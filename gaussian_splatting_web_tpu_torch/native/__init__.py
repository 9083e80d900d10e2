"""Host-side native helpers (ctypes bindings of csrc/*.cpp)."""
