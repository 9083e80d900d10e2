"""Orbit camera state machine and web viewer."""
