"""PLY read/write and cameras.json loading."""
