"""PNG output."""
