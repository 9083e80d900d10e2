"""Image IO, timing metrics and tracing."""

from .image import read_image, write_png
from .metrics import throughput_mpixps

__all__ = ["write_png", "read_image", "throughput_mpixps"]
