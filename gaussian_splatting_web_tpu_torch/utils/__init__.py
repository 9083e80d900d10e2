"""Image IO and timing metrics."""

from .image import read_image, write_png
from .metrics import FrameStats, Timer, throughput_mpixps

__all__ = ["write_png", "read_image", "Timer", "throughput_mpixps",
           "FrameStats"]
