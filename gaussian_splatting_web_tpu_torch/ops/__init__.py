"""Projection, binning, compositing and post-processing."""

from .composite import post_process
from .projection import ProjectedSplats, project_gaussians
from .rasterize import rasterize_tiles, render, render_impl
from .sh import eval_sh
from .sort import TileBins, bin_splats, depth_sort_indices

__all__ = [
    "eval_sh",
    "project_gaussians",
    "ProjectedSplats",
    "bin_splats",
    "TileBins",
    "depth_sort_indices",
    "rasterize_tiles",
    "render",
    "post_process",
]
