"""Render configuration of the PyTorch/CUDA port.

Every field of the JAX package's `RenderConfig` is kept under the same
name, so `jax_config = RenderConfig(**dataclasses.asdict(port_config))`
builds the reference configuration for parity runs. The defaults equal the
JAX defaults except for the fields that select the TPU's packed or tiered
binning: the port ships the exact mode (`depth_bits=0, tier_split=0,
pack_fields=False, pack_mean16=False, pack_grads=False`), which is the mode
the JAX package's own oracle tests pin.

The TPU grid fields (`tile_chunk`, `r_tiles`, `r_tiles_bwd`, `early_exit`,
`use_pallas`) are kept only for that one-to-one conversion; the port
ignores them. Modes the port does not implement yet raise
`NotImplementedError` naming the ROADMAP item that will port them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of the renderer (see the JAX package's
    `gaussian_splatting_web_tpu/config.py` for what each field means)."""

    # --- tiling -----------------------------------------------------------
    tile_size: int = 16          # pixels per tile side; the CUDA compositor
                                 # is built for 16 (one thread per pixel)
    max_dup: int = 16            # max tiles a single gaussian is binned into
    tile_chunk: int = 32         # TPU lax.map chunk (ignored by the port)
    max_per_tile: int = 1024     # per-tile pair cap of the compositor
    depth_bits: int = 0          # 0 = exact (tile, f32 depth) sort
    tier_split: int = 0          # 0 = single-tier duplication
    tier_mid: int = 4
    mid_frac: float = 0.3
    big_frac: float = 1.0 / 64.0
    gather_cap_factor: float = 3.0  # >0: cut the sorted pairs at factor·N
    gather_cap_floor: int = 65536   # never cut below this many pairs
    tile_cull: bool = False

    # --- EWA / splat constants (parity with the reference shader) --------
    lowpass: float = 0.3
    fov_clamp: float = 1.3
    max_radius_px: float = 4096.0
    alpha_cutoff: float = 1.0 / 255.0
    alpha_max: float = 0.99
    transmittance_eps: float = 1e-4
    radius_sigma: float = 0.0

    # --- camera defaults --------------------------------------------------
    znear: float = 0.2
    zfar: float = 100.0

    # --- compositing / post ----------------------------------------------
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    post_alpha_boost: float = 1.5
    post_alpha_pow: float = 4.0
    post_alpha_knee: float = 0.99

    # --- precision --------------------------------------------------------
    dtype: str = "float32"
    pack_fields: bool = False
    pack_mean16: bool = False
    pack_grads: bool = False

    # --- TPU kernel selection and grid shape (ignored by the port) -------
    use_pallas: str = "auto"
    binning: str = "dup"
    r_tiles: int = 8
    r_tiles_bwd: int = 1
    early_exit: bool = True

    # --- debugging --------------------------------------------------------
    debug_selected: int = -1

    def __post_init__(self):
        unported = (
            (self.depth_bits > 0, "depth_bits > 0 (packed sort key)",
             "ROADMAP §1 item 12"),
            (self.tier_split > 0, "tier_split > 0 (tiered duplication)",
             "ROADMAP §1 item 12"),
            (self.pack_fields, "pack_fields (bf16 sort payloads)",
             "ROADMAP §1 item 12"),
            (self.tile_cull, "tile_cull (ellipse-rect slot test)",
             "ROADMAP §1 item 12"),
            (self.binning == "anchor", "binning='anchor'",
             "ROADMAP §1 item 11"),
            (self.debug_selected >= 0, "debug_selected (splat highlight)",
             "ROADMAP §1 item 13"),
            (self.dtype not in ("float32", "f32"),
             f"dtype={self.dtype!r} (bf16 scene storage)",
             "ROADMAP §1 item 13"),
        )
        for bad, what, item in unported:
            if bad:
                raise NotImplementedError(
                    f"the PyTorch port does not implement {what} yet; "
                    f"{item} ports it")

    def grid_size(self, width: int, height: int) -> Tuple[int, int]:
        """Number of tiles in (x, y)."""
        ts = self.tile_size
        return (-(-width // ts), -(-height // ts))

    def num_tiles(self, width: int, height: int) -> int:
        gx, gy = self.grid_size(width, height)
        return gx * gy

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

