"""Render configuration of the PyTorch/CUDA port.

Every field of the JAX package's `RenderConfig` is kept under the same
name, so `jax_config = RenderConfig(**dataclasses.asdict(port_config))`
builds the reference configuration for parity runs, and every
configuration the JAX package accepts builds here. The defaults equal the
JAX defaults except for the fields that select the packed or tiered
binning: the port ships the exact mode (`depth_bits=0, tier_split=0,
pack_fields=False, pack_mean16=False, pack_grads=False`), which is the mode
the JAX package's own oracle tests pin. The packed modes run when asked
for: the packed single-key sort (`depth_bits`), tiered duplication
(`tier_split`, `tier_mid`, `mid_frac`, `big_frac`), the ellipse-tile cull
(`tile_cull`), bf16 fields (`pack_fields`), the tile-relative 1/32-px mean
(`pack_mean16`), bf16 pair gradients in the fold (`pack_grads`) and the
packed anchor binning (`binning="anchor", pack_fields=True`, 16-bit depth
keys).

The TPU grid fields (`r_tiles`, `r_tiles_bwd`, `early_exit`,
`use_pallas`) are kept only for that one-to-one conversion; the port
ignores them. `tile_chunk`, the TPU's lax.map chunk, is read only by the
tile deal of `parallel/` (each shard's strip is a multiple of it), as in
the JAX package. `dtype` is the scene's storage dtype
(`GaussianCloud.with_storage_dtype`, applied by `render_impl`) and
`debug_selected` the splat highlight (`ops/rasterize.py::
highlight_selected`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# scene storage dtypes (`GaussianCloud.with_storage_dtype`)
STORAGE_DTYPES = ("float32", "f32", "bfloat16", "bf16")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of the renderer (see the JAX package's
    `gaussian_splatting_web_tpu/config.py` for what each field means)."""

    # --- tiling -----------------------------------------------------------
    tile_size: int = 16          # pixels per tile side; the CUDA compositor
                                 # is built for 16 (one thread per pixel)
    max_dup: int = 16            # max tiles a single gaussian is binned into
    tile_chunk: int = 32         # tile-shard strip alignment (parallel/)
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

    # --- binning architecture: 'dup' (kernels A, B) or 'anchor' (C, D) ---
    binning: str = "dup"

    # --- TPU kernel selection and grid shape (ignored by the port) -------
    use_pallas: str = "auto"
    r_tiles: int = 8
    r_tiles_bwd: int = 1
    early_exit: bool = True

    # --- debugging --------------------------------------------------------
    debug_selected: int = -1

    def __post_init__(self):
        if self.dtype not in STORAGE_DTYPES:
            raise ValueError(f"unsupported storage dtype {self.dtype!r}; "
                             f"one of {STORAGE_DTYPES}")
        if self.binning == "anchor" and self.pack_fields:
            # the JAX package's packed anchor order key d16·mult + lane must
            # fit int32 (JAX `ops/pallas/anchor.py::_order_mult`)
            union = 2 * (self.max_per_tile // 256 + 2) * 256
            if 1 << (union - 1).bit_length() > 1 << 14:
                raise ValueError(
                    f"packed anchor order keys overflow int32 for "
                    f"max_per_tile={self.max_per_tile} (keep it below 7936, "
                    "or use pack_fields=False)")

    def grid_size(self, width: int, height: int) -> Tuple[int, int]:
        """Number of tiles in (x, y)."""
        ts = self.tile_size
        return (-(-width // ts), -(-height // ts))

    def num_tiles(self, width: int, height: int) -> int:
        gx, gy = self.grid_size(width, height)
        return gx * gy

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

