"""The work of each stage of a frame and of a training step, as the
yardstick of the roofline and `mfu` shares: (bytes, FP32 operations,
special-function operations) that the stage needs, computed from the
configuration's shapes and from what the reference's compositing of the
same view took (`reference/render.py::Counts`), never from the program's
bins, slots or buffers.

Bytes: each input the stage needs is read once and each output written
once, float32 and int32 at 4 bytes. Operations: counted from the
reference's formulas per Gaussian, per pair-pixel step and per pixel, and
rounded down. Only the steps where a pair contributes (`passed`) count: a
step whose alpha falls under the cutoff is work that a tighter footprint
skips, so the count is what these inputs need, not the most a walk could
take (`walked`, kept for the record). Terms (N Gaussians, P = 3 + 3 + 4 +
1 + 3 K parameters each for K SH coefficients, V visible, S contributing
Gaussians, M contributing (tile, Gaussian) pairs, T tiles, X pixels):

  projection + SH   read N P floats; write V x 10 (mean 2, conic 3, rgb 3,
                    opacity, depth); 400 FP32 and 12 SFU per Gaussian
  binning           read V x 7 (mean, conic, opacity, depth); write the
                    pair list M x 1 and the tile ranges T x 2; 20 FP32 and
                    2 SFU per visible Gaussian
  compositing       read S x 9 fields, M x 1, T x 2; write X x 4 (rgb,
                    alpha); per passed step 24 FP32 (the power and its
                    test, alpha, T, four accumulations) and 1 SFU (exp)
  background        read X x 4, write X x 3; 6 FP32 per pixel
  loss              read X x 3 twice (image, target), write X x 3 (its
                    gradient); 1,500 FP32 and 6 SFU per pixel (L1, five
                    11-tap separable blurs and SSIM, and their backward)
  compositing bwd   read S x 9, M x 1, T x 2, X x 3 (image gradient);
                    write S x 9; per passed step 42 FP32 (the power again,
                    alpha, T, the suffix, the nine field gradients) and 2
                    SFU (exp, reciprocal of 1 - alpha)
  projection bwd    read N P parameters and V x 9 field gradients; write N
                    P gradients; 800 FP32 and 12 SFU per Gaussian
  Adam              read parameters, gradients and both moments, write
                    parameters and moments: 7 N P floats; 10 FP32 and 2 SFU
                    (square root, reciprocal) per parameter
  densify stats     read V x 2 (screen-space gradients) and N x 3, write
                    N x 3; 8 FP32 and 1 SFU per visible Gaussian
"""

from __future__ import annotations

from typing import List, NamedTuple

F = 4   # bytes per float32 or int32


class Work(NamedTuple):
    nbytes: float
    fp32: float
    sfu: float

    def __add__(self, other):
        return Work(*(a + b for a, b in zip(self, other)))


class Shape(NamedTuple):
    """Averages of the reference's counts over the checked views."""
    n: float
    params: float
    visible: float
    splats: float
    pairs: float
    tiles: float
    pixels: float
    walked: float
    passed: float


def shape(cfg: dict, counts: List) -> Shape:
    k = (cfg["sh_degree"] + 1) ** 2
    c = len(counts)

    def avg(f):
        return sum(getattr(x, f) for x in counts) / c

    return Shape(n=cfg["num_gaussians"], params=11 + 3 * k,
                 visible=avg("visible"), splats=avg("splats"),
                 pairs=avg("pairs"), tiles=avg("tiles"),
                 pixels=avg("pixels"), walked=avg("walked"),
                 passed=avg("passed"))


def projection(s: Shape) -> Work:
    return Work(F * (s.n * s.params + s.visible * 10), 400 * s.n, 12 * s.n)


def binning(s: Shape) -> Work:
    return Work(F * (s.visible * 7 + s.pairs + 2 * s.tiles),
                20 * s.visible, 2 * s.visible)


def compositing(s: Shape) -> Work:
    return Work(F * (9 * s.splats + s.pairs + 2 * s.tiles + 4 * s.pixels),
                24 * s.passed, s.passed)


def background(s: Shape) -> Work:
    return Work(F * 7 * s.pixels, 6 * s.pixels, 0)


def loss(s: Shape) -> Work:
    return Work(F * 9 * s.pixels, 1500 * s.pixels, 6 * s.pixels)


def compositing_backward(s: Shape) -> Work:
    return Work(F * (18 * s.splats + s.pairs + 2 * s.tiles + 3 * s.pixels),
                42 * s.passed, 2 * s.passed)


def projection_backward(s: Shape) -> Work:
    return Work(F * (2 * s.n * s.params + 9 * s.visible), 800 * s.n,
                12 * s.n)


def adam(s: Shape) -> Work:
    p = s.n * s.params
    return Work(F * 7 * p, 10 * p, 2 * p)


def densify_stats(s: Shape) -> Work:
    return Work(F * (2 * s.visible + 6 * s.n), 8 * s.visible, s.visible)


def frame(s: Shape) -> Work:
    return projection(s) + binning(s) + compositing(s) + background(s)


def train_step(s: Shape) -> Work:
    return (frame(s) + loss(s) + compositing_backward(s)
            + projection_backward(s) + adam(s) + densify_stats(s))
