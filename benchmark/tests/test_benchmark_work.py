"""The work counts behind the roofline and mfu shares, on a toy scene."""

import math

import torch

from benchmark import peaks, work
from benchmark.reference import render as R

RULES = {"tile_size": 16, "alpha_cutoff": 1.0 / 255.0, "alpha_max": 0.99,
         "transmittance_eps": 1e-4, "background": [0.0, 0.0, 0.0]}
CFG = {"num_gaussians": 3, "sh_degree": 3}


def toy_counts():
    """Two splats in the first of two tiles of a 32x16 frame, one of them
    in no tile at all."""
    f = torch.tensor([[5.0, 7.0, 0.25, 0.0, 0.25, 0.2, 0.4, 0.6, 0.5],
                      [9.0, 9.0, 0.5, 0.0, 0.5, 0.9, 0.1, 0.1, 0.8],
                      [0.0, 0.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.5]])
    pairs = R.Pairs(gid=torch.tensor([1, 0]), tile_start=torch.tensor([0, 2]),
                    tile_count=torch.tensor([2, 0]), num_pairs=2)
    _, c = R.composite(f, pairs, 32, 16, RULES,
                       valid=torch.tensor([True, True, False]))
    return c


def test_counts_of_the_toy_scene():
    c = toy_counts()
    assert (c.pairs, c.splats, c.visible, c.tiles, c.pixels) == (2, 2, 2, 2,
                                                                 512)
    # no pixel saturates, so each contributing pair is walked at all 256
    assert c.walked == 512
    near = sum(1 for y in range(16) for x in range(16)
               if ((x - 5) ** 2 + (y - 7) ** 2) / 8 <= math.log(127.5))
    near2 = sum(1 for y in range(16) for x in range(16)
                if ((x - 9) ** 2 + (y - 9) ** 2) / 4 <= math.log(0.8 * 255))
    assert c.passed == near + near2


def test_stage_terms():
    c = toy_counts()
    s = work.shape(CFG, [c, c])               # the mean of equal counts
    assert s.params == 59 and s.pixels == 512
    assert work.compositing(s) == (4 * (9 * 2 + 2 + 2 * 2 + 4 * 512),
                                   24 * c.passed, c.passed)
    assert work.compositing_backward(s).nbytes == 4 * (
        18 * 2 + 2 + 2 * 2 + 3 * 512)
    assert work.adam(s) == (4 * 7 * 3 * 59, 10 * 3 * 59, 2 * 3 * 59)
    assert work.projection(s) == (4 * (3 * 59 + 2 * 10), 1200, 36)
    step = work.train_step(s)
    assert step.nbytes == sum(f(s).nbytes for f in (
        work.projection, work.binning, work.compositing, work.background,
        work.loss, work.compositing_backward, work.projection_backward,
        work.adam, work.densify_stats))


def test_least_seconds_takes_the_binding_peak():
    assert peaks.least_seconds(3.35e12, 0, 0) == 1.0
    assert peaks.least_seconds(0, 67e12, 0) == 1.0
    assert math.isclose(peaks.least_seconds(1, 1, peaks.SFU_OPS_S * 2), 2.0)
