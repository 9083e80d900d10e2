"""The inputs of one run, made from `--seed` on the run's device: the
scene, the cameras, the training targets and the order of requests.

The scene follows the distribution of the JAX package's synthetic bench
scene (`bench_lib.make_scene`), redrawn here on the device with a
`torch.Generator` in a few large calls: positions N(0, xyz_std^2) per
axis, log-scales U(lo, hi), unit quaternions (x, y, z, w) from normal
draws, opacity logits U(lo, hi), SH coefficients N(0, sh_std^2). Targets
are smooth random images in [0, 1]: uniform noise on a grid of one value
per `target_cell` pixels, bilinearly upsampled, plus a little fine noise.
Both sides of every comparison get these same tensors.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List

import torch
import torch.nn.functional as F

from . import cameras as cam_mod

SH_COEFFS = {0: 1, 1: 4, 2: 9, 3: 16}
# the scene's leaves as the program's trainable model holds them
LEAVES = ("xyz", "log_scale", "quat", "opacity_logit", "sh_dc", "sh_rest")


@dataclasses.dataclass
class Inputs:
    scene: dict            # the six leaves, float32 on the device
    cameras: List[dict]    # every view of the orbit (cameras.py)
    train_ids: List[int]   # views trained on
    test_ids: List[int]    # held-out views, every `test_every`-th
    extent: float          # INRIA's camera extent over the training views


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def make_scene(cfg: dict, seed: int, device) -> dict:
    """The configuration's scene from `seed` (see the module docstring)."""
    n = cfg["num_gaussians"]
    s = cfg["scene"]
    k = SH_COEFFS[cfg["sh_degree"]]
    g = generator(seed, device)
    normal = torch.randn((n, 3 + 4 + 3 * k), generator=g, device=device)
    uniform = torch.rand((n, 4), generator=g, device=device)
    xyz = normal[:, :3] * s["xyz_std"]
    quat = normal[:, 3:7]
    quat = quat / quat.norm(dim=1, keepdim=True)
    sh = (normal[:, 7:] * s["sh_std"]).reshape(n, k, 3)
    lo, hi = s["log_scale"]
    olo, ohi = s["opacity_logit"]
    return {"xyz": xyz.contiguous(),
            "log_scale": (lo + (hi - lo) * uniform[:, :3]).contiguous(),
            "quat": quat.contiguous(),
            "opacity_logit": (olo + (ohi - olo) * uniform[:, 3]).contiguous(),
            "sh_dc": sh[:, :1].contiguous(),
            "sh_rest": sh[:, 1:].contiguous()}


def make_cameras(cfg: dict, device) -> List[dict]:
    o = cfg["orbit"]
    n = cfg["views"]
    return [cam_mod.orbit_camera(i, n, cfg["width"], cfg["height"],
                                 o["radius"], o["height"], o["fov_y_deg"],
                                 o["znear"], o["zfar"], device)
            for i in range(n)]


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    cams = make_cameras(cfg, device)
    every = cfg["test_every"]
    test = [i for i in range(cfg["views"]) if i % every == 0]
    train = [i for i in range(cfg["views"]) if i % every != 0]
    return Inputs(scene=make_scene(cfg, seed, device), cameras=cams,
                  train_ids=train, test_ids=test,
                  extent=cam_mod.scene_extent([cams[i] for i in train]))


def make_targets(cfg: dict, seed: int, count: int, device,
                 block: int = 16) -> torch.Tensor:
    """`count` target images [count, H, W, 3] from `seed` (see the module
    docstring), made `block` at a time."""
    h, w = cfg["height"], cfg["width"]
    cell = cfg["scene"]["target_cell"]
    g = generator(seed ^ 0x5EED, device)
    out = torch.empty((count, h, w, 3), dtype=torch.float32, device=device)
    for i in range(0, count, block):
        b = min(block, count - i)
        coarse = torch.rand((b, 3, -(-h // cell) + 1, -(-w // cell) + 1),
                            generator=g, device=device)
        img = F.interpolate(coarse, size=(h, w), mode="bilinear",
                            align_corners=False)
        fine = torch.rand((b, 3, h, w), generator=g, device=device)
        img = (0.9 * img + 0.1 * fine).permute(0, 2, 3, 1)
        out[i:i + b] = img
    return out


def request_order(ids: List[int], count: int, seed: int,
                  shuffle: bool) -> List[int]:
    """`count` view ids: `ids` in turn, or epochs of seeded permutations
    of `ids` (every view once an epoch, as INRIA draws training views)."""
    rng = random.Random(seed)
    out: List[int] = []
    while len(out) < count:
        epoch = list(ids)
        if shuffle:
            rng.shuffle(epoch)
        out.extend(epoch)
    return out[:count]
