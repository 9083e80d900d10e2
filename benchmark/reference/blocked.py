"""Plain-PyTorch reference training steps of a whole scene that one pass of
`train.py` cannot hold on one card (Rubble's 40.4M Gaussians): the same
steps as `train.run_steps`, with the per-Gaussian work done a block of
Gaussians at a time. It reuses `render.py`'s projection, pair list and
blocked compositing and `train.py`'s loss and Adam, and imports nothing of
the program and nothing of JAX.

  * The forward projects the scene in blocks of `block` Gaussians without
    keeping a graph, and builds the frame's pair list from each block's
    pairs (`render.tile_pairs` with no cap), sorted again by tile, then
    depth, with the whole scene's caps applied after. Pairs of one tile at
    equal depth keep the order of their blocks, then their slots: the
    whole-scene sort orders such ties by slot alone.
  * The compositing and its backward are `render.composite` and
    `render.composite_backward` over the whole frame, a block of tiles at a
    time, as in `train.py`, over each tile's pairs up to the last one any
    of its pixels walks (`walked_prefix`): a pixel is done at the first
    pair that takes its transmittance under `transmittance_eps`, and no
    pair after that contributes to it, so the frame, its gradients and its
    `Counts` are those of the whole list. The whole list is 78M pairs a
    frame at Rubble's size, 20 times what the pixels walk.
  * The backward recomputes each block's projection under autograd and
    feeds it the composite's cotangent for that block's fields.
  * Adam runs per leaf, a block of rows at a time (elementwise: the same
    bits as `train.Adam`).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import render as R
from . import train as T

BLOCK = 2_000_000      # Gaussians a block (about 5 GB of autograd graph)


def _blocks(n: int, block: int):
    return [slice(r, min(r + block, n)) for r in range(0, n, block)]


@torch.no_grad()
def project(leaves: Dict[str, torch.Tensor], cam: dict, width: int,
            height: int, rules: dict, tf32: bool = False,
            block: int = BLOCK) -> R.Projected:
    """`render.project` of every Gaussian, a block at a time, no graph."""
    parts = [R.project({k: v[r] for k, v in leaves.items()}, cam, width,
                       height, rules, tf32)
             for r in _blocks(leaves["xyz"].shape[0], block)]
    return R.Projected(*(torch.cat(f) for f in zip(*parts)))


@torch.no_grad()
def tile_pairs(p: R.Projected, width: int, height: int, rules: dict,
               block: int = BLOCK) -> R.Pairs:
    """The frame's depth-sorted pair list as `render.tile_pairs` gives it,
    built from each block's pairs (see the module docstring)."""
    n = p.depth.shape[0]
    ts = rules["tile_size"]
    tiles = (-(-width // ts)) * (-(-height // ts))
    d = rules["max_dup"]
    whole = dict(rules, max_per_tile=d * n + 1, gather_cap_factor=float(d),
                 gather_cap_floor=0)
    gids, tids = [], []
    for r in _blocks(n, block):
        part = R.tile_pairs(R.Projected(*(f[r] for f in p)), width, height,
                            whole)
        gids.append(part.gid + r.start)
        tids.append(torch.repeat_interleave(
            torch.arange(tiles, device=p.depth.device), part.tile_count))
    gid, tile = torch.cat(gids), torch.cat(tids)
    del gids, tids
    order = torch.sort(p.depth[gid], stable=True).indices
    order = order[torch.sort(tile[order], stable=True).indices]
    gid, tile = gid[order], tile[order]
    total = gid.shape[0]
    cap = min(d * n, max(int(n * rules["gather_cap_factor"]),
                         rules["gather_cap_floor"]))
    gid, tile = gid[:cap], tile[:cap]
    count = torch.bincount(tile, minlength=tiles)
    start = torch.cumsum(count, 0) - count
    count = torch.clamp(count, max=rules["max_per_tile"])
    return R.Pairs(gid=gid, tile_start=start, tile_count=count,
                   num_pairs=total)


@torch.no_grad()
def walked_prefix(fields: torch.Tensor, pairs: R.Pairs, width: int,
                  height: int, rules: dict, first: int = 1024) -> R.Pairs:
    """`pairs` with each tile's count cut to the longest walk of its pixels
    (`render._block`'s `walked`: the steps up to and with the pair that
    ends a pixel). Tiles are tried on their first `first` pairs, and the
    tiles one of whose pixels walks all of them again on four times as
    many, until every tile's pixels end or its pairs do."""
    ts = rules["tile_size"]
    bg = torch.zeros(3, device=fields.device)
    count = pairs.tile_count
    need = count.clone()
    todo = torch.nonzero(count).squeeze(1)
    lim = first
    while todo.numel():
        trial = torch.zeros_like(count)
        trial[todo] = torch.clamp(count[todo], max=lim)
        again = []
        for tiles, k_len in R._chunks(trial, ts * ts):
            _, _, walked, _, inside = R._block(
                fields, pairs._replace(tile_count=trial), tiles, k_len,
                width, height, rules, bg)
            t = torch.as_tensor(tiles, device=count.device)
            longest = torch.where(inside, walked.sum(1), 0).amax(1)
            ended = longest < trial[t]
            need[t] = torch.where(ended, longest, trial[t])
            again.append(t[~ended & (count[t] > trial[t])])
        todo = torch.cat(again)
        lim *= 4
    return pairs._replace(tile_count=need)


def forward_backward(leaves: Dict[str, torch.Tensor], cam: dict,
                     target: torch.Tensor, cfg: dict, tf32: bool = False,
                     block: int = BLOCK):
    """One step's loss and gradients → (loss, {leaf: grad}, Counts), as
    `train.forward_backward`."""
    rules, t = cfg["render"], cfg["train"]
    w, h = cfg["width"], cfg["height"]
    p = project(leaves, cam, w, h, rules, tf32, block)
    pairs = walked_prefix(p.fields, tile_pairs(p, w, h, rules, block), w,
                          h, rules)
    img, counts = R.composite(p.fields, pairs, w, h, rules, p.valid)
    img = img.requires_grad_(True)
    loss = T.loss_fn(img, target, t, tf32)
    loss.backward()
    d_fields = R.composite_backward(p.fields, pairs, w, h, rules, img.grad)
    del p, pairs, img
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for r in _blocks(leaves["xyz"].shape[0], block):
        src = {k: v[r].detach().requires_grad_(True)
               for k, v in leaves.items()}
        with torch.enable_grad():
            pb = R.project(src, cam, w, h, rules, tf32)
            torch.autograd.backward(pb.fields, d_fields[r])
        for k, v in src.items():
            if v.grad is not None:
                grads[k][r] = v.grad
    return float(loss.detach()), grads, counts


class Adam(T.Adam):
    """`train.Adam`, each leaf updated a block of rows at a time."""

    def __init__(self, leaves: Dict[str, torch.Tensor], t: dict,
                 block: int = BLOCK):
        super().__init__(leaves, t)
        self.block = block

    @torch.no_grad()
    def step(self, leaves, grads, lrs) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in leaves.items():
            for r in _blocks(p.shape[0], self.block):
                g, m, v = grads[k][r], self.m[k][r], self.v[k][r]
                m.mul_(self.b1).add_(g, alpha=1 - self.b1)
                v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                denom = (v / c2).sqrt_().add_(self.eps)
                p[r].sub_(lrs[k] * (m / c1) / denom)


def _change_norm(a: torch.Tensor, b: torch.Tensor, block: int) -> float:
    total = 0.0
    for r in _blocks(a.shape[0], block):
        total += float(((a[r] - b[r]).double() ** 2).sum())
    return total ** 0.5


def run_steps(leaves0: Dict[str, torch.Tensor], cameras: List[dict],
              targets: List[torch.Tensor], cfg: dict, extent: float,
              tf32: bool = False, block: int = BLOCK) -> dict:
    """`train.run_steps` in blocks of `block` Gaussians: the same keys,
    "loss", "grad_norm", "grad_max", "change_norm" and "counts"."""
    t = cfg["train"]
    leaves = {k: leaves0[k].detach().clone() for k in T.LEAVES}
    opt = Adam(leaves, t, block)
    out = {"loss": [], "counts": []}
    for i, (cam, target) in enumerate(zip(cameras, targets)):
        loss, grads, counts = forward_backward(leaves, cam, target, cfg,
                                               tf32, block)
        if i == 0:
            out["grad_norm"] = {k: float(g.norm()) for k, g in grads.items()}
            out["grad_max"] = {k: float(g.abs().max())
                               for k, g in grads.items()}
        opt.step(leaves, grads, T.learning_rates(t, extent, i))
        out["loss"].append(loss)
        out["counts"].append(counts)
        del grads
    del opt
    out["change_norm"] = {k: _change_norm(leaves[k], leaves0[k], block)
                          for k in T.LEAVES}
    return out
