"""Plain-PyTorch reference of 3DGS training steps: the frame of
`render.py` with its backward, INRIA's loss (1 - lambda) L1 + lambda (1 -
SSIM) / 2 over an 11x11 Gaussian window (sigma 1.5, zero padding), and
INRIA's per-group Adam. Every value comes from the configuration's
`train` group. Imports nothing of the program and nothing of JAX.

`run_steps` follows the program's first steps from the same initial
leaves, views and targets, and returns what the check compares: each
step's loss, the first step's gradient norm per leaf, and the norm of
each leaf's change over the steps. `tf32=True` rounds the operands of the
matrix products and of the SSIM window's convolutions to TF32.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import render as R

LEAVES = ("xyz", "log_scale", "quat", "opacity_logit", "sh_dc", "sh_rest")


def _window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-(x * x) / (2 * sigma * sigma))
    return (g / g.sum()).float().to(device)


def _blur(img: torch.Tensor, win: torch.Tensor, tf32: bool) -> torch.Tensor:
    """Separable blur of [H, W, C] with zero padding."""
    c, k = img.shape[-1], win.shape[0]
    x = img.permute(2, 0, 1)[None]
    kh = win.reshape(1, 1, k, 1).expand(c, 1, k, 1)
    kw = win.reshape(1, 1, 1, k).expand(c, 1, 1, k)
    rnd = R.tf32_round if tf32 else (lambda t: t)
    x = F.conv2d(rnd(x), rnd(kh), padding=(k // 2, 0), groups=c)
    x = F.conv2d(rnd(x), rnd(kw), padding=(0, k // 2), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(a: torch.Tensor, b: torch.Tensor, t: dict,
         tf32: bool = False) -> torch.Tensor:
    win = _window(t["ssim_window"], t["ssim_sigma"], a.device)
    c1, c2 = t["ssim_c1"], t["ssim_c2"]
    mu_a, mu_b = _blur(a, win, tf32), _blur(b, win, tf32)
    var_a = _blur(a * a, win, tf32) - mu_a * mu_a
    var_b = _blur(b * b, win, tf32) - mu_b * mu_b
    cov = _blur(a * b, win, tf32) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return s.mean()


def loss_fn(img: torch.Tensor, target: torch.Tensor, t: dict,
            tf32: bool = False) -> torch.Tensor:
    lam = t["lambda_dssim"]
    return ((1 - lam) * (img - target).abs().mean()
            + lam * 0.5 * (1 - ssim(img, target, t, tf32)))


def learning_rates(t: dict, extent: float, step: int) -> Dict[str, float]:
    """Each leaf's learning rate for the update after `step` earlier ones:
    positions decay exponentially from position_lr to position_lr_final
    (both times the scene extent) over position_lr_steps, the SH rest bands
    learn at the DC rate over sh_rest_lr_div."""
    p0, p1 = t["position_lr"] * extent, t["position_lr_final"] * extent
    pos = p0 * (p1 / p0) ** (step / t["position_lr_steps"])
    return {"xyz": max(pos, p1), "log_scale": t["scale_lr"],
            "quat": t["quat_lr"], "opacity_logit": t["opacity_lr"],
            "sh_dc": t["sh_dc_lr"],
            "sh_rest": t["sh_dc_lr"] / t["sh_rest_lr_div"]}


class Adam:
    """Adam with bias correction, one learning rate per leaf."""

    def __init__(self, leaves: Dict[str, torch.Tensor], t: dict):
        self.b1, self.b2 = t["adam_betas"]
        self.eps = t["adam_eps"]
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, leaves, grads, lrs) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in leaves.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.sub_(lrs[k] * (self.m[k] / c1) / denom)


def forward_backward(leaves: Dict[str, torch.Tensor], cam: dict,
                     target: torch.Tensor, cfg: dict, tf32: bool = False):
    """One step's loss and gradients → (loss, {leaf: grad}, Counts)."""
    rules, t = cfg["render"], cfg["train"]
    w, h = cfg["width"], cfg["height"]
    src = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    p = R.project(src, cam, w, h, rules, tf32)
    pairs = R.tile_pairs(p, w, h, rules)
    img, counts = R.composite(p.fields.detach(), pairs, w, h, rules, p.valid)
    img = img.requires_grad_(True)
    loss = loss_fn(img, target, t, tf32)
    loss.backward()
    d_fields = R.composite_backward(p.fields.detach(), pairs, w, h, rules,
                                    img.grad)
    torch.autograd.backward(p.fields, d_fields)
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in src.items()}
    return float(loss.detach()), grads, counts


def run_steps(leaves0: Dict[str, torch.Tensor], cameras: List[dict],
              targets: List[torch.Tensor], cfg: dict, extent: float,
              tf32: bool = False) -> dict:
    """Steps from `leaves0` on the given views and targets → {"loss": [..],
    "grad_norm": {leaf: |g_1|}, "grad_max": {leaf: max |g_1|},
    "change_norm": {leaf: |p_n - p_0|}, "counts": [Counts per step]}."""
    t = cfg["train"]
    leaves = {k: leaves0[k].detach().clone() for k in LEAVES}
    opt = Adam(leaves, t)
    out = {"loss": [], "counts": []}
    for i, (cam, target) in enumerate(zip(cameras, targets)):
        loss, grads, counts = forward_backward(leaves, cam, target, cfg, tf32)
        if i == 0:
            out["grad_norm"] = {k: float(g.norm()) for k, g in grads.items()}
            out["grad_max"] = {k: float(g.abs().max())
                               for k, g in grads.items()}
        opt.step(leaves, grads, learning_rates(t, extent, i))
        out["loss"].append(loss)
        out["counts"].append(counts)
        del grads
    out["change_norm"] = {k: float((leaves[k] - leaves0[k]).norm())
                          for k in LEAVES}
    return out
