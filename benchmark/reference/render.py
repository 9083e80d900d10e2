"""Plain-PyTorch reference of one frame of 3D Gaussian splatting, written
from the method (Kerbl et al. 2023, arXiv:2308.04079, and INRIA's
diff-gaussian-rasterization) and the rules in the configuration's
`render` group, not from the program: EWA projection with SH colour, the
tile footprint and depth-sorted pair list, front-to-back compositing, and
its backward through autograd, recomputed a block of tiles at a time.

Rules (the configuration names each value):
  * a Gaussian is kept when its clip w > 0.2, its 2D covariance (with
    `lowpass` added on the diagonal) has a positive determinant, its
    opacity-aware radius ceil(sqrt(2 lambda_1 ln(max(o, c) / c))) is > 0
    (c = `alpha_cutoff`, capped at `max_radius_px`) and that radius
    reaches the frame; x/z and y/z are clamped at `fov_clamp` times the
    half field of view's tangent in the Jacobian;
  * its tile rectangle spans the cutoff ellipse's extents
    sqrt(2 tau Sigma_xx) + 1/2, sqrt(2 tau Sigma_yy) + 1/2 (tau = ln(max(o,
    c) / c), each at most the radius); a rectangle of more than `max_dup`
    tiles is shrunk about its clipped centre by sqrt(max_dup / tiles), as
    the configuration's `shrink` rule says;
  * pairs (tile, Gaussian) sort by tile, then depth, then slot (k N + g
    for the k-th tile of Gaussian g's rectangle, row-major); the sorted
    list is cut at min(max_dup N, max(`gather_cap_factor` N,
    `gather_cap_floor`)) pairs, and each tile composites at most its first
    `max_per_tile` pairs;
  * at pixel p, power = ln(o) - (A dx^2 + C dy^2) / 2 - B dx dy with
    (A, B, C) the conic and d = p - mean; alpha = min(exp(power),
    `alpha_max`) where power >= ln(c), else 0; pair k contributes while
    T_k (1 - alpha_k) >= `transmittance_eps`, T_k the product of (1 -
    alpha_j) over the pairs before it, and no pair after the first that
    fails does; colour = sum alpha_k T_k rgb_k + (1 - sum alpha_k T_k) bg.

`tf32=True` rounds the operands of every matrix product to TF32 (10
mantissa bits, round to nearest) and keeps float32 accumulation: the
control that a lower precision than the configuration's float32 must
fail. Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
CHUNK_ELEMS = 1 << 25


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (round half up on the
    magnitude), still stored as float32; the gradient passes straight
    through."""
    bits = x.detach().contiguous().view(torch.int32)
    low = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (low - x.detach())


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """[N, 4] (x, y, z, w) → [N, 3, 3], the quaternion normalised first."""
    q = q / torch.sqrt(torch.clamp((q * q).sum(-1, keepdim=True), min=1e-24))
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def sh_to_rgb(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Degree-0..3 SH [N, K, 3] seen along unit `dirs` [N, 3] → rgb, + 0.5,
    clamped below at 0."""
    k = sh.shape[1]
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    out = SH_C0 * sh[:, 0]
    if k > 1:
        out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        out = (out + SH_C2[0] * x * y * sh[:, 4] + SH_C2[1] * y * z * sh[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
               + SH_C2[3] * x * z * sh[:, 7]
               + SH_C2[4] * (xx - yy) * sh[:, 8])
    if k > 9:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
               + SH_C3[1] * x * y * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp(out + 0.5, min=0.0)


class Projected(NamedTuple):
    fields: torch.Tensor    # [N, 9]: mean x, y, conic A, B, C, rgb, opacity
    depth: torch.Tensor     # [N] view-space z
    cov: torch.Tensor       # [N, 3]: 2D covariance a, b, c with lowpass
    radius: torch.Tensor    # [N] pixels, 0 where not kept
    valid: torch.Tensor     # [N] bool


def project(scene: Dict[str, torch.Tensor], cam: Dict[str, torch.Tensor],
            width: int, height: int, rules: dict,
            tf32: bool = False) -> Projected:
    """Every Gaussian of `scene` (the six leaves) to screen space,
    differentiable in the leaves."""
    xyz = scene["xyz"]
    sh = torch.cat([scene["sh_dc"], scene["sh_rest"]], 1)
    view, proj = cam["view"], cam["proj"]
    rot = view[:3, :3]
    t = matmul(xyz, rot.T, tf32) + view[:3, 3]
    pv = matmul(proj, view, tf32)
    hom = matmul(xyz, pv[:, :3].T, tf32) + pv[:, 3]
    w = hom[:, 3]
    front = w > 0.2
    w_safe = torch.where(front, w, torch.ones_like(w))
    ndc_x, ndc_y = hom[:, 0] / w_safe, hom[:, 1] / w_safe
    mx = ((ndc_x + 1.0) * width - 1.0) * 0.5
    my = ((ndc_y + 1.0) * height - 1.0) * 0.5

    scale = torch.exp(scene["log_scale"]) * cam["scale_modifier"]
    m = quat_to_rot(scene["quat"]) * scale[:, None, :]
    sigma = matmul(m, m.transpose(1, 2), tf32)                # [N, 3, 3]

    z = torch.where(front, t[:, 2], torch.ones_like(w))
    lim_x = rules["fov_clamp"] * cam["tan_half_fov"][0]
    lim_y = rules["fov_clamp"] * cam["tan_half_fov"][1]
    tx = torch.clamp(t[:, 0] / z, -lim_x, lim_x) * z
    ty = torch.clamp(t[:, 1] / z, -lim_y, lim_y) * z
    fx, fy = cam["focal"][0], cam["focal"][1]
    zero = torch.zeros_like(z)
    jac = torch.stack([fx / z, zero, -fx * tx / (z * z),
                       zero, fy / z, -fy * ty / (z * z)], -1).reshape(-1, 2, 3)
    tw = matmul(jac, rot.expand(jac.shape[0], 3, 3), tf32)   # J W
    cov2 = matmul(matmul(tw, sigma, tf32), tw.transpose(1, 2), tf32)
    a = cov2[:, 0, 0] + rules["lowpass"]
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + rules["lowpass"]
    det = a * c - b * b
    det_ok = det > 0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))

    dirs = xyz - cam["cam_pos"]
    dirs = dirs / torch.clamp(dirs.norm(dim=1, keepdim=True), min=1e-12)
    rgb = sh_to_rgb(sh, dirs)
    opacity = torch.sigmoid(scene["opacity_logit"])

    with torch.no_grad():
        cut = rules["alpha_cutoff"]
        mid = 0.5 * (a + c)
        lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        tau = torch.log(torch.clamp(opacity, min=cut) / cut)
        radius = torch.clamp(torch.ceil(torch.sqrt(2.0 * lam1 * tau)),
                             max=rules["max_radius_px"])
        on_screen = ((mx + radius >= 0) & (mx - radius < width)
                     & (my + radius >= 0) & (my - radius < height))
        valid = front & det_ok & (radius > 0) & on_screen
    fields = torch.stack([mx, my, c * inv, -b * inv, a * inv, rgb[:, 0],
                          rgb[:, 1], rgb[:, 2], opacity], 1)
    return Projected(fields=fields, depth=t[:, 2].detach(),
                     cov=torch.stack([a, b, c], 1).detach(),
                     radius=torch.where(valid, radius, 0.0), valid=valid)


class Pairs(NamedTuple):
    gid: torch.Tensor         # [M] Gaussian of each kept pair, sorted
    tile_start: torch.Tensor  # [T] first pair of each tile
    tile_count: torch.Tensor  # [T] pairs each tile composites
    num_pairs: int            # pairs before the caps


@torch.no_grad()
def tile_pairs(p: Projected, width: int, height: int, rules: dict) -> Pairs:
    """The depth-sorted pair list of the frame (see the module docstring)."""
    ts = rules["tile_size"]
    gx, gy = -(-width // ts), -(-height // ts)
    n = p.depth.shape[0]
    d = rules["max_dup"]
    cut = rules["alpha_cutoff"]
    mx, my = p.fields[:, 0].detach(), p.fields[:, 1].detach()
    tau = torch.log(torch.clamp(p.fields[:, 8].detach(), min=cut) / cut)
    rx = torch.minimum(torch.sqrt(2.0 * tau * p.cov[:, 0]) + 0.5, p.radius)
    ry = torch.minimum(torch.sqrt(2.0 * tau * p.cov[:, 2]) + 0.5, p.radius)
    x0 = torch.clamp(torch.floor((mx - rx) / ts), 0, gx).long()
    x1 = torch.clamp(torch.floor((mx + rx) / ts) + 1, 0, gx).long()
    y0 = torch.clamp(torch.floor((my - ry) / ts), 0, gy).long()
    y1 = torch.clamp(torch.floor((my + ry) / ts) + 1, 0, gy).long()
    rw = torch.where(p.valid, x1 - x0, 0)
    rh = torch.where(p.valid, y1 - y0, 0)
    # the shrink rule: about the clipped rectangle's centre, rounding down
    over = rw * rh > d
    f = torch.sqrt(d / torch.clamp(rw * rh, min=1).float())
    rw2 = torch.clamp(torch.floor(rw * f).long(), 1, d)
    rh2 = torch.minimum(torch.clamp(torch.floor(rh * f).long(), min=1),
                        torch.clamp(d // rw2, min=1))
    x0 = torch.where(over, x0 + (rw - rw2) // 2, x0)
    y0 = torch.where(over, y0 + (rh - rh2) // 2, y0)
    rw = torch.where(over, rw2, rw)
    rh = torch.where(over, rh2, rh)

    k = torch.arange(d, device=mx.device)[:, None]            # slot-major
    live = k < (rw * rh)[None, :]
    safe_w = torch.clamp(rw, min=1)[None, :]
    tile = (y0[None, :] + k // safe_w) * gx + x0[None, :] + k % safe_w
    slot = torch.nonzero(live.reshape(-1)).squeeze(1)          # ascending
    gid = slot % n
    tile = tile.reshape(-1)[slot]
    order = torch.sort(p.depth[gid], stable=True).indices
    order = order[torch.sort(tile[order], stable=True).indices]
    gid, tile = gid[order], tile[order]
    total = gid.shape[0]
    cap = min(d * n, max(int(n * rules["gather_cap_factor"]),
                         rules["gather_cap_floor"]))
    gid, tile = gid[:cap], tile[:cap]
    count = torch.bincount(tile, minlength=gx * gy)
    start = torch.cumsum(count, 0) - count
    count = torch.clamp(count, max=rules["max_per_tile"])
    return Pairs(gid=gid, tile_start=start, tile_count=count,
                 num_pairs=total)


class Counts(NamedTuple):
    """What the compositing of one frame takes: `walked` pair-pixel steps
    of the pairs that contribute to some pixel (each pixel up to the pair
    after which it is done), of which `passed` contribute; the
    contributing (tile, Gaussian) `pairs` and distinct `splats`; the
    `visible` Gaussians, the frame's `tiles` and `pixels`."""

    walked: int
    passed: int
    pairs: int
    splats: int
    visible: int
    tiles: int
    pixels: int


def _chunks(count: torch.Tensor, p: int):
    """Tiles with pairs, heaviest first, in groups whose [C, K, P] blocks
    hold at most CHUNK_ELEMS elements → [(tile ids, K)]."""
    nz = torch.nonzero(count).squeeze(1)
    if nz.numel() == 0:
        return []
    cnt = count[nz]
    order = torch.argsort(cnt, descending=True, stable=True)
    tiles, cnt = nz[order].tolist(), cnt[order].tolist()
    out, i = [], 0
    while i < len(tiles):
        k = cnt[i]
        c = max(1, CHUNK_ELEMS // (k * p))
        out.append((tiles[i:i + c], k))
        i += c
    return out


def _block(fields, pairs: Pairs, tiles, k_len, width, height, rules, bg):
    """Composite one block of tiles → (rgb [C, P, 3] with the background,
    contributing mask [C, K, P], walked mask [C, K, P], gid [C, K],
    inside [C, P])."""
    ts = rules["tile_size"]
    gx = -(-width // ts)
    dev = fields.device
    tiles_t = torch.as_tensor(tiles, device=dev)
    kk = torch.arange(k_len, device=dev)
    live = kk[None, :] < pairs.tile_count[tiles_t][:, None]
    pos = torch.where(live, pairs.tile_start[tiles_t][:, None] + kk, 0)
    gid = torch.where(live, pairs.gid[pos], 0)
    f = fields[gid]                                         # [C, K, 9]
    u = torch.arange(ts, device=dev, dtype=torch.float32)
    px = ((tiles_t % gx) * ts)[:, None].float() + u.repeat(ts)[None, :]
    py = ((tiles_t // gx) * ts)[:, None].float() \
        + u.repeat_interleave(ts)[None, :]
    inside = (px < width) & (py < height)                    # [C, P]
    dx = px[:, None, :] - f[..., 0:1]
    dy = py[:, None, :] - f[..., 1:2]
    power = torch.log(f[..., 8:9]) - 0.5 * (
        f[..., 2:3] * dx * dx + f[..., 4:5] * dy * dy) - f[..., 3:4] * dx * dy
    keep = (live[..., None] & inside[:, None, :]
            & (power >= math.log(rules["alpha_cutoff"])))
    alpha = torch.where(keep, torch.clamp(torch.exp(power),
                                          max=rules["alpha_max"]), 0.0)
    with torch.no_grad():
        t_incl = torch.cumprod(1.0 - alpha, dim=1)
        fail = t_incl < rules["transmittance_eps"]
        done = torch.cumsum(fail.int(), 1) > 0      # this pair or one before
        walked = live[..., None] & inside[:, None, :] & (
            torch.cumsum(fail.int(), 1) - fail.int() == 0)
    t_excl = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                      1.0 - alpha[:, :-1]], 1), dim=1)
    contrib = keep & ~done
    wgt = torch.where(contrib, alpha * t_excl, 0.0)
    rgb = torch.einsum("ckp,ckq->cpq", wgt, f[..., 5:8])
    acc = wgt.sum(1)
    rgb = rgb + (1.0 - acc)[..., None] * bg
    return rgb, contrib, walked, gid, inside


def to_tiles(img: torch.Tensor, ts: int) -> torch.Tensor:
    """[H, W, 3] → [T, ts*ts, 3] in row-major tile order, zero past the
    image's edges."""
    h, w, c = img.shape
    gx, gy = -(-w // ts), -(-h // ts)
    pad = img.new_zeros((gy * ts, gx * ts, c))
    pad[:h, :w] = img
    return pad.reshape(gy, ts, gx, ts, c).permute(0, 2, 1, 3, 4).reshape(
        gx * gy, ts * ts, c)


def from_tiles(tiles: torch.Tensor, width: int, height: int,
               ts: int) -> torch.Tensor:
    """[T, ts*ts, 3] in row-major tile order → [H, W, 3]."""
    gx, gy = -(-width // ts), -(-height // ts)
    c = tiles.shape[-1]
    img = tiles.reshape(gy, gx, ts, ts, c).permute(0, 2, 1, 3, 4)
    return img.reshape(gy * ts, gx * ts, c)[:height, :width]


def composite(fields: torch.Tensor, pairs: Pairs, width: int, height: int,
              rules: dict, valid: Optional[torch.Tensor] = None):
    """The frame [H, W, 3] from the fields [N, 9] and the pairs, without a
    graph, and its `Counts`."""
    ts = rules["tile_size"]
    dev = fields.device
    bg = torch.tensor(rules["background"], dtype=torch.float32, device=dev)
    gx, gy = -(-width // ts), -(-height // ts)
    out = bg.expand(gx * gy, ts * ts, 3).clone()
    walked = passed = npairs = 0
    used = torch.zeros(fields.shape[0], dtype=torch.bool, device=dev)
    with torch.no_grad():
        for tiles, k_len in _chunks(pairs.tile_count, ts * ts):
            rgb, contrib, walk, gid, _ = _block(fields, pairs, tiles, k_len,
                                                width, height, rules, bg)
            out[torch.as_tensor(tiles, device=dev)] = rgb
            hit = contrib.any(-1)                             # [C, K]
            walked += int((walk & hit[..., None]).sum())
            passed += int(contrib.sum())
            npairs += int(hit.sum())
            used[gid[hit]] = True
    counts = Counts(walked=walked, passed=passed, pairs=npairs,
                    splats=int(used.sum()),
                    visible=int(valid.sum()) if valid is not None else 0,
                    tiles=gx * gy, pixels=width * height)
    return from_tiles(out, width, height, ts), counts


def composite_backward(fields: torch.Tensor, pairs: Pairs, width: int,
                       height: int, rules: dict,
                       d_img: torch.Tensor) -> torch.Tensor:
    """d loss / d fields [N, 9] for the image cotangent d_img [H, W, 3]:
    each block of tiles recomputed with autograd and its part of the
    vector-Jacobian product added up."""
    ts = rules["tile_size"]
    bg = torch.tensor(rules["background"], dtype=torch.float32,
                      device=fields.device)
    leaf = fields.detach().requires_grad_(True)
    d_tiles = to_tiles(d_img, ts)
    for tiles, k_len in _chunks(pairs.tile_count, ts * ts):
        with torch.enable_grad():
            rgb, *_ = _block(leaf, pairs, tiles, k_len, width, height, rules,
                             bg)
            torch.autograd.backward(
                rgb, d_tiles[torch.as_tensor(tiles, device=d_img.device)])
    return leaf.grad if leaf.grad is not None else torch.zeros_like(fields)


def render(scene, cam, width: int, height: int, rules: dict,
           tf32: bool = False):
    """The frame of `cam` → (image [H, W, 3], Counts), no graph."""
    with torch.no_grad():
        p = project(scene, cam, width, height, rules, tf32)
        pairs = tile_pairs(p, width, height, rules)
        return composite(p.fields, pairs, width, height, rules, p.valid)
