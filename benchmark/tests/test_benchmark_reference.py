"""The plain reference against cases worked out by hand."""

import math

import torch

from benchmark.reference import render as R
from benchmark.reference import train as T

RULES = {"tile_size": 16, "max_dup": 16, "max_per_tile": 1024,
         "gather_cap_factor": 3.0, "gather_cap_floor": 65536,
         "lowpass": 0.3, "fov_clamp": 1.3, "max_radius_px": 4096.0,
         "alpha_cutoff": 1.0 / 255.0, "alpha_max": 0.99,
         "transmittance_eps": 1e-4, "background": [0.0, 0.0, 0.0]}


def fields(rows):
    """[N, 9] fields from (mx, my, A, B, C, r, g, b, opacity) rows."""
    return torch.tensor(rows, dtype=torch.float32)


def pairs_of(tile_lists, tiles):
    """Pairs from per-tile Gaussian lists, front to back."""
    gid, start, count = [], [], []
    for t in range(tiles):
        lst = tile_lists.get(t, [])
        start.append(len(gid))
        count.append(len(lst))
        gid.extend(lst)
    return R.Pairs(gid=torch.tensor(gid, dtype=torch.long),
                   tile_start=torch.tensor(start),
                   tile_count=torch.tensor(count), num_pairs=len(gid))


def test_one_splat_at_its_centre():
    # isotropic conic 1/4 (sigma 2 px), opacity 0.5, at pixel (5, 7)
    f = fields([[5.0, 7.0, 0.25, 0.0, 0.25, 0.2, 0.4, 0.6, 0.5]])
    img, c = R.composite(f, pairs_of({0: [0]}, 1), 16, 16, RULES)
    assert torch.allclose(img[7, 5], torch.tensor([0.1, 0.2, 0.3]))
    # one pixel right: alpha = 0.5 exp(-1/8)
    a = 0.5 * math.exp(-0.125)
    assert torch.allclose(img[7, 6], torch.tensor([0.2, 0.4, 0.6]) * a)
    assert c.pairs == 1 and c.splats == 1 and c.tiles == 1
    # alpha >= 1/255 where (dx^2 + dy^2) / 8 <= ln(127.5)
    expect = sum(1 for y in range(16) for x in range(16)
                 if ((x - 5) ** 2 + (y - 7) ** 2) / 8 <= math.log(127.5))
    assert c.passed == expect and c.walked == 256


def test_front_to_back_order_and_clamp():
    # two coincident splats: the front one opaque past alpha_max
    f = fields([[8.0, 8.0, 1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0],
                [8.0, 8.0, 1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.5]])
    img, c = R.composite(f, pairs_of({0: [0, 1]}, 1), 16, 16, RULES)
    # C = 0.99 * red + (1 - 0.99) * 0.5 * green at the centre
    assert torch.allclose(img[8, 8], torch.tensor([0.99, 0.005, 0.0]))
    assert c.pairs == 2


def test_transmittance_stops_the_walk():
    # a stack of alpha-0.95 splats: T after k of them is 0.05^k, so the
    # fourth (T 6.25e-6 < 1e-4) and all behind it contribute nothing
    f = fields([[8.0, 8.0, 1e-9, 0.0, 1e-9, 1.0, 1.0, 1.0, 0.95]] * 6)
    img, c = R.composite(f, pairs_of({0: list(range(6))}, 1), 16, 16,
                         RULES)
    want = 0.95 * (1 + 0.05 + 0.05 ** 2)
    assert torch.allclose(img[8, 8], torch.full((3,), want), atol=1e-6)
    # the fourth pair is walked but contributes nowhere, so it is not
    # counted: walked steps are those of the contributing pairs
    assert c.passed == 3 * 256 and c.walked == 3 * 256 and c.pairs == 3


def test_background_fills_uncovered_pixels():
    rules = dict(RULES, background=[0.25, 0.5, 1.0])
    f = fields([[100.0, 100.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.5]])
    img, _ = R.composite(f, pairs_of({}, 4), 20, 20, rules)
    assert img.shape == (20, 20, 3)
    assert torch.equal(img[19, 19], torch.tensor([0.25, 0.5, 1.0]))


def test_backward_matches_finite_differences():
    torch.manual_seed(0)
    f = fields([[6.3, 7.1, 0.3, 0.05, 0.2, 0.3, 0.6, 0.9, 0.7],
                [9.2, 8.4, 0.15, -0.02, 0.25, 0.8, 0.1, 0.4, 0.6]])
    pairs = pairs_of({0: [1, 0]}, 1)
    d_img = torch.rand((16, 16, 3))
    grad = R.composite_backward(f, pairs, 16, 16, RULES, d_img)
    f64 = f.double()
    for g, k in ((0, 0), (0, 2), (1, 5), (1, 8), (0, 1)):
        eps = 1e-3
        hi, lo = f64.clone(), f64.clone()
        hi[g, k] += eps
        lo[g, k] -= eps
        num = ((R.composite(hi.float(), pairs, 16, 16, RULES)[0]
                - R.composite(lo.float(), pairs, 16, 16, RULES)[0]).double()
               * d_img.double()).sum() / (2 * eps)
        assert abs(float(num) - float(grad[g, k])) <= 2e-2 * max(
            1.0, abs(float(num))), (g, k)


def test_projection_of_a_point_ahead():
    # camera at the origin looking down +z, focal 100 px on a 200x100 frame
    view = torch.eye(4)
    zn, zf = 0.1, 100.0
    proj = torch.zeros((4, 4))
    proj[0, 0], proj[1, 1] = 1.0, 2.0           # tan x 1, tan y 0.5
    proj[2, 2], proj[2, 3] = zf / (zf - zn), -zf * zn / (zf - zn)
    proj[3, 2] = 1.0
    cam = {"view": view, "proj": proj, "cam_pos": torch.zeros(3),
           "focal": torch.tensor([100.0, 100.0]),
           "tan_half_fov": torch.tensor([1.0, 0.5]),
           "scale_modifier": torch.tensor(1.0)}
    scene = {"xyz": torch.tensor([[1.0, 0.5, 5.0]]),
             "log_scale": torch.full((1, 3), math.log(0.1)),
             "quat": torch.tensor([[0.0, 0.0, 0.0, 1.0]]),
             "opacity_logit": torch.zeros(1),
             "sh_dc": torch.zeros((1, 1, 3)),
             "sh_rest": torch.zeros((1, 15, 3))}
    p = R.project(scene, cam, 200, 100, RULES)
    # ndc (0.2, 0.2) → pixel ((1.2 * 200 - 1) / 2, (1.2 * 100 - 1) / 2)
    assert torch.allclose(p.fields[0, :2], torch.tensor([119.5, 59.5]))
    assert math.isclose(float(p.depth[0]), 5.0, rel_tol=1e-6)
    # isotropic sigma 0.1 at z 5 → 2 px, so cov2 ≈ 4 (+ J's x and y
    # terms) + 0.3 on the diagonal; rgb 0.5 from zero SH; opacity 0.5
    assert 4.3 < float(p.cov[0, 0]) < 4.6 and 4.3 < float(p.cov[0, 2]) < 4.5
    assert torch.allclose(p.fields[0, 5:9], torch.tensor([0.5, 0.5, 0.5, 0.5]))
    assert bool(p.valid[0])


def test_tile_pairs_sort_cap_and_shrink():
    f = torch.zeros((3, 9))
    f[:, 0], f[:, 1] = torch.tensor([8.0, 8.0, 40.0]), 8.0
    f[:, 8] = 0.5
    p = R.Projected(fields=f, depth=torch.tensor([3.0, 1.0, 2.0]),
                    cov=torch.tensor([[4.0, 0.0, 4.0]] * 3),
                    radius=torch.tensor([8.0, 8.0, 8.0]),
                    valid=torch.tensor([True, True, True]))
    pairs = R.tile_pairs(p, 64, 16, RULES)
    # tile 0 holds splats 1 then 0 (depth order), tile 2 holds splat 2
    t0 = pairs.gid[pairs.tile_start[0]:][:int(pairs.tile_count[0])]
    assert t0.tolist() == [1, 0]
    assert int(pairs.tile_count[2]) >= 1
    capped = R.tile_pairs(p, 64, 16, dict(RULES, max_per_tile=1))
    assert int(capped.tile_count[0]) == 1
    # a rectangle of 25 tiles shrinks to at most max_dup = 16
    big = R.Projected(fields=f[:1], depth=torch.ones(1),
                      cov=torch.tensor([[400.0, 0.0, 400.0]]),
                      radius=torch.tensor([100.0]),
                      valid=torch.tensor([True]))
    assert R.tile_pairs(big, 80, 80, RULES).num_pairs <= 16


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, 3.0])
    assert R.tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]


def test_loss_and_adam():
    t = {"lambda_dssim": 0.2, "ssim_window": 11, "ssim_sigma": 1.5,
         "ssim_c1": 1e-4, "ssim_c2": 9e-4, "adam_betas": [0.9, 0.999],
         "adam_eps": 1e-15}
    img = torch.rand((20, 24, 3))
    assert abs(float(T.ssim(img, img, t)) - 1.0) < 1e-5
    assert float(T.loss_fn(img, img, t)) < 1e-5
    # L1 alone: a constant offset of 0.1 gives 0.8 * 0.1 plus D-SSIM >= 0
    assert math.isclose(
        float(T.loss_fn(img + 0.1, img, dict(t, lambda_dssim=0.0))), 0.1,
        rel_tol=1e-6)
    p = {"a": torch.tensor([1.0, 2.0])}
    opt = T.Adam(p, t)
    opt.step(p, {"a": torch.tensor([3.0, -4.0])}, {"a": 0.5})
    # the first step moves each element by lr · sign(g)
    assert torch.allclose(p["a"], torch.tensor([0.5, 2.5]))


def test_learning_rates_follow_the_schedule():
    t = {"position_lr": 1.6e-4, "position_lr_final": 1.6e-6,
         "position_lr_steps": 30000, "scale_lr": 5e-3, "quat_lr": 1e-3,
         "opacity_lr": 0.05, "sh_dc_lr": 2.5e-3, "sh_rest_lr_div": 20.0}
    assert math.isclose(T.learning_rates(t, 2.0, 0)["xyz"], 3.2e-4)
    assert math.isclose(T.learning_rates(t, 2.0, 15000)["xyz"], 3.2e-5)
    assert math.isclose(T.learning_rates(t, 2.0, 60000)["xyz"], 3.2e-6)
    assert math.isclose(T.learning_rates(t, 1.0, 0)["sh_rest"], 1.25e-4)
