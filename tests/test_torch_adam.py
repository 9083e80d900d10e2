"""The port's Adam (`ops/cuda/adam.py`, kernel `csrc/adam.cu`).

On the CPU, `make_optimizer`'s Adam (the plain twin `adam_plain`) against
`torch.optim.Adam` over the six leaves of a small arena, bit for bit, with
the position schedule moving and a leaf left without a gradient; the state
layout that `reset_opt_rows`, checkpoints and the benchmark read; a
`torch.optim.Adam` state dict loaded and continued step for step.

Marked `gpu`: the kernel against `adam_plain` on the card, within a few
ulp a step, over ragged and unaligned leaves, 1, 6 and 10 leaves, and its
launch count. The file imports neither jax nor tests/conftest.py, so it
runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_adam.py
"""

import copy

import pytest
import torch

from gaussian_splatting_web_tpu_torch.bench_lib import ADAM_ULPS, adam_ulp_gap
from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
    GaussianModel,
)
from gaussian_splatting_web_tpu_torch.ops.cuda import build
from gaussian_splatting_web_tpu_torch.ops.cuda.adam import (
    MAX_LEAVES,
    Adam,
    Leaf,
    adam_plain,
)
from gaussian_splatting_web_tpu_torch.train.train_loop import (
    reset_opt_opacity,
    reset_opt_rows,
)
from gaussian_splatting_web_tpu_torch.train.trainer import (
    TrainState,
    apply_gradients,
    make_optimizer,
    set_learning_rates,
)

PARAMS = ("xyz", "log_scale", "quat", "opacity_logit", "sh_dc", "sh_rest")
# position_lr_max_steps=4 puts the decay and its clip inside five steps
KW = dict(scene_extent=2.5, position_lr_max_steps=4)
BETAS, EPS = (0.9, 0.999), 1e-15


def _leaves(n, seed, device="cpu"):
    """An arena of n rows at SH degree 3: [n, 3], [n, 3], [n, 4], [n],
    [n, 1, 3], [n, 15, 3]."""
    gen = torch.Generator().manual_seed(seed)
    shapes = ((n, 3), (n, 3), (n, 4), (n,), (n, 1, 3), (n, 15, 3))
    return [torch.randn(s, generator=gen).to(device) for s in shapes]


def _torch_adam(model):
    """torch.optim.Adam over `model` with make_optimizer's groups."""
    groups = [{k: v for k, v in g.items() if k in ("lr", "name", "lr_decay")}
              for g in make_optimizer(model, **KW).param_groups]
    return torch.optim.Adam(
        [{**g, "params": [getattr(model, f)]} for g, f in zip(groups, PARAMS)],
        betas=BETAS, eps=EPS)


def _set_grads(models, seed, skip=()):
    gen = torch.Generator().manual_seed(seed)
    for f in PARAMS:
        g = None
        if f not in skip:
            p = getattr(models[0], f)
            g = (torch.randn(p.shape, generator=gen) * 1e-3).to(p.device)
            g[:1] = 0.0
        for model in models:
            getattr(model, f).grad = None if g is None else g.clone()


def _assert_same(model_a, opt_a, model_b, opt_b):
    for f in PARAMS:
        pa, pb = getattr(model_a, f), getattr(model_b, f)
        assert torch.equal(pa, pb), f
        sa, sb = opt_a.state.get(pa, {}), opt_b.state.get(pb, {})
        assert sorted(sa) == sorted(sb), f
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (f, k)


@pytest.mark.parametrize("n", [1, 13, 1031])
def test_matches_torch_adam(n):
    """Five steps of make_optimizer's Adam (the plain twin on the CPU)
    equal torch.optim.Adam's bit for bit over arenas whose leaf sizes (3n,
    4n, n, 45n) are not multiples of 4; at step 2 opacity has no gradient
    and both leave its moments and step count as they were."""
    leaves = _leaves(n, seed=n)
    model, ref_model = GaussianModel(*leaves), GaussianModel(*leaves)
    opt = make_optimizer(model, **KW)
    assert isinstance(opt, Adam)
    state = TrainState(model, opt)
    ref = _torch_adam(ref_model)
    lrs = []
    for step in range(5):
        skip = ("opacity_logit",) if step == 2 else ()
        _set_grads((model, ref_model), seed=100 + step, skip=skip)
        before = copy.deepcopy(opt.state.get(model.opacity_logit, {}))
        apply_gradients(state)
        set_learning_rates(ref, step)
        ref.step()
        lrs.append(opt.param_groups[0]["lr"])
        assert lrs[-1] == ref.param_groups[0]["lr"]
        _assert_same(model, opt, ref_model, ref)
        if skip:
            after = opt.state[model.opacity_logit]
            for k in before:
                assert torch.equal(after[k], before[k]), k
    assert len(set(lrs)) == 5 and state.step == 5
    assert float(opt.state[model.xyz]["step"]) == 5.0
    assert float(opt.state[model.opacity_logit]["step"]) == 4.0


def test_state_layout_and_row_resets():
    """After a step each leaf's state is torch's: exp_avg and exp_avg_sq
    shaped as the leaf, step a CPU float32 scalar; the groups keep name and
    lr_decay; reset_opt_rows zeroes the changed rows of every moment and
    reset_opt_opacity the opacity moments, the step counts kept."""
    model = GaussianModel(*_leaves(9, seed=3))
    opt = make_optimizer(model, **KW)
    _set_grads((model,), seed=4)
    apply_gradients(TrainState(model, opt))
    assert [g["name"] for g in opt.param_groups] == [
        "xyz", "scale", "quat", "opacity", "sh_dc", "sh_rest"]
    assert opt.param_groups[0]["lr_decay"]["steps"] == 4
    for f in PARAMS:
        p = getattr(model, f)
        st = opt.state[p]
        assert sorted(st) == ["exp_avg", "exp_avg_sq", "step"]
        assert st["step"].device.type == "cpu" and st["step"].dim() == 0
        assert st["step"].dtype == torch.float32 and float(st["step"]) == 1
        for k in ("exp_avg", "exp_avg_sq"):
            assert st[k].shape == p.shape and st[k].dtype == p.dtype
            assert bool((st[k][1:] != 0).any()), (f, k)
    changed = torch.zeros(9, dtype=torch.bool)
    changed[[2, 5]] = True
    kept = ~changed
    moments = {f: {k: opt.state[getattr(model, f)][k].clone()
                   for k in ("exp_avg", "exp_avg_sq")} for f in PARAMS}
    reset_opt_rows(opt, changed)
    for f in PARAMS:
        st = opt.state[getattr(model, f)]
        for k in ("exp_avg", "exp_avg_sq"):
            assert bool((st[k][changed] == 0).all()), (f, k)
            assert torch.equal(st[k][kept], moments[f][k][kept]), (f, k)
        assert float(st["step"]) == 1
    reset_opt_opacity(opt, model.opacity_logit)
    st = opt.state[model.opacity_logit]
    assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()


def test_loads_torch_adam_state_dict():
    """A torch.optim.Adam state dict, saved after two steps, loads into
    make_optimizer's Adam, which then goes on step for step with the
    torch.optim.Adam it came from."""
    leaves = _leaves(21, seed=8)
    model, ref_model = GaussianModel(*leaves), GaussianModel(*leaves)
    ref = _torch_adam(ref_model)
    for step in range(2):
        _set_grads((ref_model,), seed=200 + step)
        set_learning_rates(ref, step)
        ref.step()
    with torch.no_grad():
        for f in PARAMS:
            getattr(model, f).copy_(getattr(ref_model, f))
    opt = make_optimizer(model, **KW)
    opt.load_state_dict(copy.deepcopy(ref.state_dict()))
    _assert_same(model, opt, ref_model, ref)
    state = TrainState(model, opt, step=2)
    for step in range(2, 5):
        _set_grads((model, ref_model), seed=200 + step)
        apply_gradients(state)
        set_learning_rates(ref, step)
        ref.step()
        _assert_same(model, opt, ref_model, ref)


def test_refuses_what_it_does_not_take():
    """Weight decay raises (the kernel has none), and a device that is
    neither the CPU nor CUDA has no Adam."""
    p = torch.nn.Parameter(torch.ones(5))
    p.grad = torch.ones(5)
    with pytest.raises(ValueError, match="weight decay"):
        Adam([p], weight_decay=0.1).step()
    q = torch.nn.Parameter(torch.ones(5, device="meta"))
    q.grad = torch.ones(5, device="meta")
    with pytest.raises(ValueError, match="no Adam"):
        Adam([q]).step()


# --- the kernel on the card ------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# name → [(elements, storage offset in floats, has a gradient)]
CASES = {
    "one leaf": [(1_000_003, 0, True)],
    "six leaves": [(s * 4097, 0, True) for s in (3, 3, 4, 1, 3, 45)]
    + [(4097, 0, False)],
    "unaligned": [(2049, 1, True), (7, 0, True), (12_345, 3, True),
                  (8192, 0, True)],
    "ten leaves": [(k * 997, 0, True) for k in range(1, 11)],
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_twin(device, case):
    """Four steps of Adam through csrc/adam.cu; before each, the twin
    `adam_plain` takes the same step from the same state on the card. p, m
    and v agree within 4 ulp; a leaf without a gradient keeps no state; one
    step is ceil(leaves with a gradient / 8) launches."""
    gen = torch.Generator(device=device).manual_seed(len(case))
    params, grads = [], []
    for n, offset, has_grad in CASES[case]:
        base = torch.randn(n + offset, generator=gen, device=device)
        params.append(torch.nn.Parameter(base[offset:]))
        grads.append(has_grad)
        assert params[-1].data_ptr() % 16 == (4 * offset) % 16
    lrs = [1e-3 * (k + 1) for k in range(len(params))]
    opt = Adam([{"params": [p], "lr": lr} for p, lr in zip(params, lrs)],
               betas=BETAS, eps=EPS)
    with_grad = sum(grads)
    for t in range(1, 5):
        for p, has_grad in zip(params, grads):
            p.grad = None
            if has_grad:
                g = torch.randn(p.numel() + 1, generator=gen, device=device)
                p.grad = g[1:] if p.data_ptr() % 16 else g[:-1]
        twin = []
        for p, lr in zip(params, lrs):
            if p.grad is None:
                continue
            st = opt.state.get(p)
            m, v = ((st["exp_avg"].clone(), st["exp_avg_sq"].clone()) if st
                    else (torch.zeros_like(p), torch.zeros_like(p)))
            twin.append(Leaf(p.detach().clone(), p.grad, m, v,
                             lr / (1 - BETAS[0] ** t),
                             (1 - BETAS[1] ** t) ** 0.5, *BETAS, EPS))
        old = [(x.p.clone(), x.m.clone(), x.v.clone()) for x in twin]
        adam_plain(twin)
        before = build.launch_counts()["adam"]
        opt.step()
        torch.cuda.synchronize()
        assert (build.launch_counts()["adam"] - before
                == -(-with_grad // MAX_LEAVES))
        got = [p for p in params if p.grad is not None]
        for k, (p, x, o) in enumerate(zip(got, twin, old)):
            st = opt.state[p]
            assert float(st["step"]) == t
            for name, a, b, prev in (("p", p.detach(), x.p, o[0]),
                                     ("m", st["exp_avg"], x.m, o[1]),
                                     ("v", st["exp_avg_sq"], x.v, o[2])):
                assert bool(torch.isfinite(a).all()), (case, k, name)
                gap = adam_ulp_gap(a, b, prev)
                assert gap <= ADAM_ULPS, (case, t, k, name, gap)
            assert not torch.equal(p.detach(), o[0]), (case, k)
    for p, has_grad in zip(params, grads):
        assert (p in opt.state) == has_grad


@pytest.mark.gpu
def test_one_launch_a_train_step(device):
    """make_optimizer's Adam over a GaussianModel on the card: one launch a
    step for its six leaves, every moment finite and set."""
    model = GaussianModel(*_leaves(3001, seed=5, device=device))
    state = TrainState(model, make_optimizer(model, **KW))
    for step in range(2):
        _set_grads((model,), seed=300 + step)
        before = build.launch_counts()["adam"]
        apply_gradients(state)
        assert build.launch_counts()["adam"] == before + 1
    torch.cuda.synchronize()
    for f in PARAMS:
        st = state.optimizer.state[getattr(model, f)]
        assert float(st["step"]) == 2
        for k in ("exp_avg", "exp_avg_sq"):
            assert bool(torch.isfinite(st[k]).all()) and bool(st[k].any())
