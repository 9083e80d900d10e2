"""Gaussian-sharded training through `train()`'s step
(`parallel/gaussian_sharded.py::make_gaussian_sharded_densify_step`), on
gloo ranks on the CPU:

  * four ranks take three steps of Rubble's configuration cut to 2,000
    Gaussians at 64x64, SH degree 3, the banded a2a stream, and are held to
    the benchmark's plain reference (`benchmark/reference/train.py::
    run_steps`) under the limits of the cell's traffic file; the exchange
    cuts no row, and each shard's densification statistics equal the rows
    of the single-device step's (`train_loop.make_densify_train_step`).
    The frame is 64x64 rather than 48 rows high: 48 rows are 3 rows of
    tiles for 4 bands, one band empty and the middle one holding more than
    half of every shard, more than the even share times `cand_factor` 2.5;
  * rank 0 profiles its third step: the step's spans and the exchange's
    counters show, and `tracing.count_device` reads nothing back to the
    host (no `aten::_local_scalar_dense`, the op behind `.item()`);
  * `cli train --multihost --gaussian-sharded=banded` on two ranks started
    as torchrun starts them writes the gathered PLY, and refuses a
    densification round and `--checkpoint` with the stated error;
  * `train()` on four ranks at 64x48, where the exchange cuts rows, raises
    on every rank after its last step and names the rows cut.
"""

import contextlib
import copy
import io
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import check
from benchmark import inputs as inp
from benchmark.reference import train as ref_train
from gaussian_splatting_web_tpu_torch import cli
from gaussian_splatting_web_tpu_torch.core.types import CameraParams
from gaussian_splatting_web_tpu_torch.io.dataset import View
from gaussian_splatting_web_tpu_torch.io.ply import read_ply
from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
    GaussianModel,
)
from gaussian_splatting_web_tpu_torch.parallel import (
    make_gaussian_sharded_densify_step,
    make_mesh,
)
from gaussian_splatting_web_tpu_torch.parallel.gaussian_sharded import (
    ROW,
    banded_cap_hop,
)
from gaussian_splatting_web_tpu_torch.train.densify import pad_to_capacity
from gaussian_splatting_web_tpu_torch.train.train_loop import (
    TrainLoopConfig,
    make_densify_train_step,
    train,
)
from gaussian_splatting_web_tpu_torch.train.trainer import (
    TrainState,
    make_optimizer,
)
from gaussian_splatting_web_tpu_torch.utils import tracing
from tests.test_torch_multihost import _free_port, _join_group, _write_capture

ROOT = Path(__file__).resolve().parents[1]
WORLD, STEPS, SEED = 4, 3, 4000000021
SPANS = {"step", "projection", "exchange", "binning", "composite", "gather",
         "loss", "backward", "return", "adam"}
COUNTERS = {"exchange.slots", "exchange.bytes_off", "exchange.live_rows",
            "exchange.band_max", "exchange.overflow"}


def _cell():
    cfg = json.loads((ROOT / "benchmark/configs/rubble.json").read_text())
    cfg.update(num_gaussians=2000, width=64, height=64, views=16)
    traffic = json.loads(
        (ROOT / "benchmark/traffic/gshard-train.json").read_text())
    return cfg, traffic


def _program(cfg, scene, extent):
    """The arena with every row live and its optimizer, as the benchmark's
    loops and `train()` build them."""
    t = cfg["train"]
    params, dstate = pad_to_capacity(
        GaussianModel(*(scene[k] for k in inp.LEAVES)), scene["xyz"].shape[0])
    opt = make_optimizer(
        params, scene_extent=extent, position_lr=t["position_lr"],
        position_lr_final=t["position_lr_final"],
        position_lr_max_steps=t["position_lr_steps"], sh_dc_lr=t["sh_dc_lr"],
        sh_rest_lr_div=t["sh_rest_lr_div"], opacity_lr=t["opacity_lr"],
        scale_lr=t["scale_lr"], quat_lr=t["quat_lr"])
    return TrainState(params, opt), dstate


def _views(cfg):
    data = inp.make_inputs(cfg, SEED, "cpu")
    order = inp.request_order(data.train_ids, STEPS, SEED, shuffle=True)
    targets = inp.make_targets(cfg, SEED, STEPS, "cpu")
    return data, order, targets


class _NoHostRead(TorchDispatchMode):
    """Fails on any op that reads a tensor's value back to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("count_device read a value to the host")
        return func(*args, **(kwargs or {}))


def _rank(rank, folder):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{folder}/store",
                            world_size=WORLD, rank=rank)
    try:
        cfg, traffic = _cell()
        mesh = make_mesh(tile=WORLD)
        data, order, targets = _views(cfg)
        n_s = cfg["num_gaussians"] // WORLD
        shard = {k: v[rank * n_s:(rank + 1) * n_s]
                 for k, v in data.scene.items()}
        state, dstate = _program(cfg, shard, data.extent)
        step = make_gaussian_sharded_densify_step(
            cfg["width"], cfg["height"], mesh,
            _render_config(cfg), cfg["train"]["lambda_dssim"],
            banded=traffic["banded"], cand_factor=traffic["cand_factor"],
            stream=traffic["stream"])
        res = {"loss": [], "calls": []}
        guarded = tracing.count_device

        def no_read(name, value):
            with _NoHostRead():
                guarded(name, value)
            res["calls"].append(name)

        tracing.count_device = no_read
        for k, v in enumerate(order):
            prof = (profile(activities=[ProfilerActivity.CPU])
                    if rank == 0 and k == STEPS - 1
                    else contextlib.nullcontext())
            with prof:
                state, dstate, loss = step(
                    state, dstate, CameraParams(**data.cameras[v]),
                    targets[k], traffic["sh_degree"])
            res["loss"].append(float(loss))
            if k == 0:
                res["grad_sq"] = {
                    f: float((state.optimizer.state[getattr(state.model, f)]
                              ["exp_avg"].double() ** 2).sum())
                    / (1 - cfg["train"]["adam_betas"][0]) ** 2
                    for f in inp.LEAVES}
        tracing.count_device = guarded
        res["change_sq"] = {f: float(((getattr(state.model, f).detach()
                                       - shard[f]).double() ** 2).sum())
                            for f in inp.LEAVES}
        res["overflow"] = int(step.overflow)
        res["dstate"] = {f: getattr(dstate, f).clone()
                         for f in ("grad_accum", "denom", "max_radius2d")}
        if rank == 0:
            res["spans"] = {e.name[3:] for e in prof.events()
                            if e.name.startswith(tracing.PREFIX)}
            res["counters"] = tracing.counters()
        torch.save(res, os.path.join(folder, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _render_config(cfg):
    from benchmark.harness import program_render_config

    return program_render_config(cfg)


def test_sharded_steps_match_the_reference_and_the_single_device_stats(
        tmp_path):
    ctx = mp.spawn(_rank, nprocs=WORLD, join=False, args=(str(tmp_path),))
    _join_group(ctx, seconds=300)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]

    cfg, traffic = _cell()
    data, order, targets = _views(cfg)
    ref = ref_train.run_steps(data.scene, [data.cameras[v] for v in order],
                              list(targets), cfg, data.extent)
    prog = {"loss": ranks[0]["loss"],
            "grad_norm": {f: sum(r["grad_sq"][f] for r in ranks) ** 0.5
                          for f in inp.LEAVES},
            "change_norm": {f: sum(r["change_sq"][f] for r in ranks) ** 0.5
                            for f in inp.LEAVES}}
    numbers = dict(check.train_numbers(prog, ref),
                   overflow=sum(r["overflow"] for r in ranks))
    ok, checks = check.judge(numbers, traffic["limits"])
    assert ok, checks
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)

    # the single-device step's densification statistics, row for row
    state, dstate = _program(cfg, data.scene, data.extent)
    one = make_densify_train_step(cfg["width"], cfg["height"],
                                  _render_config(cfg),
                                  cfg["train"]["lambda_dssim"])
    for k, v in enumerate(order):
        state, dstate, _ = one(state, dstate, CameraParams(**data.cameras[v]),
                               targets[k], traffic["sh_degree"])
    n_s = cfg["num_gaussians"] // WORLD
    for r, got in enumerate(ranks):
        rows = slice(r * n_s, (r + 1) * n_s)
        assert torch.equal(got["dstate"]["denom"], dstate.denom[rows])
        assert torch.equal(got["dstate"]["max_radius2d"],
                           dstate.max_radius2d[rows])
        want = dstate.grad_accum[rows]
        torch.testing.assert_close(got["dstate"]["grad_accum"], want,
                                   rtol=1e-4, atol=1e-4 * float(want.max()))
        assert float(want.max()) > 0

    # rank 0's profiled step: its spans, its counters, no host read
    assert SPANS <= ranks[0]["spans"], SPANS - ranks[0]["spans"]
    c = ranks[0]["counters"]
    assert COUNTERS <= set(c), COUNTERS - set(c)
    slots = WORLD * banded_cap_hop(cfg["num_gaussians"], WORLD,
                                   traffic["cand_factor"])
    assert c["exchange.slots"] == slots
    assert c["exchange.bytes_off"] == 2 * slots * ROW * 4 * (WORLD - 1) \
        // WORLD
    assert 0 < c["exchange.live_rows"] <= slots
    assert c["exchange.live_rows"] <= WORLD * c["exchange.band_max"]
    assert c["exchange.overflow"] == 0
    assert set(ranks[0]["calls"]) == {"exchange.live_rows",
                                      "exchange.band_max",
                                      "exchange.overflow"}


def test_count_device_adds_on_the_device_only_while_tracing():
    before = tracing.counters().get("test.device", 0)
    tracing.count_device("test.device", torch.tensor(5))
    assert tracing.counters().get("test.device", 0) == before
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count_device("test.device", torch.tensor(5))
        tracing.count_device("test.device", torch.tensor(2, dtype=torch.int32))
    assert tracing.counters()["test.device"] == before + 7


def _cli_rank(rank, ports, folder):
    """`cli train --multihost --gaussian-sharded=banded` on one rank of a
    2-rank gloo group started as torchrun starts it: a short run, then a
    run that reaches a densification round, then one with --checkpoint."""
    torch.set_num_threads(1)
    base = ["train", "--multihost", "--gaussian-sharded=banded",
            "--ply", f"{folder}/init.ply", "--cameras",
            f"{folder}/cameras.json", "--images", f"{folder}/images",
            "--width", "32", "--height", "24", "--max-dup", "16",
            "--max-per-tile", "64", "--device", "cpu"]
    runs = [["--iterations", "4", "--out", f"{folder}/sharded.ply"],
            ["--iterations", "600", "--out", f"{folder}/never.ply"],
            ["--iterations", "4", "--checkpoint", f"{folder}/ckpt",
             "--out", f"{folder}/never.ply"]]
    out = []
    for port, extra in zip(ports, runs):
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          WORLD_SIZE="2", RANK=str(rank),
                          LOCAL_RANK=str(rank))
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                cli.main(base + extra)
            out.append(("ok", err.getvalue()))
        except NotImplementedError as e:
            out.append(("refused", str(e)))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    torch.save(out, os.path.join(folder, f"cli{rank}.pt"))


def test_cli_train_gaussian_sharded_on_two_ranks(tmp_path):
    _write_capture(str(tmp_path))
    ports = [_free_port() for _ in range(3)]
    _join_group(mp.spawn(_cli_rank, nprocs=2, join=False,
                         args=(ports, str(tmp_path))), seconds=300)
    logs = [torch.load(tmp_path / f"cli{r}.pt") for r in range(2)]
    for rank, (short, densify, ckpt) in enumerate(logs):
        assert short[0] == "ok"
        assert densify[0] == "refused" and "densification round" in \
            densify[1] and "Gaussian-sharded arena" in densify[1]
        assert ckpt[0] == "refused" and "checkpoint" in ckpt[1]
    assert "saved 16 gaussians" in logs[0][0][1]
    assert "saved" not in logs[1][0][1]
    assert not (tmp_path / "never.ply").exists()
    trained = read_ply(str(tmp_path / "sharded.ply"), device="cpu")
    init = read_ply(str(tmp_path / "init.ply"), device="cpu")
    assert trained.num_gaussians == init.num_gaussians == 16
    moved = (trained.xyz - init.xyz).abs().max()
    assert 0 < float(moved) < 0.1


def _overflow_rank(rank, folder):
    """`train()` on one of four gloo ranks at 64x48: 3 rows of tiles for 4
    bands, so the middle band takes more of a shard than the exchange
    carries."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{folder}/store",
                            world_size=WORLD, rank=rank)
    try:
        cfg, _ = _cell()
        cfg.update(height=48)
        data, order, targets = _views(cfg)
        views = [View(CameraParams(**data.cameras[v]), targets[k].numpy(),
                      str(v)) for k, v in enumerate(order[:2])]
        model = GaussianModel(*(data.scene[k] for k in inp.LEAVES))
        try:
            train(model, views, cfg["width"], cfg["height"],
                  render_config=_render_config(cfg),
                  loop=TrainLoopConfig(iterations=2), device="cpu",
                  mesh=make_mesh(tile=WORLD))
            out = ("ok", "")
        except RuntimeError as e:
            out = ("raised", str(e))
        torch.save(out, os.path.join(folder, f"over{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_train_raises_when_the_exchange_cuts_rows(tmp_path):
    _join_group(mp.spawn(_overflow_rank, nprocs=WORLD, join=False,
                         args=(str(tmp_path),)), seconds=300)
    outs = [torch.load(tmp_path / f"over{r}.pt") for r in range(WORLD)]
    assert all(o == outs[0] for o in outs), outs
    kind, msg = outs[0]
    assert kind == "raised", msg
    assert "exchange cut" in msg and "by iteration 2" in msg
    assert int(msg.split("exchange cut ")[1].split()[0]) > 0
