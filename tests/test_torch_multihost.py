"""Multi-host start, the checkpoint-restart loop and the dry run of the
port (`parallel/multihost.py`, `parallel/dryrun.py`) against the JAX
package's `parallel/multihost.py` and `__graft_entry__.dryrun_multichip`.
The restart cases of `tests/test_parallel.py:323-400` run through both
packages' `run_with_restarts` (pure Python in both); process groups are
gloo on the CPU over localhost."""

import contextlib
import dataclasses
import io
import json
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gaussian_splatting_web_tpu_torch import cli
from gaussian_splatting_web_tpu_torch.core.camera import default_camera
from gaussian_splatting_web_tpu_torch.io.ply import write_ply
from gaussian_splatting_web_tpu_torch.ops.rasterize import render
from gaussian_splatting_web_tpu_torch.parallel import dryrun, multihost
from gaussian_splatting_web_tpu_torch.parallel.dryrun import (
    CONFIG,
    HEIGHT,
    WIDTH,
    dryrun_multichip,
    tiny_scene,
)
from gaussian_splatting_web_tpu_torch.train.checkpoint import LOOP_STATE
from gaussian_splatting_web_tpu_torch.utils.image import write_png

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK")


class UnavailableError(Exception):
    """An RPC-style transient failure that subclasses none of the builtin
    transient classes (the grpc name the JAX test uses)."""


# (what each call raises until it returns, max_restarts) →
# (the result or the exception raised, the number of calls)
CASES = {
    "retries_then_succeeds": ([RuntimeError("preempted")] * 2, 3,
                              "done", 3),
    "gives_up": ([RuntimeError("hard failure")] * 9, 2, RuntimeError, 3),
    "deterministic_not_retried": ([ValueError("shape mismatch")], 3,
                                  ValueError, 1),
    "named_transient_retried": ([UnavailableError("channel down")], 3,
                                "done", 2),
    "dist_network_error_retried": (
        [dist.DistNetworkError("peer reset"),
         dist.DistStoreError("store timeout")], 3, "done", 3),
    "os_error_retried": ([OSError("checkpoint I/O")], 1, "done", 2),
    "keyboard_interrupt_raised": ([KeyboardInterrupt()], 3,
                                  KeyboardInterrupt, 1),
}


def _outcome(run_with_restarts, raises, max_restarts):
    calls = []

    def train_fn(ckpt):
        calls.append(ckpt)
        if len(calls) <= len(raises):
            raise raises[len(calls) - 1]
        return "done"

    try:
        out = run_with_restarts(train_fn, checkpoint_dir="ckpt",
                                max_restarts=max_restarts, backoff_s=0.0)
    except BaseException as e:  # noqa: BLE001 — the outcome under test
        out = type(e)
    assert set(calls) == {"ckpt"}
    return out, len(calls)


@pytest.mark.parametrize("case", list(CASES))
def test_run_with_restarts_matches_jax(case):
    from gaussian_splatting_web_tpu.parallel.multihost import (
        run_with_restarts as jax_run_with_restarts,
    )

    raises, max_restarts, result, calls = CASES[case]
    got = _outcome(multihost.run_with_restarts, raises, max_restarts)
    assert got == (result, calls)
    assert got == _outcome(jax_run_with_restarts, raises, max_restarts)


def test_run_with_restarts_backs_off_linearly(monkeypatch):
    slept = []
    monkeypatch.setattr(multihost.time, "sleep", slept.append)
    with pytest.raises(RuntimeError):
        multihost.run_with_restarts(
            lambda _: (_ for _ in ()).throw(RuntimeError("down")),
            max_restarts=3, backoff_s=2.0)
    assert slept == [2.0, 4.0, 6.0]


def test_initialize_multihost_noop_without_coordinator(monkeypatch):
    for var in TORCHRUN_ENV:
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_multihost() is False
    assert multihost.initialize_multihost(device="cpu") is False
    assert not dist.is_initialized()


def test_initialize_multihost_refuses_a_missing_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize_multihost(device="cuda")
    assert not dist.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_rank(rank, port, folder):
    """A rank started as torchrun starts it: everything from the
    environment."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))
    joined = multihost.initialize_multihost(device="cpu")
    try:
        x = torch.tensor([float(rank + 1)])
        dist.all_reduce(x)
        torch.save((joined, dist.get_backend(), dist.get_world_size(),
                    dist.get_rank(), float(x)),
                   os.path.join(folder, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_initialize_multihost_from_torchrun_env(tmp_path):
    """Two processes with torchrun's environment join one gloo group over
    localhost and all-reduce in it."""
    ctx = mp.spawn(_env_rank, nprocs=2, join=False,
                   args=(_free_port(), str(tmp_path)))
    _join_group(ctx)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got == (True, "gloo", 2, r, 3.0)


def _join_group(ctx, seconds=120):
    deadline = time.monotonic() + seconds
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"the group did not finish in {seconds} s")


def _write_capture(folder, n_views=2, w=32, h=24):
    """Two posed PNG views of the dry run's scene and their cameras.json,
    as INRIA writes it."""
    cloud = tiny_scene(n=64)
    os.makedirs(os.path.join(folder, "images"))
    entries = []
    for i in range(n_views):
        camera = default_camera(w, h, eye=(0.5 * i, 0.3, -6),
                                center=(0, 0, 0))
        with torch.no_grad():
            img, _ = render(cloud, camera, w, h, CONFIG)
        write_png(img.numpy(), os.path.join(folder, "images", f"v{i}.png"))
        entries.append({
            "id": i, "img_name": f"v{i}", "width": w, "height": h,
            "position": camera.cam_pos.numpy().tolist(),
            "rotation": camera.view.numpy()[:3, :3].T.tolist(),
            "fx": float(camera.focal[0]), "fy": float(camera.focal[1])})
    with open(os.path.join(folder, "cameras.json"), "w") as f:
        json.dump(entries, f)
    write_ply(tiny_scene(n=16, seed=3), os.path.join(folder, "init.ply"))


def _train_rank(rank, port, folder, iterations, extra):
    """`cli train --multihost --checkpoint` on one rank of a 2-rank gloo
    group started as torchrun starts it. Saves what the rank printed."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        cli.main(["train", "--multihost", "--ply", f"{folder}/init.ply",
                  "--cameras", f"{folder}/cameras.json",
                  "--images", f"{folder}/images", "--width", "32",
                  "--height", "24", "--max-dup", "16", "--max-per-tile",
                  "64", "--device", "cpu", "--checkpoint", f"{folder}/ckpt",
                  "--checkpoint-every", "4", "--iterations", iterations,
                  "--out", f"{folder}/out{iterations}.ply", *extra])
    torch.save(err.getvalue(),
               os.path.join(folder, f"log{iterations}_{rank}.pt"))


def test_cli_train_multihost_checkpoints_from_rank_zero(tmp_path):
    """Two ranks train the same replicated loop into one --checkpoint
    directory (a stale loop state from an earlier run in it): rank 0 alone
    clears it for --fresh and writes the loop state and the outputs, and
    both ranks of the next job resume from it."""
    _write_capture(str(tmp_path))
    (tmp_path / "ckpt").mkdir()
    (tmp_path / "ckpt" / LOOP_STATE).write_bytes(b"stale")
    for iterations, extra in (("8", ["--fresh"]), ("12", [])):
        _join_group(mp.spawn(_train_rank, nprocs=2, join=False, args=(
            _free_port(), str(tmp_path), iterations, extra)))
    logs = [[torch.load(tmp_path / f"log{n}_{r}.pt") for n in ("8", "12")]
            for r in range(2)]
    assert "--fresh: removed" in logs[0][0]
    assert "--fresh: removed" not in logs[1][0]
    for first, second in logs:
        assert "resumed from" not in first
        assert "resumed from" in second and "iteration 8" in second
    assert sorted(os.listdir(tmp_path / "ckpt")) == [LOOP_STATE]
    blob = torch.load(tmp_path / "ckpt" / LOOP_STATE, weights_only=True)
    assert blob["it"] == 12
    assert (tmp_path / "out8.ply").exists() and (tmp_path / "out12.ply").exists()
    assert "saved" in logs[0][1] and "saved" not in logs[1][1]


def test_dryrun_without_a_card_or_group_refuses_cuda(monkeypatch):
    """`python -m ...parallel.dryrun 2` asks for the cards by default:
    without a group and without two cards it raises before it spawns, and
    names the CPU's flag."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are present")
    for var in TORCHRUN_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(dryrun.mp, "spawn", lambda *a, **k: pytest.fail(
        "spawned ranks for a device it does not have"))
    for call in (lambda: dryrun.main(["2"]),
                 lambda: dryrun.main(["2", "--device", "cuda"]),
                 lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="--device cpu"):
            call()
    assert not dist.is_initialized()


def test_cli_train_restarts_need_a_checkpoint():
    with pytest.raises(SystemExit, match="--checkpoint"):
        cli.main(["train", "--cameras", "cams.json", "--images", "imgs",
                  "--restarts", "1", "--device", "cpu"])


def test_dryrun_multichip_on_two_gloo_ranks():
    """`dryrun_multichip(2, "cpu")` spawns two gloo ranks (data=2 × tile=1): the
    tile-sharded, Gaussian-sharded and banded steps report the mean loss
    of the two views of the JAX dry run's scene, which the JAX package's
    render gives to rel 1e-5."""
    import jax

    from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig
    from gaussian_splatting_web_tpu.core import camera as jax_camera
    from gaussian_splatting_web_tpu.core.types import GaussianCloud as JaxCloud
    from gaussian_splatting_web_tpu.ops.rasterize import render as jax_render
    from gaussian_splatting_web_tpu.train.loss import photometric_loss

    losses = dryrun_multichip(2, "cpu")
    assert set(losses) == {"tile_sharded", "gaussian_sharded",
                           "gaussian_sharded_banded"}
    jcfg = JaxConfig(**dataclasses.asdict(CONFIG))
    jcloud = JaxCloud(**tiny_scene().to_numpy())
    target = np.zeros((HEIGHT, WIDTH, 3), np.float32)
    render_t = jax.jit(jax_render, static_argnums=(2, 3, 4))
    want = np.mean([float(photometric_loss(
        render_t(jcloud, jax_camera.default_camera(
            WIDTH, HEIGHT, eye=(0, i * 0.5, -6), center=(0, 0, 0)),
            WIDTH, HEIGHT, jcfg)[0], target, 0.2)) for i in range(2)])
    for name, loss in losses.items():
        assert loss == pytest.approx(want, rel=1e-5), name

