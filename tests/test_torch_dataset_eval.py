"""The rest of the port's single-card user path against the JAX package:
JPEG and resized input (`io/dataset.py`), `cli eval`, and the final
TrainState (`train/checkpoint.py::save_train_state`, written by `cli
train --checkpoint` into `<checkpoint>-final`).
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from gaussian_splatting_web_tpu_torch.cli import main as cli_main
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as cam
from gaussian_splatting_web_tpu_torch.core.types import GaussianCloud
from gaussian_splatting_web_tpu_torch.io.dataset import load_dataset
from gaussian_splatting_web_tpu_torch.io.ply import write_ply
from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
    PARAMS,
    GaussianModel,
)
from gaussian_splatting_web_tpu_torch.ops.rasterize import render
from gaussian_splatting_web_tpu_torch.train.checkpoint import (
    TRAIN_STATE,
    restore_train_state,
    save_train_state,
)
from gaussian_splatting_web_tpu_torch.train.trainer import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from gaussian_splatting_web_tpu_torch.utils.image import write_png
from tests.conftest import make_random_cloud

CFG = RenderConfig(max_dup=16, max_per_tile=64)
CAPTURE = (40, 30)     # the capture's size
W, H = 32, 24          # the training size: every image is resized


def _cloud(seed, n=16):
    return GaussianCloud.from_numpy(make_random_cloud(n, seed=seed))


def _camera(i, w, h):
    a = i * 0.7
    return cam.default_camera(w, h, eye=(3 * math.sin(a), 0.3,
                                         -3 * math.cos(a)), center=(0, 0, 0))


def _write_capture(tmp_path):
    """A capture at 40x30 rendered by the port: view0 a JPEG, view1 a PNG,
    view2 a JPEG named .JPG, with cameras.json as INRIA writes it."""
    from PIL import Image

    imgdir = tmp_path / "images"
    imgdir.mkdir()
    w, h = CAPTURE
    entries = []
    cloud = _cloud(4)
    for i, name in enumerate(("view0.jpg", "view1.png", "view2.JPG")):
        camera = _camera(i, w, h)
        with torch.no_grad():
            img, _ = render(cloud, camera, w, h, CFG)
        u8 = np.clip(np.round(img.numpy() * 255), 0, 255).astype(np.uint8)
        if name.endswith(".png"):
            write_png(u8, str(imgdir / name))
        else:
            Image.fromarray(u8).save(str(imgdir / name), quality=90)
        entries.append({
            "id": i, "img_name": os.path.splitext(name)[0], "width": w,
            "height": h, "position": camera.cam_pos.numpy().tolist(),
            "rotation": camera.view.numpy()[:3, :3].T.tolist(),
            "fx": float(camera.focal[0]), "fy": float(camera.focal[1])})
    camfile = tmp_path / "cameras.json"
    camfile.write_text(json.dumps(entries))
    return str(camfile), str(imgdir)


def test_jpeg_and_resized_png_match_jax(tmp_path):
    """Both packages decode a JPEG and resize a PNG through the same PIL
    calls: the targets agree bit for bit, at the capture size too."""
    from gaussian_splatting_web_tpu.io.dataset import (
        load_dataset as jax_load_dataset,
    )

    camfile, imgdir = _write_capture(tmp_path)
    for w, h in ((W, H), CAPTURE):
        got = load_dataset(camfile, imgdir, w, h)
        ref = jax_load_dataset(camfile, imgdir, w, h)
        assert [v.name for v in got] == [v.name for v in ref]
        assert len(got) == 3
        for g, r in zip(got, ref):
            assert g.image.shape == (h, w, 3) and g.image.dtype == np.float32
            np.testing.assert_array_equal(g.image, r.image)
            np.testing.assert_array_equal(g.camera.view.numpy(),
                                          np.asarray(r.camera.view))


def test_cli_eval_matches_jax(tmp_path, capsys, monkeypatch):
    """`cli eval` of the port against the JAX package's `cmd_eval` on the
    same PLY and capture: PSNR within 1e-3 dB, SSIM within 1e-5. The JAX
    CLI's config is set to the port's exact mode (its own default packs
    the sort payloads in bf16, which the port does not implement)."""
    import gaussian_splatting_web_tpu.cli as jax_cli
    from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig

    camfile, imgdir = _write_capture(tmp_path)
    ply = str(tmp_path / "scene.ply")
    write_ply(_cloud(5, n=24), ply)
    args = ["eval", "--ply", ply, "--cameras", camfile, "--images", imgdir,
            "--width", str(W), "--height", str(H), "--max-dup", "16",
            "--max-per-tile", "64"]
    cli_main(args + ["--device", "cpu"])
    out = capsys.readouterr()
    got = json.loads(out.out.strip().splitlines()[-1])
    assert out.err.count("PSNR") == 3

    monkeypatch.setattr(jax_cli, "_config",
                        lambda _: JaxConfig(**dataclasses.asdict(CFG)))
    jax_cli.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["views"] == want["views"] == 3
    assert math.isfinite(got["psnr_mean"])
    assert got["psnr_mean"] == pytest.approx(want["psnr_mean"], abs=1e-3)
    assert got["ssim_mean"] == pytest.approx(want["ssim_mean"], abs=1e-5)


def test_train_state_roundtrip_and_resume(tmp_path):
    """save_train_state / restore_train_state bring back the parameters,
    Adam's moments, the step and the learning rates bit for bit, and one
    step after a restore equals the same step without it."""
    camera = _camera(0, W, H)
    with torch.no_grad():
        target, _ = render(_cloud(4), camera, W, H, CFG)
    model = GaussianModel.from_cloud(_cloud(6))
    state = TrainState(model, make_optimizer(model, scene_extent=2.0))
    step = make_train_step(W, H, CFG)
    state, _ = step(state, camera, target)
    save_train_state(state, str(tmp_path / "ckpt"))
    assert os.listdir(tmp_path / "ckpt") == [TRAIN_STATE]

    other = GaussianModel.from_cloud(_cloud(7))
    got = restore_train_state(str(tmp_path / "ckpt"),
                              TrainState(other, make_optimizer(other)))
    assert got.step == state.step == 1
    for f in PARAMS:
        assert torch.equal(getattr(got.model, f), getattr(state.model, f))
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got.optimizer.state[getattr(got.model, f)][k],
                               state.optimizer.state[getattr(state.model,
                                                             f)][k])
    assert [g["lr"] for g in got.optimizer.param_groups] == \
        [g["lr"] for g in state.optimizer.param_groups]

    state, loss_a = step(state, camera, target)
    got, loss_b = step(got, camera, target)
    assert torch.equal(loss_a, loss_b) and got.step == state.step == 2
    for f in PARAMS:
        assert torch.equal(getattr(got.model, f), getattr(state.model, f))


def test_cli_train_writes_final_train_state(tmp_path):
    """`cli train --checkpoint DIR` on the JPEG capture leaves the loop
    state in DIR and the final TrainState in DIR-final."""
    camfile, imgdir = _write_capture(tmp_path)
    init = tmp_path / "init.ply"
    write_ply(_cloud(5), str(init))
    ckpt = tmp_path / "ckpt"
    cli_main(["train", "--ply", str(init), "--cameras", camfile, "--images",
              imgdir, "--out", str(tmp_path / "trained.ply"), "--width",
              str(W), "--height", str(H), "--max-dup", "16",
              "--max-per-tile", "64", "--device", "cpu", "--iterations", "3",
              "--checkpoint", str(ckpt), "--checkpoint-every", "3"])
    assert (tmp_path / "trained.ply").exists()
    final = tmp_path / "ckpt-final" / TRAIN_STATE
    blob = torch.load(final, weights_only=True)
    assert blob["step"] == 3
    assert set(blob["model"]) == set(PARAMS)
    assert torch.isfinite(blob["model"]["xyz"]).all()
