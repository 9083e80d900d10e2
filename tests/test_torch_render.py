"""The whole forward slice of the port vs the JAX package: render +
post-process, the viewer's frames over one event sequence, PLY IO, the
benchmark scene, and the CLI on the CPU."""

import dataclasses
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from gaussian_splatting_web_tpu import bench_lib as jax_bench
from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig
from gaussian_splatting_web_tpu.core import camera as jax_camera
from gaussian_splatting_web_tpu.core.types import numpy_cloud
from gaussian_splatting_web_tpu.io.ply import read_ply as jax_read_ply
from gaussian_splatting_web_tpu.ops.composite import (
    post_process as jax_post_process,
)
from gaussian_splatting_web_tpu.ops.composite import to_uint8 as jax_to_uint8
from gaussian_splatting_web_tpu.ops.rasterize import render_impl as jax_render
from gaussian_splatting_web_tpu.viewer.server import ViewerApp as JaxViewerApp
from gaussian_splatting_web_tpu_torch import bench_lib
from gaussian_splatting_web_tpu_torch.cli import main as cli_main
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as port_camera
from gaussian_splatting_web_tpu_torch.core.types import GaussianCloud
from gaussian_splatting_web_tpu_torch.io.ply import read_ply, write_ply
from gaussian_splatting_web_tpu_torch.ops.composite import (
    post_process,
    to_uint8,
)
from gaussian_splatting_web_tpu_torch.ops.rasterize import render
from gaussian_splatting_web_tpu_torch.viewer.server import ViewerApp, serve
from tests.conftest import assert_images_close, make_random_cloud

torch.set_num_threads(2)

CFG = RenderConfig(max_dup=16, max_per_tile=256)
JCFG = JaxConfig(**dataclasses.asdict(CFG))
EVENTS = [{"kind": "init"}, {"kind": "rotate", "dx": 0.3, "dy": 0.1},
          {"kind": "zoom", "d": -400}, {"kind": "pan", "dx": 0.05, "dy": 0.02},
          {"kind": "release"}, {"kind": "tick"}]


def _cloud(n=150, seed=2, sh_degree=3):
    return numpy_cloud(make_random_cloud(n, seed=seed, sh_degree=sh_degree))


@pytest.mark.parametrize("size", [(64, 48), (72, 40)])
def test_render_and_post_process_match_jax(size):
    w, h = size
    cloud = _cloud()
    kw = dict(eye=(0.3, -0.2, -6.0), center=(0.0, 0.0, 0.0))
    img0, aux0 = jax_render(cloud, jax_camera.default_camera(w, h, **kw),
                            w, h, JCFG)
    rgba0 = np.asarray(jax_post_process(img0, aux0["alpha"], JCFG))

    img, aux = render(GaussianCloud.from_numpy(cloud),
                      port_camera.default_camera(w, h, **kw), w, h, CFG)
    rgba = post_process(img, aux["alpha"], CFG)
    assert int(aux["num_pairs"]) == int(aux0["num_pairs"])
    assert int(aux["overflow"]) == int(aux0["overflow"])
    assert int(aux["num_visible"]) == int(aux0["num_visible"])
    assert_images_close(img.numpy(), np.asarray(img0))
    assert_images_close(rgba.numpy(), rgba0)
    lsb = np.abs(to_uint8(rgba).numpy().astype(int)
                 - np.asarray(jax_to_uint8(rgba0)).astype(int))
    assert lsb.max() <= 1
    assert rgba[..., 3].max() > 0.5


def test_viewer_frames_match_jax_viewer():
    cloud = _cloud(n=120, seed=4, sh_degree=1)
    ref = JaxViewerApp(cloud, 64, 48, JCFG)
    app = ViewerApp(GaussianCloud.from_numpy(cloud), 64, 48, CFG,
                    device="cpu")
    for ev in EVENTS:
        f0, dirty0 = ref.handle_event(dict(ev))
        f1, dirty1 = app.handle_event(dict(ev))
        assert f1.shape == f0.shape == (48, 64, 4)
        assert dirty1 == dirty0
        assert_images_close(f1, f0)
        assert np.abs(to_uint8(torch.from_numpy(f1)).numpy().astype(int)
                      - np.asarray(jax_to_uint8(f0)).astype(int)).max() <= 1
    assert app.info() == ref.info()


def test_viewer_http_roundtrip():
    cloud = GaussianCloud.from_numpy(_cloud(n=20, seed=0, sh_degree=0))
    httpd, app = serve(cloud, host="127.0.0.1", port=0, width=32, height=32,
                       config=CFG, block=False, device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(base + "/info") as r:
            assert json.loads(r.read())["num_gaussians"] == 20
        req = urllib.request.Request(
            base + "/event", method="POST",
            data=json.dumps({"kind": "rotate", "dx": 0.3, "dy": 0.1}).encode())
        with urllib.request.urlopen(req) as r:
            png = r.read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and png[25] == 6   # RGBA
    finally:
        httpd.shutdown()
        t.join(timeout=10)
    assert not t.is_alive()


def test_ply_roundtrip_against_jax_reader(tmp_path):
    src = _cloud(n=33, seed=6, sh_degree=2)
    path = tmp_path / "scene.ply"
    write_ply(GaussianCloud.from_numpy(src), str(path))
    ref = jax_read_ply(str(path), use_native=False)
    got = read_ply(str(path))
    for f in ("xyz", "log_scale", "quat", "opacity_logit", "sh"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.quat.numpy(), src.quat, atol=1e-6)
    np.testing.assert_array_equal(got.sh.numpy(), src.sh)


def test_make_scene_matches_jax():
    ref = jax_bench.make_scene(500, seed=3)
    got = bench_lib.make_scene(500, seed=3)
    for f in ("xyz", "log_scale", "quat", "opacity_logit", "sh"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_cli_render_cpu_writes_png(tmp_path, capsys):
    ply = tmp_path / "scene.ply"
    write_ply(GaussianCloud.from_numpy(_cloud(n=40, seed=7, sh_degree=1)),
              str(ply))
    out = tmp_path / "renders"
    cli_main(["render", "--ply", str(ply), "--out", str(out), "--device", "cpu",
              "--width", "48", "--height", "32", "--max-per-tile", "256"])
    png = next(out.glob("*.png")).read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(png[16:20], "big") == 48       # IHDR width
    assert int.from_bytes(png[20:24], "big") == 32       # IHDR height
    assert png[25] == 6                                  # RGBA
    cli_main(["info", "--ply", str(ply)])
    assert json.loads(capsys.readouterr().out)["num_gaussians"] == 40


def test_cli_cuda_without_gpu_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ply = tmp_path / "scene.ply"
    write_ply(GaussianCloud.from_numpy(_cloud(n=5, seed=1, sh_degree=0)),
              str(ply))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["render", "--ply", str(ply), "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
