"""The last library leftovers of the port against the JAX package: the
native PLY unpack (`native/plyio.py`, csrc/plyio.cpp) and the helpers of
`core/types.py`, `core/camera.py`, `ops/sort.py` and `utils/image.py`.

Tolerances: indices and PLY columns exact (bit for bit); floats to atol
1e-6. The JAX package's own native unpack scales uchar by x * (1/255),
which differs from its NumPy path's x / 255 by one ulp on 126 of the 256
values; the port's copy divides, so its two paths and the JAX NumPy path
agree bit for bit and the JAX native path agrees to one ulp on the
columns read from uchar properties.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussian_splatting_web_tpu.core import camera as jax_camera
from gaussian_splatting_web_tpu.core import types as jax_types
from gaussian_splatting_web_tpu.io.ply import read_ply as jax_read_ply
from gaussian_splatting_web_tpu.ops.sort import (
    depth_sort_indices as jax_depth_sort,
)
from gaussian_splatting_web_tpu.utils.image import (
    read_image as jax_read_image,
)
from gaussian_splatting_web_tpu_torch.core import camera as port_camera
from gaussian_splatting_web_tpu_torch.core import types as port_types
from gaussian_splatting_web_tpu_torch.io.ply import read_ply
from gaussian_splatting_web_tpu_torch import _native_build
from gaussian_splatting_web_tpu_torch.ops.sort import depth_sort_indices
from gaussian_splatting_web_tpu_torch.utils.image import read_image, write_png
from tests.conftest import make_random_cloud

torch.set_num_threads(2)

FIELDS = ("xyz", "log_scale", "quat", "opacity_logit", "sh")
# a PLY with float, double and uchar properties (and an unread float)
PROPS = ([("x", "double"), ("y", "double"), ("z", "double"),
          ("nx", "float"), ("f_dc_0", "uchar"), ("f_dc_1", "float"),
          ("f_dc_2", "uchar")]
         + [(f"f_rest_{i}", "float") for i in range(9)]
         + [("opacity", "uchar")]
         + [(f"scale_{i}", "float") for i in range(3)]
         + [(f"rot_{i}", "double") for i in range(4)])
NP_TYPES = {"float": "<f4", "double": "<f8", "uchar": "u1"}


def _ply_bytes(n=6000, seed=0):
    """n records of PROPS (more than the unpack's 4096-record threading
    threshold), with a NaN quaternion row."""
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, np.dtype([(a, NP_TYPES[b]) for a, b in PROPS]))
    for name, ptype in PROPS:
        rec[name] = (rng.integers(0, 256, n) if ptype == "uchar"
                     else rng.normal(size=n))
    rec["rot_0"][7] = np.nan
    header = (["ply", "format binary_little_endian 1.0",
               f"element vertex {n}"]
              + [f"property {b} {a}" for a, b in PROPS] + ["end_header", ""])
    return "\n".join(header).encode("ascii") + rec.tobytes()


def test_native_ply_read_matches_numpy_and_jax():
    blob = _ply_bytes()
    native = read_ply(blob, device="cpu", use_native=True)
    plain = read_ply(blob, device="cpu", use_native=False)
    jax_plain = jax_read_ply(blob, use_native=False)
    jax_native = jax_read_ply(blob, use_native=True)
    for f in FIELDS:
        got = getattr(native, f).numpy()
        np.testing.assert_array_equal(got, getattr(plain, f).numpy())
        np.testing.assert_array_equal(got, np.asarray(getattr(jax_plain, f)))
        want = np.asarray(getattr(jax_native, f))
        if f in ("opacity_logit", "sh"):     # read from uchar properties
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want)
    assert not np.isnan(native.quat.numpy()).any()


def test_native_ply_read_fallback_rule(monkeypatch):
    """use_native=True raises when the unpack cannot build; None falls
    back to NumPy with the same bits; False never builds."""
    blob = _ply_bytes(n=50)

    def broken(name):
        raise RuntimeError(f"failed to build {name}.cpp")

    monkeypatch.setattr(_native_build, "load_host", broken)
    with pytest.raises(RuntimeError, match="plyio"):
        read_ply(blob, device="cpu", use_native=True)
    auto = read_ply(blob, device="cpu")
    plain = read_ply(blob, device="cpu", use_native=False)
    for f in FIELDS:
        assert torch.equal(getattr(auto, f), getattr(plain, f))


def _clouds(n=300, seed=3):
    ref = jax_types.numpy_cloud(make_random_cloud(n, seed=seed, sh_degree=1,
                                                  spread=2.0))
    port = port_types.GaussianCloud.from_numpy(ref)
    return ref, port


def _assert_cloud_equal(port, ref):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)))


def test_morton_order_spatial_sort_reindex_match_jax():
    ref, port = _clouds()
    xyz = ref.xyz.copy()
    xyz[::7] = xyz[3]                        # tied codes keep input order
    np.testing.assert_array_equal(port_types.morton_order(xyz),
                                  jax_types.morton_order(xyz))
    _assert_cloud_equal(port.spatial_sort(), ref.spatial_sort())
    perm = np.random.default_rng(1).permutation(ref.num_gaussians)
    _assert_cloud_equal(port.reindex(perm), ref.reindex(perm))
    _assert_cloud_equal(port.reindex(torch.from_numpy(perm)),
                        ref.reindex(perm))


def test_astype_and_numpy_cloud_match_jax():
    ref, port = _clouds()
    half = port.astype(torch.float16)
    want = ref.astype(jnp.float16)
    for f in FIELDS:
        assert getattr(half, f).dtype == torch.float16     # xyz too
        np.testing.assert_array_equal(getattr(half, f).numpy(),
                                      np.asarray(getattr(want, f)))
    got = port_types.numpy_cloud(port)
    want = jax_types.numpy_cloud(ref)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], getattr(want, f))


def test_view_proj_and_stack_cameras_match_jax():
    eyes = [(0.0, 0.0, -6.0), (1.0, 0.5, -4.0), (-2.0, 1.0, 5.0)]
    ref = [jax_camera.default_camera(64, 48, eye=e) for e in eyes]
    port = [port_camera.default_camera(64, 48, eye=e) for e in eyes]
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.view_proj.numpy(),
                                   np.asarray(r.view_proj), atol=1e-6)
    got = port_types.stack_cameras(port)
    want = jax_types.stack_cameras(ref)
    for f in dataclasses.fields(port_types.CameraParams):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert g.shape == w.shape and g.shape[0] == 3
        np.testing.assert_allclose(g, w, atol=1e-6)


@pytest.mark.parametrize("fov,aspect,znear,zfar,pixels", [
    (1.04719755, 16 / 9, 0.03, 1000.0, 1920),
    (0.5, 1.0, 0.2, 100.0, 37),
])
def test_perspective_wgpu_and_fov2focal_match_jax(fov, aspect, znear, zfar,
                                                  pixels):
    np.testing.assert_allclose(
        port_camera.perspective_wgpu(fov, aspect, znear, zfar),
        jax_camera.perspective_wgpu(fov, aspect, znear, zfar), atol=1e-6)
    assert port_camera.fov2focal(fov, pixels) == pytest.approx(
        jax_camera.fov2focal(fov, pixels), abs=1e-6)


def test_depth_sort_indices_match_jax():
    """Ties and invalid entries included: both argsorts are stable."""
    rng = np.random.default_rng(5)
    depth = rng.integers(0, 40, 500).astype(np.float32) / 4
    valid = rng.random(500) > 0.2
    got = depth_sort_indices(torch.from_numpy(depth), torch.from_numpy(valid))
    want = np.asarray(jax_depth_sort(jnp.asarray(depth), jnp.asarray(valid)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not valid[got.numpy()[valid.sum():]].any()


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_read_image_matches_jax(tmp_path, ext):
    img = np.random.default_rng(2).random((12, 20, 3)).astype(np.float32)
    path = str(tmp_path / f"img.{ext}")
    if ext == "png":
        write_png(img, path)
    else:
        from PIL import Image
        Image.fromarray((img * 255).astype(np.uint8)).save(path)
    got = read_image(path)
    assert got.dtype == np.float32 and got.shape == (12, 20, 3)
    np.testing.assert_allclose(got, jax_read_image(path), atol=1e-6)
