"""The config leftovers of the port (ROADMAP §1 item 13) against the JAX
package: bf16 scene storage (`GaussianCloud.with_storage_dtype`,
`RenderConfig(dtype=...)`) and the splat highlight
(`RenderConfig(debug_selected=k)`), on the scenes and by the rules of JAX
`tests/test_rasterize.py:155-200`. Images are compared with the repo's
image rule (`assert_images_close`)."""

import dataclasses

import numpy as np
import pytest
import torch

from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as cam
from gaussian_splatting_web_tpu_torch.core.types import GaussianCloud
from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
    PARAMS,
    GaussianModel,
)
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    highlight_selected,
    pack_splat_fields,
    render,
    render_impl,
)
from gaussian_splatting_web_tpu_torch.ops.projection import project_gaussians

# JAX tests/test_rasterize.py's exact-mode configuration
CFG = RenderConfig(max_dup=128, max_per_tile=256, tile_chunk=8)
FIELDS = ("xyz", "log_scale", "quat", "opacity_logit", "sh")


def _orbit(w, h, eye=(0, 0, -6)):
    return cam.default_camera(w, h, eye=eye, center=(0, 0, 0))


def _jax():
    import jax

    from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig
    from gaussian_splatting_web_tpu.core import camera as jax_camera
    from gaussian_splatting_web_tpu.ops.rasterize import render as jax_render

    def jrender(jcloud, w, h, cfg):
        img, aux = jax_render(jcloud, jax_camera.default_camera(
            w, h, eye=(0, 0, -6), center=(0, 0, 0)), w, h,
            JaxConfig(**dataclasses.asdict(cfg)))
        return np.asarray(img), aux

    return jax, jrender


def _port(jcloud) -> GaussianCloud:
    return GaussianCloud.from_numpy(jcloud)


def _rgba(img, aux):
    return torch.cat([img, aux["alpha"][..., None]], -1).numpy()


def test_with_storage_dtype_matches_jax():
    """bf16 storage keeps xyz f32 and rounds the other four fields as the
    JAX package rounds them (both round to nearest even)."""
    from tests.conftest import make_random_cloud

    jcloud = make_random_cloud(64, seed=3, sh_degree=2)
    cloud = _port(jcloud)
    assert cloud.with_storage_dtype("float32") is cloud
    bf = cloud.with_storage_dtype("bfloat16")
    jbf = jcloud.with_storage_dtype("bfloat16")
    assert bf.xyz.dtype == torch.float32 and bf.xyz is cloud.xyz
    for f in FIELDS[1:]:
        assert getattr(bf, f).dtype == torch.bfloat16, f
        np.testing.assert_array_equal(
            getattr(bf, f).to(torch.float32).numpy(),
            np.asarray(getattr(jbf, f)).astype(np.float32), err_msg=f)
    assert bf.with_storage_dtype("bf16").sh is bf.sh   # no-op when stored so
    with pytest.raises(ValueError, match="storage dtype"):
        cloud.with_storage_dtype("float16")


@pytest.mark.parametrize("binning", ["dup", "anchor"])
def test_bfloat16_storage_matches_jax(binning):
    """JAX test_bfloat16_storage_close_to_f32's scene (64 splats, SH 2,
    96x64): the bf16 render agrees with the JAX package's bf16 render by
    the image rule and with the f32 render within that test's bounds (mean
    |diff| < 5e-3, p99 < 0.05); RenderConfig(dtype='bfloat16') on an f32
    cloud gives the pre-converted cloud's image bit for bit."""
    from tests.conftest import assert_images_close, make_random_cloud

    jax, jrender = _jax()
    jcloud = make_random_cloud(64, seed=3, sh_degree=2)
    cloud = _port(jcloud)
    cfg = CFG.replace(binning=binning)
    w, h = 96, 64
    with torch.no_grad():
        img32, _ = render(cloud, _orbit(w, h), w, h, cfg)
        img_bf, aux = render(cloud.with_storage_dtype("bfloat16"),
                             _orbit(w, h), w, h, cfg)
        img_cfg, _ = render(cloud, _orbit(w, h), w, h,
                            cfg.replace(dtype="bfloat16"))
    assert torch.equal(img_cfg, img_bf)
    diff = (img_bf - img32).abs()
    assert float(diff.mean()) < 5e-3
    assert float(torch.quantile(diff.reshape(-1), 0.99)) < 0.05
    want, _ = jrender(jax.device_put(jcloud).with_storage_dtype("bfloat16"),
                      w, h, CFG)
    assert_images_close(img_bf.numpy(), want)


def test_bfloat16_storage_trains_the_f32_parameters():
    """Under RenderConfig(dtype='bfloat16') the gradient flows through the
    storage casts into the model's f32 parameters."""
    from tests.conftest import make_random_cloud

    model = GaussianModel.from_cloud(_port(make_random_cloud(32, seed=1,
                                                             sh_degree=1)))
    img, aux = render_impl(model.to_cloud(), _orbit(64, 48), 64, 48,
                           CFG.replace(dtype="bfloat16"))
    (img.sum() + aux["alpha"].sum()).backward()
    for f in PARAMS:
        g = getattr(model, f).grad
        assert g is not None and g.dtype == torch.float32, f
        assert bool(torch.isfinite(g).all()), f
    assert bool(model.opacity_logit.grad.abs().gt(0).any())


@pytest.mark.parametrize("selected", [3, 0, 11, 12])
def test_debug_selected_matches_jax(selected):
    """JAX test_debug_selected_splat_highlight's scene (12 splats, 64x64):
    with debug_selected=k the image agrees with the JAX package's by the
    image rule; the highlight leans magenta where it changes pixels and
    leaves the rest; binning keeps the real opacity's footprint (the same
    pairs as without it). k = 12 (≥ N) selects nothing, as in JAX."""
    from tests.conftest import assert_images_close, make_random_cloud

    _, jrender = _jax()
    jcloud = make_random_cloud(12, seed=6, sh_degree=0)
    cloud = _port(jcloud)
    w = h = 64
    cfg = CFG.replace(debug_selected=selected)
    with torch.no_grad():
        img0, aux0 = render(cloud, _orbit(w, h), w, h, CFG)
        imgd, auxd = render(cloud, _orbit(w, h), w, h, cfg)
    want, jaux = jrender(jcloud, w, h, cfg)
    assert_images_close(imgd.numpy(), want)
    assert int(auxd["num_pairs"]) == int(aux0["num_pairs"]) == int(
        jaux["num_pairs"])
    changed = (imgd - img0).abs().amax(-1) > 1e-3
    if selected >= 12:
        assert not changed.any()
        return
    if changed.any():
        ch = imgd[changed]
        assert float((ch[:, 0] + ch[:, 2] - 2 * ch[:, 1]).mean()) > 0.1
    assert not changed.all()


def test_debug_selected_anchor_binning_agrees_with_dup():
    """The port highlights on the anchor binning too (JAX renders the dup
    binning under debug_selected); the two images agree by the image
    rule."""
    from tests.conftest import assert_images_close, make_random_cloud

    cloud = _port(make_random_cloud(12, seed=6, sh_degree=0))
    cfg = CFG.replace(debug_selected=3)
    with torch.no_grad():
        dup, aux_d = render(cloud, _orbit(64, 64), 64, 64, cfg)
        anc, aux_a = render(cloud, _orbit(64, 64), 64, 64,
                            cfg.replace(binning="anchor"))
        plain, _ = render(cloud, _orbit(64, 64), 64, 64, CFG)
    assert not torch.equal(dup, plain)
    assert_images_close(_rgba(anc, aux_a), _rgba(dup, aux_d))


def test_highlight_selected_rows():
    """The packed row of gaussian k takes rgb (1, 0, 1) and opacity
    max(op, 0.9); every other row and column is unchanged."""
    from tests.conftest import make_random_cloud

    cloud = _port(make_random_cloud(12, seed=6, sh_degree=0))
    fields = pack_splat_fields(project_gaussians(cloud, _orbit(64, 64), 64,
                                                 64, CFG))
    assert highlight_selected(fields, CFG) is fields
    lit = highlight_selected(fields, CFG.replace(debug_selected=5))
    assert lit.shape == fields.shape and lit.is_contiguous()
    rows = torch.arange(12) != 5
    assert torch.equal(lit[rows], fields[rows])
    assert lit[5, 5:8].tolist() == [1.0, 0.0, 1.0]
    assert float(lit[5, 8]) == max(float(fields[5, 8]),
                                   float(np.float32(0.9)))
    assert torch.equal(lit[5, :5], fields[5, :5])
