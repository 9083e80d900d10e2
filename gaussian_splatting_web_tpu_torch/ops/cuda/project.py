"""Wrapper of the projection layer's CUDA kernels for Hopper,
`csrc/project.cu`:

  * kernel P fwd (`project_fwd`), one thread per Gaussian: the whole of
    `ops/projection.py::project_gaussians_plain` (covariance, EWA, conic,
    SH colour, opacity, radius, visibility) in registers;
  * kernel P bwd (`project_bwd`), its hand-derived backward, which
    recomputes the forward's intermediates from the saved inputs (plain
    twin: `ops/projection.py::project_backward_plain`).

Neither replaces a TPU kernel: the JAX package's projection is XLA.
`ProjectFn` is the differentiable projection that `project_gaussians`
calls: a CUDA tensor runs P fwd and P bwd, a CPU tensor the plain twins
through the same Function; any other device raises. It saves only the
inputs and the packed camera (`ops/projection.py::pack_camera`, built with
device ops, so no camera value is read on the host); the camera gets no
gradient. `launches` and `launches_bwd` count kernel launches and are
changed nowhere else. `prepare_fwd` and `prepare_bwd` do a launch's checks
and allocations and return a callable that only launches, so a kernel can
be timed alone.
"""

from __future__ import annotations

import torch

from ...config import RenderConfig
from ...core.types import GaussianCloud
from ..projection import (
    CAMERA_FLOATS,
    ProjectedSplats,
    pack_camera,
    project_backward_plain,
    project_gaussians_plain,
)
from .raster import _check, _kernel_fn

launches = 0        # kernel P fwd
launches_bwd = 0    # kernel P bwd

SH_COEFFS = (1, 4, 9, 16)
INPUTS = ("xyz", "log_scale", "quat", "opacity_logit", "sh")


def _inputs(xyz, log_scale, quat, opacity_logit, sh):
    """The kernels' inputs, contiguous, the SH rows 16-byte aligned, after
    the checks of device, dtype and shape (host-side only: no sync)."""
    dev = xyz.device
    n = xyz.shape[0]
    ins = [t.contiguous() for t in (xyz, log_scale, quat, opacity_logit, sh)]
    for t, name, shape in zip(ins, INPUTS,
                              ((n, 3), (n, 3), (n, 4), (n,), None)):
        _check(t, name, torch.float32, dev, len(shape) if shape else 3)
        if shape and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    sh = ins[4]
    if sh.shape[0] != n or sh.shape[1] not in SH_COEFFS or sh.shape[2] != 3:
        raise ValueError(f"sh has shape {tuple(sh.shape)}, expected "
                         f"[{n}, K, 3] with K in {SH_COEFFS}")
    if sh.data_ptr() % 16:
        ins[4] = sh.clone()
    return ins


def _check_camera(cam, dev):
    _check(cam, "cam", torch.float32, dev, 1)
    if cam.shape[0] != CAMERA_FLOATS:
        raise ValueError(f"cam has shape {tuple(cam.shape)}, expected "
                         f"({CAMERA_FLOATS},)")


def prepare_fwd(ins, cam, width, height, config: RenderConfig):
    """P fwd's checks and outputs for the `_inputs` list `ins` and the
    packed camera → (run, ProjectedSplats): each run() launches P fwd once
    into the outputs."""
    xyz, sh = ins[0], ins[4]
    dev = xyz.device
    _check_camera(cam, dev)
    n = xyz.shape[0]

    def empty(*shape, dtype=torch.float32):
        return torch.empty((n, *shape), dtype=dtype, device=dev)

    out = ProjectedSplats(mean2d=empty(2), conic=empty(3), depth=empty(),
                          radius=empty(), rgb=empty(3), opacity=empty(),
                          valid=empty(dtype=torch.bool))
    outs = (out.mean2d, out.conic, out.depth, out.radius, out.rgb,
            out.opacity, out.valid)
    fn, err_str = _kernel_fn("project", 6, 4, 5, 7, entry="project_fwd")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        global launches
        err = fn(*(t.data_ptr() for t in (*ins, cam)), n, sh.shape[1], width,
                 height, config.fov_clamp, config.lowpass,
                 config.alpha_cutoff, config.radius_sigma,
                 config.max_radius_px, *(t.data_ptr() for t in outs),
                 dev.index, stream)
        if err != 0:
            raise RuntimeError(f"project_fwd launch failed: cuda error {err} "
                               f"({err_str(err).decode()})")
        launches += 1

    return run, out


def prepare_bwd(ins, cam, grads, width, height, config: RenderConfig):
    """P bwd's checks and outputs for the `_inputs` list `ins`, the packed
    camera and the outputs' gradients `grads` (d_mean2d, d_conic, d_depth,
    d_rgb, d_opacity; None where none arrives) → (run, [d_xyz,
    d_log_scale, d_quat, d_opacity_logit, d_sh]): each run() launches P bwd
    once into them."""
    xyz, sh = ins[0], ins[4]
    dev = xyz.device
    _check_camera(cam, dev)
    n = xyz.shape[0]
    shapes = ((n, 2), (n, 3), (n,), (n, 3), (n,))
    names = ("d_mean2d", "d_conic", "d_depth", "d_rgb", "d_opacity")
    gs = []
    for g, name, shape in zip(grads, names, shapes):
        if g is not None:
            g = g.contiguous()
            _check(g, name, torch.float32, dev, len(shape))
            if tuple(g.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(g.shape)}, "
                                 f"expected {shape}")
        gs.append(g)
    d_ins = [torch.empty_like(t) for t in ins]
    fn, err_str = _kernel_fn("project", 11, 4, 2, 5, entry="project_bwd")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        global launches_bwd
        err = fn(*(t.data_ptr() for t in (*ins, cam)),
                 *(None if g is None else g.data_ptr() for g in gs),
                 n, sh.shape[1], width, height, config.fov_clamp,
                 config.lowpass, *(t.data_ptr() for t in d_ins), dev.index,
                 stream)
        if err != 0:
            raise RuntimeError(f"project_bwd launch failed: cuda error {err} "
                               f"({err_str(err).decode()})")
        launches_bwd += 1

    return run, d_ins


def _device_of(xyz: torch.Tensor) -> str:
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no projection for device {xyz.device}")
    return xyz.device.type


class ProjectFn(torch.autograd.Function):
    """(xyz, log_scale, quat, opacity_logit, sh, camera, width, height,
    config) → (mean2d, conic, depth, radius, rgb, opacity, valid), the
    fields of ProjectedSplats; radius and valid carry no gradient, nor
    does the camera (a CameraParams)."""

    @staticmethod
    def forward(ctx, xyz, log_scale, quat, opacity_logit, sh, camera, width,
                height, config):
        cam = pack_camera(camera, xyz.dtype)
        if _device_of(xyz) == "cpu":
            ins = (xyz, log_scale, quat, opacity_logit, sh)
            out = project_gaussians_plain(GaussianCloud(*ins), camera, width,
                                          height, config)
        else:
            ins = _inputs(xyz, log_scale, quat, opacity_logit, sh)
            run, out = prepare_fwd(ins, cam, width, height, config)
            run()
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(out.radius, out.valid)
        ctx.save_for_backward(*ins, cam)
        ctx.frame = (width, height, config)
        return (out.mean2d, out.conic, out.depth, out.radius, out.rgb,
                out.opacity, out.valid)

    @staticmethod
    def backward(ctx, d_mean2d, d_conic, d_depth, _d_radius, d_rgb,
                 d_opacity, _d_valid):
        *ins, cam = ctx.saved_tensors
        width, height, config = ctx.frame
        grads = (d_mean2d, d_conic, d_depth, d_rgb, d_opacity)
        if _device_of(cam) == "cpu":
            d_ins = project_backward_plain(*ins, cam, width, height, config,
                                           *grads)
        else:
            run, d_ins = prepare_bwd(ins, cam, grads, width, height, config)
            run()
        return (*d_ins, None, None, None, None)
