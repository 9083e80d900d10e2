"""The "train" loop: a closed loop of the program's
`make_densify_train_step` steps, the step `train()` takes each iteration,
on the training views in seeded epochs with the seed's target images, at a
fixed SH degree, without densification rounds.

Traffic parameters: `sh_degree`; `warm_steps`, the set-up's steps through
the window's own call and feed on views that all differ; `checked_steps`,
the first of them that the reference follows; and `limits` for
`loss_rel`, `grad_norm_gap` and `change_norm_gap` (`check.train_numbers`).
"""

from __future__ import annotations

import math
import time
from typing import Dict

import torch

from benchmark import check, harness, inputs as inp, trace as tr
from benchmark.reference import full_f32, train as ref_train


class ProgramTrainer:
    """The program's training step with its model and optimizer state, as
    `train()` builds them: the arena equal to N with every row live."""

    def __init__(self, cfg: dict, scene: dict, extent: float, device):
        from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
            GaussianModel,
        )
        from gaussian_splatting_web_tpu_torch.train.densify import (
            pad_to_capacity,
        )
        from gaussian_splatting_web_tpu_torch.train.train_loop import (
            make_densify_train_step,
        )
        from gaussian_splatting_web_tpu_torch.train.trainer import (
            TrainState,
            make_optimizer,
        )

        t = cfg["train"]
        model = GaussianModel(*(scene[k] for k in inp.LEAVES))
        self.params, self.dstate = pad_to_capacity(model, cfg["num_gaussians"])
        del model
        opt = make_optimizer(
            self.params, scene_extent=extent, position_lr=t["position_lr"],
            position_lr_final=t["position_lr_final"],
            position_lr_max_steps=t["position_lr_steps"],
            sh_dc_lr=t["sh_dc_lr"], sh_rest_lr_div=t["sh_rest_lr_div"],
            opacity_lr=t["opacity_lr"], scale_lr=t["scale_lr"],
            quat_lr=t["quat_lr"])
        self.beta1 = t["adam_betas"][0]
        self.state = TrainState(model=self.params, optimizer=opt)
        self.step_fn = make_densify_train_step(
            cfg["width"], cfg["height"], harness.program_render_config(cfg),
            t["lambda_dssim"])

    def step(self, cam, target, sh_degree: int) -> torch.Tensor:
        self.state, self.dstate, loss = self.step_fn(
            self.state, self.dstate, cam, target, sh_degree)
        return loss

    def grad_norms(self) -> Dict[str, float]:
        """The first gradient per leaf as the optimizer got it, from its
        first moment after one step: m_1 = (1 - beta1) g_1."""
        return {k: float(self._moment(k).norm()) / (1.0 - self.beta1)
                for k in inp.LEAVES}

    def _moment(self, leaf: str) -> torch.Tensor:
        """The first moment of `leaf`, zero where the optimizer never got
        a gradient."""
        p = getattr(self.params, leaf)
        st = self.state.optimizer.state.get(p, {})
        return st["exp_avg"] if "exp_avg" in st else torch.zeros_like(p)

    def grad_max(self) -> Dict[str, float]:
        """The largest element of each leaf's first gradient, as
        `grad_norms` reads it."""
        return {k: float(self._moment(k).abs().max()) / (1.0 - self.beta1)
                for k in inp.LEAVES}

    def change_norms(self, scene0: dict) -> Dict[str, float]:
        return {k: float((getattr(self.params, k).detach() - scene0[k])
                         .norm()) for k in inp.LEAVES}


def first_steps(trainer: ProgramTrainer, cams, targets, row, order,
                traffic: dict, cfg: dict, seed: int, device) -> dict:
    """The set-up's steps through the window's own call and feed, on the
    first `warm_steps` views of `order` (all different), and the readings
    of the first `checked_steps`: each loss, the first gradient's norm per
    leaf from the optimizer's state after one step, and the norm of each
    leaf's change from the seed's scene after the last checked step."""
    sh = traffic["sh_degree"]
    checked = traffic["checked_steps"]
    prog = {"loss": []}
    for k in range(traffic["warm_steps"]):
        v = order[k]
        loss = trainer.step(cams[v], targets[row[v]], sh)
        if k < checked:
            prog["loss"].append(float(loss))
        if k == 0:
            prog["grad_norm"] = trainer.grad_norms()
            prog["grad_max"] = trainer.grad_max()
        if k == checked - 1:
            scene0 = inp.make_scene(cfg, seed, device)
            prog["change_norm"] = trainer.change_norms(scene0)
            del scene0
    return prog


def reference_steps(cfg: dict, data: inp.Inputs, targets, row, order,
                    checked: int, seed: int, device, tf32: bool = False):
    """The reference's steps on the program's first `checked` views, from
    the seed's scene made anew."""
    full_f32()
    scene0 = inp.make_scene(cfg, seed, device)
    views = order[:checked]
    return ref_train.run_steps(scene0, [data.cameras[v] for v in views],
                               [targets[row[v]] for v in views], cfg,
                               data.extent, tf32)


def spans(train_loop, rasterize) -> tr.Spans:
    return tr.Spans([(train_loop, "project_gaussians", "projection"),
                     (rasterize, "bin_splats", "binning"),
                     (rasterize, "rasterize_tiles", "composite"),
                     (train_loop, "photometric_loss", "loss", "backward"),
                     (train_loop, "apply_gradients", "adam"),
                     (train_loop, "accumulate_stats", "densify_stats")])


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device,
        setup_clock) -> dict:
    from gaussian_splatting_web_tpu_torch.ops import rasterize
    from gaussian_splatting_web_tpu_torch.train import train_loop

    cfg, traffic = cell.config, cell.traffic
    harness.mark("imports", setup_clock)
    data = inp.make_inputs(cfg, seed, device)
    targets = inp.make_targets(cfg, seed, len(data.train_ids), device)
    row = {v: r for r, v in enumerate(data.train_ids)}
    harness.sync(device)
    harness.mark("inputs", setup_clock)
    trainer = ProgramTrainer(cfg, data.scene, data.extent, device)
    data.scene = None                  # the program holds its own copy
    cams = {i: harness.program_camera(data.cameras[i])
            for i in data.train_ids}
    sh = traffic["sh_degree"]
    checked, warm = traffic["checked_steps"], traffic["warm_steps"]
    order = inp.request_order(data.train_ids, warm + 100_000, seed,
                              shuffle=True)

    harness.sync(device)
    harness.mark("program", setup_clock)
    prog = first_steps(trainer, cams, targets, row, order, traffic, cfg,
                       seed, device)
    harness.sync(device)
    setup_s = setup_clock()
    harness.mark("warm-up", setup_clock)

    losses = []
    wrapped = spans(train_loop, rasterize) if traced else None
    prof = harness.profiler(device) if traced else None
    with harness.maybe(prof, "trace stop"), harness.maybe(wrapped), \
            harness.window_range(traced):
        t0 = time.perf_counter()
        n = 0
        while True:
            v = order[warm + n]
            losses.append(trainer.step(cams[v], targets[row[v]], sh))
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        harness.sync(device)
        window_s = time.perf_counter() - t0
    peak = harness.memory_peak(device)
    failed = sum(not math.isfinite(float(x)) for x in losses)
    del trainer, losses
    harness.release(device)

    ref = reference_steps(cfg, data, targets, row, order, checked, seed,
                          device)
    numbers = check.train_numbers(prog, ref)
    metrics = {"train_step_ms": window_s / n * 1e3,
               "train_peak_gib": peak / 2 ** 30, "setup_s": setup_s}
    ctx = harness.Context(
        loop="train", config=cfg, requests=n, window_s=window_s,
        summary=harness.reduce_trace(prof) if traced else None,
        counts=ref["counts"])
    return harness.result(cell, numbers, metrics, ctx, n, failed, peak,
                          device, traced)


def half_batch(loss_fn):
    """A loss over the top half of the image: half the batch left out."""
    def half(img, target, *args, **kwargs):
        h = img.shape[0] // 2
        return loss_fn(img[:h], target[:h], *args, **kwargs)
    return half


def readings(cell: harness.Cell, seed: int, device) -> dict:
    """The check's numbers for one seed (`tools/control.py`): "program",
    the program's first steps as a run checks them; "control", the
    reference computed in TF32 put in the program's place; "half_batch",
    the program with its loss taken over the top half of each image only;
    and each side's readings per leaf under "leaves"."""
    from gaussian_splatting_web_tpu_torch.train import train_loop

    cfg, traffic = cell.config, cell.traffic
    data = inp.make_inputs(cfg, seed, device)
    targets = inp.make_targets(cfg, seed, len(data.train_ids), device)
    row = {v: r for r, v in enumerate(data.train_ids)}
    cams = {i: harness.program_camera(data.cameras[i])
            for i in data.train_ids}
    order = inp.request_order(data.train_ids, traffic["warm_steps"], seed,
                              shuffle=True)
    checked = traffic["checked_steps"]
    steps = dict(traffic, warm_steps=checked)

    def program():
        trainer = ProgramTrainer(cfg, data.scene, data.extent, device)
        out = first_steps(trainer, cams, targets, row, order, steps, cfg,
                          seed, device)
        del trainer
        harness.release(device)
        return out

    prog = program()
    orig = train_loop.photometric_loss
    train_loop.photometric_loss = half_batch(orig)
    try:
        half = program()
    finally:
        train_loop.photometric_loss = orig
    ref = reference_steps(cfg, data, targets, row, order, checked, seed,
                          device)
    ref.pop("counts")
    harness.release(device)
    low = reference_steps(cfg, data, targets, row, order, checked, seed,
                          device, tf32=True)
    low.pop("counts")
    return {"program": check.train_numbers(prog, ref),
            "control": check.train_numbers(low, ref),
            "half_batch": check.train_numbers(half, ref),
            "leaves": {"program": prog, "reference": ref, "control": low}}
