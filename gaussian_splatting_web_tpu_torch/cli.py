"""Command-line interface of the port (the JAX package's `cli.py`):

  python -m gaussian_splatting_web_tpu_torch.cli info   --ply scene.ply
  python -m gaussian_splatting_web_tpu_torch.cli render --ply scene.ply [--cameras cam.json] --out out/ [--device cuda] [--gaussian-sharded[=ring|banded]]
  python -m gaussian_splatting_web_tpu_torch.cli serve  --ply scene.ply --port 8090 [--device cuda]
  python -m gaussian_splatting_web_tpu_torch.cli train  --cameras cameras.json --images images/ [--ply init.ply] --out trained.ply [--checkpoint dir [--restarts N]] [--multihost [--gaussian-sharded[=banded]]] [--device cuda]
  python -m gaussian_splatting_web_tpu_torch.cli eval   --ply trained.ply --cameras cameras.json --images images/ [--device cuda]
  python -m gaussian_splatting_web_tpu_torch.cli bench  [--ply scene.ply] [--width 1280 --height 720] [--device cuda] [--depth-bits 19 ...]

`eval` prints PSNR and SSIM per view on stderr and one JSON line
{"views", "psnr_mean", "ssim_mean"} on stdout. `bench` (`bench_lib.run`,
on the 1M-splat synthetic scene without `--ply`) prints its details on
stderr and one JSON line {"metric", "value", "unit", "vs_baseline",
"parity_gate_ok"} on stdout; it measures the config the shared render
flags give, and exits 1 when the gradient-parity gate is red.

`--device` defaults to `cuda`; a CUDA device that is not there is an
error, never a silent switch to the CPU. `render --gaussian-sharded` and
`train --multihost` join the process group `torchrun` describes
(`parallel/multihost.py`: NCCL on the cards, gloo with `--device cpu`);
without one, `render --gaussian-sharded` runs on a 1 × 1 mesh.
`train --multihost --gaussian-sharded` shards the model, its Adam moments
and densification statistics over every rank of that group (`train`'s
Gaussian-sharded arena, the banded a2a exchange); rank 0
gathers the shards and writes the PLY. Densification rounds, opacity
resets and `--checkpoint` are refused on that path (NotImplementedError),
so keep `--iterations` below the first round (500). Each rank composites a
band of tile rows: give every rank at least one (16 pixel rows). A run
whose exchange cut rows raises RuntimeError at the next log line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import RenderConfig
from .core import camera as cam
from .io.cameras import load_cameras_json
from .io.ply import read_ply
from .ops.composite import post_process
from .ops.rasterize import render
from .utils.image import write_png


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (use --device cpu to render on the CPU)")
    return dev


def _load(args, device):
    t0 = time.time()
    last = [0.0]

    def progress(got, total):
        if time.time() - last[0] > 0.5:
            last[0] = time.time()
            print(f"\rloading {got/1e6:.0f}/{total/1e6:.0f} MB", end="",
                  file=sys.stderr)

    cloud = read_ply(args.ply, progress=progress, device=device)
    print(f"\rloaded {cloud.num_gaussians} gaussians "
          f"(SH degree {cloud.sh_degree}) in {time.time()-t0:.2f}s",
          file=sys.stderr)
    if getattr(args, "dtype", None):
        cloud = cloud.with_storage_dtype(args.dtype)
    return cloud


def _config(args) -> RenderConfig:
    kw = {f: getattr(args, f) for f in ("tile_size", "max_dup", "max_per_tile",
                                        "tile_chunk", "depth_bits", "dtype")
          if getattr(args, f, None) is not None}
    return RenderConfig(**kw)


def _pad_to_multiple(cloud, s: int):
    """Pad N to a multiple of `s` with dead gaussians (opacity logit −100,
    zeros elsewhere: they never rasterize), as the JAX CLI does."""
    pad = -cloud.num_gaussians % s
    if not pad:
        return cloud

    def grow(name):
        a = getattr(cloud, name)
        tail = torch.full((pad,) + a.shape[1:],
                          -100.0 if name == "opacity_logit" else 0.0,
                          dtype=a.dtype, device=a.device)
        return torch.cat([a, tail])

    return type(cloud)(**{f.name: grow(f.name)
                          for f in dataclasses.fields(cloud)})


def _gaussian_sharded_renderer(args, cloud, config):
    """(render_fn, is_writer) for `render --gaussian-sharded`: this rank's
    shard of the (padded) cloud rendered by the ring or the banded path
    over every rank of the process group, or over a 1 × 1 mesh alone."""
    from .parallel import (
        make_mesh,
        render_gaussian_sharded,
        render_gaussian_sharded_banded,
        shard_model,
    )

    mesh = make_mesh()
    s = mesh.shape["tile"]
    if s < 2:
        print("--gaussian-sharded: one rank; rendering on a 1 x 1 mesh (no "
              "sharding win; start it under torchrun for more)",
              file=sys.stderr)
    shard = shard_model(_pad_to_multiple(cloud, s), mesh)

    def render_fn(camera, w, h):
        if args.gaussian_sharded == "banded":
            rgb, alpha, over = render_gaussian_sharded_banded(
                shard, camera, w, h, mesh, config)
            stats = f"overflow={int(over)}"
        else:
            rgb, alpha = render_gaussian_sharded(shard, camera, w, h, mesh,
                                                 config)
            stats = f"ranks={s}"
        bg = torch.tensor(config.background, dtype=rgb.dtype,
                          device=rgb.device)
        return rgb + (1.0 - alpha[..., None]) * bg, alpha, stats

    return render_fn, (not dist.is_initialized()) or dist.get_rank() == 0


def cmd_info(args):
    cloud = read_ply(args.ply, device="cpu")
    lo, hi = cloud.bbox()
    print(json.dumps({
        "num_gaussians": cloud.num_gaussians,
        "sh_degree": cloud.sh_degree,
        "bbox_min": [float(x) for x in lo],
        "bbox_max": [float(x) for x in hi],
    }, indent=2))


def cmd_render(args):
    from .parallel.multihost import initialize_multihost

    joined = bool(args.gaussian_sharded) and initialize_multihost(
        device=args.device)
    try:
        _render(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _render(args):
    device = _device(args)
    cloud = _load(args, device)
    config = _config(args)
    w, h = args.width, args.height

    if args.cameras:
        cams = load_cameras_json(args.cameras, target_size=(w, h))
        if args.limit:
            cams = cams[: args.limit]
    else:
        lo, hi = cloud.bbox()
        center = ((lo + hi) / 2).cpu().numpy()
        camera = cam.default_camera(w, h, eye=center + np.array([0, 0, -5.0]),
                                    center=center)
        cams = [(camera, (w, h), "default")]

    if args.gaussian_sharded:
        render_fn, writer = _gaussian_sharded_renderer(args, cloud, config)
    else:
        writer = True

        def render_fn(camera, w, h):
            img, aux = render(cloud, camera, w, h, config)
            return img, aux["alpha"], f"pairs={int(aux['num_pairs'])}"

    os.makedirs(args.out, exist_ok=True)
    total_t = 0.0
    for i, (camera, _, name) in enumerate(cams):
        t0 = time.time()
        with torch.no_grad():
            img, alpha, stats = render_fn(camera, w, h)
            if args.post:
                # the reference's present pass always shapes alpha
                # (post_process_render.ts:145-166); write straight RGBA
                rgba = post_process(img, alpha, config)
                a = torch.clamp(rgba[..., 3:4], min=1.0 / 255.0)
                img = torch.cat(
                    [torch.clamp(rgba[..., :3] / a, 0.0, 1.0), rgba[..., 3:4]],
                    dim=-1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        total_t += dt
        if not writer:
            continue
        out = os.path.join(args.out, f"{i:04d}_{os.path.basename(str(name))}.png")
        write_png(img.cpu().numpy(), out)
        print(f"{out}  {dt*1e3:.1f} ms  ({w*h/dt/1e6:.1f} Mpix/s, "
              f"{stats}, device={device})", file=sys.stderr)
    if writer:
        print(f"rendered {len(cams)} views, avg "
              f"{total_t/len(cams)*1e3:.1f} ms/view", file=sys.stderr)


def cmd_serve(args):
    from .viewer.server import serve

    device = _device(args)
    cloud = _load(args, device)
    # ?model=<name> scene switching resolves .ply files next to the
    # launch scene (the reference's URL-parameter loading, index.ts:89-95)
    scene_dir = os.path.dirname(os.path.abspath(args.ply))
    serve(cloud, host=args.host, port=args.port,
          width=args.width, height=args.height, config=_config(args),
          scene_dir=scene_dir, device=device)


def cmd_train(args):
    import shutil

    from .parallel.multihost import initialize_multihost, run_with_restarts

    if args.restarts and not args.checkpoint:
        raise SystemExit("--restarts needs --checkpoint (a restart resumes "
                         "from the newest loop state there)")
    if args.multihost:
        # join the job's process group first (a no-op without torchrun's
        # coordinator: the single-process case)
        initialize_multihost(device=args.device)
    from .io.dataset import load_dataset
    from .models.gaussian_model import GaussianModel
    from .train.checkpoint import has_checkpoint, save_ply, save_train_state
    from .train.densify import compact
    from .train.train_loop import TrainLoopConfig, train

    device = _device(args)
    views = load_dataset(args.cameras, args.images, args.width, args.height,
                         limit=args.limit or None)
    print(f"{len(views)} training views at {args.width}x{args.height}",
          file=sys.stderr)
    if args.ply:
        model = GaussianModel.from_cloud(_load(args, device))
    else:
        # bootstrap from random points inside the camera hull
        centers = np.stack([v.camera.cam_pos.numpy() for v in views])
        lo, hi = centers.min(0) - 1, centers.max(0) + 1
        rng = np.random.default_rng(0)
        xyz = rng.uniform(lo, hi, size=(20_000, 3)).astype(np.float32)
        model = GaussianModel.from_points(xyz, sh_degree=3)

    rank = dist.get_rank() if dist.is_initialized() else 0
    if (args.fresh and args.checkpoint and rank == 0
            and has_checkpoint(args.checkpoint)):
        # without --fresh, a re-run with the same directory resumes; the
        # other ranks wait for this at `train`'s barrier
        shutil.rmtree(args.checkpoint)
        print(f"--fresh: removed the loop state in {args.checkpoint}",
              file=sys.stderr)

    mesh = None
    if args.gaussian_sharded:
        from .parallel import make_mesh

        mesh = make_mesh()
        if mesh.shape["tile"] < 2:
            print("--gaussian-sharded: one rank; training the replicated "
                  "loop (start it under torchrun with --multihost to shard)",
                  file=sys.stderr)

    def run_once(checkpoint_dir):
        return train(
            model, views, args.width, args.height,
            render_config=_config(args),
            loop=TrainLoopConfig(iterations=args.iterations),
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=args.checkpoint_every, device=device,
            mesh=mesh)

    if args.restarts:
        # checkpoint-restart: a transient failure resumes from the newest
        # loop state in --checkpoint (`train` leaves `model` unchanged)
        state, dstate = run_with_restarts(run_once, args.checkpoint,
                                          max_restarts=args.restarts)
    else:
        state, dstate = run_once(args.checkpoint)
    if mesh is not None and mesh.shape["tile"] > 1:
        from .parallel import gather_sharded_model

        final = gather_sharded_model(state.model, dstate.alive, mesh)
    else:
        final = compact(state.model, dstate)
    if dist.is_initialized():
        # every rank trained the same replicated loop (as the JAX CLI's
        # ranks do), or its shard of the model; rank 0 writes the outputs
        dist.destroy_process_group()
        if rank:
            return
    save_ply(final, args.out)
    print(f"saved {final.num_gaussians} gaussians → {args.out}",
          file=sys.stderr)
    if args.checkpoint:
        save_train_state(state, args.checkpoint + "-final")


def cmd_eval(args):
    from .io.dataset import load_dataset
    from .train.loss import full_f32, ssim

    device = _device(args)
    full_f32()
    cloud = _load(args, device)
    config = _config(args)
    views = load_dataset(args.cameras, args.images, args.width, args.height,
                         limit=args.limit or None)
    psnrs, ssims = [], []
    for v in views:
        with torch.no_grad():
            img, _ = render(cloud, v.camera, args.width, args.height, config)
            img = torch.clamp(img, 0, 1)
            ssims.append(float(ssim(img, torch.from_numpy(v.image).to(
                img.device))))
        mse = float(np.mean((img.cpu().numpy() - v.image) ** 2))
        psnrs.append(10 * np.log10(1.0 / max(mse, 1e-10)))
        print(f"{v.name}: PSNR {psnrs[-1]:.2f} dB  SSIM {ssims[-1]:.4f}",
              file=sys.stderr)
    print(json.dumps({
        "views": len(views),
        "psnr_mean": float(np.mean(psnrs)),
        "ssim_mean": float(np.mean(ssims)),
    }))


def cmd_bench(args):
    from . import bench_lib

    _device(args)
    result = bench_lib.run(args.ply, args.width, args.height,
                           device=args.device, config=_config(args))
    if result["parity_gate_ok"] is False:
        sys.exit(1)


def main(argv=None):
    p = argparse.ArgumentParser(prog="gaussian_splatting_web_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, ply_required=True):
        sp.add_argument("--ply", required=ply_required)
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")
        sp.add_argument("--width", type=int, default=1280)
        sp.add_argument("--height", type=int, default=720)
        sp.add_argument("--tile-size", dest="tile_size", type=int)
        sp.add_argument("--max-dup", dest="max_dup", type=int)
        sp.add_argument("--max-per-tile", dest="max_per_tile", type=int)
        sp.add_argument("--tile-chunk", dest="tile_chunk", type=int,
                        help="strip alignment of the sharded tile deals")
        sp.add_argument("--dtype", choices=("float32", "bfloat16"),
                        help="scene storage dtype (bfloat16 stores all but "
                        "the positions in bf16; compute stays f32)")
        sp.add_argument("--depth-bits", dest="depth_bits", type=int,
                        help="packed sort depth bits (0 = exact sort, the "
                        "default)")

    sp = sub.add_parser("info", help="scene statistics")
    sp.add_argument("--ply", required=True)
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("render", help="offline render to PNGs")
    sp.add_argument("--no-post", dest="post", action="store_false",
                    help="skip the present-pass alpha shaping "
                         "(post_process_render.ts:63-76)")
    common(sp)
    sp.add_argument("--cameras", help="INRIA cameras.json")
    sp.add_argument("--out", default="renders")
    sp.add_argument("--limit", type=int, default=0)
    sp.add_argument("--gaussian-sharded", dest="gaussian_sharded",
                    nargs="?", const="ring", choices=("ring", "banded"),
                    help="shard the gaussians over the ranks of torchrun's "
                    "process group (parallel.gaussian_sharded): '=ring' "
                    "(the default) gathers every shard's projected splats, "
                    "'=banded' sends each rank only the splats that touch "
                    "its band of tile rows; rank 0 writes the PNGs")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("serve", help="interactive web viewer")
    common(sp)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8090)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("bench", help="throughput benchmark and the "
                        "kernels' gradient-parity gate")
    common(sp, ply_required=False)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("train", help="train a scene from posed images")
    common(sp, ply_required=False)
    sp.add_argument("--cameras", required=True, help="INRIA cameras.json")
    sp.add_argument("--images", required=True,
                    help="directory of the images (PNG or JPEG, resized to "
                    "--width x --height)")
    sp.add_argument("--out", default="trained.ply")
    sp.add_argument("--iterations", type=int, default=7000)
    sp.add_argument("--limit", type=int, default=0, help="max training views")
    sp.add_argument("--checkpoint", help="directory of the loop state "
                    "(model, optimizer, iteration): saved every "
                    "--checkpoint-every iterations, resumed from when "
                    "present; the final TrainState goes to <dir>-final")
    sp.add_argument("--checkpoint-every", type=int, default=500,
                    dest="checkpoint_every",
                    help="save the loop state every N iterations")
    sp.add_argument("--fresh", action="store_true",
                    help="discard a loop state in --checkpoint and start "
                    "from scratch")
    sp.add_argument("--multihost", action="store_true",
                    help="join torchrun's process group before training "
                    "(a no-op without a coordinator)")
    sp.add_argument("--gaussian-sharded", dest="gaussian_sharded",
                    nargs="?", const="banded", choices=("banded",),
                    help="with --multihost, shard the gaussians, their Adam "
                    "moments and densification statistics over the ranks "
                    "(train's Gaussian-sharded arena): each rank receives "
                    "the splats that touch its band of tile rows; no "
                    "densification round, opacity reset or --checkpoint")
    sp.add_argument("--restarts", type=int, default=0,
                    help="checkpoint-restart retries after a transient "
                    "failure (needs --checkpoint)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval", help="PSNR/SSIM against ground-truth images")
    common(sp)
    sp.add_argument("--cameras", required=True, help="INRIA cameras.json")
    sp.add_argument("--images", required=True)
    sp.add_argument("--limit", type=int, default=0)
    sp.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
