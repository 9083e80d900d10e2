"""Command-line interface of the port (the JAX package's `cli.py`; only the
forward subcommands are ported so far):

  python -m gaussian_splatting_web_tpu_torch.cli info   --ply scene.ply
  python -m gaussian_splatting_web_tpu_torch.cli render --ply scene.ply [--cameras cam.json] --out out/ [--device cuda]
  python -m gaussian_splatting_web_tpu_torch.cli serve  --ply scene.ply --port 8090 [--device cuda]

`--device` defaults to `cuda`; a CUDA device that is not there is an
error, never a silent switch to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

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
    return cloud


def _config(args) -> RenderConfig:
    kw = {f: getattr(args, f) for f in ("tile_size", "max_dup", "max_per_tile")
          if getattr(args, f, None) is not None}
    return RenderConfig(**kw)


def cmd_info(args):
    cloud = read_ply(args.ply)
    lo, hi = cloud.bbox()
    print(json.dumps({
        "num_gaussians": cloud.num_gaussians,
        "sh_degree": cloud.sh_degree,
        "bbox_min": [float(x) for x in lo],
        "bbox_max": [float(x) for x in hi],
    }, indent=2))


def cmd_render(args):
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

    os.makedirs(args.out, exist_ok=True)
    total_t = 0.0
    for i, (camera, _, name) in enumerate(cams):
        t0 = time.time()
        with torch.no_grad():
            img, aux = render(cloud, camera, w, h, config)
            if args.post:
                # the reference's present pass always shapes alpha
                # (post_process_render.ts:145-166); write straight RGBA
                rgba = post_process(img, aux["alpha"], config)
                a = torch.clamp(rgba[..., 3:4], min=1.0 / 255.0)
                img = torch.cat(
                    [torch.clamp(rgba[..., :3] / a, 0.0, 1.0), rgba[..., 3:4]],
                    dim=-1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        total_t += dt
        out = os.path.join(args.out, f"{i:04d}_{os.path.basename(str(name))}.png")
        write_png(img.cpu().numpy(), out)
        print(f"{out}  {dt*1e3:.1f} ms  ({w*h/dt/1e6:.1f} Mpix/s, "
              f"pairs={int(aux['num_pairs'])}, device={device})",
              file=sys.stderr)
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


def main(argv=None):
    p = argparse.ArgumentParser(prog="gaussian_splatting_web_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--ply", required=True)
        sp.add_argument("--device", default="cuda",
                        help="torch device to render on (default cuda)")
        sp.add_argument("--width", type=int, default=1280)
        sp.add_argument("--height", type=int, default=720)
        sp.add_argument("--tile-size", dest="tile_size", type=int)
        sp.add_argument("--max-dup", dest="max_dup", type=int)
        sp.add_argument("--max-per-tile", dest="max_per_tile", type=int)

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
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("serve", help="interactive web viewer")
    common(sp)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8090)
    sp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
