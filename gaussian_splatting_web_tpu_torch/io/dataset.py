"""Training dataset: posed images + cameras, the port of the JAX package's
`io/dataset.py`. Loads an INRIA-style capture: a cameras.json (io.cameras)
next to an images directory whose file names match the `img_name` entries,
served as [H, W, 3] float32 targets in [0, 1].

A PNG at the training resolution is decoded with the standard library
(utils.image.read_png). Any other file (JPEG, as INRIA captures are) or
size goes through pillow, imported only then, exactly as the JAX package
loads every image: `Image.open(p).convert("RGB")`, a LANCZOS resize to the
training size when the size differs, / 255 in float32, so both packages
give the same bits.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

from ..core.types import CameraParams
from ..utils.image import read_png
from .cameras import load_cameras_json


@dataclasses.dataclass
class View:
    camera: CameraParams
    image: np.ndarray  # [H, W, 3] float32 in [0, 1]
    name: str


def _load_with_pillow(path: str, width: int, height: int) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: JPEG input and resizing need pillow (pip install "
            "pillow); a PNG at the training size needs nothing") from e
    img = Image.open(path).convert("RGB")
    if img.size != (width, height):
        img = img.resize((width, height), Image.LANCZOS)
    return np.asarray(img, dtype=np.float32) / 255.0


def _load_image(path: str, width: int, height: int) -> np.ndarray:
    if not path.lower().endswith(".png"):
        return _load_with_pillow(path, width, height)
    img = read_png(path)
    if img.shape[:2] != (height, width):
        return _load_with_pillow(path, width, height)
    if img.shape[2] < 3:           # grey (+ alpha) → RGB
        img = np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3].astype(np.float32) / 255.0


def load_dataset(
    cameras_json: str,
    images_dir: str,
    width: int,
    height: int,
    limit: Optional[int] = None,
    extensions: Sequence[str] = (".png", ".jpg", ".jpeg", ".JPG", ".PNG"),
) -> List[View]:
    """Load all (camera, image) pairs whose image file exists."""
    views: List[View] = []
    for camera, _, name in load_cameras_json(cameras_json,
                                             target_size=(width, height)):
        stem = os.path.splitext(str(name))[0]
        path = next((c for c in (os.path.join(images_dir, stem + ext)
                                 for ext in extensions)
                     if os.path.exists(c)), None)
        if path is None:
            continue
        views.append(View(camera=camera,
                          image=_load_image(path, width, height),
                          name=str(name)))
        if limit and len(views) >= limit:
            break
    if not views:
        raise FileNotFoundError(
            f"no images from {cameras_json} found under {images_dir}")
    return views


def scene_extent(views: Sequence[View]) -> float:
    """INRIA 'cameras extent': radius of the camera-centre bounding
    sphere."""
    centers = np.stack([v.camera.cam_pos.detach().cpu().numpy()
                        for v in views])
    center = centers.mean(axis=0)
    return float(np.linalg.norm(centers - center, axis=1).max()) * 1.1 or 1.0


def epoch_indices(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).permutation(n)
