"""The benchmark's plain reference: `render.py` (projection, footprint,
compositing and its backward) and `train.py` (loss, Adam, training steps),
plain PyTorch written from the method and the configuration's rules. It
imports nothing of the program and nothing of JAX."""

import torch


def full_f32() -> None:
    """float32 matrix products and convolutions without TF32, as the
    configurations state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
