"""Training losses, the port of the JAX package's `train/loss.py`: the
INRIA objective L = (1−λ)·L1 + λ·(1 − SSIM)/2 with λ = 0.2, SSIM over an
11×11 Gaussian window (σ = 1.5) as a separable depthwise convolution with
zero (SAME) padding, on [H, W, C] images in [0, 1].

On the card cuDNN runs float32 convolutions in TF32 unless
`torch.backends.cudnn.allow_tf32` is off, which moves SSIM in the 4th
digit; `full_f32()` turns it off, and the training entry points
(`train/trainer.py::make_train_step`, `train/train_loop.py::train`) call it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import tracing


def full_f32() -> None:
    """Run float32 matmuls and cuDNN convolutions in full float32 (no TF32)
    for the rest of the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def psnr(pred, target) -> float:
    """Peak signal-to-noise ratio in dB for [0, 1] images."""
    pred = torch.as_tensor(pred).detach().cpu().double()
    target = torch.as_tensor(target).detach().cpu().double()
    mse = float(torch.mean((pred - target) ** 2))
    return 10.0 * float(np.log10(1.0 / max(mse, 1e-10)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of [H, W, C] with SAME zero padding."""
    c = img.shape[-1]
    size = window.shape[0]
    x = img.permute(2, 0, 1)[None]                          # NCHW
    kh = window.reshape(1, 1, size, 1).expand(c, 1, size, 1)
    kw = window.reshape(1, 1, 1, size).expand(c, 1, 1, size)
    x = F.conv2d(x, kh, padding=(size // 2, 0), groups=c)
    x = F.conv2d(x, kw, padding=(0, size // 2), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(
    a: torch.Tensor,
    b: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01 ** 2,
    c2: float = 0.03 ** 2,
) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] image pair in [0, 1]."""
    w = torch.from_numpy(_gaussian_window(window_size, sigma)).to(a.device)
    mu_a = _blur(a, w)
    mu_b = _blur(b, w)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sig_a = _blur(a * a, w) - mu_aa
    sig_b = _blur(b * b, w) - mu_bb
    sig_ab = _blur(a * b, w) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sig_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sig_a + sig_b + c2))
    return torch.mean(s)


@tracing.spanned("loss")
def photometric_loss(pred: torch.Tensor, target: torch.Tensor,
                     lambda_dssim: float = 0.2) -> torch.Tensor:
    """INRIA objective: (1−λ)·L1 + λ·(1−SSIM)/2."""
    return ((1.0 - lambda_dssim) * l1_loss(pred, target)
            + lambda_dssim * 0.5 * (1.0 - ssim(pred, target)))
