"""Windowed SSIM and PSNR (port of gvfdiffusion_tpu/ops/ssim.py): an 11 x 11
Gaussian window of sigma 1.5, C1 = 0.01^2, C2 = 0.03^2, zero padding.
Images are channels-last [B, H, W, C] in [0, 1]; differentiable.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.misc import conv_weights


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g)


def _filter2d(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 2-D filter of [B, C, H, W] with SAME (zero) padding."""
    c = img.shape[1]
    k = window.shape[0]
    w = window[None, None].expand(c, 1, k, k)
    return conv_weights(F.conv2d, img, w, None, padding=k // 2, groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over [B, H, W, C] image pairs (a scalar)."""
    window = torch.as_tensor(_gaussian_window(size, sigma), dtype=img1.dtype,
                             device=img1.device)
    a, b = (x.permute(0, 3, 1, 2) for x in (img1, img2))
    mu1, mu2 = _filter2d(a, window), _filter2d(b, window)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2d(a * a, window) - mu1_sq
    s2 = _filter2d(b * b, window) - mu2_sq
    s12 = _filter2d(a * b, window) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return m.mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """PSNR in dB over all elements."""
    mse = ((img1 - img2) ** 2).mean()
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))
