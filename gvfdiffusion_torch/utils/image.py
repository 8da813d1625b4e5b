"""Image resizes with `jax.image.resize`'s arithmetic, and image files.

`resize_bilinear` and `resize_cubic` take [..., H, W, C] (channels last,
as the JAX package lays images out): half-pixel centres and, when
shrinking, the kernel widened by the shrink factor, which is torch's
`antialias=True` (for "cubic" even when enlarging: Keys' a = -0.5, as JAX,
where torch's plain bicubic takes a = -0.75).

`read_image` goes through cv2 where it is installed, else imageio (the JAX
package's reader); neither is imported before a call.
"""

from __future__ import annotations

import importlib.util

import numpy as np
import torch
import torch.nn.functional as F


def _resize(images: torch.Tensor, size, mode: str) -> torch.Tensor:
    lead, (H, W, C) = images.shape[:-3], images.shape[-3:]
    x = images.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(size), mode=mode, align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, *size, C)


def resize_bilinear(images: torch.Tensor, size) -> torch.Tensor:
    """[..., H, W, C] -> [..., h, w, C], `jax.image.resize(..., "bilinear")`."""
    return _resize(images, size, "bilinear")


def resize_cubic(images: torch.Tensor, size) -> torch.Tensor:
    """[..., H, W, C] -> [..., h, w, C], `jax.image.resize(..., "cubic")`."""
    return _resize(images, size, "bicubic")


def has_cv2() -> bool:
    return importlib.util.find_spec("cv2") is not None


def read_image(path: str, keep_gray: bool = False) -> np.ndarray:
    """An image file -> uint8 [H, W, 3] RGB or [H, W, 4] RGBA; a grayscale
    file [H, W] with `keep_gray` (as imageio reads it), else its value in
    three channels."""
    if has_cv2():
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(f"cv2 could not read {path}")
        if img.ndim == 2:
            return img if keep_gray else np.repeat(img[..., None], 3, -1)
        code = cv2.COLOR_BGRA2RGBA if img.shape[-1] == 4 else \
            cv2.COLOR_BGR2RGB
        return cv2.cvtColor(img, code)
    import imageio

    img = np.asarray(imageio.imread(path))
    return img if img.ndim == 3 or keep_gray else np.repeat(img[..., None],
                                                            3, -1)

