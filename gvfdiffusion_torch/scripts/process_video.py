"""Video frames -> DINOv2 tokens (port of
gvfdiffusion_tpu/scripts/process_video.py:49-116, the in-memory half).

`normalize_frame` centres the masked object at 380 px inside a white
512 px canvas; `encode_video` normalizes every frame, resizes the canvas to
518 and runs `models/dinov2.encode_image`. Frame extraction (ffmpeg,
imageio), the matting hook and file output are not ported: frames come in
as arrays, with their alpha as a fourth channel where they have one.

Resizes are bilinear with half-pixel centres and, when shrinking, an
antialiasing triangle filter widened by the shrink factor, as
`jax.image.resize(..., "bilinear")` computes them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..models.dinov2 import DinoV2, encode_image
from ..utils.device import resolve_device


def resize_bilinear(images: torch.Tensor, size) -> torch.Tensor:
    """[..., H, W, C] -> [..., h, w, C], antialiased when shrinking."""
    lead, (H, W, C) = images.shape[:-3], images.shape[-3:]
    x = images.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, *size, C)


def normalize_frame(image: np.ndarray, alpha: Optional[np.ndarray] = None,
                    content_size: int = 380,
                    canvas_size: int = 512) -> np.ndarray:
    """Centre the masked object at content_size inside a white canvas_size
    square. image [H, W, 3 or 4], in [0, 1] or [0, 255]; alpha [H, W] or
    the image's fourth channel or all ones -> [canvas, canvas, 3] float32."""
    img = image.astype(np.float32)
    if img.max() > 1.5:
        img /= 255.0
    if alpha is None:
        alpha = (img[..., 3] if img.shape[-1] == 4
                 else np.ones(img.shape[:2], np.float32))
    rgb = img[..., :3]
    ys, xs = np.where(alpha > 0.5)
    if len(ys) == 0:
        ys, xs = np.arange(img.shape[0]), np.arange(img.shape[1])
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    a = alpha[y0:y1, x0:x1, None]
    crop = rgb[y0:y1, x0:x1] * a + (1.0 - a)
    h, w = crop.shape[:2]
    s = content_size / max(h, w)
    nh, nw = int(round(h * s)), int(round(w * s))
    resized = resize_bilinear(torch.from_numpy(
        np.ascontiguousarray(crop, np.float32)), (nh, nw)).numpy()
    canvas = np.ones((canvas_size, canvas_size, 3), np.float32)
    oy, ox = (canvas_size - nh) // 2, (canvas_size - nw) // 2
    canvas[oy:oy + nh, ox:ox + nw] = resized
    return canvas


@torch.no_grad()
def encode_video(frames: Union[np.ndarray, Sequence[np.ndarray]],
                 model: DinoV2, image_size: int = 518,
                 device="cuda") -> torch.Tensor:
    """Per-frame DINOv2 tokens: T frames [H, W, 3 or 4] (a fourth channel
    is the alpha mask) -> [T, 1 + R + L, C] fp32 on `device` (the model
    moves there). Raises when `device` names CUDA and there is none."""
    dev = resolve_device(device)
    model.to(dev)
    canvases = np.stack([normalize_frame(np.asarray(f)) for f in frames])
    batch = resize_bilinear(torch.from_numpy(canvases).to(dev),
                            (image_size, image_size))
    return encode_image(model, batch)
