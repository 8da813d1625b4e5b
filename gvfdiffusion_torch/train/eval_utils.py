"""Evaluation helpers: reconstruction metrics, multiview snapshots and
rendered-vs-target image dumps (port of gvfdiffusion_tpu/train/
eval_utils.py; the reference's train_vae.py:231-240 dumps, sparse_vae.py:384
snapshots, utils/script_util.py:97 psnr).

`dump_image_pairs` writes a PNG through imageio where it imports, else a
`.npy` of the same grid, as JAX's does; on a machine without imageio (the
card's) it writes `.npy`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.ssim import psnr, ssim
from ..render.renderer import GaussianRenderer
from ..representations.camera import orbit_camera
from ..representations.gaussians import GaussianSplat


def reconstruction_metrics(pred: torch.Tensor,
                           target: torch.Tensor) -> Dict[str, float]:
    """PSNR / SSIM / L1 over [*, H, W, C] image stacks."""
    p = pred.reshape(-1, *pred.shape[-3:])
    t = target.reshape(-1, *target.shape[-3:])
    return {"psnr": float(psnr(p, t)), "ssim": float(ssim(p, t)),
            "l1": float(torch.mean(torch.abs(p - t)))}


@torch.no_grad()
def snapshot_multiview(renderer: GaussianRenderer, gs: GaussianSplat,
                       valid: Optional[torch.Tensor] = None,
                       num_views: int = 4, resolution: int = 256,
                       pitch_deg: float = 20.0,
                       radius: float = 2.0) -> np.ndarray:
    """[V, H, W, 3] orbit snapshots, one render a view (the reference's
    sparse_vae.py:384)."""
    out = []
    for v in range(num_views):
        cam = orbit_camera(360.0 * v / num_views, pitch_deg, radius=radius,
                           height=resolution, width=resolution)
        out.append(renderer.render(gs, cam, valid=valid)["render"].cpu()
                   .numpy())
    return np.stack(out)


def dump_image_pairs(rendered: np.ndarray, target: np.ndarray, out_dir: str,
                     step: int, prefix: str = "recon") -> str:
    """Rendered | target side by side, the pairs stacked down one image, at
    `<out_dir>/<prefix>_<step:06d>.png` (or `.npy` without imageio);
    returns the path (the reference's train_vae.py:231-240)."""
    os.makedirs(out_dir, exist_ok=True)
    r = np.clip(np.asarray(rendered), 0, 1)
    t = np.clip(np.asarray(target), 0, 1)
    pair = np.concatenate([r, t], axis=-2)  # side by side along the width
    flat = pair.reshape(-1, *pair.shape[-3:])
    grid = np.concatenate(list(flat), axis=0)
    path = os.path.join(out_dir, f"{prefix}_{step:06d}.png")
    try:
        import imageio

        imageio.imwrite(path, (grid * 255).astype(np.uint8))
    except ImportError:
        path = path.replace(".png", ".npy")
        np.save(path, grid)
    return path
