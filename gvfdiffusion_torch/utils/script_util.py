"""Small script-level helpers (port of gvfdiffusion_tpu/utils/script_util.py).

The diffusion factories live in diffusion/gaussian_diffusion.create_diffusion
and diffusion/respace.spaced_diffusion; this module holds the rest.
"""

from __future__ import annotations

import numpy as np
import torch

from ..diffusion.gaussian_diffusion import GaussianDiffusion


def init_volume_grid(resolution: int, normalize: bool = True) -> np.ndarray:
    """[R^3, 3] dense voxel coordinates, voxel centres in [0, 1] when
    `normalize`."""
    g = np.arange(resolution, dtype=np.float32)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    if normalize:
        grid = (grid + 0.5) / resolution
    return grid


def predict_x0_from_q(diffusion: GaussianDiffusion, x_start: torch.Tensor,
                      t: torch.Tensor, noise: torch.Tensor,
                      model_output: torch.Tensor) -> torch.Tensor:
    """The model's implied x0 from a training forward pass: q_sample, then
    the inverse of the process's mean type."""
    x_t = diffusion.q_sample(x_start, t, noise)
    if diffusion.mean_type == "eps":
        return diffusion.predict_xstart_from_eps(x_t, t, model_output)
    if diffusion.mean_type == "v":
        return diffusion.predict_xstart_from_v(x_t, t, model_output)
    if diffusion.mean_type == "x0":
        return model_output
    raise NotImplementedError(diffusion.mean_type)
