"""The SparseVAE's Gaussian layout (port of
gvfdiffusion_tpu/models/sparse_vae.py:26-127): 8 Gaussians per voxel, 112
channels ({xyz offset, SH DC, scaling, rotation, opacity} x 8), placed at
the voxel centre plus a tanh-bounded offset with a Hammersley
perturbation; and the VAE's KL and regularization losses (:130-152).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..representations.gaussians import GaussianSplat
from ..sparse.tensor import SparseVoxels


def halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    i = index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def hammersley_sequence(dim: int, n: int, num_samples: int):
    primes = [2, 3, 5, 7, 11]
    return [n / num_samples] + [halton(n, primes[d]) for d in range(dim - 1)]


class GSConfig(NamedTuple):
    """The Gaussian representation's settings (configs/diffusion.yml)."""

    num_gaussians: int = 8
    voxel_size: float = 1.5
    scaling_bias: float = 0.004
    opacity_bias: float = 0.1
    scaling_activation: str = "softplus"
    filter_2d_kernel_size: float = 0.1
    filter_3d_kernel_size: float = 0.0009
    perturb_offset: bool = True
    reg_mode: str = "soft_invoxel"
    lr_xyz: float = 1.0
    lr_features_dc: float = 1.0
    lr_opacity: float = 1.0
    lr_scaling: float = 1.0
    lr_rotation: float = 0.1

    @property
    def out_channels(self) -> int:
        return self.num_gaussians * 14


def build_perturbation(cfg: GSConfig) -> np.ndarray:
    """atanh of the Hammersley offsets, [G, 3] float32."""
    g = cfg.num_gaussians
    offsets = np.array([hammersley_sequence(3, i, g) for i in range(g)]) - 0.5
    if cfg.reg_mode == "soft_invoxel":
        offsets = offsets / 0.5 / cfg.voxel_size
    return np.arctanh(np.clip(offsets, -0.999999, 0.999999)).astype(np.float32)


def to_representation(x: SparseVoxels, cfg: GSConfig = GSConfig(),
                      resolution: Optional[int] = None):
    """Network output [B, L, G*14] -> (GaussianSplat [B, L*G, ...], valid
    [B, L*G]). Channels per voxel: xyz offsets [G*3] | SH DC [G*3] |
    scaling [G*3] | rotation [G*4] | opacity [G]."""
    res = resolution or x.resolution
    g = cfg.num_gaussians
    b, l, _ = x.feats.shape
    f = x.feats
    o = 0

    def take(n, shape):
        nonlocal o
        out = f[..., o:o + g * n].reshape(b, l, g, *shape)
        o += g * n
        return out

    off = take(3, (3,)) * cfg.lr_xyz
    feats_dc = take(3, (1, 3)) * cfg.lr_features_dc
    scaling = take(3, (3,)) * cfg.lr_scaling
    rotation = take(4, (4,)) * cfg.lr_rotation
    opacity = take(1, (1,)) * cfg.lr_opacity
    if cfg.perturb_offset:
        off = off + torch.from_numpy(build_perturbation(cfg)).to(f.device)
    if cfg.reg_mode == "invoxel":
        off = torch.tanh(off) / res
    elif cfg.reg_mode == "soft_invoxel":
        off = torch.tanh(off) / res * 0.5 * cfg.voxel_size
    else:
        raise ValueError(cfg.reg_mode)
    center = (x.coords.float() + 0.5) / res
    xyz = center[:, :, None, :] + off
    flat = lambda a: a.reshape(b, l * g, *a.shape[3:])
    gs = GaussianSplat(
        _xyz=flat(xyz), _features_dc=flat(feats_dc), _scaling=flat(scaling),
        _rotation=flat(rotation), _opacity=flat(opacity),
        aabb=torch.tensor([-0.5, -0.5, -0.5, 1.0, 1.0, 1.0], device=f.device),
        scaling_bias=cfg.scaling_bias, opacity_bias=cfg.opacity_bias,
        scaling_activation=cfg.scaling_activation,
        mininum_kernel_size=cfg.filter_3d_kernel_size)
    return gs, x.valid.repeat_interleave(g, dim=1)


def regularization_losses(gs: GaussianSplat, valid: torch.Tensor,
                          lambda_vol: float = 10000.0,
                          lambda_opacity: float = 0.001
                          ) -> Dict[str, torch.Tensor]:
    """The volume and opacity regularizers averaged over the valid
    Gaussians: dict(reg_vol, reg_opacity, loss = lambda_vol * reg_vol +
    lambda_opacity * reg_opacity)."""
    w = valid.float()
    n = torch.clamp(w.sum(), min=1.0)
    reg_vol = (torch.prod(gs.get_scaling, dim=-1) * w).sum() / n
    reg_op = (((gs.get_opacity[..., 0] - 1.0) ** 2) * w).sum() / n
    return {"reg_vol": reg_vol, "reg_opacity": reg_op,
            "loss": lambda_vol * reg_vol + lambda_opacity * reg_op}


def kl_loss(mean: torch.Tensor, logvar: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """KL of the diagonal Gaussian to N(0, I), averaged over valid voxels."""
    per = 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar).sum(-1)
    w = valid.float()
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)
