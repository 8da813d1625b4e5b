"""Embedding modules (port of gvfdiffusion_tpu/nn/embedders.py).

Ordering conventions match the reference: timestep embeddings concatenate
[cos, sin]; absolute position embeddings concatenate [sin, cos] per axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .misc import dense


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """[B] (possibly fractional) timesteps -> [B, dim], [cos | sin] order."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """Sinusoidal frequencies -> Linear -> SiLU -> Linear (computes in
    `dtype`; the DiT keeps it in fp32, as the JAX DiT does)."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.dtype = dtype
        self.mlp = nn.Sequential(
            nn.Linear(frequency_embedding_size, hidden_size), nn.SiLU(),
            nn.Linear(hidden_size, hidden_size))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = timestep_embedding(t, self.frequency_embedding_size)
        x = F.silu(dense(x, self.mlp[0], self.dtype))
        return dense(x, self.mlp[2], self.dtype)


class AbsolutePositionEmbedder(nn.Module):
    """Sinusoidal embedding of `in_channels`-dim positions, [sin | cos] per
    axis, zero-padded to `channels`. Parameter-free."""

    def __init__(self, channels: int, in_channels: int = 3):
        super().__init__()
        self.channels = channels
        self.in_channels = in_channels

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        freq_dim = self.channels // self.in_channels // 2
        freqs = 1.0 / (10000.0 ** (
            torch.arange(freq_dim, dtype=torch.float32, device=pos.device)
            / freq_dim))
        args = pos.float()[..., None] * freqs  # [..., in_channels, freq_dim]
        emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
        emb = emb.reshape(*pos.shape[:-1], -1)
        pad = self.channels - emb.shape[-1]
        if pad > 0:
            emb = F.pad(emb, (0, pad))
        return emb
