"""Small helpers that give torch layers flax's dtype semantics."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=dtype)`: input and parameters cast to `dtype`,
    the product returned in `dtype` (parameters are kept as stored)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """flax `nn.LayerNorm(use_scale=False, use_bias=False, dtype=float32)`:
    fp32 statistics with the fast variance E[x^2] - E[x]^2 (clipped at 0),
    fp32 output."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (xf - mu) * torch.rsqrt(var + eps)
