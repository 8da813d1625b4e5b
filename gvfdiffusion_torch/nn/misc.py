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


def conv(fn, x: torch.Tensor, layer: nn.Module, dtype: torch.dtype,
         **kw) -> torch.Tensor:
    """flax `nn.Conv(dtype=dtype)` through `fn` (F.conv2d, F.conv3d):
    input and parameters cast to `dtype`, the output in `dtype`; see
    `conv_weights`."""
    return conv_weights(fn, x.to(dtype), layer.weight.to(dtype),
                        None if layer.bias is None else layer.bias.to(dtype),
                        **kw)


def conv_weights(fn, x: torch.Tensor, weight: torch.Tensor,
                 bias, **kw) -> torch.Tensor:
    """fn(x, weight, bias, **kw); in fp32 on the card with cuDNN's TF32
    off, whatever the process set: cuDNN's default would round its
    operands to TF32's 10-bit mantissa, and XLA computes it in fp32. (fp32
    matmuls follow torch's default, which takes no TF32.)"""
    if x.dtype != torch.float32 or not x.is_cuda:
        return fn(x, weight, bias, **kw)
    flags = torch.backends.cudnn
    prev, flags.allow_tf32 = flags.allow_tf32, False
    try:
        return fn(x, weight, bias, **kw)
    finally:
        flags.allow_tf32 = prev


def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """flax `nn.LayerNorm(use_scale=False, use_bias=False, dtype=float32)`:
    fp32 statistics with the fast variance E[x^2] - E[x]^2 (clipped at 0),
    fp32 output."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (xf - mu) * torch.rsqrt(var + eps)
