"""Small helpers that give torch layers flax's dtype semantics, and the
trainers' utilities of gvfdiffusion_tpu/nn/misc.py: `update_ema`,
`mean_flat`, `Conv4d` and `AttentionPooling` (their parameters carry
across from JAX through utils/weights.py's `conv4d_table` and
`attention_pooling_table`)."""

from __future__ import annotations

from typing import Dict, Tuple

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


def update_ema(ema_params: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor],
               rate: float = 0.9999) -> Dict[str, torch.Tensor]:
    """A new dict: ema * rate + p * (1 - rate) for each name (the
    reference's model/nn.py:277)."""
    return {k: e * rate + params[k] * (1.0 - rate)
            for k, e in ema_params.items()}


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """The mean over every dimension but the first."""
    return x.reshape(x.shape[0], -1).mean(1)


def same_padding(kernel: int) -> Tuple[int, int]:
    """flax's "SAME" padding at stride 1: k // 2 on both sides at an odd
    kernel, (k // 2 - 1, k // 2) at an even one."""
    return (kernel - 1) // 2, kernel // 2


class Conv4d(nn.Module):
    """A factorized 4-D convolution (the reference's model/nn.py:107-177):
    a spatial Conv3d over (D, H, W), then a temporal Conv1d over T, each
    with flax's "SAME" padding. [B, T, D, H, W, C] -> [B, T, D, H, W,
    features], channels last as in JAX; computed in `dtype`."""

    def __init__(self, in_channels: int, features: int,
                 spatial_kernel: int = 3, temporal_kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.spatial_conv = nn.Conv3d(in_channels, features, spatial_kernel)
        self.temporal_conv = nn.Conv1d(features, features, temporal_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d, h, w, c = x.shape
        f = self.features
        xs = x.reshape(b * t, d, h, w, c).permute(0, 4, 1, 2, 3)
        xs = F.pad(xs, same_padding(self.spatial_conv.kernel_size[0]) * 3)
        hs = conv(F.conv3d, xs, self.spatial_conv, self.dtype)
        # the temporal conv over T, batched over every spatial position
        ht = hs.reshape(b, t, f, d, h, w).permute(0, 3, 4, 5, 2, 1).reshape(
            b * d * h * w, f, t)
        ht = F.pad(ht, same_padding(self.temporal_conv.kernel_size[0]))
        ht = conv(F.conv1d, ht, self.temporal_conv, self.dtype)
        return ht.reshape(b, d, h, w, f, t).permute(0, 5, 1, 2, 3, 4)


class AttentionPooling(nn.Module):
    """Single-query attention pooling over a token set (the reference's
    model/nn.py AttentionPooling): the token mean is the query, attending
    over [mean, tokens] with `num_heads` heads. [B, L, C] -> [B, C]."""

    def __init__(self, channels: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.q_proj = nn.Linear(channels, channels)
        self.k_proj = nn.Linear(channels, channels)
        self.v_proj = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        heads = self.num_heads
        mean = x.mean(1, keepdim=True)
        tokens = torch.cat([mean, x], 1)

        def split(a, n):
            return a.reshape(b, n, heads, c // heads).transpose(1, 2)

        q = split(dense(mean, self.q_proj, self.dtype), 1)
        k = split(dense(tokens, self.k_proj, self.dtype), l + 1)
        v = split(dense(tokens, self.v_proj, self.dtype), l + 1)
        return F.scaled_dot_product_attention(q, k, v).reshape(b, c)
