"""Attention parameters and the cross-attention KV projection (port of
gvfdiffusion_tpu/nn/attention.py:73-85, 135-254).

The DiT runs its attention inside the fused sublayer kernels, so
`MultiHeadAttention` here holds the parameters under the reference's names
and computes only what the JAX package computes outside any kernel: the
loop-invariant cross-attention K/V (`kv`). As in the shipped DiT, self
attention carries q/k RMS norms and cross attention none
(`qk_rms_norm_cross=False`), so `kv` applies none.
"""

from __future__ import annotations

import torch
from torch import nn

from .misc import dense


class MultiHeadRMSNorm(nn.Module):
    """Per-head RMS norm over the head dim, scaled by gamma * sqrt(dim):
    x * rsqrt(sum(x^2) + 1e-12) * gamma * sqrt(dim). The sublayer kernels
    apply it; this module holds gamma."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(heads, dim))

    def lane_gamma(self) -> torch.Tensor:
        """[heads * dim] = gamma.flatten() * sqrt(dim), as the kernels take it."""
        return self.gamma.reshape(-1) * self.dim ** 0.5


class MultiHeadAttention(nn.Module):
    """Self ("to_qkv", q/k RMS norms) or cross ("to_q", "to_kv") attention
    parameters, and an output projection "to_out"."""

    def __init__(self, channels: int, num_heads: int, attn_type: str = "self"):
        super().__init__()
        if channels % num_heads or attn_type not in ("self", "cross"):
            raise ValueError(f"bad attention config: {channels} channels, "
                             f"{num_heads} heads, {attn_type!r}")
        self.channels = channels
        self.num_heads = num_heads
        self.head_dim = channels // num_heads
        if attn_type == "self":
            self.to_qkv = nn.Linear(channels, 3 * channels)
        else:
            self.to_q = nn.Linear(channels, channels)
            self.to_kv = nn.Linear(channels, 2 * channels)
        self.to_out = nn.Linear(channels, channels)
        if attn_type == "self":
            self.q_rms_norm = MultiHeadRMSNorm(self.head_dim, num_heads)
            self.k_rms_norm = MultiHeadRMSNorm(self.head_dim, num_heads)

    def gammas(self):
        """(q, k) lane gammas of a self attention, as the kernels take them."""
        return self.q_rms_norm.lane_gamma(), self.k_rms_norm.lane_gamma()

    def kv(self, context: torch.Tensor, dtype: torch.dtype):
        """Cross-attention K/V of context [B, Lk, C] -> (k, v), each
        [B, Lk, heads, head_dim]."""
        B, Lk = context.shape[:2]
        kv = dense(context, self.to_kv, dtype).reshape(
            B, Lk, 2, self.num_heads, self.head_dim)
        return kv[:, :, 0].contiguous(), kv[:, :, 1].contiguous()
