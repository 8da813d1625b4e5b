"""Multi-head attention (port of gvfdiffusion_tpu/nn/attention.py:73-85,
135-254).

`MultiHeadAttention` holds the parameters under the reference's names. The
DiT runs its attention inside the fused sublayer kernels, so for it this
module computes only what the JAX package computes outside any kernel: the
loop-invariant cross-attention K/V (`kv`). Its self-attentions carry q/k
RMS norms (`qk_rms_norm=True`, which the sublayer kernels apply) and its
cross-attentions none, so `kv` applies none. `forward` is the self branch
without RoPE or RMS norm, as DINOv2 runs it: the qkv projection, K5
(ops/fused_attention.py) on its q/k/v views, the output projection.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.fused_attention import fused_attention
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
    """Self ("to_qkv") or cross ("to_q", "to_kv") attention parameters, an
    output projection "to_out", and with `qk_rms_norm` the q/k RMS norms
    (self attention only). A subclass may name the self branch's two
    projections otherwise (`qkv_name`, `out_name`), as DINOv2 keeps the
    torch hub's names."""

    qkv_name = "to_qkv"
    out_name = "to_out"

    def __init__(self, channels: int, num_heads: int, attn_type: str = "self",
                 qk_rms_norm: bool = False):
        super().__init__()
        if (channels % num_heads or attn_type not in ("self", "cross")
                or (qk_rms_norm and attn_type != "self")):
            raise ValueError(f"bad attention config: {channels} channels, "
                             f"{num_heads} heads, {attn_type!r}, "
                             f"qk_rms_norm={qk_rms_norm}")
        self.channels = channels
        self.num_heads = num_heads
        self.head_dim = channels // num_heads
        self.attn_type = attn_type
        self.qk_rms_norm = qk_rms_norm
        if attn_type == "self":
            setattr(self, self.qkv_name, nn.Linear(channels, 3 * channels))
            setattr(self, self.out_name, nn.Linear(channels, channels))
        else:
            self.to_q = nn.Linear(channels, channels)
            self.to_kv = nn.Linear(channels, 2 * channels)
            self.to_out = nn.Linear(channels, channels)
        if qk_rms_norm:
            self.q_rms_norm = MultiHeadRMSNorm(self.head_dim, num_heads)
            self.k_rms_norm = MultiHeadRMSNorm(self.head_dim, num_heads)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                impl: Optional[str] = None) -> torch.Tensor:
        """Self-attention over L of x [B, L, C] -> [B, L, C] in `dtype`
        (flax Dense semantics; K5 computes in `dtype`)."""
        if self.attn_type != "self" or self.qk_rms_norm:
            raise NotImplementedError(
                "only the self branch without q/k RMS norm is ported")
        B, L, C = x.shape
        qkv = dense(x, getattr(self, self.qkv_name), dtype).reshape(
            B, L, 3, self.num_heads, self.head_dim)
        o = fused_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                            self.head_dim ** -0.5, dtype, impl=impl)
        return dense(o.reshape(B, L, C), getattr(self, self.out_name), dtype)

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
