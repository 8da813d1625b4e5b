"""Multi-head attention (port of gvfdiffusion_tpu/nn/attention.py:36-85,
135-254).

`MultiHeadAttention` holds the parameters under the reference's names.
`forward` is the composed self or cross branch: the qkv (self) or the q
and kv (cross) projections, the optional q/k RMS norms, the attention and
the output projection. `temporal` is the `temporal_4d=True` branch: the
same self-attention parameters, attention over axis T of [B, T, N, C]
through K6. RoPE and `temporal_layout="transpose"` are not ported. The
DiT's inference path runs its attention inside the fused sublayer kernels
and takes from this module only the loop-invariant cross-attention K/V
(`kv`); its training path (no hoisted KV) runs `forward` and `temporal`.

`scaled_dot_product_attention` takes the JAX package's dispatch rule
(`ops/fused_attention.supports`: Lq >= 128, 128 <= Lk <= 4096), and
`temporal` the rule `temporal_supports`. On a CUDA tensor a call inside
the rule runs K5 or K6, and a call outside it raises: on the TPU those
shapes take XLA's attention, which has no port yet. On the CPU every call
runs the kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.fused_attention import (fused_attention, supports,
                                  temporal_attention, temporal_supports)
from .misc import dense


def scaled_dot_product_attention(q, k, v, dtype: torch.dtype,
                                 impl: Optional[str] = None,
                                 cross: bool = False) -> torch.Tensor:
    """[B, Lq, H, D] x [B, Lk, H, D] -> [B, Lq, H, D] in q's dtype, the
    attention computing in `dtype`; `cross` names the form for K5's launch
    count."""
    if q.is_cuda and impl != "plain" and not supports(q.shape, k.shape):
        raise NotImplementedError(
            f"attention of q {tuple(q.shape)} over k {tuple(k.shape)} is "
            "outside K5's rule (Lq >= 128, 128 <= Lk <= 4096); the JAX "
            "package's XLA attention for such shapes is not ported")
    return fused_attention(q, k, v, q.shape[-1] ** -0.5, dtype, cross=cross,
                           impl=impl)


class MultiHeadRMSNorm(nn.Module):
    """Per-head RMS norm over the head dim, scaled by gamma * sqrt(dim):
    x * rsqrt(sum(x^2) + 1e-12) * gamma * sqrt(dim), in fp32, returned in
    x's dtype. The DiT's sublayer kernels apply it from `lane_gamma`."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(heads, dim))

    def lane_gamma(self) -> torch.Tensor:
        """[heads * dim] = gamma.flatten() * sqrt(dim), as the kernels take it."""
        return self.gamma.reshape(-1) * self.dim ** 0.5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., heads, dim]."""
        xf = x.float()
        normed = xf * torch.rsqrt(xf.square().sum(-1, keepdim=True) + 1e-12)
        return (normed * self.gamma.float() * self.dim ** 0.5).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Self ("to_qkv") or cross ("to_q", "to_kv") attention parameters, an
    output projection "to_out", and with `qk_rms_norm` the q/k RMS norms.
    A subclass may name the self branch's two projections otherwise
    (`qkv_name`, `out_name`), as DINOv2 keeps the torch hub's names."""

    qkv_name = "to_qkv"
    out_name = "to_out"

    def __init__(self, channels: int, num_heads: int, attn_type: str = "self",
                 qk_rms_norm: bool = False, ctx_channels: Optional[int] = None):
        super().__init__()
        if channels % num_heads or attn_type not in ("self", "cross"):
            raise ValueError(f"bad attention config: {channels} channels, "
                             f"{num_heads} heads, {attn_type!r}")
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
            self.to_kv = nn.Linear(ctx_channels or channels, 2 * channels)
            self.to_out = nn.Linear(channels, channels)
        if qk_rms_norm:
            self.q_rms_norm = MultiHeadRMSNorm(self.head_dim, num_heads)
            self.k_rms_norm = MultiHeadRMSNorm(self.head_dim, num_heads)

    def project(self, x: torch.Tensor, dtype: torch.dtype,
                context: Optional[torch.Tensor] = None):
        """q [B, L, H, D] and k, v [B, Lk, H, D] in `dtype`, RMS-normed when
        the module has the norms; without them, views of the projections."""
        B, L, _ = x.shape
        H, D = self.num_heads, self.head_dim
        if self.attn_type == "self":
            qkv = dense(x, getattr(self, self.qkv_name), dtype).reshape(
                B, L, 3, H, D)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            if context is None:
                raise ValueError("cross attention requires context")
            q = dense(x, self.to_q, dtype).reshape(B, L, H, D)
            kv = dense(context, self.to_kv, dtype).reshape(
                B, context.shape[1], 2, H, D)
            k, v = kv[:, :, 0], kv[:, :, 1]
        if self.qk_rms_norm:
            # the normed q/k are new tensors; v joins k's strides, as K5
            # reads k and v on shared strides
            q, k, v = self.q_rms_norm(q), self.k_rms_norm(k), v.contiguous()
        return q, k, v

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                context: Optional[torch.Tensor] = None,
                impl: Optional[str] = None,
                attn_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x [B, L, C] (and context [B, Lk, C_ctx] for cross) -> [B, L, C]
        in `dtype` (flax Dense semantics); the attention computes in
        `attn_dtype`, by default `dtype`."""
        B, L, C = x.shape
        q, k, v = self.project(x, dtype, context)
        o = scaled_dot_product_attention(q, k, v, attn_dtype or dtype,
                                         impl=impl,
                                         cross=self.attn_type == "cross")
        return dense(o.reshape(B, L, C), getattr(self, self.out_name), dtype)

    def temporal(self, x: torch.Tensor, dtype: torch.dtype,
                 impl: Optional[str] = None) -> torch.Tensor:
        """The `temporal_4d` branch of a self attention: x [B, T, N, C] ->
        [B, T, N, C] in `dtype`, attention over T for each (b, n, head)
        through K6 in the native layout (no transposes), computing in bf16
        (the JAX kernel's default)."""
        if self.attn_type != "self":
            raise ValueError("temporal attention is a self attention")
        B, T, N, C = x.shape
        H, D = self.num_heads, self.head_dim
        qkv = dense(x, getattr(self, self.qkv_name), dtype).reshape(
            B, T, N, 3, H, D)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        if self.qk_rms_norm:
            q, k = self.q_rms_norm(q), self.k_rms_norm(k)
        if q.is_cuda and impl != "plain" and not temporal_supports(q.shape):
            raise NotImplementedError(
                f"temporal attention of {tuple(q.shape)} is outside K6's "
                "rule; the JAX package's einsum form is not ported")
        o = temporal_attention(q, k, v, D ** -0.5, impl=impl)
        return dense(o.reshape(B, T, N, C), getattr(self, self.out_name),
                     dtype)

    def gammas(self):
        """(q, k) lane gammas of a self attention, as the kernels take them."""
        return self.q_rms_norm.lane_gamma(), self.k_rms_norm.lane_gamma()

    def kv(self, context: torch.Tensor, dtype: torch.dtype):
        """Cross-attention K/V of context [B, Lk, C] -> (k, v), each
        [B, Lk, heads, head_dim] (the DiT's cache: its cross-attentions
        carry no RMS norm)."""
        B, Lk = context.shape[:2]
        kv = dense(context, self.to_kv, dtype).reshape(
            B, Lk, 2, self.num_heads, self.head_dim)
        return kv[:, :, 0].contiguous(), kv[:, :, 1].contiguous()
