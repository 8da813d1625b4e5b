"""Multi-head attention (port of gvfdiffusion_tpu/nn/attention.py:36-254).

`MultiHeadAttention` holds the parameters under the reference's names.
`forward` is the composed self or cross branch: the qkv (self) or the q
and kv (cross) projections, RoPE on the self branch's q/k (`use_rope`),
the optional q/k RMS norms, the attention and the output projection; a
cross branch takes its K/V either from `context` or hoisted (`context_kv`,
from `kv`, whose k carries the k norm already). `temporal` is the
`temporal_4d=True` branch: the same self-attention parameters, attention
over axis T of [B, T, N, C]. The DiT's fused inference path runs its
attention inside the fused sublayer kernels and takes from this module
only the loop-invariant cross-attention K/V (`kv`); its composed path runs
`forward` and `temporal`.

`scaled_dot_product_attention` takes the JAX package's dispatch: calls
inside K5's rule (`ops/fused_attention.supports`: Lq >= 128, 128 <= Lk <=
4096) and without a mask run K5; others take XLA's attention in JAX and
`F.scaled_dot_product_attention` here, in q's dtype. On the card K5
computes in bf16 from inputs of any dtype, as JAX calls it on its chip
(`fused_attention`'s default compute dtype, whatever the model's dtype);
on the CPU it computes in the caller's dtype, as JAX's
`jax.nn.dot_product_attention` runs off the chip in the inputs' dtype.
`temporal` runs K6 inside its rule (`temporal_supports`) and JAX's einsum
form outside it.
Those two library calls are the counterparts of XLA code, not of a Pallas
kernel. On the CPU, K5 and K6 run their plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_attention import (fused_attention, supports,
                                  temporal_attention, temporal_supports)
from .misc import dense


def scaled_dot_product_attention(q, k, v, dtype: torch.dtype,
                                 impl: Optional[str] = None,
                                 cross: bool = False,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """[B, Lq, H, D] x [B, Lk, H, D] -> [B, Lq, H, D] in q's dtype. Inside
    K5's rule and without a mask, K5 computing in bf16 on the card and in
    `dtype` on the CPU (`cross` names the form for its launch count);
    otherwise softmax attention in q's dtype, `mask` [B, H, Lq, Lk] (or
    broadcastable; True attends)."""
    if mask is None and supports(q.shape, k.shape):
        return fused_attention(q, k, v, q.shape[-1] ** -0.5,
                               kernel_compute_dtype(q, dtype), cross=cross,
                               impl=impl)
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask)
    return o.transpose(1, 2).contiguous()


def kernel_compute_dtype(q: torch.Tensor, dtype: torch.dtype) -> torch.dtype:
    """K5's compute dtype for a call of a model computing in `dtype`: bf16
    on the card (JAX calls K5 with its default bf16 there, whatever the
    model's dtype), `dtype` on the CPU (JAX's attention off its chip runs in
    the inputs' dtype)."""
    return torch.bfloat16 if q.is_cuda else dtype


def temporal_einsum_attention(q, k, v, scale: float) -> torch.Tensor:
    """JAX's temporal form outside K6's rule (nn/attention.py:193-200):
    q, k, v [B, T, N, H, D]; scores in fp32, the softmax weights rounded to
    v's dtype for the product with v."""
    s = torch.einsum("btnhd,bsnhd->bnhts", q.float(), k.float()) * scale
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bnhts,bsnhd->btnhd", w, v)


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


class RotaryPositionEmbedder(nn.Module):
    """RoPE over (up to 3-D) positions, applied per head (a copy of JAX's
    nn/attention.py:88-135). The phases take freq_dim = head_dim //
    in_channels // 2 frequencies per position channel, zero-padded to
    head_dim // 2, so that every head rotates the same way; the pairs past
    the phases do not rotate. The JAX docstring explains why this differs
    from the reference, which broadcasts for a single head only.
    Parameter-free."""

    def __init__(self, head_dim: int, in_channels: int = 3):
        super().__init__()
        self.head_dim = head_dim
        self.in_channels = in_channels

    def _phases(self, indices: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        freq_dim = self.head_dim // self.in_channels // 2
        freqs = 1.0 / (10000.0 ** (
            torch.arange(freq_dim, dtype=torch.float32, device=indices.device)
            / freq_dim))
        ang = indices.float()[..., None] * freqs  # [..., D, freq_dim]
        ang = ang.reshape(*indices.shape[:-1], -1)  # [..., D * freq_dim]
        pad = self.head_dim // 2 - ang.shape[-1]
        if pad > 0:
            ang = F.pad(ang, (0, pad))
        return torch.cos(ang), torch.sin(ang)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                indices: Optional[torch.Tensor] = None):
        """q, k [B, L, H, D]; indices [B, L, in_channels] positions, by
        default arange(L) in one channel."""
        if indices is None:
            idx = torch.arange(q.shape[1], dtype=torch.float32,
                               device=q.device)[None, :, None]
            indices = idx.expand(q.shape[0], q.shape[1], 1)
        cos, sin = (a[:, :, None, :] for a in self._phases(indices))

        def rot(x):
            xf = x.float()
            x_even, x_odd = xf[..., 0::2], xf[..., 1::2]
            out = torch.stack([x_even * cos - x_odd * sin,
                               x_even * sin + x_odd * cos], dim=-1)
            return out.reshape(x.shape).to(x.dtype)

        return rot(q), rot(k)


class MultiHeadAttention(nn.Module):
    """Self ("to_qkv") or cross ("to_q", "to_kv") attention parameters, an
    output projection "to_out", and with `qk_rms_norm` the q/k RMS norms;
    `use_rope` rotates a self attention's q and k (before the norms). A
    subclass may name the self branch's two projections otherwise
    (`qkv_name`, `out_name`), as DINOv2 keeps the torch hub's names."""

    qkv_name = "to_qkv"
    out_name = "to_out"

    def __init__(self, channels: int, num_heads: int, attn_type: str = "self",
                 qk_rms_norm: bool = False, ctx_channels: Optional[int] = None,
                 use_rope: bool = False):
        super().__init__()
        if channels % num_heads or attn_type not in ("self", "cross"):
            raise ValueError(f"bad attention config: {channels} channels, "
                             f"{num_heads} heads, {attn_type!r}")
        if use_rope and attn_type != "self":
            raise ValueError("RoPE applies to self attention")
        self.channels = channels
        self.num_heads = num_heads
        self.head_dim = channels // num_heads
        self.attn_type = attn_type
        self.qk_rms_norm = qk_rms_norm
        self.use_rope = use_rope
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
        if use_rope:
            self.rope = RotaryPositionEmbedder(self.head_dim)

    def project(self, x: torch.Tensor, dtype: torch.dtype,
                context: Optional[torch.Tensor] = None, context_kv=None,
                indices: Optional[torch.Tensor] = None):
        """q [B, L, H, D] and k, v [B, Lk, H, D] in `dtype`, rotated and
        RMS-normed as the module says; without either, views of the
        projections. A cross attention takes (k, v) from `context_kv` when
        given (k normed already), else projects `context`."""
        B, L, _ = x.shape
        H, D = self.num_heads, self.head_dim
        if self.attn_type == "self":
            qkv = dense(x, getattr(self, self.qkv_name), dtype).reshape(
                B, L, 3, H, D)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if self.use_rope:
                q, k = self.rope(q, k, indices)
            if self.qk_rms_norm:
                q, k = self.q_rms_norm(q), self.k_rms_norm(k)
            if self.use_rope or self.qk_rms_norm:
                # k is a new tensor; v joins its strides, as K5 reads k and
                # v on shared strides
                v = v.contiguous()
            return q, k, v
        q = dense(x, self.to_q, dtype).reshape(B, L, H, D)
        if self.qk_rms_norm:
            q = self.q_rms_norm(q)
        if context_kv is not None:
            k, v = context_kv
        elif context is None:
            raise ValueError("cross attention requires context")
        else:
            k, v = self._project_kv(context, dtype)
        return q, k, v

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                context: Optional[torch.Tensor] = None,
                impl: Optional[str] = None,
                attn_dtype: Optional[torch.dtype] = None, context_kv=None,
                indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, L, C] (and for cross either context [B, Lk, C_ctx] or the
        hoisted context_kv, each [B, Lk, H, D]) -> [B, L, C] in `dtype`
        (flax Dense semantics); K5 computes in bf16 on the card and on the
        CPU in `attn_dtype`, by default `dtype`. `indices` [B, L, 3]: RoPE
        positions (default arange(L))."""
        B, L, C = x.shape
        q, k, v = self.project(x, dtype, context, context_kv, indices)
        o = scaled_dot_product_attention(q, k, v, attn_dtype or dtype,
                                         impl=impl,
                                         cross=self.attn_type == "cross")
        return dense(o.reshape(B, L, C), getattr(self, self.out_name), dtype)

    def temporal(self, x: torch.Tensor, dtype: torch.dtype,
                 impl: Optional[str] = None) -> torch.Tensor:
        """The `temporal_4d` branch of a self attention: x [B, T, N, C] ->
        [B, T, N, C] in `dtype`, attention over T for each (b, n, head) in
        the native layout (no transposes): K6, computing in bf16 (the JAX
        kernel's default), or outside its rule JAX's einsum form."""
        if self.attn_type != "self" or self.use_rope:
            raise ValueError("temporal attention is a self attention "
                             "without RoPE")
        B, T, N, C = x.shape
        H, D = self.num_heads, self.head_dim
        qkv = dense(x, getattr(self, self.qkv_name), dtype).reshape(
            B, T, N, 3, H, D)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        if self.qk_rms_norm:
            q, k = self.q_rms_norm(q), self.k_rms_norm(k)
        if temporal_supports(q.shape):
            o = temporal_attention(q, k, v, D ** -0.5, impl=impl)
        else:
            o = temporal_einsum_attention(q, k, v, D ** -0.5)
        return dense(o.reshape(B, T, N, C), getattr(self, self.out_name),
                     dtype)

    def gammas(self):
        """(q, k) lane gammas of a self attention, as the kernels take them."""
        return self.q_rms_norm.lane_gamma(), self.k_rms_norm.lane_gamma()

    def _project_kv(self, context: torch.Tensor, dtype: torch.dtype):
        """(k, v) of context [B, Lk, C_ctx], each [B, Lk, heads, head_dim]
        on shared strides (views of the projection, or with the norm the
        normed k and a copy of v), k RMS-normed when the module has the
        norms."""
        B, Lk = context.shape[:2]
        kv = dense(context, self.to_kv, dtype).reshape(
            B, Lk, 2, self.num_heads, self.head_dim)
        k, v = kv[:, :, 0], kv[:, :, 1]
        if self.qk_rms_norm:
            k, v = self.k_rms_norm(k), v.contiguous()
        return k, v

    def kv(self, context: torch.Tensor, dtype: torch.dtype):
        """The hoisted cross-attention K/V of context [B, Lk, C_ctx] (JAX's
        kv_only branch): contiguous (k, v), each [B, Lk, heads, head_dim],
        k RMS-normed when the module has the norms."""
        return tuple(a.contiguous() for a in self._project_kv(context, dtype))
