"""The DiT block and final layer (port of gvfdiffusion_tpu/nn/transformer.py
:172-290, 379-474, 535-555).

The block always takes the fused four-sublayer structure of the JAX
package's `_fused_call`: spatial self, temporal self, dual cross (against
the hoisted KV cache) and MLP, each one call of ops/fused_sublayer.py.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_sublayer as fsl
from .attention import MultiHeadAttention
from .misc import dense, layer_norm


class FeedForwardNet(nn.Module):
    """Linear -> GELU(tanh) -> Linear (hidden 4C); the block feeds its
    weights to the fused MLP sublayer."""

    def __init__(self, channels: int):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Linear(channels, 4 * channels), nn.GELU(approximate="tanh"),
            nn.Linear(4 * channels, channels))


class ModulatedTransformerCrossBlock(nn.Module):
    """DiT block: spatial self-attn over N, temporal self-attn over T, image
    cross-attn, static-GS cross-attn, MLP, with adaLN-Zero modulation.

    x [B, T, N, C]; mod [B, C] (the timestep embedding); cross_kv =
    ((img_k, img_v), (static_k, static_v)), each [B*T, Lk, heads, head_dim],
    from `kv`. Parameter names follow the reference's torch state dict.
    The self-attentions carry q/k RMS norms, the cross-attentions none (the
    shipped DiT configuration).
    """

    def __init__(self, channels: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = channels
        self.channels = C
        self.num_heads = num_heads
        self.dtype = dtype
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(C, 6 * C))
        self.adaLN_modulation_temporal = nn.Sequential(
            nn.SiLU(), nn.Linear(C, 3 * C))
        self.spatial_self_attn = MultiHeadAttention(C, num_heads, "self",
                                                    qk_rms_norm=True)
        self.temporal_self_attn = MultiHeadAttention(C, num_heads, "self",
                                                     qk_rms_norm=True)
        # norm1/norm2/norm5 are affine-free (no parameters); norm3/norm4 affine
        self.norm3 = nn.LayerNorm(C, eps=1e-6)
        self.image_cross_attn = MultiHeadAttention(C, num_heads, "cross")
        self.norm4 = nn.LayerNorm(C, eps=1e-6)
        self.static_cross_attn = MultiHeadAttention(C, num_heads, "cross")
        self.mlp = FeedForwardNet(C)

    def kv(self, cond_images: torch.Tensor, static_latent: torch.Tensor):
        """The loop-invariant cross-attention KV: cond_images [B, T, L, C],
        static_latent [B, T, Ns, C] (both already projected to C)."""
        C = self.channels
        img = self.image_cross_attn.kv(
            cond_images.reshape(-1, cond_images.shape[2], C), self.dtype)
        static = self.static_cross_attn.kv(
            static_latent.reshape(-1, static_latent.shape[2], C), self.dtype)
        return img, static

    def forward(self, x: torch.Tensor, mod: torch.Tensor, cross_kv,
                impl: Optional[str] = None) -> torch.Tensor:
        C, H, dt = self.channels, self.num_heads, self.dtype
        B, T, N, _ = x.shape

        def w(a):
            return a.to(dt)

        m = dense(F.silu(mod), self.adaLN_modulation[1], dt).chunk(6, dim=-1)
        mt = dense(F.silu(mod), self.adaLN_modulation_temporal[1],
                   dt).chunk(3, dim=-1)
        (sh_s, sc_s, g_s, sh_t, sc_t, g_t, sh_m, sc_m, g_m) = (
            m[:3] + mt + m[3:])

        def self_args(attn: MultiHeadAttention):
            qg, kg = attn.gammas()
            return (w(attn.to_qkv.weight.t()), w(attn.to_qkv.bias), w(qg),
                    w(kg), w(attn.to_out.weight.t()), w(attn.to_out.bias))

        x = fsl.fused_self_sublayer(
            x.reshape(B * T, N, C), w(sh_s), w(sc_s), w(g_s),
            *self_args(self.spatial_self_attn), num_heads=H,
            compute_dtype=dt, mod_repeat=T, impl=impl,
        ).reshape(B, T, N, C)

        x = fsl.fused_temporal_sublayer(
            x, w(sh_t), w(sc_t), w(g_t), *self_args(self.temporal_self_attn),
            num_heads=H, compute_dtype=dt, impl=impl)

        def cross_args(norm: nn.LayerNorm, attn: MultiHeadAttention):
            return (w(norm.weight), w(norm.bias), w(attn.to_q.weight.t()),
                    w(attn.to_q.bias), w(attn.to_out.weight.t()),
                    w(attn.to_out.bias))

        img_kv, static_kv = cross_kv
        x = fsl.fused_cross_sublayer(
            x.reshape(B * T, N, C),
            cross_args(self.norm3, self.image_cross_attn),
            tuple(w(a) for a in img_kv),
            cross_args(self.norm4, self.static_cross_attn),
            tuple(w(a) for a in static_kv),
            num_heads=H, compute_dtype=dt, impl=impl)

        l1, l2 = self.mlp.mlp[0], self.mlp.mlp[2]
        x = fsl.fused_mlp_sublayer(
            x, w(sh_m), w(sc_m), w(g_m), w(l1.weight.t()), w(l1.bias),
            w(l2.weight.t()), w(l2.bias), compute_dtype=dt, mod_repeat=T,
            impl=impl)
        return x.reshape(B, T, N, C)


class FinalLayer(nn.Module):
    """adaLN-modulated output projection (affine-free LayerNorm)."""

    def __init__(self, hidden_size: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size))
        self.linear = nn.Linear(hidden_size, out_channels)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        m = dense(F.silu(c), self.adaLN_modulation[1], self.dtype)
        shift, scale = m.chunk(2, dim=-1)
        # as in JAX: (1 + scale) rounds in the modulation dtype, then
        # promotes against the fp32 LayerNorm output
        h = layer_norm(x, 1e-6) * (1.0 + scale[:, None, None]) \
            + shift[:, None, None]
        return dense(h, self.linear, self.dtype)
