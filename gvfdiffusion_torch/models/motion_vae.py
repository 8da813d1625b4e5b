"""Motion VAE decoder (port of the decode half of
gvfdiffusion_tpu/models/motion_vae.py).

decode: `depth` self-attention blocks over the latent set, then a cross-
attention from the Gaussian queries (gs_embedding + PointEmbed) that gives
an `output_dim`-channel delta per Gaussian per frame. The query cross-
attention runs in chunks of Gaussians, which bounds the [B*T, chunk, dim]
query embedding.

Module and parameter names follow the reference's torch state dict. The
encoder's parameters are held so a full checkpoint loads strictly; the
encoder itself (and its KNN) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.misc import dense, layer_norm


class PointEmbed(nn.Module):
    """Per-axis sinusoidal point embedding, parameter-free:
    [sin(x w), cos(x w), sin(y w), cos(y w), sin(z w), cos(z w)],
    w_i = 10000^(-i / (e/2)), e = hidden_dim // 6."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        e = self.hidden_dim // 3 // 2
        omega = 1.0 / (10000.0 ** (
            torch.arange(e, dtype=torch.float32, device=p.device) / (e / 2.0)))
        ang = p.float()[..., None] * omega  # [..., 3, e]
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return emb.reshape(*p.shape[:-1], -1).to(p.dtype)


class GEGLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gates = x.chunk(2, dim=-1)
        return x * F.gelu(gates)  # exact (erf) gelu


class PerceiverFF(nn.Module):
    def __init__(self, dim: int, mult: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.net = nn.Sequential(nn.Linear(dim, dim * mult * 2), GEGLU(),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        h = self.net[1](dense(x, self.net[0], self.dtype))
        return dense(h, self.net[2], self.dtype)


class PerceiverAttention(nn.Module):
    """Cross/self attention, q/kv bias-free. Uses torch SDPA, as the JAX
    module uses jax.nn.dot_product_attention (no kernel of this repo)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.dtype = dtype
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_kv = nn.Linear(context_dim or query_dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        ctx = x if context is None else context
        B, N, _ = x.shape
        q = dense(x, self.to_q, self.dtype)
        k, v = dense(ctx, self.to_kv, self.dtype).chunk(2, dim=-1)
        heads = lambda a: a.unflatten(-1, (self.heads, self.dim_head)).transpose(1, 2)
        out = F.scaled_dot_product_attention(heads(q), heads(k), heads(v))
        out = out.transpose(1, 2).reshape(B, N, -1)
        return dense(out, self.to_out, self.dtype)


class PreNorm(nn.Module):
    """Affine-free LayerNorm (eps 1e-6) of the input (and of the context,
    when given) in fp32, then `fn`."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, context=None):
        if context is not None:
            context = layer_norm(context, 1e-6)
        return self.fn(layer_norm(x, 1e-6), context=context)


class MotionVAE(nn.Module):
    """Config mirrors the JAX MotionVAE (configs/diffusion.yml:27-39)."""

    def __init__(self, depth: int = 12, dim: int = 768, queries_dim: int = 768,
                 input_dim: int = 3, gs_dim: int = 14, output_dim: int = 14,
                 num_inputs: int = 8192, num_latents: int = 512,
                 latent_dim: int = 16, heads: int = 12, knn_k: int = 8,
                 beta: float = 7.0, remat_decode: bool = False,
                 dtype: torch.dtype = torch.float32):
        """The JAX class's fields in its order; `num_inputs`,
        `num_latents`, `knn_k` and `beta` configure the encoder half and
        `remat_decode` its training, none of them ported: they are
        accepted, so that a JAX configuration builds, and unused."""
        super().__init__()
        if dim % 6:
            raise ValueError(f"MotionVAE dim must be divisible by 6, got {dim}")
        dim_head = dim // heads
        self.dim = dim
        self.dtype = dtype
        self.input_embedding = nn.Sequential(nn.Linear(input_dim, dim))
        self.gs_embedding = nn.Sequential(nn.Linear(gs_dim, dim))
        self.point_embed = PointEmbed(dim)
        self.cross_attend_blocks = nn.ModuleList([
            PreNorm(PerceiverAttention(dim, dim, heads, dim_head, dtype)),
            PreNorm(PerceiverFF(dim, dtype=dtype))])
        self.mean_fc = nn.Linear(dim, latent_dim)
        self.logvar_fc = nn.Linear(dim, latent_dim)
        self.proj = nn.Linear(latent_dim, dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                PreNorm(PerceiverAttention(dim, None, heads, dim_head, dtype)),
                PreNorm(PerceiverFF(dim, dtype=dtype))])
            for _ in range(depth))
        self.decoder_cross_attn = PreNorm(
            PerceiverAttention(queries_dim, dim, heads, dim_head, dtype))
        self.to_outputs = nn.Linear(queries_dim, output_dim)

    def decode(self, z: torch.Tensor, queries: torch.Tensor,
               num_timesteps: int,
               chunk_size: Optional[int] = None) -> torch.Tensor:
        """z [B*T, L, latent_dim]; queries [B, Q, gs_dim] padded static GS
        -> [B, T, Q, output_dim] fp32 per-Gaussian per-frame deltas."""
        T = num_timesteps
        B, Q = queries.shape[:2]
        x = dense(z, self.proj, self.dtype)
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        out = None
        step = chunk_size or Q
        for s in range(0, Q, step):
            qc = queries[:, s:s + step]
            Qc = qc.shape[1]
            q_embed = layer_norm(dense(qc, self.gs_embedding[0], self.dtype),
                                 1e-5) \
                + layer_norm(self.point_embed(qc[..., :3]), 1e-5)
            q_embed = q_embed[:, None].expand(B, T, Qc, self.dim).reshape(
                B * T, Qc, self.dim)
            h = self.decoder_cross_attn(q_embed, context=x)
            o = F.linear(h.float(), self.to_outputs.weight.float(),
                         self.to_outputs.bias.float())
            if out is None:
                out = o.new_empty(B, T, Q, o.shape[-1])
            out[:, :, s:s + Qc] = o.reshape(B, T, Qc, -1)
        return out
