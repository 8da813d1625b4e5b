"""Motion VAE (port of gvfdiffusion_tpu/models/motion_vae.py).

encode: `num_latents` anchor Gaussians by farthest-point sampling of the
canonical Gaussians, the point cloud's motion deltas KNN-interpolated
onto them, a cross-attention from the anchors to the whole delta cloud,
and a diagonal Gaussian posterior per frame. decode: `depth`
self-attention blocks over the latent set, then a cross-attention from
the Gaussian queries (gs_embedding + PointEmbed) that gives an
`output_dim`-channel delta per Gaussian per frame; the query
cross-attention can run in chunks of Gaussians, which bounds the [B*T,
chunk, dim] query embedding. Random draws take an explicit
torch.Generator (or the noise itself).

Module and parameter names follow the reference's torch state dict.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.misc import dense, layer_norm
from ..ops.fps import fps_masked
from ..ops.knn import interpolate_deltas

# flax's truncated normal draws from N(0, 1) cut at +-2 and rescales by
# this factor, so that the lecun-normal variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


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
        """The JAX class's fields in its order; `num_inputs` and
        `remat_decode`, which the JAX module reads nowhere, are accepted so
        that a JAX configuration builds, and unused."""
        super().__init__()
        if dim % 6:
            raise ValueError(f"MotionVAE dim must be divisible by 6, got {dim}")
        dim_head = dim // heads
        self.dim = dim
        self.num_latents, self.knn_k, self.beta = num_latents, knn_k, beta
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

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> "MotionVAE":
        """Draw the initial parameters from the JAX module's flax
        initializers, in place: normal(0.02) cut at +-2 sigma for the two
        embeddings, mean_fc, logvar_fc and proj, lecun normal for the
        attention and feed-forward layers, zeros for every bias and for
        `to_outputs`. Drawn on the CPU from `generator`, in parameter
        order."""
        normal02 = ("input_embedding.", "gs_embedding.", "mean_fc.",
                    "logvar_fc.", "proj.")
        for name, p in self.named_parameters():
            if name.endswith("bias") or name.startswith("to_outputs."):
                p.zero_()
                continue
            r = nn.init.trunc_normal_(torch.empty(p.shape), 0.0, 1.0, -2.0,
                                      2.0, generator=generator)
            p.copy_(r * (0.02 if name.startswith(normal02)
                         else p.shape[1] ** -0.5 / _TRUNC_STD))
        return self

    def _embed_points(self, p: torch.Tensor) -> torch.Tensor:
        return layer_norm(self.point_embed(p), 1e-5)

    def _embed_deltas(self, d: torch.Tensor) -> torch.Tensor:
        return layer_norm(dense(d, self.input_embedding[0], self.dtype), 1e-5)

    def sample_anchors(self, static_gs: torch.Tensor, valid: torch.Tensor):
        """`num_latents` anchors of the padded static Gaussians [B, G, 14]
        by farthest-point sampling of their positions -> (sampled [B, L,
        14], idx [B, L]); the gather carries the gradient, the sampling
        none."""
        idx = fps_masked(static_gs[..., :3].detach(), valid,
                         self.num_latents)
        sampled = torch.gather(
            static_gs, 1, idx[..., None].expand(-1, -1, static_gs.shape[-1]))
        return sampled, idx

    def encode(self, static_pc: torch.Tensor, delta_pc: torch.Tensor,
               static_gs: torch.Tensor, gs_valid: torch.Tensor):
        """static_pc [B, N, 3], delta_pc [B, T, N, 3], static_gs [B, G,
        14], gs_valid [B, G] -> (kl [B*T], mean, logvar [B*T, L, latent],
        sampled_gs [B, L, 14])."""
        B, T = delta_pc.shape[:2]
        L = self.num_latents
        sampled_gs, _ = self.sample_anchors(static_gs, gs_valid)
        anchors = sampled_gs[..., :3]
        est = interpolate_deltas(anchors, static_pc, delta_pc, k=self.knn_k,
                                 beta=self.beta)
        q = (self._embed_deltas(est)
             + self._embed_points(anchors)[:, None]).reshape(B * T, L, -1)
        ctx = (self._embed_deltas(delta_pc)
               + self._embed_points(static_pc)[:, None]).reshape(
                   B * T, static_pc.shape[1], -1)
        attn, ff = self.cross_attend_blocks
        x = attn(q, context=ctx) + q
        x = ff(x) + x
        mean = dense(x, self.mean_fc, torch.float32)
        logvar = torch.clamp(dense(x, self.logvar_fc, torch.float32),
                             -30.0, 20.0)
        kl = 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar).mean((1, 2))
        return kl, mean, logvar, sampled_gs

    @staticmethod
    def reparameterize(mean: torch.Tensor, logvar: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + exp(logvar / 2) * noise, the noise given or drawn from
        `generator`."""
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(0.5 * logvar) * noise

    def forward(self, static_gs: torch.Tensor, gs_valid: torch.Tensor,
                static_pc: torch.Tensor, delta_pc: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """encode -> sample -> decode: dict(logits [B, T, G, output_dim],
        kl [B*T], mean, logvar)."""
        T = delta_pc.shape[1]
        kl, mean, logvar, _ = self.encode(static_pc, delta_pc, static_gs,
                                          gs_valid)
        z = self.reparameterize(mean, logvar, generator, noise)
        return {"logits": self.decode(z, static_gs, T), "kl": kl,
                "mean": mean, "logvar": logvar}

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


def pad_static_gs(gs_list, pad_to: Optional[int] = None):
    """A list of [Gi, 14] arrays -> ([B, G, 14] fp32, valid [B, G] bool) on
    the CPU; padding rows carry the rotation w = 1 (column 10), so they
    stay unit quaternions."""
    import numpy as np

    max_len = pad_to or max(g.shape[0] for g in gs_list)
    out = np.zeros((len(gs_list), max_len, gs_list[0].shape[1]), np.float32)
    out[:, :, 10] = 1.0
    valid = np.zeros((len(gs_list), max_len), bool)
    for i, g in enumerate(gs_list):
        out[i, :g.shape[0]] = np.asarray(g)
        valid[i, :g.shape[0]] = True
    return torch.from_numpy(out), torch.from_numpy(valid)
