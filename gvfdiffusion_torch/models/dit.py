"""Temporal-aware DiT denoiser for the Gaussian Variation Field latent (port of
gvfdiffusion_tpu/models/dit.py in its shipped configuration: APE positions,
per-block adaLN, spatial + temporal attention with q/k RMS norms, cross
attention without, MLP ratio 4, fused sublayers).

Inputs (reference shapes):
  x              (B, T, N=512, C_in=16)   noisy variation-field latent
  t              (B,)                     diffusion timesteps
  cond_images    (B, T, L, 1024)          DINOv2 video tokens
  static_latent  (B, Ns, 14)              canonical-GS conditioning
  positions      (B, N, 3)                FPS-anchor xyz for the APE
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.embedders import AbsolutePositionEmbedder, TimestepEmbedder
from ..nn.misc import dense
from ..nn.transformer import FinalLayer, ModulatedTransformerCrossBlock


class DiT(nn.Module):
    """`dtype` is the compute dtype (flax's `dtype`): parameters stay as
    stored and are cast at use. The timestep embedder computes in fp32. On
    CUDA the DiT runs the bf16 sublayer kernels, so `dtype` must be bf16."""

    def __init__(self, in_channels: int = 16, model_channels: int = 512,
                 static_cond_channels: int = 14,
                 image_cond_channels: int = 1024, out_channels: int = 16,
                 num_blocks: int = 12, num_heads: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = model_channels
        self.model_channels = C
        self.dtype = dtype
        self.input_layer = nn.Linear(in_channels, C)
        self.t_embedder = TimestepEmbedder(C)
        self.image_cond_proj = nn.Linear(image_cond_channels, C)
        self.static_cond_proj = nn.Linear(static_cond_channels, C)
        self.pos_embedder = AbsolutePositionEmbedder(C)
        self.blocks = nn.ModuleList(
            ModulatedTransformerCrossBlock(C, num_heads, dtype=dtype)
            for _ in range(num_blocks))
        self.final_layer = FinalLayer(C, out_channels, dtype=dtype)

    def _check_device(self, x: torch.Tensor) -> None:
        if x.is_cuda and self.dtype != torch.bfloat16:
            raise TypeError(
                "on CUDA the DiT runs the bf16 sublayer kernels: build it "
                f"with dtype=torch.bfloat16 (got {self.dtype})")

    def kv_cache(self, cond_images: torch.Tensor,
                 static_latent: torch.Tensor):
        """Per-block cross-attention KV (constant across sampler steps):
        a tuple over blocks of ((img_k, img_v), (static_k, static_v))."""
        self._check_device(cond_images)
        T = cond_images.shape[1]
        image_emb = dense(cond_images, self.image_cond_proj, self.dtype)
        static_emb = dense(static_latent, self.static_cond_proj, self.dtype)
        static_emb = static_emb[:, None].expand(
            -1, T, -1, -1)  # broadcast over frames: (B, T, Ns, C)
        return tuple(b.kv(image_emb, static_emb) for b in self.blocks)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond_images: Optional[torch.Tensor] = None,
                static_latent: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None, cross_kv=None,
                kv_only: bool = False, impl: Optional[str] = None):
        """With kv_only=True returns `kv_cache(cond_images, static_latent)`;
        otherwise the predicted output [B, T, N, out_channels] in fp32. A
        given cross_kv replaces cond_images and static_latent.
        `impl="plain"` runs the sublayers' plain torch versions."""
        if kv_only or cross_kv is None:
            cache = self.kv_cache(cond_images, static_latent)
            if kv_only:
                return cache
            cross_kv = cache
        self._check_device(x)
        h = dense(x, self.input_layer, self.dtype)
        t_emb = self.t_embedder(t)
        pe = self.pos_embedder(positions)
        h = h + pe[:, None].to(h.dtype)  # broadcast over T
        for block, kv in zip(self.blocks, cross_kv):
            h = block(h, t_emb, kv, impl=impl)
        return self.final_layer(h, t_emb).float()
