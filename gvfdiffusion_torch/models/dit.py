"""Temporal-aware DiT denoiser for the Gaussian Variation Field latent (port of
gvfdiffusion_tpu/models/dit.py with its configuration fields: `mlp_ratio`,
`pe_mode` ("ape", "rope", "learnable" or "none"), `share_mod`, the q/k RMS
norms on the self (`qk_rms_norm`) and cross (`qk_rms_norm_cross`)
attentions, `no_temporal_attn` and `temporal_layout`; the defaults are the
shipped configuration. JAX's measurement-only `ablate` is not ported).

Inputs (reference shapes):
  x              (B, T, N=512, C_in=16)   noisy variation-field latent
  t              (B,)                     diffusion timesteps
  cond_images    (B, T, L, 1024)          DINOv2 video tokens
  static_latent  (B, Ns, 14)              canonical-GS conditioning
  positions      (B, N, 3)                FPS-anchor xyz for the APE

Two paths, as in JAX: with a hoisted cross-attention KV cache (`cross_kv`,
the sampler's) each block runs the fused sublayer kernels K1-K4, in bf16 on
CUDA, unless its gate closes (RoPE, a shape outside a kernel's rule, or on
CUDA a compute dtype other than bf16; see nn/transformer.py) and it
composes on the cache; without one (the trainer's, and the fp32 DiT's of
the infer CLI at guidance 1.0/1.0) the DiT projects the conditioning itself
and each block runs the composed path (K5, K6, torch elsewhere), in any
dtype, under autograd.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.embedders import AbsolutePositionEmbedder, TimestepEmbedder
from ..nn.misc import dense
from ..nn.transformer import FinalLayer, ModulatedTransformerCrossBlock

# flax's truncated normal draws from N(0, 1) cut at +-2 and rescales by
# this factor, so that the lecun-normal variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def check_quant(name: str, mode: Optional[str]) -> None:
    """An int8 switch of the fused path: None (float) or "int8". `kv_quant`
    stores the KV cache int8; `self_quant` runs the self and temporal
    sublayers' QK products in int8."""
    if mode not in (None, "int8"):
        raise ValueError(f"{name} must be None or 'int8', got {mode!r}")


class DiT(nn.Module):
    """`dtype` is the compute dtype (flax's `dtype`): parameters stay as
    stored and are cast at use. The timestep embedder computes in fp32. On
    CUDA the fused path runs the bf16 sublayer kernels, so only a DiT whose
    `dtype` is bf16 takes it there; another composes on its cache. `remat_blocks` leading blocks are
    recomputed in the backward pass (`torch.utils.checkpoint`, JAX's
    `nn.remat`)."""

    def __init__(self, resolution: int = 512, in_channels: int = 16,
                 model_channels: int = 512, static_cond_channels: int = 14,
                 image_cond_channels: int = 1024, out_channels: int = 16,
                 num_blocks: int = 12, num_heads: int = 16,
                 mlp_ratio: float = 4.0, pe_mode: str = "ape",
                 share_mod: bool = False, qk_rms_norm: bool = True,
                 qk_rms_norm_cross: bool = False,
                 no_temporal_attn: bool = False,
                 temporal_layout: str = "einsum", remat_blocks: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pe_mode not in ("ape", "rope", "learnable", "none"):
            raise ValueError(f"pe_mode must be ape, rope, learnable or none; "
                             f"got {pe_mode!r}")
        C = model_channels
        self.resolution = resolution
        self.model_channels = C
        self.num_blocks = num_blocks
        self.pe_mode = pe_mode
        self.share_mod = share_mod
        self.remat_blocks = remat_blocks
        self.dtype = dtype
        self.input_layer = nn.Linear(in_channels, C)
        self.t_embedder = TimestepEmbedder(C)
        self.image_cond_proj = nn.Linear(image_cond_channels, C)
        self.static_cond_proj = nn.Linear(static_cond_channels, C)
        mod_channels = (6 if no_temporal_attn else 9) * C
        if share_mod:
            self.adaLN_modulation = nn.Sequential(
                nn.SiLU(), nn.Linear(C, mod_channels))
        if pe_mode == "ape":
            self.pos_embedder = AbsolutePositionEmbedder(C)
        elif pe_mode == "learnable":  # flax's `pos_emb`
            self.pos_embedder = nn.Parameter(torch.zeros(1, resolution, C))
        self.blocks = nn.ModuleList(
            ModulatedTransformerCrossBlock(
                C, num_heads, mlp_ratio=mlp_ratio,
                use_rope=pe_mode == "rope", qk_rms_norm=qk_rms_norm,
                qk_rms_norm_cross=qk_rms_norm_cross, share_mod=share_mod,
                no_temporal_attn=no_temporal_attn,
                temporal_layout=temporal_layout, dtype=dtype)
            for _ in range(num_blocks))
        self.final_layer = FinalLayer(
            C, out_channels, dtype=dtype,
            cond_channels=mod_channels if share_mod else C)

    def mem_ratio_to_remat_blocks(self, mem_ratio: float) -> int:
        """The reference's mapping: recompute the first ceil((1 - r) * n) + 1
        blocks (JAX models/dit.py:52-58)."""
        if mem_ratio >= 1.0:
            return 0
        return min(math.ceil((1 - mem_ratio) * self.num_blocks) + 1,
                   self.num_blocks)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> "DiT":
        """Draw the initial parameters from the JAX DiT's flax initializers,
        in place: lecun-normal Dense kernels (a normal cut at +-2 sigma) with
        zero biases, xavier-uniform for `input_layer`, normal(0.02) for the
        timestep MLP and the two conditioning projections, zeros for every
        adaLN modulation and the final layer, ones for RMS gammas and
        LayerNorm scales, normal(1.0) for the learnable position
        embedding. Drawn on the CPU from `generator` (a CPU generator), in
        parameter order, so the values do not depend on the device."""
        normal02 = ("t_embedder.", "image_cond_proj.", "static_cond_proj.")
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                r = torch.zeros(p.shape)
            elif "adaLN_modulation" in name or name.startswith(
                    "final_layer."):
                r = torch.zeros(p.shape)
            elif name.endswith("gamma") or p.ndim == 1:  # RMS and LN scales
                r = torch.ones(p.shape)
            elif name == "pos_embedder":
                r = torch.randn(p.shape, generator=generator)
            elif name.startswith(normal02):
                r = torch.randn(p.shape, generator=generator) * 0.02
            elif name.startswith("input_layer."):
                fan_out, fan_in = p.shape
                lim = math.sqrt(6.0 / (fan_in + fan_out))
                r = (torch.rand(p.shape, generator=generator) * 2 - 1) * lim
            else:  # lecun normal over the Linear's fan-in
                std = p.shape[1] ** -0.5 / _TRUNC_STD
                r = nn.init.trunc_normal_(torch.empty(p.shape), 0.0, 1.0,
                                          -2.0, 2.0, generator=generator)
                r = r * std
            p.copy_(r)
        return self

    def kv_cache(self, cond_images: torch.Tensor,
                 static_latent: torch.Tensor,
                 kv_quant: Optional[str] = None):
        """Per-block cross-attention KV (constant across sampler steps):
        a tuple over blocks of ((img_k, img_v), (static_k, static_v)).
        kv_quant="int8" stores it as int8 with per-(token, head) scales
        (JAX's GVF_KV_QUANT=int8, bench.py's setting), and the blocks then
        run K3's int8 form; None keeps it float."""
        check_quant("kv_quant", kv_quant)
        image_emb, static_emb = self._conditioning(cond_images, static_latent)
        return tuple(b.kv(image_emb, static_emb, quant=kv_quant == "int8")
                     for b in self.blocks)

    def _conditioning(self, cond_images, static_latent):
        """The projected conditioning: image tokens [B, T, L, C] and the
        static latent broadcast over frames, [B, T, Ns, C]."""
        T = cond_images.shape[1]
        image_emb = dense(cond_images, self.image_cond_proj, self.dtype)
        static_emb = dense(static_latent, self.static_cond_proj, self.dtype)
        return image_emb, static_emb[:, None].expand(-1, T, -1, -1)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond_images: Optional[torch.Tensor] = None,
                static_latent: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None, cross_kv=None,
                kv_only: bool = False, impl: Optional[str] = None,
                self_quant: Optional[str] = None):
        """With kv_only=True returns `kv_cache(cond_images, static_latent)`;
        otherwise the predicted output [B, T, N, out_channels] in fp32. A
        given cross_kv replaces cond_images and static_latent and runs the
        fused path where each block's gate allows (else the composed path on
        the cache); without it the composed path runs. `positions` feed the
        APE (pe_mode "ape") and are unread otherwise. `impl="plain"` runs
        the kernels' plain torch versions. self_quant="int8" (JAX's
        GVF_SELF_QUANT=int8) takes the self and temporal sublayers' QK in
        int8 on the fused path; the composed path ignores it, as in JAX."""
        check_quant("self_quant", self_quant)
        if kv_only:
            return self.kv_cache(cond_images, static_latent)
        image_emb = static_emb = None
        if cross_kv is None:
            image_emb, static_emb = self._conditioning(cond_images,
                                                       static_latent)
            cross_kv = (None,) * len(self.blocks)
        h = dense(x, self.input_layer, self.dtype)
        mod = self.t_embedder(t)
        if self.share_mod:  # one modulation for every block (JAX :124-130)
            mod = dense(F.silu(mod), self.adaLN_modulation[1], self.dtype)
        if self.pe_mode == "ape":
            if positions is None:
                raise ValueError("pe_mode 'ape' needs positions")
            pe = self.pos_embedder(positions)
            h = h + pe[:, None].to(h.dtype)  # broadcast over T
        elif self.pe_mode == "learnable":
            h = h + self.pos_embedder[None].to(h.dtype)
        for i, (block, kv) in enumerate(zip(self.blocks, cross_kv)):
            args = (h, mod, kv, image_emb, static_emb, impl, self_quant)
            if i < self.remat_blocks and torch.is_grad_enabled():
                h = checkpoint(block, *args, use_reentrant=False)
            else:
                h = block(*args)
        return self.final_layer(h, mod).float()
