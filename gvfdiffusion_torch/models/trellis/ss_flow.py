"""TRELLIS sparse-structure flow DiT (port of
gvfdiffusion_tpu/models/trellis/ss_flow.py:21-101): a dense rectified-flow
transformer on the patchified 16^3 latent grid, cross-attending to the
DINOv2 image tokens through `nn/transformer.ModulatedCrossBlock`.

The public layout is the JAX package's, channels last: x [B, R, R, R, C].
The patch tokens pack their features in the reference's order,
channel * p^3 + offset (the JAX package packs offset * C + channel and
permutes the two projections in `convert_ss_flow`), so a reference state
dict loads as it is. `pe_mode="ape"` adds the fixed sinusoidal table over
the patch grid; "rope" rotates each self-attention's q/k over the token
index instead (JAX's `use_rope`, positions arange(L)); `share_mod`
computes one modulation at the top (`adaLN_modulation`) that every block
splits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.embedders import AbsolutePositionEmbedder, TimestepEmbedder
from ...nn.misc import dense, layer_norm
from ...nn.transformer import ModulatedCrossBlock


def patchify_3d(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, R, R, R, C] -> [B, (R/p)^3, C*p^3], features c * p^3 + offset."""
    b, r, _, _, c = x.shape
    n = r // p
    x = x.reshape(b, n, p, n, p, n, p, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, n ** 3, c * p ** 3)


def unpatchify_3d(x: torch.Tensor, p: int, r: int) -> torch.Tensor:
    """[B, (R/p)^3, C*p^3] -> [B, R, R, R, C] (the inverse of patchify_3d)."""
    b = x.shape[0]
    n = r // p
    c = x.shape[2] // p ** 3
    x = x.reshape(b, n, n, n, c, p, p, p).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, r, r, r, c)


class SparseStructureFlowModel(nn.Module):
    def __init__(self, resolution: int = 16, in_channels: int = 8,
                 model_channels: int = 1024, cond_channels: int = 1024,
                 out_channels: int = 8, num_blocks: int = 24,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 patch_size: int = 2, pe_mode: str = "ape",
                 share_mod: bool = False, qk_rms_norm: bool = False,
                 qk_rms_norm_cross: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        C, p = model_channels, patch_size
        self.resolution, self.patch_size = resolution, p
        self.in_channels = in_channels
        self.pe_mode, self.share_mod = pe_mode, share_mod
        self.dtype = dtype
        self.input_layer = nn.Linear(in_channels * p ** 3, C)
        self.t_embedder = TimestepEmbedder(C)
        if share_mod:
            self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                                  nn.Linear(C, 6 * C))
        self.pos_embedder = AbsolutePositionEmbedder(C)
        self.blocks = nn.ModuleList(
            ModulatedCrossBlock(C, num_heads, mlp_ratio, qk_rms_norm,
                                qk_rms_norm_cross, cond_channels, dtype,
                                use_rope=pe_mode == "rope",
                                share_mod=share_mod)
            for _ in range(num_blocks))
        self.out_layer = nn.Linear(C, out_channels * p ** 3)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                impl: Optional[str] = None) -> torch.Tensor:
        """x [B, R, R, R, C_in]; t [B]; cond [B, Lc, cond_channels] ->
        velocity [B, R, R, R, C_out] fp32."""
        p, n = self.patch_size, self.resolution // self.patch_size
        h = dense(patchify_3d(x, p), self.input_layer, self.dtype)
        if self.pe_mode == "ape":
            g = torch.arange(n, device=x.device)
            coords = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                                 -1).reshape(-1, 3)
            h = h + self.pos_embedder(coords.float())[None].to(h.dtype)
        t_emb = self.t_embedder(t)
        mod = t_emb if not self.share_mod else dense(
            F.silu(t_emb), self.adaLN_modulation[1], self.dtype)
        for block in self.blocks:
            h = block(h, mod, cond, impl=impl)
        h = dense(layer_norm(h, 1e-5), self.out_layer, torch.float32)
        return unpatchify_3d(h, p, self.resolution)
