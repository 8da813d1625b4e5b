"""TRELLIS structured-latent Gaussian decoder (port of
gvfdiffusion_tpu/models/trellis/slat_decoders.py:29-113): an input
projection, the absolute position embedding and a stack of swin-windowed
sparse transformer blocks (models/static_vae.py), then 8 Gaussians per
voxel (models/sparse_vae.to_representation).

Parameters go by the reference's names (`input_layer`, `blocks.N.attn`,
`blocks.N.mlp.mlp.{0,2}`, `out_layer`; the JAX package nests the first
two under `torso`). `pe_mode` other than "ape" adds no position
embedding; `qk_rms_norm` is accepted as JAX accepts it and, as there
(`SparseTransformerBase` does not hand it to its blocks), changes nothing.
The encoder and the mesh and radiance-field decoders are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...nn.embedders import AbsolutePositionEmbedder
from ...sparse.ops import SparseLayerNorm, SparseLinear
from ...sparse.tensor import SparseVoxels
from ..sparse_vae import GSConfig, to_representation
from ..static_vae import SparseTransformerBlock, block_attn_config

DECODER_GS_CONFIG = GSConfig(
    num_gaussians=8, voxel_size=1.5, scaling_bias=0.004, opacity_bias=0.1,
    scaling_activation="softplus", filter_3d_kernel_size=9e-4)


class SLatGaussianDecoder(nn.Module):
    """SLat [B, L, latent] -> (GaussianSplat [B, L*8], valid [B, L*8])."""

    def __init__(self, resolution: int = 64, model_channels: int = 768,
                 latent_channels: int = 8, num_blocks: int = 12,
                 num_heads: Optional[int] = None, mlp_ratio: float = 4.0,
                 attn_mode: str = "swin", window_size: int = 8,
                 pe_mode: str = "ape", qk_rms_norm: bool = False,
                 rep_config: GSConfig = DECODER_GS_CONFIG,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = model_channels
        self.resolution, self.rep_config, self.dtype = (
            resolution, rep_config, dtype)
        self.pe_mode, self.qk_rms_norm = pe_mode, qk_rms_norm
        heads = num_heads or C // 64
        self.input_layer = SparseLinear(latent_channels, C)
        self.pos_embedder = AbsolutePositionEmbedder(C)
        self.blocks = nn.ModuleList(
            SparseTransformerBlock(C, heads, mlp_ratio, mode, ws, shift)
            for mode, ws, _, shift, _ in block_attn_config(
                attn_mode, window_size, num_blocks))
        self.out_norm = SparseLayerNorm(C, affine=False)
        self.out_layer = SparseLinear(C, rep_config.out_channels)

    def forward(self, x: SparseVoxels, impl: Optional[str] = None):
        h = self.input_layer(x, self.dtype)
        if self.pe_mode == "ape":
            h = h + self.pos_embedder(x.coords.float()) * x.valid[..., None]
        for block in self.blocks:
            h = block(h, self.dtype, impl=impl)
        h = self.out_layer(self.out_norm(h), torch.float32)
        return to_representation(h, self.rep_config, self.resolution)
