"""The static (canonical Gaussian) VAE (port of
gvfdiffusion_tpu/models/static_vae.py): the per-block attention schedule,
the feed-forward net, the un-modulated pre-norm block (which the SLat
Gaussian decoder's torso stacks too) and `SparseTransformerVAE`, a sparse
transformer encoder and decoder over 64^3 voxels with the absolute
position embedding, a zero-init latent head and Gaussian head, and an
optional output layer norm. The modulated block and the serialized
attention modes (`shift_window`, `shift_sequence`, `shift_order`) are not
ported: building them raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.embedders import AbsolutePositionEmbedder
from ..sparse.attention import SparseMultiHeadAttention
from ..sparse.ops import SparseLayerNorm, SparseLinear
from ..sparse.tensor import SparseVoxels

# the 4 rotating serialize modes (reference serialized_attn.py:23)
SERIALIZE_MODES = (
    ("z_order", (0, 1, 2)),
    ("z_order", (2, 0, 1)),
    ("hilbert", (0, 1, 2)),
    ("hilbert", (2, 0, 1)),
)


def block_attn_config(attn_mode: str, window_size: int, num_blocks: int):
    """Per-block attention schedule: yields (mode, window_size, seq_shift,
    shift_window, (curve, permute)). "swin" alternates the window shift
    between (0, 0, 0) and half a window."""
    for i in range(num_blocks):
        if attn_mode == "shift_window":
            yield ("serialized", window_size, 0, (16 * (i % 2),) * 3,
                   SERIALIZE_MODES[0])
        elif attn_mode == "shift_sequence":
            yield ("serialized", window_size, window_size // 2 * (i % 2),
                   (0, 0, 0), SERIALIZE_MODES[0])
        elif attn_mode == "shift_order":
            yield ("serialized", window_size, 0, (0, 0, 0),
                   SERIALIZE_MODES[i % 4])
        elif attn_mode == "full":
            yield ("full", None, 0, (0, 0, 0), SERIALIZE_MODES[0])
        elif attn_mode == "swin":
            yield ("windowed", window_size, 0,
                   (window_size // 2 * (i % 2),) * 3, SERIALIZE_MODES[0])
        else:
            raise ValueError(attn_mode)


class SparseFeedForward(nn.Module):
    """SparseLinear -> GELU(tanh) -> SparseLinear, as `mlp.mlp.{0,2}`."""

    def __init__(self, channels: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(channels * mlp_ratio)
        self.mlp = nn.Sequential(SparseLinear(channels, hidden),
                                 nn.GELU(approximate="tanh"),
                                 SparseLinear(hidden, channels))

    def forward(self, x: SparseVoxels, dtype: torch.dtype) -> SparseVoxels:
        h = self.mlp[0](x, dtype).map_feats(
            lambda f: F.gelu(f, approximate="tanh"))
        return self.mlp[2](h, dtype)


class SparseTransformerBlock(nn.Module):
    """Pre-norm sparse block without modulation: x + attn(norm1(x)), then
    x + mlp(norm2(x)); norm1 and norm2 are affine-free."""

    def __init__(self, channels: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_mode: str = "windowed", window_size: Optional[int] = None,
                 shift_window: Tuple[int, int, int] = (0, 0, 0)):
        super().__init__()
        self.attn = SparseMultiHeadAttention(
            channels, num_heads, attn_mode=attn_mode, window_size=window_size,
            shift_window=shift_window)
        self.norm1 = SparseLayerNorm(channels, affine=False)
        self.norm2 = SparseLayerNorm(channels, affine=False)
        self.mlp = SparseFeedForward(channels, mlp_ratio)

    def forward(self, x: SparseVoxels, dtype: torch.dtype,
                impl: Optional[str] = None) -> SparseVoxels:
        x = x + self.attn(self.norm1(x), dtype, impl=impl).feats
        return x + self.mlp(self.norm2(x), dtype).feats


# flax's truncated normal draws from N(0, 1) cut at +-2 and rescales by
# this factor, so that the lecun-normal variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class SparseTransformerVAE(nn.Module):
    """The JAX class's fields in its order. Parameters under the
    reference's names (`input_layer`, `encoder.{i}`, `to_latent`,
    `from_latent`, `decoder.{i}`, `out_layer`); the first `remat_blocks`
    blocks of the encoder and of the decoder are recomputed in the
    backward pass (`torch.utils.checkpoint`, JAX's `nn.remat`). `impl`
    reaches the blocks' attention (None: the kernels on the card;
    "plain")."""

    def __init__(self, resolution: int = 64, in_channels: int = 1024,
                 model_channels: int = 768, out_channels: int = 112,
                 latent_channels: int = 8, num_blocks: int = 12,
                 window_size: int = 8, num_heads: Optional[int] = None,
                 mlp_ratio: float = 4.0, attn_mode: str = "swin",
                 pe_mode: str = "ape", norm_output: bool = True,
                 remat_blocks: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if pe_mode not in ("ape", "none"):
            raise ValueError(f"pe_mode {pe_mode!r}")
        self.resolution, self.latent_channels = resolution, latent_channels
        self.pe_mode, self.norm_output = pe_mode, norm_output
        self.remat_blocks, self.dtype = remat_blocks, dtype
        heads = num_heads or model_channels // 64
        cfgs = list(block_attn_config(attn_mode, window_size, num_blocks))

        def blocks():
            return nn.ModuleList(
                SparseTransformerBlock(model_channels, heads, mlp_ratio,
                                       attn_mode=mode, window_size=ws,
                                       shift_window=shift)
                for mode, ws, _, shift, _ in cfgs)

        if pe_mode == "ape":
            self.pos_embedder = AbsolutePositionEmbedder(model_channels)
        self.input_layer = SparseLinear(in_channels, model_channels)
        self.encoder = blocks()
        self.to_latent = SparseLinear(model_channels, 2 * latent_channels)
        self.from_latent = SparseLinear(latent_channels, model_channels)
        self.decoder = blocks()
        self.out_layer = SparseLinear(model_channels, out_channels)
        self.norm = SparseLayerNorm(model_channels, affine=False)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator
                      ) -> "SparseTransformerVAE":
        """Draw the initial parameters from the JAX class's flax
        initializers, in place: lecun-normal Dense kernels (a normal cut at
        +-2 sigma) with zero biases, zeros for `to_latent` and `out_layer`.
        Drawn on the CPU from `generator`, in parameter order."""
        for name, p in self.named_parameters():
            if name.endswith("bias") or name.startswith(("to_latent.",
                                                         "out_layer.")):
                r = torch.zeros(p.shape)
            else:
                r = nn.init.trunc_normal_(torch.empty(p.shape), 0.0, 1.0,
                                          -2.0, 2.0, generator=generator)
                r = r * (p.shape[1] ** -0.5 / _TRUNC_STD)
            p.copy_(r)
        return self

    def mem_ratio_to_remat_blocks(self, mem_ratio: float) -> int:
        """The DiT's mapping from the reference's memory ratio (its
        model/dit.py:429-442) over this VAE's blocks: recompute the first
        ceil((1 - r) * n) + 1 blocks of the encoder and of the decoder,
        for utils/elastic.LinearMemoryController."""
        n = len(self.encoder)
        if mem_ratio >= 1.0:
            return 0
        return min(math.ceil((1 - mem_ratio) * n) + 1, n)

    def _ape(self, x: SparseVoxels) -> torch.Tensor:
        return self.pos_embedder(x.coords.float()) * x.valid[..., None]

    def _blocks(self, blocks: nn.ModuleList, h: SparseVoxels,
                impl: Optional[str]) -> SparseVoxels:
        for i, block in enumerate(blocks):
            if i < self.remat_blocks and torch.is_grad_enabled():
                feats = checkpoint(
                    lambda f, b=block, x=h: b(x.replace(feats=f), self.dtype,
                                              impl).feats,
                    h.feats, use_reentrant=False)
                h = h.replace(feats=feats)
            else:
                h = block(h, self.dtype, impl)
        return h

    def encode(self, x: SparseVoxels, sample_posterior: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               impl: Optional[str] = None):
        """-> (z: SparseVoxels, mean, logvar [B, L, latent]). With
        `sample_posterior`, z = mean + exp(logvar / 2) * noise, the noise
        given or drawn from `generator`."""
        h = self.input_layer(x, self.dtype)
        if self.pe_mode == "ape":
            h = h + self._ape(x)
        h = self._blocks(self.encoder, h, impl)
        if self.norm_output:
            h = self.norm(h)
        mean, logvar = self.to_latent(h, torch.float32).feats.chunk(2, -1)
        if sample_posterior:
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator,
                                    device=mean.device)
            zf = mean + torch.exp(0.5 * logvar) * noise
        else:
            zf = mean
        return x.replace(feats=zf * x.valid[..., None]), mean, logvar

    def decode(self, latent: SparseVoxels,
               impl: Optional[str] = None) -> SparseVoxels:
        h = self.from_latent(latent, self.dtype)
        if self.pe_mode == "ape":
            h = h + self._ape(latent)
        h = self._blocks(self.decoder, h, impl)
        if self.norm_output:
            h = self.norm(h)
        return self.out_layer(h, torch.float32)

    def forward(self, x: SparseVoxels, sample_posterior: bool = True,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                impl: Optional[str] = None):
        """-> (out: SparseVoxels [B, L, out_channels], mean, logvar)."""
        z, mean, logvar = self.encode(x, sample_posterior, generator, noise,
                                      impl)
        return self.decode(z, impl), mean, logvar
