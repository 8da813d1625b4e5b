"""TRELLIS sparse-structure decoder (port of
gvfdiffusion_tpu/models/trellis/ss_vae.py:17-153): a dense 3-D conv
decoder from the 16^3 x 8 latent to 64^3 occupancy logits, with channel
LayerNorms in fp32 and pixel-shuffle upsampling.

The public layout is the JAX package's, channels last ([B, R, R, R, C]);
inside, the convolutions run F.conv3d on [B, C, D, H, W] (one permute at
each end). Parameters go by the reference's names and torch Conv3d
layouts (`input_layer`, `middle_block.N`, `blocks.N`, `out_layer.{0,2}`),
and the pixel shuffle keeps the reference's channel order (channel * 8 +
offset; the JAX package keeps offsets major and permutes in
`convert_ss_decoder`). `norm_type` picks the channel LayerNorm ("layer")
or a GroupNorm of 32 groups ("group", flax's `nn.GroupNorm`: statistics
over each group's channels and every voxel, fast variance, fp32). The
encoder is not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.misc import conv


def pixel_shuffle_3d(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, C*f^3, D, H, W] -> [B, C, D*f, H*f, W*f]."""
    b, c, d, h, w = x.shape
    f = factor
    x = x.reshape(b, c // f ** 3, f, f, f, d, h, w)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, c // f ** 3, d * f, h * f, w * f)


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over dim 1 of [B, C, D, H, W] in fp32 (flax's fast
    variance), with weight and bias: fp32 out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(1, keepdim=True)
        var = torch.clamp((xf * xf).mean(1, keepdim=True) - mu * mu, min=0.0)
        shape = (1, -1, 1, 1, 1)
        return (xf - mu) * torch.rsqrt(var + self.eps) \
            * self.weight.float().view(shape) + self.bias.float().view(shape)


class ChannelGroupNorm(nn.GroupNorm):
    """flax `nn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=float32)` on
    [B, C, D, H, W]: mean and fast variance over each group's channels and
    every voxel, in fp32, with weight and bias: fp32 out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        xg = x.float().reshape(b, self.num_groups, -1)
        mu = xg.mean(-1, keepdim=True)
        var = torch.clamp((xg * xg).mean(-1, keepdim=True) - mu * mu, min=0.0)
        h = ((xg - mu) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, -1, 1, 1, 1)
        return h * self.weight.float().view(shape) \
            + self.bias.float().view(shape)


def channel_norm(norm_type: str, channels: int) -> nn.Module:
    """JAX's `_norm`: the channel LayerNorm or a 32-group GroupNorm."""
    if norm_type == "layer":
        return ChannelLayerNorm(channels, eps=1e-5)
    if norm_type == "group":
        return ChannelGroupNorm(32, channels, eps=1e-5)
    raise ValueError(f"norm_type must be 'layer' or 'group', got "
                     f"{norm_type!r}")


def conv3d(x: torch.Tensor, layer: nn.Conv3d, dtype: torch.dtype):
    """flax `nn.Conv(dtype=dtype, padding="SAME")` (nn/misc.conv: in fp32
    with no TF32)."""
    return conv(F.conv3d, x, layer, dtype, padding=layer.padding)


class ResBlock3d(nn.Module):
    def __init__(self, channels: int, out_channels: int = None,
                 norm_type: str = "layer"):
        super().__init__()
        out = out_channels or channels
        self.norm1 = channel_norm(norm_type, channels)
        self.conv1 = nn.Conv3d(channels, out, 3, padding=1)
        self.norm2 = channel_norm(norm_type, out)
        self.conv2 = nn.Conv3d(out, out, 3, padding=1)
        self.skip_connection = (nn.Conv3d(channels, out, 1)
                                if out != channels else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = conv3d(F.silu(self.norm1(x)), self.conv1, dtype)
        h = conv3d(F.silu(self.norm2(h)), self.conv2, dtype)
        skip = x if self.skip_connection is None else conv3d(
            x, self.skip_connection, dtype)
        return h + skip


class UpsampleBlock3d(nn.Module):
    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv3d(channels, out_channels * 8, 3, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return pixel_shuffle_3d(conv3d(x, self.conv, dtype), 2)


class SparseStructureDecoder(nn.Module):
    """latent [B, r, r, r, C_latent] -> occupancy logits [B, R, R, R, C_out]
    (fp32). `dtype` is the convolutions' compute dtype inside the blocks;
    the input and output convolutions run in fp32, as in JAX."""

    def __init__(self, out_channels: int = 1, latent_channels: int = 8,
                 num_res_blocks: int = 2,
                 channels: Sequence[int] = (512, 128, 32),
                 num_res_blocks_middle: int = 2, norm_type: str = "layer",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.input_layer = nn.Conv3d(latent_channels, channels[0], 3,
                                     padding=1)
        self.middle_block = nn.ModuleList(
            ResBlock3d(channels[0], norm_type=norm_type)
            for _ in range(num_res_blocks_middle))
        blocks = []
        for i, ch in enumerate(channels):
            blocks += [ResBlock3d(ch, norm_type=norm_type)
                       for _ in range(num_res_blocks)]
            if i < len(channels) - 1:
                blocks.append(UpsampleBlock3d(ch, channels[i + 1]))
        self.blocks = nn.ModuleList(blocks)
        self.out_layer = nn.Sequential(
            channel_norm(norm_type, channels[-1]), nn.SiLU(),
            nn.Conv3d(channels[-1], out_channels, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv3d(x.permute(0, 4, 1, 2, 3), self.input_layer, torch.float32)
        for block in (*self.middle_block, *self.blocks):
            h = block(h, self.dtype)
        h = F.silu(self.out_layer[0](h))
        h = conv3d(h, self.out_layer[2], torch.float32)
        return h.permute(0, 2, 3, 4, 1)
