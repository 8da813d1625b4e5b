"""The sparse transformer block of the static VAE (port of
gvfdiffusion_tpu/models/static_vae.py:35-121): the per-block attention
schedule, the feed-forward net and the un-modulated pre-norm block, which
the SLat Gaussian decoder's torso stacks. The VAE itself, the modulated
block and the serialized attention modes are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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
