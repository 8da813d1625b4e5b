"""DINOv2 ViT-L/14 with registers, the video encoder (port of
gvfdiffusion_tpu/models/dinov2.py:23-159).

Parameters go by the torch hub's `dinov2_vitl14_reg` names
(`patch_embed.proj`, `blocks.N.attn.qkv`, `blocks.N.ls1.gamma`,
`register_tokens`, ...), so `utils/weights.dinov2_state_dict_from_flax`
loads the JAX package's parameters.

`dtype` is the compute dtype (flax's `dtype`): the patch conv and every
linear run in it, each attention goes through K5 (ops/fused_attention.py),
computing in bf16 on the card (as JAX calls K5 on its chip, whatever the
model's dtype) and in `dtype` on the CPU, while the residual stream, the
LayerNorms (flax's fast variance) and the layer scales stay fp32, as in
the reference. GELU is the exact erf.

At 518^2 (37^2 patches, L = 1 + 4 + 1369 = 1374 tokens) the position
embedding is added as stored; on another square patch grid its 37^2 grid is
resized bilinearly to the patch grid (`jax.image.resize`'s arithmetic,
antialiased when shrinking: utils/image.py), as JAX does. JAX assumes a
square grid (`int(n ** 0.5)`); here a grid that is not square raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import MultiHeadAttention
from ..nn.misc import conv, dense, layer_norm
from ..utils.image import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_EPS = 1e-6


def _affine_ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax `nn.LayerNorm(epsilon=1e-6, dtype=float32)` with scale and bias."""
    return layer_norm(x, _EPS) * norm.weight.float() + norm.bias.float()


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int = 14, embed_dim: int = 1024):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[B, H, W, 3] -> [B, H/p * W/p, C] in `dtype`."""
        y = conv(F.conv2d, x.permute(0, 3, 1, 2), self.proj, dtype,
                 stride=self.proj.stride)
        return y.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return dense(F.gelu(dense(x, self.fc1, dtype)), self.fc2, dtype)


class Attention(MultiHeadAttention):
    """DINOv2's self-attention (no q/k RMS norm) under the hub's names."""

    qkv_name = "qkv"
    out_name = "proj"

    def __init__(self, dim: int, num_heads: int):
        super().__init__(dim, num_heads, "self", qk_rms_norm=False)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                impl: Optional[str] = None) -> torch.Tensor:
        """x [B, L, C] fp32 -> fp32 (the `dtype` outputs scale in fp32)."""
        h = self.attn(_affine_ln(self.norm1, x), dtype, impl=impl)
        x = x + h.float() * self.ls1.gamma.float()
        h = self.mlp(_affine_ln(self.norm2, x), dtype)
        return x + h.float() * self.ls2.gamma.float()


class DinoV2(nn.Module):
    """ViT-L/14 with register tokens (dinov2_vitl14_reg defaults)."""

    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 num_register_tokens: int = 4, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = embed_dim
        self.dtype = dtype
        self.patch_size = patch_size
        self.patch_embed = PatchEmbed(patch_size, C)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(
            torch.randn(1, 1 + (img_size // patch_size) ** 2, C) * 0.02)
        self.register_tokens = nn.Parameter(
            torch.zeros(1, num_register_tokens, C))
        self.blocks = nn.ModuleList(
            Block(C, num_heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(C, eps=_EPS)

    def forward(self, x: torch.Tensor, impl: Optional[str] = None):
        """x [B, H, W, 3] normalized images -> (prenorm, normed) tokens
        [B, 1 + R + L, C] in fp32. `impl="plain"` runs K5's plain
        version."""
        B, H, W = x.shape[:3]
        h = self.patch_embed(x, self.dtype)
        pos = self.pos_embed.float()
        if h.shape[1] != pos.shape[1] - 1:
            pos = torch.cat([pos[:, :1], self._grid_pos(
                pos[:, 1:], H // self.patch_size, W // self.patch_size)], 1)
        C = h.shape[2]
        h = h.float() + pos[:, 1:]
        cls = (self.cls_token.float() + pos[:, :1]).expand(B, 1, C)
        reg = self.register_tokens.float().expand(B, -1, C)
        h = torch.cat([cls, reg, h], dim=1)
        for block in self.blocks:
            h = block(h, self.dtype, impl=impl)
        return h, _affine_ln(self.norm, h)

    @staticmethod
    def _grid_pos(grid: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        """The patch position embedding [1, g0^2, C] resized bilinearly to
        a gh x gw patch grid -> [1, gh * gw, C] (JAX models/dinov2.py:
        115-125)."""
        n, C = grid.shape[1:]
        g0 = int(n ** 0.5)
        if g0 * g0 != n or gh != gw:
            raise ValueError(
                f"the position embedding's {n} patches and the image's "
                f"{gh} x {gw} patch grid: only square grids are resized")
        return resize_bilinear(grid.reshape(1, g0, g0, C),
                               (gh, gw)).reshape(1, gh * gw, C)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> imagenet-normalized."""
    mean = images.new_tensor(IMAGENET_MEAN)
    std = images.new_tensor(IMAGENET_STD)
    return (images - mean) / std


@torch.no_grad()
def encode_image(model: DinoV2, images: torch.Tensor,
                 impl: Optional[str] = None) -> torch.Tensor:
    """The reference's encode_image: forward, take the prenorm tokens, then
    a parameter-free layer norm over channels (the model's own `norm` output
    is dropped). images [B, H, W, 3] in [0, 1] -> [B, 1 + R + L, C] fp32."""
    prenorm, _ = model(preprocess(images.float()), impl=impl)
    mu = prenorm.mean(-1, keepdim=True)
    var = prenorm.var(-1, unbiased=False, keepdim=True)
    return (prenorm - mu) * torch.rsqrt(var + _EPS)
