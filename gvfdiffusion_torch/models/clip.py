"""CLIP's image encoder, the azimuth alignment's scorer (port of
gvfdiffusion_tpu/models/clip.py).

The reference scores the alignment's renders against the video's frame
with OpenAI CLIP ViT-B/32 (utils/inference_utils.py:48, :105-130). This is
its visual tower: conv patchify, class token, a pre-LN transformer with
QuickGELU MLPs, post-LN, a linear projection to the joint space. The
parameters go by OpenAI's `visual.*` names without the prefix
(`conv1.weight`, `transformer.resblocks.N.attn.in_proj_weight`, ...), so
utils/weight_convert.convert_clip_visual takes a released state dict and
utils/weights.clip_table a flax tree.

`dtype` is the compute dtype (flax's), fp32 by default; LayerNorms run in
fp32 with flax's fast variance. ViT-B/32 has 50 tokens, outside K5's rule
(Lq >= 128), so its attention takes the library softmax attention, as JAX's
takes XLA's (nn/attention.scaled_dot_product_attention).

`make_clip_score_fn` makes the `clip_score_fn` that
utils/inference_utils.align_gaussian_to_canonical takes: renders [A, H, W,
3] -> cosine similarity to the target frame's embedding.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import scaled_dot_product_attention
from ..nn.misc import conv, dense, layer_norm
from ..utils.image import resize_cubic

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax `nn.LayerNorm(epsilon=1e-5, dtype=float32)`."""
    return layer_norm(x, 1e-5) * norm.weight.float() + norm.bias.float()


class Attention(nn.Module):
    """nn.MultiheadAttention's parameters (a packed [q; k; v] in_proj, an
    out_proj), self-attention only."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, L, C = x.shape
        qkv = F.linear(x.to(dtype), self.in_proj_weight.to(dtype),
                       self.in_proj_bias.to(dtype))
        qkv = qkv.reshape(B, L, 3, self.heads, C // self.heads)
        o = scaled_dot_product_attention(qkv[:, :, 0], qkv[:, :, 1],
                                         qkv[:, :, 2], dtype)
        return dense(o.reshape(B, L, C), self.out_proj, dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.c_fc = nn.Linear(dim, 4 * dim)
        self.c_proj = nn.Linear(4 * dim, dim)


class CLIPBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, heads)
        self.ln_2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x + self.attn(_ln(self.ln_1, x), dtype)
        h = quick_gelu(dense(_ln(self.ln_2, x), self.mlp.c_fc, dtype))
        return x + dense(h, self.mlp.c_proj, dtype)


class Transformer(nn.Module):
    def __init__(self, width: int, depth: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(CLIPBlock(width, heads)
                                       for _ in range(depth))


class CLIPImageEncoder(nn.Module):
    """ViT-B/32's visual tower by default. images [B, H, W, 3] in [0, 1]
    (CLIP-normalized here) -> [B, embed_dim] embeddings, not normalized."""

    def __init__(self, image_size: int = 224, patch_size: int = 32,
                 width: int = 768, depth: int = 12, heads: int = 12,
                 embed_dim: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_size, self.patch_size, self.dtype = (image_size,
                                                        patch_size, dtype)
        grid = (image_size // patch_size) ** 2
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.randn(width) * 0.02)
        self.positional_embedding = nn.Parameter(
            torch.randn(1 + grid, width) * 0.01)
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = Transformer(width, depth, heads)
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.randn(width, embed_dim) * 0.02)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = (images.float() - images.new_tensor(CLIP_MEAN)) / \
            images.new_tensor(CLIP_STD)
        S = self.image_size
        if tuple(x.shape[1:3]) != (S, S):
            # OpenAI's preprocessing: a bicubic resize of the short side
            # to S, then the centre S x S crop
            b, h, w, _ = x.shape
            if h <= w:
                rh, rw = S, max(S, int(round(w * S / h)))
            else:
                rw, rh = S, max(S, int(round(h * S / w)))
            x = resize_cubic(x, (rh, rw))
            oy, ox = (rh - S) // 2, (rw - S) // 2
            x = x[:, oy:oy + S, ox:ox + S, :]
        h = conv(F.conv2d, x.permute(0, 3, 1, 2), self.conv1, self.dtype,
                 stride=self.patch_size)
        b, c = h.shape[:2]
        h = h.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(h.dtype).expand(b, 1, c)
        h = torch.cat([cls, h], 1) + self.positional_embedding.to(h.dtype)
        h = _ln(self.ln_pre, h)
        for block in self.transformer.resblocks:
            h = block(h, self.dtype)
        h = _ln(self.ln_post, h[:, 0])
        return h @ self.proj.to(h.dtype)


def make_clip_score_fn(model: CLIPImageEncoder,
                       target_image: np.ndarray) -> Callable:
    """The `clip_score_fn` of align_gaussian_to_canonical: embeds
    target_image [H, W, 3] once; returns fn(renders [A, H, W, 3], numpy or
    tensor) -> cosine similarities [A] (numpy), on the model's device."""
    model.eval()
    dev = next(model.parameters()).device

    @torch.no_grad()
    def embed(images) -> torch.Tensor:
        e = model(torch.as_tensor(images, dtype=torch.float32, device=dev))
        return e / (e.norm(dim=-1, keepdim=True) + 1e-8)

    tgt = embed(np.asarray(target_image)[None])[0]

    def score(renders) -> np.ndarray:
        return (embed(renders) @ tgt).cpu().numpy()

    return score
