"""TRELLIS structured-latent (SLat) flow model, a sparse U-DiT (port of
gvfdiffusion_tpu/models/trellis/slat_flow.py:32-407): sparse conv res
blocks that down- and upsample around a stack of modulated sparse
transformer blocks (full sparse self-attention, cross-attention to the
DINOv2 tokens, MLP).

Each downsample hands its (child structure, child -> parent map) to the
paired upsample. The deepest downsample compacts the parents to
`torso_capacity` slots before its conv body, so the body and the torso run
at that capacity.

In the torso the self-attention follows sparse/attention.
full_sparse_attention's dispatch: K5 with the key validity as a -inf logit
bias up to 4096 slots (a compacted torso), past that K7, the streaming
flash kernel over key validity (the default `torso_capacity=None` at 32768
voxel slots), in the model's dtype (bf16, or fp32 as the registry builds
TRELLIS). The cross sublayer is K3 in its single-context form
(ops/fused_sublayer.py; on the card it takes every head width that
divides 128 and raises otherwise) at any slot count, computing in the
model's dtype; with the
cross q/k RMS norm (`qk_rms_norm_cross`, off in the released model) it
composes as JAX does (its gate, slat_flow.py:221): an affine LayerNorm, a
cross `SparseMultiHeadAttention` through `full_sparse_attention` with every
key valid (K5's bias form) and the residual. `share_mod` computes one
modulation at the top (`adaLN_modulation`) that every block splits;
`pe_mode` other than "ape" adds no position embedding (JAX's SLat flow has
no RoPE); `patch_size` is a configuration field that the forward does not
read (as in JAX). The out blocks always take the paired skips, as the
registry builds the model (it drops the release configs'
`use_skip_connection`, as JAX's does). The measurement-only `ablate`
fields are not ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.attention import MultiHeadAttention
from ...nn.embedders import AbsolutePositionEmbedder, TimestepEmbedder
from ...nn.misc import dense
from ...ops import fused_sublayer as fsl
from ...sparse.attention import SparseMultiHeadAttention
from ...sparse.conv import SparseConv3d
from ...sparse.ops import (SparseLayerNorm, SparseLinear, sparse_compact,
                           sparse_downsample, sparse_scatter_back,
                           sparse_upsample)
from ...sparse.tensor import SparseVoxels
from ..static_vae import SparseFeedForward


class SparseResBlock3d(nn.Module):
    """Timestep-modulated sparse conv res block, optionally a 2x down- or
    upsample. A downsample may compact its parents to `compact_to` slots
    (the child -> parent map is remapped into the compacted slots; children
    of parents past the capacity map to -1)."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None, downsample: bool = False,
                 upsample: bool = False, compact_to: Optional[int] = None):
        super().__init__()
        out = out_channels or channels
        self.downsample, self.upsample = downsample, upsample
        self.compact_to = compact_to
        self.norm1 = SparseLayerNorm(channels, affine=True)
        self.conv1 = SparseConv3d(channels, out)
        self.norm2 = SparseLayerNorm(out, affine=False)
        self.conv2 = SparseConv3d(out, out)
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        nn.Linear(emb_channels, 2 * out))
        self.skip_connection = (SparseLinear(channels, out)
                                if out != channels else None)

    def _skip(self, x: SparseVoxels, dtype) -> SparseVoxels:
        return x if self.skip_connection is None else \
            self.skip_connection(x, dtype)

    def _tail(self, h: SparseVoxels, emb, skip: SparseVoxels, dtype):
        scale, shift = dense(F.silu(emb), self.emb_layers[1],
                             dtype).chunk(2, -1)
        h = self.norm2(h)
        h = h.replace_feats(h.feats * (1 + scale[:, None]) + shift[:, None])
        h = self.conv2(h.map_feats(F.silu), dtype)
        return h + skip.feats

    def forward(self, x: SparseVoxels, emb: torch.Tensor, dtype: torch.dtype,
                up_structure: Optional[Tuple[SparseVoxels, torch.Tensor]] = None):
        """Returns (out, (child template, child -> parent) of a downsample,
        else None). An upsample takes its pair as `up_structure`."""
        down = None
        if self.downsample:
            template = x
            x, c2p = sparse_downsample(x, 2)
            if self.compact_to is not None and self.compact_to < x.capacity:
                x, slots = sparse_compact(x, self.compact_to)
                b, l = c2p.shape
                nc = slots.shape[1]
                inv = torch.full((b, l + 1), -1, dtype=torch.long,
                                 device=c2p.device)
                inv.scatter_(1, torch.where(slots >= 0, slots, l),
                             torch.arange(nc, device=c2p.device).expand(b, nc))
                c2p = torch.where(c2p >= 0, torch.gather(
                    inv[:, :l], 1, c2p.clamp_min(0)), -1)
            down = (template, c2p)
        elif self.upsample:
            # every child copies its parent, so norm1, silu, conv1's
            # products and the skip projection run at the parent count
            child_template, c2p = up_structure
            skip = sparse_upsample(self._skip(x, dtype), child_template, c2p)
            hp = self.norm1(x).map_feats(F.silu)
            h = self.conv1(child_template, dtype, parent=hp, c2p=c2p)
            return self._tail(h, emb, skip, dtype), down
        h = self.conv1(self.norm1(x).map_feats(F.silu), dtype)
        return self._tail(h, emb, self._skip(x, dtype), dtype), down


class ModulatedSparseCrossBlock(nn.Module):
    """Sparse self-attn + cross-attn + MLP with adaLN-Zero modulation;
    norm1/norm3 affine-free, norm2 affine. `cross_attn` holds the cross
    sublayer's parameters, which K3 takes (with `qk_rms_norm_cross`, a
    cross `SparseMultiHeadAttention` with its q/k norms). With `share_mod`
    the block has no `adaLN_modulation`: it splits the model's [B, 6C]
    modulation."""

    def __init__(self, channels: int, num_heads: int, mlp_ratio: float = 4.0,
                 qk_rms_norm: bool = False, qk_rms_norm_cross: bool = False,
                 share_mod: bool = False,
                 ctx_channels: Optional[int] = None):
        super().__init__()
        C = channels
        self.channels, self.num_heads = C, num_heads
        self.qk_rms_norm_cross, self.share_mod = qk_rms_norm_cross, share_mod
        if not share_mod:
            self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                                  nn.Linear(C, 6 * C))
        self.norm1 = SparseLayerNorm(C, affine=False)
        self.norm2 = SparseLayerNorm(C, affine=True)
        self.norm3 = SparseLayerNorm(C, affine=False)
        self.self_attn = SparseMultiHeadAttention(
            C, num_heads, attn_mode="full", qk_rms_norm=qk_rms_norm)
        if qk_rms_norm_cross:
            self.cross_attn = SparseMultiHeadAttention(
                C, num_heads, attn_type="cross", qk_rms_norm=True,
                ctx_channels=ctx_channels)
        else:
            self.cross_attn = MultiHeadAttention(C, num_heads, "cross",
                                                 ctx_channels=ctx_channels)
        self.mlp = SparseFeedForward(C, mlp_ratio)

    def _fused_cross(self, x: SparseVoxels, context: torch.Tensor, dtype,
                     impl: Optional[str]) -> SparseVoxels:
        """The cross sublayer as one K3 call. The context's K/V projection
        stays outside (fp32 sums of dtype-rounded operands, as the JAX
        einsum); k and v go in as the halves of that projection."""
        C, a = self.channels, self.cross_attn
        rd = lambda t: t.to(dtype).float()
        kv = (rd(context) @ rd(a.to_kv.weight.t()) + a.to_kv.bias.float()
              ).to(dtype)
        w = lambda t: t.to(dtype)
        p = (w(self.norm2.weight), w(self.norm2.bias), w(a.to_q.weight.t()),
             w(a.to_q.bias), w(a.to_out.weight.t()), w(a.to_out.bias))
        feats = fsl.fused_cross_sublayer(
            x.feats, p, (kv[..., :C], kv[..., C:]), num_heads=self.num_heads,
            compute_dtype=dtype, impl=impl)
        return x.replace_feats(feats)

    def forward(self, x: SparseVoxels, mod: torch.Tensor,
                context: torch.Tensor, dtype: torch.dtype,
                impl: Optional[str] = None) -> SparseVoxels:
        m = mod if self.share_mod else dense(
            F.silu(mod), self.adaLN_modulation[1], dtype)
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = (a[:, None] for a in m.chunk(6, -1))
        h = self.norm1(x)
        h = h.replace_feats(h.feats * (1 + sc_a) + sh_a)
        x = x + self.self_attn(h, dtype, impl=impl).feats * g_a
        if self.qk_rms_norm_cross:
            h = self.cross_attn(self.norm2(x), dtype, context, impl=impl)
            x = x + h.feats
        else:
            x = self._fused_cross(x, context, dtype, impl)
        h = self.norm3(x)
        h = h.replace_feats(h.feats * (1 + sc_m) + sh_m)
        return x + self.mlp(h, dtype).feats * g_m


class SLatFlowModel(nn.Module):
    """Defaults mirror the released slat_flow_img_dit_L_64l8p2 (64^3,
    io channels (128,), 24 x 1024 torso)."""

    def __init__(self, resolution: int = 64, in_channels: int = 8,
                 model_channels: int = 1024, cond_channels: int = 1024,
                 out_channels: int = 8, num_blocks: int = 24,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 patch_size: int = 2, num_io_res_blocks: int = 2,
                 io_block_channels: Sequence[int] = (128,),
                 pe_mode: str = "ape", share_mod: bool = False,
                 qk_rms_norm: bool = False, qk_rms_norm_cross: bool = False,
                 torso_capacity: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = model_channels
        io = list(io_block_channels)
        self.in_channels = in_channels
        self.patch_size = patch_size
        self.num_io_res_blocks = num_io_res_blocks
        self.pe_mode = pe_mode
        self.share_mod = share_mod
        self.torso_capacity = torso_capacity
        self.dtype = dtype
        self.input_layer = SparseLinear(in_channels, io[0])
        self.t_embedder = TimestepEmbedder(C)
        if share_mod:
            self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                                  nn.Linear(C, 6 * C))
        self.pos_embedder = AbsolutePositionEmbedder(C)
        inp: List[nn.Module] = []
        for chs, next_chs in zip(io, io[1:] + [C]):
            inp += [SparseResBlock3d(chs, C, chs)
                    for _ in range(num_io_res_blocks - 1)]
            inp.append(SparseResBlock3d(
                chs, C, next_chs, downsample=True,
                compact_to=torso_capacity if next_chs == C else None))
        self.input_blocks = nn.ModuleList(inp)
        self.blocks = nn.ModuleList(
            ModulatedSparseCrossBlock(C, num_heads, mlp_ratio, qk_rms_norm,
                                      qk_rms_norm_cross, share_mod,
                                      cond_channels)
            for _ in range(num_blocks))
        # every out block takes its input concatenated with the paired skip
        out: List[nn.Module] = []
        for chs, prev_chs in zip(reversed(io), [C] + list(reversed(io[1:]))):
            out.append(SparseResBlock3d(prev_chs * 2, C, chs, upsample=True))
            out += [SparseResBlock3d(chs * 2, C, chs)
                    for _ in range(num_io_res_blocks - 1)]
        self.out_blocks = nn.ModuleList(out)
        self.out_norm = SparseLayerNorm(io[0], affine=False)
        self.out_layer = SparseLinear(io[0], out_channels)

    def forward(self, x: SparseVoxels, t: torch.Tensor, cond: torch.Tensor,
                impl: Optional[str] = None) -> SparseVoxels:
        dt = self.dtype
        h = self.input_layer(x, dt)
        t_emb = self.t_embedder(t)
        skips, structures = [], []
        n = self.num_io_res_blocks
        for i, block in enumerate(self.input_blocks):
            h, ds = block(h, t_emb, dt)
            if ds is not None:
                structures.append(ds)
            skips.append(h.feats)
        torso_template = None
        if self.torso_capacity is not None and \
                self.torso_capacity < h.capacity:
            torso_template = h
            h, torso_slots = sparse_compact(h, self.torso_capacity)
        if self.pe_mode == "ape":
            h = h + self.pos_embedder(h.coords.float()) * h.valid[..., None]
        mod = t_emb if not self.share_mod else dense(
            F.silu(t_emb), self.adaLN_modulation[1], dt)
        for block in self.blocks:
            h = block(h, mod, cond, dt, impl=impl)
        if torso_template is not None:
            h = sparse_scatter_back(h, torso_slots, torso_template)
        rev_skips = list(reversed(skips))
        for i, block in enumerate(self.out_blocks):
            h = h.replace(feats=torch.cat([h.feats, rev_skips[i]], -1))
            h, _ = block(h, t_emb, dt, up_structure=(
                structures.pop() if i % n == 0 else None))
        return self.out_layer(self.out_norm(h), torch.float32)
