"""Pointwise and pooling ops on SparseVoxels (port of
gvfdiffusion_tpu/sparse/ops.py:24-53, 94-221).

Pooling dedups children by parent code with a stable sort (the JAX
`argsort` is stable), so the parent slots and the child -> parent map
equal the JAX package's. Pooled sums accumulate in fp32, in a fixed order,
and return in the features' dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..nn.misc import dense, layer_norm
from .tensor import SparseVoxels


class SparseLinear(nn.Linear):
    """A Linear over the voxel features (flax Dense semantics in `dtype`);
    invalid slots stay 0."""

    def forward(self, x: SparseVoxels, dtype: torch.dtype) -> SparseVoxels:
        return x.replace_feats(dense(x.feats, self, dtype))


class SparseLayerNorm(nn.Module):
    """Per-voxel LayerNorm over channels in fp32 (flax's fast variance),
    with a weight and bias when `affine`."""

    def __init__(self, channels: int, affine: bool = True, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.weight = self.bias = None

    def forward(self, x: SparseVoxels) -> SparseVoxels:
        f = layer_norm(x.feats, self.eps)
        if self.weight is not None:
            f = f * self.weight.float() + self.bias.float()
        return x.replace_feats(f)


class DownsampleResult(NamedTuple):
    parents: SparseVoxels
    child_to_parent: torch.Tensor  # [B, L] parent slot per child (-1 pad)


def sparse_downsample(x: SparseVoxels, factor: int = 2) -> DownsampleResult:
    """Pool voxels into coords // factor cells. As in the reference, each
    parent gets sum / (n_children + 1) (torch's scatter_reduce "mean" with
    include_self=True counts the zero it starts from), which the released
    weights were trained with. Parents reuse the capacity L, in
    parent-code order."""
    b, l, c = x.feats.shape
    new_res = x.resolution // factor
    pc = x.coords.long() // factor
    pflat = pc[..., 0] * new_res * new_res + pc[..., 1] * new_res + pc[..., 2]
    pflat = torch.where(x.valid, pflat, torch.full_like(pflat, new_res ** 3))
    sorted_key, order = torch.sort(pflat, dim=1, stable=True)
    first = torch.ones_like(sorted_key, dtype=torch.bool)
    first[:, 1:] = sorted_key[:, 1:] != sorted_key[:, :-1]
    seg = first.long().cumsum(1) - 1  # parent slot of each sorted child
    f_sorted = torch.gather(x.feats, 1, order[..., None].expand(-1, -1, c))
    v_sorted = torch.gather(x.valid, 1, order)
    # each parent's (at most factor^3) children in a row of their own, then
    # summed in child order: deterministic, unlike atomic scatter-adds
    ar = torch.arange(l, device=x.feats.device).expand(b, l)
    pos = ar - torch.cummax(torch.where(first, ar, 0), 1).values
    bi, ci = torch.nonzero(v_sorted, as_tuple=True)
    rows = torch.zeros(b, l, factor ** 3, c, device=x.feats.device)
    rows[bi, seg[bi, ci], pos[bi, ci]] = f_sorted[bi, ci].float()
    pooled = rows.sum(2)
    cnt = torch.zeros(b, l, device=x.feats.device).scatter_add_(
        1, seg, v_sorted.float())
    pkey = torch.zeros_like(sorted_key).scatter_(1, seg, sorted_key)
    pvalid = (cnt > 0) & (pkey < new_res ** 3)
    coords = torch.stack([pkey // (new_res * new_res), (pkey // new_res)
                          % new_res, pkey % new_res], -1)
    coords = torch.where(pvalid[..., None], coords, 0).to(torch.int32)
    mean = pooled / (cnt + 1.0)[..., None] * pvalid[..., None]
    c2p = torch.zeros_like(seg).scatter_(1, order, seg)
    c2p = torch.where(x.valid, c2p, -1)
    parents = SparseVoxels(feats=mean.to(x.feats.dtype), coords=coords,
                           valid=pvalid, resolution=new_res)
    return DownsampleResult(parents, c2p)


def sparse_upsample(parents: SparseVoxels, child_template: SparseVoxels,
                    child_to_parent: torch.Tensor) -> SparseVoxels:
    """Nearest-neighbour unpool onto the cached child structure; children
    with child_to_parent < 0 (invalid, or parent dropped by a compaction)
    get zeros."""
    c = parents.channels
    idx = child_to_parent.clamp_min(0)[..., None].expand(-1, -1, c)
    f = torch.gather(parents.feats, 1, idx)
    keep = child_template.valid & (child_to_parent >= 0)
    return child_template.replace(feats=f * keep[..., None].to(f.dtype))


def sparse_compact(x: SparseVoxels, new_capacity: int):
    """Pack the valid voxels to the front (stable) and shrink the capacity
    to `new_capacity`, dropping valid voxels past it. Returns (compacted
    SparseVoxels, slots [B, new_capacity] source index, -1 on padding)."""
    if new_capacity > x.capacity:
        raise ValueError(f"capacity {new_capacity} > {x.capacity}")
    key = (~x.valid).to(torch.int32)
    order = torch.sort(key, dim=1, stable=True).indices[:, :new_capacity]
    valid = torch.gather(x.valid, 1, order)
    feats = torch.gather(x.feats, 1,
                         order[..., None].expand(-1, -1, x.channels))
    coords = torch.gather(x.coords, 1, order[..., None].expand(-1, -1, 3))
    slots = torch.where(valid, order, -1)
    out = SparseVoxels(
        feats=feats * valid[..., None].to(feats.dtype),
        coords=torch.where(valid[..., None], coords, 0), valid=valid,
        resolution=x.resolution)
    return out, slots


def sparse_scatter_back(y: SparseVoxels, slots: torch.Tensor,
                        template: SparseVoxels) -> SparseVoxels:
    """Inverse of sparse_compact: y's features back onto the template's
    (pre-compaction) slots."""
    c = y.channels
    src = y.feats * (slots >= 0)[..., None].to(y.feats.dtype)
    feats = y.feats.new_zeros(template.batch_size, template.capacity, c)
    feats.scatter_add_(1, slots.clamp_min(0)[..., None].expand(-1, -1, c),
                       src)
    return template.replace(
        feats=feats * template.valid[..., None].to(feats.dtype))
