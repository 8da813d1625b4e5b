"""Submanifold sparse 3-D convolution (port of
gvfdiffusion_tpu/sparse/conv.py:21-122): for each of the k^3 offsets,
gather the neighbour's features through a dense slot-index grid and
multiply them by that offset's weight. The output exists only at the input
voxels.

This is XLA code in the JAX package, not a Pallas kernel: here it is torch
gathers and matrix products. The products take operands rounded to `dtype`
and accumulate in fp32 (the JAX einsum's `preferred_element_type`).

The weight keeps spconv's layout under the reference's name,
`<name>.conv.weight` [O, k, k, k, I], so a reference state dict loads.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .tensor import SparseVoxels


def _neighbor_slots(x: SparseVoxels, grid: torch.Tensor, offset) -> torch.Tensor:
    """Slot index of coords + offset per voxel ([B, L], -1 if absent)."""
    r = x.resolution
    nc = x.coords.long() + torch.tensor(offset, device=x.coords.device)
    inb = ((nc >= 0) & (nc < r)).all(-1) & x.valid
    flat = (nc[..., 0] * r * r + nc[..., 1] * r + nc[..., 2]).clamp(0, r ** 3 - 1)
    slot = torch.gather(grid, 1, flat)
    return torch.where(inb, slot, -1)


def _gather_rows(feats: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """feats [B, P, C] at slot [B, L] -> [B, L, C], zeros where slot < 0."""
    f = torch.gather(feats, 1, slot.clamp_min(0)[..., None].expand(
        -1, -1, feats.shape[-1]))
    return f * (slot >= 0)[..., None].to(f.dtype)


class _SpConv(nn.Module):
    """Parameter holder with spconv's names and layout."""

    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, k, k, k, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out))


class SparseConv3d(nn.Module):
    """k^3 submanifold conv from `in_channels` to `out_channels`."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        super().__init__()
        self.k = kernel_size
        self.conv = _SpConv(in_channels, out_channels, kernel_size)

    def _offsets(self):
        k, h = self.k, self.k // 2
        return [(i - h, j - h, l - h)
                for i in range(k) for j in range(k) for l in range(k)]

    def _kernel(self, dtype) -> torch.Tensor:
        """[k^3, I, O] rounded to dtype, as fp32."""
        w = self.conv.weight
        return w.permute(1, 2, 3, 4, 0).reshape(-1, w.shape[4], w.shape[0]) \
            .to(dtype).float()

    def forward(self, x: SparseVoxels, dtype: torch.dtype,
                parent: Optional[SparseVoxels] = None,
                c2p: Optional[torch.Tensor] = None) -> SparseVoxels:
        """Standard call: conv over x's features.

        Fused-upsample call (parent and c2p given): x is the child
        structure whose features would be the upsample of `parent` (each
        child a copy of its parent's features). The k^3 products then run
        at the parent count and are gathered:
            out[c] = sum_k W[k] . parent[c2p[slot(c + k)]] * exists(c + k),
        which is exactly conv(upsample(parent))."""
        w = self._kernel(dtype)
        grid = x.index_grid()
        b, l = x.valid.shape
        out = torch.zeros(b, l, w.shape[2], device=x.feats.device)
        center = torch.where(x.valid, torch.arange(l, device=x.valid.device),
                             -1)
        if parent is not None:
            # z[k] = parent @ W[k] at parent count, rounded to dtype
            pf = parent.feats.to(dtype).float()
            z = torch.einsum("bpc,kcf->bkpf", pf, w).to(dtype)
            for oi, off in enumerate(self._offsets()):
                slot = center if off == (0, 0, 0) else _neighbor_slots(
                    x, grid, off)
                pslot = torch.gather(c2p, 1, slot.clamp_min(0))
                pslot = torch.where(slot >= 0, pslot, -1)
                out += _gather_rows(z[:, oi], pslot)
        else:
            f = x.feats.to(dtype).float()
            for oi, off in enumerate(self._offsets()):
                nf = f if off == (0, 0, 0) else _gather_rows(
                    f, _neighbor_slots(x, grid, off))
                out += nf @ w[oi]
        out = out.to(dtype) + self.conv.bias.to(dtype)
        return x.replace_feats(out)
