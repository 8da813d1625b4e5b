"""SparseVoxels: the padded sparse-voxel tensor (port of
gvfdiffusion_tpu/sparse/tensor.py:28-165).

    feats  [B, L, C]   voxel features (zeros where invalid)
    coords [B, L, 3]   int voxel coordinates in [0, resolution)
    valid  [B, L]      bool occupancy mask

L is a fixed capacity. Slot order is the JAX package's exactly: a
compaction truncates in slot order and FPS reads slots, so `from_dense`
puts the occupied cells first in linear-index order, then the empty ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class SparseVoxels:
    feats: torch.Tensor
    coords: torch.Tensor
    valid: torch.Tensor
    resolution: int = 64

    @property
    def batch_size(self) -> int:
        return self.feats.shape[0]

    @property
    def capacity(self) -> int:
        return self.feats.shape[1]

    @property
    def channels(self) -> int:
        return self.feats.shape[-1]

    def counts(self) -> torch.Tensor:
        return self.valid.sum(1)

    def replace(self, **changes) -> "SparseVoxels":
        return dataclasses.replace(self, **changes)

    def replace_feats(self, feats: torch.Tensor) -> "SparseVoxels":
        """New features on the same structure, zeroed on invalid slots."""
        return self.replace(feats=feats * self.valid[..., None].to(feats.dtype))

    def map_feats(self, fn: Callable) -> "SparseVoxels":
        return self.replace_feats(fn(self.feats))

    def _elemwise(self, other, op):
        if isinstance(other, SparseVoxels):
            other = other.feats
        if other.dim() == 2 and other.shape[0] == self.batch_size:
            other = other[:, None, :]  # per-batch broadcast [B, C]
        return self.replace_feats(op(self.feats, other))

    def __add__(self, other):
        return self._elemwise(other, torch.add)

    def __sub__(self, other):
        return self._elemwise(other, torch.sub)

    def __mul__(self, other):
        return self._elemwise(other, torch.mul)

    def _flat_index(self) -> torch.Tensor:
        """[B, L] linear cell index, R^3 (a dump slot) where invalid."""
        r = self.resolution
        c = self.coords.long()
        flat = c[..., 0] * r * r + c[..., 1] * r + c[..., 2]
        return torch.where(self.valid, flat, torch.full_like(flat, r ** 3))

    def to_dense(self) -> torch.Tensor:
        """[B, R, R, R, C] dense grid (invalid slots contribute nothing)."""
        r = self.resolution
        b, _, c = self.feats.shape
        idx = self._flat_index()[..., None].expand(-1, -1, c)
        out = self.feats.new_zeros(b, r ** 3 + 1, c).scatter_add_(
            1, idx, self.feats)
        return out[:, :-1].reshape(b, r, r, r, c)

    def index_grid(self) -> torch.Tensor:
        """[B, R^3] int64: slot index of the voxel at each dense cell, -1 if
        empty. The neighbour lookup of sparse conv and upsampling."""
        r = self.resolution
        b, l = self.valid.shape
        slots = torch.arange(l, device=self.valid.device).expand(b, l)
        grid = torch.full((b, r ** 3 + 1), -1, dtype=torch.long,
                          device=self.valid.device)
        return grid.scatter_(1, self._flat_index(), slots)[:, :-1]


def from_dense(dense: torch.Tensor, capacity: int,
               threshold: float = 0.0) -> SparseVoxels:
    """[B, R, R, R, C] -> SparseVoxels keeping the cells with any
    |feat| > threshold, occupied cells first in linear-index order (the
    order of the JAX top_k), then empty ones; cells past `capacity` are
    dropped."""
    b, r, _, _, c = dense.shape
    flat = dense.reshape(b, r ** 3, c)
    occ = flat.abs().amax(-1) > threshold
    idx = torch.sort((~occ).to(torch.int32), dim=1,
                     stable=True).indices[:, :capacity]
    feats = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
    valid = torch.gather(occ, 1, idx)
    coords = torch.stack([idx // (r * r), (idx // r) % r, idx % r], -1)
    return SparseVoxels(feats=feats * valid[..., None].to(feats.dtype),
                        coords=coords.to(torch.int32), valid=valid,
                        resolution=r)


def from_lists(coords_list: Sequence[np.ndarray],
               feats_list: Sequence[np.ndarray], resolution: int,
               capacity: Optional[int] = None) -> SparseVoxels:
    """Per-sample [Ni, 3] coords and [Ni, C] feats (numpy) -> SparseVoxels
    on the CPU: each sample's voxels first, in the given order, then
    padding; a sample past `capacity` (default: the largest Ni) is cut."""
    b = len(coords_list)
    cap = capacity or max(len(c) for c in coords_list)
    feats = np.zeros((b, cap, feats_list[0].shape[-1]), np.float32)
    coords = np.zeros((b, cap, 3), np.int32)
    valid = np.zeros((b, cap), bool)
    for i, (co, fe) in enumerate(zip(coords_list, feats_list)):
        n = min(len(co), cap)
        coords[i, :n] = np.asarray(co)[:n]
        feats[i, :n] = np.asarray(fe)[:n]
        valid[i, :n] = True
    return SparseVoxels(feats=torch.from_numpy(feats),
                        coords=torch.from_numpy(coords),
                        valid=torch.from_numpy(valid), resolution=resolution)
