"""Tile binning for 3DGS rasterization (port of
gvfdiffusion_tpu/ops/rasterize/binning.py:42-224).

Per screen tile, the first `max_per_tile` intersecting Gaussians in the
stable front-to-back order (depth, then index), as the JAX package selects
them. The JAX package's `RankIndex` window structure exists for the TPU's
gathers; here a stable sort, then a per-tile cumulative count of
intersections <= K, expresses the same selection. The cursor-based
`select_front` of the multi-round blend is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BinnedGaussians(NamedTuple):
    """Per-tile gathered Gaussians, front to back. Slots past a tile's
    count have mask False and opacity 0 (their other fields are filler)."""

    mean2d: torch.Tensor   # [T, K, 2]
    conic: torch.Tensor    # [T, K, 3] (a, b, c) of the inverse covariance
    color: torch.Tensor    # [T, K, 3]
    opacity: torch.Tensor  # [T, K]
    depth: torch.Tensor    # [T, K]
    mask: torch.Tensor     # [T, K] bool, a real entry
    index: torch.Tensor    # [T, K] the Gaussian's index in the input
    n_tiles_y: int
    n_tiles_x: int
    tile: int


def compute_radius(cov2d: torch.Tensor) -> torch.Tensor:
    """3-sigma radius from the larger eigenvalue of [N, 2, 2] covariances."""
    mid = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
    det = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] ** 2
    lam1 = mid + torch.sqrt(torch.clamp(mid ** 2 - det, min=0.1))
    return torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))


def intersect_tiles(mean2d, cov2d, opacities, valid, height: int, width: int,
                    tile: int = 32):
    """Conservative Gaussian-disc vs tile-rect intersection.
    -> (inter [T, N] bool, conic [N, 3], n_ty, n_tx), tiles row-major."""
    n_ty, n_tx = -(-height // tile), -(-width // tile)
    det = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] * cov2d[:, 1, 0]
    det = torch.clamp(det, min=1e-12)
    conic = torch.stack([cov2d[:, 1, 1] / det, -cov2d[:, 0, 1] / det,
                         cov2d[:, 0, 0] / det], -1)
    radius = compute_radius(cov2d)
    ok = valid & (radius > 0) & (opacities > 1.0 / 255.0)

    kw = dict(device=mean2d.device, dtype=mean2d.dtype)
    y0 = (torch.arange(n_ty, **kw) * tile).repeat_interleave(n_tx)
    x0 = (torch.arange(n_tx, **kw) * tile).repeat(n_ty)
    gx, gy = mean2d[None, :, 0], mean2d[None, :, 1]
    nearest_x = torch.clamp(gx, x0[:, None], (x0 + tile)[:, None])
    nearest_y = torch.clamp(gy, y0[:, None], (y0 + tile)[:, None])
    d2 = (nearest_x - gx) ** 2 + (nearest_y - gy) ** 2
    inter = (d2 <= radius[None, :] ** 2) & ok[None, :]
    return inter, conic, n_ty, n_tx


def depth_rank_order(depths: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Stable front-to-back order, invalid entries last; depth ties keep
    the lower index first."""
    key = torch.where(valid, depths, torch.full_like(depths, float("inf")))
    return torch.sort(key, stable=True).indices


def first_k_per_tile(inter: torch.Tensor, k: int):
    """Per row of inter [T, N], the column indices of its first k True
    entries -> (idx [T, k] (0 past the row's count), mask [T, k])."""
    rank = torch.cumsum(inter, dim=1, dtype=torch.int32)
    rows, cols = torch.nonzero(inter & (rank <= k), as_tuple=True)
    slot = rank[rows, cols].long() - 1
    idx = inter.new_zeros(inter.shape[0], k, dtype=torch.long)
    mask = inter.new_zeros(inter.shape[0], k, dtype=torch.bool)
    idx[rows, slot] = cols
    mask[rows, slot] = True
    return idx, mask


def bin_gaussians(mean2d, cov2d, colors, opacities, depths, valid,
                  height: int, width: int, tile: int = 32,
                  max_per_tile: int = 256) -> BinnedGaussians:
    """mean2d [N, 2] px, cov2d [N, 2, 2], colors [N, 3], opacities [N],
    depths [N], valid [N] -> the per-tile front-to-back selection."""
    order = depth_rank_order(depths, valid)
    inter, conic, n_ty, n_tx = intersect_tiles(
        mean2d[order], cov2d[order], opacities[order], valid[order],
        height, width, tile)
    idx, mask = first_k_per_tile(inter, min(max_per_tile, mean2d.shape[0]))
    sid = order[idx]  # sorted position -> input index
    return BinnedGaussians(
        mean2d=mean2d[sid], conic=conic[idx], color=colors[sid],
        opacity=torch.where(mask, opacities[sid], 0.0), depth=depths[sid],
        mask=mask, index=sid, n_tiles_y=n_ty, n_tiles_x=n_tx, tile=tile)
