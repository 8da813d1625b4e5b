"""Tile binning for 3DGS rasterization (port of
gvfdiffusion_tpu/ops/rasterize/binning.py:42-224).

Per screen tile, the first `max_per_tile` intersecting Gaussians in the
stable front-to-back order (depth, then index), as the JAX package selects
them. The JAX package's `RankIndex` window structure exists for the TPU's
gathers; here a stable sort, then a per-tile cumulative count of
intersections, expresses the same selection: the window of ranks
[offset, offset + K) that a round of the multi-round blend takes, the
first K for one round. Several views are binned together: their tiles are
rows of one selection, each row's columns in its own view's order.
`select_front`, which no path calls, is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class BinnedGaussians(NamedTuple):
    """Per-tile gathered Gaussians, front to back. Slots past a tile's
    count have mask False and opacity 0 (their other fields are filler).
    Of V views, the tiles of each view follow the view before's."""

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
    views: Optional[int] = None  # V, or None: one view, no view axis


def compute_radius(cov2d: torch.Tensor) -> torch.Tensor:
    """3-sigma radius from the larger eigenvalue of [..., 2, 2]
    covariances."""
    mid = 0.5 * (cov2d[..., 0, 0] + cov2d[..., 1, 1])
    det = cov2d[..., 0, 0] * cov2d[..., 1, 1] - cov2d[..., 0, 1] ** 2
    lam1 = mid + torch.sqrt(torch.clamp(mid ** 2 - det, min=0.1))
    return torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))


def intersect_tiles(mean2d, cov2d, opacities, valid, height: int, width: int,
                    tile: int = 32):
    """Conservative Gaussian-disc vs tile-rect intersection, of one view's
    [N, ...] inputs or V views' [V, N, ...].
    -> (inter [(V,) T, N] bool, conic [(V,) N, 3], n_ty, n_tx), tiles
    row-major."""
    n_ty, n_tx = -(-height // tile), -(-width // tile)
    det = cov2d[..., 0, 0] * cov2d[..., 1, 1] \
        - cov2d[..., 0, 1] * cov2d[..., 1, 0]
    det = torch.clamp(det, min=1e-12)
    conic = torch.stack([cov2d[..., 1, 1] / det, -cov2d[..., 0, 1] / det,
                         cov2d[..., 0, 0] / det], -1)
    radius = compute_radius(cov2d)
    ok = valid & (radius > 0) & (opacities > 1.0 / 255.0)

    kw = dict(device=mean2d.device, dtype=mean2d.dtype)
    y0 = (torch.arange(n_ty, **kw) * tile).repeat_interleave(n_tx)
    x0 = (torch.arange(n_tx, **kw) * tile).repeat(n_ty)
    gx, gy = mean2d[..., None, :, 0], mean2d[..., None, :, 1]
    nearest_x = torch.clamp(gx, x0[:, None], (x0 + tile)[:, None])
    nearest_y = torch.clamp(gy, y0[:, None], (y0 + tile)[:, None])
    d2 = (nearest_x - gx) ** 2 + (nearest_y - gy) ** 2
    inter = (d2 <= radius[..., None, :] ** 2) & ok[..., None, :]
    return inter, conic, n_ty, n_tx


def depth_rank_order(depths: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Stable front-to-back order along the last axis, invalid entries
    last; depth ties keep the lower index first."""
    key = torch.where(valid, depths, torch.full_like(depths, float("inf")))
    return torch.sort(key, stable=True).indices


def as_views(*arrays):
    """One view's [N, ...] arrays, or V views' [V, N, ...] -> (V, or None
    for one view, and the arrays as [V, N, ...]). The first array, mean2d
    [(V,) N, 2], tells which."""
    views = arrays[0].shape[0] if arrays[0].dim() == 3 else None
    if views is None:
        arrays = tuple(a[None] for a in arrays)
    return views, arrays


def sort_views(depths: torch.Tensor, valid: torch.Tensor):
    """[V, N] -> each view's front-to-back order as positions in the views'
    flattened [V * N] arrays."""
    V, N = depths.shape
    order = depth_rank_order(depths, valid)
    base = N * torch.arange(V, device=order.device)[:, None]
    return (order + base).reshape(-1)


def view_offsets(views: int, n_tiles: int, n: int, device) -> torch.Tensor:
    """[V * T, 1]: per tile row, the flattened position of its view's
    first entry, which turns a column of that view into a position."""
    return n * (torch.arange(views * n_tiles, device=device)
                // n_tiles)[:, None]


def rank_window(inter: torch.Tensor, k: int, offset: int = 0,
                rank: torch.Tensor = None):
    """Per row of inter [T, N], the column indices of its True entries of
    rank offset .. offset + k - 1 (0-based, in column order) -> (idx [T, k]
    (0 past the row's count), mask [T, k]). `rank` is cumsum(inter, 1), the
    running count, which a caller taking several windows computes once."""
    if rank is None:
        rank = torch.cumsum(inter, dim=1, dtype=torch.int32)
    rows, cols = torch.nonzero(inter & (rank > offset) & (rank <= offset + k),
                               as_tuple=True)
    slot = rank[rows, cols].long() - offset - 1
    idx = inter.new_zeros(inter.shape[0], k, dtype=torch.long)
    mask = inter.new_zeros(inter.shape[0], k, dtype=torch.bool)
    idx[rows, slot] = cols
    mask[rows, slot] = True
    return idx, mask


def bin_gaussians(mean2d, cov2d, colors, opacities, depths, valid,
                  height: int, width: int, tile: int = 32,
                  max_per_tile: int = 256) -> BinnedGaussians:
    """mean2d [N, 2] px, cov2d [N, 2, 2], colors [N, 3], opacities [N],
    depths [N], valid [N] -> the per-tile front-to-back selection. Of V
    views (each but colors with a leading V), the tiles of all views."""
    views, arrays = as_views(mean2d, cov2d, opacities, depths, valid)
    V, N = arrays[3].shape
    order = sort_views(arrays[3], arrays[4])
    mean2d, cov2d, opacities, depths, valid = (
        a.reshape(V * N, *a.shape[2:]) for a in arrays)
    inter, conic, n_ty, n_tx = intersect_tiles(
        *(a[order].unflatten(0, (V, N))
          for a in (mean2d, cov2d, opacities, valid)), height, width, tile)
    n_tiles = n_ty * n_tx
    idx, mask = rank_window(inter.reshape(V * n_tiles, N),
                            min(max_per_tile, N))
    idx = idx + view_offsets(V, n_tiles, N, idx.device)
    sid = order[idx]  # sorted position -> position in the flattened input
    return BinnedGaussians(
        mean2d=mean2d[sid], conic=conic.reshape(V * N, 3)[idx],
        color=colors[sid % N], opacity=torch.where(mask, opacities[sid], 0.0),
        depth=depths[sid], mask=mask, index=sid % N, n_tiles_y=n_ty,
        n_tiles_x=n_tx, tile=tile, views=views)
