"""Front-to-back alpha compositing of binned Gaussians (port of
gvfdiffusion_tpu/ops/rasterize/xla_blend.py:18-201).

Tiles are blended `tile_chunk` at a time, so live memory is
O(tile_chunk * tile^2 * K) rather than O(pixels * N); the result does not
depend on the chunk. `blend_tiles` composites each tile's first K
Gaussians in one round; `blend_tiles_multiround` takes the next K of each
tile per round behind the transmittance so far, and with `early_exit`
stops a tile once every pixel's transmittance is <= 1e-4 or its list is
used up (the JAX while_loop keeps a finished tile's state under vmap, so
its result is per tile too). Both take several views at once, their tiles
blended as one list.

Under autograd `blend_tiles` recomputes each chunk's per-pixel alphas in
the backward pass (`torch.utils.checkpoint`) instead of keeping them: a
512^2 view's [tiles, tile^2, K] intermediates are ~0.27 GB each, a dozen
of them per view, and the VAE trainer renders 8-16 views a step. The
gradients are the same.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .binning import (BinnedGaussians, as_views, intersect_tiles,
                      rank_window, sort_views, view_offsets)

# transmittance at which a pixel is saturated (the CUDA rasterizer's stop)
_T_EPS = 1e-4


def _pixel_grid(n_ty: int, n_tx: int, tile: int, device, views: int = 1):
    """Tile origins (oy, ox) [V * T] and a tile's pixel centres (py, px)
    [P]."""
    kw = dict(device=device, dtype=torch.float32)
    oy = (torch.arange(n_ty, **kw) * tile).repeat_interleave(n_tx)
    ox = (torch.arange(n_tx, **kw) * tile).repeat(n_ty)
    py_loc = torch.arange(tile, **kw).repeat_interleave(tile) + 0.5
    px_loc = torch.arange(tile, **kw).repeat(tile) + 0.5
    return oy.repeat(views), ox.repeat(views), py_loc, px_loc


def _alphas(mean2d, conic, opacity, mask, oy, ox, px_loc, py_loc):
    """Tiles [c] of K Gaussians over their P = tile^2 pixels -> alpha
    [c, P, K], and the transmittance in front of each Gaussian within the
    tile's K, in the reference's form."""
    px = px_loc[None, :] + ox[:, None]  # [c, P]
    py = py_loc[None, :] + oy[:, None]
    dx = px[:, :, None] - mean2d[:, None, :, 0]  # [c, P, K]
    dy = py[:, :, None] - mean2d[:, None, :, 1]
    a, b, c = (conic[:, None, :, i] for i in range(3))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(
        opacity[:, None, :] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
    alpha = torch.where((power > 0.0) | ~mask[:, None, :], 0.0, alpha)
    alpha = torch.where(alpha < 1.0 / 255.0, 0.0, alpha)
    t_before = torch.cumprod(1.0 - alpha, dim=-1) / (1.0 - alpha + 1e-10)
    return alpha, t_before


def _blend_chunk(mean2d, conic, color, opacity, depth, mask, oy, ox, px_loc,
                 py_loc, bg):
    """Tiles [c] of K Gaussians over their P = tile^2 pixels ->
    (rgb [c, P, 3], depth [c, P], alpha [c, P])."""
    alpha, t_before = _alphas(mean2d, conic, opacity, mask, oy, ox, px_loc,
                              py_loc)
    w = alpha * t_before  # [c, P, K]
    rgb = w @ color  # [c, P, 3]
    dep = (w @ depth[:, :, None])[..., 0]
    acc = w.sum(-1)
    return rgb + (1.0 - acc[..., None]) * bg, dep, acc


def blend_tiles(binned: BinnedGaussians, height: int, width: int,
                bg_color: torch.Tensor, tile_chunk: int = 64):
    """-> (rgb [(V,) H, W, 3], depth [(V,) H, W], alpha [(V,) H, W])."""
    tile, n_ty, n_tx = binned.tile, binned.n_tiles_y, binned.n_tiles_x
    V = binned.views or 1
    oy, ox, py_loc, px_loc = _pixel_grid(n_ty, n_tx, tile,
                                         binned.mean2d.device, V)
    bg = bg_color.to(oy)
    fields = (binned.mean2d, binned.conic, binned.color, binned.opacity,
              binned.depth, binned.mask, oy, ox)
    blend = _blend_chunk
    if torch.is_grad_enabled() and any(a.requires_grad for a in fields):
        blend = lambda *a: checkpoint(_blend_chunk, *a, use_reentrant=False)
    outs = [blend(*(a[s:s + tile_chunk] for a in fields), px_loc, py_loc, bg)
            for s in range(0, V * n_ty * n_tx, tile_chunk)]
    rgb, dep, acc = (torch.cat(o) for o in zip(*outs))
    return _stitch_all(rgb, dep, acc, binned.views, n_ty, n_tx, tile, height,
                       width)


def blend_tiles_multiround(mean2d, cov2d, colors, opacities, depths, valid,
                           height: int, width: int, bg_color: torch.Tensor,
                           tile: int = 32, per_round: int = 256,
                           rounds: int = 4, early_exit: bool = False,
                           tile_chunk: int = 16):
    """mean2d [N, 2] px, cov2d [N, 2, 2], colors [N, 3], opacities [N],
    depths [N], valid [N] -> (rgb [H, W, 3], depth [H, W], alpha [H, W]);
    of V views, each input but colors and each output with a leading V.
    Round r composites ranks [r k, (r + 1) k) of each tile's front-to-back
    list of intersecting Gaussians (k = per_round) behind the tile's
    transmittance; alpha is 1 - the final transmittance. A round visits
    only the tiles whose list reaches it (a round with no entries leaves a
    tile as it was), and with early_exit only those with a pixel whose
    transmittance is still > 1e-4."""
    views, arrays = as_views(mean2d, cov2d, opacities, depths, valid)
    V, N = arrays[3].shape
    order = sort_views(arrays[3], arrays[4])
    mean2d, cov2d, opacities, depths, valid = (
        a.reshape(V * N, *a.shape[2:]) for a in arrays)
    # colours and depths stay in input order: gathered per round by index
    mean2d, cov2d, opacities, valid = (
        a[order] for a in (mean2d, cov2d, opacities, valid))
    inter, conic, n_ty, n_tx = intersect_tiles(
        *(a.unflatten(0, (V, N)) for a in (mean2d, cov2d, opacities, valid)),
        height, width, tile)
    n_tiles, P = V * n_ty * n_tx, tile * tile
    inter, conic = inter.reshape(n_tiles, N), conic.reshape(V * N, 3)
    colors = colors.repeat(V, 1)
    rank = torch.cumsum(inter, dim=1, dtype=torch.int32)
    total = rank[:, -1]
    base = view_offsets(V, n_ty * n_tx, N, inter.device)
    k = min(per_round, N)
    oy, ox, py_loc, px_loc = _pixel_grid(n_ty, n_tx, tile, inter.device, V)
    trans = torch.ones(n_tiles, P, device=inter.device)
    rgb = torch.zeros(n_tiles, P, 3, device=inter.device)
    dep = torch.zeros(n_tiles, P, device=inter.device)
    for r in range(rounds):
        go = total > r * k
        if early_exit:
            go &= (trans > _T_EPS).any(-1)
        tiles = torch.nonzero(go)[:, 0]
        if tiles.numel() == 0:
            break
        idx, mask = rank_window(inter[tiles], k, r * k, rank[tiles])
        idx = idx + base[tiles]
        sid = order[idx]
        for s in range(0, tiles.numel(), tile_chunk):
            t = tiles[s:s + tile_chunk]
            i, m = idx[s:s + tile_chunk], mask[s:s + tile_chunk]
            alpha, t_in = _alphas(
                mean2d[i], conic[i], torch.where(m, opacities[i], 0.0), m,
                oy[t], ox[t], px_loc, py_loc)
            w = alpha * t_in * trans[t][:, :, None]  # [c, P, k]
            g = sid[s:s + tile_chunk]
            rgb[t] += w @ colors[g]
            dep[t] += (w @ depths[g][:, :, None])[..., 0]
            trans[t] *= torch.prod(1.0 - alpha, dim=-1)
    rgb = rgb + trans[..., None] * bg_color.to(rgb)
    return _stitch_all(rgb, dep, 1.0 - trans, views, n_ty, n_tx, tile,
                       height, width)


def _stitch_all(rgb, dep, acc, views, n_ty, n_tx, tile, height, width):
    """Per-tile [V * T, P(, C)] -> [V, H, W(, C)], cropped to the image;
    no view axis where views is None."""

    def stitch(a):
        c = a.shape[-1] if a.dim() == 3 else 1
        a = a.reshape(-1, n_ty, n_tx, tile, tile, c).permute(0, 1, 3, 2, 4, 5)
        a = a.reshape(-1, n_ty * tile, n_tx * tile, c)[:, :height, :width]
        a = a if c > 1 else a[..., 0]
        return a if views else a[0]

    return stitch(rgb), stitch(dep), stitch(acc)
