"""Front-to-back alpha compositing of binned Gaussians (port of
gvfdiffusion_tpu/ops/rasterize/xla_blend.py:18-82).

Tiles are blended `tile_chunk` at a time, so live memory is
O(tile_chunk * tile^2 * K) rather than O(pixels * N); the result does not
depend on the chunk. The multi-round, early-exit blend
(`blend_tiles_multiround`) is not ported.
"""

from __future__ import annotations

import torch

from .binning import BinnedGaussians


def _blend_chunk(mean2d, conic, color, opacity, depth, mask, oy, ox, px_loc,
                 py_loc, bg):
    """Tiles [c] of K Gaussians over their P = tile^2 pixels ->
    (rgb [c, P, 3], depth [c, P], alpha [c, P])."""
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
    # transmittance in front of each Gaussian, in the reference's form
    t_before = torch.cumprod(1.0 - alpha, dim=-1) / (1.0 - alpha + 1e-10)
    w = alpha * t_before  # [c, P, K]
    rgb = w @ color  # [c, P, 3]
    dep = (w @ depth[:, :, None])[..., 0]
    acc = w.sum(-1)
    return rgb + (1.0 - acc[..., None]) * bg, dep, acc


def blend_tiles(binned: BinnedGaussians, height: int, width: int,
                bg_color: torch.Tensor, tile_chunk: int = 64):
    """-> (rgb [H, W, 3], depth [H, W], alpha [H, W])."""
    tile, n_ty, n_tx = binned.tile, binned.n_tiles_y, binned.n_tiles_x
    kw = dict(device=binned.mean2d.device, dtype=torch.float32)
    oy = (torch.arange(n_ty, **kw) * tile).repeat_interleave(n_tx)
    ox = (torch.arange(n_tx, **kw) * tile).repeat(n_ty)
    py_loc = torch.arange(tile, **kw).repeat_interleave(tile) + 0.5
    px_loc = torch.arange(tile, **kw).repeat(tile) + 0.5
    bg = bg_color.to(**kw)
    fields = (binned.mean2d, binned.conic, binned.color, binned.opacity,
              binned.depth, binned.mask, oy, ox)
    outs = [_blend_chunk(*(a[s:s + tile_chunk] for a in fields), px_loc,
                         py_loc, bg)
            for s in range(0, n_ty * n_tx, tile_chunk)]
    rgb, dep, acc = (torch.cat(o) for o in zip(*outs))
    return _stitch_all(rgb, dep, acc, n_ty, n_tx, tile, height, width)


def _stitch_all(rgb, dep, acc, n_ty, n_tx, tile, height, width):
    """Per-tile [T, P(, C)] -> [H, W(, C)], cropped to the image."""

    def stitch(a):
        c = a.shape[-1] if a.dim() == 3 else 1
        a = a.reshape(n_ty, n_tx, tile, tile, c).permute(0, 2, 1, 3, 4)
        a = a.reshape(n_ty * tile, n_tx * tile, c)[:height, :width]
        return a if c > 1 else a[..., 0]

    return stitch(rgb), stitch(dep), stitch(acc)
