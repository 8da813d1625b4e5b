"""Brute-force k nearest neighbours and Gaussian-weighted delta
interpolation (port of gvfdiffusion_tpu/ops/knn.py): one pairwise
squared-distance matrix |a|^2 + |b|^2 - 2 a.b in fp32 (no TF32), then the
k smallest. At the motion VAE's sizes (512 anchors or 262144 Gaussians
against 8192 points) that is one matrix product per batch row.
"""

from __future__ import annotations

import torch


# queries per chunk: the joint VAE step asks for 262144 Gaussians' neighbours
# among 8192 points, a [B, 262144, 8192] fp32 matrix of 8.6 GB a batch row
_CHUNK = 16384


def knn_points(query: torch.Tensor, points: torch.Tensor, k: int):
    """query [B, Q, 3], points [B, N, 3] -> (squared distances [B, Q, k]
    ascending, indices [B, Q, k] int64), queries in chunks of _CHUNK."""
    p2 = (points ** 2).sum(-1)[:, None, :]
    d_out, i_out = [], []
    for s in range(0, query.shape[1], _CHUNK):
        q = query[:, s:s + _CHUNK]
        qp = torch.einsum("bqc,bnc->bqn", q, points)
        d2 = torch.clamp((q ** 2).sum(-1, keepdim=True) + p2 - 2.0 * qp,
                         min=0.0)
        neg, idx = torch.topk(-d2, k, dim=-1, sorted=True)
        d_out.append(-neg)
        i_out.append(idx)
    return torch.cat(d_out, 1), torch.cat(i_out, 1)


@torch.no_grad()
def interpolate_deltas(anchors: torch.Tensor, static_pc: torch.Tensor,
                       deltas: torch.Tensor, k: int = 8, beta: float = 7.0,
                       adaptive_radius: bool = True) -> torch.Tensor:
    """The per-point motion deltas [B, T, N, 3] of the point cloud
    static_pc [B, N, 3], interpolated onto anchors [B, A, 3] -> [B, T, A,
    3]: the k nearest points, weights exp(-beta d2 / r^2) with the adaptive
    radius r = sqrt(mean d2) + 1e-6 (and d2 <= r^2), normalized. No
    gradient flows (JAX stops it)."""
    d2, idx = knn_points(anchors, static_pc, k)
    radii = torch.sqrt(d2.mean(-1)) + 1e-6
    if adaptive_radius:
        r2 = radii[..., None] ** 2
        w = torch.exp(-beta * d2 / r2) * (d2 <= r2).to(d2.dtype)
    else:
        w = torch.exp(-beta * d2)
    w = w / (w.sum(-1, keepdim=True) + 1e-8)
    B, T = deltas.shape[:2]
    A = anchors.shape[1]
    flat = idx.reshape(B, 1, A * k, 1).expand(B, T, A * k, 3)
    nbr = torch.gather(deltas, 2, flat).reshape(B, T, A, k, 3)
    return torch.einsum("bak,btakc->btac", w, nbr)
