"""Farthest-point sampling (port of gvfdiffusion_tpu/ops/fps.py: `fps`,
`fps_batched` and `fps_masked`, over padded point sets).

A loop of `num_samples - 1` batched tensor steps that stays on the device:
no step reads a value back to the host.
"""

from __future__ import annotations

import torch


def fps_masked(points: torch.Tensor, valid: torch.Tensor,
               num_samples: int) -> torch.Tensor:
    """points [B, N, 3], valid [B, N] bool -> [B, num_samples] int64 indices.

    Starts at the first valid point; padded points are never selected (their
    distance is forced to -inf). Ties go to the lowest index, as jnp.argmax.
    """
    B, n = points.shape[:2]
    points = points.float()
    neg = torch.where(valid, 0.0, float("-inf")).to(points)
    idxs = torch.zeros(B, num_samples, dtype=torch.long, device=points.device)
    idxs[:, 0] = torch.argmax(valid.to(torch.uint8), dim=1)
    min_d2 = torch.full((B, n), float("inf"), device=points.device)
    rows = torch.arange(B, device=points.device)
    for i in range(1, num_samples):
        last = points[rows, idxs[:, i - 1]]  # [B, 3]
        d2 = ((points - last[:, None]) ** 2).sum(-1)
        min_d2 = torch.minimum(min_d2, d2)
        idxs[:, i] = torch.argmax(min_d2 + neg, dim=1)
    return idxs


def fps(points: torch.Tensor, num_samples: int,
        start_idx: int = 0) -> torch.Tensor:
    """points [N, 3] -> [num_samples] int64 indices, starting at
    `start_idx`; ties go to the lowest index."""
    return fps_batched(points[None], num_samples, start_idx)[0]


def fps_batched(points: torch.Tensor, num_samples: int,
                start_idx: int = 0) -> torch.Tensor:
    """points [B, N, 3] -> [B, num_samples] int64 indices, each row from
    `start_idx`."""
    B, n = points.shape[:2]
    points = points.float()
    idxs = torch.zeros(B, num_samples, dtype=torch.long, device=points.device)
    idxs[:, 0] = start_idx
    min_d2 = torch.full((B, n), float("inf"), device=points.device)
    rows = torch.arange(B, device=points.device)
    for i in range(1, num_samples):
        last = points[rows, idxs[:, i - 1]]
        min_d2 = torch.minimum(min_d2, ((points - last[:, None]) ** 2).sum(-1))
        idxs[:, i] = torch.argmax(min_d2, dim=1)
    return idxs
