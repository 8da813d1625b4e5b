"""Quaternions and 3DGS covariances (port of
gvfdiffusion_tpu/ops/quaternion.py:16-80). Convention (w, x, y, z),
normalized before use."""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) -> [..., 3, 3] rotation matrices."""
    w, x, y, z = normalize(q).unbind(-1)
    rows = (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def build_covariance(scaling: torch.Tensor,
                     rotation: torch.Tensor) -> torch.Tensor:
    """R diag(s^2) R^T [..., 3, 3] from [..., 3] scales and [..., 4] quats,
    summed in the reference's order."""
    r = quat_to_rotmat(rotation)
    rs = r * (scaling ** 2)[..., None, :]
    return (rs[..., :, None, :] * r[..., None, :, :]).sum(-1)
