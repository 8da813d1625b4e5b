"""Quaternions and 3DGS covariances (port of
gvfdiffusion_tpu/ops/quaternion.py:12-80). Convention (w, x, y, z),
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


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w, x, y, z), branch-free Shepperd's method:
    each component's magnitude from the diagonal, the signs of x, y, z
    from the off-diagonal differences (w >= 0)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def mag(a):
        return 0.5 * torch.sqrt(torch.clamp(a, min=1e-12))

    def sign(d):
        return torch.sign(torch.where(d == 0, torch.ones_like(d), d))

    tr = m00 + m11 + m22
    return normalize(torch.stack([
        mag(1.0 + tr), mag(1.0 + m00 - m11 - m22) * sign(m21 - m12),
        mag(1.0 - m00 + m11 - m22) * sign(m02 - m20),
        mag(1.0 - m00 - m11 + m22) * sign(m10 - m01)], -1))


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Hamilton product a * b of [..., 4] (w, x, y, z) quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw], -1)


def build_covariance(scaling: torch.Tensor,
                     rotation: torch.Tensor) -> torch.Tensor:
    """R diag(s^2) R^T [..., 3, 3] from [..., 3] scales and [..., 4] quats,
    summed in the reference's order."""
    r = quat_to_rotmat(rotation)
    rs = r * (scaling ** 2)[..., None, :]
    return (rs[..., :, None, :] * r[..., None, :, :]).sum(-1)
