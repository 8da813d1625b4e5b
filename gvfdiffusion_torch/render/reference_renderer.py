"""Screen-space projection of 3D Gaussians (port of
gvfdiffusion_tpu/render/reference_renderer.py:25 `project_gaussians`).
The dense per-pixel rasterizer of that module is not ported."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.quaternion import build_covariance
from ..representations.camera import Camera


def project_gaussians(means3d: torch.Tensor, scales: torch.Tensor,
                      rotations: torch.Tensor, camera: Camera,
                      kernel_size_2d: float = 0.3, mip: bool = False,
                      cov3d: Optional[torch.Tensor] = None) -> dict:
    """EWA projection of N Gaussians. means3d [N, 3] world, scales [N, 3],
    rotations [N, 4] -> dict(mean2d [N, 2] px, cov2d [N, 2, 2], depth [N],
    in_front [N], compensation [N]). A camera of V views (world_view [V,
    4, 4], intrinsics [V, 3, 3]) gives each field a leading V. `mip=False`
    adds the classic low-pass kernel_size_2d (0.3 px); `mip=True` adds it
    with the Mip-Splatting opacity compensation."""
    dev = means3d.device
    w2c = camera.world_view.to(dev)
    intr = camera.intrinsics.to(dev)
    homog = torch.cat([means3d, means3d.new_ones(means3d.shape[0], 1)], -1)
    t = (homog @ w2c.transpose(-1, -2))[..., :3]  # camera-space positions
    depth = t[..., 2]
    in_front = depth > camera.near

    # per view, broadcast over the Gaussians
    fx = (intr[..., 0, 0] * camera.width)[..., None]
    fy = (intr[..., 1, 1] * camera.height)[..., None]
    cx = (intr[..., 0, 2] * camera.width)[..., None]
    cy = (intr[..., 1, 2] * camera.height)[..., None]
    tz = torch.clamp(depth, min=1e-6)
    # clamp x/y to 1.3x the frustum, as the CUDA rasterizer does
    lim_x = (1.3 * (0.5 / intr[..., 0, 0]))[..., None]
    lim_y = (1.3 * (0.5 / intr[..., 1, 1]))[..., None]
    txz = torch.clamp(t[..., 0] / tz, -lim_x, lim_x) * tz
    tyz = torch.clamp(t[..., 1] / tz, -lim_y, lim_y) * tz

    w = w2c[..., None, :3, :3]
    if cov3d is None:
        cov3d = build_covariance(scales, rotations)
    # J W Sigma W^T J^T, with J's two rows as combinations of W's rows
    ja = (fx / tz)[..., None] * w[..., 0, :] \
        - (fx * txz / tz ** 2)[..., None] * w[..., 2, :]
    jb = (fy / tz)[..., None] * w[..., 1, :] \
        - (fy * tyz / tz ** 2)[..., None] * w[..., 2, :]
    sa = (cov3d * ja[..., None, :]).sum(-1)
    sb = (cov3d * jb[..., None, :]).sum(-1)
    c00 = (sa * ja).sum(-1)
    c01 = (sa * jb).sum(-1)
    c11 = (sb * jb).sum(-1)
    det_raw = c00 * c11 - c01 * c01
    c00, c11 = c00 + kernel_size_2d, c11 + kernel_size_2d
    cov2d = torch.stack([torch.stack([c00, c01], -1),
                         torch.stack([c01, c11], -1)], -2)
    if mip:
        det_blur = c00 * c11 - c01 * c01
        compensation = torch.sqrt(torch.clamp(
            det_raw / torch.clamp(det_blur, min=1e-12), min=0.0))
    else:
        compensation = torch.ones_like(depth)
    mean2d = torch.stack([fx * t[..., 0] / tz + cx, fy * t[..., 1] / tz + cy],
                         -1)
    return dict(mean2d=mean2d, cov2d=cov2d, depth=depth, in_front=in_front,
                compensation=compensation)
