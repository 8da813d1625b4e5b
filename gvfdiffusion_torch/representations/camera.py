"""Cameras: OpenCV-normalized intrinsics, COLMAP world-to-view extrinsics,
OpenGL projection (port of gvfdiffusion_tpu/representations/camera.py
:16-130). Matrices are float32 tensors on the CPU; the renderer moves them
to the Gaussians' device."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def intrinsics_to_projection(intrinsics: torch.Tensor, near: float,
                             far: float) -> torch.Tensor:
    """[3, 3] OpenCV normalized intrinsics -> [4, 4] OpenGL perspective."""
    fx, fy = float(intrinsics[0, 0]), float(intrinsics[1, 1])
    cx, cy = float(intrinsics[0, 2]), float(intrinsics[1, 2])
    return torch.tensor([
        [2 * fx, 0.0, 2 * cx - 1, 0.0],
        [0.0, 2 * fy, -2 * cy + 1, 0.0],
        [0.0, 0.0, far / (far - near), near * far / (near - far)],
        [0.0, 0.0, 1.0, 0.0],
    ], dtype=torch.float32, device=intrinsics.device)


@dataclasses.dataclass
class Camera:
    """A pinhole camera: world_view [4, 4] w2c (x right, y down, z
    forward), intrinsics [3, 3] normalized."""

    world_view: torch.Tensor
    intrinsics: torch.Tensor
    height: int = 512
    width: int = 512
    near: float = 0.01
    far: float = 100.0

    def replace(self, **changes) -> "Camera":
        return dataclasses.replace(self, **changes)

    @property
    def fov_x(self) -> torch.Tensor:
        return 2.0 * torch.atan(self.tan_fov_x)

    @property
    def fov_y(self) -> torch.Tensor:
        return 2.0 * torch.atan(self.tan_fov_y)

    @property
    def tan_fov_x(self) -> torch.Tensor:
        return 0.5 / self.intrinsics[0, 0]

    @property
    def tan_fov_y(self) -> torch.Tensor:
        return 0.5 / self.intrinsics[1, 1]

    @property
    def projection(self) -> torch.Tensor:
        return intrinsics_to_projection(self.intrinsics, self.near, self.far)

    @property
    def full_proj(self) -> torch.Tensor:
        """[4, 4] world -> clip (projection @ world_view)."""
        return self.projection @ self.world_view

    @property
    def campos(self) -> torch.Tensor:
        return torch.linalg.inv(self.world_view)[:3, 3]


def fov_intrinsics(fov_deg: float) -> np.ndarray:
    """Normalized intrinsics for a square image with the given FoV."""
    f = 0.5 / math.tan(math.radians(fov_deg) / 2)
    return np.array([[f, 0, 0.5], [0, f, 0.5], [0, 0, 1]], dtype=np.float32)


def lookat_extrinsics(eye, target=(0, 0, 0), up=(0, 0, 1)) -> np.ndarray:
    """[4, 4] world-to-view, COLMAP convention (z forward, y down)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r = np.stack([right, down, fwd], axis=0)  # world -> cam rotation
    w2c = np.eye(4, dtype=np.float64)
    w2c[:3, :3] = r
    w2c[:3, 3] = -r @ eye
    return w2c.astype(np.float32)


def orbit_camera(yaw_deg: float, pitch_deg: float, radius: float = 2.0,
                 fov_deg: float = 40.0, height: int = 512, width: int = 512,
                 target=(0.0, 0.0, 0.0)) -> Camera:
    """Orbit rig around `target`."""
    yaw, pitch = math.radians(yaw_deg), math.radians(pitch_deg)
    eye = np.array([radius * math.cos(pitch) * math.sin(yaw),
                    radius * math.cos(pitch) * math.cos(yaw),
                    radius * math.sin(pitch)]) + np.asarray(target)
    return Camera(world_view=torch.from_numpy(lookat_extrinsics(eye, target)),
                  intrinsics=torch.from_numpy(fov_intrinsics(fov_deg)),
                  height=height, width=width)


def orbit_cameras(num: int, pitch_deg: float = 20.0, **kw) -> tuple:
    """`num` orbit cameras at yaws 360 * i / num."""
    return tuple(orbit_camera(360.0 * i / num, pitch_deg, **kw)
                 for i in range(num))
