"""Gaussian splats (port of gvfdiffusion_tpu/representations/gaussians.py
:33-194).

Raw parameters with activation biases, the aabb denormalization, and the
14-dim variation-field contract by which the motion
VAE's deltas animate the canonical Gaussians: delta[..., 0:3] xyz, 3:6
scale, 6:10 rotation, 10:13 SH DC, 13:14 opacity.

Only the configuration the pipeline uses is ported: exp scaling with a
bias of 0.01, an opacity bias of 0.1, no mip 3-D filter (minimum kernel
size 0). The softplus activation, other biases and kernel sizes, and
`detach_static` (the port runs no gradients through the renderer yet) are
not.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_ROT_BIAS = (1.0, 0.0, 0.0, 0.0)
_SCALE_BIAS_RAW = math.log(0.01)  # exp activation of a 0.01 scaling bias
_OPACITY_BIAS_RAW = math.log(0.1 / (1.0 - 0.1))  # inverse sigmoid of 0.1


@dataclasses.dataclass
class GaussianSplat:
    """Per-Gaussian raw parameters, leading dims arbitrary:
    _xyz [..., N, 3] in [0, 1] grid space; _features_dc [..., N, F, 3];
    _scaling [..., N, 3]; _rotation [..., N, 4] (wxyz); _opacity [..., N, 1];
    aabb [6] (x0, y0, z0, sx, sy, sz)."""

    _xyz: torch.Tensor
    _features_dc: torch.Tensor
    _scaling: torch.Tensor
    _rotation: torch.Tensor
    _opacity: torch.Tensor
    aabb: torch.Tensor

    def _rots_bias(self) -> torch.Tensor:
        return self._rotation.new_tensor(_ROT_BIAS)

    @staticmethod
    def _unit(r: torch.Tensor) -> torch.Tensor:
        return r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)

    # -- activated getters ---------------------------------------------------

    @property
    def get_xyz(self) -> torch.Tensor:
        return self._xyz * self.aabb[3:] + self.aabb[:3]

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self._scaling + _SCALE_BIAS_RAW)

    @property
    def get_rotation(self) -> torch.Tensor:
        return self._unit(self._rotation + self._rots_bias())

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self._opacity + _OPACITY_BIAS_RAW)

    @property
    def get_features(self) -> torch.Tensor:
        return self._features_dc

    @property
    def num_gaussians(self) -> int:
        return self._xyz.shape[-2]

    # -- the variation-field contract ---------------------------------------

    def apply_variation(self, delta: torch.Tensor) -> dict:
        """Activated attributes after a 14-dim per-Gaussian delta [..., N, 14]:
        dict(xyz, scaling, rotation, features [..., N, 1, 3], opacity)."""
        return dict(
            xyz=self.get_xyz + delta[..., 0:3],
            scaling=torch.exp(
                self._scaling + _SCALE_BIAS_RAW + delta[..., 3:6]),
            rotation=self._unit(
                self._rotation + self._rots_bias() + delta[..., 6:10]),
            features=self._features_dc + delta[..., None, 10:13],
            opacity=torch.sigmoid(
                self._opacity + _OPACITY_BIAS_RAW + delta[..., 13:14]),
        )

    def to_activated_tensor(self) -> torch.Tensor:
        """[..., N, 14] activated (xyz, scale, rot, dc, opacity), the form
        the motion VAE consumes."""
        return torch.cat([self.get_xyz, self.get_scaling, self.get_rotation,
                          self.get_features[..., 0, :], self.get_opacity], -1)


def from_activated(tensor: torch.Tensor,
                   aabb=(-0.5, -0.5, -0.5, 1.0, 1.0, 1.0)) -> GaussianSplat:
    """Invert the activations of a [..., N, 14] activated tensor. Scales
    clamp at 1e-10 and opacities into [1e-6, 1 - 1e-6], as the reference
    clamps them."""
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=tensor.device)
    scaling = torch.clamp(tensor[..., 3:6], min=1e-10)
    op = torch.clamp(tensor[..., 13:14], 1e-6, 1 - 1e-6)
    return GaussianSplat(
        _xyz=(tensor[..., 0:3] - aabb[:3]) / aabb[3:],
        _features_dc=tensor[..., None, 10:13],
        _scaling=torch.log(scaling) - _SCALE_BIAS_RAW,
        _rotation=tensor[..., 6:10] - tensor.new_tensor(_ROT_BIAS),
        _opacity=torch.log(op / (1 - op)) - _OPACITY_BIAS_RAW,
        aabb=aabb,
    )
