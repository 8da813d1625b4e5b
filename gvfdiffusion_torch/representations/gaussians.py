"""Gaussian splats (port of gvfdiffusion_tpu/representations/gaussians.py
:33-194).

Raw parameters with activation biases, the aabb denormalization, and the
14-dim variation-field contract by which the motion
VAE's deltas animate the canonical Gaussians: delta[..., 0:3] xyz, 3:6
scale, 6:10 rotation, 10:13 SH DC, 13:14 opacity.

The activation config of the JAX splat is ported: exp (the default: a
scaling bias of 0.01, as the canonical splats of the video path) or
softplus scaling (the SLat Gaussian decoder's: a bias of 0.004), the
opacity bias, and the mip 3-D filter sqrt(s^2 + mininum_kernel_size^2)
(the reference's spelling), applied where the kernel size is not 0.
`detach_static` is not ported (the port runs no gradients through the
renderer yet).
"""

from __future__ import annotations

import dataclasses
import math

import torch

_ROT_BIAS = (1.0, 0.0, 0.0, 0.0)
_PER_GAUSSIAN = ("_xyz", "_features_dc", "_scaling", "_rotation", "_opacity")


def inverse_sigmoid(x: float) -> float:
    return math.log(x / (1.0 - x))


def inverse_softplus(x: float) -> float:
    """log(e^x - 1), in the stable form x + log(1 - e^-x)."""
    return x + math.log(-math.expm1(-x))


def _scale_bias_raw(activation: str, bias: float) -> float:
    if activation == "exp":
        return math.log(bias)
    if activation == "softplus":
        return inverse_softplus(bias)
    raise ValueError(activation)


@dataclasses.dataclass
class GaussianSplat:
    """Per-Gaussian raw parameters, leading dims arbitrary:
    _xyz [..., N, 3] in [0, 1] grid space; _features_dc [..., N, F, 3];
    _scaling [..., N, 3]; _rotation [..., N, 4] (wxyz); _opacity [..., N, 1];
    aabb [6] (x0, y0, z0, sx, sy, sz); and the activation config."""

    _xyz: torch.Tensor
    _features_dc: torch.Tensor
    _scaling: torch.Tensor
    _rotation: torch.Tensor
    _opacity: torch.Tensor
    aabb: torch.Tensor
    scaling_bias: float = 0.01
    opacity_bias: float = 0.1
    scaling_activation: str = "exp"
    mininum_kernel_size: float = 0.0

    def _scale_raw(self, delta=0.0) -> torch.Tensor:
        """Raw scaling + the bias (+ a delta), in the JAX order of sums."""
        return self._scaling + _scale_bias_raw(
            self.scaling_activation, self.scaling_bias) + delta

    def _opacity_raw(self, delta=0.0) -> torch.Tensor:
        return self._opacity + inverse_sigmoid(self.opacity_bias) + delta

    def _activate_scaling(self, raw: torch.Tensor) -> torch.Tensor:
        s = torch.exp(raw) if self.scaling_activation == "exp" else \
            torch.nn.functional.softplus(raw)
        if self.mininum_kernel_size:  # the mip 3-D filter
            s = torch.sqrt(s.square() + self.mininum_kernel_size ** 2)
        return s

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
        return self._activate_scaling(self._scale_raw())

    @property
    def get_rotation(self) -> torch.Tensor:
        return self._unit(self._rotation + self._rots_bias())

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self._opacity_raw())

    @property
    def get_features(self) -> torch.Tensor:
        return self._features_dc

    def select(self, index) -> "GaussianSplat":
        """Each per-Gaussian field indexed by `index`: a batch row of a
        [B, N, ...] splat, or a subset of the Gaussians of an [N, ...] one;
        the aabb and the activation config are kept."""
        return dataclasses.replace(self, **{k: getattr(self, k)[index]
                                            for k in _PER_GAUSSIAN})

    @property
    def num_gaussians(self) -> int:
        return self._xyz.shape[-2]

    # -- the variation-field contract ---------------------------------------

    def apply_variation(self, delta: torch.Tensor) -> dict:
        """Activated attributes after a 14-dim per-Gaussian delta [..., N, 14]:
        dict(xyz, scaling, rotation, features [..., N, 1, 3], opacity)."""
        return dict(
            xyz=self.get_xyz + delta[..., 0:3],
            scaling=self._activate_scaling(self._scale_raw(delta[..., 3:6])),
            rotation=self._unit(
                self._rotation + self._rots_bias() + delta[..., 6:10]),
            features=self._features_dc + delta[..., None, 10:13],
            opacity=torch.sigmoid(self._opacity_raw(delta[..., 13:14])),
        )

    def to_activated_tensor(self) -> torch.Tensor:
        """[..., N, 14] activated (xyz, scale, rot, dc, opacity), the form
        the motion VAE consumes."""
        return torch.cat([self.get_xyz, self.get_scaling, self.get_rotation,
                          self.get_features[..., 0, :], self.get_opacity], -1)


def from_activated(tensor: torch.Tensor,
                   aabb=(-0.5, -0.5, -0.5, 1.0, 1.0, 1.0),
                   scaling_bias: float = 0.01, opacity_bias: float = 0.1,
                   scaling_activation: str = "exp",
                   mininum_kernel_size: float = 0.0) -> GaussianSplat:
    """Invert the activations of a [..., N, 14] activated tensor (the mip
    filter is not inverted, as in the reference). Scales clamp at 1e-10
    (exp) or 1e-6 (softplus) and opacities into [1e-6, 1 - 1e-6], as the
    reference clamps them."""
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=tensor.device)
    bias_raw = _scale_bias_raw(scaling_activation, scaling_bias)
    if scaling_activation == "exp":
        raw_s = torch.log(torch.clamp(tensor[..., 3:6], min=1e-10)) - bias_raw
    else:
        s = torch.clamp(tensor[..., 3:6], min=1e-6)
        raw_s = s + torch.log(-torch.expm1(-s)) - bias_raw
    op = torch.clamp(tensor[..., 13:14], 1e-6, 1 - 1e-6)
    return GaussianSplat(
        _xyz=(tensor[..., 0:3] - aabb[:3]) / aabb[3:],
        _features_dc=tensor[..., None, 10:13],
        _scaling=raw_s,
        _rotation=tensor[..., 6:10] - tensor.new_tensor(_ROT_BIAS),
        _opacity=torch.log(op / (1 - op)) - inverse_sigmoid(opacity_bias),
        aabb=aabb, scaling_bias=scaling_bias, opacity_bias=opacity_bias,
        scaling_activation=scaling_activation,
        mininum_kernel_size=mininum_kernel_size)
