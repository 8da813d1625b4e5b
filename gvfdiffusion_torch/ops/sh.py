"""Spherical harmonics: the degree-0 colour (port of
gvfdiffusion_tpu/ops/sh.py:65). Higher degrees are not ported."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814


def rgb_from_sh_dc(dc: torch.Tensor) -> torch.Tensor:
    """Degree-0 colour with the 3DGS +0.5 offset: C0 * dc + 0.5."""
    return dc * C0 + 0.5
