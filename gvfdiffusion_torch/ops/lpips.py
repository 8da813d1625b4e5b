"""LPIPS perceptual distance on VGG16 (port of gvfdiffusion_tpu/ops/lpips.py):
the features after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, each
unit-normalized over channels, squared differences weighted by a 1x1
linear head (no abs: the released heads are non-negative), averaged over
space and summed over the five layers.

Parameters carry the torchvision / reference names (`features.{i}` for
vgg16.features' convolutions, `lin{i}.model.1.weight` [1, C, 1, 1]);
`convert_torch_lpips` turns torchvision's `vgg16.features` and LPIPS's
heads into the flat `.npz` dict (`vgg/conv{j}/kernel` in HWIO,
`vgg/conv{j}/bias`, `lin{i}`), the same keys and arrays as JAX's
converter; `load_lpips` reads that `.npz` through
`utils/weights.lpips_table`. Without a weights file it returns None, and
the VAE trainer refuses to run with a non-zero LPIPS weight.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.misc import conv

# VGG16's plan: (out channels, convolutions) per stage
STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# vgg16.features' indices of the 13 convolutions
CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _Lin(nn.Module):
    """The reference's `lin{i}`: a bias-free 1x1 head at `model.1`."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.ModuleDict({"1": nn.Conv2d(channels, 1, 1,
                                                   bias=False)})


class LPIPS(nn.Module):
    """[B, H, W, 3] pairs in [0, 1] -> the per-sample distance [B], fp32."""

    def __init__(self):
        super().__init__()
        convs, c_in = [], 3
        for ch, n in STAGES:
            for _ in range(n):
                convs.append(nn.Conv2d(c_in, ch, 3, padding=1))
                c_in = ch
        self.features = nn.ModuleDict(
            {str(i): c for i, c in zip(CONV_INDEX, convs)})
        for i, (ch, _) in enumerate(STAGES):
            setattr(self, f"lin{i}", _Lin(ch))

    def vgg(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[B, 3, H, W] -> the five stages' relu outputs."""
        feats, ci = [], 0
        for si, (_, n) in enumerate(STAGES):
            for _ in range(n):
                layer = self.features[str(CONV_INDEX[ci])]
                x = F.relu(conv(F.conv2d, x, layer, torch.float32, padding=1))
                ci += 1
            feats.append(x)
            if si < len(STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift = x.new_tensor(_SHIFT)[:, None, None]
        scale = x.new_tensor(_SCALE)[:, None, None]

        def norm_input(img):
            return ((img.permute(0, 3, 1, 2) * 2.0 - 1.0) - shift) / scale

        total = 0.0
        for i, (a, b) in enumerate(zip(self.vgg(norm_input(x)),
                                       self.vgg(norm_input(y)))):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}").model["1"].weight.reshape(1, -1, 1, 1)
            total = total + ((a - b) ** 2 * w).sum(1).mean((1, 2))
        return total


def load_lpips(weights_path: Optional[str],
               device="cuda") -> Optional[LPIPS]:
    """The LPIPS module (lpips(x, y) -> [B]) on `device`, its parameters
    frozen, or None without a weights file."""
    if not weights_path or not os.path.exists(weights_path):
        return None
    from ..models.registry import load_params
    from ..utils.weights import from_flax, lpips_table

    model = LPIPS()
    model.load_state_dict(from_flax(lpips_table(), load_params(weights_path)))
    return model.to(device).requires_grad_(False)


def convert_torch_lpips(vgg_state: Dict[str, Any],
                        lin_state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """torchvision's vgg16.features state dict (`features.{i}.weight` /
    `.bias` at CONV_INDEX) and the LPIPS heads (`lin{i}.model.1.weight` [1,
    C, 1, 1]), tensors or arrays -> the flat dict that JAX's
    `convert_torch_lpips` returns (np.savez it for `load_lpips`)."""
    from ..models.registry import flatten_tree
    from ..utils.weights import lpips_table, to_flax

    return flatten_tree(to_flax(lpips_table(), {**vgg_state,
                                                **lin_state})["params"])
