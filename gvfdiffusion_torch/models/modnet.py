"""MODNet, trimap-free matting (port of gvfdiffusion_tpu/models/modnet.py):
a MobileNetV2 encoder and MODNet's three branches (Ke et al., AAAI 2022),

  LR branch      the semantic estimate from enc32x (SE-gated, at 1/8)
  HR branch      boundary detail from enc2x / enc4x and downscaled images
  fusion branch  semantic + detail -> the full-resolution matte,

and `make_matting_fn`, the `matting_fn(img [H, W, 3]) -> alpha [H, W]`
hook of pipelines/trellis_image_to_3d.py and scripts/process_video.py.

NCHW here, NHWC in JAX. There is no reference torch checkpoint of this
design, so the modules and parameters go by the flax tree's names
(`backbone.InvertedResidual_3.ConvBNReLU_1.Conv_0.weight` is flax's
`params/backbone/InvertedResidual_3/ConvBNReLU_1/Conv_0/kernel`; a
BatchNorm's running statistics are flax's `batch_stats` mean and var):
utils/weights.modnet_table carries a tree either way. BatchNorm runs in
eval mode (JAX's `train=False`, the only mode its callers use). flax's
`Conv` pads "SAME": the low side gets total // 2 of total = max((out - 1)
* stride + k - in, 0), so a stride-2 3x3 conv on an even size pads (0, 1),
where torch's `padding=1` would pad (1, 1). Convolutions run in fp32 (no
TF32 on the card, as XLA computes them: nn/misc.conv_weights). Resizes
are `jax.image.resize(..., "bilinear")`'s (utils/image.py).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.misc import conv_weights
from ..utils.image import resize_bilinear


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax's "SAME" padding of a k x k, stride-s convolution."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad: last dim first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Conv(nn.Conv2d):
    """flax `nn.Conv` with "SAME" padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__(cin, cout, k, stride=stride, groups=groups,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_weights(F.conv2d, _same_pad(x, self.kernel_size[0],
                                                self.stride[0]),
                            self.weight, self.bias, stride=self.stride,
                            groups=self.groups)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(use_running_average=True)`, epsilon 1e-5."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, 1e-5)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride, groups, bias=False)
        self.BatchNorm_0 = BatchNorm(cout)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu6(x) if self.act else x


class InvertedResidual(nn.Module):
    """MobileNetV2 block: 1x1 expand -> 3x3 depthwise -> 1x1 project."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int):
        super().__init__()
        hidden = cin * expand
        layers = [ConvBNReLU(cin, hidden, 1)] if expand != 1 else []
        layers += [ConvBNReLU(hidden, hidden, 3, stride, groups=hidden),
                   ConvBNReLU(hidden, cout, 1, act=False)]
        for i, layer in enumerate(layers):
            self.add_module(f"ConvBNReLU_{i}", layer)
        self.n = len(layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n):
            h = getattr(self, f"ConvBNReLU_{i}")(h)
        return x + h if self.residual else h


class MobileNetV2Encoder(nn.Module):
    """The MobileNetV2 trunk and MODNet's three taps: enc2x (stride 2),
    enc4x (stride 4), enc32x (stride 32)."""

    # (expand, channels, repeats, stride): the published configuration
    CFG: Sequence[Tuple[int, int, int, int]] = (
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
        (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self, width: float = 1.0):
        super().__init__()
        c = lambda ch: max(8, int(ch * width))  # noqa: E731
        self.ConvBNReLU_0 = ConvBNReLU(3, c(32), 3, stride=2)
        cin, n = c(32), 0
        self.taps = {}  # stage -> the block whose output it taps
        for si, (expand, ch, reps, stride) in enumerate(self.CFG):
            for i in range(reps):
                self.add_module(f"InvertedResidual_{n}", InvertedResidual(
                    cin, c(ch), stride if i == 0 else 1, expand))
                cin, n = c(ch), n + 1
            if si in (0, 1):  # enc2x, enc4x: the ends of stages 0 and 1
                self.taps[n - 1] = si
        self.n_blocks = n
        self.ConvBNReLU_1 = ConvBNReLU(cin, c(1280), 1)
        self.channels = (c(16), c(24), c(1280))

    def forward(self, x: torch.Tensor):
        h = self.ConvBNReLU_0(x)
        taps = []
        for i in range(self.n_blocks):
            h = getattr(self, f"InvertedResidual_{i}")(h)
            if i in self.taps:
                taps.append(h)
        return taps[0], taps[1], self.ConvBNReLU_1(h)


class SEBlock(nn.Module):
    def __init__(self, c: int, reduction: int = 4):
        super().__init__()
        self.Dense_0 = nn.Linear(c, max(1, c // reduction))
        self.Dense_1 = nn.Linear(max(1, c // reduction), c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = F.relu(self.Dense_0(x.mean((2, 3))))
        w = torch.sigmoid(self.Dense_1(w))
        return x * w[:, :, None, None]


class MODNet(nn.Module):
    """img [B, 3, H, W] in [-1, 1] -> (semantic [B, 1, H/8, W/8], detail
    [B, 1, H, W], matte [B, 1, H, W]), each sigmoid-activated."""

    def __init__(self, hr_channels: int = 32, backbone_width: float = 1.0):
        super().__init__()
        self.hr_channels, self.backbone_width = hr_channels, backbone_width
        hr = hr_channels
        self.backbone = MobileNetV2Encoder(backbone_width)
        c2, c4, c32 = self.backbone.channels
        self.se = SEBlock(c32)
        self.conv_lr16x = ConvBNReLU(c32, 2 * hr, 5)
        self.conv_lr8x = ConvBNReLU(2 * hr, hr, 5)
        self.conv_lr = Conv(hr, 1, 3)
        self.tohr_enc2x = ConvBNReLU(c2, hr, 1)
        self.conv_enc2x = ConvBNReLU(3 + hr, hr, 3)
        self.tohr_enc4x = ConvBNReLU(c4, hr, 1)
        self.conv_enc4x = ConvBNReLU(2 * hr, 2 * hr, 3)
        self.conv_hr4x = ConvBNReLU(2 * hr + hr + 3, 2 * hr, 3)
        self.conv_hr2x = ConvBNReLU(2 * hr + hr, hr, 3)
        self.conv_hr = ConvBNReLU(hr + 3, hr, 3)
        self.conv_hr_out = Conv(hr, 1, 1)
        self.conv_f2x = ConvBNReLU(2 * hr, hr, 3)
        self.conv_f = ConvBNReLU(hr + 3, max(hr // 2, 8), 3)
        self.conv_f_out = Conv(max(hr // 2, 8), 1, 1)

    def forward(self, img: torch.Tensor):
        H, W = img.shape[2:]
        img2x, img4x = _resize(img, H // 2, W // 2), _resize(img, H // 4,
                                                              W // 4)
        enc2x, enc4x, enc32x = self.backbone(img)

        # the LR (semantic) branch
        lr16x = self.conv_lr16x(_resize(self.se(enc32x), H // 16, W // 16))
        lr8x = self.conv_lr8x(_resize(lr16x, H // 8, W // 8))
        semantic = torch.sigmoid(self.conv_lr(lr8x))

        # the HR (detail) branch
        hr2x_in = self.conv_enc2x(torch.cat([img2x, self.tohr_enc2x(enc2x)],
                                            1))
        hr4x = self.conv_enc4x(torch.cat([_resize(hr2x_in, H // 4, W // 4),
                                          self.tohr_enc4x(enc4x)], 1))
        hr4x = self.conv_hr4x(torch.cat(
            [hr4x, _resize(lr8x, H // 4, W // 4), img4x], 1))
        hr2x = self.conv_hr2x(torch.cat([_resize(hr4x, H // 2, W // 2),
                                         hr2x_in], 1))
        detail_feat = self.conv_hr(torch.cat([_resize(hr2x, H, W), img], 1))
        detail = torch.sigmoid(self.conv_hr_out(detail_feat))

        # the fusion branch
        f2x = self.conv_f2x(torch.cat([_resize(lr8x, H // 2, W // 2), hr2x],
                                      1))
        f = self.conv_f(torch.cat([_resize(f2x, H, W), img], 1))
        matte = torch.sigmoid(self.conv_f_out(f))
        return semantic, detail, matte


def preprocess_size(h: int, w: int, ref_size: int = 512) -> Tuple[int, int]:
    """The reference inference script's sizing rule
    (scripts/inference_MODNet.py:62-80): scale so the short side is near
    ref_size (only if outside [ref, 2*ref] or smaller), then snap both sides
    down to multiples of 32."""
    if max(h, w) < ref_size or min(h, w) > ref_size:
        if w >= h:
            rh = ref_size
            rw = int(w / h * ref_size)
        else:
            rw = ref_size
            rh = int(h / w * ref_size)
    else:
        rh, rw = h, w
    return rh - rh % 32, rw - rw % 32


def make_matting_fn(model: MODNet, ref_size: int = 512) -> Callable:
    """The `matting_fn(img [H, W, 3] in [0, 1] or [0, 255]) -> alpha [H, W]
    float32 in [0, 1]` hook: the image resized to preprocess_size, scaled
    to [-1, 1], the fused matte resized back; on the model's device."""
    model.eval()

    @torch.no_grad()
    def matting_fn(img: np.ndarray) -> np.ndarray:
        img = np.asarray(img, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        h, w = img.shape[:2]
        rh, rw = preprocess_size(h, w, ref_size)
        dev = next(model.parameters()).device
        x = resize_bilinear(torch.from_numpy(img[None]).to(dev), (rh, rw))
        _, _, matte = model(x.permute(0, 3, 1, 2) * 2.0 - 1.0)
        matte = resize_bilinear(matte.permute(0, 2, 3, 1), (h, w))
        return np.clip(matte[0, :, :, 0].cpu().numpy(), 0.0, 1.0)

    return matting_fn
