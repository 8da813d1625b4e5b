"""TRELLIS image -> 3D: the canonical Gaussian splat from one image (port
of gvfdiffusion_tpu/pipelines/trellis_image_to_3d.py:36-226).

  1. preprocess (host): alpha crop with a 1.2x bbox margin, 518^2 resize;
     an RGB image's alpha comes from `matting_fn` (models/modnet.py's
     make_matting_fn) where one is given, else the whole image is kept;
  2. DINOv2 tokens of the image (models/dinov2.py);
  3. the sparse-structure flow (12 Euler steps, CFG 7.5) -> 16^3 x 8
     latent -> the occupancy decoder -> occupied 64^3 voxels (logits > 0);
  4. the SLat flow on those voxels (12 steps, CFG 3 inside the guidance
     interval), then the SLat normalization;
  5. the SLat Gaussian decoder -> GaussianSplat [B, L * 8] and validity.

The pipeline runs on `device`, "cuda" unless the caller asks for the CPU,
and moves its modules there; without a CUDA device it raises. Only the
Gaussian format is decoded (`decode_slat_formats`, `run(formats=...)`):
"mesh" and "radiance_field" raise, their decoders not being ported. The
models come from their constructors or from a pretrained directory
(models/registry.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..diffusion.flow_euler import FlowEulerGuidanceIntervalSampler
from ..models.dinov2 import DinoV2, encode_image
from ..models.trellis.slat_decoders import SLatGaussianDecoder
from ..models.trellis.slat_flow import SLatFlowModel
from ..models.trellis.ss_flow import SparseStructureFlowModel
from ..models.trellis.ss_vae import SparseStructureDecoder
from ..utils.image import resize_bilinear
from ..sparse.tensor import SparseVoxels, from_dense
from ..utils.device import resolve_device


def check_formats(formats) -> None:
    """JAX's formats are "gaussian", "mesh" and "radiance_field"; the mesh
    and radiance-field SLat decoders are not ported (ROADMAP queue 1, item
    6), so asking for them raises, as does an unknown name."""
    unported = [f for f in formats if f in ("mesh", "radiance_field")]
    if unported:
        raise NotImplementedError(
            f"{unported}: the mesh and radiance-field SLat decoders are not "
            "ported (ROADMAP queue 1, item 6)")
    unknown = [f for f in formats if f != "gaussian"]
    if unknown:
        raise ValueError(f"unknown formats {unknown}")


@dataclasses.dataclass
class TrellisConfig:
    ss_steps: int = 12
    ss_cfg: float = 7.5
    slat_steps: int = 12
    slat_cfg: float = 3.0
    slat_cfg_interval: tuple = (0.5, 1.0)
    ss_resolution: int = 16
    grid_resolution: int = 64
    voxel_capacity: int = 32768
    rescale_t: float = 3.0


class TrellisImageTo3DPipeline:
    """Holds the five models (their weights loaded), moved to `device`."""

    def __init__(self, dinov2: DinoV2, ss_flow: SparseStructureFlowModel,
                 ss_decoder: SparseStructureDecoder,
                 slat_flow: SLatFlowModel, slat_decoder: SLatGaussianDecoder,
                 config: Optional[TrellisConfig] = None,
                 slat_mean: Optional[torch.Tensor] = None,
                 slat_std: Optional[torch.Tensor] = None, device="cuda",
                 matting_fn: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.matting_fn = matting_fn
        self.dinov2, self.ss_flow, self.ss_decoder, self.slat_flow, \
            self.slat_decoder = (m.to(self.device) for m in (
                dinov2, ss_flow, ss_decoder, slat_flow, slat_decoder))
        self.cfg = config or TrellisConfig()
        self.slat_mean, self.slat_std = (
            None if a is None else a.to(self.device)
            for a in (slat_mean, slat_std))

    def preprocess_image(self, image: np.ndarray) -> np.ndarray:
        """[H, W, 3|4] uint8 or float -> [518, 518, 3] float32 in [0, 1]:
        the object (alpha > 0.5: the fourth channel, else matting_fn's
        matte, else the whole image) centred with a 1.2x bbox margin, RGB
        times alpha."""
        img = np.asarray(image).astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        if img.shape[-1] == 4:
            alpha, rgb = img[..., 3], img[..., :3]
        elif self.matting_fn is not None:
            alpha, rgb = np.asarray(self.matting_fn(img)), img
        else:
            alpha, rgb = np.ones(img.shape[:2], np.float32), img
        ys, xs = np.where(alpha > 0.5)
        if len(ys) == 0:
            ys, xs = np.arange(img.shape[0]), np.arange(img.shape[1])
        cy, cx = (ys.min() + ys.max()) / 2, (xs.min() + xs.max()) / 2
        half = max(ys.max() - ys.min(), xs.max() - xs.min()) / 2 * 1.2
        y0, y1 = int(max(cy - half, 0)), int(min(cy + half, img.shape[0]))
        x0, x1 = int(max(cx - half, 0)), int(min(cx + half, img.shape[1]))
        crop = rgb[y0:y1, x0:x1] * alpha[y0:y1, x0:x1, None]
        return resize_bilinear(torch.from_numpy(np.ascontiguousarray(crop)),
                               (518, 518)).numpy()

    @torch.no_grad()
    def encode_image(self, images: torch.Tensor,
                     impl: Optional[str] = None) -> torch.Tensor:
        """[B, 518, 518, 3] in [0, 1] -> tokens [B, 1374, 1024] fp32."""
        return encode_image(self.dinov2, images.to(self.device), impl=impl)

    @torch.no_grad()
    def sample_ss_latent(self, cond: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None,
                         impl: Optional[str] = None) -> torch.Tensor:
        """cond [B, L, C] -> the sparse-structure latent [B, r, r, r, C_in]
        (fp32). The noise is `noise`, or drawn from `generator`."""
        c = self.cfg
        r, ch = c.ss_resolution, self.ss_flow.in_channels
        if noise is None:
            noise = torch.randn((cond.shape[0], r, r, r, ch),
                                generator=generator, device=cond.device)
        return FlowEulerGuidanceIntervalSampler().sample(
            lambda x, t, cc: self.ss_flow(x, t, cc, impl=impl),
            noise.to(cond.device).float(), cond=cond,
            neg_cond=torch.zeros_like(cond), steps=c.ss_steps,
            cfg_strength=c.ss_cfg, rescale_t=c.rescale_t)["samples"]

    @torch.no_grad()
    def decode_structure(self, z: torch.Tensor) -> SparseVoxels:
        """The occupancy decoder on the latent: the voxels whose logit is
        > 0, at the grid resolution, in `voxel_capacity` slots."""
        logits = self.ss_decoder(z)
        occupancy = (logits[..., 0] > 0).float()[..., None]
        return from_dense(occupancy, capacity=self.cfg.voxel_capacity,
                          threshold=0.5)

    def sample_sparse_structure(self, cond: torch.Tensor,
                                generator: Optional[torch.Generator] = None,
                                noise: Optional[torch.Tensor] = None,
                                impl: Optional[str] = None) -> SparseVoxels:
        """cond [B, L, C] -> the occupied voxels (the JAX stage, as
        sample_ss_latent then decode_structure)."""
        return self.decode_structure(
            self.sample_ss_latent(cond, generator, noise, impl))

    @torch.no_grad()
    def sample_slat(self, structure: SparseVoxels, cond: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    noise_feats: Optional[torch.Tensor] = None,
                    impl: Optional[str] = None) -> SparseVoxels:
        """Latent features on the occupied voxels. The noise [B, L, C_in]
        is `noise_feats`, or drawn from `generator`."""
        c = self.cfg
        if noise_feats is None:
            noise_feats = torch.randn(
                structure.feats.shape[:2] + (self.slat_flow.in_channels,),
                generator=generator, device=cond.device)
        mask = structure.valid[..., None].float()
        noise = noise_feats.to(cond.device).float() * mask

        def model(x_feats, t, cc):
            x = structure.replace(feats=x_feats * mask)
            return self.slat_flow(x, t, cc, impl=impl).feats

        z = FlowEulerGuidanceIntervalSampler().sample(
            model, noise, cond=cond, neg_cond=torch.zeros_like(cond),
            steps=c.slat_steps, cfg_strength=c.slat_cfg,
            cfg_interval=c.slat_cfg_interval,
            rescale_t=c.rescale_t)["samples"]
        if self.slat_std is not None:
            z = z * self.slat_std
        if self.slat_mean is not None:
            z = z + self.slat_mean
        return structure.replace(feats=z * mask)

    @torch.no_grad()
    def decode_slat(self, slat: SparseVoxels, impl: Optional[str] = None):
        """-> (GaussianSplat [B, L * 8], valid [B, L * 8])."""
        return self.slat_decoder(slat, impl=impl)

    def decode_slat_formats(self, slat: SparseVoxels,
                            formats=("gaussian",)) -> Dict[str, Any]:
        """The decodes `formats` asks for, by name: "gaussian" ->
        (GaussianSplat, valid)."""
        check_formats(formats)
        return {"gaussian": self.decode_slat(slat)} \
            if "gaussian" in formats else {}

    @torch.no_grad()
    def run(self, image: np.ndarray,
            generator: Optional[torch.Generator] = None,
            formats=("gaussian",)) -> Dict[str, Any]:
        """One image [H, W, 3|4] -> dict(structure, slat, cond) and, with
        "gaussian" in `formats`, gaussians and valid; on the pipeline's
        device."""
        check_formats(formats)  # before any work
        pre = torch.from_numpy(self.preprocess_image(image))[None]
        cond = self.encode_image(pre)
        structure = self.sample_sparse_structure(cond, generator)
        slat = self.sample_slat(structure, cond, generator)
        out = dict(structure=structure, slat=slat, cond=cond)
        decoded = self.decode_slat_formats(slat, formats)
        if "gaussian" in decoded:
            out["gaussians"], out["valid"] = decoded["gaussian"]
        return out
