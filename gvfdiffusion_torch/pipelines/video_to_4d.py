"""Video -> 4D pipeline (port of gvfdiffusion_tpu/pipelines/video_to_4d.py).

Given DINOv2 video tokens and a canonical static GS, FPS-sample the DiT's
anchors, sample the Gaussian-Variation-Field latent with a CFG-wrapped
DPM-Solver++ (`VideoTo4DConfig.method`: multistep, or the adaptive solver of
the reference launch), decode per-frame per-Gaussian deltas with the motion
VAE (`run`), and render orbit sweeps of the animated splat (`render_4d`).

The cross-attention KV is hoisted out of the sampling loop (`hoists_kv`)
under guidance other than 1.0/1.0, as JAX does, and always for a DiT that
computes in bf16 or with an int8 setting: at 1.0/1.0 the hoisted cache
computes the same function as JAX's composed path, which projects the
conditioning inside every step, and lets a bf16 DiT take the four fused
sublayers. An fp32 DiT at 1.0/1.0 (the infer CLI's, as JAX's CLI builds it)
takes no cache and runs JAX's composed path: K5 and K6 on the card. With
`VideoTo4DConfig(kv_quant="int8")` the cache is stored int8 and the cross
sublayer runs its int8 form; with `self_quant="int8"` the self and
temporal sublayers take their QK products in int8.

The pipeline runs on `device`, "cuda" unless the caller asks for the CPU,
and moves its modules there; without a CUDA device it raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from ..diffusion.dpm_solver import DPMSolver, NoiseScheduleVP, model_wrapper
from ..diffusion.gaussian_diffusion import get_named_beta_schedule
from ..models.dit import DiT, check_quant
from ..models.motion_vae import MotionVAE
from ..render.renderer import GaussianRenderer, RenderOptions
from ..representations.gaussians import GaussianSplat
from ..utils.device import resolve_device
from ..utils.inference_utils import orbit_renders, sample_gs

# Gaussians per query chunk of the motion-VAE decode, as bench.py decodes
DECODE_CHUNK = 8192


@dataclasses.dataclass
class VideoTo4DConfig:
    """The JAX config's fields. `method` is the sampler's ("multistep",
    "adaptive", "singlestep" or "singlestep_fixed"); `num_frames` and
    `fps_anchor_points` are carried as in JAX, which reads neither (the
    frame count comes from the conditioning). `kv_quant` is the storage
    of the DiT's hoisted cross-attention KV: None (float, the JAX default
    with GVF_KV_QUANT unset) or "int8" (JAX's GVF_KV_QUANT=int8, which
    bench.py sets). `self_quant` is the DiT's self and temporal QK: None
    (bf16) or "int8" (JAX's GVF_SELF_QUANT=int8). Both are explicit fields
    here, not environment variables."""
    steps: int = 100
    order: int = 2
    method: str = "multistep"
    # 1.0/1.0 selects the single-conditional-pass CFG branch
    guidance_scale: float = 1.0
    guidance_scale2: float = 1.0
    noise_schedule: str = "cosine"
    diffusion_steps: int = 1000
    num_frames: int = 32
    num_latents: int = 512
    latent_dim: int = 16
    fps_anchor_points: int = 4096
    kv_quant: Optional[str] = None
    self_quant: Optional[str] = None

    def __post_init__(self):
        check_quant("kv_quant", self.kv_quant)
        check_quant("self_quant", self.self_quant)


class VideoTo4DPipeline:
    """Holds the DiT and the motion VAE (with their weights loaded), moved
    to `device`, and the renderer. `sample_info` holds the last sampling's
    counts: nfe, and for the adaptive solver iters, accepted, rejected and
    syncs."""

    def __init__(self, dit: DiT, motion_vae: MotionVAE,
                 config: Optional[VideoTo4DConfig] = None,
                 latent_mean: Optional[torch.Tensor] = None,
                 latent_std: Optional[torch.Tensor] = None,
                 render_options: Optional[RenderOptions] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dit = dit.to(self.device)
        self.vae = motion_vae.to(self.device)
        self.cfg = config or VideoTo4DConfig()
        self.latent_mean, self.latent_std = (
            None if a is None else a.to(self.device)
            for a in (latent_mean, latent_std))
        self.renderer = GaussianRenderer(render_options)
        betas = get_named_beta_schedule(self.cfg.noise_schedule,
                                        self.cfg.diffusion_steps)
        self.ns = NoiseScheduleVP.from_betas(betas)
        self.sample_info: Dict[str, int] = {}

    def hoists_kv(self) -> bool:
        """Whether sampling hoists the cross-attention KV: under guidance
        other than 1.0/1.0 (as JAX), for a DiT computing in bf16 (its fused
        path), or with an int8 setting (a setting of the cached path)."""
        cfg = self.cfg
        return (cfg.guidance_scale != 1.0 or cfg.guidance_scale2 != 1.0
                or self.dit.dtype == torch.bfloat16
                or cfg.kv_quant is not None or cfg.self_quant is not None)

    @torch.no_grad()
    def prepare_static_conditioning(self, static_gs_activated: torch.Tensor,
                                    valid: torch.Tensor) -> torch.Tensor:
        """FPS-sample `num_latents` anchors [B, num_latents, 14]."""
        return sample_gs(static_gs_activated, valid, self.cfg.num_latents)

    @torch.no_grad()
    def cross_kv(self, cond_images: torch.Tensor,
                 static_latent: torch.Tensor):
        """The DiT's per-block cross-attention KV for the batch the model
        sees: B rows at guidance 1.0/1.0, else the 3-way CFG batch in
        model_wrapper's order (full-uncond / uncond / cond)."""
        cfg = self.cfg
        if cfg.guidance_scale == 1.0 and cfg.guidance_scale2 == 1.0:
            return self.dit.kv_cache(cond_images, static_latent, cfg.kv_quant)
        zeros = torch.zeros_like(cond_images)
        c3 = torch.cat([zeros, zeros, cond_images])
        s3 = torch.cat([torch.zeros_like(static_latent), static_latent,
                        static_latent])
        return self.dit.kv_cache(c3, s3, cfg.kv_quant)

    @torch.no_grad()
    def sample_deformation_latent(self, cond_images: torch.Tensor,
                                  static_latent: torch.Tensor,
                                  positions: torch.Tensor,
                                  generator: Optional[torch.Generator] = None,
                                  noise: Optional[torch.Tensor] = None,
                                  cross_kv=None) -> torch.Tensor:
        """cond_images [B, T, L, 1024], static_latent [B, N, 14], positions
        [B, N, 3] -> the denormalized deformation latent [B, T, N, C].
        The initial noise is `noise`, or drawn from `generator`. A given
        `cross_kv` is used where the pipeline hoists the KV (`hoists_kv`);
        there it is otherwise built here."""
        cfg = self.cfg
        B, T = cond_images.shape[:2]
        # with the KV hoisted the DiT reads only positions, the same in every
        # CFG branch; without it guidance is 1.0/1.0, one conditional pass
        if self.hoists_kv():
            if cross_kv is None:
                cross_kv = self.cross_kv(cond_images, static_latent)
            cond = dict(positions=positions)
        else:
            cross_kv = None
            cond = dict(cond_images=cond_images, static_latent=static_latent,
                        positions=positions)

        def raw_model(x, t, positions, cross_kv=None, cond_images=None,
                      static_latent=None):
            return self.dit(x, t, cond_images, static_latent,
                            positions=positions, cross_kv=cross_kv,
                            self_quant=cfg.self_quant)

        model_fn = model_wrapper(
            raw_model, self.ns, model_type="v",
            guidance_type="classifier-free", condition=cond,
            unconditional_condition=cond,
            guidance_scale=cfg.guidance_scale,
            guidance_scale2=cfg.guidance_scale2, cross_kv=cross_kv)
        solver = DPMSolver(model_fn, self.ns, algorithm_type="dpmsolver++")
        if noise is None:
            noise = torch.randn(
                (B, T, cfg.num_latents, cfg.latent_dim),
                generator=generator, device=cond_images.device)
        x = solver.sample(noise.float(), steps=cfg.steps, order=cfg.order,
                          method=cfg.method,
                          return_info=cfg.method == "adaptive")
        self.sample_info = {"nfe": solver.nfe}
        if cfg.method == "adaptive":
            x, self.sample_info = x
        if self.latent_std is not None:
            x = x * self.latent_std
        if self.latent_mean is not None:
            x = x + self.latent_mean
        return x

    @torch.no_grad()
    def decode_deltas(self, latent: torch.Tensor,
                      static_gs_padded: torch.Tensor) -> torch.Tensor:
        """[B, T, N, C] latent -> [B, T, G, 14] per-Gaussian deltas."""
        B, T = latent.shape[:2]
        z = latent.reshape(B * T, latent.shape[2], latent.shape[3])
        return self.vae.decode(z, static_gs_padded, T, chunk_size=DECODE_CHUNK)

    @torch.no_grad()
    def run(self, canonical_gs_activated: torch.Tensor,
            gs_valid: torch.Tensor, cond_images: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None,
            timings: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
        """canonical_gs_activated [B, G, 14] padded, gs_valid [B, G],
        cond_images [B, T, L, 1024] -> latent, deltas [B, T, G, 14], anchors,
        on the pipeline's device (the inputs move there). A `timings` dict
        gets each stage's wall seconds (fps, sample, decode), the device
        synchronized after each."""
        canonical_gs_activated, gs_valid, cond_images = (
            a.to(self.device)
            for a in (canonical_gs_activated, gs_valid, cond_images))
        if noise is not None:
            noise = noise.to(self.device)
        clock = _StageClock(self.device, timings)
        anchors = self.prepare_static_conditioning(canonical_gs_activated,
                                                   gs_valid)
        clock.stop("fps")
        latent = self.sample_deformation_latent(
            cond_images, anchors, anchors[..., :3], generator=generator,
            noise=noise)
        clock.stop("sample")
        deltas = self.decode_deltas(latent, canonical_gs_activated)
        clock.stop("decode")
        return {"latent": latent, "deltas": deltas, "anchors": anchors}

    @torch.no_grad()
    def render_4d(self, gs: GaussianSplat, deltas: torch.Tensor,
                  valid: Optional[torch.Tensor] = None, num_views: int = 128,
                  resolution: int = 512, pitch_deg: float = 20.0,
                  radius: float = 2.0) -> torch.Tensor:
        """Frame t of deltas [T, G, 14] rendered from each of `num_views`
        orbit views at `pitch_deg` and `radius` -> [T, V, H, W, 3] float
        frames as a tensor on the splat's device (JAX returns a numpy
        array); see utils/inference_utils.orbit_renders."""
        return torch.stack(list(orbit_renders(
            self.renderer, gs, deltas, valid, num_views, resolution,
            pitch_deg, radius)))


class _StageClock:
    """Wall seconds per stage into `timings` (nothing without one), the
    device synchronized at each stop."""

    def __init__(self, device: torch.device, timings):
        self.device, self.timings = device, timings
        self.t = time.perf_counter()

    def stop(self, stage: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[stage] = now - self.t
        self.t = now
