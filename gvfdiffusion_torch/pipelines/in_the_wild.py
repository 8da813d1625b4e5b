"""The in-the-wild video -> 4D pipeline (port of
gvfdiffusion_tpu/pipelines/in_the_wild.py:37-116), the reference's
inference_dpm_latent.py stack:

  1. TRELLIS image -> 3D on the video's canonical frame -> canonical splat;
  2. azimuth alignment of the splat to that frame
     (utils/inference_utils.align_gaussian_to_canonical);
  3-5. VideoTo4DPipeline.run: FPS anchors, the DPM-Solver++ denoise of the
     deformation latent, the motion-VAE decode of per-frame deltas;
  6. `render_outputs`: the T x `render_views` orbit sweep, streamed in the
     spiral schedule into utils/inference_utils.StreamingVideoWriter
     (`spiral.mp4`, or `spiral.mp4.npy` without cv2) while the device
     renders the next timestep, then every frame as `frames.npy`.

One torch generator draws the noise of both pipelines in turn, where JAX
splits one key between them. The two pipelines run on their own devices
(the card unless the caller asked for the CPU).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..render.renderer import GaussianRenderer, RenderOptions
from ..utils.image import resize_bilinear
from ..utils.inference_utils import (StreamingVideoWriter,
                                     align_gaussian_to_canonical,
                                     render_sweep, spiral_frame_indices)
from .trellis_image_to_3d import TrellisImageTo3DPipeline
from .video_to_4d import VideoTo4DPipeline


@dataclasses.dataclass
class InTheWildConfig:
    """The JAX config's fields that run() and render_outputs() read
    (num_latents and max_gaussians are read by nothing there either)."""
    align_n_angles: int = 360        # a 1-degree grid for wild inputs
    align_synthetic_angles: int = 4  # a 90-degree grid for synthetic ones
    render_views: int = 128
    render_resolution: int = 512


class InTheWildPipeline:
    """TRELLIS, then the alignment, then the video -> 4D pipeline."""

    def __init__(self, trellis: TrellisImageTo3DPipeline,
                 video_to_4d: VideoTo4DPipeline,
                 config: Optional[InTheWildConfig] = None,
                 clip_score_fn: Optional[Callable] = None,
                 render_options: Optional[RenderOptions] = None):
        self.trellis = trellis
        self.v4d = video_to_4d
        self.cfg = config or InTheWildConfig()
        self.clip_score_fn = clip_score_fn
        self.renderer = GaussianRenderer(render_options or RenderOptions())

    @torch.no_grad()
    def run(self, canonical_image: np.ndarray, cond_images: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            canonical_alpha: Optional[np.ndarray] = None,
            synthetic: bool = False, align: bool = True) -> Dict[str, Any]:
        """canonical_image [H, W, 3|4] (the video's canonical frame),
        cond_images [T, L, 1024] (its DINOv2 video tokens) -> dict(gaussians
        (the aligned splat [G, ...]), valid [G], align_angle, align_scale,
        latent, deltas [1, T, G, 14], anchors)."""
        out = self.trellis.run(canonical_image, generator)
        gs, valid0 = out["gaussians"].select(0), out["valid"][0]

        angle, scale = 0.0, 1.0
        if align:
            n_angles = (self.cfg.align_synthetic_angles if synthetic
                        else self.cfg.align_n_angles)
            res = self.cfg.render_resolution
            target = resize_bilinear(torch.from_numpy(
                self.trellis.preprocess_image(canonical_image)), (res, res))
            gs, angle, scale = align_gaussian_to_canonical(
                gs, target, target_alpha=canonical_alpha, valid=valid0,
                n_angles=n_angles, renderer=self.renderer,
                clip_score_fn=self.clip_score_fn)

        res4d = self.v4d.run(gs.to_activated_tensor()[None], valid0[None],
                             cond_images[None], generator=generator)
        return {"gaussians": gs, "valid": valid0, "align_angle": angle,
                "align_scale": scale, **res4d}


    def render_outputs(self, result: Dict[str, Any], out_dir: str,
                       fps: int = 15) -> np.ndarray:
        """Stage 6: run()'s splat and deltas, T frames x render_views orbit
        views at render_resolution, streamed in the spiral schedule into
        out_dir/spiral.mp4 as each timestep lands, then all of them as
        out_dir/frames.npy; returns them, [T, V, H, W, 3] fp32."""
        os.makedirs(out_dir, exist_ok=True)
        deltas = result["deltas"][0]
        T, V = deltas.shape[0], self.cfg.render_views
        writer = StreamingVideoWriter(os.path.join(out_dir, "spiral.mp4"),
                                      fps=fps)
        by_t: Dict[int, list] = {}
        for i, (t, v) in enumerate(spiral_frame_indices(T, V)):
            by_t.setdefault(t, []).append((i, v))
        pending: Dict[int, Any] = {}
        next_i = 0

        def on_timestep(t, frames_t):
            nonlocal next_i
            for i, v in by_t.get(t, ()):
                pending[i] = frames_t[v]
            while next_i in pending:
                writer.append(pending.pop(next_i))
                next_i += 1

        frames = render_sweep(
            self.renderer, result["gaussians"], deltas, valid=result["valid"],
            num_views=V, resolution=self.cfg.render_resolution,
            on_timestep=on_timestep).numpy()
        writer.close()
        np.save(os.path.join(out_dir, "frames.npy"), frames)
        return frames
