"""Video -> 4D inference CLI (port of gvfdiffusion_tpu/cli/infer.py).

Reads precomputed conditioning (an npz with `canonical_gs` [G, 14], the
activated canonical splat, and `cond_images` [T, L, 1024], DINOv2 tokens)
and writes the deformation latent and per-frame deltas
(`deformation.npz`), orbit renders (`frames.npy`, [T, V, H, W, 3] at
min(num_views, 8) views) and, where imageio imports and can write it, an
mp4 of the first view; else it logs "mp4 export skipped". The logger
(utils/logger.py) writes the sampler's counts and the stage times to
`progress.csv` in the output directory.

The reference launch:
  python -m gvfdiffusion_torch.cli.infer --input cond.npz --output_dir out \\
      --dit_ckpt run/checkpoints --vae_ckpt vae_run/motion_vae \\
      --adaptive --use_fp16 --num_timesteps 32 [--device cpu]

The models are built as JAX's CLI builds them, in fp32 (`--use_fp16` is
accepted and changes nothing, as in JAX), from the config's `model` and
`motion_vae` sections through the trainers' `build_model` and
`build_motion_vae`; each takes the `params` of the newest trainer
checkpoint in its directory
(`utils/checkpoint.restore_params`), or without one the module's own
initializers from a generator seeded with `--seed`. At the default
guidance 1.0/1.0 the fp32 DiT runs the composed path (K5, K6). It runs on
the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..pipelines.video_to_4d import VideoTo4DConfig, VideoTo4DPipeline
from ..render.renderer import RenderOptions
from ..representations.gaussians import from_activated
from ..utils import logger
from ..utils.checkpoint import restore_params
from ..utils.config import load_config
from ..utils.device import resolve_device
from .main_latent import build_model
from .main_vae import build_motion_vae


def build_parser() -> argparse.ArgumentParser:
    """JAX's flags and defaults (the reference launch passes --adaptive
    --use_fp16 --num_timesteps 32 and no guidance flags, so guidance stays
    at 1.0/1.0, the single conditional pass), plus `--device`."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None)
    p.add_argument("--input", required=True,
                   help="npz with canonical_gs [G,14], cond_images [T,L,1024]")
    p.add_argument("--output_dir", default="out_4d")
    p.add_argument("--dit_ckpt", default=None)
    p.add_argument("--vae_ckpt", default=None)
    # the reference's name for the solver's step count (default 100);
    # --steps is an alias and must agree with it when both are given
    p.add_argument("--rescale_timesteps", type=int, default=100)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--order", type=int, default=2)
    p.add_argument("--adaptive", action="store_true")
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--guidance_scale2", type=float, default=1.0)
    # the frame count comes from the input npz; checked against this
    p.add_argument("--num_timesteps", type=int, default=None)
    # accepted so that the reference launch parses; the models stay fp32
    p.add_argument("--use_fp16", action="store_true")
    p.add_argument("--num_views", type=int, default=128)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def parse_args(argv=None):
    """(parser, args, config overrides). A `--steps` that disagrees with an
    explicitly given `--rescale_timesteps` is an error (JAX takes --steps
    silently)."""
    p = build_parser()
    args, overrides = p.parse_known_args(argv)
    probe = build_parser()
    for action in probe._actions:
        action.default = argparse.SUPPRESS
    given, _ = probe.parse_known_args(argv)
    if (args.steps is not None and hasattr(given, "rescale_timesteps")
            and args.steps != args.rescale_timesteps):
        p.error(f"--steps {args.steps} disagrees with --rescale_timesteps "
                f"{args.rescale_timesteps}")
    return p, args, overrides


def pipeline_config_from_args(args, num_frames: int, num_latents: int,
                              latent_dim: int) -> VideoTo4DConfig:
    """args -> VideoTo4DConfig, the mapping tests/test_infer_cli_flags.py
    pins for JAX."""
    steps = args.steps if args.steps is not None else args.rescale_timesteps
    return VideoTo4DConfig(
        steps=steps, order=args.order,
        method="adaptive" if args.adaptive else "multistep",
        guidance_scale=args.guidance_scale,
        guidance_scale2=args.guidance_scale2,
        num_frames=num_frames, num_latents=num_latents,
        latent_dim=latent_dim)


def _load_or_init(module: torch.nn.Module, ckpt_dir, seed: int, what: str):
    if ckpt_dir:
        step = restore_params(module, ckpt_dir)
        logger.log(f"{what}: restored step {step} from {ckpt_dir}")
    else:
        module.init_weights_(torch.Generator().manual_seed(seed))
        logger.log(f"{what}: no checkpoint given, its initializers under "
                   f"seed {seed}")


def main(argv=None) -> int:
    p, args, overrides = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config, overrides)
    logger.configure(args.output_dir)

    data = np.load(args.input)
    canonical_gs = torch.from_numpy(
        np.asarray(data["canonical_gs"], np.float32))[None]
    cond_images = torch.from_numpy(
        np.asarray(data["cond_images"], np.float32))[None]
    gs_valid = torch.ones(canonical_gs.shape[:2], dtype=torch.bool)
    T = cond_images.shape[1]
    if args.num_timesteps is not None and args.num_timesteps != T:
        p.error(f"--num_timesteps {args.num_timesteps} != input frame count "
                f"{T}")

    dit = build_model(cfg).to(dev).eval()
    vae = build_motion_vae(cfg).to(dev).eval()
    _load_or_init(dit, args.dit_ckpt, args.seed, "DiT")
    _load_or_init(vae, args.vae_ckpt, args.seed, "motion VAE")

    m, r = cfg.model, cfg.render
    pipeline = VideoTo4DPipeline(
        dit, vae, pipeline_config_from_args(
            args, num_frames=T, num_latents=m.resolution,
            latent_dim=m.in_channels),
        render_options=RenderOptions(
            near=r.near, far=r.far, bg_color=tuple(r.bg_color),
            use_mip=r.use_mip, kernel_size_2d=r.kernel_size_2d,
            backend=r.backend, max_per_tile=r.max_per_tile),
        device=dev)

    g = torch.Generator(device=dev).manual_seed(args.seed)
    times = {}
    out = pipeline.run(canonical_gs, gs_valid, cond_images, generator=g,
                       timings=times)
    os.makedirs(args.output_dir, exist_ok=True)
    np.savez(os.path.join(args.output_dir, "deformation.npz"),
             latent=out["latent"].cpu().numpy(),
             deltas=out["deltas"].cpu().numpy())
    logger.log(f"latent {tuple(out['latent'].shape)}, deltas "
               f"{tuple(out['deltas'].shape)}")

    t0 = time.perf_counter()
    gs = from_activated(canonical_gs[0].to(dev))
    frames = pipeline.render_4d(
        gs, out["deltas"][0], valid=gs_valid[0].to(dev),
        num_views=min(args.num_views, 8), resolution=args.resolution)
    frames = frames.cpu().numpy()
    times["render"] = time.perf_counter() - t0
    np.save(os.path.join(args.output_dir, "frames.npy"), frames)
    try:
        import imageio

        imageio.mimsave(os.path.join(args.output_dir, "video.mp4"),
                        (np.clip(frames[:, 0], 0, 1) * 255).astype(np.uint8),
                        fps=8)
    except Exception as e:  # imageio or its codec may be absent
        logger.log(f"mp4 export skipped: {e}")

    for k, v in pipeline.sample_info.items():
        logger.logkv(k, v)
    for k, v in times.items():
        logger.logkv(f"{k}_s", v)
    logger.dumpkvs()
    logger.log(f"wrote {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
