"""Diffusion (DiT) training CLI (port of gvfdiffusion_tpu/cli/main_latent.py):
builds the DiT from the config at full width with flax's initializers, the
diffusion process, the uniform timestep sampler and the latent dataset,
then trains on one device with the warm-up / clip / AdamW / EMA step,
saves checkpoints and resumes from the newest one. It logs through
utils/logger.py into `exp_dir`, as JAX's trainer does: each logged step's
step, loss, mse, grad_norm and step_time go to stdout, `log.txt` and
`progress.csv` there, and its messages (with a one-line summary of each
logged step) to stderr.

Usage:
  python -m gvfdiffusion_torch.cli.main_latent --config configs/diffusion.yml \
      --data_dir=/path/to/latents --exp_dir=/path/to/run \
      [--train.total_steps=500000] [--device=cuda]

It runs on the card unless `--device=cpu` is given. Host loading and the
copy to the card run one batch ahead of the step in a background thread
(data/prefetch.py, as JAX's loop runs, its cli/main_latent.py:107-129),
the copy pinned and on a side CUDA stream; data parallelism (the JAX
package's parallel/) is not ported.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..data.dataset_latent import LatentDataset, load_data
from ..data.prefetch import DevicePlacer, Prefetcher
from ..diffusion.gaussian_diffusion import create_diffusion
from ..models.dit import DiT
from ..train.diffusion_trainer import make_train_step
from ..train.train_state import create_train_state, make_optimizer
from ..utils import logger
from ..utils.checkpoint import CheckpointManager, auto_resume
from ..utils.config import Config, load_config
from ..utils.device import resolve_device


def log(msg: str) -> None:
    logger.log(f"[main_latent] {msg}")


def build_model(cfg: Config) -> DiT:
    """The DiT of `cfg.model` in fp32 (the JAX DiT's default dtype), every
    field of the config passed on; the DiT's others (qk_rms_norm_cross,
    temporal_layout) keep their defaults, as in the JAX trainer.
    `model.remat_blocks` leading blocks are recomputed in the backward
    pass; left at 0, `train.mem_ratio` < 1 sets them through the
    reference's mapping (`DiT.mem_ratio_to_remat_blocks`)."""
    m = cfg.model
    model = DiT(resolution=m.resolution, in_channels=m.in_channels,
                model_channels=m.model_channels,
                static_cond_channels=m.static_cond_channels,
                image_cond_channels=m.image_cond_channels,
                out_channels=m.out_channels, num_blocks=m.num_blocks,
                num_heads=m.num_heads, mlp_ratio=m.mlp_ratio,
                pe_mode=m.pe_mode, share_mod=m.share_mod,
                qk_rms_norm=m.qk_rms_norm,
                no_temporal_attn=m.no_temporal_attn,
                remat_blocks=m.remat_blocks)
    if not model.remat_blocks:
        model.remat_blocks = model.mem_ratio_to_remat_blocks(
            cfg.train.mem_ratio)
    return model


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda")
    args, overrides = p.parse_known_args(argv)
    cfg = load_config(args.config, overrides)
    dev = resolve_device(args.device)
    logger.configure(cfg.exp_dir)
    log(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                            if dev.type == "cuda" else ""))

    model = build_model(cfg)
    model.init_weights_(torch.Generator().manual_seed(cfg.train.seed))
    model.to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"DiT parameters: {n_params / 1e6:.1f}M")
    d = cfg.diffusion
    diffusion = create_diffusion(
        schedule=d.noise_schedule, steps=d.steps, mean_type=d.predict_type,
        var_type=d.var_type, min_snr=d.min_snr,
        rescale_timesteps=d.rescale_timesteps).to(dev)

    dataset = LatentDataset(
        cfg.data_dir, num_frames=cfg.train.sample_timesteps,
        num_latents=cfg.model.resolution, latent_dim=cfg.model.in_channels,
        uncond_p=cfg.train.uncond_p, seed=cfg.train.seed)
    if len(dataset) == 0:
        log(f"no data found under {cfg.data_dir!r}; aborting")
        return 1
    data = load_data(dataset, cfg.train.batch_size)

    tx = make_optimizer(
        lr=cfg.train.lr, warmup_steps=cfg.train.warmup_steps,
        weight_decay=cfg.train.weight_decay, grad_clip=cfg.train.grad_clip,
        grad_accum=cfg.train.grad_accum)
    # the EMA moves every micro-step; r^(1/accum) keeps the reference's
    # once-per-optimizer-step horizon (train_latent.py:223)
    ema_rate = cfg.train.ema_rate ** (1.0 / max(cfg.train.grad_accum, 1))
    state = create_train_state(model, tx)
    ckpt = CheckpointManager(f"{cfg.exp_dir}/checkpoints")
    state, start_step = auto_resume(f"{cfg.exp_dir}/checkpoints", state)
    if start_step:
        log(f"auto-resumed from step {start_step} (micro-step {state.step})")
    step_fn = make_train_step(model, diffusion, tx, ema_rate=ema_rate)

    # host IO and the copy to the device run one batch ahead of the step
    with Prefetcher(data, place_fn=DevicePlacer(dev)) as prefetch:
        t_last = time.perf_counter()
        for step in range(state.step, cfg.train.total_steps):
            batch = next(prefetch)
            # a generator per step, seeded by the step, as JAX keys each step
            g = torch.Generator(device=dev).manual_seed(step)
            state, metrics = step_fn(state, batch, g)
            if step % cfg.train.log_interval == 0:
                now = time.perf_counter()
                step_time = (now - t_last) / max(cfg.train.log_interval, 1)
                t_last = now
                terms = {k: float(metrics[k]) for k in ("loss", "mse",
                                                         "grad_norm")}
                logger.logkv("step", step)
                logger.logkvs(terms)
                logger.logkv_mean("step_time", step_time)
                logger.dumpkvs()
                log(f"step {step} " + " ".join(f"{k} {v:.6g}"
                                               for k, v in terms.items())
                    + f" step_time {step_time:.4g} s")
            if step > 0 and step % cfg.train.save_interval == 0:
                ckpt.save(state, step)
    ckpt.save(state, cfg.train.total_steps, force=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
