"""Two-phase VAE training CLI (port of gvfdiffusion_tpu/cli/main_vae.py):
phase A trains the static sparse-transformer VAE alone for
`train.static_vae_steps` steps; phase B then trains the static and the
motion VAE together with render losses, the static optimizer at `lr x
static_lr_scale`. One optimizer and one EMA per VAE, checkpoints under
`<exp_dir>/static_vae` and `<exp_dir>/motion_vae`, each resumed from its
newest step.

Usage:
  python -m gvfdiffusion_torch.cli.main_vae --config configs/vae.yml \\
      --data_dir=/path/to/4d_data --exp_dir=/path/to/run \\
      [--static_vae.attn_mode=full] [--train.total_steps=4] [--device=cpu]

It runs on the card unless `--device=cpu` is given, on one device: JAX's
mesh, `replicate` and `shard_batch` are identities at world size 1, and
data parallelism (the JAX package's parallel/) is not ported. It logs
through utils/logger.py into `exp_dir`, as JAX's trainer does: each logged
step's step, terms and step_time go to stdout, `log.txt` and
`progress.csv` there; its messages go to stderr, among them a line for
each logged step with its terms, its wall time, the peak device memory of
its phase and the step's launches of K7 (the flash attention of the
`full` mode) and its backward kernels.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from ..data.dataset_vae import VAEDataset, load_data
from ..models.motion_vae import MotionVAE
from ..models.sparse_vae import GSConfig
from ..models.static_vae import SparseTransformerVAE
from ..ops import flash_attention as fl
from ..render.renderer import RenderOptions
from ..train.train_state import (create_train_state, freeze_subtrees,
                                 make_optimizer)
from ..train.vae_trainer import make_joint_vae_step, make_static_vae_step
from ..utils import logger
from ..utils.checkpoint import CheckpointManager, auto_resume
from ..utils.config import Config, load_config
from ..utils.device import resolve_device
from ..utils.weight_convert import load_torch_checkpoint


def log(msg: str) -> None:
    logger.log(f"[main_vae] {msg}")


def build_static_vae(cfg: Config) -> SparseTransformerVAE:
    sv = cfg.static_vae
    return SparseTransformerVAE(
        resolution=sv.resolution, in_channels=sv.in_channels,
        model_channels=sv.model_channels, out_channels=sv.out_channels,
        latent_channels=sv.latent_channels, num_blocks=sv.num_blocks,
        num_heads=sv.num_heads, window_size=sv.window_size,
        attn_mode=sv.attn_mode, norm_output=sv.norm_output,
        remat_blocks=sv.remat_blocks)


def build_motion_vae(cfg: Config) -> MotionVAE:
    mv = cfg.motion_vae
    return MotionVAE(depth=mv.depth, dim=mv.dim, queries_dim=mv.queries_dim,
                     output_dim=mv.output_dim, num_inputs=mv.num_inputs,
                     num_latents=mv.num_latents, latent_dim=mv.latent_dim,
                     heads=mv.heads, knn_k=mv.knn_k, beta=mv.beta)


def init_static_from_torch(model: SparseTransformerVAE, ckpt_path: str
                           ) -> bool:
    """Load a torch `.pt` or `.safetensors` state dict under the reference's
    names into `model`, in place, with the reference's out-layer surgery:
    where the checkpoint's `out_layer` shape differs from the model's
    (TRELLIS ships a latent head, GVF trains the Gaussian head) the model
    keeps its fresh `out_layer`; every other parameter must be in the
    checkpoint (keys it holds beyond the model's are ignored, as JAX's
    converter ignores them). utils/weight_convert.load_torch_checkpoint
    reads it (a `module.` prefix stripped, a {"state_dict": ...} wrapper
    opened). Returns whether the out layer was kept fresh. A checkpoint
    in another layout raises."""
    sd = load_torch_checkpoint(ckpt_path)
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"{ckpt_path} is not a static VAE state dict under "
                       f"the reference's names: missing {missing[:4]}"
                       f"{' ...' if len(missing) > 4 else ''}")
    surgery = any(tuple(sd[k].shape) != tuple(own[k].shape)
                  for k in own if k.startswith("out_layer."))
    with torch.no_grad():
        for k, p in own.items():
            if surgery and k.startswith("out_layer."):
                continue
            if tuple(sd[k].shape) != tuple(p.shape):
                raise ValueError(f"{ckpt_path}: {k} is {tuple(sd[k].shape)}, "
                                 f"the model's {tuple(p.shape)}")
            p.copy_(sd[k])
    log(f"initialized static VAE from {ckpt_path}"
        + (", out_layer kept fresh (shape surgery)" if surgery else ""))
    return surgery


def to_device(batch: Dict, device) -> Dict:
    return {k: (v.replace(feats=v.feats.to(device), coords=v.coords.to(device),
                          valid=v.valid.to(device)) if k == "feats"
                else torch.from_numpy(np.asarray(v)).to(device))
            for k, v in batch.items()}


def _launches() -> Dict[str, int]:
    return {k: n for k, n in fl.launch_counts.items() if n}


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

    sv, tr = cfg.static_vae, cfg.train
    dataset = VAEDataset(cfg.data_dir, resolution=sv.resolution,
                         num_points=cfg.motion_vae.num_inputs,
                         num_timesteps=tr.sample_timesteps,
                         image_size=cfg.render.resolution,
                         voxel_capacity=sv.voxel_capacity)
    if len(dataset) == 0:
        log(f"no data found under {cfg.data_dir!r}; aborting")
        return 1
    data = load_data(dataset, tr.batch_size)
    next(data)  # JAX draws a batch to initialize the parameters from

    static_vae = build_static_vae(cfg)
    static_vae.init_weights_(torch.Generator().manual_seed(tr.seed))
    if tr.static_vae_init:
        init_static_from_torch(static_vae, tr.static_vae_init)
    static_vae.to(dev)
    motion_vae = build_motion_vae(cfg)
    log(f"static VAE parameters: "
        f"{sum(q.numel() for q in static_vae.parameters()) / 1e6:.1f}M, "
        f"attn_mode {sv.attn_mode}, remat_blocks {sv.remat_blocks}")

    opt = dict(warmup_steps=tr.warmup_steps, grad_clip=tr.grad_clip)
    static_tx = make_optimizer(lr=tr.lr * tr.static_lr_scale, **opt)
    static_tx_solo = make_optimizer(lr=tr.lr, **opt)
    if tr.static_vae_init and not tr.finetune_encoder:
        # the reference's frozen pretrained encoder (JAX's enc_* subtrees)
        static_tx = freeze_subtrees(static_tx, ("encoder.",))
        static_tx_solo = freeze_subtrees(static_tx_solo, ("encoder.",))
        log("encoder frozen (set train.finetune_encoder=true to train it)")
    motion_tx = make_optimizer(lr=tr.lr, **opt)

    static_state = create_train_state(static_vae, static_tx_solo)
    static_ckpt = CheckpointManager(f"{cfg.exp_dir}/static_vae")
    static_state, start = auto_resume(f"{cfg.exp_dir}/static_vae",
                                      static_state)
    if start:
        log(f"auto-resumed the static VAE from step {start}")

    r = cfg.render
    render_opts = RenderOptions(near=r.near, far=r.far,
                                bg_color=tuple(r.bg_color),
                                use_mip=r.use_mip,
                                kernel_size_2d=r.kernel_size_2d,
                                backend=r.backend,
                                max_per_tile=r.max_per_tile)
    gs_cfg = GSConfig()
    lpips_fn = None
    if cfg.loss.lambda_lpips > 0:
        from ..ops.lpips import load_lpips

        lpips_fn = load_lpips(cfg.loss.lpips_weights, dev)
        if lpips_fn is None:
            raise SystemExit(
                f"loss.lambda_lpips={cfg.loss.lambda_lpips} but no LPIPS "
                f"weights at loss.lpips_weights={cfg.loss.lpips_weights!r}. "
                "Write the torch vgg16+lin checkpoint as the .npz of "
                "gvfdiffusion_torch.ops.lpips.convert_torch_lpips and point "
                "loss.lpips_weights at it, or set loss.lambda_lpips=0 to "
                "train without the perceptual term.")
    loss_kw = dict(lambda_ssim=cfg.loss.lambda_ssim,
                   lambda_lpips=cfg.loss.lambda_lpips, lpips_fn=lpips_fn)
    static_step = make_static_vae_step(static_vae, static_tx_solo, gs_cfg,
                                       render_opts,
                                       lambda_kl=cfg.loss.lambda_kl, **loss_kw)

    motion_state = joint_step = None
    motion_ckpt = CheckpointManager(f"{cfg.exp_dir}/motion_vae")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_last = time.perf_counter()
    for step in range(start, tr.total_steps):
        batch = to_device(next(data), dev)
        g = torch.Generator(device=dev).manual_seed(step)
        before = _launches()
        if step < tr.static_vae_steps:
            phase = "A"
            static_state, terms, _ = static_step(static_state, batch, g)
        else:
            phase = "B"
            if motion_state is None:
                motion_vae.init_weights_(torch.Generator().manual_seed(tr.seed))
                motion_vae.to(dev)
                motion_state = create_train_state(motion_vae, motion_tx)
                motion_state, m_start = auto_resume(
                    f"{cfg.exp_dir}/motion_vae", motion_state)
                if m_start:
                    log(f"auto-resumed the motion VAE from step {m_start}")
                joint_step = make_joint_vae_step(
                    static_vae, motion_vae, static_tx, motion_tx, gs_cfg,
                    render_opts, lambda_kl=cfg.loss.lambda_kl,
                    lambda_xyz=cfg.loss.lambda_xyz, **loss_kw)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
            T = batch["delta_pc"].shape[1]
            batch.setdefault("frame_images", batch["images"])
            batch.setdefault("frame_extrinsics", batch["extrinsics"])
            batch.setdefault("frame_intrinsics", batch["intrinsics"])
            batch.setdefault("frame_idx",
                             torch.clamp(batch["frame_idx"], 0, T - 1))
            static_state, motion_state, terms = joint_step(
                static_state, motion_state, batch, g)
        if step % tr.log_interval == 0:
            after = _launches()
            now = time.perf_counter()
            peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                    if dev.type == "cuda" else float("nan"))
            launches = {k: n - before.get(k, 0) for k, n in after.items()
                        if n - before.get(k, 0)}
            step_time = (now - t_last) / max(tr.log_interval, 1)
            t_last = now
            logger.logkv("step", step)
            for k, v in terms.items():
                logger.logkv(k, float(v))
            logger.logkv_mean("step_time", step_time)
            logger.dumpkvs()
            log(f"step {step} phase {phase} "
                + " ".join(f"{k} {float(v):.6g}" for k, v in terms.items())
                + f" step_time {step_time:.4f} s peak_gib {peak:.3f} "
                f"launches {json.dumps(launches)}")
        if step > 0 and step % tr.save_interval == 0:
            static_ckpt.save(static_state, step)
            if motion_state is not None:
                motion_ckpt.save(motion_state, step)
    log(f"done; launches {json.dumps(_launches())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
