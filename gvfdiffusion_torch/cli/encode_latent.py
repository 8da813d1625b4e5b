"""Offline latent encoding CLI (port of gvfdiffusion_tpu/cli/encode_latent.py):
the step between the VAE trainer (cli/main_vae.py) and the DiT trainer
(cli/main_latent.py).

For each 4D training object of the VAE dataset it runs the static VAE
(encode to the posterior mean, decode, no render) to get the canonical
Gaussians, then the motion VAE's encoder (FPS anchors, KNN interpolation,
cross attention, posterior) to get the deformation latent, and writes
`<output_dir>/<object>/deformation_latent.pt`: a `torch.save` of CPU
tensors `latent_mean` and `latent_std` [T, num_latents, latent_dim],
`fps_sampled_gs_1024` and `fps_sampled_gs_4096` (farthest-point samples of
the canonical Gaussians, [min(n, G), 14] activated), `static_gs_feats` and
`static_gs_coords` (the object's padded voxel features and coordinates).
That is the file both latent datasets read; JAX's CLI writes the same
arrays as `deformation_latent.npz`, which neither dataset lists.

  python -m gvfdiffusion_torch.cli.encode_latent --config configs/vae.yml \\
      --data_dir=/path/to/4d_data --output_dir=/path/to/latents \\
      --static_ckpt=run/static_vae --motion_ckpt=run/motion_vae \\
      [--debug] [--shard=0 --num_shards=1] [--device=cpu] [--a.b=c ...]

The models are built by main_vae's builders from the config and each
takes the `params` of the newest trainer checkpoint in its directory
(`utils/checkpoint.restore_params`; a directory without one raises);
without a directory a model runs on its own initializers from a generator
seeded with 0, as JAX's runs on `init(PRNGKey(0))`. The dataset is built as
JAX's CLI builds it, from the resolution alone (4096 points and 4 frames
at most, drawn by its seeded generator). Items are split across processes
by the `torch.distributed` rank and world size when a process group is
initialized (else shard 0 of 1), or by `--shard` / `--num_shards`.
`--debug` also decodes the latent and logs the mean squared xyz delta.
Each item's log line gives its stage times and its launches of K7 (the
static VAE's full attention at `static_vae.attn_mode=full`). It runs on
the card unless `--device=cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..data.dataset_vae import VAEDataset
from ..models.sparse_vae import GSConfig, to_representation
from ..ops import flash_attention as fl
from ..ops.fps import fps_masked
from ..utils import logger
from ..utils.checkpoint import restore_params
from ..utils.config import load_config
from ..utils.device import resolve_device
from .main_vae import build_motion_vae, build_static_vae


def log(msg: str) -> None:
    logger.log(f"[encode_latent] {msg}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--static_ckpt", default=None)
    p.add_argument("--motion_ckpt", default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--shard", type=int, default=None)
    p.add_argument("--num_shards", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p


def process_shard():
    """(rank, world size) of the torch.distributed process group, or (0, 1)
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def load_model(module: torch.nn.Module, ckpt_dir, what: str, dev):
    """The module on `dev` with the seeded init, or the params of the newest
    checkpoint in `ckpt_dir` when one is given."""
    module.init_weights_(torch.Generator().manual_seed(0))
    module.to(dev).requires_grad_(False)
    if ckpt_dir:
        step = restore_params(module, ckpt_dir)
        log(f"{what} restored from {ckpt_dir} (step {step})")
    return module


def fps_sample(static_tensor: torch.Tensor, valid: torch.Tensor,
               n: int) -> torch.Tensor:
    """`n` farthest-point samples of the Gaussians [B, G, 14] by position
    -> [B, n, 14]."""
    idx = fps_masked(static_tensor[..., :3], valid, n)
    return torch.gather(static_tensor, 1,
                        idx[..., None].expand(-1, -1, static_tensor.shape[-1]))


@torch.no_grad()
def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    cfg = load_config(args.config, overrides)
    dev = resolve_device(args.device)
    logger.configure(args.output_dir)

    dataset = VAEDataset(args.data_dir, resolution=cfg.static_vae.resolution)
    rank, world = process_shard()
    shard = args.shard if args.shard is not None else rank
    num_shards = args.num_shards or world
    items = list(range(len(dataset)))[shard::num_shards]
    log(f"shard {shard}/{num_shards}: {len(items)} items")

    static_vae = load_model(build_static_vae(cfg), args.static_ckpt,
                            "static VAE", dev)
    motion_vae = load_model(build_motion_vae(cfg), args.motion_ckpt,
                            "motion VAE", dev)
    mv = cfg.motion_vae
    gs_cfg = GSConfig()
    os.makedirs(args.output_dir, exist_ok=True)

    def clock() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    for idx in items:
        name = dataset.items[idx]
        batch = dataset.collate([dataset[idx]])
        sv = batch["feats"]
        feats = sv.replace(feats=sv.feats.to(dev), coords=sv.coords.to(dev),
                           valid=sv.valid.to(dev))
        static_pc = torch.from_numpy(batch["static_pc"]).to(dev)
        delta_pc = torch.from_numpy(batch["delta_pc"]).to(dev)
        before, ms, t0 = dict(fl.launch_counts), {}, clock()

        # static encode -> decode (no render), the reference's
        # sparse_vae.py:376
        z, _, _ = static_vae.encode(feats)
        ms["static_encode"], t0 = (clock() - t0) * 1e3, clock()
        out = static_vae.decode(z)
        ms["static_decode"], t0 = (clock() - t0) * 1e3, clock()
        gs, gs_valid = to_representation(out, gs_cfg)
        static_tensor = gs.to_activated_tensor()  # [1, G, 14]

        _, mean, logvar, _ = motion_vae.encode(static_pc, delta_pc,
                                               static_tensor, gs_valid)
        std = torch.exp(0.5 * logvar)
        ms["motion_encode"], t0 = (clock() - t0) * 1e3, clock()

        # FPS samples of the canonical Gaussians at two densities (the
        # reference's encode_latent.py:119-138 sample_gs)
        G = static_tensor.shape[1]
        fps = {}
        for n in (1024, 4096):
            fps[n] = fps_sample(static_tensor, gs_valid, min(n, G))[0]
            ms[f"fps_{n}"], t0 = (clock() - t0) * 1e3, clock()

        out_path = os.path.join(args.output_dir, name)
        os.makedirs(out_path, exist_ok=True)
        T = delta_pc.shape[1]
        shape = (T, mv.num_latents, mv.latent_dim)
        torch.save({
            "latent_mean": mean.reshape(shape).cpu(),
            "latent_std": std.reshape(shape).cpu(),
            "fps_sampled_gs_1024": fps[1024].cpu(),
            "fps_sampled_gs_4096": fps[4096].cpu(),
            "static_gs_feats": feats.feats[0].cpu(),
            "static_gs_coords": feats.coords[0].cpu(),
        }, os.path.join(out_path, "deformation_latent.pt"))
        ms["save"] = (clock() - t0) * 1e3
        if not bool(torch.isfinite(mean).all()):
            log(f"WARNING: non-finite latent for {name}")
        if args.debug:
            deltas = motion_vae.decode(mean, static_tensor, T)
            err = float(torch.mean(deltas[..., :3] ** 2))
            log(f"{name}: delta-xyz ms {err:.6f}")
        launches = {k: n - before.get(k, 0)
                    for k, n in fl.launch_counts.items()
                    if n - before.get(k, 0)}
        log(f"{name}: latent {list(shape)}, {G} Gaussians; "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
            + f"; launches {json.dumps(launches)}")
        log(f"encoded {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
