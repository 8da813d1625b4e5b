"""Deformation-latent dataset for diffusion training (port of
gvfdiffusion_tpu/data/dataset_latent.py:38-143).

Each object directory holds `deformation_latent.pt` ({latent_mean,
latent_std [T, N, C], fps_sampled_gs_1024 [1024, 14], ...}) and, where
present, `dinov2_features.npz` ("features" [T, L, 1024]). An item draws
the latent by the reparameterization mean + std * eps, normalizes latent
and static conditioning with the global mean/std files when given, picks
a random sorted subset of `num_frames` frames, and drops the image
conditioning with probability `uncond_p`. A failed read retries a random
other item. Items and batches are numpy, drawn from the same generators
in the same order as the JAX package's, so one seed gives both packages
the same batches.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class LatentDataset:
    def __init__(self, data_dir: str, stats_dir: Optional[str] = None,
                 num_frames: int = 24, num_latents: int = 512,
                 latent_dim: int = 16, uncond_p: float = 0.1, seed: int = 0):
        self.data_dir = data_dir
        self.num_frames = num_frames
        self.num_latents = num_latents
        self.latent_dim = latent_dim
        self.uncond_p = uncond_p
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.items: List[str] = sorted(
            d for d in os.listdir(data_dir)
            if os.path.exists(os.path.join(data_dir, d,
                                           "deformation_latent.pt"))
        ) if os.path.isdir(data_dir) else []
        # global normalization stats (reference dataset_latent.py:113-119)
        self.deform_mean = self.deform_std = None
        self.static_mean = self.static_std = None
        if stats_dir:
            def load_stat(name):
                p = os.path.join(stats_dir, name)
                return _to_np(_torch_load(p)) if os.path.exists(p) else None

            self.deform_mean = load_stat("deformation_latent_mean.pt")
            self.deform_std = load_stat("deformation_latent_std.pt")
            self.static_mean = load_stat("static_gs_mean.pt")
            self.static_std = load_stat("static_gs_std.pt")

    def __len__(self) -> int:
        return len(self.items)

    def load_item(self, idx: int) -> Dict[str, np.ndarray]:
        name = self.items[idx]
        d = _torch_load(os.path.join(self.data_dir, name,
                                     "deformation_latent.pt"))
        mean = _to_np(d["latent_mean"]).astype(np.float32)  # [T, N, C]
        std = _to_np(d["latent_std"]).astype(np.float32)
        latent = mean + std * self.np_rng.standard_normal(mean.shape).astype(
            np.float32)
        if self.deform_mean is not None:
            latent = (latent - self.deform_mean) / (self.deform_std + 1e-8)
        static = _to_np(d["fps_sampled_gs_1024"]).astype(
            np.float32)[: self.num_latents]
        if self.static_mean is not None:
            static = (static - self.static_mean) / (self.static_std + 1e-8)
        feat_path = os.path.join(self.data_dir, name, "dinov2_features.npz")
        if os.path.exists(feat_path):
            cond = np.load(feat_path)["features"].astype(np.float32)
        else:
            cond = np.zeros((latent.shape[0], 1, 1024), np.float32)
        # a random sorted subset of frames (reference :120)
        t_total = latent.shape[0]
        if t_total > self.num_frames:
            sel = np.sort(self.np_rng.choice(t_total, self.num_frames,
                                             replace=False))
            latent, cond = latent[sel], cond[sel]
        # conditioning dropout (reference :138-141)
        if self.rng.random() < self.uncond_p:
            cond = np.zeros_like(cond)
        return dict(latent=latent, cond_images=cond, static_latent=static,
                    positions=static[..., :3])

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        for _ in range(10):
            try:
                return self.load_item(idx)
            except Exception:
                idx = self.rng.randrange(len(self.items))
        raise RuntimeError("too many failed dataset reads")


def load_data(dataset: LatentDataset, batch_size: int,
              shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches of stacked numpy items; a dataset smaller than one
    batch repeats itself to fill it."""
    order = list(range(len(dataset)))
    while len(order) < batch_size:
        order = order + order
    while True:
        if shuffle:
            dataset.rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [dataset[j] for j in order[i:i + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
