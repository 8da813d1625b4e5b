"""4D-sequence dataset for VAE training (port of
gvfdiffusion_tpu/data/dataset_vae.py).

Per object directory: `static_frame_vertices.pt` [N, 3] and
`moving_frame_deltas.pt` [T, N, 3] (re-canonicalized to frame 0), a
random subset of `num_points` points; `voxel_features.npz` (coords,
features, resolution) rescaled to the model's grid by a scatter-mean; and
`cameras.json`, per frame a list of views {image: a `.npy` uint8 file,
c2w: OpenGL camera-to-world, intrinsics}, of which `num_views` random
views of `num_timesteps` random frames are taken (OpenGL c2w -> COLMAP
w2c). Items are numpy, drawn from the same generators in the same order
as the JAX package's, so one seed gives both packages the same batches;
a batch's voxels pad into one SparseVoxels (`sparse/tensor.from_lists`).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..sparse.tensor import from_lists


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def opengl_to_colmap_w2c(c2w: np.ndarray) -> np.ndarray:
    """Blender / OpenGL camera-to-world -> COLMAP world-to-camera (y down,
    z forward)."""
    c2w = c2w.copy()
    c2w[:3, 1:3] *= -1
    return np.linalg.inv(c2w).astype(np.float32)


def rescale_voxel_coords(coords: np.ndarray, feats: np.ndarray, src_res: int,
                         dst_res: int):
    """Voxels of a src_res grid onto a dst_res grid, features averaged per
    destination cell; cells in linear-index order."""
    if src_res == dst_res:
        return coords, feats
    new = coords * dst_res // src_res
    key = new[:, 0] * dst_res * dst_res + new[:, 1] * dst_res + new[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    pooled = np.zeros((len(uniq), feats.shape[1]), feats.dtype)
    cnt = np.zeros(len(uniq), np.int64)
    np.add.at(pooled, inv, feats)
    np.add.at(cnt, inv, 1)
    pooled /= cnt[:, None]
    out = np.stack([uniq // (dst_res * dst_res), (uniq // dst_res) % dst_res,
                    uniq % dst_res], -1).astype(np.int32)
    return out, pooled


class VAEDataset:
    def __init__(self, data_dir: str, resolution: int = 64,
                 num_points: int = 4096, num_timesteps: int = 4,
                 num_views: int = 2, image_size: int = 512,
                 voxel_capacity: int = 32768, seed: int = 0):
        self.data_dir = data_dir
        self.resolution = resolution
        self.num_points = num_points
        self.num_timesteps = num_timesteps
        self.num_views = num_views
        self.image_size = image_size
        self.voxel_capacity = voxel_capacity
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.items: List[str] = sorted(
            d for d in os.listdir(data_dir)
            if os.path.exists(os.path.join(data_dir, d,
                                           "static_frame_vertices.pt"))
        ) if os.path.isdir(data_dir) else []

    def __len__(self) -> int:
        return len(self.items)

    def load_item(self, idx: int) -> Dict[str, np.ndarray]:
        base = os.path.join(self.data_dir, self.items[idx])
        verts = _to_np(_torch_load(
            os.path.join(base, "static_frame_vertices.pt"))).astype(np.float32)
        deltas = _to_np(_torch_load(
            os.path.join(base, "moving_frame_deltas.pt"))).astype(np.float32)
        verts = verts + deltas[0]
        deltas = deltas - deltas[0:1]
        if verts.shape[0] > self.num_points:
            sel = self.np_rng.choice(verts.shape[0], self.num_points,
                                     replace=False)
            verts, deltas = verts[sel], deltas[:, sel]

        z = np.load(os.path.join(base, "voxel_features.npz"))
        coords, feats = rescale_voxel_coords(
            z["coords"].astype(np.int32), z["features"].astype(np.float32),
            int(z.get("resolution", 64)), self.resolution)

        t_total = deltas.shape[0]
        t_sel = np.sort(self.np_rng.choice(
            t_total, min(self.num_timesteps, t_total), False))
        with open(os.path.join(base, "cameras.json")) as f:
            cams = json.load(f)
        images, extr, intr, frame_idx = [], [], [], []
        for t in t_sel:
            views = cams[str(t)] if isinstance(cams, dict) else cams[t]
            for v in self.np_rng.choice(len(views), self.num_views,
                                        replace=False):
                cam = views[v]
                img = np.load(os.path.join(base, cam["image"]))
                images.append(img.astype(np.float32) / 255.0)
                extr.append(opengl_to_colmap_w2c(
                    np.asarray(cam["c2w"], np.float32)))
                intr.append(np.asarray(cam["intrinsics"], np.float32))
                frame_idx.append(t)
        return dict(static_pc=verts, delta_pc=deltas, voxel_coords=coords,
                    voxel_feats=feats, images=np.stack(images),
                    extrinsics=np.stack(extr), intrinsics=np.stack(intr),
                    frame_idx=np.asarray(frame_idx, np.int32),
                    t_sel=t_sel.astype(np.int32))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        for _ in range(10):
            try:
                return self.load_item(idx)
            except Exception:
                idx = self.rng.randrange(len(self.items))
        raise RuntimeError("too many failed dataset reads")

    def collate(self, items: List[Dict[str, np.ndarray]]) -> Dict:
        """Items -> a batch: `feats` one SparseVoxels (CPU), the rest
        stacked numpy."""
        batch = {"feats": from_lists([it["voxel_coords"] for it in items],
                                     [it["voxel_feats"] for it in items],
                                     resolution=self.resolution,
                                     capacity=self.voxel_capacity)}
        for k in ("static_pc", "delta_pc", "images", "extrinsics",
                  "intrinsics", "frame_idx", "t_sel"):
            batch[k] = np.stack([it[k] for it in items])
        return batch


def load_data(dataset: VAEDataset, batch_size: int) -> Iterator[Dict]:
    """Endless batches: the items shuffled by the dataset's generator each
    pass (a dataset smaller than a batch repeats)."""
    order = list(range(len(dataset)))
    while order and len(order) < batch_size:
        order = order + order
    while True:
        dataset.rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield dataset.collate([dataset[j] for j in order[i:i + batch_size]])
