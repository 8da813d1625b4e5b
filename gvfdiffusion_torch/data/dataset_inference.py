"""In-the-wild inference dataset (port of gvfdiffusion_tpu/data/
dataset_inference.py; the reference's dataset/dataset_latent_inference.py).

Items come from a manifest (`name canonical_frame_idx` per line, by
default `<data_dir>/in_the_wild.txt`), each with its DINOv2 features
(`<name>/dinov2_features.npz`, "features" [T, L, 1024]) and, where
present, the canonical frame `canonical.png` and its matte
`canonical_mask.png`, read by utils/image.read_image as imageio reads
them (a grayscale file [H, W]) and scaled to [0, 1];
`cameras()` is the orbit rig of the outputs' render sweeps.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..representations.camera import orbit_camera
from ..utils.image import read_image


class InferenceDataset:
    def __init__(self, data_dir: str, manifest: Optional[str] = None,
                 num_views: int = 128, resolution: int = 512,
                 pitch_deg: float = 20.0, radius: float = 2.0):
        self.data_dir = data_dir
        self.num_views = num_views
        self.resolution = resolution
        self.pitch_deg = pitch_deg
        self.radius = radius
        manifest = manifest or os.path.join(data_dir, "in_the_wild.txt")
        self.items: List[Dict] = []
        if os.path.exists(manifest):
            with open(manifest) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    self.items.append({
                        "name": parts[0],
                        "canonical_idx": int(parts[1]) if len(parts) > 1
                        else 0,
                    })

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        it = self.items[idx]
        base = os.path.join(self.data_dir, it["name"])
        feats = np.load(os.path.join(base, "dinov2_features.npz"))["features"]
        entry = dict(it)
        entry["cond_images"] = feats.astype(np.float32)
        for key, file in (("canonical_image", "canonical.png"),
                          ("canonical_mask", "canonical_mask.png")):
            path = os.path.join(base, file)
            if os.path.exists(path):
                # a grayscale matte stays [H, W], as imageio reads it
                entry[key] = read_image(path, keep_gray=True).astype(
                    np.float32) / 255.0
        return entry

    def cameras(self):
        """The output orbit rig for this dataset's render sweeps."""
        return [orbit_camera(360.0 * v / self.num_views, self.pitch_deg,
                             radius=self.radius, height=self.resolution,
                             width=self.resolution)
                for v in range(self.num_views)]
