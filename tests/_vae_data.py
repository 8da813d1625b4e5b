"""A seeded 4D training directory in the VAE dataset's layout, shared by
the VAE port tests: per object `static_frame_vertices.pt` [N, 3],
`moving_frame_deltas.pt` [T, N, 3], `voxel_features.npz` (coords in a
res^3 grid, features, resolution) and `cameras.json` with uint8 `.npy`
images, every camera on an orbit around the origin."""

import json

import numpy as np
import torch

from gvfdiffusion_torch.representations.camera import orbit_camera


def orbit_c2w(yaw_deg: float, pitch_deg: float, radius: float):
    """The OpenGL camera-to-world of `orbit_camera`'s view (the dataset's
    camera convention; it inverts this with `opengl_to_colmap_w2c`) and
    its normalized intrinsics."""
    cam = orbit_camera(yaw_deg, pitch_deg, radius=radius)
    c2w = np.linalg.inv(cam.world_view.numpy().astype(np.float64))
    c2w[:3, 1:3] *= -1
    return c2w, cam.intrinsics.numpy()


def write_vae_dir(root, objects: int = 1, points: int = 32, frames: int = 3,
                  views: int = 3, voxels: int = 20, res: int = 16,
                  channels: int = 8, image: int = 16, seed: int = 0):
    """Write `objects` seeded object directories under `root` (a Path)."""
    rng = np.random.default_rng(seed)
    for o in range(objects):
        d = root / f"obj{o}"
        d.mkdir(parents=True)
        torch.save(torch.from_numpy(
            (rng.standard_normal((points, 3)) * 0.2).astype(np.float32)),
            d / "static_frame_vertices.pt")
        torch.save(torch.from_numpy(
            (rng.standard_normal((frames, points, 3)) * 0.02).astype(
                np.float32)), d / "moving_frame_deltas.pt")
        cells = rng.choice(res ** 3, voxels, replace=False)
        coords = np.stack(np.unravel_index(cells, (res,) * 3), -1)
        np.savez(d / "voxel_features.npz", coords=coords.astype(np.int32),
                 features=rng.standard_normal(
                     (voxels, channels)).astype(np.float32),
                 resolution=res)
        cams = {}
        for t in range(frames):
            vs = []
            for v in range(views):
                name = f"img_{t}_{v}.npy"
                np.save(d / name, (rng.random((image, image, 3)) * 255
                                   ).astype(np.uint8))
                c2w, intr = orbit_c2w(120.0 * v + 10 * t, 20.0, 1.2)
                vs.append({"image": name, "c2w": c2w.tolist(),
                           "intrinsics": intr.tolist()})
            cams[str(t)] = vs
        (d / "cameras.json").write_text(json.dumps(cams))
