"""In-the-wild video preprocessing: video file -> frames -> mattes -> DINOv2
tokens (port of gvfdiffusion_tpu/scripts/process_video.py).

  1. `extract_frames`: ffmpeg at `fps`; without ffmpeg, the first
     `max_frames` frames through a video reader, cv2's where it is
     installed, else imageio's (JAX's reader), as `frame_%04d.png`;
  2. the matting hook: a caller's `matting_fn(img) -> alpha [H, W]`
     (models/modnet.make_matting_fn), else the image's own alpha channel;
  3. `normalize_frame`: the masked object centred at 380 px inside a white
     512 px canvas;
  4. DINOv2's per-frame tokens (`encode_video` on frames in memory,
     `encode_video_features` on a frames directory, written as
     `np.savez(out_path, features=...)`).

    python -m gvfdiffusion_torch.scripts.process_video --video in.mp4 \\
        --out_dir out/ [--fps 8] [--max_frames 32] [--device cpu]

Resizes are bilinear with half-pixel centres and, when shrinking, an
antialiasing triangle filter widened by the shrink factor, as
`jax.image.resize(..., "bilinear")` computes them (utils/image.py). The
encode runs on `device`, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..models.dinov2 import DinoV2, encode_image
from ..utils.device import resolve_device
from ..utils.image import has_cv2, read_image, resize_bilinear


def _frames_with_cv2(video_path: str, out_dir: str, max_frames: int) -> bool:
    """The first max_frames frames through cv2's reader; False when cv2
    cannot open the file."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return False
    try:
        for i in range(max_frames):
            ok, frame = cap.read()
            if not ok:
                break
            if not cv2.imwrite(os.path.join(out_dir, f"frame_{i:04d}.png"),
                               frame):
                raise OSError(f"cv2 could not write frame {i} to {out_dir}")
    finally:
        cap.release()
    return True


def extract_frames(video_path: str, out_dir: str, fps: int = 8,
                   max_frames: int = 32) -> int:
    """Frames of video_path as out_dir/frame_%04d.png; returns the count.
    ffmpeg resamples to `fps`; the readers that stand in for it take the
    first max_frames frames as stored."""
    os.makedirs(out_dir, exist_ok=True)
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-i", video_path, "-vf", f"fps={fps}",
             "-frames:v", str(max_frames),
             os.path.join(out_dir, "frame_%04d.png")],
            check=True, capture_output=True)
    except (FileNotFoundError, subprocess.CalledProcessError):
        if not (has_cv2() and _frames_with_cv2(video_path, out_dir,
                                               max_frames)):
            import imageio

            reader = imageio.get_reader(video_path)
            for i, frame in enumerate(reader):
                if i >= max_frames:
                    break
                imageio.imwrite(os.path.join(out_dir, f"frame_{i:04d}.png"),
                                frame)
    return len(glob.glob(os.path.join(out_dir, "frame_*.png")))


def normalize_frame(image: np.ndarray, alpha: Optional[np.ndarray] = None,
                    content_size: int = 380,
                    canvas_size: int = 512) -> np.ndarray:
    """Centre the masked object at content_size inside a white canvas_size
    square. image [H, W, 3 or 4], in [0, 1] or [0, 255]; alpha [H, W] or
    the image's fourth channel or all ones -> [canvas, canvas, 3] float32."""
    img = image.astype(np.float32)
    if img.max() > 1.5:
        img /= 255.0
    if alpha is None:
        alpha = (img[..., 3] if img.shape[-1] == 4
                 else np.ones(img.shape[:2], np.float32))
    rgb = img[..., :3]
    ys, xs = np.where(alpha > 0.5)
    if len(ys) == 0:
        ys, xs = np.arange(img.shape[0]), np.arange(img.shape[1])
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    a = alpha[y0:y1, x0:x1, None]
    crop = rgb[y0:y1, x0:x1] * a + (1.0 - a)
    h, w = crop.shape[:2]
    s = content_size / max(h, w)
    nh, nw = int(round(h * s)), int(round(w * s))
    resized = resize_bilinear(torch.from_numpy(
        np.ascontiguousarray(crop, np.float32)), (nh, nw)).numpy()
    canvas = np.ones((canvas_size, canvas_size, 3), np.float32)
    oy, ox = (canvas_size - nh) // 2, (canvas_size - nw) // 2
    canvas[oy:oy + nh, ox:ox + nw] = resized
    return canvas


@torch.no_grad()
def encode_video(frames: Union[np.ndarray, Sequence[np.ndarray]],
                 model: DinoV2, image_size: int = 518, device="cuda",
                 alphas: Optional[Sequence[np.ndarray]] = None
                 ) -> torch.Tensor:
    """Per-frame DINOv2 tokens: T frames [H, W, 3 or 4] -> [T, 1 + R + L,
    C] fp32 on `device` (the model moves there). Each frame's alpha is
    alphas[t] where given, else its fourth channel. Raises when `device`
    names CUDA and there is none."""
    dev = resolve_device(device)
    model.to(dev)
    alphas = [None] * len(frames) if alphas is None else alphas
    canvases = np.stack([normalize_frame(np.asarray(f), a)
                         for f, a in zip(frames, alphas)])
    batch = resize_bilinear(torch.from_numpy(canvases).to(dev),
                            (image_size, image_size))
    return encode_image(model, batch)


def encode_video_features(frames_dir: str, out_path: str,
                          dinov2: Optional[DinoV2] = None,
                          matting_fn: Optional[Callable] = None,
                          image_size: int = 518,
                          device="cuda") -> np.ndarray:
    """The frames_dir/frame_*.png frames' DINOv2 tokens [T, 1 + R + L, C]
    (fp32 numpy), also written as np.savez(out_path, features=...). Each
    frame's alpha is matting_fn(frame) where a hook is given. Without a
    model, DinoV2() at its constructor's initialization (JAX: `init` under
    PRNGKey(0)): random weights."""
    paths = sorted(glob.glob(os.path.join(frames_dir, "frame_*.png")))
    if not paths:
        raise FileNotFoundError(f"no frames in {frames_dir}")
    dev = resolve_device(device)
    frames = [read_image(p) for p in paths]
    alphas = [matting_fn(f) for f in frames] if matting_fn else None
    feats = encode_video(frames, dinov2 or DinoV2(), image_size, dev,
                         alphas).cpu().numpy()
    np.savez(out_path, features=feats.astype(np.float32))
    return feats


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--max_frames", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="where the encode runs (cuda, or cpu)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)  # before any work
    frames_dir = os.path.join(args.out_dir, "frames")
    n = extract_frames(args.video, frames_dir, args.fps, args.max_frames)
    print(f"extracted {n} frames")
    feats = encode_video_features(
        frames_dir, os.path.join(args.out_dir, "dinov2_features.npz"),
        device=dev)
    print(f"features {feats.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
