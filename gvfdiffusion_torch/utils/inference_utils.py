"""Inference utilities: azimuth alignment, FPS sampling, render sweeps (port
of gvfdiffusion_tpu/utils/inference_utils.py).

`align_gaussian_to_canonical` finds the azimuth (and an alpha-bbox scale)
that aligns a generated splat with a video's canonical frame: rotating
the splat by a about z equals rendering it through the camera
world_view @ Rz(a), so every candidate is one camera of a
`render_views` call over the same activated Gaussians. The sweep is
hierarchical as in JAX: a `coarse_step`-degree grid at `coarse_res` over
the most opaque `coarse_subset` Gaussians, the 1-degree neighbourhood of
its best, then +-`refine` angles at the target's resolution on the whole
splat. JAX's per-shape jit cache of the score program has no counterpart.

`render_sweep` hands each timestep's frames to a callback as they land,
where `StreamingVideoWriter` takes them: its thread encodes an mp4 (cv2's
`mp4v` writer, imported in the thread) while the device renders the next
timestep, or, without cv2 or where its writer does not open, keeps the
frames for JAX's `<path>.npy` fallback. JAX's writer deadlocks when its
thread dies (it raises in cv2, and `append` then blocks once the queue of
64 fills); here `append` and `close` raise the thread's error instead.
`create_spiral_timeline_video` writes the spiral schedule of a [T, V]
sweep through one. `orbit_renders` is the sweep on the device, which
VideoTo4DPipeline.render_4d stacks.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
from typing import Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.fps import fps_masked
from ..ops.quaternion import quat_multiply
from ..render.renderer import GaussianRenderer, RenderOptions
from ..representations.camera import orbit_camera, orbit_cameras
from ..representations.gaussians import GaussianSplat
from .image import resize_bilinear


def rotate_gaussians_z(gs: GaussianSplat,
                       angle_rad: Union[float, torch.Tensor]) -> GaussianSplat:
    """The splat [N, ...] rotated about the world z axis by angle_rad
    (fp32): positions, and the rotations by the half-angle quaternion."""
    dev = gs._xyz.device
    a = torch.as_tensor(angle_rad, dtype=torch.float32, device=dev)
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, -s, z]), torch.stack([s, c, z]),
                       torch.stack([z, z, o])])
    raw = (gs.get_xyz @ rot.T - gs.aabb[:3]) / gs.aabb[3:]
    half = torch.atan2(s, c) / 2.0
    q_rot = torch.stack([torch.cos(half), 0.0 * c, 0.0 * c, torch.sin(half)])
    rotation = quat_multiply(q_rot[None], gs.get_rotation) - gs._rots_bias()
    return dataclasses.replace(gs, _xyz=raw, _rotation=rotation)


def _rot_z(a: torch.Tensor) -> torch.Tensor:
    """[A] angles -> [A, 4, 4] rotations about z."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z, z], -1),
                        torch.stack([s, c, z, z], -1),
                        torch.stack([z, z, o, z], -1),
                        torch.stack([z, z, z, o], -1)], -2)


def _extent(mask: np.ndarray) -> int:
    ys, xs = np.where(mask)
    return max(ys.max() - ys.min(), xs.max() - xs.min())


def align_gaussian_to_canonical(
        gs: GaussianSplat, target_image, target_alpha=None,
        valid: Optional[torch.Tensor] = None, n_angles: int = 360,
        renderer: Optional[GaussianRenderer] = None,
        clip_score_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        clip_weight: float = 0.2, camera_kwargs: Optional[dict] = None,
        coarse_res: int = 128, refine: int = 2,
        coarse_subset: Optional[int] = 65536, coarse_step: int = 5
) -> Tuple[GaussianSplat, float, float]:
    """gs [N, ...] and the canonical frame target_image [H, W, 3] (white
    background; numpy or tensor), its alpha [H, W] optional -> (the aligned
    splat, the best angle in radians, the scale). Each candidate scores the
    mean L1 of its render against the target, plus clip_weight * (1 -
    clip_score_fn(renders)) where a CLIP scorer is given; the scale is the
    target's alpha-bbox extent over the best render's."""
    dev = gs._xyz.device
    if not torch.is_tensor(target_image):
        target_image = torch.from_numpy(np.asarray(target_image, np.float32))
    target = target_image.float().to(dev)
    h, w = target.shape[:2]
    renderer = renderer or GaussianRenderer(RenderOptions(
        near=0.1, far=10.0, bg_color=(1.0, 1.0, 1.0), use_mip=True,
        backend="binned", max_per_tile=128))
    angles = (torch.arange(n_angles, dtype=torch.float64)
              * (2 * math.pi / n_angles)).float()
    cam0 = orbit_camera(0.0, 0.0, height=h, width=w, **(camera_kwargs or {}))

    def score_at(g, vld, idx, res_h, res_w, tgt):
        wvs = cam0.world_view[None] @ _rot_z(angles[idx])
        out = renderer.render_views(g, wvs.to(dev), cam0.intrinsics.to(dev),
                                    res_h, res_w, valid=vld)
        score = (out["render"] - tgt[None]).abs().mean((1, 2, 3))
        if clip_score_fn is not None:
            sim = torch.as_tensor(np.asarray(clip_score_fn(
                out["render"].cpu().numpy())), dtype=score.dtype, device=dev)
            score = score + clip_weight * (1.0 - sim)
        return score, out["alpha"]

    # the most opaque subset for the coarse stages
    gs_c, valid_c = gs, valid
    if coarse_subset is not None and gs._xyz.shape[0] > coarse_subset:
        opa = gs.get_opacity[..., 0]
        if valid is not None:
            opa = torch.where(valid, opa, float("-inf"))
        top = torch.topk(opa, coarse_subset).indices
        gs_c = gs.select(top)
        valid_c = None if valid is None else valid[top]

    if coarse_res < min(h, w):
        ch = max(coarse_res, 1)
        cw = max(int(round(coarse_res * w / h)), 1)
        tgt_c = resize_bilinear(target, (ch, cw))
        step = max(int(coarse_step), 1)
        # stage A: the coarse angle grid; B: its 1-degree neighbourhood
        idx_a = np.arange(0, n_angles, step)
        best = int(idx_a[int(torch.argmin(score_at(
            gs_c, valid_c, idx_a, ch, cw, tgt_c)[0]))])
        if step > 1:
            idx_b = (np.arange(-(step - 1), step) + best) % n_angles
            best = int(idx_b[int(torch.argmin(score_at(
                gs_c, valid_c, idx_b, ch, cw, tgt_c)[0]))])
        idx = (np.arange(-refine, refine + 1) + best) % n_angles
    else:
        idx = np.arange(n_angles)
    fine, alphas = score_at(gs, valid, idx, h, w, target)
    best_local = int(torch.argmin(fine))
    best_angle = float(angles[int(idx[best_local])])

    # the scale from the alpha bounding boxes (reference :150-170)
    scale = 1.0
    if target_alpha is not None:
        ra = alphas[best_local].cpu().numpy() > 0.5
        if torch.is_tensor(target_alpha):
            target_alpha = target_alpha.cpu().numpy()
        ta = np.asarray(target_alpha) > 0.5
        if ra.any() and ta.any():
            scale = float(_extent(ta)) / max(float(_extent(ra)), 1.0)

    aligned = rotate_gaussians_z(gs, best_angle)
    if scale != 1.0:
        s = torch.tensor(scale, dtype=torch.float32, device=dev)
        aligned = dataclasses.replace(
            aligned, _xyz=(aligned.get_xyz * s - aligned.aabb[:3])
            / aligned.aabb[3:], _scaling=aligned._scaling + torch.log(s))
    return aligned, best_angle, scale


def sample_gs(gs_activated: torch.Tensor, valid: torch.Tensor,
              num: int) -> torch.Tensor:
    """FPS-downsample an activated [B, G, 14] Gaussian tensor -> [B, num,
    14] (reference sample_gs :180-208)."""
    idx = fps_masked(gs_activated[..., :3], valid, num)
    return torch.gather(gs_activated, 1,
                        idx[..., None].expand(-1, -1, gs_activated.shape[-1]))


def orbit_renders(renderer: GaussianRenderer, gs: GaussianSplat,
                  deltas: Optional[torch.Tensor],
                  valid: Optional[torch.Tensor] = None, num_views: int = 128,
                  resolution: int = 512, pitch_deg: float = 20.0,
                  radius: float = 2.0) -> Iterator[torch.Tensor]:
    """For frame t of deltas [T, G, 14] (once for None: the static splat),
    its [V, H, W, 3] renders from `num_views` orbit views at `pitch_deg`
    and `radius`, on the splat's device: one render_views call each."""
    cams = orbit_cameras(num_views, pitch_deg, radius=radius,
                         height=resolution, width=resolution)
    dev = gs._xyz.device
    wvs = torch.stack([c.world_view for c in cams]).to(dev)
    intr = cams[0].intrinsics.to(dev)
    for d in ([None] if deltas is None else deltas):
        yield renderer.render_views(gs, wvs, intr, resolution, resolution,
                                    delta=d, valid=valid)["render"]


@torch.no_grad()
def render_sweep(renderer: GaussianRenderer, gs: GaussianSplat,
                 deltas: Optional[torch.Tensor],
                 valid: Optional[torch.Tensor] = None, num_views: int = 128,
                 resolution: int = 512, pitch_deg: float = 20.0,
                 radius: float = 2.0,
                 on_timestep: Optional[Callable] = None) -> torch.Tensor:
    """T x V orbit renders (reference render_and_save_images :209-306), see
    orbit_renders -> [T, V, H, W, 3] fp32 frames on the host, where the
    JAX package returns numpy; each timestep's frames are handed to
    on_timestep(t, frames_t) as they land."""
    T = 1 if deltas is None else deltas.shape[0]
    out = torch.zeros(T, num_views, resolution, resolution, 3)
    for t, frames in enumerate(orbit_renders(
            renderer, gs, deltas, valid, num_views, resolution, pitch_deg,
            radius)):
        out[t] = frames.cpu()
        if on_timestep is not None:
            on_timestep(t, out[t])
    return out


def spiral_frame_indices(T: int, V: int, loops: int = 2):
    """The spiral timeline's (t, v) schedule (reference :308-381): the
    view index sweeps the orbit while time advances, `loops` passes."""
    n = T * loops
    return [(t % T, (t * V // max(n, 1)) % V) for t in range(n)]


class StreamingVideoWriter:
    """An mp4 written on a background thread as frames arrive (float [H,
    W, 3] in [0, 1], or uint8), or their `<path>.npy` where cv2 is missing
    or its writer does not open. A frame the thread fails on (the encoder
    raising) ends it: the next `append`, or `close`, raises that error."""

    def __init__(self, path: str, fps: int = 15):
        self.path = path
        self.fps = fps
        self._q: "queue.Queue" = queue.Queue(maxsize=64)
        self._fallback: Optional[BaseException] = None  # why no mp4
        self._died: Optional[BaseException] = None
        self._frames: list = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def _to_u8(frame) -> np.ndarray:
        frame = np.asarray(frame)
        if frame.dtype == np.uint8:
            return frame
        return (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)

    def _run(self) -> None:
        vw = None
        try:
            try:
                import cv2
            except ImportError as e:
                cv2, self._fallback = None, e
            while True:
                frame = self._q.get()
                if frame is None:
                    break
                frame = self._to_u8(frame)
                if cv2 is not None and vw is None and self._fallback is None:
                    h, w = frame.shape[:2]
                    vw = cv2.VideoWriter(self.path,
                                         cv2.VideoWriter_fourcc(*"mp4v"),
                                         self.fps, (w, h))
                    if not vw.isOpened():
                        self._fallback = RuntimeError(
                            "cv2.VideoWriter failed to open")
                        vw = None
                if vw is not None:
                    vw.write(np.ascontiguousarray(frame[:, :, ::-1]))
                else:
                    self._frames.append(frame)
        except BaseException as e:  # the caller sees it: append, close
            self._died = e
        finally:
            if vw is not None:
                vw.release()

    def _put(self, item) -> None:
        """Queue item, raising the thread's error, never blocking on a
        thread that has ended."""
        while True:
            if self._died is not None or not self._thread.is_alive():
                raise RuntimeError(
                    f"the video writer's thread ended ({self._died!r})"
                ) from self._died
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def append(self, frame) -> None:
        self._put(frame)

    def close(self) -> bool:
        """Flush and join; returns True if an mp4 was written, False if the
        frames went to `<path>.npy`."""
        self._put(None)
        self._thread.join()
        if self._died is not None:
            raise RuntimeError("the video writer's thread failed") \
                from self._died
        if self._fallback is not None or self._frames:
            if self._frames:
                np.save(self.path + ".npy", np.stack(self._frames))
            return False
        return True


def create_spiral_timeline_video(frames, path: str, fps: int = 15,
                                 loops: int = 2) -> bool:
    """frames [T, V, H, W, 3] along the spiral schedule (the view index
    sweeps the orbit while time advances, reference :308-381) -> an mp4
    at `path`; True if an mp4 was written, else False and `<path>.npy`."""
    T, V = frames.shape[:2]
    w = StreamingVideoWriter(path, fps=fps)
    for t, v in spiral_frame_indices(T, V, loops):
        w.append(frames[t, v])
    return w.close()
