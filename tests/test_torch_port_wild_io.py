"""Port parity: the in-the-wild chain's inputs and outputs from files, against
the JAX package on the CPU.

- models/clip.py at a tiny width (64 wide, 2 blocks, patch 16, 64^2):
  CLIPImageEncoder on a square input, a non-square one enlarged by the
  short-side cubic resize and one shrunk by it, each then centre-cropped
  (rel L2 <= 1e-5, fp32); `make_clip_score_fn` (abs 1e-5); utils/image.py's
  cubic resize against `jax.image.resize(..., "cubic")` (abs 1e-5).
- DINOv2 (2 blocks, 128 wide, a 4^2 position grid) on 3^2 and 7^2 patch
  grids, its position embedding resized (rel L2 <= 1e-5, the bound of
  tests/test_torch_port_dinov2.py); a grid that is not square raises.
- scripts/process_video.py: `extract_frames` on a cv2-written mp4 (cv2's
  reader where ffmpeg is absent; the PNGs equal cv2's own decode), and on
  a GIF through the imageio route against JAX's (the same PNGs; imageio
  without a video plugin opens no mp4);
  `encode_video_features` with a matting hook against JAX's on the
  extracted frames (rel L2 <= 1e-5, the npz too).
- utils/inference_utils.py: `create_spiral_timeline_video` against JAX's
  (the same decoded mp4; with cv2 hidden, the same `.npy`), and a writer
  whose encoder raises: `append` and `close` raise within 20 s, where JAX's
  would block.
- `InTheWildPipeline.render_outputs` (2 frames x 3 views at 32^2) against
  JAX's: frames.npy within the renderer's atol 1e-4, both spirals written.
- TRELLIS's `preprocess_image` taking an RGB image's alpha from
  `matting_fn`, against JAX's (abs 1e-5); `process_video.main --device
  cpu` end to end.
JAX runs jitted.
"""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.models.clip import CLIPImageEncoder, \
    make_clip_score_fn
from gvfdiffusion_torch.models.dinov2 import DinoV2
from gvfdiffusion_torch.pipelines.in_the_wild import (InTheWildConfig,
                                                      InTheWildPipeline)
from gvfdiffusion_torch.render.renderer import GaussianRenderer, RenderOptions
from gvfdiffusion_torch.representations.gaussians import from_activated
from gvfdiffusion_torch.scripts import process_video as ppv
from gvfdiffusion_torch.utils import inference_utils as piu
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_torch.utils.image import read_image, resize_cubic
from gvfdiffusion_tpu.models import clip as jc
from gvfdiffusion_tpu.models import dinov2 as jd
from gvfdiffusion_tpu.pipelines import in_the_wild as jwild
from gvfdiffusion_tpu.render import renderer as jr
from gvfdiffusion_tpu.representations import gaussians as jg
from gvfdiffusion_tpu.scripts import process_video as jpv
from gvfdiffusion_tpu.utils import inference_utils as jiu

cv2 = pytest.importorskip("cv2")

REL = 1e-5
CLIP_KW = dict(image_size=64, patch_size=16, width=64, depth=2, heads=4,
               embed_dim=32)
DINO_KW = dict(img_size=56, patch_size=14, embed_dim=128, depth=2,
               num_heads=2, num_register_tokens=4)
OPT = dict(near=0.1, far=10.0, tile=16, max_per_tile=64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# -- CLIP ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def clip_pair():
    port = pw.init_random_(CLIPImageEncoder(**CLIP_KW), seed=3).eval()
    return port, pw.to_flax(pw.clip_table(2), port.state_dict())


def test_clip_table_has_jax_init_paths(clip_pair):
    shapes = jax.eval_shape(jc.CLIPImageEncoder(**CLIP_KW).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    got = jax.tree_util.tree_map(lambda a: a.shape, clip_pair[1])
    assert got == jax.tree_util.tree_map(lambda s: s.shape, shapes)


@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 48, 80), (1, 100, 70)])
def test_clip_matches_jax(clip_pair, shape):
    port, params = clip_pair
    x = np.random.default_rng(shape[1]).random(shape + (3,)).astype(
        np.float32)
    want = jax.jit(jc.CLIPImageEncoder(**CLIP_KW).apply)(params,
                                                         jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (shape[0], 32)
    assert _rel(got, want) <= REL


def test_clip_score_fn_matches_jax(clip_pair):
    port, params = clip_pair
    r = np.random.default_rng(7)
    target = r.random((70, 90, 3)).astype(np.float32)
    renders = r.random((5, 64, 64, 3)).astype(np.float32)
    got = make_clip_score_fn(port, target)(renders)
    want = jc.make_clip_score_fn(jc.CLIPImageEncoder(**CLIP_KW), params,
                                 target)(renders)
    assert got.shape == (5,)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        make_clip_score_fn(port, target)(torch.from_numpy(renders)), got)


@pytest.mark.parametrize("size", [(224, 280), (64, 80), (130, 97)])
def test_cubic_resize_matches_jax(size):
    x = np.random.default_rng(1).random((1, 128, 160, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, *size, 3), "cubic")
    got = resize_cubic(torch.from_numpy(x), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -- DINOv2 on another grid --------------------------------------------------


@pytest.fixture(scope="module")
def dino_pair():
    port = pw.init_random_(DinoV2(**DINO_KW), seed=0).eval()
    params = pw.to_flax(pw.dinov2_table(2), port.state_dict())
    return port, params


@pytest.mark.parametrize("size", [42, 98])
def test_dinov2_interpolates_its_grid_as_jax(dino_pair, size):
    port, params = dino_pair
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)
                                            ).astype(np.float32)
    jpre, jnormed = jax.jit(jd.DinoV2(**DINO_KW).apply)(params,
                                                        jnp.asarray(x))
    with torch.no_grad():
        pre, normed = port(torch.from_numpy(x))
    assert pre.shape == (2, 1 + 4 + (size // 14) ** 2, 128)
    assert _rel(pre, jpre) <= REL
    assert _rel(normed, jnormed) <= REL


def test_dinov2_non_square_grid_raises(dino_pair):
    with pytest.raises(ValueError, match="square"):
        dino_pair[0](torch.zeros(1, 70, 56, 3))


# -- frames from a video file, tokens from frames -----------------------------


def _video_frames(T=6, h=40, w=48):
    """T RGB frames: a seeded background and a square that moves."""
    r = np.random.default_rng(11)
    frames = np.repeat(r.integers(0, 80, (1, h, w, 3)), T, 0).astype(
        np.uint8)
    for t in range(T):
        frames[t, 8:28, 4 + 3 * t:24 + 3 * t] = (200, 170 - 10 * t, 90)
    return frames


def _write_mp4(path, frames, fps=8):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (frames.shape[2], frames.shape[1]))
    assert vw.isOpened()
    for f in frames:
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()


def _cv2_decode(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f[:, :, ::-1])
    cap.release()
    return np.stack(out)


def _dir_frames(d):
    names = sorted(n for n in os.listdir(d) if n.startswith("frame_"))
    return names, [read_image(os.path.join(d, n)) for n in names]


def test_extract_frames_reads_an_mp4_with_cv2(tmp_path):
    video = str(tmp_path / "v.mp4")
    _write_mp4(video, _video_frames())
    assert ppv.extract_frames(video, str(tmp_path / "all")) == 6
    names, frames = _dir_frames(tmp_path / "all")
    assert names == [f"frame_{i:04d}.png" for i in range(6)]
    np.testing.assert_array_equal(np.stack(frames), _cv2_decode(video))
    assert ppv.extract_frames(video, str(tmp_path / "four"),
                              max_frames=4) == 4


def test_extract_frames_imageio_route_matches_jax(tmp_path, monkeypatch):
    """Without ffmpeg and cv2, imageio's reader, as JAX's fallback."""
    import imageio

    gif = str(tmp_path / "v.gif")
    imageio.mimsave(gif, list(_video_frames()))
    monkeypatch.setattr(ppv, "has_cv2", lambda: False)
    n = ppv.extract_frames(gif, str(tmp_path / "port"), max_frames=5)
    assert n == jpv.extract_frames(gif, str(tmp_path / "jax"),
                                   max_frames=5) == 5
    a, b = _dir_frames(tmp_path / "port"), _dir_frames(tmp_path / "jax")
    assert a[0] == b[0]
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)


def _matte(img):
    """A matting hook: the bright square."""
    return (np.asarray(img, np.float32)[..., 0] > 150).astype(np.float32)


def test_encode_video_features_matches_jax(dino_pair, tmp_path):
    port, params = dino_pair
    video = str(tmp_path / "v.mp4")
    _write_mp4(video, _video_frames())
    frames_dir = str(tmp_path / "frames")
    ppv.extract_frames(video, frames_dir, max_frames=4)
    got = ppv.encode_video_features(frames_dir, str(tmp_path / "p.npz"),
                                    port, matting_fn=_matte, image_size=56,
                                    device="cpu")
    want = jpv.encode_video_features(
        frames_dir, str(tmp_path / "j.npz"), jd.DinoV2(**DINO_KW), params,
        matting_fn=_matte, image_size=56)
    assert got.shape == (4, 21, 128) and got.dtype == np.float32
    assert _rel(got, want) <= REL
    with np.load(tmp_path / "p.npz") as f:
        np.testing.assert_array_equal(f["features"], got)
    # the hook's alphas, in memory, give the same tokens
    _, frames = _dir_frames(frames_dir)
    mem = ppv.encode_video(frames, port, 56, "cpu",
                           alphas=[_matte(f) for f in frames])
    np.testing.assert_array_equal(mem.numpy(), got)
    with pytest.raises(FileNotFoundError):
        ppv.encode_video_features(str(tmp_path / "none"), "x.npz", port,
                                  device="cpu")


# -- the mp4 writers -------------------------------------------------------------


def _spiral_frames():
    return np.random.default_rng(0).random((5, 3, 48, 48, 3)).astype(
        np.float32)


def test_spiral_video_matches_jax(tmp_path):
    frames = _spiral_frames()
    mine, theirs = str(tmp_path / "p.mp4"), str(tmp_path / "j.mp4")
    assert piu.create_spiral_timeline_video(frames, mine, fps=10)
    assert jiu.create_spiral_timeline_video(frames, theirs, fps=10)
    a, b = _cv2_decode(mine), _cv2_decode(theirs)
    assert a.shape == (10, 48, 48, 3)
    np.testing.assert_array_equal(a, b)


def test_spiral_video_npy_fallback_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 fails
    frames = _spiral_frames()
    mine, theirs = str(tmp_path / "p.mp4"), str(tmp_path / "j.mp4")
    assert not piu.create_spiral_timeline_video(frames, mine, loops=3)
    assert not jiu.create_spiral_timeline_video(frames, theirs, loops=3)
    assert not os.path.exists(mine)
    a, b = np.load(mine + ".npy"), np.load(theirs + ".npy")
    assert a.shape == (15, 48, 48, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


class _BrokenWriter:
    """A cv2.VideoWriter that opens and then raises on the first frame."""

    def __init__(self, *args):
        pass

    def isOpened(self):
        return True

    def write(self, frame):
        raise OSError("encoder failed")

    def release(self):
        pass


def _within(fn, seconds=20.0):
    """fn() on a thread; its exception, or a failure if it is still
    running after `seconds`."""
    box = {}

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - handed to the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"still blocked after {seconds} s"
    return box.get("error")


def test_writer_raises_when_its_encoder_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(cv2, "VideoWriter", _BrokenWriter)
    frame = np.zeros((16, 16, 3), np.float32)

    w = piu.StreamingVideoWriter(str(tmp_path / "a.mp4"))

    def append_many():
        for _ in range(200):  # past the queue's 64
            w.append(frame)

    err = _within(append_many)
    assert isinstance(err, RuntimeError) and isinstance(err.__cause__,
                                                        OSError)
    assert isinstance(_within(w.close), RuntimeError)

    w = piu.StreamingVideoWriter(str(tmp_path / "b.mp4"))
    w.append(frame)
    err = _within(w.close)
    assert isinstance(err, RuntimeError) and "encoder failed" in str(
        err.__cause__)


# -- render_outputs --------------------------------------------------------------


def _splat(seed, n=500):
    r = np.random.default_rng(seed)
    q = r.standard_normal((n, 4))
    return np.concatenate([
        r.uniform(-0.35, 0.35, (n, 3)), r.uniform(0.01, 0.05, (n, 3)),
        q / np.linalg.norm(q, axis=-1, keepdims=True),
        r.standard_normal((n, 3)), r.uniform(0.2, 0.9, (n, 1))],
        -1).astype(np.float32)


def test_render_outputs_matches_jax(tmp_path):
    assert InTheWildConfig().render_views == jwild.InTheWildConfig(
        ).render_views == 128
    act = _splat(3)
    deltas = (np.random.default_rng(4).standard_normal((1, 2, 500, 14))
              * 0.02).astype(np.float32)
    valid = np.ones(500, bool)
    valid[-20:] = False
    cfg = dict(render_views=3, render_resolution=32)

    mine = InTheWildPipeline(None, None, InTheWildConfig(**cfg),
                             render_options=RenderOptions(**OPT))
    got = mine.render_outputs(
        {"gaussians": from_activated(torch.from_numpy(act)),
         "valid": torch.from_numpy(valid),
         "deltas": torch.from_numpy(deltas)}, str(tmp_path / "p"), fps=10)
    theirs = jwild.InTheWildPipeline(None, None, jwild.InTheWildConfig(**cfg),
                                     render_options=jr.RenderOptions(**OPT))
    want = theirs.render_outputs(
        {"gaussians": jg.from_activated(jnp.asarray(act)),
         "valid": jnp.asarray(valid), "deltas": jnp.asarray(deltas)},
        str(tmp_path / "j"), fps=10)
    assert got.shape == want.shape == (2, 3, 32, 32, 3)
    assert float((want < 0.98).mean()) > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(np.load(tmp_path / "p" / "frames.npy"),
                                  got)
    a = _cv2_decode(str(tmp_path / "p" / "spiral.mp4"))
    b = _cv2_decode(str(tmp_path / "j" / "spiral.mp4"))
    assert a.shape == b.shape == (4, 32, 32, 3)
    assert np.abs(a.astype(int) - b.astype(int)).mean() < 1.0


def test_trellis_preprocess_takes_the_matting_hook_as_jax():
    """An RGB image's alpha from matting_fn (a hook that keeps a disk)."""
    from gvfdiffusion_torch.pipelines.trellis_image_to_3d import (
        TrellisImageTo3DPipeline)
    from gvfdiffusion_tpu.pipelines import trellis_image_to_3d as jt

    img = np.random.default_rng(2).integers(0, 255, (90, 120, 3)).astype(
        np.uint8)
    yy, xx = np.mgrid[:90, :120]

    def disk(x):
        assert x.shape == (90, 120, 3) and x.max() <= 1.0
        return ((yy - 40) ** 2 + (xx - 70) ** 2 < 25 ** 2).astype(np.float32)

    mine = TrellisImageTo3DPipeline.__new__(TrellisImageTo3DPipeline)
    mine.matting_fn = disk
    theirs = jt.TrellisImageTo3DPipeline.__new__(jt.TrellisImageTo3DPipeline)
    theirs.matting_fn = disk
    got, want = mine.preprocess_image(img), theirs.preprocess_image(img)
    assert got.shape == (518, 518, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    mine.matting_fn = None
    assert not np.allclose(mine.preprocess_image(img), got, atol=1e-3)


def test_process_video_main_on_the_cpu(tmp_path, monkeypatch):
    """The CLI end to end on one frame: the video's frames, then DINOv2's
    tokens (its random weights; a small DINOv2 stands in for ViT-L, its
    position grid resized to 518^2's 37^2) in dinov2_features.npz."""
    monkeypatch.setattr(ppv, "DinoV2", lambda: DinoV2(**DINO_KW))
    video = str(tmp_path / "v.mp4")
    _write_mp4(video, _video_frames(T=3))
    assert ppv.main(["--video", video, "--out_dir", str(tmp_path / "o"),
                     "--max_frames", "1", "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "o" / "frames")) == [
        "frame_0000.png"]
    with np.load(tmp_path / "o" / "dinov2_features.npz") as f:
        feats = f["features"]
    assert feats.shape == (1, 1374, 128) and np.isfinite(feats).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ppv.main(["--video", video, "--out_dir", str(tmp_path / "x")])
