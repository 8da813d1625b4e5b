"""Port parity: the in-the-wild entry point and what it adds
(gvfdiffusion_torch/ops/quaternion.py `quat_multiply`, `rotmat_to_quat`;
representations/camera.py `orbit_cameras`; ops/rasterize/xla_blend.py
`blend_tiles_multiround`; utils/inference_utils.py; the render_4d
keywords; pipelines/in_the_wild.py) against the JAX package, in fp32 on
the CPU, from numpy draws handed to both.

Tolerances, each with its reason:
  * quaternions and cameras: 1e-6 (the same fp32 formulas);
  * the multi-round blend on the same projected inputs: atol 2e-5 (fp32
    cumprod and products in another order, over two rounds);
  * rotate_gaussians_z: 1e-6;
  * the alignment: the same angle index and scale exactly (the target is
    the splat itself at a known azimuth, so the minimum is sharp), the
    aligned splat within 1e-5;
  * render_sweep and render_4d: atol 1e-4 (the renderer's own bound,
    tests/test_torch_port_render.py).
The whole entry point at a tiny size is tests/test_torch_port_wild_run.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import quaternion as pq
from gvfdiffusion_torch.ops.rasterize.xla_blend import blend_tiles_multiround
from gvfdiffusion_torch.pipelines.video_to_4d import VideoTo4DPipeline
from gvfdiffusion_torch.render.renderer import GaussianRenderer, RenderOptions
from gvfdiffusion_torch.representations import camera as pcam
from gvfdiffusion_torch.representations.gaussians import from_activated
from gvfdiffusion_torch.utils import inference_utils as piu
from gvfdiffusion_tpu.ops import quaternion as jq
from gvfdiffusion_tpu.ops.rasterize import xla_blend as jblend
from gvfdiffusion_tpu.pipelines import video_to_4d as jv4d
from gvfdiffusion_tpu.render import renderer as jr
from gvfdiffusion_tpu.representations import camera as jcam
from gvfdiffusion_tpu.representations import gaussians as jg
from gvfdiffusion_tpu.utils import inference_utils as jiu
from test_torch_port_render import _projected

ALIGN_RES = 64
OPT = dict(near=0.1, far=10.0, tile=16, max_per_tile=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker while this module runs (the
    suite runs several workers at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_quaternions_and_orbit_cameras_match_jax():
    r = np.random.default_rng(0)
    a, b = r.standard_normal((2, 50, 4)).astype(np.float32)
    np.testing.assert_allclose(pq.quat_multiply(_t(a), _t(b)).numpy(),
                               np.asarray(jq.quat_multiply(a, b)),
                               rtol=1e-6, atol=1e-6)
    m = np.array(jq.quat_to_rotmat(jnp.asarray(a)))
    m[0] = np.diag([1.0, -1.0, -1.0])  # a half turn: w = 0 at the floor
    np.testing.assert_allclose(pq.rotmat_to_quat(_t(m)).numpy(),
                               np.asarray(jq.rotmat_to_quat(jnp.asarray(m))),
                               rtol=1e-6, atol=1e-6)
    got = pcam.orbit_cameras(5, 30.0, radius=2.5, height=40, width=48)
    want = jcam.orbit_cameras(5, 30.0, radius=2.5, height=40, width=48)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert (g.height, g.width) == (w.height, w.width) == (40, 48)
        np.testing.assert_allclose(g.world_view.numpy(),
                                   np.asarray(w.world_view), atol=1e-6)


@pytest.mark.parametrize("early_exit", [False, True])
def test_multiround_blend_matches_jax(early_exit):
    """64^2 with 16-px tiles, 128 per round: 101 to 1106 Gaussians per
    tile, so 3 rounds do not empty every list; opacities raised so that
    tiles saturate and, with early_exit, stop."""
    ins = list(_projected(5))
    ins[3] = np.minimum(ins[3] * 4.0, 0.99)  # opaque: tiles saturate
    bg = np.array([1.0, 0.5, 0.0], np.float32)
    kw = dict(tile=16, per_round=128, rounds=3, early_exit=early_exit)
    want = jblend.blend_tiles_multiround(*map(jnp.asarray, ins), 64, 64,
                                         jnp.asarray(bg), **kw)
    got = blend_tiles_multiround(*map(_t, ins), 64, 64, _t(bg), **kw)
    assert float(np.asarray(want[2]).mean()) > 0.3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    if early_exit:  # it stopped early somewhere, and that shows
        scan = blend_tiles_multiround(*map(_t, ins), 64, 64, _t(bg),
                                      **dict(kw, early_exit=False))
        assert not torch.equal(scan[1], got[1])


def _splat(seed, n=2048):
    r = np.random.default_rng(seed)
    q = r.standard_normal((n, 4))
    return np.concatenate([
        r.uniform(-0.35, 0.35, (n, 3)) * np.array([1.0, 0.4, 1.0]),
        r.uniform(0.01, 0.05, (n, 3)),
        q / np.linalg.norm(q, axis=-1, keepdims=True),
        r.standard_normal((n, 3)), r.uniform(0.2, 0.9, (n, 1))],
        -1).astype(np.float32)


def test_rotate_gaussians_z_matches_jax():
    act = _splat(1, 300)
    want = jiu.rotate_gaussians_z(jg.from_activated(jnp.asarray(act)),
                                  jnp.float32(0.7))
    got = piu.rotate_gaussians_z(from_activated(_t(act)), 0.7)
    np.testing.assert_allclose(got.to_activated_tensor().numpy(),
                               np.asarray(want.to_activated_tensor()),
                               atol=1e-6)


def test_align_recovers_a_known_azimuth_as_jax_does():
    """A 2048-Gaussian splat, flattened along y so that its azimuth shows,
    rendered at 145 degrees (index 29 of 72) is the target, with its alpha;
    both packages sweep 72 angles (coarse 32^2 grid, the 1-degree
    neighbourhood, then +-2 at 64^2) over a 1536-Gaussian opacity subset."""
    act = _splat(2)
    valid = np.ones(len(act), bool)
    valid[-40:] = False
    jren = jr.GaussianRenderer(jr.RenderOptions(**OPT))
    pren = GaussianRenderer(RenderOptions(**OPT))
    jgs = jg.from_activated(jnp.asarray(act))
    cam = pcam.orbit_camera(0.0, 0.0, height=ALIGN_RES, width=ALIGN_RES)
    shown = pren.render(piu.rotate_gaussians_z(
        from_activated(_t(act)), 2 * np.pi * 29 / 72), cam, valid=_t(valid))
    target, alpha = shown["render"].numpy(), shown["alpha"].numpy()
    kw = dict(n_angles=72, coarse_res=32, coarse_subset=1536)
    jal, jangle, jscale = jiu.align_gaussian_to_canonical(
        jgs, jnp.asarray(target), alpha, jnp.asarray(valid), renderer=jren,
        **kw)
    pal, pangle, pscale = piu.align_gaussian_to_canonical(
        from_activated(_t(act)), target, alpha, _t(valid), renderer=pren,
        **kw)
    assert round(jangle / (2 * np.pi) * 72) == 29
    assert round(pangle / (2 * np.pi) * 72) == 29
    assert abs(pangle - jangle) < 1e-6
    assert pscale == jscale and abs(pscale - 1.0) < 0.1
    np.testing.assert_allclose(pal.to_activated_tensor().numpy(),
                               np.asarray(jal.to_activated_tensor()),
                               atol=1e-5)


def test_render_sweep_and_render_4d_keywords_match_jax():
    """render_sweep (2 frames x 3 views at 32^2, pitch 35, radius 2.5) and
    render_4d at the same non-default pitch and radius; the timestep
    callback sees each timestep's frames."""
    act = _splat(3, 500)
    deltas = (np.random.default_rng(4).standard_normal((2, 500, 14))
              * 0.02).astype(np.float32)
    kw = dict(num_views=3, resolution=32, pitch_deg=35.0, radius=2.5)
    jren = jr.GaussianRenderer(jr.RenderOptions(**OPT))
    want = jiu.render_sweep(jren, jg.from_activated(jnp.asarray(act)),
                            jnp.asarray(deltas), **kw)
    seen = []
    got = piu.render_sweep(GaussianRenderer(RenderOptions(**OPT)),
                           from_activated(_t(act)), _t(deltas),
                           on_timestep=lambda t, f: seen.append(
                               (t, f.clone())), **kw)
    assert got.shape == want.shape == (2, 3, 32, 32, 3)
    assert float((want < 0.98).mean()) > 0.05
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert [t for t, _ in seen] == [0, 1]
    assert torch.equal(seen[1][1], got[1])

    # render_4d's default renderer; JAX's renders each view alone
    jp = jv4d.VideoTo4DPipeline.__new__(jv4d.VideoTo4DPipeline)
    jp.renderer = jr.GaussianRenderer()
    pp = VideoTo4DPipeline.__new__(VideoTo4DPipeline)
    pp.renderer = GaussianRenderer()
    want = jp.render_4d(jg.from_activated(jnp.asarray(act)),
                        jnp.asarray(deltas), **kw)
    got = pp.render_4d(from_activated(_t(act)), _t(deltas), **kw)
    assert float((want < 0.98).mean()) > 0.05
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert piu.spiral_frame_indices(3, 4) == jiu.spiral_frame_indices(3, 4)


def test_sample_gs_matches_jax():
    act = _splat(5, 200)[None]
    valid = np.ones((1, 200), bool)
    valid[0, :7] = False
    want = jiu.sample_gs(jnp.asarray(act), jnp.asarray(valid), 16)
    got = piu.sample_gs(_t(act), _t(valid), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
