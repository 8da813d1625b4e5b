"""Render parity: the port's Gaussian splat, camera, projection, tile
binning, blend and GaussianRenderer against the JAX package, in fp32 on
the CPU, at 64^2 with tiles of 16 and K = 64 per tile: 2048 Gaussians, so
every tile holds more than K and the truncation is exercised. Inputs are
numpy draws from a seed handed to both.

Tolerances, each with its reason:
  * activations, cameras, projection: rtol 1e-5, atol 1e-6 (the same fp32
    formulas; the projection's 4x4 product is summed in another order);
  * binning: the selected Gaussians and their order exactly, depth ties
    included, on the same projected inputs;
  * blend on the same binned inputs: atol 1e-5 (fp32 cumprod and products
    in another order);
  * the whole render from a splat and deltas: atol 1e-4 on the image and
    alpha, 1e-4 relative on depth; the two projections may differ in the
    last bit, which can move a Gaussian across a tile or a tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops.rasterize import binning as pb
from gvfdiffusion_torch.ops.rasterize.xla_blend import blend_tiles
from gvfdiffusion_torch.render.reference_renderer import project_gaussians
from gvfdiffusion_torch.render.renderer import GaussianRenderer, RenderOptions
from gvfdiffusion_torch.representations import camera as pcam
from gvfdiffusion_torch.representations.gaussians import from_activated
from gvfdiffusion_tpu.ops.rasterize import binning as jb
from gvfdiffusion_tpu.ops.rasterize import xla_blend as jblend
from gvfdiffusion_tpu.render import reference_renderer as jrr
from gvfdiffusion_tpu.render import renderer as jr
from gvfdiffusion_tpu.representations import camera as jcam
from gvfdiffusion_tpu.representations import gaussians as jg

N, RES, TILE, K = 2048, 64, 16, 64
OPT = dict(tile=TILE, max_per_tile=K)


def _splat(seed, n=N):
    """A valid activated splat [n, 14] and deltas [n, 14]."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((n, 4))
    act = np.concatenate([
        r.uniform(-0.4, 0.4, (n, 3)), r.uniform(0.02, 0.08, (n, 3)),
        q / np.linalg.norm(q, axis=-1, keepdims=True),
        r.standard_normal((n, 3)) * 0.5, r.uniform(0.1, 0.9, (n, 1))], -1)
    delta = r.standard_normal((n, 14)) * np.array([0.02] * 3 + [0.1] * 11)
    return act.astype(np.float32), delta.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cams():
    return (jcam.orbit_camera(30.0, 20.0, height=RES, width=RES),
            pcam.orbit_camera(30.0, 20.0, height=RES, width=RES))


def test_splat_activations_match_jax():
    act, delta = _splat(0, 64)
    jgs, pgs = jg.from_activated(jnp.asarray(act)), from_activated(_t(act))
    np.testing.assert_allclose(pgs.to_activated_tensor().numpy(),
                               np.asarray(jgs.to_activated_tensor()),
                               rtol=1e-5, atol=1e-6)
    jv = jgs.apply_variation(jnp.asarray(delta))
    pv = pgs.apply_variation(_t(delta))
    assert set(jv) == set(pv)
    for k in jv:
        np.testing.assert_allclose(pv[k].numpy(), np.asarray(jv[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_cameras_match_jax():
    jc, pc = _cams()
    for a in ("world_view", "intrinsics", "projection", "full_proj",
              "campos", "fov_x", "tan_fov_y"):
        np.testing.assert_allclose(np.asarray(getattr(pc, a)),
                                   np.asarray(getattr(jc, a)),
                                   rtol=1e-5, atol=1e-6, err_msg=a)


@pytest.mark.parametrize("mip", [True, False])
def test_projection_matches_jax(mip):
    act, _ = _splat(1)
    jgs = jg.from_activated(jnp.asarray(act))
    jc, pc = _cams()
    args = (jgs.get_xyz, jgs.get_scaling, jgs.get_rotation)
    want = jrr.project_gaussians(*args, jc, kernel_size_2d=0.1, mip=mip)
    got = project_gaussians(*(_t(a) for a in args), pc, kernel_size_2d=0.1,
                            mip=mip)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _projected(seed):
    """Projected inputs for the binning and blend tests, with depth ties:
    every fourth Gaussian shares the depth of the one before it."""
    act, _ = _splat(seed)
    jgs = jg.from_activated(jnp.asarray(act))
    jc, _ = _cams()
    p = jrr.project_gaussians(jgs.get_xyz, jgs.get_scaling, jgs.get_rotation,
                              jc, kernel_size_2d=0.1, mip=True)
    depth = np.array(p["depth"])
    depth[1::4] = depth[0::4]
    valid = np.array(p["in_front"])
    valid[::17] = False
    color = np.asarray(jgs.get_features[:, 0] * 0.28 + 0.5)
    opac = np.asarray(jgs.get_opacity[:, 0] * p["compensation"])
    return (np.asarray(p["mean2d"]), np.asarray(p["cov2d"]), color, opac,
            depth, valid)


def _jax_selection(mean2d, cov2d, opac, depth, valid, k):
    """The JAX package's selected input indices and mask per tile."""
    order = jb.depth_rank_order(depth, valid)
    inter, _, _, _ = jb.intersect_tiles(
        mean2d[order], cov2d[order], opac[order], valid[order], RES, RES,
        TILE)
    idx, mask = jb.rank_select(jb.build_rank_index(inter),
                               jnp.zeros((inter.shape[0],), jnp.int32), k)
    return np.asarray(jnp.take(order, idx)), np.asarray(mask)


@pytest.mark.parametrize("k", [K, 256])
def test_binning_selects_what_jax_selects(k):
    """Per tile 101 to 1106 Gaussians intersect: at K = 64 every tile
    truncates, at 256 the corner tiles do not fill."""
    mean2d, cov2d, color, opac, depth, valid = _projected(2)
    want_sid, want_mask = _jax_selection(*map(jnp.asarray, (
        mean2d, cov2d, opac, depth, valid)), k)
    got = pb.bin_gaussians(*map(_t, (mean2d, cov2d, color, opac, depth,
                                     valid)), RES, RES, TILE, k)
    assert want_mask.sum(1).max() == k
    assert (want_mask.sum(1) < k).any() == (k > K)
    np.testing.assert_array_equal(got.mask.numpy(), want_mask)
    np.testing.assert_array_equal(got.index.numpy()[want_mask],
                                  want_sid[want_mask])
    jbin = jb.bin_gaussians(*map(jnp.asarray, (
        mean2d, cov2d, color, opac, depth, valid)), RES, RES, TILE, k)
    for f in ("mean2d", "conic", "color", "opacity", "depth"):
        np.testing.assert_allclose(
            getattr(got, f).numpy()[want_mask],
            np.asarray(getattr(jbin, f))[want_mask], rtol=1e-6, atol=0,
            err_msg=f)


def test_blend_matches_jax():
    inputs = [jnp.asarray(a) for a in _projected(3)]
    jbin = jb.bin_gaussians(*inputs, RES, RES, TILE, K)
    bg = np.array([1.0, 0.5, 0.0], np.float32)
    want = jblend.blend_tiles(jbin, RES, RES, jnp.asarray(bg))
    pbin = pb.BinnedGaussians(
        *(_t(getattr(jbin, f)) for f in ("mean2d", "conic", "color",
                                         "opacity", "depth", "mask")),
        index=None, n_tiles_y=jbin.n_tiles_y, n_tiles_x=jbin.n_tiles_x,
        tile=TILE)
    for chunk in (3, 64):
        got = blend_tiles(pbin, RES, RES, _t(bg), tile_chunk=chunk)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_renderer_matches_jax():
    act, delta = _splat(4)
    jc, pc = _cams()
    jren = jr.GaussianRenderer(jr.RenderOptions(**OPT))
    pren = GaussianRenderer(RenderOptions(**OPT))
    valid = np.ones(N, bool)
    valid[-100:] = False
    want = jren.render(jg.from_activated(jnp.asarray(act)), jc,
                       delta=jnp.asarray(delta), valid=jnp.asarray(valid))
    got = pren.render(from_activated(_t(act)), pc, delta=_t(delta),
                      valid=_t(valid))
    assert float(np.asarray(want["alpha"]).mean()) > 0.2  # covers the image
    for k, tol in (("render", 1e-4), ("alpha", 1e-4)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=tol, err_msg=k)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]),
                               rtol=1e-4, atol=1e-4)
    # render_views gives each view's render
    views = [pcam.orbit_camera(a, 10.0, height=RES, width=RES)
             for a in (0.0, 30.0)]
    multi = pren.render_views(
        from_activated(_t(act)), torch.stack([c.world_view for c in views]),
        views[0].intrinsics, RES, RES, delta=_t(delta), valid=_t(valid))
    for v, c in enumerate(views):
        one = pren.render(from_activated(_t(act)), c, delta=_t(delta),
                          valid=_t(valid))
        assert torch.equal(multi["render"][v], one["render"])


@pytest.mark.parametrize("opt", [
    dict(OPT),
    dict(OPT, rounds=2, max_per_tile=32, early_exit=True),
], ids=["one_round", "two_rounds_early_exit"])
def test_render_views_chunks_match_jax_and_each_view(opt):
    """Five views through render_views, `chunk` at a time (1, 2 and 8: a
    partial last chunk, and all five in one): the frames do not depend on
    the chunk, equal each view's own render, and match JAX's
    render_views."""
    act, delta = _splat(6)
    gs = from_activated(_t(act))
    cams = pcam.orbit_cameras(5, 25.0, height=RES, width=RES)
    wvs = torch.stack([c.world_view for c in cams])
    pren = GaussianRenderer(RenderOptions(**opt))
    outs = [pren.render_views(gs, wvs, cams[0].intrinsics, RES, RES,
                              delta=_t(delta), chunk=c) for c in (1, 2, 8)]
    for o in outs[1:]:
        for k in o:
            assert torch.equal(o[k], outs[0][k]), k
    for v, c in enumerate(cams):
        one = pren.render(gs, c, delta=_t(delta))
        assert torch.equal(outs[0]["render"][v], one["render"])
    jren = jr.GaussianRenderer(jr.RenderOptions(**opt))
    want = jren.render_views(jg.from_activated(jnp.asarray(act)),
                             jnp.asarray(wvs.numpy()),
                             jnp.asarray(cams[0].intrinsics.numpy()), RES,
                             RES, delta=jnp.asarray(delta), chunk=2)
    assert float(np.asarray(want["alpha"]).mean()) > 0.2
    np.testing.assert_allclose(outs[0]["render"].numpy(),
                               np.asarray(want["render"]), atol=1e-4)


def test_unported_options_raise():
    for kw in (dict(backend="reference"), dict(ssaa=2),
               dict(rounds=2, early_exit=True, ssaa=2)):
        with pytest.raises(NotImplementedError):
            GaussianRenderer(RenderOptions(**kw))
    # several rounds with early exit are ported
    GaussianRenderer(RenderOptions(rounds=2, early_exit=True))
