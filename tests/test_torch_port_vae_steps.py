"""Port parity: one step of each VAE training phase
(`train/vae_trainer.make_static_vae_step`, then `make_joint_vae_step` from
the states phase A left) against the JAX package's, jitted: the loss
terms, the gradient norms, the renders and the updated parameters of both
VAEs. JAX's posterior noise (its `fold_in(rng, 1)` and `fold_in(rng, 2)`
draws) is handed to the port; the renders are on a non-white background,
`RenderOptions.bg_color`.

A small static VAE (1 + 1 blocks of 64 channels, 2 heads, 12 slots, 8
Gaussians a voxel) and motion VAE (depth 1, dim 48, 6 latents) on
`init_random_` parameters carried to flax by `utils/weights`; 2 samples x
2 views of 16^2. Bound: rel L2 <= 1e-4 on every term and on each
parameter's update (new - old, which the parameters' magnitude would
hide; Adam's eps at 1.0 makes the first update linear in the gradient,
see `_optimizers`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gvfdiffusion_torch.models import motion_vae as pmv
from gvfdiffusion_torch.models.static_vae import SparseTransformerVAE
from gvfdiffusion_torch.render.renderer import RenderOptions as PRenderOptions
from gvfdiffusion_torch.representations.camera import orbit_camera
from gvfdiffusion_torch.sparse.tensor import from_lists
from gvfdiffusion_torch.train import train_state as pts
from gvfdiffusion_torch.train import vae_trainer as pvt
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_tpu.models import motion_vae as jmv
from gvfdiffusion_tpu.models import static_vae as jstv
from gvfdiffusion_tpu.render.renderer import RenderOptions as JRenderOptions
from gvfdiffusion_tpu.sparse import tensor as jst
from gvfdiffusion_tpu.train import train_state as jts
from gvfdiffusion_tpu.train import vae_trainer as jvt

MODEL = 1e-4
STATIC = dict(resolution=16, in_channels=8, model_channels=64,
              out_channels=112, latent_channels=4, num_blocks=1,
              window_size=4, num_heads=2)
MOTION = dict(depth=1, dim=48, queries_dim=48, output_dim=14, num_inputs=32,
              num_latents=6, latent_dim=4, heads=4, knn_k=4)
H = W = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _motion():
    tm = pw.init_random_(pmv.MotionVAE(**MOTION), seed=7)
    params = pw.to_flax(pw.motion_vae_table(MOTION["depth"]), tm.state_dict())
    return tm, jmv.MotionVAE(**MOTION), jax.tree.map(jnp.asarray, params)


def _batch(seed=10, views=2):
    r = np.random.default_rng(seed)
    coords = [r.choice(16 ** 3, n, replace=False) for n in (10, 7)]
    coords = [np.stack(np.unravel_index(c, (16,) * 3), -1) for c in coords]
    feats = [r.standard_normal((len(c), 8)).astype(np.float32)
             for c in coords]
    cams = [orbit_camera(360.0 * v / views + 15, 20.0, radius=1.2, height=H,
                         width=W) for v in range(views)]
    extr = np.stack([c.world_view.numpy() for c in cams])[None].repeat(2, 0)
    intr = np.stack([c.intrinsics.numpy() for c in cams])[None].repeat(2, 0)
    return dict(coords=coords, feats=feats,
                images=r.uniform(size=(2, views, H, W, 3)).astype(np.float32),
                extrinsics=extr.astype(np.float32),
                intrinsics=intr.astype(np.float32),
                static_pc=r.uniform(-0.4, 0.4, (2, 32, 3)).astype(np.float32),
                delta_pc=(0.02 * r.standard_normal((2, 2, 32, 3))).astype(
                    np.float32),
                frame_idx=np.array([[0, 1], [1, 0]], np.int32))


def _sides(b):
    """The batch as each package takes it."""
    port = {k: _t(v) for k, v in b.items()
            if k not in ("coords", "feats", "frame_idx")}
    port["feats"] = from_lists(b["coords"], b["feats"], 16, capacity=12)
    port["frame_idx"] = torch.from_numpy(b["frame_idx"]).long()
    jx = {k: jnp.asarray(v) for k, v in b.items()
          if k not in ("coords", "feats")}
    jx["feats"] = jst.from_lists(b["coords"], b["feats"], 16, capacity=12)
    for side in (port, jx):
        side["frame_images"] = side["images"]
        side["frame_extrinsics"] = side["extrinsics"]
        side["frame_intrinsics"] = side["intrinsics"]
    return port, jx


def _static():
    tm = pw.init_random_(SparseTransformerVAE(**STATIC), seed=11)
    params = pw.to_flax(pw.static_vae_table(1), tm.state_dict())
    return tm, jstv.SparseTransformerVAE(**STATIC), jax.tree.map(
        jnp.asarray, params)


OPTS = dict(near=0.1, far=10.0, bg_color=(0.2, 0.4, 0.6), max_per_tile=32)


def _optimizers(lr):
    """The trainer's chain (clip 1.0 -> AdamW) on both sides, with Adam's
    eps at 1.0 in place of 1e-8: the first update is then lr * g / (|g| +
    1), linear in the gradient, where eps 1e-8 gives lr * sign(g), whose
    sign is noise for the gradients that are zero in exact arithmetic (the
    k projection's bias: the softmax ignores a per-query constant). The
    rates are large (0.5, 1.0) so that an update of ~lr * 1e-3 stands well
    above the fp32 rounding of the parameters it moves."""
    tx_j = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(lr, eps=1.0, weight_decay=0.0))
    tx_p = pts.make_optimizer(lr=lr, warmup_steps=0)
    tx_p.eps = 1.0
    return tx_j, tx_p


def _check_update(tm, table, before, j_old, j_new, what):
    want_new = pw.from_flax(table, j_new.params)
    want_old = pw.from_flax(table, j_old.params)
    for name, p in tm.named_parameters():
        got = p.detach() - before[name]
        want = want_new[name] - want_old[name]
        assert _rel(got.numpy(), want.numpy()) <= MODEL, (what, name)


def test_static_and_joint_steps_match_jax():
    tm, jm, jparams = _static()
    port, jx = _sides(_batch())
    rng = jax.random.PRNGKey(12)
    noise = _t(jax.random.normal(jax.random.fold_in(rng, 1), (2, 12, 4)))

    # phase A
    tx_j, tx_p = _optimizers(1.0)
    state_j = jts.create_train_state(jparams, tx_j)
    step_j = jvt.make_static_vae_step(
        lambda p, f, r_, s: jm.apply(p, f, r_, s), tx_j,
        render_options=JRenderOptions(**OPTS))
    new_j, terms_j, rendered_j = jax.jit(step_j)(state_j, jx, rng)
    state_p = pts.create_train_state(tm, tx_p)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    step_p = pvt.make_static_vae_step(tm, tx_p,
                                      render_options=PRenderOptions(**OPTS))
    state_p, terms_p, rendered_p = step_p(state_p, port, noise=noise)
    assert set(terms_p) == set(terms_j)
    for k in terms_j:
        assert _rel(float(terms_p[k]), float(terms_j[k])) <= MODEL, k
    assert _rel(rendered_p.numpy(), rendered_j) <= MODEL
    table = pw.static_vae_table(1)
    _check_update(tm, table, before, state_j, new_j, "phase A")
    assert state_p.step == 1

    # phase B, from the states phase A left
    mm, jmm, mparams = _motion()
    m_tx_j, m_tx_p = _optimizers(1.0)
    s_tx_j, s_tx_p = _optimizers(0.5)
    m_state_j = jts.create_train_state(mparams, m_tx_j)
    m_state_p = pts.create_train_state(mm, m_tx_p)
    joint_j = jvt.make_joint_vae_step(
        lambda p, f, r_, s: jm.apply(p, f, r_, s),
        lambda p, *a: jmm.apply(p, *a), s_tx_j, m_tx_j,
        render_options=JRenderOptions(**OPTS), knn_k=4)
    joint_p = pvt.make_joint_vae_step(
        tm, mm, s_tx_p, m_tx_p, render_options=PRenderOptions(**OPTS),
        knn_k=4)
    rng = jax.random.PRNGKey(13)
    noise = _t(jax.random.normal(jax.random.fold_in(rng, 1), (2, 12, 4)))
    m_noise = _t(jax.random.normal(jax.random.fold_in(rng, 2), (4, 6, 4)))
    s_before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    m_before = {n: p.detach().clone() for n, p in mm.named_parameters()}
    s_new_j, m_new_j, terms_j = jax.jit(joint_j)(new_j, m_state_j, jx, rng)
    state_p, m_state_p, terms_p = joint_p(state_p, m_state_p, port,
                                          noise=noise, motion_noise=m_noise)
    assert set(terms_p) == set(terms_j)
    for k in terms_j:
        assert _rel(float(terms_p[k]), float(terms_j[k])) <= MODEL, k
    assert float(terms_p["grad_norm_motion"]) > 0
    _check_update(tm, table, s_before, new_j, s_new_j, "phase B static")
    _check_update(mm, pw.motion_vae_table(1), m_before, m_state_j, m_new_j,
                  "phase B motion")
