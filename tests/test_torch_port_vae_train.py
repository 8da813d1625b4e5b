"""Port parity: the pieces of the VAE trainer against the JAX package's.

`ops/ssim` (ssim, psnr), `ops/lpips` (both packages reading one seeded
`.npz` in the layout of JAX's `convert_torch_lpips`), `models/sparse_vae`
(kl_loss, regularization_losses), `ops/knn` (knn_points,
interpolate_deltas), `ops/fps` (fps, fps_batched), the motion VAE's
encoder half (encode, reparameterize on a given noise, the whole forward),
`train_state.freeze_subtrees`, and `utils/weights.to_flax` copying what
it reads. One step of each training phase is in
tests/test_torch_port_vae_steps.py.

Inputs and parameters from seeds (`init_random_`, carried to flax by
`utils/weights`); fp32 throughout. Tolerances: exact for the FPS and KNN
indices; rel L2 <= 1e-5 for the losses, LPIPS, the KNN distances and the
interpolated deltas; <= 1e-4 for the motion VAE (its attention, both
packages' SDPA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gvfdiffusion_torch.models import motion_vae as pmv
from gvfdiffusion_torch.models import sparse_vae as psv
from gvfdiffusion_torch.ops import fps as pfps
from gvfdiffusion_torch.ops import knn as pknn
from gvfdiffusion_torch.ops import lpips as plp
from gvfdiffusion_torch.ops import ssim as pss
from gvfdiffusion_torch.sparse.tensor import from_lists
from gvfdiffusion_torch.train import train_state as pts
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_tpu.models import motion_vae as jmv
from gvfdiffusion_tpu.models import sparse_vae as jsv
from gvfdiffusion_tpu.ops import fps as jfps
from gvfdiffusion_tpu.ops import knn as jknn
from gvfdiffusion_tpu.ops import lpips as jlp
from gvfdiffusion_tpu.ops import ssim as jss
from gvfdiffusion_tpu.sparse import tensor as jst
from gvfdiffusion_tpu.train import train_state as jts

EXACT = 1e-5
MODEL = 1e-4
MOTION = dict(depth=1, dim=48, queries_dim=48, output_dim=14, num_inputs=32,
              num_latents=6, latent_dim=4, heads=4, knn_k=4)


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


def test_ssim_psnr_match_jax():
    r = np.random.default_rng(0)
    a = r.uniform(size=(2, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * r.standard_normal(a.shape), 0, 1).astype(np.float32)
    for fn_p, fn_j in ((pss.ssim, jss.ssim), (pss.psnr, jss.psnr)):
        got = float(fn_p(_t(a), _t(b)))
        want = float(fn_j(jnp.asarray(a), jnp.asarray(b)))
        assert abs(got - want) <= EXACT * abs(want), (fn_p.__name__, got, want)


def test_lpips_matches_jax_on_one_npz(tmp_path):
    from gvfdiffusion_torch.models.registry import save_params_npz

    path = str(tmp_path / "lpips.npz")
    model = pw.init_random_(plp.LPIPS(), seed=1)
    with torch.no_grad():  # the released heads are non-negative
        for i in range(5):
            w = getattr(model, f"lin{i}").model["1"].weight
            w.copy_(w.abs())
    # flat keys as convert_torch_lpips writes them: vgg/conv{j}/kernel, lin{i}
    save_params_npz(pw.to_flax(pw.lpips_table(), model.state_dict())["params"],
                    path)
    r = np.random.default_rng(2)
    x, y = (r.uniform(size=(2, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    port = plp.load_lpips(path, "cpu")
    got = port(_t(x), _t(y)).numpy()
    want = np.asarray(jlp.load_lpips(path)(jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == want.shape == (2,)
    assert _rel(got, want) <= EXACT
    assert plp.load_lpips(str(tmp_path / "missing.npz"), "cpu") is None
    assert all(not p.requires_grad for p in port.parameters())


def _splat_inputs(seed=3, l=12):
    r = np.random.default_rng(seed)
    coords = [r.integers(0, 16, (n, 3)) for n in (l, l - 4)]
    out = r.standard_normal((2, l, 112)).astype(np.float32) * 0.5
    valid = np.zeros((2, l), bool)
    valid[0], valid[1, :l - 4] = True, True
    return coords, out, valid


def test_kl_and_regularization_losses_match_jax():
    coords, out, _ = _splat_inputs()
    feats = [out[0], out[1, :8]]
    tx = from_lists(coords, feats, 16, capacity=12)
    jx = jst.from_lists(coords, feats, 16, capacity=12)
    gs_p, v_p = psv.to_representation(tx)
    gs_j, v_j = jsv.to_representation(jx)
    got = psv.regularization_losses(gs_p, v_p)
    want = jsv.regularization_losses(gs_j, v_j)
    for k in ("reg_vol", "reg_opacity", "loss"):
        assert _rel(float(got[k]), float(want[k])) <= EXACT, k
    r = np.random.default_rng(4)
    mean, logvar = (r.standard_normal((2, 12, 4)).astype(np.float32)
                    for _ in range(2))
    got = float(psv.kl_loss(_t(mean), _t(logvar), tx.valid))
    want = float(jsv.kl_loss(jnp.asarray(mean), jnp.asarray(logvar),
                             jx.valid))
    assert _rel(got, want) <= EXACT


def test_knn_and_interpolation_match_jax(monkeypatch):
    r = np.random.default_rng(5)
    anchors = r.uniform(size=(2, 40, 3)).astype(np.float32)
    pc = r.uniform(size=(2, 50, 3)).astype(np.float32)
    deltas = (0.1 * r.standard_normal((2, 3, 50, 3))).astype(np.float32)
    monkeypatch.setattr(pknn, "_CHUNK", 16)  # several query chunks
    d_p, i_p = pknn.knn_points(_t(anchors), _t(pc), 5)
    d_j, i_j = jknn.knn_points(jnp.asarray(anchors), jnp.asarray(pc), 5)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    assert _rel(d_p, d_j) <= EXACT
    got = pknn.interpolate_deltas(_t(anchors), _t(pc), _t(deltas), k=5)
    want = jknn.interpolate_deltas(jnp.asarray(anchors), jnp.asarray(pc),
                                   jnp.asarray(deltas), k=5)
    assert got.shape == (2, 3, 40, 3) and _rel(got, want) <= EXACT


def test_fps_matches_jax():
    r = np.random.default_rng(6)
    pts = r.standard_normal((2, 70, 3)).astype(np.float32)
    np.testing.assert_array_equal(pfps.fps(_t(pts[0]), 9, start_idx=4),
                                  np.asarray(jfps.fps(jnp.asarray(pts[0]), 9,
                                                      start_idx=4)))
    np.testing.assert_array_equal(
        pfps.fps_batched(_t(pts), 11),
        np.asarray(jfps.fps_batched(jnp.asarray(pts), 11)))


def _motion():
    tm = pw.init_random_(pmv.MotionVAE(**MOTION), seed=7)
    params = pw.to_flax(pw.motion_vae_table(MOTION["depth"]), tm.state_dict())
    return tm, jmv.MotionVAE(**MOTION), jax.tree.map(jnp.asarray, params)


def test_motion_vae_encoder_matches_jax():
    tm, jm, params = _motion()
    r = np.random.default_rng(8)
    gs = [r.standard_normal((20, 14)).astype(np.float32),
          r.standard_normal((15, 14)).astype(np.float32)]
    static_gs, valid = pmv.pad_static_gs(gs)
    j_gs, j_valid = jmv.pad_static_gs(gs)
    np.testing.assert_array_equal(static_gs.numpy(), np.asarray(j_gs))
    pc = r.standard_normal((2, 32, 3)).astype(np.float32)
    dpc = (0.1 * r.standard_normal((2, 3, 32, 3))).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    jkl, jmean, jlogvar, jsampled = jm.apply(
        params, jnp.asarray(pc), jnp.asarray(dpc), j_gs, j_valid,
        method=jm.encode)
    jout = jm.apply(params, j_gs, j_valid, jnp.asarray(pc), jnp.asarray(dpc),
                    rng)
    noise = np.asarray(jax.random.normal(rng, jmean.shape))
    with torch.no_grad():
        kl, mean, logvar, sampled = tm.encode(_t(pc), _t(dpc), static_gs,
                                              valid)
        z = tm.reparameterize(mean, logvar, noise=_t(noise))
        out = tm(static_gs, valid, _t(pc), _t(dpc), noise=_t(noise))
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(jsampled))
    for name, g, w in (("kl", kl, jkl), ("mean", mean, jmean),
                       ("logvar", logvar, jlogvar),
                       ("z", z, jm.reparameterize(rng, jmean, jlogvar)),
                       ("logits", out["logits"], jout["logits"]),
                       ("kl (forward)", out["kl"], jout["kl"])):
        assert _rel(g.numpy(), w) <= MODEL, name


def test_freeze_subtrees_matches_jax():
    """The encoder freeze: frozen parameters get no update and take no part
    in the clip's norm, as optax.multi_transform's partition."""
    r = np.random.default_rng(14)
    tree = {"enc_0": {"kernel": r.standard_normal((3, 3)).astype(np.float32)},
            "dec_0": {"kernel": r.standard_normal((3, 3)).astype(np.float32)}}
    grads = jax.tree.map(lambda a: 3.0 * a + 1.0, tree)
    tx_j = jts.freeze_subtrees(jts.make_optimizer(lr=1e-2, warmup_steps=0,
                                                  grad_clip=0.5),
                               {"params": tree}, ("enc_",))
    params_j = {"params": jax.tree.map(jnp.asarray, tree)}
    upd_j, _ = tx_j.update({"params": jax.tree.map(jnp.asarray, grads)},
                           tx_j.init(params_j), params_j)
    upd_j = optax.apply_updates(params_j, upd_j)["params"]

    module = torch.nn.Module()
    module.encoder = torch.nn.Linear(3, 3, bias=False)
    module.decoder = torch.nn.Linear(3, 3, bias=False)
    with torch.no_grad():
        module.encoder.weight.copy_(_t(tree["enc_0"]["kernel"]))
        module.decoder.weight.copy_(_t(tree["dec_0"]["kernel"]))
    tx_p = pts.freeze_subtrees(pts.make_optimizer(lr=1e-2, warmup_steps=0,
                                                  grad_clip=0.5),
                               ("encoder.",))
    state = pts.create_train_state(module, tx_p)
    assert set(state.opt_state.mu) == {"decoder.weight"}
    pts.apply_updates(state, {"encoder.weight": _t(grads["enc_0"]["kernel"]),
                              "decoder.weight": _t(grads["dec_0"]["kernel"])},
                      tx_p)
    np.testing.assert_array_equal(module.encoder.weight.detach().numpy(),
                                  tree["enc_0"]["kernel"])
    assert _rel(module.decoder.weight.detach().numpy(),
                upd_j["dec_0"]["kernel"]) <= EXACT


def test_to_flax_copies():
    """`to_flax` returns arrays of their own: before, a flax tree made from
    a module aliased its parameters (a 1-D bias kept the tensor's memory),
    so the port's in-place optimizer step moved the tree too."""
    model = pw.init_random_(pmv.MotionVAE(**MOTION), seed=15)
    tree = pw.to_flax(pw.motion_vae_table(MOTION["depth"]), model.state_dict())
    want = np.array(tree["params"]["mean_fc"]["bias"])
    with torch.no_grad():
        model.mean_fc.bias.add_(1.0)
    np.testing.assert_array_equal(tree["params"]["mean_fc"]["bias"], want)
