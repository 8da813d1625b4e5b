"""Port parity: the static VAE (`models/static_vae.SparseTransformerVAE`)
against the JAX package's, in its shipped `swin` mode and in `full` mode,
where JAX's attention is the stock Pallas flash kernel (forced, in
interpret mode on the CPU) and the port's is K7's Function (its plain
version on the CPU, the flash threshold lowered to the test's shape).

A small width: 2 encoder + 2 decoder blocks, 2 heads of 64, resolution 16,
40 voxel slots of which 27 are valid. Parameters from `init_random_`
carried to flax by `utils/weights.static_vae_table`; inputs, the posterior
noise and the loss weights from a numpy seed. Compared: `encode` (z, mean,
logvar), `decode`, `forward` with and without a sampled posterior, and
the gradient of every parameter of a scalar loss of `forward`'s output,
each on the valid slots (the invalid ones are 0 on both sides). Bound:
rel L2 <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gvfdiffusion_torch.models.static_vae import SparseTransformerVAE
from gvfdiffusion_torch.sparse import attention as psa
from gvfdiffusion_torch.sparse.tensor import from_lists
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_tpu.models import static_vae as jsv
from gvfdiffusion_tpu.sparse import attention as jsa
from gvfdiffusion_tpu.sparse import tensor as jst

BOUND = 1e-4
CFG = dict(resolution=16, in_channels=8, model_channels=128, out_channels=14,
           latent_channels=4, num_blocks=2, window_size=8, num_heads=2)
L, N_VALID = 40, 27


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _voxels(seed=0):
    r = np.random.default_rng(seed)
    res = CFG["resolution"]
    coords, feats = [], []
    for n in (N_VALID, N_VALID - 9):
        cells = r.choice(res ** 3, n, replace=False)
        coords.append(np.stack(np.unravel_index(cells, (res,) * 3), -1))
        feats.append(r.standard_normal((n, CFG["in_channels"])).astype(
            np.float32))
    return coords, feats


def _models(mode):
    tm = pw.init_random_(SparseTransformerVAE(**CFG, attn_mode=mode), seed=3)
    jm = jsv.SparseTransformerVAE(**CFG, attn_mode=mode)
    params = pw.to_flax(pw.static_vae_table(CFG["num_blocks"]),
                        tm.state_dict())
    return tm, jm, jax.tree.map(jnp.asarray, params)


@pytest.fixture
def flash(monkeypatch):
    """`full` mode on the flash branch on both sides."""
    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", 1)
    monkeypatch.setattr(jsa, "_FORCE_FLASH", True)


def _check(name, got, want, valid):
    got = got.detach().numpy()[valid]
    want = np.asarray(want)[valid]
    err = _rel(got, want)
    assert err <= BOUND, (name, err)


@pytest.mark.parametrize("mode", ["swin", "full"])
def test_static_vae_matches_jax(mode, flash):
    tm, jm, params = _models(mode)
    coords, feats = _voxels()
    tx = from_lists(coords, feats, CFG["resolution"], capacity=L)
    jx = jst.from_lists(coords, feats, CFG["resolution"], capacity=L)
    valid = tx.valid.numpy()
    rng = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(rng, (2, L, CFG["latent_channels"])))
    # jitted: an eager op dispatched while the interpret-mode kernel's
    # callbacks still run can deadlock JAX's CPU client
    with pltpu.force_tpu_interpret_mode():
        jz, jmean, jlogvar = jax.block_until_ready(jax.jit(
            lambda p, x: jm.apply(p, x, None, False, method=jm.encode))(
                params, jx))
        jdec = jax.block_until_ready(jax.jit(
            lambda p, z: jm.apply(p, z, method=jm.decode))(params, jz))
        jout, _, _ = jax.block_until_ready(jax.jit(
            lambda p, x, r: jm.apply(p, x, r, True))(params, jx, rng))
    with torch.no_grad():
        z, mean, logvar = tm.encode(tx, sample_posterior=False)
        dec = tm.decode(z)
        out, _, _ = tm(tx, True, noise=torch.from_numpy(noise.copy()))
    _check("z", z.feats, jz.feats, valid)
    _check("mean", mean, jmean, valid)
    _check("logvar", logvar, jlogvar, valid)
    _check("decode", dec.feats, jdec.feats, valid)
    _check("forward(sample_posterior)", out.feats, jout.feats, valid)
    assert float(out.feats[~tx.valid].abs().max()) == 0.0

    # the gradient of every parameter of a scalar loss of forward's output
    w = np.random.default_rng(7).standard_normal(
        (2, L, CFG["out_channels"])).astype(np.float32)

    def jloss(p):
        o, _, _ = jm.apply(p, jx, None, False)
        return jnp.sum(o.feats * w)

    with pltpu.force_tpu_interpret_mode():
        jgrads = jax.block_until_ready(jax.jit(jax.grad(jloss))(params))
    o, _, _ = tm(tx, False)
    (o.feats * torch.from_numpy(w)).sum().backward()
    want = pw.from_flax(pw.static_vae_table(CFG["num_blocks"]), jgrads)
    assert set(want) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        err = _rel(p.grad.numpy(), want[name].numpy())
        assert err <= BOUND, (name, err)


def test_static_vae_remat_and_serialized_modes():
    """remat_blocks recomputes blocks in the backward pass and gives the
    same gradients; the serialized schedule modes are not ported and
    raise."""
    coords, feats = _voxels(1)
    tx = from_lists(coords, feats, CFG["resolution"], capacity=L)
    grads = []
    for remat in (0, 2):
        tm = pw.init_random_(SparseTransformerVAE(**CFG, remat_blocks=remat),
                             seed=4)
        o, mean, _ = tm(tx, False)
        (o.feats.square().sum() + mean.sum()).backward()
        grads.append({n: p.grad for n, p in tm.named_parameters()})
    for n in grads[0]:
        assert torch.allclose(grads[0][n], grads[1][n], rtol=1e-5,
                              atol=1e-7), n
    for mode in ("shift_window", "shift_sequence", "shift_order"):
        with pytest.raises(NotImplementedError):
            SparseTransformerVAE(**CFG, attn_mode=mode)


def test_registry_builds_the_static_vae(tmp_path):
    """`create_model("SparseTransformerVAE", ...)` and `from_pretrained` of
    a directory written by `save_params_npz` build the port's static VAE,
    `remat_blocks` reaching the class as in JAX; both forwards agree with
    JAX's `create_model` / `from_pretrained` on the same numpy parameters
    (fp32, rel L2 <= BOUND)."""
    import json
    import os

    from gvfdiffusion_torch.models import registry as pr
    from gvfdiffusion_tpu.models import registry as jr

    args = dict(CFG, attn_mode="swin", use_fp16=True, use_checkpoint=False,
                remat_blocks=1)
    built = pr.create_model("SparseTransformerVAE", **args)
    assert isinstance(built, SparseTransformerVAE) and built.remat_blocks == 1
    assert jr.create_model("SparseTransformerVAE", **args).remat_blocks == 1
    pw.init_random_(built, seed=6)
    pr.save_params_npz(pr.flax_params("SparseTransformerVAE", args, built),
                       os.path.join(tmp_path, "vae.npz"))
    with open(os.path.join(tmp_path, "vae.json"), "w") as f:
        json.dump({"name": "SparseTransformerVAE", "args": args}, f)
    tm = pr.from_pretrained(str(tmp_path), "vae", device="cpu")
    assert tm.remat_blocks == 1 and not tm.training
    jm, params = jr.from_pretrained(str(tmp_path), "vae")
    params = jax.tree.map(jnp.asarray, params)

    coords, feats = _voxels(2)
    tx = from_lists(coords, feats, CFG["resolution"], capacity=L)
    jx = jst.from_lists(coords, feats, CFG["resolution"], capacity=L)
    valid = tx.valid.numpy()
    jout, jmean, _ = jax.block_until_ready(jax.jit(
        lambda p, x: jm.apply(p, x, None, False))(params, jx))
    with torch.no_grad():
        out, mean, _ = tm(tx, False)
        out_built, _, _ = built(tx, False)
    _check("from_pretrained mean", mean, jmean, valid)
    _check("from_pretrained forward", out.feats, jout.feats, valid)
    _check("create_model forward", out_built.feats, jout.feats, valid)
