"""Port parity of the two trainers' models at the head widths that reach
K5, K6 and K7 padded (ops/_widths.py), on the CPU, against JAX with its
Pallas kernels in interpret mode (each JAX call jitted and blocked on):

  * the DiT (2 blocks, C = 128, tests/_dit_configs.py's size and non-zero
    weights bridged by utils/weights.py) at 8 heads of 16 and 1 head of
    128, the widths main_latent --model.num_heads=32 and =4 give at the
    shipped 512 channels: the composed path without a cache (JAX's
    GVF_FUSED=off, the trainer's path: K5 self and cross, K6), and one
    training micro-step's v-prediction loss and gradients;
  * the static VAE (`full` mode, tests/test_torch_port_static_vae.py's
    size with 192 channels) at 2 heads of 96, the width main_vae
    --static_vae.num_heads=8 gives at 768 channels: encode, decode and
    forward through K7's plain version against JAX's stock flash kernel.

Tolerances, those the same paths take at the shipped widths: the composed
DiT rel L2 2e-3 and its micro-step's loss 5e-5 relative, gradients 5e-4
rel L2 (tests/test_torch_port_dit_config_paths.py); the static VAE rel L2
1e-4 on the valid slots (tests/test_torch_port_static_vae.py). About 65 s
alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _dit_configs import (BASE, BLOCKS, N, ORDER, inputs, nonzero, rel,
                          tpu_dispatch)
from jax.experimental.pallas import tpu as pltpu

from gvfdiffusion_torch.diffusion.gaussian_diffusion import create_diffusion
from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.models.static_vae import SparseTransformerVAE
from gvfdiffusion_torch.sparse import attention as psa
from gvfdiffusion_torch.sparse.tensor import from_lists
from gvfdiffusion_torch.train.diffusion_trainer import loss_and_grads
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_torch.utils.weights import dit_state_dict_from_flax
from gvfdiffusion_tpu.diffusion import gaussian_diffusion as jgd
from gvfdiffusion_tpu.models import static_vae as jsv
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT
from gvfdiffusion_tpu.sparse import attention as jsa
from gvfdiffusion_tpu.sparse import tensor as jst

COMPOSED_REL = 2e-3
LOSS_REL, GRAD_REL = 5e-5, 5e-4
VAE_REL = 1e-4
# heads at C = 128 -> widths 16 and 128
DIT_HEADS = {16: 8, 128: 1}
VAE_CFG = dict(resolution=16, in_channels=8, model_channels=192,
               out_channels=14, latent_channels=4, num_blocks=2,
               window_size=8, num_heads=2)
VAE_L = 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker while this module runs (the
    suite runs several workers at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS = {}


def _pair(width):
    """(JaxDiT, its non-zero params, the port's DiT with them) at heads of
    `width`."""
    if width not in _PAIRS:
        heads = DIT_HEADS[width]
        model = JaxDiT(**BASE, num_heads=heads)
        inp = inputs(0)
        params = nonzero(model.init(jax.random.PRNGKey(0), *(
            jnp.asarray(inp[k]) for k in ORDER)), seed=1)
        port = DiT(**BASE, num_heads=heads)
        port.load_state_dict(dit_state_dict_from_flax(
            jax.tree.map(np.asarray, params), BLOCKS))
        _PAIRS[width] = model, params, port.eval()
    return _PAIRS[width]


@pytest.mark.parametrize("width", list(DIT_HEADS))
def test_dit_composed_at_new_widths_matches_jax(width, monkeypatch):
    monkeypatch.setenv("GVF_FUSED", "off")
    tpu_dispatch(monkeypatch)
    model, params, port = _pair(width)
    assert port.blocks[0].spatial_self_attn.head_dim == width
    inp = inputs(3, l=130)
    jout = jax.block_until_ready(jax.jit(lambda p, *a: model.apply(p, *a))(
        params, *(jnp.asarray(inp[k]) for k in ORDER)))
    with torch.no_grad():
        pout = port(*(torch.from_numpy(inp[k]) for k in ORDER))
    err = rel(pout, jout)
    print(f"DiT heads of {width} composed: rel L2 {err:.3e}")
    assert float(np.abs(np.asarray(jout)).mean()) > 0.1
    assert err <= COMPOSED_REL, err


@pytest.mark.parametrize("width", list(DIT_HEADS))
def test_dit_micro_step_at_new_widths_matches_jax(width, monkeypatch):
    """The v-prediction loss at a batch of 2 x 4 frames (image tokens 130)
    and its gradients over every parameter."""
    monkeypatch.setenv("GVF_FUSED", "off")
    tpu_dispatch(monkeypatch)
    model, params, port = _pair(width)
    r = np.random.default_rng(8)
    inp = inputs(9, b=2, t=4, l=130)
    t = np.array([437, 12])
    noise = r.standard_normal((2, 4, N, 16)).astype(np.float32)
    kw = dict(schedule="cosine", steps=1000, mean_type="v",
              rescale_timesteps=True)
    jd, pd = jgd.create_diffusion(**kw), create_diffusion(**kw)
    cond = {k: jnp.asarray(inp[k]) for k in ORDER[2:]}

    def loss_fn(p):
        terms, _ = jd.training_losses(
            lambda x, tt: model.apply(p, x, tt, **cond),
            jnp.asarray(inp["x"]), jnp.asarray(t), None,
            noise=jnp.asarray(noise))
        return jnp.mean(terms["loss"])

    jloss, jgrads = jax.block_until_ready(
        jax.jit(jax.value_and_grad(loss_fn))(params))
    jg = dit_state_dict_from_flax(jax.tree.map(np.asarray, jgrads), BLOCKS)
    batch = {"latent": torch.from_numpy(inp["x"]),
             **{k: torch.from_numpy(inp[k]) for k in ORDER[2:]}}
    loss, _, grads = loss_and_grads(port, pd, batch, torch.from_numpy(t),
                                    torch.from_numpy(noise))
    lerr = abs(float(loss) - float(jloss)) / abs(float(jloss))
    gerr = rel(torch.cat([grads[k].flatten() for k in grads]),
               torch.cat([jg[k].flatten() for k in grads]))
    print(f"DiT heads of {width} micro-step: loss {lerr:.2e}, gradients "
          f"{gerr:.2e}")
    assert set(grads) == set(jg)
    assert lerr <= LOSS_REL, lerr
    assert gerr <= GRAD_REL, gerr


def test_static_vae_at_heads_of_96_matches_jax(monkeypatch):
    """`full` mode on the flash branch on both sides (the flash threshold
    lowered to the test's shape, JAX's stock kernel forced)."""
    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", 1)
    monkeypatch.setattr(jsa, "_FORCE_FLASH", True)
    tm = pw.init_random_(SparseTransformerVAE(**VAE_CFG, attn_mode="full"),
                         seed=3)
    assert VAE_CFG["model_channels"] // VAE_CFG["num_heads"] == 96
    jm = jsv.SparseTransformerVAE(**VAE_CFG, attn_mode="full")
    params = jax.tree.map(jnp.asarray, pw.to_flax(
        pw.static_vae_table(VAE_CFG["num_blocks"]), tm.state_dict()))
    r = np.random.default_rng(0)
    res = VAE_CFG["resolution"]
    coords, feats = [], []
    for n in (27, 18):
        cells = r.choice(res ** 3, n, replace=False)
        coords.append(np.stack(np.unravel_index(cells, (res,) * 3), -1))
        feats.append(r.standard_normal(
            (n, VAE_CFG["in_channels"])).astype(np.float32))
    tx = from_lists(coords, feats, res, capacity=VAE_L)
    jx = jst.from_lists(coords, feats, res, capacity=VAE_L)
    valid = tx.valid.numpy()
    with pltpu.force_tpu_interpret_mode():
        jz, jmean, _ = jax.block_until_ready(jax.jit(
            lambda p, x: jm.apply(p, x, None, False, method=jm.encode))(
                params, jx))
        jdec = jax.block_until_ready(jax.jit(
            lambda p, z: jm.apply(p, z, method=jm.decode))(params, jz))
        jout, _, _ = jax.block_until_ready(jax.jit(
            lambda p, x: jm.apply(p, x, None, False))(params, jx))
    with torch.no_grad():
        z, mean, _ = tm.encode(tx, sample_posterior=False)
        dec = tm.decode(z)
        out, _, _ = tm(tx, False)
    for name, got, want in (("z", z.feats, jz.feats), ("mean", mean, jmean),
                            ("decode", dec.feats, jdec.feats),
                            ("forward", out.feats, jout.feats)):
        err = rel(got.numpy()[valid], np.asarray(want)[valid])
        print(f"static VAE heads of 96 {name}: rel L2 {err:.3e}")
        assert err <= VAE_REL, (name, err)
