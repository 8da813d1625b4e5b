"""Port parity of the static VAE at heads wider than 128 lanes, on the CPU,
against JAX with its stock flash kernel in interpret mode (each JAX call
jitted and blocked on): `full` mode on the flash branch on both sides (the
flash threshold lowered to the test's shape, JAX's stock kernel forced),
at 384 channels in 2 heads of 192 and at 256 channels in 1 head of 256 -
the widths main_vae --static_vae.num_heads=4 and =3 give at the shipped
768 channels, whose attention the card runs on
`csrc/flash_attention_wide.cu`. Encode, decode and forward, with non-zero
weights carried to JAX by `utils/weights.py` (the head count changes no
parameter shape). Tolerance, the static VAE's at the shipped widths: rel
L2 1e-4 on the valid slots (tests/test_torch_port_static_vae.py). About 40
s alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gvfdiffusion_torch.models.static_vae import SparseTransformerVAE
from gvfdiffusion_torch.ops import flash_attention as fl
from gvfdiffusion_torch.sparse import attention as psa
from gvfdiffusion_torch.sparse.tensor import from_lists
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_tpu.models import static_vae as jsv
from gvfdiffusion_tpu.sparse import attention as jsa
from gvfdiffusion_tpu.sparse import tensor as jst

VAE_REL = 1e-4
VAE_L = 40
# (channels, heads): heads of 192 and 256
CASES = [(384, 2), (256, 1)]


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


@pytest.mark.parametrize("channels,heads", CASES,
                         ids=[f"heads-of-{c // h}" for c, h in CASES])
def test_static_vae_wide_heads_match_jax(monkeypatch, channels, heads):
    cfg = dict(resolution=16, in_channels=8, model_channels=channels,
               out_channels=14, latent_channels=4, num_blocks=2,
               window_size=8, num_heads=heads)
    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", 1)
    monkeypatch.setattr(jsa, "_FORCE_FLASH", True)
    applied = []
    real = fl.flash_attention_reference
    monkeypatch.setattr(fl, "flash_attention_reference",
                        lambda q, *a: applied.append(q.shape[-1])
                        or real(q, *a))
    tm = pw.init_random_(SparseTransformerVAE(**cfg, attn_mode="full"),
                         seed=4)
    jm = jsv.SparseTransformerVAE(**cfg, attn_mode="full")
    params = jax.tree.map(jnp.asarray, pw.to_flax(
        pw.static_vae_table(cfg["num_blocks"]), tm.state_dict()))
    r = np.random.default_rng(1)
    res = cfg["resolution"]
    coords, feats = [], []
    for n in (31, 17):
        cells = r.choice(res ** 3, n, replace=False)
        coords.append(np.stack(np.unravel_index(cells, (res,) * 3), -1))
        feats.append(r.standard_normal(
            (n, cfg["in_channels"])).astype(np.float32))
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
    # every attention of the port's run went through K7's plain version at
    # the wide width
    assert applied and set(applied) == {channels // heads}
    for name, got, want in (("z", z.feats, jz.feats), ("mean", mean, jmean),
                            ("decode", dec.feats, jdec.feats),
                            ("forward", out.feats, jout.feats)):
        err = _rel(got.numpy()[valid], np.asarray(want)[valid])
        print(f"static VAE heads of {channels // heads} {name}: rel L2 "
              f"{err:.3e}")
        assert err <= VAE_REL, (name, err)
