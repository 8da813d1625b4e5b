"""Port parity: the configuration fields that the registry passes to the
TRELLIS models, against the JAX package on the CPU, at fp32:

  * a 2-block SLat flow with share_mod and the composed cross sublayer
    of qk_rms_norm_cross, its torso uncompacted, against JAX with its flash kernel forced (`_FORCE_FLASH`,
    interpret mode): K7's plain version in the port;
  * through the port's `from_pretrained`, from a directory the JAX
    registry wrote: a 2-block sparse-structure flow with RoPE and
    share_mod, the occupancy decoder with GroupNorm, the Gaussian decoder
    without a position embedding and with qk_rms_norm (which JAX accepts
    and does not use).

Rel L2 <= 1e-4 on the valid rows, as the other TRELLIS chains
(tests/test_torch_port_trellis.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _pretrained import random_params, write_model
from gvfdiffusion_torch.models import registry as pr
from gvfdiffusion_torch.models.trellis.slat_flow import SLatFlowModel
from gvfdiffusion_torch.ops import flash_attention as fl
from gvfdiffusion_torch.sparse import attention as psa
from gvfdiffusion_torch.sparse.tensor import SparseVoxels
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_tpu.models.trellis import slat_flow as jsf
from gvfdiffusion_tpu.sparse import attention as jsa
from gvfdiffusion_tpu.sparse import tensor as jst

CHAIN = 1e-4


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


def _voxels(seed, cap, n, res=16, C=4):
    r = np.random.default_rng(seed)
    coords = np.zeros((1, cap, 3), np.int32)
    valid = np.zeros((1, cap), bool)
    lin = r.choice(res ** 3, n, replace=False)
    coords[0, :n] = np.stack([lin // res ** 2, lin // res % res, lin % res],
                             -1)
    valid[0, :n] = True
    feats = r.standard_normal((1, cap, C)).astype(np.float32) \
        * valid[..., None]
    return (SparseVoxels(torch.from_numpy(feats), torch.from_numpy(coords),
                         torch.from_numpy(valid), res),
            jst.SparseVoxels(jnp.asarray(feats), jnp.asarray(coords),
                             jnp.asarray(valid), resolution=res))


SLF_FIELDS = dict(resolution=16, in_channels=4, model_channels=128,
                  cond_channels=128, out_channels=4, num_blocks=2,
                  num_heads=2, num_io_res_blocks=2, io_block_channels=(16,),
                  qk_rms_norm=True, qk_rms_norm_cross=True, share_mod=True)


def test_slat_flow_fields_uncompacted_fp32_match_jax(monkeypatch):
    """share_mod, the composed qk_rms_norm_cross sublayer, fp32, the torso
    uncompacted over 256 slots: K7 in the port (its threshold lowered to
    this size), the stock flash kernel in JAX (`_FORCE_FLASH`)."""
    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", 128 * 128)
    calls = []
    real = fl.flash_attention
    monkeypatch.setattr(fl, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    p, j = _voxels(31, cap=256, n=200)
    r = np.random.default_rng(32)
    tt = np.array([604.0], np.float32)
    cond = r.standard_normal((1, 20, 128)).astype(np.float32)
    jm = jsf.SLatFlowModel(**SLF_FIELDS)
    args = (j, jnp.asarray(tt), jnp.asarray(cond))
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          *args), seed=33)
    port = SLatFlowModel(**SLF_FIELDS)
    port.load_state_dict(pw.slat_flow_state_dict_from_flax(params, 2, (16,),
                                                           2))
    assert not hasattr(port.blocks[0], "adaLN_modulation")
    with torch.no_grad():
        got = port.eval()(p, torch.from_numpy(tt), torch.from_numpy(cond))
    assert len(calls) == 2  # the torso's self-attention, one per block
    monkeypatch.setattr(jsa, "_FORCE_FLASH", True)
    # jitted and waited on: an eager op dispatched while the interpret-mode
    # kernel's callbacks still run can deadlock JAX's CPU client
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(jax.jit(jm.apply)(params, *args))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    m = got.valid.numpy()
    err = _rel(got.feats.numpy()[m], np.asarray(want.feats)[m])
    assert err <= CHAIN, err


def _module_case(kind, r):
    """(name, release-style args, port inputs, JAX inputs, output of
    each) for one model's new fields, at 2 blocks."""
    if kind == "ss_flow":
        x = r.standard_normal((1, 8, 8, 8, 4)).astype(np.float32)
        t = np.array([731.0], np.float32)
        c = r.standard_normal((1, 20, 128)).astype(np.float32)
        args = dict(resolution=8, in_channels=4, out_channels=4,
                    model_channels=128, cond_channels=128, num_blocks=2,
                    num_head_channels=64, patch_size=2, pe_mode="rope",
                    share_mod=True, qk_rms_norm=True,
                    qk_rms_norm_cross=True, remat_blocks=1, use_fp16=True)
        return ("SparseStructureFlowModel", args,
                [torch.from_numpy(a) for a in (x, t, c)],
                [jnp.asarray(a) for a in (x, t, c)],
                lambda o: o, lambda o: o)
    if kind == "ss_decoder":
        z = r.standard_normal((1, 4, 4, 4, 4)).astype(np.float32)
        args = dict(out_channels=1, latent_channels=4, num_res_blocks=1,
                    num_res_blocks_middle=1, channels=[64, 32],
                    norm_type="group", use_fp16=True)
        return ("SparseStructureDecoder", args, [torch.from_numpy(z)],
                [jnp.asarray(z)], lambda o: o, lambda o: o)
    p, j = _voxels(3, cap=64, n=50, C=4)
    m = p.valid.numpy()[0].repeat(8)
    args = dict(resolution=16, model_channels=128, latent_channels=4,
                num_blocks=2, num_head_channels=64, window_size=4,
                pe_mode="none", qk_rms_norm=True, use_fp16=True)
    return ("SLatGaussianDecoder", args, [p], [j],
            lambda o: o[0].to_activated_tensor()[0][m],
            lambda o: np.asarray(o[0].to_activated_tensor())[0][m])


@pytest.mark.parametrize("kind", ["ss_flow", "ss_decoder", "gs_decoder"])
def test_model_fields_from_pretrained_match_jax(kind, tmp_path):
    """The sparse-structure flow with RoPE and share_mod (and JAX's
    remat_blocks, which the port's registry drops), the occupancy
    decoder with GroupNorm, the Gaussian decoder with pe_mode "none" and
    qk_rms_norm (accepted, no effect, as in JAX), built by the registry."""
    r = np.random.default_rng(50)
    name, args, p_in, j_in, p_out, j_out = _module_case(kind, r)
    jm, params = write_model(str(tmp_path), kind, name, args, j_in, seed=51)
    model = pr.from_pretrained(str(tmp_path), kind, device="cpu")
    with torch.no_grad():
        got = p_out(model(*p_in))
    err = _rel(got, j_out(jm.apply(params, *j_in)))
    assert err <= CHAIN, err
