"""Port parity: K7, the streaming flash attention over key validity
(gvfdiffusion_torch/ops/flash_attention.py), against the JAX package's
`_flash_full_attention` (the stock Pallas TPU flash kernel) run in
interpret mode on the CPU, as tests/test_sparse.py runs it; its dispatch
from `full_sparse_attention`; and the SLat flow with an uncompacted torso
against JAX's with the flash kernel forced, and against its own compacted
torso.

Inputs from a numpy seed, handed to both packages. Every query row is
compared, the invalid ones too (the TPU kernel computes them: every query
is in segment 1), and a batch row with no valid key (the mean of V over
the key count padded to 512). Tolerances: fp32 atol 2e-5, the JAX suite's
own for this kernel; bf16 rel L2 <= 1e-2 (P rounds to bf16 against the
running maximum of the TPU kernel's 512-key blocks, against the final
maximum in the plain version); the SLat models rel L2 <= 1e-4 on the valid
rows, as the other TRELLIS chains (tests/test_torch_port_trellis.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gvfdiffusion_torch.models.trellis.slat_flow import SLatFlowModel
from gvfdiffusion_torch.ops import flash_attention as fl
from gvfdiffusion_torch.sparse import attention as psa
from gvfdiffusion_torch.sparse.tensor import SparseVoxels
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_tpu.models.trellis import slat_flow as jsf
from gvfdiffusion_tpu.sparse import attention as jsa
from gvfdiffusion_tpu.sparse import tensor as jst
from gvfdiffusion_tpu.utils import weight_convert as wc

ATOL_F32 = 2e-5
REL_BF16 = 1e-2
CHAIN = 1e-4
B, H, D = 2, 2, 64


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


def _validity(kind, lk, seed):
    """[B, lk] key validity: a prefix (as the downsample packs parents),
    scattered, or a batch row with none."""
    r = np.random.default_rng(seed)
    v = np.zeros((B, lk), bool)
    if kind == "prefix":
        v[0, :lk // 3] = True
        v[1, :lk - 5] = True
    elif kind == "scattered":
        v[0] = r.uniform(size=lk) < 0.3
        v[1] = r.uniform(size=lk) < 0.8
    else:  # "empty": row 0 has no valid key
        v[1] = r.uniform(size=lk) < 0.5
    return v


def _inputs(lq, lk, seed):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((B, n, H, D)).astype(np.float32)
                 for n in (lq, lk, lk))


def _jax_flash(q, k, v, kv_valid, dtype):
    qv = jnp.ones(q.shape[:2], bool)
    # jitted and waited on: an eager op dispatched while the interpret-mode
    # kernel's callbacks still run can deadlock JAX's CPU client
    with pltpu.force_tpu_interpret_mode():
        out = jax.block_until_ready(jax.jit(
            lambda a, b, c, kv: jsa._flash_full_attention(
                a, b, c, qv, kv).astype(jnp.float32))(
            *(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
            jnp.asarray(kv_valid)))
    return np.asarray(out)


@pytest.mark.parametrize("kind", ["prefix", "scattered", "empty"])
@pytest.mark.parametrize("lk", [70, 700])
@pytest.mark.parametrize("lq", [130, 600])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_jax_pallas(lq, lk, kind, dtype):
    q, k, v = _inputs(lq, lk, seed=lq + lk)
    valid = _validity(kind, lk, seed=lk)
    want = _jax_flash(q, k, v, valid, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    got = fl.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                             torch.from_numpy(valid), D ** -0.5)
    assert got.dtype == tdt and tuple(got.shape) == (B, lq, H, D)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)
    else:
        assert _rel(got, want) <= REL_BF16, _rel(got, want)
    if kind == "empty":
        # every query row of the row without valid keys: sum(V) / lk_pad
        mean = v[0].astype(np.float64).sum(0) / fl.padded_keys(lk)
        tol = ATOL_F32 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(got[0], np.broadcast_to(mean, got[0].shape),
                                   atol=tol)


def test_flash_launch_count_and_impl():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; impl accepts None and "plain" only."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(64, 70, seed=3))
    valid = torch.from_numpy(_validity("prefix", 70, seed=3))
    fl.reset_launch_counts()
    a = fl.flash_attention(q, k, v, valid, D ** -0.5)
    b = fl.flash_attention(q, k, v, valid, D ** -0.5, impl="plain")
    assert torch.equal(a, b) and fl.launch_counts["flash_attention"] == 0
    with pytest.raises(ValueError):
        fl.flash_attention(q, k, v, valid, D ** -0.5, impl="cuda")


def test_full_sparse_attention_takes_the_flash_branch(monkeypatch):
    """Past K5's rule (Lk > 4096) and over FLASH_SCORE_ELEMENTS, the JAX
    dispatch takes K7; with the port's threshold lowered, a small shape
    takes that branch too (every query row of it, against the JAX flash
    kernel forced in interpret mode)."""
    lq = lk = 300  # under K5's FUSED_SCORE_ELEMENTS
    q, k, v = _inputs(lq, lk, seed=5)
    valid = _validity("scattered", lk, seed=6)
    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", lq * lk)
    calls = []
    real = fl.flash_attention
    monkeypatch.setattr(fl, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = psa.full_sparse_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(valid), torch.from_numpy(valid), torch.float32)
    assert calls == [1]
    want = _jax_flash(q, k, v, valid, jnp.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32, rtol=0)
    # one score element under the threshold stays on the masked path
    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", lq * lk + 1)
    psa.full_sparse_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              torch.from_numpy(valid),
                              torch.from_numpy(valid), torch.float32)
    assert calls == [1]


SLF_KW = dict(resolution=16, in_channels=4, model_channels=128,
              cond_channels=128, out_channels=4, num_blocks=2, num_heads=2,
              num_io_res_blocks=2, io_block_channels=(16,), qk_rms_norm=True)


def _slat_models(seed=30):
    sd = {k: v.numpy().copy() for k, v in pw.init_random_(
        SLatFlowModel(**SLF_KW), seed).state_dict().items()}
    tree = wc.convert_slat_flow(sd, num_blocks=2, io_block_channels=(16,),
                                num_io_res_blocks=2, qk_rms_norm=True)
    port = SLatFlowModel(**SLF_KW)
    port.load_state_dict(pw.slat_flow_state_dict_from_flax(tree, 2, (16,), 2))
    return port.eval(), tree


def _voxels(seed, cap, n, res=16, C=4):
    r = np.random.default_rng(seed)
    coords = np.zeros((1, cap, 3), np.int32)
    valid = np.zeros((1, cap), bool)
    lin = r.choice(res ** 3, n, replace=False)
    coords[0, :n] = np.stack([lin // res ** 2, lin // res % res, lin % res], -1)
    valid[0, :n] = True
    feats = r.standard_normal((1, cap, C)).astype(np.float32) * valid[..., None]
    port = SparseVoxels(torch.from_numpy(feats), torch.from_numpy(coords),
                        torch.from_numpy(valid), res)
    jax_sv = jst.SparseVoxels(jnp.asarray(feats), jnp.asarray(coords),
                              jnp.asarray(valid), resolution=res)
    return port, jax_sv


def test_slat_flow_uncompacted_torso_matches_jax_flash(monkeypatch):
    """torso_capacity=None: the torso's full self-attention over all 256
    slots takes K7 (the port's threshold lowered to this size) and JAX's
    flash kernel (`_FORCE_FLASH`, interpret mode, its fused K3 in interpret
    mode too); the valid rows agree."""
    monkeypatch.setenv("GVF_FUSED", "interpret")
    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", 128 * 128)
    calls = []
    real = fl.flash_attention
    monkeypatch.setattr(fl, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    port, tree = _slat_models()
    p, j = _voxels(31, cap=256, n=200)
    r = np.random.default_rng(32)
    t = np.array([604.0], np.float32)
    cond = r.standard_normal((1, 20, 128)).astype(np.float32)
    with torch.no_grad():
        got = port(p, torch.from_numpy(t), torch.from_numpy(cond))
    assert len(calls) == 2  # one per torso block
    monkeypatch.setattr(jsa, "_FORCE_FLASH", True)
    with pltpu.force_tpu_interpret_mode():  # jitted, as _jax_flash
        want = jax.block_until_ready(jax.jit(jsf.SLatFlowModel(**SLF_KW).apply)(
            tree, j, jnp.asarray(t), jnp.asarray(cond)))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    m = got.valid.numpy()
    err = _rel(got.feats.numpy()[m], np.asarray(want.feats)[m])
    assert err <= CHAIN, err


def test_slat_flow_uncompacted_equals_compacted(monkeypatch):
    """The same weights with the torso compacted to 16 slots (the masked
    path at this size) and uncompacted at 32 (K7 at the lowered
    threshold): the same function on the valid rows when the parents fit
    (JAX tests/test_sparse.py:350-367)."""
    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", 32 * 32)
    port, _ = _slat_models(seed=33)
    compacted = SLatFlowModel(**SLF_KW, torso_capacity=16)
    compacted.load_state_dict(port.state_dict())
    p, _ = _voxels(34, cap=32, n=12)  # at most 12 parents
    calls = []
    real = fl.flash_attention
    monkeypatch.setattr(fl, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    t = torch.tensor([3.0])
    cond = torch.from_numpy(np.random.default_rng(35).standard_normal(
        (1, 5, 128)).astype(np.float32))
    with torch.no_grad():
        ref = port(p, t, cond)
        out = compacted.eval()(p, t, cond)
    assert len(calls) == 2  # the uncompacted torso's two blocks only
    m = p.valid.numpy()
    err = _rel(out.feats.numpy()[m], ref.feats.numpy()[m])
    assert err <= CHAIN, err
