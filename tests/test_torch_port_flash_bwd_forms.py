"""Port parity: K7's gradient in every form of its forward (bf16 at heads of
32, 64 and 128, fp32 at heads of 32 and 128; fp32 at heads of 64 is
tests/test_torch_port_flash_bwd.py's). The port's plain backward
(`flash_attention_backward_reference`, and `FlashAttention` under
autograd, which runs it on the CPU) against `jax.vjp` of the JAX package's
`_flash_full_attention`, whose backward is the stock Pallas TPU kernels'
dkv and dq, run in interpret mode on the CPU and jitted; and the dispatch:
`full_sparse_attention` under grad takes the flash branch in each form.

Inputs and the output gradient from a numpy seed, handed to both packages
in the form's dtype. One call per form holds every validity at once, one
per batch row: a prefix (the VAE's voxels come first in their slots),
scattered, and a row with no valid key (P = 1 / Lk-padded-to-512 on every
key, so its keys get dV != 0); Lq = 130 against Lk = 300, off the 512-key
padding. Every query row is compared.

Tolerances. fp32: atol 2e-5 on o, dq, dk and dv, the fp32 forward's and
heads of 64's. bf16: both sides round P and dS to bf16 where the stock
kernels do and each gradient once, but from fp32 values that differ in
their last bits (exp against exp2, sums in another order), so a value near
a bf16 midpoint rounds apart: rel L2 BF16_REL 1e-2 (readings 0 - 3.0e-3
at these shapes, the output's the largest) and max abs BF16_ATOL 3.2e-2
(readings up to 7.8e-3, one bf16 ulp of values in [1, 2)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gvfdiffusion_torch.ops import flash_attention as fl
from gvfdiffusion_torch.sparse import attention as psa
from gvfdiffusion_tpu.sparse import attention as jsa

ATOL = 2e-5
BF16_REL, BF16_ATOL = 1e-2, 3.2e-2
B, H, LQ, LK = 3, 2, 130, 300
FORMS = [("bfloat16", 32), ("bfloat16", 64), ("bfloat16", 128),
         ("float32", 32), ("float32", 128)]
IDS = [f"{'bf16' if dt == 'bfloat16' else 'fp32'}-d{d}" for dt, d in FORMS]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker while this module runs (the
    suite runs several workers at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _validity(lk, seed):
    """[B, lk]: row 0 a prefix, row 1 scattered, row 2 no valid key."""
    r = np.random.default_rng(seed)
    v = np.zeros((B, lk), bool)
    v[0, :lk // 3] = True
    v[1] = r.uniform(size=lk) < 0.3
    return v


def _inputs(D, seed):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((B, n, H, D)).astype(np.float32)
               for n in (LQ, LK, LK))
    return q, k, v, r.standard_normal((B, LQ, H, D)).astype(np.float32)


def _jax_grads(arrays, valid, dtype):
    """(out, dq, dk, dv) of JAX's flash attention in `dtype`, kernels in
    interpret mode, as fp32 numpy."""
    qv, kv = jnp.ones((B, LQ), bool), jnp.asarray(valid)

    def fwd_bwd(a, b, c, g):
        out, vjp = jax.vjp(
            lambda a_, b_, c_: jsa._flash_full_attention(a_, b_, c_, qv, kv),
            a, b, c)
        return (out, *vjp(g))

    # jitted: an eager op dispatched while the interpret-mode kernels'
    # callbacks still run can deadlock JAX's CPU client
    with pltpu.force_tpu_interpret_mode():
        res = jax.block_until_ready(jax.jit(fwd_bwd)(
            *(jnp.asarray(a, dtype) for a in arrays)))
    return [np.asarray(a.astype(jnp.float32)) for a in res]


def _close(name, got, want, dtype):
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=name)
        return
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    mae = np.abs(got - want).max()
    print(f"{name}: rel_l2 {rel:.3e} max_abs {mae:.3e}")
    assert rel <= BF16_REL and mae <= BF16_ATOL, (name, rel, mae)


@pytest.mark.parametrize("dtype_name,D", FORMS, ids=IDS)
def test_flash_backward_forms_match_jax_pallas(dtype_name, D):
    dtype = getattr(torch, dtype_name)
    arrays = _inputs(D, seed=D + len(dtype_name))
    valid = _validity(LK, seed=D)
    want = _jax_grads(arrays, valid, getattr(jnp, dtype_name))
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    tq, tk, tv = (a.clone().requires_grad_(True) for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    out = fl.flash_attention(tq, tk, tv, tvalid, D ** -0.5)
    out.backward(do)
    got = [out.detach(), tq.grad, tk.grad, tv.grad]
    ref = fl.flash_attention_backward_reference(q, k, v, tvalid, D ** -0.5,
                                                out.detach(), do)
    for name, g, r in zip(("dq", "dk", "dv"), got[1:], ref):
        assert torch.equal(g, r), name  # the Function runs the plain version
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and tuple(g.shape) == w.shape, name
        _close(f"{dtype_name} d{D} {name}", g, w, dtype)
    # the row without valid keys: dV = sum(dO) / lk_pad on every key
    want_dv = do[2].double().sum(0) / fl.padded_keys(LK)
    _close(f"{dtype_name} d{D} empty-row dv", got[3][2],
           np.broadcast_to(want_dv.numpy(), (LK, H, D)), dtype)
    assert float(got[3][2].abs().max()) > 0


@pytest.mark.parametrize("dtype_name,D", FORMS, ids=IDS)
def test_full_sparse_attention_under_grad_takes_the_flash_branch(
        monkeypatch, dtype_name, D):
    """With the threshold lowered to the shape, `full_sparse_attention`
    under grad in the form's dtype goes through K7's Function once, and its
    gradients (through the casts to the dtype) are the plain backward's."""
    dtype = getattr(torch, dtype_name)
    lq = lk = 300
    r = np.random.default_rng(D)
    q, k, v, do = (torch.from_numpy(r.standard_normal((2, n, H, D)).astype(
        np.float32)) for n in (lq, lk, lk, lq))
    valid = torch.from_numpy(r.uniform(size=(2, lk)) < 0.5)
    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", lq * lk)
    applied = []
    real = fl.FlashAttention.apply
    monkeypatch.setattr(fl.FlashAttention, "apply",
                        lambda *a: applied.append(a[0].dtype) or real(*a))
    tq, tk, tv = (a.clone().requires_grad_(True) for a in (q, k, v))
    out = psa.full_sparse_attention(tq, tk, tv, valid, valid, dtype)
    assert out.dtype == dtype and applied == [dtype]
    out.backward(do.to(dtype))
    o = fl.flash_attention_reference(*(a.to(dtype) for a in (q, k, v)), valid,
                                     D ** -0.5)
    assert torch.equal(out.detach(), o)
    want = fl.flash_attention_backward_reference(
        *(a.to(dtype) for a in (q, k, v)), valid, D ** -0.5, o, do.to(dtype))
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          want):
        assert g.dtype == torch.float32, name
        assert torch.equal(g, w.float()), name
