"""Port parity: K7's gradient. The port's plain backward
(`flash_attention_backward_reference`, and `FlashAttention` under
autograd, which runs it on the CPU) against `jax.vjp` of the JAX
package's `_flash_full_attention`, whose backward is the stock Pallas TPU
kernels' dkv and dq, run in interpret mode on the CPU; and the dispatch:
`full_sparse_attention` under grad takes the flash branch on both sides.

Inputs and the output gradient from a numpy seed, handed to both
packages; fp32. Every query row is compared, the invalid ones too (every
query is in the valid keys' segment), and a batch row with no valid key
(P = 1 / Lk-padded-to-512 on every key, so its keys get dV != 0).
Tolerance: atol 2e-5 on dq, dk and dv, the forward's
(tests/test_torch_port_flash.py), for prefix, scattered and empty
validity, and Lq != Lk with Lk off the 512-key padding.
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
B, H, D = 2, 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker while this module runs (the
    suite runs several workers at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _validity(kind, lk, seed):
    """[B, lk] key validity: a prefix (the VAE's voxels come first in
    their slots), scattered, or a batch row with none."""
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
    q, k, v = (r.standard_normal((B, n, H, D)).astype(np.float32)
               for n in (lq, lk, lk))
    return q, k, v, r.standard_normal((B, lq, H, D)).astype(np.float32)


def _jax_grads(q, k, v, do, valid):
    """(out, dq, dk, dv) of JAX's flash attention, kernels in interpret
    mode."""
    qv, kv = jnp.ones(q.shape[:2], bool), jnp.asarray(valid)

    def fwd_bwd(a, b, c, g):
        out, vjp = jax.vjp(
            lambda a_, b_, c_: jsa._flash_full_attention(a_, b_, c_, qv, kv),
            a, b, c)
        return (out, *vjp(g))

    # jitted: an eager op dispatched while the interpret-mode kernels'
    # callbacks still run can deadlock JAX's CPU client
    with pltpu.force_tpu_interpret_mode():
        res = jax.block_until_ready(jax.jit(fwd_bwd)(
            *(jnp.asarray(a) for a in (q, k, v, do))))
    return [np.asarray(a) for a in res]


@pytest.mark.parametrize("kind", ["prefix", "scattered", "empty"])
@pytest.mark.parametrize("lq,lk", [(600, 700), (130, 70)])
def test_flash_backward_matches_jax_pallas(lq, lk, kind):
    q, k, v, do = _inputs(lq, lk, seed=lq + lk)
    valid = _validity(kind, lk, seed=lk)
    want = _jax_grads(q, k, v, do, valid)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    out = fl.flash_attention(tq, tk, tv, tvalid, D ** -0.5)
    out.backward(torch.from_numpy(do))
    got = [out.detach(), tq.grad, tk.grad, tv.grad]
    ref = fl.flash_attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), tvalid, D ** -0.5,
        out.detach(), torch.from_numpy(do))
    for name, g, r in zip(("dq", "dk", "dv"), got[1:], ref):
        assert torch.equal(g, r), name  # the Function runs the plain version
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0,
                                   err_msg=name)
    if kind == "empty":
        # every key of the row without valid keys: dV = sum(dO) / lk_pad
        want_dv = do[0].astype(np.float64).sum(0) / fl.padded_keys(lk)
        np.testing.assert_allclose(
            got[3][0].numpy(), np.broadcast_to(want_dv, (lk, H, D)),
            atol=ATOL)
        assert float(got[3][0].abs().max()) > 0


def test_full_sparse_attention_under_grad_takes_the_flash_branch(
        monkeypatch):
    """With both packages' thresholds lowered to the shape (JAX's through
    `_FORCE_FLASH`), `full_sparse_attention` under grad goes through K7's
    Function on the port's side and the stock kernel's VJP on JAX's, and
    the gradients agree on every row."""
    lq = lk = 300
    q, k, v, do = _inputs(lq, lk, seed=9)
    valid = _validity("scattered", lk, seed=10)
    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", lq * lk)
    monkeypatch.setattr(jsa, "_FORCE_FLASH", True)
    applied = []
    real = fl.FlashAttention.apply
    monkeypatch.setattr(fl.FlashAttention, "apply",
                        lambda *a: applied.append(1) or real(*a))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    out = psa.full_sparse_attention(tq, tk, tv, tvalid, tvalid, torch.float32)
    out.backward(torch.from_numpy(do))
    assert applied == [1]

    kv = jnp.asarray(valid)

    def fwd_bwd(a, b, c, g):
        out, vjp = jax.vjp(
            lambda a_, b_, c_: jsa.full_sparse_attention(a_, b_, c_, kv, kv),
            a, b, c)
        return (out, *vjp(g))

    with pltpu.force_tpu_interpret_mode():
        want_out, *want = jax.block_until_ready(jax.jit(fwd_bwd)(
            *(jnp.asarray(a) for a in (q, k, v, do))))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATOL, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)
