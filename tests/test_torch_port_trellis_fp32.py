"""Port parity: TRELLIS at fp32, as the registry builds it, against the JAX
package on the CPU.

  * K7's plain version in fp32 and at heads of 32 and 128 (both dtypes)
    against JAX's `_flash_full_attention` (the stock Pallas flash kernel)
    in interpret mode, on every query row: fp32 atol 2e-5, bf16 rel L2
    1e-2, as tests/test_torch_port_flash.py holds heads of 64;
  * K3's single-context plain version at compute_dtype=float32 against
    JAX `fused_cross_sublayer(compute_dtype=float32, interpret=True)`,
    atol 2e-5 (JAX's fixed exp2 shift against the port's row maximum),
    and at heads of 32 and 128 in both dtypes (bf16: rel L2 1e-2 of the
    update);
  * K5 as the card calls it for an fp32 model (bf16 compute from fp32
    q/k/v, whatever the model's dtype) against JAX `fused_attention` at
    fp32 inputs in interpret mode, rel L2 5e-3 (tests/
    test_torch_port_attention.py gives the reason);
  * `cfg_batched` against the two-call form and against JAX.
The configuration fields the registry passes are held in
tests/test_torch_port_trellis_fields.py, and the tiny pipeline built from a
pretrained directory in tests/test_torch_port_trellis_pretrained.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gvfdiffusion_torch.diffusion import flow_euler as pfe
from gvfdiffusion_torch.nn import attention as pna
from gvfdiffusion_torch.ops import flash_attention as fl
from gvfdiffusion_torch.ops import fused_sublayer as pfs
from gvfdiffusion_torch.sparse import attention as psa
from gvfdiffusion_tpu.diffusion import flow_euler as jfe
from gvfdiffusion_tpu.ops import fused_sublayer as jfs
from gvfdiffusion_tpu.ops.fused_attention import fused_attention as j_attention
from gvfdiffusion_tpu.sparse import attention as jsa

ATOL_F32 = 2e-5
REL_BF16 = 1e-2
REL_K5_BF16 = 5e-3
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


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# -- the kernels' plain versions ----------------------------------------------


@pytest.mark.parametrize("kind", ["prefix", "empty"])
@pytest.mark.parametrize("dtype,D", [("float32", 64), ("float32", 32),
                                     ("float32", 128), ("bfloat16", 32),
                                     ("bfloat16", 128)])
def test_flash_forms_match_jax_pallas(dtype, D, kind):
    """K7's plain version at the new forms, every query row (130 over 700
    keys, 2 batch rows, 2 heads); "empty": batch row 0 has no valid key."""
    r = np.random.default_rng(D)
    q, k, v = (r.standard_normal((2, n, 2, D)).astype(np.float32)
               for n in (130, 700, 700))
    valid = np.zeros((2, 700), bool)
    valid[1] = r.uniform(size=700) < 0.5
    if kind == "prefix":
        valid[0, :233] = True
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # jitted and waited on: an eager op dispatched while the interpret-mode
    # kernel's callbacks still run can deadlock JAX's CPU client
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(jax.jit(
            lambda a, b, c, kv: jsa._flash_full_attention(
                a, b, c, jnp.ones((2, 130), bool), kv).astype(jnp.float32))(
            *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
            jnp.asarray(valid)))
    want = np.asarray(want)
    got = fl.flash_attention(*(torch.from_numpy(a).to(tdt)
                               for a in (q, k, v)),
                             torch.from_numpy(valid), D ** -0.5)
    assert got.dtype == tdt and tuple(got.shape) == (2, 130, 2, D)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32, rtol=0)
    else:
        assert _rel(_np(got), want) <= REL_BF16


@pytest.mark.parametrize("lk", [37, 130])
def test_cross_single_fp32_matches_jax(lk):
    """K3's single context at compute_dtype=float32 (the SLat torso of
    TRELLIS as the registry builds it): 256 rows, 2 heads of 64."""
    r = np.random.default_rng(lk)
    C = 128
    f = lambda *s, sc=1.0, sh=0.0: (r.standard_normal(s) * sc + sh).astype(
        np.float32)
    x = f(2, 256, C)
    ns, nb, wq, bq = f(C, sc=0.1, sh=1.0), f(C, sc=0.1), f(C, C, sc=C ** -.5), \
        f(C, sc=0.1)
    wo, bo = f(C, C, sc=C ** -0.5), f(C, sc=0.1)
    k, v = f(2, lk, C), f(2, lk, C)
    want = jfs.fused_cross_sublayer(
        jnp.asarray(x), tuple(jnp.asarray(a) for a in (
            ns, nb, wq, bq, np.ones(C, np.float32), wo, bo)),
        (jnp.asarray(k), jnp.asarray(v)), num_heads=2,
        compute_dtype=jnp.float32, interpret=True)
    t = torch.from_numpy
    got = pfs.fused_cross_sublayer(
        t(x), tuple(map(t, (ns, nb, wq, bq, wo, bo))), (t(k), t(v)),
        num_heads=2, compute_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 128])
def test_cross_single_heads_match_jax(D, dtype):
    """K3's single context at heads of 32 and 128 (a 1024-wide torso at 32
    or 8 heads; here C = 128 at 4 heads or 1), 256 rows, 130 keys."""
    r = np.random.default_rng(D)
    C, lk, H = 128, 130, 128 // D
    f = lambda *s, sc=1.0, sh=0.0: (r.standard_normal(s) * sc + sh).astype(
        np.float32)
    x = f(2, 256, C)
    p = (f(C, sc=0.1, sh=1.0), f(C, sc=0.1), f(C, C, sc=C ** -.5),
         f(C, sc=0.1), f(C, C, sc=C ** -0.5), f(C, sc=0.1))
    k, v = f(2, lk, C), f(2, lk, C)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = lambda a: jnp.asarray(a, jdt)
    want = jfs.fused_cross_sublayer(
        j(x), tuple(map(j, (*p[:4], np.ones(C, np.float32), *p[4:]))),
        (j(k), j(v)), num_heads=H, compute_dtype=jdt, interpret=True)
    t = lambda a: torch.from_numpy(a).to(tdt)
    got = pfs.fused_cross_sublayer(
        t(x), tuple(map(t, p)), (t(k), t(v)), num_heads=H,
        compute_dtype=tdt)
    assert got.dtype == tdt
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32, rtol=0)
    else:
        xr = _np(t(x))
        err = _rel(_np(got) - xr, want - xr)
        assert err <= REL_BF16, err


class _OnCard:
    """Stands in for a CUDA tensor where only `is_cuda` is read."""
    is_cuda = True


def test_k5_route_of_an_fp32_model_matches_jax(monkeypatch):
    """On the card K5 computes in bf16 whatever the model's dtype, as JAX
    calls `fused_attention` (default compute bf16) on its chip; on the CPU
    in the model's dtype. The card's route, taken on the CPU: an fp32
    self-attention, cross-attention and the torso's kv_bias form against
    JAX at fp32 inputs."""
    assert pna.kernel_compute_dtype(_OnCard(), torch.float32) == \
        torch.bfloat16
    assert pna.kernel_compute_dtype(torch.zeros(1), torch.float32) == \
        torch.float32
    seen = []

    def card_route(q, dtype):
        seen.append(dtype)
        return torch.bfloat16
    monkeypatch.setattr(pna, "kernel_compute_dtype", card_route)
    monkeypatch.setattr(psa, "kernel_compute_dtype", card_route)
    r = np.random.default_rng(5)
    q = (r.standard_normal((2, 173, 2, 64)) * 2).astype(np.float32)
    k, v = ((r.standard_normal((2, 300, 2, 64)) * 2).astype(np.float32)
            for _ in range(2))
    valid = r.uniform(size=(2, 300)) < 0.6
    t = torch.from_numpy
    cases = [
        (pna.scaled_dot_product_attention(t(q), t(q), t(q), torch.float32),
         (q, q, q, None)),
        (pna.scaled_dot_product_attention(t(q), t(k), t(v), torch.float32,
                                          cross=True), (q, k, v, None)),
    ]
    bias = np.where(valid, 0.0, -np.inf).astype(np.float32)
    # the sparse torso's form: queries over the valid keys (>= 2^20 scores)
    qs = np.repeat(q, 21, axis=1)[:, :3500]
    got = psa.full_sparse_attention(
        t(qs), t(k), t(v), torch.ones(2, 3500, dtype=torch.bool),
        t(valid), torch.float32)
    cases.append((got, (qs, k, v, bias)))
    assert seen == [torch.float32] * 3
    for got, (a, b, c, kb) in cases:
        assert got.dtype == torch.float32
        want = j_attention(*(jnp.asarray(z) for z in (a, b, c)), 64 ** -0.5,
                           interpret=True,
                           kv_bias=None if kb is None else jnp.asarray(kb))
        err = _rel(_np(got), np.asarray(want))
        assert err <= REL_K5_BF16, err


# -- the sampler ------------------------------------------------------------------


def test_cfg_batched_matches_two_calls_and_jax():
    """One 2B-batched model call per CFG step: the same samples as the two
    calls, and as JAX's cfg_batched, with half the calls inside the
    guidance interval."""
    r = np.random.default_rng(22)
    noise = r.standard_normal((2, 6, 4)).astype(np.float32)
    cond = r.standard_normal((2, 6, 4)).astype(np.float32)
    calls = []

    def model(x, t, c):
        calls.append(x.shape[0])
        return 0.3 * x + c * (t[:, None, None] / 1000.0) + 0.1 * x * c

    kw = dict(steps=12, rescale_t=3.0, cfg_strength=7.5,
              cfg_interval=(0.5, 1.0))
    sampler = pfe.FlowEulerGuidanceIntervalSampler()
    t = torch.from_numpy
    two = sampler.sample(model, t(noise), t(cond), torch.zeros(2, 6, 4),
                         **kw)["samples"]
    n_two = len(calls)
    calls.clear()
    one = sampler.sample(model, t(noise), t(cond), torch.zeros(2, 6, 4),
                         cfg_batched=True, **kw)["samples"]
    assert n_two == 22 and len(calls) == 12 and max(calls) == 4
    assert _rel(one, two) <= 1e-6
    want = jfe.FlowEulerGuidanceIntervalSampler().sample(
        model, jnp.asarray(noise), jnp.asarray(cond), jnp.zeros((2, 6, 4)),
        cfg_batched=True, **kw)["samples"]
    assert _rel(one, want) <= CHAIN
