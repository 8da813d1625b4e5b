"""K3 (`fused_cross_sublayer`, gvfdiffusion_torch/ops/fused_sublayer.py)
at the head widths its rule admits beyond the card's 32, 64 and 128,
against JAX's Pallas kernel in interpret mode on the CPU (each JAX call
jitted and blocked on), on the same seeded numpy inputs in fp32 at C = 128
and D = 4, 8, 16 and 128: the DiT's two contexts (without and with the q
RMS norm), its int8 cache (with the norm), and one context (without and
with the norm, and on an int8 cache). The card checks, the padding
identity and K1 / K2: tests/test_torch_port_sublayer_widths.py.

Tolerances, those the existing parity tests state for the same forms: the
float forms 2e-4 abs / rel (tests/test_torch_port_sublayers.py); the int8
cache 5e-4 abs / rel, K3 int8's bound in tests/test_torch_port_forms.py
(q quantizes by the same fp32 products on both sides, so an int8 value
moves only where a product lands on a rounding midpoint after a
summation-order difference upstream: readings up to 3.8e-4 at heads of 4
and 16, 1e-6 at 8 and 128). About 55 s alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import fused_sublayer as pt
from gvfdiffusion_tpu.ops import fused_sublayer as fs

FLOAT_TOL = dict(rtol=2e-4, atol=2e-4)
Q8_TOL = dict(rtol=5e-4, atol=5e-4)
C = 128
WIDTHS = (4, 8, 16, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker while this module runs (the
    suite runs several workers at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _jax(fn, *args):
    """A JAX call that reaches an interpret-mode kernel: jitted, blocked
    on (the CPU client can deadlock otherwise)."""
    return np.asarray(jax.block_until_ready(jax.jit(fn)(*args)), np.float32)


def _inputs(seed, B, L, lks):
    """x, then per context (ns, nb, wq, bq, qg, wo, bo) and (k, v); JAX
    takes the q gamma in every form and reads it with rms=True only."""
    r = np.random.default_rng(seed)
    out = [_arr(r, B, L, C)]
    for lk in lks:
        gam = (np.abs(_arr(r, C, scale=0.3)) + 1.0).astype(np.float32)
        out += [(1.0 + _arr(r, C, scale=0.1), _arr(r, C, scale=0.1),
                 _arr(r, C, C, scale=0.09), _arr(r, C, scale=0.1), gam,
                 _arr(r, C, C, scale=0.09), _arr(r, C, scale=0.1)),
                (_arr(r, B, lk, C), _arr(r, B, lk, C))]
    return out


def _int8_cache(kv, H):
    """The port's quantize_kv cache (k, v int8, k scales [B, H, Lk], v
    scales [B, Lk, H]) and the same values as JAX arrays."""
    kq, ks = pt.quantize_kv(torch.from_numpy(kv[0]), H)
    vq, vs = pt.quantize_kv(torch.from_numpy(kv[1]), H)
    cache = (kq, vq, ks.transpose(1, 2).contiguous(), vs)
    jcache = tuple(jnp.asarray(a.float().numpy()).astype(
        jnp.int8 if a.dtype == torch.int8 else jnp.bfloat16) for a in cache)
    return cache, jcache


@pytest.mark.parametrize("form", ["cross", "cross_rms", "cross_q8", "single",
                                  "single_rms", "single_q8"])
@pytest.mark.parametrize("D", WIDTHS)
def test_k3_forms_match_jax_kernel(D, form):
    H = C // D
    single = form.startswith("single")
    quant = form.endswith("q8")
    rms = form.endswith("rms") or quant
    x, *groups = _inputs(30 + D, 2, 64, (37,) if single else (37, 20))
    ps, kvs = groups[0::2], groups[1::2]
    jkvs, tkvs = kvs, [tuple(map(torch.from_numpy, kv)) for kv in kvs]
    if quant:
        caches = [_int8_cache(kv, H) for kv in kvs]
        tkvs, jkvs = [c[0] for c in caches], [c[1] for c in caches]
    kw = dict(num_heads=H, rms=rms, quant=quant)
    jargs = [a for pr in zip(ps, jkvs) for a in pr]
    want = _jax(lambda x, *a: fs.fused_cross_sublayer(
        x, *a, compute_dtype=jnp.float32, interpret=True, **kw), x, *jargs)
    targs = [a for p, kv in zip(ps, tkvs)
             for a in (tuple(map(torch.from_numpy, p)), kv)]
    got = pt.fused_cross_sublayer(torch.from_numpy(x), *targs,
                                  compute_dtype=torch.float32, **kw).numpy()
    print(f"K3 {form} heads of {D}: max abs {np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, **(Q8_TOL if quant else FLOAT_TOL))
