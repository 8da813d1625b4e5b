"""The plain versions of K1 (float and int8 QK) and of K3's int8 form
against the JAX package's Pallas kernels (interpret mode, on the CPU) at
the row and key counts where the card's attention core has tile edges: it
takes query rows in tiles of 64 or 128 and keys in tiles of 128, so 1, 63,
64, 65, 127, 128, 129 and 257 rows (K1's L, which is also its key count)
and keys (K3's context) fall just before, on and after an edge. The
card tests (tests/test_torch_port_cuda.py `test_core_self_edges`,
`test_core_cross_q8_edges`) hold the kernels to these plain versions at
the same counts, so this file chains the kernels to JAX there. Counts the
other port tests already hold are left out: K1 at 128 rows (float and int8
QK) and 64 (int8 QK), K3's int8 form at 20, 37 and 130 keys.

Each JAX call is jitted and blocked on (ROADMAP's note on interpret mode).
Inputs are numpy draws from a seed handed to both sides; compute in fp32.

Tolerances, each with its reason:
  * K1 float: atol = rtol = 2e-4, as tests/test_torch_port_dit_forms.py
    (the same function; the fp32 sums run in another order);
  * K1 int8 QK and K3 int8: atol = rtol = 5e-4, as
    tests/test_torch_port_selfq8.py and tests/test_torch_port_int8.py (a q
    or k value near a rounding half step can land one int8 step apart when
    the fp32 projection, summed in another order, differs in its last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import fused_sublayer as pt
from gvfdiffusion_tpu.ops import fused_sublayer as fs

C, H = 128, 4  # heads of 32, as the DiT ships
TOL = dict(rtol=2e-4, atol=2e-4)
TOL_Q8 = dict(rtol=5e-4, atol=5e-4)
K1_FLOAT_ROWS = [1, 63, 64, 65, 127, 129, 257]
K1_Q8_ROWS = [1, 63, 65, 127, 129, 257]
K3_KEYS = [1, 63, 64, 65, 127, 128, 129, 257]


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


def _self_args(seed, L, rows=2, B=4):
    r = np.random.default_rng(seed)
    gam = lambda: (np.abs(_arr(r, C, scale=0.3)) + 1.0).astype(np.float32)
    return [_arr(r, B, L, C), _arr(r, rows, C, scale=0.2),
            _arr(r, rows, C, scale=0.2), _arr(r, rows, C, scale=0.5),
            _arr(r, C, 3 * C, scale=0.05), _arr(r, 3 * C, scale=0.05),
            gam(), gam(), _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05)]


def _self_pair(args, quant_qk, rms):
    kw = dict(num_heads=H, rms=rms, mod_repeat=2, quant_qk=quant_qk)
    fn = jax.jit(lambda *a: fs.fused_self_sublayer(
        *a, compute_dtype=jnp.float32, interpret=True, **kw))
    want = jax.block_until_ready(fn(*map(jnp.asarray, args)))
    with torch.no_grad():
        got = pt.fused_self_sublayer(*map(torch.from_numpy, args),
                                     compute_dtype=torch.float32, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("L", K1_FLOAT_ROWS)
def test_k1_float_at_tile_edges(L):
    """K1 float, 4 frames of L rows sharing 2 modulation rows; the q/k RMS
    norms on (off at the odd counts, the DiT's other configuration)."""
    got, want = _self_pair(_self_args(L, L), False, rms=L % 2 == 0)
    assert got.shape == (4, L, C)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("L", K1_Q8_ROWS)
def test_k1_int8_qk_at_tile_edges(L):
    """K1 with int8 QK (one q and one k scale per frame and head), the q/k
    RMS norms on, and off at 129 rows."""
    got, want = _self_pair(_self_args(100 + L, L), True, rms=L != 129)
    assert got.shape == (4, L, C)
    np.testing.assert_allclose(got, want, **TOL_Q8)


def _context(r, B, lk, rms):
    """The port's cross parameters (with the q gamma under rms), the int8
    cache (k normed first under rms, as the DiT's cache), and JAX's."""
    p = [1.0 + _arr(r, C, scale=0.1), _arr(r, C, scale=0.1),
         _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05),
         _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05)]
    qg = (np.abs(_arr(r, C, scale=0.3)) + 1.0).astype(np.float32)
    k, v = _arr(r, B, lk, C, scale=0.5), _arr(r, B, lk, C, scale=0.5)
    if rms:
        kh = k.reshape(B, lk, H, -1)
        k = (kh / np.sqrt((kh * kh).sum(-1, keepdims=True) + 1e-12)
             * np.sqrt(C // H)).reshape(B, lk, C).astype(np.float32)
    kq, ks = pt.quantize_kv(torch.from_numpy(k), H)
    vq, vs = pt.quantize_kv(torch.from_numpy(v), H)
    cache = (kq, vq, ks.transpose(1, 2).contiguous(), vs)
    port_p = tuple(map(torch.from_numpy, p[:4] + ([qg] if rms else [])
                       + p[4:]))
    jax_p = tuple(map(jnp.asarray, p[:4] + [qg if rms else np.ones(C)]
                      + p[4:]))
    jax_kv = (jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
              jnp.asarray(cache[2].float().numpy()).astype(jnp.bfloat16),
              jnp.asarray(vs.float().numpy()).astype(jnp.bfloat16))
    return (port_p, cache), (jax_p, jax_kv)


@pytest.mark.parametrize("lk", K3_KEYS)
def test_k3_int8_at_key_tile_edges(lk):
    """K3's int8 form on one context of lk keys (the attention step the
    DiT runs once per context; tests/test_torch_port_int8.py holds the two
    chained), 2 batch rows of 64, q scales over all rows; the q RMS norm on
    at the odd counts (dit-rms-cross), off at the others (as shipped)."""
    rms = lk % 2 == 1
    r = np.random.default_rng(200 + lk)
    x = _arr(r, 2, 64, C)
    (tp, tkv), (jp, jkv) = _context(r, 2, lk, rms)
    port = [torch.from_numpy(x), tp, tkv]
    jax_args = [jnp.asarray(x), jp, jkv, None, None]
    kw = dict(num_heads=H, rms=rms)
    fn = jax.jit(lambda *a: fs.fused_cross_sublayer(
        *a, **kw, compute_dtype=jnp.float32, quant=True, interpret=True,
        lq_block=0))
    want = jax.block_until_ready(fn(*jax_args))
    with torch.no_grad():
        got = pt.fused_cross_sublayer(*port, **kw,
                                      compute_dtype=torch.float32,
                                      quant=True, q_block=0)
    assert got.shape == (2, 64, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_Q8)
