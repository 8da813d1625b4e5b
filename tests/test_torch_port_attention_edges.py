"""The plain versions of K5 and K3's single context against the JAX
package's Pallas kernels (interpret mode, on the CPU) at the key counts
where the card's attention core has tile edges: it takes keys in tiles of
128 (64 at heads of 128), so 1, 63, 64, 65, 127, 128, 129 and 257 keys
fall just before, on and after an edge, and 129 query rows spill one row
into a second 128-row tile. The card tests (tests/test_torch_port_cuda.py)
hold the kernel to these plain versions at the same edges, so this file
chains the kernel to JAX there. Counts the other port tests already hold
(130, 173, 200 and 1374 keys) are left out.

Each JAX call that reaches an interpret-mode kernel is jitted and blocked on
(ROADMAP's note on interpret mode). Inputs are numpy draws from a seed
handed to both sides.

Tolerances, each with its reason:
  * fp32 compute: atol = rtol = 2e-5, as tests/test_torch_port_attention.py
    (the same function; JAX takes exp2 of a fixed shift, the port at heads
    of 64 exp of the row maximum);
  * bf16 compute at heads of 32: rel L2 2e-4, as
    tests/test_torch_port_train.py (both take the fixed shift and round at
    the same points; the fp32 scores differ in their last bits);
  * K3's single context in bf16: rel L2 of the update y - x 1e-2, as
    tests/test_torch_port_trellis_fp32.py (bf16 rounding of the LN output,
    q, P and the attention output, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import fused_attention as pfa
from gvfdiffusion_torch.ops import fused_sublayer as pfs
from gvfdiffusion_tpu.ops import fused_sublayer as jfs
from gvfdiffusion_tpu.ops.fused_attention import fused_attention as j_attention

EDGES = [1, 63, 64, 65, 127, 128, 129, 257]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _draw(seed, *shapes, scale=1.0):
    r = np.random.default_rng(seed)
    return [(r.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _jax_attention(q, k, v, compute_dtype, kv_bias=None):
    fn = jax.jit(lambda q, k, v, b: j_attention(
        q, k, v, q.shape[-1] ** -0.5, compute_dtype=compute_dtype,
        interpret=True, kv_bias=b))
    out = jax.block_until_ready(fn(
        *(jnp.asarray(a) for a in (q, k, v)),
        None if kv_bias is None else jnp.asarray(kv_bias)))
    return np.asarray(out.astype(jnp.float32))


def _edge_bias(B, Lk, seed):
    """[B, Lk] fp32: row 0 masks every key (its output must be 0), the
    others keep a random half with a small finite bias (at least one key)."""
    r = np.random.default_rng(seed)
    bias = np.where(r.uniform(size=(B, Lk)) < 0.5, r.normal(0, 0.5, (B, Lk)),
                    -np.inf)
    bias[1:, 0] = 0.0
    bias[0] = -np.inf
    return bias.astype(np.float32)


@pytest.mark.parametrize("Lk", EDGES)
def test_k5_heads_of_64_at_key_tile_edges(Lk):
    """K5's running-maximum form (heads of 64) in fp32, 129 query rows."""
    q, k, v = _draw(Lk, (2, 129, 2, 64), (2, Lk, 2, 64), (2, Lk, 2, 64),
                    scale=2.0)
    want = _jax_attention(q, k, v, jnp.float32)
    got = pfa.attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                  64 ** -0.5, compute_dtype=torch.float32)
    assert got.shape == (2, 129, 2, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("Lk", [63, 128, 129])
def test_k5_kv_bias_at_key_tile_edges(Lk):
    """The key-bias form at heads of 64 (fp32): a fully masked batch row
    gives exactly 0 in both, never NaN."""
    q, k, v = _draw(Lk + 1, (3, 129, 2, 64), (3, Lk, 2, 64), (3, Lk, 2, 64),
                    scale=2.0)
    bias = _edge_bias(3, Lk, Lk)
    want = _jax_attention(q, k, v, jnp.float32, bias)
    got = pfa.fused_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              64 ** -0.5, torch.float32,
                              kv_bias=torch.from_numpy(bias)).numpy()
    assert np.isfinite(got).all() and not got[0].any() and not want[0].any()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("Lk", [1, 63, 65, 127, 129])
def test_k5_fixed_shift_heads_of_32_at_key_tile_edges(Lk):
    """K5 at heads of 32 (the TPU kernels' fixed exp2 shift), bf16 compute
    with fp32 in and out, as the DiT's training path calls it."""
    q, k, v = _draw(Lk + 2, (2, 129, 4, 32), (2, Lk, 4, 32), (2, Lk, 4, 32))
    want = _jax_attention(q, k, v, jnp.bfloat16)
    got = pfa.attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                  32 ** -0.5)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 2e-4, _rel(got.numpy(), want)


@pytest.mark.parametrize("D,lk", [(64, 1), (64, 64), (64, 65), (64, 128),
                                  (64, 129), (128, 63), (128, 64),
                                  (128, 65)])
def test_k3_single_context_at_key_tile_edges(D, lk):
    """K3's single context in bf16 (the SLat torso's image cross-attention)
    at C = 128, 129 rows: heads of 64 (128-key tiles on the card) and 128
    (64-key tiles)."""
    C, H = 128, 128 // D
    x, ns, nb, wq, bq, wo, bo, k, v = _draw(
        D + lk, (2, 129, C), (C,), (C,), (C, C), (C,), (C, C), (C,),
        (2, lk, C), (2, lk, C))
    ns, nb, bq, bo = 1.0 + 0.1 * ns, 0.1 * nb, 0.1 * bq, 0.1 * bo
    wq, wo = wq * C ** -0.5, wo * C ** -0.5
    p = (ns, nb, wq, bq, wo, bo)
    j = lambda a: jnp.asarray(a, jnp.bfloat16)
    fn = jax.jit(lambda x, p, kv: jfs.fused_cross_sublayer(
        x, p, kv, num_heads=H, compute_dtype=jnp.bfloat16, interpret=True))
    want = jax.block_until_ready(fn(
        j(x), tuple(map(j, (*p[:4], np.ones(C, np.float32), *p[4:]))),
        (j(k), j(v))))
    t = lambda a: torch.from_numpy(a).bfloat16()
    got = pfs.fused_cross_sublayer(t(x), tuple(map(t, p)), (t(k), t(v)),
                                   num_heads=H, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 129, C)
    xr = t(x).float().numpy()
    want = np.asarray(want, np.float32)
    err = _rel(got.float().numpy() - xr, want - xr)
    assert err <= 1e-2, err
