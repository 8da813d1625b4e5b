"""The plain version of K6 (`ops/fused_attention.py` `temporal_attention` on
the CPU) against the JAX package's Pallas kernel (`temporal_attention(...,
jnp.bfloat16, interpret=True)`) over the domain of its card kernel.

K6's card kernel (csrc/temporal_sm90.cuh's fixed-shift forms) cuts each
(batch row, voxel, head) problem into query blocks of 32 frames x key tiles
of 32 keys, with the fixed exp2 shift summed over the tiles. So T = 1 sits
inside one tile, T = 33 one past it, T = 64 on two, T = 70 across three and
T = 1024 over 32 x 32 items where JAX's voxel group falls to 1 (N = 1).
N = 8, 16 and 4 keep the groups of 8, 16 and 4. Every case is one that
`temporal_supports` admits, heads of 32 (4 heads) and 64 (2 heads), fp32
and bf16 io, q contiguous with k and v views of a [B, T, N, 3, H, D] qkv
(the composed block's layout; the card kernel reads each on its own row
stride). The card tests (tests/test_torch_port_cuda.py
`test_temporal_attention_core`, `..._long`, `..._underflow_row`) hold the
kernel to this plain version on the same domain, so this file chains it
to JAX there. tests/test_torch_port_train.py holds K6 at T = 23, 24 and 32
with its VJP.

Each JAX call is jitted and blocked on (ROADMAP's note on interpret mode).
Inputs are numpy draws from a seed handed to both sides.

Tolerances, each with its reason:
  * fp32 io: rel L2 <= 2e-4, tests/test_torch_port_train.py's K6 bound
    (the same rounding points; ulp-level differences in the fp32 scores
    and in exp2 flip a few of P's bf16 roundings);
  * bf16 io: rel L2 <= 1e-3 (readings 0-2.2e-4, the largest at T = 1024):
    the same, then the output rounded to bf16, where a difference in the
    last fp32 bit lands one bf16 step (2^-8 relative) apart on a few
    elements;
  * a row whose every logit lies far below the shift: P underflows to 0
    on both sides, and the row is 0/0 = NaN in the same places (JAX's
    kernel does not clamp the sum); the other rows as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import fused_attention as pfa
from gvfdiffusion_tpu.ops import fused_attention as jfa

C = 128
REL = {"float32": 2e-4, "bfloat16": 1e-3}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (B, T, N, heads, io): each T around the card's 32-frame tiles, each form
CASES = [
    (2, 1, 8, 4, "float32"),
    (2, 1, 8, 2, "bfloat16"),
    (2, 33, 8, 2, "float32"),
    (2, 33, 8, 4, "bfloat16"),
    (1, 64, 16, 4, "float32"),
    (1, 64, 16, 2, "bfloat16"),
    (2, 70, 4, 2, "float32"),
    (2, 70, 4, 4, "bfloat16"),
    (1, 1024, 1, 4, "float32"),
    (1, 1024, 1, 2, "bfloat16"),
]


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


def _inputs(seed, B, T, N, heads):
    """q [B, T, N, heads, D] and a qkv [B, T, N, 3, heads, D], fp32."""
    D = C // heads
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, T, N, heads, D)).astype(np.float32),
            r.standard_normal((B, T, N, 3, heads, D)).astype(np.float32))


def _both(q, qkv, io):
    """(the port's output, JAX's) as fp32 numpy: q apart, k and v views of
    qkv on the port's side, contiguous copies on JAX's."""
    tdt, jdt = DTYPES[io]
    D = q.shape[-1]
    tqkv = torch.from_numpy(qkv).to(tdt)
    tq = torch.from_numpy(q).to(tdt)
    tk, tv = tqkv[..., 1, :, :], tqkv[..., 2, :, :]
    assert tk.stride(2) == 3 * tq.stride(2)
    got = pfa.temporal_attention(tq, tk, tv, D ** -0.5)
    assert got.dtype == tdt and got.shape == tq.shape
    fn = jax.jit(lambda q, k, v: jfa.temporal_attention(
        q, k, v, D ** -0.5, jnp.bfloat16, True))
    want = fn(*(jnp.asarray(a, jdt) for a in (q, qkv[..., 1, :, :],
                                              qkv[..., 2, :, :])))
    want.block_until_ready()
    assert want.dtype == jdt
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("B,T,N,heads,io", CASES)
def test_k6_plain_matches_jax_kernel(B, T, N, heads, io):
    assert jfa.temporal_supports((B, T, N, heads, C // heads))
    q, qkv = _inputs(1000 * T + 10 * N + heads, B, T, N, heads)
    got, want = _both(q, qkv, io)
    err = _rel(got, want)
    print(f"K6 T={T} N={N} heads={heads} {io}: rel_l2 {err:.3e}")
    assert np.isfinite(got).all() and err <= REL[io], err


@pytest.mark.parametrize("io", ["float32", "bfloat16"])
def test_k6_underflow_row_is_nan_in_both(io):
    """Query row (1, 5, 3, head 1): its k rows all ones and its q -40, so
    every logit is -40 sqrt(D) log2 e (~-330) below the shift of 30 and
    every P underflows: 0/0 on both sides, the same NaN places."""
    B, T, N, heads = 2, 24, 8, 4
    q, qkv = _inputs(7, B, T, N, heads)
    qkv[1, :, 3, 1, 1] = 1.0
    q[1, 5, 3, 1] = -40.0
    assert jfa.temporal_supports(q.shape)
    got, want = _both(q, qkv, io)
    nan = np.isnan(got)
    assert (nan == np.isnan(want)).all()
    assert nan[1, 5, 3, 1].all() and nan.sum() == C // heads
    err = _rel(got[~nan], want[~nan])
    print(f"K6 underflow row {io}: rel_l2 of the rest {err:.3e}")
    assert err <= REL[io], err
