"""Port parity: K7's plain version (gvfdiffusion_torch/ops/flash_attention.py)
against the JAX package's `_flash_full_attention` (the stock Pallas TPU
flash kernel, in interpret mode on the CPU) at the key layouts that the
card kernel's list of visited key tiles must handle, one to a row of one
batch: no valid key, valid keys in two runs more than two 128-key tiles
apart, and keys valid only in the last, partial tile; key counts of 300
and 1100 (multiples of neither 64 nor 128); bf16 and fp32; heads of 32,
64 and 128. Every query row is compared.

Also the 3xTF32 split that the fp32 card kernels take (tests/_tf32.py, a
plain emulation: hi = tf32(x), lo = tf32(x - hi), three tf32 products
with fp32 sums) against the plain fp32 versions, at reduced row counts, to
the bounds chip_smoke.py holds the card's fp32 kernels to; one tf32
product alone does not hold them.

Tolerances: fp32 atol 2e-5 and bf16 rel L2 1e-2, as
tests/test_torch_port_flash.py; the split: CROSS_F32_BOUNDS (4e-7, 3e-6)
for K3's single context (y, the update y - x) and FLASH_F32_BOUND 5e-6 for
K7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _tf32 import (attention_3xtf32, cross_case, cross_single_3xtf32,
                   flash_case, rel_l2, tf32_round)
from gvfdiffusion_torch.ops import flash_attention as fl
from gvfdiffusion_torch.ops import fused_sublayer as fsl
from gvfdiffusion_tpu.sparse import attention as jsa

ATOL_F32 = 2e-5
REL_BF16 = 1e-2
CROSS_F32_BOUNDS = (4e-7, 3e-6)
FLASH_F32_BOUND = 5e-6
LQ, H = 40, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker while this module runs (the
    suite runs several workers at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row(kind, lk, r):
    v = np.zeros(lk, bool)
    if kind == "runs":  # two runs more than 256 keys apart
        v[3:20] = r.uniform(size=17) < 0.7
        v[3] = v[lk - 12:lk - 2] = True
    elif kind == "last":  # only in the last tile, partial at 64 and 128
        v[lk - lk % 64 + 1:] = True
    return v  # "empty": none


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


ROWS = ("empty", "runs", "last")


@pytest.mark.parametrize("lk", [300, 1100])
@pytest.mark.parametrize("dtype,D", [("float32", 32), ("float32", 64),
                                     ("float32", 128), ("bfloat16", 32),
                                     ("bfloat16", 64), ("bfloat16", 128)])
def test_flash_tile_layouts_match_jax_pallas(dtype, D, lk):
    """One batch whose rows each take a layout of ROWS."""
    r = np.random.default_rng(lk + D)
    q, k, v = (r.standard_normal((len(ROWS), n, H, D)).astype(np.float32)
               for n in (LQ, lk, lk))
    valid = np.stack([_row(kind, lk, r) for kind in ROWS])
    want = _jax_flash(q, k, v, valid, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    got = fl.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                             torch.from_numpy(valid), D ** -0.5)
    assert got.dtype == tdt and tuple(got.shape) == (len(ROWS), LQ, H, D)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= REL_BF16, err
    for b, kind in enumerate(ROWS):
        if kind == "empty":  # sum(V) / lk_pad on every query row
            mean = v[b].astype(np.float64).sum(0) / fl.padded_keys(lk)
            np.testing.assert_allclose(
                got[b], np.broadcast_to(mean, got[b].shape),
                atol=ATOL_F32 if dtype == "float32" else 2e-2)


def test_key_tiles_are_the_kernels():
    """The unit of the visited-tile list: the bf16 core's 128-key tiles (64
    at heads of 128), the 3xTF32 path's 64 (32 at 128)."""
    assert [fl.key_tile(torch.bfloat16, d) for d in (32, 64, 128)] == \
        [128, 128, 64]
    assert [fl.key_tile(torch.float32, d) for d in (32, 64, 128)] == \
        [64, 64, 32]


def test_tf32_round_is_round_to_nearest_away():
    """tf32_round keeps 10 mantissa bits, a tie rounding away from zero
    (cvt.rna), and the split's hi + lo holds 21 bits or more of x."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -20,
                      -7.25, 1.0])
    assert tf32_round(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, -7.25, 1.0]
    y = torch.randn(4096, generator=torch.Generator().manual_seed(3))
    hi = tf32_round(y)
    lo = tf32_round(y - hi)
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2.0 ** -21


@pytest.mark.parametrize("heads", [32, 16, 8])
def test_3xtf32_split_holds_the_fp32_bounds(heads):
    """K3's single context at compute_dtype=float32 with its q, attention
    and out products by the split, 256 of the torso's 32768 rows, against
    the port's plain fp32 version; one tf32 product alone breaks them."""
    torch.set_num_threads(2)
    x, p, kv = cross_case(256, heads)
    want = fsl.fused_cross_sublayer(x, p, kv, num_heads=heads,
                                    compute_dtype=torch.float32)
    got = cross_single_3xtf32(x, p, kv, heads)
    y_err, upd_err = rel_l2(got, want), rel_l2(got - x, want - x)
    assert y_err <= CROSS_F32_BOUNDS[0], y_err
    assert upd_err <= CROSS_F32_BOUNDS[1], upd_err
    ns, nb, wq, bq, wo, bo = p
    one = (ns, nb, tf32_round(wq), bq, tf32_round(wo), bo)
    once = fsl.fused_cross_sublayer(x, one, kv, num_heads=heads,
                                    compute_dtype=torch.float32)
    assert rel_l2(once - x, want - x) > CROSS_F32_BOUNDS[1]


@pytest.mark.parametrize("heads,width", [(32, 32), (16, 64), (8, 128)])
def test_3xtf32_split_holds_the_flash_bound(heads, width):
    """K7 in fp32 by the split (S and P V), 256 query rows over 3700 valid
    keys (the defaults' torso, whose invalid keys add nothing), against the
    plain fp32 version; the logsumexp against fp64."""
    torch.set_num_threads(2)
    q, k, v = flash_case(256, 3700, heads, width)
    valid = torch.ones(1, 3700, dtype=torch.bool)
    want = fl.flash_attention(q, k, v, valid, width ** -0.5)
    got, lse = attention_3xtf32(q, k, v, width ** -0.5, lse=True)
    assert rel_l2(got, want) <= FLASH_F32_BOUND, rel_l2(got, want)
    s64 = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double())
    assert torch.allclose(lse.double(),
                          torch.logsumexp(s64 * width ** -0.5, -1),
                          rtol=0, atol=2e-5)
