"""The plain versions of K2 (the temporal sublayer, float and int8 QK) and
of K4 (the MLP sublayer) against the JAX package's Pallas kernels
(interpret mode, on the CPU) over the domain of their card kernels.

K2's card attention (csrc/temporal_sm90.cuh) cuts each (batch row, voxel,
head) problem into query blocks of 32 frames x key tiles of 32 keys, so T
of 24, 32 and 64 fall inside one tile, on it and across two; N of 16 keeps
JAX's voxel group of 16, N = 3 drops it to 1 (at T = 128, four tiles), N
= 24 halves it to 8 for the int8-QK scales. K4's card GEMM takes 128-row
tiles, so its rows here are not a multiple of 128. The card tests
(tests/test_torch_port_cuda.py `test_temporal_core`,
`test_temporal_core_q8`, `test_mlp_kernel_widths`) hold the kernels to
these plain versions on the same domain, so this file chains them to JAX
there. Other port tests hold K2 at T = 4 and 8 over 32 voxels and K4 at
M = 256.

Each JAX call is jitted and blocked on (ROADMAP's note on interpret mode).
Inputs are numpy draws from a seed handed to both sides.

Tolerances, each with its reason:
  * fp32: atol = rtol = 2e-4, tests/test_torch_port_sublayers.py's (the
    same function; the fp32 sums run in another order);
  * int8 QK in fp32: atol = rtol = 5e-4, tests/test_torch_port_selfq8.py's
    (a q or k value near a rounding half step can land one int8 step apart
    when the fp32 projection, summed in another order, differs in its last
    bit);
  * bf16 (the main path's compute dtype): rel L2 of y <= 2e-3 (readings
    4.9e-4-6.1e-4) and of the update y - x <= 3e-2, the card's bound for
    K2 (tests/test_torch_port_cuda.py BOUNDS; readings 1.0e-2-1.3e-2). The
    plain version rounds the softmax's P after the row maximum is taken
    out, the TPU kernel rounds exp2(s - 30) with its fixed shift, so the
    two round P at different scales; y is then rounded to bf16 at the ulp
    of |x| (2^-6 at |y| ~ 2-4, the largest difference read), which is
    about 1e-2 of the update's size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import fused_sublayer as pt
from gvfdiffusion_tpu.ops import fused_sublayer as fs

C = 128
TOL = dict(rtol=2e-4, atol=2e-4)
TOL_Q8 = dict(rtol=5e-4, atol=5e-4)
REL_BF16 = (2e-3, 3e-2)  # (y, the update y - x)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _temporal_args(seed, B, T, N):
    r = np.random.default_rng(seed)
    gam = lambda: (np.abs(_arr(r, C, scale=0.3)) + 1.0).astype(np.float32)
    return [_arr(r, B, T, N, C), _arr(r, B, C, scale=0.2),
            _arr(r, B, C, scale=0.2), _arr(r, B, C, scale=0.5),
            _arr(r, C, 3 * C, scale=0.05), _arr(r, 3 * C, scale=0.05),
            gam(), gam(), _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05)]


def _temporal_pair(args, dtype, **kw):
    """(plain version, JAX kernel) outputs as fp32 numpy arrays."""
    tdt, jdt = DTYPES[dtype]
    fn = jax.jit(lambda *a: fs.fused_temporal_sublayer(
        *a, compute_dtype=jdt, interpret=True, **kw))
    want = jax.block_until_ready(fn(*(jnp.asarray(a).astype(jdt)
                                      for a in args)))
    with torch.no_grad():
        got = pt.fused_temporal_sublayer(
            *(torch.from_numpy(a).to(tdt) for a in args), compute_dtype=tdt,
            **kw)
    assert got.dtype == tdt
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms", [True, False])
@pytest.mark.parametrize("T", [24, 32, 64])
def test_temporal_plain_vs_jax(T, rms, dtype):
    """One batch row, 16 voxels (one JAX cell), 4 heads of 32."""
    args = _temporal_args(T + 2 * rms, 1, T, 16)
    got, want = _temporal_pair(args, dtype, num_heads=4, rms=rms)
    assert got.shape == (1, T, 16, C)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        err, upd = _rel(got, want), _rel(got - args[0], want - args[0])
        assert err <= REL_BF16[0] and upd <= REL_BF16[1], (err, upd)


@pytest.mark.parametrize("heads", [4, 2])
def test_temporal_plain_vs_jax_voxel_group_of_one(heads):
    """N = 3 voxels: the JAX cell is one voxel, over T = 128 frames (four
    of the card kernel's key tiles); heads of 32 and 64, fp32."""
    assert pt.temporal_voxel_group(3) == 1
    args = _temporal_args(50 + heads, 2, 128, 3)
    got, want = _temporal_pair(args, "float32", num_heads=heads, rms=True)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("T,N", [(64, 16), (32, 24)])
def test_temporal_int8_qk_plain_vs_jax(T, N):
    """The int8-QK plain version (scales per batch row x voxel group x
    head over all T frames) at T = 64 with a group of 16 and at N = 24,
    where the group halves to 8; fp32."""
    nc = pt.temporal_voxel_group(N)
    assert nc == {16: 16, 24: 8}[N]
    args = _temporal_args(60 + N, 1, T, N)
    got, want = _temporal_pair(args, "float32", num_heads=4, rms=True,
                               quant_qk=True)
    np.testing.assert_allclose(got, want, **TOL_Q8)


def test_mlp_plain_vs_jax_m1024():
    """K4 at dit-notemporal's M = 1024, 2 x 100 rows (not a multiple of the
    card GEMM's 128-row tile) under 2 x mod_repeat modulation rows, fp32."""
    r = np.random.default_rng(70)
    args = [_arr(r, 2, 100, C), _arr(r, 1, C, scale=0.2),
            _arr(r, 1, C, scale=0.2), _arr(r, 1, C, scale=0.5),
            _arr(r, C, 1024, scale=0.05), _arr(r, 1024, scale=0.05),
            _arr(r, 1024, C, scale=0.05), _arr(r, C, scale=0.05)]
    fn = jax.jit(lambda *a: fs.fused_mlp_sublayer(
        *a, compute_dtype=jnp.float32, mod_repeat=2, interpret=True))
    want = jax.block_until_ready(fn(*map(jnp.asarray, args)))
    with torch.no_grad():
        got = pt.fused_mlp_sublayer(*map(torch.from_numpy, args),
                                    compute_dtype=torch.float32,
                                    mod_repeat=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_temporal_attention_step_alone_matches_the_sublayer():
    """`temporal_sublayer_attention` (the card kernel's own entry; its
    plain version on the CPU), float and int8 QK, fed the sublayer's own
    projection, is the attention inside the plain sublayers: through the
    same out projection it gives temporal_sublayer_reference's y and
    temporal_sublayer_qk8_reference's (bf16 compute on fp32 x, T = 40 over
    24 voxels: groups of 8 for the int8 scales)."""
    B, T, N, H = 2, 40, 24, 4
    D, bf = C // H, torch.bfloat16
    args = list(map(torch.from_numpy, _temporal_args(80, B, T, N)))
    x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo = args
    nc = pt.temporal_voxel_group(N)
    h = pt._layernorm_f32(x) * (1.0 + sc[:, None, None]) + sh[:, None, None]
    q, k, v = pt._qkv(pt._rd(h, bf) @ pt._rd(wqkv, bf) + bqkv, qg, kg, H,
                      True)
    # q8_kernel's quantization: one scale per (batch row, group, head)
    cells = lambda a: a.reshape(B, T, N // nc, nc, H, D)
    qs, ks = (cells(a).abs().amax((1, 3, 5)).clamp_min(1e-8)
              for a in (q, k))  # [B, N // nc, H]
    qi, ki = (torch.round(cells(a) * (127.0 / s)[:, None, :, None, :, None])
              .reshape(B, T, N, C).to(torch.int8)
              for a, s in ((q, qs), (k, ks)))
    pt.reset_launch_counts()
    with torch.no_grad():
        attn = pt.temporal_sublayer_attention(torch.cat((q, k, v), -1).to(bf),
                                              H)
        attn8 = pt.temporal_sublayer_attention(
            torch.cat((q, k, v), -1), H,
            quant=(qi, ki, qs.reshape(-1, H), ks.reshape(-1, H)))
        refs = [fn(*args, num_heads=H, compute_dtype=bf) for fn in (
            pt.temporal_sublayer_reference,
            pt.temporal_sublayer_qk8_reference)]
    assert pt.launch_counts["temporal_core"] == 0  # the CPU never counts
    for a, ref in zip((attn, attn8), refs):
        assert a.shape == (B, T, N, C) and a.dtype == bf
        y = x + (a.float() @ pt._rd(wo, bf) + bo) * gate[:, None, None]
        np.testing.assert_allclose(y.numpy(), ref.numpy(), **TOL)
