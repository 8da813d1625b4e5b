"""Port parity: the kernel forms added last to the port, each against the
JAX package's Pallas kernel in interpret mode on the same seeded inputs:
K5's `segment_size` (with and without `kv_bias`) and its int8 forms
`quant="qk"` and `quant="qk+av"` (with a -inf `kv_bias`, a batch row whose
keys are all masked, and segments), K1's `seg` (float and `quant_qk`),
and K3's single context with the q RMS norm (fp32 and bf16) and on an
int8 cache (with and without the norm, whole and `q_block` cells).

Tolerances, in fp32 unless named:
  * float forms 2e-5 relative (max |difference| over max |JAX|), as the
    JAX suite's own fp32 bounds: the two differ by the order of their fp32
    sums;
  * `quant="qk"` 1e-3 relative: q and k quantize by the same fp32 products
    in both, so an int8 value moves only where a product lands on a
    rounding midpoint after a summation-order difference upstream, and one
    such step moves a score by about 1/127 of the row's scale;
  * `quant="qk+av"` 2 vm / 127 absolute (vm the largest |v|): P's int8
    step at a midpoint of exp2 (two exp2 implementations) moves one key's
    weight by 1 of at least 127, and its output by at most vm / 127;
  * K1 `seg` with `quant_qk`, K3 int8: 5e-4 (the int8 forms' bound of
    tests/test_torch_port_selfq8.py);
  * bf16: rel L2 of the update y - x <= 1e-2 (both round at the same
    points; a one-ulp flip of y is large against the update).
The readings are printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import fused_attention as pfa
from gvfdiffusion_torch.ops import fused_sublayer as pt
from gvfdiffusion_tpu.ops import fused_attention as jfa
from gvfdiffusion_tpu.ops import fused_sublayer as fs

FLOAT_REL = 2e-5
QK_REL = 1e-3
Q8_TOL = dict(rtol=5e-4, atol=5e-4)
REL_BF16 = 1e-2
C, H = 128, 4  # heads of 32, as the DiT


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


def _maxrel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax(fn, *args):
    """A JAX call that reaches an interpret-mode kernel: jitted, blocked
    on (the CPU client can deadlock otherwise)."""
    return np.asarray(jax.block_until_ready(jax.jit(fn)(*args)),
                      np.float32)


# -- K5 -------------------------------------------------------------------------


def _k5_inputs(seed, B, L, Lk, heads, D, bias=None):
    r = np.random.default_rng(seed)
    q, k, v = (_arr(r, B, n, heads, D) for n in (L, Lk, Lk))
    kv_bias = None
    if bias == "ragged":  # the torso's padding keys, and one dead row
        kv_bias = np.zeros((B, Lk), np.float32)
        kv_bias[:, Lk - Lk // 5:] = -np.inf
        kv_bias[-1] = -np.inf
    elif bias == "soft":
        kv_bias = _arr(r, B, Lk)
    return q, k, v, kv_bias


def _k5(q, k, v, kv_bias, seg, quant):
    scale = q.shape[-1] ** -0.5
    want = _jax(lambda q, k, v, b: jfa.fused_attention(
        q, k, v, scale, jnp.float32, interpret=True, segment_size=seg,
        kv_bias=b, quant=quant), q, k, v, kv_bias)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = pfa.fused_attention(t(q), t(k), t(v), scale, torch.float32,
                              kv_bias=t(kv_bias), segment_size=seg,
                              quant=quant).numpy()
    return got, want


@pytest.mark.parametrize("D,seg,bias", [(32, 32, None), (32, 24, "soft"),
                                        (64, 64, None), (64, 32, "soft")])
def test_k5_segments_match_jax_kernel(D, seg, bias):
    """Block-diagonal attention over packed segments: 32 against the
    kernel's 128-key tiles, and 24, which no tile boundary lines up with."""
    q, k, v, kb = _k5_inputs(1, 2, 192, 192, 2, D, bias)
    got, want = _k5(q, k, v, kb, seg, "")
    err = _maxrel(got, want)
    print(f"K5 segment_size={seg} D={D} bias={bias}: max rel {err:.2e}")
    assert err <= FLOAT_REL, err
    # the mask acts: the segments' outputs differ from full attention's
    full, _ = _k5(q, k, v, kb, 0, "")
    assert _maxrel(full, want) > 1e-2


@pytest.mark.parametrize("D,L,Lk,seg,bias",
                         [(32, 256, 256, 0, None), (64, 200, 300, 0, None),
                          (32, 200, 300, 0, "ragged"),
                          (64, 256, 256, 32, "soft"),
                          (32, 512, 1374, 0, None)])
def test_k5_qk_matches_jax_kernel(D, L, Lk, seg, bias):
    """int8 QK: q's scale per block of lq_block rows (Lq = 512 against
    1374 keys: one block; 200: one block padded), k's per batch row and
    head; P rounded before its row sum."""
    q, k, v, kb = _k5_inputs(2, 2, L, Lk, 2, D, bias)
    got, want = _k5(q, k, v, kb, seg, "qk")
    err = _maxrel(got, want)
    print(f"K5 qk D={D} {L}x{Lk} seg={seg} bias={bias}: max rel {err:.2e}")
    assert err <= QK_REL, err
    if bias == "ragged":  # the dead row gives 0 in both
        assert not np.abs(want[-1]).any() and not np.abs(got[-1]).any()
    flt, _ = _k5(q, k, v, kb, seg, "")
    assert _maxrel(flt, want) > err  # the int8 scores moved the output


@pytest.mark.parametrize("D,L,Lk,seg,bias",
                         [(32, 256, 256, 0, None), (64, 200, 300, 0, None),
                          (32, 200, 300, 0, "ragged"),
                          (64, 256, 256, 32, None)])
def test_k5_qkav_matches_jax_kernel(D, L, Lk, seg, bias):
    """int8 P V: the row maximum first, P in 127 steps, V quantized per
    batch row and head; a row whose keys are all masked gives 0."""
    q, k, v, kb = _k5_inputs(3, 2, L, Lk, 2, D, bias)
    got, want = _k5(q, k, v, kb, seg, "qk+av")
    err = float(np.abs(got - want).max())
    tol = 2 * float(np.abs(v).max()) / 127
    print(f"K5 qk+av D={D} {L}x{Lk} seg={seg} bias={bias}: max abs "
          f"{err:.2e} (bound {tol:.2e})")
    assert err <= tol, err
    assert np.isfinite(got).all()
    if bias == "ragged":
        assert not np.abs(want[-1]).any() and not np.abs(got[-1]).any()


def test_k5_lq_block_matches_jax():
    for lq, lk in ((512, 512), (1374, 1374), (4096, 4096), (200, 300),
                   (100, 1374), (32768, 1374)):
        lk_pad = pfa._round_up(lk, 128)
        assert pfa.lq_block(lq, lk_pad) == jfa._lq_block(lq, lk_pad)


# -- K1 seg ---------------------------------------------------------------------


def _self_args(seed, B, L, rows):
    r = np.random.default_rng(seed)
    gam = lambda: (np.abs(_arr(r, C, scale=0.3)) + 1.0).astype(np.float32)
    return [_arr(r, B, L, C), _arr(r, rows, C, scale=0.2),
            _arr(r, rows, C, scale=0.2), _arr(r, rows, C, scale=0.5),
            _arr(r, C, 3 * C, scale=0.05), _arr(r, 3 * C, scale=0.05), gam(),
            gam(), _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05)]


@pytest.mark.parametrize("quant_qk", [False, True])
@pytest.mark.parametrize("seg,mod_repeat", [(16, 2), (4, 1)])
def test_self_seg_matches_jax_kernel(seg, mod_repeat, quant_qk):
    """K1 with `seg` interleaved streams (the rows of one stream r % seg
    attend one another), float and int8 QK; and the same function as K2
    on the [B, L / seg, seg, C] view, as the card runs it."""
    B, L = 4, 64
    args = _self_args(4, B, L, B // mod_repeat)
    kw = dict(num_heads=H, seg=seg, mod_repeat=mod_repeat, quant_qk=quant_qk)
    want = _jax(lambda *a: fs.fused_self_sublayer(
        *a, rms=True, compute_dtype=jnp.float32, interpret=True, **kw),
        *args)
    ta = [torch.from_numpy(a) for a in args]
    got = pt.fused_self_sublayer(*ta, compute_dtype=torch.float32,
                                 **kw).numpy()
    err = _maxrel(got, want)
    print(f"K1 seg={seg} quant_qk={quant_qk}: max rel {err:.2e}")
    if quant_qk:
        np.testing.assert_allclose(got, want, **Q8_TOL)
    else:
        assert err <= FLOAT_REL, err
    rep = lambda a: a.repeat_interleave(mod_repeat, 0)
    temporal = pt.fused_temporal_sublayer(
        ta[0].reshape(B, L // seg, seg, C), *map(rep, ta[1:4]), *ta[4:],
        num_heads=H, compute_dtype=torch.float32, quant_qk=quant_qk,
        voxel_group=seg).reshape(B, L, C).numpy()
    assert _maxrel(temporal, got) <= 1e-6
    plain = pt.fused_self_sublayer(*ta, compute_dtype=torch.float32,
                                   num_heads=H, mod_repeat=mod_repeat,
                                   quant_qk=quant_qk).numpy()
    assert _maxrel(plain, want) > 1e-3  # without seg: another function


# -- K3, one context --------------------------------------------------------------


def _cross_args(seed, B, L, lk, rms_gamma=True):
    r = np.random.default_rng(seed)
    gam = (np.abs(_arr(r, C, scale=0.3)) + 1.0).astype(np.float32)
    p = (1.0 + _arr(r, C, scale=0.1), _arr(r, C, scale=0.1),
         _arr(r, C, C, scale=0.09), _arr(r, C, scale=0.1), gam,
         _arr(r, C, C, scale=0.09), _arr(r, C, scale=0.1))
    return _arr(r, B, L, C), p, (_arr(r, B, lk, C), _arr(r, B, lk, C))


def _jax_cross1(x, p, kv, dt, **kw):
    return _jax(lambda x, p, kv: fs.fused_cross_sublayer(
        x, p, kv, num_heads=H, compute_dtype=dt, interpret=True, **kw),
        x, p, kv)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cross_single_rms_matches_jax_kernel(dt):
    """One context with q RMS-normed by the lane gamma before the
    attention, in fp32 and in bf16."""
    x, p, kv = _cross_args(5, 2, 64, 37)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    want = _jax_cross1(*(jax.tree.map(lambda a: jnp.asarray(a).astype(jdt),
                                      (x, p, kv))), jdt, rms=True)
    t = lambda a: torch.from_numpy(a).to(tdt)
    got = pt.fused_cross_sublayer(t(x), tuple(map(t, p)), tuple(map(t, kv)),
                                  num_heads=H, rms=True,
                                  compute_dtype=tdt).float().numpy()
    if dt == "float32":
        err = _maxrel(got, want)
        print(f"K3 single rms fp32: max rel {err:.2e}")
        assert err <= FLOAT_REL, err
    else:
        err = _rel(got - x, want - x)
        print(f"K3 single rms bf16: update rel L2 {err:.2e}")
        assert err <= REL_BF16, err
    no_rms = pt.fused_cross_sublayer(
        torch.from_numpy(x), tuple(map(torch.from_numpy, p[:4] + p[5:])),
        tuple(map(torch.from_numpy, kv)), num_heads=H,
        compute_dtype=torch.float32).numpy()
    assert _rel(no_rms - x, want - x) > 1e-2  # the norm acts


@pytest.mark.parametrize("rms,q_block", [(False, 0), (True, 0), (True, 32)])
def test_cross_single_int8_matches_jax_kernel(rms, q_block):
    """One context on an int8 cache from quantize_kv, q quantized per cell
    of all L rows or of q_block (JAX's lq_block) rows."""
    x, p, (k, v) = _cross_args(6, 2, 64, 130)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    kq, ks = pt.quantize_kv(tk, H)
    vq, vs = pt.quantize_kv(tv, H)
    cache = (kq, vq, ks.transpose(1, 2).contiguous(), vs)
    jcache = tuple(jnp.asarray(a.float().numpy()).astype(
        jnp.int8 if a.dtype == torch.int8 else jnp.bfloat16) for a in cache)
    want = _jax(lambda x, p, kv: fs.fused_cross_sublayer(
        x, p, kv, num_heads=H, rms=rms, compute_dtype=jnp.float32,
        quant=True, interpret=True, lq_block=q_block), x, p, jcache)
    tp = tuple(map(torch.from_numpy, p if rms else p[:4] + p[5:]))
    got = pt.fused_cross_sublayer(torch.from_numpy(x), tp, cache,
                                  num_heads=H, rms=rms,
                                  compute_dtype=torch.float32, quant=True,
                                  q_block=q_block).numpy()
    print(f"K3 single int8 rms={rms} q_block={q_block}: max rel "
          f"{_maxrel(got, want):.2e}")
    np.testing.assert_allclose(got, want, **Q8_TOL)
