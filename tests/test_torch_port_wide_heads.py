"""K7 above 128 lanes, on the CPU: the port's plain forward and backward at
head widths the card runs on `csrc/flash_attention_wide.cu`, against the
JAX package's stock flash attention, the padding that carries a head to
the wide kernels' width, the dispatch under grad and K7's width rule.

JAX sends any head width that is a multiple of 8 to the stock Pallas flash
kernel (`gvfdiffusion_tpu/sparse/attention.py:114`), which has no cap on
D: the static VAE's 768 channels in 4, 3, 2 or 1 heads train at D = 192,
256, 384 and 768, and 1152 channels in one head at 1152. The port's wide
kernels have no cap either: they split a head over a cluster of at most
16 CTAs of 192, 128 or 64 lanes (`_widths.wide_split`), in passes of such
clusters above 3072 lanes, and the wrapper zero-pads a head of another
multiple of 8 above 128 to the next width they split
(`_widths.flash_card_width`: 136 runs at 192, 1088 at 1152, 3136 at 3328).
This file holds:
  (a) the plain forward and `FlashAttention`'s plain backward against
      `jax.vjp` of `_flash_full_attention` (its kernels in interpret mode,
      jitted and blocked on) at D = 136, 192, 256, 384, 768, 1088 and 1152
      in fp32 and bf16, one call holding three validities as batch rows (a
      prefix, scattered keys, no valid key), Lq = 130 against Lk = 300,
      every query row compared;
  (b) the padding identity: heads of 136, 1088 and 3136 zero-padded to
      192, 1152 and 3328 through the plain versions, with the true width's
      scale and cut back, against the unpadded run; rel L2 <= 1e-6 (the
      same function: only the order of fp32 sums may differ);
  (c) under grad, `full_sparse_attention` takes the flash branch at D >
      128 on both sides (JAX's rule read as it reads it on a TPU), the two
      results and gradients equal within fp32's tolerance, at D = 192, 768
      and 1152 (past the old cap);
  (e) K7's rule: every multiple of 8 from 136 to 4096 maps to a width the
      wide source takes (its lane chunk read from the source, which checks
      no cap), the card check passes on stand-ins of the caller's views at
      that width, and a width off the rule raises;
  (f) the wide kernels' split (`wide_split`) at every card width up to
      4096: CTAs of 192, 128 or 64 lanes, a cluster within the cap the
      source asks the card for, passes (above 3072, of 64-lane CTAs only)
      tiling D exactly, and every multiple of 8 above the card width
      before it padded to this one.
Tolerances, those of tests/test_torch_port_flash_bwd_forms.py: fp32 atol
2e-5 on o, dq, dk and dv; bf16 rel L2 1e-2 and max abs 3.2e-2 (both sides
round P and dS to bf16 from fp32 values that differ in their last bits). The
static VAE at heads wider than 128 is
tests/test_torch_port_wide_heads_models.py. About 50 s alone.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gvfdiffusion_torch.ops import flash_attention as fl
from gvfdiffusion_torch.ops._widths import (COUNTED_MAX, FLASH_WIDTHS,
                                            WIDE_CLUSTER, WIDE_LANES,
                                            WIDE_SPAN, WIDE_SPLITS, card_width,
                                            flash_card_width, pad_heads,
                                            wide_passes, wide_split)
from gvfdiffusion_torch.sparse import attention as psa
from gvfdiffusion_tpu.sparse import attention as jsa

WIDE_SRC = (Path(__file__).resolve().parents[1] / "gvfdiffusion_torch"
            / "csrc" / "flash_attention_wide.cu")
ATOL = 2e-5
BF16_REL, BF16_ATOL = 1e-2, 3.2e-2
PAD_REL = 1e-6
B, H, LQ, LK = 3, 1, 130, 300
WIDTHS = (136, 192, 256, 384, 768, 1088, 1152)


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


def _inputs(D, seed, lq=LQ, lk=LK, b=B):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((b, n, H, D)).astype(np.float32)
               for n in (lq, lk, lk))
    return q, k, v, r.standard_normal((b, lq, H, D)).astype(np.float32)


def _jax_grads(arrays, valid, dtype):
    """(out, dq, dk, dv) of JAX's flash attention in `dtype`, kernels in
    interpret mode, as fp32 numpy."""
    qv, kv = jnp.ones(valid.shape[:1] + (arrays[0].shape[1],), bool), \
        jnp.asarray(valid)

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


def _port_grads(arrays, valid, dtype):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    tq, tk, tv = (a.clone().requires_grad_(True) for a in (q, k, v))
    D = q.shape[-1]
    out = fl.flash_attention(tq, tk, tv, torch.from_numpy(valid), D ** -0.5)
    out.backward(do)
    return [out.detach(), tq.grad, tk.grad, tv.grad]


# -- (a) the plain versions against JAX's stock kernels -----------------------


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_wide_heads_match_jax_pallas(dtype_name, D):
    dtype = getattr(torch, dtype_name)
    arrays = _inputs(D, seed=D + len(dtype_name))
    valid = _validity(LK, seed=D)
    want = _jax_grads(arrays, valid, getattr(jnp, dtype_name))
    got = _port_grads(arrays, valid, dtype)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    ref = fl.flash_attention_backward_reference(
        q, k, v, torch.from_numpy(valid), D ** -0.5, got[0], do)
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


# -- (b) the padding identity -------------------------------------------------


@pytest.mark.parametrize("D,W", [(136, 192), (1088, 1152), (3136, 3328)])
def test_wide_padding_identity(D, W):
    """136 -> 192, 1088 -> 1152 (its 64-lane split would take 17 CTAs) and
    3136 -> 3328 (4 passes of 13 CTAs of 64 lanes): zero columns change no
    score and no row sum, and give zero in the dropped columns of o, dq, dk
    and dv."""
    assert flash_card_width(D) == W
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(D, seed=5))
    valid = torch.from_numpy(_validity(LK, seed=5))
    scale = D ** -0.5
    o = fl.flash_attention_reference(q, k, v, valid, scale)
    grads = fl.flash_attention_backward_reference(q, k, v, valid, scale, o,
                                                  do)
    qp, kp, vp, dop = (pad_heads(t, W) for t in (q, k, v, do))
    op = fl.flash_attention_reference(qp, kp, vp, valid, scale)
    gp = fl.flash_attention_backward_reference(qp, kp, vp, valid, scale, op,
                                               dop)
    for name, a, b in zip(("o", "dq", "dk", "dv"), (op, *gp), (o, *grads)):
        assert float(a[..., D:].abs().max()) == 0, name
        err = float((a[..., :D] - b).norm() / b.norm())
        print(f"padding {D} -> {W} {name}: rel_l2 {err:.3e}")
        assert err <= PAD_REL, (name, err)


# -- (c) the dispatch under grad on both sides --------------------------------


@pytest.mark.parametrize("D", (192, 768, 1152))
def test_full_sparse_attention_takes_the_flash_branch(monkeypatch, D):
    """Both packages' `full_sparse_attention` under grad, the flash
    threshold lowered to the shape: the port's goes through K7's Function
    (K5's rule refuses D > 128), JAX's through `_flash_full_attention`
    (its rule as it reads it on a TPU); their outputs and gradients agree."""
    lq = lk = 300
    arrays = _inputs(D, seed=D + 1, lq=lq, lk=lk, b=2)
    valid = np.random.default_rng(D).uniform(size=(2, lk)) < 0.5
    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", lq * lk)
    applied = []
    real = fl.FlashAttention.apply
    monkeypatch.setattr(fl.FlashAttention, "apply",
                        lambda *a: applied.append(a[0].shape) or real(*a))
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    tq, tk, tv = (a.clone().requires_grad_(True) for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    out = psa.full_sparse_attention(tq, tk, tv, tvalid, tvalid,
                                    torch.float32)
    out.backward(do)
    assert applied == [q.shape]

    monkeypatch.setattr(jsa, "FLASH_SCORE_ELEMENTS", lq * lk)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    taken = []
    real_flash = jsa._flash_full_attention
    monkeypatch.setattr(jsa, "_flash_full_attention",
                        lambda *a: taken.append(a[0].shape) or real_flash(*a))
    jvalid = jnp.asarray(valid)

    def fwd_bwd(a, b, c, g):
        o, vjp = jax.vjp(lambda a_, b_, c_: jsa.full_sparse_attention(
            a_, b_, c_, jvalid, jvalid), a, b, c)
        return (o, *vjp(g))

    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(jax.jit(fwd_bwd)(
            *(jnp.asarray(a) for a in arrays)))
    assert taken == [q.shape]
    for name, g, w in zip(("out", "dq", "dk", "dv"),
                          (out.detach(), tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=f"d{D} {name}")


# -- (e) K7's width rule -------------------------------------------------------


def _source_constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", WIDE_SRC.read_text())
    return int(m.group(1))


class _OnCard:
    """A CPU tensor that answers as a CUDA one: the card check reads only
    metadata (device, dtype, shape, strides, alignment)."""
    is_cuda = True

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _card_widths():
    """Every card width above 128 up to COUNTED_MAX, ascending."""
    return sorted({flash_card_width(d) for d in range(136, COUNTED_MAX + 1, 8)})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_multiple_of_8_maps_to_a_wide_width(dtype):
    """136 .. 4096 step 8 -> a multiple of the source's lane chunk (the
    kernels' check: D % WL == 0, D > 128, no cap) whose split fits a
    cluster: up to 3072 the next multiple of 64 that splits into at most
    16 CTAs, within 191 lanes of the head;
    the card check passing on the views of a qkv projection; the counters
    exist for every width, and a head past them gets its own at its first
    launch."""
    lanes = _source_constant("WL")
    assert lanes == WIDE_LANES == 64 and WIDE_SPAN == 3072
    src = WIDE_SRC.read_text()
    assert "a.D % WL != 0 || a.D <= 128 || a.B < 1" in src
    assert "WIDE_MAX" not in src
    valid = _OnCard(torch.ones(1, 8, dtype=torch.bool))
    for d in range(136, COUNTED_MAX + 1, 8):
        w = flash_card_width(d)
        assert w % lanes == 0 and 128 < w and w >= d, d
        n = wide_split(w)[1]
        assert n <= WIDE_CLUSTER, d
        if w <= WIDE_SPAN:  # the next multiple of 64 whose split fits
            assert w - d < 192, d
            for x in range(-(-d // 64) * 64, w, 64):
                split = next(c for c in (192, 128, 64) if x % c == 0)
                assert x // split > WIDE_CLUSTER, (d, x)
        assert fl.key_tile(dtype, d) == 64
        qkv = torch.zeros(1, 8, 3, 1, d, dtype=dtype)
        q, k, v = (_OnCard(qkv[:, :, i]) for i in range(3))
        assert fl._check_cuda(q, k, v, valid) == w
        for kind in fl.GRAD_KINDS:
            assert fl.grad_key(kind, dtype, d) in fl.launch_counts
        assert fl.launch_key(dtype, d) in fl.launch_counts
    assert FLASH_WIDTHS == tuple(range(8, COUNTED_MAX + 1, 8))
    # up to 128 the rule is K5's and K6's, as before
    assert [flash_card_width(d) for d in range(8, 129, 8)] == [
        card_width(d) for d in range(8, 129, 8)]
    # past the counters made at import, a launch makes its own
    key = fl.launch_key(dtype, 8192)
    assert key not in fl.launch_counts
    try:
        fl._count(key)
        assert fl.launch_counts[key] == 1
    finally:
        del fl.launch_counts[key]


@pytest.mark.parametrize("d", [0, 4, 132, 196, 770, 1036, 4100])
def test_widths_off_the_rule_raise(d):
    """Not a positive multiple of 8: K7's rule refuses it (a multiple of 8
    of any size is on it: 1032 and 2048, off the old cap, run)."""
    with pytest.raises(ValueError, match="heads of"):
        flash_card_width(d)
    q = _OnCard(torch.zeros(1, 8, 1, d))
    with pytest.raises(ValueError):
        fl._check_cuda(q, q, q, _OnCard(torch.ones(1, 8, dtype=torch.bool)))
    with pytest.raises(ValueError):
        card_width(d)


@pytest.mark.parametrize("width", _card_widths())
def test_wide_backward_split(width):
    """The split of the wide kernels at each card width: up to 3072 the
    first of 192, 128 and 64 lanes that divides it, one pass; above, 64
    lanes and the fewest passes of at most 16 CTAs; the passes times the
    cluster times the lanes tiling D exactly, the cluster within the cap
    the source's launch asks for (non-portable above 8); every multiple of
    8 above the card width before it padded to this width; the wrapper
    hands the entries the lanes and the cluster."""
    lanes, n = wide_split(width)
    passes = wide_passes(width)
    assert WIDE_SPLITS == (192, 128, 64) and lanes * n * passes == width
    assert 1 <= n <= _source_constant("CLUSTER_MAX") == WIDE_CLUSTER == 16
    if width <= WIDE_SPAN:
        assert passes == 1
        assert lanes == next(c for c in (192, 128, 64) if width % c == 0)
    else:
        assert lanes == 64 and passes == -(-width // 64 // 16) > 1
    src = WIDE_SRC.read_text()
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in src
    assert "(a.D / span > 1 && lanes != 64)" in src
    widths = _card_widths()
    before = widths[widths.index(width) - 1] if width != widths[0] else 128
    for d in range(before + 8, width + 1, 8):
        assert flash_card_width(d) == width, d
    assert fl._split(width) == (lanes, n)
    assert fl._split(128) == ()


@pytest.mark.parametrize("width", [128, 200, 1088, 3200])
def test_wide_split_off_the_rule_raises(width):
    """Not a card width: 128 and below, not a multiple of 64, a split past
    16 CTAs (1088: 17 of 64 lanes; it runs at 1152), or above 3072 no
    whole passes of 64-lane clusters (3200: 50 chunks in 4 passes)."""
    with pytest.raises(ValueError, match="wide kernels take"):
        wide_split(width)
