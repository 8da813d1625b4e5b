"""K5, K6 and K7 at every head width their dispatch rules admit, on the
CPU: the rules against the card's checks and instantiations, the padding
that carries a head of another width to the card's, and parity with JAX
at the new widths.

The card kernels are built at heads of 32, 64 and 128
(`gvfdiffusion_torch/csrc/`); the rules (`fused_attention.supports`,
`temporal_supports`, K7's branch of `full_sparse_attention`) admit any
multiple of 8 up to 128. The wrappers zero-pad a head to
`_widths.card_width(D)`, launch at that width with the scale D ** -0.5 of
the true width, and keep the first D columns. This file holds:
  (a) for every D in 8 .. 128 step 8 and every head count H with H * D a
      multiple of 128 up to 1024 lanes, where a rule admits the shape,
      that `card_width(D)` is a width the `.cu` sources instantiate (read
      from the sources) and that the wrapper's card check, run on CPU
      stand-ins of the caller's tensors (the views of a qkv projection),
      does not raise;
  (b) the padding identity on the plain versions in fp32: zero-pad to the
      card width, run with the true scale, cut back, against the unpadded
      run, for K5 (the fixed shift at heads up to 32, the running maximum
      above, `kv_bias`, `segment_size`, both int8 forms), K6, and K7's
      forward, row logsumexp and dq / dk / dv; rel L2 <= 1e-6 (the same
      function: only the order of fp32 sums may differ);
  (c) parity with JAX's Pallas kernels in interpret mode (each JAX call
      jitted and blocked on) at the new widths, on the same seeded numpy
      inputs: K5 at heads of 16 and 128, K6 at 16 and 128, K7's forward
      and gradients at 24 and 96. Tolerances, those the existing parity
      tests state for the same kernels: K5 fp32 atol = rtol = 2e-5 and
      bf16 compute rel L2 5e-3 (tests/test_torch_port_attention.py); K6
      fp32 rel L2 2e-4, bf16 io 1e-3 (tests/test_torch_port_k6_edges.py);
      K7 fp32 atol 2e-5 on the output and on dq, dk and dv
      (tests/test_torch_port_flash.py, tests/test_torch_port_flash_bwd.py).
About 30 s alone.
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
from gvfdiffusion_torch.ops import fused_attention as pfa
from gvfdiffusion_torch.ops._widths import (CARD_WIDTHS, WIDTHS, card_width,
                                            pad_heads)
from gvfdiffusion_torch.sparse import attention as psa
from gvfdiffusion_tpu.ops import fused_attention as jfa
from gvfdiffusion_tpu.sparse import attention as jsa

CSRC = Path(__file__).resolve().parents[1] / "gvfdiffusion_torch" / "csrc"
PAD_REL = 1e-6
K5_ATOL, K5_BF16_REL = 2e-5, 5e-3
K6_REL = {"float32": 2e-4, "bfloat16": 1e-3}
K7_ATOL = 2e-5


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


def _instantiated(source, pattern):
    return {int(w) for w in re.findall(pattern, (CSRC / source).read_text())}


# the widths each kernel's sources instantiate
K5_WIDTHS = _instantiated("fused_attention.cu", r"launch<(\d+), (?:bf16|float)")
K5_Q8_WIDTHS = (_instantiated("fused_attention.cu",
                              r"launch_attn_sm90_q8<(\d+), Q8_QK,")
                & _instantiated("fused_attention.cu",
                                r"launch_attn_sm90_q8<(\d+), Q8_QKAV,")
                & _instantiated("fused_attention.cu", r"quant_kernel<(\d+)>"))
K6_WIDTHS = (_instantiated("temporal_attention.cu",
                           r"launch_temporal<(\d+), TForm::Shift>")
             & _instantiated("temporal_attention.cu",
                             r"launch_temporal<(\d+), TForm::ShiftF32>"))
K7_WIDTHS = (_instantiated("flash_attention.cu", r"GVF_FLASH\((\d+)\)")
             & _instantiated("flash_attention_bwd.cu", r"launch_dkv<(\d+)>")
             & _instantiated("flash_attention_bwd.cu", r"launch_dq<(\d+)>")
             & _instantiated("flash_attention_bwd_bf16.cu",
                             r"launch_dkv<(\d+)>")
             & _instantiated("flash_attention_bwd_bf16.cu",
                             r"launch_dq<(\d+)>"))


class _OnCard:
    """A CPU tensor that answers as a CUDA one: the card checks read only
    metadata (device, dtype, shape, strides, alignment)."""
    is_cuda = True

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _views(shape, dtype):
    """q, k, v: the views of one projection [..., 3, H, D] on the card."""
    qkv = torch.zeros(*shape[:-2], 3, *shape[-2:], dtype=dtype)
    return [_OnCard(qkv[..., i, :, :]) for i in range(3)]


def _admitted():
    """(D, H) with H * D a multiple of 128, up to 1024 lanes."""
    return [(d, h) for d in WIDTHS for h in range(1, 1024 // d + 1)
            if h * d % 128 == 0]


def test_instantiated_widths_are_the_card_widths():
    assert set(CARD_WIDTHS) == K5_WIDTHS == K5_Q8_WIDTHS == K6_WIDTHS \
        == K7_WIDTHS == {32, 64, 128}
    assert [card_width(d) for d in WIDTHS] == [32] * 4 + [64] * 4 + [128] * 8
    for d in (0, 4, 12, 130, 136, 256):
        with pytest.raises(ValueError):
            card_width(d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,H", _admitted())
def test_rules_map_to_instantiated_widths(D, H, dtype, monkeypatch):
    """Where K5's, K6's or K7's rule admits a shape, the kernel has its
    card width and the wrapper's card check passes on the caller's views
    (the q8 forms: bf16 only)."""
    L = 128
    assert pfa.supports((1, L, H, D), (1, L, H, D))
    assert card_width(D) in K5_WIDTHS
    q, k, v = _views((1, L, H, D), dtype)
    bias = _OnCard(torch.zeros(1, L))
    assert pfa._check_cuda(q, k, v, bias, torch.bfloat16) == card_width(D)
    if dtype == torch.bfloat16:
        assert card_width(D) in K5_Q8_WIDTHS
    T, N = 24, 16
    assert pfa.temporal_supports((1, T, N, H, D))
    assert card_width(D) in K6_WIDTHS
    q, k, v = _views((1, T, N, H, D), dtype)
    assert pfa._check_temporal_cuda(q, k, v, torch.bfloat16) == card_width(D)
    # K7: full_sparse_attention's flash branch takes the shape; its check
    # passes on the card stand-ins
    assert card_width(D) in K7_WIDTHS
    q, k, v = _views((1, 8, H, D), dtype)
    valid = _OnCard(torch.ones(1, 8, dtype=torch.bool))
    assert fl._check_cuda(q, k, v, valid) == card_width(D)
    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", 1)
    seen = []
    monkeypatch.setattr(fl, "flash_attention",
                        lambda q, *a, **kw: seen.append(q.shape[-1]) or q)
    x = torch.zeros(1, 8, H, D)
    psa.full_sparse_attention(x, x, x, torch.ones(1, 8, dtype=torch.bool),
                              torch.ones(1, 8, dtype=torch.bool),
                              torch.float32)
    assert seen == [D]


# -- (b) the padding identity on the plain versions ---------------------------


def _pad(width, *ts):
    return [pad_heads(t, width) for t in ts]


def _draw(seed, *shapes, std=2.0):
    r = np.random.default_rng(seed)
    return [torch.from_numpy((r.standard_normal(s) * std).astype(np.float32))
            for s in shapes]


_FLOAT_CASES = [dict(D=16), dict(D=24, bias=True), dict(D=48),
                dict(D=96, bias=True), dict(D=16, seg=32), dict(D=48, seg=64)]
# the int8 forms compute in bf16 only
_Q8_CASES = [dict(D=16, quant="qk"), dict(D=16, quant="qk+av", bias=True),
             dict(D=96, quant="qk"), dict(D=96, quant="qk+av")]


@pytest.mark.parametrize("case,compute", [
    (c, dt) for c in _FLOAT_CASES for dt in ("float32", "bfloat16")]
    + [(c, "bfloat16") for c in _Q8_CASES])
def test_k5_padding_identity(case, compute):
    """The fixed shift (D <= 32, padded to 32) and the running maximum
    (wider heads, padded to 64 or 128) alike."""
    D, quant = case["D"], case.get("quant", "")
    H = 128 // np.gcd(128, D)
    q, k, v = _draw(D, (2, 256, H, D), (2, 256, H, D), (2, 256, H, D))
    bias = None
    if case.get("bias"):
        bias = torch.randn(2, 256, generator=torch.Generator().manual_seed(0))
        bias[:, 200:] = float("-inf")
    kw = dict(compute_dtype=getattr(torch, compute), kv_bias=bias,
              segment_size=case.get("seg", 0), quant=quant)
    want = pfa.attention_reference(q, k, v, D ** -0.5, **kw)
    got = pfa.attention_reference(*_pad(card_width(D), q, k, v), D ** -0.5,
                                  **kw)[..., :D]
    err = _rel(got, want)
    assert err <= PAD_REL, err


@pytest.mark.parametrize("D", [8, 16, 40, 96, 120])
def test_k6_padding_identity(D):
    H = 128 // np.gcd(128, D)
    q, k, v = _draw(D, *[(2, 24, 8, H, D)] * 3)
    for compute in (torch.float32, torch.bfloat16):
        want = pfa.temporal_attention_reference(q, k, v, D ** -0.5, compute)
        got = pfa.temporal_attention_reference(
            *_pad(card_width(D), q, k, v), D ** -0.5, compute)[..., :D]
        assert _rel(got, want) <= PAD_REL


def _lse(q, k, valid, scale):
    """K7's row logsumexp [B, H, Lq] from the plain version's scores."""
    kf, _, bias, _ = fl._padded(k, k, valid)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale + bias
    return torch.logsumexp(s, -1)


@pytest.mark.parametrize("D", [24, 48, 96])
def test_k7_padding_identity(D):
    H = 128 // np.gcd(128, D)
    q, k, v, do = _draw(D, *[(2, 300, H, D)] * 4)
    valid = torch.rand(2, 300, generator=torch.Generator().manual_seed(D)) \
        < 0.4
    valid[1] = False  # a row with no valid key: P spread over every key
    s = D ** -0.5
    W = card_width(D)
    qp, kp, vp, dop = _pad(W, q, k, v, do)
    o = fl.flash_attention_reference(q, k, v, valid, s)
    op = fl.flash_attention_reference(qp, kp, vp, valid, s)
    assert _rel(op[..., :D], o) <= PAD_REL and not op[..., D:].any()
    assert _rel(_lse(qp, kp, valid, s), _lse(q, k, valid, s)) <= PAD_REL
    grads = fl.flash_attention_backward_reference(q, k, v, valid, s, o, do)
    gp = fl.flash_attention_backward_reference(qp, kp, vp, valid, s, op, dop)
    for g, p in zip(grads, gp):
        assert _rel(p[..., :D], g) <= PAD_REL and not p[..., D:].any()


# -- (c) parity with JAX at the new widths ------------------------------------


@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_k5_matches_jax_at_new_widths(D, compute):
    H = 128 // D
    q, k, v = (a.numpy() for a in _draw(D + 1, (2, 173, H, D),
                                        (2, 130, H, D), (2, 130, H, D)))
    bias = np.where(np.random.default_rng(2).uniform(size=(2, 130)) < 0.7,
                    0.0, -np.inf).astype(np.float32)
    fn = jax.jit(lambda q, k, v, b: jfa.fused_attention(
        q, k, v, D ** -0.5, getattr(jnp, compute), True, kv_bias=b))
    want = np.asarray(jax.block_until_ready(fn(q, k, v, bias)))
    got = pfa.fused_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              D ** -0.5, getattr(torch, compute),
                              kv_bias=torch.from_numpy(bias)).numpy()
    if compute == "float32":
        np.testing.assert_allclose(got, want, atol=K5_ATOL, rtol=K5_ATOL)
    else:
        assert _rel(got, want) <= K5_BF16_REL


@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("io", ["float32", "bfloat16"])
def test_k6_matches_jax_at_new_widths(D, io):
    H = 128 // D
    # unit draws, as tests/test_torch_port_k6_edges.py's
    q, qkv = (a.numpy() for a in _draw(D + 2, (2, 24, 8, H, D),
                                       (2, 24, 8, 3, H, D), std=1.0))
    tdt, jdt = getattr(torch, io), getattr(jnp, io)
    tqkv = torch.from_numpy(qkv).to(tdt)
    got = pfa.temporal_attention(torch.from_numpy(q).to(tdt),
                                 tqkv[..., 1, :, :], tqkv[..., 2, :, :],
                                 D ** -0.5)
    fn = jax.jit(lambda q, k, v: jfa.temporal_attention(
        q, k, v, D ** -0.5, jnp.bfloat16, True))
    want = jax.block_until_ready(fn(*(jnp.asarray(a, jdt) for a in (
        q, qkv[..., 1, :, :], qkv[..., 2, :, :]))))
    err = _rel(got.float().numpy(), np.asarray(want, np.float32))
    assert err <= K6_REL[io], err


@pytest.mark.parametrize("D", [24, 96])
def test_k7_matches_jax_at_new_widths(D):
    """Forward and gradients through the wrapper under grad against
    jax.vjp of `_flash_full_attention` (the stock kernels in interpret
    mode); scattered validity and a batch row with none."""
    H = 2
    q, k, v, do = (a.numpy() for a in _draw(D + 3, (2, 130, H, D),
                                            *[(2, 600, H, D)] * 2,
                                            (2, 130, H, D)))
    valid = np.random.default_rng(D).uniform(size=(2, 600)) < 0.3
    valid[1] = False
    qv = jnp.ones(q.shape[:2], bool)

    def fwd_bwd(a, b, c, g):
        out, vjp = jax.vjp(lambda a_, b_, c_: jsa._flash_full_attention(
            a_, b_, c_, qv, jnp.asarray(valid)), a, b, c)
        return (out, *vjp(g))

    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(jax.jit(fwd_bwd)(
            *(jnp.asarray(a) for a in (q, k, v, do))))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fl.flash_attention(tq, tk, tv, torch.from_numpy(valid), D ** -0.5)
    out.backward(torch.from_numpy(do))
    for name, g, w in zip(("out", "dq", "dk", "dv"),
                          (out.detach(), tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=K7_ATOL,
                                   rtol=0, err_msg=name)
