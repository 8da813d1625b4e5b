"""K1, K2 and K3 (gvfdiffusion_torch/ops/fused_sublayer.py) at every head
width their dispatch rules admit, on the CPU: the rules against the card's
checks and instantiations, the padding that carries a head narrower than
32 to the kernels' width, and parity of K1's and K2's forms with JAX at
the new widths (K3's: tests/test_torch_port_sublayer_widths_k3.py).

The rules (`self_sublayer_supports`, `temporal_sublayer_supports`,
`cross_sublayer_supports`, JAX's less their VMEM terms) admit every head
width D that divides 128 over C a multiple of 128. The card kernels are
built at 32, 64 and 128; a narrower head runs at 32
(`_widths.sublayer_card_width`), zero-padded in the projections' weights
(`widen_self_weights`, `widen_cross_params`) and in K3's cache
(`widen_heads`), with the scale D ** -0.5 of the true width. This file
holds:
  (a) for every C in 128, 256, 512, 1024 and every head count H where a
      rule admits the shape, that the wrapper's card check, run on CPU
      stand-ins of the caller's tensors, passes and names a card width
      that the `.cu` sources instantiate for every form (read from the
      sources); and that a width no rule admits (48, 24, 256) raises;
  (b) the padding identity on the plain versions in fp32, at D = 1, 2,
      4, 8 and 16: each form's `*_reference` at heads of 32 on the padded
      parameters (and cache), with sqrt(32 / D) folded into the q side so
      that the scores carry the true scale D ** -0.5, against the same
      function on the unpadded ones; rel L2 <= 1e-6 (the same function:
      only the order of fp32 sums may differ). A reference at heads of 32
      reads a residual 32 H wide, so the padded problem repeats the
      residual, and every vector it meets, 32 / D times (`_Embed`): the
      LN's mean and variance are then those at width C, the input
      projections read the first copy, and the output projection writes
      every copy, which keeps the repeat through two cross contexts;
  (c) parity of K1 (float with and without the q/k RMS norms, int8 QK,
      `seg` float and int8 QK) and K2 (float with and without the norms,
      int8 QK) with JAX's Pallas kernels in interpret mode (each JAX call
      jitted and blocked on) at D = 4, 8, 16 and 128 (C = 128), on the
      same seeded numpy inputs in fp32. Tolerances, those the existing
      parity tests state for the same forms: the float forms 2e-4 abs /
      rel (tests/test_torch_port_sublayers.py), the int8-QK forms 5e-4
      abs / rel (tests/test_torch_port_selfq8.py).
About 40 s alone.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import fused_sublayer as pt
from gvfdiffusion_torch.ops._widths import (CARD_WIDTHS, SUBLAYER_WIDTHS,
                                            sublayer_card_width)
from gvfdiffusion_tpu.ops import fused_sublayer as fs

CSRC = Path(__file__).resolve().parents[1] / "gvfdiffusion_torch" / "csrc"
PAD_REL = 1e-6
FLOAT_TOL = dict(rtol=2e-4, atol=2e-4)
Q8_TOL = dict(rtol=5e-4, atol=5e-4)
C = 128
PARITY_WIDTHS = (4, 8, 16, 128)
PAD_WIDTHS = (1, 2, 4, 8, 16)


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


def _arr(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _jax(fn, *args):
    """A JAX call that reaches an interpret-mode kernel: jitted, blocked
    on (the CPU client can deadlock otherwise)."""
    return np.asarray(jax.block_until_ready(jax.jit(fn)(*args)), np.float32)


# -- (a) the rules against the card's checks and instantiations ---------------


def _instantiated(pattern):
    text = (CSRC / "fused_sublayer.cu").read_text()
    return {int(w) for w in re.findall(pattern, text)}


# what fused_sublayer.cu instantiates for each form's kernels
FORM_PATTERNS = {
    "qkv epilogue": r"launch_gemm_sm90<false, float, bf16, false, (\d+)>",
    "K1 attention": r"launch_attn_sm90<(\d+), bf16, bf16, bf16, false>",
    "K3 attention": r"launch_attn_sm90<(\d+), float, bf16, bf16, false>",
    "K3 fp32 attention": r"launch_attn_tf32<(\d+)>",
    "K1 int8 QK": r"launch_attn_sm90_q8<(\d+), sm90::Q8_SELF>",
    "K3 int8 cache": r"launch_attn_sm90_q8<(\d+), sm90::Q8_CACHE>",
    "q8_kernel": r"q8_kernel<(\d+)><<<",
    "K2 float": r"launch_temporal<(\d+), sm90::TForm::Float>",
    "K2 int8 QK": r"launch_temporal<(\d+), sm90::TForm::Q8>",
}


class _OnCard:
    """A CPU tensor that answers as a CUDA one: the card checks read only
    metadata (device, dtype)."""
    is_cuda = True

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _heads(c):
    return [h for h in range(1, c + 1) if c % h == 0]


def test_sources_instantiate_the_card_widths():
    widths = {sublayer_card_width(d) for d in SUBLAYER_WIDTHS}
    assert widths == set(CARD_WIDTHS) == {32, 64, 128}
    for form, pattern in FORM_PATTERNS.items():
        assert _instantiated(pattern) == widths, form
    assert [sublayer_card_width(d) for d in SUBLAYER_WIDTHS] == \
        [32] * 6 + [64, 128]
    for d in (0, 3, 24, 48, 96, 256):
        with pytest.raises(ValueError):
            sublayer_card_width(d)


@pytest.mark.parametrize("Cc", [128, 256, 512, 1024])
def test_rules_pass_the_card_checks(Cc):
    """Where a rule admits (B, L, C, H), the check of every form's card
    path passes on bf16 (fp32 for K3's fp32 single context) stand-ins and
    returns the card width; where none admits, it raises."""
    admitted = 0
    for H in _heads(Cc):
        D = Cc // H
        rules = (pt.self_sublayer_supports(2, 128, Cc, H),
                 pt.temporal_sublayer_supports(1, 8, 16, Cc, H),
                 pt.cross_sublayer_supports(2, 128, Cc, H, 37, 20))
        assert len(set(rules)) == 1, (Cc, H)
        bf = _OnCard(torch.zeros(4, dtype=torch.bfloat16))
        f32 = _OnCard(torch.zeros(4))
        if rules[0]:
            admitted += 1
            assert pt._check_cuda(torch.bfloat16, H, Cc, 2, bf, bf) == \
                sublayer_card_width(D) == max(D, 32)
            assert pt._check_f32(H, Cc, 2, f32, f32) == max(D, 32)
        else:
            assert 128 % D
            with pytest.raises(ValueError, match="divide 128"):
                pt._check_cuda(torch.bfloat16, H, Cc, 2, bf)
            with pytest.raises(ValueError, match="divide 128"):
                pt._check_f32(H, Cc, 2, f32)
    assert admitted == 8  # heads of 1, 2, 4, ..., 128 lanes
    # the MLP has no heads: no width to check
    assert pt._check_cuda(torch.bfloat16, None, Cc, 0) == 0


@pytest.mark.parametrize("Cc,H", [(384, 8), (384, 16), (768, 16)])
def test_widths_no_rule_admits_raise(Cc, H):
    """Heads of 48, 24 and 48 over C a multiple of 128: refused by the
    rules and by the card checks alike."""
    assert not pt.self_sublayer_supports(2, 128, Cc, H)
    assert not pt.temporal_sublayer_supports(1, 8, 16, Cc, H)
    assert not pt.cross_sublayer_supports(2, 128, Cc, H, 37, 20)
    bf = _OnCard(torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="divide 128"):
        pt._check_cuda(torch.bfloat16, H, Cc, 2, bf)


# -- (b) the padding identity on the plain versions ---------------------------


def _self_inputs(seed, shape, rows, c=C):
    r = np.random.default_rng(seed)
    gam = lambda: (np.abs(_arr(r, c, scale=0.3)) + 1.0).astype(np.float32)
    return [torch.from_numpy(a) for a in (
        _arr(r, *shape, c), _arr(r, rows, c, scale=0.2),
        _arr(r, rows, c, scale=0.2), _arr(r, rows, c, scale=0.5),
        _arr(r, c, 3 * c, scale=0.05), _arr(r, 3 * c, scale=0.05), gam(),
        gam(), _arr(r, c, c, scale=0.05), _arr(r, c, scale=0.05))]


def test_widening_is_the_identity_from_32_lanes():
    args = _self_inputs(0, (1, 8), 1)
    for H in (4, 2, 1):  # heads of 32, 64, 128
        wide = pt.widen_self_weights(*args[4:9], H)
        assert all(a is b for a, b in zip(wide, args[4:9]))
        k = args[0]
        assert pt.widen_heads(k, C // H) is k


@pytest.mark.parametrize("D", PAD_WIDTHS)
def test_widened_shapes(D):
    H = C // D
    x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo = _self_inputs(1, (1, 8), 1)
    w = pt.widen_self_weights(wqkv, bqkv, qg, kg, wo, H)
    Cp = 32 * H
    assert [tuple(a.shape) for a in w] == [(C, 3 * Cp), (3 * Cp,), (Cp,),
                                           (Cp,), (Cp, C)]
    # the kernels read [out, in] rows: the weights are free transposes
    assert w[0].t().is_contiguous() and w[4].t().is_contiguous()
    # head h's lanes land at h * 32 .. h * 32 + D - 1, the rest zero
    g = w[2].reshape(H, 32)
    assert torch.equal(g[:, :D], qg.reshape(H, D))
    assert not g[:, D:].any()
    v = w[0].t().reshape(3, H, 32, C)
    assert torch.equal(v[:, :, :D], wqkv.t().reshape(3, H, D, C))
    assert not v[:, :, D:].any()
    assert pt.widen_heads(torch.ones(2, 5, C), D).shape == (2, 5, Cp)


class _Embed:
    """The padded problem at heads of 32 (see (b) above): a [.., C]
    residual or vector repeated k = 32 / D times; an input projection
    [C, n] with zero rows for the copies past the first; an output
    projection [Cp, C] writing every copy; the q side's lane gammas (or,
    without the norm, its projection columns and bias) times sqrt(32 / D),
    the ratio of the scale at 32 to the true one."""

    def __init__(self, D):
        self.k, self.f = 32 // D, (32 / D) ** 0.5

    def rep(self, t):
        return torch.cat([t] * self.k, -1)

    def rows_in(self, w):
        return torch.cat([w, w.new_zeros((self.k - 1) * w.shape[0],
                                         w.shape[1])], 0)

    def cols_out(self, w):
        return torch.cat([w] * self.k, 1)


@pytest.mark.parametrize("form", ["self", "self_norms_off", "self_seg",
                                  "self_q8", "temporal", "temporal_q8"])
@pytest.mark.parametrize("D", PAD_WIDTHS)
def test_self_padding_identity(D, form):
    H, e = C // D, _Embed(D)
    temporal = form.startswith("temporal")
    args = _self_inputs(2, (2, 8, 16) if temporal else (2, 64), 2)
    rms = form != "self_norms_off"
    kw = dict(num_heads=H, rms=rms, compute_dtype=torch.float32)
    if form == "self_seg":
        kw["seg"] = 4
    fn = {"self_q8": pt.self_sublayer_qk8_reference,
          "temporal": pt.temporal_sublayer_reference,
          "temporal_q8": pt.temporal_sublayer_qk8_reference}.get(
              form, pt.self_sublayer_reference)
    want = fn(*args, **kw)
    wqkv, bqkv, qg, kg, wo = pt.widen_self_weights(*args[4:9], H)
    if rms:
        qg = qg * e.f
    else:
        q = torch.ones(3 * H * 32)
        q[:H * 32] = e.f
        wqkv, bqkv = wqkv * q, bqkv * q
    got = fn(*map(e.rep, args[:4]), e.rows_in(wqkv), bqkv, qg, kg,
             e.cols_out(wo), e.rep(args[9]), **kw)[..., :C]
    err = _rel(got, want)
    print(f"{form} heads of {D} padded to 32: rel L2 {err:.2e}")
    assert err <= PAD_REL, err


def _cross_inputs(seed, B, L, lks, c=C):
    r = np.random.default_rng(seed)
    t = lambda *s, scale=1.0: torch.from_numpy(_arr(r, *s, scale=scale))
    out = [t(B, L, c)]
    for lk in lks:
        gam = torch.from_numpy((np.abs(_arr(r, c, scale=0.3)) + 1.0).astype(
            np.float32))
        out += [(1.0 + t(c, scale=0.1), t(c, scale=0.1),
                 t(c, c, scale=0.09), t(c, scale=0.1), gam,
                 t(c, c, scale=0.09), t(c, scale=0.1)),
                (t(B, lk, c), t(B, lk, c))]
    return out


def _int8_cache(kv, H):
    kq, ks = pt.quantize_kv(kv[0], H)
    vq, vs = pt.quantize_kv(kv[1], H)
    return kq, vq, ks.transpose(1, 2).contiguous(), vs


@pytest.mark.parametrize("form", ["cross", "cross_rms", "cross_q8",
                                  "single", "single_rms", "single_q8"])
@pytest.mark.parametrize("D", PAD_WIDTHS)
def test_cross_padding_identity(D, form):
    H = C // D
    single = form.startswith("single")
    x, *groups = _cross_inputs(3, 2, 32, (37,) if single else (37, 20))
    rms = form.endswith("rms") or form.endswith("q8")
    quant = form.endswith("q8")
    pairs = [(groups[i], groups[i + 1]) for i in range(0, len(groups), 2)]
    if quant:
        pairs = [(p, _int8_cache(kv, H)) for p, kv in pairs]

    e = _Embed(D)

    def widen(p, kv):
        wk = tuple(pt.widen_heads(a, D) for a in kv[:2]) + tuple(kv[2:])
        ns, nb, wq, bq, qg, wo, bo = pt.widen_cross_params(p, H, rms)
        if rms:
            qg = qg * e.f
        else:
            wq, bq = wq * e.f, bq * e.f
        return (e.rep(ns), e.rep(nb), e.rows_in(wq), bq, qg,
                e.cols_out(wo), e.rep(bo)), wk

    fn = pt.cross_sublayer_q8_reference if quant else \
        pt.cross_sublayer_reference
    kw = dict(num_heads=H, rms=rms, compute_dtype=torch.float32)
    want = fn(x, *[a for pr in pairs for a in pr], **kw)
    got = fn(e.rep(x), *[a for pr in pairs for a in widen(*pr)],
             **kw)[..., :C]
    err = _rel(got, want)
    print(f"{form} heads of {D} padded to 32: rel L2 {err:.2e}")
    assert err <= PAD_REL, err


# -- (c) K1 and K2 against JAX's interpret-mode kernels -----------------------


def _self_np(seed, shape, rows):
    return [a.numpy() for a in _self_inputs(seed, shape, rows)]


@pytest.mark.parametrize("form", ["self", "self_norms_off", "self_q8",
                                  "self_seg", "self_seg_q8"])
@pytest.mark.parametrize("D", PARITY_WIDTHS)
def test_k1_forms_match_jax_kernel(D, form):
    H = C // D
    quant = form.endswith("q8")
    kw = dict(num_heads=H, rms=form != "self_norms_off", mod_repeat=2,
              seg=4 if "seg" in form else 0, quant_qk=quant)
    args = _self_np(10 + D, (4, 128), 2)
    want = _jax(lambda *a: fs.fused_self_sublayer(
        *a, compute_dtype=jnp.float32, interpret=True, **kw), *args)
    got = pt.fused_self_sublayer(*map(torch.from_numpy, args),
                                 compute_dtype=torch.float32, **kw).numpy()
    print(f"K1 {form} heads of {D}: max abs {np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, **(Q8_TOL if quant else FLOAT_TOL))


@pytest.mark.parametrize("form", ["temporal", "temporal_norms_off",
                                  "temporal_q8"])
@pytest.mark.parametrize("D", PARITY_WIDTHS)
def test_k2_forms_match_jax_kernel(D, form):
    H = C // D
    quant = form.endswith("q8")
    kw = dict(num_heads=H, rms=form != "temporal_norms_off", quant_qk=quant)
    args = _self_np(20 + D, (2, 8, 32), 2)
    want = _jax(lambda *a: fs.fused_temporal_sublayer(
        *a, compute_dtype=jnp.float32, interpret=True, **kw), *args)
    got = pt.fused_temporal_sublayer(*map(torch.from_numpy, args),
                                     compute_dtype=torch.float32,
                                     **kw).numpy()
    print(f"K2 {form} heads of {D}: max abs {np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, **(Q8_TOL if quant else FLOAT_TOL))
