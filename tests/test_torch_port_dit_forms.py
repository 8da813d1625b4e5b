"""Port parity: the kernel forms of the DiT's other configurations, each
plain version (gvfdiffusion_torch/ops/fused_sublayer.py, ops/
fused_attention.py) against the JAX package's Pallas kernel in interpret
mode, on the CPU:

  * K1 / K2 without the q/k RMS norm (`rms=False`) and at heads of 64
    (C = 128, 2 heads), with and without the norm;
  * K3 (two contexts) with the q RMS norm (`rms=True`) and at heads of
    64, on a float cache and on an int8 cache (`quant=True`);
  * K1 / K2 with int8 QK (`quant_qk=True`) at `rms=False` and at heads
    of 64;
  * K6 at heads of 64, forward and VJP.

Tolerances, each with its reason: the float forms 2e-4 abs / rel (the
fp32 sublayers' bound, tests/test_torch_port_sublayers.py); the int8
forms 5e-4 abs / rel in fp32 (a value near a rounding half step can land
one int8 step apart when the fp32 product, summed in another order,
differs in its last bit: tests/test_torch_port_selfq8.py) and rel L2 of
the bf16 update y - x <= 1e-2 (both round P, V and y to bf16 at the same
points, and a flipped int8 step moves a score by ~1/127 of its scale);
K6 forward rel L2 <= 2e-4 and VJP <= 1e-5 (tests/test_torch_port_train.py:
the same rounding points, and the plain fp32 gradient on both sides).
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
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

TOL = dict(rtol=2e-4, atol=2e-4)
TOL_Q8 = dict(rtol=5e-4, atol=5e-4)
REL_BF16 = 1e-2
C = 128
# (rms, heads): the new forms; heads 4 = width 32 (the shipped width), 2 =
# width 64 (the DiT's 8-head configuration at C = 512)
SELF_FORMS = [(False, 4), (True, 2), (False, 2)]
CROSS_FORMS = [(True, 4), (True, 2), (False, 2)]


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


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


def _gamma(r):
    return (np.abs(_arr(r, C, scale=0.3)) + 1.0).astype(np.float32)


def _self_args(seed, xshape, rows):
    r = np.random.default_rng(seed)
    return [_arr(r, *xshape), _arr(r, rows, C, scale=0.2),
            _arr(r, rows, C, scale=0.2), _arr(r, rows, C, scale=0.5),
            _arr(r, C, 3 * C, scale=0.05), _arr(r, 3 * C, scale=0.05),
            _gamma(r), _gamma(r), _arr(r, C, C, scale=0.05),
            _arr(r, C, scale=0.05)]


def _self_run(kind, args, dt, rms, heads, **kw):
    port_fn = {"self": pt.fused_self_sublayer,
               "temporal": pt.fused_temporal_sublayer}[kind]
    jax_fn = {"self": fs.fused_self_sublayer,
              "temporal": fs.fused_temporal_sublayer}[kind]
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dt]
    with torch.no_grad():
        got = port_fn(*(torch.from_numpy(a).to(dt) for a in args),
                      num_heads=heads, rms=rms, compute_dtype=dt, **kw)
    want = jax_fn(*(jnp.asarray(a).astype(jdt) for a in args),
                  num_heads=heads, rms=rms, compute_dtype=jdt,
                  interpret=True, **kw)
    return got, want


def _self_shape(kind):
    # K1: 4 frames of 128 rows (mod_repeat 2); K2: 2 x 8 frames x 32 voxels
    return ((4, 128, C), 2, dict(mod_repeat=2)) if kind == "self" else \
        ((2, 8, 32, C), 2, {})


@pytest.mark.parametrize("rms,heads", SELF_FORMS)
@pytest.mark.parametrize("kind", ["self", "temporal"])
def test_self_forms_match_jax_kernel(kind, rms, heads):
    xshape, rows, kw = _self_shape(kind)
    args = _self_args(0, xshape, rows)
    got, want = _self_run(kind, args, torch.float32, rms, heads, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the flag is read: the other setting gives another output
    other, _ = _self_run(kind, args, torch.float32, not rms, heads, **kw)
    assert _rel(_np(other) - args[0], _np(got) - args[0]) > 1e-2


@pytest.mark.parametrize("rms,heads", SELF_FORMS)
@pytest.mark.parametrize("kind", ["self", "temporal"])
def test_self_qk8_forms_match_jax_kernel(kind, rms, heads):
    xshape, rows, kw = _self_shape(kind)
    args = _self_args(1, xshape, rows)
    got, want = _self_run(kind, args, torch.float32, rms, heads,
                          quant_qk=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_Q8)
    flt, _ = _self_run(kind, args, torch.float32, rms, heads, **kw)
    x = args[0]
    assert 1e-5 < _rel(_np(got) - x, _np(flt) - x) < 2e-2  # not the float


@pytest.mark.parametrize("kind", ["self", "temporal"])
def test_self_qk8_forms_bf16(kind):
    """bf16 compute at heads of 64 without the norm: the update's rel L2."""
    xshape, rows, kw = _self_shape(kind)
    args = _self_args(2, xshape, rows)
    got, want = _self_run(kind, args, torch.bfloat16, False, 2,
                          quant_qk=True, **kw)
    x = args[0]
    assert got.dtype == torch.bfloat16
    upd = _rel(_np(got) - x, _np(want) - x)
    assert upd <= REL_BF16, upd


def _cross_case(seed, rms, heads, B=2, L=64, lks=(130, 37)):
    """x, the port's p_i ((ns, nb, wq, bq, [qg,] wo, bo)), JAX's p_i (qg
    always, ones without rms) and float (k, v) per context, k RMS-normed
    per head when rms (the cache's k carries the norm)."""
    r = np.random.default_rng(seed)
    x = _arr(r, B, L, C)
    groups = []
    for lk in lks:
        ns, nb = 1.0 + _arr(r, C, scale=0.1), _arr(r, C, scale=0.1)
        wq, bq = _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05)
        qg = _gamma(r) if rms else np.ones(C, np.float32)
        wo, bo = _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05)
        k, v = _arr(r, B, lk, C, scale=0.5), _arr(r, B, lk, C, scale=0.5)
        if rms:
            kh = k.reshape(B, lk, heads, -1)
            k = (kh / np.sqrt((kh ** 2).sum(-1, keepdims=True) + 1e-12)
                 * np.sqrt(C // heads)).reshape(B, lk, C).astype(np.float32)
        pp = (ns, nb, wq, bq, *((qg,) if rms else ()), wo, bo)
        groups.append((pp, (ns, nb, wq, bq, qg, wo, bo), (k, v)))
    return x, groups


def _q8(kv, heads):
    kq, ks = pt.quantize_kv(torch.from_numpy(kv[0]), heads)
    vq, vs = pt.quantize_kv(torch.from_numpy(kv[1]), heads)
    return kq, vq, ks.transpose(1, 2).contiguous(), vs


def _jax_q8(kv8):
    kq, vq, ks_t, vs = kv8
    return (jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
            jnp.asarray(ks_t.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(vs.float().numpy()).astype(jnp.bfloat16))


def _cross_run(x, groups, dt, rms, heads, quant=False):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dt]
    jargs, targs = [jnp.asarray(x).astype(jdt)], [torch.from_numpy(x).to(dt)]
    for pp, jp, kv in groups:
        targs.append(tuple(torch.from_numpy(a).to(dt) for a in pp))
        jargs.append(tuple(jnp.asarray(a).astype(jdt) for a in jp))
        if quant:
            kv8 = _q8(kv, heads)
            targs.append(kv8)
            jargs.append(_jax_q8(kv8))
        else:
            targs.append(tuple(torch.from_numpy(a).to(dt) for a in kv))
            jargs.append(tuple(jnp.asarray(a).astype(jdt) for a in kv))
    with torch.no_grad():
        got = pt.fused_cross_sublayer(*targs, num_heads=heads, rms=rms,
                                      compute_dtype=dt, quant=quant)
    want = fs.fused_cross_sublayer(*jargs, num_heads=heads, rms=rms,
                                   compute_dtype=jdt, quant=quant,
                                   interpret=True)
    return got, want, jargs


@pytest.mark.parametrize("rms,heads", CROSS_FORMS)
def test_cross_forms_match_jax_kernel(rms, heads):
    x, groups = _cross_case(3, rms, heads)
    got, want, jargs = _cross_run(x, groups, torch.float32, rms, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    j_ref = fs.cross_sublayer_reference(*jargs, num_heads=heads, rms=rms,
                                        compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_ref), **TOL)
    if rms:  # the q norm is read
        targs = [torch.from_numpy(x)]
        for pp, _, kv in groups:
            targs += [tuple(map(torch.from_numpy, pp[:4] + pp[5:])),
                      tuple(map(torch.from_numpy, kv))]
        off = pt.fused_cross_sublayer(*targs, num_heads=heads,
                                      compute_dtype=torch.float32)
        assert _rel(_np(off) - x, _np(got) - x) > 1e-2


@pytest.mark.parametrize("rms,heads", CROSS_FORMS)
def test_cross_q8_forms_match_jax_kernel(rms, heads):
    x, groups = _cross_case(4, rms, heads)
    got, want, _ = _cross_run(x, groups, torch.float32, rms, heads,
                              quant=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_Q8)
    flt, _, _ = _cross_run(x, groups, torch.float32, rms, heads)
    assert 1e-5 < _rel(_np(got) - x, _np(flt) - x) < 2e-2  # the cache's drift


@pytest.mark.parametrize("rms,heads", [(True, 4), (True, 2)])
def test_cross_q8_forms_bf16(rms, heads):
    x, groups = _cross_case(5, rms, heads)
    got, want, _ = _cross_run(x, groups, torch.bfloat16, rms, heads,
                              quant=True)
    assert got.dtype == torch.bfloat16
    upd = _rel(_np(got) - x, _np(want) - x)
    assert upd <= REL_BF16, upd


def test_cross_params_need_the_q_gamma_with_rms():
    x, groups = _cross_case(6, False, 4)
    targs = [torch.from_numpy(x)]
    for pp, _, kv in groups:
        targs += [tuple(map(torch.from_numpy, pp)),
                  tuple(map(torch.from_numpy, kv))]
    with pytest.raises(ValueError):
        pt.fused_cross_sublayer(*targs, num_heads=4, rms=True,
                                compute_dtype=torch.float32)


@pytest.mark.parametrize("t_len", [24, 32])
def test_k6_heads_of_64_matches_jax_kernel(t_len):
    D, H = 64, 2
    r = np.random.default_rng(7)
    q, k, v, g = (r.standard_normal((2, t_len, 16, H, D)).astype(np.float32)
                  for _ in range(4))
    jo, vjp = jax.vjp(
        lambda q, k, v: jfa.temporal_attention(q, k, v, D ** -0.5,
                                               jnp.bfloat16, True),
        *(jnp.asarray(a) for a in (q, k, v)))
    jg = vjp(jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    po = pfa.temporal_attention(*ts, D ** -0.5)
    po.backward(torch.from_numpy(g))
    assert po.dtype == torch.float32 and po.shape == (2, t_len, 16, H, D)
    assert _rel(po.detach(), jo) <= 2e-4, _rel(po.detach(), jo)
    for a, b in zip((t.grad for t in ts), jg):
        assert _rel(a, b) <= 1e-5, _rel(a, b)
    assert pfa.temporal_supports(q.shape) == jfa.temporal_supports(q.shape)
