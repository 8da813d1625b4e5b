"""Port parity of the backward: the gradients of the fused sublayers K1-K4
(gvfdiffusion_torch/ops/fused_sublayer.py: their autograd Function, the
JAX custom_vjp's recomputation of the float oracle) and of K5 (its
`kv_bias` gradient and the `segment_size` mask) against `jax.vjp` through
the JAX package's custom_vjps (`_self_bwd`, `_temporal_bwd`, `_cross_bwd`,
`_mlp_bwd`, fused_attention's `_bwd`), the Pallas forwards in interpret
mode, on the same seeded inputs and cotangents; with `mod_repeat` (the
modulation's gradient summed over the rows that share it), K1's `seg` and
int8 QK (JAX differentiates the float oracle), and K3 on an int8 cache
(zero gradient for the cache, as JAX's). The recomputation's chunking over
batch rows is forced down to one row block at a time in one case each
(`_BWD_SCORES` monkeypatched) and must not move the gradients.

Tolerance: rel L2 1e-4 at fp32 compute for every gradient, the bound of
tests/test_fused_attention.py:35 and tests/test_fused_sublayer.py:107; the
readings are printed. tests/test_torch_port_dit_grad.py holds the DiT with
a hoisted cache under grad.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import fused_attention as pfa
from gvfdiffusion_torch.ops import fused_sublayer as pt
from gvfdiffusion_tpu.ops import fused_attention as jfa
from gvfdiffusion_tpu.ops import fused_sublayer as fs

REL = 1e-4
C, H = 128, 4


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


def _vjp(fn, args, g):
    """JAX's vjp of fn at args (numpy leaves, a pytree) against g: jitted,
    blocked on (the interpret-mode forward)."""
    def run(args, g):
        _, vjp = jax.vjp(fn, *args)
        return vjp(g)
    out = jax.block_until_ready(jax.jit(run)(args, g))
    # an int8 input's cotangent is float0: no gradient, read as 0
    return [np.zeros(a.shape, np.float32) if a.dtype == jax.dtypes.float0
            else np.asarray(a, np.float32) for a in jax.tree.leaves(out)]


def _grads(fn, args, g):
    """The port's gradients of fn at args (numpy leaves) against g, in
    jax.tree.leaves order; a leaf with no gradient reads 0."""
    leaves, tree = jax.tree.flatten(args)
    ts = [torch.from_numpy(a.copy()) for a in leaves]
    for t in ts:
        if t.is_floating_point():
            t.requires_grad_(True)
    y = fn(*jax.tree.unflatten(tree, ts))
    want = [t for t in ts if t.requires_grad]
    gs = torch.autograd.grad(y, want, torch.from_numpy(g), allow_unused=True)
    out, it = [], iter(gs)
    for t in ts:
        gr = next(it) if t.requires_grad else None
        out.append(np.zeros(t.shape, np.float32) if gr is None
                   else gr.numpy())
    return out


def _check(what, got, want):
    errs = [_rel(a, b) for a, b in zip(got, want)]
    print(f"{what}: worst gradient rel L2 {max(errs):.2e}")
    assert len(got) == len(want)
    for a, b, e in zip(got, want, errs):
        assert a.shape == b.shape
        assert e <= REL or (not np.abs(b).any() and not np.abs(a).any()), e


def _self_args(seed, B, L, rows):
    r = np.random.default_rng(seed)
    gam = lambda: (np.abs(_arr(r, C, scale=0.3)) + 1.0).astype(np.float32)
    return (_arr(r, B, *L, C), _arr(r, rows, C, scale=0.2),
            _arr(r, rows, C, scale=0.2), _arr(r, rows, C, scale=0.5),
            _arr(r, C, 3 * C, scale=0.05), _arr(r, 3 * C, scale=0.05), gam(),
            gam(), _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05))


@pytest.mark.parametrize("seg,mod_repeat,quant_qk,chunked",
                         [(0, 2, False, False), (0, 2, False, True),
                          (16, 2, False, False), (4, 1, True, False)])
def test_self_sublayer_gradients_match_jax(seg, mod_repeat, quant_qk,
                                           chunked, monkeypatch):
    if chunked:  # one frame's scores a chunk: 4 chunks of 2 frames
        monkeypatch.setattr(pt, "_BWD_SCORES", H * 64 * 64)
    args = _self_args(1, 4, (64,), 4 // mod_repeat)
    kw = dict(num_heads=H, seg=seg, mod_repeat=mod_repeat, quant_qk=quant_qk)
    g = _arr(np.random.default_rng(2), 4, 64, C)
    want = _vjp(functools.partial(fs.fused_self_sublayer, rms=True,
                                  compute_dtype=jnp.float32, interpret=True,
                                  **kw), args, g)
    got = _grads(functools.partial(pt.fused_self_sublayer,
                                   compute_dtype=torch.float32, **kw),
                 args, g)
    _check(f"K1 seg={seg} mod_repeat={mod_repeat} quant_qk={quant_qk} "
           f"chunked={chunked}", got, want)


@pytest.mark.parametrize("quant_qk", [False, True])
def test_temporal_sublayer_gradients_match_jax(quant_qk):
    args = _self_args(3, 2, (8, 16), 2)
    g = _arr(np.random.default_rng(4), 2, 8, 16, C)
    kw = dict(num_heads=H, quant_qk=quant_qk)
    want = _vjp(functools.partial(fs.fused_temporal_sublayer, rms=True,
                                  compute_dtype=jnp.float32, interpret=True,
                                  **kw), args, g)
    got = _grads(functools.partial(pt.fused_temporal_sublayer,
                                   compute_dtype=torch.float32, **kw),
                 args, g)
    _check(f"K2 quant_qk={quant_qk}", got, want)


def _cross_ctx(r, B, lk, rms):
    gam = (np.abs(_arr(r, C, scale=0.3)) + 1.0).astype(np.float32)
    p = (1.0 + _arr(r, C, scale=0.1), _arr(r, C, scale=0.1),
         _arr(r, C, C, scale=0.09), _arr(r, C, scale=0.1), gam,
         _arr(r, C, C, scale=0.09), _arr(r, C, scale=0.1))
    return p, (_arr(r, B, lk, C), _arr(r, B, lk, C))


def _int8(kv):
    kq, ks = pt.quantize_kv(torch.from_numpy(kv[0]), H)
    vq, vs = pt.quantize_kv(torch.from_numpy(kv[1]), H)
    return (kq.numpy(), vq.numpy(),
            ks.transpose(1, 2).float().numpy().copy(), vs.float().numpy())


@pytest.mark.parametrize("ctxs,rms,quant,chunked",
                         [(2, True, False, False), (2, False, False, True),
                          (1, True, False, False), (2, True, True, False),
                          (1, False, True, False)])
def test_cross_sublayer_gradients_match_jax(ctxs, rms, quant, chunked,
                                            monkeypatch):
    """Two contexts (the DiT) or one (the SLat torso); an int8 cache gets
    zero gradient and x and the parameters the float oracle's through the
    dequantized cache."""
    if chunked:  # one batch row a chunk
        monkeypatch.setattr(pt, "_BWD_SCORES", H * 64 * (37 + 20))
    r = np.random.default_rng(5)
    x = _arr(r, 3, 64, C)
    groups = [_cross_ctx(r, 3, lk, rms) for lk in (37, 20)[:ctxs]]
    if quant:
        groups = [(p, _int8(kv)) for p, kv in groups]
    if not rms:  # the port's 6-tuple; JAX reads a gamma it ignores
        tp = [(p[:4] + p[5:], kv) for p, kv in groups]
    else:
        tp = groups
    g = _arr(r, 3, 64, C)

    def jfn(x, *flat):
        return fs.fused_cross_sublayer(
            x, *flat, num_heads=H, rms=rms, compute_dtype=jnp.float32,
            quant=quant, interpret=True)

    jargs = [x, *[a for p, kv in groups for a in (p, kv)]]
    if quant:  # the int8 cache's dtypes, as quantize_kv makes them
        jargs = [jax.tree.map(lambda a: jnp.asarray(a).astype(
            jnp.int8 if a.dtype == np.int8 else jnp.bfloat16), a)
            if i % 2 == 0 and i else a for i, a in enumerate(jargs)]
    want = _vjp(jfn, jargs, g)

    def tfn(x, *flat):
        if quant:
            flat = [tuple(a if a.dtype == torch.int8 else a.bfloat16()
                          for a in t) if i % 2 else t
                    for i, t in enumerate(flat)]
        return pt.fused_cross_sublayer(x, *flat, num_heads=H, rms=rms,
                                       compute_dtype=torch.float32,
                                       quant=quant)

    got = _grads(tfn, [x, *[a for p, kv in tp for a in (p, kv)]], g)
    if not rms:  # drop JAX's unread gammas
        skip = {1 + 4 + i * 9 for i in range(ctxs)}
        want = [w for i, w in enumerate(want) if i not in skip]
    if quant:
        got = [np.asarray(a, np.float32) for a in got]
    _check(f"K3 contexts={ctxs} rms={rms} quant={quant} chunked={chunked}",
           got, want)


def test_mlp_sublayer_gradients_match_jax():
    r = np.random.default_rng(6)
    args = (_arr(r, 4, 64, C), _arr(r, 2, C, scale=0.2),
            _arr(r, 2, C, scale=0.2), _arr(r, 2, C, scale=0.5),
            _arr(r, C, 256, scale=0.09), _arr(r, 256, scale=0.1),
            _arr(r, 256, C, scale=0.06), _arr(r, C, scale=0.1))
    g = _arr(r, 4, 64, C)
    want = _vjp(functools.partial(fs.fused_mlp_sublayer,
                                  compute_dtype=jnp.float32, mod_repeat=2,
                                  interpret=True), args, g)
    got = _grads(functools.partial(pt.fused_mlp_sublayer,
                                   compute_dtype=torch.float32, mod_repeat=2),
                 args, g)
    _check("K4 mod_repeat=2", got, want)


@pytest.mark.parametrize("D,seg,quant,chunked",
                         [(32, 0, "", False), (64, 32, "", False),
                          (32, 24, "", True), (64, 0, "qk", False),
                          (32, 32, "qk+av", False)])
def test_k5_gradients_match_jax(D, seg, quant, chunked, monkeypatch):
    """q, k, v and the key bias, with segments; the int8 forms
    differentiate as the float one (JAX's _bwd ignores quant)."""
    if chunked:
        monkeypatch.setattr(pfa, "_BWD_SCORES", 2 * 192 * 192)
    r = np.random.default_rng(7)
    q, k, v = (_arr(r, 3, 192, 2, D) for _ in range(3))
    bias = _arr(r, 3, 192)
    g = _arr(r, 3, 192, 2, D)
    scale = D ** -0.5
    want = _vjp(lambda q, k, v, b: jfa.fused_attention(
        q, k, v, scale, jnp.float32, interpret=True, segment_size=seg,
        kv_bias=b, quant=quant), (q, k, v, bias), g)
    got = _grads(lambda q, k, v, b: pfa.fused_attention(
        q, k, v, scale, torch.float32, kv_bias=b, segment_size=seg,
        quant=quant), (q, k, v, bias), g)
    _check(f"K5 D={D} seg={seg} quant={quant!r} chunked={chunked}", got,
           want)
