"""Port parity: the four fused DiT sublayers (gvfdiffusion_torch/ops/
fused_sublayer.py) against the JAX package's Pallas kernels in interpret
mode and against its `*_reference` functions, at fp32 on the CPU.

Tolerance: 2e-4 abs / rel, the JAX suite's own (tests/test_fused_sublayer.py).
In bf16 each plain version is also held against the JAX reference: mean
|diff| < 1e-4, max |diff| <= 2^-5 (one bf16 ulp at |y| ~ 4-8).
The configurations covered are the port's: the DiT's (heads of 32, q/k RMS
norms on self and temporal, none on cross, two cross contexts) and the
SLat torso's single-context cross sublayer (heads of 64, no RMS norm).
The CUDA kernels are checked against the plain versions on the card by
tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import fused_sublayer as pt
from gvfdiffusion_tpu.ops import fused_sublayer as fs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker while this module runs (the
    suite runs several workers at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = dict(rtol=2e-4, atol=2e-4)
C, H = 128, 4  # head width 32, as the DiT


def _rng(seed):
    return np.random.default_rng(seed)


def _arr(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _gamma(r):
    return (np.abs(_arr(r, C, scale=0.3)) + 1.0).astype(np.float32)


def _self_weights(r):
    return (_arr(r, C, 3 * C, scale=0.05), _arr(r, 3 * C, scale=0.05),
            _gamma(r), _gamma(r), _arr(r, C, C, scale=0.05),
            _arr(r, C, scale=0.05))


def _mods(r, rows):
    return (_arr(r, rows, C, scale=0.2), _arr(r, rows, C, scale=0.2),
            _arr(r, rows, C, scale=0.5))


def _to_jax(args):
    return jax.tree.map(jnp.asarray, args)


def _to_torch(args):
    return jax.tree.map(torch.from_numpy, args)


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mod_repeat", [1, 2])
def test_self_sublayer(mod_repeat):
    r = _rng(0)
    B, L = 4, 128
    x = _arr(r, B, L, C)
    args = (x, *_mods(r, B // mod_repeat), *_self_weights(r))
    jax_kernel = fs.fused_self_sublayer(
        *_to_jax(args), num_heads=H, rms=True, compute_dtype=jnp.float32,
        mod_repeat=mod_repeat, interpret=True)
    rep = lambda a: np.repeat(a, mod_repeat, axis=0)
    jax_ref = fs.self_sublayer_reference(
        jnp.asarray(x), *[jnp.asarray(rep(a)) for a in args[1:4]],
        *_to_jax(args[4:]), num_heads=H, rms=True, compute_dtype=jnp.float32)
    with torch.no_grad():
        port = pt.fused_self_sublayer(*_to_torch(args), num_heads=H,
                                      compute_dtype=torch.float32,
                                      mod_repeat=mod_repeat)
    _close(port, jax_kernel)
    _close(port, jax_ref)


@pytest.mark.parametrize("T", [8, 4])
def test_temporal_sublayer(T):
    r = _rng(1)
    B, N = 2, 32
    args = (_arr(r, B, T, N, C), *_mods(r, B), *_self_weights(r))
    jax_kernel = fs.fused_temporal_sublayer(
        *_to_jax(args), num_heads=H, rms=True, compute_dtype=jnp.float32,
        interpret=True)
    jax_ref = fs.temporal_sublayer_reference(
        *_to_jax(args), num_heads=H, rms=True, compute_dtype=jnp.float32)
    with torch.no_grad():
        port = pt.fused_temporal_sublayer(*_to_torch(args), num_heads=H,
                                          compute_dtype=torch.float32)
    _close(port, jax_kernel)
    _close(port, jax_ref)


def _cross_group(r, B, lk):
    """The port's (ns, nb, wq, bq, wo, bo) and (k, v); the JAX kernel takes
    a q-norm gamma after bq too, which it ignores at rms=False."""
    p = (1.0 + _arr(r, C, scale=0.1), _arr(r, C, scale=0.1),
         _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05),
         _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05))
    kv = (_arr(r, B, lk, C), _arr(r, B, lk, C))
    return p, kv


def _jax_cross_args(x, groups, dtype=None):
    cast = (lambda a: jnp.asarray(a)) if dtype is None else (
        lambda a: jnp.asarray(a).astype(dtype))
    out = [cast(x)]
    for p, kv in groups:
        out += [tuple(cast(a) for a in (*p[:4], np.ones(C, np.float32),
                                        *p[4:])),
                tuple(cast(a) for a in kv)]
    return out


@pytest.mark.parametrize("lks", [(37, 20), (20, 37)])
def test_cross_sublayer(lks):
    """Key lengths 37 and 20 are not multiples of the TPU's 128-lane tile;
    image then static context, as the DiT chains them."""
    r = _rng(2)
    B, L = 2, 64
    x = _arr(r, B, L, C)
    groups = [_cross_group(r, B, lk) for lk in lks]
    jax_args = _jax_cross_args(x, groups)
    kw = dict(num_heads=H, rms=False, compute_dtype=jnp.float32)
    jax_kernel = fs.fused_cross_sublayer(*jax_args, **kw, interpret=True)
    jax_ref = fs.cross_sublayer_reference(*jax_args, **kw)
    t_args = [torch.from_numpy(x)] + [_to_torch(a) for g in groups for a in g]
    with torch.no_grad():
        port = pt.fused_cross_sublayer(*t_args, num_heads=H,
                                       compute_dtype=torch.float32)
    _close(port, jax_kernel)
    _close(port, jax_ref)


@pytest.mark.parametrize("lk", [37, 130])
def test_cross_sublayer_single_context(lk):
    """The SLat torso's form: one context, heads of 64 (C = 128, 2 heads),
    key lengths that are not multiples of 128."""
    r = _rng(6)
    B, L = 2, 128
    x = _arr(r, B, L, C)
    groups = [_cross_group(r, B, lk)]
    jax_args = _jax_cross_args(x, groups)
    kw = dict(num_heads=2, rms=False, compute_dtype=jnp.float32)
    jax_kernel = fs.fused_cross_sublayer(*jax_args, **kw, interpret=True)
    jax_ref = fs.cross_sublayer_reference(*jax_args, None, None, **kw)
    t_args = [torch.from_numpy(x)] + [_to_torch(a) for a in groups[0]]
    with torch.no_grad():
        port = pt.fused_cross_sublayer(*t_args, num_heads=2,
                                       compute_dtype=torch.float32)
    _close(port, jax_kernel)
    _close(port, jax_ref)


@pytest.mark.parametrize("mod_repeat", [1, 2])
def test_mlp_sublayer(mod_repeat):
    r = _rng(3)
    B, L, M = 4, 64, 256
    x = _arr(r, B, L, C)
    args = (x, *_mods(r, B // mod_repeat), _arr(r, C, M, scale=0.05),
            _arr(r, M, scale=0.05), _arr(r, M, C, scale=0.05),
            _arr(r, C, scale=0.05))
    jax_kernel = fs.fused_mlp_sublayer(*_to_jax(args),
                                       compute_dtype=jnp.float32,
                                       mod_repeat=mod_repeat, interpret=True)
    rep = lambda a: np.repeat(a, mod_repeat, axis=0)
    jax_ref = fs.mlp_sublayer_reference(
        jnp.asarray(x), *[jnp.asarray(rep(a)) for a in args[1:4]],
        *_to_jax(args[4:]), compute_dtype=jnp.float32)
    with torch.no_grad():
        port = pt.fused_mlp_sublayer(*_to_torch(args),
                                     compute_dtype=torch.float32,
                                     mod_repeat=mod_repeat)
    _close(port, jax_kernel)
    _close(port, jax_ref)


def _bf16_case(name, r):
    """(JAX reference output, port plain output), both in bf16."""
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).bfloat16()
    if name in ("cross", "cross_single"):
        B, L = 2, 64
        x = _arr(r, B, L, C)
        lks, heads = ((37, 20), H) if name == "cross" else ((37,), 2)
        groups = [_cross_group(r, B, lk) for lk in lks]
        jargs = _jax_cross_args(x, groups, jnp.bfloat16)
        if name == "cross_single":
            jargs += [None, None]
        want = fs.cross_sublayer_reference(*jargs, num_heads=heads,
                                           rms=False)
        got = pt.cross_sublayer_reference(
            tb(x), *[tuple(tb(a) for a in t) for g in groups for t in g],
            num_heads=heads)
        return want, got
    if name == "temporal":
        args = (_arr(r, 2, 8, 32, C), *_mods(r, 2), *_self_weights(r))
    elif name == "self":
        args = (_arr(r, 2, 128, C), *_mods(r, 2), *_self_weights(r))
    else:
        args = (_arr(r, 2, 64, C), *_mods(r, 2), _arr(r, C, 256, scale=0.05),
                _arr(r, 256, scale=0.05), _arr(r, 256, C, scale=0.05),
                _arr(r, C, scale=0.05))
    jfn = getattr(fs, f"{name}_sublayer_reference")
    pfn = getattr(pt, f"{name}_sublayer_reference")
    kw = {} if name == "mlp" else dict(num_heads=H)
    want = jfn(*[jb(a) for a in args], **kw,
               **({} if name == "mlp" else dict(rms=True)))
    got = pfn(*[tb(a) for a in args], **kw)
    return want, got


@pytest.mark.parametrize("name", ["self", "temporal", "cross", "mlp",
                                  "cross_single"])
def test_bf16_rounding_points_match_jax(name):
    """In bf16 each plain version rounds where the JAX reference rounds:
    the two agree far inside the distance between bf16 neighbours."""
    with torch.no_grad():
        want, got = _bf16_case(name, _rng(4))
    assert got.dtype == torch.bfloat16
    diff = np.abs(np.asarray(want, np.float32) - got.float().numpy())
    # one bf16 ulp of |y| ~ 4 is 2^-6; allow a rare one-ulp tie flip
    assert np.mean(diff) < 1e-4 and np.max(diff) <= 2 ** -5, (
        np.mean(diff), np.max(diff))


def test_cpu_tensors_take_the_plain_path():
    """A CPU tensor runs the plain version and never counts a launch;
    impl accepts only None and "plain"."""
    r = _rng(5)
    args = _to_torch((_arr(r, 2, 128, C), *_mods(r, 2), *_self_weights(r)))
    pt.reset_launch_counts()
    with torch.no_grad():
        a = pt.fused_self_sublayer(*args, num_heads=H,
                                   compute_dtype=torch.float32)
        b = pt.fused_self_sublayer(*args, num_heads=H,
                                   compute_dtype=torch.float32, impl="plain")
    assert torch.equal(a, b)
    assert all(v == 0 for v in pt.launch_counts.values())
    with pytest.raises(ValueError):
        pt.fused_self_sublayer(*args, num_heads=H, impl="triton")
