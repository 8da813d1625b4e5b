"""Port parity: the int8-QK forms of the DiT's self and temporal sublayers
(gvfdiffusion_torch/ops/fused_sublayer.py `self_sublayer_qk8_reference`,
`temporal_sublayer_qk8_reference`, `fused_*_sublayer(quant_qk=True)`)
against the JAX package's Pallas kernels in interpret mode
(`fused_*_sublayer(..., interpret=True, quant_qk=True)`), and a 2-block
DiT with `self_quant="int8"` on a hoisted int8 cache against JAX at
GVF_FUSED=interpret, GVF_SELF_QUANT=int8, GVF_KV_QUANT=int8.

Tolerances: fp32 plain vs the JAX kernel 5e-4 abs / rel (a q or k value
near a rounding half step can land one int8 step apart when the fp32 qkv
product, summed in another order, differs in its last bit); bf16 rel L2
of the update y - x <= 1e-2 (both round P, V and y to bf16 at the same
points, and a flipped int8 step moves a score by ~1/127 of its scale);
the DiT rel L2 <= 2e-3 (reading 5.6e-4: a flipped int8 step in one
block moves the next block's input; the int8-cache DiT alone reads
1.2e-4, tests/test_torch_port_int8.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.ops import fused_sublayer as pt
from gvfdiffusion_torch.pipelines.video_to_4d import VideoTo4DConfig
from gvfdiffusion_torch.utils.weights import (dit_state_dict_from_flax,
                                              init_random_)
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT
from gvfdiffusion_tpu.ops import fused_sublayer as fs
from gvfdiffusion_tpu.utils.weight_convert import convert_dit

TOL = dict(rtol=5e-4, atol=5e-4)
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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _arr(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


def _args(seed, xshape, rows):
    r = np.random.default_rng(seed)
    gam = lambda: (np.abs(_arr(r, C, scale=0.3)) + 1.0).astype(np.float32)
    x = _arr(r, *xshape)
    return [x, _arr(r, rows, C, scale=0.2), _arr(r, rows, C, scale=0.2),
            _arr(r, rows, C, scale=0.5), _arr(r, C, 3 * C, scale=0.05),
            _arr(r, 3 * C, scale=0.05), gam(), gam(),
            _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05)]


def _run(kind, args, dt, **kw):
    port_fn = {"self": pt.fused_self_sublayer,
               "temporal": pt.fused_temporal_sublayer}[kind]
    jax_fn = {"self": fs.fused_self_sublayer,
              "temporal": fs.fused_temporal_sublayer}[kind]
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dt]
    got = port_fn(*(torch.from_numpy(a).to(dt) for a in args), num_heads=H,
                  compute_dtype=dt, quant_qk=True, **kw)
    want = jax_fn(*(jnp.asarray(a).astype(jdt) for a in args), num_heads=H,
                  rms=True, compute_dtype=jdt, interpret=True, quant_qk=True,
                  **kw)
    return got, want


@pytest.mark.parametrize("mod_repeat", [1, 2])
def test_self_qk8_matches_jax_kernel_fp32(mod_repeat):
    B, L = 4, 64
    args = _args(0, (B, L, C), B // mod_repeat)
    got, want = _run("self", args, torch.float32, mod_repeat=mod_repeat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and it is not the float sublayer
    flt = pt.self_sublayer_reference(
        *(torch.from_numpy(a) for a in args[:1]),
        *(torch.from_numpy(a).repeat_interleave(mod_repeat, 0)
          for a in args[1:4]),
        *(torch.from_numpy(a) for a in args[4:]), num_heads=H,
        compute_dtype=torch.float32)
    assert 1e-5 < _rel(got - torch.from_numpy(args[0]),
                       flt - torch.from_numpy(args[0])) < 2e-2


# N = 32: the JAX cell is 16 voxels; N = 24: it halves to 8
@pytest.mark.parametrize("N", [32, 24])
def test_temporal_qk8_matches_jax_kernel_fp32(N):
    B, T = 2, 8
    nc = pt.temporal_voxel_group(N)
    assert nc == {32: 16, 24: 8}[N]
    args = _args(1, (B, T, N, C), B)
    got, want = _run("temporal", args, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # The LayerNorm and the RMS norms take the rows' magnitudes out, so a
    # scale taken per voxel (a group of 1) differs from the group's only
    # by the max over 16x fewer values: the update moves ~100x more than
    # the port's own difference from JAX (readings 5e-4 against 4e-6).
    per_voxel = pt.fused_temporal_sublayer(
        *(torch.from_numpy(a) for a in args), num_heads=H,
        compute_dtype=torch.float32, quant_qk=True, voxel_group=1)
    x = args[0]
    upd = _rel(got.numpy() - x, np.asarray(want) - x)
    assert upd <= 5e-5, upd
    assert _rel(per_voxel.numpy() - x, np.asarray(want) - x) > 2.5e-4


@pytest.mark.parametrize("kind", ["self", "temporal"])
def test_qk8_bf16_matches_jax_kernel(kind):
    if kind == "self":
        args = _args(2, (2, 64, C), 2)
    else:
        args = _args(3, (1, 8, 32, C), 1)
    got, want = _run(kind, args, torch.bfloat16)
    x = args[0]
    upd = _rel(_np(got) - x, _np(want) - x)
    assert got.dtype == torch.bfloat16
    assert upd <= REL_BF16, upd


def test_qk8_plain_counts_nothing_and_checks_the_group():
    args = [torch.from_numpy(a) for a in _args(4, (1, 4, 24, C), 1)]
    pt.reset_launch_counts()
    pt.fused_temporal_sublayer(*args, num_heads=H, quant_qk=True,
                               compute_dtype=torch.float32)
    pt.fused_self_sublayer(args[0][0], *args[1:], num_heads=H, quant_qk=True,
                           compute_dtype=torch.float32, mod_repeat=4)
    assert pt.launch_counts["self_q8"] == pt.launch_counts["temporal_q8"] == 0
    with pytest.raises(ValueError):
        pt.fused_temporal_sublayer(*args, num_heads=H, quant_qk=True,
                                   voxel_group=16)


# the DiT: 2 blocks, C = 128, 4 heads of 32, N = 128, T = 8, image tokens
# 20 x 64 (tests/test_torch_port_int8.py)
B, T, N, L, CI, BLOCKS = 1, 8, 128, 20, 64, 2
DIT_KW = dict(in_channels=16, model_channels=C, image_cond_channels=CI,
              num_blocks=BLOCKS, num_heads=H)


def _dit_pair():
    sd = {k: v.numpy().copy() for k, v in init_random_(
        DiT(**DIT_KW), 0).state_dict().items()}
    flax_params = convert_dit(sd, num_blocks=BLOCKS, qk_rms_norm=True)
    port = DiT(**DIT_KW)
    port.load_state_dict(dit_state_dict_from_flax(flax_params, BLOCKS))
    r = np.random.default_rng(1)
    inp = [r.standard_normal((B, T, N, 16)).astype(np.float32),
           np.array([437.5], np.float32),
           r.standard_normal((B, T, L, CI)).astype(np.float32),
           r.standard_normal((B, N, 14)).astype(np.float32),
           r.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)]
    return port.eval(), flax_params, inp


def test_dit_with_self_quant_matches_jax(monkeypatch):
    monkeypatch.setenv("GVF_FUSED", "interpret")
    monkeypatch.setenv("GVF_KV_QUANT", "int8")
    monkeypatch.setenv("GVF_SELF_QUANT", "int8")
    port, flax_params, inp = _dit_pair()
    # a fresh module: JAX reads GVF_SELF_QUANT while it traces
    model = JaxDiT(resolution=N, **DIT_KW)
    jargs = [jnp.asarray(a) for a in inp]
    jkv = model.apply(flax_params, *jargs, kv_only=True)
    jout = model.apply(flax_params, *jargs, cross_kv=jkv)
    targs = [torch.from_numpy(a) for a in inp]
    with torch.no_grad():
        pkv = port.kv_cache(targs[2], targs[3], kv_quant="int8")
        pout = port(*targs[:2], positions=targs[4], cross_kv=pkv,
                    self_quant="int8")
        pflt = port(*targs[:2], positions=targs[4], cross_kv=pkv)
    err = _rel(pout, jout)
    assert float(np.abs(np.asarray(jout)).mean()) > 0.1
    assert err <= 2e-3, err
    assert _rel(pout, pflt) > 2 * err  # int8 QK moved the output (2.9e-3)


def test_composed_path_ignores_self_quant():
    port, _, inp = _dit_pair()
    t = [torch.from_numpy(a) for a in inp]
    with torch.no_grad():
        a = port(t[0], t[1], t[2], t[3], t[4])
        b = port(t[0], t[1], t[2], t[3], t[4], self_quant="int8")
    assert torch.equal(a, b)


def test_self_quant_rejects_unknown_values():
    with pytest.raises(ValueError):
        VideoTo4DConfig(self_quant="fp8")
    port, _, inp = _dit_pair()
    t = [torch.from_numpy(a) for a in inp]
    with pytest.raises(ValueError):
        port(t[0], t[1], t[2], t[3], t[4], self_quant="int4")
    assert VideoTo4DConfig().self_quant is None
