"""Port parity: K3's int8 form (gvfdiffusion_torch/ops/fused_sublayer.py
`quantize_kv`, `dequantize_kv`, `cross_sublayer_q8_reference`,
`fused_cross_sublayer(quant=True)`) against the JAX package on the CPU:
`quantize_kv` bit for bit, the plain int8 sublayer against the JAX Pallas
kernel `fused_cross_sublayer(quant=True)` in interpret mode at both of its
q-scale domains (a whole cell of L rows, and halves: `lq_block`), both
against the dequantized oracle `cross_sublayer_reference(quant=True)`, and
a 2-block DiT on a hoisted int8 cache (GVF_KV_QUANT=int8, interpret mode)
against the port's `kv_cache(kv_quant="int8")`.

Tolerances: the int8 values and bf16 scales of quantize_kv equal JAX's;
fp32 plain vs the JAX kernel 2e-4 abs / rel (the fp32 sublayers' bound,
tests/test_torch_port_sublayers.py); bf16 rel L2 of the update y - x
<= 5e-3 (readings 1.4e-3 and 6.5e-4: the two round P and the dequantized
V at the same points, and y to bf16, where a one-ulp flip of y is large
against the update); against the oracle rel L2 < 1e-2 and against the
float path < 2e-2, the JAX suite's quantization bounds
(tests/test_fused_sublayer.py:187-225); the DiT rel L2 <= 5e-4 (reading
1.2e-4: its cache agrees to ~1e-6 before quantization, so a value near a
rounding tie may land one int8 step apart).
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

TOL = dict(rtol=2e-4, atol=2e-4)
REL_BF16 = 5e-3
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


@pytest.mark.parametrize("heads", [4, 2])
def test_quantize_kv_is_bit_equal(heads):
    r = np.random.default_rng(0)
    k = _arr(r, 3, 37, C, scale=0.7)
    k[0, 5] = 0.0  # a zero row: the 1e-8 floor
    jq, js = fs.quantize_kv(jnp.asarray(k), heads)
    pq, ps = pt.quantize_kv(torch.from_numpy(k), heads)
    assert pq.dtype == torch.int8 and ps.dtype == torch.bfloat16
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    back = pt.dequantize_kv(pq, ps)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(fs.dequantize_kv(jq, js)))


def _group(r, B, lk):
    """The port's (ns, nb, wq, bq, wo, bo) and the int8 cache (k, v, ks_t,
    vs) quantized by both packages (the same values, by the test above)."""
    p = (1.0 + _arr(r, C, scale=0.1), _arr(r, C, scale=0.1),
         _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05),
         _arr(r, C, C, scale=0.05), _arr(r, C, scale=0.05))
    k, v = _arr(r, B, lk, C, scale=0.5), _arr(r, B, lk, C, scale=0.5)
    kq, ks = pt.quantize_kv(torch.from_numpy(k), H)
    vq, vs = pt.quantize_kv(torch.from_numpy(v), H)
    return p, (kq, vq, ks.transpose(1, 2).contiguous(), vs), (k, v)


def _jax_group(p, kv8, dtype):
    cast = lambda a: jnp.asarray(a).astype(dtype)
    jp = tuple(cast(a) for a in (*p[:4], np.ones(C, np.float32), *p[4:]))
    kq, vq, ks_t, vs = kv8
    jkv = (jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
           jnp.asarray(ks_t.float().numpy()).astype(jnp.bfloat16),
           jnp.asarray(vs.float().numpy()).astype(jnp.bfloat16))
    return jp, jkv


def _case(n_ctx, lk, seed, B=2, L=64):
    r = np.random.default_rng(seed)
    x = _arr(r, B, L, C)
    groups = [_group(r, B, l) for l in ((lk, 20) if n_ctx == 2 else (lk,))]
    return x, groups


@pytest.mark.parametrize("q_block", [0, 32])
@pytest.mark.parametrize("lk", [37, 130])
@pytest.mark.parametrize("n_ctx", [1, 2])
def test_int8_cross_sublayer_matches_jax_kernel(n_ctx, lk, q_block):
    """fp32 compute: the plain int8 arithmetic against the JAX kernel in
    interpret mode; q_block 32 = the JAX kernel's lq_block (two cells per
    batch row of 64); both within the quantization bounds of the
    dequantized oracle and of the float sublayer."""
    x, groups = _case(n_ctx, lk, seed=10 + lk + n_ctx)
    jargs = [jnp.asarray(x)]
    targs = [torch.from_numpy(x)]
    for p, kv8, _ in groups:
        jargs += list(_jax_group(p, kv8, jnp.float32))
        targs += [tuple(map(torch.from_numpy, p)), kv8]
    if n_ctx == 1:
        jargs += [None, None]
    kw = dict(num_heads=H, rms=False, compute_dtype=jnp.float32)
    want = fs.fused_cross_sublayer(*jargs, **kw, quant=True, interpret=True,
                                   lq_block=q_block)
    with torch.no_grad():
        got = pt.fused_cross_sublayer(*targs, num_heads=H,
                                      compute_dtype=torch.float32,
                                      quant=True, q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = pt.cross_sublayer_reference(*targs, num_heads=H,
                                         compute_dtype=torch.float32,
                                         quant=True)
    j_oracle = fs.cross_sublayer_reference(*jargs, **kw, quant=True)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(j_oracle), **TOL)
    assert _rel(got, oracle) < 1e-2, _rel(got, oracle)
    assert _rel(want, j_oracle) < 1e-2, _rel(want, j_oracle)
    fargs = [torch.from_numpy(x)]
    for p, _, kv in groups:
        fargs += [tuple(map(torch.from_numpy, p)),
                  tuple(map(torch.from_numpy, kv))]
    float_ref = pt.cross_sublayer_reference(*fargs, num_heads=H,
                                            compute_dtype=torch.float32)
    assert _rel(got, float_ref) < 2e-2, _rel(got, float_ref)


@pytest.mark.parametrize("q_block", [0, 32])
def test_int8_cross_sublayer_bf16_rounding_points(q_block):
    """bf16 compute: the plain int8 form against the JAX kernel in
    interpret mode (V dequantized in bf16, P rounded to bf16)."""
    x, groups = _case(2, 130, seed=20)
    jargs = [jnp.asarray(x).astype(jnp.bfloat16)]
    targs = [torch.from_numpy(x).bfloat16()]
    for p, kv8, _ in groups:
        jargs += list(_jax_group(p, kv8, jnp.bfloat16))
        targs += [tuple(torch.from_numpy(a).bfloat16() for a in p), kv8]
    want = fs.fused_cross_sublayer(*jargs, num_heads=H, rms=False,
                                   quant=True, interpret=True,
                                   lq_block=q_block)
    with torch.no_grad():
        got = pt.fused_cross_sublayer(*targs, num_heads=H, quant=True,
                                      q_block=q_block)
    assert got.dtype == torch.bfloat16
    upd, jupd = _np(got) - x, _np(want) - x
    assert _rel(upd, jupd) <= REL_BF16, _rel(upd, jupd)


def test_int8_cross_sublayer_plain_counts_nothing():
    x, groups = _case(2, 37, seed=21)
    targs = [torch.from_numpy(x)]
    for p, kv8, _ in groups:
        targs += [tuple(map(torch.from_numpy, p)), kv8]
    pt.reset_launch_counts()
    with torch.no_grad():
        a = pt.fused_cross_sublayer(*targs, num_heads=H, quant=True,
                                    compute_dtype=torch.float32)
        b = pt.fused_cross_sublayer(*targs, num_heads=H, quant=True,
                                    compute_dtype=torch.float32, impl="plain")
    assert torch.equal(a, b) and pt.launch_counts["cross_q8"] == 0
    with pytest.raises(ValueError):
        pt.fused_cross_sublayer(*targs, num_heads=H, quant=True, q_block=48)


# the DiT: 2 blocks, C = 128, 4 heads of 32, N = 128, T = 8, image tokens
# 20 x 64 (tests/test_torch_port_dit.py)
B, T, N, L, CI, BLOCKS = 1, 8, 128, 20, 64, 2
DIT_KW = dict(in_channels=16, model_channels=C, image_cond_channels=CI,
              num_blocks=BLOCKS, num_heads=H)


def test_dit_on_an_int8_cache_matches_jax(monkeypatch):
    monkeypatch.setenv("GVF_FUSED", "interpret")
    monkeypatch.setenv("GVF_KV_QUANT", "int8")
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
    model = JaxDiT(resolution=N, **DIT_KW)
    jargs = [jnp.asarray(a) for a in inp]
    jkv = model.apply(flax_params, *jargs, kv_only=True)
    jout = model.apply(flax_params, *jargs, cross_kv=jkv)
    targs = [torch.from_numpy(a) for a in inp]
    with torch.no_grad():
        pkv = port.eval().kv_cache(targs[2], targs[3], kv_quant="int8")
        pout = port(*targs[:2], positions=targs[4], cross_kv=pkv)
    for jblock, pblock in zip(jkv, pkv):
        for jctx, pctx in zip(jblock, pblock):
            assert len(pctx) == 4
            for ja, pa in zip(jctx, pctx):
                assert tuple(pa.shape) == tuple(ja.shape)
            jq, pq = np.asarray(jctx[0]), pctx[0].numpy()
            assert np.abs(jq.astype(int) - pq).max() <= 1
            assert np.mean(jq != pq) < 1e-3
            assert _rel(_np(pctx[2]), _np(jctx[2])) <= 1e-4
    err = _rel(pout, jout)
    assert float(np.abs(np.asarray(jout)).mean()) > 0.1
    assert err <= 5e-4, err


def test_kv_quant_rejects_unknown_values():
    with pytest.raises(ValueError):
        VideoTo4DConfig(kv_quant="fp8")
    with pytest.raises(ValueError):
        DiT(**DIT_KW).kv_cache(torch.zeros(B, T, L, CI),
                               torch.zeros(B, N, 14), kv_quant="int4")
    assert VideoTo4DConfig().kv_quant is None
