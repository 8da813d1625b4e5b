"""K5 parity: the port's plain attention (ops/fused_attention.py) against
the JAX package's Pallas kernel `fused_attention`, run in interpret mode on
the CPU, at heads of 64 and ragged lengths (173 and 130 are not multiples
of the kernels' row tiles): self-attention (DINOv2, the sparse-structure
flow), cross-attention with Lq != Lk (the sparse-structure flow's image
tokens) and a per-key `kv_bias` with -inf on masked keys (the SLat
torso), one batch row of it fully masked. Inputs are numpy draws from a
seed handed to both.

Tolerances, each with its reason:
  * fp32 compute: atol = rtol = 2e-5, the bound of
    tests/test_fused_attention.py:24 (the same function; JAX takes exp2 of
    a fixed shift, the port exp of a running maximum);
  * bf16 compute: rel L2 <= 5e-3. Both round q/k/v and P to bf16 at the
    same points, but the two rounded P differ in scale (JAX shifts the
    log2 logits by 30, the port by the row maximum), so their bf16
    rounding errors differ: the readings are 1.7e-3 with fp32 inputs and
    2.8e-3 with bf16 inputs, whose bf16 output adds its own rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import fused_attention as pfa
from gvfdiffusion_tpu.ops.fused_attention import fused_attention as j_attention


def _qkv(seed, B, L, H, D=64, scale=1.0):
    r = np.random.default_rng(seed)
    return [(r.standard_normal((B, L, H, D)) * scale).astype(np.float32)
            for _ in range(3)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax(q, k, v, compute_dtype, in_dtype=jnp.float32, kv_bias=None):
    out = j_attention(*(jnp.asarray(a, in_dtype) for a in (q, k, v)),
                      q.shape[-1] ** -0.5, compute_dtype=compute_dtype,
                      interpret=True, kv_bias=None if kv_bias is None
                      else jnp.asarray(kv_bias))
    return np.asarray(out.astype(jnp.float32))


def _bias(B, Lk, seed):
    """[B, Lk] fp32: 0 on valid keys and -inf on masked ones; row 0 keeps
    101 keys (not a multiple of the 64-key tile), row 1 keeps none, the
    rest a random half with a small finite bias."""
    r = np.random.default_rng(seed)
    bias = np.where(r.uniform(size=(B, Lk)) < 0.5, 0.0, -np.inf)
    bias += np.where(np.isfinite(bias), r.normal(0, 0.5, (B, Lk)), 0.0)
    bias[0] = -np.inf
    bias[0, r.choice(Lk, 101, replace=False)] = 0.0
    bias[1] = -np.inf
    return bias.astype(np.float32)


@pytest.mark.parametrize("L", [173, 130])
def test_plain_matches_jax_fp32(L):
    q, k, v = _qkv(0, 2, L, 2, scale=2.0)  # scaled logits of several units
    want = _jax(q, k, v, jnp.float32)
    got = pfa.attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), 64 ** -0.5,
        compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, L, 2, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [173, 130])
def test_plain_matches_jax_bf16_compute(L, in_dtype):
    q, k, v = _qkv(1, 2, L, 2, scale=2.0)
    want = _jax(q, k, v, jnp.bfloat16, getattr(jnp, in_dtype))
    tin = getattr(torch, in_dtype)
    got = pfa.attention_reference(
        *(torch.from_numpy(a).to(tin) for a in (q, k, v)), 64 ** -0.5,
        compute_dtype=torch.bfloat16)
    assert got.dtype == tin
    err = _rel(got.float().numpy(), want)
    print(f"L={L} {in_dtype}: rel L2 {err:.3e}")
    assert err <= 5e-3, err


@pytest.mark.parametrize("Lq,Lk", [(173, 130), (130, 1374)])
def test_cross_form_matches_jax(Lq, Lk):
    r = np.random.default_rng(3)
    q = (r.standard_normal((2, Lq, 2, 64)) * 2).astype(np.float32)
    k, v = ((r.standard_normal((2, Lk, 2, 64)) * 2).astype(np.float32)
            for _ in range(2))
    want = _jax(q, k, v, jnp.float32)
    got = pfa.attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), 64 ** -0.5,
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    want16 = _jax(q, k, v, jnp.bfloat16)
    got16 = pfa.attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), 64 ** -0.5)
    assert _rel(got16.numpy(), want16) <= 5e-3


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_kv_bias_form_matches_jax(compute):
    """A fully masked row gives 0 in both, never NaN."""
    q, k, v = _qkv(4, 3, 173, 2, scale=2.0)
    bias = _bias(3, 173, 5)
    want = _jax(q, k, v, getattr(jnp, compute), kv_bias=bias)
    got = pfa.fused_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), 64 ** -0.5,
        getattr(torch, compute), kv_bias=torch.from_numpy(bias)).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert not got[1].any() and not want[1].any()
    if compute == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        assert _rel(got, want) <= 5e-3


def test_dispatch_rule_matches_jax():
    from gvfdiffusion_tpu.ops.fused_attention import supports as j_supports

    for q, k in [((1, 512, 16, 64), (1, 512, 16, 64)),
                 ((1, 512, 16, 64), (1, 1374, 16, 64)),
                 ((1, 4096, 16, 64), (1, 4096, 16, 64)),
                 ((1, 4096, 16, 64), (1, 16384, 16, 64)),
                 ((1, 100, 2, 64), (1, 20, 2, 64)),
                 ((2, 130, 1, 64), (2, 130, 1, 64))]:
        assert pfa.supports(q, k) == j_supports(q, k), (q, k)


def test_strided_qkv_views_and_cpu_dispatch():
    """The q/k/v views of a [B, L, 3, H, D] projection give what contiguous
    tensors give; a CPU tensor takes the plain path and counts no launch."""
    r = np.random.default_rng(2)
    qkv = torch.from_numpy(r.standard_normal((2, 37, 3, 2, 64)).astype(
        np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    pfa.reset_launch_counts()
    got = pfa.fused_attention(q, k, v, 0.125, torch.float32)
    want = pfa.attention_reference(q.contiguous(), k.contiguous(),
                                   v.contiguous(), 0.125, torch.float32)
    assert torch.equal(got, want)
    assert set(pfa.launch_counts) >= {"attention", "attention_cross",
                                      "attention_bias"}
    assert not any(pfa.launch_counts.values())
    with pytest.raises(ValueError):
        pfa.fused_attention(q, k, v, 0.125, impl="kernel")
