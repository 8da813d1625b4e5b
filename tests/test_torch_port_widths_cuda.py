"""K5, K6 and K7 (forward and backward) at every head width their dispatch
rules admit, on the card, against their plain torch versions, at small
and ragged shapes (chip_smoke.py's `[widths]` holds the new forms at full
width and drives main_latent and main_vae through them).

The kernels are built at heads of 32, 64 and 128; a head of another
multiple of 8 up to 128 is zero-padded to the next of those by its
wrapper (`ops/_widths.py`), so every width runs on a hand-written kernel
and none raises:
  * every width 8 .. 128 of K5 (bf16 and fp32 io, with a key bias that
    masks keys), of K6 (bf16 and fp32, q apart, k and v views of a qkv
    projection, T of 24 and 70) and of K7 under grad (bf16 and fp32, the
    residual forward, dkv and dq, scattered validity), each launch counted
    under the caller's width;
  * the new native instantiations, K5 at heads of 128 (the Hopper core
    with fp32 io, and its int8 path: `quant="qk"` and `"qk+av"`, 64-row
    query tiles) and K6 at heads of 128 (Q's fragments read per k-step,
    fp32 at 2 warps a CTA), around their tiles;
  * K5's padded forms, int8 at 16 and segments at 16;
  * a width no rule admits (12; 1032 for K7, whose wide kernels take
    every multiple of 8 up to 1024) raising.
Every test needs a CUDA device and skips without one; run them on the GPU
with

    python -m pytest tests/test_torch_port_widths_cuda.py -m cuda -q

Tolerances, rel L2 against the plain version, those the same kernels
take at their native widths: K5's float forms and int8 QK 1e-2
(ATTN_BOUND), int8 P V 2e-2 (QKAV_BOUND; tests/test_torch_port_forms_cuda
.py), K6 1e-2 (tests/test_torch_port_cuda.py's ATTN_BOUND), K7 fp32 1e-5
for o, dq, dk and dv (FLASH_BWD_BOUND), bf16 1e-2
(tests/test_torch_port_flash_bwd_forms_cuda.py's BF16_BOUND).
"""

import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import fused_attention as fa
from gvfdiffusion_torch.ops._widths import WIDTHS

pytestmark = pytest.mark.cuda

ATTN_BOUND = 1e-2
QKAV_BOUND = 2e-2
FLASH_BWD_BOUND = 1e-5
BF16_BOUND = 1e-2
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _t(r, *shape, dev, dt=torch.bfloat16):
    return torch.tensor(r.standard_normal(shape), dtype=dt, device=dev)


def _heads(D):
    """Heads that make H * D a multiple of 128 (the rules' lanes)."""
    return 128 // np.gcd(128, D)


def _bias(r, B, Lk, dev):
    b = torch.tensor(r.standard_normal((B, Lk)) * 0.5, dtype=torch.float32,
                     device=dev)
    b[:, Lk - Lk // 4:] = float("-inf")
    return b


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", WIDTHS)
def test_k5_every_width(dev, D, dt):
    """Self-attention from the views of one qkv projection with a key bias
    that masks a quarter of the keys, then a cross-attention (Lq != Lk)."""
    r = np.random.default_rng(D)
    H, dtype = _heads(D), DTYPES[dt]
    qkv = _t(r, 2, 200, 3, H, D, dev=dev, dt=dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    b = _bias(r, 2, 200, dev)
    kq = _t(r, 2, 130, H, D, dev=dev, dt=dtype)
    fa.reset_launch_counts()
    y = fa.fused_attention(q, k, v, D ** -0.5, kv_bias=b)
    yc = fa.fused_attention(kq, k, v, D ** -0.5, cross=True)
    torch.cuda.synchronize()
    assert {n: c for n, c in fa.launch_counts.items() if c} == {
        fa.launch_key(D, False, True): 1, fa.launch_key(D, True, False): 1}
    ref = fa.fused_attention(q, k, v, D ** -0.5, kv_bias=b, impl="plain")
    refc = fa.fused_attention(kq, k, v, D ** -0.5, impl="plain")
    for got, want in ((y, ref), (yc, refc)):
        assert got.dtype == dtype and got.shape == want.shape
        assert got.is_contiguous() and bool(torch.isfinite(got).all())
    errs = _rel(y, ref), _rel(yc, refc)
    print(f"K5 d{D} {dt} H={H}: rel_l2 self+bias {errs[0]:.3e}, cross "
          f"{errs[1]:.3e}")
    assert max(errs) <= ATTN_BOUND, errs


@pytest.mark.parametrize("quant", ["qk", "qk+av"])
@pytest.mark.parametrize("D,H,Lq,Lk,bias", [
    (16, 8, 200, 300, True), (128, 2, 64, 64, False),
    (128, 2, 200, 300, True), (128, 2, 1374, 1374, False)])
def test_k5_int8_new_widths(dev, quant, D, H, Lq, Lk, bias):
    """int8 QK and int8 P V at heads of 16 (padded to 32) and at heads of
    128 (the int8 core's new instantiation), Lk off the 128-key tile."""
    r = np.random.default_rng(3)
    q, k, v = (_t(r, 2, n, H, D, dev=dev) for n in (Lq, Lk, Lk))
    b = _bias(r, 2, Lk, dev) if bias else None
    kw = dict(kv_bias=b, quant=quant)
    fa.reset_launch_counts()
    y = fa.fused_attention(q, k, v, D ** -0.5, **kw)
    torch.cuda.synchronize()
    assert fa.launch_counts[fa.launch_key(D, False, False, quant=quant)] == 1
    ref = fa.fused_attention(q, k, v, D ** -0.5, **kw, impl="plain")
    assert bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"K5 {quant} d{D} {tuple(q.shape)} x {Lk}: rel_l2 {err:.3e}")
    assert err <= (QKAV_BOUND if quant == "qk+av" else ATTN_BOUND), err


@pytest.mark.parametrize("dt", list(DTYPES))
def test_k5_segments_at_16(dev, dt):
    r = np.random.default_rng(4)
    q, k, v = (_t(r, 2, 256, 8, 16, dev=dev, dt=DTYPES[dt])
               for _ in range(3))
    fa.reset_launch_counts()
    y = fa.fused_attention(q, k, v, 0.25, segment_size=32)
    torch.cuda.synchronize()
    assert fa.launch_counts["attention_seg_d16"] == 1
    ref = fa.fused_attention(q, k, v, 0.25, segment_size=32, impl="plain")
    err = _rel(y, ref)
    print(f"K5 seg 32 d16 {dt}: rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


@pytest.mark.parametrize("T", [24, 70])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", WIDTHS)
def test_k6_every_width(dev, D, dt, T):
    """q apart, k and v views of one [B, T, N, 3, H, D] projection; T = 70
    walks three key tiles (at heads of 128: Q's rows loaded again for each
    tile)."""
    r = np.random.default_rng(D + T)
    H, dtype = _heads(D), DTYPES[dt]
    qkv = _t(r, 2, T, 8, 3, H, D, dev=dev, dt=dtype)
    q = _t(r, 2, T, 8, H, D, dev=dev, dt=dtype)
    k, v = qkv[..., 1, :, :], qkv[..., 2, :, :]
    fa.reset_launch_counts()
    with torch.no_grad():
        y = fa.temporal_attention(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert {n: c for n, c in fa.launch_counts.items() if c} == {
        fa.temporal_launch_key(D): 1}
    ref = fa.temporal_attention(q, k, v, D ** -0.5, impl="plain")
    assert y.dtype == dtype and y.shape == q.shape and y.is_contiguous()
    err = _rel(y, ref)
    print(f"K6 d{D} {dt} T={T} H={H}: rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", WIDTHS)
def test_k7_every_width_under_grad(dev, D, dt):
    """K7's residual forward, dkv and dq through flash_attention under
    grad (q, k, v views of one projection; scattered validity, and a batch
    row with no valid key, where P = 1 / Lk-padded-to-512 on every key, as
    tests/test_torch_port_flash_bwd_forms_cuda.py holds it), against the
    plain forward and backward; each launch once, counted under the
    caller's width."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    dtype, H, L = DTYPES[dt], _heads(D), 1000
    g = torch.Generator(device=dev).manual_seed(D)
    qkv = torch.randn(2, L, 3, H, D, generator=g, device=dev).to(dtype)
    do = torch.randn(2, L, H, D, generator=g, device=dev).to(dtype)
    valid = torch.rand(2, L, generator=g, device=dev) < 0.3
    valid[1] = False
    out = {}
    for impl in (None, "plain"):
        leaf = qkv.detach().clone().requires_grad_(True)
        fl.reset_launch_counts()
        o = fl.flash_attention(leaf[:, :, 0], leaf[:, :, 1], leaf[:, :, 2],
                               valid, D ** -0.5, impl=impl)
        o.backward(do)
        torch.cuda.synchronize()
        counts = {n: c for n, c in fl.launch_counts.items() if c}
        assert counts == ({fl.grad_key(kind, dtype, D): 1
                           for kind in fl.GRAD_KINDS} if impl is None
                          else {}), counts
        out[impl] = (o.detach(), *leaf.grad.unbind(2))
    bound = FLASH_BWD_BOUND if dtype == torch.float32 else BF16_BOUND
    errs = {n: _rel(a, b) for n, a, b in zip(("o", "dq", "dk", "dv"),
                                             out[None], out["plain"])}
    print(f"K7 d{D} {dt} H={H}: " + ", ".join(f"{n} {e:.3e}"
                                              for n, e in errs.items()))
    assert out[None][0].shape == (2, L, H, D)
    assert all(bool(torch.isfinite(t).all()) for t in out[None])
    assert max(errs.values()) <= bound, errs


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", [24, 48, 96])
def test_k7_forward_padded_no_grad(dev, D, dt):
    """Without grad: the forward alone, padded, over 4097 keys."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    dtype, H = DTYPES[dt], _heads(D)
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(1, 4097, H, D, generator=g, device=dev).to(dtype)
               for _ in range(3))
    valid = torch.rand(1, 4097, generator=g, device=dev) < 0.2
    fl.reset_launch_counts()
    y = fl.flash_attention(q, k, v, valid, D ** -0.5)
    torch.cuda.synchronize()
    assert fl.launch_counts[fl.launch_key(dtype, D)] == 1
    ref = fl.flash_attention(q, k, v, valid, D ** -0.5, impl="plain")
    assert y.is_contiguous() and y.shape == q.shape
    err = _rel(y, ref)
    print(f"K7 forward d{D} {dt}: rel_l2 {err:.3e}")
    assert err <= (FLASH_BWD_BOUND if dtype == torch.float32
                   else BF16_BOUND), err


def test_unadmitted_widths_raise(dev):
    from gvfdiffusion_torch.ops import flash_attention as fl

    r = np.random.default_rng(6)
    q = _t(r, 1, 200, 2, 12, dev=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.fused_attention(q, q, q, 0.25)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.temporal_attention(*(_t(r, 1, 8, 4, 2, 12, dev=dev)
                                for _ in range(3)), 0.25)
    q = _t(r, 1, 200, 1, 1032, dev=dev)
    with pytest.raises(ValueError, match="heads of"):
        fl.flash_attention(q, q, q, torch.ones(1, 200, dtype=torch.bool,
                                               device=dev), 0.1)
