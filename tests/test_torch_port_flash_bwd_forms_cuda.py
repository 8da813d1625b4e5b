"""K7's backward in every form of its forward, on the card: the bf16
kernels (csrc/flash_attention_bwd_bf16.cu) at heads of 32, 64 and 128 and
the fp32 kernels (csrc/flash_attention_bwd.cu, 3xTF32) at heads of 32 and
128, each with the forward's residual (the row logsumexp, in bf16 the core's
LSE instantiation), against the plain backward on the card; and the fp32
kernels at heads of 64, which kept their code, as before.

The kernels walk the forward's list of key tiles (bf16: 128 keys, 64 at
heads of 128; fp32: 64, 32 at heads of 128) in visits of 64 keys (dq in
fp32 at heads of 128: 32), so the cases are: query and key counts off the
tiles (Lq 33 / 130 / 1000 against Lk 130 / 1000 / 4097, Lq != Lk), prefix
and scattered validity, a tile whose only valid keys are the last of its
halves (the 64-key visits of a 128-key tile, the pairs of 32-key tiles), a
batch row with no valid key (every tile visited, P = 1 / Lk-padded-to-512)
beside a scattered one, and q, k and v the views of one projection. Every
test needs a CUDA device and skips without one; run them on the GPU with

    python -m pytest tests/test_torch_port_flash_bwd_forms_cuda.py -m cuda -q

Tolerance, rel L2 of o, dq, dk and dv against the plain backward
(`flash_attention_backward_reference` after `flash_attention_reference`):
fp32 FLASH_BWD_BOUND 1e-5, as at heads of 64 (both fp32 throughout, the
kernels' 3xTF32 products about fp32's precision); bf16 BF16_BOUND 1e-2
(both round P and dS to bf16 and each gradient once; where an fp32 P or dS
lies near a bf16 midpoint the two round it apart; readings 0 - 3.0e-3 on
an H100 80GB HBM3).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

FLASH_BWD_BOUND = 1e-5
BF16_BOUND = 1e-2
B = 2
# (dtype, head width, heads): every new form, and fp32 at heads of 64
FORMS = [(torch.bfloat16, 32, 3), (torch.bfloat16, 64, 2),
         (torch.bfloat16, 128, 1), (torch.float32, 32, 3),
         (torch.float32, 128, 1)]
IDS = [f"{'bf16' if dt == torch.bfloat16 else 'fp32'}-d{d}"
       for dt, d, _ in FORMS]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _inputs(dev, dtype, D, H, lq, lk, seed):
    """q/k/v as views of one [B, L, 3, H, D] projection where lq == lk
    (the VAE's self-attention), else q apart and k/v views of one [B, Lk,
    2, H, D]; dO contiguous; all in `dtype`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if lq == lk:
        qkv = torch.randn(B, lq, 3, H, D, generator=g, device=dev).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.randn(B, lq, H, D, generator=g, device=dev).to(dtype)
        kv = torch.randn(B, lk, 2, H, D, generator=g, device=dev).to(dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
    do = torch.randn(B, lq, H, D, generator=g, device=dev).to(dtype)
    return q, k, v, do, g


def _grads(q, k, v, valid, do, impl):
    """(o, dq, dk, dv) through the wrapper under grad; with the kernels,
    one launch of the form's residual forward, dkv and dq."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    if q._base is not None and q._base is k._base:  # views of one qkv
        base = q._base.detach().clone().requires_grad_(True)
        args = [base[:, :, i] for i in range(3)]
    else:
        args = [a.detach().clone().requires_grad_(True) for a in (q, k, v)]
    fl.reset_launch_counts()
    D = q.shape[-1]
    o = fl.flash_attention(*args, valid, D ** -0.5, impl=impl)
    o.backward(do)
    if impl is None:
        torch.cuda.synchronize()
        assert {n: c for n, c in fl.launch_counts.items() if c} == {
            fl.grad_key(kind, q.dtype, D): 1 for kind in fl.GRAD_KINDS}
    if q._base is not None and q._base is k._base:
        return (o.detach(), *(base.grad[:, :, i] for i in range(3)))
    return (o.detach(), *(a.grad for a in args))


def _check(q, k, v, valid, do, what):
    got = _grads(q, k, v, valid, do, None)
    want = _grads(q, k, v, valid, do, "plain")
    bound = FLASH_BWD_BOUND if q.dtype == torch.float32 else BF16_BOUND
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.dtype == q.dtype and a.shape == b.shape, (what, name)
        assert bool(torch.isfinite(a).all()), (what, name)
        err = _rel(a, b)
        print(f"flash bwd {what} {name}: rel_l2 {err:.3e}")
        assert err <= bound, (what, name, err)
    return got, want


def _validity(dev, kind, lk, g):
    valid = torch.zeros(B, lk, dtype=torch.bool, device=dev)
    if kind == "prefix":
        valid[0, :max(1, lk // 3)] = True
        valid[1, :max(1, lk - 5)] = True
    else:
        valid = torch.rand(B, lk, generator=g, device=dev) < 0.3
        valid[:, 0] = True
    return valid


@pytest.mark.parametrize("kind", ["prefix", "scattered"])
@pytest.mark.parametrize("Lq,Lk", [(33, 130), (130, 1000), (1000, 4097),
                                   (1000, 1000)])
@pytest.mark.parametrize("dtype,D,H", FORMS, ids=IDS)
def test_forms_ragged(dev, dtype, D, H, Lq, Lk, kind):
    """Query and key counts off every tile, Lq != Lk (and one self-attention
    on a qkv projection)."""
    q, k, v, do, g = _inputs(dev, dtype, D, H, Lq, Lk, 7 + Lq + Lk + D)
    _check(q, k, v, _validity(dev, kind, Lk, g), do,
           f"{dtype} d{D} Lq={Lq} Lk={Lk} {kind}")


@pytest.mark.parametrize("dtype,D,H", FORMS, ids=IDS)
def test_forms_last_keys(dev, dtype, D, H):
    """Each half of a 128-key tile and each of a pair of 32-key tiles holds
    one valid key, its last (31, 63, 127, 159), and the last key of a
    partial tile; row 1 only keys 31 and 200 (a 32-key tile's pair
    unlisted)."""
    Lk = 331
    q, k, v, do, _ = _inputs(dev, dtype, D, H, 130, Lk, 90 + D)
    valid = torch.zeros(B, Lk, dtype=torch.bool, device=dev)
    valid[0, [31, 63, 127, 159, Lk - 1]] = True
    valid[1, [31, 200]] = True
    _check(q, k, v, valid, do, f"{dtype} d{D} last keys")


@pytest.mark.parametrize("dtype,D,H", FORMS, ids=IDS)
def test_forms_empty_row(dev, dtype, D, H):
    """Batch row 0 has no valid key: every key gets P = 1 / lk_pad, so dV
    = sum(dO) / lk_pad on every key; row 1 scattered."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    Lq, Lk = 130, 1000
    q, k, v, do, g = _inputs(dev, dtype, D, H, Lq, Lk, 110 + D)
    valid = torch.rand(B, Lk, generator=g, device=dev) < 0.5
    valid[0] = False
    got, _ = _check(q, k, v, valid, do, f"{dtype} d{D} empty row")
    want_dv = do[0].float().sum(0) / fl.padded_keys(Lk)
    bound = FLASH_BWD_BOUND if dtype == torch.float32 else BF16_BOUND
    assert _rel(got[3][0], want_dv.expand(Lk, H, D)) <= bound


def test_fp32_d64_as_before(dev):
    """fp32 at heads of 64 (the VAE as configs/vae.yml builds it) through the
    same wrapper: its old counters, every launch bit-equal to the last (no
    atomics), within FLASH_BWD_BOUND of the plain backward."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    q, k, v, do, g = _inputs(dev, torch.float32, 64, 2, 1000, 1000, 130)
    valid = _validity(dev, "scattered", 1000, g)
    got, _ = _check(q, k, v, valid, do, "fp32 d64")
    assert fl.grad_key("res", torch.float32, 64) == "flash_attention_fp32_res"
    assert fl.grad_key("bwd_dkv", torch.float32, 64) == \
        "flash_attention_bwd_dkv"
    again = _grads(q, k, v, valid, do, None)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,D,H", FORMS, ids=IDS)
def test_forms_deterministic(dev, dtype, D, H):
    """Two runs of the kernels give the same bits (two kernels, no
    atomics)."""
    q, k, v, do, g = _inputs(dev, dtype, D, H, 1000, 1000, 150 + D)
    valid = _validity(dev, "scattered", 1000, g)
    a = _grads(q, k, v, valid, do, None)
    b = _grads(q, k, v, valid, do, None)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
