"""K7 above 128 lanes on the card: the wide kernels
(csrc/flash_attention_wide.cu) in each of their six forms, the forward
with and without its logsumexp residual, dkv and dq, in bf16 and in fp32,
at heads of 136 (padded to 192), 192, 256, 320, 384, 576, 640, 768, 832,
1024, 1088 (padded to 1152), 1152, 1536 and 3136 (padded to 3328),
against their plain torch versions (chip_smoke.py's `[wide-heads]` holds
them at the static VAE's full width and drives main_vae through them).
The widths cover every split the kernels take (`_widths.wide_split`:
lanes a CTA x CTAs a cluster, all three kernels): 192 x 1 (136, 192),
128 x 2 (256), 64 x 5 (320), 192 x 2 (384), 192 x 3 (576), 128 x 5 (640),
192 x 4 (768), 64 x 13 (832, past the portable 8), 128 x 8 (1024),
192 x 6 (1088, whose 64-lane split would take 17 CTAs, and 1152), 192 x 8
(1536) and, above one cluster's 3072 lanes, 4 passes of 64 x 13 (3136).

The cases: three batch rows, a prefix of valid keys, scattered keys and no
valid key at all (every 64-key tile visited, P = 1 / Lk-padded-to-512, so
its keys get dV != 0), at Lq 130 against Lk 300 (off the 64-row tiles and
the 512-key padding), q, k and v the views of one projection at Lq = Lk =
1000, and a tile whose only valid key is its last; the forward's logsumexp
against the plain scores'; two launches giving the same bits; each launch
counted under the caller's width; the fp32 gradients also against a
dense fp64 gradient; batch rows whose lists differ in length (one tile
against all of them: the clusters of the short row's missing visits
leave at once, the others run on); the residual forward's o and
logsumexp the same bits in two calls; the wrapper raising, not falling
back, where the library lacks the wide entries; and a head that is not a
multiple of 8 raising. Every test needs a CUDA
device and skips without one; run them on the GPU with

    python -m pytest tests/test_torch_port_wide_heads_cuda.py -m cuda -q

Tolerances, rel L2 of o, dq, dk and dv against the plain versions, those
the kernels of heads up to 128 take (tests/test_torch_port_flash_bwd_forms
_cuda.py): fp32 FLASH_BWD_BOUND 1e-5 (both fp32 throughout, the kernels'
3xTF32 products about fp32's precision), bf16 BF16_BOUND 1e-2 (both round
P and dS to bf16 and each gradient once; a value near a bf16 midpoint
rounds apart); the logsumexp LSE_ATOL 1e-4 absolute in fp32 (log-domain
values of a few units; exp2 and log2 against exp and log).
"""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda

FLASH_BWD_BOUND = 1e-5
BF16_BOUND = 1e-2
LSE_ATOL = 1e-4
WIDTHS = (136, 192, 256, 320, 384, 576, 640, 768, 832, 1024, 1088, 1152,
          1536, 3136)
HEADS = {136: 2, 192: 2, 256: 1, 320: 1, 384: 2, 576: 1, 640: 1, 768: 1,
         832: 1, 1024: 1, 1088: 1, 1152: 1, 1536: 1, 3136: 1}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _validity(dev, lk, g):
    """[3, lk]: row 0 a prefix, row 1 scattered, row 2 no valid key."""
    valid = torch.zeros(3, lk, dtype=torch.bool, device=dev)
    valid[0, :lk // 3] = True
    valid[1] = torch.rand(lk, generator=g, device=dev) < 0.3
    return valid


def _inputs(dev, dtype, B, D, H, lq, lk, seed, views=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    if views:
        qkv = torch.randn(B, lq, 3, H, D, generator=g, device=dev).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.randn(B, lq, H, D, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(B, lk, H, D, generator=g, device=dev).to(dtype)
                for _ in range(2))
    do = torch.randn(B, lq, H, D, generator=g, device=dev).to(dtype)
    return q, k, v, do, g


def _grads(q, k, v, valid, do, impl):
    """(o, dq, dk, dv) through the wrapper under grad; with the kernels,
    one launch of each of the form's three kernels under the caller's
    width."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    args = [a.detach().clone().requires_grad_(True) for a in (q, k, v)]
    fl.reset_launch_counts()
    D = q.shape[-1]
    o = fl.flash_attention(*args, valid, D ** -0.5, impl=impl)
    o.backward(do)
    if impl is None:
        torch.cuda.synchronize()
        assert {n: c for n, c in fl.launch_counts.items() if c} == {
            fl.grad_key(kind, q.dtype, D): 1 for kind in fl.GRAD_KINDS}
    return (o.detach(), *(a.grad for a in args))


def _grads_fp64(q, k, v, valid, do):
    """(o, dq, dk, dv) in fp64, dense: P the softmax over each row's valid
    keys, or 1 / Lk-padded-to-512 on every key of a row with none."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, -1)
    empty = ~valid.any(1)
    p[empty] = 1.0 / fl.padded_keys(k.shape[1])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    di = (o * do).sum(-1).transpose(1, 2)[..., None]  # [B, H, Lq, 1]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - di) * scale
    return (o, torch.einsum("bhqk,bkhd->bqhd", ds, k),
            torch.einsum("bhqk,bqhd->bkhd", ds, q),
            torch.einsum("bhqk,bqhd->bkhd", p, do))


def _check(q, k, v, valid, do, what):
    from gvfdiffusion_torch.ops import flash_attention as fl

    bound = FLASH_BWD_BOUND if q.dtype == torch.float32 else BF16_BOUND
    got = _grads(q, k, v, valid, do, None)
    want = _grads(q, k, v, valid, do, "plain")
    exact = (_grads_fp64(q, k, v, valid, do) if q.dtype == torch.float32
             else (None,) * 4)
    for name, a, b, c in zip(("o", "dq", "dk", "dv"), got, want, exact):
        assert a.dtype == q.dtype and a.shape == b.shape, (what, name)
        assert bool(torch.isfinite(a).all()), (what, name)
        err = _rel(a, b)
        print(f"wide {what} {name}: rel_l2 {err:.3e}")
        assert err <= bound, (what, name, err)
        if c is not None:
            err = _rel(a, c)
            print(f"wide {what} {name}: rel_l2 against fp64 {err:.3e}")
            assert err <= bound, (what, name, "fp64", err)
    # the forward without its residual
    D = q.shape[-1]
    fl.reset_launch_counts()
    o = fl.flash_attention(q, k, v, valid, D ** -0.5)
    torch.cuda.synchronize()
    assert {n: c for n, c in fl.launch_counts.items() if c} == {
        fl.launch_key(q.dtype, D): 1}
    err = _rel(o, want[0])
    print(f"wide {what} forward: rel_l2 {err:.3e}")
    assert o.dtype == q.dtype and err <= bound, (what, err)
    return got, want


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_wide_forms(dev, dt, D):
    """The six forms at every width: prefix, scattered and empty rows at
    Lq 130 against Lk 300; the empty row's keys get dV != 0."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    dtype = DTYPES[dt]
    q, k, v, do, g = _inputs(dev, dtype, 3, D, HEADS[D], 130, 300, D)
    valid = _validity(dev, 300, g)
    got, _ = _check(q, k, v, valid, do, f"{dt} d{D}")
    want_dv = do[2].double().sum(0) / fl.padded_keys(300)
    err = _rel(got[3][2], want_dv.expand(300, -1, -1))
    assert err <= (FLASH_BWD_BOUND if dt == "fp32" else BF16_BOUND), err


@pytest.mark.parametrize("D", (192, 768))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_wide_views_and_longer_rows(dev, dt, D):
    """q, k and v the views of one [2, 1000, 3, H, D] projection (the
    VAE's self-attention), a prefix and a scattered row."""
    q, k, v, do, g = _inputs(dev, DTYPES[dt], 2, D, 768 // D, 1000, 1000,
                             5 + D, views=True)
    valid = torch.zeros(2, 1000, dtype=torch.bool, device=dev)
    valid[0, :613] = True
    valid[1] = torch.rand(1000, generator=g, device=dev) < 0.2
    _check(q, k, v, valid, do, f"{dt} d{D} views")


@pytest.mark.parametrize("dt", list(DTYPES))
def test_wide_last_keys(dev, dt):
    """Each listed 64-key tile holds one valid key, its last (63, 191),
    and the last key of a partial tile (Lk 301: key 300); row 1 one key."""
    q, k, v, do, _ = _inputs(dev, DTYPES[dt], 2, 256, 1, 70, 301, 11)
    valid = torch.zeros(2, 301, dtype=torch.bool, device=dev)
    valid[0, [63, 191, 300]] = True
    valid[1, 130] = True
    _check(q, k, v, valid, do, f"{dt} d256 last keys")


@pytest.mark.parametrize("dt", list(DTYPES))
def test_wide_logsumexp_and_list(dev, dt):
    """The residual forward's row logsumexp against the plain scores' (in
    fp64; the empty row's log(Lk padded to 512)) and its list of the
    64-key tiles that hold a valid key."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    D, lk = 384, 300
    dtype = DTYPES[dt]
    q, k, v, _, g = _inputs(dev, dtype, 3, D, 2, 130, lk, 17)
    valid = _validity(dev, lk, g)
    assert fl.key_tile(dtype, D) == 64
    o, lse, tiles, _ = fl.launch_forward(q, k, v, valid, D ** -0.5,
                                         residual=True, width=D)
    torch.cuda.synchronize()
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * D ** -0.5
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    want = torch.logsumexp(s, -1)
    want[2] = math.log(fl.padded_keys(lk))
    err = float((lse.double() - want).abs().max())
    print(f"wide {dt} d{D} logsumexp: max abs {err:.3e}")
    assert err <= LSE_ATOL, err
    for b in range(3):
        listed = [t for t in range(-(-lk // 64))
                  if bool(valid[b, 64 * t:64 * t + 64].any())]
        assert tiles[b, 0].item() == len(listed), b
        assert tiles[b, 1:1 + len(listed)].tolist() == listed, b


@pytest.mark.parametrize("D", (576, 832))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_wide_uneven_lists(dev, dt, D):
    """Batch row 0 lists one 64-key tile (one valid key), row 1 all
    sixteen (every key valid), row 2 none: the backward's clusters of row
    0's missing visits leave before any cluster barrier while row 1's run
    every visit; Lq 1000 against Lk 1000."""
    q, k, v, do, _ = _inputs(dev, DTYPES[dt], 3, D, 1, 1000, 1000, 29 + D)
    valid = torch.zeros(3, 1000, dtype=torch.bool, device=dev)
    valid[0, 517] = True
    valid[1] = True
    _check(q, k, v, valid, do, f"{dt} d{D} uneven lists")


@pytest.mark.parametrize("D", (136, 768, 832, 1152, 3136))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_wide_deterministic(dev, dt, D):
    """Two launches of each kernel on the same inputs give the same bits
    (no atomics; a cluster sums its partial scores in rank order)."""
    q, k, v, do, g = _inputs(dev, DTYPES[dt], 3, D, 1, 130, 300, 23 + D)
    valid = _validity(dev, 300, g)
    first = _grads(q, k, v, valid, do, None)
    second = _grads(q, k, v, valid, do, None)
    for name, a, b in zip(("o", "dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), (dt, D, name)


def test_wide_entries_missing_raise(dev, monkeypatch):
    """Where the library has no wide entry, the wrapper raises: nothing
    falls back to the plain version, and nothing is counted."""
    from gvfdiffusion_torch import _ext
    from gvfdiffusion_torch.ops import flash_attention as fl

    lib = _ext.load()

    class Without:
        def __getattr__(self, name):
            if "_wide" in name:
                raise AttributeError(name)
            return getattr(lib, name)

    monkeypatch.setattr(_ext, "_lib", Without())
    q, k, v, do, g = _inputs(dev, torch.float32, 3, 192, 1, 130, 300, 3)
    valid = _validity(dev, 300, g)
    fl.reset_launch_counts()
    with pytest.raises(AttributeError, match="_wide"):
        fl.flash_attention(q, k, v, valid, 192 ** -0.5)
    leaf = q.clone().requires_grad_(True)
    with pytest.raises(AttributeError, match="_wide"):
        fl.flash_attention(leaf, k, v, valid, 192 ** -0.5)
    assert not any(fl.launch_counts.values())
    # the kernels of heads up to 128 are still there
    fl.flash_attention(*(t[..., :64].contiguous() for t in (q, k, v)),
                       valid, 0.125)
    assert fl.launch_counts["flash_attention_fp32"] == 1


@pytest.mark.parametrize("D", (192, 768, 1152, 3136))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_wide_forward_same_bits(dev, dt, D):
    """The residual forward twice on the same inputs: o and the row
    logsumexp the same bits (every CTA of a cluster sums the partial
    scores in rank order and runs the softmax on the same sums; rank 0 of
    the first pass writes the logsumexp)."""
    from gvfdiffusion_torch.ops import flash_attention as fl
    from gvfdiffusion_torch.ops._widths import flash_card_width, pad_heads

    q, k, v, _, g = _inputs(dev, DTYPES[dt], 3, D, 1, 130, 300, 41 + D)
    valid = _validity(dev, 300, g)
    W = flash_card_width(D)
    q, k, v = (pad_heads(t, W) for t in (q, k, v))
    runs = [fl.launch_forward(q, k, v, valid, D ** -0.5, residual=True,
                              width=D)[:2] for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse"), *runs):
        assert torch.equal(a, b), (dt, D, name)


def test_wider_than_the_rule_raises(dev):
    """K7's rule takes every multiple of 8, with no cap (1032 and 4096, past
    the old cap of 1024, run); a head of another width raises and nothing
    is launched."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    valid = torch.ones(1, 64, dtype=torch.bool, device=dev)
    fl.reset_launch_counts()
    for D in (196, 132, 1036, 3140):
        q = torch.zeros(1, 64, 1, D, device=dev)
        with pytest.raises(ValueError, match="heads of"):
            fl.flash_attention(q, q, q, valid, 0.1)
    assert not any(fl.launch_counts.values())
    for D in (1032, 4096):
        q = torch.zeros(1, 64, 1, D, device=dev)
        o = fl.flash_attention(q, q, q, valid, 0.1)
        torch.cuda.synchronize()
        assert tuple(o.shape) == (1, 64, 1, D) and float(o.abs().max()) == 0
    assert fl.launch_counts["flash_attention_fp32_d1032"] == 1
    assert fl.launch_counts["flash_attention_fp32_d4096"] == 1
