"""K7's backward kernels (csrc/flash_attention_bwd.cu: dkv and dq, fp32 at
heads of 64, every product by the 3xTF32 split on the tensor cores) at the
edges of their tiles, against the plain backward on the card.

The kernels cut keys and queries into 64-row tiles and sum dK, dV and dQ
32 rows or keys a chain, and they visit only the 64-key tiles that the
forward listed. So: query and key counts that are not multiples of 32 or
64 (Lq 1, 33, 130 and 1000 against Lk 33, 1000 and 4097, Lq != Lk among
them); a key tile whose one valid key is its last; a batch row with no
valid key (every tile visited, P = 1 / Lk-padded-to-512) beside one with a
single valid key (whose dQ and dK are 0 in exact arithmetic: held against
the terms that cancel); and scores scaled by 8 (q times 8), which sharpens exp
and makes dP - di cancel. k and v are the views of one [B, Lk, 2, H, 64]
tensor. Every test needs a CUDA device and skips without one; run them on
the GPU with

    python -m pytest tests/test_torch_port_flash_bwd_edges.py -m cuda -q

Tolerance: FLASH_BWD_BOUND, rel L2 1e-5 of dq, dk and dv against the plain
backward (`flash_attention_backward_reference`), as the card tests of
tests/test_torch_port_cuda.py hold the kernels at the VAE's shapes: both
are fp32 throughout, the kernels' 3xTF32 products about fp32's precision.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

FLASH_BWD_BOUND = 1e-5
B, H, D = 2, 2, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _validity(dev, kind, lk, g):
    """[B, lk] key validity: a prefix of each row (the VAE's slots), or
    scattered at 30%, key 0 valid."""
    valid = torch.zeros(B, lk, dtype=torch.bool, device=dev)
    if kind == "prefix":
        valid[0, :max(1, lk // 3)] = True
        valid[1, :max(1, lk - 5)] = True
    else:
        valid = torch.rand(B, lk, generator=g, device=dev) < 0.3
        valid[:, 0] = True
    return valid


def _grads(q, k, v, valid, do, impl):
    """(o, dq, dk, dv) through the wrapper under grad; with the kernels,
    the launches checked."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    q = q.detach().requires_grad_(True)
    kv = k.detach().new_empty(k.shape[0], k.shape[1], 2, H, D)
    kv[:, :, 0], kv[:, :, 1] = k, v
    kv.requires_grad_(True)
    fl.reset_launch_counts()
    o = fl.flash_attention(q, kv[:, :, 0], kv[:, :, 1], valid, D ** -0.5,
                           impl=impl)
    o.backward(do)
    if impl is None:
        torch.cuda.synchronize()
        assert {n: c for n, c in fl.launch_counts.items() if c} == {
            "flash_attention_fp32_res": 1, "flash_attention_bwd_dkv": 1,
            "flash_attention_bwd_dq": 1}
    return o.detach(), q.grad, kv.grad[:, :, 0], kv.grad[:, :, 1]


def _check(q, k, v, valid, do, what):
    got = _grads(q, k, v, valid, do, None)
    want = _grads(q, k, v, valid, do, "plain")
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a).all()), (what, name)
        err = _rel(a, b)
        print(f"flash bwd {what} {name}: rel_l2 {err:.3e}")
        assert err <= FLASH_BWD_BOUND, (what, name, err)
    return got, want


def _inputs(dev, lq, lk, seed, q_scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, lq, H, D, generator=g, device=dev) * q_scale
    k, v = (torch.randn(B, lk, H, D, generator=g, device=dev)
            for _ in range(2))
    do = torch.randn(B, lq, H, D, generator=g, device=dev)
    return q, k, v, do, g


@pytest.mark.parametrize("kind", ["prefix", "scattered"])
@pytest.mark.parametrize("Lk", [33, 1000, 4097])
@pytest.mark.parametrize("Lq", [1, 33, 130, 1000])
def test_ragged_lengths(dev, Lq, Lk, kind):
    """Query and key counts off the 32- and 64-row tiles, Lq != Lk."""
    q, k, v, do, g = _inputs(dev, Lq, Lk, 40 + Lq + Lk)
    _check(q, k, v, _validity(dev, kind, Lk, g), do,
           f"Lq={Lq} Lk={Lk} {kind}")


@pytest.mark.parametrize("Lk", [128, 200, 4097])
def test_tile_with_only_its_last_key(dev, Lk):
    """Each listed tile's only valid key is its last: row 0 keys 63 and
    127, row 1 key 63 and its last key (in a partial tile where Lk is not
    a multiple of 64)."""
    q, k, v, do, _ = _inputs(dev, 130, Lk, 50 + Lk)
    valid = torch.zeros(B, Lk, dtype=torch.bool, device=dev)
    valid[0, [63, 127]] = True
    valid[1, [63, Lk - 1]] = True
    _check(q, k, v, valid, do, f"last-key Lk={Lk}")


def _cancelled(got, want, terms, what):
    """A gradient that is 0 in exact arithmetic (a query row, or a key, in
    a batch row with one valid key: P = 1 there and dP - di cancels): the
    kernel's and the plain version's differ by rounding, held to
    FLASH_BWD_BOUND times the norm of the terms that cancel."""
    err = float((got - want).double().norm() / terms.double().norm())
    print(f"flash bwd {what}: rel to the cancelled terms {err:.3e}")
    assert err <= FLASH_BWD_BOUND, (what, err)


@pytest.mark.parametrize("Lq,Lk", [(33, 130), (1000, 4097)])
def test_empty_row_beside_single_key(dev, Lq, Lk):
    """Batch row 0 has no valid key: every key gets P = 1 / Lk-padded-to-512
    (dV = sum(dO) / lk_pad on every key); row 1 has a single valid key j
    (P = 1 on it, so dV_j = sum(dO) and dS = P (dP - di) = 0: its dQ and
    dK_j are rounding, held against the terms that cancel)."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    q, k, v, do, _ = _inputs(dev, Lq, Lk, 60 + Lk)
    j = Lk // 2
    valid = torch.zeros(B, Lk, dtype=torch.bool, device=dev)
    valid[1, j] = True
    what = f"empty+single Lq={Lq} Lk={Lk}"
    got = _grads(q, k, v, valid, do, None)
    want = _grads(q, k, v, valid, do, "plain")
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a).all()), (what, name)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        err = _rel(a[0], b[0])
        print(f"flash bwd {what} {name}, the empty row: rel_l2 {err:.3e}")
        assert err <= FLASH_BWD_BOUND, (what, name, err)
    o, dq, dk, dv = got
    assert _rel(o[1], v[1, j].expand_as(o[1])) <= FLASH_BWD_BOUND
    assert _rel(dv[1, j], do[1].sum(0)) <= FLASH_BWD_BOUND
    assert _rel(dv[1], want[3][1]) <= FLASH_BWD_BOUND
    # the terms P dP scale that dS's subtraction of di cancels
    dp = torch.einsum("qhd,hd->qh", do[1], v[1, j]) * D ** -0.5
    _cancelled(dq[1], want[1][1], dp[..., None] * k[1, j], f"{what} dq")
    _cancelled(dk[1], want[2][1], dp[..., None] * q[1], f"{what} dk")
    want0 = (do[0].sum(0) / fl.padded_keys(Lk)).expand(Lk, H, D)
    assert _rel(dv[0], want0) <= FLASH_BWD_BOUND


@pytest.mark.parametrize("kind", ["prefix", "scattered"])
def test_sharp_scores(dev, kind):
    """q times 8: scaled scores with a standard deviation of 8 (against
    1), a softmax close to one-hot, dP - di cancelling in most rows."""
    q, k, v, do, g = _inputs(dev, 300, 1000, 70, q_scale=8.0)
    _check(q, k, v, _validity(dev, kind, 1000, g), do, f"x8 {kind}")
