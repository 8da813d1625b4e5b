"""K7's backward as its card kernels compute it (csrc/flash_attention_bwd.cu:
every product by the 3xTF32 split, dK and dV summed 32 query rows a
chain, dQ 32 keys a chain), emulated on the CPU (tests/_tf32.py
`backward_3xtf32`), against the port's plain backward
(`flash_attention_backward_reference`) and an fp64 backward, at the static
VAE's 12 heads of 64: 512 query rows, 2048 keys with a prefix of 1500
valid (every query row counts, valid or not).

Tolerance: FLASH_BWD_BOUND, rel L2 1e-5 of dq, dk and dv, the bound that
tests/test_torch_port_cuda.py and chip_smoke.py hold the card's kernels
to against the plain backward; the fp64 readings are printed beside the
plain fp32 version's. The tensor cores' own fp32 accumulation inside a
chain is what this cannot show. One case shows that the split is needed:
hi . hi' alone (plain TF32) breaks the bound.
"""

import numpy as np
import pytest
import torch

from gvfdiffusion_torch.ops import flash_attention as fl
import _tf32

FLASH_BWD_BOUND = 1e-5
B, LQ, LK, N_VALID, H, D = 1, 512, 2048, 1500, 12, 64
NAMES = ("dq", "dk", "dv")


def _backward_fp64(q, k, v, valid, scale, do):
    """The gradient of softmax attention over the valid keys, in fp64."""
    qh, kh, vh, doh = (a.double().transpose(1, 2) for a in (q, k, v, do))
    mask = torch.where(valid, 0.0, float("-inf")).double()[:, None, None]
    p = torch.softmax(qh @ kh.transpose(-1, -2) * scale + mask, -1)
    o = p @ vh
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - (o * doh).sum(-1, keepdim=True)) * scale
    grads = ds @ kh, ds.transpose(-1, -2) @ qh, p.transpose(-1, -2) @ doh
    return tuple(g.transpose(1, 2) for g in grads)


@pytest.fixture(scope="module")
def grads():
    """(dq, dk, dv) of the 3xTF32 emulation, of the plain fp32 backward, of
    the hi . hi' emulation and in fp64, on one seeded draw."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = np.random.default_rng(140)
        q, do = (torch.from_numpy(r.standard_normal((B, LQ, H, D)).astype(
            np.float32)) for _ in range(2))
        k, v = (torch.from_numpy(r.standard_normal((B, LK, H, D)).astype(
            np.float32)) for _ in range(2))
        valid = torch.zeros(B, LK, dtype=torch.bool)
        valid[:, :N_VALID] = True
        scale = D ** -0.5
        o = fl.flash_attention_reference(q, k, v, valid, scale)
        return {
            "3xtf32": _tf32.backward_3xtf32(q, k, v, valid, scale, o, do),
            "plain": fl.flash_attention_backward_reference(
                q, k, v, valid, scale, o, do),
            "hi.hi": _tf32.backward_3xtf32(q, k, v, valid, scale, o, do,
                                           mm=_tf32.mm1),
            "fp64": _backward_fp64(q, k, v, valid, scale, do)}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("i", range(3), ids=NAMES)
def test_emulation_against_plain(grads, i):
    err = _tf32.rel_l2(grads["3xtf32"][i], grads["plain"][i])
    print(f"{NAMES[i]}: 3xTF32 emulation vs plain fp32 rel_l2 {err:.3e}")
    assert err <= FLASH_BWD_BOUND


@pytest.mark.parametrize("i", range(3), ids=NAMES)
def test_emulation_against_fp64(grads, i):
    err = _tf32.rel_l2(grads["3xtf32"][i], grads["fp64"][i])
    plain = _tf32.rel_l2(grads["plain"][i], grads["fp64"][i])
    print(f"{NAMES[i]} against fp64: 3xTF32 emulation {err:.3e}, plain "
          f"fp32 {plain:.3e}")
    assert err <= FLASH_BWD_BOUND
    assert plain <= FLASH_BWD_BOUND


@pytest.mark.parametrize("i", range(3), ids=NAMES)
def test_split_is_needed(grads, i):
    """hi . hi' alone, every product at tf32's 11 bits, breaks the bound."""
    err = _tf32.rel_l2(grads["hi.hi"][i], grads["fp64"][i])
    print(f"{NAMES[i]}: hi . hi' alone against fp64 rel_l2 {err:.3e}")
    assert err > FLASH_BWD_BOUND
