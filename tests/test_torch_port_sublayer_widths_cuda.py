"""K1, K2 and K3 on the card at the head widths their rules admit beyond
32 and 64 (C = 128: heads of 1, 2, 4, 8, 16 and 128), every form against
its plain torch version: K1 float with and without the q/k RMS norms,
int8 QK, `seg` (float and int8 QK, on K2's chain); K2 float with and
without the norms, int8 QK, and its attention step alone
(`temporal_sublayer_attention`, float and int8 QK); K3's two contexts
without and with the q norm, on an int8 cache without and with it; its
single context in bf16 (bf16 and fp32 residual streams, with and without
the norm), in fp32 (with and without it) and on an int8 cache. Each
launch is counted under the true width's key; a width no rule admits
(48) raises in every form. Every test here needs a CUDA device and skips
without one; run them on the GPU with

    python -m pytest tests/test_torch_port_sublayer_widths_cuda.py -m cuda -q

Tolerances, tests/test_torch_port_cuda.py's for the same forms (a few
times the error chip_smoke.py reads at full width): rel L2 of y and of the
update y - x <= (3e-3, 3e-2) for the bf16 forms ((1e-2, 4e-2) for K3's
two contexts with the q norm at heads of 1, whose readings reach 4.8e-3,
1.5e-2 over nine draws),
CROSS_F32_BOUNDS for the fp32 single context, ATTN_BOUND for the
attention step alone.
"""

import pytest
import torch
from test_torch_port_cuda import (ATTN_BOUND, BOUNDS, CROSS_F32_BOUNDS,
                                  _Draw, _rel, _temporal_core_case)

from gvfdiffusion_torch.ops import fused_sublayer as pt

pytestmark = pytest.mark.cuda

# K3's two contexts with the q RMS norm at heads of 1, where the norm is the
# sign of q, which a q near 0 flips between the kernel's fp32 sums and the
# plain version's (readings over nine draws, y 3.2e-3 to 4.8e-3, update
# 1.0e-2 to 1.5e-2: test_cross_rms_heads_of_1_draws)
CROSS_RMS_BOUNDS = (1e-2, 4e-2)
C = 128
WIDTHS = (1, 2, 4, 8, 16, 128)
SELF_FORMS = ("self", "self_norms_off", "self_q8", "self_seg",
              "self_seg_q8", "temporal", "temporal_norms_off", "temporal_q8")
CROSS_FORMS = ("cross", "cross_rms", "cross_q8", "cross_q8_norms_off",
               "single", "single_x32", "single_rms", "single_q8",
               "single_fp32", "single_rms_fp32")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _run(key, fn, x, args, kw, bounds=None):
    """The kernel once (its launch counted under `key` alone) and the
    plain version; rel L2 of y and of the update within the bounds."""
    pt.reset_launch_counts()
    with torch.no_grad():
        y = fn(*args, **kw)
        ref = fn(*args, **kw, impl="plain")
    torch.cuda.synchronize()
    assert {k: n for k, n in pt.launch_counts.items() if n} == {key: 1}
    assert y.shape == ref.shape and y.dtype == x.dtype
    assert bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    upd = _rel(y.float() - x.float(), ref.float() - x.float())
    print(f"{key} {tuple(x.shape)}: rel_l2 {err:.3e} update_rel_l2 "
          f"{upd:.3e}")
    y_bound, upd_bound = bounds or BOUNDS["self"]
    assert err <= y_bound, err
    assert upd <= upd_bound, upd


def _self_case(dev, form, D, c=C):
    d = _Draw(dev, 40 + D, c)
    H = c // D
    q8 = form.endswith("q8")
    kw = dict(num_heads=H, rms="norms_off" not in form, quant_qk=q8)
    if form.startswith("temporal"):
        x = d(2, 32, 24, c)
        return x, (x, *d.mods(2), *d.self_weights()), kw, \
            pt.fused_temporal_sublayer
    seg = "seg" in form
    x = d(4, 128 if seg else 100, c)
    kw.update(mod_repeat=2, seg=4 if seg else 0)
    return x, (x, *d.mods(2), *d.self_weights()), kw, pt.fused_self_sublayer


@pytest.mark.parametrize("form", SELF_FORMS)
@pytest.mark.parametrize("D", WIDTHS)
def test_self_forms(dev, D, form):
    x, args, kw, fn = _self_case(dev, form, D)
    counter = form.replace("_norms_off", "")
    _run(pt.launch_key(counter, D), fn, x, args, kw)


def _cross_case(dev, form, D, c=C, seed=None):
    d = _Draw(dev, 60 + D if seed is None else seed, c)
    H = c // D
    single = form.startswith("single")
    q8 = "q8" in form
    rms = form in ("cross_rms", "cross_q8", "single_rms", "single_q8",
                   "single_rms_fp32")
    dt = torch.float32 if form.endswith("fp32") else torch.bfloat16
    x = d(2, 100, c)
    args = [x]
    for lk in ((37,) if single else (37, 130)):
        p, (k, v) = d.cross(2, lk)
        if rms:
            p = p[:4] + (d(c, shift=1.0, scale=0.1) * (c // H) ** 0.5,) \
                + p[4:]
        kv = (k, v)
        if q8:
            kq, ks = pt.quantize_kv(k, H)
            vq, vs = pt.quantize_kv(v, H)
            kv = (kq, vq, ks.transpose(1, 2).contiguous(), vs)
        args += [p, kv]
    if dt == torch.float32:
        args = [args[0].float(), tuple(a.float() for a in args[1]),
                tuple(a.float() for a in args[2])]
    elif form == "single_x32":
        args[0] = args[0].float()
    kw = dict(num_heads=H, rms=rms, quant=q8, compute_dtype=dt)
    if single:
        key = pt.single_launch_key(dt, D, rms=rms and not q8, quant=q8)
    else:
        key = pt.launch_key("cross_q8" if q8 else "cross", D)
    bounds = CROSS_F32_BOUNDS if dt == torch.float32 else \
        CROSS_RMS_BOUNDS if (form, D) == ("cross_rms", 1) else \
        BOUNDS["cross"]
    return args[0], args, kw, key, bounds


@pytest.mark.parametrize("form", CROSS_FORMS)
@pytest.mark.parametrize("D", WIDTHS)
def test_cross_forms(dev, D, form):
    x, args, kw, key, bounds = _cross_case(dev, form, D)
    _run(key, pt.fused_cross_sublayer, x, args, kw, bounds)


@pytest.mark.parametrize("seed", range(100, 108))
def test_cross_rms_heads_of_1_draws(dev, seed):
    """K3's two contexts with the q norm at heads of 1, where the norm is
    the sign of q, over eight more draws: the readings CROSS_RMS_BOUNDS is
    set from."""
    x, args, kw, key, bounds = _cross_case(dev, "cross_rms", 1, seed=seed)
    _run(key, pt.fused_cross_sublayer, x, args, kw, bounds)


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("D", WIDTHS)
def test_temporal_core_widths(dev, D, q8):
    """The attention over T alone, its qkv (and int8 q, k) at the true
    width, padded and cut back by the wrapper below 32 lanes."""
    heads = C // D
    qkv, quant = _temporal_core_case(dev, 70 + D, 2, 33, 24, heads, q8)
    pt.reset_launch_counts()
    with torch.no_grad():
        got = pt.temporal_sublayer_attention(qkv, heads, quant=quant)
        want = pt.temporal_sublayer_attention(qkv, heads, quant=quant,
                                              impl="plain")
    torch.cuda.synchronize()
    assert {k: n for k, n in pt.launch_counts.items() if n} == {
        pt.launch_key("temporal_core", D): 1}
    assert got.shape == want.shape == (2, 33, 24, C)
    err = _rel(got, want)
    print(f"temporal core heads of {D} q8={q8}: rel_l2 {err:.3e}")
    assert bool(torch.isfinite(got).all()) and err <= ATTN_BOUND, err


@pytest.mark.parametrize("form", SELF_FORMS + CROSS_FORMS)
def test_width_no_rule_admits_raises(dev, form):
    """Heads of 48 (C = 96, 2 heads): refused on the card in every form,
    never run by the plain version instead."""
    case = _self_case if form in SELF_FORMS else _cross_case
    x, args, kw = case(dev, form, 48, c=96)[:3]
    pt.reset_launch_counts()
    with torch.no_grad(), pytest.raises(ValueError, match="divide 128"):
        (pt.fused_cross_sublayer if form in CROSS_FORMS else
         pt.fused_temporal_sublayer if form.startswith("temporal") else
         pt.fused_self_sublayer)(*args, **kw)
    assert not any(pt.launch_counts.values())
