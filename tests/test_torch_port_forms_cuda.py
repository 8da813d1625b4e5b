"""The kernel forms that no path of the system reaches, and the fused
sublayers' backward, against their plain torch versions on the card, at
small and ragged shapes (chip_smoke.py's `[forms]` holds them at full
width):
  * K5's `segment_size`: segments of 24 and 26 that no 128-key tile
    boundary lines up with, 64 at heads of 64, a query tile that spans
    two key tiles, with a soft and a -inf key bias, bf16 and fp32 io;
  * K5's int8 forms: Lq of 64 to 1374 (one to three q scale cells of
    `lq_block` rows), Lk off the 128-key tile, a -inf bias with a batch
    row whose keys are all masked (exactly 0, never NaN), segments;
  * K1's `seg` on K2's chain: seg 4 and 16, mod_repeat 1 and 2, float and
    int8 QK, equal bit for bit to K2 on the [B, L / seg, seg, C] view;
  * K3's single context with the q RMS norm (heads of 32, 64, 128; bf16
    and fp32) and on an int8 cache (heads of 32 and 64, q_block 0 and 32,
    bf16 and fp32 residual);
  * the backward: the Functions of K1-K4 against torch's autograd through
    their plain functions, K5's key-bias gradient with segments, and a
    2-block DiT with a hoisted cache under autograd against impl="plain".
Every test needs a CUDA device and skips without one; run them on the GPU
with

    python -m pytest tests/test_torch_port_forms_cuda.py -m cuda -q

Tolerances, rel L2 against the plain version: K5's float forms and int8
QK 1e-2 (the float forms' ATTN_BOUND of tests/test_torch_port_cuda.py),
int8 P V 2e-2 (an int8 P step where the two exp2s straddle a midpoint
moves a row by up to vm / 127); the sublayers' (y, y - x) bounds of
tests/test_torch_port_cuda.py, CROSS_F32_BOUNDS for the fp32 form; the
gradients 1e-2 (the Function's chunked recomputation rounds its shared
gradients to bf16 per chunk; K5 fp32 1e-5), the DiT's 5e-2 (its bf16
forward's differences carried through two blocks).
"""

import numpy as np
import pytest
import torch

from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.ops import fused_attention as fa
from gvfdiffusion_torch.ops import fused_sublayer as pt
from gvfdiffusion_torch.utils.weights import init_random_

pytestmark = pytest.mark.cuda

ATTN_BOUND = 1e-2
QKAV_BOUND = 2e-2
BOUNDS = {"self": (3e-3, 3e-2), "cross_single": (3e-3, 3e-2)}
CROSS_F32_BOUNDS = (4e-7, 3e-6)
GRAD_BOUND = 1e-2
K5_GRAD_BOUND = 1e-5
DIT_GRAD_BOUND = 5e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _t(r, *shape, dev, dt=torch.bfloat16, scale=1.0, shift=0.0):
    a = r.standard_normal(shape) * scale + shift
    return torch.tensor(a, dtype=dt, device=dev)


def _bias(r, B, Lk, kind, dev):
    if kind is None:
        return None
    b = torch.tensor(r.standard_normal((B, Lk)) * 0.5, dtype=torch.float32,
                     device=dev)
    if kind == "ragged":  # padding keys, and a batch row with none valid
        b[:, Lk - Lk // 4:] = float("-inf")
        b[-1] = float("-inf")
    return b


@pytest.mark.parametrize("B,L,H,D,seg,bias,dt", [
    (2, 192, 2, 32, 24, None, torch.bfloat16),
    (1, 130, 2, 32, 26, "soft", torch.bfloat16),
    (3, 256, 4, 64, 64, "soft", torch.bfloat16),
    (2, 384, 2, 64, 32, None, torch.float32),
    (2, 192, 2, 32, 24, "ragged", torch.float32)])
def test_k5_segments(dev, B, L, H, D, seg, bias, dt):
    r = np.random.default_rng(1)
    q, k, v = (_t(r, B, L, H, D, dev=dev, dt=dt) for _ in range(3))
    b = _bias(r, B, L, bias, dev)
    fa.reset_launch_counts()
    y = fa.fused_attention(q, k, v, D ** -0.5, kv_bias=b, segment_size=seg)
    ref = fa.fused_attention(q, k, v, D ** -0.5, kv_bias=b,
                             segment_size=seg, impl="plain")
    torch.cuda.synchronize()
    assert fa.launch_counts[fa.launch_key(D, False, b is not None,
                                          True)] == 1
    assert y.dtype == dt and bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"K5 seg {seg} {tuple(q.shape)} {dt} bias={bias}: rel_l2 "
          f"{err:.3e}")
    assert err <= ATTN_BOUND, err
    if bias == "ragged":
        assert not y[-1].abs().any()
    with pytest.raises(ValueError):  # Lq must be a multiple of it
        fa.fused_attention(q, k, v, D ** -0.5, segment_size=seg + 1)


@pytest.mark.parametrize("quant", ["qk", "qk+av"])
@pytest.mark.parametrize("B,Lq,Lk,H,D,bias,seg", [
    (2, 64, 64, 2, 32, None, 0),
    (2, 200, 300, 2, 64, "ragged", 0),
    (1, 1374, 1374, 2, 64, None, 0),
    (3, 256, 256, 4, 32, "soft", 32),
    (2, 100, 130, 4, 32, "ragged", 0)])
def test_k5_int8_forms(dev, quant, B, Lq, Lk, H, D, bias, seg):
    r = np.random.default_rng(2)
    q, k, v = (_t(r, B, n, H, D, dev=dev) for n in (Lq, Lk, Lk))
    b = _bias(r, B, Lk, bias, dev)
    kw = dict(kv_bias=b, segment_size=seg, quant=quant)
    fa.reset_launch_counts()
    y = fa.fused_attention(q, k, v, D ** -0.5, **kw)
    ref = fa.fused_attention(q, k, v, D ** -0.5, **kw, impl="plain")
    torch.cuda.synchronize()
    assert fa.launch_counts[fa.launch_key(D, False, False, quant=quant)] == 1
    assert bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"K5 {quant} {tuple(q.shape)} x {Lk} bias={bias} seg={seg}: "
          f"rel_l2 {err:.3e}")
    assert err <= (QKAV_BOUND if quant == "qk+av" else ATTN_BOUND), err
    if bias == "ragged":
        assert not y[-1].abs().any() and not ref[-1].abs().any()


@pytest.mark.parametrize("quant_qk", [False, True])
@pytest.mark.parametrize("seg,mod_repeat", [(4, 1), (16, 2)])
def test_self_seg_on_k2_chain(dev, seg, mod_repeat, quant_qk):
    r = np.random.default_rng(3)
    C, B, L = 128, 4, 64
    x = _t(r, B, L, C, dev=dev)
    mods = [_t(r, B // mod_repeat, C, dev=dev, scale=0.3) for _ in range(3)]
    w = (_t(r, C, 3 * C, dev=dev, scale=C ** -0.5),
         _t(r, 3 * C, dev=dev, scale=0.1),
         _t(r, C, dev=dev, shift=1.0, scale=0.1),
         _t(r, C, dev=dev, shift=1.0, scale=0.1),
         _t(r, C, C, dev=dev, scale=C ** -0.5), _t(r, C, dev=dev, scale=0.1))
    kw = dict(num_heads=4, seg=seg, mod_repeat=mod_repeat,
              quant_qk=quant_qk)
    pt.reset_launch_counts()
    with torch.no_grad():
        y = pt.fused_self_sublayer(x, *mods, *w, **kw)
        ref = pt.fused_self_sublayer(x, *mods, *w, **kw, impl="plain")
        rep = [m.repeat_interleave(mod_repeat, 0) for m in mods]
        k2 = pt.fused_temporal_sublayer(
            x.reshape(B, L // seg, seg, C), *rep, *w, num_heads=4,
            quant_qk=quant_qk, voxel_group=seg).reshape(B, L, C)
    torch.cuda.synchronize()
    key = "self_seg_q8" if quant_qk else "self_seg"
    assert pt.launch_counts[key] == 1
    assert torch.equal(y, k2)
    err = _rel(y, ref)
    upd = _rel(y.float() - x.float(), ref.float() - x.float())
    print(f"K1 seg {seg} quant_qk={quant_qk}: rel_l2 {err:.3e} update "
          f"{upd:.3e}")
    assert err <= BOUNDS["self"][0] and upd <= BOUNDS["self"][1]


def _single_case(r, dev, C, H, B, L, lk, dt, rms=True):
    gam = (1.0 + 0.1 * r.standard_normal(C)) * (C // H) ** 0.5
    p = (_t(r, C, dev=dev, dt=dt, shift=1.0, scale=0.1),
         _t(r, C, dev=dev, dt=dt, scale=0.1),
         _t(r, C, C, dev=dev, dt=dt, scale=C ** -0.5),
         _t(r, C, dev=dev, dt=dt, scale=0.1),
         torch.tensor(gam, dtype=dt, device=dev),
         _t(r, C, C, dev=dev, dt=dt, scale=C ** -0.5),
         _t(r, C, dev=dev, dt=dt, scale=0.1))
    if not rms:
        p = p[:4] + p[5:]
    return p, (_t(r, B, lk, C, dev=dev, dt=dt), _t(r, B, lk, C, dev=dev,
                                                   dt=dt))


@pytest.mark.parametrize("H", [8, 4, 2])  # heads of 32, 64, 128 at C = 256
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_cross_single_rms(dev, H, dt):
    r = np.random.default_rng(4)
    C = 256
    x = _t(r, 2, 100, C, dev=dev, dt=torch.float32)
    p, kv = _single_case(r, dev, C, H, 2, 100, 37, dt)
    kw = dict(num_heads=H, rms=True, compute_dtype=dt)
    pt.reset_launch_counts()
    with torch.no_grad():
        y = pt.fused_cross_sublayer(x, p, kv, **kw)
        ref = pt.fused_cross_sublayer(x, p, kv, **kw, impl="plain")
        no_rms = pt.fused_cross_sublayer(x, p[:4] + p[5:], kv, num_heads=H,
                                         compute_dtype=dt)
    torch.cuda.synchronize()
    assert pt.launch_counts[pt.single_launch_key(dt, C // H, rms=True)] == 1
    err, upd = _rel(y, ref), _rel(y - x, ref - x)
    print(f"K3 single rms heads of {C // H} {dt}: rel_l2 {err:.3e} update "
          f"{upd:.3e}")
    y_b, u_b = CROSS_F32_BOUNDS if dt == torch.float32 else \
        BOUNDS["cross_single"]
    assert err <= y_b and upd <= u_b, (err, upd)
    assert _rel(no_rms - x, ref - x) > 10 * upd  # the norm acts


@pytest.mark.parametrize("H,rms,q_block,x_dt", [
    (4, False, 0, torch.bfloat16), (4, True, 32, torch.float32),
    (2, True, 0, torch.float32), (2, False, 32, torch.bfloat16)])
def test_cross_single_int8(dev, H, rms, q_block, x_dt):
    r = np.random.default_rng(5)
    C = 128
    x = _t(r, 2, 128, C, dev=dev, dt=x_dt)
    p, (k, v) = _single_case(r, dev, C, H, 2, 128, 130, torch.bfloat16, rms)
    kq, ks = pt.quantize_kv(k, H)
    vq, vs = pt.quantize_kv(v, H)
    cache = (kq, vq, ks.transpose(1, 2).contiguous(), vs)
    kw = dict(num_heads=H, rms=rms, quant=True, q_block=q_block)
    pt.reset_launch_counts()
    with torch.no_grad():
        y = pt.fused_cross_sublayer(x, p, cache, **kw)
        ref = pt.fused_cross_sublayer(x, p, cache, **kw, impl="plain")
    torch.cuda.synchronize()
    assert pt.launch_counts[pt.single_launch_key(
        torch.bfloat16, C // H, quant=True)] == 1
    assert y.dtype == x_dt
    err = _rel(y, ref)
    upd = _rel(y.float() - x.float(), ref.float() - x.float())
    print(f"K3 single int8 heads of {C // H} rms={rms} q_block={q_block} "
          f"{x_dt}: rel_l2 {err:.3e} update {upd:.3e}")
    assert err <= 3e-3 and upd <= 2e-2, (err, upd)


def _grads(fn, ins, gy):
    ins = [a.detach().requires_grad_(a.is_floating_point()) for a in ins]
    return torch.autograd.grad(fn(*ins), ins, gy, allow_unused=True)


def test_sublayer_backward_matches_plain_autograd(dev, monkeypatch):
    """Each Function's gradients against torch's autograd through its plain
    function (the oracle), with the recomputation's chunking forced to one
    modulation group (K1, K4) or batch row (K3) at a time."""
    monkeypatch.setattr(pt, "_BWD_SCORES", 1)
    r = np.random.default_rng(6)
    C, B, L = 128, 4, 64
    d = lambda *s, **k: _t(r, *s, dev=dev, **k)  # noqa: E731
    x = d(B, L, C)
    mods = [d(2, C, scale=0.3) for _ in range(3)]
    sw = [d(C, 3 * C, scale=C ** -0.5), d(3 * C, scale=0.1),
          d(C, shift=1.0, scale=0.1), d(C, shift=1.0, scale=0.1),
          d(C, C, scale=C ** -0.5), d(C, scale=0.1)]
    rep = lambda a: a.repeat_interleave(2, 0)  # noqa: E731
    gy = d(B, L, C)
    cases = {
        "self": (lambda x, *a: pt.fused_self_sublayer(
            x, *a, num_heads=4, mod_repeat=2),
                 lambda x, s, c, g, *w: pt.self_sublayer_reference(
            x, rep(s), rep(c), rep(g), *w, num_heads=4),
                 [x, *mods, *sw]),
        "mlp": (lambda x, *a: pt.fused_mlp_sublayer(x, *a, mod_repeat=2),
                lambda x, s, c, g, *w: pt.mlp_sublayer_reference(
            x, rep(s), rep(c), rep(g), *w),
                [x, *mods, d(C, 256, scale=C ** -0.5), d(256, scale=0.1),
                 d(256, C, scale=256 ** -0.5), d(C, scale=0.1)]),
    }
    p1, kv1 = _single_case(r, dev, C, 4, B, L, 37, torch.bfloat16, False)
    p2, kv2 = _single_case(r, dev, C, 4, B, L, 20, torch.bfloat16, False)
    flat = [x, *p1, *kv1, *p2, *kv2]

    def split(ts):
        return (ts[0], tuple(ts[1:7]), tuple(ts[7:9]), tuple(ts[9:15]),
                tuple(ts[15:17]))

    cases["cross"] = (
        lambda *ts: pt.fused_cross_sublayer(*split(ts), num_heads=4),
        lambda *ts: pt.cross_sublayer_reference(*split(ts), num_heads=4),
        flat)
    x4 = d(2, 8, 16, C)
    cases["temporal"] = (
        lambda *a: pt.fused_temporal_sublayer(*a, num_heads=4),
        lambda *a: pt.temporal_sublayer_reference(*a, num_heads=4),
        [x4, *mods, *sw])
    for key, (fn, ref, ins) in cases.items():
        g = gy if key != "temporal" else d(*x4.shape)
        got, want = _grads(fn, ins, g), _grads(ref, ins, g)
        worst = max(_rel(a, b) for a, b in zip(got, want))
        print(f"backward of {key}: worst gradient rel_l2 {worst:.3e}")
        assert worst <= GRAD_BOUND, (key, worst)


def test_k5_bias_gradient_with_segments(dev):
    r = np.random.default_rng(7)
    q, k, v = (_t(r, 2, 192, 2, 64, dev=dev, dt=torch.float32)
               for _ in range(3))
    b = _bias(r, 2, 192, "soft", dev)
    b[:, -20:] = float("-inf")
    gy = _t(r, 2, 192, 2, 64, dev=dev, dt=torch.float32)
    seg = 48

    def plain(q, k, v, b):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.125 + b[:, None, None]
        rows = torch.arange(192, device=dev) // seg
        s = s.masked_fill(rows[:, None] != rows[None, :], float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)

    got = _grads(lambda *a: fa.fused_attention(
        *a[:3], 0.125, kv_bias=a[3], segment_size=seg), (q, k, v, b), gy)
    want = _grads(plain, (q, k, v, b), gy)
    worst = max(_rel(a, c) for a, c in zip(got, want))
    print(f"K5 backward, bias and segments: worst rel_l2 {worst:.3e}")
    assert worst <= K5_GRAD_BOUND, worst


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_dit_hoisted_cache_under_autograd(dev, kv_quant):
    """A 2-block bf16 DiT (C = 128, 4 heads of 32, N = 128, T = 8) with a
    hoisted cache takes the fused kernels under autograd; its gradients
    against the same DiT's impl="plain" run."""
    torch.manual_seed(0)
    dit = init_random_(DiT(in_channels=16, model_channels=128,
                           image_cond_channels=64, num_blocks=2, num_heads=4,
                           dtype=torch.bfloat16), 0).to(dev)
    r = np.random.default_rng(8)
    f = lambda *s: torch.tensor(r.standard_normal(s), dtype=torch.float32,  # noqa: E731
                                device=dev)
    x, ci, st, w = f(2, 8, 128, 16), f(2, 8, 20, 64), f(2, 128, 14), \
        f(2, 8, 128, 16)
    pos = torch.tensor(r.uniform(-0.5, 0.5, (2, 128, 3)),
                       dtype=torch.float32, device=dev)
    t = torch.tensor([500.0, 250.0], device=dev)

    def run(impl):
        dit.zero_grad(set_to_none=True)
        xg = x.clone().requires_grad_(True)
        out = dit(xg, t, positions=pos,
                  cross_kv=dit.kv_cache(ci, st, kv_quant), impl=impl)
        (out.float() * w).sum().backward()
        return [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                for p in dit.parameters()] + [xg.grad]

    pt.reset_launch_counts()
    got = run(None)
    counts = {k: n for k, n in pt.launch_counts.items() if n}
    assert counts == {"self": 2, "temporal": 2, "mlp": 2,
                      ("cross_q8" if kv_quant else "cross"): 2}, counts
    want = run("plain")
    errs = [_rel(a, b) for a, b in zip(got, want) if b.abs().any()]
    print(f"DiT kv_quant={kv_quant}: worst gradient rel_l2 {max(errs):.3e}")
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert max(errs) <= DIT_GRAD_BOUND, max(errs)
