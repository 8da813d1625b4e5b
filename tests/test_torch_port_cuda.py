"""The hand-written CUDA kernels against their plain torch versions on the
card (bf16), at small and ragged shapes: for the sublayers (K1-K4) query
lengths that are not multiples of the 64-row tile, frame counts 8 to 70,
and cross key lengths 37, 20, 130 and 1374; for the attention kernel (K5)
lengths 1 to 1374 around the 64-key tile, q/k/v read in place from a qkv
projection or from separate tensors, logits far beyond the TPU kernel's
fixed shift, the cross form (Lq != Lk, k/v the halves of a kv projection)
and the kv_bias form (a fully masked row, valid counts off the 64-key
tile); for the single-context cross sublayer (K3 at heads of 64) query
counts 100 and 128, key lengths 37 and 1374, bf16 and fp32 residual
streams. Every test here needs a CUDA device and skips
without one; run them on the GPU with

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q

K7 (the flash attention over key validity, heads of 64) runs at key
lengths 70, 4097 and 32768 with prefix, scattered and empty validity, and
in fp32 and at heads of 32 and 128 (both dtypes) over 4097 keys; its
backward (fp32, heads of 64: the residual forward, the dkv and dq kernels)
at 70 and 4097 keys with the same validities (FLASH_BWD_BOUND); K3's
single context at compute_dtype=float32 at key lengths 37 and 1374;
K3's int8 form at the DiT's heads of 32 with both q-scale domains; K1 and
K2 with int8 QK (`quant_qk`) at several frames, N of 100, 128 and 512 and
T of 24 and 32 over 24 and 48 voxels (voxel groups of 8 and 16); the
multi-round, early-exit tile blend on the card against the CPU; the
Hopper attention core under K5 and K3's bf16 forms (`test_core_*`) at query
counts 128, 129, 1374 and 4097 against key counts 1, 63, 64, 65, 1374 and
4096 (its 128-row query tiles and 128-key tiles, 64-key at heads of 128),
heads of 32 and 64 in strided views, a fully masked bias row, fp32 in and
out, K3's two contexts at unequal key counts with and without the q RMS
norm, and K3's single context at heads of 32, 64 and 128; K1 on that core
(float, k's RMS norm in its fp32 producer) and on its int8-QK path
(attention_sm90_q8.cuh, s8 wgmma), and K3's int8 form on that path, at 1,
63, 64, 65, 127, 128, 129 and 257 rows (K1) or image keys (K3): every
K1 form (q/k RMS norms on and off, heads of 32 and 64, float and int8 QK)
and K3 int8's (shipped, q RMS norm, heads of 64) in both q-scale domains;
K1's gated out projection with GEMM tiles across frames and modulation
groups; K7 in bf16 on the core over its list of visited key tiles (a row
with no valid key, one tile, the last partial tile, two runs, every tile;
heads of 32, 64 and 128; every tile equal bit for bit to the list-free
core; more than 1024 tiles), and the fp32 forms on the core's 3xTF32 path
at 1-257 keys (K7 with its logsumexp and a row with no valid key, K3's
single context at heads of 32, 64 and 128); K2's attention over T alone
(csrc/temporal_sm90.cuh, through `temporal_sublayer_attention`), float
and int8 QK, at T of 1 to 128 around its 32-frame tiles and at 257 and
1024, heads of 32 and 64, voxel groups of 16, 8 and 1, one and three
batch rows (ATTN_BOUND); K4 at MLP widths 264, 1024 and 2048 over 400
rows, mod_repeat 1 and 2; K6 on the same kernel's fixed-shift forms
(`test_temporal_attention_core*`: T of 1 to 257 and 1024, heads of 32 and
64, fp32 and bf16 io, mixed row strides, a row whose P all underflow,
NaN in the same places as the plain version).

Tolerance, per kernel, the same bounds as chip_smoke.py (each a few times
the error measured on an H100 at the full shapes): rel L2 of the output y
and of the update y - x, <= (3e-3, 3e-2) for the attention sublayers and
(5e-4, 3e-3) for the MLP; FLASH_F32_BOUND and CROSS_F32_BOUNDS for the
fp32 forms of K7 and K3, whose kernels and plain versions differ by the
order of their fp32 sums alone; 3e-2 for a 2-block DiT forward;
ATTN_BOUND for K5's output and DINO_BOUND for a 2-block DINOv2's tokens
(bf16 and fp32 models, K5 computing in bf16 from either); GRAD_BOUND for
the gradients of K5 and K6 (the Functions' fp32 backward against autograd
through the bf16-rounded plain forward), COMPOSED_BOUNDS for the composed
DiT.
"""

import numpy as np
import pytest
import torch

from gvfdiffusion_torch.models.dinov2 import DinoV2, encode_image
from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.ops import fused_attention as fa
from gvfdiffusion_torch.ops import fused_sublayer as pt
from gvfdiffusion_torch.utils.weights import init_random_

pytestmark = pytest.mark.cuda

# (rel L2 of y, rel L2 of y - x) per sublayer
BOUNDS = {"self": (3e-3, 3e-2), "temporal": (3e-3, 3e-2),
          "cross": (3e-3, 3e-2), "mlp": (5e-4, 3e-3),
          "cross_single": (3e-3, 3e-2)}
ATTN_BOUND = 1e-2
DINO_BOUND = 2e-2
GRAD_BOUND = 2e-2  # readings 3.2e-3-4.5e-3
COMPOSED_BOUNDS = {"loss": 1e-5, "grads": 2e-3}  # readings 2.2e-6, 3.5e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


class _Draw:
    def __init__(self, dev, seed, C):
        self.r = np.random.default_rng(seed)
        self.dev, self.C = dev, C

    def __call__(self, *shape, scale=1.0, shift=0.0):
        a = self.r.standard_normal(shape) * scale + shift
        return torch.tensor(a, dtype=torch.bfloat16, device=self.dev)

    def mods(self, rows):
        return (self(rows, self.C, scale=0.3), self(rows, self.C, scale=0.3),
                self(rows, self.C, scale=0.5))

    def self_weights(self):
        C = self.C
        return (self(C, 3 * C, scale=C ** -0.5), self(3 * C, scale=0.1),
                self(C, shift=1.0, scale=0.1), self(C, shift=1.0, scale=0.1),
                self(C, C, scale=C ** -0.5), self(C, scale=0.1))

    def cross(self, B, lk):
        C = self.C
        p = (self(C, shift=1.0, scale=0.1), self(C, scale=0.1),
             self(C, C, scale=C ** -0.5), self(C, scale=0.1),
             self(C, C, scale=C ** -0.5), self(C, scale=0.1))
        return p, (self(B, lk, C), self(B, lk, C))


def _check(key, fn, x, args, kw):
    with torch.no_grad():
        y = fn(*args, **kw)
        ref = fn(*args, **kw, impl="plain")
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    upd = _rel(y.float() - x.float(), ref.float() - x.float())
    print(f"{key} {tuple(x.shape)}: rel_l2 {err:.3e} update_rel_l2 {upd:.3e}")
    y_bound, upd_bound = BOUNDS[key]
    assert err <= y_bound, err
    assert upd <= upd_bound, upd


@pytest.mark.parametrize("L", [100, 128])
@pytest.mark.parametrize("mod_repeat", [1, 2])
def test_self_kernel(dev, L, mod_repeat):
    d = _Draw(dev, 0, 128)
    x = d(4, L, 128)
    _check("self", pt.fused_self_sublayer, x,
           (x, *d.mods(4 // mod_repeat), *d.self_weights()),
           dict(num_heads=4, mod_repeat=mod_repeat))


@pytest.mark.parametrize("T", [8, 32, 70])
def test_temporal_kernel(dev, T):
    d = _Draw(dev, 1, 128)
    x = d(2, T, 24, 128)
    _check("temporal", pt.fused_temporal_sublayer, x,
           (x, *d.mods(2), *d.self_weights()), dict(num_heads=4))


@pytest.mark.parametrize("lks", [(37, 20), (130, 1374)])
def test_cross_kernel(dev, lks):
    d = _Draw(dev, 2, 128)
    x = d(4, 100, 128)
    args = [x]
    for lk in lks:
        args += list(d.cross(4, lk))
    _check("cross", pt.fused_cross_sublayer, x, args, dict(num_heads=4))


def test_mlp_kernel(dev):
    d = _Draw(dev, 3, 128)
    x = d(4, 100, 128)
    _check("mlp", pt.fused_mlp_sublayer, x,
           (x, *d.mods(2), d(128, 264, scale=128 ** -0.5), d(264, scale=0.1),
            d(264, 128, scale=264 ** -0.5), d(128, scale=0.1)),
           dict(mod_repeat=2))


def test_launch_counts_and_dtype_check(dev):
    d = _Draw(dev, 4, 128)
    x = d(2, 64, 128)
    args = (x, *d.mods(2), *d.self_weights())
    pt.reset_launch_counts()
    with torch.no_grad():
        pt.fused_self_sublayer(*args, num_heads=4)
        pt.fused_self_sublayer(*args, num_heads=4, impl="plain")
    assert {k: n for k, n in pt.launch_counts.items() if n} == {"self": 1}
    with pytest.raises(TypeError):
        pt.fused_self_sublayer(x.float(), *args[1:], num_heads=4)
    d48 = _Draw(dev, 4, 96)
    x48 = d48(2, 64, 96)
    with pytest.raises(ValueError):  # heads of 48: no rule admits them
        pt.fused_self_sublayer(x48, *d48.mods(2), *d48.self_weights(),
                               num_heads=2)


def test_dit_kernels_match_plain(dev):
    dit = init_random_(DiT(model_channels=128,
                           image_cond_channels=64, num_blocks=2, num_heads=4,
                           dtype=torch.bfloat16), seed=5).to(dev)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(1, 8, 128, 16, generator=g, device=dev)
    t = torch.tensor([300.0], device=dev)
    ci = torch.randn(1, 8, 20, 64, generator=g, device=dev)
    st = torch.randn(1, 128, 14, generator=g, device=dev)
    pos = torch.rand(1, 128, 3, generator=g, device=dev)
    with torch.no_grad():
        kv = dit(x, t, ci, st, pos, kv_only=True)
        y = dit(x, t, positions=pos, cross_kv=kv)
        ref = dit(x, t, positions=pos, cross_kv=kv, impl="plain")
    assert _rel(y, ref) <= 3e-2, _rel(y, ref)
    # an fp32 DiT on its cache: the fused sublayers compute in bf16 only,
    # so on the card it composes on the cache, the function it computes
    # without one (K5 and K6 on the same fp32 K/V either way)
    dit32 = init_random_(DiT(model_channels=128, image_cond_channels=64,
                             num_blocks=2, num_heads=4), seed=5).to(dev)
    with torch.no_grad():
        kv32 = dit32(x, t, ci, st, pos, kv_only=True)
        pt.reset_launch_counts()
        y32 = dit32(x, t, positions=pos, cross_kv=kv32)
        assert not any(pt.launch_counts.values()), pt.launch_counts
        ref32 = dit32(x, t, ci, st, pos)
    assert _rel(y32, ref32) <= 1e-5, _rel(y32, ref32)


def _attend(dev, L, layout, B=2, H=3, scale=1.0, seed=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "qkv":  # views of one [B, L, 3, H, 64] projection
        qkv = (torch.randn(B, L, 3, H, 64, generator=g, device=dev)
               * scale).bfloat16()
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return [(torch.randn(B, L, H, 64, generator=g, device=dev)
             * scale).bfloat16() for _ in range(3)]


@pytest.mark.parametrize("layout", ["qkv", "separate"])
@pytest.mark.parametrize("L", [1, 30, 64, 65, 130, 173, 1374])
def test_attention_kernel(dev, L, layout):
    q, k, v = _attend(dev, L, layout)
    y = fa.fused_attention(q, k, v, 0.125)
    ref = fa.fused_attention(q, k, v, 0.125, impl="plain")
    torch.cuda.synchronize()
    assert y.shape == q.shape and y.dtype == torch.bfloat16
    assert y.is_contiguous() and bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"attention L={L} {layout}: rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


def test_attention_kernel_large_logits(dev):
    """Scaled logits of several hundred: past the TPU kernel's exp2 shift of
    30 (safe to about +-90); the running maximum keeps the kernel exact."""
    q, k, v = _attend(dev, 200, "qkv", scale=12.0)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 0.125
    assert float(s.abs().max()) > 300
    y = fa.fused_attention(q, k, v, 0.125)
    ref = fa.fused_attention(q, k, v, 0.125, impl="plain")
    assert bool(torch.isfinite(y).all())
    assert _rel(y, ref) <= ATTN_BOUND, _rel(y, ref)


def test_attention_launch_counts_and_checks(dev):
    q, k, v = _attend(dev, 70, "qkv")
    fa.reset_launch_counts()
    fa.fused_attention(q, k, v, 0.125)
    fa.fused_attention(q, k, v, 0.125, impl="plain")
    fa.fused_attention(q[:, :10], k, v, 0.125, cross=True)
    fa.fused_attention(q, k, v, 0.125,
                       kv_bias=torch.zeros(2, 70, device=dev))
    fa.fused_attention(q, k, v, 0.125, cross=True)  # Lq = Lk, yet cross
    fa.fused_attention(*(a[..., :32].float() for a in (q, k, v)), 0.125)
    assert {k: n for k, n in fa.launch_counts.items() if n} == {
        "attention": 1, "attention_cross": 2, "attention_bias": 1,
        "attention_d32": 1}
    with pytest.raises(TypeError):  # q fp32, k/v bf16
        fa.fused_attention(q.float(), k, v, 0.125)
    with pytest.raises(ValueError):  # heads of 12: no rule admits them
        fa.fused_attention(*(a[..., :12].contiguous() for a in (q, k, v)),
                           0.125)
    with pytest.raises(ValueError):  # k's batch is not q's
        fa.fused_attention(q[:1], k, v, 0.125)
    with pytest.raises(TypeError):  # a bf16 bias
        fa.fused_attention(q, k, v, 0.125, kv_bias=torch.zeros(
            2, 70, device=dev, dtype=torch.bfloat16))


@pytest.mark.parametrize("Lq,Lk", [(1, 30), (65, 64), (173, 130),
                                   (512, 1374)])
def test_attention_kernel_cross(dev, Lq, Lk):
    """q from its own projection, k/v the halves of one [B, Lk, 2, H, 64]
    kv projection (read in place)."""
    g = torch.Generator(device=dev).manual_seed(10)
    q = torch.randn(2, Lq, 3, 64, generator=g, device=dev).bfloat16()
    kv = torch.randn(2, Lk, 2, 3, 64, generator=g, device=dev).bfloat16()
    k, v = kv[:, :, 0], kv[:, :, 1]
    y = fa.fused_attention(q, k, v, 0.125)
    ref = fa.fused_attention(q, k, v, 0.125, impl="plain")
    torch.cuda.synchronize()
    assert y.shape == q.shape and bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"attention cross Lq={Lq} Lk={Lk}: rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


@pytest.mark.parametrize("L", [70, 173, 1374, 4096])
def test_attention_kernel_kv_bias(dev, L):
    """-inf on masked keys: row 0 keeps 101 keys (off the 64-key tile),
    row 1 none (its output must be exactly 0), row 2 a random half with a
    finite bias on the rest."""
    q, k, v = _attend(dev, L, "qkv", B=3)
    g = torch.Generator(device=dev).manual_seed(11)
    keep = torch.rand(3, L, generator=g, device=dev) < 0.5
    keep[0] = False
    keep[0, torch.randperm(L, generator=g, device=dev)[:min(101, L)]] = True
    keep[1] = False
    bias = torch.where(keep, 0.5 * torch.randn(3, L, generator=g, device=dev),
                       float("-inf"))
    y = fa.fused_attention(q, k, v, 0.125, kv_bias=bias)
    ref = fa.fused_attention(q, k, v, 0.125, kv_bias=bias, impl="plain")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and not bool(y[1].any())
    err = _rel(y, ref)
    print(f"attention kv_bias L={L}: rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("L,lk", [(100, 37), (128, 1374)])
def test_cross_single_kernel(dev, L, lk, x_dtype):
    """K3's single-context form at heads of 64 (C = 128, 2 heads); k and v
    are the halves of one [B, lk, 2C] projection."""
    d = _Draw(dev, 12, 128)
    x = d(3, L, 128).to(getattr(torch, x_dtype))
    p, _ = d.cross(3, lk)
    kv = d(3, lk, 256)
    args = (x, p, (kv[..., :128], kv[..., 128:]))
    with torch.no_grad():
        y = pt.fused_cross_sublayer(*args, num_heads=2)
        ref = pt.fused_cross_sublayer(*args, num_heads=2, impl="plain")
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    upd = _rel(y.float() - x.float(), ref.float() - x.float())
    print(f"cross_single L={L} lk={lk} {x_dtype}: rel_l2 {err:.3e} "
          f"update_rel_l2 {upd:.3e}")
    y_bound, upd_bound = BOUNDS["cross_single"]
    assert err <= y_bound and upd <= upd_bound, (err, upd)


def test_dinov2_kernels_match_plain(dev):
    """182^2: 13^2 patches + 5 tokens = 174, inside K5's rule (Lq >= 128)."""
    dino = init_random_(DinoV2(img_size=182, embed_dim=128, depth=2,
                               num_heads=2, dtype=torch.bfloat16),
                        seed=8).to(dev)
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.rand(3, 182, 182, 3, generator=g, device=dev)
    fa.reset_launch_counts()
    y = encode_image(dino, x)
    assert fa.launch_counts["attention"] == 2
    ref = encode_image(dino, x, impl="plain")
    assert y.shape == (3, 174, 128)
    assert _rel(y, ref) <= DINO_BOUND, _rel(y, ref)
    # an fp32 model on the card: K5 computes in bf16 from its fp32 q/k/v, as
    # JAX calls it on its chip, and its plain version on the card likewise
    dino32 = init_random_(DinoV2(img_size=182, embed_dim=128, depth=2,
                                 num_heads=2), seed=8).to(dev)
    fa.reset_launch_counts()
    y32 = encode_image(dino32, x)
    assert fa.launch_counts["attention"] == 2
    ref32 = encode_image(dino32, x, impl="plain")
    assert _rel(y32, ref32) <= DINO_BOUND, _rel(y32, ref32)


def test_attention_outside_the_kernels_raises(dev):
    """On the card, attention outside K5's rule takes the library call, as
    the JAX package takes XLA's attention there (no K5 launch, the same
    function); K6's outside its rule JAX's einsum form; full sparse
    attention over more than 4096 keys takes the flash kernel K7, which
    raises for heads it does not take (every multiple of 8 up to 1024 it
    takes)."""
    import torch.nn.functional as F
    from gvfdiffusion_torch.nn.attention import scaled_dot_product_attention
    from gvfdiffusion_torch.ops import flash_attention as fl
    from gvfdiffusion_torch.sparse.attention import full_sparse_attention

    q, k, v = _attend(dev, 100, "separate")
    fa.reset_launch_counts()
    y = scaled_dot_product_attention(q, k, v, torch.bfloat16)
    assert not any(fa.launch_counts.values())
    ref = F.scaled_dot_product_attention(
        *(a.transpose(1, 2) for a in (q, k, v))).transpose(1, 2)
    assert torch.equal(y, ref)
    q, k, v = (torch.zeros(1, L, 1, 64, device=dev, dtype=torch.bfloat16)
               for L in (4096, 4100, 4100))
    valid = torch.ones(1, 4100, dtype=torch.bool, device=dev)
    fl.reset_launch_counts()
    full_sparse_attention(q, k, v, valid[:, :4096], valid, torch.bfloat16)
    assert fl.launch_counts["flash_attention"] == 1
    # K7 runs heads of 16 padded to 32, and of 256 on its wide kernels;
    # above 1024 it has none
    full_sparse_attention(*(a[..., :16].contiguous() for a in (q, k, v)),
                          valid[:, :4096], valid, torch.bfloat16)
    assert fl.launch_counts["flash_attention_d16"] == 1
    full_sparse_attention(*(torch.cat([a] * 4, -1) for a in (q, k, v)),
                          valid[:, :4096], valid, torch.bfloat16)
    assert fl.launch_counts["flash_attention_d256"] == 1
    with pytest.raises(ValueError, match="heads of"):
        full_sparse_attention(*(torch.cat([a] * 17, -1) for a in (q, k, v)),
                              valid[:, :4096], valid, torch.bfloat16)
    from gvfdiffusion_torch.nn.attention import MultiHeadAttention

    attn = MultiHeadAttention(96, 3, qk_rms_norm=True).to(dev)  # 96 lanes
    x = torch.randn(1, 8, 16, 96, device=dev)
    fa.reset_launch_counts()
    with torch.no_grad():
        y = attn.temporal(x, torch.float32)
    assert not any(fa.launch_counts.values())
    with torch.no_grad():
        ref = attn.cpu().temporal(x.cpu(), torch.float32)
    assert torch.allclose(y.cpu(), ref, rtol=1e-4, atol=1e-4)


# -- the DiT's training path: K5 at heads of 32, K6, the composed DiT ---------


def _grads(fn, inputs, g):
    ins = [a.detach().clone().requires_grad_(True) for a in inputs]
    out = fn(*ins)
    out.backward(g)
    return out.detach(), [a.grad for a in ins]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq,Lk", [(130, 130), (512, 1374), (200, 70)])
def test_attention_kernel_d32(dev, Lq, Lk, dtype):
    """K5 at heads of 32 (fixed exp2 shift), q apart, k/v the halves of a
    kv projection; output in q's dtype."""
    g = torch.Generator(device=dev).manual_seed(13)
    dt = getattr(torch, dtype)
    q = torch.randn(3, Lq, 4, 32, generator=g, device=dev).to(dt)
    kv = torch.randn(3, Lk, 2, 4, 32, generator=g, device=dev).to(dt)
    k, v = kv[:, :, 0], kv[:, :, 1]
    y = fa.fused_attention(q, k, v, 32 ** -0.5, cross=True)
    ref = fa.fused_attention(q, k, v, 32 ** -0.5, impl="plain")
    torch.cuda.synchronize()
    assert y.dtype == dt and y.shape == q.shape
    assert bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"attention d32 {dtype} Lq={Lq} Lk={Lk}: rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_d32_kv_bias(dev, dtype):
    """K5 at heads of 32 with a key bias (the fixed shift takes 30 - bias
    * log2 e): row 0 keeps 101 keys, row 1 none (exactly 0), row 2 a
    random half with a finite bias."""
    g = torch.Generator(device=dev).manual_seed(21)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(3, L, 4, 32, generator=g, device=dev).to(dt)
               for L in (130, 200, 200))
    keep = torch.rand(3, 200, generator=g, device=dev) < 0.5
    keep[0] = False
    keep[0, torch.randperm(200, generator=g, device=dev)[:101]] = True
    keep[1] = False
    bias = torch.where(keep, 0.5 * torch.randn(3, 200, generator=g,
                                               device=dev), float("-inf"))
    fa.reset_launch_counts()
    y = fa.fused_attention(q, k, v, 32 ** -0.5, kv_bias=bias)
    assert fa.launch_counts["attention_bias_d32"] == 1
    ref = fa.fused_attention(q, k, v, 32 ** -0.5, kv_bias=bias, impl="plain")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and not bool(y[1].any())
    err = _rel(y, ref)
    print(f"attention d32 kv_bias {dtype}: rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


def test_attention_d32_gradients(dev):
    g = torch.Generator(device=dev).manual_seed(14)
    q, k, v, go = (torch.randn(4, L, 4, 32, generator=g, device=dev)
                   for L in (512, 1374, 1374, 512))
    scale = 32 ** -0.5
    y, grads = _grads(lambda *a: fa.fused_attention(*a, scale), (q, k, v), go)
    yp, grads_p = _grads(lambda *a: fa.fused_attention(*a, scale,
                                                       impl="plain"),
                         (q, k, v), go)
    torch.cuda.synchronize()
    assert _rel(y, yp) <= ATTN_BOUND
    errs = [_rel(a, b) for a, b in zip(grads, grads_p)]
    print(f"attention d32 gradients rel_l2 {errs}")
    assert max(errs) <= GRAD_BOUND, errs


@pytest.mark.parametrize("Lq,Lk", [(512, 512), (512, 1374), (200, 70)])
def test_attention_kernel_d64_fp32(dev, Lq, Lk):
    """K5 at heads of 64 in fp32, as the 8-head DiT trains: q apart, k/v
    the halves of a kv projection; the output, then the gradients through
    the autograd Function against autograd of the plain version."""
    g = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn(3, Lq, 4, 64, generator=g, device=dev)
    kv = torch.randn(3, Lk, 2, 4, 64, generator=g, device=dev)
    go = torch.randn(3, Lq, 4, 64, generator=g, device=dev)
    k, v = kv[:, :, 0], kv[:, :, 1]
    scale = 64 ** -0.5
    fa.reset_launch_counts()
    y = fa.fused_attention(q, k, v, scale, cross=True)
    assert fa.launch_counts["attention_cross"] == 1
    ref = fa.fused_attention(q, k, v, scale, impl="plain")
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == q.shape
    assert bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    _, grads = _grads(lambda *a: fa.fused_attention(*a, scale), (q, k, v),
                      go)
    _, grads_p = _grads(lambda *a: fa.fused_attention(*a, scale,
                                                      impl="plain"),
                        (q, k, v), go)
    errs = [_rel(a, b) for a, b in zip(grads, grads_p)]
    print(f"attention d64 fp32 Lq={Lq} Lk={Lk}: rel_l2 {err:.3e}, "
          f"gradients {errs}")
    assert err <= ATTN_BOUND, err
    assert max(errs) <= GRAD_BOUND, errs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [24, 32, 23, 70])
def test_temporal_attention_kernel(dev, T, dtype):
    """K6 on [2, T, 8, 4, 32]; q apart, k/v views of a qkv projection (row
    stride 3 * H * D)."""
    g = torch.Generator(device=dev).manual_seed(15)
    dt = getattr(torch, dtype)
    qkv = torch.randn(2, T, 8, 3, 4, 32, generator=g, device=dev).to(dt)
    q = torch.randn(2, T, 8, 4, 32, generator=g, device=dev).to(dt)
    k, v = qkv[..., 1, :, :], qkv[..., 2, :, :]
    fa.reset_launch_counts()
    y = fa.temporal_attention(q, k, v, 32 ** -0.5)
    assert fa.launch_counts["temporal_attention"] == 1
    ref = fa.temporal_attention(q, k, v, 32 ** -0.5, impl="plain")
    torch.cuda.synchronize()
    assert y.dtype == dt and y.shape == q.shape and y.is_contiguous()
    assert bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"temporal attention {dtype} T={T}: rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


def test_temporal_attention_gradients(dev):
    g = torch.Generator(device=dev).manual_seed(16)
    q, k, v, go = (torch.randn(2, 24, 64, 4, 32, generator=g, device=dev)
                   for _ in range(4))
    scale = 32 ** -0.5
    y, grads = _grads(lambda *a: fa.temporal_attention(*a, scale), (q, k, v),
                      go)
    yp, grads_p = _grads(lambda *a: fa.temporal_attention(*a, scale,
                                                          impl="plain"),
                         (q, k, v), go)
    torch.cuda.synchronize()
    assert _rel(y, yp) <= ATTN_BOUND
    errs = [_rel(a, b) for a, b in zip(grads, grads_p)]
    print(f"temporal attention gradients rel_l2 {errs}")
    assert max(errs) <= GRAD_BOUND, errs


def test_composed_dit_kernels_match_plain(dev):
    """A 2-block fp32 DiT (C = 128, heads of 32) without a hoisted KV: the
    composed path's loss and gradients, kernels against impl="plain"."""
    dit = init_random_(DiT(model_channels=128, image_cond_channels=64,
                           num_blocks=2, num_heads=4), seed=17).to(dev)
    g = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn(2, 8, 128, 16, generator=g, device=dev)
    t = torch.tensor([300.0, 20.0], device=dev)
    ci = torch.randn(2, 8, 130, 64, generator=g, device=dev)
    st = torch.randn(2, 128, 14, generator=g, device=dev)
    pos = torch.rand(2, 128, 3, generator=g, device=dev)

    def run(impl):
        dit.zero_grad(set_to_none=True)
        loss = dit(x, t, ci, st, pos, impl=impl).square().mean()
        loss.backward()
        return float(loss.detach()), torch.cat([p.grad.flatten()
                                       for p in dit.parameters()])

    fa.reset_launch_counts()
    loss, grads = run(None)
    assert fa.launch_counts["attention_d32"] == 2
    assert fa.launch_counts["attention_cross_d32"] == 4
    assert fa.launch_counts["temporal_attention"] == 2
    loss_p, grads_p = run("plain")
    torch.cuda.synchronize()
    errs = {"loss": abs(loss - loss_p) / abs(loss_p),
            "grads": _rel(grads, grads_p)}
    print(f"composed DiT kernels vs plain: {errs}")
    assert all(errs[k] <= b for k, b in COMPOSED_BOUNDS.items()), errs


# -- K7 and K3's int8 form ------------------------------------------------------


FLASH_BOUND = 1e-2  # as K5's running-maximum form (ATTN_BOUND)


def _flash_validity(dev, kind, B, Lk, g):
    """Prefix (as the downsample packs parents), scattered, or empty (batch
    row 0 has no valid key)."""
    valid = torch.zeros(B, Lk, dtype=torch.bool, device=dev)
    if kind == "prefix":
        valid[0, :max(1, Lk // 9)] = True
        valid[1:, :Lk - 3] = True
    elif kind == "scattered":
        valid = torch.rand(B, Lk, generator=g, device=dev) < 0.12
        valid[:, 0] = True
    else:
        valid[1:] = torch.rand(B - 1, Lk, generator=g, device=dev) < 0.5
    return valid


@pytest.mark.parametrize("kind", ["prefix", "scattered", "empty"])
@pytest.mark.parametrize("Lq,Lk", [(130, 70), (200, 4097), (1024, 32768)])
def test_flash_attention_kernel(dev, Lq, Lk, kind):
    """K7 against its plain version on every query row; v read in place as
    the view of a [B, Lk, 3, H, 64] projection, as the torso passes it."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    g = torch.Generator(device=dev).manual_seed(21)
    B, H = 2, 3
    q = torch.randn(B, Lq, H, 64, generator=g, device=dev).bfloat16()
    k = torch.randn(B, Lk, H, 64, generator=g, device=dev).bfloat16()
    v = torch.randn(B, Lk, 3, H, 64, generator=g,
                    device=dev).bfloat16()[:, :, 2]
    valid = _flash_validity(dev, kind, B, Lk, g)
    y = fl.flash_attention(q, k, v, valid, 0.125)
    ref = fl.flash_attention(q, k, v, valid, 0.125, impl="plain")
    torch.cuda.synchronize()
    assert y.shape == q.shape and y.dtype == torch.bfloat16
    assert bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"flash Lq={Lq} Lk={Lk} {kind}: rel_l2 {err:.3e}")
    assert err <= FLASH_BOUND, err
    if kind == "empty":  # sum(V) / Lk padded to 512, in every row
        want = v[0].float().sum(0) / fl.padded_keys(Lk)
        assert _rel(y[0], want.expand_as(y[0])) <= FLASH_BOUND


def test_flash_attention_counts_and_checks(dev):
    from gvfdiffusion_torch.ops import flash_attention as fl

    q, k, v = _attend(dev, 70, "separate")
    valid = torch.ones(2, 70, dtype=torch.bool, device=dev)
    fl.reset_launch_counts()
    fl.flash_attention(q, k, v, valid, 0.125)
    fl.flash_attention(q, k, v, valid, 0.125, impl="plain")
    fl.flash_attention(q.float(), k.float(), v.float(), valid, 0.125)
    fl.flash_attention(*(a[..., :32].contiguous() for a in (q, k, v)),
                       valid, 0.125)
    fl.flash_attention(*(torch.cat([a, a, a[..., :8]], -1)
                         for a in (q, k, v)), valid, 0.125)  # 136: wide
    assert {k_: n for k_, n in fl.launch_counts.items() if n} == {
        "flash_attention": 1, "flash_attention_fp32": 1,
        "flash_attention_d32": 1, "flash_attention_d136": 1}
    with pytest.raises(TypeError):  # fp32 q with bf16 k/v: never cast
        fl.flash_attention(q.float(), k, v, valid, 0.125)
    with pytest.raises(ValueError, match="heads of"):  # heads of 1088
        fl.flash_attention(*(torch.cat([a] * 17, -1)
                             for a in (q, k, v)), valid, 0.125)
    with pytest.raises(TypeError):  # a float validity
        fl.flash_attention(q, k, v, valid.float(), 0.125)
    fl.reset_launch_counts()  # under grad: the forward with its residual
    fl.flash_attention(q.requires_grad_(), k, v, valid, 0.125)
    assert {k_: n for k_, n in fl.launch_counts.items() if n} == {
        "flash_attention_res": 1}


# K7 in bf16 runs the Hopper core over each batch row's list of the key
# tiles that hold a valid key (128 keys at heads of 32 and 64, 64 at 128)


def _tile_validity(dev, layout, Lk):
    """Two batch rows whose lists differ: an empty row, one tile, the last
    (partial) tile alone, two runs more than two tiles apart, every tile."""
    valid = torch.zeros(2, Lk, dtype=torch.bool, device=dev)
    if layout == "empty_row":  # row 0 none; row 1 two runs
        valid[1, 10:90] = valid[1, 700:760] = True
    elif layout == "one_tile":  # a few keys inside one tile; one key
        valid[0, 300:310] = True
        valid[1, 5] = True
    elif layout == "last_partial":  # the ragged last tile only
        valid[0, Lk - 1] = True
        valid[1, Lk - 20:] = True
    elif layout == "two_runs":
        valid[0, :100] = valid[0, 700:800] = True
        valid[1, 1:2] = valid[1, Lk - 300:Lk - 290] = True
    else:  # "every_tile": one valid key in each 64-key stretch
        valid[:, ::64] = True
    return valid


@pytest.mark.parametrize("layout", ["empty_row", "one_tile", "last_partial",
                                    "two_runs", "every_tile"])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_core_tile_lists(dev, D, layout):
    """K7 bf16 against its plain version at Lk = 1100 (ragged at 64 and
    128 keys), 129 query rows (a ragged 128-row query tile), v a qkv view;
    a row with no valid key gives sum(V) / lk_pad on every query row."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    g = torch.Generator(device=dev).manual_seed(23)
    B, H, Lq, Lk = 2, 3, 129, 1100
    q = torch.randn(B, Lq, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(B, Lk, H, D, generator=g, device=dev).bfloat16()
    v = torch.randn(B, Lk, 3, H, D, generator=g,
                    device=dev).bfloat16()[:, :, 2]
    valid = _tile_validity(dev, layout, Lk)
    fl.reset_launch_counts()
    y = fl.flash_attention(q, k, v, valid, D ** -0.5)
    ref = fl.flash_attention(q, k, v, valid, D ** -0.5, impl="plain")
    torch.cuda.synchronize()
    assert fl.launch_counts[fl.launch_key(torch.bfloat16, D)] == 1
    assert y.shape == q.shape and bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"flash tiles D={D} {layout}: rel_l2 {err:.3e}")
    assert err <= FLASH_BOUND, err
    if layout == "empty_row":
        want = v[0].float().sum(0) / fl.padded_keys(Lk)
        assert _rel(y[0], want.expand_as(y[0])) <= FLASH_BOUND


@pytest.mark.parametrize("Lk", [1, 100, 1100, 4097])
def test_flash_core_every_tile_is_the_core(dev, Lk):
    """With every key valid, K7's list names every tile and its bias row is
    0: the output equals, bit for bit, the list-free core's (K5 at heads of
    64, the same running-maximum instantiation)."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    g = torch.Generator(device=dev).manual_seed(24)
    B, H, Lq = 2, 3, 300
    q = torch.randn(B, Lq, H, 64, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(B, Lk, H, 64, generator=g, device=dev).bfloat16()
            for _ in range(2))
    valid = torch.ones(B, Lk, dtype=torch.bool, device=dev)
    with torch.no_grad():
        y = fl.flash_attention(q, k, v, valid, 0.125)
        want = fa.fused_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(y.reshape(want.shape), want)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_core_long_key_list(dev, D):
    """More than 1024 key tiles (the list's compaction runs in chunks of
    1024 tiles): 140000 keys, valid in four runs and one lone key."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    g = torch.Generator(device=dev).manual_seed(25)
    B, H, Lq, Lk = 1, 2, 64, 140000
    q = torch.randn(B, Lq, H, D, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(B, Lk, H, D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    valid = torch.zeros(B, Lk, dtype=torch.bool, device=dev)
    for a in (0, 65600, 70000, 131000):
        valid[0, a:a + 200] = True
    valid[0, Lk - 1] = True
    y = fl.flash_attention(q, k, v, valid, D ** -0.5)
    ref = fl.flash_attention(q, k, v, valid, D ** -0.5, impl="plain")
    torch.cuda.synchronize()
    err = _rel(y, ref)
    print(f"flash long list D={D}: rel_l2 {err:.3e}")
    assert err <= FLASH_BOUND, err


# K7 in fp32 against its plain version: both fp32 throughout (FFMA in the
# kernel, fp32 einsums in the plain version), so they differ by the order
# of the sums alone
FLASH_F32_BOUND = 1e-5


@pytest.mark.parametrize("kind", ["prefix", "scattered", "empty"])
@pytest.mark.parametrize("dtype,D", [("float32", 64), ("float32", 32),
                                     ("float32", 128), ("bfloat16", 32),
                                     ("bfloat16", 128)])
def test_flash_attention_kernel_forms(dev, dtype, D, kind):
    """K7 in fp32 and at heads of 32 and 128 (both dtypes), Lq = 200 over
    Lk = 4097 keys (a ragged last tile); v the view of a [B, Lk, 3, H, D]
    projection; the launch counted under its dtype and width."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    g = torch.Generator(device=dev).manual_seed(22)
    dt = getattr(torch, dtype)
    B, H, Lq, Lk = 2, 3, 200, 4097
    q = torch.randn(B, Lq, H, D, generator=g, device=dev).to(dt)
    k = torch.randn(B, Lk, H, D, generator=g, device=dev).to(dt)
    v = torch.randn(B, Lk, 3, H, D, generator=g, device=dev).to(dt)[:, :, 2]
    valid = _flash_validity(dev, kind, B, Lk, g)
    fl.reset_launch_counts()
    y = fl.flash_attention(q, k, v, valid, D ** -0.5)
    ref = fl.flash_attention(q, k, v, valid, D ** -0.5, impl="plain")
    torch.cuda.synchronize()
    assert fl.launch_counts[fl.launch_key(dt, D)] == 1
    assert y.shape == q.shape and y.dtype == dt
    assert bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"flash {dtype} D={D} {kind}: rel_l2 {err:.3e}")
    bound = FLASH_F32_BOUND if dt == torch.float32 else FLASH_BOUND
    assert err <= bound
    if kind == "empty":  # sum(V) / Lk padded to 512, in every row
        want = v[0].float().sum(0) / fl.padded_keys(Lk)
        assert _rel(y[0], want.expand_as(y[0])) <= bound


# K7's backward (fp32, heads of 64) against the plain backward: both fp32
# throughout, so they differ by the order of their sums (and the kernel's
# exp(s - lse) against the plain exp(s - m) / l)
FLASH_BWD_BOUND = 1e-5


@pytest.mark.parametrize("kind", ["prefix", "scattered", "empty"])
@pytest.mark.parametrize("Lq,Lk", [(130, 70), (200, 4097)])
def test_flash_attention_backward_kernels(dev, Lq, Lk, kind):
    """K7's residual forward, dkv and dq kernels (`FlashAttention` under
    grad) against the plain forward and backward on every query row, Lq
    != Lk (the static VAE's are equal; the kernels take both), a ragged
    last tile, q/k/v the views of one [B, L, 3, H, 64] projection as the
    VAE passes them; batch row 0 has no valid key in "empty", where every
    key gets dV = sum(dO) / Lk-padded-to-512."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    g = torch.Generator(device=dev).manual_seed(23)
    B, H, D = 2, 3, 64
    L = max(Lq, Lk)
    qkv = torch.randn(B, L, 3, H, D, generator=g, device=dev)
    valid = _flash_validity(dev, kind, B, Lk, g)
    do = torch.randn(B, Lq, H, D, generator=g, device=dev)
    outs = {}
    for impl in (None, "plain"):
        leaf = qkv.clone().requires_grad_(True)
        q, k, v = leaf[:, :Lq, 0], leaf[:, :Lk, 1], leaf[:, :Lk, 2]
        fl.reset_launch_counts()
        o = fl.flash_attention(q, k, v, valid, D ** -0.5, impl=impl)
        o.backward(do)
        outs[impl] = (o.detach(), leaf.grad[:, :Lq, 0], leaf.grad[:, :Lk, 1],
                      leaf.grad[:, :Lk, 2])
        if impl is None:
            torch.cuda.synchronize()
            assert {n: c for n, c in fl.launch_counts.items() if c} == {
                "flash_attention_fp32_res": 1, "flash_attention_bwd_dkv": 1,
                "flash_attention_bwd_dq": 1}
    for name, a, b in zip(("o", "dq", "dk", "dv"), outs[None], outs["plain"]):
        assert bool(torch.isfinite(a).all()), name
        err = _rel(a, b)
        print(f"flash bwd Lq={Lq} Lk={Lk} {kind} {name}: rel_l2 {err:.3e}")
        assert err <= FLASH_BWD_BOUND, (name, err)
    if kind == "empty":
        want = do[0].sum(0) / fl.padded_keys(Lk)
        assert _rel(outs[None][3][0], want.expand(Lk, H, D)) <= FLASH_BWD_BOUND


def test_static_vae_full_attention_kernels_under_remat(dev, monkeypatch):
    """A 2 + 2-block static VAE in `full` attention with every block
    recomputed in the backward pass (remat_blocks): K7's Function runs
    under torch.utils.checkpoint (its forward twice, its backward once a
    block) and the gradients equal the plain version's."""
    from gvfdiffusion_torch.models.static_vae import SparseTransformerVAE
    from gvfdiffusion_torch.ops import flash_attention as fl
    from gvfdiffusion_torch.sparse import attention as psa
    from gvfdiffusion_torch.sparse.tensor import from_lists

    monkeypatch.setattr(psa, "FLASH_SCORE_ELEMENTS", 1)
    r = np.random.default_rng(24)
    coords = [np.stack(np.unravel_index(r.choice(16 ** 3, n, replace=False),
                                        (16,) * 3), -1) for n in (150, 90)]
    feats = [r.standard_normal((len(c), 8)).astype(np.float32)
             for c in coords]
    x = from_lists(coords, feats, 16, capacity=200)
    x = x.replace(feats=x.feats.to(dev), coords=x.coords.to(dev),
                  valid=x.valid.to(dev))
    model = init_random_(SparseTransformerVAE(
        resolution=16, in_channels=8, model_channels=128, out_channels=14,
        latent_channels=4, num_blocks=2, num_heads=2, attn_mode="full",
        remat_blocks=2), seed=5).to(dev)
    w = torch.from_numpy(r.standard_normal((2, 200, 14)).astype(
        np.float32)).to(dev)
    grads = {}
    for impl in (None, "plain"):
        model.zero_grad()
        fl.reset_launch_counts()
        out, _, _ = model(x, False, impl=impl)
        (out.feats * w).sum().backward()
        torch.cuda.synchronize()
        grads[impl] = torch.cat([p.grad.flatten()
                                 for p in model.parameters()])
        if impl is None:
            assert {n: c for n, c in fl.launch_counts.items() if c} == {
                "flash_attention_fp32_res": 8, "flash_attention_bwd_dkv": 4,
                "flash_attention_bwd_dq": 4}
    assert _rel(grads[None], grads["plain"]) <= FLASH_BWD_BOUND


def test_flash_attention_backward_forms_raise(dev):
    """Under grad every form of the forward (bf16 and fp32, heads of 32, 64
    and 128) runs its residual forward, dkv and dq kernels; what the
    kernels do not take (heads of 1088, past K7's 1024; mixed dtypes)
    raises and never falls back to the plain version."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    valid = torch.ones(1, 70, dtype=torch.bool, device=dev)
    for dt in fl.DTYPES:
        for D in fl.HEAD_WIDTHS:
            q = torch.randn(1, 70, 2, D, device=dev, dtype=dt,
                            requires_grad=True)
            fl.reset_launch_counts()
            fl.flash_attention(q, q.detach(), q.detach(), valid,
                               D ** -0.5).sum().backward()
            torch.cuda.synchronize()
            assert {n: c for n, c in fl.launch_counts.items() if c} == {
                fl.grad_key(kind, dt, D): 1 for kind in fl.GRAD_KINDS}
            assert q.grad.dtype == dt and bool(torch.isfinite(q.grad).all())
    q = torch.randn(1, 70, 2, 1088, device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="heads of"):
        fl.flash_attention(q, q.detach(), q.detach(), valid, 0.25)
    q = torch.randn(1, 70, 2, 64, device=dev, requires_grad=True)
    with pytest.raises(TypeError):
        fl.flash_attention(q, q.detach().bfloat16(), q.detach().bfloat16(),
                           valid, 0.125)


# K3's single-context form at compute_dtype=float32 against its plain
# version: fp32 throughout, as K7 in fp32
CROSS_F32_BOUNDS = (1e-5, 1e-4)


@pytest.mark.parametrize("L,lk", [(100, 37), (128, 1374)])
def test_cross_single_kernel_fp32(dev, L, lk):
    """The fp32 chain (fp32 LN, FFMA projections and attention) at heads
    of 64 (C = 128, 2 heads); k and v the halves of one [B, lk, 2C]
    projection; a bf16 tensor is refused, never cast."""
    d = _Draw(dev, 13, 128)
    x = d(3, L, 128).float()
    p, _ = d.cross(3, lk)
    p = tuple(a.float() for a in p)
    kv = d(3, lk, 256).float()
    args = (x, p, (kv[..., :128], kv[..., 128:]))
    pt.reset_launch_counts()
    with torch.no_grad():
        y = pt.fused_cross_sublayer(*args, num_heads=2,
                                    compute_dtype=torch.float32)
        ref = pt.fused_cross_sublayer(*args, num_heads=2,
                                      compute_dtype=torch.float32,
                                      impl="plain")
        torch.cuda.synchronize()
        assert pt.launch_counts["cross_single_fp32"] == 1
        assert pt.launch_counts["cross_single"] == 0
        with pytest.raises(TypeError):  # bf16 weights at compute fp32
            pt.fused_cross_sublayer(
                x, tuple(a.bfloat16() for a in p), args[2], num_heads=2,
                compute_dtype=torch.float32)
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    upd = _rel(y - x, ref - x)
    print(f"cross_single fp32 L={L} lk={lk}: rel_l2 {err:.3e} update_rel_l2 "
          f"{upd:.3e}")
    assert err <= CROSS_F32_BOUNDS[0] and upd <= CROSS_F32_BOUNDS[1], (err,
                                                                       upd)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [32, 128])
def test_cross_single_kernel_heads(dev, D, dtype):
    """K3's single context at heads of 32 and 128 (C = 256: 8 heads or 2),
    bf16 (fp32 x, as the SLat torso's residual stream) and fp32, against
    the plain version; the launch goes to the counter of its dtype and
    width."""
    d = _Draw(dev, 14, 256)
    tdt = getattr(torch, dtype)
    x = d(2, 200, 256).float()
    p, _ = d.cross(2, 300)
    kv = d(2, 300, 512)
    if tdt == torch.float32:
        p, kv = tuple(a.float() for a in p), kv.float()
    args = (x, p, (kv[..., :256], kv[..., 256:]))
    key = pt.single_launch_key(tdt, D)
    pt.reset_launch_counts()
    with torch.no_grad():
        y = pt.fused_cross_sublayer(*args, num_heads=256 // D,
                                    compute_dtype=tdt)
        torch.cuda.synchronize()
        assert {k: n for k, n in pt.launch_counts.items() if n} == {key: 1}
        ref = pt.fused_cross_sublayer(*args, num_heads=256 // D,
                                      compute_dtype=tdt, impl="plain")
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    err, upd = _rel(y, ref), _rel(y - x, ref - x)
    print(f"{key}: rel_l2 {err:.3e} update_rel_l2 {upd:.3e}")
    bounds = CROSS_F32_BOUNDS if tdt == torch.float32 else \
        BOUNDS["cross_single"]
    assert err <= bounds[0] and upd <= bounds[1], (err, upd)


# The fp32 forms of K7 and K3's single context on the core's 3xTF32 path
# (attention_sm90_tf32.cuh: 64-key tiles, 32 at heads of 128) and K3's
# 3xTF32 GEMM, at key counts around those tiles


@pytest.mark.parametrize("Lk", [1, 31, 32, 33, 63, 64, 65, 127, 129, 257])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_f32_core_edges(dev, D, Lk):
    """K7 in fp32 with its logsumexp residual at 1-257 keys, 129 query rows
    (a ragged 128-row tile), batch row 0 with no valid key (sum(V) / lk_pad
    on every row, lse log(lk_pad)), row 1 valid on a scattered half with
    its last key; against the plain forward and the plain logsumexp."""
    from gvfdiffusion_torch.ops import flash_attention as fl

    g = torch.Generator(device=dev).manual_seed(26)
    B, H, Lq = 2, 2, 129
    q = torch.randn(B, Lq, H, D, generator=g, device=dev)
    k = torch.randn(B, Lk, H, D, generator=g, device=dev)
    v = torch.randn(B, Lk, 3, H, D, generator=g, device=dev)[:, :, 2]
    valid = torch.zeros(B, Lk, dtype=torch.bool, device=dev)
    valid[1] = torch.rand(Lk, generator=g, device=dev) < 0.5
    valid[1, -1] = True
    scale = D ** -0.5
    with torch.no_grad():
        o, lse, _, _ = fl.launch_forward(q, k, v, valid, scale, residual=True)
        y = fl.flash_attention(q, k, v, valid, scale)
        ref = fl.flash_attention(q, k, v, valid, scale, impl="plain")
    torch.cuda.synchronize()
    assert torch.equal(o, y) and bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"flash fp32 D={D} Lk={Lk}: rel_l2 {err:.3e}")
    assert err <= FLASH_F32_BOUND, err
    want = v[0].sum(0) / fl.padded_keys(Lk)
    assert _rel(y[0], want.expand_as(y[0])) <= FLASH_F32_BOUND
    s = torch.einsum("qhd,khd->hqk", q[1].double(),
                     k[1, valid[1]].double()) * scale
    assert torch.allclose(lse[1].double(), torch.logsumexp(s, -1),
                          rtol=0, atol=2e-5)
    assert torch.allclose(lse[0], torch.full_like(
        lse[0], float(np.log(fl.padded_keys(Lk)))))


@pytest.mark.parametrize("lk", [1, 63, 64, 65, 257])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_cross_single_fp32_edges(dev, D, lk):
    """K3's single context at compute_dtype=float32 (3xTF32 GEMMs and
    attention) at 1-257 keys, 129 rows (ragged 128-row GEMM and query
    tiles), C = 256, against the plain version."""
    d = _Draw(dev, 27, 256)
    x = d(2, 129, 256).float()
    p, _ = d.cross(2, lk)
    p = tuple(a.float() for a in p)
    kv = d(2, lk, 512).float()
    args = (x, p, (kv[..., :256], kv[..., 256:]))
    with torch.no_grad():
        y = pt.fused_cross_sublayer(*args, num_heads=256 // D,
                                    compute_dtype=torch.float32)
        ref = pt.fused_cross_sublayer(*args, num_heads=256 // D,
                                      compute_dtype=torch.float32,
                                      impl="plain")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    err, upd = _rel(y, ref), _rel(y - x, ref - x)
    print(f"cross_single fp32 D={D} lk={lk}: rel_l2 {err:.3e} "
          f"update_rel_l2 {upd:.3e}")
    assert err <= CROSS_F32_BOUNDS[0] and upd <= CROSS_F32_BOUNDS[1], (err,
                                                                       upd)


@pytest.mark.parametrize("model", ["ss_decoder", "dinov2"])
def test_fp32_convolutions_take_no_tf32(dev, model):
    """An fp32 model's convolutions (the occupancy decoder's, DINOv2's
    patch embedding) compute in fp32 on the card with cuDNN's TF32 on, its
    default, as a caller gets it: they agree with the same module on the
    CPU at fp32 level (TF32 would read ~1e-3)."""
    from gvfdiffusion_torch.models.trellis.ss_vae import (
        SparseStructureDecoder)

    g = torch.Generator().manual_seed(15)
    if model == "ss_decoder":
        m = SparseStructureDecoder(latent_channels=8, num_res_blocks=1,
                                   channels=(128, 64), num_res_blocks_middle=1)
        x = torch.randn(1, 8, 8, 8, 8, generator=g)
        fn = lambda mod, a: mod(a)
    else:
        m = DinoV2(img_size=56, embed_dim=256, depth=1, num_heads=4)
        x = torch.rand(1, 56, 56, 3, generator=g)
        fn = lambda mod, a: mod.patch_embed(a, torch.float32)
    m = init_random_(m, seed=16).eval()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            want = fn(m, x)
            got = fn(m.to(dev), x.to(dev)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert torch.backends.cudnn.allow_tf32 == prev
    err = _rel(got, want)
    print(f"{model} fp32 card vs CPU: rel_l2 {err:.3e}")
    assert err <= 1e-5, err


def _q8_case(dev, B, L, lks, seed):
    d = _Draw(dev, seed, 128)
    x = d(B, L, 128)
    args = [x]
    for lk in lks:
        p, (k, v) = d.cross(B, lk)
        kq, ks = pt.quantize_kv(k, 4)
        vq, vs = pt.quantize_kv(v, 4)
        args += [p, (kq, vq, ks.transpose(1, 2).contiguous(), vs)]
    return x, args


@pytest.mark.parametrize("L,lks,q_block", [(128, (37, 20), 0),
                                           (128, (37, 20), 64),
                                           (100, (130, 1374), 0)])
def test_cross_q8_kernel(dev, L, lks, q_block):
    """K3's int8 form (heads of 32) against its plain int8 version; q_block
    64 gives two q-scale cells per batch row of 128."""
    x, args = _q8_case(dev, 4, L, lks, seed=22)
    _check("cross", pt.fused_cross_sublayer, x, args,
           dict(num_heads=4, quant=True, q_block=q_block))


def test_cross_q8_counts_and_checks(dev):
    x, args = _q8_case(dev, 2, 64, (37, 20), seed=23)
    pt.reset_launch_counts()
    with torch.no_grad():
        pt.fused_cross_sublayer(*args, num_heads=4, quant=True)
        pt.fused_cross_sublayer(*args, num_heads=4, quant=True, impl="plain")
    assert {k: n for k, n in pt.launch_counts.items() if n} == {"cross_q8": 1}
    with torch.no_grad():
        with pytest.raises(TypeError):  # a bf16 k where the cache is int8
            bad = list(args)
            kq, vq, ks, vs = bad[2]
            bad[2] = (kq.bfloat16(), vq, ks, vs)
            pt.fused_cross_sublayer(*bad, num_heads=4, quant=True)
        with pytest.raises(ValueError):  # q_block does not divide L
            pt.fused_cross_sublayer(*args, num_heads=4, quant=True,
                                    q_block=48)
        # one context: its own chain, counted apart
        y1 = pt.fused_cross_sublayer(*args[:3], num_heads=4, quant=True)
        ref1 = pt.fused_cross_sublayer(*args[:3], num_heads=4, quant=True,
                                       impl="plain")
        assert pt.launch_counts["cross_single_q8_d32"] == 1
        assert _rel(y1, ref1) <= 3e-2, _rel(y1, ref1)


def test_dit_int8_cache_kernels_match_plain(dev):
    """A 2-block DiT on an int8 cache, kernels vs impl="plain", at B*T 8
    (whole-cell q scales) and 72 (halves, as at the 3-way CFG batch)."""
    dit = init_random_(DiT(model_channels=128, image_cond_channels=64,
                           num_blocks=2, num_heads=4, dtype=torch.bfloat16),
                       seed=5).to(dev)
    g = torch.Generator(device=dev).manual_seed(24)
    for Bx, Tx in ((1, 8), (3, 24)):
        x = torch.randn(Bx, Tx, 128, 16, generator=g, device=dev)
        t = torch.full((Bx,), 300.0, device=dev)
        ci = torch.randn(Bx, Tx, 20, 64, generator=g, device=dev)
        st = torch.randn(Bx, 128, 14, generator=g, device=dev)
        pos = torch.rand(Bx, 128, 3, generator=g, device=dev)
        pt.reset_launch_counts()
        with torch.no_grad():
            kv = dit.kv_cache(ci, st, kv_quant="int8")
            y = dit(x, t, positions=pos, cross_kv=kv)
            ref = dit(x, t, positions=pos, cross_kv=kv, impl="plain")
        assert pt.launch_counts["cross_q8"] == 2
        assert pt.launch_counts["cross"] == 0
        assert _rel(y, ref) <= 3e-2, _rel(y, ref)


@pytest.mark.parametrize("L", [100, 128, 512])
@pytest.mark.parametrize("mod_repeat", [1, 2])
def test_self_q8_kernel(dev, L, mod_repeat):
    """K1 with int8 QK: one q and one k scale per (frame, head)."""
    d = _Draw(dev, 25, 128)
    x = d(4, L, 128)
    _check("self", pt.fused_self_sublayer, x,
           (x, *d.mods(4 // mod_repeat), *d.self_weights()),
           dict(num_heads=4, mod_repeat=mod_repeat, quant_qk=True))


@pytest.mark.parametrize("T", [24, 32])
@pytest.mark.parametrize("N", [24, 48])
def test_temporal_q8_kernel(dev, T, N):
    """K2 with int8 QK: scales per (batch row, group of 8 or 16 voxels,
    head), attention over T per voxel."""
    d = _Draw(dev, 26, 128)
    x = d(2, T, N, 128)
    _check("temporal", pt.fused_temporal_sublayer, x,
           (x, *d.mods(2), *d.self_weights()),
           dict(num_heads=4, quant_qk=True))


def test_qk8_counts_and_checks(dev):
    d = _Draw(dev, 27, 128)
    x = d(2, 8, 32, 128)
    args = (x, *d.mods(2), *d.self_weights())
    pt.reset_launch_counts()
    with torch.no_grad():
        pt.fused_temporal_sublayer(*args, num_heads=4, quant_qk=True)
        pt.fused_temporal_sublayer(*args, num_heads=4, quant_qk=True,
                                   impl="plain")
        pt.fused_self_sublayer(x[0], *args[1:], num_heads=4, quant_qk=True,
                               mod_repeat=4)
    assert {k: n for k, n in pt.launch_counts.items() if n} == {
        "self_q8": 1, "temporal_q8": 1}
    with torch.no_grad(), pytest.raises(ValueError):  # 24 voxels in 16s
        pt.fused_temporal_sublayer(d(1, 8, 24, 128), *d.mods(1),
                                   *d.self_weights(), num_heads=4,
                                   quant_qk=True, voxel_group=16)
    # under grad: the float oracle's vjp, as JAX's custom_vjp
    xg = x[0].detach().requires_grad_()
    y = pt.fused_self_sublayer(xg, *args[1:], num_heads=4, quant_qk=True,
                               mod_repeat=4)
    (gx,) = torch.autograd.grad(y.float().sum(), xg)
    assert bool(torch.isfinite(gx).all()) and gx.abs().sum() > 0


def test_dit_self_quant_kernels_match_plain(dev):
    """A 2-block DiT with self_quant="int8" on an int8 cache, kernels vs
    impl="plain": K1 q8 and K2 q8 launch once per block."""
    dit = init_random_(DiT(model_channels=128, image_cond_channels=64,
                           num_blocks=2, num_heads=4, dtype=torch.bfloat16),
                       seed=6).to(dev)
    g = torch.Generator(device=dev).manual_seed(28)
    x = torch.randn(1, 24, 128, 16, generator=g, device=dev)
    t = torch.full((1,), 300.0, device=dev)
    ci = torch.randn(1, 24, 20, 64, generator=g, device=dev)
    st = torch.randn(1, 128, 14, generator=g, device=dev)
    pos = torch.rand(1, 128, 3, generator=g, device=dev)
    pt.reset_launch_counts()
    with torch.no_grad():
        kv = dit.kv_cache(ci, st, kv_quant="int8")
        y = dit(x, t, positions=pos, cross_kv=kv, self_quant="int8")
        ref = dit(x, t, positions=pos, cross_kv=kv, impl="plain",
                  self_quant="int8")
    assert {k: n for k, n in pt.launch_counts.items() if n} == {
        "self_q8": 2, "temporal_q8": 2, "cross_q8": 2, "mlp": 2}
    assert _rel(y, ref) <= 3e-2, _rel(y, ref)


@pytest.mark.parametrize("early_exit", [False, True])
def test_multiround_blend_on_the_card_matches_the_cpu(dev, early_exit):
    """The plain-torch multi-round blend (no kernel of its own) on the card
    against the same call on the CPU: 3000 Gaussians at 128^2, tiles of
    64, 128 per round, 2 rounds. Four broad Gaussians of opacity 0.95 in
    front leave every pixel's transmittance under 1e-4 after the first
    round, so early exit stops every tile there; skipping the second round
    moves the frames by ~3e-5 (on the CPU), past the 1e-5 bound, so the
    card must stop the same tiles as the CPU."""
    from gvfdiffusion_torch.ops.rasterize.xla_blend import (
        blend_tiles_multiround)

    r = np.random.default_rng(29)
    n, m = 3000, 4
    a = r.uniform(-0.5, 0.5, (n, 2, 2)) * 8.0
    cov = a @ a.transpose(0, 2, 1) + 2.0 * np.eye(2)
    ins = [r.uniform(0, 128, (n, 2)), cov, r.uniform(0, 1, (n, 3)),
           r.uniform(0.05, 0.95, n), r.uniform(1, 3, n)]
    ins[0][:m] = r.uniform(48, 80, (m, 2))
    ins[1][:m] = 300.0 ** 2 * np.eye(2)
    ins[3][:m] = 0.95
    ins[4][:m] = r.uniform(0.5, 0.9, m)
    ins = [torch.tensor(v, dtype=torch.float32) for v in ins]
    ins.append(torch.from_numpy(r.uniform(size=n) > 0.05))
    ins[5][:m] = True
    bg = torch.ones(3)
    kw = dict(tile=64, per_round=128, rounds=2, early_exit=early_exit)
    want = blend_tiles_multiround(*ins, 128, 128, bg, **kw)
    got = blend_tiles_multiround(*(v.to(dev) for v in ins), 128, 128,
                                 bg.to(dev), **kw)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_.cpu(), w_, atol=1e-5, rtol=1e-5)
    if early_exit:  # it stopped early, and that shows on the card too
        scan = blend_tiles_multiround(*(v.to(dev) for v in ins), 128, 128,
                                      bg.to(dev), **dict(kw, early_exit=False))
        assert (scan[1] - got[1]).abs().max() > 1e-5


@pytest.mark.parametrize("N", [32, 24])
def test_temporal_q8_scales_span_the_voxel_group(dev, monkeypatch, N):
    """K2 with int8 QK, its own q and k scales read back from its scratch:
    one per (batch row, group of 16 voxels (8 at N = 24), head) over all T
    frames, as the TPU grid's cell. They equal the group max-abs of the
    plain arithmetic's RMS-normalized q and k to rtol 1e-3 (the two qkv
    products round apart), while a per-voxel max-abs sits a median of
    12-17% below it (plain arithmetic, these draws); in each group the int8 values reach 127 in
    one voxel, not in every voxel as per-voxel scales would give."""
    B, T, C, H = 2, 24, 128, 4
    D = C // H
    d = _Draw(dev, 31, C)
    x = d(B, T, N, C)
    sh, sc, gate = d.mods(B)
    weights = d.self_weights()
    seen = []
    real = pt._qk8_scratch

    def keep(*a):
        seen.append(real(*a))
        return seen[-1]

    monkeypatch.setattr(pt, "_qk8_scratch", keep)
    with torch.no_grad():
        pt.fused_temporal_sublayer(x, sh, sc, gate, *weights, num_heads=H,
                                   quant_qk=True)
    torch.cuda.synchronize()
    qi, ki, qs, ks = seen[0]
    nc = pt.temporal_voxel_group(N)
    G = N // nc
    assert qs.shape == ks.shape == (B * G, H)
    wqkv, bqkv, qg, kg = weights[:4]
    bf = torch.bfloat16
    h = (pt._layernorm_f32(x.float()) * (1.0 + sc.float()[:, None, None])
         + sh.float()[:, None, None])
    qkv = pt._rd(h, bf) @ pt._rd(wqkv, bf) + bqkv.float()
    for a, g, s, i8 in ((qkv[..., :C], qg, qs, qi),
                        (qkv[..., C:2 * C], kg, ks, ki)):
        a = pt._rms(a, g, H).abs().reshape(B, T, G, nc, H, D)
        grp = a.amax((1, 3, 5))  # [B, G, H]
        vox = a.amax((1, 5))     # [B, G, nc, H]
        torch.testing.assert_close(s.reshape(B, G, H),
                                   grp.clamp_min(1e-8), rtol=1e-3, atol=0)
        assert float((1.0 - vox / grp[:, :, None]).median()) > 1e-2
        top = i8.reshape(B, T, G, nc, H, D).abs().amax((1, 5)) == 127
        assert bool(top.any(2).all())  # every (row, group, head) reaches 127
        assert float(top.float().mean()) < 0.5


# -- the DiT's other configurations: K1-K3 with the RMS norms off / on the
# cross sublayer, at heads of 64, their int8 forms; K6 at heads of 64; the
# configured DiTs

# (rms, heads) at C = 128: heads 4 = width 32, 2 = width 64
SELF_FORMS = [(False, 4), (True, 2), (False, 2)]
CROSS_FORMS = [(True, 4), (True, 2), (False, 2)]


@pytest.mark.parametrize("quant_qk", [False, True])
@pytest.mark.parametrize("rms,heads", SELF_FORMS)
def test_self_kernel_forms(dev, rms, heads, quant_qk):
    d = _Draw(dev, 40, 128)
    x = d(4, 100, 128)
    _check("self", pt.fused_self_sublayer, x,
           (x, *d.mods(2), *d.self_weights()),
           dict(num_heads=heads, rms=rms, mod_repeat=2, quant_qk=quant_qk))


@pytest.mark.parametrize("quant_qk", [False, True])
@pytest.mark.parametrize("rms,heads", SELF_FORMS)
def test_temporal_kernel_forms(dev, rms, heads, quant_qk):
    """T = 32 over 48 voxels (groups of 16 for the int8 QK scales); the
    float form also at T = 70 (two query tiles)."""
    d = _Draw(dev, 41, 128)
    for T in ((32,) if quant_qk else (32, 70)):
        x = d(2, T, 48, 128)
        _check("temporal", pt.fused_temporal_sublayer, x,
               (x, *d.mods(2), *d.self_weights()),
               dict(num_heads=heads, rms=rms, quant_qk=quant_qk))


@pytest.mark.parametrize("quant,q_block", [(False, 0), (True, 0),
                                           (True, 64)])
@pytest.mark.parametrize("rms,heads", CROSS_FORMS)
def test_cross_kernel_forms(dev, rms, heads, quant, q_block):
    """Two contexts of 130 and 1374 keys (37 and 20 with q_block 64); with
    rms a q gamma per context, k normed as the cache carries it."""
    d = _Draw(dev, 42, 128)
    L, lks = (128, (37, 20)) if q_block else (100, (130, 1374))
    x = d(4, L, 128)
    args = [x]
    for lk in lks:
        p, (k, v) = d.cross(4, lk)
        if rms:
            p = p[:4] + (d(128, shift=1.0, scale=0.1) * (128 // heads) ** 0.5,
                         ) + p[4:]
            kh = k.float().unflatten(-1, (heads, -1))
            k = (kh * (kh.square().sum(-1, keepdim=True) + 1e-12).rsqrt()
                 * (128 // heads) ** 0.5).flatten(-2).bfloat16()
        if quant:
            kq, ks = pt.quantize_kv(k, heads)
            vq, vs = pt.quantize_kv(v, heads)
            args += [p, (kq, vq, ks.transpose(1, 2).contiguous(), vs)]
        else:
            args += [p, (k, v)]
    _check("cross", pt.fused_cross_sublayer, x, args,
           dict(num_heads=heads, rms=rms, quant=quant, q_block=q_block))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [24, 32, 23, 70])
def test_temporal_attention_kernel_d64(dev, T, dtype):
    """K6 at heads of 64 on [2, T, 8, 2, 64]; q apart, k/v views of a qkv
    projection."""
    g = torch.Generator(device=dev).manual_seed(43)
    dt = getattr(torch, dtype)
    qkv = torch.randn(2, T, 8, 3, 2, 64, generator=g, device=dev).to(dt)
    q = torch.randn(2, T, 8, 2, 64, generator=g, device=dev).to(dt)
    k, v = qkv[..., 1, :, :], qkv[..., 2, :, :]
    fa.reset_launch_counts()
    y = fa.temporal_attention(q, k, v, 64 ** -0.5)
    assert fa.launch_counts["temporal_attention"] == 1
    ref = fa.temporal_attention(q, k, v, 64 ** -0.5, impl="plain")
    torch.cuda.synchronize()
    assert y.dtype == dt and y.shape == q.shape and y.is_contiguous()
    err = _rel(y, ref)
    print(f"temporal attention d64 {dtype} T={T}: rel_l2 {err:.3e}")
    assert bool(torch.isfinite(y).all()) and err <= ATTN_BOUND, err


def test_temporal_attention_gradients_d64(dev):
    g = torch.Generator(device=dev).manual_seed(44)
    q, k, v, go = (torch.randn(2, 24, 64, 2, 64, generator=g, device=dev)
                   for _ in range(4))
    scale = 64 ** -0.5
    y, grads = _grads(lambda *a: fa.temporal_attention(*a, scale), (q, k, v),
                      go)
    yp, grads_p = _grads(lambda *a: fa.temporal_attention(*a, scale,
                                                          impl="plain"),
                         (q, k, v), go)
    torch.cuda.synchronize()
    assert _rel(y, yp) <= ATTN_BOUND
    errs = [_rel(a, b) for a, b in zip(grads, grads_p)]
    print(f"temporal attention d64 gradients rel_l2 {errs}")
    assert max(errs) <= GRAD_BOUND, errs


DIT_CONFIGS = {
    "dit-rms-cross": dict(num_heads=4, qk_rms_norm=False,
                          qk_rms_norm_cross=True),
    "dit-d64": dict(num_heads=2),
    "dit-rope": dict(num_heads=4, pe_mode="rope", share_mod=True),
    "dit-notemporal": dict(num_heads=4, no_temporal_attn=True,
                           pe_mode="learnable", mlp_ratio=2.0),
}


@pytest.mark.parametrize("cfg", list(DIT_CONFIGS))
def test_configured_dit_kernels_match_plain(dev, cfg):
    """A 2-block DiT at each configuration on a hoisted float cache and on
    an int8 cache with int8 QK, kernels vs impl="plain"; the launches say
    which path each took (dit-rope composes on the cache: K5, whose cross
    form takes the 128 static latents, the 20 image tokens and the
    temporal attention over 8 frames lying outside its rule)."""
    dit = init_random_(DiT(resolution=128, model_channels=128,
                           image_cond_channels=64, num_blocks=2,
                           dtype=torch.bfloat16, **DIT_CONFIGS[cfg]),
                       seed=7).to(dev)
    g = torch.Generator(device=dev).manual_seed(45)
    x = torch.randn(1, 8, 128, 16, generator=g, device=dev)
    t = torch.full((1,), 300.0, device=dev)
    ci = torch.randn(1, 8, 20, 64, generator=g, device=dev)
    st = torch.randn(1, 128, 14, generator=g, device=dev)
    pos = torch.rand(1, 128, 3, generator=g, device=dev)
    for quant in (None, "int8"):
        pt.reset_launch_counts()
        fa.reset_launch_counts()
        with torch.no_grad():
            kv = dit.kv_cache(ci, st, kv_quant=quant)
            y = dit(x, t, positions=pos, cross_kv=kv, self_quant=quant)
            ref = dit(x, t, positions=pos, cross_kv=kv, impl="plain",
                      self_quant=quant)
        got = {k: n for k, n in {**pt.launch_counts,
                                 **fa.launch_counts}.items() if n}
        q8 = "_q8" if quant else ""
        want = {"self" + q8: 2, "temporal" + q8: 2, "cross" + q8: 2,
                "mlp": 2}
        if cfg == "dit-rope":
            want = {"attention_d32": 2, "attention_cross_d32": 2}
        elif cfg == "dit-notemporal":
            del want["temporal" + q8]
        assert got == want, (cfg, quant, got)
        err = _rel(y, ref)
        print(f"{cfg} {quant}: rel_l2 {err:.3e}")
        assert bool(torch.isfinite(y).all()) and err <= 3e-2, err


# -- the Hopper attention core (attention_sm90.cuh) under K5 and K3's bf16
# forms, and K3's projection GEMM (gemm_sm90.cuh): tile edges of the 128-row
# query tiles (64 where the grid has fewer tiles than SMs) and of the
# 128-key tiles (64 at heads of 128)

CORE_LQ = [128, 129, 1374, 4097]
CORE_LK = [1, 63, 64, 65, 1374, 4096]


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("Lk", CORE_LK)
@pytest.mark.parametrize("Lq", CORE_LQ)
def test_core_attention_edges(dev, Lq, Lk, D):
    """K5 in bf16 at heads of 32 (fixed shift) and 64 (running maximum):
    q/k/v the strided views of one qkv projection where Lq = Lk, else q
    apart and k/v the halves of a kv projection."""
    g = torch.Generator(device=dev).manual_seed(Lq * 7 + Lk)
    H = 128 // D
    if Lq == Lk:
        qkv = torch.randn(2, Lq, 3, H, D, generator=g, device=dev).bfloat16()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.randn(2, Lq, H, D, generator=g, device=dev).bfloat16()
        kv = torch.randn(2, Lk, 2, H, D, generator=g,
                         device=dev).bfloat16()
        k, v = kv[:, :, 0], kv[:, :, 1]
    y = fa.fused_attention(q, k, v, D ** -0.5, cross=Lq != Lk)
    ref = fa.fused_attention(q, k, v, D ** -0.5, impl="plain")
    torch.cuda.synchronize()
    assert y.shape == q.shape and y.dtype == torch.bfloat16
    assert bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"core D={D} Lq={Lq} Lk={Lk}: rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("Lk", [63, 129, 4096])
def test_core_kv_bias_all_masked_row(dev, Lk, D):
    """A key bias whose batch row 0 masks every key (exactly 0 out, no
    NaN); row 1 keeps a random half off the key tiles, with a finite bias."""
    g = torch.Generator(device=dev).manual_seed(Lk + D)
    H = 128 // D
    q, k, v = (torch.randn(2, L, H, D, generator=g, device=dev).bfloat16()
               for L in (129, Lk, Lk))
    keep = torch.rand(2, Lk, generator=g, device=dev) < 0.5
    keep[0] = False
    keep[1, 0] = True
    bias = torch.where(keep, 0.5 * torch.randn(2, Lk, generator=g,
                                               device=dev), float("-inf"))
    y = fa.fused_attention(q, k, v, D ** -0.5, kv_bias=bias)
    ref = fa.fused_attention(q, k, v, D ** -0.5, kv_bias=bias, impl="plain")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and not bool(y[0].any())
    err = _rel(y, ref)
    print(f"core kv_bias D={D} Lk={Lk}: rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("Lq,Lk", [(129, 65), (1374, 1374), (4097, 63)])
def test_core_fp32_in_and_out(dev, Lq, Lk, D):
    """fp32 q/k/v and output (the DiT's training forms): k/v converted to
    bf16 on the way into shared memory."""
    g = torch.Generator(device=dev).manual_seed(Lq + Lk + D)
    H = 128 // D
    q = torch.randn(2, Lq, H, D, generator=g, device=dev)
    kv = torch.randn(2, Lk, 2, H, D, generator=g, device=dev)
    k, v = kv[:, :, 0], kv[:, :, 1]
    y = fa.fused_attention(q, k, v, D ** -0.5, cross=True)
    ref = fa.fused_attention(q, k, v, D ** -0.5, impl="plain")
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    err = _rel(y, ref)
    print(f"core fp32 D={D} Lq={Lq} Lk={Lk}: rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


@pytest.mark.parametrize("heads", [4, 2])
@pytest.mark.parametrize("lks", [(1, 65), (63, 1374)])
@pytest.mark.parametrize("rms", [False, True])
def test_core_cross_two_contexts(dev, rms, lks, heads):
    """K3's two contexts at unequal key counts on the tile edges, 129 rows
    (a ragged GEMM and query tile), heads of 32 and 64, with and without
    the q RMS norm (k normed as the cache carries it)."""
    d = _Draw(dev, 50 + sum(lks), 128)
    x = d(3, 129, 128)
    args = [x]
    for lk in lks:
        p, (k, v) = d.cross(3, lk)
        if rms:
            p = p[:4] + (d(128, shift=1.0, scale=0.1) * (128 // heads) ** 0.5,
                         ) + p[4:]
            kh = k.float().unflatten(-1, (heads, -1))
            k = (kh * (kh.square().sum(-1, keepdim=True) + 1e-12).rsqrt()
                 * (128 // heads) ** 0.5).flatten(-2).bfloat16()
        args += [p, (k, v)]
    _check("cross", pt.fused_cross_sublayer, x, args,
           dict(num_heads=heads, rms=rms))


@pytest.mark.parametrize("lk", [1, 63, 64, 65, 129])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_core_cross_single_edges(dev, D, lk):
    """K3's single context in bf16 at heads of 32, 64 and 128 (C = 256),
    fp32 x as the SLat torso's residual stream, k/v the halves of one
    [B, lk, 2C] projection, 129 rows."""
    d = _Draw(dev, 60 + lk, 256)
    x = d(2, 129, 256).float()
    p, _ = d.cross(2, lk)
    kv = d(2, lk, 512)
    args = (x, p, (kv[..., :256], kv[..., 256:]))
    with torch.no_grad():
        y = pt.fused_cross_sublayer(*args, num_heads=256 // D)
        ref = pt.fused_cross_sublayer(*args, num_heads=256 // D,
                                      impl="plain")
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    err, upd = _rel(y, ref), _rel(y - x, ref - x)
    print(f"core cross_single D={D} lk={lk}: rel_l2 {err:.3e} "
          f"update_rel_l2 {upd:.3e}")
    y_bound, upd_bound = BOUNDS["cross_single"]
    assert err <= y_bound and upd <= upd_bound, (err, upd)


# -- K1 on the Hopper core (float: attention_sm90.cuh with k's RMS norm in
# its fp32 producer; int8 QK: attention_sm90_q8.cuh's s8 path) and K3's int8
# form on the s8 path, both with their projections on gemm_sm90.cuh (K1's
# out projection through its gated epilogue): the 64-row query tiles and
# 128-key tiles' edges

CORE_EDGES = [1, 63, 64, 65, 127, 128, 129, 257]
# (rms, heads) at C = 128: every K1 form with its int8-QK twin
K1_FORMS = [(True, 4), (False, 4), (True, 2), (False, 2)]
# (rms, heads): K3 int8's shipped form, its q RMS norm, heads of 64
K3_Q8_FORMS = [(False, 4), (True, 4), (False, 2), (True, 2)]


@pytest.mark.parametrize("quant_qk", [False, True])
@pytest.mark.parametrize("rms,heads", K1_FORMS)
@pytest.mark.parametrize("L", CORE_EDGES)
def test_core_self_edges(dev, L, rms, heads, quant_qk):
    """K1 at L rows and keys around the core's tiles, 4 frames sharing 2
    modulation rows (mod_repeat 2)."""
    d = _Draw(dev, 70 + L, 128)
    x = d(4, L, 128)
    _check("self", pt.fused_self_sublayer, x,
           (x, *d.mods(2), *d.self_weights()),
           dict(num_heads=heads, rms=rms, mod_repeat=2, quant_qk=quant_qk))


@pytest.mark.parametrize("L,q_block", [(129, 0), (128, 64)])
@pytest.mark.parametrize("rms,heads", K3_Q8_FORMS)
@pytest.mark.parametrize("lk", CORE_EDGES)
def test_core_cross_q8_edges(dev, lk, rms, heads, L, q_block):
    """K3's int8 form with an image context of lk keys around the key tile
    and a static one of 20, both q-scale domains (all L rows; q_block 64,
    cells that split a 128-row query tile), with and without the q RMS
    norm (k normed as the cache carries it), heads of 32 and 64."""
    d = _Draw(dev, 80 + lk, 128)
    x = d(3, L, 128)
    args = [x]
    for n in (lk, 20):
        p, (k, v) = d.cross(3, n)
        if rms:
            p = p[:4] + (d(128, shift=1.0, scale=0.1) * (128 // heads) ** 0.5,
                         ) + p[4:]
            kh = k.float().unflatten(-1, (heads, -1))
            k = (kh * (kh.square().sum(-1, keepdim=True) + 1e-12).rsqrt()
                 * (128 // heads) ** 0.5).flatten(-2).bfloat16()
        kq, ks = pt.quantize_kv(k, heads)
        vq, vs = pt.quantize_kv(v, heads)
        args += [p, (kq, vq, ks.transpose(1, 2).contiguous(), vs)]
    _check("cross", pt.fused_cross_sublayer, x, args,
           dict(num_heads=heads, rms=rms, quant=True, q_block=q_block))


@pytest.mark.parametrize("quant_qk", [False, True])
@pytest.mark.parametrize("L,mod_repeat", [(100, 1), (100, 3), (192, 3)])
def test_gated_epilogue_across_frames(dev, L, mod_repeat, quant_qk):
    """K1's gated out projection: 6 frames of L rows, so the GEMM's 128-row
    tiles straddle frames and modulation groups; each modulation row's gate
    has its own sign and size, so a row that read its neighbour's gate
    would show in y."""
    d = _Draw(dev, 90 + L + mod_repeat, 128)
    x = d(6, L, 128)
    sh, sc, _ = d.mods(6 // mod_repeat)
    rows = torch.arange(6 // mod_repeat, device=dev, dtype=torch.float32)
    gate = (d(6 // mod_repeat, 128, scale=0.1).float() + (rows[:, None] - 0.7)
            * 2.0).bfloat16()
    _check("self", pt.fused_self_sublayer, x,
           (x, sh, sc, gate, *d.self_weights()),
           dict(num_heads=4, mod_repeat=mod_repeat, quant_qk=quant_qk))


# -- K2's attention over T alone (csrc/temporal_sm90.cuh: query blocks of 32
# frames x key tiles of 32 keys, one warp a (batch row, voxel, head)) and
# K4 on the Hopper GEMM with its GELU epilogue

TEMPORAL_TS = [1, 8, 31, 32, 33, 64, 65, 70, 128]
# N -> JAX's voxel group: 16, 8 and 1 (N = 7: no power of two divides it)
TEMPORAL_NS = {32: 16, 24: 8, 7: 1}


def _temporal_core_case(dev, seed, B, T, N, heads, q8):
    """A [B, T, N, 3C] projection, C = 128: bf16 with q and k RMS-normed
    per head (the float form), or fp32 with int8 q and k quantized per
    (batch row, voxel group, head) as q8_kernel does (the int8-QK form)."""
    C, D = 128, 128 // heads
    r = np.random.default_rng(seed)
    qkv = torch.tensor(r.standard_normal((B, T, N, 3 * C)),
                       dtype=torch.float32, device=dev)
    qk = qkv[..., :2 * C].unflatten(-1, (2, heads, D))
    g = torch.tensor(1.0 + 0.3 * np.abs(r.standard_normal((2, heads, D))),
                     dtype=torch.float32, device=dev)
    qk = qk * (qk.square().sum(-1, keepdim=True) + 1e-12).rsqrt() * g \
        * D ** 0.5
    qkv = torch.cat((qk.flatten(-3), qkv[..., 2 * C:]), -1)
    if not q8:
        return qkv.bfloat16(), None
    nc = pt.temporal_voxel_group(N)
    cells = lambda a: a.reshape(B, T, N // nc, nc, heads, D)
    scales = [cells(qkv[..., i * C:(i + 1) * C]).abs().amax((1, 3, 5))
              .clamp_min(1e-8) for i in range(2)]
    qi, ki = (torch.round(cells(qkv[..., i * C:(i + 1) * C])
                          * (127.0 / s)[:, None, :, None, :, None])
              .reshape(B, T, N, C).to(torch.int8)
              for i, s in enumerate(scales))
    return qkv, (qi, ki, *(s.reshape(-1, heads) for s in scales))


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("N", list(TEMPORAL_NS))
@pytest.mark.parametrize("heads", [4, 2])
@pytest.mark.parametrize("T", TEMPORAL_TS)
def test_temporal_core(dev, T, heads, N, B, q8):
    """The attention alone against its plain version: T below, on and past
    the 32-frame tiles, heads of 32 and 64, voxel groups of 16, 8 and 1,
    one and three batch rows; float and int8 QK (s8 mma.sync)."""
    assert pt.temporal_voxel_group(N) == TEMPORAL_NS[N]
    qkv, quant = _temporal_core_case(dev, 1000 * T + 10 * N + B + heads,
                                     B, T, N, heads, q8)
    pt.reset_launch_counts()
    with torch.no_grad():
        got = pt.temporal_sublayer_attention(qkv, heads, quant=quant)
        want = pt.temporal_sublayer_attention(qkv, heads, quant=quant,
                                              impl="plain")
    torch.cuda.synchronize()
    assert pt.launch_counts["temporal_core"] == 1
    assert got.shape == want.shape == (B, T, N, 128)
    assert bool(torch.isfinite(got).all())
    err = _rel(got, want)
    print(f"temporal core T={T} heads={heads} N={N} B={B} q8={q8}: "
          f"rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("T", [257, 1024])
def test_temporal_core_long(dev, T, q8):
    """T past the DiT's gate (up to 1024 frames where the voxel group is 1):
    many key tiles under the running maximum (float) or the fixed shift
    (int8 QK), 9 and 32 query blocks a problem, heads of 64."""
    qkv, quant = _temporal_core_case(dev, T, 1, T, 3, 2, q8)
    with torch.no_grad():
        got = pt.temporal_sublayer_attention(qkv, 2, quant=quant)
        want = pt.temporal_sublayer_attention(qkv, 2, quant=quant,
                                              impl="plain")
    torch.cuda.synchronize()
    err = _rel(got, want)
    print(f"temporal core T={T} q8={q8}: rel_l2 {err:.3e}")
    assert bool(torch.isfinite(got).all()) and err <= ATTN_BOUND, err


# -- K6 on temporal_sm90.cuh's fixed-shift forms (bf16 io: TForm::Shift; fp32
# io: TForm::ShiftF32, its fp32 q / k tiles rounded per lane): T around the
# 32-frame tiles, the N of JAX's voxel groups 16, 8 and 1, q / k / v each on
# its own row stride

K6_TS = [1, 8, 23, 24, 31, 32, 33, 70, 257]


def _k6_case(dev, seed, B, T, N, heads, dtype, q_view):
    """q, k, v [B, T, N, heads, D], C = 128, from a [B, T, N, 3, heads, D]
    qkv and one tensor apart: q apart with k and v views of the qkv, or
    (q_view) q and v views with k apart."""
    r = np.random.default_rng(seed)
    draw = lambda *s: torch.tensor(r.standard_normal(s), dtype=torch.float32,
                                   device=dev).to(dtype)
    qkv, lone = draw(B, T, N, 3, heads, 128 // heads), draw(
        B, T, N, heads, 128 // heads)
    if q_view:
        return qkv[..., 0, :, :], lone, qkv[..., 2, :, :]
    return lone, qkv[..., 1, :, :], qkv[..., 2, :, :]


def _k6_run(q, k, v):
    """(the kernel's output, the plain version's); the kernel launched
    once, its output contiguous in q's dtype."""
    scale = q.shape[-1] ** -0.5
    fa.reset_launch_counts()
    with torch.no_grad():
        y = fa.temporal_attention(q, k, v, scale)
        assert fa.launch_counts["temporal_attention"] == 1
        ref = fa.temporal_attention(q, k, v, scale, impl="plain")
    torch.cuda.synchronize()
    assert fa.launch_counts["temporal_attention"] == 1
    assert y.dtype == q.dtype and y.shape == q.shape and y.is_contiguous()
    return y, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("N", list(TEMPORAL_NS))
@pytest.mark.parametrize("heads", [4, 2])
@pytest.mark.parametrize("T", K6_TS)
def test_temporal_attention_core(dev, T, heads, N, B, dtype):
    """K6 against its plain version: T below, on and past the 32-frame
    tiles, heads of 32 and 64, voxel groups of 16, 8 and 1, one and three
    batch rows, fp32 and bf16 io; mixed row strides (3 H D and H D)."""
    q, k, v = _k6_case(dev, 1000 * T + 10 * N + B + heads, B, T, N, heads,
                       getattr(torch, dtype), B == 3)
    y, ref = _k6_run(q, k, v)
    err = _rel(y, ref)
    print(f"K6 T={T} heads={heads} N={N} B={B} {dtype}: rel_l2 {err:.3e}")
    assert bool(torch.isfinite(y).all()) and err <= ATTN_BOUND, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [4, 2])
def test_temporal_attention_core_long(dev, heads, dtype):
    """K6 at T = 1024 where the voxel group is 1 (N = 1, B = 1): 32 query
    blocks x 32 key tiles a problem, the fixed shift's sums over them."""
    q, k, v = _k6_case(dev, 1024 + heads, 1, 1024, 1, heads,
                       getattr(torch, dtype), False)
    y, ref = _k6_run(q, k, v)
    err = _rel(y, ref)
    print(f"K6 T=1024 heads={heads} {dtype}: rel_l2 {err:.3e}")
    assert bool(torch.isfinite(y).all()) and err <= ATTN_BOUND, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [4, 2])
def test_temporal_attention_core_underflow_row(dev, heads, dtype):
    """One query row whose every P underflows (its k rows all ones, its q
    -40: logits ~330 below the shift) is 0/0 = NaN in the kernel as in the
    plain version (and JAX's kernel); the other rows agree."""
    q, k, v = _k6_case(dev, 77 + heads, 2, 24, 8, heads,
                       getattr(torch, dtype), False)
    k[1, :, 3, 1] = 1.0
    q[1, 5, 3, 1] = -40.0
    y, ref = _k6_run(q, k, v)
    nan = torch.isnan(y)
    assert torch.equal(nan, torch.isnan(ref))
    assert bool(nan[1, 5, 3, 1].all()) and int(nan.sum()) == 128 // heads
    err = _rel(y[~nan], ref[~nan])
    print(f"K6 underflow row heads={heads} {dtype}: rel_l2 {err:.3e}")
    assert err <= ATTN_BOUND, err


def test_temporal_attention_misaligned_raises(dev):
    """The kernel's cp.async reads 16-byte chunks: a q that starts 4 bytes
    off a 16-byte boundary is refused before any launch."""
    buf = torch.randn(2 * 8 * 4 * 4 * 32 + 1, device=dev)
    q = buf[1:].view(2, 8, 4, 4, 32)
    k = v = torch.randn(2, 8, 4, 4, 32, device=dev)
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        fa.temporal_attention(q, k, v, 32 ** -0.5)
    assert fa.launch_counts["temporal_attention"] == 0


@pytest.mark.parametrize("mod_repeat", [1, 2])
@pytest.mark.parametrize("M", [264, 1024, 2048])
def test_mlp_kernel_widths(dev, M, mod_repeat):
    """K4 on the Hopper GEMM: fc1 with the GELU epilogue at M = 264 (not a
    multiple of the 128-column tile), 1024 and 2048, 400 rows (not a
    multiple of the 128-row tile) whose tiles straddle the modulation rows
    of mod_repeat 2; fc2's gated epilogue reads each row's own gate."""
    d = _Draw(dev, 60 + M + mod_repeat, 128)
    x = d(4, 100, 128)
    rows = torch.arange(4 // mod_repeat, device=dev, dtype=torch.float32)
    sh, sc, _ = d.mods(4 // mod_repeat)
    gate = (d(4 // mod_repeat, 128, scale=0.1).float()
            + (rows[:, None] - 0.7) * 2.0).bfloat16()
    pt.reset_launch_counts()
    _check("mlp", pt.fused_mlp_sublayer, x,
           (x, sh, sc, gate, d(128, M, scale=128 ** -0.5), d(M, scale=0.1),
            d(M, 128, scale=M ** -0.5), d(128, scale=0.1)),
           dict(mod_repeat=mod_repeat))
    assert pt.launch_counts["mlp"] == 1

