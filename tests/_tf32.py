"""A plain torch emulation of the 3xTF32 split, for the fp32 forms of K3's
single context and K7 (forward and backward): a = hi + lo with hi =
tf32(a) (round to nearest, ties away from zero: cvt.rna.tf32.f32) and lo
= tf32(a - hi), a product a.b
taken as hi.hi' + hi.lo' + lo.hi' (lo.lo' dropped) with fp32 sums, as a
tensor core takes three tf32 products into one fp32 accumulator. The
softmax, the LayerNorm, the biases and the residual stay fp32.

Run from the repository's root as a script (`PYTHONPATH=. python
tests/_tf32.py`), it prints the emulation's rel L2 against the plain fp32
versions of the port at K3 single fp32's and K7
fp32's widths (query rows cut to 1024 of 32768; K7's 3700 valid keys of
32768, which are all that enter the softmax), beside the bounds that
chip_smoke.py holds the card's kernels to. The tensor cores' own fp32
accumulation is what this cannot show; the card's kernels are held to the
same bounds there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 (10 mantissa bits), ties away from zero,
    kept in fp32."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b by the 3xTF32 split: the two small products first, then the
    large one, each an fp32 matrix product of tf32 values."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from the tf32 halves alone (hi . hi'): plain TF32."""
    return tf32_round(a) @ tf32_round(b)


def chained(a: torch.Tensor, b: torch.Tensor, mm=mm3,
            chain: int = 32) -> torch.Tensor:
    """a @ b summed over `chain` columns of a (rows of b) at a time, each
    chunk's product a fresh accumulator added into an fp32 sum: the chain
    of the backward kernels' tensor-core products."""
    out = None
    for c0 in range(0, a.shape[-1], chain):
        part = mm(a[..., c0:c0 + chain], b[..., c0:c0 + chain, :])
        out = part if out is None else out + part
    return out


def backward_3xtf32(q, k, v, valid, scale: float, o, do, mm=mm3):
    """K7's backward as its card kernels (csrc/flash_attention_bwd.cu)
    compute it, for batch rows that hold a valid key: q/o/do [B, Lq, H,
    D], k/v [B, Lk, H, D], valid bool [B, Lk] -> (dq, dk, dv) fp32. S and
    dP by the split (mm), the row logsumexp from those scores (the forward
    kernel's residual), P = exp(s - lse) with an invalid key's mask as
    -inf, di = rowsum(o * do) in fp32, dS = P (dP - di) scale, and dV =
    P^T dO, dK = dS^T Q summed 32 query rows a chain, dQ = dS K 32 keys a
    chain."""
    qh, kh, vh, oh, doh = (a.float().transpose(1, 2)
                           for a in (q, k, v, o, do))
    mask = torch.where(valid, 0.0, float("-inf"))[:, None, None, :]
    s = mm(qh, kh.transpose(-1, -2)) * scale + mask
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    di = (oh * doh).sum(-1, keepdim=True)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - di) * scale
    dv = chained(p.transpose(-1, -2), doh, mm)
    dk = chained(ds.transpose(-1, -2), qh, mm)
    dq = chained(ds, kh, mm)
    return tuple(a.transpose(1, 2) for a in (dq, dk, dv))


def attention_3xtf32(q, k, v, scale: float, lse: bool = False):
    """Softmax attention of q [B, Lq, H, D] over k/v [B, Lk, H, D] (every key
    visible), S and P V by the split, the softmax in fp32 with the row's
    maximum; with `lse` also the row logsumexp [B, H, Lq]."""
    qh, kh, vh = (a.float().transpose(1, 2) for a in (q, k, v))
    s = mm3(qh, kh.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (mm3(p, vh) / l).transpose(1, 2)
    return (o, (m + torch.log(l))[..., 0]) if lse else o


def cross_single_3xtf32(x, p, kv, num_heads: int):
    """K3's single context at compute_dtype=float32 with its three products
    (q projection, attention, out projection) by the split."""
    ns, nb, wq, bq, wo, bo = p
    B, L, C = x.shape
    h = F.layer_norm(x, (C,), ns, nb, eps=1e-6)
    q = (mm3(h, wq) + bq).view(B, L, num_heads, -1)
    k, v = (a.reshape(B, a.shape[1], num_heads, -1) for a in kv)
    o = attention_3xtf32(q, k, v, (C // num_heads) ** -0.5)
    return x + mm3(o.reshape(B, L, C), wo) + bo


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def cross_case(rows: int, num_heads: int, seed: int = 15, C: int = 1024,
               lk: int = 1374):
    """x [1, rows, C], the parameters and the k/v halves of a [1, lk, 2C]
    projection, drawn as chip_smoke.py's phase_cross_single draws them."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s_, sc=1.0: torch.randn(*s_, generator=g) * sc
    x = r(1, rows, C)
    p = (1 + 0.1 * r(C), 0.1 * r(C), r(C, C, sc=C ** -0.5), 0.1 * r(C),
         r(C, C, sc=C ** -0.5), 0.1 * r(C))
    kvp = r(1, lk, 2 * C)
    return x, p, (kvp[..., :C], kvp[..., C:])


def flash_case(rows: int, keys: int, heads: int, width: int, seed: int = 14):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(1, n, heads, width, generator=g)
                 for n in (rows, keys, keys))


def main() -> None:
    from gvfdiffusion_torch.ops import flash_attention as fl
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    torch.set_num_threads(4)
    for heads in (32, 16, 8):
        x, p, kv = cross_case(1024, heads)
        want = fsl.fused_cross_sublayer(x, p, kv, num_heads=heads,
                                        compute_dtype=torch.float32)
        got = cross_single_3xtf32(x, p, kv, heads)
        print(f"K3 single fp32, {heads} heads of {1024 // heads}, 1024 rows "
              f"x 1374 keys: rel_l2 y {rel_l2(got, want):.3e} (bound 4e-7), "
              f"update {rel_l2(got - x, want - x):.3e} (bound 3e-6)")
    for heads, width in ((32, 32), (16, 64), (8, 128)):
        q, k, v = flash_case(1024, 3700, heads, width)
        valid = torch.ones(1, 3700, dtype=torch.bool)
        want = fl.flash_attention(q, k, v, valid, width ** -0.5)
        got = attention_3xtf32(q, k, v, width ** -0.5)
        print(f"K7 fp32, {heads} heads of {width}, 1024 rows x 3700 valid "
              f"keys: rel_l2 {rel_l2(got, want):.3e} (bound 5e-6)")
    q, k, v = flash_case(512, 15721, 12, 64, seed=16)
    valid = torch.ones(1, 15721, dtype=torch.bool)
    want = fl.flash_attention(q, k, v, valid, 0.125)
    got, _ = attention_3xtf32(q, k, v, 0.125, lse=True)
    print(f"K7 fp32 res (the static VAE's 12 heads of 64), 512 rows x 15721 "
          f"valid keys: rel_l2 {rel_l2(got, want):.3e} (bound 1e-5)")


if __name__ == "__main__":
    main()
