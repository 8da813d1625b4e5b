"""K5, softmax attention on [B, L, H, D], and K6, attention over T on
[B, T, N, H, D] (port of gvfdiffusion_tpu/ops/fused_attention.py:370
`fused_attention` with its dispatch rule `supports` :386, and :494
`temporal_attention` with `temporal_supports` :524).

Each has two versions:
  * the plain torch version (`attention_reference`,
    `temporal_attention_reference`): rounds q/k/v to `compute_dtype`, takes
    the scores in fp32, P in fp32, rounds P to `compute_dtype` for the P V
    product and divides by the row sum of the fp32 P, clamped at 1e-30 in
    K5 so that a row whose keys are all masked gives 0: the rounding points
    of the TPU kernels (`_attn_kernel_dense`, `_temporal_kernel`). K6 and
    K5 at heads of 32 or less take the TPU kernels' fixed shift, P =
    exp2(S * scale * log2(e) - 30); K5 at heads wider than 32 takes exp(S -
    the row maximum) instead, as its CUDA kernel keeps a running maximum at
    the card widths 64 and 128 (DINOv2's un-normed logits may pass the
    fixed shift's range of about +-90). The rule follows the width the card
    runs a head at (`_widths.card_width`: 32 for heads of 8 to 32). K5's
    `segment_size` masks a score outside the query row's segment to -inf
    after the scale and the bias, as the TPU kernel does. K5's int8 forms
    (`attention_q8_reference`) copy the TPU kernel's int8 body
    (`_attn_kernel`) with its fixed shift at every head width.
  * the wrapper (`fused_attention`, `temporal_attention`): dispatches on the
    device of `q`. A CUDA tensor runs the hand-written kernel
    (`csrc/fused_attention.cu`, `csrc/temporal_attention.cu`); a CPU tensor
    runs the plain version. It is a `torch.autograd.Function` whose
    backward is the JAX custom_vjp's (`_bwd` :345, `_temporal_bwd` :505):
    the plain softmax-attention gradient in fp32 from the saved, unrounded
    q/k/v, with the segment mask, and K5's key-bias gradient, the sum of
    dS over heads and query rows (neither TPU kernel has a backward kernel;
    an int8 form differentiates as the float one, as JAX's backward
    ignores `quant`). `impl="plain"` runs the plain version instead, with
    torch's own autograd through it, for comparing the two on the card.

K5 serves heads of 64 in bf16 (DINOv2, the TRELLIS flows: self, cross with
Lq != Lk, and self with a [B, Lk] fp32 `kv_bias` whose -inf entries mask
keys) and heads of 32 in fp32 or bf16 (the DiT's composed path: spatial
self and the image and static cross-attentions; heads of 64 in fp32 in the
DiT's 8-head configuration, 128 in its 4-head one), and `segment_size`
(block-diagonal attention over packed segments, Lq == Lk a multiple of it)
in either. `quant="qk"` (int8 QK) and `quant="qk+av"` (int8 P V as well)
run on the card in bf16, with `kv_bias` and `segment_size`. K6 serves
fp32 or bf16. Both take every head width their rules admit, a multiple of
8 up to 128: the kernels run natively at heads of 32, 64 and 128, and a
head of another width is zero-padded to the next of those
(`_widths.card_width`, `pad_heads`: the kernel gets the true width's
scale, and the output keeps the first D columns). The padding is the
design, not a departure from JAX's function: zero columns change no score,
row maximum, row sum or int8 scale. At the native widths the kernels read
q and k/v with their own strides, so the views of a qkv or kv projection
go in without copies; at a padded width the wrapper copies them into
contiguous padded buffers.

`launch_counts` counts kernel launches by the form the caller runs and the
caller's head width (the true one, not the padded one): "attention",
"attention_cross", "attention_bias", "attention_seg", "attention_qk" and
"attention_qkav" at heads of 64, the same names with "_d32", "_d16", ...
at the other widths (the int8 forms count as their quant form whatever
their bias or segments), and "temporal_attention" at heads of 32 and 64,
"temporal_attention_d16", ... at the others (`temporal_launch_key`); the
plain version never counts.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._widths import WIDTHS, card_width, pad_heads, width_suffix

# the TPU kernel holds the whole key extent in VMEM: its longest key count
MAX_LK = 4096
_LANES = 128
_LOG2E = 1.4426950408889634
_SHIFT = 30.0  # the TPU kernels' fixed exp2 shift
_TEMPORAL_NC = 16  # voxels per TPU grid cell; only `temporal_supports` reads it
# scores per chunk of the plain backward ([rows, H, Lq, Lk] fp32: 512 MB)
_BWD_SCORES = 1 << 27
# the TPU kernel's VMEM budget for a row block's score tiles (JAX
# `_SCORE_BYTES`): it sets the rows of an int8 q scale cell (`lq_block`)
_SCORE_BYTES = 8 * 1024 * 1024
QUANT_FORMS = ("", "qk", "qk+av")


def temporal_launch_key(head_dim: int) -> str:
    """The counter of a K6 launch at the caller's head width (heads of 32
    and 64 keep the name they had as K6's only widths)."""
    return "temporal_attention" + (
        "" if head_dim in (32, 64) else f"_d{head_dim}")


launch_counts = {f"attention{form}{width_suffix(w)}": 0 for w in WIDTHS
                 for form in ("", "_cross", "_bias", "_seg", "_qk", "_qkav")}
launch_counts.update({temporal_launch_key(w): 0 for w in WIDTHS})


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def launch_key(head_dim: int, cross: bool, bias: bool, seg: bool = False,
               quant: str = "") -> str:
    """The counter of a K5 launch: its form (an int8 form, segments, a key
    bias, cross or self) as the caller runs it, and the caller's head
    width."""
    form = ("_qkav" if quant == "qk+av" else "_qk" if quant else
            "_seg" if seg else "_bias" if bias else "_cross" if cross else "")
    return f"attention{form}{width_suffix(head_dim)}"


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def lq_block(lq: int, lk_pad: int) -> int:
    """The TPU kernel's query rows per grid instance (JAX `_lq_block`): the
    largest power of two <= 1024 whose score tiles (6 bytes a score) fit
    the VMEM budget, at least 8, and not above Lq unless that is 8. The
    int8 forms take q's scale over such a block of rows."""
    blk = 1024
    while blk > 8 and (blk * lk_pad * 6 > _SCORE_BYTES or blk > lq):
        blk //= 2
    return blk


def supports(q_shape, k_shape) -> bool:
    """The JAX dispatch rule `fa.supports`: the kernel serves Lq >= 128,
    128 <= Lk <= 4096, head widths that are a multiple of 8 up to 128 and
    rows of a multiple of 128 lanes; other shapes take XLA's attention."""
    _, Lq, H, D = q_shape
    Lk = k_shape[1]
    return (Lq >= 128 and 128 <= Lk <= MAX_LK and D <= 128 and D % 8 == 0
            and (H * D) % _LANES == 0)


def temporal_supports(q_shape) -> bool:
    """The JAX dispatch rule `fa.temporal_supports` for [B, T, N, H, D]."""
    _, T, N, H, D = q_shape
    nc = _TEMPORAL_NC
    while nc and N % nc:
        nc //= 2
    return (nc >= 1 and T * nc % 8 == 0 and (H * D) % _LANES == 0
            and D % 8 == 0 and T * nc <= 1024)


# -- plain versions -------------------------------------------------------------


def _segment_mask(lq: int, lk: int, segment_size: int, device):
    """[Lq, Lk] True where row // s == col // s, or None without segments."""
    if not segment_size:
        return None
    r = torch.arange(lq, device=device)[:, None] // segment_size
    c = torch.arange(lk, device=device)[None, :] // segment_size
    return r == c


def attention_reference(q, k, v, scale: float, compute_dtype=torch.bfloat16,
                        kv_bias: Optional[torch.Tensor] = None,
                        segment_size: int = 0, quant: str = ""):
    """q [B, Lq, H, D]; k, v [B, Lk, H, D]; kv_bias [B, Lk] or None ->
    [B, Lq, H, D] in q's dtype. Heads of 32 or less take P = exp2(S *
    scale * log2(e) - 30 + bias * log2(e)), wider heads exp of S minus the
    row maximum; segment_size > 0 masks the scores outside a row's segment
    (row // s != col // s) to -inf. quant: see attention_q8_reference."""
    if quant:
        return attention_q8_reference(q, k, v, scale, compute_dtype, kv_bias,
                                      segment_size, quant)
    dt = compute_dtype
    qh, kh, vh = (a.to(dt).float() for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    mask = _segment_mask(q.shape[1], k.shape[1], segment_size, q.device)
    if q.shape[-1] <= 32:
        shift = _SHIFT
        if kv_bias is not None:
            shift = _SHIFT - kv_bias.float()[:, None, None, :] * _LOG2E
        s = s * (scale * _LOG2E) - shift
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        p = torch.exp2(s)
    else:
        s = s * scale
        if kv_bias is not None:
            s = s + kv_bias.float()[:, None, None, :]
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)
    denom = p.sum(-1).transpose(1, 2)[..., None]  # [B, Lq, H, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), vh)
    return (o / denom.clamp_min(1e-30)).to(q.dtype)


def attention_q8_reference(q, k, v, scale: float,
                           compute_dtype=torch.bfloat16,
                           kv_bias: Optional[torch.Tensor] = None,
                           segment_size: int = 0, quant: str = "qk"):
    """K5's int8 forms in the TPU kernel's arithmetic (`_attn_kernel` with
    quant): q, k, v rounded to compute_dtype; q's max-abs scale qm per
    (batch row, head, block of lq_block(Lq, Lk rounded up to 128) rows), k's
    km per (batch row, head) over all keys, both floored at 1e-6; qi =
    round(q * (127 / qm)), ki likewise (half to even); s = (qi . ki) *
    ((qm * km / 127^2) * scale * log2 e) - (30 - bias * log2 e), -inf outside
    a row's segment. quant="qk": P = exp2(s) rounded to compute_dtype, O =
    P V / max(sum of the rounded P, 1e-30). quant="qk+av": m = the row
    maximum of s, P = round(exp2(max(s - m, -126)) * 127) (0 for a row whose
    keys are all masked, as the TPU kernel's int8 conversion of its NaN
    gives), V quantized as k with vm, O = (P . vi) / max(127 sum P, 1) *
    vm. In chunks of batch rows."""
    if quant not in QUANT_FORMS[1:]:
        raise ValueError(f"quant must be one of {QUANT_FORMS}, got {quant!r}")
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    blk = lq_block(Lq, _round_up(Lk, 128))
    cells = -(-Lq // blk)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=q.device)
    n127, lg = f32(127.0), f32(_LOG2E)
    mask = _segment_mask(Lq, Lk, segment_size, q.device)
    out = torch.empty(B, Lq, H, D, dtype=q.dtype, device=q.device)
    rows = max(1, _BWD_SCORES // (H * Lq * Lk))
    for b0 in range(0, B, rows):
        sl = slice(b0, b0 + rows)
        qf, kf, vf = (a[sl].to(compute_dtype).float() for a in (q, k, v))
        nb = qf.shape[0]
        qp = torch.nn.functional.pad(qf, (0, 0, 0, 0, 0, cells * blk - Lq))
        qp = qp.reshape(nb, cells, blk, H, D)
        qm = qp.abs().amax((2, 4)).clamp_min(1e-6)  # [nb, cells, H]
        km = kf.abs().amax((1, 3)).clamp_min(1e-6)  # [nb, H]
        qi = torch.round(qp * (n127 / qm)[:, :, None, :, None])
        qi = qi.reshape(nb, cells * blk, H, D)[:, :Lq]
        ki = torch.round(kf * (n127 / km)[:, None, :, None])
        si = torch.einsum("bqhd,bkhd->bhqk", qi, ki)
        fac = qm[:, :, None, :] * km[:, None, None, :] / f32(127.0 * 127.0)
        fac = (fac * f32(scale) * lg).expand(nb, cells, blk, H).reshape(
            nb, cells * blk, H)[:, :Lq].transpose(1, 2)  # [nb, H, Lq]
        bias = torch.full((nb, Lk), _SHIFT, device=q.device)
        if kv_bias is not None:
            bias = bias - kv_bias[sl].float() * lg
        s = si * fac[..., None] - bias[:, None, None, :]
        del si
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        if quant == "qk":
            p = torch.exp2(s).to(compute_dtype).float()
            del s
            denom = p.sum(-1).transpose(1, 2)[..., None]  # [nb, Lq, H, 1]
            o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
            out[sl] = (o / denom.clamp_min(1e-30)).to(q.dtype)
            continue
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(torch.maximum(s - m, f32(-126.0)))
        del s
        pi = torch.round(p * n127).nan_to_num(0.0)
        del p
        vm = vf.abs().amax((1, 3)).clamp_min(1e-6)  # [nb, H]
        vi = torch.round(vf * (n127 / vm)[:, None, :, None])
        o = torch.einsum("bhqk,bkhd->bqhd", pi, vi)
        denom = (pi.sum(-1) * n127).transpose(1, 2)[..., None]
        out[sl] = (o / denom.clamp_min(1.0) * vm[:, None, :, None]).to(
            q.dtype)
    return out


def attention_backward(q, k, v, kv_bias, g, scale: float,
                       segment_size: int = 0, bias_grad: bool = False):
    """The JAX custom_vjp's `_bwd`: the gradient of softmax(q k^T * scale +
    bias) v (masked outside each row's segment) with respect to q, k, v
    and, with bias_grad, kv_bias (the sum of dS over heads and query rows,
    before the scale), in fp32 from the unrounded inputs, in chunks of
    batch rows (the [B, H, Lq, Lk] scores of the DiT's image
    cross-attention would take 2.2 GB each at once)."""
    B, Lq, H, _ = q.shape
    Lk = k.shape[1]
    rows = max(1, _BWD_SCORES // (H * Lq * Lk))
    dq, dk, dv = (torch.empty_like(a) for a in (q, k, v))
    dbias = torch.empty_like(kv_bias) if bias_grad else None
    mask = _segment_mask(Lq, Lk, segment_size, q.device)
    for b0 in range(0, B, rows):
        sl = slice(b0, b0 + rows)
        qf, kf, vf, gf = (a[sl].float() for a in (q, k, v, g))
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        if kv_bias is not None:
            s = s + kv_bias[sl].float()[:, None, None, :]
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        dv[sl] = torch.einsum("bhqk,bqhd->bkhd", p, gf)
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
        ds = dp.sub_((dp * p).sum(-1, keepdim=True)).mul_(p)
        del dp, p
        if bias_grad:
            dbias[sl] = ds.sum((1, 2))
        ds.mul_(scale)
        dq[sl] = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
        dk[sl] = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq, dk, dv, dbias


def temporal_attention_reference(q, k, v, scale: float,
                                 compute_dtype=torch.bfloat16):
    """q, k, v [B, T, N, H, D] -> [B, T, N, H, D] in q's dtype: attention
    over T for each (b, n, h), P = exp2(S * scale * log2(e) - 30)."""
    dt = compute_dtype
    qh, kh, vh = (a.to(dt).float() for a in (q, k, v))
    s = torch.einsum("btnhd,bsnhd->bnhts", qh, kh)
    p = torch.exp2(s * (scale * _LOG2E) - _SHIFT)
    denom = p.sum(-1).permute(0, 3, 1, 2)[..., None]  # [B, T, N, H, 1]
    o = torch.einsum("bnhts,bsnhd->btnhd", p.to(dt).float(), vh)
    return (o / denom).to(q.dtype)


def temporal_attention_backward(q, k, v, g, scale: float):
    """The JAX custom_vjp's `_temporal_bwd`, in fp32 from the unrounded
    inputs."""
    qf, kf, vf, gf = (a.float() for a in (q, k, v, g))
    s = torch.einsum("btnhd,bsnhd->bnhts", qf, kf) * scale
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bnhts,btnhd->bsnhd", p, gf)
    dp = torch.einsum("btnhd,bsnhd->bnhts", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bnhts,bsnhd->btnhd", ds, kf)
    dk = torch.einsum("bnhts,btnhd->bsnhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernel wrappers ------------------------------------------------------------


def _plain(impl: Optional[str]) -> bool:
    """impl="plain": the plain version with torch's autograd through it;
    None: the Function (the kernel on CUDA, the plain forward on the CPU)."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    return impl == "plain"


def _check_cuda(q, k, v, kv_bias, compute_dtype) -> int:
    """What K5 takes: CUDA q [B, Lq, H, D] and k/v [B, Lk, H, D], all bf16
    or all fp32, D a multiple of 8 up to 128, each with its heads
    contiguous in a row, k and v on the same strides; kv_bias fp32 [B, Lk].
    Returns the width the kernel runs at (`card_width(D)`)."""
    if compute_dtype != torch.bfloat16:
        raise TypeError("the CUDA attention kernel computes in bfloat16 only; "
                        f"got compute_dtype={compute_dtype}")
    for t in (q, k, v):
        if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float32) \
                or t.dtype != q.dtype:
            raise TypeError("the CUDA attention kernel takes q/k/v CUDA "
                            "tensors, all bfloat16 or all float32; got "
                            f"{t.dtype} on {t.device} (q {q.dtype})")
        if t.dim() != 4 or t.stride(3) != 1 or t.stride(2) != t.shape[3]:
            raise ValueError("q/k/v must be [B, L, H, D] with heads "
                             f"contiguous in a row; got {tuple(t.shape)}, "
                             f"strides {t.stride()}")
    B, _, H, D = q.shape
    if tuple(k.shape) != tuple(v.shape) or (k.shape[0], k.shape[2],
                                            k.shape[3]) != (B, H, D):
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match")
    width = card_width(D)
    if k.stride()[:2] != v.stride()[:2]:
        raise ValueError("k and v must share their batch and row strides")
    if not 1 <= B <= 65535:
        raise ValueError(f"batch {B} is outside 1..65535 (a grid limit)")
    if kv_bias is not None and (
            not kv_bias.is_cuda or kv_bias.dtype != torch.float32
            or tuple(kv_bias.shape) != (B, k.shape[1])):
        raise TypeError(f"kv_bias must be fp32 CUDA [B, Lk] = {(B, k.shape[1])};"
                        f" got {kv_bias.dtype} {tuple(kv_bias.shape)} on "
                        f"{kv_bias.device}")
    return width


def _check_segments(q, k, segment_size: int) -> None:
    """What segment_size takes on the card: Lq == Lk, a multiple of it."""
    if segment_size < 0 or (segment_size and (
            q.shape[1] != k.shape[1] or q.shape[1] % segment_size)):
        raise ValueError(f"segment_size {segment_size} needs Lq == Lk, a "
                         f"multiple of it; got {q.shape[1]}, {k.shape[1]}")


def _attention_forward(q, k, v, kv_bias, scale, compute_dtype, cross,
                       segment_size=0, quant=""):
    if not q.is_cuda:
        return attention_reference(q, k, v, scale, compute_dtype, kv_bias,
                                   segment_size, quant)
    from .. import _ext

    width = _check_cuda(q, k, v, kv_bias, compute_dtype)
    _check_segments(q, k, segment_size)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    # a padded width: contiguous zero-padded copies, the true scale
    q, k, v = (pad_heads(t, width) for t in (q, k, v))
    bias = None if kv_bias is None else kv_bias.contiguous()
    o = torch.empty(B, Lq, H, width, device=q.device, dtype=q.dtype)
    bias_ptr = None if bias is None else bias.data_ptr()
    if quant:
        if q.dtype != torch.bfloat16:
            raise TypeError("the int8 attention forms take bfloat16 q/k/v; "
                            f"got {q.dtype}")
        blk = lq_block(Lq, _round_up(Lk, 128))
        dev = q.device
        qi = torch.empty(B, Lq, H * width, device=dev, dtype=torch.int8)
        ki = torch.empty(B, Lk, H * width, device=dev, dtype=torch.int8)
        qs = torch.empty(B, -(-Lq // blk), H, device=dev)
        ks, vs = (torch.empty(B, H, device=dev) for _ in range(2))
        _ext.call("gvf_attention_q8", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), bias_ptr, o.data_ptr(), qi.data_ptr(),
                  ki.data_ptr(), qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                  B, Lq, Lk, H, width, q.stride(0), q.stride(1), k.stride(0),
                  k.stride(1), blk, segment_size, int(quant == "qk+av"),
                  float(scale))
    else:
        _ext.call("gvf_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  bias_ptr, o.data_ptr(), B, Lq, Lk, H, width, q.stride(0),
                  q.stride(1), k.stride(0), k.stride(1), float(scale),
                  float(scale * _LOG2E), int(q.dtype == torch.float32),
                  int(width == 32), segment_size)
    launch_counts[launch_key(D, cross, bias is not None, segment_size > 0,
                             quant)] += 1
    return o if width == D else o[..., :D].contiguous()


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_bias, scale, compute_dtype, cross,
                segment_size, quant):
        ctx.save_for_backward(q, k, v, kv_bias)
        ctx.scale, ctx.segment_size = scale, segment_size
        return _attention_forward(q, k, v, kv_bias, scale, compute_dtype,
                                  cross, segment_size, quant)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_bias = ctx.saved_tensors
        dq, dk, dv, dbias = attention_backward(
            q, k, v, kv_bias, g, ctx.scale, ctx.segment_size,
            bias_grad=ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None, None, None, None, None


def fused_attention(q, k, v, scale: float, compute_dtype=torch.bfloat16, *,
                    kv_bias: Optional[torch.Tensor] = None,
                    cross: bool = False, segment_size: int = 0,
                    quant: str = "", impl: Optional[str] = None):
    """Softmax attention, q [B, Lq, H, D], k/v [B, Lk, H, D] -> [B, Lq, H, D]
    in q's dtype (a contiguous tensor, i.e. [B, Lq, H * D] as the output
    projection reads it). kv_bias [B, Lk]: an additive logit bias per key;
    -inf masks the key, and a row with no key left gives 0; it gets the
    gradient JAX's backward gives it. segment_size > 0: q and k are packed
    segments of that length (Lq == Lk, a multiple of it), attention
    block-diagonal. quant: "" | "qk" | "qk+av", the TPU kernel's int8
    forms (see attention_q8_reference); the backward is the float form's.
    `cross` names the form for the launch count (the caller's
    cross-attention, whatever its lengths)."""
    if quant not in QUANT_FORMS:
        raise ValueError(f"quant must be one of {QUANT_FORMS}, got {quant!r}")
    if _plain(impl):
        return attention_reference(q, k, v, scale, compute_dtype, kv_bias,
                                   segment_size, quant)
    return _Attention.apply(q, k, v, kv_bias, scale, compute_dtype, cross,
                            segment_size, quant)


def _check_temporal_cuda(q, k, v, compute_dtype) -> None:
    """What K6 takes: CUDA [B, T, N, H, D], D a multiple of 8 up to 128,
    all bf16 or all fp32, heads contiguous in a row, the (b, t, n) rows
    evenly strided, each base and row stride a multiple of 16 bytes (the
    kernel's cp.async). Returns the width the kernel runs at
    (`card_width(D)`)."""
    if compute_dtype != torch.bfloat16:
        raise TypeError("the CUDA temporal attention kernel computes in "
                        f"bfloat16 only; got compute_dtype={compute_dtype}")
    for t in (q, k, v):
        if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float32) \
                or t.dtype != q.dtype:
            raise TypeError("the CUDA temporal attention kernel takes q/k/v "
                            "CUDA tensors, all bfloat16 or all float32; got "
                            f"{t.dtype} on {t.device} (q {q.dtype})")
        if tuple(t.shape) != tuple(q.shape) or t.dim() != 5:
            raise ValueError(f"q/k/v must share one [B, T, N, H, D] shape; "
                             f"got {tuple(q.shape)}, {tuple(t.shape)}")
        B, T, N, H, D = t.shape
        rs = t.stride(2)
        if (t.stride(4) != 1 or t.stride(3) != D or t.stride(1) != N * rs
                or t.stride(0) != T * N * rs):
            raise ValueError("q/k/v must have heads contiguous in a row and "
                             "evenly strided (b, t, n) rows; got strides "
                             f"{t.stride()}")
        if t.data_ptr() % 16 or rs * t.element_size() % 16:
            raise ValueError("q/k/v must start at a 16-byte boundary with "
                             "rows a multiple of 16 bytes apart; got offset "
                             f"{t.data_ptr() % 16}, row stride {rs}")
    return card_width(q.shape[-1])


def _temporal_forward(q, k, v, scale, compute_dtype):
    if not q.is_cuda:
        return temporal_attention_reference(q, k, v, scale, compute_dtype)
    from .. import _ext

    width = _check_temporal_cuda(q, k, v, compute_dtype)
    B, T, N, H, D = q.shape
    # a padded width: contiguous zero-padded copies, the true scale
    q, k, v = (pad_heads(t, width) for t in (q, k, v))
    o = torch.empty(B, T, N, H, width, device=q.device, dtype=q.dtype)
    _ext.call("gvf_temporal_attention", q.data_ptr(), k.data_ptr(),
              v.data_ptr(), o.data_ptr(), B, T, N, H, width, q.stride(2),
              k.stride(2), v.stride(2), float(scale * _LOG2E),
              int(q.dtype == torch.float32))
    launch_counts[temporal_launch_key(D)] += 1
    return o if width == D else o[..., :D].contiguous()


class _TemporalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, compute_dtype):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _temporal_forward(q, k, v, scale, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*temporal_attention_backward(q, k, v, g, ctx.scale), None,
                None)


def temporal_attention(q, k, v, scale: float, compute_dtype=torch.bfloat16,
                       *, impl: Optional[str] = None):
    """Attention over T for each (b, n, h): q, k, v [B, T, N, H, D] ->
    [B, T, N, H, D] (contiguous) in q's dtype."""
    if _plain(impl):
        return temporal_attention_reference(q, k, v, scale, compute_dtype)
    return _TemporalAttention.apply(q, k, v, scale, compute_dtype)
