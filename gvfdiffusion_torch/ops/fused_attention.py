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
    K5 at heads of 32 take the TPU kernels' fixed shift, P = exp2(S * scale
    * log2(e) - 30); K5 at heads of 64 takes exp(S - the row maximum)
    instead, as its CUDA kernel keeps a running maximum (DINOv2's un-normed
    logits may pass the fixed shift's range of about +-90).
  * the wrapper (`fused_attention`, `temporal_attention`): dispatches on the
    device of `q`. A CUDA tensor runs the hand-written kernel
    (`csrc/fused_attention.cu`, `csrc/temporal_attention.cu`); a CPU tensor
    runs the plain version. It is a `torch.autograd.Function` whose
    backward is the JAX custom_vjp's (`_bwd` :345, `_temporal_bwd` :505):
    the plain softmax-attention gradient in fp32 from the saved, unrounded
    q/k/v (neither TPU kernel has a backward kernel). `impl="plain"` runs
    the plain version instead, with torch's own autograd through it, for
    comparing the two on the card.

K5 serves heads of 64 in bf16 (DINOv2, the TRELLIS flows: self, cross with
Lq != Lk, and self with a [B, Lk] fp32 `kv_bias` whose -inf entries mask
keys) and heads of 32 in fp32 or bf16 (the DiT's composed path: spatial
self and the image and static cross-attentions; heads of 64 in fp32 in the
DiT's 8-head configuration). `kv_bias` gets no gradient. K6 serves heads
of 32 or 64 in fp32 or bf16. `segment_size` and `quant` are not ported.
The kernels read q and k/v with their own strides, so the views of a qkv
or kv projection go in without copies.

`launch_counts` counts kernel launches by the form the caller runs and the
head width: "attention", "attention_cross" and "attention_bias" at heads
of 64, the same names with "_d32" at heads of 32, and
"temporal_attention"; the plain version never counts.
"""

from __future__ import annotations

from typing import Optional

import torch

# the TPU kernel holds the whole key extent in VMEM: its longest key count
MAX_LK = 4096
_LANES = 128
_LOG2E = 1.4426950408889634
_SHIFT = 30.0  # the TPU kernels' fixed exp2 shift
_TEMPORAL_NC = 16  # voxels per TPU grid cell; only `temporal_supports` reads it
# scores per chunk of the plain backward ([rows, H, Lq, Lk] fp32: 512 MB)
_BWD_SCORES = 1 << 27

launch_counts = {f"attention{form}{width}": 0
                 for width in ("", "_d32")
                 for form in ("", "_cross", "_bias")}
launch_counts["temporal_attention"] = 0


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def launch_key(head_dim: int, cross: bool, bias: bool) -> str:
    """The counter of a K5 launch: its form (self, cross, or with a key
    bias) as the caller runs it, and its head width."""
    form = "_bias" if bias else "_cross" if cross else ""
    return f"attention{form}{'_d32' if head_dim == 32 else ''}"


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


def attention_reference(q, k, v, scale: float, compute_dtype=torch.bfloat16,
                        kv_bias: Optional[torch.Tensor] = None):
    """q [B, Lq, H, D]; k, v [B, Lk, H, D]; kv_bias [B, Lk] or None ->
    [B, Lq, H, D] in q's dtype. Heads of 32 take P = exp2(S * scale *
    log2(e) - 30 + bias * log2(e)), heads of 64 exp of S minus the row
    maximum."""
    dt = compute_dtype
    qh, kh, vh = (a.to(dt).float() for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    if q.shape[-1] == 32:
        shift = _SHIFT
        if kv_bias is not None:
            shift = _SHIFT - kv_bias.float()[:, None, None, :] * _LOG2E
        p = torch.exp2(s * (scale * _LOG2E) - shift)
    else:
        s = s * scale
        if kv_bias is not None:
            s = s + kv_bias.float()[:, None, None, :]
        m = s.amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)
    denom = p.sum(-1).transpose(1, 2)[..., None]  # [B, Lq, H, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), vh)
    return (o / denom.clamp_min(1e-30)).to(q.dtype)


def attention_backward(q, k, v, kv_bias, g, scale: float):
    """The JAX custom_vjp's `_bwd`: the gradient of softmax(q k^T * scale +
    bias) v with respect to q, k, v, in fp32 from the unrounded inputs, in
    chunks of batch rows (the [B, H, Lq, Lk] scores of the DiT's image
    cross-attention would take 2.2 GB each at once)."""
    B, Lq, H, _ = q.shape
    Lk = k.shape[1]
    rows = max(1, _BWD_SCORES // (H * Lq * Lk))
    dq, dk, dv = (torch.empty_like(a) for a in (q, k, v))
    for b0 in range(0, B, rows):
        sl = slice(b0, b0 + rows)
        qf, kf, vf, gf = (a[sl].float() for a in (q, k, v, g))
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        if kv_bias is not None:
            s = s + kv_bias[sl].float()[:, None, None, :]
        p = torch.softmax(s, dim=-1)
        del s
        dv[sl] = torch.einsum("bhqk,bqhd->bkhd", p, gf)
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
        ds = dp.sub_((dp * p).sum(-1, keepdim=True)).mul_(p).mul_(scale)
        del dp, p
        dq[sl] = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
        dk[sl] = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq, dk, dv


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


def _check_cuda(q, k, v, kv_bias, compute_dtype) -> None:
    """What K5 takes: CUDA q [B, Lq, H, D] and k/v [B, Lk, H, D], all bf16
    or all fp32, D = 32 or 64, each with its heads contiguous in a row, k
    and v on the same strides; kv_bias fp32 [B, Lk]."""
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
    if D not in (32, 64):
        raise ValueError(f"head width must be 32 or 64, got {D}")
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


def _attention_forward(q, k, v, kv_bias, scale, compute_dtype, cross):
    if not q.is_cuda:
        return attention_reference(q, k, v, scale, compute_dtype, kv_bias)
    from .. import _ext

    _check_cuda(q, k, v, kv_bias, compute_dtype)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    bias = None if kv_bias is None else kv_bias.contiguous()
    o = torch.empty(B, Lq, H, D, device=q.device, dtype=q.dtype)
    _ext.call("gvf_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if bias is None else bias.data_ptr(), o.data_ptr(), B, Lq,
              Lk, H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
              float(scale), float(scale * _LOG2E),
              int(q.dtype == torch.float32), int(D == 32))
    launch_counts[launch_key(D, cross, bias is not None)] += 1
    return o


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_bias, scale, compute_dtype, cross):
        ctx.save_for_backward(q, k, v, kv_bias)
        ctx.scale = scale
        return _attention_forward(q, k, v, kv_bias, scale, compute_dtype,
                                  cross)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_bias = ctx.saved_tensors
        return (*attention_backward(q, k, v, kv_bias, g, ctx.scale), None,
                None, None, None)


def fused_attention(q, k, v, scale: float, compute_dtype=torch.bfloat16, *,
                    kv_bias: Optional[torch.Tensor] = None,
                    cross: bool = False, impl: Optional[str] = None):
    """Softmax attention, q [B, Lq, H, D], k/v [B, Lk, H, D] -> [B, Lq, H, D]
    in q's dtype (a contiguous tensor, i.e. [B, Lq, H * D] as the output
    projection reads it). kv_bias [B, Lk]: an additive logit bias per key;
    -inf masks the key, and a row with no key left gives 0. `cross` names
    the form for the launch count (the caller's cross-attention, whatever
    its lengths)."""
    if _plain(impl):
        return attention_reference(q, k, v, scale, compute_dtype, kv_bias)
    if kv_bias is not None and kv_bias.requires_grad \
            and torch.is_grad_enabled():
        raise NotImplementedError("kv_bias gets no gradient: the JAX "
                                  "backward's bias gradient is not ported")
    return _Attention.apply(q, k, v, kv_bias, scale, compute_dtype, cross)


def _check_temporal_cuda(q, k, v, compute_dtype) -> None:
    """What K6 takes: CUDA [B, T, N, H, D], D = 32 or 64, all bf16 or all
    fp32, heads contiguous in a row, the (b, t, n) rows evenly strided, each
    base and row stride a multiple of 16 bytes (the kernel's cp.async)."""
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
    if q.shape[-1] not in (32, 64):
        raise ValueError(f"head width must be 32 or 64, got {q.shape[-1]}")


def _temporal_forward(q, k, v, scale, compute_dtype):
    if not q.is_cuda:
        return temporal_attention_reference(q, k, v, scale, compute_dtype)
    from .. import _ext

    _check_temporal_cuda(q, k, v, compute_dtype)
    B, T, N, H, D = q.shape
    o = torch.empty(B, T, N, H, D, device=q.device, dtype=q.dtype)
    _ext.call("gvf_temporal_attention", q.data_ptr(), k.data_ptr(),
              v.data_ptr(), o.data_ptr(), B, T, N, H, D, q.stride(2),
              k.stride(2), v.stride(2), float(scale * _LOG2E),
              int(q.dtype == torch.float32))
    launch_counts["temporal_attention"] += 1
    return o


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
