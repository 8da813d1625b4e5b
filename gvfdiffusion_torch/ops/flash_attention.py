"""K7, streaming flash attention over key validity (port of
gvfdiffusion_tpu/sparse/attention.py:57-92 `_flash_full_attention`, which
runs the stock Pallas TPU `flash_attention` with the key validity as
segment ids).

What it computes, as the TPU kernel does:
  * every query row, whether its slot is valid or not: the JAX code gives
    every query segment 1, so an invalid query row attends to the valid
    keys (its output is discarded downstream);
  * scores q . k in fp32 from the inputs' values, times `scale`, plus the
    additive mask value -0.7 * FLT_MAX on every invalid key (not -inf);
  * softmax with the row sum from the fp32 P, and P rounded to v's dtype
    for the P V product;
  * a batch row with no valid key: every score equals the mask value, so P
    is 1 on every key of the key count padded to a multiple of 512 (the
    TPU kernel's block) and the output is the sum of V over the real keys
    divided by that padded count.

Two versions:
  * `flash_attention_reference`, plain torch, in chunks of query rows (the
    SLat torso's [1, 16, 32768, 32768] fp32 scores would take 64 GiB);
  * `flash_attention`, the wrapper: on a CPU tensor, or with
    impl="plain", the plain version; on a CUDA tensor the kernel of
    `csrc/flash_attention.cu`: q/k/v all bf16 (the Hopper attention core
    over the list of key tiles that hold a valid key, P rounded to bf16)
    or all fp32 (the same core's 3xTF32 path: no operand rounded to bf16,
    each product split into three tf32 products with fp32 sums; the SLat
    flow as the registry builds it). The kernels run natively at heads of
    32, 64 and 128; above 128 lanes `csrc/flash_attention_wide.cu`'s
    kernels (a cluster of CTAs along the head's lanes forming each tile
    pair's scores once: bf16 on wgmma, fp32 on mma.sync 3xTF32) run every
    multiple of 64 that `_widths.wide_split` splits, with no cap on D. A
    head of any other multiple of 8 (the widths
    `sparse/attention.full_sparse_attention` sends here) is zero-padded
    to the next width the kernels run
    (`_widths.flash_card_width`, `pad_heads`), run with the true width's
    scale, and its output cut back to its D columns: zero columns change no
    score and no logsumexp, so the padding is the design, not a departure
    from JAX's function. It raises for anything else (not a multiple of 8)
    and never falls back: an fp32 input is never cast to reach the bf16
    kernel.

The gradient (port of the stock kernel's `_flash_attention_bwd_dkv` and
`_flash_attention_bwd_dq`, which JAX runs when a trainer differentiates
through `_flash_full_attention`: the static VAE's `full` mode, at any head
width and in bf16 too): when grad mode is on and q, k or v requires grad,
the wrapper runs `FlashAttention`, a `torch.autograd.Function`, in every
form the forward has (bf16 or fp32, every head width, padded as the
forward pads: q, k, v and dO go in padded, the padded o is saved with its
logsumexp, and o, dq, dk and dv come back cut to D). On the card its
forward is the kernel with the row logsumexp and its list of the key
tiles that hold a valid key as residuals (the TPU kernel saves its running
max and sum) and its backward takes di = rowsum(o * dO) in fp32 plain
torch, as JAX does, then two kernels that walk the listed tiles alone
(exact: an unlisted tile's P is 0): dkv (dK, dV; zeroed here first, so an
unlisted tile's stay 0) and dq. In fp32 (`csrc/flash_attention_bwd.cu`)
each of their five products runs on the tensor cores by the forward's
3xTF32 split, in chains of at most 32 rows or keys summed in fp32; in
bf16 (`csrc/flash_attention_bwd_bf16.cu`) on bf16 wgmma from bf16
operands into fp32, P and dS rounded to bf16 before the products that
take them, each gradient rounded to bf16 once. Above 128 lanes both are
`csrc/flash_attention_wide.cu`'s, the same arithmetic (bf16 on wgmma,
fp32 on mma.sync): a cluster of CTAs along the head's lanes
(`_widths.wide_split`; passes of clusters above 3072 lanes) forms each
tile pair's scores once, summed through the cluster's shared memory. A
kernel that does not build or launch raises; nothing falls back to the
plain version. On the CPU, or with impl="plain", forward and backward are
the plain versions
(`flash_attention_backward_reference`, in chunks of query rows too), with
the stock kernel's semantics: P = exp(s - m) / l on the -0.7 * FLT_MAX
mask, every query row, and a batch row with no valid key spreading P = 1 /
Lk-padded-to-512 over every key, so its keys get dV != 0.

`launch_counts` counts kernel launches by form: the forward by dtype and
the caller's head width (the true one, not the padded one),
"flash_attention" (bf16, heads of 64), "flash_attention_fp32", and either
with "_d32", "_d96", "_d768", ... at the other widths (`launch_key`);
under grad, per form, the forward with its residual and the two backward
kernels
(`grad_key`: "flash_attention_fp32_res", "flash_attention_bwd_dkv",
"flash_attention_bwd_dq" at fp32 and heads of 64, "flash_attention_res",
"flash_attention_bwd_dkv_bf16", ... in bf16, "_d32", "_d96", ... at the
other widths). The counters are made at import for every multiple of 8
up to 4096 (`_widths.FLASH_WIDTHS`), a wider head's at its first launch.
The plain versions never count.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._widths import (CARD_WIDTHS, FLASH_WIDTHS, flash_card_width,
                      pad_heads, wide_split, width_suffix)

# the Pallas kernel's additive mask value (jax.experimental.pallas.ops.tpu.
# flash_attention.DEFAULT_MASK_VALUE)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# the JAX call's block size: keys are padded to a multiple of it
BLOCK = 512
# score elements per chunk of the plain version ([B, H, rows, Lk] fp32: 512 MB)
_SCORES = 1 << 27

# the widths the kernels are built at (a head of another width is padded)
HEAD_WIDTHS = CARD_WIDTHS
DTYPES = (torch.bfloat16, torch.float32)
GRAD_KINDS = ("res", "bwd_dkv", "bwd_dq")


def launch_key(dtype: torch.dtype, head_dim: int) -> str:
    """The counter of a forward launch: its dtype and head width."""
    return ("flash_attention" + ("_fp32" if dtype == torch.float32 else "")
            + width_suffix(head_dim))


def grad_key(kind: str, dtype: torch.dtype, head_dim: int) -> str:
    """The counter of a launch under grad: `kind` "res" (the forward with
    its residual), "bwd_dkv" or "bwd_dq", at a dtype and head width (fp32
    at heads of 64 keeps the names it had as the only such form)."""
    f32 = dtype == torch.float32
    if kind == "res":
        return ("flash_attention" + ("_fp32" if f32 else "") + "_res"
                + width_suffix(head_dim))
    return (f"flash_attention_{kind}" + ("" if f32 else "_bf16")
            + width_suffix(head_dim))


launch_counts = {launch_key(dt, w): 0 for dt in DTYPES
                 for w in FLASH_WIDTHS}
launch_counts.update({grad_key(kind, dt, w): 0 for kind in GRAD_KINDS
                      for dt in DTYPES for w in FLASH_WIDTHS})


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _count(key: str) -> None:
    """One launch under `key`, its counter made at the first."""
    launch_counts[key] = launch_counts.get(key, 0) + 1


def key_tile(dtype: torch.dtype, head_dim: int) -> int:
    """The kernel's key tile, the unit of its list of visited tiles: in
    bf16 128 keys at heads of 32 and 64, 64 at 128 (the Hopper core's); in
    fp32 64, 32 at 128 (its 3xTF32 path's); 64 in both above 128 (the wide
    kernels'); a padded head takes its card width's."""
    w = flash_card_width(head_dim)
    if w > 128:
        return 64
    return (64 if dtype == torch.float32 else 128) // (2 if w == 128 else 1)


def padded_keys(lk: int) -> int:
    """The key count the TPU kernel runs over: Lk padded to BLOCK."""
    return -(-lk // BLOCK) * BLOCK


def _padded(k, v, kv_valid):
    """k, v as fp32 and kv_valid, padded with invalid keys to BLOCK; the
    additive mask [B, 1, 1, Lk_pad]; the rows of queries per chunk."""
    B, Lk, H, _ = k.shape
    pad = padded_keys(Lk) - Lk
    kf, vf = k.float(), v.float()
    if pad:
        kf, vf = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                  for a in (kf, vf))
        kv_valid = torch.nn.functional.pad(kv_valid, (0, pad))
    bias = torch.where(kv_valid, 0.0, MASK_VALUE).float()[:, None, None, :]
    return kf, vf, bias, max(1, _SCORES // (B * H * (Lk + pad)))


def flash_attention_reference(q, k, v, kv_valid, scale: float):
    """q [B, Lq, H, D], k/v [B, Lk, H, D], kv_valid bool [B, Lk] ->
    [B, Lq, H, D] in q's dtype."""
    kf, vf, bias, rows = _padded(k, v, kv_valid)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for i0 in range(0, q.shape[1], rows):
        qc = q[:, i0:i0 + rows].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * scale + bias
        p = torch.exp(s - s.amax(-1, keepdim=True))
        del s
        denom = p.sum(-1).transpose(1, 2)[..., None]  # [B, rows, H, 1]
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
        out[:, i0:i0 + rows] = (o / denom).to(q.dtype)
    return out


def flash_attention_backward_reference(q, k, v, kv_valid, scale: float, o,
                                       do):
    """The gradient of `flash_attention_reference` as the stock kernel's
    backward computes it: o [B, Lq, H, D] the forward's output, do its
    gradient -> (dq, dk, dv) in q's, k's and v's dtypes. P = exp(s - m) /
    l from the fp32 scores with the mask, di = rowsum(o * do) in fp32, dS =
    P (dO . v - di) scale; P and dS are rounded to dO's dtype for dV and
    dK and dS to k's for dQ, as the kernels cast them."""
    Lk = k.shape[1]
    kf, vf, bias, rows = _padded(k, v, kv_valid)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2)  # [B, H, Lq]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i0 in range(0, q.shape[1], rows):
        qc, doc = (a[:, i0:i0 + rows].float() for a in (q, do))
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * scale + bias
        p = torch.exp(s - s.amax(-1, keepdim=True))
        del s
        p = p / p.sum(-1, keepdim=True)
        dv += torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), doc)
        dp = torch.einsum("bqhd,bkhd->bhqk", doc, vf)
        ds = (dp - di[:, :, i0:i0 + rows, None]) * p * scale
        del dp, p
        dq[:, i0:i0 + rows] = torch.einsum(
            "bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf).to(q.dtype)
        dk += torch.einsum("bhqk,bqhd->bkhd", ds.to(do.dtype).float(), qc)
    return dq, dk[:, :Lk].to(k.dtype), dv[:, :Lk].to(v.dtype)


def _check_cuda(q, k, v, kv_valid) -> int:
    """What the kernel takes: CUDA q [B, Lq, H, D] and k/v [B, Lk, H, D],
    all bf16 or all fp32, D a multiple of 8, each with its heads
    contiguous in a row and rows on 16-byte boundaries; kv_valid bool [B,
    Lk]. Returns the width the kernels run at (`flash_card_width(D)`)."""
    for t in (q, k, v):
        if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float32) \
                or t.dtype != q.dtype:
            raise TypeError("the CUDA flash attention kernel takes q/k/v "
                            "CUDA tensors, all bfloat16 or all float32; got "
                            f"{t.dtype} on {t.device} (q {q.dtype})")
        if t.dim() != 4 or t.stride(3) != 1 or t.stride(2) != t.shape[3]:
            raise ValueError("q/k/v must be [B, L, H, D] with heads "
                             f"contiguous in a row; got {tuple(t.shape)}, "
                             f"strides {t.stride()}")
        per16 = 16 // t.element_size()
        if t.data_ptr() % 16 or t.stride(1) % per16 or t.stride(0) % per16:
            raise ValueError("q/k/v rows must start on 16-byte boundaries; "
                             f"got strides {t.stride()}")
    B, _, H, D = q.shape
    width = flash_card_width(D)  # raises for a width K7 does not take
    if tuple(k.shape) != tuple(v.shape) or (k.shape[0], k.shape[2],
                                            k.shape[3]) != (B, H, D):
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match")
    if not 1 <= B <= 65535 or H > 65535:
        raise ValueError(f"batch {B} / heads {H} exceed the grid's 65535")
    if (not kv_valid.is_cuda or kv_valid.dtype != torch.bool
            or tuple(kv_valid.shape) != (B, k.shape[1])):
        raise TypeError(f"kv_valid must be a bool CUDA [B, Lk] = "
                        f"{(B, k.shape[1])}; got {kv_valid.dtype} "
                        f"{tuple(kv_valid.shape)} on {kv_valid.device}")
    return width


def launch_forward(q, k, v, kv_valid, scale: float, residual: bool,
                   width: Optional[int] = None):
    """The forward kernel -> (o, and with `residual` the row logsumexp
    [B, H, Lq] fp32, the list of the key tiles (`key_tile` keys each) that
    hold a valid key [B, 1 + tiles] (per row their count, then their
    indices) and the contiguous validity, which the backward reads). The
    caller has checked the inputs, and q, k and v are at a card width
    (padded by the caller); `width` is the caller's head width before the
    padding, the one its counter names (default: q's)."""
    from .. import _ext

    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    valid = kv_valid.contiguous()
    f32 = q.dtype == torch.float32
    # each row's count of visited key tiles, then their indices
    scratch = torch.empty(B, 1 + -(-Lk // key_tile(q.dtype, D)),
                          dtype=torch.int32, device=q.device)
    o = torch.empty(B, Lq, H, D, dtype=q.dtype, device=q.device)
    lse = (torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
           if residual else None)
    entry = "gvf_flash_attention" + ("_wide" if D > 128 else "")
    _ext.call(entry, q.data_ptr(), k.data_ptr(),
              v.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
              o.data_ptr(), 0 if lse is None else lse.data_ptr(), B, Lq, Lk,
              H, D,
              q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
              v.stride(1), float(scale), padded_keys(Lk), int(f32),
              *_split(D))
    if residual:
        _count(grad_key("res", q.dtype, width or D))
        return o, lse, scratch, valid
    _count(launch_key(q.dtype, width or D))
    return o


def backward_inputs(q, k, v, valid, tiles, lse, o, do):
    """The pointers and sizes both backward kernels take, with do
    contiguous and di = rowsum(o * do) [B, H, Lq] in fp32 (plain torch, as
    JAX computes it outside the kernels); the tensors it makes are kept in
    the returned tuple's last item until the launches."""
    B, Lq, H, D = q.shape
    do = do.contiguous()
    if do.dtype != q.dtype or tuple(do.shape) != tuple(o.shape):
        raise TypeError(f"flash_attention backward: dO must be {q.dtype} "
                        f"{tuple(o.shape)}; got {do.dtype} "
                        f"{tuple(do.shape)}")
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            tiles.data_ptr(), lse.data_ptr(), do.data_ptr(), di.data_ptr())
    sizes = (B, Lq, k.shape[1], H, D, q.stride(0), q.stride(1), k.stride(0),
             k.stride(1), v.stride(0), v.stride(1))
    return ptrs, sizes, (do, di)


def _entry(kind: str, dtype: torch.dtype, width: int) -> str:
    """The C entry of a backward kernel at a card width: fp32 in
    flash_attention_bwd.cu, bf16 in flash_attention_bwd_bf16.cu, above 128
    lanes both in flash_attention_wide.cu ("_wide")."""
    return ("gvf_flash_attention_" + ("wide_" if width > 128 else "") + kind
            + ("" if dtype == torch.float32 else "_bf16"))


def _split(width: int) -> tuple:
    """The wide entries' last arguments, the lanes a CTA owns and the
    CTAs a cluster (`wide_split`; the kernels take the passes as D over
    their product); nothing for the entries of heads up to 128."""
    return wide_split(width) if width > 128 else ()


def launch_dkv(ptrs, sizes, scale: float, dtype: torch.dtype,
               width: Optional[int] = None):
    """The dkv kernel -> (dk, dv) [B, Lk, H, D] in `dtype` (q/k/v's),
    zeroed first: the kernel writes the listed key tiles alone. D is the
    card width of `sizes`; `width` the caller's, as `launch_forward`."""
    from .. import _ext

    B, _, Lk, H, D = sizes[:5]
    dk = torch.zeros(B, Lk, H, D, dtype=dtype,
                     device=torch.device("cuda", torch.cuda.current_device()))
    dv = torch.zeros_like(dk)
    _ext.call(_entry("bwd_dkv", dtype, D), *ptrs, dk.data_ptr(), dv.data_ptr(),
              *sizes, float(scale), padded_keys(Lk), *_split(D))
    _count(grad_key("bwd_dkv", dtype, width or D))
    return dk, dv


def launch_dq(ptrs, sizes, scale: float, dtype: torch.dtype,
              width: Optional[int] = None):
    """The dq kernel -> dq [B, Lq, H, D] in `dtype` (D and `width` as
    `launch_dkv`'s)."""
    from .. import _ext

    B, Lq, Lk, H, D = sizes[:5]
    dq = torch.empty(B, Lq, H, D, dtype=dtype,
                     device=torch.device("cuda", torch.cuda.current_device()))
    _ext.call(_entry("bwd_dq", dtype, D), *ptrs, dq.data_ptr(), *sizes,
              float(scale), padded_keys(Lk), *_split(D))
    _count(grad_key("bwd_dq", dtype, width or D))
    return dq


class FlashAttention(torch.autograd.Function):
    """K7 under autograd: the kernels on the card (every dtype and head
    width of the forward; q, k, v and dO padded to the card width, the
    padded o saved, o and the gradients cut back), the plain versions on
    the CPU or with impl="plain"."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, scale: float, plain: bool):
        ctx.scale, ctx.plain = scale, plain
        if plain:
            o = flash_attention_reference(q, k, v, kv_valid, scale)
            ctx.save_for_backward(q, k, v, kv_valid, o)
            return o
        D = q.shape[-1]
        q, k, v = (pad_heads(t, flash_card_width(D)) for t in (q, k, v))
        o, lse, tiles, valid = launch_forward(q, k, v, kv_valid, scale,
                                               residual=True, width=D)
        ctx.save_for_backward(q, k, v, valid, tiles, lse, o)
        ctx.width = D
        return o if o.shape[-1] == D else o[..., :D].contiguous()

    @staticmethod
    def backward(ctx, do):
        if ctx.plain:
            q, k, v, kv_valid, o = ctx.saved_tensors
            grads = flash_attention_backward_reference(q, k, v, kv_valid,
                                                       ctx.scale, o, do)
        else:
            saved = ctx.saved_tensors  # read once (checkpoint's rule)
            dtype, D = saved[0].dtype, ctx.width
            do = pad_heads(do, saved[0].shape[-1])
            with torch.cuda.device(saved[0].device):
                ptrs, sizes, keep = backward_inputs(*saved, do)
                dk, dv = launch_dkv(ptrs, sizes, ctx.scale, dtype, D)
                grads = launch_dq(ptrs, sizes, ctx.scale, dtype, D), dk, dv
            del keep
            grads = tuple(g[..., :D] for g in grads)
        return (*grads, None, None, None)


def flash_attention(q, k, v, kv_valid, scale: float,
                    impl: Optional[str] = None):
    """Softmax attention of q [B, Lq, H, D] over the valid keys of k/v
    [B, Lk, H, D] (kv_valid bool [B, Lk]) -> [B, Lq, H, D] in q's dtype,
    contiguous; differentiable in q, k and v."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    plain = impl == "plain" or not q.is_cuda
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if not plain:
        width = _check_cuda(q, k, v, kv_valid)
    if grad:
        return FlashAttention.apply(q, k, v, kv_valid, scale, plain)
    if plain:
        return flash_attention_reference(q, k, v, kv_valid, scale)
    D = q.shape[-1]
    o = launch_forward(*(pad_heads(t, width) for t in (q, k, v)), kv_valid,
                       scale, residual=False, width=D)
    return o if width == D else o[..., :D].contiguous()
