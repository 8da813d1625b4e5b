"""K5: softmax attention on [B, L, H, D] (port of
gvfdiffusion_tpu/ops/fused_attention.py:370 `fused_attention` and its
dispatch rule `supports`, :386).

Two versions:
  * `attention_reference`: plain torch. Rounds q/k/v to `compute_dtype`,
    takes the scores (plus the optional per-key `kv_bias`) and the softmax
    in fp32 (max-shifted), rounds P to `compute_dtype` for the P V product
    and divides by the row sum of the fp32 P, clamped at 1e-30 so that a
    row whose keys are all masked gives 0: the rounding points of the TPU
    kernel's dense branch (`_attn_kernel_dense`, which heads of 64 take).
  * `fused_attention`: dispatches on the device of `q`. A CUDA tensor runs
    the hand-written kernel of `csrc/fused_attention.cu`; a CPU tensor runs
    the plain version. `impl="plain"` forces the plain version on any
    device, for comparing the two on the card.

The ported forms are those the port's callers run, all at heads of 64 in
bf16: self-attention (DINOv2, the sparse-structure flow), cross-attention
with Lq != Lk (the sparse-structure flow's image tokens), and
self-attention with a [B, Lk] fp32 `kv_bias` whose -inf entries mask keys
(the SLat torso's key validity). `segment_size`, `quant`, heads of 32 and
the backward are not ported. The kernel reads q and k/v with their own
strides, so the views of a [B, L, 3, H, D] qkv or a [B, Lk, 2, H, D] kv
projection go in without copies.

`launch_counts` counts kernel launches by form: "attention" (self, no
bias), "attention_cross" (no bias, Lq != Lk or another q than k's shape)
and "attention_bias" (with kv_bias); the plain version never counts.
"""

from __future__ import annotations

from typing import Optional

import torch

from .fused_sublayer import _use_kernel

# the TPU kernel holds the whole key extent in VMEM: its longest key count
MAX_LK = 4096

launch_counts = {"attention": 0, "attention_cross": 0, "attention_bias": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def supports(q_shape, k_shape) -> bool:
    """The JAX dispatch rule `fa.supports`: the kernel serves Lq >= 128,
    128 <= Lk <= 4096, head widths that are a multiple of 8 up to 128 and
    rows of a multiple of 128 lanes; other shapes take XLA's attention."""
    _, Lq, H, D = q_shape
    Lk = k_shape[1]
    return (Lq >= 128 and 128 <= Lk <= MAX_LK and D <= 128 and D % 8 == 0
            and (H * D) % 128 == 0)


def attention_reference(q, k, v, scale: float, compute_dtype=torch.bfloat16,
                        kv_bias: Optional[torch.Tensor] = None):
    """q [B, Lq, H, D]; k, v [B, Lk, H, D]; kv_bias [B, Lk] or None ->
    [B, Lq, H, D] in q's dtype."""
    dt = compute_dtype
    qh, kh, vh = (a.to(dt).float() for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    if kv_bias is not None:
        s = s + kv_bias.float()[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    denom = p.sum(-1).transpose(1, 2)[..., None]  # [B, Lq, H, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), vh)
    return (o / denom.clamp_min(1e-30)).to(q.dtype)


def _check_cuda(q, k, v, kv_bias, compute_dtype) -> None:
    """What the kernel takes: bf16 CUDA q [B, Lq, H, 64] and k/v
    [B, Lk, H, 64], each with its heads contiguous in a row, k and v on the
    same strides; kv_bias fp32 [B, Lk]."""
    if compute_dtype != torch.bfloat16:
        raise TypeError("the CUDA attention kernel computes in bfloat16 only; "
                        f"got compute_dtype={compute_dtype}")
    for t in (q, k, v):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise TypeError("the CUDA attention kernel takes bfloat16 CUDA "
                            f"tensors; got {t.dtype} on {t.device}")
        if t.dim() != 4 or t.stride(3) != 1 or t.stride(2) != t.shape[3]:
            raise ValueError("q/k/v must be [B, L, H, D] with heads "
                             f"contiguous in a row; got {tuple(t.shape)}, "
                             f"strides {t.stride()}")
    B, _, H, D = q.shape
    if tuple(k.shape) != tuple(v.shape) or (k.shape[0], k.shape[2],
                                            k.shape[3]) != (B, H, D):
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match")
    if D != 64:
        raise ValueError(f"head width must be 64, got {D}")
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


def fused_attention(q, k, v, scale: float, compute_dtype=torch.bfloat16, *,
                    kv_bias: Optional[torch.Tensor] = None,
                    impl: Optional[str] = None):
    """Softmax attention, q [B, Lq, H, D], k/v [B, Lk, H, D] -> [B, Lq, H, D]
    (a contiguous tensor, i.e. [B, Lq, H * D] as the output projection
    reads it). kv_bias [B, Lk]: an additive logit bias per key; -inf masks
    the key, and a row with no key left gives 0."""
    if not _use_kernel(q, impl):
        return attention_reference(q, k, v, scale, compute_dtype, kv_bias)
    from .. import _ext

    _check_cuda(q, k, v, kv_bias, compute_dtype)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    bias = None if kv_bias is None else kv_bias.contiguous()
    o = torch.empty(B, Lq, H, D, device=q.device, dtype=torch.bfloat16)
    _ext.call("gvf_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if bias is None else bias.data_ptr(), o.data_ptr(), B, Lq,
              Lk, H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
              float(scale))
    if bias is not None:
        launch_counts["attention_bias"] += 1
    elif q.shape == k.shape:
        launch_counts["attention"] += 1
    else:
        launch_counts["attention_cross"] += 1
    return o
