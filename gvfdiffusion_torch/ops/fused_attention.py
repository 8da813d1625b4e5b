"""K5: softmax attention on [B, L, H, D] (port of
gvfdiffusion_tpu/ops/fused_attention.py:370 `fused_attention`).

Two versions:
  * `attention_reference`: plain torch. Rounds q/k/v to `compute_dtype`,
    takes the scores and the softmax in fp32 (max-shifted), rounds P to
    `compute_dtype` for the P V product and divides by the row sum of the
    fp32 P: the rounding points of the TPU kernel's dense branch
    (`_attn_kernel_dense`, which DINOv2's heads of 64 take).
  * `fused_attention`: dispatches on the device of `q`. A CUDA tensor runs
    the hand-written kernel of `csrc/fused_attention.cu`; a CPU tensor runs
    the plain version. `impl="plain"` forces the plain version on any
    device, for comparing the two on the card.

Only the configuration DINOv2 runs is ported: self-attention (Lq = Lk),
heads of 64, bf16, no `kv_bias`, no `segment_size`, no `quant`. The kernel
reads q/k/v with strides, so the q/k/v views of a [B, L, 3, H, D] qkv
projection go in without copies.

`launch_counts["attention"]` counts kernel launches; the plain version
never counts.
"""

from __future__ import annotations

from typing import Optional

import torch

from .fused_sublayer import _use_kernel

launch_counts = {"attention": 0}


def reset_launch_counts() -> None:
    launch_counts["attention"] = 0


def attention_reference(q, k, v, scale: float, compute_dtype=torch.bfloat16):
    """q [B, Lq, H, D]; k, v [B, Lk, H, D] -> [B, Lq, H, D] in q's dtype."""
    dt = compute_dtype
    qh, kh, vh = (a.to(dt).float() for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1).transpose(1, 2)[..., None]  # [B, Lq, H, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), vh)
    return (o / denom).to(q.dtype)


def _check_cuda(q, k, v, compute_dtype) -> None:
    """What the kernel takes: bf16 CUDA q/k/v of one shape [B, L, H, 64],
    each with its heads contiguous in a row, k and v on the same strides."""
    if compute_dtype != torch.bfloat16:
        raise TypeError("the CUDA attention kernel computes in bfloat16 only; "
                        f"got compute_dtype={compute_dtype}")
    for t in (q, k, v):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise TypeError("the CUDA attention kernel takes bfloat16 CUDA "
                            f"tensors; got {t.dtype} on {t.device}")
        if t.dim() != 4 or tuple(t.shape) != tuple(q.shape):
            raise ValueError("self-attention only: q, k, v [B, L, H, D] of "
                             f"one shape; got {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, {tuple(v.shape)}")
        if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
            raise ValueError(f"heads must be contiguous in a row; got strides "
                             f"{t.stride()}")
    if q.shape[3] != 64:
        raise ValueError(f"head width must be 64, got {q.shape[3]}")
    if k.stride()[:2] != v.stride()[:2]:
        raise ValueError("k and v must share their batch and row strides")
    if not 1 <= q.shape[0] <= 65535:
        raise ValueError(f"batch {q.shape[0]} is outside 1..65535 "
                         "(a grid limit)")


def fused_attention(q, k, v, scale: float, compute_dtype=torch.bfloat16, *,
                    impl: Optional[str] = None):
    """Softmax attention, q/k/v [B, L, H, D] -> [B, L, H, D] (a contiguous
    tensor, i.e. [B, L, H * D] as the output projection reads it)."""
    if not _use_kernel(q, impl):
        return attention_reference(q, k, v, scale, compute_dtype)
    from .. import _ext

    _check_cuda(q, k, v, compute_dtype)
    B, L, H, D = q.shape
    o = torch.empty(B, L, H, D, device=q.device, dtype=torch.bfloat16)
    _ext.call("gvf_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
              o.data_ptr(), B, L, H, D, q.stride(0), q.stride(1),
              k.stride(0), k.stride(1), float(scale))
    launch_counts["attention"] += 1
    return o
