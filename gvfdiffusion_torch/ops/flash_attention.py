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
    `csrc/flash_attention.cu`: q/k/v all bf16 (WMMA products, P rounded to
    bf16) or all fp32 (fp32 FFMA, nothing rounded: the SLat flow as the
    registry builds it), heads of 32, 64 or 128. It raises for anything
    else and never falls back: an fp32 input is never cast to reach the
    bf16 kernel. The kernel has no backward pass (the SLat flow runs it at
    inference), so on the card the wrapper raises when grad mode is on and
    an input requires grad.

`launch_counts` counts kernel launches by dtype and head width:
"flash_attention" (bf16, heads of 64), "flash_attention_fp32", and either
with "_d32" / "_d128" at the other widths; the plain version never counts.
"""

from __future__ import annotations

from typing import Optional

import torch

# the Pallas kernel's additive mask value (jax.experimental.pallas.ops.tpu.
# flash_attention.DEFAULT_MASK_VALUE)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# the JAX call's block size: keys are padded to a multiple of it
BLOCK = 512
# score elements per chunk of the plain version ([B, H, rows, Lk] fp32: 512 MB)
_SCORES = 1 << 27

HEAD_WIDTHS = (32, 64, 128)
launch_counts = {f"flash_attention{dt}{w}": 0 for dt in ("", "_fp32")
                 for w in ("", "_d32", "_d128")}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def launch_key(dtype: torch.dtype, head_dim: int) -> str:
    """The counter of a launch: its dtype and head width."""
    return ("flash_attention" + ("_fp32" if dtype == torch.float32 else "")
            + ("" if head_dim == 64 else f"_d{head_dim}"))


def padded_keys(lk: int) -> int:
    """The key count the TPU kernel runs over: Lk padded to BLOCK."""
    return -(-lk // BLOCK) * BLOCK


def flash_attention_reference(q, k, v, kv_valid, scale: float):
    """q [B, Lq, H, D], k/v [B, Lk, H, D], kv_valid bool [B, Lk] ->
    [B, Lq, H, D] in q's dtype."""
    B, Lq, H, _ = q.shape
    Lk = k.shape[1]
    pad = padded_keys(Lk) - Lk
    kf, vf = k.float(), v.float()
    if pad:
        kf, vf = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                  for a in (kf, vf))
        kv_valid = torch.nn.functional.pad(kv_valid, (0, pad))
    bias = torch.where(kv_valid, 0.0, MASK_VALUE).float()[:, None, None, :]
    rows = max(1, _SCORES // (B * H * (Lk + pad)))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for i0 in range(0, Lq, rows):
        qc = q[:, i0:i0 + rows].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * scale + bias
        p = torch.exp(s - s.amax(-1, keepdim=True))
        del s
        denom = p.sum(-1).transpose(1, 2)[..., None]  # [B, rows, H, 1]
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
        out[:, i0:i0 + rows] = (o / denom).to(q.dtype)
    return out


def _check_cuda(q, k, v, kv_valid) -> None:
    """What the kernel takes: CUDA q [B, Lq, H, D] and k/v [B, Lk, H, D],
    all bf16 or all fp32, D = 32, 64 or 128, each with its heads contiguous
    in a row and rows on 16-byte boundaries; kv_valid bool [B, Lk]."""
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
    if D not in HEAD_WIDTHS:
        raise ValueError(f"the flash attention kernel takes heads of "
                         f"{HEAD_WIDTHS}, got {D}")
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


def flash_attention(q, k, v, kv_valid, scale: float,
                    impl: Optional[str] = None):
    """Softmax attention of q [B, Lq, H, D] over the valid keys of k/v
    [B, Lk, H, D] (kv_valid bool [B, Lk]) -> [B, Lq, H, D] in q's dtype,
    contiguous."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if impl == "plain" or not q.is_cuda:
        return flash_attention_reference(q, k, v, kv_valid, scale)
    from .. import _ext

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the CUDA kernel has no backward "
                           "pass; run it under torch.no_grad() or pass "
                           "impl='plain' to differentiate")
    _check_cuda(q, k, v, kv_valid)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    valid = kv_valid.contiguous()
    tiles = -(-Lk // 64)
    counts = torch.empty(B, tiles, dtype=torch.int32, device=q.device)
    o = torch.empty(B, Lq, H, D, dtype=q.dtype, device=q.device)
    _ext.call("gvf_flash_attention", q.data_ptr(), k.data_ptr(),
              v.data_ptr(), valid.data_ptr(), counts.data_ptr(), o.data_ptr(),
              B, Lq, Lk, H, D, q.stride(0), q.stride(1), k.stride(0),
              k.stride(1), v.stride(0), v.stride(1), float(scale),
              padded_keys(Lk), int(q.dtype == torch.float32))
    launch_counts[launch_key(q.dtype, D)] += 1
    return o
