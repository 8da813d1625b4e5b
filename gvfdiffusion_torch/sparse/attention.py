"""Sparse attention: full and windowed (swin) (port of
gvfdiffusion_tpu/sparse/attention.py:34-204, 237-305).

`full_sparse_attention` keeps the JAX dispatch. Where the JAX package
takes the fused kernel K5 (Lq * Lk >= 1M inside K5's rule, the compacted
SLat torso), the port takes K5 with the key validity as a -inf logit bias,
computing in bf16 on the card whatever the model's dtype, as JAX calls it
there (on the CPU in the model's dtype).
Where it takes the stock Pallas flash kernel K7 (Lq * Lk >= 4096^2 past
K5's rule: full attention over more than 4096 keys, the uncompacted
torso), the port takes K7 (ops/flash_attention.py), on the CPU its plain
version, as K5's branch does. Everything else takes the masked path, which
in JAX is `jax.nn.dot_product_attention` outside any Pallas kernel and
here `F.scaled_dot_product_attention` with a boolean mask.

The windowed mode sorts voxels by 3-D window id (a stable sort, as the JAX
`argsort`) and runs banded chunked attention: each chunk of queries
attends to [previous | own | next] key chunks, masked by window-id
equality, which is exact for windows no longer than a chunk. The
serialized (space-filling curve) mode is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.attention import MultiHeadAttention, kernel_compute_dtype
from ..nn.misc import dense
from ..ops import flash_attention as fl
from ..ops import fused_attention as fa
from .tensor import SparseVoxels

FUSED_SCORE_ELEMENTS = 1024 * 1024
FLASH_SCORE_ELEMENTS = 4096 * 4096


def _masked_attention(q, k, v, mask):
    """Softmax attention of [B, L, H, D] with a boolean mask [B, 1|H, Lq,
    Lk]; a row with no visible key sees key 0 instead (its output is
    discarded downstream), so nothing is NaN."""
    fallback = torch.zeros_like(mask)
    fallback[..., 0] = True
    mask = torch.where(mask.any(-1, keepdim=True), mask, fallback)
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask)
    return o.transpose(1, 2)


def full_sparse_attention(q, k, v, q_valid, kv_valid, dtype: torch.dtype,
                          impl: Optional[str] = None):
    """q [B, Lq, H, D], k/v [B, Lk, H, D]; per-sample full attention over
    the valid keys; [B, Lq, H, D] in `dtype`. On the card K5 and K7 run
    heads of 32, 64 and 128 natively and zero-pad a head of any other
    multiple of 8 up to 128 to the next of those (`ops/_widths.py`: the
    same function). K7's branch also takes D > 128, as JAX's stock kernel
    does, at every multiple of 8 with no cap: its wide kernels pad a head
    to the next width they split over a cluster of CTAs
    (`_widths.flash_card_width`, `wide_split`)."""
    lq, lk = q.shape[1], k.shape[1]
    if fa.supports(q.shape, k.shape) and lq * lk >= FUSED_SCORE_ELEMENTS:
        bias = torch.where(kv_valid, 0.0, float("-inf")).float()
        return fa.fused_attention(q, k, v, q.shape[-1] ** -0.5,
                                  kernel_compute_dtype(q, dtype),
                                  kv_bias=bias, impl=impl)
    if lq * lk >= FLASH_SCORE_ELEMENTS and q.shape[-1] % 8 == 0:
        return fl.flash_attention(q.to(dtype), k.to(dtype), v.to(dtype),
                                  kv_valid, q.shape[-1] ** -0.5, impl=impl)
    mask = q_valid[:, None, :, None] & kv_valid[:, None, None, :]
    return _masked_attention(q.to(dtype), k.to(dtype), v.to(dtype), mask)


def chunked_banded_attention(q, k, v, q_seg, k_seg, chunk: int):
    """Queries in chunks attend to the [prev | self | next] key chunks,
    masked by segment-id equality (-1 = invalid). With n <= 2 chunks the
    band shrinks so that no key appears twice (a duplicate key would bias
    the softmax). q, k, v [B, L, H, D]; q_seg, k_seg [B, L]."""
    b, l, h, d = q.shape
    pad = (-l) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        q_seg = F.pad(q_seg, (0, pad), value=-1)
        k_seg = F.pad(k_seg, (0, pad), value=-1)
    n = (l + pad) // chunk
    qc = q.reshape(b, n, chunk, h, d)
    kc, vc = (a.reshape(b, n, chunk, h, d) for a in (k, v))
    sq, sk = q_seg.reshape(b, n, chunk), k_seg.reshape(b, n, chunk)
    if n == 1:
        nb, band = 1, lambda a: a
    elif n == 2:
        nb, band = 2, lambda a: torch.cat([torch.roll(a, 1, 1), a], 2)
    else:
        nb, band = 3, lambda a: torch.cat(
            [torch.roll(a, 1, 1), a, torch.roll(a, -1, 1)], 2)
    kb, vb, skb = band(kc), band(vc), band(sk)
    mask = (sq[..., :, None] == skb[..., None, :]) & (sq[..., :, None] >= 0)
    out = _masked_attention(
        qc.reshape(b * n, chunk, h, d), kb.reshape(b * n, nb * chunk, h, d),
        vb.reshape(b * n, nb * chunk, h, d),
        mask.reshape(b * n, 1, chunk, nb * chunk))
    return out.reshape(b, n * chunk, h, d)[:, :l]


def window_ids(coords, valid, resolution: int, window_size: int,
               shift: Tuple[int, int, int] = (0, 0, 0)) -> torch.Tensor:
    """3-D swin window id per voxel ([B, L], -1 invalid)."""
    w = (coords.long() + torch.tensor(shift, device=coords.device)) \
        // window_size
    n_w = (resolution + window_size - 1) // window_size + 1
    wid = w[..., 0] * n_w * n_w + w[..., 1] * n_w + w[..., 2]
    return torch.where(valid, wid, -1)


def sort_by_key(key: torch.Tensor) -> torch.Tensor:
    """Stable argsort of [B, L] keys with invalid (-1) keys last."""
    k = torch.where(key < 0, torch.iinfo(torch.int64).max, key)
    return torch.sort(k, dim=1, stable=True).indices


def windowed_sparse_attention(q, k, v, x: SparseVoxels, window_size: int,
                              shift=(0, 0, 0)):
    """Swin attention over 3-D windows, in chunks of one window's cell
    count; q/k/v [B, L, H, D] aligned with x."""
    chunk = window_size ** 3
    wid = window_ids(x.coords, x.valid, x.resolution, window_size, shift)
    order = sort_by_key(wid)
    inv = torch.argsort(order, dim=1)
    take = lambda a, o: torch.gather(
        a, 1, o[..., None, None].expand(-1, -1, *a.shape[2:]))
    seg = torch.gather(wid, 1, order)
    out = chunked_banded_attention(take(q, order), take(k, order),
                                   take(v, order), seg, seg, chunk)
    return take(out, inv)


class SparseMultiHeadAttention(MultiHeadAttention):
    """Sparse multi-head attention over the voxel features: self-attention
    ("full" or "windowed"), or with attn_type="cross" the voxels' queries
    against a dense context [B, Lk, C_ctx] whose keys are all valid (the
    SLat torso's cross sublayer under `qk_rms_norm_cross`; without it that
    sublayer runs inside K3, models/trellis/slat_flow.py); parameters as
    `nn/attention.MultiHeadAttention`."""

    def __init__(self, channels: int, num_heads: int, attn_mode: str = "full",
                 window_size: Optional[int] = None,
                 shift_window: Tuple[int, int, int] = (0, 0, 0),
                 qk_rms_norm: bool = False, attn_type: str = "self",
                 ctx_channels: Optional[int] = None):
        if attn_mode not in ("full", "windowed"):
            raise NotImplementedError(
                f"sparse attention mode {attn_mode!r} is not ported")
        super().__init__(channels, num_heads, attn_type, qk_rms_norm,
                         ctx_channels)
        self.attn_mode = attn_mode
        self.window_size = window_size
        self.shift_window = tuple(shift_window)

    def forward(self, x: SparseVoxels, dtype: torch.dtype,
                context: Optional[torch.Tensor] = None,
                impl: Optional[str] = None) -> SparseVoxels:
        b, l, _ = x.feats.shape
        q, k, v = self.project(x.feats, dtype, context)
        if self.attn_type == "cross":
            kv_valid = torch.ones(context.shape[:2], dtype=torch.bool,
                                  device=context.device)
            out = full_sparse_attention(q, k, v, x.valid, kv_valid, dtype,
                                        impl)
        elif self.attn_mode == "full":
            out = full_sparse_attention(q, k, v, x.valid, x.valid, dtype,
                                        impl)
        else:
            out = windowed_sparse_attention(q, k, v, x, self.window_size,
                                            self.shift_window)
        out = dense(out.reshape(b, l, self.channels), self.to_out, dtype)
        return x.replace_feats(out)
