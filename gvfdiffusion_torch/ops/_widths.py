"""The head widths the card's attention kernels run, and where.

K5, K6 and K7 (`fused_attention`, `flash_attention`): the JAX dispatch
rules admit any head width D that is a multiple of 8 up to 128
(`fused_attention.supports`, `temporal_supports`; K7 through
`sparse/attention.full_sparse_attention`). The CUDA kernels are built at
three widths, 32, 64 and 128. A head of another width runs at the next of
them (`card_width`): its wrapper copies q, k and v into zero-padded
buffers (`pad_heads`), launches the kernel with the scale of the true
width, D ** -0.5, and keeps the first D columns of the output (and of dq,
dk and dv).

K7 above 128 lanes: JAX's rule sends any multiple of 8 to the stock flash
kernel, which has no cap on D (the static VAE's 768 channels in 4, 3, 2
or 1 heads: D = 192, 256, 384, 768). The wide kernels
(`csrc/flash_attention_wide.cu`) take every multiple of WIDE_LANES (64)
from 192 to WIDE_MAX (1024); a head of another multiple of 8 above 128 is
padded the same way to the next of them (`flash_card_width`: 136 runs at
192). FLASH_WIDTHS is K7's whole rule, every multiple of 8 up to
WIDE_MAX; a wider head raises. The wide backward splits a head's lanes
over a cluster of CTAs (`wide_split`): each CTA owns WIDE_SPLITS' first
that divides the card width (192, else 128, else 64 lanes: a tile pair's
barriers and sum cost each CTA the same, so the widest CTAs are the
fastest), so a cluster holds 1 to 13 CTAs, within the 16 the entries
ask the card for.

K1, K2 and K3 (`fused_sublayer`): their rules admit every head width that
divides 128 (`_LANES % D == 0`: 1, 2, 4, 8, 16, 32, 64 and 128,
`SUBLAYER_WIDTHS`). A head of 32, 64 or 128 runs at its own width; a
narrower one at 32 (`sublayer_card_width`), padded in the projections'
weights (`fused_sublayer.widen_self_weights`, `widen_cross_params`) and in
K3's cache, with the scale of the true width.

Either way the zero columns change neither q . k nor any row's maximum,
sum or logsumexp, nor an int8 form's max-abs scales, nor a per-head RMS
norm (whose padded gammas are zero), and they give zero in the dropped
columns: the function is the one at width D.
"""

from __future__ import annotations

import torch

# the widths the kernels are instantiated at
CARD_WIDTHS = (32, 64, 128)
# every head width K5's, K6's and K7's rules admit: multiples of 8 up to 128
WIDTHS = tuple(range(8, 129, 8))
# K7's wide kernels: heads of a multiple of WIDE_LANES above 128, up to
# WIDE_MAX; every width K7 takes, padded or not
WIDE_LANES = 64
WIDE_MAX = 1024
FLASH_WIDTHS = WIDTHS + tuple(range(136, WIDE_MAX + 1, 8))
# the wide backward's lanes a CTA, in the order tried
WIDE_SPLITS = (192, 128, 64)
# every head width K1's, K2's and K3's rules admit: the divisors of 128
SUBLAYER_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128)


def card_width(d: int) -> int:
    """The width the card's kernels run a head of width d at: d itself at
    32, 64 or 128, else the next of them. Raises for a width no rule admits
    (not a multiple of 8, or above 128)."""
    if d not in WIDTHS:
        raise ValueError(f"the attention kernels take heads of a multiple of "
                         f"8 up to 128 (run at {CARD_WIDTHS}), got {d}")
    return next(w for w in CARD_WIDTHS if d <= w)


def flash_card_width(d: int) -> int:
    """The width K7's kernels run a head of width d at: `card_width(d)` up
    to 128, above it the next multiple of WIDE_LANES (the wide kernels').
    Raises for a width K7 does not take (not a multiple of 8, or above
    WIDE_MAX)."""
    if d not in FLASH_WIDTHS:
        raise ValueError(f"the flash attention kernels take heads of a "
                         f"multiple of 8 up to {WIDE_MAX} (run at "
                         f"{CARD_WIDTHS} up to 128, at multiples of "
                         f"{WIDE_LANES} above), got {d}")
    if d <= 128:
        return card_width(d)
    return -(-d // WIDE_LANES) * WIDE_LANES


def wide_split(width: int) -> tuple:
    """(lanes a CTA, CTAs a cluster) of K7's wide backward at a card width
    above 128 (`flash_card_width`'s): the first of WIDE_SPLITS that divides
    it. Raises for a width the wide kernels do not take."""
    if width % WIDE_LANES or not 128 < width <= WIDE_MAX:
        raise ValueError(f"the wide kernels take multiples of {WIDE_LANES} "
                         f"from 192 to {WIDE_MAX}, got {width}")
    lanes = next(n for n in WIDE_SPLITS if width % n == 0)
    return lanes, width // lanes


def sublayer_card_width(d: int) -> int:
    """The width K1-K3's kernels run a head of width d at: d itself from 32
    up, 32 below. Raises for a width their rules refuse (not dividing
    128)."""
    if d not in SUBLAYER_WIDTHS:
        raise ValueError(f"the sublayer kernels take heads of a width that "
                         f"divides 128, {SUBLAYER_WIDTHS}, got {d}")
    return max(d, 32)


def width_suffix(d: int) -> str:
    """The launch counters' suffix for the caller's head width d: none at
    64 (the first width the kernels served), "_dD" at the others."""
    return "" if d == 64 else f"_d{d}"


def pad_heads(t: torch.Tensor, width: int) -> torch.Tensor:
    """t [..., D] zero-padded to [..., width], a new contiguous tensor; t
    itself where D == width."""
    d = t.shape[-1]
    if d == width:
        return t
    return torch.nn.functional.pad(t, (0, width - d))
