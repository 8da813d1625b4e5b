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
or 1 heads: D = 192, 256, 384, 768; 1152 channels in 1 head: 1152). The
wide kernels (`csrc/flash_attention_wide.cu`) split a head's lanes over a
cluster of CTAs (`wide_split`): each CTA owns WIDE_SPLITS' first that
divides the card width (192, else 128, else 64 lanes: a tile pair's
barriers and sum cost each CTA the same, so the widest CTAs are the
fastest), a cluster at most WIDE_CLUSTER (16) CTAs, so one cluster covers
up to WIDE_SPAN (3072) lanes. `flash_card_width` pads a head of a
multiple of 8 above 128 the same way: to the next multiple of WIDE_LANES
(64; 136 runs at 192) whose split fits a cluster (1088, 17 CTAs of 64,
runs at 1152, 6 of 192; a multiple of 192 always fits).
Above 3072 lanes the kernels run passes: P clusters of n CTAs of 64 lanes
(the width P n 64, P the fewest passes of at most 16 CTAs, n as few CTAs
as then cover the head: 3136 runs at 3328, 4 passes of 13), each pass
forming the full scores and writing its own group of output lanes. Every
multiple of 8 takes a width: no head raises for its size.

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
# K7's wide kernels: heads of a multiple of WIDE_LANES above 128, split
# over clusters of at most WIDE_CLUSTER CTAs of WIDE_SPLITS' lanes, one
# cluster covering up to WIDE_SPAN lanes (passes of clusters above)
WIDE_LANES = 64
WIDE_CLUSTER = 16
WIDE_SPLITS = (192, 128, 64)
WIDE_SPAN = WIDE_CLUSTER * WIDE_SPLITS[0]
# the head widths whose launch counters exist at import: every multiple of
# 8 up to COUNTED_MAX (K7's rule has no cap: a wider head's counters are
# made at its first launch)
COUNTED_MAX = 4096
FLASH_WIDTHS = WIDTHS + tuple(range(136, COUNTED_MAX + 1, 8))
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


def _splits(width: int) -> bool:
    """Whether the first of WIDE_SPLITS dividing a multiple of WIDE_LANES
    up to WIDE_SPAN leaves at most WIDE_CLUSTER CTAs."""
    lanes = next(n for n in WIDE_SPLITS if width % n == 0)
    return width // lanes <= WIDE_CLUSTER


def flash_card_width(d: int) -> int:
    """The width K7's kernels run a head of width d at: `card_width(d)` up
    to 128; above it, up to WIDE_SPAN, the next multiple of WIDE_LANES
    whose split (`wide_split`) takes at most WIDE_CLUSTER CTAs (a multiple
    of 192 always does); above WIDE_SPAN the width of the fewest passes of
    clusters of 64-lane CTAs. Raises for a width K7 does not
    take (not a positive multiple of 8)."""
    if d < 8 or d % 8:
        raise ValueError(f"the flash attention kernels take heads of a "
                         f"multiple of 8 (run at {CARD_WIDTHS} up to 128, "
                         f"at multiples of {WIDE_LANES} above), got {d}")
    if d <= 128:
        return card_width(d)
    w = -(-d // WIDE_LANES) * WIDE_LANES
    if w <= WIDE_SPAN:
        while not _splits(w):  # ends at a multiple of 192 at the latest
            w += WIDE_LANES
        return w
    chunks = w // WIDE_LANES
    passes = -(-chunks // WIDE_CLUSTER)
    return passes * -(-chunks // passes) * WIDE_LANES


def wide_split(width: int) -> tuple:
    """(lanes a CTA, CTAs a cluster) of K7's wide kernels at a card width
    above 128 (`flash_card_width`'s): up to WIDE_SPAN the first of
    WIDE_SPLITS that divides it, one pass; above, 64 lanes and
    `wide_passes(width)` passes of clusters. Raises for a width the wide
    kernels do not take."""
    if width % WIDE_LANES or width <= 128:
        raise ValueError(f"the wide kernels take multiples of {WIDE_LANES} "
                         f"above 128, got {width}")
    if width <= WIDE_SPAN:
        lanes = next(n for n in WIDE_SPLITS if width % n == 0)
        if not _splits(width):
            raise ValueError(f"the wide kernels take a width up to "
                             f"{WIDE_SPAN} whose split fits a cluster of "
                             f"{WIDE_CLUSTER} CTAs, got {width}")
        return lanes, width // lanes
    chunks = width // WIDE_LANES
    passes = -(-chunks // WIDE_CLUSTER)
    if chunks % passes:
        raise ValueError(f"the wide kernels take a width above {WIDE_SPAN} "
                         f"of whole passes of clusters of {WIDE_LANES}-lane "
                         f"CTAs, got {width}")
    return WIDE_LANES, chunks // passes


def wide_passes(width: int) -> int:
    """The passes of clusters that cover a card width above 128: 1 up to
    WIDE_SPAN."""
    lanes, ctas = wide_split(width)
    return width // (lanes * ctas)


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
