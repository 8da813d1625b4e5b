"""The head widths the card's attention kernels run (K5, K6, K7).

The JAX dispatch rules admit any head width D that is a multiple of 8 up
to 128 (`fused_attention.supports`, `temporal_supports`; K7 through
`sparse/attention.full_sparse_attention`). The CUDA kernels are built at
three widths, 32, 64 and 128. A head of another width runs at the next of
them (`card_width`): its wrapper copies q, k and v into zero-padded
buffers (`pad_heads`), launches the kernel with the scale of the true
width, D ** -0.5, and keeps the first D columns of the output (and of dq,
dk and dv). The zero columns change neither q . k nor any row's maximum,
sum or logsumexp, nor an int8 form's max-abs scales, and they give zero in
the dropped columns: the function is the one at width D.
"""

from __future__ import annotations

import torch

# the widths the kernels are instantiated at
CARD_WIDTHS = (32, 64, 128)
# every head width a dispatch rule admits: multiples of 8 up to 128
WIDTHS = tuple(range(8, 129, 8))


def card_width(d: int) -> int:
    """The width the card's kernels run a head of width d at: d itself at
    32, 64 or 128, else the next of them. Raises for a width no rule admits
    (not a multiple of 8, or above 128)."""
    if d not in WIDTHS:
        raise ValueError(f"the attention kernels take heads of a multiple of "
                         f"8 up to 128 (run at {CARD_WIDTHS}), got {d}")
    return next(w for w in CARD_WIDTHS if d <= w)


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
