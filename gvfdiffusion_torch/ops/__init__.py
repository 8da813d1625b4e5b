"""Ops: hand-written CUDA kernels beside their plain torch versions, and
the plain torch math around them."""
