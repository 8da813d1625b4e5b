"""Ops with hand-written CUDA kernels beside their plain torch versions."""
