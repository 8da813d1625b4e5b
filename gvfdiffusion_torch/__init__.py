"""PyTorch / CUDA port of gvfdiffusion_tpu for one NVIDIA H100.

Mirrors the JAX package's module paths and class names; the JAX package is
the reference it is tested against. Imports torch and never jax.
"""
