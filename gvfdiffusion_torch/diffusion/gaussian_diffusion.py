"""Beta schedules (port of get_named_beta_schedule, gvfdiffusion_tpu/diffusion/
gaussian_diffusion.py:58). Precomputed in float64 numpy, as the reference."""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def _cosine_window(t, start=0.0, end=1.0, tau=1.0):
    v_start = math.cos(start * math.pi / 2) ** (2 * tau)
    v_end = math.cos(end * math.pi / 2) ** (2 * tau)
    out = np.cos((t * (end - start) + start) * math.pi / 2) ** (2 * tau)
    return (v_end - out) / (v_end - v_start)


def _sigmoid_window(t, start=0.0, end=3.0, tau=0.1):
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))
    v_start, v_end = sig(start / tau), sig(end / tau)
    out = sig((t * (end - start) + start) / tau)
    return (v_end - out) / (v_end - v_start)


def betas_for_alpha_bar(num_steps: int, alpha_bar: Callable,
                        max_beta=0.999) -> np.ndarray:
    """Discretize a continuous alpha_bar(t) into per-step betas."""
    i = np.arange(num_steps, dtype=np.float64)
    t1, t2 = i / num_steps, (i + 1) / num_steps
    return np.minimum(1.0 - alpha_bar(t2) / alpha_bar(t1), max_beta)


def get_named_beta_schedule(name: str, num_steps: int, beta_start=0.0001,
                            beta_end=0.02) -> np.ndarray:
    if name == "linear":
        scale = 1000.0 / num_steps
        return np.linspace(scale * beta_start, scale * beta_end, num_steps,
                           dtype=np.float64)
    if name == "cosine":
        return betas_for_alpha_bar(
            num_steps,
            lambda t: np.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    if name == "cosine_light":
        return betas_for_alpha_bar(
            num_steps, lambda t: _cosine_window(t, 0.2, 1.0, 3.0))
    if name == "sigmoid":
        return betas_for_alpha_bar(
            num_steps, lambda t: _sigmoid_window(t, 0.0, 3.0, 0.1))
    raise NotImplementedError(f"unknown beta schedule: {name}")
