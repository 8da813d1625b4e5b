"""Elastic memory management: an adaptive gradient-checkpoint ratio (port
of gvfdiffusion_tpu/utils/elastic.py; the reference's LinearMemoryController,
utils/elastic_utils.py:9-174).

It records each step's peak device memory in a ring buffer, fits `memory =
k * (input_size * mem_ratio) + b` by least squares every `update_every`
steps, and predicts the largest mem_ratio that keeps the use under
`target_ratio` of the card's memory, under a cap that rises slowly. The
suggestion maps onto a model's recomputed blocks through its
`mem_ratio_to_remat_blocks` (the DiT's and the static VAE's).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch


def device_memory_stats(device=None) -> Tuple[int, int]:
    """(peak bytes allocated, the card's total bytes); zeros on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return 0, 0
    peak = torch.cuda.max_memory_allocated(device)
    return int(peak), int(torch.cuda.get_device_properties(
        device).total_memory)


class LinearMemoryController:
    """See the module docstring; the reference's knobs
    (utils/elastic_utils.py:34-135)."""

    def __init__(self, buffer_size: int = 1000, update_every: int = 500,
                 target_ratio: float = 0.8,
                 available_memory: Optional[int] = None,
                 max_mem_ratio_start: float = 0.1, device=None):
        self.buffer_size = buffer_size
        self.update_every = update_every
        self.target_ratio = target_ratio
        self.device = device
        _, limit = device_memory_stats(self.device)
        self.available = available_memory or limit or (16 << 30)
        self.max_mem_ratio = max_mem_ratio_start
        self._xs: List[float] = []
        self._ys: List[float] = []
        self._steps = 0
        self.k = 0.0
        self.b = 0.0

    @contextlib.contextmanager
    def record(self, input_size: float, mem_ratio: float):
        """Record one step's (input_size * mem_ratio, peak memory)."""
        yield
        peak, _ = device_memory_stats(self.device)
        if peak > 0:
            self._xs.append(input_size * mem_ratio)
            self._ys.append(float(peak))
            if len(self._xs) > self.buffer_size:
                self._xs.pop(0)
                self._ys.pop(0)
        self._steps += 1
        if self._steps % self.update_every == 0:
            self._fit()
            self.max_mem_ratio = min(self.max_mem_ratio + 0.1, 1.0)

    def _fit(self):
        if len(self._xs) < 2:
            return
        x = np.asarray(self._xs)
        y = np.asarray(self._ys)
        if np.ptp(x) < 1e-9:
            return
        self.k, self.b = np.polyfit(x, y, 1)

    def get_mem_ratio(self, input_size: float) -> float:
        """The largest mem_ratio that keeps the predicted memory under the
        target."""
        if self.k <= 0:
            return self.max_mem_ratio
        budget = self.target_ratio * self.available
        r = (budget - self.b) / (self.k * max(input_size, 1.0))
        return float(np.clip(r, 0.0, self.max_mem_ratio))

    def suggest_remat_blocks(self, model, input_size: float) -> int:
        """The suggested ratio on the model's block grid (the model has
        `mem_ratio_to_remat_blocks`)."""
        return model.mem_ratio_to_remat_blocks(self.get_mem_ratio(input_size))
