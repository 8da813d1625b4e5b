"""Device profiling helpers (port of gvfdiffusion_tpu/utils/profiling.py):
`trace` records everything inside its scope with `torch.profiler` (CUDA
activity too when the card is in use) and writes a Chrome trace (viewable
in Perfetto or chrome://tracing) under `log_dir`; `maybe_trace_step`
traces a window of steps; `log_memory_kvs` logs the card's memory in use,
its peak and its size to the logger. The wall-clock scopes are
utils/logger.py's `profile_kv`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from . import logger


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile everything inside the scope; yields `log_dir` (by default
    `<logger dir>/profile`), where the trace `trace_<pid>_<ns>.json` is
    written when the scope ends."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(logger.get_dir(), "profile")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def maybe_trace_step(step: int, start: int, num_steps: int, log_dir=None):
    """A context manager that traces steps [start, start + num_steps)."""
    if start <= step < start + num_steps:
        return trace(log_dir)
    return contextlib.nullcontext()


def log_memory_kvs(prefix: str = "mem", device=None) -> None:
    """logkv the card's memory (GiB): allocated now, its peak, the card's
    size; nothing on the CPU, as JAX logs nothing where the backend keeps
    no statistics."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return
    stats = torch.cuda.memory_stats(device)
    gib = 1024 ** 3
    logger.logkv(f"{prefix}_in_use_gib",
                 stats.get("allocated_bytes.all.current", 0) / gib)
    logger.logkv(f"{prefix}_peak_gib",
                 stats.get("allocated_bytes.all.peak", 0) / gib)
    logger.logkv(f"{prefix}_limit_gib",
                 torch.cuda.mem_get_info(device)[1] / gib)
