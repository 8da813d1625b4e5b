"""Background-thread batch prefetch: host loading and the host-to-device
copy overlap the step (port of gvfdiffusion_tpu/data/prefetch.py).

A daemon thread pulls batches from the batch iterator, runs the host work
(torch.load, stacking, the dataset's random draws, in the iterator's own
order) and `place_fn` ahead of consumption, and hands them out through a
bounded queue (depth 2 by default: double buffering; each slot holds a
whole batch on the device). The worker's exception is raised on the
consumer's side; `close()` stops the thread promptly.

On the card, `DevicePlacer` is the `place_fn` that makes the copy
asynchronous: it pins the host batch, copies it on a side CUDA stream and
records an event there; `Prefetcher.__next__` makes the consumer's current
stream wait on that event and marks each tensor as used by that stream
(`record_stream`), so the copy of batch k+1 runs while the card computes
step k. A plain `.to("cuda")` in the worker would run on the default
stream, serialize with the step, and copy synchronously from pageable
memory.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


class _OnStream:
    """A batch of device tensors whose copy is in flight on a side stream,
    complete once `event` is reached."""

    def __init__(self, batch: Dict[str, torch.Tensor], event):
        self.batch, self.event = batch, event

    def ready(self) -> Dict[str, torch.Tensor]:
        """The batch, usable on the calling thread's current stream."""
        stream = torch.cuda.current_stream(self.event.device)
        stream.wait_event(self.event)
        for t in self.batch.values():
            t.record_stream(stream)
        return self.batch


class DevicePlacer:
    """place_fn for a dict of numpy arrays: tensors on `device`. On a CUDA
    device the copy is pinned and asynchronous on a side stream (the
    module docstring); on the CPU a plain conversion."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, batch: Dict[str, np.ndarray]):
        if self.stream is None:
            return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                    for k, v in batch.items()}
        with torch.cuda.stream(self.stream):
            out = {k: torch.from_numpy(np.asarray(v)).pin_memory().to(
                self.device, non_blocking=True) for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return _OnStream(out, event)


class Prefetcher:
    """Iterator wrapper: pulls from `it` in a daemon thread, applies
    `place_fn` in that thread, and hands the placed batches out with
    `next()`. Exceptions in the worker propagate to the consumer; `close()`
    stops the thread promptly; usable as a context manager."""

    def __init__(self, it: Iterator, place_fn: Optional[Callable] = None,
                 depth: int = 2):
        self._it = it
        self._place = place_fn or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                placed = self._place(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(placed, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # raised on the consumer's side
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item.ready() if isinstance(item, _OnStream) else item

    def close(self):
        self._stop.set()
        # drain, so that a blocked put wakes up
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
