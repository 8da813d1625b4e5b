"""Checkpoints of a trainer's state (port of gvfdiffusion_tpu/utils/
checkpoint.py: `CheckpointManager` and `auto_resume`, there over orbax).
One directory per state: the DiT trainer's `<exp>/checkpoints`, the VAE
trainer's `<exp>/static_vae` and `<exp>/motion_vae`, each resumed on its
own.

One `torch.save` file per saved step, `<dir>/ckpt_<step:08d>.pt`, holding
the micro-step count, the parameters, the optimizer state (moments,
gradient accumulator, counts) and the EMA; written to a temporary name and
renamed, so a reader never sees half a file. The newest `max_to_keep`
files stay.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from ..train.train_state import TrainState

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


class CheckpointManager:
    """save(state, step) / latest_step() / restore(state, step)."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 5):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"ckpt_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.ckpt_dir):
            return []
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.ckpt_dir))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: int) -> bool:
        """Write `state` under `step`; a step already on disk is left as it
        is (resuming a finished run reaches its final save again)."""
        if step in self.all_steps():
            return False
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> Optional[TrainState]:
        """Load step (the newest by default) into `state`, in place; None
        when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        sd = torch.load(self._path(step), map_location="cpu",
                        weights_only=True)
        state.load_state_dict(sd)
        return state


def auto_resume(ckpt_dir: str, state: TrainState) -> Tuple[TrainState, int]:
    """Restore the newest checkpoint into `state` if there is one; returns
    (state, the restored step label or 0)."""
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        return state, 0
    return mgr.restore(state, step), step
