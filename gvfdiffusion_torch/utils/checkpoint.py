"""Checkpoints of a trainer's state (port of gvfdiffusion_tpu/utils/
checkpoint.py: `CheckpointManager` and `auto_resume`, there over orbax).
One directory per state: the DiT trainer's `<exp>/checkpoints`, the VAE
trainer's `<exp>/static_vae` and `<exp>/motion_vae`, each resumed on its
own.

One `torch.save` file per saved step, `<dir>/ckpt_<step:08d>.pt`, holding
the micro-step count, the parameters, the optimizer state (moments,
gradient accumulator, counts) and the EMA; written to a temporary name and
renamed, so a reader never sees half a file. The newest `max_to_keep`
files stay. `restore_params` loads one model's weights alone (the
checkpoint's `params`) into a module, as the infer CLI restores its models.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

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

    def save(self, state: TrainState, step: int, force: bool = False) -> bool:
        """Write `state` under `step`; a step already on disk is left as it
        is (resuming a finished run reaches its final save again). `force`
        is JAX's flag, which overrides orbax's save interval; this manager
        has none, so every call saves."""
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

    def close(self) -> None:
        """JAX's `close`: this manager holds nothing open."""


def restore_params(module: torch.nn.Module, ckpt_dir: str,
                   step: Optional[int] = None) -> int:
    """Load the parameters of the checkpoint at `step` (the newest by
    default) in `ckpt_dir` into `module`, in place, loaded straight to the
    module's device: the trainer state's `params`, strict on names and
    shapes (its optimizer state and EMA are not used). Returns the step;
    raises FileNotFoundError when there is no checkpoint."""
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step() if step is None else step
    if step is None or not os.path.exists(mgr._path(step)):
        at = "" if step is None else f" at step {step}"
        raise FileNotFoundError(f"no checkpoint{at} in {mgr.ckpt_dir}")
    own = dict(module.named_parameters())
    device = next(iter(own.values())).device
    params: Dict[str, torch.Tensor] = torch.load(
        mgr._path(step), map_location=device, weights_only=True)["params"]
    missing, unexpected = sorted(set(own) - set(params)), sorted(
        set(params) - set(own))
    if missing or unexpected:
        raise KeyError(f"checkpoint {mgr._path(step)} does not match the "
                       f"module: missing {missing}, unexpected {unexpected}")
    bad = [(k, tuple(params[k].shape), tuple(p.shape))
           for k, p in own.items() if params[k].shape != p.shape]
    if bad:
        raise ValueError(f"checkpoint {mgr._path(step)}: shapes differ "
                         f"(name, saved, module): {bad}")
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(params[k])
    return step


def auto_resume(ckpt_dir: str, state: TrainState) -> Tuple[TrainState, int]:
    """Restore the newest checkpoint into `state` if there is one; returns
    (state, the restored step label or 0)."""
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        return state, 0
    return mgr.restore(state, step), step
