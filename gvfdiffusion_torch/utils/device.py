"""Where the port's entry points run: on the card unless the caller asks
for the CPU, and never on the CPU in place of a missing card."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The torch.device for `device`; raises when it names CUDA and no CUDA
    device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA device "
                           "is present (pass device='cpu' to run on the CPU)")
    return dev
