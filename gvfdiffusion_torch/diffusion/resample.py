"""Training-timestep samplers (port of gvfdiffusion_tpu/diffusion/
resample.py: `uniform_sampler` and `static_sampler`)."""

from __future__ import annotations

from typing import Optional

import torch


def uniform_sampler(generator: torch.Generator, batch: int,
                    num_timesteps: int, device):
    """Uniform timesteps [batch] (int64) in [0, num_timesteps) and unit
    importance weights (fp32), drawn on the generator's device and placed
    on `device`."""
    t = torch.randint(0, num_timesteps, (batch,), generator=generator,
                      device=generator.device)
    return t.to(device), torch.ones(batch, dtype=torch.float32, device=device)


def static_sampler(generator: torch.Generator, batch: int,
                   num_timesteps: int, value: int = 0,
                   device: Optional[torch.device] = None):
    """The fixed timestep `value` [batch] (int64) and unit importance
    weights (fp32) on `device` (the generator's by default), which draws
    nothing (the reference's StaticSampler, model/resample.py:51)."""
    del num_timesteps
    device = generator.device if device is None else device
    t = torch.full((batch,), value, dtype=torch.long, device=device)
    return t, torch.ones(batch, dtype=torch.float32, device=device)
