"""Training-timestep sampler (port of gvfdiffusion_tpu/diffusion/
resample.py:9 `uniform_sampler`)."""

from __future__ import annotations

import torch


def uniform_sampler(generator: torch.Generator, batch: int,
                    num_timesteps: int, device):
    """Uniform timesteps [batch] (int64) in [0, num_timesteps) and unit
    importance weights (fp32), drawn on the generator's device and placed
    on `device`."""
    t = torch.randint(0, num_timesteps, (batch,), generator=generator,
                      device=generator.device)
    return t.to(device), torch.ones(batch, dtype=torch.float32, device=device)
