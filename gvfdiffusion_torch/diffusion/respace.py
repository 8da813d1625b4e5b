"""Timestep respacing (port of gvfdiffusion_tpu/diffusion/respace.py).

`space_timesteps` picks a subset of the original timesteps; the respaced
process re-derives betas for that subset so that the cumulative alphas line
up, and records `timestep_map`, through which the model always sees
original-process timesteps (`GaussianDiffusion.scaled_model_t`).
"""

from __future__ import annotations

from typing import Iterable, Set, Union

import numpy as np

from .gaussian_diffusion import (GaussianDiffusion, diffusion_from_betas,
                                 get_named_beta_schedule)


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Iterable[int]]) -> Set[int]:
    """The original timesteps to keep. section_counts: "ddimN" (an integer
    stride giving exactly N steps), "fastN" (a quadratic spread dense at the
    low-noise end), a comma string ("10,10,5") or a list of counts, one per
    equal section."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} steps with "
                             "integer stride")
        if section_counts.startswith("fast"):
            desired = int(section_counts[len("fast"):])
            steps = set(int(s) for s in np.linspace(
                0, np.sqrt(num_timesteps * 0.8), desired) ** 2)
            if len(steps) < desired:
                extra = [t for t in range(num_timesteps) if t not in steps]
                steps |= set(extra[:desired - len(steps)])
            return steps
        section_counts = [int(x) for x in section_counts.split(",")]
    section_counts = list(section_counts)
    size_per, extra = divmod(num_timesteps, len(section_counts))
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into "
                             f"{section_count}")
        frac_stride = 1 if section_count <= 1 else (
            (size - 1) / (section_count - 1))
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


def spaced_diffusion(*, schedule: str = "cosine", steps: int = 1000,
                     timestep_respacing: Union[str, Iterable[int],
                                               None] = None,
                     mean_type: str = "v", var_type: str = "fixed_small",
                     min_snr: bool = False,
                     rescale_timesteps: bool = False) -> GaussianDiffusion:
    """A (possibly) respaced diffusion process from a named schedule."""
    betas = get_named_beta_schedule(schedule, steps)
    if not timestep_respacing:
        timestep_respacing = [steps]
    use_timesteps = sorted(space_timesteps(steps, timestep_respacing))
    acp = np.cumprod(1.0 - betas)
    last_alpha_cumprod = 1.0
    new_betas = []
    for i in use_timesteps:
        new_betas.append(1.0 - acp[i] / last_alpha_cumprod)
        last_alpha_cumprod = acp[i]
    return diffusion_from_betas(
        np.array(new_betas, dtype=np.float64), mean_type=mean_type,
        var_type=var_type, min_snr=min_snr,
        rescale_timesteps=rescale_timesteps,
        timestep_map=np.array(use_timesteps), original_num_steps=steps)
