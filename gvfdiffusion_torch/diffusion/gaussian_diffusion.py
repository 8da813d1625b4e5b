"""Gaussian diffusion for training (port of gvfdiffusion_tpu/diffusion/
gaussian_diffusion.py: the beta schedules :37-72, the `GaussianDiffusion`
tables with `q_sample`, `get_v`, `scaled_model_t` and `training_losses`
:83-190, :419-466, `create_diffusion` and `diffusion_from_betas`
:483-557).

Coefficients are precomputed in float64 numpy, as the reference does, and
stored as fp32 tensors. Channels last. The learned-variance training terms
(`_vb_terms`) and the sampling loops are not ported: the port samples with
DPM-Solver++ (diffusion/dpm_solver.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch


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


MEAN_TYPES = ("eps", "x0", "v", "xprev")
VAR_TYPES = ("fixed_small", "fixed_large", "learned", "learned_range")


def _bcast(coef: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """coef[t] (t shaped [B]), right-padded to broadcast over x."""
    out = coef[t]
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=1)


@dataclasses.dataclass
class GaussianDiffusion:
    """Coefficient tables (each [num_timesteps] fp32) and the static config
    of a diffusion process. Build with `create_diffusion`."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    timestep_map: torch.Tensor  # this process's step -> the original's
    mean_type: str = "eps"
    var_type: str = "fixed_small"
    min_snr: bool = False
    rescale_timesteps: bool = False
    original_num_steps: int = 1000

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "GaussianDiffusion":
        """The same process with its tables on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def scaled_model_t(self, t: torch.Tensor) -> torch.Tensor:
        """The timestep value the model sees: respace-mapped, and with
        `rescale_timesteps` scaled by 1000 / original_num_steps."""
        mt = self.timestep_map[t].float()
        if self.rescale_timesteps:
            mt = mt * (1000.0 / self.original_num_steps)
        return mt

    def q_sample(self, x_start, t, noise):
        return (_bcast(self.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
                + _bcast(self.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
                * noise)

    def q_posterior_mean(self, x_start, x_t, t):
        return (_bcast(self.posterior_mean_coef1, t, x_t.ndim) * x_start
                + _bcast(self.posterior_mean_coef2, t, x_t.ndim) * x_t)

    def get_v(self, x_start, noise, t):
        return (_bcast(self.sqrt_alphas_cumprod, t, x_start.ndim) * noise
                - _bcast(self.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
                * x_start)

    def training_losses(self, model: Callable, x_start: torch.Tensor,
                        t: torch.Tensor, noise: torch.Tensor):
        """The MSE training loss against the configured target, with the
        min-SNR-5 weight when `min_snr`. `model(x_t, t_scaled)` returns
        channels-last output; the caller draws the noise. Returns (terms
        with 'loss' and 'mse' [B], aux with x_t and model_output)."""
        if self.var_type in ("learned", "learned_range"):
            raise NotImplementedError(
                "the learned-variance terms (_vb_terms) are not ported")
        x_t = self.q_sample(x_start, t, noise)
        if self.min_snr:
            snr = (self.sqrt_alphas_cumprod[t]
                   / self.sqrt_one_minus_alphas_cumprod[t]) ** 2
            mse_weight = torch.where(snr == 0, 1.0, torch.clamp(snr, max=5.0))
        else:
            mse_weight = torch.ones(t.shape, dtype=x_start.dtype,
                                    device=x_start.device)
        model_output = model(x_t, self.scaled_model_t(t))
        target = {
            "xprev": lambda: self.q_posterior_mean(x_start, x_t, t),
            "x0": lambda: x_start,
            "eps": lambda: noise,
            "v": lambda: self.get_v(x_start, noise, t),
        }[self.mean_type]()
        mse = mean_flat((target - model_output) ** 2)
        terms = {"mse": mse, "loss": mse * mse_weight}
        return terms, {"x_t": x_t, "model_output": model_output}


def create_diffusion(*, schedule: str = "cosine", steps: int = 1000,
                     mean_type: str = "v", var_type: str = "fixed_small",
                     min_snr: bool = False, rescale_timesteps: bool = False,
                     betas: Optional[np.ndarray] = None) -> GaussianDiffusion:
    """A full (not respaced) diffusion process; cosine + v-prediction is the
    reference's training configuration."""
    if betas is None:
        betas = get_named_beta_schedule(schedule, steps)
    return diffusion_from_betas(
        betas, mean_type=mean_type, var_type=var_type, min_snr=min_snr,
        rescale_timesteps=rescale_timesteps, timestep_map=np.arange(len(betas)),
        original_num_steps=steps)


def diffusion_from_betas(betas: np.ndarray, *, mean_type: str, var_type: str,
                         min_snr: bool = False, rescale_timesteps: bool = False,
                         timestep_map: Optional[np.ndarray] = None,
                         original_num_steps: Optional[int] = None
                         ) -> GaussianDiffusion:
    """Every coefficient table from betas (float64 precompute)."""
    if mean_type not in MEAN_TYPES or var_type not in VAR_TYPES:
        raise ValueError(f"unknown mean_type {mean_type!r} or var_type "
                         f"{var_type!r}")
    betas = np.asarray(betas, dtype=np.float64)
    if not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must lie in (0, 1]")
    n = len(betas)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    acp_next = np.append(acp[1:], 0.0)
    posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:]))

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    if timestep_map is None:
        timestep_map = np.arange(n)
    return GaussianDiffusion(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        alphas_cumprod_next=f32(acp_next),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas)
                                 / (1.0 - acp)),
        timestep_map=torch.tensor(np.asarray(timestep_map), dtype=torch.long),
        mean_type=mean_type, var_type=var_type, min_snr=min_snr,
        rescale_timesteps=rescale_timesteps,
        original_num_steps=original_num_steps or n)
