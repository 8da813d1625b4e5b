"""Gaussian diffusion (port of gvfdiffusion_tpu/diffusion/
gaussian_diffusion.py): the beta schedules, the `GaussianDiffusion` tables
with the forward process (`q_*`), the parameterization conversions
(`predict_*`), one reverse step (`p_mean_variance`, every variance type,
the dynamic-threshold clip), the ancestral and DDIM sampling loops, the
bits-per-dim evaluation (`calc_bpd_loop`), the training losses with the
learned-variance bound terms (`_vb_terms`), `create_diffusion` and
`diffusion_from_betas`.

Coefficients are precomputed in float64 numpy, as the reference does, and
stored as fp32 tensors. Channels last. The JAX `lax.scan` loops are Python
loops here, and randomness comes from an explicit `torch.Generator` where
JAX takes a PRNG key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .losses import discretized_gaussian_log_likelihood, normal_kl


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

    def _randn(self, shape, generator: Optional[torch.Generator]):
        device = self.betas.device if generator is None else generator.device
        return torch.randn(shape, generator=generator, device=device)

    # -- q (forward) ---------------------------------------------------------

    def q_mean_variance(self, x_start, t):
        mean = _bcast(self.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
        variance = _bcast(1.0 - self.alphas_cumprod, t, x_start.ndim)
        log_variance = _bcast(self.log_one_minus_alphas_cumprod, t,
                              x_start.ndim)
        return mean, variance, log_variance

    def q_sample(self, x_start, t, noise):
        return (_bcast(self.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
                + _bcast(self.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
                * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        mean = (_bcast(self.posterior_mean_coef1, t, x_t.ndim) * x_start
                + _bcast(self.posterior_mean_coef2, t, x_t.ndim) * x_t)
        variance = _bcast(self.posterior_variance, t, x_t.ndim)
        log_variance = _bcast(self.posterior_log_variance_clipped, t,
                              x_t.ndim)
        return mean, variance, log_variance

    def get_v(self, x_start, noise, t):
        return (_bcast(self.sqrt_alphas_cumprod, t, x_start.ndim) * noise
                - _bcast(self.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
                * x_start)

    # -- parameterization conversions --------------------------------------

    def predict_xstart_from_eps(self, x_t, t, eps):
        return (_bcast(self.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
                - _bcast(self.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps)

    def predict_xstart_from_v(self, x_t, t, v):
        return (_bcast(self.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
                - _bcast(self.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v)

    def predict_xstart_from_xprev(self, x_t, t, xprev):
        c1 = _bcast(1.0 / self.posterior_mean_coef1, t, x_t.ndim)
        c2 = _bcast(self.posterior_mean_coef2 / self.posterior_mean_coef1, t,
                    x_t.ndim)
        return c1 * xprev - c2 * x_t

    def predict_eps_from_xstart(self, x_t, t, x_start):
        return ((_bcast(self.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
                 - x_start)
                / _bcast(self.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))

    # -- p (reverse) ---------------------------------------------------------

    def p_mean_variance(self, model: Callable, x: torch.Tensor,
                        t: torch.Tensor, clip_denoised: bool = True,
                        denoised_fn: Optional[Callable] = None,
                        dynamic_threshold: Optional[float] = 0.99,
                        model_kwargs: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
        """One reverse-step distribution p(x_{t-1} | x_t): mean, variance,
        log_variance and pred_xstart. `model(x, t_scaled, **kwargs)` returns
        channels-last output; for the learned variance types its last axis
        is 2C (mean values, then variance values). With clip_denoised the
        predicted x0 is clipped to its per-sample |x0| quantile
        `dynamic_threshold` (not rescaled), or with dynamic_threshold=None
        to [-1, 1]."""
        model_output = model(x, self.scaled_model_t(t), **(model_kwargs or {}))

        if self.var_type in ("learned", "learned_range"):
            model_output, model_var_values = model_output.chunk(2, dim=-1)
            if self.var_type == "learned":
                model_log_variance = model_var_values
            else:
                min_log = _bcast(self.posterior_log_variance_clipped, t,
                                 x.ndim)
                max_log = _bcast(torch.log(self.betas), t, x.ndim)
                frac = (model_var_values + 1.0) / 2.0
                model_log_variance = frac * max_log + (1.0 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif self.var_type == "fixed_large":
            # the betas, with posterior_variance[1] at t = 0
            var = torch.cat([self.posterior_variance[1:2], self.betas[1:]])
            model_variance = _bcast(var, t, x.ndim)
            model_log_variance = _bcast(torch.log(var), t, x.ndim)
        else:  # fixed_small
            model_variance = _bcast(self.posterior_variance, t, x.ndim)
            model_log_variance = _bcast(self.posterior_log_variance_clipped,
                                        t, x.ndim)

        def process_xstart(x0):
            if denoised_fn is not None:
                x0 = denoised_fn(x0)
            if not clip_denoised:
                return x0
            if dynamic_threshold is None:
                return torch.clamp(x0, -1.0, 1.0)
            flat = x0.reshape(x0.shape[0], -1).abs()
            # torch.quantile reduces at most 2^24 values a row
            if flat.shape[1] > 1 << 24:
                raise ValueError(f"dynamic threshold over {flat.shape[1]} "
                                 "values a sample: more than 2^24")
            s = torch.quantile(flat, dynamic_threshold, dim=1)
            s = s.reshape((-1,) + (1,) * (x0.ndim - 1))
            return torch.clamp(x0, -s, s)

        if self.mean_type == "xprev":
            pred_xstart = process_xstart(
                self.predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        else:
            if self.mean_type == "x0":
                pred_xstart = process_xstart(model_output)
            elif self.mean_type == "eps":
                pred_xstart = process_xstart(
                    self.predict_xstart_from_eps(x, t, model_output))
            else:  # v
                pred_xstart = process_xstart(
                    self.predict_xstart_from_v(x, t, model_output))
            model_mean = self.q_posterior_mean_variance(pred_xstart, x, t)[0]
        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance,
                "pred_xstart": pred_xstart}

    # -- sampling loops --------------------------------------------------------

    def _sample_loop(self, step: Callable, shape, generator, noise,
                     inpainting_mask):
        """x_T -> x_0 over t = num_timesteps - 1 .. 0: x_{t-1} = step(x, t
        as [B], fresh noise z); with inpainting_mask (broadcastable to x; 1
        resamples, 0 keeps the current value) blended at every step."""
        x = self._randn(shape, generator) if noise is None else noise
        for t in range(self.num_timesteps - 1, -1, -1):
            tb = torch.full((shape[0],), t, dtype=torch.long, device=x.device)
            x_next = step(x, tb, t, self._randn(x.shape, generator))
            if inpainting_mask is not None:
                x_next = (1 - inpainting_mask) * x + inpainting_mask * x_next
            x = x_next
        return x

    @torch.no_grad()
    def p_sample_loop(self, model: Callable, shape,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None,
                      clip_denoised: bool = True,
                      denoised_fn: Optional[Callable] = None,
                      dynamic_threshold: Optional[float] = None,
                      model_kwargs: Optional[Dict[str, Any]] = None,
                      inpainting_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Ancestral sampling x_T -> x_0, the initial noise `noise` or drawn
        from `generator`, as is each step's."""
        def step(x, tb, t, z):
            out = self.p_mean_variance(model, x, tb, clip_denoised,
                                       denoised_fn, dynamic_threshold,
                                       model_kwargs)
            return out["mean"] + float(t != 0) * torch.exp(
                0.5 * out["log_variance"]) * z

        return self._sample_loop(step, shape, generator, noise,
                                 inpainting_mask)

    @torch.no_grad()
    def ddim_sample_loop(self, model: Callable, shape,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None,
                         clip_denoised: bool = True,
                         denoised_fn: Optional[Callable] = None,
                         dynamic_threshold: Optional[float] = None,
                         model_kwargs: Optional[Dict[str, Any]] = None,
                         eta: float = 0.0,
                         inpainting_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """DDIM sampling x_T -> x_0; at eta = 0 deterministic given the
        initial noise."""
        def step(x, tb, t, z):
            out = self.p_mean_variance(model, x, tb, clip_denoised,
                                       denoised_fn, dynamic_threshold,
                                       model_kwargs)
            eps = self.predict_eps_from_xstart(x, tb, out["pred_xstart"])
            acp = _bcast(self.alphas_cumprod, tb, x.ndim)
            acp_prev = _bcast(self.alphas_cumprod_prev, tb, x.ndim)
            sigma = (eta * torch.sqrt((1 - acp_prev) / (1 - acp))
                     * torch.sqrt(1 - acp / acp_prev))
            mean = (out["pred_xstart"] * torch.sqrt(acp_prev)
                    + torch.sqrt(1 - acp_prev - sigma ** 2) * eps)
            return mean + float(t != 0) * sigma * z

        return self._sample_loop(step, shape, generator, noise,
                                 inpainting_mask)

    # -- likelihood evaluation -------------------------------------------------

    @torch.no_grad()
    def calc_bpd_loop(self, model: Callable, x_start: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      clip_denoised: bool = True,
                      model_kwargs: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, torch.Tensor]:
        """The full variational bound in bits per dim: total_bpd and
        prior_bpd [B], and vb, xstart_mse and mse [B, T] with t descending
        along axis 1. Each step's noise is drawn from `generator`."""
        B = x_start.shape[0]
        vb, xstart_mse, mse = [], [], []
        for t in range(self.num_timesteps - 1, -1, -1):
            tb = torch.full((B,), t, dtype=torch.long, device=x_start.device)
            noise = self._randn(x_start.shape, generator).to(x_start.dtype)
            x_t = self.q_sample(x_start, tb, noise)
            out = self._vb_terms(model, x_start, x_t, tb, clip_denoised,
                                 model_kwargs=model_kwargs)
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            eps = self.predict_eps_from_xstart(x_t, tb, out["pred_xstart"])
            mse.append(mean_flat((eps - noise) ** 2))
        vb, xstart_mse, mse = (torch.stack(a, 1)
                               for a in (vb, xstart_mse, mse))
        prior_bpd = self.prior_bpd(x_start)
        return {"total_bpd": vb.sum(dim=1) + prior_bpd,
                "prior_bpd": prior_bpd, "vb": vb, "xstart_mse": xstart_mse,
                "mse": mse}

    def prior_bpd(self, x_start: torch.Tensor) -> torch.Tensor:
        """KL(q(x_T | x_0) || N(0, I)) in bits per dim, [B]."""
        tb = torch.full((x_start.shape[0],), self.num_timesteps - 1,
                        dtype=torch.long, device=x_start.device)
        qt_mean, _, qt_log_var = self.q_mean_variance(x_start, tb)
        zeros = torch.zeros_like(x_start)
        prior = normal_kl(qt_mean, qt_log_var.expand(x_start.shape), zeros,
                          zeros)
        return mean_flat(prior) / math.log(2.0)

    # -- training ------------------------------------------------------------

    def training_losses(self, model: Callable, x_start: torch.Tensor,
                        t: torch.Tensor, noise: torch.Tensor,
                        model_kwargs: Optional[Dict[str, Any]] = None):
        """The MSE training loss against the configured target, with the
        min-SNR-5 weight when `min_snr`, plus the variational-bound term
        "vb" for the learned variance types (the mean half detached, as in
        JAX). `model(x_t, t_scaled, **model_kwargs)` returns channels-last
        output; the caller draws the noise. Returns (terms with 'loss' and
        'mse' [B], and 'vb' where learned; aux with x_t and
        model_output)."""
        x_t = self.q_sample(x_start, t, noise)
        if self.min_snr:
            snr = (self.sqrt_alphas_cumprod[t]
                   / self.sqrt_one_minus_alphas_cumprod[t]) ** 2
            mse_weight = torch.where(snr == 0, 1.0, torch.clamp(snr, max=5.0))
        else:
            mse_weight = torch.ones(t.shape, dtype=x_start.dtype,
                                    device=x_start.device)
        model_output = model(x_t, self.scaled_model_t(t),
                             **(model_kwargs or {}))
        terms = {}
        if self.var_type in ("learned", "learned_range"):
            model_output, model_var_values = model_output.chunk(2, dim=-1)
            frozen = torch.cat([model_output.detach(), model_var_values], -1)
            terms["vb"] = self._vb_terms(lambda *a, **k: frozen, x_start,
                                         x_t, t, clip_denoised=False)["output"]
        target = {
            "xprev": lambda: self.q_posterior_mean_variance(x_start, x_t,
                                                            t)[0],
            "x0": lambda: x_start,
            "eps": lambda: noise,
            "v": lambda: self.get_v(x_start, noise, t),
        }[self.mean_type]()
        terms["mse"] = mean_flat((target - model_output) ** 2)
        terms["loss"] = terms["mse"] * mse_weight + terms.get("vb", 0.0)
        return terms, {"x_t": x_t, "model_output": model_output}

    def _vb_terms(self, model, x_start, x_t, t, clip_denoised=True,
                  model_kwargs=None):
        """The bound's term at t in bits per dim, [B]: the KL of the
        posterior against p, or at t = 0 the discretized decoder NLL."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(
            x_start, x_t, t)
        out = self.p_mean_variance(model, x_t, t, clip_denoised,
                                   model_kwargs=model_kwargs)
        kl = normal_kl(true_mean, true_log_var, out["mean"],
                       out["log_variance"])
        kl = mean_flat(kl) / math.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
        return {"output": torch.where(t == 0, decoder_nll, kl),
                "pred_xstart": out["pred_xstart"]}


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
