"""DPM-Solver++ multistep sampling (port of gvfdiffusion_tpu/diffusion/
dpm_solver.py: NoiseScheduleVP, model_wrapper, DPMSolver multistep orders
1-3 on the time-uniform grid from T to 1/N). The JAX `lax.scan` over steps
is a Python loop here. Only what the pipeline runs is ported: a
v-prediction model, classifier-free (single-pass or dual-scale) guidance
and the data-prediction (DPM-Solver++) updates.

Schedule values are float32 tensors. Solver scalars (times, alphas, sigmas)
stay 0-d CPU tensors, which combine with CUDA tensors without a device sync;
per-sample values move to the latent's device.

Solver math follows Lu et al., "DPM-Solver++" (arXiv:2211.01095).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """jnp.interp with constant extrapolation (xp ascending)."""
    x = x.contiguous()
    xp = xp.to(x.device)
    fp = fp.to(x.device)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.float()
    return torch.tensor(v, dtype=torch.float32)


class NoiseScheduleVP:
    """Discrete-time VP noise schedule with piecewise-linear log-alpha
    interpolation. lambda_t = log(alpha_t) - log(sigma_t)."""

    def __init__(self, t_array: torch.Tensor, log_alpha_array: torch.Tensor,
                 T: float = 1.0, total_N: int = 1000):
        self.t_array = t_array
        self.log_alpha_array = log_alpha_array
        self.T = T
        self.total_N = total_N

    @classmethod
    def from_betas(cls, betas: np.ndarray, clipped_lambda: float = -5.1):
        """Build from discrete betas, dropping the tail whose lambda falls
        below `clipped_lambda`; the t grid spans the clipped length."""
        betas = np.asarray(betas, dtype=np.float64)
        log_alphas = 0.5 * np.cumsum(np.log(1.0 - betas))
        log_sigmas = 0.5 * np.log(1.0 - np.exp(2.0 * log_alphas))
        lambs = log_alphas - log_sigmas
        idx = np.searchsorted(lambs[::-1], clipped_lambda)
        if idx > 0:
            log_alphas = log_alphas[:-idx]
        n = len(log_alphas)
        t_array = np.linspace(0.0, 1.0, n + 1)[1:]
        return cls(torch.tensor(t_array, dtype=torch.float32),
                   torch.tensor(log_alphas, dtype=torch.float32),
                   T=1.0, total_N=n)

    def marginal_log_mean_coeff(self, t):
        return _interp(_f32(t), self.t_array, self.log_alpha_array)

    def marginal_alpha(self, t):
        return torch.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_mean = self.marginal_log_mean_coeff(t)
        log_std = 0.5 * torch.log(1.0 - torch.exp(2.0 * log_mean))
        return log_mean - log_std

    def inverse_lambda(self, lamb):
        lamb = _f32(lamb)
        log_alpha = -0.5 * torch.logaddexp(torch.zeros_like(lamb), -2.0 * lamb)
        return _interp(log_alpha, self.log_alpha_array.flip(0),
                       self.t_array.flip(0))


def model_wrapper(
    model: Callable,
    noise_schedule: NoiseScheduleVP,
    condition: Dict[str, torch.Tensor],
    unconditional_condition: Optional[Dict[str, torch.Tensor]] = None,
    guidance_scale: float = 1.0,
    guidance_scale2: float = 1.0,
    cross_kv=None,
) -> Callable:
    """Wrap a discrete-time v-prediction model into a continuous-time noise
    predictor model_fn(x, t_continuous). At guidance 1.0/1.0 (or without an
    unconditional condition) it is one conditional pass; otherwise the
    dual-scale CFG of CAT4D,
        eps = e_full_uncond + s1 * (e_static_uncond - e_full_uncond)
              + s2 * (e_cond - e_static_uncond),
    in ONE 3-way-batched model call, the conditions concatenated in the
    order (unconditional, unconditional, conditional). The JAX wrapper
    zeroes `static_latent` in the first branch; the port's caller builds
    that branch into `cross_kv` instead (pipelines/video_to_4d.py)."""

    def noise_pred_fn(x, t_continuous, cond):
        t_continuous = _f32(t_continuous).to(x.device).expand(x.shape[0])
        t_input = (t_continuous - 1.0 / noise_schedule.total_N) * 1000.0
        output = model(x, t_input, **cond, cross_kv=cross_kv)
        shape = (-1,) + (1,) * (x.ndim - 1)
        alpha_t = noise_schedule.marginal_alpha(t_continuous).reshape(shape)
        sigma_t = noise_schedule.marginal_std(t_continuous).reshape(shape)
        return alpha_t * output + sigma_t * x

    if ((guidance_scale == 1.0 and guidance_scale2 == 1.0)
            or unconditional_condition is None):
        return lambda x, t: noise_pred_fn(x, t, condition)

    def model_fn(x, t_continuous):
        x_in = torch.cat([x] * 3)
        t = _f32(t_continuous).reshape(-1)
        t_in = torch.cat([t.expand(x.shape[0])] * 3)
        u = unconditional_condition
        c_in = {k: torch.cat([u[k], u[k], condition[k]]) for k in condition}
        e_fu, e_u, e_c = noise_pred_fn(x_in, t_in, c_in).chunk(3)
        return (e_fu + guidance_scale * (e_u - e_fu)
                + guidance_scale2 * (e_c - e_u))

    return model_fn


class DPMSolver:
    """DPM-Solver++ (data-prediction) multistep sampler.

    model_fn(x, t_continuous) -> noise prediction."""

    def __init__(self, model_fn: Callable, noise_schedule: NoiseScheduleVP):
        self.model_fn_raw = model_fn
        self.ns = noise_schedule

    def model_fn(self, x, t):
        """The data prediction x0 = (x - sigma_t * eps) / alpha_t."""
        noise = self.model_fn_raw(x, t)
        return (x - self.ns.marginal_std(t) * noise) / self.ns.marginal_alpha(t)

    def first_update(self, x, s, t, model_s):
        ns = self.ns
        h = ns.marginal_lambda(t) - ns.marginal_lambda(s)
        phi_1 = torch.expm1(-h)
        return ((ns.marginal_std(t) / ns.marginal_std(s)) * x
                - (ns.marginal_alpha(t) * phi_1) * model_s)

    def multistep_second_update(self, x, m_prev, t_prev, t):
        """m_prev = (model[-2], model[-1]); t_prev = (t[-2], t[-1])."""
        ns = self.ns
        m1, m0 = m_prev
        t1, t0 = t_prev
        lam1, lam0, lam_t = (ns.marginal_lambda(t1), ns.marginal_lambda(t0),
                             ns.marginal_lambda(t))
        h0, h = lam0 - lam1, lam_t - lam0
        r0 = h0 / h
        d1_0 = (1.0 / r0) * (m0 - m1)
        phi_1 = torch.expm1(-h)
        return ((ns.marginal_std(t) / ns.marginal_std(t0)) * x
                - ns.marginal_alpha(t) * phi_1 * m0
                - 0.5 * ns.marginal_alpha(t) * phi_1 * d1_0)

    def multistep_third_update(self, x, m_prev, t_prev, t):
        ns = self.ns
        m2, m1, m0 = m_prev
        t2, t1, t0 = t_prev
        lam2, lam1, lam0, lam_t = (
            ns.marginal_lambda(t2), ns.marginal_lambda(t1),
            ns.marginal_lambda(t0), ns.marginal_lambda(t))
        h1, h0, h = lam1 - lam2, lam0 - lam1, lam_t - lam0
        r0, r1 = h0 / h, h1 / h
        d1_0 = (1.0 / r0) * (m0 - m1)
        d1_1 = (1.0 / r1) * (m1 - m2)
        d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = (1.0 / (r0 + r1)) * (d1_0 - d1_1)
        phi_1 = torch.expm1(-h)
        phi_2 = phi_1 / h + 1.0
        phi_3 = phi_2 / h - 0.5
        a_t = ns.marginal_alpha(t)
        return ((ns.marginal_std(t) / ns.marginal_std(t0)) * x
                - a_t * phi_1 * m0 + a_t * phi_2 * d1 - a_t * phi_3 * d2)

    def multistep_update(self, x, m_hist, t_hist, t, order: int):
        """Update of the given order from the most recent history entries."""
        if order == 1:
            return self.first_update(x, t_hist[-1], t, m_hist[-1])
        if order == 2:
            return self.multistep_second_update(x, m_hist[-2:], t_hist[-2:], t)
        if order == 3:
            return self.multistep_third_update(x, m_hist[-3:], t_hist[-3:], t)
        raise ValueError(f"order must be 1..3, got {order}")

    def sample(self, x: torch.Tensor, steps: int = 20,
               order: int = 2) -> torch.Tensor:
        """Multistep sampling over `steps` time-uniform steps from T to 1/N.
        Below 10 steps the order drops over the last steps
        (lower_order_final); otherwise the order stays constant and the
        final update runs no model."""
        if not 1 <= order <= 3 or steps < order:
            raise ValueError(f"need 1 <= order <= 3 and steps >= order; got "
                             f"order {order}, steps {steps}")
        ts = torch.tensor(np.linspace(self.ns.T, 1.0 / self.ns.total_N,
                                      steps + 1), dtype=torch.float32)

        # warm-up: the first `order` model values via increasing orders
        m_hist = [self.model_fn(x, ts[0])]
        t_hist = [ts[0]]
        for step in range(1, order):
            x = self.multistep_update(x, m_hist, t_hist, ts[step], step)
            t_hist.append(ts[step])
            m_hist.append(self.model_fn(x, ts[step]))

        if steps < 10:
            for step in range(order, steps + 1):
                step_order = min(order, steps + 1 - step)
                x = self.multistep_update(x, m_hist, t_hist, ts[step],
                                          step_order)
                t_hist = t_hist[1:] + [ts[step]]
                if step < steps:
                    m_hist = m_hist[1:] + [self.model_fn(x, ts[step])]
            return x

        for step in range(order, steps):
            x = self.multistep_update(x, m_hist, t_hist, ts[step], order)
            t_hist = t_hist[1:] + [ts[step]]
            m_hist = m_hist[1:] + [self.model_fn(x, ts[step])]
        return self.multistep_update(x, m_hist, t_hist, ts[steps], order)
