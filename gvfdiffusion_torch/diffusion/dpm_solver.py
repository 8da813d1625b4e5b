"""DPM-Solver and DPM-Solver++ (port of gvfdiffusion_tpu/diffusion/
dpm_solver.py): `NoiseScheduleVP` (from betas or alphas_cumprod),
`model_wrapper` (noise / x_start / v / score models, unconditional or
classifier-free guidance with the dual-scale CFG of CAT4D), and `DPMSolver`
with both algorithm types, the singlestep updates of orders 1-3 and the
multistep updates of orders 1-3, the three time grids, `sample` (multistep,
singlestep, singlestep_fixed and the adaptive step-size solver), and
`inverse`.

JAX's `lax.scan` over the multistep loop is a Python loop here, and its
`lax.while_loop` of the adaptive solver a Python loop whose accept/reject
and stop tests read the error on the host: one device sync an iteration
(`return_info` counts them).

Schedule values are float32 tensors. Solver scalars (times, lambdas,
alphas, sigmas, the adaptive step) stay 0-d CPU tensors, in float32 as in
JAX, which combine with CUDA tensors without a device sync; per-sample
values move to the latent's device.

Solver math follows Lu et al., "DPM-Solver++" (arXiv:2211.01095).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

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

    @classmethod
    def from_alphas_cumprod(cls, alphas_cumprod: np.ndarray, **kw):
        acp = np.asarray(alphas_cumprod, dtype=np.float64)
        betas = 1.0 - acp / np.concatenate([[1.0], acp[:-1]])
        return cls.from_betas(betas, **kw)

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
    model_type: str = "noise",
    model_kwargs: Optional[Dict[str, torch.Tensor]] = None,
    guidance_type: str = "uncond",
    condition: Optional[Dict[str, torch.Tensor]] = None,
    unconditional_condition: Optional[Dict[str, torch.Tensor]] = None,
    guidance_scale: float = 1.0,
    guidance_scale2: float = 1.0,
    zero_uncond_keys: Sequence[str] = ("static_latent",),
    cross_kv=None,
) -> Callable:
    """Wrap a discrete-time model (`model(x, t_input, **kwargs)`, t_input
    in [0, 1000 (N - 1) / N]) into a continuous-time noise predictor
    model_fn(x, t_continuous), t a scalar or [B]. model_type: "noise",
    "x_start", "v" or "score". guidance_type "uncond" (or guidance 1.0/1.0,
    or no unconditional condition) is one pass on `condition`;
    "classifier-free" is the dual-scale CFG of CAT4D,
        eps = e_full_uncond + s1 * (e_static_uncond - e_full_uncond)
              + s2 * (e_cond - e_static_uncond),
    in ONE 3-way-batched model call, the conditions concatenated in the
    order (full-uncond, uncond, cond), the full-uncond branch with
    `zero_uncond_keys` zeroed. A hoisted `cross_kv` goes to every call; the
    port's pipeline builds the zeroed branch into it."""
    model_kwargs = model_kwargs or {}
    if model_type not in ("noise", "x_start", "v", "score"):
        raise ValueError(f"unknown model_type {model_type!r}")
    if guidance_type not in ("uncond", "classifier-free"):
        raise ValueError(f"unknown guidance_type {guidance_type!r}")
    ns = noise_schedule

    def noise_pred_fn(x, t_continuous, cond=None):
        t_continuous = _f32(t_continuous).to(x.device).expand(x.shape[0])
        t_input = (t_continuous - 1.0 / ns.total_N) * 1000.0
        kwargs = dict(model_kwargs)
        if cond is not None:
            kwargs.update(cond)
        if cross_kv is not None:
            kwargs["cross_kv"] = cross_kv
        output = model(x, t_input, **kwargs)
        if model_type == "noise":
            return output
        shape = (-1,) + (1,) * (x.ndim - 1)
        sigma_t = ns.marginal_std(t_continuous).reshape(shape)
        if model_type == "score":
            return -sigma_t * output
        alpha_t = ns.marginal_alpha(t_continuous).reshape(shape)
        if model_type == "x_start":
            return (x - alpha_t * output) / sigma_t
        return alpha_t * output + sigma_t * x  # v

    if (guidance_type == "uncond"
            or (guidance_scale == 1.0 and guidance_scale2 == 1.0)
            or unconditional_condition is None):
        return lambda x, t: noise_pred_fn(x, t, cond=condition)

    def model_fn(x, t_continuous):
        x_in = torch.cat([x] * 3)
        t = _f32(t_continuous).reshape(-1)
        t_in = torch.cat([t.expand(x.shape[0])] * 3)
        u = unconditional_condition
        full_uncond = {k: torch.zeros_like(v) if k in zero_uncond_keys else v
                       for k, v in u.items()}
        c_in = {k: torch.cat([full_uncond[k], u[k], condition[k]])
                for k in condition}
        e_fu, e_u, e_c = noise_pred_fn(x_in, t_in, c_in).chunk(3)
        return (e_fu + guidance_scale * (e_u - e_fu)
                + guidance_scale2 * (e_c - e_u))

    return model_fn


class DPMSolver:
    """DPM-Solver++ (data prediction, the default) or DPM-Solver (noise
    prediction). model_fn(x, t_continuous) -> noise prediction. `nfe`
    counts the model calls."""

    def __init__(self, model_fn: Callable, noise_schedule: NoiseScheduleVP,
                 algorithm_type: str = "dpmsolver++"):
        if algorithm_type not in ("dpmsolver", "dpmsolver++"):
            raise ValueError(f"unknown algorithm_type {algorithm_type!r}")
        self.model_fn_raw = model_fn
        self.ns = noise_schedule
        self.algorithm_type = algorithm_type
        self.nfe = 0

    def model_fn(self, x, t):
        """The data prediction x0 = (x - sigma_t * eps) / alpha_t for
        dpmsolver++, the noise prediction otherwise."""
        self.nfe += 1
        noise = self.model_fn_raw(x, t)
        if self.algorithm_type == "dpmsolver++":
            return ((x - self.ns.marginal_std(t) * noise)
                    / self.ns.marginal_alpha(t))
        return noise

    # -- singlestep updates ------------------------------------------------

    def first_update(self, x, s, t, model_s):
        ns = self.ns
        h = ns.marginal_lambda(t) - ns.marginal_lambda(s)
        if self.algorithm_type == "dpmsolver++":
            phi_1 = torch.expm1(-h)
            return ((ns.marginal_std(t) / ns.marginal_std(s)) * x
                    - (ns.marginal_alpha(t) * phi_1) * model_s)
        phi_1 = torch.expm1(h)
        return (torch.exp(ns.marginal_log_mean_coeff(t)
                          - ns.marginal_log_mean_coeff(s)) * x
                - ns.marginal_std(t) * phi_1 * model_s)

    def singlestep_second_update(self, x, s, t, r1=0.5, model_s=None,
                                 return_intermediate: bool = False):
        """Order-2 singlestep. Returns (x_t, model_s), so that a lower-order
        estimate can reuse model_s; with return_intermediate also model_s1,
        the model at s1 = lambda^-1(lambda_s + r1 h), which the order-3
        update at the same r1 computes again otherwise."""
        ns = self.ns
        lambda_s, lambda_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
        h = lambda_t - lambda_s
        s1 = ns.inverse_lambda(lambda_s + r1 * h)
        sigma_s, sigma_s1, sigma_t = (ns.marginal_std(s), ns.marginal_std(s1),
                                      ns.marginal_std(t))
        alpha_s1, alpha_t = ns.marginal_alpha(s1), ns.marginal_alpha(t)
        if model_s is None:
            model_s = self.model_fn(x, s)
        if self.algorithm_type == "dpmsolver++":
            phi_11 = torch.expm1(-r1 * h)
            phi_1 = torch.expm1(-h)
            x_s1 = (sigma_s1 / sigma_s) * x - alpha_s1 * phi_11 * model_s
            model_s1 = self.model_fn(x_s1, s1)
            x_t = ((sigma_t / sigma_s) * x - alpha_t * phi_1 * model_s
                   - (0.5 / r1) * alpha_t * phi_1 * (model_s1 - model_s))
        else:
            log_a = ns.marginal_log_mean_coeff
            phi_11 = torch.expm1(r1 * h)
            phi_1 = torch.expm1(h)
            x_s1 = (torch.exp(log_a(s1) - log_a(s)) * x
                    - sigma_s1 * phi_11 * model_s)
            model_s1 = self.model_fn(x_s1, s1)
            x_t = (torch.exp(log_a(t) - log_a(s)) * x
                   - sigma_t * phi_1 * model_s
                   - (0.5 / r1) * sigma_t * phi_1 * (model_s1 - model_s))
        if return_intermediate:
            return x_t, model_s, model_s1
        return x_t, model_s

    def singlestep_third_update(self, x, s, t, r1=1.0 / 3.0, r2=2.0 / 3.0,
                                model_s=None, model_s1=None):
        """Order-3 singlestep (dpmsolver++ only, as in JAX). Returns (x_t,
        model_s, model_s1)."""
        if self.algorithm_type != "dpmsolver++":
            raise NotImplementedError("the order-3 singlestep update is "
                                      "dpmsolver++ only")
        ns = self.ns
        lambda_s, lambda_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
        h = lambda_t - lambda_s
        s1 = ns.inverse_lambda(lambda_s + r1 * h)
        s2 = ns.inverse_lambda(lambda_s + r2 * h)
        sig, alp = ns.marginal_std, ns.marginal_alpha
        phi_11 = torch.expm1(-r1 * h)
        phi_12 = torch.expm1(-r2 * h)
        phi_1 = torch.expm1(-h)
        phi_22 = phi_12 / (r2 * h) + 1.0
        phi_2 = phi_1 / h + 1.0
        if model_s is None:
            model_s = self.model_fn(x, s)
        x_s1 = (sig(s1) / sig(s)) * x - alp(s1) * phi_11 * model_s
        if model_s1 is None:
            model_s1 = self.model_fn(x_s1, s1)
        x_s2 = ((sig(s2) / sig(s)) * x - alp(s2) * phi_12 * model_s
                + (r2 / r1) * alp(s2) * phi_22 * (model_s1 - model_s))
        model_s2 = self.model_fn(x_s2, s2)
        x_t = ((sig(t) / sig(s)) * x - alp(t) * phi_1 * model_s
               + (1.0 / r2) * alp(t) * phi_2 * (model_s2 - model_s))
        return x_t, model_s, model_s1

    def singlestep_update(self, x, s, t, order: int, r1=None, r2=None):
        if order == 1:
            return self.first_update(x, s, t, self.model_fn(x, s))
        if order == 2:
            return self.singlestep_second_update(
                x, s, t, r1=0.5 if r1 is None else r1)[0]
        if order == 3:
            return self.singlestep_third_update(
                x, s, t, r1=1.0 / 3.0 if r1 is None else r1,
                r2=2.0 / 3.0 if r2 is None else r2)[0]
        raise ValueError(f"order must be 1..3, got {order}")

    def get_orders_and_timesteps_for_singlestep_solver(
            self, steps: int, order: int, skip_type: str, t_T: float,
            t_0: float):
        """DPM-Solver-fast's allocation of orders 1-3 over exactly `steps`
        model calls, and the outer time grid."""
        if order == 3:
            k = steps // 3 + 1
            if steps % 3 == 0:
                orders = [3] * (k - 2) + [2, 1]
            elif steps % 3 == 1:
                orders = [3] * (k - 1) + [1]
            else:
                orders = [3] * (k - 1) + [2]
        elif order == 2:
            orders = [2] * (steps // 2) + ([1] if steps % 2 else [])
        elif order == 1:
            orders = [1] * steps
        else:
            raise ValueError(f"order must be 1..3, got {order}")
        if skip_type == "logSNR":
            ts = self.get_time_steps(skip_type, t_T, t_0, len(orders))
        else:
            full = self.get_time_steps(skip_type, t_T, t_0, steps)
            ts = full[np.cumsum([0] + orders)]
        return ts, orders

    # -- multistep updates -------------------------------------------------

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
        if self.algorithm_type == "dpmsolver++":
            phi_1 = torch.expm1(-h)
            return ((ns.marginal_std(t) / ns.marginal_std(t0)) * x
                    - ns.marginal_alpha(t) * phi_1 * m0
                    - 0.5 * ns.marginal_alpha(t) * phi_1 * d1_0)
        phi_1 = torch.expm1(h)
        log_a = ns.marginal_log_mean_coeff
        return (torch.exp(log_a(t) - log_a(t0)) * x
                - ns.marginal_std(t) * phi_1 * m0
                - 0.5 * ns.marginal_std(t) * phi_1 * d1_0)

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
        if self.algorithm_type == "dpmsolver++":
            phi_1 = torch.expm1(-h)
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            a_t = ns.marginal_alpha(t)
            return ((ns.marginal_std(t) / ns.marginal_std(t0)) * x
                    - a_t * phi_1 * m0 + a_t * phi_2 * d1 - a_t * phi_3 * d2)
        phi_1 = torch.expm1(h)
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        log_a = ns.marginal_log_mean_coeff
        s_t = ns.marginal_std(t)
        return (torch.exp(log_a(t) - log_a(t0)) * x - s_t * phi_1 * m0
                - s_t * phi_2 * d1 - s_t * phi_3 * d2)

    def multistep_update(self, x, m_hist, t_hist, t, order: int):
        """Update of the given order from the most recent history entries."""
        if order == 1:
            return self.first_update(x, t_hist[-1], t, m_hist[-1])
        if order == 2:
            return self.multistep_second_update(x, m_hist[-2:], t_hist[-2:], t)
        if order == 3:
            return self.multistep_third_update(x, m_hist[-3:], t_hist[-3:], t)
        raise ValueError(f"order must be 1..3, got {order}")

    # -- time grids --------------------------------------------------------

    def get_time_steps(self, skip_type: str, t_T: float, t_0: float,
                       N: int) -> np.ndarray:
        """N + 1 times from t_T to t_0: uniform in t ("time_uniform", float64),
        in sqrt(t) ("time_quadratic", float64) or in lambda ("logSNR", the
        fp32 schedule's inverse)."""
        if skip_type == "time_uniform":
            return np.linspace(t_T, t_0, N + 1, dtype=np.float64)
        if skip_type == "time_quadratic":
            return np.linspace(t_T ** 0.5, t_0 ** 0.5, N + 1,
                               dtype=np.float64) ** 2
        if skip_type == "logSNR":
            lam_T = float(self.ns.marginal_lambda(_f32(t_T)))
            lam_0 = float(self.ns.marginal_lambda(_f32(t_0)))
            lams = np.linspace(lam_T, lam_0, N + 1)
            return self.ns.inverse_lambda(
                torch.tensor(lams, dtype=torch.float32)).numpy()
        raise ValueError(f"unsupported skip_type {skip_type}")

    # -- sampling ----------------------------------------------------------

    def sample(self, x: torch.Tensor, steps: int = 20,
               t_start: Optional[float] = None, t_end: Optional[float] = None,
               order: int = 2, skip_type: str = "time_uniform",
               method: str = "multistep", lower_order_final: bool = True,
               atol: float = 0.0078, rtol: float = 0.05,
               return_info: bool = False):
        """Sample from t_start (default T) to t_end (default 1/N).
        method: "multistep" (below 10 steps with lower_order_final the order
        drops over the last steps; otherwise it stays constant and the final
        update runs no model), "singlestep" (DPM-Solver-fast's orders over
        exactly `steps` model calls), "singlestep_fixed" (steps // order
        updates of `order`) or "adaptive" (orders 2-3, `atol` / `rtol`;
        with return_info also returns its counts, see _sample_adaptive)."""
        t_0 = 1.0 / self.ns.total_N if t_end is None else t_end
        t_T = self.ns.T if t_start is None else t_start
        if method == "adaptive":
            return self._sample_adaptive(x, order, t_T, t_0, atol=atol,
                                         rtol=rtol, return_info=return_info)
        if method in ("singlestep", "singlestep_fixed"):
            if method == "singlestep_fixed":
                k = steps // order
                orders = [order] * k
                ts_np = self.get_time_steps(skip_type, t_T, t_0, k)
            else:
                ts_np, orders = \
                    self.get_orders_and_timesteps_for_singlestep_solver(
                        steps, order, skip_type, t_T, t_0)
            for i, o in enumerate(orders):
                s_i, t_i = float(ts_np[i]), float(ts_np[i + 1])
                # the intermediate points' ratios, from an inner grid of
                # `skip_type` in lambda
                inner = torch.tensor(
                    self.get_time_steps(skip_type, s_i, t_i, max(o, 1)),
                    dtype=torch.float32)
                lam = self.ns.marginal_lambda(inner)
                h = lam[-1] - lam[0]
                r1 = None if o <= 1 else (lam[1] - lam[0]) / h
                r2 = None if o <= 2 else (lam[2] - lam[0]) / h
                x = self.singlestep_update(x, _f32(s_i), _f32(t_i), o,
                                           r1=r1, r2=r2)
            return x
        if method != "multistep":
            raise ValueError(f"unsupported method {method!r}")
        if not 1 <= order <= 3 or steps < order:
            raise ValueError(f"need 1 <= order <= 3 and steps >= order; got "
                             f"order {order}, steps {steps}")
        ts = torch.tensor(self.get_time_steps(skip_type, t_T, t_0, steps),
                          dtype=torch.float32)

        # warm-up: the first `order` model values via increasing orders
        m_hist = [self.model_fn(x, ts[0])]
        t_hist = [ts[0]]
        for step in range(1, order):
            x = self.multistep_update(x, m_hist, t_hist, ts[step], step)
            t_hist.append(ts[step])
            m_hist.append(self.model_fn(x, ts[step]))

        if lower_order_final and steps < 10:
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

    def inverse(self, x: torch.Tensor, steps: int = 20,
                t_start: Optional[float] = None,
                t_end: Optional[float] = None, order: int = 2,
                skip_type: str = "time_uniform",
                method: str = "multistep") -> torch.Tensor:
        """Invert a sample from t_start (default 1/N) to t_end (default T):
        DDIM-style encoding to noise, the solver run in reverse time."""
        t_0 = 1.0 / self.ns.total_N if t_start is None else t_start
        t_T = self.ns.T if t_end is None else t_end
        return self.sample(x, steps=steps, t_start=t_0, t_end=t_T,
                           order=order, skip_type=skip_type, method=method,
                           lower_order_final=False)

    def _sample_adaptive(self, x: torch.Tensor, order: int, t_T: float,
                         t_0: float, h_init: float = 0.05,
                         atol: float = 0.0078, rtol: float = 0.05,
                         theta: float = 0.9, t_err: float = 1e-5,
                         max_iters: int = 200, return_info: bool = False):
        """The adaptive step-size solver (orders 2 and 3): each iteration
        takes a lower- and a higher-order step of h in lambda, accepts the
        higher one when the scaled error err (one scalar over the whole
        tensor) is at most 1, and sets the next h = min(theta h err^(-1 /
        order), lambda_0 - lambda_s); it stops once |s - t_0| <= t_err or
        after max_iters. The times are float32 0-d CPU tensors, as JAX
        keeps them in float32; err is read on the host, one device sync an
        iteration. Order 3 reuses the order-2 step's model at s1 (the same
        point), so an iteration costs `order` model calls.

        With return_info returns (x, info): nfe (model calls), iters,
        accepted, rejected and syncs (host reads of the device)."""
        if order not in (2, 3):
            raise ValueError(f"the adaptive solver takes order 2 or 3, got "
                             f"{order}")
        ns = self.ns
        nfe0 = self.nfe
        lambda_0 = ns.marginal_lambda(_f32(t_0))
        s, h = _f32(t_T), _f32(h_init)
        x_prev = x
        iters = accepted = 0
        while bool(torch.abs(s - t_0) > t_err) and iters < max_iters:
            t = ns.inverse_lambda(ns.marginal_lambda(s) + h)
            if order == 2:
                model_s = self.model_fn(x, s)
                x_lower = self.first_update(x, s, t, model_s)
                x_higher = self.singlestep_second_update(
                    x, s, t, r1=0.5, model_s=model_s)[0]
            else:
                x_lower, model_s, model_s1 = self.singlestep_second_update(
                    x, s, t, r1=1.0 / 3.0, return_intermediate=True)
                x_higher = self.singlestep_third_update(
                    x, s, t, model_s=model_s, model_s1=model_s1)[0]
            delta = torch.clamp(rtol * torch.maximum(x_lower.abs(),
                                                     x_prev.abs()), min=atol)
            err = torch.sqrt(torch.mean(((x_higher - x_lower) / delta) ** 2))
            err = _f32(err.item())  # the iteration's one device sync
            if bool(err <= 1.0):
                x, x_prev, s = x_higher, x_lower, t
                accepted += 1
            h = torch.minimum(
                theta * h * torch.pow(torch.clamp(err, min=1e-10),
                                      -1.0 / order),
                lambda_0 - ns.marginal_lambda(s))
            iters += 1
        if return_info:
            return x, {"nfe": self.nfe - nfe0, "iters": iters,
                       "accepted": accepted, "rejected": iters - accepted,
                       "syncs": iters}
        return x
