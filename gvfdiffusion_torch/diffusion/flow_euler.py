"""Rectified-flow Euler samplers with CFG and a guidance interval (port of
gvfdiffusion_tpu/diffusion/flow_euler.py:24-164).

The t grid is host-side numpy, as in JAX, so a guidance interval splits
the steps statically: steps inside it run the two-call CFG velocity, steps
outside it the conditional call alone. A Python loop stands in for
`lax.scan`; t and the step size are fp32 scalars, as the scan carries
them. `cfg_batched` runs the two CFG passes as one model call on the
2B batch [x; x] with [cond; neg_cond] (off by default, as in JAX, which
measured it slower); the model must take the doubled batch. The x_0
prediction (the only reader of `sigma_min`) is not ported.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def t_schedule(steps: int, rescale_t: float = 1.0) -> np.ndarray:
    """Descending t grid [steps + 1] from 1 to 0, with the reference's
    rescale t' = r t / (1 + (r - 1) t)."""
    t_seq = np.linspace(1.0, 0.0, steps + 1)
    return rescale_t * t_seq / (1 + (rescale_t - 1) * t_seq)


class FlowEulerSampler:
    """model(x_t, t_input [B], cond) -> velocity v."""

    @staticmethod
    def _inference(model: Callable, x_t, t: torch.Tensor, cond):
        tb = (1000.0 * t).expand(x_t.shape[0])
        return model(x_t, tb, cond)

    def predict_v(self, model, x_t, t: torch.Tensor, cond, neg_cond=None,
                  cfg_strength: float = 0.0, cfg_batched: bool = False):
        """The conditional velocity, or with neg_cond the CFG velocity
        (1 + s) v_cond - s v_neg from two model calls, or with cfg_batched
        from one call on the 2B batch."""
        if neg_cond is None or cfg_strength == 0.0:
            return self._inference(model, x_t, t, cond)
        if cfg_batched:
            out = self._inference(model, torch.cat([x_t, x_t]), t,
                                  torch.cat([cond, neg_cond]))
            pred, neg = out.chunk(2)
        else:
            pred = self._inference(model, x_t, t, cond)
            neg = self._inference(model, x_t, t, neg_cond)
        return (1 + cfg_strength) * pred - cfg_strength * neg

    @torch.no_grad()
    def sample(self, model: Callable, noise: torch.Tensor, cond: Any = None,
               neg_cond: Any = None, steps: int = 50, rescale_t: float = 1.0,
               cfg_strength: float = 0.0, cfg_interval=None,
               cfg_batched: bool = False):
        """Returns dict(samples=...)."""
        ts = t_schedule(steps, rescale_t)
        use_cfg = neg_cond is not None and cfg_strength != 0.0
        lo, hi = cfg_interval if cfg_interval is not None else (-np.inf,
                                                                np.inf)
        t32 = torch.tensor(ts.astype(np.float32), device=noise.device)
        x = noise
        for i in range(steps):
            # the interval is tested on the float64 grid, as in JAX
            with_cfg = use_cfg and lo <= ts[i] <= hi
            v = self.predict_v(model, x, t32[i], cond,
                               neg_cond if with_cfg else None,
                               cfg_strength if with_cfg else 0.0, cfg_batched)
            x = x - (t32[i] - t32[i + 1]) * v
        return {"samples": x}


class FlowEulerCfgSampler(FlowEulerSampler):
    """CFG over every step."""

    def sample(self, model, noise, cond, neg_cond, steps=50, rescale_t=1.0,
               cfg_strength=3.0, cfg_batched=False, **kw):
        return super().sample(model, noise, cond, neg_cond, steps=steps,
                              rescale_t=rescale_t, cfg_strength=cfg_strength,
                              cfg_batched=cfg_batched)


class FlowEulerGuidanceIntervalSampler(FlowEulerSampler):
    """CFG inside the interval of t, the conditional call alone outside."""

    def sample(self, model, noise, cond, neg_cond, steps=50, rescale_t=1.0,
               cfg_strength=3.0, cfg_interval=(0.0, 1.0), cfg_batched=False,
               **kw):
        return super().sample(model, noise, cond, neg_cond, steps=steps,
                              rescale_t=rescale_t, cfg_strength=cfg_strength,
                              cfg_interval=cfg_interval,
                              cfg_batched=cfg_batched)
