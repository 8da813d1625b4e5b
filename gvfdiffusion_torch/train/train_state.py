"""Train state: parameters, optimizer, EMA (port of
gvfdiffusion_tpu/train/train_state.py:18-106), and `freeze_subtrees`.

The optimizer is the JAX package's optax chain, written out so that it
matches optax number for number:

  MultiSteps(grad_accum)(                       # when grad_accum > 1
      chain(clip_by_global_norm(grad_clip),
            adamw(linear_schedule(0, lr, warmup_steps),
                  b1, b2, eps=1e-8, weight_decay)))

  * MultiSteps keeps the running mean of the micro-gradients,
    acc + (g - acc) / (n + 1), and fires the inner chain on it every
    `grad_accum`-th micro-step; the other micro-steps update nothing.
  * clip_by_global_norm scales by max / ||g|| when ||g|| >= max (no 1e-6,
    unlike `torch.nn.utils.clip_grad_norm_`).
  * AdamW: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, bias
    corrections 1 - b^count with count the number of inner updates
    including this one, update mu_hat / (sqrt(nu_hat) + eps), plus
    weight_decay * p, times -lr(count), where the schedule reads the count
    of earlier inner updates: the first update uses lr = 0 under a warm-up.
  * The EMA moves every micro-step: e * rate + p * (1 - rate).

Unlike JAX's immutable pytrees, the state here is updated in place (the
parameters are the model's own, and the moments, the accumulator and the
EMA are one fp32 tensor per parameter): a full-width DiT's 105.5M parameters
need no second copy of each.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


def global_norm(tree: Tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every element, fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in tree.values()))


@dataclasses.dataclass
class OptState:
    mu: Tensors
    nu: Tensors
    acc: Optional[Tensors]  # running mean of the micro-gradients
    count: int = 0          # inner updates so far
    mini_step: int = 0      # micro-gradients in `acc`

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "acc": self.acc,
                "count": self.count, "mini_step": self.mini_step}

    def load_state_dict(self, sd: dict) -> None:
        for name in ("mu", "nu", "acc"):
            mine = getattr(self, name)
            if mine is not None:
                for k, t in mine.items():
                    t.copy_(sd[name][k])
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])


class Optimizer:
    """The optax chain above; see `make_optimizer`."""

    eps = 1e-8  # optax.adamw's default

    def __init__(self, lr: float, warmup_steps: int, weight_decay: float,
                 grad_clip: float, b1: float, b2: float, grad_accum: int):
        self.lr, self.warmup_steps = lr, warmup_steps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.b1, self.b2 = b1, b2
        self.grad_accum = grad_accum

    def init(self, params: Tensors) -> OptState:
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in params.items()}
        return OptState(mu=zeros(), nu=zeros(),
                        acc=zeros() if self.grad_accum > 1 else None)

    def learning_rate(self, count: int) -> float:
        """optax.linear_schedule(0, lr, warmup_steps) at `count`, in fp32."""
        if self.warmup_steps <= 0:
            return float(np.float32(self.lr))
        f = np.float32
        c = min(max(count, 0), self.warmup_steps)
        frac = f(1) - f(c) / f(self.warmup_steps)
        return float(f(0.0 - self.lr) * frac + f(self.lr))

    @torch.no_grad()
    def update(self, grads: Tensors, state: OptState,
               params: Tensors) -> Optional[Tensors]:
        """The updates to add to `params`, or None on a micro-step that
        fires no update; `state` moves in place."""
        if state.acc is not None:
            n = state.mini_step
            for k, g in grads.items():
                a = state.acc[k]
                a.add_((g.float() - a) / (n + 1))
            if n + 1 < self.grad_accum:
                state.mini_step = n + 1
                return None
            grads = {k: a.clone() for k, a in state.acc.items()}
            for a in state.acc.values():
                a.zero_()
            state.mini_step = 0
        # clip_by_global_norm
        g_norm = global_norm(grads)
        if not bool(g_norm < self.grad_clip):
            grads = {k: (g.float() / g_norm) * self.grad_clip
                     for k, g in grads.items()}
        # scale_by_adam, add_decayed_weights, scale_by_learning_rate
        f = np.float32
        count_inc = state.count + 1
        bc1 = float(f(1) - f(self.b1) ** f(count_inc))
        bc2 = float(f(1) - f(self.b2) ** f(count_inc))
        step_size = -1.0 * self.learning_rate(state.count)
        updates = {}
        for k, g in grads.items():
            g = g.float()
            mu, nu = state.mu[k], state.nu[k]
            mu.copy_(g * (1 - self.b1) + mu * self.b1)
            nu.copy_(g * g * (1 - self.b2) + nu * self.b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * params[k].float()
            updates[k] = u * step_size
        state.count = count_inc
        return updates


class FrozenOptimizer:
    """`freeze_subtrees`' optimizer: `tx` over the parameters outside the
    frozen prefixes (optax.multi_transform's "train" partition: the frozen
    ones take no part in the clip's norm and hold no moments), no update
    for the frozen ones (optax.set_to_zero)."""

    def __init__(self, tx: Optimizer, prefixes: tuple):
        self.tx, self.prefixes = tx, tuple(prefixes)

    def trained(self, tree: Tensors) -> Tensors:
        return {k: v for k, v in tree.items()
                if not k.startswith(self.prefixes)}

    def init(self, params: Tensors) -> OptState:
        return self.tx.init(self.trained(params))

    def update(self, grads: Tensors, state: OptState,
               params: Tensors) -> Optional[Tensors]:
        """The updates of the trained parameters (a frozen one's is 0 and
        left out), or None."""
        return self.tx.update(self.trained(grads), state,
                              self.trained(params))


def freeze_subtrees(tx: Optimizer, prefixes: tuple) -> FrozenOptimizer:
    """`tx` with zero updates for the parameters whose name starts with any
    of `prefixes` (the reference's requires_grad_(False) encoder freeze;
    JAX's top-level `enc_{i}` subtrees are the port's `encoder.{i}.`
    modules, and JAX's third argument, the tree it labels, is not needed:
    the names decide)."""
    return FrozenOptimizer(tx, prefixes)


def make_optimizer(lr: float = 5e-5, warmup_steps: int = 1000,
                   weight_decay: float = 0.0, grad_clip: float = 1.0,
                   b1: float = 0.9, b2: float = 0.999,
                   grad_accum: int = 1) -> Optimizer:
    """clip(grad_clip) -> adamw(lr with a linear warm-up), averaged over
    `grad_accum` micro-steps (the reference's train_latent.py:93-105, 188)."""
    return Optimizer(lr, warmup_steps, weight_decay, grad_clip, b1, b2,
                     grad_accum)


@dataclasses.dataclass
class TrainState:
    step: int            # micro-steps taken
    params: Tensors      # the model's own parameters
    opt_state: OptState
    ema_params: Tensors

    def state_dict(self) -> dict:
        return {"step": self.step,
                "params": {k: p.detach() for k, p in self.params.items()},
                "opt_state": self.opt_state.state_dict(),
                "ema_params": self.ema_params}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        for k, p in self.params.items():
            p.copy_(sd["params"][k])
            self.ema_params[k].copy_(sd["ema_params"][k])
        self.opt_state.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])


def create_train_state(model: torch.nn.Module, tx) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(
        step=0, params=params, opt_state=tx.init(params),
        ema_params={k: p.detach().float().clone() for k, p in params.items()})


@torch.no_grad()
def apply_updates(state: TrainState, grads: Tensors, tx,
                  ema_rate: float = 0.9999) -> TrainState:
    """One micro-step of the optimizer and the EMA, in place; returns
    `state`."""
    updates = tx.update(grads, state.opt_state, state.params)
    if updates is not None:
        for k, u in updates.items():
            state.params[k].add_(u.to(state.params[k].dtype))
    for k, e in state.ema_params.items():
        e.copy_(e * ema_rate + state.params[k].float() * (1.0 - ema_rate))
    state.step += 1
    return state
