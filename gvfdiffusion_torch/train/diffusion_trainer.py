"""Diffusion (DiT) training step (port of gvfdiffusion_tpu/train/
diffusion_trainer.py:22-67): q-sample -> DiT (the composed path, no hoisted
KV) -> MSE against the configured target -> clip -> AdamW with a warm-up
-> EMA, on one device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..diffusion.gaussian_diffusion import GaussianDiffusion
from ..diffusion.resample import uniform_sampler
from .train_state import Optimizer, TrainState, apply_updates, global_norm


def loss_and_grads(model: torch.nn.Module, diffusion: GaussianDiffusion,
                   batch: Dict[str, torch.Tensor], t: torch.Tensor,
                   noise: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   impl: Optional[str] = None):
    """(loss, terms, grads) of the weighted training loss at timesteps t
    with the given noise; grads maps each parameter name to its gradient.

    batch: latent [B, T, N, C] (x_start), cond_images [B, T, L, Ci],
    static_latent [B, Ns, Cs], positions [B, N, 3]."""
    def model_fn(x, tt):
        return model(x, tt, cond_images=batch["cond_images"],
                     static_latent=batch["static_latent"],
                     positions=batch.get("positions"), impl=impl)

    terms, _ = diffusion.training_losses(model_fn, batch["latent"], t,
                                         noise=noise)
    loss = terms["loss"] if weights is None else terms["loss"] * weights
    loss = loss.mean()
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, params, grads)}
    return loss.detach(), {k: v.detach() for k, v in terms.items()}, grads


def make_train_step(model: torch.nn.Module, diffusion: GaussianDiffusion,
                    tx: Optimizer, ema_rate: float = 0.9999) -> Callable:
    """`train_step(state, batch, generator, *, t=None, noise=None,
    impl=None) -> (state, metrics)`: timesteps and noise are drawn from
    `generator` unless given; metrics are the loss, the mean MSE and the
    micro-step's gradient norm before clipping, as JAX reports them. The
    state moves in place."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator, *,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   impl: Optional[str] = None):
        x_start = batch["latent"]
        B = x_start.shape[0]
        if t is None:
            t, weights = uniform_sampler(generator, B,
                                         diffusion.num_timesteps,
                                         x_start.device)
        else:
            weights = torch.ones(B, device=x_start.device)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                device=generator.device,
                                dtype=x_start.dtype).to(x_start.device)
        loss, terms, grads = loss_and_grads(model, diffusion, batch, t, noise,
                                            weights, impl)
        gnorm = global_norm(grads)
        state = apply_updates(state, grads, tx, ema_rate)
        metrics = {"loss": loss, "mse": terms["mse"].mean(),
                   "grad_norm": gnorm}
        return state, metrics

    return train_step
