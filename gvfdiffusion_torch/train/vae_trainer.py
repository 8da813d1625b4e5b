"""Two-phase VAE training steps (port of gvfdiffusion_tpu/train/
vae_trainer.py).

Phase A (`make_static_vae_step`): voxel features -> SparseTransformerVAE
(posterior sampled) -> Gaussians (`to_representation`) -> one render per
(sample, view) -> L1 + SSIM (+ LPIPS) + KL + volume / opacity
regularizers -> clip -> AdamW -> EMA.
Phase B (`make_joint_vae_step`): the static VAE and the motion VAE
together: the static renders, per-frame renders of the Gaussians moved by
the motion VAE's deltas (gradients reach both VAEs), the KNN
interpolation loss on the deltas' xyz and both KLs; one optimizer and one
EMA per VAE.

Each step draws its posterior noise from a torch.Generator, or takes it
(`noise=`, `motion_noise=`), so that a test can hand both packages the
same draws. The states move in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.sparse_vae import (GSConfig, kl_loss, regularization_losses,
                                 to_representation)
from ..ops.knn import interpolate_deltas
from ..ops.ssim import ssim
from ..render.renderer import GaussianRenderer, RenderOptions
from ..representations.camera import Camera
from .train_state import TrainState, apply_updates, global_norm


def render_loss(rendered: torch.Tensor, target: torch.Tensor,
                lambda_ssim: float = 0.2, lpips_fn: Optional[Callable] = None,
                lambda_lpips: float = 0.2,
                loss_type: str = "l1") -> Dict[str, torch.Tensor]:
    """[V, H, W, 3] renders against targets -> dict(render_rec, ssim,
    lpips where asked, loss)."""
    terms = {}
    if loss_type == "l1":
        terms["render_rec"] = (rendered - target).abs().mean()
    else:
        terms["render_rec"] = ((rendered - target) ** 2).mean()
    loss = terms["render_rec"]
    if lambda_ssim > 0:
        terms["ssim"] = 1.0 - ssim(rendered, target)
        loss = loss + lambda_ssim * terms["ssim"]
    if lpips_fn is not None and lambda_lpips > 0:
        terms["lpips"] = lpips_fn(rendered, target).mean()
        loss = loss + lambda_lpips * terms["lpips"]
    terms["loss"] = loss
    return terms


def _render(renderer: GaussianRenderer, gs, valid, extrinsics, intrinsics,
            height: int, width: int, deltas=None, frame_idx=None):
    """One render per (b, v) of the batch's cameras [B, V, 4, 4] / [B, V,
    3, 3] -> [B, V, H, W, 3]; with deltas [B, T, G, 14], view v of sample b
    takes frame frame_idx[b, v]'s."""
    B, V = extrinsics.shape[:2]
    rows = []
    for b in range(B):
        gs_b = gs.select(b)
        views = []
        for v in range(V):
            cam = Camera(world_view=extrinsics[b, v],
                         intrinsics=intrinsics[b, v], height=height,
                         width=width)
            delta = None if deltas is None else deltas[b, frame_idx[b, v]]
            views.append(renderer.render(gs_b, cam, delta=delta,
                                         valid=valid[b])["render"])
        rows.append(torch.stack(views))
    return torch.stack(rows)


def _grads(loss: torch.Tensor, module: torch.nn.Module,
           more: Optional[torch.nn.Module] = None):
    """{name: gradient} of each module's parameters (0 where unused)."""
    mods = [module] + ([more] if more is not None else [])
    named = [list(m.named_parameters()) for m in mods]
    flat = [p for n in named for _, p in n]
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    out, i = [], 0
    for n in named:
        d = {}
        for name, p in n:
            d[name] = torch.zeros_like(p) if gs[i] is None else gs[i]
            i += 1
        out.append(d)
    return out


def make_static_vae_step(vae, tx, gs_config: GSConfig = GSConfig(),
                         render_options: Optional[RenderOptions] = None,
                         lambda_ssim: float = 0.2, lambda_lpips: float = 0.2,
                         lambda_kl: float = 1e-6, lambda_vol: float = 10000.0,
                         lambda_opacity: float = 0.001,
                         lpips_fn: Optional[Callable] = None,
                         ema_rate: float = 0.9999):
    """`train_step(state, batch, generator=None, *, noise=None, impl=None)
    -> (state, terms, rendered [B, V, H, W, 3])`. batch: feats
    (SparseVoxels), images [B, V, H, W, 3], extrinsics [B, V, 4, 4],
    intrinsics [B, V, 3, 3]. `noise` [B, L, latent] replaces the posterior
    draw; `impl` reaches the VAE's attention."""
    renderer = GaussianRenderer(render_options or RenderOptions())

    def loss_and_grads(batch, generator=None, noise=None, impl=None):
        feats, images = batch["feats"], batch["images"]
        B, V, H, W, _ = images.shape
        out, mean, logvar = vae(feats, True, generator, noise, impl)
        gs, valid = to_representation(out, gs_config)
        rendered = _render(renderer, gs, valid, batch["extrinsics"],
                           batch["intrinsics"], H, W)
        terms = render_loss(rendered.reshape(B * V, H, W, 3),
                            images.reshape(B * V, H, W, 3), lambda_ssim,
                            lpips_fn, lambda_lpips)
        kl = kl_loss(mean, logvar, feats.valid)
        reg = regularization_losses(gs, valid, lambda_vol, lambda_opacity)
        loss = terms["loss"] + lambda_kl * kl + reg["loss"]
        terms.update(kl=kl, reg_vol=reg["reg_vol"],
                     reg_opacity=reg["reg_opacity"], loss=loss)
        grads, = _grads(loss, vae)
        return ({k: v.detach() for k, v in terms.items()}, rendered.detach(),
                grads)

    def train_step(state: TrainState, batch, generator=None, *, noise=None,
                   impl=None):
        terms, rendered, grads = loss_and_grads(batch, generator, noise, impl)
        terms["grad_norm"] = global_norm(grads)
        return apply_updates(state, grads, tx, ema_rate), terms, rendered

    train_step.loss_and_grads = loss_and_grads
    return train_step


def make_joint_vae_step(static_vae, motion_vae, static_tx, motion_tx,
                        gs_config: GSConfig = GSConfig(),
                        render_options: Optional[RenderOptions] = None,
                        lambda_ssim: float = 0.2, lambda_lpips: float = 0.2,
                        lambda_kl: float = 1e-6, lambda_xyz: float = 1.0,
                        knn_k: int = 8, beta: float = 7.0,
                        lpips_fn: Optional[Callable] = None,
                        ema_rate: float = 0.9999):
    """`train_step(static_state, motion_state, batch, generator=None, *,
    noise=None, motion_noise=None, impl=None) -> (static_state,
    motion_state, terms)`. batch: phase A's, plus static_pc [B, N, 3],
    delta_pc [B, T, N, 3], frame_images [B, T', H, W, 3],
    frame_extrinsics, frame_intrinsics and frame_idx [B, T'] (the frame
    each render shows). `motion_noise` [B*T, L, latent] replaces the motion
    posterior's draw."""
    renderer = GaussianRenderer(render_options or RenderOptions())

    def train_step(static_state: TrainState, motion_state: TrainState,
                   batch, generator=None, *, noise=None, motion_noise=None,
                   impl=None):
        feats, images = batch["feats"], batch["images"]
        B, V, H, W, _ = images.shape
        Tr = batch["frame_images"].shape[1]
        out, mean, logvar = static_vae(feats, True, generator, noise, impl)
        gs, valid = to_representation(out, gs_config)
        static_tensor = gs.to_activated_tensor()
        motion_out = motion_vae(static_tensor, valid, batch["static_pc"],
                                batch["delta_pc"], generator, motion_noise)
        deltas = motion_out["logits"]  # [B, T, G, 14]
        est = interpolate_deltas(static_tensor[..., :3], batch["static_pc"],
                                 batch["delta_pc"], k=knn_k, beta=beta)
        interp = ((deltas[..., :3] - est).abs()
                  * valid[:, None, :, None]).mean()
        static_rendered = _render(renderer, gs, valid, batch["extrinsics"],
                                  batch["intrinsics"], H, W)
        rl_static = render_loss(static_rendered.reshape(B * V, H, W, 3),
                                images.reshape(B * V, H, W, 3), lambda_ssim,
                                lpips_fn, lambda_lpips)
        frames = _render(renderer, gs, valid, batch["frame_extrinsics"],
                         batch["frame_intrinsics"], H, W, deltas,
                         batch["frame_idx"])
        rl_frames = render_loss(frames.reshape(B * Tr, H, W, 3),
                                batch["frame_images"].reshape(B * Tr, H, W, 3),
                                lambda_ssim, lpips_fn, lambda_lpips)
        kl_static = kl_loss(mean, logvar, feats.valid)
        kl_motion = motion_out["kl"].mean()
        loss = (rl_static["loss"] + rl_frames["loss"] + lambda_xyz * interp
                + lambda_kl * (kl_static + kl_motion))
        terms = {"loss": loss, "static_render": rl_static["render_rec"],
                 "frame_render": rl_frames["render_rec"], "interp": interp,
                 "kl_static": kl_static, "kl_motion": kl_motion}
        terms = {k: v.detach() for k, v in terms.items()}
        g_static, g_motion = _grads(loss, static_vae, motion_vae)
        terms["grad_norm_static"] = global_norm(g_static)
        terms["grad_norm_motion"] = global_norm(g_motion)
        static_state = apply_updates(static_state, g_static, static_tx,
                                     ema_rate)
        motion_state = apply_updates(motion_state, g_motion, motion_tx,
                                     ema_rate)
        return static_state, motion_state, terms

    return train_step
