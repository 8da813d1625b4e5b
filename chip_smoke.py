#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # build + per-kernel checks only
    python3 chip_smoke.py --profile  # build + a profiled denoise and encode

Phases, each printed on its own lines:
  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. each fused DiT sublayer kernel (K1-K4) against its plain torch version
     on the card, at the DiT's full shapes in bf16, with both times, the
     time of a library composition of the same sublayer (LayerNorm, cuBLAS
     bf16 matmuls, scaled_dot_product_attention, the residual) and the
     bound; then K5 (the attention kernel) the same way at DINOv2's
     [32 frames, 1374 tokens, 16 heads, 64] from a qkv projection, with
     scaled_dot_product_attention as its library call;
  3. one full DINOv2 ViT-L/14-reg forward (518^2, 32 frames) and one full
     12x512 DiT forward, kernels against impl="plain";
  4. the main path through the entry points, with seeded random weights:
     32 seeded frames [518, 518, 3] -> encode_video (DINOv2 tokens
     [1, 32, 1374, 1024]) -> VideoTo4DPipeline.run (FPS, KV cache, a
     32-step DPM-Solver++ denoise at guidance 1.0/1.0, the motion-VAE
     decode of 131072 Gaussians) -> render_4d (all 32 frames from one
     orbit view at 512^2), timed stage by stage and whole; the kernel
     launches of K1-K5 are counted in this run only. Then run()'s stages
     called one by one must give what run() gave, and both again for
     4 steps at guidance 2.0/5.0 (the 3-way CFG batch B*T = 96).
Then one JSON line of per-kernel results and, last, the contract line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
non-zero and no result line is printed. Without a CUDA device, or without
the repository beside this script, it exits 1.

Bounds (bound_ms) are the larger of the operations over the dense bf16
tensor-core peak and the bytes (each input read once, each output written
once) over the memory rate, at the H100 SXM datasheet's 989 TFLOP/s and
3.35 TB/s: assumed peaks, not measured on the card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# (name, TPU kernel body replaced, source, key)
KERNELS = [
    ("fused_self_sublayer", "gvfdiffusion_tpu/ops/fused_sublayer.py:170",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "self"),
    ("fused_temporal_sublayer", "gvfdiffusion_tpu/ops/fused_sublayer.py:373",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "temporal"),
    ("fused_cross_sublayer", "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross"),
    ("fused_mlp_sublayer", "gvfdiffusion_tpu/ops/fused_sublayer.py:881",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "mlp"),
    ("fused_attention", "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention"),
]
# Kernel vs plain version at the full shapes, per sublayer: (rel L2 of the
# output y, rel L2 of the update y - x). Each is 3-6x the error measured on
# an H100 80GB HBM3 (700 W) with these seeds, which four runs reproduced to
# every digit: y 6.2e-4 / 9.0e-4 / 1.0e-3 / 9.9e-5 and update 6.0e-3 /
# 7.8e-3 / 6.2e-3 / 5.1e-4 for self / temporal / cross / MLP.
BOUNDS = {"self": (3e-3, 3e-2), "temporal": (3e-3, 3e-2),
          "cross": (3e-3, 3e-2), "mlp": (5e-4, 3e-3)}
ATTN_REL_BOUND = 1e-2      # K5 output rel L2 (reading 2.3e-3)
DINO_REL_BOUND = 2e-2      # encode_image tokens, kernels vs plain (3.9e-3)
DIT_REL_BOUND = 3e-2       # rel L2 of the whole 12-block DiT output (9.6e-3)
RUN_REL_BOUND = 1e-6       # run() against the same stages called one by one
PEAK_FLOPS = 989e12        # dense bf16, H100 SXM datasheet (assumed)
PEAK_BYTES = 3.35e12       # HBM3, H100 SXM datasheet (assumed)

B, T, N, C, H, M = 1, 32, 512, 512, 16, 2048   # the DiT at full width
L_IMG = 1374               # DINOv2 tokens at 518^2: 1 + 4 registers + 37^2
G = 131072                 # Gaussians: 16384 voxels x 8
RENDER_DELTA_SCALE = 0.01  # random-weight deltas, scaled as bench.py:395


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*objs) -> int:
    """Bytes of every tensor in objs (nested tuples, lists and dicts)."""
    import torch

    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += nbytes(*o)
        elif isinstance(o, dict):
            total += nbytes(*o.values())
    return total


def bound(flops: float, moved: int):
    """(bound_ms, bound_by) at the assumed peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sublayer_cases(dev, g):
    """Inputs at the DiT's full shapes: B*T = 32 frames of N = 512 tokens,
    C = 512, 16 heads of 32, MLP 2048, image KV 1374, static KV 512."""
    import torch

    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    def w(i, o):
        return rnd(i, o, scale=i ** -0.5)

    def mod(rows):
        return rnd(rows, C, scale=0.3)

    def gam():
        return (1.0 + 0.1 * torch.randn(C, generator=g, device=dev)).to(bf) \
            * (C // H) ** 0.5

    self_w = lambda: (w(C, 3 * C), rnd(3 * C, scale=0.1), gam(), gam(),
                      w(C, C), rnd(C, scale=0.1))
    x3 = rnd(B * T, N, C)
    x4 = rnd(B, T, N, C)

    def cross_p():
        return ((1.0 + 0.1 * rnd(C)).to(bf), rnd(C, scale=0.1), w(C, C),
                rnd(C, scale=0.1), w(C, C), rnd(C, scale=0.1))

    kv_img = (rnd(B * T, L_IMG, C), rnd(B * T, L_IMG, C))
    kv_st = (rnd(B * T, N, C), rnd(B * T, N, C))
    return {
        "self": (x3, dict(args=(x3, mod(B), mod(B), mod(B), *self_w()),
                          kw=dict(num_heads=H, mod_repeat=T))),
        "temporal": (x4, dict(args=(x4, mod(B), mod(B), mod(B), *self_w()),
                              kw=dict(num_heads=H))),
        "cross": (x3, dict(args=(x3, cross_p(), kv_img, cross_p(), kv_st),
                           kw=dict(num_heads=H))),
        "mlp": (x3, dict(args=(x3, mod(B), mod(B), mod(B), w(C, M),
                               rnd(M, scale=0.1), w(M, C), rnd(C, scale=0.1)),
                         kw=dict(mod_repeat=T))),
    }


def sublayer_flops(key: str) -> float:
    R, D = B * T * N, C // H
    proj = 2 * R * C * 3 * C + 2 * R * C * C  # qkv and output projections
    if key == "self":
        return proj + 4 * B * T * H * N * N * D
    if key == "temporal":
        return proj + 4 * B * N * H * T * T * D
    if key == "cross":
        return 2 * 2 * (2 * R * C * C) + 4 * B * T * H * N * (L_IMG + N) * D
    return 2 * 2 * R * C * M


# -- library compositions of K1-K4: a yardstick timed here, never used by
# the port: F.layer_norm / modulate, cuBLAS bf16 matmuls,
# F.scaled_dot_product_attention, the residual.

def _ln_mod(x, sh, sc, rep):
    import torch.nn.functional as F

    h = F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6)
    shape = (-1,) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    sh, sc = (a.repeat_interleave(rep, 0).view(shape) for a in (sh, sc))
    return (h * (1 + sc.float()) + sh.float()).bfloat16()


def _rms(a, g):
    af = a.float()
    return (af * (af.square().sum(-1, keepdim=True) + 1e-12).rsqrt()
            * g.float().view(H, -1)).bfloat16()


def library_self(x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo, num_heads,
                 mod_repeat=1):
    import torch.nn.functional as F

    Bx, L, _ = x.shape
    qkv = (_ln_mod(x, sh, sc, mod_repeat) @ wqkv + bqkv).view(
        Bx, L, 3, H, -1)
    q, k = _rms(qkv[:, :, 0], qg), _rms(qkv[:, :, 1], kg)
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), qkv[:, :, 2].transpose(1, 2))
    out = o.transpose(1, 2).reshape(Bx, L, C) @ wo + bo
    g = gate.repeat_interleave(mod_repeat, 0)[:, None]
    return (x.float() + out.float() * g.float()).bfloat16()


def library_temporal(x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo, num_heads):
    import torch.nn.functional as F

    Bx, Tx, Nx, _ = x.shape
    qkv = (_ln_mod(x, sh, sc, 1) @ wqkv + bqkv).view(Bx, Tx, Nx, 3, H, -1)
    q, k = _rms(qkv[..., 0, :, :], qg), _rms(qkv[..., 1, :, :], kg)
    v = qkv[..., 2, :, :]
    o = F.scaled_dot_product_attention(  # [B, N, H, T, D]
        *(a.permute(0, 2, 3, 1, 4) for a in (q, k, v)))
    out = o.permute(0, 3, 1, 2, 4).reshape(Bx, Tx, Nx, C) @ wo + bo
    return (x.float() + out.float() * gate.float()[:, None, None]).bfloat16()


def library_cross(x, p1, kv1, p2, kv2, num_heads):
    import torch.nn.functional as F

    Bx, L, _ = x.shape

    def one(xf, p, kv):
        ns, nb, wq, bq, wo, bo = p
        h = F.layer_norm(xf, (C,), ns.float(), nb.float(), eps=1e-6)
        q = (h.bfloat16() @ wq + bq).view(Bx, L, H, -1).transpose(1, 2)
        k, v = (a.view(Bx, a.shape[1], H, -1).transpose(1, 2) for a in kv)
        o = F.scaled_dot_product_attention(q, k, v)
        return xf + (o.transpose(1, 2).reshape(Bx, L, C) @ wo + bo).float()

    return one(one(x.float(), p1, kv1), p2, kv2).bfloat16()


def library_mlp(x, sh, sc, gate, w1, b1, w2, b2, mod_repeat=1):
    import torch.nn.functional as F

    hid = F.gelu(_ln_mod(x, sh, sc, mod_repeat) @ w1 + b1, approximate="tanh")
    g = gate.repeat_interleave(mod_repeat, 0)[:, None]
    return (x.float() + (hid @ w2 + b2).float() * g.float()).bfloat16()


def phase_kernels(dev):
    import torch
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    fns = {"self": fsl.fused_self_sublayer,
           "temporal": fsl.fused_temporal_sublayer,
           "cross": fsl.fused_cross_sublayer, "mlp": fsl.fused_mlp_sublayer}
    libs = {"self": library_self, "temporal": library_temporal,
            "cross": library_cross, "mlp": library_mlp}
    g = torch.Generator(device=dev).manual_seed(1)
    cases = sublayer_cases(dev, g)
    results = {}
    for name, replaces, source, key in KERNELS[:4]:
        x, case = cases[key]
        fn, lib = fns[key], libs[key]
        args, kw = case["args"], case["kw"]
        y = fn(*args, **kw)
        torch.cuda.synchronize()
        ref = fn(*args, **kw, impl="plain")
        err = rel_l2(y, ref)
        upd = rel_l2(y.float() - x.float(), ref.float() - x.float())
        mae = float((y.float() - ref.float()).abs().max())
        finite = bool(torch.isfinite(y).all())
        lib_upd = rel_l2(lib(*args, **kw).float() - x.float(),
                         ref.float() - x.float())
        ms = time_ms(lambda: fn(*args, **kw))
        plain_ms = time_ms(lambda: fn(*args, **kw, impl="plain"))
        lib_ms = time_ms(lambda: lib(*args, **kw))
        b_ms, b_by = bound(sublayer_flops(key), nbytes(args, y))
        y_bound, upd_bound = BOUNDS[key]
        log(f"[kernel] {name}: shape {tuple(x.shape)} max_abs_err {mae:.4g} "
            f"rel_l2 {err:.3e} (bound {y_bound:g}) update_rel_l2 "
            f"{upd:.3e} (bound {upd_bound:g}) kernel {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms library {lib_ms:.3f} ms (its update "
            f"rel_l2 {lib_upd:.3e}) bound {b_ms:.4f} ms ({b_by})")
        if not (finite and err <= y_bound and upd <= upd_bound):
            raise AssertionError(f"{name} disagrees with its plain version")
        results[key] = dict(name=name, route="cuda", source=source,
                            replaces=replaces, max_abs_err=mae, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib_ms)
    results["attention"] = phase_attention(dev)
    return results


def phase_attention(dev):
    """K5 at DINOv2's shape, q/k/v read in place from a qkv projection."""
    import torch
    import torch.nn.functional as F
    from gvfdiffusion_torch.ops import fused_attention as fa

    name, replaces, source, _ = KERNELS[4]
    Bv, L, Hv, D = T, L_IMG, 16, 64
    g = torch.Generator(device=dev).manual_seed(8)
    qkv = torch.randn(Bv, L, 3, Hv, D, generator=g, device=dev).bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = D ** -0.5
    y = fa.fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    ref = fa.fused_attention(q, k, v, scale, impl="plain")
    err = rel_l2(y, ref)
    mae = float((y.float() - ref.float()).abs().max())
    finite = bool(torch.isfinite(y).all())
    sdpa = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    lib_err = rel_l2(sdpa().transpose(1, 2), ref)
    ms = time_ms(lambda: fa.fused_attention(q, k, v, scale))
    plain_ms = time_ms(lambda: fa.fused_attention(q, k, v, scale,
                                                  impl="plain"), iters=3)
    lib_ms = time_ms(sdpa)
    flops = 4 * Bv * Hv * L * L * D
    b_ms, b_by = bound(flops, nbytes(q, k, v, y))
    log(f"[kernel] {name}: q/k/v {tuple(q.shape)} bf16 (views of qkv "
        f"{tuple(qkv.shape)}) max_abs_err {mae:.4g} rel_l2 {err:.3e} (bound "
        f"{ATTN_REL_BOUND:g}) kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
        f"TFLOP/s) plain {plain_ms:.3f} ms sdpa {lib_ms:.3f} ms (its rel_l2 "
        f"{lib_err:.3e}) bound {b_ms:.4f} ms ({b_by})")
    if not (finite and err <= ATTN_REL_BOUND):
        raise AssertionError(f"{name} disagrees with its plain version")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=mae, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def build_models(dev):
    import torch
    from gvfdiffusion_torch.models.dinov2 import DinoV2
    from gvfdiffusion_torch.models.dit import DiT
    from gvfdiffusion_torch.models.motion_vae import MotionVAE
    from gvfdiffusion_torch.utils.weights import init_random_

    dino = init_random_(DinoV2(dtype=torch.bfloat16), seed=10).to(dev).eval()
    dit = init_random_(DiT(dtype=torch.bfloat16), seed=0).to(dev).eval()
    vae = init_random_(MotionVAE(dtype=torch.bfloat16), seed=1).to(dev).eval()
    return dino, dit, vae


def seeded_frames():
    """32 video frames [518, 518, 3] uint8, from a seed."""
    import numpy as np

    return (np.random.default_rng(9).uniform(size=(T, 518, 518, 3))
            * 255).astype(np.uint8)


def phase_dinov2(dino, dev, card):
    """The full ViT-L/14-reg forward over 32 frames, kernels vs plain, and
    the host's share of encode_video: normalizing the 32 frames."""
    import torch
    from gvfdiffusion_torch.models.dinov2 import encode_image
    from gvfdiffusion_torch.scripts.process_video import normalize_frame

    g = torch.Generator(device=dev).manual_seed(11)
    images = torch.rand(T, 518, 518, 3, generator=g, device=dev)
    tokens = encode_image(dino, images)
    torch.cuda.synchronize()
    ref = encode_image(dino, images, impl="plain")
    err = rel_l2(tokens, ref)
    ms = time_ms(lambda: encode_image(dino, images), iters=3)
    plain_ms = time_ms(lambda: encode_image(dino, images, impl="plain"),
                       iters=1)
    t0 = time.perf_counter()
    for f in seeded_frames():
        normalize_frame(f)
    host_ms = (time.perf_counter() - t0) * 1e3
    log(f"[dinov2] ViT-L/14-reg 24x1024, 16 heads of 64, 518^2, {T} frames: "
        f"tokens {tuple(tokens.shape)} kernels vs plain rel_l2 {err:.3e} "
        f"(bound {DINO_REL_BOUND:g}), max_abs_err "
        f"{float((tokens - ref).abs().max()):.4g}; encode_image {ms:.1f} ms, "
        f"plain {plain_ms:.1f} ms; normalize_frame of the {T} seeded frames "
        f"on the host {host_ms:.1f} ms; {card}")
    if tuple(tokens.shape) != (T, L_IMG, 1024) or not (
            bool(torch.isfinite(tokens).all()) and err <= DINO_REL_BOUND):
        raise AssertionError("DINOv2 disagrees with its plain version")


def phase_dit(dit, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(B, T, N, 16, generator=g, device=dev)
    t = torch.tensor([500.0], device=dev)
    ci = torch.randn(B, T, L_IMG, 1024, generator=g, device=dev)
    st = torch.randn(B, N, 14, generator=g, device=dev)
    pos = torch.rand(B, N, 3, generator=g, device=dev) - 0.5
    with torch.no_grad():
        kv = dit(x, t, ci, st, pos, kv_only=True)
        y = dit(x, t, positions=pos, cross_kv=kv)
        ref = dit(x, t, positions=pos, cross_kv=kv, impl="plain")
    torch.cuda.synchronize()
    err = rel_l2(y, ref)
    log(f"[dit] 12x512 forward [1, 32, 512, 16]: kernels vs plain rel_l2 "
        f"{err:.3e} (bound {DIT_REL_BOUND:g}), max_abs_err "
        f"{float((y - ref).abs().max()):.4g}, |ref| mean "
        f"{float(ref.abs().mean()):.4g}")
    if not (bool(torch.isfinite(y).all()) and err <= DIT_REL_BOUND):
        raise AssertionError("DiT forward disagrees with its plain version")


def canonical_splat(dev):
    """A valid activated splat [1, G, 14]: xyz in [-0.5, 0.5], scales
    0.003-0.02, unit quaternions, SH DC ~ N(0, 0.5^2), opacity in
    (0.1, 0.9); the last 1000 rows are padding (invalid, unit rotation)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(3)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    quat = torch.randn(G, 4, generator=g, device=dev)
    gs = torch.cat([u(G, 3) - 0.5, 0.003 + 0.017 * u(G, 3),
                    quat / quat.norm(dim=-1, keepdim=True),
                    0.5 * torch.randn(G, 3, generator=g, device=dev),
                    0.1 + 0.8 * u(G, 1)], -1)[None]
    valid = torch.ones(1, G, dtype=torch.bool, device=dev)
    valid[:, G - 1000:] = False
    gs[:, G - 1000:] = 0.0
    gs[:, G - 1000:, 6] = 1.0
    return gs, valid


def run_stages(pipe, gs, valid, ci, seed):
    """The steps of VideoTo4DPipeline.run, called one by one and timed."""
    import torch

    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    g = torch.Generator(device=gs.device).manual_seed(seed)
    anchors = timed("fps", lambda: pipe.prepare_static_conditioning(gs, valid))
    kv = timed("kv_cache", lambda: pipe.cross_kv(ci, anchors))
    latent = timed("denoise", lambda: pipe.sample_deformation_latent(
        ci, anchors, anchors[..., :3], generator=g, cross_kv=kv))
    deltas = timed("decode", lambda: pipe.decode_deltas(latent, gs))
    return {"latent": latent, "deltas": deltas, "anchors": anchors}, stages


def reset_counts():
    from gvfdiffusion_torch.ops import fused_attention as fa
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    fsl.reset_launch_counts()
    fa.reset_launch_counts()


def read_counts():
    from gvfdiffusion_torch.ops import fused_attention as fa
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    return {**fsl.launch_counts, **fa.launch_counts}


def main_path(dino, pipe, frames, gs, valid, seed):
    """frames -> encode_video -> run -> render_4d through the entry points,
    timed stage by stage and whole, with the kernel launch counts of this
    run alone."""
    import torch
    from gvfdiffusion_torch.representations.gaussians import from_activated
    from gvfdiffusion_torch.scripts.process_video import encode_video

    g = torch.Generator(device=gs.device).manual_seed(seed)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tokens = encode_video(frames, dino, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = pipe.run(gs, valid, tokens[None], generator=g)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    video = pipe.render_4d(from_activated(gs[0]),
                           out["deltas"][0] * RENDER_DELTA_SCALE, valid[0],
                           num_views=1, resolution=512)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = read_counts()
    stages = {"encode": (t1 - t0) * 1e3, "run": (t2 - t1) * 1e3,
              "render_4d": (t3 - t2) * 1e3, "whole": (t3 - t0) * 1e3}
    return tokens, out, video, launches, stages


def check_outputs(out, batch, frames, gaussians):
    import torch

    shapes = {"latent": (batch, frames, 512, 16),
              "deltas": (batch, frames, gaussians, 14),
              "anchors": (batch, 512, 14)}
    for k, shape in shapes.items():
        v = out[k]
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{k}: shape {tuple(v.shape)} (want {shape}), "
                                 f"finite {bool(torch.isfinite(v).all())}")
    if float(out["deltas"].abs().mean()) == 0.0:
        raise AssertionError("deltas are all zero")


def check_video(video):
    """Finite [32, 1, 512, 512, 3] frames that cover part of the image and
    differ from frame to frame."""
    import torch

    if tuple(video.shape) != (T, 1, 512, 512, 3) or not bool(
            torch.isfinite(video).all()):
        raise AssertionError(f"frames: shape {tuple(video.shape)}, finite "
                             f"{bool(torch.isfinite(video).all())}")
    # share of pixels the splat covers: those off the white background
    coverage = float((video < 1.0 - 1e-3).any(-1).float().mean())
    motion = (video[1:] - video[:-1]).abs().amax(dim=(1, 2, 3, 4))
    log(f"[main] frames {tuple(video.shape)}: finite, coverage "
        f"{coverage:.4f}, frame-to-frame max abs change min "
        f"{float(motion.min()):.4g} / max {float(motion.max()):.4g}, "
        f"mean pixel {float(video.mean()):.4f}")
    if not (coverage > 0.0 and bool((motion > 0).all())):
        raise AssertionError("the frames show no splat or do not move")


def check_same(out, staged, what):
    """run() must give what its stages give when called one by one."""
    errs = {k: rel_l2(out[k], staged[k]) for k in ("anchors", "latent",
                                                   "deltas")}
    log(f"[pipeline] {what}: run() vs staged rel_l2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bound {RUN_REL_BOUND:g})")
    if max(errs.values()) > RUN_REL_BOUND:
        raise AssertionError(f"{what}: run() disagrees with its stages")


def phase_pipeline(dino, dit, vae, dev, card):
    import torch
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)

    frames = seeded_frames()
    gs, valid = canonical_splat(dev)
    warm = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=4, order=2))
    main_path(dino, warm, frames, gs, valid, seed=4)  # warm-up

    # the main path, through the entry points: the kernel launch counts
    # are read from this run only
    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=32, order=2))
    torch.cuda.reset_peak_memory_stats()
    tokens, out, video, launches, stages = main_path(
        dino, pipe, frames, gs, valid, seed=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ci = tokens[None]
    if tuple(ci.shape) != (B, T, L_IMG, 1024) or not bool(
            torch.isfinite(ci).all()):
        raise AssertionError(f"tokens: shape {tuple(ci.shape)}")
    check_outputs(out, B, T, G)
    log(f"[main] frames [{T}, 518, 518, 3] -> encode_video -> run "
        f"(guidance 1.0/1.0, 32 steps, G={G}) -> render_4d ({T} frames, one "
        f"orbit view, 512^2, deltas x {RENDER_DELTA_SCALE:g} as bench.py "
        "scales random-weight deltas): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items())
        + f"; peak {peak:.2f} GiB; launches {launches}; {card}")
    log(f"[main] tokens {tuple(ci.shape)}, latent |mean| "
        f"{float(out['latent'].abs().mean()):.4g}, deltas |mean| "
        f"{float(out['deltas'].abs().mean()):.4g}, finite")
    check_video(video)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel")
    if launches["attention"] != 24:
        raise AssertionError(f"{launches['attention']} attention launches; "
                             "one 24-block encode makes 24")

    staged, st = run_stages(pipe, gs, valid, ci, seed=5)
    check_outputs(staged, B, T, G)
    log(f"[pipeline] guidance 1.0/1.0, 32 steps, G={G}, run()'s stages one "
        "by one: " + ", ".join(f"{k} {v:.1f} ms" for k, v in st.items())
        + f"; {card}")
    check_same(out, staged, "guidance 1.0/1.0")

    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(
        steps=4, order=2, guidance_scale=2.0, guidance_scale2=5.0))
    staged, st = run_stages(pipe, gs, valid, ci, seed=6)
    check_outputs(staged, B, T, G)
    g = torch.Generator(device=dev).manual_seed(6)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = pipe.run(gs, valid, ci, generator=g)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    cfg_launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_outputs(out, B, T, G)
    log(f"[pipeline] guidance 2.0/5.0 (3-way CFG, B*T = 96), 4 steps, stage "
        f"by stage: " + ", ".join(f"{k} {v:.1f} ms" for k, v in st.items())
        + f"; run() {wall_ms:.1f} ms; peak {peak:.2f} GiB; launches "
        f"{cfg_launches}; finite; {card}")
    check_same(out, staged, "guidance 2.0/5.0")
    return launches


def _kernel_group(name: str) -> str:
    for k in ("attn_kernel", "gemm_kernel", "ln_kernel"):
        if k in name:
            return k
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "cuBLAS GEMM"
    return "other"


def _profile(fn, what: str, trace: str, card: str) -> None:
    """torch.profiler over one call of fn (after a warm-up): device time by
    kernel group and the device's busy share of the wall time; the Chrome
    trace is written to the file `trace` of the output directory below."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, rows = {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3, e.count, e.key))
        k = _kernel_group(e.key)
        groups[k] = groups.get(k, 0.0) + us / 1e3
    busy = sum(groups.values())
    log(f"[profile] {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}% of wall); {card}")
    if busy == 0:
        raise AssertionError("the profiler saw no device time")
    for k, ms in sorted(groups.items(), key=lambda kv_: -kv_[1]):
        log(f"[profile]   {k}: {ms:.1f} ms ({100 * ms / busy:.1f}% of device)")
    for ms, n, name in sorted(rows, reverse=True)[:12]:
        log(f"[profile]   {ms:9.2f} ms  x{n:<5d} {name[:110]}")
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, trace))


def phase_profile(dino, dit, vae, dev, card):
    """Where the time goes, at full width: a 4-step denoise (guidance
    1.0/1.0, KV hoisted; trace denoise_trace.json) and the DINOv2
    encode_image of 32 frames (trace encode_trace.json)."""
    import torch
    from gvfdiffusion_torch.models.dinov2 import encode_image
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)

    gs, valid = canonical_splat(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    ci = torch.randn(B, T, L_IMG, 1024, generator=g, device=dev)
    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=4, order=2))
    anchors = pipe.prepare_static_conditioning(gs, valid)
    kv = pipe.cross_kv(ci, anchors)
    _profile(lambda: pipe.sample_deformation_latent(
        ci, anchors, anchors[..., :3], generator=g, cross_kv=kv),
        "4-step denoise (4 DiT forwards, B*T = 32)", "denoise_trace.json",
        card)
    images = torch.rand(T, 518, 518, 3, generator=g, device=dev)
    _profile(lambda: encode_image(dino, images),
             f"DINOv2 encode_image ({T} frames, 518^2)", "encode_trace.json",
             card)


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from gvfdiffusion_torch import _ext
    except ImportError:
        print("chip_smoke: gvfdiffusion_torch not found beside this script",
              file=sys.stderr)
        return 1
    quick = "--quick" in argv

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)  # as nvidia-smi prints it: name, power limit
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    t0 = time.perf_counter()
    _ext.load()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({_ext.library_path().name})")

    if "--profile" in argv:
        phase_profile(*build_models(dev), dev, card)
        return 0
    results = phase_kernels(dev)
    if quick:
        return 0
    dino, dit, vae = build_models(dev)
    phase_dinov2(dino, dev, card)
    phase_dit(dit, dev)
    launches = phase_pipeline(dino, dit, vae, dev, card)
    for key, r in results.items():
        r["launches"] = launches[key]
    log(json.dumps({"kernels": [results[k] for *_, k in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
