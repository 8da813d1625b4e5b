#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # build + per-kernel checks only
    python3 chip_smoke.py --profile  # build + a profiled 4-step denoise

Phases, each printed on its own lines:
  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. each fused DiT sublayer kernel (K1-K4) against its plain torch version
     on the card, at the DiT's full shapes in bf16, with both times;
  3. one full 12x512 DiT forward, kernels against impl="plain";
  4. the pipeline at full width with seeded random weights: FPS, KV cache,
     a 32-step DPM-Solver++ denoise at guidance 1.0/1.0, and the motion-VAE
     decode of 131072 Gaussians, timed stage by stage; then the same through
     VideoTo4DPipeline.run, the public entry point, whose kernel launches are
     counted and whose outputs must equal the staged ones; then both again
     for 4 steps at guidance 2.0/5.0 (the 3-way CFG batch B*T = 96).
Then one JSON line of per-kernel results and, last, the contract line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
non-zero and no result line is printed. Without a CUDA device, or without
the repository beside this script, it exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# (name, TPU kernel body replaced, sublayer wrapper)
KERNELS = [
    ("fused_self_sublayer", "gvfdiffusion_tpu/ops/fused_sublayer.py:170", "self"),
    ("fused_temporal_sublayer", "gvfdiffusion_tpu/ops/fused_sublayer.py:373",
     "temporal"),
    ("fused_cross_sublayer", "gvfdiffusion_tpu/ops/fused_sublayer.py:589", "cross"),
    ("fused_mlp_sublayer", "gvfdiffusion_tpu/ops/fused_sublayer.py:881", "mlp"),
]
SOURCE = "gvfdiffusion_torch/csrc/fused_sublayer.cu"
# Kernel vs plain version at the full shapes, per sublayer: (rel L2 of the
# output y, rel L2 of the update y - x). Each is 3-6x the error measured on
# an H100 80GB HBM3 (700 W) with these seeds, which four runs reproduced to
# every digit: y 6.2e-4 / 9.0e-4 / 1.0e-3 / 9.9e-5 and update 6.0e-3 /
# 7.8e-3 / 6.2e-3 / 5.1e-4 for self / temporal / cross / MLP.
BOUNDS = {"self": (3e-3, 3e-2), "temporal": (3e-3, 3e-2),
          "cross": (3e-3, 3e-2), "mlp": (5e-4, 3e-3)}
DIT_REL_BOUND = 3e-2       # rel L2 of the whole 12-block DiT output (9.6e-3)
RUN_REL_BOUND = 1e-6       # run() against the same stages called one by one


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


def sublayer_cases(dev, g):
    """Inputs at the DiT's full shapes: B*T = 32 frames of N = 512 tokens,
    C = 512, 16 heads of 32, MLP 2048, image KV 1370, static KV 512."""
    import torch

    B, T, N, C, H, M = 1, 32, 512, 512, 16, 2048
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

    kv_img = (rnd(B * T, 1370, C), rnd(B * T, 1370, C))
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


def phase_kernels(dev):
    import torch
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    fns = {"self": fsl.fused_self_sublayer,
           "temporal": fsl.fused_temporal_sublayer,
           "cross": fsl.fused_cross_sublayer, "mlp": fsl.fused_mlp_sublayer}
    g = torch.Generator(device=dev).manual_seed(1)
    cases = sublayer_cases(dev, g)
    results = {}
    for name, replaces, key in KERNELS:
        x, case = cases[key]
        fn = fns[key]
        y = fn(*case["args"], **case["kw"])
        torch.cuda.synchronize()
        ref = fn(*case["args"], **case["kw"], impl="plain")
        err = rel_l2(y, ref)
        upd = rel_l2(y.float() - x.float(), ref.float() - x.float())
        mae = float((y.float() - ref.float()).abs().max())
        finite = bool(torch.isfinite(y).all())
        ms = time_ms(lambda: fn(*case["args"], **case["kw"]))
        plain_ms = time_ms(lambda: fn(*case["args"], **case["kw"], impl="plain"))
        y_bound, upd_bound = BOUNDS[key]
        log(f"[kernel] {name}: shape {tuple(x.shape)} max_abs_err {mae:.4g} "
            f"rel_l2 {err:.3e} (bound {y_bound:g}) update_rel_l2 "
            f"{upd:.3e} (bound {upd_bound:g}) kernel {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms")
        if not (finite and err <= y_bound and upd <= upd_bound):
            raise AssertionError(f"{name} disagrees with its plain version")
        results[key] = dict(name=name, route="cuda", source=SOURCE,
                            replaces=replaces, max_abs_err=mae, ms=ms,
                            plain_ms=plain_ms)
    return results


def build_models(dev):
    import torch
    from gvfdiffusion_torch.models.dit import DiT
    from gvfdiffusion_torch.models.motion_vae import MotionVAE
    from gvfdiffusion_torch.utils.weights import init_random_

    dit = init_random_(DiT(dtype=torch.bfloat16), seed=0).to(dev).eval()
    vae = init_random_(MotionVAE(dtype=torch.bfloat16), seed=1).to(dev).eval()
    return dit, vae


def phase_dit(dit, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(2)
    B, T, N = 1, 32, 512
    x = torch.randn(B, T, N, 16, generator=g, device=dev)
    t = torch.tensor([500.0], device=dev)
    ci = torch.randn(B, T, 1370, 1024, generator=g, device=dev)
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


def pipeline_inputs(dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(3)
    B, T, G, L = 1, 32, 131072, 1370  # G: 16384 voxels x 8 Gaussians
    gs = torch.randn(B, G, 14, generator=g, device=dev)
    gs[..., :3] = torch.rand(B, G, 3, generator=g, device=dev) - 0.5
    valid = torch.ones(B, G, dtype=torch.bool, device=dev)
    valid[:, G - 1000:] = False  # a padded tail, as pad_static_gs leaves
    cond_images = torch.randn(B, T, L, 1024, generator=g, device=dev)
    return gs, valid, cond_images


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


def run_entry_point(pipe, gs, valid, ci, seed):
    """VideoTo4DPipeline.run itself, with its launch counts and wall time."""
    import torch
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    g = torch.Generator(device=gs.device).manual_seed(seed)
    torch.cuda.synchronize()
    fsl.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe.run(gs, valid, ci, generator=g)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return out, dict(fsl.launch_counts), wall_ms


def check_outputs(out, B, T, G):
    import torch

    shapes = {"latent": (B, T, 512, 16), "deltas": (B, T, G, 14),
              "anchors": (B, 512, 14)}
    for k, shape in shapes.items():
        v = out[k]
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{k}: shape {tuple(v.shape)} (want {shape}), "
                                 f"finite {bool(torch.isfinite(v).all())}")
    if float(out["deltas"].abs().mean()) == 0.0:
        raise AssertionError("deltas are all zero")


def check_same(out, staged, what):
    """run() must give what its stages give when called one by one."""
    errs = {k: rel_l2(out[k], staged[k]) for k in ("anchors", "latent",
                                                   "deltas")}
    log(f"[pipeline] {what}: run() vs staged rel_l2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bound {RUN_REL_BOUND:g})")
    if max(errs.values()) > RUN_REL_BOUND:
        raise AssertionError(f"{what}: run() disagrees with its stages")


def phase_pipeline(dit, vae, dev, card):
    import torch
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)

    gs, valid, ci = pipeline_inputs(dev)
    B, T, G = 1, 32, gs.shape[1]
    warm = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=4, order=2))
    run_stages(warm, gs, valid, ci, seed=4)

    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=32, order=2))
    staged, stages = run_stages(pipe, gs, valid, ci, seed=5)
    check_outputs(staged, B, T, G)
    log(f"[pipeline] guidance 1.0/1.0, 32 steps, G={G}, stage by stage: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items())
        + f"; {card}")

    # the main path, through the public entry point: the kernel launch
    # counts are read from this run only
    torch.cuda.reset_peak_memory_stats()
    out, launches, wall_ms = run_entry_point(pipe, gs, valid, ci, seed=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_outputs(out, B, T, G)
    log(f"[pipeline] guidance 1.0/1.0, 32 steps: run() {wall_ms:.1f} ms; "
        f"peak {peak:.2f} GiB; launches {launches}; {card}")
    log(f"[pipeline] latent |mean| {float(out['latent'].abs().mean()):.4g}, "
        f"deltas |mean| {float(out['deltas'].abs().mean()):.4g}, finite")
    check_same(out, staged, "guidance 1.0/1.0")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel")

    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(
        steps=4, order=2, guidance_scale=2.0, guidance_scale2=5.0))
    staged, stages = run_stages(pipe, gs, valid, ci, seed=6)
    check_outputs(staged, B, T, G)
    torch.cuda.reset_peak_memory_stats()
    out, cfg_launches, wall_ms = run_entry_point(pipe, gs, valid, ci, seed=6)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_outputs(out, B, T, G)
    log(f"[pipeline] guidance 2.0/5.0 (3-way CFG, B*T = 96), 4 steps, stage "
        f"by stage: " + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items())
        + f"; run() {wall_ms:.1f} ms; peak {peak:.2f} GiB; launches "
        f"{cfg_launches}; finite; {card}")
    check_same(out, staged, "guidance 2.0/5.0")
    return launches


def _kernel_group(name: str) -> str:
    for k in ("attn_kernel", "gemm_kernel", "ln_kernel"):
        if k in name:
            return k
    return "other"


def phase_profile(dit, vae, dev, card):
    """Where the denoise time goes: torch.profiler over a 4-step denoise at
    full width (guidance 1.0/1.0, KV hoisted), device time by kernel and
    the device's busy share of the wall time. The trace goes to
    chiprun_out/denoise_trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)

    gs, valid, ci = pipeline_inputs(dev)
    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=4, order=2))
    anchors = pipe.prepare_static_conditioning(gs, valid)
    kv = pipe.cross_kv(ci, anchors)
    g = torch.Generator(device=dev).manual_seed(7)

    def denoise():
        return pipe.sample_deformation_latent(ci, anchors, anchors[..., :3],
                                              generator=g, cross_kv=kv)

    denoise()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        denoise()
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
    log(f"[profile] 4-step denoise (4 DiT forwards, B*T = 32): wall "
        f"{wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}% of wall); {card}")
    if busy == 0:
        raise AssertionError("the profiler saw no device time")
    for k, ms in sorted(groups.items(), key=lambda kv_: -kv_[1]):
        log(f"[profile]   {k}: {ms:.1f} ms ({100 * ms / busy:.1f}% of device)")
    for ms, n, name in sorted(rows, reverse=True)[:12]:
        log(f"[profile]   {ms:9.2f} ms  x{n:<5d} {name[:110]}")
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "denoise_trace.json"))


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
    dit, vae = build_models(dev)
    phase_dit(dit, dev)
    launches = phase_pipeline(dit, vae, dev, card)
    for key, r in results.items():
        r["launches"] = launches[key]
    log(json.dumps({"kernels": [results[k] for _, _, k in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
