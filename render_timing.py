"""Times the port's renderer where it draws many views, on one CUDA card.

    python3 render_timing.py [--root DIR] [--repeats 5]

Two workloads, both through bench.py's inference rasterizer
(RenderOptions(rounds=2, early_exit=True, tile=64, max_per_tile=128)) on a
seeded splat of 131072 Gaussians (the one chip_smoke.py's frames phase
draws): `alignment_360`, align_gaussian_to_canonical over 360 angles
against the splat's own render at 137 degrees (72 views at 128^2 on the
65536 most opaque Gaussians, 9 around the best, then 5 at 512^2 on all),
and `render_24f`, a 24-frame one-view sweep at 512^2 (render_sweep with
deltas of 0.01 x N(0, 1)). Each is run once to warm up, then `repeats`
times; prints the card and one JSON line of the times in ms.

`--root` imports gvfdiffusion_torch from another checkout (for example a
parent commit unpacked beside this one), so that one script times two
versions of the package in the same session.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

G = 131072


def seeded_splat(dev):
    """[G, 14] activated: xyz in [-0.5, 0.5], scales 0.003-0.02, unit
    quaternions, SH DC ~ N(0, 0.5^2), opacity in (0.1, 0.9); the last 1000
    rows invalid."""
    import torch

    g = torch.Generator(device=dev).manual_seed(3)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    quat = torch.randn(G, 4, generator=g, device=dev)
    gs = torch.cat([u(G, 3) - 0.5, 0.003 + 0.017 * u(G, 3),
                    quat / quat.norm(dim=-1, keepdim=True),
                    0.5 * torch.randn(G, 3, generator=g, device=dev),
                    0.1 + 0.8 * u(G, 1)], -1)
    valid = torch.ones(G, dtype=torch.bool, device=dev)
    valid[G - 1000:] = False
    return gs, valid


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose gvfdiffusion_torch is timed")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("render_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from gvfdiffusion_torch.render.renderer import (GaussianRenderer,
                                                    RenderOptions)
    from gvfdiffusion_torch.representations.camera import orbit_camera
    from gvfdiffusion_torch.representations.gaussians import from_activated
    from gvfdiffusion_torch.utils.inference_utils import (
        align_gaussian_to_canonical, render_sweep, rotate_gaussians_z)

    dev = torch.device("cuda:0")
    renderer = GaussianRenderer(RenderOptions(
        near=0.1, far=10.0, bg_color=(1.0, 1.0, 1.0), use_mip=True,
        backend="binned", max_per_tile=128, rounds=2, early_exit=True,
        tile=64))
    act, valid = seeded_splat(dev)
    gs = from_activated(act)
    shown = renderer.render(rotate_gaussians_z(gs, math.radians(137.0)),
                            orbit_camera(0.0, 0.0, height=512, width=512),
                            valid=valid)
    deltas = 0.01 * torch.randn(24, G, 14, device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(4))
    work = {
        "alignment_360": lambda: align_gaussian_to_canonical(
            gs, shown["render"], shown["alpha"], valid=valid, n_angles=360,
            renderer=renderer)[1],
        "render_24f": lambda: render_sweep(
            renderer, gs, deltas, valid, num_views=1, resolution=512,
            pitch_deg=0.0),
    }
    times, found = {}, None
    for key, fn in work.items():
        out = fn()  # warm-up
        if key == "alignment_360":
            found = math.degrees(out)
        ms = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        times[key] = {"median_ms": statistics.median(ms), "ms": ms}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "found_deg": found, **times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
