#!/usr/bin/env python3
"""Times K7's wide kernels, the forward (with its residual, and without it
as encode_latent calls it) and the backward's dkv and dq, on one CUDA
card, for one or several checkouts of the package in turn, beside SDPA's
forward and backward and the bounds.

    python3 wide_bwd_timing.py [--root DIR ...] [--form bfloat16:192 ...]
                               [--iters 10]

The inputs are chip_smoke.py's `[wide-heads]` ones: the static VAE's full
attention at [2, 32768, 768 / D, D], q, k and v the views of one seeded
projection, the two surface shells of `vae_valid` (15721 + 12219 valid
keys), dO seeded; the encode form one object's [1, 32768, 768 / D, D]
(batch row 0: 15721 valid keys); by default the forms (bf16, fp32) x
(192, 768). Each root (a checkout holding gvfdiffusion_torch, e.g. a
parent commit unpacked beside this one; default: this checkout) runs in a
process of its own, one after the other, so that one call times several
versions on the same card: per form `launch_forward` with the residual
and without it on the one object, `launch_dkv` and `launch_dq` (the
wrapper's calls, zeroed outputs included), each `iters` times after 2
warm-ups (CUDA events), and SDPA's forward (both shapes) and backward
under the boolean key mask (2 calls after 1 warm-up). The bounds count
the valid keys' products (forward 4, dkv 8, dq 6 B H Lq Nv D operations;
in fp32 three tf32 products each) at the datasheet's peaks, as
chip_smoke.py does.

Prints the card's name and power limit, one JSON line per root, then a
table of the times. Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FORMS = ("bfloat16:192", "bfloat16:768", "float32:192", "float32:768")


def measure(root: str, forms, iters: int) -> dict:
    """{form: {fwd, enc, dkv, dq, sdpa_fwd, sdpa_enc, sdpa_bwd, bound_fwd,
    bound_enc, bound_dkv, bound_dq, lanes, cluster}} for the package under
    `root` (ms)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import torch.nn.functional as F
    from gvfdiffusion_torch.ops import flash_attention as fl

    sys.path.insert(1, HERE)
    import chip_smoke as cs

    dev = torch.device("cuda:0")
    valid = cs.vae_valid(dev)
    qk_units = sum(cs.SLOTS * int(n) * cs.VAE_C for n in valid.sum(1))
    enc_units = cs.SLOTS * int(valid[0].sum()) * cs.VAE_C
    out = {}
    for form in forms:
        dt_name, D = form.split(":")
        dtype, D = getattr(torch, dt_name), int(D)
        H, scale, f32 = cs.VAE_C // D, D ** -0.5, dtype == torch.float32
        g = torch.Generator(device=dev).manual_seed(31 + D)
        qkv = torch.randn(cs.VAE_B, cs.SLOTS, 3, H, D, generator=g,
                          device=dev).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.randn(cs.VAE_B, cs.SLOTS, H, D, generator=g,
                         device=dev).to(dtype)
        fwd = cs.time_ms(lambda: fl.launch_forward(
            q, k, v, valid, scale, residual=True, width=D), iters=iters)
        one = [t_[:1] for t_ in (q, k, v, valid)]
        enc = cs.time_ms(lambda: fl.launch_forward(
            *one[:3], one[3], scale, residual=False, width=D), iters=iters)
        o, lse, tiles, vld = fl.launch_forward(q, k, v, valid, scale,
                                                residual=True, width=D)
        ptrs, sizes, keep = fl.backward_inputs(q, k, v, vld, tiles, lse, o,
                                               do)
        dkv = cs.time_ms(lambda: fl.launch_dkv(ptrs, sizes, scale, dtype, D),
                         iters=iters)
        dq = cs.time_ms(lambda: fl.launch_dq(ptrs, sizes, scale, dtype, D),
                        iters=iters)
        t = [a.detach().transpose(1, 2).requires_grad_(True)
             for a in (q, k, v)]
        mask = valid[:, None, None, :]
        sdpa_fwd = cs.time_ms(lambda: F.scaled_dot_product_attention(
            *t, attn_mask=mask).detach(), iters=2, warm=1)
        sdpa_enc = cs.time_ms(lambda: F.scaled_dot_product_attention(
            *(a[:1] for a in t), attn_mask=mask[:1]).detach(), iters=2,
            warm=1)
        lib_o = F.scaled_dot_product_attention(*t, attn_mask=mask)
        sdpa = cs.time_ms(lambda: torch.autograd.grad(
            lib_o, t, do.transpose(1, 2), retain_graph=True), iters=2,
            warm=1)
        ops, peak = (3, cs.PEAK_TF32) if f32 else (1, cs.PEAK_FLOPS)
        b_fwd = cs.bound(ops * 4 * qk_units, cs.nbytes(q, k, v, valid, o,
                                                       lse), peak)[0]
        b_enc = cs.bound(ops * 4 * enc_units, cs.nbytes(*one, o[:1]),
                         peak)[0]
        b_dkv = cs.bound(ops * 8 * qk_units, cs.nbytes(
            q, k, v, valid, lse, do, q, q), peak)[0]
        b_dq = cs.bound(ops * 6 * qk_units, cs.nbytes(q, k, v, valid, lse,
                                                      do, q), peak)[0]
        # a checkout before the backward's clusters: a CTA per 64-lane
        # chunk
        split = getattr(fl, "wide_split", None)
        lanes, cluster = split(D) if split else (64, None)
        out[form] = dict(fwd=fwd, enc=enc, dkv=dkv, dq=dq,
                         sdpa_fwd=sdpa_fwd, sdpa_enc=sdpa_enc,
                         sdpa_bwd=sdpa, bound_fwd=b_fwd, bound_enc=b_enc,
                         bound_dkv=b_dkv, bound_dq=b_dq, lanes=lanes,
                         cluster=cluster)
        del qkv, q, k, v, do, o, lse, tiles, vld, keep, t, lib_o, one
        torch.cuda.empty_cache()
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append",
                    help="checkout whose gvfdiffusion_torch is timed "
                         "(repeatable; default: this one)")
    ap.add_argument("--form", action="append",
                    help="dtype:width, e.g. float32:768 (repeatable)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("wide_bwd_timing: no CUDA device", file=sys.stderr)
        return 1
    forms = args.form or list(FORMS)
    roots = args.root or [HERE]
    if args.child:
        print(json.dumps(measure(roots[0], forms, args.iters)))
        return 0
    print(card())
    runs = []
    for root in roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--child",
               "--root", root, "--iters", str(args.iters)]
        for f in forms:
            cmd += ["--form", f]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        runs.append((root, json.loads(res.stdout.strip().splitlines()[-1])))
        print(json.dumps({"root": os.path.abspath(root), **runs[-1][1]}))
    for form in forms:
        print(f"{form}:")
        for root, r in runs:
            x = r[form]
            print(f"  {root}: forward with residual {x['fwd']:.3f} ms "
                  f"(bound {x['bound_fwd']:.4f}; SDPA's forward "
                  f"{x['sdpa_fwd']:.3f}), encode {x['enc']:.3f} ms (bound "
                  f"{x['bound_enc']:.4f}; SDPA's {x['sdpa_enc']:.3f})")
            print(f"  {root}: dkv {x['dkv']:.3f} ms (bound "
                  f"{x['bound_dkv']:.4f}), dq {x['dq']:.3f} ms (bound "
                  f"{x['bound_dq']:.4f}), dkv + dq "
                  f"{x['dkv'] + x['dq']:.3f} ms; SDPA's backward "
                  f"{x['sdpa_bwd']:.3f} ms; " + (
                      f"{x['lanes']} lanes x {x['cluster']} CTAs a cluster"
                      if x["cluster"] else "a CTA per 64-lane chunk"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
