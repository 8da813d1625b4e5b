"""Batch matting CLI (port of gvfdiffusion_tpu/scripts/matting.py, the
reference's scripts/inference_MODNet.py:16-110 surface): a directory of
images -> `<name>_matte.png` for each, through models/modnet.py.

    python -m gvfdiffusion_torch.scripts.matting \\
        --input-path frames/ --output-path mattes/ [--ckpt-path modnet.npz] \\
        [--device cpu]

The checkpoint is the JAX package's: an `.npz` of the flax variables, one
array per '/'-joined path (`params/...` and `batch_stats/...`;
`save_params` writes one), so a tree JAX saved loads here. Without
--ckpt-path the model runs on random weights (its constructor's), with a
warning: that only exercises the plumbing. It runs on the card unless
`--device cpu` is given. Images are read and written with PIL, as in JAX.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..models import registry
from ..models.modnet import MODNet, make_matting_fn
from ..utils import weights
from ..utils.device import resolve_device


def load_params(model: MODNet, path: str) -> MODNet:
    """The flax variables of an `.npz` (flat '/'-joined keys) into `model`,
    in place (strict); returns it."""
    model.load_state_dict(weights.modnet_state_dict_from_flax(
        registry.load_params(path), model.hr_channels, model.backbone_width))
    return model


def save_params(model: MODNet, path: str) -> None:
    """`model` as JAX's `save_params` writes a flax tree: an `.npz` of the
    variables, one array per '/'-joined path."""
    registry.save_params_npz(weights.modnet_variables(
        model.state_dict(), model.hr_channels, model.backbone_width), path)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input-path", required=True)
    p.add_argument("--output-path", required=True)
    p.add_argument("--ckpt-path", default=None)
    p.add_argument("--ref-size", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="where MODNet runs (cuda, or cpu)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)  # before any work

    model = MODNet()
    if args.ckpt_path:
        load_params(model, args.ckpt_path)
    else:
        print("[matting] WARNING: no --ckpt-path; random weights")
    fn = make_matting_fn(model.to(dev), ref_size=args.ref_size)

    from PIL import Image

    os.makedirs(args.output_path, exist_ok=True)
    for name in sorted(os.listdir(args.input_path)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg", ".webp")):
            continue
        img = np.asarray(Image.open(
            os.path.join(args.input_path, name)).convert("RGB"))
        matte = fn(img)
        out = os.path.join(
            args.output_path, os.path.splitext(name)[0] + "_matte.png")
        Image.fromarray((matte * 255).astype(np.uint8)).save(out)
        print(f"[matting] {name} -> {out}")


if __name__ == "__main__":
    main()
