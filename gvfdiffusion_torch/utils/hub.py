"""The GVF release's files, found in an offline mirror, and loaded (port of
gvfdiffusion_tpu/utils/hub.py).

`MODEL_REPOS` is the reference's release map (utils/inference_utils.py:
21-34), copied verbatim. `download_model_files` resolves the release's
seven files in a local mirror laid out as the hub repository,
`<local_hub or $GVF_HUB_DIR>/<repo_id>/<filename>`; the port resolves
offline only (JAX falls back to huggingface_hub downloads: not ported, the
port needs no network), so without a mirror it raises and names the
variable to set. `load_gvf_release` parses each `.pt` state dict, strips
DDP's `module.` prefix (reference inference_dpm_latent.py:79-115), converts
each to the port's state dict (utils/weight_convert.py) and loads the
latent-normalization stats, bare tensors (:150-153), onto `device`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from .device import resolve_device

# the reference release map, verbatim (utils/inference_utils.py:21-34)
MODEL_REPOS = {
    "GVFDiffusion_v1.0": {
        "repo_id": "BwZhang/GaussianVariationFieldDiffusion",
        "revision": "main",
        "model_path": "ema_diffusion_0.9999_500000.pt",
        "vae_path": "ema_deformation_0.9999_200000.pt",
        "static_vae_path": "ema_static_vae_0.9999_200000.pt",
        "static_mean_path": "static_mean.pt",
        "static_std_path": "static_std.pt",
        "deformation_mean_path": "deformation_mean.pt",
        "deformation_std_path": "deformation_std.pt",
        "assets_dir": "assets",
    }
}

_FILE_KEYS = {
    "ckpt": "model_path",
    "vae_ckpt": "vae_path",
    "static_vae_ckpt": "static_vae_path",
    "static_mean": "static_mean_path",
    "static_std": "static_std_path",
    "deformation_mean": "deformation_mean_path",
    "deformation_std": "deformation_std_path",
}


def download_model_files(model_name: str,
                         local_hub: Optional[str] = None) -> Dict[str, str]:
    """The release's seven files as local paths, from the mirror
    `local_hub` (else $GVF_HUB_DIR): {"ckpt", "vae_ckpt",
    "static_vae_ckpt", "static_mean", "static_std", "deformation_mean",
    "deformation_std"}. An unknown name raises ValueError, a missing file
    or mirror FileNotFoundError."""
    if model_name not in MODEL_REPOS:
        raise ValueError(
            f"Unknown model name: {model_name}. "
            f"Available models: {list(MODEL_REPOS)}")
    info = MODEL_REPOS[model_name]
    local_hub = local_hub or os.environ.get("GVF_HUB_DIR")
    if not local_hub:
        raise FileNotFoundError(
            f"no offline mirror of {info['repo_id']!r}: pass local_hub or "
            "set GVF_HUB_DIR to a directory holding <repo_id>/<filename> "
            "(the port does not download)")
    repo_dir = os.path.join(local_hub, info["repo_id"])
    out: Dict[str, str] = {}
    for key, pkey in _FILE_KEYS.items():
        path = os.path.join(repo_dir, info[pkey])
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"offline hub mirror {repo_dir!r} is missing "
                f"{info[pkey]!r} (for {key})")
        out[key] = path
    return out


def load_stat_tensor(path: str) -> torch.Tensor:
    """A mean / std file, a bare torch tensor -> fp32 on the CPU."""
    t = torch.load(path, map_location="cpu", weights_only=False)
    return torch.as_tensor(t).to(torch.float32)


def load_gvf_release(files: Dict[str, str], *, dit_kwargs: Dict,
                     vae_kwargs: Dict, static_vae_kwargs: Dict,
                     device="cuda") -> Dict[str, object]:
    """The release's files (download_model_files) -> {"dit", "motion_vae",
    "static_vae": the port's state dicts; "static_mean", "static_std",
    "deformation_mean", "deformation_std": fp32 tensors}, on `device` (the
    card unless the caller asks for the CPU). *_kwargs are the converters'
    structural arguments (num_blocks, depth, ...), which the reference's
    launch script fixes in its config."""
    from . import weight_convert as wc

    dev = resolve_device(device)
    sds = {
        "dit": wc.convert_dit(wc.load_torch_checkpoint(files["ckpt"]),
                              **dit_kwargs),
        "motion_vae": wc.convert_motion_vae(
            wc.load_torch_checkpoint(files["vae_ckpt"]), **vae_kwargs),
        "static_vae": wc.convert_static_vae(
            wc.load_torch_checkpoint(files["static_vae_ckpt"]),
            **static_vae_kwargs),
    }
    out: Dict[str, object] = {k: {n: v.to(dev) for n, v in sd.items()}
                              for k, sd in sds.items()}
    for key in ("static_mean", "static_std", "deformation_mean",
                "deformation_std"):
        out[key] = load_stat_tensor(files[key]).to(dev)
    return out
