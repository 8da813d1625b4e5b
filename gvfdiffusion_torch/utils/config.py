"""Configuration: a dataclass tree, a YAML overlay and `--a.b=c` overrides
(the port's own copy of gvfdiffusion_tpu/utils/config.py:16-205).

`read_yaml` reads the repository's configs (`configs/*.yml`) without
PyYAML: mappings of at most two levels whose leaves are scalars (numbers,
booleans, null, plain or quoted strings) or flow lists of scalars, with
`#` comments. Anything else raises a ValueError naming the line, rather
than being dropped.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class DiTConfig:
    resolution: int = 512
    in_channels: int = 16
    model_channels: int = 512
    static_cond_channels: int = 14
    image_cond_channels: int = 1024
    out_channels: int = 16
    num_blocks: int = 12
    num_heads: int = 16
    mlp_ratio: float = 4.0
    pe_mode: str = "ape"
    qk_rms_norm: bool = True
    no_temporal_attn: bool = False
    share_mod: bool = False
    remat_blocks: int = 0


@dataclasses.dataclass
class DiffusionConfig:
    steps: int = 1000
    noise_schedule: str = "cosine"
    predict_type: str = "v"     # eps | x0 | v | xprev
    var_type: str = "fixed_small"
    rescale_timesteps: bool = True
    timestep_respacing: str = ""
    min_snr: bool = False


@dataclasses.dataclass
class MotionVAEConfig:
    depth: int = 12
    dim: int = 768
    queries_dim: int = 768
    output_dim: int = 14
    num_inputs: int = 8192
    num_latents: int = 512
    latent_dim: int = 16
    heads: int = 12
    knn_k: int = 8
    beta: float = 7.0


@dataclasses.dataclass
class StaticVAEConfig:
    resolution: int = 64
    in_channels: int = 1024
    model_channels: int = 768
    out_channels: int = 112
    latent_channels: int = 8
    num_blocks: int = 12
    num_heads: int = 12
    window_size: int = 8
    attn_mode: str = "swin"
    norm_output: bool = True
    remat_blocks: int = 0
    # padded active-voxel capacity for the sparse batches this VAE consumes
    voxel_capacity: int = 32768


@dataclasses.dataclass
class TrainConfig:
    lr: float = 5e-5
    static_lr_scale: float = 0.1
    weight_decay: float = 0.0
    warmup_steps: int = 1000
    grad_clip: float = 1.0
    batch_size: int = 2
    grad_accum: int = 2
    ema_rate: float = 0.9999
    total_steps: int = 500000
    static_vae_steps: int = 150000
    log_interval: int = 100
    save_interval: int = 10000
    uncond_p: float = 0.1
    sample_timesteps: int = 24
    mem_ratio: float = 1.0
    seed: int = 0
    # torch static-VAE checkpoint to initialize from (reference
    # main_vae.py:31-47): out_layer is dropped on shape mismatch and the
    # encoder is frozen unless finetune_encoder is set.
    static_vae_init: str = ""
    finetune_encoder: bool = False


@dataclasses.dataclass
class LossConfig:
    """VAE render-loss weights (reference train_vae.py:207-215, 328-334)."""

    lambda_render: float = 1.0
    lambda_ssim: float = 0.2
    lambda_lpips: float = 0.2
    lambda_kl: float = 1e-6
    lambda_xyz: float = 1.0
    # path to converted LPIPS weights (ops/lpips.convert_torch_lpips npz);
    # empty + lambda_lpips > 0 is a hard error in main_vae — the perceptual
    # term must never silently vanish
    lpips_weights: str = ""


@dataclasses.dataclass
class RenderConfig:
    near: float = 0.8
    far: float = 1.6
    bg_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    resolution: int = 512
    use_mip: bool = True
    kernel_size_2d: float = 0.1
    ssaa: int = 1
    backend: str = "binned"
    max_per_tile: int = 256


@dataclasses.dataclass
class Config:
    model: DiTConfig = dataclasses.field(default_factory=DiTConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    motion_vae: MotionVAEConfig = dataclasses.field(default_factory=MotionVAEConfig)
    static_vae: StaticVAEConfig = dataclasses.field(default_factory=StaticVAEConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    data_dir: str = ""
    exp_dir: str = "gvf_exp"  # relative to the working directory
    uncond_p: float = 0.1


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, (tuple, list)):
        parts = json.loads(value) if value.startswith("[") else value.split(",")
        return type(current)(type(current[0])(p) for p in parts) if current else parts
    return value


def apply_overrides(cfg: Any, overrides: Dict[str, Any]) -> Any:
    """Apply {'a.b.c': v} dotted overrides to a (nested) dataclass, returning
    a new instance."""
    updates: Dict[str, Any] = {}
    grouped: Dict[str, Dict[str, Any]] = {}
    for key, val in overrides.items():
        if "." in key:
            head, rest = key.split(".", 1)
            grouped.setdefault(head, {})[rest] = val
        else:
            current = getattr(cfg, key)
            if dataclasses.is_dataclass(current) and isinstance(val, dict):
                grouped.setdefault(key, {}).update(
                    {k: v for k, v in val.items()}
                )
            else:
                updates[key] = (
                    _coerce(val, current) if isinstance(val, str) else val
                )
    for head, sub in grouped.items():
        updates[head] = apply_overrides(getattr(cfg, head), sub)
    return dataclasses.replace(cfg, **updates)


_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+|[0-9]+)([eE][-+]?[0-9]+)?$")
_WORDS = {"true": True, "yes": True, "on": True, "false": False,
          "no": False, "off": False, "null": None, "~": None}


def _scalar(text: str, where: str) -> Any:
    """A YAML plain or quoted scalar, or a flow list of them."""
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_scalar(p, where) for p in inner.split(",")] if inner else []
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text.lower() in _WORDS:
        return _WORDS[text.lower()]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text) and any(c in text for c in ".eE"):
        return float(text)
    if not text or text[0] in "[]{}&*!|>%@`" or ": " in text:
        raise ValueError(f"{where}: unsupported YAML value {text!r}")
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_yaml(path: str) -> Dict[str, Any]:
    """A two-level YAML mapping as nested dicts (see the module doc)."""
    out: Dict[str, Any] = {}
    section: Optional[Dict[str, Any]] = None
    indent = None
    with open(path) as f:
        for n, raw in enumerate(f, 1):
            where = f"{path}:{n}"
            line = _strip_comment(raw.rstrip("\n")).rstrip()
            if not line.strip():
                continue
            if "\t" in line[:len(line) - len(line.lstrip())]:
                raise ValueError(f"{where}: tab indentation")
            depth = len(line) - len(line.lstrip())
            key, sep, value = line.strip().partition(":")
            if not sep or not key or (value and not value.startswith(" ")):
                raise ValueError(f"{where}: expected 'key: value', got "
                                 f"{line.strip()!r}")
            key, value = key.strip(), value.strip()
            if depth == 0:
                if value:
                    out[key] = _scalar(value, where)
                    section = None
                else:
                    section = out[key] = {}
                    indent = None
                continue
            if section is None or (indent is not None and depth != indent):
                raise ValueError(f"{where}: unsupported nesting")
            indent = depth
            if not value:
                raise ValueError(f"{where}: mappings deeper than two levels "
                                 "are not supported")
            section[key] = _scalar(value, where)
    return out


def write_yaml(data: Dict[str, Any], path: str) -> None:
    """A mapping of at most two levels whose leaves are scalars (or flow
    lists of them) as YAML that `read_yaml` reads back."""
    def scalar(v: Any) -> str:
        if isinstance(v, bool):
            return "true" if v else "false"
        if v is None:
            return "null"
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(scalar(a) for a in v) + "]"
        return json.dumps(v) if isinstance(v, str) else repr(v)

    lines = []
    for key, value in data.items():
        if isinstance(value, dict):
            lines.append(f"{key}:")
            lines += [f"  {k}: {scalar(v)}" for k, v in value.items()]
        else:
            lines.append(f"{key}: {scalar(value)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_config(
    yaml_path: Optional[str] = None, cli_args: Optional[Sequence[str]] = None
) -> Config:
    """Config() <- YAML overlay <- `--a.b=c` CLI overrides."""
    cfg = Config()
    if yaml_path:
        cfg = apply_overrides(cfg, read_yaml(yaml_path))
    if cli_args:
        kv = {}
        for a in cli_args:
            if a.startswith("--") and "=" in a:
                k, v = a[2:].split("=", 1)
                kv[k] = v
        cfg = apply_overrides(cfg, kv)
    return cfg


def load_yaml(path: str) -> Dict[str, Any]:
    """JAX's `load_yaml`: the YAML file as a dict ({} when empty), read by
    `read_yaml`."""
    return read_yaml(path) or {}


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
