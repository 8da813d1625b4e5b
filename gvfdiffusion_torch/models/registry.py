"""Model registry and loading from a pretrained directory (port of
gvfdiffusion_tpu/models/registry.py).

A pretrained directory is the reference's layout:

    <root>/pipeline.json     {"name": ..., "models": {key: relpath}}
    <root>/<key>.json        {"name": registry name, "args": kwargs}
    <root>/<key>.npz         flax-flat parameters ('a/b/c' keys), or a
                             torch `.pt` / `.safetensors` state dict
                             under the reference's names (`weights` in
                             `<key>.json` names the file)

`create_model` builds the port's class of a registry name from a release
config's kwargs, translated as JAX's `_adapt_kwargs` translates them: the
torch runtime flags `use_fp16`, `use_checkpoint` and `use_skip_connection`
are dropped, `num_head_channels` becomes `num_heads`, and a Gaussian
decoder's `representation_config` becomes a `GSConfig`. Every model is
therefore built at its class's default dtype, fp32, as the JAX package
builds it. `remat_blocks`, a training memory knob, is dropped too for every
class but the two the port trains, the DiT and the static VAE. `from_pretrained` builds
the model of `<key>.json`, reads its weights with `load_params` and carries
the flax tree into the module through the class's weight table
(`WEIGHT_TABLES`, utils/weights.py; a strict load), then moves it to
`device`, "cuda" unless the caller asks for the CPU. A torch checkpoint
goes through the class's converter (utils/weight_convert.py; JAX's
`_converters`: the DiT, the motion VAE and the static VAE), called with the
structural arguments of the model's configuration; the classes JAX has no
converter for raise ValueError there, as in JAX. `flax_params` takes a
model's state dict the other way through the weight table, for
`save_params_npz`.

Not ported (ROADMAP queue 1, items 4 and 6): the registry names whose
class the port lacks (`NOT_PORTED`), each raising NotImplementedError. A
name the registry does not know raises KeyError, as in JAX.
"""

from __future__ import annotations

import inspect
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import weights
from ..utils.device import resolve_device

MODEL_REGISTRY: Dict[str, Callable] = {}
# class -> its utils/weights.py table, called with the constructor
# arguments that its own parameters name
WEIGHT_TABLES: Dict[type, Callable] = {}
# the JAX registry's names whose class the port lacks
NOT_PORTED = ("SparseStructureEncoder", "SLatEncoder",
              "SLatRadianceFieldDecoder", "SLatMeshDecoder",
              "ElasticSLatMeshDecoder", "TpuSLatMeshDecoder")
_TODO = "not ported yet (ROADMAP queue 1, items 4 and 6)"


def register(name: str):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls

    return deco


def _populate() -> None:
    from .dinov2 import DinoV2
    from .dit import DiT
    from .motion_vae import MotionVAE
    from .static_vae import SparseTransformerVAE
    from .trellis.slat_decoders import SLatGaussianDecoder
    from .trellis.slat_flow import SLatFlowModel
    from .trellis.ss_flow import SparseStructureFlowModel
    from .trellis.ss_vae import SparseStructureDecoder

    WEIGHT_TABLES.update({
        DiT: weights.dit_table, MotionVAE: weights.motion_vae_table,
        SparseTransformerVAE: weights.static_vae_table,
        SparseStructureDecoder: weights.ss_decoder_table,
        SparseStructureFlowModel: weights.ss_flow_table,
        SLatFlowModel: weights.slat_flow_table,
        SLatGaussianDecoder: weights.slat_gs_decoder_table,
        DinoV2: weights.dinov2_table,
    })
    MODEL_REGISTRY.update({
        "DiT": DiT,
        "GSKLTemporalVariationalAutoEncoder": MotionVAE,  # reference name
        "MotionVAE": MotionVAE,
        "SparseTransformerVAE": SparseTransformerVAE,
        "SparseStructureDecoder": SparseStructureDecoder,
        "SparseStructureFlowModel": SparseStructureFlowModel,
        "SLatFlowModel": SLatFlowModel,
        "SLatGaussianDecoder": SLatGaussianDecoder,
        "ElasticSLatGaussianDecoder": SLatGaussianDecoder,  # reference alias
        "DinoV2": DinoV2,
    })


def _adapt_kwargs(name: str, kwargs: Dict) -> Dict:
    """JAX's translation of reference-style constructor args onto the
    classes (see the module doc)."""
    kw = dict(kwargs)
    kw.pop("use_fp16", None)
    kw.pop("use_checkpoint", None)
    kw.pop("use_skip_connection", None)  # slat flow: always on (ref default)
    if name not in ("DiT", "SparseTransformerVAE"):
        kw.pop("remat_blocks", None)  # the port trains only these two
    if "num_head_channels" in kw:
        nhc = kw.pop("num_head_channels")
        if kw.get("num_heads") is None and kw.get("model_channels") and nhc:
            kw["num_heads"] = kw["model_channels"] // nhc
    rep = kw.pop("representation_config", None)
    if isinstance(rep, dict):
        if name in ("SLatMeshDecoder", "ElasticSLatMeshDecoder"):
            kw["use_color"] = rep.get("use_color", False)
        elif "GaussianDecoder" in name:
            from .sparse_vae import GSConfig

            kw["rep_config"] = GSConfig(
                num_gaussians=rep.get("num_gaussians", 8),
                voxel_size=rep.get("voxel_size", 1.5),
                scaling_bias=rep.get("scaling_bias", 0.004),
                opacity_bias=rep.get("opacity_bias", 0.1),
                scaling_activation=rep.get("scaling_activation", "softplus"),
                filter_3d_kernel_size=rep.get("3d_filter_kernel_size", 9e-4),
                lr_rotation=(rep.get("lr") or {}).get("_rotation", 1.0),
            )
        elif "RadianceField" in name:
            kw["rank"] = rep.get("rank", 16)
            kw["dim"] = rep.get("dim", 8)
    return kw


def _class(name: str):
    if not MODEL_REGISTRY:
        _populate()
    if name in NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is {_TODO}")
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def create_model(name: str, **kwargs) -> torch.nn.Module:
    return _class(name)(**_adapt_kwargs(name, kwargs))


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_params_npz(params: Dict, path: str) -> None:
    np.savez(path, **flatten_tree(params))


def load_params(path: str, converter: Optional[Callable] = None) -> Dict:
    """The flax parameter tree of a `.npz` checkpoint (flax-flat keys), or
    converter(state dict) of a torch `.pt` / `.safetensors` checkpoint
    (utils/weight_convert.py: the port's state dict)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return _unflatten({k: data[k] for k in data.files})
    if not path.endswith((".pt", ".safetensors")):
        raise ValueError(f"{path}: unknown checkpoint format")
    from ..utils.weight_convert import load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    if converter is None:
        raise ValueError(f"torch checkpoint {path} needs an explicit "
                         "converter")
    return converter(sd)


def _converters() -> Dict[str, Callable]:
    """JAX's `_converters`: registry name -> utils/weight_convert.py."""
    from ..utils import weight_convert as wc

    return {"DiT": wc.convert_dit, "MotionVAE": wc.convert_motion_vae,
            "GSKLTemporalVariationalAutoEncoder": wc.convert_motion_vae,
            "SparseTransformerVAE": wc.convert_static_vae}


def _config(name: str, args: Dict) -> Tuple[type, Dict[str, Any]]:
    """The class of a registry name and its constructor arguments for a
    release config's `args`, the class defaults filled in."""
    cls = _class(name)
    kw = _adapt_kwargs(name, args)
    cfg = {k: p.default for k, p in
           inspect.signature(cls.__init__).parameters.items()
           if p.default is not inspect.Parameter.empty}
    cfg.update(kw)
    return cls, cfg


def weight_table(name: str, args: Dict) -> List[weights.Row]:
    """The weight table of the model that `create_model(name, **args)`
    builds."""
    cls, cfg = _config(name, args)
    if cls not in WEIGHT_TABLES:
        raise NotImplementedError(f"no weight table for {cls.__name__}")
    table = WEIGHT_TABLES[cls]
    return table(**{k: cfg[k] for k in
                    inspect.signature(table).parameters if k in cfg})


def flax_params(name: str, args: Dict, model: torch.nn.Module) -> Dict:
    """`model`'s state dict as the flax tree ({"params": ...}) of the model
    `create_model(name, **args)` builds, for save_params_npz."""
    return weights.to_flax(weight_table(name, args), model.state_dict())


def from_pretrained(root: str, key: str, device="cuda") -> torch.nn.Module:
    """The model `key` of a pretrained directory (see the module doc),
    with its weights, on `device`, in eval mode."""
    dev = resolve_device(device)  # before any work
    with open(os.path.join(root, f"{key}.json")) as f:
        spec = json.load(f)
    name, args = spec["name"], spec.get("args", {})
    model = create_model(name, **args)
    path = os.path.join(root, spec.get("weights", f"{key}.npz"))
    if path.endswith(".npz"):
        sd = weights.from_flax(weight_table(name, args), load_params(path))
    else:
        sd = load_params(path, _converter(name, args))
    model.load_state_dict(sd)
    return model.to(dev).eval()


def _converter(name: str, args: Dict) -> Optional[Callable]:
    """The class's converter with the structural arguments of the model
    that `create_model(name, **args)` builds (None where JAX has none)."""
    conv = _converters().get(name)
    if conv is None:
        return None
    _, cfg = _config(name, args)
    kw = {k: cfg[k] for k in inspect.signature(conv).parameters
          if cfg.get(k) is not None}
    return lambda sd: conv(sd, **kw)


def load_pipeline_spec(root: str) -> Dict:
    with open(os.path.join(root, "pipeline.json")) as f:
        return json.load(f)
