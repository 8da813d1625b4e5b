"""Carry the JAX package's parameters over to the port.

`dit_state_dict_from_flax`, `motion_vae_state_dict_from_flax` and
`dinov2_state_dict_from_flax` are the inverses of `convert_dit`,
`convert_motion_vae` and `convert_dinov2` in
gvfdiffusion_tpu/utils/weight_convert.py: they take a flax parameter tree
(numpy or any array convertible with np.asarray) and return the torch state
dict under the reference's names (the torch hub's for DINOv2), which the
port's modules use. A flax Dense kernel [in, out] becomes a Linear weight
[out, in]; a Conv kernel [kh, kw, in, out] a Conv2d weight [out, in, kh, kw];
a LayerNorm scale becomes its weight.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch


@torch.no_grad()
def init_random_(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Draw every parameter from a seeded non-zero distribution, in place.

    The modules' own zero inits (adaLN, the DiT final layer, the VAE output)
    make every block the identity and every output 0, which would hide any
    fault. Linear and conv weights get N(0, 1/fan_in), fan_in the product
    of every dimension after the first (in * kh * kw for a conv); biases
    N(0, 0.1^2); LayerNorm weights, RMS gammas and layer scales 1 + N(0,
    0.1^2) (DINOv2's layer-scale init of 1e-5 would make every block nearly
    the identity); DINOv2's tokens and position embedding N(0, 1), the scale
    of the patch embedding they join. Drawn on the CPU from one
    torch.Generator, so the values do not depend on the device."""
    g = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        r = torch.randn(p.shape, generator=g, dtype=torch.float32)
        if name.endswith("gamma") or (p.ndim == 1 and name.endswith("weight")):
            r = 1.0 + 0.1 * r
        elif p.ndim == 1:
            r = 0.1 * r
        elif name.endswith(("token", "tokens", "pos_embed")):
            pass
        else:
            r = r / math.prod(p.shape[1:]) ** 0.5
        p.copy_(r)
    return module


def _node(tree: Dict, path: List[str]):
    for p in path:
        tree = tree[p]
    return tree


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd, tree, torch_name: str, path: List[str]) -> None:
    node = _node(tree, path)
    sd[f"{torch_name}.weight"] = _tensor(np.asarray(node["kernel"]).T)
    if "bias" in node:
        sd[f"{torch_name}.bias"] = _tensor(node["bias"])


def _layernorm(sd, tree, torch_name: str, path: List[str]) -> None:
    node = _node(tree, path)
    if "scale" in node:
        sd[f"{torch_name}.weight"] = _tensor(node["scale"])
    if "bias" in node:
        sd[f"{torch_name}.bias"] = _tensor(node["bias"])


def _mha(sd, tree, tname: str, path: List[str], is_self: bool) -> None:
    if is_self:
        _linear(sd, tree, f"{tname}.to_qkv", path + ["to_qkv"])
    else:
        _linear(sd, tree, f"{tname}.to_q", path + ["to_q"])
        _linear(sd, tree, f"{tname}.to_kv", path + ["to_kv"])
    _linear(sd, tree, f"{tname}.to_out", path + ["to_out"])
    node = _node(tree, path)
    for n in ("q_rms_norm", "k_rms_norm"):
        if n in node:
            sd[f"{tname}.{n}.gamma"] = _tensor(node[n]["gamma"])


def _params(params: Dict) -> Dict:
    return params["params"] if "params" in params else params


def dit_state_dict_from_flax(params: Dict[str, Any],
                             num_blocks: int = 12) -> Dict[str, torch.Tensor]:
    """JAX DiT params ({'params': ...} or the bare tree) -> the port's DiT
    state dict."""
    p = _params(params)
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, p, "input_layer", ["input_layer"])
    _linear(sd, p, "t_embedder.mlp.0", ["t_embedder", "mlp_0"])
    _linear(sd, p, "t_embedder.mlp.2", ["t_embedder", "mlp_2"])
    _linear(sd, p, "image_cond_proj", ["image_cond_proj"])
    _linear(sd, p, "static_cond_proj", ["static_cond_proj"])
    for i in range(num_blocks):
        b, fp = f"blocks.{i}", [f"blocks_{i}"]
        _linear(sd, p, f"{b}.adaLN_modulation.1", fp + ["adaLN_modulation"])
        _linear(sd, p, f"{b}.adaLN_modulation_temporal.1",
                fp + ["adaLN_modulation_temporal"])
        _layernorm(sd, p, f"{b}.norm3", fp + ["norm3"])
        _layernorm(sd, p, f"{b}.norm4", fp + ["norm4"])
        _mha(sd, p, f"{b}.spatial_self_attn", fp + ["spatial_self_attn"], True)
        _mha(sd, p, f"{b}.temporal_self_attn", fp + ["temporal_self_attn"],
             True)
        _mha(sd, p, f"{b}.image_cross_attn", fp + ["image_cross_attn"], False)
        _mha(sd, p, f"{b}.static_cross_attn", fp + ["static_cross_attn"],
             False)
        _linear(sd, p, f"{b}.mlp.mlp.0", fp + ["mlp", "mlp_0"])
        _linear(sd, p, f"{b}.mlp.mlp.2", fp + ["mlp", "mlp_2"])
    _linear(sd, p, "final_layer.adaLN_modulation.1",
            ["final_layer", "adaLN_modulation"])
    _linear(sd, p, "final_layer.linear", ["final_layer", "linear"])
    return sd


def motion_vae_state_dict_from_flax(
        params: Dict[str, Any], depth: int = 12) -> Dict[str, torch.Tensor]:
    """JAX MotionVAE params -> the port's MotionVAE state dict (the
    encoder's parameters included)."""
    p = _params(params)
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, p, "input_embedding.0", ["input_embedding"])
    _linear(sd, p, "gs_embedding.0", ["gs_embedding"])
    for n in ("to_q", "to_kv", "to_out"):
        _linear(sd, p, f"cross_attend_blocks.0.fn.{n}", ["enc_cross", n])
    _linear(sd, p, "cross_attend_blocks.1.fn.net.0", ["enc_ff", "net_0"])
    _linear(sd, p, "cross_attend_blocks.1.fn.net.2", ["enc_ff", "net_2"])
    _linear(sd, p, "mean_fc", ["mean_fc"])
    _linear(sd, p, "logvar_fc", ["logvar_fc"])
    _linear(sd, p, "proj", ["proj"])
    for i in range(depth):
        for n in ("to_q", "to_kv", "to_out"):
            _linear(sd, p, f"layers.{i}.0.fn.{n}", [f"latent_attn_{i}", n])
        _linear(sd, p, f"layers.{i}.1.fn.net.0", [f"latent_ff_{i}", "net_0"])
        _linear(sd, p, f"layers.{i}.1.fn.net.2", [f"latent_ff_{i}", "net_2"])
    for n in ("to_q", "to_kv", "to_out"):
        _linear(sd, p, f"decoder_cross_attn.fn.{n}", ["dec_cross", n])
    _linear(sd, p, "to_outputs", ["to_outputs"])
    return sd


def dinov2_state_dict_from_flax(params: Dict[str, Any],
                                depth: int = 24) -> Dict[str, torch.Tensor]:
    """JAX DinoV2 params -> the port's DinoV2 state dict, under the torch
    hub's `dinov2_vitl14_reg` names (`blocks.N.attn.qkv`,
    `blocks.N.ls1.gamma`, `patch_embed.proj`, `register_tokens`, ...)."""
    p = _params(params)
    sd: Dict[str, torch.Tensor] = {}
    for n in ("cls_token", "pos_embed", "register_tokens"):
        if n in p:
            sd[n] = _tensor(p[n])
    proj = p["patch_embed"]["proj"]
    sd["patch_embed.proj.weight"] = _tensor(
        np.transpose(np.asarray(proj["kernel"]), (3, 2, 0, 1)))
    sd["patch_embed.proj.bias"] = _tensor(proj["bias"])
    for i in range(depth):
        b, fp = f"blocks.{i}", [f"blocks_{i}"]
        _layernorm(sd, p, f"{b}.norm1", fp + ["norm1"])
        _layernorm(sd, p, f"{b}.norm2", fp + ["norm2"])
        _linear(sd, p, f"{b}.attn.qkv", fp + ["attn", "to_qkv"])
        _linear(sd, p, f"{b}.attn.proj", fp + ["attn", "to_out"])
        sd[f"{b}.ls1.gamma"] = _tensor(_node(p, fp + ["ls1_gamma"]))
        sd[f"{b}.ls2.gamma"] = _tensor(_node(p, fp + ["ls2_gamma"]))
        _linear(sd, p, f"{b}.mlp.fc1", fp + ["mlp", "fc1"])
        _linear(sd, p, f"{b}.mlp.fc2", fp + ["mlp", "fc2"])
    _layernorm(sd, p, "norm", ["norm"])
    return sd
