"""Carry the JAX package's parameters over to the port.

The `*_state_dict_from_flax` functions are the inverses of the
`convert_*` functions of gvfdiffusion_tpu/utils/weight_convert.py (DiT,
motion VAE, DINOv2, and TRELLIS's sparse-structure flow and decoder, SLat
flow and SLat Gaussian decoder): they take a flax parameter tree (numpy or
any array convertible with np.asarray) and return the torch state dict
under the reference's names (the torch hub's for DINOv2), which the port's
modules use. A flax Dense kernel [in, out] becomes a Linear weight
[out, in]; a Conv kernel [kh, kw, (kd,) in, out] a Conv weight
[out, in, kh, kw, (kd)]; a sparse conv kernel [k^3, in, out] spconv's
[out, k, k, k, in]; a LayerNorm scale becomes its weight.
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
        elif name.endswith(("token", "tokens", "pos_embed", "pos_embedder")):
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
    state dict. The tree says the configuration: q/k RMS gammas where an
    attention has them, a top-level `adaLN_modulation` under share_mod
    (the blocks then have none), temporal modules unless
    no_temporal_attn, and the learnable position embedding `pos_emb`
    [1, N, C] as `pos_embedder`."""
    p = _params(params)
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, p, "input_layer", ["input_layer"])
    _linear(sd, p, "t_embedder.mlp.0", ["t_embedder", "mlp_0"])
    _linear(sd, p, "t_embedder.mlp.2", ["t_embedder", "mlp_2"])
    _linear(sd, p, "image_cond_proj", ["image_cond_proj"])
    _linear(sd, p, "static_cond_proj", ["static_cond_proj"])
    if "adaLN_modulation" in p:
        _linear(sd, p, "adaLN_modulation.1", ["adaLN_modulation"])
    if "pos_emb" in p:
        sd["pos_embedder"] = _tensor(p["pos_emb"])
    for i in range(num_blocks):
        b, fp = f"blocks.{i}", [f"blocks_{i}"]
        for n in ("adaLN_modulation", "adaLN_modulation_temporal"):
            if n in p[fp[0]]:
                _linear(sd, p, f"{b}.{n}.1", fp + [n])
        _layernorm(sd, p, f"{b}.norm3", fp + ["norm3"])
        _layernorm(sd, p, f"{b}.norm4", fp + ["norm4"])
        _mha(sd, p, f"{b}.spatial_self_attn", fp + ["spatial_self_attn"], True)
        if "temporal_self_attn" in p[fp[0]]:
            _mha(sd, p, f"{b}.temporal_self_attn",
                 fp + ["temporal_self_attn"], True)
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


# -- TRELLIS ------------------------------------------------------------------


def _perm(p3: int, channels: int) -> np.ndarray:
    """JAX patch feature offset * C + c -> the reference's c * p3 + offset."""
    return np.asarray([c * p3 + off for off in range(p3)
                       for c in range(channels)])


def ss_flow_state_dict_from_flax(params: Dict[str, Any], num_blocks: int = 24,
                                 in_channels: int = 8, out_channels: int = 8,
                                 patch_size: int = 2) -> Dict[str, torch.Tensor]:
    """Inverse of `convert_ss_flow`: JAX SparseStructureFlowModel params ->
    the reference's (and the port's) state dict; the patch features of the
    two projections go back to the reference's channel-major order."""
    p = _params(params)
    sd: Dict[str, torch.Tensor] = {}
    p3 = patch_size ** 3
    k = np.asarray(p["input_layer"]["kernel"])
    w = np.zeros_like(k)
    w[_perm(p3, in_channels)] = k
    sd["input_layer.weight"] = _tensor(w.T)
    sd["input_layer.bias"] = _tensor(p["input_layer"]["bias"])
    _linear(sd, p, "t_embedder.mlp.0", ["t_embedder", "mlp_0"])
    _linear(sd, p, "t_embedder.mlp.2", ["t_embedder", "mlp_2"])
    for i in range(num_blocks):
        b, fp = f"blocks.{i}", [f"blocks_{i}"]
        _linear(sd, p, f"{b}.adaLN_modulation.1", fp + ["adaLN_modulation"])
        _layernorm(sd, p, f"{b}.norm2", fp + ["norm2"])
        _mha(sd, p, f"{b}.self_attn", fp + ["self_attn"], True)
        _mha(sd, p, f"{b}.cross_attn", fp + ["cross_attn"], False)
        _linear(sd, p, f"{b}.mlp.mlp.0", fp + ["mlp", "mlp_0"])
        _linear(sd, p, f"{b}.mlp.mlp.2", fp + ["mlp", "mlp_2"])
    perm = _perm(p3, out_channels)
    k = np.asarray(p["out_layer"]["kernel"])
    w = np.zeros_like(k)
    w[:, perm] = k
    bias = np.zeros(k.shape[1], np.float32)
    bias[perm] = np.asarray(p["out_layer"]["bias"])
    sd["out_layer.weight"] = _tensor(w.T)
    sd["out_layer.bias"] = _tensor(bias)
    return sd


def _conv3d(sd, tree, torch_name: str, path: List[str], out_perm=None):
    """flax Conv kernel [k, k, k, I, O] -> torch Conv3d weight [O, I, k, k, k]
    (output channels moved back by out_perm, as convert_ss_decoder moved
    them)."""
    node = _node(tree, path)
    w, b = np.asarray(node["kernel"]), np.asarray(node["bias"])
    if out_perm is not None:
        w2, b2 = np.zeros_like(w), np.zeros_like(b)
        w2[..., out_perm], b2[out_perm] = w, b
        w, b = w2, b2
    sd[f"{torch_name}.weight"] = _tensor(np.transpose(w, (4, 3, 0, 1, 2)))
    sd[f"{torch_name}.bias"] = _tensor(b)


def ss_decoder_state_dict_from_flax(params: Dict[str, Any],
                                    channels=(512, 128, 32),
                                    num_res_blocks: int = 2,
                                    num_res_blocks_middle: int = 2
                                    ) -> Dict[str, torch.Tensor]:
    """Inverse of `convert_ss_decoder`."""
    p = _params(params)
    sd: Dict[str, torch.Tensor] = {}

    def res(tname, fp):
        _layernorm(sd, p, f"{tname}.norm1", fp + ["norm1"])
        _layernorm(sd, p, f"{tname}.norm2", fp + ["norm2"])
        _conv3d(sd, p, f"{tname}.conv1", fp + ["conv1"])
        _conv3d(sd, p, f"{tname}.conv2", fp + ["conv2"])
        if "skip_connection" in _node(p, fp):
            _conv3d(sd, p, f"{tname}.skip_connection", fp + ["skip_connection"])

    _conv3d(sd, p, "input_layer", ["input_layer"])
    for j in range(num_res_blocks_middle):
        res(f"middle_block.{j}", [f"middle_{j}"])
    bi = 0
    for i, _ in enumerate(channels):
        for j in range(num_res_blocks):
            res(f"blocks.{bi}", [f"block_{i}_{j}"])
            bi += 1
        if i < len(channels) - 1:
            _conv3d(sd, p, f"blocks.{bi}.conv", [f"up_{i}", "conv"],
                    out_perm=_perm(8, channels[i + 1]))
            bi += 1
    _layernorm(sd, p, "out_layer.0", ["out_norm"])
    _conv3d(sd, p, "out_layer.2", ["out_layer"])
    return sd


def _spconv(sd, tree, torch_name: str, path: List[str]) -> None:
    """flax SparseConv3d kernel [K^3, I, O] -> spconv [O, k, k, k, I]."""
    node = _node(tree, path)
    w = np.asarray(node["kernel"])
    k = round(w.shape[0] ** (1 / 3))
    w = w.reshape(k, k, k, w.shape[1], w.shape[2])
    sd[f"{torch_name}.weight"] = _tensor(np.transpose(w, (4, 0, 1, 2, 3)))
    sd[f"{torch_name}.bias"] = _tensor(node["bias"])


def _slat_res_block(sd, p, b: str, fp: List[str]) -> None:
    _layernorm(sd, p, f"{b}.norm1", fp + ["norm1", "LayerNorm_0"])
    _spconv(sd, p, f"{b}.conv1.conv", fp + ["conv1"])
    _spconv(sd, p, f"{b}.conv2.conv", fp + ["conv2"])
    _linear(sd, p, f"{b}.emb_layers.1", fp + ["emb_layers"])
    if "skip_connection" in _node(p, fp):
        _linear(sd, p, f"{b}.skip_connection",
                fp + ["skip_connection", "Dense_0"])


def slat_flow_state_dict_from_flax(params: Dict[str, Any],
                                   num_blocks: int = 24,
                                   io_block_channels=(128,),
                                   num_io_res_blocks: int = 2
                                   ) -> Dict[str, torch.Tensor]:
    """Inverse of `convert_slat_flow`."""
    p = _params(params)
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, p, "input_layer", ["input_layer", "Dense_0"])
    _linear(sd, p, "t_embedder.mlp.0", ["t_embedder", "mlp_0"])
    _linear(sd, p, "t_embedder.mlp.2", ["t_embedder", "mlp_2"])
    n_io = len(io_block_channels) * num_io_res_blocks
    for i in range(n_io):
        _slat_res_block(sd, p, f"input_blocks.{i}", [f"input_blocks_{i}"])
        _slat_res_block(sd, p, f"out_blocks.{i}", [f"out_blocks_{i}"])
    for i in range(num_blocks):
        b, fp = f"blocks.{i}", [f"blocks_{i}"]
        _linear(sd, p, f"{b}.adaLN_modulation.1", fp + ["adaLN_modulation"])
        _layernorm(sd, p, f"{b}.norm2", fp + ["norm2", "LayerNorm_0"])
        _mha(sd, p, f"{b}.self_attn", fp + ["self_attn"], True)
        _mha(sd, p, f"{b}.cross_attn", fp + ["cross_attn"], False)
        _linear(sd, p, f"{b}.mlp.mlp.0", fp + ["mlp", "mlp_0", "Dense_0"])
        _linear(sd, p, f"{b}.mlp.mlp.2", fp + ["mlp", "mlp_2", "Dense_0"])
    _linear(sd, p, "out_layer", ["out_layer", "Dense_0"])
    return sd


def slat_gs_decoder_state_dict_from_flax(params: Dict[str, Any],
                                         num_blocks: int = 12
                                         ) -> Dict[str, torch.Tensor]:
    """Inverse of `convert_slat_gs_decoder` (the JAX `torso` prefix goes)."""
    p = _params(params)
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, p, "input_layer", ["torso", "input_layer", "Dense_0"])
    for i in range(num_blocks):
        b, fp = f"blocks.{i}", ["torso", f"blocks_{i}"]
        _mha(sd, p, f"{b}.attn", fp + ["attn"], True)
        _linear(sd, p, f"{b}.mlp.mlp.0", fp + ["mlp", "mlp_0", "Dense_0"])
        _linear(sd, p, f"{b}.mlp.mlp.2", fp + ["mlp", "mlp_2", "Dense_0"])
    _linear(sd, p, "out_layer", ["out_layer", "Dense_0"])
    return sd
