"""Carry parameters between the JAX package's flax trees and the port.

Each model has one table (`*_table`, from the configuration that fixes its
parameter count) of (torch name, flax path, transform) rows, one per
parameter, and both directions read it:
  * `from_flax`: a flax tree -> the torch state dict under the reference's
    names (the torch hub's for DINOv2), which the port's modules use; the
    inverse of gvfdiffusion_tpu/utils/weight_convert.py's `convert_*`;
  * `to_flax`: a state dict -> {"params": tree}, what `convert_*` gives
    (models/registry.save_params_npz writes it as a pretrained
    directory's `.npz`).
A row applies where its source holds the parameter, so the tree (or the
state dict) says the optional parts: q/k RMS gammas, share_mod's top-level
`adaLN_modulation`, skip projections, the DiT's temporal modules. A flax
Dense kernel [in, out] is a Linear weight [out, in]; a Conv kernel [kh, kw,
(kd,) in, out] a Conv weight [out, in, kh, kw, (kd)]; a sparse conv kernel
[k^3, in, out] spconv's [out, k, k, k, in]; a LayerNorm scale its weight;
the sparse-structure flow's patch features and the decoder's pixel shuffle
go between the reference's channel-major and the JAX package's
offset-major order. `*_state_dict_from_flax` read a model's table flax ->
torch.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

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


# -- rows and transforms ------------------------------------------------------


class Transform(NamedTuple):
    """A parameter's layout change, flax -> torch, and its inverse."""
    to_torch: Callable[[np.ndarray], np.ndarray]
    to_flax: Callable[[np.ndarray], np.ndarray]


Row = Tuple[str, Tuple[str, ...], Transform]

SAME = Transform(lambda a: a, lambda a: a)
DENSE = Transform(lambda a: a.T, lambda a: a.T)  # [in, out] <-> [out, in]


def _axes(to_torch: Tuple[int, ...]) -> Transform:
    inv = tuple(int(i) for i in np.argsort(to_torch))
    return Transform(lambda a: np.transpose(a, to_torch),
                     lambda a: np.transpose(a, inv))


CONV1D = _axes((2, 1, 0))        # [k, I, O] <-> [O, I, k]
CONV2D = _axes((3, 2, 0, 1))     # [kh, kw, I, O] <-> [O, I, kh, kw]
CONV3D = _axes((4, 3, 0, 1, 2))  # [k, k, k, I, O] <-> [O, I, k, k, k]


def _spconv_to_torch(a: np.ndarray) -> np.ndarray:
    k = round(a.shape[0] ** (1 / 3))
    return np.transpose(a.reshape(k, k, k, *a.shape[1:]), (4, 0, 1, 2, 3))


def _spconv_to_flax(w: np.ndarray) -> np.ndarray:
    o, k0, k1, k2, i = w.shape
    return np.transpose(w, (1, 2, 3, 4, 0)).reshape(k0 * k1 * k2, i, o)


SPCONV = Transform(_spconv_to_torch, _spconv_to_flax)  # [k^3, I, O]


def _perm(p3: int, channels: int) -> np.ndarray:
    """The reference's feature c * p3 + offset at JAX's offset * C + c."""
    return np.asarray([c * p3 + off for off in range(p3)
                       for c in range(channels)])


def _permuted(perm: np.ndarray, axis: int, base: Transform) -> Transform:
    """`base`, the flax array's `axis` in JAX's order (`perm` of the
    reference's)."""
    inv = np.argsort(perm)
    return Transform(lambda a: base.to_torch(np.take(a, inv, axis)),
                     lambda w: np.take(base.to_flax(w), perm, axis))


def _pair(t: str, f: Sequence[str], tf: Transform, w: str) -> List[Row]:
    """A layer's weight (flax `w`, through tf) and bias."""
    f = tuple(f)
    return [(f"{t}.weight", f + (w,), tf), (f"{t}.bias", f + ("bias",), SAME)]


def _dense(t: str, f: Sequence[str]) -> List[Row]:
    return _pair(t, f, DENSE, "kernel")


def _norm(t: str, f: Sequence[str]) -> List[Row]:
    return _pair(t, f, SAME, "scale")


def _conv(t: str, f: Sequence[str], tf: Transform = CONV3D) -> List[Row]:
    return _pair(t, f, tf, "kernel")


def _mha(t: str, f: Sequence[str], is_self: bool) -> List[Row]:
    """An attention's projections and q/k RMS gammas."""
    f = list(f)
    rows = (_dense(f"{t}.to_qkv", f + ["to_qkv"]) if is_self else
            _dense(f"{t}.to_q", f + ["to_q"])
            + _dense(f"{t}.to_kv", f + ["to_kv"]))
    rows += _dense(f"{t}.to_out", f + ["to_out"])
    return rows + [(f"{t}.{n}.gamma", tuple(f + [n, "gamma"]), SAME)
                   for n in ("q_rms_norm", "k_rms_norm")]


# -- the two directions -------------------------------------------------------


def _get(tree, path: Tuple[str, ...]):
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def from_flax(table: List[Row], params: Dict[str, Any]
              ) -> Dict[str, torch.Tensor]:
    """A flax tree ({'params': ...} or the bare tree; numpy or any array
    np.asarray takes) -> the torch state dict: the rows whose flax path
    the tree holds."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for name, path, tf in table:
        a = _get(p, path)
        if a is not None:
            sd[name] = torch.from_numpy(np.array(
                tf.to_torch(np.asarray(a, np.float32)), dtype=np.float32))
    return sd


def to_flax(table: List[Row], state_dict: Dict[str, Any]) -> Dict:
    """A state dict -> {"params": tree}: the rows whose torch name it
    holds."""
    tree: Dict = {}
    for name, path, tf in table:
        if name not in state_dict:
            continue
        v = state_dict[name]
        # a copy: the tree must not alias the module's parameters
        a = np.array(v.detach().float().cpu() if hasattr(v, "detach")
                     else v)
        node = tree
        for q in path[:-1]:
            node = node.setdefault(q, {})
        node[path[-1]] = tf.to_flax(a)
    return {"params": tree}


# -- one table per model ------------------------------------------------------


def dit_table(num_blocks: int = 12) -> List[Row]:
    """The DiT: a top-level `adaLN_modulation` under share_mod (the blocks
    then have none), temporal modules unless no_temporal_attn, the
    learnable position embedding `pos_emb` [1, N, C] as `pos_embedder`."""
    rows = (_dense("input_layer", ["input_layer"])
            + _dense("t_embedder.mlp.0", ["t_embedder", "mlp_0"])
            + _dense("t_embedder.mlp.2", ["t_embedder", "mlp_2"])
            + _dense("image_cond_proj", ["image_cond_proj"])
            + _dense("static_cond_proj", ["static_cond_proj"])
            + _dense("adaLN_modulation.1", ["adaLN_modulation"])
            + [("pos_embedder", ("pos_emb",), SAME)])
    for i in range(num_blocks):
        b, f = f"blocks.{i}", [f"blocks_{i}"]
        for n in ("adaLN_modulation", "adaLN_modulation_temporal"):
            rows += _dense(f"{b}.{n}.1", f + [n])
        rows += _norm(f"{b}.norm3", f + ["norm3"])
        rows += _norm(f"{b}.norm4", f + ["norm4"])
        for n, is_self in (("spatial_self_attn", True),
                           ("temporal_self_attn", True),
                           ("image_cross_attn", False),
                           ("static_cross_attn", False)):
            rows += _mha(f"{b}.{n}", f + [n], is_self)
        rows += _dense(f"{b}.mlp.mlp.0", f + ["mlp", "mlp_0"])
        rows += _dense(f"{b}.mlp.mlp.2", f + ["mlp", "mlp_2"])
    return (rows + _dense("final_layer.adaLN_modulation.1",
                          ["final_layer", "adaLN_modulation"])
            + _dense("final_layer.linear", ["final_layer", "linear"]))


def motion_vae_table(depth: int = 12) -> List[Row]:
    """The motion VAE, the encoder's parameters included."""
    qkvo = ("to_q", "to_kv", "to_out")
    rows = (_dense("input_embedding.0", ["input_embedding"])
            + _dense("gs_embedding.0", ["gs_embedding"]))
    for n in qkvo:
        rows += _dense(f"cross_attend_blocks.0.fn.{n}", ["enc_cross", n])
    rows += (_dense("cross_attend_blocks.1.fn.net.0", ["enc_ff", "net_0"])
             + _dense("cross_attend_blocks.1.fn.net.2", ["enc_ff", "net_2"])
             + _dense("mean_fc", ["mean_fc"])
             + _dense("logvar_fc", ["logvar_fc"]) + _dense("proj", ["proj"]))
    for i in range(depth):
        for n in qkvo:
            rows += _dense(f"layers.{i}.0.fn.{n}", [f"latent_attn_{i}", n])
        rows += _dense(f"layers.{i}.1.fn.net.0", [f"latent_ff_{i}", "net_0"])
        rows += _dense(f"layers.{i}.1.fn.net.2", [f"latent_ff_{i}", "net_2"])
    for n in qkvo:
        rows += _dense(f"decoder_cross_attn.fn.{n}", ["dec_cross", n])
    return rows + _dense("to_outputs", ["to_outputs"])


def static_vae_table(num_blocks: int = 12) -> List[Row]:
    """The static SparseTransformerVAE (flax SparseLinears wrap a Dense
    named Dense_0; the encoder's and decoder's blocks are `enc_{i}` and
    `dec_{i}`)."""
    rows = []
    for n in ("input_layer", "to_latent", "from_latent", "out_layer"):
        rows += _dense(n, [n, "Dense_0"])
    for prefix, f in (("encoder", "enc"), ("decoder", "dec")):
        for i in range(num_blocks):
            b, fp = f"{prefix}.{i}", [f"{f}_{i}"]
            rows += (_mha(f"{b}.attn", fp + ["attn"], True)
                     + _dense(f"{b}.mlp.mlp.0", fp + ["mlp", "mlp_0", "Dense_0"])
                     + _dense(f"{b}.mlp.mlp.2", fp + ["mlp", "mlp_2", "Dense_0"]))
    return rows


def lpips_table() -> List[Row]:
    """LPIPS: vgg16.features' 13 convolutions as flax `vgg/conv{j}`, the
    five [1, C, 1, 1] linear heads as flat [C] vectors `lin{i}` (the
    layout of JAX's `ops/lpips.convert_torch_lpips`)."""
    from ..ops.lpips import CONV_INDEX, STAGES

    rows = []
    for j, i in enumerate(CONV_INDEX):
        rows += _conv(f"features.{i}", ["vgg", f"conv{j}"], CONV2D)
    for i, (ch, _) in enumerate(STAGES):
        rows.append((f"lin{i}.model.1.weight", (f"lin{i}",), Transform(
            lambda a, ch=ch: a.reshape(1, ch, 1, 1),
            lambda w: w.reshape(-1))))
    return rows


def conv4d_table() -> List[Row]:
    """nn/misc.Conv4d: the spatial Conv3d and the temporal Conv1d."""
    return (_conv("spatial_conv", ["spatial_conv"])
            + _conv("temporal_conv", ["temporal_conv"], CONV1D))


def attention_pooling_table() -> List[Row]:
    """nn/misc.AttentionPooling: its q, k and v projections."""
    return [r for n in ("q_proj", "k_proj", "v_proj") for r in _dense(n, [n])]


def dinov2_table(depth: int = 24) -> List[Row]:
    """DINOv2 under the torch hub's `dinov2_vitl14_reg` names."""
    rows = [(n, (n,), SAME) for n in ("cls_token", "pos_embed",
                                      "register_tokens")]
    rows += _conv("patch_embed.proj", ["patch_embed", "proj"], CONV2D)
    for i in range(depth):
        b, f = f"blocks.{i}", [f"blocks_{i}"]
        rows += (_norm(f"{b}.norm1", f + ["norm1"])
                 + _norm(f"{b}.norm2", f + ["norm2"])
                 + _dense(f"{b}.attn.qkv", f + ["attn", "to_qkv"])
                 + _dense(f"{b}.attn.proj", f + ["attn", "to_out"])
                 + [(f"{b}.ls{j}.gamma", (f[0], f"ls{j}_gamma"), SAME)
                    for j in (1, 2)]
                 + _dense(f"{b}.mlp.fc1", f + ["mlp", "fc1"])
                 + _dense(f"{b}.mlp.fc2", f + ["mlp", "fc2"]))
    return rows + _norm("norm", ["norm"])


def ss_flow_table(num_blocks: int = 24, in_channels: int = 8,
                  out_channels: int = 8, patch_size: int = 2) -> List[Row]:
    """The sparse-structure flow (share_mod's top-level `adaLN_modulation`
    where the source has one)."""
    p3 = patch_size ** 3
    pin, pout = _perm(p3, in_channels), _perm(p3, out_channels)
    rows = [("input_layer.weight", ("input_layer", "kernel"),
             _permuted(pin, 0, DENSE)),
            ("input_layer.bias", ("input_layer", "bias"), SAME)]
    rows += (_dense("t_embedder.mlp.0", ["t_embedder", "mlp_0"])
             + _dense("t_embedder.mlp.2", ["t_embedder", "mlp_2"])
             + _dense("adaLN_modulation.1", ["adaLN_modulation"]))
    for i in range(num_blocks):
        b, f = f"blocks.{i}", [f"blocks_{i}"]
        rows += (_dense(f"{b}.adaLN_modulation.1", f + ["adaLN_modulation"])
                 + _norm(f"{b}.norm2", f + ["norm2"])
                 + _mha(f"{b}.self_attn", f + ["self_attn"], True)
                 + _mha(f"{b}.cross_attn", f + ["cross_attn"], False)
                 + _dense(f"{b}.mlp.mlp.0", f + ["mlp", "mlp_0"])
                 + _dense(f"{b}.mlp.mlp.2", f + ["mlp", "mlp_2"]))
    return rows + [("out_layer.weight", ("out_layer", "kernel"),
                    _permuted(pout, 1, DENSE)),
                   ("out_layer.bias", ("out_layer", "bias"),
                    _permuted(pout, 0, SAME))]


def ss_decoder_table(channels: Sequence[int] = (512, 128, 32),
                     num_res_blocks: int = 2,
                     num_res_blocks_middle: int = 2) -> List[Row]:
    """The occupancy decoder (LayerNorm or GroupNorm weights alike), the
    upsamples' output channels in the pixel shuffle's order."""

    def res(t, f):
        return (_norm(f"{t}.norm1", f + ["norm1"])
                + _norm(f"{t}.norm2", f + ["norm2"])
                + _conv(f"{t}.conv1", f + ["conv1"])
                + _conv(f"{t}.conv2", f + ["conv2"])
                + _conv(f"{t}.skip_connection", f + ["skip_connection"]))

    rows = _conv("input_layer", ["input_layer"])
    for j in range(num_res_blocks_middle):
        rows += res(f"middle_block.{j}", [f"middle_{j}"])
    bi = 0
    for i, _ in enumerate(channels):
        for j in range(num_res_blocks):
            rows += res(f"blocks.{bi}", [f"block_{i}_{j}"])
            bi += 1
        if i < len(channels) - 1:
            perm = _perm(8, channels[i + 1])
            rows += [(f"blocks.{bi}.conv.weight",
                      (f"up_{i}", "conv", "kernel"),
                      _permuted(perm, 4, CONV3D)),
                     (f"blocks.{bi}.conv.bias", (f"up_{i}", "conv", "bias"),
                      _permuted(perm, 0, SAME))]
            bi += 1
    return (rows + _norm("out_layer.0", ["out_norm"])
            + _conv("out_layer.2", ["out_layer"]))


def _spconv(sd, tree, torch_name: str, path: List[str]) -> None:
    """One sparse conv's flax parameters at `path` of `tree` into `sd`."""
    sd.update(from_flax(_conv(torch_name, path, SPCONV), tree))


def _slat_res_block(b: str, f: List[str]) -> List[Row]:
    return (_norm(f"{b}.norm1", f + ["norm1", "LayerNorm_0"])
            + _conv(f"{b}.conv1.conv", f + ["conv1"], SPCONV)
            + _conv(f"{b}.conv2.conv", f + ["conv2"], SPCONV)
            + _dense(f"{b}.emb_layers.1", f + ["emb_layers"])
            + _dense(f"{b}.skip_connection",
                     f + ["skip_connection", "Dense_0"]))


def slat_flow_table(num_blocks: int = 24,
                    io_block_channels: Sequence[int] = (128,),
                    num_io_res_blocks: int = 2) -> List[Row]:
    """The SLat flow (share_mod's top-level `adaLN_modulation` and the
    cross q/k RMS gammas of qk_rms_norm_cross where the source has them)."""
    rows = (_dense("input_layer", ["input_layer", "Dense_0"])
            + _dense("t_embedder.mlp.0", ["t_embedder", "mlp_0"])
            + _dense("t_embedder.mlp.2", ["t_embedder", "mlp_2"])
            + _dense("adaLN_modulation.1", ["adaLN_modulation"]))
    for i in range(len(io_block_channels) * num_io_res_blocks):
        rows += _slat_res_block(f"input_blocks.{i}", [f"input_blocks_{i}"])
        rows += _slat_res_block(f"out_blocks.{i}", [f"out_blocks_{i}"])
    for i in range(num_blocks):
        b, f = f"blocks.{i}", [f"blocks_{i}"]
        rows += (_dense(f"{b}.adaLN_modulation.1", f + ["adaLN_modulation"])
                 + _norm(f"{b}.norm2", f + ["norm2", "LayerNorm_0"])
                 + _mha(f"{b}.self_attn", f + ["self_attn"], True)
                 + _mha(f"{b}.cross_attn", f + ["cross_attn"], False)
                 + _dense(f"{b}.mlp.mlp.0", f + ["mlp", "mlp_0", "Dense_0"])
                 + _dense(f"{b}.mlp.mlp.2", f + ["mlp", "mlp_2", "Dense_0"]))
    return rows + _dense("out_layer", ["out_layer", "Dense_0"])


def slat_gs_decoder_table(num_blocks: int = 12) -> List[Row]:
    """The SLat Gaussian decoder (its torso under JAX's `torso`)."""
    rows = _dense("input_layer", ["torso", "input_layer", "Dense_0"])
    for i in range(num_blocks):
        b, f = f"blocks.{i}", ["torso", f"blocks_{i}"]
        rows += (_mha(f"{b}.attn", f + ["attn"], True)
                 + _dense(f"{b}.mlp.mlp.0", f + ["mlp", "mlp_0", "Dense_0"])
                 + _dense(f"{b}.mlp.mlp.2", f + ["mlp", "mlp_2", "Dense_0"]))
    return rows + _dense("out_layer", ["out_layer", "Dense_0"])



def clip_table(depth: int = 12) -> List[Row]:
    """CLIP's visual tower under OpenAI's names (`visual.` stripped): the
    packed in_proj [3C, C] is flax's `attn/to_qkv` Dense, `proj` [width,
    embed] stays as stored."""
    rows = [("conv1.weight", ("conv1", "kernel"), CONV2D)]
    rows += [(n, (n,), SAME) for n in ("class_embedding",
                                       "positional_embedding", "proj")]
    rows += _norm("ln_pre", ["ln_pre"]) + _norm("ln_post", ["ln_post"])
    for i in range(depth):
        b, f = f"transformer.resblocks.{i}", [f"resblocks_{i}"]
        qkv = tuple(f + ["attn", "to_qkv"])
        rows += (_norm(f"{b}.ln_1", f + ["ln_1"])
                 + [(f"{b}.attn.in_proj_weight", qkv + ("kernel",), DENSE),
                    (f"{b}.attn.in_proj_bias", qkv + ("bias",), SAME)]
                 + _dense(f"{b}.attn.out_proj", f + ["attn", "to_out"])
                 + _norm(f"{b}.ln_2", f + ["ln_2"])
                 + _dense(f"{b}.mlp.c_fc", f + ["c_fc"])
                 + _dense(f"{b}.mlp.c_proj", f + ["c_proj"]))
    return rows


def modnet_table(hr_channels: int = 32,
                 backbone_width: float = 1.0) -> List[Row]:
    """MODNet under flax's variable paths, collection first: each
    parameter under `params` (a Conv's kernel, a Dense's, a BatchNorm's
    scale, their biases), each BatchNorm's running mean and variance under
    `batch_stats` (`mean`, `var`). The modules carry flax's names
    (models/modnet.py)."""
    from ..models.modnet import BatchNorm, MODNet

    with torch.device("meta"):
        model = MODNet(hr_channels, backbone_width)
    rows: List[Row] = []
    for name, m in model.named_modules():
        f = ["params"] + name.split(".")
        if isinstance(m, torch.nn.Conv2d):
            rows += _conv(name, f, CONV2D)
        elif isinstance(m, torch.nn.Linear):
            rows += _dense(name, f)
        elif isinstance(m, BatchNorm):
            stats = ["batch_stats"] + f[1:]
            rows += _norm(name, f) + [
                (f"{name}.running_mean", tuple(stats + ["mean"]), SAME),
                (f"{name}.running_var", tuple(stats + ["var"]), SAME)]
    return rows


# -- flax -> torch, by model ---------------------------------------------------


def dit_state_dict_from_flax(params, num_blocks: int = 12):
    return from_flax(dit_table(num_blocks), params)


def static_vae_state_dict_from_flax(params, num_blocks: int = 12):
    return from_flax(static_vae_table(num_blocks), params)


def motion_vae_state_dict_from_flax(params, depth: int = 12):
    return from_flax(motion_vae_table(depth), params)


def dinov2_state_dict_from_flax(params, depth: int = 24):
    return from_flax(dinov2_table(depth), params)


def ss_flow_state_dict_from_flax(params, num_blocks: int = 24,
                                 in_channels: int = 8, out_channels: int = 8,
                                 patch_size: int = 2):
    return from_flax(ss_flow_table(num_blocks, in_channels, out_channels,
                                   patch_size), params)


def ss_decoder_state_dict_from_flax(params, channels=(512, 128, 32),
                                    num_res_blocks: int = 2,
                                    num_res_blocks_middle: int = 2):
    return from_flax(ss_decoder_table(channels, num_res_blocks,
                                      num_res_blocks_middle), params)


def slat_flow_state_dict_from_flax(params, num_blocks: int = 24,
                                   io_block_channels=(128,),
                                   num_io_res_blocks: int = 2):
    return from_flax(slat_flow_table(num_blocks, io_block_channels,
                                     num_io_res_blocks), params)


def slat_gs_decoder_state_dict_from_flax(params, num_blocks: int = 12):
    return from_flax(slat_gs_decoder_table(num_blocks), params)


def modnet_state_dict_from_flax(variables, hr_channels: int = 32,
                                backbone_width: float = 1.0):
    """flax's MODNet variables ({"params": ..., "batch_stats": ...}) -> the
    state dict."""
    return from_flax(modnet_table(hr_channels, backbone_width),
                     {"params": variables})


def modnet_variables(state_dict, hr_channels: int = 32,
                     backbone_width: float = 1.0) -> Dict:
    """The state dict -> flax's variables {"params", "batch_stats"}."""
    return to_flax(modnet_table(hr_channels, backbone_width),
                   state_dict)["params"]
