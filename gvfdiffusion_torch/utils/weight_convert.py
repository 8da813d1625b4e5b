"""Reference torch checkpoints -> the port's state dicts (port of
gvfdiffusion_tpu/utils/weight_convert.py).

The port's modules keep the reference's parameter names and layouts
(utils/weights.py), so a converter here reads from a reference state dict
exactly the names that JAX's `convert_*` of the same name reads, under the
same arguments, and returns them under the port's names: the same names,
but for the two layout changes JAX makes too, the static VAE's old fused-qkv
layout (`old_qkv_layout`) and the GVF checkpoint surgery onto the SLat
Gaussian decoder (`convert_static_vae_to_slat_decoder`). A name JAX's
converter requires and the state dict lacks raises KeyError, as in JAX;
names it does not read are dropped, as in JAX (buffers such as the Gaussian
decoder's `offset_perturbation`, the encoder half under the surgery). Every
name a converter returns is checked against the model's weight table
(`utils/weights.py`, the rows JAX's tree has), and `load_state_dict`
(strict) then checks the names against the module and the shapes.
`weights.to_flax(table, convert_x(sd))` is JAX's `convert_x(sd)`.

`load_torch_checkpoint` reads `.pt` (torch.load, a {"state_dict": ...}
wrapper opened, DDP's `module.` prefix stripped) and `.safetensors`
through `read_safetensors`, the format's reader written here (an 8-byte
little-endian header length, a JSON header, the raw buffers), so the port
needs no `safetensors` package.

Not ported (ROADMAP queue 1, items 4 and 6): the converters of the models
the port lacks, `convert_slat_encoder`, `convert_slat_rf_decoder` and
`convert_slat_mesh_decoder`.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Iterable, List, Optional

import torch

from . import weights

# safetensors dtype names -> torch dtypes
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file -> {name: CPU tensor}, in the header's order
    (`__metadata__` skipped). Each tensor owns its memory."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n:]
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             "which this reader does not read")
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = info["shape"]
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(bytearray(body[begin:end]), dtype=dtype)
        out[name] = flat.reshape(shape)
    return out


def strip_prefix(state_dict: Dict[str, Any],
                 prefix: str = "module.") -> Dict[str, Any]:
    """Remove DDP `module.` prefixes (reference main_latent.py:29-33)."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state_dict.items()}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch `.pt` or `.safetensors` state dict -> {name: CPU tensor}.
    A `.pt` may wrap it in {"state_dict": ...}; its `module.` prefixes are
    stripped (a `.safetensors` file is returned as stored, as in JAX)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v).detach().cpu()
            for k, v in strip_prefix(sd).items()}


class _Reader:
    """Copies names from a reference state dict into the port's, as JAX's
    helpers read them (a Linear's weight required, its bias optional; a
    LayerNorm's weight and bias optional)."""

    def __init__(self, state_dict: Dict[str, Any]):
        self.sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
        self.out: Dict[str, torch.Tensor] = {}

    def take(self, name: str, as_name: Optional[str] = None) -> None:
        self.out[as_name or name] = self.sd[name]

    def maybe(self, name: str, as_name: Optional[str] = None) -> None:
        if name in self.sd:
            self.take(name, as_name)

    def linear(self, name: str, as_name: Optional[str] = None) -> None:
        as_name = as_name or name
        self.take(f"{name}.weight", f"{as_name}.weight")
        self.maybe(f"{name}.bias", f"{as_name}.bias")

    def norm(self, name: str) -> None:
        self.maybe(f"{name}.weight")
        self.maybe(f"{name}.bias")

    def mha(self, name: str, is_self: bool, qk_rms: bool,
            as_name: Optional[str] = None) -> None:
        as_name = as_name or name
        for n in (("to_qkv",) if is_self else ("to_q", "to_kv")) + (
                "to_out",):
            self.linear(f"{name}.{n}", f"{as_name}.{n}")
        if qk_rms:
            for n in ("q_rms_norm", "k_rms_norm"):
                self.maybe(f"{name}.{n}.gamma", f"{as_name}.{n}.gamma")

    def done(self, table: List[weights.Row]) -> Dict[str, torch.Tensor]:
        known = {name for name, _, _ in table}
        stray = sorted(set(self.out) - known)
        if stray:
            raise KeyError(f"{stray[:4]} are not in the model's weight "
                           "table")
        return self.out


def convert_dit(state_dict: Dict[str, Any], num_blocks: int = 12,
                qk_rms_norm: bool = True, no_temporal_attn: bool = False,
                share_mod: bool = False) -> Dict[str, torch.Tensor]:
    """The reference DiT (model/dit.py) -> the port's DiT."""
    r = _Reader(state_dict)
    for n in ("input_layer", "t_embedder.mlp.0", "t_embedder.mlp.2",
              "image_cond_proj", "static_cond_proj"):
        r.linear(n)
    if share_mod:
        r.linear("adaLN_modulation.1")
    r.maybe("pos_embedder")  # a learnable PE is a bare parameter
    for i in range(num_blocks):
        b = f"blocks.{i}"
        if not share_mod:
            r.linear(f"{b}.adaLN_modulation.1")
            if not no_temporal_attn:
                r.linear(f"{b}.adaLN_modulation_temporal.1")
        r.norm(f"{b}.norm3")
        r.norm(f"{b}.norm4")
        r.mha(f"{b}.spatial_self_attn", True, qk_rms_norm)
        if not no_temporal_attn:
            r.mha(f"{b}.temporal_self_attn", True, qk_rms_norm)
        r.mha(f"{b}.image_cross_attn", False, False)
        r.mha(f"{b}.static_cross_attn", False, False)
        r.linear(f"{b}.mlp.mlp.0")
        r.linear(f"{b}.mlp.mlp.2")
    r.linear("final_layer.adaLN_modulation.1")
    r.linear("final_layer.linear")
    return r.done(weights.dit_table(num_blocks))


def convert_motion_vae(state_dict: Dict[str, Any],
                       depth: int = 12) -> Dict[str, torch.Tensor]:
    """The reference GSKLTemporalVariationalAutoEncoder -> MotionVAE."""
    r = _Reader(state_dict)
    qkvo = ("to_q", "to_kv", "to_out")
    r.linear("input_embedding.0")
    r.linear("gs_embedding.0")
    for n in qkvo:
        r.linear(f"cross_attend_blocks.0.fn.{n}")
    for n in ("cross_attend_blocks.1.fn.net.0",
              "cross_attend_blocks.1.fn.net.2", "mean_fc", "logvar_fc",
              "proj"):
        r.linear(n)
    for i in range(depth):
        for n in qkvo:
            r.linear(f"layers.{i}.0.fn.{n}")
        r.linear(f"layers.{i}.1.fn.net.0")
        r.linear(f"layers.{i}.1.fn.net.2")
    for n in qkvo:
        r.linear(f"decoder_cross_attn.fn.{n}")
    r.linear("to_outputs")
    return r.done(weights.motion_vae_table(depth))


def _old_qkv_to_new(w: torch.Tensor, num_heads: int) -> torch.Tensor:
    """A fused-qkv weight [3C, C_in] or bias [3C] from the reference static
    VAE's old attention layout, whose output channels read (H, 3, Ch), to
    the standard (3, H, Ch) (sparse/attention/modules.py:161-164 with
    use_old_attn_impl=True)."""
    ch = w.shape[0] // (3 * num_heads)
    return (w.reshape(num_heads, 3, ch, *w.shape[1:]).transpose(0, 1)
            .reshape(w.shape).contiguous())


def convert_static_vae(state_dict: Dict[str, Any], num_blocks: int = 12,
                       num_heads: int = 12, old_qkv_layout: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """The reference SparseTransformerVAE -> the port's. old_qkv_layout:
    for checkpoints trained with use_old_attn_impl=True (the shipped
    configs set it false, so released weights are in the new layout)."""
    r = _Reader(state_dict)
    for n in ("input_layer", "to_latent", "from_latent", "out_layer"):
        r.linear(n)
    for prefix in ("encoder", "decoder"):
        for i in range(num_blocks):
            b = f"{prefix}.{i}"
            if old_qkv_layout:  # the weight required, the bias optional
                for k in (f"{b}.attn.to_qkv.weight", f"{b}.attn.to_qkv.bias"):
                    if k in r.sd or k.endswith("weight"):
                        r.sd[k] = _old_qkv_to_new(r.sd[k], num_heads)
            r.mha(f"{b}.attn", True, False)
            r.linear(f"{b}.mlp.mlp.0")
            r.linear(f"{b}.mlp.mlp.2")
    return r.done(weights.static_vae_table(num_blocks))


def convert_static_vae_to_slat_decoder(state_dict: Dict[str, Any],
                                       num_blocks: int = 12
                                       ) -> Dict[str, torch.Tensor]:
    """The GVF checkpoint surgery (reference trellis/models/__init__.py:
    46-76): the static VAE's decoder half as a SLat Gaussian decoder,
    `from_latent.` -> `input_layer.`, `decoder.{i}.` -> `blocks.{i}.`,
    `out_layer.` kept; the encoder's weights are dropped."""
    r = _Reader(state_dict)
    r.linear("from_latent", "input_layer")
    for i in range(num_blocks):
        b, to = f"decoder.{i}", f"blocks.{i}"
        r.mha(f"{b}.attn", True, False, f"{to}.attn")
        r.linear(f"{b}.mlp.mlp.0", f"{to}.mlp.mlp.0")
        r.linear(f"{b}.mlp.mlp.2", f"{to}.mlp.mlp.2")
    r.linear("out_layer")
    return r.done(weights.slat_gs_decoder_table(num_blocks))


def convert_dinov2(state_dict: Dict[str, Any],
                   depth: int = 24) -> Dict[str, torch.Tensor]:
    """facebookresearch/dinov2 ViT with registers (the torch hub's
    `dinov2_vitl14_reg` names, which the port keeps) -> DinoV2."""
    r = _Reader(state_dict)
    r.take("cls_token")
    r.take("pos_embed")
    r.maybe("register_tokens")
    r.take("patch_embed.proj.weight")
    r.take("patch_embed.proj.bias")
    for i in range(depth):
        b = f"blocks.{i}"
        r.norm(f"{b}.norm1")
        r.norm(f"{b}.norm2")
        r.linear(f"{b}.attn.qkv")
        r.linear(f"{b}.attn.proj")
        r.take(f"{b}.ls1.gamma")
        r.take(f"{b}.ls2.gamma")
        r.linear(f"{b}.mlp.fc1")
        r.linear(f"{b}.mlp.fc2")
    r.norm("norm")
    return r.done(weights.dinov2_table(depth))


def convert_clip_visual(state_dict: Dict[str, Any],
                        depth: int = 12) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP's `visual.*` state dict (the prefix optional) ->
    models/clip.CLIPImageEncoder, which keeps OpenAI's names."""
    r = _Reader({(k[len("visual."):] if k.startswith("visual.") else k): v
                 for k, v in state_dict.items()})
    r.take("conv1.weight")
    r.take("class_embedding")
    r.take("positional_embedding")
    r.norm("ln_pre")
    for i in range(depth):
        b = f"transformer.resblocks.{i}"
        r.norm(f"{b}.ln_1")
        r.take(f"{b}.attn.in_proj_weight")
        r.take(f"{b}.attn.in_proj_bias")
        r.linear(f"{b}.attn.out_proj")
        r.norm(f"{b}.ln_2")
        r.linear(f"{b}.mlp.c_fc")
        r.linear(f"{b}.mlp.c_proj")
    r.norm("ln_post")
    r.take("proj")
    return r.done(weights.clip_table(depth))


def _modulated_block(r: _Reader, b: str, qk_rms: bool, qk_rms_cross: bool,
                     share_mod: bool) -> None:
    """A TRELLIS modulated cross block (dense or sparse: the same names)."""
    if not share_mod:
        r.linear(f"{b}.adaLN_modulation.1")
    r.norm(f"{b}.norm2")
    r.mha(f"{b}.self_attn", True, qk_rms)
    r.mha(f"{b}.cross_attn", False, qk_rms_cross)
    r.linear(f"{b}.mlp.mlp.0")
    r.linear(f"{b}.mlp.mlp.2")


def convert_ss_flow(state_dict: Dict[str, Any], num_blocks: int = 24,
                    in_channels: int = 8, out_channels: int = 8,
                    patch_size: int = 2, share_mod: bool = False,
                    qk_rms_norm: bool = False,
                    qk_rms_norm_cross: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """trellis SparseStructureFlowModel -> the port's. The port keeps the
    reference's channel-major patch features, so the projections JAX
    permutes are taken as they are."""
    r = _Reader(state_dict)
    r.take("input_layer.weight")
    r.take("input_layer.bias")
    r.linear("t_embedder.mlp.0")
    r.linear("t_embedder.mlp.2")
    if share_mod:
        r.linear("adaLN_modulation.1")
    for i in range(num_blocks):
        _modulated_block(r, f"blocks.{i}", qk_rms_norm, qk_rms_norm_cross,
                         share_mod)
    r.take("out_layer.weight")
    r.take("out_layer.bias")
    return r.done(weights.ss_flow_table(num_blocks, in_channels,
                                        out_channels, patch_size))


def convert_ss_decoder(state_dict: Dict[str, Any],
                       channels: Iterable[int] = (512, 128, 32),
                       num_res_blocks: int = 2,
                       num_res_blocks_middle: int = 2,
                       out_channels_up: Optional[Dict[int, int]] = None
                       ) -> Dict[str, torch.Tensor]:
    """trellis SparseStructureDecoder -> the port's (the upsamples' pixel
    shuffle in the reference's order, as the port keeps it)."""
    channels = tuple(channels)
    r = _Reader(state_dict)

    def conv(name):
        r.take(f"{name}.weight")
        r.take(f"{name}.bias")

    def res(name):
        r.norm(f"{name}.norm1")
        r.norm(f"{name}.norm2")
        conv(f"{name}.conv1")
        conv(f"{name}.conv2")
        if f"{name}.skip_connection.weight" in r.sd:
            conv(f"{name}.skip_connection")

    conv("input_layer")
    for j in range(num_res_blocks_middle):
        res(f"middle_block.{j}")
    bi = 0
    for i in range(len(channels)):
        for _ in range(num_res_blocks):
            res(f"blocks.{bi}")
            bi += 1
        if i < len(channels) - 1:
            conv(f"blocks.{bi}.conv")
            bi += 1
    r.norm("out_layer.0")
    conv("out_layer.2")
    return r.done(weights.ss_decoder_table(channels, num_res_blocks,
                                           num_res_blocks_middle))


def _spconv(r: _Reader, name: str) -> None:
    r.take(f"{name}.weight")
    r.maybe(f"{name}.bias")


def _slat_res_block(r: _Reader, b: str) -> None:
    r.norm(f"{b}.norm1")
    _spconv(r, f"{b}.conv1.conv")
    _spconv(r, f"{b}.conv2.conv")
    r.linear(f"{b}.emb_layers.1")
    if f"{b}.skip_connection.weight" in r.sd:
        r.linear(f"{b}.skip_connection")


def convert_slat_flow(state_dict: Dict[str, Any], num_blocks: int = 24,
                      io_block_channels: Iterable[int] = (128,),
                      num_io_res_blocks: int = 2, share_mod: bool = False,
                      qk_rms_norm: bool = False,
                      qk_rms_norm_cross: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """trellis SLatFlowModel (structured_latent_flow.py:234) -> the
    port's (spconv's [O, k, k, k, I] kernels, as the port keeps them)."""
    io_block_channels = tuple(io_block_channels)
    r = _Reader(state_dict)
    r.linear("input_layer")
    r.linear("t_embedder.mlp.0")
    r.linear("t_embedder.mlp.2")
    if share_mod:
        r.linear("adaLN_modulation.1")
    n_io = len(io_block_channels) * num_io_res_blocks
    for i in range(n_io):
        _slat_res_block(r, f"input_blocks.{i}")
    for i in range(num_blocks):
        _modulated_block(r, f"blocks.{i}", qk_rms_norm, qk_rms_norm_cross,
                         share_mod)
    for i in range(n_io):
        _slat_res_block(r, f"out_blocks.{i}")
    r.linear("out_layer")
    return r.done(weights.slat_flow_table(num_blocks, io_block_channels,
                                          num_io_res_blocks))


def convert_slat_gs_decoder(state_dict: Dict[str, Any], num_blocks: int = 12,
                            qk_rms_norm: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """TRELLIS's SLatGaussianDecoder (decoder_gs.py:117, the released
    safetensors layout) -> the port's; its `offset_perturbation` buffer is
    recomputed, not stored, on this side."""
    r = _Reader(state_dict)
    r.linear("input_layer")
    for i in range(num_blocks):
        b = f"blocks.{i}"
        r.mha(f"{b}.attn", True, qk_rms_norm)
        r.linear(f"{b}.mlp.mlp.0")
        r.linear(f"{b}.mlp.mlp.2")
    r.linear("out_layer")
    return r.done(weights.slat_gs_decoder_table(num_blocks))

