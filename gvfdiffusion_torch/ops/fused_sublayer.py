"""The DiT's four fused transformer sublayers (port of
gvfdiffusion_tpu/ops/fused_sublayer.py).

Each sublayer has two versions:
  * `*_reference`: plain torch, a straight copy of the JAX reference math,
    rounding to `compute_dtype` at the same points (matmul operands and the
    softmax weights are rounded; every product accumulates in fp32).
  * `fused_*_sublayer`: dispatches on the device of `x`. A CUDA tensor runs
    the hand-written kernel chain of `csrc/fused_sublayer.cu` (bf16, and
    fp32 for one cross context); a CPU tensor runs the plain version.
    `impl="plain"` forces the plain version on any device, for comparing
    the two on the card.

The JAX kernels' configurations are ported at every head width D that
their rules admit (`*_sublayer_supports`: D divides 128), in every form:
the self, temporal and two-context cross sublayers with their `rms` flag
at JAX's defaults (q/k RMS norms on the self and temporal sublayers unless
`rms=False`; on the cross sublayer, `rms=True` norms q, the cached k
having been normed when the cache was built); one cross context, with or
without the q RMS norm, for the SLat flow torso, in bf16 or, at
compute_dtype=float32 (the torso of TRELLIS as the registry builds it), in
fp32 with no operand rounded to bf16: an fp32 LN, the projections and the
attention by the 3xTF32 split on the tensor cores
(`gvf_cross_sublayer1_f32`; every tensor fp32, the q norm in fp32). The
kernels run a head at its card width (`_widths.sublayer_card_width`: D
from 32 up, 32 below); a narrower head is zero-padded in the projections'
weights (`widen_self_weights`, `widen_cross_params`) and K3's cache
(`widen_heads`) by the wrappers, the scale staying D ** -0.5: zero lanes
change no score, maximum, row sum, RMS norm or int8 max-abs scale, so the
function is the one at width D. The
JAX kernel's `kv_buffers` sized its VMEM residency on the
TPU and has no counterpart here. Its int8 `quant` form (the DiT's two
contexts against an int8 KV cache from `quantize_kv`, and one context,
with or without `rms`) is ported with its
arithmetic: `cross_sublayer_q8_reference` is its plain version, and
`cross_sublayer_reference(quant=True)` the JAX package's oracle on the
dequantized cache. That form quantizes q (after its RMS norm, with `rms`)
per (cell, head), where a cell is one TPU grid instance: all L rows of a
batch row, or `lq_block` of them where the JAX DiT grids the rows (halves
at the 3-way CFG batch); the wrappers take that domain as `q_block`. The
self kernels' int8-QK form (`quant_qk=True`, JAX's GVF_SELF_QUANT=int8) is
ported too: q and k, in fp32 after their RMS norms (if any), each take one
max-abs scale per (cell, head), where the cell is one frame for the self
sublayer and one batch row x `voxel_group` voxels x all T frames for the
temporal one (the TPU grid instance; attention still couples only the T
rows of one voxel). JAX has no oracle for it:
`self_sublayer_qk8_reference` and `temporal_sublayer_qk8_reference` are
its plain versions. K1's `seg` (rows of `seg` interleaved streams, row r
attending the rows of its stream r % seg) is K2's function on the
[B, L / seg, seg, C] view: on the card it runs K2's chain there, float or
int8 QK (one scale cell a batch row: a voxel group of seg).

Cross parameters p_i are (norm_scale, norm_bias, wq, bq, wo, bo), or with
`rms=True` (norm_scale, norm_bias, wq, bq, qg, wo, bo), JAX's order, where
qg is the q norm's lane gamma. Weights come in the JAX layout ([in, out]);
an `nn.Linear(...).weight.t()` view passes to the kernel with no copy.

`*_sublayer_supports` are the JAX package's shape rules for the DiT
block's gate to the fused path, less their `vmem_est` terms: those size
the TPU kernel's VMEM residency and have no counterpart on Hopper.

`launch_counts` counts kernel launches per sublayer (one per launched
chain; "cross" for the two-context form, "cross_q8" for its int8 form,
"self_q8" and "temporal_q8" for the int8-QK self forms, "self_seg" and
"self_seg_q8" for K1 with seg, "temporal_core" for
temporal_sublayer_attention, the temporal sublayer's attention step called
alone); the plain version never counts. A form's counter covers heads of
32 and 64 and every `rms` setting, a run's configuration telling them
apart; at every other width it has a counter of its own named by the true
width (`launch_key`: "self_d16", "cross_q8_d128", ...). The single-context
form's counter is keyed by form, dtype and head width as K7's
(`single_launch_key`: "cross_single", "cross_single_fp32",
"cross_single_d128", "cross_single_rms", "cross_single_rms_fp32",
"cross_single_q8", "cross_single_d16", ...).

The backward of every sublayer wrapper, on every device and with
impl="plain" too, is the JAX custom_vjp's (`_self_bwd`, `_temporal_bwd`,
`_cross_bwd`, `_mlp_bwd`): a `torch.autograd.Function` (`_Fused`) saves
the inputs and differentiates the float oracle, recomputed under torch's
autograd in chunks of batch rows; the int8 forms differentiate the float
oracle too (through the dequantized cache, which gets no gradient), as JAX
does. `temporal_sublayer_attention`, the attention step alone (no JAX
counterpart; the tests' entry to the kernel), has no backward on the card:
it raises under grad there.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ._widths import SUBLAYER_WIDTHS, sublayer_card_width

_LN_EPS = 1e-6
_RMS_EPS = 1e-12

_LOG2E = 1.4426950408889634
_SHIFT = 30.0  # the TPU kernels' fixed exp2 shift

def launch_key(form: str, head_dim: int) -> str:
    """The counter of a launch of `form` ("self", "temporal", "cross",
    "self_q8", "temporal_q8", "cross_q8", "self_seg", "self_seg_q8",
    "temporal_core") at heads of head_dim: the form's own name at 32 and 64
    (the widths its kernels served first), "<form>_d<head_dim>" at the
    others."""
    return form if head_dim in (32, 64) else f"{form}_d{head_dim}"


def single_launch_key(dtype: torch.dtype, head_dim: int, rms: bool = False,
                      quant: bool = False) -> str:
    """The counter of a single-context launch: its form (int8 cache, q RMS
    norm, or neither), its dtype and its head width."""
    form = "_q8" if quant else "_rms" if rms else ""
    return ("cross_single" + form
            + ("_fp32" if dtype == torch.float32 else "")
            + ("" if head_dim == 64 else f"_d{head_dim}"))


_FORMS = ("self", "temporal", "cross", "self_q8", "temporal_q8",
          "cross_q8", "self_seg", "self_seg_q8", "temporal_core")
launch_counts = {"self": 0, "temporal": 0, "cross": 0, "mlp": 0,
                 **{launch_key(f, d): 0 for d in SUBLAYER_WIDTHS
                    for f in _FORMS},
                 **{single_launch_key(dt, d, rms): 0 for d in SUBLAYER_WIDTHS
                    for dt in (torch.bfloat16, torch.float32)
                    for rms in (False, True)},
                 **{single_launch_key(torch.bfloat16, d, quant=True): 0
                    for d in SUBLAYER_WIDTHS}}
# voxels per cell of the temporal sublayer (JAX `_TEMPORAL_NC`), halved
# until it divides N
_TEMPORAL_NC = 16


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# -- plain versions -------------------------------------------------------------


def _layernorm_f32(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _LN_EPS)


def _rd(a: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Round to the compute dtype and compute on in fp32: a matmul of two
    rounded operands is then a `preferred_element_type=float32` product."""
    return a.to(dt).float()


def _f(a: torch.Tensor) -> torch.Tensor:
    return a.float()


def _rms(a: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Per-head RMS norm of [..., C] with the lane gamma g = gamma * sqrt(D)."""
    ah = a.unflatten(-1, (num_heads, -1))
    ss = ah.square().sum(-1, keepdim=True)
    return (ah * torch.rsqrt(ss + _RMS_EPS)).flatten(-2) * _f(g)


def _qkv(qkv, qg, kg, num_heads: int, rms: bool):
    """q, k, v of an fp32 [..., 3C] projection, q and k RMS-normed with
    `rms`."""
    C = qkv.shape[-1] // 3
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    if rms:
        q, k = _rms(q, qg, num_heads), _rms(k, kg, num_heads)
    return q, k, v


def _seg_mask(L: int, seg: int, device):
    """[L, L] True where row % seg == col % seg (K1's `seg` interleaved
    streams), or None for seg <= 1."""
    if seg <= 1:
        return None
    r = torch.arange(L, device=device)
    return r[:, None] % seg == r[None, :] % seg


def self_sublayer_reference(x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo,
                            num_heads: int, rms: bool = True,
                            compute_dtype=torch.bfloat16, seg: int = 0):
    """x [B, L, C]; sh/sc/gate [B, C]; wqkv [C, 3C]; wo [C, C]; qg/kg [C]
    (read with rms=True). seg > 1: row i attends only the rows j with
    i % seg == j % seg (JAX's oracle's mask)."""
    B, L, C = x.shape
    D = C // num_heads
    dt = compute_dtype
    xf = _f(x)
    h = _layernorm_f32(xf) * (1.0 + _f(sc)[:, None]) + _f(sh)[:, None]
    qkv = _rd(h, dt) @ _rd(wqkv, dt) + _f(bqkv)
    q, k, v = _qkv(qkv, qg, kg, num_heads, rms)
    qh, kh, vh = (_rd(a, dt).reshape(B, L, num_heads, D) for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * D ** -0.5
    mask = _seg_mask(L, seg, x.device)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", _rd(p, dt), vh).reshape(B, L, C)
    out = _rd(attn, dt) @ _rd(wo, dt) + _f(bo)
    return (xf + out * _f(gate)[:, None]).to(x.dtype)


def temporal_sublayer_reference(x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo,
                                num_heads: int, rms: bool = True,
                                compute_dtype=torch.bfloat16):
    """x [B, T, N, C]; sh/sc/gate [B, C]; attention over T per (b, n, h)."""
    B, T, N, C = x.shape
    D = C // num_heads
    dt = compute_dtype
    xf = _f(x)
    h = _layernorm_f32(xf) * (1.0 + _f(sc)[:, None, None]) \
        + _f(sh)[:, None, None]
    qkv = _rd(h, dt) @ _rd(wqkv, dt) + _f(bqkv)
    q, k, v = _qkv(qkv, qg, kg, num_heads, rms)
    qh, kh, vh = (_rd(a, dt).reshape(B, T, N, num_heads, D)
                  for a in (q, k, v))
    s = torch.einsum("btnhd,bsnhd->bnhts", qh, kh) * D ** -0.5
    p = torch.softmax(s, dim=-1)
    attn = torch.einsum("bnhts,bsnhd->btnhd", _rd(p, dt), vh)
    out = _rd(attn.reshape(B, T, N, C), dt) @ _rd(wo, dt) + _f(bo)
    return (xf + out * _f(gate)[:, None, None]).to(x.dtype)


def temporal_voxel_group(n: int) -> int:
    """Voxels per cell of the temporal sublayer at N = n, as the JAX kernel
    grids them: 16, halved while it does not divide n."""
    nc = _TEMPORAL_NC
    while n % nc:
        nc //= 2
    return nc


def _qk8_attention(q, qs, k, ks, v, dt, scale, mask=None):
    """The int8-QK attention of one row block per leading index, in the
    kernels' arithmetic (JAX `_packed_attention`, quant_qk): q, k [..., Lq |
    Lk, H, D] fp32 after the RMS norms, their max-abs scales qs, ks
    [..., H] (each floored at 1e-8) taken beforehand over the cell; v fp32.
    qi = round(q * (127 / qs)) (half to even), si the int8 x int8 sums
    (exact in fp32), s = si * (qs * ks * scale * log2 e / 127^2) - 30,
    P = exp2(s); the row sum from the fp32 P, P V with P and V rounded to
    dt; mask [Lq, Lk] (False: P = 0, the score -inf) or None. -> [..., Lq,
    H, D]."""
    n127 = torch.tensor(127.0, dtype=torch.float32)
    qi = torch.round(q * (n127 / qs)[..., None, :, None])
    ki = torch.round(k * (n127 / ks)[..., None, :, None])
    return _qk8_int_attention(qi, qs, ki, ks, v, dt, scale, mask)


def _qk8_int_attention(qi, qs, ki, ks, v, dt, scale, mask=None):
    """_qk8_attention from the int8 values qi, ki [..., Lq | Lk, H, D]
    (held as floats) and their scales."""
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    si = torch.einsum("...qhd,...khd->...hqk", qi, ki)
    f = qs * ks * f32(scale) * f32(_LOG2E) / f32(127.0 * 127.0)
    s = si * f[..., None, None] - _SHIFT
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p_ = torch.exp2(s)
    del si, s
    denom = p_.sum(-1).transpose(-1, -2)[..., None]  # [..., Lq, H, 1]
    o = torch.einsum("...hqk,...khd->...qhd", _rd(p_, dt), _rd(v, dt))
    return o / denom.clamp_min(1e-30)


def self_sublayer_qk8_reference(x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo,
                                num_heads: int, rms: bool = True,
                                compute_dtype=torch.bfloat16, seg: int = 0):
    """The int8-QK self sublayer's own arithmetic (JAX
    `_self_sublayer_kernel` with quant_qk=True): as
    self_sublayer_reference, with q and k (fp32, RMS-normalized with `rms`)
    quantized per (frame, head), a frame being one batch row of L rows
    (with seg: all its interleaved streams); see _qk8_attention."""
    B, L, C = x.shape
    H, D = num_heads, C // num_heads
    dt = compute_dtype
    xf = _f(x)
    h = _layernorm_f32(xf) * (1.0 + _f(sc)[:, None]) + _f(sh)[:, None]
    qkv = _rd(h, dt) @ _rd(wqkv, dt) + _f(bqkv)
    q, k, v = (a.reshape(B, L, H, D) for a in _qkv(qkv, qg, kg, H, rms))
    qs, ks = (a.abs().amax((1, 3)).clamp_min(1e-8) for a in (q, k))  # [B, H]
    attn = _qk8_attention(q, qs, k, ks, v, dt, D ** -0.5,
                          _seg_mask(L, seg, x.device)).reshape(B, L, C)
    out = _rd(attn, dt) @ _rd(wo, dt) + _f(bo)
    return (xf + out * _f(gate)[:, None]).to(x.dtype)


def temporal_sublayer_qk8_reference(x, sh, sc, gate, wqkv, bqkv, qg, kg, wo,
                                    bo, num_heads: int, rms: bool = True,
                                    compute_dtype=torch.bfloat16,
                                    voxel_group: Optional[int] = None):
    """The int8-QK temporal sublayer's own arithmetic (JAX
    `_temporal_sublayer_kernel` with quant_qk=True): as
    temporal_sublayer_reference, with q and k (fp32, RMS-normalized with
    `rms`) quantized per (batch row, group of `voxel_group` voxels, head)
    over all T frames (default: temporal_voxel_group(N)); attention over T
    per voxel."""
    B, T, N, C = x.shape
    H, D = num_heads, C // num_heads
    nc = voxel_group or temporal_voxel_group(N)
    if N % nc:
        raise ValueError(f"voxel group {nc} does not divide {N} voxels")
    dt = compute_dtype
    xf = _f(x)
    h = _layernorm_f32(xf) * (1.0 + _f(sc)[:, None, None]) \
        + _f(sh)[:, None, None]
    qkv = _rd(h, dt) @ _rd(wqkv, dt) + _f(bqkv)
    # [B, N, T, H, D]: one row block per voxel
    q, k, v = (a.reshape(B, T, N, H, D).transpose(1, 2)
               for a in _qkv(qkv, qg, kg, H, rms))
    qs, ks = (a.reshape(B, N // nc, nc, T, H, D).abs().amax((2, 3, 5))
              .clamp_min(1e-8).repeat_interleave(nc, 1) for a in (q, k))
    attn = _qk8_attention(q, qs, k, ks, v, dt, D ** -0.5)
    attn = attn.transpose(1, 2).reshape(B, T, N, C)
    out = _rd(attn, dt) @ _rd(wo, dt) + _f(bo)
    return (xf + out * _f(gate)[:, None, None]).to(x.dtype)


def temporal_sublayer_attention(qkv, num_heads: int, *, quant=None,
                                voxel_group: Optional[int] = None,
                                impl: Optional[str] = None):
    """The temporal sublayer's attention step alone: for each (b, n, h) of a
    [B, T, N, 3C] projection, attention over its T frames -> [B, T, N, C]
    bf16, the kernel (`csrc/temporal_sm90.cuh`) that fused_temporal_sublayer
    runs inside its chain. Float form (quant=None): qkv bf16, q and k
    already RMS-normed; temporal_sublayer_reference's softmax, P rounded to
    bf16 for P V. int8 QK: quant = (qi, ki, qs, ks), int8 q and k
    [B, T, N, C] with fp32 scales [B * N // nc, H], one per (batch row,
    group of nc = voxel_group or temporal_voxel_group(N) voxels, head); qkv
    fp32, v read from its last C columns; _qk8_attention's arithmetic. On
    the card a head narrower than 32 runs zero-padded (widen_heads), its
    output cut back."""
    B, T, N, C3 = qkv.shape
    C, H = C3 // 3, num_heads
    D = C // H
    nc = voxel_group or temporal_voxel_group(N)
    if N % nc:
        raise ValueError(f"voxel group {nc} does not divide {N} voxels")
    if not _use_kernel(qkv, impl):
        heads = lambda a: a.float().reshape(B, T, N, H, D)
        if quant is None:
            q, k, v = (heads(qkv[..., i * C:(i + 1) * C]) for i in range(3))
            s = torch.einsum("btnhd,bsnhd->bnhts", q, k) * D ** -0.5
            p = torch.softmax(s, dim=-1)
            attn = torch.einsum("bnhts,bsnhd->btnhd", _rd(p, torch.bfloat16),
                                v)
        else:
            qi, ki, qs, ks = quant
            voxels = lambda a: heads(a).transpose(1, 2)  # [B, N, T, H, D]
            cells = lambda a: a.reshape(B, N // nc, H).repeat_interleave(
                nc, 1)
            attn = _qk8_int_attention(
                voxels(qi), cells(qs), voxels(ki), cells(ks),
                voxels(qkv[..., 2 * C:]), torch.bfloat16,
                D ** -0.5).transpose(1, 2)
        return attn.reshape(B, T, N, C).to(torch.bfloat16)
    from .. import _ext

    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qkv, *(quant or ()))):
        raise RuntimeError("temporal_sublayer_attention's kernel has no "
                           "backward pass; call it under torch.no_grad() "
                           "(fused_temporal_sublayer differentiates)")
    if C % H or D not in SUBLAYER_WIDTHS or C % 8:
        raise ValueError(f"head width must divide 128, over C a multiple "
                         f"of 8, got {C}/{H}")
    want = torch.bfloat16 if quant is None else torch.float32
    if qkv.dtype != want or not qkv.is_contiguous():
        raise TypeError(f"qkv must be a contiguous {want} tensor")
    q8 = (None,) * 4
    if quant is not None:
        q8 = tuple(a.contiguous() for a in quant)
        if any(a.dtype != torch.int8 or a.shape != (B, T, N, C)
               for a in q8[:2]) or any(
                a.dtype != torch.float32 or a.shape != (B * N // nc, H)
                for a in q8[2:]) or any(a.device != qkv.device for a in q8):
            raise TypeError("quant takes int8 qi, ki [B, T, N, C] and fp32 "
                            "qs, ks [B * N // nc, H] on qkv's device")
        q8 = (widen_heads(q8[0], D), widen_heads(q8[1], D), *q8[2:])
    qkv = widen_heads(qkv, D)
    o = torch.empty(B, T, N, H * sublayer_card_width(D), device=qkv.device,
                    dtype=torch.bfloat16)
    _ext.call("gvf_temporal_attention_sm90", _ptr(qkv),
              *map(_ptr_or_null, q8), _ptr(o), B, T, N, C, H, nc)
    launch_counts[launch_key("temporal_core", D)] += 1
    return _narrow_heads(o, H, D)


def quantize_kv(k: torch.Tensor, num_heads: int):
    """[B, Lk, C] -> (int8 values [B, Lk, C], bf16 scales [B, Lk, H]):
    symmetric per-(token, head) max-abs / 127, the scale rounded to bf16
    before the division so that dequantization multiplies by exactly the
    value quantization divided by (JAX `quantize_kv`)."""
    B, Lk, C = k.shape
    kh = k.float().reshape(B, Lk, num_heads, C // num_heads)
    scale = (kh.abs().amax(-1) / 127.0).clamp_min(1e-8).to(torch.bfloat16)
    q = torch.round(kh / scale.float()[..., None]).clamp(-127, 127)
    return q.to(torch.int8).reshape(B, Lk, C), scale


def dequantize_kv(kq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The inverse of quantize_kv: int8 [B, Lk, C] x scales [B, Lk, H] ->
    fp32 [B, Lk, C]."""
    B, Lk, C = kq.shape
    H = scale.shape[-1]
    kh = kq.float().reshape(B, Lk, H, C // H)
    return (kh * scale.float()[..., None]).reshape(B, Lk, C)


def _dequantize_pair(kv, dt):
    """An int8 cache (k, v, k scales [B, H, Lk], v scales [B, Lk, H]) ->
    (k, v) in dt."""
    kq, vq, ks_t, vs = kv
    return (dequantize_kv(kq, ks_t.transpose(1, 2)).to(dt),
            dequantize_kv(vq, vs).to(dt))


def _cross_params(p, rms: bool):
    """p_i as (ns, nb, wq, bq, qg, wo, bo), qg None without rms."""
    if len(p) == 7:
        ns, nb, wq, bq, qg, wo, bo = p
    elif len(p) == 6 and not rms:
        (ns, nb, wq, bq, wo, bo), qg = p, None
    else:
        raise ValueError(f"cross parameters: expected 7 (with the q gamma) "
                         f"or, without rms, 6 tensors; got {len(p)}")
    return ns, nb, wq, bq, qg if rms else None, wo, bo


def cross_sublayer_reference(x, p1, kv1, p2=None, kv2=None, *,
                             num_heads: int, rms: bool = False,
                             compute_dtype=torch.bfloat16,
                             quant: bool = False):
    """One, or two chained, un-gated cross-attention sublayers, the residual
    kept in fp32 between them. p_i = (norm_scale, norm_bias, wq [C, C], bq,
    [qg,] wo [C, C], bo); kv_i = (k, v), each [B, Lk_i, C] (or
    [B, Lk_i, H, D]); with quant=True kv_i is an int8 cache (k, v, ks_t
    [B, H, Lk], vs [B, Lk, H]) that this oracle dequantizes first, as the
    JAX one. rms=True RMS-normalizes q (fp32) with qg before it rounds."""
    B, L, C = x.shape
    D = C // num_heads
    dt = compute_dtype
    if quant:
        kv1 = _dequantize_pair(kv1, dt)
        kv2 = None if kv2 is None else _dequantize_pair(kv2, dt)

    def one(xf, p, kv):
        ns, nb, wq, bq, qg, wo, bo = _cross_params(p, rms)
        k, v = kv
        h = _layernorm_f32(xf) * _f(ns) + _f(nb)
        q = _rd(h, dt) @ _rd(wq, dt) + _f(bq)
        if rms:
            q = _rms(q, qg, num_heads)
        qh = _rd(q, dt).reshape(B, L, num_heads, D)
        kh = _rd(k, dt).reshape(B, -1, num_heads, D)
        vh = _rd(v, dt).reshape(B, -1, num_heads, D)
        s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * D ** -0.5
        p_ = torch.softmax(s, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", _rd(p_, dt), vh)
        out = _rd(attn.reshape(B, L, C), dt) @ _rd(wo, dt)
        return xf + out + _f(bo)

    xf = one(_f(x), p1, kv1)
    if p2 is not None:
        xf = one(xf, p2, kv2)
    return xf.to(x.dtype)


def cross_sublayer_q8_reference(x, p1, kv1, p2=None, kv2=None, *,
                                num_heads: int, rms: bool = False,
                                compute_dtype=torch.bfloat16,
                                q_block: int = 0):
    """The int8 form's own arithmetic (JAX `_packed_attention`'s int8 branch
    in `_cross_sublayer_kernel`): per context, q (fp32, RMS-normalized with
    `rms` first, as `_rms_norm_lanes` precedes it) is quantized per
    (cell of `q_block` rows, 0 = all L, head) as round(q * (127 / qs)) with
    qs = max|q| floored at 1e-8; the scores are int8 x int8 sums (exact in
    fp32), s = si * (ks * (qs * scale * log2 e / 127)) - 30 and P =
    exp2(s); V is dequantized in compute_dtype as v * vs, P is rounded to
    compute_dtype for P V, and the output divides by the fp32 row sum.
    kv_i = (k int8 [B, Lk, C], v int8, ks_t bf16 [B, H, Lk], vs bf16
    [B, Lk, H])."""
    B, L, C = x.shape
    H, D = num_heads, C // num_heads
    dt = compute_dtype
    qb = q_block or L
    if L % qb:
        raise ValueError(f"q_block {qb} does not divide {L} rows")
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    scale, log2e, n127 = f32(D ** -0.5), f32(_LOG2E), f32(127.0)

    def one(xf, p, kv):
        ns, nb, wq, bq, qg, wo, bo = _cross_params(p, rms)
        k8, v8, ks_t, vs = kv
        lk = k8.shape[1]
        h = _layernorm_f32(xf) * _f(ns) + _f(nb)
        q = _rd(h, dt) @ _rd(wq, dt) + _f(bq)
        if rms:
            q = _rms(q, qg, H)
        q = q.reshape(B, L // qb, qb, H, D)
        qs = q.abs().amax((2, 4), keepdim=True).clamp_min(1e-8)
        qi = torch.round(q * (n127 / qs)).reshape(B, L, H, D)
        si = torch.einsum("bqhd,bkhd->bhqk", qi,
                          k8.float().reshape(B, lk, H, D))
        f = (qs * scale * log2e / n127).reshape(B, L // qb, H)
        f = f.repeat_interleave(qb, 1).transpose(1, 2)[..., None]  # [B,H,L,1]
        s = si * (ks_t.float()[:, :, None, :] * f) - _SHIFT
        p_ = torch.exp2(s)
        del s, si
        denom = p_.sum(-1).transpose(1, 2)[..., None]  # [B, L, H, 1]
        vh = (v8.reshape(B, lk, H, D).to(dt) * vs.to(dt)[..., None]).float()
        o = torch.einsum("bhqk,bkhd->bqhd", _rd(p_, dt), vh)
        attn = (o / denom.clamp_min(1e-30)).reshape(B, L, C)
        return xf + (_rd(attn, dt) @ _rd(wo, dt) + _f(bo))

    xf = one(_f(x), p1, kv1)
    if p2 is not None:
        xf = one(xf, p2, kv2)
    return xf.to(x.dtype)


def mlp_sublayer_reference(x, sh, sc, gate, w1, b1, w2, b2,
                           compute_dtype=torch.bfloat16):
    """x [B, L, C]; sh/sc/gate [B, C]; w1 [C, M]; w2 [M, C]; gelu (tanh)."""
    dt = compute_dtype
    xf = _f(x)
    h = _layernorm_f32(xf) * (1.0 + _f(sc)[:, None]) + _f(sh)[:, None]
    m = _rd(h, dt) @ _rd(w1, dt)
    m = torch.nn.functional.gelu(m + _f(b1), approximate="tanh")
    out = _rd(m, dt) @ _rd(w2, dt) + _f(b2)
    return (xf + out * _f(gate)[:, None]).to(x.dtype)


# -- kernel wrappers ------------------------------------------------------------


def _use_kernel(x: torch.Tensor, impl: Optional[str]) -> bool:
    if impl == "plain":
        return False
    if impl is not None:
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    return x.is_cuda


# scores per chunk of the backward's recomputation ([rows, H, Lq, Lk] fp32:
# 512 MB, as fused_attention.attention_backward's)
_BWD_SCORES = 1 << 27


class _Fused(torch.autograd.Function):
    """A sublayer's forward (its kernel chain on CUDA, its plain version on
    the CPU) with the JAX custom_vjp's backward: the vjp of the float
    oracle (`oracle`, the JAX package's `*_reference` at the rounding points
    of compute_dtype) recomputed under torch's autograd from the saved
    inputs. `divs[i]` says how tensor i follows the batch rows of x: 0, a
    parameter shared by every row; d, one row of it for every d rows of x
    (1: x itself, a KV cache; mod_repeat: the modulation). The
    recomputation runs in chunks of `rows` rows of x (a multiple of every
    d), the shared gradients summed in fp32 over the chunks; a tensor that
    needs no gradient (int8 caches, None) gets none."""

    @staticmethod
    def forward(ctx, run, oracle, divs, rows, *tensors):
        ctx.oracle, ctx.divs, ctx.rows = oracle, divs, rows
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            return run(*tensors)

    @staticmethod
    def backward(ctx, gy):
        tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        wrt = [i for i, n in enumerate(need) if n]
        grads = [None] * len(tensors)
        for i in wrt:
            t = tensors[i]
            grads[i] = (torch.zeros_like(t) if ctx.divs[i] else
                        torch.zeros(t.shape, device=t.device))
        total = gy.shape[0]
        for r0 in range(0, total, ctx.rows):
            r1 = min(total, r0 + ctx.rows)
            ins = []
            for t, d, n in zip(tensors, ctx.divs, need):
                if t is not None:
                    t = (t[r0 // d:r1 // d] if d else t).detach()
                    t.requires_grad_(n)
                ins.append(t)
            with torch.enable_grad():
                y = ctx.oracle(*ins)
                gs = torch.autograd.grad(y, [ins[i] for i in wrt], gy[r0:r1],
                                         allow_unused=True)
            for i, g in zip(wrt, gs):
                if g is None:
                    continue
                d = ctx.divs[i]
                if d:
                    grads[i][r0 // d:r1 // d] = g
                else:
                    grads[i] += g.float()
        for i in wrt:
            grads[i] = grads[i].to(tensors[i].dtype)
        return (None, None, None, None, *grads)


def _chunk_rows(total: int, unit: int, per_row: int) -> int:
    """Rows of x a backward chunk takes: as many as keep `per_row` scores a
    row under _BWD_SCORES, a multiple of `unit`, at least one unit."""
    n = max(1, _BWD_SCORES // max(per_row, 1)) // unit * unit
    return min(total, max(unit, n))


def _fused(run, oracle, tensors, divs, rows):
    """y = run(*tensors) with oracle's vjp as its gradient (see _Fused);
    straight to `run` when no tensor needs a gradient."""
    if not (torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors)):
        return run(*tensors)
    return _Fused.apply(run, oracle, divs, rows, *tensors)


def _ptr(t: torch.Tensor):
    return t.data_ptr()


def _vec(a: torch.Tensor, n: int) -> torch.Tensor:
    a = a.contiguous()
    if a.numel() != n:
        raise ValueError(f"expected {n} elements, got shape {tuple(a.shape)}")
    return a


def _weight(w: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """[in=k, out=n] weight -> the contiguous [out, in] the kernel reads
    (free for the .t() view of an nn.Linear weight)."""
    if tuple(w.shape) != (k, n):
        raise ValueError(f"expected weight [{k}, {n}], got {tuple(w.shape)}")
    w = w.t().contiguous()
    # the GEMM reads weight rows in 16-byte vectors
    return w if w.data_ptr() % 16 == 0 else w.clone()


def _mod_rows(B: int, mod_repeat: int) -> int:
    if mod_repeat < 1 or B % mod_repeat:
        raise ValueError(f"{B} row blocks do not split into groups of "
                         f"mod_repeat={mod_repeat}")
    return B // mod_repeat


def _check_cuda(compute_dtype, num_heads: Optional[int], C: int,
                row_blocks: int, *tensors: torch.Tensor) -> int:
    """What the kernels take: bf16 CUDA tensors, C a multiple of 8, heads
    of a width that divides 128 (the rules' widths), at most 65535
    attention row blocks (a grid limit). Returns the heads' card width
    (sublayer_card_width; 0 without heads)."""
    if compute_dtype != torch.bfloat16:
        raise TypeError("the CUDA sublayer kernels compute in bfloat16 only; "
                        f"got compute_dtype={compute_dtype}")
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise TypeError("the CUDA sublayer kernels take bfloat16 CUDA "
                            f"tensors; got {t.dtype} on {t.device}")
    if C % 8:
        raise ValueError(f"channels must be a multiple of 8, got {C}")
    if row_blocks > 65535:
        raise ValueError(f"{row_blocks} attention row blocks exceed 65535")
    return 0 if num_heads is None else _card_width(C, num_heads)


def _card_width(C: int, num_heads: int) -> int:
    if C % num_heads or C // num_heads not in SUBLAYER_WIDTHS:
        raise ValueError(f"head width must divide 128, one of "
                         f"{SUBLAYER_WIDTHS}; got {C}/{num_heads}")
    return sublayer_card_width(C // num_heads)


def _rep(a: torch.Tensor, mod_repeat: int) -> torch.Tensor:
    return a.repeat_interleave(mod_repeat, 0) if mod_repeat > 1 else a


def _ptr_or_null(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# -- heads narrower than the kernels' 32 lanes: zero-padded in the weights ----


def _widen(t: Optional[torch.Tensor], dim: int, d: int,
           w: int) -> Optional[torch.Tensor]:
    """t with each run of d entries along dim (one head's; the heads in
    order) zero-padded to w entries: a new contiguous tensor; t itself
    (or None) at d == w."""
    if t is None or d == w:
        return t
    dim %= t.dim()
    t = t.unflatten(dim, (-1, d))
    out = t.new_zeros(*t.shape[:dim + 1], w, *t.shape[dim + 2:])
    out.narrow(dim + 1, 0, d).copy_(t)
    return out.flatten(dim, dim + 1)


def widen_heads(t: torch.Tensor, head_dim: int, dim: int = -1):
    """t with each head's head_dim entries along dim zero-padded to the
    kernels' card width (sublayer_card_width): K3's caches [B, Lk, C] ->
    [B, Lk, Cp] (Cp = H * card width), a qkv projection [..., 3C] ->
    [..., 3 Cp]; t itself from 32 lanes up."""
    return _widen(t, dim, head_dim, sublayer_card_width(head_dim))


def widen_self_weights(wqkv, bqkv, qg, kg, wo, num_heads: int):
    """The self and temporal sublayers' head-holding parameters with each
    head zero-padded to its card width (Cp = H * card width): wqkv
    [C, 3C] -> [C, 3 Cp], bqkv [3 Cp], the lane gammas qg, kg [Cp] (None
    stays None), wo [C, C] -> [Cp, C]. The weights are transposed views of
    contiguous [out, in] tensors, as the kernels read them. With the scale
    D ** -0.5 the sublayer computes the same function (module docstring);
    unchanged from 32 lanes up."""
    d = wo.shape[0] // num_heads
    w = sublayer_card_width(d)
    if d == w:
        return wqkv, bqkv, qg, kg, wo
    return (_widen(wqkv.t(), 0, d, w).t(), _widen(bqkv, 0, d, w),
            _widen(qg, 0, d, w), _widen(kg, 0, d, w),
            _widen(wo.t(), 1, d, w).t())


def widen_cross_params(p, num_heads: int, rms: bool):
    """A cross context's parameters (ns, nb, wq, bq, [qg,] wo, bo) as
    (ns, nb, wq [C, Cp], bq [Cp], qg [Cp] or None without rms, wo [Cp, C],
    bo): each head zero-padded as widen_self_weights pads them."""
    ns, nb, wq, bq, qg, wo, bo = params = _cross_params(p, rms)
    d = wo.shape[0] // num_heads
    w = sublayer_card_width(d)
    if d == w:
        return params
    return (ns, nb, _widen(wq.t(), 0, d, w).t(), _widen(bq, 0, d, w),
            _widen(qg, 0, d, w), _widen(wo.t(), 1, d, w).t(), bo)


def _narrow_heads(o: torch.Tensor, num_heads: int, d: int) -> torch.Tensor:
    """[..., H W] -> the first d lanes of each head, [..., H d]."""
    w = o.shape[-1] // num_heads
    return o if w == d else o.unflatten(-1, (num_heads, w))[..., :d] \
        .flatten(-2)


def _self_args(sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo, rows: int,
               num_heads: int, rms: bool):
    """The self sublayers' parameters as their C entries take them: the
    modulation [rows, C] each, wqkv [3 Cp, C], bqkv [3 Cp], the gammas
    [Cp] (None without rms), wo [C, Cp], bo [C]; each head at its card
    width (widen_self_weights). The caller keeps the tuple alive until its
    launch."""
    C = wo.shape[1]
    wqkv, bqkv, qg, kg, wo = widen_self_weights(
        wqkv, bqkv, qg if rms else None, kg if rms else None, wo, num_heads)
    Cp = wo.shape[0]
    return (_vec(sh, rows * C), _vec(sc, rows * C), _vec(gate, rows * C),
            _weight(wqkv, C, 3 * Cp), _vec(bqkv, 3 * Cp),
            *(None if g is None else _vec(g, Cp) for g in (qg, kg)),
            _weight(wo, Cp, C), _vec(bo, C))


def fused_self_sublayer(x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo, *,
                        num_heads: int, rms: bool = True,
                        compute_dtype=torch.bfloat16, seg: int = 0,
                        mod_repeat: int = 1, quant_qk: bool = False,
                        impl: Optional[str] = None):
    """Modulated self-attention sublayer over L. x [B, L, C];
    sh/sc/gate [B // mod_repeat, C]: row block i reads modulation row
    i // mod_repeat (the frames of one sample share a timestep). rms: the
    q/k RMS norms with the lane gammas qg/kg (unread without it).
    seg > 1: the rows are `seg` interleaved streams, row r = t * seg + n
    attending only the rows of its n (L a multiple of seg on the card,
    where it runs K2's chain on the [B, L / seg, seg, C] view).
    quant_qk=True: int8 QK with per-(frame, head) scales; see
    self_sublayer_qk8_reference. Under autograd the backward is JAX's:
    the float oracle's vjp, the modulation's gradient summed over the rows
    that share it."""
    B, L, C = x.shape
    mr = mod_repeat
    kw = dict(num_heads=num_heads, rms=rms, compute_dtype=compute_dtype,
              seg=seg)

    def oracle(x, sh, sc, gate, *w):
        return self_sublayer_reference(x, _rep(sh, mr), _rep(sc, mr),
                                       _rep(gate, mr), *w, **kw)

    if not _use_kernel(x, impl):
        ref = self_sublayer_qk8_reference if quant_qk else \
            self_sublayer_reference

        def run(x, sh, sc, gate, *w):
            return ref(x, _rep(sh, mr), _rep(sc, mr), _rep(gate, mr), *w,
                       **kw)

    else:
        _mod_rows(B, mr)

        def run(*ts):
            return _self_kernel(*ts, num_heads=num_heads, rms=rms,
                                compute_dtype=compute_dtype, seg=seg,
                                mod_repeat=mr, quant_qk=quant_qk)

    rows = _chunk_rows(B, mr, num_heads * L * L)
    return _fused(run, oracle, (x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo),
                  (1, mr, mr, mr, 0, 0, 0, 0, 0, 0), rows)


def _self_kernel(x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo, *,
                 num_heads: int, rms: bool, compute_dtype, seg: int,
                 mod_repeat: int, quant_qk: bool):
    """K1's chain on the card; with seg > 1, K2's on the [B, L / seg, seg,
    C] view (the same function: attention over the L / seg rows of each
    stream), the modulation expanded to one row a batch row and, for
    quant_qk, one scale cell a batch row (a voxel group of seg)."""
    from .. import _ext

    B, L, C = x.shape
    Bm = _mod_rows(B, mod_repeat)
    W = _check_cuda(compute_dtype, num_heads, C, B, x, sh, sc, gate, wqkv,
                    bqkv, wo, bo, *((qg, kg) if rms else ()))
    D = C // num_heads
    if seg > 1:
        if L % seg:
            raise ValueError(f"seg {seg} does not divide {L} rows")
        y = _temporal_kernel(
            x.reshape(B, L // seg, seg, C), _rep(sh, mod_repeat),
            _rep(sc, mod_repeat), _rep(gate, mod_repeat), wqkv, bqkv, qg, kg,
            wo, bo, num_heads=num_heads, rms=rms, quant_qk=quant_qk,
            voxel_group=seg)
        launch_counts[launch_key("self_seg_q8" if quant_qk else "self_seg",
                                 D)] += 1
        return y.reshape(B, L, C)
    x = x.contiguous()
    args = _self_args(sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo, Bm,
                      num_heads, rms)
    Cp = num_heads * W
    y = torch.empty_like(x)
    h = torch.empty(B * L, C, device=x.device, dtype=torch.bfloat16)
    # the int8-QK form quantizes the fp32 projection; the float form's
    # projection writes q/k (normed) and v in bf16
    qkv = torch.empty(B * L, 3 * Cp, device=x.device,
                      dtype=torch.float32 if quant_qk else torch.bfloat16)
    attn = torch.empty(B * L, Cp, device=x.device, dtype=torch.bfloat16)
    if quant_qk:
        q8 = _qk8_scratch(B * L, B, Cp, num_heads, x.device)
        _ext.call("gvf_self_sublayer_q8", _ptr(x), *map(_ptr_or_null, args),
                  _ptr(y), _ptr(h), _ptr(qkv), *map(_ptr, q8), _ptr(attn), B,
                  L, C, num_heads, mod_repeat)
        launch_counts[launch_key("self_q8", D)] += 1
        return y
    _ext.call("gvf_self_sublayer", _ptr(x), *map(_ptr_or_null, args),
              _ptr(y), _ptr(h), _ptr(qkv), _ptr(attn), B, L, C, num_heads,
              mod_repeat)
    launch_counts[launch_key("self", D)] += 1
    return y


def _qk8_scratch(rows: int, cells: int, C: int, H: int, device):
    """int8 q and k [rows, C] and their fp32 scales [cells, H]."""
    i8 = lambda: torch.empty(rows, C, device=device, dtype=torch.int8)
    f32 = lambda: torch.empty(cells, H, device=device, dtype=torch.float32)
    return i8(), i8(), f32(), f32()


def fused_temporal_sublayer(x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo, *,
                            num_heads: int, rms: bool = True,
                            compute_dtype=torch.bfloat16,
                            quant_qk: bool = False,
                            voxel_group: Optional[int] = None,
                            impl: Optional[str] = None):
    """Modulated self-attention over T on the native [B, T, N, C] layout;
    sh/sc/gate [B, C]; rms as fused_self_sublayer. quant_qk=True: int8 QK
    with scales per (batch row, group of `voxel_group` voxels, head), the
    group defaulting to temporal_voxel_group(N); see
    temporal_sublayer_qk8_reference. Under autograd the backward is JAX's
    (the float oracle's vjp)."""
    B, T, N, C = x.shape
    kw = dict(num_heads=num_heads, rms=rms, compute_dtype=compute_dtype)

    def oracle(*ts):
        return temporal_sublayer_reference(*ts, **kw)

    if not _use_kernel(x, impl):
        def run(*ts):
            if quant_qk:
                return temporal_sublayer_qk8_reference(
                    *ts, **kw, voxel_group=voxel_group)
            return oracle(*ts)

    else:
        def run(*ts):
            _check_cuda(compute_dtype, num_heads, C, B * N, *ts[:6],
                        *ts[8:], *(ts[6:8] if rms else ()))
            y = _temporal_kernel(*ts, num_heads=num_heads, rms=rms,
                                 quant_qk=quant_qk, voxel_group=voxel_group)
            launch_counts[launch_key("temporal_q8" if quant_qk else
                                     "temporal", C // num_heads)] += 1
            return y

    rows = _chunk_rows(B, 1, num_heads * N * T * T)
    return _fused(run, oracle, (x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo),
                  (1, 1, 1, 1, 0, 0, 0, 0, 0, 0), rows)


def _temporal_kernel(x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo, *,
                     num_heads: int, rms: bool, quant_qk: bool,
                     voxel_group: Optional[int]):
    """K2's chain on the card (x [B, T, N, C], sh/sc/gate [B, C]; the
    caller checks the tensors and counts the launch)."""
    from .. import _ext

    B, T, N, C = x.shape
    x = x.contiguous()
    args = _self_args(sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo, B,
                      num_heads, rms)
    Cp = num_heads * _card_width(C, num_heads)
    y = torch.empty_like(x)
    R = B * T * N
    h = torch.empty(R, C, device=x.device, dtype=torch.bfloat16)
    # as the self sublayer's: fp32 for the int8-QK form, bf16 q/k (normed)
    # and v for the float form
    qkv = torch.empty(R, 3 * Cp, device=x.device,
                      dtype=torch.float32 if quant_qk else torch.bfloat16)
    attn = torch.empty(R, Cp, device=x.device, dtype=torch.bfloat16)
    ptrs = tuple(map(_ptr_or_null, args))
    if quant_qk:
        nc = voxel_group or temporal_voxel_group(N)
        if N % nc:
            raise ValueError(f"voxel group {nc} does not divide {N} voxels")
        q8 = _qk8_scratch(R, B * (N // nc), Cp, num_heads, x.device)
        _ext.call("gvf_temporal_sublayer_q8", _ptr(x), *ptrs, _ptr(y),
                  _ptr(h), _ptr(qkv), *map(_ptr, q8), _ptr(attn), B, T, N, C,
                  num_heads, nc)
        return y
    _ext.call("gvf_temporal_sublayer", _ptr(x), *ptrs, _ptr(y), _ptr(h),
              _ptr(qkv), _ptr(attn), B, T, N, C, num_heads)
    return y


CrossParams = Tuple[torch.Tensor, ...]


def fused_cross_sublayer(x, p1: CrossParams, kv1: Sequence[torch.Tensor],
                         p2: Optional[CrossParams] = None,
                         kv2: Optional[Sequence[torch.Tensor]] = None, *,
                         num_heads: int, rms: bool = False,
                         compute_dtype=torch.bfloat16, quant: bool = False,
                         q_block: int = 0, impl: Optional[str] = None):
    """Un-gated cross-attention sublayers with affine pre-norms against the
    cached KV: two chained (the DiT's image then static-GS conditioning)
    or one (p2 = kv2 = None: the SLat torso's image conditioning; on the
    card in bf16, or in fp32 at compute_dtype=float32). x [B, L, C]; see
    cross_sublayer_reference. rms=True: q RMS-normed with each p_i's qg. quant=True: an int8 cache,
    kv_i = (k, v, ks_t, vs) from quantize_kv with the k scales transposed to
    [B, H, Lk], q quantized per `q_block` rows (0: all L); see
    cross_sublayer_q8_reference. Under autograd the backward is JAX's:
    the float oracle's vjp, through the dequantized cache for an int8 one,
    which gets no gradient."""
    if quant:  # the int8 cache gets no gradient, its scales none either
        kv1 = tuple(t.detach() for t in kv1)
        kv2 = None if kv2 is None else tuple(t.detach() for t in kv2)
    ctxs = ((p1, kv1),) if p2 is None else ((p1, kv1), (p2, kv2))
    sizes = [(len(p), len(kv)) for p, kv in ctxs]
    flat = (x, *[t for p, kv in ctxs for t in (*p, *kv)])

    def unflat(ts):
        out, i = [], 1
        for n_p, n_kv in sizes:
            out += [tuple(ts[i:i + n_p]), tuple(ts[i + n_p:i + n_p + n_kv])]
            i += n_p + n_kv
        return ts[0], out + [None] * (4 - len(out))

    kw = dict(num_heads=num_heads, rms=rms, compute_dtype=compute_dtype)

    def oracle(*ts):
        x, (p1, kv1, p2, kv2) = unflat(ts)
        return cross_sublayer_reference(x, p1, kv1, p2, kv2, **kw,
                                        quant=quant)

    if not _use_kernel(x, impl):
        def run(*ts):
            x, args = unflat(ts)
            if quant:
                return cross_sublayer_q8_reference(x, *args, **kw,
                                                   q_block=q_block)
            return oracle(*ts)
    else:
        def run(*ts):
            x, (p1, kv1, p2, kv2) = unflat(ts)
            return _cross_kernel(x, p1, kv1, p2, kv2, num_heads, rms,
                                 compute_dtype, quant, q_block)

    # every x row and cache row shares nothing with another batch row
    divs = (1, *[d for n_p, n_kv in sizes for d in (0,) * n_p + (1,) * n_kv])
    lk = sum(kv[0].shape[1] for _, kv in ctxs)
    rows = _chunk_rows(x.shape[0], 1, num_heads * x.shape[1] * lk)
    return _fused(run, oracle, flat, divs, rows)


def _cross_kernel(x, p1, kv1, p2, kv2, num_heads: int, rms: bool,
                  compute_dtype, quant: bool, q_block: int):
    """The chains of K3's forms on the card."""
    if quant:
        return _cross_q8_kernel(x, p1, kv1, p2, kv2, num_heads, rms,
                                compute_dtype, q_block)
    if p2 is None:
        if compute_dtype == torch.float32:
            return _cross_single_f32_kernel(x, p1, kv1, num_heads, rms)
        return _cross_single_kernel(x, p1, kv1, num_heads, compute_dtype,
                                    rms)
    from .. import _ext

    B, L, C = x.shape
    groups = [(_cross_params(p, rms), kv) for p, kv in ((p1, kv1),
                                                          (p2, kv2))]
    W = _check_cuda(compute_dtype, num_heads, C, B, x,
                    *[t for p, kv in groups for t in (*p, *kv)
                      if t is not None])
    D, Cp = C // num_heads, num_heads * W
    x = x.contiguous()
    # the kernel reads the copies made here: keep them alive until it runs
    kept, ctx_args = [], []
    for params, (k, v) in groups:
        lk = k.shape[1]
        ts = (*_cross_args(params, num_heads),
              *(widen_heads(a.reshape(B, lk, C), D).contiguous()
                for a in (k, v)))
        kept += ts
        ctx_args += [*map(_ptr_or_null, ts), lk]
    y = torch.empty_like(x)
    h = torch.empty(B * L, C, device=x.device, dtype=torch.bfloat16)
    q = torch.empty(B * L, Cp, device=x.device, dtype=torch.float32)
    attn = torch.empty(B * L, Cp, device=x.device, dtype=torch.bfloat16)
    mid = torch.empty(B * L, C, device=x.device, dtype=torch.float32)
    _ext.call("gvf_cross_sublayer", _ptr(x), *ctx_args, _ptr(y), _ptr(h),
              _ptr(q), _ptr(attn), _ptr(mid), B, L, C, num_heads)
    launch_counts[launch_key("cross", D)] += 1
    return y


def _cross_args(params, num_heads: int):
    """_cross_params' (ns, nb, wq, bq, qg, wo, bo) as the C entries take
    them: ns, nb [C], wq [Cp, C], bq [Cp], qg [Cp] or None, wo [C, Cp], bo
    [C], each head at its card width. The caller keeps the tuple alive
    until its launch."""
    ns, nb, wq, bq, qg, wo, bo = widen_cross_params(params, num_heads,
                                                    params[4] is not None)
    Cp, C = wo.shape
    return (_vec(ns, C), _vec(nb, C), _weight(wq, C, Cp), _vec(bq, Cp),
            None if qg is None else _vec(qg, Cp), _weight(wo, Cp, C),
            _vec(bo, C))


def _cross_single_kernel(x, p, kv, num_heads: int, compute_dtype,
                         rms: bool):
    """The single-context chain on the card. x is bf16 or fp32 (the SLat
    torso's residual stream is fp32) and y comes back in x's dtype; k and v
    may be the halves of one [B, Lk, 2C] projection: they are read in
    place, with their shared batch and row strides (from 32 lanes a head;
    narrower heads are read from widen_heads' copies). rms: q RMS-normed
    with p's qg in the attention's prologue."""
    from .. import _ext

    B, L, C = x.shape
    k, v = (a.reshape(B, a.shape[1], C) for a in kv)
    x_f32 = x.dtype == torch.float32
    if not x.is_cuda or not (x_f32 or x.dtype == torch.bfloat16):
        raise TypeError("the single-context cross kernel takes a bf16 or "
                        f"fp32 CUDA x; got {x.dtype} on {x.device}")
    params = _cross_params(p, rms)
    W = _check_cuda(compute_dtype, num_heads, C, B,
                    *[t for t in params if t is not None], k, v)
    D = C // num_heads
    k, v = widen_heads(k, D), widen_heads(v, D)
    if k.stride()[:2] != v.stride()[:2] or k.stride(2) != 1 \
            or v.stride(2) != 1:
        raise ValueError("k and v must share batch and row strides, with "
                         f"channels contiguous; got {k.stride()}, "
                         f"{v.stride()}")
    x = x.contiguous()
    args = _cross_args(params, num_heads)
    Cp = num_heads * W
    y = torch.empty_like(x)
    h = torch.empty(B * L, C, device=x.device, dtype=torch.bfloat16)
    q = torch.empty(B * L, Cp, device=x.device, dtype=torch.float32)
    attn = torch.empty(B * L, Cp, device=x.device, dtype=torch.bfloat16)
    _ext.call("gvf_cross_sublayer1", _ptr(x), *map(_ptr_or_null, args),
              _ptr(k), _ptr(v), k.shape[1], k.stride(0), k.stride(1), _ptr(y),
              _ptr(h), _ptr(q), _ptr(attn), B, L, C, num_heads, int(x_f32))
    launch_counts[single_launch_key(torch.bfloat16, D, rms=rms)] += 1
    return y


def _check_f32(num_heads: int, C: int, B: int, *tensors) -> int:
    """What the fp32 single-context chain takes: fp32 CUDA tensors, C a
    multiple of 8, heads of a width that divides 128, at most 65535 batch
    rows. Returns the heads' card width."""
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32:
            raise TypeError("the fp32 single-context cross kernel takes fp32 "
                            f"CUDA tensors; got {t.dtype} on {t.device}")
    if C % 8:
        raise ValueError(f"channels must be a multiple of 8, got {C}")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535")
    return _card_width(C, num_heads)


def _cross_single_f32_kernel(x, p, kv, num_heads: int, rms: bool):
    """The single-context chain at compute_dtype=float32 on the card: x,
    every parameter and k/v fp32 CUDA tensors (nothing is cast to reach the
    bf16 chain); y fp32. k and v may be the halves of one [B, Lk, 2C]
    projection, read in place (from 32 lanes a head). rms: q RMS-normed in
    fp32 with p's qg."""
    from .. import _ext

    B, L, C = x.shape
    k, v = (a.reshape(B, a.shape[1], C) for a in kv)
    params = _cross_params(p, rms)
    W = _check_f32(num_heads, C, B, x, k, v,
                   *[t for t in params if t is not None])
    D, Cp = C // num_heads, num_heads * W
    k, v = widen_heads(k, D), widen_heads(v, D)
    if k.stride()[:2] != v.stride()[:2] or k.stride(2) != 1 \
            or v.stride(2) != 1 or k.stride(0) % 4 or k.stride(1) % 4 \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must share batch and row strides, with "
                         "channels contiguous and rows on 16-byte "
                         f"boundaries; got {k.stride()}, {v.stride()}")
    x = x.contiguous()
    args = _cross_args(params, num_heads)
    y = torch.empty_like(x)
    # the LN and attention outputs as their two tf32 halves, the weights'
    # halves, q (the 3xTF32 GEMMs' operands)
    h = torch.empty(2, B * L, C, device=x.device, dtype=torch.float32)
    attn = torch.empty(2, B * L, Cp, device=x.device, dtype=torch.float32)
    q = torch.empty(B * L, Cp, device=x.device, dtype=torch.float32)
    wsplit = torch.empty(4, Cp * C, device=x.device, dtype=torch.float32)
    _ext.call("gvf_cross_sublayer1_f32", _ptr(x), *map(_ptr_or_null, args),
              _ptr(k), _ptr(v), k.shape[1], k.stride(0), k.stride(1), _ptr(y),
              _ptr(h), _ptr(q), _ptr(attn), _ptr(wsplit), B, L, C, num_heads)
    launch_counts[single_launch_key(torch.float32, D, rms=rms)] += 1
    return y


def _cross_q8_kernel(x, p1, kv1, p2, kv2, num_heads: int, rms: bool,
                     compute_dtype, q_block: int):
    """The int8 form on the card: the DiT's two contexts (x bf16), or one
    (p2 = None; x bf16 or fp32, y in x's dtype)."""
    from .. import _ext

    B, L, C = x.shape
    H = num_heads
    qb = q_block or L
    single = p2 is None
    groups = [(_cross_params(p, rms), kv)
              for p, kv in ((p1, kv1),) + (() if single else ((p2, kv2),))]
    x_f32 = single and x.dtype == torch.float32
    W = _check_cuda(compute_dtype, num_heads, C, B, *(() if x_f32 else (x,)),
                    *[t for p, _ in groups for t in p if t is not None])
    D, Cp = C // H, H * W
    if x_f32 and not x.is_cuda:
        raise TypeError(f"x must be a CUDA tensor; got {x.device}")
    if L % qb:
        raise ValueError(f"q_block {qb} does not divide {L} rows")
    x = x.contiguous()
    # the kernel reads the copies made here: keep them alive until it runs
    kept, ctx_args = [], []
    for params, (kq, vq, ks_t, vs) in groups:
        lk = kq.shape[1]
        for t, dtype, shape in ((kq, torch.int8, (B, lk, C)),
                                (vq, torch.int8, (B, lk, C)),
                                (ks_t, torch.bfloat16, (B, H, lk)),
                                (vs, torch.bfloat16, (B, lk, H))):
            if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != shape:
                raise TypeError(f"int8 cache entry must be {dtype} CUDA "
                                f"{shape}; got {t.dtype} {tuple(t.shape)} "
                                f"on {t.device}")
        ts = (*_cross_args(params, H),
              *(widen_heads(a, D).contiguous() for a in (kq, vq)),
              ks_t.contiguous(), vs.contiguous())
        kept += ts
        ctx_args += [*map(_ptr_or_null, ts), lk]
    R = B * L
    y = torch.empty_like(x)
    h = torch.empty(R, C, device=x.device, dtype=torch.bfloat16)
    q = torch.empty(R, Cp, device=x.device, dtype=torch.float32)
    qi = torch.empty(R, Cp, device=x.device, dtype=torch.int8)
    qs = torch.empty(R // qb, H, device=x.device, dtype=torch.float32)
    attn = torch.empty(R, Cp, device=x.device, dtype=torch.bfloat16)
    if single:
        _ext.call("gvf_cross_sublayer1_q8", _ptr(x), *ctx_args, _ptr(y),
                  _ptr(h), _ptr(q), _ptr(qi), _ptr(qs), _ptr(attn), B, L, C,
                  H, qb, int(x_f32))
        launch_counts[single_launch_key(torch.bfloat16, D, quant=True)] += 1
        return y
    mid = torch.empty(R, C, device=x.device, dtype=torch.float32)
    _ext.call("gvf_cross_sublayer_q8", _ptr(x), *ctx_args, _ptr(y), _ptr(h),
              _ptr(q), _ptr(qi), _ptr(qs), _ptr(attn), _ptr(mid), B, L, C, H,
              qb)
    launch_counts[launch_key("cross_q8", D)] += 1
    return y


def fused_mlp_sublayer(x, sh, sc, gate, w1, b1, w2, b2, *,
                       compute_dtype=torch.bfloat16, mod_repeat: int = 1,
                       impl: Optional[str] = None):
    """Modulated MLP sublayer: x + gate * (W2 gelu_tanh(W1 mod(LN x) + b1)
    + b2). x [B, L, C]; sh/sc/gate [B // mod_repeat, C]. Under autograd the
    backward is JAX's (the oracle's vjp, the modulation's gradient summed
    over the rows that share it)."""
    mr = mod_repeat

    def oracle(x, sh, sc, gate, *w):
        return mlp_sublayer_reference(x, _rep(sh, mr), _rep(sc, mr),
                                      _rep(gate, mr), *w,
                                      compute_dtype=compute_dtype)

    if not _use_kernel(x, impl):
        run = oracle
    else:
        _mod_rows(x.shape[0], mr)

        def run(*ts):
            return _mlp_kernel(*ts, compute_dtype=compute_dtype,
                               mod_repeat=mr)

    return _fused(run, oracle, (x, sh, sc, gate, w1, b1, w2, b2),
                  (1, mr, mr, mr, 0, 0, 0, 0), x.shape[0])


def _mlp_kernel(x, sh, sc, gate, w1, b1, w2, b2, *, compute_dtype,
                mod_repeat: int):
    """K4's chain on the card."""
    from .. import _ext

    B, L, C = x.shape
    M = w1.shape[1]
    Bm = _mod_rows(B, mod_repeat)
    _check_cuda(compute_dtype, None, C, 0, x, sh, sc, gate, w1, b1, w2, b2)
    if M % 8:
        raise ValueError(f"MLP width must be a multiple of 8, got {M}")
    x = x.contiguous()
    args = (_vec(sh, Bm * C), _vec(sc, Bm * C), _vec(gate, Bm * C),
            _weight(w1, C, M), _vec(b1, M), _weight(w2, M, C), _vec(b2, C))
    y = torch.empty_like(x)
    h = torch.empty(B * L, C, device=x.device, dtype=torch.bfloat16)
    hid = torch.empty(B * L, M, device=x.device, dtype=torch.bfloat16)
    _ext.call("gvf_mlp_sublayer", _ptr(x), *map(_ptr, args), _ptr(y),
              _ptr(h), _ptr(hid), B, L, C, M, mod_repeat)
    launch_counts["mlp"] += 1
    return y


# -- the DiT block's gate to the fused path: JAX's shape rules less their
# `vmem_est` terms (the TPU kernel's VMEM residency; none on Hopper)

_LANES = 128


def self_sublayer_supports(B, L, C, num_heads) -> bool:
    """JAX `self_sublayer_supports` without its VMEM terms (vmem_est and
    the score tile's L * L * 4 bytes)."""
    return C % _LANES == 0 and _LANES % (C // num_heads) == 0 \
        and L % _LANES == 0


def temporal_sublayer_supports(B, T, N, C, num_heads) -> bool:
    """JAX `temporal_sublayer_supports` (it has no VMEM term)."""
    nc = temporal_voxel_group(N)
    L = T * nc
    return C % _LANES == 0 and _LANES % (C // num_heads) == 0 \
        and L % 8 == 0 and 128 <= L <= 1024


def cross_sublayer_supports(B, L, C, num_heads, lk1, lk2) -> bool:
    """JAX `cross_sublayer_supports` without its vmem_est term."""
    return C % _LANES == 0 and _LANES % (C // num_heads) == 0 and L % 8 == 0


def mlp_sublayer_supports(B, L, C, M) -> bool:
    """JAX `mlp_sublayer_supports` without its vmem_est term."""
    return C % _LANES == 0 and M % _LANES == 0 and L % 8 == 0
