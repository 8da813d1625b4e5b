"""Transformer blocks (port of gvfdiffusion_tpu/nn/transformer.py:138-164,
167-474, 477-555).

The DiT block has the JAX block's two paths and JAX's gate between them
(:277-290): with a hoisted KV cache, no RoPE, and shapes inside each fused
kernel's rule, it takes the fused four-sublayer structure of `_fused_call`:
spatial self, temporal self (unless `no_temporal_attn`), dual cross
(against the cache) and MLP, each one call of ops/fused_sublayer.py.
Otherwise it takes the composed path (JAX :291-376): fp32 LayerNorms,
`modulate`, the attentions of nn/attention.py (K5 for spatial self and both
cross-attentions where their shapes fit its rule, K6 for the temporal one
in the native layout, the library attention elsewhere) and the gated MLP,
all under torch's autograd; a hoisted cache there serves as the
cross-attentions' K/V, an int8 one dequantized first as JAX's
`_maybe_dequant` does. The gate has two deliberate differences from JAX's,
and under both the two paths compute the same function. First, JAX's
`*_supports` rules also bound the TPU kernels' VMEM residency
(`vmem_est`), which has no counterpart on Hopper, so the port's rules
(`fsl.*_sublayer_supports`) leave those terms out and a shape past them
stays on the fused path here where JAX would compose. Second, on CUDA the
fused sublayer kernels compute in bf16 only, so a block whose compute
dtype is not bf16 (an fp32 DiT, as the infer CLI builds it) composes on
its cache there, where JAX would fuse in fp32; on the CPU the fused
path's plain versions take any dtype.
`ModulatedCrossBlock` is the single-context composed block of the
sparse-structure flow: its attentions go through
`nn/attention.MultiHeadAttention` (K5), its LayerNorms run in fp32 as the
JAX `_ln` does; `use_rope` rotates its self-attention's q/k over the token
index, and with `share_mod` it splits the model's [B, 6C] modulation.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_sublayer as fsl
from .attention import MultiHeadAttention
from .misc import dense, layer_norm


class FeedForwardNet(nn.Module):
    """Linear -> GELU(tanh) -> Linear (hidden mlp_ratio * C); the DiT block
    feeds its weights to the fused MLP sublayer."""

    def __init__(self, channels: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(channels * mlp_ratio)
        self.mlp = nn.Sequential(
            nn.Linear(channels, hidden), nn.GELU(approximate="tanh"),
            nn.Linear(hidden, channels))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = F.gelu(dense(x, self.mlp[0], dtype), approximate="tanh")
        return dense(h, self.mlp[2], dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """x [B, T, N, C]; shift/scale [B, C] broadcast over T and N."""
    return x * (1.0 + scale[:, None, None, :]) + shift[:, None, None, :]


def affine_layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax `nn.LayerNorm(dtype=float32)` with scale and bias: fp32 out."""
    return layer_norm(x, norm.eps) * norm.weight.float() + norm.bias.float()


class ModulatedCrossBlock(nn.Module):
    """Single-context block: self-attn + cross-attn + MLP with adaLN-Zero
    modulation. x [B, L, C]; mod [B, C], or with `share_mod` the model's
    pre-chunked [B, 6C]; context [B, Lc, C_ctx]. norm1 and norm3 are
    affine-free (no parameters), norm2 affine."""

    def __init__(self, channels: int, num_heads: int, mlp_ratio: float = 4.0,
                 qk_rms_norm: bool = False, qk_rms_norm_cross: bool = False,
                 ctx_channels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, use_rope: bool = False,
                 share_mod: bool = False):
        super().__init__()
        C = channels
        self.dtype = dtype
        self.share_mod = share_mod
        if not share_mod:
            self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                                  nn.Linear(C, 6 * C))
        self.norm2 = nn.LayerNorm(C, eps=1e-6)
        self.self_attn = MultiHeadAttention(C, num_heads, "self",
                                            qk_rms_norm=qk_rms_norm,
                                            use_rope=use_rope)
        self.cross_attn = MultiHeadAttention(
            C, num_heads, "cross", qk_rms_norm=qk_rms_norm_cross,
            ctx_channels=ctx_channels)
        self.mlp = FeedForwardNet(C, mlp_ratio)

    def forward(self, x: torch.Tensor, mod: torch.Tensor,
                context: torch.Tensor,
                impl: Optional[str] = None) -> torch.Tensor:
        dt = self.dtype
        m = mod if self.share_mod else dense(
            F.silu(mod), self.adaLN_modulation[1], dt)
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = (a[:, None] for a in m.chunk(6, -1))
        h = layer_norm(x, 1e-6) * (1.0 + sc_a) + sh_a
        x = x + self.self_attn(h, dt, impl=impl) * g_a
        h = affine_layer_norm(self.norm2, x)
        x = x + self.cross_attn(h, dt, context, impl=impl)
        h = layer_norm(x, 1e-6) * (1.0 + sc_m) + sh_m
        return x + self.mlp(h, dt) * g_m


class ModulatedTransformerCrossBlock(nn.Module):
    """DiT block: spatial self-attn over N, temporal self-attn over T (unless
    `no_temporal_attn`), image cross-attn, static-GS cross-attn, MLP, with
    adaLN-Zero modulation. The fields are JAX's (:180-195); `ablate` is a
    measurement-only skip there and is not ported.

    x [B, T, N, C]; mod [B, C] (the timestep embedding) or, with
    `share_mod`, the DiT's pre-chunked modulation [B, 9C] ([B, 6C] without
    temporal attention); either cross_kv = ((img_k, img_v), (static_k,
    static_v)), each [B*T, Lk, heads, head_dim], or its int8 form, from
    `kv`, or the projected conditioning cond_images [B, T, L, C] and
    static_latent [B, T, Ns, C]. Parameter names follow the reference's
    torch state dict, shared by both paths.
    """

    def __init__(self, channels: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_rope: bool = False, qk_rms_norm: bool = False,
                 qk_rms_norm_cross: bool = False, share_mod: bool = False,
                 no_temporal_attn: bool = False,
                 temporal_layout: str = "transpose",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if temporal_layout not in ("transpose", "einsum"):
            raise ValueError(f"temporal_layout must be 'transpose' or "
                             f"'einsum', got {temporal_layout!r}")
        C = channels
        self.channels = C
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.use_rope = use_rope
        self.qk_rms_norm = qk_rms_norm
        self.qk_rms_norm_cross = qk_rms_norm_cross
        self.share_mod = share_mod
        self.no_temporal_attn = no_temporal_attn
        self.temporal_layout = temporal_layout
        self.dtype = dtype
        if not share_mod:
            self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                                  nn.Linear(C, 6 * C))
            if not no_temporal_attn:
                self.adaLN_modulation_temporal = nn.Sequential(
                    nn.SiLU(), nn.Linear(C, 3 * C))
        self.spatial_self_attn = MultiHeadAttention(
            C, num_heads, "self", qk_rms_norm=qk_rms_norm, use_rope=use_rope)
        if not no_temporal_attn:
            self.temporal_self_attn = MultiHeadAttention(
                C, num_heads, "self", qk_rms_norm=qk_rms_norm,
                use_rope=use_rope)
        # norm1/norm2/norm5 are affine-free (no parameters); norm3/norm4 affine
        self.norm3 = nn.LayerNorm(C, eps=1e-6)
        self.image_cross_attn = MultiHeadAttention(
            C, num_heads, "cross", qk_rms_norm=qk_rms_norm_cross)
        self.norm4 = nn.LayerNorm(C, eps=1e-6)
        self.static_cross_attn = MultiHeadAttention(
            C, num_heads, "cross", qk_rms_norm=qk_rms_norm_cross)
        self.mlp = FeedForwardNet(C, mlp_ratio)

    def kv(self, cond_images: torch.Tensor, static_latent: torch.Tensor,
           quant: bool = False):
        """The loop-invariant cross-attention KV: cond_images [B, T, L, C],
        static_latent [B, T, Ns, C] (both already projected to C), k
        RMS-normed with `qk_rms_norm_cross`. With quant=True each context's
        cache is quantized once (JAX :234-250): (k int8, v int8, k scales
        [B*T, H, Lk], v scales [B*T, Lk, H])."""
        C = self.channels
        img = self.image_cross_attn.kv(
            cond_images.reshape(-1, cond_images.shape[2], C), self.dtype)
        static = self.static_cross_attn.kv(
            static_latent.reshape(-1, static_latent.shape[2], C), self.dtype)
        if not quant:
            return img, static

        def q8(kv):
            k, v = (a.reshape(a.shape[0], a.shape[1], C) for a in kv)
            kq, ks = fsl.quantize_kv(k, self.num_heads)
            vq, vs = fsl.quantize_kv(v, self.num_heads)
            return kq, vq, ks.transpose(1, 2).contiguous(), vs

        return q8(img), q8(static)

    def _chunks(self, mod: torch.Tensor):
        """The modulation chunks (sh_s, sc_s, g_s, sh_t, sc_t, g_t, sh_m,
        sc_m, g_m), each [B, C]; the temporal three are None without
        temporal attention."""
        if self.share_mod:
            m = mod.chunk(6 if self.no_temporal_attn else 9, dim=-1)
        else:
            m = dense(F.silu(mod), self.adaLN_modulation[1],
                      self.dtype).chunk(6, dim=-1)
            if not self.no_temporal_attn:
                m = m[:3] + dense(F.silu(mod),
                                  self.adaLN_modulation_temporal[1],
                                  self.dtype).chunk(3, dim=-1) + m[3:]
        return m[:3] + (None,) * 3 + m[3:] if self.no_temporal_attn else m

    def fused_supported(self, x: torch.Tensor, cross_kv) -> bool:
        """JAX's gate to the fused path (:277-290): a hoisted cache, no
        RoPE, and each fused kernel's shape rule, less the TPU's VMEM terms;
        on CUDA also the compute dtype bf16 (see the module docstring)."""
        if cross_kv is None or self.use_rope:
            return False
        if x.is_cuda and self.dtype != torch.bfloat16:
            return False
        B, T, N, C = x.shape
        H = self.num_heads
        return (fsl.self_sublayer_supports(B * T, N, C, H)
                and (self.no_temporal_attn or fsl.temporal_sublayer_supports(
                    B, T, N, C, H))
                and fsl.cross_sublayer_supports(
                    B * T, N, C, H, cross_kv[0][0].shape[1],
                    cross_kv[1][0].shape[1])
                and fsl.mlp_sublayer_supports(B * T, N, C,
                                              int(C * self.mlp_ratio)))

    def forward(self, x: torch.Tensor, mod: torch.Tensor, cross_kv=None,
                cond_images: Optional[torch.Tensor] = None,
                static_latent: Optional[torch.Tensor] = None,
                impl: Optional[str] = None,
                self_quant: Optional[str] = None) -> torch.Tensor:
        """self_quant="int8": the fused path's self and temporal sublayers
        take their QK in int8 (JAX :397-424); the composed path ignores
        it."""
        chunks = self._chunks(mod)
        if self.fused_supported(x, cross_kv):
            return self._fused(x, chunks, cross_kv, impl,
                               self_quant == "int8")
        return self._composed(x, chunks, cross_kv, cond_images,
                              static_latent, impl)

    def _dequantized(self, kv):
        """JAX's `_maybe_dequant`: an int8 cache entry (k, v, k scales
        [BT, H, Lk], v scales [BT, Lk, H]) -> (k, v) [BT, Lk, H, D] in the
        block's dtype; a float entry as it is."""
        if len(kv) != 4:
            return kv
        kq, vq, ks_t, vs = kv
        bt, lk = kq.shape[:2]
        H = self.num_heads
        return (fsl.dequantize_kv(kq, ks_t.transpose(1, 2)).to(
                    self.dtype).reshape(bt, lk, H, -1),
                fsl.dequantize_kv(vq, vs).to(self.dtype).reshape(
                    bt, lk, H, -1))

    def _composed(self, x, chunks, cross_kv, cond_images, static_latent,
                  impl):
        """JAX :291-376: LayerNorms in fp32, K5 and K6 computing in bf16
        (the JAX kernels' default), everything differentiable; with a
        hoisted cache the cross-attentions read it (dequantized if int8)."""
        C, dt, at = self.channels, self.dtype, torch.bfloat16
        B, T, N, _ = x.shape
        sh_s, sc_s, g_s, sh_t, sc_t, g_t, sh_m, sc_m, g_m = chunks

        h = modulate(layer_norm(x, 1e-6), sh_s, sc_s)
        h = self.spatial_self_attn(h.reshape(B * T, N, C), dt, impl=impl,
                                   attn_dtype=at).reshape(B, T, N, C)
        x = x + h * g_s[:, None, None, :]

        if not self.no_temporal_attn:
            h = modulate(layer_norm(x, 1e-6), sh_t, sc_t)
            attn = self.temporal_self_attn
            if self.temporal_layout == "einsum" and not self.use_rope:
                h = attn.temporal(h, dt, impl=impl)
            else:  # [B * N, T, C]: RoPE over the frames
                h = attn(h.transpose(1, 2).reshape(B * N, T, C), dt,
                         impl=impl, attn_dtype=at)
                h = h.reshape(B, N, T, C).transpose(1, 2)
            x = x + h * g_t[:, None, None, :]

        # the two cross-attentions: un-gated, affine pre-norms
        img_kv, static_kv = (None, None) if cross_kv is None else (
            self._dequantized(kv) for kv in cross_kv)
        for norm, attn, ctx, kv in (
                (self.norm3, self.image_cross_attn, cond_images, img_kv),
                (self.norm4, self.static_cross_attn, static_latent,
                 static_kv)):
            context = None if kv is not None else ctx.reshape(
                B * T, ctx.shape[2], C)
            h = attn(affine_layer_norm(norm, x).reshape(B * T, N, C), dt,
                     context, impl=impl, attn_dtype=at, context_kv=kv)
            x = x + h.reshape(B, T, N, C)

        h = modulate(layer_norm(x, 1e-6), sh_m, sc_m)
        return x + self.mlp(h, dt) * g_m[:, None, None, :]

    def _fused(self, x, chunks, cross_kv, impl, quant_qk: bool):
        C, H, dt = self.channels, self.num_heads, self.dtype
        B, T, N, _ = x.shape
        sh_s, sc_s, g_s, sh_t, sc_t, g_t, sh_m, sc_m, g_m = chunks
        rms, rms_cross = self.qk_rms_norm, self.qk_rms_norm_cross

        def w(a):
            return a.to(dt)

        def self_args(attn: MultiHeadAttention):
            # without the norms the sublayers read no gammas
            qg, kg = (w(g) for g in attn.gammas()) if rms else (None, None)
            return (w(attn.to_qkv.weight.t()), w(attn.to_qkv.bias), qg, kg,
                    w(attn.to_out.weight.t()), w(attn.to_out.bias))

        x = fsl.fused_self_sublayer(
            x.reshape(B * T, N, C), w(sh_s), w(sc_s), w(g_s),
            *self_args(self.spatial_self_attn), num_heads=H, rms=rms,
            compute_dtype=dt, mod_repeat=T, quant_qk=quant_qk, impl=impl,
        ).reshape(B, T, N, C)

        if not self.no_temporal_attn:
            x = fsl.fused_temporal_sublayer(
                x, w(sh_t), w(sc_t), w(g_t),
                *self_args(self.temporal_self_attn), num_heads=H, rms=rms,
                compute_dtype=dt, quant_qk=quant_qk, impl=impl)

        def cross_args(norm: nn.LayerNorm, attn: MultiHeadAttention):
            qg = (w(attn.q_rms_norm.lane_gamma()),) if rms_cross else ()
            return (w(norm.weight), w(norm.bias), w(attn.to_q.weight.t()),
                    w(attn.to_q.bias), *qg, w(attn.to_out.weight.t()),
                    w(attn.to_out.bias))

        img_kv, static_kv = cross_kv
        # an int8 cache goes in as stored; its q scales cover a cell of N
        # rows, or half of one where the JAX DiT grids the rows at the
        # 3-way CFG batch (JAX :455-458)
        quant = len(img_kv) == 4
        kv_in = (lambda kv: kv) if quant else (
            lambda kv: tuple(w(a) for a in kv))
        q_block = N // 2 if quant and B * T > 64 and N % 2 == 0 else N
        x = fsl.fused_cross_sublayer(
            x.reshape(B * T, N, C),
            cross_args(self.norm3, self.image_cross_attn), kv_in(img_kv),
            cross_args(self.norm4, self.static_cross_attn), kv_in(static_kv),
            num_heads=H, rms=rms_cross, compute_dtype=dt, quant=quant,
            q_block=q_block, impl=impl)

        l1, l2 = self.mlp.mlp[0], self.mlp.mlp[2]
        x = fsl.fused_mlp_sublayer(
            x, w(sh_m), w(sc_m), w(g_m), w(l1.weight.t()), w(l1.bias),
            w(l2.weight.t()), w(l2.bias), compute_dtype=dt, mod_repeat=T,
            impl=impl)
        return x.reshape(B, T, N, C)


class FinalLayer(nn.Module):
    """adaLN-modulated output projection (affine-free LayerNorm). Its
    modulation reads c [B, cond_channels]: the timestep embedding, or under
    the DiT's share_mod the shared modulation itself (as the JAX DiT passes
    it)."""

    def __init__(self, hidden_size: int, out_channels: int,
                 dtype: torch.dtype = torch.float32,
                 cond_channels: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(cond_channels or hidden_size,
                                 2 * hidden_size))
        self.linear = nn.Linear(hidden_size, out_channels)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        m = dense(F.silu(c), self.adaLN_modulation[1], self.dtype)
        shift, scale = m.chunk(2, dim=-1)
        # as in JAX: (1 + scale) rounds in the modulation dtype, then
        # promotes against the fp32 LayerNorm output
        h = layer_norm(x, 1e-6) * (1.0 + scale[:, None, None]) \
            + shift[:, None, None]
        return dense(h, self.linear, self.dtype)
