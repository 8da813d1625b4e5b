"""Shared by tests/test_torch_port_dit_configs.py and
tests/test_torch_port_dit_config_paths.py: the DiT's four other
configurations at a small size, and the same non-zero weights in both
packages.

A 2-block DiT (C = 128, N = 128, T = 8, image tokens 20 x 64) at each of

  dit-rms-cross   qk_rms_norm=False, qk_rms_norm_cross=True
  dit-d64         num_heads=2 (heads of 64, as 8 heads at C = 512)
  dit-rope        pe_mode="rope", share_mod=True
  dit-notemporal  no_temporal_attn=True, pe_mode="learnable", mlp_ratio=2

The weights are JAX's `init` tree with every leaf redrawn non-zero from a
seed (the zero inits of adaLN and the final layer would hide any fault),
bridged to torch by `utils/weights.py`. `tpu_dispatch` makes JAX's
composed path reach its attention kernels as on a TPU (in interpret mode):
`gvfdiffusion_tpu.nn.attention._on_tpu` patched to True and
`fa.fused_attention` / `fa.temporal_attention` run with interpret=True, as
in tests/test_torch_port_train.py; shapes outside their rules take XLA's
attention, and the port's library counterparts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.utils.weights import dit_state_dict_from_flax
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT
from gvfdiffusion_tpu.nn import attention as j_attention
from gvfdiffusion_tpu.ops import fused_attention as jfa

B, T, N, C, L, CI, BLOCKS = 1, 8, 128, 128, 20, 64, 2
CONFIGS = {
    "dit-rms-cross": dict(num_heads=4, qk_rms_norm=False,
                          qk_rms_norm_cross=True),
    "dit-d64": dict(num_heads=2),
    "dit-rope": dict(num_heads=4, pe_mode="rope", share_mod=True),
    "dit-notemporal": dict(num_heads=4, no_temporal_attn=True,
                           pe_mode="learnable", mlp_ratio=2.0),
}
BASE = dict(resolution=N, in_channels=16, model_channels=C,
            image_cond_channels=CI, num_blocks=BLOCKS)
ORDER = ("x", "t", "cond_images", "static_latent", "positions")


def tpu_dispatch(monkeypatch):
    """The JAX composed path with its attention kernels in interpret mode,
    reached as on a TPU (undone with the monkeypatch)."""
    fused, temporal = jfa.fused_attention, jfa.temporal_attention
    monkeypatch.setattr(j_attention, "_on_tpu", lambda: True)
    monkeypatch.setattr(
        jfa, "fused_attention",
        lambda q, k, v, s, cd=jnp.bfloat16: fused(q, k, v, s, cd, True))
    monkeypatch.setattr(
        jfa, "temporal_attention",
        lambda q, k, v, s, cd=jnp.bfloat16: temporal(q, k, v, s, cd, True))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def inputs(seed, b=B, t=T, l=L):
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal((b, t, N, 16)).astype(np.float32),
        t=np.linspace(437.5, 12.0, b).astype(np.float32),
        cond_images=r.standard_normal((b, t, l, CI)).astype(np.float32),
        static_latent=r.standard_normal((b, N, 14)).astype(np.float32),
        positions=r.uniform(-0.5, 0.5, (b, N, 3)).astype(np.float32))


def nonzero(tree, seed):
    """Every leaf of a flax tree redrawn from a seed: kernels N(0, 1/fan_in),
    biases N(0, 0.1^2), LayerNorm scales and RMS gammas 1 + N(0, 0.1^2),
    the learnable position embedding N(0, 1)."""
    r = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, leaf in leaves:
        name = str(path[-1].key)
        z = r.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            z = z / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "bias":
            z = 0.1 * z
        elif name in ("scale", "gamma"):
            z = 1.0 + 0.1 * z
        out.append(jnp.asarray(z))
    return jax.tree_util.tree_unflatten(treedef, out)


PAIRS = {}


def pair(cfg):
    """(JaxDiT, its non-zero params, the port's DiT with them) of `cfg`."""
    if cfg not in PAIRS:
        model = JaxDiT(**BASE, **CONFIGS[cfg])
        inp = inputs(0, l=L)
        params = nonzero(model.init(jax.random.PRNGKey(0), *(
            jnp.asarray(inp[k]) for k in ORDER)), seed=1)
        port = DiT(**BASE, **CONFIGS[cfg])
        port.load_state_dict(dit_state_dict_from_flax(
            jax.tree.map(np.asarray, params), BLOCKS))
        PAIRS[cfg] = model, params, port.eval()
    return PAIRS[cfg]


def jax_hoisted(model, params, inp):
    args = [jnp.asarray(inp[k]) for k in ORDER]
    kv = model.apply(params, *args, kv_only=True)
    return model.apply(params, *args, cross_kv=kv)


def port_hoisted(port, inp, kv_quant=None, self_quant=None):
    a = {k: torch.from_numpy(v) for k, v in inp.items()}
    with torch.no_grad():
        kv = port.kv_cache(a["cond_images"], a["static_latent"], kv_quant)
        return port(a["x"], a["t"], positions=a["positions"], cross_kv=kv,
                    self_quant=self_quant)
