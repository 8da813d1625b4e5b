"""Port parity: the DiT (gvfdiffusion_torch/models/dit.py) at its other
configurations against the JAX DiT on a hoisted cross-attention KV cache,
on the CPU, and the weight bridge at each configuration (the
configurations and weights: tests/_dit_configs.py; the composed path,
the gate and training: tests/test_torch_port_dit_config_paths.py).

Tolerances, each with its reason: the fused path on a hoisted float cache
rel L2 <= REL (1e-4, tests/test_torch_port_dit.py: fp32 on both sides);
the composed path on a hoisted cache (dit-rope, whose RoPE closes the
gate), float or int8, rel L2 <= COMPOSED_REL (2e-3: both round q/k/v and P
to bf16 at the same points, and ulp-level differences in the fp32 scores
flip a few of P's bf16 roundings); the int8 cache with int8 QK
(dit-rms-cross, dit-d64) rel L2 <= 2e-3 (tests/test_torch_port_selfq8.py:
a flipped int8 step moves the next block's input).
"""

import jax
import numpy as np
import pytest
import torch

from _dit_configs import (B, BASE, C, CI, CONFIGS, L, N, T, inputs,
                          jax_hoisted, pair, port_hoisted, rel, tpu_dispatch)

from gvfdiffusion_torch.ops import fused_sublayer as pfsl
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT

REL = 1e-4
COMPOSED_REL = 2e-3
INT8_REL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker while this module runs (the
    suite runs several workers at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_tpu_dispatch(monkeypatch):
    tpu_dispatch(monkeypatch)


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_hoisted_cache_matches_jax(cfg, monkeypatch, jax_tpu_dispatch):
    """GVF_FUSED=interpret, a hoisted float cache: the fused path in both
    packages, except dit-rope, which composes on the cache in both."""
    monkeypatch.setenv("GVF_FUSED", "interpret")
    model, params, port = pair(cfg)
    inp = inputs(2)
    jout = jax_hoisted(model, params, inp)
    fused = port.blocks[0].fused_supported(
        torch.zeros(B, T, N, C), port.kv_cache(
            torch.zeros(B, T, L, CI), torch.zeros(B, N, 14))[0])
    assert fused == (cfg != "dit-rope")
    pfsl.reset_launch_counts()
    pout = port_hoisted(port, inp)
    assert float(np.abs(np.asarray(jout)).mean()) > 0.1
    err = rel(pout, jout)
    print(f"{cfg} hoisted cache: rel L2 {err:.3e}")
    assert err <= (REL if fused else COMPOSED_REL), err
    assert not any(pfsl.launch_counts.values())  # the CPU launches nothing


def test_rope_composes_on_an_int8_cache(monkeypatch, jax_tpu_dispatch):
    """dit-rope on bench.py's int8 cache: JAX builds it at GVF_FUSED=
    interpret with GVF_KV_QUANT=int8, its gate closes on RoPE, and
    `_maybe_dequant` dequantizes it for the composed path; the port
    dequantizes it the same way."""
    monkeypatch.setenv("GVF_FUSED", "interpret")
    monkeypatch.setenv("GVF_KV_QUANT", "int8")
    model, params, port = pair("dit-rope")
    inp = inputs(4)
    jout = jax_hoisted(model, params, inp)
    pout = port_hoisted(port, inp, kv_quant="int8")
    pflt = port_hoisted(port, inp)
    err = rel(pout, jout)
    print(f"dit-rope int8 cache: rel L2 {err:.3e}")
    assert err <= COMPOSED_REL, err
    assert rel(pout, pflt) > 1e-5  # the cache was int8


@pytest.mark.parametrize("cfg", ["dit-rms-cross", "dit-d64"])
def test_int8_cache_and_qk_match_jax(cfg, monkeypatch):
    """GVF_KV_QUANT=int8 + GVF_SELF_QUANT=int8 at GVF_FUSED=interpret (a
    fresh JAX module: it reads GVF_SELF_QUANT while it traces) against
    kv_cache(kv_quant="int8") and self_quant="int8"."""
    monkeypatch.setenv("GVF_FUSED", "interpret")
    monkeypatch.setenv("GVF_KV_QUANT", "int8")
    monkeypatch.setenv("GVF_SELF_QUANT", "int8")
    _, params, port = pair(cfg)
    inp = inputs(5)
    jout = jax_hoisted(JaxDiT(**BASE, **CONFIGS[cfg]), params, inp)
    pout = port_hoisted(port, inp, kv_quant="int8", self_quant="int8")
    pflt = port_hoisted(port, inp)
    err = rel(pout, jout)
    print(f"{cfg} int8 cache + int8 QK: rel L2 {err:.3e}")
    assert err <= INT8_REL, err
    assert rel(pout, pflt) > 2 * err  # the int8 modes moved the output


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_weight_bridge_carries_every_parameter(cfg):
    """Every leaf of JAX's tree lands in the port's DiT, and nothing else:
    the strict load takes every port parameter, the element counts agree,
    and so does each leaf's sum of magnitudes, multiset for multiset."""
    _, params, port = pair(cfg)
    leaves = [np.asarray(a) for a in jax.tree.leaves(params)]
    tensors = [p.detach().numpy() for p in port.parameters()]
    assert len(leaves) == len(tensors)
    assert sum(a.size for a in leaves) == sum(a.size for a in tensors)
    assert sorted(float(np.abs(a).sum()) for a in leaves) == pytest.approx(
        sorted(float(np.abs(a).sum()) for a in tensors), rel=1e-6)
    names, kw = dict(port.named_parameters()), CONFIGS[cfg]
    if kw.get("qk_rms_norm_cross"):
        assert "blocks.0.image_cross_attn.q_rms_norm.gamma" in names
    if kw.get("share_mod"):
        assert "adaLN_modulation.1.weight" in names
        assert not any(".adaLN_modulation" in k for k in names
                       if k.startswith("blocks."))
    if kw.get("pe_mode") == "learnable":
        assert names["pos_embedder"].shape == (1, N, C)
