"""Port parity: the DiT (gvfdiffusion_torch/models/dit.py) against the JAX
DiT, and the weight bridge between the two packages.

A 2-block DiT (C=128, 4 heads, N=128, T=8, image tokens 20 x 64) is the
smallest shape at which the JAX block's fused-sublayer gate opens. Both
packages run the same random, reference-named weights at fp32 on the CPU.
Tolerance: rel L2 <= 1e-4 on the output and on the cross-attention KV cache.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.models.motion_vae import MotionVAE
from gvfdiffusion_torch.utils.weights import (
    dit_state_dict_from_flax, init_random_, motion_vae_state_dict_from_flax)
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT
from gvfdiffusion_tpu.nn import attention as j_attention_mod
from gvfdiffusion_tpu.ops import fused_attention as j_fa
from gvfdiffusion_tpu.utils.weight_convert import (
    convert_dit, convert_motion_vae)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker while this module runs (the
    suite runs several workers at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REL = 1e-4
COMPOSED_REL = 2e-3
B, T, N, C, H, L, CI, BLOCKS = 1, 8, 128, 128, 4, 20, 64, 2
DIT_KW = dict(in_channels=16, model_channels=C, image_cond_channels=CI,
              num_blocks=BLOCKS, num_heads=H)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _random_state_dict(module, seed):
    """A reference-named torch state dict with every parameter non-zero."""
    return {k: v.numpy().copy()
            for k, v in init_random_(module, seed).state_dict().items()}


@pytest.fixture(scope="module")
def dit_pair():
    sd = _random_state_dict(DiT(**DIT_KW), seed=0)
    flax_params = convert_dit(sd, num_blocks=BLOCKS, qk_rms_norm=True)
    port = DiT(**DIT_KW)
    port.load_state_dict(dit_state_dict_from_flax(flax_params, BLOCKS))
    return flax_params, port.eval()


@pytest.fixture(scope="module")
def dit_inputs():
    r = np.random.default_rng(1)
    return dict(
        x=r.standard_normal((B, T, N, 16)).astype(np.float32),
        t=np.array([437.5], np.float32),
        cond_images=r.standard_normal((B, T, L, CI)).astype(np.float32),
        static_latent=r.standard_normal((B, N, 14)).astype(np.float32),
        positions=r.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32),
    )


def _jax_run(flax_params, inp, hoist_kv):
    model = JaxDiT(resolution=N, **DIT_KW)
    args = [jnp.asarray(inp[k]) for k in
            ("x", "t", "cond_images", "static_latent", "positions")]
    kv = model.apply(flax_params, *args, kv_only=True)
    out = model.apply(flax_params, *args, cross_kv=kv if hoist_kv else None)
    return kv, out


def _port_run(port, inp):
    args = [torch.from_numpy(inp[k]) for k in
            ("x", "t", "cond_images", "static_latent", "positions")]
    with torch.no_grad():
        kv = port(*args, kv_only=True)
        out = port(*args[:2], positions=args[4], cross_kv=kv)
    return kv, out


@pytest.mark.parametrize("fused", ["interpret", "off"])
def test_dit_matches_jax(dit_pair, dit_inputs, fused, monkeypatch):
    """GVF_FUSED=interpret: the JAX fused four-sublayer path (Pallas
    interpret mode) with the hoisted KV; GVF_FUSED=off: the composed path,
    which projects the conditioning itself."""
    monkeypatch.setenv("GVF_FUSED", fused)
    flax_params, port = dit_pair
    jkv, jout = _jax_run(flax_params, dit_inputs, hoist_kv=fused != "off")
    pkv, pout = _port_run(port, dit_inputs)
    assert pout.shape == (B, T, N, 16) and pout.dtype == torch.float32
    assert float(np.abs(np.asarray(jout)).mean()) > 0.1  # non-trivial output
    assert _rel(pout, jout) <= REL, _rel(pout, jout)
    assert len(pkv) == BLOCKS
    for jblock, pblock in zip(jkv, pkv):
        for jctx, pctx in zip(jblock, pblock):
            for ja, pa in zip(jctx, pctx):
                assert tuple(pa.shape) == tuple(ja.shape)
                assert _rel(pa, ja) <= REL, _rel(pa, ja)


def test_dit_without_hoisted_kv_is_the_same_function(dit_pair, dit_inputs,
                                                      monkeypatch):
    """Without cross_kv the port runs the composed path, JAX's at
    GVF_FUSED=off: the DiT projects the conditioning itself, and its
    attentions are K5 (heads of 32) and K6 (over T), computing in bf16 as
    the JAX kernels do on the TPU. JAX's kernels run here in interpret
    mode; the image tokens are 130 long, inside K5's rule (Lk >= 128) as
    the reference's 1374 are. Tolerance rel L2 <= COMPOSED_REL: both sides
    round q/k/v and P to bf16 at the same points, and ulp-level differences
    in the fp32 scores flip a few of P's bf16 roundings."""
    monkeypatch.setenv("GVF_FUSED", "off")
    monkeypatch.setattr(j_attention_mod, "_on_tpu", lambda: True)
    fused, temporal = j_fa.fused_attention, j_fa.temporal_attention
    monkeypatch.setattr(
        j_fa, "fused_attention",
        lambda q, k, v, scale, cd=jnp.bfloat16: fused(q, k, v, scale, cd,
                                                      True))
    monkeypatch.setattr(
        j_fa, "temporal_attention",
        lambda q, k, v, scale, cd=jnp.bfloat16: temporal(q, k, v, scale, cd,
                                                         True))
    flax_params, port = dit_pair
    inp = dict(dit_inputs, cond_images=np.random.default_rng(4).standard_normal(
        (B, T, 130, CI)).astype(np.float32))
    _, jout = _jax_run(flax_params, inp, hoist_kv=False)
    args = [torch.from_numpy(inp[k]) for k in
            ("x", "t", "cond_images", "static_latent", "positions")]
    with torch.no_grad():
        pout = port(*args)
    err = _rel(pout, jout)
    print(f"composed DiT vs JAX: rel L2 {err:.3e}")
    assert err <= COMPOSED_REL, err


def test_dit_weight_bridge_round_trip():
    """reference-named state dict -> convert_dit -> dit_state_dict_from_flax
    gives back the same dict, key for key, with nothing left over."""
    sd = _random_state_dict(DiT(**DIT_KW), seed=2)
    back = dit_state_dict_from_flax(
        convert_dit(sd, num_blocks=BLOCKS, qk_rms_norm=True), BLOCKS)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and np.array_equal(back[k].numpy(), v), k


def test_motion_vae_weight_bridge_round_trip():
    vae = MotionVAE(depth=2, dim=48, queries_dim=48, latent_dim=4, heads=4)
    sd = _random_state_dict(vae, seed=3)
    back = motion_vae_state_dict_from_flax(convert_motion_vae(sd, depth=2),
                                           depth=2)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and np.array_equal(back[k].numpy(), v), k

