"""Port parity of the DiT's fused path under autograd: a 2-block DiT at a
narrow width (C = 128, 4 heads of 32, N = 128, T = 8, 20 image tokens of
64) with a hoisted cache, float and int8 (`kv_cache(kv_quant="int8")`,
JAX's GVF_KV_QUANT=int8), both building the cache inside the
differentiated function as VideoTo4DPipeline does; the loss the sum of the
output times a fixed seeded tensor; its gradients for every parameter and
for the input latent against `jax.grad` of the JAX DiT at GVF_FUSED=
interpret on the same weights (carried across by utils/weights.py, drawn
by init_random_). The port's fused sublayers run their plain forwards on
the CPU and their autograd Function's backward, the JAX custom_vjps'; an
int8 cache passes no gradient to the k/v projections (JAX's zeros), and
the port's are then None, read as 0.

Tolerance: rel L2 1e-4 of each gradient (the sublayers' fp32 bound,
tests/test_torch_port_sublayer_grad.py), 1e-3 with the int8 cache, where
a q value at a rounding midpoint in the forward may land one int8 step
apart between the two (the forward's bound there is 5e-4,
tests/test_torch_port_int8.py); the loss 1e-5 relative, 1e-3 with the
int8 cache for the same reason. Readings are printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.utils.weights import (dit_state_dict_from_flax,
                                              init_random_)
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT
from gvfdiffusion_tpu.utils.weight_convert import convert_dit

B, T, N, L, CI, C, H, BLOCKS = 1, 8, 128, 20, 64, 128, 4, 2
DIT_KW = dict(in_channels=16, model_channels=C, image_cond_channels=CI,
              num_blocks=BLOCKS, num_heads=H)
BOUNDS = {None: 1e-4, "int8": 1e-3}
LOSS_BOUNDS = {None: 1e-5, "int8": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker while this module runs (the
    suite runs several workers at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_dit_hoisted_cache_gradients_match_jax(kv_quant, monkeypatch):
    monkeypatch.setenv("GVF_FUSED", "interpret")
    if kv_quant:
        monkeypatch.setenv("GVF_KV_QUANT", "int8")
    else:
        monkeypatch.delenv("GVF_KV_QUANT", raising=False)
    sd = {k: v.numpy().copy() for k, v in init_random_(
        DiT(**DIT_KW), 0).state_dict().items()}
    flax_params = convert_dit(sd, num_blocks=BLOCKS, qk_rms_norm=True)
    port = DiT(**DIT_KW)
    port.load_state_dict(dit_state_dict_from_flax(flax_params, BLOCKS))
    r = np.random.default_rng(1)
    inp = [r.standard_normal((B, T, N, 16)).astype(np.float32),
           np.array([437.5], np.float32),
           r.standard_normal((B, T, L, CI)).astype(np.float32),
           r.standard_normal((B, N, 14)).astype(np.float32),
           r.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)]
    w = r.standard_normal((B, T, N, 16)).astype(np.float32)

    model = JaxDiT(resolution=N, **DIT_KW)
    rest = [jnp.asarray(a) for a in inp[1:]]

    def loss(params, x):
        kv = model.apply(params, x, *rest, kv_only=True)
        out = model.apply(params, x, *rest, cross_kv=kv)
        return jnp.sum(out * w)

    jl, (jg, jgx) = jax.block_until_ready(jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1)))(flax_params, jnp.asarray(inp[0])))
    want = {k: np.asarray(v, np.float32) for k, v in dit_state_dict_from_flax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jg),
        BLOCKS).items()}

    t = [torch.from_numpy(a) for a in inp]
    x = t[0].clone().requires_grad_(True)
    kv = port.kv_cache(t[2], t[3], kv_quant=kv_quant)
    assert port.blocks[0].fused_supported(torch.empty(B, T, N, C), kv[0])
    out = port(x, t[1], positions=t[4], cross_kv=kv)
    tl = (out * torch.from_numpy(w)).sum()
    tl.backward()
    tl = tl.detach()

    loss_err = abs(float(tl) - float(jl)) / abs(float(jl))
    errs = {"x": _rel(x.grad, jgx)}
    for name, p in port.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        errs[name] = _rel(g, want[name]) if np.abs(want[name]).any() \
            else float(np.abs(g).max())
    worst = max(errs, key=errs.get)
    print(f"DiT kv_quant={kv_quant}: loss {float(tl):.6f} (rel "
          f"{loss_err:.2e}), worst gradient rel L2 {errs[worst]:.2e} "
          f"({worst}), x {errs['x']:.2e}")
    assert loss_err <= LOSS_BOUNDS[kv_quant], loss_err
    assert errs[worst] <= BOUNDS[kv_quant], (worst, errs[worst])
    kv_w = [n for n in errs if ".to_kv." in n]
    assert kv_w  # the cache's projections, by name
    zero = all(not np.abs(want[n]).any() for n in kv_w)
    assert zero == (kv_quant == "int8")  # int8: no gradient through it
