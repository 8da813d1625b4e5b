"""Port parity of the DiT's fused path (K1-K4 on a hoisted cache) at the
head widths K1-K3 now take beyond 32, 64 and 128, on the CPU, against
JAX at GVF_FUSED=interpret (its Pallas kernels in interpret mode, each
JAX call jitted and blocked on): the DiT (2 blocks, C = 128,
tests/_dit_configs.py's size, inputs and non-zero weights bridged by
utils/weights.py) at 8 heads of 16, 1 head of 128 and 32 heads of 4 (the
widths `num_heads` 32, 4 and 128 give at the shipped 512 channels) on a
hoisted float cache; and the weight bridge (utils/weights.py) at the
shipped 12 x 512 DiT's 32 and 4 heads on init_random_ weights. The int8
cache with int8 QK at heads of 16 and VideoTo4DPipeline.run at heads of
16: tests/test_torch_port_sublayer_widths_run.py.

Tolerance, the same path's at the shipped widths: rel L2 1e-4
(tests/test_torch_port_dit_configs.py: fp32 on both sides). About 55 s
alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _dit_configs import (B, BASE, BLOCKS, C, CI, L, N, ORDER, T, inputs,
                          jax_hoisted, nonzero, port_hoisted, rel,
                          tpu_dispatch)

from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.ops import fused_sublayer as pfsl
from gvfdiffusion_torch.utils.weights import (dit_state_dict_from_flax,
                                              init_random_)
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT
from gvfdiffusion_tpu.utils.weight_convert import convert_dit

REL = 1e-4
# head width -> heads at C = 128
HEADS = {16: 8, 128: 1, 4: 32}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker while this module runs (the
    suite runs several workers at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS = {}


def _pair(width):
    """(JaxDiT, its non-zero params, the port's DiT with them) at heads of
    `width`."""
    if width not in _PAIRS:
        model = JaxDiT(**BASE, num_heads=HEADS[width])
        inp = inputs(0)
        params = nonzero(model.init(jax.random.PRNGKey(0), *(
            jnp.asarray(inp[k]) for k in ORDER)), seed=1)
        port = DiT(**BASE, num_heads=HEADS[width])
        port.load_state_dict(dit_state_dict_from_flax(
            jax.tree.map(np.asarray, params), BLOCKS))
        _PAIRS[width] = model, params, port.eval()
    return _PAIRS[width]


def _fused(port):
    return port.blocks[0].fused_supported(
        torch.zeros(B, T, N, C), port.kv_cache(
            torch.zeros(B, T, L, CI), torch.zeros(B, N, 14))[0])


@pytest.mark.parametrize("width", list(HEADS))
def test_dit_fused_at_new_widths_matches_jax(width, monkeypatch):
    monkeypatch.setenv("GVF_FUSED", "interpret")
    tpu_dispatch(monkeypatch)
    model, params, port = _pair(width)
    assert port.blocks[0].spatial_self_attn.head_dim == width
    assert _fused(port)
    inp = inputs(2)
    jout = jax.block_until_ready(jax.jit(
        lambda p, i: jax_hoisted(model, p, i))(params, inp))
    pfsl.reset_launch_counts()
    pout = port_hoisted(port, inp)
    err = rel(pout, jout)
    print(f"DiT heads of {width}, fused on a float cache: rel L2 {err:.3e}")
    assert float(np.abs(np.asarray(jout)).mean()) > 0.1
    assert err <= REL, err
    assert not any(pfsl.launch_counts.values())  # the CPU launches nothing


@pytest.mark.parametrize("heads", [32, 4])
def test_weight_bridge_at_32_and_4_heads(heads):
    """The shipped 12 x 512 DiT at 32 heads of 16 and 4 of 128: its
    init_random_ state dict through convert_dit and back is the same dict;
    the q/k gammas are [H, D], C lanes at every head count (the fused path
    reads them flattened to [C])."""
    port = init_random_(DiT(num_heads=heads), seed=heads)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = dit_state_dict_from_flax(convert_dit(sd, num_blocks=12), 12)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert np.array_equal(back[k].numpy(), v), k
    gammas = [k for k in sd if k.endswith("q_rms_norm.gamma")]
    assert gammas and all(sd[k].shape == (heads, 512 // heads)
                          for k in gammas)
