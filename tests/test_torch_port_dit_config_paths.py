"""Port parity of the DiT's other configurations (tests/_dit_configs.py)
on the CPU, beyond the hoisted cache (tests/test_torch_port_dit_configs.py):
the composed path without a cache (JAX's GVF_FUSED=off, the trainer's
path), the gate's one deliberate difference from JAX (no TPU VMEM terms),
one training micro-step of dit-d64 and of dit-rope against JAX, and the
trainer's configuration (`main_latent.build_model`, `mem_ratio`).

Tolerances, each with its reason: the composed path rel L2 <= COMPOSED_REL
(2e-3: both round q/k/v and P to bf16 at the same points, and ulp-level
differences in the fp32 scores flip a few of P's bf16 roundings); the gate
case rel L2 <= 1e-4 (fp32 on both sides, tests/test_torch_port_dit.py);
one training micro-step: the loss within 5e-5 relative and the gradients
within 5e-4 rel L2 (tests/test_torch_port_train.py:22-24).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _dit_configs import (BASE, BLOCKS, C, CONFIGS, N, ORDER, inputs,
                          nonzero, pair, rel, tpu_dispatch)

from gvfdiffusion_torch.cli.main_latent import build_model
from gvfdiffusion_torch.diffusion.gaussian_diffusion import create_diffusion
from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.nn import attention as p_attention
from gvfdiffusion_torch.ops import fused_sublayer as pfsl
from gvfdiffusion_torch.train.diffusion_trainer import loss_and_grads
from gvfdiffusion_torch.utils.config import (load_config, read_yaml,
                                             write_yaml)
from gvfdiffusion_torch.utils.weights import dit_state_dict_from_flax
from gvfdiffusion_tpu.diffusion import gaussian_diffusion as jgd
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT
from gvfdiffusion_tpu.nn import attention as j_attention
from gvfdiffusion_tpu.ops import fused_sublayer as jfsl
from gvfdiffusion_tpu.utils import config as jconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4
COMPOSED_REL = 2e-3


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
def test_composed_path_matches_jax(cfg, monkeypatch, jax_tpu_dispatch):
    """GVF_FUSED=off and no hoisted cache: the composed path in both, the
    DiT projecting the conditioning itself; image tokens 130 long, inside
    K5's rule as the reference's 1374 are."""
    monkeypatch.setenv("GVF_FUSED", "off")
    model, params, port = pair(cfg)
    inp = inputs(3, l=130)
    jout = model.apply(params, *(jnp.asarray(inp[k]) for k in ORDER))
    with torch.no_grad():
        pout = port(*(torch.from_numpy(inp[k]) for k in ORDER))
    err = rel(pout, jout)
    print(f"{cfg} composed: rel L2 {err:.3e}")
    assert err <= COMPOSED_REL, err


def test_gate_leaves_out_the_tpu_vmem_terms():
    """A shape where the JAX gate closes on its VMEM estimate alone: 11000
    image tokens at C = 128 (the cross sublayer's kv buffers and score
    tile pass 16 MB), every other term met. JAX composes; the port stays
    on the fused path, and both compute the same function (fp32, no bf16
    rounding on either side)."""
    lk1, lk2 = 11000, N
    assert not jfsl.cross_sublayer_supports(8, N, C, 4, lk1, lk2)
    assert pfsl.cross_sublayer_supports(8, N, C, 4, lk1, lk2)
    assert jfsl.self_sublayer_supports(8, N, C, 4) and \
        jfsl.temporal_sublayer_supports(1, 8, N, C, 4)
    kw = dict(BASE, num_blocks=1, num_heads=4)
    model = JaxDiT(**kw)
    inp = inputs(6, t=8, l=lk1)
    params = nonzero(model.init(jax.random.PRNGKey(1), *(
        jnp.asarray(inp[k]) for k in ORDER)), seed=7)
    port = DiT(**kw)
    port.load_state_dict(dit_state_dict_from_flax(
        jax.tree.map(np.asarray, params), 1))
    args = [jnp.asarray(inp[k]) for k in ORDER]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GVF_FUSED", "interpret")
        kv = model.apply(params, *args, kv_only=True)
        jout = model.apply(params, *args, cross_kv=kv)
    a = {k: torch.from_numpy(v) for k, v in inp.items()}
    with torch.no_grad():
        pkv = port.kv_cache(a["cond_images"], a["static_latent"])
        assert port.blocks[0].fused_supported(torch.zeros(1, 8, N, C),
                                              pkv[0])
        pout = port(a["x"], a["t"], positions=a["positions"], cross_kv=pkv)
    err = rel(pout, jout)
    print(f"gate: JAX composed vs the port fused, rel L2 {err:.3e}")
    assert err <= REL, err


@pytest.mark.parametrize("lq,lk,masked", [(20, 37, False), (20, 37, True),
                                          (130, 130, True)])
def test_attention_outside_k5_and_with_a_mask_matches_jax(lq, lk, masked):
    """The attention JAX sends to XLA (outside K5's rule, or with a mask):
    the port's library counterpart against `jax.nn.dot_product_attention`,
    fp32, rel L2 <= 1e-6 (the same softmax in another order)."""
    r = np.random.default_rng(10)
    q, k, v = (r.standard_normal((2, n, 4, 32)).astype(np.float32)
               for n in (lq, lk, lk))
    mask = None
    if masked:
        mask = r.uniform(size=(2, 1, lq, lk)) < 0.7
        mask[..., 0] = True  # every row attends somewhere
    want = j_attention.scaled_dot_product_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        mask=None if mask is None else jnp.asarray(mask))
    got = p_attention.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.float32,
        mask=None if mask is None else torch.from_numpy(mask))
    assert rel(got, want) <= 1e-6, rel(got, want)


# -- training: one micro-step of dit-d64 and dit-rope against JAX ------------


@pytest.mark.parametrize("cfg", ["dit-d64", "dit-rope"])
def test_training_micro_step_matches_jax(cfg, monkeypatch, jax_tpu_dispatch):
    """The v-prediction loss of the composed DiT at a batch of 2 x 4
    frames (image tokens 130) and its gradients over every parameter."""
    monkeypatch.setenv("GVF_FUSED", "off")
    model, params, port = pair(cfg)
    r = np.random.default_rng(8)
    inp = inputs(9, b=2, t=4, l=130)
    t = np.array([437, 12])
    noise = r.standard_normal((2, 4, N, 16)).astype(np.float32)
    kw = dict(schedule="cosine", steps=1000, mean_type="v",
              rescale_timesteps=True)
    jd, pd = jgd.create_diffusion(**kw), create_diffusion(**kw)
    cond = {k: jnp.asarray(inp[k]) for k in ORDER[2:]}

    def loss_fn(p):
        terms, _ = jd.training_losses(
            lambda x, tt: model.apply(p, x, tt, **cond),
            jnp.asarray(inp["x"]), jnp.asarray(t), None,
            noise=jnp.asarray(noise))
        return jnp.mean(terms["loss"])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jg = dit_state_dict_from_flax(jax.tree.map(np.asarray, jgrads), BLOCKS)
    batch = {"latent": torch.from_numpy(inp["x"]),
             **{k: torch.from_numpy(inp[k]) for k in ORDER[2:]}}
    loss, _, grads = loss_and_grads(port, pd, batch, torch.from_numpy(t),
                                    torch.from_numpy(noise))
    lerr = abs(float(loss) - float(jloss)) / abs(float(jloss))
    allp = torch.cat([grads[k].flatten() for k in grads])
    allj = torch.cat([jg[k].flatten() for k in grads])
    gerr = rel(allp, allj)
    print(f"{cfg} micro-step: loss {lerr:.2e}, gradients {gerr:.2e}")
    assert set(grads) == set(jg)
    assert lerr <= 5e-5, lerr
    assert gerr <= 5e-4, gerr


# -- the trainer's configuration ---------------------------------------------


# the configurations the trainer's config can name: JAX's config (and so
# the port's) has no qk_rms_norm_cross, so dit-rms-cross is built by the
# constructor only
TRAINABLE = [c for c in CONFIGS if "qk_rms_norm_cross" not in CONFIGS[c]]


def _yaml(tmp_path, name, model):
    data = read_yaml(os.path.join(REPO, "configs", "diffusion.yml"))
    data["model"].update(model)
    path = str(tmp_path / f"{name}.yml")
    write_yaml(data, path)
    assert read_yaml(path) == data
    return path


@pytest.mark.parametrize("cfg", TRAINABLE)
def test_build_model_accepts_each_configuration(cfg, tmp_path):
    """main_latent.build_model on a YAML written from configs/diffusion.yml
    with the configuration's overrides (as chip_smoke.py writes them)
    builds the module the constructor builds."""
    c = load_config(_yaml(tmp_path, cfg, dict(CONFIGS[cfg], num_blocks=2)))
    built = build_model(c)
    direct = DiT(**{f.name: getattr(c.model, f.name)
                    for f in dataclasses.fields(c.model)})
    assert str(built) == str(direct)
    assert {k: v.shape for k, v in built.state_dict().items()} == {
        k: v.shape for k, v in direct.state_dict().items()}
    block = built.blocks[0]
    kw = CONFIGS[cfg]
    assert block.num_heads == kw["num_heads"]
    assert block.use_rope == (kw.get("pe_mode") == "rope")
    assert block.no_temporal_attn == kw.get("no_temporal_attn", False)
    assert not block.qk_rms_norm_cross
    assert built.remat_blocks == 0


@pytest.mark.parametrize("field,value", [("qk_rms_norm_cross", True),
                                         ("temporal_layout", "transpose")])
def test_config_refuses_the_dits_other_fields(field, value, tmp_path):
    """A DiT field that JAX's config does not name is refused by the
    port's config as by JAX's, not dropped."""
    path = _yaml(tmp_path, field, {field: value})
    with pytest.raises(AttributeError, match=field):
        load_config(path)
    with pytest.raises(AttributeError, match=field):
        jconfig.load_config(path)


def test_mem_ratio_sets_remat_blocks():
    path = os.path.join(REPO, "configs", "diffusion.yml")
    assert build_model(load_config(path, ["--train.mem_ratio=0.5"])
                       ).remat_blocks == 7  # ceil(0.5 * 12) + 1
    assert build_model(load_config(path, ["--train.mem_ratio=0.5",
                                          "--model.remat_blocks=3"])
                       ).remat_blocks == 3
    assert JaxDiT().mem_ratio_to_remat_blocks(0.5) == 7
