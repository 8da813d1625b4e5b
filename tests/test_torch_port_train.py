"""Port parity of the DiT training path against the JAX package, on the CPU:
K5 at heads of 32 with fp32 in and out and K6 (ops/fused_attention.py),
forward and VJP; the composed DiT block and DiT (nn/transformer.py,
models/dit.py), forward and gradients; `training_losses`; the optimizer
chain against optax; one whole train step; the latent dataset; the YAML
reader; a checkpoint round trip; `cli/main_latent.main` for a few steps.

Inputs are numpy draws from a seed handed to both packages. JAX's
attention kernels run in Pallas interpret mode: inside these tests only,
`gvfdiffusion_tpu.nn.attention._on_tpu` is patched to True and
`fa.fused_attention` / `fa.temporal_attention` are wrapped with
interpret=True, so the JAX composed path (GVF_FUSED=off) reaches them as
it does on a TPU. The shapes keep every attention inside the kernels'
rules (Lq >= 128, 128 <= Lk; 128 lanes).

Tolerances, each with its reason:
  * K5 / K6 forward, rel L2 <= 2e-4 (readings 3.6e-5, 3.5e-5): the same
    rounding points (bf16 q/k/v and P, fp32 scores, the fixed exp2 shift);
    ulp-level differences in the fp32 scores and in XLA's exp2 flip a few
    of P's bf16 roundings. Their VJPs, rel L2 <= 1e-5 (readings
    1.2e-7-4.0e-7): both sides take the plain fp32 gradient.
  * the composed block and DiT: output rel L2 <= 2e-3 (readings 2.2e-4
    for the block, 3.7e-4 for the DiT), the loss relative <= 5e-5
    (7.1e-6), the gradients rel L2 <= 5e-4 over all parameters and for the
    block's input (5.4e-5, 6.9e-5) and <= 2e-3 for each parameter (worst
    8.4e-4 in the block, 1.4e-4 in the DiT): the attention outputs'
    differences above, carried through.
  * one train step: the update rel L2 <= 2e-2 (4.5e-3), its signs agreeing
    on >= 99.9% of the elements (99.975%): Adam's first step keeps only
    the gradient's sign, which those differences flip where a gradient is
    near 0.
  * `training_losses` with a plain model, the optimizer chain against
    optax, the EMA: rel 1e-6 (fp32 arithmetic in another order).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gvfdiffusion_torch.diffusion.gaussian_diffusion import create_diffusion
from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.nn import attention as p_attention
from gvfdiffusion_torch.ops import fused_attention as pfa
from gvfdiffusion_torch.ops import fused_sublayer as pfsl
from gvfdiffusion_torch.train import train_state as pts
from gvfdiffusion_torch.train.diffusion_trainer import (loss_and_grads,
                                                        make_train_step)
from gvfdiffusion_torch.utils import config as pconfig
from gvfdiffusion_torch.utils.checkpoint import CheckpointManager, auto_resume
from gvfdiffusion_torch.utils.weights import dit_state_dict_from_flax, init_random_
from gvfdiffusion_tpu.diffusion import gaussian_diffusion as jgd
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT
from gvfdiffusion_tpu.nn import attention as j_attention
from gvfdiffusion_tpu.nn.transformer import (
    ModulatedTransformerCrossBlock as JaxBlock)
from gvfdiffusion_tpu.ops import fused_attention as jfa
from gvfdiffusion_tpu.train import train_state as jts
from gvfdiffusion_tpu.utils.weight_convert import convert_dit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, N, C, H, L, CI, BLOCKS = 2, 4, 128, 128, 4, 130, 64, 2
DIT_KW = dict(in_channels=16, model_channels=C, image_cond_channels=CI,
              num_blocks=BLOCKS, num_heads=H)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def jax_kernels():
    """The JAX composed path with its attention kernels in interpret mode."""
    fused, temporal = jfa.fused_attention, jfa.temporal_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GVF_FUSED", "off")
        mp.setattr(j_attention, "_on_tpu", lambda: True)
        mp.setattr(jfa, "fused_attention",
                   lambda q, k, v, s, cd=jnp.bfloat16: fused(q, k, v, s, cd,
                                                             True))
        mp.setattr(jfa, "temporal_attention",
                   lambda q, k, v, s, cd=jnp.bfloat16: temporal(q, k, v, s,
                                                                cd, True))
        yield


# -- K5 at heads of 32 and K6 -----------------------------------------------------


def _vjp_pair(jfn, pfn, shapes, seed):
    r = np.random.default_rng(seed)
    q, k, v, g = (r.standard_normal(s).astype(np.float32) for s in shapes)
    jo, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    jg = vjp(jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    po = pfn(*ts)
    po.backward(torch.from_numpy(g))
    return po.detach(), jo, [t.grad for t in ts], jg


@pytest.mark.parametrize("lq,lk", [(130, 130), (130, 200)])
def test_k5_heads_of_32_fp32_matches_jax_kernel(lq, lk):
    """Self (Lq = Lk) and cross (Lk 200, off the 64-key tile): fp32 in and
    out, bf16 compute; the Function's forward is the plain version here."""
    D = 32
    po, jo, pg, jg = _vjp_pair(
        lambda q, k, v: jfa.fused_attention(q, k, v, D ** -0.5,
                                            interpret=True),
        lambda q, k, v: pfa.fused_attention(q, k, v, D ** -0.5,
                                            cross=lq != lk),
        [(3, lq, H, D), (3, lk, H, D), (3, lk, H, D), (3, lq, H, D)], 0)
    assert po.dtype == torch.float32
    assert _rel(po, jo) <= 2e-4, _rel(po, jo)
    for a, b in zip(pg, jg):
        assert _rel(a, b) <= 1e-5, _rel(a, b)


def test_k5_heads_of_32_kv_bias_matches_jax_kernel():
    """The key-bias form at heads of 32 (the fixed shift takes 30 - bias *
    log2 e): row 0 keeps 101 keys, row 1 none (its output is 0), row 2 a
    random half."""
    D, lk = 32, 200
    r = np.random.default_rng(7)
    bias = np.where(r.uniform(size=(3, lk)) < 0.5, 0.0, -np.inf)
    bias[0] = -np.inf
    bias[0, r.choice(lk, 101, replace=False)] = 0.3
    bias[1] = -np.inf
    bias = bias.astype(np.float32)
    po, jo, pg, jg = _vjp_pair(
        lambda q, k, v: jfa.fused_attention(q, k, v, D ** -0.5,
                                            interpret=True,
                                            kv_bias=jnp.asarray(bias)),
        lambda q, k, v: pfa.fused_attention(q, k, v, D ** -0.5,
                                            kv_bias=torch.from_numpy(bias)),
        [(3, 130, H, D), (3, lk, H, D), (3, lk, H, D), (3, 130, H, D)], 8)
    assert not po[1].any() and torch.isfinite(po).all()
    assert _rel(po, jo) <= 2e-4, _rel(po, jo)
    for a, b in zip(pg, jg):  # the masked row's softmax gradient is NaN in
        a, b = a.numpy(), np.asarray(b)  # both (JAX's `_bwd`)
        assert (np.isnan(a[1]) == np.isnan(b[1])).all()
        assert _rel(a[[0, 2]], b[[0, 2]]) <= 1e-5, _rel(a[[0, 2]], b[[0, 2]])


@pytest.mark.parametrize("t_len", [24, 32, 23])
def test_k6_matches_jax_kernel(t_len):
    D = 32
    po, jo, pg, jg = _vjp_pair(
        lambda q, k, v: jfa.temporal_attention(q, k, v, D ** -0.5,
                                               jnp.bfloat16, True),
        lambda q, k, v: pfa.temporal_attention(q, k, v, D ** -0.5),
        [(2, t_len, 16, H, D)] * 4, 1)
    assert po.dtype == torch.float32 and po.shape == (2, t_len, 16, H, D)
    assert _rel(po, jo) <= 2e-4, _rel(po, jo)
    for a, b in zip(pg, jg):
        assert _rel(a, b) <= 1e-5, _rel(a, b)


def test_temporal_dispatch_rule_matches_jax():
    for shape in [(1, 32, 512, 16, 32), (2, 24, 512, 16, 32),
                  (1, 32, 510, 16, 32), (1, 32, 512, 3, 32),
                  (1, 23, 16, 4, 32), (1, 100, 512, 4, 32)]:
        assert pfa.temporal_supports(shape) == jfa.temporal_supports(shape)


# -- the composed block and DiT ---------------------------------------------------


@pytest.fixture(scope="module")
def dit_pair():
    sd = {k: v.numpy().copy()
          for k, v in init_random_(DiT(**DIT_KW), 0).state_dict().items()}
    flax_params = convert_dit(sd, num_blocks=BLOCKS, qk_rms_norm=True)
    port = DiT(**DIT_KW)
    port.load_state_dict(dit_state_dict_from_flax(flax_params, BLOCKS))
    return flax_params, port


@pytest.fixture(scope="module")
def batch():
    r = np.random.default_rng(1)
    return dict(
        latent=r.standard_normal((B, T, N, 16)).astype(np.float32),
        cond_images=r.standard_normal((B, T, L, CI)).astype(np.float32),
        static_latent=r.standard_normal((B, N, 14)).astype(np.float32),
        positions=r.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32),
        t=np.array([437, 12]),
        noise=r.standard_normal((B, T, N, 16)).astype(np.float32))


def _diffusions():
    kw = dict(schedule="cosine", steps=1000, mean_type="v",
              rescale_timesteps=True)
    return jgd.create_diffusion(**kw), create_diffusion(**kw)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_dit_loss(dit_pair, batch, jax_kernels):
    """JAX: the v-prediction loss of the composed DiT at the batch's t and
    noise, its gradients, and the model output."""
    flax_params, _ = dit_pair
    jd, _ = _diffusions()
    model = JaxDiT(resolution=N, **DIT_KW)
    kw = {k: jnp.asarray(batch[k]) for k in
          ("cond_images", "static_latent", "positions")}

    def loss_fn(params):
        terms, aux = jd.training_losses(
            lambda x, tt: model.apply(params, x, tt, **kw),
            jnp.asarray(batch["latent"]), jnp.asarray(batch["t"]), None,
            noise=jnp.asarray(batch["noise"]))
        return jnp.mean(terms["loss"]), (aux["model_output"], terms)

    (loss, (out, terms)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(flax_params)
    return (float(loss), np.asarray(out), terms, _port_named(grads), grads)


def _port_named(tree, blocks=None):
    """A flax gradient tree (or, with `blocks`, its block subtrees filling a
    zero copy of the DiT's tree) under the port's parameter names."""
    tree = jax.tree.map(np.asarray, tree)
    if blocks is not None:
        full = jax.tree.map(np.zeros_like, tree)
        full["params"].update(blocks)
        tree = full
    return dit_state_dict_from_flax(tree, BLOCKS)


def test_composed_block_matches_jax(dit_pair, batch, jax_kernels):
    """One block's composed path (spatial self, temporal, image and static
    cross, MLP), forward and the gradients of its parameters and input."""
    flax_params, port = dit_pair
    block = port.blocks[0]
    r = np.random.default_rng(2)
    x = r.standard_normal((B, T, N, C)).astype(np.float32)
    mod = r.standard_normal((B, C)).astype(np.float32)
    img = r.standard_normal((B, T, L, C)).astype(np.float32)
    st = r.standard_normal((B, T, N, C)).astype(np.float32)
    g = r.standard_normal((B, T, N, C)).astype(np.float32)
    jblock = JaxBlock(C, H, qk_rms_norm=True, temporal_layout="einsum")
    bp = {"params": flax_params["params"]["blocks_0"]}

    def jfn(params, x):
        y = jblock.apply(params, x, mod, img, st)
        return jnp.sum(y * g), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(bp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    block.zero_grad(set_to_none=True)
    y = block(tx, torch.from_numpy(mod), None, torch.from_numpy(img),
              torch.from_numpy(st))
    (y * torch.from_numpy(g)).sum().backward()
    assert _rel(y.detach(), jy) <= 2e-3, _rel(y.detach(), jy)
    assert _rel(tx.grad, jgx) <= 5e-4, _rel(tx.grad, jgx)
    full = _port_named(flax_params, {"blocks_0": jax.tree.map(
        np.asarray, jgp["params"])})
    want = {k.split(".", 2)[2]: v for k, v in full.items()
            if k.startswith("blocks.0.")}
    worst = max(_rel(p.grad, want[n]) for n, p in block.named_parameters())
    print(f"block: y {_rel(y.detach(), jy):.2e}, dx {_rel(tx.grad, jgx):.2e}"
          f", worst parameter gradient {worst:.2e}")
    for name, p in block.named_parameters():
        assert _rel(p.grad, want[name]) <= 2e-3, (name, _rel(p.grad,
                                                             want[name]))


def test_composed_dit_loss_and_gradients_match_jax(dit_pair, batch,
                                                   jax_dit_loss):
    jloss, jout, _, jgrads, _ = jax_dit_loss
    _, port = dit_pair
    _, pd = _diffusions()
    tb = _torch_batch(batch)
    pfa.reset_launch_counts()
    loss, terms, grads = loss_and_grads(port, pd, tb, tb["t"], tb["noise"])
    assert not any(pfa.launch_counts.values())  # the CPU launches nothing
    print(f"DiT: loss {abs(float(loss) - jloss) / abs(jloss):.2e}")
    assert abs(float(loss) - jloss) / abs(jloss) <= 5e-5
    allp = torch.cat([grads[k].flatten() for k in grads])
    allj = torch.cat([jgrads[k].flatten() for k in grads])
    print(f"DiT: gradients {_rel(allp, allj):.2e}, worst "
          f"{max(_rel(grads[k], jgrads[k]) for k in grads):.2e}")
    assert _rel(allp, allj) <= 5e-4, _rel(allp, allj)
    for k in grads:
        assert _rel(grads[k], jgrads[k]) <= 2e-3, (k, _rel(grads[k],
                                                           jgrads[k]))
    with torch.no_grad():
        out = port(pd.q_sample(tb["latent"], tb["t"], tb["noise"]),
                   pd.scaled_model_t(tb["t"]), tb["cond_images"],
                   tb["static_latent"], tb["positions"])
    assert out.shape == (B, T, N, 16)
    print(f"DiT: output {_rel(out, jout):.2e}")
    assert _rel(out, jout) <= 2e-3, _rel(out, jout)


def test_remat_blocks_give_the_same_gradients(dit_pair, batch):
    """remat_blocks recomputes the leading blocks in the backward pass
    (torch.utils.checkpoint): the same loss and gradients, bit for bit."""
    _, port = dit_pair
    _, pd = _diffusions()
    tb = _torch_batch(batch)
    loss, _, grads = loss_and_grads(port, pd, tb, tb["t"], tb["noise"])
    port.remat_blocks = BLOCKS
    try:
        loss_r, _, grads_r = loss_and_grads(port, pd, tb, tb["t"],
                                            tb["noise"])
    finally:
        port.remat_blocks = 0
    assert float(loss) == float(loss_r)
    assert all(torch.equal(grads[k], grads_r[k]) for k in grads)


def test_init_weights_follow_flax_initializers(batch):
    """init_weights_ draws each parameter from the flax initializer of the
    same layer: the same zero and one pattern as JAX's `init`, lecun-normal
    kernels inside +-2 sigma with std ~ 1/sqrt(fan_in), xavier-uniform for
    the input layer, normal(0.02) for the timestep and conditioning
    projections."""
    port = DiT(**DIT_KW).init_weights_(torch.Generator().manual_seed(0))
    again = DiT(**DIT_KW).init_weights_(torch.Generator().manual_seed(0))
    model = JaxDiT(resolution=N, **DIT_KW)
    shapes = {k: jnp.asarray(batch[k][:1]) for k in
              ("latent", "cond_images", "static_latent", "positions")}
    jp = dit_state_dict_from_flax(jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), shapes["latent"], jnp.zeros((1,)),
        shapes["cond_images"], shapes["static_latent"],
        shapes["positions"])), BLOCKS)
    params = {k: p.detach() for k, p in port.named_parameters()}
    assert set(params) == set(jp)
    for name, p in params.items():
        j = jp[name]
        assert torch.equal(p, dict(again.named_parameters())[name])
        assert p.shape == j.shape
        for const in (0.0, 1.0):
            assert bool((p == const).all()) == bool((j == const).all()), name
        if p.ndim != 2 or not p.any() or p.numel() < 1000:
            continue
        fan_out, fan_in = p.shape
        std = float(p.std())
        if name.startswith("input_layer"):
            lim = (6.0 / (fan_in + fan_out)) ** 0.5
            assert float(p.abs().max()) <= lim
            assert abs(std - lim / 3 ** 0.5) <= 0.1 * lim, name
        elif name.startswith(("t_embedder", "image_cond", "static_cond")):
            assert abs(std - 0.02) <= 0.002, (name, std)
        else:
            want = fan_in ** -0.5
            assert abs(std - want) <= 0.1 * want, (name, std, want)
            assert float(p.abs().max()) <= 2 * want / 0.8796 * 1.0001
        assert abs(std - float(j.std())) <= 0.1 * float(j.std()), name


# -- diffusion, optimizer, train step ---------------------------------------------


@pytest.mark.parametrize("mean_type,min_snr", [("v", False), ("eps", True),
                                               ("x0", False),
                                               ("xprev", False)])
def test_training_losses_match_jax(mean_type, min_snr):
    """With a given t and noise, and a plain model that reads x_t and t."""
    kw = dict(schedule="cosine", steps=1000, mean_type=mean_type,
              min_snr=min_snr, rescale_timesteps=True)
    jd, pd = jgd.create_diffusion(**kw), create_diffusion(**kw)
    r = np.random.default_rng(3)
    x0, noise = (r.standard_normal((3, 2, 5, 4)).astype(np.float32)
                 for _ in range(2))
    t = np.array([0, 437, 999])
    w = r.standard_normal((1, 1, 1, 4)).astype(np.float32)
    jterms, jaux = jd.training_losses(
        lambda x, tt: jnp.tanh(x * w + 1e-3 * tt[:, None, None, None]),
        jnp.asarray(x0), jnp.asarray(t), None, noise=jnp.asarray(noise))
    pterms, paux = pd.training_losses(
        lambda x, tt: torch.tanh(x * torch.from_numpy(w)
                                 + 1e-3 * tt[:, None, None, None]),
        torch.from_numpy(x0), torch.from_numpy(t),
        noise=torch.from_numpy(noise))
    np.testing.assert_allclose(paux["x_t"].numpy(), np.asarray(jaux["x_t"]),
                               rtol=1e-6, atol=1e-6)
    for k in ("mse", "loss"):
        np.testing.assert_allclose(pterms[k].numpy(), np.asarray(jterms[k]),
                                   rtol=1e-6, atol=1e-7)
    for name in ("betas", "alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                 "posterior_mean_coef1", "posterior_log_variance_clipped"):
        np.testing.assert_array_equal(getattr(pd, name).numpy(),
                                      np.asarray(getattr(jd, name)))


def test_optimizer_chain_matches_optax():
    """6 micro-steps at grad_accum 2: the warm-up (the first update at lr
    0), clipping (the gradients' norm passes 1.0 on some steps),
    MultiSteps' running mean, AdamW and the per-micro-step EMA."""
    r = np.random.default_rng(4)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 2, 4)}
    params = {k: r.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (r.standard_normal(s) * (0.05 if i % 3 else 0.8)).astype(
        np.float32) for k, s in shapes.items()} for i in range(6)]
    kw = dict(lr=1e-2, warmup_steps=3, weight_decay=0.0, grad_clip=1.0,
              grad_accum=2)
    ema_rate = 0.99 ** 0.5
    jtx = jts.make_optimizer(**kw)
    jstate = jts.create_train_state(
        {k: jnp.asarray(v) for k, v in params.items()}, jtx)
    ptx = pts.make_optimizer(**kw)
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(
            v.copy())))
    pstate = pts.create_train_state(module, ptx)
    moved = []
    for i, g in enumerate(grads):
        before = {k: p.detach().clone() for k, p in pstate.params.items()}
        jstate = jts.apply_updates(
            jstate, {k: jnp.asarray(v) for k, v in g.items()}, jtx, ema_rate)
        pstate = pts.apply_updates(
            pstate, {k: torch.from_numpy(v) for k, v in g.items()}, ptx,
            ema_rate)
        moved.append(any(not torch.equal(before[k], p)
                         for k, p in pstate.params.items()))
        assert pstate.step == int(jstate.step) == i + 1
        for k in shapes:
            np.testing.assert_allclose(
                pstate.params[k].detach().numpy(),
                np.asarray(jstate.params[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(
                pstate.ema_params[k].numpy(),
                np.asarray(jstate.ema_params[k]), rtol=1e-6, atol=1e-7)
    # micro-steps 1, 3, 5 fire the inner update; the first runs at lr 0
    assert moved == [False, False, False, True, False, True]
    assert pstate.opt_state.count == 3


def test_train_step_matches_jax(dit_pair, batch, jax_dit_loss):
    """One whole train step at grad_accum 1 (its update fires) from the
    same state, t and noise: the metrics, the updated parameters and EMA.
    JAX's `train_step` draws t and noise from its key, so the JAX side is
    its body with them given: value_and_grad of training_losses, then
    apply_updates."""
    flax_params, port = dit_pair
    jloss, _, jterms, _, jgrad_tree = jax_dit_loss
    _, pd = _diffusions()
    kw = dict(lr=1e-4, warmup_steps=0, weight_decay=0.0, grad_clip=1.0,
              grad_accum=1)
    ema_rate = 0.9999
    jtx = jts.make_optimizer(**kw)
    jstate = jts.create_train_state(flax_params, jtx)
    jstate = jax.jit(lambda st, g: jts.apply_updates(st, g, jtx, ema_rate))(
        jstate, jgrad_tree)
    jnew = dit_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params),
                                    BLOCKS)
    jema = dit_state_dict_from_flax(
        jax.tree.map(np.asarray, jstate.ema_params), BLOCKS)
    jgn = float(optax.global_norm(jgrad_tree))

    model = DiT(**DIT_KW)
    model.load_state_dict(port.state_dict())
    old = {k: p.detach().clone() for k, p in model.named_parameters()}
    ptx = pts.make_optimizer(**kw)
    state = pts.create_train_state(model, ptx)
    step = make_train_step(model, pd, ptx, ema_rate)
    tb = _torch_batch(batch)
    state, metrics = step(state, tb, torch.Generator(), t=tb["t"],
                          noise=tb["noise"])
    assert state.step == 1
    assert abs(float(metrics["loss"]) - jloss) / jloss <= 5e-5
    assert abs(float(metrics["mse"]) - float(jnp.mean(jterms["mse"]))) \
        / jloss <= 5e-5
    assert abs(float(metrics["grad_norm"]) - jgn) / jgn <= 5e-4
    upd = torch.cat([(p.detach() - old[k]).flatten()
                     for k, p in model.named_parameters()])
    jupd = torch.cat([(jnew[k] - old[k]).flatten()
                      for k, _ in model.named_parameters()])
    # Adam's first step is lr * g / (|g| + eps): elementwise, the update
    # keeps only the gradient's sign, which the gradient's differences flip
    # on the few elements whose gradient is near 0
    print(f"train step: update {_rel(upd, jupd):.2e}, signs agree "
          f"{float((upd.sign() == jupd.sign()).float().mean()):.6f}")
    assert _rel(upd, jupd) <= 2e-2, _rel(upd, jupd)
    assert float((upd.sign() == jupd.sign()).float().mean()) >= 0.999
    ema = torch.cat([state.ema_params[k].flatten() for k in old])
    assert _rel(ema, torch.cat([jema[k].flatten() for k in old])) <= 1e-6


# -- the repairs ------------------------------------------------------------------


def _sublayer_args():
    r = np.random.default_rng(5)
    t = lambda *s: torch.tensor(r.standard_normal(s).astype(np.float32))
    c = 64
    x = t(2, 8, c)
    mod = (t(2, c), t(2, c), t(2, c))
    self_w = (t(c, 3 * c), t(3 * c), t(c), t(c), t(c, c), t(c))
    cross_p = (t(c), t(c), t(c, c), t(c), t(c, c), t(c))
    return {
        "self": (pfsl.fused_self_sublayer, (x, *mod, *self_w),
                 dict(num_heads=2)),
        "temporal": (pfsl.fused_temporal_sublayer,
                     (x[:, :, None].expand(2, 8, 2, c).contiguous(), *mod,
                      *self_w), dict(num_heads=2)),
        "cross": (pfsl.fused_cross_sublayer,
                  (x, cross_p, (t(2, 5, c), t(2, 5, c)), cross_p,
                   (t(2, 5, c), t(2, 5, c))), dict(num_heads=2)),
        "mlp": (pfsl.fused_mlp_sublayer,
                (x, *mod, t(c, 128), t(128), t(128, c), t(c)), {}),
    }


@pytest.mark.parametrize("key", ["self", "temporal", "cross", "mlp"])
def test_sublayer_kernels_raise_under_grad(key, monkeypatch):
    """K1-K4 read raw pointers, so their wrappers are autograd Functions
    whose backward is JAX's custom_vjp (the float oracle's vjp, recomputed):
    on the CPU the Function's gradient equals torch's autograd through the
    plain version; where the kernel would launch, grad mode no longer
    raises for want of a backward, and the CPU tensors fail the kernel's
    device check, with or without grad."""
    fn, args, kw = _sublayer_args()[key]
    weight = args[-1]
    flat = lambda a: a[-1] if isinstance(a, tuple) else a
    w = flat(weight)
    w.requires_grad_(True)
    x = args[0].detach().requires_grad_(True)
    args = (x, *args[1:])
    g = torch.tensor(np.random.default_rng(8).standard_normal(
        tuple(x.shape)).astype(np.float32))
    y = fn(*args, **kw)  # the CPU: the plain forward, JAX's backward
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, (x, w), g)
    ref = {"self": pfsl.self_sublayer_reference,
           "temporal": pfsl.temporal_sublayer_reference,
           "cross": pfsl.cross_sublayer_reference,
           "mlp": pfsl.mlp_sublayer_reference}[key]
    want = torch.autograd.grad(ref(*args, **kw), (x, w), g)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
        assert b.abs().sum() > 0
    monkeypatch.setattr(pfsl, "_use_kernel", lambda x, impl: True)
    with pytest.raises(TypeError):
        fn(*args, **kw)
    with torch.no_grad(), pytest.raises(TypeError):
        fn(*args, **kw)


def test_k5_has_a_gradient_and_refuses_one_for_kv_bias():
    """K5's wrapper is an autograd Function: its output carries grad_fn
    and a gradient reaches q; a kv_bias that requires grad gets the
    gradient JAX's backward gives it (the sum of dS over heads and query
    rows), equal to torch's autograd through the plain version, with
    segments too."""
    r = np.random.default_rng(6)
    q, k, v = (torch.tensor(r.standard_normal((1, 130, 2, 64)).astype(
        np.float32), requires_grad=True) for _ in range(3))
    y = pfa.fused_attention(q, k, v, 0.125, torch.float32)
    assert y.grad_fn is not None
    y.sum().backward()
    assert q.grad.abs().sum() > 0
    bias = torch.tensor(r.standard_normal((1, 130)).astype(np.float32),
                        requires_grad=True)
    g = torch.tensor(r.standard_normal((1, 130, 2, 64)).astype(np.float32))
    for seg in (0, 26):
        kw = dict(kv_bias=bias, segment_size=seg)
        got = torch.autograd.grad(pfa.fused_attention(
            q, k, v, 0.125, torch.float32, **kw), (q, bias), g)
        want = torch.autograd.grad(pfa.fused_attention(
            q, k, v, 0.125, torch.float32, impl="plain", **kw), (q, bias), g)
        for a, b in zip(got, want):
            assert float((a - b).norm() / b.norm()) <= 1e-5


def test_k5_launch_counter_keys_by_form_and_head_width(monkeypatch):
    """The counter names the form the caller runs and the head width: a
    cross-attention with Lq = Lk (the DiT's static context, 512 x 512) is
    counted as cross; heads of 64 keep the earlier names."""
    assert pfa.launch_key(64, False, False) == "attention"
    assert pfa.launch_key(64, True, False) == "attention_cross"
    assert pfa.launch_key(64, False, True) == "attention_bias"
    assert pfa.launch_key(32, False, False) == "attention_d32"
    assert pfa.launch_key(32, True, False) == "attention_cross_d32"
    assert pfa.launch_key(32, False, True, seg=True) == "attention_seg_d32"
    assert pfa.launch_key(64, False, True, quant="qk") == "attention_qk"
    assert pfa.launch_key(32, False, False, True, "qk+av") == \
        "attention_qkav_d32"
    assert pfa.launch_key(16, True, False) == "attention_cross_d16"
    assert pfa.launch_key(128, False, False, quant="qk") == "attention_qk_d128"
    assert pfa.temporal_launch_key(32) == pfa.temporal_launch_key(64) == \
        "temporal_attention"
    assert pfa.temporal_launch_key(128) == "temporal_attention_d128"
    widths = [""] + [f"_d{w}" for w in range(8, 129, 8) if w != 64]
    assert set(pfa.launch_counts) == {
        f"attention{form}{w}" for w in widths for form in (
            "", "_cross", "_bias", "_seg", "_qk", "_qkav")} | {
        "temporal_attention"} | {f"temporal_attention_d{w}"
                                 for w in range(8, 129, 8) if w not in (32, 64)}
    seen = []
    real = p_attention.fused_attention

    def spy(*a, cross=False, **kw):
        seen.append(cross)
        return real(*a, cross=cross, **kw)

    monkeypatch.setattr(p_attention, "fused_attention", spy)
    attn = p_attention.MultiHeadAttention(128, 4, "cross")
    x = torch.zeros(2, 130, 128)
    attn(x, torch.float32, context=x)  # Lq = Lk = 130
    p_attention.MultiHeadAttention(128, 4, "self")(x, torch.float32)
    assert seen == [True, False]


# -- data, config, checkpoint, CLI ------------------------------------------------


def _write_dataset(root, n_items=2, t_total=6, n=16, c=16, l=5, ci=32,
                   seed=7):
    r = np.random.default_rng(seed)
    for i in range(n_items):
        d = os.path.join(root, f"obj{i}")
        os.makedirs(d)
        torch.save({
            "latent_mean": torch.from_numpy(
                r.standard_normal((t_total, n, c)).astype(np.float32)),
            "latent_std": torch.from_numpy(
                r.uniform(0.1, 0.5, (t_total, n, c)).astype(np.float32)),
            "fps_sampled_gs_1024": torch.from_numpy(
                r.standard_normal((2 * n, 14)).astype(np.float32)),
        }, os.path.join(d, "deformation_latent.pt"))
        np.savez(os.path.join(d, "dinov2_features.npz"),
                 features=r.standard_normal((t_total, l, ci)).astype(
                     np.float32))


def test_dataset_matches_jax(tmp_path):
    from gvfdiffusion_torch.data.dataset_latent import LatentDataset, load_data
    from gvfdiffusion_tpu.data import dataset_latent as jdl

    _write_dataset(str(tmp_path), n_items=3)
    kw = dict(num_frames=4, num_latents=16, latent_dim=16, uncond_p=0.5,
              seed=3)
    pds, jds = LatentDataset(str(tmp_path), **kw), jdl.LatentDataset(
        str(tmp_path), **kw)
    assert len(pds) == len(jds) == 3
    pit, jit_ = load_data(pds, 2), jdl.load_data(jds, 2)
    dropped = 0
    for _ in range(4):
        pb, jb = next(pit), next(jit_)
        assert set(pb) == set(jb) == {"latent", "cond_images",
                                      "static_latent", "positions"}
        for k in pb:
            assert pb[k].dtype == np.float32
            np.testing.assert_array_equal(pb[k], jb[k])
        assert pb["latent"].shape == (2, 4, 16, 16)
        dropped += int((pb["cond_images"] == 0).all(axis=(1, 2, 3)).sum())
    assert 0 < dropped < 8  # uncond_p = 0.5 dropped some, not all


def test_yaml_reader_matches_pyyaml_and_jax_config(tmp_path):
    import yaml

    from gvfdiffusion_tpu.utils import config as jconfig

    for name in ("diffusion.yml", "vae.yml"):
        path = os.path.join(REPO, "configs", name)
        with open(path) as f:
            assert pconfig.read_yaml(path) == yaml.safe_load(f)
    args = ["--train.lr=1e-4", "--model.num_blocks=2", "--data_dir=/x"]
    path = os.path.join(REPO, "configs", "diffusion.yml")
    p = dataclasses.asdict(pconfig.load_config(path, args))
    j = dataclasses.asdict(jconfig.load_config(path, args))
    assert p.pop("exp_dir") == "gvf_exp"  # relative, not a host path
    j.pop("exp_dir")
    assert p == j
    bad = tmp_path / "bad.yml"
    bad.write_text("a:\n  b:\n    c: 1\n")
    with pytest.raises(ValueError, match="two levels"):
        pconfig.read_yaml(str(bad))
    bad.write_text("a:\n  - 1\n")
    with pytest.raises(ValueError):
        pconfig.read_yaml(str(bad))


def test_checkpoint_round_trip(tmp_path):
    model = torch.nn.Linear(3, 4)
    tx = pts.make_optimizer(lr=1e-2, warmup_steps=0, grad_accum=2)
    state = pts.create_train_state(model, tx)
    for i in range(3):
        g = {k: torch.full_like(p, 0.1 * (i + 1))
             for k, p in state.params.items()}
        pts.apply_updates(state, g, tx, 0.9)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.save(state, 3) and not mgr.save(state, 3)
    saved = {k: v.detach().clone() for k, v in state.params.items()}
    ema = {k: v.clone() for k, v in state.ema_params.items()}
    mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    fresh = pts.create_train_state(torch.nn.Linear(3, 4), tx)
    fresh, step = auto_resume(str(tmp_path / "ck"), fresh)
    assert step == 3 and fresh.step == 3
    assert fresh.opt_state.count == 1 and fresh.opt_state.mini_step == 1
    for k in saved:
        assert torch.equal(fresh.params[k], saved[k])
        assert torch.equal(fresh.ema_params[k], ema[k])
        assert torch.equal(fresh.opt_state.mu[k], mu[k])
        assert torch.equal(fresh.opt_state.acc[k], state.opt_state.acc[k])
    mgr.save(state, 4)
    mgr.save(state, 5)
    assert mgr.all_steps() == [4, 5]


def test_main_latent_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """`main(["--device=cpu", ...])` on a tiny config: 2 micro-steps (one
    update, at lr 0), a checkpoint, then a resume to 4 (the second update
    moves the weights)."""
    from gvfdiffusion_torch.cli import main_latent

    data = tmp_path / "data"
    os.makedirs(data)
    _write_dataset(str(data))
    exp = tmp_path / "exp"
    args = ["--device=cpu", "--config", os.path.join(REPO, "configs",
                                                     "diffusion.yml"),
            f"--data_dir={data}", f"--exp_dir={exp}",
            "--model.model_channels=64", "--model.num_heads=2",
            "--model.num_blocks=1", "--model.resolution=16",
            "--model.image_cond_channels=32", "--train.sample_timesteps=4",
            "--train.warmup_steps=2", "--train.log_interval=1",
            "--train.save_interval=100"]
    assert main_latent.main(args + ["--train.total_steps=2"]) == 0
    out = capsys.readouterr().err  # the logger's messages
    assert "step 1 loss" in out and "device: cpu" in out
    ck = CheckpointManager(str(exp / "checkpoints"))
    assert ck.all_steps() == [2]
    first = torch.load(os.path.join(ck.ckpt_dir, "ckpt_00000002.pt"),
                       weights_only=True)
    assert first["opt_state"]["count"] == 1
    init = DiT(in_channels=16, model_channels=64, image_cond_channels=32,
               num_blocks=1, num_heads=2).init_weights_(
                   torch.Generator().manual_seed(0))
    for k, p in init.named_parameters():  # the first update runs at lr 0
        assert torch.equal(first["params"][k], p.detach()), k
    assert main_latent.main(args + ["--train.total_steps=4"]) == 0
    out = capsys.readouterr().err  # the logger's messages
    assert "auto-resumed from step 2" in out and "step 3 loss" in out
    assert ck.all_steps() == [2, 4]
    second = torch.load(os.path.join(ck.ckpt_dir, "ckpt_00000004.pt"),
                        weights_only=True)
    assert second["step"] == 4 and second["opt_state"]["count"] == 2
    assert any(not torch.equal(second["params"][k], p.detach())
               for k, p in init.named_parameters())
    assert all(torch.isfinite(v).all() for v in second["params"].values())
