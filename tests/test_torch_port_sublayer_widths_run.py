"""Port parity at heads of 16 (the width `num_heads=32` gives at the
shipped 512 channels) of the DiT on bench.py's int8 modes and of the video
main path, on the CPU, against JAX at GVF_FUSED=interpret (its Pallas
kernels in interpret mode, each JAX call jitted and blocked on):

  * the DiT (2 blocks, C = 128, tests/_dit_configs.py's size, inputs and
    non-zero weights) on the int8 cache with int8 QK (GVF_KV_QUANT=int8,
    GVF_SELF_QUANT=int8);
  * VideoTo4DPipeline.run with a 1-block DiT of 8 heads of 16 (C = 128,
    128 latents, 8 frames) under the dual CFG (2.0 / 5.0, which hoists the
    cache on both sides, so both take the fused path), 2 DPM-Solver++
    steps, and the motion-VAE decode.
The float cache at heads of 16, 128 and 4:
tests/test_torch_port_sublayer_widths_models.py.

Tolerances, those the same paths take at the shipped widths: the int8
DiT rel L2 2e-3 (tests/test_torch_port_dit_configs.py); the pipeline's
latent and deltas rel L2 1e-3 (tests/test_torch_port_pipeline.py). About
45 s alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _dit_configs import (BASE, BLOCKS, ORDER, inputs, jax_hoisted, nonzero,
                          port_hoisted, rel)

from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.models.motion_vae import MotionVAE
from gvfdiffusion_torch.pipelines.video_to_4d import (VideoTo4DConfig,
                                                      VideoTo4DPipeline)
from gvfdiffusion_torch.utils.weights import (dit_state_dict_from_flax,
                                              init_random_,
                                              motion_vae_state_dict_from_flax)
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT
from gvfdiffusion_tpu.models.motion_vae import MotionVAE as JaxMotionVAE
from gvfdiffusion_tpu.models.motion_vae import pad_static_gs
from gvfdiffusion_tpu.pipelines import video_to_4d as jpipe
from gvfdiffusion_tpu.utils.weight_convert import (convert_dit,
                                                   convert_motion_vae)

INT8_REL = 2e-3
PIPE_REL = 1e-3
HEADS = 8  # heads of 16 at C = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker while this module runs (the
    suite runs several workers at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dit_int8_cache_and_qk_at_heads_of_16_match_jax(monkeypatch):
    """A fresh JAX module: it reads GVF_SELF_QUANT while it traces."""
    monkeypatch.setenv("GVF_FUSED", "interpret")
    monkeypatch.setenv("GVF_KV_QUANT", "int8")
    monkeypatch.setenv("GVF_SELF_QUANT", "int8")
    model = JaxDiT(**BASE, num_heads=HEADS)
    params = nonzero(model.init(jax.random.PRNGKey(0), *(
        jnp.asarray(inputs(0)[k]) for k in ORDER)), seed=1)
    port = DiT(**BASE, num_heads=HEADS)
    port.load_state_dict(dit_state_dict_from_flax(
        jax.tree.map(np.asarray, params), BLOCKS))
    port.eval()
    inp = inputs(4)
    jout = jax.block_until_ready(jax.jit(
        lambda p, i: jax_hoisted(model, p, i))(params, inp))
    pout = port_hoisted(port, inp, kv_quant="int8", self_quant="int8")
    pflt = port_hoisted(port, inp)
    err = rel(pout, jout)
    print(f"DiT heads of 16, int8 cache and QK: rel L2 {err:.3e} (against "
          f"the float cache {rel(pout, pflt):.3e})")
    assert err <= INT8_REL, err
    assert rel(pout, pflt) > 0  # the int8 forms ran


VAE_KW = dict(depth=1, dim=48, queries_dim=48, output_dim=14, latent_dim=4,
              heads=4)


def test_video_to_4d_run_at_heads_of_16_matches_jax(monkeypatch):
    monkeypatch.setenv("GVF_FUSED", "interpret")
    Bp, Tp, G, N_lat, C_lat, Lp = 1, 8, 160, 128, 4, 5
    dit_kw = dict(in_channels=C_lat, model_channels=128,
                  static_cond_channels=14, image_cond_channels=16,
                  out_channels=C_lat, num_blocks=1, num_heads=8)
    port_dit = init_random_(DiT(**dit_kw), seed=12)
    sd = {k: v.numpy().copy() for k, v in port_dit.state_dict().items()}
    dit_params = convert_dit(sd, num_blocks=1)
    port_dit.load_state_dict(dit_state_dict_from_flax(dit_params, 1))
    port_vae = init_random_(MotionVAE(**VAE_KW), 13)
    vsd = {k: v.numpy().copy() for k, v in port_vae.state_dict().items()}
    vae_params = convert_motion_vae(vsd, depth=1)
    port_vae.load_state_dict(motion_vae_state_dict_from_flax(vae_params,
                                                             depth=1))

    r = np.random.default_rng(14)
    gs_act = r.normal(size=(G - 6, 14)).astype(np.float32)
    static_gs, valid = pad_static_gs([gs_act], pad_to=G)
    cond_images = r.standard_normal((Bp, Tp, Lp, 16)).astype(np.float32)
    cfg = dict(steps=2, order=2, num_latents=N_lat, latent_dim=C_lat,
               guidance_scale=2.0, guidance_scale2=5.0)
    rng = jax.random.PRNGKey(0)
    jp = jpipe.VideoTo4DPipeline(
        JaxDiT(resolution=N_lat, **dit_kw, pe_mode="ape", qk_rms_norm=True),
        dit_params,
        JaxMotionVAE(num_inputs=G, num_latents=N_lat, knn_k=4, **VAE_KW),
        vae_params, jpipe.VideoTo4DConfig(**cfg, num_frames=Tp))
    want = jp.run(static_gs, valid, jnp.asarray(cond_images), rng)
    noise = np.array(jax.random.normal(rng, (Bp, Tp, N_lat, C_lat)))

    pp = VideoTo4DPipeline(port_dit.eval(), port_vae.eval(),
                           VideoTo4DConfig(**cfg), device="cpu")
    hoisted = []
    dit_forward = port_dit.forward

    def forward(*a, **kw):
        hoisted.append(kw.get("cross_kv") is not None)
        return dit_forward(*a, **kw)

    monkeypatch.setattr(port_dit, "forward", forward)
    got = pp.run(torch.from_numpy(np.array(static_gs)),
                 torch.from_numpy(np.array(valid)),
                 torch.from_numpy(cond_images), noise=torch.from_numpy(noise))
    assert hoisted and all(hoisted)
    assert port_dit.blocks[0].spatial_self_attn.head_dim == 16
    lat, dlt = (rel(got[k], want[k]) for k in ("latent", "deltas"))
    print(f"VideoTo4DPipeline.run, heads of 16, dual CFG: latent rel L2 "
          f"{lat:.3e}, deltas {dlt:.3e}")
    assert float(np.abs(np.asarray(want["deltas"])).mean()) > 0.01
    assert lat <= PIPE_REL, lat
    assert dlt <= PIPE_REL, dlt
