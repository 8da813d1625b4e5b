"""Port parity: the in-the-wild entry point
(gvfdiffusion_torch/pipelines/in_the_wild.py `InTheWildPipeline.run`)
against the JAX package's, in fp32 on the CPU, at a tiny size: a 64^2
RGBA frame through a 1-block TRELLIS, the azimuth alignment (8 angles at
32^2 through the multi-round blend) and a 2-block DiT's video pipeline,
with the noise JAX draws from its keys handed to the port. The pieces
are held one by one in tests/test_torch_port_wild.py.

Tolerances: the angle and the scale exactly, the aligned splat and the
anchors within 1e-5, the latent and deltas within 1e-3 (the bound of the
video pipeline test, tests/test_torch_port_pipeline.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_pipeline as tpp
import test_torch_port_trellis as tpt
from gvfdiffusion_torch.models.dinov2 import DinoV2
from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.pipelines.in_the_wild import (InTheWildConfig,
                                                      InTheWildPipeline)
from gvfdiffusion_torch.pipelines.trellis_image_to_3d import (
    TrellisConfig, TrellisImageTo3DPipeline)
from gvfdiffusion_torch.pipelines.video_to_4d import (VideoTo4DConfig,
                                                      VideoTo4DPipeline)
from gvfdiffusion_torch.render.renderer import RenderOptions
from gvfdiffusion_torch.utils.weights import (dit_state_dict_from_flax,
                                              init_random_)
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT
from gvfdiffusion_tpu.models.motion_vae import MotionVAE as JaxMotionVAE
from gvfdiffusion_tpu.pipelines import in_the_wild as jwild
from gvfdiffusion_tpu.pipelines import trellis_image_to_3d as jtrellis
from gvfdiffusion_tpu.pipelines import video_to_4d as jv4d
from gvfdiffusion_tpu.render import renderer as jr
from gvfdiffusion_tpu.representations import gaussians as jg
from gvfdiffusion_tpu.utils.weight_convert import convert_dit

OPT = dict(near=0.1, far=10.0, tile=16, max_per_tile=64)


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _tiny_pipelines():
    """The port's tiny TRELLIS of tests/test_torch_port_trellis.py with a
    1-block DINOv2 of width 128 at 518^2, and a tiny video pipeline (a
    2-block DiT, the motion VAE of tests/test_torch_port_pipeline.py) on
    its 2048 Gaussians, in both packages."""
    dino = init_random_(DinoV2(embed_dim=128, depth=1, num_heads=2), 30)
    ptr = TrellisImageTo3DPipeline(
        dino.eval(), tpt._ss_flow_pair()[0], tpt._ss_dec_pair()[0],
        tpt._slat_pair()[0], tpt._gs_pair()[0],
        TrellisConfig(ss_steps=1, slat_steps=1, ss_resolution=8,
                      grid_resolution=16, voxel_capacity=256), device="cpu")
    G, T, N_lat, C_lat, CI = 2048, 2, 8, 4, 16
    dit_kw = dict(in_channels=C_lat, model_channels=32,
                  static_cond_channels=14, image_cond_channels=CI,
                  out_channels=C_lat, num_blocks=2, num_heads=4)
    port_dit = init_random_(DiT(**dit_kw), seed=31)
    dit_params = convert_dit(
        {k: v.numpy().copy() for k, v in port_dit.state_dict().items()},
        num_blocks=2)
    port_dit.load_state_dict(dit_state_dict_from_flax(dit_params, 2))
    vae_params, port_vae = tpp._vae_pair(32)
    vcfg = dict(steps=2, order=2, num_latents=N_lat, latent_dim=C_lat)
    pv4d = VideoTo4DPipeline(port_dit.eval(), port_vae,
                             VideoTo4DConfig(**vcfg), device="cpu")
    jv = jv4d.VideoTo4DPipeline(
        JaxDiT(resolution=N_lat, **dit_kw, pe_mode="ape", qk_rms_norm=True),
        dit_params,
        JaxMotionVAE(num_inputs=G, num_latents=N_lat, knn_k=4, **tpp.VAE_KW),
        vae_params, jv4d.VideoTo4DConfig(**vcfg, num_frames=T))
    return ptr, pv4d, jv, (G, T, N_lat, C_lat, CI)


# positional arguments each stage keeps: the callers pass (cond, generator)
# to sample_ss_latent, (structure, cond, generator) to sample_slat and
# (cond, anchors, positions) to sample_deformation_latent
_KEEP = {"sample_ss_latent": 1, "sample_slat": 2,
         "sample_deformation_latent": 3}


def _inject(obj, name, **noise):
    """obj.name replaced by a call with the noise the stage would have
    drawn handed in as keywords."""
    fn, keep = getattr(obj, name), _KEEP[name]
    setattr(obj, name, lambda *a, **kw: fn(*a[:keep], **noise))


def _jax_splat(gs):
    """The port's batched splat as the JAX package's."""
    return jg.GaussianSplat(
        *(jnp.asarray(getattr(gs, k).numpy()) for k in (
            "_xyz", "_features_dc", "_scaling", "_rotation", "_opacity",
            "aabb")), scaling_bias=gs.scaling_bias,
        opacity_bias=gs.opacity_bias,
        scaling_activation=gs.scaling_activation,
        mininum_kernel_size=gs.mininum_kernel_size)


def test_tiny_in_the_wild_run_matches_jax(monkeypatch):
    """InTheWildPipeline.run on a 64^2 RGBA frame, with the noise JAX draws
    from its keys handed to the port. JAX's run gets the port's TRELLIS
    output for its first stage (tests/test_torch_port_trellis.py holds the
    port's TRELLIS stages to JAX's, whose eager trace takes minutes on the
    CPU); the rest, from selecting the splat through the alignment (8
    angles at 32^2 through the multi-round blend, the scale from the
    frame's alpha) to the video pipeline on its noise, runs in both."""
    monkeypatch.setenv("GVF_FUSED", "off")
    ptr, pv4d, jv, (G, T, N_lat, C_lat, CI) = _tiny_pipelines()
    r = np.random.default_rng(33)
    image = np.zeros((64, 64, 4), np.float32)
    image[14:50, 18:46, :3] = r.uniform(0.1, 0.9, (36, 28, 3))
    image[14:50, 18:46, 3] = 1.0
    cond_images = r.standard_normal((T, 5, CI)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(rng)
    ka, kb = jax.random.split(k1)
    _inject(ptr, "sample_ss_latent",
            noise=_t(jax.random.normal(ka, (1, 8, 8, 8, 4))))
    _inject(ptr, "sample_slat",
            noise_feats=_t(jax.random.normal(kb, (1, 256, 4))))
    _inject(pv4d, "sample_deformation_latent",
            noise=_t(jax.random.normal(k2, (1, T, N_lat, C_lat))))
    cond = ptr.encode_image(torch.from_numpy(ptr.preprocess_image(image))[None])
    tpt._occupancy_biased(ptr.ss_decoder, ptr.sample_ss_latent(cond))
    trellis_out = ptr.run(image)

    jt = jtrellis.TrellisImageTo3DPipeline(*[None] * 10)
    jt.run = lambda image_, key: dict(
        gaussians=_jax_splat(trellis_out["gaussians"]),
        valid=jnp.asarray(trellis_out["valid"].numpy()))
    render = dict(OPT, rounds=2, early_exit=True)
    wcfg = dict(align_n_angles=8, render_resolution=32)
    alpha = image[..., 3]
    got = InTheWildPipeline(ptr, pv4d, InTheWildConfig(**wcfg),
                            render_options=RenderOptions(**render)).run(
        image, _t(cond_images), canonical_alpha=alpha)
    want = jwild.InTheWildPipeline(
        jt, jv, jwild.InTheWildConfig(**wcfg),
        render_options=jr.RenderOptions(**render)).run(
        image, jnp.asarray(cond_images), rng, canonical_alpha=alpha)

    m = got["valid"].numpy()
    assert torch.equal(got["valid"], trellis_out["valid"][0])
    assert 0 < m.sum() < G
    assert got["align_angle"] == pytest.approx(want["align_angle"], abs=1e-6)
    assert got["align_scale"] == want["align_scale"]
    assert _rel(got["gaussians"].to_activated_tensor().numpy()[m],
                np.asarray(want["gaussians"].to_activated_tensor())[m]) \
        <= 1e-5
    np.testing.assert_allclose(got["anchors"].numpy(),
                               np.asarray(want["anchors"]), atol=1e-5)
    assert got["deltas"].shape == (1, T, G, 14)
    assert float(np.abs(np.asarray(want["deltas"])).mean()) > 0.01
    assert _rel(got["latent"], want["latent"]) <= 1e-3
    assert _rel(got["deltas"], want["deltas"]) <= 1e-3
