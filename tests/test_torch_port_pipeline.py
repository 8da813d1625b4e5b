"""Port parity: the sampler, FPS, the motion-VAE decode and the whole
video->4D denoise-and-decode pipeline against the JAX package, at fp32 on
the CPU, with the same random weights and JAX's own initial noise.

Tolerances, each with its reason:
  * schedule arrays and scalars: 1e-6 rel (the same float32 formulas);
  * model_wrapper and the multistep solver on a toy model: 1e-5 rel (the
    float32 updates in another evaluation order);
  * fps_masked: indices exactly;
  * motion-VAE decode: rel L2 <= 1e-4;
  * the tiny pipeline (sizes of tests/test_pipelines.py:97, GVF_FUSED=off):
    rel L2 <= 1e-3 on the latent and on the deltas;
  * the tiny frames -> DINOv2 -> run -> render_4d chain: rel L2 <= 1e-5 on
    the tokens (test_torch_port_dinov2.py), 1e-3 on the latent and deltas
    (as above), and max abs <= 1e-4 on the rendered frames (reading 5e-7:
    the deltas, scaled by 0.1, carry their differences into the Gaussians).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.diffusion import dpm_solver as pdpm
from gvfdiffusion_torch.models.dinov2 import DinoV2
from gvfdiffusion_torch.diffusion.gaussian_diffusion import (
    get_named_beta_schedule as p_betas)
from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.models.motion_vae import MotionVAE
from gvfdiffusion_torch.ops.fps import fps_masked
from gvfdiffusion_torch.pipelines.video_to_4d import (
    VideoTo4DConfig, VideoTo4DPipeline)
from gvfdiffusion_torch.representations.gaussians import from_activated
from gvfdiffusion_torch.scripts.process_video import encode_video
from gvfdiffusion_torch.utils.weights import (
    dinov2_state_dict_from_flax, dit_state_dict_from_flax, init_random_,
    motion_vae_state_dict_from_flax)
from gvfdiffusion_tpu.diffusion import dpm_solver as jdpm
from gvfdiffusion_tpu.diffusion.gaussian_diffusion import (
    get_named_beta_schedule as j_betas)
from gvfdiffusion_tpu.models import dinov2 as jdino
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT
from gvfdiffusion_tpu.models.motion_vae import MotionVAE as JaxMotionVAE
from gvfdiffusion_tpu.models.motion_vae import pad_static_gs
from gvfdiffusion_tpu.ops.fps import fps_masked as j_fps_masked
from gvfdiffusion_tpu.pipelines import video_to_4d as jpipe
from gvfdiffusion_tpu.representations.gaussians import (
    from_activated as j_from_activated)
from gvfdiffusion_tpu.scripts.process_video import (
    normalize_frame as j_normalize_frame)
from gvfdiffusion_tpu.utils.weight_convert import (
    convert_dinov2, convert_dit, convert_motion_vae)


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


def _schedules():
    betas = j_betas("cosine", 1000)
    assert np.array_equal(betas, p_betas("cosine", 1000))
    return (jdpm.NoiseScheduleVP.from_betas(betas),
            pdpm.NoiseScheduleVP.from_betas(betas))


@pytest.mark.parametrize("name", ["linear", "cosine", "cosine_light",
                                  "sigmoid"])
def test_beta_schedules(name):
    np.testing.assert_array_equal(p_betas(name, 1000), j_betas(name, 1000))


def test_noise_schedule():
    jns, pns = _schedules()
    assert pns.total_N == jns.total_N
    np.testing.assert_array_equal(pns.t_array.numpy(), np.asarray(jns.t_array))
    np.testing.assert_array_equal(pns.log_alpha_array.numpy(),
                                  np.asarray(jns.log_alpha_array))
    t = np.linspace(0.0005, 1.0, 37).astype(np.float32)
    for fn in ("marginal_log_mean_coeff", "marginal_alpha", "marginal_std",
               "marginal_lambda"):
        np.testing.assert_allclose(
            getattr(pns, fn)(torch.from_numpy(t)).numpy(),
            np.asarray(getattr(jns, fn)(jnp.asarray(t))), rtol=1e-6, atol=1e-6)
    lam = np.linspace(-5.0, 6.0, 23).astype(np.float32)
    np.testing.assert_allclose(
        pns.inverse_lambda(torch.from_numpy(lam)).numpy(),
        np.asarray(jns.inverse_lambda(jnp.asarray(lam))), rtol=1e-6, atol=1e-6)


def _toy_models(seed):
    """The same small v-prediction model in both frameworks: it reads x, t
    and every condition, so the CFG branch order shows in its output. It
    takes no `static_latent`, the one key the JAX wrapper zeroes in its
    first CFG branch (the port's pipeline zeroes it in the KV cache)."""
    r = np.random.default_rng(seed)
    a = r.standard_normal((1, 1, 1, 4)).astype(np.float32)

    def jax_model(x, t, cond_images, positions, cross_kv=None):
        c = (cond_images.mean(axis=(1, 2, 3))
             + positions.mean(axis=(1, 2)))[:, None, None, None]
        return jnp.tanh(x * jnp.asarray(a) + 1e-3 * t[:, None, None, None] + c)

    def torch_model(x, t, cond_images, positions, cross_kv=None):
        c = (cond_images.mean(dim=(1, 2, 3))
             + positions.mean(dim=(1, 2)))[:, None, None, None]
        return torch.tanh(x * torch.from_numpy(a) + 1e-3 * t[:, None, None, None]
                          + c)

    return jax_model, torch_model


def _conds(seed, B=2):
    r = np.random.default_rng(seed)
    c = dict(cond_images=r.standard_normal((B, 2, 3, 4)),
             positions=r.standard_normal((B, 5, 3)))
    u = dict(c, cond_images=np.zeros((B, 2, 3, 4)))
    f = lambda d, m: {k: m(v.astype(np.float32)) for k, v in d.items()}
    return ((f(c, jnp.asarray), f(u, jnp.asarray)),
            (f(c, torch.from_numpy), f(u, torch.from_numpy)))


@pytest.mark.parametrize("scales", [(1.0, 1.0), (2.0, 5.0)],
                         ids=["single_pass", "dual_cfg"])
@pytest.mark.parametrize("t", [0.9, 0.3, 0.02])
def test_model_wrapper(scales, t):
    """v-prediction under classifier-free guidance, as the pipeline wraps
    its DiT; t = 0.02 sits near the end of the clipped schedule."""
    jns, pns = _schedules()
    jm, tm = _toy_models(0)
    (jc, ju), (tc, tu) = _conds(1)
    scale = dict(guidance_scale=scales[0], guidance_scale2=scales[1])
    jfn = jdpm.model_wrapper(jm, jns, model_type="v",
                             guidance_type="classifier-free", condition=jc,
                             unconditional_condition=ju, **scale)
    pfn = pdpm.model_wrapper(tm, pns, model_type="v",
                             guidance_type="classifier-free", condition=tc,
                             unconditional_condition=tu, **scale)
    x = np.random.default_rng(2).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    got = pfn(torch.from_numpy(x), torch.tensor(t)).numpy()
    want = np.asarray(jfn(jnp.asarray(x), jnp.float32(t)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("steps", [6, 9, 10, 12])
def test_multistep_sampler(order, steps):
    """Below 10 steps (6, 9) the lower-order-final branch; from 10 on the
    constant-order loop with a final update that runs no model."""
    jns, pns = _schedules()
    jm, tm = _toy_models(3)
    (jc, _), (tc, _) = _conds(4)
    jfn = jdpm.model_wrapper(jm, jns, model_type="v", condition=jc)
    pfn = pdpm.model_wrapper(tm, pns, model_type="v", condition=tc)
    x = np.random.default_rng(5).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    want = jdpm.DPMSolver(jfn, jns, "dpmsolver++").sample(
        jnp.asarray(x), steps=steps, order=order)
    got = pdpm.DPMSolver(pfn, pns).sample(
        torch.from_numpy(x), steps=steps, order=order)
    assert _rel(got, want) <= 1e-5, _rel(got, want)


def test_fps_masked_indices():
    r = np.random.default_rng(6)
    pts = r.uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    valid = np.ones((2, 300), bool)
    valid[0, :7] = False      # padding before the first valid point
    valid[1, 250:] = False    # a padded tail
    want = np.stack([np.asarray(j_fps_masked(jnp.asarray(p), jnp.asarray(v),
                                             64)) for p, v in zip(pts, valid)])
    got = fps_masked(torch.from_numpy(pts), torch.from_numpy(valid), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert valid[np.arange(2)[:, None], got.numpy()].all()


VAE_KW = dict(depth=1, dim=48, queries_dim=48, output_dim=14, latent_dim=4,
              heads=4)


def _vae_pair(seed):
    port = init_random_(MotionVAE(**VAE_KW), seed)
    sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    flax_params = convert_motion_vae(sd, depth=1)
    port.load_state_dict(motion_vae_state_dict_from_flax(flax_params, depth=1))
    return flax_params, port.eval()


def test_motion_vae_decode():
    flax_params, port = _vae_pair(7)
    r = np.random.default_rng(8)
    T, Q = 2, 32
    z = r.standard_normal((T, 8, 4)).astype(np.float32)
    q = r.standard_normal((1, Q, 14)).astype(np.float32)
    jvae = JaxMotionVAE(num_inputs=Q, num_latents=8, knn_k=4, **VAE_KW)
    want = jvae.apply(flax_params, jnp.asarray(z), jnp.asarray(q), T,
                      method=JaxMotionVAE.decode)
    with torch.no_grad():
        whole = port.decode(torch.from_numpy(z), torch.from_numpy(q), T)
        chunked = port.decode(torch.from_numpy(z), torch.from_numpy(q), T,
                              chunk_size=8)
    assert whole.shape == (1, T, Q, 14)
    assert float(np.abs(np.asarray(want)).mean()) > 0.01
    assert _rel(whole, want) <= 1e-4, _rel(whole, want)
    assert _rel(chunked, want) <= 1e-4, _rel(chunked, want)


@pytest.mark.parametrize("scales", [(1.0, 1.0), (2.0, 5.0)],
                         ids=["single_pass", "dual_cfg"])
def test_video_to_4d_pipeline(scales, monkeypatch):
    """The tiny pipeline of tests/test_pipelines.py:97 (1 block, 32
    channels; G = 32 Gaussians) through both packages. The JAX side runs its
    composed DiT (GVF_FUSED=off); the port always hoists the KV cache."""
    monkeypatch.setenv("GVF_FUSED", "off")
    B, T, G, N_lat, C_lat, L = 1, 2, 32, 8, 4, 5
    dit_kw = dict(in_channels=C_lat, model_channels=32,
                  static_cond_channels=14, image_cond_channels=16,
                  out_channels=C_lat, num_blocks=1, num_heads=4)
    port_dit = init_random_(DiT(**dit_kw), seed=9)
    sd = {k: v.numpy().copy() for k, v in port_dit.state_dict().items()}
    dit_params = convert_dit(sd, num_blocks=1)
    port_dit.load_state_dict(dit_state_dict_from_flax(dit_params, 1))
    vae_params, port_vae = _vae_pair(10)

    r = np.random.default_rng(11)
    gs_act = r.normal(size=(G - 4, 14)).astype(np.float32)
    static_gs, valid = pad_static_gs([gs_act], pad_to=G)
    cond_images = r.standard_normal((B, T, L, 16)).astype(np.float32)
    cfg = dict(steps=4, order=2, num_latents=N_lat, latent_dim=C_lat,
               guidance_scale=scales[0], guidance_scale2=scales[1])
    # latent normalization stats, applied after sampling
    mean = r.standard_normal(C_lat).astype(np.float32)
    std = (1.0 + 0.1 * r.standard_normal(C_lat)).astype(np.float32)
    rng = jax.random.PRNGKey(0)

    jp = jpipe.VideoTo4DPipeline(
        JaxDiT(resolution=N_lat, **dit_kw, pe_mode="ape", qk_rms_norm=True),
        dit_params,
        JaxMotionVAE(num_inputs=G, num_latents=N_lat, knn_k=4, **VAE_KW),
        vae_params, jpipe.VideoTo4DConfig(**cfg, num_frames=T),
        latent_mean=jnp.asarray(mean), latent_std=jnp.asarray(std))
    want = jp.run(static_gs, valid, jnp.asarray(cond_images), rng)
    # the noise JAX's sample_deformation_latent draws from `rng`
    noise = np.array(jax.random.normal(rng, (B, T, N_lat, C_lat)))

    pp = VideoTo4DPipeline(port_dit.eval(), port_vae, VideoTo4DConfig(**cfg),
                           latent_mean=torch.from_numpy(mean),
                           latent_std=torch.from_numpy(std), device="cpu")
    got = pp.run(torch.from_numpy(np.array(static_gs)),
                 torch.from_numpy(np.array(valid)),
                 torch.from_numpy(cond_images), noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got["anchors"].numpy(),
                                  np.asarray(want["anchors"]))
    assert got["latent"].shape == (B, T, N_lat, C_lat)
    assert got["deltas"].shape == (B, T, G, 14)
    assert float(np.abs(np.asarray(want["deltas"])).mean()) > 0.01
    assert _rel(got["latent"], want["latent"]) <= 1e-3
    assert _rel(got["deltas"], want["deltas"]) <= 1e-3


def test_frames_to_rendered_frames_chain(monkeypatch):
    """The port's main path at a tiny size against the JAX chain: frames ->
    normalize_frame -> resize -> DINOv2 encode_image -> VideoTo4DPipeline.run
    -> render_4d (2 orbit views at 32^2, one 32-px tile, K = 256)."""
    monkeypatch.setenv("GVF_FUSED", "off")
    T, G, N_lat, C_lat, size = 2, 64, 8, 4, 56
    dino_kw = dict(img_size=size, patch_size=14, embed_dim=128, depth=2,
                   num_heads=2, num_register_tokens=4)
    port_dino = init_random_(DinoV2(**dino_kw), seed=12).eval()
    dino_params = convert_dinov2(
        {k: v.numpy().copy() for k, v in port_dino.state_dict().items()},
        depth=2)
    port_dino.load_state_dict(dinov2_state_dict_from_flax(dino_params, 2))
    dit_kw = dict(in_channels=C_lat, model_channels=32,
                  static_cond_channels=14, image_cond_channels=128,
                  out_channels=C_lat, num_blocks=1, num_heads=4)
    port_dit = init_random_(DiT(**dit_kw), seed=13)
    dit_params = convert_dit(
        {k: v.numpy().copy() for k, v in port_dit.state_dict().items()},
        num_blocks=1)
    port_dit.load_state_dict(dit_state_dict_from_flax(dit_params, 1))
    vae_params, port_vae = _vae_pair(14)

    r = np.random.default_rng(15)
    frames = (r.uniform(size=(T, 48, 40, 3)) * 255).astype(np.uint8)
    q = r.standard_normal((G - 6, 4))
    gs_act = np.concatenate([
        r.uniform(-0.4, 0.4, (G - 6, 3)), r.uniform(0.03, 0.1, (G - 6, 3)),
        q / np.linalg.norm(q, axis=-1, keepdims=True),
        r.standard_normal((G - 6, 3)) * 0.5, r.uniform(0.3, 0.9, (G - 6, 1))],
        -1).astype(np.float32)
    static_gs, valid = pad_static_gs([gs_act], pad_to=G)
    cfg = dict(steps=4, order=2, num_latents=N_lat, latent_dim=C_lat)
    rng = jax.random.PRNGKey(1)
    noise = np.array(jax.random.normal(rng, (1, T, N_lat, C_lat)))
    view = dict(num_views=2, resolution=32)

    jdm = jdino.DinoV2(**dino_kw)
    canv = np.stack([np.asarray(jax.image.resize(
        jnp.asarray(j_normalize_frame(f)), (size, size, 3), "bilinear"))
        for f in frames])
    j_tokens = jdino.encode_image(jdm, dino_params, jnp.asarray(canv))
    jp = jpipe.VideoTo4DPipeline(
        JaxDiT(resolution=N_lat, **dit_kw, pe_mode="ape", qk_rms_norm=True),
        dit_params,
        JaxMotionVAE(num_inputs=G, num_latents=N_lat, knn_k=4, **VAE_KW),
        vae_params, jpipe.VideoTo4DConfig(**cfg, num_frames=T))
    want = jp.run(static_gs, valid, j_tokens[None], rng)
    want_frames = jp.render_4d(j_from_activated(static_gs[0]),
                               want["deltas"][0] * 0.1, valid[0], **view)

    tokens = encode_video(frames, port_dino, image_size=size, device="cpu")
    pp = VideoTo4DPipeline(port_dit.eval(), port_vae, VideoTo4DConfig(**cfg),
                           device="cpu")
    got = pp.run(torch.from_numpy(np.array(static_gs)),
                 torch.from_numpy(np.array(valid)), tokens[None],
                 noise=torch.from_numpy(noise))
    frames_out = pp.render_4d(
        from_activated(torch.from_numpy(np.array(static_gs[0]))),
        got["deltas"][0] * 0.1, torch.from_numpy(np.array(valid[0])), **view)

    assert _rel(tokens, j_tokens) <= 1e-5
    assert _rel(got["latent"], want["latent"]) <= 1e-3
    assert _rel(got["deltas"], want["deltas"]) <= 1e-3
    assert frames_out.shape == (T, 2, 32, 32, 3) == want_frames.shape
    assert float((want_frames < 0.98).mean()) > 0.05  # the splat shows
    assert np.abs(want_frames[1] - want_frames[0]).max() > 0.01  # and moves
    err = np.abs(frames_out.numpy() - want_frames).max()
    print(f"rendered frames: max abs {err:.3e}")
    assert err <= 1e-4, err
