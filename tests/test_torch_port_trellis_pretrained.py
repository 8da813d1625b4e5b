"""Port parity: TRELLIS built from a pretrained directory at fp32, as the
registry builds it, against the JAX package on the CPU.

Every model of the tiny staged pipeline (DINOv2, the sparse-structure flow
and decoder, the SLat flow with its torso uncompacted, the Gaussian
decoder) is built by the port's `from_pretrained` from a directory the JAX
registry wrote (release-style configs with `use_fp16: true`, seeded random
parameters); TrellisImageTo3DPipeline's stages with the noise injected
must give JAX's pipeline on the same parameters and noise: the occupied
voxels exactly, the SLat and the Gaussians rel L2 <= 1e-4, as the chains of
tests/test_torch_port_trellis.py. `run(formats=...)` and
`decode_slat_formats` refuse the formats whose decoders are not ported.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _pretrained import write_model
from gvfdiffusion_torch.models import registry as pr
from gvfdiffusion_torch.pipelines.trellis_image_to_3d import (
    TrellisConfig, TrellisImageTo3DPipeline)
from gvfdiffusion_torch.sparse.tensor import SparseVoxels
from gvfdiffusion_tpu.pipelines import trellis_image_to_3d as jpipe
from gvfdiffusion_tpu.sparse import tensor as jst

CHAIN = 1e-4


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


def _np(t):
    return t.detach().float().numpy()


def _voxels(seed, cap, n, res=16, C=4):
    r = np.random.default_rng(seed)
    coords = np.zeros((1, cap, 3), np.int32)
    valid = np.zeros((1, cap), bool)
    lin = r.choice(res ** 3, n, replace=False)
    coords[0, :n] = np.stack([lin // res ** 2, lin // res % res, lin % res],
                             -1)
    valid[0, :n] = True
    feats = r.standard_normal((1, cap, C)).astype(np.float32) \
        * valid[..., None]
    return (SparseVoxels(torch.from_numpy(feats), torch.from_numpy(coords),
                         torch.from_numpy(valid), res),
            jst.SparseVoxels(jnp.asarray(feats), jnp.asarray(coords),
                             jnp.asarray(valid), resolution=res))


PIPE_MODELS = {
    "ss_flow": ("SparseStructureFlowModel", dict(
        resolution=8, in_channels=4, out_channels=4, model_channels=128,
        cond_channels=128, num_blocks=1, num_head_channels=64,
        patch_size=2, pe_mode="ape", qk_rms_norm=True, use_fp16=True)),
    "ss_decoder": ("SparseStructureDecoder", dict(
        out_channels=1, latent_channels=4, num_res_blocks=1,
        num_res_blocks_middle=1, channels=[16, 8], use_fp16=True)),
    "slat_flow": ("SLatFlowModel", dict(
        resolution=16, in_channels=4, out_channels=4, model_channels=128,
        cond_channels=128, num_blocks=1, num_head_channels=64,
        patch_size=2, num_io_res_blocks=2, io_block_channels=[16],
        pe_mode="ape", qk_rms_norm=True, use_fp16=True,
        use_skip_connection=True, use_checkpoint=False)),
    "slat_decoder_gs": ("ElasticSLatGaussianDecoder", dict(
        resolution=16, model_channels=128, latent_channels=4, num_blocks=2,
        num_head_channels=64, window_size=4, use_fp16=True,
        representation_config={"num_gaussians": 8, "voxel_size": 1.5,
                               "3d_filter_kernel_size": 9e-4,
                               "scaling_bias": 4e-3, "opacity_bias": 0.1,
                               "scaling_activation": "softplus"})),
    "image_cond_model": ("DinoV2", dict(img_size=28, embed_dim=64, depth=1,
                                        num_heads=1)),
}


def test_tiny_pipeline_from_pretrained_matches_jax(tmp_path):
    """Every model from the port's from_pretrained (fp32, the torso
    uncompacted as the registry builds it) in TrellisImageTo3DPipeline;
    its stages with the noise injected against JAX's pipeline on the
    parameters the JAX registry saved; run(formats=...) refuses the
    formats whose decoders are not ported."""
    root = str(tmp_path)
    r = np.random.default_rng(60)
    cond = r.standard_normal((1, 20, 128)).astype(np.float32)
    ss_noise = r.standard_normal((1, 8, 8, 8, 4)).astype(np.float32)
    slat_noise = r.standard_normal((1, 256, 4)).astype(np.float32)
    p0, j0 = _voxels(61, cap=64, n=40)
    inputs = {
        "ss_flow": [jnp.asarray(ss_noise), jnp.zeros(1), jnp.asarray(cond)],
        "ss_decoder": [jnp.asarray(ss_noise)],
        "slat_flow": [j0, jnp.zeros(1), jnp.asarray(cond)],
        "slat_decoder_gs": [j0],
        "image_cond_model": [jnp.zeros((1, 28, 28, 3))],
    }
    jax_models = {key: write_model(root, key, name, args, inputs[key],
                                   seed=62 + i)
                  for i, (key, (name, args)) in enumerate(PIPE_MODELS.items())}
    with open(os.path.join(root, "pipeline.json"), "w") as f:
        f.write('{"name": "TrellisImageTo3DPipeline", "models": {'
                + ", ".join(f'"{k}": "{k}"' for k in PIPE_MODELS) + "}}")
    spec = pr.load_pipeline_spec(root)
    m = {k: pr.from_pretrained(root, v, device="cpu")
         for k, v in spec["models"].items()}
    assert m["slat_flow"].torso_capacity is None
    cfg = TrellisConfig(ss_steps=2, slat_steps=2, ss_resolution=8,
                        grid_resolution=16, voxel_capacity=256)
    mean = r.standard_normal(4).astype(np.float32) * 0.3
    std = r.uniform(0.5, 1.5, 4).astype(np.float32)
    pipe = TrellisImageTo3DPipeline(
        m["image_cond_model"], m["ss_flow"], m["ss_decoder"], m["slat_flow"],
        m["slat_decoder_gs"], cfg, torch.from_numpy(mean),
        torch.from_numpy(std), device="cpu")
    t = torch.from_numpy
    # the occupancy bias at the middle of the largest logit gap near rank
    # 60, in both packages' decoders (random weights make it arbitrary)
    z = pipe.sample_ss_latent(t(cond), noise=t(ss_noise))
    with torch.no_grad():
        v = torch.sort(pipe.ss_decoder(z).flatten(), descending=True).values
    gaps = v[40:80] - v[41:81]
    k = 41 + int(torch.argmax(gaps))
    thr = float(0.5 * (v[k - 1] + v[k]))
    with torch.no_grad():
        pipe.ss_decoder.out_layer[2].bias -= thr
    jm = {key: jm_p for key, jm_p in jax_models.items()}
    ssd_params = jax.tree_util.tree_map(lambda a: a, jm["ss_decoder"][1])
    ssd_params["params"]["out_layer"]["bias"] = \
        ssd_params["params"]["out_layer"]["bias"] - np.float32(thr)

    structure = pipe.sample_sparse_structure(t(cond), noise=t(ss_noise))
    slat = pipe.sample_slat(structure, t(cond), noise_feats=t(slat_noise))
    decoded = pipe.decode_slat_formats(slat, ("gaussian",))
    gs, valid = decoded["gaussian"]

    jp = jpipe.TrellisImageTo3DPipeline(
        None, None, jm["ss_flow"][0], jm["ss_flow"][1],
        jm["ss_decoder"][0], ssd_params, jm["slat_flow"][0],
        jm["slat_flow"][1], jm["slat_decoder_gs"][0],
        jm["slat_decoder_gs"][1], jpipe.TrellisConfig(**cfg.__dict__),
        slat_mean=jnp.asarray(mean), slat_std=jnp.asarray(std))
    key = jax.random.PRNGKey(0)  # unused: the noise is injected
    js = jp.sample_sparse_structure(jnp.asarray(cond), key,
                                    noise=jnp.asarray(ss_noise))
    n_occ = int(structure.valid.sum())
    assert 0 < n_occ <= 256
    np.testing.assert_array_equal(structure.valid.numpy(),
                                  np.asarray(js.valid))
    np.testing.assert_array_equal(structure.coords.numpy(),
                                  np.asarray(js.coords))
    jslat = jp.sample_slat(js, jnp.asarray(cond), key,
                           noise_feats=jnp.asarray(slat_noise))
    assert _rel(slat.feats, jslat.feats) <= CHAIN
    jdec = jp.decode_slat_formats(jslat, ("gaussian",))
    jgs, jvalid = jdec["gaussian"]
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    mk = valid.numpy()[0]
    assert _rel(_np(gs.to_activated_tensor())[0][mk],
                np.asarray(jgs.to_activated_tensor())[0][mk]) <= CHAIN
    image = np.zeros((40, 40, 4), np.uint8)
    for formats in (("gaussian", "mesh"), ("radiance_field",)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pipe.run(image, formats=formats)
        with pytest.raises(NotImplementedError):
            pipe.decode_slat_formats(slat, formats)
    with pytest.raises(ValueError):
        pipe.decode_slat_formats(slat, ("voxels",))
