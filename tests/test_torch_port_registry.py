"""Port parity: models/registry.py, TRELLIS built from a pretrained
directory, against the JAX package's registry on the CPU.

A pretrained directory in the reference's layout is written by the JAX
package (`create_model` from release-style configs with `use_fp16: true`,
`num_head_channels` and the Gaussian decoder's `representation_config`,
parameters from `init`'s shapes drawn from a numpy seed, saved with
`save_params_npz`); the port's `from_pretrained` builds each model from it
and must give JAX's forward on the same inputs, at fp32, rel L2 <= 1e-5.
Also: `_adapt_kwargs` against JAX's on release-style dicts, and the names
the port does not build yet, and the torch checkpoints JAX has no
converter for, raising as pinned.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _pretrained import write_model
from gvfdiffusion_torch.models import registry as pr
from gvfdiffusion_tpu.models import registry as jr

MODULE = 1e-5


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


# release-style configs at small widths (the released files' keys)
SS_FLOW = dict(resolution=8, in_channels=4, out_channels=4,
               model_channels=128, cond_channels=128, num_blocks=1,
               num_head_channels=64, mlp_ratio=4, patch_size=2,
               pe_mode="ape", qk_rms_norm=True, use_fp16=True)
SS_DEC = dict(out_channels=1, latent_channels=4, num_res_blocks=1,
              num_res_blocks_middle=1, channels=[16, 8], use_fp16=True)
GS_DEC = dict(resolution=16, model_channels=128, latent_channels=4,
              num_blocks=2, num_heads=2, mlp_ratio=4, attn_mode="swin",
              window_size=4, pe_mode="ape", use_fp16=True,
              use_checkpoint=False, qk_rms_norm=False,
              representation_config={
                  "lr": {"_xyz": 1.0, "_features_dc": 1.0, "_opacity": 1.0,
                         "_scaling": 1.0, "_rotation": 0.1},
                  "perturb_offset": True, "voxel_size": 1.5,
                  "num_gaussians": 8, "2d_filter_kernel_size": 0.1,
                  "3d_filter_kernel_size": 9e-4, "scaling_bias": 4e-3,
                  "opacity_bias": 0.1, "scaling_activation": "softplus"})
DINO = dict(img_size=28, patch_size=14, embed_dim=64, depth=1, num_heads=1)


@pytest.mark.parametrize("name,args", [
    ("SparseStructureFlowModel", SS_FLOW),
    ("SLatFlowModel", dict(resolution=64, in_channels=8, out_channels=8,
                           model_channels=1024, cond_channels=1024,
                           num_blocks=24, num_head_channels=64, mlp_ratio=4,
                           patch_size=2, num_io_res_blocks=2,
                           io_block_channels=[128], pe_mode="ape",
                           qk_rms_norm=True, use_fp16=True,
                           use_skip_connection=True, use_checkpoint=False)),
    ("ElasticSLatGaussianDecoder", GS_DEC),
    ("SLatMeshDecoder", dict(resolution=64, model_channels=768,
                             num_head_channels=64, use_fp16=True,
                             representation_config={"use_color": True})),
    ("SLatRadianceFieldDecoder", dict(model_channels=768, use_fp16=True,
                                      representation_config={"rank": 16,
                                                             "dim": 8})),
    ("SparseStructureDecoder", SS_DEC),
])
def test_adapt_kwargs_matches_jax(name, args):
    got, want = pr._adapt_kwargs(name, args), jr._adapt_kwargs(name, args)
    if "rep_config" in want:
        assert got.pop("rep_config")._asdict() == \
            want.pop("rep_config")._asdict()
    assert got == want
    assert "use_fp16" not in got and "use_skip_connection" not in got


def _voxels(seed, cap, n, res, C):
    from gvfdiffusion_torch.sparse.tensor import SparseVoxels
    from gvfdiffusion_tpu.sparse import tensor as jst

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


def _case(kind, r):
    """(registry name, args, port inputs, JAX inputs, forward of each)."""
    if kind == "ss_flow":
        x = r.standard_normal((1, 8, 8, 8, 4)).astype(np.float32)
        t = np.array([731.0], np.float32)
        c = r.standard_normal((1, 20, 128)).astype(np.float32)
        return ("SparseStructureFlowModel", SS_FLOW,
                [torch.from_numpy(a) for a in (x, t, c)],
                [jnp.asarray(a) for a in (x, t, c)],
                lambda out: out, lambda out: out)
    if kind == "ss_decoder":
        z = r.standard_normal((1, 8, 8, 8, 4)).astype(np.float32)
        return ("SparseStructureDecoder", SS_DEC, [torch.from_numpy(z)],
                [jnp.asarray(z)], lambda out: out, lambda out: out)
    if kind == "gs_decoder":
        p, j = _voxels(3, cap=64, n=50, res=16, C=4)
        m = p.valid.numpy()[0].repeat(8)
        return ("ElasticSLatGaussianDecoder", GS_DEC, [p], [j],
                lambda out: out[0].to_activated_tensor()[0][m],
                lambda out: np.asarray(out[0].to_activated_tensor())[0][m])
    x = r.uniform(-1, 1, (2, 28, 28, 3)).astype(np.float32)
    return ("DinoV2", DINO, [torch.from_numpy(x)], [jnp.asarray(x)],
            lambda out: out[0], lambda out: out[0])


@pytest.mark.parametrize("kind", ["ss_flow", "ss_decoder", "gs_decoder",
                                  "dinov2"])
def test_from_pretrained_matches_jax(kind, tmp_path):
    """JAX's create_model + init + save_params_npz into a pretrained
    directory; the port's from_pretrained gives JAX's forward at fp32."""
    r = np.random.default_rng(40)
    name, args, p_in, j_in, p_out, j_out = _case(kind, r)
    jm, params = write_model(str(tmp_path), kind, name, args, j_in, seed=41)
    model = pr.from_pretrained(str(tmp_path), kind, device="cpu")
    assert not model.training
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        got = p_out(model(*p_in))
    want = j_out(jm.apply(params, *j_in))
    err = _rel(got, want)
    assert err <= MODULE, err


def test_not_ported_names_and_formats_raise(tmp_path):
    """The JAX registry's names whose class the port lacks raise
    NotImplementedError; an unknown name KeyError, as in JAX; a torch
    checkpoint of a class JAX has no converter for ValueError, as in JAX
    (utils/weight_convert.py reads it; `_converters` has the DiT and the
    two VAEs)."""
    assert pr.NOT_PORTED == (
        "SparseStructureEncoder", "SLatEncoder", "SLatRadianceFieldDecoder",
        "SLatMeshDecoder", "ElasticSLatMeshDecoder", "TpuSLatMeshDecoder")
    jr._populate()
    assert set(pr.NOT_PORTED) < set(jr.MODEL_REGISTRY)
    pr._populate()
    assert set(pr.MODEL_REGISTRY) | set(pr.NOT_PORTED) == \
        set(jr.MODEL_REGISTRY)
    for name in pr.NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pr.create_model(name)
    with pytest.raises(KeyError):
        pr.create_model("NoSuchModel")
    with pytest.raises(KeyError):
        jr.create_model("NoSuchModel")
    from safetensors.torch import save_file

    sd = pr.create_model("SparseStructureDecoder", **SS_DEC).state_dict()
    for ext in (".pt", ".safetensors"):
        path = str(tmp_path / f"m{ext}")
        if ext == ".pt":
            torch.save(sd, path)
        else:
            save_file({k: v.contiguous() for k, v in sd.items()}, path)
        for load in (pr.load_params, jr.load_params):
            with pytest.raises(ValueError, match="converter"):
                load(path)
        with open(tmp_path / f"m{ext[1:]}.json", "w") as f:
            json.dump({"name": "SparseStructureDecoder", "args": SS_DEC,
                       "weights": f"m{ext}"}, f)
        with pytest.raises(ValueError, match="converter"):
            pr.from_pretrained(str(tmp_path), f"m{ext[1:]}", device="cpu")


def test_npz_tree_and_pipeline_spec_round_trip(tmp_path):
    """save_params_npz / load_params / flatten_tree / _unflatten and
    load_pipeline_spec read and write what the JAX package does."""
    tree = {"params": {"a": {"kernel": np.arange(6.0).reshape(2, 3)},
                       "b": np.ones(4, np.float32)}}
    pr.save_params_npz(tree, str(tmp_path / "p.npz"))
    back = jr.load_params(str(tmp_path / "p.npz"))
    assert pr.flatten_tree(back).keys() == jr.flatten_tree(tree).keys()
    np.testing.assert_array_equal(back["params"]["a"]["kernel"],
                                  tree["params"]["a"]["kernel"])
    jr.save_params_npz(tree, str(tmp_path / "q.npz"))
    mine = pr.load_params(str(tmp_path / "q.npz"))
    assert pr._unflatten(pr.flatten_tree(mine)).keys() == mine.keys()
    np.testing.assert_array_equal(mine["params"]["b"], tree["params"]["b"])
    spec = {"name": "TrellisImageTo3DPipeline",
            "models": {"ss_flow": "ss_flow"}}
    with open(tmp_path / "pipeline.json", "w") as f:
        json.dump(spec, f)
    assert pr.load_pipeline_spec(str(tmp_path)) == \
        jr.load_pipeline_spec(str(tmp_path)) == spec
    with pytest.raises(ValueError):
        pr.load_params(str(tmp_path / "p.bin"))
    if not torch.cuda.is_available():  # the card by default, or a raise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pr.from_pretrained(str(tmp_path), "p")


def _same_tree(a, b):
    fa, fb = pr.flatten_tree(a), pr.flatten_tree(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("kind", ["dinov2", "ss_flow", "ss_flow_shared",
                                  "ss_decoder", "slat_flow",
                                  "slat_flow_shared", "gs_decoder"])
def test_flax_params_match_jax_convert(kind):
    """The torch -> flax direction of each model's weight table
    (utils/weights.py's `to_flax`, which writes the smoke's pretrained
    directory) gives JAX's convert_* trees exactly, and the table's flax ->
    torch direction takes them back."""
    from gvfdiffusion_torch.models.dinov2 import DinoV2
    from gvfdiffusion_torch.models.trellis.slat_decoders import (
        SLatGaussianDecoder)
    from gvfdiffusion_torch.models.trellis.slat_flow import SLatFlowModel
    from gvfdiffusion_torch.models.trellis.ss_flow import (
        SparseStructureFlowModel)
    from gvfdiffusion_torch.models.trellis.ss_vae import (
        SparseStructureDecoder)
    from gvfdiffusion_torch.utils import weights as pw
    from gvfdiffusion_tpu.utils import weight_convert as wc

    shared = kind.endswith("_shared")
    if kind == "dinov2":
        m = DinoV2(img_size=28, embed_dim=64, depth=2, num_heads=1)
        table, back = pw.dinov2_table, lambda t: pw.dinov2_state_dict_from_flax(
            t, 2)
        jax_fn = lambda sd: wc.convert_dinov2(sd, depth=2)
        args = (2,)
    elif kind.startswith("ss_flow"):
        m = SparseStructureFlowModel(
            resolution=8, in_channels=4, out_channels=4, model_channels=128,
            cond_channels=128, num_blocks=2, num_heads=2, qk_rms_norm=True,
            share_mod=shared)
        table = pw.ss_flow_table
        back = lambda t: pw.ss_flow_state_dict_from_flax(t, 2, 4, 4, 2)
        jax_fn = lambda sd: wc.convert_ss_flow(
            sd, 2, 4, 4, 2, share_mod=shared, qk_rms_norm=True)
        args = (2, 4, 4, 2)
    elif kind == "ss_decoder":
        m = SparseStructureDecoder(latent_channels=4, num_res_blocks=1,
                                   channels=(64, 32), num_res_blocks_middle=1,
                                   norm_type="group")
        table = pw.ss_decoder_table
        back = lambda t: pw.ss_decoder_state_dict_from_flax(t, (64, 32), 1, 1)
        jax_fn = lambda sd: wc.convert_ss_decoder(sd, (64, 32), 1, 1)
        args = ((64, 32), 1, 1)
    elif kind.startswith("slat_flow"):
        m = SLatFlowModel(resolution=16, in_channels=4, out_channels=4,
                          model_channels=128, cond_channels=128, num_blocks=2,
                          num_heads=2, io_block_channels=(16,),
                          qk_rms_norm=True, qk_rms_norm_cross=shared,
                          share_mod=shared)
        table = pw.slat_flow_table
        back = lambda t: pw.slat_flow_state_dict_from_flax(t, 2, (16,), 2)
        jax_fn = lambda sd: wc.convert_slat_flow(
            sd, 2, (16,), 2, share_mod=shared, qk_rms_norm=True,
            qk_rms_norm_cross=shared)
        args = (2, (16,), 2)
    else:
        m = SLatGaussianDecoder(resolution=16, model_channels=128,
                                latent_channels=4, num_blocks=2, num_heads=2)
        table = pw.slat_gs_decoder_table
        back = lambda t: pw.slat_gs_decoder_state_dict_from_flax(t, 2)
        jax_fn = lambda sd: wc.convert_slat_gs_decoder(sd, 2)
        args = (2,)
    sd = pw.init_random_(m, seed=44).state_dict()
    tree = pw.to_flax(table(*args), sd)
    _same_tree(tree, jax_fn({k: v.numpy() for k, v in sd.items()}))
    again = back(tree)
    assert again.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(again[k].numpy(), sd[k].numpy(),
                                      err_msg=k)


def test_registry_builds_the_video_models_from_the_shipped_config():
    """The DiT and the motion VAE (under the reference's name) from
    configs/diffusion.yml's sections, whose keys (the motion VAE's encoder
    fields, num_inputs, num_latents, knn_k and beta, among them) both
    registries take."""
    import dataclasses

    from gvfdiffusion_torch.models.dit import DiT
    from gvfdiffusion_torch.models.motion_vae import MotionVAE
    from gvfdiffusion_torch.utils.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..",
                                   "configs", "diffusion.yml"))
    vae_kw = dataclasses.asdict(cfg.motion_vae)
    jr.create_model("GSKLTemporalVariationalAutoEncoder", **vae_kw)
    vae = pr.create_model("GSKLTemporalVariationalAutoEncoder", **vae_kw)
    assert isinstance(vae, MotionVAE) and len(vae.layers) == vae_kw["depth"]
    dit_kw = dict(dataclasses.asdict(cfg.model), num_blocks=2)
    jr.create_model("DiT", **dit_kw)
    dit = pr.create_model("DiT", **dit_kw)
    assert isinstance(dit, DiT) and len(dit.blocks) == 2
