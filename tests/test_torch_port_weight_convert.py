"""Port parity: utils/weight_convert.py, utils/hub.py and the registry's
torch checkpoints, against the JAX package on the CPU.

For each converter a seeded state dict under the reference's names (the
port's module at a small width, `init_random_`) goes through JAX's
`convert_*` and through the port's of the same name with the same
arguments; `weights.to_flax(table, port(sd))` must equal JAX's tree bit for
bit, and the port's output must load into the module (strict) and give
back the state dict (the surgery and the old qkv layout apart). Also: the
port's `.safetensors` reader against `safetensors.numpy.load_file`,
`load_torch_checkpoint`'s wrappers, and `hub` on a fabricated mirror
against JAX's `download_model_files` / `load_gvf_release`, with the
missing-file and unknown-name errors; `registry.from_pretrained` of a
`.pt` / `.safetensors` release file against its `.npz` twin.
"""

import json
import os

import numpy as np
import pytest
import torch

from gvfdiffusion_torch.models import registry as pr
from gvfdiffusion_torch.models.clip import CLIPImageEncoder
from gvfdiffusion_torch.models.dinov2 import DinoV2
from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.models.motion_vae import MotionVAE
from gvfdiffusion_torch.models.static_vae import SparseTransformerVAE
from gvfdiffusion_torch.models.trellis.slat_decoders import (
    SLatGaussianDecoder)
from gvfdiffusion_torch.models.trellis.slat_flow import SLatFlowModel
from gvfdiffusion_torch.models.trellis.ss_flow import (
    SparseStructureFlowModel)
from gvfdiffusion_torch.models.trellis.ss_vae import SparseStructureDecoder
from gvfdiffusion_torch.utils import hub as phub
from gvfdiffusion_torch.utils import weight_convert as pwc
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_tpu.models import registry as jr
from gvfdiffusion_tpu.utils import hub as jhub
from gvfdiffusion_tpu.utils import weight_convert as jwc

DIT = dict(model_channels=64, num_heads=4, num_blocks=2, in_channels=6,
           out_channels=6, static_cond_channels=7, image_cond_channels=9)
MVAE = dict(depth=2, dim=48, queries_dim=48, heads=4, num_latents=8,
            latent_dim=4, num_inputs=32, knn_k=4)
SVAE = dict(resolution=16, in_channels=8, model_channels=32,
            out_channels=10, latent_channels=4, num_blocks=2, num_heads=4,
            window_size=4)
SS_FLOW = dict(resolution=8, in_channels=4, out_channels=4,
               model_channels=64, cond_channels=64, num_blocks=2,
               num_heads=2)
SS_DEC = dict(latent_channels=4, num_res_blocks=1, num_res_blocks_middle=1,
              channels=(16, 8))
SLAT = dict(in_channels=8, out_channels=8, model_channels=64,
            cond_channels=64, num_blocks=2, num_heads=2,
            io_block_channels=(16,), num_io_res_blocks=2)
GS_DEC = dict(resolution=16, model_channels=64, latent_channels=4,
              num_blocks=2, num_heads=2, window_size=4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _np_sd(model):
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


# (name, port module, its table, converter kwargs)
CASES = {
    "dit": (lambda: DiT(**DIT), lambda: pw.dit_table(2),
            dict(num_blocks=2)),
    "dit_share_mod_no_temporal": (
        lambda: DiT(**DIT, share_mod=True, no_temporal_attn=True,
                    pe_mode="learnable", qk_rms_norm=False),
        lambda: pw.dit_table(2),
        dict(num_blocks=2, share_mod=True, no_temporal_attn=True,
             qk_rms_norm=False)),
    "motion_vae": (lambda: MotionVAE(**MVAE),
                   lambda: pw.motion_vae_table(2), dict(depth=2)),
    "static_vae": (lambda: SparseTransformerVAE(**SVAE),
                   lambda: pw.static_vae_table(2),
                   dict(num_blocks=2, num_heads=4)),
    "static_vae_old_qkv": (lambda: SparseTransformerVAE(**SVAE),
                           lambda: pw.static_vae_table(2),
                           dict(num_blocks=2, num_heads=4,
                                old_qkv_layout=True)),
    "static_vae_to_slat_decoder": (
        lambda: SparseTransformerVAE(**dict(SVAE, out_channels=_gs_out())),
        lambda: pw.slat_gs_decoder_table(2), dict(num_blocks=2)),
    "dinov2": (lambda: DinoV2(img_size=28, embed_dim=64, depth=2,
                              num_heads=2),
               lambda: pw.dinov2_table(2), dict(depth=2)),
    "clip_visual": (lambda: CLIPImageEncoder(image_size=64, patch_size=16,
                                             width=64, depth=2, heads=4,
                                             embed_dim=32),
                    lambda: pw.clip_table(2), dict(depth=2)),
    "ss_flow": (lambda: SparseStructureFlowModel(**SS_FLOW,
                                                 qk_rms_norm=True),
                lambda: pw.ss_flow_table(2, 4, 4),
                dict(num_blocks=2, in_channels=4, out_channels=4,
                     qk_rms_norm=True)),
    "ss_flow_share_mod": (
        lambda: SparseStructureFlowModel(**SS_FLOW, share_mod=True,
                                         qk_rms_norm_cross=True),
        lambda: pw.ss_flow_table(2, 4, 4),
        dict(num_blocks=2, in_channels=4, out_channels=4, share_mod=True,
             qk_rms_norm_cross=True)),
    "ss_decoder": (lambda: SparseStructureDecoder(**SS_DEC),
                   lambda: pw.ss_decoder_table((16, 8), 1, 1),
                   dict(channels=(16, 8), num_res_blocks=1,
                        num_res_blocks_middle=1)),
    "slat_flow": (lambda: SLatFlowModel(**SLAT, qk_rms_norm=True),
                  lambda: pw.slat_flow_table(2, (16,), 2),
                  dict(num_blocks=2, io_block_channels=(16,),
                       qk_rms_norm=True)),
    "slat_gs_decoder": (lambda: SLatGaussianDecoder(**GS_DEC),
                        lambda: pw.slat_gs_decoder_table(2),
                        dict(num_blocks=2)),
}
SURGERY_DEC = dict(resolution=16, model_channels=32, latent_channels=4,
                  num_blocks=2, num_heads=4, window_size=4)


def _gs_out():
    """The out channels of the SLat decoder the surgery's VAE feeds."""
    return SLatGaussianDecoder(**SURGERY_DEC).out_layer.out_features


CONVERTER = {"dit_share_mod_no_temporal": "dit",
             "static_vae_old_qkv": "static_vae",
             "ss_flow_share_mod": "ss_flow"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_converter_matches_jax_bit_for_bit(case):
    make, table, kw = CASES[case]
    model = pw.init_random_(make(), seed=len(case))
    sd = _np_sd(model)
    fn = "convert_" + CONVERTER.get(case, case)
    got = getattr(pwc, fn)(sd, **kw)
    _same_tree(pw.to_flax(table(), got), getattr(jwc, fn)(sd, **kw))
    surgery = case == "static_vae_to_slat_decoder"
    fresh = SLatGaussianDecoder(**SURGERY_DEC) if surgery else make()
    fresh.load_state_dict(got)  # strict: names and shapes
    for k, v in fresh.state_dict().items():
        src = (k.replace("input_layer.", "from_latent.")
               .replace("blocks.", "decoder.") if surgery else k)
        if case != "static_vae_old_qkv" or "to_qkv" not in k:
            np.testing.assert_array_equal(v.numpy(), sd[src], err_msg=k)


def test_missing_required_name_raises_as_in_jax():
    make, _, kw = CASES["dit"]
    sd = _np_sd(pw.init_random_(make(), 1))
    del sd["blocks.1.mlp.mlp.0.weight"]
    with pytest.raises(KeyError, match="blocks.1.mlp.mlp.0.weight"):
        pwc.convert_dit(sd, **kw)
    with pytest.raises(KeyError):
        jwc.convert_dit(sd, **kw)


def test_old_qkv_layout_permutation_matches_jax():
    w = np.random.default_rng(3).standard_normal((3 * 4 * 8, 5)).astype(
        np.float32)
    got = pwc._old_qkv_to_new(torch.from_numpy(w), 4).numpy()
    np.testing.assert_array_equal(got, jwc._old_qkv_to_new(w, 4))
    np.testing.assert_array_equal(
        pwc._old_qkv_to_new(torch.from_numpy(w[:, 0]), 4).numpy(),
        jwc._old_qkv_to_new(w[:, 0], 4))


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import save_file as save_torch

    r = np.random.default_rng(4)
    arrays = {"a.weight": r.standard_normal((3, 5)).astype(np.float32),
              "b": r.standard_normal((7,)).astype(np.float16),
              "c.idx": r.integers(-9, 9, (2, 3, 4)).astype(np.int64),
              "empty": np.zeros((0, 4), np.float32),
              "scalar": np.asarray(2.5, np.float32)}
    path = str(tmp_path / "x.safetensors")
    save_file(arrays, path, metadata={"format": "pt"})
    got, want = pwc.read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    bf = torch.randn(4, 6, generator=torch.Generator().manual_seed(5)
                     ).bfloat16()
    save_torch({"w": bf}, str(tmp_path / "bf.safetensors"))
    assert torch.equal(pwc.read_safetensors(
        str(tmp_path / "bf.safetensors"))["w"], bf)
    # load_torch_checkpoint: the JAX package's reader on the same file
    np.testing.assert_array_equal(
        pwc.load_torch_checkpoint(path)["a.weight"].numpy(),
        jwc.load_torch_checkpoint(path)["a.weight"])


def test_load_torch_checkpoint_opens_wrappers(tmp_path):
    sd = {"x.weight": torch.arange(6.0).reshape(2, 3), "y": torch.ones(2)}
    path = str(tmp_path / "c.pt")
    torch.save({"state_dict": {"module.x.weight": sd["x.weight"],
                               "y": sd["y"]}}, path)
    got = pwc.load_torch_checkpoint(path)
    want = jwc.load_torch_checkpoint(path)
    assert sorted(got) == sorted(want) == ["x.weight", "y"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


# -- hub ----------------------------------------------------------------------

REPO = phub.MODEL_REPOS["GVFDiffusion_v1.0"]
HUB_KW = dict(dit_kwargs=dict(num_blocks=2), vae_kwargs=dict(depth=2),
              static_vae_kwargs=dict(num_blocks=2, num_heads=4))


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    """A release in MODEL_REPOS's layout: the seeded models as `.pt` with
    a `module.` prefix on every other key, the stats as bare tensors."""
    root = tmp_path_factory.mktemp("hub")
    repo = root / REPO["repo_id"]
    repo.mkdir(parents=True)
    models = {"model_path": pw.init_random_(DiT(**DIT), 1),
              "vae_path": pw.init_random_(MotionVAE(**MVAE), 2),
              "static_vae_path": pw.init_random_(
                  SparseTransformerVAE(**SVAE), 3)}
    for key, m in models.items():
        torch.save({("module." + k if i % 2 == 0 else k): v for i, (k, v) in
                    enumerate(m.state_dict().items())}, repo / REPO[key])
    g = torch.Generator().manual_seed(9)
    for key in ("static_mean", "static_std", "deformation_mean",
                "deformation_std"):
        torch.save(torch.rand(14 if "static" in key else 4, generator=g),
                   repo / REPO[key + "_path"])
    return str(root), models


def test_model_repos_is_jax_s():
    assert phub.MODEL_REPOS == jhub.MODEL_REPOS


def test_hub_resolves_and_loads_as_jax(mirror, monkeypatch):
    root, models = mirror
    files = phub.download_model_files("GVFDiffusion_v1.0", local_hub=root)
    assert files == jhub.download_model_files("GVFDiffusion_v1.0",
                                              local_hub=root)
    monkeypatch.setenv("GVF_HUB_DIR", root)
    assert phub.download_model_files("GVFDiffusion_v1.0") == files
    got = phub.load_gvf_release(files, **HUB_KW, device="cpu")
    want = jhub.load_gvf_release(
        files, dit_kwargs=dict(num_blocks=2, qk_rms_norm=True,
                               no_temporal_attn=False, share_mod=False),
        vae_kwargs=dict(depth=2),
        static_vae_kwargs=dict(num_blocks=2, num_heads=4,
                               old_qkv_layout=False))
    for key, table in (("dit", pw.dit_table(2)),
                       ("motion_vae", pw.motion_vae_table(2)),
                       ("static_vae", pw.static_vae_table(2))):
        _same_tree(pw.to_flax(table, got[key]), want[key])
    for key, m in zip(("dit", "motion_vae", "static_vae"), models.values()):
        own = m.state_dict()
        assert sorted(got[key]) == sorted(own)
        assert all(torch.equal(got[key][k], own[k]) for k in own)
    for key in ("static_mean", "static_std", "deformation_mean",
                "deformation_std"):
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            phub.load_gvf_release(files, **HUB_KW)


def test_hub_errors(mirror, tmp_path, monkeypatch):
    root, _ = mirror
    for hub in (phub, jhub):
        with pytest.raises(ValueError, match="Unknown model name"):
            hub.download_model_files("nope", local_hub=root)
    # a mirror without one file
    partial = tmp_path / REPO["repo_id"]
    partial.mkdir(parents=True)
    for key in ("model_path", "vae_path"):
        os.link(os.path.join(root, REPO["repo_id"], REPO[key]),
                partial / REPO[key])
    for hub in (phub, jhub):
        with pytest.raises(FileNotFoundError, match="static_vae"):
            hub.download_model_files("GVFDiffusion_v1.0",
                                     local_hub=str(tmp_path))
    # no mirror: the port names it and never downloads
    monkeypatch.delenv("GVF_HUB_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="GVF_HUB_DIR"):
        phub.download_model_files("GVFDiffusion_v1.0")


# -- the registry on torch checkpoints -----------------------------------------


def _save_safetensors(sd, path):
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in sd.items()}, path)


@pytest.mark.parametrize("ext", [".pt", ".safetensors"])
def test_from_pretrained_reads_torch_checkpoints(tmp_path, ext):
    """A DiT release file (the reference's names, a `module.` prefix in a
    .pt) through from_pretrained equals the module it was saved from;
    JAX's load_params converts the same file to the tree the port's
    weight table gives."""
    args = dict(DIT, resolution=8)
    src = pw.init_random_(pr.create_model("DiT", **args), 7)
    path = str(tmp_path / f"dit{ext}")
    if ext == ".pt":
        torch.save({"module." + k: v for k, v in src.state_dict().items()},
                   path)
    else:
        _save_safetensors(src.state_dict(), path)
    with open(tmp_path / "dit.json", "w") as f:
        json.dump({"name": "DiT", "args": args, "weights": f"dit{ext}"}, f)
    got = pr.from_pretrained(str(tmp_path), "dit", device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    want = jr.load_params(path, lambda sd: jwc.convert_dit(sd, num_blocks=2))
    _same_tree(pr.flax_params("DiT", args, got), want)
