"""Port parity and end-to-end runs of the VAE training CLI
(`cli/main_vae.py`) and its dataset (`data/dataset_vae.py`).

- `VAEDataset` + `load_data` give the JAX package's batches, array for
  array and exactly (the same generators drawn in the same order), on one
  seeded directory (tests/_vae_data.py); `rescale_voxel_coords` and
  `opengl_to_colmap_w2c` equal JAX's.
- `main_vae.main(--device=cpu)` runs both phases at a tiny width, in the
  shipped `swin` mode and in `full`, writes both checkpoint directories,
  and a second run resumes from them.
- `init_static_from_torch` on a `.pt` the test writes under the
  reference's names: with a Gaussian head of another width the out layer
  stays fresh (shape surgery) and everything else loads, as JAX's
  `init_static_from_torch` loads it (exactly); with the CLI the encoder
  stays frozen through phase A; a checkpoint in another layout, `.pt` or
  `.safetensors`, raises.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.cli import main_vae as pcli
from gvfdiffusion_torch.data import dataset_vae as pds
from gvfdiffusion_torch.models.static_vae import SparseTransformerVAE
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_tpu.cli import main_vae as jcli
from gvfdiffusion_tpu.data import dataset_vae as jds
from gvfdiffusion_tpu.models import static_vae as jsv
from gvfdiffusion_tpu.sparse import tensor as jst

sys.path.insert(0, str(Path(__file__).parent))
from _vae_data import write_vae_dir  # noqa: E402

TINY = ["--static_vae.resolution=16", "--static_vae.in_channels=8",
        "--static_vae.model_channels=128", "--static_vae.latent_channels=4",
        "--static_vae.num_blocks=2", "--static_vae.num_heads=2",
        "--static_vae.window_size=4", "--static_vae.voxel_capacity=32",
        "--static_vae.remat_blocks=1",
        "--motion_vae.depth=1", "--motion_vae.dim=36",
        "--motion_vae.queries_dim=36", "--motion_vae.num_inputs=16",
        "--motion_vae.num_latents=4", "--motion_vae.latent_dim=4",
        "--motion_vae.heads=4", "--motion_vae.knn_k=4",
        "--train.batch_size=2", "--train.warmup_steps=0",
        "--train.log_interval=1", "--train.sample_timesteps=2",
        "--render.resolution=16", "--render.max_per_tile=32",
        "--loss.lambda_lpips=0", "--device=cpu"]
VAE = dict(resolution=16, in_channels=8, model_channels=128,
           latent_channels=4, num_blocks=2, num_heads=2, window_size=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dataset_batches_match_jax(tmp_path):
    write_vae_dir(tmp_path, objects=3, points=40, frames=4, voxels=30,
                  res=32)
    kw = dict(resolution=16, num_points=24, num_timesteps=2, num_views=2,
              image_size=16, voxel_capacity=40, seed=3)
    port = pds.load_data(pds.VAEDataset(str(tmp_path), **kw), 2)
    ref = jds.load_data(jds.VAEDataset(str(tmp_path), **kw), 2)
    for _ in range(3):
        a, b = next(port), next(ref)
        assert set(a) == set(b)
        for f in ("feats", "coords", "valid"):
            np.testing.assert_array_equal(getattr(a["feats"], f).numpy(),
                                          np.asarray(getattr(b["feats"], f)))
        assert a["feats"].resolution == b["feats"].resolution == 16
        for k in a:
            if k != "feats":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    c2w = np.random.default_rng(4).standard_normal((4, 4)) + 3 * np.eye(4)
    np.testing.assert_array_equal(pds.opengl_to_colmap_w2c(c2w),
                                  jds.opengl_to_colmap_w2c(c2w))


@pytest.mark.parametrize("mode", ["swin", "full"])
def test_main_vae_two_phases_and_resume(tmp_path, mode, capsys):
    write_vae_dir(tmp_path / "data", objects=2)
    common = [f"--data_dir={tmp_path / 'data'}",
              f"--exp_dir={tmp_path / 'exp'}",
              f"--static_vae.attn_mode={mode}", "--train.static_vae_steps=2",
              "--train.save_interval=1", *TINY]
    assert pcli.main(["--train.total_steps=4", *common]) == 0
    out = capsys.readouterr().err  # the logger's messages
    for step, phase in ((0, "A"), (1, "A"), (2, "B"), (3, "B")):
        assert f"step {step} phase {phase} " in out
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in out.splitlines() if " phase " in line]
    assert len(losses) == 4 and np.isfinite(losses).all()
    for d in ("static_vae", "motion_vae"):
        steps = pcli.CheckpointManager(str(tmp_path / "exp" / d)).all_steps()
        assert steps and steps[-1] == 3, (d, steps)
    # the logger's files in exp_dir, with JAX's keys
    with open(tmp_path / "exp" / "progress.csv") as f:
        header = f.readline().strip().split(",")
    assert {"step", "loss", "step_time"} <= set(header), header
    assert "| loss " in (tmp_path / "exp" / "log.txt").read_text()
    # a second run resumes both states from step 3
    assert pcli.main(["--train.total_steps=5", *common]) == 0
    out = capsys.readouterr().err  # the logger's messages
    assert "auto-resumed the static VAE from step 3" in out
    assert "auto-resumed the motion VAE from step 3" in out
    assert "step 3 phase B" in out and "step 2 phase" not in out


def _write_torch_vae(path, out_channels, seed=5):
    """A static VAE's state dict under the reference's names, DDP-prefixed."""
    model = pw.init_random_(SparseTransformerVAE(**VAE,
                                                 out_channels=out_channels),
                            seed=seed)
    torch.save({"module." + k: v for k, v in model.state_dict().items()},
               path)
    return model.state_dict()


@pytest.mark.parametrize("out_channels", [10, 112])
def test_init_static_from_torch_matches_jax(tmp_path, out_channels):
    path = str(tmp_path / "static.pt")
    theirs = _write_torch_vae(path, out_channels)
    mine = SparseTransformerVAE(**VAE, out_channels=112)
    mine.init_weights_(torch.Generator().manual_seed(0))
    fresh_out = mine.out_layer.weight.detach().clone()
    surgery = pcli.init_static_from_torch(mine, path)
    assert surgery == (out_channels != 112)

    jm = jsv.SparseTransformerVAE(**VAE, out_channels=112)
    x = jst.from_lists([np.array([[1, 2, 3]])], [np.ones((1, 8), np.float32)],
                       resolution=16, capacity=4)
    fresh = jm.init(jax.random.PRNGKey(0), x, jax.random.PRNGKey(1))
    loaded = jcli.init_static_from_torch(fresh, path, num_blocks=2,
                                         num_heads=2)
    want = pw.from_flax(pw.static_vae_table(2), loaded)
    for name, p in mine.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(),
                                      err_msg=name)
        if not (surgery and name.startswith("out_layer.")):
            np.testing.assert_array_equal(p.detach().numpy(),
                                          theirs[name].numpy(), err_msg=name)
    if surgery:  # the fresh zero-init Gaussian head
        assert torch.equal(mine.out_layer.weight.detach(), fresh_out)


def test_init_static_other_layouts_raise(tmp_path):
    mine = SparseTransformerVAE(**VAE, out_channels=112)
    flax_named = str(tmp_path / "flax.pt")
    torch.save({"input_layer/Dense_0/kernel": torch.zeros(8, 128)},
               flax_named)
    with pytest.raises(KeyError, match="reference's names"):
        pcli.init_static_from_torch(mine, flax_named)
    from safetensors.torch import save_file

    save_file({"input_layer/Dense_0/kernel": torch.zeros(8, 128)},
              str(tmp_path / "x.safetensors"))
    with pytest.raises(KeyError, match="reference's names"):
        pcli.init_static_from_torch(mine, str(tmp_path / "x.safetensors"))


def test_main_vae_freezes_the_loaded_encoder(tmp_path):
    """static_vae_init without finetune_encoder: through phase A the
    encoder keeps the checkpoint's values and the decoder trains."""
    write_vae_dir(tmp_path / "data", objects=1)
    path = str(tmp_path / "static.pt")
    theirs = _write_torch_vae(path, 10)
    assert pcli.main([f"--data_dir={tmp_path / 'data'}",
                      f"--exp_dir={tmp_path / 'exp'}",
                      f"--train.static_vae_init={path}",
                      "--train.total_steps=2", "--train.static_vae_steps=2",
                      "--train.save_interval=1", *TINY]) == 0
    mgr = pcli.CheckpointManager(str(tmp_path / "exp" / "static_vae"))
    sd = torch.load(mgr._path(mgr.latest_step()), weights_only=True)
    params = sd["params"]
    enc = [k for k in params if k.startswith("encoder.")]
    dec = [k for k in params if k.startswith("decoder.")]
    assert enc and dec
    for k in enc:
        assert torch.equal(params[k], theirs[k]), k
    assert any(not torch.equal(params[k], theirs[k]) for k in dec)
    assert set(sd["opt_state"]["mu"]) == set(params) - set(enc)
