"""Port parity of the latent-encoding CLI (cli/encode_latent.py), the step
between the VAE trainer and the DiT trainer, and the chain of the three.

- JAX's `encode_latent.main` and the port's run over the same two objects
  (tests/_vae_data.py) on a tiny config (static VAE at resolution 16, 2
  blocks of 64 channels in the shipped `swin` mode; motion VAE depth 1,
  width 48) on the same weights: seeded
  non-zero ones (`init_random_`: the modules' zero inits would make the
  decoded Gaussians a fixed lattice, whose FPS ties a last bit decides),
  written as a port trainer checkpoint for the port and carried across by
  utils/weights into an orbax checkpoint of `{"params": ...}` for JAX
  (the layout JAX's CLI restores; it cannot restore its own trainer's
  checkpoints). The port's `deformation_latent.pt` against JAX's
  `deformation_latent.npz`: the latents at rel L2 <= 1e-5; the FPS samples
  the same rows in the same order (each port row's nearest JAX row is its
  own, the rows apart by less than a hundredth of their nearest other row)
  at rel L2 <= 1e-5, their values computed by two frameworks; the voxel
  features and coordinates, read from the files, equal.
- The chain on the port alone: `main_vae` for one step, `encode_latent` on
  its checkpoints, `main_latent` for one step on the written latents, with
  a finite loss.
- A checkpoint directory without a checkpoint raises; `--shard` /
  `--num_shards` split the items.

Both CLIs build the VAE dataset at its default 32768 voxel slots, as the
card runs them (`chip_smoke.py` `[encode-latent]`); here both packages'
`VAEDataset` is patched to CAPACITY slots, since the FPS of 4096 samples
over 8 x 32768 padded Gaussians takes some 30 s an object on this CPU in
either package. JAX's models run jitted (`_jit_flax`), as every JAX call
of the port tests does.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gvfdiffusion_torch.cli import encode_latent as penc
from gvfdiffusion_torch.cli import main_latent as platent
from gvfdiffusion_torch.cli import main_vae as pvae
from gvfdiffusion_torch.train.train_state import (create_train_state,
                                                  make_optimizer)
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_torch.utils.checkpoint import CheckpointManager
from gvfdiffusion_torch.utils.config import load_config

sys.path.insert(0, str(Path(__file__).parent))
from _vae_data import write_vae_dir  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = ["--static_vae.resolution=16", "--static_vae.in_channels=8",
        "--static_vae.model_channels=64", "--static_vae.latent_channels=4",
        "--static_vae.num_blocks=2", "--static_vae.num_heads=2",
        "--static_vae.window_size=4",
        "--motion_vae.depth=1", "--motion_vae.dim=48",
        "--motion_vae.queries_dim=48", "--motion_vae.num_latents=8",
        "--motion_vae.latent_dim=4", "--motion_vae.heads=4"]
LATENT_BOUND = 1e-5
CAPACITY = 64  # voxel slots: G = 8 x 64 Gaussians, 160 of them valid
KEYS = ("latent_mean", "latent_std", "fps_sampled_gs_1024",
        "fps_sampled_gs_4096", "static_gs_feats", "static_gs_coords")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _small_capacity(monkeypatch):
    """Both CLIs' VAEDataset at CAPACITY voxel slots."""
    from gvfdiffusion_torch.data import dataset_vae as pds
    from gvfdiffusion_tpu.data import dataset_vae as jds

    for module, cls in ((jds, jds.VAEDataset), (penc, pds.VAEDataset)):
        monkeypatch.setattr(module, "VAEDataset", lambda *a, _cls=cls, **kw:
                            _cls(*a, voxel_capacity=CAPACITY, **kw))


def _jit_flax(monkeypatch, cls):
    """`cls.init` and `cls.apply` jitted, one program per instance and
    method: JAX's CLI calls them eagerly, which compiles op by op (some 30
    s here)."""
    import jax

    init, apply, cache = cls.init, cls.apply, {}

    def jit_init(self, *args, **kw):
        return jax.jit(lambda a, k: init(self, *a, **k))(args, kw)

    def jit_apply(self, variables, *args, method=None):
        key = (id(self), method)
        if key not in cache:
            cache[key] = jax.jit(lambda v, a: apply(self, v, *a,
                                                    method=method))
        return cache[key](variables, args)

    monkeypatch.setattr(cls, "init", jit_init)
    monkeypatch.setattr(cls, "apply", jit_apply)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def write_checkpoints(root: Path, cfg):
    """Seeded static and motion VAEs as port trainer checkpoints
    (root/port_{static,motion}) and as orbax checkpoints of their flax
    variables (root/jax_{static,motion})."""
    from gvfdiffusion_tpu.utils.checkpoint import CheckpointManager as JCM

    sv, mv = cfg.static_vae, cfg.motion_vae
    for name, model, table in (
            ("static", pvae.build_static_vae(cfg),
             pw.static_vae_table(sv.num_blocks)),
            ("motion", pvae.build_motion_vae(cfg),
             pw.motion_vae_table(mv.depth))):
        pw.init_random_(model, seed={"static": 3, "motion": 4}[name])
        CheckpointManager(str(root / f"port_{name}")).save(
            create_train_state(model, make_optimizer(lr=0.0)), 0)
        jm = JCM(str(root / f"jax_{name}"))
        jm.save(pw.to_flax(table, model.state_dict()), 0)
        jm.close()


def test_encode_latent_matches_jax(tmp_path, monkeypatch):
    from gvfdiffusion_tpu.cli import encode_latent as jenc
    from gvfdiffusion_tpu.models import motion_vae as jmv
    from gvfdiffusion_tpu.models import static_vae as jsv

    _jit_flax(monkeypatch, jsv.SparseTransformerVAE)
    _jit_flax(monkeypatch, jmv.MotionVAE)

    write_vae_dir(tmp_path / "data", objects=2, points=32, frames=3,
                  voxels=20, res=16, channels=8)
    cfg = load_config(None, TINY)
    write_checkpoints(tmp_path, cfg)
    common = [f"--data_dir={tmp_path / 'data'}", *TINY]
    assert jenc.main(common + [
        f"--output_dir={tmp_path / 'jax'}",
        f"--static_ckpt={tmp_path / 'jax_static'}",
        f"--motion_ckpt={tmp_path / 'jax_motion'}"]) == 0
    assert penc.main(common + [
        f"--output_dir={tmp_path / 'port'}", "--device=cpu",
        f"--static_ckpt={tmp_path / 'port_static'}",
        f"--motion_ckpt={tmp_path / 'port_motion'}"]) == 0
    for obj in ("obj0", "obj1"):
        # JAX writes the npz alone; the port the .pt the datasets read
        assert not (tmp_path / "jax" / obj / "deformation_latent.pt").exists()
        want = np.load(tmp_path / "jax" / obj / "deformation_latent.npz")
        got = torch.load(tmp_path / "port" / obj / "deformation_latent.pt",
                         weights_only=True)
        assert set(got) == set(want.files) == set(KEYS)
        for k in KEYS:
            assert tuple(got[k].shape) == want[k].shape, k
        assert want["latent_mean"].shape == (3, 8, 4)
        assert want["fps_sampled_gs_4096"].shape == (8 * CAPACITY, 14)
        for k in ("latent_mean", "latent_std"):
            assert rel_l2(got[k], want[k]) <= LATENT_BOUND, (obj, k)
        for k in ("fps_sampled_gs_1024", "fps_sampled_gs_4096"):
            a, b = got[k].numpy(), want[k]
            assert rel_l2(a, b) <= LATENT_BOUND, (obj, k)
            # the same Gaussians in the same order: every valid one (20
            # voxels x 8) first, then the first valid one repeated
            d = np.linalg.norm(a[:, None, :3] - b[None, :, :3], axis=-1)
            n_valid = 20 * 8
            idx = np.arange(n_valid)
            assert (d[idx][:, :n_valid].argmin(1) == idx).all(), (obj, k)
            other = d[idx][:, :n_valid] + np.eye(n_valid) * 1e9
            assert (d[idx, idx] < 0.01 * other.min(1)).all(), (obj, k)
            np.testing.assert_array_equal(a[n_valid:],
                                          np.broadcast_to(a[:1], a[n_valid:]
                                                          .shape))
        for k in ("static_gs_feats", "static_gs_coords"):
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert np.isfinite(got["latent_mean"].numpy()).all()


def test_chain_main_vae_encode_latent_main_latent(tmp_path, capsys):
    """The port's three training steps on the CPU: the VAEs (one step of
    each phase), the latents from their checkpoints, the DiT (one step) on
    those latents."""
    write_vae_dir(tmp_path / "data", objects=2, points=32, frames=3,
                  voxels=20, res=16, channels=8)
    vae_args = [f"--data_dir={tmp_path / 'data'}", *TINY,
                "--static_vae.voxel_capacity=32", "--motion_vae.knn_k=8",
                "--motion_vae.num_inputs=16", "--train.batch_size=1",
                "--train.warmup_steps=0", "--train.sample_timesteps=2",
                "--train.static_vae_steps=1", "--train.total_steps=2",
                "--train.save_interval=1", "--train.log_interval=1",
                "--render.resolution=16", "--render.max_per_tile=32",
                "--loss.lambda_lpips=0", "--device=cpu"]
    exp = tmp_path / "vae"
    assert pvae.main(vae_args + [f"--exp_dir={exp}"]) == 0
    out = tmp_path / "latents"
    # one object per shard: shard 1 of 2 encodes obj1 alone
    assert penc.main([f"--data_dir={tmp_path / 'data'}", *TINY,
                      f"--output_dir={out}", "--device=cpu", "--debug",
                      "--shard=1", "--num_shards=2",
                      f"--static_ckpt={exp / 'static_vae'}",
                      f"--motion_ckpt={exp / 'motion_vae'}"]) == 0
    err = capsys.readouterr().err
    assert "shard 1/2: 1 items" in err and "obj1: delta-xyz ms" in err
    assert "static VAE restored from" in err and "(step 1)" in err
    assert sorted(os.listdir(out / "obj1")) == ["deformation_latent.pt"]
    assert not (out / "obj0").exists()
    dit = tmp_path / "dit"
    assert platent.main([
        "--device=cpu", "--config", str(REPO / "configs" / "diffusion.yml"),
        f"--data_dir={out}", f"--exp_dir={dit}",
        "--model.model_channels=64", "--model.num_heads=2",
        "--model.num_blocks=1", "--model.resolution=8",
        "--model.in_channels=4", "--model.out_channels=4",
        "--model.image_cond_channels=1024", "--train.batch_size=1",
        "--train.sample_timesteps=2", "--train.log_interval=1",
        "--train.total_steps=1"]) == 0
    err = capsys.readouterr().err
    loss = float(err.split("step 0 loss ")[1].split()[0])
    assert np.isfinite(loss)
    assert CheckpointManager(str(dit / "checkpoints")).all_steps() == [1]


def test_checkpoint_directory_without_checkpoint_raises(tmp_path):
    write_vae_dir(tmp_path / "data", objects=1, res=16, channels=8)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        penc.main([f"--data_dir={tmp_path / 'data'}", *TINY,
                    f"--output_dir={tmp_path / 'out'}", "--device=cpu",
                    f"--motion_ckpt={tmp_path / 'empty'}"])
