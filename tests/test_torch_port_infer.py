"""Port parity of the reference launch, on the CPU: the infer CLI
(cli/infer.py) against JAX's flag surface (the cases of
tests/test_infer_cli_flags.py) and against JAX's pipeline; the adaptive
DPM-Solver++ through VideoTo4DPipeline against JAX's pipeline; the fp32
DiT's CFG path; the logger (utils/logger.py) against JAX's, and in the
trainers; load_yaml / to_dict; the weights-only restore.

Sizes: a 2-block DiT of 32 channels (4 heads of 8), 8 latents of 4
channels, T = 4 frames of 5 tokens of 16 channels, 32 Gaussians. At these
widths every attention is the library's (K5's and K6's rules need 128
lanes), in fp32 on both sides.

Tolerances, each with its reason:
  * the adaptive pipeline. The step-size controller makes the run
    sensitive to the last bits: err, the scaled norm of the difference of
    two nearly equal estimates, moves some 1e3 times as much as the DiT's
    output, and every later step follows it. With the seeded DiT, whose
    output is O(1) (the two DiTs agree to rel 1.9e-6 a call), the port
    takes 57 iterations where JAX takes 52, and the port alone, its noise
    moved by 1e-7, takes 57-59 with latents 6e-3-3e-2 apart; so there the
    latent and deltas are held to rel L2 <= 0.1 (ADAPTIVE_CHAOS_BOUND;
    readings 3.7e-2, 2.7e-2) and the iterations to within 20% of JAX's.
    With the DiT's output layer scaled by 0.03 (ADAPTIVE_SMOOTH_SCALE, a
    gentle field whose steps no rounding moves across a decision) the
    port takes JAX's iterations and accepts the same steps, latent and
    deltas rel L2 <= 1e-4 (ADAPTIVE_BOUND; readings 8.4e-6, 5.2e-6).
    The solver alone, on a model both frameworks evaluate to the bit,
    matches JAX exactly: tests/test_torch_port_samplers.py;
  * the fp32 DiT under CFG (2.0 / 5.0) on its hoisted cache, composed as
    on the card and fused as on the CPU, against JAX's CFG path (composed
    on its cache on the CPU): rel L2 <= 1e-3, the bound of
    tests/test_torch_port_pipeline.py's pipeline test;
  * the CLI against the pipeline on the same weights and generator:
    equal;
  * the logger's files against JAX's: equal text.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.cli import infer as pinfer
from gvfdiffusion_torch.cli.main_latent import build_model
from gvfdiffusion_torch.cli.main_vae import build_motion_vae
from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.models.motion_vae import MotionVAE
from gvfdiffusion_torch.nn import transformer as ptr
from gvfdiffusion_torch.pipelines.video_to_4d import (VideoTo4DConfig,
                                                      VideoTo4DPipeline)
from gvfdiffusion_torch.train.train_state import (create_train_state,
                                                  make_optimizer)
from gvfdiffusion_torch.utils import config as pconfig
from gvfdiffusion_torch.utils import logger as plogger
from gvfdiffusion_torch.utils.checkpoint import (CheckpointManager,
                                                 restore_params)
from gvfdiffusion_torch.utils.config import load_config
from gvfdiffusion_torch.utils.weights import (dit_state_dict_from_flax,
                                              init_random_,
                                              motion_vae_state_dict_from_flax)
from gvfdiffusion_tpu.cli import infer as jinfer
from gvfdiffusion_tpu.models.dit import DiT as JaxDiT
from gvfdiffusion_tpu.models.motion_vae import MotionVAE as JaxMotionVAE
from gvfdiffusion_tpu.models.motion_vae import pad_static_gs
from gvfdiffusion_tpu.pipelines import video_to_4d as jpipe
from gvfdiffusion_tpu.utils import config as jconfig
from gvfdiffusion_tpu.utils import logger as jlogger
from gvfdiffusion_tpu.utils.weight_convert import (convert_dit,
                                                   convert_motion_vae)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTIVE_BOUND = 1e-4
ADAPTIVE_CHAOS_BOUND = 0.1
ADAPTIVE_SMOOTH_SCALE = 0.03
CFG_BOUND = 1e-3
T, G, N_LAT, C_LAT, L, CI = 4, 32, 8, 4, 5, 16
DIT_KW = dict(in_channels=C_LAT, model_channels=32, static_cond_channels=14,
              image_cond_channels=CI, out_channels=C_LAT, num_blocks=2,
              num_heads=4)
VAE_KW = dict(depth=1, dim=48, queries_dim=48, output_dim=14,
              latent_dim=C_LAT, heads=4)
# the same sizes as config overrides, for the CLI and build_model / build_motion_vae
OVERRIDES = [f"--model.{k}={v}" for k, v in dict(
    DIT_KW, resolution=N_LAT).items()] + [
    f"--motion_vae.{k}={v}" for k, v in dict(
        VAE_KW, num_inputs=G, num_latents=N_LAT, knn_k=4).items()]
REFERENCE_LAUNCH = ["--input", "x.npz", "--adaptive", "--use_fp16",
                    "--num_timesteps", "32"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# -- the flag surface (tests/test_infer_cli_flags.py's cases) ----------------


def test_defaults_match_reference():
    args, _ = pinfer.build_parser().parse_known_args(["--input", "x.npz"])
    assert (args.guidance_scale, args.guidance_scale2) == (1.0, 1.0)
    assert args.rescale_timesteps == 100 and args.order == 2
    assert not args.adaptive and args.device == "cuda"
    jargs, _ = jinfer.build_parser().parse_known_args(["--input", "x.npz"])
    assert vars(jargs) == {k: v for k, v in vars(args).items()
                           if k != "device"}


def test_reference_launch_flags_parse_and_select_single_pass():
    args, extra = pinfer.build_parser().parse_known_args(REFERENCE_LAUNCH)
    assert extra == []
    cfg = pinfer.pipeline_config_from_args(args, num_frames=32,
                                           num_latents=512, latent_dim=16)
    assert cfg.method == "adaptive" and cfg.steps == 100
    assert (cfg.guidance_scale, cfg.guidance_scale2) == (1.0, 1.0)
    jargs, _ = jinfer.build_parser().parse_known_args(REFERENCE_LAUNCH)
    jcfg = jinfer.pipeline_config_from_args(jargs, 32, 512, 16)
    for f in ("steps", "order", "method", "guidance_scale",
              "guidance_scale2", "num_frames", "num_latents", "latent_dim",
              "fps_anchor_points", "noise_schedule", "diffusion_steps"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_single_pass_branch_skips_cfg_batch():
    """At 1.0 / 1.0 the pipeline builds no 3-way batch, and an fp32 DiT
    (the CLI's) takes no KV cache: JAX's composed path. A bf16 DiT, or
    CFG, hoists it."""
    cfg = VideoTo4DConfig()
    assert (cfg.guidance_scale, cfg.guidance_scale2) == (1.0, 1.0)
    vae = MotionVAE(**VAE_KW)
    for dtype, guidance, hoists in ((torch.float32, (1.0, 1.0), False),
                                    (torch.bfloat16, (1.0, 1.0), True),
                                    (torch.float32, (2.0, 5.0), True)):
        pipe = VideoTo4DPipeline(
            DiT(**DIT_KW, dtype=dtype), vae,
            VideoTo4DConfig(guidance_scale=guidance[0],
                            guidance_scale2=guidance[1]), device="cpu")
        assert pipe.hoists_kv() == hoists, (dtype, guidance)


def test_steps_alias():
    args, _ = pinfer.build_parser().parse_known_args(
        ["--input", "x.npz", "--steps", "8"])
    assert pinfer.pipeline_config_from_args(args, 4, 8, 4).steps == 8


def _write_input(path, seed=11):
    r = np.random.default_rng(seed)
    q = r.standard_normal((G, 4))
    gs = np.concatenate([
        r.uniform(-0.4, 0.4, (G, 3)), r.uniform(0.03, 0.1, (G, 3)),
        q / np.linalg.norm(q, axis=-1, keepdims=True),
        r.standard_normal((G, 3)) * 0.5, r.uniform(0.3, 0.9, (G, 1))],
        -1).astype(np.float32)
    np.savez(path, canonical_gs=gs,
             cond_images=r.standard_normal((T, L, CI)).astype(np.float32))
    return gs


def test_num_timesteps_mismatch_is_an_error(tmp_path):
    npz = tmp_path / "in.npz"
    _write_input(npz)
    with pytest.raises(SystemExit):
        pinfer.main(["--input", str(npz), "--num_timesteps", "32",
                     "--device", "cpu", "--output_dir", str(tmp_path / "o"),
                     *OVERRIDES])


@pytest.mark.parametrize("argv,ok", [
    (["--steps", "8"], True), (["--steps", "100"], True),
    (["--steps", "8", "--rescale_timesteps", "8"], True),
    (["--steps", "8", "--rescale_timesteps", "100"], False),
    (["--rescale_timesteps=50", "--steps=8"], False),
    (["--rescale_t", "50", "--steps", "8"], False)],
    ids=["steps", "steps_is_default", "agree", "disagree", "equals_form",
         "abbreviated"])
def test_steps_and_rescale_timesteps_must_agree(argv, ok):
    """JAX takes --steps over an explicit --rescale_timesteps silently
    (ROADMAP queue 3); the port's parser refuses the disagreement."""
    argv = ["--input", "x.npz", *argv]
    if ok:
        _, args, _ = pinfer.parse_args(argv)
        assert args.rescale_timesteps in (100, 8)
    else:
        with pytest.raises(SystemExit):
            pinfer.parse_args(argv)


def test_main_refuses_to_run_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    npz = tmp_path / "in.npz"
    _write_input(npz)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pinfer.main(["--input", str(npz), "--output_dir", str(tmp_path)])
    assert not (tmp_path / "deformation.npz").exists()


# -- the pipeline against JAX's -----------------------------------------------


def _model_pair(seed=9, out_scale=1.0):
    """The tiny DiT and motion VAE with the same seeded weights in both
    packages; the DiT's output layer scaled by `out_scale`."""
    port_dit = init_random_(DiT(**DIT_KW), seed=seed)
    with torch.no_grad():
        for p in port_dit.final_layer.linear.parameters():
            p.mul_(out_scale)
    dit_params = convert_dit(
        {k: v.numpy().copy() for k, v in port_dit.state_dict().items()},
        num_blocks=2)
    port_dit.load_state_dict(dit_state_dict_from_flax(dit_params, 2))
    port_vae = init_random_(MotionVAE(**VAE_KW), seed + 1)
    vae_params = convert_motion_vae(
        {k: v.numpy().copy() for k, v in port_vae.state_dict().items()},
        depth=1)
    port_vae.load_state_dict(motion_vae_state_dict_from_flax(vae_params,
                                                             depth=1))
    return port_dit.eval(), dit_params, port_vae.eval(), vae_params


def _inputs(seed=12):
    r = np.random.default_rng(seed)
    gs_act = r.normal(size=(G - 4, 14)).astype(np.float32)
    static_gs, valid = pad_static_gs([gs_act], pad_to=G)
    cond = r.standard_normal((1, T, L, CI)).astype(np.float32)
    return static_gs, valid, cond


class _RecordingDiT:
    """JAX's DiT, recording the time of each call through a host callback
    (the adaptive loop is a lax.while_loop)."""

    def __init__(self, dit, calls):
        self.dit, self.calls = dit, calls

    def apply(self, params, x, t, *args, **kw):
        jax.debug.callback(lambda v: self.calls.append(float(v)), t[0],
                           ordered=True)
        return self.dit.apply(params, x, t, *args, **kw)


def _run_both(cfg_kw, monkeypatch, seed=0, out_scale=1.0):
    """JAX's and the port's pipeline on the same weights and inputs, the
    port handed JAX's noise; JAX's sampler info recorded, with the number
    of steps it accepted (an adaptive iteration starts with a model call at
    its s, which moves only when the step before was accepted, and the loop
    ends on an accepted step)."""
    port_dit, dit_params, port_vae, vae_params = _model_pair(
        out_scale=out_scale)
    static_gs, valid, cond = _inputs()
    info, calls = {}, []

    class Solver(jpipe.DPMSolver):
        def sample(self, x, **kw):
            if kw.get("method") != "adaptive":
                return super().sample(x, **kw)
            x, info_ = super().sample(x, return_info=True, **kw)
            info.update({k: int(v) for k, v in info_.items()})
            return x

    monkeypatch.setattr(jpipe, "DPMSolver", Solver)
    cfg = dict(num_latents=N_LAT, latent_dim=C_LAT, num_frames=T, **cfg_kw)
    rng = jax.random.PRNGKey(seed)
    jp = jpipe.VideoTo4DPipeline(
        _RecordingDiT(JaxDiT(resolution=N_LAT, **DIT_KW, pe_mode="ape",
                             qk_rms_norm=True), calls),
        dit_params,
        JaxMotionVAE(num_inputs=G, num_latents=N_LAT, knn_k=4, **VAE_KW),
        vae_params, jpipe.VideoTo4DConfig(**cfg))
    want = jp.run(static_gs, valid, jnp.asarray(cond), rng)
    want = {k: np.asarray(jax.block_until_ready(v)) for k, v in want.items()}
    if info:
        starts = calls[::cfg_kw["order"]]
        info["accepted"] = sum(a != b for a, b in zip(starts,
                                                     starts[1:])) + 1
    noise = np.array(jax.random.normal(rng, (1, T, N_LAT, C_LAT)))
    pp = VideoTo4DPipeline(port_dit, port_vae, VideoTo4DConfig(**cfg),
                           device="cpu")
    got = pp.run(torch.from_numpy(np.array(static_gs)),
                 torch.from_numpy(np.array(valid)), torch.from_numpy(cond),
                 noise=torch.from_numpy(noise))
    return got, want, pp, info


@pytest.mark.parametrize("field", ["seeded", "smooth"])
def test_adaptive_pipeline_matches_jax(field, monkeypatch):
    """The reference launch's sampler (adaptive, order 2, guidance 1.0 /
    1.0) with the fp32 DiT on the composed path without a KV cache, as
    JAX's; see the module docstring for the two fields' bounds."""
    smooth = field == "smooth"
    got, want, pp, info = _run_both(
        dict(method="adaptive", order=2), monkeypatch,
        out_scale=ADAPTIVE_SMOOTH_SCALE if smooth else 1.0)
    mine = pp.sample_info
    errs = {k: _rel(got[k], want[k]) for k in ("latent", "deltas")}
    print(f"adaptive pipeline ({field}): port {mine}, JAX {info}, rel L2 "
          f"{errs}")
    assert not pp.hoists_kv()
    assert mine["nfe"] == 2 * mine["iters"] == 2 * mine["syncs"]
    assert mine["accepted"] + mine["rejected"] == mine["iters"]
    assert float(np.abs(want["deltas"]).mean()) > 0.01
    if smooth:
        assert (mine["iters"], mine["accepted"]) == (
            info["iters"], info["accepted"]), (mine, info)
        assert max(errs.values()) <= ADAPTIVE_BOUND, errs
    else:
        assert abs(mine["iters"] - info["iters"]) <= 0.2 * info["iters"]
        assert max(errs.values()) <= ADAPTIVE_CHAOS_BOUND, errs


@pytest.mark.parametrize("block_path", ["composed_on_cache", "fused_plain"])
def test_fp32_cfg_pipeline_matches_jax(block_path, monkeypatch):
    """The fp32 DiT under CFG 2.0 / 5.0 (4 multistep steps) on its hoisted
    cache: composed on it, as on the card where the fused gate needs bf16
    (the gate forced closed here), and fused through the plain sublayers,
    as the CPU's gate admits fp32."""
    if block_path == "composed_on_cache":
        monkeypatch.setattr(ptr.ModulatedTransformerCrossBlock,
                            "fused_supported", lambda self, x, kv: False)
    got, want, pp, _ = _run_both(dict(steps=4, order=2, guidance_scale=2.0,
                                      guidance_scale2=5.0), monkeypatch)
    assert pp.hoists_kv() and pp.sample_info["nfe"] == 4
    for k in ("latent", "deltas"):
        assert _rel(got[k], want[k]) <= CFG_BOUND, (k, _rel(got[k], want[k]))


# -- the CLI end to end -------------------------------------------------------


def _save_checkpoint(module, ckpt_dir, step=3):
    state = create_train_state(module, make_optimizer(lr=0.0))
    CheckpointManager(str(ckpt_dir)).save(state, step)


def test_infer_main_matches_the_pipeline(tmp_path, capsys):
    """main(--device cpu) with the reference launch's flags on a tiny input
    and trainer checkpoints: its latent equals VideoTo4DPipeline.run(method=
    "adaptive") on the same weights and generator; its outputs are JAX's."""
    cfg = load_config(None, OVERRIDES)
    dit = init_random_(build_model(cfg), seed=21)
    vae = init_random_(build_motion_vae(cfg), seed=22)
    _save_checkpoint(dit, tmp_path / "dit")
    _save_checkpoint(vae, tmp_path / "vae")
    npz, out = tmp_path / "in.npz", tmp_path / "out"
    gs = _write_input(npz)
    assert pinfer.main(["--input", str(npz), "--output_dir", str(out),
                        "--dit_ckpt", str(tmp_path / "dit"),
                        "--vae_ckpt", str(tmp_path / "vae"), "--adaptive",
                        "--use_fp16", "--num_timesteps", str(T),
                        "--num_views", "2", "--resolution", "32",
                        "--seed", "5", "--device", "cpu", *OVERRIDES]) == 0

    data = np.load(npz)
    pipe = VideoTo4DPipeline(dit.eval(), vae.eval(), VideoTo4DConfig(
        method="adaptive", num_frames=T, num_latents=N_LAT,
        latent_dim=C_LAT), device="cpu")
    want = pipe.run(torch.from_numpy(gs)[None], torch.ones(1, G, dtype=bool),
                    torch.from_numpy(data["cond_images"])[None],
                    generator=torch.Generator().manual_seed(5))
    got = np.load(out / "deformation.npz")
    assert got["latent"].shape == (1, T, N_LAT, C_LAT)
    assert got["deltas"].shape == (1, T, G, 14)
    np.testing.assert_array_equal(got["latent"], want["latent"].numpy())
    np.testing.assert_array_equal(got["deltas"], want["deltas"].numpy())
    frames = np.load(out / "frames.npy")
    assert frames.shape == (T, 2, 32, 32, 3) and np.isfinite(frames).all()
    with open(out / "progress.csv") as f:
        row = next(csv.DictReader(f))
    assert int(row["nfe"]) == pipe.sample_info["nfe"] == \
        2 * int(row["iters"])
    assert int(row["syncs"]) == int(row["iters"])
    for k in ("fps_s", "sample_s", "decode_s", "render_s"):
        assert float(row[k]) >= 0.0, k
    err = capsys.readouterr().err
    assert "restored step 3" in err
    assert (out / "video.mp4").exists() or "mp4 export skipped" in err


# -- the weights-only restore -------------------------------------------------


def test_restore_params_is_strict(tmp_path):
    model = init_random_(MotionVAE(**VAE_KW), seed=3)
    _save_checkpoint(model, tmp_path / "a", step=2)
    _save_checkpoint(model, tmp_path / "a", step=7)
    fresh = MotionVAE(**VAE_KW)
    assert restore_params(fresh, str(tmp_path / "a")) == 7
    for (k, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), k
    assert restore_params(fresh, str(tmp_path / "a"), step=2) == 2
    with pytest.raises(FileNotFoundError):
        restore_params(fresh, str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        restore_params(fresh, str(tmp_path / "a"), step=5)
    with pytest.raises(ValueError, match="shapes differ"):
        restore_params(MotionVAE(**dict(VAE_KW, dim=60, queries_dim=60)),
                       str(tmp_path / "a"))
    with pytest.raises(KeyError, match="missing"):
        restore_params(MotionVAE(**dict(VAE_KW, depth=2)),
                       str(tmp_path / "a"))
    mgr = CheckpointManager(str(tmp_path / "a"))
    state = create_train_state(model, make_optimizer(lr=0.0))
    assert mgr.save(state, 9, force=True) and not mgr.save(state, 9)
    mgr.close()


# -- the logger and the config helpers ----------------------------------------


def _log_sequence(mod, d):
    """The same calls through either package's logger, in `d`."""
    mod.configure(str(d), format_strs=["log", "csv", "json"])
    mod.logkv("step", 0)
    mod.logkv("loss", 0.5)
    mod.logkv_mean("step_time", 1.0)
    mod.logkv_mean("step_time", 2.0)
    mod.dumpkvs()
    mod.logkvs({"step": 1, "loss": 0.25, "extra": "x"})
    with mod.profile_kv("io"):
        pass
    mod.get_current().name2val["wait_io"] = 0.125  # the wall time, fixed
    d2 = mod.dumpkvs()
    mod.save_args({"a": 1, "b": "c"})
    assert mod.get_dir() == str(d)
    return d2


def test_logger_files_match_jax(tmp_path):
    got = _log_sequence(plogger, tmp_path / "p")
    want = _log_sequence(jlogger, tmp_path / "j")
    assert got == want
    for name in ("log.txt", "progress.csv", "progress.json", "args.json"):
        assert (tmp_path / "p" / name).read_text() == \
            (tmp_path / "j" / name).read_text(), name


def test_logger_defaults_and_tensorboard(tmp_path, monkeypatch, capsys):
    """$LOGDIR and $GVF_LOG_FORMAT as JAX reads them; the stdout table;
    `log` to stderr; the tensorboard format raising ImportError without
    the package."""
    monkeypatch.setenv("LOGDIR", str(tmp_path / "env"))
    monkeypatch.setenv("GVF_LOG_FORMAT", "stdout,csv")
    lg = plogger.configure()
    assert lg.dir == str(tmp_path / "env")
    plogger.logkv("loss", 1.5)
    plogger.dumpkvs()
    plogger.log("hello")
    out = capsys.readouterr()
    assert "| loss | 1.5" in out.out and "hello" in out.err
    assert (tmp_path / "env" / "progress.csv").exists()
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)
    with pytest.raises(ImportError):
        plogger.configure(str(tmp_path / "tb"), format_strs=["tensorboard"])


def test_main_latent_logs_into_exp_dir(tmp_path):
    """A one-step run of the DiT trainer leaves log.txt and progress.csv in
    exp_dir with JAX's keys."""
    from gvfdiffusion_torch.cli import main_latent

    r = np.random.default_rng(7)
    d = tmp_path / "data" / "obj0"
    os.makedirs(d)
    torch.save({
        "latent_mean": torch.from_numpy(
            r.standard_normal((6, 16, 16)).astype(np.float32)),
        "latent_std": torch.from_numpy(
            r.uniform(0.1, 0.5, (6, 16, 16)).astype(np.float32)),
        "fps_sampled_gs_1024": torch.from_numpy(
            r.standard_normal((32, 14)).astype(np.float32)),
    }, d / "deformation_latent.pt")
    np.savez(d / "dinov2_features.npz",
             features=r.standard_normal((6, 5, 32)).astype(np.float32))
    exp = tmp_path / "exp"
    assert main_latent.main([
        "--device=cpu", "--config", os.path.join(REPO, "configs",
                                                 "diffusion.yml"),
        f"--data_dir={tmp_path / 'data'}", f"--exp_dir={exp}",
        "--model.model_channels=64", "--model.num_heads=2",
        "--model.num_blocks=1", "--model.resolution=16",
        "--model.image_cond_channels=32", "--train.sample_timesteps=4",
        "--train.log_interval=1", "--train.total_steps=1"]) == 0
    with open(exp / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    assert set(rows[0]) == {"step", "loss", "mse", "grad_norm", "step_time"}
    assert int(rows[0]["step"]) == 0 and np.isfinite(float(rows[0]["loss"]))
    text = (exp / "log.txt").read_text()
    for k in ("step", "loss", "mse", "grad_norm", "step_time"):
        assert f"| {k} " in text, k


def test_load_yaml_and_to_dict_match_jax():
    for name in ("diffusion.yml", "vae.yml"):
        path = os.path.join(REPO, "configs", name)
        assert pconfig.load_yaml(path) == jconfig.load_yaml(path)
    mine = pconfig.to_dict(pconfig.Config())
    theirs = jconfig.to_dict(jconfig.Config())
    for section in ("model", "diffusion", "motion_vae", "render"):
        for k, v in mine[section].items():
            if k in theirs[section]:
                assert v == theirs[section][k], (section, k)
