"""Port parity of the trainers' utilities, on the CPU:

- nn/misc: `update_ema`, `mean_flat`, `Conv4d` at odd and even kernels
  (flax's "SAME" pads (0, 1) at a kernel of 2) and `AttentionPooling`
  against JAX's on seeded parameters carried across by utils/weights
  (`conv4d_table`, `attention_pooling_table`), fp32 rel L2 <= 1e-5;
- diffusion/resample.static_sampler;
- ops/lpips.convert_torch_lpips: a seeded torchvision-layout state dict
  gives JAX's keys and arrays exactly, and the written `.npz` the same
  LPIPS distance in both packages on 64^2 images (rel 1e-5);
- data/prefetch.Prefetcher: the five cases of tests/test_prefetch.py, and
  the DiT trainer's batches through it (`DevicePlacer` on the CPU) equal
  to JAX's unprefetched ones;
- data/dataset_inference.InferenceDataset against JAX's on the same files;
- train/eval_utils: `reconstruction_metrics`, a 2-view 32^2
  `snapshot_multiview` (atol 1e-4, the render tests' bound) and
  `dump_image_pairs` against JAX's;
- utils/elastic.LinearMemoryController against JAX's over one sequence
  of peaks (the device's statistics replaced by the same sequence in both
  packages), `suggest_remat_blocks` on the DiT and the static VAE;
- utils/profiling.trace writing a trace on the CPU, and the memory
  helpers' CPU no-ops.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.data import dataset_latent as pdl
from gvfdiffusion_torch.data import dataset_inference as pdi
from gvfdiffusion_torch.data.prefetch import DevicePlacer, Prefetcher
from gvfdiffusion_torch.diffusion import resample as pres
from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.models.static_vae import SparseTransformerVAE
from gvfdiffusion_torch.nn import misc as pmisc
from gvfdiffusion_torch.ops import lpips as plp
from gvfdiffusion_torch.render.renderer import GaussianRenderer, RenderOptions
from gvfdiffusion_torch.representations.gaussians import from_activated
from gvfdiffusion_torch.train import eval_utils as pev
from gvfdiffusion_torch.utils import elastic as pel
from gvfdiffusion_torch.utils import logger as plogger
from gvfdiffusion_torch.utils import profiling as pprof
from gvfdiffusion_torch.utils import weights as pw

BOUND = 1e-5


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def seeded_tree(tree, seed):
    """Every leaf of a flax tree redrawn from N(0, 0.3^2), so that no bias
    is the zero init."""
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (0.3 * r.standard_normal(a.shape)).astype(
        np.float32), tree)


# -- nn/misc -------------------------------------------------------------------


def test_update_ema_and_mean_flat_match_jax():
    from gvfdiffusion_tpu.nn import misc as jmisc

    r = np.random.default_rng(0)
    ema = {"a": r.standard_normal((3, 4)), "b": r.standard_normal(5)}
    new = {k: r.standard_normal(v.shape) for k, v in ema.items()}
    ema, new = ({k: v.astype(np.float32) for k, v in d.items()}
                for d in (ema, new))
    got = pmisc.update_ema({k: torch.from_numpy(v) for k, v in ema.items()},
                           {k: torch.from_numpy(v) for k, v in new.items()},
                           rate=0.9)
    want = jmisc.update_ema(ema, new, rate=0.9)
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k]) <= BOUND, k
    x = r.standard_normal((3, 4, 5, 6)).astype(np.float32)
    assert rel_l2(pmisc.mean_flat(torch.from_numpy(x)),
                  jmisc.mean_flat(jnp.asarray(x))) <= BOUND


@pytest.mark.parametrize("spatial,temporal", [(3, 3), (2, 4), (1, 2)])
def test_conv4d_matches_jax(spatial, temporal):
    from gvfdiffusion_tpu.nn import misc as jmisc

    x = np.random.default_rng(1).standard_normal((2, 5, 4, 3, 6, 3)).astype(
        np.float32)
    jm = jmisc.Conv4d(features=4, spatial_kernel=spatial,
                      temporal_kernel=temporal)
    params = seeded_tree(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                          jnp.asarray(x)), 2)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    pm = pmisc.Conv4d(3, 4, spatial_kernel=spatial, temporal_kernel=temporal)
    pm.load_state_dict(pw.from_flax(pw.conv4d_table(), params))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 5, 4, 3, 6, 4)
    assert rel_l2(got, want) <= BOUND
    # the table's other direction gives the flax tree back
    back = pw.to_flax(pw.conv4d_table(), pm.state_dict())
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        b = back
        for p in path:
            b = b[p.key]
        np.testing.assert_array_equal(b, np.asarray(a))


def test_attention_pooling_matches_jax():
    from gvfdiffusion_tpu.nn import misc as jmisc

    x = np.random.default_rng(3).standard_normal((2, 7, 32)).astype(
        np.float32)
    jm = jmisc.AttentionPooling(num_heads=4)
    params = seeded_tree(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                          jnp.asarray(x)), 4)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    pm = pmisc.AttentionPooling(32, 4)
    pm.load_state_dict(pw.from_flax(pw.attention_pooling_table(), params))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 32)
    assert rel_l2(got, want) <= BOUND


def test_static_sampler_matches_jax():
    from gvfdiffusion_tpu.diffusion import resample as jres

    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    t, w = pres.static_sampler(g, 6, 1000, value=17)
    jt, jw = jres.static_sampler(jax.random.PRNGKey(0), 6, 1000, value=17)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert t.dtype == torch.long and w.dtype == torch.float32
    assert torch.equal(g.get_state(), state)  # it draws nothing
    t0, _ = pres.static_sampler(g, 3, 1000)
    assert t0.tolist() == [0, 0, 0] and t0.device == g.device


# -- LPIPS -----------------------------------------------------------------------


def _torchvision_lpips_state(seed):
    """A seeded state dict in torchvision's vgg16.features layout and the
    LPIPS heads' (non-negative, as released)."""
    r = np.random.default_rng(seed)
    vgg, c_in = {}, 3
    widths = [ch for ch, n in plp.STAGES for _ in range(n)]
    for ti, ch in zip(plp.CONV_INDEX, widths):
        vgg[f"features.{ti}.weight"] = torch.from_numpy((r.standard_normal(
            (ch, c_in, 3, 3)) / np.sqrt(9 * c_in)).astype(np.float32))
        vgg[f"features.{ti}.bias"] = torch.from_numpy(
            (0.1 * r.standard_normal(ch)).astype(np.float32))
        c_in = ch
    lin = {f"lin{i}.model.1.weight": torch.from_numpy(np.abs(
        r.standard_normal((1, ch, 1, 1))).astype(np.float32))
        for i, (ch, _) in enumerate(plp.STAGES)}
    return vgg, lin


def test_convert_torch_lpips_matches_jax(tmp_path):
    from gvfdiffusion_tpu.ops import lpips as jlp

    vgg, lin = _torchvision_lpips_state(5)
    got = plp.convert_torch_lpips(vgg, lin)
    want = jlp.convert_torch_lpips({k: v.numpy() for k, v in vgg.items()},
                                   {k: v.numpy() for k, v in lin.items()})
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **got)
    r = np.random.default_rng(6)
    x, y = (r.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
            for _ in range(2))
    jfn = jlp.load_lpips(path)
    jd = jax.jit(jfn)(jnp.asarray(x), jnp.asarray(y))
    model = plp.load_lpips(path, device="cpu")
    with torch.no_grad():
        pd = model(torch.from_numpy(x), torch.from_numpy(y))
    assert rel_l2(pd, jd) <= BOUND


# -- the prefetcher: tests/test_prefetch.py's cases ------------------------------


def test_prefetch_order_and_place_fn():
    seen = []

    def place(x):
        seen.append(x)
        return x * 10

    with Prefetcher(iter(range(8)), place_fn=place) as pf:
        out = [next(pf) for _ in range(8)]
    assert out == [i * 10 for i in range(8)]
    assert seen[:8] == list(range(8))


def test_prefetch_stop_iteration():
    pf = Prefetcher(iter([1, 2]))
    assert next(pf) == 1
    assert next(pf) == 2
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


def test_prefetch_propagates_worker_exception():
    def gen():
        yield 1
        raise ValueError("loader failed")

    pf = Prefetcher(gen())
    assert next(pf) == 1
    with pytest.raises(ValueError, match="loader failed"):
        next(pf)
    pf.close()


def test_prefetch_runs_ahead_of_consumer():
    produced = []

    def gen():
        for i in range(4):
            produced.append(i)
            yield i

    pf = Prefetcher(gen(), depth=2)
    deadline = time.time() + 5.0
    # the queue's 2 + the one the worker holds
    while len(produced) < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert len(produced) >= 2
    assert [next(pf) for _ in range(4)] == list(range(4))
    pf.close()


def test_prefetch_close_unblocks_full_queue():
    def gen():
        while True:
            yield 0

    pf = Prefetcher(gen(), depth=1)
    time.sleep(0.1)  # the worker blocks on a full queue
    pf.close()
    assert not pf._thread.is_alive()


def _write_latents(root, items=3, frames=5):
    r = np.random.default_rng(8)
    for i in range(items):
        d = os.path.join(root, f"obj{i}")
        os.makedirs(d)
        torch.save({
            "latent_mean": torch.from_numpy(
                r.standard_normal((frames, 8, 4)).astype(np.float32)),
            "latent_std": torch.from_numpy(
                r.uniform(0.1, 0.5, (frames, 8, 4)).astype(np.float32)),
            "fps_sampled_gs_1024": torch.from_numpy(
                r.standard_normal((16, 14)).astype(np.float32)),
        }, os.path.join(d, "deformation_latent.pt"))
        np.savez(os.path.join(d, "dinov2_features.npz"),
                 features=r.standard_normal((frames, 3, 8)).astype(
                     np.float32))


def test_prefetched_latent_batches_match_jax(tmp_path):
    """The DiT trainer's batches through the prefetcher, placed on the
    device by DevicePlacer, against JAX's unprefetched batches: the same
    draws of the same generators in the same order."""
    from gvfdiffusion_tpu.data import dataset_latent as jdl

    _write_latents(str(tmp_path))
    kw = dict(num_frames=3, num_latents=8, latent_dim=4, uncond_p=0.3,
              seed=9)
    port = pdl.load_data(pdl.LatentDataset(str(tmp_path), **kw), 2)
    ref = jdl.load_data(jdl.LatentDataset(str(tmp_path), **kw), 2)
    with Prefetcher(port, place_fn=DevicePlacer("cpu")) as pf:
        for _ in range(5):
            a, b = next(pf), next(ref)
            assert set(a) == set(b)
            for k in b:
                assert isinstance(a[k], torch.Tensor)
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]),
                                              err_msg=k)


# -- the inference dataset -------------------------------------------------------


def test_inference_dataset_matches_jax(tmp_path):
    import imageio

    from gvfdiffusion_tpu.data import dataset_inference as jdi

    r = np.random.default_rng(10)
    (tmp_path / "in_the_wild.txt").write_text("a 3\n\nb\n")
    for name, images in (("a", True), ("b", False)):
        d = tmp_path / name
        d.mkdir()
        np.savez(d / "dinov2_features.npz",
                 features=r.standard_normal((4, 5, 8)).astype(np.float64))
        if images:
            imageio.imwrite(d / "canonical.png",
                            r.integers(0, 256, (12, 10, 3), dtype=np.uint8))
            imageio.imwrite(d / "canonical_mask.png",
                            r.integers(0, 256, (12, 10), dtype=np.uint8))
    kw = dict(num_views=3, resolution=32, pitch_deg=10.0, radius=1.5)
    port = pdi.InferenceDataset(str(tmp_path), **kw)
    ref = jdi.InferenceDataset(str(tmp_path), **kw)
    assert len(port) == len(ref) == 2 and port.items == ref.items
    for i in range(2):
        a, b = port[i], ref[i]
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    for pc, jc in zip(port.cameras(), ref.cameras(), strict=True):
        np.testing.assert_allclose(pc.world_view.numpy(),
                                   np.asarray(jc.world_view), atol=1e-6)
        np.testing.assert_allclose(pc.intrinsics.numpy(),
                                   np.asarray(jc.intrinsics), atol=1e-7)
        assert (pc.height, pc.width) == (jc.height, jc.width) == (32, 32)
    assert len(pdi.InferenceDataset(str(tmp_path / "a"))) == 0


# -- evaluation helpers ----------------------------------------------------------


def test_reconstruction_metrics_match_jax():
    from gvfdiffusion_tpu.train import eval_utils as jev

    r = np.random.default_rng(11)
    p = r.uniform(0, 1, (2, 3, 24, 24, 3)).astype(np.float32)
    t = np.clip(p + 0.05 * r.standard_normal(p.shape), 0, 1).astype(
        np.float32)
    got = pev.reconstruction_metrics(torch.from_numpy(p), torch.from_numpy(t))
    want = jev.reconstruction_metrics(jnp.asarray(p), jnp.asarray(t))
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= BOUND * abs(want[k]), k


def test_snapshot_multiview_matches_jax(monkeypatch):
    from gvfdiffusion_tpu.render import renderer as jr
    from gvfdiffusion_tpu.representations import gaussians as jg
    from gvfdiffusion_tpu.train import eval_utils as jev

    # JAX's snapshot renders eagerly; one jitted render serves both views
    render, jitted = jr.GaussianRenderer.render, {}

    def jit_render(self, gs, camera, valid=None):
        if id(self) not in jitted:
            jitted[id(self)] = jax.jit(lambda g, c, v: render(self, g, c,
                                                              valid=v))
        return jitted[id(self)](gs, camera, valid)

    monkeypatch.setattr(jr.GaussianRenderer, "render", jit_render)

    r = np.random.default_rng(12)
    n = 256
    q = r.standard_normal((n, 4))
    act = np.concatenate([
        r.uniform(-0.4, 0.4, (n, 3)), r.uniform(0.02, 0.08, (n, 3)),
        q / np.linalg.norm(q, axis=-1, keepdims=True),
        r.standard_normal((n, 3)) * 0.5, r.uniform(0.1, 0.9, (n, 1))],
        -1).astype(np.float32)
    valid = r.uniform(size=n) < 0.8
    opt = dict(tile=16, max_per_tile=64)
    got = pev.snapshot_multiview(
        GaussianRenderer(RenderOptions(**opt)), from_activated(
            torch.from_numpy(act)), torch.from_numpy(valid), num_views=2,
        resolution=32)
    want = jev.snapshot_multiview(
        jr.GaussianRenderer(jr.RenderOptions(**opt)), jg.from_activated(
            jnp.asarray(act)), jnp.asarray(valid), num_views=2,
        resolution=32)
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert float(np.abs(got - want).max()) <= 1e-4
    assert float(np.abs(got[0] - got[1]).max()) > 0.05  # two views


def test_dump_image_pairs_matches_jax(tmp_path):
    import imageio.v2 as imageio

    from gvfdiffusion_tpu.train import eval_utils as jev

    r = np.random.default_rng(13)
    a, b = (r.uniform(-0.2, 1.2, (2, 8, 6, 3)).astype(np.float32)
            for _ in range(2))
    got = pev.dump_image_pairs(a, b, str(tmp_path / "p"), 7)
    want = jev.dump_image_pairs(a, b, str(tmp_path / "j"), 7)
    assert os.path.basename(got) == os.path.basename(want) == \
        "recon_000007.png"
    np.testing.assert_array_equal(imageio.imread(got), imageio.imread(want))


# -- memory control and profiling -------------------------------------------------


PEAKS = [3.0e9, 3.4e9, 0.0, 4.1e9, 4.4e9, 5.2e9, 5.0e9, 6.1e9, 6.3e9,
         7.7e9]
SIZES = [10.0, 12.0, 11.0, 15.0, 16.0, 20.0, 19.0, 24.0, 25.0, 30.0]


def test_linear_memory_controller_matches_jax(monkeypatch):
    from gvfdiffusion_tpu.models import dit as jdit
    from gvfdiffusion_tpu.utils import elastic as jel

    ctrl = []
    for module in (pel, jel):
        peaks = iter(PEAKS)
        monkeypatch.setattr(module, "device_memory_stats",
                            lambda device=None, it=peaks: (next(it, 0), 0))
        c = module.LinearMemoryController(buffer_size=6, update_every=3,
                                          available_memory=16 << 30)
        ctrl.append(c)
        readings = []
        for size in SIZES:
            with c.record(size, mem_ratio=0.5 + size / 100):
                pass
            readings.append((c.k, c.b, c.max_mem_ratio,
                             c.get_mem_ratio(size)))
        c.readings = readings
    (p, j) = ctrl
    assert p._xs == j._xs and p._ys == j._ys
    np.testing.assert_allclose(np.asarray(p.readings), np.asarray(j.readings),
                               rtol=1e-12)
    assert p.k > 0 and p.max_mem_ratio == pytest.approx(0.4)
    # the static VAE maps the ratio as the DiT does, over its own blocks
    vae = SparseTransformerVAE(resolution=8, in_channels=4, model_channels=64,
                               num_blocks=6, num_heads=2)
    dit = DiT(num_blocks=12, model_channels=32, num_heads=2,
              image_cond_channels=8)
    for size in (5.0, 30.0, 1e4):
        assert p.suggest_remat_blocks(dit, size) == \
            j.suggest_remat_blocks(jdit.DiT(num_blocks=12), size)
        assert p.suggest_remat_blocks(vae, size) == \
            j.suggest_remat_blocks(jdit.DiT(num_blocks=6), size)
    assert [vae.mem_ratio_to_remat_blocks(r) for r in (1.0, 0.9, 0.5, 0.0)] \
        == [0, 2, 4, 6]


def test_memory_helpers_on_the_cpu(tmp_path):
    assert pel.device_memory_stats("cpu") == (0, 0)
    plogger.configure(str(tmp_path), format_strs=["csv"])
    pprof.log_memory_kvs(device="cpu")
    assert dict(plogger.get_current().name2val) == {}
    c = pel.LinearMemoryController(device="cpu")
    assert c.available == 16 << 30  # no card: JAX's fallback size


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    with pprof.trace(str(tmp_path / "prof")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(os.path.join(d, files[0])) > 0
    seen = []
    for step in range(5):
        with pprof.maybe_trace_step(step, 2, 2, str(tmp_path / "w")) as d:
            seen.append(d)
    assert seen[:2] == [None, None] and seen[4] is None
    assert len(os.listdir(tmp_path / "w")) == 2
