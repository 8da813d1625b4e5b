"""Port parity: the TRELLIS image -> 3D front end (gvfdiffusion_torch/
sparse/*, models/trellis/*, models/{static,sparse}_vae.py,
nn/transformer.ModulatedCrossBlock, diffusion/flow_euler.py,
pipelines/trellis_image_to_3d.py) against the JAX package on the CPU, at
small widths, from one seeded numpy draw handed to both. Every model is
built in the port from `init_random_` weights under the reference's names,
carried to JAX with `utils/weight_convert.convert_*`, and back with the
port's inverse, which must give the state dict back exactly.

Tolerances, fp32 throughout: exact equality for coordinates, validity,
slots and the child -> parent map; rel L2 <= 1e-5 for one module; <= 1e-4
for a chain (a whole model, a sampler run, the pipeline).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.diffusion import flow_euler as pfe
from gvfdiffusion_torch.models.dinov2 import DinoV2
from gvfdiffusion_torch.models import sparse_vae as psv
from gvfdiffusion_torch.models.trellis.slat_decoders import (
    SLatGaussianDecoder)
from gvfdiffusion_torch.models.trellis.slat_flow import SLatFlowModel
from gvfdiffusion_torch.models.trellis.ss_flow import (
    SparseStructureFlowModel)
from gvfdiffusion_torch.models.trellis.ss_vae import SparseStructureDecoder
from gvfdiffusion_torch.nn.transformer import ModulatedCrossBlock
from gvfdiffusion_torch.pipelines.trellis_image_to_3d import (
    TrellisConfig, TrellisImageTo3DPipeline)
from gvfdiffusion_torch.sparse import attention as psa
from gvfdiffusion_torch.sparse import ops as pso
from gvfdiffusion_torch.sparse.conv import SparseConv3d
from gvfdiffusion_torch.sparse.tensor import SparseVoxels, from_dense
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_tpu.diffusion import flow_euler as jfe
from gvfdiffusion_tpu.models import sparse_vae as jsv
from gvfdiffusion_tpu.models.trellis import slat_decoders as jsd
from gvfdiffusion_tpu.models.trellis import slat_flow as jsf
from gvfdiffusion_tpu.models.trellis import ss_flow as jssf
from gvfdiffusion_tpu.models.trellis import ss_vae as jssv
from gvfdiffusion_tpu.nn.transformer import ModulatedCrossBlock as JaxMCB
from gvfdiffusion_tpu.pipelines import trellis_image_to_3d as jpipe
from gvfdiffusion_tpu.sparse import attention as jsa
from gvfdiffusion_tpu.sparse import conv as jsc
from gvfdiffusion_tpu.sparse import ops as jso
from gvfdiffusion_tpu.sparse import tensor as jst
from gvfdiffusion_tpu.utils import weight_convert as wc

MODULE, CHAIN = 1e-5, 1e-4


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
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _sd(module, seed):
    """A reference-named state dict with every parameter non-zero."""
    return {k: v.numpy().copy()
            for k, v in pw.init_random_(module, seed).state_dict().items()}


def _round_trip(module, sd, back):
    """The port's inverse of convert_* gives the state dict back, and the
    port module loads it with no key missing or left over."""
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    module.load_state_dict(back)
    return module.eval()


def _voxels(seed, B=2, res=16, cap=128, counts=(90, 70), C=8):
    """Random structures at unique coordinates: (numpy dict, port, JAX)."""
    r = np.random.default_rng(seed)
    coords = np.zeros((B, cap, 3), np.int32)
    valid = np.zeros((B, cap), bool)
    for b, n in enumerate(counts):
        lin = r.choice(res ** 3, n, replace=False)
        coords[b, :n] = np.stack([lin // res ** 2, lin // res % res,
                                  lin % res], -1)
        valid[b, :n] = True
    feats = r.standard_normal((B, cap, C)).astype(np.float32) * valid[..., None]
    port = SparseVoxels(torch.from_numpy(feats), torch.from_numpy(coords),
                        torch.from_numpy(valid), res)
    jax_sv = jst.SparseVoxels(jnp.asarray(feats), jnp.asarray(coords),
                              jnp.asarray(valid), resolution=res)
    return port, jax_sv


def _same_structure(p, j):
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(p.coords.numpy(), np.asarray(j.coords))


# -- the sparse runtime ------------------------------------------------------


def test_sparse_tensor_ops():
    p, j = _voxels(0)
    np.testing.assert_array_equal(p.index_grid().numpy(),
                                  np.asarray(j.index_grid()))
    assert _rel(p.to_dense(), j.to_dense()) == 0
    dense = np.random.default_rng(1).standard_normal((2, 8, 8, 8, 3))
    dense = (dense * (np.abs(dense) > 1.2)).astype(np.float32)
    pd, jd = from_dense(torch.from_numpy(dense), 128, 0.5), \
        jst.from_dense(jnp.asarray(dense), 128, 0.5)
    _same_structure(pd, jd)
    assert _rel(pd.feats, jd.feats) == 0
    other = np.random.default_rng(2).standard_normal((2, 8)).astype(np.float32)
    for op in ("__add__", "__sub__", "__mul__"):
        got = getattr(p, op)(torch.from_numpy(other)).feats
        want = getattr(j, op)(jnp.asarray(other)).feats
        assert _rel(got, want) == 0, op


def test_downsample_compact_scatter_back():
    p, j = _voxels(3)
    pr, jr = pso.sparse_downsample(p, 2), jso.sparse_downsample(j, 2)
    _same_structure(pr.parents, jr.parents)
    np.testing.assert_array_equal(pr.child_to_parent.numpy(),
                                  np.asarray(jr.child_to_parent))
    assert _rel(pr.parents.feats, jr.parents.feats) <= MODULE
    up = pso.sparse_upsample(pr.parents, p, pr.child_to_parent)
    jup = jso.sparse_upsample(jr.parents, j, jr.child_to_parent)
    assert _rel(up.feats, jup.feats) <= MODULE
    # 64 slots: the first structure (90 voxels) is truncated
    pc, ps = pso.sparse_compact(p, 64)
    jc, js = jso.sparse_compact(j, 64)
    _same_structure(pc, jc)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert _rel(pc.feats, jc.feats) == 0
    back = pso.sparse_scatter_back(pc, ps, p)
    jback = jso.sparse_scatter_back(jc, js, j)
    assert _rel(back.feats, jback.feats) == 0


@pytest.mark.parametrize("fused_upsample", [False, True])
def test_sparse_conv(fused_upsample):
    p, j = _voxels(4)
    conv = pw.init_random_(SparseConv3d(8, 6), seed=5).eval()
    sd = {k: v.numpy() for k, v in conv.state_dict().items()}
    tree = {}
    wc._spconv(sd, "conv", tree, [])
    back = {}
    pw._spconv(back, tree, "conv", [])
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])
    jconv = jsc.SparseConv3d(6)
    if fused_upsample:
        pr, jr = pso.sparse_downsample(p, 2), jso.sparse_downsample(j, 2)
        with torch.no_grad():
            got = conv(p, torch.float32, parent=pr.parents,
                       c2p=pr.child_to_parent).feats
        want = jconv.apply({"params": tree}, j, parent=jr.parents,
                           c2p=jr.child_to_parent).feats
    else:
        with torch.no_grad():
            got = conv(p, torch.float32).feats
        want = jconv.apply({"params": tree}, j).feats
    assert _rel(got, want) <= MODULE


@pytest.mark.parametrize("cap,counts", [(64, (40, 64)), (128, (100, 7)),
                                        (256, (200, 150))])
def test_windowed_attention(cap, counts):
    """window 4 -> chunks of 64: one chunk, two (the band without
    duplicates), and four; windows alternate shifts as the swin schedule."""
    p, j = _voxels(6, cap=cap, counts=counts)
    r = np.random.default_rng(7)
    q, k, v = (r.standard_normal((2, cap, 2, 16)).astype(np.float32)
               for _ in range(3))
    for shift in ((0, 0, 0), (2, 2, 2)):
        got = psa.windowed_sparse_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), p, 4, shift)
        want = jsa.windowed_sparse_attention(
            *(jnp.asarray(a) for a in (q, k, v)), j, 4, shift)
        m = p.valid.numpy()
        assert _rel(_np(got)[m], np.asarray(want)[m]) <= MODULE


def test_full_sparse_attention_masked_path():
    p, j = _voxels(8, cap=64, counts=(50, 33))
    r = np.random.default_rng(9)
    q, k, v = (r.standard_normal((2, 64, 2, 16)).astype(np.float32)
               for _ in range(3))
    got = psa.full_sparse_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    p.valid, p.valid, torch.float32)
    want = jsa.full_sparse_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     j.valid, j.valid)
    m = p.valid.numpy()
    assert _rel(_np(got)[m], np.asarray(want)[m]) <= MODULE


# -- the sparse-structure stage ---------------------------------------------


@pytest.mark.parametrize("qk_cross", [False, True])
def test_modulated_cross_block(qk_cross):
    C, H, L, Lc = 128, 2, 130, 20
    block = ModulatedCrossBlock(C, H, qk_rms_norm=True,
                                qk_rms_norm_cross=qk_cross, ctx_channels=64)
    sd = _sd(block, seed=10)
    tree = {}
    wc._mcb_block({f"b.{k}": v for k, v in sd.items()}, "b", tree, [], True,
                  qk_cross, False)
    r = np.random.default_rng(11)
    x = r.standard_normal((1, L, C)).astype(np.float32)
    mod = r.standard_normal((1, C)).astype(np.float32)
    ctx = r.standard_normal((1, Lc, 64)).astype(np.float32)
    with torch.no_grad():
        got = block.eval()(*(torch.from_numpy(a) for a in (x, mod, ctx)))
    want = JaxMCB(C, H, qk_rms_norm=True, qk_rms_norm_cross=qk_cross).apply(
        {"params": tree}, *(jnp.asarray(a) for a in (x, mod, ctx)))
    assert _rel(got, want) <= MODULE


# the JAX fused cross sublayer projects a context as wide as the model
SSF_KW = dict(resolution=8, in_channels=4, model_channels=128,
              cond_channels=128, out_channels=4, num_blocks=1, num_heads=2,
              patch_size=2, qk_rms_norm=True)
SSD_KW = dict(latent_channels=4, num_res_blocks=1, channels=(16, 8),
              num_res_blocks_middle=1)
SLF_KW = dict(resolution=16, in_channels=4, model_channels=128,
              cond_channels=128, out_channels=4, num_blocks=1, num_heads=2,
              num_io_res_blocks=2, io_block_channels=(16,), qk_rms_norm=True,
              torso_capacity=128)
GSD_KW = dict(resolution=16, model_channels=128, latent_channels=4,
              num_blocks=2, num_heads=2, window_size=4)


def _ss_flow_pair(seed=12):
    sd = _sd(SparseStructureFlowModel(**SSF_KW), seed)
    tree = wc.convert_ss_flow(sd, num_blocks=1, in_channels=4, out_channels=4,
                              patch_size=2, qk_rms_norm=True)
    port = _round_trip(SparseStructureFlowModel(**SSF_KW), sd,
                       pw.ss_flow_state_dict_from_flax(tree, 1, 4, 4, 2))
    return port, tree


def _ss_dec_pair(seed=13):
    sd = _sd(SparseStructureDecoder(**SSD_KW), seed)
    tree = wc.convert_ss_decoder(sd, channels=(16, 8), num_res_blocks=1,
                                 num_res_blocks_middle=1)
    port = _round_trip(SparseStructureDecoder(**SSD_KW), sd,
                       pw.ss_decoder_state_dict_from_flax(tree, (16, 8), 1, 1))
    return port, tree


def _slat_pair(seed=14):
    sd = _sd(SLatFlowModel(**SLF_KW), seed)
    tree = wc.convert_slat_flow(sd, num_blocks=1, io_block_channels=(16,),
                                num_io_res_blocks=2, qk_rms_norm=True)
    port = _round_trip(SLatFlowModel(**SLF_KW), sd,
                       pw.slat_flow_state_dict_from_flax(tree, 1, (16,), 2))
    return port, tree


def _gs_pair(seed=15):
    sd = _sd(SLatGaussianDecoder(**GSD_KW), seed)
    tree = wc.convert_slat_gs_decoder(sd, num_blocks=2)
    port = _round_trip(SLatGaussianDecoder(**GSD_KW), sd,
                       pw.slat_gs_decoder_state_dict_from_flax(tree, 2))
    return port, tree


def _jax_ss_flow():
    return jssf.SparseStructureFlowModel(**SSF_KW)


def test_ss_flow():
    port, tree = _ss_flow_pair()
    r = np.random.default_rng(16)
    x = r.standard_normal((1, 8, 8, 8, 4)).astype(np.float32)
    t = np.array([731.0], np.float32)
    cond = r.standard_normal((1, 20, 128)).astype(np.float32)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (x, t, cond)))
    want = _jax_ss_flow().apply(tree, *(jnp.asarray(a) for a in (x, t, cond)))
    assert got.shape == (1, 8, 8, 8, 4)
    assert _rel(got, want) <= CHAIN


def test_ss_decoder():
    port, tree = _ss_dec_pair()
    z = np.random.default_rng(17).standard_normal((1, 8, 8, 8, 4)).astype(
        np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(z))
    want = jssv.SparseStructureDecoder(**SSD_KW).apply(tree, jnp.asarray(z))
    assert got.shape == (1, 16, 16, 16, 1)
    assert _rel(got, want) <= CHAIN


# -- the SLat stage ------------------------------------------------------------


@pytest.mark.parametrize("fused", ["off", "interpret"])
def test_slat_flow(fused, monkeypatch):
    """Against the JAX composed path and against its fused K3 kernel in
    interpret mode; the port's torso takes K3's plain version. 160 voxels
    pool to more parents than the 128-slot torso holds, so both truncate."""
    monkeypatch.setenv("GVF_FUSED", fused)
    port, tree = _slat_pair()
    p, j = _voxels(18, B=1, cap=256, counts=(160,), C=4)
    r = np.random.default_rng(19)
    t = np.array([604.0], np.float32)
    cond = r.standard_normal((1, 20, 128)).astype(np.float32)
    with torch.no_grad():
        got = port(p, torch.from_numpy(t), torch.from_numpy(cond))
    want = jsf.SLatFlowModel(**SLF_KW).apply(tree, j, jnp.asarray(t),
                                             jnp.asarray(cond))
    _same_structure(got, want)
    assert _rel(got.feats, want.feats) <= CHAIN


def test_gs_decoder_and_representation():
    port, tree = _gs_pair()
    p, j = _voxels(20, B=1, cap=256, counts=(200,), C=4)
    with torch.no_grad():
        gs, valid = port(p)
    jgs, jvalid = jsd.SLatGaussianDecoder(**GSD_KW).apply(tree, j)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    m = valid.numpy()[0]
    for a in ("_xyz", "_features_dc", "_scaling", "_rotation", "_opacity"):
        assert _rel(_np(getattr(gs, a))[0][m],
                    np.asarray(getattr(jgs, a))[0][m]) <= CHAIN, a
    for a in ("get_xyz", "get_scaling", "get_rotation", "get_opacity"):
        assert _rel(_np(getattr(gs, a))[0][m],
                    np.asarray(getattr(jgs, a))[0][m]) <= CHAIN, a
    assert gs.scaling_activation == "softplus"


def test_to_representation_and_softplus_inverse():
    """The layout and activations alone, and from_activated's softplus
    inverse, against JAX."""
    from gvfdiffusion_torch.representations import gaussians as pg
    from gvfdiffusion_tpu.representations import gaussians as jg

    p, j = _voxels(21, B=1, cap=64, counts=(50,), C=112)
    cfg = psv.GSConfig(filter_3d_kernel_size=9e-4)
    gs, _ = psv.to_representation(p, cfg)
    jgs, _ = jsv.to_representation(j, jsv.GSConfig(filter_3d_kernel_size=9e-4))
    np.testing.assert_allclose(psv.build_perturbation(cfg),
                               jsv.build_perturbation(jsv.GSConfig()))
    act = gs.to_activated_tensor()
    want = jgs.to_activated_tensor()
    assert _rel(act, want) <= MODULE
    kw = dict(scaling_bias=0.004, scaling_activation="softplus",
              mininum_kernel_size=0.0)
    back = pg.from_activated(act, **kw)
    jback = jg.from_activated(jnp.asarray(_np(act)), **kw)
    assert _rel(back._scaling, jback._scaling) <= MODULE
    assert _rel(back.to_activated_tensor(), act) <= MODULE


# -- the sampler ------------------------------------------------------------------


@pytest.mark.parametrize("interval,calls", [((0.0, 1.0), 24),
                                            ((0.5, 1.0), 22)])
def test_flow_euler(interval, calls):
    """A linear velocity field, 12 steps, rescale 3: the sample and the
    number of model calls (two per step inside the guidance interval)."""
    r = np.random.default_rng(22)
    noise = r.standard_normal((1, 6, 4)).astype(np.float32)
    cond = r.standard_normal((1, 6, 4)).astype(np.float32)
    n = [0]

    def model(x, t, c):
        n[0] += 1
        return 0.3 * x + c * (t[:, None, None] / 1000.0)

    got = pfe.FlowEulerGuidanceIntervalSampler().sample(
        model, torch.from_numpy(noise), torch.from_numpy(cond),
        torch.zeros(1, 6, 4), steps=12, rescale_t=3.0, cfg_strength=7.5,
        cfg_interval=interval)["samples"]
    assert n[0] == calls
    want = jfe.FlowEulerGuidanceIntervalSampler().sample(
        model, jnp.asarray(noise), jnp.asarray(cond), jnp.zeros((1, 6, 4)),
        steps=12, rescale_t=3.0, cfg_strength=7.5,
        cfg_interval=interval)["samples"]
    np.testing.assert_allclose(pfe.t_schedule(12, 3.0),
                               jfe.t_schedule(12, 3.0))
    assert _rel(got, want) <= CHAIN


# -- the pipeline ---------------------------------------------------------------


def _occupancy_biased(ss_dec, z, target=60):
    """Shift the decoder's output bias to the middle of the largest logit
    gap near rank `target`, so that no cell sits near the threshold (the
    random-weight occupancy is arbitrary; fp32 drift must not flip it)."""
    with torch.no_grad():
        v = torch.sort(ss_dec(z).flatten(), descending=True).values
        gaps = v[target - 20:target + 20] - v[target - 19:target + 21]
        k = target - 19 + int(torch.argmax(gaps))
        ss_dec.out_layer[2].bias -= 0.5 * (v[k - 1] + v[k])


def test_tiny_pipeline_matches_jax():
    """The stages of TrellisImageTo3DPipeline with the noise injected:
    the occupied voxels exactly, the SLat and the Gaussians within CHAIN."""
    ssf, ssf_tree = _ss_flow_pair()
    ssd, _ = _ss_dec_pair()
    slf, slf_tree = _slat_pair()
    gsd, gsd_tree = _gs_pair()
    cfg = TrellisConfig(ss_steps=2, slat_steps=3, ss_resolution=8,
                        grid_resolution=16, voxel_capacity=256)
    r = np.random.default_rng(23)
    cond = torch.from_numpy(r.standard_normal((1, 20, 128)).astype(np.float32))
    ss_noise = torch.from_numpy(
        r.standard_normal((1, 8, 8, 8, 4)).astype(np.float32))
    slat_noise = torch.from_numpy(
        r.standard_normal((1, 256, 4)).astype(np.float32))
    mean = torch.from_numpy(r.standard_normal(4).astype(np.float32) * 0.3)
    std = torch.from_numpy(r.uniform(0.5, 1.5, 4).astype(np.float32))
    dino = DinoV2(img_size=28, embed_dim=64, depth=1, num_heads=1)
    pipe = TrellisImageTo3DPipeline(dino, ssf, ssd, slf, gsd, cfg, mean, std,
                                    device="cpu")
    with torch.no_grad():
        z = pfe.FlowEulerGuidanceIntervalSampler().sample(
            ssf, ss_noise, cond, torch.zeros_like(cond), steps=2,
            cfg_strength=7.5, rescale_t=3.0)["samples"]
    _occupancy_biased(ssd, z)
    ssd_tree = wc.convert_ss_decoder(
        {k: v.numpy() for k, v in ssd.state_dict().items()},
        channels=(16, 8), num_res_blocks=1, num_res_blocks_middle=1)

    structure = pipe.sample_sparse_structure(cond, noise=ss_noise)
    slat = pipe.sample_slat(structure, cond, noise_feats=slat_noise)
    gs, valid = pipe.decode_slat(slat)

    jp = jpipe.TrellisImageTo3DPipeline(
        None, None, _jax_ss_flow(), ssf_tree,
        jssv.SparseStructureDecoder(**SSD_KW), ssd_tree,
        jsf.SLatFlowModel(**SLF_KW), slf_tree,
        jsd.SLatGaussianDecoder(**GSD_KW), gsd_tree,
        jpipe.TrellisConfig(**cfg.__dict__),
        slat_mean=jnp.asarray(_np(mean)), slat_std=jnp.asarray(_np(std)))
    key = jax.random.PRNGKey(0)  # unused: the noise is injected
    jc = jnp.asarray(_np(cond))
    js = jp.sample_sparse_structure(jc, key, noise=jnp.asarray(_np(ss_noise)))
    n_occ = int(structure.valid.sum())
    assert 0 < n_occ <= 256
    _same_structure(structure, js)
    jslat = jp.sample_slat(js, jc, key, noise_feats=jnp.asarray(
        _np(slat_noise)))
    assert _rel(slat.feats, jslat.feats) <= CHAIN
    jgs, jvalid = jp.decode_slat(jslat)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    m = valid.numpy()[0]
    assert _rel(_np(gs.to_activated_tensor())[0][m],
                np.asarray(jgs.to_activated_tensor())[0][m]) <= CHAIN


def test_preprocess_image_matches_jax():
    img = np.zeros((300, 240, 4), np.uint8)
    img[60:200, 40:190, :3] = np.random.default_rng(24).integers(
        0, 255, (140, 150, 3))
    img[60:200, 40:190, 3] = 255
    got = TrellisImageTo3DPipeline.preprocess_image(None, img)
    want = jpipe.TrellisImageTo3DPipeline.preprocess_image(None, img)
    assert got.shape == (518, 518, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_run_defaults_to_the_card_and_chains_the_stages():
    """The constructor's default device is the card (it raises here, with
    no card); on the CPU, run() gives what its stages give."""
    # DINOv2's width 128 is the flows' cond_channels
    dino = pw.init_random_(DinoV2(embed_dim=128, depth=1, num_heads=2), 25)
    models = (dino, _ss_flow_pair()[0], _ss_dec_pair()[0], _slat_pair()[0],
              _gs_pair()[0])
    cfg = TrellisConfig(ss_steps=1, slat_steps=1, ss_resolution=8,
                        grid_resolution=16, voxel_capacity=256)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TrellisImageTo3DPipeline(*models, cfg)
    pipe = TrellisImageTo3DPipeline(*models, cfg, device="cpu")
    img = np.zeros((64, 64, 4), np.float32)
    img[16:48, 20:44] = 0.8
    out = pipe.run(img, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    cond = pipe.encode_image(torch.from_numpy(pipe.preprocess_image(img))[None])
    st = pipe.sample_sparse_structure(cond, g)
    slat = pipe.sample_slat(st, cond, g)
    gs, valid = pipe.decode_slat(slat)
    assert torch.equal(out["valid"], valid)
    assert torch.equal(out["gaussians"]._xyz, gs._xyz)
    assert bool(torch.isfinite(gs.to_activated_tensor()).all())
