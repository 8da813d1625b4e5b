"""Port parity: models/modnet.py and scripts/matting.py against the JAX
package on the CPU.

MODNet at hr_channels 8, backbone width 0.25, its parameters drawn by
`init_random_` and its BatchNorm statistics from a seed, carried into
JAX's variables by `weights.modnet_variables` (whose tree must have JAX
`init`'s paths and shapes): semantic, detail and matte within rel L2 1e-5
in fp32 on an even size (every stride-2 conv sees an even input: flax pads
it (0, 1)) and on a size whose quarter is odd (a stride-2 conv on an odd
input: (1, 1)). Then `preprocess_size`, `make_matting_fn` against JAX's
(abs 1e-5), the `.npz` variables written by either side loading in the
other, and `scripts.matting.main` on a directory of PNGs against JAX's
main on the same `--ckpt-path` (the full-width MODNet; mattes as PNGs,
within one level of 255). JAX runs jitted.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gvfdiffusion_torch.models import modnet as pm
from gvfdiffusion_torch.scripts import matting as pmat
from gvfdiffusion_torch.utils import weights as pw
from gvfdiffusion_tpu.models import modnet as jm
from gvfdiffusion_tpu.scripts import matting as jmat

REL = 1e-5
HR, WIDTH = 8, 0.25


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _seeded(hr=HR, width=WIDTH, seed=5):
    """A port MODNet with seeded parameters and BatchNorm statistics."""
    model = pw.init_random_(pm.MODNet(hr, width), seed=seed).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, b in model.named_buffers():
            r = torch.rand(b.shape, generator=g)
            b.copy_(0.5 * r if "mean" in name else 0.75 + 0.5 * r)
    return model


@pytest.fixture(scope="module")
def pair():
    model = _seeded()
    return model, pw.modnet_variables(model.state_dict(), HR, WIDTH)


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


def test_variables_have_jax_init_paths(pair):
    _, var = pair
    shapes = jax.eval_shape(jm.MODNet(HR, WIDTH).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    assert _paths(var) == _paths(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape), shapes))


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 36, 44)])
def test_modnet_matches_jax(pair, shape):
    model, var = pair
    x = np.random.default_rng(shape[1]).uniform(
        -1, 1, shape + (3,)).astype(np.float32)
    want = jax.jit(jm.MODNet(HR, WIDTH).apply)(var, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for name, g, w in zip(("semantic", "detail", "matte"), got, want):
        g, w = g.permute(0, 2, 3, 1).numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        assert _rel(g, w) <= REL, name
        # the branches' logits, not their sigmoids alone
        assert _rel(g - 0.5, w - 0.5) <= REL * 10, name


def test_same_padding_differs_from_symmetric():
    """flax's SAME at stride 2 on an even size is not torch's padding=1:
    the port pads (0, 1), as flax does."""
    x = torch.arange(64.0).reshape(1, 1, 8, 8)
    padded = pm._same_pad(x, 3, 2)
    assert padded.shape[-2:] == (9, 9)
    assert torch.equal(padded[0, 0, :8, :8], x[0, 0])
    assert pm._same_pad(torch.zeros(1, 1, 7, 9), 3, 2).shape[-2:] == (9, 11)


@pytest.mark.parametrize("hw", [(1080, 1920), (100, 200), (520, 530),
                                (700, 300), (64, 64)])
def test_preprocess_size_matches_jax(hw):
    assert pm.preprocess_size(*hw) == jm.preprocess_size(*hw)
    assert pm.preprocess_size(*hw, 64) == jm.preprocess_size(*hw, 64)


def test_matting_fn_matches_jax(pair):
    model, var = pair
    img = np.random.default_rng(0).uniform(0, 255, (70, 50, 3)).astype(
        np.uint8)
    got = pm.make_matting_fn(model, ref_size=64)(img)
    want = jm.make_matting_fn(jm.MODNet(HR, WIDTH), var, ref_size=64)(img)
    assert got.shape == (70, 50) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_params_npz_round_trip_with_jax(pair, tmp_path):
    model, var = pair
    pmat.save_params(model, str(tmp_path / "port.npz"))
    back = jmat.load_params(None, str(tmp_path / "port.npz"))
    assert _paths(back) == _paths(var)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, var)
    jmat.save_params(var, str(tmp_path / "jax.npz"))
    mine = pmat.load_params(pm.MODNet(HR, WIDTH), str(tmp_path / "jax.npz"))
    for k, v in model.state_dict().items():
        assert torch.equal(mine.state_dict()[k], v), k


def test_matting_main_matches_jax(tmp_path, capsys):
    """Both CLIs on one directory of PNGs with the same checkpoint (the
    full-width MODNet, seeded): the same files, the same mattes."""
    ckpt = str(tmp_path / "modnet.npz")
    pmat.save_params(_seeded(32, 1.0, seed=7), ckpt)
    src = tmp_path / "in"
    src.mkdir()
    r = np.random.default_rng(3)
    for i in range(2):
        Image.fromarray(r.integers(0, 255, (48, 40, 3)).astype(np.uint8)
                        ).save(src / f"f{i}.png")
    (src / "notes.txt").write_text("skipped")
    args = ["--input-path", str(src), "--ckpt-path", ckpt,
            "--ref-size", "64"]
    pmat.main(args + ["--output-path", str(tmp_path / "port"),
                      "--device", "cpu"])
    jmat.main(args + ["--output-path", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["f0_matte.png", "f1_matte.png"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        a = np.asarray(Image.open(tmp_path / "port" / n), np.int32)
        b = np.asarray(Image.open(tmp_path / "jax" / n), np.int32)
        assert a.shape == b.shape == (48, 40)
        assert np.abs(a - b).max() <= 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pmat.main(args + ["--output-path", str(tmp_path / "x")])
