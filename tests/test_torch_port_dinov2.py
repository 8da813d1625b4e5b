"""DINOv2 parity: the port's encoder (models/dinov2.py), its weight bridge
and the video preprocessing (scripts/process_video.py) against the JAX
package, in fp32 on the CPU, at a small size (2 blocks, 128 wide, heads
of 64, 4 registers, 56^2 input: L = 1 + 4 + 16 = 21 tokens). Both packages
get the same random weights: the port's hub-named state dict goes through
`convert_dinov2` to flax and back through `dinov2_state_dict_from_flax`.

Tolerances, each with its reason:
  * the forward (prenorm and normed tokens) and `encode_image`: rel L2 <=
    1e-5 (the same fp32 math summed in another order; readings ~1e-7);
  * `normalize_frame` and the 518 resize: max abs <= 1e-4 (torch's
    antialiased bilinear against jax.image.resize, both in fp32; readings
    up to 1e-5 on [0, 1] pixels);
  * the weight bridge and `init_random_`: exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.models.dinov2 import DinoV2, encode_image
from gvfdiffusion_torch.models.dit import DiT
from gvfdiffusion_torch.models.motion_vae import MotionVAE
from gvfdiffusion_torch.scripts.process_video import (
    encode_video, normalize_frame)
from gvfdiffusion_torch.utils.weights import (
    dinov2_state_dict_from_flax, init_random_)
from gvfdiffusion_tpu.models import dinov2 as jd
from gvfdiffusion_tpu.scripts.process_video import (
    normalize_frame as j_normalize_frame)
from gvfdiffusion_tpu.utils.weight_convert import convert_dinov2

KW = dict(img_size=56, patch_size=14, embed_dim=128, depth=2, num_heads=2,
          num_register_tokens=4)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def pair():
    port = init_random_(DinoV2(**KW), seed=0).eval()
    sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    params = convert_dinov2(sd, depth=2)
    port.load_state_dict(dinov2_state_dict_from_flax(params, depth=2))
    return jd.DinoV2(**KW), params, port


def _images(seed, T=3, size=56):
    r = np.random.default_rng(seed)
    return r.uniform(size=(T, size, size, 3)).astype(np.float32)


def test_hub_key_names_and_bridge_round_trip():
    port = init_random_(DinoV2(**KW), seed=1)
    sd = port.state_dict()
    for k in ("cls_token", "pos_embed", "register_tokens",
              "patch_embed.proj.weight", "blocks.1.attn.qkv.weight",
              "blocks.1.attn.proj.bias", "blocks.0.ls1.gamma",
              "blocks.0.mlp.fc2.weight", "norm.bias"):
        assert k in sd, k
    back = dinov2_state_dict_from_flax(
        convert_dinov2({k: v.numpy() for k, v in sd.items()}, depth=2),
        depth=2)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_forward_matches_jax(pair):
    jmodel, params, port = pair
    x = _images(2) * 2.0 - 1.0
    jpre, jnormed = jmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        pre, normed = port(torch.from_numpy(x))
    assert pre.shape == (3, 21, 128) and pre.dtype == torch.float32
    assert _rel(pre, jpre) <= 1e-5, _rel(pre, jpre)
    assert _rel(normed, jnormed) <= 1e-5, _rel(normed, jnormed)


def test_encode_image_matches_jax(pair):
    jmodel, params, port = pair
    x = _images(3)
    want = jd.encode_image(jmodel, params, jnp.asarray(x))
    got = encode_image(port, torch.from_numpy(x))
    assert got.shape == (3, 21, 128)
    assert _rel(got, want) <= 1e-5, _rel(got, want)


@pytest.mark.parametrize("shape,alpha", [((90, 70, 3), None),
                                         ((64, 120, 4), None),
                                         ((100, 100, 3), "disk")])
def test_normalize_frame_matches_jax(shape, alpha):
    r = np.random.default_rng(4)
    img = (r.uniform(size=shape) * 255).astype(np.uint8)
    a = None
    if alpha == "disk":
        yy, xx = np.mgrid[:shape[0], :shape[1]]
        a = ((yy - 40) ** 2 + (xx - 55) ** 2 < 30 ** 2).astype(np.float32)
    want = j_normalize_frame(img, a)
    got = normalize_frame(img, a)
    assert got.shape == (512, 512, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_encode_video_matches_jax(pair):
    """frames -> normalize -> resize to the model's 56 -> encode_image, the
    chain of the JAX `encode_video_features` without its file IO."""
    jmodel, params, port = pair
    r = np.random.default_rng(5)
    frames = (r.uniform(size=(2, 40, 48, 3)) * 255).astype(np.uint8)
    canv = np.stack([np.asarray(jax.image.resize(
        jnp.asarray(j_normalize_frame(f)), (56, 56, 3), "bilinear"))
        for f in frames])
    want = jd.encode_image(jmodel, params, jnp.asarray(canv))
    got = encode_video(frames, port, image_size=56, device="cpu")
    assert got.shape == (2, 21, 128)
    assert _rel(got, want) <= 1e-5, _rel(got, want)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        encode_video(np.zeros((1, 56, 56, 3), np.float32), DinoV2(**KW),
                     image_size=56)


def test_other_grid_raises(pair):
    """Another square grid resizes the position embedding (held against
    JAX in tests/test_torch_port_wild_io.py); a grid that is not square
    raises."""
    with pytest.raises(ValueError, match="square"):
        pair[2](torch.zeros(1, 70, 56, 3))


def test_init_random_fan_in():
    """Conv weights are drawn at 1/sqrt(in * kh * kw); every parameter of
    at most two dimensions (all of the DiT's and the motion VAE's) is drawn
    as before the conv repair: N(0, 1/shape[1]) for matrices."""
    w = init_random_(DinoV2(embed_dim=256, depth=1, num_heads=4),
                     seed=3).patch_embed.proj.weight.detach()
    assert w.shape == (256, 3, 14, 14)
    assert abs(float(w.std()) * math.sqrt(3 * 14 * 14) - 1.0) < 0.02
    for module in (DiT(num_blocks=1), MotionVAE(depth=1)):
        got = init_random_(module, seed=7).state_dict()
        g = torch.Generator().manual_seed(7)
        for name, p in module.named_parameters():
            assert p.dim() <= 2, name
            r = torch.randn(p.shape, generator=g, dtype=torch.float32)
            if name.endswith("gamma") or (p.dim() == 1
                                          and name.endswith("weight")):
                r = 1.0 + 0.1 * r
            elif p.dim() == 1:
                r = 0.1 * r
            else:
                r = r / p.shape[1] ** 0.5
            assert torch.equal(got[name], r), name
