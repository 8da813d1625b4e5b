"""The port imports torch and never jax: importing every module of
gvfdiffusion_torch, and chip_smoke.py, in a fresh interpreter leaves jax
(and flax, optax, orbax, and the JAX package) out of sys.modules, and
builds no kernel; nor does it import cv2, imageio, PIL or safetensors,
which the port reads and writes files with where they are installed."""

import os
import pkgutil
import subprocess
import sys

import gvfdiffusion_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "gvfdiffusion_torch._ext",
    "gvfdiffusion_torch.ops.fused_sublayer",
    "gvfdiffusion_torch.ops.fps",
    "gvfdiffusion_torch.nn.embedders",
    "gvfdiffusion_torch.nn.attention",
    "gvfdiffusion_torch.nn.transformer",
    "gvfdiffusion_torch.models.dit",
    "gvfdiffusion_torch.models.motion_vae",
    "gvfdiffusion_torch.diffusion.gaussian_diffusion",
    "gvfdiffusion_torch.diffusion.dpm_solver",
    "gvfdiffusion_torch.pipelines.video_to_4d",
    "gvfdiffusion_torch.utils.weights",
    "gvfdiffusion_torch.utils.device",
    "gvfdiffusion_torch.ops.fused_attention",
    "gvfdiffusion_torch.models.dinov2",
    "gvfdiffusion_torch.scripts.process_video",
    "gvfdiffusion_torch.ops.quaternion",
    "gvfdiffusion_torch.ops.sh",
    "gvfdiffusion_torch.representations.gaussians",
    "gvfdiffusion_torch.representations.camera",
    "gvfdiffusion_torch.render.reference_renderer",
    "gvfdiffusion_torch.ops.rasterize.binning",
    "gvfdiffusion_torch.ops.rasterize.xla_blend",
    "gvfdiffusion_torch.render.renderer",
    "gvfdiffusion_torch.sparse.tensor",
    "gvfdiffusion_torch.sparse.ops",
    "gvfdiffusion_torch.sparse.conv",
    "gvfdiffusion_torch.sparse.attention",
    "gvfdiffusion_torch.models.static_vae",
    "gvfdiffusion_torch.models.sparse_vae",
    "gvfdiffusion_torch.models.trellis.ss_flow",
    "gvfdiffusion_torch.models.trellis.ss_vae",
    "gvfdiffusion_torch.models.trellis.slat_flow",
    "gvfdiffusion_torch.models.trellis.slat_decoders",
    "gvfdiffusion_torch.diffusion.flow_euler",
    "gvfdiffusion_torch.pipelines.trellis_image_to_3d",
    "gvfdiffusion_torch.diffusion.resample",
    "gvfdiffusion_torch.train.train_state",
    "gvfdiffusion_torch.train.diffusion_trainer",
    "gvfdiffusion_torch.data.dataset_latent",
    "gvfdiffusion_torch.utils.config",
    "gvfdiffusion_torch.utils.checkpoint",
    "gvfdiffusion_torch.cli.main_latent",
    "gvfdiffusion_torch.ops.flash_attention",
    "gvfdiffusion_torch.models.registry",
    "gvfdiffusion_torch.cli.infer",
    "gvfdiffusion_torch.cli.main_vae",
    "gvfdiffusion_torch.diffusion.losses",
    "gvfdiffusion_torch.diffusion.respace",
    "gvfdiffusion_torch.utils.logger",
    "gvfdiffusion_torch.utils.script_util",
    "gvfdiffusion_torch.utils.weight_convert",
    "gvfdiffusion_torch.utils.hub",
    "gvfdiffusion_torch.utils.image",
    "gvfdiffusion_torch.models.clip",
    "gvfdiffusion_torch.models.modnet",
    "gvfdiffusion_torch.scripts.matting",
    "gvfdiffusion_torch.cli.encode_latent",
    "gvfdiffusion_torch.data.prefetch",
    "gvfdiffusion_torch.data.dataset_inference",
    "gvfdiffusion_torch.train.eval_utils",
    "gvfdiffusion_torch.utils.profiling",
    "gvfdiffusion_torch.utils.elastic",
    "gvfdiffusion_torch.nn.misc",
    "gvfdiffusion_torch.ops.lpips",
]
# image, video and checkpoint packages the card may lack: imported inside
# the functions that need them, never by importing a module
OPTIONAL = ("cv2", "imageio", "PIL", "safetensors")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        gvfdiffusion_torch.__path__, "gvfdiffusion_torch."))


def test_every_slice_module_exists():
    assert set(SLICE_MODULES) <= set(_all_modules())


def test_port_never_imports_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_all_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "              'gvfdiffusion_tpu'))\n"
        "assert not bad, bad\n"
        "opt = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        f"             {OPTIONAL!r})\n"
        "assert not opt, opt\n"
        "from gvfdiffusion_torch import _ext\n"
        "assert _ext._lib is None  # no build at import time\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
