"""GaussianRenderer, the rendering API (port of
gvfdiffusion_tpu/render/renderer.py:40-190).

Projection (render/reference_renderer.project_gaussians), tile binning
(ops/rasterize/binning.py) and the tile blend (ops/rasterize/xla_blend.py),
in plain torch: the JAX renderer reaches no Pallas kernel. The binned
backend is ported, in one round or in several (`rounds` > 1, with
`early_exit`: the inference configuration of bench.py, tile 64, K 128 x
2); `RenderOptions` keeps the JAX defaults, and the renderer raises on the
options it does not run (the dense reference backend, supersampling).
Colour overrides and per-call backgrounds are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..ops.quaternion import build_covariance
from ..ops.rasterize.binning import bin_gaussians
from ..ops.rasterize.xla_blend import blend_tiles, blend_tiles_multiround
from ..ops.sh import rgb_from_sh_dc
from ..representations.camera import Camera
from ..representations.gaussians import GaussianSplat
from .reference_renderer import project_gaussians


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    near: float = 0.8
    far: float = 1.6
    bg_color: tuple = (1.0, 1.0, 1.0)
    use_mip: bool = True
    kernel_size_2d: float = 0.1
    ssaa: int = 1
    backend: str = "binned"
    tile: int = 32
    max_per_tile: int = 256
    rounds: int = 1
    early_exit: bool = False


class GaussianRenderer:
    def __init__(self, options: Optional[RenderOptions] = None):
        opt = options or RenderOptions()
        if opt.backend != "binned" or opt.ssaa != 1:
            raise NotImplementedError(
                "only the binned backend without supersampling is ported; "
                f"got {opt}")
        self.options = opt

    def render(self, gs: GaussianSplat, camera: Camera,
               delta: Optional[torch.Tensor] = None,
               valid: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """One splat set from one camera -> dict(render [H, W, 3],
        depth [H, W], alpha [H, W]). `delta` [N, 14] applies the variation
        field."""
        opt = self.options
        cam = camera.replace(near=opt.near, far=opt.far)
        return self._render_activated(*self._activate(gs, delta), cam,
                                      self._bg(gs), valid)

    def render_views(self, gs: GaussianSplat, world_views: torch.Tensor,
                     intrinsics: torch.Tensor, height: int, width: int,
                     delta: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None, chunk: int = 8
                     ) -> Dict[str, torch.Tensor]:
        """V cameras (world_views [V, 4, 4], intrinsics [V, 3, 3] or
        [3, 3]) -> dict of [V, ...]. The delta, the colours and the
        world-space covariances are computed once for all views; the views
        go `chunk` at a time through one projection, one binning and one
        blend, so `chunk` trades memory (the binning's tile x Gaussian
        table grows with it) for fewer, larger launches. The frames do
        not depend on it."""
        opt = self.options
        V = world_views.shape[0]
        if intrinsics.dim() == 2:
            intrinsics = intrinsics.expand(V, 3, 3)
        xyz, scaling, rotation, colors, opac0 = self._activate(gs, delta)
        cov3d = build_covariance(scaling, rotation)
        bg = self._bg(gs)
        outs = [self._render_activated(
            xyz, scaling, rotation, colors, opac0,
            Camera(world_view=world_views[s:s + chunk],
                   intrinsics=intrinsics[s:s + chunk], height=height,
                   width=width, near=opt.near, far=opt.far),
            bg, valid, cov3d=cov3d) for s in range(0, V, max(chunk, 1))]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def _bg(self, gs: GaussianSplat) -> torch.Tensor:
        return torch.as_tensor(self.options.bg_color, dtype=torch.float32,
                               device=gs._xyz.device)

    @staticmethod
    def _activate(gs: GaussianSplat, delta):
        """The camera-independent attributes, shared across views."""
        if delta is not None:
            a = gs.apply_variation(delta)
            xyz, scaling, rotation = a["xyz"], a["scaling"], a["rotation"]
            features, opacity = a["features"], a["opacity"]
        else:
            xyz, scaling = gs.get_xyz, gs.get_scaling
            rotation, features = gs.get_rotation, gs.get_features
            opacity = gs.get_opacity
        return (xyz, scaling, rotation, rgb_from_sh_dc(features[..., 0, :]),
                opacity[..., 0])

    def _render_activated(self, xyz, scaling, rotation, colors, opac0,
                          cam: Camera, bg, valid, cov3d=None):
        """One camera, or one of V views (world_view [V, 4, 4]): each
        output then has a leading V."""
        opt = self.options
        proj = project_gaussians(
            xyz, scaling, rotation, cam,
            kernel_size_2d=opt.kernel_size_2d if opt.use_mip else 0.3,
            mip=opt.use_mip, cov3d=cov3d)
        v = proj["in_front"] if valid is None else proj["in_front"] & valid
        if opt.rounds > 1:
            rgb, dep, acc = blend_tiles_multiround(
                proj["mean2d"], proj["cov2d"], colors,
                opac0 * proj["compensation"], proj["depth"], v, cam.height,
                cam.width, bg, tile=opt.tile, per_round=opt.max_per_tile,
                rounds=opt.rounds, early_exit=opt.early_exit)
            return {"render": rgb, "depth": dep, "alpha": acc}
        binned = bin_gaussians(
            proj["mean2d"], proj["cov2d"], colors,
            opac0 * proj["compensation"], proj["depth"], v, cam.height,
            cam.width, tile=opt.tile, max_per_tile=opt.max_per_tile)
        rgb, dep, acc = blend_tiles(binned, cam.height, cam.width, bg)
        return {"render": rgb, "depth": dep, "alpha": acc}
