"""Render front end: scene and cluster caching, settings precedence, timing.

Counterpart of :class:`cosig_tpu.render.renderer.Renderer`
(``renderer.py:64-246``) for the default path. ``Renderer(device)`` runs
the wavefront render on that device: ``"cuda"`` launches the CUDA kernels,
``"cpu"`` runs their plain PyTorch versions. Nothing else is chosen for
the caller — a CUDA renderer on a machine without a GPU raises.

The tessellated scene and its cluster set are cached per scene object
(``renderer.py:84-98,230-241``), so camera or settings changes never
rebuild or re-upload geometry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cosig_tpu.models.scene import SceneData
from cosig_tpu.models.settings import RenderSettings
from cosig_tpu.scene.tessellate import extract_triangles
from cosig_tpu_torch.accel.clusters import ClusterSet, build_clusters
from cosig_tpu_torch.models.soa import frame_params, materials_host, static_config
from cosig_tpu_torch.ops import kernel_core, trace_wavefront


@dataclass
class RenderStats:
    width: int = 0
    height: int = 0
    triangles: int = 0
    render_ms: float = 0.0
    rays_traced: int = 0

    @property
    def mrays_per_s(self) -> float:
        if self.render_ms <= 0:
            return 0.0
        return self.rays_traced / (self.render_ms * 1e3)


class Renderer:
    """Stateful front end with scene and cluster-set caching."""

    def __init__(self, device="cuda"):
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Renderer(device='cuda') needs a CUDA device; none is available")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
        self.device = dev
        self._cached_scene: Optional[SceneData] = None
        self._cached_cset: Optional[ClusterSet] = None
        self.last_stats = RenderStats()

    def invalidate_cache(self) -> None:
        self._cached_scene = None
        self._cached_cset = None

    def _cset_for(self, scene: SceneData) -> ClusterSet:
        if self._cached_scene is not scene or self._cached_cset is None:
            tris = extract_triangles(scene)
            mats = np.concatenate(materials_host(scene), axis=1)
            self._cached_cset = build_clusters(tris, mats).to(self.device)
            self._cached_scene = scene
        return self._cached_cset

    def render_to_device(self, scene: SceneData, settings: RenderSettings) -> torch.Tensor:
        """Returns the framebuffer [H, W, 3] f32 on the renderer's device
        (row 0 = bottom), without a copy to the host."""
        if settings.debug_mode != 0:
            raise NotImplementedError(
                "debug_mode needs the debug kernel, not ported yet "
                "(ROADMAP.md, still to port: item 1)"
            )
        if settings.analytic_primitives:
            raise NotImplementedError(
                "analytic_primitives needs the analytic primitive fold, not ported yet "
                "(ROADMAP.md, still to port: item 3)"
            )
        params = frame_params(scene, settings)
        cfg = static_config(scene, settings)
        uniforms = kernel_core.build_uniforms(params)
        lights = kernel_core.build_lights(params, cfg.multi_light)
        cset = self._cset_for(scene)

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        img, rays = trace_wavefront.render_wavefront(
            cset, uniforms, lights, cfg, device=self.device
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = (time.perf_counter() - t0) * 1e3
        self.last_stats = RenderStats(
            width=cfg.width,
            height=cfg.height,
            triangles=cset.num_triangles,
            render_ms=dt,
            rays_traced=rays,
        )
        return img

    def render(self, scene: SceneData, settings: RenderSettings) -> np.ndarray:
        """Render and copy to the host -> [H, W, 3] f32 numpy, row 0 bottom."""
        return self.render_to_device(scene, settings).cpu().numpy()
