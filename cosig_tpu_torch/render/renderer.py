"""Render front end: scene and cluster caching, settings precedence, timing.

Counterpart of :class:`cosig_tpu.render.renderer.Renderer`
(``renderer.py:64-246``) for its two kernel paths. ``Renderer(device,
backend)`` renders on that device: ``"cuda"`` launches the CUDA kernels,
``"cpu"`` runs their plain PyTorch versions. ``backend`` picks the path:
``"wavefront"`` (one primary and ``max_depth - 1`` bounce stages, the JAX
package's ``backend="wavefront"``) or ``"megakernel"`` (one kernel for the
frame, its ``backend="pallas"``). On either, ``debug_mode`` 1/2/3 renders
through the debug kernel (``renderer.py:158-161,182-186``), and
``analytic_primitives`` clusters the mesh without its spheres and boxes
and folds those in analytically (``renderer.py:121-169``). Nothing else
is chosen for the caller — a CUDA renderer on a machine without a GPU
raises.

The cluster set and the primitive table are cached per scene object and
analytic mode (``renderer.py:84-98,230-241``), so camera or settings
changes never rebuild or re-upload geometry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cosig_tpu_torch.accel.clusters import build_clusters
from cosig_tpu_torch.models.scene import SceneData
from cosig_tpu_torch.models.settings import RenderSettings
from cosig_tpu_torch.models.soa import frame_params, materials_host, static_config
from cosig_tpu_torch.ops import kernel_core, trace_megakernel, trace_wavefront
from cosig_tpu_torch.ops.analytic import pack_prims_host
from cosig_tpu_torch.scene.tessellate import extract_triangles

BACKENDS = ("wavefront", "megakernel")


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

    def __init__(self, device="cuda", backend: str = "wavefront"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: use one of {BACKENDS}")
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Renderer(device='cuda') needs a CUDA device; none is available")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
        self.device = dev
        self.backend = backend
        # (scene, analytic, cluster set, primitive table, (n_sph, n_box))
        self._cached: Optional[tuple] = None
        self.last_stats = RenderStats()

    def invalidate_cache(self) -> None:
        self._cached = None

    def _geometry_for(self, scene: SceneData, analytic: bool = False):
        """(cluster set, primitive table, (n_sph, n_box)) on the renderer's
        device, cached per (scene, analytic). Analytic: the mesh clustered
        without its spheres and boxes, which the table then holds; else the
        whole mesh and a zero table (0, 0), kept on the device so a frame
        uploads nothing."""
        c = self._cached
        if c is None or c[0] is not scene or c[1] != analytic:
            tris = extract_triangles(scene, include_primitives=not analytic)
            mats = np.concatenate(materials_host(scene), axis=1)
            cset = build_clusters(tris, mats).to(self.device)
            table, n_sph, n_box = pack_prims_host(scene) if analytic else (None, 0, 0)
            prims, n_sph, n_box = kernel_core.prim_table(table, (n_sph, n_box), self.device)
            self._cached = (scene, analytic, cset, prims, (n_sph, n_box))
        return self._cached[2:]

    def render_to_device(self, scene: SceneData, settings: RenderSettings) -> torch.Tensor:
        """Returns the framebuffer [H, W, 3] f32 on the renderer's device
        (row 0 = bottom), without a copy to the host."""
        params = frame_params(scene, settings)
        cfg = static_config(scene, settings)
        uniforms = kernel_core.build_uniforms(params)
        lights = kernel_core.build_lights(params, cfg.multi_light)
        cset, prims, prim_counts = self._geometry_for(scene, settings.analytic_primitives)
        kw = dict(device=self.device, prims=prims, prim_counts=prim_counts)

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        if cfg.debug_mode != 0:
            img, rays = trace_megakernel.render_debug(cset, uniforms, lights, cfg, **kw)
        elif self.backend == "megakernel":
            img, rays = trace_megakernel.render_clusters(cset, uniforms, lights, cfg, **kw)
        else:
            img, rays = trace_wavefront.render_wavefront(cset, uniforms, lights, cfg, **kw)
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
