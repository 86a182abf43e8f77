"""Render front end: scene and acceleration caching, backend choice,
settings precedence, timing, the chunked render.

Counterpart of :class:`cosig_tpu.render.renderer.Renderer`
(``renderer.py:64-317``). ``Renderer(device, backend)`` renders on that
device; ``backend`` picks the path:

* ``"wavefront"`` (the default; the JAX package's ``"wavefront"``): one
  primary and ``max_depth - 1`` compaction and bounce stages;
* ``"megakernel"`` (the JAX package's ``"pallas"``): one kernel a frame;
* ``"xla"``: the oracle path of plain PyTorch operations
  (:mod:`cosig_tpu_torch.ops.trace_xla`), switching to the per-ray BVH
  walk above 4096 triangles (``renderer.py:198-215``);
* ``"xla-brute"``: the oracle path with the brute-force closest hit at any
  size — the exact test oracle (the BVH walk breaks equal-t ties by visit
  order, not soup order);
* ``"auto"``: ``"wavefront"`` on ``device="cuda"`` (the kernels), ``"xla"``
  on ``device="cpu"``, the counterpart of ``renderer.py:100-108``.

On ``"cuda"`` the two kernel paths launch the CUDA kernels and the oracle
path runs its PyTorch operations on the card; on ``"cpu"`` the kernel
paths run the kernels' plain PyTorch versions. ``debug_mode`` 1/2/3 and
``analytic_primitives`` work on every backend. The device is never chosen
for the caller: a CUDA renderer on a machine without a GPU raises.

Geometry is cached per scene object and analytic mode
(``renderer.py:84-98,230-241``): the cluster set and primitive table for
the kernels, the triangle soup (and the BVH or the analytic tables) for
the oracle path, so camera or settings changes never rebuild or re-upload
geometry.

On ``"cuda"`` a frame of the kernel paths (wavefront, megakernel, debug
view, analytic mode) is one replay of a CUDA graph
(:class:`~cosig_tpu_torch.ops.frame_graph.FrameGraph`), the counterpart
of the JAX package's jitted frame. The renderer keeps one graph, under
:meth:`Renderer.graph_key` (the scene object, analytic mode, the path and
the ``StaticConfig``): a change of camera, lights, background or the
other per-frame values replays it; a change of resolution, depth, AA,
a toggle or the debug mode captures a new one, which replaces it;
``invalidate_cache`` frees it. Its private memory pool holds the frame's
buffers (the wavefront's state [16, N] is 64 B a ray). The oracle path
runs eagerly. ``Renderer.last_capture`` is the graph's capture record
(set-up steps' seconds, the plan of its kernels, pool bytes, launches).

A frame's steps are spans of :mod:`cosig_tpu_torch.utils.trace`
(``cosig.frame`` and its children), profiler ranges while torch.profiler
records and a flag check otherwise; building the geometry is the set-up
span ``cosig.setup.geometry``.

``Renderer(..., mxu=)`` picks the pair test's form on the kernel paths:
``"off"`` (the default) the exact test, ``"full"`` the tensor-core form
for every closest hit and shadow ray, ``"closest"`` for the closest hits
only (the wavefront; the megakernel refuses it). The debug view and the
oracle path have only the exact test, so a renderer whose backend is the
oracle path, and a debug frame, refuse any other form with a
``ValueError``, as ``FrameGraph`` does. A scene whose cluster geometry is
past 6 MiB keeps the exact test (``ops/kernel_core.mxu_mode``), as the
JAX package's streamed stages do.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cosig_tpu_torch.accel.clusters import build_clusters
from cosig_tpu_torch.models.scene import SceneData
from cosig_tpu_torch.models.settings import RenderSettings
from cosig_tpu_torch.models.soa import compile_scene, frame_params, materials_host, static_config
from cosig_tpu_torch.ops import bvh_traverse, frame_graph, kernel_core, trace_megakernel, trace_xla
from cosig_tpu_torch.ops.analytic import closest_hit_analytic, compile_analytic, pack_prims_host
from cosig_tpu_torch.scene.tessellate import extract_triangles
from cosig_tpu_torch.utils import trace

log = logging.getLogger("cosig_tpu_torch.render")

BACKENDS = ("auto", "xla", "xla-brute", "wavefront", "megakernel")
BVH_ABOVE_TRIANGLES = 4096  # the oracle path walks a BVH above this many triangles


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
    """Stateful front end with scene and acceleration caching."""

    def __init__(self, device="cuda", backend: str = "wavefront", mxu: str = "off"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: use one of {BACKENDS}")
        if mxu not in kernel_core.MXU_MODES:
            raise ValueError(f"mxu must be one of {kernel_core.MXU_MODES}, got {mxu!r}")
        if backend == "megakernel":
            trace_megakernel.check_mxu(mxu)
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
        self.mxu = mxu
        if mxu != "off" and self.resolve_backend() in ("xla", "xla-brute"):
            raise ValueError(f"mxu={mxu!r} needs a kernel path: the {self.resolve_backend()!r} "
                             "backend has only the exact pair test")
        # Kernel paths: (scene, analytic, cluster set, primitive table, (n_sph, n_box)).
        self._cached: Optional[tuple] = None
        # Oracle path: [scene, analytic, triangle soup, SceneArrays,
        # AnalyticPrims (analytic) or the BVH (once a frame has walked it) or None].
        self._cached_xla: Optional[list] = None
        # Kernel paths on the card: (graph_key, scene, FrameGraph); the scene
        # is held so that the id in its key stays its own.
        self._graph: Optional[tuple] = None
        self._geometry_s = 0.0  # the set-up seconds of the kernel paths' cached geometry
        self.last_stats = RenderStats()

    def invalidate_cache(self) -> None:
        self._cached = None
        self._cached_xla = None
        self._graph = None

    def resolve_backend(self) -> str:
        """The backend a frame runs: ``auto`` is the kernels' wavefront on
        the card and the oracle path on the CPU."""
        if self.backend != "auto":
            return self.backend
        return "wavefront" if self.device.type == "cuda" else "xla"

    def _geometry_for(self, scene: SceneData, analytic: bool = False):
        """(cluster set, primitive table, (n_sph, n_box)) on the renderer's
        device, cached per (scene, analytic). Analytic: the mesh clustered
        without its spheres and boxes, which the table then holds; else the
        whole mesh and a zero table (0, 0), kept on the device so a frame
        uploads nothing."""
        c = self._cached
        if c is None or c[0] is not scene or c[1] != analytic:
            with trace.setup("cosig.setup.geometry") as step:
                tris = extract_triangles(scene, include_primitives=not analytic)
                mats = np.concatenate(materials_host(scene), axis=1)
                cset = build_clusters(tris, mats).to(self.device)
                table, n_sph, n_box = pack_prims_host(scene) if analytic else (None, 0, 0)
                prims, n_sph, n_box = kernel_core.prim_table(table, (n_sph, n_box), self.device)
            self._geometry_s = step.seconds
            self._cached = (scene, analytic, cset, prims, (n_sph, n_box))
        return self._cached[2:]

    def _arrays_for(self, scene: SceneData, analytic: bool = False) -> list:
        """The oracle path's geometry on the renderer's device, cached per
        (scene, analytic): the mesh without its spheres and boxes and their
        instance tables (analytic), else the whole mesh."""
        c = self._cached_xla
        if c is None or c[0] is not scene or c[1] != analytic:
            with trace.setup("cosig.setup.geometry"):
                tris = extract_triangles(scene, include_primitives=not analytic)
                arrays = compile_scene(scene, tris, device=self.device)
                extra = compile_analytic(scene, device=self.device) if analytic else None
            self._cached_xla = c = [scene, analytic, tris, arrays, extra]
        return c

    def _render_xla(self, scene, params, cfg, backend, analytic):
        """The oracle path's frame -> (image, rays, triangles)."""
        c = self._arrays_for(scene, analytic)
        arrays = c[3]
        if analytic:
            prims = c[4]

            def ch(s, o, d):
                return closest_hit_analytic(s, prims, o, d)

            img, rays = trace_xla.render_image(arrays, params, cfg, closest_hit=ch, with_rays=True)
        elif (backend == "xla" and arrays.num_triangles > BVH_ABOVE_TRIANGLES
              and cfg.debug_mode == 0):
            # Large scenes: the per-ray BVH walk (O(log T)) instead of the
            # O(T) brute-force scan; "xla-brute" opts out.
            if c[4] is None:
                c[4] = bvh_traverse.build_bvh_device(c[2], device=self.device)
            img, rays = bvh_traverse.render_bvh(arrays, c[4], params, cfg, with_rays=True)
        else:
            img, rays = trace_xla.render_image(arrays, params, cfg, with_rays=True)
        return img, rays, arrays.num_triangles

    def kernel_path(self, cfg) -> Optional[str]:
        """The kernel path a frame of ``cfg`` runs (``"wavefront"``,
        ``"megakernel"`` or ``"debug"``), or None on the oracle path."""
        backend = self.resolve_backend()
        if backend in ("xla", "xla-brute"):
            return None
        if cfg.debug_mode != 0:
            return "debug"
        return backend

    def graph_key(self, scene: SceneData, settings: RenderSettings) -> tuple:
        """What a captured frame is specific to: the scene object, analytic
        mode, the kernel path, the ``StaticConfig`` (size, depth, AA,
        toggles, debug mode) and the pair test's form (``mxu``). Frames with
        equal keys replay one graph."""
        cfg = static_config(scene, settings)
        return self._key(scene, settings, cfg, self.kernel_path(cfg))

    def _key(self, scene, settings, cfg, path) -> tuple:
        return (id(scene), settings.analytic_primitives, path, cfg, self._mxu_of(path))

    @property
    def last_capture(self) -> Optional[trace.Capture]:
        """The capture record of the graph the renderer holds, or None."""
        return None if self._graph is None else self._graph[2].capture

    def _mxu_of(self, path) -> str:
        """The pair test's form a frame of ``path`` runs: the renderer's on
        the wavefront and the megakernel; a debug frame refuses any form
        but the exact test."""
        if path == "debug" and self.mxu != "off":
            raise ValueError(f"mxu={self.mxu!r}: the debug view has only the exact pair test")
        return self.mxu if path in ("wavefront", "megakernel") else "off"

    def _frame_graph(self, key, scene, cfg, uniforms, lights, cset, prims, prim_counts):
        """The cached graph of this frame's key, captured (in place of the
        last one) if the key changed."""
        if self._graph is None or self._graph[0] != key:
            self._graph = None  # free the last graph's pool before capturing
            graph = frame_graph.FrameGraph(key[2], cset, cfg, uniforms, lights, prims,
                                           prim_counts, mxu=key[4])
            # The geometry's own set-up, where an earlier capture built it.
            graph.capture.steps.setdefault("cosig.setup.geometry", self._geometry_s)
            self._graph = (key, scene, graph)
            log.info("captured a %s frame graph: %.3f s, %d pool bytes", key[2],
                     graph.capture.steps["cosig.setup.capture"], graph.capture.pool_bytes)
        return self._graph[2]

    def _frames(self, scene: SceneData, settings: RenderSettings, k: int):
        """``k`` frames queued with no host read in between -> (last image,
        rays of the k frames as an int); sets ``last_stats``."""
        with trace.frame() as fr:
            with trace.span("cosig.frame.settings"):
                params = frame_params(scene, settings)
                cfg = static_config(scene, settings)
                backend = self.resolve_backend()
                analytic = settings.analytic_primitives
                path = self.kernel_path(cfg)
                on_card = path is not None and self.device.type == "cuda"
                key = self._key(scene, settings, cfg, path) if on_card else None

            t0 = time.perf_counter()
            if path is None:
                with trace.span("cosig.frame.launch"):
                    rays = 0
                    for _ in range(k):
                        img, r, triangles = self._render_xla(scene, params, cfg, backend, analytic)
                        rays += r
                with trace.span("cosig.frame.wait"):
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            else:
                with trace.span("cosig.frame.uniforms"):
                    uniforms = kernel_core.build_uniforms(params)
                    lights = kernel_core.build_lights(params, cfg.multi_light)
                with trace.span("cosig.frame.lookup"):
                    cset, prims, prim_counts = self._geometry_for(scene, analytic)
                    if on_card:
                        graph = self._frame_graph(key, scene, cfg, uniforms, lights, cset,
                                                  prims, prim_counts)
                triangles = cset.num_triangles
                if not on_card:
                    img, rays = frame_graph.render_chain(path, cset, uniforms, lights, cfg, k,
                                                         prims, prim_counts,
                                                         mxu=self._mxu_of(path))
                elif k == 1:
                    img, rays = graph.replay(uniforms, lights)
                    with trace.span("cosig.frame.wait"):
                        rays = int(rays)  # the one read: the frame is done
                else:
                    img, rays = graph.chain(uniforms, lights, k)
                if on_card and fr is not None:  # a chain copies out no list lengths
                    fr.replayed(graph.capture, graph.lives_host if k == 1 else None)
            dt = (time.perf_counter() - t0) * 1e3
        self.last_stats = RenderStats(
            width=cfg.width,
            height=cfg.height,
            triangles=triangles,
            render_ms=dt,
            rays_traced=rays,
        )
        return img, rays

    def render_to_device(self, scene: SceneData, settings: RenderSettings) -> torch.Tensor:
        """Returns the framebuffer [H, W, 3] f32 on the renderer's device
        (row 0 = bottom), without a copy to the host. The frame is done
        when this returns, as in the JAX package (``renderer.py:218``):
        ``last_stats.rays_traced`` is the int the host read, and
        ``last_stats.render_ms`` the host's time from the call to it."""
        return self._frames(scene, settings, 1)[0]

    def render_chain(self, scene: SceneData, settings: RenderSettings, k: int):
        """Render the frame ``k`` times, queued with no host read in between
        -> ``(last image [H, W, 3] on the device, total rays of the k frames
        as an int)``: on the card the kernel paths replay the cached graph k
        times. ``last_stats`` holds the chain's time and rays; timing two
        chain lengths and taking the slope gives the time per frame."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        return self._frames(scene, settings, k)

    def render(self, scene: SceneData, settings: RenderSettings) -> np.ndarray:
        """Render and copy to the host -> [H, W, 3] f32 numpy, row 0 bottom."""
        return self.render_to_device(scene, settings).cpu().numpy()

    def render_chunked(self, scene: SceneData, settings: RenderSettings,
                       rows_per_chunk: int = 64, checkpoint: Optional[str] = None,
                       progress=None) -> np.ndarray:
        """Resumable render in bands of ``rows_per_chunk`` rows, each through
        the oracle path (brute-force closest hit) on the renderer's device,
        with an optional on-disk checkpoint (``renderer.py:248-304``).

        Interrupt at any point; running again with the same ``checkpoint``
        path resumes after the last finished band, and the checkpoint is
        removed when the frame is done. Returns [H, W, 3] f32 numpy."""
        arrays = self._arrays_for(scene)[3]
        params = frame_params(scene, settings)
        cfg = static_config(scene, settings)
        h, w = cfg.height, cfg.width

        img = np.zeros((h, w, 3), np.float32)
        done_rows = 0
        if checkpoint and os.path.exists(checkpoint):
            data = np.load(checkpoint)
            if tuple(data["shape"]) == (h, w) and int(data["depth"]) == cfg.max_depth:
                img = data["img"]
                done_rows = int(data["done_rows"])
                log.info("resuming chunked render at row %d/%d", done_rows, h)

        t0 = time.perf_counter()
        rays = 0
        while done_rows < h:
            rows = min(rows_per_chunk, h - done_rows)
            band, band_rays = trace_xla.render_image(arrays, params, cfg, row_offset=done_rows,
                                                     rows=rows, with_rays=True)
            img[done_rows:done_rows + rows] = band.cpu().numpy()
            rays += band_rays
            done_rows += rows
            if checkpoint:
                # Through a file handle: np.savez(path) appends ".npz" to a
                # bare path, which would break the resume lookup.
                with open(checkpoint, "wb") as f:
                    np.savez(f, img=img, done_rows=done_rows, shape=(h, w), depth=cfg.max_depth)
            if progress:
                progress(done_rows / h)
        if checkpoint and os.path.exists(checkpoint):
            os.remove(checkpoint)
        self.last_stats = RenderStats(width=w, height=h, triangles=arrays.num_triangles,
                                      render_ms=(time.perf_counter() - t0) * 1e3,
                                      rays_traced=rays)
        return img

    def save_png(self, img, path: str) -> None:
        from cosig_tpu_torch.utils.png import write_png

        if isinstance(img, torch.Tensor):
            img = img.cpu().numpy()
        write_png(path, np.asarray(img))


def estimate_rays(cfg) -> int:
    """Upper bound on the rays of a frame: W*H*AA*depth*(1 primary or
    secondary + 1 shadow). The renderer reports the live count."""
    shadow = 1 if cfg.enable_diffuse else 0
    return cfg.width * cfg.height * cfg.aa_samples * cfg.max_depth * (1 + shadow)
