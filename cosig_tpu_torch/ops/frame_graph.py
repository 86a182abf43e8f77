"""One frame of a kernel path as one CUDA graph, replayed with each
frame's camera, lights and materials.

Counterpart of the JAX package's jitted frame: ``trace_wavefront.render_jit``
(``cosig_tpu/ops/trace_wavefront.py:1175-1186``), ``trace_pallas.render_jit``
and ``render_debug_jit`` (``trace_pallas.py:431,605``) each compile one
XLA program per static configuration, with the camera, lights and
materials as traced arguments, and ``trace_pallas.render_chain``
(``:612-636``) queues k frames in one dispatch.

A :class:`FrameGraph` captures one frame of one path for one (cluster
set, ``StaticConfig``, band, row offset, primitive table) as a
``torch.cuda.CUDAGraph``, on a side stream after one eager warm-up frame
there (``capture_begin``/``capture_end``: the ``torch.cuda.graph``
context would also collect garbage and empty the allocator's cache at
every capture):

* ``"wavefront"``: the primary kernel, then a compaction and a bounce per
  depth, then finalize (the list lengths stay on the device, so the
  stages need no host step between them); with ``fission`` the primary's
  trace and a shade, then per depth a compaction, a trace and a shade,
  and with ``cset_primary``/``cset_shadow`` the kernels' builds that walk
  those sets (:func:`~cosig_tpu_torch.ops.trace_wavefront.render_wavefront`);
  a graph holds the launches of its own form only;
* ``"megakernel"``: the megakernel and the image's untiling;
* ``"debug"``: the debug kernel (``cfg.debug_mode`` 1, 2 or 3).

``mxu`` picks the pair test's form of the wavefront (``"off"``,
``"full"``, ``"closest"``; in every form, with or without fission and
the separate sets) and the megakernel (``"off"``, ``"full"``) as their
eager frames take it; the debug view has the exact test only.

The kernels read the frame's uniforms, materials and lights through a
pointer to the device buffer of a
:class:`~cosig_tpu_torch.kernels.binding.FrameBuffer` that the graph
owns, so :meth:`FrameGraph.replay` writes that buffer on the current
stream and replays: a new camera or new lights need no new capture. The
graph's private memory pool holds what the frame allocates: the state
[16, N] ([24, N] with fission), the lists and their lengths, the compaction's scratch, the
image and the int64 ray count (``pool_bytes``).

A replayed frame is the eager frame bit for bit: the same launches with
the same arguments. A capture that the CUDA runtime refuses raises;
nothing falls back to the eager stages.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cosig_tpu_torch.accel.clusters import ClusterSet
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.models.soa import StaticConfig
from cosig_tpu_torch.ops import trace_megakernel, trace_wavefront
from cosig_tpu_torch.ops.kernel_core import U_ROW_OFF
from cosig_tpu_torch.utils import trace

F32 = np.float32

# Path -> its frame with no host read: (cset, fb, cfg, band, row_offset,
# prims, n_sph, n_box) -> (image, int64 rays) on the device.
PATHS = {
    "wavefront": trace_wavefront.one_frame,
    "megakernel": trace_megakernel.one_frame,
    "debug": trace_megakernel.debug_frame,
}
# Pinned frame buffers a graph writes in turn: the host may run this many
# frames less one ahead of the card.
RING = 4


class FrameGraph:
    """One frame of ``path`` captured as a CUDA graph on the cluster set's
    device. ``uniforms``/``lights`` (:func:`kernel_core.build_uniforms`,
    :func:`kernel_core.build_lights`) are the warm-up frame's; ``prims``,
    ``prim_counts``, ``rows`` and ``row_offset`` as in
    :func:`~cosig_tpu_torch.ops.trace_wavefront.render_wavefront`.

    ``cset_primary``, ``cset_shadow`` and ``fission``: the wavefront's
    forms, as in ``render_wavefront``; a graph is captured for one form.
    ``mxu``: the pair test's form of the wavefront and the megakernel.

    ``capture``: the capture's :class:`~cosig_tpu_torch.utils.trace.Capture`
    (its set-up steps' seconds, the plan of its kernels, ``pool_bytes``:
    the device memory the capture reserved for the graph's pool,
    ``launches``: what one replay adds to ``binding.LAUNCHES``, the kernels
    the graph holds and ``graph`` 1); ``capture_s``, ``pool_bytes`` and
    ``launches`` read it. The eager warm-up frame and the capture are the
    set-up spans ``cosig.setup.warmup`` and ``cosig.setup.capture``; a
    replay's steps are the frame spans ``cosig.frame.write``, ``.launch``
    and ``.copy_out`` (:mod:`cosig_tpu_torch.utils.trace`)."""

    def __init__(self, path: str, cset: ClusterSet, cfg: StaticConfig, uniforms: np.ndarray,
                 lights: np.ndarray, prims=None, prim_counts=(0, 0), rows: int | None = None,
                 row_offset: int = 0, cset_primary=None, cset_shadow=None,
                 fission: bool = False, mxu: str = "off"):
        if path not in PATHS:
            raise ValueError(f"unknown path {path!r}: use one of {tuple(PATHS)}")
        forms = _forms(path, cset, dict(cset_primary=cset_primary, cset_shadow=cset_shadow,
                                        fission=fission, mxu=mxu))
        dev = cset.device
        if dev.type != "cuda":
            raise ValueError(f"a FrameGraph captures frames on a CUDA device, not {dev}")
        self.path, self.cset, self.cfg = path, cset, cfg
        self.device = dev
        self.band = cfg.height if rows is None else int(rows)
        self.row_offset = int(row_offset)
        uniforms, lights, self.mats, prims, n_sph, n_box = trace_wavefront.frame_inputs(
            cset, uniforms, lights, row_offset, dev, prims, prim_counts)
        self.prims = prims  # the graph reads this table's memory
        self.fb = binding.FrameBuffer(dev, RING)
        self.forms = forms  # the graph reads these sets' memory
        run = functools.partial(PATHS[path], cset, self.fb, cfg, self.band, self.row_offset,
                                prims, n_sph, n_box, **forms)
        with torch.cuda.device(dev):
            self.fb.write(uniforms, self.mats, lights)
            current = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(current)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                # The warm-up frame builds and loads the kernel library,
                # computes the compaction's grid and loads each kernel.
                with trace.setup("cosig.setup.warmup"):
                    run()
                before = dict(binding.LAUNCHES)
                reserved = torch.cuda.memory_reserved(dev)
                with trace.setup("cosig.setup.capture"), trace.recording() as plan:
                    self.graph.capture_begin()  # into a private memory pool
                    try:
                        self.image, self.rays = run()
                    finally:
                        self.graph.capture_end()
                        # The captured launches did not run; a replay runs them.
                        launches = {k: binding.LAUNCHES[k] - before[k] for k in before}
                        binding.LAUNCHES.update(before)
                pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            current.wait_stream(side)
        launches["graph"] = 1
        self.capture = trace.captured(path, plan, pool_bytes, launches)
        # The compactions' list lengths in the graph's pool, and the pinned
        # copy that a traced replay fills (None on paths with no compaction).
        self._lives = trace.live_tensor(plan.n_live)
        self.lives_host = (None if self._lives is None else
                           torch.empty(self._lives.shape, dtype=torch.int32, pin_memory=True))

    @property
    def capture_s(self) -> float:
        """The host's seconds for the capture and the graph's instantiation."""
        return self.capture.steps["cosig.setup.capture"]

    @property
    def pool_bytes(self) -> int:
        return self.capture.pool_bytes

    @property
    def launches(self) -> dict:
        return self.capture.launches

    def launch(self, uniforms: np.ndarray, lights: np.ndarray) -> None:
        """Write the frame's inputs and replay the graph on the current
        stream; ``self.image`` and ``self.rays`` are then the frame's until
        the next replay."""
        with torch.cuda.device(self.device):
            with trace.span("cosig.frame.write"):
                uniforms = np.array(uniforms, F32)
                uniforms[U_ROW_OFF] = F32(self.row_offset)
                self.fb.write(uniforms, self.mats, np.ascontiguousarray(lights, F32))
            with trace.span("cosig.frame.launch"):
                self.graph.replay()
                for name, n in self.capture.launches.items():
                    binding.LAUNCHES[name] += n

    def replay(self, uniforms: np.ndarray, lights: np.ndarray):
        """Render one frame -> ``(image [band, W, 3], rays as an int64
        tensor)`` on the device, queued with no host read. Both are copies
        of the graph's outputs (one device copy of the image), so a caller
        may keep them across later replays, as a JAX array is kept. While
        tracing is on, the compactions' list lengths (depth 1 up) are copied
        to ``lives_host`` too, to be read once the frame is done."""
        self.launch(uniforms, lights)
        with torch.cuda.device(self.device), trace.span("cosig.frame.copy_out"):
            if self._lives is not None and trace.on():
                self.lives_host.copy_(self._lives, non_blocking=True)
            return self.image.clone(), self.rays.clone()

    def chain(self, uniforms: np.ndarray, lights: np.ndarray, k: int):
        """Replay the frame ``k`` times, queued with no host read in between
        -> ``(last image, total rays of the k frames as an int)``."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        with torch.cuda.device(self.device):
            total = torch.zeros((), dtype=torch.int64, device=self.device)
            for _ in range(k):
                self.launch(uniforms, lights)
                total += self.rays
            with trace.span("cosig.frame.copy_out"):
                img = self.image.clone()
            with trace.span("cosig.frame.wait"):
                return img, int(total)


def _forms(path: str, cset: ClusterSet, forms: dict) -> dict:
    """The keyword arguments of ``path``'s frame for the wavefront forms
    and the pair test's form ``forms``; raise where the path has none or
    the sets do not fit."""
    mxu = forms.get("mxu", "off")
    if path != "wavefront":
        if forms.get("fission") or any(forms.get(k) is not None
                                       for k in ("cset_primary", "cset_shadow")):
            raise ValueError(f"the {path} path has no fission or separate cluster sets")
        if path == "debug":
            if mxu != "off":
                raise ValueError(f"the debug view has the exact pair test only, not mxu={mxu!r}")
            return {}
        trace_megakernel.check_mxu(mxu)
        return dict(mxu=mxu)
    trace_wavefront.check_forms(cset, forms.get("cset_primary"), forms.get("cset_shadow"), mxu)
    return forms


def render_chain(path: str, cset: ClusterSet, uniforms: np.ndarray, lights: np.ndarray,
                 cfg: StaticConfig, k: int, prims=None, prim_counts=(0, 0), **forms):
    """``k`` whole frames of ``path`` queued with no host read in between ->
    ``(last image [H, W, 3], total rays of the k frames as an int)``: on a
    card one capture and k replays, on the CPU k plain frames. ``forms``:
    the wavefront's ``cset_primary``, ``cset_shadow`` and ``fission``, and
    ``mxu``."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if cset.device.type == "cuda":
        return FrameGraph(path, cset, cfg, uniforms, lights, prims,
                          prim_counts, **forms).chain(uniforms, lights, k)
    forms = _forms(path, cset, forms)
    uniforms, lights, mats, prims, n_sph, n_box = trace_wavefront.frame_inputs(
        cset, uniforms, lights, 0, None, prims, prim_counts)
    with trace.span("cosig.frame.write"):
        fb = binding.frame_buffer(cset.device, uniforms, mats, lights)
    total = 0
    with trace.span("cosig.frame.launch"):
        for _ in range(k):
            img, rays = PATHS[path](cset, fb, cfg, cfg.height, 0, prims, n_sph, n_box, **forms)
            total = total + rays
    with trace.span("cosig.frame.wait"):
        return img, int(total)
