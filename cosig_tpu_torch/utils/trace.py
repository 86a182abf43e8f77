"""The port's spans and counters, on torch.profiler's clock.

Tracing is on while torch.profiler records (the CLI's ``--profile DIR``,
a benchmark's traced stretch); nothing here starts it. Then each span is
a profiler range (the fast record-function path), so it lands among the
profiler's own host events, on the clock of the device activity that
CUPTI traces, and a span's parent is the span that encloses it. Off, a
span costs one flag check: no range, clock read, allocation or record.

Hot spans, one frame of ``Renderer.render_to_device`` (only while on):

* ``cosig.frame``, the root (:func:`frame`), its argument the frame's
  number, which its children share;
* ``cosig.frame.settings``: ``static_config``, the graph key
  (``frame_params`` on the oracle path);
* ``cosig.frame.lookup``: the geometry and graph caches;
* ``cosig.frame.uniforms``: ``FrameInputs.uniforms`` and its light table;
* ``cosig.frame.write``: ``FrameBuffer.write``, the ring's event wait in it;
* ``cosig.frame.launch``: the graph's replay on the card, the stages on
  the CPU;
* ``cosig.frame.copy_out``: the copies of the frame's outputs;
* ``cosig.frame.wait``: the one read of the ray count.

Set-up spans (:func:`setup`), once per capture, always timed and kept:
``cosig.setup.geometry`` (triangles, clusters, upload, primitive table),
``cosig.setup.kernels`` (the first load or build of the kernel library),
``cosig.setup.warmup`` (a graph's eager warm-up frame) and
``cosig.setup.capture`` (``capture_begin`` to ``capture_end``, the
graph's instantiation in it). A capture takes the steps run since the
last one into its :class:`Capture`, :func:`last_capture`.

Counters, in the style of ``binding.LAUNCHES``: :data:`COUNTS`
``captures``, one per graph capture, always; ``frame_inputs_built``, one
per build of a scene's part of the frames' inputs
(:class:`~cosig_tpu_torch.render.frame_inputs.FrameInputs`, cached with
the Renderer's geometry), always; a capture's ``form``
(``"fission"`` or ``"fused"``), so a record says which form ran. A
capture's ``plan``: the ordered labels of the port's kernels its frame
launches, recorded by the launch wrappers (:func:`plan_step`):
``primary``, then ``compact.1``, ``bounce.1``, ... (fused) or
``shade_all``, ``compact.1``, ``trace.1``, ``shade.1``, ... (fission),
``megakernel``, ``debug``. The k-th
``cosig::`` kernel of a traced frame on the card is the plan's k-th. A
frame in row bands (``trace_wavefront.band_plan``) repeats the labels
band after band: each band starts at a ``primary``, its compactions
hand their lists to depths 1, 2, ...; a capture's ``plan_bands`` gives
the band of each label, its ``bands`` each band's (row offset, rows,
camera rays). While on, each frame leaves a :class:`FrameRecord`
(:func:`frames`) with its plan, ``live_rays`` (the length of the lists
handed to depth d, summed over the bands), ``band_live`` (by band and
depth), ``box_tests`` (the box tests of the traces at depth d, group
and cluster, per listed ray, summed over the bands: the trace kernels'
counter), ``pair_tests`` (the pairs those traces' closest hits ran and
pruned), ``primary_tests`` (the fission primary's box tests, per camera
ray walking, and the pairs its closest hit ran and pruned, summed over
the bands) and ``shadow_tests`` (by depth, 0 the shade over every ray:
the shade kernels' shadow rays' box tests, the pairs their any hits ran
and the shadow rays cast, summed over the bands), read after the frame's
wait. The fission form's kernels add these counters to one int64 buffer
of three words a kernel, in launch order, zeroed once a frame; a capture's
``count_plan`` names the kernel of each entry.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

COUNTS = {"captures": 0, "frame_inputs_built": 0}
FRAMES_KEPT = 4096  # frame records kept, the newest

_frames: collections.deque = collections.deque(maxlen=FRAMES_KEPT)
_last_capture = None
_pending: dict = {}  # set-up steps since the last capture: name -> seconds
_parents: dict = {}  # ... and the set-up span that enclosed each
_open: list = []  # the set-up spans open now, innermost last
_recorder = None  # the _Plan that plan_step records into, or None
_frame_no = 0


def on() -> bool:
    """Whether torch.profiler records now (spans and frame records on)."""
    return _profiler._is_profiler_enabled


class _Off:
    """The span of tracing off: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager: the profiler range ``name`` while tracing is
    on, else nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)


@dataclass
class Capture:
    """One capture of a frame graph: ``index`` (``COUNTS["captures"]`` after
    it), the kernel ``path``, its ``plan``, ``steps`` (seconds of each
    ``cosig.setup.*`` step run for it, and the geometry's of its scene),
    ``parents`` (the set-up span that enclosed a step, or None),
    ``pool_bytes``, ``launches`` (what one replay adds to
    ``binding.LAUNCHES``), ``form``: ``"fission"`` where the wavefront's
    stages are split into trace and shade kernels, else ``"fused"``,
    ``bands``: (row offset, rows, camera rays) of each row band the frame
    renders, one entry for a frame in one band, ``plan_bands``: the band of
    each label of ``plan``, and ``count_plan``: the label of each kernel
    whose counters (three words each) a traced replay reads, in the order
    of their buffer."""

    index: int
    path: str
    plan: tuple
    steps: dict
    parents: dict
    pool_bytes: int = 0
    launches: dict = field(default_factory=dict)
    form: str = "fused"
    bands: tuple = ()
    plan_bands: tuple = ()
    count_plan: tuple = ()


@dataclass
class FrameRecord:
    """One traced frame: its number (the ``cosig.frame`` range's argument),
    its ``plan``, the :class:`Capture` it replayed (None for an eager
    frame), ``live_rays`` {depth: listed rays, summed over the bands},
    ``band_live`` {(band, depth): listed rays}, ``box_tests`` {depth: the
    box tests of the depth's traces, summed over the bands},
    ``pair_tests`` {depth: (pairs run, pairs pruned) by those traces'
    closest hits, summed over the bands}, ``primary_tests`` (box tests,
    pairs run, pairs pruned) of the fission primary's closest hit, summed
    over the bands, and ``shadow_tests`` {depth: (box tests, pairs run,
    shadow rays cast) of the depth's shade kernels' any hits, summed over
    the bands; depth 0 the shade over every ray}."""

    frame: int
    plan: tuple = ()
    capture: Capture | None = None
    live_rays: dict = field(default_factory=dict)
    band_live: dict = field(default_factory=dict)
    box_tests: dict = field(default_factory=dict)
    pair_tests: dict = field(default_factory=dict)
    primary_tests: tuple = ()
    shadow_tests: dict = field(default_factory=dict)


class _Plan:
    """Labels of the kernels launched, in order, the band of each
    (``plan_bands``: every primary stage after the first starts the next band),
    each compaction's list length (a tensor) by the depth it hands the
    list to (``n_live``), and by its band (``live_bands``): the k-th
    compaction after a primary stage hands it to depth k; the counters (an
    int64 [3] tensor) of each kernel that keeps them, by its label
    (``counts``: the fission primary's and the traces'
    ``trace_wavefront.TRACE_COUNTS``, the shades' ``SHADE_COUNTS``)."""

    def __init__(self):
        self.labels, self.plan_bands, self.n_live, self.live_bands = [], [], [], []
        self.counts = []
        self._compactions = 0
        self._band = -1

    def step(self, stage: str, depth: int, n_live, counts=None) -> None:
        if stage == "primary":
            self._compactions = 0
            self._band += 1
        band = max(self._band, 0)
        if stage == "compact":
            self._compactions += 1
            depth = self._compactions
            self.n_live.append((depth, n_live))
            self.live_bands.append(band)
        label = f"{stage}.{depth}" if depth else stage
        if counts is not None:
            self.counts.append((label, counts))
        self.labels.append(label)
        self.plan_bands.append(band)


def plan_step(stage: str, depth: int = 0, n_live=None, counts=None) -> None:
    """A launch wrapper's kernel, for the plan recorded now (a capture's, or
    an eager traced frame's); ``n_live``: a compaction's list length;
    ``counts``: the kernel's counters (the fission primary's, a trace's or a
    shade's)."""
    if _recorder is not None:
        _recorder.step(stage, depth, n_live, counts)


class recording:
    """Record the kernels launched inside into a fresh plan (``as`` it)."""

    def __enter__(self) -> _Plan:
        global _recorder
        self._outer, _recorder = _recorder, _Plan()
        return _recorder

    def __exit__(self, *exc):
        global _recorder
        _recorder = self._outer
        return False


class _Frame:
    """The root span of a traced frame and its record, which the kernels
    launched eagerly inside record their plan into."""

    def __enter__(self) -> _Frame:
        global _frame_no, _recorder
        _frame_no += 1
        self.record = FrameRecord(_frame_no)
        self._plan, self._live, self._tests = _Plan(), None, None
        self._outer, _recorder = _recorder, self._plan
        self._range = _RecordFunctionFast("cosig.frame", [_frame_no])
        self._range.__enter__()
        return self

    def replayed(self, capture: Capture, live, tests=None) -> None:
        """The frame replayed the graph of ``capture``; ``live``: a host
        tensor of its list lengths from depth 1, ``tests``: one of its
        kernels' counters in the order of ``capture.count_plan`` ([kernels,
        3]), each filled before the wait (or None)."""
        self.record.plan, self.record.capture = capture.plan, capture
        self._live, self._tests = live, tests

    def __exit__(self, *exc):
        global _recorder
        self._range.__exit__(*exc)
        _recorder = self._outer
        rec = self.record
        if rec.capture is None:
            rec.plan = tuple(self._plan.labels)
            _live_records(rec, zip(self._plan.live_bands, (d for d, _ in self._plan.n_live)),
                          [int(n.reshape(-1)[0]) for _, n in self._plan.n_live])
            _counts_record(rec, [label for label, _ in self._plan.counts],
                           [t.tolist() for _, t in self._plan.counts])
        else:
            cap = rec.capture
            if self._live is not None:
                keys = [(b, int(label.rpartition(".")[2])) for label, b in
                        zip(cap.plan, cap.plan_bands) if label.startswith("compact.")]
                _live_records(rec, keys, self._live.tolist())
            if self._tests is not None:
                _counts_record(rec, cap.count_plan, self._tests.tolist())
        _frames.append(rec)
        return False


def _live_records(rec: FrameRecord, keys, counts: list) -> None:
    """Fill ``rec``'s ``band_live`` from each compaction's (band, depth)
    ``keys`` and list length ``counts``, and its ``live_rays`` with their
    sums by depth."""
    rec.band_live = dict(zip(keys, counts))
    rec.live_rays = {}
    for (_, depth), n in rec.band_live.items():
        rec.live_rays[depth] = rec.live_rays.get(depth, 0) + n


def _counts_record(rec: FrameRecord, labels, counts: list) -> None:
    """Fill ``rec``'s ``box_tests`` and ``pair_tests`` from each trace's
    counters (box tests, pairs run, pairs pruned), its ``primary_tests``
    from the fission primaries' (the same three) and its ``shadow_tests``
    from the shades' (box tests, pairs run, shadow rays cast), each kernel
    named by its plan label, summed by depth and over the bands."""
    rec.box_tests, rec.pair_tests, rec.shadow_tests = {}, {}, {}
    primary = None
    for label, (tests, run, third) in zip(labels, counts):
        stage, _, tail = label.rpartition(".")
        stage, depth = (stage, int(tail)) if tail.isdigit() else (label, 0)
        if stage == "trace":
            rec.box_tests[depth] = rec.box_tests.get(depth, 0) + tests
            old = rec.pair_tests.get(depth, (0, 0))
            rec.pair_tests[depth] = (old[0] + run, old[1] + third)
        elif stage == "primary":
            primary = [a + b for a, b in zip(primary or (0, 0, 0), (tests, run, third))]
        else:  # "shade_all" (depth 0) or "shade"
            old = rec.shadow_tests.get(depth, (0, 0, 0))
            rec.shadow_tests[depth] = tuple(a + b for a, b in zip(old, (tests, run, third)))
    rec.primary_tests = () if primary is None else tuple(primary)


def frame():
    """The root span ``cosig.frame`` of one frame; ``as`` it, the frame's
    handle while tracing is on, else None."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Frame()


class setup:
    """A set-up span (cold): timed into the record of the next capture
    always (and into its ``seconds``), and a profiler range while tracing
    is on."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _RecordFunctionFast(self.name) if on() else None
        if self._range is not None:
            self._range.__enter__()
        _parents[self.name] = _open[-1] if _open else None
        _open.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = _pending[self.name] = time.perf_counter() - self._t0
        _open.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def pending_setup() -> dict:
    """Seconds of the set-up steps run since the last capture."""
    return dict(_pending)


def captured(path: str, plan: _Plan, pool_bytes: int, launches: dict, form: str,
             bands: tuple) -> Capture:
    """Count a capture and keep its record, which takes the set-up steps
    run since the last one; ``bands``: (row offset, rows, camera rays) of
    each band."""
    global _last_capture
    COUNTS["captures"] += 1
    _last_capture = Capture(COUNTS["captures"], path, tuple(plan.labels), dict(_pending),
                            {k: _parents.get(k) for k in _pending}, pool_bytes, launches, form,
                            tuple(bands), tuple(plan.plan_bands),
                            tuple(label for label, _ in plan.counts))
    _pending.clear()
    return _last_capture


def last_capture() -> Capture | None:
    """The record of the process's last capture, or None."""
    return _last_capture


def frames() -> list:
    """The traced frames' records, oldest first (the newest FRAMES_KEPT)."""
    return list(_frames)


def live_tensor(n_live: list):
    """A plan's counters, its compactions' list lengths (``n_live``, one
    element each) or its kernels' counters (``counts``, three each), as one
    tensor [launches] or [launches, 3] where they are consecutive runs of
    one int32 or int64 buffer, as ``trace_wavefront.stages`` and
    ``banded_frame`` allocate them (a view, read with one copy), else
    None."""
    if not n_live:
        return None
    first = n_live[0][1]
    width = first.numel()
    step = first.element_size() * width
    if first.dtype not in (torch.int32, torch.int64) or any(
            t.dtype != first.dtype or t.numel() != width or not t.is_contiguous()
            or t.untyped_storage().data_ptr() != first.untyped_storage().data_ptr()
            or t.data_ptr() != first.data_ptr() + step * i for i, (_, t) in enumerate(n_live)):
        return None
    if width == 1:
        return first.as_strided((len(n_live),), (1,))
    return first.as_strided((len(n_live), width), (width, 1))
