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
* ``cosig.frame.settings``: ``frame_params``, ``static_config``, the
  graph key;
* ``cosig.frame.uniforms``: ``build_uniforms``, ``build_lights``;
* ``cosig.frame.lookup``: the geometry and graph caches;
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
``captures``, one per graph capture, always. A capture's ``plan``: the
ordered labels of the port's kernels its frame launches, recorded by the
launch wrappers (:func:`plan_step`): ``primary``, then ``compact.1``,
``bounce.1``, ... (fused) or ``shade_all``, ``compact.1``, ``trace.1``,
``shade.1``, ... (fission), ``megakernel``, ``debug``. The k-th
``cosig::`` kernel of a traced frame on the card is the plan's k-th.
While on, each frame leaves a :class:`FrameRecord` (:func:`frames`) with
its plan and ``live_rays``: the length of the list each compaction hands
to depth d, read after the frame's wait.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

COUNTS = {"captures": 0}
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
    ``pool_bytes`` and ``launches`` (what one replay adds to
    ``binding.LAUNCHES``)."""

    index: int
    path: str
    plan: tuple
    steps: dict
    parents: dict
    pool_bytes: int = 0
    launches: dict = field(default_factory=dict)


@dataclass
class FrameRecord:
    """One traced frame: its number (the ``cosig.frame`` range's argument),
    its ``plan``, the :class:`Capture` it replayed (None for an eager
    frame) and ``live_rays`` {depth: listed rays}."""

    frame: int
    plan: tuple = ()
    capture: Capture | None = None
    live_rays: dict = field(default_factory=dict)


class _Plan:
    """Labels of the kernels launched, in order, and each compaction's
    list length (a tensor) by the depth it hands the list to: the k-th
    compaction after a primary stage hands it to depth k."""

    def __init__(self):
        self.labels, self.n_live = [], []
        self._compactions = 0

    def step(self, stage: str, depth: int, n_live) -> None:
        if stage == "primary":
            self._compactions = 0
        if stage == "compact":
            self._compactions += 1
            depth = self._compactions
            self.n_live.append((depth, n_live))
        self.labels.append(f"{stage}.{depth}" if depth else stage)


def plan_step(stage: str, depth: int = 0, n_live=None) -> None:
    """A launch wrapper's kernel, for the plan recorded now (a capture's, or
    an eager traced frame's); ``n_live``: a compaction's list length."""
    if _recorder is not None:
        _recorder.step(stage, depth, n_live)


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
        self._plan, self._live = _Plan(), None
        self._outer, _recorder = _recorder, self._plan
        self._range = _RecordFunctionFast("cosig.frame", [_frame_no])
        self._range.__enter__()
        return self

    def replayed(self, capture: Capture, live) -> None:
        """The frame replayed the graph of ``capture``; ``live``: a host
        tensor of its list lengths from depth 1, filled before the wait
        (or None)."""
        self.record.plan, self.record.capture, self._live = capture.plan, capture, live

    def __exit__(self, *exc):
        global _recorder
        self._range.__exit__(*exc)
        _recorder = self._outer
        rec = self.record
        if rec.capture is None:
            rec.plan = tuple(self._plan.labels)
            rec.live_rays = {d: int(n.reshape(-1)[0]) for d, n in self._plan.n_live}
        elif self._live is not None:
            rec.live_rays = dict(enumerate(self._live.tolist(), 1))
        _frames.append(rec)
        return False


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


def captured(path: str, plan: _Plan, pool_bytes: int, launches: dict) -> Capture:
    """Count a capture and keep its record, which takes the set-up steps
    run since the last one."""
    global _last_capture
    COUNTS["captures"] += 1
    _last_capture = Capture(COUNTS["captures"], path, tuple(plan.labels), dict(_pending),
                            {k: _parents.get(k) for k in _pending}, pool_bytes, launches)
    _pending.clear()
    return _last_capture


def last_capture() -> Capture | None:
    """The record of the process's last capture, or None."""
    return _last_capture


def frames() -> list:
    """The traced frames' records, oldest first (the newest FRAMES_KEPT)."""
    return list(_frames)


def live_tensor(n_live: list):
    """A plan's list lengths as one int32 tensor [depths] where they are
    consecutive elements of one buffer, as ``trace_wavefront.stages``
    allocates them (a view, read with one copy), else None."""
    if not n_live or [d for d, _ in n_live] != list(range(1, len(n_live) + 1)):
        return None
    first = n_live[0][1]
    if first.dtype != torch.int32 or any(
            t.untyped_storage().data_ptr() != first.untyped_storage().data_ptr()
            or t.data_ptr() != first.data_ptr() + 4 * i for i, (_, t) in enumerate(n_live)):
        return None
    return first.as_strided((len(n_live),), (1,))
