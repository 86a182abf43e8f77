"""The band readers (``bands_per_frame``, ``band_spread_pct``) on a
made-up trace: two frames, each the port's ``cosig.frame`` span with two
bands of three port kernels, and the capture record of a banded graph;
and on a program that records no bands."""

import collections

import pytest

from benchmark.manifest import reader
from cosig_tpu_torch.utils import trace as port

PLAN = ("primary", "compact.1", "bounce.1") * 2
BANDS = ((0, 1024, 2 ** 23), (1024, 1024, 2 ** 23))
CAPTURE = port.Capture(1, "wavefront", PLAN, {}, {}, 4096, {"graph": 1}, "fused", BANDS,
                       (0, 0, 0, 1, 1, 1))
# Band 0's kernels take 10 + 1 + 19 = 30 us, band 1's 20 + 1 + 29 = 50 us.
ACTS = [("void cosig::primary_kernel<false>", 10, 20), ("cosig::compact_kernel(float const*)",
                                                        21, 22),
        ("void cosig::bounce_kernel<false>", 23, 42), ("Memcpy DtoD", 43, 44),
        ("void cosig::primary_kernel<false>", 45, 65), ("cosig::compact_kernel(float const*)",
                                                        66, 67),
        ("void cosig::bounce_kernel<false>", 68, 97), ("at::native::reduce_kernel", 98, 99)]


def _trace(second=ACTS):
    host, device = [], []
    for t0, acts in ((0.0, ACTS), (110.0, second)):
        host.append(("cosig.frame", t0, t0 + 100))
        device += [(n, t0 + s, t0 + e) for n, s, e in acts]
    return {"frames": 2, "spans": [(0.0, 100.0), (110.0, 210.0)],
            "device": sorted(device, key=lambda a: a[1]), "host": host}


def _read(name, trace):
    return reader(name)({"frames": 10, "window_s": 1.0, "frame_s": [0.1] * 10,
                         "launches": {"graph": 10}, "first_frame_s": 0.5, "trace": trace,
                         "bound": None})


@pytest.fixture
def kept(monkeypatch):
    """The port's newest frame records: the two traced frames."""
    frames = [port.FrameRecord(n, PLAN, CAPTURE, {1: 3000}, {(0, 1): 1000, (1, 1): 2000})
              for n in (1, 2)]
    monkeypatch.setattr(port, "_frames", collections.deque(frames))
    return frames


def test_band_readers(kept):
    assert _read("bands_per_frame", _trace()) == 2.0
    # (50 - 30) / 40 in both frames.
    assert _read("band_spread_pct", _trace()) == pytest.approx(50.0)


def test_a_frame_off_its_plan_is_left_out(kept):
    # The second frame's second band is twice as slow, but it shows a
    # kernel less than its plan: only the first frame counts.
    assert _read("band_spread_pct", _trace(ACTS[:-2])) == pytest.approx(50.0)
    # Equal bands spread by nothing.
    same = ACTS[:4] + [(n, s + 35, e + 35) for n, s, e in ACTS[:3]]
    assert _read("band_spread_pct", _trace(same)) == pytest.approx((50.0 + 0.0) / 2)


def test_band_readers_without_the_programs_bands(monkeypatch):
    """A program whose records have no bands, or that keeps no records,
    gives nothing, and nothing raises."""
    bare = port.Capture(1, "wavefront", PLAN[:3], {}, {}, 4096, {"graph": 1})  # no bands
    monkeypatch.setattr(port, "_frames", collections.deque(
        [port.FrameRecord(n, PLAN[:3], bare, {1: 1000}) for n in (1, 2)]))
    for name in ("bands_per_frame", "band_spread_pct"):
        assert _read(name, _trace()) is None, name
        assert _read(name, None) is None, name
    monkeypatch.setattr(port, "_frames", collections.deque())
    for name in ("bands_per_frame", "band_spread_pct"):
        assert _read(name, _trace()) is None, name
