"""The per-layer readers on a made-up trace: two frames, each a copy in,
two kernels and a copy out, with idle stretches between."""

import pytest

from benchmark import timeline
from benchmark.manifest import manifest, reader

TRACE = {
    "frames": 2,
    "spans": [(0.0, 100.0), (110.0, 210.0)],
    "device": [("Memcpy HtoD", 10.0, 12.0), ("cosig::primary_kernel", 14.0, 60.0),
               ("cosig::bounce_kernel", 62.0, 90.0), ("Memcpy DtoH", 92.0, 94.0),
               ("Memcpy HtoD", 130.0, 132.0), ("cosig::primary_kernel", 134.0, 180.0),
               ("cosig::bounce_kernel", 182.0, 200.0), ("Memcpy DtoH", 202.0, 204.0)],
    "host": [("cudaGraphLaunch", 12.5, 13.5), ("aten::copy_", 105.0, 129.0)],
}
RECORDS = {"frames": 10, "window_s": 1.0, "frame_s": [0.1] * 10,
           "launches": {"primary": 10, "compact": 30, "bounce": 30, "graph": 10},
           "first_frame_s": 0.5, "trace": TRACE,
           "bound": {"bound_ms": 0.0138, "ops": 0, "bytes": 0, "bound_by": "operations"}}


def read(name, records=RECORDS):
    return reader(name)(records)


def test_readers():
    assert read("first_frame_ms") == 500.0
    assert read("launches_per_frame") == 8.0
    assert read("host_gap_ms") == pytest.approx((130.0 - 94.0) / 1e3)
    assert read("kernel_ms_per_frame") == pytest.approx((46 + 28 + 46 + 18) / 2 / 1e3)
    assert read("kernels_roofline") == pytest.approx(100 * 0.0138 / 0.069)
    busy = 2 + 46 + 28 + 2 + 2 + 46 + 18 + 2
    assert read("device_idle_pct") == pytest.approx(100 * (1 - busy / 210.0))


def test_readers_return_nothing_without_their_inputs():
    bare = dict(RECORDS, trace=None, bound=None, launches={"primary": 0})
    for m in manifest()["per_layer"]:
        if m["name"] != "first_frame_ms":
            assert read(m["name"], bare) is None, m["name"]


def test_idle_gaps_name_the_host():
    gaps = dict(timeline.top(timeline.idle_gaps(TRACE)))
    assert gaps["aten::copy_"] == pytest.approx(36e-6)  # the gap 94..130, its middle 112
    assert set(gaps) <= {"aten::copy_", "cudaGraphLaunch", "host: Python in render_to_device",
                         "host: between frames"}
