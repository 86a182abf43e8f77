"""``BENCHMARK.json`` and the files it names.

The harness is driven by data: a cell (an entry of ``workloads``) names
a configuration and a traffic mix, and each is found by its name:
``benchmark/configs/<config>.json`` (with the scene file it names),
``benchmark/traffic/<traffic>.json``, ``benchmark/limits/<cell>.json``
(the limits of the numbers that decide ``correct``) and, for each
per-layer metric, ``benchmark/metrics/<metric>.py``, a reader of the
run's records. A metric named ``<base>.<cells>`` (one quantity split by
the end-to-end metric it moves in those cells) is read by ``<base>.py``
where it has no file of its own. A later cell, mix or metric comes with files and entries
of its own; no file here needs an edit.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmark")


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def sha256_of(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix, limits and the metrics it reports."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = manifest() if bench is None else bench
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec = found[0]
        self.name = name
        self.chips = int(self.spec["chips"])
        self.config_name = self.spec["config"]
        self.traffic_name = self.spec["traffic"]
        entry = [c for c in bench["configs"] if c["name"] == self.config_name][0]
        self.config = _json(os.path.join(ROOT, entry["file"]))
        self.traffic = _json(os.path.join(BENCH_DIR, "traffic", f"{self.traffic_name}.json"))
        self.limits = _json(os.path.join(BENCH_DIR, "limits", f"{name}.json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def scene_path(self) -> str:
        """The configuration's scene file, after its sha256 is checked
        against the one the configuration records."""
        path = os.path.join(ROOT, self.config["scene_file"])
        digest = sha256_of(path)
        if digest != self.config["scene_sha256"]:
            raise ValueError(f"{path}: sha256 {digest} is not the configuration's "
                             f"{self.config['scene_sha256']}")
        return path


def reader(metric: str):
    """The ``read(records) -> float | None`` of ``benchmark/metrics/<metric>.py``,
    or of ``<base>.py`` for a metric ``<base>.<cells>`` with no file of its own."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(BENCH_DIR, "metrics", f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
