"""BENCHMARK.json against the benchmark's contract: shapes, names, units,
and every name resolving to its file."""

import json
import os
import re

import pytest

from benchmark import manifest
from benchmark.manifest import ROOT, Cell, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.manifest()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["command"]) <= 32
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_allowed_characters(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(names) == len(set(names))
    for e in bench[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_cells_reference_known_entries(bench):
    configs = {c["name"] for c in bench["configs"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert configs == {w["config"] for w in bench["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        # Each cell that reports a per-layer metric reports what it moves.
        moved = [e for e in bench["end_to_end"] if e["name"] == m["moves"]][0]
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.manifest()["workloads"]])
def test_every_name_resolves_to_its_file(cell):
    c = Cell(cell)
    assert os.path.exists(c.scene_path())  # and its sha256 is the configuration's
    assert c.traffic["name"] == c.traffic_name
    assert c.config["name"] == c.config_name
    assert c.limits and all("limit" in v for v in c.limits.values())
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(reader(m["name"]))


def test_config_files_lie_under_paths(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in bench["paths"])
        with open(os.path.join(ROOT, f)) as fh:
            json.load(fh)
