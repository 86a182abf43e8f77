"""Runs of the harness itself on the card: each cell for a short window,
untraced and traced. On the card: ``python -m pytest benchmark/tests -m gpu``."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import manifest
from benchmark.manifest import ROOT

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                          "--seed", str(2**31 + 101 + trace), "--seconds", "2",
                          "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    bench = manifest.manifest()
    want = bench["per_layer"] if trace else bench["end_to_end"]
    assert set(result["metrics"]) == {m["name"] for m in want
                                      if cell in m.get("workloads", [cell])}
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        # A roofline share under its own name or a cell's (``<base>.<cells>``).
        shares = [v["value"] for k, v in result["metrics"].items()
                  if k.split(".")[0].endswith("_roofline")]
        assert shares and all(0 < v <= 100 for v in shares)
