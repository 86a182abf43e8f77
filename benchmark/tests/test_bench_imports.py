"""The import guard: nothing a run loads is JAX or the JAX package, and
the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import run
from benchmark.manifest import BENCH_DIR, ROOT


def test_guard_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cosig_tpu_torch_fake.sub", object())
    assert "cosig_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cosig_tpu.ops.fake", object())
    assert run.forbidden_modules() == ["cosig_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH_DIR, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert not tops & {"cosig_tpu_torch", "cosig_tpu", "jax", "jaxlib", "__graft_entry__"}, name


def test_what_a_run_loads_holds_no_jax():
    """A run's modules, the port's renderer and kernels' wrappers
    included, in a fresh interpreter: the guard finds nothing, and the
    reference alone loads nothing of the port."""
    code = (
        "import sys\n"
        "import benchmark.reference.trace, benchmark.reference.bvh, benchmark.check\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'cosig_tpu_torch'], 'ref'\n"
        "from benchmark import run, control, timeline, peaks, orbit\n"
        "from benchmark.manifest import reader, manifest\n"
        "[reader(m['name']) for m in manifest()['per_layer']]\n"
        "import cosig_tpu_torch.render.renderer, cosig_tpu_torch.kernels.wavefront\n"
        "import cosig_tpu_torch.kernels.megakernel, cosig_tpu_torch.ops.frame_graph\n"
        "print(run.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
