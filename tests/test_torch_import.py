"""The PyTorch port stands apart from JAX: importing and rendering with it
loads no jax and nothing of the JAX package, and a CUDA renderer without a
GPU refuses to start."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHILD = r"""
import sys
import numpy as np
import torch
import cosig_tpu_torch
import cosig_tpu_torch.kernels.binding
import cosig_tpu_torch.kernels.build
import cosig_tpu_torch.kernels.wavefront
import cosig_tpu_torch.kernels.megakernel
import cosig_tpu_torch.ops.trace_megakernel
import cosig_tpu_torch.ops.trace_xla
import cosig_tpu_torch.ops.bvh_traverse
import cosig_tpu_torch.scene.generate
import cosig_tpu_torch.utils.gif
import cosig_tpu_torch.cli
import cosig_tpu_torch.parallel.sharding
import cosig_tpu_torch.native.loader
import cosig_tpu_torch.native.bvh_native
import cosig_tpu_torch.native.gif_native
import chip_smoke
import tempfile, os

scene = cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)
st = cosig_tpu_torch.RenderSettings(resolution_override=(16, 12), max_depth=2, aa_samples=2)
r = cosig_tpu_torch.Renderer(device="cpu")
img = r.render(scene, st)
assert img.shape == (12, 16, 3) and np.isfinite(img).all(), img.shape
assert img.max() > 0.0
for backend in ("wavefront", "megakernel"):
    m = cosig_tpu_torch.Renderer(device="cpu", backend=backend)
    a = m.render(scene, st.replace(analytic_primitives=True, debug_mode=2))
    assert a.shape == (12, 16, 3) and np.isfinite(a).all()
x = cosig_tpu_torch.Renderer(device="cpu", backend="xla")
xi = x.render(scene, st)
assert xi.shape == (12, 16, 3) and np.isfinite(xi).all() and x.last_stats.rays_traced >= 16 * 12
with tempfile.TemporaryDirectory() as tmp:
    out = os.path.join(tmp, "cli.png")
    rc = cosig_tpu_torch.cli.main(["render", "generated:large_mesh", "-o", out, "--width", "12",
                                   "--height", "8", "--depth", "2", "--device", "cpu"])
    assert rc == 0 and os.path.getsize(out) > 0
from cosig_tpu_torch.parallel import sharding
from cosig_tpu_torch.native import loader
cset, prims, counts = m._geometry_for(scene)
sst = st.replace(analytic_primitives=False, debug_mode=0)
from cosig_tpu_torch.models.soa import frame_params, static_config
from cosig_tpu_torch.ops import kernel_core
params, cfg = frame_params(scene, sst), static_config(scene, sst)
simg, srays = sharding.render_sharded_megakernel(
    cset, kernel_core.build_uniforms(params), kernel_core.build_lights(params, cfg.multi_light),
    cfg, sharding.make_mesh(devices=["cpu"] * 2))
assert simg.shape == (12, 16, 3) and srays >= 16 * 12 * 2
from cosig_tpu_torch.accel.bvh import build_bvh
from cosig_tpu_torch.scene.tessellate import extract_triangles
assert build_bvh(extract_triangles(scene), use_native="native").num_nodes > 1
assert loader.loaded()
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not loaded, loaded
jax_pkg = sorted(m for m in sys.modules
                 if m in ("cosig_tpu", "__graft_entry__") or m.startswith("cosig_tpu."))
assert not jax_pkg, jax_pkg
if not torch.cuda.is_available():
    try:
        cosig_tpu_torch.Renderer(device="cuda")
    except RuntimeError:
        pass
    else:
        raise AssertionError("Renderer(device='cuda') started without a GPU")
print("OK", r.last_stats.rays_traced)
"""


def test_port_imports_and_renders_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.splitlines()[-1]  # the CLI prints its own lines first
    assert last.startswith("OK "), out.stdout
    assert int(last.split()[1]) >= 16 * 12 * 2


# jax itself, any module of the JAX package (cosig_tpu, cosig_tpu.*) and
# the JAX package's entry module: the port keeps its own copies of what it
# needs from them.
_JAX_MODULES = re.compile(
    r"^\s*(import|from)\s+(jax\b|jaxlib\b|cosig_tpu\b|__graft_entry__\b)",
    re.MULTILINE,
)


def test_port_sources_import_no_jax_module():
    files = sorted((ROOT / "cosig_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    names = {p.relative_to(ROOT / "cosig_tpu_torch").as_posix() for p in files[:-1]}
    assert {"parallel/sharding.py", "native/loader.py", "native/bvh_native.py",
            "native/gif_native.py"} <= names
    for path in files:
        src = path.read_text()
        m = _JAX_MODULES.search(src)
        assert m is None, f"{path.relative_to(ROOT)} imports {m.group(0).strip()}"
    for bad in ("import cosig_tpu.ops", "from cosig_tpu.scene import parser",
                "    from __graft_entry__ import _tiny_scene", "import jax.numpy as jnp"):
        assert _JAX_MODULES.search(bad), bad
    assert not _JAX_MODULES.search("from cosig_tpu_torch.ops import kernel_core")


def test_native_sources_are_the_ports_own():
    """The C++ host builders are the port's copies, built from its own
    directory: they name no file of the JAX package's native module."""
    sources = sorted((ROOT / "cosig_tpu_torch" / "native" / "src").glob("*.cc"))
    assert [p.name for p in sources] == ["bvh.cc", "gif_lzw.cc"]
    for path in sources + sorted((ROOT / "cosig_tpu_torch" / "native").glob("*.py")):
        text = path.read_text()
        assert "cosig_tpu/native" not in text and "cosig_tpu/" not in text.replace(
            "cosig_tpu_torch/", ""), path.name


def test_cuda_renderer_raises_without_gpu(monkeypatch):
    import cosig_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cosig_tpu_torch.Renderer(device="cuda")


@pytest.mark.parametrize("device", ["meta", "mps"])
def test_renderer_rejects_other_devices(device):
    import cosig_tpu_torch

    with pytest.raises(ValueError, match="unsupported device"):
        cosig_tpu_torch.Renderer(device=device)


def test_xdist_workers_do_not_oversubscribe_the_cpus():
    """Under pytest-xdist the workers' torch pools together fit the CPUs (the root
    conftest.py gives each worker its share); run alone, torch keeps its default pool."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    cpus = len(os.sched_getaffinity(0))
    assert torch.get_num_threads() * workers <= max(cpus, workers), (
        torch.get_num_threads(), workers, cpus)
