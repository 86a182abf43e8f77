"""The port's native host builders (``cosig_tpu_torch.native``): the C++
BVH builder and GIF LZW encoder, built by g++ at first use.

Their output is held equal, array for array and byte for byte, to the
port's Python builders and to the JAX package's Python and native ones;
the build is held to survive two processes building at once, and the
``"native"`` mode to raise where the compiler is missing."""

import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import chip_smoke
import cosig_tpu
import cosig_tpu_torch
from cosig_tpu.accel import bvh as jbvh
from cosig_tpu.scene.generate import CONFIGS as JCONFIGS
from cosig_tpu.scene.tessellate import extract_triangles as jextract
from cosig_tpu.utils import gif as jgif
from cosig_tpu_torch.accel import bvh as tbvh
from cosig_tpu_torch.native import bvh_native, gif_native, loader
from cosig_tpu_torch.scene.generate import CONFIGS as TCONFIGS
from cosig_tpu_torch.scene.tessellate import extract_triangles as textract
from cosig_tpu_torch.utils import gif as tgif

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = [*JCONFIGS, "demo_cornell", "tiny"]  # the port-only configs reuse their scenes
BVH_FIELDS = ("node_min", "node_max", "left_or_first", "count", "order")


def _scenes(name):
    """(JAX-built scene, port-built scene)."""
    if name == "tiny":
        from __graft_entry__ import _tiny_scene

        return _tiny_scene(), cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)
    if name == "demo_cornell":
        path = os.path.join(ROOT, "scenes", "demo_cornell.txt")
        return cosig_tpu.load_scene(path), cosig_tpu_torch.load_scene(path)
    return JCONFIGS[name]()[0], TCONFIGS[name]()[0]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", SCENES)
def test_bvh_native_equals_python_and_jax(name):
    """Four builders, one tree: the port's native and Python builders and
    the JAX package's Python and native ones, at the default leaf size and
    at the cluster cut's (64 rows x LEAF_MULT 4)."""
    jscene, tscene = _scenes(name)
    jt, tt = jextract(jscene), textract(tscene)
    for leaf in (4, 256):
        trees = {
            "port native": tbvh.build_bvh(tt, leaf, use_native="native"),
            "port python": tbvh.build_bvh(tt, leaf, use_native="python"),
            "jax python": jbvh.build_bvh(jt, leaf, use_native="python"),
            "jax native": jbvh.build_bvh(jt, leaf, use_native="native"),
        }
        ref = trees.pop("port python")
        assert ref.num_nodes > 1
        for label, tree in trees.items():
            for f in BVH_FIELDS:
                np.testing.assert_array_equal(_bits(getattr(tree, f)), _bits(getattr(ref, f)),
                                              err_msg=f"{name} leaf {leaf}: {label} {f}")
            np.testing.assert_array_equal(tree.triangles.v0, ref.triangles.v0)
    assert loader.loaded()


def test_bvh_empty_soup_in_every_mode():
    tris = textract(_scenes("tiny")[1]).take(np.zeros(0, np.int64))
    for mode in ("auto", "native", "python"):
        b = tbvh.build_bvh(tris, use_native=mode)
        assert b.num_nodes == 1 and b.count[0] == 0 and b.order.shape == (0,)
    with pytest.raises(ValueError, match="use_native"):
        tbvh.build_bvh(tris, use_native="c++")


def _frames():
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:96, 0:128].astype(np.float32)
    smooth = np.stack([x / 128, y / 96, (x + y) / 224], axis=2)
    return {
        "random": rng.integers(0, 256, 96 * 128, dtype=np.uint8).tobytes(),
        "smooth": tgif.quantize(smooth).tobytes(),
        "render": tgif.quantize(rng.random((40, 50, 3), np.float32)).tobytes(),
        "empty": b"",
        "one": b"\x07",
    }


@pytest.mark.parametrize("kind", list(_frames()))
def test_lzw_native_equals_python_and_jax(kind):
    data = _frames()[kind]
    ref = tgif.lzw_compress_py(data)
    assert tgif.lzw_compress(data, use_native="native") == ref
    assert gif_native.compress(data) == ref
    assert tgif.lzw_compress(data) == ref
    assert jgif.lzw_compress_py(data) == ref
    assert jgif.lzw_compress(data) == ref  # the JAX package's native encoder where it loads


def test_gif_bytes_equal_to_jax(tmp_path):
    rng = np.random.default_rng(3)
    frames = [rng.random((24, 32, 3), np.float32) for _ in range(3)]
    tgif.save_gif(frames, str(tmp_path / "t.gif"))
    jgif.save_gif(frames, str(tmp_path / "j.gif"))
    assert (tmp_path / "t.gif").read_bytes() == (tmp_path / "j.gif").read_bytes()


_CHILD = textwrap.dedent(r"""
    import sys
    from cosig_tpu_torch.native import gif_native, loader
    from cosig_tpu_torch.utils.gif import lzw_compress_py
    loader.BUILD_DIR = sys.argv[1]
    data = bytes(range(256)) * 40
    assert gif_native.compress(data) == lzw_compress_py(data)
    print(loader.library_path())
""")


def test_concurrent_first_build(tmp_path):
    """Two processes build the library into one empty directory at once:
    both load a working library, and one library is left, with no
    temporary file beside it."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(paths.pop())]


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """The loader as in a fresh process whose PATH has no C++ compiler."""
    for fn in (bvh_native._fn, gif_native._fn):
        fn.cache_clear()
    monkeypatch.setattr(loader, "CXX", "cosig-no-such-compiler")
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_error", None)
    yield
    for fn in (bvh_native._fn, gif_native._fn):
        fn.cache_clear()


def test_native_raises_without_compiler(no_compiler, caplog):
    """``"native"`` raises; ``"auto"`` falls back to the Python builders,
    with one warning for the whole process."""
    tris = textract(_scenes("tiny")[1])
    data = _frames()["smooth"]
    with caplog.at_level(logging.WARNING, logger="cosig_tpu_torch.native"):
        with pytest.raises(loader.NativeError, match="not found"):
            tbvh.build_bvh(tris, use_native="native")
        with pytest.raises(loader.NativeError, match="not found"):
            tgif.lzw_compress(data, use_native="native")
        auto = tbvh.build_bvh(tris)
        assert tgif.lzw_compress(data) == tgif.lzw_compress_py(data)
    ref = tbvh.build_bvh(tris, use_native="python")
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(auto, f), getattr(ref, f))
    assert not loader.loaded()
    assert len([r for r in caplog.records if "unavailable" in r.getMessage()]) == 1
