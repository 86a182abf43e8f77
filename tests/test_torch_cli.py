"""The port's application layer on the CPU: the CLI's subcommands
(tests/test_cli.py's cases, with ``--device cpu`` on in-repo scenes), the
chunked render and its resume, and the PNG, GIF and preset writers byte
for byte against the JAX package's."""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

import cosig_tpu_torch
from cosig_tpu_torch.cli import main
from cosig_tpu_torch.render import renderer as renderer_mod
from cosig_tpu_torch.utils import gif as tgif
from cosig_tpu_torch.utils import png as tpng

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORNELL = str(ROOT / "scenes" / "demo_cornell.txt")
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these frames are small, and the suite runs
    several test processes at once, where torch's thread pools would
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _render(backend, scene_arg, **kw):
    """The Renderer's frame for a scene argument as the CLI loads it."""
    if scene_arg.startswith("generated:"):
        from cosig_tpu_torch.scene.generate import CONFIGS

        scene, st = CONFIGS[scene_arg.split(":", 1)[1]]()
    else:
        scene, st = cosig_tpu_torch.load_scene(scene_arg), cosig_tpu_torch.RenderSettings()
    return cosig_tpu_torch.Renderer(device="cpu", backend=backend).render(scene, st.replace(**kw))


def test_render_command(tmp_path, capsys):
    out = str(tmp_path / "r.png")
    rc = main(["render", CORNELL, "-o", out, "--backend", "xla", "--width", "32", "--height", "24",
               "--depth", "1", *CPU])
    assert rc == 0
    img = tpng.read_png(out)
    assert img.shape == (24, 32, 3)
    assert "rendered 32x24 (788 tris)" in capsys.readouterr().out
    ref = _render("xla", CORNELL, resolution_override=(32, 24), max_depth=1)
    np.testing.assert_array_equal(img, tpng.to_uint8(ref))


def test_render_generated_config(tmp_path):
    out = str(tmp_path / "g.png")
    rc = main(["render", "generated:diffuse_sphere", "-o", out, "--backend", "xla",
               "--width", "24", "--height", "24", *CPU])
    assert rc == 0
    assert tpng.read_png(out).shape == (24, 24, 3)


@pytest.mark.parametrize("backend,runs", [("auto", "xla"), ("xla-brute", "xla-brute"),
                                          ("wavefront", "wavefront"), ("megakernel", "megakernel"),
                                          ("pallas", "megakernel")])
def test_render_backends(tmp_path, capsys, backend, runs):
    """Every --backend choice renders the Renderer's frame byte for byte;
    "pallas" is the JAX package's name of the megakernel, "auto" is the
    oracle path on the CPU."""
    out = str(tmp_path / "b.png")
    rc = main(["render", "generated:glass_sphere", "-o", out, "--backend", backend,
               "--width", "20", "--height", "14", "--depth", "3", *CPU])
    assert rc == 0
    assert f"[{runs} on cpu]" in capsys.readouterr().out
    ref = _render(runs, "generated:glass_sphere", resolution_override=(20, 14), max_depth=3)
    np.testing.assert_array_equal(tpng.read_png(out), tpng.to_uint8(ref))


def test_info_command(capsys):
    assert main(["info", CORNELL]) == 0
    out = capsys.readouterr().out
    assert "tessellated triangles: 788" in out
    assert "BVH: 505 nodes, depth 14" in out
    assert main(["info", "generated:large_mesh"]) == 0
    assert "tessellated triangles: 11970" in capsys.readouterr().out


def test_compare_command(tmp_path, capsys):
    rng = np.random.default_rng(0)
    a = rng.random((16, 16, 3)).astype(np.float32)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    tpng.write_png(pa, a)
    tpng.write_png(pb, a)
    assert main(["compare", pa, pb, "--threshold", "0.001"]) == 0
    assert json.loads(capsys.readouterr().out.strip())["rmse"] == 0.0
    tpng.write_png(pb, 1.0 - a)
    assert main(["compare", pa, pb, "--threshold", "0.001"]) == 1


def test_turntable_command(tmp_path):
    out = str(tmp_path / "t.gif")
    rc = main(["turntable", CORNELL, "-o", out, "--backend", "xla", "--width", "16",
               "--height", "16", "--depth", "1", "--steps", "4", *CPU])
    assert rc == 0
    assert tgif.decode_gif_frame_count(out) == 4


def test_preset_commands(tmp_path, capsys):
    path = str(tmp_path / "p.json")
    assert main(["preset", "save", path, "--scene", "/x.txt", "--name", "t1"]) == 0
    assert main(["preset", "load", path]) == 0
    out = capsys.readouterr().out
    assert "t1" in out
    # A preset's settings drive a render.
    png = str(tmp_path / "p.png")
    assert main(["render", CORNELL, "-o", png, "--preset", path, "--width", "12", "--height", "8",
                 "--backend", "xla", *CPU]) == 0
    assert tpng.read_png(png).shape == (8, 12, 3)


def test_render_chunked_command(tmp_path):
    out = str(tmp_path / "c.png")
    ck = str(tmp_path / "ck.npz")
    rc = main(["render", CORNELL, "-o", out, "--backend", "xla", "--width", "24", "--height", "30",
               "--depth", "1", "--chunk-rows", "8", "--checkpoint", ck, *CPU])
    assert rc == 0
    assert tpng.read_png(out).shape == (30, 24, 3)
    assert not os.path.exists(ck)  # removed on completion


class _Stop(Exception):
    pass


def test_chunked_render_resumes_bit_equal(tmp_path):
    """Interrupted after its first band, then resumed from the checkpoint:
    the frame equals the unchunked "xla" render bit for bit, through the
    Renderer and through the CLI."""
    scene = cosig_tpu_torch.load_scene(CORNELL)
    st = cosig_tpu_torch.RenderSettings(resolution_override=(20, 30), max_depth=3, aa_samples=2)
    full = cosig_tpu_torch.Renderer(device="cpu", backend="xla").render(scene, st)
    ck = str(tmp_path / "ck.npz")

    def stop(frac):
        raise _Stop

    r = cosig_tpu_torch.Renderer(device="cpu", backend="xla")
    with pytest.raises(_Stop):
        r.render_chunked(scene, st, rows_per_chunk=8, checkpoint=ck, progress=stop)
    saved = np.load(ck)
    assert int(saved["done_rows"]) == 8 and not saved["img"][8:].any()
    seen = []
    img = r.render_chunked(scene, st, rows_per_chunk=8, checkpoint=ck, progress=seen.append)
    assert seen == [16 / 30, 24 / 30, 1.0]  # the first band was not rendered again
    np.testing.assert_array_equal(img, full)
    assert not os.path.exists(ck)
    # The CLI resumes the same checkpoint and writes the same PNG.
    with pytest.raises(_Stop):
        r.render_chunked(scene, st, rows_per_chunk=8, checkpoint=ck, progress=stop)
    out = str(tmp_path / "resumed.png")
    assert main(["render", CORNELL, "-o", out, "--backend", "xla", "--width", "20",
                 "--height", "30", "--depth", "3", "--aa", "2", "--chunk-rows", "8",
                 "--checkpoint", ck, *CPU]) == 0
    np.testing.assert_array_equal(tpng.read_png(out), tpng.to_uint8(full))
    # A checkpoint of another frame size is not resumed.
    with pytest.raises(_Stop):
        r.render_chunked(scene, st, rows_per_chunk=8, checkpoint=ck, progress=stop)
    other = r.render_chunked(scene, st.replace(resolution_override=(20, 12)), rows_per_chunk=8,
                             checkpoint=ck)
    assert other.shape == (12, 20, 3) and other.all(axis=2).any()


def test_preview_zero_readback(monkeypatch, capsys):
    """The realtime contract (RayTracer.cs:76-82): no frame is read back
    inside the loop. ``Renderer.render`` is the readback path, so it must
    not run; every frame goes through ``render_to_device``."""
    calls = {"to_device": 0}
    orig = renderer_mod.Renderer.render_to_device

    def counting(self, scene, settings):
        calls["to_device"] += 1
        img = orig(self, scene, settings)
        assert isinstance(img, torch.Tensor)
        return img

    def forbidden(self, scene, settings):
        raise AssertionError("preview loop performed a per-frame readback")

    monkeypatch.setattr(renderer_mod.Renderer, "render_to_device", counting)
    monkeypatch.setattr(renderer_mod.Renderer, "render", forbidden)
    rc = main(["preview", "generated:diffuse_sphere", "--backend", "xla", "--width", "16",
               "--height", "16", "--frames", "3", "--orbit", "15", *CPU])
    assert rc == 0
    assert calls["to_device"] == 3
    assert "FPS avg" in capsys.readouterr().out


def test_preview_save_dir_after_loop(tmp_path):
    rc = main(["preview", "generated:diffuse_sphere", "--backend", "wavefront", "--width", "16",
               "--height", "16", "--frames", "2", "--save-dir", str(tmp_path), *CPU])
    assert rc == 0
    assert tpng.read_png(str(tmp_path / "frame_0000.png")).shape == (16, 16, 3)
    assert tpng.read_png(str(tmp_path / "frame_0001.png")).shape == (16, 16, 3)


def test_profile_writes_a_chrome_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    rc = main(["render", CORNELL, "-o", str(tmp_path / "p.png"), "--width", "8", "--height", "8",
               "--depth", "1", "--profile", str(prof), *CPU])
    assert rc == 0
    trace = json.loads((prof / "render_trace.json").read_text())
    assert trace["traceEvents"]
    assert "profiler trace ->" in capsys.readouterr().out
    # The port's own steps: the oracle path's frame on the CPU, and its set-up.
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"cosig.frame", "cosig.frame.settings", "cosig.frame.launch", "cosig.frame.wait",
            "cosig.setup.geometry"} <= names


@pytest.mark.parametrize("cmd", ["render", "turntable", "preview"])
def test_device_cuda_without_gpu_exits_nonzero(monkeypatch, tmp_path, capsys, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main([cmd, CORNELL, "-o", str(tmp_path / "x.out"), "--device", "cuda"])
    assert rc != 0
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "x.out").exists()


# ---------------------------------------------------------------------------
# Output bytes against the JAX package's writers


def test_png_bytes_equal_to_jax(tmp_path):
    from cosig_tpu.utils import png as jpng

    r = np.random.default_rng(7)
    for i, img in enumerate([r.random((13, 17, 3)).astype(np.float32) * 1.2 - 0.1,
                             r.integers(0, 256, (9, 5, 4)).astype(np.uint8),
                             r.random((6, 4)).astype(np.float32)]):
        a, b = tmp_path / f"t{i}.png", tmp_path / f"j{i}.png"
        tpng.write_png(str(a), img)
        jpng.write_png(str(b), img)
        assert a.read_bytes() == b.read_bytes()
        np.testing.assert_array_equal(tpng.read_png(str(a)), jpng.read_png(str(b)))
    np.testing.assert_array_equal(tpng.to_uint8(img), jpng.to_uint8(img))


def test_gif_bytes_equal_to_jax(tmp_path, monkeypatch):
    from cosig_tpu.utils import gif as jgif

    monkeypatch.setattr(jgif, "lzw_compress", jgif.lzw_compress_py)
    r = np.random.default_rng(8)
    frames = [r.random((11, 23, 3)).astype(np.float32) for _ in range(3)]
    frames.append(np.zeros((11, 23, 3), np.float32))
    a, b = tmp_path / "t.gif", tmp_path / "j.gif"
    tgif.save_gif(frames, str(a), delay_cs=7)
    jgif.save_gif(frames, str(b), delay_cs=7)
    assert a.read_bytes() == b.read_bytes()
    assert tgif.decode_gif_frame_count(str(a)) == 4
    assert tgif.color_table() == jgif.color_table()
    for data in (b"", bytes(range(256)) * 40, r.integers(0, 216, 5000).astype(np.uint8).tobytes()):
        assert tgif.lzw_compress(data) == jgif.lzw_compress_py(data)


def test_preset_bytes_equal_to_jax(tmp_path):
    import cosig_tpu
    from cosig_tpu.models.preset import ScenePreset as JPreset

    kw = dict(resolution_override=(320, 200), background_color_override=(0.1, 0.2, 0.3),
              camera_rotation_override=(5.0, 0.0, 10.0), max_depth=5, is_orthographic=True)
    tp = cosig_tpu_torch.ScenePreset.from_render_settings(
        cosig_tpu_torch.RenderSettings(**kw), scene_file_path="s.txt")
    jp = JPreset.from_render_settings(cosig_tpu.RenderSettings(**kw), scene_file_path="s.txt")
    tp.SavedAt = jp.SavedAt = "2026-01-01 00:00:00"
    tp.AASamples = jp.AASamples = 4
    tp.ShadowMode = jp.ShadowMode = 2
    a, b = tmp_path / "t.json", tmp_path / "j.json"
    tp.save(str(a))
    jp.save(str(b))
    assert a.read_bytes() == b.read_bytes()
    back = cosig_tpu_torch.ScenePreset.load(str(b)).to_render_settings()
    want = JPreset.load(str(a)).to_render_settings()
    assert {k: getattr(back, k) for k in vars(want)} == vars(want)
