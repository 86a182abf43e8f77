"""Command-line application layer of the PyTorch + CUDA port.

Counterpart of :mod:`cosig_tpu.cli` (``cli.py:30-335``), with the same
subcommands and flags:

* ``render``    — render a scene file (or ``generated:<config>``) to PNG,
  optionally in resumable row bands (``--chunk-rows``, ``--checkpoint``)
* ``turntable`` — rotating-camera animated GIF
* ``preview``   — realtime loop with a frames/s readout and no readback
  of a frame inside the loop
* ``compare``   — RMSE/PSNR between two PNGs
* ``info``      — parsed-scene summary and BVH statistics
* ``preset``    — save/load JSON presets (the reference's schema)

Beyond the JAX package's flags: ``--device cuda|cpu`` (default ``cuda``;
without a GPU, ``cuda`` exits non-zero), and ``--backend`` takes the
port's renderer backends (``auto``, ``xla``, ``xla-brute``, ``wavefront``,
``megakernel``) and ``pallas``, the JAX package's name of the megakernel,
so that package's commands run unchanged. ``--profile DIR`` records the
render with ``torch.profiler`` (CUDA activity on the card) and writes a
Chrome trace into DIR.

    python -m cosig_tpu_torch.cli render scenes/demo_cornell.txt -o out.png --device cuda
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

BACKENDS = ["auto", "xla", "xla-brute", "wavefront", "megakernel", "pallas"]


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("scene", help="scene .txt path, or generated:<config-name>")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda launches the kernels; cpu runs their plain PyTorch versions")
    p.add_argument("--backend", default="auto", choices=BACKENDS,
                   help="auto: wavefront on cuda, xla on cpu; pallas = megakernel")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--depth", type=int, default=None, help="max bounce depth")
    p.add_argument("--aa", type=int, default=None)
    p.add_argument("--fov", type=float)
    p.add_argument("--intensity", type=float, default=None)
    p.add_argument("--background", type=float, nargs=3, metavar=("R", "G", "B"))
    p.add_argument("--camera-pos", type=float, nargs=3, metavar=("X", "Y", "Z"))
    p.add_argument("--camera-rot", type=float, nargs=3, metavar=("RX", "RY", "RZ"))
    p.add_argument("--ortho", action="store_true")
    p.add_argument("--no-ambient", action="store_true")
    p.add_argument("--no-diffuse", action="store_true")
    p.add_argument("--no-specular", action="store_true")
    p.add_argument("--no-refraction", action="store_true")
    p.add_argument("--soft-shadows", type=float, metavar="LIGHT_SIZE")
    p.add_argument("--glossy", type=float, metavar="ROUGHNESS")
    p.add_argument("--motion-blur", type=float, metavar="SHUTTER")
    p.add_argument("--multi-light", action="store_true")
    p.add_argument("--analytic", action="store_true",
                   help="analytic sphere/box intersection instead of tessellation")
    p.add_argument("--debug-mode", type=int, default=0, choices=[0, 1, 2, 3])
    p.add_argument("--preset", help="load settings from a preset JSON first")
    p.add_argument("--profile", metavar="DIR",
                   help="record the render with torch.profiler; write a Chrome trace into DIR")


def _load_scene_arg(arg: str):
    from cosig_tpu_torch.models.settings import RenderSettings
    from cosig_tpu_torch.scene.parser import load_scene

    if arg.startswith("generated:"):
        from cosig_tpu_torch.scene.generate import CONFIGS

        return CONFIGS[arg.split(":", 1)[1]]()
    return load_scene(arg), RenderSettings()


def _settings_from_args(args, base):
    s = base
    if args.preset:
        from cosig_tpu_torch.models.preset import ScenePreset

        s = ScenePreset.load(args.preset).to_render_settings()
    kw = {}
    if args.width or args.height:
        w = args.width or (args.height or 256)
        h = args.height or w
        kw["resolution_override"] = (w, h)
    if args.depth is not None:
        kw["max_depth"] = args.depth
    if args.aa is not None:
        kw["aa_samples"] = args.aa
    if args.fov is not None:
        kw["camera_fov_override"] = args.fov
    if args.intensity is not None:
        kw["light_intensity_scale"] = args.intensity
    if args.background:
        kw["background_color_override"] = tuple(args.background)
    if args.camera_pos:
        kw["camera_position_override"] = tuple(args.camera_pos)
    if args.camera_rot:
        kw["camera_rotation_override"] = tuple(args.camera_rot)
    if args.ortho:
        kw["is_orthographic"] = True
    if args.no_ambient:
        kw["enable_ambient"] = False
    if args.no_diffuse:
        kw["enable_diffuse"] = False
    if args.no_specular:
        kw["enable_specular"] = False
    if args.no_refraction:
        kw["enable_refraction"] = False
    if args.soft_shadows is not None:
        kw["enable_soft_shadows"] = True
        kw["light_size"] = args.soft_shadows
    if args.glossy is not None:
        kw["enable_glossy"] = True
        kw["surface_roughness"] = args.glossy
    if args.motion_blur is not None:
        kw["enable_motion_blur"] = True
        kw["shutter_speed"] = args.motion_blur
    if args.multi_light:
        kw["multi_light"] = True
    if args.analytic:
        kw["analytic_primitives"] = True
    if args.debug_mode:
        kw["debug_mode"] = args.debug_mode
    return s.replace(**kw) if kw else s


def _renderer(args):
    from cosig_tpu_torch.render.renderer import Renderer

    backend = "megakernel" if args.backend == "pallas" else args.backend
    return Renderer(device=args.device, backend=backend)


def _profiler(args):
    """torch.profiler over the render (CUDA activity on the card), or a
    no-op without ``--profile``."""
    if not args.profile:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if args.device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def cmd_render(args) -> int:
    from cosig_tpu_torch.utils.png import write_png

    scene, base = _load_scene_arg(args.scene)
    settings = _settings_from_args(args, base)
    renderer = _renderer(args)

    t0 = time.perf_counter()
    with _profiler(args) as prof:
        if args.chunk_rows:
            img = renderer.render_chunked(
                scene, settings, rows_per_chunk=args.chunk_rows, checkpoint=args.checkpoint,
                progress=lambda f: print(f"\rchunks: {f * 100:.0f}%", end="", flush=True),
            )
            print()
        else:
            img = renderer.render(scene, settings)
    dt = time.perf_counter() - t0
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "render_trace.json")
        prof.export_chrome_trace(trace)
        print(f"profiler trace -> {trace}")
    write_png(args.output, img)
    st = renderer.last_stats
    print(f"rendered {st.width}x{st.height} ({st.triangles} tris) in {dt:.2f}s "
          f"[{renderer.resolve_backend()} on {renderer.device}] -> {args.output}")
    if st.rays_traced:
        print(f"rays traced: {st.rays_traced:,} ({st.mrays_per_s:.1f} Mrays/s)")
    return 0


def cmd_turntable(args) -> int:
    from cosig_tpu_torch.utils.gif import save_gif, turntable_frames

    scene, base = _load_scene_arg(args.scene)
    settings = _settings_from_args(args, base)
    if settings.camera_rotation_override is None:
        settings = settings.replace(camera_rotation_override=(0.0, 0.0, 0.0))
    renderer = _renderer(args)

    t0 = time.perf_counter()
    frames = turntable_frames(
        renderer, scene, settings, steps=args.steps,
        progress=lambda f: print(f"\rframes: {f * 100:.0f}%", end="", flush=True),
    )
    print()
    save_gif(frames, args.output, delay_cs=args.delay)
    print(f"GIF: {time.perf_counter() - t0:.2f}s ({len(frames)} frames) -> {args.output}")
    return 0


def cmd_preview(args) -> int:
    """Realtime preview: ``--frames`` renders with an orbiting camera and a
    frames/s readout — the reference's Update() loop and FPS label
    (SceneBuilder.cs:501,520-538), headless.

    The reference's realtime path binds the render texture and never reads
    a frame back (RayTracer.cs:76-82): every frame goes through
    ``render_to_device`` and stays on the device (on the card, one replay
    of the renderer's cached CUDA graph with the frame's camera; the host
    reads only its ray count). ``--save-dir`` copies the frames to the
    host after the loop."""
    from cosig_tpu_torch.utils.png import write_png

    scene, base = _load_scene_arg(args.scene)
    settings = _settings_from_args(args, base)
    renderer = _renderer(args)
    rot = settings.camera_rotation_override or (0.0, 0.0, 0.0)

    frames_dev = []
    t_start = time.perf_counter()
    for i in range(args.frames):
        s = settings.replace(camera_rotation_override=(rot[0], rot[1], rot[2] + i * args.orbit))
        frames_dev.append(renderer.render_to_device(scene, s))
        print(f"\rframe {i + 1}/{args.frames} enqueued", end="", flush=True)
    total = time.perf_counter() - t_start
    print(f"\n{args.frames} frames in {total:.2f}s ({args.frames / total:.2f} FPS avg)")
    if args.save_dir:
        for i, img in enumerate(frames_dev):
            write_png(f"{args.save_dir}/frame_{i:04d}.png", img.cpu().numpy())
        print(f"saved {len(frames_dev)} frames -> {args.save_dir}")
    return 0


def cmd_compare(args) -> int:
    from cosig_tpu_torch.utils.png import read_png

    a = read_png(args.image_a).astype(np.float64) / 255.0
    b = read_png(args.image_b).astype(np.float64) / 255.0
    if a.shape != b.shape:
        print(f"shape mismatch: {a.shape} vs {b.shape}", file=sys.stderr)
        return 1
    mse = float(((a - b) ** 2).mean())
    rmse = mse ** 0.5
    psnr = 10 * np.log10(1.0 / mse) if mse > 0 else float("inf")
    print(json.dumps({"rmse": rmse, "psnr_db": psnr, "max_abs": float(np.abs(a - b).max())}))
    if args.threshold is not None and rmse > args.threshold:
        print(f"FAIL: rmse {rmse:.6f} > threshold {args.threshold}", file=sys.stderr)
        return 1
    return 0


def cmd_info(args) -> int:
    from cosig_tpu_torch.accel.bvh import build_bvh
    from cosig_tpu_torch.scene.tessellate import extract_triangles

    scene, _ = _load_scene_arg(args.scene)
    print(scene.summary())
    tris = extract_triangles(scene)
    print(f"tessellated triangles: {tris.count}")
    if tris.count:
        t0 = time.perf_counter()
        bvh = build_bvh(tris)
        dt = (time.perf_counter() - t0) * 1e3
        leaves = bvh.count[bvh.count > 0]
        print(f"BVH: {bvh.num_nodes} nodes, depth {bvh.depth()}, {len(leaves)} leaves "
              f"(max {leaves.max()} tris), built in {dt:.1f} ms")
    return 0


def cmd_preset(args) -> int:
    from cosig_tpu_torch.models.preset import ScenePreset
    from cosig_tpu_torch.models.settings import RenderSettings

    if args.action == "save":
        preset = ScenePreset.from_render_settings(RenderSettings(), scene_file_path=args.scene)
        preset.PresetName = args.name
        preset.save(args.path)
        print(f"saved preset -> {args.path}")
    else:
        print(json.dumps(ScenePreset.load(args.path).__dict__, indent=2))
    return 0


_NEEDS_DEVICE = (cmd_render, cmd_turntable, cmd_preview)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cosig-tpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to PNG")
    _add_render_args(p)
    p.add_argument("--chunk-rows", type=int,
                   help="resumable chunked rendering with this many rows per chunk")
    p.add_argument("--checkpoint", help="checkpoint path for chunked rendering")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("turntable", help="360-degree turntable GIF")
    _add_render_args(p)
    p.add_argument("--steps", type=int, default=36)
    p.add_argument("--delay", type=int, default=15, help="centiseconds per frame")
    p.set_defaults(fn=cmd_turntable)

    p = sub.add_parser("preview", help="realtime preview loop with FPS readout")
    _add_render_args(p)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--orbit", type=float, default=10.0, help="deg/frame camera Z orbit")
    p.add_argument("--save-dir")
    p.set_defaults(fn=cmd_preview)

    p = sub.add_parser("compare", help="RMSE/PSNR between two PNGs")
    p.add_argument("image_a")
    p.add_argument("image_b")
    p.add_argument("--threshold", type=float)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("info", help="scene + acceleration structure stats")
    p.add_argument("scene")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("preset", help="save/load JSON presets")
    p.add_argument("action", choices=["save", "load"])
    p.add_argument("path")
    p.add_argument("--scene")
    p.add_argument("--name", default="Untitled")
    p.set_defaults(fn=cmd_preset)

    args = ap.parse_args(argv)
    if args.fn in _NEEDS_DEVICE and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("cosig-tpu-torch: --device cuda needs a CUDA device and none is available; "
                  "--device cpu runs the plain PyTorch versions", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
