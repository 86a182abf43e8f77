#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (cosig_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. print the card's name and power limit and the torch version; build the
   kernels from ``cosig_tpu_torch/csrc`` and print the build time;
2. render small frames with the kernels and with their plain PyTorch
   versions on the card and hold them to the tolerances below;
3. time each kernel against its plain version at the main path's shapes
   (glass_sphere, 1024x1024, AA 4);
4. drive the main path — ``Renderer(device="cuda").render`` — on
   glass_sphere (1024x1024, depth 6, AA 4) and large_mesh (2048x2048,
   depth 4) with the launch counters reset first: one primary and
   max_depth - 1 bounce launches per frame, finite images, ray counts
   and image means against the JAX package's recorded values
   (bench_details.json), ms/frame with CUDA events;
5. time each stage of one such frame, and the plain version's frame at
   the same size, and compare its image with the kernels'.

The last two lines are a JSON object with the per-kernel numbers and the
result line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# Kernel vs plain version, on the same inputs (the port's own gates,
# ROADMAP "what ported means"): depth 1 is a single bounce, so any
# difference is rounding and stays at float32 ULPs; deeper frames can
# amplify a ULP at a silhouette into a changed secondary ray.
DEPTH1_MAX = 2e-6
DEEP_RMSE = 1e-5
DEEP_MAX = 1e-3
RAYS_SLACK = 8
# One stage's state against its plain version at the main path's shapes.
STATE_MAX = 1e-3

# The JAX package's records for the two bench configurations
# (bench_details.json): rays traced and image mean, per frame.
RECORDS = {
    "glass_sphere": {"rays": 8847840, "mean": 0.425855},
    "large_mesh": {"rays": 13689416, "mean": 0.404119},
}
RAYS_REL = 1e-4  # 0.01 %
MEAN_ABS = 1e-4
PLAIN_FRAME_LIMIT_S = 60.0


def log(*a):
    print(*a, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok, *what) -> None:
    """Raise (and so exit non-zero) unless ``ok``; unlike ``assert`` it
    also holds under ``python -O``."""
    if not ok:
        raise SmokeFailure(" ".join(str(w) for w in what))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else (
        f"nvidia-smi failed: {out.stderr.strip()}"
    )


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs, CUDA events around all of them."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def diff(a, b):
    """(bitwise equal, max |a-b|, rmse) over two tensors (NaN == NaN)."""
    import torch

    same = torch.equal(a, b) or bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()
    )
    d = torch.nan_to_num((a - b).abs(), nan=0.0).double()
    return same, float(d.max()), float(d.pow(2).mean().sqrt())


def scene_setup(name: str, settings_kw: dict, device):
    """(scene, settings, cfg, cset on device, uniforms, lights)."""
    import numpy as np

    import cosig_tpu
    from cosig_tpu.scene.generate import CONFIGS
    from cosig_tpu.scene.tessellate import extract_triangles
    from cosig_tpu_torch.accel.clusters import build_clusters
    from cosig_tpu_torch.models.soa import frame_params, materials_host, static_config
    from cosig_tpu_torch.ops.kernel_core import build_lights, build_uniforms

    if name == "demo_cornell":
        scene = cosig_tpu.load_scene(
            os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes", "demo_cornell.txt")
        )
        settings = cosig_tpu.RenderSettings()
    elif name == "tiny":
        from __graft_entry__ import _tiny_scene

        scene, settings = _tiny_scene(), cosig_tpu.RenderSettings()
    else:
        scene, settings = CONFIGS[name]()
    settings = settings.replace(**settings_kw)
    params = frame_params(scene, settings)
    cfg = static_config(scene, settings)
    mats = np.concatenate(materials_host(scene), axis=1)
    cset = build_clusters(extract_triangles(scene), mats).to(device)
    return scene, settings, cfg, cset, build_uniforms(params), build_lights(params, cfg.multi_light)


def compare_small(device) -> None:
    """Phase 2: kernels vs plain versions through the wavefront render."""
    import torch

    from cosig_tpu_torch.ops import trace_wavefront as tw

    cases = [
        ("demo_cornell", dict(resolution_override=(200, 120), max_depth=1)),
        ("demo_cornell", dict(resolution_override=(200, 120), max_depth=4)),
        ("tiny", dict(resolution_override=(64, 64), max_depth=3, aa_samples=4,
                      enable_soft_shadows=True, light_size=5.0, enable_glossy=True,
                      surface_roughness=0.05, enable_motion_blur=True, shutter_speed=0.5)),
        ("tiny", dict(resolution_override=(64, 64), max_depth=3, aa_samples=4,
                      enable_soft_shadows=True, light_size=5.0, enable_glossy=True,
                      surface_roughness=0.05, enable_motion_blur=True, shutter_speed=0.5,
                      is_orthographic=True)),
        ("cosig_walls", dict(resolution_override=(128, 128))),
    ]
    for name, kw in cases:
        _, _, cfg, cset, uni, lights = scene_setup(name, kw, device)
        st_k = tw.trace_state(cset, uni, lights, cfg)
        st_p = tw.trace_state(cset, uni, lights, cfg, plain=True)
        img_k, rays_k = tw.finalize(st_k, cfg, cfg.height)
        img_p, rays_p = tw.finalize(st_p, cfg, cfg.height)
        s_same, s_max, _ = diff(st_k, st_p)
        _, i_max, i_rmse = diff(img_k, img_p)
        tag = f"{name} {cfg.width}x{cfg.height} d{cfg.max_depth} aa{cfg.aa_samples}"
        if cfg.is_orthographic:
            tag += " ortho"
        log(f"compare {tag}: state bitwise={s_same} state max={s_max:.3e} "
            f"image max={i_max:.3e} rmse={i_rmse:.3e} rays kernel={rays_k} plain={rays_p}")
        check(abs(rays_k - rays_p) <= RAYS_SLACK, (tag, rays_k, rays_p))
        check(bool(torch.isfinite(img_k).all()), tag)
        if cfg.max_depth == 1:
            check(i_max <= DEPTH1_MAX, (tag, i_max))
        else:
            check(i_rmse < DEEP_RMSE and i_max < DEEP_MAX, (tag, i_rmse, i_max))


def time_kernels(device) -> list:
    """Phase 3: each kernel alone against its plain version on the same
    inputs, at the main path's shapes (glass_sphere at full size)."""
    import torch

    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import trace_wavefront as tw

    _, _, cfg, cset, uni, lights = scene_setup("glass_sphere", {}, device)
    mats = cset.mats.cpu().numpy()
    band = cfg.height
    out = []

    st_k = kw.primary(cset, uni, mats, lights, cfg, band)
    st_p = tw.primary_stage(cset, uni, mats, lights, cfg, band)
    same, mx, _ = diff(st_k, st_p)
    log(f"primary kernel vs plain (glass_sphere {cfg.width}x{cfg.height} aa{cfg.aa_samples}): "
        f"bitwise={same} max={mx:.3e}")
    check(mx <= STATE_MAX, mx)
    ms = cuda_ms(lambda: kw.primary(cset, uni, mats, lights, cfg, band), 5)
    plain_ms = cuda_ms(lambda: tw.primary_stage(cset, uni, mats, lights, cfg, band), 2)
    out.append(dict(name="primary", route="cuda", source="cosig_tpu_torch/csrc/wavefront.cu",
                    replaces="cosig_tpu/ops/trace_wavefront.py:293",
                    max_abs_err=mx, ms=ms, plain_ms=plain_ms))

    # Bounce at depth 1 on the primary's output, kernel and plain on copies.
    b_k, b_p = st_k.clone(), st_k.clone()
    kw.bounce(b_k, cset, uni, mats, lights, cfg, 1)
    tw.bounce_stage(b_p, cset, uni, mats, lights, cfg, 1)
    same, mx, _ = diff(b_k, b_p)
    log(f"bounce kernel vs plain (depth 1 on the primary state): bitwise={same} max={mx:.3e}")
    check(mx <= STATE_MAX, mx)
    copies = [st_k.clone() for _ in range(5)]
    it = iter(copies)
    ms = cuda_ms(lambda: kw.bounce(next(it), cset, uni, mats, lights, cfg, 1), 5)
    copies = [st_k.clone() for _ in range(2)]
    it = iter(copies)
    plain_ms = cuda_ms(lambda: tw.bounce_stage(next(it), cset, uni, mats, lights, cfg, 1), 2)
    out.append(dict(name="bounce", route="cuda", source="cosig_tpu_torch/csrc/wavefront.cu",
                    replaces="cosig_tpu/ops/trace_wavefront.py:439",
                    max_abs_err=mx, ms=ms, plain_ms=plain_ms))
    del copies, st_k, st_p, b_k, b_p
    torch.cuda.empty_cache()
    return out


def drive_main_path() -> dict:
    """Phase 4: the main path through the Renderer at full size. Only the
    renderer's own launches happen here (main() reads the counters right
    after)."""
    import numpy as np

    import cosig_tpu_torch
    from cosig_tpu.scene.generate import CONFIGS
    from cosig_tpu_torch.kernels import wavefront as kw

    renderer = cosig_tpu_torch.Renderer(device="cuda")
    frames = {}
    for name in ("glass_sphere", "large_mesh"):
        scene, settings = CONFIGS[name]()

        def frame():
            before = (kw.primary_launches, kw.bounce_launches)
            img = renderer.render_to_device(scene, settings)
            check(kw.primary_launches - before[0] == 1, name)
            check(kw.bounce_launches - before[1] == settings.max_depth - 1, name)
            return img

        img = frame().cpu().numpy()  # warm-up frame (builds the cluster set)
        st = renderer.last_stats
        check(img.shape == (st.height, st.width, 3), img.shape)
        check(np.isfinite(img).all(), name)
        rec = RECORDS[name]
        mean = float(img.astype(np.float64).mean())
        check(abs(st.rays_traced - rec["rays"]) <= RAYS_REL * rec["rays"], (name, st.rays_traced))
        check(abs(mean - rec["mean"]) <= MEAN_ABS, (name, mean))
        ms = cuda_ms(frame, 5)
        rays = st.rays_traced
        cset = renderer._cached_cset
        log(f"main path {name} {st.width}x{st.height} d{settings.max_depth} "
            f"aa{settings.aa_samples}: {ms:.3f} ms/frame, {rays / (ms * 1e3):.2f} Mrays/s, "
            f"rays={rays} (record {rec['rays']}), mean={mean:.6f} (record {rec['mean']}), "
            f"clusters={cset.num_clusters} k={cset.k} triangles={cset.num_triangles}")
        frames[name] = dict(ms=ms, rays=rays, mrays_s=rays / (ms * 1e3), mean=mean, image=img)
    return frames


def breakdown_and_plain(device, frames: dict) -> None:
    """Phase 5: per-stage kernel times of one frame (CUDA events around
    each launch), and the plain version's frame time and image at the
    same size (or 512x512 when a frame takes too long)."""
    import torch

    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import trace_wavefront as tw

    for name, fr in frames.items():
        _, _, cfg, cset, uni, lights = scene_setup(name, {}, device)
        mats = cset.mats.cpu().numpy()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(cfg.max_depth + 2)]
        torch.cuda.synchronize()
        ev[0].record()
        state = kw.primary(cset, uni, mats, lights, cfg, cfg.height)
        ev[1].record()
        for d in range(1, cfg.max_depth):
            kw.bounce(state, cset, uni, mats, lights, cfg, d)
            ev[d + 1].record()
        tw.finalize(state, cfg, cfg.height)
        ev[-1].record()
        torch.cuda.synchronize()
        t = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]
        busy = sum(t)
        fr["stages_ms"] = dict(primary=t[0], bounces=t[1:-1], finalize=t[-1])
        fr["kernel_share"] = busy / fr["ms"]
        log(f"  {name} stages (ms): primary {t[0]:.3f}, bounces "
            f"{', '.join(f'{x:.3f}' for x in t[1:-1])}, finalize {t[-1]:.3f}; "
            f"sum {busy:.3f} = {100 * busy / fr['ms']:.1f} % of the renderer's ms/frame")
        # Live rays entering each bounce, from a second frame (host reads
        # between launches would stretch the timed gaps above).
        state = kw.primary(cset, uni, mats, lights, cfg, cfg.height)
        alive = []
        for d in range(1, cfg.max_depth):
            alive.append(int((state[12] > 0).sum()))
            kw.bounce(state, cset, uni, mats, lights, cfg, d)
        fr["alive_into_bounces"] = alive
        log(f"  {name} live rays entering bounces 1..: {alive}")
        del state

        t0 = time.perf_counter()
        pimg, prays = tw.render_wavefront(cset, uni, lights, cfg, plain=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        _, i_max, i_rmse = diff(torch.from_numpy(fr["image"]).to(device), pimg)
        log(f"  {name} kernel vs plain image at full size: max={i_max:.3e} "
            f"rmse={i_rmse:.3e} rays kernel={fr['rays']} plain={prays}")
        check(abs(prays - fr["rays"]) <= RAYS_SLACK)
        check(i_rmse < DEEP_RMSE and i_max < DEEP_MAX, (name, i_rmse, i_max))
        plain_note = "full size"
        if first_s > PLAIN_FRAME_LIMIT_S:
            side = 512
            _, _, cfg, cset, uni, lights = scene_setup(
                name, dict(resolution_override=(side, side)), device)
            plain_note = f"{side}x{side} (full-size frame took {first_s:.1f} s)"
            tw.render_wavefront(cset, uni, lights, cfg, plain=True)
        fr["plain_ms"] = cuda_ms(lambda: tw.render_wavefront(cset, uni, lights, cfg, plain=True), 5)
        fr["plain_at"] = plain_note
        log(f"  {name} plain version: {fr['plain_ms']:.3f} ms/frame at {plain_note}")
        del fr["image"], cset, pimg
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from cosig_tpu_torch.kernels import build as kbuild
        from cosig_tpu_torch.kernels import wavefront as kw
    except ImportError as e:
        print(f"chip_smoke: cosig_tpu_torch is not importable from {here}: {e}", file=sys.stderr)
        return 2

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)
    path, build_s, ptxas = kbuild.build(force=True, verbose=True)
    log(f"kernels built in {build_s:.2f} s: {os.path.relpath(path, here)}")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    check("jax" not in sys.modules)

    compare_small(device)
    kernels = time_kernels(device)
    kw.reset_counts()
    frames = drive_main_path()
    launches = {"primary": kw.primary_launches, "bounce": kw.bounce_launches}
    check(launches["primary"] > 0 and launches["bounce"] > 0, launches)
    breakdown_and_plain(device, frames)
    check("jax" not in sys.modules)

    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(json.dumps({"frames": frames}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
