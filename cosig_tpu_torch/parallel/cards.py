"""Row bands on several cards at once, against the same bands on one card.

On a machine with more than one GPU::

    python3 -m cosig_tpu_torch.parallel.cards

For glass_sphere (1024 x 1024, depth 6, AA 4) and large_mesh (2048 x
2048, depth 4, AA 4: 2^24 camera rays, more than one wavefront band
takes) it renders one band per card on every CUDA device (``make_mesh()``)
and the same bands on the first card alone (``[cuda:0] * n``), through the
sharded wavefront and megakernel: the images must be equal bit for bit and
the rays equal. It then times a frame each way (host clock around the call,
which ends by reading the rays, after a warm-up; median of 5), and each
band alone on the first card. If the cards run their bands at once, the
frame on n cards takes about as long as its slowest band alone, and 1/n of
the frame on one card when the bands hold equal work. It prints the card
line of ``nvidia-smi`` and one JSON line; it exits non-zero if a check
fails.

``--device cpu --n N`` runs the same on N bands of ``[cpu] * N`` at 64 x
64, to rehearse the script without a card (the CPU times are not a
measurement of anything here). ``--mxu full`` renders every band in the
tensor-core form of the pair test (both paths take it).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cosig_tpu_torch.accel.clusters import build_clusters
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.models.soa import frame_params, materials_host, static_config
from cosig_tpu_torch.ops import trace_megakernel, trace_wavefront
from cosig_tpu_torch.ops.kernel_core import build_lights, build_uniforms
from cosig_tpu_torch.parallel import sharding
from cosig_tpu_torch.scene.generate import CONFIGS
from cosig_tpu_torch.scene.tessellate import extract_triangles

FRAMES = ("glass_sphere", "large_mesh")
PATHS = {"wavefront": (sharding.render_sharded_wavefront, trace_wavefront.render_wavefront,
                       lambda cset, cfg, n: sharding.wavefront_band(cfg, n)),
         "megakernel": (sharding.render_sharded_megakernel, trace_megakernel.render_clusters,
                        lambda cset, cfg, n: sharding.megakernel_band(cset, cfg.height, n))}


def _inputs(name: str, side=None):
    scene, settings = CONFIGS[name]()
    settings = settings.replace(aa_samples=4)
    if side is not None:
        settings = settings.replace(resolution_override=(side, side))
    tris = extract_triangles(scene)
    cset = build_clusters(tris, np.concatenate(materials_host(scene), axis=1))
    params, cfg = frame_params(scene, settings), static_config(scene, settings)
    return cset, build_uniforms(params), build_lights(params, cfg.multi_light), cfg


def _frame_ms(fn, devices, reps: int = 5) -> list:
    """Host ms of ``fn()`` after every device has finished its earlier work."""
    out = []
    for _ in range(reps):
        for d in set(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    if res.returncode != 0:
        return f"nvidia-smi failed: {res.stderr}"
    lines = res.stdout.strip().splitlines()
    return lines[0] + (f" (x{len(lines)})" if len(set(lines)) == 1 and len(lines) > 1
                       else "".join(f"; {x}" for x in lines[1:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=None, help="bands on --device cpu (default 4)")
    ap.add_argument("--mxu", choices=("off", "full"), default="off",
                    help="the pair test's form of both paths")
    args = ap.parse_args(argv)
    mx = dict(mxu=args.mxu)
    if args.device == "cuda":
        if torch.cuda.device_count() < 2:
            print(f"needs two or more CUDA devices, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        many = sharding.make_mesh()
        one = [many[0]] * len(many)
        side = None
    else:
        one = many = sharding.make_mesh(devices=["cpu"] * (args.n or 4))
        side = 64
    card = _card_line() if args.device == "cuda" else "cpu"
    print(card, flush=True)
    result = {"card": card, "devices": [str(d) for d in many], "mxu": args.mxu, "frames": {}}
    ok = True
    for name in FRAMES:
        cset, uniforms, lights, cfg = _inputs(name, side)
        for path, (render, single, band_of) in PATHS.items():
            img_many, rays_many = render(cset, uniforms, lights, cfg, many, **mx)
            img_one, rays_one = render(cset, uniforms, lights, cfg, one, **mx)
            same = torch.equal(img_many.cpu(), img_one.cpu()) and rays_many == rays_one
            ok &= same
            ms_many = _frame_ms(lambda: render(cset, uniforms, lights, cfg, many, **mx), many)
            ms_one = _frame_ms(lambda: render(cset, uniforms, lights, cfg, one, **mx), one)
            band = band_of(cset, cfg, len(many))
            dev_cset = cset.to(many[0])
            band_ms = [statistics.median(_frame_ms(
                lambda off=off: single(dev_cset, uniforms, lights, cfg, rows=band, row_offset=off,
                                       **mx),
                many[:1])) for off in sharding.band_offsets(cfg.height, band, len(many))]
            row = dict(bit_equal=same, rays=rays_many, ms_n_cards=ms_many, ms_one_card=ms_one,
                       speedup=statistics.median(ms_one) / statistics.median(ms_many),
                       band_ms_alone=band_ms)
            result["frames"][f"{name} {cfg.width}x{cfg.height} d{cfg.max_depth} aa4 {path}"] = row
            print(f"[{card}] {name} {cfg.width}x{cfg.height} d{cfg.max_depth} aa4 {path}, "
                  f"{len(many)} bands: {len(set(many))} devices vs one: bit-equal {same}, rays "
                  f"{rays_many}; ms/frame {statistics.median(ms_many):.3f} vs "
                  f"{statistics.median(ms_one):.3f} (medians of 5), {row['speedup']:.2f}x; "
                  f"each band alone on one card {', '.join(f'{t:.3f}' for t in band_ms)} ms",
                  flush=True)
            del img_many, img_one
    if args.device == "cuda":  # the bands ran through the kernels, not their plain versions
        result["launches"] = dict(binding.LAUNCHES)
        sfx = "_mx" if args.mxu != "off" else ""
        ok &= all(result["launches"][k + (sfx if k != "compact" else "")] > 0
                  for k in ("primary", "compact", "bounce", "megakernel"))
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
