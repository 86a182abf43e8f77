#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (cosig_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. print the card's name and power limit and the torch version; build the
   kernels from ``cosig_tpu_torch/csrc`` (one ``nvcc`` per source,
   all started at once), and print the build's time and each kernel's
   registers and spills (the warm serial and parallel rebuilds that PRs
   6-10 timed, ~80 s of the script on a slow host, are left out since
   PR 11 to keep the script inside its time limit);
2. render small frames with the kernels and with their plain PyTorch
   versions on the card and hold them to the tolerances below: the
   wavefront (primary, compaction, bounce) and the megakernel on every
   case, the compaction kernel's list against the plain list at every
   depth (as integers), the megakernel against the wavefront kernels
   (bit-equal at AA 1 and 4), the debug kernel in modes 1-3, and analytic
   spheres and boxes through every kernel; then the edges of the block
   walk in every kernel (partial tiles, inactive threads, AA 3, a band of
   rows, large_mesh's 64-row clusters and the same cut two ways, into two
   cull passes, and four ways, c_pad 1024, into four and two superblocks,
   an analytic frame, a frame whose rays all die at depth 1), bit for
   bit, with the pre-filters of the block walk on (the superblock cull in
   every kernel, the frustum cull in the primary, the debug kernel and the
   megakernel's depth 0); then the compaction
   kernel on synthetic states (``compact_states``: N from 1 to 2^24 - 1,
   every ray dead, alive in one octant or in all eight, NaN and signed
   zero directions), its list and length equal to the plain ones as
   integers, and equal on a second run;
3. print models of the block walk at the main path's shapes (the
   pair-loop efficiency of the kernels' warps, from the plain traversal's
   count of warp slots, for the bounce's warps in pixel order and in list
   order too, for the closest hits of the trace and the fission primary
   their warps beside their compacted schedule, and for the shade's any
   hits the per-warp walk beside the compacted one; the trip fill of the
   megakernel's block-uniform depth loop,
   from the wavefront's live rows), then time each kernel against its
   plain version at the main path's shapes (glass_sphere, 1024x1024, depth
   6, AA 4; the bounce also at large_mesh's depths 1-3, and on an empty
   list), with ``torch.sort`` beside the compaction kernel and its CUDA
   launches per call counted from torch.profiler's device activity, and compute
   each bound from the work the plain traversal counts at those shapes
   (what the kernel's walk tests, shadow rays up to their first occluder)
   and the bytes it must move;
4. drive each path through ``Renderer`` with the launch counters reset
   just before it and read just after: the wavefront and the megakernel
   on the five bench configurations at their full size (diffuse_sphere
   256x256 depth 1, cosig_walls 512x512 depth 1, mirror_sphere 512x512
   depth 3, glass_sphere 1024x1024 depth 6 AA 4, large_mesh 2048x2048
   depth 4) against the JAX package's recorded rays and image means
   (bench_details.json) and the megakernel's frames against the
   wavefront's bit for bit, a debug frame, and analytic frames of
   glass_sphere and cosig_walls held to their plain versions; ms/frame
   with CUDA events;
5. time each wavefront stage (primary; per depth compaction and bounce;
   finalize) over a few frames, the first apart from the rest, with the
   device allocations of each stage, then each launch of one frame on the
   device with torch.profiler, and time the plain versions' frames at the
   same size against the kernels' images;
6. the oracle path and the application layer on the card: glass_sphere
   and large_mesh at bench.py's reduced size (256x256) through the
   brute-force oracle (``backend="xla-brute"``), then through the
   wavefront kernels and the megakernel, each held to the oracle (RMSE <
   1e-5, printed beside the JAX package's record); large_mesh's BVH walk
   (``"xla"``) against brute force; the oracle on the card against the
   oracle on the CPU on one small frame with every effect; then the CLI
   (``cosig_tpu_torch.cli.main``): a full-size render through the
   wavefront kernels (its PNG equal to the Renderer's image, one primary
   and five compaction and bounce launches), a turntable GIF, a preview
   loop with no readback (frames/s), a chunked render interrupted and
   resumed (equal to the unchunked oracle bit for bit) and ``info``;
7. the row-band sharding (``cosig_tpu_torch.parallel.sharding``), the
   megakernel's ``render_chain`` and the native host builders, with the
   launch counters read around each sharded run: (a) the tiny scene at
   32x24 and 32x50 (AA 1 and 4), depth 2, in n = 1, 2, 4, 8 bands on
   ``[cuda:0] * n`` through the oracle, wavefront and megakernel sharded
   functions, each bit-equal to its single render with equal rays and
   within 1e-5 (oracle) and 1e-3 (kernels) of the single oracle, and the
   kernel paths with ``mxu="full"`` in 2 and 4 bands bit-equal to their
   single tensor-core renders; (b)
   glass_sphere in 2, 3 and 4 wavefront bands, bit-equal to the single
   frame, 8,847,840 rays; (c) large_mesh at 2048x2048, depth 4, AA 4 (2^24
   camera rays, which one wavefront band refuses) in 2 and 4 bands,
   bit-equal to each other and to the megakernel's unbanded frame, its
   ms/frame, each of 4 bands alone, and at AA 1 in 2 bands (13,689,414
   rays); (d) ``render_chain``
   on glass_sphere at k = 1 and 4 (the single frame's image, k times its
   rays, ms/frame from the slope); (e) the native library built from the
   repository's sources: BVH nodes and LZW bytes equal to the Python
   builders', the library loaded after a Renderer's build, and the host's
   seconds per new scene and per 36-frame 512x512 turntable GIF;
8. the dense knot (``dense_knot``: large_mesh's configuration with a knot
   of 256,000 triangles, 2,355 clusters of k = 128 in c_pad 2560, five
   superblocks): the host build, the block walk's shared memory and blocks
   per multiprocessor at k = 128 in both builds of each ray kernel (with
   and without the superblock cull), the kernels against their plain
   versions at 128x128, depth 2, bit for bit (lists equal), the
   knot's clusters split 32 ways (75,360 clusters, past the 65,536 that
   sb_aabb_t's 128 superblocks cover, so every kernel takes its flat
   build) bit for bit at 16x8, depth 1 (depth 2, with the bounce and the
   debug view, under ``--dense-knot``), both paths at
   2048x2048 depth 4 through the Renderer with the launch counters read
   around each (ms/frame, Mrays/s, the megakernel bit-equal to the
   wavefront, each launch's device time), and both paths against
   the BVH-walk oracle at 256x256 (RMSE < 1e-5);
9. the Renderer's frames on the card, each one replay of a CUDA graph
   (``cosig_tpu_torch.ops.frame_graph``), against the eager frames (one
   launch per stage from the host) on the same cluster set
   (``graph_frames``): bit for bit, image and rays, on the five bench
   configurations on both paths, debug modes 1-3, the analytic mixed
   scene and the dense knot; an 8-frame orbit of the preview's camera
   path on one capture; two renderers on two scenes interleaved;
   ``render_chain`` at k = 2 and 12 (k times the rays, ms/frame from the
   slope); and eager against graph in turns: ms/frame, the host's ms to
   queue a frame, the graph frame's runtime calls in torch.profiler, each
   graph's capture time and pool bytes;
10. the wavefront's fission form (trace and shade kernels) and its
   separate primary and shadow cluster sets (``form_phase``): each new
   kernel bit-equal to its plain version stage by stage, record rows and
   lists included, on glass_sphere, large_mesh cut 4 ways (c_pad 1024),
   the dense knot at 128x128, the analytic mixed scene and cosig_walls and the tiny scene with every
   effect (both in the fission form alone too), demo_cornell at 61x37 at
   AA 1, 3 and 4 and as a band, on 32- and 64-row clusters, in the
   fission form (``form_edges``: partial blocks of rays and of lists, one
   and two 32-row slots a cluster), and cluster sets past 128 rows (the builds whose walk has
   slots: large_mesh's main set at k = 512 in every form, the tensor-core
   form and the megakernel and debug kernel too, and a shadow set at
   k = 1024); the k of the dense knot's shadow set (1024, the first that
   fits one cull block) and its shared memory against what a block may
   take; every form's full-size frame (glass_sphere, large_mesh, the
   dense knot with that shadow set), eager and as a graph replay,
   bit-equal to the fused frame, with its launches read around it;
   render_chain slopes of each form against the fused frame in turns; and
   the new kernels timed beside the fused kernel of the same stage, with
   their plain versions, bounds and blocks per multiprocessor;
11. the tensor-core form of the pair test (``mx_phase``; the JAX
   package's MXU form, ``mxu="full"`` and ``"closest"``): (a) the device
   functions on single clusters of glass_sphere, large_mesh and large_mesh
   cut 4 ways through ``binding.mx_probe``: the geometry limbs bit-equal to
   ``clusters.pack_mx``, every plane within 1e-6 x sum |coef x input| of
   the float64 sums, the largest error printed; (b) every tensor-core
   kernel against its plain tensor-core version stage by stage on
   glass_sphere, large_mesh cut 4 ways, cosig_walls, the analytic mixed
   scene and the tiny scene with every effect: rays within 8, depth 1 max
   <= 2e-6 and deeper RMSE < 1e-5, flips (more than 1e-3 apart) at most
   0.01 % of a frame, each printed with the pairs whose validity terms
   changed sign; (c) the five bench configurations at full size through
   ``Renderer(mxu="full")`` on both paths and ``mxu="closest"`` on the
   wavefront against their JAX records, each replay bit-equal to its
   eager frame, with the launch counters read around each path; the dense
   knot (past 6 MiB of geometry) keeping the exact builds; glass_sphere
   and large_mesh at 256x256 against the oracle (RMSE < 1e-5);
   ``render_chain`` slopes of the exact and tensor-core frames in turns;
   (d) each tensor-core kernel at the main path's shapes (glass_sphere
   1024x1024 d6 AA 4: the primary, depth 1 and the megakernel's frame;
   large_mesh's depths 1-3) held to its plain tensor-core version as in
   (b), with the plain version's time and the bound from its counted work
   (phase 3's ``kernel_row``), then beside its exact build on the same
   input in turns, with ``torch.bmm`` of the same planes and blocks per
   multiprocessor of both layouts;
12. the tensor-core form in the wavefront's fission form and with the
   separate primary and shadow sets (``mx_form_phase``; six new builds of
   ``csrc/mx_forms.cu``): (a) every new build against its plain version
   stage by stage at 64²-128² (glass_sphere in every form and both modes,
   large_mesh cut 4 ways for the superblock builds, the analytic mixed
   scene, the tiny scene with every effect) at phase 11's gates, flips
   counted, lists equal, and each form's frame bit-equal to the fused
   tensor-core kernels' frame (the same mode's; closest-only with a
   shadow set, whose shadow rays are exact); (b) glass_sphere and
   large_mesh at full size in every form and mode, eager and as a graph
   replay, against their JAX records, the eager frame bit-equal to the
   fused tensor-core frame and the replay to the eager one, with the
   launch counters read around each; ``render_chain`` slopes of each
   against the fused exact frame in turns; (c) each new build at the main
   path's shapes held to its plain version, timed in turns beside the same
   form's exact build and the fused tensor-core build, with its bound and
   blocks per multiprocessor.

Up to phase 8 every Renderer frame on the card is a graph replay too
(each frame's launch counts include one ``graph``; the first frame of a
new configuration also its capture's eager warm-up frame); the kernels'
checks against their plain versions (phases 2, 3, 5) launch them
eagerly.

Near the end the script prints a JSON line of the models, a JSON line of
per-frame numbers, a JSON line each of the oracle's and phases 7's to
12's numbers, a JSON line of per-kernel numbers, the card's name and
power limit, and, as the last line, the result ``{"ok": true, "device":
{...}}``. Without a CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.

    python3 chip_smoke.py --time-kernels [TREE]

runs only phase 3's kernel times (``time_kernels``) of the checkout TREE
(default: this one), with that checkout's own ``chip_smoke.py`` and
package, and prints one line ``TIMES {"tree": ..., "card": ...,
"primary": ms, ..., "bounce large_mesh": [ms per depth]}``. Run it once per
tree, each in a process of its own, parent and change in turns (README.md).

    python3 chip_smoke.py --dense-knot

holds the dense knot to its plain versions at depth 4 (``dense_deep``):
every wavefront stage bit for bit at 128x128 in the fused and the fission
form, the chain, the megakernel and the debug view; the knot cut 32 ways
(past 65,536 clusters: the flat builds) at 16x8, depth 2, with the
bounce and the debug view; then the primary and the megakernel at
2048x2048 with their times and bounds; one ``DENSE {...}`` line, the
card line and the result line (~7 min; phase 8 runs these plain checks
at depth 2 and 1, whose plain frames took most of its time).
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

# The JAX package's records for the five bench configurations
# (bench_details.json): rays traced and image mean, per frame.
RECORDS = {
    "diffuse_sphere": {"rays": 130884, "mean": 0.567826},
    "cosig_walls": {"rays": 687877, "mean": 0.652392},
    "mirror_sphere": {"rays": 548578, "mean": 0.383861},
    "glass_sphere": {"rays": 8847840, "mean": 0.425855},
    "large_mesh": {"rays": 13689416, "mean": 0.404119},
}
RAYS_REL = 1e-4  # 0.01 %
MEAN_ABS = 1e-4
PLAIN_FRAME_LIMIT_S = 60.0

# Phase 6. The JAX package's kernel images against its brute-force oracle
# at bench.py's reduced size (bench_details.json "rmse_vs_oracle"), and
# the port's gates: kernels against the oracle as the JAX backends hold
# among themselves at depth >= 2 (tests/test_pallas.py:33-43); the BVH
# walk against brute force as tests/test_bvh.py:93-95 holds it.
ORACLE_SIDE = 256
ORACLE_RECORDS = {"glass_sphere": 2.4518669761164347e-07, "large_mesh": 3.9810606722312514e-07}
ORACLE_RMSE = 1e-5
BVH_OFF_ABS, BVH_OFF_SHARE, BVH_RMSE = 1e-3, 0.005, 1e-3

# The bound of a kernel: the larger of its float32 operations over the
# H100 SXM's fp32 issue rate and its bytes (each input read once, each
# output written once) over 3.35 TB/s. NVIDIA's 67 TFLOP/s counts a fused
# multiply-add as two operations; these kernels are built with
# --fmad=false (cosig_tpu_torch/kernels/build.py), so every multiply and
# every add is its own instruction, and the fp32 pipes issue at most
# 132 SMs x 128 lanes x 1.98 GHz = 33.45 T operations/s of them (min, max
# and compares may issue slower, which only raises the floor). Operations
# per unit of traversal work (csrc/traverse.cuh): a slab test is 6
# subtracts, 6 multiplies, 10 min/max and 2 compares; a pair test 55
# (three 6-term edge volumes, two 3-term dots, a reciprocal, t and 9
# compares); an analytic primitive about 70 (the 3x4 object transform,
# then the quadratic or the slabs); a pre-filter test of a hull against a
# box (traverse.cuh frustum_pass: a block's hull against a cluster or a
# superblock box, or one ray's against a superblock box) about 75 (per
# axis 2 subtracts, 4 multiplies, 8 min/max, the zero-straddle select and
# the NaN and face rules). Shading adds a few hundred per ray and the
# block's hull reduction (13 values through 5 shuffle steps a pass) a few
# hundred per thread and pass; both are left out, so the bound is a floor.
PEAK_F32_OPS = 132 * 128 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_SLAB = 24
FLOPS_PER_PAIR = 55
FLOPS_PER_PRIM = 70
FLOPS_PER_FRUSTUM = 75

# The small scene of the JAX package's entry module (__graft_entry__.py),
# carried here as text so this script needs nothing of that package: one
# triangle, a sphere, a box, two materials, one light.
TINY_SCENE = """
Image
{
    64 64
    0.2 0.2 0.2
}
Transformation
{
}
Transformation
{
    T 0 0 -20
    Rx -30
}
Transformation
{
    T 2 8 10
}
Transformation
{
    T 1.5 0 0
    S 2 2 2
}
Material
{
    0.8 0.2 0.2
    0.1 0.6 0.3 0 1
}
Material
{
    0.2 0.8 0.2
    0.1 0.5 0 0.8 1.2
}
Camera
{
    1
    12
    45
}
Light
{
    2
    1 1 1
}
Triangles
{
    0
    0
    -8 -8 -2
    8 -8 -2
    0 8 -2
}
Sphere
{
    3
    1
}
Box
{
    0
    0
}
"""


def mixed_scene():
    """An analytic sphere and an analytic box, one light, 48x48: the JAX
    package's analytic test scene (tests/test_analytic.py _mixed_scene),
    built with the port's model classes."""
    from cosig_tpu_torch.models.scene import (
        BoxDescription,
        CameraSettings,
        CompositeTransformation,
        ImageSettings,
        LightSource,
        MaterialDescription,
        SceneData,
        SphereDescription,
        TransformElement,
    )

    T = TransformElement
    return SceneData(
        image=ImageSettings(48, 48, (0.0, 0.0, 0.0)),
        transformations=[
            CompositeTransformation(),
            CompositeTransformation([T.translation((0, 0, 40))]),
            CompositeTransformation([T.translation((0, 0, 0)), T.scale((3, 3, 3))]),
            CompositeTransformation([T.translation((4.0, -2.0, -2.0)), T.scale((2, 2, 2))]),
        ],
        camera=CameraSettings(0, 12.0, 60.0),
        lights=[LightSource(1, (1, 1, 1))],
        materials=[MaterialDescription((0.8, 0.4, 0.2), 0.1, 0.7, 0, 0, 1)],
        spheres=[SphereDescription(2, 0)],
        boxes=[BoxDescription(3, 0)],
    )


def log(*a):
    print(*a, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok, *what) -> None:
    """Raise (and so exit non-zero) unless ``ok``; unlike ``assert`` it
    also holds under ``python -O``."""
    if not ok:
        raise SmokeFailure(" ".join(str(w) for w in what))


def check_no_jax() -> None:
    loaded = sorted(m for m in sys.modules if m in ("jax", "cosig_tpu", "__graft_entry__")
                    or m.startswith(("jax.", "cosig_tpu.")))
    check(not loaded, "modules of JAX or the JAX package loaded:", loaded)


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


# A sleep queued on the card ahead of timed launches (~25 ms at the H100's
# clock), long enough for the host to enqueue them all behind it.
SLEEP_CYCLES = 50_000_000


def device_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` on the card over ``reps`` runs: CUDA events around
    the runs, queued behind a sleep kernel so that the host's time to launch
    them (the wrappers' Python, ~0.1-0.2 ms a call) does not pace the card.
    A run that waits for the card on the host is paced by it all the same
    (the plain versions). ``cuda_ms`` times the same runs as the host paces
    them, as a frame does."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
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


# Phase 8's scene: large_mesh with a denser knot, 3200 x 40 x 2 triangles
# (scene/generate.py _torus_knot_mesh), about the mesh size users load.
DENSE_SEGS, DENSE_SIDES = 3200, 40
DENSE_TRIANGLES = 256770
DENSE_CLUSTERS, DENSE_K, DENSE_C_PAD = 2355, 128, 2560


def dense_knot():
    """(scene, settings) of phase 8: large_mesh's configuration (2048x2048,
    depth 4, camera, materials, ground, glass sphere, light) with the knot
    tessellated at DENSE_SEGS x DENSE_SIDES, built with the port's own
    scene/generate.py."""
    from cosig_tpu_torch.models.scene import TrianglesMesh
    from cosig_tpu_torch.scene.generate import CONFIGS, _torus_knot_mesh

    scene, settings = CONFIGS["large_mesh"]()
    meshes = scene.triangle_meshes
    i = max(range(len(meshes)), key=lambda m: len(meshes[m].triangles))  # the knot
    meshes[i] = TrianglesMesh(transformation_index=meshes[i].transformation_index,
                              triangles=_torus_knot_mesh(1, segs=DENSE_SEGS, sides=DENSE_SIDES))
    return scene, settings


def load(name: str):
    """(scene, settings) of a named scene, with the port's own modules."""
    import cosig_tpu_torch
    from cosig_tpu_torch.scene.generate import CONFIGS

    if name == "dense_knot":
        return dense_knot()
    if name == "demo_cornell":
        here = os.path.dirname(os.path.abspath(__file__))
        return (cosig_tpu_torch.load_scene(os.path.join(here, "scenes", "demo_cornell.txt")),
                cosig_tpu_torch.RenderSettings())
    if name == "tiny":
        return cosig_tpu_torch.parse_scene(TINY_SCENE), cosig_tpu_torch.RenderSettings()
    if name == "mixed":
        return mixed_scene(), cosig_tpu_torch.RenderSettings()
    return CONFIGS[name]()


def scene_setup(name: str, settings_kw: dict, device, analytic: bool = False) -> dict:
    """The inputs of one frame: cfg, cluster set on ``device``, uniforms,
    lights and (analytic) the primitive table with its counts, as the
    Renderer builds them."""
    import cosig_tpu_torch
    from cosig_tpu_torch.models.soa import frame_params, static_config
    from cosig_tpu_torch.ops.kernel_core import build_lights, build_uniforms

    scene, settings = load(name)
    settings = settings.replace(analytic_primitives=analytic, **settings_kw)
    cset, prims, counts = cosig_tpu_torch.Renderer(device=device)._geometry_for(scene, analytic)
    params = frame_params(scene, settings)
    cfg = static_config(scene, settings)
    return dict(scene=scene, settings=settings, cfg=cfg, cset=cset,
                uni=build_uniforms(params), lights=build_lights(params, cfg.multi_light),
                prims=prims, prim_counts=counts)


def form_sets(s: dict, ks: dict, device) -> dict:
    """Cluster sets of the frame ``s`` (:func:`scene_setup`'s) at other
    cluster sizes, over the same triangles -> {name: ClusterSet on
    ``device``} for ``ks`` {name: k}: the wavefront's ``cset_primary`` and
    ``cset_shadow``."""
    import numpy as np

    from cosig_tpu_torch.accel.clusters import build_clusters
    from cosig_tpu_torch.models.soa import materials_host
    from cosig_tpu_torch.scene.tessellate import extract_triangles

    tris = extract_triangles(s["scene"], include_primitives=not s["settings"].analytic_primitives)
    mats = np.concatenate(materials_host(s["scene"]), axis=1)
    return {name: build_clusters(tris, mats, k=k).to(device) for name, k in ks.items()}


def tag_of(name, cfg, analytic=False) -> str:
    tag = f"{name} {cfg.width}x{cfg.height} d{cfg.max_depth} aa{cfg.aa_samples}"
    if cfg.is_orthographic:
        tag += " ortho"
    if analytic:
        tag += " analytic"
    return tag


def hold(tag, cfg, img_k, rays_k, img_p, rays_p, exact=False) -> None:
    """A kernel's image against its plain version's, at the port's gates
    (``exact``: bit for bit, rays equal)."""
    import torch

    same, i_max, i_rmse = diff(img_k, img_p)
    log(f"  {tag}: bitwise={same} max={i_max:.3e} rmse={i_rmse:.3e} "
        f"rays kernel={rays_k} plain={rays_p}")
    if exact:
        check(same and rays_k == rays_p, (tag, "not bit-equal to the plain version", i_max))
    check(abs(rays_k - rays_p) <= RAYS_SLACK, (tag, rays_k, rays_p))
    check(bool(torch.isfinite(img_k).all()), tag)
    if cfg.max_depth == 1 or cfg.debug_mode:
        check(i_max <= DEPTH1_MAX, (tag, i_max))
    else:
        check(i_rmse < DEEP_RMSE and i_max < DEEP_MAX, (tag, i_rmse, i_max))


def compare_small(device) -> None:
    """Phase 2: every kernel against its plain version on small frames,
    then the edges of the block walk (edge_cases)."""
    effects = dict(aa_samples=4, enable_soft_shadows=True, light_size=5.0, enable_glossy=True,
                   surface_roughness=0.05, enable_motion_blur=True, shutter_speed=0.5)
    cases = [
        ("demo_cornell", dict(resolution_override=(200, 120), max_depth=1), False),
        ("demo_cornell", dict(resolution_override=(200, 120), max_depth=4), False),
        ("tiny", dict(resolution_override=(64, 64), max_depth=3, **effects), False),
        ("tiny", dict(resolution_override=(64, 64), max_depth=3, is_orthographic=True,
                      **effects), False),
        ("cosig_walls", dict(resolution_override=(128, 128)), False),
        ("mixed", dict(max_depth=2), True),
        ("cosig_walls", dict(resolution_override=(128, 128), max_depth=2), True),
    ]
    for name, kw, analytic in cases:
        compare_case(device, name, kw, analytic)
    edge_cases(device)


def edge_cases(device) -> None:
    """The edges of the block walk, each held bit for bit to its plain
    version on both backends and in the debug kernel: partial 16 x 8 tiles
    and partial blocks of rays and of the bounce's list (61 x 37),
    inactive threads at every barrier, a non-power-of-two AA, a band of
    rows (rows, row_offset); large_mesh, whose 64-row clusters are listed
    many more times than the ring has stages and whose secondary rays are
    incoherent; the analytic cosig_walls frame; and the mixed scene, whose
    one material neither reflects nor refracts, so every ray dies at depth
    1 and the bounces get empty lists."""
    compare_case(device, "mixed", dict(max_depth=3), False, exact=True, lists=[0, 0])
    cornell = dict(resolution_override=(61, 37), max_depth=3)
    for aa in (1, 3, 4):
        compare_case(device, "demo_cornell", dict(cornell, aa_samples=aa), False, exact=True)
        compare_case(device, "demo_cornell", dict(cornell, aa_samples=aa), False, exact=True,
                     band=(21, 9))
    compare_case(device, "large_mesh", dict(resolution_override=(128, 96), max_depth=4), False,
                 exact=True)
    # More clusters than one pass of the block walk's cull (TILE_C = 256):
    # 442 clusters (c_pad 512), then 884 (c_pad 1024, past one superblock
    # of 512, four cull passes).
    for ways in (2, 4):
        compare_case(device, "large_mesh", dict(resolution_override=(128, 96), max_depth=4),
                     False, exact=True, split=ways)
    compare_case(device, "cosig_walls", dict(resolution_override=(128, 128), max_depth=2), True,
                 exact=True)


def split_clusters(cset, ways: int = 2):
    """The cluster set with each cluster cut into ``ways`` clusters of
    k / ways rows, each part under its whole cluster's box (a superset, so
    still exact; the rows keep their order, so each row keeps its index
    into the flat geometry): ``ways`` times the clusters, for a walk over
    more clusters than one cull pass holds. Padding rows stay last in every
    part; c_pad is the next multiple of 512, and the superblock unions are
    built anew from the split boxes (two superblocks at 4 ways on
    large_mesh)."""
    import torch

    from cosig_tpu_torch.accel.clusters import superblock_aabbs

    c, k = cset.num_clusters, cset.k
    if k % ways:
        raise ValueError(f"k = {k} does not split {ways} ways")
    geom = cset.geom.reshape(ways * c, k // ways, cset.geom.shape[2]).contiguous()
    c_pad = -(-ways * c // 512) * 512
    aabb = torch.full((8, c_pad), float("nan"), dtype=torch.float32, device=cset.device)
    aabb[:, :ways * c] = cset.aabb_t[:, :c].repeat_interleave(ways, dim=1)
    sb = torch.from_numpy(superblock_aabbs(aabb.cpu().numpy())).to(cset.device)
    return type(cset)(geom=geom, aabb_t=aabb, sb_aabb_t=sb, mats=cset.mats,
                      num_triangles=cset.num_triangles, mats_host=cset.mats_host)


def check_lists(cset, uni, lights, cfg, rows, row_off, pk) -> list:
    """The wavefront kernels' chain with the compaction kernel's list held
    to compact_plain's at every depth, as integers -> the list lengths."""
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import trace_wavefront as tw

    uni, lights, mats, prims, n_sph, n_box = tw.frame_inputs(
        cset, uni, lights, row_off, None, pk["prims"], pk["prim_counts"])
    fb = binding.frame_buffer(cset.device, uni, mats, lights)
    state = kw.primary(cset, fb, cfg, rows, prims, n_sph, n_box)
    lengths = []
    for d in range(1, cfg.max_depth):
        idx, n_live = kw.compact(state)
        idx_p, n_live_p = tw.compact_plain(state)
        m = int(n_live)
        check(m == int(n_live_p) and idx.dtype == idx_p.dtype
              and bool((idx[:m] == idx_p[:m]).all()),
              "compaction list differs from compact_plain's at depth", d, m, int(n_live_p))
        lengths.append(m)
        kw.bounce(state, idx, n_live, cset, fb, cfg, d, prims, n_sph, n_box)
    return lengths


def compare_case(device, name, kw, analytic, exact=False, band=None, split=1,
                 lists=None, k=None) -> dict:
    """One small frame: the wavefront kernels and the megakernel against
    their plain versions (``exact``: bit for bit), the compaction kernel's
    list against the plain one at every depth (``lists``: the lengths it
    must have), the megakernel against the wavefront kernels (the same bits
    at AA 1 and 4; at other AA the wavefront's sample sum times
    float32(1/aa)), and on some frames the debug kernel. ``band``: (rows,
    row_offset), rows inside the image; ``split``: the scene's clusters cut
    that many ways (split_clusters); ``k``: the scene's clusters built at
    that size instead (past 128 rows, the builds whose walk has slots).
    Returns the plain wavefront's and megakernel's seconds."""
    import numpy as np

    from cosig_tpu_torch.models.soa import static_config
    from cosig_tpu_torch.ops import trace_megakernel as tm
    from cosig_tpu_torch.ops import trace_wavefront as tw

    s = scene_setup(name, kw, device, analytic)
    cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
    if split > 1:
        cset = split_clusters(cset, split)
    if k is not None:
        cset = form_sets(s, dict(k=k), device)["k"]
    pk = dict(prims=s["prims"], prim_counts=s["prim_counts"])
    rows, row_off = band if band else (cfg.height, 0)
    bk = dict(rows=rows, row_offset=row_off) if band else {}
    tag = tag_of(name, cfg, analytic) + (f" rows {row_off}..{row_off + rows - 1}" if band else "")
    log(f"compare {tag} (clusters={cset.num_clusters} k={cset.k} "
        f"c_pad={cset.aabb_t.shape[1]})")
    # Wavefront: primary, compaction and bounce kernels, state against the plain stages.
    st_k = tw.trace_state(cset, uni, lights, cfg, **bk, **pk)
    t0 = time.perf_counter()
    st_p = tw.trace_state(cset, uni, lights, cfg, plain=True, **bk, **pk)
    plain_s = {"wavefront": time.perf_counter() - t0}
    s_same, s_max, _ = diff(st_k, st_p)
    log(f"  wavefront state: bitwise={s_same} max={s_max:.3e}")
    img_w, rays_w = tw.finalize(st_k, cfg, rows)
    hold("wavefront image", cfg, img_w, rays_w, *tw.finalize(st_p, cfg, rows), exact=exact)
    if exact:
        check(s_same, tag, "wavefront state not bit-equal to the plain stages", s_max)
    lengths = check_lists(cset, uni, lights, cfg, rows, row_off, pk)
    log(f"  compaction lists equal to the plain ones; live rays listed per depth: {lengths}")
    check(lists is None or lengths == lists, tag, "list lengths", lengths, "expected", lists)
    # Megakernel against its plain version, and against the wavefront
    # kernels: the same device code, so the same bits at AA 1 and 4.
    img_m, rays_m = tm.render_clusters(cset, uni, lights, cfg, **bk, **pk)
    t0 = time.perf_counter()
    plain_m = tm.render_clusters(cset, uni, lights, cfg, plain=True, **bk, **pk)
    plain_s["megakernel"] = time.perf_counter() - t0
    hold("megakernel", cfg, img_m, rays_m, *plain_m, exact=exact)
    same, mx, _ = diff(img_m, img_w)
    log(f"  megakernel vs wavefront kernels: bitwise={same} max={mx:.3e} "
        f"rays {rays_m} / {rays_w}")
    aa = max(1, cfg.aa_samples)
    if aa in (1, 4):
        check(same and rays_m == rays_w, (tag, "megakernel vs wavefront", mx))
    else:
        # The megakernel's mean is acc * float32(1/aa), the wavefront's acc / aa.
        cols = st_k[9:12].reshape(3, rows, cfg.width, aa)
        acc = cols[..., 0]
        for k in range(1, aa):
            acc = acc + cols[..., k]
        scaled = (acc * float(np.float32(1.0 / aa))).permute(1, 2, 0)
        same_s = diff(img_m, scaled)[0]
        log(f"  megakernel vs the wavefront kernels' sample sum x f32(1/{aa}): bitwise={same_s}")
        check(same_s and rays_m == rays_w, (tag, "megakernel vs wavefront sum x 1/aa"))
    if not band and ((name in ("demo_cornell", "tiny", "large_mesh", "dense_knot")
                      and cfg.max_depth > 1)
                     or analytic):
        for mode in (1, 2, 3):
            dcfg = static_config(s["scene"], s["settings"].replace(debug_mode=mode))
            img_d, rays_d = tm.render_debug(cset, uni, lights, dcfg, **pk)
            hold(f"debug mode {mode}", dcfg, img_d, rays_d,
                 *tm.render_debug(cset, uni, lights, dcfg, plain=True, **pk), exact=exact)
            check(rays_d == cfg.width * cfg.height, (tag, rays_d))
    return plain_s


# The compaction kernel's smallest block range (csrc/wavefront.cu: 16
# warps of a chunk of 32 rays each) and the largest band the wavefront
# takes (trace_wavefront.num_rays: fewer than 2^24 rays).
COMPACT_MIN_RANGE = 512
COMPACT_MAX_N = 2**24 - 1


def compact_states(device, extra_sizes=(), seed: int = 0):
    """Synthetic states f32 [16, N] on ``device`` for the compaction kernel,
    made from ``seed`` with numpy, one at a time -> yields (name, state).
    Mixed states (40 % dead: alive 0, -0, -1 or NaN; live directions
    random, a tenth of their components +0, -0 or NaN) at N = 1, 31, 2047,
    2049, one past the smallest block range, each of ``extra_sizes`` and
    2^24 - 1 (1.07 GB); then at N = 4099: every ray dead, every ray alive
    in one octant, every ray alive in all eight octants, and directions
    drawn from NaN, +0, -0 and +-1 only. Rows the compaction does not read
    are 0."""
    import numpy as np
    import torch

    from cosig_tpu_torch.ops.kernel_core import ROW_ALIVE

    rng = np.random.default_rng(seed)

    def state(alive, dirs):
        st = torch.zeros((16, alive.shape[0]), dtype=torch.float32, device=device)
        st[ROW_ALIVE] = torch.from_numpy(alive).to(device)
        st[3:6] = torch.from_numpy(dirs).to(device)
        return st

    def mixed(n):
        alive = np.where(rng.random(n, dtype=np.float32) < 0.6, np.float32(1.0),
                         rng.choice(np.array([0.0, -0.0, -1.0, np.nan], np.float32), n))
        dirs = rng.standard_normal((3, n), dtype=np.float32)
        odd = rng.random((3, n), dtype=np.float32) < 0.1
        dirs[odd] = rng.choice(np.array([0.0, -0.0, np.nan], np.float32), int(odd.sum()))
        return state(alive, dirs)

    for n in (1, 31, 2047, 2049, COMPACT_MIN_RANGE + 1, *extra_sizes, COMPACT_MAX_N):
        yield f"mixed N={n}", mixed(n)
    n = 4099
    dirs = rng.standard_normal((3, n), dtype=np.float32)
    yield "every ray dead", state(
        rng.choice(np.array([0.0, -0.0, -1.0, np.nan], np.float32), n), dirs)
    signs = np.array([1.0, -1.0, 1.0], np.float32)[:, None]  # octant 1 + 4 = 5
    yield "every ray alive in one octant", state(np.ones(n, np.float32),
                                                 np.abs(dirs) * signs + 0.5 * signs)
    octant = rng.integers(0, 8, n)
    bits = np.stack([(octant >> a) & 1 for a in range(3)]).astype(np.float32)
    yield "every ray alive in all eight octants", state(np.ones(n, np.float32),
                                                        (np.abs(dirs) + 0.5) * (2 * bits - 1))
    yield "directions NaN, +0, -0", state(
        np.ones(n, np.float32),
        rng.choice(np.array([np.nan, 0.0, -0.0, 1.0, -1.0], np.float32), (3, n)))


def check_compaction_states(device) -> list:
    """The compaction kernel on compact_states: its list and n_live equal
    compact_plain's as integers, and a second run on the same state gives
    the same list, on every state -> per state (name, N, live, blocks, rays
    per block)."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import trace_wavefront as tw

    blocks, rays = binding.compact_grid(4 * 1024 * 1024, device)
    check(binding.compact_grid(COMPACT_MIN_RANGE + 1, device) == (2, COMPACT_MIN_RANGE),
          "the smallest block range is not", COMPACT_MIN_RANGE)
    out = []
    for name, st in compact_states(device, extra_sizes=(blocks * rays + 1,)):
        n = st.shape[1]
        idx, n_live = kw.compact(st)
        idx2, n_live2 = kw.compact(st)
        idx_p, n_live_p = tw.compact_plain(st)
        m = int(n_live)
        same = (m == int(n_live_p) and idx.dtype == idx_p.dtype == torch.int32
                and bool((idx[:m] == idx_p[:m]).all()))
        again = int(n_live2) == m and bool((idx2[:m] == idx[:m]).all())
        grid = binding.compact_grid(n, device)
        log(f"  compaction {name}: {m} of {n} rays listed, equal to compact_plain={same}, "
            f"second run equal={again}; grid {grid[0]} blocks x {grid[1]} rays")
        check(same and again, "compaction of", name, m, int(n_live_p))
        out.append(dict(state=name, n=n, live=m, blocks=grid[0], rays_per_block=grid[1]))
        del st, idx, idx2, idx_p
    torch.cuda.empty_cache()
    return out


def cuda_activity(fn, tries: int = 3, calls: dict | None = None) -> list:
    """The device activities (kernels, copies, sets) of one ``fn()`` from
    torch.profiler's CUDA activity -> [(name, start us, ms)] by start. A
    first run of ``fn`` under the profiler is its warm-up step and is not
    read: without it the tracer can miss the first launch. The step's own
    span on the device timeline ("ProfilerStep#n") is not an activity.
    The tracer now and then returns an empty trace of a call that launched
    a kernel: a trace with no CUDA activity at all is taken again, up to
    ``tries`` traces. A trace with any activity goes to the callers'
    checks as it is. ``calls``: filled with the count of each CUDA runtime
    call on the host (``cudaGraphLaunch``, ``cudaLaunchKernel``, ...) in
    the same step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        acts = []

        def read(prof):
            acts.extend((e.name, e.time_range.start,
                         (e.time_range.end - e.time_range.start) / 1e3)
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and not e.name.startswith("ProfilerStep"))
            if calls is not None:
                calls.clear()
                for e in prof.events():
                    if e.device_type == DeviceType.CPU and e.name.startswith("cuda"):
                        calls[e.name] = calls.get(e.name, 0) + 1

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1), on_trace_ready=read) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        if acts:
            break
        log("  torch.profiler's trace held no CUDA activity: traced again")
    return sorted(acts, key=lambda a: a[1])


def work_bound(work: dict, nbytes: int) -> dict:
    """Bound of one kernel call from the plain traversal's counted work and
    the bytes it must move."""
    flops = (FLOPS_PER_SLAB * work["slab_tests"] + FLOPS_PER_PAIR * work["pair_tests"]
             + FLOPS_PER_PRIM * work["prim_tests"]
             + FLOPS_PER_FRUSTUM * (work["frustum_tests"] + work["superblock_tests"]))
    op_ms = flops / PEAK_F32_OPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes",
                work=dict(work, flops=flops, bytes=nbytes))


def uniform_fill(trips, grp, lanes: int) -> float:
    """Trip fill of a loop that a group of ``lanes`` threads runs in step
    per sample: trips [P, aa] per (pixel, sample), grp [P] each pixel's
    group -> sum of trips / (lanes x sum over groups and samples of the
    group's largest trip count). Empty lanes count as idle."""
    import torch

    aa = trips.shape[1]
    top = torch.zeros((int(grp.max()) + 1, aa), dtype=trips.dtype, device=trips.device)
    top.scatter_reduce_(0, grp[:, None].expand(-1, aa), trips, "amax")
    return float(trips.sum() / (lanes * top.sum()))


def model_walks(device) -> dict:
    """Phase 3, before the times: two models of the block walk at the main
    path's full size, counted with the plain traversal and the wavefront
    kernels' alive rows. Neither is a measurement of a kernel.

    * Pair-loop efficiency: the pair tests the rays need over the pair-loop
      slots their warps spend (``kernel_core.WORK["warp_slots"]``: 32 x the
      real rows of each cluster that some ray of the warp enters), for the
      primary kernel's warps (32 consecutive ray ids, 8 pixels x 4 samples
      at AA 4) and for the megakernel's warps of 8 x 4 pixels and of the
      parent's 32 x 1; and per depth for the bounce's warps in pixel order
      (the parent's: 32 consecutive ray ids, dead lanes idle) and in list
      order (32 consecutive entries of the compaction list); and for the
      trace kernel's closest hit alone (large_mesh's depths, glass's
      first) its warps in list order beside its compacted schedule
      (``WORK["pair_slots"]``: per block, cluster and 32-row piece, 128 x
      ceil(pairs / 128)); the fission primary's closest hit in its warps (32
      consecutive ray ids) beside the same compacted schedule; and the
      shade's any hits (glass's primary stage over every ray, large_mesh's
      depths, glass's first) in the per-warp walk, a warp leaving a cluster
      once none of its lanes still walks (``WORK["any_warp_slots"]``; beside
      ``warp_slots``, which counts all the real rows), against the shade
      kernel's compacted any hit (``WORK["any_pair_slots"]``: per block and
      32-row piece, 128 x ceil(n x rows / 128), n the block's rays still
      walking at the start of the piece).
    * Trip fill of the megakernel's depth loop: trips per (pixel, sample)
      from the wavefront's live rows (one, plus one per bounce the ray
      enters alive); for the parent's per-thread loop in 32 x 1 strips, a
      warp runs until its busiest thread's sum over samples; for the
      block-uniform loop, a 8 x 4 warp or a 16 x 8 block runs each sample
      for its busiest pixel's trips. The block walk stages per block if
      the block's fill is at least 90 % on both frames."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import kernel_core as kc
    from cosig_tpu_torch.ops import trace_megakernel as tm
    from cosig_tpu_torch.ops import trace_wavefront as tw

    def shade_model(tag, run) -> dict:
        """The any hits of one plain shade stage: pair tests, the per-warp
        walk's slots (all real rows, and up to the lanes' first occluders)
        and the compacted schedule's."""
        kc.reset_work()
        run()
        torch.cuda.synchronize()
        w = dict(kc.WORK)
        rec = dict(pair_tests=w["pair_tests"], warp_slots=w["warp_slots"],
                   any_warp_slots=w["any_warp_slots"], any_pair_slots=w["any_pair_slots"],
                   per_warp=w["pair_tests"] / max(1, w["any_warp_slots"]),
                   compacted=w["pair_tests"] / max(1, w["any_pair_slots"]))
        log(f"  {tag} any-hit pair-loop efficiency: per-warp walk "
            f"{100 * rec['per_warp']:.1f} %, compacted (the shade kernel's schedule) "
            f"{100 * rec['compacted']:.1f} % ({w['pair_tests']} pair tests, "
            f"{w['any_warp_slots']} per-warp slots, {w['warp_slots']} warp slots of all real "
            f"rows, {w['any_pair_slots']} compacted slots)")
        return rec

    out = {}
    for name in ("glass_sphere", "large_mesh"):
        s = scene_setup(name, {}, device)
        cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
        mats = cset.mats_host
        fb = binding.frame_buffer(cset.device, uni, mats, lights)
        pk = kc.prim_table(None, (0, 0), device)
        aa = max(1, cfg.aa_samples)
        n_px = cfg.width * cfg.height
        n = n_px * aa
        eff = {}
        for label, run, slots, count in (
            ("primary 32 rays", tw.primary_stage, kc.linear_slots(n), n),
            ("megakernel 8x4", tm.megakernel_plain, tm.tile_slots(cfg.width, cfg.height), n_px),
            ("megakernel 32x1", tm.megakernel_plain, kc.linear_slots(n_px), n_px),
        ):
            kc.reset_work()
            run(cset, uni, mats, lights, cfg, cfg.height, *pk,
                warps=kc.warp_of_rays(slots, count).to(device))
            torch.cuda.synchronize()
            w = dict(kc.WORK)
            eff[label] = dict(pair_tests=w["pair_tests"], warp_slots=w["warp_slots"],
                              efficiency=w["pair_tests"] / max(1, w["warp_slots"]))
            log(f"  {name} pair-loop efficiency, {label} warps: {w['pair_tests']} pair tests / "
                f"{w['warp_slots']} warp slots = {100 * eff[label]['efficiency']:.1f} %")
        # The fission primary's closest hit, then the shade's any hits over
        # every ray of its stage, in the primary kernel's warps.
        lin = kc.warp_of_rays(kc.linear_slots(n), n).to(device)
        kc.reset_work()
        st24 = tw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk, warps=lin,
                                fission=True)
        torch.cuda.synchronize()
        w = dict(kc.WORK)
        eff["primary_fission"] = dict(pair_tests=w["pair_tests"], warp_slots=w["warp_slots"],
                                      pair_slots=w["pair_slots"],
                                      per_warp=w["pair_tests"] / max(1, w["warp_slots"]),
                                      compacted=w["pair_tests"] / max(1, w["pair_slots"]))
        log(f"  {name} fission primary pair-loop efficiency: warps of 32 rays "
            f"{100 * eff['primary_fission']['per_warp']:.1f} %, compacted (the kernel's "
            f"schedule) {100 * eff['primary_fission']['compacted']:.1f} % ({w['pair_tests']} "
            f"pair tests, {w['warp_slots']} warp slots, {w['pair_slots']} compacted slots)")
        eff["shade_all"] = shade_model(
            f"{name} shade of the primary stage (all rays)",
            lambda: tw.primary_shade(st24, cset, uni, mats, lights, cfg, *pk, warps=lin))
        del st24
        # Trips per (pixel, sample) from the wavefront kernels' alive rows,
        # and the bounce's pair-loop efficiency per depth in both orders.
        state = kw.primary(cset, fb, cfg, cfg.height, *pk)
        trips = torch.ones(n, dtype=torch.float64, device=device)
        alive, bounce_eff = [], []
        pixel_warps = torch.arange(n, device=device) // 32
        for d in range(1, cfg.max_depth):
            live = state[kc.ROW_ALIVE] > 0
            alive.append(int(live.sum()))
            trips += live.to(torch.float64)
            idx, n_live = kw.compact(state)
            m = int(n_live)
            list_warps = torch.zeros(n, dtype=torch.int64, device=device)
            list_warps[idx[:m].long()] = torch.arange(m, device=device) // 32
            row = {}
            for order, warps in (("pixel order", pixel_warps), ("list order", list_warps)):
                kc.reset_work()
                tw.bounce_listed_stage(state.clone(), idx, n_live, cset, uni, mats, lights, cfg,
                                       d, *pk, warps=warps)
                torch.cuda.synchronize()
                w = dict(kc.WORK)
                row[order] = dict(pair_tests=w["pair_tests"], warp_slots=w["warp_slots"],
                                  efficiency=w["pair_tests"] / max(1, w["warp_slots"]))
            if name == "large_mesh" or d == 1:
                # The trace kernel's closest hit alone, on the same list: its
                # warps in list order against its compacted schedule.
                st24 = torch.zeros((kc.FISSION_ROWS, n), dtype=torch.float32, device=device)
                st24[:kc.STATE_ROWS] = state
                kc.reset_work()
                tw.trace_listed_stage(st24, idx, n_live, cset, *pk, warps=list_warps)
                torch.cuda.synchronize()
                w = dict(kc.WORK)
                row["trace"] = dict(pair_tests=w["pair_tests"], warp_slots=w["warp_slots"],
                                    pair_slots=w["pair_slots"],
                                    per_warp=w["pair_tests"] / max(1, w["warp_slots"]),
                                    compacted=w["pair_tests"] / max(1, w["pair_slots"]))
                log(f"  {name} trace {d} ({m} live rays) pair-loop efficiency: warps in list "
                    f"order {100 * row['trace']['per_warp']:.1f} %, compacted (the trace "
                    f"kernel's schedule) {100 * row['trace']['compacted']:.1f} % "
                    f"({w['pair_tests']} pair tests, {w['warp_slots']} warp slots, "
                    f"{w['pair_slots']} compacted slots)")
                # The shade's any hits on the same list, after that trace.
                row["shade"] = shade_model(
                    f"{name} shade {d} ({m} live rays)",
                    lambda: tw.shade_listed_stage(st24, idx, n_live, cset, uni, mats, lights, cfg,
                                                  d, *pk, warps=list_warps))
                del st24
            bounce_eff.append(dict(depth=d, live=m, **row))
            log(f"  {name} bounce {d} ({m} live rays) pair-loop efficiency: pixel order "
                f"{100 * row['pixel order']['efficiency']:.1f} %, list order "
                f"{100 * row['list order']['efficiency']:.1f} %")
            kw.bounce(state, idx, n_live, cset, fb, cfg, d, *pk)
        eff["bounce"] = bounce_eff
        del state
        trips = trips.reshape(n_px, aa)
        per_pixel = trips.sum(dim=1)
        warp_max = per_pixel.reshape(-1, 32).max(dim=1).values
        tile = kc.warp_of_rays(tm.tile_slots(cfg.width, cfg.height), n_px).to(device)
        fill = {
            "per-thread 32x1": float(per_pixel.sum() / (32 * warp_max.sum())),
            "warp 8x4": uniform_fill(trips, tile, 32),
            "block 16x8": uniform_fill(trips, tile // 4, 128),
        }
        log(f"  {name} live rays entering bounces 1..: {alive}; modelled megakernel trip fill: "
            + ", ".join(f"{k} {100 * v:.1f} %" for k, v in fill.items()))
        out[name] = dict(pair_loop=eff, trip_fill=fill, alive_into_bounces=alive)
        del cset
        torch.cuda.empty_cache()
    worst = min(m["trip_fill"]["block 16x8"] for m in out.values())
    log(f"  block fill {100 * worst:.1f} % on the worse frame: "
        + ("staging per block (the kernels' design)" if worst >= 0.9
           else "below 90 %: per-warp staging would be the design"))
    return out


def timed(fn):
    """(result, ms) of one call of ``fn``, CUDA events around it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def kernel_row(name, tag, run_k, run_p, nbytes, reps_k=5, reps_p=2, bound=work_bound,
               hold=None) -> dict:
    """One kernel against its plain version on the same input (phases 3 and
    11): the kernel's result, the plain version's first run (timed; its
    counted WORK and ``nbytes(result)`` give ``bound``), the two held to
    each other (``hold(kernel's, plain's)``, by default within STATE_MAX),
    then the kernel's time on the card and as the host paces it.
    ``reps_p=0`` times the plain version's one run that gives its result."""
    from cosig_tpu_torch.ops import kernel_core as kc

    res_k = run_k()
    kc.reset_work()
    res_p, first_ms = timed(run_p)
    b = bound(dict(kc.WORK), nbytes(res_k))
    same, mx, _ = diff(res_k, res_p)
    log(f"{name} kernel vs plain ({tag}): bitwise={same} max={mx:.3e}")
    if hold is None:
        check(mx <= STATE_MAX, name, tag, mx)
    else:
        hold(res_k, res_p)
    ms = device_ms(run_k, reps_k)
    paced_ms = cuda_ms(run_k, reps_k)
    plain_ms = cuda_ms(run_p, reps_p) if reps_p else first_ms
    log(f"  {name} ({tag}): {ms:.3f} ms on the card ({paced_ms:.3f} ms paced by the host), "
        f"plain {plain_ms:.1f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
        f"{b['work']})")
    return dict(name=name, at=tag, route="cuda", max_abs_err=mx, ms=ms,
                host_paced_ms=paced_ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], library_ms=None, work=b["work"], result=res_k)


def time_kernels(device) -> list:
    """Phase 3: each kernel alone against its plain version on the same
    inputs, at the main path's shapes: glass_sphere at full size for every
    kernel, the bounce also on an empty list and at large_mesh's depths
    1-3, on the wavefront chain's own states."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import megakernel as km
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.models.soa import static_config
    from cosig_tpu_torch.ops import kernel_core as kc
    from cosig_tpu_torch.ops import trace_megakernel as tm
    from cosig_tpu_torch.ops import trace_wavefront as tw

    wavefront_cu = "cosig_tpu_torch/csrc/wavefront.cu"
    out = []

    def bounce_measure(tag, cset, uni, mats, lights, cfg, depth, pk, state, geom_bytes,
                       reps_p):
        """The bounce kernel at ``depth`` on copies of ``state`` (the
        kernel runs 1 + 2 x 5 times) with the compaction kernel's list. Its
        bytes: the live rays' rows 0-11 and count (and id under soft shadows
        or glossy) in, rows 0-13 out, and the list."""
        idx, n_live = kw.compact(state)
        live = int(n_live)
        fb = binding.frame_buffer(cset.device, uni, mats, lights)
        rows_in = 13 + int(cfg.enable_soft_shadows or cfg.enable_glossy)
        nbytes = geom_bytes + 4 * live * (rows_in + 14 + 1) + 4
        copies_k = [state.clone() for _ in range(11)]
        copies_p = [state.clone() for _ in range(1 + reps_p)]

        def run_k():
            st = copies_k.pop()
            kw.bounce(st, idx, n_live, cset, fb, cfg, depth, *pk)
            return st

        def run_p():
            st = copies_p.pop()
            tw.bounce_listed_stage(st, idx, n_live, cset, uni, mats, lights, cfg, depth, *pk)
            return st

        log(f"bounce input ({tag}): {live} of {state.shape[1]} rays alive")
        rec = kernel_row("bounce", tag, run_k, run_p, lambda st: nbytes, reps_p=reps_p)
        rec["live"] = live
        return rec

    # ---- glass_sphere: every kernel ----
    s = scene_setup("glass_sphere", {}, device)
    cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
    mats = cset.mats_host
    fb = binding.frame_buffer(cset.device, uni, mats, lights)
    pk = kc.prim_table(None, (0, 0), device)
    band = cfg.height
    geom_bytes = 4 * (cset.geom.numel() + cset.aabb_t.numel() + pk[0].numel())
    glass = f"glass_sphere {cfg.width}x{cfg.height} d{cfg.max_depth} aa{cfg.aa_samples}"

    rec = kernel_row("primary", glass, lambda: kw.primary(cset, fb, cfg, band, *pk),
                  lambda: tw.primary_stage(cset, uni, mats, lights, cfg, band, *pk),
                  lambda st: geom_bytes + 4 * st.numel())
    st_k = rec.pop("result")
    out.append(dict(rec, source=wavefront_cu, replaces="cosig_tpu/ops/trace_wavefront.py:293"))

    # Compaction of the primary's output, the list bounce 1 walks. Its
    # bytes: the alive row, the live rays' three direction rows, the list.
    n = st_k.shape[1]
    alive = st_k[kc.ROW_ALIVE] > 0
    live = int(alive.sum())
    idx_k, nl_k = kw.compact(st_k)
    idx_p, nl_p = tw.compact_plain(st_k)
    same = int(nl_k) == int(nl_p) == live and bool((idx_k[:live] == idx_p[:live]).all())
    log(f"compact kernel vs plain ({glass}, depth 1): {live} of {n} rays listed, equal={same}")
    check(same, "compaction list differs from compact_plain's")
    keys = torch.where(alive, (st_k[3] > 0).int() + 2 * (st_k[4] > 0).int()
                       + 4 * (st_k[5] > 0).int(), 8)
    kc.reset_work()
    bound = work_bound(dict(kc.WORK), 4 * n + 12 * live + 4 * live + 4)
    # The CUDA launches of one call, from the profiler's device activity.
    acts = cuda_activity(lambda: kw.compact(st_k))
    log(f"  one kw.compact call on the card: {len(acts)} device activities "
        + ", ".join(f"{a[0][:40]} {a[2]:.4f} ms" for a in acts))
    check(len(acts) == 1 and "compact_kernel" in acts[0][0],
          "kw.compact is not one CUDA launch:", [a[0] for a in acts])
    ms = device_ms(lambda: kw.compact(st_k), 20)
    paced_ms = cuda_ms(lambda: kw.compact(st_k), 20)
    plain_ms = cuda_ms(lambda: tw.compact_plain(st_k), 5)
    library_ms = device_ms(lambda: torch.sort(keys, stable=True), 20)
    grid = binding.compact_grid(n, device)
    log(f"  compact: {ms:.4f} ms on the card ({paced_ms:.4f} ms paced by the host; profiler "
        f"{acts[0][2]:.4f} ms), plain {plain_ms:.3f} ms, torch.sort(keys, stable=True) "
        f"{library_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); grid "
        f"{grid[0]} blocks x {grid[1]} rays")
    out.append(dict(name="compact", at=f"{glass}, depth 1", route="cuda", source=wavefront_cu,
                    replaces="cosig_tpu/ops/trace_wavefront.py:576 _compact_prefix "
                             "(XLA, not Pallas)",
                    max_abs_err=0.0, ms=ms, host_paced_ms=paced_ms, plain_ms=plain_ms,
                    bound_ms=bound["bound_ms"],
                    bound_by=bound["bound_by"], library_ms=library_ms, work=bound["work"],
                    live=live, cuda_launches_per_call=len(acts), profiler_ms=acts[0][2],
                    grid_blocks=grid[0], rays_per_block=grid[1]))
    del idx_k, idx_p, keys

    rec = bounce_measure(f"{glass}, depth 1", cset, uni, mats, lights, cfg, 1, pk, st_k,
                         geom_bytes, reps_p=2)
    del rec["result"]
    bounce = dict(rec, source=wavefront_cu, replaces="cosig_tpu/ops/trace_wavefront.py:439")
    # An empty list over all N rays: the cost of the grid's empty blocks.
    idx, _ = kw.compact(st_k)
    empty = torch.zeros(1, dtype=torch.int32, device=device)
    def run_empty():
        kw.bounce(st_k, idx, empty, cset, fb, cfg, 1, *pk)

    bounce["empty_list_ms"] = device_ms(run_empty, 20)
    bounce["empty_list_host_paced_ms"] = cuda_ms(run_empty, 20)
    log(f"  bounce on an empty list over {n} rays: {bounce['empty_list_ms']:.4f} ms on the card "
        f"({bounce['empty_list_host_paced_ms']:.4f} ms paced by the host)")
    del st_k, idx

    rec = kernel_row("megakernel", glass,
                  lambda: km.megakernel(cset, fb, cfg, band, *pk),
                  lambda: tm.megakernel_plain(cset, uni, mats, lights, cfg, band, *pk),
                  lambda o: geom_bytes + 4 * o.numel())
    del rec["result"]
    megakernel = dict(rec, source="cosig_tpu_torch/csrc/megakernel.cu",
                      replaces="cosig_tpu/ops/trace_pallas.py:132")
    dcfg = static_config(s["scene"], s["settings"].replace(debug_mode=1))
    rec = kernel_row("debug", f"{glass} mode 1", lambda: km.debug(cset, fb, dcfg, *pk),
                  lambda: tm.debug_plain(cset, uni, mats, lights, dcfg, *pk),
                  lambda o: geom_bytes + 4 * o.numel(), reps_k=20, reps_p=5)
    del rec["result"]
    debug = dict(rec, source="cosig_tpu_torch/csrc/megakernel.cu",
                 replaces="cosig_tpu/ops/trace_pallas.py:438")
    del cset
    torch.cuda.empty_cache()

    # ---- large_mesh: the bounce (and its list) at each depth of the chain ----
    s = scene_setup("large_mesh", {}, device)
    cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
    mats = cset.mats_host
    fb = binding.frame_buffer(cset.device, uni, mats, lights)
    geom_bytes = 4 * (cset.geom.numel() + cset.aabb_t.numel() + pk[0].numel())
    state = kw.primary(cset, fb, cfg, cfg.height, *pk)
    deep = []
    for d in range(1, cfg.max_depth):
        tag = f"large_mesh {cfg.width}x{cfg.height} d{cfg.max_depth} aa{cfg.aa_samples}, depth {d}"
        compact_ms = device_ms(lambda: kw.compact(state), 20)
        compact_paced_ms = cuda_ms(lambda: kw.compact(state), 20)
        rec = bounce_measure(tag, cset, uni, mats, lights, cfg, d, pk, state, geom_bytes,
                             reps_p=0)
        state = rec.pop("result")
        deep.append(dict(rec, compact_ms=compact_ms, compact_host_paced_ms=compact_paced_ms))
        log(f"  compact ({tag}): {compact_ms:.4f} ms on the card ({compact_paced_ms:.4f} ms "
            "paced by the host)")
    bounce["large_mesh"] = deep
    del state, cset
    torch.cuda.empty_cache()
    return out + [bounce, megakernel, debug]


def wavefront_launches(max_depth: int) -> dict:
    """Launches of one wavefront frame: the primary, then a compaction and
    a bounce per depth."""
    return dict(primary=1, compact=max_depth - 1, bounce=max_depth - 1)


def graph_launches(per_frame: dict, frames: int, captures: int) -> dict:
    """Launches of ``frames`` Renderer frames on the card that captured
    ``captures`` graphs, each frame's kernels ``per_frame`` (counter name
    -> launches): a capture's warm-up frame runs the kernels eagerly, and
    every frame is one replay of them (``graph``)."""
    out = {k: v * (frames + captures) for k, v in per_frame.items()}
    out["graph"] = frames
    return out


def drive(renderer, name, scene, settings, per_frame: dict) -> dict:
    """A warm-up frame and 5 timed frames through ``renderer``; on the card
    each frame must be one replay of the renderer's graph, launching
    exactly the kernels ``per_frame`` (counter name -> launches), and the
    first frame after a change of the graph's key also its capture's
    warm-up frame. Plain frames on the CPU count nothing."""
    import numpy as np

    from cosig_tpu_torch.kernels import binding

    def frame():
        before, graph = dict(binding.LAUNCHES), renderer._graph
        img = renderer.render_to_device(scene, settings)
        after = dict(binding.LAUNCHES)
        got = {k: after[k] - before[k] for k in after}
        want = {}
        if renderer.device.type == "cuda":
            want = graph_launches(per_frame, 1, int(renderer._graph is not graph))
        want = {k: want.get(k, 0) for k in after}
        check(got == want, name, renderer.backend, "launches per frame", got, "expected", want)
        return img

    img = frame().cpu().numpy()  # warm-up frame (builds the cluster set)
    st = renderer.last_stats
    check(img.shape == (st.height, st.width, 3), img.shape)
    check(np.isfinite(img).all(), name)
    ms = cuda_ms(frame, 5)
    return dict(ms=ms, rays=st.rays_traced, mrays_s=st.rays_traced / (ms * 1e3),
                mean=float(img.astype(np.float64).mean()), image=img)


def drive_main_paths(device) -> tuple:
    """Phase 4: each path through the Renderer at full size, the launch
    counters set to 0 just before it and read just after. Only the
    renderer's own launches happen inside each path."""
    import numpy as np
    import torch

    import cosig_tpu_torch
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.ops import trace_megakernel as tm
    from cosig_tpu_torch.ops import trace_wavefront as tw

    def read():
        return dict(binding.LAUNCHES)

    frames, launches = {}, {}
    for backend in ("wavefront", "megakernel"):
        renderer = cosig_tpu_torch.Renderer(device="cuda", backend=backend)
        binding.reset_counts()
        for name in RECORDS:
            scene, settings = load(name)
            per_frame = (wavefront_launches(settings.max_depth)
                         if backend == "wavefront" else dict(megakernel=1))
            fr = drive(renderer, name, scene, settings, per_frame)
            rec = RECORDS[name]
            cset = renderer._geometry_for(scene)[0]
            log(f"main path {backend} {name} {settings.resolution_override or ''}"
                f"d{settings.max_depth} aa{settings.aa_samples}: {fr['ms']:.3f} ms/frame, "
                f"{fr['mrays_s']:.2f} Mrays/s, rays={fr['rays']} (record {rec['rays']}), "
                f"mean={fr['mean']:.6f} (record {rec['mean']}), clusters={cset.num_clusters} "
                f"k={cset.k} triangles={cset.num_triangles}")
            check(abs(fr["rays"] - rec["rays"]) <= RAYS_REL * rec["rays"], (name, fr["rays"]))
            check(abs(fr["mean"] - rec["mean"]) <= MEAN_ABS, (name, fr["mean"]))
            frames[f"{backend} {name}"] = fr
        got = read()
        log(f"  launches in the {backend} path: {got}")
        if backend == "wavefront":
            check(got["primary"] > 0 and got["compact"] > 0 and got["bounce"] > 0
                  and got["megakernel"] == 0, got)
            launches.update(primary=got["primary"], compact=got["compact"], bounce=got["bounce"])
        else:
            check(got["megakernel"] > 0 and got["primary"] == got["compact"] == got["bounce"] == 0,
                  got)
            launches["megakernel"] = got["megakernel"]
        del renderer
        torch.cuda.empty_cache()
    # Full size, AA 4 and 1: the megakernel runs the wavefront kernels'
    # camera and bounce device code, so its frames are the same bits.
    for name in RECORDS:
        w, m = frames[f"wavefront {name}"], frames[f"megakernel {name}"]
        same = bool(np.array_equal(w["image"], m["image"]))
        log(f"  {name} megakernel vs wavefront kernels at full size: bitwise={same} "
            f"rays {m['rays']} / {w['rays']}")
        check(same and m["rays"] == w["rays"], name, "megakernel vs wavefront at full size")

    # The debug path: one depth view of glass_sphere at its full size.
    renderer = cosig_tpu_torch.Renderer(device="cuda", backend="megakernel")
    scene, settings = load("glass_sphere")
    binding.reset_counts()
    fr = drive(renderer, "glass_sphere debug", scene, settings.replace(debug_mode=1),
               dict(debug=1))
    got = read()
    log(f"debug path glass_sphere d1 mode 1: {fr['ms']:.3f} ms/frame, rays={fr['rays']}, "
        f"mean={fr['mean']:.6f}; launches {got}")
    check(got["debug"] > 0 and fr["rays"] == 1024 * 1024, got, fr["rays"])
    launches["debug"] = got["debug"]
    frames["debug glass_sphere"] = fr

    # The analytic path: spheres (glass_sphere) and boxes and spheres
    # (cosig_walls) at full size through both backends, each against its
    # plain version on the same inputs.
    analytic = []
    binding.reset_counts()
    for backend in ("wavefront", "megakernel"):
        renderer = cosig_tpu_torch.Renderer(device="cuda", backend=backend)
        for name in ("glass_sphere", "cosig_walls"):
            scene, settings = load(name)
            settings = settings.replace(analytic_primitives=True)
            per_frame = (wavefront_launches(settings.max_depth)
                         if backend == "wavefront" else dict(megakernel=1))
            fr = drive(renderer, f"{name} analytic", scene, settings, per_frame)
            frames[f"{backend} {name} analytic"] = fr
            analytic.append((backend, name, fr))
        del renderer
    got = read()
    log(f"  launches in the analytic path: {got}")
    check(got["primary"] > 0 and got["compact"] > 0 and got["bounce"] > 0
          and got["megakernel"] > 0, got)
    for backend, name, fr in analytic:
        s = scene_setup(name, {}, device, analytic=True)
        render = tw.render_wavefront if backend == "wavefront" else tm.render_clusters
        img_p, rays_p = render(s["cset"], s["uni"], s["lights"], s["cfg"], plain=True,
                               prims=s["prims"], prim_counts=s["prim_counts"])
        log(f"analytic {backend} {name} {s['cfg'].width}x{s['cfg'].height} "
            f"d{s['cfg'].max_depth} aa{s['cfg'].aa_samples} (spheres, boxes = "
            f"{s['prim_counts']}): {fr['ms']:.3f} ms/frame, {fr['mrays_s']:.2f} Mrays/s, "
            f"rays={fr['rays']}, mean={fr['mean']:.6f}")
        hold("  against the plain version", s["cfg"], torch.from_numpy(fr["image"]).to(device),
             fr["rays"], img_p, rays_p)
        del img_p
    torch.cuda.empty_cache()
    return frames, launches


def breakdown_and_plain(device, frames: dict, stage_frames: int = 5) -> None:
    """Phase 5: per-stage kernel times of the wavefront frame (CUDA events
    around each launch as the host paces them: the primary; per depth the
    compaction, then the bounce; finalize) in each of ``stage_frames``
    frames, the first frame after phase 4's ``empty_cache`` apart from the
    rest, with the caching allocator's device allocations (``cudaMalloc``)
    per stage; then the device time of each launch of one more frame from
    torch.profiler's CUDA activity, which no host pacing enters; then the
    plain versions' frame times and images at the same size (or 512x512
    when a frame takes too long)."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import kernel_core as kc
    from cosig_tpu_torch.ops import trace_megakernel as tm
    from cosig_tpu_torch.ops import trace_wavefront as tw

    def device_allocs() -> int:
        return int(torch.cuda.memory_stats(device).get("num_device_alloc", -1))

    for name in ("glass_sphere", "large_mesh"):
        fr = frames[f"wavefront {name}"]
        s = scene_setup(name, {}, device)
        cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
        fb = binding.frame_buffer(cset.device, uni, cset.mats_host, lights)
        pk = kc.prim_table(None, (0, 0), device)
        steps = 2 * cfg.max_depth  # primary, (compact, bounce) per depth, finalize

        def frame(mark=lambda: None):
            state = kw.primary(cset, fb, cfg, cfg.height, *pk)
            mark()
            for d in range(1, cfg.max_depth):
                idx, n_live = kw.compact(state)
                mark()
                kw.bounce(state, idx, n_live, cset, fb, cfg, d, *pk)
                mark()
            tw.finalize(state, cfg, cfg.height)
            mark()

        per_frame, allocs, host = [], [], []
        for _ in range(stage_frames):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
            counts, clock = [device_allocs()], [time.perf_counter()]

            def mark():
                ev[len(counts)].record()
                counts.append(device_allocs())
                clock.append(time.perf_counter())

            torch.cuda.synchronize()
            ev[0].record()
            frame(mark)
            torch.cuda.synchronize()
            per_frame.append([ev[i].elapsed_time(ev[i + 1]) for i in range(steps)])
            allocs.append([b - a for a, b in zip(counts, counts[1:])])
            host.append([1e3 * (b - a) for a, b in zip(clock, clock[1:])])
        t = [sum(f[i] for f in per_frame) / stage_frames for i in range(steps)]
        busy = sum(t)
        later = [sum(f[i] for f in per_frame[1:]) / (stage_frames - 1) for i in range(steps)]
        fr["stages_ms"] = dict(primary=t[0], compacts=t[1:-1:2], bounces=t[2:-1:2],
                               finalize=t[-1], frames=stage_frames,
                               per_frame=per_frame, later_frames_mean=later,
                               host_ms_per_stage=host, device_allocs_per_stage=allocs)
        fr["kernel_share"] = busy / fr["ms"]
        log(f"  {name} stages (ms, mean of {stage_frames} frames): primary {t[0]:.3f}; "
            "compact + bounce per depth "
            + ", ".join(f"{c:.3f} + {b:.3f}" for c, b in zip(t[1:-1:2], t[2:-1:2]))
            + f"; finalize {t[-1]:.3f}; sum {busy:.3f} = {100 * busy / fr['ms']:.1f} % of the "
            "renderer's ms/frame")
        for i, (row, h) in enumerate(zip(per_frame, host)):
            log(f"    frame {i}: events " + ", ".join(f"{x:.4f}" for x in row)
                + "; host " + ", ".join(f"{x:.4f}" for x in h))
        log(f"    later frames' mean: " + ", ".join(f"{x:.4f}" for x in later))
        log(f"    device allocations per stage, by frame: {allocs}")
        # One more frame under the profiler: each launch's device time.
        acts = cuda_activity(frame)
        kern = [a for a in acts if "cosig" in a[0]]
        pick = [a[2] for a in kern]
        span = (acts[-1][1] + 1e3 * acts[-1][2] - acts[0][1]) / 1e3
        fr["profiler_ms"] = dict(
            primary=pick[0], compacts=pick[1:-1:2], bounces=pick[2::2],
            other=sum(a[2] for a in acts if "cosig" not in a[0]), span=span,
            busy_share=sum(a[2] for a in acts) / span,
            kernels=[a[0].split("(")[0] for a in kern])
        check(len(kern) == 2 * cfg.max_depth - 1 and "primary_kernel" in kern[0][0]
              and all("compact_kernel" in a[0] for a in kern[1::2])
              and all("bounce_kernel" in a[0] for a in kern[2::2]),
              name, "profiled frame's activities", [a[0] for a in acts])
        p = fr["profiler_ms"]
        log(f"    profiler, one frame's device times: primary {p['primary']:.4f}; compact + "
            "bounce per depth " + ", ".join(f"{c:.4f} + {b:.4f}" for c, b in
                                            zip(p["compacts"], p["bounces"]))
            + f"; other {p['other']:.4f} ({len(acts) - len(kern)} activities); span "
            f"{span:.3f} ms, busy {100 * p['busy_share']:.1f} %")
        t0 = time.perf_counter()
        pimg, prays = tw.render_wavefront(cset, uni, lights, cfg, plain=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        hold(f"{name} wavefront kernels vs plain at full size", cfg,
             torch.from_numpy(fr["image"]).to(device), fr["rays"], pimg, prays)
        mfr = frames[f"megakernel {name}"]
        mimg, mrays = tm.render_clusters(cset, uni, lights, cfg, plain=True)
        hold(f"{name} megakernel vs plain at full size", cfg,
             torch.from_numpy(mfr["image"]).to(device), mfr["rays"], mimg, mrays)
        del pimg, mimg
        plain_note = "full size"
        if first_s > PLAIN_FRAME_LIMIT_S:
            side = 512
            s = scene_setup(name, dict(resolution_override=(side, side)), device)
            cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
            plain_note = f"{side}x{side} (full-size frame took {first_s:.1f} s)"
            tw.render_wavefront(cset, uni, lights, cfg, plain=True)
        fr["plain_ms"] = cuda_ms(lambda: tw.render_wavefront(cset, uni, lights, cfg, plain=True), 3)
        fr["plain_at"] = plain_note
        log(f"  {name} plain wavefront version: {fr['plain_ms']:.3f} ms/frame at {plain_note}")
        del cset
        torch.cuda.empty_cache()
    for fr in frames.values():
        del fr["image"]


def timed_render(renderer, scene, settings):
    """(image on the device, ms) of one ``render_to_device``, CUDA events
    around it on the card."""
    import torch

    if renderer.device.type != "cuda":
        t0 = time.perf_counter()
        img = renderer.render_to_device(scene, settings)
        return img, (time.perf_counter() - t0) * 1e3
    return timed(lambda: renderer.render_to_device(scene, settings))


def run_cli(args) -> str:
    """``cosig_tpu_torch.cli.main(args)`` with its standard output captured;
    it must exit 0."""
    import contextlib
    import io

    from cosig_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    out = buf.getvalue()
    for line in out.replace("\r", "\n").splitlines():
        if line.strip() and not line.startswith(("frame ", "frames:", "chunks:")):
            log(f"    | {line}")
    check(rc == 0, "cli", args, "exited", rc)
    return out


def oracle_and_cli(device, workdir: str, side: int = ORACLE_SIDE, full_size: bool = True) -> dict:
    """Phase 6: the oracle path and the application layer on ``device``
    (``side``: the oracle frames' size; ``full_size``: the CLI render at
    glass_sphere's own size, else at ``side``). Launch counts are checked
    where the device is a card."""
    import re

    import numpy as np
    import torch

    import cosig_tpu_torch
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.render import renderer as renderer_mod
    from cosig_tpu_torch.utils import gif, png

    on_card = device.type == "cuda"
    dev = "cuda" if on_card else "cpu"
    out = {"oracle_side": side, "rmse_vs_oracle": {}}

    # 1. The kernels against the brute-force oracle at the reduced size.
    images = {}
    for name in ("glass_sphere", "large_mesh"):
        scene, settings = load(name)
        small = settings.replace(resolution_override=(side, side))
        oracle = cosig_tpu_torch.Renderer(device=dev, backend="xla-brute")
        img_o, ms = timed_render(oracle, scene, small)  # with the soup's upload
        check(bool(torch.isfinite(img_o).all()) and float(img_o.max()) > 0.05, name, "oracle image")
        images[name] = img_o
        rec = dict(oracle_ms=ms, oracle_rays=oracle.last_stats.rays_traced,
                   triangles=oracle.last_stats.triangles, record=ORACLE_RECORDS[name])
        for backend in ("wavefront", "megakernel"):
            kernels = cosig_tpu_torch.Renderer(device=dev, backend=backend)
            img_k = kernels.render_to_device(scene, small)
            _, mx, rmse = diff(img_k, img_o)
            rays = kernels.last_stats.rays_traced
            rec[backend] = dict(rmse=rmse, max=mx, rays=rays)
            log(f"  {name} {side}x{side} d{settings.max_depth} aa{settings.aa_samples}: "
                f"{backend} rmse_vs_oracle {rmse:.3e} (JAX record {ORACLE_RECORDS[name]:.3e}), "
                f"max {mx:.3e}, rays {rays} (oracle {rec['oracle_rays']})")
            check(rmse < ORACLE_RMSE, name, backend, "rmse_vs_oracle", rmse)
            check(abs(rays - rec["oracle_rays"]) <= RAYS_SLACK, name, backend, "rays", rays)
        log(f"  {name} oracle (xla-brute) {side}x{side}: {ms:.1f} ms/frame, "
            f"{rec['oracle_rays']} rays, {rec['triangles']} triangles")
        out["rmse_vs_oracle"][name] = rec

    # 2. The BVH walk against brute force on large_mesh (11,970 triangles).
    scene, settings = load("large_mesh")
    small = settings.replace(resolution_override=(side, side))
    walk = cosig_tpu_torch.Renderer(device=dev, backend="xla")
    img_w, ms = timed_render(walk, scene, small)  # with the BVH's build
    check(walk._cached_xla[4] is not None, "the xla backend did not walk a BVH on large_mesh")
    a, b = img_w.cpu().numpy(), images["large_mesh"].cpu().numpy()
    off = float((np.abs(a - b).max(axis=2) > BVH_OFF_ABS).mean())
    rmse = float(np.sqrt(((a.astype(np.float64) - b) ** 2).mean()))
    log(f"  large_mesh BVH walk vs brute force {side}x{side}: {100 * off:.3f} % of pixels off by "
        f"> {BVH_OFF_ABS}, rmse {rmse:.3e}; walk {ms:.1f} ms/frame")
    check(off < BVH_OFF_SHARE and rmse < BVH_RMSE, "BVH walk vs brute force", off, rmse)
    out["bvh_walk"] = dict(ms=ms, off_share=off, rmse=rmse)

    # 3. The oracle on the card against the oracle on the CPU.
    scene, _ = load("demo_cornell")
    st = cosig_tpu_torch.RenderSettings(
        resolution_override=(61, 37), max_depth=3, aa_samples=4, enable_soft_shadows=True,
        light_size=5.0, enable_glossy=True, surface_roughness=0.05, enable_motion_blur=True,
        shutter_speed=0.5)
    img_d = cosig_tpu_torch.Renderer(device=dev, backend="xla").render(scene, st)
    img_c = cosig_tpu_torch.Renderer(device="cpu", backend="xla").render(scene, st)
    d = np.abs(img_d - img_c)
    rmse = float(np.sqrt((d.astype(np.float64) ** 2).mean()))
    n_diff = int((d.max(axis=2) > 0).sum())
    log(f"  oracle on {dev} vs on the CPU (demo_cornell 61x37 d3 aa4, soft shadows, glossy, "
        f"motion blur): max {d.max():.3e}, rmse {rmse:.3e}, {n_diff} of {61 * 37} pixels differ")
    check(rmse < DEEP_RMSE and d.max() < DEEP_MAX, "oracle device vs CPU", rmse, d.max())
    out["oracle_device_vs_cpu"] = dict(max=float(d.max()), rmse=rmse, pixels_differ=n_diff)

    # 4. The CLI.
    t_cli = time.perf_counter()
    scene, settings = load("glass_sphere")
    size = [] if full_size else ["--width", str(side), "--height", str(side)]
    png_path = os.path.join(workdir, "glass.png")
    binding.reset_counts()
    text = run_cli(["render", "generated:glass_sphere", "-o", png_path, "--backend", "auto",
                    "--device", dev, *size])
    got = dict(binding.LAUNCHES)
    per_frame = wavefront_launches(settings.max_depth)
    want = {k: 0 for k in got} | graph_launches(per_frame, 1, 1)
    log(f"  cli render launches (one capture, one replay): {got}")
    if on_card:
        check(got == want, "cli render launches", got, "expected", want)
        check(f"[wavefront on {device}]" in text, "cli auto did not take the wavefront kernels")
    st = settings if full_size else settings.replace(resolution_override=(side, side))
    ref = cosig_tpu_torch.Renderer(device=dev, backend="wavefront").render(scene, st)
    same = bool(np.array_equal(png.read_png(png_path), png.to_uint8(ref)))
    log(f"  cli render PNG equal to to_uint8(Renderer.render): {same} ({ref.shape[1]}x{ref.shape[0]})")
    check(same, "cli PNG differs from the renderer's image")
    out["cli_launches"] = got

    gif_path = os.path.join(workdir, "spin.gif")
    run_cli(["turntable", "generated:glass_sphere", "-o", gif_path, "--width", str(side),
             "--height", str(side), "--steps", "8", "--device", dev])
    n_frames = gif.decode_gif_frame_count(gif_path)
    check(n_frames == 8, "turntable GIF frames", n_frames)

    calls = {"to_device": 0}
    orig_to_device, orig_render = renderer_mod.Renderer.render_to_device, renderer_mod.Renderer.render

    def counting(self, scene_, settings_):
        calls["to_device"] += 1
        return orig_to_device(self, scene_, settings_)

    def forbidden(self, scene_, settings_):
        raise SmokeFailure("the preview loop read a frame back")

    renderer_mod.Renderer.render_to_device, renderer_mod.Renderer.render = counting, forbidden
    binding.reset_counts()
    try:
        text = run_cli(["preview", "generated:glass_sphere", "--frames", "10", "--device", dev, *size])
    finally:
        renderer_mod.Renderer.render_to_device, renderer_mod.Renderer.render = (
            orig_to_device, orig_render)
    got = dict(binding.LAUNCHES)
    fps = float(re.search(r"\(([0-9.]+) FPS avg\)", text).group(1))
    log(f"  preview: {calls['to_device']} frames through render_to_device, launches {got}, "
        f"{fps:.2f} frames/s on {card_line() if on_card else 'the CPU'}")
    check(calls["to_device"] == 10, "preview frames", calls)
    if on_card:  # the orbit's camera changes replay one graph
        want = {k: 0 for k in got} | graph_launches(per_frame, 10, 1)
        check(got == want, "preview launches", got, "expected", want)
    out["preview_fps"] = fps

    # The chunked render: interrupted after its first band, resumed by the CLI.
    ck = os.path.join(workdir, "chunks.npz")
    oracle_img = images["glass_sphere"].cpu().numpy()

    class Interrupt(Exception):
        pass

    def stop(frac):
        raise Interrupt

    small = settings.replace(resolution_override=(side, side))
    try:
        cosig_tpu_torch.Renderer(device=dev, backend="xla").render_chunked(
            scene, small, rows_per_chunk=64, checkpoint=ck, progress=stop)
    except Interrupt:
        pass
    check(int(np.load(ck)["done_rows"]) == 64, "checkpoint after the first band")
    chunked = []
    orig_chunked = renderer_mod.Renderer.render_chunked

    def recording(self, *a, **k):
        chunked.append(orig_chunked(self, *a, **k))
        return chunked[-1]

    renderer_mod.Renderer.render_chunked = recording
    try:
        run_cli(["render", "generated:glass_sphere", "-o", os.path.join(workdir, "chunked.png"),
                 "--width", str(side), "--height", str(side), "--chunk-rows", "64",
                 "--checkpoint", ck, "--device", dev, "--backend", "xla"])
    finally:
        renderer_mod.Renderer.render_chunked = orig_chunked
    same = bool(np.array_equal(chunked[0], oracle_img)) and not os.path.exists(ck)
    log(f"  chunked render resumed after the first of {side // 64} bands, equal to the unchunked "
        f"xla render bit for bit: {same}")
    check(same, "chunked render differs from the unchunked one")

    text = run_cli(["info", "generated:large_mesh"])
    check("tessellated triangles: 11970" in text, "cli info")
    out["cli_s"] = time.perf_counter() - t_cli
    log(f"  CLI commands: {out['cli_s']:.1f} s")
    return out


# Phase 7. The sharded renders against the single ones: JAX's
# dryrun_multichip bounds against the single oracle (__graft_entry__.py:165
# for the oracle path, :180 and :190 for the kernels); glass_sphere's
# record (bench_details.json); large_mesh's rays at AA 1 as the port has
# traced them on the card since its first slice (the JAX record is
# 13,689,416, RECORDS).
SHARD_XLA_MAX = 1e-5
SHARD_KERNEL_MAX = 1e-3
LARGE_MESH_AA1_RAYS = 13689414
TURNTABLE_STEPS, TURNTABLE_SIDE = 36, 512


def _launched(before: dict) -> dict:
    from cosig_tpu_torch.kernels import binding

    return {k: binding.LAUNCHES[k] - before[k] for k in binding.LAUNCHES}


def _expect_launches(device, got: dict, want: dict, *what) -> None:
    """On a card, the launches of a run equal ``want`` (counter -> launches,
    the others 0); plain runs count nothing."""
    if device.type == "cuda":
        want = {k: want.get(k, 0) for k in got}
        check(got == want, *what, "launches", got, "expected", want)


def _sharded_wavefront_launches(cfg, n: int) -> dict:
    from cosig_tpu_torch.parallel import sharding

    bands = len(sharding.band_offsets(cfg.height, sharding.wavefront_band(cfg, n), n))
    return {k: v * bands for k, v in wavefront_launches(cfg.max_depth).items()}


def shard_small(device) -> dict:
    """Phase 7a: dryrun_multichip's frame (the tiny scene, 32 x 24, depth
    2) and the padding case (32 x 50, at AA 1 and AA 4) in n bands on
    ``[device] * n``, n = 1, 2, 4, 8, through the three sharded functions:
    each bit-equal to its single render with equal rays, and within the
    dryrun's bounds of the single oracle; then the two kernel paths in the
    tensor-core form (``mxu="full"``) in 2 and 4 bands, each bit-equal to
    its single tensor-core render."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.models.soa import compile_scene, frame_params
    from cosig_tpu_torch.ops import trace_megakernel as tm
    from cosig_tpu_torch.ops import trace_wavefront as tw
    from cosig_tpu_torch.ops import trace_xla
    from cosig_tpu_torch.parallel import sharding

    out = {}
    for w, h, aa in ((32, 24, 1), (32, 50, 1), (32, 50, 4)):
        s = scene_setup("tiny", dict(resolution_override=(w, h), max_depth=2, aa_samples=aa),
                        device)
        cfg, args = s["cfg"], (s["cset"], s["uni"], s["lights"], s["cfg"])
        arrays = compile_scene(s["scene"], device=device)
        params = frame_params(s["scene"], s["settings"])
        oracle = trace_xla.render_image(arrays, params, cfg)
        single = {"wavefront": tw.render_wavefront(*args), "megakernel": tm.render_clusters(*args)}
        tag = f"tiny {w}x{h} d2 aa{aa}"
        for n in (1, 2, 4, 8):
            devs = sharding.make_mesh(devices=[device] * n)
            img = sharding.render_sharded(arrays, params, cfg, devs)
            same, mx, _ = diff(img, oracle)
            check(same and mx <= SHARD_XLA_MAX, tag, n, "sharded oracle", mx)
            res = {"xla_max": mx}
            for path, fn in (("wavefront", sharding.render_sharded_wavefront),
                             ("megakernel", sharding.render_sharded_megakernel)):
                before = dict(binding.LAUNCHES)
                img, rays = fn(*args, devs)
                got = _launched(before)
                same, _, _ = diff(img, single[path][0])
                _, mx, _ = diff(img, oracle)
                check(same and rays == single[path][1], tag, n, path,
                      "sharded differs from its single render", rays, single[path][1])
                check(mx < SHARD_KERNEL_MAX, tag, n, path, "against the single oracle", mx)
                want = (_sharded_wavefront_launches(cfg, n) if path == "wavefront" else
                        dict(megakernel=len(sharding.band_offsets(
                            h, sharding.megakernel_band(s["cset"], h, n), n))))
                _expect_launches(device, got, want, tag, n, path)
                res[path] = dict(max_vs_oracle=mx, rays=rays, launches=got)
            out[f"{tag} n{n}"] = res
            log(f"  {tag} in {n} bands: oracle bit-equal, max {res['xla_max']:.1e}; wavefront "
                f"and megakernel bit-equal to their single renders, rays "
                f"{res['wavefront']['rays']} / {res['megakernel']['rays']}, max vs oracle "
                f"{res['wavefront']['max_vs_oracle']:.2e} / "
                f"{res['megakernel']['max_vs_oracle']:.2e}")
        # The tensor-core form: a pair's planes do not depend on the band.
        single = {"wavefront": tw.render_wavefront(*args, mxu="full"),
                  "megakernel": tm.render_clusters(*args, mxu="full")}
        for n in (2, 4):
            devs = sharding.make_mesh(devices=[device] * n)
            for path, fn in (("wavefront", sharding.render_sharded_wavefront),
                             ("megakernel", sharding.render_sharded_megakernel)):
                before = dict(binding.LAUNCHES)
                img, rays = fn(*args, devs, mxu="full")
                got = _launched(before)
                check(torch.equal(img, single[path][0]) and rays == single[path][1], tag, n, path,
                      "mxu=full: sharded differs from its single render", rays, single[path][1])
                if path == "wavefront":
                    bands = len(sharding.band_offsets(h, sharding.wavefront_band(cfg, n), n))
                    want = dict(primary_mx=bands, compact=bands, bounce_mx=bands)
                else:
                    want = dict(megakernel_mx=len(sharding.band_offsets(
                        h, sharding.megakernel_band(s["cset"], h, n), n)))
                _expect_launches(device, got, want, tag, n, path, "mxu=full")
                out[f"{tag} n{n}"][f"{path} mxu full"] = dict(rays=rays, launches=got)
        log(f"  {tag} in 2 and 4 bands, mxu=full: wavefront and megakernel bit-equal to their "
            f"single tensor-core renders")
        del arrays, oracle, single
    torch.cuda.empty_cache() if device.type == "cuda" else None
    return out


def _ms(device, fn, reps: int) -> float:
    """ms per call of ``fn`` as a user waits for it (each call ends by
    reading the rays on the host): CUDA events on a card, else the host clock."""
    if device.type == "cuda":
        return cuda_ms(fn, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def shard_frames(device, card: str, full_size: bool = True) -> dict:
    """Phases 7b-7d: glass_sphere in 2, 3 and 4 wavefront bands; large_mesh
    at 2048 x 2048 AA 4 (2^24 camera rays, which one wavefront band refuses)
    in 2 and 4 bands against the megakernel's unbanded frame, and at AA 1
    in 2 bands; ``render_chain`` on glass_sphere at k = 1 and 4.
    ``full_size=False`` cuts the frames to 128 x 128 (CPU rehearsal)."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.ops import trace_megakernel as tm
    from cosig_tpu_torch.ops import trace_wavefront as tw
    from cosig_tpu_torch.parallel import sharding

    cut = {} if full_size else dict(resolution_override=(128, 128))
    out = {"card": card}

    # 7b. glass_sphere, 1024 x 1024, d6, AA 4.
    g = scene_setup("glass_sphere", cut, device)
    gargs = (g["cset"], g["uni"], g["lights"], g["cfg"])
    single, single_rays = tw.render_wavefront(*gargs)
    if full_size:
        check(single_rays == RECORDS["glass_sphere"]["rays"], "glass single rays", single_rays)
    for n in (2, 3, 4):
        before = dict(binding.LAUNCHES)
        img, rays = sharding.render_sharded_wavefront(*gargs, [device] * n)
        got = _launched(before)
        same, _, _ = diff(img, single)
        check(same and rays == single_rays, "glass_sphere wavefront in", n, "bands", rays)
        _expect_launches(device, got, _sharded_wavefront_launches(g["cfg"], n), "glass", n)
        out[f"glass_sphere wavefront n{n}"] = dict(rays=rays, launches=got)
        log(f"  [{card}] {tag_of('glass_sphere', g['cfg'])} wavefront in {n} bands of "
            f"{sharding.wavefront_band(g['cfg'], n)} rows: bit-equal to the single frame, "
            f"rays {rays} (record {RECORDS['glass_sphere']['rays']}), launches {got}")

    # 7d. render_chain on glass_sphere: the last image is the single
    # frame's, the rays k times its; per-frame time from the slope.
    mega, mega_rays = tm.render_clusters(*gargs)
    before = dict(binding.LAUNCHES)
    chain = {}
    for k in (1, 4):
        img, rays = tm.render_chain(*gargs, k=k)
        same, _, _ = diff(img, mega)
        check(same and rays == k * mega_rays, "render_chain k", k, rays, mega_rays)
        chain[k] = [_ms(device, lambda: tm.render_chain(*gargs, k=k), 1) for _ in range(3)]
    got = _launched(before)
    # Each call captures its graph after one eager frame, then replays it k times.
    _expect_launches(device, got, dict(megakernel=4 * (1 + 1) + 4 * (1 + 4), graph=4 * 1 + 4 * 4),
                     "render_chain")
    t1, t4 = sorted(chain[1])[1], sorted(chain[4])[1]
    out["render_chain"] = dict(k1_ms=chain[1], k4_ms=chain[4], slope_ms=(t4 - t1) / 3,
                               rays_k4=4 * mega_rays, launches=got)
    log(f"  [{card}] render_chain glass_sphere: k=1 {t1:.3f} ms, k=4 {t4:.3f} ms (medians of "
        f"3), {(t4 - t1) / 3:.3f} ms/frame from the slope; last image bit-equal to a single "
        f"frame, rays 4 x {mega_rays}")
    del g, gargs, single, mega, img

    # 7c. large_mesh at 2048 x 2048, d4: AA 4 (one band of 2^24 rays is
    # refused) in 2 and 4 bands, then AA 1 in 2 bands.
    m = scene_setup("large_mesh", dict(cut, aa_samples=4), device)
    margs = (m["cset"], m["uni"], m["lights"], m["cfg"])
    if full_size:
        try:
            tw.render_wavefront(*margs)
        except ValueError as e:
            log(f"  large_mesh 2048x2048 d4 aa4 in one wavefront band: refused ({e})")
        else:
            check(False, "one wavefront band of 2^24 rays was not refused")
    before = dict(binding.LAUNCHES)
    img2, rays2 = sharding.render_sharded_wavefront(*margs, [device] * 2)
    img4, rays4 = sharding.render_sharded_wavefront(*margs, [device] * 4)
    got = _launched(before)
    same, _, _ = diff(img2, img4)
    check(same and rays2 == rays4, "large_mesh aa4: 2 bands differ from 4 bands", rays2, rays4)
    want = {k: _sharded_wavefront_launches(m["cfg"], 2)[k]
            + _sharded_wavefront_launches(m["cfg"], 4)[k] for k in ("primary", "compact",
                                                                     "bounce")}
    _expect_launches(device, got, want, "large_mesh aa4 bands")
    mega, mega_rays = tm.render_clusters(*margs)
    same_mega, mx, _ = diff(img2, mega)
    check(same_mega and rays2 == mega_rays, "large_mesh aa4 bands vs the megakernel", mx,
          rays2, mega_rays)
    del mega
    ms2 = _ms(device, lambda: sharding.render_sharded_wavefront(*margs, [device] * 2), 3)
    ms_mega = _ms(device, lambda: tm.render_clusters(*margs), 3)
    band_rays = sharding.wavefront_band(m["cfg"], 2) * m["cfg"].width * 4
    # Each of 4 bands alone: on 4 cards the slowest one sets the frame.
    bands4 = {}
    for path, render, band in (
            ("wavefront", tw.render_wavefront, sharding.wavefront_band(m["cfg"], 4)),
            ("megakernel", tm.render_clusters,
             sharding.megakernel_band(m["cset"], m["cfg"].height, 4))):
        bands4[path] = [_ms(device, lambda: render(*margs, rows=band, row_offset=off), 3)
                        for off in sharding.band_offsets(m["cfg"].height, band, 4)]
    out["large_mesh aa4"] = dict(rays=rays2, band_rays=band_rays, ms_2_bands=ms2,
                                 mrays_s=rays2 / (ms2 * 1e3), megakernel_ms=ms_mega,
                                 launches=got, mean=float(img2.double().mean()),
                                 ms_each_of_4_bands=bands4)
    log(f"  [{card}] {tag_of('large_mesh', m['cfg'])}: wavefront in 2 bands ({band_rays} rays "
        f"a band) and in 4 bit-equal, rays {rays2}, mean {float(img2.double().mean()):.6f}; "
        f"bit-equal to the megakernel's unbanded frame; 2 bands {ms2:.3f} ms/frame "
        f"({rays2 / (ms2 * 1e3):.1f} Mrays/s), megakernel {ms_mega:.3f} ms/frame; launches {got}")
    log(f"  [{card}] large_mesh aa4, each of 4 bands alone (ms): wavefront "
        f"{', '.join(f'{t:.3f}' for t in bands4['wavefront'])}; megakernel "
        f"{', '.join(f'{t:.3f}' for t in bands4['megakernel'])}")
    del img2, img4, margs, m
    m = scene_setup("large_mesh", cut, device)
    margs = (m["cset"], m["uni"], m["lights"], m["cfg"])
    single, single_rays = tw.render_wavefront(*margs)
    img, rays = sharding.render_sharded_wavefront(*margs, [device] * 2)
    same, _, _ = diff(img, single)
    check(same and rays == single_rays, "large_mesh aa1 in 2 bands", rays, single_rays)
    if full_size:
        check(rays == LARGE_MESH_AA1_RAYS, "large_mesh aa1 rays", rays)
    out["large_mesh aa1 n2"] = dict(rays=rays)
    log(f"  [{card}] {tag_of('large_mesh', m['cfg'])} wavefront in 2 bands: bit-equal to the "
        f"single frame, rays {rays}")
    del single, img, margs, m
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def native_host(device, card: str, workdir: str, full_size: bool = True) -> dict:
    """Phase 7e: the native host builders built from the repository's
    sources (``use_native="native"``): BVH nodes equal to the Python
    builder's on the five bench scenes and demo_cornell, LZW bytes equal to
    ``lzw_compress_py``'s, the native library loaded after a Renderer's
    build; the host's seconds per new scene (tessellation, BVH native and
    Python, clusters) and per 36-frame turntable GIF at 512 x 512 (native
    and Python encoders). ``full_size=False`` renders the turntable at 64 x
    64 (CPU rehearsal)."""
    import numpy as np

    import cosig_tpu_torch
    from cosig_tpu_torch.accel.bvh import build_bvh
    from cosig_tpu_torch.accel.clusters import build_clusters
    from cosig_tpu_torch.models.soa import materials_host
    from cosig_tpu_torch.native import loader
    from cosig_tpu_torch.scene.generate import CONFIGS
    from cosig_tpu_torch.scene.tessellate import extract_triangles
    from cosig_tpu_torch.utils import gif

    t0 = time.perf_counter()
    path = loader.build(force=True)
    host = "host times on the card machine's CPU" if device.type == "cuda" else "host times"
    out = {"card": card, "host": host, "build_s": time.perf_counter() - t0,
           "library": os.path.basename(path), "scenes": {}}
    log(f"  native library built from {', '.join(loader.SOURCES)} in {out['build_s']:.2f} s")

    def secs(fn, reps=3):
        best = None
        for _ in range(reps):
            t = time.perf_counter()
            res = fn()
            dt = time.perf_counter() - t
            best = dt if best is None else min(best, dt)
        return res, best

    for name in [*CONFIGS, "demo_cornell"]:
        scene, _ = load(name)
        tris, t_tess = secs(lambda: extract_triangles(scene))
        row = dict(triangles=tris.count, tessellate_s=t_tess)
        for leaf in (4, 256):
            nat, t_nat = secs(lambda: build_bvh(tris, leaf, use_native="native"))
            py, t_py = secs(lambda: build_bvh(tris, leaf, use_native="python"), 1)
            for f in ("node_min", "node_max", "left_or_first", "count", "order"):
                a, b = np.asarray(getattr(nat, f)), np.asarray(getattr(py, f))
                check(a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)),
                      name, "leaf", leaf, "native BVH", f, "differs from the Python builder's")
            row[f"bvh{leaf}_native_s"], row[f"bvh{leaf}_python_s"] = t_nat, t_py
        if name in CONFIGS:
            mats = np.concatenate(materials_host(scene), axis=1)
            _, row["clusters_s"] = secs(lambda: build_clusters(tris, mats))
        out["scenes"][name] = row
        log(f"  [{card}; {host}] {name}: {tris.count} triangles, "
            f"tessellate {t_tess:.4f} s, BVH (leaf 4) native {row['bvh4_native_s']:.4f} s / "
            f"Python {row['bvh4_python_s']:.4f} s, BVH (leaf 256) native "
            f"{row['bvh256_native_s']:.4f} s / Python {row['bvh256_python_s']:.4f} s"
            + (f", clusters {row['clusters_s']:.4f} s" if "clusters_s" in row else "")
            + "; nodes equal to the Python builder's")

    renderer = cosig_tpu_torch.Renderer(device=device)
    scene, settings = load("glass_sphere")
    renderer._geometry_for(scene)
    check(loader.loaded(), "the Renderer's host build did not load the native library")

    side = TURNTABLE_SIDE if full_size else 64
    small = settings.replace(resolution_override=(side, side))
    t = time.perf_counter()
    frames = gif.turntable_frames(renderer, scene, small, steps=TURNTABLE_STEPS)
    render_s = time.perf_counter() - t
    data = [gif.quantize(f).tobytes() for f in frames]
    enc = {}
    for mode in ("native", "python"):
        t = time.perf_counter()
        enc[mode] = [gif.lzw_compress(d, use_native=mode) for d in data]
        out[f"gif_encode_{mode}_s"] = time.perf_counter() - t
    check(enc["native"] == enc["python"], "native LZW bytes differ from lzw_compress_py's")
    gif_path = os.path.join(workdir, "turntable.gif")
    t = time.perf_counter()
    gif.save_gif(frames, gif_path)
    out["save_gif_s"] = time.perf_counter() - t
    check(gif.decode_gif_frame_count(gif_path) == TURNTABLE_STEPS, "turntable GIF frames")
    out.update(turntable_render_s=render_s, turntable_side=side,
               gif_bytes=os.path.getsize(gif_path))
    log(f"  [{card}; {host}] turntable of {TURNTABLE_STEPS} "
        f"frames at {side}x{side}: LZW encode (quantized frames, one after another) native "
        f"{out['gif_encode_native_s']:.3f} s, Python {out['gif_encode_python_s']:.3f} s, bytes "
        f"equal; save_gif (quantize + encode in its thread pool + write, native) "
        f"{out['save_gif_s']:.3f} s; rendering the frames {render_s:.3f} s")
    return out


# Phase 8. The dense knot (dense_knot): a scene whose own cluster set
# passes 512 clusters, so every kernel runs the superblock cull on five
# superblocks, at k = 128 (the block walk's largest shared memory). The
# kernels against their plain versions at DENSE_PLAIN_SIDE, both paths
# against the BVH-walk oracle at ORACLE_SIDE, and full-size frames.
DENSE_PLAIN_SIDE = 128
DENSE_PLAIN_DEPTH = 2  # one bounce: the plain frames were most of the script's time at d4
DENSE_SUPERBLOCKS = 5
DENSE_FLAT_SPLIT = 32  # 75,360 clusters of 4 rows: past MAX_CLUSTERS


def dense_frames(device, card: str, full_size: bool = True) -> dict:
    """Phase 8 on the dense knot: (a) the host build and the cluster set
    (DENSE_TRIANGLES triangles, DENSE_CLUSTERS clusters of k = 128 in
    c_pad 2560), the block walk's shared memory and blocks per
    multiprocessor at that k; (b) the kernels against their plain versions
    at DENSE_PLAIN_SIDE, depth DENSE_PLAIN_DEPTH, bit for bit, the
    compaction lists equal, the plain wavefront frame inside
    PLAIN_FRAME_LIMIT_S; (c) both
    paths at 2048 x 2048, depth 4, through the Renderer, the launch
    counters set to 0 before each path and read after it: ms/frame, Mrays/s,
    the megakernel bit-equal to the wavefront, and each launch's device
    time (dense_launch_times); (d) both paths against the BVH-walk
    oracle (``backend="xla"``) at ORACLE_SIDE, RMSE < ORACLE_RMSE.
    ``full_size=False`` cuts (b) to 32 x 32, (c) to 64 x 64 and (d) to 48 x 48
    (CPU rehearsal)."""
    import numpy as np

    import cosig_tpu_torch
    from cosig_tpu_torch.accel.clusters import CULL_BLOCK, MAX_CLUSTERS
    from cosig_tpu_torch.kernels import binding

    check(DENSE_FLAT_SPLIT * DENSE_CLUSTERS > MAX_CLUSTERS, "the split set is not past",
          MAX_CLUSTERS)
    on_card = device.type == "cuda"
    dev = "cuda" if on_card else "cpu"
    out = {"card": card}
    scene, settings = dense_knot()
    if not full_size:
        settings = settings.replace(resolution_override=(64, 64))

    # 8a. The host build and the cluster set.
    renderers = {b: cosig_tpu_torch.Renderer(device=dev, backend=b)
                 for b in ("wavefront", "megakernel")}
    t0 = time.perf_counter()
    cset = renderers["wavefront"]._geometry_for(scene)[0]
    build_s = time.perf_counter() - t0
    sb = cset.sb_aabb_t[:6].cpu().numpy()
    n_sb = int(np.isfinite(sb).all(axis=0).sum())
    shape = dict(triangles=cset.num_triangles, clusters=cset.num_clusters, k=cset.k,
                 c_pad=int(cset.aabb_t.shape[1]), superblocks=n_sb, host_build_s=build_s)
    check(shape["triangles"] == DENSE_TRIANGLES and shape["clusters"] == DENSE_CLUSTERS
          and shape["k"] == DENSE_K and shape["c_pad"] == DENSE_C_PAD
          and n_sb == DENSE_SUPERBLOCKS, "dense knot cluster set", shape)
    if on_card:
        shape["smem_bytes"] = binding.library().cosig_tile_smem_bytes(cset.k)
        # The build each launch picks here (with the superblock cull) and
        # the one a scene of at most 512 clusters launches, at the same k.
        shape["blocks_per_sm"] = {
            build: {name: binding.occupancy(name, n, cset.k, device)
                    for name in ("primary", "bounce", "megakernel", "debug")}
            for build, n in (("superblocks", cset.num_clusters), ("flat", CULL_BLOCK))}
    out["cluster_set"] = shape
    log(f"  dense knot: {shape['triangles']} triangles, {shape['clusters']} clusters of "
        f"k = {shape['k']}, c_pad {shape['c_pad']}, {n_sb} superblocks; host build "
        f"{build_s:.2f} s (tessellation, BVH, clusters); block walk "
        f"{shape.get('smem_bytes', 'n/a')} B of shared memory a block, blocks per "
        f"multiprocessor {shape.get('blocks_per_sm', 'n/a')}")

    # 8b. The kernels against their plain versions at a cut size.
    side = DENSE_PLAIN_SIDE if full_size else 32
    t0 = time.perf_counter()
    plain_s = compare_case(device, "dense_knot", dict(resolution_override=(side, side),
                                                      max_depth=DENSE_PLAIN_DEPTH), False,
                           exact=True)
    out["plain"] = dict(side=side, plain_s=plain_s, compare_s=time.perf_counter() - t0)
    log(f"  dense knot {side}x{side} d{DENSE_PLAIN_DEPTH}: kernels bit-equal to their plain "
        f"versions; plain frames "
        f"{plain_s['wavefront']:.1f} s (wavefront), {plain_s['megakernel']:.1f} s (megakernel)")
    check(plain_s["wavefront"] <= PLAIN_FRAME_LIMIT_S, "plain dense knot frame",
          plain_s["wavefront"])
    # Past the superblocks sb_aabb_t holds: the flat build of every kernel.
    t0 = time.perf_counter()
    flat_s = compare_case(device, "dense_knot", dict(resolution_override=(16, 8), max_depth=1),
                          False, exact=True, split=DENSE_FLAT_SPLIT)
    out["plain_flat"] = dict(clusters=DENSE_FLAT_SPLIT * DENSE_CLUSTERS, side=(16, 8),
                             plain_s=flat_s, compare_s=time.perf_counter() - t0)
    log(f"  dense knot split {DENSE_FLAT_SPLIT} ways ({DENSE_FLAT_SPLIT * DENSE_CLUSTERS} "
        f"clusters, no superblock cull) 16x8 d1: kernels bit-equal to their plain versions "
        f"(at d2, the bounce and the debug view: --dense-knot); "
        f"plain frames {flat_s['wavefront']:.1f} s, {flat_s['megakernel']:.1f} s")

    # 8c. Full-size frames on both paths.
    frames = {}
    for backend, per_frame in (("wavefront", wavefront_launches(settings.max_depth)),
                               ("megakernel", dict(megakernel=1))):
        renderer = renderers[backend]
        renderer._geometry_for(scene)
        binding.reset_counts()
        fr = drive(renderer, "dense_knot", scene, settings, per_frame)
        fr["launches"] = dict(binding.LAUNCHES)
        if on_card:
            check(all(fr["launches"][k] > 0 for k in per_frame), backend, fr["launches"])
        frames[backend] = fr
        log(f"  [{card}] dense knot {backend} {settings.resolution_override or '2048x2048'} "
            f"d{settings.max_depth}: {fr['ms']:.3f} ms/frame, {fr['mrays_s']:.2f} Mrays/s, "
            f"rays {fr['rays']}, mean {fr['mean']:.6f}; launches {fr['launches']}")
    if on_card:
        out["device_ms"] = dense_launch_times(device, renderers["wavefront"], scene, settings)
        log(f"  [{card}] dense knot device ms per launch: "
            + ", ".join(f"{n} {v:.4f}" for n, v in out["device_ms"].items()))
    w, m = frames["wavefront"], frames["megakernel"]
    same = bool(np.array_equal(w["image"], m["image"]))
    log(f"  dense knot megakernel vs wavefront at full size: bitwise={same} rays "
        f"{m['rays']} / {w['rays']}")
    check(same and m["rays"] == w["rays"], "dense knot megakernel vs wavefront")
    for fr in frames.values():
        del fr["image"]
    out["frames"] = frames

    # 8d. Both paths against the BVH-walk oracle.
    oside = ORACLE_SIDE if full_size else 48
    small = settings.replace(resolution_override=(oside, oside))
    walk = cosig_tpu_torch.Renderer(device=dev, backend="xla")
    img_o, ms = timed_render(walk, scene, small)  # with the BVH's build
    check(walk._cached_xla[4] is not None, "the xla backend did not walk a BVH")
    rays_o = walk.last_stats.rays_traced
    rec = dict(side=oside, oracle_ms=ms, oracle_rays=rays_o)
    for backend, renderer in renderers.items():
        img_k = renderer.render_to_device(scene, small)
        _, mx, rmse = diff(img_k, img_o)
        rays = renderer.last_stats.rays_traced
        rec[backend] = dict(rmse=rmse, max=mx, rays=rays)
        log(f"  dense knot {oside}x{oside} d{settings.max_depth}: {backend} vs the BVH-walk "
            f"oracle rmse {rmse:.3e}, max {mx:.3e}, rays {rays} (oracle {rays_o}, "
            f"{ms:.1f} ms/frame)")
        check(rmse < ORACLE_RMSE, "dense knot", backend, "rmse vs the oracle", rmse)
        check(abs(rays - rays_o) <= RAYS_REL * rays_o, "dense knot", backend, "rays", rays)
    out["oracle"] = rec
    del renderers, walk, cset
    if on_card:
        import torch

        torch.cuda.empty_cache()
    return out


def dense_launch_times(device, renderer, scene, settings) -> dict:
    """Each kernel launch of one dense-knot frame on the card: the primary,
    then per depth the compaction and the bounce on that depth's state
    (copies made ahead, so the timed runs see the same input), and the
    megakernel, each timed with CUDA events behind a sleep (device_ms).
    Not torch.profiler: on these 50-90 ms frames its traces held 2 to 6 of
    a frame's 7 launches (PERF.md)."""
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import megakernel as km
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.models.soa import frame_params, static_config
    from cosig_tpu_torch.ops import kernel_core as kc
    from cosig_tpu_torch.ops import trace_wavefront as tw

    cset, prims, counts = renderer._geometry_for(scene)
    params = frame_params(scene, settings)
    cfg = static_config(scene, settings)
    uni, lights, mats, pr, n_sph, n_box = tw.frame_inputs(
        cset, kc.build_uniforms(params), kc.build_lights(params, cfg.multi_light), 0, None,
        prims, counts)
    pk = (pr, n_sph, n_box)
    fb = binding.frame_buffer(cset.device, uni, mats, lights)
    out = {"primary": device_ms(lambda: kw.primary(cset, fb, cfg, cfg.height, *pk), 3)}
    state = kw.primary(cset, fb, cfg, cfg.height, *pk)
    for d in range(1, cfg.max_depth):
        out[f"compact {d}"] = device_ms(lambda: kw.compact(state), 10)
        idx, n_live = kw.compact(state)
        copies = [state.clone() for _ in range(3)]
        out[f"bounce {d}"] = device_ms(
            lambda: kw.bounce(copies.pop(), idx, n_live, cset, fb, cfg, d, *pk), 3)
        kw.bounce(state, idx, n_live, cset, fb, cfg, d, *pk)
        del copies
    out["megakernel"] = device_ms(lambda: km.megakernel(cset, fb, cfg, cfg.height, *pk), 3)
    return out


# Phase 9: the Renderer's frames on the card are CUDA-graph replays
# (cosig_tpu_torch/ops/frame_graph.py), held to the eager frames bit for
# bit and timed against them in turns.
GRAPH_TURN_FRAMES = 10  # frames per timed turn (the dense knot: 4)
ORBIT_FRAMES, ORBIT_DEG = 8, 10.0  # the CLI preview's camera path (--orbit 10)
CHAIN_KS = (2, 12)


TRACE_TRIES = 4


def traced(fn, kernels: int, calls: dict | None = None) -> tuple:
    """(activities, traces taken) of one ``fn()`` from ``cuda_activity``,
    traced again (up to TRACE_TRIES traces) while the trace holds fewer
    than ``kernels`` launches of the port's kernels: torch.profiler's
    trace of a frame of a few ms now and then loses its first activities
    (PERF.md)."""
    for tries in range(1, TRACE_TRIES + 1):
        acts = cuda_activity(fn, calls=calls)
        if sum("cosig" in a[0] for a in acts) == kernels:
            break
    return acts, tries


def graph_frames(device, card: str, full_size: bool = True) -> dict:
    """Phase 9 on the card: (a) Renderer frames (one replay of the
    renderer's cached graph each) bit-equal to the eager frames
    (``render_wavefront`` / ``render_clusters`` / ``render_debug``, one
    launch per stage from the host) on the same cluster set, image and
    rays: the five bench configurations on both kernel paths, debug modes
    1-3, the analytic mixed scene and the dense knot, each with its
    capture time and pool bytes; (b) an 8-frame orbit of the preview's
    camera path, every frame equal to its eager frame, one capture; (c)
    two renderers on two scenes interleaved, every kept frame equal to its
    eager frame; (d) ``Renderer.render_chain`` and both modules'
    ``render_chain`` at k = 2 and 12: k times the frame's rays, the
    frame's image, ms/frame from the slope; (e) eager against graph in
    turns (eager, graph, graph, eager): ms/frame as the host waits for it,
    the host's ms to queue a frame, and a graph frame's activities in
    torch.profiler (one ``cudaGraphLaunch`` and at most one device-to-host
    copy, the ray count).
    ``full_size=False`` cuts every frame to 96 x 96 and the dense knot out
    (a first check on the card)."""
    import torch

    import cosig_tpu_torch
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.models.soa import frame_params, static_config
    from cosig_tpu_torch.ops import kernel_core as kc
    from cosig_tpu_torch.ops import trace_megakernel as tm
    from cosig_tpu_torch.ops import trace_wavefront as tw

    check(device.type == "cuda", "phase 9 runs on a card")
    out = {"card": card}

    def inputs(renderer, scene, settings):
        params = frame_params(scene, settings)
        cfg = static_config(scene, settings)
        cset, prims, counts = renderer._geometry_for(scene, settings.analytic_primitives)
        return (cset, kc.build_uniforms(params), kc.build_lights(params, cfg.multi_light), cfg,
                dict(prims=prims, prim_counts=counts))

    def eager(renderer, scene, settings, rays_on_device=False):
        """The renderer's frame as eager launches, on its cluster set."""
        cset, uni, lights, cfg, pk = inputs(renderer, scene, settings)
        path = renderer.kernel_path(cfg)
        if path == "debug":
            return tm.render_debug(cset, uni, lights, cfg, **pk)
        render = tm.render_clusters if path == "megakernel" else tw.render_wavefront
        return render(cset, uni, lights, cfg, rays_on_device=rays_on_device, **pk)

    def held(tag, img_g, rays_g, renderer, scene, settings) -> None:
        img_e, rays_e = eager(renderer, scene, settings)
        same = torch.equal(img_g, img_e)
        check(same and rays_g == rays_e, tag, "replayed frame differs from the eager frame",
              diff(img_g, img_e), rays_g, rays_e)

    def sized(settings):
        return settings if full_size else settings.replace(resolution_override=(96, 96))

    renderers = {b: cosig_tpu_torch.Renderer(device="cuda", backend=b)
                 for b in ("wavefront", "megakernel")}

    # (a) Bit-equality, with each capture's time and pool.
    cases = [(name, {}, backend) for name in RECORDS for backend in renderers]
    cases += [("glass_sphere", dict(debug_mode=m), "wavefront") for m in (1, 2, 3)]
    cases += [("mixed", dict(analytic_primitives=True, max_depth=3), b) for b in renderers]
    if full_size:
        cases += [("dense_knot", {}, b) for b in renderers]
    equal = {}
    for name, kw, backend in cases:
        renderer = renderers[backend]
        scene, settings = load(name)
        settings = sized(settings.replace(**kw))
        before, graph = dict(binding.LAUNCHES), renderer._graph
        img = renderer.render_to_device(scene, settings)
        rays = renderer.last_stats.rays_traced
        got = {k: binding.LAUNCHES[k] - before[k] for k in before}
        g = renderer._graph[2]
        check(renderer._graph is not graph and got["graph"] == 1, name, "did not capture", got)
        tag = f"{tag_of(name, static_config(scene, settings), 'analytic_primitives' in kw)}"
        tag += f" {g.path}" + (f" mode {kw['debug_mode']}" if "debug_mode" in kw else "")
        held(tag, img, rays, renderer, scene, settings)
        again = renderer.render_to_device(scene, settings)
        check(renderer._graph[2] is g and torch.equal(again, img)
              and renderer.last_stats.rays_traced == rays, tag, "second replay differs")
        equal[tag] = dict(bitwise=True, rays=rays, capture_s=g.capture_s,
                          pool_bytes=g.pool_bytes, replay_launches=g.launches)
        log(f"  [{card}] {tag}: replay bit-equal to the eager frame, rays {rays}; capture "
            f"{g.capture_s * 1e3:.1f} ms, pool {g.pool_bytes} B, a replay launches "
            f"{ {k: v for k, v in g.launches.items() if v} }")
    out["equal"] = equal

    # (b) The preview's orbit: camera changes replay one graph.
    renderer = renderers["wavefront"]
    scene, settings = load("glass_sphere")
    settings = sized(settings)
    renderer.render_to_device(scene, settings)
    g = renderer._graph[2]
    frames = []
    for i in range(ORBIT_FRAMES):
        s_i = settings.replace(camera_rotation_override=(0.0, 0.0, i * ORBIT_DEG))
        frames.append((renderer.render_to_device(scene, s_i), renderer.last_stats.rays_traced,
                       s_i))
    check(renderer._graph[2] is g, "a camera change captured a new graph")
    for i, (img, rays, s_i) in enumerate(frames):
        held(f"orbit frame {i}", img, rays, renderer, scene, s_i)
    check(not torch.equal(frames[0][0], frames[1][0]), "the orbit's frames are all alike")
    out["orbit"] = dict(frames=ORBIT_FRAMES, deg=ORBIT_DEG, captures=1,
                        rays=[f[1] for f in frames])
    log(f"  [{card}] {ORBIT_FRAMES}-frame orbit ({ORBIT_DEG} deg a frame): one capture, "
        "every replay bit-equal to its eager frame")
    del frames

    # (c) Two renderers on two scenes, interleaved, every frame kept.
    pair = [(cosig_tpu_torch.Renderer(device="cuda", backend="wavefront"), *load("mirror_sphere")),
            (cosig_tpu_torch.Renderer(device="cuda", backend="megakernel"), *load("cosig_walls"))]
    kept = []
    for i in range(4):
        for r, sc, st in pair:
            st = sized(st).replace(camera_rotation_override=(0.0, 5.0 * i, 3.0 * i))
            kept.append((r, sc, st, r.render_to_device(sc, st), r.last_stats.rays_traced))
    for i, (r, sc, st, img, rays) in enumerate(kept):
        held(f"interleaved frame {i}", img, rays, r, sc, st)
    out["interleaved"] = dict(renderers=2, frames=len(kept))
    log(f"  [{card}] two renderers interleaved on mirror_sphere and cosig_walls: "
        f"{len(kept)} kept frames, each bit-equal to its eager frame")
    del kept, pair

    # (d) render_chain: k frames, k times the rays, the frame's image.
    chains = {}
    for backend, renderer in renderers.items():
        scene, settings = load("glass_sphere")
        settings = sized(settings)
        single = renderer.render_to_device(scene, settings)
        rays1 = renderer.last_stats.rays_traced
        ms = {}
        for k in CHAIN_KS:
            img, rays = renderer.render_chain(scene, settings, k)
            check(torch.equal(img, single) and rays == k * rays1, backend, "render_chain k", k,
                  rays, rays1)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                renderer.render_chain(scene, settings, k)
                times.append((time.perf_counter() - t0) * 1e3)
            ms[k] = sorted(times)[1]
        cset, uni, lights, cfg, pk = inputs(renderer, scene, settings)
        module = tm.render_chain if backend == "megakernel" else tw.render_chain
        img, rays = module(cset, uni, lights, cfg, 2, **pk)
        check(torch.equal(img, single) and rays == 2 * rays1, backend, "module render_chain")
        lo, hi = CHAIN_KS
        chains[backend] = dict(ms={str(k): v for k, v in ms.items()}, rays=rays1,
                               slope_ms=(ms[hi] - ms[lo]) / (hi - lo))
        log(f"  [{card}] glass_sphere {backend} render_chain: k={lo} {ms[lo]:.3f} ms, "
            f"k={hi} {ms[hi]:.3f} ms (medians of 3), {chains[backend]['slope_ms']:.4f} ms/frame "
            f"from the slope; images and k x {rays1} rays as the single frame's")
    out["render_chain"] = chains

    # (e) Eager against graph, in turns on this card.
    reps = GRAPH_TURN_FRAMES
    timed_cases = [(name, b) for name in RECORDS for b in renderers]
    if full_size:
        timed_cases += [("dense_knot", b) for b in renderers]
    times = {}
    for name, backend in timed_cases:
        renderer = renderers[backend]
        scene, settings = load(name)
        settings = sized(settings)
        renderer.render_to_device(scene, settings)  # capture
        g = renderer._graph[2]
        cset, uni, lights, cfg, pk = inputs(renderer, scene, settings)
        n = 4 if name == "dense_knot" else reps

        def eager_frame():
            return eager(renderer, scene, settings)

        def graph_frame():
            return renderer.render_to_device(scene, settings)

        def wall(fn) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        def queue(fn) -> float:
            """The host's ms to queue one frame (no read), then the wait."""
            total = 0.0
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                total += time.perf_counter() - t0
                torch.cuda.synchronize()
            return total * 1e3 / n

        eager_frame(), graph_frame()
        turns = [("eager", wall(eager_frame)), ("graph", wall(graph_frame)),
                 ("graph", wall(graph_frame)), ("eager", wall(eager_frame))]
        host_e = queue(lambda: eager(renderer, scene, settings, rays_on_device=True))
        host_g = queue(lambda: g.replay(uni, lights))
        want = sum(v for k, v in g.launches.items() if k != "graph")
        calls = {}
        acts_g, tries_g = traced(graph_frame, want, calls)
        check(calls.get("cudaGraphLaunch", 0) == 1, name, backend, "graph launches", calls)
        to_host = [a for a in acts_g if "DtoH" in a[0]]
        check(len(to_host) <= 1, name, backend, "device-to-host copies in a graph frame",
              to_host)
        # The replay's copies of its outputs: the image's is the longest
        # device-to-device copy of the frame.
        copy_ms = max((a[2] for a in acts_g if "DtoD" in a[0]), default=None)
        ms_e = [t for w, t in turns if w == "eager"]
        ms_g = [t for w, t in turns if w == "graph"]
        tag = f"{backend} {tag_of(name, cfg)}"
        times[tag] = dict(eager_ms=ms_e, graph_ms=ms_g, host_ms_eager=host_e, host_ms_graph=host_g,
                          traces_graph=tries_g,
                          frames_per_turn=n, graph_runtime_calls=calls, kernels=want,
                          image_copy_ms=copy_ms,
                          capture_s=g.capture_s, pool_bytes=g.pool_bytes)

        log(f"  [{card}] {tag}: ms/frame eager {ms_e[0]:.3f} / {ms_e[1]:.3f}, graph "
            f"{ms_g[0]:.3f} / {ms_g[1]:.3f}; host ms to queue a frame eager {host_e:.3f}, graph "
            f"{host_g:.3f}; {tries_g} traces; the image's copy {copy_ms} ms; pool "
            f"{g.pool_bytes} B, capture {g.capture_s * 1e3:.1f} ms; runtime calls of a graph "
            f"frame {calls}")
    out["times"] = times
    del renderers
    torch.cuda.empty_cache()
    return out


# Phase 10: the wavefront's fission form (trace and shade kernels, the hit
# record in state rows 15-19) and its separate primary and shadow cluster
# sets (cosig_tpu/ops/trace_wavefront.py:115-135, :247-267, :716-888).
# Cluster sizes of the forms' sets per scene: a finer primary cut and a
# coarser shadow cut within one cull block (the dense knot's first such cut
# is k = 1024, 298 clusters: knot_shadow_k finds it among KNOT_SHADOW_KS;
# its walk goes in slots of the main walk's 128 rows).
FORM_KS = {"glass_sphere": dict(primary=8, shadow=64), "large_mesh": dict(primary=16, shadow=128),
           "dense_knot": dict(primary=32, shadow=1024)}
KNOT_SHADOW_KS = (512, 1024)
# Phase 10a's sets past 128 rows (the builds whose walk has slots): a
# main set at k = 512 (with a primary set of 128 rows and a shadow set of
# 1024), and a shadow set at k = 1024 behind the scene's own k = 64.
SLOT_KS = dict(main=512, primary=128, shadow=1024)
# name -> (fission, primary set, shadow set)
FORMS = {"fission": (True, False, False), "primary set": (False, True, False),
         "shadow set": (False, False, True), "all": (True, True, True)}
FORM_TURNS = 2
# The new kernel builds, their counters and the TPU kernel form each replaces.
FORM_KERNELS = {
    "trace": "cosig_tpu/ops/trace_wavefront.py:439 _make_bounce_kernel(mode=\"trace\")",
    "shade": "cosig_tpu/ops/trace_wavefront.py:439 _make_bounce_kernel(mode=\"shade\")",
    "primary_fission": "cosig_tpu/ops/trace_wavefront.py:293 _make_primary_kernel(fission=True)",
    "primary_shadow": "cosig_tpu/ops/trace_wavefront.py:247 _make_shadow_traverse in "
                      "_make_primary_kernel",
    "bounce_shadow": "cosig_tpu/ops/trace_wavefront.py:247 _make_shadow_traverse in "
                     "_make_bounce_kernel",
}


def form_kwargs(sets: dict, form: str) -> dict:
    """The render keywords of ``form`` over the sets of form_sets, or None
    where the scene has no such set."""
    fission, primary, shadow = FORMS[form]
    if (primary and "primary" not in sets) or (shadow and "shadow" not in sets):
        return None
    return dict(fission=fission, cset_primary=sets["primary"] if primary else None,
                cset_shadow=sets["shadow"] if shadow else None)


def form_launches(max_depth: int, forms: dict) -> dict:
    """Launches of one wavefront frame in the form ``forms``."""
    d = max_depth - 1
    if forms["fission"]:
        return dict(primary_fission=1, shade=1 + d, compact=d, trace=d)
    if forms["cset_shadow"] is not None:
        return dict(primary_shadow=1, compact=d, bounce_shadow=d)
    return wavefront_launches(max_depth)


def check_form_stages(s: dict, forms: dict, tag: str, mxu: str = "off", band=None) -> list:
    """The wavefront chain of one frame in the form ``forms`` with each
    kernel held bit for bit to its plain version on the same input state
    (all rows, the hit record's included) and each compaction list to the
    plain one as integers; then the frame's image and rays to the fused
    single-set kernels' -> the list lengths. ``band``: (rows, row_offset),
    a band of the frame's rows. With ``mxu`` ("full" or
    "closest", phase 12) every stage runs the tensor-core form and a kernel
    is held to its plain version by hold_mx (rows 0-12 and the record's
    15-19, flips counted) instead, and the frame, bit for bit, to the fused
    tensor-core kernels' frame of the mode the form's arithmetic gives:
    ``mxu``'s own, or "closest" with a separate shadow set (whose shadow
    rays are exact)."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import kernel_core as kc
    from cosig_tpu_torch.ops import trace_wavefront as tw

    cset, cfg = s["cset"], s["cfg"]
    rows, row_off = band if band else (cfg.height, 0)
    uni, lights, mats, prims, n_sph, n_box = tw.frame_inputs(
        cset, s["uni"], s["lights"], row_off, None, s["prims"], s["prim_counts"])
    pk = (prims, n_sph, n_box)
    fb = binding.frame_buffer(cset.device, uni, mats, lights)
    fission, csp, css = forms["fission"], forms["cset_primary"], forms["cset_shadow"]
    pcs = cset if csp is None else csp
    p_sh, b_sh = (pcs if css is None else css), (cset if css is None else css)
    sh_mxu = mxu if css is None else "off"  # the shade's shadow rays: exact on a shadow set

    def same(stage, st_k, st_p):
        if mxu == "off":
            ok, mx, _ = diff(st_k, st_p)
            check(ok, tag, stage, "kernel not bit-equal to its plain version", mx)
            return
        hold_mx(f"{tag} {mxu} {stage}", cfg, mx_state_rows(st_k), mx_state_rows(st_p),
                int(st_k[kc.ROW_COUNT].sum()), int(st_p[kc.ROW_COUNT].sum()), st_k.shape[1])

    prim_sh = None if fission else css
    st = kw.primary(pcs, fb, cfg, rows, *pk, fission=fission, cset_shadow=prim_sh, mxu=mxu)
    same("primary", st, tw.primary_stage(pcs, uni, mats, lights, cfg, rows, *pk,
                                         fission=fission, cset_shadow=prim_sh, mxu=mxu))
    if fission:
        ref = st.clone()
        kw.shade(st, None, None, p_sh, fb, cfg, 0, *pk, mxu=sh_mxu)
        tw.primary_shade(ref, p_sh, uni, mats, lights, cfg, *pk, mxu=sh_mxu)
        same("shade of the primary", st, ref)
    lengths = []
    for d in range(1, cfg.max_depth):
        idx, n_live = kw.compact(st)
        idx_p, n_p = tw.compact_plain(st)
        m = int(n_live)
        check(m == int(n_p) and bool((idx[:m] == idx_p[:m]).all()), tag, "list at depth", d)
        lengths.append(m)
        ref = st.clone()
        if fission:
            kw.trace(st, idx, n_live, cset, fb, cfg, d, *pk, mxu=mxu)
            tw.trace_listed_stage(ref, idx, n_live, cset, *pk, mxu=mxu)
            same(f"trace at depth {d}", st, ref)
            ref = st.clone()
            kw.shade(st, idx, n_live, b_sh, fb, cfg, d, *pk, mxu=sh_mxu)
            tw.shade_listed_stage(ref, idx, n_live, b_sh, uni, mats, lights, cfg, d, *pk,
                                  mxu=sh_mxu)
            same(f"shade at depth {d}", st, ref)
        else:
            kw.bounce(st, idx, n_live, cset, fb, cfg, d, *pk, cset_shadow=css, mxu=mxu)
            tw.bounce_listed_stage(ref, idx, n_live, cset, uni, mats, lights, cfg, d, *pk,
                                   cset_shadow=css, mxu=mxu)
            same(f"bounce at depth {d}", st, ref)
    img, rays = tw.finalize(st, cfg, rows)
    fused = "off" if mxu == "off" else "closest" if css is not None else mxu
    img0, rays0 = tw.render_wavefront(cset, s["uni"], s["lights"], cfg, rows=rows,
                                      row_offset=row_off, prims=s["prims"],
                                      prim_counts=s["prim_counts"], mxu=fused)
    if not (torch.equal(img, img0) and rays == rays0):
        log(f"  {tag} {mxu}: frame apart from the fused {fused} frame at pixels "
            f"{torch.nonzero((img - img0).abs().amax(dim=2) > 0)[:8].tolist()}")
    check(torch.equal(img, img0) and rays == rays0, tag, mxu,
          "frame differs from the fused", fused, "frame")
    return lengths


def form_small(device) -> dict:
    """Phase 10a: every new kernel against its plain version, bit for bit,
    stage by stage (check_form_stages) on small frames: glass_sphere,
    large_mesh with its clusters cut 4 ways (c_pad 1024: the superblock
    builds), the dense knot at 128x128, depth 3, the analytic mixed scene
    and cosig_walls, and the tiny scene with soft shadows, glossy and AA
    2 (the shade's RNG). The knot's primary set (9,447 clusters) is held
    to the fused frame at full size (form_frames). Then the sizes past 128
    rows (slot_sizes)."""
    effects = dict(aa_samples=2, enable_soft_shadows=True, light_size=5.0, enable_glossy=True,
                   surface_roughness=0.05)
    cases = [
        ("glass_sphere", dict(resolution_override=(96, 96)), False, 1, ("all", "shadow set")),
        ("large_mesh", dict(resolution_override=(128, 96)), False, 4, ("all", "shadow set")),
        ("dense_knot", dict(resolution_override=(128, 128), max_depth=3), False, 1,
         ("fission",)),
        ("mixed", dict(resolution_override=(64, 48), max_depth=3), True, 1, ("all", "shadow set")),
        ("cosig_walls", dict(resolution_override=(128, 128), max_depth=2), True, 1,
         ("fission", "all")),
        ("tiny", dict(resolution_override=(64, 64), max_depth=3, **effects), False, 1,
         ("fission", "all", "shadow set")),
    ]
    out = {}
    for name, kw_, analytic, split, forms in cases:
        t0 = time.perf_counter()
        s = scene_setup(name, kw_, device, analytic)
        k = s["cset"].k
        ks = dict(FORM_KS.get(name, dict(primary=max(4, k // 4), shadow=2 * k)))
        if name == "large_mesh":
            s["cset"] = split_clusters(s["cset"], split)
        sets = form_sets(s, ks, device)
        tag = tag_of(name, s["cfg"], analytic) + (f" split {split}" if split > 1 else "")
        for form in forms:
            f = form_kwargs(sets, form)
            lengths = check_form_stages(s, f, f"{tag} {form}")
            out[f"{tag} {form}"] = dict(lists=lengths, clusters=s["cset"].num_clusters,
                                        c_pad=int(s["cset"].aabb_t.shape[1]),
                                        sets={n: (c.num_clusters, c.k, int(c.aabb_t.shape[1]))
                                              for n, c in sets.items()})
        log(f"  {tag} (clusters {s['cset'].num_clusters}, c_pad {s['cset'].aabb_t.shape[1]}; "
            + ", ".join(f"{n} set {c.num_clusters} of k = {c.k}, c_pad {c.aabb_t.shape[1]}"
                        for n, c in sets.items())
            + f"): forms {forms}: every kernel bit-equal to its plain version, lists equal, "
            f"frames equal to the fused one ({time.perf_counter() - t0:.1f} s)")
    out.update(form_edges(device))
    out.update(slot_sizes(device))
    return out


def form_edges(device) -> dict:
    """Phase 10a's edges of the compacted walks in the fission form, stage
    by stage (check_form_stages): demo_cornell at 61 x 37 d3, AA 1, 3 and 4
    (partial blocks of rays and of each depth's list, non-power-of-two AA)
    and as a band of rows 9..29, on the scene's own 32-row clusters (one
    slot each) and on a 64-row cut (two slots each)."""
    out = {}
    t0 = time.perf_counter()
    f = form_kwargs({}, "fission")
    for aa in (1, 3, 4):
        s = scene_setup("demo_cornell", dict(resolution_override=(61, 37), max_depth=3,
                                             aa_samples=aa), device)
        for cset in (s["cset"], form_sets(s, dict(k=64), device)["k"]):
            tag = f"{tag_of('demo_cornell', s['cfg'])} k = {cset.k} fission"
            sk = dict(s, cset=cset)
            out[tag] = check_form_stages(sk, f, tag)
            out[f"{tag} rows 9..29"] = check_form_stages(sk, f, f"{tag} rows 9..29",
                                                         band=(21, 9))
    log(f"  demo_cornell 61x37 d3 AA 1/3/4 at k = 32 and 64, whole and rows 9..29: the "
        f"fission form's kernels bit-equal to their plain versions, frames equal to the "
        f"fused one ({time.perf_counter() - t0:.1f} s)")
    return out


def slot_sizes(device) -> dict:
    """Phase 10a's sizes past 128 rows (SLOT_KS; every k JAX's
    build_clusters takes), on large_mesh at 128x96 d4, each kernel bit for
    bit against its plain version stage by stage (check_form_stages) and
    each form's frame against the fused one: a main set at k = 512 in the
    fused form, every other form (its primary set of 128 rows and shadow
    set of 1024) and the tensor-core form in full mode, then its
    megakernel and debug kernel (compare_case); the scene's own k = 64
    with a shadow set at k = 1024."""
    out = {}
    kw_ = dict(resolution_override=(128, 96), max_depth=4)
    t0 = time.perf_counter()
    s = scene_setup("large_mesh", kw_, device)
    own_k = s["cset"].k
    sets = form_sets(s, SLOT_KS, device)
    main = sets.pop("main")
    base = tag_of("large_mesh", s["cfg"])
    fused = dict(fission=False, cset_primary=None, cset_shadow=None)
    for label, cset, forms in ((f"main k = {main.k}", main,
                                ("fused", "fission", "primary set", "shadow set", "all")),
                               (f"k = {own_k}", s["cset"], ("shadow set", "all"))):
        sm = dict(s, cset=cset)
        for form in forms:
            f = fused if form == "fused" else form_kwargs(sets, form)
            tag = f"{base} {label} {form}"
            out[tag] = dict(lists=check_form_stages(sm, f, tag),
                            sets={n: (c.num_clusters, c.k, int(c.aabb_t.shape[1]))
                                  for n, c in dict(sets, main=cset).items()})
        log(f"  {base} {label} (clusters {cset.num_clusters}; sets "
            + ", ".join(f"{n} {c.num_clusters} of k = {c.k}, c_pad {c.aabb_t.shape[1]}"
                        for n, c in sets.items())
            + f"): forms {forms}: every kernel bit-equal to its plain version, frames equal to "
            f"the fused one ({time.perf_counter() - t0:.1f} s)")
    sm = dict(s, cset=main)
    for form in ("fused", "fission"):
        f = dict(fused, fission=form == "fission")
        tag = f"{base} main k = {main.k} {form}"
        out[f"{tag} full"] = check_form_stages(sm, f, tag, mxu="full")
    log(f"  {base} main k = {main.k}: the tensor-core builds (full mode) within phase 11's gates, "
        f"frames bit-equal to the fused tensor-core frame ({time.perf_counter() - t0:.1f} s)")
    compare_case(device, "large_mesh", kw_, False, exact=True, k=main.k)
    log(f"  {base} main k = {main.k}: megakernel and debug modes 1-3 bit-equal to their plain "
        f"frames ({time.perf_counter() - t0:.1f} s)")
    return out


def knot_shadow_k(device) -> dict:
    """The dense knot's shadow set: the smallest k of KNOT_SHADOW_KS whose
    cut fits one cull block, which must be phase 10b's (FORM_KS), and
    whether the block walk's shared memory over it (walk_layout.h: slots
    of at most 128 rows, so 70,064 B; a ring of whole clusters, 3 x k x
    144 B, outgrew the card past k = 503) fits what a block may opt into
    on this card."""
    import torch

    from cosig_tpu_torch.kernels import binding

    s = scene_setup("dense_knot", dict(resolution_override=(8, 8)), "cpu")
    optin = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    out = {"optin_bytes": optin}
    for k in KNOT_SHADOW_KS:
        c = form_sets(s, dict(k=k), "cpu")["k"]
        smem = binding.library().cosig_tile_smem_bytes(k)
        out[str(k)] = dict(clusters=c.num_clusters, c_pad=int(c.aabb_t.shape[1]),
                           one_block=int(c.aabb_t.shape[1]) <= 512, smem_bytes=smem,
                           fits=smem <= optin)
        if out[str(k)]["one_block"]:
            out["k"] = k
            break
    log(f"  dense knot shadow set: {out} (a block may opt into {optin} B)")
    k = out.get("k")
    check(k == FORM_KS["dense_knot"]["shadow"] and out[str(k)]["fits"],
          "the dense knot's shadow set", out, "is not phase 10b's, or does not fit")
    return out


def form_frames(device, card: str, full_size: bool = True) -> dict:
    """Phase 10b, the forms' main path: glass_sphere (1024x1024, d6, AA 4),
    large_mesh (2048x2048, d4) and the dense knot (2048x2048, d4), each in
    every form its sets allow, eager (render_wavefront) and as a CUDA
    graph (FrameGraph), bit-equal to the fused single-set eager frame,
    image and rays; the launch counters set to 0 just before each form's
    frames and read just after; then each graph's render_chain slope
    (k = 2 and 12) against the fused frame's graph, in turns."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.ops import frame_graph
    from cosig_tpu_torch.ops import trace_wavefront as tw

    out = {"launches": {}, "frames": {}}
    totals = out["launches"]
    scenes = ("glass_sphere", "large_mesh", "dense_knot") if full_size else ("glass_sphere",)
    for name in scenes:
        s = scene_setup(name, {} if full_size else dict(resolution_override=(96, 96)), device)
        cset, cfg, uni, lights = s["cset"], s["cfg"], s["uni"], s["lights"]
        pk = dict(prims=s["prims"], prim_counts=s["prim_counts"])
        sets = form_sets(s, FORM_KS[name], device)
        tag = tag_of(name, cfg)
        img0, rays0 = tw.render_wavefront(cset, uni, lights, cfg, **pk)
        graphs = {"fused": frame_graph.FrameGraph("wavefront", cset, cfg, uni, lights, **pk)}
        rec = {"sets": {n: (c.num_clusters, c.k, int(c.aabb_t.shape[1]))
                        for n, c in sets.items()}}
        # Blocks per multiprocessor of each build at this scene's sets (the
        # shadow builds hold the main walk's shared memory: walk_layout.h both_smem).
        c, k = cset.num_clusters, cset.k
        occ = {n: binding.occupancy(n, c, k, device)
               for n in ("primary", "bounce", "trace", "primary_fission")}
        if "primary" in sets:
            occ["primary (primary set)"] = binding.occupancy(
                "primary", sets["primary"].num_clusters, sets["primary"].k, device)
        walk_sh = sets.get("shadow", cset)
        occ["shade"] = binding.occupancy("shade", walk_sh.num_clusters, walk_sh.k, device)
        if "shadow" in sets:
            for n in ("primary_shadow", "bounce_shadow"):
                occ[n] = binding.occupancy(n, c, k, device, shadow_k=sets["shadow"].k)
        rec["blocks_per_sm"] = occ
        rec["smem_bytes"] = {n: binding.library().cosig_tile_smem_bytes(c.k)
                             for n, c in dict(sets, main=cset).items()}
        log(f"  [{card}] {tag_of(name, cfg)}: blocks per multiprocessor {occ}; block walk "
            f"shared memory {rec['smem_bytes']} B")
        for form in FORMS:
            f = form_kwargs(sets, form)
            if f is None:
                continue
            binding.reset_counts()
            img, rays = tw.render_wavefront(cset, uni, lights, cfg, **pk, **f)
            eager = {k: v for k, v in binding.LAUNCHES.items() if v}
            g = frame_graph.FrameGraph("wavefront", cset, cfg, uni, lights, **pk, **f)
            img_g, rays_g = g.replay(uni, lights)
            got = {k: v for k, v in binding.LAUNCHES.items() if v}
            for k, v in got.items():
                totals[k] = totals.get(k, 0) + v
            want = form_launches(cfg.max_depth, f)
            check(eager == want, tag, form, "eager launches", eager, "expected", want)
            check({k: v for k, v in g.launches.items() if v} == dict(want, graph=1), tag, form,
                  "graph launches", g.launches)
            check(torch.equal(img, img0) and int(rays) == int(rays0), tag, form,
                  "eager frame differs from the fused frame")
            check(torch.equal(img_g, img0) and int(rays_g) == int(rays0), tag, form,
                  "graph replay differs from the fused frame")
            graphs[form] = g
            rec[form] = dict(launches=got, pool_bytes=g.pool_bytes, capture_s=g.capture_s)
            log(f"  [{card}] {tag} {form}: eager and replayed frames bit-equal to the fused "
                f"frame ({rays0} rays); launches {got}; pool {g.pool_bytes} B")
        del img0
        # Device ms per frame: the slope of render_chain over CHAIN_KS, each
        # graph in turns with the fused one.
        lo, hi = CHAIN_KS
        slopes = {n: [] for n in graphs}
        for _ in range(FORM_TURNS):
            for n, g in graphs.items():
                ms = {}
                for k in (lo, hi):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    g.chain(uni, lights, k)
                    ms[k] = (time.perf_counter() - t0) * 1e3
                slopes[n].append((ms[hi] - ms[lo]) / (hi - lo))
        rec["slope_ms"] = slopes
        log(f"  [{card}] {tag} render_chain slope, ms/frame in {FORM_TURNS} turns: "
            + "; ".join(f"{n} " + " / ".join(f"{v:.3f}" for v in vs) for n, vs in slopes.items()))
        out["frames"][tag] = rec
        del graphs, sets, cset
        torch.cuda.empty_cache()
    return out


def form_kernel_times(device) -> list:
    """Phase 10c: the new kernels alone against their plain versions, with
    the fused kernel of the same stage on the same input in this call: the
    primary stage of glass_sphere (the fission primary and the shade over
    every ray, per-warp on its 32-row clusters; the primary with the shadow
    set) and of large_mesh (the fission primary and the shade over every
    ray, compacted on its 64-row clusters), then glass_sphere's depth 1 and
    large_mesh's depths 1-3 (trace, shade, the bounce with the shadow set;
    plain versions timed at each). Bounds from
    the plain versions' counted work (WORK) and the bytes each kernel must
    move; each row with its build's blocks per multiprocessor (the shade
    over every ray: shade_all's) -> the kernels line's rows. The parent's
    times of the same rows: ``--time-kernels`` on the parent's tree, in
    turns with this one's."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import kernel_core as kc
    from cosig_tpu_torch.ops import trace_wavefront as tw

    forms_cu = ("cosig_tpu_torch/csrc/forms.cu + csrc/wavefront.cuh + csrc/traverse_tile.cuh "
                "+ csrc/walk_layout.h")
    rows = {}

    def row(name, tag, run_k, copies_k, run_p, nbytes, fused_ms=None, build=None):
        """Time ``run_k(state)`` on fresh copies; hold it to ``run_p(state)``
        once; the bound from the plain run's WORK; ``build``: the build's
        name for its blocks per multiprocessor, if not ``name``."""
        st_k = run_k(copies_k.pop())
        kc.reset_work()
        st_p, plain_ms = timed(lambda: run_p(copies_k.pop()))
        bound = work_bound(dict(kc.WORK), nbytes)
        same, mx, _ = diff(st_k, st_p)
        check(same, name, tag, "kernel not bit-equal to its plain version", mx)
        del st_p
        ms = device_ms(lambda: run_k(copies_k.pop()), 3)
        r = dict(at=tag, ms=ms, fused_ms=fused_ms, plain_ms=plain_ms, max_abs_err=mx,
                 bound_ms=bound["bound_ms"], bound_by=bound["bound_by"], work=bound["work"],
                 blocks_per_sm=occ.get(build or name))
        log(f"  {name} ({tag}): {ms:.4f} ms on the card"
            + (f", the fused kernel {fused_ms:.4f} ms" if fused_ms is not None else "")
            + f"; plain {plain_ms:.1f} ms, bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']}; {bound['work']})")
        if name not in rows:
            rows[name] = dict(name=name, route="cuda", source=forms_cu,
                              replaces=FORM_KERNELS[name], library_ms=None, **r)
        else:
            rows[name].setdefault("more", []).append(r)
        return st_k

    for name in ("glass_sphere", "large_mesh"):
        s = scene_setup(name, {}, device)
        cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
        mats = cset.mats_host
        fb = binding.frame_buffer(cset.device, uni, mats, lights)
        pk = kc.prim_table(None, (0, 0), device)
        sh = form_sets(s, dict(shadow=FORM_KS[name]["shadow"]), device)["shadow"]
        geom = 4 * (cset.geom.numel() + cset.aabb_t.numel())
        geom_sh = 4 * (sh.geom.numel() + sh.aabb_t.numel())
        band, n = cfg.height, kc.state_rows(False)
        tag = f"{name} {cfg.width}x{cfg.height} d{cfg.max_depth} aa{cfg.aa_samples}"
        glass = name == "glass_sphere"
        c, k = cset.num_clusters, cset.k
        occ = {n_: binding.occupancy(n_, c, k, device, shadow_k=sh.k)
               for n_ in ("bounce", "trace", "shade", "shade_all", "primary_fission",
                          "bounce_shadow", "primary_shadow")}
        log(f"  {tag}: blocks per multiprocessor {occ} (the shadow set's k = {sh.k}; shared "
            f"memory: walk {binding.library().cosig_tile_smem_bytes(k)} B, trace "
            f"{binding.library().cosig_trace_smem_bytes(k)} B)")
        # The primary stage: fused, fission, with the shadow set.
        st16 = kw.primary(cset, fb, cfg, band, *pk)
        n_rays = st16.shape[1]
        fused_ms = device_ms(lambda: kw.primary(cset, fb, cfg, band, *pk), 3)
        row("primary_fission", tag, lambda _: kw.primary(cset, fb, cfg, band, *pk, fission=True),
            [None] * 6, lambda _: tw.primary_stage(cset, uni, mats, lights, cfg, band, *pk,
                                                  fission=True),
            geom + 4 * n_rays * (6 + 14), fused_ms=fused_ms)
        if glass:
            row("primary_shadow", tag, lambda _: kw.primary(cset, fb, cfg, band, *pk,
                                                           cset_shadow=sh),
                [None] * 6, lambda _: tw.primary_stage(cset, uni, mats, lights, cfg, band, *pk,
                                                      cset_shadow=sh),
                geom + geom_sh + 4 * n_rays * 16, fused_ms=fused_ms)
        st24 = kw.primary(cset, fb, cfg, band, *pk, fission=True)

        def shade_all(st):
            kw.shade(st, None, None, cset, fb, cfg, 0, *pk)
            return st

        def shade_all_p(st):
            tw.primary_shade(st, cset, uni, mats, lights, cfg, *pk)
            return st

        row("shade", f"{tag}, the primary stage over all rays", shade_all,
            [st24.clone() for _ in range(5)], shade_all_p,
            geom + 4 * n_rays * (13 + 5 + 14), fused_ms=fused_ms, build="shade_all")
        del st24
        # The bounces: the fused bounce, trace then shade, the shadow-set bounce.
        st24 = torch.zeros((kc.FISSION_ROWS, n_rays), dtype=torch.float32, device=device)
        st24[:n] = st16
        for d in range(1, cfg.max_depth if not glass else 2):
            idx, n_live = kw.compact(st16)
            live = int(n_live)
            copies = [st16.clone() for _ in range(4)]
            fused_ms = device_ms(lambda: kw.bounce(copies.pop(), idx, n_live, cset, fb, cfg, d,
                                                   *pk), 3)
            at = f"{tag}, depth {d} ({live} live rays)"
            rows_io = 4 * live * (13 + 14 + 1) + 4

            def bounce_sh(st):
                kw.bounce(st, idx, n_live, cset, fb, cfg, d, *pk, cset_shadow=sh)
                return st

            def bounce_sh_p(st):
                tw.bounce_listed_stage(st, idx, n_live, cset, uni, mats, lights, cfg, d, *pk,
                                       cset_shadow=sh)
                return st

            row("bounce_shadow", at, bounce_sh, [st16.clone() for _ in range(5)], bounce_sh_p,
                geom + geom_sh + rows_io, fused_ms=fused_ms)

            def trace(st):
                kw.trace(st, idx, n_live, cset, fb, cfg, d, *pk)
                return st

            def trace_p(st):
                tw.trace_listed_stage(st, idx, n_live, cset, *pk)
                return st

            traced_st = row("trace", at, trace, [st24.clone() for _ in range(5)], trace_p,
                            geom + 4 * live * (7 + 6 + 1) + 4, fused_ms=fused_ms)

            def shade(st):
                kw.shade(st, idx, n_live, cset, fb, cfg, d, *pk)
                return st

            def shade_p(st):
                tw.shade_listed_stage(st, idx, n_live, cset, uni, mats, lights, cfg, d, *pk)
                return st

            row("shade", at, shade, [traced_st.clone() for _ in range(5)], shade_p,
                geom + 4 * live * (13 + 5 + 14 + 1) + 4, fused_ms=fused_ms)
            # The next depth's input: the fused bounce, and the fission state from it.
            kw.bounce(st16, idx, n_live, cset, fb, cfg, d, *pk)
            st24[:n] = st16
            del copies, traced_st
        del st16, st24, cset, sh
        torch.cuda.empty_cache()
    return list(rows.values())


def form_phase(device, card: str, full_size: bool = True) -> dict:
    """Phase 10 (form_small, knot_shadow_k, form_frames, form_kernel_times)."""
    out = {"small": form_small(device)}
    if full_size:
        out["knot_shadow"] = knot_shadow_k(device)
    out.update(form_frames(device, card, full_size))
    if full_size:
        out["kernels"] = form_kernel_times(device)
    return out


# ---- phase 11: the tensor-core form of the pair test (mxu) ----

# The gates of phase 11. The kernel's planes against the float64 sums of
# the same limb products: tests/test_pallas.py:482's bound, 1e-6 of the
# sum of |coefficient x input| over a plane's terms. The frames against
# the plain tensor-core versions: the slice tolerances, with pixels (rays,
# in a stage's state) more than FLIP_ABS apart counted as flips (a plane an
# ulp away from the plain one can turn a grazing pair's validity), at most
# FLIP_SHARE of a frame's.
MX_PLANE_REL = 1e-6
FLIP_ABS = 1e-3
FLIP_SHARE = 1e-4  # 0.01 %
MX_MODES = {"wavefront": ("full", "closest"), "megakernel": ("full",)}
# The bound of a tensor-core kernel: the limb products a pair needs
# (kernel_core.MX_PRODUCTS, 147: those not zero by construction, fewer
# than the 5 x 48 the kernel's wgmma tiles issue) over the dense bf16 rate
# (989 TFLOP/s, 494.5 T multiply-adds/s), plus its fp32 operations (the
# slab, pre-filter and primitive tests as above, and about 15 a pair for
# the selection: a reciprocal, t, 9 compares and the fold) over
# PEAK_F32_OPS; or its bytes over HBM_BYTES_PER_S, whichever is larger.
MX_SEL_OPS_PER_PAIR = 15
PEAK_BF16_MACS = 989e12 / 2
MX_REPLACES = "cosig_tpu/ops/kernel_core.py:776 mt_mxu + :633 mxu_sel, in "
MX_KERNELS = {
    "primary_mx": ("cosig_tpu_torch/csrc/mx.cu + csrc/wavefront.cuh + csrc/mx_pair.cuh",
                   MX_REPLACES + "trace_wavefront.py:293 _make_primary_kernel"),
    "bounce_mx": ("cosig_tpu_torch/csrc/mx.cu + csrc/wavefront.cuh + csrc/mx_pair.cuh",
                  MX_REPLACES + "trace_wavefront.py:439 _make_bounce_kernel"),
    "megakernel_mx": ("cosig_tpu_torch/csrc/megakernel.cu + csrc/mx_pair.cuh",
                      MX_REPLACES + "trace_pallas.py:132 _make_kernel"),
}
MX_EXACT = {"primary_mx": "primary", "bounce_mx": "bounce", "megakernel_mx": "megakernel"}
MX_DESIGN = ("block walk; the block's warpgroup issues wgmma m64n32k16 + m64n8k16 bf16 per "
             "8-row n-tile, the two 64-ray m-tiles one after the other, the ray limbs in "
             "registers, the geometry split once per block into a double-buffered "
             "shared-memory B tile; a running winner per fragment row")
MX_TURNS = 2


def mx_bound(work: dict, nbytes: int) -> dict:
    """Bound of one tensor-core kernel call from the plain traversal's
    counted work (mx=True) and the bytes it must move."""
    from cosig_tpu_torch.ops.kernel_core import MX_PRODUCTS

    pairs = work["pair_tests"]
    f32 = (FLOPS_PER_SLAB * work["slab_tests"] + MX_SEL_OPS_PER_PAIR * pairs
           + FLOPS_PER_PRIM * work["prim_tests"]
           + FLOPS_PER_FRUSTUM * (work["frustum_tests"] + work["superblock_tests"]))
    op_ms = (MX_PRODUCTS * pairs / PEAK_BF16_MACS + f32 / PEAK_F32_OPS) * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes",
                work=dict(work, macs=MX_PRODUCTS * pairs, f32_ops=f32, bytes=nbytes))


def mx_split(cset, ways: int):
    """split_clusters with the tensor-core operand packed for the split rows."""
    from dataclasses import replace

    from cosig_tpu_torch.accel.clusters import pack_mx

    out = split_clusters(cset, ways)
    return replace(out, geom_mx=pack_mx(out.geom).to(cset.device))


def mx_probe_check(device) -> dict:
    """Phase 11a: the tensor-core device functions (binding.mx_probe) on
    clusters of glass_sphere (k = 32), large_mesh (k = 64) and large_mesh
    cut 4 ways (k = 16), each against 384 rays from the numpy seed aimed
    around its box: the geometry limbs bit-equal to clusters.pack_mx, and
    every plane within MX_PLANE_REL x sum |coefficient x input| of the
    float64 sums of the same products (kernel_core.mx_planes)."""
    import numpy as np
    import torch

    from cosig_tpu_torch.accel.clusters import GN, NDA, VA, VB, VC, pack_mx
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.ops import kernel_core as kc

    rng = np.random.default_rng(11)
    out = {}
    worst = 0.0
    for name, ways in (("glass_sphere", 1), ("large_mesh", 1), ("large_mesh", 4)):
        cset = scene_setup(name, dict(resolution_override=(8, 8)), device)["cset"]
        if ways > 1:
            cset = mx_split(cset, ways)
        c_all = cset.num_clusters
        for c in sorted({0, c_all // 2, c_all - 1}):
            geom = cset.geom[c].contiguous()
            box = cset.aabb_t[:6, c].cpu().numpy().astype(np.float64)
            lo, hi = box[:3], box[3:]
            mid, size = (lo + hi) / 2, float(np.max(hi - lo)) + 1e-3
            n = 384
            o = mid + rng.normal(size=(n, 3)) * 2.0 * size
            tgt = lo + rng.random((n, 3)) * (hi - lo)
            d = tgt - o
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            rays = torch.from_numpy(np.concatenate([o, d], axis=1).T.astype(np.float32)).to(device)
            limbs, planes = binding.mx_probe(geom, rays.contiguous())
            torch.cuda.synchronize()
            ref_limbs = pack_mx(geom.cpu()[None])[0]
            same = torch.equal(limbs.cpu().view(torch.int16), ref_limbs.view(torch.int16))
            check(same, name, ways, c, "kernel limbs differ from pack_mx")
            ox, oy, oz, dx, dy, dz = (rays[i] for i in range(6))
            w = (oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx)
            rl = kc.ray_limbs(ox, oy, oz, dx, dy, dz, *w)
            exact = kc.mx_planes(cset.geom_mx[c], rl, f64=True)  # [n, k] each
            # Sum of |coefficient x input| per plane, in float64.
            x = torch.stack([ox, oy, oz, dx, dy, dz, *w, torch.ones_like(ox)]).double()  # [10, n]
            g = geom.double()
            coefs = [(g[:, VA:VA + 6], range(3, 9)), (g[:, VB:VB + 6], range(3, 9)),
                     (g[:, VC:VC + 6], range(3, 9)), (g[:, GN:GN + 3], range(3, 6)),
                     (torch.cat([-g[:, GN:GN + 3], g[:, NDA:NDA + 1]], 1), (0, 1, 2, 9))]
            rel = 0.0
            for p, (cf, inputs) in enumerate(coefs):
                mag = sum((x[i][:, None] * cf[None, :, j]).abs() for j, i in enumerate(inputs))
                err = (planes[p].double().T - exact[p]).abs()
                bad = err > MX_PLANE_REL * mag
                check(not bool(bad.any()), name, ways, c, "plane", p, "outside the bound",
                      float(err.max()))
                rel = max(rel, float((err / mag.clamp_min(1e-30)).max()))
            worst = max(worst, rel)
            out[f"{name} split {ways} cluster {c}"] = dict(k=cset.k, limbs_equal=same,
                                                           max_rel_err=rel)
    log(f"  probe: limbs bit-equal to pack_mx on {len(out)} clusters; largest plane error "
        f"{worst:.3e} of sum |coef x input| (bound {MX_PLANE_REL})")
    out["max_rel_err"] = worst
    return out


def flips_of(a, b) -> tuple:
    """(flipped, rmse, max) of ``a`` against ``b`` [rows, n]: the columns
    more than FLIP_ABS apart in some row, and the RMSE and the largest
    difference over the other columns."""
    import torch

    d = torch.nan_to_num((a - b).abs(), nan=1.0)
    bad = (d > FLIP_ABS).any(dim=0)
    rest = d[:, ~bad].double()
    return (torch.nonzero(bad).squeeze(1), float(rest.pow(2).mean().sqrt()) if rest.numel() else 0.0,
            float(rest.max()) if rest.numel() else 0.0)


def explain_flip(cset, o, d, tag: str) -> dict:
    """Print the pairs of one flipped ray (origin ``o``, direction ``d``,
    3-vectors on the card) whose validity terms (|s| - EPSILON, va s, vb s,
    vc s, t - EPSILON) change sign between the kernel's planes
    (binding.mx_probe) and the plain ones (kernel_core.mx_planes), over the
    clusters whose box the ray enters (the slab test, NaN-conservative as
    the walk's), and the closest hit's (t, gid) winner under each where the
    two differ (two valid pairs whose t order turned, as on coplanar
    faces). hold_mx calls it for at most 8 flips of a stage. Returns
    {"pairs": [(cluster, row, gid) whose terms changed sign], "winners":
    {"kernel": (t - EPSILON, gid, (cluster, row)), "plain": ...}}."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.ops import kernel_core as kc

    rays = torch.cat([o, d]).reshape(6, 1).contiguous()
    ox, oy, oz, dx, dy, dz = (rays[i] for i in range(6))
    rl = kc.ray_limbs(ox, oy, oz, dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
                      ox * dy - oy * dx)

    def terms(pl):
        va, vb, vc, s, num = pl
        t = num * torch.reciprocal(s)
        return torch.stack([s.abs() - kc.EPSILON, va * s, vb * s, vc * s, t - kc.EPSILON])

    box = cset.aabb_t[:6, :cset.num_clusters]
    inv = torch.reciprocal(d)[:, None]
    t0, t1 = (box[:3] - o[:, None]) * inv, (box[3:] - o[:, None]) * inv
    tn = torch.minimum(t0, t1).max(dim=0).values
    tf = torch.maximum(t0, t1).min(dim=0).values
    entered = torch.nonzero(~(tn > tf) & ~(tf < 0.0)).squeeze(1).tolist()
    pairs = []
    best = {"kernel": (float("inf"), 0.0, None), "plain": (float("inf"), 0.0, None)}
    for c in entered:
        _, planes = binding.mx_probe(cset.geom[c].contiguous(), rays)
        tk = terms([planes[p][:, 0] for p in range(5)])
        tp = terms([x[0] for x in kc.mx_planes(cset.geom_mx[c], rl)])
        for name, tt in (("kernel", tk), ("plain", tp)):
            for row in torch.nonzero((tt >= 0).all(dim=0)).squeeze(1).tolist():
                key = (float(tt[4, row]), float(cset.geom[c, row, 35]), (c, row))
                if key[:2] < best[name][:2]:
                    best[name] = key
        sign = (tk >= 0) != (tp >= 0)
        for row in torch.nonzero(sign.any(dim=0)).squeeze(1).tolist():
            gid = float(cset.geom[c, row, 35])
            if gid >= 2 ** 24:
                continue
            pairs.append((c, row, gid))
            log(f"    {tag}: cluster {c} row {row} gid {gid:.0f}: terms kernel "
                f"{[f'{v:.3e}' for v in tk[:, row].tolist()]} plain "
                f"{[f'{v:.3e}' for v in tp[:, row].tolist()]}")
    turned = best["kernel"][:2] != best["plain"][:2]
    if turned:
        log(f"    {tag}: the closest hit's winner turned: kernel (t - EPSILON, gid, (cluster, "
            f"row)) {best['kernel']}, plain {best['plain']}")
    if not pairs and not turned:
        log(f"    {tag}: no closest-hit pair changed (a shadow ray's pair)")
    return dict(pairs=pairs, winners=best)


def hold_mx(tag, cfg, a, b, count_a, count_b, n_pixels, explain=None) -> dict:
    """A tensor-core kernel's output ``a`` [rows, n] against its plain
    version's ``b``: flips at most FLIP_SHARE of ``n_pixels``, each printed
    (``explain(column)`` then names its pair); the ray counts within
    RAYS_SLACK; outside the flips, at depth 1 the largest difference within
    DEPTH1_MAX, deeper the RMSE below DEEP_RMSE (a flip is a turned pair,
    the slice gates hold everywhere else)."""
    import torch

    flipped, rmse, rest = flips_of(a, b)
    log(f"  {tag}: flips {flipped.numel()} of {n_pixels}; outside them rmse {rmse:.3e}, max "
        f"{rest:.3e}; rays {count_a} / {count_b}")
    for col in flipped[:8].tolist():
        log(f"    flip at column {col}: kernel {a[:, col].tolist()} plain {b[:, col].tolist()}")
        if explain is not None:
            explain(col)
    check(flipped.numel() <= FLIP_SHARE * n_pixels, tag, "flips", flipped.numel())
    check(abs(count_a - count_b) <= RAYS_SLACK, tag, "rays", count_a, count_b)
    check(bool(torch.isfinite(a).all()), tag, "not finite")
    if cfg.max_depth == 1:
        check(rest <= DEPTH1_MAX, tag, "max", rest)
    else:
        check(rmse < DEEP_RMSE, tag, "rmse", rmse)
    return dict(flips=int(flipped.numel()), rmse=rmse, max_rest=rest)


def mx_stages(device) -> dict:
    """Phase 11b: each tensor-core kernel against its plain tensor-core
    version on the same inputs, stage by stage (the wavefront's primary,
    then per depth the kernel's compaction list and the bounce on the same
    state; the megakernel per frame), in full and closest-only mode, on
    glass_sphere, large_mesh cut 4 ways (c_pad 1024: the superblock
    builds; full mode only, at 96x64 d3, since its plain walk over 884
    clusters is most of this phase's time), cosig_walls, the analytic
    mixed scene and the tiny scene with every effect (AA 2, soft shadows,
    glossy, motion blur)."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import camera
    from cosig_tpu_torch.ops import kernel_core as kc
    from cosig_tpu_torch.ops import trace_megakernel as tm
    from cosig_tpu_torch.ops import trace_wavefront as tw

    effects = dict(aa_samples=2, enable_soft_shadows=True, light_size=5.0, enable_glossy=True,
                   surface_roughness=0.05, enable_motion_blur=True, shutter_speed=0.5)
    cases = [
        ("glass_sphere", dict(resolution_override=(96, 96)), False, 1),
        ("large_mesh", dict(resolution_override=(96, 64), max_depth=3), False, 4),
        ("cosig_walls", dict(resolution_override=(128, 128), max_depth=2), False, 1),
        ("mixed", dict(resolution_override=(64, 48), max_depth=3), True, 1),
        ("tiny", dict(resolution_override=(64, 64), max_depth=3, **effects), False, 1),
    ]
    out = {}
    for name, kw_, analytic, split in cases:
        t0 = time.perf_counter()
        s = scene_setup(name, kw_, device, analytic)
        cset, cfg = s["cset"], s["cfg"]
        if split > 1:
            cset = mx_split(cset, split)
        tag = tag_of(name, cfg, analytic) + (f" split {split}" if split > 1 else "")
        uni, lights, mats, prims, n_sph, n_box = tw.frame_inputs(
            cset, s["uni"], s["lights"], 0, None, s["prims"], s["prim_counts"])
        pk = (prims, n_sph, n_box)
        fb = binding.frame_buffer(device, uni, mats, lights)
        n_pix = cfg.width * cfg.height
        rec = {}
        u = [float(x) for x in uni]
        for mode in MX_MODES["wavefront"] if split == 1 else ("full",):
            def explain(col, inputs):
                o, d = inputs
                explain_flip(cset, o[:, col], d[:, col], f"{tag} {mode} ray {col}")

            rid = torch.arange(tw.num_rays(cfg, cfg.height), device=device)
            px, py, sp = tw._seed_planes(rid, cfg, 0.0)
            cam = camera.primary_rays(cfg, u, px, py, sp)
            cam_in = (torch.stack(cam[:3]), torch.stack(cam[3:]))
            st = kw.primary(cset, fb, cfg, cfg.height, *pk, mxu=mode)
            ref = tw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk, mxu=mode)
            stage = {"primary": hold_mx(
                f"{tag} {mode} primary", cfg, st[:13], ref[:13], int(st[kc.ROW_COUNT].sum()),
                int(ref[kc.ROW_COUNT].sum()), st.shape[1],
                lambda col: explain(col, cam_in))}
            for d in range(1, cfg.max_depth):
                idx, n_live = kw.compact(st)
                inputs = (st[0:3].clone(), st[3:6].clone())
                ref = st.clone()
                kw.bounce(st, idx, n_live, cset, fb, cfg, d, *pk, mxu=mode)
                tw.bounce_listed_stage(ref, idx, n_live, cset, uni, mats, lights, cfg, d, *pk,
                                       mxu=mode)
                stage[f"bounce {d}"] = hold_mx(
                    f"{tag} {mode} bounce {d} ({int(n_live)} live)", cfg, st[:13], ref[:13],
                    int(st[kc.ROW_COUNT].sum()), int(ref[kc.ROW_COUNT].sum()), st.shape[1],
                    lambda col: explain(col, inputs))
            rec[f"wavefront {mode}"] = stage
        img_k, rays_k = tm.render_clusters(cset, s["uni"], s["lights"], cfg, prims=s["prims"],
                                           prim_counts=s["prim_counts"], mxu="full")
        img_p, rays_p = tm.render_clusters(cset, s["uni"], s["lights"], cfg, plain=True,
                                           prims=s["prims"], prim_counts=s["prim_counts"],
                                           mxu="full")
        rec["megakernel full"] = hold_mx(f"{tag} megakernel full", cfg, img_k.reshape(-1, 3).T,
                                         img_p.reshape(-1, 3).T, rays_k, rays_p, n_pix)
        rec["clusters"], rec["c_pad"] = cset.num_clusters, int(cset.aabb_t.shape[1])
        out[tag] = rec
        log(f"  {tag}: every tensor-core kernel held to its plain version "
            f"({time.perf_counter() - t0:.1f} s)")
        del cset, st, ref
        torch.cuda.empty_cache()
    return out


def mx_frames(device, card: str, full_size: bool = True) -> dict:
    """Phase 11c, the tensor-core form's main path: the five bench
    configurations through Renderer(mxu="full") on the wavefront and the
    megakernel and Renderer(mxu="closest") on the wavefront, the launch
    counters set to 0 just before each path and read just after, each frame
    held to the JAX records and its graph replay to the eager frame bit for
    bit; the dense knot (43 MB of geometry, past STREAM_THRESHOLD_BYTES)
    through Renderer(mxu="full"), which must launch the exact builds; the
    oracle gate at 256x256 on glass_sphere and large_mesh; and the
    render_chain slopes of the exact and the tensor-core frames in turns."""
    import numpy as np
    import torch

    import cosig_tpu_torch
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.models.soa import frame_params, static_config
    from cosig_tpu_torch.ops import frame_graph
    from cosig_tpu_torch.ops import trace_megakernel as tm
    from cosig_tpu_torch.ops import trace_wavefront as tw
    from cosig_tpu_torch.ops.kernel_core import build_lights, build_uniforms

    out = {"frames": {}, "launches": {}, "oracle": {}, "slopes": {}}
    names = list(RECORDS) if full_size else ["diffuse_sphere", "glass_sphere"]
    for backend, modes in MX_MODES.items():
        for mode in modes:
            renderer = cosig_tpu_torch.Renderer(device="cuda", backend=backend, mxu=mode)
            binding.reset_counts()
            frames = {}
            for name in names:
                scene, settings = load(name)
                if not full_size:
                    settings = settings.replace(resolution_override=(96, 96))
                per_frame = (dict(primary_mx=1, compact=settings.max_depth - 1,
                                  bounce_mx=settings.max_depth - 1)
                             if backend == "wavefront" else dict(megakernel_mx=1))
                frames[name] = (scene, settings, drive(renderer, name, scene, settings, per_frame))
            got = {k: v for k, v in binding.LAUNCHES.items() if v}
            log(f"  [{card}] launches in the {backend} mxu={mode} path: {got}")
            check(not any(got.get(k) for k in ("primary", "bounce", "megakernel")), backend, mode,
                  "an exact build ran", got)
            for k, v in got.items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            for name, (scene, settings, fr) in frames.items():
                params = frame_params(scene, settings)
                cfg = static_config(scene, settings)
                render = tw.render_wavefront if backend == "wavefront" else tm.render_clusters
                img_e, rays_e = render(renderer._geometry_for(scene)[0], build_uniforms(params),
                                       build_lights(params, cfg.multi_light), cfg, mxu=mode)
                same = bool(np.array_equal(img_e.cpu().numpy(), fr["image"]))
                check(same and int(rays_e) == fr["rays"], name, backend, mode,
                      "graph replay differs from the eager frame")
                rec = RECORDS[name]
                log(f"  [{card}] {backend} mxu={mode} {name}: {fr['ms']:.3f} ms/frame, "
                    f"rays={fr['rays']} (record {rec['rays']}), mean={fr['mean']:.6f} (record "
                    f"{rec['mean']}); replay bit-equal to the eager frame")
                if full_size:
                    check(abs(fr["rays"] - rec["rays"]) <= RAYS_REL * rec["rays"], name, mode,
                          fr["rays"])
                    check(abs(fr["mean"] - rec["mean"]) <= MEAN_ABS, name, mode, fr["mean"])
                out["frames"][f"{backend} {mode} {name}"] = dict(
                    ms=fr["ms"], rays=fr["rays"], mean=fr["mean"], mrays_s=fr["mrays_s"])
            del renderer
            torch.cuda.empty_cache()

    # The streaming rule: a set past 6 MiB keeps the exact builds.
    scene, settings = load("dense_knot")
    settings = settings.replace(resolution_override=(128, 128), max_depth=2)
    renderer = cosig_tpu_torch.Renderer(device="cuda", mxu="full")
    binding.reset_counts()
    renderer.render_to_device(scene, settings)
    cset = renderer._geometry_for(scene)[0]
    got = {k: v for k, v in binding.LAUNCHES.items() if v}
    log(f"  [{card}] dense knot ({cset.geom_bytes} B of geometry, geom_mx "
        f"{'absent' if cset.geom_mx is None else 'present'}) through Renderer(mxu='full'): "
        f"launches {got}")
    check(cset.streamed and got.get("primary", 0) > 0 and "primary_mx" not in got
          and "bounce_mx" not in got, "the streaming rule", got)
    out["streamed_knot"] = dict(geom_bytes=cset.geom_bytes, launches=got)
    del renderer, cset

    # The oracle gate at bench.py's reduced size.
    side = ORACLE_SIDE if full_size else 64
    for name in ("glass_sphere", "large_mesh"):
        scene, settings = load(name)
        small = settings.replace(resolution_override=(side, side))
        oracle = cosig_tpu_torch.Renderer(device="cuda", backend="xla-brute")
        img_o = oracle.render_to_device(scene, small)
        rays_o = oracle.last_stats.rays_traced
        for backend in MX_MODES:
            r = cosig_tpu_torch.Renderer(device="cuda", backend=backend, mxu="full")
            img = r.render_to_device(scene, small)
            _, mx, rmse = diff(img, img_o)
            rays = r.last_stats.rays_traced
            log(f"  [{card}] {name} {side}x{side} {backend} mxu=full: rmse_vs_oracle {rmse:.3e} "
                f"(JAX record {ORACLE_RECORDS[name]:.3e}), max {mx:.3e}, rays {rays} (oracle "
                f"{rays_o})")
            check(rmse < ORACLE_RMSE, name, backend, "mxu rmse_vs_oracle", rmse)
            check(abs(rays - rays_o) <= RAYS_SLACK, name, backend, "mxu rays", rays, rays_o)
            out["oracle"][f"{backend} {name}"] = dict(rmse=rmse, max=mx, rays=rays)
        del oracle
        torch.cuda.empty_cache()

    # render_chain slopes, exact and tensor-core frames in turns.
    lo, hi = CHAIN_KS
    for name in ("glass_sphere", "large_mesh") if full_size else ("glass_sphere",):
        s = scene_setup(name, {} if full_size else dict(resolution_override=(96, 96)), device)
        a = (s["cset"], s["cfg"], s["uni"], s["lights"])
        graphs = {f"wavefront {m}": frame_graph.FrameGraph("wavefront", *a, mxu=m)
                  for m in ("off", "full", "closest")}
        graphs.update({f"megakernel {m}": frame_graph.FrameGraph("megakernel", *a, mxu=m)
                       for m in ("off", "full")})
        slopes = {n: [] for n in graphs}
        for _ in range(MX_TURNS):
            for n, g in graphs.items():
                ms = {}
                for k in (lo, hi):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    g.chain(s["uni"], s["lights"], k)
                    ms[k] = (time.perf_counter() - t0) * 1e3
                slopes[n].append((ms[hi] - ms[lo]) / (hi - lo))
        tag = tag_of(name, s["cfg"])
        out["slopes"][tag] = slopes
        log(f"  [{card}] {tag} render_chain slope, ms/frame in {MX_TURNS} turns: "
            + "; ".join(f"{n} " + " / ".join(f"{v:.3f}" for v in vs) for n, vs in slopes.items()))
        del graphs, s
        torch.cuda.empty_cache()
    return out


def mx_kernel_times(device, card: str) -> list:
    """Phase 11d: each tensor-core kernel against its plain tensor-core
    version at the main path's shapes through phase 3's kernel_row (held by
    hold_mx, bound by mx_bound, the plain version timed by its one run):
    glass_sphere's primary stage, depth 1 and megakernel frame, and
    large_mesh's depths 1-3; each then beside its exact build on the same
    input in turns (exact, mx, mx, exact), with torch.bmm of the same
    clusters' planes as a scale for the products alone and blocks per
    multiprocessor of both layouts -> the kernels line's rows."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import megakernel as km
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import kernel_core as kc
    from cosig_tpu_torch.ops import trace_megakernel as tm
    from cosig_tpu_torch.ops import trace_wavefront as tw

    rows = {}
    reps = 3

    def held(tag, cfg, n_pixels, rows_, count):
        """hold_mx of a kernel's result against its plain version's: rows
        0..rows_-1 compared, row ``count`` the rays traced."""
        return lambda a, b: hold_mx(tag, cfg, a[:rows_], b[:rows_], int(a[count].sum()),
                                    int(b[count].sum()), n_pixels)

    def bmm_ms(cset, pairs):
        """torch.bmm of every cluster's planes [5K, 64] against as many ray
        columns as the counted pair tests give it on average."""
        c, k = cset.num_clusters, cset.k
        r = max(8, -(-pairs // (c * k)))
        a = cset.geom_mx
        b = torch.ones((c, 64, r), dtype=torch.bfloat16, device=device)
        torch.bmm(a, b)
        return device_ms(lambda: torch.bmm(a, b), reps)

    def add(name, cset, rec, run_exact, run_mx):
        """The row of kernel_row's ``rec``, timed in turns beside the exact build."""
        del rec["result"]
        e1 = device_ms(run_exact, reps)
        m1 = device_ms(run_mx, reps)
        m2 = device_ms(run_mx, reps)
        e2 = device_ms(run_exact, reps)
        occ = {lay: binding.occupancy(k, cset.num_clusters, cset.k, device)
               for lay, k in (("exact", MX_EXACT[name]), ("mx", name))}
        r = dict(rec, ms=(m1 + m2) / 2, ms_turns=[m1, m2], exact_ms=[e1, e2],
                 bmm_ms=bmm_ms(cset, rec["work"]["pair_tests"]), blocks_per_sm=occ)
        log(f"  [{card}] {name} ({r['at']}): {r['ms']:.4f} ms ({m1:.4f} / {m2:.4f}), exact "
            f"{e1:.4f} / {e2:.4f} ms; plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), torch.bmm of the planes {r['bmm_ms']:.4f} ms; blocks per "
            f"multiprocessor {occ}; max |kernel - plain| {r['max_abs_err']:.3e}")
        if name not in rows:
            src, rep = MX_KERNELS[name]
            rows[name] = dict(r, source=src, replaces=rep)
        else:
            rows[name].setdefault("more", []).append(r)

    for name in ("glass_sphere", "large_mesh"):
        s = scene_setup(name, {}, device)
        cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
        mats = cset.mats_host
        fb = binding.frame_buffer(device, uni, mats, lights)
        pk = kc.prim_table(None, (0, 0), device)
        geom = 4 * (cset.geom.numel() + cset.aabb_t.numel() + pk[0].numel())
        band = cfg.height
        tag = tag_of(name, cfg)
        glass = name == "glass_sphere"
        n_px = cfg.width * cfg.height
        st16 = kw.primary(cset, fb, cfg, band, *pk)
        n_rays = st16.shape[1]
        if glass:
            def run_mx():
                return kw.primary(cset, fb, cfg, band, *pk, mxu="full")

            rec = kernel_row("primary_mx", tag, run_mx, lambda: tw.primary_stage(
                cset, uni, mats, lights, cfg, band, *pk, mxu="full"),
                lambda st: geom + 4 * st.numel(), reps_k=reps, reps_p=0, bound=mx_bound,
                hold=held(f"{tag} primary_mx", cfg, n_rays, 13, kc.ROW_COUNT))
            add("primary_mx", cset, rec, lambda: kw.primary(cset, fb, cfg, band, *pk), run_mx)
        for d in range(1, 2 if glass else cfg.max_depth):
            idx, n_live = kw.compact(st16)
            live = int(n_live)
            at = f"{tag}, depth {d} ({live} live rays)"
            # Fresh copies of the input state: 1 + 2 x reps kernel runs in
            # kernel_row, one plain run, 4 x reps in turns.
            copies = [st16.clone() for _ in range(2 + 6 * reps)]

            def run(mxu):
                st = copies.pop()
                kw.bounce(st, idx, n_live, cset, fb, cfg, d, *pk, mxu=mxu)
                return st

            def run_plain():
                st = copies.pop()
                tw.bounce_listed_stage(st, idx, n_live, cset, uni, mats, lights, cfg, d, *pk,
                                       mxu="full")
                return st

            rows_in = 13 + int(cfg.enable_soft_shadows or cfg.enable_glossy)
            rec = kernel_row("bounce_mx", at, lambda: run("full"), run_plain,
                             lambda st: geom + 4 * live * (rows_in + 14 + 1) + 4,
                             reps_k=reps, reps_p=0, bound=mx_bound,
                             hold=held(f"{at} bounce_mx", cfg, n_rays, 13, kc.ROW_COUNT))
            add("bounce_mx", cset, rec, lambda: run("off"), lambda: run("full"))
            kw.bounce(st16, idx, n_live, cset, fb, cfg, d, *pk)  # the next depth's input
            del copies
        if glass:
            def run_mx():
                return km.megakernel(cset, fb, cfg, band, *pk, mxu="full")

            rec = kernel_row("megakernel_mx", tag, run_mx, lambda: tm.megakernel_plain(
                cset, uni, mats, lights, cfg, band, *pk, mxu="full"),
                lambda o: geom + 4 * o.numel(), reps_k=reps, reps_p=0, bound=mx_bound,
                hold=held(f"{tag} megakernel_mx", cfg, n_px, 3, 3))
            add("megakernel_mx", cset, rec, lambda: km.megakernel(cset, fb, cfg, band, *pk),
                run_mx)
        del st16, cset
        torch.cuda.empty_cache()
    return list(rows.values())


def mx_phase(device, card: str, full_size: bool = True) -> dict:
    """Phase 11 (mx_probe_check, mx_stages, mx_frames, mx_kernel_times)."""
    from cosig_tpu_torch.kernels import binding

    out = {"probe": mx_probe_check(device), "small": mx_stages(device)}
    out.update(mx_frames(device, card, full_size))
    out["smem_bytes"] = {str(k): dict(exact=binding.library().cosig_tile_smem_bytes(k),
                                      mx=binding.library().cosig_mx_smem_bytes(k))
                         for k in (16, 32, 64, 128)}
    log(f"  [{card}] block walk shared memory, exact and tensor-core layouts: {out['smem_bytes']}")
    if full_size:
        out["kernels"] = mx_kernel_times(device, card)
    return out


# ---- phase 12: the tensor-core pair test in the wavefront's other forms ----

# The new builds (csrc/mx_forms.cu): the TPU kernel form each replaces, the
# same form's exact build and the fused tensor-core build of the same stage,
# timed beside it in phase 12c.
MX_FORM_SOURCE = ("cosig_tpu_torch/csrc/mx_forms.cu + csrc/forms.cuh + csrc/wavefront.cuh + "
                  "csrc/mx_pair.cuh")
MX_FORM_KERNELS = {
    "primary_fission_mx": (MX_REPLACES + "trace_wavefront.py:293 _make_primary_kernel"
                           "(fission=True)", "primary_fission", "primary_mx"),
    "trace_mx": (MX_REPLACES + "trace_wavefront.py:439 _make_bounce_kernel(mode=\"trace\")",
                 "trace", "bounce_mx"),
    "shade_mx": (MX_REPLACES + "trace_wavefront.py:439 _make_bounce_kernel(mode=\"shade\")",
                 "shade", "bounce_mx"),
    "shade_all_mx": (MX_REPLACES + "trace_wavefront.py:873 the primary stage's "
                     "_make_bounce_kernel(mode=\"shade\")", "shade_all", "primary_mx"),
    "primary_shadow_mx": (MX_REPLACES + "trace_wavefront.py:293 _make_primary_kernel with :247 "
                          "_make_shadow_traverse", "primary_shadow", "primary_mx"),
    "bounce_shadow_mx": (MX_REPLACES + "trace_wavefront.py:439 _make_bounce_kernel with :247 "
                         "_make_shadow_traverse", "bounce_shadow", "bounce_mx"),
}
MX_FORM_DESIGN = {  # the tensor-core block walk: MX_DESIGN
    "primary_fission_mx": "tensor-core block walk, stops after the closest hit",
    "trace_mx": "tensor-core block walk on the compaction list, closest hit only",
    "shade_mx": "the record, then the tensor-core block walk's any hits, on the list",
    "shade_all_mx": "the record, then the tensor-core block walk's any hits, every ray",
    "primary_shadow_mx": "tensor-core closest-hit walk, then handoff to the exact shadow walk",
    "bounce_shadow_mx": "tensor-core closest-hit walk, then handoff to the exact shadow walk",
}


def mx_form_launches(max_depth: int, forms: dict, mxu: str) -> dict:
    """Launches of one wavefront frame in the form ``forms`` and mode ``mxu``
    (the tensor-core builds; the shade's exact builds in closest-only mode
    and on a separate shadow set)."""
    d = max_depth - 1
    if forms["fission"]:
        if mxu == "full" and forms["cset_shadow"] is None:
            return dict(primary_fission_mx=1, shade_all_mx=1, compact=d, trace_mx=d,
                        **({"shade_mx": d} if d else {}))
        return dict(primary_fission_mx=1, shade=1 + d, compact=d, trace_mx=d)
    if forms["cset_shadow"] is not None:
        return dict(primary_shadow_mx=1, compact=d, bounce_shadow_mx=d)
    return dict(primary_mx=1, compact=d, bounce_mx=d)


def mx_form_small(device) -> dict:
    """Phase 12a: every new tensor-core build against its plain version
    stage by stage (check_form_stages with mxu: hold_mx's gates, flips
    counted; lists equal as integers), then each form's frame against the
    fused tensor-core kernels' frame bit for bit (the same mode's, or
    closest-only with a separate shadow set): glass_sphere in every form
    and both modes, large_mesh cut 4 ways (c_pad 1024: the superblock
    builds; its k = 16 primary set has 749 clusters), the analytic mixed
    scene and the tiny scene with every effect."""
    effects = dict(aa_samples=2, enable_soft_shadows=True, light_size=5.0, enable_glossy=True,
                   surface_roughness=0.05, enable_motion_blur=True, shutter_speed=0.5)
    cases = [
        ("glass_sphere", dict(resolution_override=(96, 96)), False, 1, ("full", "closest"),
         tuple(FORMS)),
        ("large_mesh", dict(resolution_override=(96, 64), max_depth=3), False, 4, ("full",),
         ("fission", "all")),
        ("mixed", dict(resolution_override=(64, 48), max_depth=3), True, 1, ("full",),
         ("all", "shadow set")),
        ("tiny", dict(resolution_override=(64, 64), max_depth=3, **effects), False, 1,
         ("full", "closest"), ("fission", "shadow set", "all")),
    ]
    out = {}
    for name, kw_, analytic, split, modes, forms in cases:
        t0 = time.perf_counter()
        s = scene_setup(name, kw_, device, analytic)
        k = s["cset"].k
        ks = dict(FORM_KS.get(name, dict(primary=max(4, k // 4), shadow=2 * k)))
        if split > 1:
            s["cset"] = mx_split(s["cset"], split)
        sets = form_sets(s, ks, device)
        tag = tag_of(name, s["cfg"], analytic) + (f" split {split}" if split > 1 else "")
        for mode in modes:
            for form in forms:
                lengths = check_form_stages(s, form_kwargs(sets, form), f"{tag} {form}", mxu=mode)
                out[f"{tag} {form} {mode}"] = dict(lists=lengths)
        out[tag] = dict(clusters=s["cset"].num_clusters, c_pad=int(s["cset"].aabb_t.shape[1]),
                        sets={n: (c.num_clusters, c.k, int(c.aabb_t.shape[1]))
                              for n, c in sets.items()})
        log(f"  {tag} ({out[tag]}): modes {modes}, forms {forms}: every tensor-core kernel held "
            f"to its plain version, lists equal, frames bit-equal to the fused tensor-core "
            f"frames ({time.perf_counter() - t0:.1f} s)")
    return out


def mx_form_frames(device, card: str, full_size: bool = True) -> dict:
    """Phase 12b, the main path of the new builds: glass_sphere (1024x1024,
    d6, AA 4) and large_mesh (2048x2048, d4) in every form and both modes,
    eager (render_wavefront) and replayed (FrameGraph), the launch counters
    set to 0 just before each and read just after: rays within 0.01 % and
    image mean within 1e-4 of the JAX records, the replay bit-equal to the
    eager frame, and the eager frame bit-equal to the fused tensor-core
    kernels' frame of the mode the form's arithmetic gives; then each
    graph's render_chain slope against the fused exact frame's, in turns."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.ops import frame_graph
    from cosig_tpu_torch.ops import trace_wavefront as tw

    out = {"launches": {}, "frames": {}}
    for name in ("glass_sphere", "large_mesh") if full_size else ("glass_sphere",):
        s = scene_setup(name, {} if full_size else dict(resolution_override=(96, 96)), device)
        cset, cfg, uni, lights = s["cset"], s["cfg"], s["uni"], s["lights"]
        sets = form_sets(s, FORM_KS[name], device)
        tag = tag_of(name, cfg)
        fused = {m: tw.render_wavefront(cset, uni, lights, cfg, mxu=m)
                 for m in ("full", "closest")}
        graphs = {"fused exact": frame_graph.FrameGraph("wavefront", cset, cfg, uni, lights)}
        rec = {}
        for mode in ("full", "closest"):
            for form in FORMS:
                f = form_kwargs(sets, form)
                binding.reset_counts()
                img, rays = tw.render_wavefront(cset, uni, lights, cfg, mxu=mode, **f)
                eager = {k: v for k, v in binding.LAUNCHES.items() if v}
                g = frame_graph.FrameGraph("wavefront", cset, cfg, uni, lights, mxu=mode, **f)
                img_g, rays_g = g.replay(uni, lights)
                got = {k: v for k, v in binding.LAUNCHES.items() if v}
                for k, v in got.items():
                    out["launches"][k] = out["launches"].get(k, 0) + v
                want = mx_form_launches(cfg.max_depth, f, mode)
                check(eager == want, tag, form, mode, "eager launches", eager, "expected", want)
                check({k: v for k, v in g.launches.items() if v} == dict(want, graph=1), tag,
                      form, mode, "graph launches", g.launches)
                ref = fused["closest" if f["cset_shadow"] is not None else mode]
                check(torch.equal(img, ref[0]) and int(rays) == int(ref[1]), tag, form, mode,
                      "eager frame differs from the fused tensor-core frame")
                check(torch.equal(img_g, img) and int(rays_g) == int(rays), tag, form, mode,
                      "graph replay differs from the eager frame")
                mean = float(img.double().mean())
                if full_size:
                    r = RECORDS[name]
                    check(abs(int(rays) - r["rays"]) <= RAYS_REL * r["rays"], tag, form, mode,
                          "rays", int(rays), r["rays"])
                    check(abs(mean - r["mean"]) <= MEAN_ABS, tag, form, mode, "mean", mean)
                graphs[f"{form} {mode}"] = g
                rec[f"{form} {mode}"] = dict(rays=int(rays), mean=mean, launches=got,
                                             pool_bytes=g.pool_bytes)
                log(f"  [{card}] {tag} {form} mxu={mode}: rays {int(rays)}, mean {mean:.6f} "
                    f"(record {RECORDS[name]['rays']}, {RECORDS[name]['mean']}); eager bit-equal "
                    f"to the fused {'closest' if f['cset_shadow'] is not None else mode} frame, "
                    f"replay to eager; launches {got}")
        del fused
        lo, hi = CHAIN_KS
        slopes = {n: [] for n in graphs}
        for _ in range(FORM_TURNS):
            for n, g in graphs.items():
                ms = {}
                for k in (lo, hi):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    g.chain(uni, lights, k)
                    ms[k] = (time.perf_counter() - t0) * 1e3
                slopes[n].append((ms[hi] - ms[lo]) / (hi - lo))
        rec["slope_ms"] = slopes
        log(f"  [{card}] {tag} render_chain slope, ms/frame in {FORM_TURNS} turns: "
            + "; ".join(f"{n} " + " / ".join(f"{v:.3f}" for v in vs) for n, vs in slopes.items()))
        out["frames"][tag] = rec
        del graphs, sets, cset, s
        torch.cuda.empty_cache()
    return out


def mx_state_rows(st):
    """The rows a tensor-core stage is held on: 0-12 and, in a 24-row state,
    the record's 15-19, with a miss's t (INF) as 1e30 so that two misses
    agree and a turned hit counts as a flip."""
    import torch

    from cosig_tpu_torch.ops.kernel_core import REC0

    rows = list(range(13)) + (list(range(REC0, REC0 + 5)) if st.shape[0] > 16 else [])
    return torch.nan_to_num(st[rows], posinf=1e30)


def mx_form_kernel_times(device, card: str) -> list:
    """Phase 12c: each new build at the main path's shapes (glass_sphere
    1024x1024 d6 AA 4: the primary stage and depth 1; large_mesh 2048x2048:
    depths 1-3), on the fused tensor-core chain's states: held once to its
    plain version (hold_mx on mx_state_rows, the plain version timed by that
    run, its counted WORK giving mx_bound), then timed behind a sleep in
    turns beside the same form's exact build (exact, mx, mx, exact) and the
    fused tensor-core build of the stage, with blocks per multiprocessor
    of each -> the kernels line's rows."""
    import torch

    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import kernel_core as kc
    from cosig_tpu_torch.ops import trace_wavefront as tw

    rows = {}
    reps = 3

    def row(name, at, cfg, fresh, run_mx, run_exact, run_fused, run_p, nbytes, occ,
            fresh_fused=None):
        """``fresh()`` -> a new copy of the input (None for a primary;
        ``fresh_fused()`` the fused build's, where it differs); each
        ``run_*(input)`` -> the state it writes. Held and timed by phase 3's
        kernel_row (1 + 2 x reps kernel runs and the plain version's one
        run), then timed in turns."""
        held = {}

        def hold(a, b):
            held.update(hold_mx(f"{at} {name}", cfg, mx_state_rows(a), mx_state_rows(b),
                                int(a[kc.ROW_COUNT].sum()), int(b[kc.ROW_COUNT].sum()),
                                a.shape[1]))
            held["err"] = diff(mx_state_rows(a), mx_state_rows(b))[1]

        cps = [fresh() for _ in range(2 + 2 * reps)]
        rec = kernel_row(name, at, lambda: run_mx(cps.pop()), lambda: run_p(cps.pop()),
                         lambda _: nbytes, reps_k=reps, reps_p=0, bound=mx_bound, hold=hold)
        del rec["result"], cps

        def ms_of(run, make=fresh):
            cps = [make() for _ in range(reps)]
            return device_ms(lambda: run(cps.pop()), reps)

        e1, m1, m2, e2 = ms_of(run_exact), ms_of(run_mx), ms_of(run_mx), ms_of(run_exact)
        f_ms = ms_of(run_fused, fresh_fused or fresh)
        r = dict(rec, ms=(m1 + m2) / 2, ms_turns=[m1, m2], kernel_row_ms=rec["ms"],
                 exact_ms=[e1, e2], fused_mx_ms=f_ms, max_abs_err=held["err"],
                 flips=held["flips"], blocks_per_sm=occ)
        log(f"  [{card}] {name} ({at}): {r['ms']:.4f} ms ({m1:.4f} / {m2:.4f}); the exact "
            f"build {e1:.4f} / {e2:.4f} ms, the fused tensor-core {f_ms:.4f} ms; plain "
            f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); blocks "
            f"per multiprocessor {occ}; flips {held['flips']}")
        if name not in rows:
            rows[name] = dict(r, source=MX_FORM_SOURCE, replaces=MX_FORM_KERNELS[name][0])
        else:
            rows[name].setdefault("more", []).append(r)

    for name in ("glass_sphere", "large_mesh"):
        s = scene_setup(name, {}, device)
        cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
        mats = cset.mats_host
        fb = binding.frame_buffer(device, uni, mats, lights)
        pk = kc.prim_table(None, (0, 0), device)
        sh = form_sets(s, dict(shadow=FORM_KS[name]["shadow"]), device)["shadow"]
        geom = 4 * (cset.geom.numel() + cset.aabb_t.numel())
        geom_sh = 4 * (sh.geom.numel() + sh.aabb_t.numel())
        band, c, k = cfg.height, cset.num_clusters, cset.k
        tag = tag_of(name, cfg)

        def occ(mx_name, sh_k=0):
            return {b: binding.occupancy(b, c, k, device, shadow_k=sh_k)
                    for b in (mx_name, MX_FORM_KERNELS[mx_name][1])}

        if name == "glass_sphere":
            def prim(**f):
                return lambda _: kw.primary(cset, fb, cfg, band, *pk, **f)

            def prim_p(**f):
                return lambda _: tw.primary_stage(cset, uni, mats, lights, cfg, band, *pk, **f)

            n_rays = tw.num_rays(cfg, band)
            row("primary_fission_mx", tag, cfg, lambda: None, prim(fission=True, mxu="full"),
                prim(fission=True), prim(mxu="full"), prim_p(fission=True, mxu="full"),
                geom + 4 * n_rays * kc.FISSION_ROWS, occ("primary_fission_mx"))
            row("primary_shadow_mx", tag, cfg, lambda: None,
                prim(cset_shadow=sh, mxu="full"), prim(cset_shadow=sh), prim(mxu="full"),
                prim_p(cset_shadow=sh, mxu="full"), geom + geom_sh + 4 * n_rays * kc.STATE_ROWS,
                occ("primary_shadow_mx", sh.k))
            st24 = kw.primary(cset, fb, cfg, band, *pk, fission=True, mxu="full")

            def shade_all(m):
                def run(st):
                    kw.shade(st, None, None, cset, fb, cfg, 0, *pk, mxu=m)
                    return st
                return run

            def shade_all_p(st):
                tw.primary_shade(st, cset, uni, mats, lights, cfg, *pk, mxu="full")
                return st

            row("shade_all_mx", f"{tag}, the primary stage over all rays", cfg, st24.clone,
                shade_all("full"), shade_all("off"), prim(mxu="full"), shade_all_p,
                geom + 4 * n_rays * (13 + 5 + 14), occ("shade_all_mx"))
            del st24
        # The bounces, on the fused tensor-core chain's states.
        st16 = kw.primary(cset, fb, cfg, band, *pk, mxu="full")
        n = kc.STATE_ROWS
        for d in range(1, 2 if name == "glass_sphere" else cfg.max_depth):
            idx, n_live = kw.compact(st16)
            live = int(n_live)
            at = f"{tag}, depth {d} ({live} live rays)"
            st24 = torch.zeros((kc.FISSION_ROWS, st16.shape[1]), dtype=torch.float32,
                               device=device)
            st24[:n] = st16

            def bounce(**f):
                def run(st):
                    kw.bounce(st, idx, n_live, cset, fb, cfg, d, *pk, **f)
                    return st
                return run

            def bounce_sh_p(st):
                tw.bounce_listed_stage(st, idx, n_live, cset, uni, mats, lights, cfg, d, *pk,
                                       cset_shadow=sh, mxu="full")
                return st

            row("bounce_shadow_mx", at, cfg, st16.clone, bounce(cset_shadow=sh, mxu="full"),
                bounce(cset_shadow=sh), bounce(mxu="full"), bounce_sh_p,
                geom + geom_sh + 4 * live * (13 + 14 + 1) + 4, occ("bounce_shadow_mx", sh.k))

            def trace(m):
                def run(st):
                    kw.trace(st, idx, n_live, cset, fb, cfg, d, *pk, mxu=m)
                    return st
                return run

            def trace_p(st):
                tw.trace_listed_stage(st, idx, n_live, cset, *pk, mxu="full")
                return st

            row("trace_mx", at, cfg, st24.clone, trace("full"), trace("off"), bounce(mxu="full"),
                trace_p, geom + 4 * live * (7 + 6 + 1) + 4, occ("trace_mx"),
                fresh_fused=st16.clone)
            traced = trace("full")(st24.clone())

            def shade(m):
                def run(st):
                    kw.shade(st, idx, n_live, cset, fb, cfg, d, *pk, mxu=m)
                    return st
                return run

            def shade_p(st):
                tw.shade_listed_stage(st, idx, n_live, cset, uni, mats, lights, cfg, d, *pk,
                                      mxu="full")
                return st

            row("shade_mx", at, cfg, traced.clone, shade("full"), shade("off"), bounce(mxu="full"),
                shade_p, geom + 4 * live * (13 + 5 + 14 + 1) + 4, occ("shade_mx"),
                fresh_fused=st16.clone)
            kw.bounce(st16, idx, n_live, cset, fb, cfg, d, *pk, mxu="full")  # the next input
            del st24, traced
        del st16, cset, sh
        torch.cuda.empty_cache()
    return list(rows.values())


def mx_form_phase(device, card: str, full_size: bool = True) -> dict:
    """Phase 12 (mx_form_small, mx_form_frames, mx_form_kernel_times)."""
    out = {}
    t0 = time.perf_counter()
    out["small"] = mx_form_small(device)
    out["small_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out.update(mx_form_frames(device, card, full_size))
    out["frames_s"] = time.perf_counter() - t0
    if full_size:
        t0 = time.perf_counter()
        out["kernels"] = mx_form_kernel_times(device, card)
        out["kernels_s"] = time.perf_counter() - t0
    log(f"  phase 12: stages {out['small_s']:.1f} s, frames {out['frames_s']:.1f} s, kernel "
        f"times {out.get('kernels_s', 0.0):.1f} s")
    return out


def ptxas_resources(ptxas: str) -> dict:
    """Registers and spill bytes per kernel from ``nvcc -Xptxas -v``:
    {"primary": {"registers": r, "spill_stores": b, "spill_loads": b,
    "superblocks": {the same of the build with the superblock cull}}, ...},
    each build under the name ``kernels.sass.build_label`` gives its
    mangled name (the launch counters' names: primary_fission,
    primary_shadow, bounce_shadow, primary_mx, bounce_mx, megakernel_mx,
    primary_fission_mx, primary_shadow_mx, bounce_shadow_mx, trace_mx,
    shade_mx; shade_all and shade_all_mx, the shade over every ray of the
    primary stage; mx_probe)."""
    import re

    from cosig_tpu_torch.kernels.sass import build_label

    out, cur = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(_ZN5cosig\w+)'", line)
        if m:
            label = build_label(m.group(1))
            cur = None
            if label:
                cur = out.setdefault(label[0], {})
                if label[1]:  # built with the superblock cull
                    cur = cur.setdefault("superblocks", {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and "spill_stores" not in cur:  # later lines are called functions'
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


# The exact builds whose walk is compacted, in slots of 32 rows at every k:
# no other build (the fission primary's and the shade over every ray's
# "slots" builds are their compacted walks, for k > 32).
COMPACTED_BUILDS = ("trace", "shade")
# Every tensor-core build: the launch counters' names (kernels.sass.build_label).
MX_BUILDS = ("primary_mx", "bounce_mx", "megakernel_mx", "primary_fission_mx", "trace_mx",
             "shade_mx", "shade_all_mx", "primary_shadow_mx", "bounce_shadow_mx")


def check_tensor_ops(path: str) -> dict:
    """The SASS of the library at ``path`` (kernels.sass): every
    tensor-core build, with and without the superblock cull, issues wgmma
    (HGMMA) in its pair loop and has no mma.sync (HMMA) anywhere; no exact
    build has either -> {build: kernels.sass.tensor_ops' counts}."""
    from cosig_tpu_torch.kernels import sass

    ops = sass.tensor_ops(sass.disassemble(path))
    for name in MX_BUILDS:
        for label in (name, name + " (superblocks)"):
            check(label in ops, label, "not found in the library's SASS", sorted(ops))
            c = ops[label]
            check(c["pair_loop_hgmma"] > 0, label, "issues no HGMMA in its pair loop", c)
            check(c["hmma"] == 0, label, "still has HMMA", c)
    for label, c in ops.items():
        if label.split(" ")[0] not in MX_BUILDS and label != "mx_probe":
            check(c["hgmma"] == 0 and c["hmma"] == 0, label, "exact build with tensor ops", c)
    log("  SASS: HGMMA (pair loop / function) and HMMA of the tensor-core builds: "
        + "; ".join(f"{n} {c['pair_loop_hgmma']} / {c['hgmma']}, {c['hmma']}"
                    for n, c in sorted(ops.items()) if n.split(" ")[0] in MX_BUILDS))
    return ops


def _row_times(rows: list) -> dict:
    """{kernel: [[at, ms], ...]} of a kernels line's rows and their "more"."""
    out = {}
    for r in rows:
        for x in [r] + r.get("more", []):
            out.setdefault(r["name"], []).append([x.get("at"), x["ms"]])
    return out


def time_tree(tree: str) -> int:
    """``--time-kernels``: phase 3's kernel times of the checkout ``tree``,
    from its own ``chip_smoke.py`` and package, then those of phases 10c,
    11d and 12c (the forms, the tensor-core builds and their forms) where
    the tree has them, as one ``TIMES`` line."""
    import importlib

    import torch

    tree = os.path.abspath(tree)
    if not os.path.isfile(os.path.join(tree, "chip_smoke.py")):
        print(f"chip_smoke: no chip_smoke.py in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    os.chdir(tree)
    smoke = importlib.import_module("chip_smoke")
    dev = torch.device("cuda", 0)
    rows = smoke.time_kernels(dev)
    card = smoke.card_line()
    out = {"tree": tree, "card": card}
    for r in rows:
        out[r["name"]] = r["ms"]
        if r["name"] == "bounce":
            out["bounce large_mesh"] = [x["ms"] for x in r["large_mesh"]]
            out["bounce empty"] = r["empty_list_ms"]
    out["forms"] = _row_times(smoke.form_kernel_times(dev))
    out["mx"] = _row_times(smoke.mx_kernel_times(dev, card))
    out["mx_forms"] = _row_times(smoke.mx_form_kernel_times(dev, card))
    print("TIMES " + json.dumps(out), flush=True)
    return 0


DENSE_DEEP_DEPTH = 4


def dense_deep(device) -> dict:
    """``--dense-knot``: the dense knot held to its plain versions at depth
    DENSE_DEEP_DEPTH, the check that phase 8 cut to depth 2 to keep the
    script inside its time limit. At DENSE_PLAIN_SIDE: every wavefront
    stage bit-equal to its plain version on the same input state, in the
    fused and the fission form and with the shadow set of phase 10b (k =
    1024, walked in slots), the compaction lists equal as integers
    (check_form_stages; the knot's 2,355 clusters take the superblock
    builds, so the fission form runs the compacted fission primary and
    shade with the superblock cull); the whole chain, the megakernel and the debug
    view in modes 1-3 bit-equal to their plain frames (compare_case). Cut
    DENSE_FLAT_SPLIT ways (every kernel's flat build) at 16x8, depth 2:
    the primary, the bounce, the megakernel and the debug view bit-equal to
    their plain versions (phase 8 runs this case at depth 1: at depth 2
    its plain frames took 250 s). At full size (2048x2048, d4): the primary
    and the megakernel against their plain versions bit for bit through
    phase 3's kernel_row, their times on the card and the bounds from the
    plain versions' counted work; the fission primary and the shade over
    every ray (their compacted superblock builds) the same way; then the
    bounce at depths 1-3 of the kernels' own chain."""
    from cosig_tpu_torch.accel.clusters import superblocks
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import megakernel as km
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import kernel_core as kc
    from cosig_tpu_torch.ops import trace_megakernel as tm
    from cosig_tpu_torch.ops import trace_wavefront as tw

    out = {}
    side = DENSE_PLAIN_SIDE
    kw_ = dict(resolution_override=(side, side), max_depth=DENSE_DEEP_DEPTH)
    t0 = time.perf_counter()
    s = scene_setup("dense_knot", kw_, device)
    tag = tag_of("dense_knot", s["cfg"])
    check(superblocks(s["cset"].num_clusters) > 0, tag, "takes no superblock build")
    shadow = form_sets(s, dict(shadow=FORM_KS["dense_knot"]["shadow"]), device)["shadow"]
    for form in ("fused", "fission", "shadow set"):
        f = dict(fission=form == "fission", cset_primary=None,
                 cset_shadow=shadow if form == "shadow set" else None)
        out[f"{form} lists"] = check_form_stages(s, f, f"{tag} {form}")
        log(f"  {tag} {form}: every stage bit-equal to its plain version, lists "
            f"{out[f'{form} lists']} equal ({time.perf_counter() - t0:.1f} s)")
    out["plain_s"] = compare_case(device, "dense_knot", kw_, False, exact=True)
    log(f"  {tag}: chain, megakernel and debug modes 1-3 bit-equal to their plain frames "
        f"({time.perf_counter() - t0:.1f} s)")
    out["flat_plain_s"] = compare_case(device, "dense_knot",
                                       dict(resolution_override=(16, 8), max_depth=2), False,
                                       exact=True, split=DENSE_FLAT_SPLIT)
    log(f"  dense knot split {DENSE_FLAT_SPLIT} ways ({DENSE_FLAT_SPLIT * DENSE_CLUSTERS} "
        f"clusters, the flat builds) 16x8 d2: primary, bounce, megakernel and debug modes 1-3 "
        f"bit-equal to their plain versions ({time.perf_counter() - t0:.1f} s)")

    s = scene_setup("dense_knot", {}, device)
    cfg, cset = s["cfg"], s["cset"]
    uni, lights, mats, prims, n_sph, n_box = tw.frame_inputs(
        cset, s["uni"], s["lights"], 0, None, s["prims"], s["prim_counts"])
    pk = (prims, n_sph, n_box)
    fb = binding.frame_buffer(device, uni, mats, lights)
    geom_bytes = 4 * (cset.geom.numel() + cset.aabb_t.numel() + prims.numel())
    tag = tag_of("dense_knot", cfg)

    def exact(name):
        return lambda a, b: check(diff(a, b)[0], tag, name, "not bit-equal to its plain version")

    rows = []
    for name, run_k, run_p in (
            ("primary", lambda: kw.primary(cset, fb, cfg, cfg.height, *pk),
             lambda: tw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk)),
            ("megakernel", lambda: km.megakernel(cset, fb, cfg, cfg.height, *pk),
             lambda: tm.megakernel_plain(cset, uni, mats, lights, cfg, cfg.height, *pk))):
        rec = kernel_row(name, tag, run_k, run_p, lambda o: geom_bytes + 4 * o.numel(),
                         reps_k=3, reps_p=0, hold=exact(name))
        result = rec.pop("result")
        if name == "primary":
            st16 = result
        rows.append(rec)
    # The fission form's primary stage (the compacted superblock builds of
    # the fission primary and the shade over every ray): each bit-equal to
    # its plain version, the shade on the kernel's own fission state; the
    # bytes as phase 10c counts them.
    n_rays = st16.shape[1]
    rec = kernel_row("primary_fission", tag,
                     lambda: kw.primary(cset, fb, cfg, cfg.height, *pk, fission=True),
                     lambda: tw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk,
                                              fission=True),
                     lambda _: geom_bytes + 4 * n_rays * (6 + 14), reps_k=3, reps_p=0,
                     hold=exact("primary_fission"))
    st24 = rec.pop("result")
    rows.append(dict(rec, blocks_per_sm=binding.occupancy(
        "primary_fission", cset.num_clusters, cset.k, device)))
    copies = [st24.clone() for _ in range(8)]  # 1 + 2 x 3 kernel runs, one plain run

    def shade_all():
        st = copies.pop()
        kw.shade(st, None, None, cset, fb, cfg, 0, *pk)
        return st

    def shade_all_p():
        st = copies.pop()
        tw.primary_shade(st, cset, uni, mats, lights, cfg, *pk)
        return st

    rec = kernel_row("shade", f"{tag}, the primary stage over all rays", shade_all, shade_all_p,
                     lambda _: geom_bytes + 4 * n_rays * (13 + 5 + 14), reps_k=3, reps_p=0,
                     hold=exact("shade"))
    del rec["result"], copies, st24
    rows.append(dict(rec, blocks_per_sm=binding.occupancy(
        "shade_all", cset.num_clusters, cset.k, device)))
    # The bounces of the wavefront chain, each on the kernels' own state and
    # the compaction kernel's list: bit-equal to the plain bounce, its time
    # and the bound of its plain version's counted work (the bytes as phase
    # 3 counts them).
    rows_in = 13 + int(cfg.enable_soft_shadows or cfg.enable_glossy)
    for d in range(1, cfg.max_depth):
        idx, n_live = kw.compact(st16)
        live = int(n_live)
        copies = [st16.clone() for _ in range(8)]  # 1 + 2 x 3 kernel runs, one plain run

        def run_k():
            st = copies.pop()
            kw.bounce(st, idx, n_live, cset, fb, cfg, d, *pk)
            return st

        def run_p():
            st = copies.pop()
            tw.bounce_listed_stage(st, idx, n_live, cset, uni, mats, lights, cfg, d, *pk)
            return st

        rec = kernel_row("bounce", f"{tag}, depth {d} ({live} live rays)", run_k, run_p,
                         lambda st: geom_bytes + 4 * live * (rows_in + 14 + 1) + 4,
                         reps_k=3, reps_p=0, hold=exact("bounce"))
        del rec["result"], copies
        rows.append(dict(rec, live=live))
        kw.bounce(st16, idx, n_live, cset, fb, cfg, d, *pk)  # the next depth's input
    out["kernels"] = rows
    return out


def dense_main(device) -> int:
    """``--dense-knot``: build the kernels, run dense_deep, print one
    ``DENSE {...}`` line, the card line and the result line."""
    import torch

    from cosig_tpu_torch.kernels import build as kbuild

    card = card_line()
    log(f"card: {card}")
    _, build_s, _ = kbuild.build(force=True)
    log(f"kernels built in {build_s:.2f} s")
    t0 = time.perf_counter()
    out = dense_deep(device)
    out.update(card=card, seconds=time.perf_counter() - t0)
    print("DENSE " + json.dumps(out), flush=True)
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if argv[:1] == ["--time-kernels"] and len(argv) <= 2:
        return time_tree(argv[1] if len(argv) == 2 else here)
    dense = argv == ["--dense-knot"]
    if argv and not dense:
        print(f"chip_smoke: unknown arguments {argv}\n{__doc__}", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    try:
        from cosig_tpu_torch.kernels import build as kbuild
    except ImportError as e:
        print(f"chip_smoke: cosig_tpu_torch is not importable from {here}: {e}", file=sys.stderr)
        return 2
    if dense:
        return dense_main(torch.device("cuda", 0))

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)
    path, build_s, ptxas = kbuild.build(force=True, verbose=True)
    log(f"kernels built in {build_s:.2f} s, one nvcc per source in parallel: "
        f"{os.path.relpath(path, here)}")
    for line in ptxas.splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "warning" in line):
            log(f"  ptxas: {line.strip()}")
    serialized = [line.strip() for line in ptxas.splitlines() if "wgmma" in line.lower()]
    log(f"  ptxas lines on wgmma (C7510/C7515: serialized): {len(serialized)}")
    resources = ptxas_resources(ptxas)
    tensor_ops = check_tensor_ops(path)
    check(set(resources) >= {"primary", "compact", "bounce", "megakernel", "debug", "trace",
                             "shade", "shade_all", "primary_fission", "primary_shadow",
                             "bounce_shadow", "primary_mx", "bounce_mx", "megakernel_mx",
                             *MX_FORM_KERNELS},
          resources)
    # Every ray kernel's builds whose walk has slots (k > 128; the exact
    # fission primary's and shade over every ray's: the compacted walk, k >
    # 32), but the exact trace's and shade on a list's, whose compacted
    # walks have slots at every k.
    slot_builds = {n + " slots" for n in resources
                   if n not in ("compact", "mx_probe", *COMPACTED_BUILDS)
                   and not n.endswith(" slots")}
    check(set(resources) >= slot_builds, "builds with slots missing",
          sorted(slot_builds - set(resources)))
    check_no_jax()

    t0 = time.perf_counter()
    compare_small(device)
    states = check_compaction_states(device)
    log(f"phase 2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    models = model_walks(device)
    kernels = time_kernels(device)
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    frames, launches = drive_main_paths(device)
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    breakdown_and_plain(device, frames)
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    import tempfile

    with tempfile.TemporaryDirectory() as workdir:
        oracle = oracle_and_cli(device, workdir)
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        phase7 = dict(small=shard_small(device), frames=shard_frames(device, card),
                      native=native_host(device, card, workdir))
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase8 = dense_frames(device, card)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase9 = graph_frames(device, card)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase10 = form_phase(device, card)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase11 = mx_phase(device, card)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase12 = mx_form_phase(device, card)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    check_no_jax()

    from cosig_tpu_torch.kernels import binding

    glass_k = scene_setup("glass_sphere", {}, "cpu")["cset"].k
    dense_launches = {}
    for fr in phase8["frames"].values():
        dense_launches.update({n: c for n, c in fr["launches"].items() if c})
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, k["name"], "was not launched on its path")
        if k["name"] != "debug":
            k["dense_knot_launches"] = dense_launches[k["name"]]
        k.update(resources[k["name"]])
        k["slots_build"] = resources.get(k["name"] + " slots")
        if k["name"] == "compact":
            k["design"] = ("one cooperative launch: key bytes in shared memory, one grid "
                           "barrier, offsets from the per-block counts in every block; no "
                           "atomics")
            k["smem_bytes"] = k["rays_per_block"]
            k["synthetic_states"] = states
            continue
        k["design"] = "block walk" + (" on the compaction list" if k["name"] == "bounce" else "")
        k["smem_bytes"] = binding.library().cosig_tile_smem_bytes(glass_k)
    # The fission form and the shadow-set builds: launches on phase 10's
    # main path (its forms' full-size frames, eager and replayed).
    for k in phase10.pop("kernels"):
        k["launches"] = phase10["launches"].get(k["name"], 0)
        check(k["launches"] > 0, k["name"], "was not launched on its path")
        k.update(resources[k["name"]])
        k["slots_build"] = resources.get(k["name"] + " slots")
        if k["name"] == "shade":
            k["primary_stage_build"] = resources["shade_all"]
        shadow = ("two block walks, one shared memory (handoff); the shadow walk in slots of "
                  "at most the main walk's rows, its any hit stopped after every slot")
        k["design"] = {"trace": "block walk on the compaction list, closest hit only, its pair "
                                "loop compacted: per 32-row slot the (ray, row) pairs of the "
                                "rays in the box over the block, a 64-bit (t, gid) atomicMin "
                                "key per ray",
                       "shade": "the record, then per light the any hit, its pair loop "
                                "compacted: per 32-row slot the (ray, row) pairs of the rays "
                                "in the box still walking over the block, an occluding pair "
                                "flags its ray (a plain store), the block stops when no ray "
                                "walks; over every ray with clusters of at most 32 rows, the "
                                "block walk's per-warp any hit",
                       "primary_fission": "the frustum cull, then the block walk's closest "
                                          "hit, compacted (the trace's) past 32-row clusters, "
                                          "stops after it",
                       "primary_shadow": shadow, "bounce_shadow": shadow}[k["name"]]
        kernels.append(k)
    # The tensor-core builds: launches on phase 11's main path (its
    # Renderer frames: warm-up, capture's warm-up and replays).
    for k in phase11.pop("kernels"):
        k["launches"] = phase11["launches"].get(k["name"], 0)
        check(k["launches"] > 0, k["name"], "was not launched on its path")
        k.update(resources[k["name"]])
        k["slots_build"] = resources.get(k["name"] + " slots")
        k["design"] = MX_DESIGN
        k["tensor_ops"] = {b: tensor_ops[b] for b in (k["name"], k["name"] + " (superblocks)")}
        kernels.append(k)
    # The tensor-core builds of the other forms: launches on phase 12's
    # main path (its full-size frames in every form, eager and replayed).
    for k in phase12.pop("kernels"):
        k["launches"] = phase12["launches"].get(k["name"], 0)
        check(k["launches"] > 0, k["name"], "was not launched on its path")
        k.update(resources[k["name"]])
        k["slots_build"] = resources.get(k["name"] + " slots")
        k["design"] = MX_FORM_DESIGN[k["name"]]
        k["tensor_ops"] = {b: tensor_ops[b] for b in (k["name"], k["name"] + " (superblocks)")}
        kernels.append(k)
    log(json.dumps({"models": models}))
    log(json.dumps({"frames": frames}))
    log(json.dumps({"oracle": oracle}))
    log(json.dumps({"phase7": phase7}))
    log(json.dumps({"phase8": phase8}))
    log(json.dumps({"phase9": phase9}))
    log(json.dumps({"phase10": phase10}))
    log(json.dumps({"phase11": phase11}))
    log(json.dumps({"phase12": phase12}))
    log(json.dumps({"ptxas_wgmma": serialized}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
