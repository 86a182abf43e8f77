"""Plain PyTorch versions of the two device functions every wavefront
kernel runs: cluster traversal and one Whitted bounce.

Counterpart of :mod:`cosig_tpu.ops.kernel_core`. The JAX package runs
``make_traverse`` (``:200-1035``) and ``bounce_core`` (``:1058-1270``)
inside its Pallas kernels on (1, R) lane planes; here they are plain
functions on [N] tensors, used as the CPU path and as the reference the
CUDA kernels (``csrc/traverse.cuh``, ``csrc/bounce.cuh``) are held
against on the card. The per-pair and per-ray arithmetic keeps the JAX
package's operation order, so float32 results agree to the bit where the
operations are IEEE (everything but sin/cos):

* the slab cull is NaN-conservative: ``torch.minimum``/``maximum``
  propagate NaN and the tests are inverted (``~(tn > tf)``), so a NaN slab
  passes and the exact pair test decides (``:410-453``);
* the Plücker chain order follows ``:818-842``;
* the winner is the lexicographic (t, gid) minimum over all valid pairs
  (``:861-902``) — independent of clustering and visit order;
* two pre-filters of the slab cull, the superblock cull (``:545-590``) and,
  for coherent packets, the bounding-frustum cull (``:455-517``), are exact:
  each passes a superset of what the per-ray slab test passes
  (:func:`frustum_flags`), so they change only how many slab tests run;
* normalization is ``1/sqrt`` then multiply (``:137-140``);
* analytic spheres and boxes (``analytic_primitives``) fold in after the
  cluster walk with tie ids above every triangle's (``:931-1018``).

The tensor-core form of the pair test (``traverse(..., mx=True)``, the
JAX package's MXU form ``mt_mxu``/``mxu_sel``, ``:633-803``) changes only
the five planes va, vb, vc, s and num = nda - o.n: each is the sum of the
exact bf16 x bf16 products of the limbs (``clusters.pack_mx`` for the
geometry, :func:`ray_limbs` for the rays), summed in float64 by one matrix
product and rounded once to float32: every product is exact in float64, so
the sum is within a few float64 roundings of the exact one in any order,
a fixed reference within about one float32 rounding of the exact sum
whatever order a tensor core takes.
The validity test, t = num * (1/s), the (t, gid) fold and u = vb * (1/s)
stay as they are. ``bounce_core(mxu=)`` picks it per traversal: ``"full"``
for the closest hit and the shadow rays, ``"closest"`` for the closest
hit only (the JAX package's ``COSIG_MXU_SHADOW=0``), and shadow rays
through a separate shadow set always exact; :func:`mxu_mode`
applies the JAX package's rule that a set past ``STREAM_THRESHOLD_BYTES``
keeps the exact test.

Division by a Python scalar goes through a tensor divisor (``_div``):
PyTorch's CUDA backend turns ``tensor / scalar`` into a multiply by the
reciprocal, which is not IEEE division. Square roots go through float64
(``_sqrt``): PyTorch's vectorized float32 sqrt on the CPU is not always
correctly rounded (an AVX-512 build misses by 1 ulp on some inputs;
tests/test_torch_host.py counts them), while the float64 root rounded to
float32 is, on every device. Both helpers live in
:mod:`cosig_tpu_torch.ops.intersect`, which the oracle path shares.
"""

from __future__ import annotations

import numpy as np
import torch

from cosig_tpu_torch.accel.clusters import (
    CULL_BLOCK,
    GID_PAD,
    MX_COMBOS,
    MX_PLANES,
    ClusterSet,
    limbs,
    superblocks,
)
from cosig_tpu_torch.models.soa import FrameParams, StaticConfig
from cosig_tpu_torch.ops import rng
from cosig_tpu_torch.ops.intersect import EPSILON, INF, _sign, _sqrt
from cosig_tpu_torch.ops.shade import OFFSET

F32 = np.float32

# Ray-state rows (f32 [16, N]): 0-2 origin, 3-5 direction, 6-8
# attenuation, 9-11 accumulated color, 12 alive, 13 rays-traced count,
# 14 ray id, 15 pad. The fission form (separate trace and shade stages)
# appends the hit record, t, nx, ny, nz, mat, at rows 15-19 and pads to 24
# rows (cosig_tpu/ops/trace_wavefront.py:24-28, :132-138); the record is
# written and read within one depth step.
ROW_ALIVE = 12
ROW_COUNT = 13
ROW_ID = 14
STATE_ROWS = 16
REC0 = 15
FISSION_ROWS = 24


def state_rows(fission: bool) -> int:
    """Rows of a ray state: 16 fused, 24 in the fission form."""
    return FISSION_ROWS if fission else STATE_ROWS

# uniforms layout (f32 [UNIFORMS_LEN])
U_CAM = 0  # 12 floats: rows of the 3x4 camera->object matrix
U_DIST = 12
U_PLANE_H = 13
U_ORTHO = 14
U_BG = 15  # 3
U_INTENSITY = 18
U_LIGHT_SIZE = 19
U_ROUGHNESS = 20
U_SHUTTER = 21
U_ROW_OFF = 22  # global row offset of the rendered band
U_DEPTH = 23  # bounce index (kept for layout parity; stages take it as an argument)
U_LAST = 24  # final-bounce flag (likewise)
UNIFORMS_LEN = 25

# Material defaults for a miss or an out-of-range index (compute:371-376).
MAT_DEFAULTS = (1.0, 1.0, 1.0, 0.1, 0.7, 0.0, 0.0, 1.0)

# Geometry columns read by the traversal (accel/clusters.py layout).
_GN, _NDA, _VA, _VB, _VC, _N0, _MAT, _GID = 3, 6, 7, 13, 19, 25, 34, 35

# Tie ids of analytic primitives: GID_SPH + 2p, above every triangle id
# (< 2^24), so a primitive loses an equal-t tie to a triangle; spaced by 2
# to stay f32-exact above 2^24 (cosig_tpu/ops/kernel_core.py:108-111).
GID_SPH = float(F32(2.0 ** 24 + 2))

# Rays per pair-grid slice in the plain traversal (bounds [rays, K] temporaries).
_PAIR_CHUNK = 1 << 20

# Work entered by the plain traversal since the last reset_work(): ray x
# cluster slab tests (on the clusters the pre-filters pass), ray x
# triangle pair tests on the clusters a ray enters (padding rows
# excluded), ray x analytic-primitive tests, and with a ray -> block map
# (``packets``) the pre-filters' tests: block x cluster frustum tests and
# superblock tests (block x superblock in frustum mode, ray x superblock
# otherwise) — the tests csrc/traverse_tile.cuh runs on the same rays. Its
# closest-hit walk visits everything; its any-hit walk visits clusters,
# then rows, then primitives in order and stops at the first occluder, so a
# shadow ray counts up to that test and no further. chip_smoke.py turns the
# counts into each kernel's bound. With a ray -> warp map (``warps``), also
# the pair-loop slots the warps spend: a warp in which some ray (still
# walking, for an any hit) enters a cluster runs its real rows on all 32
# lanes, so each such (warp, cluster) counts 32 x the cluster's real rows.
# For an exact closest hit also the slots of the compacted walk (the
# trace's and the fission primary's: ``pair_slots``, per block of four
# warps and piece of TRACE_SLOT rows BLOCK_RAYS x ceil(n x rows /
# BLOCK_RAYS), n the block's rays that run the piece; :func:`_walk_pruned`).
# For an any hit also the slots of a per-warp
# walk that leaves a cluster once none of its lanes still walks
# (``any_warp_slots``: per (warp, cluster) 32 x the most rows a lane tests,
# up to its first occluder) and of the compacted any hit (the exact
# shade's: ``any_pair_slots``, :func:`any_compact_slots`). With ``warps`` and
# no frustum cull, the kernels' two-level cull (:func:`group_flags`): per ray
# a test of each group's union box (``group_tests``), and ``slab_tests``
# only for the groups that some ray of its warp enters. A closest hit
# (exact) with ``warps`` walks as the compacted one does, near-first and
# distance-pruned (:func:`prune_flags`): its ``pair_tests`` and
# ``pair_slots`` are the pairs that walk runs, ``pairs_pruned`` those it
# skips (a walk without pruning, such as the kernels' per-warp walks, runs
# their sum). The kernels' own counters (csrc/traverse_tile.cuh add_counts,
# add_shadow_counts) count as the kernels' culls run: ``box_tests`` the
# group and cluster box tests of every ray walking as its cull pass starts
# (an any-hit ray stopped within the pass keeps its tests of the pass's
# later boxes, which ``slab_tests`` leaves out; for a closest hit the two
# counts agree with ``group_tests``), ``shadow_rays`` an any hit's rays
# cast, and ``any_pairs_run`` the pairs the compacted any hit lists: each
# ray in a box runs every real row of the box's pieces of TRACE_SLOT rows
# up to the piece of its first occluder (an exact any hit's ``pair_tests``
# are those a per-warp walk runs, up to the occluder itself).
WORK = {"slab_tests": 0, "pair_tests": 0, "prim_tests": 0, "warp_slots": 0,
        "pair_slots": 0, "any_warp_slots": 0, "any_pair_slots": 0, "frustum_tests": 0,
        "superblock_tests": 0, "group_tests": 0, "pairs_pruned": 0, "box_tests": 0,
        "shadow_rays": 0, "any_pairs_run": 0}

# The kernels' block walk (csrc/traverse_tile.cuh): the rays of a thread
# block walk together, and its cull takes TILE_C clusters a pass; the
# trace's compacted walk streams a cluster in slots of TRACE_SLOT rows
# (csrc/walk_layout.h).
BLOCK_RAYS = 128
TILE_C = 256
TRACE_SLOT = 32
CULL_GROUP = 8  # consecutive clusters under one union box (the two-level cull)


# The distance pruning's margin (csrc/traverse.cuh prunes, which gives the
# argument): its grazing factor (8.4 u / EPSILON) and relative slack (2^-20).
PRUNE_GRAZE = 5e-3
PRUNE_REL = 2.0 ** -20


def prune_flags(tn, t_key, ox, oy, oz, box, n1) -> torch.Tensor:
    """Which rays [M] the compacted closest hit lets skip a piece of rows
    (csrc/traverse.cuh prunes, operation for operation): ``tn`` the ray's
    entry distance into the cluster's box (:func:`slab`), ``t_key`` its key's
    t after the earlier pieces (INF: none), ``box`` [6, M] the box, ``n1`` [M]
    the piece's largest |gx| + |gy| + |gz| (:func:`piece_normals`) -> bool
    [M]: tn lies past t_key by more than the margin, so no pair of the piece
    can reach t_key. NaN never prunes (fmax drops a NaN operand as fmaxf
    does; a NaN margin or tn compares false)."""
    fmax = torch.fmax
    o = fmax(fmax(ox.abs(), oy.abs()), oz.abs())
    b = box.abs()
    rb = fmax(fmax(fmax(b[0], b[1]), fmax(b[2], b[3])), fmax(b[4], b[5]))
    margin = ((o + rb) + t_key) * n1 * PRUNE_GRAZE + t_key * PRUNE_REL
    return (t_key < INF) & (tn > t_key + margin)


def piece_normals(geom: torch.Tensor) -> torch.Tensor:
    """Per cluster and piece of TRACE_SLOT rows, the largest |n|_1 =
    (|gx| + |gy|) + |gz| of its rows (padding rows are 0), as a warp of the
    compacted walk reduces it (csrc/traverse.cuh normal_l1) -> [C, pieces]."""
    C, K = int(geom.shape[0]), int(geom.shape[1])
    l1 = (geom[:, :, _GN].abs() + geom[:, :, _GN + 1].abs()) + geom[:, :, _GN + 2].abs()
    return torch.stack([l1[:, p:p + TRACE_SLOT].amax(dim=1) for p in range(0, K, TRACE_SLOT)],
                       dim=1)


def near_first(e_block, e_cluster, e_tn, n_blocks: int, n_clusters: int) -> torch.Tensor:
    """The compacted closest hit's order of each block's list (csrc/
    traverse_tile.cuh near_first): box entries (block, cluster, tn) [E] ->
    each entry's position in its block's list, the clusters ranked by their
    entry key, the least max(tn, 0) over the block's entries (a NaN tn as
    0), ties by cluster index."""
    key = torch.where(e_tn > 0.0, e_tn, 0.0)
    keys = torch.full((n_blocks * n_clusters,), float("nan"), dtype=e_tn.dtype,
                      device=e_tn.device)
    keys.scatter_reduce_(0, e_block * n_clusters + e_cluster, key, "amin", include_self=False)
    order = torch.sort(keys.view(n_blocks, n_clusters), dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(n_clusters, device=order.device).expand(n_blocks, -1))
    return rank[e_block, e_cluster]


def any_compact_slots(blocks: torch.Tensor, stop: torch.Tensor, rows: int) -> int:
    """Pair-loop slots of the compacted any hit (csrc/traverse_tile.cuh
    any_pairs) on one cluster of ``rows`` real rows: ``blocks`` [R] the
    block of each ray in its box, ``stop`` [R] the last piece of TRACE_SLOT
    rows each walks (the piece of its first occluder in the cluster, else
    the last). Per block and piece of r real rows, the n rays still walking
    at the start of the piece take BLOCK_RAYS x ceil(n r / BLOCK_RAYS)
    slots."""
    total = 0
    for p, first in enumerate(range(0, rows, TRACE_SLOT)):
        r = min(TRACE_SLOT, rows - first)
        walking = blocks[stop >= p]
        if walking.numel():
            n_in = torch.unique(walking, return_counts=True)[1]
            total += BLOCK_RAYS * int(((n_in * r + BLOCK_RAYS - 1) // BLOCK_RAYS).sum())
    return total


# The tensor-core form (traverse(..., mx=True)): the modes a caller picks,
# each plane's contraction inputs (0:3 origin, 3:6 direction, 6:9 moment
# w, 9 the constant 1), and the rows a kernel's any hit tests at a time
# (csrc/mx_pair.cuh: an n-tile of 8 triangles), by which WORK counts a
# shadow ray's pair tests in that form. MX_PRODUCTS is the limb products
# a pair needs, those not zero by construction (the constant's limbs 1 and
# 2 are 0): 36 each for va, vb and vc, 18 for s, 21 for num.
MXU_MODES = ("off", "full", "closest")
MX_INPUTS = ((3, 4, 5, 6, 7, 8),) * 3 + ((3, 4, 5), (0, 1, 2, 9))
MX_ROWS = 8
MX_PRODUCTS = sum(1 for inputs in MX_INPUTS for _, kk in MX_COMBOS for i in inputs
                  if not (i == 9 and kk))


def mxu_mode(cset: ClusterSet, mxu: str) -> str:
    """The pair test that a stage over ``cset`` runs when the caller asks for
    ``mxu``: ``"off"`` for a set past STREAM_THRESHOLD_BYTES, whose
    geometry the JAX package streams and then keeps the exact test
    (cosig_tpu/ops/trace_wavefront.py:651-659); raise on an unknown mode
    and on a set without ``geom_mx`` where the form would run."""
    if mxu not in MXU_MODES:
        raise ValueError(f"mxu must be one of {MXU_MODES}, got {mxu!r}")
    if mxu == "off" or cset.streamed:
        return "off"
    if cset.geom_mx is None:
        raise ValueError("the tensor-core pair test needs the cluster set's geom_mx "
                         "(clusters.pack_mx); this set has none")
    return mxu


def ray_limbs(ox, oy, oz, dx, dy, dz, wx, wy, wz) -> torch.Tensor:
    """The rays' inputs split into bf16 limbs, as the JAX kernel stages them
    (cosig_tpu/ops/kernel_core.py:335-392 stage_rays) -> f32 [10, 3, N]:
    limb k of input i (0:3 origin, 3:6 direction, 6:9 w, 9 the constant 1
    with limbs 1, 0, 0)."""
    planes = [torch.stack(limbs(x)) for x in (ox, oy, oz, dx, dy, dz, wx, wy, wz)]
    one = torch.zeros_like(planes[0])
    one[0] = 1.0
    return torch.stack(planes + [one])


def mx_planes(gmx: torch.Tensor, rl: torch.Tensor, f64: bool = False) -> list:
    """The five planes of one cluster for a chunk of rays: ``gmx`` [5K, 64]
    (the cluster's geom_mx), ``rl`` [10, 3, n] (:func:`ray_limbs` of the
    rays) -> [va, vb, vc, s, num], each f32 [n, K]: per (ray, row) the sum
    of the limb products over the contraction columns ci * 10 + i (the
    ray's limb MX_COMBOS[ci][1] of input i), one float64 matrix product
    rounded once to float32 (``f64``: the float64 sums, unrounded). Every
    product is exact in float64 (8 x 8 significant bits), and the columns
    whose geometry or ray limb is 0 by construction add exact zeros."""
    k = gmx.shape[0] // MX_PLANES
    x = torch.cat([rl[:, kk] for _, kk in MX_COMBOS]).to(torch.float64)  # [60, n]
    cols = x.shape[0]
    acc = x.T @ gmx[:, :cols].to(torch.float64).T  # [n, 5K]
    return [p if f64 else p.to(torch.float32) for p in acc.split(k, dim=1)]


def reset_work() -> None:
    for key in WORK:
        WORK[key] = 0


def linear_slots(n: int) -> torch.Tensor:
    """Thread slot -> ray id of a kernel that gives thread i of its grid of
    128-thread blocks ray i: -1 on the threads past the last ray."""
    slots = torch.arange(-(-n // 128) * 128, dtype=torch.int64)
    slots[n:] = -1
    return slots


def warp_of_rays(slots: torch.Tensor, n: int) -> torch.Tensor:
    """Warp id [n] of each ray, from a thread slot -> ray id map (-1 on
    empty slots) that holds every ray id once; raise if it does not."""
    ids = slots[slots >= 0]
    if ids.numel() != n or not torch.equal(torch.sort(ids).values, torch.arange(n)):
        raise ValueError("the slot map is not a permutation of the ray ids")
    warp = torch.empty(n, dtype=torch.int64)
    warp[ids] = torch.nonzero(slots >= 0).squeeze(1) // 32
    return warp


def linear_packets(n: int) -> torch.Tensor:
    """Block id [n] of each ray of a kernel that gives thread i of its grid
    of 128-thread blocks ray i (the primary kernel; the bounce kernel over
    its list)."""
    return torch.arange(n, dtype=torch.int64) // BLOCK_RAYS


# ---------------------------------------------------------------------------
# The slab cull's exact pre-filters


def _pack_reduce(packets, n_packets, vals, fill, reduce):
    """Per-packet min or max (``reduce``: "amin" / "amax") of ``vals`` [M]
    whose packets are ``packets`` [M] -> [n_packets], ``fill`` for an empty
    packet; NaN if any value of the packet is NaN."""
    out = torch.full((n_packets,), fill, dtype=vals.dtype, device=vals.device)
    out = out.scatter_reduce(0, packets, vals, reduce)
    return torch.where(_pack_any(packets, n_packets, torch.isnan(vals)), float("nan"), out)


def _pack_any(packets, n_packets, flags):
    """Per-packet OR of ``flags`` [M, ...] -> bool [n_packets, ...] (in
    int32: PyTorch's CUDA scatter takes no bool)."""
    out = torch.zeros((n_packets,) + tuple(flags.shape[1:]), dtype=torch.int32,
                      device=flags.device)
    idx = packets.reshape((-1,) + (1,) * (flags.dim() - 1)).expand_as(flags)
    return out.scatter_reduce(0, idx, flags.to(torch.int32), "amax") > 0


def _hull(olo, ohi, dlo, dhi, zinf, wild, mt, live) -> dict:
    """A hull from its per-axis bounds ([3, P] each) -> the dict that
    :func:`frustum_flags` reads: the bounds, 1/d over the direction
    interval (``rlo`` = 1/dhi, ``rhi`` = 1/dlo, IEEE divisions), ``uni``
    (the interval lies on one side of zero), ``zinf`` (some ray's 1/d is
    infinite), ``wild`` (some ray's d is NaN or infinite), ``mt`` [P] and
    ``live`` [P] (the packet has an active ray)."""
    return dict(olo=olo, ohi=ohi, dlo=dlo, dhi=dhi,
                rlo=torch.reciprocal(dhi), rhi=torch.reciprocal(dlo),
                uni=(dlo > 0.0) | (dhi < 0.0), zinf=zinf, wild=wild, mt=mt, live=live)


def packet_hulls(packets, n_packets, active, ox, oy, oz, dx, dy, dz, max_t=None) -> dict:
    """Per packet, the hull of its active rays (cosig_tpu/ops/kernel_core.py:455-474):
    the origin and direction intervals per axis, the largest ``max_t``
    (+inf without one), and the two flags that keep the frustum test exact
    where a ray's own slab test turns NaN (:func:`frustum_flags`).
    ``packets`` [N]: each ray's packet in ``[0, n_packets)``."""
    pk = packets[active]
    inf = float("inf")
    lo, hi, zinf, wild = [], [], [], []
    for o, d in ((ox, dx), (oy, dy), (oz, dz)):
        oa, da = o[active], d[active]
        lo.append(torch.stack([_pack_reduce(pk, n_packets, oa, inf, "amin"),
                               _pack_reduce(pk, n_packets, da, inf, "amin")]))
        hi.append(torch.stack([_pack_reduce(pk, n_packets, oa, -inf, "amax"),
                               _pack_reduce(pk, n_packets, da, -inf, "amax")]))
        zinf.append(_pack_any(pk, n_packets, torch.isinf(torch.reciprocal(da))))
        wild.append(_pack_any(pk, n_packets, ~torch.isfinite(da)))
    lo, hi = torch.stack(lo), torch.stack(hi)  # [3, 2, P]: origin, direction
    if max_t is None:
        mt = torch.full((n_packets,), inf, dtype=ox.dtype, device=ox.device)
    else:
        mt = _pack_reduce(pk, n_packets, max_t[active], -inf, "amax")
    return _hull(lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1], torch.stack(zinf), torch.stack(wild),
                 mt, _pack_any(pk, n_packets, torch.ones_like(pk, dtype=torch.bool)))


def ray_hulls(active, ox, oy, oz, dx, dy, dz, max_t=None) -> dict:
    """Each ray as a hull of its own ([N] packets of one ray): the per-ray
    form of the test, the superblock cull's."""
    o, d = torch.stack([ox, oy, oz]), torch.stack([dx, dy, dz])
    mt = torch.full_like(ox, float("inf")) if max_t is None else max_t
    return _hull(o, o, d, d, torch.isinf(torch.reciprocal(d)), ~torch.isfinite(d), mt, active)


def frustum_flags(h: dict, boxes: torch.Tensor) -> torch.Tensor:
    """Hulls [P] (:func:`packet_hulls`) against boxes ``boxes`` [>= 6, W]
    (rows min xyz, max xyz) -> [P, W] bool: False only where no ray of the
    hull can pass the box's slab test.

    The interval arithmetic of cosig_tpu/ops/kernel_core.py:476-517,
    operation for operation: per axis the entry and exit distances over the
    origin interval times the 1/d interval (float rounding is monotone, so
    every ray's own products lie between the corners'), an axis whose
    direction interval holds zero (-0 included) unconstrained; NaN passes.
    Three changes make it a superset of the per-ray slab test of every ray
    of the hull, which the JAX version is not quite: (1) the slab test's
    own form, entry <= exit, exit >= 0, entry <= max_t, from -inf and +inf
    (the JAX version starts at 0 and FLT_MAX, so it drops a ray whose
    max_t is negative or whose slabs are all +inf); (2) an axis on which
    some ray's 1/d is infinite passes the box when the origin interval
    meets the box's range there — that ray's slab is 0 * inf = NaN, which
    passes, on a face at its origin; (3) an axis with a NaN or infinite
    direction, or a NaN box or origin, passes."""
    inf = float("inf")
    entry = exit_ = over = None
    for a in range(3):
        bmin, bmax = boxes[a][None, :], boxes[a + 3][None, :]
        olo, ohi = h["olo"][a][:, None], h["ohi"][a][:, None]
        rlo, rhi = h["rlo"][a][:, None], h["rhi"][a][:, None]
        s_lo = bmin - ohi
        s_hi = bmax - olo
        p1 = s_lo * rlo
        p2 = s_lo * rhi
        p3 = s_hi * rlo
        p4 = s_hi * rhi
        t_lo = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
        t_hi = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
        uni = h["uni"][a][:, None]
        t_lo = torch.where(uni, t_lo, -inf)
        t_hi = torch.where(uni, t_hi, inf)
        entry = t_lo if entry is None else torch.maximum(entry, t_lo)
        exit_ = t_hi if exit_ is None else torch.minimum(exit_, t_hi)
        o_a = (h["wild"][a][:, None] | torch.isnan(s_lo) | torch.isnan(s_hi)
               | (h["zinf"][a][:, None] & ~(olo > bmax) & ~(ohi < bmin)))
        over = o_a if over is None else over | o_a
    mt = h["mt"][:, None]
    return over | (~(entry > exit_) & ~(exit_ < 0.0) & ~(entry > mt))


def superblock_flags(packets, n_packets, active, ox, oy, oz, dx, dy, dz, sb_boxes,
                     max_t=None) -> torch.Tensor:
    """Per-ray test of the superblock boxes ``sb_boxes`` [>= 6, S] OR-ed
    over each packet's active rays -> [n_packets, S] bool: the superblock
    cull of rays that are not coherent (cosig_tpu/ops/kernel_core.py:568-572).
    A ray's test is :func:`frustum_flags` of its own hull, the slab test of
    a union box with the rule that keeps it a superset of the ray's slab
    test on every cluster box inside the union: where the ray's 1/d is
    infinite and its origin lies in the union's range, a cluster's face may
    sit at the origin, whose NaN slab passes, so the union passes."""
    flags = frustum_flags(ray_hulls(active, ox, oy, oz, dx, dy, dz, max_t), sb_boxes)
    return _pack_any(packets, n_packets, flags & active[:, None])


def slab(box, ox, oy, oz, idx, idy, idz) -> tuple:
    """The per-ray slab test's entry and exit distances (tn, tf) [N] against
    ``box`` (rows min xyz, max xyz), NaN-conservative
    (cosig_tpu/ops/kernel_core.py:430-449): torch.minimum/maximum propagate
    NaN, and the callers' tests are inverted, so a NaN slab passes."""
    t0x = (box[0] - ox) * idx
    t1x = (box[3] - ox) * idx
    t0y = (box[1] - oy) * idy
    t1y = (box[4] - oy) * idy
    t0z = (box[2] - oz) * idz
    t1z = (box[5] - oz) * idz
    tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                       torch.minimum(t0z, t1z))
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                       torch.maximum(t0z, t1z))
    return tn, tf


def union_box(boxes: torch.Tensor) -> torch.Tensor:
    """The union box [6] of boxes [>= 6, W] (rows min xyz, max xyz): NaN
    where some box's bound is NaN, as the kernels' shuffles of slab_min and
    slab_max build it (csrc/traverse_tile.cuh stage_boxes)."""
    return torch.cat([boxes[:3].amin(dim=1), boxes[3:6].amax(dim=1)])


def group_flags(u: torch.Tensor, ox, oy, oz, dx, dy, dz, idx, idy, idz,
                max_t=None) -> torch.Tensor:
    """The group test of the kernels' two-level cull (csrc/traverse.cuh
    group_pass) of rays [N] against a union box ``u`` [6] -> bool [N]: the
    slab test of the union (and with ``max_t`` the any hit's tn <= max_t),
    False only where the ray passes the slab test on no box inside it. Per
    axis a member's slab interval lies inside the union's (rounding is
    monotone) and a NaN bound or origin puts a NaN, which passes, into the
    union's slab too; two rules keep the rest a superset: an axis with an
    infinite 1/d and the origin within the union's range there passes (a
    member's face may lie at the origin, where its slab is 0 * inf = NaN),
    and so does a ray with a NaN or infinite direction component."""
    tn, tf = slab(u, ox, oy, oz, idx, idy, idz)
    passed = ~(tn > tf) & ~(tf < 0.0)
    if max_t is not None:
        passed = passed & ~(tn > max_t)
    over = ~torch.isfinite(dx) | ~torch.isfinite(dy) | ~torch.isfinite(dz)
    for a, (o, i) in enumerate(((ox, idx), (oy, idy), (oz, idz))):
        over = over | (torch.isinf(i) & ~(o > u[a + 3]) & ~(o < u[a]))
    return passed | over


def build_uniforms(params: FrameParams, row_offset: float = 0.0) -> np.ndarray:
    """Pack the frame's dynamic floats into the uniforms vector (f32 [25]).

    ``plane_h = 2 * distance * tan(fov/2)`` is taken in float64 and rounded
    once, after the float32 degrees-to-radians product — the correctly
    rounded float32 value."""
    m = params.cam_to_obj
    half = F32(np.deg2rad(params.fov_deg)) * F32(0.5)
    plane_h = F32(2.0) * F32(params.cam_distance) * F32(np.tan(np.float64(half)))
    vals = [
        m[0, 0], m[0, 1], m[0, 2], m[0, 3],
        m[1, 0], m[1, 1], m[1, 2], m[1, 3],
        m[2, 0], m[2, 1], m[2, 2], m[2, 3],
        params.cam_distance,
        plane_h,
        params.ortho_size,
        params.background[0], params.background[1], params.background[2],
        params.light_intensity,
        params.light_size,
        params.surface_roughness,
        params.shutter_speed,
        row_offset, 0.0, 0.0,
    ]
    return np.array(vals, F32)


def build_lights(params: FrameParams, multi_light: bool) -> np.ndarray:
    """Light table f32 [L, 8]: position xyz, rgb, two pad columns."""
    pos = params.light_pos if multi_light else params.light_pos[:1]
    rgb = params.light_rgb if multi_light else params.light_rgb[:1]
    pad = np.zeros((pos.shape[0], 2), F32)
    return np.concatenate([pos, rgb, pad], axis=1).astype(F32)


def _pow32(x):
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    x16 = x8 * x8
    return x16 * x16


def _rsqrt3(x, y, z):
    """1/sqrt then multiply (not rsqrt): bit-matches the JAX package."""
    inv = torch.reciprocal(_sqrt(x * x + y * y + z * z))
    return x * inv, y * inv, z * inv


def prim_table(prims, prim_counts, device):
    """The analytic primitive table as the traversals take it ->
    (contiguous f32 [P, 22] tensor on ``device``, n_sph, n_box); one zero
    row when there is none (``ops/analytic.pack_prims_host``)."""
    n_sph, n_box = (int(n) for n in prim_counts)
    if prims is None:
        prims = np.zeros((1, 22), F32)
    prims = torch.as_tensor(prims, dtype=torch.float32, device=device).contiguous()
    if prims.dim() != 2 or prims.shape[1] != 22 or prims.shape[0] < max(1, n_sph + n_box):
        raise ValueError(
            f"prims must be [>= max(1, n_sph + n_box), 22], got {tuple(prims.shape)} "
            f"for counts {(n_sph, n_box)}"
        )
    return prims, n_sph, n_box


# ---------------------------------------------------------------------------
# Traversal


def traverse(cset: ClusterSet, ox, oy, oz, dx, dy, dz, active,
             max_t=None, any_hit=False, prims=None, n_sph=0, n_box=0, warps=None,
             packets=None, frustum=False, mx=False):
    """Closest hit (or, with ``any_hit``, occlusion at t <= max_t) of rays
    [N] against the cluster set and the analytic primitives -> ``(hit, t,
    nx, ny, nz, mat)``.

    Closest hit: ``t`` is INF and the normal (0, 1, 0) on a miss; ``mat``
    is the winner's material (-1 on a miss). Any hit: ``hit`` is the
    occlusion flag and the other outputs are None. Inactive rays report a
    miss. ``prims`` is the [P, 22] table of :func:`prim_table` with its
    first ``n_sph`` rows spheres and the next ``n_box`` boxes. ``warps``
    ([N] warp id of each ray on the rays' device, or None) adds the warps'
    pair-loop slots to ``WORK["warp_slots"]`` and, for a closest hit, the
    compacted walk's (blocks of four warps) to ``WORK["pair_slots"]``; for
    an any hit, the slots of a per-warp walk that stops at its lanes' first
    occluders to ``WORK["any_warp_slots"]`` and the compacted any hit's to
    ``WORK["any_pair_slots"]``; and, where ``frustum`` is off, it runs the
    kernels' two-level cull in those warps: at each group of CULL_GROUP
    clusters of a pass of more than CULL_GROUP, every ray tests the group's
    union box (:func:`group_flags`, ``WORK["group_tests"]``), and the
    members' slab tests run only for the rays of a warp in which some ray
    enters it (``WORK["slab_tests"]``). An exact closest hit with ``warps``
    walks as the kernels' compacted one (csrc/traverse_tile.cuh
    closest_pairs): each block of four warps walks its list of entered
    clusters near-first (:func:`near_first`), in pieces of TRACE_SLOT rows,
    and a ray skips a piece that :func:`prune_flags` prunes from its key after
    the earlier pieces; ``pair_tests`` and ``pair_slots`` count what that walk
    runs and ``WORK["pairs_pruned"]`` what it skips. Pruning is exact, so the
    outputs are the unpruned walk's bit for bit.

    ``packets`` ([N] thread block of each ray on the rays' device, or None)
    runs the kernels' pre-filters before the per-ray slab test, as their
    block walk does (csrc/traverse_tile.cuh): with superblocks to test
    (:func:`~cosig_tpu_torch.accel.clusters.superblocks`: 513 to 65,536
    clusters), at the first cull pass of each superblock a block tests the
    superblock's union box (:func:`superblock_flags`, or with ``frustum``
    its hull's :func:`frustum_flags`) and skips the superblock's clusters
    when no ray enters it; with ``frustum``, at each pass of TILE_C
    clusters the block's hull of the rays still walking is tested against
    every box of the pass, and only the boxes it passes get the per-ray
    test. All three culls are exact, so the outputs do not depend on
    ``warps``, ``packets`` or ``frustum``; only the counted slab tests fall."""
    n = ox.shape[0]
    dev = ox.device
    geom = cset.geom
    C, K = int(geom.shape[0]), int(geom.shape[1])
    aabb = cset.aabb_t
    rows_real = (geom[:, :, _GID] != float(GID_PAD)).sum(dim=1).tolist()
    if not any_hit:
        WORK["prim_tests"] += int(active.sum()) * (n_sph + n_box)
    else:
        WORK["shadow_rays"] += int(active.sum())
    n_packets = int(packets.max()) + 1 if packets is not None and n > 0 else 0
    n_sb = superblocks(C)
    rays6 = (ox, oy, oz, dx, dy, dz)
    mt_hull = max_t if any_hit else None
    idx = torch.reciprocal(dx)
    idy = torch.reciprocal(dy)
    idz = torch.reciprocal(dz)
    # Ray moment w = o x d (canonical component order).
    wx = oy * dz - oz * dy
    wy = oz * dx - ox * dz
    wz = ox * dy - oy * dx
    if mx:
        if cset.geom_mx is None:
            raise ValueError("the tensor-core pair test needs the cluster set's geom_mx")
        rl = ray_limbs(ox, oy, oz, dx, dy, dz, wx, wy, wz)
    chunk = max(1, (1 << 22) // K) if mx else _PAIR_CHUNK

    rays9 = (ox, oy, oz, dx, dy, dz, wx, wy, wz)
    rows_k = torch.arange(K, device=dev)[None]  # [1, K]
    if any_hit:
        occ = torch.zeros(n, dtype=torch.bool, device=dev)
    else:
        best = dict(t=torch.full((n,), INF, dtype=torch.float32, device=dev),
                    gid=torch.full((n,), float(GID_PAD), dtype=torch.float32, device=dev),
                    row=torch.full((n,), -1, dtype=torch.int64, device=dev),
                    u=torch.zeros(n, dtype=torch.float32, device=dev),
                    v=torch.zeros(n, dtype=torch.float32, device=dev))

    sb_open = None  # [n_packets] blocks that enter the current superblock
    n_warps = int(warps.max()) + 1 if warps is not None and n > 0 else 0
    # The compacted closest hit's walk: the box entries (cluster, rays, tn)
    # first, then their pairs near-first and distance-pruned.
    pruned = warps is not None and not any_hit and not mx
    entries = []
    for c in range(C):
        if any_hit:
            # An occluded ray's walk has stopped: it tests no more clusters.
            active = active & ~occ
        if c % TILE_C == 0:
            # The rays the kernels' cull of this pass tests (box_tests).
            pass_active = active
        tested = active
        culled = pass_active
        if n_packets:
            if c % TILE_C == 0:
                # A cull pass: blocks without a ray still walking skip it.
                live = _pack_any(packets[active], n_packets, active[active])
                if frustum:
                    hull = packet_hulls(packets, n_packets, active, *rays6, max_t=mt_hull)
                if n_sb and c % CULL_BLOCK == 0:
                    sb_box = cset.sb_aabb_t[:6, c // CULL_BLOCK:c // CULL_BLOCK + 1]
                    if frustum:
                        sb_open = frustum_flags(hull, sb_box)[:, 0]
                        WORK["superblock_tests"] += int(live.sum())
                    else:
                        sb_open = superblock_flags(packets, n_packets, active, *rays6, sb_box,
                                                   max_t=mt_hull)[:, 0]
                        WORK["superblock_tests"] += int(active.sum())
                entered = live if sb_open is None else live & sb_open
                if frustum:
                    width = min(TILE_C, C - c)
                    pass_fl = frustum_flags(hull, aabb[:6, c:c + width]) & entered[:, None]
                    WORK["frustum_tests"] += int(entered.sum()) * width
            passes = (pass_fl[:, c % TILE_C] if frustum else entered)[packets]
            tested = active & passes
            culled = pass_active & passes
        pass_end = min(C, c - c % TILE_C + TILE_C)
        if n_warps and not frustum and pass_end - (c - c % TILE_C) > CULL_GROUP:
            if c % CULL_GROUP == 0:  # the group's union box, then its warps
                u = union_box(aabb[:6, c:min(c + CULL_GROUP, pass_end)])
                g_flags = group_flags(u, *rays6, idx, idy, idz, max_t)
                g_in = tested & g_flags
                WORK["group_tests"] += int(tested.sum())
                in_group = _pack_any(warps[g_in], n_warps, g_in[g_in])[warps]
                g_cull = culled & g_flags
                WORK["box_tests"] += int(culled.sum())
                cull_group = _pack_any(warps[g_cull], n_warps, g_cull[g_cull])[warps]
            tested = tested & in_group
            culled = culled & cull_group
        WORK["slab_tests"] += int(tested.sum())
        WORK["box_tests"] += int(culled.sum())
        # Per-ray slab cull, NaN-conservative (cosig_tpu/ops/kernel_core.py:430-449).
        tn, tf = slab(aabb[:6, c], ox, oy, oz, idx, idy, idz)
        boxhit = ~(tn > tf) & ~(tf < 0.0) & tested
        if max_t is not None:
            boxhit = boxhit & ~(tn > max_t)
        rays = torch.nonzero(boxhit).squeeze(1)
        if rays.numel() == 0:
            continue
        if warps is not None:
            WORK["warp_slots"] += 32 * rows_real[c] * int(torch.unique(warps[rays]).numel())
        if pruned:
            entries.append((c, rays, tn[rays]))
            continue
        if not any_hit:
            WORK["pair_tests"] += int(rays.numel()) * rows_real[c]
        g = geom[c]  # [K, 36]
        gid = g[:, _GID].unsqueeze(0)  # [1, K]
        if any_hit:
            # Each ray's first occluding row in the cluster (rows_real: none).
            first_occ = torch.full((rays.numel(),), rows_real[c], dtype=torch.int64, device=dev)
        for lo in range(0, int(rays.numel()), chunk):
            r = rays[lo:lo + chunk]
            if mx:
                # The five planes from the limb products (mxu_sel, kernel_core.py:640-649).
                va, vb, vc, s, num = mx_planes(cset.geom_mx[c], rl[:, :, r])
                inv_s = torch.reciprocal(s)
                t = num * inv_s
                valid = _pair_valid(va, vb, vc, s, t)
            else:
                valid, t, vb, vc, inv_s = _pair_planes(g[None], r, rays9)
            if any_hit:
                # The walk stops at the first occluding row of the cluster.
                occludes = valid & (t <= max_t[r, None])
                first = occludes.to(torch.uint8).argmax(dim=1)
                hit_here = occludes.any(dim=1)
                tested_rows = first + 1
                if mx:  # the kernel tests MX_ROWS rows at a time
                    tested_rows = torch.clamp((first // MX_ROWS + 1) * MX_ROWS, max=rows_real[c])
                WORK["pair_tests"] += int(torch.where(hit_here, tested_rows, rows_real[c]).sum())
                occ[r] |= hit_here
                first_occ[lo:lo + chunk] = torch.where(hit_here, first, rows_real[c])
                continue
            _fold_closest(best, r, valid, t, vb, vc, inv_s, gid, c * K + rows_k)
        if any_hit:
            # The compacted any hit lists a ray's pieces up to its occluder's.
            stop = first_occ.clamp(max=max(0, rows_real[c] - 1)) // TRACE_SLOT
            WORK["any_pairs_run"] += int(torch.clamp((stop + 1) * TRACE_SLOT,
                                                     max=rows_real[c]).sum())
        if any_hit and warps is not None:
            wr = warps[rays]
            tested = torch.clamp(first_occ + 1, max=rows_real[c])
            top = torch.zeros(int(wr.max()) + 1, dtype=torch.int64, device=dev)
            top.scatter_reduce_(0, wr, tested, "amax")
            WORK["any_warp_slots"] += 32 * int(top.sum())
            WORK["any_pair_slots"] += any_compact_slots(wr // (BLOCK_RAYS // 32), stop,
                                                        rows_real[c])

    if pruned and entries:
        _walk_pruned(cset, entries, warps // (BLOCK_RAYS // 32), rows_real, rays9, best)
    if not any_hit:
        best_t, best_gid, best_row = best["t"], best["gid"], best["row"]
        best_u, best_v = best["u"], best["v"]
        # Winner attributes: columns n0 | n1 | n2 | material of the winning
        # row; the normal stays unnormalized until after the primitive fold.
        g = geom.reshape(C * K, -1)[:, _N0:_MAT + 1].index_select(0, best_row.clamp_min(0))
        w = 1.0 - best_u - best_v
        u, v = best_u, best_v
        nx = w * g[:, 0] + u * g[:, 3] + v * g[:, 6]
        ny = w * g[:, 1] + u * g[:, 4] + v * g[:, 7]
        nz = w * g[:, 2] + u * g[:, 5] + v * g[:, 8]
        mat = g[:, 9]

    # ---- analytic primitive fold (cosig_tpu/ops/kernel_core.py:930-1018) ----
    table = prims.tolist() if n_sph + n_box else []
    for p in range(n_sph + n_box):
        if any_hit:
            active = active & ~occ
            WORK["prim_tests"] += int(active.sum())
        m = table[p]
        # Object-space ray; the direction is NOT normalized, so t stays in
        # world parameterization.
        oxo = m[0] * ox + m[1] * oy + m[2] * oz + m[3]
        oyo = m[4] * ox + m[5] * oy + m[6] * oz + m[7]
        ozo = m[8] * ox + m[9] * oy + m[10] * oz + m[11]
        dxo = m[0] * dx + m[1] * dy + m[2] * dz
        dyo = m[4] * dx + m[5] * dy + m[6] * dz
        dzo = m[8] * dx + m[9] * dy + m[10] * dz
        if p < n_sph:
            # Unit sphere (HittableObjects.cs:83-108).
            a = dxo * dxo + dyo * dyo + dzo * dzo
            b = 2.0 * (oxo * dxo + oyo * dyo + ozo * dzo)
            c = oxo * oxo + oyo * oyo + ozo * ozo - 1.0
            disc = b * b - 4.0 * a * c
            sq = _sqrt(torch.maximum(disc, torch.zeros_like(disc)))
            t0 = (-b - sq) / (2.0 * a)
            t1 = (-b + sq) / (2.0 * a)
            tp = torch.where(t0 > EPSILON, t0, t1)
            valid = (disc >= 0.0) & (tp > EPSILON)
            # Object normal = the hit point on the unit sphere.
            nxo, nyo, nzo = oxo + tp * dxo, oyo + tp * dyo, ozo + tp * dzo
        else:
            # Unit cube [-0.5, 0.5]^3 (HittableObjects.cs:182-224), the
            # first-of-equals face pick of intersect.intersect_unit_box.
            ix, iy, iz = torch.reciprocal(dxo), torch.reciprocal(dyo), torch.reciprocal(dzo)
            t0x = (-0.5 - oxo) * ix
            t1x = (0.5 - oxo) * ix
            t0y = (-0.5 - oyo) * iy
            t1y = (0.5 - oyo) * iy
            t0z = (-0.5 - ozo) * iz
            t1z = (0.5 - ozo) * iz
            t_en = torch.maximum(
                torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                torch.minimum(t0z, t1z),
            )
            t_ex = torch.minimum(
                torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                torch.maximum(t0z, t1z),
            )
            tp = torch.where(t_en > EPSILON, t_en, t_ex)
            valid = (t_en <= t_ex) & (t_ex > EPSILON) & (tp > EPSILON)
            pxo, pyo, pzo = oxo + tp * dxo, oyo + tp * dyo, ozo + tp * dzo
            ax, ay, az = torch.abs(pxo), torch.abs(pyo), torch.abs(pzo)
            is_x = (ax >= ay) & (ax >= az)
            is_y = ~is_x & (ay >= az)
            nxo = torch.where(is_x, _sign(pxo), 0.0)
            nyo = torch.where(is_y, _sign(pyo), 0.0)
            nzo = torch.where(is_x | is_y, 0.0, _sign(pzo))
        valid = valid & active
        if any_hit:
            occ |= valid & (tp <= max_t)
            continue
        # World normal = inverse-transpose x object normal, unnormalized.
        wx_ = m[12] * nxo + m[13] * nyo + m[14] * nzo
        wy_ = m[15] * nxo + m[16] * nyo + m[17] * nzo
        wz_ = m[18] * nxo + m[19] * nyo + m[20] * nzo
        tm = torch.where(valid, tp, INF)
        gid_p = GID_SPH + 2.0 * p
        better = (tm < best_t) | ((tm == best_t) & (gid_p < best_gid))
        best_t = torch.where(better, tm, best_t)
        best_gid = torch.where(better, gid_p, best_gid)
        nx = torch.where(better, wx_, nx)
        ny = torch.where(better, wy_, ny)
        nz = torch.where(better, wz_, nz)
        mat = torch.where(better, m[21], mat)

    if any_hit:
        return occ, None, None, None, None, None

    hit = best_t < INF
    nx, ny, nz = _rsqrt3(nx, ny, nz)
    nx = torch.where(hit, nx, 0.0)
    ny = torch.where(hit, ny, 1.0)
    nz = torch.where(hit, nz, 0.0)
    mat = torch.where(hit, mat, -1.0)
    return hit, best_t, nx, ny, nz, mat


def _pair_valid(va, vb, vc, s, t) -> torch.Tensor:
    """The pair test's validity from its planes (kernel_core.py:838-842)."""
    return ((torch.abs(s) >= EPSILON) & (va * s >= 0.0) & (vb * s >= 0.0) & (vc * s >= 0.0)
            & (t > EPSILON))


def _pair_planes(g: torch.Tensor, r: torch.Tensor, rays9: tuple) -> tuple:
    """The exact pair test (kernel_core.py:818-842) of rays ``r`` [M] (ids
    into ``rays9``: o, d and the moment w, each [N]) against geometry rows
    ``g`` [1 or M, R, 36] -> (valid, t, vb, vc, 1/s), each [M, R]."""
    oxs, oys, ozs, dxs, dys, dzs, wxs, wys, wzs = (x[r, None] for x in rays9)

    def col(j):
        return g[:, :, j]

    va = (dxs * col(_VA) + dys * col(_VA + 1) + dzs * col(_VA + 2)
          + wxs * col(_VA + 3) + wys * col(_VA + 4) + wzs * col(_VA + 5))
    vb = (dxs * col(_VB) + dys * col(_VB + 1) + dzs * col(_VB + 2)
          + wxs * col(_VB + 3) + wys * col(_VB + 4) + wzs * col(_VB + 5))
    vc = (dxs * col(_VC) + dys * col(_VC + 1) + dzs * col(_VC + 2)
          + wxs * col(_VC + 3) + wys * col(_VC + 4) + wzs * col(_VC + 5))
    s = dxs * col(_GN) + dys * col(_GN + 1) + dzs * col(_GN + 2)
    ndo = oxs * col(_GN) + oys * col(_GN + 1) + ozs * col(_GN + 2)
    inv_s = torch.reciprocal(s)
    t = (col(_NDA) - ndo) * inv_s
    return _pair_valid(va, vb, vc, s, t), t, vb, vc, inv_s


def _fold_closest(best: dict, r, valid, t, vb, vc, inv_s, gid, row_ids) -> None:
    """Fold the pairs of rays ``r`` [M] with rows [M, R] (``gid`` and the flat
    ``row_ids`` [1 or M, R]) into the running winners ``best`` (t, gid, row,
    u, v; each [N]): the lexicographic (t, gid) minimum (kernel_core.py:861-902)."""
    tm = torch.where(valid, t, INF)
    tmin = tm.min(dim=1).values
    is_t = tm == tmin[:, None]
    gmin = torch.where(is_t, gid, float(GID_PAD)).min(dim=1).values
    j = (is_t & (gid == gmin[:, None])).to(torch.uint8).argmax(dim=1)
    ar = torch.arange(r.numel(), device=r.device)
    u = vb[ar, j] * inv_s[ar, j]
    v = vc[ar, j] * inv_s[ar, j]
    bt = best["t"][r]
    better = ((tmin < bt) | ((tmin == bt) & (gmin < best["gid"][r]))) & (tmin < INF)
    rb = r[better]
    best["t"][rb] = tmin[better]
    best["gid"][rb] = gmin[better]
    best["row"][rb] = row_ids.expand(r.numel(), -1)[ar, j][better]
    best["u"][rb] = u[better]
    best["v"][rb] = v[better]


def _walk_pruned(cset: ClusterSet, entries: list, blocks: torch.Tensor, rows_real: list,
                 rays9: tuple, best: dict) -> None:
    """The pair loop of the kernels' compacted closest hit (csrc/
    traverse_tile.cuh closest_pairs) on the box entries of a cull,
    ``entries`` [(cluster, rays [M], their tn [M])], ``blocks`` [N] each
    ray's block: each block walks its clusters near-first
    (:func:`near_first`), a cluster in pieces of TRACE_SLOT rows; at each
    piece a ray that entered the box runs its pairs unless
    :func:`prune_flags` prunes the piece from its key after the earlier
    pieces (``best``, folded in place). Adds the pairs run to
    ``WORK["pair_tests"]``, their compacted schedule to ``pair_slots`` and
    the pairs pruned to ``pairs_pruned``."""
    geom, aabb = cset.geom, cset.aabb_t
    C, K = int(geom.shape[0]), int(geom.shape[1])
    dev = geom.device
    e_c = torch.cat([torch.full_like(r, c) for c, r, _ in entries])
    e_r = torch.cat([r for _, r, _ in entries])
    e_tn = torch.cat([tn for _, _, tn in entries])
    e_b = blocks[e_r]
    n_blocks = int(blocks.max()) + 1
    pos = near_first(e_b, e_c, e_tn, n_blocks, C)
    by_pos = torch.argsort(pos, stable=True)
    starts = torch.searchsorted(pos[by_pos], torch.arange(int(pos.max()) + 2, device=dev))
    pieces = -(-K // TRACE_SLOT)
    n1 = piece_normals(geom)  # [C, pieces]
    real_rows = torch.tensor(rows_real, device=dev)
    ox, oy, oz = rays9[:3]
    for i in range(starts.numel() - 1):
        sel = by_pos[int(starts[i]):int(starts[i + 1])]  # each block's i-th cluster
        c, r, tn, b = e_c[sel], e_r[sel], e_tn[sel], e_b[sel]
        for p in range(pieces):
            first = p * TRACE_SLOT
            real = torch.clamp(real_rows[c] - first, 0, TRACE_SLOT)
            keep = ~prune_flags(tn, best["t"][r], ox[r], oy[r], oz[r], aabb[:6, c], n1[c, p])
            WORK["pair_tests"] += int((real * keep).sum())
            WORK["pairs_pruned"] += int((real * ~keep).sum())
            n_in = torch.zeros(n_blocks, dtype=torch.int64, device=dev).index_add_(
                0, b, keep.to(torch.int64))
            real_b = torch.zeros(n_blocks, dtype=torch.int64, device=dev).scatter_(0, b, real)
            WORK["pair_slots"] += BLOCK_RAYS * int(
                ((n_in * real_b + BLOCK_RAYS - 1) // BLOCK_RAYS).sum())
            run = torch.nonzero(keep & (real > 0)).squeeze(1)
            rows = min(TRACE_SLOT, K - first)
            chunk = max(1, (1 << 18) // rows)
            for lo in range(0, int(run.numel()), chunk):
                k = run[lo:lo + chunk]
                g = geom[c[k], first:first + rows]  # [M, rows, 36]
                valid, t, vb, vc, inv_s = _pair_planes(g, r[k], rays9)
                _fold_closest(best, r[k], valid, t, vb, vc, inv_s, g[:, :, _GID],
                              c[k, None] * K + first + torch.arange(rows, device=dev)[None])


# ---------------------------------------------------------------------------
# One Whitted bounce on the ray state


def bounce_trace(cset: ClusterSet, state: torch.Tensor, prims=None, n_sph: int = 0,
                 n_box: int = 0, warps=None, packets=None, frustum: bool = False,
                 mx: bool = False) -> tuple:
    """The closest-hit half of a bounce (cosig_tpu/ops/kernel_core.py:1042-1056):
    count the live rays of ``state`` in place and trace them -> the hit
    record ``(hit, t, nx, ny, nz, mat)`` of :func:`traverse` (``mx``: its
    tensor-core form)."""
    alive = state[ROW_ALIVE] > 0.0
    state[ROW_COUNT] = state[ROW_COUNT] + alive.to(torch.float32)
    return traverse(cset, state[0], state[1], state[2], state[3], state[4], state[5], alive,
                    prims=prims, n_sph=n_sph, n_box=n_box, warps=warps, packets=packets,
                    frustum=frustum, mx=mx)


def rec_store(state: torch.Tensor, rec: tuple) -> None:
    """Write a hit record into the fission rows 15-19 of ``state``."""
    _, t, nx, ny, nz, mat = rec
    for r, v in enumerate((t, nx, ny, nz, mat)):
        state[REC0 + r] = v


def rec_load(state: torch.Tensor) -> tuple:
    """The hit record of rows 15-19 -> ``(hit, t, nx, ny, nz, mat)``, with
    ``hit`` recomputed as ``t < INF``: exactly the traversal's own value,
    whose t is INF on a miss and below it on every hit."""
    t = state[REC0]
    return t < INF, t, state[REC0 + 1], state[REC0 + 2], state[REC0 + 3], state[REC0 + 4]


def bounce_core(cfg: StaticConfig, uniforms: np.ndarray, mats: np.ndarray,
                lights: np.ndarray, cset: ClusterSet, state: torch.Tensor,
                px, py, s, depth: int, is_last: bool,
                prims=None, n_sph: int = 0, n_box: int = 0, warps=None,
                packets=None, frustum: bool = False, rec=None, cset_shadow=None,
                mxu: str = "off") -> None:
    """One Whitted bounce on ``state`` [16, N] in place (compute:356-473;
    kernel_core.py:1058-1270): count and trace the live rays, add the
    background on a miss, shade the hits (ambient, then per light a
    shadow ray, Lambert and Blinn-Phong), and turn each surviving ray
    into its secondary (refraction first, TIR reflects about the flipped
    normal, else mirror reflection).

    ``px``/``py``/``s`` are the RNG seed planes (read only with soft
    shadows or glossy); ``depth`` is the bounce index; ``is_last`` skips
    the secondary ray and retires every ray. ``prims``/``n_sph``/``n_box``
    are the analytic primitives both traversals fold in, ``warps`` the ray ->
    warp map whose pair-loop slots they count, ``packets`` the ray -> block
    map of the kernel's block walk and ``frustum`` whether the block's
    frustum pre-cull runs, for the closest hit and the shadow rays alike
    (:func:`traverse`).

    ``rec``: a hit record of :func:`bounce_trace` (or :func:`rec_load`):
    this call is then the shade half and traces no closest hit (the fission
    form). ``cset_shadow``: the cluster set every shadow ray walks, a
    coarser cut of the same triangles (default ``cset``); occlusion does
    not depend on the cut, so neither do the results.

    ``mxu``: the pair test's form (:data:`MXU_MODES`): ``"full"`` runs the
    tensor-core form in the closest hit and the shadow rays, ``"closest"``
    in the closest hit only; the caller has applied :func:`mxu_mode`. The
    shadow rays through a separate ``cset_shadow`` always take the exact
    test, as the JAX package's shadow traversal (which gets no ``geom_mx``,
    ``cosig_tpu/ops/trace_wavefront.py:247-267``)."""
    u = [float(x) for x in uniforms]
    bg = (u[U_BG], u[U_BG + 1], u[U_BG + 2])
    intensity = u[U_INTENSITY]
    light_size = u[U_LIGHT_SIZE]
    roughness = u[U_ROUGHNESS]
    depth_f = float(depth)

    pk = dict(prims=prims, n_sph=n_sph, n_box=n_box, warps=warps, packets=packets,
              frustum=frustum)
    if rec is None:
        rec = bounce_trace(cset, state, mx=mxu != "off", **pk)
    hit, t, nx, ny, nz, mat_c = rec
    shadow_set = cset if cset_shadow is None else cset_shadow

    ox, oy, oz = state[0], state[1], state[2]
    dx, dy, dz = state[3], state[4], state[5]
    at_r, at_g, at_b = state[6], state[7], state[8]
    scol_r, scol_g, scol_b = state[9], state[10], state[11]
    alive = state[ROW_ALIVE] > 0.0

    miss = alive & ~hit
    scol_r = scol_r + torch.where(miss, at_r * bg[0], 0.0)
    scol_g = scol_g + torch.where(miss, at_g * bg[1], 0.0)
    scol_b = scol_b + torch.where(miss, at_b * bg[2], 0.0)
    alive = alive & hit

    hx = ox + t * dx
    hy = oy + t * dy
    hz = oz + t * dz

    props = [torch.full_like(ox, d) for d in MAT_DEFAULTS]
    for m in range(mats.shape[0]):
        is_m = mat_c == float(m)
        for p in range(8):
            props[p] = torch.where(is_m, float(mats[m, p]), props[p])
    cr, cg, cb, ka, kd, ks, krefr, ior = props

    zeros = torch.zeros_like(ox)
    loc_r = cr * ka if cfg.enable_ambient else zeros
    loc_g = cg * ka if cfg.enable_ambient else zeros
    loc_b = cb * ka if cfg.enable_ambient else zeros

    for li in range(lights.shape[0]):
        lpx = torch.full_like(ox, float(lights[li, 0]))
        lpy = torch.full_like(ox, float(lights[li, 1]))
        lpz = torch.full_like(ox, float(lights[li, 2]))
        if cfg.enable_soft_shadows:
            jx, jy, jz = rng.random_unit_vector_planes(px + s * 9.0, py + s * 4.0 + depth_f, s)
            lpx = lpx + jx * light_size
            lpy = lpy + jy * light_size
            lpz = lpz + jz * light_size

        tlx = lpx - hx
        tly = lpy - hy
        tlz = lpz - hz
        dist_l = _sqrt(tlx * tlx + tly * tly + tlz * tlz)
        ldx, ldy, ldz = _rsqrt3(tlx, tly, tlz)
        ndl = torch.maximum(zeros, nx * ldx + ny * ldy + nz * ldz)

        if cfg.enable_diffuse:
            shadow_active = alive & (ndl > 0.0)
            state[ROW_COUNT] = state[ROW_COUNT] + shadow_active.to(torch.float32)
            s_occ = traverse(
                shadow_set, hx + nx * OFFSET, hy + ny * OFFSET, hz + nz * OFFSET,
                ldx, ldy, ldz, shadow_active, max_t=dist_l, any_hit=True,
                mx=mxu == "full" and cset_shadow is None,
                **pk,
            )[0]
            gate = ~s_occ & (ndl > 0.0) & alive
            dr = cr * kd * ndl
            dg = cg * kd * ndl
            db = cb * kd * ndl
            if cfg.enable_specular:
                hvx, hvy, hvz = _rsqrt3(ldx - dx, ldy - dy, ldz - dz)
                spec = _pow32(torch.maximum(nx * hvx + ny * hvy + nz * hvz, zeros))
                dr = dr + ks * spec
                dg = dg + ks * spec
                db = db + ks * spec
            if cfg.multi_light:
                dr = dr * float(lights[li, 3])
                dg = dg * float(lights[li, 4])
                db = db * float(lights[li, 5])
            loc_r = loc_r + torch.where(gate, dr, 0.0)
            loc_g = loc_g + torch.where(gate, dg, 0.0)
            loc_b = loc_b + torch.where(gate, db, 0.0)

    state[9] = scol_r + torch.where(alive, at_r * loc_r * intensity, 0.0)
    state[10] = scol_g + torch.where(alive, at_g * loc_g * intensity, 0.0)
    state[11] = scol_b + torch.where(alive, at_b * loc_b * intensity, 0.0)

    if is_last:
        state[ROW_ALIVE] = 0.0
        return  # no secondary rays after the final bounce

    # ---- secondary ray (compute:420-455) ----
    should_reflect = ks > 0.0
    should_refract = (krefr > 0.0) if cfg.enable_refraction else torch.zeros_like(alive)

    cos_in = dx * nx + dy * ny + dz * nz
    exiting = cos_in > 0.0
    fnx = torch.where(exiting, -nx, nx)
    fny = torch.where(exiting, -ny, ny)
    fnz = torch.where(exiting, -nz, nz)
    eta = torch.where(exiting, ior, torch.reciprocal(ior))
    cos = -(dx * fnx + dy * fny + dz * fnz)
    kk = 1.0 - eta * eta * (1.0 - cos * cos)
    tir = kk < 0.0
    coef = eta * cos - _sqrt(torch.maximum(kk, zeros))
    rfx = eta * dx + coef * fnx
    rfy = eta * dy + coef * fny
    rfz = eta * dz + coef * fnz
    dot_f = dx * fnx + dy * fny + dz * fnz
    tirx = dx - 2.0 * dot_f * fnx
    tiry = dy - 2.0 * dot_f * fny
    tirz = dz - 2.0 * dot_f * fnz
    dot_p = cos_in
    rpx = dx - 2.0 * dot_p * nx
    rpy = dy - 2.0 * dot_p * ny
    rpz = dz - 2.0 * dot_p * nz

    ndx = torch.where(should_refract, torch.where(tir, tirx, rfx), rpx)
    ndy = torch.where(should_refract, torch.where(tir, tiry, rfy), rpy)
    ndz = torch.where(should_refract, torch.where(tir, tirz, rfz), rpz)
    amr = torch.where(should_refract, torch.where(tir, cr * ks, cr * krefr), cr * ks)
    amg = torch.where(should_refract, torch.where(tir, cg * ks, cg * krefr), cg * ks)
    amb = torch.where(should_refract, torch.where(tir, cb * ks, cb * krefr), cb * ks)
    sox = torch.where(should_refract,
                      torch.where(tir, hx + fnx * OFFSET, hx + rfx * OFFSET),
                      hx + nx * OFFSET)
    soy = torch.where(should_refract,
                      torch.where(tir, hy + fny * OFFSET, hy + rfy * OFFSET),
                      hy + ny * OFFSET)
    soz = torch.where(should_refract,
                      torch.where(tir, hz + fnz * OFFSET, hz + rfz * OFFSET),
                      hz + nz * OFFSET)

    if cfg.enable_glossy:
        gx, gy, gz = rng.random_unit_vector_planes(px + s * 55.0 + depth_f, py + s * 22.0,
                          torch.full_like(ox, 13.0) * depth_f)
        ndx = ndx + gx * roughness
        ndy = ndy + gy * roughness
        ndz = ndz + gz * roughness

    cont = alive & (should_reflect | should_refract)
    ndx, ndy, ndz = _rsqrt3(ndx, ndy, ndz)
    at_r = torch.where(cont, at_r * amr, at_r)
    at_g = torch.where(cont, at_g * amg, at_g)
    at_b = torch.where(cont, at_b * amb, at_b)
    state[6] = at_r
    state[7] = at_g
    state[8] = at_b
    state[0] = torch.where(cont, sox, ox)
    state[1] = torch.where(cont, soy, oy)
    state[2] = torch.where(cont, soz, oz)
    state[3] = torch.where(cont, ndx, dx)
    state[4] = torch.where(cont, ndy, dy)
    state[5] = torch.where(cont, ndz, dz)
    max_at = torch.maximum(torch.maximum(at_r, at_g), at_b)
    state[ROW_ALIVE] = (cont & (max_at > 0.0)).to(torch.float32)
