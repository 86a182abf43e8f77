"""Flat cluster structure over the triangle soup (host build, numpy).

Counterpart of :func:`cosig_tpu.accel.clusters.build_clusters`
(``clusters.py:236-483``): the reference-style median-split BVH
(:mod:`cosig_tpu_torch.accel.bvh`) is cut into leaves of at most ``k``
triangles; leaves are chunked, packed and become *clusters*, each padded
to exactly ``k`` rows of precomputed Plücker constants. The kernels test
a ray against the cluster boxes (after two exact pre-filters: the
superblock unions and, for coherent rays, the packet's bounding frustum)
and run the exact pair test on the clusters it may enter.

Kept from the JAX build, bit for bit: the auto-k rule and the explicit
``k``, leaf chunking and packing, gid-sorted rows, the inflated boxes,
the NaN padding columns and the superblock unions. Dropped: the sub-cluster boxes (``sub_aabb_t``,
never read by the traversal) and the TPU matrix-unit operands
(``geom_mx``/``gatt``).

Layout (same as the JAX package, so the two can share one structure):

* ``geom [C, K, GEOM_COMPS]`` f32 — per-triangle constants (columns below);
* ``aabb_t [8, C_pad]`` f32 — rows min.xyz / max.xyz, NaN padding columns;
* ``sb_aabb_t [8, 128]`` f32 — unions of CULL_BLOCK-cluster superblocks;
* ``mats [M, 8]`` f32 — color rgb, ambient, diffuse, specular, refraction, ior
  (and ``mats_host``, the same table in numpy).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from cosig_tpu_torch.accel.bvh import build_bvh
from cosig_tpu_torch.scene.tessellate import TriangleSoA
from cosig_tpu_torch.ops.intersect import plucker_constants_host

log = logging.getLogger("cosig_tpu_torch.clusters")

F32 = np.float32

# Geometry component columns:
# 0:3 v0 | 3:6 n | 6 n.A | 7:13 VA d/w coeffs | 13:19 VB | 19:25 VC |
# 25:28 n0 | 28:31 n1 | 31:34 n2 | 34 material | 35 global tri index
V0 = 0
GN = 3
NDA = 6
VA = 7
VB = 13
VC = 19
N0, N1, N2 = 25, 28, 31
MAT = 34
GID = 35  # original (pre-BVH-reorder) soup index, f32 (exact below 2^24)
GEOM_COMPS = 36

# GID of padding rows / the no-hit state: above every real index.
GID_PAD = F32(2 ** 24)

DEFAULT_K = 32
AUTO_K_MAX_C = 256  # auto rule: double k while the cut is wider than this

CULL_BLOCK = 512  # clusters per superblock
MAX_SUPERBLOCKS = 128  # sb_aabb_t width
MAX_CLUSTERS = MAX_SUPERBLOCKS * CULL_BLOCK  # 65,536: the most that sb_aabb_t covers

# The JAX package's default cut (its COSIG_LEAF_MULT / COSIG_CLUSTER_PACK /
# COSIG_PACK_SA sweep knobs at their defaults): stop the median split at
# LEAF_MULT * k triangles, then pack consecutive chunks up to k while the
# merged box's surface area stays within PACK_SA x the parts' sum.
LEAF_MULT = 4
PACK_SA = 2.0


@dataclass(frozen=True)
class ClusterSet:
    geom: torch.Tensor  # [C, K, GEOM_COMPS] f32
    aabb_t: torch.Tensor  # [8, C_pad] f32
    sb_aabb_t: torch.Tensor  # [8, 128] f32
    mats: torch.Tensor  # [M, 8] f32
    num_triangles: int
    # The material table on the host, kept beside ``mats`` (on any device)
    # so that a frame packs its materials without a copy from the device.
    mats_host: np.ndarray = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.mats_host is None:
            object.__setattr__(self, "mats_host",
                               np.ascontiguousarray(self.mats.detach().cpu().numpy(), F32))

    @property
    def num_clusters(self) -> int:
        return int(self.geom.shape[0])

    @property
    def k(self) -> int:
        return int(self.geom.shape[1])

    @property
    def device(self) -> torch.device:
        return self.geom.device

    def to(self, device) -> "ClusterSet":
        return replace(
            self,
            geom=self.geom.to(device),
            aabb_t=self.aabb_t.to(device),
            sb_aabb_t=self.sb_aabb_t.to(device),
            mats=self.mats.to(device),
        )


def cluster_set_from_arrays(geom, aabb_t, sb_aabb_t, mats) -> ClusterSet:
    """A ClusterSet over given numpy arrays (e.g. the JAX package's
    ``ClusterSet`` fields), on the CPU. Padding rows carry ``GID_PAD``, so
    the real triangle count is the number of other rows."""
    geom = np.ascontiguousarray(geom, F32)
    if geom.ndim != 3 or geom.shape[2] != GEOM_COMPS:
        raise ValueError(f"geom must be [C, K, {GEOM_COMPS}], got {geom.shape}")
    return ClusterSet(
        geom=torch.from_numpy(geom.copy()),
        aabb_t=torch.from_numpy(np.array(aabb_t, F32)),
        sb_aabb_t=torch.from_numpy(np.array(sb_aabb_t, F32)),
        mats=torch.from_numpy(np.array(mats, F32)),
        num_triangles=int((geom[:, :, GID] != GID_PAD).sum()),
    )


def superblocks(n_clusters: int) -> int:
    """Superblocks the walks over ``n_clusters`` clusters test: none up to
    one superblock (the JAX kernel's ``n_blocks == 1``), one per CULL_BLOCK
    clusters up to MAX_SUPERBLOCKS, and none past MAX_CLUSTERS, where
    ``sb_aabb_t`` holds no box for the rest and the walk is flat, which is
    exact (the JAX build drops the superblocks past 128). The kernels pick
    their build by the same rule (csrc/traverse.cuh ``superblocks``)."""
    n_sb = -(-n_clusters // CULL_BLOCK)
    return n_sb if 1 < n_sb <= MAX_SUPERBLOCKS else 0


def superblock_aabbs(aabb_t: np.ndarray) -> np.ndarray:
    """Union AABBs of CULL_BLOCK-cluster superblocks -> [8, 128] (NaN pad)."""
    c_pad = aabb_t.shape[1]
    n_sb = -(-c_pad // CULL_BLOCK)
    sb = np.full((8, MAX_SUPERBLOCKS), np.nan, F32)
    with np.errstate(all="ignore"):
        for s in range(min(n_sb, MAX_SUPERBLOCKS)):
            blk = aabb_t[:, s * CULL_BLOCK : (s + 1) * CULL_BLOCK]
            if np.isnan(blk).all():
                continue
            sb[0:3, s] = np.nanmin(blk[0:3], axis=1)
            sb[3:6, s] = np.nanmax(blk[3:6], axis=1)
    return sb


def _cut(tris: TriangleSoA, k: int):
    """Median-split BVH cut at ``k * LEAF_MULT`` triangles, leaves chunked
    into balanced <= k pieces, consecutive chunks packed up to k while the
    merged box's surface area stays within PACK_SA x the parts' sum."""
    bvh = build_bvh(tris, max_leaf=k * LEAF_MULT)
    leaf_idx = np.nonzero(bvh.count > 0)[0]
    ranges = [(int(bvh.left_or_first[i]), int(bvh.count[i]), i) for i in leaf_idx]
    chunks = []
    for first, count, node in ranges:
        n_ch = -(-count // k)
        lo = count // n_ch
        extra = count - lo * n_ch  # the first `extra` chunks get lo+1
        off = 0
        for i in range(n_ch):
            sz = lo + (1 if i < extra else 0)
            chunks.append((first + off, sz, node))
            off += sz

    if len(chunks) > 1:
        tri_min = np.minimum(np.minimum(tris.v0, tris.v1), tris.v2)
        tri_max = np.maximum(np.maximum(tris.v0, tris.v1), tris.v2)
        order = bvh.order

        def _range_box(first, count):
            sl = order[first:first + count]
            return tri_min[sl].min(axis=0), tri_max[sl].max(axis=0)

        def _sa(lo, hi):
            d = hi - lo
            return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

        chunks.sort(key=lambda ch: ch[0])
        packed = []
        cf, cc, cn = chunks[0]
        clo, chi = _range_box(cf, cc)
        for first, count, node in chunks[1:]:
            if cc + count <= k:
                lo, hi = _range_box(first, count)
                mlo = np.minimum(clo, lo)
                mhi = np.maximum(chi, hi)
                if _sa(mlo, mhi) <= PACK_SA * (_sa(clo, chi) + _sa(lo, hi)):
                    cc += count
                    clo, chi = mlo, mhi
                    continue
            packed.append((cf, cc, cn))
            cf, cc, cn = first, count, node
            clo, chi = _range_box(cf, cc)
        packed.append((cf, cc, cn))
        chunks = packed
    return bvh, chunks


def build_clusters(tris: TriangleSoA, mats_host: np.ndarray, k: int | None = None) -> ClusterSet:
    """Build the cluster structure on the host -> ClusterSet on the CPU.

    ``mats_host``: [M, 8] material table (color rgb + the five coefficients,
    see :func:`cosig_tpu_torch.models.soa.materials_host`). ``k``: the
    cluster size; ``None`` follows the JAX package's auto rule: start at
    DEFAULT_K and double while the cut has more than AUTO_K_MAX_C clusters,
    up to 128. Raises ``ValueError`` on a ``k`` that is not a positive int.
    ``sb_aabb_t`` holds the first MAX_SUPERBLOCKS superblocks, as the JAX
    build's; a cut of more than MAX_CLUSTERS clusters is walked flat
    (:func:`superblocks`)."""
    if k is not None and (not isinstance(k, int) or k <= 0):
        raise ValueError(f"cluster size k must be a positive int or None (auto); got {k!r}")
    mats = torch.from_numpy(np.ascontiguousarray(mats_host, F32).copy())
    t = tris.count
    auto_k = k is None
    if auto_k:
        k = DEFAULT_K
    if t == 0:
        geom = np.zeros((1, k, GEOM_COMPS), F32)
        geom[:, :, GID] = GID_PAD
        aabb_t = np.full((8, 128), np.nan, F32)
        return ClusterSet(
            geom=torch.from_numpy(geom),
            aabb_t=torch.from_numpy(aabb_t),
            sb_aabb_t=torch.from_numpy(superblock_aabbs(aabb_t)),
            mats=mats,
            num_triangles=0,
        )

    bvh, chunks = _cut(tris, k)
    while auto_k and len(chunks) > AUTO_K_MAX_C and k < 128:
        k *= 2
        bvh, chunks = _cut(tris, k)
    log.info("clusters: k=%d%s cut=%d (tris=%d)", k, " (auto)" if auto_k else "", len(chunks), t)

    c = len(chunks)
    if c > MAX_CLUSTERS:
        log.info("clusters: %d > %d, past the superblocks sb_aabb_t holds: no superblock cull, "
                 "the walks are flat", c, MAX_CLUSTERS)
    c_pad = -(-c // 128) * 128
    if c_pad > CULL_BLOCK:
        c_pad = -(-c // CULL_BLOCK) * CULL_BLOCK
    if t >= 2 ** 24:
        raise ValueError(f"{t} triangles: the global tri index must stay f32-exact (< 2^24)")
    geom = np.zeros((c, k, GEOM_COMPS), F32)
    geom[:, :, GID] = GID_PAD  # padding rows: all-zero constants never hit
    aabb_t = np.full((8, c_pad), np.nan, F32)
    rt = bvh.triangles
    for ci, (first, count, _node) in enumerate(chunks):
        # Rows sorted ascending by original soup index.
        sl = first + np.argsort(bvh.order[first:first + count], kind="stable")
        pk = plucker_constants_host(rt.v0[sl], rt.v1[sl], rt.v2[sl])
        geom[ci, :count, V0 : V0 + 3] = rt.v0[sl]
        geom[ci, :count, GN : GN + 3] = pk["n"]
        geom[ci, :count, NDA] = pk["n_dot_a"]
        geom[ci, :count, VA : VA + 3] = pk["va_d"]
        geom[ci, :count, VA + 3 : VA + 6] = pk["va_w"]
        geom[ci, :count, VB : VB + 3] = pk["vb_d"]
        geom[ci, :count, VB + 3 : VB + 6] = pk["vb_w"]
        geom[ci, :count, VC : VC + 3] = pk["vc_d"]
        geom[ci, :count, VC + 3 : VC + 6] = pk["vc_w"]
        geom[ci, :count, N0 : N0 + 3] = rt.n0[sl]
        geom[ci, :count, N1 : N1 + 3] = rt.n1[sl]
        geom[ci, :count, N2 : N2 + 3] = rt.n2[sl]
        geom[ci, :count, MAT] = rt.material[sl].astype(F32)
        # Original soup index: the (t, gid) tie-break key.
        geom[ci, :count, GID] = bvh.order[sl].astype(F32)
        v = np.concatenate([rt.v0[sl], rt.v1[sl], rt.v2[sl]], axis=0)
        vmin = v.min(axis=0)
        vmax = v.max(axis=0)
        # Conservative inflation, far above the slab test's rounding error,
        # so the cull is a true superset of the pair test (clusters.py:443-452).
        pad = F32(1e-4) + F32(1e-5) * (vmax - vmin)
        aabb_t[0:3, ci] = vmin - pad
        aabb_t[3:6, ci] = vmax + pad

    return ClusterSet(
        geom=torch.from_numpy(geom),
        aabb_t=torch.from_numpy(aabb_t),
        sb_aabb_t=torch.from_numpy(superblock_aabbs(aabb_t)),
        mats=mats,
        num_triangles=t,
    )
