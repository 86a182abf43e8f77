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
the NaN padding columns, the superblock unions and the matrix-unit
operand ``geom_mx`` of the tensor-core form of the pair test
(:func:`pack_mx`). Dropped: the sub-cluster boxes (``sub_aabb_t``, never
read by the traversal) and ``gatt``, the per-triangle attributes that the
TPU kernel gathers for the winner by a one-hot contraction: that
contraction rebuilds geom columns 25-35 exactly, and the port reads those
columns of the winning row instead (``csrc/traverse.cuh``
``finish_closest``, ``kernel_core.traverse``).

Layout (same as the JAX package, so the two can share one structure):

* ``geom [C, K, GEOM_COMPS]`` f32 — per-triangle constants (columns below);
* ``aabb_t [8, C_pad]`` f32 — rows min.xyz / max.xyz, NaN padding columns;
* ``sb_aabb_t [8, 128]`` f32 — unions of CULL_BLOCK-cluster superblocks;
* ``mats [M, 8]`` f32 — color rgb, ambient, diffuse, specular, refraction, ior
  (and ``mats_host``, the same table in numpy);
* ``geom_mx [C, 5K, 64]`` bf16 — the tensor-core form's operand
  (:func:`pack_mx`): the JAX package's ``geom_mx [C, 6K, 64]`` without its
  last row group, the gid plane, which only the TPU's chunk-level
  selection reads. ``build_clusters`` packs it for a set whose geometry is
  at most ``STREAM_THRESHOLD_BYTES``; a larger set (which the JAX package
  streams, keeping the exact test) carries None.
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

# The tensor-core form of the pair test (cosig_tpu/accel/clusters.py:70-103):
# every f32 coefficient and ray input splits into three bf16 limbs (limbs),
# and the limb products (j, k) with j + k <= 2 become contraction columns:
# column ci * 10 + i of a plane's row holds limb j of coefficient i, the
# ray's staged column limb k of input i (0:3 origin, 3:6 direction, 6:9
# moment w = o x d, 9 the constant 1), for MX_COMBOS[ci] = (j, k).
MX_COMBOS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
MX_COLS = 64  # 10 inputs x 6 combos, zero-padded
MX_PLANES = 5  # va, vb, vc, s = d.n, num = nda - o.n (JAX's sixth, the gid plane, dropped)
# Geometry above this many bytes streams on the TPU, which then keeps the
# exact pair test (cosig_tpu/ops/kernel_core.py:90); the port applies the
# same rule per stage.
STREAM_THRESHOLD_BYTES = 6 * 1024 * 1024

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
    # [C, 5K, 64] bf16 (pack_mx), or None (a set past STREAM_THRESHOLD_BYTES).
    geom_mx: torch.Tensor = field(default=None, compare=False, repr=False)

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

    @property
    def geom_bytes(self) -> int:
        """Bytes of ``geom``, the size the streaming rule reads."""
        return 4 * self.geom.numel()

    @property
    def streamed(self) -> bool:
        """Whether the JAX package streams this set's geometry, and so keeps
        the exact pair test where the tensor-core form is asked for."""
        return self.geom_bytes > STREAM_THRESHOLD_BYTES

    def to(self, device) -> "ClusterSet":
        return replace(
            self,
            geom=self.geom.to(device),
            aabb_t=self.aabb_t.to(device),
            sb_aabb_t=self.sb_aabb_t.to(device),
            mats=self.mats.to(device),
            geom_mx=None if self.geom_mx is None else self.geom_mx.to(device),
        )


def cluster_set_from_arrays(geom, aabb_t, sb_aabb_t, mats, geom_mx=None) -> ClusterSet:
    """A ClusterSet over given numpy arrays (e.g. the JAX package's
    ``ClusterSet`` fields), on the CPU. Padding rows carry ``GID_PAD``, so
    the real triangle count is the number of other rows. ``geom_mx``: the
    tensor-core operand, [C, 5K, 64] or the JAX package's [C, 6K, 64] (its
    gid plane is dropped), as bf16 (a torch tensor, or numpy of an ml_dtypes
    bfloat16 or uint16 bit pattern); None leaves the set without it."""
    geom = np.ascontiguousarray(geom, F32)
    if geom.ndim != 3 or geom.shape[2] != GEOM_COMPS:
        raise ValueError(f"geom must be [C, K, {GEOM_COMPS}], got {geom.shape}")
    c, k = geom.shape[:2]
    if geom_mx is not None:
        if not isinstance(geom_mx, torch.Tensor):
            bits = np.ascontiguousarray(geom_mx)
            if bits.dtype.itemsize != 2:
                raise ValueError(f"geom_mx must hold bf16 values, got {bits.dtype}")
            geom_mx = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
        if (geom_mx.dtype != torch.bfloat16 or geom_mx.dim() != 3 or geom_mx.shape[0] != c
                or geom_mx.shape[1] not in (MX_PLANES * k, (MX_PLANES + 1) * k)
                or geom_mx.shape[2] != MX_COLS):
            raise ValueError(f"geom_mx must be bf16 [{c}, {MX_PLANES} * {k}, {MX_COLS}], got "
                             f"{geom_mx.dtype} {tuple(geom_mx.shape)}")
        geom_mx = geom_mx[:, :MX_PLANES * k].contiguous()
    return ClusterSet(
        geom=torch.from_numpy(geom.copy()),
        aabb_t=torch.from_numpy(np.array(aabb_t, F32)),
        sb_aabb_t=torch.from_numpy(np.array(sb_aabb_t, F32)),
        mats=torch.from_numpy(np.array(mats, F32)),
        num_triangles=int((geom[:, :, GID] != GID_PAD).sum()),
        geom_mx=geom_mx,
    )


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to bfloat16, to nearest even, by integer
    operations on the bits (the same on every device and CPU build, and
    ml_dtypes' and ``__float2bfloat16_rn``'s rounding: subnormals kept, a
    NaN stays a quiet NaN)."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    r = torch.where((u & 0x7FFFFFFF) > 0x7F800000, (u | 0x00400000) & 0xFFFF0000, r)
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(torch.float32)


def limbs(a) -> tuple:
    """Split float32 values (a tensor or an array) into three bf16 limbs ->
    (l0, l1, l2) float32 tensors with a == l0 + l1 + l2 exactly: l0 the
    value rounded to bf16, then each residual (an exact float32
    subtraction) rounded the same way (cosig_tpu/accel/clusters.py:105)."""
    a = a.to(torch.float32) if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, F32))
    l0 = bf16_round(a)
    r = a - l0
    l1 = bf16_round(r)
    return l0, l1, bf16_round(r - l1)


def pack_mx(geom) -> torch.Tensor:
    """The tensor-core operand of a finished geometry block [C, K, 36] (a
    tensor or an array) -> bf16 [C, 5K, 64] on the CPU: per cluster the
    row groups va, vb, vc, s and num of cosig_tpu/accel/clusters.py:119
    ``_pack_mx``, bit for bit (its sixth, the gid plane, left out). Column
    ci * 10 + i of a row holds limb MX_COMBOS[ci][0] of the row's
    coefficient of input i; padding rows are zeros."""
    g = (geom.to(torch.float32).cpu() if isinstance(geom, torch.Tensor)
         else torch.from_numpy(np.array(geom, F32)))
    c, k, _ = g.shape
    coef = torch.zeros((c, MX_PLANES * k, 10), dtype=torch.float32)
    coef[:, 0 * k:1 * k, 3:9] = g[:, :, VA:VA + 6]
    coef[:, 1 * k:2 * k, 3:9] = g[:, :, VB:VB + 6]
    coef[:, 2 * k:3 * k, 3:9] = g[:, :, VC:VC + 6]
    coef[:, 3 * k:4 * k, 3:6] = g[:, :, GN:GN + 3]
    coef[:, 4 * k:5 * k, 0:3] = -g[:, :, GN:GN + 3]
    coef[:, 4 * k:5 * k, 9] = g[:, :, NDA]
    lim = limbs(coef)
    mx = torch.zeros((c, MX_PLANES * k, MX_COLS), dtype=torch.float32)
    for ci, (j, _) in enumerate(MX_COMBOS):
        mx[:, :, ci * 10:ci * 10 + 10] = lim[j]
    return mx.to(torch.bfloat16)  # exact: every limb is a bf16 value


def _geom_mx(geom: np.ndarray):
    """pack_mx of a set the tensor-core form runs on, else None."""
    return pack_mx(geom) if 4 * geom.size <= STREAM_THRESHOLD_BYTES else None


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
            geom_mx=_geom_mx(geom),
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
        geom_mx=_geom_mx(geom),
    )
