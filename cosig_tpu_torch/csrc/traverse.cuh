// The per-ray and per-pair arithmetic of the cluster traversal (closest
// hit and any hit): the slab test, the pair test, the (t, gid) fold and
// the epilogue with the analytic fold.
//
// Replaces the traversal that every TPU kernel inlines,
// cosig_tpu/ops/kernel_core.py make_traverse (:200-1035). On the TPU a
// tile of 4096 rays culls all clusters in one vector slab test, compacts
// the hit list in scalar memory and intersects each listed cluster's
// (K, rays) pair grid on the vector unit. Here every kernel walks a
// thread block's rays together (traverse_tile.cuh, the schedule); the
// functions below take their operands as values, so the walk decides
// only where they are loaded from. What the result must keep from the
// TPU version is the per-pair arithmetic, not the schedule:
//
//  * the slab test is NaN-conservative: min/max propagate NaN and the
//    tests are inverted, so a NaN slab (0 * inf from a zero direction
//    component on a box plane, or a NaN padding column) passes and the
//    exact pair test decides (kernel_core.py:410-453). fminf/fmaxf drop
//    NaN, hence nan_min/nan_max below, and slab_min/slab_max, the same
//    in one instruction, in the slab test;
//  * the Plücker chain order of kernel_core.py:818-842, with the build's
//    --fmad=false so nothing is contracted;
//  * the winner is the lexicographic (t, gid) minimum over all valid
//    pairs (kernel_core.py:861-902). That fold does not depend on visit
//    order or clustering, so the block walk picks the TPU's winner;
//  * normalization is 1/sqrt then multiply (kernel_core.py:137-140);
//  * analytic spheres and boxes (the prims table of ops/analytic.py,
//    passed as a device pointer beside the cluster set) fold in after the
//    cluster walk, as kernel_core.py:930-1018 does: the object-space ray is
//    not normalized, box slabs use nan_min/nan_max (1/d is inf on an
//    axis-parallel ray), the face sign is jnp.sign's (0 at 0, so not
//    copysignf), and tie ids GID_SPH + 2p sit above every triangle id, so
//    a primitive loses an equal-t tie to a triangle. The world normal stays
//    unnormalized until the shared epilogue.
//
// Two pre-filters run before the slab test, as on the TPU: the superblock
// cull (kernel_core.py:545-590: with 513 to 65,536 clusters, the union
// boxes of sb_aabb_t, one per 512 clusters) and, for coherent packets, the
// bounding-frustum cull (kernel_core.py:455-517: a packet's hull of
// origins and directions against a box by interval arithmetic). Both go
// through frustum_pass below, the superblock cull of incoherent rays with
// a hull of one ray. Each is exact: it passes every box that some ray of
// the hull passes in box_pass, so the lists the walk builds, and every
// result, stay those of the flat walk; only the slab tests it runs fall.
// Incoherent rays also take a two-level cull (group_pass below): a warp
// tests the union box of each CULL_GROUP consecutive clusters first and
// runs the members' slab tests only where some lane enters it, exact by
// the same rule.
//
// Bound: the pair tests per ray, about 55 fp32 operations each (see
// traverse_tile.cuh for where their operands come from). Padding rows
// sort last within a cluster and can never hit, so the row loop stops at
// the first one.
#pragma once

namespace cosig {

constexpr float INF = 3.402823466e38f;  // FLT_MAX, the reference's "infinity"
constexpr float EPSILON = 1e-4f;
constexpr float GID_PAD = 16777216.0f;  // 2^24: padding rows / no hit
constexpr float GID_SPH = 16777218.0f;  // 2^24 + 2: tie id of primitive 0
constexpr int PRIM_COLS = 22;  // 3x4 inverse, 3x3 inverse-transpose, material

// Geometry columns (accel/clusters.py).
constexpr int GEOM_COMPS = 36;
constexpr int C_GN = 3, C_NDA = 6, C_VA = 7, C_VB = 13, C_VC = 19;
constexpr int C_N0 = 25, C_N1 = 28, C_N2 = 31, C_MAT = 34, C_GID = 35;

// jnp.minimum / torch.minimum semantics: NaN if either input is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// The same minimum and maximum in one instruction each (PTX min.NaN /
// max.NaN, sm_80 and later). Their NaN is PTX's canonical NaN, not
// 0x7fc00000, so they serve only where a NaN is compared and never stored:
// the slab test.
__device__ __forceinline__ float slab_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float slab_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// jnp.sign: -1, 1, and x itself at +-0 and NaN.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

constexpr int SB_CLUSTERS = 512;      // clusters per superblock (accel/clusters.py CULL_BLOCK)
constexpr int MAX_SUPERBLOCKS = 128;  // sb_aabb_t's width

// Superblocks a walk over n clusters tests: none up to one superblock
// (kernel_core.py:542, n_blocks == 1), one per 512 clusters up to
// MAX_SUPERBLOCKS, and none past them, where sb_aabb_t holds no box for
// the rest: such a scene takes the flat walk, which is exact (the JAX
// build drops the superblocks past 128, clusters.py:207-222).
__host__ __device__ inline int superblocks(int n_clusters) {
  const int n_sb = (n_clusters + SB_CLUSTERS - 1) / SB_CLUSTERS;
  return n_sb > 1 && n_sb <= MAX_SUPERBLOCKS ? n_sb : 0;
}

// Whether a walk over n_clusters clusters may launch with these superblock
// boxes: a walk that tests superblocks needs their boxes.
inline bool superblocks_ok(int n_clusters, const float* sb_aabb) {
  return superblocks(n_clusters) == 0 || sb_aabb != nullptr;
}

struct Geometry {
  const float* __restrict__ geom;   // [C, K, GEOM_COMPS]
  const float* __restrict__ aabb;   // [8, c_pad]: min xyz, max xyz, pad
  const float* __restrict__ sb_aabb;  // [8, MAX_SUPERBLOCKS]: superblock unions
  const float* __restrict__ prims;  // [>= n_sph + n_box, PRIM_COLS], spheres first
  int n_clusters, k, c_pad, n_sph, n_box;
};

__device__ __forceinline__ Geometry make_geometry(const float* geom, const float* aabb,
                                                  const float* sb_aabb, int n_clusters, int k,
                                                  int c_pad, const float* prims, int n_sph,
                                                  int n_box) {
  Geometry g;
  g.geom = geom;
  g.aabb = aabb;
  g.sb_aabb = sb_aabb;
  g.prims = prims;
  g.n_clusters = n_clusters;
  g.k = k;
  g.c_pad = c_pad;
  g.n_sph = n_sph;
  g.n_box = n_box;
  return g;
}

struct Hit {
  bool hit;
  float t, nx, ny, nz, mat;
};

// A ray with its reciprocal direction and moment w = o x d.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float idx, idy, idz, wx, wy, wz;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                                        float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.idx = 1.0f / dx;
  r.idy = 1.0f / dy;
  r.idz = 1.0f / dz;
  // Canonical component order (intersect.moller_trumbore).
  r.wx = oy * dz - oz * dy;
  r.wy = oz * dx - ox * dz;
  r.wz = ox * dy - oy * dx;
  return r;
}

// A cluster box: min xyz, max xyz.
struct Box {
  float b0, b1, b2, b3, b4, b5;
};

// Box c from aabb [8, c_pad] through the read-only cache.
__device__ __forceinline__ Box box_ldg(const Geometry& g, int c) {
  Box b;
  b.b0 = __ldg(g.aabb + 0 * g.c_pad + c);
  b.b1 = __ldg(g.aabb + 1 * g.c_pad + c);
  b.b2 = __ldg(g.aabb + 2 * g.c_pad + c);
  b.b3 = __ldg(g.aabb + 3 * g.c_pad + c);
  b.b4 = __ldg(g.aabb + 4 * g.c_pad + c);
  b.b5 = __ldg(g.aabb + 5 * g.c_pad + c);
  return b;
}

// Superblock s's union box from sb_aabb [8, MAX_SUPERBLOCKS].
__device__ __forceinline__ Box sb_box_ldg(const Geometry& g, int s) {
  Box b;
  b.b0 = __ldg(g.sb_aabb + 0 * MAX_SUPERBLOCKS + s);
  b.b1 = __ldg(g.sb_aabb + 1 * MAX_SUPERBLOCKS + s);
  b.b2 = __ldg(g.sb_aabb + 2 * MAX_SUPERBLOCKS + s);
  b.b3 = __ldg(g.sb_aabb + 3 * MAX_SUPERBLOCKS + s);
  b.b4 = __ldg(g.sb_aabb + 4 * MAX_SUPERBLOCKS + s);
  b.b5 = __ldg(g.sb_aabb + 5 * MAX_SUPERBLOCKS + s);
  return b;
}

// Slab test of the ray against a cluster box (kernel_core.py:430-449):
// false only when the ray cannot enter the box. tn is the entry distance,
// for the shadow rays' clip.
__device__ __forceinline__ bool box_pass(const Box& b, const Ray& r, float& tn) {
  const float t0x = (b.b0 - r.ox) * r.idx;
  const float t1x = (b.b3 - r.ox) * r.idx;
  const float t0y = (b.b1 - r.oy) * r.idy;
  const float t1y = (b.b4 - r.oy) * r.idy;
  const float t0z = (b.b2 - r.oz) * r.idz;
  const float t1z = (b.b5 - r.oz) * r.idz;
  tn = slab_max(slab_max(slab_min(t0x, t1x), slab_min(t0y, t1y)), slab_min(t0z, t1z));
  const float tf =
      slab_min(slab_min(slab_max(t0x, t1x), slab_max(t0y, t1y)), slab_max(t0z, t1z));
  return !(tn > tf) && !(tf < 0.0f);
}

// The axes on which a ray's slab test of a box inside a union box may turn
// NaN while the union's does not: bits 0-2 an infinite 1/d on x, y, z (its
// slab is 0 * inf = NaN on a face at the origin, which the union may hold
// strictly inside), bit 3 a NaN or infinite direction component. 0 for
// almost every ray; group_pass reads it.
__device__ __forceinline__ unsigned odd_axes(const Ray& r) {
  unsigned b = (isinf(r.idx) ? 1u : 0u) | (isinf(r.idy) ? 2u : 0u) | (isinf(r.idz) ? 4u : 0u);
  if (!isfinite(r.dx) || !isfinite(r.dy) || !isfinite(r.dz)) b |= 8u;
  return b;
}

// The group test of the two-level cull (traverse_tile.cuh): the slab test of
// the union box u of consecutive cluster boxes (NaN-propagating minima and
// maxima of theirs), false only when the ray passes box_pass on none of them
// (with `clip`, the any hit's tn <= max_t on none). Per axis, with 1/d
// finite, fl(fl(b - o) * (1/d)) is monotone in b, so a member's slab
// interval lies inside the union's, its tn is no smaller and its tf no
// larger; a NaN in a member's slab from a NaN or infinite bound or origin
// puts one in the union's slab on that axis, which passes. What is left,
// as in frustum_pass: an axis of `odd` with an infinite 1/d and the origin
// within the union's range there (a member's face may lie at the origin),
// and a NaN or infinite direction, pass. About 28 operations.
__device__ __forceinline__ bool group_pass(const Box& u, const Ray& r, unsigned odd, bool clip,
                                           float max_t) {
  float tn;
  bool pass = box_pass(u, r, tn);
  if (clip) pass = pass && !(tn > max_t);
  if (odd == 0u) return pass;
  return pass || (odd & 8u) != 0u ||
         ((odd & 1u) && !(r.ox > u.b3) && !(r.ox < u.b0)) ||
         ((odd & 2u) && !(r.oy > u.b4) && !(r.oy < u.b1)) ||
         ((odd & 4u) && !(r.oz > u.b5) && !(r.oz < u.b2));
}

// The hull of a packet's rays (kernel_core.py:455-474): per axis the
// origin interval, the direction interval and 1/d over it (rlo = 1/dhi,
// rhi = 1/dlo, IEEE divisions), whether some ray's 1/d is infinite (zinf)
// and whether some ray's d is NaN or infinite (wild); and the largest
// max_t (+inf for a closest hit). The plain version is
// cosig_tpu_torch/ops/kernel_core.py packet_hulls.
struct Hull {
  float olo[3], ohi[3], dlo[3], dhi[3], rlo[3], rhi[3];
  float mt;
  bool zinf[3], wild[3];
};

// One ray as a hull: the superblock cull's per-ray test.
__device__ __forceinline__ Hull ray_hull(const Ray& r, float max_t) {
  Hull h;
  const float o[3] = {r.ox, r.oy, r.oz}, d[3] = {r.dx, r.dy, r.dz};
  const float id[3] = {r.idx, r.idy, r.idz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    h.olo[a] = h.ohi[a] = o[a];
    h.dlo[a] = h.dhi[a] = d[a];
    h.rlo[a] = h.rhi[a] = id[a];
    h.zinf[a] = isinf(id[a]);
    h.wild[a] = !isfinite(d[a]);
  }
  h.mt = max_t;
  return h;
}

// The bounding-frustum test (kernel_core.py:476-517) of a hull against a
// box, operation for operation as cosig_tpu_torch/ops/kernel_core.py
// frustum_flags: false only when no ray of the hull can pass box_pass (and
// the any hit's tn <= max_t) on the box. Per axis, float rounding is
// monotone, so each ray's fl(fl(b - o) * fl(1/d)) lies between the hull's
// corner products, and an axis whose direction interval holds zero is
// unconstrained. Three rules keep it a superset where a ray's slab turns
// NaN, which box_pass lets through: an axis with a NaN or infinite
// direction (wild), a NaN box bound or origin (s_lo or s_hi NaN), or an
// infinite 1/d (zinf) with the origin interval meeting the box's range on
// that axis (0 * inf on a face at a ray's origin) passes the box; and the
// test takes box_pass's form from -inf / +inf (the TPU version starts at 0
// and FLT_MAX, which drops a ray whose slabs are all +inf). NaN passes.
// About 70 operations.
__device__ __forceinline__ bool frustum_pass(const Hull& h, const Box& b) {
  const float bmin[3] = {b.b0, b.b1, b.b2}, bmax[3] = {b.b3, b.b4, b.b5};
  float entry = 0.0f, exit = 0.0f;
  bool over = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s_lo = bmin[a] - h.ohi[a];
    const float s_hi = bmax[a] - h.olo[a];
    const float p1 = s_lo * h.rlo[a];
    const float p2 = s_lo * h.rhi[a];
    const float p3 = s_hi * h.rlo[a];
    const float p4 = s_hi * h.rhi[a];
    float t_lo = slab_min(slab_min(p1, p2), slab_min(p3, p4));
    float t_hi = slab_max(slab_max(p1, p2), slab_max(p3, p4));
    if (!(h.dlo[a] > 0.0f || h.dhi[a] < 0.0f)) {  // the interval holds zero (or NaN)
      t_lo = -INFINITY;
      t_hi = INFINITY;
    }
    entry = a == 0 ? t_lo : slab_max(entry, t_lo);
    exit = a == 0 ? t_hi : slab_min(exit, t_hi);
    over = over || h.wild[a] || s_lo != s_lo || s_hi != s_hi ||
           (h.zinf[a] && !(h.olo[a] > bmax[a]) && !(h.ohi[a] < bmin[a]));
  }
  return over || (!(entry > exit) && !(exit < 0.0f) && !(entry > h.mt));
}

// One ray's superblock test, the per-ray form of frustum_pass. Not
// inlined: it runs once per superblock and walk.
static __device__ __noinline__ bool ray_enters(Ray r, float max_t, Box b) {
  return frustum_pass(ray_hull(r, max_t), b);
}

// The 22 constants of one geometry row that the pair test reads: the
// plane normal and n.A, then the three edge volumes' d and w coefficients.
struct PairRow {
  float gnx, gny, gnz, nda;
  float va[6], vb[6], vc[6];
};

// Plücker / edge-volume pair test of the ray against one geometry row
// (kernel_core.py:818-842) -> validity, with t, vb, vc and 1/s for the
// winner's barycentrics.
__device__ __forceinline__ bool pair_test(const PairRow& q, const Ray& r, float& t,
                                          float& vb, float& vc, float& inv_s) {
  const float va = r.dx * q.va[0] + r.dy * q.va[1] + r.dz * q.va[2] + r.wx * q.va[3] +
                   r.wy * q.va[4] + r.wz * q.va[5];
  vb = r.dx * q.vb[0] + r.dy * q.vb[1] + r.dz * q.vb[2] + r.wx * q.vb[3] + r.wy * q.vb[4] +
       r.wz * q.vb[5];
  vc = r.dx * q.vc[0] + r.dy * q.vc[1] + r.dz * q.vc[2] + r.wx * q.vc[3] + r.wy * q.vc[4] +
       r.wz * q.vc[5];
  const float s = r.dx * q.gnx + r.dy * q.gny + r.dz * q.gnz;
  const float ndo = r.ox * q.gnx + r.oy * q.gny + r.oz * q.gnz;
  inv_s = 1.0f / s;
  t = (q.nda - ndo) * inv_s;
  return (fabsf(s) >= EPSILON) && (va * s >= 0.0f) && (vb * s >= 0.0f) &&
         (vc * s >= 0.0f) && (t > EPSILON);
}

// The distance pruning of the compacted closest hit (traverse_tile.cuh
// closest_pairs): whether a ray whose key is at t_key may skip a piece of
// rows of a cluster whose box b it enters at tn (box_pass), n1 the largest
// |n|_1 = |gx| + |gy| + |gz| of the piece's rows (the unnormalised plane
// normal n = (B - A) x (C - A) of accel/clusters.py). It skips them only
// where no pair of them can reach a key at or below t_key, a gid tie
// included: where every valid pair has t > t_key. The argument, with u =
// 2^-24 and the slab test, the pair test and the key all in float32:
//  * the box is the rows' vertex box grown by pad >= 1e-4 on every side
//    (clusters.py), so where the ray's line crosses a triangle exactly, at
//    t*, it entered the box at least pad / max|d_a| >= pad (|d| = 1) before:
//    exact tn <= t* - pad;
//  * box_pass's tn = fl(fl(b - o) * fl(1/d)) on the entering axis, within
//    3u |tn| of the exact entry (max and min are exact);
//  * pair_test's t = fl(fl(nda - fl(n.o)) * fl(1/fl(n.d))) (three-term
//    sums, nda = fl(n.A) stored) is within about 3u |n|_1 (|o|_inf +
//    |A|_inf + t |d|_inf) / |s| + 3u t of the crossing of the ray and the
//    triangle's plane; the pair test is valid only for |s| >= EPSILON, A lies
//    in the box (|A|_inf <= rb, the box's largest |bound|) and t <= t_key
//    for a pair that would beat the key, so that is at most
//    3u n1 (|o|_inf + rb + t_key) / EPSILON + 3u t_key;
//  * so a valid pair whose crossing lies in its triangle has t > tn - pad +
//    those errors, and t > t_key wherever tn > t_key + margin, with margin
//    = (|o|_inf + rb + t_key) n1 PRUNE_GRAZE + t_key PRUNE_REL: PRUNE_GRAZE
//    is 2.8x the rounding term's 3u / EPSILON, PRUNE_REL 5x the 3u |tn| and
//    3u t terms, and the pad is left as slack. No tighter bound holds for
//    grazing pairs (small |s|, where t moves by |n| / |s| times its
//    rounding), so the margin takes the worst |s| the pair test lets pass
//    and the piece's largest normal: large for large triangles (a ground
//    quad's pieces are never pruned), small for a mesh's. Not covered by
//    the bound: a grazing pair whose float edge tests pass where the exact
//    ones fail, crossing its plane outside the triangle by more than the
//    pad (the unpruned walk's own hit is then a rounding artefact).
// A ray with no key (t_key = INF), a NaN tn or margin, and an origin
// inside the box (tn <= 0 < t_key) never prune. About 20 operations; the
// plain version is cosig_tpu_torch/ops/kernel_core.py prune_flags.
constexpr float PRUNE_GRAZE = 5e-3f;               // 8.4u / EPSILON
constexpr float PRUNE_REL = 9.5367431640625e-07f;  // 2^-20 = 16u

__device__ __forceinline__ bool prunes(float tn, float t_key, const Ray& r, const Box& b,
                                       float n1) {
  if (!(t_key < INF)) return false;
  const float o = fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz));
  const float rb = fmaxf(fmaxf(fmaxf(fabsf(b.b0), fabsf(b.b1)), fmaxf(fabsf(b.b2), fabsf(b.b3))),
                         fmaxf(fabsf(b.b4), fabsf(b.b5)));
  const float margin = ((o + rb) + t_key) * n1 * PRUNE_GRAZE + t_key * PRUNE_REL;
  return tn > t_key + margin;
}

// A geometry row's |n|_1 (columns 3-5), the piece maximum prunes() takes.
__device__ __forceinline__ float normal_l1(float gx, float gy, float gz) {
  return (fabsf(gx) + fabsf(gy)) + fabsf(gz);
}

// The closest-hit fold's running winner: lexicographic (t, gid) minimum,
// the winning row (c * K + k) and its barycentrics.
struct Best {
  float t, gid, u, v;
  int row;
};

__device__ __forceinline__ Best no_hit() {
  Best b;
  b.t = INF;
  b.gid = GID_PAD;
  b.u = 0.0f;
  b.v = 0.0f;
  b.row = -1;
  return b;
}

// One pair test folded into the winner.
__device__ __forceinline__ void fold_pair(Best& b, const PairRow& q, float gid, const Ray& r,
                                          int row) {
  float t, vb, vc, inv_s;
  if (pair_test(q, r, t, vb, vc, inv_s) && (t < b.t || (t == b.t && gid < b.gid))) {
    b.t = t;
    b.gid = gid;
    b.row = row;
    b.u = vb * inv_s;
    b.v = vc * inv_s;
  }
}

// Analytic primitive p against the ray (kernel_core.py:955-1018) ->
// validity, t (world parameterization) and the object-space normal.
__device__ __forceinline__ bool prim_test(const Geometry& g, int p, const Ray& r, float& tp,
                                          float& nxo, float& nyo, float& nzo) {
  const float* __restrict__ m = g.prims + p * PRIM_COLS;
  const float m0 = __ldg(m + 0), m1 = __ldg(m + 1), m2 = __ldg(m + 2), m3 = __ldg(m + 3);
  const float m4 = __ldg(m + 4), m5 = __ldg(m + 5), m6 = __ldg(m + 6), m7 = __ldg(m + 7);
  const float m8 = __ldg(m + 8), m9 = __ldg(m + 9), m10 = __ldg(m + 10), m11 = __ldg(m + 11);
  const float oxo = m0 * r.ox + m1 * r.oy + m2 * r.oz + m3;
  const float oyo = m4 * r.ox + m5 * r.oy + m6 * r.oz + m7;
  const float ozo = m8 * r.ox + m9 * r.oy + m10 * r.oz + m11;
  const float dxo = m0 * r.dx + m1 * r.dy + m2 * r.dz;
  const float dyo = m4 * r.dx + m5 * r.dy + m6 * r.dz;
  const float dzo = m8 * r.dx + m9 * r.dy + m10 * r.dz;
  if (p < g.n_sph) {
    // Unit sphere (HittableObjects.cs:83-108).
    const float a = dxo * dxo + dyo * dyo + dzo * dzo;
    const float b = 2.0f * (oxo * dxo + oyo * dyo + ozo * dzo);
    const float c = oxo * oxo + oyo * oyo + ozo * ozo - 1.0f;
    const float disc = b * b - 4.0f * a * c;
    const float sq = sqrtf(nan_max(disc, 0.0f));
    const float t0 = (-b - sq) / (2.0f * a);
    const float t1 = (-b + sq) / (2.0f * a);
    tp = t0 > EPSILON ? t0 : t1;
    nxo = oxo + tp * dxo;  // the hit point on the unit sphere
    nyo = oyo + tp * dyo;
    nzo = ozo + tp * dzo;
    return (disc >= 0.0f) && (tp > EPSILON);
  }
  // Unit cube [-0.5, 0.5]^3 (HittableObjects.cs:182-224), first-of-equals
  // face pick.
  const float ix = 1.0f / dxo, iy = 1.0f / dyo, iz = 1.0f / dzo;
  const float t0x = (-0.5f - oxo) * ix;
  const float t1x = (0.5f - oxo) * ix;
  const float t0y = (-0.5f - oyo) * iy;
  const float t1y = (0.5f - oyo) * iy;
  const float t0z = (-0.5f - ozo) * iz;
  const float t1z = (0.5f - ozo) * iz;
  const float t_en =
      nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)), nan_min(t0z, t1z));
  const float t_ex =
      nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)), nan_max(t0z, t1z));
  tp = t_en > EPSILON ? t_en : t_ex;
  const float pxo = oxo + tp * dxo, pyo = oyo + tp * dyo, pzo = ozo + tp * dzo;
  const float ax = fabsf(pxo), ay = fabsf(pyo), az = fabsf(pzo);
  const bool is_x = (ax >= ay) && (ax >= az);
  const bool is_y = !is_x && (ay >= az);
  nxo = is_x ? sign_of(pxo) : 0.0f;
  nyo = is_y ? sign_of(pyo) : 0.0f;
  nzo = (is_x || is_y) ? 0.0f : sign_of(pzo);
  return (t_en <= t_ex) && (t_ex > EPSILON) && (tp > EPSILON);
}

// After the cluster walk: the triangle winner's normal and material, the
// analytic fold, then the shared epilogue. t = INF, normal (0, 1, 0) and
// material -1 on a miss.
__device__ __forceinline__ Hit finish_closest(const Geometry& g, const Ray& r, const Best& b) {
  float bt = b.t, bgid = b.gid;
  // The triangle winner's interpolated normal, unnormalized.
  float nx = 0.0f, ny = 1.0f, nz = 0.0f, mat = -1.0f;
  if (b.row >= 0) {
    const float* __restrict__ p = g.geom + (size_t)b.row * GEOM_COMPS;
    const float w = 1.0f - b.u - b.v;
    nx = w * __ldg(p + C_N0) + b.u * __ldg(p + C_N1) + b.v * __ldg(p + C_N2);
    ny = w * __ldg(p + C_N0 + 1) + b.u * __ldg(p + C_N1 + 1) + b.v * __ldg(p + C_N2 + 1);
    nz = w * __ldg(p + C_N0 + 2) + b.u * __ldg(p + C_N1 + 2) + b.v * __ldg(p + C_N2 + 2);
    mat = __ldg(p + C_MAT);
  }
  // Analytic fold: lexicographic (t, gid), the world normal the
  // inverse-transpose times the object normal.
  for (int q = 0; q < g.n_sph + g.n_box; ++q) {
    float tp, nxo, nyo, nzo;
    const bool valid = prim_test(g, q, r, tp, nxo, nyo, nzo);
    const float tm = valid ? tp : INF;
    const float gid = GID_SPH + 2.0f * (float)q;
    if (tm < bt || (tm == bt && gid < bgid)) {
      const float* __restrict__ w = g.prims + q * PRIM_COLS + 12;
      nx = __ldg(w + 0) * nxo + __ldg(w + 1) * nyo + __ldg(w + 2) * nzo;
      ny = __ldg(w + 3) * nxo + __ldg(w + 4) * nyo + __ldg(w + 5) * nzo;
      nz = __ldg(w + 6) * nxo + __ldg(w + 7) * nyo + __ldg(w + 8) * nzo;
      mat = __ldg(w + 9);
      bt = tm;
      bgid = gid;
    }
  }
  Hit h;
  h.t = bt;
  h.hit = bt < INF;
  if (h.hit) {
    const float inv = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz);
    h.nx = nx * inv;
    h.ny = ny * inv;
    h.nz = nz * inv;
    h.mat = mat;
  } else {
    h.nx = 0.0f;
    h.ny = 1.0f;
    h.nz = 0.0f;
    h.mat = -1.0f;
  }
  return h;
}

// Any hit among the analytic primitives at t <= max_t, after a cluster
// walk that found no occluder.
__device__ __forceinline__ bool prims_occlude(const Geometry& g, const Ray& r, float max_t) {
  for (int q = 0; q < g.n_sph + g.n_box; ++q) {
    float tp, nxo, nyo, nzo;
    if (prim_test(g, q, r, tp, nxo, nyo, nzo) && tp <= max_t) return true;
  }
  return false;
}

}  // namespace cosig
