// The tensor-core form of the pair test: the five planes of a cluster's
// rows against the block's 128 rays as bf16 wgmma products of exact limbs,
// then the exact test's selection on them.
//
// Replaces the TPU kernel's MXU form, cosig_tpu/ops/kernel_core.py mt_mxu
// (:776-803) and mxu_sel (:633-722), with the operands of
// cosig_tpu/accel/clusters.py _limbs / _pack_mx (:105-150) and the ray
// staging of stage_rays (:335-392). Every f32 value a splits into three
// bf16 limbs, a == l0 + l1 + l2 exactly (limbs3); a plane is the sum over
// the ray inputs i of the limb products limb_j(coef_i) * limb_k(x_i) for
// the six pairs (j, k) with j + k <= 2 (MX_COMBOS). A bf16 x bf16 product
// is exact in f32 and the tensor core accumulates in f32, so each plane is
// within a few f32 roundings of the exact sum of those products, in an
// order the hardware picks. The plain version
// (cosig_tpu_torch/ops/kernel_core.py mx_planes) sums the same products in
// float64 (one matrix product) and rounds once; the two are held to
// 1e-6 x sum |coef * input| (chip_smoke.py phase 11), and the frames to
// the slice tolerances, since a plane an ulp away can flip a grazing pair.
//
// Design, per block (wgmma.mma_async m64nNk16 bf16 in, f32 accumulate; the
// block's 128 threads are one warpgroup):
//  * M: two m-tiles of 64 rays; row 16 w + r of m-tile i is ray 32 w +
//    16 i + r, so warp w's accumulator rows are its own 32 rays, and each
//    8 columns of an accumulator have mma.sync's m16n8 layout: lane (g, t)
//    holds rays g and g + 8 (of the warp's 16 i ..), columns 2t, 2t + 1.
//  * N: an n-tile of 8 cluster rows, its columns plane-major: va, vb, vc
//    and s are 32 columns against operand X (m64n32k16), num 8 columns
//    against operand Z (m64n8k16). The any hit stops a ray after the
//    n-tile of its first occluder (kernel_core.traverse counts its pair
//    tests so, MX_ROWS).
//  * K: 3 k-steps of 16 columns; column 8h + 2t + e of k-step s is limb
//    pair MX_COMBOS[2s + h] of input slot 2t + e: slots 0-5 are d and w
//    (operand X; the s plane's coefficients for w are 0), or o and the
//    constant 1 (operand Z: num). 48 columns, tighter than the TPU's 64;
//    the sum is over the same exact products.
//  * The ray operand (A) is wgmma's register operand, which takes
//    mma.sync's A fragment: each lane splits its four fragment rays into
//    limbs once per walk (mx_stage, 24 registers), and no shared memory
//    holds it.
//  * The geometry operand (B) is split once per block: when a cluster's f32
//    rows have landed in the walk's ring (traverse_tile.cuh), 40 threads
//    split an n-tile's rows with limbs3 (the same deterministic split as
//    pack_mx, so its limbs are pack_mx's bits; phase 11 checks them
//    through mx_probe_kernel) into a shared-memory tile in wgmma's
//    canonical K-major layout (mx_layout.h), then a proxy fence and a block
//    barrier, since wgmma reads shared memory through the async proxy. Two
//    tiles: the next n-tile is split while the tensor cores multiply this
//    one, so shared memory does not grow with k. The ring stays f32, 144
//    B a row, for the exact any hit of closest-only mode, the shadow-set
//    walk and finish_closest.
//  * Each lane keeps a running (t, gid) winner for its four rays (two per
//    m-tile) over the whole walk; at its end the four lanes of a row group
//    reduce them and the ray's own lane takes its winner (mx_finish). The
//    fold is order-free (gids are unique), so the winner is the one the
//    plain version picks from the same planes.
//  * wgmma is warpgroup-collective: every thread of the block issues it
//    for every listed cluster (some lane entered it, so the decision is
//    block-uniform); a warp with no ray in an m-tile skips only that
//    m-tile's selection, and the any hit stops a cluster when no ray of
//    the block walks (__syncthreads_or), never per warp.
//
// Bound: the limb products a pair needs (kernel_core.MX_PRODUCTS, 147 of
// the 5 planes x 48 columns the tiles issue; the rest are zero by
// construction) over the dense bf16 rate, and the selection's f32
// operations (about 15 a pair) over the fp32 rate; chip_smoke.py phase 11
// prints both.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mx_layout.h"
#include "traverse.cuh"

namespace cosig {

constexpr int MX_REGS = 6;  // packed ray registers per (m-tile, operand) and lane
// Blocks a multiprocessor holds of a wavefront tensor-core build: its
// kernels' __launch_bounds__ minimum, which holds them to 128 registers
// (they spill 0-452 B; at 3 blocks and 168 registers the large_mesh
// bounces ran 11-19 % slower, PERF.md).
constexpr int MX_MIN_BLOCKS = 4;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// a rounded to bf16 (to nearest even), as a float.
__device__ __forceinline__ float bf16r(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// The three limbs of a: a == l0 + l1 + l2 exactly (each residual is an
// exact f32 subtraction; the build has --fmad=false).
__device__ __forceinline__ void limbs3(float a, float& l0, float& l1, float& l2) {
  l0 = bf16r(a);
  const float r = a - l0;
  l1 = bf16r(r);
  l2 = bf16r(r - l1);
}

// Two bf16 values (floats that are bf16 exactly) in one register, lo in
// the low half: the element order of a fragment register and of shared
// memory.
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// The limbs of two values as three packed registers: limb j of (a, b).
__device__ __forceinline__ void limb_pairs(float a, float b, unsigned (&p)[3]) {
  float a0, a1, a2, b0, b1, b2;
  limbs3(a, a0, a1, a2);
  limbs3(b, b0, b1, b2);
  p[0] = pack2(a0, b0);
  p[1] = pack2(a1, b1);
  p[2] = pack2(a2, b2);
}

// The block's ray operand in registers: lane (g, t) holds, for m-tile i,
// x[i][j] = limb j of slots 2t, 2t + 1 of operand X of the warp's ray
// 16 i + g, x[i][3 + j] the same of ray 16 i + g + 8; z likewise for Z.
struct MxRays {
  unsigned x[2][MX_REGS], z[2][MX_REGS];
};

// Every lane of the warp, with its own ray: its fragment rows' limbs into
// `a` and in mt the max_t of those four rays (ray 16 i + 8 h + g at [i][h]).
__device__ __forceinline__ void mx_stage(const Ray& r, float max_t, MxRays& a,
                                         float (&mt)[2][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float x[6] = {r.dx, r.dy, r.dz, r.wx, r.wy, r.wz};
  const float z[3] = {r.ox, r.oy, r.oz};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int src = 16 * i + 8 * h + g;
      float v[6], o[3];
#pragma unroll
      for (int q = 0; q < 6; ++q) v[q] = __shfl_sync(0xffffffffu, x[q], src);
#pragma unroll
      for (int q = 0; q < 3; ++q) o[q] = __shfl_sync(0xffffffffu, z[q], src);
      mt[i][h] = __shfl_sync(0xffffffffu, max_t, src);
      const float xa = t == 0 ? v[0] : t == 1 ? v[2] : t == 2 ? v[4] : 0.0f;
      const float xb = t == 0 ? v[1] : t == 1 ? v[3] : t == 2 ? v[5] : 0.0f;
      const float za = t == 0 ? o[0] : t == 1 ? o[2] : 0.0f;
      const float zb = t == 0 ? o[1] : t == 1 ? 1.0f : 0.0f;
      unsigned px[3], pz[3];
      limb_pairs(xa, xb, px);
      limb_pairs(za, zb, pz);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        a.x[i][3 * h + j] = px[j];
        a.z[i][3 * h + j] = pz[j];
      }
    }
  }
}

// The n-tiles of a staged cluster (`rows`: k rows of GEOM_COMPS floats)
// before its first padding row (padding rows sort last); the same in
// every thread.
__device__ __forceinline__ int mx_ntiles(const float* rows, int k) {
  int n = 0;
  while (MX_TILE_ROWS * n < k && rows[MX_TILE_ROWS * n * GEOM_COMPS + C_GID] < GID_PAD) ++n;
  return n;
}

// Every thread of the block: n-tile nt of a staged cluster into `tile`
// (MX_B_BYTES of shared memory, mx_layout.h). Thread 8 p + r < 40 splits
// the coefficients of plane p of row 8 nt + r (zeros past row k) by input
// slot, va, vb, vc: d, w; s: d; num: o, 1 (as -gn, nda), and writes its
// four cores.
__device__ __forceinline__ void mx_split(const float* rows, int k, int nt, unsigned char* tile) {
  const int i = threadIdx.x;
  if (i >= MX_PLANES * MX_TILE_ROWS) return;
  const int p = i >> 3, r = i & 7, row = MX_TILE_ROWS * nt + r;
  float c[MX_SLOTS];
#pragma unroll
  for (int q = 0; q < MX_SLOTS; ++q) c[q] = 0.0f;
  if (row < k) {
    const float* g = rows + row * GEOM_COMPS;
    if (p < 3) {
#pragma unroll
      for (int q = 0; q < 6; ++q) c[q] = g[C_VA + 6 * p + q];
    } else if (p == 3) {
#pragma unroll
      for (int q = 0; q < 3; ++q) c[q] = g[C_GN + q];
    } else {
#pragma unroll
      for (int q = 0; q < 3; ++q) c[q] = -g[C_GN + q];
      c[3] = g[C_NDA];
    }
  }
  unsigned l[3][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    unsigned pr[3];
    limb_pairs(c[2 * e], c[2 * e + 1], pr);
#pragma unroll
    for (int j = 0; j < 3; ++j) l[j][e] = pr[j];
  }
#pragma unroll
  for (int cc = 0; cc < MX_CORES; ++cc) {
    const int j = mx_core_limb(cc);
    *reinterpret_cast<uint4*>(tile + mx_b_offset(p, cc, r, 0)) =
        make_uint4(l[j][0], l[j][1], l[j][2], l[j][3]);
  }
}

// Every thread: make the block's generic writes of a tile visible to the
// async proxy (wgmma's shared-memory reads), then a block barrier.
__device__ __forceinline__ void mx_publish() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d = a * B (SCALE_D 0) or d += a * B (1), m64n32k16, a in registers, B
// by its descriptor.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], unsigned a0, unsigned a1, unsigned a2,
                                          unsigned a3, uint64_t desc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %21, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(SCALE_D));
}

// The same at m64n8k16.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, uint64_t desc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %9, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(SCALE_D));
}

// The planes of one m-tile (wgmma accumulators): x[4 p + e] holds plane p
// (va, vb, vc, s) of the lane's element e (ray g + 8 (e >> 1) of the
// m-tile's rows of this warp, column 2t + (e & 1) of the n-tile), z[e] its
// num.
struct MxPlanes {
  float x[16], z[4];
};

// The three k-steps of one operand, a[0..2] the ray limbs of fragment row
// g, a[3..5] of row g + 8; step s pairs them with the tile's cores as
// MX_COMBOS does: (0,0),(0,1) | (1,0),(0,2) | (1,1),(2,0) as (geometry
// limb, ray limb).
template <int N>
__device__ __forceinline__ void mx_steps(float (&d)[N], const unsigned (&a)[MX_REGS],
                                         uint32_t tile, int p0) {
  if constexpr (N == 16) {
    wgmma_n32<0>(d, a[0], a[3], a[1], a[4], mx_desc(tile, p0, 0));
    wgmma_n32<1>(d, a[0], a[3], a[2], a[5], mx_desc(tile, p0, 1));
    wgmma_n32<1>(d, a[1], a[4], a[0], a[3], mx_desc(tile, p0, 2));
  } else {
    wgmma_n8<0>(d, a[0], a[3], a[1], a[4], mx_desc(tile, p0, 0));
    wgmma_n8<1>(d, a[0], a[3], a[2], a[5], mx_desc(tile, p0, 1));
    wgmma_n8<1>(d, a[1], a[4], a[0], a[3], mx_desc(tile, p0, 2));
  }
}

// Every thread of the block: issue m-tile i's products of the tile at
// shared address `tile` as one commit group.
__device__ __forceinline__ void mx_issue(const MxRays& a, uint32_t tile, int i, MxPlanes& d) {
  wg_fence();
  mx_steps(d.x, a.x[i], tile, 0);
  mx_steps(d.z, a.z[i], tile, 4);
  wg_commit();
}

// After the wait for m-tile products d: their registers are read only from
// here on.
__device__ __forceinline__ void mx_hold(MxPlanes& d) {
#pragma unroll
  for (int j = 0; j < 16; ++j) asm volatile("" : "+f"(d.x[j])::"memory");
#pragma unroll
  for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d.z[j])::"memory");
}

// The exact test's selection on one element's planes (mxu_sel,
// kernel_core.py:640-649; pair_test's operations from its planes on).
__device__ __forceinline__ bool mx_valid(const MxPlanes& d, int e, float& t, float& inv_s) {
  const float va = d.x[e], vb = d.x[4 + e], vc = d.x[8 + e], s = d.x[12 + e];
  inv_s = 1.0f / s;
  t = d.z[e] * inv_s;
  return (fabsf(s) >= EPSILON) && (va * s >= 0.0f) && (vb * s >= 0.0f) && (vc * s >= 0.0f) &&
         (t > EPSILON);
}

// Fold m-tile i's planes d of n-tile nt (row0: the flat index of the
// cluster's first row; gid: the gids of the lane's columns) into the
// lane's running winners b[i][h], for the warp's rays with bits in w.
__device__ __forceinline__ void mx_fold(const MxPlanes& d, int i, int nt, int row0,
                                        const float (&gid)[2], unsigned w, Best (&b)[2][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (((w >> (16 * i)) & 0xffffu) == 0u) return;  // warp-uniform: only the selection is skipped
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int h = e >> 1;
    if (!((w >> (16 * i + 8 * h + g)) & 1u) || gid[e & 1] >= GID_PAD) continue;
    float tt, inv_s;
    Best& bb = b[i][h];
    if (mx_valid(d, e, tt, inv_s) && (tt < bb.t || (tt == bb.t && gid[e & 1] < bb.gid))) {
      bb.t = tt;
      bb.gid = gid[e & 1];
      bb.row = row0 + MX_TILE_ROWS * nt + 2 * t + (e & 1);
      bb.u = d.x[4 + e] * inv_s;
      bb.v = d.x[8 + e] * inv_s;
    }
  }
}

// Closest hit: every thread of the block, on a staged cluster of k rows
// (row0: the index of its first row in the flat geometry), with `tiles`
// the two B tiles (2 x MX_B_BYTES of shared memory): fold every pair whose
// ray's bit is set in `w` (the warp's rays that entered the box) into the
// lane's running winners b[i][h]. The m-tiles run one after the other,
// m-tile 0's product beside the next tile's split: one m-tile's
// accumulators live, not two, so the builds keep to 128 registers
// (MX_MIN_BLOCKS). Both m-tiles are multiplied for every n-tile: a
// product skipped on a block-uniform test made ptxas serialize the wgmma
// (C7518) and ran slower.
__device__ __forceinline__ void mx_closest_cluster(const float* rows, int k, int row0,
                                                   unsigned w, const MxRays& a,
                                                   unsigned char* tiles, Best (&b)[2][2]) {
  const int t = threadIdx.x & 3;
  const int n = mx_ntiles(rows, k);
  if (n == 0) return;
  mx_split(rows, k, 0, tiles);
  mx_publish();
  MxPlanes d;
  for (int nt = 0; nt < n; ++nt) {
    const uint32_t tile = smem_u32(tiles + (nt & 1) * MX_B_BYTES);
    mx_issue(a, tile, 0, d);
    if (nt + 1 < n) mx_split(rows, k, nt + 1, tiles + ((nt + 1) & 1) * MX_B_BYTES);
    float gid[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = MX_TILE_ROWS * nt + 2 * t + c;
      gid[c] = row < k ? rows[row * GEOM_COMPS + C_GID] : GID_PAD;
    }
    wg_wait<0>();
    mx_hold(d);
    mx_fold(d, 0, nt, row0, gid, w, b);
    mx_issue(a, tile, 1, d);
    wg_wait<0>();
    mx_hold(d);
    mx_fold(d, 1, nt, row0, gid, w, b);
    if (nt + 1 < n) mx_publish();  // the next tile is written; every product of this one is done
  }
}

// After the walk: the lane's own ray's winner, from the running winners of
// the four lanes (g, 0..3) that hold its fragment row.
__device__ __forceinline__ Best mx_finish(Best (&b)[2][2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Best& x = b[m][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, x.t, off);
        const float og = __shfl_xor_sync(0xffffffffu, x.gid, off);
        const float ou = __shfl_xor_sync(0xffffffffu, x.u, off);
        const float ov = __shfl_xor_sync(0xffffffffu, x.v, off);
        const int orow = __shfl_xor_sync(0xffffffffu, x.row, off);
        if (ot < x.t || (ot == x.t && og < x.gid)) {
          x.t = ot;
          x.gid = og;
          x.u = ou;
          x.v = ov;
          x.row = orow;
        }
      }
    }
  }
  // Ray `lane` is fragment row g' = lane & 7 of m-tile lane >> 4, half (lane >> 3) & 1.
  const int src = (lane & 7) * 4, mine = lane >> 3;
  Best own = no_hit();
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Best& x = b[m][h];
      const float ot = __shfl_sync(0xffffffffu, x.t, src);
      const float og = __shfl_sync(0xffffffffu, x.gid, src);
      const float ou = __shfl_sync(0xffffffffu, x.u, src);
      const float ov = __shfl_sync(0xffffffffu, x.v, src);
      const int orow = __shfl_sync(0xffffffffu, x.row, src);
      if (mine == 2 * m + h) {
        own.t = ot;
        own.gid = og;
        own.u = ou;
        own.v = ov;
        own.row = orow;
      }
    }
  }
  return own;
}

// Bit 2 i + h: some valid pair of m-tile i's planes d lies at t <= the
// max_t of the lane's fragment ray 16 i + 8 h + g (a bit of w; real: the
// lane's columns are rows of the cluster).
__device__ __forceinline__ unsigned mx_occluded(const MxPlanes& d, int i, const bool (&real)[2],
                                                unsigned w, const float (&mt)[2][2]) {
  const int g = (threadIdx.x & 31) >> 2;
  unsigned occ = 0u;
  if (((w >> (16 * i)) & 0xffffu) == 0u) return occ;  // warp-uniform
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int h = e >> 1;
    if (!((w >> (16 * i + 8 * h + g)) & 1u) || !real[e & 1]) continue;
    float tt, inv_s;
    if (mx_valid(d, e, tt, inv_s) && tt <= mt[i][h]) occ |= 1u << (2 * i + h);
  }
  return occ;
}

// Any hit: every thread of the block, on a staged cluster's rows (tiles as
// in mx_closest_cluster), against the warp's rays with bits in `w`
// (entered the box and still walking), an n-tile at a time; a ray with a
// valid pair at t <= its max_t (mt, mx_stage's) stops walking (`walking`,
// the lane's own ray) after that n-tile. Returns when no ray of the
// block's w walks or the rows end. The m-tiles run as in
// mx_closest_cluster.
__device__ __forceinline__ void mx_any_cluster(const float* rows, int k, unsigned w,
                                               const MxRays& a, const float (&mt)[2][2],
                                               unsigned char* tiles, bool& walking) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int n = mx_ntiles(rows, k);
  if (n == 0) return;
  mx_split(rows, k, 0, tiles);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (!__syncthreads_or(w != 0u)) return;  // no ray of the block to test
  MxPlanes d;
  for (int nt = 0; nt < n; ++nt) {
    const uint32_t tile = smem_u32(tiles + (nt & 1) * MX_B_BYTES);
    mx_issue(a, tile, 0, d);
    if (nt + 1 < n) mx_split(rows, k, nt + 1, tiles + ((nt + 1) & 1) * MX_B_BYTES);
    bool real[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = MX_TILE_ROWS * nt + 2 * t + c;
      real[c] = row < k && rows[row * GEOM_COMPS + C_GID] < GID_PAD;
    }
    wg_wait<0>();
    mx_hold(d);
    unsigned occ = mx_occluded(d, 0, real, w, mt);
    mx_issue(a, tile, 1, d);
    wg_wait<0>();
    mx_hold(d);
    occ |= mx_occluded(d, 1, real, w, mt);
    occ |= __shfl_xor_sync(0xffffffffu, occ, 1);
    occ |= __shfl_xor_sync(0xffffffffu, occ, 2);
    const unsigned own = __shfl_sync(0xffffffffu, occ, (lane & 7) * 4);
    if ((own >> (lane >> 3)) & 1u) walking = false;
    w &= __ballot_sync(0xffffffffu, walking);
    if (nt + 1 == n) break;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (!__syncthreads_or(w != 0u)) break;  // block-uniform stop; the next tile is written
  }
}

}  // namespace cosig
