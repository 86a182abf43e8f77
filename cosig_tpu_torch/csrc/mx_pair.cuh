// The tensor-core form of the pair test: the five planes of a cluster's
// rows against a warp's 32 rays as bf16 mma.sync products of exact limbs,
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
// Design, per warp (mma.sync.aligned.m16n8k16, bf16 in, f32 accumulate):
//  * M = 16 rays (two m-tiles cover the warp's 32 lanes), N = 8 rows of
//    the cluster (an n-tile), K = 3 k-steps of 16 columns. Column
//    8h + 2t + e of k-step s is limb pair MX_COMBOS[2s + h] of input slot
//    2t + e: slots 0-5 are d and w (operand X: va, vb, vc and s, whose
//    coefficients for w are 0), or o and the constant 1 (operand Z: num).
//    The kernel packs these 48 columns tighter than the TPU's 64; the sum
//    is over the same exact products. So lane (g, t) of the accumulator
//    holds every plane of rays g and g + 8 against rows 2t and 2t + 1 of
//    the n-tile, and the validity test, t = num * (1/s) and the (t, gid)
//    fold run in its registers.
//  * The ray operand (A) is staged once per walk into shared memory, six
//    packed registers per (m-tile, operand) and lane (3 KB a warp). The
//    geometry operand (B) is split in registers from the f32 rows the
//    block walk already stages (traverse_tile.cuh's ring), with
//    __float2bfloat16_rn and exact residuals: the same deterministic split
//    as pack_mx, so its limbs are pack_mx's bits (phase 11 checks them
//    through mx_probe_kernel), and the ring stays 144 B a row.
//  * Each lane keeps a running (t, gid) winner for its four rays (two per
//    m-tile) over the whole walk; at its end the four lanes of a row group
//    reduce them and the ray's own lane takes its winner (mx_finish). The
//    fold is order-free (gids are unique), so the winner is the one the
//    plain version picks from the same planes.
//  * The any hit tests an n-tile at a time and stops a ray after the
//    n-tile of its first occluder (kernel_core.traverse counts its pair
//    tests so, MX_ROWS).
//
// Bound: the limb products a pair needs (kernel_core.MX_PRODUCTS, 147 of
// the 5 planes x 48 columns the mma tiles issue; the rest are zero by
// construction) over the dense bf16 rate, and the selection's f32
// operations (about 15 a pair) over the fp32 rate; chip_smoke.py phase 11
// prints both.

#pragma once

#include <cuda_bf16.h>

#include "traverse.cuh"

namespace cosig {

constexpr int MX_TILE_ROWS = 8;  // rows of an n-tile (kernel_core.MX_ROWS)
constexpr int MX_REGS = 6;       // packed ray registers per (m-tile, operand) and lane
// Shared memory of a warp's staged ray operand: [m-tile][operand][reg][lane].
constexpr int MX_WARP_WORDS = 2 * 2 * MX_REGS * 32;
constexpr int MX_WARP_BYTES = MX_WARP_WORDS * 4;

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
// the low half: the element order of an mma fragment register.
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

// d += a * b, one m16n8k16 bf16 product with f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The three k-steps of one plane: a[0..2] the ray limbs of row g, a[3..5]
// of row g + 8 (operand registers), b[0..2] the coefficient limbs. Step s
// holds pairs 2s and 2s + 1 of MX_COMBOS ((0,0),(0,1),(1,0),(0,2),(1,1),
// (2,0)) as (geometry limb, ray limb).
__device__ __forceinline__ void mma_plane(float (&d)[4], const unsigned (&a)[MX_REGS],
                                          const unsigned (&b)[3]) {
  mma_bf16(d, a[0], a[3], a[1], a[4], b[0], b[0]);  // (0,0), (0,1)
  mma_bf16(d, a[0], a[3], a[2], a[5], b[1], b[0]);  // (1,0), (0,2)
  mma_bf16(d, a[1], a[4], a[0], a[3], b[1], b[2]);  // (1,1), (2,0)
}

// Every lane of the warp, with its own ray: stage the warp's ray operand
// into `frag` (MX_WARP_WORDS words of shared memory) and return in mt the
// max_t of the lane's four fragment rays (ray 16 m + 8 h + g at [m][h]).
__device__ __forceinline__ void mx_stage(const Ray& r, float max_t, unsigned* frag,
                                         float (&mt)[2][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float x[6] = {r.dx, r.dy, r.dz, r.wx, r.wy, r.wz};
  float z[3] = {r.ox, r.oy, r.oz};
  __syncwarp();  // the warp is done with the last walk's operand
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int src = 16 * m + 8 * h + g;
      float v[6], o[3];
#pragma unroll
      for (int i = 0; i < 6; ++i) v[i] = __shfl_sync(0xffffffffu, x[i], src);
#pragma unroll
      for (int i = 0; i < 3; ++i) o[i] = __shfl_sync(0xffffffffu, z[i], src);
      mt[m][h] = __shfl_sync(0xffffffffu, max_t, src);
      const float xa = t == 0 ? v[0] : t == 1 ? v[2] : t == 2 ? v[4] : 0.0f;
      const float xb = t == 0 ? v[1] : t == 1 ? v[3] : t == 2 ? v[5] : 0.0f;
      const float za = t == 0 ? o[0] : t == 1 ? o[2] : 0.0f;
      const float zb = t == 0 ? o[1] : t == 1 ? 1.0f : 0.0f;
      unsigned px[3], pz[3];
      limb_pairs(xa, xb, px);
      limb_pairs(za, zb, pz);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        frag[((m * 2 + 0) * MX_REGS + 3 * h + j) * 32 + lane] = px[j];
        frag[((m * 2 + 1) * MX_REGS + 3 * h + j) * 32 + lane] = pz[j];
      }
    }
  }
  __syncwarp();
}

// The staged ray operand of m-tile m: X and Z, six registers each.
__device__ __forceinline__ void mx_load_a(const unsigned* frag, int m, unsigned (&ax)[MX_REGS],
                                          unsigned (&az)[MX_REGS]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < MX_REGS; ++j) {
    ax[j] = frag[((m * 2 + 0) * MX_REGS + j) * 32 + lane];
    az[j] = frag[((m * 2 + 1) * MX_REGS + j) * 32 + lane];
  }
}

// The geometry operand of n-tile nt of a staged cluster (`rows`: k rows of
// GEOM_COMPS floats): this lane's slots 2t, 2t + 1 of row 8 nt + g, split
// into limbs per plane (va, vb, vc, s, num); zeros past row k.
__device__ __forceinline__ void mx_load_b(const float* rows, int k, int nt,
                                          unsigned (&b)[5][3]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = MX_TILE_ROWS * nt + g;
  float c[5][2];
#pragma unroll
  for (int p = 0; p < 5; ++p) c[p][0] = c[p][1] = 0.0f;
  if (row < k) {
    const float* q = rows + row * GEOM_COMPS;
    if (t < 3) {
      c[0][0] = q[C_VA + 2 * t];
      c[0][1] = q[C_VA + 2 * t + 1];
      c[1][0] = q[C_VB + 2 * t];
      c[1][1] = q[C_VB + 2 * t + 1];
      c[2][0] = q[C_VC + 2 * t];
      c[2][1] = q[C_VC + 2 * t + 1];
    }
    if (t == 0) {
      c[3][0] = q[C_GN];
      c[3][1] = q[C_GN + 1];
      c[4][0] = -q[C_GN];
      c[4][1] = -q[C_GN + 1];
    } else if (t == 1) {
      c[3][0] = q[C_GN + 2];
      c[4][0] = -q[C_GN + 2];
      c[4][1] = q[C_NDA];
    }
  }
#pragma unroll
  for (int p = 0; p < 5; ++p) limb_pairs(c[p][0], c[p][1], b[p]);
}

// The five planes of m-tile m against n-tile `b`: d[p][e] for the lane's
// element e, ray 16 m + g + 8 (e >> 1), row 8 nt + 2t + (e & 1).
__device__ __forceinline__ void mx_planes(const unsigned (&ax)[MX_REGS],
                                          const unsigned (&az)[MX_REGS],
                                          const unsigned (&b)[5][3], float (&d)[5][4]) {
#pragma unroll
  for (int p = 0; p < 5; ++p) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[p][e] = 0.0f;
    if (p < 4) {
      mma_plane(d[p], ax, b[p]);
    } else {
      mma_plane(d[p], az, b[p]);
    }
  }
}

// The exact test's selection on one element's planes (mxu_sel,
// kernel_core.py:640-649; pair_test's operations from its planes on).
__device__ __forceinline__ bool mx_valid(const float (&d)[5][4], int e, float& t, float& inv_s) {
  const float va = d[0][e], vb = d[1][e], vc = d[2][e], s = d[3][e];
  inv_s = 1.0f / s;
  t = d[4][e] * inv_s;
  return (fabsf(s) >= EPSILON) && (va * s >= 0.0f) && (vb * s >= 0.0f) && (vc * s >= 0.0f) &&
         (t > EPSILON);
}

// Closest hit: fold every pair of a staged cluster of k rows (row0: the
// index of its first row in the flat geometry) whose ray's bit is set in
// `w` (the warp's rays that entered the box) into the lane's running
// winners b[m][h].
__device__ __forceinline__ void mx_closest_cluster(const float* rows, int k, int row0,
                                                   unsigned w, const unsigned* frag,
                                                   Best (&b)[2][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int nt = 0; MX_TILE_ROWS * nt < k; ++nt) {
    if (rows[MX_TILE_ROWS * nt * GEOM_COMPS + C_GID] >= GID_PAD) break;  // padding rows sort last
    unsigned bf[5][3];
    mx_load_b(rows, k, nt, bf);
    float gid[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = MX_TILE_ROWS * nt + 2 * t + c;
      gid[c] = row < k ? rows[row * GEOM_COMPS + C_GID] : GID_PAD;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (((w >> (16 * m)) & 0xffffu) == 0u) continue;  // warp-uniform
      unsigned ax[MX_REGS], az[MX_REGS];
      mx_load_a(frag, m, ax, az);
      float d[5][4];
      mx_planes(ax, az, bf, d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        if (!((w >> (16 * m + 8 * h + g)) & 1u) || gid[e & 1] >= GID_PAD) continue;
        float tt, inv_s;
        Best& bb = b[m][h];
        if (mx_valid(d, e, tt, inv_s) && (tt < bb.t || (tt == bb.t && gid[e & 1] < bb.gid))) {
          bb.t = tt;
          bb.gid = gid[e & 1];
          bb.row = row0 + MX_TILE_ROWS * nt + 2 * t + (e & 1);
          bb.u = d[1][e] * inv_s;
          bb.v = d[2][e] * inv_s;
        }
      }
    }
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

// Any hit: test a staged cluster's rows against the warp's rays with bits
// in `w` (entered the box and still walking), an n-tile at a time; a ray
// with a valid pair at t <= its max_t (mt, mx_stage's) stops walking
// (`walking`, the lane's own ray) after that n-tile. Returns when no ray
// of `w` walks or the rows end.
__device__ __forceinline__ void mx_any_cluster(const float* rows, int k, unsigned w,
                                               const unsigned* frag, const float (&mt)[2][2],
                                               bool& walking) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int nt = 0; MX_TILE_ROWS * nt < k; ++nt) {
    if (rows[MX_TILE_ROWS * nt * GEOM_COMPS + C_GID] >= GID_PAD) break;
    unsigned bf[5][3];
    mx_load_b(rows, k, nt, bf);
    bool real[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = MX_TILE_ROWS * nt + 2 * t + c;
      real[c] = row < k && rows[row * GEOM_COMPS + C_GID] < GID_PAD;
    }
    unsigned occ = 0u;  // bit 2 m + h: ray 16 m + 8 h + g has an occluder here
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (((w >> (16 * m)) & 0xffffu) == 0u) continue;  // warp-uniform
      unsigned ax[MX_REGS], az[MX_REGS];
      mx_load_a(frag, m, ax, az);
      float d[5][4];
      mx_planes(ax, az, bf, d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        if (!((w >> (16 * m + 8 * h + g)) & 1u) || !real[e & 1]) continue;
        float tt, inv_s;
        if (mx_valid(d, e, tt, inv_s) && tt <= mt[m][h]) occ |= 1u << (2 * m + h);
      }
    }
    occ |= __shfl_xor_sync(0xffffffffu, occ, 1);
    occ |= __shfl_xor_sync(0xffffffffu, occ, 2);
    const unsigned own = __shfl_sync(0xffffffffu, occ, (lane & 7) * 4);
    if ((own >> (lane >> 3)) & 1u) walking = false;
    w &= __ballot_sync(0xffffffffu, walking);
    if (w == 0u) break;
  }
}

}  // namespace cosig
