// Block-cooperative cluster walk: the closest hit and the any hit of the
// 128 rays of a thread block, for every kernel (primary, bounce,
// megakernel, debug).
//
// The counterpart of the TPU kernel's three-step traversal
// (cosig_tpu/ops/kernel_core.py:215-242): the tile becomes the thread
// block, the SMEM hit list a list in shared memory, the sub-packet visit
// mask a per-warp mask, and the geometry DMA (stream=True) a ring of bulk
// async copies (cp.async.bulk, the TMA's non-tensor form) completing on
// mbarriers. Every thread of the block calls a walk, each with its own ray
// and an `active` flag; inactive threads take part in every barrier.
//
//  1. Cull. The boxes sit in shared memory as [c][8] (two 16-byte words
//     per box), staged once per block when the scene has at most TILE_C
//     clusters, else once per pass of TILE_C. Each active ray runs
//     box_pass on every cluster of the pass; a warp ballot stores which
//     lanes enter it, one word per (cluster, warp). The any hit also
//     applies the tn > max_t skip here.
//  2. List. Warp 0 compacts the clusters that some lane enters into a list
//     in ascending cluster order: the closest-hit fold does not need the
//     order (the (t, gid) winner is order-free), but the any hit must stop
//     at the occluder a walk in cluster order stops at (the plain
//     kernel_core.traverse, whose WORK counts its pair tests so).
//  3. Walk. Thread 0 keeps the next RING_STAGES listed clusters' rows in
//     flight, K x 144 contiguous bytes each, one mbarrier per ring slot.
//     A warp whose ballot word is 0 skips the cluster; otherwise its lanes
//     read each row from shared memory as 16-byte broadcasts and the lanes
//     that entered the box run pair_test on it. The padding-row break
//     stays. An any-hit lane stops at its first occluder and the block
//     stops when __syncthreads_or finds no lane still walking; copies
//     still in flight are waited for, so the ring is idle between walks.
//
// A slot's mbarrier completes one phase per copy; copy q (counted over the
// block's whole life, `seq`) uses slot q % RING_STAGES and waits on parity
// (q / RING_STAGES) & 1. A slot is refilled only after the block barrier
// that ends the visit of its previous cluster, so no thread can fall two
// phases behind.
//
// Bound: the pair tests. What this walk removes is issue pressure: a pair
// test reads its row from 7 sixteen-byte shared-memory words and the gid
// (8 loads, against 23 four-byte global loads in a walk of one ray per
// thread through the read-only cache), a slab test 2 words instead of 6
// loads, and the rows arrive ahead of their use. The up-front cull
// runs a shadow ray's slab tests on every cluster of the pass, also those
// after its first occluder, so the bound's count (kernel_core.WORK,
// shadow rays up to their first occluder) stays a floor. The per-pair
// arithmetic is traverse.cuh's: box_pass, pair_test and finish_closest
// unchanged. Not tensor cores: the three edge volumes per pair are a small
// matrix product (the TPU had an MXU form), but wgmma accumulates in its
// own order and rounds its inputs to TF32 or bf16, so it would keep
// neither the Plücker chain order nor the unfused float32 roundings that
// make these kernels bit-equal to their plain versions.
#pragma once

#include "traverse.cuh"

namespace cosig {

constexpr int TILE_THREADS = 128;
constexpr int TILE_WARPS = TILE_THREADS / 32;
constexpr int TILE_C = 256;      // clusters culled and listed per pass
constexpr int RING_STAGES = 3;   // clusters in flight
constexpr int ROW_BYTES = GEOM_COMPS * 4;  // 144 = 9 sixteen-byte words
constexpr unsigned FULL_MASK = 0xffffffffu;

// Dynamic shared memory of a walk over clusters of k rows: the ring, the
// boxes [TILE_C][8], the ballots [TILE_C][TILE_WARPS], the list, the
// mbarriers and the list length. Every offset is a multiple of 16.
struct TileLayout {
  unsigned ring, boxes, ballots, list, bars, count, total;
};

__host__ __device__ inline TileLayout tile_layout(int k) {
  TileLayout l;
  l.ring = 0;
  l.boxes = (unsigned)(RING_STAGES * k * ROW_BYTES);
  l.ballots = l.boxes + TILE_C * 32;
  l.list = l.ballots + TILE_C * TILE_WARPS * 4;
  l.bars = l.list + TILE_C * 4;
  l.count = l.bars + 16 * ((RING_STAGES * 8 + 15) / 16);
  l.total = l.count + 16;
  return l;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One thread: copy `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Row k of a staged cluster: the pair test's 22 constants from 7 of its 9
// sixteen-byte words (columns 0-27; word 8 holds the gid).
__device__ __forceinline__ PairRow row_smem(const float4* p) {
  const float4 a = p[0], b = p[1], c = p[2], d = p[3], e = p[4], f = p[5], h = p[6];
  PairRow q;
  q.gnx = a.w;  // columns 3-5: the plane normal
  q.gny = b.x;
  q.gnz = b.y;
  q.nda = b.z;  // column 6
  q.va[0] = b.w;  // columns 7-12
  q.va[1] = c.x;
  q.va[2] = c.y;
  q.va[3] = c.z;
  q.va[4] = c.w;
  q.va[5] = d.x;
  q.vb[0] = d.y;  // columns 13-18
  q.vb[1] = d.z;
  q.vb[2] = d.w;
  q.vb[3] = e.x;
  q.vb[4] = e.y;
  q.vb[5] = e.z;
  q.vc[0] = e.w;  // columns 19-24
  q.vc[1] = f.x;
  q.vc[2] = f.y;
  q.vc[3] = f.z;
  q.vc[4] = f.w;
  q.vc[5] = h.x;
  return q;
}

struct BlockWalk {
  Geometry g;
  unsigned char* smem;  // dynamic shared memory, laid out by tile_layout(g.k)
  unsigned seq;  // bulk copies issued so far; the same in every thread

  // Every thread of the block, once, before the first walk.
  __device__ __forceinline__ void init(const Geometry& geo, unsigned char* base) {
    g = geo;
    smem = base;
    seq = 0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < RING_STAGES; ++s) mbar_init(smem_u32(smem + lay().bars + 8 * s), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (g.n_clusters <= TILE_C) stage_boxes(0);
    __syncthreads();
  }

  __device__ __forceinline__ TileLayout lay() const { return tile_layout(g.k); }
  __device__ __forceinline__ int lane() const { return threadIdx.x & 31; }
  __device__ __forceinline__ int warp() const { return threadIdx.x >> 5; }

  __device__ __forceinline__ float4* boxes() const {
    return reinterpret_cast<float4*>(smem + lay().boxes);
  }
  __device__ __forceinline__ unsigned* ballots() const {
    return reinterpret_cast<unsigned*>(smem + lay().ballots);
  }
  __device__ __forceinline__ int* list() const {
    return reinterpret_cast<int*>(smem + lay().list);
  }

  // Boxes c0 .. c0 + TILE_C - 1 of aabb [8, c_pad] into [c][8].
  __device__ __forceinline__ void stage_boxes(int c0) {
    const int n = min(TILE_C, g.n_clusters - c0);
    float4* bx = boxes();
    for (int c = threadIdx.x; c < n; c += TILE_THREADS) {
      const Box b = box_ldg(g, c0 + c);
      bx[2 * c] = make_float4(b.b0, b.b1, b.b2, 0.0f);
      bx[2 * c + 1] = make_float4(b.b3, b.b4, b.b5, 0.0f);
    }
  }

  // Thread 0: copy cluster c's rows into the slot of copy q.
  __device__ __forceinline__ void issue(unsigned q, int c) {
    const unsigned slot = q % RING_STAGES;
    const unsigned bytes = (unsigned)g.k * ROW_BYTES;
    bulk_copy(smem_u32(smem + lay().ring + slot * bytes), g.geom + (size_t)c * g.k * GEOM_COMPS,
              bytes, smem_u32(smem + lay().bars + 8 * slot));
  }

  __device__ __forceinline__ void wait_copy(unsigned q) {
    mbar_wait(smem_u32(smem + lay().bars + 8 * (q % RING_STAGES)), (q / RING_STAGES) & 1u);
  }

  // Steps 1 and 2 on clusters c0 .. c0 + n - 1 -> the list length.
  template <bool ANY>
  __device__ __forceinline__ int cull(const Ray& r, bool enter, float max_t, int c0, int n) {
    if (g.n_clusters > TILE_C) {
      __syncthreads();  // the previous pass has read its boxes
      stage_boxes(c0);
      __syncthreads();
    }
    unsigned* bal = ballots();
    if (__any_sync(FULL_MASK, enter)) {
      const float4* bx = boxes();
      for (int c = 0; c < n; ++c) {
        const float4 lo = bx[2 * c], hi = bx[2 * c + 1];
        Box b;
        b.b0 = lo.x;
        b.b1 = lo.y;
        b.b2 = lo.z;
        b.b3 = hi.x;
        b.b4 = hi.y;
        b.b5 = hi.z;
        float tn;
        bool pass = box_pass(b, r, tn);
        if (ANY) pass = pass && !(tn > max_t);
        const unsigned w = __ballot_sync(FULL_MASK, enter && pass);
        if (lane() == 0) bal[c * TILE_WARPS + warp()] = w;
      }
    } else {
      for (int c = lane(); c < n; c += 32) bal[c * TILE_WARPS + warp()] = 0u;
    }
    __syncthreads();
    int* lst = list();
    int* count = reinterpret_cast<int*>(smem + lay().count);
    if (warp() == 0) {
      int m = 0;
      for (int base = 0; base < n; base += 32) {
        const int c = base + lane();
        bool f = false;
        if (c < n) {
          const uint4 w = *reinterpret_cast<const uint4*>(bal + c * TILE_WARPS);
          f = (w.x | w.y | w.z | w.w) != 0u;
        }
        const unsigned fb = __ballot_sync(FULL_MASK, f);
        if (f) lst[m + __popc(fb & ((1u << lane()) - 1u))] = c;
        m += __popc(fb);
      }
      if (lane() == 0) *count = m;
    }
    __syncthreads();
    return *count;
  }

  // Closest hit of every thread's ray; inactive threads get a miss.
  __device__ __forceinline__ Hit closest(float ox, float oy, float oz, float dx, float dy,
                                         float dz, bool active) {
    const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
    Best b = no_hit();
    const unsigned bytes = (unsigned)g.k * ROW_BYTES;
    for (int c0 = 0; c0 < g.n_clusters; c0 += TILE_C) {
      const int n = min(TILE_C, g.n_clusters - c0);
      const int m = cull<false>(r, active, 0.0f, c0, n);
      const int* lst = list();
      const unsigned* bal = ballots();
      const unsigned base = seq;
      if (threadIdx.x == 0) {
        for (int j = 0; j < min(RING_STAGES, m); ++j) issue(base + j, c0 + lst[j]);
      }
      for (int j = 0; j < m; ++j) {
        const unsigned q = base + j;
        const int c = lst[j];
        const unsigned w = bal[c * TILE_WARPS + warp()];
        if (w != 0u) {
          wait_copy(q);
          const bool mine = (w >> lane()) & 1u;
          const float4* rows =
              reinterpret_cast<const float4*>(smem + lay().ring + (q % RING_STAGES) * bytes);
          const int row0 = (c0 + c) * g.k;
          for (int k = 0; k < g.k; ++k) {
            const float4* p = rows + 9 * k;
            const float gid = p[8].w;
            if (gid >= GID_PAD) break;  // padding rows: all-zero constants, never valid
            if (mine) fold_pair(b, row_smem(p), gid, r, row0 + k);
          }
        }
        __syncthreads();  // every warp is done with this slot
        if (threadIdx.x == 0 && j + RING_STAGES < m) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue(q + RING_STAGES, c0 + lst[j + RING_STAGES]);
        }
      }
      seq = base + m;
    }
    return finish_closest(g, r, b);
  }

  // Any hit of every thread's ray at t <= max_t; false for inactive threads.
  __device__ __forceinline__ bool any(float ox, float oy, float oz, float dx, float dy,
                                      float dz, float max_t, bool active) {
    const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
    bool walking = active;  // active and no occluder found yet
    const unsigned bytes = (unsigned)g.k * ROW_BYTES;
    for (int c0 = 0; c0 < g.n_clusters; c0 += TILE_C) {
      if (c0 > 0 && !__syncthreads_or(walking)) break;
      const int n = min(TILE_C, g.n_clusters - c0);
      const int m = cull<true>(r, walking, max_t, c0, n);
      const int* lst = list();
      const unsigned* bal = ballots();
      const unsigned base = seq;
      const int first = min(RING_STAGES, m);
      if (threadIdx.x == 0) {
        for (int j = 0; j < first; ++j) issue(base + j, c0 + lst[j]);
      }
      int issued = first, j = 0;
      while (j < m) {
        const unsigned q = base + j;
        const int c = lst[j];
        // Every warp that entered the box waits for its rows, walking or
        // not: a copy that no thread waited for could still be landing
        // when its slot is refilled.
        const unsigned entered = bal[c * TILE_WARPS + warp()];
        if (entered != 0u) wait_copy(q);
        const unsigned w = entered & __ballot_sync(FULL_MASK, walking);
        if (w != 0u) {
          bool mine = (w >> lane()) & 1u;
          const float4* rows =
              reinterpret_cast<const float4*>(smem + lay().ring + (q % RING_STAGES) * bytes);
          for (int k = 0; k < g.k; ++k) {
            const float4* p = rows + 9 * k;
            if (p[8].w >= GID_PAD) break;
            if (mine) {
              float t, vb, vc, inv_s;
              if (pair_test(row_smem(p), r, t, vb, vc, inv_s) && t <= max_t) {
                mine = false;
                walking = false;
              }
            }
            if (__ballot_sync(FULL_MASK, mine) == 0u) break;
          }
        }
        ++j;
        if (!__syncthreads_or(walking)) break;  // also: every warp is done with this slot
        if (threadIdx.x == 0 && issued < m) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue(base + issued, c0 + lst[issued]);
        }
        if (issued < m) ++issued;
      }
      // Copies still in flight after an early stop land before the ring is reused.
      for (int jj = j; jj < issued; ++jj) wait_copy(base + jj);
      seq = base + issued;
    }
    // Occluded by a triangle (active, no longer walking), else by a primitive.
    return active && (!walking || prims_occlude(g, r, max_t));
  }
};

}  // namespace cosig
