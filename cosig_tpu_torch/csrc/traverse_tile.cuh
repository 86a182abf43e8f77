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
//  0. Pre-filters (traverse.cuh frustum_pass; kernel_core.py:455-590),
//     at the start of each pass of TILE_C clusters. With 513 to 65,536
//     clusters (traverse.cuh superblocks(); the kernels' builds with SB,
//     which their launches pick for such scenes), at the first pass of
//     each superblock of 512 the block tests the superblock's union box (sb_aabb): in frustum mode the
//     block's hull against it, else every ray's own one-ray hull, OR-ed
//     with a block barrier; a superblock no ray enters skips both its
//     passes. In frustum mode (coherent rays: the primary's camera and
//     shadow rays, the megakernel at depth 0, the debug kernel) the block
//     reduces the hull of its rays still walking (warp shuffles, then
//     shared memory) and skips the pass when none walks; each thread tests
//     clusters tid and tid + 128 of the pass against the hull, and warp 0
//     lists the clusters that pass in ascending order.
//  1. Cull. The boxes sit in shared memory as [c][8] (two 16-byte words
//     per box), staged once per block when the scene has at most TILE_C
//     clusters, else once per pass of TILE_C. Each active ray runs
//     box_pass on every cluster of the pass that step 0 lets through; a
//     warp ballot stores which lanes enter it, one word per (cluster,
//     warp). The any hit also applies the tn > max_t skip here.
//  2. List. Warp 0 compacts the clusters that some lane enters into a list
//     in ascending cluster order: the closest-hit fold does not need the
//     order (the (t, gid) winner is order-free), but the any hit must stop
//     at the occluder a walk in cluster order stops at (the plain
//     kernel_core.traverse, whose WORK counts its pair tests so). Step 0
//     passes a superset of the boxes some lane enters, so the list is the
//     flat walk's, cluster for cluster.
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
// unchanged.
//
// MX (BlockWalk<SB, true>): the same walk with the tensor-core form of the
// pair test in step 3 (mx_pair.cuh, the TPU's MXU form): each lane splits
// its fragment rays' limbs once per walk into registers (mx_stage, the
// wgmma register operand); for every listed cluster, once its rows land in
// the ring, every thread of the block waits for them, 40 threads split
// each n-tile into a B tile in shared memory (tile_layout's mxb region,
// two tiles) and the block's one warpgroup issues wgmma on it, a running
// winner per fragment row, and each ray gets its winner at the end
// (mx_finish). Lanes outside the box take part in the products but do not
// fold; a warp with no ray in the box skips only the selection. The any
// hit takes that form when mx_any is set (full mode), else the exact test
// (closest-only mode, a runtime flag of the same build). The exact builds
// keep their code: every MX branch is `if constexpr`.
#pragma once

#include "mx_pair.cuh"
#include "traverse.cuh"

namespace cosig {

constexpr int TILE_THREADS = 128;
constexpr int TILE_WARPS = TILE_THREADS / 32;
constexpr int TILE_C = 256;      // clusters culled and listed per pass
constexpr int RING_STAGES = 3;   // clusters in flight
constexpr int ROW_BYTES = GEOM_COMPS * 4;  // 144 = 9 sixteen-byte words
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int HULL_SLOTS = 16;  // a warp's partial hull: 13 floats and the flag bits

// Dynamic shared memory of a walk over clusters of k rows: the ring, the
// boxes [TILE_C][8], the ballots [TILE_C][TILE_WARPS], the list, the
// frustum candidates (the clusters of a pass the block's hull passes, in
// order) and their flag words, the warps' partial hulls
// [TILE_WARPS][HULL_SLOTS], the block's hull, the mbarriers and the two
// list lengths, and with `mx` the two B tiles of the tensor-core pair
// test (mx_layout.h, MX_B_BYTES each, at a multiple of MX_B_ALIGN). Every
// offset is a multiple of 16.
struct TileLayout {
  unsigned ring, boxes, ballots, list, cand, pre, partial, hull, bars, count, mxb, total;
};

__host__ __device__ inline TileLayout tile_layout(int k, bool mx = false) {
  TileLayout l;
  l.ring = 0;
  l.boxes = (unsigned)(RING_STAGES * k * ROW_BYTES);
  l.ballots = l.boxes + TILE_C * 32;
  l.list = l.ballots + TILE_C * TILE_WARPS * 4;
  l.cand = l.list + TILE_C * 4;
  l.pre = l.cand + TILE_C * 4;
  l.partial = l.pre + 16 * ((TILE_C / 32 * 4 + 15) / 16);
  l.hull = l.partial + TILE_WARPS * HULL_SLOTS * 4;
  l.bars = l.hull + 16 * (((unsigned)sizeof(Hull) + 4 + 15) / 16);
  l.count = l.bars + 16 * ((RING_STAGES * 8 + 15) / 16);
  l.mxb = l.count + 16;
  if (mx) l.mxb = (l.mxb + MX_B_ALIGN - 1) / MX_B_ALIGN * MX_B_ALIGN;
  l.total = l.mxb + (mx ? 2u * MX_B_BYTES : 0u);
  return l;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_inval(unsigned bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
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

// SB: the walk runs the superblock cull. Every ray kernel is built both
// ways and its launch picks SB = (superblocks(n_clusters) > 0), so that a
// scene of at most 512 clusters (or past 65,536, where the walk is flat)
// runs none of its code: present but unused, it cost the bounce 2-3 %
// (PERF.md). MX: the tensor-core form of the pair test (see the top).
template <bool SB, bool MX = false>
struct BlockWalk {
  Geometry g;
  unsigned char* smem;  // dynamic shared memory, laid out by tile_layout(g.k, MX)
  unsigned seq;  // bulk copies issued so far; the same in every thread
  bool sb_open;  // some ray of the block enters the current superblock; the same in every thread
  bool mx_any;  // MX: the any hit takes the tensor-core form too (full mode); the same in every thread

  // Every thread of the block, once, before the first walk.
  __device__ __forceinline__ void init(const Geometry& geo, unsigned char* base) {
    g = geo;
    smem = base;
    seq = 0;
    sb_open = true;
    mx_any = false;
    if (threadIdx.x == 0) {
      for (int s = 0; s < RING_STAGES; ++s) mbar_init(smem_u32(smem + lay().bars + 8 * s), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (g.n_clusters <= TILE_C) stage_boxes(0);
    __syncthreads();
  }

  __device__ __forceinline__ TileLayout lay() const { return tile_layout(g.k, MX); }
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
  __device__ __forceinline__ int* count() const {
    return reinterpret_cast<int*>(smem + lay().count);
  }
  __device__ __forceinline__ Hull* hull() const {
    return reinterpret_cast<Hull*>(smem + lay().hull);
  }
  // MX: the two B tiles.
  __device__ __forceinline__ unsigned char* mx_tiles() const { return smem + lay().mxb; }

  // The block's hull of the rays with `in` set, into shared memory ->
  // whether some ray is in (the same in every thread). Each warp reduces
  // its lanes with shuffles (min and max that keep NaN, so a NaN ray
  // makes a NaN hull, which passes), lane 0 stores the warp's partial
  // hull, then thread f < 14 combines field f over the warps; the
  // threads that combine a direction bound also take its reciprocal.
  // Every thread of the block calls it.
  __device__ __forceinline__ bool block_hull(const Ray& r, bool in, float max_t) {
    float v[13];
    const float o[3] = {r.ox, r.oy, r.oz}, d[3] = {r.dx, r.dy, r.dz};
    const float id[3] = {r.idx, r.idy, r.idz};
    unsigned bits = in ? 64u : 0u;  // bits 0-2 zinf, 3-5 wild, 6 some ray is in
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = in ? o[a] : INFINITY;       // olo
      v[3 + a] = in ? o[a] : -INFINITY;  // ohi
      v[6 + a] = in ? d[a] : INFINITY;   // dlo
      v[9 + a] = in ? d[a] : -INFINITY;  // dhi
      if (in && isinf(id[a])) bits |= 1u << a;
      if (in && !isfinite(d[a])) bits |= 8u << a;
    }
    v[12] = in ? max_t : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < 13; ++i) {
        const float w = __shfl_xor_sync(FULL_MASK, v[i], off);
        v[i] = (i < 3 || (i >= 6 && i < 9)) ? nan_min(v[i], w) : nan_max(v[i], w);
      }
    }
    bits = __reduce_or_sync(FULL_MASK, bits);
    float* part = reinterpret_cast<float*>(smem + lay().partial);
    __syncthreads();  // every thread is done with the previous hull
    if (lane() == 0) {
#pragma unroll
      for (int i = 0; i < 13; ++i) part[warp() * HULL_SLOTS + i] = v[i];
      part[warp() * HULL_SLOTS + 13] = __uint_as_float(bits);
    }
    __syncthreads();
    const int f = threadIdx.x;
    if (f < 13) {
      const bool is_min = f < 3 || (f >= 6 && f < 9);
      float x = part[f];
      for (int w = 1; w < TILE_WARPS; ++w) {
        x = is_min ? nan_min(x, part[w * HULL_SLOTS + f]) : nan_max(x, part[w * HULL_SLOTS + f]);
      }
      Hull* h = hull();
      const int a = f % 3;
      if (f < 3) {
        h->olo[a] = x;
      } else if (f < 6) {
        h->ohi[a] = x;
      } else if (f < 9) {
        h->dlo[a] = x;
        h->rhi[a] = 1.0f / x;
      } else if (f < 12) {
        h->dhi[a] = x;
        h->rlo[a] = 1.0f / x;
      } else {
        h->mt = x;
      }
    } else if (f == 13) {
      unsigned b = 0u;
      for (int w = 0; w < TILE_WARPS; ++w) b |= __float_as_uint(part[w * HULL_SLOTS + 13]);
      Hull* h = hull();
      for (int a = 0; a < 3; ++a) {
        h->zinf[a] = (b >> a) & 1u;
        h->wild[a] = (b >> (3 + a)) & 1u;
      }
      count()[2] = (int)(b >> 6);
    }
    __syncthreads();
    return count()[2] != 0;
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

  // Step 0 on clusters c0 .. c0 + n - 1 of the rays with `enter` set: the
  // pre-filters, then the boxes of the pass staged -> the candidates' count
  // (cand[0 .. count) in frustum mode, else all n), or -1 when the block
  // skips the pass; the same in every thread. Inlined: as a call (which
  // puts the walk's state on the stack) the primary, the megakernel and
  // the debug kernel timed 6-16 % slower than with the inlined form's few
  // more registers and spilled bytes (PERF.md).
  __device__ __forceinline__ int prefilter(const Ray& r, bool enter, float max_t, bool frustum,
                                           int c0, int n) {
    // A block with no ray to walk skips the pass (walking can only stop, so
    // a later pass has none either); without the frustum cull it is left to
    // the superblock test and the per-warp vote below, as in the flat walk.
    if (frustum && !block_hull(r, enter, max_t)) return -1;
    if (SB && c0 % SB_CLUSTERS == 0) {
      const Box sb = sb_box_ldg(g, c0 / SB_CLUSTERS);
      sb_open = frustum ? frustum_pass(*hull(), sb)
                        : __syncthreads_or(enter && ray_enters(r, max_t, sb));
    }
    if (SB && !sb_open) return -1;
    if (g.n_clusters > TILE_C) {
      __syncthreads();  // the previous pass has read its boxes
      stage_boxes(c0);
      __syncthreads();
    }
    if (!frustum) return n;
    const float4* bx = boxes();
    int* cand = reinterpret_cast<int*>(smem + lay().cand);
    unsigned* pre = reinterpret_cast<unsigned*>(smem + lay().pre);
    const Hull& h = *hull();
#pragma unroll
    for (int q = 0; q < TILE_C / TILE_THREADS; ++q) {
      const int c = q * TILE_THREADS + threadIdx.x;
      bool f = false;
      if (c < n) {
        const float4 lo = bx[2 * c], hi = bx[2 * c + 1];
        Box b;
        b.b0 = lo.x;
        b.b1 = lo.y;
        b.b2 = lo.z;
        b.b3 = hi.x;
        b.b4 = hi.y;
        b.b5 = hi.z;
        f = frustum_pass(h, b);
      }
      const unsigned w = __ballot_sync(FULL_MASK, f);
      if (lane() == 0) pre[c >> 5] = w;
    }
    __syncthreads();
    if (warp() == 0) {
      int m = 0;
      for (int base = 0; base < n; base += 32) {
        const int c = base + lane();
        const bool f = c < n && ((pre[base >> 5] >> lane()) & 1u);
        const unsigned fb = __ballot_sync(FULL_MASK, f);
        if (f) cand[m + __popc(fb & ((1u << lane()) - 1u))] = c;
        m += __popc(fb);
      }
      if (lane() == 0) count()[1] = m;
    }
    __syncthreads();
    return count()[1];
  }

  // Steps 0 to 2 on clusters c0 .. c0 + n - 1 of the rays with `enter`
  // set -> the list length (the same in every thread).
  template <bool ANY>
  __device__ __forceinline__ int cull(const Ray& r, bool enter, float max_t, bool frustum,
                                      int c0, int n) {
    const int m0 = prefilter(r, enter, max_t, frustum, c0, n);
    if (m0 < 0) return 0;
    const float4* bx = boxes();
    const int* cand = reinterpret_cast<const int*>(smem + lay().cand);
    // 1. The per-ray slab test of each candidate.
    unsigned* bal = ballots();
    if (__any_sync(FULL_MASK, enter)) {
      for (int j = 0; j < m0; ++j) {
        const int c = frustum ? cand[j] : j;
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
      for (int j = lane(); j < m0; j += 32) bal[(frustum ? cand[j] : j) * TILE_WARPS + warp()] = 0u;
    }
    __syncthreads();
    // 2. The list, in ascending cluster order.
    int* lst = list();
    if (warp() == 0) {
      int m = 0;
      for (int base = 0; base < m0; base += 32) {
        const int j = base + lane();
        bool f = false;
        int c = 0;
        if (j < m0) {
          c = frustum ? cand[j] : j;
          const uint4 w = *reinterpret_cast<const uint4*>(bal + c * TILE_WARPS);
          f = (w.x | w.y | w.z | w.w) != 0u;
        }
        const unsigned fb = __ballot_sync(FULL_MASK, f);
        if (f) lst[m + __popc(fb & ((1u << lane()) - 1u))] = c;
        m += __popc(fb);
      }
      if (lane() == 0) count()[0] = m;
    }
    __syncthreads();
    return count()[0];
  }

  // Closest hit of every thread's ray; inactive threads get a miss.
  // `frustum` (the same in every thread): run the frustum pre-cull.
  __device__ __forceinline__ Hit closest(float ox, float oy, float oz, float dx, float dy,
                                         float dz, bool active, bool frustum) {
    const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
    Best b = no_hit();
    Best bm[2][2];  // MX: the running winners of the lane's fragment rows
    MxRays mx;      // MX: the lane's fragment rays' limbs
    float mt_unused[2][2];
    if constexpr (MX) {
      for (int m = 0; m < 2; ++m)
        for (int h = 0; h < 2; ++h) bm[m][h] = no_hit();
      mx_stage(r, INF, mx, mt_unused);
    }
    const unsigned bytes = (unsigned)g.k * ROW_BYTES;
    sb_open = true;
    for (int c0 = 0; c0 < g.n_clusters; c0 += TILE_C) {
      const int n = min(TILE_C, g.n_clusters - c0);
      const int m = cull<false>(r, active, INFINITY, frustum, c0, n);
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
        if constexpr (MX) {
          // Every thread: the block splits the rows and issues the products.
          wait_copy(q);
          mx_closest_cluster(
              reinterpret_cast<const float*>(smem + lay().ring + (q % RING_STAGES) * bytes),
              g.k, (c0 + c) * g.k, w, mx, mx_tiles(), bm);
        } else if (w != 0u) {
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
    if constexpr (MX) b = mx_finish(bm);
    return finish_closest(g, r, b);
  }

  // Any hit of every thread's ray at t <= max_t; false for inactive
  // threads. The pre-filters of each pass take the rays still walking.
  __device__ __forceinline__ bool any(float ox, float oy, float oz, float dx, float dy,
                                      float dz, float max_t, bool active, bool frustum) {
    const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
    bool walking = active;  // active and no occluder found yet
    MxRays mx;       // MX: the lane's fragment rays' limbs
    float mt[2][2];  // MX: max_t of the lane's fragment rows
    if constexpr (MX) {
      if (mx_any) mx_stage(r, max_t, mx, mt);
    }
    const unsigned bytes = (unsigned)g.k * ROW_BYTES;
    sb_open = true;
    for (int c0 = 0; c0 < g.n_clusters; c0 += TILE_C) {
      if (c0 > 0 && !__syncthreads_or(walking)) break;
      const int n = min(TILE_C, g.n_clusters - c0);
      const int m = cull<true>(r, walking, max_t, frustum, c0, n);
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
        // when its slot is refilled. In the tensor-core form every thread
        // waits: the block splits the rows.
        const unsigned entered = bal[c * TILE_WARPS + warp()];
        bool mx_walk = false;  // the same in every thread
        if constexpr (MX) mx_walk = mx_any;
        if (entered != 0u || mx_walk) wait_copy(q);
        const unsigned w = entered & __ballot_sync(FULL_MASK, walking);
        if constexpr (MX) {
          if (mx_walk) {
            mx_any_cluster(
                reinterpret_cast<const float*>(smem + lay().ring + (q % RING_STAGES) * bytes),
                g.k, w, mx, mt, mx_tiles(), walking);
          }
        }
        if (w != 0u && !mx_walk) {
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

// Hand the block's dynamic shared memory from walk `from` to walk `to`,
// whose geometry is another cluster set (the shadow set): every thread of
// the block, between a bounce's closest hit through `from` and its shadow
// rays through `to` (the uses are strictly sequential, as the TPU kernel's
// shadow traversal shares best_ref and the DMA semaphores with the main
// one, cosig_tpu/ops/trace_wavefront.py:247-267). Every copy `from`
// issued has landed (a closest hit waits for each listed cluster's rows,
// an any hit for the copies still in flight when it stops). Thread 0
// invalidates `from`'s mbarriers, since `to`'s layout (tile_layout of its
// own k) may put ring rows or boxes over them, and `to.init` sets up its
// own; the proxy fence orders the block's generic writes before `to`'s
// bulk copies into the same bytes. The block's shared memory is the larger
// of the two layouts (the launches size it so). `from` may be the
// tensor-core walk (MXA): its B tiles (tile_layout's mxb region, written by
// generic stores, read by wgmma, whose reads completed at each tile's
// wait) are dead after the barrier, and its mbarriers sit at the same
// offsets as the exact layout's, so `to`'s ring may land over both. `to`
// is always exact: the shadow set's walk, as the TPU kernel's shadow
// traversal gets no geom_mx.
template <bool A, bool MXA, bool B>
__device__ __forceinline__ void handoff(BlockWalk<A, MXA>& from, BlockWalk<B>& to) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();  // every thread is done with `from`'s shared memory
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_STAGES; ++s) mbar_inval(smem_u32(from.smem + from.lay().bars + 8 * s));
  }
  to.init(to.g, from.smem);
}

// Launch `kernel` (a ray kernel's instantiation) on a grid of `blocks`
// blocks of TILE_THREADS with `smem` bytes of dynamic shared memory on
// `stream`, after raising its limit to that -> the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch_walk(Kernel kernel, int blocks, int smem, cudaStream_t stream, Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, TILE_THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Blocks of `kernel` that one multiprocessor holds at once with `smem`
// bytes of dynamic shared memory, after the same raise of its limit as its
// launch; minus the CUDA error if refused.
template <typename Kernel>
int walk_occupancy(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, TILE_THREADS, smem);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace cosig
