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
//     warp). The any hit also applies the tn > max_t skip here. Without
//     the frustum cull (incoherent rays: the trace, the bounce, the shade
//     on a list, the megakernel past depth 0) a pass of more than
//     CULL_GROUP clusters is culled in two levels: a warp tests the union
//     box of each group of CULL_GROUP consecutive clusters (traverse.cuh
//     group_pass, a superset of box_pass on every member, NaN slabs
//     included) and runs its members' slab tests only where some lane
//     enters it, else stores 0 as their ballot words; most bounce rays
//     leave the scene, and a ray that enters few clusters skips most
//     groups. The ballots, the list and every result stay the flat cull's.
//     The union boxes are built with the boxes where the kernel asks at
//     init or the pass culls without the frustum (stage_boxes), else at
//     the first two-level cull of the boxes staged (stage_groups), so the
//     kernels that only run the frustum cull carry none of that code. The
//     block counts the box tests its warps run (group and cluster, per lane
//     walking as the pass starts; in frustum mode the candidates, per ray in
//     the block's hull), which the trace kernel, the fission primary and the
//     shade kernel add to counters of their launch (add_counts,
//     add_shadow_counts).
//  2. List. Warp 0 compacts the clusters that some lane enters into a list
//     in ascending cluster order: the closest-hit fold does not need the
//     order (the (t, gid) winner is order-free), but the any hit must stop
//     at the occluder a walk in cluster order stops at (the plain
//     kernel_core.traverse, whose WORK counts its pair tests so). Step 0
//     passes a superset of the boxes some lane enters, so the list is the
//     flat walk's, cluster for cluster. The compacted closest hit then walks
//     it near-first (closest_pairs, below).
//  3. Walk. Thread 0 keeps the next RING_STAGES listed clusters' rows in
//     flight, K x 144 contiguous bytes each, one mbarrier per ring slot.
//     A warp whose ballot word is 0 skips the cluster; otherwise its lanes
//     read each row from shared memory as 16-byte broadcasts and the lanes
//     that entered the box run pair_test on it. The padding-row break
//     stays. An any-hit lane stops at its first occluder and the block
//     stops when __syncthreads_or finds no lane still walking; copies
//     still in flight are waited for, so the ring is idle between walks.
//
// Slots (BlockWalk<SB, MX, true>, "PC"; walk_layout.h): a slot holds
// `rows` rows, fewer than k, and a listed cluster is copied and walked in
// slot_pieces(k, rows) consecutive pieces over the same ring, in order; a
// unit of the walk is one piece, so the any hit checks for a ray still
// walking after every piece. The padding-row break ends a piece at its
// first padding row, and the later pieces of that cluster, all padding,
// at their first (they are copied all the same). The launches take the
// builds with slots where k > SLOT_MAX, so every k a cluster set may have
// fits a block (the ring of whole clusters, 3 x k x 144 B, outgrew the
// H100's 232,448 B past k = 503), and keep the builds without (one piece
// a cluster, the code they had) up to k = 128. Shadow walks always have
// slots: no more rows than the main walk's, so their layout is never
// larger than the block's (handoff). The compacted walks (closest_pairs
// and any_pairs, below) go in slots of TRACE_SLOT rows: the closest hit of
// the trace and of the fission primary, the any hit of the exact shade.
//
// A slot's mbarrier completes one phase per copy; copy q (counted over the
// block's whole life, `seq`) uses slot q % RING_STAGES and waits on parity
// (q / RING_STAGES) & 1. A slot is refilled only after the block barrier
// that ends the visit of its previous piece, so no thread can fall two
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
#include "walk_layout.h"

namespace cosig {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr unsigned NO_ENTRY = 0xffffffffu;  // a box no ray of the block entered (entry_key)
static_assert(ROW_BYTES == GEOM_COMPS * 4, "a ring row is one geometry row");
static_assert(sizeof(Hull) == HULL_BYTES, "walk_layout.h sizes the hull");
static_assert(TRACE_SLOT == 32, "the compacted walk finds a slot's real rows with one ballot");
static_assert(32 % CULL_GROUP == 0 && TILE_C % CULL_GROUP == 0,
              "a group's boxes are consecutive lanes of one warp, and groups tile a pass");

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
// (PERF.md). MX: the tensor-core form of the pair test (see the top). PC:
// slots of `rows` rows, a cluster in pieces (see the top); without PC a
// slot is one cluster, and every piece expression below folds to it.
template <bool SB, bool MX = false, bool PC = false>
struct BlockWalk {
  Geometry g;
  unsigned char* smem;  // dynamic shared memory, laid out by tile_layout(slot(), MX)
  unsigned seq;  // bulk copies issued so far; the same in every thread
  bool sb_open;  // some ray of the block enters the current superblock; the same in every thread
  bool grouped;  // groups() holds the staged boxes' union boxes; the same in every thread
  bool mx_any;  // MX: the any hit takes the tensor-core form too (full mode); the same in every thread
  int rows;  // PC: a slot's rows (slot_rows of k), set before init

  // Every thread of the block, once, before the first walk. `groups` (a
  // constant of the kernel): its walks cull without the frustum cull, so
  // the union boxes of the two-level cull are built with the boxes.
  __device__ __forceinline__ void init(const Geometry& geo, unsigned char* base,
                                       bool groups = false) {
    g = geo;
    smem = base;
    seq = 0;
    sb_open = true;
    grouped = false;
    mx_any = false;
    if (threadIdx.x == 0) {
      for (int s = 0; s < RING_STAGES; ++s) mbar_init(smem_u32(smem + lay().bars + 8 * s), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      // The block's counts: box tests, pairs run, shadow rays cast.
      count()[COUNT_BOX_TESTS] = count()[COUNT_PAIRS_RUN] = count()[COUNT_SHADOW_RAYS] = 0;
    }
    if (g.n_clusters <= TILE_C) stage_boxes(0, groups);
    __syncthreads();
  }

  // A slot's rows, and the pieces of a cluster.
  __device__ __forceinline__ int slot() const { return PC ? rows : g.k; }
  __device__ __forceinline__ int pieces() const { return PC ? slot_pieces(g.k, rows) : 1; }
  __device__ __forceinline__ TileLayout lay() const { return tile_layout(slot(), MX); }
  __device__ __forceinline__ int lane() const { return threadIdx.x & 31; }
  __device__ __forceinline__ int warp() const { return threadIdx.x >> 5; }

  __device__ __forceinline__ float4* boxes() const {
    return reinterpret_cast<float4*>(smem + lay().boxes);
  }
  __device__ __forceinline__ float4* groups() const {
    return reinterpret_cast<float4*>(smem + lay().groups);
  }
  // Box i of a [i][8] array in shared memory (boxes() or groups()).
  static __device__ __forceinline__ Box box_at(const float4* bx, int i) {
    const float4 lo = bx[2 * i], hi = bx[2 * i + 1];
    Box b;
    b.b0 = lo.x;
    b.b1 = lo.y;
    b.b2 = lo.z;
    b.b3 = hi.x;
    b.b4 = hi.y;
    b.b5 = hi.z;
    return b;
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
  // The rows in the slot of copy q.
  __device__ __forceinline__ const float4* ring_rows(unsigned q) const {
    return reinterpret_cast<const float4*>(smem + lay().ring +
                                           (q % RING_STAGES) * ((unsigned)slot() * ROW_BYTES));
  }

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
    // Every thread is done with the previous hull; the rays in this one.
    const int rays_in = __syncthreads_count(in);
    if (threadIdx.x == 0) count()[COUNT_HULL_RAYS] = rays_in;
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

  // Boxes c0 .. c0 + TILE_C - 1 of aabb [8, c_pad] into [c][8]; with
  // `groups`, the union boxes of the two-level cull too (union_group). A
  // box's first spare word holds its entry key (entry_key), NO_ENTRY here.
  __device__ __forceinline__ void stage_boxes(int c0, bool groups) {
    const int n = min(TILE_C, g.n_clusters - c0);
    float4* bx = boxes();
    const float none = __uint_as_float(NO_ENTRY);
    if (!groups) {
      for (int c = threadIdx.x; c < n; c += TILE_THREADS) {
        const Box b = box_ldg(g, c0 + c);
        bx[2 * c] = make_float4(b.b0, b.b1, b.b2, none);
        bx[2 * c + 1] = make_float4(b.b3, b.b4, b.b5, 0.0f);
      }
    } else {
      for (int base = 0; base < n; base += TILE_THREADS) {  // the same trips in every thread
        const int c = base + threadIdx.x;
        Box b = no_box();
        if (c < n) {
          b = box_ldg(g, c0 + c);
          bx[2 * c] = make_float4(b.b0, b.b1, b.b2, none);
          bx[2 * c + 1] = make_float4(b.b3, b.b4, b.b5, 0.0f);
        }
        union_group(b, c, n);
      }
    }
    grouped = groups;
  }

  // Every thread, at a two-level cull of n staged boxes whose union boxes
  // were not built with them (a walk whose kernel did not ask at init, or a
  // shadow walk after its handoff): build them from the staged boxes.
  __device__ __forceinline__ void stage_groups(int n) {
    for (int base = 0; base < n; base += TILE_THREADS) {  // the same trips in every thread
      const int c = base + threadIdx.x;
      union_group(c < n ? box_at(boxes(), c) : no_box(), c, n);
    }
    __syncthreads();
    grouped = true;
  }

  // The lanes of a warp holding boxes c (of n; no_box() past them): the
  // union box of each group of CULL_GROUP of them (the last one short) into
  // groups() [c / CULL_GROUP][8], NaN-propagating minima and maxima over the
  // group's consecutive lanes by shuffles, so the padding columns past
  // n_clusters are left out.
  __device__ __forceinline__ void union_group(const Box& b, int c, int n) {
    float v[6] = {b.b0, b.b1, b.b2, b.b3, b.b4, b.b5};
#pragma unroll
    for (int off = 1; off < CULL_GROUP; off <<= 1) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float w = __shfl_xor_sync(FULL_MASK, v[i], off);
        v[i] = i < 3 ? slab_min(v[i], w) : slab_max(v[i], w);
      }
    }
    if (c < n && c % CULL_GROUP == 0) {
      groups()[2 * (c / CULL_GROUP)] = make_float4(v[0], v[1], v[2], 0.0f);
      groups()[2 * (c / CULL_GROUP) + 1] = make_float4(v[3], v[4], v[5], 0.0f);
    }
  }

  // The box no ray enters and every union leaves out: +inf minima, -inf maxima.
  static __device__ __forceinline__ Box no_box() {
    Box b;
    b.b0 = b.b1 = b.b2 = INFINITY;
    b.b3 = b.b4 = b.b5 = -INFINITY;
    return b;
  }

  // Thread 0: copy piece p of cluster c's rows into the slot of copy q.
  __device__ __forceinline__ void issue(unsigned q, int c, int p = 0) {
    const unsigned slot_id = q % RING_STAGES;
    const unsigned stride = (unsigned)slot() * ROW_BYTES;
    const unsigned bytes = (unsigned)(PC ? piece_rows(g.k, rows, p) : g.k) * ROW_BYTES;
    bulk_copy(smem_u32(smem + lay().ring + slot_id * stride),
              g.geom + ((size_t)c * g.k + (size_t)(PC ? piece_first(p, rows) : 0)) * GEOM_COMPS,
              bytes, smem_u32(smem + lay().bars + 8 * slot_id));
  }

  // Thread 0: copy unit u of a pass whose list is lst (cluster u / pieces,
  // piece u % pieces) into the slot of copy q.
  __device__ __forceinline__ void issue_unit(unsigned q, int c0, const int* lst, int u) {
    if constexpr (PC) {
      const int j = u / pieces();
      issue(q, c0 + lst[j], u - j * pieces());
    } else {
      issue(q, c0 + lst[u]);
    }
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
  // ANY: an any hit's, whose per-warp walk (exact, no slots) counts its
  // shadow rays cast in frustum mode here: the rays in its first pass's hull.
  template <bool ANY>
  __device__ __forceinline__ int prefilter(const Ray& r, bool enter, float max_t, bool frustum,
                                           int c0, int n) {
    // A block with no ray to walk skips the pass (walking can only stop, so
    // a later pass has none either); without the frustum cull it is left to
    // the superblock test and the per-warp vote below, as in the flat walk.
    if (frustum && !block_hull(r, enter, max_t)) return -1;
    if constexpr (ANY && !PC && !MX) {  // thread 0 wrote the hull's rays
      if (frustum && c0 == 0 && threadIdx.x == 0) count()[COUNT_SHADOW_RAYS] += count()[COUNT_HULL_RAYS];
    }
    if (SB && c0 % SB_CLUSTERS == 0) {
      const Box sb = sb_box_ldg(g, c0 / SB_CLUSTERS);
      sb_open = frustum ? frustum_pass(*hull(), sb)
                        : __syncthreads_or(enter && ray_enters(r, max_t, sb));
    }
    if (SB && !sb_open) return -1;
    if (g.n_clusters > TILE_C) {
      __syncthreads();  // the previous pass has read its boxes
      stage_boxes(c0, !frustum);
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
      if (c < n) f = frustum_pass(h, box_at(bx, c));
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
      if (lane() == 0) {
        count()[1] = m;
        count()[COUNT_BOX_TESTS] += m * count()[COUNT_HULL_RAYS];  // each ray in tests each candidate
      }
    }
    __syncthreads();
    return count()[1];
  }

  // Step 1 on box c of the pass: the slab test of every lane's ray, the
  // warp's ballot of the lanes with `enter` set that pass it stored. KEYS
  // (the compacted closest hit): also the warp's least entry distance
  // max(tn, 0) of those lanes (a NaN tn as 0) into the box's entry key, a
  // shared-memory minimum over the warps.
  template <bool ANY, bool KEYS = false>
  __device__ __forceinline__ void slab_ballot(const Ray& r, bool enter, float max_t, int c) {
    float tn;
    bool pass = box_pass(box_at(boxes(), c), r, tn);
    if (ANY) pass = pass && !(tn > max_t);
    const unsigned w = __ballot_sync(FULL_MASK, enter && pass);
    if (lane() == 0) ballots()[c * TILE_WARPS + warp()] = w;
    if constexpr (KEYS) {
      if (w != 0u) {  // the same in every lane
        const unsigned near = __reduce_min_sync(
            FULL_MASK, enter && pass ? __float_as_uint(tn > 0.0f ? tn : 0.0f) : NO_ENTRY);
        if (lane() == 0) atomicMin(entry_key(c), near);
      }
    }
  }

  // Cluster c's entry key in the pass: the bits of the least max(tn, 0)
  // over the block's rays that enter its box (non-negative floats order as
  // their bits), NO_ENTRY where none has; the first spare word of its
  // staged box.
  __device__ __forceinline__ unsigned* entry_key(int c) const {
    return reinterpret_cast<unsigned*>(&boxes()[2 * c].w);
  }

  // Steps 0 to 2 on clusters c0 .. c0 + n - 1 of the rays with `enter`
  // set -> the list length (the same in every thread). Without the frustum
  // cull (incoherent rays) a pass of more than CULL_GROUP clusters is culled
  // in two levels: a warp tests the union box of each group first
  // (group_pass, exact) and runs the members' slab tests only where some
  // lane enters it, else stores 0 as their ballots. Each warp also adds the
  // box tests it runs (group and cluster), once per lane with `enter` set,
  // to the block's count (count()[COUNT_BOX_TESTS], add_counts); in frustum
  // mode prefilter adds the candidates' for the rays in the block's hull.
  // KEYS: gather the listed clusters' entry keys too (slab_ballot).
  template <bool ANY, bool KEYS = false>
  __device__ __forceinline__ int cull(const Ray& r, bool enter, float max_t, bool frustum,
                                      int c0, int n) {
    const int m0 = prefilter<ANY>(r, enter, max_t, frustum, c0, n);
    if (m0 < 0) return 0;
    const int* cand = reinterpret_cast<const int*>(smem + lay().cand);
    const bool two_level = !frustum && m0 > CULL_GROUP;
    if (two_level && !grouped) stage_groups(m0);
    // 1. The per-ray slab test of each candidate.
    unsigned* bal = ballots();
    if (__any_sync(FULL_MASK, enter)) {
      if (frustum) {
        for (int j = 0; j < m0; ++j) slab_ballot<ANY, KEYS>(r, enter, max_t, cand[j]);
      } else {
        int tests = m0;
        if (two_level) {
          const unsigned odd = odd_axes(r);
          tests = 0;
          for (int c = 0; c < m0; c += CULL_GROUP) {
            const int end = min(c + CULL_GROUP, m0);
            const bool in =
                enter && group_pass(box_at(groups(), c / CULL_GROUP), r, odd, ANY, max_t);
            ++tests;
            if (__any_sync(FULL_MASK, in)) {
              tests += end - c;
              for (int j = c; j < end; ++j) slab_ballot<ANY, KEYS>(r, enter, max_t, j);
            } else if (c + lane() < end) {
              bal[(c + lane()) * TILE_WARPS + warp()] = 0u;
            }
          }
        } else {
          for (int j = 0; j < m0; ++j) slab_ballot<ANY, KEYS>(r, enter, max_t, j);
        }
        const int lanes = __popc(__ballot_sync(FULL_MASK, enter));
        if (lane() == 0) atomicAdd(count() + COUNT_BOX_TESTS, tests * lanes);
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

  // Thread 0, after a closest hit: add the block's counts since init to
  // out[0 .. 2]: its box tests (every cull's count lands before its step-1
  // barrier), and the pairs its closest hit runs and prunes: the compacted
  // walk's region's count words (thread 0's own adds), or the per-warp
  // walk's pairs run (each warp's add lands before the barrier that ends
  // its cluster), which prunes none. The tensor-core walk counts no pairs.
  __device__ __forceinline__ void add_counts(unsigned long long* out) const {
    if (threadIdx.x == 0) {
      atomicAdd(out, (unsigned long long)count()[COUNT_BOX_TESTS]);
      if constexpr (PC && !MX) {
        const int* pc = pair_counts();
        atomicAdd(out + 1, (unsigned long long)pc[PAIRS_RUN]);
        atomicAdd(out + 2, (unsigned long long)pc[PAIRS_PRUNED]);
      } else if constexpr (!MX) {
        atomicAdd(out + 1, (unsigned long long)count()[COUNT_PAIRS_RUN]);
      }
    }
  }

  // Thread 0, after a shade's any hits: add the block's counts since init
  // to out[0 .. 2]: its box tests, the pairs its any hits run (the per-warp
  // walk's tests up to each lane's first occluder, or the compacted walk's
  // listed pairs) and the shadow rays it casts (the compacted walk's first
  // barrier counts them, the per-warp walk's first frustum hull; both exact
  // walks' forms in the shade kernel). The tensor-core form counts its box
  // tests only. Every count lands before a block barrier of the walk. Where
  // each count sits was chosen by ptxas: the shadow rays counted in the
  // per-warp any hit's own code, or the frustum cull's box tests counted per
  // warp, spilled 24-40 bytes more in the shade over every ray (PERF.md).
  __device__ __forceinline__ void add_shadow_counts(unsigned long long* out) const {
    if (threadIdx.x == 0) {
      atomicAdd(out, (unsigned long long)count()[COUNT_BOX_TESTS]);
      atomicAdd(out + 1, (unsigned long long)count()[COUNT_PAIRS_RUN]);
      atomicAdd(out + 2, (unsigned long long)count()[COUNT_SHADOW_RAYS]);
    }
  }

  // The compacted closest hit's count words (PAIR_COUNTS of its region).
  __device__ __forceinline__ int* pair_counts() const {
    return reinterpret_cast<int*>(smem + tile_layout(rows, false, true).pairs + PAIR_COUNTS);
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
    const int np = pieces();
    sb_open = true;
    for (int c0 = 0; c0 < g.n_clusters; c0 += TILE_C) {
      const int n = min(TILE_C, g.n_clusters - c0);
      const int m = cull<false>(r, active, INFINITY, frustum, c0, n) * np;  // units
      const int* lst = list();
      const unsigned* bal = ballots();
      const unsigned base = seq;
      if (threadIdx.x == 0) {
        for (int j = 0; j < min(RING_STAGES, m); ++j) issue_unit(base + j, c0, lst, j);
      }
      for (int j = 0; j < m; ++j) {
        const unsigned q = base + j;
        const int jc = PC ? j / np : j;  // the unit's cluster in the list, and its piece
        const int p = j - jc * np;
        const int c = lst[jc];
        const unsigned w = bal[c * TILE_WARPS + warp()];
        const int kr = PC ? piece_rows(g.k, rows, p) : g.k;
        const int row0 = (c0 + c) * g.k + (PC ? piece_first(p, rows) : 0);
        if constexpr (MX) {
          // Every thread: the block splits the rows and issues the products.
          wait_copy(q);
          mx_closest_cluster(reinterpret_cast<const float*>(ring_rows(q)), kr, row0, w, mx,
                             mx_tiles(), bm);
        } else if (w != 0u) {
          wait_copy(q);
          const bool mine = (w >> lane()) & 1u;
          const float4* rows_q = ring_rows(q);
          int k = 0;
          for (; k < kr; ++k) {
            const float4* pr = rows_q + 9 * k;
            const float gid = pr[8].w;
            if (gid >= GID_PAD) break;  // padding rows: all-zero constants, never valid
            if (mine) fold_pair(b, row_smem(pr), gid, r, row0 + k);
          }
          if (lane() == 0) atomicAdd(count() + COUNT_PAIRS_RUN, __popc(w) * k);  // pairs run
        }
        __syncthreads();  // every warp is done with this slot
        if (threadIdx.x == 0 && j + RING_STAGES < m) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue_unit(q + RING_STAGES, c0, lst, j + RING_STAGES);
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
    const int np = pieces();
    sb_open = true;
    for (int c0 = 0; c0 < g.n_clusters; c0 += TILE_C) {
      if (c0 > 0 && !__syncthreads_or(walking)) break;
      const int n = min(TILE_C, g.n_clusters - c0);
      const int m = cull<true>(r, walking, max_t, frustum, c0, n) * np;  // units
      const int* lst = list();
      const unsigned* bal = ballots();
      const unsigned base = seq;
      const int first = min(RING_STAGES, m);
      if (threadIdx.x == 0) {
        for (int j = 0; j < first; ++j) issue_unit(base + j, c0, lst, j);
      }
      int issued = first, j = 0;
      while (j < m) {
        const unsigned q = base + j;
        const int jc = PC ? j / np : j;  // the unit's cluster in the list, and its piece
        const int c = lst[jc];
        const int kr = PC ? piece_rows(g.k, rows, j - jc * np) : g.k;
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
            mx_any_cluster(reinterpret_cast<const float*>(ring_rows(q)), kr, w, mx, mt,
                           mx_tiles(), walking);
          }
        }
        if (w != 0u && !mx_walk) {
          // Pairs run: each lane's tests, one add a cluster (counted from the
          // rows run after the loop, or by an add at each occluder, the walk
          // timed 6-8 % slower at glass_sphere; PERF.md).
          bool mine = (w >> lane()) & 1u;
          int tested = 0;
          const float4* rows_q = ring_rows(q);
          for (int k = 0; k < kr; ++k) {
            const float4* pr = rows_q + 9 * k;
            if (pr[8].w >= GID_PAD) break;
            if (mine) {
              ++tested;
              float t, vb, vc, inv_s;
              if (pair_test(row_smem(pr), r, t, vb, vc, inv_s) && t <= max_t) {
                mine = false;
                walking = false;
              }
            }
            if (__ballot_sync(FULL_MASK, mine) == 0u) break;
          }
          const int run = __reduce_add_sync(FULL_MASK, tested);
          if (lane() == 0) atomicAdd(count() + COUNT_PAIRS_RUN, run);
        }
        ++j;
        if (!__syncthreads_or(walking)) break;  // also: every warp is done with this slot
        if (threadIdx.x == 0 && issued < m) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue_unit(base + issued, c0, lst, issued);
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

  // A compacted walk's ray operands into the region's [PAIR_OPERANDS][128]:
  // the values pair_test reads of the ray (make_ray's).
  __device__ __forceinline__ void stage_ops(float* ops, const Ray& r) const {
    const float op[PAIR_OPERANDS] = {r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.wx, r.wy, r.wz};
#pragma unroll
    for (int i = 0; i < PAIR_OPERANDS; ++i) ops[i * TILE_THREADS + threadIdx.x] = op[i];
  }

  // Ray `ray`'s operands from the region, for pair_test.
  __device__ __forceinline__ Ray staged_ray(const float* ops, int ray) const {
    Ray x;
    x.ox = ops[0 * TILE_THREADS + ray];
    x.oy = ops[1 * TILE_THREADS + ray];
    x.oz = ops[2 * TILE_THREADS + ray];
    x.dx = ops[3 * TILE_THREADS + ray];
    x.dy = ops[4 * TILE_THREADS + ray];
    x.dz = ops[5 * TILE_THREADS + ray];
    x.wx = ops[6 * TILE_THREADS + ray];
    x.wy = ops[7 * TILE_THREADS + ray];
    x.wz = ops[8 * TILE_THREADS + ray];
    return x;
  }

  // The closest hit of a compacted walk (exact, PC, slots of TRACE_SLOT
  // rows): the trace's, and the fission primary's with `frustum` (the
  // frustum pre-cull, as closest()). Near-first: each pass's list is walked
  // in the order of its clusters' entry keys (the least max(tn, 0) over the
  // block's rays that enter the box, gathered by the cull; ties by cluster
  // index), ranked in shared memory (near_first). Distance-pruned: at each
  // piece, a ray that entered the box runs box_pass on it again and skips
  // the piece where its entry lies past its key's t by more than prunes()'s
  // margin, which no pair of the piece can beat; the key is the ray's after
  // every earlier piece, whose pairs are all folded by the barrier before,
  // so the order of the list decides only how much is pruned. The pair loop
  // is compacted: the rays of the piece that are not pruned are listed
  // (each warp adds its count to the piece's counter, which the first
  // barrier publishes) and the n x rows (ray, row) pairs spread over the
  // block's threads (walk_layout.h pair_first / pair_next: a warp reads one
  // row as a broadcast, its lanes' rays' operands from `pairs`
  // [PAIR_OPERANDS][128], staged once per walk). A pair that beats the key
  // its thread reads (stale or not: it only lets more through) folds
  // hit_key(t, gid) into its ray's key with a 64-bit atomicMin; the key's
  // minimum is the (t, gid) winner of the per-ray fold, which depends on
  // neither the order of the clusters nor that of the list. Then each ray
  // whose key fell in this piece finds the winning row by its gid among the
  // slot's rows and runs pair_test on it again, for the row and the
  // barycentrics (the same operands, so the same bits). Thread 0 counts the
  // pairs run and pruned (pair_counts(), for add_counts).
  // The region: PAIR_BYTES of shared memory past the walk's layout
  // (trace_smem). Two block barriers a piece: after the list (and the
  // previous piece's owners), after the pairs; one more a pass to rank a
  // list of two clusters or more.
  __device__ __forceinline__ Hit closest_pairs(float ox, float oy, float oz, float dx, float dy,
                                               float dz, bool active, bool frustum) {
    static_assert(PC && !MX, "the compacted walk is exact, in slots");
    const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
    unsigned char* pairs = smem + tile_layout(rows, false, true).pairs;
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(pairs + PAIR_KEYS);
    float* ops = reinterpret_cast<float*>(pairs + PAIR_OPS);
    int* in_box = reinterpret_cast<int*>(pairs + PAIR_LIST);
    int* pc = pair_counts();
    const int tid = threadIdx.x;
    const unsigned long long no_key = hit_key(__float_as_uint(INF), (unsigned)GID_PAD);
    keys[tid] = no_key;
    if (tid < PAIR_COUNT_WORDS) pc[tid] = 0;
    stage_ops(ops, r);
    // cull() holds block barriers before any thread reads these.
    Best b = no_hit();
    unsigned long long own = no_key;  // the ray's key after the last piece it ran
    const int np = pieces();
    sb_open = true;
    for (int c0 = 0; c0 < g.n_clusters; c0 += TILE_C) {
      const int n = min(TILE_C, g.n_clusters - c0);
      const int m = near_first(cull<false, true>(r, active, INFINITY, frustum, c0, n)) * np;
      const int* lst = m > np ? reinterpret_cast<const int*>(smem + lay().cand) : list();
      const unsigned* bal = ballots();
      const unsigned base = seq;
      if (tid == 0) {
        for (int j = 0; j < min(RING_STAGES, m); ++j) issue_unit(base + j, c0, lst, j);
      }
      bool entered = false;  // the ray ran the previous unit's pairs
      int kr_prev = 0, row0_prev = 0;  // the previous unit's rows and first row
      for (int j = 0; j < m; ++j) {
        const unsigned q = base + j;
        const int jc = j / np;
        const int p = j - jc * np;
        const int c = lst[jc];
        const int kr = piece_rows(g.k, rows, p);
        const int row0 = (c0 + c) * g.k + piece_first(p, rows);
        const uint4 w4 = *reinterpret_cast<const uint4*>(bal + c * TILE_WARPS);
        const unsigned wv = warp() == 0 ? w4.x : warp() == 1 ? w4.y : warp() == 2 ? w4.z : w4.w;
        const int n_box = __popc(w4.x) + __popc(w4.y) + __popc(w4.z) + __popc(w4.w);
        wait_copy(q);
        const float4* rows_q = ring_rows(q);
        // The previous piece's owners; the key after every earlier piece.
        const unsigned long long key = keys[tid];
        if (entered) own = resolve(key, own, r, b, ring_rows(q - 1), kr_prev, row0_prev);
        // This piece's rays: those in the box that it does not prune.
        bool in = (wv >> lane()) & 1u;
        if (wv != 0u) {
          const float4* pr = rows_q + 9 * lane();
          const float l1 = lane() < kr ? normal_l1(pr[0].w, pr[1].x, pr[1].y) : 0.0f;
          const float n1 = __uint_as_float(__reduce_max_sync(FULL_MASK, __float_as_uint(l1)));
          if (in) {
            const Box bx = box_at(boxes(), c);
            float tn;
            box_pass(bx, r, tn);
            in = !prunes(tn, __uint_as_float((unsigned)(key >> 32)), r, bx, n1);
          }
        }
        entered = in;
        const unsigned mine = __ballot_sync(FULL_MASK, in);
        int at = 0;
        if (lane() == 0 && mine != 0u) at = atomicAdd(pc + PAIRS_IN_BOX + (q & 1u), __popc(mine));
        at = __shfl_sync(FULL_MASK, at, 0);
        if (in) in_box[at + __popc(mine & ((1u << lane()) - 1u))] = tid;
        // Real rows of the piece: before its first padding row.
        const unsigned pad =
            __ballot_sync(FULL_MASK, lane() < kr && rows_q[9 * lane() + 8].w >= GID_PAD);
        const int real = pad ? __ffs(pad) - 1 : kr;
        __syncthreads();  // the list is written; the previous piece's owners are done
        const int n_in = pc[PAIRS_IN_BOX + (q & 1u)];
        if (tid == 0) {
          pc[PAIRS_IN_BOX + ((q + 1u) & 1u)] = 0;  // the next piece's, read before the last barrier
          pc[PAIRS_RUN] += n_in * real;
          pc[PAIRS_PRUNED] += (n_box - n_in) * real;
          if (j >= 1 && j - 1 + RING_STAGES < m) {
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            issue_unit(q - 1 + RING_STAGES, c0, lst, j - 1 + RING_STAGES);
          }
        }
        const int total = n_in * real;
        if (tid < total) {
          PairCursor cur = pair_first(tid, n_in);
          for (int pp = tid; pp < total; pp += TILE_THREADS) {
            const float4* pr = rows_q + 9 * cur.row;
            const int ray = in_box[cur.ray];
            float t, vb, vc, inv_s;
            if (pair_test(row_smem(pr), staged_ray(ops, ray), t, vb, vc, inv_s)) {
              const unsigned long long key = hit_key(__float_as_uint(t), (unsigned)pr[8].w);
              if (key < *(volatile unsigned long long*)(keys + ray)) atomicMin(keys + ray, key);
            }
            pair_next(cur, n_in);
          }
        }
        __syncthreads();  // every pair of this piece is folded
        kr_prev = kr;
        row0_prev = row0;
        if (j + 1 == m) {
          if (entered) own = resolve(keys[tid], own, r, b, rows_q, kr, row0);
          __syncthreads();  // the owners are done with the last slot
        }
      }
      seq = base + m;
    }
    return finish_closest(g, r, b);
  }

  // Every thread, after a cull<false, true> that listed ml clusters -> ml:
  // with two or more, rank them near-first (by entry key, then by list
  // position, which is cluster order) into the frustum candidates' array,
  // dead after the list is built (the walk then reads it there), then a
  // block barrier. Any order of the list gives the same hits (the pruning
  // is exact); this one makes the pruning engage most.
  __device__ __forceinline__ int near_first(int ml) {
    if (ml > 1) {
      const int* lst = list();
      int* ranked = reinterpret_cast<int*>(smem + lay().cand);
      for (int i = threadIdx.x; i < ml; i += TILE_THREADS) {
        const int ci = lst[i];
        const unsigned ki = *entry_key(ci);
        int rank = 0;
        for (int jj = 0; jj < ml; ++jj) {
          const unsigned kj = *entry_key(lst[jj]);
          rank += (kj < ki || (kj == ki && jj < i)) ? 1 : 0;
        }
        ranked[rank] = ci;
      }
      __syncthreads();  // ranked
    }
    return ml;
  }

  // A ray's owner after a piece it entered (its slot rows_q: kr rows from
  // flat row row0): when the ray's key fell below `own`, the winner is the
  // piece's row with the key's gid (gids are unique); pair_test on it
  // again gives the barycentrics -> the new own key.
  __device__ __forceinline__ unsigned long long resolve(unsigned long long key,
                                                        unsigned long long own, const Ray& r,
                                                        Best& b, const float4* rows_q, int kr,
                                                        int row0) {
    if (key >= own) return own;
    const float gid = (float)(unsigned)(key & 0xffffffffull);
    for (int k = 0; k < kr; ++k) {
      const float4* pr = rows_q + 9 * k;
      if (pr[8].w != gid) continue;
      float t, vb, vc, inv_s;
      pair_test(row_smem(pr), r, t, vb, vc, inv_s);
      b.t = t;
      b.gid = gid;
      b.row = row0 + k;
      b.u = vb * inv_s;
      b.v = vc * inv_s;
      break;
    }
    return key;
  }

  // The any hit of a compacted walk (exact, PC, slots of TRACE_SLOT rows;
  // the exact shade's), with any()'s cull, tn > max_t skip and `frustum`,
  // its pair loop compacted as closest_pairs': for each listed piece, the
  // rays that entered the cluster's box and still walk are listed (a prefix
  // over the 4 warps' masks) and their n x rows (ray, row) pairs spread over
  // the block's threads. A pair whose ray is flagged already is skipped (a
  // stale read only lets more tests through); an occluding pair (pair_test
  // valid, t <= the ray's max_t) flags its ray, every writer with the same
  // value, so no atomic. A ray is occluded iff some row of a box it enters
  // occludes it, or a primitive does (cosig_tpu/ops/kernel_core.py:302-303),
  // whatever the order of the tests and however far it walks past its first
  // occluder, so the result is any()'s. After each piece every thread reads
  // every warp's walking lanes from the flags (4 loads and ballots; the same
  // in every thread), and the block stops when none walks. Two block
  // barriers a piece: after the list, after the pairs. The region:
  // closest_pairs', a flag and max_t in place of the key (PAIR_FLAGS,
  // PAIR_MAX_T). Every thread of the block calls it, once per shadow ray.
  __device__ __forceinline__ bool any_pairs(float ox, float oy, float oz, float dx, float dy,
                                            float dz, float max_t, bool active, bool frustum) {
    static_assert(PC && !MX, "the compacted walk is exact, in slots");
    const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
    unsigned char* pairs = smem + tile_layout(rows, false, true).pairs;
    int* flags = reinterpret_cast<int*>(pairs + PAIR_FLAGS);  // 1: occluded or not walking
    float* mts = reinterpret_cast<float*>(pairs + PAIR_MAX_T);
    float* ops = reinterpret_cast<float*>(pairs + PAIR_OPS);
    int* in_box = reinterpret_cast<int*>(pairs + PAIR_LIST);
    const int tid = threadIdx.x;
    // Every thread is done with the previous walk's region; the shadow rays cast.
    const int cast = __syncthreads_count(active);
    if (tid == 0) count()[COUNT_SHADOW_RAYS] += cast;
    flags[tid] = active ? 0 : 1;
    mts[tid] = max_t;
    stage_ops(ops, r);
    // cull() holds block barriers before any thread reads these.
    bool walking = active;  // active and no occluder found yet
    const int np = pieces();
    sb_open = true;
    for (int c0 = 0; c0 < g.n_clusters; c0 += TILE_C) {
      if (c0 > 0 && !__syncthreads_or(walking)) break;
      const int n = min(TILE_C, g.n_clusters - c0);
      const int m = cull<true>(r, walking, max_t, frustum, c0, n) * np;  // units
      const int* lst = list();
      const unsigned* bal = ballots();
      const unsigned base = seq;
      const int first = min(RING_STAGES, m);
      if (tid == 0) {
        for (int j = 0; j < first; ++j) issue_unit(base + j, c0, lst, j);
      }
      int issued = first, j = 0;
      while (j < m) {
        // Every warp's lanes still walking.
        unsigned walk_w[TILE_WARPS];
        unsigned some = 0u;
#pragma unroll
        for (int w = 0; w < TILE_WARPS; ++w) {
          walk_w[w] = __ballot_sync(FULL_MASK, flags[w * 32 + lane()] == 0);
          some |= walk_w[w];
        }
        if (some == 0u) break;  // the same in every thread
        const unsigned q = base + j;
        const int jc = j / np;
        const int c = lst[jc];
        const int kr = piece_rows(g.k, rows, j - jc * np);
        const uint4 w4 = *reinterpret_cast<const uint4*>(bal + c * TILE_WARPS);
        const unsigned wv[TILE_WARPS] = {w4.x & walk_w[0], w4.y & walk_w[1], w4.z & walk_w[2],
                                         w4.w & walk_w[3]};
        wait_copy(q);
        const float4* rows_q = ring_rows(q);
        // The list of this piece's rays.
        int n_in = 0, at = 0;
        unsigned mine = 0u;  // this warp's lanes in the list
#pragma unroll
        for (int w = 0; w < TILE_WARPS; ++w) {
          if (w == warp()) {
            at = n_in;
            mine = wv[w];
          }
          n_in += __popc(wv[w]);
        }
        if ((mine >> lane()) & 1u) in_box[at + __popc(mine & ((1u << lane()) - 1u))] = tid;
        // Real rows of the piece: before its first padding row.
        const unsigned pad =
            __ballot_sync(FULL_MASK, lane() < kr && rows_q[9 * lane() + 8].w >= GID_PAD);
        const int real = pad ? __ffs(pad) - 1 : kr;
        __syncthreads();  // the list is written; every thread has read the flags
        const int total = n_in * real;
        if (tid == 0) count()[COUNT_PAIRS_RUN] += total;  // the pairs listed
        if (tid < total) {
          PairCursor cur = pair_first(tid, n_in);
          for (int pp = tid; pp < total; pp += TILE_THREADS) {
            const int ray = in_box[cur.ray];
            if (*(volatile int*)(flags + ray) == 0) {
              float t, vb, vc, inv_s;
              if (pair_test(row_smem(rows_q + 9 * cur.row), staged_ray(ops, ray), t, vb, vc,
                            inv_s) &&
                  t <= mts[ray]) {
                flags[ray] = 1;
              }
            }
            pair_next(cur, n_in);
          }
        }
        __syncthreads();  // every pair of this piece is tested; every warp is done with this slot
        ++j;
        if (tid == 0 && issued < m) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue_unit(base + issued, c0, lst, issued);
        }
        if (issued < m) ++issued;
      }
      // Copies still in flight after an early stop land before the ring is reused.
      for (int jj = j; jj < issued; ++jj) wait_copy(base + jj);
      seq = base + issued;
      walking = flags[tid] == 0;  // after the pass's last barrier
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
// own slot) may put ring rows or boxes over them, and `to.init` sets up
// its own; the proxy fence orders the block's generic writes before `to`'s
// bulk copies into the same bytes. `to` walks in slots of no more rows
// than `from`'s (walk_layout.h shadow_rows), so its layout is never the
// larger and the block holds `from`'s (both_smem). `from` may be the
// tensor-core walk (MXA): its B tiles (tile_layout's mxb region, written by
// generic stores, read by wgmma, whose reads completed at each tile's
// wait) are dead after the barrier, and its mbarriers sit at the same
// offsets as the exact layout's, so `to`'s ring may land over both. `to`
// is always exact: the shadow set's walk, as the TPU kernel's shadow
// traversal gets no geom_mx.
template <bool A, bool MXA, bool PCA, bool B>
__device__ __forceinline__ void handoff(BlockWalk<A, MXA, PCA>& from,
                                        BlockWalk<B, false, true>& to) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();  // every thread is done with `from`'s shared memory
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_STAGES; ++s) mbar_inval(smem_u32(from.smem + from.lay().bars + 8 * s));
  }
  to.init(to.g, from.smem);
}

// The build of a ray kernel that a launch over n_clusters clusters of k
// rows takes, from its four builds <SB, PC> = <false, false>, <false,
// true>, <true, false>, <true, true>: the superblock cull where
// superblocks(n_clusters) > 0, slots where k > slot_max (SLOT_MAX; the
// builds without keep whole clusters in the ring, the code they had; the
// exact fission primary and shade over every ray: TRACE_SLOT, forms.cuh).
template <typename Kernel>
Kernel pick_build(int n_clusters, int k, Kernel flat, Kernel flat_pc, Kernel sb, Kernel sb_pc,
                  int slot_max = SLOT_MAX) {
  const bool pc = k > slot_max;
  return superblocks(n_clusters) > 0 ? (pc ? sb_pc : sb) : (pc ? flat_pc : flat);
}

// The four builds of kernel template K for pick_build, its template
// arguments between SB (first) and PC (last) given.
#define COSIG_BUILDS(K, ...)                                                              \
  K<false, __VA_ARGS__, false>, K<false, __VA_ARGS__, true>, K<true, __VA_ARGS__, false>, \
      K<true, __VA_ARGS__, true>

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
