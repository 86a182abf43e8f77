// The wavefront's ray kernels: the primary kernel and the bounce kernel
// of the default render, and the fission form's trace and shade kernels,
// as templates that wavefront.cu (the fused single-set builds, beside the
// compaction) and forms.cu (the fission and shadow-set builds) instantiate
// and launch, one nvcc each.
//
// primary_kernel replaces cosig_tpu/ops/trace_wavefront.py
// _make_primary_kernel (:293-436): per (pixel, AA sample) the camera ray
// (camera.cuh: stratified jitter, perspective or orthographic, motion
// blur), the 16-row state and bounce 0.
//
// bounce_kernel replaces cosig_tpu/ops/trace_wavefront.py
// _make_bounce_kernel (:439-564) in its blocked form (:1013-1129): one
// bounce on each listed ray. Thread j takes list entry j, reads ray
// idx[j]'s rows, bounces it and writes the rows back in place at idx[j],
// so the state keeps pixel order and finalize needs no inverse
// permutation. The grid is sized for all N rays, since the list length
// stays on the device: a block whose first entry is past the list
// returns before it touches shared memory, a test every thread of the
// block answers alike. A dead ray is not listed and its state is not
// touched, as in the self-skip form (a dead ray's bounce changes nothing).
// Two other designs were timed against this one and lost (PERF.md, PR 4):
// a persistent grid striding over the list (the hardware's block
// scheduler balances uneven tiles better than a fixed stride), and a
// per-warp walk without block barriers reading rows through L1 (slower at
// every depth, incoherent rays included).
//
// Design: one thread per ray, 128 threads per block, state f32 [16, N]
// row-major so a warp's reads and writes of one row are contiguous (for
// the bounce nearly so: a run of the list within one octant holds
// ascending ids). Both ray kernels are bound by the pair tests of their
// traversals: the arithmetic, and the loads that feed it. They walk a
// block's rays together (traverse_tile.cuh), culling every cluster box
// from shared memory once per block, listing the clusters some ray
// enters, and streaming each listed cluster's rows into shared memory
// with bulk async copies ahead of their use, so that a pair test costs 8
// shared-memory loads. That pays when the rays of a block enter the same
// clusters. The camera rays of a block are neighbours. The bounce's rays
// are the survivors, sparse in pixel order, so the bounce walks the list,
// whose 128 consecutive entries are all live and mostly of one octant.
// Threads past n_rays or past the list, and rays of rows past the image,
// take part in the walk inactive. The builds with the tensor-core form of
// the pair test (MX, traverse_tile.cuh and mx_pair.cuh; the fused ones
// instantiated by mx.cu, the fission and shadow-set ones by mx_forms.cu)
// replace the TPU kernels' MXU form of the same stages.
//
// The fission form and the separate shadow set (cosig_tpu/ops/
// trace_wavefront.py:115-135, :247-267, :716-888), the TPU kernel forms
// behind render_wavefront's _FISSION switch and its cset_primary /
// cset_shadow arguments:
//
// primary_kernel<SB, SH, FISSION = true> replaces _make_primary_kernel
// (fission=True) (:293-300, :426-427): the camera ray and the closest hit
// only, its hit record (t, nx, ny, nz, mat) stored in rows 15-19 of a
// 24-row state. trace_kernel replaces _make_bounce_kernel(mode="trace")
// (:439-499): the closest hit of each listed ray, its count and its
// record; no material, light or RNG loads. shade_kernel replaces
// _make_bounce_kernel(mode="shade"): read the record (hit = t < INF, the
// traversal's own value), then ambient, per light the any-hit shadow ray,
// Lambert and Blinn-Phong, and the secondary ray; over every ray for the
// primary stage (depth 0, frustum pre-cull on its coherent shadow rays,
// as the fused primary) and over a bounce's list, the list its trace
// took (a ray that missed in the trace is live until its shade adds the
// background). Bound: the trace by the closest hit's pair tests; the
// shade by its shadow rays' tests, and where they are few by the record's
// round trip, about 20 state rows of the listed rays read and 14 written
// (at 4,194,304 rays, 24 rows x 4 B a ray are 403 MB, 0.12 ms at 3.35
// TB/s). What the split buys on this card: each kernel holds one walk's
// registers and code, and the two halves time apart.
//
// SH (primary_kernel, bounce_kernel) replaces the sh_* operands of every
// TPU kernel (_make_shadow_traverse, :247-267): the closest hit walks the
// stage's set, then the block hands its shared memory to a second walk
// over the shadow set, a coarser cut within one cull block (c_pad <= 512,
// so that walk has no superblock cull), for every shadow ray
// (traverse_tile.cuh handoff). That walk goes in slots of no more rows
// than the main walk's (shadow_walk), so the block's shared memory is the
// main walk's and the shadow-set builds hold as many blocks a
// multiprocessor as the fused ones; its any hit stops the block after the
// first slot in which no shadow ray still walks. Occlusion and the (t,
// gid) winner do not depend on the cut, so every form gives the fused
// single-set bits. The fused builds (SH and FISSION false) compile to the
// code they had without these flags.
//
// PC (every ray kernel): the main walk in slots of SLOT_MAX rows, the
// builds the launches pick for k > SLOT_MAX (traverse_tile.cuh
// pick_build), so every k a cluster set may have fits a block; up to
// k = 128 they pick the builds without, whose code is the one they had.
//
// Every form also has its MX build, as the TPU's MXU switch applies per
// stage whatever the form (trace_wavefront.py:621-714): the closest hit of
// the fission primary and of the trace kernel, and the any hits of the
// shade kernel (full mode, F_MX_SHADOW), take the tensor-core walk; with SH
// the closest hit takes it and the shadow walk over the shadow set stays
// exact (JAX's _make_shadow_traverse gets no geom_mx), so the MX walk's
// mx_any is never set there. A pair's planes are a fixed sum of exact limb
// products, whichever rays share a wgmma tile, so each MX form gives the
// fused MX frame's bits (with SH, the fused closest-only frame's). The MX
// builds carry __launch_bounds__(THREADS, MX_MIN_BLOCKS), 128 registers
// (mx_pair.cuh); the exact builds a minimum of 0, which adds no bound, so
// ptxas keeps its own choice (a minimum of 1 gave the exact bounce 156
// registers in place of 128, 3 blocks a multiprocessor in place of 4).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (cosig_tpu_torch/kernels/build.py). --fmad=false and IEEE
// division and sqrt (no --use_fast_math) keep the results bit-equal to
// the plain PyTorch version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "camera.cuh"
#include "traverse_tile.cuh"

namespace cosig {

constexpr int ROW_ALIVE = 12, ROW_COUNT = 13, ROW_ID = 14, STATE_ROWS = 16;
constexpr int REC0 = 15, FISSION_ROWS = 24;  // the fission form's hit record, rows 15-19
constexpr int THREADS = TILE_THREADS;
// Blocks a multiprocessor holds of the exact trace, fission primary and
// shade builds (their __launch_bounds__ minimum; 0 adds no bound), and the
// rows of a cluster up to which the fission primary and the shade over
// every ray keep the per-warp walk of whole clusters (past it they walk
// compacted), each the fastest in turns on the card (PERF.md;
// kernels/variants.py times the candidates): left to ptxas, the trace took
// 128 registers and 4 blocks, 6-10 % slower than at 5; the compacted
// fission primary and shade 6 (80 registers; 4 and 5 were slower); the
// fission primary's per-warp walk 7 (72 registers; 5 and 6 were slower),
// the shade's over every ray left to ptxas (5, 6 and 7 were slower).
constexpr int TRACE_MIN_BLOCKS = 5;
constexpr int FISSION_PAIRS_MIN_BLOCKS = 6;
constexpr int FISSION_MIN_BLOCKS = 7;
constexpr int SHADE_MIN_BLOCKS = 6;
constexpr int SHADE_ALL_MIN_BLOCKS = 0;
constexpr int PER_WARP_ROWS = TRACE_SLOT;

// (px, py, s) RNG seeds of ray id i: the inverse of the enumeration, py global.
__device__ __forceinline__ void seeds(const Frame& f, int i, float& px, float& py,
                                      float& s) {
  const int s_i = i % f.aa;
  const int p_i = i / f.aa;
  px = (float)(p_i % f.width);
  py = (float)(p_i / f.width) + uni(f, U_ROW_OFF);
  s = (float)s_i;
}

__device__ __forceinline__ void store(float* __restrict__ state, int n, int i,
                                      const RayState& st) {
  state[0 * (size_t)n + i] = st.ox;
  state[1 * (size_t)n + i] = st.oy;
  state[2 * (size_t)n + i] = st.oz;
  state[3 * (size_t)n + i] = st.dx;
  state[4 * (size_t)n + i] = st.dy;
  state[5 * (size_t)n + i] = st.dz;
  state[6 * (size_t)n + i] = st.at_r;
  state[7 * (size_t)n + i] = st.at_g;
  state[8 * (size_t)n + i] = st.at_b;
  state[9 * (size_t)n + i] = st.col_r;
  state[10 * (size_t)n + i] = st.col_g;
  state[11 * (size_t)n + i] = st.col_b;
  state[ROW_ALIVE * (size_t)n + i] = st.alive ? 1.0f : 0.0f;
  state[ROW_COUNT * (size_t)n + i] = st.count;
}

// The hit record of ray i in rows 15-19.
__device__ __forceinline__ void store_rec(float* __restrict__ state, int n, int i,
                                          const Hit& h) {
  state[(REC0 + 0) * (size_t)n + i] = h.t;
  state[(REC0 + 1) * (size_t)n + i] = h.nx;
  state[(REC0 + 2) * (size_t)n + i] = h.ny;
  state[(REC0 + 3) * (size_t)n + i] = h.nz;
  state[(REC0 + 4) * (size_t)n + i] = h.mat;
}

// The block walk over the shadow set `sh` (no superblocks: it fits one
// cull block) after a main walk over k-row clusters, before its handoff:
// geometry and slots only, no shared memory yet. Its slots hold no more
// rows than the main walk's (walk_layout.h shadow_rows), so the block's
// shared memory is the main walk's, and its any hit checks for a ray still
// walking after every slot.
__device__ __forceinline__ BlockWalk<false, false, true> shadow_walk(const Geometry& sh, int k) {
  BlockWalk<false, false, true> w;
  w.g = sh;
  w.rows = shadow_rows(k, sh.k);
  return w;
}

// SH: the shadow rays walk the cluster set `sh`; FISSION: stop after the
// trace and store the hit record (24-row state). Not both: the fission
// primary traces no shadow ray. MX: the tensor-core form of the pair test
// (traverse_tile.cuh) for the closest hit; without SH its shadow rays take
// it too when the frame has F_MX_SHADOW. PC: the walk in slots
// (traverse_tile.cuh), the build for k > SLOT_MAX. The exact fission
// primary's PC build instead: the compacted closest hit (closest_pairs)
// behind the frustum cull, in slots of TRACE_SLOT rows, the build for
// k > PER_WARP_ROWS (forms.cuh fission_build); without PC the per-warp
// walk of whole clusters. counts (FISSION; or NULL): the launch's three
// counters, one add each a block (add_counts): the box tests of its
// closest hit's cull (the frustum candidates, per camera ray), and the
// pairs it runs and prunes; the other builds leave it unread.
template <bool SB, bool SH, bool FISSION, bool MX = false, bool PC = false>
__global__ void __launch_bounds__(
    THREADS,
    MX ? MX_MIN_BLOCKS : (FISSION ? (PC ? FISSION_PAIRS_MIN_BLOCKS : FISSION_MIN_BLOCKS) : 0))
    primary_kernel(const __grid_constant__ Frame f, const float* __restrict__ geom,
                   const float* __restrict__ aabb, const float* __restrict__ sb_aabb,
                   int n_clusters, int k, int c_pad,
                   const float* __restrict__ prims, int n_sph, int n_box,
                   const __grid_constant__ Geometry sh, float* __restrict__ state,
                   unsigned long long* __restrict__ counts) {
  static_assert(!(SH && FISSION), "the fission primary traces no shadow rays");
  constexpr bool PAIRS = FISSION && !MX && PC;  // the compacted closest hit
  extern __shared__ __align__(128) unsigned char tile_smem[];
  BlockWalk<SB, MX, PC> walk;
  walk.rows = PAIRS ? slot_rows(k, TRACE_SLOT) : walk_rows(k);
  walk.init(make_geometry(geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph, n_box),
            tile_smem);
  if constexpr (MX && !SH) walk.mx_any = (f.flags & F_MX_SHADOW) != 0;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = f.n_rays;
  const bool in_range = i < n;  // threads past the last ray walk inactive
  float px, py, s;
  seeds(f, i, px, py, s);
  const int s_i = i % f.aa;

  RayState st;
  camera_ray(f, px, py, s_i, st);

  st.at_r = st.at_g = st.at_b = 1.0f;
  st.col_r = st.col_g = st.col_b = 0.0f;
  st.count = 0.0f;
  st.alive = in_range && py < (float)f.height;  // rows of the band past the image are dead

  // Camera rays and their shadow rays are coherent: frustum pre-cull on
  // (trace_wavefront.py:412-424).
  if constexpr (FISSION) {
    Hit h;
    if constexpr (PAIRS) {  // bounce_trace's count, then the compacted closest hit
      st.count = st.count + (st.alive ? 1.0f : 0.0f);
      h = walk.closest_pairs(st.ox, st.oy, st.oz, st.dx, st.dy, st.dz, st.alive, true);
    } else {
      h = bounce_trace(walk, st, true);
    }
    if (counts != nullptr) walk.add_counts(counts);
    if (!in_range) return;
    if (!st.alive) {  // a dead ray's record is a miss, as the plain traversal's
      h.t = INF;
      h.nx = h.nz = 0.0f;
      h.ny = 1.0f;
      h.mat = -1.0f;
    }
    store(state, n, i, st);
    state[ROW_ID * (size_t)n + i] = (float)i;
    store_rec(state, n, i, h);
    for (int r = REC0 + 5; r < FISSION_ROWS; ++r) state[r * (size_t)n + i] = 0.0f;  // pad rows
    return;
  } else if constexpr (SH) {
    BlockWalk<false, false, true> shadow = shadow_walk(sh, k);
    bounce_core(f, walk, shadow, st, px, py, s, 0.0f, f.is_last != 0, true);
  } else {
    bounce_core(f, walk, st, px, py, s, 0.0f, f.is_last != 0, true);
  }
  if (!in_range) return;
  store(state, n, i, st);
  state[ROW_ID * (size_t)n + i] = (float)i;
  state[(STATE_ROWS - 1) * (size_t)n + i] = 0.0f;  // pad row
}

// Ray `i`'s state, or an inactive thread's zeros.
__device__ __forceinline__ RayState load(const float* __restrict__ state, int n, int i,
                                         bool listed) {
  RayState st;
  st.ox = st.oy = st.oz = st.dx = st.dy = st.dz = 0.0f;
  st.at_r = st.at_g = st.at_b = st.col_r = st.col_g = st.col_b = st.count = 0.0f;
  if (listed) {
    st.ox = state[0 * (size_t)n + i];
    st.oy = state[1 * (size_t)n + i];
    st.oz = state[2 * (size_t)n + i];
    st.dx = state[3 * (size_t)n + i];
    st.dy = state[4 * (size_t)n + i];
    st.dz = state[5 * (size_t)n + i];
    st.at_r = state[6 * (size_t)n + i];
    st.at_g = state[7 * (size_t)n + i];
    st.at_b = state[8 * (size_t)n + i];
    st.col_r = state[9 * (size_t)n + i];
    st.col_g = state[10 * (size_t)n + i];
    st.col_b = state[11 * (size_t)n + i];
    st.count = state[ROW_COUNT * (size_t)n + i];
  }
  st.alive = listed;  // the list holds exactly the live rays
  return st;
}

// SH: the shadow rays walk the cluster set `sh`; MX: the tensor-core form
// for the closest hit, and without SH for the shadow rays too when the
// frame has F_MX_SHADOW; PC: the walk in slots, for k > SLOT_MAX.
template <bool SB, bool SH, bool MX = false, bool PC = false>
__global__ void __launch_bounds__(THREADS, MX ? MX_MIN_BLOCKS : 0)
    bounce_kernel(const __grid_constant__ Frame f, const float* __restrict__ geom,
                  const float* __restrict__ aabb, const float* __restrict__ sb_aabb,
                  int n_clusters, int k, int c_pad,
                  const float* __restrict__ prims, int n_sph, int n_box,
                  const __grid_constant__ Geometry sh,
                  const int* __restrict__ idx, const int* __restrict__ n_live,
                  float* __restrict__ state) {
  const int live = *n_live;
  if ((int)blockIdx.x * THREADS >= live) return;  // the same in every thread: no barrier is left
  extern __shared__ __align__(128) unsigned char tile_smem[];
  BlockWalk<SB, MX, PC> walk;
  walk.rows = walk_rows(k);
  walk.init(make_geometry(geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph, n_box),
            tile_smem, true);
  if constexpr (MX && !SH) walk.mx_any = (f.flags & F_MX_SHADOW) != 0;

  const int n = f.n_rays;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const bool listed = j < live;  // threads past the list walk inactive
  const int i = listed ? idx[j] : 0;
  RayState st = load(state, n, i, listed);
  // RNG seeds from the ray id row (bit-equal to the primary's planes).
  float px = 0.0f, py = 0.0f, s = 0.0f;
  if (listed && (f.flags & (F_SOFT_SHADOWS | F_GLOSSY))) {
    seeds(f, (int)state[ROW_ID * (size_t)n + i], px, py, s);
  }
  // Bounce rays are incoherent: superblock cull only (trace_wavefront.py:459).
  if constexpr (SH) {
    BlockWalk<false, false, true> shadow = shadow_walk(sh, k);
    bounce_core(f, walk, shadow, st, px, py, s, (float)f.depth, f.is_last != 0, false);
  } else {
    bounce_core(f, walk, st, px, py, s, (float)f.depth, f.is_last != 0, false);
  }
  if (listed) store(state, n, i, st);
}

// ---- the fission form: trace, then shade ----

// The trace half of a bounce on the listed rays of a 24-row state: ray
// idx[j]'s origin, direction and count in, its count and hit record out.
// MX: the closest hit in the tensor-core form (both modes), PC its walk in
// slots (for k > SLOT_MAX). Exact: the compacted walk
// (traverse_tile.cuh closest_pairs) in slots of TRACE_SLOT rows, at every k
// (PC unused), held to TRACE_MIN_BLOCKS blocks a multiprocessor.
// counts (or NULL): the launch's three counters, one add each a block: the
// box tests its walks run (group and cluster, per listed ray), and the
// pairs the compacted walk runs and prunes.
template <bool SB, bool MX = false, bool PC = false>
__global__ void __launch_bounds__(THREADS, MX ? MX_MIN_BLOCKS : TRACE_MIN_BLOCKS)
    trace_kernel(const __grid_constant__ Frame f, const float* __restrict__ geom,
                 const float* __restrict__ aabb, const float* __restrict__ sb_aabb,
                 int n_clusters, int k, int c_pad,
                 const float* __restrict__ prims, int n_sph, int n_box,
                 const int* __restrict__ idx, const int* __restrict__ n_live,
                 float* __restrict__ state, unsigned long long* __restrict__ counts) {
  const int live = *n_live;
  if ((int)blockIdx.x * THREADS >= live) return;  // the same in every thread
  extern __shared__ __align__(128) unsigned char tile_smem[];
  BlockWalk<SB, MX, MX ? PC : true> walk;
  walk.rows = MX ? walk_rows(k) : slot_rows(k, TRACE_SLOT);
  walk.init(make_geometry(geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph, n_box),
            tile_smem, true);

  const int n = f.n_rays;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const bool listed = j < live;  // threads past the list walk inactive
  const int i = listed ? idx[j] : 0;
  RayState st;
  st.ox = st.oy = st.oz = st.dx = st.dy = st.dz = st.count = 0.0f;
  if (listed) {
    st.ox = state[0 * (size_t)n + i];
    st.oy = state[1 * (size_t)n + i];
    st.oz = state[2 * (size_t)n + i];
    st.dx = state[3 * (size_t)n + i];
    st.dy = state[4 * (size_t)n + i];
    st.dz = state[5 * (size_t)n + i];
    st.count = state[ROW_COUNT * (size_t)n + i];
  }
  st.alive = listed;  // the list holds exactly the live rays
  // Bounce rays are incoherent: superblock cull only.
  Hit h;
  if constexpr (MX) {
    h = bounce_trace(walk, st, false);
  } else {  // bounce_trace's count, then the compacted closest hit
    st.count = st.count + (st.alive ? 1.0f : 0.0f);
    h = walk.closest_pairs(st.ox, st.oy, st.oz, st.dx, st.dy, st.dz, st.alive, false);
  }
  if (counts != nullptr) walk.add_counts(counts);
  if (!listed) return;
  state[ROW_COUNT * (size_t)n + i] = st.count;
  store_rec(state, n, i, h);
}

// The shade half on a 24-row state, its shadow rays through the cluster
// set it is given (the shadow set where there is one). LISTED: the listed
// rays of a bounce stage; else every ray of the primary stage, whose
// blocks of consecutive rays are coherent (frustum pre-cull on). MX: the
// any hits in the tensor-core form when the frame has F_MX_SHADOW (full
// mode; never on a separate shadow set, which the launches keep exact).
// PC: the walk in slots, for k > SLOT_MAX. Exact: the compacted any hit
// (traverse_tile.cuh any_pairs) in slots of TRACE_SLOT rows, held to
// SHADE_MIN_BLOCKS blocks a multiprocessor: on a list at every k (PC
// unused); over every ray in the PC build, the build for k > PER_WARP_ROWS
// (forms.cuh shade_build), and without PC the per-warp walk of whole
// clusters (any()). counts (or NULL): the launch's three counters, one add
// each a block (add_shadow_counts): the box tests of its shadow rays'
// culls, the pairs their any hits run, and the shadow rays cast.
template <bool SB, bool LISTED, bool MX = false, bool PC = false>
__global__ void __launch_bounds__(THREADS,
                                  MX ? MX_MIN_BLOCKS : (LISTED || PC ? SHADE_MIN_BLOCKS : SHADE_ALL_MIN_BLOCKS))
    shade_kernel(const __grid_constant__ Frame f, const float* __restrict__ geom,
                 const float* __restrict__ aabb, const float* __restrict__ sb_aabb,
                 int n_clusters, int k, int c_pad,
                 const float* __restrict__ prims, int n_sph, int n_box,
                 const int* __restrict__ idx, const int* __restrict__ n_live,
                 float* __restrict__ state, unsigned long long* __restrict__ counts) {
  const int n = f.n_rays;
  int i;
  bool listed;
  if constexpr (LISTED) {
    const int live = *n_live;
    if ((int)blockIdx.x * THREADS >= live) return;  // the same in every thread
    const int j = blockIdx.x * THREADS + threadIdx.x;
    listed = j < live;
    i = listed ? idx[j] : 0;
  } else {
    i = blockIdx.x * THREADS + threadIdx.x;
    listed = i < n;  // threads past the last ray walk inactive
  }
  constexpr bool PAIRS = !MX && (LISTED || PC);  // the compacted any hit
  extern __shared__ __align__(128) unsigned char tile_smem[];
  BlockWalk<SB, MX, PAIRS || PC> walk;
  walk.rows = PAIRS ? slot_rows(k, TRACE_SLOT) : walk_rows(k);
  walk.init(make_geometry(geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph, n_box),
            tile_smem, LISTED);
  if constexpr (MX) walk.mx_any = (f.flags & F_MX_SHADOW) != 0;

  RayState st = load(state, n, i, listed);
  if (!LISTED) st.alive = listed && state[ROW_ALIVE * (size_t)n + i] > 0.0f;
  Hit h;
  h.t = INF;
  h.nx = 0.0f;
  h.ny = 1.0f;
  h.nz = 0.0f;
  h.mat = -1.0f;
  if (listed) {
    h.t = state[(REC0 + 0) * (size_t)n + i];
    h.nx = state[(REC0 + 1) * (size_t)n + i];
    h.ny = state[(REC0 + 2) * (size_t)n + i];
    h.nz = state[(REC0 + 3) * (size_t)n + i];
    h.mat = state[(REC0 + 4) * (size_t)n + i];
  }
  h.hit = h.t < INF;  // the traversal's own value: t is INF exactly on a miss
  float px = 0.0f, py = 0.0f, s = 0.0f;
  if (listed && (f.flags & (F_SOFT_SHADOWS | F_GLOSSY))) {
    seeds(f, (int)state[ROW_ID * (size_t)n + i], px, py, s);
  }
  bounce_shade<PAIRS>(f, walk, st, h, px, py, s, (float)f.depth, f.is_last != 0, !LISTED);
  if (counts != nullptr) walk.add_shadow_counts(counts);
  if (listed) store(state, n, i, st);
}

}  // namespace cosig
