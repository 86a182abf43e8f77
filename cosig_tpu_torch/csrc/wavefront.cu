// Wavefront stages of the default render: the primary kernel, the
// compaction kernel and the bounce kernel, with plain C launchers for
// ctypes.
//
// primary_kernel replaces cosig_tpu/ops/trace_wavefront.py
// _make_primary_kernel (:293-436): per (pixel, AA sample) the camera ray
// (camera.cuh: stratified jitter, perspective or orthographic, motion
// blur), the 16-row state and bounce 0.
//
// The compaction kernel (compact_count_kernel, compact_scan_kernel and
// compact_scatter_kernel, three launches behind one launcher) replaces
// cosig_tpu/ops/trace_wavefront.py _compact_prefix (:576-617, XLA, not
// Pallas), the blocked dispatch's gather of the live rays, per ray instead
// of per 128-ray group (a TPU gather-cost device): it lists the ids of the
// rays with alive > 0 ordered by the direction octant (dx > 0) + 2 (dy >
// 0) + 4 (dz > 0), the JAX key, then by id. Each block of COMPACT_TILE
// rays counts its live rays per octant with warp ballots; one block scans
// the counts octant-major into each (octant, block) offset and the list
// length; each block then writes its live ids at offset + rank, the rank
// a ballot prefix within the warp plus the warp prefix within the block.
// No atomics, so the list is the same on every run. Bound: bytes (the
// alive row, the live rays' direction rows, the list).
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
// take part in the walk inactive. No tensor cores: see traverse_tile.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (cosig_tpu_torch/kernels/build.py). --fmad=false and IEEE
// division and sqrt (no --use_fast_math) keep the results bit-equal to
// the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "camera.cuh"
#include "traverse_tile.cuh"

namespace cosig {

constexpr int ROW_ALIVE = 12, ROW_COUNT = 13, ROW_ID = 14, STATE_ROWS = 16;
constexpr int THREADS = TILE_THREADS;

// (px, py, s) RNG seeds of ray id i: the inverse of the enumeration, py global.
__device__ __forceinline__ void seeds(const Frame& f, int i, float& px, float& py,
                                      float& s) {
  const int s_i = i % f.aa;
  const int p_i = i / f.aa;
  px = (float)(p_i % f.width);
  py = (float)(p_i / f.width) + f.u[U_ROW_OFF];
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

__global__ void __launch_bounds__(THREADS)
    primary_kernel(const __grid_constant__ Frame f, const float* __restrict__ geom,
                   const float* __restrict__ aabb, int n_clusters, int k, int c_pad,
                   const float* __restrict__ prims, int n_sph, int n_box,
                   float* __restrict__ state) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  BlockWalk walk;
  walk.init(make_geometry(geom, aabb, n_clusters, k, c_pad, prims, n_sph, n_box), tile_smem);

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

  bounce_core(f, walk, st, px, py, s, 0.0f, f.is_last != 0);
  if (!in_range) return;
  store(state, n, i, st);
  state[ROW_ID * (size_t)n + i] = (float)i;
  state[(STATE_ROWS - 1) * (size_t)n + i] = 0.0f;  // pad row
}

// ---- compaction ----

constexpr int OCTANTS = 8;  // keys 0-7; a dead ray's key is OCTANTS
constexpr int COMPACT_THREADS = 256;
constexpr int COMPACT_WARPS = COMPACT_THREADS / 32;
constexpr int COMPACT_ITEMS = 8;  // rays per thread
constexpr int COMPACT_TILE = COMPACT_THREADS * COMPACT_ITEMS;  // rays per block
constexpr int SCAN_THREADS = 1024;

// Key of ray i: its direction octant if it is alive, else OCTANTS.
__device__ __forceinline__ int ray_key(const float* __restrict__ state, int n, int i) {
  if (i >= n || !(state[ROW_ALIVE * (size_t)n + i] > 0.0f)) return OCTANTS;
  return (state[3 * (size_t)n + i] > 0.0f ? 1 : 0) + (state[4 * (size_t)n + i] > 0.0f ? 2 : 0) +
         (state[5 * (size_t)n + i] > 0.0f ? 4 : 0);
}

// The keys of this thread's rays: round r of a block covers rays base + r
// * COMPACT_THREADS + threadIdx.x, so (round, warp, lane) ascends with the
// ray id. All loads are issued before any is used.
__device__ __forceinline__ void block_keys(const float* __restrict__ state, int n,
                                           int (&key)[COMPACT_ITEMS]) {
  const int base = blockIdx.x * COMPACT_TILE + threadIdx.x;
#pragma unroll
  for (int r = 0; r < COMPACT_ITEMS; ++r) key[r] = ray_key(state, n, base + r * COMPACT_THREADS);
}

// 1. counts[o * blocks + b]: the live rays of octant o in block b's tile.
__global__ void __launch_bounds__(COMPACT_THREADS)
    compact_count_kernel(const float* __restrict__ state, int n, int* __restrict__ counts) {
  __shared__ int cnt[COMPACT_WARPS][OCTANTS];
  const int lane = threadIdx.x & 31;
  int key[COMPACT_ITEMS];
  block_keys(state, n, key);
  int mine = 0;  // lane o < OCTANTS: the warp's live rays of octant o
#pragma unroll
  for (int r = 0; r < COMPACT_ITEMS; ++r) {
#pragma unroll
    for (int o = 0; o < OCTANTS; ++o) {
      const int c = __popc(__ballot_sync(FULL_MASK, key[r] == o));
      if (lane == o) mine += c;
    }
  }
  if (lane < OCTANTS) cnt[threadIdx.x >> 5][lane] = mine;
  __syncthreads();
  if (threadIdx.x < OCTANTS) {
    int total = 0;
    for (int w = 0; w < COMPACT_WARPS; ++w) total += cnt[w][threadIdx.x];
    counts[threadIdx.x * gridDim.x + blockIdx.x] = total;
  }
}

// 2. One block: counts[0 .. m) -> their exclusive prefix sums, in place,
// and the list length (the sum of all) in *n_live.
__global__ void __launch_bounds__(SCAN_THREADS)
    compact_scan_kernel(int* __restrict__ counts, int m, int* __restrict__ n_live) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (m + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(m, (int)threadIdx.x * per), hi = min(m, lo + per);
  int sum = 0;
  for (int e = lo; e < hi; ++e) sum += counts[e];
  int x = sum;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, w, d);
      if (lane >= d) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int e = lo; e < hi; ++e) {
    const int c = counts[e];
    counts[e] = run;
    run += c;
  }
  if (threadIdx.x == SCAN_THREADS - 1) *n_live = run;
}

// 3. Each live ray's id at its octant's offset for the block plus its rank
// among the block's earlier rays of that octant: the block's earlier rounds
// (`next`), the warp's earlier warps in this round, its earlier lanes.
__global__ void __launch_bounds__(COMPACT_THREADS)
    compact_scatter_kernel(const float* __restrict__ state, int n,
                           const int* __restrict__ offsets, int* __restrict__ idx) {
  __shared__ int cnt[2][COMPACT_WARPS][OCTANTS];  // by round parity
  __shared__ int next[OCTANTS];  // the block's next list slot per octant
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int key[COMPACT_ITEMS];
  block_keys(state, n, key);
  if (threadIdx.x < OCTANTS) next[threadIdx.x] = offsets[threadIdx.x * gridDim.x + blockIdx.x];
  const int base = blockIdx.x * COMPACT_TILE + threadIdx.x;
#pragma unroll
  for (int r = 0; r < COMPACT_ITEMS; ++r) {
    int(*c)[OCTANTS] = cnt[r & 1];
    unsigned mine = 0u;  // the ballot of this lane's octant
#pragma unroll
    for (int o = 0; o < OCTANTS; ++o) {
      const unsigned b = __ballot_sync(FULL_MASK, key[r] == o);
      if (lane == o) c[warp][o] = __popc(b);
      if (key[r] == o) mine = b;
    }
    __syncthreads();  // the counts, and `next` from the round before
    if (key[r] < OCTANTS) {
      int pos = next[key[r]] + __popc(mine & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) pos += c[w][key[r]];
      idx[pos] = base + r * COMPACT_THREADS;
    }
    __syncthreads();  // every thread has read `next`
    if (threadIdx.x < OCTANTS) {
      for (int w = 0; w < COMPACT_WARPS; ++w) next[threadIdx.x] += c[w][threadIdx.x];
    }
  }
}

// ---- bounce ----

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

__global__ void __launch_bounds__(THREADS)
    bounce_kernel(const __grid_constant__ Frame f, const float* __restrict__ geom,
                  const float* __restrict__ aabb, int n_clusters, int k, int c_pad,
                  const float* __restrict__ prims, int n_sph, int n_box,
                  const int* __restrict__ idx, const int* __restrict__ n_live,
                  float* __restrict__ state) {
  const int live = *n_live;
  if ((int)blockIdx.x * THREADS >= live) return;  // the same in every thread: no barrier is left
  extern __shared__ __align__(128) unsigned char tile_smem[];
  BlockWalk walk;
  walk.init(make_geometry(geom, aabb, n_clusters, k, c_pad, prims, n_sph, n_box), tile_smem);

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
  bounce_core(f, walk, st, px, py, s, (float)f.depth, f.is_last != 0);
  if (listed) store(state, n, i, st);
}

}  // namespace cosig

extern "C" {

// sizeof(Frame), for the binding's layout check.
int cosig_frame_bytes() { return (int)sizeof(cosig::Frame); }

// Dynamic shared memory of a block walk over clusters of k rows.
int cosig_tile_smem_bytes(int k) { return (int)cosig::tile_layout(k).total; }

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
int cosig_primary_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                         int n_clusters, int k, int c_pad, const float* prims, int n_sph,
                         int n_box, float* state, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  const int smem = (int)cosig::tile_layout(k).total;
  cudaError_t err = cudaFuncSetAttribute(cosig::primary_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cosig::primary_kernel<<<blocks, cosig::THREADS, smem, (cudaStream_t)stream>>>(
      *frame, geom, aabb, n_clusters, k, c_pad, prims, n_sph, n_box, state);
  return (int)cudaGetLastError();
}

// Scratch ints the compaction of n rays needs (the per-block counts).
int cosig_compact_scratch(int n) {
  return cosig::OCTANTS * ((n + cosig::COMPACT_TILE - 1) / cosig::COMPACT_TILE);
}

// List the live rays of state f32 [16, n] into idx[0 .. *n_live), by
// octant then id; three launches on `stream`. counts: cosig_compact_scratch(n)
// ints of scratch.
int cosig_compact_launch(const float* state, int n, int* counts, int* idx, int* n_live,
                         void* stream) {
  if (n <= 0) return (int)cudaMemsetAsync(n_live, 0, sizeof(int), (cudaStream_t)stream);
  const int blocks = (n + cosig::COMPACT_TILE - 1) / cosig::COMPACT_TILE;
  const cudaStream_t s = (cudaStream_t)stream;
  cosig::compact_count_kernel<<<blocks, cosig::COMPACT_THREADS, 0, s>>>(state, n, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cosig::compact_scan_kernel<<<1, cosig::SCAN_THREADS, 0, s>>>(counts, cosig::OCTANTS * blocks,
                                                               n_live);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cosig::compact_scatter_kernel<<<blocks, cosig::COMPACT_THREADS, 0, s>>>(state, n, counts, idx);
  return (int)cudaGetLastError();
}

// One bounce on the listed rays idx[0 .. *n_live) of state f32 [16, n_rays],
// on a grid for all n_rays (the list length is read on the device only).
int cosig_bounce_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                        int n_clusters, int k, int c_pad, const float* prims, int n_sph,
                        int n_box, const int* idx, const int* n_live, float* state,
                        void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  const int smem = (int)cosig::tile_layout(k).total;
  cudaError_t err = cudaFuncSetAttribute(cosig::bounce_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cosig::bounce_kernel<<<blocks, cosig::THREADS, smem, (cudaStream_t)stream>>>(
      *frame, geom, aabb, n_clusters, k, c_pad, prims, n_sph, n_box, idx, n_live, state);
  return (int)cudaGetLastError();
}

}  // extern "C"
