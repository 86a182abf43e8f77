// Wavefront stages of the default render: the primary kernel, the
// compaction kernel and the bounce kernel (their fused single-set builds;
// the ray kernels are templates of wavefront.cuh), with plain C launchers
// for ctypes. forms.cu launches the same templates' fission and
// shadow-set builds.
//
// compact_kernel replaces cosig_tpu/ops/trace_wavefront.py _compact_prefix
// (:576-617, XLA, not Pallas), the blocked dispatch's gather of the live
// rays, per ray instead of per 128-ray group (a TPU gather-cost device): it
// lists the ids of the rays with alive > 0 ordered by the direction octant
// (dx > 0) + 2 (dy > 0) + 4 (dz > 0), the JAX key, then by id, and writes
// the list length to the device. It is bound by bytes: the alive row, the
// live rays' direction rows and the list, about 4 N + 16 live bytes, a few
// microseconds at the card's memory rate. So it is one launch that reads
// the state once: a cooperative grid of resident blocks, each owning one
// contiguous range of rays, keeps one key byte per ray in shared memory
// between its count and its scatter, with one grid barrier between them
// for the per-block counts; every block then derives its offsets from the
// counts itself, with no second barrier and no atomics, so the list is the
// same on every run. A launch the card refuses is an error, never a
// fallback.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (cosig_tpu_torch/kernels/build.py).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront.cuh"

namespace cosig {

// ---- compaction ----

constexpr int OCTANTS = 8;  // keys 0-7; a dead ray's key is OCTANTS
constexpr int COMPACT_THREADS = 512;
constexpr int COMPACT_WARPS = COMPACT_THREADS / 32;
constexpr int COMPACT_UNROLL = 4;  // chunks of 32 rays whose loads a warp issues together
constexpr int COMPACT_MAX_PER_SM = 2048 / COMPACT_THREADS;

// One launch on a cooperative grid whose blocks are all resident. Block b
// owns rays [b * range, (b + 1) * range), range = COMPACT_WARPS * span *
// 32; warp w of it owns `span` consecutive chunks of 32 rays, so (block,
// warp, chunk, lane) ascends with the ray id.
//  1. Each warp reads its rays' alive row, and the three direction rows of
//     the live ones, once; it keeps each ray's key byte in shared memory and
//     counts its keys per octant (16-bit fields of two registers per lane,
//     summed over the warp at the end). Thread o < 8 writes the block's
//     count of octant o to counts[o * blocks + b].
//  2. One grid barrier. Every block then reads the [8, blocks] counts (from
//     L2) and computes the same octant starts and its own offset per octant
//     (the counts of the blocks before it), then each warp's from the warp
//     counts; block 0 writes n_live.
//  3. Each warp walks its key bytes again and writes each live ray's id at
//     its warp's next slot for the ray's octant plus its rank among the
//     chunk's lanes of that octant (a match of the key's bits over three
//     ballots).
// No atomics beyond the barrier's own, so the list is the same on every run.
__global__ void __launch_bounds__(COMPACT_THREADS)
    compact_kernel(const float* __restrict__ state, int n, int span, int* __restrict__ counts,
                   int* __restrict__ idx, int* __restrict__ n_live) {
  extern __shared__ unsigned char keys[];  // [COMPACT_WARPS * span * 32]
  __shared__ int warp_cnt[COMPACT_WARPS][OCTANTS];
  __shared__ int next[COMPACT_WARPS][OCTANTS];  // each warp's next list slot per octant
  __shared__ int total[OCTANTS], before[OCTANTS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * (COMPACT_WARPS * span * 32);  // the block's first ray
  const int own = warp * span * 32;  // the warp's first key byte

  // 1. Keys and counts.
  const float* __restrict__ alive_row = state + ROW_ALIVE * (size_t)n;
  unsigned long long lo = 0ull, hi = 0ull;  // octants 0-3 and 4-7, 16 bits each
  for (int c0 = 0; c0 < span; c0 += COMPACT_UNROLL) {
    float a[COMPACT_UNROLL], dx[COMPACT_UNROLL], dy[COMPACT_UNROLL], dz[COMPACT_UNROLL];
#pragma unroll
    for (int u = 0; u < COMPACT_UNROLL; ++u) {
      const int i = first + own + (c0 + u) * 32 + lane;
      a[u] = (c0 + u < span && i < n) ? alive_row[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < COMPACT_UNROLL; ++u) {
      const int i = first + own + (c0 + u) * 32 + lane;
      dx[u] = dy[u] = dz[u] = 0.0f;
      if (a[u] > 0.0f) {  // NaN is not alive
        dx[u] = state[3 * (size_t)n + i];
        dy[u] = state[4 * (size_t)n + i];
        dz[u] = state[5 * (size_t)n + i];
      }
    }
#pragma unroll
    for (int u = 0; u < COMPACT_UNROLL; ++u) {
      if (c0 + u >= span) break;
      const int key = a[u] > 0.0f ? (dx[u] > 0.0f ? 1 : 0) + (dy[u] > 0.0f ? 2 : 0) +
                                        (dz[u] > 0.0f ? 4 : 0)
                                  : OCTANTS;
      keys[own + (c0 + u) * 32 + lane] = (unsigned char)key;
      const unsigned long long one = 1ull << (16 * (key & 3));
      if (key < 4) lo += one;
      else if (key < OCTANTS) hi += one;
    }
  }
#pragma unroll
  for (int o = 0; o < OCTANTS; ++o) {
    const unsigned v = (unsigned)(((o < 4 ? lo : hi) >> (16 * (o & 3))) & 0xffffull);
    const unsigned s = __reduce_add_sync(FULL_MASK, v);
    if (lane == 0) warp_cnt[warp][o] = (int)s;
  }
  __syncthreads();
  if (threadIdx.x < OCTANTS) {
    int t = 0;
    for (int w = 0; w < COMPACT_WARPS; ++w) t += warp_cnt[w][threadIdx.x];
    counts[threadIdx.x * gridDim.x + blockIdx.x] = t;
  }

  // 2. Offsets, after every block's counts.
  cooperative_groups::this_grid().sync();
  if (warp < OCTANTS) {
    int t = 0, b = 0;
    for (int blk = lane; blk < (int)gridDim.x; blk += 32) {
      const int c = __ldcg(counts + warp * gridDim.x + blk);
      t += c;
      if (blk < (int)blockIdx.x) b += c;
    }
    t = __reduce_add_sync(FULL_MASK, t);
    b = __reduce_add_sync(FULL_MASK, b);
    if (lane == 0) {
      total[warp] = t;
      before[warp] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < COMPACT_WARPS * OCTANTS) {
    const int w = threadIdx.x / OCTANTS, o = threadIdx.x % OCTANTS;
    int pos = before[o];
    for (int q = 0; q < o; ++q) pos += total[q];
    for (int v = 0; v < w; ++v) pos += warp_cnt[v][o];
    next[w][o] = pos;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int s = 0;
    for (int o = 0; o < OCTANTS; ++o) s += total[o];
    *n_live = s;
  }
  __syncthreads();

  // 3. Scatter from the key bytes.
  int* __restrict__ mine = next[warp];
  const unsigned earlier = (1u << lane) - 1u;
  for (int c = 0; c < span; ++c) {
    const int l = own + c * 32 + lane;
    const int key = keys[l];
    const unsigned live = __ballot_sync(FULL_MASK, key < OCTANTS);
    if (live == 0u) continue;  // the same in every lane
    const unsigned b0 = __ballot_sync(FULL_MASK, key & 1), b1 = __ballot_sync(FULL_MASK, key & 2),
                   b2 = __ballot_sync(FULL_MASK, key & 4);
    // The live lanes whose key equals this lane's.
    const unsigned same = live & ((key & 1) ? b0 : ~b0) & ((key & 2) ? b1 : ~b1) &
                          ((key & 4) ? b2 : ~b2);
    if (key < OCTANTS) idx[mine[key] + __popc(same & earlier)] = first + l;
    __syncwarp();
    if (key < OCTANTS && (same >> lane) == 1u) mine[key] += __popc(same);  // the key's last lane
    __syncwarp();
  }
}

// The compaction's grid for n > 0 rays on the current device: the most
// blocks a multiprocessor holds at once, times the multiprocessors, cut to
// what n needs; span = chunks of 32 rays per warp; smem = the key bytes.
// Raises the kernel's dynamic shared-memory limit to all a block may opt
// into, once per call, so that a launch with any grid computed here needs
// no attribute call (the binding computes each grid once and keeps it).
struct CompactGrid {
  int blocks, span, smem;
};

cudaError_t compact_grid(int n, CompactGrid& g) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, compact_kernel);
  if (err != cudaSuccess) return err;
  const int cap = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (err != cudaSuccess) return err;
  const int chunks = (n + 31) / 32;
  for (int per_sm = COMPACT_MAX_PER_SM; per_sm >= 1; --per_sm) {
    const int warps = per_sm * sms * COMPACT_WARPS;
    g.span = (chunks + warps - 1) / warps;
    const int range = COMPACT_WARPS * g.span;  // chunks per block
    g.blocks = (chunks + range - 1) / range;
    g.smem = range * 32;
    if (g.smem > cap) continue;
    int resident = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, compact_kernel,
                                                        COMPACT_THREADS, g.smem);
    if (err != cudaSuccess) return err;
    if (resident >= per_sm) return cudaSuccess;
  }
  return cudaErrorCooperativeLaunchTooLarge;
}
}  // namespace cosig

extern "C" {

// sizeof(Frame) and sizeof(FrameData), for the binding's layout check.
int cosig_frame_bytes() { return (int)sizeof(cosig::Frame); }
int cosig_frame_data_bytes() { return (int)sizeof(cosig::FrameData); }

// Dynamic shared memory of a block walk over clusters of k rows (its
// slots: walk_layout.h), and of the trace's compacted walk.
int cosig_tile_smem_bytes(int k) { return cosig::walk_smem(k); }
int cosig_trace_smem_bytes(int k) { return cosig::trace_smem(k); }

// Blocks of the primary (which 0) or the bounce kernel (1), in the
// build their launch picks for n_clusters clusters of k rows (with or
// without the superblock cull, with or without slots), that one
// multiprocessor holds at once with the block walk's shared memory,
// after the same raise of the kernel's dynamic shared-memory limit as its
// launch; minus the CUDA error if refused.
int cosig_wavefront_occupancy(int which, int n_clusters, int k) {
  const int smem = cosig::walk_smem(k);
  if (which == 0) {
    return cosig::walk_occupancy(
        cosig::pick_build(n_clusters, k, COSIG_BUILDS(cosig::primary_kernel, false, false, false)),
        smem);
  }
  return cosig::walk_occupancy(
      cosig::pick_build(n_clusters, k, COSIG_BUILDS(cosig::bounce_kernel, false, false)), smem);
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched). sb_aabb:
// the cluster set's sb_aabb_t f32 [8, 128].
int cosig_primary_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                         const float* sb_aabb, int n_clusters, int k, int c_pad,
                         const float* prims, int n_sph, int n_box, float* state, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  if (!cosig::superblocks_ok(n_clusters, sb_aabb)) return (int)cudaErrorInvalidValue;
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  const auto kernel =
      cosig::pick_build(n_clusters, k, COSIG_BUILDS(cosig::primary_kernel, false, false, false));
  return (int)cosig::launch_walk(kernel, blocks, cosig::walk_smem(k), (cudaStream_t)stream,
                                 *frame, geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph,
                                 n_box, cosig::Geometry{}, state,
                                 static_cast<unsigned long long*>(nullptr));
}

// The compaction's grid for n rays: blocks and rays per block (0 and 0
// for n <= 0); returns a CUDA error (0 = it fits). Its launch needs
// 8 x blocks ints of scratch (the per-block octant counts).
int cosig_compact_grid(int n, int* blocks, int* range) {
  *blocks = *range = 0;
  if (n <= 0) return 0;
  cosig::CompactGrid g;
  const cudaError_t err = cosig::compact_grid(n, g);
  if (err != cudaSuccess) return (int)err;
  *blocks = g.blocks;
  *range = cosig::COMPACT_WARPS * g.span * 32;
  return 0;
}

// List the live rays of state f32 [16, n] into idx[0 .. *n_live), by
// octant then id: one cooperative launch on `stream`, on the grid that
// cosig_compact_grid(n) gave on this device (blocks, range); it neither
// queries nor sets anything of the device, so a stream capture records
// it as one kernel node. counts: scratch of `scratch` ints, at least
// 8 x blocks.
int cosig_compact_launch(const float* state, int n, int blocks, int range, int* counts,
                         int scratch, int* idx, int* n_live, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaMemsetAsync(n_live, 0, sizeof(int), s);
  // range = COMPACT_THREADS x span: one chunk of 32 rays per warp and span.
  if (blocks <= 0 || range <= 0 || range % cosig::COMPACT_THREADS != 0 ||
      (long long)blocks * range < n || scratch < cosig::OCTANTS * blocks) {
    return (int)cudaErrorInvalidValue;
  }
  int span = range / cosig::COMPACT_THREADS;
  void* args[] = {(void*)&state, (void*)&n, (void*)&span, (void*)&counts, (void*)&idx,
                  (void*)&n_live};
  const cudaError_t err =
      cudaLaunchCooperativeKernel((const void*)cosig::compact_kernel, dim3(blocks),
                                  dim3(cosig::COMPACT_THREADS), args, (size_t)range, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One bounce on the listed rays idx[0 .. *n_live) of state f32 [16, n_rays],
// on a grid for all n_rays (the list length is read on the device only).
int cosig_bounce_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                        const float* sb_aabb, int n_clusters, int k, int c_pad,
                        const float* prims, int n_sph, int n_box, const int* idx,
                        const int* n_live, float* state, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  if (!cosig::superblocks_ok(n_clusters, sb_aabb)) return (int)cudaErrorInvalidValue;
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  const auto kernel =
      cosig::pick_build(n_clusters, k, COSIG_BUILDS(cosig::bounce_kernel, false, false));
  return (int)cosig::launch_walk(kernel, blocks, cosig::walk_smem(k), (cudaStream_t)stream,
                                 *frame, geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph,
                                 n_box, cosig::Geometry{}, idx, n_live, state);
}

}  // extern "C"
