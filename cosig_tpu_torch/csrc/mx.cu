// The wavefront's builds with the tensor-core form of the pair test
// (primary_kernel<SB, false, false, true>, bounce_kernel<SB, false, true>:
// the TPU kernels' MXU form, mx_pair.cuh), and mx_probe_kernel, which runs
// the same device functions on one cluster and a list of rays and writes
// out the geometry limbs and the five planes, for phase 11 of
// chip_smoke.py; with plain C launchers for ctypes. A translation unit of
// its own, so that nvcc builds it beside wavefront.cu and forms.cu, in
// parallel. Closest-only mode is the same build without F_MX_SHADOW in
// the frame's flags.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (cosig_tpu_torch/kernels/build.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront.cuh"

namespace cosig {

// Shared memory of mx_probe_kernel over k rows: the rows, then one B tile.
__host__ __device__ inline int probe_tile_offset(int k) {
  return (k * GEOM_COMPS * 4 + MX_B_ALIGN - 1) / MX_B_ALIGN * MX_B_ALIGN;
}

// One block of 128 threads, one warpgroup (ray i = blockIdx.x * 128 +
// threadIdx.x; zeros past n): the cluster's k rows [k, GEOM_COMPS] into
// shared memory, each lane's fragment rays split (mx_stage), and per
// n-tile the block's split into a B tile (mx_split) and the wgmma
// products through its descriptors (mx_issue), as the block walk runs
// them. Out: planes f32 [5, k, n] (va, vb, vc, s, num) and, from block 0,
// the geometry limbs read back from the B tile at the core each k-step's
// descriptor reads for its combo (mx_step_core), as bf16 bits in the
// layout of clusters.pack_mx, [5 k, 64] (the caller zeroes it: only the
// columns of each plane's inputs are written).
__global__ void __launch_bounds__(TILE_THREADS)
    mx_probe_kernel(const float* __restrict__ geom, int k, const float* __restrict__ rays, int n,
                    unsigned short* __restrict__ limbs, float* __restrict__ planes) {
  extern __shared__ __align__(128) unsigned char probe_smem[];
  float* rows = reinterpret_cast<float*>(probe_smem);
  unsigned char* tile = probe_smem + probe_tile_offset(k);
  for (int j = threadIdx.x; j < k * GEOM_COMPS; j += TILE_THREADS) rows[j] = geom[j];
  __syncthreads();
  const int i = blockIdx.x * TILE_THREADS + threadIdx.x;
  const bool in = i < n;
  const Ray r = make_ray(in ? rays[0 * n + i] : 0.0f, in ? rays[1 * n + i] : 0.0f,
                         in ? rays[2 * n + i] : 0.0f, in ? rays[3 * n + i] : 0.0f,
                         in ? rays[4 * n + i] : 0.0f, in ? rays[5 * n + i] : 0.0f);
  MxRays a;
  float mt[2][2];
  mx_stage(r, INF, a, mt);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ray0 = blockIdx.x * TILE_THREADS + (threadIdx.x & ~31);
  MxPlanes d;
  for (int nt = 0; MX_TILE_ROWS * nt < k; ++nt) {
    mx_split(rows, k, nt, tile);
    mx_publish();
    const int p = threadIdx.x >> 3, rr = threadIdx.x & 7, row = MX_TILE_ROWS * nt + rr;
    if (blockIdx.x == 0 && p < MX_PLANES && row < k) {
      for (int ci = 0; ci < 6; ++ci) {
        const int core = mx_step_core(ci >> 1, ci & 1);
        for (int q = 0; q < MX_SLOTS; ++q) {
          // slot q: X = d, w (planes 0-3), Z = o, 1 (num)
          const int input = p < 4 ? (q < 6 ? 3 + q : -1) : (q < 3 ? q : q == 3 ? 9 : -1);
          if (input < 0) continue;
          limbs[(p * k + row) * 64 + ci * 10 + input] =
              *reinterpret_cast<const unsigned short*>(tile + mx_b_offset(p, core, rr, q));
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      mx_issue(a, smem_u32(tile), m, d);
      wg_wait<0>();
      mx_hold(d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ray = ray0 + 16 * m + g + 8 * (e >> 1);
        const int rw = MX_TILE_ROWS * nt + 2 * t + (e & 1);
        if (ray >= n || rw >= k) continue;
#pragma unroll
        for (int pl = 0; pl < MX_PLANES; ++pl) {
          planes[((size_t)pl * k + rw) * n + ray] = pl < 4 ? d.x[4 * pl + e] : d.z[e];
        }
      }
    }
    __syncthreads();  // every thread is done with the tile
  }
}

}  // namespace cosig

extern "C" {

// Dynamic shared memory of a block walk over clusters of k rows in the
// tensor-core builds.
int cosig_mx_smem_bytes(int k) { return cosig::walk_smem(k, true); }

// Blocks of the tensor-core primary (which 0) or bounce (1) that one
// multiprocessor holds at once, in the build its launch picks for
// n_clusters clusters of k rows; minus the CUDA error if refused.
int cosig_mx_occupancy(int which, int n_clusters, int k) {
  const int smem = cosig::walk_smem(k, true);
  if (which == 0) {
    return cosig::walk_occupancy(
        cosig::pick_build(n_clusters, k, COSIG_BUILDS(cosig::primary_kernel, false, false, true)),
        smem);
  }
  return cosig::walk_occupancy(
      cosig::pick_build(n_clusters, k, COSIG_BUILDS(cosig::bounce_kernel, false, true)), smem);
}

// The primary stage with the tensor-core pair test into state f32 [16,
// n_rays]; its shadow rays take it when frame->flags has F_MX_SHADOW.
int cosig_primary_mx_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                            const float* sb_aabb, int n_clusters, int k, int c_pad,
                            const float* prims, int n_sph, int n_box, float* state,
                            void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  if (!cosig::superblocks_ok(n_clusters, sb_aabb)) return (int)cudaErrorInvalidValue;
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  const auto kernel =
      cosig::pick_build(n_clusters, k, COSIG_BUILDS(cosig::primary_kernel, false, false, true));
  return (int)cosig::launch_walk(kernel, blocks, cosig::walk_smem(k, true), (cudaStream_t)stream,
                                 *frame, geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph,
                                 n_box, cosig::Geometry{}, state,
                                 static_cast<unsigned long long*>(nullptr));
}

// One bounce with the tensor-core pair test on the listed rays idx[0 ..
// *n_live) of state f32 [16, n_rays].
int cosig_bounce_mx_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                           const float* sb_aabb, int n_clusters, int k, int c_pad,
                           const float* prims, int n_sph, int n_box, const int* idx,
                           const int* n_live, float* state, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  if (!cosig::superblocks_ok(n_clusters, sb_aabb)) return (int)cudaErrorInvalidValue;
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  const auto kernel =
      cosig::pick_build(n_clusters, k, COSIG_BUILDS(cosig::bounce_kernel, false, true));
  return (int)cosig::launch_walk(kernel, blocks, cosig::walk_smem(k, true), (cudaStream_t)stream,
                                 *frame, geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph,
                                 n_box, cosig::Geometry{}, idx, n_live, state);
}

// mx_probe_kernel on one cluster geom f32 [k, 36] and rays f32 [6, n]
// (origin, direction) -> limbs (bf16 bits [5 k, 64], zeroed by the
// caller) and planes f32 [5, k, n].
int cosig_mx_probe_launch(const float* geom, int k, const float* rays, int n,
                          unsigned short* limbs, float* planes, void* stream) {
  if (k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int smem = cosig::probe_tile_offset(k) + cosig::MX_B_BYTES;
  const int blocks = (n + cosig::TILE_THREADS - 1) / cosig::TILE_THREADS;
  return (int)cosig::launch_walk(cosig::mx_probe_kernel, blocks, smem, (cudaStream_t)stream,
                                 geom, k, rays, n, limbs, planes);
}

}  // extern "C"
