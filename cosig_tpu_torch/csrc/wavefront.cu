// Wavefront stages of the default render: the primary kernel and the
// bounce kernel, with plain C launchers for ctypes.
//
// primary_kernel replaces cosig_tpu/ops/trace_wavefront.py
// _make_primary_kernel (:293-436): per (pixel, AA sample) the camera ray
// (camera.cuh: stratified jitter, perspective or orthographic, motion
// blur), the 16-row state and bounce 0.
//
// bounce_kernel replaces cosig_tpu/ops/trace_wavefront.py
// _make_bounce_kernel (:439-564) in its self-skip form (:509-542, the
// compiled default): one bounce in place on every live ray; on the TPU a
// tile whose rays are all dead skips its state copy, here a thread whose
// ray is dead returns at once.
//
// Design: one thread per ray, 128 threads per block, rays in plain order
// id = (py_local * W + px) * aa + s, state f32 [16, N] row-major so a
// warp's reads and writes of one row are contiguous; at AA 4 a warp is 8
// pixels x 4 samples. Both kernels are bound by the pair tests of their
// traversals: the arithmetic, and the loads that feed it. The primary
// kernel's camera rays are coherent, so the rays of a block enter mostly
// the same clusters: it walks them together (traverse_tile.cuh), culling
// every cluster box from shared memory once per block, listing the
// clusters some ray enters, and streaming each listed cluster's rows into
// shared memory with bulk async copies ahead of their use, so that a pair
// test costs 8 shared-memory loads instead of 23 four-byte
// global ones. Threads past n_rays and rays of rows past the image take
// part in the walk inactive. The bounce kernel's rays are the survivors,
// sparse and incoherent, and keep the per-ray walk of traverse.cuh with
// its early return for dead rays. No tensor cores: see traverse_tile.cuh.
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

__global__ void __launch_bounds__(THREADS)
    bounce_kernel(const __grid_constant__ Frame f, const float* __restrict__ geom,
                  const float* __restrict__ aabb, int n_clusters, int k, int c_pad,
                  const float* __restrict__ prims, int n_sph, int n_box,
                  float* __restrict__ state) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= f.n_rays) return;
  const int n = f.n_rays;
  if (!(state[ROW_ALIVE * (size_t)n + i] > 0.0f)) return;  // dead: nothing to do

  RayState st;
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
  st.alive = true;

  // RNG seeds from the ray id row (bit-equal to the primary's planes).
  float px = 0.0f, py = 0.0f, s = 0.0f;
  if (f.flags & (F_SOFT_SHADOWS | F_GLOSSY)) {
    seeds(f, (int)state[ROW_ID * (size_t)n + i], px, py, s);
  }
  RayWalk walk{make_geometry(geom, aabb, n_clusters, k, c_pad, prims, n_sph, n_box)};
  bounce_core(f, walk, st, px, py, s, (float)f.depth, f.is_last != 0);
  store(state, n, i, st);
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

int cosig_bounce_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                        int n_clusters, int k, int c_pad, const float* prims, int n_sph,
                        int n_box, float* state, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  cosig::bounce_kernel<<<blocks, cosig::THREADS, 0, (cudaStream_t)stream>>>(
      *frame, geom, aabb, n_clusters, k, c_pad, prims, n_sph, n_box, state);
  return (int)cudaGetLastError();
}

}  // extern "C"
