// Wavefront stages of the default render: the primary kernel and the
// bounce kernel, with plain C launchers for ctypes.
//
// primary_kernel replaces cosig_tpu/ops/trace_wavefront.py
// _make_primary_kernel (:293-436): per (pixel, AA sample) the stratified
// jitter, the perspective or orthographic camera ray, motion blur, the
// 16-row state and bounce 0.
//
// bounce_kernel replaces cosig_tpu/ops/trace_wavefront.py
// _make_bounce_kernel (:439-564) in its self-skip form (:509-542, the
// compiled default): one bounce in place on every live ray; on the TPU a
// tile whose rays are all dead skips its state copy, here a thread whose
// ray is dead returns at once.
//
// Design: one thread per ray, 128 threads per block, rays in plain order
// id = (py_local * W + px) * aa + s, state f32 [16, N] row-major so a
// warp's reads and writes of one row are contiguous. Both kernels are
// bound by the pair tests of their traversals (traverse.cuh): the
// arithmetic and the L2 reads of the cluster geometry. This first
// version keeps the geometry in L2 through the read-only cache and
// relies on rays of a warp sharing clusters; it does no compaction of
// live rays, no sorting by direction and no tensor-core (wgmma) or TMA
// staging.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (cosig_tpu_torch/kernels/build.py). --fmad=false and IEEE
// division and sqrt (no --use_fast_math) keep the results bit-equal to
// the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"

namespace cosig {

constexpr int ROW_ALIVE = 12, ROW_COUNT = 13, ROW_ID = 14, STATE_ROWS = 16;
constexpr int THREADS = 128;

__device__ __forceinline__ Geometry make_geometry(const float* geom, const float* aabb,
                                                  int n_clusters, int k, int c_pad) {
  Geometry g;
  g.geom = geom;
  g.aabb = aabb;
  g.n_clusters = n_clusters;
  g.k = k;
  g.c_pad = c_pad;
  return g;
}

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
                   float* __restrict__ state) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= f.n_rays) return;
  const int n = f.n_rays;
  float px, py, s;
  seeds(f, i, px, py, s);
  const int s_i = i % f.aa;

  const float* cam = f.u + U_CAM;
  const float dist = f.u[U_DIST];
  const float plane_h = f.u[U_PLANE_H];
  const float plane_w = plane_h * f.aspect;
  const float ortho_h = f.u[U_ORTHO];
  const float ortho_w = ortho_h * f.aspect;

  // AA offsets (compute:300-310).
  float off_x = 0.5f, off_y = 0.5f;
  if (f.aa > 1) {
    const float gx = (float)(s_i % f.grid_w);
    const float gy = (float)(s_i / f.grid_w);
    float jx, jy;
    hash22(px + s * 13.0f, py + s * 7.0f, jx, jy);
    off_x = (gx + jx) / (float)f.grid_w;
    off_y = (gy + jy) / (float)f.grid_h;
  }

  float ocx, ocy, ocz, dcx, dcy, dcz;
  if (f.flags & F_ORTHO) {
    ocx = ((px + off_x) / (float)f.width - 0.5f) * 2.0f * ortho_w;
    ocy = ((py + off_y) / (float)f.height - 0.5f) * 2.0f * ortho_h;
    ocz = dist;
    dcx = 0.0f;
    dcy = 0.0f;
    dcz = -1.0f;
  } else {
    const float u = ((px + off_x) / (float)f.width - 0.5f) * plane_w;
    const float v = ((py + off_y) / (float)f.height - 0.5f) * plane_h;
    ocx = 0.0f;
    ocy = 0.0f;
    ocz = dist;
    dcx = u - ocx;
    dcy = v - ocy;
    dcz = -ocz;
    rsqrt3(dcx, dcy, dcz);
  }

  RayState st;
  st.ox = cam[0] * ocx + cam[1] * ocy + cam[2] * ocz + cam[3];
  st.oy = cam[4] * ocx + cam[5] * ocy + cam[6] * ocz + cam[7];
  st.oz = cam[8] * ocx + cam[9] * ocy + cam[10] * ocz + cam[11];
  st.dx = cam[0] * dcx + cam[1] * dcy + cam[2] * dcz;
  st.dy = cam[4] * dcx + cam[5] * dcy + cam[6] * dcz;
  st.dz = cam[8] * dcx + cam[9] * dcy + cam[10] * dcz;
  rsqrt3(st.dx, st.dy, st.dz);

  if (f.flags & F_MOTION_BLUR) {
    float rx, ry, rz;
    random_unit(px + s, py, s, rx, ry, rz);
    const float scale = 0.2f * f.u[U_SHUTTER];
    st.ox = st.ox + (rx - 0.5f) * scale;
    st.oy = st.oy + (ry - 0.5f) * scale;
    st.oz = st.oz + (rz - 0.5f) * scale;
  }

  st.at_r = st.at_g = st.at_b = 1.0f;
  st.col_r = st.col_g = st.col_b = 0.0f;
  st.count = 0.0f;
  st.alive = py < (float)f.height;  // rows of the band past the image are dead

  if (st.alive) {
    const Geometry g = make_geometry(geom, aabb, n_clusters, k, c_pad);
    bounce_core(f, g, st, px, py, s, 0.0f, f.is_last != 0);
  }
  store(state, n, i, st);
  state[ROW_ID * (size_t)n + i] = (float)i;
  state[15 * (size_t)n + i] = 0.0f;
}

__global__ void __launch_bounds__(THREADS)
    bounce_kernel(const __grid_constant__ Frame f, const float* __restrict__ geom,
                  const float* __restrict__ aabb, int n_clusters, int k, int c_pad,
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
  const Geometry g = make_geometry(geom, aabb, n_clusters, k, c_pad);
  bounce_core(f, g, st, px, py, s, (float)f.depth, f.is_last != 0);
  store(state, n, i, st);
}

}  // namespace cosig

extern "C" {

// sizeof(Frame), for the binding's layout check.
int cosig_frame_bytes() { return (int)sizeof(cosig::Frame); }

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
int cosig_primary_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                         int n_clusters, int k, int c_pad, float* state, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  cosig::primary_kernel<<<blocks, cosig::THREADS, 0, (cudaStream_t)stream>>>(
      *frame, geom, aabb, n_clusters, k, c_pad, state);
  return (int)cudaGetLastError();
}

int cosig_bounce_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                        int n_clusters, int k, int c_pad, float* state, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  cosig::bounce_kernel<<<blocks, cosig::THREADS, 0, (cudaStream_t)stream>>>(
      *frame, geom, aabb, n_clusters, k, c_pad, state);
  return (int)cudaGetLastError();
}

}  // extern "C"
