// The megakernel and the debug kernel, with plain C launchers for ctypes.
//
// megakernel replaces cosig_tpu/ops/trace_pallas.py _make_kernel
// (:132-288), megakernel<SB, true> its MXU form (the tensor-core pair
// test, traverse_tile.cuh and mx_pair.cuh): per pixel, every AA sample in order, each traced through up
// to max_depth bounces, then the colour mean and the per-pixel ray count.
// On the TPU a grid step owns a 32x32 pixel tile, keeps the ray state in
// VMEM and skips a bounce when no ray of the tile is alive; here one
// thread owns one pixel (the TPU kernel's lane) and keeps its ray,
// attenuation and colour in registers, so no state goes to device memory.
// The camera ray and the bounce are the same device code as the wavefront
// kernels (camera.cuh, bounce.cuh), so for power-of-two AA the two paths
// give the same bits; the mean here is acc * f32(1/aa) as on the TPU
// (trace_pallas.py:282-285), not the wavefront's division.
//
// Design: the megakernel's time is the traversal of its camera rays plus
// a few bounces of the rays that survive (traverse.cuh's bound), so it
// walks clusters as the primary kernel does, a block's rays together
// (traverse_tile.cuh). A block covers 16 x 8 pixels, each warp 8 x 4, so
// the rays that walk together are neighbours in both directions. The
// sample and depth loops are block-uniform: the block leaves a sample's
// depth loop when __syncthreads_or finds no live ray in it, the TPU's own
// per-tile skip; a dead ray's bounce changes nothing, so this is exact.
// Threads of a tile outside the width or the band take part inactive and
// write nothing; as on the TPU, every row of the band is traced (no
// in-image mask).
//
// debug_kernel replaces cosig_tpu/ops/trace_pallas.py _make_debug_kernel
// (:438-513): one perspective centre ray per pixel, even under the
// orthographic toggle (the reference's quirk), one closest-hit traversal,
// then mode 1 depth t/100, mode 2 normal * 0.5 + 0.5, mode 3 hit/miss.
// Its rays are camera rays, the coherent rays the block walk was built
// for, so it walks as the megakernel does: 16 x 8 pixel blocks of 8 x 4
// warps (the TPU kernel also tiles its pixels and culls per tile,
// :453-491), threads outside the width or the band inactive.
//
// Build: as wavefront.cu (cosig_tpu_torch/kernels/build.py), --fmad=false
// and IEEE division and sqrt.
#include <cuda_runtime.h>
#include <stdint.h>

#include "camera.cuh"
#include "traverse_tile.cuh"

namespace cosig {

constexpr int MEGA_THREADS = TILE_THREADS;
// Megakernel tiles: a block of 16 x 8 pixels, four warps of 8 x 4.
constexpr int TILE_W = 16, TILE_H = 8, WARP_W = 8, WARP_H = 4;

// Pixel (x, y) of this thread, y within the band: block b covers tile
// (b % tiles_x, b / tiles_x) of the band's 16 x 8 tiles, warp w of it the
// 8 x 4 pixels at (w % 2, w / 2), lane l pixel (l % 8, l / 8) of those.
// False outside the width or the band.
__device__ __forceinline__ bool tile_pixel(const Frame& f, int& x, int& y) {
  const int tiles_x = (f.width + TILE_W - 1) / TILE_W;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  x = (blockIdx.x % tiles_x) * TILE_W + (w % 2) * WARP_W + l % WARP_W;
  y = (blockIdx.x / tiles_x) * TILE_H + (w / 2) * WARP_H + l / WARP_W;
  return x < f.width && y < f.band;
}

// MX: the tensor-core form of the pair test (traverse_tile.cuh), for the
// closest hits and the shadow rays alike (the TPU megakernel's MXU form
// has full mode only, trace_pallas.py:88-106). Its build holds 3 blocks a
// multiprocessor (168 registers, 168-176 B spilled): with its frame loop's
// state at 4 blocks and 128 registers it spilled 388-396 B and ran 7 %
// slower (PERF.md). The exact build keeps ptxas's own choice: a minimum
// of 0 adds no bound.
constexpr int MEGA_MX_MIN_BLOCKS = 3;

// PC: the walk in slots (traverse_tile.cuh), the build for k > SLOT_MAX.
template <bool SB, bool MX = false, bool PC = false>
__global__ void __launch_bounds__(MEGA_THREADS, MX ? MEGA_MX_MIN_BLOCKS : 0)
    megakernel(const __grid_constant__ Frame f, const float* __restrict__ geom,
               const float* __restrict__ aabb, const float* __restrict__ sb_aabb,
               int n_clusters, int k, int c_pad,
               const float* __restrict__ prims, int n_sph, int n_box, int max_depth,
               float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  BlockWalk<SB, MX, PC> walk;
  walk.rows = walk_rows(k);
  walk.init(make_geometry(geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph, n_box),
            tile_smem);
  if constexpr (MX) walk.mx_any = true;

  int x, y;
  const bool in_tile = tile_pixel(f, x, y);
  const int n = f.n_rays;
  const int i = y * f.width + x;  // pixel py_local * W + px
  const float px = (float)x;
  // Global row: projection and RNG seeds stay those of the full frame.
  const float py = (float)y + uni(f, U_ROW_OFF);

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  RayState st;
  st.count = 0.0f;
  for (int s_i = 0; s_i < f.aa; ++s_i) {
    camera_ray(f, px, py, s_i, st);
    st.at_r = st.at_g = st.at_b = 1.0f;
    st.col_r = st.col_g = st.col_b = 0.0f;
    st.alive = in_tile;
    // A dead ray's bounce is a no-op on the TPU as well: stopping is exact.
    for (int depth = 0; depth < max_depth; ++depth) {
      if (!__syncthreads_or(st.alive)) break;
      // Depth 0 traces the coherent camera rays: frustum pre-cull on
      // (trace_pallas.py:187-198,272); later depths the superblock cull only.
      bounce_core(f, walk, st, px, py, (float)s_i, (float)depth, depth == max_depth - 1,
                  depth == 0);
    }
    acc_r = acc_r + st.col_r;
    acc_g = acc_g + st.col_g;
    acc_b = acc_b + st.col_b;
  }
  if (!in_tile) return;
  const float inv_aa = 1.0f / (float)f.aa;  // == float32(1.0 / aa) for aa <= 64
  out[0 * (size_t)n + i] = acc_r * inv_aa;
  out[1 * (size_t)n + i] = acc_g * inv_aa;
  out[2 * (size_t)n + i] = acc_b * inv_aa;
  out[3 * (size_t)n + i] = st.count;
}

template <bool SB, bool PC = false>
__global__ void __launch_bounds__(MEGA_THREADS)
    debug_kernel(const __grid_constant__ Frame f, const float* __restrict__ geom,
                 const float* __restrict__ aabb, const float* __restrict__ sb_aabb,
                 int n_clusters, int k, int c_pad,
                 const float* __restrict__ prims, int n_sph, int n_box, int mode,
                 float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  BlockWalk<SB, false, PC> walk;
  walk.rows = walk_rows(k);
  walk.init(make_geometry(geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph, n_box),
            tile_smem);

  int x, y;
  const bool in_tile = tile_pixel(f, x, y);
  const int n = f.n_rays;
  const int i = y * f.width + x;
  const float px = (float)x;
  const float py = (float)y + uni(f, U_ROW_OFF);
  float cam[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) cam[j] = uni(f, U_CAM + j);
  const float ocz = uni(f, U_DIST);
  const float plane_h = uni(f, U_PLANE_H);
  const float plane_w = plane_h * f.aspect;

  // trace_pallas.py:469-480, operation for operation: the origin is the
  // camera position cam[., 2] * dist + cam[., 3].
  float dcx = ((px + 0.5f) / (float)f.width - 0.5f) * plane_w;
  float dcy = ((py + 0.5f) / (float)f.height - 0.5f) * plane_h;
  float dcz = -ocz;
  rsqrt3(dcx, dcy, dcz);
  const float ox = cam[2] * ocz + cam[3];
  const float oy = cam[6] * ocz + cam[7];
  const float oz = cam[10] * ocz + cam[11];
  float dx = cam[0] * dcx + cam[1] * dcy + cam[2] * dcz;
  float dy = cam[4] * dcx + cam[5] * dcy + cam[6] * dcz;
  float dz = cam[8] * dcx + cam[9] * dcy + cam[10] * dcz;
  rsqrt3(dx, dy, dz);

  const Hit h = walk.closest(ox, oy, oz, dx, dy, dz, in_tile, true);  // trace_pallas.py:480-490
  if (!in_tile) return;
  float r, gr, b;
  if (mode == 1) {
    const float d = h.t / 100.0f;
    r = h.hit ? d : 1.0f;
    gr = h.hit ? d : 0.0f;
    b = h.hit ? d : 0.0f;
  } else if (mode == 2) {
    r = h.hit ? h.nx * 0.5f + 0.5f : 0.0f;
    gr = h.hit ? h.ny * 0.5f + 0.5f : 0.0f;
    b = h.hit ? h.nz * 0.5f + 0.5f : 1.0f;
  } else {
    r = h.hit ? 0.0f : 0.2f;
    gr = h.hit ? 1.0f : 0.2f;
    b = h.hit ? 0.0f : 0.2f;
  }
  out[0 * (size_t)n + i] = r;
  out[1 * (size_t)n + i] = gr;
  out[2 * (size_t)n + i] = b;
  out[3 * (size_t)n + i] = 1.0f;
}

// Blocks of a launch over the band's 16 x 8 pixel tiles.
inline int tile_blocks(const Frame& f) {
  return ((f.width + TILE_W - 1) / TILE_W) * ((f.band + TILE_H - 1) / TILE_H);
}

}  // namespace cosig

extern "C" {

// Blocks of the megakernel (which 0), the debug kernel (1) or the
// megakernel with the tensor-core pair test (2), in the
// build their launch picks for n_clusters clusters of k rows (with or
// without the superblock cull, with or without slots), that one
// multiprocessor holds at once with the block walk's shared memory,
// after the same raise of the kernel's dynamic shared-memory limit as its
// launch; minus the CUDA error if refused.
int cosig_megakernel_occupancy(int which, int n_clusters, int k) {
  if (which == 2) {  // the build with the tensor-core pair test
    return cosig::walk_occupancy(
        cosig::pick_build(n_clusters, k, COSIG_BUILDS(cosig::megakernel, true)),
        cosig::walk_smem(k, true));
  }
  if (which == 0) {
    return cosig::walk_occupancy(
        cosig::pick_build(n_clusters, k, COSIG_BUILDS(cosig::megakernel, false)),
        cosig::walk_smem(k));
  }
  return cosig::walk_occupancy(
      cosig::pick_build(n_clusters, k, cosig::debug_kernel<false, false>,
                        cosig::debug_kernel<false, true>, cosig::debug_kernel<true, false>,
                        cosig::debug_kernel<true, true>),
      cosig::walk_smem(k));
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched). frame->n_rays
// is the number of pixels, frame->band * frame->width; out f32 [4, n_rays]:
// rgb and the ray count.
int cosig_megakernel_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                            const float* sb_aabb, int n_clusters, int k, int c_pad,
                            const float* prims, int n_sph, int n_box, int max_depth, float* out,
                            void* stream) {
  if (frame->n_rays <= 0) return 0;
  if (!cosig::superblocks_ok(n_clusters, sb_aabb)) return (int)cudaErrorInvalidValue;
  const auto kernel = cosig::pick_build(n_clusters, k, COSIG_BUILDS(cosig::megakernel, false));
  return (int)cosig::launch_walk(kernel, cosig::tile_blocks(*frame), cosig::walk_smem(k),
                                 (cudaStream_t)stream, *frame, geom, aabb, sb_aabb, n_clusters, k,
                                 c_pad, prims, n_sph, n_box, max_depth, out);
}

// The megakernel with the tensor-core pair test (full mode), as above.
int cosig_megakernel_mx_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                               const float* sb_aabb, int n_clusters, int k, int c_pad,
                               const float* prims, int n_sph, int n_box, int max_depth,
                               float* out, void* stream) {
  if (frame->n_rays <= 0) return 0;
  if (!cosig::superblocks_ok(n_clusters, sb_aabb)) return (int)cudaErrorInvalidValue;
  const auto kernel = cosig::pick_build(n_clusters, k, COSIG_BUILDS(cosig::megakernel, true));
  return (int)cosig::launch_walk(kernel, cosig::tile_blocks(*frame), cosig::walk_smem(k, true),
                                 (cudaStream_t)stream, *frame, geom, aabb, sb_aabb, n_clusters, k,
                                 c_pad, prims, n_sph, n_box, max_depth, out);
}

int cosig_debug_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                       const float* sb_aabb, int n_clusters, int k, int c_pad,
                       const float* prims, int n_sph, int n_box, int mode, float* out,
                       void* stream) {
  if (frame->n_rays <= 0) return 0;
  if (!cosig::superblocks_ok(n_clusters, sb_aabb)) return (int)cudaErrorInvalidValue;
  const auto kernel = cosig::pick_build(
      n_clusters, k, cosig::debug_kernel<false, false>, cosig::debug_kernel<false, true>,
      cosig::debug_kernel<true, false>, cosig::debug_kernel<true, true>);
  return (int)cosig::launch_walk(kernel, cosig::tile_blocks(*frame), cosig::walk_smem(k),
                                 (cudaStream_t)stream, *frame, geom, aabb, sb_aabb, n_clusters, k,
                                 c_pad, prims, n_sph, n_box, mode, out);
}

}  // extern "C"
