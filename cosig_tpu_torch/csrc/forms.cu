// The wavefront's other kernel forms (wavefront.cuh): the fission form's
// primary (stops after the trace), trace and shade kernels, and the
// primary and bounce builds whose shadow rays walk a separate cluster set,
// with plain C launchers for ctypes. A translation unit of its own, so
// that nvcc builds it beside wavefront.cu, in parallel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (cosig_tpu_torch/kernels/build.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wavefront.cuh"

namespace {

// The shadow set's geometry for a launch -> whether it may launch: a
// shadow set must fit one cull block (no superblocks to test).
bool shadow_geometry(const float* sh_geom, const float* sh_aabb, int sh_clusters, int sh_k,
                     int sh_c_pad, const float* prims, int n_sph, int n_box,
                     cosig::Geometry& g) {
  g.geom = sh_geom;
  g.aabb = sh_aabb;
  g.sb_aabb = nullptr;  // never read: one cull block has no superblocks
  g.prims = prims;
  g.n_clusters = sh_clusters;
  g.k = sh_k;
  g.c_pad = sh_c_pad;
  g.n_sph = n_sph;
  g.n_box = n_box;
  return sh_geom != nullptr && sh_aabb != nullptr && sh_clusters > 0 && sh_k > 0 &&
         sh_c_pad >= sh_clusters && sh_c_pad <= cosig::SB_CLUSTERS;
}

// Shared memory of a block that walks k-row clusters, then hands its
// memory to a walk over sh_k-row clusters: the larger layout.
int both_smem(int k, int sh_k) {
  return std::max((int)cosig::tile_layout(k).total, (int)cosig::tile_layout(sh_k).total);
}

}  // namespace

extern "C" {

// Blocks of a build that one multiprocessor holds at once, in the build
// its launch picks for n_clusters clusters of k rows (with or without the
// superblock cull), after the same raise of its dynamic shared-memory
// limit as its launch: which 0 the primary and 1 the bounce whose shadow
// rays walk a set of sh_k-row clusters, 2 the fission primary, 3 the trace
// kernel, 4 the shade kernel on a list; minus the CUDA error if refused.
int cosig_form_occupancy(int which, int n_clusters, int k, int sh_k) {
  const bool sb = cosig::superblocks(n_clusters) > 0;
  const int smem = (int)cosig::tile_layout(k).total;
  switch (which) {
    case 0:
      return cosig::walk_occupancy(sb ? cosig::primary_kernel<true, true, false>
                                      : cosig::primary_kernel<false, true, false>,
                                   both_smem(k, sh_k));
    case 1:
      return cosig::walk_occupancy(sb ? cosig::bounce_kernel<true, true>
                                      : cosig::bounce_kernel<false, true>,
                                   both_smem(k, sh_k));
    case 2:
      return cosig::walk_occupancy(sb ? cosig::primary_kernel<true, false, true>
                                      : cosig::primary_kernel<false, false, true>,
                                   smem);
    case 3:
      return cosig::walk_occupancy(sb ? cosig::trace_kernel<true> : cosig::trace_kernel<false>,
                                   smem);
    default:
      return cosig::walk_occupancy(sb ? cosig::shade_kernel<true, true>
                                      : cosig::shade_kernel<false, true>,
                                   smem);
  }
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The
// fission primary (fission != 0, sh_geom NULL) into state f32 [24, n_rays],
// or the primary whose shadow rays walk the set sh_* (fission 0) into
// state f32 [16, n_rays].
int cosig_primary_form_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                              const float* sb_aabb, int n_clusters, int k, int c_pad,
                              const float* prims, int n_sph, int n_box, int fission,
                              const float* sh_geom, const float* sh_aabb, int sh_clusters,
                              int sh_k, int sh_c_pad, float* state, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  if (!cosig::superblocks_ok(n_clusters, sb_aabb)) return (int)cudaErrorInvalidValue;
  cosig::Geometry sh{};
  if (fission ? sh_geom != nullptr
              : !shadow_geometry(sh_geom, sh_aabb, sh_clusters, sh_k, sh_c_pad, prims, n_sph,
                                 n_box, sh)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  const bool sb = cosig::superblocks(n_clusters) > 0;
  const auto kernel = fission ? (sb ? cosig::primary_kernel<true, false, true>
                                    : cosig::primary_kernel<false, false, true>)
                              : (sb ? cosig::primary_kernel<true, true, false>
                                    : cosig::primary_kernel<false, true, false>);
  const int smem = fission ? (int)cosig::tile_layout(k).total : both_smem(k, sh_k);
  return (int)cosig::launch_walk(kernel, blocks, smem, (cudaStream_t)stream, *frame, geom, aabb,
                                 sb_aabb, n_clusters, k, c_pad, prims, n_sph, n_box, sh, state);
}

// One bounce on the listed rays idx[0 .. *n_live) of state f32 [16, n_rays],
// its shadow rays through the set sh_*, on a grid for all n_rays.
int cosig_bounce_shadow_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                               const float* sb_aabb, int n_clusters, int k, int c_pad,
                               const float* prims, int n_sph, int n_box, const float* sh_geom,
                               const float* sh_aabb, int sh_clusters, int sh_k, int sh_c_pad,
                               const int* idx, const int* n_live, float* state, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  cosig::Geometry sh{};
  if (!cosig::superblocks_ok(n_clusters, sb_aabb) ||
      !shadow_geometry(sh_geom, sh_aabb, sh_clusters, sh_k, sh_c_pad, prims, n_sph, n_box, sh)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  const auto kernel = cosig::superblocks(n_clusters) > 0 ? cosig::bounce_kernel<true, true>
                                                         : cosig::bounce_kernel<false, true>;
  return (int)cosig::launch_walk(kernel, blocks, both_smem(k, sh_k), (cudaStream_t)stream,
                                 *frame, geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph,
                                 n_box, sh, idx, n_live, state);
}

// The trace half of a bounce on the listed rays of state f32 [24, n_rays].
int cosig_trace_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                       const float* sb_aabb, int n_clusters, int k, int c_pad,
                       const float* prims, int n_sph, int n_box, const int* idx,
                       const int* n_live, float* state, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  if (!cosig::superblocks_ok(n_clusters, sb_aabb)) return (int)cudaErrorInvalidValue;
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  const auto kernel = cosig::superblocks(n_clusters) > 0 ? cosig::trace_kernel<true>
                                                         : cosig::trace_kernel<false>;
  return (int)cosig::launch_walk(kernel, blocks, (int)cosig::tile_layout(k).total,
                                 (cudaStream_t)stream, *frame, geom, aabb, sb_aabb, n_clusters,
                                 k, c_pad, prims, n_sph, n_box, idx, n_live, state);
}

// The shade half on state f32 [24, n_rays], its shadow rays through the
// cluster set given: on the listed rays idx[0 .. *n_live), or with idx
// and n_live NULL on every ray (the primary stage's, frame depth 0).
int cosig_shade_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                       const float* sb_aabb, int n_clusters, int k, int c_pad,
                       const float* prims, int n_sph, int n_box, const int* idx,
                       const int* n_live, float* state, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  if (!cosig::superblocks_ok(n_clusters, sb_aabb) || (idx == nullptr) != (n_live == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + cosig::THREADS - 1) / cosig::THREADS;
  const bool sb = cosig::superblocks(n_clusters) > 0;
  const auto kernel = idx ? (sb ? cosig::shade_kernel<true, true>
                                : cosig::shade_kernel<false, true>)
                          : (sb ? cosig::shade_kernel<true, false>
                                : cosig::shade_kernel<false, false>);
  return (int)cosig::launch_walk(kernel, blocks, (int)cosig::tile_layout(k).total,
                                 (cudaStream_t)stream, *frame, geom, aabb, sb_aabb, n_clusters,
                                 k, c_pad, prims, n_sph, n_box, idx, n_live, state);
}

}  // extern "C"
