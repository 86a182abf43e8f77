// Host-side launchers of the wavefront's other kernel forms (wavefront.cuh):
// the fission primary, the trace and shade kernels, and the primary and
// bounce builds whose shadow rays walk a separate cluster set, each as a
// template over MX, the pair test's form. forms.cu instantiates them with
// MX false (the exact builds), mx_forms.cu with MX true (the tensor-core
// builds), each behind its own plain C launchers for ctypes, so that nvcc
// builds the two translation units in parallel.
//
// A tensor-core build's block walk lays out tile_layout(rows, true): the
// exact layout and the two B tiles of the pair test. A shadow-set build
// holds its closest-hit walk's layout, which the exact shadow walk's,
// slots of no more rows, never outgrows (walk_layout.h both_smem); the
// exact trace and shade on a list their compacted walk's (trace_smem), in
// slots at every k, so they are built with and without the superblock cull
// only; the exact fission primary and shade over every ray the compacted
// walk's in their PC builds, which the launches pick for k > PER_WARP_ROWS,
// and the per-warp walk's of whole clusters (walk_smem) in the others.
// Every other kernel has builds with and without slots (PC, picked by
// k > SLOT_MAX), beside those with and without the superblock cull.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront.cuh"

namespace cosig {

// The shadow set's geometry for a launch -> whether it may launch: a
// shadow set must fit one cull block (no superblocks to test).
inline bool shadow_geometry(const float* sh_geom, const float* sh_aabb, int sh_clusters, int sh_k,
                            int sh_c_pad, const float* prims, int n_sph, int n_box, Geometry& g) {
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
         sh_c_pad >= sh_clusters && sh_c_pad <= SB_CLUSTERS;
}

// The builds for n_clusters clusters of k rows of the trace, the fission
// primary and the shade (`listed`: on a list, else over every ray): the
// tensor-core ones by SB and PC; the exact trace and shade on a list by SB
// only, their compacted walks in slots at every k; the exact fission
// primary and shade over every ray by SB and k > PER_WARP_ROWS (their
// compacted PC builds; the per-warp walk up to it, wavefront.cuh).
template <bool MX>
auto trace_build(int n_clusters, int k) {
  if constexpr (MX) {
    return pick_build(n_clusters, k, COSIG_BUILDS(trace_kernel, true));
  } else {
    return superblocks(n_clusters) > 0 ? trace_kernel<true, false> : trace_kernel<false, false>;
  }
}

template <bool MX>
auto fission_build(int n_clusters, int k) {
  return pick_build(n_clusters, k, COSIG_BUILDS(primary_kernel, false, true, MX),
                    MX ? SLOT_MAX : PER_WARP_ROWS);
}

template <bool MX>
auto shade_build(int n_clusters, int k, bool listed) {
  if constexpr (MX) {
    return listed ? pick_build(n_clusters, k, COSIG_BUILDS(shade_kernel, true, true))
                  : pick_build(n_clusters, k, COSIG_BUILDS(shade_kernel, false, true));
  } else {
    return listed ? (superblocks(n_clusters) > 0 ? shade_kernel<true, true>
                                                 : shade_kernel<false, true>)
                  : pick_build(n_clusters, k, COSIG_BUILDS(shade_kernel, false, false),
                               PER_WARP_ROWS);
  }
}

// The shared memory of those builds over clusters of k rows: the trace
// and the shade on a list (`listed`), else the fission primary and the
// shade over every ray.
template <bool MX>
int pairs_smem(int k, bool listed) {
  if (MX) return walk_smem(k, true);
  return listed || k > PER_WARP_ROWS ? trace_smem(k) : walk_smem(k);
}

// Blocks of a build that one multiprocessor holds at once, in the build
// its launch picks for n_clusters clusters of k rows (with or without the
// superblock cull, with or without slots), after the same raise of its
// dynamic shared-memory limit as its launch: which 0 the primary and 1 the
// bounce whose shadow rays walk a set of sh_k-row clusters, 2 the fission
// primary, 3 the trace kernel, 4 the shade kernel on a list, 5 the shade
// kernel over every ray; minus the CUDA error if refused.
template <bool MX>
int form_occupancy(int which, int n_clusters, int k, int sh_k) {
  switch (which) {
    case 0:
      return walk_occupancy(
          pick_build(n_clusters, k, COSIG_BUILDS(primary_kernel, true, false, MX)),
          both_smem(k, sh_k, MX));
    case 1:
      return walk_occupancy(pick_build(n_clusters, k, COSIG_BUILDS(bounce_kernel, true, MX)),
                            both_smem(k, sh_k, MX));
    case 2:
      return walk_occupancy(fission_build<MX>(n_clusters, k), pairs_smem<MX>(k, false));
    case 3:
      return walk_occupancy(trace_build<MX>(n_clusters, k), pairs_smem<MX>(k, true));
    default:
      return walk_occupancy(shade_build<MX>(n_clusters, k, which == 4),
                            pairs_smem<MX>(k, which == 4));
  }
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The
// fission primary (fission != 0, sh_geom NULL) into state f32 [24, n_rays],
// counts (or NULL) three u64 counters it adds its box tests, pairs run and
// pairs pruned to; or the primary whose shadow rays walk the set sh_*
// (fission 0, counts NULL) into state f32 [16, n_rays].
template <bool MX>
int primary_form_launch(const Frame* frame, const float* geom, const float* aabb,
                        const float* sb_aabb, int n_clusters, int k, int c_pad,
                        const float* prims, int n_sph, int n_box, int fission,
                        const float* sh_geom, const float* sh_aabb, int sh_clusters, int sh_k,
                        int sh_c_pad, float* state, unsigned long long* counts,
                        void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  if (!superblocks_ok(n_clusters, sb_aabb) || (!fission && counts != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry sh{};
  if (fission ? sh_geom != nullptr
              : !shadow_geometry(sh_geom, sh_aabb, sh_clusters, sh_k, sh_c_pad, prims, n_sph,
                                 n_box, sh)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  const auto kernel =
      fission ? fission_build<MX>(n_clusters, k)
              : pick_build(n_clusters, k, COSIG_BUILDS(primary_kernel, true, false, MX));
  const int smem = fission ? pairs_smem<MX>(k, false) : both_smem(k, sh_k, MX);
  return (int)launch_walk(kernel, blocks, smem, (cudaStream_t)stream, *frame, geom, aabb, sb_aabb,
                          n_clusters, k, c_pad, prims, n_sph, n_box, sh, state, counts);
}

// One bounce on the listed rays idx[0 .. *n_live) of state f32 [16, n_rays],
// its shadow rays through the set sh_*, on a grid for all n_rays.
template <bool MX>
int bounce_shadow_launch(const Frame* frame, const float* geom, const float* aabb,
                         const float* sb_aabb, int n_clusters, int k, int c_pad,
                         const float* prims, int n_sph, int n_box, const float* sh_geom,
                         const float* sh_aabb, int sh_clusters, int sh_k, int sh_c_pad,
                         const int* idx, const int* n_live, float* state, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  Geometry sh{};
  if (!superblocks_ok(n_clusters, sb_aabb) ||
      !shadow_geometry(sh_geom, sh_aabb, sh_clusters, sh_k, sh_c_pad, prims, n_sph, n_box, sh)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  const auto kernel = pick_build(n_clusters, k, COSIG_BUILDS(bounce_kernel, true, MX));
  return (int)launch_walk(kernel, blocks, both_smem(k, sh_k, MX), (cudaStream_t)stream, *frame,
                          geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph, n_box, sh, idx,
                          n_live, state);
}

// The trace half of a bounce on the listed rays of state f32 [24, n_rays];
// counts (or NULL): three u64 counters the launch adds its box tests, pairs
// run and pairs pruned to.
template <bool MX>
int trace_launch(const Frame* frame, const float* geom, const float* aabb, const float* sb_aabb,
                 int n_clusters, int k, int c_pad, const float* prims, int n_sph, int n_box,
                 const int* idx, const int* n_live, float* state,
                 unsigned long long* counts, void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  if (!superblocks_ok(n_clusters, sb_aabb)) return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  return (int)launch_walk(trace_build<MX>(n_clusters, k), blocks, pairs_smem<MX>(k, true),
                          (cudaStream_t)stream, *frame, geom, aabb, sb_aabb, n_clusters, k, c_pad,
                          prims, n_sph, n_box, idx, n_live, state, counts);
}

// The shade half on state f32 [24, n_rays], its shadow rays through the
// cluster set given: on the listed rays idx[0 .. *n_live), or with idx
// and n_live NULL on every ray (the primary stage's, frame depth 0);
// counts (or NULL): three u64 counters the launch adds its shadow rays'
// box tests, pairs run and rays cast to.
template <bool MX>
int shade_launch(const Frame* frame, const float* geom, const float* aabb, const float* sb_aabb,
                 int n_clusters, int k, int c_pad, const float* prims, int n_sph, int n_box,
                 const int* idx, const int* n_live, float* state, unsigned long long* counts,
                 void* stream) {
  const int n = frame->n_rays;
  if (n <= 0) return 0;
  if (!superblocks_ok(n_clusters, sb_aabb) || (idx == nullptr) != (n_live == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  return (int)launch_walk(shade_build<MX>(n_clusters, k, idx != nullptr), blocks,
                          pairs_smem<MX>(k, idx != nullptr), (cudaStream_t)stream, *frame, geom, aabb, sb_aabb,
                          n_clusters, k, c_pad, prims, n_sph, n_box, idx, n_live, state, counts);
}

}  // namespace cosig
