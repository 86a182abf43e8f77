// The wavefront's other kernel forms (wavefront.cuh, launchers in
// forms.cuh) with the exact pair test: the fission form's primary (stops
// after the trace), trace and shade kernels, and the primary and bounce
// builds whose shadow rays walk a separate cluster set, with plain C
// launchers for ctypes. A translation unit of its own, so that nvcc builds
// it beside wavefront.cu, in parallel. Their tensor-core builds are
// mx_forms.cu's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (cosig_tpu_torch/kernels/build.py).
#include "forms.cuh"

extern "C" {

// forms.cuh form_occupancy (which 0-5) of the exact builds.
int cosig_form_occupancy(int which, int n_clusters, int k, int sh_k) {
  return cosig::form_occupancy<false>(which, n_clusters, k, sh_k);
}

// The fission primary (fission != 0) or the primary whose shadow rays walk
// the set sh_* (forms.cuh primary_form_launch).
int cosig_primary_form_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                              const float* sb_aabb, int n_clusters, int k, int c_pad,
                              const float* prims, int n_sph, int n_box, int fission,
                              const float* sh_geom, const float* sh_aabb, int sh_clusters,
                              int sh_k, int sh_c_pad, float* state,
                              unsigned long long* counts, void* stream) {
  return cosig::primary_form_launch<false>(frame, geom, aabb, sb_aabb, n_clusters, k, c_pad,
                                           prims, n_sph, n_box, fission, sh_geom, sh_aabb,
                                           sh_clusters, sh_k, sh_c_pad, state, counts, stream);
}

// One bounce on a list, its shadow rays through the set sh_*.
int cosig_bounce_shadow_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                               const float* sb_aabb, int n_clusters, int k, int c_pad,
                               const float* prims, int n_sph, int n_box, const float* sh_geom,
                               const float* sh_aabb, int sh_clusters, int sh_k, int sh_c_pad,
                               const int* idx, const int* n_live, float* state, void* stream) {
  return cosig::bounce_shadow_launch<false>(frame, geom, aabb, sb_aabb, n_clusters, k, c_pad,
                                            prims, n_sph, n_box, sh_geom, sh_aabb, sh_clusters,
                                            sh_k, sh_c_pad, idx, n_live, state, stream);
}

// The trace half of a bounce on a list of a 24-row state.
int cosig_trace_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                       const float* sb_aabb, int n_clusters, int k, int c_pad,
                       const float* prims, int n_sph, int n_box, const int* idx,
                       const int* n_live, float* state,
                       unsigned long long* counts, void* stream) {
  return cosig::trace_launch<false>(frame, geom, aabb, sb_aabb, n_clusters, k, c_pad, prims,
                                    n_sph, n_box, idx, n_live, state, counts, stream);
}

// The shade half on a list, or on every ray with idx and n_live NULL.
int cosig_shade_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                       const float* sb_aabb, int n_clusters, int k, int c_pad,
                       const float* prims, int n_sph, int n_box, const int* idx,
                       const int* n_live, float* state,
                       unsigned long long* counts, void* stream) {
  return cosig::shade_launch<false>(frame, geom, aabb, sb_aabb, n_clusters, k, c_pad, prims,
                                    n_sph, n_box, idx, n_live, state, counts, stream);
}

}  // extern "C"
