// The wavefront's other kernel forms with the tensor-core pair test (the
// TPU kernels' MXU form in the fission and shadow-set stages; wavefront.cuh,
// launchers in forms.cuh with MX true):
//
//   primary_kernel<SB, false, true, true>   the fission primary: the MX
//                                           closest hit, record in rows 15-19;
//   trace_kernel<SB, true>                  the MX closest hit of a list;
//   shade_kernel<SB, true | false, true>    the shade on a list or over every
//                                           ray, MX any hits (full mode);
//   primary_kernel<SB, true, false, true>,  the MX closest hit, then handoff
//   bounce_kernel<SB, true, true>           to the exact walk over the
//                                           shadow set.
//
// Closest-only mode launches the exact shade builds (forms.cu); a separate
// shadow set is always walked exactly. Plain C launchers for ctypes; a
// translation unit of its own, so that nvcc builds it beside the others,
// in parallel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (cosig_tpu_torch/kernels/build.py).
#include "forms.cuh"

extern "C" {

// forms.cuh form_occupancy (which 0-5) of the tensor-core builds.
int cosig_mx_form_occupancy(int which, int n_clusters, int k, int sh_k) {
  return cosig::form_occupancy<true>(which, n_clusters, k, sh_k);
}

// The fission primary (fission != 0) or the primary whose shadow rays walk
// the set sh_* exactly, both with the tensor-core closest hit.
int cosig_primary_form_mx_launch(const cosig::Frame* frame, const float* geom,
                                 const float* aabb, const float* sb_aabb, int n_clusters, int k,
                                 int c_pad, const float* prims, int n_sph, int n_box, int fission,
                                 const float* sh_geom, const float* sh_aabb, int sh_clusters,
                                 int sh_k, int sh_c_pad, float* state,
                                 unsigned long long* counts, void* stream) {
  return cosig::primary_form_launch<true>(frame, geom, aabb, sb_aabb, n_clusters, k, c_pad,
                                          prims, n_sph, n_box, fission, sh_geom, sh_aabb,
                                          sh_clusters, sh_k, sh_c_pad, state, counts, stream);
}

// One bounce on a list with the tensor-core closest hit, its shadow rays
// through the set sh_* exactly.
int cosig_bounce_shadow_mx_launch(const cosig::Frame* frame, const float* geom,
                                  const float* aabb, const float* sb_aabb, int n_clusters, int k,
                                  int c_pad, const float* prims, int n_sph, int n_box,
                                  const float* sh_geom, const float* sh_aabb, int sh_clusters,
                                  int sh_k, int sh_c_pad, const int* idx, const int* n_live,
                                  float* state, void* stream) {
  return cosig::bounce_shadow_launch<true>(frame, geom, aabb, sb_aabb, n_clusters, k, c_pad,
                                           prims, n_sph, n_box, sh_geom, sh_aabb, sh_clusters,
                                           sh_k, sh_c_pad, idx, n_live, state, stream);
}

// The trace half of a bounce on a list, tensor-core closest hit.
int cosig_trace_mx_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                          const float* sb_aabb, int n_clusters, int k, int c_pad,
                          const float* prims, int n_sph, int n_box, const int* idx,
                          const int* n_live, float* state,
                          unsigned long long* counts, void* stream) {
  return cosig::trace_launch<true>(frame, geom, aabb, sb_aabb, n_clusters, k, c_pad, prims,
                                   n_sph, n_box, idx, n_live, state, counts, stream);
}

// The shade half with tensor-core any hits (frame->flags has F_MX_SHADOW),
// on a list, or on every ray with idx and n_live NULL.
int cosig_shade_mx_launch(const cosig::Frame* frame, const float* geom, const float* aabb,
                          const float* sb_aabb, int n_clusters, int k, int c_pad,
                          const float* prims, int n_sph, int n_box, const int* idx,
                          const int* n_live, float* state,
                          unsigned long long* counts, void* stream) {
  return cosig::shade_launch<true>(frame, geom, aabb, sb_aabb, n_clusters, k, c_pad, prims,
                                   n_sph, n_box, idx, n_live, state, counts, stream);
}

}  // extern "C"
