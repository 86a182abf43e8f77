// Camera ray of one (pixel, AA sample): the ray generation that the TPU's
// primary-stage kernel and megakernel each inline
// (cosig_tpu/ops/trace_wavefront.py:346-390, cosig_tpu/ops/trace_pallas.py
// :210-252; compute:291-340). primary_kernel and megakernel both call
// camera_ray, so their rays are the same code and the same bits. Plain
// version: cosig_tpu_torch/ops/camera.py primary_rays.
#pragma once

#include "bounce.cuh"

namespace cosig {

// Sets st's origin and unit direction (object space) for AA sample s_i
// through pixel (px, py), py global: stratified cell plus hash22 jitter,
// the perspective or orthographic ray, then the motion-blur jitter.
__device__ __forceinline__ void camera_ray(const Frame& f, float px, float py, int s_i,
                                           RayState& st) {
  const float s = (float)s_i;
  float cam[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) cam[j] = uni(f, U_CAM + j);
  const float dist = uni(f, U_DIST);
  const float plane_h = uni(f, U_PLANE_H);
  const float plane_w = plane_h * f.aspect;
  const float ortho_h = uni(f, U_ORTHO);
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
    const float scale = 0.2f * uni(f, U_SHUTTER);
    st.ox = st.ox + (rx - 0.5f) * scale;
    st.oy = st.oy + (ry - 0.5f) * scale;
    st.oz = st.oz + (rz - 0.5f) * scale;
  }
}

}  // namespace cosig
