// Ray and primitive tests shared by the BVH traversal kernels (traverse.cu,
// cluster.cu). Both compute in IEEE float32 with nvcc's default FMA
// contraction, like brute.cu, and write every reject as a comparison that is
// false on NaN.
#pragma once

#include <cuda_runtime.h>

namespace tt {

constexpr float kBig = 3.4e38f;     // t of a miss
constexpr float kDwEps = 1e-12f;    // parallel-ray reject
constexpr float kInvDirEps = 1e-20f;
constexpr int kTriFloats = 24;      // o_u[4] o_v[4] o_w[4] d_u[3] d_v[3] d_w[3] pad[3]

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
  float ix, iy, iz;  // 1 / d, with |d| < 1e-20 read as 1e-20
};

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < kInvDirEps ? kInvDirEps : d);
}

__device__ __forceinline__ Ray load_ray(const float* ro, const float* rd,
                                        const float* tmin, const float* tmax,
                                        int i) {
  Ray r;
  r.ox = ro[3 * i];
  r.oy = ro[3 * i + 1];
  r.oz = ro[3 * i + 2];
  r.dx = rd[3 * i];
  r.dy = rd[3 * i + 1];
  r.dz = rd[3 * i + 2];
  r.tmin = tmin[i];
  r.tmax = tmax[i];
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  return r;
}

// Slab test of one box (lo, hi) at [tmin, tcap], bbox.h's inclusive
// semantics; `tlo` is the entry distance. Each axis orders its two plane
// distances with one comparison, so a NaN distance (a NaN-padded box) lands
// in exactly one of the axis's lo/hi and fails `lo <= hi`: padding never
// hits. (fminf/fmaxf would drop the NaN and turn padding into a hit.)
__device__ __forceinline__ bool slab_hit(float lx, float ly, float lz,
                                         float hx, float hy, float hz,
                                         const Ray& r, float tcap,
                                         float& tlo) {
  const float ax = (lx - r.ox) * r.ix, bx = (hx - r.ox) * r.ix;
  const float ay = (ly - r.oy) * r.iy, by = (hy - r.oy) * r.iy;
  const float az = (lz - r.oz) * r.iz, bz = (hz - r.oz) * r.iz;
  const bool sx = ax <= bx, sy = ay <= by, sz = az <= bz;
  const float lo_x = sx ? ax : bx, hi_x = sx ? bx : ax;
  const float lo_y = sy ? ay : by, hi_y = sy ? by : ay;
  const float lo_z = sz ? az : bz, hi_z = sz ? bz : az;
  float t0 = lo_x > lo_y ? lo_x : lo_y;
  t0 = t0 > lo_z ? t0 : lo_z;
  float t1 = hi_x < hi_y ? hi_x : hi_y;
  t1 = t1 < hi_z ? t1 : hi_z;
  tlo = t0;
  return lo_x <= hi_x && lo_y <= hi_y && lo_z <= hi_z && t0 <= t1 &&
         t1 >= r.tmin && t0 <= tcap;
}

// The affine ray/triangle test of one 24-float row (6 float4):
// t = -s_w / d_w, u = s_u + t d_u, v = s_v + t d_v; false when parallel
// (|d_w| < 1e-12; all-zero padding rows) or outside the triangle. The range
// [tmin, tmax] is the caller's.
__device__ __forceinline__ bool tri_test(float4 a, float4 b, float4 c,
                                         float4 d, float4 e, float4 f,
                                         const Ray& r, float& t, float& u,
                                         float& v) {
  const float su = a.x * r.ox + a.y * r.oy + a.z * r.oz + a.w;
  const float sv = b.x * r.ox + b.y * r.oy + b.z * r.oz + b.w;
  const float sw = c.x * r.ox + c.y * r.oy + c.z * r.oz + c.w;
  const float du = d.x * r.dx + d.y * r.dy + d.z * r.dz;
  const float dv = d.w * r.dx + e.x * r.dy + e.y * r.dz;
  const float dw = e.z * r.dx + e.w * r.dy + f.x * r.dz;
  const bool parallel = fabsf(dw) < kDwEps;
  const float inv_dw = 1.0f / (parallel ? 1.0f : dw);
  t = -sw * inv_dw;
  u = su + t * du;
  v = sv + t * dv;
  return !parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f;
}

// tri_test rounded as the plain twins round it (geometry/packet.py::
// affine_test in torch): every product and sum rounded on its own, left to
// right, none contracted into an FMA, so the answers are the twins' bit for
// bit. The FMA form differs in the last bits, which on ill-conditioned rays
// moves u or v across an edge by up to the float32 rounding bound.
__device__ __forceinline__ float dot3_rn(float a, float b, float c, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

__device__ __forceinline__ bool tri_test_rn(float4 a, float4 b, float4 c,
                                            float4 d, float4 e, float4 f,
                                            const Ray& r, float& t, float& u,
                                            float& v) {
  const float su = __fadd_rn(dot3_rn(a.x, a.y, a.z, r.ox, r.oy, r.oz), a.w);
  const float sv = __fadd_rn(dot3_rn(b.x, b.y, b.z, r.ox, r.oy, r.oz), b.w);
  const float sw = __fadd_rn(dot3_rn(c.x, c.y, c.z, r.ox, r.oy, r.oz), c.w);
  const float du = dot3_rn(d.x, d.y, d.z, r.dx, r.dy, r.dz);
  const float dv = dot3_rn(d.w, e.x, e.y, r.dx, r.dy, r.dz);
  const float dw = dot3_rn(e.z, e.w, f.x, r.dx, r.dy, r.dz);
  const bool parallel = fabsf(dw) < kDwEps;
  const float inv_dw = __fdiv_rn(1.0f, parallel ? 1.0f : dw);
  t = __fmul_rn(-sw, inv_dw);
  u = __fadd_rn(su, __fmul_rn(t, du));
  v = __fadd_rn(sv, __fmul_rn(t, dv));
  return !parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f;
}

}  // namespace tt

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
