// Brute-force ray/triangle sweeps for Hopper (sm_90a): closest hit (K1) and
// any hit (K2) of each ray against the whole triangle soup.
//
// Replaces take_tpu/geometry/pallas_brute.py::_closest_kernel (K1) and
// ::_anyhit_kernel (K2), and computes what they compute: each triangle's
// affine map into its (u, v, w) frame gives s = M (o - v0), dd = M d, and
//   t = -s_w * (1 / dd_w),  u = s_u + t dd_u,  v = s_v + t dd_v.
// A triangle is rejected when |dd_w| < 1e-12 (padding rows are all zero, so
// they fail this test), when min(u, v, 1 - (u + v)) < 0, or when
// min(t - tmin, tmax - t) < 0. The tests are written as comparisons, which
// are false on NaN, where fminf would drop a NaN operand. K1 keeps the first
// triangle at the least t (strict < in ascending order: the argmin tie rule),
// returns its t, u, v and index (-1 on a miss, with t = 3.4e38) and copies
// its 32-float attribute row from global memory, where the TPU kernel used a
// one-hot matmul. K2 stops at the first valid hit. A ray with tmax <= 0 (a
// dead lane, tmax = -3.4e38, or a padded ray, tmax = -1) is a miss without
// a sweep, and a block whose rays are all dead skips the sweep entirely.
//
// Layout: one thread per ray. Triangles are staged, a tile of 128 at a time,
// into shared memory as 24-float rows (s_u[4] s_v[4] s_w[4] d_u[3] d_v[3]
// d_w[3] pad[3]); every thread of a warp reads the same row, a broadcast. So
// any triangle count works, and the tables are read from global memory once
// per block. At cbox's 32 triangles the kernels are bound by the launch and
// by the rays' bytes in and out (28 B in, 16 B + one 128 B attribute row
// out per ray for K1), not by the ~20 FLOPs per ray-triangle pair.
//
// Arithmetic is IEEE float32: division is IEEE (no --use_fast_math), and
// nvcc's default FMA contraction is left on, so the affine dot products may
// differ from a separately rounded multiply-add in the last bit.
//
// Each entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // rays per block
constexpr int kTile = 128;     // triangles per shared-memory tile
constexpr int kTriFloats = 24;
constexpr int kAttrDim = 32;
constexpr float kBig = 3.4e38f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

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
  return r;
}

// Stage triangles [base, base + count) of the axis-major tables
// aff_o [4, 3 * tpad] and aff_d [3, 3 * tpad] (column k * tpad + t holds row
// k of triangle t) into 24-float rows.
__device__ __forceinline__ void stage_tile(float* s, const float* aff_o,
                                           const float* aff_d, int tpad,
                                           int base, int count) {
  for (int idx = threadIdx.x; idx < count * kTriFloats; idx += blockDim.x) {
    const int j = idx / kTriFloats;
    const int c = idx % kTriFloats;
    const int tri = base + j;
    float val = 0.0f;
    if (c < 12) {
      const int k = c / 4, row = c % 4;
      val = aff_o[row * 3 * tpad + k * tpad + tri];
    } else if (c < 21) {
      const int k = (c - 12) / 3, row = (c - 12) % 3;
      val = aff_d[row * 3 * tpad + k * tpad + tri];
    }
    s[idx] = val;
  }
}

__device__ __forceinline__ bool tri_test(const float4* row, const Ray& r,
                                         float& t, float& u, float& v) {
  const float4 a = row[0], b = row[1], c = row[2];
  const float4 d = row[3], e = row[4], f = row[5];
  const float su = a.x * r.ox + a.y * r.oy + a.z * r.oz + a.w;
  const float sv = b.x * r.ox + b.y * r.oy + b.z * r.oz + b.w;
  const float sw = c.x * r.ox + c.y * r.oy + c.z * r.oz + c.w;
  const float du = d.x * r.dx + d.y * r.dy + d.z * r.dz;
  const float dv = d.w * r.dx + e.x * r.dy + e.y * r.dz;
  const float dw = e.z * r.dx + e.w * r.dy + f.x * r.dz;
  const bool parallel = fabsf(dw) < 1e-12f;
  const float inv_dw = 1.0f / (parallel ? 1.0f : dw);
  t = -sw * inv_dw;
  u = su + t * du;
  v = sv + t * dv;
  return !parallel && u >= 0.0f && v >= 0.0f && 1.0f - (u + v) >= 0.0f &&
         t - r.tmin >= 0.0f && r.tmax - t >= 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    closest_kernel(const float* __restrict__ aff_o,
                   const float* __restrict__ aff_d, int tpad, int n_tri,
                   const float* __restrict__ attr,
                   const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ tmin,
                   const float* __restrict__ tmax, int n,
                   float* __restrict__ attrs_out, float* __restrict__ t_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   int* __restrict__ prim_out) {
  __shared__ float4 s_tri[kTile * kTriFloats / 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  Ray r{};
  bool live = false;
  if (in_range) {
    r = load_ray(ro, rd, tmin, tmax, i);
    live = r.tmax > 0.0f;
  }
  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best = -1;
  if (__syncthreads_or(live)) {
    for (int base = 0; base < n_tri; base += kTile) {
      const int count = min(kTile, n_tri - base);
      if (base > 0) __syncthreads();  // the previous tile is consumed
      stage_tile(reinterpret_cast<float*>(s_tri), aff_o, aff_d, tpad, base,
                 count);
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < count; ++j) {
        float t, u, v;
        if (tri_test(&s_tri[j * (kTriFloats / 4)], r, t, u, v) && t < best_t) {
          best_t = t;
          best_u = u;
          best_v = v;
          best = base + j;
        }
      }
    }
  }
  if (!in_range) return;
  t_out[i] = best_t;
  u_out[i] = best_u;
  v_out[i] = best_v;
  prim_out[i] = best;
  float4* dst = reinterpret_cast<float4*>(attrs_out + (size_t)i * kAttrDim);
  if (best >= 0) {
    const float4* src =
        reinterpret_cast<const float4*>(attr + (size_t)best * kAttrDim);
#pragma unroll
    for (int k = 0; k < kAttrDim / 4; ++k) dst[k] = __ldg(src + k);
  } else {
#pragma unroll
    for (int k = 0; k < kAttrDim / 4; ++k)
      dst[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
    anyhit_kernel(const float* __restrict__ aff_o,
                  const float* __restrict__ aff_d, int tpad, int n_tri,
                  const float* __restrict__ ro, const float* __restrict__ rd,
                  const float* __restrict__ tmin,
                  const float* __restrict__ tmax, int n,
                  unsigned char* __restrict__ occ_out) {
  __shared__ float4 s_tri[kTile * kTriFloats / 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  Ray r{};
  bool live = false;
  if (in_range) {
    r = load_ray(ro, rd, tmin, tmax, i);
    live = r.tmax > 0.0f;
  }
  bool occ = false;
  if (__syncthreads_or(live)) {
    for (int base = 0; base < n_tri; base += kTile) {
      const int count = min(kTile, n_tri - base);
      // a barrier before restaging, and the block's early exit
      if (base > 0 && __syncthreads_and(occ || !live)) break;
      stage_tile(reinterpret_cast<float*>(s_tri), aff_o, aff_d, tpad, base,
                 count);
      __syncthreads();
      if (!live || occ) continue;
      for (int j = 0; j < count; ++j) {
        float t, u, v;
        if (tri_test(&s_tri[j * (kTriFloats / 4)], r, t, u, v)) {
          occ = true;
          break;
        }
      }
    }
  }
  if (in_range) occ_out[i] = occ ? 1 : 0;
}

}  // namespace

extern "C" int tt_brute_closest(const float* aff_o, const float* aff_d,
                                int tpad, int n_tri, const float* attr,
                                const float* ro, const float* rd,
                                const float* tmin, const float* tmax, int n,
                                float* attrs_out, float* t_out, float* u_out,
                                float* v_out, int* prim_out, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  closest_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      aff_o, aff_d, tpad, n_tri, attr, ro, rd, tmin, tmax, n, attrs_out, t_out,
      u_out, v_out, prim_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_brute_occluded(const float* aff_o, const float* aff_d,
                                 int tpad, int n_tri, const float* ro,
                                 const float* rd, const float* tmin,
                                 const float* tmax, int n,
                                 unsigned char* occ_out, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  anyhit_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      aff_o, aff_d, tpad, n_tri, ro, rd, tmin, tmax, n, occ_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
