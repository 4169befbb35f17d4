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
// its 32-float attribute row, where the TPU kernel used a one-hot matmul. K2
// answers whether any triangle passes. A ray with tmax <= 0 (a dead lane,
// tmax = -3.4e38, or a padded ray, tmax = -1) is a miss, and a block whose
// rays are all such skips the sweep.
//
// What bounds them on the H100, and what the design does about it:
//  - Issued instructions per ray-triangle pair: about 55 in the SASS, 21
//    of them the six affine dot products, whose form fixes their bits, ~10
//    the IEEE reciprocal, and the compares. A warp runs as long as its
//    slowest lane, so K2 too sweeps nearly every triangle (a live shadow
//    ray of a cbox render tests 30 of the 32 before its first hit or the
//    end). The range test is written as lo <= t < hi with lo and hi set
//    once a ray (load_ray), and 1 - (u + v) >= 0 as u + v <= 1: the same
//    answers with 3 adds and a compare fewer; the parallel reject no
//    longer selects the divisor. Rows come from shared memory, the whole
//    table of a default scene (<= 256 rows, 24 KB) in one tile, staged by
//    float4 copies of the scene's `tri_rows`, built once per upload;
//    larger tables are swept a tile at a time. K1 unrolls its loop by 2;
//    K2 holds 2 rays a thread, tests them branch-free (a ray once occluded
//    stays so), and its warps vote every 4 triangles on leaving the sweep.
//  - K1's 128-byte attribute row, 128 of its 176 bytes a ray. A warp's 32
//    rows are one 4 KB span, stored as 8 instructions of 512 contiguous
//    bytes (one thread a row wrote 32 lines per instruction).
// Tried and measured slower (PERF.md): a warp-uniform skip of pairs whose
// plane lies behind the ray, rows read through __ldg instead of shared
// memory, 2 or 4 rays a thread in K1 and 1 or 4 in K2, blocks of 64 or 256
// threads; and no faster: attribute rows staged in shared memory, streaming
// stores, any-hit orders by triangle area.
//
// Arithmetic is IEEE float32: division is IEEE (no --use_fast_math), and
// nvcc's default FMA contraction is left on, so the affine dot products may
// differ from a separately rounded multiply-add in the last bit. t, u and v
// keep the first design's expressions, so the kernels return its answers bit
// for bit; reference_kernel keeps its loop to show it on the card.
//
// Each entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kAnyHitRays = 2;   // rays a thread in K2 (K1: one)
constexpr int kThreads = 128;    // threads a block
constexpr int kGroup = 4;        // K2's triangles between two votes of a warp
constexpr int kTile = 256;       // rows a shared-memory tile (24 KB)
constexpr int kRowF4 = 6;        // a triangle row: 24 floats
constexpr int kAttrF4 = 8;       // an attribute row: 32 floats
constexpr float kBig = 3.4e38f;
constexpr unsigned kAll = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
  // [lo, hi): the t that pass t - tmin >= 0 && tmax - t >= 0
  float lo, hi;
};

// Ray i; past n, and for tmax <= 0 (or NaN), a dead ray whose tmax is -inf.
__device__ __forceinline__ Ray load_ray(const float* ro, const float* rd,
                                        const float* tmin, const float* tmax,
                                        int i, int n) {
  Ray r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -INFINITY};
  if (i < n) {
    r.ox = ro[3 * i];
    r.oy = ro[3 * i + 1];
    r.oz = ro[3 * i + 2];
    r.dx = rd[3 * i];
    r.dy = rd[3 * i + 1];
    r.dz = rd[3 * i + 2];
    r.tmin = tmin[i];
    const float tm = tmax[i];
    r.tmax = tm > 0.0f ? tm : -INFINITY;
  }
  // t - tmin >= 0 fails for t = -inf and for a NaN tmin, and otherwise holds
  // iff t >= tmin; tmax - t >= 0 fails for t = +inf and otherwise holds iff
  // t <= tmax, i.e. iff t is below the next float above tmax.
  r.lo = r.tmin == -INFINITY ? -3.40282347e38f : r.tmin;
  r.hi = nextafterf(r.tmax, INFINITY);
  return r;
}

__device__ __forceinline__ bool live(const Ray& r) { return r.tmax > 0.0f; }

// The affine test of one row. t, u and v are the parent's expressions in
// its order, so that nvcc contracts them alike and they keep their bits.
// It passes where the parent's test passes and t < hi: its
// 1 - (u + v) >= 0 holds iff u + v <= 1 (1 - s is exact for s near 1), and
// the range is [lo, hi) (load_ray). A parallel row (|d_w| < 1e-12) fails
// whatever 1 / d_w gives.
__device__ __forceinline__ bool tri_test(const float4* q, const Ray& r,
                                         float hi, float& t, float& u,
                                         float& v) {
  const float4 a = q[0], b = q[1], c = q[2], d = q[3], e = q[4], f = q[5];
  const float su = a.x * r.ox + a.y * r.oy + a.z * r.oz + a.w;
  const float sv = b.x * r.ox + b.y * r.oy + b.z * r.oz + b.w;
  const float sw = c.x * r.ox + c.y * r.oy + c.z * r.oz + c.w;
  const float du = d.x * r.dx + d.y * r.dy + d.z * r.dz;
  const float dv = d.w * r.dx + e.x * r.dy + e.y * r.dz;
  const float dw = e.z * r.dx + e.w * r.dy + f.x * r.dz;
  t = -sw * (1.0f / dw);
  u = su + t * du;
  v = sv + t * dv;
  return !(fabsf(dw) < 1e-12f) && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t >= r.lo && t < hi;
}

// Rows [base, base + count) into shared memory, one float4 a thread a step.
__device__ __forceinline__ void stage(float4* s, const float4* rows, int base,
                                      int count) {
  const float4* src = rows + (size_t)base * kRowF4;
  for (int idx = threadIdx.x; idx < count * kRowF4; idx += kThreads)
    s[idx] = __ldg(src + idx);
}

// K1: one ray a thread; every triangle is tested, and the first at the
// least t wins.
__global__ void __launch_bounds__(kThreads)
    closest_kernel(const float4* __restrict__ rows, int n_tri,
                   const float4* __restrict__ attr,
                   const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ tmin,
                   const float* __restrict__ tmax, int n,
                   float4* __restrict__ attrs_out, float* __restrict__ t_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   int* __restrict__ prim_out) {
  extern __shared__ float4 s_rows[];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const Ray r = load_ray(ro, rd, tmin, tmax, i, n);
  float bt = fminf(kBig, r.hi), bu = 0.0f, bv = 0.0f;  // t < bt: below the best t, within tmax
  int bp = -1;
  if (__syncthreads_or(live(r))) {
    for (int base = 0; base < n_tri; base += kTile) {
      const int count = min(kTile, n_tri - base);
      if (base > 0) __syncthreads();  // the previous tile is consumed
      stage(s_rows, rows, base, count);
      __syncthreads();
      const float4* q = s_rows;
#pragma unroll 2
      for (int j = base; j < base + count; ++j, q += kRowF4) {
        float t, u, v;
        if (tri_test(q, r, bt, t, u, v)) {
          bt = t;
          bu = u;
          bv = v;
          bp = j;
        }
      }
    }
  }
  if (i < n) {
    t_out[i] = bp >= 0 ? bt : kBig;
    u_out[i] = bu;
    v_out[i] = bv;
    prim_out[i] = bp;
  }
  // The warp's rays i - lane .. i - lane + 31 own one 4 KB span of attribute
  // rows: 8 stores of 512 contiguous bytes, lane l writing float4 (l & 7) of
  // row 4 m + (l >> 3).
  const int lane = threadIdx.x & 31, row0 = i - lane;
#pragma unroll
  for (int m = 0; m < 32 / 4; ++m) {
    const int q = 4 * m + (lane >> 3);
    const int p = __shfl_sync(kAll, bp, q);
    if (row0 + q < n)
      attrs_out[(size_t)(row0 + q) * kAttrF4 + (lane & 7)] =
          p >= 0 ? __ldg(attr + (size_t)p * kAttrF4 + (lane & 7))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// K2. Thread h of block b holds rays b * kAnyHitRays * kThreads + k *
// kThreads + h. A ray once occluded stays so, and a warp whose rays are all
// occluded or dead leaves the sweep (checked every kGroup triangles).
__global__ void __launch_bounds__(kThreads)
    anyhit_kernel(const float4* __restrict__ rows, int n_tri,
                  const float* __restrict__ ro, const float* __restrict__ rd,
                  const float* __restrict__ tmin,
                  const float* __restrict__ tmax, int n,
                  unsigned char* __restrict__ occ_out) {
  extern __shared__ float4 s_rows[];
  constexpr int R = kAnyHitRays;
  const int first = blockIdx.x * R * kThreads + threadIdx.x;
  Ray r[R];
  bool occ[R];
  bool done = true;  // every ray of the thread occluded or dead
#pragma unroll
  for (int k = 0; k < R; ++k) {
    r[k] = load_ray(ro, rd, tmin, tmax, first + k * kThreads, n);
    occ[k] = false;
    done &= !live(r[k]);
  }
  if (!__syncthreads_and(done)) {
    for (int base = 0; base < n_tri; base += kTile) {
      const int count = min(kTile, n_tri - base);
      if (base > 0) __syncthreads();
      stage(s_rows, rows, base, count);
      __syncthreads();
      // a warp whose rays are all answered sweeps no further; no barrier
      // follows inside the sweep
      const float4* q = s_rows;
      for (int j = 0; j < count && !__all_sync(kAll, done); j += kGroup) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g, q += kRowF4) {
          if (j + g < count) {
#pragma unroll
            for (int k = 0; k < R; ++k) {
              float t, u, v;
              occ[k] |= tri_test(q, r[k], r[k].hi, t, u, v);
            }
          }
        }
        done = true;
#pragma unroll
        for (int k = 0; k < R; ++k) done &= occ[k] || !live(r[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = first + k * kThreads;
    if (i < n) occ_out[i] = occ[k] ? 1 : 0;
  }
}

// The parent's test, as written in the first design.
__device__ __forceinline__ bool tri_test_parent(const float4* q,
                                                const Ray& r, float& t,
                                                float& u, float& v) {
  const float su = q[0].x * r.ox + q[0].y * r.oy + q[0].z * r.oz + q[0].w;
  const float sv = q[1].x * r.ox + q[1].y * r.oy + q[1].z * r.oz + q[1].w;
  const float sw = q[2].x * r.ox + q[2].y * r.oy + q[2].z * r.oz + q[2].w;
  const float du = q[3].x * r.dx + q[3].y * r.dy + q[3].z * r.dz;
  const float dv = q[3].w * r.dx + q[4].x * r.dy + q[4].y * r.dz;
  const float dw = q[4].z * r.dx + q[4].w * r.dy + q[5].x * r.dz;
  const bool parallel = fabsf(dw) < 1e-12f;
  const float inv_dw = 1.0f / (parallel ? 1.0f : dw);
  t = -sw * inv_dw;
  u = su + t * du;
  v = sv + t * dv;
  return !parallel && u >= 0.0f && v >= 0.0f && 1.0f - (u + v) >= 0.0f &&
         t - r.tmin >= 0.0f && r.tmax - t >= 0.0f;
}

// The loop of the first design, kept as the reference the kernels above are
// held to bit for bit on the card: one thread per ray, every triangle in
// index order (up to the first hit for any hit), the same test.
template <bool kAnyHit>
__global__ void reference_kernel(const float4* __restrict__ rows, int n_tri,
                                 const float4* __restrict__ attr,
                                 const float* __restrict__ ro,
                                 const float* __restrict__ rd,
                                 const float* __restrict__ tmin,
                                 const float* __restrict__ tmax, int n,
                                 float4* __restrict__ attrs_out,
                                 float* __restrict__ t_out,
                                 float* __restrict__ u_out,
                                 float* __restrict__ v_out,
                                 int* __restrict__ prim_out,
                                 unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ro, rd, tmin, tmax, i, n);
  float bt = kBig, bu = 0.0f, bv = 0.0f;
  int bp = -1;
  for (int j = 0; j < n_tri && live(r); ++j) {
    float4 q[kRowF4];
#pragma unroll
    for (int c = 0; c < kRowF4; ++c) q[c] = __ldg(rows + j * kRowF4 + c);
    float t, u, v;
    if (tri_test_parent(q, r, t, u, v) && (kAnyHit || t < bt)) {
      bt = t;
      bu = u;
      bv = v;
      bp = j;
      if (kAnyHit) break;
    }
  }
  if (kAnyHit) {
    occ_out[i] = bp >= 0 ? 1 : 0;
    return;
  }
  t_out[i] = bt;
  u_out[i] = bu;
  v_out[i] = bv;
  prim_out[i] = bp;
#pragma unroll
  for (int c = 0; c < kAttrF4; ++c)
    attrs_out[(size_t)i * kAttrF4 + c] =
        bp >= 0 ? __ldg(attr + (size_t)bp * kAttrF4 + c)
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

int blocks(int n, int rays) { return (n + rays * kThreads - 1) / (rays * kThreads); }

size_t smem(int n_tri) {
  return sizeof(float4) * kRowF4 * (n_tri < kTile ? n_tri : kTile);
}

}  // namespace

extern "C" int tt_brute_closest(const float* rows, int n_tri, const float* attr,
                                const float* ro, const float* rd,
                                const float* tmin, const float* tmax, int n,
                                float* attrs_out, float* t_out, float* u_out,
                                float* v_out, int* prim_out, void* stream) {
  if (n == 0) return 0;
  closest_kernel<<<blocks(n, 1), kThreads, smem(n_tri),
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(rows), n_tri,
      reinterpret_cast<const float4*>(attr), ro, rd, tmin, tmax, n,
      reinterpret_cast<float4*>(attrs_out), t_out, u_out, v_out, prim_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_brute_occluded(const float* rows, int n_tri, const float* ro,
                                 const float* rd, const float* tmin,
                                 const float* tmax, int n,
                                 unsigned char* occ_out, void* stream) {
  if (n == 0) return 0;
  anyhit_kernel<<<blocks(n, kAnyHitRays), kThreads, smem(n_tri),
                  static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(rows), n_tri, ro, rd, tmin, tmax, n,
      occ_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_brute_reference(const float* rows, int n_tri,
                                  const float* attr, const float* ro,
                                  const float* rd, const float* tmin,
                                  const float* tmax, int n, float* attrs_out,
                                  float* t_out, float* u_out, float* v_out,
                                  int* prim_out, unsigned char* occ_out,
                                  int any_hit, void* stream) {
  if (n == 0) return 0;
  const int threads = 256, grid = (n + threads - 1) / threads;
  auto s = static_cast<cudaStream_t>(stream);
  auto* rows4 = reinterpret_cast<const float4*>(rows);
  auto* attr4 = reinterpret_cast<const float4*>(attr);
  auto* out4 = reinterpret_cast<float4*>(attrs_out);
  if (any_hit)
    reference_kernel<true><<<grid, threads, 0, s>>>(
        rows4, n_tri, attr4, ro, rd, tmin, tmax, n, out4, t_out, u_out, v_out,
        prim_out, occ_out);
  else
    reference_kernel<false><<<grid, threads, 0, s>>>(
        rows4, n_tri, attr4, ro, rd, tmin, tmax, n, out4, t_out, u_out, v_out,
        prim_out, occ_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
