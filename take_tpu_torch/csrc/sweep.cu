// Tree-free cluster cull and sweep for Hopper (sm_90a): closest hit and any
// hit (K6).
//
// Replaces take_tpu/geometry/pallas_sweep.py::_sweep_kernel (entry
// sweep_traverse, static any_hit) and computes what it computes over the
// same tables:
//   cl_aabb [Cpad, 8]: the box of cluster c = triangle rows 64 c .. 64 c + 63
//     (min xyz, max xyz, 0, 0); all-NaN padding rows;
//   tris [Tpad, 24]: the affine operands of each triangle in BVH order
//     (geometry/packet.py::prep_tables), rows >= n_tri never hit.
//
// One block of 128 threads per 128 rays, one thread per ray:
//   1. cull: the block's live rays (tmax >= tmin) are staged in shared
//      memory; thread k owns clusters k, k + 128, ... and takes, for each,
//      the least slab entry distance over the live rays whose slab test at
//      [tmin, tmax] passes (dmin; not capped by any running best, as on the
//      TPU). Clusters that some ray enters are appended to a shared list as
//      64-bit keys (dmin as an order-preserving integer, cluster id), and
//      the list is sorted ascending by a block-wide bitonic sort: pending
//      clusters in (dmin, id) order, the order of the TPU's repeated
//      argmin extraction.
//   2. sweep: the list is consumed in groups of GSWEEP = 4 clusters, their
//      4 x 64 rows staged in shared memory and tested by every live thread.
//      Before each group the TPU's stop rule is checked: closest hit stops
//      when the next dmin is not below the block's max of min(best t, tmax);
//      any hit stops when every live ray has a hit. A hit is kept when it
//      lies in [tmin, tmax], inside the triangle, and is better by
//      (t < best) | (t == best & prim < best prim): the closest hit, ties to
//      the lower primitive, whatever order the clusters come in.
//   3. u and v of the winner are recomputed from its row, as the JAX
//      package does after its kernel. A miss is t = 3.4e38, prim = -1.
//
// The TPU contracts the stacked rows with the rays on its matrix unit; here
// each thread runs the same affine test per row (geometry.cuh::tri_test).
// Rays with tmax < tmin (dead lanes at -3.4e38, padding at -1) take no part
// in the cull, so they never make the block sweep a cluster, and miss; the
// tail block's missing rays are handled the same way, with no padding.
// Every slab reject is a comparison that is false on NaN, so padding rows
// never hit.
//
// The bound is the cull, Cpad x live rays slab tests per block, and the
// sweep of every cluster nearer than the block's farthest best hit, 64
// affine tests per ray each; coherent blocks sweep few clusters. Shared
// memory holds the sorted list, next_pow2(Cpad) keys of 8 bytes, so the
// host refuses tables of more than tt_sweep_max_clusters() clusters.
//
// Each entry point launches on the given stream, allocates nothing, and
// returns the first CUDA error of the launch.

#include <cstdint>

#include "geometry.cuh"

namespace {

constexpr int kThreads = 128;  // rays per block
constexpr int kWin = 64;       // triangle rows per cluster
constexpr int kGroup = 4;      // clusters swept per group (GSWEEP)
constexpr int kRowF4 = tt::kTriFloats / 4;  // float4 per row
constexpr int kMaxClusters = 16384;
constexpr uint64_t kNoKey = ~0ull;

// dynamic shared memory: staged rows, staged rays, the cluster list
constexpr size_t kRowBytes = sizeof(float4) * kGroup * kWin * kRowF4;
constexpr size_t kRayBytes = sizeof(float) * 8 * kThreads;

size_t shared_bytes(int keys) { return kRowBytes + kRayBytes + sizeof(uint64_t) * keys; }

// float -> uint32 whose unsigned order is the float order (-0 reads as +0)
__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_float(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ float block_max(float x, float* s_red) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = s_red[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, s_red[w]);
  return m;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ cl_aabb, int n_cl,
                 const float4* __restrict__ tris, int tpad, int n_tri,
                 const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ tmin,
                 const float* __restrict__ tmax, int n,
                 float* __restrict__ t_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, int* __restrict__ prim_out,
                 unsigned char* __restrict__ occ_out) {
  extern __shared__ float4 smem[];
  float4* s_rows = smem;
  float* s_ray = reinterpret_cast<float*>(smem + kGroup * kWin * kRowF4);
  uint64_t* s_keys = reinterpret_cast<uint64_t*>(s_ray + 8 * kThreads);
  __shared__ int s_live, s_count;
  __shared__ float s_red[kThreads / 32];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  tt::Ray r{};
  bool live = false;
  if (i < n) {
    r = tt::load_ray(ro, rd, tmin, tmax, i);
    live = r.tmax >= r.tmin;
  }
  if (threadIdx.x == 0) s_live = s_count = 0;
  __syncthreads();

  // ---- 1. cull: every cluster box against the block's live rays ----
  if (live) {
    const int k = atomicAdd(&s_live, 1);
    s_ray[0 * kThreads + k] = r.ox;
    s_ray[1 * kThreads + k] = r.oy;
    s_ray[2 * kThreads + k] = r.oz;
    s_ray[3 * kThreads + k] = r.ix;
    s_ray[4 * kThreads + k] = r.iy;
    s_ray[5 * kThreads + k] = r.iz;
    s_ray[6 * kThreads + k] = r.tmin;
    s_ray[7 * kThreads + k] = r.tmax;
  }
  __syncthreads();
  const int n_live = s_live;
  for (int c = threadIdx.x; c < n_cl; c += kThreads) {
    const float* box = cl_aabb + 8 * c;
    const float lx = __ldg(box), ly = __ldg(box + 1), lz = __ldg(box + 2);
    const float hx = __ldg(box + 3), hy = __ldg(box + 4), hz = __ldg(box + 5);
    float dmin = tt::kBig;
    bool any = false;
    for (int k = 0; k < n_live; ++k) {
      tt::Ray q;
      q.ox = s_ray[0 * kThreads + k];
      q.oy = s_ray[1 * kThreads + k];
      q.oz = s_ray[2 * kThreads + k];
      q.ix = s_ray[3 * kThreads + k];
      q.iy = s_ray[4 * kThreads + k];
      q.iz = s_ray[5 * kThreads + k];
      q.tmin = s_ray[6 * kThreads + k];
      float tlo;
      if (tt::slab_hit(lx, ly, lz, hx, hy, hz, q, s_ray[7 * kThreads + k], tlo)) {
        any = true;
        dmin = tlo < dmin ? tlo : dmin;
      }
    }
    if (any) s_keys[atomicAdd(&s_count, 1)] = (uint64_t(order_bits(dmin)) << 32) | uint32_t(c);
  }
  __syncthreads();

  const int count = s_count;
  int n2 = 1;
  while (n2 < count) n2 <<= 1;
  for (int k = count + threadIdx.x; k < n2; k += kThreads) s_keys[k] = kNoKey;
  __syncthreads();
  // bitonic sort of n2 keys, ascending
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int k = threadIdx.x; k < n2; k += kThreads) {
        const int partner = k ^ stride;
        if (partner > k) {
          const uint64_t a = s_keys[k], b = s_keys[partner];
          if ((a > b) == ((k & size) == 0)) {
            s_keys[k] = b;
            s_keys[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- 2. sweep the pending clusters nearest first, kGroup at a time ----
  float best_t = tt::kBig;
  int best = -1;
  for (int g0 = 0; g0 < count; g0 += kGroup) {
    if (kAnyHit) {
      if (__syncthreads_and(!live || best >= 0)) break;
    } else {
      const float mstar = order_float(uint32_t(s_keys[g0] >> 32));
      const float cap = block_max(live ? (best_t < r.tmax ? best_t : r.tmax) : -tt::kBig, s_red);
      if (!(mstar < (cap < tt::kBig ? cap : tt::kBig))) break;
    }
    const int ng = count - g0 < kGroup ? count - g0 : kGroup;
    __syncthreads();  // the previous group's rows are consumed
    for (int idx = threadIdx.x; idx < kGroup * kWin * kRowF4; idx += kThreads) {
      const int g = idx / (kWin * kRowF4), within = idx % (kWin * kRowF4);
      float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // rejects as parallel
      if (g < ng) {
        const int c = int(uint32_t(s_keys[g0 + g]));
        const int row = c * kWin + within / kRowF4;
        if (row < tpad) val = __ldg(tris + size_t(c) * kWin * kRowF4 + within);
      }
      s_rows[idx] = val;
    }
    __syncthreads();
    if (!live || (kAnyHit && best >= 0)) continue;
    for (int g = 0; g < ng; ++g) {
      const int base = int(uint32_t(s_keys[g0 + g])) * kWin;
      const int lim = n_tri - base < kWin ? n_tri - base : kWin;
      for (int loc = 0; loc < lim; ++loc) {
        const float4* row = s_rows + (g * kWin + loc) * kRowF4;
        const int prim = base + loc;
        float t, u, v;
        if (tt::tri_test(row[0], row[1], row[2], row[3], row[4], row[5], r, t, u, v) &&
            t >= r.tmin && t <= r.tmax && t <= best_t && (t < best_t || prim < best)) {
          best_t = t;
          best = prim;
          if (kAnyHit) break;
        }
      }
      if (kAnyHit && best >= 0) break;
    }
  }

  // ---- 3. outputs; u, v of the winner from its row ----
  if (i < n) {
    const bool ok = best >= 0 && best_t <= r.tmax;
    if (kAnyHit) {
      occ_out[i] = ok ? 1 : 0;
    } else {
      float u = 0.0f, v = 0.0f;
      if (ok) {
        const float4* row = tris + size_t(best) * kRowF4;
        float t;
        tt::tri_test(__ldg(row), __ldg(row + 1), __ldg(row + 2), __ldg(row + 3),
                     __ldg(row + 4), __ldg(row + 5), r, t, u, v);
      }
      t_out[i] = ok ? best_t : tt::kBig;
      u_out[i] = u;
      v_out[i] = v;
      prim_out[i] = ok ? best : -1;
    }
  }
}

template <bool kAnyHit>
int launch(const float* cl_aabb, int n_cl, const float* tris, int tpad, int n_tri,
           const float* ro, const float* rd, const float* tmin, const float* tmax, int n,
           float* t_out, float* u_out, float* v_out, int* prim_out, unsigned char* occ_out,
           void* stream) {
  if (n == 0) return 0;
  if (n_cl > kMaxClusters) return static_cast<int>(cudaErrorInvalidValue);
  int keys = 1;
  while (keys < n_cl) keys <<= 1;
  const size_t bytes = shared_bytes(keys);
  cudaError_t err = cudaFuncSetAttribute(sweep_kernel<kAnyHit>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_kernel<kAnyHit><<<(n + kThreads - 1) / kThreads, kThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      cl_aabb, n_cl, reinterpret_cast<const float4*>(tris), tpad, n_tri, ro, rd, tmin,
      tmax, n, t_out, u_out, v_out, prim_out, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tt_sweep_max_clusters() { return kMaxClusters; }

extern "C" int tt_sweep_closest(const float* cl_aabb, int n_cl, const float* tris,
                                int tpad, int n_tri, const float* ro, const float* rd,
                                const float* tmin, const float* tmax, int n,
                                float* t_out, float* u_out, float* v_out,
                                int* prim_out, void* stream) {
  return launch<false>(cl_aabb, n_cl, tris, tpad, n_tri, ro, rd, tmin, tmax, n, t_out,
                       u_out, v_out, prim_out, nullptr, stream);
}

extern "C" int tt_sweep_occluded(const float* cl_aabb, int n_cl, const float* tris,
                                 int tpad, int n_tri, const float* ro, const float* rd,
                                 const float* tmin, const float* tmax, int n,
                                 unsigned char* occ_out, void* stream) {
  return launch<true>(cl_aabb, n_cl, tris, tpad, n_tri, ro, rd, tmin, tmax, n, nullptr,
                      nullptr, nullptr, nullptr, occ_out, stream);
}
