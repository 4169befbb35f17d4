// Streaming supercluster sweep for Hopper (sm_90a): closest hit (K4) and
// any hit (K5).
//
// Replaces take_tpu/geometry/pallas_cluster.py::_sweep_kernel (K4) and
// ::_occluded_kernel (K5), and computes what they compute over the same
// tables: sup_aabb [SupP, 8] (min xyz, max xyz, 0, 0; all-NaN padding rows,
// SupP a multiple of 8) and tri_sweep [SupP' * 24, 512] (SupP' >= SupP),
// whose rows sup * 24 + j hold affine operand j of supercluster sup's 512
// triangles (triangle sup * 512 + column, in BVH order; padding columns are
// all zero and reject as parallel).
//
// Per block of 128 rays, one thread per ray, for each group of 8
// superclusters in ascending order: every thread slab-tests the 8 boxes at
// [tmin, min(best t, tmax)] (K5: at tmax, and only rays not yet occluded);
// __syncthreads_or decides, box by box, whether the block sweeps that
// supercluster; its [24, 512] granule is staged through shared memory in
// tiles of 128 triangles, turned into 24-float rows, and every live thread
// tests all 512 columns, as the TPU kernel sweeps the whole granule for the
// whole block. Triangles are visited in ascending index and a hit replaces
// the best only at a strictly smaller t, which is the TPU kernel's rule
// (superclusters ascending, strict < across them, first row within one):
// the closest hit, ties to the lower primitive. K5 stops a thread at its
// first hit and leaves the group loop once every live ray of the block is
// occluded (__syncthreads_and). A miss is t = 3.4e38, prim = -1.
//
// Rays with tmax < tmin (dead lanes at -3.4e38, padding at -1) are not
// live: they test no box, so they never make the block stage a granule.
// Every slab reject is a comparison that is false on NaN (geometry.cuh), so
// padding rows never hit.
//
// The bound is the granule traffic: 48 KB per swept supercluster per block,
// read from global memory (room's 10 MB tri_sweep table stays in L2), and
// 512 affine tests per ray per swept supercluster; coherent blocks sweep
// fewer superclusters.
//
// Each entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include "geometry.cuh"

namespace {

constexpr int kThreads = 128;  // rays per block
constexpr int kGroup = 8;      // superclusters per slab-test group
constexpr int kSupT = 512;     // triangles per supercluster
constexpr int kOps = 24;       // operand rows per granule
constexpr int kTile = 128;     // triangles per shared-memory tile

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
    cluster_kernel(const float* __restrict__ sup_aabb, int n_sup,
                   const float* __restrict__ tri_sweep,
                   const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ tmin,
                   const float* __restrict__ tmax, int n,
                   float* __restrict__ t_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int* __restrict__ prim_out,
                   unsigned char* __restrict__ occ_out) {
  __shared__ float4 s_tri[kTile * tt::kTriFloats / 4];
  float* s = reinterpret_cast<float*>(s_tri);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  tt::Ray r{};
  bool live = false;
  if (in_range) {
    r = tt::load_ray(ro, rd, tmin, tmax, i);
    live = r.tmax >= r.tmin;
  }
  float best_t = tt::kBig, best_u = 0.0f, best_v = 0.0f;
  int best = -1;
  bool occ = false;
  for (int g = 0; g < n_sup / kGroup; ++g) {
    if (kAnyHit && __syncthreads_and(occ || !live)) break;
    const float tcap = kAnyHit ? r.tmax : (best_t < r.tmax ? best_t : r.tmax);
    unsigned hits = 0;
    if (live && !occ) {
#pragma unroll
      for (int w = 0; w < kGroup; ++w) {
        const float* box = sup_aabb + 8 * (g * kGroup + w);
        float tlo;
        if (tt::slab_hit(__ldg(box), __ldg(box + 1), __ldg(box + 2),
                         __ldg(box + 3), __ldg(box + 4), __ldg(box + 5), r,
                         tcap, tlo))
          hits |= 1u << w;
      }
    }
    for (int w = 0; w < kGroup; ++w) {
      if (!__syncthreads_or((hits >> w) & 1u)) continue;
      const int sup = g * kGroup + w;
      const float* granule = tri_sweep + static_cast<size_t>(sup) * kOps * kSupT;
      for (int base = 0; base < kSupT; base += kTile) {
        __syncthreads();  // the previous tile is consumed
        // coalesced along the granule's columns, stored as 24-float rows
        for (int idx = threadIdx.x; idx < kOps * kTile; idx += blockDim.x) {
          const int j = idx / kTile, col = idx % kTile;
          s[col * tt::kTriFloats + j] = __ldg(granule + j * kSupT + base + col);
        }
        __syncthreads();
        if (!live || occ) continue;
        for (int col = 0; col < kTile; ++col) {
          const float4* row = s_tri + col * (tt::kTriFloats / 4);
          float t, u, v;
          if (tt::tri_test(row[0], row[1], row[2], row[3], row[4], row[5], r,
                           t, u, v) &&
              t >= r.tmin && t <= r.tmax && t < best_t) {
            best_t = t;
            best_u = u;
            best_v = v;
            best = sup * kSupT + base + col;
            if (kAnyHit) {
              occ = true;
              break;
            }
          }
        }
      }
    }
  }
  if (!in_range) return;
  if (kAnyHit) {
    occ_out[i] = occ ? 1 : 0;
  } else {
    const bool ok = best_t <= r.tmax;
    t_out[i] = ok ? best_t : tt::kBig;
    u_out[i] = best_u;
    v_out[i] = best_v;
    prim_out[i] = ok ? best : -1;
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int tt_cluster_closest(const float* sup_aabb, int n_sup,
                                  const float* tri_sweep, const float* ro,
                                  const float* rd, const float* tmin,
                                  const float* tmax, int n, float* t_out,
                                  float* u_out, float* v_out, int* prim_out,
                                  void* stream) {
  if (n == 0) return 0;
  cluster_kernel<false>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          sup_aabb, n_sup, tri_sweep, ro, rd, tmin, tmax, n, t_out, u_out,
          v_out, prim_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_cluster_occluded(const float* sup_aabb, int n_sup,
                                   const float* tri_sweep, const float* ro,
                                   const float* rd, const float* tmin,
                                   const float* tmax, int n,
                                   unsigned char* occ_out, void* stream) {
  if (n == 0) return 0;
  cluster_kernel<true>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          sup_aabb, n_sup, tri_sweep, ro, rd, tmin, tmax, n, nullptr, nullptr,
          nullptr, nullptr, occ_out);
  return static_cast<int>(cudaGetLastError());
}
