// Streaming supercluster sweep for Hopper (sm_90a): closest hit (K4) and
// any hit (K5).
//
// Replaces take_tpu/geometry/pallas_cluster.py::_sweep_kernel (K4) and
// ::_occluded_kernel (K5), and computes what they compute over the same
// triangles: sup_aabb [SupP, 8] (min xyz, max xyz, 0, 0; all-NaN padding
// rows, SupP a multiple of 8) bounds supercluster sup = triangle rows
// sup * 512 .. sup * 512 + 511 of tris [Tpad, 24], the affine operands of
// each triangle in BVH order (geometry/packet.py::prep_tables; rows past the
// last triangle are all zero and reject as parallel). The TPU kernel reads
// the same operands transposed, as one [24, 512] granule per supercluster
// (GeometryArrays.tri_sweep); here the rows are read as they are.
//
// Per block of 128 rays, one thread per ray, for each group of 8
// superclusters in ascending order: every thread slab-tests the 8 boxes at
// [tmin, min(best t, tmax)] (K5: at tmax, and only rays not yet occluded);
// __syncthreads_or decides, box by box, whether the block sweeps that
// supercluster; its 512 rows are staged through shared memory in tiles of
// 128 rows (rows at or past Tpad read as zero), and every live thread
// tests all 512, as the TPU kernel sweeps the whole granule for the whole
// block. Triangles are visited in ascending index and a hit replaces the
// best only at a strictly smaller t, which is the TPU kernel's rule
// (superclusters ascending, strict < across them, first row within one):
// the closest hit, ties to the lower primitive. K5 stops a thread at its
// first hit and leaves the group loop once every live ray of the block is
// occluded (__syncthreads_and). A miss is t = 3.4e38, prim = -1.
//
// Rays with tmax < tmin (dead lanes at -3.4e38, padding at -1) are not
// live: they test no box, so they never make the block stage a supercluster.
// Every slab reject is a comparison that is false on NaN (geometry.cuh), so
// padding rows never hit.
//
// The bound is the row traffic: 48 KB per swept supercluster per block,
// read from global memory (room's 10 MB of rows stay in L2), and 512 affine
// tests per ray per swept supercluster; coherent blocks sweep fewer
// superclusters.
//
// Each entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include "geometry.cuh"

namespace {

constexpr int kThreads = 128;  // rays per block
constexpr int kGroup = 8;      // superclusters per slab-test group
constexpr int kSupT = 512;     // triangles per supercluster
constexpr int kTile = 128;     // triangles per shared-memory tile
constexpr int kRowF4 = tt::kTriFloats / 4;  // float4 per row

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
    cluster_kernel(const float* __restrict__ sup_aabb, int n_sup,
                   const float4* __restrict__ tris, int tpad,
                   const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ tmin,
                   const float* __restrict__ tmax, int n,
                   float* __restrict__ t_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int* __restrict__ prim_out,
                   unsigned char* __restrict__ occ_out) {
  __shared__ float4 s_tri[kTile * kRowF4];
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
      for (int base = 0; base < kSupT; base += kTile) {
        const int first = sup * kSupT + base;  // row of the tile's first triangle
        __syncthreads();  // the previous tile is consumed
        for (int idx = threadIdx.x; idx < kTile * kRowF4; idx += blockDim.x) {
          s_tri[idx] = first + idx / kRowF4 < tpad
                           ? __ldg(tris + static_cast<size_t>(first) * kRowF4 + idx)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        __syncthreads();
        if (!live || occ) continue;
        for (int col = 0; col < kTile; ++col) {
          const float4* row = s_tri + col * kRowF4;
          float t, u, v;
          if (tt::tri_test(row[0], row[1], row[2], row[3], row[4], row[5], r,
                           t, u, v) &&
              t >= r.tmin && t <= r.tmax && t < best_t) {
            best_t = t;
            best_u = u;
            best_v = v;
            best = first + col;
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
                                  const float* tris, int tpad, const float* ro,
                                  const float* rd, const float* tmin,
                                  const float* tmax, int n, float* t_out,
                                  float* u_out, float* v_out, int* prim_out,
                                  void* stream) {
  if (n == 0) return 0;
  cluster_kernel<false>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          sup_aabb, n_sup, reinterpret_cast<const float4*>(tris), tpad, ro, rd,
          tmin, tmax, n, t_out, u_out, v_out, prim_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_cluster_occluded(const float* sup_aabb, int n_sup,
                                   const float* tris, int tpad, const float* ro,
                                   const float* rd, const float* tmin,
                                   const float* tmax, int n,
                                   unsigned char* occ_out, void* stream) {
  if (n == 0) return 0;
  cluster_kernel<true>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          sup_aabb, n_sup, reinterpret_cast<const float4*>(tris), tpad, ro, rd,
          tmin, tmax, n, nullptr, nullptr, nullptr, nullptr, occ_out);
  return static_cast<int>(cudaGetLastError());
}
