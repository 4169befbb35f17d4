// Streaming supercluster sweep for Hopper (sm_90a): closest hit (K4) and
// any hit (K5).
//
// Replaces take_tpu/geometry/pallas_cluster.py::_sweep_kernel (K4) and
// ::_occluded_kernel (K5), and computes what they compute over the same
// triangles:
//   sup_aabb [SupP, 8]: the box of supercluster s = clusters 8 s .. 8 s + 7
//     (min xyz, max xyz, 0, 0; all-NaN padding rows, SupP a multiple of 8);
//   cl_aabb [Cpad, 8]: the box of cluster c = triangle rows 64 c .. 64 c + 63
//     (the same layout and padding), built with sup_aabb (geometry/bvh.py);
//   tris [Tpad, 24]: the affine operands of each triangle in BVH order
//     (geometry/packet.py::prep_tables); rows past the last triangle are all
//     zero and reject as parallel, rows at or past Tpad are absent.
// K4 returns the closest hit in [tmin, tmax], exact-t ties to the lower
// triangle index; K5 whether any triangle lies in that range. A miss is
// t = 3.4e38, prim = -1; rays with tmax < tmin (dead lanes at -3.4e38,
// padding at -1) are not live and miss.
//
// The TPU kernel sweeps a supercluster's 512 rows for a whole block of 128
// rays when any of them enters its box: on its matrix unit that costs what
// a single ray would. Here each thread runs its own tests, so the work is
// culled per ray, at two levels, and the tests that survive are spread over
// the whole block:
//   1. cull: one thread per ray walks the supercluster boxes in ascending
//      order, staged in shared memory in chunks of kChunk rows by
//      asynchronous copies (cp.async), double-buffered, so the table streams
//      at any size. Each group of kGroup boxes is slab-tested at the range
//      [tmin, min(best t, tmax)] of the group's start (K5: [tmin, tmax], rays
//      not yet occluded), and one block vote decides which of the group's
//      superclusters some ray of the block may enter.
//   2. pairs: for each such supercluster, in order, each thread whose ray
//      voted for it tests the box again at its current range (this is
//      cluster_plain's cull, decision for decision) and, when it enters,
//      the supercluster's 8 cluster boxes, widened by kBoxRel of
//      |coordinate| + |origin| so that a hit on a box face (room's walls lie
//      on them) survives rounding. Each entered cluster becomes a
//      (ray, cluster) pair in a shared list.
//   3. sweep: the block's 128 threads take the list's (pair, row) items in
//      turn, 64 rows a pair, so a warp tests 32 rows of one cluster against
//      one ray: rows read coalesced through the read-only path (room's 10 MB
//      of rows stay in the 50 MB L2), the ray broadcast from shared memory.
//      A K4 hit counts when it lies in [tmin, tmax] and below the ray's best
//      t at the supercluster's start; the warp reduces its hits to the least
//      (t, row) and merges it into the ray's 64-bit key (order bits of t,
//      row) by a shared atomicMin: the least t, ties to the lower row,
//      whatever order the items run in. This is the twin's rule (strict <
//      across superclusters in ascending order, first row within one). K5
//      sets the ray's flag at its first hit; flagged rays take no more items
//      and the block leaves when every live ray is answered.
//   4. K4 recomputes t, u and v of the winner from its row.
// The tests are geometry.cuh's, in full float32: the TPU's contraction on
// its matrix unit becomes each thread's affine test, rounded as the plain
// twin rounds it (tri_test_rn, no FMA), so the culls and the answers are
// cluster_plain's bit for bit. Every slab reject is a comparison that is
// false on NaN, so padding rows never hit, and rows at or past Tpad are
// not read.
//
// The bound is the triangle tests that survive the two culls (~3 clusters
// of 64 rows per ray on room's mix), each a 96-byte row read from L2, and
// the block's walk over the supercluster table; there is no scene-size cap.
// Shared memory: 2 x kChunk staged rows (16 KB), the block's rays, keys and
// pair list (~7.5 KB).
//
// Each entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cstdint>

#include "geometry.cuh"

namespace {

constexpr int kThreads = 128;    // rays per block
constexpr int kBlocksPerSM = 8;  // resident blocks the registers are sized for (ptxas spills without it)
constexpr int kChunk = 256;      // supercluster rows per staged chunk
constexpr int kGroup = 8;        // supercluster boxes slab-tested per block vote
constexpr int kSupClusters = 8;  // clusters per supercluster (bvh.py SUP)
constexpr int kWin = 64;         // triangle rows per cluster (bvh.py CLUSTER_K)
constexpr float kBoxRel = 1.52587890625e-05f;  // 2^-16: cluster box widening
constexpr int kRowF4 = tt::kTriFloats / 4;      // float4 per triangle row
constexpr int kBoxF4 = 2;                       // float4 per box row
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;  // K4: no hit yet; K5: not occluded

static_assert(kThreads == 128 && kSupClusters == 8, "a pair packs the thread in 7 bits, the cluster in 3");
static_assert(kChunk % kGroup == 0 && kWin % 32 == 0, "groups and warps tile the chunk and the cluster");

struct Shared {
  float4 sup[2][kChunk * kBoxF4];                // staged supercluster boxes, two chunks
  float4 ray[2][kThreads];                       // (o, tmin), (d, tmax) of each thread's ray
  unsigned long long key[kThreads];              // K4: (order bits of t, row); K5: 0 once occluded
  float best[kThreads];                          // K4: best t at the supercluster's start
  unsigned short pair[kThreads * kSupClusters];  // thread | cluster << 7
  int npair[2];
  unsigned vote[2][kThreads / 32];
};

// float -> uint32 whose unsigned order is the float order (-0 reads as +0)
__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_float(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issue the copies of supercluster rows first .. first + rows - 1.
__device__ __forceinline__ void stage(float4* dst, const float4* __restrict__ sup, int first, int rows) {
  for (int k = threadIdx.x; k < rows * kBoxF4; k += kThreads)
    copy16(dst + k, sup + static_cast<size_t>(first) * kBoxF4 + k);
}

__device__ __forceinline__ bool box_hit(float4 a, float4 b, const tt::Ray& r, float tcap) {
  float tlo;
  return tt::slab_hit(a.x, a.y, a.z, a.w, b.x, b.y, r, tcap, tlo);
}

// A cluster box, widened by kBoxRel (|coordinate| + |origin|) on every face
// (a power of two: the product is exact, so contraction changes nothing).
__device__ __forceinline__ float widen_lo(float l, float o) { return l - kBoxRel * (fabsf(l) + fabsf(o)); }
__device__ __forceinline__ float widen_hi(float h, float o) { return h + kBoxRel * (fabsf(h) + fabsf(o)); }

__device__ __forceinline__ bool cluster_hit(const float4* __restrict__ cl_aabb, int cl, const tt::Ray& r,
                                            float tcap) {
  const float4 a = __ldg(cl_aabb + kBoxF4 * cl), b = __ldg(cl_aabb + kBoxF4 * cl + 1);
  float tlo;
  return tt::slab_hit(widen_lo(a.x, r.ox), widen_lo(a.y, r.oy), widen_lo(a.z, r.oz), widen_hi(a.w, r.ox),
                      widen_hi(b.x, r.oy), widen_hi(b.y, r.oz), r, tcap, tlo);
}

__device__ __forceinline__ bool row_test(const float4* __restrict__ tris, int row, const tt::Ray& r, float& t,
                                         float& u, float& v) {
  const float4* p = tris + static_cast<size_t>(row) * kRowF4;
  return tt::tri_test_rn(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 4), __ldg(p + 5), r, t, u, v);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    cluster_kernel(const float4* __restrict__ sup_aabb, int n_sup, const float4* __restrict__ cl_aabb, int n_cl,
                   const float4* __restrict__ tris, int tpad, const float* __restrict__ ro,
                   const float* __restrict__ rd, const float* __restrict__ tmin,
                   const float* __restrict__ tmax, int n, float* __restrict__ t_out,
                   float* __restrict__ u_out, float* __restrict__ v_out, int* __restrict__ prim_out,
                   unsigned char* __restrict__ occ_out) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kThreads + tid;
  tt::Ray r{};
  bool live = false;
  if (i < n) {
    r = tt::load_ray(ro, rd, tmin, tmax, i);
    live = r.tmax >= r.tmin;
  }
  sh.ray[0][tid] = make_float4(r.ox, r.oy, r.oz, r.tmin);
  sh.ray[1][tid] = make_float4(r.dx, r.dy, r.dz, r.tmax);
  sh.key[tid] = kNoKey;
  if (tid < 2) sh.npair[tid] = 0;
  float best_t = tt::kBig;  // K4: the best hit so far (3.4e38: none)
  int best = -1;
  bool occ = false;  // K5
  int parity = 0, vote_parity = 0;

  const int n_chunks = (n_sup + kChunk - 1) / kChunk;
  if (n_chunks > 0) stage(sh.sup[0], sup_aabb, 0, min(kChunk, n_sup));
  commit_copies();
  bool done = false;
  for (int ch = 0; ch < n_chunks && !done; ++ch) {
    const int first = ch * kChunk, rows = min(kChunk, n_sup - first);
    // the other buffer's last reads were before a barrier every thread has passed
    if (ch + 1 < n_chunks)
      stage(sh.sup[(ch + 1) & 1], sup_aabb, first + kChunk, min(kChunk, n_sup - first - kChunk));
    commit_copies();
    wait_copies<1>();
    __syncthreads();
    const float4* box = sh.sup[ch & 1];
    for (int g = 0; g < rows; g += kGroup) {
      // ---- 1. cull: the group's boxes at the range of the group's start ----
      const bool pending = live && !occ;
      const float tcap = kAnyHit ? r.tmax : (best_t < r.tmax ? best_t : r.tmax);
      unsigned mask = 0;
      if (pending) {
#pragma unroll
        for (int w = 0; w < kGroup; ++w)
          if (box_hit(box[kBoxF4 * (g + w)], box[kBoxF4 * (g + w) + 1], r, tcap)) mask |= 1u << w;
      }
      // block vote: the OR of the masks; bit kGroup: some live ray is unanswered
      const unsigned wv = __reduce_or_sync(kFull, mask | (pending ? 1u << kGroup : 0u));
      if (lane == 0) sh.vote[vote_parity][warp] = wv;
      __syncthreads();
      unsigned any = 0;
#pragma unroll
      for (int k = 0; k < kThreads / 32; ++k) any |= sh.vote[vote_parity][k];
      vote_parity ^= 1;
      if (kAnyHit && !(any >> kGroup)) {
        done = true;
        break;
      }
      any &= (1u << kGroup) - 1;
      while (any) {
        const int w = __ffs(any) - 1;
        any &= any - 1;
        const int sup = first + g + w;
        // ---- 2. pairs: the supercluster at the current range, then its clusters ----
        const float cap = kAnyHit ? r.tmax : (best_t < r.tmax ? best_t : r.tmax);
        unsigned cmask = 0;
        if (((mask >> w) & 1u) && !occ &&
            (kAnyHit || box_hit(box[kBoxF4 * (g + w)], box[kBoxF4 * (g + w) + 1], r, cap))) {
#pragma unroll
          for (int c = 0; c < kSupClusters; ++c) {
            const int cl = sup * kSupClusters + c;
            if (cl < n_cl && cluster_hit(cl_aabb, cl, r, cap)) cmask |= 1u << c;
          }
        }
        const int cnt = __popc(cmask);
        int incl = cnt;  // inclusive scan of the warp's pair counts
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        int base = 0;
        if (lane == 31 && incl) base = atomicAdd(&sh.npair[parity], incl);
        int pos = __shfl_sync(kFull, base, 31) + incl - cnt;
        for (unsigned m = cmask; m; m &= m - 1)
          sh.pair[pos++] = static_cast<unsigned short>(tid | (__ffs(m) - 1) << 7);
        if (!kAnyHit) sh.best[tid] = best_t;
        __syncthreads();
        // ---- 3. sweep: the block takes the (pair, row) items in turn ----
        const int items = sh.npair[parity] * kWin;  // a multiple of 64: each warp's items share one pair
        if (tid == 0) sh.npair[parity ^ 1] = 0;
        parity ^= 1;
        for (int k = tid; k < items; k += kThreads) {
          const unsigned p = sh.pair[k / kWin];
          const int ray = p & (kThreads - 1);
          if (kAnyHit && __shfl_sync(kFull, sh.key[ray] == 0ull, 0)) continue;  // answered
          const int row = (sup * kSupClusters + static_cast<int>(p >> 7)) * kWin + (k & (kWin - 1));
          const float4 o = sh.ray[0][ray], d = sh.ray[1][ray];
          tt::Ray q{};
          q.ox = o.x, q.oy = o.y, q.oz = o.z, q.dx = d.x, q.dy = d.y, q.dz = d.z;
          float t = 0.0f, u, v;
          bool ok = row < tpad && row_test(tris, row, q, t, u, v) && t >= o.w && t <= d.w;
          if (kAnyHit) {
            if (__any_sync(kFull, ok) && lane == 0) sh.key[ray] = 0ull;
          } else {
            ok = ok && t < sh.best[ray];
            const unsigned hi = ok ? order_bits(t) : kFull;
            const unsigned m = __reduce_min_sync(kFull, hi);
            const unsigned lo = __reduce_min_sync(kFull, hi == m ? static_cast<unsigned>(row) : kFull);
            if (lane == 0 && m != kFull) atomicMin(&sh.key[ray], static_cast<unsigned long long>(m) << 32 | lo);
          }
        }
        __syncthreads();
        const unsigned long long key = sh.key[tid];
        if (kAnyHit) {
          occ = key == 0ull;
        } else if (key != kNoKey) {
          best_t = order_float(static_cast<uint32_t>(key >> 32));
          best = static_cast<int>(key & 0xffffffffull);
        }
      }
    }
  }
  wait_copies<0>();
  if (i >= n) return;
  if (kAnyHit) {
    occ_out[i] = occ ? 1 : 0;
    return;
  }
  // ---- 4. the winner's t, u, v from its row ----
  float t = tt::kBig, u = 0.0f, v = 0.0f;
  int prim = -1;
  if (best >= 0 && best_t <= r.tmax) {
    row_test(tris, best, r, t, u, v);
    prim = best;
  }
  t_out[i] = t;
  u_out[i] = u;
  v_out[i] = v;
  prim_out[i] = prim;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int tt_cluster_closest(const float* sup_aabb, int n_sup, const float* cl_aabb, int n_cl,
                                  const float* tris, int tpad, const float* ro, const float* rd,
                                  const float* tmin, const float* tmax, int n, float* t_out, float* u_out,
                                  float* v_out, int* prim_out, void* stream) {
  if (n == 0) return 0;
  cluster_kernel<false><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(sup_aabb), n_sup, reinterpret_cast<const float4*>(cl_aabb), n_cl,
      reinterpret_cast<const float4*>(tris), tpad, ro, rd, tmin, tmax, n, t_out, u_out, v_out, prim_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_cluster_occluded(const float* sup_aabb, int n_sup, const float* cl_aabb, int n_cl,
                                   const float* tris, int tpad, const float* ro, const float* rd,
                                   const float* tmin, const float* tmax, int n, unsigned char* occ_out,
                                   void* stream) {
  if (n == 0) return 0;
  cluster_kernel<true><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(sup_aabb), n_sup, reinterpret_cast<const float4*>(cl_aabb), n_cl,
      reinterpret_cast<const float4*>(tris), tpad, ro, rd, tmin, tmax, n, nullptr, nullptr, nullptr, nullptr,
      occ_out);
  return static_cast<int>(cudaGetLastError());
}
