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
// The answer is geometry/sweep.py::sweep_plain's, bit for bit: over every
// cluster whose box passes the slab test at [tmin, tmax], the least (t,
// prim) of the triangles hit in [tmin, tmax] (exact-t ties to the lower
// prim), or with any hit whether there is one. A miss is t = 3.4e38,
// prim = -1; rays with tmax < tmin (dead lanes at -3.4e38, padding at -1)
// are not live and miss. Clusters at or past ceil(n_tri / 64) are padding
// and are not read.
//
// The TPU kernel culls per block of 128 rays (a cluster is kept when any
// ray enters it), sorts the union near first and sweeps it group by group
// until the block's worst running best is passed: on its matrix unit a
// cluster costs the block what it costs one ray. Here each thread runs its
// own tests, so every ray would pay for the block's union (7,589 rows a
// live ray on room's mix, against the ~3 clusters, 176 rows, of its own).
// So the cull is per ray, and the TPU's sort and its block stop rule are
// gone: the twin is order-free, and a per-ray cull in any order with a
// merge by the least (t, prim) is the same answer.
//   1. cull: one thread per ray walks the cluster boxes in ascending order,
//      staged in shared memory in chunks of kChunk boxes by asynchronous
//      copies (cp.async), double-buffered, so the table streams at any
//      size. A cluster becomes a (ray, cluster) pair in the block's shared
//      list when (a) its box passes the twin's own slab test at [tmin,
//      tmax] and, for closest hits, (b) the box widened by kBoxRel of
//      |coordinate| + |origin| is entered at [tmin, min(best t, tmax)].
//      (a) is the twin's decision (a cluster it does not test must not be
//      tested); (b) drops clusters that cannot beat the best hit so far,
//      and the widening keeps a hit on a box face (room's walls lie on
//      them) whose t rounds below the box's entry distance. Any hit takes
//      (a) alone, for rays not yet answered.
//      The walk is most of the work (room: 1,657 boxes a ray, ~3 entered),
//      so the block first builds, from each chunk it stages, the union box
//      of every kGroup consecutive boxes, and a ray tests the members of a
//      group only when it enters the group's box (any hit: at [tmin,
//      tmax]; closest hit: widened, at [tmin, min(best t, tmax)]). Slab
//      tests are monotone in the box, so a group that a ray does not enter
//      holds no pair, and the pairs are the same. No tree is read: the
//      groups are made from cl_aabb alone, in the kernel.
//   2. sweep: when the list is full (a thread that cannot append stops and
//      takes the same box again after) or the chunk is walked, the block's
//      128 threads take the list's (pair, row) items in turn, 64 rows a
//      pair, so a warp tests 32 rows of one cluster against one ray: rows
//      read coalesced through the read-only path (room's 10 MB of rows stay
//      in the 50 MB L2), the ray broadcast from shared memory. Closest hit:
//      the warp reduces its hits to the least (order bits of t, prim) and
//      merges it into the ray's 64-bit key by a shared atomicMin, the
//      least t, ties to the lower prim, in any order; the key's t caps the
//      ray's range for the rest of the walk. Any hit: the ray's flag is set
//      at its first hit; answered rays take no more items, and the block
//      leaves when every live ray is answered.
//   3. closest hit recomputes t, u and v of the winner from its row.
// The tests are in full float32: the slab test with NaN-propagating
// min/max (the twin's torch.minimum/maximum; a NaN box never passes), the
// triangle test rounded as the twin rounds it (geometry.cuh::tri_test_rn,
// no FMA), so the culls and the answers are sweep_plain's bit for bit.
//
// The bound is the walk, ~100 group boxes and the members of the entered
// groups a ray (room), and the rows of the clusters that survive the cull
// (~3 clusters of 64 rows a ray on room's mix), each a 96-byte row read from L2;
// there is no scene size cap. Shared memory: 2 x kChunk staged boxes (16
// KB), their group boxes, the block's rays, keys and pair list (~7 KB).
//
// Each entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cstdint>

#include "geometry.cuh"

namespace {

constexpr int kThreads = 128;    // rays per block
constexpr int kBlocksPerSM = 8;  // resident blocks the registers are sized for
constexpr int kChunk = 256;      // cluster boxes per staged chunk
constexpr int kPairs = 256;      // (ray, cluster) pairs the block's list holds
constexpr int kGroup = 16;       // cluster boxes under one group box of the walk
constexpr int kWin = 64;         // triangle rows per cluster (bvh.py CLUSTER_K)
constexpr float kBoxRel = 1.52587890625e-05f;  // 2^-16: box widening of the cull (b)
constexpr int kRowF4 = tt::kTriFloats / 4;      // float4 per triangle row
constexpr int kBoxF4 = 2;                       // float4 per box row
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;  // closest: no hit yet; any hit: not occluded

static_assert(kThreads == 128, "a pair packs the thread in 7 bits, the cluster above them");
static_assert(kChunk % kGroup == 0, "groups tile the chunk");
static_assert(kWin % 32 == 0 && (kThreads * 2) % kWin == 0, "each warp's 32 items share one pair");

struct Shared {
  float4 box[2][kChunk * kBoxF4];    // staged cluster boxes, two chunks
  float4 grp[2][kChunk / kGroup * kBoxF4];  // the union box of each kGroup staged boxes
  float4 ray[2][kThreads];           // (o, tmin), (d, tmax) of each thread's ray
  unsigned long long key[kThreads];  // closest: (order bits of t, prim); any hit: 0 once occluded
  unsigned pair[kPairs];             // thread | cluster << 7
  int npair[2];
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

// Issue the copies of box rows first .. first + rows - 1.
__device__ __forceinline__ void stage(float4* dst, const float4* __restrict__ boxes, int first, int rows) {
  for (int k = threadIdx.x; k < rows * kBoxF4; k += kThreads)
    copy16(dst + k, boxes + static_cast<size_t>(first) * kBoxF4 + k);
}

// min and max that return NaN when either operand is NaN (PTX .NaN, sm_80+)
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The slab test of box (lo, hi) at [tmin, tcap] as geometry/packet.py::slab
// decides it: tlo = max of the per-axis entries, thi = min of the exits,
// NaN carried through, hit = tlo <= thi & thi >= tmin & tlo <= tcap. Folded
// into max(tlo, tmin) <= min(thi, tcap), which adds tmin <= tcap: true for
// a live ray at tcap = tmax, and at any best t (hits lie at or past tmin).
__device__ __forceinline__ bool slab_nan(float lx, float ly, float lz, float hx, float hy, float hz,
                                         const tt::Ray& r, float tcap) {
  const float ax = (lx - r.ox) * r.ix, bx = (hx - r.ox) * r.ix;
  const float ay = (ly - r.oy) * r.iy, by = (hy - r.oy) * r.iy;
  const float az = (lz - r.oz) * r.iz, bz = (hz - r.oz) * r.iz;
  const float t0 = max_nan(max_nan(min_nan(ax, bx), min_nan(ay, by)), max_nan(min_nan(az, bz), r.tmin));
  const float t1 = min_nan(min_nan(max_nan(ax, bx), max_nan(ay, by)), min_nan(max_nan(az, bz), tcap));
  return t0 <= t1;
}

// The box widened by kBoxRel (|coordinate| + |origin|) on every face (a
// power of two: the product is exact, so contraction changes nothing).
__device__ __forceinline__ float widen_lo(float l, float o) { return l - kBoxRel * (fabsf(l) + fabsf(o)); }
__device__ __forceinline__ float widen_hi(float h, float o) { return h + kBoxRel * (fabsf(h) + fabsf(o)); }

__device__ __forceinline__ bool widened_hit(float4 a, float4 b, const tt::Ray& r, float tcap) {
  return slab_nan(widen_lo(a.x, r.ox), widen_lo(a.y, r.oy), widen_lo(a.z, r.oz), widen_hi(a.w, r.ox),
                  widen_hi(b.x, r.oy), widen_hi(b.y, r.oz), r, tcap);
}

__device__ __forceinline__ bool row_test(const float4* __restrict__ tris, int row, const tt::Ray& r, float& t,
                                         float& u, float& v) {
  const float4* p = tris + static_cast<size_t>(row) * kRowF4;
  return tt::tri_test_rn(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 4), __ldg(p + 5), r, t, u, v);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    sweep_kernel(const float4* __restrict__ cl_aabb, int n_cl, const float4* __restrict__ tris, int n_rows,
                 const float* __restrict__ ro, const float* __restrict__ rd, const float* __restrict__ tmin,
                 const float* __restrict__ tmax, int n, float* __restrict__ t_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, int* __restrict__ prim_out, unsigned char* __restrict__ occ_out) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31;
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
  float best_t = tt::kBig;  // closest: the best hit after the last sweep (3.4e38: none)
  bool occ = false;         // any hit
  int parity = 0;

  // clusters past the last triangle are padding (the twin stops there)
  const int n_walk = min(n_cl, (n_rows + kWin - 1) / kWin);
  const int n_chunks = (n_walk + kChunk - 1) / kChunk;
  if (n_chunks > 0) stage(sh.box[0], cl_aabb, 0, min(kChunk, n_walk));
  commit_copies();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int first = ch * kChunk, last = min(first + kChunk, n_walk);
    // the other buffer's last reads were before a barrier every thread has passed
    if (ch + 1 < n_chunks) stage(sh.box[(ch + 1) & 1], cl_aabb, last, min(kChunk, n_walk - last));
    commit_copies();
    wait_copies<1>();
    __syncthreads();
    const float4* box = sh.box[ch & 1];
    float4* grp = sh.grp[ch & 1];  // the chunk's group boxes
    for (int g = tid; g * kGroup < last - first; g += kThreads) {
      float4 lo = box[kBoxF4 * g * kGroup], hi = box[kBoxF4 * g * kGroup + 1];
      for (int k = g * kGroup + 1; k < min(g * kGroup + kGroup, last - first); ++k) {
        const float4 a = box[kBoxF4 * k], b = box[kBoxF4 * k + 1];  // fminf/fmaxf skip a NaN box
        lo = make_float4(fminf(lo.x, a.x), fminf(lo.y, a.y), fminf(lo.z, a.z), fmaxf(lo.w, a.w));
        hi = make_float4(fmaxf(hi.x, b.x), fmaxf(hi.y, b.y), 0.0f, 0.0f);
      }
      grp[kBoxF4 * g] = lo;
      grp[kBoxF4 * g + 1] = hi;
    }
    __syncthreads();
    int c = live && !occ ? first : last;  // this thread's next box
    bool again = true;
    while (again) {
      // ---- 1. cull: this ray's boxes, by groups, until the chunk ends or the list is full ----
      const float cap = kAnyHit ? r.tmax : (best_t < r.tmax ? best_t : r.tmax);
      bool full = false;
      while (c < last && !full) {
        const int g = (c - first) / kGroup, end = min(first + (g + 1) * kGroup, last);
        const float4 ga = grp[kBoxF4 * g], gb = grp[kBoxF4 * g + 1];
        if (kAnyHit ? !slab_nan(ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, r, r.tmax) : !widened_hit(ga, gb, r, cap)) {
          c = end;
          continue;
        }
        for (; c < end; ++c) {
          const float4 a = box[kBoxF4 * (c - first)], b = box[kBoxF4 * (c - first) + 1];
          if (!slab_nan(a.x, a.y, a.z, a.w, b.x, b.y, r, r.tmax)) continue;  // (a)
          if (!kAnyHit && !widened_hit(a, b, r, cap)) continue;               // (b)
          const int k = atomicAdd(&sh.npair[parity], 1);
          if (k >= kPairs) {
            full = true;  // box c again after the sweep
            break;
          }
          sh.pair[k] = static_cast<unsigned>(tid) | static_cast<unsigned>(c) << 7;
        }
      }
      again = __syncthreads_or(full);
      // ---- 2. sweep: the block takes the (pair, row) items in turn ----
      const int items = min(sh.npair[parity], kPairs) * kWin;  // a multiple of 64
      if (tid == 0) sh.npair[parity ^ 1] = 0;
      for (int k = tid; k < items; k += kThreads) {
        const unsigned p = sh.pair[k / kWin];
        const int ray = p & (kThreads - 1);
        if (kAnyHit && __shfl_sync(kFull, sh.key[ray] == 0ull, 0)) continue;  // answered
        const int row = static_cast<int>(p >> 7) * kWin + (k & (kWin - 1));
        const float4 o = sh.ray[0][ray], d = sh.ray[1][ray];
        tt::Ray q{};
        q.ox = o.x, q.oy = o.y, q.oz = o.z, q.dx = d.x, q.dy = d.y, q.dz = d.z;
        float t = 0.0f, u, v;
        const bool ok = row < n_rows && row_test(tris, row, q, t, u, v) && t >= o.w && t <= d.w;
        if (kAnyHit) {
          if (__any_sync(kFull, ok) && lane == 0) sh.key[ray] = 0ull;
        } else {
          const unsigned hi = ok ? order_bits(t) : kFull;
          const unsigned m = __reduce_min_sync(kFull, hi);
          const unsigned lo = __reduce_min_sync(kFull, hi == m ? static_cast<unsigned>(row) : kFull);
          if (lane == 0 && m != kFull) atomicMin(&sh.key[ray], static_cast<unsigned long long>(m) << 32 | lo);
        }
      }
      parity ^= 1;
      __syncthreads();
      const unsigned long long key = sh.key[tid];
      if (kAnyHit) {
        occ = key == 0ull;
        if (occ) c = last;
      } else if (key != kNoKey) {
        best_t = order_float(static_cast<uint32_t>(key >> 32));
      }
    }
    if (kAnyHit && !__syncthreads_or(live && !occ)) break;  // every live ray is answered
  }
  wait_copies<0>();
  if (i >= n) return;
  if (kAnyHit) {
    occ_out[i] = occ ? 1 : 0;
    return;
  }
  // ---- 3. the winner's t, u, v from its row ----
  const unsigned long long key = sh.key[tid];
  float t = tt::kBig, u = 0.0f, v = 0.0f;
  int prim = -1;
  if (key != kNoKey) {
    prim = static_cast<int>(key & 0xffffffffull);
    row_test(tris, prim, r, t, u, v);
  }
  t_out[i] = t;
  u_out[i] = u;
  v_out[i] = v;
  prim_out[i] = prim;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int tt_sweep_closest(const float* cl_aabb, int n_cl, const float* tris, int tpad, int n_tri,
                                const float* ro, const float* rd, const float* tmin, const float* tmax, int n,
                                float* t_out, float* u_out, float* v_out, int* prim_out, void* stream) {
  if (n == 0) return 0;
  sweep_kernel<false><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(cl_aabb), n_cl, reinterpret_cast<const float4*>(tris), n_tri < tpad ? n_tri : tpad, ro,
      rd, tmin, tmax, n, t_out, u_out, v_out, prim_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_sweep_occluded(const float* cl_aabb, int n_cl, const float* tris, int tpad, int n_tri,
                                 const float* ro, const float* rd, const float* tmin, const float* tmax, int n,
                                 unsigned char* occ_out, void* stream) {
  if (n == 0) return 0;
  sweep_kernel<true><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(cl_aabb), n_cl, reinterpret_cast<const float4*>(tris), n_tri < tpad ? n_tri : tpad, ro,
      rd, tmin, tmax, n, nullptr, nullptr, nullptr, nullptr, occ_out);
  return static_cast<int>(cudaGetLastError());
}
