// Wide-BVH traversal for Hopper (sm_90a): closest hit and any hit (K3).
//
// Replaces take_tpu/geometry/pallas_traverse.py::_kernel (entry
// packet_traverse, static any_hit) and computes what it computes:
//   closest: the hit in [tmin, tmax] with the least t, ties to the lower
//     primitive ((t < best) | (t == best & prim < best prim)); a miss is
//     t = 3.4e38, prim = -1;
//   any hit: whether a triangle lies in [tmin, tmax]; a ray stops at its
//     first accepted hit.
// Rays with tmax < tmin (dead lanes at -3.4e38, padding at -1) miss without
// a pop. A child is entered when the ray enters its box at a distance
// <= min(best t, tmax) (inclusive: a tie with a lower primitive in a later
// node is not lost), so tmax is honoured during traversal.
//
// Tables (geometry/packet.py::prep_tables, built once per scene upload):
//   qnodes [M', 24] int32: 96-byte nodes (quantize_nodes): origin xyz
//     (float), the biased exponent of each axis's power-of-two scale,
//     8-bit child minima and maxima per axis, and 8 child references
//     (-1 empty; >= 0 an inner node's row; else a leaf,
//     INT_MIN | (count - 1) << 26 | start). A decoded bound is
//     fmaf(q, scale, origin), one rounding of an exact sum, and
//     quantize_nodes checks each value it stores against it, so every
//     decoded box contains its exact box in float32 and the slab test,
//     monotone in its box, enters every child the exact tree would.
//     Children sit in slots by octant: a ray whose direction has sign bits
//     `oct` takes slot s in the order s ^ oct, roughly near first. The
//     inner child in slot j of a node is row base + j.
//   tris [Tpad, 24]: the affine operands of each triangle in BVH order
//     (the rows K4, K5 and K6 read too).
//
// What bounds it on this card: neither bytes nor FLOPs (PERF.md counts
// both) but each ray's chain of dependent loads and the divergence of a
// warp's rays. On room's rays a ray visits ~3 nodes and tests ~11
// triangles (leaves of up to 16), so the triangle rows, 6 loads of 16 bytes
// each from L2 (room's 10 MB of rows sit in the 50 MB L2), take most of
// the time. The design keeps the rest short and the warps many:
//   * no per-thread local memory (ptxas reports 0 bytes of stack frame):
//     the stack holds (base << 8 | mask of children still to visit)
//     entries, one per ancestor with children left, in a per-thread
//     column of shared memory (kStack deep, 8 KB a block of 64); no array
//     is indexed at run time;
//   * a node is 6 loads of 16 bytes, not 16 of the exact rows; a pop reads
//     nothing from global memory (the child's row is base + slot);
//   * the nearest hit inner child is entered at once, the others wait as
//     one entry and are taken in octant order; leaves are swept as their
//     node is visited;
//   * decoded boxes are finite, so the slab test takes fminf/fmaxf;
//   * one thread per ray in blocks of 64 (persistent warps that fetch rays
//     from a counter lost on room's and textured's rays: PERF.md).
// A tree of wide depth D needs D - 1 entries; the host checks
// depth <= tt_packet_stack_size() before every launch and raises when it
// does not fit, so no node is ever dropped (a push past the end would trap,
// not write).
//
// Each entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include "geometry.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kWidth = 8;
constexpr int kStack = 32;
constexpr int kEmpty = -1;

// The 8-bit value in byte (j & 3) of word `w`, as an exact float.
__device__ __forceinline__ float qbyte(unsigned w, int j) {
  // 0x4B0000qq is the float 2^23 + qq
  return __uint_as_float(__byte_perm(w, 0x4B00u, (j & 3) | 0x5440)) -
         8388608.0f;
}

// Reference of slot j (0..7) out of two int4 words, by selects rather
// than an indexed array (which would live in local memory).
__device__ __forceinline__ int pick(int4 a, int4 b, int j) {
  const int4 c = (j & 4) ? b : a;
  const int x = (j & 2) ? c.z : c.x;
  const int y = (j & 2) ? c.w : c.y;
  return (j & 1) ? y : x;
}

__device__ __forceinline__ unsigned word_of(uint4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Slab test of a decoded box at [tmin, tcap]. Decoded bounds are finite,
// so for a ray without NaN fminf/fmaxf order each axis's plane distances
// exactly as slab_hit's comparisons do and give its answer (a NaN ray
// enters boxes here that slab_hit refuses, but no triangle test accepts
// it).
__device__ __forceinline__ bool qslab(float lx, float ly, float lz, float hx,
                                      float hy, float hz, const tt::Ray& r,
                                      float tcap, float& t0) {
  const float ax = (lx - r.ox) * r.ix, bx = (hx - r.ox) * r.ix;
  const float ay = (ly - r.oy) * r.iy, by = (hy - r.oy) * r.iy;
  const float az = (lz - r.oz) * r.iz, bz = (hz - r.oz) * r.iz;
  t0 = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
             fmaxf(fminf(az, bz), r.tmin));
  const float t1 = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                         fminf(fmaxf(az, bz), tcap));
  return t0 <= t1;
}

template <bool kAnyHit>
__device__ __forceinline__ void trace(const int4* __restrict__ qnodes,
                                      const float4* __restrict__ tris,
                                      const tt::Ray& r, unsigned* stack,
                                      float& best_t, float& best_u,
                                      float& best_v, int& best) {
  const int oct =
      (r.dx < 0.0f ? 1 : 0) | (r.dy < 0.0f ? 2 : 0) | (r.dz < 0.0f ? 4 : 0);
  int sp = 0;
  int node = 0;  // root
  while (true) {
    // visit `node`: test its children's boxes, sweep its hit leaves, enter
    // its nearest hit inner child, keep the others as one entry
    const int4* p = qnodes + 6 * node;
    const float4 head = __ldg(reinterpret_cast<const float4*>(p));
    const uint4 bx = __ldg(reinterpret_cast<const uint4*>(p + 1));
    const uint4 by = __ldg(reinterpret_cast<const uint4*>(p + 2));
    const uint4 bz = __ldg(reinterpret_cast<const uint4*>(p + 3));
    const int4 r0 = __ldg(p + 4), r1 = __ldg(p + 5);
    const unsigned e = __float_as_uint(head.w);
    const float sx = __uint_as_float((e & 0xFFu) << 23);
    const float sy = __uint_as_float(((e >> 8) & 0xFFu) << 23);
    const float sz = __uint_as_float(((e >> 16) & 0xFFu) << 23);
    const float tcap = best_t < r.tmax ? best_t : r.tmax;
    unsigned inner = 0, leaves = 0;  // slot j at bit j ^ oct
    float near_t = tt::kBig;         // the nearest hit inner child
    int near_j = 0;
#pragma unroll
    for (int j = 0; j < kWidth; ++j) {
      const int ref = pick(r0, r1, j);
      const int k = j >> 2;  // word of the slot's minima (maxima: k + 2)
      float t0;
      if (ref == kEmpty ||
          !qslab(fmaf(qbyte(word_of(bx, k), j), sx, head.x),
                 fmaf(qbyte(word_of(by, k), j), sy, head.y),
                 fmaf(qbyte(word_of(bz, k), j), sz, head.z),
                 fmaf(qbyte(word_of(bx, k + 2), j), sx, head.x),
                 fmaf(qbyte(word_of(by, k + 2), j), sy, head.y),
                 fmaf(qbyte(word_of(bz, k + 2), j), sz, head.z), r, tcap, t0))
        continue;
      if (ref < 0) {
        leaves |= 1u << (j ^ oct);
      } else {
        inner |= 1u << (j ^ oct);
        if (t0 < near_t) {
          near_t = t0;
          near_j = j;
        }
      }
    }
    while (leaves) {  // leaves, in octant order
      const int j = (__ffs(leaves) - 1) ^ oct;
      leaves &= leaves - 1;
      const int ref = pick(r0, r1, j);
      const int start = ref & ((1 << 26) - 1);
      const int end = start + ((ref >> 26) & 31) + 1;
      for (int prim = start; prim < end; ++prim) {
        const float4* row = tris + 6 * prim;
        float t, u, v;
        if (tt::tri_test(__ldg(row), __ldg(row + 1), __ldg(row + 2),
                         __ldg(row + 3), __ldg(row + 4), __ldg(row + 5), r, t,
                         u, v) &&
            t >= r.tmin && t <= r.tmax && t <= best_t &&
            (t < best_t || prim < best)) {
          best_t = t;
          best_u = u;
          best_v = v;
          best = prim;
          if (kAnyHit) return;
        }
      }
    }
    if (inner) {  // enter the nearest, keep the rest
      const int next = pick(r0, r1, near_j);
      inner &= ~(1u << (near_j ^ oct));
      if (inner) {  // the children of a node are nodes base + slot
        if (sp >= kStack) __trap();  // excluded by the host's depth check
        stack[sp++ * kThreads] =
            static_cast<unsigned>(next - near_j) << 8 | inner;
      }
      node = next;
      continue;
    }
    if (sp == 0) return;
    // pop: the next child of the top entry; the entry stays while it has more
    const unsigned top = stack[(sp - 1) * kThreads];
    const unsigned rest = top & (top - 1) & 0xFFu;
    node = static_cast<int>(top >> 8) + ((__ffs(top & 0xFFu) - 1) ^ oct);
    if (rest) stack[(sp - 1) * kThreads] = (top & ~0xFFu) | rest;
    else --sp;
  }
}

// Trace ray i and write its answer.
template <bool kAnyHit>
__device__ __forceinline__ void one_ray(
    const int4* __restrict__ qnodes, const float4* __restrict__ tris,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin, const float* __restrict__ tmax, int i,
    unsigned* stack, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ prim_out,
    unsigned char* __restrict__ occ_out) {
  const tt::Ray r = tt::load_ray(ro, rd, tmin, tmax, i);
  float best_t = tt::kBig, best_u = 0.0f, best_v = 0.0f;
  int best = -1;
  if (r.tmax >= r.tmin)
    trace<kAnyHit>(qnodes, tris, r, stack, best_t, best_u, best_v, best);
  const bool ok = best >= 0 && best_t <= r.tmax;
  if (kAnyHit) {
    occ_out[i] = ok ? 1 : 0;
  } else {
    t_out[i] = ok ? best_t : tt::kBig;
    u_out[i] = best_u;
    v_out[i] = best_v;
    prim_out[i] = ok ? best : -1;
  }
}

// One thread per ray, one block per kThreads rays.
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
    packet_kernel(const int4* __restrict__ qnodes,
                  const float4* __restrict__ tris,
                  const float* __restrict__ ro, const float* __restrict__ rd,
                  const float* __restrict__ tmin,
                  const float* __restrict__ tmax, int n,
                  float* __restrict__ t_out, float* __restrict__ u_out,
                  float* __restrict__ v_out, int* __restrict__ prim_out,
                  unsigned char* __restrict__ occ_out) {
  __shared__ unsigned stack[kStack * kThreads];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    one_ray<kAnyHit>(qnodes, tris, ro, rd, tmin, tmax, i, stack + threadIdx.x,
                     t_out, u_out, v_out, prim_out, occ_out);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int tt_packet_stack_size() { return kStack; }

extern "C" int tt_packet_closest(const int* qnodes, const float* tris,
                                 const float* ro, const float* rd,
                                 const float* tmin, const float* tmax, int n,
                                 float* t_out, float* u_out, float* v_out,
                                 int* prim_out, void* stream) {
  if (n == 0) return 0;
  packet_kernel<false>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          reinterpret_cast<const int4*>(qnodes),
          reinterpret_cast<const float4*>(tris), ro, rd, tmin, tmax, n, t_out,
          u_out, v_out, prim_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_packet_occluded(const int* qnodes, const float* tris,
                                  const float* ro, const float* rd,
                                  const float* tmin, const float* tmax, int n,
                                  unsigned char* occ_out, void* stream) {
  if (n == 0) return 0;
  packet_kernel<true>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          reinterpret_cast<const int4*>(qnodes),
          reinterpret_cast<const float4*>(tris), ro, rd, tmin, tmax, n,
          nullptr, nullptr, nullptr, nullptr, occ_out);
  return static_cast<int>(cudaGetLastError());
}
