// Wide-BVH traversal for Hopper (sm_90a): closest hit and any hit (K3).
//
// Replaces take_tpu/geometry/pallas_traverse.py::_kernel (entry
// packet_traverse, static any_hit) and computes what it computes over the
// same kernel layout (geometry/packet.py::prep_tables):
//   nodes [M * 8, 8]: row m * 8 + w = child w of node m, (min xyz, max xyz,
//     child, count) with child and count as floats. child >= 0 is an inner
//     node; child < 0 with count > 0 a leaf over triangle rows
//     [-(child + 1), -(child + 1) + count); child -1 with count 0 an empty
//     slot, skipped by child/count and not by its (inverted) box.
//   tris [Tpad, 24]: the affine operands of each triangle in BVH order.
// Children whose boxes the ray enters within [tmin, min(best t, tmax)] are
// ordered near-first by entry distance (ties keep slot order); the node's
// leaves are tested nearest first and its inner children pushed farthest
// first, so the nearest is popped next. A hit is kept when it lies in
// [tmin, tmax], inside the triangle, and is better by
// (t < best) | (t == best & prim < best prim): the closest hit with ties to
// the lower primitive, whatever the visiting order. t <= tmax is enforced
// during traversal and again at the end. A miss is t = 3.4e38, prim = -1.
// The any-hit entry stops at the first accepted hit of each ray.
//
// Layout: one thread per ray with its own stack, where the TPU shares one
// scalar stack per 256-ray packet and tests every child against all the
// packet's rays. Node and triangle rows are read from global memory through
// the read-only path (__ldg): the tables have no size limit, and room's
// (0.7 MB of nodes, 10 MB of triangles) sit in the 50 MB L2. The bound is
// the latency of the dependent loads of each pop and the divergence of
// neighbouring rays' paths.
//
// The stack holds kStack entries. Each pop pushes at most 8 children and
// removes one, so a tree of wide depth D needs at most 7 D + 1; the host
// checks that bound against tt_packet_stack_size() before every launch and
// raises when it does not fit, so no node is ever dropped (a push past the
// end would trap, not write). Rays with tmax < tmin (dead lanes at
// -3.4e38, padding at -1) miss without a pop.
//
// Each entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include "geometry.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWidth = 8;
constexpr int kStack = 128;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
    packet_kernel(const float4* __restrict__ nodes,
                  const float4* __restrict__ tris,
                  const float* __restrict__ ro, const float* __restrict__ rd,
                  const float* __restrict__ tmin,
                  const float* __restrict__ tmax, int n,
                  float* __restrict__ t_out, float* __restrict__ u_out,
                  float* __restrict__ v_out, int* __restrict__ prim_out,
                  unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const tt::Ray r = tt::load_ray(ro, rd, tmin, tmax, i);
  float best_t = tt::kBig, best_u = 0.0f, best_v = 0.0f;
  int best = -1;
  if (r.tmax >= r.tmin) {
    int stack[kStack];
    int sp = 0;
    stack[sp++] = 0;  // root
    while (sp > 0) {
      const int node = stack[--sp];
      const float tcap = best_t < r.tmax ? best_t : r.tmax;
      // hit children, sorted by entry distance (insertion sort, stable)
      float key[kWidth];
      int child[kWidth], count[kWidth];
      int nhit = 0;
#pragma unroll
      for (int w = 0; w < kWidth; ++w) {
        const float4 p = __ldg(nodes + 2 * (node * kWidth + w));
        const float4 q = __ldg(nodes + 2 * (node * kWidth + w) + 1);
        const int c = static_cast<int>(q.z), k = static_cast<int>(q.w);
        if (c < 0 && k <= 0) continue;  // empty slot
        float tlo;
        if (!tt::slab_hit(p.x, p.y, p.z, p.w, q.x, q.y, r, tcap, tlo)) continue;
        int j = nhit++;
        while (j > 0 && key[j - 1] > tlo) {
          key[j] = key[j - 1];
          child[j] = child[j - 1];
          count[j] = count[j - 1];
          --j;
        }
        key[j] = tlo;
        child[j] = c;
        count[j] = k;
      }
      for (int j = 0; j < nhit; ++j) {  // leaves, nearest first
        if (child[j] >= 0) continue;
        const int start = -(child[j] + 1);
        for (int prim = start; prim < start + count[j]; ++prim) {
          const float4* row = tris + 6 * prim;
          float t, u, v;
          if (tt::tri_test(__ldg(row), __ldg(row + 1), __ldg(row + 2),
                           __ldg(row + 3), __ldg(row + 4), __ldg(row + 5), r,
                           t, u, v) &&
              t >= r.tmin && t <= r.tmax && t <= best_t &&
              (t < best_t || prim < best)) {
            best_t = t;
            best_u = u;
            best_v = v;
            best = prim;
            if (kAnyHit) goto done;
          }
        }
      }
      for (int j = nhit - 1; j >= 0; --j) {  // inner children, farthest first
        if (child[j] < 0) continue;
        if (sp >= kStack) __trap();  // excluded by the host's depth check
        stack[sp++] = child[j];
      }
    }
  }
done:
  const bool ok = best_t <= r.tmax;
  if (kAnyHit) {
    occ_out[i] = ok && best >= 0 ? 1 : 0;
  } else {
    t_out[i] = ok ? best_t : tt::kBig;
    u_out[i] = best_u;
    v_out[i] = best_v;
    prim_out[i] = ok ? best : -1;
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int tt_packet_stack_size() { return kStack; }

extern "C" int tt_packet_closest(const float* nodes, const float* tris,
                                 const float* ro, const float* rd,
                                 const float* tmin, const float* tmax, int n,
                                 float* t_out, float* u_out, float* v_out,
                                 int* prim_out, void* stream) {
  if (n == 0) return 0;
  packet_kernel<false>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          reinterpret_cast<const float4*>(nodes),
          reinterpret_cast<const float4*>(tris), ro, rd, tmin, tmax, n, t_out,
          u_out, v_out, prim_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_packet_occluded(const float* nodes, const float* tris,
                                  const float* ro, const float* rd,
                                  const float* tmin, const float* tmax, int n,
                                  unsigned char* occ_out, void* stream) {
  if (n == 0) return 0;
  packet_kernel<true>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          reinterpret_cast<const float4*>(nodes),
          reinterpret_cast<const float4*>(tris), ro, rd, tmin, tmax, n,
          nullptr, nullptr, nullptr, nullptr, occ_out);
  return static_cast<int>(cudaGetLastError());
}
