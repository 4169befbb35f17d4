// The Disney lobes (take_tpu_torch/materials/disney.py): sample, eval and
// pdf of metal, glass, clearcoat, sheen and the disneybsdf composite, one
// launch for each call of the BSDF dispatch (materials/bsdf.py) and tag.
//
// Replaces no TPU kernel: take_tpu's lobes (take_tpu/materials/disney.py)
// are jnp code that XLA fuses. The port's plain version is hundreds of
// elementwise torch kernels a call, each reading and writing a 2^20-lane
// float tensor: every lobe builds its own shading frame with two to_worlds,
// every local vector is a torch.stack, the composite's sample draws all four
// lobes and its pdf runs three lobe pdfs again. Here a lane's frame, local
// vectors, half vectors, lobe values and pdfs live in registers from its
// inputs to its one output, and the frame is built once a lane.
//
// Bound (bytes over the H100's 3.35 TB/s): a call reads at most ~140 B a
// lane (the tag, the front flag, refl and up to 12 scalars of the shade
// point, both normals, dir_in and dir_out or up to four uniforms) and writes
// 4-16 B, so a 2^20-lane call moves at most ~160 MB: ~47 us. Its arithmetic
// is a few thousand float operations a lane, ~3 GFLOP a call, under a
// millisecond at the card's ~67 TFLOP/s of float32 outside the tensor
// cores. One thread a lane, blocks of kThreads; the shade point is read in
// place, each field through a pointer and a row stride (its scalars are
// columns of the gathered [N, 24] material rows), so the wrapper copies
// nothing.
//
// Each expression is disney.py's (and, for the composite's diffuse parts,
// bsdf.py's _disney_diffuse_eval, _cosine_sample and _cosine_pdf), in the
// same order, with the same clamps, epsilons and selects. Built with
// --fmad=false and without fast math (geometry/_build.py), each float
// operation rounds as torch's separate elementwise kernels round it, and
// sqrtf, sinf, cosf, logf and powf are libdevice's, as torch's kernels call
// them. A sum over a vector's three components (torch.sum, dot) adds them
// in the order torch's reduction kernel does (sum3), and a cross product
// contracts as torch.linalg.cross's kernel does (cross). A clamp passes NaN
// through, as torch.clamp does. The composite's sample computes only the
// lobe that u_lobe picks, which gives what drawing all four and selecting
// gives. A lane whose tag is not the call's tag writes 0; the dispatch
// selects by tag, so those lanes are thrown away.
//
// `extern "C"` keeps each kernel's name as written in a trace
// (take_disney_*). Each tt_disney_* launcher launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

// A field of the shade point: lane i at p[i * s], a vector's component k at
// p[i * s + k].
struct FieldF {
  const float* p;
  int64_t s;
};
struct FieldI {
  const int32_t* p;
  int64_t s;
};
struct FieldB {
  const uint8_t* p;
  int64_t s;
};

// The inputs of a call, in disney.py's _Inputs order. Fields a call does
// not read may be null. Outside the unnamed namespace: the launchers
// (extern "C", exported) take it.
struct Inputs {
  FieldI tag;
  FieldB front;
  FieldF refl, geo_n, sh_n, dir_in, dir_out;
  FieldF eta, roughness, subsurface, anisotropic, metallic, spec_trans, specular, specular_tint, sheen,
      sheen_tint, clearcoat, clearcoat_gloss;
  FieldF u_lobe, u1, u2, u3;
  int64_t n;
};

namespace {

// scene/types.py's material tags
constexpr int kMetal = 7;
constexpr int kGlass = 8;
constexpr int kClearcoat = 9;
constexpr int kSheen = 10;
constexpr int kBsdf = 11;

constexpr int kThreads = 128;

// core/math.py's constants, each rounded to float32 as torch rounds a
// Python scalar for a float32 tensor
constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kInvPi = static_cast<float>(1.0 / kPiD);
constexpr float kTwoPi = static_cast<float>(2.0 * kPiD);
constexpr float kSingular = static_cast<float>(-1.0 + 1e-6);  // to_world's n.z < -1 + 1e-6

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return v3(a.x / s, a.y / s, a.z / s); }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// torch.sum over the last axis of 3: the reduction kernel splits it over 2
// threads (x0 + x2 on one, x1 on the other, each from a +0 identity) and
// adds the two.
__device__ __forceinline__ float sum3(float a, float b, float c) { return ((0.0f + a) + (0.0f + c)) + (0.0f + b); }
__device__ __forceinline__ float sum3(V3 a) { return sum3(a.x, a.y, a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return sum3(a * b); }

// torch.linalg.cross: its kernel's a1 b2 - a2 b1 contracted as nvcc
// contracts it, the first product fused.
__device__ __forceinline__ float cross_term(float a1, float b2, float a2, float b1) {
  return __fmaf_rn(a1, b2, -(a2 * b1));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(cross_term(a.y, b.z, a.z, b.y), cross_term(a.z, b.x, a.x, b.z), cross_term(a.x, b.y, a.y, b.x));
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp(float x, float lo, float hi) { return isnan(x) ? x : fminf(fmaxf(x, lo), hi); }
__device__ __forceinline__ V3 clamp_min(V3 a, float lo) { return v3(clamp_min(a.x, lo), clamp_min(a.y, lo), clamp_min(a.z, lo)); }

// 1.0 / x: torch's reciprocal kernel (Tensor.__rtruediv__), then a product by 1
__device__ __forceinline__ float recip(float x) { return (1.0f / x) * 1.0f; }

// disney._sqrt0: sqrt clamped at 0, and 0 for NaN
__device__ __forceinline__ float sqrt0(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }
__device__ __forceinline__ V3 sqrt0(V3 a) { return v3(sqrt0(a.x), sqrt0(a.y), sqrt0(a.z)); }

// torch.sign: (0 < x) - (x < 0)
__device__ __forceinline__ float sgn(float x) { return static_cast<float>((0.0f < x) - (x < 0.0f)); }

// core.math.normalize(a, eps)
__device__ __forceinline__ V3 normalize(V3 a, float eps) {
  float n2 = sum3(a * a);
  n2 = n2 > eps ? n2 : eps;
  return a / sqrtf(n2);
}

// core.math.face_forward
__device__ __forceinline__ V3 face_forward(V3 n, V3 ref) { return dot(n, ref) < 0.0f ? -n : n; }

// core.math.reflect: -d + 2 (d.n) n
__device__ __forceinline__ V3 reflect(V3 d, V3 n) { return -d + (2.0f * dot(d, n)) * n; }

// core.math.to_world: the Frisvad basis around n, with its singular branch
__device__ __forceinline__ V3 to_world(V3 n, V3 v) {
  const bool singular = n.z < kSingular;
  const float a = recip(singular ? 1.0f : 1.0f + n.z);
  const float b = (-n.x * n.y) * a;
  const V3 x = sel(singular, v3(0.0f, -1.0f, 0.0f), v3(1.0f - (n.x * n.x) * a, b, -n.x));
  const V3 y = sel(singular, v3(-1.0f, 0.0f, 0.0f), v3(b, 1.0f - (n.y * n.y) * a, -n.y));
  return (x * v.x + y * v.y) + n * v.z;
}

// core.math.pow5 as bsdf._pow5: x (x x)(x x)
__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

__device__ __forceinline__ float schlick_w(float c) { return pow5(clamp(1.0f - c, 0.0f, 1.0f)); }

__device__ __forceinline__ float luminance(V3 c) { return (c.x * 0.212671f + c.y * 0.715160f) + c.z * 0.072169f; }

// core.sampling.sample_hemisphere_cos
__device__ __forceinline__ V3 hemisphere_cos(float u1, float u2) {
  const float phi = kTwoPi * u2;
  const float r = sqrtf(clamp(u1, 0.0f, 1.0f));
  const float z = sqrtf(clamp(1.0f - u1, 0.0f, 1.0f));
  return v3(cosf(phi) * r, sinf(phi) * r, z);
}

// What a lane reads once: the shading frame (disney._frame, n flipped
// toward dir_in) and the shade point's fields its lobes use.
struct Lane {
  V3 n, tx, ty;  // the frame
  V3 geo_n, dir_in, il;  // il: dir_in in the frame
  V3 refl;
  float roughness, anisotropic;
};

__device__ __forceinline__ V3 local(const Lane& L, V3 w) { return v3(dot(L.tx, w), dot(L.ty, w), dot(L.n, w)); }

__device__ __forceinline__ V3 world(const Lane& L, V3 hl) { return (hl.x * L.tx + hl.y * L.ty) + hl.z * L.n; }

// disney._alphas
__device__ __forceinline__ void alphas(float roughness, float anisotropic, float& ax, float& ay) {
  const float aspect = sqrtf(clamp_min(1.0f - 0.9f * anisotropic, 1e-4f));
  const float a2 = clamp_min(roughness * roughness, 1e-4f);
  ax = a2 / aspect;
  ay = a2 * aspect;
}

// disney._ggx_D
__device__ __forceinline__ float ggx_D(V3 hl, float ax, float ay) {
  const float k = ((hl.x * hl.x) / (ax * ax) + (hl.y * hl.y) / (ay * ay)) + hl.z * hl.z;
  const float ik = recip(clamp_min(k, 1e-7f));
  return hl.z > 0.0f ? (ik * ik) / ((kPi * ax) * ay) : 0.0f;
}

// disney._smith_G1 (1 / (1 + lambda))
__device__ __forceinline__ float smith_G1(V3 wl, float ax, float ay) {
  const float wz2 = clamp_min(wl.z * wl.z, 1e-12f);
  const float a = ((((ax * ax) * wl.x) * wl.x) + (((ay * ay) * wl.y) * wl.y)) / wz2;
  const float lambda = 0.5f * (sqrtf(1.0f + a) - 1.0f);
  return recip(1.0f + lambda);
}

// disney._sample_ggx_vndf (Heitz 2018), in the local frame
__device__ __forceinline__ V3 sample_ggx_vndf(V3 wl, float ax, float ay, float u1, float u2) {
  const V3 v = normalize(v3(wl.x * ax, wl.y * ay, wl.z), 1e-20f);
  const float lensq = v.x * v.x + v.y * v.y;
  const float inv = recip(sqrtf(clamp_min(lensq, 1e-20f)));
  const V3 t1 = sel(lensq > 1e-12f, v3(-v.y * inv, v.x * inv, 0.0f), v3(1.0f, 0.0f, 0.0f));
  const V3 t2 = cross(v, t1);
  const float r = sqrt0(clamp(u1, 0.0f, 1.0f));
  const float phi = kTwoPi * u2;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float s = 0.5f * (1.0f + v.z);
  p2 = (1.0f - s) * sqrt0(clamp(1.0f - p1 * p1, 0.0f, 1.0f)) + s * p2;
  const float p3 = sqrt0(clamp((1.0f - p1 * p1) - p2 * p2, 0.0f, 1.0f));
  const V3 nh = (p1 * t1 + p2 * t2) + p3 * v;
  return normalize(v3(nh.x * ax, nh.y * ay, clamp_min(nh.z, 1e-6f)), 1e-20f);
}

// disney._vndf_pdf
__device__ __forceinline__ float vndf_pdf(V3 wl_in, V3 hl, float ax, float ay) {
  const float D = ggx_D(hl, ax, ay);
  const float G1 = smith_G1(wl_in, ax, ay);
  const float wh = clamp_min(sum3(wl_in * hl), 0.0f);
  const float wz = clamp_min(wl_in.z, 1e-6f);
  return ((G1 * D) * wh) / wz;
}

// disney._fresnel_dielectric
__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta) {
  cos_i = clamp(cos_i, 0.0f, 1.0f);
  const float sin2_t = (1.0f - cos_i * cos_i) / (eta * eta);
  const bool tir = sin2_t >= 1.0f;
  const float cos_t = sqrt0(clamp(1.0f - sin2_t, 0.0f, 1.0f));
  const float rs = (cos_i - eta * cos_t) / clamp_min(cos_i + eta * cos_t, 1e-12f);
  const float rp = (eta * cos_i - cos_t) / clamp_min(eta * cos_i + cos_t, 1e-12f);
  const float F = 0.5f * (rs * rs + rp * rp);
  return tir ? 1.0f : F;
}

// disney._reflecting_ok
__device__ __forceinline__ bool reflecting_ok(const Lane& L, V3 ol, V3 dir_out) {
  return (L.il.z > 0.0f) & (ol.z > 0.0f) & (dot(L.geo_n, dir_out) > 0.0f);
}

// -- Metal --

__device__ V3 metal_eval(const Lane& L, V3 dir_out) {
  const V3 ol = local(L, dir_out);
  const V3 h = normalize(L.dir_in + dir_out, 1e-20f);
  const V3 hl = local(L, h);
  float ax, ay;
  alphas(L.roughness, L.anisotropic, ax, ay);
  const float D = ggx_D(hl, ax, ay);
  const float G = smith_G1(L.il, ax, ay) * smith_G1(ol, ax, ay);
  const float w = schlick_w(dot(h, dir_out));
  const V3 F = v3(L.refl.x + (1.0f - L.refl.x) * w, L.refl.y + (1.0f - L.refl.y) * w, L.refl.z + (1.0f - L.refl.z) * w);
  const float niz = clamp_min(L.il.z, 1e-6f);
  const V3 f = F * ((D * G) / (4.0f * niz));
  return sel(reflecting_ok(L, ol, dir_out), f, v3(0.0f, 0.0f, 0.0f));
}

__device__ float metal_pdf(const Lane& L, V3 dir_out) {
  const V3 h = normalize(L.dir_in + dir_out, 1e-20f);
  const V3 hl = local(L, h);
  const V3 ol = local(L, dir_out);
  float ax, ay;
  alphas(L.roughness, L.anisotropic, ax, ay);
  const float hdo = clamp_min(dot(h, dir_out), 1e-8f);
  const float pdf = vndf_pdf(L.il, hl, ax, ay) / (4.0f * hdo);
  return reflecting_ok(L, ol, dir_out) ? pdf : 0.0f;
}

__device__ V3 metal_sample(const Lane& L, float u1, float u2, float& pdf) {
  float ax, ay;
  alphas(L.roughness, L.anisotropic, ax, ay);
  const V3 hl = sample_ggx_vndf(L.il, ax, ay, u1, u2);
  const V3 dir_out = reflect(L.dir_in, world(L, hl));
  const float p = metal_pdf(L, dir_out);
  pdf = dot(L.geo_n, L.dir_in) < 0.0f ? 0.0f : p;
  return dir_out;
}

// -- Clearcoat --

__device__ __forceinline__ float cc_alpha(float gloss) { return (1.0f - gloss) * 0.1f + gloss * 0.001f; }

__device__ __forceinline__ float cc_D(float hz, float alpha) {
  const float a2 = alpha * alpha;
  const float denom = (kPi * logf(clamp_min(a2, 1e-12f))) * (1.0f + ((a2 - 1.0f) * hz) * hz);
  return (a2 - 1.0f) / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
}

__device__ float clearcoat_eval(const Lane& L, float gloss, V3 dir_out) {
  const V3 ol = local(L, dir_out);
  const V3 h = normalize(L.dir_in + dir_out, 1e-20f);
  const V3 hl = local(L, h);
  const float D = cc_D(hl.z, cc_alpha(gloss));
  const float F = 0.04f + 0.96f * schlick_w(dot(h, dir_out));
  const float G = smith_G1(L.il, 0.25f, 0.25f) * smith_G1(ol, 0.25f, 0.25f);
  const float niz = clamp_min(L.il.z, 1e-6f);
  const float f = ((F * D) * G) / (4.0f * niz);
  return (reflecting_ok(L, ol, dir_out) ? f : 0.0f) * 1.0f;  // * torch.ones_like
}

__device__ float clearcoat_pdf(const Lane& L, float gloss, V3 dir_out) {
  const V3 ol = local(L, dir_out);
  const V3 h = normalize(L.dir_in + dir_out, 1e-20f);
  const V3 hl = local(L, h);
  const float D = cc_D(hl.z, cc_alpha(gloss));
  const float hdo = clamp_min(dot(h, dir_out), 1e-8f);
  const float pdf = (D * clamp_min(hl.z, 0.0f)) / (4.0f * hdo);
  return reflecting_ok(L, ol, dir_out) ? pdf : 0.0f;
}

__device__ V3 clearcoat_sample(const Lane& L, float gloss, float u1, float u2, float& pdf) {
  const float alpha = cc_alpha(gloss);
  const float a2 = clamp_min(alpha * alpha, 1e-12f);
  const float cos2 = (1.0f - powf(a2, 1.0f - u1)) / (1.0f - a2);
  const float cos_h = sqrt0(clamp(cos2, 0.0f, 1.0f));
  const float sin_h = sqrt0(clamp(1.0f - cos2, 0.0f, 1.0f));
  const float phi = kTwoPi * u2;
  const V3 h = world(L, v3(sin_h * cosf(phi), sin_h * sinf(phi), cos_h));
  const V3 dir_out = reflect(L.dir_in, h);
  const float p = clearcoat_pdf(L, gloss, dir_out);
  pdf = dot(L.geo_n, L.dir_in) < 0.0f ? 0.0f : p;
  return dir_out;
}

// -- Sheen --

__device__ V3 sheen_eval(const Lane& L, float sheen_tint, V3 dir_out) {
  const V3 h = normalize(L.dir_in + dir_out, 1e-20f);
  const float hdo = dot(h, dir_out);
  const float ndo = dot(L.n, dir_out);
  const float lum = clamp_min(luminance(L.refl), 1e-8f);
  const V3 tint = L.refl / lum;
  const float base = 1.0f - sheen_tint;
  const V3 color = v3(base + sheen_tint * tint.x, base + sheen_tint * tint.y, base + sheen_tint * tint.z);
  const V3 f = color * (schlick_w(hdo) * clamp_min(ndo, 0.0f));
  const bool ok = (ndo > 0.0f) & (dot(L.geo_n, dir_out) > 0.0f);
  return sel(ok, f, v3(0.0f, 0.0f, 0.0f));
}

// disney._sheen_pdf, which is bsdf._cosine_pdf too
__device__ float cosine_pdf(const Lane& L, V3 dir_out) {
  const float pdf = clamp_min(dot(L.n, dir_out), 0.0f) * kInvPi;
  return dot(L.geo_n, dir_out) < 0.0f ? 0.0f : pdf;
}

__device__ V3 sheen_sample(const Lane& L, float u1, float u2, float& pdf) {
  const V3 dir_out = to_world(L.n, hemisphere_cos(u1, u2));
  const float p = clamp_min(dot(L.n, dir_out), 0.0f) * kInvPi;
  const bool bad = (dot(L.geo_n, dir_out) < 0.0f) | (dot(L.geo_n, L.dir_in) < 0.0f);
  pdf = bad ? 0.0f : p;
  return dir_out;
}

// bsdf._cosine_sample
__device__ V3 cosine_sample(const Lane& L, float u1, float u2, float& pdf) {
  const V3 dir_out = to_world(L.n, hemisphere_cos(u1, u2));
  const bool front = dot(L.geo_n, dir_out) >= 0.0f;
  const float p = front ? clamp_min(dot(L.n, dir_out), 0.0f) * kInvPi : 0.0f;
  pdf = dot(L.geo_n, L.dir_in) < 0.0f ? 0.0f : p;
  return dir_out;
}

// -- Glass (rough dielectric) --

// disney._glass_eta
__device__ __forceinline__ float glass_eta(bool front, float eta) { return front ? eta : recip(clamp_min(eta, 1e-6f)); }

// disney._glass_half and _glass_valid
struct GlassHalf {
  V3 ol, hl;
  float hdi, hdo;
  bool reflecting, valid;
};

__device__ __forceinline__ GlassHalf glass_half(const Lane& L, float eta, V3 dir_out) {
  GlassHalf g;
  g.ol = local(L, dir_out);
  g.reflecting = g.ol.z > 0.0f;
  const V3 h_r = normalize(L.dir_in + dir_out, 1e-20f);
  const V3 h_t = normalize(L.dir_in + dir_out * eta, 1e-20f);
  V3 h = sel(g.reflecting, h_r, h_t);
  g.hl = local(L, h);
  const bool flip = g.hl.z < 0.0f;
  g.hl = sel(flip, -g.hl, g.hl);
  h = sel(flip, -h, h);
  g.hdi = dot(h, L.dir_in);
  g.hdo = dot(h, dir_out);
  const bool side = g.reflecting ? g.hdo > 0.0f : g.hdo < 0.0f;
  g.valid = (fabsf(g.ol.z) > 1e-7f) & (g.hdi > 0.0f) & side;
  return g;
}

__device__ V3 glass_eval(const Lane& L, float eta, V3 dir_out) {
  const GlassHalf g = glass_half(L, eta, dir_out);
  float ax, ay;
  alphas(L.roughness, L.anisotropic, ax, ay);
  const float F = fresnel_dielectric(fabsf(g.hdi), eta);
  const float D = ggx_D(g.hl, ax, ay);
  const float G = smith_G1(L.il, ax, ay) * smith_G1(g.ol, ax, ay);
  const float niz = clamp_min(fabsf(L.il.z), 1e-6f);
  const float f_refl = (((F * D) * G) / (4.0f * niz)) * 1.0f;  // * torch.ones_like
  const float denom = g.hdi + eta * g.hdo;
  const float denom2 = clamp_min(denom * denom, 1e-12f);
  const float t = ((((1.0f - F) * D) * G) * fabsf(g.hdo * g.hdi)) / (niz * denom2);
  const V3 f_trans = sqrt0(clamp_min(L.refl, 0.0f)) * t;
  const V3 f = sel(g.reflecting, v3(f_refl, f_refl, f_refl), f_trans);
  return sel(g.valid, f, v3(0.0f, 0.0f, 0.0f));
}

__device__ float glass_pdf(const Lane& L, float eta, V3 dir_out) {
  const GlassHalf g = glass_half(L, eta, dir_out);
  float ax, ay;
  alphas(L.roughness, L.anisotropic, ax, ay);
  const float F = fresnel_dielectric(fabsf(g.hdi), eta);
  const float ph = vndf_pdf(L.il, g.hl, ax, ay);
  const float pdf_refl = (F * ph) / clamp_min(4.0f * fabsf(g.hdo), 1e-12f);
  const float denom = g.hdi + eta * g.hdo;
  const float denom2 = clamp_min(denom * denom, 1e-12f);
  const float jac_t = ((eta * eta) * fabsf(g.hdo)) / denom2;
  const float pdf_trans = ((1.0f - F) * ph) * jac_t;
  const float pdf = g.reflecting ? pdf_refl : pdf_trans;
  return g.valid ? pdf : 0.0f;
}

__device__ V3 glass_sample(const Lane& L, float eta, float u_choice, float u1, float u2, float& pdf) {
  float ax, ay;
  alphas(L.roughness, L.anisotropic, ax, ay);
  const V3 hl = sample_ggx_vndf(L.il, ax, ay, u1, u2);
  const V3 h = world(L, hl);
  const float hdi = dot(h, L.dir_in);
  const float F = fresnel_dielectric(fabsf(hdi), eta);
  const V3 d_refl = reflect(L.dir_in, h);
  const float cos_i = hdi;
  const float sin2_t = (1.0f - cos_i * cos_i) / (eta * eta);
  const bool tir = sin2_t >= 1.0f;
  const float cos_t = sqrt0(clamp(1.0f - sin2_t, 0.0f, 1.0f));
  const float k = (fabsf(cos_i) / eta - cos_t) * sgn(cos_i);
  const V3 d_trans = normalize((-L.dir_in) / eta + k * h, 1e-20f);
  const bool take_refl = (u_choice <= F) | tir;
  const V3 dir_out = sel(take_refl, d_refl, d_trans);
  const bool above = dot(L.n, dir_out) > 0.0f;
  pdf = take_refl == above ? glass_pdf(L, eta, dir_out) : 0.0f;
  return dir_out;
}

// -- DisneyBSDF composite --

// The composite's shade point beyond Lane's fields.
struct Composite {
  float eta;  // glass_eta: oriented by the side the ray came from
  float metallic, spec_trans, specular, specular_tint, sheen, sheen_tint, clearcoat, clearcoat_gloss, subsurface;
  float dw, mw, gw, cw;  // disney._bsdf_weights
};

// disney._bsdf_lobe_probs
__device__ __forceinline__ void lobe_probs(const Composite& C, float& pd, float& pm, float& pg, float& pc) {
  const float total = clamp_min(((C.dw + C.mw) + C.gw) + C.cw, 1e-8f);
  pd = C.dw / total;
  pm = C.mw / total;
  pg = C.gw / total;
  pc = C.cw / total;
}

// bsdf._disney_diffuse_eval
__device__ V3 disney_diffuse_eval(const Lane& L, const Composite& C, V3 dir_out) {
  const V3 h = normalize(L.dir_in + dir_out, 1e-12f);
  const float hdout = dot(h, dir_out);
  const float ndout = dot(L.n, dir_out);
  const float ndin = dot(L.n, L.dir_in);
  const float wi = pow5(clamp(1.0f - ndin, 0.0f, 1.0f));
  const float wo = pow5(clamp(1.0f - ndout, 0.0f, 1.0f));
  const float fd90 = 0.5f + ((2.0f * L.roughness) * hdout) * hdout;
  const float fi = 1.0f + (fd90 - 1.0f) * wi, fo = 1.0f + (fd90 - 1.0f) * wo;
  const V3 f_base = L.refl * (((kInvPi * fi) * fo) * ndout);
  const float fss90 = (L.roughness * hdout) * hdout;
  const float denom = clamp_min(fabsf(ndin) + fabsf(ndout), 1e-12f);
  const float si = 1.0f + (fss90 - 1.0f) * wi, so = 1.0f + (fss90 - 1.0f) * wo;
  const V3 f_ss = (1.25f * L.refl) * ((kInvPi * ((si * so) * (recip(denom) - 0.5f) + 0.5f)) * ndout);
  const V3 f = (1.0f - C.subsurface) * f_base + C.subsurface * f_ss;
  const bool bad = (dot(L.geo_n, L.dir_in) < 0.0f) | (dot(L.geo_n, dir_out) < 0.0f);
  return sel(bad, v3(0.0f, 0.0f, 0.0f), f);
}

// disney._bsdf_metal_fresnel
__device__ V3 composite_metal_fresnel(const Lane& L, const Composite& C, V3 h, V3 dir_out) {
  const float lum = clamp_min(luminance(L.refl), 1e-8f);
  const V3 tint = L.refl / lum;
  const float base = 1.0f - C.specular_tint;
  const V3 ks = v3(base + C.specular_tint * tint.x, base + C.specular_tint * tint.y, base + C.specular_tint * tint.z);
  const float r = (C.eta - 1.0f) / (C.eta + 1.0f);
  const float r0 = r * r;
  const float k = (C.specular * r0) * (1.0f - C.metallic);
  const V3 c0 = k * ks + C.metallic * L.refl;
  const float w = schlick_w(dot(h, dir_out));
  return v3(c0.x + (1.0f - c0.x) * w, c0.y + (1.0f - c0.y) * w, c0.z + (1.0f - c0.z) * w);
}

__device__ V3 composite_eval(const Lane& L, const Composite& C, V3 dir_out) {
  const V3 ol = local(L, dir_out);
  const bool reflecting = (L.il.z > 0.0f) & (ol.z > 0.0f);
  const V3 f_diff = disney_diffuse_eval(L, C, dir_out);
  const V3 f_sheen = (sheen_eval(L, C.sheen_tint, dir_out) * C.sheen) * (1.0f - C.metallic);
  const V3 h = normalize(L.dir_in + dir_out, 1e-20f);
  const V3 hl = local(L, h);
  float ax, ay;
  alphas(L.roughness, L.anisotropic, ax, ay);
  const float D = ggx_D(hl, ax, ay);
  const float G = smith_G1(L.il, ax, ay) * smith_G1(ol, ax, ay);
  const V3 Fm = composite_metal_fresnel(L, C, h, dir_out);
  const float niz = clamp_min(L.il.z, 1e-6f);
  const V3 f_metal = Fm * ((D * G) / (4.0f * niz));
  const float f_cc = clearcoat_eval(L, C.clearcoat_gloss, dir_out);
  const V3 f_glass = glass_eval(L, C.eta, dir_out);
  const V3 gf = C.gw * f_glass;
  const V3 sum = (((C.dw * f_diff + f_sheen) + C.mw * f_metal) + C.cw * v3(f_cc, f_cc, f_cc)) + gf;
  return sel(reflecting, sum, gf);
}

__device__ float composite_pdf(const Lane& L, const Composite& C, V3 dir_out) {
  float pd, pm, pg, pc;
  lobe_probs(C, pd, pm, pg, pc);
  return ((pd * cosine_pdf(L, dir_out) + pm * metal_pdf(L, dir_out)) + pg * glass_pdf(L, C.eta, dir_out)) +
         pc * clearcoat_pdf(L, C.clearcoat_gloss, dir_out);
}

__device__ V3 composite_sample(const Lane& L, const Composite& C, float u_lobe, float u1, float u2, float u3,
                               float& pdf) {
  float pd, pm, pg, pc;
  lobe_probs(C, pd, pm, pg, pc);
  const bool c1 = u_lobe < pd;
  const bool c2 = u_lobe < pd + pm;
  const bool c3 = u_lobe < (pd + pm) + pg;
  float own;
  V3 dir_out;
  if (c1) {
    dir_out = cosine_sample(L, u1, u2, own);
  } else if (c2) {
    dir_out = metal_sample(L, u1, u2, own);
  } else if (c3) {
    dir_out = glass_sample(L, C.eta, u3, u1, u2, own);
  } else {
    dir_out = clearcoat_sample(L, C.clearcoat_gloss, u1, u2, own);
  }
  pdf = own > 0.0f ? composite_pdf(L, C, dir_out) : 0.0f;
  return dir_out;
}

// -- Loading a lane --

__device__ __forceinline__ int64_t lane() { return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; }
__device__ __forceinline__ float ld(FieldF f, int64_t i) { return f.p[i * f.s]; }
__device__ __forceinline__ V3 ld3(FieldF f, int64_t i) {
  const float* p = f.p + i * f.s;
  return v3(p[0], p[1], p[2]);
}

// The lane's frame and dir_in, and the fields its tag's lobes read: refl
// where `refl`, roughness and anisotropic but for sheen and clearcoat.
__device__ __forceinline__ Lane load_lane(const Inputs& in, int64_t i, int tag, bool refl) {
  Lane L;
  L.dir_in = ld3(in.dir_in, i);
  L.geo_n = ld3(in.geo_n, i);
  L.n = face_forward(ld3(in.sh_n, i), L.dir_in);
  L.tx = to_world(L.n, v3(1.0f, 0.0f, 0.0f));
  L.ty = to_world(L.n, v3(0.0f, 1.0f, 0.0f));
  L.il = local(L, L.dir_in);
  L.refl = refl ? ld3(in.refl, i) : v3(0.0f, 0.0f, 0.0f);
  const bool micro = tag != kSheen && tag != kClearcoat;
  L.roughness = micro ? ld(in.roughness, i) : 0.0f;
  L.anisotropic = micro ? ld(in.anisotropic, i) : 0.0f;
  return L;
}

__device__ __forceinline__ Composite load_composite(const Inputs& in, int64_t i) {
  Composite C;
  C.eta = glass_eta(in.front.p[i * in.front.s] != 0, ld(in.eta, i));
  C.metallic = ld(in.metallic, i);
  C.spec_trans = ld(in.spec_trans, i);
  C.specular = ld(in.specular, i);
  C.specular_tint = ld(in.specular_tint, i);
  C.sheen = ld(in.sheen, i);
  C.sheen_tint = ld(in.sheen_tint, i);
  C.clearcoat = ld(in.clearcoat, i);
  C.clearcoat_gloss = ld(in.clearcoat_gloss, i);
  C.subsurface = ld(in.subsurface, i);
  C.dw = (1.0f - C.metallic) * (1.0f - C.spec_trans);
  C.mw = 1.0f - C.spec_trans * (1.0f - C.metallic);
  C.gw = (1.0f - C.metallic) * C.spec_trans;
  C.cw = 0.25f * C.clearcoat;
  return C;
}

__device__ __forceinline__ bool other_tag(const Inputs& in, int64_t i, int tag) { return in.tag.p[i * in.tag.s] != tag; }

__device__ __forceinline__ void store3(float* out, int64_t i, V3 v) {
  out[3 * i] = v.x;
  out[3 * i + 1] = v.y;
  out[3 * i + 2] = v.z;
}

unsigned blocks(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads)
take_disney_sample(Inputs in, int tag, float* dir_out, float* pdf) {
  const int64_t i = lane();
  if (i >= in.n) return;
  if (other_tag(in, i, tag)) {
    store3(dir_out, i, v3(0.0f, 0.0f, 0.0f));
    pdf[i] = 0.0f;
    return;
  }
  const float u_lobe = ld(in.u_lobe, i), u1 = ld(in.u1, i), u2 = ld(in.u2, i);
  const Lane L = load_lane(in, i, tag, false);
  float p = 0.0f;
  V3 d = v3(0.0f, 0.0f, 0.0f);
  switch (tag) {
    case kMetal: d = metal_sample(L, u1, u2, p); break;
    case kGlass: d = glass_sample(L, glass_eta(in.front.p[i * in.front.s] != 0, ld(in.eta, i)), u_lobe, u1, u2, p); break;
    case kClearcoat: d = clearcoat_sample(L, ld(in.clearcoat_gloss, i), u1, u2, p); break;
    case kSheen: d = sheen_sample(L, u1, u2, p); break;
    case kBsdf: d = composite_sample(L, load_composite(in, i), u_lobe, u1, u2, ld(in.u3, i), p); break;
  }
  store3(dir_out, i, d);
  pdf[i] = p;
}

extern "C" __global__ void __launch_bounds__(kThreads)
take_disney_eval(Inputs in, int tag, float* f) {
  const int64_t i = lane();
  if (i >= in.n) return;
  if (other_tag(in, i, tag)) {
    store3(f, i, v3(0.0f, 0.0f, 0.0f));
    return;
  }
  const V3 dir_out = ld3(in.dir_out, i);
  const Lane L = load_lane(in, i, tag, tag != kClearcoat);
  V3 v = v3(0.0f, 0.0f, 0.0f);
  switch (tag) {
    case kMetal: v = metal_eval(L, dir_out); break;
    case kGlass: v = glass_eval(L, glass_eta(in.front.p[i * in.front.s] != 0, ld(in.eta, i)), dir_out); break;
    case kClearcoat: {
      const float c = clearcoat_eval(L, ld(in.clearcoat_gloss, i), dir_out);
      v = v3(c, c, c);
      break;
    }
    case kSheen: v = sheen_eval(L, ld(in.sheen_tint, i), dir_out) * ld(in.sheen, i); break;
    case kBsdf: v = composite_eval(L, load_composite(in, i), dir_out); break;
  }
  store3(f, i, v);
}

extern "C" __global__ void __launch_bounds__(kThreads)
take_disney_pdf(Inputs in, int tag, float* pdf) {
  const int64_t i = lane();
  if (i >= in.n) return;
  if (other_tag(in, i, tag)) {
    pdf[i] = 0.0f;
    return;
  }
  const V3 dir_out = ld3(in.dir_out, i);
  const Lane L = load_lane(in, i, tag, false);
  float p = 0.0f;
  switch (tag) {
    case kMetal: p = metal_pdf(L, dir_out); break;
    case kGlass: p = glass_pdf(L, glass_eta(in.front.p[i * in.front.s] != 0, ld(in.eta, i)), dir_out); break;
    case kClearcoat: p = clearcoat_pdf(L, ld(in.clearcoat_gloss, i), dir_out); break;
    case kSheen: p = cosine_pdf(L, dir_out); break;
    case kBsdf: p = composite_pdf(L, load_composite(in, i), dir_out); break;
  }
  pdf[i] = p;
}

// `in` is read on the host at the launch: the kernel gets a copy.
extern "C" int tt_disney_sample(const Inputs* in, int tag, float* dir_out, float* pdf, cudaStream_t stream) {
  if (in->n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  take_disney_sample<<<blocks(in->n), kThreads, 0, stream>>>(*in, tag, dir_out, pdf);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_disney_eval(const Inputs* in, int tag, float* f, cudaStream_t stream) {
  if (in->n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  take_disney_eval<<<blocks(in->n), kThreads, 0, stream>>>(*in, tag, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_disney_pdf(const Inputs* in, int tag, float* pdf, cudaStream_t stream) {
  if (in->n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  take_disney_pdf<<<blocks(in->n), kThreads, 0, stream>>>(*in, tag, pdf);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
