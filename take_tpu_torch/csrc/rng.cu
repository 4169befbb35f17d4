// The counter RNG (take_tpu_torch/core/rng.py) as kernels: a path's stream
// key (hi, lo) from (seed, pixel, sample), and a draw, the uint32 bits or the
// U[0, 1) float of (hi, lo, counter), one launch each.
//
// Replaces no TPU kernel: take_tpu's core/rng.py is jnp code that XLA fuses
// into its neighbours. The port's plain version holds every uint32 word in
// an int64 tensor (torch has no uint32 arithmetic), so a draw there is 42
// elementwise kernels and a stream 58, each writing its intermediate to
// device memory; here the whole hash stays in registers, in uint32_t
// arithmetic with rng.py's constants, and the stream words keep their int64
// form in memory (values in [0, 2^32)) so that no caller changes.
//
// Bound (bytes over the H100's 3.35 TB/s): a draw reads hi and lo (16 B a
// lane; 8 B more with a per-lane counter) and writes 4 B (a float) or 8 B
// (bits), so a 2^20-lane uniform moves 20 B x 2^20 = 21 MB: 6.3 us. A
// stream reads two int32 indices (8 B) and writes hi and lo (16 B): 7.5 us.
// The hash is ~30 integer operations a word, far below the card's rate. One
// thread a lane, blocks of kThreads: 4,096 blocks for 2^20 lanes, enough to
// fill the 132 SMs many times over.
//
// `extern "C"` keeps each kernel's name as written in a trace (take_rng_*).
// Each tt_rng_* launcher launches on the given stream, allocates nothing,
// and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// murmur3 / splitmix constants (rng.py's _M1-_M4, _GOLDEN, _SALT)
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kM3 = 0x7FEB352Du;
constexpr uint32_t kM4 = 0x846CA68Bu;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kSalt = 0xDEADBEEFu;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 13;
  x *= kM2;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t mix2(uint32_t a, uint32_t b) { return mix(a * kGolden + b); }

__device__ __forceinline__ uint32_t draw(uint32_t hi, uint32_t lo, uint32_t c) {
  const uint32_t x = mix(hi ^ (c * kM3));
  const uint32_t y = mix(lo + c * kM4 + kGolden);
  return mix(x ^ ((y << 1) | (y >> 31)));
}

// Lane i of an int32 or int64 index tensor as a uint32 word (its low 32 bits).
__device__ __forceinline__ uint32_t word(const void* p, int is64, int64_t i) {
  return is64 ? static_cast<uint32_t>(static_cast<const int64_t*>(p)[i])
              : static_cast<uint32_t>(static_cast<const int32_t*>(p)[i]);
}

__device__ __forceinline__ int64_t lane() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// The counter of lane i: a per-lane int64 tensor, or `c` where it is null.
__device__ __forceinline__ uint32_t counter_of(const int64_t* counter, uint32_t c, int64_t i) {
  return counter ? static_cast<uint32_t>(counter[i]) : c;
}

unsigned blocks(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads)
take_rng_stream(uint32_t seed, const void* pix, int pix64, const void* samp, int samp64, int64_t n,
                int64_t* hi, int64_t* lo) {
  const int64_t i = lane();
  if (i >= n) return;
  const uint32_t p = word(pix, pix64, i), s = word(samp, samp64, i);
  hi[i] = mix2(mix2(seed, p), s);
  lo[i] = mix2(mix2(seed ^ kSalt, s), p);
}

extern "C" __global__ void __launch_bounds__(kThreads)
take_rng_uniform(const int64_t* hi, const int64_t* lo, const int64_t* counter, uint32_t c, int64_t n,
                 float* out) {
  const int64_t i = lane();
  if (i >= n) return;
  const uint32_t b = draw(static_cast<uint32_t>(hi[i]), static_cast<uint32_t>(lo[i]), counter_of(counter, c, i));
  out[i] = static_cast<float>(b >> 8) * 0x1p-24f;  // 24 bits: exact, as (bits >> 8).float() / 2^24 is
}

extern "C" __global__ void __launch_bounds__(kThreads)
take_rng_bits(const int64_t* hi, const int64_t* lo, const int64_t* counter, uint32_t c, int64_t n,
              int64_t* out) {
  const int64_t i = lane();
  if (i >= n) return;
  out[i] = draw(static_cast<uint32_t>(hi[i]), static_cast<uint32_t>(lo[i]), counter_of(counter, c, i));
}

extern "C" int tt_rng_stream(uint32_t seed, const void* pix, int pix64, const void* samp, int samp64, int64_t n,
                             int64_t* hi, int64_t* lo, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  take_rng_stream<<<blocks(n), kThreads, 0, stream>>>(seed, pix, pix64, samp, samp64, n, hi, lo);
  return static_cast<int>(cudaGetLastError());
}

// `counter` may be null: then every lane draws at counter `c`.
extern "C" int tt_rng_uniform(const int64_t* hi, const int64_t* lo, const int64_t* counter, uint32_t c, int64_t n,
                              float* out, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  take_rng_uniform<<<blocks(n), kThreads, 0, stream>>>(hi, lo, counter, c, n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_rng_bits(const int64_t* hi, const int64_t* lo, const int64_t* counter, uint32_t c, int64_t n,
                           int64_t* out, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  take_rng_bits<<<blocks(n), kThreads, 0, stream>>>(hi, lo, counter, c, n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
