// Phase marks: one-thread kernels that do nothing, each named for a stage
// and a phase of a pass (take_tpu_torch/tracing.py), so that a graph
// captured with marks puts named boundaries between the phases' kernels on
// the card's timeline at every replay: take_mark_forward_bsdf, say.
//
// Replaces no TPU kernel: it is the port's way to name device time inside a
// CUDA graph, where host ranges cannot reach (a pass body runs on the host
// once, at capture). A mark costs one launch of one thread, a node of the
// graph. `extern "C"` keeps each kernel's name as written in a trace.
//
// The order of the stages and phases below is tracing.STAGES and
// tracing.PHASES: tt_mark(stage, phase) takes their indices. It launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#define TT_PHASES(X, stage)                                                    \
  X(stage, camera) X(stage, shade) X(stage, light) X(stage, occlusion)        \
  X(stage, bsdf) X(stage, intersect) X(stage, hit) X(stage, step)             \
  X(stage, loss) X(stage, vjp) X(stage, end) X(stage, disney)                 \
  X(stage, envmap) X(stage, glossy)

#define TT_DEFINE(stage, phase) \
  extern "C" __global__ void take_mark_##stage##_##phase() {}
TT_PHASES(TT_DEFINE, forward)
TT_PHASES(TT_DEFINE, backward)

namespace {

#define TT_ENTRY(stage, phase) take_mark_##stage##_##phase,
void (*const kMarks[])() = {TT_PHASES(TT_ENTRY, forward) TT_PHASES(TT_ENTRY, backward)};
constexpr int kStages = 2;
constexpr int kPhases = sizeof(kMarks) / sizeof(kMarks[0]) / kStages;

}  // namespace

extern "C" int tt_mark(int stage, int phase, cudaStream_t stream) {
  if (stage < 0 || stage >= kStages || phase < 0 || phase >= kPhases) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kMarks[stage * kPhases + phase]),
                                           dim3(1), dim3(1), nullptr, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
