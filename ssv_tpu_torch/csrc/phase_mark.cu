// Phase marks of the train step: one single-thread kernel a mark, named
// ssv_mark_<mark> so a profiler's device timeline shows each mark by name,
// each writing the card's %globaltimer (nanoseconds) into
// stamps[pos, column], the column the mark's place among the marks the
// algorithm's step makes.
//
// Replaces no TPU kernel: the JAX package's epoch is one XLA program with no
// marks inside it. The port's step runs as a CUDA graph replay, inside which
// the host has no range, so the step records its own phases on the card.
// `pos` is the step's position in the epoch, read on the device (the
// trainer's position counter), so the same kernel node writes the right row
// in every replay. Bound by its launch: one thread, one 8-byte load and one
// 8-byte store.
//
// Layout: stamps is (steps, cols) int64, contiguous; pos a single int64.
// A position outside [0, steps) or a column outside [0, cols) writes
// nothing.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void stamp(const long long* pos, long long* stamps,
                                      int steps, int cols, int column) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long p = *pos;
  if (p >= 0 && p < steps && column >= 0 && column < cols)
    stamps[p * cols + column] = static_cast<long long>(now);
}

}  // namespace

extern "C" {

// The marks, in the order of ssv_tpu_torch/utils/trace.py's MARKS.
__global__ void ssv_mark_views(const long long* pos, long long* stamps, int steps, int cols,
                                int column) {
  stamp(pos, stamps, steps, cols, column);
}
__global__ void ssv_mark_forward(const long long* pos, long long* stamps, int steps, int cols,
                                int column) {
  stamp(pos, stamps, steps, cols, column);
}
__global__ void ssv_mark_student(const long long* pos, long long* stamps, int steps, int cols,
                                int column) {
  stamp(pos, stamps, steps, cols, column);
}
__global__ void ssv_mark_loss(const long long* pos, long long* stamps, int steps, int cols,
                                int column) {
  stamp(pos, stamps, steps, cols, column);
}
__global__ void ssv_mark_backward(const long long* pos, long long* stamps, int steps, int cols,
                                int column) {
  stamp(pos, stamps, steps, cols, column);
}
__global__ void ssv_mark_optimizer(const long long* pos, long long* stamps, int steps, int cols,
                                int column) {
  stamp(pos, stamps, steps, cols, column);
}
__global__ void ssv_mark_state(const long long* pos, long long* stamps, int steps, int cols,
                                int column) {
  stamp(pos, stamps, steps, cols, column);
}
__global__ void ssv_mark_end(const long long* pos, long long* stamps, int steps, int cols,
                                int column) {
  stamp(pos, stamps, steps, cols, column);
}

// Launches mark `mark` (its place in MARKS, 0 .. 7), writing column `column` of the
// (steps, cols) stamps, on `stream` and returns cudaGetLastError() (0 on
// success).
int ssv_phase_mark(int mark, int column, const long long* pos, long long* stamps, int steps,
                   int cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mark) {
    case 0: ssv_mark_views<<<1, 1, 0, s>>>(pos, stamps, steps, cols, column); break;
    case 1: ssv_mark_forward<<<1, 1, 0, s>>>(pos, stamps, steps, cols, column); break;
    case 2: ssv_mark_student<<<1, 1, 0, s>>>(pos, stamps, steps, cols, column); break;
    case 3: ssv_mark_loss<<<1, 1, 0, s>>>(pos, stamps, steps, cols, column); break;
    case 4: ssv_mark_backward<<<1, 1, 0, s>>>(pos, stamps, steps, cols, column); break;
    case 5: ssv_mark_optimizer<<<1, 1, 0, s>>>(pos, stamps, steps, cols, column); break;
    case 6: ssv_mark_state<<<1, 1, 0, s>>>(pos, stamps, steps, cols, column); break;
    case 7: ssv_mark_end<<<1, 1, 0, s>>>(pos, stamps, steps, cols, column); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
