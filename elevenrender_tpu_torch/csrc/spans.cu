// Device-side stamps of the port's spans (core/spans.py), for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no spans inside its
// programs.  A span of device work is bracketed by two launches of one
// thread each on the stream that runs the work: er_span_enter before it,
// er_span_exit after it.  Each reads %globaltimer, the card's nanosecond
// clock, so the stretch between them is the device time of the work
// between (and the launch gaps inside it).  Nothing is read back: the
// stamps keep their sums in device memory, and the host reads them once
// (core/spans.py report).  Inside a CUDA graph's capture the two launches
// become kernel nodes like any other, so every replay accumulates.
//
// The stack: spans nest, and a span's self time is its inclusive time
// less that of its direct children.  A stack of kDepth frames in device
// memory ([0] the depth, then (entry time, span row, children's time) a
// frame) keeps the open spans of one stream, or of one graph (the host
// picks the stack).  The sums: one row of 4 per span (inclusive ns, self
// ns, exits, the ring's next slot), added with atomics, since two streams
// may stamp the same span at once, and a ring of the last kRing inclusive
// durations per span.  A frame deeper than kDepth, or an exit whose frame
// belongs to another span, adds one to *errors and is not counted.
//
// What bounds it: one launch each (a few microseconds of launch gap in a
// stream, about 1 us inside a graph); the work is a few words.

#include <cuda_runtime.h>

namespace {

constexpr int kDepth = 32;
constexpr int kRing = 4096;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void span_enter(long long* stack, int row) {
  const long long t = global_ns();
  const long long d = stack[0];
  if (d >= 0 && d < kDepth) {
    long long* f = stack + 1 + 3 * d;
    f[0] = t;
    f[1] = row;
    f[2] = 0;
  }
  stack[0] = d + 1;
}

__global__ void span_exit(long long* stack, unsigned long long* sums,
                          long long* ring, unsigned long long* errors,
                          int row) {
  const long long t = global_ns();
  const long long d = stack[0] - 1;
  stack[0] = d < 0 ? 0 : d;
  if (d < 0 || d >= kDepth || stack[1 + 3 * d + 1] != row) {
    atomicAdd(errors, 1ULL);
    return;
  }
  const long long* f = stack + 1 + 3 * d;
  const long long inclusive = t - f[0];
  unsigned long long* s = sums + 4 * row;
  atomicAdd(s, static_cast<unsigned long long>(inclusive));
  atomicAdd(s + 1, static_cast<unsigned long long>(inclusive - f[2]));
  atomicAdd(s + 2, 1ULL);
  const unsigned long long slot = atomicAdd(s + 3, 1ULL);
  ring[static_cast<long long>(row) * kRing + slot % kRing] = inclusive;
  if (d > 0) stack[1 + 3 * (d - 1) + 2] += inclusive;
}

}  // namespace

extern "C" {

int er_span_depth() { return kDepth; }

int er_span_ring() { return kRing; }

// All pointers are device pointers: stack, 1 + 3 kDepth int64; sums,
// 4 int64 a span row; ring, kRing int64 a span row; errors, one int64.
// Each launches one thread on `stream` and returns the cudaError_t of the
// launch (0 on success).
int er_span_enter(void* stack, int row, void* stream) {
  span_enter<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(stack), row);
  return static_cast<int>(cudaGetLastError());
}

int er_span_exit(void* stack, void* sums, void* ring, void* errors, int row,
                 void* stream) {
  span_exit<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(stack), static_cast<unsigned long long*>(sums),
      static_cast<long long*>(ring), static_cast<unsigned long long*>(errors),
      row);
  return static_cast<int>(cudaGetLastError());
}

const char* er_span_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
