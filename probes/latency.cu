// Latency probes for chip_smoke.py: one thread follows a dependent chain
// of loads, so the time per step is one round trip.  They port no TPU
// kernel and no path of repro_torch runs them; they measure the units of
// the replay kernel's latency floor (repro_torch/core/accel/csrc/replay.cu):
//
//   * l2_chase   -- a ring in global memory read with ld.global.cg (skips
//                   the SM's L1), sized to stay in the card's L2 cache:
//                   one L2 round trip, where the replay keeps deeper levels;
//   * smem_chase -- a ring copied into shared memory: one shared-memory
//                   round trip, where the replay keeps a first level of
//                   <= 48 KB of state.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void l2_chase_kernel(const long long* __restrict__ next,
                                int64_t steps, long long* sink) {
  long long i = 0;
  for (int64_t s = 0; s < steps; ++s) i = __ldcg(next + i);
  *sink = i;
}

__global__ void smem_chase_kernel(const int* __restrict__ next, int n_slots,
                                  int64_t steps, long long* sink) {
  extern __shared__ int ring[];
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) ring[i] = next[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int i = 0;
    for (int64_t s = 0; s < steps; ++s) i = ring[i];
    *sink = i;
  }
}

extern "C" int l2_chase(const int64_t* next, int64_t steps, int64_t* sink,
                        void* stream) {
  l2_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const long long*>(next), steps,
      reinterpret_cast<long long*>(sink));
  return (int)cudaGetLastError();
}

// n_slots * 4 bytes must fit the default 48 KB of dynamic shared memory.
extern "C" int smem_chase(const int32_t* next, int n_slots, int64_t steps,
                          int64_t* sink, void* stream) {
  smem_chase_kernel<<<1, 32, (size_t)n_slots * sizeof(int),
                      static_cast<cudaStream_t>(stream)>>>(
      next, n_slots, steps, reinterpret_cast<long long*>(sink));
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
