// Segment reductions of the placement stage: segment_sum / segment_max.
//
// Replaces the Pallas kernels of repro/core/accel/pallas_ops.py
// (segment_sum and segment_max, both through _segment_reduce and
// _seg_kernel).  The TPU version recasts the scatter as a one-hot
// (8,128)x(128,128) contraction because the TPU has a matrix unit and
// scatters badly; a GPU scatters well, so this is the plain scatter.
//
// What bounds it on the H100: bytes moved -- each element is read once
// (an int32 value and an int32 segment id, 8 bytes) and each segment
// written once -- and, at the sizes placement gives it (a few thousand
// elements), the launch itself.  Design: one thread per element,
// grid-stride, with an integer atomicAdd / atomicMax into the int32 output
// the wrapper initialised (0, or INT32_MIN for the max).  Integer atomics
// commute, so the result is exact and the same in every run.  Ids outside
// [0, n_segments) are dropped, like jax.ops.segment_*; an empty segment of
// the max keeps INT32_MIN.
#include <cstdint>
#include <cuda_runtime.h>

template <bool IS_MAX>
__global__ void segment_reduce_kernel(const int32_t* __restrict__ vals,
                                      const int32_t* __restrict__ ids,
                                      int64_t n, int32_t* __restrict__ out,
                                      int64_t n_segments) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t s = ids[i];
    if (s < 0 || s >= n_segments) continue;
    if (IS_MAX)
      atomicMax(out + s, vals[i]);
    else
      atomicAdd(out + s, vals[i]);
  }
}

extern "C" int segment_reduce(const int32_t* vals, const int32_t* ids,
                              int64_t n, int32_t* out, int64_t n_segments,
                              int is_max, void* stream) {
  const int threads = 256;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > (int64_t)sms * 16) blocks = (int64_t)sms * 16;  // then stride
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_max)
    segment_reduce_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
        vals, ids, n, out, n_segments);
  else
    segment_reduce_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
        vals, ids, n, out, n_segments);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
