// Bulk CiM ops: x op y, and the fused IDG subtree (x op1 y) op2 z.
//
// Replaces the Pallas kernels of repro/kernels/cim_bitwise.py
// (cim_bitwise and cim_bitwise_fused).  The TPU version cuts the 2-D
// arrays into (256, 512) tiles so that each tile sits in VMEM for the op;
// a GPU streams an elementwise op best as one flat pass, so the tiles are
// gone and the kernel walks the elements in 16-byte vectors.
//
// What bounds it on the H100: bytes.  Each operand is read once and the
// result written once (4 bytes per element and array); one op per element
// is far below the card's integer rate.  Design: grid-stride loop, uint4
// loads and stores (four elements) when every pointer is 16-byte aligned,
// a scalar tail, the op (or op pair) a template argument.  int32 and
// uint32 both run as uint32: two's-complement add and sub wrap alike in
// either, which is what the reference's XLA arithmetic does.
#include <cstdint>
#include <cuda_runtime.h>

enum Op { AND = 0, OR = 1, XOR = 2, ADD = 3, SUB = 4 };

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) {
  if (OP == AND) return a & b;
  if (OP == OR) return a | b;
  if (OP == XOR) return a ^ b;
  if (OP == ADD) return a + b;
  return a - b;
}

// OP2 < 0: the single op x OP1 y (c unused); else (x OP1 y) OP2 c
template <int OP1, int OP2>
__device__ __forceinline__ uint32_t elem(uint32_t a, uint32_t b, uint32_t c) {
  if (OP2 < 0) return apply<OP1>(a, b);
  return apply<(OP2 < 0 ? 0 : OP2)>(apply<OP1>(a, b), c);
}

template <int OP1, int OP2>
__global__ void bitwise_kernel(const uint32_t* __restrict__ x,
                               const uint32_t* __restrict__ y,
                               const uint32_t* __restrict__ z,
                               uint32_t* __restrict__ out, int64_t n,
                               bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    const uint4* y4 = reinterpret_cast<const uint4*>(y);
    const uint4* z4 = reinterpret_cast<const uint4*>(z);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const uint4 a = x4[i], b = y4[i];
      uint4 c = make_uint4(0, 0, 0, 0);
      if (OP2 >= 0) c = z4[i];
      o4[i] = make_uint4(elem<OP1, OP2>(a.x, b.x, c.x),
                         elem<OP1, OP2>(a.y, b.y, c.y),
                         elem<OP1, OP2>(a.z, b.z, c.z),
                         elem<OP1, OP2>(a.w, b.w, c.w));
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = elem<OP1, OP2>(x[i], y[i], OP2 >= 0 ? z[i] : 0u);
}

template <int OP1, int OP2>
static cudaError_t launch(const uint32_t* x, const uint32_t* y,
                          const uint32_t* z, uint32_t* out, int64_t n,
                          cudaStream_t s) {
  const int threads = 256;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(z) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t work = vec ? (n + 3) / 4 : n;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > (int64_t)sms * 32) blocks = (int64_t)sms * 32;  // then stride
  bitwise_kernel<OP1, OP2><<<(unsigned)blocks, threads, 0, s>>>(
      x, y, z, out, n, vec);
  return cudaGetLastError();
}

template <int OP1>
static cudaError_t dispatch2(int op2, const uint32_t* x, const uint32_t* y,
                             const uint32_t* z, uint32_t* out, int64_t n,
                             cudaStream_t s) {
  switch (op2) {
    case -1: return launch<OP1, -1>(x, y, z, out, n, s);
    case AND: return launch<OP1, AND>(x, y, z, out, n, s);
    case OR: return launch<OP1, OR>(x, y, z, out, n, s);
    case XOR: return launch<OP1, XOR>(x, y, z, out, n, s);
    case ADD: return launch<OP1, ADD>(x, y, z, out, n, s);
    case SUB: return launch<OP1, SUB>(x, y, z, out, n, s);
  }
  return cudaErrorInvalidValue;
}

// out = x op1 y (op2 = -1, z may be null), or (x op1 y) op2 z; n elements
// of 32 bits each.  Ops: 0 and, 1 or, 2 xor, 3 add, 4 sub.
extern "C" int cim_bitwise(const uint32_t* x, const uint32_t* y,
                           const uint32_t* z, uint32_t* out, int64_t n,
                           int op1, int op2, void* stream) {
  if (n == 0) return 0;
  if (op2 < 0) z = x;  // never read; keeps the alignment test uniform
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op1) {
    case AND: return (int)dispatch2<AND>(op2, x, y, z, out, n, s);
    case OR: return (int)dispatch2<OR>(op2, x, y, z, out, n, s);
    case XOR: return (int)dispatch2<XOR>(op2, x, y, z, out, n, s);
    case ADD: return (int)dispatch2<ADD>(op2, x, y, z, out, n, s);
    case SUB: return (int)dispatch2<SUB>(op2, x, y, z, out, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
