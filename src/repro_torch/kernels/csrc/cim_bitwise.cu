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
// is far below the card's integer rate.  The design is the shape that came
// closest to the bytes bound among the 68 that probes/bulk_stream.py
// times on the card (x & y on 4096x8192 int32, 128 MiB an operand, in
// turns with torch.bitwise_and; PERF.md): the plainest one.
// - One 16-byte vector a thread, blocks of 1,024 threads, a grid as large
//   as the array (threads stride only past 2^31 blocks), so the block
//   scheduler keeps every SM full to the end and each load of a warp reads
//   512 contiguous bytes.  Blocks of 128 to 512 threads ran 0.1 to 0.4%
//   slower; two vectors a thread 0.4%, four 0.9 to 1.1%, eight 1.6 to 4%;
//   a persistent one-wave grid striding over the array 5 to 7%.
// - The default cache policy.  Streaming hints (__ldcs / __stcs), an L1
//   no-allocate or L2 evict-first policy on the loads cost 1.5 to 3%; a
//   256-byte L2 prefetch hint or __ldg nothing; a TMA ring (cp.async.bulk
//   into shared memory, completed on mbarriers) 4 to 7%.
// - uint4 vectors (four elements) when every pointer is 16-byte aligned,
//   with the last n % 4 elements done by block 0; else single elements.
//   The op (or op pair) is a template argument.
// The launcher queries nothing of the device.  int32 and uint32 both run
// as uint32: two's-complement add and sub wrap alike in either, which is
// what the reference's XLA arithmetic does.
#include <cstdint>
#include <cuda_runtime.h>

enum Op { AND = 0, OR = 1, XOR = 2, ADD = 3, SUB = 4 };

constexpr int THREADS = 1024;
constexpr int64_t MAX_BLOCKS = (1LL << 31) - 1;

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
__device__ __forceinline__ uint4 elem(uint4 a, uint4 b, uint4 c) {
  return make_uint4(elem<OP1, OP2>(a.x, b.x, c.x),
                    elem<OP1, OP2>(a.y, b.y, c.y),
                    elem<OP1, OP2>(a.z, b.z, c.z),
                    elem<OP1, OP2>(a.w, b.w, c.w));
}

// out[i] = x[i] op y[i] (op z[i]) for the n / PER vectors of type V (uint4,
// PER = 4, or uint32_t); with uint4, block 0 also does the n % 4 last
// elements
template <int OP1, int OP2, typename V>
__global__ void __launch_bounds__(THREADS)
bitwise_kernel(const uint32_t* __restrict__ x,
               const uint32_t* __restrict__ y,
               const uint32_t* __restrict__ z, uint32_t* __restrict__ out,
               int64_t n) {
  constexpr int PER = sizeof(V) / sizeof(uint32_t);
  const int64_t nv = n / PER;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* yv = reinterpret_cast<const V*>(y);
  const V* zv = reinterpret_cast<const V*>(z);
  V* ov = reinterpret_cast<V*>(out);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < nv;
       i += stride)
    ov[i] = elem<OP1, OP2>(xv[i], yv[i], OP2 >= 0 ? zv[i] : xv[i]);
  if (PER > 1 && blockIdx.x == 0 && threadIdx.x < n - nv * PER) {
    const int64_t j = nv * PER + threadIdx.x;
    out[j] = elem<OP1, OP2>(x[j], y[j], OP2 >= 0 ? z[j] : 0u);
  }
}

template <int OP1, int OP2>
static cudaError_t launch(const uint32_t* x, const uint32_t* y,
                          const uint32_t* z, uint32_t* out, int64_t n,
                          cudaStream_t s) {
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(z) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t blocks = ((vec ? n / 4 : n) + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(blocks < 1 ? 1
                                   : blocks < MAX_BLOCKS ? blocks
                                                         : MAX_BLOCKS);
  if (vec)
    bitwise_kernel<OP1, OP2, uint4><<<grid, THREADS, 0, s>>>(
        x, y, z, out, n);
  else
    bitwise_kernel<OP1, OP2, uint32_t><<<grid, THREADS, 0, s>>>(
        x, y, z, out, n);
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
