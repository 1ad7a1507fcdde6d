// Pricing's counts, the integers profile_system prices a design point from,
// in one launch and one readback.
//
// Replaces no TPU kernel: the reference counts with numpy bincounts on the
// host (repro/core/profiler.py, Profiler._unit_counts / _mem_counts, and
// OffloadResult.macr_breakdown's L1 count).  On the card those were a chain
// of some 30 library launches (bincounts, gathers at host_seqs, boolean-mask
// selections, reductions) and about 14 host syncs a point; this kernel
// writes every count into one small int64 buffer, which the launcher copies
// to pinned host memory before it synchronises once.
//
// One launch walks three ranges as one index space of n + n_host + n_conv
// items, reading the trace columns in place:
//   rows       i < n:          unit[i] -> UNITS_ALL + unit;
//                              level[i] > 0 -> MEM_ALL + level * 2 + is_store;
//                              op[i] is a load or a store -> MEM_ROWS
//   host rows  host_seqs[j]:   the same two histograms, at UNITS_HOST and
//                              MEM_HOST, over the rows the CiM run keeps
//   converted  conv[k]:        level[conv[k]] == L1 -> CONV_L1
// A unit outside [0, 16) (the trace's 4-bit field), a level above MEM, or a
// host or converted index outside [0, n) counts into BAD, which the wrapper
// refuses.  The layout is price_counts.py's; N_OUT int64 in all.
//
// What bounds it on the H100: launch latency.  The largest call of the main
// path (astar at 32K+256K, both levels: 63,031 rows, 39,181 host rows) reads
// about 1 MB, 0.3 us of HBM time, far below one launch, so the design is one
// launch and a short host path: a memset, the kernel, a copy to pinned
// memory and one stream synchronisation, all inside one C call.  Each block
// keeps a private histogram in shared memory (fewer than 64 bins); the lanes
// of a warp that hit one bin add once (__match_any_sync), and each block
// merges its nonzero bins into the output with one global atomic a bin.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;                     // items a thread, for the grid
constexpr int64_t MAX_BLOCKS = 1024;         // beyond, warps stride
constexpr unsigned FULL = 0xffffffffu;
// repro_torch.core.isa: OP_LOAD, OP_STORE, LEVEL_L1, LEVEL_MEM
constexpr int OP_LOAD = 0, OP_STORE = 1, LEVEL_L1 = 1, LEVEL_MEM = 3;
// the output layout (repro_torch.core.accel.price_counts)
constexpr int UNIT_BINS = 16, MEM_BINS = 8;
constexpr int UNITS_ALL = 0, UNITS_HOST = UNITS_ALL + UNIT_BINS,
              MEM_ALL = UNITS_HOST + UNIT_BINS, MEM_HOST = MEM_ALL + MEM_BINS,
              MEM_ROWS = MEM_HOST + MEM_BINS, CONV_L1 = MEM_ROWS + 1,
              BAD = CONV_L1 + 1, N_OUT = BAD + 1;
constexpr int NO_BIN = -1;

// one bin per lane (NO_BIN: nothing); the lanes of a bin add once
__device__ __forceinline__ void warp_add(unsigned* hist, int bin, int lane) {
  const unsigned peers = __match_any_sync(FULL, bin);
  if (bin != NO_BIN && (peers & ((1u << lane) - 1)) == 0)
    atomicAdd(&hist[bin], (unsigned)__popc(peers));
}

__device__ __forceinline__ int unit_bin(int base, int u) {
  return u >= 0 && u < UNIT_BINS ? base + u : BAD;
}

__device__ __forceinline__ int mem_bin(int base, int lv, int o) {
  if (lv <= 0) return NO_BIN;
  return lv <= LEVEL_MEM ? base + lv * 2 + (o == OP_STORE) : BAD;
}

__global__ void __launch_bounds__(THREADS)
price_counts_kernel(const int8_t* __restrict__ unit,
                    const int8_t* __restrict__ level,
                    const int16_t* __restrict__ op, int64_t n,
                    const int64_t* __restrict__ host_seqs, int64_t n_host,
                    const int64_t* __restrict__ conv, int64_t n_conv,
                    unsigned long long* __restrict__ out) {
  __shared__ unsigned hist[N_OUT];
  for (int b = threadIdx.x; b < N_OUT; b += THREADS) hist[b] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t total = n + n_host + n_conv;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  // base is warp-uniform, so every lane reaches each warp_add
  for (int64_t base = (int64_t)blockIdx.x * THREADS + (threadIdx.x & ~31);
       base < total; base += stride) {
    const int64_t i = base + lane;
    int b0 = NO_BIN, b1 = NO_BIN, b2 = NO_BIN;
    if (i < n) {
      const int o = op[i];
      b0 = unit_bin(UNITS_ALL, unit[i]);
      b1 = mem_bin(MEM_ALL, level[i], o);
      b2 = o == OP_LOAD || o == OP_STORE ? MEM_ROWS : NO_BIN;
    } else if (i < n + n_host) {
      const int64_t s = host_seqs[i - n];
      if (s < 0 || s >= n) {
        b0 = BAD;
      } else {
        b0 = unit_bin(UNITS_HOST, unit[s]);
        b1 = mem_bin(MEM_HOST, level[s], op[s]);
      }
    } else if (i < total) {
      const int64_t s = conv[i - n - n_host];
      if (s < 0 || s >= n) b0 = BAD;
      else if (level[s] == LEVEL_L1) b0 = CONV_L1;
    }
    warp_add(hist, b0, lane);
    warp_add(hist, b1, lane);
    warp_add(hist, b2, lane);
  }

  __syncthreads();
  for (int b = threadIdx.x; b < N_OUT; b += THREADS)
    if (hist[b]) atomicAdd(&out[b], (unsigned long long)hist[b]);
}

}  // namespace

// The counts of n trace rows (unit, level: int8; op: int16), of the n_host
// rows at host_seqs and of the n_conv converted accesses at conv (int64
// indices), into out (N_OUT int64 on the device, zeroed here).  With host
// non-null (pinned, N_OUT int64) the counts are also copied there and the
// stream synchronised before the call returns.
extern "C" int price_counts(const int8_t* unit, const int8_t* level,
                            const int16_t* op, int64_t n,
                            const int64_t* host_seqs, int64_t n_host,
                            const int64_t* conv, int64_t n_conv, int64_t* out,
                            int64_t* host, void* stream) {
  if (n < 0 || n_host < 0 || n_conv < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, N_OUT * sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = n + n_host + n_conv;
  if (total > 0) {
    int64_t blocks = (total + THREADS * ITEMS - 1) / (THREADS * ITEMS);
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    price_counts_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
        unit, level, op, n, host_seqs, n_host, conv, n_conv,
        reinterpret_cast<unsigned long long*>(out));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (host == nullptr) return 0;
  err = cudaMemcpyAsync(host, out, N_OUT * sizeof(int64_t),
                        cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return (int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
