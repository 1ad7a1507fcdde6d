// Placement, the vectorized half of Algorithm 1: per proto-candidate its
// target CiM level, operand moves, DRAM fills and home bank, in one launch.
//
// Replaces repro/core/accel/place.py:144 (place_candidates_jax, one jitted
// JAX kernel composing the Pallas segment reductions of pallas_ops.py: a
// segment max of leaf depths, a searchsorted lift, a segment sum of the
// shallower leaves, and a lexsort of (proto, line) pairs whose group heads
// are segment-summed into the DRAM fills).  The TPU version flattens every
// proto into one padded stream because its segment ops want one; here the
// flat arrays keep each proto's leaves and accesses contiguous (CSR
// offsets leaf_off / acc_off), so a proto's work is local to one run and
// needs no global sort: one warp takes one proto.
//
// Per proto p (leaves leaf_seq[leaf_off[p] .. leaf_off[p+1]), accesses
// acc_seq[acc_off[p] .. acc_off[p+1])), reading the trace columns in place:
//   depth(leaf)  = min(level[leaf] - 1, depth_cap)
//   target       = the shallowest enabled depth >= max(0, max depth), else
//                  the deepest enabled depth
//   moves        = the leaves with depth < target
//   fills        = the distinct lines addr >> 6 (an arithmetic shift: the
//                  floor division of both packages) among the accesses
//                  that main memory served (level == LEVEL_MEM)
//   bank         = bank[first_load[p]]
// out is (4, n_protos) int32: target, moves, fills, bank.
//
// What bounds it on the H100: bytes -- the flat arrays and the columns
// gathered through them, about 0.2 MB at the largest placement (astar,
// 0.06 us of HBM time) -- far below a launch, so the design spends one
// launch and a short host path: the launcher queries nothing of the
// device, and with a pinned host buffer it also copies the result there
// and synchronises the stream, so a placement is one call from Python.
//
// Distinct lines without a sort: an access counts when no earlier
// MEM-served access of its run has its line.  The warp walks the run in
// chunks of 32: __match_any_sync finds the equal lines inside a chunk (the
// lowest lane of each group counts), and each earlier chunk is broadcast
// lane by lane with __shfl_sync to clear lanes whose line came before.
// That is O(run^2 / 32) shuffles for a warp: a run of the fixtures holds
// at most 105 accesses (4 chunks), and a run of any length stays exact.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int64_t MAX_BLOCKS = 8192;         // beyond, warps stride
constexpr unsigned FULL = 0xffffffffu;
constexpr int LEVEL_MEM = 3;                 // repro_torch.core.isa
constexpr long long NONE = INT64_MIN;        // no line: addr >> 6 > NONE

__device__ __forceinline__ long long mem_line(const int8_t* level,
                                              const int64_t* addr,
                                              int64_t seq) {
  return level[seq] == LEVEL_MEM ? (long long)(addr[seq] >> 6) : NONE;
}

__global__ void __launch_bounds__(THREADS)
place_kernel(const int8_t* __restrict__ level,
             const int64_t* __restrict__ addr,
             const int16_t* __restrict__ bank,
             const int64_t* __restrict__ leaf_seq,
             const int64_t* __restrict__ leaf_off,
             const int64_t* __restrict__ acc_seq,
             const int64_t* __restrict__ acc_off,
             const int64_t* __restrict__ first_load, int64_t n,
             unsigned enabled_mask, int depth_cap,
             int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;   // the lanes before this one
  const int64_t n_warps = (int64_t)gridDim.x * WARPS;
  for (int64_t p = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32; p < n;
       p += n_warps) {                       // warp-uniform
    // target: the deepest leaf, lifted to an enabled depth
    const int64_t l0 = leaf_off[p], l1 = leaf_off[p + 1];
    int deepest = 0;                         // an empty proto places at 0
    for (int64_t i = l0 + lane; i < l1; i += 32)
      deepest = max(deepest, min((int)level[leaf_seq[i]] - 1, depth_cap));
    deepest = __reduce_max_sync(FULL, deepest);
    const unsigned at_or_below = enabled_mask >> deepest;
    const int target = at_or_below ? deepest + __ffs(at_or_below) - 1
                                   : 31 - __clz(enabled_mask);

    // moves: leaves resident shallower than the target
    unsigned moves = 0;
    for (int64_t i = l0 + lane; i < l1; i += 32)
      moves += min((int)level[leaf_seq[i]] - 1, depth_cap) < target;
    moves = __reduce_add_sync(FULL, moves);

    // fills: distinct lines among the MEM-served accesses of the run
    const int64_t a0 = acc_off[p], a1 = acc_off[p + 1];
    int fills = 0;
    for (int64_t base = a0; base < a1; base += 32) {
      const int64_t i = base + lane;
      const long long line = i < a1 ? mem_line(level, addr, acc_seq[i])
                                    : NONE;
      const unsigned same = __match_any_sync(FULL, line);
      bool first = line != NONE && (same & below) == 0;
      for (int64_t prev = a0; prev < base && __any_sync(FULL, first);
           prev += 32) {                     // earlier chunks are full
        const long long seen = mem_line(level, addr, acc_seq[prev + lane]);
        for (int k = 0; k < 32; ++k)
          first &= __shfl_sync(FULL, seen, k) != line;
      }
      fills += __popc(__ballot_sync(FULL, first));
    }

    if (lane == 0) {
      out[p] = target;
      out[n + p] = (int32_t)moves;
      out[2 * n + p] = fills;
      out[3 * n + p] = bank[first_load[p]];
    }
  }
}

}  // namespace

// Placement of n_protos > 0 protos into out (4 * n_protos int32 on the
// device).  enabled_mask has bit d set for each enabled CiM depth d
// (depths < 32); depth_cap is the deepest of them.  With host non-null
// (pinned, 4 * n_protos int32) the result is also copied there and the
// stream synchronised before the call returns.
extern "C" int place(const int8_t* level, const int64_t* addr,
                     const int16_t* bank, const int64_t* leaf_seq,
                     const int64_t* leaf_off, const int64_t* acc_seq,
                     const int64_t* acc_off, const int64_t* first_load,
                     int64_t n_protos, unsigned enabled_mask, int depth_cap,
                     int32_t* out, int32_t* host, void* stream) {
  if (n_protos <= 0 || enabled_mask == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t blocks = (n_protos + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  place_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      level, addr, bank, leaf_seq, leaf_off, acc_seq, acc_off, first_load,
      n_protos, enabled_mask, depth_cap, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || host == nullptr) return (int)err;
  err = cudaMemcpyAsync(host, out, 4 * n_protos * sizeof(int32_t),
                        cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return (int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
