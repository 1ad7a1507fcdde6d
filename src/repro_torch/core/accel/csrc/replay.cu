// Batched cache replay: CacheHierarchy.replay for many geometries at once.
//
// Replaces replay_columns_batch of repro/core/accel/replay.py (a jitted,
// geometry-vmapped lax.scan built by _build).  Its plain version is the
// OrderedDict machine of repro_torch/core/cache.py, and the result is
// bit-identical to it: service level, first-level hit, bank and MSHR-merge
// per access, plus the hit/miss/writeback/DRAM counters.
//
// What bounds it on the H100: latency, not bytes or operations.  Each
// access depends on the state every earlier access left, so the stream is
// a dependent chain of ~n steps, each at least one round trip to where the
// probed set lives (shared memory for a small first level, the card's L2
// cache for the rest).
//
// Design:
//   * one thread block per geometry, one warp.  Lane w owns way w of
//     whichever set is probed (assoc <= 32) and MSHR slot w (mshrs <= 32),
//     so a lane only ever reads what it wrote itself; lanes talk through
//     warp votes and shuffles alone.
//   * hits, free ways and the LRU / FIFO victims come from __ballot_sync
//     and a warp-level argmin; the control flow is warp-uniform.
//   * LRU order is a running touch counter per geometry, bumped at every
//     move_to_end / insert in the exact order of CacheHierarchy._access
//     and _writeback; the victim is the least-recently-touched way.  This
//     equals OrderedDict order.  Lines and counters are int64.
//   * MSHR files live in registers (one slot per lane, stamped with the
//     access index: FIFO retirement); a merge is a membership test.
//   * a first level of <= 48 KB of state lives in shared memory; deeper
//     levels (the 2 MB L2 is 32,768 ways, ~557 KB) live in a global
//     scratch tensor the wrapper allocates, which stays in the card's L2.
//   * the access stream is read 32 entries at a time, one per lane, and
//     broadcast with shuffles; results are written back the same way.
//   * templated on the depth L in {1, 2}.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kParams = 5;  // per (geometry, level): sets, assoc, banks,
                            // mshrs, offset of its ways in the scratch

struct Level {
  int64_t* tags;      // [sets * assoc]; -1 marks an empty way
  int64_t* stamp;     // last touch of each way (LRU order)
  uint8_t* dirty;
  int64_t sets, set_mask;    // mask >= 0 when sets is a power of two
  int64_t banks, bank_mask;
  int assoc, mshrs;
};

__device__ __forceinline__ int64_t mod(int64_t x, int64_t n, int64_t mask) {
  return mask >= 0 ? (x & mask) : (x % n);
}

__device__ __forceinline__ unsigned low_lanes(int k) {
  return k >= 32 ? kFull : ((1u << k) - 1u);
}

// Lane holding the smallest key (ties: lowest lane); the same in all lanes.
__device__ __forceinline__ int argmin_lane(int64_t key) {
  int64_t best = key;
  int best_lane = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t k = __shfl_xor_sync(kFull, best, o);
    const int l = __shfl_xor_sync(kFull, best_lane, o);
    if (k < best || (k == best && l < best_lane)) {
      best = k;
      best_lane = l;
    }
  }
  return best_lane;
}

// _Level.lookup: a hit refreshes the way's LRU position.
__device__ __forceinline__ bool lookup(const Level& lv, int64_t line,
                                       int64_t& touch) {
  const int lane = threadIdx.x;
  const int64_t i = mod(line, lv.sets, lv.set_mask) * lv.assoc + lane;
  const bool mine = lane < lv.assoc && lv.tags[i] == line;
  if (!__ballot_sync(kFull, mine)) return false;
  ++touch;
  if (mine) lv.stamp[i] = touch;
  return true;
}

// _Level.mshr_probe: true if the miss merges into an in-flight entry.
__device__ __forceinline__ bool mshr_probe(int64_t& mline, int64_t& mstamp,
                                           int mshrs, int64_t line,
                                           int64_t t) {
  const int lane = threadIdx.x;
  const bool slot = lane < mshrs;
  if (__ballot_sync(kFull, slot && mline == line)) return true;
  const unsigned occ = __ballot_sync(kFull, slot && mline >= 0);
  const int victim = __popc(occ) >= mshrs
                         ? argmin_lane(slot && mline >= 0 ? mstamp : INT64_MAX)
                         : __ffs(~occ & low_lanes(mshrs)) - 1;
  if (lane == victim) {
    mline = line;
    mstamp = t;
  }
  return false;
}

// _Level.fill: insert (or refresh) a line; returns true when a dirty
// victim was evicted, its line in `victim`.
__device__ __forceinline__ bool fill(const Level& lv, int64_t line,
                                     bool dirty_in, int64_t& touch,
                                     int64_t& victim, int64_t& writebacks) {
  const int lane = threadIdx.x;
  const bool way_ok = lane < lv.assoc;
  const int64_t i = mod(line, lv.sets, lv.set_mask) * lv.assoc + lane;
  const int64_t tag = way_ok ? lv.tags[i] : -1;
  ++touch;
  if (__ballot_sync(kFull, way_ok && tag == line)) {
    if (way_ok && tag == line) {
      if (dirty_in) lv.dirty[i] = 1;
      lv.stamp[i] = touch;
    }
    return false;
  }
  const unsigned occ = __ballot_sync(kFull, way_ok && tag >= 0);
  bool dirty_victim = false;
  int way;
  if (__popc(occ) >= lv.assoc) {
    way = argmin_lane(way_ok ? lv.stamp[i] : INT64_MAX);
    dirty_victim =
        __shfl_sync(kFull, way_ok ? (int)lv.dirty[i] : 0, way) != 0;
    victim = __shfl_sync(kFull, tag, way);
  } else {
    way = __ffs(~occ & low_lanes(lv.assoc)) - 1;
  }
  if (lane == way) {
    lv.tags[i] = line;
    lv.dirty[i] = dirty_in ? 1 : 0;
    lv.stamp[i] = touch;
  }
  if (dirty_victim) ++writebacks;
  return dirty_victim;
}

__device__ __forceinline__ void mark_dirty(const Level& lv, int64_t line) {
  const int lane = threadIdx.x;
  const int64_t i = mod(line, lv.sets, lv.set_mask) * lv.assoc + lane;
  if (lane < lv.assoc && lv.tags[i] == line) lv.dirty[i] = 1;
}

template <int L>
__global__ void __launch_bounds__(32)
    replay_kernel(const int64_t* __restrict__ lines,
                  const uint8_t* __restrict__ is_write, int64_t n,
                  const int64_t* __restrict__ params, int l0_shared,
                  int64_t l0_ways, int64_t* g_tags, int64_t* g_stamp,
                  uint8_t* g_dirty, int8_t* __restrict__ service_out,
                  uint8_t* __restrict__ merged_out,
                  int16_t* __restrict__ bank_out,
                  int64_t* __restrict__ counters) {
  extern __shared__ int64_t smem[];
  const int g = blockIdx.x;
  const int lane = threadIdx.x;

  Level lv[L];
  int64_t mline[L], mstamp[L], hits[L], misses[L], wbs[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int64_t* p = params + ((int64_t)g * L + l) * kParams;
    Level& v = lv[l];
    v.sets = p[0];
    v.assoc = (int)p[1];
    v.banks = p[2];
    v.mshrs = (int)p[3];
    v.set_mask = (v.sets & (v.sets - 1)) == 0 ? v.sets - 1 : -1;
    v.bank_mask = (v.banks & (v.banks - 1)) == 0 ? v.banks - 1 : -1;
    if (l == 0 && l0_shared) {
      v.tags = smem;
      v.stamp = smem + l0_ways;
      v.dirty = reinterpret_cast<uint8_t*>(smem + 2 * l0_ways);
    } else {
      v.tags = g_tags + p[4];
      v.stamp = g_stamp + p[4];
      v.dirty = g_dirty + p[4];
    }
    if (lane < v.assoc) {  // each lane clears the way column it owns
      for (int64_t s = 0; s < v.sets; ++s) {
        const int64_t i = s * v.assoc + lane;
        v.tags[i] = -1;
        v.stamp[i] = 0;
        v.dirty[i] = 0;
      }
    }
    mline[l] = -1;
    mstamp[l] = 0;
    hits[l] = misses[l] = wbs[l] = 0;
  }
  int64_t mem_reads = 0, mem_writes = 0, touch = 0;

  for (int64_t t0 = 0; t0 < n; t0 += 32) {
    const int64_t ti = t0 + lane;
    const int64_t my_line = ti < n ? lines[ti] : 0;
    const int my_wr = ti < n ? (int)is_write[ti] : 0;
    int my_service = 0, my_merged = 0;
    int64_t my_bank = 0;
    const int count = n - t0 < 32 ? (int)(n - t0) : 32;
    for (int k = 0; k < count; ++k) {
      const int64_t line = __shfl_sync(kFull, my_line, k);
      const bool wr = __shfl_sync(kFull, my_wr, k) != 0;
      const int64_t t = t0 + k;

      // probe phase: the first hit ends the walk; every missed level
      // probes its MSHR file
      int service = L + 1;
      bool merged = false;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (service == L + 1) {
          if (lookup(lv[l], line, touch)) {
            service = l + 1;
            ++hits[l];
          } else {
            ++misses[l];
            merged = mshr_probe(mline[l], mstamp[l], lv[l].mshrs, line, t) ||
                     merged;
          }
        }
      }
      if (service == L + 1) ++mem_reads;

      // fill phase: allocate in every level above the service point; a
      // dirty victim cascades into the next level, and off the last level
      // it is a DRAM write
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (i < service - 1) {
          int64_t v = 0;
          bool dirty_victim = fill(lv[i], line, false, touch, v, wbs[i]);
#pragma unroll
          for (int m = i + 1; m < L; ++m)
            if (dirty_victim)
              dirty_victim = fill(lv[m], v, true, touch, v, wbs[m]);
          if (dirty_victim) ++mem_writes;
        }
      }
      if (wr) mark_dirty(lv[0], line);  // write-allocate, no LRU reorder

      const int bank_level = (service < L ? service : L) - 1;
      int64_t bank = 0;
#pragma unroll
      for (int l = 0; l < L; ++l)
        if (l == bank_level) bank = mod(line, lv[l].banks, lv[l].bank_mask);
      if (lane == k) {
        my_service = service;
        my_merged = merged;
        my_bank = bank;
      }
    }
    if (ti < n) {
      const int64_t o = (int64_t)g * n + ti;
      service_out[o] = (int8_t)my_service;
      merged_out[o] = (uint8_t)my_merged;
      bank_out[o] = (int16_t)my_bank;
    }
  }
  if (lane == 0) {
    int64_t* c = counters + (int64_t)g * (3 * L + 2);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      c[l] = hits[l];
      c[L + l] = misses[l];
      c[2 * L + l] = wbs[l];
    }
    c[3 * L] = mem_reads;
    c[3 * L + 1] = mem_writes;
  }
}

}  // namespace

extern "C" int replay_batch(const int64_t* lines, const uint8_t* is_write,
                            int64_t n, const int64_t* params,
                            int n_geometries, int depth, int l0_shared,
                            int64_t l0_ways, int64_t* g_tags,
                            int64_t* g_stamp, uint8_t* g_dirty,
                            int8_t* service, uint8_t* merged, int16_t* bank,
                            int64_t* counters, void* stream) {
  const size_t smem = l0_shared ? (size_t)l0_ways * 17 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth == 1)
    replay_kernel<1><<<n_geometries, 32, smem, s>>>(
        lines, is_write, n, params, l0_shared, l0_ways, g_tags, g_stamp,
        g_dirty, service, merged, bank, counters);
  else if (depth == 2)
    replay_kernel<2><<<n_geometries, 32, smem, s>>>(
        lines, is_write, n, params, l0_shared, l0_ways, g_tags, g_stamp,
        g_dirty, service, merged, bank, counters);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
