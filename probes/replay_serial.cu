// Probe: the serial look-ahead design of the batched cache replay, kept to
// be timed against the kernel the port runs (repro_torch/core/accel/
// csrc/replay.cu) by probes/replay_variants.py.  It ports no TPU kernel
// and no path of repro_torch runs it; it has the kernel's C interface
// (replay_batch) and gives its results, bit for bit.
//
// Design: one warp walks the stream one access at a time, lane w owning
// way w of the probed set.  A first level that fits lives in shared
// memory (templated on where it lives, reached through the dynamic
// shared-memory symbol), tags are set-local and stamps count touches in
// 32-bit words where the stream allows (templated on W); each lane loads
// its way's tag of access t+1's set while access t resolves, and a fill
// into that set forwards the new tag from registers; a repeat of the last
// access's line takes no load and no stamp; the level, hit and bank
// columns are computed per chunk of 32 after the walk, and the global
// scratch is cleared by cudaMemsetAsync.  Every access is still one step
// of the warp's chain, which the look-ahead shortens but does not remove.
#include <cstdint>
#include <cuda_runtime.h>

extern __shared__ __align__(16) unsigned char replay_smem[];

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // the walk is warp 0; all clear shared state
constexpr int kRing = 64;      // access records staged: two chunks of 32
constexpr int kParams = 7;     // per (geometry, level): sets, assoc, banks,
                               // mshrs, offset of its ways in the scratch,
                               // log2(sets) or -1, level code

template <typename W>
__host__ __device__ constexpr size_t ring_bytes() {
  return kRing * (sizeof(int64_t) + sizeof(W) + sizeof(int) + 1);
}

template <typename W>
struct Ring {  // the staged access records, in shared memory
  __device__ static int64_t& line(int i) {
    return reinterpret_cast<int64_t*>(replay_smem)[i];
  }
  __device__ static W& tag(int i) {
    return reinterpret_cast<W*>(replay_smem + kRing * 8)[i];
  }
  __device__ static int& set(int i) {
    return reinterpret_cast<int*>(replay_smem + kRing * (8 + sizeof(W)))[i];
  }
  __device__ static uint8_t& flags(int i) {  // bit 0 write, bit 1 repeat
    return (replay_smem + kRing * (12 + sizeof(W)))[i];
  }
};

// A level's tags, stamps and dirty bits: in shared memory after the ring
// (SHARED) or in the global scratch.
template <typename W, bool SHARED>
struct Ways;

template <typename W>
struct Ways<W, true> {
  int n;  // ways of the level
  __device__ W* base() const {
    return reinterpret_cast<W*>(replay_smem + ring_bytes<W>());
  }
  __device__ W& tag(int i) const { return base()[i]; }
  __device__ W& stamp(int i) const { return base()[n + i]; }
  __device__ uint8_t& dirty(int i) const {
    return reinterpret_cast<uint8_t*>(base() + 2 * n)[i];
  }
};

template <typename W>
struct Ways<W, false> {
  W* tags;
  W* stamps;
  uint8_t* dirt;
  __device__ W& tag(int i) const { return tags[i]; }
  __device__ W& stamp(int i) const { return stamps[i]; }
  __device__ uint8_t& dirty(int i) const { return dirt[i]; }
};

struct Geo {
  int64_t sets, banks;
  int assoc, mshrs, shift, code;
};

template <typename W>
__device__ __forceinline__ void split(const Geo& g, int64_t line, int& set,
                                      W& tag) {
  if (g.shift >= 0) {
    set = (int)(line & (g.sets - 1));
    tag = (W)(line >> g.shift);
  } else {
    set = (int)(line % g.sets);
    tag = (W)(line / g.sets);
  }
}

template <typename W>
__device__ __forceinline__ int64_t join(const Geo& g, W tag, int set) {
  return g.shift >= 0 ? (((int64_t)tag << g.shift) | set)
                      : (int64_t)tag * g.sets + set;
}

__device__ __forceinline__ unsigned low_lanes(int k) {
  return k >= 32 ? kFull : ((1u << k) - 1u);
}

// Lane holding the smallest key (ties: lowest lane); the same in all lanes.
__device__ __forceinline__ int argmin_lane(uint32_t key) {
  const uint32_t m = __reduce_min_sync(kFull, key);
  return __ffs(__ballot_sync(kFull, key == m)) - 1;
}

__device__ __forceinline__ int argmin_lane(unsigned long long key) {
  unsigned long long best = key;
  int best_lane = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long k = __shfl_xor_sync(kFull, best, o);
    const int l = __shfl_xor_sync(kFull, best_lane, o);
    if (k < best || (k == best && l < best_lane)) {
      best = k;
      best_lane = l;
    }
  }
  return best_lane;
}

// _Level.lookup on a deeper level: a hit refreshes the way's LRU position.
template <typename W, class Ws>
__device__ __forceinline__ bool lookup(const Ws& ws, const Geo& g,
                                       int64_t line, W& touch) {
  const int lane = threadIdx.x;
  int set;
  W tag;
  split(g, line, set, tag);
  const int i = set * g.assoc + lane;
  const bool mine = lane < g.assoc && ws.tag(i) == tag;
  if (!__ballot_sync(kFull, mine)) return false;
  ++touch;
  if (mine) ws.stamp(i) = touch;
  return true;
}

// _Level.mshr_probe: true if the miss merges into an in-flight entry.
template <typename W>
__device__ __forceinline__ bool mshr_probe(int64_t& mline, W& mstamp,
                                           int mshrs, int64_t line, W t) {
  const int lane = threadIdx.x;
  const bool slot = lane < mshrs;
  if (__ballot_sync(kFull, slot && mline == line)) return true;
  const unsigned occ = __ballot_sync(kFull, slot && mline >= 0);
  const int victim =
      __popc(occ) >= mshrs
          ? argmin_lane(slot && mline >= 0 ? mstamp : ~(W)0)
          : __ffs(~occ & low_lanes(mshrs)) - 1;
  if (lane == victim) {
    mline = line;
    mstamp = t;
  }
  return false;
}

// _Level.fill: insert (or refresh) a line; returns true when a dirty
// victim was evicted, its line in `victim`; the way that now holds the
// line in `way`, its index in the level in `idx`.
template <typename W, class Ws>
__device__ __forceinline__ bool fill(const Ws& ws, const Geo& g,
                                     int64_t line, bool dirty_in, W& touch,
                                     int64_t& victim, int64_t& writebacks,
                                     int& way, int& idx) {
  const int lane = threadIdx.x;
  const bool way_ok = lane < g.assoc;
  int set;
  W tag;
  split(g, line, set, tag);
  const int i = set * g.assoc + lane;
  // the three loads are independent: one round trip
  const W cur = way_ok ? ws.tag(i) : ~(W)0;
  const W st = way_ok ? ws.stamp(i) : ~(W)0;
  const int d = way_ok ? (int)ws.dirty(i) : 0;
  ++touch;
  const unsigned hm = __ballot_sync(kFull, way_ok && cur == tag);
  idx = set * g.assoc;
  if (hm) {
    way = __ffs(hm) - 1;
    idx += way;
    if (lane == way) {
      if (dirty_in) ws.dirty(i) = 1;
      ws.stamp(i) = touch;
    }
    return false;
  }
  const unsigned occ = __ballot_sync(kFull, way_ok && cur != ~(W)0);
  bool dirty_victim = false;
  if (__popc(occ) >= g.assoc) {
    way = argmin_lane(st);
    dirty_victim = __shfl_sync(kFull, d, way) != 0;
    victim = join(g, (W)__shfl_sync(kFull, cur, way), set);
  } else {
    way = __ffs(~occ & low_lanes(g.assoc)) - 1;
  }
  idx += way;
  if (lane == way) {
    ws.tag(i) = tag;
    ws.dirty(i) = dirty_in ? 1 : 0;
    ws.stamp(i) = touch;
  }
  if (dirty_victim) ++writebacks;
  return dirty_victim;
}

template <int L, typename W, bool S0>
__global__ void __launch_bounds__(kThreads, 1)
    replay_kernel(const int64_t* __restrict__ addrs,
                  const uint8_t* __restrict__ is_write, int64_t n,
                  int line_shift, const int64_t* __restrict__ params,
                  W* g_tags, W* g_stamp, uint8_t* g_dirty, int mem_code,
                  int8_t* __restrict__ level_out,
                  int8_t* __restrict__ hit_out,
                  int16_t* __restrict__ bank_out,
                  uint8_t* __restrict__ merged_out,
                  int64_t* __restrict__ counters) {
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  using Ways0 = Ways<W, S0>;
  using WaysG = Ways<W, false>;

  Geo geo[L];
  WaysG deep[L];
  Ways0 first;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int64_t* p = params + ((int64_t)g * L + l) * kParams;
    geo[l] = Geo{p[0], p[2], (int)p[1], (int)p[3], (int)p[5], (int)p[6]};
    deep[l] = WaysG{g_tags + p[4], g_stamp + p[4], g_dirty + p[4]};
  }
  if constexpr (S0) {
    first.n = (int)(geo[0].sets * geo[0].assoc);
    // all threads clear the shared first level: tags to all ones,
    // stamps and dirty bits to zero
    W* base = first.base();
    for (int i = lane; i < first.n; i += kThreads) {
      base[i] = ~(W)0;
      base[first.n + i] = 0;
      first.dirty(i) = 0;
    }
  } else {
    first = deep[0];
  }
  __syncthreads();
  if (lane >= 32) return;

  const Geo g0 = geo[0];
  int64_t mline[L];
  W mstamp[L];
  int64_t hits[L], misses[L], wbs[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    mline[l] = -1;
    mstamp[l] = 0;
    hits[l] = misses[l] = wbs[l] = 0;
  }
  int64_t mem_reads = 0, mem_writes = 0;
  W touch = 0;

  // ---- the access records: loads from global memory two chunks ahead,
  //      staged into the shared ring one chunk ahead of the walk
  int64_t r_line = 0, r_prev = -1;
  int r_wr = 0;
  int64_t r_t = 0;
  auto fetch = [&](int64_t t0) {
    r_t = t0 + lane;
    r_line = r_t < n ? addrs[r_t] >> line_shift : 0;
    r_prev = (r_t >= 1 && r_t < n) ? addrs[r_t - 1] >> line_shift : -1;
    r_wr = r_t < n ? (int)is_write[r_t] : 0;
  };
  auto stage = [&]() {
    const int slot = (int)(r_t & (kRing - 1));
    int set;
    W tag;
    split(g0, r_line, set, tag);
    Ring<W>::line(slot) = r_line;
    Ring<W>::tag(slot) = tag;
    Ring<W>::set(slot) = set;
    Ring<W>::flags(slot) =
        (uint8_t)((r_wr ? 1 : 0) | (r_line == r_prev ? 2 : 0));
  };
  fetch(0);
  stage();
  fetch(32);

  // the walk's rolling registers: access t (set, tag, flags, this lane's
  // way tag loaded ahead) and access t+1 (set, tag, flags)
  int way0 = 0, idx0 = 0;  // first-level way of the last access's line
  __syncwarp();
  int c_set = Ring<W>::set(0);
  W c_tag = Ring<W>::tag(0);
  int c_flags = Ring<W>::flags(0);
  W c_way = lane < g0.assoc ? first.tag(c_set * g0.assoc + lane) : ~(W)0;
  int n_set = Ring<W>::set(1);
  W n_tag = Ring<W>::tag(1);
  int n_flags = Ring<W>::flags(1);

  for (int64_t t0 = 0; t0 < n; t0 += 32) {
    __syncwarp();  // the slots of chunk t0 - 32 are read
    stage();       // chunk t0 + 32 (loaded during the last chunk)
    fetch(t0 + 64);
    __syncwarp();
    const int count = n - t0 < 32 ? (int)(n - t0) : 32;
    int my_service = 0, my_merged = 0;
    for (int k = 0; k < count; ++k) {
      const int64_t t = t0 + k;
      // ahead: this lane's way of access t+1's set, and t+2's record
      W nx_way = lane < g0.assoc ? first.tag(n_set * g0.assoc + lane)
                                 : ~(W)0;
      const int s2 = (int)((t + 2) & (kRing - 1));
      const int n2_set = Ring<W>::set(s2);
      const W n2_tag = Ring<W>::tag(s2);
      const int n2_flags = Ring<W>::flags(s2);

      int service = 1;
      bool merged = false;
      if (!(c_flags & 2)) {
        const unsigned hm =
            __ballot_sync(kFull, lane < g0.assoc && c_way == c_tag);
        if (hm) {  // first-level hit
          way0 = __ffs(hm) - 1;
          idx0 = c_set * g0.assoc + way0;
          ++touch;
          if (lane == way0) first.stamp(idx0) = touch;
        } else {
          // first-level miss: probe the MSHR file and the deeper levels
          const int64_t line = Ring<W>::line((int)(t & (kRing - 1)));
          ++misses[0];
          merged = mshr_probe(mline[0], mstamp[0], g0.mshrs, line, (W)t);
          service = L + 1;
#pragma unroll
          for (int l = 1; l < L; ++l) {
            if (service == L + 1) {
              if (lookup(deep[l], geo[l], line, touch)) {
                service = l + 1;
                ++hits[l];
              } else {
                ++misses[l];
                merged = mshr_probe(mline[l], mstamp[l], geo[l].mshrs, line,
                                    (W)t) ||
                         merged;
              }
            }
          }
          if (service == L + 1) ++mem_reads;
          // fill every level above the service point; a dirty victim
          // cascades into the next level, and off the last level it is a
          // DRAM write
#pragma unroll
          for (int i = 0; i < L; ++i) {
            if (i < service - 1) {
              int64_t v = 0;
              int way, idx;
              bool dv = i == 0 ? fill(first, geo[0], line, false, touch, v,
                                      wbs[0], way0, idx0)
                               : fill(deep[i], geo[i], line, false, touch, v,
                                      wbs[i], way, idx);
#pragma unroll
              for (int m = i + 1; m < L; ++m)
                if (dv) dv = fill(deep[m], geo[m], v, true, touch, v, wbs[m],
                                  way, idx);
              if (dv) ++mem_writes;
            }
          }
          // forward the filled tag to access t+1's loaded-ahead way
          if (n_set == c_set && lane == way0) nx_way = c_tag;
        }
      }
      if (service == 1) ++hits[0];
      // write-allocate: the line is now in the first level at way0
      if ((c_flags & 1) && lane == way0) first.dirty(idx0) = 1;
      if (lane == k) {
        my_service = service;
        my_merged = merged;
      }
      c_set = n_set;
      c_tag = n_tag;
      c_flags = n_flags;
      c_way = nx_way;
      n_set = n2_set;
      n_tag = n2_tag;
      n_flags = n2_flags;
    }
    // epilogue: the level code, hit, bank and merge columns of this chunk,
    // one access a lane
    if (lane < count) {
      const int64_t line = Ring<W>::line((int)((t0 + lane) & (kRing - 1)));
      int code = mem_code, banks_level = L - 1;
#pragma unroll
      for (int l = 0; l < L; ++l)
        if (my_service == l + 1) {
          code = geo[l].code;
          banks_level = l;
        }
      int64_t banks = geo[0].banks;
#pragma unroll
      for (int l = 1; l < L; ++l)
        if (banks_level == l) banks = geo[l].banks;
      const int64_t bank =
          (banks & (banks - 1)) == 0 ? (line & (banks - 1)) : line % banks;
      const int64_t o = (int64_t)g * n + t0 + lane;
      level_out[o] = (int8_t)code;
      hit_out[o] = (int8_t)(my_service == 1);
      bank_out[o] = (int16_t)bank;
      merged_out[o] = (uint8_t)my_merged;
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

template <int L, typename W, bool S0>
cudaError_t launch(const int64_t* addrs, const uint8_t* is_write, int64_t n,
                   int line_shift, const int64_t* params, int n_geometries,
                   int l0_ways, void* scratch, int64_t scratch_ways,
                   int mem_code, int8_t* level, int8_t* hit, int16_t* bank,
                   uint8_t* merged, int64_t* counters, cudaStream_t s) {
  W* tags = static_cast<W*>(scratch);
  W* stamp = tags + scratch_ways;
  uint8_t* dirty = reinterpret_cast<uint8_t*>(stamp + scratch_ways);
  if (scratch_ways) {  // clear the deeper levels before the walk
    cudaError_t err =
        cudaMemsetAsync(tags, 0xff, sizeof(W) * scratch_ways, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(stamp, 0, (sizeof(W) + 1) * scratch_ways, s);
    if (err != cudaSuccess) return err;
  }
  const size_t smem =
      ring_bytes<W>() + (S0 ? (size_t)l0_ways * (2 * sizeof(W) + 1) : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        replay_kernel<L, W, S0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  replay_kernel<L, W, S0><<<n_geometries, kThreads, smem, s>>>(
      addrs, is_write, n, line_shift, params, tags, stamp, dirty, mem_code,
      level, hit, bank, merged, counters);
  return cudaGetLastError();
}

}  // namespace

// addrs: the stream's byte addresses (int64, >= 0), a line is addr >>
// line_shift; params: kParams int64 per (geometry, level); scratch:
// scratch_ways * (2 * word + 1) bytes for the levels kept in global memory
// (cleared here); wide: 64-bit words (else 32-bit); l0_shared: the first
// level in shared memory, l0_ways its most ways; outputs (n_geometries, n).
extern "C" int replay_batch(const int64_t* addrs, const uint8_t* is_write,
                            int64_t n, int line_shift, const int64_t* params,
                            int n_geometries, int depth, int wide,
                            int l0_shared, int l0_ways, void* scratch,
                            int64_t scratch_ways, int mem_code, int8_t* level,
                            int8_t* hit, int16_t* bank, uint8_t* merged,
                            int64_t* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPLAY_CASE(L, W, S0)                                              \
  if (depth == L && wide == (sizeof(W) == 8) && (l0_shared != 0) == S0)   \
    return (int)launch<L, W, S0>(addrs, is_write, n, line_shift, params,   \
                                 n_geometries, l0_ways, scratch,           \
                                 scratch_ways, mem_code, level, hit, bank, \
                                 merged, counters, s);
  REPLAY_CASE(1, uint32_t, true)
  REPLAY_CASE(1, uint32_t, false)
  REPLAY_CASE(1, unsigned long long, true)
  REPLAY_CASE(1, unsigned long long, false)
  REPLAY_CASE(2, uint32_t, true)
  REPLAY_CASE(2, uint32_t, false)
  REPLAY_CASE(2, unsigned long long, true)
  REPLAY_CASE(2, unsigned long long, false)
#undef REPLAY_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
