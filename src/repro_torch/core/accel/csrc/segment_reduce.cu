// Segment reductions of the placement stage: segment_sum / segment_max.
//
// Replaces the Pallas kernels of repro/core/accel/pallas_ops.py
// (segment_sum at line 88 and segment_max at line 96, both through
// _segment_reduce and _seg_kernel, pallas_call at line 73).  The TPU
// version recasts the scatter as a one-hot (8,128)x(128,128) contraction
// because the TPU has a matrix unit and scatters badly; a GPU scatters
// well, so this is a plain scatter with integer atomics.  Integer atomics
// commute, so the result is exact and the same in every run.  Ids outside
// [0, n_segments) are dropped, like jax.ops.segment_*; an empty segment of
// the max is INT32_MIN.
//
// What bounds it on the H100: bytes moved -- each element read once (an
// int32 value and an int32 segment id, 8 bytes), each segment written
// once -- which at the sizes placement gives it (about 10^4 elements and
// segments, 0.03 us of HBM time) is far below the cost of a launch.  So
// the design spends launches, not bytes:
//
// - small (n_segments <= SMEM_SEGMENTS and n <= SMEM_ELEMENTS, all of
//   placement): one launch of one thread-block cluster (8 blocks on 8
//   SMs), no fill.  Each block sets a shared-memory array of all segments
//   to the identity (0, or INT32_MIN) and folds an eighth of the elements
//   into it with shared-memory atomics; then each block folds an eighth
//   of the segments across the 8 arrays through distributed shared
//   memory and writes them, so every output segment is written once and
//   the output needs no initialisation.  SMEM_SEGMENTS = 57,344 int32
//   (224 KiB) is the largest multiple of 1024 segments under the 227 KB a
//   block may hold.  SMEM_ELEMENTS = 65,536 (512 KB of input, 64 KB a
//   block): there the cluster still runs in about 6 us on the device,
//   less than the host spends on a call, so one launch beats the large
//   path's two (chip_smoke.py times both sides of the limit in turns);
//   beyond it the cluster's device time grows with n while the whole-card
//   grid's hardly does.
// - large: a fill kernel sets the output to the identity, then a grid of
//   256-thread blocks strides over the elements with global atomics.
//
// The launcher queries nothing of the device: the large grid is capped at
// a fixed MAX_BLOCKS and strides beyond it.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int SMEM_SEGMENTS = 57344;
constexpr int SMEM_ELEMENTS = 65536;
constexpr int SMALL_THREADS = 1024;
constexpr int CLUSTER = 8;                     // the portable cluster size
constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 4096;

template <bool IS_MAX>
__device__ __forceinline__ void reduce_into(int32_t* p, int32_t v) {
  if (IS_MAX)
    atomicMax(p, v);
  else
    atomicAdd(p, v);
}

// One cluster of CLUSTER blocks.  Each block keeps every segment in its
// shared memory, set to the identity, and folds its share of the elements
// into it with shared-memory atomics; after a cluster barrier, block r
// folds segments [r * per, (r + 1) * per) across the cluster's shared
// memories (distributed shared memory) and writes each once.
template <bool IS_MAX>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(SMALL_THREADS)
    segment_reduce_cluster(const int32_t* __restrict__ vals,
                           const int32_t* __restrict__ ids, int n,
                           int32_t* __restrict__ out, int n_segments) {
  extern __shared__ int32_t acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int32_t ident = IS_MAX ? INT32_MIN : 0;
  for (int s = threadIdx.x; s < n_segments; s += SMALL_THREADS)
    acc[s] = ident;
  __syncthreads();
  constexpr int STRIDE = CLUSTER * SMALL_THREADS;
  // four loads in flight per thread before their atomics
  int i = rank * SMALL_THREADS + threadIdx.x;
  for (; i + 3 * STRIDE < n; i += 4 * STRIDE) {
    int32_t s[4], v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s[u] = ids[i + u * STRIDE];
      v[u] = vals[i + u * STRIDE];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if ((uint32_t)s[u] < (uint32_t)n_segments)
        reduce_into<IS_MAX>(acc + s[u], v[u]);
  }
  for (; i < n; i += STRIDE) {
    const int32_t s = ids[i];
    if ((uint32_t)s < (uint32_t)n_segments)
      reduce_into<IS_MAX>(acc + s, vals[i]);
  }
  cluster.sync();                // every block's partial sums are final
  const int per = (n_segments + CLUSTER - 1) / CLUSTER;
  const int end = min(n_segments, (rank + 1) * per);
  for (int s = rank * per + threadIdx.x; s < end; s += SMALL_THREADS) {
    int32_t r = acc[s];
#pragma unroll
    for (int c = 1; c < CLUSTER; ++c) {
      const int32_t x = cluster.map_shared_rank(acc, (rank + c) % CLUSTER)[s];
      r = IS_MAX ? max(r, x) : (int32_t)((uint32_t)r + (uint32_t)x);
    }
    out[s] = r;
  }
  cluster.sync();                // no block leaves while others read it
}

__global__ void fill_kernel(int32_t* __restrict__ out, int64_t n,
                            int32_t value) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = value;
}

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
    reduce_into<IS_MAX>(out + s, vals[i]);
  }
}

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  return (unsigned)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

template <bool IS_MAX>
cudaError_t launch(const int32_t* vals, const int32_t* ids, int64_t n,
                   int32_t* out, int64_t n_segments, cudaStream_t s) {
  if (n_segments <= SMEM_SEGMENTS && n <= SMEM_ELEMENTS) {
    const int smem = (int)n_segments * (int)sizeof(int32_t);
    if (smem > 48 * 1024) {      // beyond the default, ask for it
      cudaError_t err = cudaFuncSetAttribute(
          segment_reduce_cluster<IS_MAX>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    segment_reduce_cluster<IS_MAX><<<CLUSTER, SMALL_THREADS, smem, s>>>(
        vals, ids, (int)n, out, (int)n_segments);
    return cudaGetLastError();
  }
  fill_kernel<<<grid_for(n_segments), THREADS, 0, s>>>(
      out, n_segments, IS_MAX ? INT32_MIN : 0);
  if (n > 0)
    segment_reduce_kernel<IS_MAX><<<grid_for(n), THREADS, 0, s>>>(
        vals, ids, n, out, n_segments);
  return cudaGetLastError();
}

}  // namespace

// out[s] = sum (is_max = 0) or max (1) of vals[i] over ids[i] == s, for
// every s in [0, n_segments); out needs no initialisation.  n_segments > 0.
extern "C" int segment_reduce(const int32_t* vals, const int32_t* ids,
                              int64_t n, int32_t* out, int64_t n_segments,
                              int is_max, void* stream) {
  if (n_segments <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_max ? launch<true>(vals, ids, n, out, n_segments, s)
                      : launch<false>(vals, ids, n, out, n_segments, s));
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
