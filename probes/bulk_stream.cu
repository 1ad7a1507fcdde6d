// Design probe for the bulk CiM kernel (repro_torch/kernels/csrc/
// cim_bitwise.cu): one elementwise x & y over n4 16-byte vectors, written
// in several ways, so that probes/bulk_stream.py can time them in turns
// with torch.bitwise_and on the card and the kernel can take the fastest
// shape.  No path of repro_torch runs this file.
//
// Variants (template arguments in the names):
//   tile<T,U,H>      one block per tile of T*U vectors, thread t loading
//                    vectors k*T + t (k < U) of its tile; a grid as large
//                    as the array (the shape of PyTorch's own kernel)
//   tileloop<T,U,H>  the same tiles, strided over a one-wave grid
//   stride<T,U,H>    a one-wave grid, each thread loading U vectors one
//                    grid-width apart per step
//   capped           grid-stride, one vector a step, over at most 32
//                    blocks of 256 threads per SM
//   tma<S,V>         a persistent grid; each block keeps an S-stage ring
//                    of V-vector tiles of x and y in shared memory, filled
//                    by cp.async.bulk (TMA) and completed on mbarriers,
//                    and writes x & y from the ring with streaming stores
// H, the cache hint of the loads (stores plain unless said): 0 none,
// 1 __ldcs (and __stcs on the stores), 2 ld.global.nc.L1::no_allocate.
// L2::256B, 3 ld.global.L2::256B, 4 ld.global.nc (__ldg), 5 ld.global.
// L1::no_allocate, 6 an L2 evict_first policy (createpolicy).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int H>
__device__ __forceinline__ uint4 ld(const uint4* p) {
  if (H == 1) return __ldcs(p);
  uint4 v;
  if (H == 2)
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  else if (H == 3)
    asm("ld.global.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  else if (H == 4)
    v = __ldg(p);
  else if (H == 5)
    asm("ld.global.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  else if (H == 6) {
    uint64_t policy;
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
        : "=l"(policy));
    asm("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p), "l"(policy));
  } else
    v = *p;
  return v;
}

template <int H>
__device__ __forceinline__ void st(uint4* p, uint4 v) {
  if (H == 1)
    __stcs(p, v);
  else
    *p = v;
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

template <int T, int U, int H>
__device__ __forceinline__ void do_tile(const uint4* x, const uint4* y,
                                        uint4* o, int64_t n4,
                                        int64_t tile) {
  const int64_t base = tile * (T * U) + threadIdx.x;
  if (base + (U - 1) * T < n4) {
    uint4 a[U], b[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      a[k] = ld<H>(x + base + k * T);
      b[k] = ld<H>(y + base + k * T);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) st<H>(o + base + k * T, and4(a[k], b[k]));
  } else {
    for (int k = 0; k < U; ++k)
      if (base + k * T < n4)
        st<H>(o + base + k * T,
              and4(ld<H>(x + base + k * T), ld<H>(y + base + k * T)));
  }
}

template <int T, int U, int H>
__global__ void __launch_bounds__(T)
tile_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
            uint4* __restrict__ o, int64_t n4) {
  do_tile<T, U, H>(x, y, o, n4, blockIdx.x);
}

template <int T, int U, int H>
__global__ void __launch_bounds__(T)
tileloop_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
                uint4* __restrict__ o, int64_t n4) {
  const int64_t tiles = (n4 + T * U - 1) / (T * U);
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x)
    do_tile<T, U, H>(x, y, o, n4, t);
}

template <int T, int U, int H>
__global__ void __launch_bounds__(T)
stride_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
              uint4* __restrict__ o, int64_t n4) {
  const int64_t stride = (int64_t)gridDim.x * T;
  int64_t i = (int64_t)blockIdx.x * T + threadIdx.x;
  for (; i + (U - 1) * stride < n4; i += U * stride) {
    uint4 a[U], b[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      a[k] = ld<H>(x + i + k * stride);
      b[k] = ld<H>(y + i + k * stride);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) st<H>(o + i + k * stride, and4(a[k], b[k]));
  }
  for (; i < n4; i += stride) st<H>(o + i, and4(ld<H>(x + i), ld<H>(y + i)));
}

// ---------------------------------------------------------------- TMA ring
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int S, int V>
__device__ __forceinline__ void issue(const uint4* x, const uint4* y,
                                      uint4* ring, uint64_t* full,
                                      int64_t n4, int64_t tile, int s) {
  const int64_t base = tile * V;
  const uint32_t bytes = (uint32_t)(min((int64_t)V, n4 - base) * 16);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(full + s)), "r"(2 * bytes) : "memory");
  bulk_load(ring + (2 * s) * V, x + base, bytes, full + s);
  bulk_load(ring + (2 * s + 1) * V, y + base, bytes, full + s);
}

template <int S, int V>
__global__ void __launch_bounds__(256)
tma_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
           uint4* __restrict__ o, int64_t n4) {
  extern __shared__ __align__(128) uint4 ring[];   // S x {x, y} x V
  __shared__ __align__(8) uint64_t full[S];
  const int64_t tiles = (n4 + V - 1) / V;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < S; ++s) {
      const int64_t t = blockIdx.x + (int64_t)s * gridDim.x;
      if (t < tiles) issue<S, V>(x, y, ring, full, n4, t, s);
    }
  int it = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int s = it % S;
    const uint32_t parity = (it / S) & 1;
    uint32_t done = 0;
    do {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
          "[%1], %2; selp.u32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(smem_addr(full + s)), "r"(parity) : "memory");
    } while (!done);
    const int64_t base = t * V;
    const int n = (int)min((int64_t)V, n4 - base);
    const uint4* xs = ring + (2 * s) * V;
    const uint4* ys = xs + V;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      __stcs(o + base + i, and4(xs[i], ys[i]));
    __syncthreads();                       // the stage is free again
    if (threadIdx.x == 0) {
      const int64_t next = t + (int64_t)S * gridDim.x;
      if (next < tiles) issue<S, V>(x, y, ring, full, n4, next, s);
    }
  }
}

// ------------------------------------------------------------- variants
typedef cudaError_t (*Runner)(const uint4*, const uint4*, uint4*, int64_t,
                              cudaStream_t);

template <typename K>
int64_t one_wave(K kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return (int64_t)sms * per_sm;
}

int64_t clamp_grid(int64_t want, int64_t cap) {
  return want < 1 ? 1 : (want > cap ? cap : want);
}

template <int T, int U, int H>
cudaError_t run_tile(const uint4* x, const uint4* y, uint4* o, int64_t n4,
                     cudaStream_t s) {
  const int64_t grid = clamp_grid((n4 + T * U - 1) / (T * U), 1LL << 31);
  tile_kernel<T, U, H><<<(unsigned)grid, T, 0, s>>>(x, y, o, n4);
  return cudaGetLastError();
}

template <int T, int U, int H>
cudaError_t run_tileloop(const uint4* x, const uint4* y, uint4* o,
                         int64_t n4, cudaStream_t s) {
  const int64_t grid = clamp_grid((n4 + T * U - 1) / (T * U),
                                  one_wave(tileloop_kernel<T, U, H>, T, 0));
  tileloop_kernel<T, U, H><<<(unsigned)grid, T, 0, s>>>(x, y, o, n4);
  return cudaGetLastError();
}

template <int T, int U, int H>
cudaError_t run_stride(const uint4* x, const uint4* y, uint4* o, int64_t n4,
                       cudaStream_t s) {
  const int64_t grid = clamp_grid((n4 + T - 1) / T,
                                  one_wave(stride_kernel<T, U, H>, T, 0));
  stride_kernel<T, U, H><<<(unsigned)grid, T, 0, s>>>(x, y, o, n4);
  return cudaGetLastError();
}

cudaError_t run_capped(const uint4* x, const uint4* y, uint4* o, int64_t n4,
                       cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t grid = clamp_grid((n4 + 255) / 256, (int64_t)sms * 32);
  stride_kernel<256, 1, 0><<<(unsigned)grid, 256, 0, s>>>(x, y, o, n4);
  return cudaGetLastError();
}

template <int S, int V>
cudaError_t run_tma(const uint4* x, const uint4* y, uint4* o, int64_t n4,
                    cudaStream_t s) {
  const int smem = S * 2 * V * 16;
  cudaError_t err = cudaFuncSetAttribute(
      tma_kernel<S, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t grid = clamp_grid((n4 + V - 1) / V,
                                  one_wave(tma_kernel<S, V>, 256, smem));
  tma_kernel<S, V><<<(unsigned)grid, 256, smem, s>>>(x, y, o, n4);
  return cudaGetLastError();
}

struct Variant {
  const char* name;
  Runner run;
};

#define TILE(T, U, H) {"tile<" #T "," #U "," #H ">", run_tile<T, U, H>}
#define TILES(T, H) TILE(T, 1, H), TILE(T, 2, H), TILE(T, 4, H), TILE(T, 8, H)
#define LOOP(T, U, H) \
  {"tileloop<" #T "," #U "," #H ">", run_tileloop<T, U, H>}
#define STRIDE(T, U, H) {"stride<" #T "," #U "," #H ">", run_stride<T, U, H>}
#define TMA(S, V) {"tma<" #S "," #V ">", run_tma<S, V>}

const Variant VARIANTS[] = {
    {"capped", run_capped},
    TILES(128, 0), TILES(128, 1), TILES(128, 2),
    TILES(256, 0), TILES(256, 1), TILES(256, 2),
    TILES(512, 0), TILES(512, 1), TILES(512, 2),
    TILE(1024, 1, 0), TILE(1024, 2, 0),
    TILE(256, 2, 3), TILE(512, 1, 3), TILE(512, 2, 3),
    TILE(256, 2, 4), TILE(512, 1, 4), TILE(512, 2, 4),
    TILE(256, 2, 5), TILE(512, 1, 5), TILE(512, 2, 5),
    TILE(256, 2, 6), TILE(512, 1, 6), TILE(512, 2, 6),
    LOOP(256, 2, 0), LOOP(256, 4, 0), LOOP(256, 8, 0),
    LOOP(256, 2, 1), LOOP(256, 4, 1), LOOP(256, 8, 1),
    STRIDE(256, 1, 0), STRIDE(256, 2, 0), STRIDE(256, 4, 0),
    STRIDE(256, 1, 1), STRIDE(256, 2, 1), STRIDE(256, 4, 1),
    TMA(2, 512), TMA(4, 512), TMA(2, 1024), TMA(4, 1024), TMA(6, 1024),
};

}  // namespace

extern "C" int bulk_count() {
  return (int)(sizeof(VARIANTS) / sizeof(VARIANTS[0]));
}

extern "C" const char* bulk_name(int i) { return VARIANTS[i].name; }

// out = x & y over n4 16-byte vectors (16-byte aligned pointers)
extern "C" int bulk_run(int i, const void* x, const void* y, void* out,
                        int64_t n4, void* stream) {
  if (i < 0 || i >= bulk_count() || n4 <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)VARIANTS[i].run(static_cast<const uint4*>(x),
                              static_cast<const uint4*>(y),
                              static_cast<uint4*>(out), n4,
                              static_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
