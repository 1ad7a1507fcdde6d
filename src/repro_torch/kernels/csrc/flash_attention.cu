// Online-softmax (flash) attention, causal and sliding-window, with GQA.
//
// Replaces the Pallas kernel of repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel at line 71, pallas_call at line 94). The
// TPU version walks a grid of (B*H, q blocks, kv blocks) whose last axis
// runs in order on one core, carrying m, l and acc in VMEM scratch from step
// to step, with K and V repeated up to H heads.  Here one thread block owns
// one (b*h, 64-row q tile) and loops over the 64-row KV tiles itself; m, l
// and acc live in registers, query head h reads KV head h / G in place (no
// repeat), and KV tiles that the causal and window masks leave empty for
// every row of the q tile are skipped.  Two kernels, one per input type:
//
// f32 (flash_kernel): bound by operations, 4*d flops per unmasked score at
// the 67 TFLOP/s outside the tensor cores, since TF32 could not hold the
// reference's 2e-5.  Scalar FMAs over tiles in dynamic shared memory
// (213,760 bytes at d = 256), a 4x4 register tile of scores and a 4 x d/16
// register tile of the output per thread.
//
// bf16 (flash_wgmma_kernel): bound by operations too, at the 989 TFLOP/s of
// the bf16 tensor cores, which only Hopper's warpgroup products (wgmma)
// approach: one block is one warpgroup (4 warps, 16 q rows each). Q.K^T is
// wgmma m64n64k16 with Q and K read from shared memory; each product is
// exact in f32, so only the order of the sum differs from the reference. The
// scores stay in the accumulator registers for the online softmax (m, l and
// the correction in f32) and become P.V's A operand in place; V is read from
// shared memory (wgmma m64n{d}k16, B transposed). P rounded once to bf16
// would be the one rounding the reference does not make, and it can miss the
// card's check (atol 2e-3, rtol 1e-2 against the f32 oracle) at gemma3-1b's
// width (tests/test_torch_kernels_ops.py emulates it), so P is split into
// hi = bf16(p) and lo = bf16(p - hi) and P.V runs twice on the same V: 1.5
// times the products.  The output is acc / max(l, 1e-30), rounded once to
// bf16.  Q, K and V tiles sit in wgmma's 128-byte swizzled layout (without
// the swizzle the tensor cores' shared-memory reads conflict), 96 KB at
// d = 256, so two blocks share an SM: while one waits on its products or its
// loads the other runs.  cp.async brings V(j) in while Q.K^T(j) runs and
// K(j+1) while P.V(j) runs; a two-stage ring of both K and V would take
// 160 KB at d = 256 and leave one block an SM.  Blocks pair the longest
// causal q tiles with the shortest on each SM (flash_wgmma_kernel's first
// lines).
//
// Numerics of both follow the reference: masked scores are the finite -1e30
// (not -inf), so a row whose first KV tiles are all masked builds exp(0)
// garbage that the first real key clears through corr = exp(-1e30 - m); a
// row with no real key at all (window > 0 and q >= Skv + window - 1) ends as
// the reference's uniform average, so for a q tile holding such a row no
// tile is skipped.  Keys past Skv do not exist in the reference; here they
// score -inf, p = 0, and their K and V rows are zeros.  The result is
// acc / max(l, 1e-30).
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
             int Sq, int Skv, int causal, int window, float sm_scale) {
  constexpr int DP = D + 1;    // padded row stride: no bank conflicts
  constexpr int PP = BK + 1;
  constexpr int NC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x DP
  float* Ks = Qs + BQ * DP;    // BK x DP
  float* Vs = Ks + BK * DP;    // BK x D
  float* Ps = Vs + BK * D;     // BQ x PP

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int nrow = min(BQ, Sq - q0);
  const T* qp = q + ((size_t)bh * Sq + q0) * D;
  const T* kp = k + (size_t)(b * Hkv + hk) * Skv * D;
  const T* vp = v + (size_t)(b * Hkv + hk) * Skv * D;
  T* op = o + ((size_t)bh * Sq + q0) * D;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * DP + c] = r < nrow ? to_f(qp[(size_t)r * D + c]) : 0.f;
  }

  // the KV tiles holding any unmasked key of this q tile
  const int q_last = q0 + nrow - 1;
  const int nkt = (Skv + BK - 1) / BK;
  int lo = 0, hi = nkt;
  if (!(window > 0 && q_last >= Skv + window - 1)) {
    if (causal) hi = min(nkt, q_last / BK + 1);
    if (window > 0) lo = max(0, q0 - window + 1) / BK;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q loaded; last tile's Ks, Vs, Ps no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < Skv;
      const size_t g = (size_t)(k0 + r) * D + c;
      Ks[r * DP + c] = ok ? to_f(kp[g]) : 0.f;
      Vs[r * D + c] = ok ? to_f(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool keep = true;
        if (causal) keep = qpos >= kpos;
        if (window > 0) keep = keep && (qpos - kpos < window);
        float val = keep ? s[i][j] * sm_scale : NEG_INF;
        if (kpos >= Skv) val = -INFINITY;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // Ps complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nrow) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      op[(size_t)r * D + tx + 16 * c] = from_f<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Skv, int causal,
                   int window, float sm_scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<T, D><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Skv, causal,
      window, sm_scale);
  return cudaGetLastError();
}

// ------------------------------------------- bf16 on the tensor cores
constexpr int WG_THREADS = 128;                // one warpgroup: 4 warps
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t SLICE = BK * 128;           // a 64-row, 64-column slice
static_assert(BQ == BK, "Q and K/V tiles share one slice size");

// 64-column slices of a tile (the last one partly filled for d = 16, 32,
// 96) and the dynamic shared memory of Q, K and V, plus 1 KB of alignment
template <int D>
__host__ __device__ constexpr int slices() { return (D + 63) / 64; }
template <int D>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  return 1024 + 3 * (size_t)slices<D>() * SLICE;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// two floats rounded to nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async's writes made visible to the async proxy that wgmma reads by
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (K-major: lbo unused, sbo the
// 1 KB between 8-row groups; N-major: lbo between 64-column slices, sbo
// between 8-row groups), layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)1 << 62;
}

// d (64 x 64 f32) += A (64 x 16, shared) B (16 x 64, shared), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %34, 0; "
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 0; }\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
       "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
       "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
       "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
       "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
       "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x N f32) += A (64 x 16 bf16, registers) B (16 x N, shared,
// N-major: imm-trans-b = 1)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %13, 0; "
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1; }\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
       "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %21, 0; "
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, "
      "%17, %18, %19}, %20, p, 1, 1, 1; }\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
       "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
       "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
       "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %37, 0; "
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1; }\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
       "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
       "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
       "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
       "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
       "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %53, 0; "
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1; }\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
       "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
       "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
       "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
       "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
       "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
       "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
       "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
       "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %69, 0; "
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1; }\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
       "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
       "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
       "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
       "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
       "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
       "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
       "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
       "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
       "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
       "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
       "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %101, 0; "
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, "
      "%83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1; }\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
       "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
       "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
       "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
       "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
       "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
       "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
       "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
       "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
       "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
       "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
       "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
       "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
       "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
       "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
       "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
       "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
       "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
       "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %133, 0; "
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, "
      "%83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, "
      "%130, %131}, %132, p, 1, 1, 1; }\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
       "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
       "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
       "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
       "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
       "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
       "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
       "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
       "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
       "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
       "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
       "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
       "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
       "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
       "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
       "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
       "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
       "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
       "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
       "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
       "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
       "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
       "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
       "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
       "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// a (64 x D) bf16 tile at g, rows from `valid` on zeros, into shared
// memory at dst in wgmma's 128-byte swizzled layout: slices<D>() slices
// of 64 columns, each 64 rows of 128 bytes, the 16-byte chunk j of row r
// at chunk j ^ (r % 8).  The same bytes serve as a K-major operand (Q, K;
// 8-row groups 1 KB apart) and as an N-major one (V, keys as rows).
// Consecutive threads fill consecutive 16-byte chunks of a row.
template <int D>
__device__ __forceinline__ void load_tile_sw(uint32_t dst,
                                             const __nv_bfloat16* g,
                                             int valid, int tid) {
  constexpr int CH = D / 8;                   // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < BK * CH / WG_THREADS; ++it) {
    const int i = tid + it * WG_THREADS;
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid;
    cp_async16(dst + (c / 8) * SLICE + r * 128 + ((c % 8) ^ (r % 8)) * 16,
               ok ? g + (size_t)r * D + c * 8 : g, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 2)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int H, int Hkv, int Sq,
                   int Skv, int causal, int window, float sm_scale,
                   int wave) {
  constexpr int NT = D / 8;                   // 8-column tiles of the output
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const uint32_t Qs = (smem_u32(smem_wg) + 1023) & ~1023u;  // 1 KB-aligned
  const uint32_t Ks = Qs + slices<D>() * SLICE;             // BQ x D
  const uint32_t Vs = Ks + slices<D>() * SLICE;             // BK x D

  // block -> (b*h, q tile).  Items ranked by causal length, longest
  // first (rank r: q tile nqt - 1 - r / BH of head r % BH).  The first
  // `wave` blocks (one an SM) take the longest items and the next `wave`
  // the shortest, so the two blocks that share an SM carry about equal
  // work; blocks after those take the rest, longest first.
  const int nqt = (Sq + BQ - 1) / BQ;
  const int n_items = gridDim.x, BH = n_items / nqt, L = blockIdx.x;
  const int r = L < wave ? L
                : L < 2 * wave ? n_items - 1 - (L - wave) : L - wave;
  const int bh = r % BH, qt = nqt - 1 - r / BH;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int nrow = min(BQ, Sq - q0);
  const __nv_bfloat16* qp = q + ((size_t)bh * Sq + q0) * D;
  const __nv_bfloat16* kp = k + (size_t)(b * Hkv + hk) * Skv * D;
  const __nv_bfloat16* vp = v + (size_t)(b * Hkv + hk) * Skv * D;
  __nv_bfloat16* op = o + ((size_t)bh * Sq + q0) * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;      // fragment row, column pair

  // the KV tiles holding any unmasked key of this q tile (as flash_kernel)
  const int q_last = q0 + nrow - 1;
  const int nkt = (Skv + BK - 1) / BK;
  int lo = 0, hi = nkt;
  if (!(window > 0 && q_last >= Skv + window - 1)) {
    if (causal) hi = min(nkt, q_last / BK + 1);
    if (window > 0) lo = max(0, q0 - window + 1) / BK;
  }

  load_tile_sw<D>(Qs, qp, nrow, tid);
  if (lo < hi)
    load_tile_sw<D>(Ks, kp + (size_t)lo * BK * D, Skv - lo * BK, tid);
  cp_async_commit();

  // the wgmma accumulator: this thread's part of rows g and g + 8 of its
  // warp's 16, output columns 8n + 2t, +1 in acc[n][0..1] and acc[n][2..3]
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float (&acc_flat)[D / 2] = *reinterpret_cast<float(*)[D / 2]>(&acc[0][0]);

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();                 // K(kt) and Q landed; P.V(kt-1) done
    load_tile_sw<D>(Vs, vp + (size_t)k0 * D, Skv - k0, tid);
    cp_async_commit();

    // scores, the wgmma accumulator: keys 8j + 2t, +1 in s[j][0..1]
    // (row g), s[j][2..3] (row g + 8)
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    float (&s_flat)[BK / 2] = *reinterpret_cast<float(*)[BK / 2]>(&s[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // 16 columns: 32 bytes a row
      const uint32_t off = kk / 4 * SLICE + kk % 4 * 32;
      wgmma_ss_n64(s_flat, smem_desc(Qs + off, 16, 1024),
                   smem_desc(Ks + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_flat);

    const bool masked = (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && q_last - k0 >= window) ||
                        k0 + BK > Skv;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[j][e] * sm_scale;
        if (masked) {
          const int qpos = q0 + warp * 16 + g + (e >> 1) * 8;
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          bool keep = true;
          if (causal) keep = qpos >= kpos;
          if (window > 0) keep = keep && (qpos - kpos < window);
          val = keep ? val : NEG_INF;
          if (kpos >= Skv) val = -INFINITY;
        }
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {     // a row lives in the 4 lanes of a quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f((m[i] - m_new) * LOG2E);
      m[i] = m_new;
      l[i] *= corr[i];               // this lane's share; summed at the end
    }
    // P = hi + lo in two bf16 A operands of P.V, in registers (keys
    // 16c .. 16c + 15 in [c], the layout of the scores): hi = bf16(p),
    // lo = bf16(p - hi), exact to about 2^-16 of p
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = exp2f((s[j][e] - m[e >> 1]) * LOG2E);
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
#pragma unroll
      for (int r = 0; r < 2; ++r) {   // rows g, g + 8
        const int i = (j & 1) * 2 + r;
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(p[2 * r], p[2 * r + 1]);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[j / 2][i] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[j / 2][i] = pack_bf16(p[2 * r] - hf.x, p[2 * r + 1] - hf.y);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();                 // V(kt) landed; Q.K^T(kt) done by all
    if (kt + 1 < hi)
      load_tile_sw<D>(Ks, kp + (size_t)(k0 + BK) * D, Skv - k0 - BK, tid);
    cp_async_commit();
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {   // V N-major: 16 keys, 2 KB
      const uint64_t vd = smem_desc(Vs + c * 2048, SLICE, 1024);
      wgmma_rs<D>(acc_flat, p_lo[c], vd);
      wgmma_rs<D>(acc_flat, p_hi[c], vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_flat);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = warp * 16 + g + 8 * i;
    if (r >= nrow) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(op + (size_t)r * D + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int Hkv, int Sq, int Skv,
                         int causal, int window, float sm_scale,
                         cudaStream_t s) {
  constexpr size_t smem = wg_smem_bytes<D>();
  const int64_t n_items = (int64_t)B * H * ((Sq + BQ - 1) / BQ);
  if (n_items > INT32_MAX) return cudaErrorInvalidValue;
  int dev = 0, wave = 0;                       // wave: one block an SM
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&wave, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)                      // room for two blocks an SM
    err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  flash_wgmma_kernel<D><<<(unsigned)n_items, WG_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, Hkv, Sq, Skv, causal, window, sm_scale, wave);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* o, int B, int H, int Hkv, int Sq, int Skv,
                     int causal, int window, float sm_scale, cudaStream_t s) {
#define FLASH_CASE(DIM)                                                    \
  case DIM:                                                                \
    if constexpr (std::is_same<T, __nv_bfloat16>::value)                   \
      return launch_wgmma<DIM>(q, k, v, o, B, H, Hkv, Sq, Skv, causal,     \
                               window, sm_scale, s);                       \
    else                                                                   \
      return launch<T, DIM>(q, k, v, o, B, H, Hkv, Sq, Skv, causal,        \
                            window, sm_scale, s);
  switch (d) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(96)
    FLASH_CASE(128)
    FLASH_CASE(192)
    FLASH_CASE(256)
  }
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (B, H, Sq, d), k and v: (B, Hkv, Skv, d), o like q; contiguous, f32
// (is_bf16 = 0) or bf16 (1; 16-byte aligned).  d one of 16, 32, 64, 96,
// 128, 192, 256.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Hkv, int Sq,
                               int Skv, int d, int causal, int window,
                               float sm_scale, int is_bf16, void* stream) {
  if (B * H == 0 || Sq == 0) return 0;
  if (Skv == 0 || Hkv == 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(d, q, k, v, o, B, H, Hkv, Sq, Skv,
                                        causal, window, sm_scale, s);
  return (int)dispatch<float>(d, q, k, v, o, B, H, Hkv, Sq, Skv, causal,
                              window, sm_scale, s);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
