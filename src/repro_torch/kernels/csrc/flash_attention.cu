// Online-softmax (flash) attention, causal and sliding-window, with GQA.
//
// Replaces the Pallas kernel of repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel).  The TPU version walks a grid of
// (B*H, q blocks, kv blocks) whose last axis runs in order on one core,
// carrying m, l and acc in VMEM scratch from step to step, with K and V
// repeated up to H heads.  Here one thread block owns one (b*h, 64-row q
// tile) and loops over the 64-row KV tiles itself; m, l and acc live in
// registers, and query head h reads KV head h / G in place (no repeat).
//
// What bounds it on the H100: operations.  Every unmasked score costs 4*d
// flops (QK^T and PV); in f32 that is the 67 TFLOP/s non-tensor rate, since
// TF32 tensor cores could not hold the reference's 2e-5.  This first
// version is simple: f32 arithmetic for f32 and bf16 inputs alike (bf16 is
// widened when a tile is loaded), tiles in dynamic shared memory (213,760
// bytes at d = 256), a 4x4 register tile of scores and a 4 x d/16 register
// tile of the output per thread.  KV tiles that the causal and window
// masks leave empty for every row of the q tile are skipped.
//
// Numerics follow the reference: masked scores are the finite -1e30 (not
// -inf), so a row whose first KV tiles are all masked builds exp(0)
// garbage that the first real key clears through corr = exp(-1e30 - m);
// a row with no real key at all (window > 0 and q >= Skv + window - 1)
// ends as the reference's uniform average, so for a q tile holding such a
// row no tile is skipped.  Keys past Skv do not exist in the reference;
// here they score -inf, p = 0.  The result is acc / max(l, 1e-30).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
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

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* o, int B, int H, int Hkv, int Sq, int Skv,
                     int causal, int window, float sm_scale, cudaStream_t s) {
#define FLASH_CASE(DIM)                                                    \
  case DIM:                                                                \
    return launch<T, DIM>(q, k, v, o, B, H, Hkv, Sq, Skv, causal, window, \
                          sm_scale, s);
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
// (is_bf16 = 0) or bf16 (1).  d one of 16, 32, 64, 96, 128, 192, 256.
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
