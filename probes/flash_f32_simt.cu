// The f32 attention kernel on the CUDA cores, as the port ran it before
// its products moved onto the tensor cores (flash_attention.cu's former
// flash_kernel<float, D>), kept for probes/flash_f32_variants.py to time
// beside the kernel that replaced it.  Scalar FMAs over tiles in
// dynamic shared memory (213,760 bytes at d = 256), one block of 256
// threads per (b*h, 64-row q tile), a 4x4 register tile of scores and a
// 4 x d/16 register tile of the output per thread.
//
// Three switches, each 0 unless defined before this file is compiled, take
// one part out so that a timing shows what it costs; the results are then
// wrong, and only the full build (all 0) is checked:
//   SKIP_QK    -- no Q.K^T products (and none of their shared-memory reads)
//   SKIP_PV    -- no P.V products
//   SKIP_LOADS -- K and V come from device memory for the first tile only
// Same C entry as csrc/flash_attention.cu (f32 only: is_bf16 must be 0).
#include <cstdint>
#include <cuda_runtime.h>

#ifndef SKIP_QK
#define SKIP_QK 0
#endif
#ifndef SKIP_PV
#define SKIP_PV 0
#endif
#ifndef SKIP_LOADS
#define SKIP_LOADS 0
#endif

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int H,
             int Hkv, int Sq, int Skv, int causal, int window,
             float sm_scale) {
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
  const float* qp = q + ((size_t)bh * Sq + q0) * D;
  const float* kp = k + (size_t)(b * Hkv + hk) * Skv * D;
  const float* vp = v + (size_t)(b * Hkv + hk) * Skv * D;
  float* op = o + ((size_t)bh * Sq + q0) * D;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * DP + c] = r < nrow ? qp[(size_t)r * D + c] : 0.f;
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
    if (!SKIP_LOADS || kt == lo) {
      for (int i = tid; i < BK * D; i += THREADS) {
        const int r = i / D, c = i % D;
        const bool ok = k0 + r < Skv;
        const size_t g = (size_t)(k0 + r) * D + c;
        Ks[r * DP + c] = ok ? kp[g] : 0.f;
        Vs[r * D + c] = ok ? vp[g] : 0.f;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    if (!SKIP_QK) {
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

    if (!SKIP_PV) {
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
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nrow) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      op[(size_t)r * D + tx + 16 * c] = acc[i][c] / den;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Skv, int causal,
                   int window, float sm_scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<D><<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, Sq, Skv,
      causal, window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Hkv, int Sq,
                               int Skv, int d, int causal, int window,
                               float sm_scale, int is_bf16, void* stream) {
  if (B * H == 0 || Sq == 0) return 0;
  if (is_bf16 || Skv == 0 || Hkv == 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return (int)launch<64>(q, k, v, o, B, H, Hkv, Sq, Skv, causal, window,
                             sm_scale, s);
    case 256:
      return (int)launch<256>(q, k, v, o, B, H, Hkv, Sq, Skv, causal,
                              window, sm_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
