// Stabilized chunkwise mLSTM: the xLSTM matrix-memory recurrence.
//
// Replaces the Pallas kernel of repro/kernels/mlstm_chunk.py
// (mlstm_chunkwise / _mlstm_kernel).  The TPU version runs a grid of
// (B*H, chunks) whose chunk axis goes in order on one core, carrying the
// state C (dh x dh), n (dh) and the stabilizer m in VMEM scratch.  Here one
// thread block owns one (b, h) chain and walks its chunks in a loop, with
// C, n and m in shared memory for the whole sequence.
//
// What bounds it on the H100: operations, and the chains.  A chunk of K
// rows costs 2*K*K*dh (q k^T) + 2*K*K*dh (w v) + 2*K*dh*dh (q C) +
// 2*K*dh*dh (k^T v) flops in f32, and a chain's chunks depend on each
// other, so one block per chain runs at most at one SM's share of the
// 67 TFLOP/s non-tensor rate.  Shared memory sets the design: at dh = 192,
// C alone takes 147,456 of the 232,448 bytes a block may use, so the
// chunk's q, k and v never sit in shared memory whole.  They stream
// through in 32-row tiles (row stride dh + 1: no bank conflicts) from the
// card's L2, and a 32 x K tile of the decayed scores w = (q k^T * scale) * D
// is kept per 32 output rows.  216,720 bytes in all at dh = 192, K = 128.
//
// Per chunk, as the reference writes it: b = cumsum(lf) (one thread, in
// order), g = li - b, m_t = max(cummax(g) + b, m_prev + b),
// D[t][j] = exp(b_t + g_j - m_t) for j <= t, h = (w v + e^(m_prev + b - m_t)
// (q * scale) C) / max(|sum w + e^(...) (q * scale) n|, e^-m_t); then the
// state moves to the chunk end with m_next = max(m_prev + F, F + max g).
// The stabilizer starts at the finite -1e30, as in the reference.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RT = 32;        // rows per streamed tile
constexpr int KMAX = 128;     // largest chunk
constexpr int WP = KMAX + 1;  // score tile row stride
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
  return __float2bfloat16(v);
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(DH * DH + DH + 5 * KMAX + 4 +
                                  2 * RT * (DH + 1) + RT * WP);
}

// rows [r0, r0 + RT) of a (K, DH) chunk slice into a tile of stride DH + 1;
// rows at or past `rows` are zero; each row is multiplied by scale[row]
// when scale is given
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, const float* scale) {
  for (int i = threadIdx.x; i < RT * DH; i += THREADS) {
    const int r = i / DH, a = i % DH;
    float x = 0.f;
    if (r0 + r < rows) {
      x = to_f(src[(size_t)(r0 + r) * DH + a]);
      if (scale) x *= scale[r0 + r];
    }
    dst[r * (DH + 1) + a] = x;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ li,
             const float* __restrict__ lf, T* __restrict__ out, int S, int K,
             float scale) {
  constexpr int DP = DH + 1;
  constexpr int NC = DH / 16;        // columns per thread
  constexpr int IH = (NC + 1) / 2;   // state rows per thread and pass
  extern __shared__ float smem[];
  float* C = smem;                   // DH x DH
  float* n = C + DH * DH;            // DH
  float* bv = n + DH;                // cumsum of lf
  float* gv = bv + KMAX;             // li - b
  float* mt = gv + KMAX;             // stabilizer per row
  float* iw = mt + KMAX;             // inter-chunk weight per row
  float* ws = iw + KMAX;             // source weight per row
  float* sc = ws + KMAX;             // m_prev, m_next, w_prev
  float* Qs = sc + 4;                // RT x DP
  float* KVs = Qs + RT * DP;         // RT x DP
  float* W = KVs + RT * DP;          // RT x WP

  const int bh = blockIdx.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + (size_t)bh * S * DH;
  const T* kb = k + (size_t)bh * S * DH;
  const T* vb = v + (size_t)bh * S * DH;
  T* ob = out + (size_t)bh * S * DH;

  for (int i = tid; i < DH * DH; i += THREADS) C[i] = 0.f;
  for (int i = tid; i < DH; i += THREADS) n[i] = 0.f;
  if (tid == 0) sc[0] = NEG_INF;

  for (int cs = 0; cs < S; cs += K) {
    const T* qc = qb + (size_t)cs * DH;
    const T* kc = kb + (size_t)cs * DH;
    const T* vc = vb + (size_t)cs * DH;
    __syncthreads();  // state of the last chunk written
    if (tid == 0) {
      const float m_prev = sc[0];
      float cum = 0.f, cmax = -INFINITY;
      for (int j = 0; j < K; ++j) {
        cum += lf[(size_t)bh * S + cs + j];
        const float g = li[(size_t)bh * S + cs + j] - cum;
        cmax = fmaxf(cmax, g);
        bv[j] = cum;
        gv[j] = g;
        mt[j] = fmaxf(cmax + cum, m_prev + cum);
      }
      const float F = cum;
      const float m_next = fmaxf(m_prev + F, F + cmax);
      sc[1] = m_next;
      sc[2] = expf(m_prev + F - m_next);
    }
    __syncthreads();
    for (int j = tid; j < K; j += THREADS) {
      const float F = bv[K - 1];
      iw[j] = expf((sc[0] + bv[j]) - mt[j]);
      ws[j] = expf(F + gv[j] - sc[1]);
    }

    // ---- outputs, RT rows at a time, from the state at the chunk start
    for (int t0 = 0; t0 < K; t0 += RT) {
      const int kend = min(K, t0 + RT);   // keys j <= t < kend
      __syncthreads();
      load_tile<T, DH>(Qs, qc, t0, K, nullptr);
      for (int j0 = 0; j0 < kend; j0 += RT) {
        __syncthreads();
        load_tile<T, DH>(KVs, kc, j0, K, nullptr);
        __syncthreads();
        const int r = tid >> 3;
        const int t = t0 + r;
#pragma unroll
        for (int u = 0; u < RT / 8; ++u) {
          const int jj = (tid & 7) + 8 * u;
          const int j = j0 + jj;
          float w = 0.f;
          if (t < K && j <= t) {
            float dot = 0.f;
#pragma unroll 8
            for (int a = 0; a < DH; ++a)
              dot = fmaf(Qs[r * DP + a], KVs[jj * DP + a], dot);
            w = (dot * scale) * expf(bv[t] + gv[j] - mt[t]);
          }
          W[r * WP + j] = w;
        }
      }

      float acc[2][NC], qC[2][NC];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = qC[i][c] = 0.f;
      for (int j0 = 0; j0 < kend; j0 += RT) {
        __syncthreads();  // W complete; KVs free
        load_tile<T, DH>(KVs, vc, j0, K, nullptr);
        __syncthreads();
        const int nk = min(RT, kend - j0);
        for (int jj = 0; jj < nk; ++jj) {
          const float w0 = W[(ty * 2) * WP + j0 + jj];
          const float w1 = W[(ty * 2 + 1) * WP + j0 + jj];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float x = KVs[jj * DP + tx + 16 * c];
            acc[0][c] = fmaf(w0, x, acc[0][c]);
            acc[1][c] = fmaf(w1, x, acc[1][c]);
          }
        }
      }
      // (q * scale) C and (q * scale) n, from the chunk-start state
      float den[2], qn[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ty * 2 + i;
        den[i] = qn[i] = 0.f;
        for (int j = tx; j < kend; j += 16) den[i] += W[r * WP + j];
        for (int a = tx; a < DH; a += 16)
          qn[i] = fmaf(Qs[r * DP + a] * scale, n[a], qn[i]);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          den[i] += __shfl_xor_sync(0xffffffffu, den[i], off);
          qn[i] += __shfl_xor_sync(0xffffffffu, qn[i], off);
        }
      }
#pragma unroll 4
      for (int a = 0; a < DH; ++a) {
        const float q0 = Qs[(ty * 2) * DP + a] * scale;
        const float q1 = Qs[(ty * 2 + 1) * DP + a] * scale;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float x = C[a * DH + tx + 16 * c];
          qC[0][c] = fmaf(q0, x, qC[0][c]);
          qC[1][c] = fmaf(q1, x, qC[1][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = t0 + ty * 2 + i;
        if (t >= K) continue;
        const float d = fmaxf(fabsf(den[i] + iw[t] * qn[i]), expf(-mt[t]));
#pragma unroll
        for (int c = 0; c < NC; ++c)
          ob[(size_t)(cs + t) * DH + tx + 16 * c] =
              from_f<T>((acc[i][c] + iw[t] * qC[i][c]) / d);
      }
    }

    // ---- state to the chunk end: C = w_prev C + (k * w_src)^T v,
    //      n = w_prev n + sum_j k_j w_src_j, m = m_next
    const float w_prev = sc[2];
    for (int i0 = 0; i0 < NC; i0 += IH) {
      float up[IH][NC];
#pragma unroll
      for (int i = 0; i < IH; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) up[i][c] = 0.f;
      for (int j0 = 0; j0 < K; j0 += RT) {
        __syncthreads();
        load_tile<T, DH>(Qs, kc, j0, K, ws);
        load_tile<T, DH>(KVs, vc, j0, K, nullptr);
        __syncthreads();
        const int nk = min(RT, K - j0);
        for (int jj = 0; jj < nk; ++jj) {
          float ka[IH];
#pragma unroll
          for (int i = 0; i < IH; ++i)
            ka[i] = (i0 + i < NC) ? Qs[jj * DP + ty + 16 * (i0 + i)] : 0.f;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float x = KVs[jj * DP + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < IH; ++i) up[i][c] = fmaf(ka[i], x, up[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < IH; ++i) {
        if (i0 + i >= NC) continue;
        const int a = ty + 16 * (i0 + i);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float* p = &C[a * DH + tx + 16 * c];
          *p = w_prev * *p + up[i][c];
        }
      }
    }
    for (int a = tid; a < DH; a += THREADS) {
      float sum = 0.f;
      for (int j = 0; j < K; ++j)
        sum += to_f(kc[(size_t)j * DH + a]) * ws[j];
      n[a] = w_prev * n[a] + sum;
    }
    __syncthreads();
    if (tid == 0) sc[0] = sc[1];
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* li, const float* lf, void* out, int BH,
                   int S, int K, float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  mlstm_kernel<T, DH><<<BH, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), li, lf, static_cast<T*>(out), S, K, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v,
                     const float* li, const float* lf, void* out, int BH,
                     int S, int K, float scale, cudaStream_t s) {
#define MLSTM_CASE(DIM) \
  case DIM:             \
    return launch<T, DIM>(q, k, v, li, lf, out, BH, S, K, scale, s);
  switch (dh) {
    MLSTM_CASE(16)
    MLSTM_CASE(32)
    MLSTM_CASE(64)
    MLSTM_CASE(96)
    MLSTM_CASE(128)
    MLSTM_CASE(192)
  }
#undef MLSTM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out: (BH, S, dh) contiguous, f32 (is_bf16 = 0) or bf16 (1);
// li, lf: (BH, S) f32 log gates.  S a multiple of the chunk K <= 128;
// dh one of 16, 32, 64, 96, 128, 192.
extern "C" int mlstm_chunkwise(const void* q, const void* k, const void* v,
                               const float* li, const float* lf, void* out,
                               int BH, int S, int dh, int K, float scale,
                               int is_bf16, void* stream) {
  if (BH == 0 || S == 0) return 0;
  if (K < 1 || K > KMAX || S % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(dh, q, k, v, li, lf, out, BH, S, K,
                                        scale, s);
  return (int)dispatch<float>(dh, q, k, v, li, lf, out, BH, S, K, scale, s);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
