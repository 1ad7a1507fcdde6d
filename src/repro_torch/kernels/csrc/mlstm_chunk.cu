// Stabilized chunkwise mLSTM: the xLSTM matrix-memory recurrence.
//
// Replaces the Pallas kernel of repro/kernels/mlstm_chunk.py
// (mlstm_chunkwise / _mlstm_kernel).  The TPU version runs a grid of
// (B*H, chunks) whose chunk axis goes in order on one core, carrying the
// state C (dh x dh), n (dh) and the stabilizer m in VMEM scratch.  Blocks
// on the H100 run in no order, and one block per chain (B*H = 32 at
// xlstm-125m) leaves 100 of its 132 SMs idle, so the work is split by what
// the recurrence lets run in parallel.  Only the state is sequential across
// chunks, and its update is an axpy once each chunk's own contribution is
// known:
//
//   0. gates (one block per chain): per chunk, b = cumsum(lf) in order
//      (one thread a chunk), g = li - b, F = b[K-1], max g; then the
//      scalar stabilizer chain m_next = max(m_prev + F, F + max g) in
//      order, in the reference's float operations; per token m_t =
//      max(cummax(g) + b, m_prev + b) and the inter-chunk weight
//      e^(m_prev + b - m_t); per chunk w_prev = e^(m_prev + F - m_next) and
//      the update's scale e^(F + max g - m_next).
//   1. chunk updates (per chain, chunk and 64 rows of the state, in
//      parallel): dC = sum_j e^(g_j - max g) k_j v_j^T and dn likewise, a
//      (dh x K) x (K x dh) product.
//   2. state scan (per chain and slice of the dh^2 + dh state elements):
//      C_k = w_prev C_{k-1} + e^(F + max g - m_k) dC_k over the chunks in
//      order, storing each chunk's start state in place of its dC.
//   3. outputs (per chain, chunk and 64 rows, in parallel), from the
//      chunk's start state, as the reference writes them: the decayed
//      scores w = (q k^T * scale) * e^(b_t + g_j - m_t) for j <= t, then
//      h = (w v + e^(...) (q * scale) C) / max(|sum w + e^(...) (q * scale)
//      n|, e^-m_t), one (64 x (K + dh)) x ((K + dh) x dh) product.
//
// What bounds it on the H100: operations, 4 K^2 dh / 2 + 4 K dh^2 flops a
// chunk, in f32.  The products of phases 1 and 3 run on the tensor cores
// as 3xTF32 (each f32 operand split into two TF32 terms, three mma.sync
// m16n8k8 a product, f32 sums: f32 accuracy at a third of the TF32
// rate, 2.5 times the f32 rate outside the tensor cores), a warp a
// 32 x 48 tile of 16 x 8 fragments, over 32-deep slices kept in shared
// memory in their natural layout with padded rows (no bank conflicts).  At
// xlstm-125m (B*H = 32, 16 chunks, dh = 192) phases 1 and 3 run 1,536 and
// 1,024 blocks; the start states take 32 x 16 x (192^2 + 192) x 4 bytes
// (75 MB) of scratch.  The stabilizer starts at the finite -1e30, as in
// the reference.  bf16 inputs are computed in f32 and the output rounded
// once.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int KMAX = 128;  // largest chunk
constexpr int SL = 32;     // depth of a product's shared-memory slice
constexpr int RT = 64;     // output rows of a phase-3 block
constexpr int THREADS = 256;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---- 3xTF32 products on the tensor cores (mma.sync m16n8k8): each f32
// operand x is split into x_hi = tf32(x) and x_lo = tf32(x - x_hi), and
// A B = A_lo B_hi + A_hi B_lo + A_hi B_hi in f32 accumulators (the
// dropped A_lo B_lo is below f32 rounding).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mt][nt] += A[m0 + 16 mt .., k] B[k, n0 + 8 nt ..] over k < kn (a
// multiple of 8), one warp.  A is stored [m][k] (A_MK) or [k][m], B [k][n]
// (B_KN) or [n][k], in shared memory with row strides lda / ldb; strides
// of 4 or 8 mod 32 floats keep the fragment loads free of bank conflicts.
// acc[..][0..3] holds (row g, col 2c), (g, 2c + 1), (g + 8, 2c), (g + 8,
// 2c + 1) of its 16 x 8 tile, g = lane / 4, c = lane % 4.
template <int MT, int NT, bool A_MK, bool B_KN>
__device__ __forceinline__ void warp_mma(const float* A, int lda,
                                         const float* B, int ldb, int kn,
                                         int m0, int n0,
                                         float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  auto at = [&](int m, int k) {
    return A_MK ? A[m * lda + k] : A[k * lda + m];
  };
  auto bt = [&](int k, int n) {
    return B_KN ? B[k * ldb + n] : B[n * ldb + k];
  };
  for (int k = 0; k < kn; k += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = m0 + 16 * mt + g;
      split_tf32(at(m, k + c), ah[mt][0], al[mt][0]);
      split_tf32(at(m + 8, k + c), ah[mt][1], al[mt][1]);
      split_tf32(at(m, k + c + 4), ah[mt][2], al[mt][2]);
      split_tf32(at(m + 8, k + c + 4), ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + 8 * nt + g;
      split_tf32(bt(k + c, n), bh[nt][0], bl[nt][0]);
      split_tf32(bt(k + c + 4, n), bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(acc[mt][nt], al[mt], bh[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
      }
  }
}

// The warps of a block over a 64 x DH product: NWN warps across the
// columns, NWM down the rows; each warp MT x NT tiles of 16 x 8.
template <int DH>
struct OutTiling {
  static constexpr int NWN = DH / 8 < 4 ? DH / 8 : 4;
  static constexpr int NWM = 8 / NWN;
  static constexpr int MT = 64 / 16 / NWM;
  static constexpr int NT = DH / 8 / NWN;
};

// ----------------------------------------------------------------- gates
// tok: (BH, 4, S) -- b, g, m_t, inter-chunk weight; chk: (BH, nc, 4) --
// m at the chunk start, max g, w_prev, the update's scale.
__global__ void __launch_bounds__(THREADS)
    mlstm_gates_kernel(const float* __restrict__ li,
                       const float* __restrict__ lf, int S, int K,
                       float* __restrict__ tok, float* __restrict__ chk) {
  const int bh = blockIdx.x, nc = S / K;
  const float* lib = li + (size_t)bh * S;
  const float* lfb = lf + (size_t)bh * S;
  float* bo = tok + (size_t)bh * 4 * S;
  float* go = bo + S;
  float* mo = go + S;  // cummax(g) until the last pass makes it m_t
  float* io = mo + S;
  float* ck = chk + (size_t)bh * nc * 4;
  // one thread a chunk, in order: the reference's float operations
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    float cum = 0.f, cmax = -INFINITY;
#pragma unroll 8
    for (int j = c * K; j < (c + 1) * K; ++j) {
      cum += lfb[j];
      const float g = lib[j] - cum;
      cmax = fmaxf(cmax, g);
      bo[j] = cum;
      go[j] = g;
      mo[j] = cmax;
    }
    ck[4 * c + 1] = cmax;
    ck[4 * c + 2] = cum;  // F, until the chain below replaces it
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = NEG_INF;
    for (int c = 0; c < nc; ++c) {
      const float gmax = ck[4 * c + 1], F = ck[4 * c + 2];
      const float m_next = fmaxf(m + F, F + gmax);
      ck[4 * c + 0] = m;
      ck[4 * c + 2] = expf(m + F - m_next);
      ck[4 * c + 3] = expf(F + gmax - m_next);
      m = m_next;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += blockDim.x) {  // every token
    const float m_prev = ck[4 * (j / K)], b = bo[j];
    const float mt = fmaxf(mo[j] + b, m_prev + b);
    mo[j] = mt;
    io[j] = expf((m_prev + b) - mt);
  }
}

// -------------------------------------------------------- chunk updates
constexpr int TA = 64;           // rows of dC a block computes
constexpr int LDA1 = TA + 8;     // row stride of its k slices

template <int DH>
__host__ __device__ constexpr size_t update_smem_bytes() {
  return sizeof(float) * (size_t)(2 * SL * LDA1 + 2 * SL * (DH + 8) + KMAX);
}

// st: (BH, nc, DH * DH + DH) -- dC (row a, column c) then dn.  A block
// computes 64 rows of dC (all DH columns) and of dn on the tensor cores,
// over 32-row slices of the chunk's keys and values: each slice is
// fetched into registers while the last one is multiplied, then stored
// into the other of two shared-memory buffers (one barrier a slice).
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 2)
    mlstm_update_kernel(const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ tok,
                        const float* __restrict__ chk, int S, int K,
                        float* __restrict__ st) {
  using Tl = OutTiling<DH>;
  constexpr int LDB = DH + 8;
  constexpr int NA = (SL * TA / 4 + THREADS - 1) / THREADS;  // float4s a
  constexpr int NB = (SL * DH / 4 + THREADS - 1) / THREADS;  // thread
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                  // 2 x [j][a]
  float* Bs = As + 2 * SL * LDA1;    // 2 x [j][c]
  float* wj = Bs + 2 * SL * LDB;
  const int a0 = blockIdx.x * TA, c = blockIdx.y, bh = blockIdx.z;
  const int nc = S / K, tid = threadIdx.x, warp = tid >> 5;
  const int m0 = (warp / Tl::NWN) * Tl::MT * 16;
  const int n0 = (warp % Tl::NWN) * Tl::NT * 8;
  const size_t row0 = (size_t)bh * S + (size_t)c * K;
  const float* gv = tok + (size_t)bh * 4 * S + S + (size_t)c * K;
  const float gmax = chk[((size_t)bh * nc + c) * 4 + 1];
  for (int j = tid; j < K; j += THREADS) wj[j] = expf(gv[j] - gmax);
  __syncthreads();

  float4 ra[NA], rb[NB];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int u = 0; u < NA; ++u) {
      const int i = tid + u * THREADS, r = i / (TA / 4);
      const int q = 4 * (i % (TA / 4));
      ra[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < SL * TA / 4 && j0 + r < K && a0 + q < DH) {
        const float w = wj[j0 + r];
        const float4 x = ld4(k + (row0 + j0 + r) * DH + a0 + q);
        ra[u] = make_float4(x.x * w, x.y * w, x.z * w, x.w * w);
      }
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int i = tid + u * THREADS, r = i / (DH / 4);
      rb[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < SL * DH / 4 && j0 + r < K)
        rb[u] = ld4(v + (row0 + j0 + r) * DH + 4 * (i % (DH / 4)));
    }
  };
  auto put = [&](int b) {
#pragma unroll
    for (int u = 0; u < NA; ++u) {
      const int i = tid + u * THREADS;
      if (i < SL * TA / 4)
        st4(As + b * SL * LDA1 + (i / (TA / 4)) * LDA1 + 4 * (i % (TA / 4)),
            ra[u]);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int i = tid + u * THREADS;
      if (i < SL * DH / 4)
        st4(Bs + b * SL * LDB + (i / (DH / 4)) * LDB + 4 * (i % (DH / 4)),
            rb[u]);
    }
  };

  float acc[Tl::MT][Tl::NT][4] = {};
  float dn = 0.f;
  fetch(0);
  for (int j0 = 0, b = 0; j0 < K; j0 += SL, b ^= 1) {
    put(b);
    __syncthreads();
    if (j0 + SL < K) fetch(j0 + SL);
    const int kn = min(SL, K - j0);
    warp_mma<Tl::MT, Tl::NT, false, true>(As + b * SL * LDA1, LDA1,
                                          Bs + b * SL * LDB, LDB,
                                          (kn + 7) & ~7, m0, n0, acc);
    if (tid < TA)
      for (int kk = 0; kk < kn; ++kk) dn += As[b * SL * LDA1 + kk * LDA1 + tid];
  }
  float* out = st + ((size_t)bh * nc + c) * (DH * DH + DH);
  const int g = (tid & 31) >> 2, cc = tid & 3;
#pragma unroll
  for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = a0 + m0 + 16 * mt + g + 8 * h;
      if (a >= DH) continue;
#pragma unroll
      for (int nt = 0; nt < Tl::NT; ++nt)
        *reinterpret_cast<float2*>(out + (size_t)a * DH + n0 + 8 * nt +
                                   2 * cc) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    }
  if (tid < TA && a0 + tid < DH) out[DH * DH + a0 + tid] = dn;
}

// ----------------------------------------------------------- state scan
// In place over st: each chunk's dC / dn becomes the state at its start.
// The loads of sixteen chunks go out before their stores, so a thread
// keeps sixteen 16-byte loads in flight.
__global__ void __launch_bounds__(THREADS)
    mlstm_scan_kernel(const float* __restrict__ chk, int nc, int per_chunk,
                      float* __restrict__ st) {
  constexpr int U = 16;
  const int bh = blockIdx.y;
  const int e = 4 * (blockIdx.x * THREADS + threadIdx.x);
  if (e >= per_chunk) return;
  float* p = st + (size_t)bh * nc * per_chunk + e;
  const float* ck = chk + (size_t)bh * nc * 4;
  float4 C = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += U) {
    float4 d[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < nc) d[u] = ld4(p + (size_t)(c0 + u) * per_chunk);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      if (c >= nc) break;
      const float a = ck[4 * c + 2], s = ck[4 * c + 3];
      st4(p + (size_t)c * per_chunk, C);
      C = make_float4(a * C.x + s * d[u].x, a * C.y + s * d[u].y,
                      a * C.z + s * d[u].z, a * C.w + s * d[u].w);
    }
  }
}

// -------------------------------------------------------------- outputs
constexpr int LDW = KMAX + 4;  // row stride of the decayed scores

template <int DH>
__host__ __device__ constexpr int slice_depth() {  // of q, k and C slices
  return DH < SL ? DH : SL;
}

// floats of a buffer: a q slice, then a k, v or C slice
template <int DH>
__host__ __device__ constexpr int out_buffer_floats() {
  return RT * (slice_depth<DH>() + 4) +
         (KMAX * (slice_depth<DH>() + 4) > SL * (DH + 8)
              ? KMAX * (slice_depth<DH>() + 4)
              : SL * (DH + 8));
}

template <int DH>
__host__ __device__ constexpr size_t out_smem_bytes() {
  return sizeof(float) * (size_t)(RT * LDW + 2 * out_buffer_floats<DH>() +
                                  DH + KMAX + 4 * RT);
}

// A block: RT rows of one chunk, two products on the tensor cores, each
// over slices fetched into registers while the last slice is multiplied
// and then stored into the other of two shared-memory buffers:
//   scores  (RT x dh) x (dh x K): q and k slices of 32 columns; w = (s *
//           scale) * D into Ws[t][j];
//   outputs (RT x (K + dh)) x ((K + dh) x dh): w against 32-row slices of
//           v, then (weight * scale * q) against 32-row slices of the
//           chunk's start state C, with q n beside it.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 2)
    mlstm_out_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ tok,
                     const float* __restrict__ st, int S, int K, float scale,
                     T* __restrict__ out) {
  using Tl = OutTiling<DH>;
  constexpr int SLA = slice_depth<DH>();
  constexpr int LDQ = SLA + 4;            // row stride of q and k slices
  constexpr int LDX = DH + 8;             // row stride of v and C slices
  constexpr int NSA = DH / SLA;           // slices over dh
  constexpr int NQF = (SLA * RT / 4 + THREADS - 1) / THREADS;    // float4s
  constexpr int NKF = (SLA * KMAX / 4 + THREADS - 1) / THREADS;  // a
  constexpr int NBF = (SL * DH / 4 + THREADS - 1) / THREADS;     // thread
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;                       // [t][j]: w[t][j]
  float* buf0 = Ws + RT * LDW;            // two buffers: [t][a] q slice,
  float* ns = buf0 + 2 * out_buffer_floats<DH>();  // then k/v/C slice
  float* gs = ns + DH;                    // g of the chunk's keys
  float* bs = gs + KMAX;                  // b, m_t, weight, den of rows
  float* ms = bs + RT;
  float* iws = ms + RT;
  float* den = iws + RT;
  auto qbuf = [&](int b) { return buf0 + b * out_buffer_floats<DH>(); };
  auto xbuf = [&](int b) { return qbuf(b) + RT * LDQ; };

  const int t0 = blockIdx.x * RT, c = blockIdx.y, bh = blockIdx.z;
  const int nc = S / K, tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, cc = tid & 3;
  const int rows = min(RT, K - t0);       // rows of this block
  const int kend = t0 + rows;             // keys j < kend
  const size_t row0 = (size_t)bh * S + (size_t)c * K;
  const float* tb = tok + (size_t)bh * 4 * S + (size_t)c * K;
  const float* stc = st + ((size_t)bh * nc + c) * (DH * DH + DH);
  for (int j = tid; j < K; j += THREADS) gs[j] = tb[S + j];
  for (int i = tid; i < RT; i += THREADS) {
    const bool ok = i < rows;
    bs[i] = ok ? tb[t0 + i] : 0.f;
    ms[i] = ok ? tb[2 * S + t0 + i] : 0.f;
    iws[i] = ok ? tb[3 * S + t0 + i] : 0.f;
  }
  for (int a = tid; a < DH; a += THREADS) ns[a] = stc[DH * DH + a];
  __syncthreads();

  // q rows a0 .. a0 + SLA (times weight * scale per row when weighted)
  float4 rq[NQF], rk[NKF];
  auto fetch_q = [&](int a0, bool weighted) {
#pragma unroll
    for (int u = 0; u < NQF; ++u) {
      const int i = tid + u * THREADS, r = i / (SLA / 4);
      rq[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < SLA * RT / 4 && r < rows) {
        const float4 x =
            ld4(q + (row0 + t0 + r) * DH + a0 + 4 * (i % (SLA / 4)));
        const float w = weighted ? iws[r] * scale : 1.f;
        rq[u] = make_float4(w * x.x, w * x.y, w * x.z, w * x.w);
      }
    }
  };
  auto put_q = [&](int b) {
#pragma unroll
    for (int u = 0; u < NQF; ++u) {
      const int i = tid + u * THREADS;
      if (i < SLA * RT / 4)
        st4(qbuf(b) + (i / (SLA / 4)) * LDQ + 4 * (i % (SLA / 4)), rq[u]);
    }
  };

  // ---- scores over all keys j < kend: Ws[t][j] = w[t][j]
  {
    constexpr int MT = 2, NT = 4;         // 2 x 4 warps of 32 x 32
    const int sm0 = (warp >> 2) * 32, sn0 = (warp & 3) * 32;
    auto fetch_k = [&](int a0) {
#pragma unroll
      for (int u = 0; u < NKF; ++u) {
        const int i = tid + u * THREADS, r = i / (SLA / 4);
        rk[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < SLA * KMAX / 4 && r < kend)
          rk[u] = ld4(k + (row0 + r) * DH + a0 + 4 * (i % (SLA / 4)));
      }
    };
    float acc[MT][NT][4] = {};
    fetch_q(0, false);
    fetch_k(0);
    for (int sa = 0; sa < NSA; ++sa) {
      const int b = sa & 1;
      put_q(b);
#pragma unroll
      for (int u = 0; u < NKF; ++u) {
        const int i = tid + u * THREADS;
        if (i < SLA * KMAX / 4)
          st4(xbuf(b) + (i / (SLA / 4)) * LDQ + 4 * (i % (SLA / 4)), rk[u]);
      }
      __syncthreads();
      if (sa + 1 < NSA) {
        fetch_q((sa + 1) * SLA, false);
        fetch_k((sa + 1) * SLA);
      }
      if (sn0 < kend)
        warp_mma<MT, NT, true, false>(qbuf(b), LDQ, xbuf(b), LDQ, SLA, sm0,
                                      sn0, acc);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = sm0 + 16 * mt + g + 8 * h, t = t0 + r;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = sn0 + 8 * nt + 2 * cc + e;
            float w = 0.f;
            if (r < rows && j <= t)
              w = (acc[mt][nt][2 * h + e] * scale) *
                  expf(bs[r] + gs[j] - ms[r]);
            Ws[r * LDW + j] = w;
          }
      }
  }
  __syncthreads();
  if (tid < RT) {  // sum w over the row's keys
    float sum = 0.f;
    for (int j = 0; j < kend; ++j) sum += Ws[tid * LDW + j];
    den[tid] = sum;
  }

  // ---- num = w v + (weight * scale * q) C: slices of v rows, then of
  //      q columns and C rows
  const int nj = (kend + SL - 1) / SL;
  float4 rb[NBF];
  auto fetch = [&](int s) {
    const T* src_t = nullptr;
    const float* src_f = nullptr;
    int nr;
    if (s < nj) {
      nr = min(SL, kend - s * SL);
      src_t = v + (row0 + s * SL) * DH;
    } else {
      const int a0 = (s - nj) * SLA;
      nr = SLA;
      src_f = stc + (size_t)a0 * DH;
      fetch_q(a0, true);
    }
#pragma unroll
    for (int u = 0; u < NBF; ++u) {
      const int i = tid + u * THREADS, r = i / (DH / 4);
      const int cq = 4 * (i % (DH / 4));
      rb[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < SL * DH / 4 && r < nr)
        rb[u] = src_t ? ld4(src_t + r * DH + cq) : ld4(src_f + r * DH + cq);
    }
  };
  const int m0 = (warp / Tl::NWN) * Tl::MT * 16;
  const int n0 = (warp % Tl::NWN) * Tl::NT * 8;
  float acc[Tl::MT][Tl::NT][4] = {};
  float qn = 0.f;
  fetch(0);
  for (int s = 0; s < nj + NSA; ++s) {
    const int b = s & 1;
    if (s >= nj) put_q(b);
#pragma unroll
    for (int u = 0; u < NBF; ++u) {
      const int i = tid + u * THREADS;
      if (i < SL * DH / 4)
        st4(xbuf(b) + (i / (DH / 4)) * LDX + 4 * (i % (DH / 4)), rb[u]);
    }
    __syncthreads();
    if (s + 1 < nj + NSA) fetch(s + 1);
    if (s < nj) {
      const int kn = min(SL, kend - s * SL);
      warp_mma<Tl::MT, Tl::NT, true, true>(Ws + s * SL, LDW, xbuf(b), LDX,
                                           (kn + 7) & ~7, m0, n0, acc);
    } else {
      const int a0 = (s - nj) * SLA;
      if (tid < RT)
        for (int aa = 0; aa < SLA; ++aa)
          qn = fmaf(qbuf(b)[tid * LDQ + aa], ns[a0 + aa], qn);
      warp_mma<Tl::MT, Tl::NT, true, true>(qbuf(b), LDQ, xbuf(b), LDX, SLA,
                                           m0, n0, acc);
    }
  }
  if (tid < RT) den[tid] += qn;
  __syncthreads();

  // ---- h = num / max(|den|, e^-m_t)
  T* ob = out + (row0 + t0) * DH;
#pragma unroll
  for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 16 * mt + g + 8 * h;
      if (r >= rows) continue;
      const float d = fmaxf(fabsf(den[r]), expf(-ms[r]));
#pragma unroll
      for (int nt = 0; nt < Tl::NT; ++nt)
        st2(ob + (size_t)r * DH + n0 + 8 * nt + 2 * cc,
            acc[mt][nt][2 * h] / d, acc[mt][nt][2 * h + 1] / d);
    }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* li, const float* lf, void* out, int BH,
                   int S, int K, float scale, float* tok, float* chk,
                   float* st, cudaStream_t s) {
  const int nc = S / K;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  constexpr size_t smem = out_smem_bytes<DH>();
  static bool attributes_set = false;  // once per instantiation
  if (!attributes_set) {
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_update_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)update_smem_bytes<DH>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mlstm_out_kernel<T, DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return err;
    attributes_set = true;
  }
  mlstm_gates_kernel<<<BH, THREADS, 0, s>>>(li, lf, S, K, tok, chk);
  mlstm_update_kernel<T, DH>
      <<<dim3((DH + 63) / 64, nc, BH), THREADS, update_smem_bytes<DH>(), s>>>(
          kt, vt, tok, chk, S, K, st);
  const int per_chunk = DH * DH + DH;
  mlstm_scan_kernel<<<dim3((per_chunk / 4 + THREADS - 1) / THREADS, BH),
                      THREADS, 0, s>>>(chk, nc, per_chunk, st);
  mlstm_out_kernel<T, DH><<<dim3((K + RT - 1) / RT, nc, BH), THREADS, smem,
                            s>>>(qt, kt, vt, tok, st, S, K, scale,
                                 static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v,
                     const float* li, const float* lf, void* out, int BH,
                     int S, int K, float scale, float* tok, float* chk,
                     float* st, cudaStream_t s) {
#define MLSTM_CASE(DIM)                                                   \
  case DIM:                                                               \
    return launch<T, DIM>(q, k, v, li, lf, out, BH, S, K, scale, tok, chk, \
                          st, s);
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

// q, k, v, out: (BH, S, dh) contiguous, 16-byte aligned, f32 (is_bf16 = 0)
// or bf16 (1); li, lf: (BH, S) f32 log gates.  S a multiple of the chunk
// K <= 128; dh one of 16, 32, 64, 96, 128, 192.  Scratch, f32: tok (BH, 4,
// S), chk (BH, S / K, 4), st (BH, S / K, dh * dh + dh).
extern "C" int mlstm_chunkwise(const void* q, const void* k, const void* v,
                               const float* li, const float* lf, void* out,
                               int BH, int S, int dh, int K, float scale,
                               int is_bf16, float* tok, float* chk,
                               float* st, void* stream) {
  if (BH == 0 || S == 0) return 0;
  if (K < 1 || K > KMAX || S % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(dh, q, k, v, li, lf, out, BH, S, K,
                                        scale, tok, chk, st, s);
  return (int)dispatch<float>(dh, q, k, v, li, lf, out, BH, S, K, scale, tok,
                              chk, st, s);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
