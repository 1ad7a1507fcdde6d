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
// f32 (flash_mma_kernel): on the tensor cores, as 3xTF32 mma.sync
// m16n8k8.  One TF32 product keeps about 10 bits of each operand and
// misses the reference's 2e-5 many times over, so each operand is split
// into a TF32 hi and lo part and A B = A_lo B_hi + A_hi B_lo + A_hi B_hi,
// all three terms in both products (tests/test_torch_kernels_ops.py
// emulates the design, and shows that any term dropped misses).  Bound by
// operations: 3 x 4*d flops per unmasked score at the 495 TFLOP/s of
// TF32.  Eight warps a block: four bands of 16 q rows, two warps a band,
// one half of d each.  A warp sums Q.K^T over its half of d and adds its
// partner's partial scores through shared memory; both then run the same
// softmax, and each computes P.V for its half of the output columns (64
// accumulators a thread at d = 256).  P passes from the scores'
// accumulator to P.V's A fragment in registers, unmoved: within an 8-key
// step the keys are taken in the accumulator's order (2c, 2c + 1 as
// columns c, c + 4), and V's rows in the same order.  Q, K and V tiles (64
// rows) sit in shared memory with their 8-float chunks permuted so that
// fragment loads are free of bank conflicts, 229,376 bytes at d = 256: one
// block an SM.  cp.async brings V(j) in while Q.K^T(j) runs and K(j + 1)
// while P.V(j) runs.
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
constexpr float NEG_INF = -1e30f;

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

  // the KV tiles holding any unmasked key of this q tile (as
  // flash_mma_kernel)
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

// ------------------------------------------ f32 on the tensor cores, 3xTF32
constexpr int MMA_THREADS = 256;   // 8 warps: 4 row bands x 2 halves of d

// 3xTF32 (as mlstm_chunk.cu): each f32 operand x is split into x_hi and
// x_lo = x - x_hi, and A B = A_lo B_hi + A_hi B_lo + A_hi B_hi in f32
// accumulators (the dropped A_lo B_lo is below f32 rounding).  x_hi is x
// with its 13 low mantissa bits cleared (TF32, rounded toward zero), so
// x_lo is exact in f32, and x_lo goes to the tensor cores as it is: they
// read a TF32 operand's upper 19 bits (the code nvcc emits for
// cvt.rna.tf32.f32 relies on that too), so it is rounded toward zero
// there.  Two instructions an element where cvt.rna takes about eight for
// both parts (with its checks for inf and NaN); round to nearest would
// not be more accurate here (tests/test_torch_kernels_ops.py emulates
// both).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// an A fragment split once, for all the B fragments it meets
struct SplitA {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2,
                                          float a3) {
  SplitA a;
  split_tf32(a0, a.hi[0], a.lo[0]);
  split_tf32(a1, a.hi[1], a.lo[1]);
  split_tf32(a2, a.hi[2], a.lo[2]);
  split_tf32(a3, a.hi[3], a.lo[3]);
  return a;
}

// d += A B, B's fragment (b0, b1) split here
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const SplitA& a,
                                           float b0, float b1) {
  uint32_t bh[2], bl[2];
  split_tf32(b0, bh[0], bl[0]);
  split_tf32(b1, bh[1], bl[1]);
  mma_tf32(d, a.lo, bh);
  mma_tf32(d, a.hi, bl);
  mma_tf32(d, a.hi, bh);
}

// the two warps of a row band meet here (named barriers 1-4; 0 is
// __syncthreads)
__device__ __forceinline__ void band_sync(int band) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(band + 1) : "memory");
}

// Q, K and V tiles in shared memory: 64 rows of D floats, unpadded, the
// 8-float chunks of a row permuted by an XOR so that fragment loads are
// free of bank conflicts.  Q and K are read 8 bytes a lane (rows g, dims
// 2c and 2c + 1): chunk ^ (row % 4) puts rows g = 0..3 of a half-warp on
// four different groups of 8 banks.  V is read 4 bytes a lane (keys 2c
// and 2c + 1, column g): chunk ^ (row / 2 % 4) does the same for c =
// 0..3.  16-byte cp.async chunks stay whole.  At d = 16 (two chunks a
// row) nothing is permuted.
template <int D>
__device__ __forceinline__ int qk_at(int row, int col) {
  return row * D + (col ^ (D >= 32 ? (row & 3) << 3 : 0));
}
template <int D>
__device__ __forceinline__ int v_at(int row, int col) {
  return row * D + (col ^ (D >= 32 ? ((row >> 1) & 3) << 3 : 0));
}
// Q, K and V tiles, and each warp's partial scores (BK / 8 float4 a lane)
template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * D +
                          (size_t)(MMA_THREADS / 32) * BK * 16);
}

// rows [0, valid) of a 64 x D f32 tile at g (row stride D) into shared
// memory at dst, laid out as V (v_at) or as Q and K (qk_at), rows from
// `valid` on zeros; 16 bytes a thread per step, consecutive threads on
// consecutive bytes of a row
template <int D, bool AS_V>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* g,
                                              int valid, int tid) {
  constexpr int CH = D / 4;                   // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < BK * CH / MMA_THREADS; ++it) {
    const int i = tid + it * MMA_THREADS;
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid;
    cp_async16(smem_u32(dst + (AS_V ? v_at<D>(r, c * 4)
                                    : qk_at<D>(r, c * 4))),
               ok ? g + (size_t)r * D + c * 4 : g, ok ? 16 : 0);
  }
}

// One block per (b*h, 64-row q tile), longest causal tiles first.  Warp w
// owns rows 16 (w / 2) .. + 15 of the tile and half w % 2 of d: for Q.K^T
// it sums its half of the dimensions over all BK keys of a tile, the two
// warps of a band add their partial scores through shared memory (a + b
// == b + a, so both hold the same scores and run the same softmax), and
// for P.V it owns its half of the output columns.  Every product is
// mma.sync m16n8k8 in 3xTF32.  A fragment's logical column c is the pair
// (2c, 2c + 1) of the accumulator layout: for Q.K^T, dims 2c and 2c + 1
// of an 8-dim step are logical columns c and c + 4 of both Q and K (8-byte
// loads); for P.V the scores' accumulator is P's A fragment as it stands
// (row g, keys 2c, 2c + 1 in elements 0, 1; row g + 8 in 2, 3) when B
// takes V's keys 2c and 2c + 1 as its rows c and c + 4.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 1)
flash_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int Hkv, int Sq, int Skv, int causal, int window,
                 float sm_scale) {
  constexpr int HALF = D / 2;
  constexpr int KS = HALF / 8;                // 8-dim steps of a half
  constexpr int NK = BK / 8;                  // 8-key tiles of a KV tile
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;                         // BQ x D
  float* Ks = Qs + BQ * D;                    // BK x D
  float* Vs = Ks + BK * D;                    // BK x D
  float4* Xs = reinterpret_cast<float4*>(Vs + BK * D);  // warps x NK x 32

  // block -> (b*h, q tile), ranked by causal length, longest first
  const int nqt = (Sq + BQ - 1) / BQ;
  const int BH = gridDim.x / nqt;
  const int bh = blockIdx.x % BH, qt = nqt - 1 - blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int nrow = min(BQ, Sq - q0);
  const float* kp = k + (size_t)(b * Hkv + hk) * Skv * D;
  const float* vp = v + (size_t)(b * Hkv + hk) * Skv * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int band = warp >> 1, half = warp & 1;
  const int g = lane >> 2, c = lane & 3;      // fragment row, column pair
  const int r0 = band * 16 + g;               // this lane's rows r0, r0 + 8
  const int d0 = half * HALF + 2 * c;         // its dims d0 + 8 s, + 1

  // the KV tiles holding any unmasked key of this q tile; a tile holding a
  // row with no real key (window > 0 and q >= Skv + window - 1) skips none
  const int q_last = q0 + nrow - 1;
  const int nkt = (Skv + BK - 1) / BK;
  int lo = 0, hi = nkt;
  if (!(window > 0 && q_last >= Skv + window - 1)) {
    if (causal) hi = min(nkt, q_last / BK + 1);
    if (window > 0) lo = max(0, q0 - window + 1) / BK;
  }
  load_tile_f32<D, false>(Qs, q + ((size_t)bh * Sq + q0) * D, nrow, tid);
  if (lo < hi)
    load_tile_f32<D, false>(Ks, kp + (size_t)lo * BK * D, Skv - lo * BK,
                            tid);
  cp_async_commit();

  // output columns half * HALF + 8 n + 2c, +1: rows r0 in acc[n][0..1],
  // r0 + 8 in acc[n][2..3]; m and l of rows r0, r0 + 8 (l this lane's
  // share, summed over the quad at the end)
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_all();
    __syncthreads();            // K(kt) landed; P.V(kt-1) done, V free
    load_tile_f32<D, true>(Vs, vp + (size_t)k0 * D, Skv - k0, tid);
    cp_async_commit();

    // this half's share of the scores: keys 8j + 2c, +1 in s[j][0..1]
    // (row r0), s[j][2..3] (row r0 + 8)
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      const float2 qg = *reinterpret_cast<const float2*>(
          Qs + qk_at<D>(r0, d0 + 8 * st));
      const float2 qg8 = *reinterpret_cast<const float2*>(
          Qs + qk_at<D>(r0 + 8, d0 + 8 * st));
      const SplitA a = split_a(qg.x, qg8.x, qg.y, qg8.y);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(
            Ks + qk_at<D>(8 * j + g, d0 + 8 * st));
        mma_3xtf32(s[j], a, x.x, x.y);
      }
    }
    // the other half's share, from its warp
    float4* mine = Xs + (warp * NK) * 32 + lane;
    const float4* other = Xs + ((warp ^ 1) * NK) * 32 + lane;
#pragma unroll
    for (int j = 0; j < NK; ++j)
      mine[j * 32] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    band_sync(band);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float4 x = other[j * 32];
      s[j][0] += x.x;
      s[j][1] += x.y;
      s[j][2] += x.z;
      s[j][3] += x.w;
    }

    const bool masked = (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && q_last - k0 >= window) ||
                        k0 + BK > Skv;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[j][e] * sm_scale;
        if (masked) {
          const int qpos = q0 + r0 + (e >> 1) * 8;
          const int kpos = k0 + 8 * j + 2 * c + (e & 1);
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
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - m[e >> 1]) * LOG2E);  // P, in place
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    cp_async_wait_all();
    __syncthreads();            // V(kt) landed; Q.K^T(kt) done, K free
    if (kt + 1 < hi)
      load_tile_f32<D, false>(Ks, kp + (size_t)(k0 + BK) * D, Skv - k0 - BK,
                              tid);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const SplitA a = split_a(s[j][0], s[j][2], s[j][1], s[j][3]);
      const int kr = 8 * j + 2 * c, col = half * HALF + g;
#pragma unroll
      for (int n = 0; n < KS; ++n)
        mma_3xtf32(acc[n], a, Vs[v_at<D>(kr, col + 8 * n)],
                   Vs[v_at<D>(kr + 1, col + 8 * n)]);
    }
  }
  cp_async_wait_all();

  float* op = o + ((size_t)bh * Sq + q0) * D + d0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + 8 * i;
    if (r >= nrow) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < KS; ++n)
      *reinterpret_cast<float2*>(op + (size_t)r * D + 8 * n) =
          make_float2(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Hkv, int Sq, int Skv, int causal,
                       int window, float sm_scale, cudaStream_t s) {
  constexpr size_t smem = mma_smem_bytes<D>();
  const int64_t n_items = (int64_t)B * H * ((Sq + BQ - 1) / BQ);
  if (n_items > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_mma_kernel<D><<<(unsigned)n_items, MMA_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, Sq, Skv,
      causal, window, sm_scale);
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
      return launch_mma<DIM>(q, k, v, o, B, H, Hkv, Sq, Skv, causal,       \
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
