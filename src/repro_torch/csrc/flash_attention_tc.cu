// Flash attention on the tensor cores, for bfloat16 q/k/v: grouped-query,
// causal and/or sliding-window online-softmax attention that never writes
// the score matrix to memory.  Head widths 64, 80, 128 and 256.  The
// float32 route, and the other head widths, stay on the CUDA-core kernel
// (flash_attention.cu); kernels/flash_attention.py picks the route.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas), as flash_attention.cu does: q (B, S, H, D) and
// k/v (B, S, KV, D) are read in place through their strides (query head h
// reads KV head h / (H / KV)), the ragged edge is masked, not padded.
//
// What bounds it on an H100: operations.  At the main path's call
// (B 2, S 4096, H 16, KV 2, D 128, causal) the two products need
// 4 * B * H * D * 8,390,656 kept pairs = 137.4 GFLOP, 0.139 ms at the
// tensor cores' 989 TFLOP/s; q/k/v/o are 75 MB, 0.023 ms at 3.35 TB/s.
// The kernel executes more: whole 128 x 128 tiles on the diagonal, and
// P.V twice (below), 4 * B * H * D * 1.5 * (tile pairs * 128^2) =
// 4 * 2 * 16 * 128 * 1.5 * 8,650,752 = 213 GFLOP.  At hubert-xlarge's
// encoder call (B 2, S 4096, H 16, KV 16, D 80, non-causal) the function
// needs 4 * 2 * 16 * 80 * 4096^2 = 171.8 GFLOP, 0.174 ms; the kernel
// executes 1.5 times that, 257.7 GFLOP (P.V twice; no tile is partial).
//
// Design (a CTA of 384 threads per (128-row query tile, query head,
// batch); longest causal tiles first):
//   - warp specialisation: warpgroup 2 is the producer (setmaxnreg down to
//     24 registers); one of its threads loads Q once and K and V tiles of
//     BK keys by TMA into a ring of two shared-memory stages, with an
//     mbarrier "full" per tile and an "empty" one the consumers release;
//   - warpgroups 0 and 1 are consumers (setmaxnreg up to 240), 64 query
//     rows each.  S = Q.K^T by wgmma m64nBKk16 (bf16 in, f32 accumulate),
//     Q and K from 128-byte-swizzled shared memory (both D-contiguous, so
//     K-major); masks as flash_attention.cu (-1e30, never -inf); online
//     softmax in registers in base 2 (the scale folded with log2(e));
//     O += P.V by wgmma m64nDk16 with P from registers and V read
//     MN-major through the transpose bit;
//   - tiles wholly above the diagonal or left of the window are skipped;
//     others are masked only where a key can fall outside;
//   - a head is held as ceil(D / 64) column blocks of 64, one TMA box
//     each.  At D 80 the tensor map's D extent is 80, so TMA zero-fills
//     the second block's columns 80-127 (and counts them in the bytes a
//     load completes); Q.K^T takes five k16 steps, the fifth on block 1,
//     and P.V one n80 product over block 0 and 16 columns of block 1: the
//     products execute D 80's work, not D 128's.
// Numerics: the check this kernel is held to (rtol 8e-3, atol 1e-3 against
// the f32 plain version) allows one bf16 rounding, the output's.  Rounding
// P to bf16 before P.V, FlashAttention's usual step, adds a second and
// breaks it in the first rows of a causal sequence, where few keys are
// kept.  So P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi) and
// O += P_hi.V + P_lo.V: P is carried to ~16 bits at 1.5 times the tensor
// work of the two products.
// Not here yet (ROADMAP Queue 2, this kernel's entry): the ping-pong of the two consumers'
// softmax against the other's products, and the overlap of one tile's
// softmax with the next tile's Q.K^T inside a warpgroup.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 128;          // query rows per CTA
constexpr int kStages = 2;        // K/V ring
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreadsTC = 384;   // + the producer warpgroup
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// a wait longer than this (~10 s) is a fault: trap instead of hanging
constexpr long long kHangCycles = 20000000000ll;

// D (64 x 64, f32) += A (64 x 16, shared) * B (64 x 16, shared); scale_d 0
// overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, shared) * B (128 x 16, shared); scale_d 0
// overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 80, f32) += A (64 x 16, registers) * B (16 x 80, shared,
// MN-major: the transpose bit): the 64 columns of block 0 and the first 16
// of block 1, LBO apart
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, registers) * B (16 x 256, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, scale_d);
  } else {
    static_assert(N == 128, "S tiles of 64 or 128 keys");
    wgmma_ss_n128(d, da, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 80) {
    wgmma_rs_n80(d, a, db);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    static_assert(N == 256, "head widths 64, 80, 128, 256");
    wgmma_rs_n256(d, a, db);
  }
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
// keep the compiler from moving reads or writes of wgmma operands across
// the asynchronous product's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma operand descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// wait for the completion of the phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

// one TMA box of a (B, S, heads, D) tensor: 64 columns of one head, `rows`
// positions, into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(pos), "r"(batch)
      : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// column blocks of 64 (one TMA box, one 128-byte swizzled row each) that
// hold a head of width D; TMA zero-fills a last block's columns past D
__host__ __device__ constexpr int col_blocks(int d) {
  return (d + 63) / 64;
}

template <int D, int BK>
constexpr size_t tc_smem_bytes() {
  // 1 KB of slack to align the tiles to 1024 bytes (the swizzle's period),
  // Q, the K and V rings at the padded width, then the barriers
  constexpr size_t dp = col_blocks(D) * 64;
  return 1024 + static_cast<size_t>(kBQ) * dp * 2 +
         2 * static_cast<size_t>(kStages) * BK * dp * 2 + 64;
}

// Shared memory: Q as ceil(D/64) column blocks of (128 rows x 128 bytes),
// K and V per stage as ceil(D/64) column blocks of (BK rows x 128 bytes),
// each block 128-byte swizzled as TMA writes it.  At D 80 the second block
// holds columns 64-79 and 48 zero columns, which no product reads: Q.K^T
// stops at depth D, P.V's n80 at column D.
template <int D, int BK>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          __nv_bfloat16* __restrict__ out, int S, int H,
                          int KV, int causal, int window, float scale_log2) {
  static_assert(D % 16 == 0, "Q.K^T walks the depth in steps of 16");
  constexpr int kCB = col_blocks(D);
  // whole boxes, zero-filled columns included: what TMA writes and what
  // each load's expect_tx must count, or the barrier never completes
  constexpr uint32_t kQBytes = kBQ * kCB * 128;
  constexpr uint32_t kKVBytes = BK * kCB * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = base;
  uint8_t* ks = qs + kQBytes;
  uint8_t* vs = ks + kStages * kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;

  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBQ;  // long tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  // the key tiles some row of this query tile keeps
  const int q_hi = min(q_lo + kBQ - 1, S - 1);
  const int kt_end = (causal ? q_hi : S - 1) / BK;
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / BK;
  const int n_tiles = kt_end - kt_begin + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(kv_empty + st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: never rejoins the consumers' path
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
        tma_load(qs + cb * kBQ * 128, &qmap, q_full, cb * 64, h, q_lo, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t round = (i / kStages) & 1;
        mbar_wait(kv_empty + st, round ^ 1);  // the first round passes
        const int k_lo = (kt_begin + i) * BK;
        mbar_expect_tx(k_full + st, kKVBytes);
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb)
          tma_load(ks + st * kKVBytes + cb * BK * 128, &kmap, k_full + st,
                   cb * 64, kvh, k_lo, b);
        mbar_expect_tx(v_full + st, kKVBytes);
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb)
          tma_load(vs + st * kKVBytes + cb * BK * 128, &vmap, v_full + st,
                   cb * 64, kvh, k_lo, b);
      }
    }
  } else {  // consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    // this thread's rows of the accumulators: r0 and r0 + 8
    const int r0 = wg * 64 + (t / 32) * 16 + lane / 4;
    const int qpos0 = q_lo + r0;
    const int qpos1 = qpos0 + 8;
    const int wg_lo = q_lo + wg * 64;  // the warpgroup's first row
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNeg, kNeg};
    float l[2] = {0.0f, 0.0f};  // this thread's part of the row sums
    const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const uint32_t round = (i / kStages) & 1;
      const int k_lo = (kt_begin + i) * BK;

      // S = Q.K^T
      float s[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] = 0.0f;
      mbar_wait(k_full + st, round);
      const uint32_t k_addr = smem_u32(ks + st * kKVBytes);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
        const uint64_t da =
            sw128_desc(q_addr + (kk / 4) * (kBQ * 128) + off, 16, 1024);
        const uint64_t db =
            sw128_desc(k_addr + (kk / 4) * (BK * 128) + off, 16, 1024);
        wgmma_ss<BK>(s, da, db, kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // masks and the online softmax, in base 2
      const bool masked = k_lo + BK > S ||
                          (causal && k_lo + BK - 1 > wg_lo) ||
                          (window > 0 && k_lo <= wg_lo + 63 - window);
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j * 4 + e] * scale_log2;
          if (masked) {
            const int kpos = k_lo + j * 8 + (lane % 4) * 2 + (e & 1);
            const int qpos = (e >> 1) ? qpos1 : qpos0;
            bool ok = kpos < S;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) x = kNeg;
          }
          s[j * 4 + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j * 4 + e] - m[e >> 1]);
          s[j * 4 + e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j * 4 + 0] *= alpha[0];
        o[j * 4 + 1] *= alpha[0];
        o[j * 4 + 2] *= alpha[1];
        o[j * 4 + 3] *= alpha[1];
      }

      // P as the A operand of m64k16 steps, split into hi and lo bf16
      // terms: a0 (r0, keys 16kk + 2(lane%4) + {0,1}), a1 (r0 + 8, same),
      // a2 (r0, 8 keys on), a3 (r0 + 8, 8 keys on)
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int idx = (2 * kk + (q >> 1)) * 4 + (q & 1) * 2;
          const float x0 = s[idx];
          const float x1 = s[idx + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][q] = bf16x2_bits(hi);
          p_lo[kk][q] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x,
                                                          x1 - hf.y));
        }
      }

      // O += P_hi.V + P_lo.V
      mbar_wait(v_full + st, round);
      const uint32_t v_addr = smem_u32(vs + st * kKVBytes);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = sw128_desc(v_addr + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs<D>(o, p_hi[kk], db);
        wgmma_rs<D>(o, p_lo[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(kv_empty + st);
    }

    // out = O / l, rows past S not written
    __nv_bfloat16* ob =
        out + (static_cast<int64_t>(b) * S * H + h) * D + (lane % 4) * 2;
    const int64_t q_step = static_cast<int64_t>(H) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float denom = fmaxf(lt, 1e-30f);
      const int qpos = r ? qpos1 : qpos0;
      if (qpos < S) {
        __nv_bfloat16* orow = ob + qpos * q_step;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
              __floats2bfloat162_rn(o[j * 4 + 2 * r] / denom,
                                    o[j * 4 + 2 * r + 1] / denom);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// codes past cudaError's: the entry point was not found, or the encoding
// failed (kEncodeFailed + its CUresult)
constexpr int kNoEncoder = 9999;
constexpr int kEncodeFailed = 10000;

// (B, S, heads, D) bf16 -> boxes of 64 columns x 1 head x rows positions
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
             int D, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int D, int BK>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int KV, int causal, int window, float scale,
              cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int rc = make_map(&qm, q, B, S, H, D, kBQ);
  if (rc == 0) rc = make_map(&km, k, B, S, KV, D, BK);
  if (rc == 0) rc = make_map(&vm, v, B, S, KV, D, BK);
  if (rc != 0) return rc;
  constexpr size_t smem = tc_smem_bytes<D, BK>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_tc_kernel<D, BK><<<grid, kThreadsTC, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), S, H, KV, causal, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, D), k/v (B, S, KV, D), out (B, S, H, D): contiguous bfloat16,
// D 64, 80, 128 or 256, H a multiple of KV.  window <= 0 means no window.
// Launches on `stream` and returns cudaGetLastError() as an int, or 9999
// when libcuda's tensor-map encoder is missing, or 10000 + its CUresult
// when it refuses a map.
extern "C" int quipt_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* out, int B,
                                        int S, int H, int KV, int D,
                                        int causal, int window, float scale,
                                        void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV < 1 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_tc<64, 128>(q, k, v, out, B, S, H, KV, causal, window,
                                scale, st);
    case 80:
      return launch_tc<80, 128>(q, k, v, out, B, S, H, KV, causal, window,
                                scale, st);
    case 128:
      return launch_tc<128, 128>(q, k, v, out, B, S, H, KV, causal, window,
                                 scale, st);
    case 256:
      return launch_tc<256, 64>(q, k, v, out, B, S, H, KV, causal, window,
                                scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
