// Hopper (sm_90a) building blocks shared by the flash-attention kernels of
// flash_fwd.cu, flash_bwd.cu and flash_wide.cu: the block shape of their
// 16-bit kernels (two consumer warpgroups and a producer warpgroup) and its
// tiling per head dim, the swizzled tile geometry that TMA writes and wgmma
// reads, mbarrier and TMA helpers, the 4-D tensor-map encoder over strided
// [B, T, H, D] views (taken from libcuda at run time), wgmma descriptors and
// instructions for bf16 and f16 operands (one layout, another type in the
// instruction), setmaxnreg, the accumulator fragment layout, the softmax's
// exp2, the quad transpose of the 16-byte output stores, and the block order
// that keeps a few heads' K/V in L2.
// ops/_build.py keys each library on its .cu and on every csrc/*.cuh, so an
// edit here rebuilds every kernel.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

constexpr int WG = 128;                       // threads of a warpgroup
constexpr int CONSUMERS = 2;                  // consumer warpgroups
constexpr int THREADS90 = (CONSUMERS + 1) * WG;
constexpr int ROWS = 64;                      // rows of a warpgroup and of a streamed tile
constexpr int BLOCK_ROWS = CONSUMERS * ROWS;  // the block's own rows
constexpr float LOG2E = 1.4426950408889634f;
// registers a thread after setmaxnreg: what the producer gives up, the two
// consumer warpgroups take (168 a thread at launch from __launch_bounds__)
constexpr int LAUNCH_REGS = 168;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert((LAUNCH_REGS - PRODUCER_REGS) == CONSUMERS * (CONSUMER_REGS - LAUNCH_REGS),
              "setmaxnreg must balance");

// Shared-memory geometry of one head dim. A tile of R rows x D 16-bit values is
// NCB column boxes of R rows, each row SWB bytes (CHUNK elements), in the
// hardware's SWB-byte swizzle: box (c, rb) holds rows [64 rb, 64 rb + 64) of
// columns [CHUNK c, CHUNK c + CHUNK) at byte (c * R / 64 + rb) * BOX.
template <int D> struct Geo {
  static constexpr int SWB = D >= 64 ? 128 : 64;
  static constexpr int CHUNK = SWB / 2;
  static constexpr int NCB = D / CHUNK;
  static constexpr uint64_t LAYOUT = SWB == 128 ? 1 : 2;   // wgmma descriptor swizzle mode
  static constexpr int BOX = ROWS * SWB;
  static constexpr int TILE64 = NCB * BOX;
  static constexpr int TILE128 = 2 * TILE64;
  static_assert(D % CHUNK == 0 && (CHUNK == 32 || CHUNK == 64), "D in 32/64/128/256");
};

// Tiling that depends on the head dim. Up to D = 128: rings of three slots,
// the forward's 128-key tiles, 128 own rows a block (64 a consumer
// warpgroup). At D = 256 the [64, 256] f32 output accumulator takes 128
// registers a thread and a 64-row tile 32 KB, so: the forward streams 64-key
// tiles (scores and P fragments fit beside O) through two slots; the
// backward kernels give a block 64 own rows that both consumer warpgroups
// share (SPLIT), each computing the same scores and accumulating half of
// D's output columns, with two slots.
template <int D> struct Cfg {
  static constexpr bool SPLIT = D == 256;
  static constexpr int STAGES = D == 256 ? 2 : 3;        // slots of the streamed ring
  static constexpr int FWD_KEYS = D == 256 ? 64 : 128;   // keys of a forward K/V tile
  static constexpr int OWN = SPLIT ? ROWS : BLOCK_ROWS;  // a backward block's own rows
  static constexpr int NC = SPLIT ? Geo<D>::NCB / 2 : Geo<D>::NCB;   // output boxes a warpgroup sums
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t addr, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of parity `parity` of barrier `b` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  while (!bar_try(a, parity)) {
  }
}

// One TMA box of a [B, T, H, D] map: columns [d, d + CHUNK), rows [t, t + 64)
// of (b, h), into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                        int d, int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d), "r"(h), "r"(t), "r"(b)
      : "memory");
}

// One TMA box of a 2-D map: columns [x, x + box width), rows [y, y + box
// height), into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_box2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                          int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// Rows [t0, t0 + R) of (b, h) into the R-row tile at `dst`.
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                         int h, int t0, int b) {
  using G = Geo<D>;
#pragma unroll
  for (int c = 0; c < G::NCB; ++c)
#pragma unroll
    for (int rb = 0; rb < R / ROWS; ++rb)
      tma_box(dst + (c * (R / ROWS) + rb) * G::BOX, map, bar, c * G::CHUNK, h,
              t0 + rb * ROWS, b);
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand (rows = M or N, D along K): the M or N rows from row r0 of
// an R-row tile, k-step kk (columns [16 kk, 16 kk + 16)). Inside a swizzle row
// the k-step moves the start address by 32 bytes; the hardware applies the
// swizzle to the address it forms, as TMA did when it wrote the box.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  using G = Geo<D>;
  const int col = kk * 16;
  const uint32_t a =
      tile + (col / G::CHUNK) * R * G::SWB + r0 * G::SWB + (col % G::CHUNK) * 2;
  return make_desc(a, 16, 8 * G::SWB, G::LAYOUT);
}

// MN-major operand (tile rows along K, D along N): rows [16 kk, 16 kk + 16)
// of an R-row tile and column box c, one swizzle atom wide (CHUNK columns).
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int c, int kk) {
  using G = Geo<D>;
  const uint32_t a = tile + c * R * G::SWB + kk * 16 * G::SWB;
  return make_desc(a, R * G::SWB, 8 * G::SWB, G::LAYOUT);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The thread's warpgroup, broadcast from lane 0 so that the compiler sees
// it uniform across the warp: the role branch below must not diverge inside a
// warp for setmaxnreg to apply.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / WG, 0);
}

// Two floats rounded to the operand type, as one 32-bit register (lo in the
// low half): an A fragment pair of wgmma, or two output columns.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, bf16>::value) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

#define WGMMA_0(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(accumulate))

// D[64, 64] (+)= A[64, 16] . B[64, 16]^T, both K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    WGMMA_0("bf16");
  } else {
    WGMMA_0("f16");
  }
}

#define WGMMA_TT(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(accumulate))

// D[64, 64] (+)= A[64, 16] . B[16, 64], both MN-major in shared memory (A
// stored [K][M], B stored [K][N]: tiles whose rows run along K)
template <typename T>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    WGMMA_TT("bf16");
  } else {
    WGMMA_TT("f16");
  }
}

#define WGMMA_1(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(a), "l"(b), "r"(accumulate))

// D[64, 32] (+)= A[64, 16] . B[32, 16]^T, both K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    WGMMA_1("bf16");
  } else {
    WGMMA_1("f16");
  }
}

#define WGMMA_2(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// D[64, 64] += A[64, 16] . B[16, 64]: A in registers (bf16 pairs), B MN-major
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (std::is_same<T, bf16>::value) {
    WGMMA_2("bf16");
  } else {
    WGMMA_2("f16");
  }
}

#define WGMMA_3(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15" \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// D[64, 32] += A[64, 16] . B[16, 32]: A in registers (bf16 pairs), B MN-major
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (std::is_same<T, bf16>::value) {
    WGMMA_3("bf16");
  } else {
    WGMMA_3("f16");
  }
}

#define WGMMA_4(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(a), "l"(b), "r"(accumulate))

// D[64, 128] (+)= A[64, 16] . B[128, 16]^T, both K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    WGMMA_4("bf16");
  } else {
    WGMMA_4("f16");
  }
}

// acc[64, CHUNK NC] += A[64, 16 KS] . B[16 KS, column boxes c0 .. c0 + NC):
// A the 16-bit fragments of KS k-steps in registers, B rows [16 kk0,
// 16 (kk0 + KS)) of an R-row tile read MN-major (its rows along K).
template <typename T, int D, int KS, int R = ROWS, int NC = Geo<D>::NCB>
__device__ __forceinline__ void accumulate(float (&acc)[NC][Geo<D>::CHUNK / 2],
                                           const uint32_t (&a)[KS][4], uint32_t b_tile,
                                           int kk0, int c0 = 0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_rs<T>(acc[c], a[kk], desc_mn<D, R>(b_tile, c0 + c, kk0 + kk));
}

// Accumulator layout of m64nN (f32): entry i of thread (warp w, lane l)
// holds row 16 w + l / 4 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * (l % 4)
// + (i & 1). Entries 8 kk .. 8 kk + 7 as bf16 pairs are the A fragment of
// k-step kk of the next product.
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// 2^x on the MUFU.EX2 unit alone (ex2.approx.ftz: ~2 ulp, results below
// 2^-126 flush to 0); exp2f wraps it in range handling for subnormal
// results, three more instructions an element of the softmax.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A 4x4 transpose of 32-bit words inside a quad of lanes, by shuffles: lane
// q holds in[r] = M[q][r] and gets back M[0..3][q]. In round i, lane s sends
// in[(s - i) & 3] and lane q takes it from lane (q + i) & 3.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&in)[4], int lane) {
  const int q = lane & 3;
  uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int send = (q - i) & 3;
    uint32_t v = in[0];
#pragma unroll
    for (int r = 1; r < 4; ++r) v = send == r ? in[r] : v;
    const int src = (q + i) & 3;
    const uint32_t got = __shfl_sync(0xffffffffu, v, src, 4);
#pragma unroll
    for (int r = 0; r < 4; ++r) out[r] = src == r ? got : out[r];
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// (batch, head) pairs whose blocks are numbered together: their K and V (1
// MB a pair at T=2048, D=128 bf16) stay in L2 while their blocks run
constexpr int HEAD_GROUP = 8;
// The (batch*head, query block) of block i: groups of HEAD_GROUP
// (batch, head) pairs one after the other, inside a group the query block
// outermost (under a causal mask the last, longest, first).
__device__ __forceinline__ void block_coords(int i, int BH, int n_qb, int causal, int& bh,
                                             int& qb) {
  const int group = i / (HEAD_GROUP * n_qb);
  const int bh0 = group * HEAD_GROUP;
  const int size = min(HEAD_GROUP, BH - bh0);   // the last group may be short
  const int r = i - bh0 * n_qb;
  bh = bh0 + r % size;
  qb = causal ? n_qb - 1 - r / size : r / size;
}

// Dynamic shared memory rounded up to the 1024-byte alignment the 128-byte
// swizzle needs.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// Negative return codes of the C interface (cudaError_t codes are positive).
constexpr int ERR_UNSUPPORTED = -1;   // dtype or head dim
constexpr int ERR_NO_ENCODER = -2;    // cuTensorMapEncodeTiled not found in libcuda
constexpr int ERR_TENSOR_MAP = -3;    // libcuda refused a tensor map

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, from the libcuda the process has loaded
// (the library links only the CUDA runtime).
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A 4-D map over a 16-bit (E: bf16 or f16) [B, T, H, D] view with element
// strides (sb, st, sh) and a contiguous head dim: boxes of CHUNK columns x 64
// rows of one (b, h), swizzled as Geo<D> says; reads past T fill zeros.
template <typename E, int D>
int encode_map(CUtensorMap* map, const void* ptr, int B, int T, int H, long long sb,
               long long st, long long sh) {
  using G = Geo<D>;
  EncodeTiledFn enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(T), cuuint64_t(B)};
  long long el[4] = {1, sh, st, sb};
  // a dim of size 1 is never stepped over; give it the packed stride
  for (int i = 1; i < 4; ++i)
    if (dims[i] == 1) el[i] = el[i - 1] * (long long)dims[i - 1];
  const cuuint64_t strides[3] = {cuuint64_t(el[1] * 2), cuuint64_t(el[2] * 2),
                                 cuuint64_t(el[3] * 2)};
  const cuuint32_t box[4] = {cuuint32_t(G::CHUNK), 1, cuuint32_t(ROWS), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = std::is_same<E, bf16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r = enc(map, type, 4, const_cast<void*>(ptr),
                         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         G::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// A 2-D map over a row-major 16-bit (E: bf16 or f16) [rows, cols] matrix:
// boxes of 64 columns x 64 rows in the 128-byte swizzle (the layout of a
// 64-row tile of Geo<64>); reads past the last row fill zeros.
template <typename E>
int encode_rows(CUtensorMap* map, const void* ptr, long long rows, long long cols) {
  EncodeTiledFn enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols * 2)};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapDataType type = std::is_same<E, bf16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r = enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

}  // namespace
