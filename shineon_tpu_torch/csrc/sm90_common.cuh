// Device helpers shared by the hand-written Hopper (sm_90a) kernels of this
// directory: mma.sync, wgmma, cp.async, bulk-copy and mbarrier wrappers,
// two-element loads and stores, and the symmetric-int8 quantizer both int8
// kernels use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same four 8x8 matrices, each transposed: lane 4g + t receives rows
// 2t and 2t+1 of column g (a B operand from a row-major k x n tile).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes, or 16 zero bytes where !valid (src is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// ---------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// This thread's arrival on a barrier of this CTA.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// This thread's arrival on a barrier of this CTA that also expects `bytes`
// of bulk copies before its phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Spin until the phase of parity `parity` has completed. A wait that
// outlasts 2^28 tries (seconds) traps, so a broken pipeline ends the launch
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// Makes initialised barriers visible to the bulk-copy unit; a block-wide
// barrier must follow before any thread uses them.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Give back (dec) or claim (inc) registers for this warpgroup: every thread
// of its warps, converged; N a multiple of 8 in [24, 256].
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// Named barrier `id` over `count` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Bulk copy (no tensor map) of `bytes` from global memory into this CTA's
// shared memory at `dst`, completing its bytes on the barrier `bar`. bytes:
// a multiple of 16; dst and src 16-byte aligned.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ------------------------------------------------------------------ wgmma
// Shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// rows of 128 bytes (64 bf16 or 128 int8 of K), 8-row groups 1024 bytes
// apart, the buffer 1024-byte aligned. A step along K within the 128 bytes
// adds its byte offset to the start address.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of a register across the
// asynchronous products (an accumulator) or reusing it while they run (an
// A fragment).
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (sizeof(T) == 4 && std::is_floating_point<T>::value)
      asm volatile("" : "+f"(r[i])::"memory");
    else
      asm volatile("" : "+r"(r[i])::"memory");
  }
}

#define WGMMA_D16(i)                                                                       \
  "+" WGMMA_C(d[i + 0]), "+" WGMMA_C(d[i + 1]), "+" WGMMA_C(d[i + 2]), "+" WGMMA_C(d[i + 3]), \
      "+" WGMMA_C(d[i + 4]), "+" WGMMA_C(d[i + 5]), "+" WGMMA_C(d[i + 6]),                  \
      "+" WGMMA_C(d[i + 7]), "+" WGMMA_C(d[i + 8]), "+" WGMMA_C(d[i + 9]),                  \
      "+" WGMMA_C(d[i + 10]), "+" WGMMA_C(d[i + 11]), "+" WGMMA_C(d[i + 12]),               \
      "+" WGMMA_C(d[i + 13]), "+" WGMMA_C(d[i + 14]), "+" WGMMA_C(d[i + 15])
#define WGMMA_OUT64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "       \
  "{%64, %65, %66, %67}, %68, p"

// D(64x128, f32) += A(64x16 bf16, registers: this warp's 16 rows as for
// mma.sync m16n8k16) * B(16x128 bf16, shared memory, K-major, descriptor).
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                         uint64_t desc_b) {
#define WGMMA_C(x) "f"(x)
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_OUT64 ", 1, 1, 0;\n}\n"
      : WGMMA_D16(0), WGMMA_D16(16), WGMMA_D16(32), WGMMA_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
#undef WGMMA_C
}

// D(64x128, s32) += A(64x32 s8, registers as for mma.sync m16n8k32) *
// B(32x128 s8, shared memory, K-major, descriptor).
__device__ __forceinline__ void wgmma_m64n128k32_s8_rs(int (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
#define WGMMA_C(x) "r"(x)
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WGMMA_OUT64 ";\n}\n"
      : WGMMA_D16(0), WGMMA_D16(16), WGMMA_D16(32), WGMMA_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
#undef WGMMA_C
}
#define WGMMA_OUT32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "       \
  "{%32, %33, %34, %35}, %36, p"

// D(64x64, s32) += A(64x32 s8, registers) * B(32x64 s8, shared memory,
// K-major, descriptor).
__device__ __forceinline__ void wgmma_m64n64k32_s8_rs(int (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
#define WGMMA_C(x) "r"(x)
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WGMMA_OUT32 ";\n}\n"
      : WGMMA_D16(0), WGMMA_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
#undef WGMMA_C
}

// The s8 product of width N = 64 or 128 (d holds N / 2 sums a thread).
template <int N>
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (N == 128)
    wgmma_m64n128k32_s8_rs(d, a, desc_b);
  else
    wgmma_m64n64k32_s8_rs(d, a, desc_b);
}
#undef WGMMA_D16
#undef WGMMA_OUT64
#undef WGMMA_OUT32

// Two consecutive values as f32, and back (8- or 4-byte aligned).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// clip(rint(v / s), -127, 127) with v / s an IEEE division, given r =
// __frcp_rn(s): v * r lies within a few ulps of v / s, so both round to the
// same integer unless v * r is within that of a half-integer; there (about
// one value in 10^4) the quotient is taken with __fdiv_rn. (Up to |y| = 128,
// beyond which both clip to +-127, those ulps are under 4e-5, so the test
// takes 1e-4.)
__device__ __forceinline__ int quant_level(float v, float s, float r) {
  const float y = v * r;
  float q = rintf(y);
  if (fabsf(fabsf(y - q) - 0.5f) < 1e-4f) q = rintf(__fdiv_rn(v, s));
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

// The per-tensor scale s = absmax / 127 + 1e-30, with an IEEE division.
__device__ __forceinline__ float int8_scale(float absmax) {
  return __fadd_rn(__fdiv_rn(absmax, 127.f), 1e-30f);
}

// acc * scale + bias, the dequantization of an int32 sum, never contracted.
__device__ __forceinline__ float dequant(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

}  // namespace
