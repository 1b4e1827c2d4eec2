// Device helpers shared by the tensor-core kernels (dpa_matmul.cu,
// dpa_fused_tiled.cu, dpa_flash.cu, flash_attention.cu) and the cp.async
// copies of paged_decode.cu:
// cp.async copies into shared memory, ldmatrix and the XOR swizzle of
// 16-byte chunks it reads, the exact conversions of E4M3 and packed E2M1
// codes to fp16 pairs, the fp16 and bf16 mma.sync with f32 accumulation,
// and the quad reductions over an accumulator fragment's row.
//
// Why fp16 operands are exact here: every E4M3 value (4 significant bits,
// 2^-9 .. 448) and every E2M1 value is an fp16 value, and a product of two
// of them is exact in f32 (tests/test_torch_fused_plan.py checks all of
// them), so an MMA's sum differs from a scalar f32 sum only in its order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dpa {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

// Index (in 16-bit elements) of chunk `ch` (8 elements) of row `row` of a
// tile with HD elements a row: the chunk XOR the row's low three bits, so
// the eight rows an ldmatrix reads at one chunk fall on eight different
// 16-byte bank groups.
template <int HD>
__device__ __forceinline__ int swz(int row, int ch) {
  return row * HD + ((ch ^ (row & 7)) << 3);
}

// Max and sum over the four lanes (a quad) that hold one row of an MMA
// accumulator fragment; every lane gets the same bits.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two E4M3 codes (low 16 bits; the lower code in the lower byte) -> f16x2
// (exact).
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t v) {
  uint32_t r;
  const unsigned short h = static_cast<unsigned short>(v & 0xFFFFu);
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(r) : "h"(h));
  return r;
}

// Four packed E2M1 bytes (byte j: low nibble even k, high nibble odd k)
// -> four f16x2 (exact), out[j] from byte j.  The magnitude (code & 7)
// picks the f16's high byte from an 8-entry table (0, 0.5, 1, 1.5, 2, 3,
// 4, 6); bit 3 of the code is the sign; the f16s' low bytes are 0.
__device__ __forceinline__ void fp4x8_to_f16x2(uint32_t w, uint32_t (&out)[4]) {
  constexpr uint32_t kLut0 = 0x3E3C3800u, kLut1 = 0x46444240u;
  const uint32_t mag = w & 0x77777777u;
  const uint32_t sgn = (w >> 3) & 0x11111111u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t hi = __byte_perm(kLut0, kLut1, mag >> (16 * h)) |
                        __byte_perm(0x8000u, 0u, sgn >> (16 * h));
    out[2 * h] = __byte_perm(hi, 0u, 0x1404u);
    out[2 * h + 1] = __byte_perm(hi, 0u, 0x3424u);
  }
}

// Four 32-bit words of E4M3 weights, rows k .. k+3 of four adjacent
// columns (byte j = column j) -> lo[j] = column j at k, k+1 and hi[j] =
// column j at k+2, k+3, as f16x2 (exact): the same pairs fp4x8_to_f16x2
// gives for the packed rows k/2 and k/2 + 1.
__device__ __forceinline__ void e4m3x16_to_f16x2(uint32_t r0, uint32_t r1,
                                                 uint32_t r2, uint32_t r3,
                                                 uint32_t (&lo)[4],
                                                 uint32_t (&hi)[4]) {
  const uint32_t p01 = __byte_perm(r0, r1, 0x5140u),
                 p23 = __byte_perm(r0, r1, 0x7362u);
  const uint32_t q01 = __byte_perm(r2, r3, 0x5140u),
                 q23 = __byte_perm(r2, r3, 0x7362u);
  lo[0] = e4m3x2_to_f16x2(p01), lo[1] = e4m3x2_to_f16x2(p01 >> 16);
  lo[2] = e4m3x2_to_f16x2(p23), lo[3] = e4m3x2_to_f16x2(p23 >> 16);
  hi[0] = e4m3x2_to_f16x2(q01), hi[1] = e4m3x2_to_f16x2(q01 >> 16);
  hi[2] = e4m3x2_to_f16x2(q23), hi[3] = e4m3x2_to_f16x2(q23 >> 16);
}

__device__ __forceinline__ void mma_f16(float (&c)[4], uint32_t a0,
                                        uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 operands, f32 accumulation: a product of two bf16 values (8
// significant bits each) is exact in f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace dpa
