// dpa_matmul_fused at large M for Hopper (sm_90a): the same contract as
// dpa_matmul.cu, in two kernels — a one-pass activation quantizer, then a
// tiled product on the fp16 tensor cores.
//
// Replaces, for M at or above the launch plan's threshold
// (kernels/dpa_matmul.py fused_plan), the Pallas TPU kernels
// repro/kernels/dpa_matmul.py dpa_matmul_fused (_dpa_fused_kernel and its
// prologue _quantize_block; src/repro/kernels/dpa_matmul.py:184 / :212)
// and repro/kernels/dpa_grouped_matmul.py dpa_grouped_matmul_fused, which
// is the same contract per expert.  Below the threshold (the engines'
// decode steps and prefill chunks) the plan keeps dpa_matmul.cu.
//
// Contract, per K block of 128 and per row m:
//   scale = max(max(amax, 1e-30) * f32(1/448), 2^-126)
//   q     = e4m3_rne_satfinite(clip(x / scale, +-448))     (IEEE division)
//   part  = sum_k q * w          in a fresh f32 accumulator
//   acc  += part * scale         (multiply rounded, then add: no FMA)
// and out = acc * sw[n].
//
// What bounds it: operations.  At path D's M = 4096 one qwen3-4b layer is
// 8.27e11 operations, 0.42 ms at the fp8 peak and 0.84 ms at the fp16
// peak, against 0.02-0.05 ms for its bytes.  dpa_matmul.cu quantizes x
// again in every block of a column tile and re-reads the weights for
// every 32 rows: right where the weight bytes bound a call, not here.
//
// Stage one, act_quant_kernel: x (E, M, K) f32/bf16 -> E4M3 codes (E, M,
// K) uint8 and scales (E, M, K/128) f32, one warp per (row, K block),
// 16-byte (f32) or 8-byte (bf16) loads: each element is quantized once.
// Bytes-bound (about 3 bytes per element of x).
//
// Stage two, fused_tiled_kernel: mma.sync m16n8k16 with fp16 operands
// and f32 accumulation.  fp16 is exact for every operand value here:
// every E4M3 value (4 significant bits, 2^-9 .. 448) and every E2M1 value
// is an fp16 value, and a product of two of them is exact in f32, so each
// block's `part` differs from the plain version's only in the order of
// its f32 sums.  The e4m3 tensor cores would run at twice the rate but
// keep only about 14 bits in their accumulation on Hopper (DeepSeek-V3,
// arXiv 2412.19437, 3.3.2), which costs about half of the 2e-4 pin.
//   A block owns a 128 x 128 output tile of one expert (grid z) and walks
// K in blocks of 128 through a 3-stage cp.async ring (x codes 128 x 128
// B, packed weights 64 x 128 B or E4M3 weights 128 x 128 B, and the 128
// rows' scales).  Eight warps of 64 rows x 32 columns run 8 k16 steps per
// K block into fresh f32 fragments, then fold each fragment row into the
// running accumulator in registers with that row's scale: no shared-
// memory reduction and no barrier beyond the ring's.
//   Fragments are read straight from the stored layouts.  Inside a k16
// step the MMA's k slots are a permutation of the 16 physical k (the sum
// does not care, as long as both operands agree): a thread's slots 2t,
// 2t+1 and 2t+8, 2t+9 hold physical k 4t .. 4t+3.  So one ldmatrix.x4
// gives each thread four adjacent E4M3 codes of a row per step (two
// cvt.rn.f16x2.e4m3x2), and on the weight side those four k are one
// packed byte in each of packed rows 2t and 2t+1.  The MMA's 8 columns of
// n-tile j are the warp's physical columns 4g + j, so one 32-bit load at
// column 4g serves all four n-tiles; a packed byte becomes an f16x2 by
// two byte-permutes from an 8-entry magnitude table plus the sign bits.
// The row pitch (144 B) puts every fragment load of a warp on distinct
// banks (2-way on the E4M3-weight loads).  The conversions, cp.async and
// the MMA are dpa_mma.cuh's, shared with dpa_matmul.cu.
//   Rows at or past M and columns at or past N (N % 32 == 0) are
// zero-filled and never stored.
//   Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): 3.9 ms per
// qwen3-4b layer at M = 4096, pre-pass included, 21 % of the fp16 peak.
// tools/fused_tiled_ablation.py finds most of it outside the MMAs and the
// conversions (the ring, the fragment loads, the fold, one block of 8
// warps per SM); smaller warp tiles with more warps were slower.  wgmma
// and TMA (operands from shared memory, asynchronous, a producer warp) are
// the next step.
#include "dpa_common.cuh"
#include "dpa_mma.cuh"

namespace {

constexpr int kBK = 128;            // K block: part of the contract
constexpr int kBM = 128;            // output rows per block
constexpr int kBN = 128;            // output columns per block
constexpr int kMT = 4;              // m16 tiles per warp (2 and 1: slower)
constexpr int kWarpRows = kMT * 16;
constexpr int kWarps = kBM / kWarpRows * 4;   // 4 warps of 32 columns a row
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kPitch = kBK + 16;    // shared row pitch, bytes
constexpr int kQuantWarps = 8;      // (row, K block) pairs per quant block

// One ring stage: x codes (kBM rows), weights (kWRows rows), row scales.
template <int WFMT>
struct Stage {
  static constexpr int kWRows = WFMT == dpa::kFmtFp4Packed ? kBK / 2 : kBK;
  static constexpr int kW = kBM * kPitch;
  static constexpr int kS = kW + kWRows * kPitch;
  static constexpr int kBytes = kS + kBM * 4;
};

// Stage one: warp b quantizes K block (b % nkb) of row (b / nkb); its
// scale lands at scales[b], which is the (rows, K / 128) layout.
template <typename XT>
__global__ void __launch_bounds__(kQuantWarps * 32)
act_quant_kernel(const XT* __restrict__ x, uint8_t* __restrict__ codes,
                 float* __restrict__ scales, long long blocks, int K) {
  const long long b =
      (long long)blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  if (b >= blocks) return;                   // the whole warp leaves
  const int lane = threadIdx.x & 31, nkb = K / kBK;
  const size_t off = (size_t)(b / nkb) * K + (b % nkb) * kBK + lane * 4;
  float v[4];
  dpa::load4(x + off, v);
  const float a = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                        fmaxf(fabsf(v[2]), fabsf(v[3])));
  const float s = dpa::e4m3_scale(dpa::warp_max(a));
  uint32_t q = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q |= static_cast<uint32_t>(
             __nv_fp8_e4m3(dpa::quantize_e4m3(v[i], s)).__x)
         << (8 * i);
  *reinterpret_cast<uint32_t*>(codes + off) = q;
  if (lane == 0) scales[b] = s;
}

// Stage two.  Grid (ceil(N / 128), ceil(M / 128), E); warp (wm, wn) owns
// rows wm * kWarpRows .. + kWarpRows - 1 and columns wn * 32 .. +31 of the
// block's tile.
template <int WFMT>
__global__ void __launch_bounds__(kThreads, 1)
fused_tiled_kernel(const uint8_t* __restrict__ xq,
                   const float* __restrict__ xs,
                   const uint8_t* __restrict__ wq,
                   const float* __restrict__ sw, float* __restrict__ out,
                   int M, int K, int N) {
  using S = Stage<WFMT>;
  constexpr bool kFp4 = WFMT == dpa::kFmtFp4Packed;
  extern __shared__ __align__(16) uint8_t smem[];
  const int nkb = K / kBK;
  const size_t e = blockIdx.z;
  xq += e * M * K;
  xs += e * M * nkb;
  wq += e * (kFp4 ? K / 2 : K) * N;
  sw += e * N;
  out += e * M * N;

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  // K block c -> ring slot c % kStages; always one commit group
  auto fetch = [&](int c) {
    if (c < nkb) {
      uint8_t* st = smem + (c % kStages) * S::kBytes;
      const int k0 = c * kBK;
      for (int i = tid; i < kBM * 8; i += kThreads) {
        const int r = i >> 3, v = i & 7;
        const bool live = m0 + r < M;
        dpa::cp_async16(st + r * kPitch + v * 16,
                   live ? xq + (size_t)(m0 + r) * K + k0 + v * 16 : xq,
                   live ? 16 : 0);
      }
      const int kr0 = kFp4 ? k0 / 2 : k0;
      for (int i = tid; i < S::kWRows * 8; i += kThreads) {
        const int r = i >> 3, v = i & 7;
        const bool live = n0 + v * 16 < N;
        dpa::cp_async16(st + S::kW + r * kPitch + v * 16,
                   live ? wq + (size_t)(kr0 + r) * N + n0 + v * 16 : wq,
                   live ? 16 : 0);
      }
      if (tid < kBM) {
        const bool live = m0 + tid < M;
        dpa::cp_async4(st + S::kS + tid * 4,
                  live ? xs + (size_t)(m0 + tid) * nkb + c : xs,
                  live ? 4 : 0);
      }
    }
    dpa::cp_async_commit();
  };

  float acc[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  // ldmatrix: lanes 8j .. 8j+7 address matrix j = rows + (j & 1) * 8,
  // bytes + (j >> 1) * 16 of an m-tile's 16 x 32 B k32 slice
  const uint32_t a_off =
      (wm * kWarpRows + ((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch +
      (lane >> 4) * 16;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) fetch(c);
  for (int c = 0; c < nkb; ++c) {
    dpa::cp_async_wait<kStages - 2>();  // block c has landed (this thread's)
    __syncthreads();               // ... everyone's; block c - 1 is read
    fetch(c + kStages - 1);        // into block c - 1's slot

    const uint8_t* st = smem + (c % kStages) * S::kBytes;
    const uint32_t a_base = dpa::smem_u32(st) + a_off;
    const uint8_t* w_base = st + S::kW + wn * 32 + 4 * g;
    float part[kMT][4][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.0f;

#pragma unroll
    for (int q = 0; q < kBK / 32; ++q) {
      // x codes of k32 slice q: a[mt][2h] row g, a[mt][2h+1] row g + 8 of
      // k16 step 2q + h, physical k 4t .. 4t+3 each
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        dpa::ldmatrix_x4(a[mt], a_base + mt * 16 * kPitch + q * 32);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = 2 * q + h;
        uint32_t b0[4], b1[4];   // n-tile j: column 4g + j
        if constexpr (kFp4) {
          const uint8_t* wr = w_base + (8 * s + 2 * t) * kPitch;
          dpa::fp4x8_to_f16x2(dpa::lds32(wr), b0);            // k 4t, 4t+1
          dpa::fp4x8_to_f16x2(dpa::lds32(wr + kPitch), b1);   // k 4t+2, 4t+3
        } else {
          const uint8_t* wr = w_base + (16 * s + 4 * t) * kPitch;
          dpa::e4m3x16_to_f16x2(dpa::lds32(wr), dpa::lds32(wr + kPitch),
                                dpa::lds32(wr + 2 * kPitch),
                                dpa::lds32(wr + 3 * kPitch), b0, b1);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const uint32_t lo = a[mt][2 * h], hi = a[mt][2 * h + 1];
          const uint32_t a0 = dpa::e4m3x2_to_f16x2(lo);
          const uint32_t a1 = dpa::e4m3x2_to_f16x2(hi);
          const uint32_t a2 = dpa::e4m3x2_to_f16x2(lo >> 16);
          const uint32_t a3 = dpa::e4m3x2_to_f16x2(hi >> 16);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            dpa::mma_f16(part[mt][nt], a0, a1, a2, a3, b0[nt], b1[nt]);
        }
      }
    }

    // fold: acc = acc + part * scale, per row (c0, c1 row g; c2, c3 g + 8)
    const float* sc = reinterpret_cast<const float*>(st + S::kS) + wm * kWarpRows;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float s0 = sc[mt * 16 + g], s1 = sc[mt * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float(&p)[4] = part[mt][nt];
        float(&r)[4] = acc[mt][nt];
        r[0] = __fadd_rn(r[0], __fmul_rn(p[0], s0));
        r[1] = __fadd_rn(r[1], __fmul_rn(p[1], s0));
        r[2] = __fadd_rn(r[2], __fmul_rn(p[2], s1));
        r[3] = __fadd_rn(r[3], __fmul_rn(p[3], s1));
      }
    }
  }
  dpa::cp_async_wait<0>();

  // epilogue: c0 of n-tile j is column 8t + j, c1 column 8t + 4 + j, so a
  // thread's outputs of a row are 8 adjacent columns: two 16-byte stores
  const int col = n0 + wn * 32 + 8 * t;
  if (col >= N) return;                  // N % 32 == 0: the warp's columns
  const float4 slo = *reinterpret_cast<const float4*>(sw + col);
  const float4 shi = *reinterpret_cast<const float4*>(sw + col + 4);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * kWarpRows + mt * 16 + g + 8 * h;
      if (m >= M) continue;
      float* o = out + (size_t)m * N + col;
      *reinterpret_cast<float4*>(o) = make_float4(
          __fmul_rn(acc[mt][0][2 * h], slo.x),
          __fmul_rn(acc[mt][1][2 * h], slo.y),
          __fmul_rn(acc[mt][2][2 * h], slo.z),
          __fmul_rn(acc[mt][3][2 * h], slo.w));
      *reinterpret_cast<float4*>(o + 4) = make_float4(
          __fmul_rn(acc[mt][0][2 * h + 1], shi.x),
          __fmul_rn(acc[mt][1][2 * h + 1], shi.y),
          __fmul_rn(acc[mt][2][2 * h + 1], shi.z),
          __fmul_rn(acc[mt][3][2 * h + 1], shi.w));
    }
}

template <int WFMT>
int launch_tiled(const uint8_t* xq, const float* xs, const uint8_t* wq,
                 const float* sw, float* out, int E, int M, int K, int N,
                 cudaStream_t s) {
  constexpr int smem = kStages * Stage<WFMT>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_tiled_kernel<WFMT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
  fused_tiled_kernel<WFMT><<<grid, kThreads, smem, s>>>(xq, xs, wq, sw, out,
                                                        M, K, N);
  return (int)cudaGetLastError();
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace

// x: (rows, K) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), contiguous, 16-byte
// aligned; codes: (rows, K) uint8 E4M3; scales: (rows, K / 128) f32.
// Requires K % 128 == 0.
extern "C" int dpa_act_quant_launch(const void* x, int x_bf16, void* codes,
                                    float* scales, int rows, int K,
                                    void* stream) {
  if (rows <= 0 || K <= 0 || K % kBK || misaligned(x) || misaligned(codes))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)rows * (K / kBK);
  const unsigned grid =
      static_cast<unsigned>((blocks + kQuantWarps - 1) / kQuantWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    act_quant_kernel<__nv_bfloat16><<<grid, kQuantWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<uint8_t*>(codes),
        scales, blocks, K);
  else
    act_quant_kernel<float><<<grid, kQuantWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<uint8_t*>(codes), scales,
        blocks, K);
  return (int)cudaGetLastError();
}

// xq: (E, M, K) E4M3 codes and xs: (E, M, K / 128) f32 scales from
// dpa_act_quant_launch; wq: (E, K/2, N) packed E2M1 (w_fmt 0) or (E, K, N)
// E4M3 (w_fmt 1); sw: (E, 1, N) f32; out: (E, M, N) f32; each contiguous
// and 16-byte aligned.  Requires K % 128 == 0 and N % 32 == 0.
extern "C" int dpa_fused_tiled_launch(const void* xq, const float* xs,
                                      const void* wq, int w_fmt,
                                      const float* sw, float* out, int E,
                                      int M, int K, int N, void* stream) {
  if (K <= 0 || K % kBK || N <= 0 || N % 32 || M <= 0 || E <= 0 ||
      E > 65535 || (w_fmt != dpa::kFmtFp4Packed && w_fmt != dpa::kFmtE4M3) ||
      misaligned(xq) || misaligned(wq) || misaligned(sw) || misaligned(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x8 = static_cast<const uint8_t*>(xq);
  const uint8_t* w8 = static_cast<const uint8_t*>(wq);
  return w_fmt == dpa::kFmtFp4Packed
             ? launch_tiled<dpa::kFmtFp4Packed>(x8, xs, w8, sw, out, E, M, K,
                                                N, s)
             : launch_tiled<dpa::kFmtE4M3>(x8, xs, w8, sw, out, E, M, K, N,
                                           s);
}
