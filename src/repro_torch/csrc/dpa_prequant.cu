// dpa_matmul_prequant for Hopper (sm_90a): pre-quantized activations times
// pre-quantized weights, both packed E2M1 along K, f32 accumulation; dense,
// or one product per expert of a MoE layer.
//
// Replaces the Pallas TPU kernels repro/kernels/dpa_matmul.py
// dpa_matmul_prequant (_dpa_matmul_kernel) and
// repro/kernels/dpa_grouped_matmul.py dpa_grouped_matmul_prequant
// (_grouped_prequant_kernel), which is the same contract per expert.
//
// Contract, per expert e, row m and column n:
//   acc = sum_k e2m1(xq[m, k]) * e2m1(wq[k, n])      (f32)
//   out = (acc * sx[m]) * sw[n]                        (two rounded products)
// Codes are packed two per byte along K (low nibble = even k).  Every
// E2M1 x E2M1 product is a multiple of 1/4 with |p| <= 36, so any partial
// sum over K < 2^16 is an integer number of quarters below 2^24: exact in
// f32 in every order.  The kernel, its plain version and the JAX
// reference therefore agree bit for bit.
//
// What bounds it: at the serving shapes (2 to 16 rows per expert) each
// packed weight byte feeds only 2 * M products, so the floor is the weight
// bytes over 3.35 TB/s (2.5 us for one 32-expert 1024 x 512 matrix of
// granite-moe-1b, 8 MB of codes).
//
// Design: the fused kernel's layout without its per-block scale folding.
// One block owns a 32-column slice of the output for up to 16 rows of one
// expert (grid z); per K block of 128 the block decodes its rows' x codes
// into shared memory, and the eight warps split the block's 128 k values
// 16 apiece, each lane streaming its column's weight bytes (a warp reads
// 32 consecutive bytes per k row pair).  The eight partial sums meet in
// shared memory once, at the end, where the row and column scales apply.
// Rows >= M are masked: never read, never written.
#include "dpa_common.cuh"

namespace {

constexpr int kBK = 128;      // k values staged per step
constexpr int kBN = 32;       // output columns per block (one per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKPerWarp = kBK / kWarps;   // 16: 8 packed bytes per lane

template <int MT>
__global__ void __launch_bounds__(kThreads)
dpa_prequant_kernel(const uint8_t* __restrict__ xq,
                    const float* __restrict__ sx,
                    const uint8_t* __restrict__ wq,
                    const float* __restrict__ sw, float* __restrict__ out,
                    int M, int K, int N) {
  __shared__ float xs[MT][kBK];
  __shared__ float red[kWarps][MT][kBN];
  constexpr int kOut = MT * kBN / kThreads;   // outputs each thread owns
  const int kb = K / 2;                       // packed bytes along K

  // this block's expert (0 for a dense product)
  const size_t e = blockIdx.z;
  xq += e * M * kb;
  sx += e * M;
  wq += e * kb * N;
  sw += e * N;
  out += e * M * N;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * MT;
  const int col = n0 + lane;
  const int kw = warp * kKPerWarp;
  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // the block's x codes, decoded into shared memory (masked rows -> 0)
    for (int i = threadIdx.x; i < MT * (kBK / 2); i += kThreads) {
      const int r = i / (kBK / 2), b = i % (kBK / 2);
      const int m = m0 + r;
      const uint32_t byte = m < M ? xq[(size_t)m * kb + k0 / 2 + b] : 0u;
      xs[r][2 * b] = dpa::decode_fp4(byte & 15u);
      xs[r][2 * b + 1] = dpa::decode_fp4(byte >> 4);
    }
    __syncthreads();

    // this warp's 16 k values of the block, one column per lane
    const uint8_t* wp = wq + (size_t)((k0 + kw) >> 1) * N + col;
#pragma unroll
    for (int j = 0; j < kKPerWarp / 2; ++j) {
      const uint32_t wb = __ldg(wp + (size_t)j * N);
      const float wlo = dpa::decode_fp4(wb & 15u);
      const float whi = dpa::decode_fp4(wb >> 4);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        acc[r] = fmaf(xs[r][kw + 2 * j], wlo, acc[r]);
        acc[r] = fmaf(xs[r][kw + 2 * j + 1], whi, acc[r]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < MT; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();

  // epilogue: the warps' exact partial sums, then row x column scales
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int idx = threadIdx.x + o * kThreads;
    const int r = idx / kBN, c = idx % kBN;
    const int m = m0 + r, n = n0 + c;
    float p = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) p += red[w][r][c];
    if (m < M) out[(size_t)m * N + n] = __fmul_rn(__fmul_rn(p, sx[m]), sw[n]);
  }
}

}  // namespace

// xq: (E, M, K/2) packed E2M1; sx: (E, M) f32 row scales.
// wq: (E, K/2, N) packed E2M1; sw: (E, N) f32 column scales.
// out: (E, M, N) f32.  A dense product is E = 1.
// Requires K % 128 == 0 and N % 32 == 0 (the wrapper checks and pads).
extern "C" int dpa_prequant_launch(const void* xq, const float* sx,
                                   const void* wq, const float* sw,
                                   float* out, int E, int M, int K, int N,
                                   void* stream) {
  if (K % kBK || N % kBN || M <= 0 || E <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x8 = static_cast<const uint8_t*>(xq);
  const uint8_t* w8 = static_cast<const uint8_t*>(wq);
  if (M <= 8) {
    dim3 grid(N / kBN, 1, E);
    dpa_prequant_kernel<8><<<grid, kThreads, 0, s>>>(x8, sx, w8, sw, out, M,
                                                     K, N);
  } else {
    dim3 grid(N / kBN, (M + 15) / 16, E);
    dpa_prequant_kernel<16><<<grid, kThreads, 0, s>>>(x8, sx, w8, sw, out,
                                                      M, K, N);
  }
  return (int)cudaGetLastError();
}
