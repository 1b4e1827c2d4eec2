// flash_attention for Hopper (sm_90a): blocked online-softmax f32 prefill
// attention, GQA, causal and sliding-window masks.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// flash_attention (_flash_kernel).  (The DPA kernel, dpa_flash_attention,
// is dpa_flash.cu.)
//
// Contract, per (batch x head, q block of bq rows), over the key blocks
// of bk keys in order:
//   q_s = q * scale;  s = q_s . k
//   masked entries (kpos > qpos when causal, kpos <= qpos - window) are
//   set to -1e30, with qpos = row + Sk - Sq;
//   m_cur = max(m, rowmax(s)), p = exp(s - m_cur), alpha = exp(m - m_cur)
//   l = l * alpha + rowsum(p),  acc = acc * alpha + p . v
//   out = acc / max(l, 1e-30), cast to q's dtype.
// Divisions are IEEE (__fdiv_rn), exp is expf (this file is never built
// with --use_fast_math), and each multiply-then-add of the state is two
// rounded operations, as in the reference.
//
// Skipped key blocks, exactly: a block wholly above the causal diagonal
// gives p = 0 and alpha = 1 for every row that has seen a live key, and
// every row's first live key (kpos = qpos when Sq <= Sk) lies in an
// earlier block, so it leaves m, l and acc as they were.  A block wholly
// before every row's window gives p = 1 under m = -1e30 and is then wiped
// by alpha = exp(-1e30 - m) = 0 at the first live block, so leaving it
// out gives the same bits.  With Sq > Sk some rows have no live key at
// all, and nothing is skipped.
//
// What bounds it: operations.  A causal layer of qwen3-4b's prefill (S
// 4096, 32 heads, hd 128) needs 1.37e11 flops: 2.05 ms at the H100's 67
// Tflop/s in f32 (the kernel's tolerance rules out TF32), against 0.02 ms
// of bytes.
//
// Design (right and simple first): one block of 256 threads per (batch x
// head, q block), a 16 x 16 grid of threads, each owning 8 q rows x 8
// keys of a 128 x 128 logits tile and 8 rows x hd/16 dims of the output.
// The scaled q tile, the K tile and the p tile sit transposed in dynamic
// shared memory with a padded leading dimension, so the inner products
// read one address per half warp; the V tile reuses the K tile's space.
// 198 KB at hd 128.  The running max, denominator and accumulator stay in
// registers, replicated over the 16 threads that share a row (row
// reductions are xor shuffles, which give every lane the same bits).  bq
// and bk may be any size up to 128 (S = 1000 gives 125): tile rows and
// keys past them are zeros, and keys past bk carry s = -inf, so they add
// exactly nothing.  Blocks run the heaviest (last) causal q blocks first.
#include <math.h>

#include "dpa_common.cuh"

namespace {

constexpr int kT = 128;         // tile rows and keys: bq, bk <= 128
constexpr int kThreads = 256;   // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kR = 8;           // q rows per thread
constexpr int kC = 8;           // keys per thread
constexpr int kLd = kT + 1;     // padded leading dim of the transposed tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int H, KV, Sq, Sk, bq, bk, causal, window;
  float scale;
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per key row of the tile: the row as f32 into dst, transposed
// ([d][key], leading dim kLd) or not ([key][d]).  Lane l holds dims
// l + 32 e.  Keys >= bk are zeros.
template <int HD, typename QT>
__device__ void load_kv_tile(const Params& p, const void* src, size_t row0,
                             float* dst, bool transposed) {
  constexpr int kE = HD / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const QT* x = static_cast<const QT*>(src);
  for (int key = warp; key < kT; key += kWarps) {
    const bool ok = key < p.bk;                 // uniform over the warp
    const size_t row = row0 + key;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int d = lane + 32 * e;
      const float val = ok ? dpa::to_f32(x[row * HD + d]) : 0.0f;
      if (transposed) {
        dst[d * kLd + key] = val;
      } else {
        dst[key * HD + d] = val;
      }
    }
  }
}

template <int HD, typename QT>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(const Params p) {
  constexpr int kE = HD / 32;
  constexpr int kD = HD / 16;     // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [HD][kLd] q tile, transposed
  float* KVs = Qs + HD * kLd;     // [HD][kLd] K tile, or [kT][HD] V tile
  float* Ps = KVs + HD * kLd;     // [kT][kLd] p tile, key-major

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int h = bh % p.H, b = bh / p.H;
  const size_t kv_row0 = ((size_t)b * p.KV + h / (p.H / p.KV)) * p.Sk;
  const int bq = p.bq, bk = p.bk;
  const int qb = gridDim.x - 1 - blockIdx.x;     // heaviest first
  const int q0 = qb * bq;
  const int off = p.Sk - p.Sq;

  // the scaled q tile; rows >= bq zero
  const QT* qp = static_cast<const QT*>(p.q) + ((size_t)bh * p.Sq + q0) * HD;
  for (int r = warp; r < kT; r += kWarps) {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const float val =
          r < bq ? dpa::to_f32(qp[(size_t)r * HD + lane + 32 * e]) : 0.0f;
      Qs[(lane + 32 * e) * kLd + r] = __fmul_rn(val, p.scale);
    }
  }

  // the key blocks that can change the result (see the note on skipping)
  const int n_k = p.Sk / bk;
  int j0 = 0, j1 = n_k;
  if (p.Sq <= p.Sk) {
    const int qmin = q0 + off, qmax = q0 + bq - 1 + off;
    if (p.causal) j1 = min(n_k, qmax / bk + 1);
    if (p.window > 0) j0 = max(0, qmin - p.window + 1) / bk;
  }

  float m[kR], l[kR], acc[kR][kD];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = -1e30f;
    l[i] = 0.0f;
#pragma unroll
    for (int dd = 0; dd < kD; ++dd) acc[i][dd] = 0.0f;
  }

  for (int j = j0; j < j1; ++j) {
    const int k0 = j * bk;
    __syncthreads();            // the previous block's reads of KVs / Ps
    load_kv_tile<HD, QT>(p, p.k, kv_row0 + k0, KVs, true);
    __syncthreads();

    float s[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) s[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[kR], kk[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) a[i] = Qs[d * kLd + ty * kR + i];
#pragma unroll
      for (int c = 0; c < kC; ++c) kk[c] = KVs[d * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) s[i][c] = fmaf(a[i], kk[c], s[i][c]);
    }

    // online softmax, row by row; p goes to Ps
    float alpha[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = ty * kR + i;
      const int qpos = q0 + r + off;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int key = tx + 16 * c;
        const int kpos = k0 + key;
        float sv = -INFINITY;               // keys past bk: not in the block
        if (key < bk) {
          sv = s[i][c];
          const bool live = (!p.causal || kpos <= qpos) &&
                            (p.window <= 0 || kpos > qpos - p.window);
          if (!live) sv = -1e30f;
        }
        s[i][c] = sv;
        mx = fmaxf(mx, sv);
      }
      const float m_cur = fmaxf(m[i], half_warp_max(mx));
      alpha[i] = expf(m[i] - m_cur);
#pragma unroll
      for (int c = 0; c < kC; ++c) s[i][c] = expf(s[i][c] - m_cur);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kC; ++c) sum += s[i][c];
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), half_warp_sum(sum));
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < kC; ++c) Ps[(tx + 16 * c) * kLd + r] = s[i][c];
    }

    __syncthreads();            // every thread's reads of the K tile
    load_kv_tile<HD, QT>(p, p.v, kv_row0 + k0, KVs, false);
    __syncthreads();

    float part[kR][kD];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int dd = 0; dd < kD; ++dd) part[i][dd] = 0.0f;
    for (int c = 0; c < bk; ++c) {
      float pr[kR], vv[kD];
#pragma unroll
      for (int i = 0; i < kR; ++i) pr[i] = Ps[c * kLd + ty * kR + i];
#pragma unroll
      for (int dd = 0; dd < kD; ++dd) vv[dd] = KVs[c * HD + tx + 16 * dd];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int dd = 0; dd < kD; ++dd)
          part[i][dd] = fmaf(pr[i], vv[dd], part[i][dd]);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int dd = 0; dd < kD; ++dd)
        acc[i][dd] = __fadd_rn(__fmul_rn(acc[i][dd], alpha[i]), part[i][dd]);
  }

  QT* op = static_cast<QT*>(p.out) + ((size_t)bh * p.Sq + q0) * HD;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty * kR + i;
    if (r < bq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int dd = 0; dd < kD; ++dd)
        dpa::store(op + (size_t)r * HD + tx + 16 * dd,
                   __fdiv_rn(acc[i][dd], den));
    }
  }
}

template <int HD, typename QT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)HD * kLd +
                                       (size_t)kT * kLd);
  auto kernel = flash_kernel<HD, QT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.Sq / p.bq, B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_hd(int hd, const Params& p, int B, cudaStream_t s) {
  return hd == 64 ? launch<64, QT>(p, B, s) : launch<128, QT>(p, B, s);
}

}  // namespace

// q/out: (B, H, Sq, hd) f32 (q_bf16 = 0) or bf16 (q_bf16 = 1), hd 64 or
// 128; k/v: (B, KV, Sk, hd) in q's dtype.  window <= 0: none.  All
// contiguous.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int q_bf16,
                                      int hd, int B, int H, int KV, int Sq,
                                      int Sk, int bq, int bk, int causal,
                                      int window, float scale,
                                      void* stream) {
  if ((hd != 64 && hd != 128) || B <= 0 || KV <= 0 || H % KV ||
      bq < 1 || bq > kT || bk < 1 || bk > kT || Sq % bq || Sk % bk ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, H, KV, Sq, Sk, bq, bk, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q_bf16 ? launch_hd<__nv_bfloat16>(hd, p, B, s)
                      : launch_hd<float>(hd, p, B, s));
}
