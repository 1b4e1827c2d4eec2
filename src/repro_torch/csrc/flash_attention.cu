// flash_attention for Hopper (sm_90a): blocked online-softmax f32 prefill
// attention, GQA, causal and sliding-window masks, both products on bf16
// tensor cores over operands split exactly into bf16 pieces.
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
// rounded operations, as in the reference.  The route's pin is 2e-6
// relative against the global-softmax plain version, which rules out TF32.
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
// Tflop/s in f32 on the CUDA cores, 0.42 ms as three bf16 products at 989
// Tflop/s (the bf16 instance), 0.83 ms as six (the f32 instance), against
// 0.02 ms of bytes.
//
// The products (tests/test_torch_attn_plan.py models this order): each
// f32 operand x splits into three bf16 pieces hi = bf16(x), mid = bf16(x -
// hi), lo = x - hi - mid (24 = 3 x 8 significant bits, and bf16 has f32's
// exponent range: exact for |x| >= 2^-110, below which the dropped part
// is under 2^-133).  The scaled q tile and p split so; bf16 K and V enter
// as they are, so the bf16 instance's piece products are exact and it
// differs from a scalar f32 kernel only in the order and rounding of its
// sums.  f32 K and V go through a pre-pass (kv_split_kernel) that writes
// their three pieces; the f32 instance keeps the six piece products of
// weight 2^-16 or more (hi hi, hi mid, mid hi, hi lo, lo hi, mid mid) and
// drops terms near 2^-24 relative.  To keep the tensor cores' rounding of
// a running sum off the small pieces, hi . hi products and the rest
// accumulate apart (QK: over hd; PV: over the key tile, fresh per tile)
// and meet in one f32 add; the state updates stay as above.
//
// Layout (FA2): one block of 8 warps per (batch x head, q block of <= 128
// rows), warp w owning rows 16 w .. 16 w + 15 against a key tile, so a
// row's max and sums are quad shuffles and p goes from the QK accumulators
// straight into PV's A fragments.  The q tile is scaled and split once
// into three swizzled bf16 tiles (96 KB at hd 128); K and V tiles (bf16
// piece planes, 2 bytes a value) stream through a cp.async ring with one
// barrier a tile, read by ldmatrix (V transposed): tiles of 64 keys in 3
// stages for bf16 inputs, of 32 keys (three planes each) in 2 stages for
// f32 (96 KB either way).  The block walks the keys of the caller's live
// key blocks [j0 bk, j1 bk) in its own tiles (any bk <= 128: keys past j1
// bk carry s = -inf and zero K/V rows), so the tile, not bk, sets where
// the running max is taken; that changes only the f32 rounding, as the
// plain version's global softmax already differs from any blocking.  Rows
// past bq are zeros and are not stored.  One block an SM (255 registers).
// Blocks run the heaviest (last) causal q blocks first.
#include <math.h>

#include <type_traits>

#include "dpa_common.cuh"
#include "dpa_mma.cuh"

namespace {

constexpr int kT = 128;         // q tile rows; bq, bk <= 128
constexpr int kWarps = 8;       // 16 q rows each
constexpr int kThreads = 32 * kWarps;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int H, KV, Sq, Sk, bq, bk, causal, window;
  float scale;
};

// KVP: bf16 pieces of a K or V value, 1 (bf16 inputs) or 3 (f32 inputs,
// split by the pre-pass below).  The key tile and the ring's depth follow
// from the shared memory the q pieces leave.
template <int KVP>
struct Tc {
  static constexpr int kTN = KVP == 1 ? 64 : 32;   // keys a tile
  static constexpr int kN8 = kTN / 8;   // the QK accumulators' 8-key columns
  static constexpr int kStages = KVP == 1 ? 3 : 2;   // K/V ring stages
  // the (q or p piece, K or V piece) pairs summed apart from hi . hi: all
  // pairs of weight >= 2^-16 (with one K/V piece: mid and lo of q or p)
  static constexpr int kLo = KVP == 1 ? 2 : 5;
  __host__ __device__ static constexpr int lo_a(int i) {
    return KVP == 1 ? 1 + i : (i == 0 || i == 2) ? 0 : i == 3 ? 2 : 1;
  }
  __host__ __device__ static constexpr int lo_b(int i) {
    return KVP == 1 ? 0 : i == 0 || i == 4 ? 1 : i == 2 ? 2 : 0;
  }
};

// Shared memory, bytes: the three q pieces (kT rows of HD bf16 each), then
// kStages ring stages of a K and a V tile (KVP piece planes of kTN rows of
// HD bf16 each), all swizzled.
template <int HD, int KVP>
struct TcSmem {
  static constexpr int kQPiece = kT * HD * 2;
  static constexpr int kTile = Tc<KVP>::kTN * HD * 2;      // one plane
  static constexpr int kStage = 2 * KVP * kTile;
  static constexpr int kRing = 3 * kQPiece;
  static constexpr int kBytes = kRing + Tc<KVP>::kStages * kStage;
};

// x0, x1 -> bf16 pairs hi, mid, lo with hi + mid + lo = x, exact for |x|
// >= 2^-110 (the low half of each pair from x0).
__device__ __forceinline__ void split3_bf16x2(float x0, float x1,
                                              uint32_t& hi, uint32_t& mid,
                                              uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(x0, hf.x), r1 = __fsub_rn(x1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The f32 instance's pre-pass: rows of n f32 values -> three bf16 planes
// of the same rows (row r's planes at out + (3 r + piece) n), two values a
// thread.
__global__ void __launch_bounds__(256) kv_split_kernel(
    const float* __restrict__ x, __nv_bfloat16* __restrict__ out,
    long long rows, int n) {
  const long long i =
      2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= rows * n) return;
  const long long r = i / n;
  const int c = (int)(i - r * n);
  const float2 v = *reinterpret_cast<const float2*>(x + i);
  uint32_t pc[3];
  split3_bf16x2(v.x, v.y, pc[0], pc[1], pc[2]);
#pragma unroll
  for (int pi = 0; pi < 3; ++pi)
    *reinterpret_cast<uint32_t*>(out + (3 * r + pi) * n + c) = pc[pi];
}

// cp.async copies of the K and V rows of keys [k0, k0 + kTN), each of its
// KVP piece planes, into ring stage `stage` (16-byte chunks, swizzled);
// keys at or past kend are zero-filled.  k and v hold, per (batch, KV
// head), KVP planes of Sk rows.
template <int HD, int KVP>
__device__ __forceinline__ void load_tc_tile(const Params& p, uint8_t* sm,
                                             int stage, size_t kv_head,
                                             int k0, int kend) {
  using L = TcSmem<HD, KVP>;
  constexpr int kTN = Tc<KVP>::kTN;
  constexpr int kCh = HD / 8;                 // 16-byte chunks a row
  constexpr int kItems = kTN * kCh;           // a plane's
  for (int i = threadIdx.x; i < 2 * KVP * kItems; i += kThreads) {
    const int plane = i / kItems;             // K's planes, then V's
    const int is_v = plane >= KVP, pi = plane - is_v * KVP;
    const int key = (i % kItems) / kCh, c = i % kCh;
    const bool ok = k0 + key < kend;
    const __nv_bfloat16* src =
        static_cast<const __nv_bfloat16*>(is_v ? p.v : p.k) +
        ((kv_head * KVP + pi) * p.Sk + (ok ? k0 + key : 0)) * HD + 8 * c;
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(
        sm + L::kRing + stage * L::kStage + plane * L::kTile);
    dpa::cp_async16(dst + dpa::swz<HD>(key, c), src, ok ? 16 : 0);
  }
  dpa::cp_async_commit();
}

template <int HD, int KVP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const Params p) {
  using L = TcSmem<HD, KVP>;
  using T = Tc<KVP>;
  constexpr int kTN = T::kTN, kN8 = T::kN8, kStages = T::kStages;
  constexpr int kE = HD / 32;          // q dims a lane while splitting
  constexpr int kKSteps = HD / 16;     // QK's k16 steps
  constexpr int kDHalf = HD / 16;      // PV's 8-dim columns per half of hd
  extern __shared__ __align__(16) uint8_t sm[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int bh = blockIdx.y;
  const int h = bh % p.H, b = bh / p.H;
  const size_t kv_head = (size_t)b * p.KV + h / (p.H / p.KV);
  const int bq = p.bq, bk = p.bk;
  const int qb = gridDim.x - 1 - blockIdx.x;     // heaviest first
  const int q0 = qb * bq;
  const int off = p.Sk - p.Sq;

  // the key blocks that can change the result (see the note on skipping)
  const int n_k = p.Sk / bk;
  int j0 = 0, j1 = n_k;
  if (p.Sq <= p.Sk) {
    const int qmin = q0 + off, qmax = q0 + bq - 1 + off;
    if (p.causal) j1 = min(n_k, qmax / bk + 1);
    if (p.window > 0) j0 = max(0, qmin - p.window + 1) / bk;
  }
  const int kstart = j0 * bk, kend = j1 * bk;
  const int n_tiles = (kend - kstart + kTN - 1) / kTN;
  for (int s = 0; s < kStages - 1 && s < n_tiles; ++s)
    load_tc_tile<HD, KVP>(p, sm, s, kv_head, kstart + s * kTN, kend);

  // q_s = fl(q * scale) split into three bf16 tiles; rows >= bq zero
  using QT = typename std::conditional<KVP == 1, __nv_bfloat16, float>::type;
  __nv_bfloat16* Qp = reinterpret_cast<__nv_bfloat16*>(sm);
  const QT* qp = static_cast<const QT*>(p.q) + ((size_t)bh * p.Sq + q0) * HD;
  for (int r = warp; r < kT; r += kWarps) {
#pragma unroll
    for (int e = 0; e < kE; e += 2) {
      const int d = lane * kE + e;
      float2 v = make_float2(0.0f, 0.0f);
      if (r < bq) {
        if constexpr (KVP == 1)
          v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              qp + (size_t)r * HD + d));
        else
          v = *reinterpret_cast<const float2*>(qp + (size_t)r * HD + d);
      }
      uint32_t pc[3];
      split3_bf16x2(__fmul_rn(v.x, p.scale), __fmul_rn(v.y, p.scale), pc[0],
                    pc[1], pc[2]);
#pragma unroll
      for (int pi = 0; pi < 3; ++pi)
        *reinterpret_cast<uint32_t*>(Qp + pi * kT * HD +
                                     dpa::swz<HD>(r, d >> 3) + (d & 7)) =
            pc[pi];
    }
  }

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};
  float acc[2 * kDHalf][4];
#pragma unroll
  for (int n = 0; n < 2 * kDHalf; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const int qlo = q0 + r0 + off;               // this warp's first qpos

  // One barrier per tile: after it tile `it` (and the q pieces) have
  // landed for every thread, and every warp is done with tile it - 1,
  // whose stage then takes tile it + kStages - 1.
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kstart + it * kTN, stage = it % kStages;
    if (it + 1 < n_tiles)
      dpa::cp_async_wait<kStages - 2>();
    else
      dpa::cp_async_wait<0>();
    __syncthreads();
    if (it + kStages - 1 < n_tiles)
      load_tc_tile<HD, KVP>(p, sm, (it + kStages - 1) % kStages, kv_head,
                            k0 + (kStages - 1) * kTN, kend);
    const __nv_bfloat16* Kt = reinterpret_cast<const __nv_bfloat16*>(
        sm + L::kRing + stage * L::kStage);
    const __nv_bfloat16* Vt = Kt + KVP * kTN * HD;

    // s = q_s . k over the tile: hi . hi products apart from the rest
    float sh[kN8][4], sl[kN8][4];
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[n][e] = sl[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t a[3][4];
#pragma unroll
      for (int pi = 0; pi < 3; ++pi)
        dpa::ldmatrix_x4(a[pi], dpa::smem_u32(
            Qp + pi * kT * HD +
            dpa::swz<HD>(r0 + (lane & 15), 2 * kk + (lane >> 4))));
#pragma unroll
      for (int np = 0; np < kN8 / 2; ++np) {
        uint32_t bf[KVP][4];
#pragma unroll
        for (int pi = 0; pi < KVP; ++pi)
          dpa::ldmatrix_x4(bf[pi], dpa::smem_u32(
              Kt + pi * kTN * HD +
              dpa::swz<HD>(16 * np + (lane & 7) + ((lane >> 4) << 3),
                           2 * kk + ((lane >> 3) & 1))));
        dpa::mma_bf16(sh[2 * np], a[0][0], a[0][1], a[0][2], a[0][3],
                      bf[0][0], bf[0][1]);
        dpa::mma_bf16(sh[2 * np + 1], a[0][0], a[0][1], a[0][2], a[0][3],
                      bf[0][2], bf[0][3]);
#pragma unroll
        for (int i = 0; i < T::kLo; ++i) {
          const uint32_t(&x)[4] = a[T::lo_a(i)];
          const uint32_t(&y)[4] = bf[T::lo_b(i)];
          dpa::mma_bf16(sl[2 * np], x[0], x[1], x[2], x[3], y[0], y[1]);
          dpa::mma_bf16(sl[2 * np + 1], x[0], x[1], x[2], x[3], y[2], y[3]);
        }
      }
    }

    // logits, masks and the running max; element e of column block n is
    // row r0 + g + 8 (e >> 1), key k0 + 8 n + 2 t + (e & 1).  A tile whose
    // every (row, key) of this warp is live skips the mask.
    const bool all_live = k0 + kTN <= kend &&
                          (!p.causal || k0 + kTN - 1 <= qlo) &&
                          (p.window <= 0 || k0 > qlo + 15 - p.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = __fadd_rn(sh[n][e], sl[n][e]);
        if (!all_live) {
          const int qpos = qlo + g + 8 * (e >> 1);
          const int kpos = k0 + 8 * n + 2 * t + (e & 1);
          const bool live = (!p.causal || kpos <= qpos) &&
                            (p.window <= 0 || kpos > qpos - p.window);
          if (!live) sv = -1e30f;
          if (kpos >= kend) sv = -INFINITY;   // not in a live key block
        }
        sh[n][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    float alpha[2], m_cur[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_cur[i] = fmaxf(m[i], dpa::quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_cur[i]);
      m[i] = m_cur[i];
    }
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sh[n][e] = expf(sh[n][e] - m_cur[e >> 1]);
        sum[e >> 1] += sh[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), dpa::quad_sum(sum[i]));

    // PV, one half of hd at a time: p split into three bf16 pieces (A,
    // from this thread's accumulators: keys 16 c + 2 t (+1) and 16 c + 8 +
    // 2 t (+1)) times V (B, ldmatrix.trans); hi . hi apart from the rest
#pragma unroll
    for (int dh = 0; dh < 2; ++dh) {
      float ph[kDHalf][4], pl[kDHalf][4];
#pragma unroll
      for (int n = 0; n < kDHalf; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ph[n][e] = pl[n][e] = 0.0f;
#pragma unroll
      for (int c = 0; c < kTN / 16; ++c) {
        uint32_t a[3][4];
        split3_bf16x2(sh[2 * c][0], sh[2 * c][1], a[0][0], a[1][0], a[2][0]);
        split3_bf16x2(sh[2 * c][2], sh[2 * c][3], a[0][1], a[1][1], a[2][1]);
        split3_bf16x2(sh[2 * c + 1][0], sh[2 * c + 1][1], a[0][2], a[1][2],
                      a[2][2]);
        split3_bf16x2(sh[2 * c + 1][2], sh[2 * c + 1][3], a[0][3], a[1][3],
                      a[2][3]);
#pragma unroll
        for (int dp = 0; dp < kDHalf / 2; ++dp) {
          uint32_t bf[KVP][4];
#pragma unroll
          for (int pi = 0; pi < KVP; ++pi)
            dpa::ldmatrix_x4_trans(bf[pi], dpa::smem_u32(
                Vt + pi * kTN * HD +
                dpa::swz<HD>(16 * c + (lane & 7) + (((lane >> 3) & 1) << 3),
                             dh * kDHalf + 2 * dp + (lane >> 4))));
          dpa::mma_bf16(ph[2 * dp], a[0][0], a[0][1], a[0][2], a[0][3],
                        bf[0][0], bf[0][1]);
          dpa::mma_bf16(ph[2 * dp + 1], a[0][0], a[0][1], a[0][2], a[0][3],
                        bf[0][2], bf[0][3]);
#pragma unroll
          for (int i = 0; i < T::kLo; ++i) {
            const uint32_t(&x)[4] = a[T::lo_a(i)];
            const uint32_t(&y)[4] = bf[T::lo_b(i)];
            dpa::mma_bf16(pl[2 * dp], x[0], x[1], x[2], x[3], y[0], y[1]);
            dpa::mma_bf16(pl[2 * dp + 1], x[0], x[1], x[2], x[3], y[2],
                          y[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kDHalf; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[dh * kDHalf + n][e] =
              __fadd_rn(__fmul_rn(acc[dh * kDHalf + n][e], alpha[e >> 1]),
                        __fadd_rn(ph[n][e], pl[n][e]));
    }
  }

  // out: element e of column block n is row r0 + g + 8 (e >> 1), dim
  // 8 n + 2 t + (e & 1)
  QT* op = static_cast<QT*>(p.out) + ((size_t)bh * p.Sq + q0) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r < bq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int n = 0; n < 2 * kDHalf; ++n) {
        const float o0 = __fdiv_rn(acc[n][2 * i], den);
        const float o1 = __fdiv_rn(acc[n][2 * i + 1], den);
        if constexpr (KVP == 1)
          *reinterpret_cast<__nv_bfloat162*>(op + (size_t)r * HD + 8 * n +
                                             2 * t) =
              __floats2bfloat162_rn(o0, o1);
        else
          *reinterpret_cast<float2*>(op + (size_t)r * HD + 8 * n + 2 * t) =
              make_float2(o0, o1);
      }
    }
  }
}

template <int HD, int KVP>
cudaError_t launch_tc(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = TcSmem<HD, KVP>::kBytes;
  auto kernel = flash_tc_kernel<HD, KVP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.Sq / p.bq, B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q/out: (B, H, Sq, hd) f32 (q_bf16 = 0) or bf16 (q_bf16 = 1), hd 64 or
// 128.  bf16: k/v (B, KV, Sk, hd) bf16.  f32: k/v are the pre-pass's
// pieces of the f32 K and V, (B, KV, 3, Sk, hd) bf16 (flash_kv_split_launch).
// window <= 0: none.  All contiguous, 16-byte aligned.
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
  if (q_bf16)
    return (int)(hd == 64 ? launch_tc<64, 1>(p, B, s)
                          : launch_tc<128, 1>(p, B, s));
  return (int)(hd == 64 ? launch_tc<64, 3>(p, B, s)
                        : launch_tc<128, 3>(p, B, s));
}

// The f32 instance's pre-pass: x (rows, n) f32 -> out (rows, 3, n) bf16,
// the hi, mid and lo pieces of each value (n even; both 16-byte aligned).
extern "C" int flash_kv_split_launch(const void* x, void* out,
                                     long long rows, int n, void* stream) {
  if (rows <= 0 || n <= 0 || n % 2) return (int)cudaErrorInvalidValue;
  const long long pairs = rows * n / 2;
  kv_split_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(out), rows,
      n);
  return (int)cudaGetLastError();
}
