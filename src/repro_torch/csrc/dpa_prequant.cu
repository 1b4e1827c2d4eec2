// dpa_matmul_prequant for Hopper (sm_90a): pre-quantized activations times
// pre-quantized weights; dense, or one product per expert of a MoE layer.
//
// Replaces the Pallas TPU kernels repro/kernels/dpa_matmul.py
// dpa_matmul_prequant (_dpa_matmul_kernel) and
// repro/kernels/dpa_grouped_matmul.py dpa_grouped_matmul_prequant
// (_grouped_prequant_kernel), which is the same contract per expert.
//
// Contract, per expert e, row m and column n:
//   acc = sum_k x(xq[m, k]) * w(wq[k, n])       (exact products, f32 sum)
//   out = (acc * sx[m]) * sw[n]                        (two rounded products)
// xq is (E, M, K) and wq (E, K, N) in one of the operand formats below,
// each side its own: fp16, bf16, E4M3, E5M2, E2M1 one code a byte, or
// E2M1 packed two codes a byte along K (low nibble = even k: xq (E, M,
// K/2), wq (E, K/2, N)); sx is (E, M) and sw (E, N), f32.
//
// What bounds it: at the serving shapes (8 to 64 rows per expert) each
// weight byte feeds 2 * M products, so the floor is the weight bytes over
// 3.35 TB/s: 0.16 us for one of granite-moe-1b's 1024 x 1024 attention
// projections in packed E2M1 (512 KB of codes), 2.5 us for a 32-expert
// 1024 x 512 stack (8 MB); fp8 and fp16 weights move 2x and 4x the bytes.
// The dense calls are far below a launch and one DRAM round trip, so what
// a call costs there is latency: how many SMs work, and how many bytes
// each has in flight.  The design follows from that.
//
// 1. Three tensor-core routes, each exact in its products:
//    - E2M1 x E2M1 (either side packed or not): int8.  Each E2M1 code maps
//      to the int8 value 2 * e2m1(c) (magnitudes 0, 1, 2, 3, 4, 6, 8, 12,
//      sign from bit 3, -0 -> 0) and the products run on mma.sync
//      m16n8k32 s8 x s8 -> s32.  Then acc_int = 4 * acc, |acc_int| <= 144
//      K < 2^24 for K < 2^16 (the wrapper's plan refuses larger K), so
//      (float)acc_int * 0.25f is the exact sum, which is also what the
//      plain version's f32 sum is: every partial sum of E2M1 products is a
//      multiple of 1/4 below 2^22.  The kernel equals its plain version
//      bit for bit by construction, and any split of K sums exactly.  The
//      e4m3 tensor cores would not do: their f32 accumulation keeps fewer
//      bits on Hopper (DeepSeek-V3, arXiv 2412.19437, 3.3.2), and these
//      sums need about 18.
//    - any mix of fp16, E4M3, E5M2 and E2M1 otherwise: fp16 mma.sync
//      m16n8k16 with f32 accumulation.  Every E4M3, E5M2 and E2M1 value is
//      an fp16 value, and a product of two fp16 values is exact in f32, so
//      the sum differs from the plain version's only in its order (and in
//      how the tensor core rounds inside one MMA's sum).
//    - bf16 with bf16, E4M3, E5M2 or E2M1: bf16 mma.sync, likewise (every
//      such value is a bf16 value; a bf16 product is exact in f32).
//    fp16 x bf16 has no exact 16-bit MMA and is refused.
//    M is small, so the product is taken swapped: 16 weight columns are
//    the MMA's 16-row side, 8 activation rows its n8 side; a block loops
//    over up to 8 such row tiles (64 rows), and grid y over more.
// 2. Split K across a thread-block cluster.  One block owns `bn` output
//    columns (16, 32 or 64) of up to 64 rows of one expert; at granite's
//    attention projections that is only 32 to 64 blocks for 132 SMs.  The
//    launch plan (kernels/dpa_matmul.py prequant_plan) picks the smallest
//    cluster size `split` <= 8 that brings the grid to 132 blocks; each
//    block of a cluster sums one K / split slice.  The partials (int32, or
//    f32 on the 16-bit routes) meet through distributed shared memory:
//    each rank pushes its sums for the outputs another rank owns into
//    that rank's shared memory (stores do not wait, remote loads would),
//    one cluster barrier, and each rank finishes and writes 1/split of the
//    tile, adding the ranks' sums in rank order.  One launch, no
//    workspace, no atomics.
// 3. Wide loads, several in flight.  A ring of kStages chunks of 128 k is
//    filled with 16-byte cp.async copies of the operands as they are in
//    memory (the weight rows are contiguous along N and keep the op's
//    layout; rows past M are zero-filled, never read), three chunks ahead
//    of the MMAs.  Where a side's format is the route's own (packed E2M1
//    on the int8 route, fp16 or bf16 on theirs) the MMA fragments are
//    read from the ring as they are; otherwise one pass over the landed
//    chunk widens it into the route's layout first (E2M1 codes packed two
//    a byte, or 16-bit values), exactly.  On the int8 route Hopper has no
//    8-bit ldmatrix.trans, so instead of transposing the weights, each
//    thread's 16-column MMA rows are mapped to output columns that sit
//    side by side in memory, and one __byte_perm pairs two packed rows
//    into a column's four codes; the 16-bit routes read the weights with
//    ldmatrix.trans.  The row pitches put every fragment load of a warp
//    on its own bank.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dpa_mma.cuh"

namespace cg = cooperative_groups;

namespace {

// operand formats (kernels/dpa_matmul.py PREQUANT_FMT)
constexpr int kE2M1Packed = 0;            // E2M1 codes, two a byte along K
constexpr int kE4M3 = 1;
constexpr int kE5M2 = 2;
constexpr int kE2M1 = 3;                  // E2M1 codes, one a byte
constexpr int kF16 = 4;
constexpr int kBF16 = 5;
// tensor-core routes
constexpr int kS8 = 0;                    // E2M1 x E2M1 on int8
constexpr int kH16 = 1;                   // fp16 MMA, f32 accumulation
constexpr int kB16 = 2;                   // bf16 MMA, f32 accumulation

constexpr int kChunk = 128;               // k per ring stage
constexpr int kChunkBytes = kChunk / 2;   // packed rows of weights a stage
constexpr int kStages = 4;
constexpr int kWarps = 4;                 // one k step of 32 each per chunk
constexpr int kThreads = kWarps * 32;
static_assert(kWarps * 32 == kChunk, "warp w takes k step w of a chunk");

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// half-bytes an element of format f takes in memory
__host__ __device__ constexpr int nibbles(int f) {
  return f == kE2M1Packed ? 1 : (f >= kF16 ? 4 : 2);
}

// the format the route's MMA reads as it is
__host__ __device__ constexpr int native_fmt(int route) {
  return route == kS8 ? kE2M1Packed : (route == kH16 ? kF16 : kBF16);
}
__host__ __device__ constexpr bool native(int route, int f) {
  return f == native_fmt(route);
}

// Int8 route's row pitches (bytes, multiples of 16 for cp.async): the
// fragment loads of a warp then fall on distinct banks (lane g, t reads
// weight row 2t + h, x row g; see the kernel).
constexpr int kXPitch = kChunkBytes + 16;
__host__ __device__ constexpr int w_pitch(int bn) {
  return bn + 16 > 48 ? bn + 16 : 48;
}

// Shared memory: the ring (kStages x [weight rows of the chunk as they
// are in memory, w_pitch] [MT x rows, x_pitch]); the widened tiles of the
// sides whose format is not the route's (the route's layout: packed E2M1
// 64 x w_pitch(bn) and MT x kXPitch on the int8 route, 16-bit 128 x (2 bn
// + 16) and MT x (256 + 16) on the others); after the main loop the ring
// holds the warps' partials (kWarps x MT x bn, 4 bytes each); then
// `recv`, split slots of the tile share this rank reduces, which the
// cluster's ranks push into.
struct Layout {
  int w_rows, w_pitch, x_pitch, stage;    // the ring
  int cw, cw_pitch, cx, cx_pitch;         // widened tiles (-1: read ring)
  int recv;
};

__host__ __device__ constexpr Layout layout(int route, int bn, int mt, int fx,
                                            int fw) {
  Layout L{};
  L.w_rows = fw == kE2M1Packed ? kChunk / 2 : kChunk;
  L.w_pitch = imax(bn * (fw >= kF16 ? 2 : 1) + 16, 48);
  L.x_pitch = kChunk * nibbles(fx) / 2 + 16;
  L.stage = L.w_rows * L.w_pitch + mt * L.x_pitch;
  const bool s8 = route == kS8;
  L.cw_pitch = s8 ? w_pitch(bn) : 2 * bn + 16;
  L.cx_pitch = s8 ? kXPitch : 2 * kChunk + 16;
  int off = kStages * L.stage;
  L.cw = native(route, fw) ? -1 : off;
  if (L.cw >= 0) off += (s8 ? kChunkBytes : kChunk) * L.cw_pitch;
  L.cx = native(route, fx) ? -1 : off;
  if (L.cx >= 0) off += mt * L.cx_pitch;
  L.recv = imax(off, kWarps * mt * bn * 4);
  return L;
}

__host__ __device__ constexpr int share(int bn, int mt, int split) {
  return (mt * bn + split - 1) / split;
}

// Four E2M1 codes, one per nibble of the low 16 bits (lowest k lowest) ->
// four int8 lanes holding 2 * e2m1(code), lowest k in the low byte.
__device__ __forceinline__ uint32_t codes_to_s8x4(uint32_t v) {
  const uint32_t sel = v & 0x7777u;
  const uint32_t pos = __byte_perm(0x03020100u, 0x0C080604u, sel);
  const uint32_t neg = __byte_perm(0xFDFEFF00u, 0xF4F8FAFCu, sel);
  const uint32_t sgn = __byte_perm(0u, 0xFFFFFFFFu, (v >> 1) & 0x4444u);
  return (pos & ~sgn) | (neg & sgn);
}

// One packed E2M1 byte (low nibble first) -> its two values as f16x2
// (exact): the magnitude (code & 7) picks the f16's high byte from an
// 8-entry table (0, 0.5, 1, 1.5, 2, 3, 4, 6), bit 3 is the sign.
__device__ __forceinline__ uint32_t fp4x2_to_f16x2(uint32_t b) {
  constexpr uint32_t kLut0 = 0x3E3C3800u, kLut1 = 0x46444240u;
  const uint32_t hi = __byte_perm(kLut0, kLut1, (b & 7u) | ((b >> 4) & 7u) << 4) |
                      ((b & 8u) << 4) | ((b & 0x80u) << 8);
  return __byte_perm(hi, 0u, 0x1404u);
}

// Two codes of format f in the low 16 bits (first k in the low byte; for
// packed E2M1 one byte, low nibble first) -> their values as f16x2, exact.
__device__ __forceinline__ uint32_t to_f16x2(uint32_t v, int f) {
  if (f == kE4M3) return dpa::e4m3x2_to_f16x2(v);
  if (f == kE5M2) return __byte_perm(v, 0u, 0x1404u);  // fp16's high byte
  if (f == kE2M1) v = (v & 0xFu) | ((v >> 4) & 0xF0u);
  return fp4x2_to_f16x2(v);
}

// ... as the route's MMA operand: bf16x2 on the bf16 route (exact: every
// E4M3, E5M2 and E2M1 value is a bf16 value)
template <int R>
__device__ __forceinline__ uint32_t to_mma(uint32_t v, int f) {
  const uint32_t h = to_f16x2(v, f);
  if constexpr (R == kB16) {
    const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&h));
    const __nv_bfloat162 b = __floats2bfloat162_rn(x.x, x.y);
    return *reinterpret_cast<const uint32_t*>(&b);
  } else {
    return h;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
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

template <typename T>
__device__ __forceinline__ T lds(const uint8_t* p) {
  return *reinterpret_cast<const T*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of one k step (32 k, 16 packed weight rows from `w`)
// for the block's CT 16-column tiles.  MMA row g (g + 8) of tile ct is
// output column 2 CT g + 2 ct (+ 1), so the 2 CT columns a thread needs
// lie side by side in its rows: half a word (CT 1), a word (CT 2) or two
// (CT 4).  Registers 0 and 1 hold k 4t..4t+3 (packed rows 2t, 2t+1),
// registers 2 and 3 k 16+4t.. (rows 8+2t, 9+2t); a __byte_perm pairs the
// two rows' bytes of each column into its four codes.
template <int CT>
__device__ __forceinline__ void load_a(uint32_t (&a)[CT][4],
                                       const uint8_t* w, int wp, int g,
                                       int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint8_t* r0 = w + (8 * h + 2 * t) * wp;
    const uint8_t* r1 = r0 + wp;
    if constexpr (CT == 1) {
      const uint32_t p = __byte_perm(lds<uint32_t>(r0 + 4 * (g >> 1)),
                                     lds<uint32_t>(r1 + 4 * (g >> 1)),
                                     (g & 1) ? 0x7362u : 0x5140u);
      a[0][2 * h] = codes_to_s8x4(p);
      a[0][2 * h + 1] = codes_to_s8x4(p >> 16);
    } else {
      uint32_t lo[CT / 2], hi[CT / 2];
      if constexpr (CT == 2) {
        lo[0] = lds<uint32_t>(r0 + 4 * g);
        hi[0] = lds<uint32_t>(r1 + 4 * g);
      } else {
        const uint2 l = lds<uint2>(r0 + 8 * g), u = lds<uint2>(r1 + 8 * g);
        lo[0] = l.x, lo[1] = l.y, hi[0] = u.x, hi[1] = u.y;
      }
#pragma unroll
      for (int i = 0; i < CT / 2; ++i) {
        const uint32_t p01 = __byte_perm(lo[i], hi[i], 0x5140u);
        const uint32_t p23 = __byte_perm(lo[i], hi[i], 0x7362u);
        a[2 * i][2 * h] = codes_to_s8x4(p01);
        a[2 * i][2 * h + 1] = codes_to_s8x4(p01 >> 16);
        a[2 * i + 1][2 * h] = codes_to_s8x4(p23);
        a[2 * i + 1][2 * h + 1] = codes_to_s8x4(p23 >> 16);
      }
    }
  }
}

// Two bytes of E2M1 codes (one a byte) -> one byte, low nibble first, for
// each of the two halves of v: the packed bytes (b0 | b1 << 4) and (b2 |
// b3 << 4) in the low 16 bits.
__device__ __forceinline__ uint32_t pack_codes4(uint32_t v) {
  const uint32_t lo = v & 0x0F0F0F0Fu;
  return __byte_perm(lo | (lo >> 4), 0u, 0x4420u);
}

// Widen the landed chunk of the sides whose format is not the route's
// into the route's layout (Layout), all threads.
template <int R>
__device__ __forceinline__ void widen_chunk(const uint8_t* st, uint8_t* smem,
                                            const Layout& L, int bn, int mt,
                                            int fx, int fw) {
  const uint8_t* xs = st + L.w_rows * L.w_pitch;
  if (L.cw >= 0) {
    uint8_t* cw = smem + L.cw;
    if constexpr (R == kS8) {
      // unpacked codes, rows 2p and 2p + 1 -> packed row p
      const int per = bn / 16;
      for (int i = threadIdx.x; i < kChunkBytes * per; i += kThreads) {
        const int p = i / per, v = i % per;
        const uint4 a = lds<uint4>(st + 2 * p * L.w_pitch + 16 * v);
        const uint4 b = lds<uint4>(st + (2 * p + 1) * L.w_pitch + 16 * v);
        uint4 o;
        o.x = (a.x & 0x0F0F0F0Fu) | ((b.x & 0x0F0F0F0Fu) << 4);
        o.y = (a.y & 0x0F0F0F0Fu) | ((b.y & 0x0F0F0F0Fu) << 4);
        o.z = (a.z & 0x0F0F0F0Fu) | ((b.z & 0x0F0F0F0Fu) << 4);
        o.w = (a.w & 0x0F0F0F0Fu) | ((b.w & 0x0F0F0F0Fu) << 4);
        *reinterpret_cast<uint4*>(cw + p * L.cw_pitch + 16 * v) = o;
      }
    } else if (fw == kE2M1Packed) {
      // packed row p, 8 columns -> rows 2p (low nibbles), 2p + 1 (high)
      const int per = bn / 8;
      for (int i = threadIdx.x; i < kChunkBytes * per; i += kThreads) {
        const int p = i / per, v = i % per;
        const uint2 a = lds<uint2>(st + p * L.w_pitch + 8 * v);
        uint4 lo, hi;
        const uint32_t l0 = a.x & 0x0F0F0F0Fu, l1 = a.y & 0x0F0F0F0Fu;
        const uint32_t h0 = (a.x >> 4) & 0x0F0F0F0Fu,
                       h1 = (a.y >> 4) & 0x0F0F0F0Fu;
        lo.x = to_mma<R>(l0, kE2M1), lo.y = to_mma<R>(l0 >> 16, kE2M1);
        lo.z = to_mma<R>(l1, kE2M1), lo.w = to_mma<R>(l1 >> 16, kE2M1);
        hi.x = to_mma<R>(h0, kE2M1), hi.y = to_mma<R>(h0 >> 16, kE2M1);
        hi.z = to_mma<R>(h1, kE2M1), hi.w = to_mma<R>(h1 >> 16, kE2M1);
        *reinterpret_cast<uint4*>(cw + 2 * p * L.cw_pitch + 16 * v) = lo;
        *reinterpret_cast<uint4*>(cw + (2 * p + 1) * L.cw_pitch + 16 * v) =
            hi;
      }
    } else {
      // one byte a code, 8 columns of a row
      const int per = bn / 8;
      for (int i = threadIdx.x; i < kChunk * per; i += kThreads) {
        const int r = i / per, v = i % per;
        const uint2 a = lds<uint2>(st + r * L.w_pitch + 8 * v);
        uint4 o;
        o.x = to_mma<R>(a.x, fw), o.y = to_mma<R>(a.x >> 16, fw);
        o.z = to_mma<R>(a.y, fw), o.w = to_mma<R>(a.y >> 16, fw);
        *reinterpret_cast<uint4*>(cw + r * L.cw_pitch + 16 * v) = o;
      }
    }
  }
  if (L.cx >= 0) {
    uint8_t* cx = smem + L.cx;
    if constexpr (R == kS8) {
      // 16 codes of a row, one a byte -> 8 packed bytes
      for (int i = threadIdx.x; i < mt * 8; i += kThreads) {
        const int r = i >> 3, v = i & 7;
        const uint4 a = lds<uint4>(xs + r * L.x_pitch + 16 * v);
        uint2 o;
        o.x = __byte_perm(pack_codes4(a.x), pack_codes4(a.y), 0x5410u);
        o.y = __byte_perm(pack_codes4(a.z), pack_codes4(a.w), 0x5410u);
        *reinterpret_cast<uint2*>(cx + r * L.cx_pitch + 8 * v) = o;
      }
    } else if (fx == kE2M1Packed) {
      // 4 packed bytes (8 k) of a row -> 8 values
      for (int i = threadIdx.x; i < mt * 16; i += kThreads) {
        const int r = i >> 4, v = i & 15;
        const uint32_t a = lds<uint32_t>(xs + r * L.x_pitch + 4 * v);
        uint4 o;
        o.x = to_mma<R>(a, kE2M1Packed), o.y = to_mma<R>(a >> 8, kE2M1Packed);
        o.z = to_mma<R>(a >> 16, kE2M1Packed);
        o.w = to_mma<R>(a >> 24, kE2M1Packed);
        *reinterpret_cast<uint4*>(cx + r * L.cx_pitch + 16 * v) = o;
      }
    } else {
      // 8 codes of a row, one a byte -> 8 values
      for (int i = threadIdx.x; i < mt * 16; i += kThreads) {
        const int r = i >> 4, v = i & 15;
        const uint2 a = lds<uint2>(xs + r * L.x_pitch + 8 * v);
        uint4 o;
        o.x = to_mma<R>(a.x, fx), o.y = to_mma<R>(a.x >> 16, fx);
        o.z = to_mma<R>(a.y, fx), o.w = to_mma<R>(a.y >> 16, fx);
        *reinterpret_cast<uint4*>(cx + r * L.cx_pitch + 16 * v) = o;
      }
    }
  }
}

// Grid (N / bn * split, ceil(M / MT), E), clusters of (split, 1, 1): the
// cluster rank picks the K slice, blockIdx.x / split the column tile.
// Each warp takes k step `warp` (32 k) of every chunk for the whole tile.
// NAT: both sides in the route's own format, the layout a constant.
template <int MT8, int CT, int R, bool NAT>
__global__ void __launch_bounds__(kThreads)
dpa_prequant_kernel(const uint8_t* __restrict__ xq, int x_fmt,
                    const float* __restrict__ sx,
                    const uint8_t* __restrict__ wq, int w_fmt,
                    const float* __restrict__ sw, float* __restrict__ out,
                    int M, int K, int N, int split) {
  using Acc = std::conditional_t<R == kS8, int, float>;
  constexpr int MT = MT8 * 8, BN = CT * 16, TILE = MT * BN;
  const int fx = NAT ? native_fmt(R) : x_fmt;
  const int fw = NAT ? native_fmt(R) : w_fmt;
  const Layout L = layout(R, BN, MT, fx, fw);
  extern __shared__ __align__(16) uint8_t smem[];
  Acc* red = reinterpret_cast<Acc*>(smem);
  Acc* recv = reinterpret_cast<Acc*>(smem + L.recv);
  cg::cluster_group cluster = cg::this_cluster();
  // every rank must have started before any pushes into its recv
  if (split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n");

  const int rank = static_cast<int>(cluster.block_rank());
  // bytes of a row of x, of a weight row, of a ring chunk's x row
  const size_t x_ld = (size_t)K * nibbles(fx) / 2;
  const int w_es = fw >= kF16 ? 2 : 1;
  const size_t w_ld = (size_t)N * w_es;
  const int x_row = kChunk * nibbles(fx) / 2, w_row = BN * w_es;
  const size_t e = blockIdx.z;
  xq += e * M * x_ld;
  sx += e * M;
  wq += e * (size_t)K * N * nibbles(fw) / 2;
  sw += e * N;
  out += e * M * N;
  const int n0 = static_cast<int>(blockIdx.x) / split * BN;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int k_beg = rank * (K / split);        // this block's K slice
  const int nchunks = K / split / kChunk;

  // chunk c of the slice -> ring slot c % kStages; always one commit group
  auto fetch = [&](int c) {
    if (c < nchunks) {
      uint8_t* st = smem + (c % kStages) * L.stage;
      const int k0 = k_beg + c * kChunk;
      const uint8_t* wsrc = wq + (size_t)k0 * L.w_rows / kChunk * w_ld +
                            (size_t)n0 * w_es;
      const int wv = w_row / 16, wl = __ffs(wv) - 1;   // a power of 2
      for (int i = threadIdx.x; i < L.w_rows * wv; i += kThreads) {
        const int r = i >> wl, v = i & (wv - 1);
        cp_async16(st + r * L.w_pitch + v * 16, wsrc + r * w_ld + v * 16,
                   16);
      }
      uint8_t* xs = st + L.w_rows * L.w_pitch;
      const uint8_t* xsrc = xq + (size_t)k0 * nibbles(fx) / 2;
      const int xv = x_row / 16, xl = __ffs(xv) - 1;   // a power of 2
      for (int i = threadIdx.x; i < MT * xv; i += kThreads) {
        const int r = i >> xl, v = i & (xv - 1);
        const bool live = r < rows;
        cp_async16(xs + r * L.x_pitch + v * 16,
                   live ? xsrc + (m0 + r) * x_ld + v * 16 : xq,
                   live ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  Acc acc[CT][MT8][4];
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int rt = 0; rt < MT8; ++rt)
      acc[ct][rt][0] = acc[ct][rt][1] = acc[ct][rt][2] = acc[ct][rt][3] = 0;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) fetch(c);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's)
    __syncthreads();               // ... everyone's; chunk c - 1 is read
    fetch(c + kStages - 1);        // into chunk c - 1's slot

    const uint8_t* st = smem + (c % kStages) * L.stage;
    if (L.cw >= 0 || L.cx >= 0) {
      widen_chunk<R>(st, smem, L, BN, MT, fx, fw);
      __syncthreads();
    }
    const uint8_t* ws = L.cw >= 0 ? smem + L.cw : st;
    const uint8_t* xs = L.cx >= 0 ? smem + L.cx
                                  : st + L.w_rows * L.w_pitch;
    if constexpr (R == kS8) {
      uint32_t a[CT][4];
      load_a<CT>(a, ws + warp * 16 * L.cw_pitch, L.cw_pitch, g, t);
      const uint8_t* xw = xs + g * kXPitch + warp * 16 + 2 * t;
#pragma unroll
      for (int rt = 0; rt < MT8; ++rt) {
        const uint8_t* xr = xw + rt * 8 * kXPitch;
        const uint32_t b0 = codes_to_s8x4(lds<uint16_t>(xr));
        const uint32_t b1 = codes_to_s8x4(lds<uint16_t>(xr + 8));
#pragma unroll
        for (int ct = 0; ct < CT; ++ct) mma_s8(acc[ct][rt], a[ct], b0, b1);
      }
    } else {
      // two k16 steps: MMA row r of tile ct is output column 16 ct + r
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int kk = warp * 32 + s * 16;
        uint32_t a[CT][4];
#pragma unroll
        for (int ct = 0; ct < CT; ++ct)
          dpa::ldmatrix_x4_trans(
              a[ct], dpa::smem_u32(ws + (kk + (lane >> 4) * 8 + (lane & 7)) *
                                            L.cw_pitch +
                                   (16 * ct + ((lane >> 3) & 1) * 8) * 2));
        const uint8_t* xw = xs + g * L.cx_pitch + (kk + 2 * t) * 2;
#pragma unroll
        for (int rt = 0; rt < MT8; ++rt) {
          const uint8_t* xr = xw + rt * 8 * L.cx_pitch;
          const uint32_t b0 = lds<uint32_t>(xr), b1 = lds<uint32_t>(xr + 16);
#pragma unroll
          for (int ct = 0; ct < CT; ++ct) {
            if constexpr (R == kH16)
              dpa::mma_f16(acc[ct][rt], a[ct][0], a[ct][1], a[ct][2],
                           a[ct][3], b0, b1);
            else
              dpa::mma_bf16(acc[ct][rt], a[ct][0], a[ct][1], a[ct][2],
                            a[ct][3], b0, b1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it takes the warps' partials

  // C fragment of tile ct, row tile rt: c0, c1 at (MMA row g, rows 2t,
  // 2t + 1), c2, c3 at MMA row g + 8; MMA row -> output column as above
  Acc* rw = red + warp * TILE;
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int rt = 0; rt < MT8; ++rt) {
      const int col = R == kS8 ? 2 * CT * g + 2 * ct : 16 * ct + g;
      const int hi = R == kS8 ? 1 : 8;
      const int o = (rt * 8 + 2 * t) * BN + col;
      rw[o] = acc[ct][rt][0];
      rw[o + BN] = acc[ct][rt][1];
      rw[o + hi] = acc[ct][rt][2];
      rw[o + BN + hi] = acc[ct][rt][3];
    }
  __syncthreads();

  // the block's sum over its warps, pushed into the owning rank's slot
  // for this rank: rank r owns outputs [r * per, (r + 1) * per) of the tile
  const int per = share(BN, MT, split);
  if (split > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int idx = threadIdx.x; idx < rows * BN; idx += kThreads) {
    const Acc sum = red[idx] + red[TILE + idx] + red[2 * TILE + idx] +
                    red[3 * TILE + idx];
    const int owner = idx / per;
    Acc* dst = recv + rank * per + (idx - owner * per);
    if (split > 1) dst = cluster.map_shared_rank(dst, owner);
    *dst = sum;
  }
  if (split > 1)
    cluster.sync();   // the pushes have landed; nobody reads remotely after
  else
    __syncthreads();

  // epilogue over this rank's share: the ranks' sums, then the two scales
  for (int l = threadIdx.x; l < per; l += kThreads) {
    const int idx = rank * per + l;
    if (idx >= rows * BN) break;
    Acc sum = 0;
    for (int q = 0; q < split; ++q) sum += recv[q * per + l];
    const int m = m0 + idx / BN, n = n0 + idx % BN;
    float p;
    if constexpr (R == kS8)
      p = static_cast<float>(sum) * 0.25f;   // exact: |sum| < 2^24
    else
      p = sum;
    out[(size_t)m * N + n] = __fmul_rn(__fmul_rn(p, sx[m]), sw[n]);
  }
}

template <int MT8, int CT, int R, bool NAT>
int launch_as(const uint8_t* xq, int fx, const float* sx, const uint8_t* wq,
              int fw, const float* sw, float* out, int E, int M, int K,
              int N, int split, cudaStream_t s) {
  constexpr int MT = MT8 * 8, BN = CT * 16;
  const int smem =
      layout(R, BN, MT, fx, fw).recv + split * share(BN, MT, split) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dpa_prequant_kernel<MT8, CT, R, NAT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN * split, (M + MT - 1) / MT, E);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dpa_prequant_kernel<MT8, CT, R, NAT>, xq, fx, sx, wq, fw, sw,
      out, M, K, N, split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MT8, int CT, int R>
int launch(const uint8_t* xq, int fx, const float* sx, const uint8_t* wq,
           int fw, const float* sw, float* out, int E, int M, int K, int N,
           int split, cudaStream_t s) {
  if (native(R, fx) && native(R, fw))
    return launch_as<MT8, CT, R, true>(xq, fx, sx, wq, fw, sw, out, E, M, K,
                                       N, split, s);
  return launch_as<MT8, CT, R, false>(xq, fx, sx, wq, fw, sw, out, E, M, K,
                                      N, split, s);
}

template <int CT, int R>
int launch_rows(const uint8_t* xq, int fx, const float* sx,
                const uint8_t* wq, int fw, const float* sw, float* out,
                int E, int M, int K, int N, int split, cudaStream_t s) {
  if (M <= 8)
    return launch<1, CT, R>(xq, fx, sx, wq, fw, sw, out, E, M, K, N, split,
                            s);
  if (M <= 16)
    return launch<2, CT, R>(xq, fx, sx, wq, fw, sw, out, E, M, K, N, split,
                            s);
  if (M <= 32)
    return launch<4, CT, R>(xq, fx, sx, wq, fw, sw, out, E, M, K, N, split,
                            s);
  if constexpr (CT < 4)   // 64 rows x 64 columns: too many accumulators
    return launch<8, CT, R>(xq, fx, sx, wq, fw, sw, out, E, M, K, N, split,
                            s);
  return (int)cudaErrorInvalidValue;
}

template <int R>
int launch_cols(const uint8_t* xq, int fx, const float* sx,
                const uint8_t* wq, int fw, const float* sw, float* out,
                int E, int M, int K, int N, int bn, int split,
                cudaStream_t s) {
  if (bn == 16)
    return launch_rows<1, R>(xq, fx, sx, wq, fw, sw, out, E, M, K, N, split,
                             s);
  if (bn == 32)
    return launch_rows<2, R>(xq, fx, sx, wq, fw, sw, out, E, M, K, N, split,
                             s);
  return launch_rows<4, R>(xq, fx, sx, wq, fw, sw, out, E, M, K, N, split,
                           s);
}

}  // namespace

// xq: (E, M, K) codes in format x_fmt ((E, M, K/2) packed E2M1); sx: (E,
// M) f32 row scales.  wq: (E, K, N) codes in w_fmt ((E, K/2, N) packed
// E2M1); sw: (E, N) f32 column scales.  Formats: 0 packed E2M1, 1 E4M3,
// 2 E5M2, 3 E2M1 one code a byte, 4 fp16, 5 bf16; fp16 with bf16 is
// refused.  out: (E, M, N) f32.  A dense product is E = 1.  bn (16, 32
// or 64 output columns per block, at most 32 above 32 rows) and split
// (the cluster size, dividing K / 128) come from the wrapper's launch
// plan, which also holds K < 2^16; xq and wq must be 16-byte aligned.
extern "C" int dpa_prequant_launch(const void* xq, int x_fmt, const float* sx,
                                   const void* wq, int w_fmt, const float* sw,
                                   float* out, int E, int M, int K, int N,
                                   int bn, int split, void* stream) {
  if (K <= 0 || K % kChunk || K >= (1 << 16) || M <= 0 || E <= 0 ||
      E > 65535 || (bn != 16 && bn != 32 && bn != 64) || N <= 0 || N % bn ||
      split < 1 || split > 8 || (K / kChunk) % split || x_fmt < 0 ||
      x_fmt > kBF16 || w_fmt < 0 || w_fmt > kBF16 ||
      (x_fmt == kF16 && w_fmt == kBF16) || (x_fmt == kBF16 && w_fmt == kF16) ||
      (reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(wq)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x8 = static_cast<const uint8_t*>(xq);
  const uint8_t* w8 = static_cast<const uint8_t*>(wq);
  const auto fp4 = [](int f) { return f == kE2M1Packed || f == kE2M1; };
  if (fp4(x_fmt) && fp4(w_fmt))
    return launch_cols<kS8>(x8, x_fmt, sx, w8, w_fmt, sw, out, E, M, K, N,
                            bn, split, s);
  if (x_fmt == kBF16 || w_fmt == kBF16)
    return launch_cols<kB16>(x8, x_fmt, sx, w8, w_fmt, sw, out, E, M, K, N,
                             bn, split, s);
  return launch_cols<kH16>(x8, x_fmt, sx, w8, w_fmt, sw, out, E, M, K, N, bn,
                           split, s);
}
