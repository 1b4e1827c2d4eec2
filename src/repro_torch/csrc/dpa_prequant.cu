// dpa_matmul_prequant for Hopper (sm_90a): pre-quantized activations times
// pre-quantized weights, both packed E2M1 along K; dense, or one product
// per expert of a MoE layer.
//
// Replaces the Pallas TPU kernels repro/kernels/dpa_matmul.py
// dpa_matmul_prequant (_dpa_matmul_kernel) and
// repro/kernels/dpa_grouped_matmul.py dpa_grouped_matmul_prequant
// (_grouped_prequant_kernel), which is the same contract per expert.
//
// Contract, per expert e, row m and column n:
//   acc = sum_k e2m1(xq[m, k]) * e2m1(wq[k, n])
//   out = (acc * sx[m]) * sw[n]                        (two rounded products)
// xq is (E, M, K/2) and wq (E, K/2, N), codes packed two per byte along K
// (low nibble = even k); sx is (E, M) and sw (E, N), f32.
//
// What bounds it: at the serving shapes (8 to 64 rows per expert) each
// weight byte feeds 2 * M products, so the floor is the weight bytes over
// 3.35 TB/s: 0.16 us for one of granite-moe-1b's 1024 x 1024 attention
// projections (512 KB of codes), 2.5 us for a 32-expert 1024 x 512 stack
// (8 MB).  The dense calls are far below a launch and one DRAM round
// trip, so what a call costs there is latency: how many SMs work, and how
// many bytes each has in flight.  The design follows from that.
//
// 1. Exact integer tensor cores.  Each E2M1 code maps to the int8 value
//    2 * e2m1(c) (magnitudes 0, 1, 2, 3, 4, 6, 8, 12, sign from bit 3,
//    -0 -> 0) and the products run on mma.sync m16n8k32 s8 x s8 -> s32.
//    Then acc_int = 4 * acc, |acc_int| <= 144 K < 2^24 for K < 2^16 (the
//    wrapper's plan refuses larger K), so (float)acc_int * 0.25f is the
//    exact sum, which is also what the plain version's f32 sum is: every
//    partial sum of E2M1 products is a multiple of 1/4 below 2^22.  The
//    kernel equals its plain version bit for bit by construction, and any
//    split of K sums exactly.  The e4m3 tensor cores would not do: their
//    f32 accumulation keeps fewer bits on Hopper (DeepSeek-V3, arXiv
//    2412.19437, 3.3.2), and these sums need about 18.
//    M is small, so the product is taken swapped: 16 weight columns are
//    the MMA's 16-row side, 8 activation rows its n8 side; a block loops
//    over up to 8 such row tiles (64 rows), and grid y over more.
// 2. Split K across a thread-block cluster.  One block owns `bn` output
//    columns (16, 32 or 64) of up to 64 rows of one expert; at granite's
//    attention projections that is only 32 to 64 blocks for 132 SMs.  The
//    launch plan (kernels/dpa_matmul.py prequant_plan) picks the smallest
//    cluster size `split` <= 8 that brings the grid to 132 blocks; each
//    block of a cluster sums one K / split slice.  The int32 partials meet
//    through distributed shared memory: each rank pushes its sums for the
//    outputs another rank owns into that rank's shared memory (stores do
//    not wait, remote loads would), one cluster barrier, and each rank
//    finishes and writes 1/split of the tile.  One launch, no workspace,
//    no atomics, and the result does not depend on the split (integer
//    sums).
// 3. Wide loads, several in flight.  A ring of kStages chunks of 128 k is
//    filled with 16-byte cp.async copies (the weight rows are contiguous
//    along N and keep the op's layout; rows past M are zero-filled, never
//    read), three chunks ahead of the MMAs.  The MMA fragments are read
//    from the ring as they are: Hopper has no 8-bit ldmatrix.trans, so
//    instead of transposing the weights, each thread's 16-column MMA rows
//    are mapped to output columns that sit side by side in memory, and
//    one __byte_perm pairs two packed rows into a column's four codes.
//    The row pitches put every fragment load of a warp on its own bank.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 128;               // k per ring stage
constexpr int kChunkBytes = kChunk / 2;   // packed rows of weights a stage
constexpr int kStages = 4;
constexpr int kWarps = 4;                 // one k step of 32 each per chunk
constexpr int kThreads = kWarps * 32;
static_assert(kWarps * 32 == kChunk, "warp w takes k step w of a chunk");
// Row pitches of the ring (bytes, multiples of 16 for cp.async): the
// fragment loads of a warp then fall on distinct banks (lane g, t reads
// weight row 2t + h, x row g; see the kernel).
constexpr int kXPitch = kChunkBytes + 16;
__host__ __device__ constexpr int w_pitch(int bn) {
  return bn + 16 > 48 ? bn + 16 : 48;
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

// Shared memory: the ring (kStages x [64 weight rows, pitch w_pitch(bn)]
// [MT x rows, pitch kXPitch]); after the main loop the same bytes hold the
// warps' int32 partials (kWarps x MT x bn); then `recv`, split slots of
// the tile share this rank reduces, which the cluster's ranks push into.
__host__ __device__ constexpr int stage_bytes(int bn, int mt) {
  return kChunkBytes * w_pitch(bn) + mt * kXPitch;
}
__host__ __device__ constexpr int share(int bn, int mt, int split) {
  return (mt * bn + split - 1) / split;
}
__host__ __device__ constexpr int recv_offset(int bn, int mt) {
  return kStages * stage_bytes(bn, mt) > kWarps * mt * bn * 4
             ? kStages * stage_bytes(bn, mt)
             : kWarps * mt * bn * 4;
}
__host__ __device__ constexpr int smem_bytes(int bn, int mt, int split) {
  return recv_offset(bn, mt) + split * share(bn, mt, split) * 4;
}

// Grid (N / bn * split, ceil(M / MT), E), clusters of (split, 1, 1): the
// cluster rank picks the K slice, blockIdx.x / split the column tile.
// Each warp takes k step `warp` of every chunk for the whole tile.
template <int MT8, int CT>
__global__ void __launch_bounds__(kThreads)
dpa_prequant_kernel(const uint8_t* __restrict__ xq,
                    const float* __restrict__ sx,
                    const uint8_t* __restrict__ wq,
                    const float* __restrict__ sw, float* __restrict__ out,
                    int M, int K, int N, int split) {
  constexpr int MT = MT8 * 8, BN = CT * 16, TILE = MT * BN;
  constexpr int WP = w_pitch(BN), SB = stage_bytes(BN, MT);
  extern __shared__ __align__(16) uint8_t smem[];
  int* red = reinterpret_cast<int*>(smem);
  int* recv = reinterpret_cast<int*>(smem + recv_offset(BN, MT));
  cg::cluster_group cluster = cg::this_cluster();
  // every rank must have started before any pushes into its recv
  if (split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n");

  const int rank = static_cast<int>(cluster.block_rank());
  const int kb = K / 2;
  const size_t e = blockIdx.z;
  xq += e * M * kb;
  sx += e * M;
  wq += e * kb * N;
  sw += e * N;
  out += e * M * N;
  const int n0 = static_cast<int>(blockIdx.x) / split * BN;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int kp_beg = rank * (kb / split);      // this block's K slice
  const int nchunks = K / split / kChunk;

  // chunk c of the slice -> ring slot c % kStages; always one commit group
  auto fetch = [&](int c) {
    if (c < nchunks) {
      uint8_t* st = smem + (c % kStages) * SB;
      const int kp0 = kp_beg + c * kChunkBytes;
      for (int i = threadIdx.x; i < kChunkBytes * CT; i += kThreads) {
        const int r = i / CT, v = i % CT;
        cp_async16(st + r * WP + v * 16,
                   wq + (size_t)(kp0 + r) * N + n0 + v * 16, 16);
      }
      uint8_t* xs = st + kChunkBytes * WP;
      for (int i = threadIdx.x; i < MT * 4; i += kThreads) {
        const int r = i >> 2, v = i & 3;
        const bool live = r < rows;
        cp_async16(xs + r * kXPitch + v * 16,
                   live ? xq + (size_t)(m0 + r) * kb + kp0 + v * 16 : xq,
                   live ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int acc[CT][MT8][4];
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

    const uint8_t* st = smem + (c % kStages) * SB;
    uint32_t a[CT][4];
    load_a<CT>(a, st + warp * 16 * WP, WP, g, t);
    const uint8_t* xs = st + kChunkBytes * WP + g * kXPitch + warp * 16 +
                        2 * t;
#pragma unroll
    for (int rt = 0; rt < MT8; ++rt) {
      const uint8_t* xr = xs + rt * 8 * kXPitch;
      const uint32_t b0 = codes_to_s8x4(lds<uint16_t>(xr));
      const uint32_t b1 = codes_to_s8x4(lds<uint16_t>(xr + 8));
#pragma unroll
      for (int ct = 0; ct < CT; ++ct) mma_s8(acc[ct][rt], a[ct], b0, b1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it takes the warps' partials

  // C fragment of tile ct, row tile rt: c0, c1 at (column 2 CT g + 2 ct,
  // rows 2t, 2t + 1), c2, c3 at the next column
  int* rw = red + warp * TILE;
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int rt = 0; rt < MT8; ++rt) {
      const int o = (rt * 8 + 2 * t) * BN + 2 * CT * g + 2 * ct;
      rw[o] = acc[ct][rt][0];
      rw[o + BN] = acc[ct][rt][1];
      rw[o + 1] = acc[ct][rt][2];
      rw[o + BN + 1] = acc[ct][rt][3];
    }
  __syncthreads();

  // the block's sum over its warps, pushed into the owning rank's slot
  // for this rank: rank r owns outputs [r * per, (r + 1) * per) of the tile
  const int per = share(BN, MT, split);
  if (split > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int idx = threadIdx.x; idx < rows * BN; idx += kThreads) {
    const int sum = red[idx] + red[TILE + idx] + red[2 * TILE + idx] +
                    red[3 * TILE + idx];
    const int owner = idx / per;
    int* dst = recv + rank * per + (idx - owner * per);
    if (split > 1) dst = cluster.map_shared_rank(dst, owner);
    *dst = sum;
  }
  if (split > 1)
    cluster.sync();   // the pushes have landed; nobody reads remotely after
  else
    __syncthreads();

  // epilogue over this rank's share: exact int sum, then the two scales
  for (int l = threadIdx.x; l < per; l += kThreads) {
    const int idx = rank * per + l;
    if (idx >= rows * BN) break;
    int sum = 0;
    for (int q = 0; q < split; ++q) sum += recv[q * per + l];
    const int m = m0 + idx / BN, n = n0 + idx % BN;
    const float p = static_cast<float>(sum) * 0.25f;   // exact: |sum| < 2^24
    out[(size_t)m * N + n] = __fmul_rn(__fmul_rn(p, sx[m]), sw[n]);
  }
}

template <int MT8, int CT>
int launch(const uint8_t* xq, const float* sx, const uint8_t* wq,
           const float* sw, float* out, int E, int M, int K, int N,
           int split, cudaStream_t s) {
  constexpr int MT = MT8 * 8;
  const int smem = smem_bytes(CT * 16, MT, split);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dpa_prequant_kernel<MT8, CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / (CT * 16) * split, (M + MT - 1) / MT, E);
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
      &cfg, dpa_prequant_kernel<MT8, CT>, xq, sx, wq, sw, out, M, K, N,
      split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int CT>
int launch_rows(const uint8_t* xq, const float* sx, const uint8_t* wq,
                const float* sw, float* out, int E, int M, int K, int N,
                int split, cudaStream_t s) {
  if (M <= 8) return launch<1, CT>(xq, sx, wq, sw, out, E, M, K, N, split, s);
  if (M <= 16)
    return launch<2, CT>(xq, sx, wq, sw, out, E, M, K, N, split, s);
  if (M <= 32)
    return launch<4, CT>(xq, sx, wq, sw, out, E, M, K, N, split, s);
  if constexpr (CT < 4)   // 64 rows x 64 columns: too many accumulators
    return launch<8, CT>(xq, sx, wq, sw, out, E, M, K, N, split, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xq: (E, M, K/2) packed E2M1; sx: (E, M) f32 row scales.
// wq: (E, K/2, N) packed E2M1; sw: (E, N) f32 column scales.
// out: (E, M, N) f32.  A dense product is E = 1.  bn (16, 32 or 64
// output columns per block, at most 32 above 32 rows) and split (the
// cluster size, dividing K / 128) come from the wrapper's launch plan,
// which also holds K < 2^16; xq and wq must be 16-byte aligned.
extern "C" int dpa_prequant_launch(const void* xq, const float* sx,
                                   const void* wq, const float* sw,
                                   float* out, int E, int M, int K, int N,
                                   int bn, int split, void* stream) {
  if (K <= 0 || K % kChunk || K >= (1 << 16) || M <= 0 || E <= 0 ||
      E > 65535 || (bn != 16 && bn != 32 && bn != 64) || N <= 0 || N % bn ||
      split < 1 || split > 8 || (K / kChunk) % split ||
      (reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(wq)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x8 = static_cast<const uint8_t*>(xq);
  const uint8_t* w8 = static_cast<const uint8_t*>(wq);
  if (bn == 16)
    return launch_rows<1>(x8, sx, w8, sw, out, E, M, K, N, split, s);
  if (bn == 32)
    return launch_rows<2>(x8, sx, w8, sw, out, E, M, K, N, split, s);
  return launch_rows<4>(x8, sx, w8, sw, out, E, M, K, N, split, s);
}
