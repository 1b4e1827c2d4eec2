// quantize_rows and quantize_pack_rows for Hopper (sm_90a): per-row
// absmax quantization of an (M, K) f32/bf16 matrix onto a DPA operand
// grid, with the E2M1 codes optionally packed two per byte.
//
// Replaces the Pallas TPU kernels repro/kernels/quantize.py quantize_rows
// (_quantize_kernel) and quantize_pack_rows (_quantize_pack_kernel).
//
// Contract, per row:
//   scale = max(max(amax, 1e-30) * f32(1/target), 2^-126)
//   y     = clip(x / scale, -target, target)           (IEEE division)
//   code  = E4M3 / E5M2 / fp16 / bf16 round-to-nearest-even cast of y, y
//           itself (f32), or the E2M1 code of y (one per byte, or two per
//           byte with the even index in the low nibble when packed)
// with target 448 (E4M3), 6 (E2M1) and 2^14 (fp16, bf16, E5M2 and f32,
// the format table's cap).  Codes and scales are bit-identical to the
// plain version.
//
// What bounds it: bytes — one read of x and one write of the codes and
// scales (qwen3-4b's MLP activations, 4096 x 9728 bf16 to E4M3, move 120
// MB: 0.036 ms at 3.35 TB/s).
//
// Design (the launch plan is kernels/quantize.py:quantize_plan):
// - A row belongs to a group of `lanes` threads: a power of two up to 32
//   for short rows (several rows a warp, the absmax by a segmented
//   shuffle), or whole warps, one row a block, for long ones (the absmax
//   through shared memory).
// - A row is cut into chunks: 16 bytes of x (8 bf16 or 4 f32, one vector
//   load) on the vector route, two elements loaded one at a time on the
//   scalar route (a K or a base that is not 16-byte aligned).  Thread t
//   of a group takes chunks t, t + lanes, ...: up to kMaxVecs of them,
//   all loaded before the first is used, and kept in registers from the
//   absmax to the cast, so x is read once.  A row longer than lanes x
//   kMaxVecs chunks (the plan's reread routes) is walked in tiles, once
//   for the absmax and once more to quantize.
// - Codes leave as one store a chunk (8 bytes of E4M3 / E5M2 / E2M1
//   codes, 4 of packed E2M1, 16 of fp16 / bf16, 32 of f32 for 8 bf16),
//   cast two at a time (cvt ...x2); E2M1 keeps encode_fp4's threshold
//   compares (sm_90a has no E2M1 convert), three a code by bisection.
// - Four chunks a thread at most: at 50 registers or fewer an SM keeps
//   more rows in flight than with room for eight at 64
//   (tools/quantize_rows_ablation.py, PERF.md).
#include <cuda_fp16.h>

#include "dpa_common.cuh"

namespace {

constexpr int kMaxVecs = 4;      // chunks a thread holds (the plan's nv cap)
constexpr int kMaxThreads = 1024;

constexpr int kQE4M3 = 0;
constexpr int kQE2M1 = 1;
constexpr int kQE2M1Packed = 2;
constexpr int kQF16 = 3;
constexpr int kQBF16 = 4;
constexpr int kQE5M2 = 5;
constexpr int kQF32 = 6;

template <int FMT>
struct Target {
  static constexpr bool kWide = FMT >= kQF16;          // the 2^14 cap
  static constexpr float max = FMT == kQE4M3 ? dpa::kE4M3Max
                               : kWide      ? 16384.0f
                                            : dpa::kE2M1Max;
  static constexpr float inv = FMT == kQE4M3 ? dpa::kInvE4M3Max
                               : kWide      ? 1.0f / 16384.0f
                                            : dpa::kInvE2M1Max;
};

// x / scale, clipped to +-target.  The E2M1 encode saturates by itself
// (every |y| above 5 is code 7), so its clip is left out.
template <int FMT>
__device__ __forceinline__ float clip_div(float x, float scale) {
  const float y = __fdiv_rn(x, scale);
  if constexpr (FMT == kQE2M1 || FMT == kQE2M1Packed) return y;
  return fminf(fmaxf(y, -Target<FMT>::max), Target<FMT>::max);
}

// One chunk of x: 16 bytes (VEC), or two elements loaded one at a time,
// the second zero past the row's end.
template <typename XT, bool VEC>
struct Chunk;

template <>
struct Chunk<float, true> {
  static constexpr int W = 4;
  uint4 u;
  __device__ __forceinline__ void load(const float* r, int k, int) {
    u = *reinterpret_cast<const uint4*>(r + k);
  }
  __device__ __forceinline__ void get(float (&f)[W]) const {
    f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Chunk<__nv_bfloat16, true> {
  static constexpr int W = 8;
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* r, int k, int) {
    u = *reinterpret_cast<const uint4*>(r + k);
  }
  __device__ __forceinline__ void get(float (&f)[W]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

template <typename XT>
struct Chunk<XT, false> {
  static constexpr int W = 2;
  float v[2];
  __device__ __forceinline__ void load(const XT* r, int k, int K) {
    v[0] = dpa::to_f32(r[k]);
    v[1] = k + 1 < K ? dpa::to_f32(r[k + 1]) : 0.0f;
  }
  __device__ __forceinline__ void get(float (&f)[W]) const {
    f[0] = v[0], f[1] = v[1];
  }
};

// The E2M1 code of y: dpa::encode_fp4's thresholds and strictness (>
// 0.25, >= 0.75, > 1.25, >= 1.75, > 2.5, >= 3.5, > 5: round to nearest
// even), found by bisection in three compares instead of seven; -0.0 and
// NaN give code 0.
__device__ __forceinline__ uint32_t encode_e2m1(float y) {
  const float a = fabsf(y);
  const bool hi = a >= 1.75f;                              // codes 4-7
  const bool mid = a >= (hi ? 3.5f : 0.75f);               // 6-7 or 2-3
  const float t = hi ? (mid ? 5.0f : 2.5f) : (mid ? 1.25f : 0.25f);
  const uint32_t c = (hi ? 4u : 0u) + (mid ? 2u : 0u) + (a > t ? 1u : 0u);
  return c | (y < 0.0f ? 8u : 0u);
}

// Two clipped quotients -> their codes' bits, the first in the low half.
template <int FMT>
__device__ __forceinline__ uint32_t code_pair(float a, float b) {
  if constexpr (FMT == kQE4M3 || FMT == kQE5M2) {
    return __nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE,
                                    FMT == kQE4M3 ? __NV_E4M3 : __NV_E5M2);
  } else if constexpr (FMT == kQE2M1) {
    return encode_e2m1(a) | (encode_e2m1(b) << 8);
  } else if constexpr (FMT == kQE2M1Packed) {
    return encode_e2m1(a) | (encode_e2m1(b) << 4);
  } else if constexpr (FMT == kQF16) {
    const __half2 h = __float22half2_rn(make_float2(a, b));
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(a, b));
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// Bits of one code pair: 8 (packed E2M1), 16 (byte codes), 32 (fp16 /
// bf16) or 64 (f32, handled apart).
template <int FMT>
constexpr int kPairBits = FMT == kQE2M1Packed ? 8
                          : (FMT == kQF16 || FMT == kQBF16) ? 32
                          : FMT == kQF32                    ? 64
                                                            : 16;

template <int NB>
__device__ __forceinline__ void put(void* p, const uint32_t* w) {
  if constexpr (NB == 2) {
    *static_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
  } else if constexpr (NB == 4) {
    *static_cast<uint32_t*>(p) = w[0];
  } else if constexpr (NB == 8) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i)
      static_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
}

// The codes of one whole chunk (y[0] at code index i of the row-major
// code matrix; i is a multiple of W), one aligned store.
template <int FMT, int W>
__device__ __forceinline__ void store_chunk(void* codes, size_t i,
                                            const float (&y)[W]) {
  constexpr int kBits = kPairBits<FMT>;
  constexpr int kBytes = W / 2 * kBits / 8;
  uint32_t w[kBytes >= 4 ? kBytes / 4 : 1] = {};
  if constexpr (FMT == kQF32) {
#pragma unroll
    for (int e = 0; e < W; ++e) w[e] = __float_as_uint(y[e]);
  } else {
#pragma unroll
    for (int p = 0; p < W / 2; ++p) {
      const uint32_t c = code_pair<FMT>(y[2 * p], y[2 * p + 1]);
      w[p * kBits / 32] |= c << (p * kBits % 32);
    }
  }
  constexpr int kCodeBits = kBits / 2;
  put<kBytes>(static_cast<uint8_t*>(codes) + i * kCodeBits / 8, w);
}

// The scalar route's chunk: two codes (the second only where second),
// stored one at a time; packed E2M1 rows have an even K, so a chunk is
// one whole byte.
template <int FMT>
__device__ __forceinline__ void store_pair(void* codes, size_t i, float a,
                                           float b, bool second) {
  if constexpr (FMT == kQF32) {
    float* c = static_cast<float*>(codes) + i;
    c[0] = a;
    if (second) c[1] = b;
  } else if constexpr (FMT == kQE2M1Packed) {
    static_cast<uint8_t*>(codes)[i / 2] =
        static_cast<uint8_t>(code_pair<FMT>(a, b));
  } else if constexpr (kPairBits<FMT> == 32) {
    const uint32_t c = code_pair<FMT>(a, b);
    uint16_t* p = static_cast<uint16_t*>(codes) + i;
    p[0] = static_cast<uint16_t>(c);
    if (second) p[1] = static_cast<uint16_t>(c >> 16);
  } else {
    const uint32_t c = code_pair<FMT>(a, b);
    uint8_t* p = static_cast<uint8_t*>(codes) + i;
    p[0] = static_cast<uint8_t>(c);
    if (second) p[1] = static_cast<uint8_t>(c >> 8);
  }
}

// Block = (blockDim.x / lanes) rows of `lanes` threads; thread t of a row
// holds up to nv chunks a tile.  lanes is a power of two <= 32 (then
// blockDim.x is a multiple of 32) or blockDim.x itself (one row a block).
template <typename XT, int FMT, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
quantize_rows_kernel(const XT* __restrict__ x, void* __restrict__ codes,
                     float* __restrict__ scales, int M, int K, int lanes,
                     int nv) {
  using C = Chunk<XT, VEC>;
  constexpr int W = C::W;
  const int t = threadIdx.x % lanes;
  const int row = blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  const bool live = row < M;
  const XT* xr = x + (size_t)(live ? row : 0) * K;
  const int chunks = (K + W - 1) / W;
  const int span = lanes * nv;                // chunks a tile covers
  const int tiles = (chunks + span - 1) / span;

  C c[kMaxVecs];
  float a = 0.0f;
  for (int j = 0; j < tiles; ++j) {
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i) {
      const int q = j * span + i * lanes + t;
      if (live && i < nv && q < chunks) c[i].load(xr, q * W, K);
    }
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i) {
      const int q = j * span + i * lanes + t;
      if (live && i < nv && q < chunks) {
        float f[W];
        c[i].get(f);
#pragma unroll
        for (int e = 0; e < W; ++e) a = fmaxf(a, fabsf(f[e]));
      }
    }
  }
  if (lanes <= 32) {
    for (int o = lanes >> 1; o > 0; o >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  } else {
    __shared__ float red[kMaxThreads / 32];
    a = dpa::warp_max(a);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = a;
    __syncthreads();
    a = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) a = fmaxf(a, red[w]);
  }
  const float s = dpa::block_scale(a, Target<FMT>::inv);
  if (live && t == 0) scales[row] = s;

  const size_t base = (size_t)(live ? row : 0) * K;
  for (int j = 0; j < tiles; ++j) {
    if (tiles > 1) {                           // the reread routes
#pragma unroll
      for (int i = 0; i < kMaxVecs; ++i) {
        const int q = j * span + i * lanes + t;
        if (live && i < nv && q < chunks) c[i].load(xr, q * W, K);
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i) {
      const int q = j * span + i * lanes + t;
      if (live && i < nv && q < chunks) {
        float y[W];
        c[i].get(y);
#pragma unroll
        for (int e = 0; e < W; ++e) y[e] = clip_div<FMT>(y[e], s);
        if constexpr (VEC) {
          store_chunk<FMT, W>(codes, base + (size_t)q * W, y);
        } else {
          store_pair<FMT>(codes, base + (size_t)q * W, y[0], y[1],
                          q * W + 1 < K);
        }
      }
    }
  }
}

template <typename XT, int FMT>
cudaError_t launch_fmt(const XT* x, void* codes, float* scales, int M, int K,
                       int vec, int lanes, int rows, int nv,
                       cudaStream_t stream) {
  const dim3 grid((M + rows - 1) / rows), block(lanes * rows);
  if (vec)
    quantize_rows_kernel<XT, FMT, true><<<grid, block, 0, stream>>>(
        x, codes, scales, M, K, lanes, nv);
  else
    quantize_rows_kernel<XT, FMT, false><<<grid, block, 0, stream>>>(
        x, codes, scales, M, K, lanes, nv);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch(const void* xv, void* codes, float* scales, int M, int K,
                   int fmt, int vec, int lanes, int rows, int nv,
                   cudaStream_t s) {
  const XT* x = static_cast<const XT*>(xv);
  switch (fmt) {
    case kQE4M3:
      return launch_fmt<XT, kQE4M3>(x, codes, scales, M, K, vec, lanes, rows,
                                    nv, s);
    case kQE2M1:
      return launch_fmt<XT, kQE2M1>(x, codes, scales, M, K, vec, lanes, rows,
                                    nv, s);
    case kQE2M1Packed:
      return launch_fmt<XT, kQE2M1Packed>(x, codes, scales, M, K, vec, lanes,
                                          rows, nv, s);
    case kQF16:
      return launch_fmt<XT, kQF16>(x, codes, scales, M, K, vec, lanes, rows,
                                   nv, s);
    case kQBF16:
      return launch_fmt<XT, kQBF16>(x, codes, scales, M, K, vec, lanes, rows,
                                    nv, s);
    case kQE5M2:
      return launch_fmt<XT, kQE5M2>(x, codes, scales, M, K, vec, lanes, rows,
                                    nv, s);
    default:
      return launch_fmt<XT, kQF32>(x, codes, scales, M, K, vec, lanes, rows,
                                   nv, s);
  }
}

}  // namespace

// x: (M, K) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), contiguous.  fmt: 0
// E4M3 (codes (M, K) bytes), 1 E2M1 (one code per byte), 2 packed E2M1
// ((M, K/2) bytes, K even), 3 fp16, 4 bf16 ((M, K) 16-bit codes), 5 E5M2
// ((M, K) bytes), 6 f32 ((M, K) f32).  scales: (M,) f32.  The plan
// (kernels/quantize.py:quantize_plan): vec 1 for 16-byte chunks (K a
// multiple of 16 / element bytes, x 16-byte aligned), 0 for pairs of
// scalar loads; lanes threads a row (a power of two <= 32, or a multiple
// of 32 with rows = 1), rows a block, nv chunks a thread holds (<= 8).
extern "C" int quantize_rows_launch(const void* x, int x_bf16, void* codes,
                                    float* scales, int M, int K, int fmt,
                                    int vec, int lanes, int rows, int nv,
                                    void* stream) {
  const int w = x_bf16 ? 8 : 4;                // elements of a 16-byte chunk
  const bool group = lanes >= 1 && lanes <= 32 && !(lanes & (lanes - 1));
  const bool warps = lanes > 32 && lanes % 32 == 0 && rows == 1;
  if (M <= 0 || K <= 0 || fmt < kQE4M3 || fmt > kQF32 ||
      (fmt == kQE2M1Packed && K % 2) || !(group || warps) || rows < 1 ||
      lanes * rows > kMaxThreads || (lanes * rows) % 32 || nv < 1 ||
      nv > kMaxVecs ||
      (vec && (K % w || reinterpret_cast<uintptr_t>(x) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_bf16 ? launch<__nv_bfloat16>(x, codes, scales, M, K, fmt,
                                               vec, lanes, rows, nv, s)
                      : launch<float>(x, codes, scales, M, K, fmt, vec,
                                      lanes, rows, nv, s));
}
