// Tile routines of the SSD scan's kernels, shared by ssd_train.cu (the
// forward: the scores, the chunk states, the scan over chunks and y) and
// ssd_grad.cu (the training backward): 128 threads
// own a 64 x 64 tile of outputs, 8 x 4 a thread (rows 4 ty + r and 32 + 4
// ty + r, columns 4 tx + q), fed from k-major shared tiles whose rows are
// padded to 68 words; all arithmetic float32. Inputs of a type chosen at
// run time (F32, BF16, F16) are read as raw bits and widened on the way
// into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spm_tiles.cuh"

namespace ssd {

constexpr int kThr = 128;           // threads of the tiled kernels
constexpr int kT = 64;              // tile edge
constexpr int kLd = kT + 4;         // words per row of a shared tile
constexpr int kK = 32;              // K slab

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int n_pad(int N) { return ceil_div(N, kK) * kK; }

__device__ __forceinline__ bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// row r of the thread's 8 x 4 block
__device__ __forceinline__ int row_of(int ty, int r) { return (r < 4 ? 0 : 32) + 4 * ty + (r & 3); }

// acc[r][q] += sum_{k < kend} a[k][row_of(ty, r)] * b[k][4 tx + q] over two
// k-major [K][kLd] tiles (kend <= K, a multiple of 8)
template <int K>
__device__ __forceinline__ void tile_fma(const float* a, const float* b, int ty, int tx,
                                         float (&acc)[8][4], int kend = K) {
#pragma unroll 8
  for (int k = 0; k < kend; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * kLd + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * kLd + 32 + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * kLd + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bq[q], acc[r][q]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
}

// dst[k][i] = src row (i0 + i), element k0 + k, for k < nk (a multiple of
// 8) and i < kT; zero for rows at or past `rows` and elements at or past N.
// `row_at(i)` is the offset of row i in src. Lane l of warp w copies
// elements 8 v + l % 8 of rows 4 (w + 4 u) + l / 8 (u < 4): each copy's
// write k * kLd + i reaches 32 banks across the warp, its reads are
// 32-byte runs, and the four row offsets are reckoned once.
template <typename RowAt>
__device__ __forceinline__ void copy_transposed(float* dst, const float* src, RowAt row_at,
                                                int i0, int rows, int k0, int nk, int N) {
  static_assert(kThr == 128 && kT == 64, "four warps cover 64 rows");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kl = lane & 7, il = lane >> 3;
  const float* rp[4];
  bool rin[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = 4 * (warp + 4 * u) + il;
    rin[u] = i0 + i < rows;
    rp[u] = rin[u] ? src + row_at(i0 + i) + k0 + kl : src;
  }
  for (int v = 0; v < nk / 8; ++v) {
    const bool kin = k0 + 8 * v + kl < N;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = rin[u] && kin;
      spm::cp_async4(dst + (8 * v + kl) * kLd + 4 * (warp + 4 * u) + il, in ? rp[u] + 8 * v : src,
                     in);
    }
  }
}

// dst[k][w] = src[k0 + k][w0 + w] of a row-major [K][W] source, k < R,
// w < kT; zero past K or W. 16-byte copies when `vec` (W % 4 == 0 and src
// 16-byte aligned), else 4-byte ones; thread t copies the same columns of
// rows t / (copies a row) + (rows a pass) m.
template <int R>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int64_t row_stride,
                                          int k0, int K, int w0, int W, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kPer = kT / 4, kStep = kThr / kPer;     // 16 copies a row, 8 rows a pass
    const int kt = tid / kPer, w = tid % kPer * 4;
    const bool win = w0 + w < W;
    const float* sp = src + (int64_t)(k0 + kt) * row_stride + w0 + w;
#pragma unroll
    for (int m = 0; m < R / kStep; ++m) {
      const bool in = win && k0 + kt + kStep * m < K;
      spm::cp_async16(dst + (kt + kStep * m) * kLd + w,
                      in ? sp + (int64_t)kStep * m * row_stride : src, in);
    }
  } else {
    constexpr int kStep = kThr / kT;                      // 2 rows a pass
    const int kt = tid / kT, w = tid % kT;
    const bool win = w0 + w < W;
    const float* sp = src + (int64_t)(k0 + kt) * row_stride + w0 + w;
#pragma unroll
    for (int m = 0; m < R / kStep; ++m) {
      const bool in = win && k0 + kt + kStep * m < K;
      spm::cp_async4(dst + (kt + kStep * m) * kLd + w,
                     in ? sp + (int64_t)kStep * m * row_stride : src, in);
    }
  }
}

constexpr int kTile = kT * kLd;     // floats of a 64 x 68 shared tile
constexpr int kPerThread = kT * kT / kThr;  // a thread's elements of a 64 x 64 tile

// shared memory of `tiles` 64 x 68 tiles and a chunk's cum and dt
inline size_t tiles_smem(int tiles, int cs) {
  return sizeof(float) * ((size_t)tiles * kTile + 2 * (size_t)cs);
}

// element i of a tensor of type `dtype` = v, rounded to nearest even
__device__ __forceinline__ void st(void* p, int dtype, int64_t i, float v) {
  if (dtype == BF16)
    spm::store(static_cast<__nv_bfloat16*>(p) + i, v);
  else if (dtype == F16)
    spm::store(static_cast<__half*>(p) + i, v);
  else
    static_cast<float*>(p)[i] = v;
}

// the raw bits of element i of a tensor of type `dtype`, and their value
__device__ __forceinline__ uint32_t bits_of(const void* p, int dtype, int64_t i) {
  return dtype == F32 ? __float_as_uint(static_cast<const float*>(p)[i])
                      : (uint32_t) static_cast<const uint16_t*>(p)[i];
}
__device__ __forceinline__ float value_of(uint32_t v, int dtype) {
  if (dtype == BF16) return __uint_as_float(v << 16);
  if (dtype == F16) return __half2float(__ushort_as_half((unsigned short)v));
  return __uint_as_float(v);
}
// element i, widened
__device__ __forceinline__ float ld(const void* p, int dtype, int64_t i) {
  return value_of(bits_of(p, dtype, i), dtype);
}

// A 64 x 64 tile on its way to shared memory through registers: fetch_*
// issues the thread's 32 loads (raw bits; nothing waits on them, so they
// stay in flight while the block computes on the last tile), put_* converts
// them and stores f(., ., value). Transposed: dst[k][i] from src[row_at(i0 +
// i) + k0 + k], lane l of warp w on elements 8 v + l % 8 of rows 4 (w + 4 u)
// + l / 8 (32-byte runs of a row are read, and a warp's stores reach 32
// banks). Row-major: dst[k][w] from src[row_at(k0 + k) + w0 + w], thread t
// on element t + 128 m. Elements outside [rows) x [K) hold 0 before f.
struct Staged {
  uint32_t v[kPerThread];

  template <typename RowAt>
  __device__ __forceinline__ void fetch_t(const void* src, int dtype, RowAt row_at, int i0,
                                          int rows, int k0, int K) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int kl = lane & 7, il = lane >> 3;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * (warp + 4 * u) + il;
      const bool rin = i0 + i < rows;
      const int64_t base = rin ? row_at(i0 + i) + k0 : 0;
#pragma unroll
      for (int w = 0; w < kT / 8; ++w) {
        const int k = 8 * w + kl;
        v[8 * u + w] = rin && k0 + k < K ? bits_of(src, dtype, base + k) : 0u;
      }
    }
  }
  template <typename F>
  __device__ __forceinline__ void put_t(float* dst, int dtype, F f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int kl = lane & 7, il = lane >> 3;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * (warp + 4 * u) + il;
#pragma unroll
      for (int w = 0; w < kT / 8; ++w) {
        const int k = 8 * w + kl;
        dst[k * kLd + i] = f(i, k, value_of(v[8 * u + w], dtype));
      }
    }
  }
  template <typename RowAt>
  __device__ __forceinline__ void fetch_rows(const void* src, int dtype, RowAt row_at, int k0,
                                             int K, int w0, int W) {
    const int w = threadIdx.x % kT, k1 = threadIdx.x / kT;
    const bool win = w0 + w < W;
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
      const int k = k1 + (kThr / kT) * m;
      v[m] = win && k0 + k < K ? bits_of(src, dtype, row_at(k0 + k) + w0 + w) : 0u;
    }
  }
  template <typename F>
  __device__ __forceinline__ void put_rows(float* dst, int dtype, F f) const {
    const int w = threadIdx.x % kT, k1 = threadIdx.x / kT;
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
      const int k = k1 + (kThr / kT) * m;
      dst[k * kLd + w] = f(k, w, value_of(v[m], dtype));
    }
  }
};

__device__ __forceinline__ float same(int, int, float v) { return v; }

// the sum over the 16 lanes (tx) that share a thread's rows
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the block's sum, in a fixed order (every thread gets it)
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();                        // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// the tile pair (it >= jt) of index p of the lower triangle, row by row
__device__ __forceinline__ void tri_pair(int p, int& it, int& jt) {
  it = 0;
  while ((it + 1) * (it + 2) / 2 <= p) ++it;
  jt = p - it * (it + 1) / 2;
}

// the shapes the training launchers take: positive sizes, whole chunks,
// groups dividing the heads, int32 lengths, grids within 2^31 - 1 blocks
inline bool train_shapes_ok(int64_t Bz, int64_t S, int64_t H, int64_t P, int64_t N, int64_t cs,
                            int64_t G) {
  if (Bz <= 0 || H <= 0 || P <= 0 || N <= 0 || S <= 0 || cs <= 0 || G <= 0) return false;
  if (S % cs != 0 || H % G != 0 || S > INT32_MAX || P > INT32_MAX || N > INT32_MAX) return false;
  if (tiles_smem(3, (int)cs) > spm::kMaxSmem) return false;
  const int64_t blocks = Bz * H * (S / cs) * ((cs + kT - 1) / kT);
  return blocks * ((P + kT - 1) / kT) <= INT32_MAX && blocks * ((N + kT - 1) / kT) <= INT32_MAX &&
         blocks * ((cs + kT - 1) / kT) <= INT32_MAX;
}

}  // namespace ssd
