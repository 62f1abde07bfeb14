// Device tile routines of the paper's compute kernels, shared by
// spm_matmul.cu, spm_conv2d.cu, spm_fft.cu and het_mimd.cu: each
// standalone kernel runs one routine per block, and the het-MIMD kernel
// runs all three in ONE launch, the block index picking the routine.
//
// Every routine is written for a 1-D block of kThreads threads, takes
// the index of the tile it computes (so a caller maps blockIdx.x onto
// it), and stages its operands in the dynamic shared memory `smem` the
// caller passes (the *_smem_bytes helpers give the size). Each routine
// bounds-checks its tile, so any shape is taken; the wrappers in
// repro_torch/kernels/ validate shapes, types and contiguity first.
//
// Arithmetic, and why:
// - float32 products accumulate in float32. The matmul uses an FMA per
//   term (no TF32: the composite's matmul is held at 1e-4). conv2d and
//   the FFT round every multiply and every add on its own
//   (__fmul_rn / __fadd_rn, which nvcc never contracts), in the order of
//   their plain PyTorch versions, so that on the card the two agree bit
//   for bit.
// - bf16 inputs widen to float32 on load; a bf16 output rounds to
//   nearest even (__float2bfloat16_rn), as JAX's astype does.
// - int8 and int32 products accumulate in uint32_t: signed overflow is
//   undefined in C++, unsigned arithmetic wraps exactly like the
//   reference's int32 accumulator. conv2d then shifts the WRAPPED int32
//   arithmetically (the reference's order), a count outside [0, 31]
//   acting as 31 (the sign fill).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spm {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;   // above this: opt in per kernel

// ---- element access -------------------------------------------------------

// load_c: one input element in its compute type (float or int32_t)
__device__ __forceinline__ float load_c(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_c(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ int32_t load_c(const int8_t* p) { return (int32_t)__ldg(p); }
__device__ __forceinline__ int32_t load_c(const int32_t* p) { return __ldg(p); }

// the compute type of an input type, and the accumulator of a compute type
template <typename T> struct ComputeOf { using type = float; };     // float, bf16
template <> struct ComputeOf<int8_t> { using type = int32_t; };
template <> struct ComputeOf<int32_t> { using type = int32_t; };
template <typename C> struct AccOf { using type = float; };
template <> struct AccOf<int32_t> { using type = uint32_t; };

// matmul term: one FMA, or a wrapping integer multiply-add
__device__ __forceinline__ float mac(float acc, float a, float b) { return __fmaf_rn(a, b, acc); }
__device__ __forceinline__ uint32_t mac(uint32_t acc, int32_t a, int32_t b) {
  return acc + (uint32_t)a * (uint32_t)b;
}
// conv2d term: a rounded product, then a rounded sum
__device__ __forceinline__ float mul_add(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}
__device__ __forceinline__ uint32_t mul_add(uint32_t acc, int32_t a, int32_t b) {
  return mac(acc, a, b);
}

// the accumulator as an output value: a float as it is; an int32 wrapped,
// then shifted arithmetically (a count outside [0, 31] acts as 31)
__device__ __forceinline__ float finish(float acc, int) { return acc; }
__device__ __forceinline__ int32_t finish(uint32_t acc, int shift) {
  return (int32_t)acc >> ((unsigned)shift > 31u ? 31 : shift);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(int32_t* p, int32_t v) { *p = v; }

// ---- matmul: C[M, N] = A[M, K] @ B[K, N], row-major -----------------------
//
// A 64 x 64 output tile per block; each thread holds a 4 x 4 block of
// outputs in registers (rows ty + 16 i, columns tx + 16 j, so the stores
// of a warp are contiguous). K advances in steps of 16: A's 64 x 16 slab
// is stored transposed (k-major, padded against bank conflicts) and B's
// 16 x 64 slab as it is, both in the compute type.

constexpr int kMmBM = 64, kMmBN = 64, kMmBK = 16, kMmPad = 4;
constexpr size_t kMatmulSmemBytes = (kMmBK * (kMmBM + kMmPad) + kMmBK * kMmBN) * 4;

__host__ __device__ inline int64_t matmul_tiles(int64_t M, int64_t N) {
  return ((M + kMmBM - 1) / kMmBM) * ((N + kMmBN - 1) / kMmBN);
}

template <typename Tin, typename Tout>
__device__ void matmul_tile(const Tin* __restrict__ a, const Tin* __restrict__ b,
                            Tout* __restrict__ c, int64_t M, int64_t N, int64_t K,
                            int64_t tile, unsigned char* smem) {
  using C = typename ComputeOf<Tin>::type;
  using Acc = typename AccOf<C>::type;
  constexpr int kAs = kMmBM + kMmPad;
  C* As = reinterpret_cast<C*>(smem);        // [BK][BM + pad], A transposed
  C* Bs = As + kMmBK * kAs;                  // [BK][BN]
  const int64_t tiles_n = (N + kMmBN - 1) / kMmBN;
  const int64_t m0 = (tile / tiles_n) * kMmBM, n0 = (tile % tiles_n) * kMmBN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);

  for (int64_t k0 = 0; k0 < K; k0 += kMmBK) {
    for (int e = tid; e < kMmBM * kMmBK; e += kThreads) {
      const int r = e / kMmBK, kk = e % kMmBK;
      const int64_t gm = m0 + r, gk = k0 + kk;
      As[kk * kAs + r] = (gm < M && gk < K) ? load_c(a + gm * K + gk) : C(0);
    }
    for (int e = tid; e < kMmBK * kMmBN; e += kThreads) {
      const int kk = e / kMmBN, cc = e % kMmBN;
      const int64_t gk = k0 + kk, gn = n0 + cc;
      Bs[kk * kMmBN + cc] = (gk < K && gn < N) ? load_c(b + gk * N + gn) : C(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmBK; ++kk) {
      C av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk * kAs + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * kMmBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = mac(acc[i][j], av[i], bv[j]);
    }
    __syncthreads();                          // the slabs are refilled next step
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) store(c + gm * N + gn, finish(acc[i][j], 0));
    }
  }
}

// ---- conv2d: F x F correlation over a zero-extended image -----------------
//
// out[r][c] = sum_{fr, fc} in(r + fr - pad_top, c + fc - pad_left) * filt[fr][fc],
// in() reading 0 outside [0, H_in) x [0, W_in), taps in (fr, fc) order.
// The same-size convolution passes the unpadded image and pad_top =
// F / 2 (the padding is an index test, not a padded copy); the het-MIMD
// branch passes its pre-padded image and pad 0 (a valid correlation).
// A 32 x 32 output tile per block: its (32 + F - 1)^2 input window and
// the filter are staged in shared memory; each thread computes 4 rows of
// one column (rows ty + 8 i), so a warp reads 32 consecutive words.

constexpr int kConvT = 32;

__host__ __device__ inline size_t conv_smem_bytes(int F) {
  return ((size_t)(kConvT + F - 1) * (kConvT + F - 1) + (size_t)F * F) * 4;
}

__host__ __device__ inline int64_t conv_tiles(int64_t H, int64_t W) {
  return ((H + kConvT - 1) / kConvT) * ((W + kConvT - 1) / kConvT);
}

// filt is in the compute type (float, or int32_t for an int32 image)
template <typename Tin, typename Tout>
__device__ void conv_tile(const Tin* __restrict__ img, int64_t H_in, int64_t W_in,
                          const typename ComputeOf<Tin>::type* __restrict__ filt,
                          int F, Tout* __restrict__ out, int64_t H, int64_t W, int pad_top,
                          int pad_left, int shift, int64_t tile, unsigned char* smem) {
  using C = typename ComputeOf<Tin>::type;
  using Acc = typename AccOf<C>::type;
  const int SW = kConvT + F - 1, SH = kConvT + F - 1;
  C* win = reinterpret_cast<C*>(smem);       // [SH][SW] input window
  C* fs = win + SH * SW;                     // [F][F] filter
  const int64_t tiles_w = (W + kConvT - 1) / kConvT;
  const int64_t r0 = (tile / tiles_w) * kConvT, c0 = (tile % tiles_w) * kConvT;
  const int tid = threadIdx.x;

  for (int e = tid; e < SH * SW; e += kThreads) {
    const int64_t gr = r0 + e / SW - pad_top, gc = c0 + e % SW - pad_left;
    win[e] = (gr >= 0 && gr < H_in && gc >= 0 && gc < W_in) ? load_c(img + gr * W_in + gc)
                                                            : C(0);
  }
  for (int e = tid; e < F * F; e += kThreads) fs[e] = filt[e];
  __syncthreads();

  const int tx = tid % kConvT, ty = tid / kConvT;   // 8 rows of threads
  Acc acc[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
  for (int fr = 0; fr < F; ++fr) {
    for (int fc = 0; fc < F; ++fc) {
      const C w = fs[fr * F + fc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = mul_add(acc[i], win[(ty + 8 * i + fr) * SW + tx + fc], w);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = r0 + ty + 8 * i, c = c0 + tx;
    if (r < H && c < W) store(out + r * W + c, finish(acc[i], shift));
  }
}

// ---- FFT: batched radix-2 DIF over rows of n (a power of two) -------------
//
// Rows of separate float32 re / im planes. A block holds R = max(1,
// 2048 / n) whole rows in shared memory (8 n R bytes), runs all log2(n)
// stages there with a barrier between stages, then writes through the
// bit reversal: out[j] = x[bitrev(j)]. Stage half-size h reads its
// twiddles from tw[h - 1 + k] (cos) and tw[n - 1 + h - 1 + k] (sin),
// the table the wrapper builds once per n with the reference's float32
// formula. n = 1 is the identity.

constexpr int kFftRowElems = 2048;

__host__ __device__ inline int fft_rows_per_block(int64_t n) {
  return n >= kFftRowElems ? 1 : (int)(kFftRowElems / n);
}

__host__ __device__ inline size_t fft_smem_bytes(int64_t n) {
  return (size_t)fft_rows_per_block(n) * n * 2 * sizeof(float);
}

__host__ __device__ inline int64_t fft_tiles(int64_t B, int64_t n) {
  const int R = fft_rows_per_block(n);
  return (B + R - 1) / R;
}

__device__ void fft_tile(const float* __restrict__ re, const float* __restrict__ im,
                         const float* __restrict__ tw, float* __restrict__ ore,
                         float* __restrict__ oim, int64_t B, int n, int log2n, int64_t tile,
                         unsigned char* smem) {
  const int R = fft_rows_per_block(n);
  const int64_t row0 = tile * R;
  const int rows = (int)(B - row0 < R ? B - row0 : R);
  const int cnt = rows * n;
  const int64_t base = row0 * n;
  float* sre = reinterpret_cast<float*>(smem);
  float* sim = sre + R * n;
  const int tid = threadIdx.x;

  for (int e = tid; e < cnt; e += kThreads) {
    sre[e] = __ldg(re + base + e);
    sim[e] = __ldg(im + base + e);
  }
  const float* wre = tw;
  const float* wim = tw + (n - 1);
  for (int lh = log2n - 1; lh >= 0; --lh) {     // half-size h = 2^lh: n/2 .. 1
    __syncthreads();
    const int h = 1 << lh;
    for (int bf = tid; bf < cnt / 2; bf += kThreads) {
      // butterfly bf of all rows: group bf / h (of 2h elements), offset k
      const int k = bf & (h - 1);
      const int lo = ((bf >> lh) << (lh + 1)) + k, hi = lo + h;
      const float ar = sre[lo], ai = sim[lo], br = sre[hi], bi = sim[hi];
      const float wr = __ldg(wre + h - 1 + k), wi = __ldg(wim + h - 1 + k);
      const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
      sre[lo] = __fadd_rn(ar, br);
      sim[lo] = __fadd_rn(ai, bi);
      sre[hi] = __fsub_rn(__fmul_rn(dr, wr), __fmul_rn(di, wi));
      sim[hi] = __fadd_rn(__fmul_rn(dr, wi), __fmul_rn(di, wr));
    }
  }
  __syncthreads();
  for (int e = tid; e < cnt; e += kThreads) {
    const unsigned j = (unsigned)(e & (n - 1));
    const int src = (e - (int)j) + (log2n ? (int)(__brev(j) >> (32 - log2n)) : 0);
    ore[base + e] = sre[src];
    oim[base + e] = sim[src];
  }
}

// Opt a kernel in to more than the default 48 KB of dynamic shared
// memory; returns the CUDA error (0 on success).
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace spm
