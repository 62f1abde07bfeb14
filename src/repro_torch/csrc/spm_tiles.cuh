// Device tile routines of the paper's compute kernels, shared by
// spm_matmul.cu (its float32 kernel), spm_fft.cu and het_mimd.cu: each
// standalone kernel runs one routine per block, and the het-MIMD kernel
// runs all three in ONE launch, the block index picking the routine
// (conv_tile serves het_mimd.cu's conv hart only; the standalone conv2d
// has its own kernel, spm_conv2d.cu).
//
// Every routine is written for a 1-D block of kThreads threads, takes
// the index of the tile it computes (so a caller maps blockIdx.x onto
// it), and stages its operands in the dynamic shared memory `smem` the
// caller passes (MmTile::kSmemBytes and the *_smem_bytes helpers give
// the size). Each routine bounds-checks its tile, so any shape is taken;
// the wrappers in repro_torch/kernels/ validate shapes, types and
// contiguity first.
//
// What bounds them on an H100, and what the designs do about it:
// - matmul_tile: float32 operations on the CUDA cores (67 TFLOP/s; TF32
//   on the tensor cores is refused by the checks). A shared-memory load
//   must feed several FMAs, so each thread keeps an 8 x 8 (or 4 x 8)
//   block of outputs in registers, read as float4 (16 FMAs a load), the
//   block's two halves splitting K; the K slabs stream through a
//   three-stage cp.async ring, so the next slabs arrive during this
//   one's FMAs.
// - fft_tiles_run: bytes (16 per point against 5 log2(n) operations).
//   What held it back was shared memory: a barriered pass over shared
//   memory per radix-2 stage and a bit-reversed read that put a warp on
//   one bank. Now each thread runs up to 4 stages on 16 points in
//   registers, the passes exchange through an XOR-swizzled layout that
//   keeps the exchanges free of bank conflicts, and the bit reversal is
//   folded into the last exchange, so HBM sees coalesced loads and
//   16-byte stores.
// - conv_tile: bytes for small filters, INT32 / FP32 operations for
//   large ones; the input window is staged once per tile.
//
// Arithmetic, and why:
// - The matmul uses one FMA per term (__fmaf_rn), the even and the odd k
//   in two ascending chains, then one add; no TF32 (the float32 products
//   are held to a float32 bound). conv2d
//   and the FFT round every multiply and every add on its own
//   (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts), in
//   the order of their plain PyTorch versions, so that on the card the
//   two agree bit for bit.
// - bf16 inputs widen to float32 on load; a bf16 output rounds to
//   nearest even (__float2bfloat16_rn), as JAX's astype does.
// - int32 conv products accumulate in uint32_t: signed overflow is
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
constexpr size_t kMaxSmem = 232448;          // a block's limit on the H100 (227 KB)

// ---- element access -------------------------------------------------------

// load_c: one input element in its compute type (float or int32_t)
__device__ __forceinline__ float load_c(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_c(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ int32_t load_c(const int32_t* p) { return __ldg(p); }

// the compute type of an input type, and the accumulator of a compute type
template <typename T> struct ComputeOf { using type = float; };     // float, bf16
template <> struct ComputeOf<int32_t> { using type = int32_t; };
template <typename C> struct AccOf { using type = float; };
template <> struct AccOf<int32_t> { using type = uint32_t; };

// conv2d term: a rounded product, then a rounded sum; or a wrapping
// integer multiply-add
__device__ __forceinline__ float mul_add(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}
__device__ __forceinline__ uint32_t mul_add(uint32_t acc, int32_t a, int32_t b) {
  return acc + (uint32_t)a * (uint32_t)b;
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

// global -> shared copies that do not wait: `bytes` of `src`, zero-filled
// when `in` is false (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- matmul: C[M, N] = A[M, K] @ B[K, N], float32, row-major ----------------
//
// A BM x 64 output tile per block, BM = 128 or 64. The block's 256
// threads split K in two groups of 128, the even and the odd k of every
// slab; each thread keeps BM / 16 x 8 outputs in registers (rows 4 ty + i,
// and BM / 2 + 4 ty + i at BM = 128; columns 4 tx + j and 32 + 4 tx + j),
// read per k as float4 of A and B, so 16 FMAs per shared load at BM =
// 128 and 10.7 at 64 (warp w of a group holds ty = 4 w + l / 8 and tx =
// l % 8 of its lanes l; each of its reads is one 64- or 128-byte
// wavefront). At the end group 1 hands its sums to group 0 through shared
// memory, which adds the two and stores: one FMA per term, in two
// interleaved chains, then one add. K advances in slabs of BK (16 or 32)
// through a ring of three stages, so two slabs are in flight during a
// slab's FMAs and one barrier a slab suffices. A's BM x BK slab is stored
// k-major: the transpose needs 4-byte copies, each warp copying 4 k of 8
// rows so that its writes reach 32 banks (rows padded by 8 words); a
// thread copies one k of rows r, r + 256 / BK, ..., so its source pointer
// steps by 256 / BK rows. B's BK x 64 slab is stored as it is: 16-byte
// copies when N % 4 == 0 and B is 16-byte aligned, else 4-byte ones.
// Copies past an edge zero-fill, so edges cost no branch in the FMAs.

constexpr int kMmBN = 64, kMmStages = 3;

template <int BM, int BK>
struct MmTile {
  static constexpr int kAs = BM + 8;                       // words per k of the A slab
  static constexpr int kStage = BK * kAs + BK * kMmBN;     // words per stage
  static constexpr size_t kSmemBytes = kMmStages * kStage * sizeof(float);
  static_assert(kSmemBytes >= BM / 16 * 8 * 128 * sizeof(float), "the hand-over fits");
};

template <int BM>
__host__ __device__ inline int64_t matmul_tiles(int64_t M, int64_t N) {
  return ((M + BM - 1) / BM) * ((N + kMmBN - 1) / kMmBN);
}

template <int BM, int BK>
__device__ void matmul_tile(const float* __restrict__ a, const float* __restrict__ b,
                            float* __restrict__ c, int64_t M, int64_t N, int64_t K,
                            int64_t tile, unsigned char* smem) {
  constexpr int kAs = MmTile<BM, BK>::kAs, kStage = MmTile<BM, BK>::kStage, RI = BM / 16;
  float* st = reinterpret_cast<float*>(smem);    // stages of [BK][BM + 8] A, [BK][BN] B
  const int64_t tiles_n = (N + kMmBN - 1) / kMmBN;
  const int64_t m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * kMmBN;
  const int tid = threadIdx.x, kg = tid / 128, t = tid % 128, lane = t % 32;
  const int ty = (t / 32) * 4 + lane / 8, tx = lane % 8;
  const bool vec_b = N % 4 == 0 && (uintptr_t)b % 16 == 0;
  const bool vec_c = N % 4 == 0 && (uintptr_t)c % 16 == 0;

  // this thread's copies: A's k = ak of rows ar + kAStep i (lanes: 4 k
  // of 8 rows); B's row bk + kThreads / 16 i, columns bc .. bc + 3
  // (16-byte copies) or row e / 64, column e % 64 of e = tid + 256 i
  // (4-byte copies)
  constexpr int kAStep = kThreads / BK;
  const int ak = (tid & 3) | ((tid >> 5) % (BK / 4)) << 2;
  const int ar = ((tid >> 2) & 7) | (tid / (8 * BK)) << 3;
  const int bk = tid / (kMmBN / 4), bc = tid % (kMmBN / 4) * 4;
  const int64_t a_rows = M - m0 - ar;             // rows of this thread's A copies in range
  const float* pa = a + (m0 + ar) * K + ak;      // advanced one slab at a time
  const float* pb = b + n0;
  auto copy_slab = [&](int64_t k0, float* As) {
    float* Bs = As + BK * kAs;
    const bool ka = k0 + ak < K;
#pragma unroll
    for (int i = 0; i < BM * BK / kThreads; ++i) {
      const bool in = ka && kAStep * i < a_rows;
      cp_async4(As + ak * kAs + ar + kAStep * i, in ? pa + kAStep * i * K : a, in);
    }
    if (vec_b) {                                  // a piece is whole or outside: N % 4 == 0
#pragma unroll
      for (int i = 0; i < BK * kMmBN / 4 / kThreads; ++i) {
        const int kk = bk + kThreads / (kMmBN / 4) * i;
        const bool in = k0 + kk < K && n0 + bc < N;
        cp_async16(Bs + kk * kMmBN + bc, in ? pb + kk * N + bc : b, in);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK * kMmBN / kThreads; ++i) {
        const int e = tid + kThreads * i, kk = e / kMmBN, cc = e % kMmBN;
        const bool in = k0 + kk < K && n0 + cc < N;
        cp_async4(Bs + kk * kMmBN + cc, in ? pb + kk * N + cc : b, in);
      }
    }
    pa += BK;
    pb += BK * N;
  };

  float acc[RI][8];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int64_t slabs = (K + BK - 1) / BK;
  for (int s = 0; s < kMmStages - 1; ++s) {       // the ring's first slabs
    if (s < slabs) copy_slab(s * BK, st + s * kStage);
    cp_async_commit();
  }
  for (int64_t s = 0; s < slabs; ++s) {
    cp_async_wait<kMmStages - 2>();               // slab s has landed, for this thread ...
    __syncthreads();                              // ... and all; slab s - 1 is consumed
    if (s + kMmStages - 1 < slabs)
      copy_slab((s + kMmStages - 1) * BK, st + (s + kMmStages - 1) % kMmStages * kStage);
    cp_async_commit();
    const float* As = st + s % kMmStages * kStage;
    const float* Bs = As + BK * kAs;
#pragma unroll
    for (int u = 0; u < BK / 2; ++u) {
      const int kk = 2 * u + kg;
      float av[RI], bv[8];
#pragma unroll
      for (int h = 0; h < RI / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(As + kk * kAs + BM / 2 * h + 4 * ty);
        av[4 * h] = v.x, av[4 * h + 1] = v.y, av[4 * h + 2] = v.z, av[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(Bs + kk * kMmBN + 32 * h + 4 * tx);
        bv[4 * h] = v.x, bv[4 * h + 1] = v.y, bv[4 * h + 2] = v.z, bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();                                // the stages are free: group 1 hands over
  if (kg == 1) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) st[(i * 8 + j) * 128 + t] = acc[i][j];
  }
  __syncthreads();
  if (kg == 1) return;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int64_t gm = m0 + BM / 2 * (i / 4) + 4 * ty + i % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gn = n0 + 32 * h + 4 * tx;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = __fadd_rn(acc[i][4 * h + j], st[(i * 8 + 4 * h + j) * 128 + t]);
      if (gm >= M || gn >= N) continue;
      float* out = c + gm * N + gn;
      if (vec_c) {
        *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) out[j] = v[j];
      }
    }
  }
}

// ---- conv2d: F x F correlation over a zero-extended image -----------------
//
// out[r][c] = sum_{fr, fc} in(r + fr - pad_top, c + fc - pad_left) * filt[fr][fc],
// in() reading 0 outside [0, H_in) x [0, W_in), taps in (fr, fc) order.
// The het-MIMD branch passes its pre-padded image and pad 0 (a valid
// correlation); a nonzero pad makes the padding an index test.
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

// ---- FFT: batched radix-2 DIF over rows of n = 2^log2n points ---------------
//
// Rows of separate float32 re / im planes; out[j] = x[bitrev(j)] after
// the log2(n) stages. Stage half-size h pairs x[i] and x[i + h] in each
// group of 2h and multiplies the difference by the twiddle tw[h - 1 + k]
// (cos) and tw[cos_len + h - 1 + k] (sin), k = i mod h: the table the
// wrapper builds once per n with the reference's float32 formula.
//
// The plan (spm_fft.pass_plan, packed: bits 0-3 the number of passes,
// bits 4 + 4p the stages of pass p) groups the stages, from h = n / 2
// down, into passes of at most 4. A block holds `rows` whole rows in
// shared memory at a time, a tile; it runs tiles first, first + stride,
// ... In a pass of R stages whose lowest is 2^s_lo, a work item is one
// base index b (no bits in the pass's range) of one row; its thread loads
// the 2^R points b + j 2^s_lo into registers, runs the R stages there
// with the same rounded operations as the plain version, and stores them
// back. The first pass loads its points straight from device memory
// (coalesced: lanes take consecutive b); a barrier separates the passes;
// after the last one the threads read the rows back through the bit
// reversal, 4 consecutive outputs each, and write them as float4.
//
// Shared memory is XOR-swizzled: word e holds block element
// e ^ (((e >> 5) ^ (e >> 10)) & 31). The swizzle is linear over XOR, and
// a warp's 32 lanes then reach 32 banks whenever they vary 5 contiguous
// index bits. Work items give lanes consecutive low bits of b where the
// pass leaves 5 of them (s_lo >= 5, and the first pass), else
// consecutive index bits above the pass, then the low bits, then rows:
// at the plans' full blocks the exchanges of n = 1024, 8192 and 16384 are
// conflict-free, and from n = 128 up no pass is more than 2-way
// (tests/test_torch_spm_fft.py models them).

constexpr int kFftMaxPasses = 4, kFftMaxRadix = 4;

__host__ __device__ inline int fft_passes(unsigned plan) { return (int)(plan & 15u); }
__host__ __device__ inline int fft_radix(unsigned plan, int p) {
  return (int)((plan >> (4 + 4 * p)) & 15u);
}
// words of one plane: `rows` rows, whole 32-word lines (the swizzle's unit)
__host__ __device__ inline int64_t fft_plane(int64_t n, int rows) {
  return (rows * n + 31) / 32 * 32;
}
__host__ __device__ inline size_t fft_smem_bytes(int64_t n, int rows) {
  return (size_t)(2 * fft_plane(n, rows)) * sizeof(float);
}
__host__ __device__ inline int64_t fft_tiles(int64_t B, int rows) { return (B + rows - 1) / rows; }

// whether the tile runs `plan` at n = 2^log2n with `rows` rows a tile:
// 1 to 4 passes of 1 to 4 stages covering the log2(n) stages (n = 1: one
// pass of none), and the rows within a block's shared memory
inline bool fft_plan_ok(int log2n, unsigned plan, int rows) {
  const int np = fft_passes(plan);
  if (log2n < 0 || log2n > 14 || np < 1 || np > kFftMaxPasses || (plan >> (4 + 4 * np)) != 0 ||
      rows < 1)
    return false;
  int stages = 0;
  for (int p = 0; p < np; ++p) {
    const int r = fft_radix(plan, p);
    if (r > kFftMaxRadix || (r == 0 && log2n != 0)) return false;
    stages += r;
  }
  return stages == log2n && fft_smem_bytes(1 << log2n, rows) <= kMaxSmem;
}

__device__ __forceinline__ int fft_swz(int e) { return e ^ (((e >> 5) ^ (e >> 10)) & 31); }

// the reference's butterfly, every operation rounded on its own
__device__ __forceinline__ void fft_bfly(float& ar, float& ai, float& br, float& bi, float wr,
                                         float wi) {
  const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
  ar = __fadd_rn(ar, br);
  ai = __fadd_rn(ai, bi);
  br = __fsub_rn(__fmul_rn(dr, wr), __fmul_rn(di, wi));
  bi = __fadd_rn(__fmul_rn(dr, wi), __fmul_rn(di, wr));
}

// one pass of R stages, the highest of half-size 2^s_hi, over `rows` rows;
// the first pass reads its points from the tile's rows in device memory
// (gre / gim), the others from shared memory. The last pass (s_lo = 0)
// has offsets and twiddles known at compile time: the same twiddles for
// every work item, loaded once.
template <int R, bool first, bool last>
__device__ __forceinline__ void fft_pass(const float* __restrict__ gre,
                                         const float* __restrict__ gim,
                                         const float* __restrict__ wre,
                                         const float* __restrict__ wim, float* sre, float* sim,
                                         int log2n, int rows, int s_hi) {
  constexpr int P = 1 << R;
  const int s_lo = last ? 0 : s_hi - R + 1;
  const int lq = log2n - 1 - s_hi;                 // index bits above the pass
  const int items = rows << (log2n - R);
  const bool lo_first = first || s_lo >= 5;
  int off[P];                                      // swizzled offsets of the points
#pragma unroll
  for (int j = 0; j < P; ++j) off[j] = fft_swz(j << s_lo);
  for (int w = threadIdx.x; w < items; w += kThreads) {
    int ql, qh, r;
    if (lo_first) {
      ql = w & ((1 << s_lo) - 1);
      qh = (w >> s_lo) & ((1 << lq) - 1);
      r = w >> (s_lo + lq);
    } else {
      qh = w & ((1 << lq) - 1);
      ql = (w >> lq) & ((1 << s_lo) - 1);
      r = w >> (lq + s_lo);
    }
    const int base = (r << log2n) | (qh << (s_hi + 1)) | ql;
    const int sb = fft_swz(base);                  // swz(base | x) = swz(base) ^ swz(x)
    float xr[P], xi[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (first) {
        xr[j] = __ldg(gre + base + (j << s_lo));
        xi[j] = __ldg(gim + base + (j << s_lo));
      } else {
        xr[j] = sre[sb ^ off[j]];
        xi[j] = sim[sb ^ off[j]];
      }
    }
    // stage 2^(s_lo + st) pairs points j and j + 2^st; its twiddle index
    // k = ql + (j mod 2^st) 2^s_lo
#pragma unroll
    for (int st = R - 1; st >= 0; --st) {
      const int h = 1 << (s_lo + st);
#pragma unroll
      for (int m = 0; m < (1 << st); ++m) {
        const int t = h - 1 + ql + (m << s_lo);
        const float wr = __ldg(wre + t), wi = __ldg(wim + t);
#pragma unroll
        for (int g = m; g < P; g += 2 << st)
          fft_bfly(xr[g], xi[g], xr[g + (1 << st)], xi[g + (1 << st)], wr, wi);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      sre[sb ^ off[j]] = xr[j];
      sim[sb ^ off[j]] = xi[j];
    }
  }
}

// a pass of R stages (the dispatch of the runtime plan onto the templates)
template <bool first, bool last>
__device__ __forceinline__ void fft_pass(int R, const float* gre, const float* gim,
                                         const float* wre, const float* wim, float* sre,
                                         float* sim, int log2n, int rows, int s_hi) {
  switch (R) {
    case 0: fft_pass<0, first, last>(gre, gim, wre, wim, sre, sim, log2n, rows, s_hi); break;
    case 1: fft_pass<1, first, last>(gre, gim, wre, wim, sre, sim, log2n, rows, s_hi); break;
    case 2: fft_pass<2, first, last>(gre, gim, wre, wim, sre, sim, log2n, rows, s_hi); break;
    case 3: fft_pass<3, first, last>(gre, gim, wre, wim, sre, sim, log2n, rows, s_hi); break;
    default: fft_pass<4, first, last>(gre, gim, wre, wim, sre, sim, log2n, rows, s_hi); break;
  }
}

// tiles first, first + stride, ... of rows_per_block rows of the B rows;
// ore / oim 16-byte aligned
__device__ void fft_tiles_run(const float* __restrict__ re, const float* __restrict__ im,
                              const float* __restrict__ tw, float* __restrict__ ore,
                              float* __restrict__ oim, int64_t B, int log2n, unsigned plan,
                              int rows_per_block, int64_t first, int64_t stride,
                              unsigned char* smem) {
  const int n = 1 << log2n;
  float* sre = reinterpret_cast<float*>(smem);
  float* sim = sre + fft_plane(n, rows_per_block);
  const float* wre = tw;
  const float* wim = tw + (n > 1 ? n - 1 : 1);      // the table is [2, max(n - 1, 1)]
  for (int64_t tile = first; tile < fft_tiles(B, rows_per_block); tile += stride) {
    const int64_t row0 = tile * rows_per_block, base = row0 * n;
    const int rows = (int)(B - row0 < rows_per_block ? B - row0 : rows_per_block);
    int s_hi = log2n - 1;
    for (int p = 0; p < fft_passes(plan); ++p) {
      const int R = fft_radix(plan, p);
      const bool last = p == fft_passes(plan) - 1;
      if (p == 0 && last)
        fft_pass<true, true>(R, re + base, im + base, wre, wim, sre, sim, log2n, rows, s_hi);
      else if (p == 0)
        fft_pass<true, false>(R, re + base, im + base, wre, wim, sre, sim, log2n, rows, s_hi);
      else if (last)
        fft_pass<false, true>(R, re, im, wre, wim, sre, sim, log2n, rows, s_hi);
      else
        fft_pass<false, false>(R, re, im, wre, wim, sre, sim, log2n, rows, s_hi);
      __syncthreads();                              // the exchange
      s_hi -= R;
    }
    // out[e] = x[bitrev(e mod n)] of its row, 4 consecutive outputs e = o + c
    // a thread, written as float4. From n = 4 on, o mod n = j is a multiple
    // of 4 and bitrev(j + c) = bitrev(j) | bitrev(c): one swizzled index
    // and 4 constant offsets reach the 4 (all 8 loads issued before the
    // stores)
    const int cnt = rows * n;
    const bool vec = base % 4 == 0 && log2n >= 2;
    int offc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      offc[c] = vec ? fft_swz((c & 1) << (log2n - 1) | (c >> 1) << (log2n - 2)) : 0;
    for (int o = 4 * threadIdx.x; o < cnt; o += 4 * kThreads) {
      float vr[4], vi[4];
      if (vec) {
        const int j = o & (n - 1);
        const int sb = fft_swz((o - j) | (int)(__brev((unsigned)j) >> (32 - log2n)));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          vr[c] = o + c < cnt ? sre[sb ^ offc[c]] : 0.f;
          vi[c] = o + c < cnt ? sim[sb ^ offc[c]] : 0.f;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = o + c, j = e & (n - 1);
          const int src =
              fft_swz((e - j) | (log2n ? (int)(__brev((unsigned)j) >> (32 - log2n)) : 0));
          vr[c] = e < cnt ? sre[src] : 0.f;
          vi[c] = e < cnt ? sim[src] : 0.f;
        }
      }
      if (vec && o + 4 <= cnt) {
        *reinterpret_cast<float4*>(ore + base + o) = make_float4(vr[0], vr[1], vr[2], vr[3]);
        *reinterpret_cast<float4*>(oim + base + o) = make_float4(vi[0], vi[1], vi[2], vi[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (o + c < cnt) {
            ore[base + o + c] = vr[c];
            oim[base + o + c] = vi[c];
          }
        }
      }
    }
    __syncthreads();                                // the next tile rewrites the rows
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
