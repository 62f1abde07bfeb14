// The Mamba-2 SSD chunk scan as three kernels on one stream. Per (batch b,
// head h) a state h [N, P] (float32, zero at the start) walks the sequence
// in chunks of cs steps; within chunk c, with cum the running sum of da over
// the chunk and xdt_j = x_j dt_j,
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xdt_j          (intra)
//         + exp(cum_i) (C_i h_in[c])                                  (inter)
//   h_in[c + 1] = exp(cum_last) h_in[c] + s_c,
//   s_c   = sum_j (B_j exp(cum_last - cum_j))^T xdt_j                  (chunk state)
// x [Bz, S, H, P] (float32 or bf16), da and dt [Bz, S, H], B and C [Bz, S,
// H, N] head-broadcast (float32); y in x's type, the final state [Bz, H, N,
// P] float32. All arithmetic float32.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel (a (Bz, H,
// S/cs) grid whose innermost, sequential chunk axis carries the state in
// VMEM scratch). On an H100 that order leaves Bz * H blocks, each walking
// its chunks in series; here the chain is cut into three launches, and
// the stream orders them:
//   1. ssd_chunk_state_kernel: every chunk's own state s_c, from zero, as
//      an [N x cs] . [cs x P] product; one block per (b, h, c, 64-row N
//      tile, 64-column P tile). It writes cum to a [Bz, H, S] workspace
//      (the only cum the other two kernels read) and s_c to a [Bz, H, S/cs,
//      N, P] workspace;
//   2. ssd_state_pass_kernel: the short scan over chunks, one thread per
//      state element; it overwrites s_c with h_in[c] in place and writes the
//      final state. Bound by bytes (the workspace read and written once);
//   3. ssd_chunk_scan_kernel: y, one block per (b, h, c, 64-row tile i of
//      the chunk, 64-column P tile): for each column tile j <= i the scores
//      C_i B_j^T over N, masked to j <= i BEFORE the exp (exp(cum_i - cum_j)
//      overflows for j > i), times exp(cum_i - cum_j), into a product with
//      xdt_j; first the inter term exp(cum_i) (C_i h_in[c]). Row tile i
//      does i + 1 column tiles, so blocks run heaviest first: blockIdx.x
//      takes row tile ntile - 1 - blockIdx.x / (blocks per row tile).
//
// What bounds it: operations. At the mamba2-1.3b row (Bz 2, S 4096, H 64,
// P 64, N 128, cs 256) the function needs 43 G float32 operations (0.64 ms
// at the FP32 rate) against 0.81 GB (0.24 ms). Everything runs on the CUDA
// cores (TF32 fails the checks). Kernels 1 and 3 keep 8 x 4 outputs a
// thread in registers (rows 4 ty + r and 32 + 4 ty + r, columns 4 tx + q of
// a 64 x 64 tile, 128 threads), read per k as float4 from k-major tiles
// whose rows are padded to 68 words, so 32 FMAs take three shared loads.
// Their K slabs of 32 stream through cp.async stages (two in kernel 1,
// three in kernel 3; one barrier a slab). B and C arrive n-contiguous and
// are transposed by the 4-byte copies (each warp copies 8 n of 4 rows,
// which reach 32 banks); kernel 3 holds its 64 x N tile of C whole and
// streams B and h_in, and a float32 x tile arrives by cp.async during the
// scores before it (dt_j is folded into the scores). x staged through
// registers (kernel 1; bf16 x in kernel 3) is loaded a slab ahead and
// used only after the slab's FMAs, so no warp waits on it. Shared memory
// does not grow with P (tiled in the grid) and grows with N only through
// that C tile: 37888 and 97792 bytes at the mamba2 row, so two blocks or
// more fit an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "spm_tiles.cuh"

namespace {

constexpr int kThr = 128;           // threads of kernels 1 and 3
constexpr int kPassThr = 256;       // threads of kernel 2
constexpr int kT = 64;              // tile edge
constexpr int kLd = kT + 4;         // words per row of a shared tile
constexpr int kK = 32;              // K slab
constexpr int kStages = 3;          // kernel 3's cp.async ring
constexpr int kPassUnroll = 8;      // chunk states kernel 2 loads at once

enum Dtype { F32 = 0, BF16 = 1 };

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int n_pad(int N) { return ceil_div(N, kK) * kK; }

size_t state_smem(int cs) { return sizeof(float) * (4 * (size_t)kK * kLd + 3 * (size_t)cs); }
size_t scan_smem(int N, int cs) {
  return sizeof(float) * ((size_t)n_pad(N) * kLd + kStages * (size_t)kK * kLd +
                          2 * (size_t)kT * kLd + 2 * (size_t)cs);
}

__device__ __forceinline__ bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// ---- 1. chunk states --------------------------------------------------------

template <typename Tx>
__global__ void __launch_bounds__(kThr)
ssd_chunk_state_kernel(const Tx* __restrict__ x, const float* __restrict__ da,
                       const float* __restrict__ dt, const float* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ cum, int S, int H, int P,
                       int N, int cs) {
  extern __shared__ __align__(16) float smem[];
  float* ring_b = smem;                   // 2 x [kK][kLd]: B rows j, columns n
  float* ring_x = ring_b + 2 * kK * kLd;  // 2 x [kK][kLd]: xdt_j exp(cum_last - cum_j)
  float* ccum = ring_x + 2 * kK * kLd;    // [cs] the chunk's cum
  float* cdt = ccum + cs;                 // [cs] its dt
  float* cw = cdt + cs;                   // [cs] exp(cum_last - cum_j)
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int nc = S / cs, ntn = ceil_div(N, kT), npt = ceil_div(P, kT);
  int64_t q = blockIdx.x;
  const int pt = (int)(q % npt);
  q /= npt;
  const int nt = (int)(q % ntn);
  q /= ntn;
  const int c = (int)(q % nc);
  const int64_t bh = q / nc, b = bh / H, h = bh % H;
  const int c0 = c * cs, n0 = nt * kT, p0 = pt * kT;
  auto row = [&](int s) { return (b * S + c0 + s) * H + h; };   // of a [Bz, S, H] tensor

  // cum = cumsum(da) over the chunk: one warp's scan
  for (int j = tid; j < cs; j += kThr) {
    ccum[j] = __ldg(da + row(j));
    cdt[j] = __ldg(dt + row(j));
  }
  __syncthreads();
  if (warp == 0) {
    float carry = 0.f;
    for (int base = 0; base < cs; base += 32) {
      float v = base + lane < cs ? ccum[base + lane] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (base + lane < cs) ccum[base + lane] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const float last = ccum[cs - 1];
  for (int j = tid; j < cs; j += kThr) {
    if (nt == 0 && pt == 0) cum[bh * S + c0 + j] = ccum[j];
    cw[j] = expf(last - ccum[j]);
  }
  __syncthreads();

  const int nslab = ceil_div(cs, kK);
  const bool vec_b = N % 4 == 0 && aligned16(Bm);
  const float* bc = Bm + (int64_t)row(0) * N;              // row j at bc + j H N
  auto issue_b = [&](int s) {
    copy_rows<kK>(ring_b + (s & 1) * kK * kLd, bc, (int64_t)H * N, s * kK, cs, n0, N, vec_b);
  };
  // x of slab s, raw into registers (nothing uses them until store_x, so
  // the loads stay in flight during a slab's FMAs), then x dt w into
  // the ring
  constexpr int kXr = kK * kT / kThr, kXStep = kThr / kT;   // rows jx + 2 m, column px
  const int jx = tid / kT, px = tid % kT;
  const bool pin = p0 + px < P;
  const Tx* xp = x + (int64_t)row(jx) * P + p0 + px;
  const int64_t xstep = (int64_t)H * P;                       // one sequence step
  Tx xr[kXr];
  auto load_x = [&](int s) {
    const int j0 = s * kK;
#pragma unroll
    for (int m = 0; m < kXr; ++m) {
      const int j = j0 + jx + kXStep * m;
      xr[m] = pin && j < cs ? xp[(int64_t)(j0 + kXStep * m) * xstep] : Tx(0.f);
    }
  };
  auto store_x = [&](int s) {
    float* dst = ring_x + (s & 1) * kK * kLd;
    const int j0 = s * kK;
#pragma unroll
    for (int m = 0; m < kXr; ++m) {
      const int j = j0 + jx + kXStep * m;
      dst[(jx + kXStep * m) * kLd + px] = j < cs ? widen(xr[m]) * cdt[j] * cw[j] : 0.f;
    }
  };

  issue_b(0);
  spm::cp_async_commit();
  load_x(0);
  store_x(0);
  float acc[8][4];
  zero(acc);
  for (int s = 0; s < nslab; ++s) {
    if (s + 1 < nslab) load_x(s + 1);     // in flight during this slab's FMAs
    spm::cp_async_wait<0>();
    __syncthreads();                      // slab s is in; slab s - 1 is consumed
    if (s + 1 < nslab) issue_b(s + 1);
    spm::cp_async_commit();
    tile_fma<kK>(ring_b + (s & 1) * kK * kLd, ring_x + (s & 1) * kK * kLd, ty, tx, acc);
    if (s + 1 < nslab) store_x(s + 1);
  }

  float* out = states + (bh * nc + c) * (int64_t)N * P;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + row_of(ty, r);
    if (n >= N) continue;
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int p = p0 + 4 * tx + qq;
      if (p < P) out[(int64_t)n * P + p] = acc[r][qq];
    }
  }
}

// ---- 2. the scan over chunks -------------------------------------------------

__global__ void __launch_bounds__(kPassThr)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ cum,
                      float* __restrict__ state, int S, int cs, int64_t NP, int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * kPassThr + threadIdx.x;
  if (e >= total) return;
  const int nc = S / cs;
  const int64_t bh = e / NP;
  float* sp = states + bh * nc * NP + e % NP;        // s_c at sp[c NP]
  const float* last = cum + bh * S + cs - 1;         // cum_last of chunk c at last[c cs]
  float hv = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPassUnroll) {
    float sv[kPassUnroll], dv[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      if (c0 + u < nc) {
        sv[u] = sp[(int64_t)(c0 + u) * NP];
        dv[u] = expf(__ldg(last + (int64_t)(c0 + u) * cs));
      }
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      if (c0 + u < nc) {
        sp[(int64_t)(c0 + u) * NP] = hv;             // h_in[c]
        hv = __fadd_rn(__fmul_rn(dv[u], hv), sv[u]);  // exp(cum_last) h + s_c
      }
    }
  }
  state[e] = hv;
}

// ---- 3. y ----------------------------------------------------------------------

template <typename Tx>
__global__ void __launch_bounds__(kThr)
ssd_chunk_scan_kernel(const Tx* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ cum, const float* __restrict__ hin,
                      Tx* __restrict__ y, int S, int H, int P, int N, int cs, int64_t BH) {
  constexpr bool kF32 = std::is_same<Tx, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int NK = n_pad(N), nslab = NK / kK;
  float* ct = smem;                        // [NK][kLd]: C of the row tile, n-major
  float* ring = ct + NK * kLd;             // kStages x [kK][kLd]: slabs of h_in[c] or B (n-major)
  float* ss = ring + kStages * kK * kLd;   // [kT][kLd]: masked, decayed scores times dt_j
  float* xs = ss + kT * kLd;               // [kT][kLd]: x of the column tile, j-major
  float* ccum = xs + kT * kLd;             // [cs] the chunk's cum (rows up to the tile's end)
  float* cdt = ccum + cs;                  // [cs] its dt
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nc = S / cs, ntile = ceil_div(cs, kT), npt = ceil_div(P, kT);

  // heaviest row tiles first
  const int64_t per = BH * nc * npt;
  const int it = ntile - 1 - (int)(blockIdx.x / per);
  int64_t q = blockIdx.x % per;
  const int pt = (int)(q % npt);
  q /= npt;
  const int c = (int)(q % nc);
  const int64_t bh = q / nc, b = bh / H, h = bh % H;
  const int c0 = c * cs, i0 = it * kT, p0 = pt * kT;
  auto row = [&](int s) { return (b * S + c0 + s) * H + h; };   // of a [Bz, S, H] tensor
  auto row_n = [&](int s) { return (int64_t)row(s) * N; };
  const float* hc = hin + (bh * nc + c) * (int64_t)N * P;       // h_in[c], [N][P]
  const bool vec_h = P % 4 == 0 && aligned16(hin), vec_x = P % 4 == 0 && aligned16(x);

  // the slab stream: nslab slabs of h_in[c] (rows n), then nslab slabs of B
  // (transposed) for each column tile 0 .. it
  const int total = nslab * (it + 2);
  auto issue = [&](int s) {
    float* dst = ring + (s % kStages) * kK * kLd;
    if (s < nslab) {
      copy_rows<kK>(dst, hc, P, s * kK, N, p0, P, vec_h);
    } else {
      const int jt = (s - nslab) / nslab, k0 = (s - nslab) % nslab * kK;
      copy_transposed(dst, Bm, row_n, jt * kT, cs, k0, kK, N);
    }
  };
  // a float32 x tile goes straight to shared memory (rows j0.., columns p0..)
  auto issue_x = [&](int j0) {
    if constexpr (kF32)
      copy_rows<kT>(xs, (const float*)x + (int64_t)row(0) * P, (int64_t)H * P, j0, cs, p0, P,
                    vec_x);
  };

  copy_transposed(ct, Cm, row_n, i0, cs, 0, NK, N);
  issue(0);
  spm::cp_async_commit();
  issue(1);
  spm::cp_async_commit();
  const int ncum = min(cs, i0 + kT);
  for (int j = tid; j < ncum; j += kThr) {
    ccum[j] = __ldg(cum + bh * S + c0 + j);
    cdt[j] = __ldg(dt + row(j));
  }

  int s = 0;
  // slab s has landed for every thread; slab s + 2 goes on its way, and at
  // the first slab of column tile jt (every thread past tile jt - 1's
  // product) its x tile
  auto next = [&]() -> const float* {
    spm::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s >= nslab && (s - nslab) % nslab == 0) issue_x((s - nslab) / nslab * kT);
    if (s + 2 < total) issue(s + 2);
    spm::cp_async_commit();
    return ring + (s % kStages) * kK * kLd;
  };

  // inter: acc = exp(cum_i) (C_i h_in[c])
  float acc[8][4];
  zero(acc);
  for (int k = 0; k < nslab; ++k, ++s) {
    const float* slab = next();
    tile_fma<kK>(ct + k * kK * kLd, slab, ty, tx, acc);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + row_of(ty, r);
    const float din = i < cs ? expf(ccum[i]) : 0.f;
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) acc[r][qq] *= din;
  }

  // intra: column tiles j <= i
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    float g[8][4];
    zero(g);
    for (int k = 0; k < nslab; ++k, ++s) {
      const float* slab = next();
      tile_fma<kK>(ct + k * kK * kLd, slab, ty, tx, g);
    }
    // every thread is past the previous tile's product: ss is free
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int j = j0 + 4 * tx + qq;
      const float cj = j < cs ? ccum[j] : 0.f, dj = j < cs ? cdt[j] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[4];
#pragma unroll
        for (int r4 = 0; r4 < 4; ++r4) {
          const int r = 4 * half + r4, i = i0 + row_of(ty, r);
          // mask before the exp: cum_i - cum_j > 0 for j > i
          v[r4] = (j <= i && i < cs) ? g[r][qq] * expf(ccum[i] - cj) * dj : 0.f;
        }
        *reinterpret_cast<float4*>(ss + (j - j0) * kLd + 32 * half + 4 * ty) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    if constexpr (kF32) {
      // the x tile was committed at this tile's first slab, before the
      // nslab - 1 groups since
      if (nslab >= 2)
        spm::cp_async_wait<1>();
      else
        spm::cp_async_wait<0>();
    } else {
      for (int e = tid; e < kT * kT; e += kThr) {
        const int j = e / kT, p = e % kT;
        xs[j * kLd + p] = j0 + j < cs && p0 + p < P
                              ? widen(x[(int64_t)row(j0 + j) * P + p0 + p])
                              : 0.f;
      }
    }
    __syncthreads();
    // on the diagonal tile the warp's rows end at 32 + 8 warp + 7: the
    // scores past them are 0
    tile_fma<kT>(ss, xs, ty, tx, acc, jt == it ? 40 + 8 * (tid >> 5) : kT);
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + row_of(ty, r);
    if (i >= cs) continue;
    Tx* out = y + (int64_t)row(i) * P;
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int p = p0 + 4 * tx + qq;
      if (p < P) spm::store(out + p, acc[r][qq]);
    }
  }
}

// the shapes every launch takes: positive sizes, whole chunks, int32
// lengths, grids within 2^31 - 1 blocks
bool shapes_ok(int64_t Bz, int64_t S, int64_t H, int64_t P, int64_t N, int64_t cs) {
  if (Bz <= 0 || H <= 0 || P <= 0 || N <= 0 || S <= 0 || cs <= 0 || S % cs != 0) return false;
  if (S > INT32_MAX || P > INT32_MAX || N > INT32_MAX) return false;
  const int64_t tiles = Bz * H * (S / cs) * ((P + kT - 1) / kT);
  return tiles * ((N + kT - 1) / kT) <= INT32_MAX && tiles * ((cs + kT - 1) / kT) <= INT32_MAX;
}

template <typename Tx>
int launch_state(const void* x, const float* da, const float* dt, const float* Bm, float* states,
                 float* cum, int64_t Bz, int S, int H, int P, int N, int cs, cudaStream_t st) {
  auto kern = ssd_chunk_state_kernel<Tx>;
  const size_t smem = state_smem(cs);
  int err = spm::allow_smem(kern, smem);
  if (err) return err;
  const int64_t blocks = Bz * H * (S / cs) * ceil_div(N, kT) * ceil_div(P, kT);
  kern<<<(unsigned)blocks, kThr, smem, st>>>((const Tx*)x, da, dt, Bm, states, cum, S, H, P, N,
                                              cs);
  return (int)cudaGetLastError();
}

template <typename Tx>
int launch_scan(const void* x, const float* dt, const float* Bm, const float* Cm,
                const float* cum, const float* hin, void* y, int64_t Bz, int S, int H, int P,
                int N, int cs, cudaStream_t st) {
  auto kern = ssd_chunk_scan_kernel<Tx>;
  const size_t smem = scan_smem(N, cs);
  int err = spm::allow_smem(kern, smem);
  if (err) return err;
  const int64_t BH = Bz * H;
  const int64_t blocks = BH * (S / cs) * ceil_div(cs, kT) * ceil_div(P, kT);
  kern<<<(unsigned)blocks, kThr, smem, st>>>((const Tx*)x, dt, Bm, Cm, cum, hin, (Tx*)y, S, H, P,
                                              N, cs, BH);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher returns cudaGetLastError() after its launch (0 on success),
// or cudaErrorInvalidValue for shapes, types or shared memory it does not
// take. Every tensor is contiguous; x is F32 or BF16 by `dtype`, the rest
// float32. Workspaces: cum [Bz, H, S], states [Bz, H, S / cs, N, P].

// 1: states[b, h, c] = s_c and cum, from x, da, dt, B
extern "C" int ssd_chunk_state_launch(int dtype, const void* x, const void* da, const void* dt,
                                      const void* Bm, void* states, void* cum, int64_t Bz,
                                      int64_t S, int64_t H, int64_t P, int64_t N, int64_t cs,
                                      void* stream) {
  if (!shapes_ok(Bz, S, H, P, N, cs) || state_smem((int)cs) > spm::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == F32)
    return launch_state<float>(x, f(da), f(dt), f(Bm), (float*)states, (float*)cum, Bz, (int)S,
                               (int)H, (int)P, (int)N, (int)cs, st);
  if (dtype == BF16)
    return launch_state<__nv_bfloat16>(x, f(da), f(dt), f(Bm), (float*)states, (float*)cum, Bz,
                                       (int)S, (int)H, (int)P, (int)N, (int)cs, st);
  return (int)cudaErrorInvalidValue;
}

// 2: states[b, h, c] <- h_in[c] in place; state = the final h
extern "C" int ssd_state_pass_launch(void* states, const void* cum, void* state, int64_t Bz,
                                     int64_t S, int64_t H, int64_t P, int64_t N, int64_t cs,
                                     void* stream) {
  if (!shapes_ok(Bz, S, H, P, N, cs)) return (int)cudaErrorInvalidValue;
  const int64_t total = Bz * H * N * P;
  const int64_t blocks = (total + kPassThr - 1) / kPassThr;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  ssd_state_pass_kernel<<<(unsigned)blocks, kPassThr, 0, (cudaStream_t)stream>>>(
      (float*)states, (const float*)cum, (float*)state, (int)S, (int)cs, N * P, total);
  return (int)cudaGetLastError();
}

// 3: y from x, dt, B, C, cum and h_in (states after kernel 2)
extern "C" int ssd_chunk_scan_launch(int dtype, const void* x, const void* dt, const void* Bm,
                                     const void* Cm, const void* cum, const void* hin, void* y,
                                     int64_t Bz, int64_t S, int64_t H, int64_t P, int64_t N,
                                     int64_t cs, void* stream) {
  if (!shapes_ok(Bz, S, H, P, N, cs) || N > (1 << 20) ||
      scan_smem((int)N, (int)cs) > spm::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == F32)
    return launch_scan<float>(x, f(dt), f(Bm), f(Cm), f(cum), f(hin), y, Bz, (int)S, (int)H,
                              (int)P, (int)N, (int)cs, st);
  if (dtype == BF16)
    return launch_scan<__nv_bfloat16>(x, f(dt), f(Bm), f(Cm), f(cum), f(hin), y, Bz, (int)S,
                                      (int)H, (int)P, (int)N, (int)cs, st);
  return (int)cudaErrorInvalidValue;
}
