// The Mamba-2 SSD chunk scan as three kernels on one stream; this file holds
// the third, and ssd_train.cu the first two (which the training scan runs
// too). Per (batch b, head h) a state h [N, P] (float32, zero at the start,
// or an initial state) walks the sequence
// in chunks of cs steps; within chunk c, with cum the running sum of da over
// the chunk and xdt_j = x_j dt_j,
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xdt_j          (intra)
//         + exp(cum_i) (C_i h_in[c])                                  (inter)
//   h_in[c + 1] = exp(cum_last) h_in[c] + s_c,
//   s_c   = sum_j (B_j exp(cum_last - cum_j))^T xdt_j                  (chunk state)
// x [Bz, S, H, P] (float32, bf16 or float16), da and dt [Bz, S, H], B and C [Bz, S,
// G, N] for G groups dividing the heads (float32; the op passes them
// head-broadcast, G = H); y in x's type, the final state [Bz, H, N, P]
// float32. All arithmetic float32.
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
// registers (kernel 1; bf16 and float16 x in kernel 3) is loaded a slab
// ahead and used only after the slab's FMAs, so no warp waits on it.
// x's type is a template argument here and read at run time in kernel 1.
// Shared memory does not grow with P (tiled in the grid); kernel 1's does
// not grow with N (tiled in the grid too), kernel 3's only through that C
// tile: 37888 and 97792 bytes at the mamba2 row, so two blocks or more
// fit an SM. Where the whole C tile would pass a block's 227 KB (N above
// 608 at cs 256), kernel 3 streams C too (kStreamC): each slab of h_in or
// B arrives with the matching 32 n of C in a second ring, so shared
// memory is 89 KB at cs 256 whatever N, at the price of reading the C
// tile again for every column tile.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ssd_tiles.cuh"

namespace {

using namespace ssd;

constexpr int kStages = 3;          // kernel 3's cp.async ring

// kernel 3 holds the row tile's C whole (n_pad(N) rows) unless that passes
// a block's shared memory; then C streams through a ring like B's
size_t scan_smem_resident(int N, int cs) {
  return sizeof(float) * ((size_t)n_pad(N) * kLd + kStages * (size_t)kK * kLd +
                          2 * (size_t)kT * kLd + 2 * (size_t)cs);
}
bool scan_streams_c(int N, int cs) { return scan_smem_resident(N, cs) > spm::kMaxSmem; }
size_t scan_smem(int N, int cs) {
  if (!scan_streams_c(N, cs)) return scan_smem_resident(N, cs);
  return sizeof(float) * (2 * kStages * (size_t)kK * kLd + 2 * (size_t)kT * kLd +
                          2 * (size_t)cs);
}

// ---- 3. y ----------------------------------------------------------------------

template <typename Tx, bool kStreamC>
__global__ void __launch_bounds__(kThr)
ssd_chunk_scan_kernel(const Tx* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ cum, const float* __restrict__ hin,
                      Tx* __restrict__ y, int S, int H, int P, int N, int cs, int G,
                      int64_t BH) {
  constexpr bool kF32 = std::is_same<Tx, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int NK = n_pad(N), nslab = NK / kK;
  // [NK][kLd]: C of the row tile, n-major; streamed: kStages x [kK][kLd],
  // the slab of C matching each slab of the ring
  float* ct = smem;
  float* ring = ct + (kStreamC ? kStages * kK : NK) * kLd;   // kStages x [kK][kLd]: slabs of h_in[c] or B (n-major)
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
  const int64_t bh = q / nc, b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * cs, i0 = it * kT, p0 = pt * kT;
  auto row = [&](int s) { return (b * S + c0 + s) * H + h; };   // of a [Bz, S, H] tensor
  auto row_n = [&](int s) { return ((b * S + c0 + s) * G + g) * N; };   // of B, C
  const float* hc = hin + (bh * nc + c) * (int64_t)N * P;       // h_in[c], [N][P]
  const bool vec_h = P % 4 == 0 && aligned16(hin), vec_x = P % 4 == 0 && aligned16(x);

  // the slab stream: nslab slabs of h_in[c] (rows n), then nslab slabs of B
  // (transposed) for each column tile 0 .. it
  const int total = nslab * (it + 2);
  auto issue = [&](int s) {
    float* dst = ring + (s % kStages) * kK * kLd;
    const int k0 = (s < nslab ? s : (s - nslab) % nslab) * kK;
    if (s < nslab) {
      copy_rows<kK>(dst, hc, P, k0, N, p0, P, vec_h);
    } else {
      const int jt = (s - nslab) / nslab;
      copy_transposed(dst, Bm, row_n, jt * kT, cs, k0, kK, N);
    }
    if constexpr (kStreamC)
      copy_transposed(ct + (s % kStages) * kK * kLd, Cm, row_n, i0, cs, k0, kK, N);
  };
  // the C slab of stream step s (its k-th 32 n)
  auto c_slab = [&](int s, int k) {
    return kStreamC ? ct + (s % kStages) * kK * kLd : ct + k * kK * kLd;
  };
  // a float32 x tile goes straight to shared memory (rows j0.., columns p0..)
  auto issue_x = [&](int j0) {
    if constexpr (kF32)
      copy_rows<kT>(xs, (const float*)x + (int64_t)row(0) * P, (int64_t)H * P, j0, cs, p0, P,
                    vec_x);
  };

  if constexpr (!kStreamC) copy_transposed(ct, Cm, row_n, i0, cs, 0, NK, N);
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
    tile_fma<kK>(c_slab(s, k), slab, ty, tx, acc);
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
      tile_fma<kK>(c_slab(s, k), slab, ty, tx, g);
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
int launch_scan(const void* x, const float* dt, const float* Bm, const float* Cm,
                const float* cum, const float* hin, void* y, int64_t Bz, int S, int H, int P,
                int N, int cs, int G, cudaStream_t st) {
  auto kern = scan_streams_c(N, cs) ? ssd_chunk_scan_kernel<Tx, true>
                                    : ssd_chunk_scan_kernel<Tx, false>;
  const size_t smem = scan_smem(N, cs);
  int err = spm::allow_smem(kern, smem);
  if (err) return err;
  const int64_t BH = Bz * H;
  const int64_t blocks = BH * (S / cs) * ceil_div(cs, kT) * ceil_div(P, kT);
  kern<<<(unsigned)blocks, kThr, smem, st>>>((const Tx*)x, dt, Bm, Cm, cum, hin, (Tx*)y, S, H, P,
                                              N, cs, G, BH);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher returns cudaGetLastError() after its launch (0 on success),
// or cudaErrorInvalidValue for shapes, types or shared memory it does not
// take. Every tensor is contiguous; x is F32, BF16 or F16 by `dtype`, the rest
// float32; B and C are [Bz, S, G, N] for G groups that divide the H heads
// (head h reads group h / (H / G); G = H for head-broadcast B and C).
// Workspaces: cum [Bz, H, S], states [Bz, H, S / cs, N, P].

// 3: y from x, dt, B, C, cum and h_in (states after kernel 2)
extern "C" int ssd_chunk_scan_launch(int dtype, const void* x, const void* dt, const void* Bm,
                                     const void* Cm, const void* cum, const void* hin, void* y,
                                     int64_t Bz, int64_t S, int64_t H, int64_t P, int64_t N,
                                     int64_t cs, int64_t G, void* stream) {
  if (!shapes_ok(Bz, S, H, P, N, cs) || G <= 0 || H % G != 0 || N > (1 << 20) ||
      scan_smem((int)N, (int)cs) > spm::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == F32)
    return launch_scan<float>(x, f(dt), f(Bm), f(Cm), f(cum), f(hin), y, Bz, (int)S, (int)H,
                              (int)P, (int)N, (int)cs, (int)G, st);
  if (dtype == BF16)
    return launch_scan<__nv_bfloat16>(x, f(dt), f(Bm), f(Cm), f(cum), f(hin), y, Bz, (int)S,
                                      (int)H, (int)P, (int)N, (int)cs, (int)G, st);
  if (dtype == F16)
    return launch_scan<__half>(x, f(dt), f(Bm), f(Cm), f(cum), f(hin), y, Bz, (int)S, (int)H,
                               (int)P, (int)N, (int)cs, (int)G, st);
  return (int)cudaErrorInvalidValue;
}
