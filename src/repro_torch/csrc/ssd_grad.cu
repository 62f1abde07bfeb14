// The Mamba-2 SSD scan's backward for training, after ssd_train.cu's chunk-
// state and state-pass kernels in their backward forms (the chunk terms and
// the reverse pass that leaves each chunk's sbar). Per (batch b, head h,
// chunk c), in ssd_train.cu's notation, with sbar the gradient of the state
// the chunk ends with and dy of y:
//   ubar_j = sum_{i >= j} S_ij L_ij dy_i + exp(cum_last - cum_j) (B_j sbar)
//   Shat_ij = sum over the group's heads of (dy_i . u_j) L_ij
//   Cbar_i = sum_{j <= i} Shat_ij B_j + sum_heads exp(cum_i) (h_c dy_i)
//   Bbar_j = sum_{i >= j} Shat_ij C_i + sum_heads exp(cum_last - cum_j) (sbar u_j)
//   cumbar_i = sum_j W_ij - sum_k W_ki + dy_i . y_inter_i - r_i,
//     W = (dy . u) L S, y_inter_i . dy_i = C_i . (exp(cum_i) h_c dy_i),
//     r_j = u_j . (exp(cum_last - cum_j) (B_j sbar))
//   cumbar_last += sum_j r_j + exp(cum_last) <sbar, h_c>
// then abar = the reverse running sum of cumbar over the chunk, xbar = dt
// ubar, dtbar = x . ubar + abar A, Abar = sum abar dt. Summing the heads'
// (dy . u) L into Shat first makes the products with B and C one per group.
//
// Replaces no TPU kernel: the reference's zoo differentiates its plain
// ssd_chunked through XLA, whose eager backward took two fifths of a mamba2
// training step on the card. Every cs x cs tile (S L, dy . u, W) lives in
// registers and shared memory; device memory sees the inputs, the saved
// cum, chunk-start states and scores, the head-summed Shat [Bz, G, nc, cs,
// cs], the outputs, and per-row partial sums in workspaces [tiles, Bz, H,
// S].
//   ssd_bwd_dx_kernel: xbar, one block per (b, h, c, 64-row tile j,
//     64-column P tile): the inter term B_j sbar over N, then for each
//     column tile i >= j the scores masked BEFORE the exp and decayed, into
//     a product with dy_i, one pipelined sequence of steps; the row sums x
//     . ubar of its P tile.
//   ssd_bwd_ds_kernel: Shat, one block per (b, c, group, tile pair of the
//     lower triangle), looping over the group's heads in order: per head
//     dy . x over P, masked and decayed, into Shat (kept in registers), and
//     W's row and column sums.
//   ssd_bwd_dbc_kernel: Cbar (is_db false) or Bbar, one block per (b, c,
//     group, 64-row tile, 64-column N tile): the group's Shat product, then
//     each head's state term over P in order, and its row sums with the
//     tile's own C (dy . y_inter) or B (r).
//   ssd_bwd_dcum_kernel: one block per (b, h, c): cumbar from the
//     workspaces, <sbar, h_c>, the reverse running sum, dtbar, and the
//     chunk's share of Abar (summed over b and c by the wrapper).
// No float atomics: every sum has one order, so two runs give the same bits.
//
// What bounds them: operations, on the CUDA cores (float32 FMAs, no TF32),
// through ssd_tiles.cuh's tile routine; K is taken 64 at a time, the next
// tiles' loads in flight during a tile's product, so shared memory is two
// or three 64 x 68 tiles whatever N and P.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tiles.cuh"

namespace {

using namespace ssd;

constexpr int kCumThr = 256;        // threads of the dcum kernel

// ---- the backward ------------------------------------------------------------------

__global__ void __launch_bounds__(kThr)
ssd_bwd_dx_kernel(int dtype, const void* __restrict__ x, const void* __restrict__ dy,
                  const float* __restrict__ dt, const float* __restrict__ Bm,
                  const float* __restrict__ cum, const float* __restrict__ sbar,
                  const float* __restrict__ scores, void* __restrict__ dx,
                  float* __restrict__ ws_xu, int S, int H, int P, int N, int cs, int G,
                  int64_t BH) {
  extern __shared__ __align__(16) float smem[];
  float* ta = smem;                 // B^T (inter), then the decayed scores, i-major
  float* tb = ta + kTile;           // sbar's rows n (inter), then dy's rows i
  float* ccum = tb + kTile;         // [cs] the chunk's cum
  float* cdt = ccum + cs;           // [cs] its dt
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nc = S / cs, ntile = ceil_div(cs, kT), npt = ceil_div(P, kT);
  // heaviest first: row tile jt does ntile - jt column tiles
  const int64_t per = BH * nc * npt;
  const int jt = (int)(blockIdx.x / per);
  int64_t q = blockIdx.x % per;
  const int pt = (int)(q % npt);
  q /= npt;
  const int c = (int)(q % nc);
  const int64_t bh = q / nc, b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * cs, j0 = jt * kT, p0 = pt * kT;
  auto row = [&](int s) { return (b * S + c0 + s) * H + h; };           // of [Bz, S, H]
  auto row_n = [&](int s) { return ((b * S + c0 + s) * G + g) * N; };   // of B
  auto row_p = [&](int s) { return row(s) * P; };                       // of x, dy
  const float* sc = scores + ((b * G + g) * nc + c) * (int64_t)cs * cs;
  const float* sbc = sbar + (bh * nc + c) * (int64_t)N * P;
  for (int t = tid; t < cs; t += kThr) {
    ccum[t] = __ldg(cum + bh * S + c0 + t);
    cdt[t] = __ldg(dt + row(t));
  }

  // steps: the inter term's 64-n slabs (B^T and sbar's rows), then the
  // column tiles i >= j (the decayed scores and dy's rows); the next
  // step's loads in flight during a step's product
  const int ninter = ceil_div(N, kT), nstep = ninter + ntile - jt;
  Staged sa, sb;
  auto fetch = [&](int step) {
    if (step < ninter) {
      sa.fetch_t(Bm, F32, row_n, j0, cs, step * kT, N);
      sb.fetch_rows(sbc, F32, [&](int n) { return (int64_t)n * P; }, step * kT, N, p0, P);
    } else {
      const int i0 = (jt + step - ninter) * kT;
      sa.fetch_rows(sc, F32, [&](int i) { return (int64_t)i * cs; }, i0, cs, j0, cs);
      sb.fetch_rows(dy, dtype, row_p, i0, cs, p0, P);
    }
  };
  fetch(0);
  float acc[8][4];
  zero(acc);
  for (int step = 0; step < nstep; ++step) {
    const int i0 = (jt + step - ninter) * kT;
    if (step < ninter) {
      sa.put_t(ta, F32, same);
      sb.put_rows(tb, F32, same);
    } else {
      if (step == ninter) {           // the inter term whole: exp(cum_last - cum_j) (B_j sbar)
        const float last = ccum[cs - 1];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int j = j0 + row_of(ty, r);
          const float w = j < cs ? expf(last - ccum[j]) : 0.f;
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) acc[r][qq] *= w;
        }
      }
      sa.put_rows(ta, F32, [&](int i, int j, float v) {
        // mask before the exp: cum_i - cum_j > 0 for i < j
        return i0 + i >= j0 + j && i0 + i < cs ? v * expf(ccum[i0 + i] - ccum[j0 + j]) : 0.f;
      });
      sb.put_rows(tb, dtype, same);
    }
    __syncthreads();
    if (step + 1 < nstep) fetch(step + 1);
    tile_fma<kT>(ta, tb, ty, tx, acc);
    __syncthreads();
  }

  // xbar = dt ubar, and the row sums x . ubar of this P tile
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = j0 + row_of(ty, r);
    float s = 0.f;
    if (j < cs) {
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int p = p0 + 4 * tx + qq;
        if (p < P) {
          const int64_t o = row_p(j) + p;
          s = fmaf(ld(x, dtype, o), acc[r][qq], s);
          st(dx, dtype, o, cdt[j] * acc[r][qq]);
        }
      }
    }
    s = sum16(s);
    if (tx == 0 && j < cs) ws_xu[((int64_t)pt * BH + bh) * S + c0 + j] = s;
  }
}

__global__ void __launch_bounds__(kThr)
ssd_bwd_ds_kernel(int dtype, const void* __restrict__ x, const void* __restrict__ dy,
                  const float* __restrict__ dt, const float* __restrict__ cum,
                  const float* __restrict__ scores, float* __restrict__ shat,
                  float* __restrict__ ws_wrow, float* __restrict__ ws_wcol, int S, int H, int P,
                  int cs, int G, int64_t Bz) {
  extern __shared__ __align__(16) float smem[];
  float* ta = smem;                 // dy^T of the row tile, p-major
  float* tb = ta + kTile;           // x^T of the column tile, p-major
  float* ts = tb + kTile;           // S of the tile pair, rows i, columns j
  float* ci = ts + kTile;           // [kT] cum of the rows (this head's)
  float* cj = ci + kT;              // [kT] cum of the columns
  float* dj = cj + kT;              // [kT] dt of the columns
  float* red = dj + kT;             // [4][kT] the warps' column sums
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, lane = tid & 31, warp = tid >> 5;
  const int nc = S / cs, ntile = ceil_div(cs, kT), npair = ntile * (ntile + 1) / 2;
  const int rep = H / G, npk = ceil_div(P, kT), nstep = rep * npk;
  const int64_t BH = Bz * H;
  int64_t q = blockIdx.x;
  const int pr = (int)(q % npair);
  q /= npair;
  const int c = (int)(q % nc);
  const int64_t bg = q / nc, b = bg / G, g = bg % G;
  int it, jt;
  tri_pair(pr, it, jt);
  const int c0 = c * cs, i0 = it * kT, j0 = jt * kT;
  const int64_t tile0 = (bg * nc + c) * (int64_t)cs * cs;

  // step s: head g rep + s / npk, 64 p from (s % npk) 64; its tiles (and, at
  // a head's first step, its cum and dt) in flight during the last step
  Staged sa, sb;
  float rci = 0.f, rcj = 0.f, rdj = 0.f;
  auto fetch = [&](int s) {
    const int64_t h = g * rep + s / npk, bh = b * H + h;
    const int pk = (s % npk) * kT;
    auto row_p = [&](int t) { return ((b * S + c0 + t) * H + h) * P; };   // of x, dy
    sa.fetch_t(dy, dtype, row_p, i0, cs, pk, P);
    sb.fetch_t(x, dtype, row_p, j0, cs, pk, P);
    if (s % npk == 0 && tid < kT) {
      rci = i0 + tid < cs ? __ldg(cum + bh * S + c0 + i0 + tid) : 0.f;
      rcj = j0 + tid < cs ? __ldg(cum + bh * S + c0 + j0 + tid) : 0.f;
      rdj = j0 + tid < cs ? __ldg(dt + (b * S + c0 + j0 + tid) * H + h) : 0.f;
    }
  };
  fetch(0);

  copy_rows<kT>(ts, scores + tile0, cs, i0, cs, j0, cs, cs % 4 == 0 && aligned16(scores));
  spm::cp_async_commit();
  float sh[8][4], d[8][4];
  zero(sh);
  zero(d);
  for (int s = 0; s < nstep; ++s) {
    const int64_t bh = b * H + g * rep + s / npk;
    __syncthreads();                // the last step is done with the tiles, ci, cj, dj, red
    sa.put_t(ta, dtype, same);
    sb.put_t(tb, dtype, same);
    if (s % npk == 0 && tid < kT) {
      ci[tid] = rci;
      cj[tid] = rcj;
      dj[tid] = rdj;
    }
    spm::cp_async_wait<0>();        // S, at the first step
    __syncthreads();
    if (s + 1 < nstep) fetch(s + 1);
    tile_fma<kT>(ta, tb, ty, tx, d);
    if (s % npk != npk - 1) continue;

    // the head's sbar_ij = (dy_i . x_j) dt_j exp(cum_i - cum_j) for j <= i,
    // masked before the exp, into Shat; W = sbar S
    float rs[8], cl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int il = row_of(ty, r), i = i0 + il;
      rs[r] = 0.f;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int jl = 4 * tx + qq, j = j0 + jl;
        const float v = i < cs && j <= i ? d[r][qq] * dj[jl] * expf(ci[il] - cj[jl]) : 0.f;
        sh[r][qq] += v;
        const float w = v * ts[il * kLd + jl];
        rs[r] += w;
        cl[qq] += w;
      }
    }
    zero(d);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float v = sum16(rs[r]);
      const int i = i0 + row_of(ty, r);
      if (tx == 0 && i < cs) ws_wrow[((int64_t)jt * BH + bh) * S + c0 + i] = v;
    }
    // the column sums: the warp's two rows of threads, then the four warps
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const float v = cl[qq] + __shfl_xor_sync(0xffffffffu, cl[qq], 16);
      if (lane < 16) red[warp * kT + 4 * tx + qq] = v;
    }
    __syncthreads();
    if (tid < kT && j0 + tid < cs)
      ws_wcol[((int64_t)it * BH + bh) * S + c0 + j0 + tid] =
          red[tid] + red[kT + tid] + red[2 * kT + tid] + red[3 * kT + tid];
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + row_of(ty, r);
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int j = j0 + 4 * tx + qq;
      if (i < cs && j < cs) shat[tile0 + (int64_t)i * cs + j] = sh[r][qq];
    }
  }
}

// is_db false: Cbar, rows i (the Shat product over j <= i with B, then per
// head exp(cum_i) dy_i . h_c over P, and the head's row sums C_i . that,
// dy_i . y_inter_i); true: Bbar, rows j (over i >= j with C, then per head
// exp(cum_last - cum_j) dt_j x_j . sbar over P, and the row sums B_j .
// that, r_j).
__global__ void __launch_bounds__(kThr)
ssd_bwd_dbc_kernel(int dtype, bool is_db, const void* __restrict__ x,
                   const void* __restrict__ dy, const float* __restrict__ dt,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ cum, const float* __restrict__ state,
                   const float* __restrict__ shat, float* __restrict__ out,
                   float* __restrict__ ws_dot, int S, int H, int P, int N, int cs, int G,
                   int64_t Bz) {
  extern __shared__ __align__(16) float smem[];
  float* ta = smem;                 // Shat (k-major), then dy^T or x^T of the row tile
  float* tb = ta + kTile;           // partner rows of a column tile, then the state^T
  float* ot = tb + kTile;           // the row tile's own rows (C, or B for Bbar)
  float* rcum = ot + kTile;         // [kT] cum of the rows (this head's)
  float* rdt = rcum + kT;           // [kT] dt of the rows
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nc = S / cs, ntile = ceil_div(cs, kT), ntn = ceil_div(N, kT), rep = H / G;
  const int npk = ceil_div(P, kT), nstep = rep * npk;
  const int64_t BH = Bz * H;
  const int64_t per = Bz * G * nc * ntn;
  const int k_ = (int)(blockIdx.x / per);
  const int t = is_db ? k_ : ntile - 1 - k_;
  int64_t q = blockIdx.x % per;
  const int nt = (int)(q % ntn);
  q /= ntn;
  const int c = (int)(q % nc);
  const int64_t bg = q / nc, b = bg / G, g = bg % G;
  const int c0 = c * cs, r0 = t * kT, n0 = nt * kT;
  const float* part = (is_db ? Cm : Bm) + ((b * S + c0) * G + g) * N;   // row s at s G N
  const float* sh = shat + (bg * nc + c) * (int64_t)cs * cs;
  const bool vec_n = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  const void* R = is_db ? x : dy;

  // step s: head g rep + s / npk, 64 p from (s % npk) 64; its tiles (and, at
  // a head's first step, its cum and dt) in flight during the last step
  Staged sa, sb;
  float rc = 0.f, rd = 0.f, rl = 0.f;
  auto fetch = [&](int s) {
    const int64_t h = g * rep + s / npk, bh = b * H + h;
    const int pk = (s % npk) * kT;
    auto row_p = [&](int u) { return ((b * S + c0 + u) * H + h) * P; };   // of x, dy
    sa.fetch_t(R, dtype, row_p, r0, cs, pk, P);
    sb.fetch_t(state + (bh * nc + c) * (int64_t)N * P, F32,
               [&](int n) { return (int64_t)n * P; }, n0, N, pk, P);
    if (s % npk == 0) {
      rl = __ldg(cum + bh * S + c0 + cs - 1);
      if (tid < kT && r0 + tid < cs) {
        rc = __ldg(cum + bh * S + c0 + r0 + tid);
        rd = __ldg(dt + (b * S + c0 + r0 + tid) * H + h);
      }
    }
  };
  fetch(0);

  copy_rows<kT>(ot, (is_db ? Bm : Cm) + ((b * S + c0) * G + g) * N, (int64_t)G * N, r0, cs, n0,
                N, vec_n);
  float acc[8][4];
  zero(acc);
  // the group's Shat product: over column tiles j <= i (Cbar) or i >= j (Bbar)
  for (int kt = is_db ? t : 0; kt <= (is_db ? ntile - 1 : t); ++kt) {
    const int k0 = kt * kT;
    if (is_db)
      copy_rows<kT>(ta, sh, cs, k0, cs, r0, cs, cs % 4 == 0 && aligned16(shat));
    else
      copy_transposed(ta, sh, [&](int i) { return (int64_t)i * cs; }, r0, cs, k0, kT, cs);
    copy_rows<kT>(tb, part, (int64_t)G * N, k0, cs, n0, N, vec_n);
    spm::cp_async_commit();
    spm::cp_async_wait<0>();
    __syncthreads();
    tile_fma<kT>(ta, tb, ty, tx, acc);
    __syncthreads();
  }

  // each head's state term, in order
  float ah[8][4], last = 0.f;
  zero(ah);
  for (int s = 0; s < nstep; ++s) {
    const int64_t bh = b * H + g * rep + s / npk;
    if (s > 0) __syncthreads();     // the last step is done with the tiles, rcum, rdt
    sa.put_t(ta, dtype, same);
    sb.put_t(tb, F32, same);
    if (s % npk == 0) {
      last = rl;
      if (tid < kT) {
        rcum[tid] = rc;
        rdt[tid] = rd;
      }
    }
    __syncthreads();
    if (s + 1 < nstep) fetch(s + 1);
    tile_fma<kT>(ta, tb, ty, tx, ah);
    if (s % npk != npk - 1) continue;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int rl_ = row_of(ty, r), rho = r0 + rl_;
      const float w = rho >= cs ? 0.f
                      : is_db   ? expf(last - rcum[rl_]) * rdt[rl_]
                                : expf(rcum[rl_]);
      float sdot = 0.f;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        ah[r][qq] *= w;
        acc[r][qq] += ah[r][qq];
        sdot = fmaf(ot[rl_ * kLd + 4 * tx + qq], ah[r][qq], sdot);
      }
      sdot = sum16(sdot);
      if (tx == 0 && rho < cs) ws_dot[((int64_t)nt * BH + bh) * S + c0 + rho] = sdot;
    }
    zero(ah);
  }

  float* o = out + ((b * S + c0) * G + g) * N;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int rho = r0 + row_of(ty, r);
    if (rho >= cs) continue;
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int n = n0 + 4 * tx + qq;
      if (n < N) o[(int64_t)rho * G * N + n] = acc[r][qq];
    }
  }
}

__global__ void __launch_bounds__(kCumThr)
ssd_bwd_dcum_kernel(const float* __restrict__ cum, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ ws_xu,
                    const float* __restrict__ ws_r, const float* __restrict__ ws_wrow,
                    const float* __restrict__ ws_wcol, const float* __restrict__ ws_yd,
                    const float* __restrict__ sbar, const float* __restrict__ hin,
                    float* __restrict__ ddt, float* __restrict__ dA_part, int S, int H, int cs,
                    int64_t NP, int npt, int ntn, int64_t BHS) {
  extern __shared__ __align__(16) float smem[];
  float* cb = smem;                 // [cs]: cumbar, then abar
  __shared__ float red[kCumThr / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = S / cs, ntile = ceil_div(cs, kT);
  const int64_t bhc = blockIdx.x, bh = bhc / nc, b = bh / H, h = bh % H;
  const int c0 = (int)(bhc % nc) * cs;
  const int64_t o = bh * S + c0;    // the chunk's row 0 in a [Bz, H, S] tensor

  const float* sp = sbar + bhc * NP;
  const float* hp = hin + bhc * NP;
  float d = 0.f;
  for (int64_t e = tid; e < NP; e += kCumThr) d = fmaf(sp[e], hp[e], d);
  float rsum = 0.f;
  for (int t = tid; t < cs; t += kCumThr) {
    // W's row sums over the column tiles j <= t, its column sums over the
    // row tiles i >= t
    float v = 0.f, rr = 0.f;
    for (int k = 0; k <= t / kT; ++k) v += ws_wrow[k * BHS + o + t];
    for (int k = t / kT; k < ntile; ++k) v -= ws_wcol[k * BHS + o + t];
    for (int k = 0; k < ntn; ++k) v += ws_yd[k * BHS + o + t];
    for (int k = 0; k < ntn; ++k) rr += ws_r[k * BHS + o + t];
    cb[t] = v - rr;
    rsum += rr;
  }
  d = block_sum(d, red);
  rsum = block_sum(rsum, red);
  if (tid == 0) cb[cs - 1] += rsum + expf(cum[o + cs - 1]) * d;
  __syncthreads();
  // abar_t = sum_{i >= t} cumbar_i: warp 0 scans from the chunk's end
  if (warp == 0) {
    float carry = 0.f;
    for (int base = cs - 1; base >= 0; base -= 32) {
      const int t = base - lane;
      float v = t >= 0 ? cb[t] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (t >= 0) cb[t] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const float a = __ldg(A + h);
  float ap = 0.f;
  for (int t = tid; t < cs; t += kCumThr) {
    float v = 0.f;
    for (int k = 0; k < npt; ++k) v += ws_xu[k * BHS + o + t];
    const int64_t rt = (b * S + c0 + t) * H + h;
    ddt[rt] = fmaf(cb[t], a, v);
    ap = fmaf(cb[t], __ldg(dt + rt), ap);
  }
  ap = block_sum(ap, red);
  if (tid == 0) dA_part[bhc] = ap;
}
}  // namespace

// Each launcher returns cudaGetLastError() after its launch (0 on success),
// or cudaErrorInvalidValue for shapes or types it does not take. Every
// tensor is contiguous: x, dy, y and dx [Bz, S, H, P] of type `dtype` (F32,
// BF16, F16); dt [Bz, S, H], A [H], B and C [Bz, S, G, N] (head h reads group
// h / (H / G)), cum [Bz, H, S], the chunk-start states h_in and their
// gradients sbar [Bz, H, S / cs, N, P], the scores and Shat [Bz, G, S / cs,
// cs, cs] and the rest float32. Workspaces of row sums [tiles, Bz, H, S].

extern "C" int ssd_bwd_dx_launch(int dtype, const void* x, const void* dy, const void* dt,
                                 const void* Bm, const void* cum, const void* sbar,
                                 const void* scores, void* dx, void* ws_xu, int64_t Bz,
                                 int64_t S, int64_t H, int64_t P, int64_t N, int64_t cs,
                                 int64_t G, void* stream) {
  if (!train_shapes_ok(Bz, S, H, P, N, cs, G) || dtype < F32 || dtype > F16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tiles_smem(2, (int)cs);
  int err = spm::allow_smem(ssd_bwd_dx_kernel, smem);
  if (err) return err;
  const int64_t BH = Bz * H;
  const int64_t blocks = BH * (S / cs) * ceil_div((int)P, kT) * ceil_div((int)cs, kT);
  ssd_bwd_dx_kernel<<<(unsigned)blocks, kThr, smem, (cudaStream_t)stream>>>(
      (int)dtype, x, dy, (const float*)dt, (const float*)Bm, (const float*)cum,
      (const float*)sbar, (const float*)scores, dx, (float*)ws_xu, (int)S, (int)H, (int)P, (int)N,
      (int)cs, (int)G, BH);
  return (int)cudaGetLastError();
}

extern "C" int ssd_bwd_ds_launch(int dtype, const void* x, const void* dy, const void* dt,
                                 const void* cum, const void* scores, void* shat, void* ws_wrow,
                                 void* ws_wcol, int64_t Bz, int64_t S, int64_t H, int64_t P,
                                 int64_t cs, int64_t G, void* stream) {
  if (!train_shapes_ok(Bz, S, H, P, 1, cs, G) || dtype < F32 || dtype > F16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (3 * (size_t)kTile + 7 * (size_t)kT);
  int err = spm::allow_smem(ssd_bwd_ds_kernel, smem);
  if (err) return err;
  const int ntile = ceil_div((int)cs, kT);
  const int64_t blocks = Bz * G * (S / cs) * (ntile * (ntile + 1) / 2);
  ssd_bwd_ds_kernel<<<(unsigned)blocks, kThr, smem, (cudaStream_t)stream>>>(
      (int)dtype, x, dy, (const float*)dt, (const float*)cum, (const float*)scores,
      (float*)shat, (float*)ws_wrow, (float*)ws_wcol, (int)S, (int)H, (int)P, (int)cs, (int)G,
      Bz);
  return (int)cudaGetLastError();
}

extern "C" int ssd_bwd_dbc_launch(int dtype, int is_db, const void* x, const void* dy,
                                  const void* dt, const void* Bm, const void* Cm,
                                  const void* cum, const void* state, const void* shat,
                                  void* out, void* ws_dot, int64_t Bz, int64_t S, int64_t H,
                                  int64_t P, int64_t N, int64_t cs, int64_t G, void* stream) {
  if (!train_shapes_ok(Bz, S, H, P, N, cs, G) || dtype < F32 || dtype > F16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tiles_smem(3, kT);
  int err = spm::allow_smem(ssd_bwd_dbc_kernel, smem);
  if (err) return err;
  const int64_t blocks = Bz * G * (S / cs) * ceil_div((int)N, kT) * ceil_div((int)cs, kT);
  ssd_bwd_dbc_kernel<<<(unsigned)blocks, kThr, smem, (cudaStream_t)stream>>>(
      (int)dtype, is_db != 0, x, dy, (const float*)dt, (const float*)Bm, (const float*)Cm,
      (const float*)cum, (const float*)state, (const float*)shat, (float*)out, (float*)ws_dot,
      (int)S, (int)H, (int)P, (int)N, (int)cs, (int)G, Bz);
  return (int)cudaGetLastError();
}

extern "C" int ssd_bwd_dcum_launch(const void* cum, const void* dt, const void* A,
                                   const void* ws_xu, const void* ws_r, const void* ws_wrow,
                                   const void* ws_wcol, const void* ws_yd, const void* sbar,
                                   const void* hin, void* ddt, void* dA_part, int64_t Bz,
                                   int64_t S, int64_t H, int64_t P, int64_t N, int64_t cs,
                                   void* stream) {
  if (!train_shapes_ok(Bz, S, H, P, N, cs, 1)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)cs;
  int err = spm::allow_smem(ssd_bwd_dcum_kernel, smem);
  if (err) return err;
  const int64_t blocks = Bz * H * (S / cs);
  ssd_bwd_dcum_kernel<<<(unsigned)blocks, kCumThr, smem, (cudaStream_t)stream>>>(
      (const float*)cum, (const float*)dt, (const float*)A, (const float*)ws_xu,
      (const float*)ws_r, (const float*)ws_wrow, (const float*)ws_wcol, (const float*)ws_yd,
      (const float*)sbar, (const float*)hin, (float*)ddt, (float*)dA_part, (int)S, (int)H,
      (int)cs, N * P, ceil_div((int)P, kT), ceil_div((int)N, kT), Bz * H * S);
  return (int)cudaGetLastError();
}
