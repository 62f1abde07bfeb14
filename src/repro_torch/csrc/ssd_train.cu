// The Mamba-2 SSD scan's forward, for the op (ops.ssd_scan_op) and for
// training (ssd_grad.cu holds the backward): the chunk states and the scan
// over chunks, the scores, and y from them. Per
// (batch b, head h, chunk c), with u = dt x, cum the running sum of dt A
// over the chunk, S_ij = C_i . B_j (once per group: head h reads group h /
// (H / G)), L_ij = exp(cum_i - cum_j) for j <= i (else 0) and h_c the state
// the chunk starts from:
//   y_i     = sum_{j <= i} S_ij L_ij u_j + exp(cum_i) (C_i h_c)
//   h_{c+1} = exp(cum_last) h_c + sum_j exp(cum_last - cum_j) B_j^T u_j
// from h_0 the initial state (or 0); all arithmetic float32.
//
// The four kernels, launched 3, 1, 2, 4, replace the TPU kernel
// repro/kernels/ssd_scan.py::_ssd_kernel (one grid step per (b, h, chunk),
// C B^T per head). In training they also replace the reference zoo's plain
// ssd_chunked, whose eager forward took a third of a mamba2 training
// step's SSD on the card in float32 elementwise passes over [b, c, h, 256,
// 256] tensors (the backward, two thirds, is ssd_grad.cu's). Kernels 1
// and 2 also have a backward form.
//   1. ssd_chunk_state_kernel: every chunk's own state from zero, an [N x
//      cs] . [cs x P] product, one block per (b, h, c, 64-row N tile,
//      64-column P tile); it writes cum to [Bz, H, S]. Backward form: the
//      chunk terms sum_i exp(cum_i) C_i^T dy_i (C in B's place, dy in x's).
//   2. ssd_state_pass_kernel: the scan over chunks, one thread per state
//      element, in place (h_c over each chunk's own state), from the
//      initial state. Backward form: the same recurrence in reverse from
//      the final state's gradient, leaving each chunk's sbar = hbar_{c+1}.
//   3. ssd_scores_kernel: S of each (b, c, group), one block per 64 x 64
//      tile of the chunk's lower triangle, a product over N: the heads
//      share it, so y and the backward read it instead of forming C . B
//      per head (33.5 MB at the mamba2 row, mostly in L2).
//   4. ssd_train_scan_kernel: y, one block per (b, h, c, 64-row tile i,
//      64-column P tile): the inter term C_i h_c over N, then for each
//      column tile j <= i the scores masked BEFORE the exp (exp(cum_i -
//      cum_j) overflows for j > i), decayed and times dt_j, into a product
//      with x_j. Row tile i does i + 1 column tiles: the heaviest run
//      first.
//
// What bounds them: operations, on the CUDA cores (float32 FMAs, no TF32),
// through ssd_tiles.cuh's tile routine. Operands arrive by cp.async
// (float32) or through registers (x and dy in their own type, chosen at
// run time, so each kernel builds once), the next tile's loads in flight
// during a tile's product. Shared memory: kernel 1 two stages of 32-row
// slabs; kernels 3 and 4 two 64 x 68 tiles (and the chunk's cum and dt),
// whatever N and P.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tiles.cuh"

namespace {

using namespace ssd;

constexpr int kPassThr = 256;       // threads of the state pass
constexpr int kPassUnroll = 8;      // chunk states the state pass loads at once

size_t state_smem(int cs) { return sizeof(float) * (4 * (size_t)kK * kLd + 3 * (size_t)cs); }

// ---- 1. chunk states --------------------------------------------------------

__global__ void __launch_bounds__(kThr)
ssd_chunk_state_kernel(int dtype, const void* __restrict__ x, const float* __restrict__ da,
                       const float* __restrict__ dt, const float* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ cum, int S, int H, int P,
                       int N, int cs, int G, bool bwd) {
  extern __shared__ __align__(16) float smem[];
  float* ring_b = smem;                   // 2 x [kK][kLd]: B rows j, columns n
  float* ring_x = ring_b + 2 * kK * kLd;  // 2 x [kK][kLd]: xdt_j exp(cum_last - cum_j)
  float* ccum = ring_x + 2 * kK * kLd;    // [cs] the chunk's cum
  float* cdt = ccum + cs;                 // [cs] its dt (1 in the backward's form)
  float* cw = cdt + cs;                   // [cs] exp(cum_last - cum_j) (exp(cum_j) backward)
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int nc = S / cs, ntn = ceil_div(N, kT), npt = ceil_div(P, kT);
  int64_t q = blockIdx.x;
  const int pt = (int)(q % npt);
  q /= npt;
  const int nt = (int)(q % ntn);
  q /= ntn;
  const int c = (int)(q % nc);
  const int64_t bh = q / nc, b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * cs, n0 = nt * kT, p0 = pt * kT;
  auto row = [&](int s) { return (b * S + c0 + s) * H + h; };   // of a [Bz, S, H] tensor

  // cum = cumsum(da) over the chunk: one warp's scan
  for (int j = tid; j < cs; j += kThr) {
    ccum[j] = __ldg(da + row(j));
    cdt[j] = bwd ? 1.f : __ldg(dt + row(j));
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
    if (cum != nullptr && nt == 0 && pt == 0) cum[bh * S + c0 + j] = ccum[j];
    cw[j] = expf(bwd ? ccum[j] : last - ccum[j]);
  }
  __syncthreads();

  const int nslab = ceil_div(cs, kK);
  const bool vec_b = N % 4 == 0 && aligned16(Bm);
  const float* bc = Bm + ((b * S + c0) * G + g) * N;      // row j at bc + j G N
  auto issue_b = [&](int s) {
    copy_rows<kK>(ring_b + (s & 1) * kK * kLd, bc, (int64_t)G * N, s * kK, cs, n0, N, vec_b);
  };
  // x of slab s, raw into registers (nothing uses them until store_x, so
  // the loads stay in flight during a slab's FMAs), then x dt w into
  // the ring
  constexpr int kXr = kK * kT / kThr, kXStep = kThr / kT;   // rows jx + 2 m, column px
  const int jx = tid / kT, px = tid % kT;
  const bool pin = p0 + px < P;
  const int64_t xo = (int64_t)row(jx) * P + p0 + px;
  const int64_t xstep = (int64_t)H * P;                       // one sequence step
  uint32_t xr[kXr];                                           // raw, in x's type
  auto load_x = [&](int s) {
    const int j0 = s * kK;
#pragma unroll
    for (int m = 0; m < kXr; ++m) {
      const int j = j0 + jx + kXStep * m;
      xr[m] = pin && j < cs ? bits_of(x, dtype, xo + (int64_t)(j0 + kXStep * m) * xstep) : 0u;
    }
  };
  auto store_x = [&](int s) {
    float* dst = ring_x + (s & 1) * kK * kLd;
    const int j0 = s * kK;
#pragma unroll
    for (int m = 0; m < kXr; ++m) {
      const int j = j0 + jx + kXStep * m;
      dst[(jx + kXStep * m) * kLd + px] = j < cs ? value_of(xr[m], dtype) * cdt[j] * cw[j] : 0.f;
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

// Forward (rev false): chunks in order from h0 = init (or 0). Backward's
// form (rev true): the same recurrence over the chunks in reverse, from the
// final state's gradient, taking the chunk terms sum_i exp(cum_i) C_i^T
// dy_i; it leaves each chunk's hbar_{c+1} and returns hbar_0.
__global__ void __launch_bounds__(kPassThr)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ cum,
                      float* __restrict__ state, const float* __restrict__ init, int S, int cs,
                      int64_t NP, int64_t total, bool rev) {
  const int64_t e = (int64_t)blockIdx.x * kPassThr + threadIdx.x;
  if (e >= total) return;
  const int nc = S / cs;
  const int64_t bh = e / NP;
  float* sp = states + bh * nc * NP + e % NP;        // s_c at sp[c NP]
  const float* last = cum + bh * S + cs - 1;         // cum_last of chunk c at last[c cs]
  float hv = init != nullptr ? init[e] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPassUnroll) {
    float sv[kPassUnroll], dv[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int c = rev ? nc - 1 - (c0 + u) : c0 + u;
      if (c0 + u < nc) {
        sv[u] = sp[(int64_t)c * NP];
        dv[u] = expf(__ldg(last + (int64_t)c * cs));
      }
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int c = rev ? nc - 1 - (c0 + u) : c0 + u;
      if (c0 + u < nc) {
        sp[(int64_t)c * NP] = hv;                    // h_in[c] (hbar_{c+1} backward)
        hv = __fadd_rn(__fmul_rn(dv[u], hv), sv[u]);  // exp(cum_last) h + s_c
      }
    }
  }
  state[e] = hv;
}

// ---- the forward -------------------------------------------------------------------

__global__ void __launch_bounds__(kThr)
ssd_scores_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                  float* __restrict__ scores, int S, int N, int cs, int G) {
  extern __shared__ __align__(16) float smem[];
  float* ta = smem;                 // C^T of the row tile, 64 n
  float* tb = ta + kTile;           // B^T of the column tile
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nc = S / cs, ntile = ceil_div(cs, kT), npair = ntile * (ntile + 1) / 2;
  int64_t q = blockIdx.x;
  const int pr = (int)(q % npair);
  q /= npair;
  const int c = (int)(q % nc);
  const int64_t bg = q / nc, b = bg / G, g = bg % G;
  int it, jt;
  tri_pair(pr, it, jt);
  const int c0 = c * cs, i0 = it * kT, j0 = jt * kT;
  auto row_n = [&](int s) { return ((b * S + c0 + s) * G + g) * N; };
  float acc[8][4];
  zero(acc);
  for (int n0 = 0; n0 < N; n0 += kT) {
    const int nk = min(kT, n_pad(N - n0));
    copy_transposed(ta, Cm, row_n, i0, cs, n0, nk, N);
    copy_transposed(tb, Bm, row_n, j0, cs, n0, nk, N);
    spm::cp_async_commit();
    spm::cp_async_wait<0>();
    __syncthreads();
    tile_fma<kT>(ta, tb, ty, tx, acc, nk);
    __syncthreads();
  }
  float* out = scores + (bg * nc + c) * (int64_t)cs * cs;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + row_of(ty, r);
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int j = j0 + 4 * tx + qq;
      if (i < cs && j < cs) out[(int64_t)i * cs + j] = acc[r][qq];
    }
  }
}

__global__ void __launch_bounds__(kThr)
ssd_train_scan_kernel(int dtype, const void* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ Cm, const float* __restrict__ cum,
                      const float* __restrict__ hin, const float* __restrict__ scores,
                      void* __restrict__ y, int S, int H, int P, int N, int cs, int G,
                      int64_t BH) {
  extern __shared__ __align__(16) float smem[];
  float* ta = smem;                 // C^T (inter), then the decayed scores, j-major
  float* tb = ta + kTile;           // h_c's rows n (inter), then x's rows j
  float* ccum = tb + kTile;         // [cs] the chunk's cum (rows up to the tile's end)
  float* cdt = ccum + cs;           // [cs] its dt
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, warp = tid >> 5;
  const int nc = S / cs, ntile = ceil_div(cs, kT), npt = ceil_div(P, kT);
  const int64_t per = BH * nc * npt;
  const int it = ntile - 1 - (int)(blockIdx.x / per);
  int64_t q = blockIdx.x % per;
  const int pt = (int)(q % npt);
  q /= npt;
  const int c = (int)(q % nc);
  const int64_t bh = q / nc, b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * cs, i0 = it * kT, p0 = pt * kT;
  auto row = [&](int s) { return (b * S + c0 + s) * H + h; };           // of [Bz, S, H]
  auto row_n = [&](int s) { return ((b * S + c0 + s) * G + g) * N; };   // of C
  auto row_p = [&](int s) { return row(s) * P; };                       // of x, y
  const float* sc = scores + ((b * G + g) * nc + c) * (int64_t)cs * cs;
  const int ncum = min(cs, i0 + kT);
  for (int t = tid; t < ncum; t += kThr) {
    ccum[t] = __ldg(cum + bh * S + c0 + t);
    cdt[t] = __ldg(dt + row(t));
  }
  // steps: the inter term's 64-n slabs (C^T and h_c's rows), then the
  // column tiles j <= i (the decayed scores and x's rows); the next step's
  // loads in flight during a step's product
  const float* hc = hin + (bh * nc + c) * (int64_t)N * P;
  const int ninter = ceil_div(N, kT), nstep = ninter + it + 1;
  Staged sa, sb;
  auto fetch = [&](int step) {
    if (step < ninter) {
      sa.fetch_t(Cm, F32, row_n, i0, cs, step * kT, N);
      sb.fetch_rows(hc, F32, [&](int n) { return (int64_t)n * P; }, step * kT, N, p0, P);
    } else {
      const int j0 = (step - ninter) * kT;
      sa.fetch_t(sc, F32, [&](int i) { return (int64_t)i * cs; }, i0, cs, j0, cs);
      sb.fetch_rows(x, dtype, row_p, j0, cs, p0, P);
    }
  };
  fetch(0);
  float acc[8][4];
  zero(acc);
  for (int step = 0; step < nstep; ++step) {
    const int j0 = (step - ninter) * kT;
    if (step < ninter) {
      sa.put_t(ta, F32, same);
      sb.put_rows(tb, F32, same);
    } else {
      if (step == ninter) {           // the inter term whole: exp(cum_i) (C_i h_c)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + row_of(ty, r);
          const float w = i < cs ? expf(ccum[i]) : 0.f;
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) acc[r][qq] *= w;
        }
      }
      sa.put_t(ta, F32, [&](int i, int j, float v) {
        // mask before the exp: cum_i - cum_j > 0 for j > i
        return j0 + j <= i0 + i && i0 + i < cs
                   ? v * cdt[j0 + j] * expf(ccum[i0 + i] - ccum[j0 + j])
                   : 0.f;
      });
      sb.put_rows(tb, dtype, same);
    }
    __syncthreads();
    if (step + 1 < nstep) fetch(step + 1);
    // on the diagonal tile the warp's rows end at 32 + 8 warp + 7: the
    // scores past them are 0
    tile_fma<kT>(ta, tb, ty, tx, acc, step == nstep - 1 ? 40 + 8 * warp : kT);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + row_of(ty, r);
    if (i >= cs) continue;
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int p = p0 + 4 * tx + qq;
      if (p < P) st(y, dtype, row_p(i) + p, acc[r][qq]);
    }
  }
}

int launch_state(int dtype, const void* x, const float* da, const float* dt, const float* Bm, float* states,
                 float* cum, int64_t Bz, int S, int H, int P, int N, int cs, int G, bool bwd,
                 cudaStream_t st) {
  auto kern = ssd_chunk_state_kernel;
  const size_t smem = state_smem(cs);
  int err = spm::allow_smem(kern, smem);
  if (err) return err;
  const int64_t blocks = Bz * H * (S / cs) * ceil_div(N, kT) * ceil_div(P, kT);
  kern<<<(unsigned)blocks, kThr, smem, st>>>(dtype, x, da, dt, Bm, states, cum, S, H, P, N,
                                              cs, G, bwd);
  return (int)cudaGetLastError();
}


}  // namespace

// Each launcher returns cudaGetLastError() after its launch (0 on success),
// or cudaErrorInvalidValue for shapes or types it does not take. Every
// tensor is contiguous: x, dy, y and dx [Bz, S, H, P] of type `dtype` (F32,
// BF16, F16); dt [Bz, S, H], A [H], B and C [Bz, S, G, N] (head h reads group
// h / (H / G)), cum [Bz, H, S], the chunk-start states h_in and their
// gradients sbar [Bz, H, S / cs, N, P], the scores and Shat [Bz, G, S / cs,
// cs, cs] and the rest float32. Workspaces of row sums [tiles, Bz, H, S].

// 1: states[b, h, c] = s_c and cum, from x, da, dt, B. bwd != 0: the
// backward's chunk terms sum_i exp(cum_i) C_i^T dy_i, from dy as x and C as
// B (dt unread, cum may be null and is then not written)
extern "C" int ssd_chunk_state_launch(int dtype, const void* x, const void* da, const void* dt,
                                      const void* Bm, void* states, void* cum, int64_t Bz,
                                      int64_t S, int64_t H, int64_t P, int64_t N, int64_t cs,
                                      int64_t G, int bwd, void* stream) {
  if (!train_shapes_ok(Bz, S, H, P, N, cs, G) || state_smem((int)cs) > spm::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype < F32 || dtype > F16) return (int)cudaErrorInvalidValue;
  return launch_state(dtype, x, f(da), f(dt), f(Bm), (float*)states, (float*)cum, Bz, (int)S,
                      (int)H, (int)P, (int)N, (int)cs, (int)G, bwd != 0, st);
}

// 2: states[b, h, c] <- h_in[c] in place; state = the final h; init the
// state [Bz, H, N, P] the scan starts from, or null for zero. rev != 0: the
// backward's form (see the kernel)
extern "C" int ssd_state_pass_launch(void* states, const void* cum, void* state, const void* init,
                                     int64_t Bz, int64_t S, int64_t H, int64_t P, int64_t N,
                                     int64_t cs, int rev, void* stream) {
  if (!train_shapes_ok(Bz, S, H, P, N, cs, 1)) return (int)cudaErrorInvalidValue;
  const int64_t total = Bz * H * N * P;
  const int64_t blocks = (total + kPassThr - 1) / kPassThr;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  ssd_state_pass_kernel<<<(unsigned)blocks, kPassThr, 0, (cudaStream_t)stream>>>(
      (float*)states, (const float*)cum, (float*)state, (const float*)init, (int)S, (int)cs,
      N * P, total, rev != 0);
  return (int)cudaGetLastError();
}

extern "C" int ssd_scores_launch(const void* Bm, const void* Cm, void* scores, int64_t Bz,
                                 int64_t S, int64_t N, int64_t cs, int64_t G, void* stream) {
  if (!train_shapes_ok(Bz, S, G, 1, N, cs, G)) return (int)cudaErrorInvalidValue;
  const size_t smem = tiles_smem(2, 0);
  int err = spm::allow_smem(ssd_scores_kernel, smem);
  if (err) return err;
  const int ntile = ceil_div((int)cs, kT);
  const int64_t blocks = Bz * G * (S / cs) * (ntile * (ntile + 1) / 2);
  ssd_scores_kernel<<<(unsigned)blocks, kThr, smem, (cudaStream_t)stream>>>(
      (const float*)Bm, (const float*)Cm, (float*)scores, (int)S, (int)N, (int)cs, (int)G);
  return (int)cudaGetLastError();
}

extern "C" int ssd_train_scan_launch(int dtype, const void* x, const void* dt, const void* Cm,
                                     const void* cum, const void* hin, const void* scores,
                                     void* y, int64_t Bz, int64_t S, int64_t H, int64_t P,
                                     int64_t N, int64_t cs, int64_t G, void* stream) {
  if (!train_shapes_ok(Bz, S, H, P, N, cs, G) || dtype < F32 || dtype > F16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tiles_smem(2, (int)cs);
  int err = spm::allow_smem(ssd_train_scan_kernel, smem);
  if (err) return err;
  const int64_t BH = Bz * H;
  const int64_t blocks = BH * (S / cs) * ceil_div((int)P, kT) * ceil_div((int)cs, kT);
  ssd_train_scan_kernel<<<(unsigned)blocks, kThr, smem, (cudaStream_t)stream>>>(
      (int)dtype, x, (const float*)dt, (const float*)Cm, (const float*)cum, (const float*)hin,
      (const float*)scores, y, (int)S, (int)H, (int)P, (int)N, (int)cs, (int)G, BH);
  return (int)cudaGetLastError();
}
