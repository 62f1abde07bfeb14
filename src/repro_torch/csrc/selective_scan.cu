// Mamba-1's selective scan for training (hymba's SSM heads), forward and
// backward. Per row b, channel c (of d) and state n (of N), from s_{-1} the
// initial state (or 0):
//   a_t = exp(dt_t A_n),  s_t = a_t s_{t-1} + dt_t u_t B_t,  y_t = sum_n s_t C_t
// and, backward, the adjoint g_t = a_{t+1} g_{t+1} + gy_t C_t from g_S the
// final state's gradient (a_S = 1), with h_t = a_t s_{t-1}:
//   gu_t = dt_t sum_n g_t B_t           gdt_t = u_t sum_n g_t B_t + sum_n g_t h_t A_n
//   gB_t = sum_c g_t dt_t u_t           gC_t  = sum_c gy_t s_t
//   gA   = sum_{b,t} g_t h_t dt_t       gs_{-1} = a_0 g_0
// All arithmetic float32; u, dt, B and C read in their own type (float32,
// bf16 or float16, chosen at run time) and the gradients written in it.
//
// These kernels replace no TPU kernel: the JAX package has no Mamba-1 scan.
// They replace the port's plain chunked doubling scan (models/ssm.py::
// _SelectiveScan), which moved float32 [B, S, d, N] expansions through some
// 35 elementwise passes a call and launched a kernel per chunk to carry the
// state (288 a forward at hymba's 8 x 1152 positions, chunk 4).
//
// What bounds them on the H100 at hymba's cell (8 x 1152 positions, d 3200,
// N 16): the exponentials. B S d N = 471.9 M a pass, 0.11-0.13 ms on the
// SFUs (132 SMs x 16 a clock); the forward takes one pass and the backward
// two (the segment's states recomputed, then a_t again in the reverse
// walk). The compulsory bytes are 177.7 MB a forward and 296.5 MB a
// backward (flops/hybrid.py's count), 53 and 89 us at 3.35 TB/s.
//
// Design: no [B, S, d, N] tensor in device memory. A channel's N states live
// in registers, NS = 4 of them in each of Q neighbouring lanes (the tiling:
// Q = 4 up to N 16, 8 up to 32; at the cell four lanes of four ran forward
// and backward in 2.44 ms, two of eight in 3.00, one of 16 in 3.64, all
// with ex2.approx), and
// each thread walks time in series: one launch, no loop over chunks on the
// host. A block is 128 threads, 128 / Q channels of one row; it stages each
// segment of K positions' u, dt (and gy) along the channels and the rows'
// B and C in shared memory, the next segment's loads in flight in registers
// during this one's arithmetic. exp(dt A) is CUDA's expf (2 ulp: one SFU
// ex2 and a few multiply-adds). ex2.approx alone on dt A log2(e) was 0.1 to
// 0.2 ms faster a call, but raised the cell's grad_gap (its gradients
// against a float32 reference, hymba's decays lying near 1 over its 1152
// positions) on each of 5 seeds, 1.1-2.1x (PERF.md §6).
//   1. selective_scan_fwd_kernel: y, the final state and, for the backward,
//      the state entering every segment of K = 64 / NS = 16 positions ([B,
//      S / K, d, N] float32: 118 MB at the cell, where the plain scan's
//      expansions were 1.89 GB each).
//   2. selective_scan_bwd_kernel: the segments from last to first; each
//      recomputes its K states from its checkpoint into registers (K NS a
//      thread), then walks them in reverse for the adjoint and every
//      gradient. gu and gdt are written whole; gB and gC are summed over a
//      warp's channels (a reduce-scatter of shuffles), then over the block's
//      warps in shared memory, into per-block partials [d / (128 / Q), B,
//      S, 2, N]; gA into per-row partials [B, d, N]; the initial state's
//      gradient whole.
//   3. selective_scan_sum_kernel: the partials summed in a fixed order into
//      gB, gC (their type) and gA (float32). No float atomics anywhere: two
//      runs give the same bits.
// Shapes refused (the launchers return cudaErrorInvalidValue, the wrapper
// raises first): N above NS Q of the largest tiling (32), a grid past 2^31
// blocks, a segment count or partial count other than the tiling's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThr = 128;                    // threads a block
constexpr int kWarps = kThr / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

__device__ __forceinline__ float ld(const void* p, int64_t i, int code) {
  if (code == BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (code == F16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, int64_t i, float v, int code) {
  if (code == BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else if (code == F16)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// NS states a lane, Q lanes a channel (neighbouring lanes), kThr / Q channels
// a block, segments of K positions (K NS floats of recomputed states a
// thread in the backward)
template <int NS, int Q>
struct Tiling {
  static constexpr int kNP = NS * Q;                    // states a channel, padded
  static constexpr int kK = 64 / NS;                    // positions a segment
  static constexpr int kDC = kThr / Q;                  // channels a block
  static constexpr int kRch = kK * kDC / kThr;          // a channel array's loads a thread
  static constexpr int kRbc = (kK * kNP + kThr - 1) / kThr;  // B's (or C's)
  static constexpr int kRounds = Q == 1 ? 5 : Q == 2 ? 4 : Q == 4 ? 3 : Q == 8 ? 2 : 1;
  static constexpr int kLeft = (2 * NS) >> kRounds > 0 ? (2 * NS) >> kRounds : 1;
};

// v[0..V) summed over the lanes that differ in the bits O, O / 2, .., Q
// (the warp's channels), scattered: after it this lane holds the sums of
// entries base .. base + V / 2^rounds (at least one; lanes past that hold
// copies)
template <int V, int O, int Q>
__device__ __forceinline__ void reduce_scatter(float* v, int lane, int& base) {
  if constexpr (O >= Q && O > 0) {
    if constexpr (V > 1) {
      constexpr int H = V / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      if (up) base += H;
      reduce_scatter<H, O / 2, Q>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      reduce_scatter<1, O / 2, Q>(v, lane, base);
    }
  }
}

template <int Q>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 1; o < Q; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The inputs of the block's (b, c0) over one segment: RA channel arrays
// [K][DC] and B, C [K][NP], loaded into registers (fetch) then stored into
// a shared buffer (commit), zero past S, d and N
template <int NS, int Q, int RA>
struct Stage {
  using T = Tiling<NS, Q>;
  float ch[RA][T::kRch];
  float bc[2][T::kRbc];

  __device__ __forceinline__ void fetch(const void* const* arr, const int* codes,
                                        const void* Bm, int b_code, const void* Cm,
                                        int c_code, int64_t b, int c0, int t0, int S,
                                        int d, int N) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int r = 0; r < T::kRch; ++r) {
      const int e = tid + r * kThr, i = e / T::kDC, c = e % T::kDC, t = t0 + i;
      const bool ok = t < S && c0 + c < d;
      const int64_t at = (b * S + t) * (int64_t)d + c0 + c;
#pragma unroll
      for (int a = 0; a < RA; ++a)
        ch[a][r] = ok && arr[a] != nullptr ? ld(arr[a], at, codes[a]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < T::kRbc; ++r) {
      const int e = tid + r * kThr, i = e / T::kNP, n = e % T::kNP, t = t0 + i;
      const bool ok = e < T::kK * T::kNP && t < S && n < N;
      const int64_t at = (b * S + t) * (int64_t)N + n;
      bc[0][r] = ok ? ld(Bm, at, b_code) : 0.f;
      bc[1][r] = ok ? ld(Cm, at, c_code) : 0.f;
    }
  }

  __device__ __forceinline__ void commit(float (*sch)[T::kK][T::kDC],
                                         float (*sbc)[T::kK][T::kNP]) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int r = 0; r < T::kRch; ++r) {
      const int e = tid + r * kThr;
#pragma unroll
      for (int a = 0; a < RA; ++a) sch[a][e / T::kDC][e % T::kDC] = ch[a][r];
    }
#pragma unroll
    for (int r = 0; r < T::kRbc; ++r) {
      const int e = tid + r * kThr;
      if (e < T::kK * T::kNP) {
        sbc[0][e / T::kNP][e % T::kNP] = bc[0][r];
        sbc[1][e / T::kNP][e % T::kNP] = bc[1][r];
      }
    }
  }
};

// NS values of a shared row from n0 (a multiple of NS)
template <int NS>
__device__ __forceinline__ void row(const float* p, float (&v)[NS]) {
  if constexpr (NS % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NS; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) v[j] = p[j];
  }
}

// ---- 1. forward -------------------------------------------------------------

// 8 blocks an SM (64 registers a thread): hymba's 3200 warps fit the card at
// once (at 80 registers, 6 blocks an SM, the last 8 of its 800 blocks ran
// alone, 0.74 ms against 0.46)
template <int NS, int Q>
__global__ void __launch_bounds__(kThr, 8)
selective_scan_fwd_kernel(const void* __restrict__ u, int u_code, const void* __restrict__ dt,
                          int dt_code, const float* __restrict__ A, const void* __restrict__ Bm,
                          int b_code, const void* __restrict__ Cm, int c_code,
                          const void* __restrict__ s0, int s0_code, float* __restrict__ y,
                          float* __restrict__ last, float* __restrict__ ck, int S, int d, int N) {
  using T = Tiling<NS, Q>;
  constexpr int K = T::kK, DC = T::kDC, NP = T::kNP;
  __shared__ __align__(16) float s_ch[2][2][K][DC];   // [buffer][u, dt][i][channel]
  __shared__ __align__(16) float s_bc[2][2][K][NP];   // [buffer][B, C][i][n]
  __shared__ float s_y[K][DC];
  const int tid = threadIdx.x, cl = tid / Q, q = tid % Q, n0 = q * NS;
  const int nblk = (int)ceil_div(d, DC);
  const int64_t b = blockIdx.x / nblk;
  const int c0 = (int)(blockIdx.x % nblk) * DC, ch = c0 + cl;
  const bool live = ch < d;
  const int nseg = (int)ceil_div(S, K);
  const int64_t sd = (b * d + ch) * (int64_t)N;       // this channel's states

  float aw[NS], s[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const bool on = live && n0 + j < N;
    aw[j] = on ? A[(int64_t)ch * N + n0 + j] : 0.f;
    s[j] = on && s0 != nullptr ? ld(s0, sd + n0 + j, s0_code) : 0.f;
  }
  const void* arr[2] = {u, dt};
  const int codes[2] = {u_code, dt_code};
  Stage<NS, Q, 2> stage;
  stage.fetch(arr, codes, Bm, b_code, Cm, c_code, b, c0, 0, S, d, N);
  stage.commit(s_ch[0], s_bc[0]);
  __syncthreads();
  for (int k = 0; k < nseg; ++k) {
    const int buf = k & 1, t0 = k * K, len = min(K, S - t0);
    if (k + 1 < nseg) stage.fetch(arr, codes, Bm, b_code, Cm, c_code, b, c0, t0 + K, S, d, N);
    if (ck != nullptr && live) {
      float* out = ck + ((b * nseg + k) * d + ch) * (int64_t)N + n0;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        if (n0 + j < N) out[j] = s[j];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i < len) {
        const float dti = s_ch[buf][1][i][cl], dtu = dti * s_ch[buf][0][i][cl];
        float bv[NS], cv[NS];
        row<NS>(&s_bc[buf][0][i][n0], bv);
        row<NS>(&s_bc[buf][1][i][n0], cv);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          s[j] = fmaf(s[j], expf(dti * aw[j]), dtu * bv[j]);
          acc = fmaf(s[j], cv[j], acc);
        }
        acc = lane_sum<Q>(acc);
        if (q == 0) s_y[i][cl] = acc;
      }
    }
    __syncthreads();
    for (int e = tid; e < len * DC; e += kThr) {
      const int i = e / DC, c = e % DC;
      if (c0 + c < d) y[(b * S + t0 + i) * (int64_t)d + c0 + c] = s_y[i][c];
    }
    if (k + 1 < nseg) stage.commit(s_ch[buf ^ 1], s_bc[buf ^ 1]);
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if (n0 + j < N) last[sd + n0 + j] = s[j];
  }
}

// ---- 2. backward ------------------------------------------------------------

template <int NS, int Q>
__global__ void __launch_bounds__(kThr)
selective_scan_bwd_kernel(const void* __restrict__ u, int u_code, const void* __restrict__ dt,
                          int dt_code, const float* __restrict__ A, const void* __restrict__ Bm,
                          int b_code, const void* __restrict__ Cm, int c_code,
                          const float* __restrict__ gy, const float* __restrict__ glast,
                          const float* __restrict__ ck, void* __restrict__ gu,
                          void* __restrict__ gdt, float* __restrict__ pbc,
                          float* __restrict__ pA, float* __restrict__ gs0, int Bz, int S,
                          int d, int N) {
  using T = Tiling<NS, Q>;
  constexpr int K = T::kK, DC = T::kDC, NP = T::kNP;
  __shared__ __align__(16) float s_ch[2][3][K][DC];   // [buffer][u, dt, gy][i][channel]
  __shared__ __align__(16) float s_bc[2][2][K][NP];   // [buffer][B, C][i][n]
  __shared__ float s_out[2][K][DC];                   // gu, gdt
  __shared__ float s_red[kWarps][K][2 * NP];          // a warp's gB, gC sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / Q, q = tid % Q, n0 = q * NS;
  const int nblk = (int)ceil_div(d, DC);
  const int64_t b = blockIdx.x / nblk;
  const int cb = (int)(blockIdx.x % nblk), c0 = cb * DC, ch = c0 + cl;
  const bool live = ch < d;
  const int nseg = (int)ceil_div(S, K);
  const int64_t sd = (b * d + ch) * (int64_t)N;

  float aw[NS], g[NS], anext[NS], gA[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const bool on = live && n0 + j < N;
    aw[j] = on ? A[(int64_t)ch * N + n0 + j] : 0.f;
    g[j] = on && glast != nullptr ? glast[sd + n0 + j] : 0.f;
    anext[j] = 1.f;
    gA[j] = 0.f;
  }
  const void* arr[3] = {u, dt, gy};
  const int codes[3] = {u_code, dt_code, F32};
  Stage<NS, Q, 3> stage;
  stage.fetch(arr, codes, Bm, b_code, Cm, c_code, b, c0, (nseg - 1) * K, S, d, N);
  stage.commit(s_ch[0], s_bc[0]);
  __syncthreads();
  for (int k = nseg - 1, it = 0; k >= 0; --k, ++it) {
    const int buf = it & 1, t0 = k * K, len = min(K, S - t0);
    if (k > 0) stage.fetch(arr, codes, Bm, b_code, Cm, c_code, b, c0, t0 - K, S, d, N);
    float sck[NS], sr[K][NS];
    {
      const float* in = ck + ((b * nseg + k) * d + ch) * (int64_t)N + n0;
#pragma unroll
      for (int j = 0; j < NS; ++j) sck[j] = live && n0 + j < N ? in[j] : 0.f;
    }
    // the segment's states again, from its checkpoint
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i < len) {
        const float dti = s_ch[buf][1][i][cl], dtu = dti * s_ch[buf][0][i][cl];
        float bv[NS];
        row<NS>(&s_bc[buf][0][i][n0], bv);
#pragma unroll
        for (int j = 0; j < NS; ++j)
          sr[i][j] = fmaf(i > 0 ? sr[i - 1][j] : sck[j], expf(dti * aw[j]), dtu * bv[j]);
      }
    }
    // the adjoint, in reverse
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      if (i < len) {
        const float ui = s_ch[buf][0][i][cl], dti = s_ch[buf][1][i][cl];
        const float gyi = s_ch[buf][2][i][cl], dtu = dti * ui;
        float bv[NS], cv[NS], v[2 * NS];
        row<NS>(&s_bc[buf][0][i][n0], bv);
        row<NS>(&s_bc[buf][1][i][n0], cv);
        float gb = 0.f, gh = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          g[j] = fmaf(g[j], anext[j], gyi * cv[j]);
          const float a = expf(dti * aw[j]);
          const float w = g[j] * (a * (i > 0 ? sr[i - 1][j] : sck[j]));   // g h
          gb = fmaf(g[j], bv[j], gb);
          gh = fmaf(w, aw[j], gh);
          gA[j] = fmaf(w, dti, gA[j]);
          v[j] = g[j] * dtu;
          v[NS + j] = gyi * sr[i][j];
          anext[j] = a;
        }
        gb = lane_sum<Q>(gb);
        gh = lane_sum<Q>(gh);
        if (q == 0) {
          s_out[0][i][cl] = gb * dti;
          s_out[1][i][cl] = fmaf(gb, ui, gh);
        }
        int base = 0;
        reduce_scatter<2 * NS, 16, Q>(v, lane, base);
#pragma unroll
        for (int r = 0; r < T::kLeft; ++r) {
          const int e = base + r, which = e / NS;
          s_red[warp][i][which * NP + n0 + e % NS] = v[r];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < len * DC; e += kThr) {
      const int i = e / DC, c = e % DC;
      if (c0 + c < d) {
        const int64_t at = (b * S + t0 + i) * (int64_t)d + c0 + c;
        st(gu, at, s_out[0][i][c], u_code);
        st(gdt, at, s_out[1][i][c], dt_code);
      }
    }
    float* part = pbc + (((int64_t)cb * Bz + b) * S + t0) * 2 * N;
    for (int e = tid; e < len * 2 * N; e += kThr) {
      const int i = e / (2 * N), r = e % (2 * N), slot = (r / N) * NP + r % N;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_red[w][i][slot];
      part[e] = sum;
    }
    if (k > 0) stage.commit(s_ch[buf ^ 1], s_bc[buf ^ 1]);
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (n0 + j < N) {
        pA[sd + n0 + j] = gA[j];
        if (gs0 != nullptr) gs0[sd + n0 + j] = anext[j] * g[j];
      }
    }
  }
}

// ---- 3. the partials' sums --------------------------------------------------

__global__ void __launch_bounds__(256)
selective_scan_sum_kernel(const float* __restrict__ pbc, const float* __restrict__ pA,
                          void* __restrict__ gB, int b_code, void* __restrict__ gC, int c_code,
                          float* __restrict__ gA, int64_t rows, int64_t nA, int N, int ncb,
                          int Bz) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nbc = rows * 2 * N;   // entries [B S][2][N] of one partial
  if (e < nbc) {
    float sum = 0.f;
    for (int c = 0; c < ncb; ++c) sum += pbc[c * nbc + e];
    const int64_t r = e / (2 * N);
    const int which = (int)(e % (2 * N)) / N, n = (int)(e % N);
    if (which == 0)
      st(gB, r * N + n, sum, b_code);
    else
      st(gC, r * N + n, sum, c_code);
  } else if (e - nbc < nA) {
    const int64_t i = e - nbc;
    float sum = 0.f;
    for (int b = 0; b < Bz; ++b) sum += pA[b * nA + i];
    gA[i] = sum;
  }
}

// the tilings by code, as kernels/selective_scan.py::TILINGS: (NS, Q)
template <template <int, int> class F, typename... Args>
int by_tiling(int tiling, Args... args) {
  switch (tiling) {
    case 0: return F<4, 4>::run(args...);
    case 1: return F<4, 8>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool codes_ok(int a, int b = F32, int c = F32, int d = F32, int e = F32) {
  for (int x : {a, b, c, d, e})
    if (x < F32 || x > F16) return false;
  return true;
}

// the grid of a scan kernel: a block per (row, 128 / Q channels); refuses
// N past the tiling's, the segment count and partial count the caller
// sized its buffers for, and grids past 2^31 blocks
template <int NS, int Q>
bool grid_ok(int64_t Bz, int64_t S, int64_t d, int64_t N, int64_t nseg, int64_t ncb,
             unsigned* blocks) {
  using T = Tiling<NS, Q>;
  if (Bz < 1 || S < 1 || d < 1 || N < 1 || N > T::kNP || S > INT32_MAX || d > INT32_MAX)
    return false;
  if (nseg != ceil_div(S, T::kK) || ncb != ceil_div(d, T::kDC)) return false;
  const int64_t n = Bz * ncb;
  if (n > INT32_MAX) return false;
  *blocks = (unsigned)n;
  return true;
}

template <int NS, int Q>
struct Fwd {
  static int run(const void* u, int u_code, const void* dt, int dt_code, const void* A,
                 const void* Bm, int b_code, const void* Cm, int c_code, const void* s0,
                 int s0_code, void* y, void* last, void* ck, int64_t Bz, int64_t S, int64_t d,
                 int64_t N, int64_t nseg, int64_t ncb, cudaStream_t st) {
    unsigned blocks;
    if (!grid_ok<NS, Q>(Bz, S, d, N, nseg, ncb, &blocks)) return (int)cudaErrorInvalidValue;
    selective_scan_fwd_kernel<NS, Q><<<blocks, kThr, 0, st>>>(
        u, u_code, dt, dt_code, (const float*)A, Bm, b_code, Cm, c_code, s0, s0_code,
        (float*)y, (float*)last, (float*)ck, (int)S, (int)d, (int)N);
    return (int)cudaGetLastError();
  }
};

template <int NS, int Q>
struct Bwd {
  static int run(const void* u, int u_code, const void* dt, int dt_code, const void* A,
                 const void* Bm, int b_code, const void* Cm, int c_code, const void* gy,
                 const void* glast, const void* ck, void* gu, void* gdt, void* pbc, void* pA,
                 void* gs0, int64_t Bz, int64_t S, int64_t d, int64_t N, int64_t nseg,
                 int64_t ncb, cudaStream_t st) {
    unsigned blocks;
    if (!grid_ok<NS, Q>(Bz, S, d, N, nseg, ncb, &blocks)) return (int)cudaErrorInvalidValue;
    selective_scan_bwd_kernel<NS, Q><<<blocks, kThr, 0, st>>>(
        u, u_code, dt, dt_code, (const float*)A, Bm, b_code, Cm, c_code, (const float*)gy,
        (const float*)glast, (const float*)ck, gu, gdt, (float*)pbc, (float*)pA, (float*)gs0,
        (int)Bz, (int)S, (int)d, (int)N);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// y [Bz, S, d] and last [Bz, d, N] float32; ck [Bz, nseg, d, N] float32 or
// null (no backward to come); s0 [Bz, d, N] or null for zero
extern "C" int selective_scan_fwd_launch(int tiling, const void* u, int u_code, const void* dt,
                                         int dt_code, const void* A, const void* Bm, int b_code,
                                         const void* Cm, int c_code, const void* s0,
                                         int s0_code, void* y, void* last, void* ck, int64_t Bz,
                                         int64_t S, int64_t d, int64_t N, int64_t nseg,
                                         int64_t ncb, void* stream) {
  if (!codes_ok(u_code, dt_code, b_code, c_code, s0_code)) return (int)cudaErrorInvalidValue;
  return by_tiling<Fwd>(tiling, u, u_code, dt, dt_code, A, Bm, b_code, Cm, c_code, s0, s0_code,
                        y, last, ck, Bz, S, d, N, nseg, ncb, (cudaStream_t)stream);
}

// gy [Bz, S, d] and glast [Bz, d, N] float32, each or null for zero; gu and
// gdt in u's and dt's types; pbc [ncb, Bz, S, 2, N] and pA [Bz, d, N]
// float32 partials for selective_scan_sum_launch; gs0 [Bz, d, N] float32 or
// null
extern "C" int selective_scan_bwd_launch(int tiling, const void* u, int u_code, const void* dt,
                                         int dt_code, const void* A, const void* Bm, int b_code,
                                         const void* Cm, int c_code, const void* gy,
                                         const void* glast, const void* ck, void* gu, void* gdt,
                                         void* pbc, void* pA, void* gs0, int64_t Bz, int64_t S,
                                         int64_t d, int64_t N, int64_t nseg, int64_t ncb,
                                         void* stream) {
  if (!codes_ok(u_code, dt_code, b_code, c_code) || ck == nullptr)
    return (int)cudaErrorInvalidValue;
  return by_tiling<Bwd>(tiling, u, u_code, dt, dt_code, A, Bm, b_code, Cm, c_code, gy, glast,
                        ck, gu, gdt, pbc, pA, gs0, Bz, S, d, N, nseg, ncb,
                        (cudaStream_t)stream);
}

// gB, gC [Bz, S, N] in their types from pbc (summed over its ncb partials,
// in order), gA [d, N] float32 from pA (over the Bz rows, in order)
extern "C" int selective_scan_sum_launch(const void* pbc, const void* pA, void* gB, int b_code,
                                         void* gC, int c_code, void* gA, int64_t Bz, int64_t S,
                                         int64_t d, int64_t N, int64_t ncb, void* stream) {
  if (!codes_ok(b_code, c_code) || Bz < 1 || S < 1 || d < 1 || N < 1 || ncb < 1 ||
      ncb > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t total = Bz * S * 2 * N + d * N;
  const int64_t blocks = ceil_div(total, 256);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  selective_scan_sum_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)pbc, (const float*)pA, gB, b_code, gC, c_code, (float*)gA, Bz * S, d * N,
      (int)N, (int)ncb, (int)Bz);
  return (int)cudaGetLastError();
}
