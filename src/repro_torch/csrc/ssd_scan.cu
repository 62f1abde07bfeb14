// The Mamba-2 SSD chunk scan. Per (batch b, head h) a state h [N, P]
// (float32, zero at the start) walks the sequence in chunks of cs steps;
// within a chunk, with cum the running sum of da over the chunk,
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xdt_j        (intra)
//       + exp(cum_i) (C_i h)                                       (inter)
//   h  <- exp(cum_last) h + sum_j (B_j exp(cum_last - cum_j))^T xdt_j
// where xdt_j = x_j dt_j. x [Bz, S, H, P] (float32 or bf16), da and dt
// [Bz, S, H], B and C [Bz, S, H, N] head-broadcast (float32); y in x's
// type, the final state [Bz, H, N, P] float32. All arithmetic float32.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel (a
// (Bz, H, S/cs) grid whose innermost, sequential chunk axis carries the
// [N, P] state in VMEM scratch; four MXU products per chunk).
//
// What bounds it on an H100: operations. At the mamba2-1.3b row (Bz 2,
// S 4096, H 64, P 64, N 128, cs 256) the four products need 43 G float32
// operations (the j <= i half of the two cs x cs products), 0.64 ms at
// the FP32 rate, against 0.81 GB of bytes (0.24 ms), most of it the
// head-broadcast B and C.
//
// Design: the simple, right first version, on the CUDA cores. One block
// of 256 threads per (b, h) walks the chunks in order, as the TPU grid
// does; the state, the chunk's xdt and its cum stay in shared memory
// (180 KB at the mamba2 row). The chunk's cs x cs matrix (256 KB at
// cs 256) and its B and C (128 KB each) do not fit a block, so the rows
// are tiled: for each 64-row tile of C, the 64-row tiles of B at or
// below it give 64 x 64 scores (each thread a 4 x 4 register block;
// B rows padded to an odd stride so a warp's 16 rows fall in 16 banks),
// masked to j <= i BEFORE the exp (exp(cum_i - cum_j) overflows for
// j > i), then multiplied into a 64 x 64 register tile of y. The state
// update tiles [N, P] the same way. Only Bz * H blocks run (128 at the
// mamba2 row, under one wave of 132 SMs): a chunk-parallel design (chunk
// states first, then a short scan) is the redesign's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int T = 64;                     // tile edge (rows of C, B; columns)
constexpr size_t kMaxSmem = 232448;       // 227 KB, a block's opt-in limit

enum Dtype { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ inline int n_stride(int N) { return N | 1; }   // odd

size_t smem_bytes(int N, int P, int cs) {
  return sizeof(float) * ((size_t)N * P + (size_t)cs * P + 2 * (size_t)cs +
                          2 * (size_t)T * n_stride(N) + (size_t)T * (T + 1));
}

template <typename Tx>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Tx* __restrict__ x, const float* __restrict__ da,
                const float* __restrict__ dt, const float* __restrict__ Bm,
                const float* __restrict__ Cm, Tx* __restrict__ y, float* __restrict__ state,
                int S, int H, int P, int N, int cs) {
  extern __shared__ __align__(16) float smem[];
  const int ldn = n_stride(N);
  float* hs = smem;                       // [N][P] the carried state
  float* xdt = hs + N * P;                // [cs][P]
  float* cum = xdt + cs * P;              // [cs]
  float* dts = cum + cs;                  // [cs]
  float* cts = dts + cs;                  // [T][ldn] a row tile of C
  float* bts = cts + T * ldn;             // [T][ldn] a row tile of B
  float* sts = bts + T * ldn;             // [T][T + 1] masked scores
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H, h = bh % H;
  const int ntile = (cs + T - 1) / T;

  // row s of a [Bz, S, H, W] tensor at this (b, h)
  auto row = [&](int64_t s, int W) { return ((b * S + s) * H + h) * W; };

  // a T-row tile of B or C (rows r0.. of the chunk at c0), zero past cs
  auto load_tile = [&](float* dst, const float* src, int c0, int r0) {
    for (int e = tid; e < T * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      dst[r * ldn + n] = r0 + r < cs ? src[row(c0 + r0 + r, N) + n] : 0.f;
    }
  };

  for (int e = tid; e < N * P; e += kThreads) hs[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += cs) {
    __syncthreads();                      // the previous chunk is done
    for (int j = tid; j < cs; j += kThreads) {
      cum[j] = da[row(c0 + j, 1)];
      dts[j] = dt[row(c0 + j, 1)];
    }
    __syncthreads();
    if (warp == 0) {                      // cum = cumsum(da): one warp's scan
      float carry = 0.f;
      for (int base = 0; base < cs; base += 32) {
        float v = base + lane < cs ? cum[base + lane] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        if (base + lane < cs) cum[base + lane] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    for (int e = tid; e < cs * P; e += kThreads) {
      const int j = e / P, p = e - j * P;
      xdt[e] = widen(x[row(c0 + j, P) + p]) * dts[j];
    }
    __syncthreads();

    // ---- y: intra-chunk and inter-chunk terms, one 64 x 64 tile at a time
    for (int p0 = 0; p0 < P; p0 += T) {
      for (int it = 0; it < ntile; ++it) {
        const int i0 = it * T;
        __syncthreads();
        load_tile(cts, Cm, c0, i0);
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
        for (int jt = 0; jt <= it; ++jt) {
          const int j0 = jt * T;
          __syncthreads();
          load_tile(bts, Bm, c0, j0);
          __syncthreads();
          float g[4][4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) g[a][q] = 0.f;
          for (int n = 0; n < N; ++n) {
            float ca[4], bq[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) ca[a] = cts[(ty + 16 * a) * ldn + n];
#pragma unroll
            for (int q = 0; q < 4; ++q) bq[q] = bts[(tx + 16 * q) * ldn + n];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int q = 0; q < 4; ++q) g[a][q] = fmaf(ca[a], bq[q], g[a][q]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = i0 + ty + 16 * a;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int j = j0 + tx + 16 * q;
              // mask before the exp: cum_i - cum_j > 0 for j > i
              sts[(ty + 16 * a) * (T + 1) + tx + 16 * q] =
                  (j <= i && i < cs) ? g[a][q] * expf(cum[i] - cum[j]) : 0.f;
            }
          }
          __syncthreads();
          const int nj = min(T, cs - j0);
          for (int jj = 0; jj < nj; ++jj) {
            float sa[4], xq[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) sa[a] = sts[(ty + 16 * a) * (T + 1) + jj];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int p = p0 + tx + 16 * q;
              xq[q] = p < P ? xdt[(j0 + jj) * P + p] : 0.f;
            }
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(sa[a], xq[q], acc[a][q]);
          }
        }
        // inter: y += exp(cum_i) * (C_i h), h the state before this chunk
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          for (int n = 0; n < N; ++n) {
            const float cv = cts[(ty + 16 * a) * ldn + n];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int p = p0 + tx + 16 * q;
              t[q] = fmaf(cv, p < P ? hs[n * P + p] : 0.f, t[q]);
            }
          }
          if (i >= cs) continue;
          const float din = expf(cum[i]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = p0 + tx + 16 * q;
            if (p < P) store(y + row(c0 + i, P) + p, acc[a][q] + din * t[q]);
          }
        }
      }
    }

    // ---- state: h <- exp(cum_last) h + sum_j (B_j exp(cum_last - cum_j))^T xdt_j
    const float last = cum[cs - 1];
    const float dlast = expf(last);
    for (int n0 = 0; n0 < N; n0 += T) {
      for (int p0 = 0; p0 < P; p0 += T) {
        float u[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) u[a][q] = 0.f;
        for (int jt = 0; jt < ntile; ++jt) {
          const int j0 = jt * T;
          __syncthreads();                // y's readers of hs, bts are done
          for (int e = tid; e < T * N; e += kThreads) {
            const int r = e / N, n = e - r * N;
            const int j = j0 + r;
            bts[r * ldn + n] = j < cs ? Bm[row(c0 + j, N) + n] * expf(last - cum[j]) : 0.f;
          }
          __syncthreads();
          const int nj = min(T, cs - j0);
          for (int jj = 0; jj < nj; ++jj) {
            float bn[4], xq[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const int n = n0 + ty + 16 * a;
              bn[a] = n < N ? bts[jj * ldn + n] : 0.f;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int p = p0 + tx + 16 * q;
              xq[q] = p < P ? xdt[(j0 + jj) * P + p] : 0.f;
            }
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int q = 0; q < 4; ++q) u[a][q] = fmaf(bn[a], xq[q], u[a][q]);
          }
        }
        // each thread owns its (n, p): nobody else reads them in this phase
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int n = n0 + ty + 16 * a;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = p0 + tx + 16 * q;
            if (n < N && p < P) hs[n * P + p] = dlast * hs[n * P + p] + u[a][q];
          }
        }
      }
    }
  }
  __syncthreads();
  float* sg = state + bh * N * P;
  for (int e = tid; e < N * P; e += kThreads) sg[e] = hs[e];
}

template <typename Tx>
int launch(const void* x, const float* da, const float* dt, const float* Bm, const float* Cm,
           void* y, float* state, int64_t BH, int S, int H, int P, int N, int cs,
           cudaStream_t stream) {
  auto kern = ssd_scan_kernel<Tx>;
  const size_t smem = smem_bytes(N, P, cs);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)BH, kThreads, smem, stream>>>((const Tx*)x, da, dt, Bm, Cm, (Tx*)y, state,
                                                 S, H, P, N, cs);
  return (int)cudaGetLastError();
}

}  // namespace

// (y, state) = ssd_scan(x, da, dt, B, C) for x dtype code F32 or BF16;
// the other inputs float32; all contiguous. S must be a multiple of cs.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* da, const void* dt,
                               const void* Bm, const void* Cm, void* y, void* state,
                               int64_t Bz, int64_t S, int64_t H, int64_t P, int64_t N,
                               int64_t cs, void* stream) {
  if (Bz <= 0 || H <= 0 || P <= 0 || N <= 0) return 0;
  if (S <= 0 || cs <= 0 || S % cs != 0 || Bz * H > INT32_MAX || S > INT32_MAX ||
      smem_bytes((int)N, (int)P, (int)cs) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *pda = (const float*)da, *pdt = (const float*)dt;
  const float *pb = (const float*)Bm, *pc = (const float*)Cm;
  if (dtype == F32)
    return launch<float>(x, pda, pdt, pb, pc, y, (float*)state, Bz * H, (int)S, (int)H,
                         (int)P, (int)N, (int)cs, s);
  if (dtype == BF16)
    return launch<__nv_bfloat16>(x, pda, pdt, pb, pc, y, (float*)state, Bz * H, (int)S,
                                 (int)H, (int)P, (int)N, (int)cs, s);
  return (int)cudaErrorInvalidValue;
}
