// Flash attention with an online softmax: o = softmax(q k^T / sqrt(hd)) v
// per query head, over the keys each query row sees (causal and / or
// sliding-window masks, q_offset), with grouped-query heads (H = KV * G).
// q [B, H, Sq, hd], k and v [B, KV, Skv, hd], o [B, H, Sq, hd]; float32
// or bf16. m, l and acc are float32 and the inputs are widened to float32
// before both products; o = acc / max(l, 1e-30), rounded to the input's
// type (bf16 to nearest even), so a query row that sees no key gives 0.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (a (B*H, Sq/bq, Skv/bk) grid whose innermost, sequential KV axis
// carries m, l and acc in VMEM scratch; KV head bh // G).
//
// What bounds it on an H100: operations. At the llama3.2-1b row (B 2,
// H 32, S 4096, hd 64, causal) the visible pairs need 137 G operations on
// 84 MB: 0.139 ms at the bf16 tensor-core rate against 0.025 ms of bytes.
//
// Design: the simple, right first version, on the CUDA cores. One block
// of 256 threads per (b*h, 64-row query tile), the heaviest causal tiles
// launched first; a loop inside the block over 64-key tiles takes the
// place of the TPU's sequential KV grid axis, and tiles no row of the
// block can see are never loaded (the saving the reference's docstring
// names). Shared memory holds the query tile, one K tile (rows padded to
// an odd stride, so a warp's 16 key rows fall in 16 banks), one V tile
// and the 64 x 64 probabilities: 114 KB at hd = 128, opted in past
// 48 KB. Each thread keeps a 4 x 4 block of scores and a 4 x ceil(hd/16)
// block of acc in registers (rows ty + 16 a, so the row's m, l and the
// correction stay in the thread; a row's max and sum are reduced over
// its 16 lanes with shuffles). A fully masked tile keeps m at the finite
// -1e30 start: corr = exp(0) = 1 and p = 0, so nothing becomes NaN.
// wgmma, TMA and a pipelined ring of tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;

enum Dtype { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ inline int k_stride(int hd) { return hd | 1; }   // odd

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)BQ * hd + (size_t)BK * k_stride(hd) + (size_t)BK * hd +
                          (size_t)BQ * (BK + 1));
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NJ = ceil(hd / 16): the acc columns of one thread (tx + 16 j)
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int n_qtiles, int G, int Sq,
                       int Skv, int hd, int causal, int window, int64_t q_offset, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = k_stride(hd);
  float* qs = smem;                       // [BQ][hd]
  float* ks = qs + BQ * hd;               // [BK][ldk]
  float* vs = ks + BK * ldk;              // [BK][hd]
  float* ps = vs + BK * hd;               // [BQ][BK + 1]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t bh = blockIdx.x / n_qtiles;
  const int q0 = (n_qtiles - 1 - (int)(blockIdx.x % n_qtiles)) * BQ;   // heavy first
  const int64_t kvh = bh / G;
  const T* qg = q + (bh * Sq + q0) * hd;
  const T* kg = k + kvh * Skv * hd;
  const T* vg = v + kvh * Skv * hd;
  T* og = o + (bh * Sq + q0) * hd;

  for (int e = tid; e < BQ * hd; e += kThreads) {
    const int r = e / hd;
    qs[e] = q0 + r < Sq ? widen(qg[e]) : 0.f;
  }

  // keys [klo, khi) are the only ones a row of this tile may see
  const int64_t qmin = q_offset + q0;
  const int64_t qmax = q_offset + min(q0 + BQ, Sq) - 1;
  int64_t klo = 0, khi = Skv;
  if (window > 0) klo = max((int64_t)0, qmin - window + 1);
  if (causal) khi = min((int64_t)Skv, qmax + 1);
  const int t_lo = (int)(klo / BK);
  const int t_hi = khi > klo ? (int)((khi + BK - 1) / BK) : t_lo;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();                      // the previous tile's readers are done
    for (int e = tid; e < BK * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd;
      const bool in = k0 + r < Skv;
      const int64_t g = (int64_t)(k0 + r) * hd + d;
      ks[r * ldk + d] = in ? widen(kg[g]) : 0.f;
      vs[e] = in ? widen(vg[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * hd + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = ks[(tx + 16 * b) * ldk + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const int64_t qpos = q_offset + q0 + r;
      bool vis[4];
      float mc = kNegInf;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int64_t key = k0 + tx + 16 * b;
        vis[b] = key < Skv && (!causal || qpos >= key) && (window <= 0 || qpos - key < window);
        s[a][b] = vis[b] ? s[a][b] * scale : kNegInf;
        mc = fmaxf(mc, s[a][b]);
      }
      const float m_new = fmaxf(m[a], row_max16(mc));
      const float corr = expf(m[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = vis[b] ? expf(s[a][b] - m_new) : 0.f;
        ps[r * (BK + 1) + tx + 16 * b] = p;
        psum += p;
      }
      l[a] = l[a] * corr + row_sum16(psum);
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[a][j] *= corr;
    }
    __syncthreads();

    const int nk = min(BK, Skv - k0);
    for (int c = 0; c < nk; ++c) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(ty + 16 * a) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < hd ? vs[c * hd + col] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][j] = fmaf(pa[a], vv, acc[a][j]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= Sq) continue;
    const float den = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) store(og + (int64_t)r * hd + col, acc[a][j] / den);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int64_t BH, int G, int Sq,
           int Skv, int hd, int causal, int window, int64_t q_offset, float scale,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, NJ>;
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (Sq + BQ - 1) / BQ;
  const int64_t blocks = BH * n_qtiles;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                     (T*)o, n_qtiles, G, Sq, Skv, hd, causal,
                                                     window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int64_t BH, int G, int Sq,
             int Skv, int hd, int causal, int window, int64_t q_offset, float scale,
             cudaStream_t s) {
  switch ((hd + 15) / 16) {
#define CASE(nj) \
  case nj:       \
    return launch<T, nj>(q, k, v, o, BH, G, Sq, Skv, hd, causal, window, q_offset, scale, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// o = attention(q, k, v) for dtype code F32 or BF16; q [B, H, Sq, hd],
// k / v [B, KV, Skv, hd], o [B, H, Sq, hd], all contiguous; window 0 is
// no window. Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for shapes it does not take (hd outside
// 1..128, H not a multiple of KV, sizes past int32).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* o, int64_t B, int64_t H, int64_t KV, int64_t Sq,
                                      int64_t Skv, int64_t hd, int causal, int64_t window,
                                      int64_t q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Skv <= 0 || hd < 1 || hd > kMaxHd || window < 0 ||
      window > INT32_MAX || Sq * hd > INT32_MAX || Skv * hd > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int G = (int)(H / KV);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32)
    return dispatch<float>(q, k, v, o, B * H, G, (int)Sq, (int)Skv, (int)hd, causal,
                           (int)window, q_offset, scale, s);
  if (dtype == BF16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B * H, G, (int)Sq, (int)Skv, (int)hd, causal,
                                   (int)window, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
