// Flash attention with an online softmax: o = softmax(q k^T / sqrt(hd)) v
// per query head, over the keys each query row sees (causal and / or
// sliding-window masks, q_offset), with grouped-query heads (H = KV * G).
// q [B, H, Sq, hd], k and v [B, KV, Skv, hd], o [B, H, Sq, hd]. m, l and
// acc are float32; o = acc / max(l, 1e-30), rounded to the input's type
// (bf16 to nearest even), so a query row that sees no key gives 0. Two
// kernels, picked by the operand type:
// - bf16 runs on the tensor cores (flash_attention_kernel_mma);
// - float32 runs on the CUDA cores (flash_attention_kernel): float32 on
//   the tensor cores would be TF32, which the checks refuse.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (a (B*H, Sq/bq, Skv/bk) grid whose innermost, sequential KV axis
// carries m, l and acc in VMEM scratch; KV head bh // G).
//
// What bounds it on an H100: operations. At the llama3.2-1b row (B 2,
// H 32, S 4096, hd 64, causal) the visible pairs need 137 G operations on
// 84 MB: 0.139 ms at the bf16 tensor-core rate against 0.025 ms of bytes.
//
// Both kernels: one block per (b*h, 64-row query tile), the heaviest
// causal tiles launched first; a loop inside the block over 64-key tiles
// takes the place of the TPU's sequential KV grid axis, and tiles no row
// of the block can see are never loaded (the saving the reference's
// docstring names). m starts at the finite -1e30: a fully masked tile
// gives corr = exp(0) = 1 and p = 0, so nothing becomes NaN.
//
// Tensor-core design (FlashAttention-2's structure): 4 warps, 16 query
// rows each. The query tile and two buffers of K and V tiles sit in
// shared memory (rows padded by 16 bytes, so ldmatrix's eight rows fall
// in distinct banks; hd padded with zeros to a multiple of 16, exact for
// q k^T), filled with cp.async (16-byte pieces, zero-filled past the
// edges) one tile ahead of the compute. Each warp keeps its q fragments
// in registers and runs S = q k^T on mma.sync m16n8k16 bf16 -> f32, then
// the scale, the mask (only on tiles that need one) and the online
// softmax in registers (a row's max and sum over the 4 lanes that hold
// it). The S accumulators become the A operand of P v without a trip
// through shared memory; v comes N-major through ldmatrix.trans. P keeps
// float32 accuracy: P = P_hi + P_lo, P_hi = bf16(P), P_lo = bf16(P -
// P_hi), two bf16 products against v (exact in bf16), which leaves an
// error near 2^-17 of sum p |v| where one bf16 P would leave 2^-9; l sums
// the float32 P. That costs 1.5x the tensor-core operations of one P.
//
// Remaining gap (PERF.md): mma.sync, not wgmma, so no asynchronous
// warpgroup products and no TMA; one query head per block, so the G heads
// of a KV head each load its tiles (L2 serves the repeats).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;

constexpr int F32 = 0;       // the dtype code of the CUDA-core entry point

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

// ---- float32 on the CUDA cores ----------------------------------------------
//
// 256 threads. Shared memory holds the query tile, one K tile (rows at an
// odd stride, so a warp's 16 key rows fall in 16 banks), one V tile and
// the 64 x 64 probabilities: 114 KB at hd = 128, opted in past 48 KB.
// Each thread keeps a 4 x 4 block of scores and a 4 x NJ block of acc
// (NJ = ceil(hd / 16); rows ty + 16 a, columns tx + 16 j), so a row's m,
// l and correction stay in the thread; a row's max and sum are reduced
// over its 16 lanes with shuffles.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int n_qtiles, int G,
                       int Sq, int Skv, int hd, int causal, int window, int64_t q_offset,
                       float scale) {
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
  const float* qg = q + (bh * Sq + q0) * hd;
  const float* kg = k + kvh * Skv * hd;
  const float* vg = v + kvh * Skv * hd;
  float* og = o + (bh * Sq + q0) * hd;

  for (int e = tid; e < BQ * hd; e += kThreads) {
    const int r = e / hd;
    qs[e] = q0 + r < Sq ? qg[e] : 0.f;
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
      ks[r * ldk + d] = in ? kg[g] : 0.f;
      vs[e] = in ? vg[g] : 0.f;
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
      if (col < hd) og[(int64_t)r * hd + col] = acc[a][j] / den;
    }
  }
}

template <int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int64_t BH, int G, int Sq,
           int Skv, int hd, int causal, int window, int64_t q_offset, float scale,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<NJ>;
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (Sq + BQ - 1) / BQ;
  const int64_t blocks = BH * n_qtiles;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>((const float*)q, (const float*)k,
                                                     (const float*)v, (float*)o, n_qtiles, G,
                                                     Sq, Skv, hd, causal, window, q_offset,
                                                     scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int64_t BH, int G, int Sq,
             int Skv, int hd, int causal, int window, int64_t q_offset, float scale,
             cudaStream_t s) {
  switch ((hd + 15) / 16) {
#define CASE(nj) \
  case nj:       \
    return launch<nj>(q, k, v, o, BH, G, Sq, Skv, hd, causal, window, q_offset, scale, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

bool valid_shape(int64_t B, int64_t H, int64_t KV, int64_t Sq, int64_t Skv, int64_t hd,
                 int64_t window) {
  return KV > 0 && H % KV == 0 && Skv > 0 && hd >= 1 && hd <= kMaxHd && window >= 0 &&
         window <= INT32_MAX && Sq * hd <= INT32_MAX && Skv * hd <= INT32_MAX &&
         B * H <= INT32_MAX;
}

// ---- bf16 on the tensor cores ------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;               // 4 warps x 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

// bf16 elements of one shared-memory row of a tile: hd padded to HDP (a
// multiple of 16) and 16 bytes more, so the 8 rows of an ldmatrix fall in
// 8 distinct 16-byte bank groups
__host__ __device__ constexpr int tc_stride(int hdp) { return hdp + 8; }
size_t tc_smem_bytes(int hdp) { return sizeof(bf16) * 5 * BQ * tc_stride(hdp); }  // q, 2 k, 2 v

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// the score of a key a row does not see: -inf, so exp2 gives exactly 0
__device__ __forceinline__ float masked() { return __int_as_float(0xff800000); }
// 16 bytes global -> shared, the last 16 - src_bytes of them zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a (16 x 16, row fragment) b (16 x 8, column fragment), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x, y) = hi + lo, each a bf16 pair (x in the low half): hi rounds to
// nearest even, lo rounds the exact float32 remainder x - hi
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// rows [r0, r0 + 64) of a row-major [S, hd] matrix into a tile of rows
// tc_stride(HDP) long: zero past S and past hd. vec: hd % 8 == 0 and
// 16-byte aligned, so cp.async 16-byte pieces (asynchronous); else one
// element at a time (synchronous).
template <int HDP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* g, int r0, int S, int hd,
                                          bool vec) {
  constexpr int STR = tc_stride(HDP), CH = HDP / 8;
  if (vec) {
    const uint32_t base = smem_u32(dst);
    for (int e = threadIdx.x; e < BQ * CH; e += kTcThreads) {
      const int r = e / CH, c = e - r * CH;
      const bool in = r0 + r < S && c * 8 < hd;
      cp_async16(base + 2 * (r * STR + c * 8), in ? g + (int64_t)(r0 + r) * hd + c * 8 : g,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BQ * HDP; e += kTcThreads) {
      const int r = e / HDP, c = e - r * HDP;
      dst[r * STR + c] =
          r0 + r < S && c < hd ? g[(int64_t)(r0 + r) * hd + c] : __float2bfloat16_rn(0.f);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o, int BH,
                           int n_qtiles, int G, int Sq, int Skv, int hd, int causal, int window,
                           int64_t q_offset, float scale, bool vec) {
  constexpr int STR = tc_stride(HDP);
  constexpr int NK = HDP / 16;            // 16-deep steps of q k^T
  constexpr int ND = HDP / 8;             // 8-column blocks of o
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][STR]
  bf16* ks = qs + BQ * STR;                        // [2][BK][STR]
  bf16* vs = ks + 2 * BK * STR;                    // [2][BK][STR]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qtiles - 1 - (int)(blockIdx.x / BH)) * BQ;   // heavy first
  const int64_t kvh = bh / G;
  const bf16* qg = q + (int64_t)bh * Sq * hd;
  const bf16* kg = k + kvh * Skv * hd;
  const bf16* vg = v + kvh * Skv * hd;

  // keys [klo, khi) are the only ones a row of this tile may see
  const int64_t qmin = q_offset + q0;
  const int64_t qmax = q_offset + min(q0 + BQ, Sq) - 1;
  int64_t klo = 0, khi = Skv;
  if (window > 0) klo = max((int64_t)0, qmin - window + 1);
  if (causal) khi = min((int64_t)Skv, qmax + 1);
  const int t_lo = (int)(klo / BK);
  const int t_hi = khi > klo ? (int)((khi + BK - 1) / BK) : t_lo;

  load_tile<HDP>(qs, qg, q0, Sq, hd, vec);
  if (t_lo < t_hi) {
    load_tile<HDP>(ks, kg, t_lo * BK, Skv, hd, vec);
    load_tile<HDP>(vs, vg, t_lo * BK, Skv, hd, vec);
  }
  cp_async_commit();

  // this thread's rows of the warp's 16: r and r + 8 (h = 0, 1)
  const int rw = warp * 16 + lane / 4;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[NK][4];
  const int mi = lane / 8, ri = lane % 8;           // ldmatrix: matrix, row

  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      load_tile<HDP>(ks + (buf ^ 1) * BK * STR, kg, (t + 1) * BK, Skv, hd, vec);
      load_tile<HDP>(vs + (buf ^ 1) * BK * STR, vg, (t + 1) * BK, Skv, hd, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == t_lo) {
#pragma unroll
      for (int kc = 0; kc < NK; ++kc)
        ldmatrix_x4(qf[kc], smem_u32(qs + (warp * 16 + (mi % 2) * 8 + ri) * STR + kc * 16 +
                                     (mi / 2) * 8));
    }

    // S = q k^T: 16 rows x 64 keys a warp, 8 key blocks of 8
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    const bf16* kt = ks + buf * BK * STR;
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(kt + (nb2 * 16 + (mi / 2) * 8 + ri) * STR + kc * 16 +
                                (mi % 2) * 8));
        mma_bf16(s[2 * nb2], qf[kc], b[0], b[1]);
        mma_bf16(s[2 * nb2 + 1], qf[kc], b[2], b[3]);
      }
    }

    // scale and mask; s[nb][e] is row rw + 8 (e / 2), key k0 + 8 nb +
    // 2 (lane % 4) + e % 2
    const int k0 = t * BK;
    const bool full = k0 + BK <= Skv && (!causal || qmin >= k0 + BK - 1) &&
                      (window <= 0 || qmax - k0 < window);
    float mx[2] = {masked(), masked()};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale;
        if (!full) {
          const int64_t key = k0 + 8 * nb + 2 * (lane % 4) + (e & 1);
          const int64_t qpos = qmin + rw + 8 * (e >> 1);
          const bool vis = key < Skv && (!causal || qpos >= key) &&
                           (window <= 0 || qpos - key < window);
          x = vis ? x : masked();
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f((m[h] - m_new) * kLog2e);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[nb][e] - m[e >> 1]) * kLog2e);   // masked: exp2(-inf) = 0
        s[nb][e] = p;
        l[e >> 1] += p;
      }

    // acc += (P_hi + P_lo) v: the S blocks 2 kc and 2 kc + 1 are the A
    // fragment of keys [16 kc, 16 kc + 16)
    const bf16* vt = vs + buf * BK * STR;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split2(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split2(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split2(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_u32(vt + (kc * 16 + (mi % 2) * 8 + ri) * STR + nd2 * 16 +
                                      (mi / 2) * 8));
        mma_bf16(acc[2 * nd2], ph, b[0], b[1]);
        mma_bf16(acc[2 * nd2], pl, b[0], b[1]);
        mma_bf16(acc[2 * nd2 + 1], ph, b[2], b[3]);
        mma_bf16(acc[2 * nd2 + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();                      // the buffer is reloaded next step
  }

  // o = acc / max(l, 1e-30); acc[j][e] is row rw + 8 (e / 2), column
  // 8 j + 2 (lane % 4) + e % 2
  bf16* og = o + (int64_t)bh * Sq * hd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + rw + 8 * h;
    if (row >= Sq) continue;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col >= hd) continue;
      const float x = acc[j][2 * h] / den, y = acc[j][2 * h + 1] / den;
      bf16* p = og + (int64_t)row * hd + col;
      if (hd % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
      } else {
        p[0] = __float2bfloat16_rn(x);
        if (col + 1 < hd) p[1] = __float2bfloat16_rn(y);
      }
    }
  }
}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, void* o, int BH, int G, int Sq,
              int Skv, int hd, int causal, int window, int64_t q_offset, float scale, bool vec,
              cudaStream_t stream) {
  auto kern = flash_attention_kernel_mma<HDP>;
  const size_t smem = tc_smem_bytes(HDP);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (Sq + BQ - 1) / BQ;
  const int64_t blocks = (int64_t)BH * n_qtiles;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, BH, n_qtiles, G, Sq, Skv, hd,
      causal, window, q_offset, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 o = attention(q, k, v) on the CUDA cores (dtype code F32); q
// [B, H, Sq, hd], k / v [B, KV, Skv, hd], o [B, H, Sq, hd], all
// contiguous; window 0 is no window. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for what it does not
// take (another dtype, hd outside 1..128, H not a multiple of KV, sizes
// past int32).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* o, int64_t B, int64_t H, int64_t KV, int64_t Sq,
                                      int64_t Skv, int64_t hd, int causal, int64_t window,
                                      int64_t q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (dtype != F32 || !valid_shape(B, H, KV, Sq, Skv, hd, window))
    return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, o, B * H, (int)(H / KV), (int)Sq, (int)Skv, (int)hd, causal,
                         (int)window, q_offset, scale, (cudaStream_t)stream);
}

// bf16 o = attention(q, k, v) on the tensor cores; the arguments of
// flash_attention_launch without the dtype. Returns as it does.
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* o,
                                         int64_t B, int64_t H, int64_t KV, int64_t Sq,
                                         int64_t Skv, int64_t hd, int causal, int64_t window,
                                         int64_t q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (!valid_shape(B, H, KV, Sq, Skv, hd, window)) return (int)cudaErrorInvalidValue;
  const bool vec = hd % 8 == 0 &&
                   (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16) == 0;
  const int BH = (int)(B * H), G = (int)(H / KV);
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
#define CASE(n)                                                                                \
  case n:                                                                                      \
    return launch_tc<16 * n>(q, k, v, o, BH, G, (int)Sq, (int)Skv, (int)hd, causal,           \
                             (int)window, q_offset, scale, vec, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}
