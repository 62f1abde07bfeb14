// Flash attention with an online softmax: o = softmax(q k^T / sqrt(hd)) v
// per query head, over the keys each query row sees (causal: q_pos >=
// k_pos; a non-zero window: q_pos - k_pos < window, of either sign, as the
// reference's `if window:` reads it; q_pos = q_offset + row), with
// grouped-query heads (H = KV * G). q [B, H, Sq, hd], k and v [B, KV, Skv,
// hd], o [B, H, Sq, hd]. m, l and acc are float32; o = acc / max(l,
// 1e-30), rounded to the input's type (to nearest even), so a query row
// that sees no key gives 0. Two kernels, picked by the operand type and hd:
// - bf16 and float16 with hd <= 256 run on the tensor cores
//   (flash_attention_kernel_mma, mma.sync with float32 accumulation);
// - float32 (float32 on the tensor cores would be TF32, which the checks
//   refuse), and bf16 / float16 with hd above 256, run on the CUDA cores
//   (flash_attention_kernel, converting loads), at any hd.
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
// docstring names): keys below q_min - window + 1 (any non-zero window)
// and, when causal, above q_max. m starts at the finite -1e30: a fully
// masked tile gives corr = exp(0) = 1 and p = 0, so nothing becomes NaN.
//
// Tensor-core design (FlashAttention-2's structure): 4 warps, 16 query
// rows each. The query tile and two buffers of K and V tiles sit in
// shared memory (rows padded by 16 bytes, so ldmatrix's eight rows fall
// in distinct banks; hd padded with zeros up to the tile width HDP, one of
// 32, 64, 96, 128, 160, 192, 256, exact for q k^T), filled with cp.async
// (16-byte pieces, zero-filled past the edges) one tile ahead of the
// compute: 5 x 64 x (HDP + 8) x 2 bytes, 169 KB at HDP 256. Up to HDP 160
// each warp keeps its q fragments in registers (255 a thread there); past
// it, it reads them from shared memory at every key tile (acc alone holds
// 96 registers at 192, 128 at 256).
// S = q k^T runs on mma.sync m16n8k16 (bf16 or f16) -> f32, then the
// scale, the mask (only on tiles that need one) and the online softmax in
// registers (a row's max and sum over the 4 lanes that hold it). The S
// accumulators become the A operand of P v without a trip through shared
// memory; v comes N-major through ldmatrix.trans. P keeps float32
// accuracy: P = P_hi + P_lo, P_hi = T(P), P_lo = T(P - P_hi), two
// products against v (exact in T), which leaves an error near 2^-17 of
// sum p |v| (bf16; float16's 11-bit P_hi leaves less, its P_lo under 2^-14
// goes subnormal, an absolute error under 2^-24) where one bf16 P would
// leave 2^-9; l sums the float32 P. That costs 1.5x the tensor-core
// operations of one P. float16 takes the tensor cores because its
// products are exact in float32 and it has bf16's width: the same kernel
// with the f16 mma and conversions, at the bf16 rate.
//
// CUDA-core design: 256 threads, each with a 4 x 4 block of scores and a
// 4 x NJ block of acc (rows ty + 16 a, columns c0 + tx + 16 j). hd runs in
// chunks of 128: S sums q k^T over the chunks of q and k staged in shared
// memory (q stays resident when hd <= 128), and each block writes one
// 128-wide column chunk of o (grid y), so shared memory is 115 KB at any
// hd and hd above 128 recomputes S once a column chunk.
//
// Remaining gap (PERF.md): mma.sync, not wgmma, so no asynchronous
// warpgroup products and no TMA; one query head per block, so the G heads
// of a KV head each load its tiles (L2 serves the repeats).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int DC = 128;      // hd chunk of the CUDA-core kernel
constexpr int kMaxTcHd = 256;
constexpr float kNegInf = -1e30f;

// dtype codes of the entry points
constexpr int F32 = 0, BF16 = 1, F16 = 2;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * DC + (size_t)BK * (DC + 1) + (size_t)BK * DC +
                          (size_t)BQ * (BK + 1));
}

// the keys [klo, khi) some row of a query tile with positions [qmin, qmax]
// may see, as 64-key tiles [t_lo, t_hi)
__device__ __forceinline__ void key_tiles(int64_t qmin, int64_t qmax, int Skv, int causal,
                                          int window, int& t_lo, int& t_hi) {
  int64_t klo = 0, khi = Skv;
  if (window != 0) klo = max((int64_t)0, qmin - window + 1);
  if (causal) khi = min((int64_t)Skv, qmax + 1);
  klo = min(klo, (int64_t)Skv);
  t_lo = (int)(klo / BK);
  t_hi = khi > klo ? (int)((khi + BK - 1) / BK) : t_lo;
}

__device__ __forceinline__ bool sees(int64_t qpos, int64_t key, int Skv, int causal,
                                     int window) {
  return key < Skv && (!causal || qpos >= key) && (window == 0 || qpos - key < window);
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

// ---- the CUDA cores: float32, and bf16 / float16 above hd 256 ----------------
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int n_qtiles, int G, int Sq,
                       int Skv, int hd, int causal, int window, int64_t q_offset, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDK = DC + 1;             // odd: a warp's 16 key rows in 16 banks
  float* qs = smem;                       // [BQ][DC]
  float* ks = qs + BQ * DC;               // [BK][LDK]
  float* vs = ks + BK * LDK;              // [BK][DC]
  float* ps = vs + BK * DC;               // [BQ][BK + 1]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t bh = blockIdx.x / n_qtiles;
  const int q0 = (n_qtiles - 1 - (int)(blockIdx.x % n_qtiles)) * BQ;   // heavy first
  const int c0 = blockIdx.y * DC;         // this block's columns of o
  const int nc = min(DC, hd - c0);
  const int n_chunks = (hd + DC - 1) / DC;
  const int64_t kvh = bh / G;
  const T* qg = q + (bh * Sq + q0) * hd;
  const T* kg = k + kvh * Skv * hd;
  const T* vg = v + kvh * Skv * hd;
  T* og = o + (bh * Sq + q0) * hd;

  const int64_t qmin = q_offset + q0;
  const int64_t qmax = q_offset + min(q0 + BQ, Sq) - 1;
  int t_lo, t_hi;
  key_tiles(qmin, qmax, Skv, causal, window, t_lo, t_hi);

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
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int d0 = ch * DC, dn = min(DC, hd - d0);
      __syncthreads();                    // the previous chunk's readers are done
      if (n_chunks > 1 || t == t_lo) {
        for (int e = tid; e < BQ * DC; e += kThreads) {
          const int r = e / DC, d = e - r * DC;
          qs[e] = q0 + r < Sq && d < dn ? to_f(qg[(int64_t)r * hd + d0 + d]) : 0.f;
        }
      }
      for (int e = tid; e < BK * DC; e += kThreads) {
        const int r = e / DC, d = e - r * DC;
        ks[r * LDK + d] = k0 + r < Skv && d < dn ? to_f(kg[(int64_t)(k0 + r) * hd + d0 + d]) : 0.f;
      }
      __syncthreads();
      for (int d = 0; d < dn; ++d) {
        float qa[4], kb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * DC + d];
#pragma unroll
        for (int b = 0; b < 4; ++b) kb[b] = ks[(tx + 16 * b) * LDK + d];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
      }
    }
    // v's columns [c0, c0 + nc) of this tile; its readers of the last
    // tile passed the barrier above
    for (int e = tid; e < BK * DC; e += kThreads) {
      const int r = e / DC, d = e - r * DC;
      vs[e] = k0 + r < Skv && d < nc ? to_f(vg[(int64_t)(k0 + r) * hd + c0 + d]) : 0.f;
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const int64_t qpos = qmin + r;
      bool vis[4];
      float mc = kNegInf;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        vis[b] = sees(qpos, k0 + tx + 16 * b, Skv, causal, window);
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
        const float vv = vs[c * DC + tx + 16 * j];
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
      if (col < nc) og[(int64_t)r * hd + c0 + col] = from_f<T>(acc[a][j] / den);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int64_t BH, int G, int Sq,
           int Skv, int hd, int causal, int window, int64_t q_offset, float scale,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, NJ>;
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (Sq + BQ - 1) / BQ;
  const int64_t blocks = BH * n_qtiles;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)((hd + DC - 1) / DC));
  kern<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                         n_qtiles, G, Sq, Skv, hd, causal, window, q_offset,
                                         scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int64_t BH, int G, int Sq,
             int Skv, int hd, int causal, int window, int64_t q_offset, float scale,
             cudaStream_t s) {
  // NJ column blocks of 16 a thread: the block's column chunk min(hd, 128)
  const int nj = (min(hd, DC) + 15) / 16;
  if (nj <= 2) return launch<T, 2>(q, k, v, o, BH, G, Sq, Skv, hd, causal, window, q_offset, scale, s);
  if (nj <= 4) return launch<T, 4>(q, k, v, o, BH, G, Sq, Skv, hd, causal, window, q_offset, scale, s);
  if (nj <= 6) return launch<T, 6>(q, k, v, o, BH, G, Sq, Skv, hd, causal, window, q_offset, scale, s);
  return launch<T, 8>(q, k, v, o, BH, G, Sq, Skv, hd, causal, window, q_offset, scale, s);
}

bool valid_shape(int64_t B, int64_t H, int64_t KV, int64_t Sq, int64_t Skv, int64_t hd,
                 int64_t window) {
  return KV > 0 && H % KV == 0 && Skv > 0 && hd >= 1 && window >= INT32_MIN &&
         window <= INT32_MAX && Sq * hd <= INT32_MAX && Skv * hd <= INT32_MAX &&
         B * H <= INT32_MAX && (hd + DC - 1) / DC <= 65535;
}

// ---- bf16 and float16 on the tensor cores -------------------------------------

constexpr int kTcThreads = 128;               // 4 warps x 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

// 16-bit elements of one shared-memory row of a tile: hd padded to HDP and
// 16 bytes more, so the 8 rows of an ldmatrix fall in 8 distinct 16-byte
// bank groups
__host__ __device__ constexpr int tc_stride(int hdp) { return hdp + 8; }
size_t tc_smem_bytes(int hdp) { return 2 * 5 * BQ * tc_stride(hdp); }  // q, 2 k, 2 v

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
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1);
template <>
__device__ __forceinline__ void mma16<bf16>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16<__half>(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x, y) as a pair of T in one register (x in the low half), to nearest even
__device__ __forceinline__ uint32_t pack2(bf16, float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(__half, float x, float y) {
  const __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack2(bf16, uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ float2 unpack2(__half, uint32_t u) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}
// (x, y) = hi + lo, each a T pair: hi rounds to nearest even, lo rounds
// the exact float32 remainder x - hi
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack2(T(), x, y);
  const float2 hf = unpack2(T(), hi);
  lo = pack2(T(), x - hf.x, y - hf.y);
}

// rows [r0, r0 + 64) of a row-major [S, hd] matrix into a tile of rows
// tc_stride(HDP) long: zero past S and past hd. vec: hd % 8 == 0 and
// 16-byte aligned, so cp.async 16-byte pieces (asynchronous); else one
// element at a time (synchronous).
template <typename T, int HDP>
__device__ __forceinline__ void load_tile(T* dst, const T* g, int r0, int S, int hd, bool vec) {
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
      dst[r * STR + c] = r0 + r < S && c < hd ? g[(int64_t)(r0 + r) * hd + c] : from_f<T>(0.f);
    }
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_kernel_mma(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int BH, int n_qtiles,
                           int G, int Sq, int Skv, int hd, int causal, int window,
                           int64_t q_offset, float scale, bool vec) {
  constexpr int STR = tc_stride(HDP);
  constexpr int NK = HDP / 16;            // 16-deep steps of q k^T
  constexpr int ND = HDP / 8;             // 8-column blocks of o
  constexpr bool kQRegs = HDP <= 160;     // q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);         // [BQ][STR]
  T* ks = qs + BQ * STR;                           // [2][BK][STR]
  T* vs = ks + 2 * BK * STR;                       // [2][BK][STR]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qtiles - 1 - (int)(blockIdx.x / BH)) * BQ;   // heavy first
  const int64_t kvh = bh / G;
  const T* qg = q + (int64_t)bh * Sq * hd;
  const T* kg = k + kvh * Skv * hd;
  const T* vg = v + kvh * Skv * hd;

  const int64_t qmin = q_offset + q0;
  const int64_t qmax = q_offset + min(q0 + BQ, Sq) - 1;
  int t_lo, t_hi;
  key_tiles(qmin, qmax, Skv, causal, window, t_lo, t_hi);

  load_tile<T, HDP>(qs, qg, q0, Sq, hd, vec);
  if (t_lo < t_hi) {
    load_tile<T, HDP>(ks, kg, t_lo * BK, Skv, hd, vec);
    load_tile<T, HDP>(vs, vg, t_lo * BK, Skv, hd, vec);
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
  uint32_t qf[kQRegs ? NK : 1][4];
  const int mi = lane / 8, ri = lane % 8;           // ldmatrix: matrix, row
  const T* qrow = qs + (warp * 16 + (mi % 2) * 8 + ri) * STR + (mi / 2) * 8;

  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      load_tile<T, HDP>(ks + (buf ^ 1) * BK * STR, kg, (t + 1) * BK, Skv, hd, vec);
      load_tile<T, HDP>(vs + (buf ^ 1) * BK * STR, vg, (t + 1) * BK, Skv, hd, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQRegs) {
      if (t == t_lo) {
#pragma unroll
        for (int kc = 0; kc < NK; ++kc) ldmatrix_x4(qf[kc], smem_u32(qrow + kc * 16));
      }
    }

    // S = q k^T: 16 rows x 64 keys a warp, 8 key blocks of 8
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    const T* kt = ks + buf * BK * STR;
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kc][e];
      } else {
        ldmatrix_x4(qa, smem_u32(qrow + kc * 16));
      }
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(kt + (nb2 * 16 + (mi / 2) * 8 + ri) * STR + kc * 16 +
                                (mi % 2) * 8));
        mma16<T>(s[2 * nb2], qa, b[0], b[1]);
        mma16<T>(s[2 * nb2 + 1], qa, b[2], b[3]);
      }
    }

    // scale and mask; s[nb][e] is row rw + 8 (e / 2), key k0 + 8 nb +
    // 2 (lane % 4) + e % 2. A tile is full when every pair sees: the
    // largest q_pos - k_pos, qmax - k0, is below a non-zero window (of
    // either sign)
    const int k0 = t * BK;
    const bool full = k0 + BK <= Skv && (!causal || qmin >= k0 + BK - 1) &&
                      (window == 0 || qmax - k0 < window);
    float mx[2] = {masked(), masked()};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale;
        if (!full) {
          const int64_t key = k0 + 8 * nb + 2 * (lane % 4) + (e & 1);
          x = sees(qmin + rw + 8 * (e >> 1), key, Skv, causal, window) ? x : masked();
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
    const T* vt = vs + buf * BK * STR;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ph[4], pl[4];
      split2<T>(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split2<T>(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split2<T>(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split2<T>(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_u32(vt + (kc * 16 + (mi % 2) * 8 + ri) * STR + nd2 * 16 +
                                      (mi / 2) * 8));
        mma16<T>(acc[2 * nd2], ph, b[0], b[1]);
        mma16<T>(acc[2 * nd2], pl, b[0], b[1]);
        mma16<T>(acc[2 * nd2 + 1], ph, b[2], b[3]);
        mma16<T>(acc[2 * nd2 + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();                      // the buffer is reloaded next step
  }

  // o = acc / max(l, 1e-30); acc[j][e] is row rw + 8 (e / 2), column
  // 8 j + 2 (lane % 4) + e % 2
  T* og = o + (int64_t)bh * Sq * hd;
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
      T* p = og + (int64_t)row * hd + col;
      if (hd % 2 == 0) {
        *reinterpret_cast<uint32_t*>(p) = pack2(T(), x, y);
      } else {
        p[0] = from_f<T>(x);
        if (col + 1 < hd) p[1] = from_f<T>(y);
      }
    }
  }
}

template <typename T, int HDP>
int launch_tc(const void* q, const void* k, const void* v, void* o, int BH, int G, int Sq,
              int Skv, int hd, int causal, int window, int64_t q_offset, float scale, bool vec,
              cudaStream_t stream) {
  auto kern = flash_attention_kernel_mma<T, HDP>;
  const size_t smem = tc_smem_bytes(HDP);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (Sq + BQ - 1) / BQ;
  const int64_t blocks = (int64_t)BH * n_qtiles;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, BH, n_qtiles, G, Sq, Skv, hd, causal, window,
      q_offset, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_tc(const void* q, const void* k, const void* v, void* o, int BH, int G, int Sq,
                int Skv, int hd, int causal, int window, int64_t q_offset, float scale, bool vec,
                cudaStream_t s) {
  // the tile width: hd padded up to one of 32, 64, 96, 128, 160, 192, 256
#define TC(hdp) launch_tc<T, hdp>(q, k, v, o, BH, G, Sq, Skv, hd, causal, window, q_offset, scale, vec, s)
  if (hd <= 32) return TC(32);
  if (hd <= 64) return TC(64);
  if (hd <= 96) return TC(96);
  if (hd <= 128) return TC(128);
  if (hd <= 160) return TC(160);
  if (hd <= 192) return TC(192);
  if (hd <= kMaxTcHd) return TC(256);
#undef TC
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// o = attention(q, k, v) on the CUDA cores: dtype 0 float32, 1 bf16, 2
// float16 (converting loads, float32 arithmetic, any hd); q [B, H, Sq,
// hd], k / v [B, KV, Skv, hd], o [B, H, Sq, hd], all contiguous; window 0
// is no window, a negative one the reference's predicate. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what it does not take (another dtype, H not a
// multiple of KV, sizes past int32).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* o, int64_t B, int64_t H, int64_t KV, int64_t Sq,
                                      int64_t Skv, int64_t hd, int causal, int64_t window,
                                      int64_t q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (!valid_shape(B, H, KV, Sq, Skv, hd, window)) return (int)cudaErrorInvalidValue;
  const int G = (int)(H / KV);
  cudaStream_t s = (cudaStream_t)stream;
#define ARGS q, k, v, o, B * H, G, (int)Sq, (int)Skv, (int)hd, causal, (int)window, q_offset, scale, s
  switch (dtype) {
    case F32: return dispatch<float>(ARGS);
    case BF16: return dispatch<bf16>(ARGS);
    case F16: return dispatch<__half>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

// bf16 (dtype 1) or float16 (dtype 2) o = attention(q, k, v) on the tensor
// cores, hd up to 256; the arguments of flash_attention_launch. Returns as
// it does.
extern "C" int flash_attention_tc_launch(int dtype, const void* q, const void* k,
                                         const void* v, void* o, int64_t B, int64_t H,
                                         int64_t KV, int64_t Sq, int64_t Skv, int64_t hd,
                                         int causal, int64_t window, int64_t q_offset,
                                         float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (!valid_shape(B, H, KV, Sq, Skv, hd, window) || hd > kMaxTcHd)
    return (int)cudaErrorInvalidValue;
  const bool vec = hd % 8 == 0 &&
                   (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16) == 0;
  const int BH = (int)(B * H), G = (int)(H / KV);
  cudaStream_t s = (cudaStream_t)stream;
#define ARGS q, k, v, o, BH, G, (int)Sq, (int)Skv, (int)hd, causal, (int)window, q_offset, scale, vec, s
  switch (dtype) {
    case BF16: return dispatch_tc<bf16>(ARGS);
    case F16: return dispatch_tc<__half>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
