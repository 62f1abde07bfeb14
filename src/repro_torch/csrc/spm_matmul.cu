// Dense matrix product C[M, N] = A[M, K] @ B[K, N], two kernels picked by
// the operand type:
// - bf16 and int8 run on the tensor cores (spm_matmul_kernel_wgmma):
//   bf16 accumulates in float32 and stores float32 or bf16 (rounded to
//   nearest even); int8 accumulates in a wrapping 32-bit integer
//   (wgmma .s32.s8.s8 without .satfinite) and stores int32;
// - float32 runs on the CUDA cores (spm_matmul_kernel, the tile routine
//   of spm_tiles.cuh, which the het-MIMD composite's matmul runs too:
//   here 128 x 64 tiles, 8 x 8 outputs a thread fed by float4 reads, the
//   block's two halves splitting K, K slabs of 16 through a three-stage
//   cp.async ring), one FMA per term: float32 on the tensor cores would
//   be TF32, which the checks refuse.
//
// Replaces the TPU kernel repro/kernels/spm_matmul.py::_matmul_kernel
// (a (M/bm, N/bn, K/bk) grid that carries a VMEM accumulator across the
// sequential K steps and feeds the 128 x 128 MXU).
//
// What bounds it on an H100: operations. At 4096^3 the product does
// 2 * 4096^3 = 137 G operations on 100 MB of operands, far above the
// card's ridge for every type: 0.139 ms at 989 TFLOP/s bf16, 0.069 ms at
// 1979 TOPS int8, 2.05 ms at 67 TFLOP/s for float32 held to FP32.
//
// Tensor-core design: one block of three warpgroups per 128 x 128 output
// tile. Warpgroup 0 is the producer: one thread walks K in stages of 128
// bytes a row (64 bf16 or 128 int8) and fills a ring of kStages stages
// of shared memory with TMA (cp.async.bulk.tensor, 128-byte swizzle),
// each stage completing on a "full" mbarrier. Warpgroups 1 and 2 are the
// consumers: each owns 64 rows of the tile, waits on a stage, issues four
// wgmma.mma_async m64n128 (k16 bf16, k32 int8) from shared memory into
// 64 accumulator registers a thread, keeps one group in flight and
// releases the stage before it on an "empty" mbarrier. The epilogue
// stores straight from the registers, predicated on the M and N edges.
// A is K-major (row-major [M, K]). wgmma reads bf16 B N-major through the
// descriptor's transpose bit, so bf16 B stays [K, N]; 8-bit operands must
// be K-major, so the wrapper hands int8 B over transposed, [N, K]. TMA
// needs 16-byte row strides: the wrapper pads K (and bf16 N) with zeros
// where they are not multiples of 16 bytes, which adds only zero terms.
// TMA fills the ragged M, N and K edges of a box with zeros. The tensor
// maps are encoded on the host through the driver entry point (no -lcuda)
// and passed as __grid_constant__ parameters.
//
// Remaining gap (PERF.md): no persistent grid or clusters, so one tile's
// epilogue does not overlap the next tile's loads; the epilogue writes
// 8-byte pieces, not whole lines; int8 B costs a transposing copy in the
// wrapper.

#include <cuda.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "spm_tiles.cuh"

namespace {

enum Dtype { F32 = 0, BF16 = 1, I8 = 2, I32 = 3 };

// ---- float32 on the CUDA cores ---------------------------------------------

// 128 x 64 tiles (512 at 2048^2), K slabs of 16
constexpr int kF32Rows = 128, kF32Slab = 16;

__global__ void __launch_bounds__(spm::kThreads, 2)
spm_matmul_kernel(const float* a, const float* b, float* c, int64_t M, int64_t N, int64_t K) {
  extern __shared__ __align__(16) unsigned char smem[];
  spm::matmul_tile<kF32Rows, kF32Slab>(a, b, c, M, N, K, blockIdx.x, smem);
}

// ---- bf16 and int8 on the tensor cores ---------------------------------------

constexpr int BM = 128, BN = 128;
constexpr int kRowBytes = 128;                  // one swizzle row: 64 bf16 or 128 int8 of K
constexpr int kStageBytes = BM * kRowBytes;     // A's and B's share of a stage, 16 KB each
constexpr int kStages = 4;
constexpr int kTcThreads = 3 * 128;             // producer warpgroup + two consumers
constexpr int kConsumerThreads = 2 * 128;
constexpr size_t kTcSmem = 1024 + 2 * kStages * kStageBytes + 2 * kStages * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// spin until the phase of parity `parity` of the barrier has completed; a
// pipeline stuck for 2^26 polls (seconds) traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one TMA box {c0 (innermost), c1} of the map into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator registers while wgmma owns them
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC8(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
                   C(d[i + 6]), C(d[i + 7])
#define ACC64(C) ACC8(C, 0), ACC8(C, 8), ACC8(C, 16), ACC8(C, 24), ACC8(C, 32), ACC8(C, 40), \
                 ACC8(C, 48), ACC8(C, 56)
#define F_(x) "+f"(x)
#define R_(x) "+r"(x)
#define D64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
            "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
            "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
            "%62, %63}"

// d += A (64 x 16, K-major) @ B (16 x 128, N-major: the transpose bit)
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64
      ", %64, %65, p, 1, 1, 0, 1;\n}"
      : ACC64(F_)
      : "l"(da), "l"(db), "r"(1));
}
// d += A (64 x 32) @ B (32 x 128), both K-major; the s32 sum wraps
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " D64 ", %64, %65, p;\n}"
      : ACC64(R_)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store1(int32_t* p, int32_t x) { *p = x; }
// two neighbours at an even column of an even-width row (aligned)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(int32_t* p, int32_t x, int32_t y) {
  *reinterpret_cast<int2*>(p) = make_int2(x, y);
}

// INT8: int8 operands, B K-major; else bf16, B N-major
template <bool INT8, typename Tout>
__global__ void __launch_bounds__(kTcThreads, 1)
spm_matmul_kernel_wgmma(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b, Tout* __restrict__ c,
                        int M, int N, int n_k) {
  using Acc = typename std::conditional<INT8, int32_t, float>::type;
  constexpr int KE = INT8 ? 128 : 64;             // K elements of one stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t tiles = (raw + 1023) & ~1023u;   // the swizzle needs 1024-byte alignment
  const uint32_t a_s = tiles, b_s = tiles + kStages * kStageBytes;
  const uint32_t full = b_s + kStages * kStageBytes, empty = full + kStages * 8;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + 8 * s, ((kt / kStages) - 1) & 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * kStageBytes);
        tma_load(a_s + s * kStageBytes, &map_a, kt * KE, m0, bar);
        if (INT8) {
          tma_load(b_s + s * kStageBytes, &map_b, kt * KE, n0, bar);
        } else {                                  // two 64-column boxes of [64 K][64 N]
          tma_load(b_s + s * kStageBytes, &map_b, n0, kt * KE, bar);
          tma_load(b_s + s * kStageBytes + kStageBytes / 2, &map_b, n0 + 64, kt * KE, bar);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128 - 1;
  Acc d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = Acc(0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const uint32_t a = a_s + s * kStageBytes + wg * 64 * kRowBytes;
    const uint32_t b = b_s + s * kStageBytes;
    pin(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {              // 32 bytes of K each
      const uint64_t da = sw128_desc(a + 32 * kk, 16, 1024);
      if constexpr (INT8) {
        wgmma_s8(d, da, sw128_desc(b + 32 * kk, 16, 1024));
      } else {
        // N-major: 16 K rows of 128 bytes a step; the next 64 columns
        // (LBO) lie half a stage on, the next 8 K rows (SBO) 1024 bytes
        wgmma_bf16(d, da, sw128_desc(b + 2048 * kk, kStageBytes / 2, 1024));
      }
    }
    wgmma_commit();
    pin(d);
    if (kt > 0) {
      wgmma_wait<1>();
      mbar_arrive(empty + 8 * ((kt - 1) % kStages));
    }
  }
  wgmma_wait<0>();
  pin(d);

  // epilogue: d[4j + 2h + e] is row 16 warp + lane / 4 + 8 h, column
  // 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 128 block
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const bool even = (N % 2) == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      Tout* p = c + (int64_t)row * N + col;
      const Acc x = d[4 * j + 2 * h], y = d[4 * j + 2 * h + 1];
      if (even) {
        store2(p, x, y);
      } else {
        store1(p, x);
        if (col + 1 < N) store1(p + 1, y);
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a row-major [outer, inner] matrix of 1- or 2-byte elements, boxes of
// [box_outer][box_inner] with box_inner * size = 128 bytes
bool make_map(CUtensorMap* map, const void* ptr, bool bytes, int64_t inner, int64_t outer,
              uint32_t box_inner, uint32_t box_outer) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * (bytes ? 1 : 2)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool INT8, typename Tout>
int launch_tc(const CUtensorMap& ma, const CUtensorMap& mb, void* c, int64_t M, int64_t N,
              int64_t Kp, cudaStream_t stream) {
  auto kern = spm_matmul_kernel_wgmma<INT8, Tout>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t ke = INT8 ? 128 : 64;
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  kern<<<grid, kTcThreads, kTcSmem, stream>>>(ma, mb, (Tout*)c, (int)M, (int)N,
                                              (int)((Kp + ke - 1) / ke));
  return (int)cudaGetLastError();
}

}  // namespace

// float32 c = a @ b on the CUDA cores (in and out dtype codes F32). Returns
// cudaGetLastError() after the launch (0 on success); launches nothing
// when M or N is 0.
extern "C" int spm_matmul_launch(int in_dtype, int out_dtype, const void* a, const void* b,
                                 void* c, int64_t M, int64_t N, int64_t K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (in_dtype != F32 || out_dtype != F32) return (int)cudaErrorInvalidValue;
  const int64_t tiles = spm::matmul_tiles<kF32Rows>(M, N);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = spm::MmTile<kF32Rows, kF32Slab>::kSmemBytes;
  const int rc = spm::allow_smem(spm_matmul_kernel, smem);
  if (rc != 0) return rc;
  spm_matmul_kernel<<<(unsigned)tiles, spm::kThreads, smem,
                      (cudaStream_t)stream>>>((const float*)a, (const float*)b, (float*)c, M, N,
                                              K);
  return (int)cudaGetLastError();
}

// c [M, N] = a @ b on the tensor cores, for in / out dtype codes (BF16,
// BF16), (BF16, F32), (I8, I32). a is [M, Kp] row-major; b is [Kp, Nb]
// for bf16 (Nb >= N, Nb % 8 == 0) and [N, Kp] for int8 (K-major); Kp
// keeps rows whole 16-byte multiples (Kp % 8 for bf16, Kp % 16 for int8),
// the pointers are 16-byte aligned and padded entries are zeros. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what it does not take (including a tensor map
// the driver refuses); launches nothing when M or N is 0.
extern "C" int spm_matmul_tc_launch(int in_dtype, int out_dtype, const void* a, const void* b,
                                    void* c, int64_t M, int64_t N, int64_t Kp, int64_t Nb,
                                    void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const bool int8 = in_dtype == I8;
  if (int8 ? out_dtype != I32 : (in_dtype != BF16 || (out_dtype != BF16 && out_dtype != F32)))
    return (int)cudaErrorInvalidValue;
  if (Kp <= 0 || Kp % (int8 ? 16 : 8) != 0 || M > INT32_MAX || N > INT32_MAX ||
      Kp > INT32_MAX || (!int8 && (Nb < N || Nb % 8 != 0)) ||
      ((uintptr_t)a | (uintptr_t)b) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const bool ok = int8 ? make_map(&ma, a, true, Kp, M, 128, BM) &&
                             make_map(&mb, b, true, Kp, N, 128, BN)
                       : make_map(&ma, a, false, Kp, M, 64, BM) &&
                             make_map(&mb, b, false, Nb, Kp, 64, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (int8) return launch_tc<true, int32_t>(ma, mb, c, M, N, Kp, s);
  if (out_dtype == BF16) return launch_tc<false, __nv_bfloat16>(ma, mb, c, M, N, Kp, s);
  return launch_tc<false, float>(ma, mb, c, M, N, Kp, s);
}
