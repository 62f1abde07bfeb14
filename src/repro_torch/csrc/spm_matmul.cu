// Dense matrix product C[M, N] = A[M, K] @ B[K, N], two kernels picked by
// the operand type, each storing any output type of the reference (XLA's
// converts, spm_tiles.cuh store_out: floats to nearest even, a float sum
// into an integer type saturated and truncated with NaN to 0, an int32
// sum into a narrower integer wrapped):
// - bf16, float16 and int8 run on the tensor cores
//   (spm_matmul_kernel_wgmma): bf16 and float16 accumulate in float32;
//   int8 accumulates in a wrapping 32-bit integer (wgmma .s32.s8.s8
//   without .satfinite);
// - float32, int32, int16 and uint8 run on the CUDA cores
//   (spm_matmul_kernel, the tile routine
//   of spm_tiles.cuh, which the het-MIMD composite's matmul runs too:
//   here 128 x 64 tiles, 8 x 8 outputs a thread fed by float4 reads, the
//   block's two halves splitting K, K slabs of 16 through a three-stage
//   cp.async ring), one FMA per term: float32 on the tensor cores would
//   be TF32, which the checks refuse. Integer operands are converted to
//   float32 as they are loaded (int32 rounded to nearest even), so the
//   sum is the reference's float32 accumulation of them.
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

constexpr int F32 = spm::kMmF32, BF16 = spm::kMmBF16, I8 = spm::kMmI8, I32 = spm::kMmI32,
              F16 = spm::kMmF16, I16 = spm::kMmI16, U8 = spm::kMmU8;

// ---- float32 on the CUDA cores ---------------------------------------------

// 128 x 64 tiles (512 at 2048^2), K slabs of 16
constexpr int kF32Rows = 128, kF32Slab = 16;

template <typename Tin>
__global__ void __launch_bounds__(spm::kThreads, 2)
spm_matmul_kernel(const Tin* a, const Tin* b, void* c, int64_t M, int64_t N, int64_t K,
                  int out) {
  extern __shared__ __align__(16) unsigned char smem[];
  spm::matmul_tile<kF32Rows, kF32Slab, Tin>(a, b, c, M, N, K, blockIdx.x, smem, out);
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

// d += A (64 x 16, K-major) @ B (16 x 128, N-major: the transpose bit),
// bf16 or (F16) float16 operands
template <bool F16>
__device__ __forceinline__ void wgmma_16(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " D64
        ", %64, %65, p, 1, 1, 0, 1;\n}"
        : ACC64(F_)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64
        ", %64, %65, p, 1, 1, 0, 1;\n}"
        : ACC64(F_)
        : "l"(da), "l"(db), "r"(1));
  }
}
// d += A (64 x 32) @ B (32 x 128), both K-major; the s32 sum wraps
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " D64 ", %64, %65, p;\n}"
      : ACC64(R_)
      : "l"(da), "l"(db), "r"(1));
}

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

// KIND I8: int8 operands, B K-major; BF16 / F16: B N-major. `out` is the
// output's type code.
template <int KIND>
__global__ void __launch_bounds__(kTcThreads, 1)
spm_matmul_kernel_wgmma(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b, void* __restrict__ c,
                        int M, int N, int n_k, int out) {
  constexpr bool INT8 = KIND == I8;
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
        wgmma_16<KIND == F16>(d, da, sw128_desc(b + 2048 * kk, kStageBytes / 2, 1024));
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
  // the kernels' own output types store neighbours as one aligned piece
  const bool pair = N % 2 == 0 && (INT8 ? out == I32 : out == F32 || out == BF16);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const int64_t i = (int64_t)row * N + col;
      const Acc x = d[4 * j + 2 * h], y = d[4 * j + 2 * h + 1];
      if (pair) {
        if constexpr (INT8)
          store2(static_cast<int32_t*>(c) + i, x, y);
        else if (out == F32)
          store2(static_cast<float*>(c) + i, x, y);
        else
          store2(static_cast<__nv_bfloat16*>(c) + i, x, y);
      } else {
        spm::store_out(c, out, i, x);
        if (col + 1 < N) spm::store_out(c, out, i + 1, y);
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

// a row-major [outer, inner] matrix of int8 (kind I8), bf16 or float16
// elements, boxes of [box_outer][box_inner] with box_inner * size = 128
// bytes
bool make_map(CUtensorMap* map, const void* ptr, int kind, int64_t inner, int64_t outer,
              uint32_t box_inner, uint32_t box_outer) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const bool bytes = kind == I8;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * (bytes ? 1 : 2)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type = bytes           ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : kind == F16   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 2,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KIND>
int launch_tc(const CUtensorMap& ma, const CUtensorMap& mb, void* c, int64_t M, int64_t N,
              int64_t Kp, int out, cudaStream_t stream) {
  auto kern = spm_matmul_kernel_wgmma<KIND>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t ke = KIND == I8 ? 128 : 64;
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  kern<<<grid, kTcThreads, kTcSmem, stream>>>(ma, mb, c, (int)M, (int)N,
                                              (int)((Kp + ke - 1) / ke), out);
  return (int)cudaGetLastError();
}

template <typename Tin>
int launch_f32(const void* a, const void* b, void* c, int64_t M, int64_t N, int64_t K, int out,
               cudaStream_t stream) {
  constexpr size_t smem = spm::MmTile<kF32Rows, kF32Slab>::kSmemBytes;
  const int rc = spm::allow_smem(spm_matmul_kernel<Tin>, smem);
  if (rc != 0) return rc;
  spm_matmul_kernel<Tin><<<(unsigned)spm::matmul_tiles<kF32Rows>(M, N), spm::kThreads, smem,
                           stream>>>((const Tin*)a, (const Tin*)b, c, M, N, K, out);
  return (int)cudaGetLastError();
}

}  // namespace

// c = a @ b on the CUDA cores: in_dtype F32, I32, I16 or U8 (converted to
// float32 as loaded), out_dtype any code; a [M, K], b [K, N], c [M, N],
// row-major. Returns cudaGetLastError() after the launch (0 on success);
// launches nothing when M or N is 0.
extern "C" int spm_matmul_launch(int in_dtype, int out_dtype, const void* a, const void* b,
                                 void* c, int64_t M, int64_t N, int64_t K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (out_dtype < F32 || out_dtype > U8) return (int)cudaErrorInvalidValue;
  const int64_t tiles = spm::matmul_tiles<kF32Rows>(M, N);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (in_dtype) {
    case F32: return launch_f32<float>(a, b, c, M, N, K, out_dtype, s);
    case I32: return launch_f32<int32_t>(a, b, c, M, N, K, out_dtype, s);
    case I16: return launch_f32<int16_t>(a, b, c, M, N, K, out_dtype, s);
    case U8: return launch_f32<uint8_t>(a, b, c, M, N, K, out_dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

// c [M, N] = a @ b on the tensor cores, in_dtype BF16, F16 or I8, out_dtype
// any code. a is [M, Kp] row-major; b is [Kp, Nb] for bf16 / float16
// (Nb >= N, Nb % 8 == 0) and [N, Kp] for int8 (K-major); Kp keeps rows
// whole 16-byte multiples (Kp % 8 for 16-bit types, Kp % 16 for int8),
// the pointers are 16-byte aligned and padded entries are zeros. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what it does not take (including a tensor map
// the driver refuses); launches nothing when M or N is 0.
extern "C" int spm_matmul_tc_launch(int in_dtype, int out_dtype, const void* a, const void* b,
                                    void* c, int64_t M, int64_t N, int64_t Kp, int64_t Nb,
                                    void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const bool int8 = in_dtype == I8;
  if ((!int8 && in_dtype != BF16 && in_dtype != F16) || out_dtype < F32 || out_dtype > U8)
    return (int)cudaErrorInvalidValue;
  if (Kp <= 0 || Kp % (int8 ? 16 : 8) != 0 || M > INT32_MAX || N > INT32_MAX ||
      Kp > INT32_MAX || (!int8 && (Nb < N || Nb % 8 != 0)) ||
      ((uintptr_t)a | (uintptr_t)b) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const bool ok = int8 ? make_map(&ma, a, I8, Kp, M, 128, BM) &&
                             make_map(&mb, b, I8, Kp, N, 128, BN)
                       : make_map(&ma, a, in_dtype, Kp, M, 64, BM) &&
                             make_map(&mb, b, in_dtype, Nb, Kp, 64, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (int8) return launch_tc<I8>(ma, mb, c, M, N, Kp, out_dtype, s);
  if (in_dtype == F16) return launch_tc<F16>(ma, mb, c, M, N, Kp, out_dtype, s);
  return launch_tc<BF16>(ma, mb, c, M, N, Kp, out_dtype, s);
}
