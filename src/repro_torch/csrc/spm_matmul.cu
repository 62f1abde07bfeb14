// Tiled dense matrix product C[M, N] = A[M, K] @ B[K, N] (row-major):
// float32 and bf16 accumulate in float32 (FMA, no TF32), int8 in a
// wrapping 32-bit integer; the output is float32, bf16 or int32.
//
// Replaces the TPU kernel repro/kernels/spm_matmul.py::_matmul_kernel
// (a (M/bm, N/bn, K/bk) grid that carries a VMEM accumulator across the
// sequential K steps and feeds the 128 x 128 MXU).
//
// What bounds it on an H100: operations. At 4096^3 the product does
// 2 * 4096^3 = 137 G operations on 100 MB of operands, far above the
// card's ridge for every type. The bound is the tensor cores' rate
// (989 TFLOP/s bf16, 1979 TOPS int8), or 67 TFLOP/s for float32 held to
// plain FP32 arithmetic.
//
// Design: the simple, right first version. Blocks run in parallel, so
// the TPU's sequential K grid becomes a loop inside each block over
// 16-deep slabs staged in shared memory, and each thread keeps a 4 x 4
// register block of one 64 x 64 output tile (spm_tiles.cuh,
// matmul_tile). It runs on the CUDA cores, not the tensor cores: wgmma,
// TMA and mma.sync are later work, so bf16 and int8 land one to two
// orders of magnitude under their bound (PERF.md).

#include "spm_tiles.cuh"

namespace {

enum Dtype { F32 = 0, BF16 = 1, I8 = 2, I32 = 3 };

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(spm::kThreads)
spm_matmul_kernel(const Tin* a, const Tin* b, Tout* c, int64_t M, int64_t N, int64_t K) {
  extern __shared__ __align__(16) unsigned char smem[];
  spm::matmul_tile<Tin, Tout>(a, b, c, M, N, K, blockIdx.x, smem);
}

template <typename Tin, typename Tout>
int launch(const void* a, const void* b, void* c, int64_t M, int64_t N, int64_t K,
           cudaStream_t stream) {
  const int64_t tiles = spm::matmul_tiles(M, N);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  spm_matmul_kernel<Tin, Tout><<<(unsigned)tiles, spm::kThreads, spm::kMatmulSmemBytes,
                                  stream>>>((const Tin*)a, (const Tin*)b, (Tout*)c, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// c = a @ b for in/out dtype codes (F32, F32), (F32, BF16), (BF16, BF16),
// (BF16, F32), (I8, I32). Returns cudaGetLastError() after the launch
// (0 on success); launches nothing when M or N is 0.
extern "C" int spm_matmul_launch(int in_dtype, int out_dtype, const void* a, const void* b,
                                 void* c, int64_t M, int64_t N, int64_t K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == F32 && out_dtype == F32) return launch<float, float>(a, b, c, M, N, K, s);
  if (in_dtype == F32 && out_dtype == BF16)
    return launch<float, __nv_bfloat16>(a, b, c, M, N, K, s);
  if (in_dtype == BF16 && out_dtype == BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, M, N, K, s);
  if (in_dtype == BF16 && out_dtype == F32)
    return launch<__nv_bfloat16, float>(a, b, c, M, N, K, s);
  if (in_dtype == I8 && out_dtype == I32) return launch<int8_t, int32_t>(a, b, c, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}
