// Batched row reductions: sum or dot product of each row, with a flush
// step (shift, scalar add or scalar multiply).
//
// Replaces the TPU kernel repro/kernels/kdotp.py::_reduce_kernel (the
// Pallas kernel behind kdotp / kdotpps / kvred, which the reference's
// PallasBackend._make_reducer vmaps over a batch of N program instances
// and also uses for ksvaddrf / ksvmulrf).
//
// What bounds it on an H100: bytes. Each row is read once (one or two
// operands of n elements) and one element is written, two operations per
// element pair. At the main path's shapes (N = 128 rows of n = 64 int32
// for the streamed 64x64 matmul) one launch moves about 66 KB, so the
// launch itself (a few microseconds) costs far more than the 20 ns that
// the bytes take at 3.35 TB/s.
//
// Design: one block per row (grid-stride over rows beyond the grid),
// threads stride over the row so neighbouring threads load neighbouring
// elements, a warp-shuffle tree, then one pass over the warp partials in
// shared memory by thread 0. No atomics, so integer results are exact
// and the float summation order is the same in every run. Integers
// accumulate in uint64_t, which is bit-identical to numpy's int64 sum in
// the oracle (repro/core/mfu.py); the flush then either shifts the
// 64-bit sum (oracle mode, what the KVI backend uses) or wraps to int32
// first and shifts after (the reference Pallas kernel's order, used by
// the public kdotp / kdotpps / kvred). Shift counts at or above the
// width are clamped on purpose: C++ leaves them undefined, the reference
// fills with the sign bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kvi_ops.cuh"

namespace {

enum Dtype { I8 = 0, I16 = 1, I32 = 2, F32 = 3 };
constexpr int kMaxThreads = 1024;

template <typename T> struct AccOf { using type = uint64_t; };
template <> struct AccOf<float> { using type = float; };

template <typename Tin, typename Tout>
__global__ void reduce_rows_kernel(const Tin* a, const Tin* b, int64_t a_stride,
                                   int64_t b_stride, Tout* out, int64_t out_stride,
                                   int64_t rows, int64_t n, int post, int64_t scalar,
                                   int mode) {
  using Acc = typename AccOf<Tin>::type;
  __shared__ Acc partial[kMaxThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const Tin* ar = a + row * a_stride;
    Acc acc = 0;
    if (b != nullptr) {
      const Tin* br = b + row * b_stride;
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) acc += widen(ar[i]) * widen(br[i]);
    } else {
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) acc += widen(ar[i]);
    }
    acc = warp_sum(acc);
    if (lane == 0) partial[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      Acc total = 0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += partial[w];
      out[row * out_stride] = flush<Tout>(total, post, scalar, mode);
    }
    __syncthreads();        // partial[] is reused by the next row
  }
}

template <typename Tin, typename Tout>
int launch(const void* a, const void* b, int64_t a_stride, int64_t b_stride, void* out,
           int64_t out_stride, int64_t rows, int64_t n, int post, int64_t scalar,
           int mode, int threads, cudaStream_t stream) {
  const int64_t grid = rows < (int64_t(1) << 20) ? rows : (int64_t(1) << 20);
  reduce_rows_kernel<Tin, Tout><<<(unsigned)grid, threads, 0, stream>>>(
      (const Tin*)a, (const Tin*)b, a_stride, b_stride, (Tout*)out, out_stride, rows, n,
      post, scalar, mode);
  return (int)cudaGetLastError();
}

template <typename Tin>
int launch_int(int out_dtype, const void* a, const void* b, int64_t a_stride,
               int64_t b_stride, void* out, int64_t out_stride, int64_t rows, int64_t n,
               int post, int64_t scalar, int mode, int threads, cudaStream_t stream) {
  switch (out_dtype) {
    case I8: return launch<Tin, int8_t>(a, b, a_stride, b_stride, out, out_stride, rows, n, post, scalar, mode, threads, stream);
    case I16: return launch<Tin, int16_t>(a, b, a_stride, b_stride, out, out_stride, rows, n, post, scalar, mode, threads, stream);
    case I32: return launch<Tin, int32_t>(a, b, a_stride, b_stride, out, out_stride, rows, n, post, scalar, mode, threads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out[r * out_stride] = flush(sum_i a[r * a_stride + i] (* b[r * b_stride + i]))
// for r < rows. b may be null (kvred). Returns cudaGetLastError() after
// the launch (0 on success); launches nothing when rows == 0.
extern "C" int kdotp_rows(int in_dtype, int out_dtype, const void* a, const void* b,
                          int64_t a_stride, int64_t b_stride, void* out,
                          int64_t out_stride, int64_t rows, int64_t n, int post,
                          int64_t scalar, int mode, int threads, void* stream) {
  if (rows <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (in_dtype) {
    case I8: return launch_int<int8_t>(out_dtype, a, b, a_stride, b_stride, out, out_stride, rows, n, post, scalar, mode, threads, s);
    case I16: return launch_int<int16_t>(out_dtype, a, b, a_stride, b_stride, out, out_stride, rows, n, post, scalar, mode, threads, s);
    case I32: return launch_int<int32_t>(out_dtype, a, b, a_stride, b_stride, out, out_stride, rows, n, post, scalar, mode, threads, s);
    case F32:
      if (out_dtype != F32) return (int)cudaErrorInvalidValue;
      return launch<float, float>(a, b, a_stride, b_stride, out, out_stride, rows, n, post, scalar, mode, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
