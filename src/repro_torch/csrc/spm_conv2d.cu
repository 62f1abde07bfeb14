// Same-size 2-D convolution (correlation) of an [H, W] image with an
// F x F filter, zero padded F / 2 rows and columns on the top and left
// and F - 1 - F / 2 on the bottom and right; int32 exact with a wrapping
// accumulator and an arithmetic post-shift, float32 and bf16 accumulated
// in float32.
//
// Replaces the TPU kernel repro/kernels/spm_conv2d.py::_conv_kernel (a
// grid over blocks of output rows of a VMEM-resident padded image, the
// F x F taps unrolled as shifted vector multiply-adds).
//
// What bounds it on an H100: bytes for small filters, operations for
// large ones. One image read and one written is 8 bytes a pixel against
// 2 F^2 operations: at F = 3 the bytes bound (10 us for 2048^2 int32),
// at F = 11 the 33.5 TOPS INT32 rate (30 us).
//
// Design: each block computes a 32 x 32 output tile from its
// (31 + F)^2 input window staged once in shared memory (padding is an
// index test on load, never a padded copy in device memory), so every
// input word is read from device memory about once; the taps then run
// from shared memory in (fr, fc) order (spm_tiles.cuh, conv_tile).

#include "spm_tiles.cuh"

namespace {

enum Dtype { F32 = 0, BF16 = 1, I32 = 3 };

template <typename T>
__global__ void __launch_bounds__(spm::kThreads)
spm_conv2d_kernel(const T* img, const typename spm::ComputeOf<T>::type* filt, T* out,
                  int64_t H, int64_t W, int F, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  spm::conv_tile<T, T>(img, H, W, filt, F, out, H, W, F / 2, F / 2, shift, blockIdx.x, smem);
}

template <typename T>
int launch(const void* img, const void* filt, void* out, int64_t H, int64_t W, int F,
           int shift, cudaStream_t stream) {
  using C = typename spm::ComputeOf<T>::type;
  const int64_t tiles = spm::conv_tiles(H, W);
  const size_t smem = spm::conv_smem_bytes(F);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int rc = spm::allow_smem(spm_conv2d_kernel<T>, smem);
  if (rc != 0) return rc;
  spm_conv2d_kernel<T><<<(unsigned)tiles, spm::kThreads, smem, stream>>>(
      (const T*)img, (const C*)filt, (T*)out, H, W, F, shift);
  return (int)cudaGetLastError();
}

}  // namespace

// out = conv(img, filt) >> shift (the shift for int32 only). filt holds
// F * F values in the compute type: float32 for F32 / BF16 images,
// int32 for I32. Returns cudaGetLastError() after the launch (0 on
// success); launches nothing when H or W is 0.
extern "C" int spm_conv2d_launch(int dtype, const void* img, const void* filt, void* out,
                                 int64_t H, int64_t W, int F, int shift, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case F32: return launch<float>(img, filt, out, H, W, F, 0, s);
    case BF16: return launch<__nv_bfloat16>(img, filt, out, H, W, F, 0, s);
    case I32: return launch<int32_t>(img, filt, out, H, W, F, shift, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
