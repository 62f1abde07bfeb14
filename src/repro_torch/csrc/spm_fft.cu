// Batched radix-2 decimation-in-frequency FFT over the rows of separate
// float32 re / im planes [B, n], n a power of two up to 16384, written
// in natural order through the bit reversal.
//
// Replaces the TPU kernel repro/kernels/spm_fft.py::_fft_kernel (a grid
// over batch tiles, all log2(n) stages on a VMEM-resident block, then a
// static gather through _bitrev).
//
// What bounds it on an H100: bytes. Four planes of B n float32 move
// (16 B n bytes) against 5 n log2(n) float operations a row: at
// n = 256 that is 2.5 operations a byte, far below the ridge.
//
// Design: the TPU's insight carries over, on a smaller scale: each
// block keeps whole rows in shared memory (max(1, 2048 / n) rows, 8 n
// bytes each) across all stages, so a row leaves device memory once and
// comes back once. A barrier separates the stages. Above 6144 points a
// row needs more than the default 48 KB of shared memory, so the
// launcher opts in (up to 128 KB at n = 16384). The twiddle table comes
// from the wrapper, built once per n with the reference's float32
// formula, so the kernel and its plain version use the same twiddles
// (spm_tiles.cuh, fft_tile).

#include "spm_tiles.cuh"

namespace {

__global__ void __launch_bounds__(spm::kThreads)
spm_fft_kernel(const float* re, const float* im, const float* tw, float* ore, float* oim,
               int64_t B, int n, int log2n) {
  extern __shared__ __align__(16) unsigned char smem[];
  spm::fft_tile(re, im, tw, ore, oim, B, n, log2n, blockIdx.x, smem);
}

}  // namespace

// (ore, oim) = FFT(re, im) over B rows of n = 2^log2n points; tw holds
// the 2 (n - 1) twiddles (cos, then sin). Returns cudaGetLastError()
// after the launch (0 on success); launches nothing when B is 0.
extern "C" int spm_fft_launch(const float* re, const float* im, const float* tw, float* ore,
                              float* oim, int64_t B, int log2n, void* stream) {
  if (B <= 0) return 0;
  if (log2n < 0 || log2n > 14) return (int)cudaErrorInvalidValue;
  const int n = 1 << log2n;
  const int64_t tiles = spm::fft_tiles(B, n);
  const size_t smem = spm::fft_smem_bytes(n);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int rc = spm::allow_smem(spm_fft_kernel, smem);
  if (rc != 0) return rc;
  spm_fft_kernel<<<(unsigned)tiles, spm::kThreads, smem, (cudaStream_t)stream>>>(
      re, im, tw, ore, oim, B, n, log2n);
  return (int)cudaGetLastError();
}
