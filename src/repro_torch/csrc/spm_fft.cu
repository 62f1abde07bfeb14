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
// n = 1024 that is 3.1 operations a byte, far below the ridge. What held
// the first version back was shared memory, not HBM: one barriered
// shared-memory sweep per stage, and a bit-reversed read whose warps hit
// one bank (32-way at n = 1024).
//
// Design (spm_tiles.cuh, fft_tiles_run): a block holds whole rows in
// shared memory, so a row leaves device memory once and comes back once.
// The stages run in passes of up to 4 on 16 points a thread in
// registers; passes exchange through an XOR-swizzled layout without bank
// conflicts, and the last exchange reads the rows back bit-reversed so
// that each thread writes 4 consecutive outputs as one float4. At
// n = 1024: 3 exchanges where there were 10 barriered stages. The grid is
// persistent: as many blocks as fit the card at once (two an SM, at up to
// 128 registers a thread), each looping over tiles of rows, so a block's
// next loads overlap its neighbours' passes without a block launch per
// tile. The pass plan and the rows of a tile come from the wrapper
// (spm_fft.pass_plan), so the CPU tests hold the plan the kernel runs.
// The twiddle table comes from the wrapper too, built once per n with the
// reference's float32 formula, and every butterfly rounds as the plain
// version does: the two agree bit for bit.

#include "spm_tiles.cuh"

namespace {

__global__ void __launch_bounds__(spm::kThreads, 2)
spm_fft_kernel(const float* re, const float* im, const float* tw, float* ore, float* oim,
               int64_t B, int log2n, unsigned plan, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  spm::fft_tiles_run(re, im, tw, ore, oim, B, log2n, plan, rows, blockIdx.x, gridDim.x, smem);
}

}  // namespace

// (ore, oim) = FFT(re, im) over B rows of n = 2^log2n points; tw holds
// the 2 max(n - 1, 1) twiddles (cos, then sin); `plan` packs the passes
// (spm_tiles.cuh, fft_plan_ok) and `rows` is the rows of a tile; ore and
// oim are 16-byte aligned. Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for what it does not take;
// launches nothing when B is 0.
extern "C" int spm_fft_launch(const float* re, const float* im, const float* tw, float* ore,
                              float* oim, int64_t B, int log2n, unsigned plan, int rows,
                              void* stream) {
  if (B <= 0) return 0;
  if (!spm::fft_plan_ok(log2n, plan, rows) || ((uintptr_t)ore | (uintptr_t)oim) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = spm::fft_smem_bytes(1 << log2n, rows);
  int rc = spm::allow_smem(spm_fft_kernel, smem);
  if (rc != 0) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = (int)cudaGetDevice(&dev)) != 0 ||
      (rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0 ||
      (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spm_fft_kernel,
                                                               spm::kThreads, smem)) != 0)
    return rc;
  const int64_t tiles = spm::fft_tiles(B, rows), resident = (int64_t)sms * per_sm;
  if (resident < 1) return (int)cudaErrorInvalidValue;
  spm_fft_kernel<<<(unsigned)(tiles < resident ? tiles : resident), spm::kThreads, smem,
                   (cudaStream_t)stream>>>(re, im, tw, ore, oim, B, log2n, plan, rows);
  return (int)cudaGetLastError();
}
