// Batched radix-2 decimation-in-frequency FFT over the rows of separate
// float32 re / im planes [B, n], n a power of two, written in natural
// order through the bit reversal. One launch of spm_fft_kernel for n up
// to 16384; above it, three kinds of launch (below).
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
//
// n = 2^L above 16384 (L - 14 = s): a row no longer fits a block. The
// first s DIF stages (half-sizes n / 2 .. 2^14) run as global-memory
// passes, one radix-2 launch each (spm_fft_stage_kernel: a thread a
// butterfly, the same rounded operations and twiddles). Each block of
// 16384 points is then an independent DIF transform of its own: the
// remaining 14 stages are the 16384-point transform's, twiddles included,
// so spm_fft_kernel runs them on the 2^s B rows of 16384 and writes each
// in its own natural order. Natural order of the whole row: out[a 2^s +
// c] = sub[bitrev_s(c)][a] (bitrev_L(a 2^s + c) = bitrev_s(c) 2^14 +
// bitrev_14(a)), one gather launch (spm_fft_permute_kernel: reads
// coalesced along a, writes at a stride of 2^s). Every butterfly is the
// plain version's, so this route too agrees with it bit for bit. Bytes:
// 16 B n a stage pass, the transform, and the gather: (s + 2) times the
// one-launch route's.

#include "spm_tiles.cuh"

namespace {

__global__ void __launch_bounds__(spm::kThreads, 2)
spm_fft_kernel(const float* re, const float* im, const float* tw, float* ore, float* oim,
               int64_t B, int log2n, unsigned plan, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  spm::fft_tiles_run(re, im, tw, ore, oim, B, log2n, plan, rows, blockIdx.x, gridDim.x, smem);
}

// one DIF stage of half-size h = 2^log2h over B rows of n = 2^log2n
// points, from (re, im) into (ore, oim) (which may be the same planes): a
// thread a butterfly, x[i] and x[i + h] of each group of 2h
__global__ void spm_fft_stage_kernel(const float* re, const float* im, const float* tw,
                                     float* ore, float* oim, int64_t B, int log2n, int log2h) {
  const int64_t half = (int64_t)1 << (log2n - 1), h = (int64_t)1 << log2h;
  const float* wre = tw + (h - 1);
  const float* wim = tw + ((int64_t)1 << log2n) - 1 + (h - 1);
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < B * half;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = t >> (log2n - 1), rem = t & (half - 1);
    const int64_t k = rem & (h - 1);
    const int64_t a = (row << log2n) + ((rem >> log2h) << (log2h + 1)) + k, b = a + h;
    float ar = re[a], ai = im[a], br = re[b], bi = im[b];
    spm::fft_bfly(ar, ai, br, bi, wre[k], wim[k]);
    ore[a] = ar;
    oim[a] = ai;
    ore[b] = br;
    oim[b] = bi;
  }
}

// out[row][a 2^s + c] = sub[row][bitrev_s(c) 2^14 + a] over B rows of n =
// 2^(14 + s) points
__global__ void spm_fft_permute_kernel(const float* __restrict__ sre,
                                       const float* __restrict__ sim, float* __restrict__ ore,
                                       float* __restrict__ oim, int64_t B, int s) {
  constexpr int kSub = 14;
  const int64_t n = (int64_t)1 << (kSub + s);
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < B * n;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = t >> (kSub + s), src = t & (n - 1);
    const int64_t c = src >> kSub, a = src & ((1 << kSub) - 1);
    const int64_t cr = __brev((unsigned)c) >> (32 - s);
    const int64_t dst = (row << (kSub + s)) + (a << s) + cr;
    ore[dst] = sre[t];
    oim[dst] = sim[t];
  }
}

int grid_of(int64_t items) {
  const int64_t blocks = (items + spm::kThreads - 1) / spm::kThreads;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

}  // namespace

// one global DIF stage of half-size 2^log2h over B rows of 2^log2n points
// (log2h < log2n), (re, im) -> (ore, oim), in place allowed; tw as for
// spm_fft_launch. Returns cudaGetLastError() after the launch.
extern "C" int spm_fft_stage_launch(const float* re, const float* im, const float* tw,
                                    float* ore, float* oim, int64_t B, int log2n, int log2h,
                                    void* stream) {
  if (B <= 0) return 0;
  if (log2n < 1 || log2n > 40 || log2h < 0 || log2h >= log2n) return (int)cudaErrorInvalidValue;
  spm_fft_stage_kernel<<<grid_of(B << (log2n - 1)), spm::kThreads, 0, (cudaStream_t)stream>>>(
      re, im, tw, ore, oim, B, log2n, log2h);
  return (int)cudaGetLastError();
}

// the natural-order gather of rows of 2^(14 + s) points whose 2^s blocks
// of 16384 hold their sub-transforms in natural order; 1 <= s <= 16
extern "C" int spm_fft_permute_launch(const float* sre, const float* sim, float* ore,
                                      float* oim, int64_t B, int s, void* stream) {
  if (B <= 0) return 0;
  if (s < 1 || s > 16) return (int)cudaErrorInvalidValue;
  spm_fft_permute_kernel<<<grid_of(B << (14 + s)), spm::kThreads, 0, (cudaStream_t)stream>>>(
      sre, sim, ore, oim, B, s);
  return (int)cudaGetLastError();
}

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
