// The heterogeneous-MIMD composite in ONE launch: a float32 matmul, a
// valid F x F correlation of a pre-padded image (float32 out, no shift)
// and a batched FFT (as spm_fft.cu).
//
// Replaces the TPU kernel repro/kernels/het_mimd.py::_composite_kernel
// (a grid of 3 whose program id, the "hart", switches between the three
// tile programs, each on its own VMEM blocks).
//
// What bounds it on an H100: the sum of its three parts' work. At the
// card-scale composite (1026^2 image, 1024 x 256 FFT, 1024^3 matmul) the
// matmul's 2.1 G float32 operations are 99 % of the bound (32 us at
// 67 TFLOP/s); the conv and the FFT are byte-bound and small beside it.
// So the matmul hart sets the time twice over: by its FMA rate, and by
// its blocks being the longest.
//
// Design: one grid split into three blockIdx ranges, matmul tiles | conv
// tiles | FFT row groups; the range is the hart and selects the tile
// routine of spm_tiles.cuh. The longest blocks come first, so the card
// dispatches them in the first wave and the short conv and FFT blocks
// fill the SMs behind them. The matmul hart runs the register-blocked
// float32 tile of spm_matmul at 64 x 64 (4 x 8 outputs a thread, K slabs
// of 32 through a three-stage cp.async ring): 256 tiles at 1024^2, two
// on nearly every SM. With 128 x 64 tiles, one for each of 128 SMs, the
// card put two matmul tiles on some SMs and none on others when conv and
// FFT blocks followed in the grid, and those SMs set the time (a
// per-block trace on the card). The FFT hart runs spm_fft's register
// passes, one tile of rows a block. All harts share one block size, one
// register count (the largest branch's, held to 128 a thread so that two
// blocks fit an SM) and one dynamic shared-memory size (the largest any
// branch needs), so the card schedules blocks of the three programs side
// by side on its SMs: the het-MIMD scheme's shared engine with dedicated
// scratchpads.

#include "spm_tiles.cuh"

namespace {

// 64 x 64 matmul tiles (256 at 1024^2: two an SM), K slabs of 32
constexpr int kMmRows = 64, kMmSlab = 32;

struct Mm { const float* a; const float* b; float* c; int64_t M, K, N; };
struct Conv { const float* img; const float* filt; float* out; int64_t H, W; int F; };
struct Fft { const float* re; const float* im; const float* tw; float* ore; float* oim;
             int64_t B; int log2n; unsigned plan; int rows; };

__global__ void __launch_bounds__(spm::kThreads, 2)
het_mimd_kernel(Mm mm, Conv cv, Fft ft, int64_t mm_tiles, int64_t conv_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t t = blockIdx.x;
  if (t < mm_tiles) {                                     // hart 2: matmul
    spm::matmul_tile<kMmRows, kMmSlab>(mm.a, mm.b, mm.c, mm.M, mm.N, mm.K, t, smem);
  } else if (t < mm_tiles + conv_tiles) {                 // hart 0: conv2d
    spm::conv_tile<float, float>(cv.img, cv.H + cv.F - 1, cv.W + cv.F - 1, cv.filt, cv.F,
                                 cv.out, cv.H, cv.W, 0, 0, 0, t - mm_tiles, smem);
  } else {                                                // hart 1: FFT
    const int64_t tile = t - mm_tiles - conv_tiles;         // one tile a block
    spm::fft_tiles_run(ft.re, ft.im, ft.tw, ft.ore, ft.oim, ft.B, ft.log2n, ft.plan, ft.rows,
                       tile, spm::fft_tiles(ft.B, ft.rows), smem);
  }
}

}  // namespace

// conv [H, W] = valid correlation of img [H + F - 1, W + F - 1] with filt
// [F, F]; (ore, oim) = FFT of fre / fim [nb, 2^log2n] with twiddles tw,
// pass plan `plan` and `rows` rows a block (as spm_fft_launch takes
// them; ore and oim 16-byte aligned); c [M, N] = a [M, K] @ b [K, N].
// All float32, row-major. Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for what it does not take;
// launches nothing when all three parts are empty.
extern "C" int het_mimd_launch(const float* img, const float* filt, int F, float* conv,
                               int64_t H, int64_t W, const float* fre, const float* fim,
                               const float* tw, float* ore, float* oim, int64_t nb, int log2n,
                               unsigned plan, int rows, const float* a, const float* b,
                               float* c, int64_t M, int64_t K, int64_t N, void* stream) {
  if (F <= 0 || !spm::fft_plan_ok(log2n, plan, rows) ||
      ((uintptr_t)ore | (uintptr_t)oim) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t mt = (M > 0 && N > 0) ? spm::matmul_tiles<kMmRows>(M, N) : 0;
  const int64_t ct = (H > 0 && W > 0) ? spm::conv_tiles(H, W) : 0;
  const int64_t ft = nb > 0 ? spm::fft_tiles(nb, rows) : 0;
  const int64_t tiles = mt + ct + ft;
  if (tiles == 0) return 0;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  size_t smem = mt ? spm::MmTile<kMmRows, kMmSlab>::kSmemBytes : 0;
  if (ct && spm::conv_smem_bytes(F) > smem) smem = spm::conv_smem_bytes(F);
  if (ft && spm::fft_smem_bytes(1 << log2n, rows) > smem)
    smem = spm::fft_smem_bytes(1 << log2n, rows);
  const int rc = spm::allow_smem(het_mimd_kernel, smem);
  if (rc != 0) return rc;
  het_mimd_kernel<<<(unsigned)tiles, spm::kThreads, smem, (cudaStream_t)stream>>>(
      Mm{a, b, c, M, K, N}, Conv{img, filt, conv, H, W, F},
      Fft{fre, fim, tw, ore, oim, nb, log2n, plan, rows}, mt, ct);
  return (int)cudaGetLastError();
}
