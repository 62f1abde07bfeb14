// The heterogeneous-MIMD composite in ONE launch: a valid F x F
// correlation of a pre-padded image (float32 out, no shift), a batched
// FFT (as spm_fft.cu) and a float32-accumulated matmul (float32 out).
//
// Replaces the TPU kernel repro/kernels/het_mimd.py::_composite_kernel
// (a grid of 3 whose program id, the "hart", switches between the three
// tile programs, each on its own VMEM blocks).
//
// What bounds it on an H100: the sum of its three parts' work. At the
// card-scale composite (1026^2 image, 1024 x 256 FFT, 1024^3 matmul) the
// matmul's 2.1 G float32 operations dominate (32 us at 67 TFLOP/s); the
// conv and the FFT are byte-bound and small beside it.
//
// Design: one grid split into three blockIdx ranges, conv tiles | FFT
// row groups | matmul tiles; the range is the hart and selects the tile
// routine of spm_tiles.cuh. All harts share one block size and one
// dynamic shared-memory size, the largest any branch needs, so the card
// schedules blocks of the three programs side by side on its SMs, the
// het-MIMD scheme's shared engine with dedicated scratchpads.

#include "spm_tiles.cuh"

namespace {

struct Conv { const float* img; const float* filt; float* out; int64_t H, W; int F; };
struct Fft { const float* re; const float* im; const float* tw; float* ore; float* oim;
             int64_t B; int n, log2n; };
struct Mm { const float* a; const float* b; float* c; int64_t M, K, N; };

__global__ void __launch_bounds__(spm::kThreads)
het_mimd_kernel(Conv cv, Fft ft, Mm mm, int64_t conv_tiles, int64_t fft_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t t = blockIdx.x;
  if (t < conv_tiles) {                                   // hart 0: conv2d
    spm::conv_tile<float, float>(cv.img, cv.H + cv.F - 1, cv.W + cv.F - 1, cv.filt, cv.F,
                                 cv.out, cv.H, cv.W, 0, 0, 0, t, smem);
  } else if (t < conv_tiles + fft_tiles) {                // hart 1: FFT
    spm::fft_tile(ft.re, ft.im, ft.tw, ft.ore, ft.oim, ft.B, ft.n, ft.log2n,
                  t - conv_tiles, smem);
  } else {                                                // hart 2: matmul
    spm::matmul_tile<float, float>(mm.a, mm.b, mm.c, mm.M, mm.N, mm.K,
                                   t - conv_tiles - fft_tiles, smem);
  }
}

}  // namespace

// conv [H, W] = valid correlation of img [H + F - 1, W + F - 1] with filt
// [F, F]; (ore, oim) = FFT of fre / fim [nb, 2^log2n] with twiddles tw;
// c [M, N] = a [M, K] @ b [K, N]. All float32, row-major. Returns
// cudaGetLastError() after the launch (0 on success); launches nothing
// when all three parts are empty.
extern "C" int het_mimd_launch(const float* img, const float* filt, int F, float* conv,
                               int64_t H, int64_t W, const float* fre, const float* fim,
                               const float* tw, float* ore, float* oim, int64_t nb, int log2n,
                               const float* a, const float* b, float* c, int64_t M, int64_t K,
                               int64_t N, void* stream) {
  if (F <= 0 || log2n < 0 || log2n > 14) return (int)cudaErrorInvalidValue;
  const int n = 1 << log2n;
  const int64_t ct = (H > 0 && W > 0) ? spm::conv_tiles(H, W) : 0;
  const int64_t ft = nb > 0 ? spm::fft_tiles(nb, n) : 0;
  const int64_t mt = (M > 0 && N > 0) ? spm::matmul_tiles(M, N) : 0;
  const int64_t tiles = ct + ft + mt;
  if (tiles == 0) return 0;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  size_t smem = spm::kMatmulSmemBytes;
  if (ct && spm::conv_smem_bytes(F) > smem) smem = spm::conv_smem_bytes(F);
  if (ft && spm::fft_smem_bytes(n) > smem) smem = spm::fft_smem_bytes(n);
  const int rc = spm::allow_smem(het_mimd_kernel, smem);
  if (rc != 0) return rc;
  het_mimd_kernel<<<(unsigned)tiles, spm::kThreads, smem, (cudaStream_t)stream>>>(
      Conv{img, filt, conv, H, W, F}, Fft{fre, fim, tw, ore, oim, nb, n, log2n},
      Mm{a, b, c, M, K, N}, ct, ft);
  return (int)cudaGetLastError();
}
