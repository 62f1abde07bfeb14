// Same-size 2-D convolution (correlation) of an [H, W] image with an
// F x F filter, zero padded F / 2 rows and columns on the top and left
// and F - 1 - F / 2 on the bottom and right. int32: products summed
// modulo 2^32, then shifted arithmetically; every other image dtype
// (float32, bf16, float16, int8, int16, uint8) widened to float32,
// summed in float32 with one rounded product and one rounded sum per
// tap, in (fr, fc) order, and cast back (floats to nearest even,
// integers truncated toward zero and saturated, NaN giving 0).
//
// Replaces the TPU kernel repro/kernels/spm_conv2d.py::_conv_kernel (a
// grid over blocks of output rows of a VMEM-resident padded image, the
// F x F taps unrolled as shifted vector multiply-adds).
//
// What bounds it on an H100: bytes for small filters, operations for
// large ones. One image read and one written is 2 x 4 bytes a pixel for
// int32 against 2 F^2 operations: at F = 3 the bytes bound (10 us for
// 2048^2 int32), at F = 11 the 33.5 TOPS INT32 rate (30 us). A float tap
// is a rounded multiply and a rounded add, two FP32 instructions, so at
// large F a float image reaches at most half the FP32 peak the bound
// counts (an FMA would round once and break exact agreement with the
// plain version).
//
// Design:
// - Register blocking. A thread keeps RY output rows x 4 adjacent columns
//   in registers (RY = 8, or 4 where an image at 8 would give the card
//   too few warps). The block walks the input rows of its tile once,
//   j = 0 .. RY + F - 2: each thread loads the 4 + F - 1 words of row j
//   it needs into registers, and for every output row y with fr = j - y in
//   [0, F) runs the fc taps, the filter as broadcast 16-byte loads. Each
//   output still sees fr ascending with fc inner. At F = 11 that is 7.5
//   multiply-adds per shared load over a tile (9 on a row all 8 outputs
//   take), so the multiply-add pipe, not the shared-memory port, sets
//   the pace.
// - No F^2 shared memory. Input row segments (4 tx columns plus the
//   filter's reach) and the filter rows in use stream through two rings:
//   kStages row segments (kAhead in flight while one is read) and
//   kFiltSlots filter rows (>= RY + kAhead; the row of step s lives in
//   slot s mod kFiltSlots for the RY steps that read it). Shared memory
//   is linear in F; F up to about 2700 fits a block.
// - 16-byte streaming. A row segment starts on a 16-byte boundary of the
//   image row: 16-byte cp.async.cg pieces when the row pitch and the base
//   allow (W a multiple of 16 bytes), else 4-byte cp.async (4-byte
//   dtypes) or plain copies (narrower ones). Padding is a zero-fill, never
//   a padded copy. A thread reads its words one by one (a 4-way bank
//   conflict: segments aligned to the thread, read as 16-byte loads,
//   measured no faster at 64 registers). Outputs leave as one 16-, 8- or
//   4-byte store of a thread's 4 columns where W % 4 == 0.
// - Occupancy. The time a step takes is mostly latency (the barrier, the
//   copies' address arithmetic, shared loads), so the kernel is held to
//   64 registers for 4 blocks of 256 threads an SM, and index arithmetic
//   is 32-bit.
// - A persistent grid: as many blocks as fill the card, a whole number of
//   tiles each (no wave tail), each walking its tiles from the largest
//   index down, the ring running on from one tile into the next.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 8;       // output rows a thread keeps: 8, or 4 for small images
constexpr int kAhead = 3;         // input steps in flight
constexpr int kStages = kAhead + 1;
constexpr int kFiltSlots = 16;    // >= kMaxRows + kAhead, a power of two
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;     // blocks of kMaxThreads an SM: <= 64 registers
constexpr size_t kMaxSmem = 232448;
static_assert(kFiltSlots >= kMaxRows + kAhead, "filter ring too short");

enum Dtype { F32 = 0, BF16 = 1, F16 = 2, I32 = 3, I8 = 4, I16 = 5, U8 = 6 };

// the compute type of an image type (the filter's type) and its accumulator
template <typename T> struct Types { using C = float; using Acc = float; };
template <> struct Types<int32_t> { using C = int32_t; using Acc = uint32_t; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ int32_t widen(int32_t v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }
__device__ __forceinline__ float widen(int16_t v) { return (float)v; }
__device__ __forceinline__ float widen(uint8_t v) { return (float)v; }

// one tap: a rounded product and a rounded sum (never contracted), or a
// wrapping integer multiply-add (unsigned: signed overflow is undefined)
__device__ __forceinline__ float mac(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}
__device__ __forceinline__ uint32_t mac(uint32_t acc, int32_t x, int32_t w) {
  return acc + (uint32_t)x * (uint32_t)w;
}

// the accumulator as raw bits of an output value: floats rounded to
// nearest even; int8 / int16 / uint8 truncated toward zero and saturated,
// NaN giving 0 (XLA's convert); int32 wrapped, then shifted
// arithmetically (the count already in [0, 31])
__device__ __forceinline__ int sat(float v, int lo, int hi) {
  if (v != v) return 0;
  return __float2int_rz(fminf(fmaxf(v, (float)lo), (float)hi));
}
template <typename T> struct Out;
template <> struct Out<float> {
  static __device__ __forceinline__ uint32_t bits(float a, int) { return __float_as_uint(a); }
};
template <> struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t bits(float a, int) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(a));
  }
};
template <> struct Out<__half> {
  static __device__ __forceinline__ uint32_t bits(float a, int) {
    return __half_as_ushort(__float2half_rn(a));
  }
};
template <> struct Out<int8_t> {
  static __device__ __forceinline__ uint32_t bits(float a, int) {
    return (uint8_t)sat(a, -128, 127);
  }
};
template <> struct Out<int16_t> {
  static __device__ __forceinline__ uint32_t bits(float a, int) {
    return (uint16_t)sat(a, -32768, 32767);
  }
};
template <> struct Out<uint8_t> {
  static __device__ __forceinline__ uint32_t bits(float a, int) { return sat(a, 0, 255); }
};
template <> struct Out<int32_t> {
  static __device__ __forceinline__ uint32_t bits(uint32_t a, int shift) {
    return (uint32_t)((int32_t)a >> shift);
  }
};

// 4 filter weights (16-byte aligned) in one broadcast load
__device__ __forceinline__ void load4(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}
__device__ __forceinline__ void load4(const int32_t* p, int32_t (&w)[4]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}

// the raw storage of an element of T
template <int B> struct Raw;
template <> struct Raw<1> { using type = uint8_t; };
template <> struct Raw<2> { using type = uint16_t; };
template <> struct Raw<4> { using type = uint32_t; };

template <typename T>
__device__ __forceinline__ void store1(T* p, uint32_t b) {
  using R = typename Raw<sizeof(T)>::type;
  *reinterpret_cast<R*>(p) = (R)b;
}
// 4 adjacent outputs in one store (p aligned to 4 elements)
template <typename T>
__device__ __forceinline__ void store4(T* p, const uint32_t (&b)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(b[0], b[1], b[2], b[3]);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(b[0] | b[1] << 16, b[2] | b[3] << 16);
  } else {
    *reinterpret_cast<uint32_t*>(p) = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

struct Args {
  const void* img;      // [H, W] of the image type
  const void* filt;     // [F, F] of the compute type
  void* out;            // [H, W] of the image type
  int H, W, F, nc;      // nc = ceil(F / 4): filter rows padded to 4 nc words
  int pad, off;         // pad = F / 2; a row segment starts pad + off columns left of
                        // the tile, on a 16-byte boundary of the image row
  int sw, stage_bytes;  // row segment: sw elements, stage_bytes bytes
  int tiles_w, tiles;
  int shift, vec_in, vec_out;
};

// taps fc = 4c .. 4c + n - 1 of one filter row on a thread's 4 columns
// (n = 4 unless FULL is false): x holds the row's words from 4c on
template <bool FULL, typename Acc, typename C>
__device__ __forceinline__ void taps(Acc (&acc)[4], const C* x, const C* wc, int n) {
  C w[4];
  load4(wc, w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (FULL || k < n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = mac(acc[q], x[k + q], w[k]);
    }
  }
}

// chunk c (taps fc = 4c ..) of every output row y in [ylo, yhi], whose
// filter row j - y was staged at step s - y
template <bool FULL, int RY, typename Acc, typename C>
__device__ __forceinline__ void chunk(Acc (&acc)[RY][4], const C* x, const C* fring, int s,
                                      int fp, int c, int ylo, int yhi, int n) {
#pragma unroll
  for (int y = 0; y < RY; ++y)
    if (y >= ylo && y <= yhi)
      taps<FULL>(acc[y], x, fring + ((s - y) & (kFiltSlots - 1)) * fp + 4 * c, n);
}

// NC > 0: ceil(F / 4) fixed at compile time (the row's words all in
// registers); NC == 0: any F, the row's words in a sliding window of 8.
// RY: output rows a thread keeps
template <typename T, int NC, int RY>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
spm_conv2d_kernel(const Args a) {
  using C = typename Types<T>::C;
  using Acc = typename Types<T>::Acc;
  using R = typename Raw<sizeof(T)>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  C* fring = reinterpret_cast<C*>(smem + kStages * a.stage_bytes);

  const int t = threadIdx.x, tx = blockDim.x, F = a.F;
  const int fp = 4 * (NC > 0 ? NC : a.nc);
  const int L = RY + F - 1;                          // steps a tile
  const int ntiles = (a.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int steps = ntiles * L;
  const T* img = reinterpret_cast<const T*>(a.img);
  const C* filt = reinterpret_cast<const C*>(a.filt);

  // ---- producer: row ij of tile ii into the rings -----------------------
  int is = 0, ii = 0, ij = 0;
  int irow0 = 0, icol0 = 0;
  auto fetch = [&]() {
    if (is < steps) {
      if (ij == 0) {
        const int k = a.tiles - 1 - ((int)blockIdx.x + ii * (int)gridDim.x);
        irow0 = (k / a.tiles_w) * RY - a.pad;
        icol0 = (k % a.tiles_w) * 4 * tx - a.pad - a.off;
      }
      const int row = irow0 + ij;
      const bool row_in = (unsigned)row < (unsigned)a.H;
      const T* src = img + (int64_t)(row_in ? row : 0) * a.W;
      unsigned char* st = smem + (is % kStages) * a.stage_bytes;
      if (a.vec_in) {
        constexpr int ve = 16 / sizeof(T);
        for (int m = t; m < a.sw / ve; m += tx) {
          const int c = icol0 + m * ve;
          const bool in = row_in && (unsigned)c < (unsigned)a.W;
          cp_async16(st + m * 16, in ? src + c : img, in);
        }
      } else {
        for (int e = t; e < a.sw; e += tx) {
          const int c = icol0 + e;
          const bool in = row_in && (unsigned)c < (unsigned)a.W;
          if constexpr (sizeof(T) == 4) {
            cp_async4(st + e * 4, in ? src + c : img, in);
          } else {
            reinterpret_cast<R*>(st)[e] = in ? reinterpret_cast<const R*>(src)[c] : R(0);
          }
        }
      }
      if (ij < F) {                                  // filter row ij, zero-padded to fp
        C* fd = fring + (is & (kFiltSlots - 1)) * fp;
        const C* fs = filt + ij * F;
        for (int e = t; e < fp; e += tx) cp_async4(fd + e, e < F ? fs + e : fs, e < F);
      }
      ++is;
      if (++ij == L) {
        ij = 0;
        ++ii;
      }
    }
    cp_async_commit();                               // empty groups keep the count
  };

  Acc acc[RY][4];
#pragma unroll
  for (int y = 0; y < RY; ++y)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[y][q] = Acc(0);

#pragma unroll
  for (int d = 0; d < kAhead; ++d) fetch();

  int ci = 0, j = 0;                                 // the step computed: its tile, its row
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kAhead - 1>();                     // step s has landed ...
    __syncthreads();                                 // ... for every thread, and s - 1 is done
    fetch();                                         // step s + kAhead into s - 1's slots

    const T* st = reinterpret_cast<const T*>(smem + (s % kStages) * a.stage_bytes) + a.off +
                  4 * t;
    const int ylo = max(0, j - F + 1), yhi = min(RY - 1, j);
    if constexpr (NC > 0) {
      C x[4 * NC + 3];
#pragma unroll
      for (int e = 0; e < 4 * NC + 3; ++e) x[e] = widen(st[e]);
#pragma unroll
      for (int c = 0; c < NC - 1; ++c)
        chunk<true, RY>(acc, x + 4 * c, fring, s, fp, c, ylo, yhi, 4);
      chunk<false, RY>(acc, x + 4 * (NC - 1), fring, s, fp, NC - 1, ylo, yhi, F - 4 * (NC - 1));
    } else {
      C x[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = widen(st[e]);
      for (int c = 0; c < a.nc; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 + e] = widen(st[4 * c + 4 + e]);
        if (c < a.nc - 1)
          chunk<true, RY>(acc, x, fring, s, fp, c, ylo, yhi, 4);
        else
          chunk<false, RY>(acc, x, fring, s, fp, c, ylo, yhi, F - 4 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = x[4 + e];
      }
    }

    if (++j == L) {                                  // the tile's outputs are whole
      const int k = a.tiles - 1 - ((int)blockIdx.x + ci * (int)gridDim.x);
      const int r0 = (k / a.tiles_w) * RY, c0 = (k % a.tiles_w) * 4 * tx + 4 * t;
      T* out = reinterpret_cast<T*>(a.out);
#pragma unroll
      for (int y = 0; y < RY; ++y) {
        uint32_t b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          b[q] = Out<T>::bits(acc[y][q], a.shift);
          acc[y][q] = Acc(0);
        }
        if (r0 + y >= a.H || c0 >= a.W) continue;
        T* p = out + (int64_t)(r0 + y) * a.W + c0;
        if (a.vec_out) {
          store4(p, b);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c0 + q < a.W) store1(p + q, b[q]);
        }
      }
      j = 0;
      ++ci;
    }
  }
  cp_async_wait<0>();
}

// blocks of `kern` an SM at (threads, smem), cached
int blocks_per_sm(const void* kern, int threads, size_t smem) {
  struct Entry { const void* kern; int threads; size_t smem; int n; };
  static Entry cache[32];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].kern == kern && cache[i].threads == threads && cache[i].smem == smem)
      return cache[i].n;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads, smem) != cudaSuccess)
    return -1;
  cache[used % 32] = {kern, threads, smem, n};
  if (used < 32) ++used;
  return n;
}

template <typename T, int NC, int RY>
int launch_nc(const Args& a, int tx, int sms, size_t smem, cudaStream_t stream) {
  auto kern = spm_conv2d_kernel<T, NC, RY>;
  static bool opted = false;                         // > 48 KB: opt in once
  if (!opted) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (rc != cudaSuccess) return (int)rc;
    opted = true;
  }
  const int per_sm = blocks_per_sm((const void*)kern, tx, smem);
  if (per_sm < 0) return (int)cudaGetLastError();
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  // a whole number of tiles a block: the fewest rounds the card allows
  const int64_t most = (int64_t)per_sm * sms;
  const int64_t rounds = (a.tiles + most - 1) / most;
  const int64_t grid = (a.tiles + rounds - 1) / rounds;
  kern<<<(unsigned)grid, tx, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int RY>
int launch(Args a, int tx, int sms, cudaStream_t stream) {
  using C = typename Types<T>::C;
  const int ve = 16 / (int)sizeof(T);
  a.nc = (a.F + 3) / 4;
  a.pad = a.F / 2;
  a.off = (a.pad + ve - 1) / ve * ve - a.pad;
  a.sw = (a.off + 4 * tx + 4 * a.nc + ve - 1) / ve * ve;
  a.stage_bytes = a.sw * (int)sizeof(T);
  a.tiles_w = (a.W + 4 * tx - 1) / (4 * tx);
  const int64_t tiles = (int64_t)((a.H + RY - 1) / RY) * a.tiles_w;
  if (tiles > INT32_MAX / 2) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  a.vec_out = a.W % 4 == 0;
  if (a.vec_in && (a.W % ve != 0 || (uintptr_t)a.img % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)kStages * a.stage_bytes + (size_t)kFiltSlots * 4 * a.nc * sizeof(C);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  switch (a.nc) {
    case 1: return launch_nc<T, 1, RY>(a, tx, sms, smem, stream);
    case 2: return launch_nc<T, 2, RY>(a, tx, sms, smem, stream);
    case 3: return launch_nc<T, 3, RY>(a, tx, sms, smem, stream);
    default: return launch_nc<T, 0, RY>(a, tx, sms, smem, stream);
  }
}

template <typename T>
int launch_rows(const Args& a, int rows, int tx, int sms, cudaStream_t stream) {
  switch (rows) {
    case 4: return launch<T, 4>(a, tx, sms, stream);
    case 8: return launch<T, 8>(a, tx, sms, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out = conv(img, filt) (>> shift for int32). filt holds F * F values in
// the compute type: int32 for an I32 image, float32 for every other.
// rows: output rows a thread keeps, 4 or 8; tx: threads a block, a
// multiple of 32 up to 256 (each keeps 4 columns of `rows` output rows);
// vec: 16-byte copies of the image allowed (W * element size a multiple
// of 16 and img 16-byte aligned); sms: the card's SMs. Returns
// cudaGetLastError() after the launch (0 on success); launches nothing
// when H or W is 0.
extern "C" int spm_conv2d_launch(int dtype, const void* img, const void* filt, void* out,
                                 int64_t H, int64_t W, int F, int shift, int rows, int tx,
                                 int vec, int sms, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (F <= 0 || tx < 32 || tx > kMaxThreads || tx % 32 != 0 || sms <= 0 ||
      (unsigned)shift > 31u || H > INT32_MAX / 2 || W > INT32_MAX / 2 ||
      (int64_t)F * F > INT32_MAX / 2)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.img = img, a.filt = filt, a.out = out, a.H = (int)H, a.W = (int)W, a.F = F;
  a.shift = shift, a.vec_in = vec != 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case F32: return launch_rows<float>(a, rows, tx, sms, s);
    case BF16: return launch_rows<__nv_bfloat16>(a, rows, tx, sms, s);
    case F16: return launch_rows<__half>(a, rows, tx, sms, s);
    case I32: return launch_rows<int32_t>(a, rows, tx, sms, s);
    case I8: return launch_rows<int8_t>(a, rows, tx, sms, s);
    case I16: return launch_rows<int16_t>(a, rows, tx, sms, s);
    case U8: return launch_rows<uint8_t>(a, rows, tx, sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
