// Fused element-wise KVI slot programs: one launch runs one planned
// FusedRegion (at most 64 ops over at most 24 input windows) for all N
// program instances of a batch.
//
// Replaces the TPU kernel repro/kvi/pallas_backend.py::_fused_kernel
// (built per region by _make_fused_caller, one pl.pallas_call over an
// (N, n / block) grid per region).
//
// What bounds it on an H100: bytes. Every element of every input window
// is read once and every element of every output window written once;
// the ops in between are a few integer instructions each. At the main
// path's shapes (N = 1024 instances, windows of 32 to 128 int32 lanes)
// a launch moves a few hundred KB, so the launch overhead dominates, and
// the design aims at one launch per region rather than at bandwidth.
//
// Design: one interpreter kernel, templated on the element type and
// compiled once, serves every region structure. The region's slot
// program arrives as a small int64 device tensor (built once per
// structure and cached by the caller) and is staged in shared memory;
// the window column offsets arrive by value as kernel parameters. A 1-D
// grid strides over the N * n elements; each thread gathers its element
// of every input window into a per-thread slot array (<= 88 slots: 24
// inputs + 64 op results), runs the op list, and stores its element of
// every output window. Reads of a thread all precede its writes, and the
// caller routes a region whose output window overlaps an input window at
// another offset through scratch (the only case where one thread's
// write could reach another thread's read).
//
// Arithmetic: the MFU semantics of kvi_ops.cuh, shared with kdotp.cu and
// kvi_walk.cu.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "kvi_ops.cuh"

namespace {

struct Windows {
  int64_t in_col[kMaxIn];
  int64_t out_col[kMaxOut];
};

template <typename T>
__global__ void fused_vops_kernel(const int64_t* __restrict__ rec, int n_ops, int n_in,
                                  int n_out, const T* src, int64_t src_stride, T* dst,
                                  int64_t dst_stride, Windows win, int64_t rows,
                                  int64_t n) {
  // rec: [word, imm] per op, then the input slots, then the output slots;
  // word = op | dst << 8 | src1 << 16 | src2 << 24 (src2 = 255: none)
  __shared__ int64_t prog[2 * kMaxOps + kMaxIn + kMaxOut];
  const int len = 2 * n_ops + n_in + n_out;
  for (int i = threadIdx.x; i < len; i += blockDim.x) prog[i] = rec[i];
  __syncthreads();
  const int64_t* in_slot = prog + 2 * n_ops;
  const int64_t* out_slot = in_slot + n_in;

  const int64_t total = rows * n;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += step) {
    const int64_t row = idx / n, e = idx - row * n;
    T slot[kMaxSlots];
    const T* s = src + row * src_stride + e;
    for (int k = 0; k < n_in; ++k) slot[in_slot[k]] = s[win.in_col[k]];
    run_slot_ops<T>(slot, prog, n_ops);
    T* o = dst + row * dst_stride + e;
    for (int k = 0; k < n_out; ++k) o[win.out_col[k]] = slot[out_slot[k]];
  }
}

template <typename T>
int launch(const int64_t* rec, int n_ops, int n_in, int n_out, const void* src,
           int64_t src_stride, void* dst, int64_t dst_stride, const Windows& win,
           int64_t rows, int64_t n, int threads, cudaStream_t stream) {
  const int64_t total = rows * n;
  const int64_t max_blocks = 132 * 32;              // 32 blocks per SM in flight
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  fused_vops_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      rec, n_ops, n_in, n_out, (const T*)src, src_stride, (T*)dst, dst_stride, win, rows, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Runs the slot program `rec` (device pointer) over rows x n elements:
// input window k of row r starts at src + r * src_stride + in_col[k],
// output window k at dst + r * dst_stride + out_col[k]. in_col / out_col
// are host arrays of n_in / n_out offsets (passed to the kernel by
// value). dtype: 0 int8, 1 int16, 2 int32, 3 uint8. Returns cudaGetLastError()
// after the launch (0 on success); launches nothing when rows * n == 0.
extern "C" int fused_vops_launch(int dtype, const int64_t* rec, int n_ops, int n_in,
                                 int n_out, const void* src, int64_t src_stride, void* dst,
                                 int64_t dst_stride, const int64_t* in_col,
                                 const int64_t* out_col, int64_t rows, int64_t n,
                                 int threads, void* stream) {
  if (n_ops < 1 || n_ops > kMaxOps || n_in < 1 || n_in > kMaxIn || n_out < 1 ||
      n_out > kMaxOut || threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows * n <= 0) return 0;
  Windows win;
  memset(&win, 0, sizeof(win));
  memcpy(win.in_col, in_col, sizeof(int64_t) * n_in);
  memcpy(win.out_col, out_col, sizeof(int64_t) * n_out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<int8_t>(rec, n_ops, n_in, n_out, src, src_stride, dst, dst_stride, win, rows, n, threads, s);
    case 1: return launch<int16_t>(rec, n_ops, n_in, n_out, src, src_stride, dst, dst_stride, win, rows, n, threads, s);
    case 2: return launch<int32_t>(rec, n_ops, n_in, n_out, src, src_stride, dst, dst_stride, win, rows, n, threads, s);
    case 3: return launch<uint8_t>(rec, n_ops, n_in, n_out, src, src_stride, dst, dst_stride, win, rows, n, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
