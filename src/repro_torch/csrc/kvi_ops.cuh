// The MFU semantics of the KVI kernels, defined once: element-wise slot
// ops (fused_vops.cu, kvi_walk.cu) and the reductions' widening, block
// sum and flush (kdotp.cu, kvi_walk.cu).
//
// Arithmetic wraps like the paper's MFU datapath (repro/core/mfu.py):
// add, sub and mul run in unsigned types (signed overflow is undefined
// in C++) and truncate to the element width; immediates are int64,
// wrapped into add and mul and compared exactly by ksvslt; a shift count
// at or above the element width gives the sign fill (ksrav) or 0
// (ksrlv), where C++ would leave it undefined. Reductions accumulate
// integers in uint64_t, bit-identical to numpy's int64 sum in the oracle.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// opcodes: the order of repro_torch/kernels/fused_vops.py::OPCODES
enum Op { KADDV = 0, KSUBV, KVMUL, KSVADDSC, KSVMULSC, KSRLV, KSRAV, KRELU, KVSLT,
          KSVSLT, KVCP };

// slot-program limits: repro_torch/kernels/fused_vops.py::MAX_*
constexpr int kMaxOps = 64, kMaxIn = 24, kMaxOut = 64, kMaxSlots = kMaxIn + kMaxOps;
constexpr int kNoSlot = 255;

enum Post { POST_NONE = 0, POST_SHIFT = 1, POST_ADD = 2, POST_MUL = 3 };
enum Mode { MODE_ORACLE = 0, MODE_WRAP32 = 1 };

template <typename T> struct Unsigned;
template <> struct Unsigned<int8_t> { using type = uint8_t; };
template <> struct Unsigned<int16_t> { using type = uint16_t; };
template <> struct Unsigned<int32_t> { using type = uint32_t; };

template <typename T>
__device__ __forceinline__ T apply_op(int op, T a, T b, int64_t imm) {
  using U = typename Unsigned<T>::type;
  constexpr uint64_t kBits = 8 * sizeof(T);
  switch (op) {
    case KADDV: return (T)(U)((uint32_t)a + (uint32_t)b);
    case KSUBV: return (T)(U)((uint32_t)a - (uint32_t)b);
    case KVMUL: return (T)(U)((uint32_t)a * (uint32_t)b);
    case KSVADDSC: return (T)(U)((uint64_t)(int64_t)a + (uint64_t)imm);
    case KSVMULSC: return (T)(U)((uint64_t)(int64_t)a * (uint64_t)imm);
    case KSRLV: return (uint64_t)imm >= kBits ? T(0) : (T)(U)((U)a >> (int)imm);
    case KSRAV: return (T)(a >> ((uint64_t)imm >= kBits ? (int)kBits - 1 : (int)imm));
    case KRELU: return a > T(0) ? a : T(0);
    case KVSLT: return a < b ? T(1) : T(0);
    case KSVSLT: return (int64_t)a < imm ? T(1) : T(0);
    default: return a;                              // KVCP
  }
}

// one slot op word: op | dst << 8 | src1 << 16 | src2 << 24 (src2 255: none)
template <typename T>
__device__ __forceinline__ void run_slot_ops(T* slot, const int64_t* prog, int n_ops) {
  for (int i = 0; i < n_ops; ++i) {
    const int64_t w = prog[2 * i];
    const int op = (int)(w & 0xff), d = (int)((w >> 8) & 0xff);
    const int s1 = (int)((w >> 16) & 0xff), s2 = (int)((w >> 24) & 0xff);
    slot[d] = apply_op<T>(op, slot[s1], s2 == kNoSlot ? T(0) : slot[s2], prog[2 * i + 1]);
  }
}

__device__ __forceinline__ uint64_t widen(int8_t v) { return (uint64_t)(int64_t)v; }
__device__ __forceinline__ uint64_t widen(int16_t v) { return (uint64_t)(int64_t)v; }
__device__ __forceinline__ uint64_t widen(int32_t v) { return (uint64_t)(int64_t)v; }
__device__ __forceinline__ float widen(float v) { return v; }

template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// integer flush: the 64-bit modular sum -> the destination element
template <typename Tout>
__device__ __forceinline__ Tout flush(uint64_t acc, int post, int64_t scalar, int mode) {
  int64_t r;
  if (mode == MODE_WRAP32) {
    int32_t w = (int32_t)(uint32_t)acc;
    if (post == POST_SHIFT) w >>= ((uint64_t)scalar >= 32 ? 31 : (int)scalar);
    r = w;
  } else if (post == POST_SHIFT) {
    r = (int64_t)acc >> ((uint64_t)scalar >= 64 ? 63 : (int)scalar);
  } else if (post == POST_ADD) {
    r = (int64_t)(acc + (uint64_t)scalar);
  } else if (post == POST_MUL) {
    r = (int64_t)(acc * (uint64_t)scalar);
  } else {
    r = (int64_t)acc;
  }
  return (Tout)r;           // two's-complement wrap to the element width
}

// float flush: a shift divides by 2^shift
template <typename Tout>
__device__ __forceinline__ Tout flush(float acc, int post, int64_t scalar, int) {
  return post == POST_SHIFT ? acc / ldexpf(1.0f, (int)scalar) : acc;
}

}  // namespace
