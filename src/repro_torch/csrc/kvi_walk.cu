// The KVI walk in one launch: every copy, fused element-wise region and
// reduction of a compiled structure, for all N instances of a batch.
//
// Replaces, on the KVI path, the two TPU kernels the reference launches
// once per walk step: repro/kvi/pallas_backend.py::_fused_kernel (one
// pl.pallas_call per FusedRegion) and repro/kernels/kdotp.py::
// _reduce_kernel (one per kdotp / kdotpps / kvred / ksvaddrf /
// ksvmulrf). fused_vops.cu and kdotp.cu stay for the intrinsics.
//
// What bounds it on an H100: at the main path's sizes, neither bytes nor
// operations. A batch reads each instance's input stack once (1.06 MB an
// instance at the streamed 64x64 matmul) and writes its stores; the
// register file stays on chip. The time is set by one instance's chain of
// steps (8320 at matmul64), each a few shared-memory accesses and one or
// two barriers: latency, not throughput. The per-step design it replaces
// paid one launch (1.6-3.7 us) per step instead.
//
// Design:
// * One block per instance row (grid-stride over rows beyond the grid).
//   Instances never read each other's data, so no step crosses blocks.
// * The SPMs in shared memory: the instance's register files (one per
//   element width, 16-byte aligned) and a staging scratch for hazard
//   regions form an arena that the block zeroes, as the reference starts
//   from zeros. Above the caller's cap the same code addresses a row of a
//   global workspace through the same generic pointer (a layout chosen
//   before the launch from the structure's size).
// * The step table (8 int64 words a step) is staged in shared memory in
//   chunks of 64 steps; every block reads the same table, so it stays in
//   L2.
// * kmemld sources in the input stacks are prefetched with cp.async into a
//   ring of up to 8 shared-memory slots, in table order, ring - 1 loads
//   ahead, so the chain does not wait on device memory at every load. A
//   copy waits for its slot, syncs, sends the next prefetch to the slot
//   the previous copy read, and converts its own slot into the register
//   file.
// * Three step kinds: copy (kmemld / kmemstr / kvcp between input stacks,
//   register files and store stacks, with an integer cast that wraps; an
//   overlapping kvcp moves chunk by chunk in the safe direction), fused
//   (the slot-program interpreter of fused_vops.cu over the region's
//   windows; a region whose output window overlaps an input window at
//   another offset stages its outputs in the scratch, syncs, then writes)
//   and reduce (a uint64_t block sum with warp shuffles, then the oracle's
//   flush into the dst element at the dst's width).
// * Barriers: a __syncthreads() after a step only where the table says the
//   next step may touch what another thread touched since the last sync.
//   Element e of a window is thread e % blockDim's in every step, so a
//   window read or written again at the same column by a lane-parallel
//   step needs no barrier (a kmemld, then the kdotp over its register).
//   Fused steps and prefetched copies open with a sync of their own; the
//   slot programs and the warp partials are double-buffered, so
//   back-to-back steps of one kind need no further barrier.
// * Stores go straight to the store stacks in global memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kvi_ops.cuh"

namespace {

// repro_torch/kernels/kvi_walk.py mirrors every constant here
constexpr int kStepWords = 8, kChunk = 64, kMaxBuf = 16, kMaxRing = 8;
constexpr int kProgWords = 2 * kMaxOps + 2 * kMaxIn + 2 * kMaxOut;
constexpr int kMaxThreads = 256;
constexpr int64_t kMaxSmem = 232448;
enum Kind { COPY = 0, FUSED = 1, REDUCE = 2 };
constexpr int64_t F_BARRIER = 1 << 8, F_OVERLAP = 1 << 9, F_PREFETCH = 1 << 10,
                  F_HAZARD = 1 << 11, F_PARITY = 1 << 12;
enum Elem { E_I8 = 0, E_I16, E_I32, E_I64, E_U8, E_F32, E_F64 };

// a buffer's row of instance r starts at (base ? base : arena) + off +
// r * stride: register files live in the arena (base null, stride 0),
// stacks in device memory (off 0)
struct Buffers {
  int64_t off[kMaxBuf];
  int64_t stride[kMaxBuf];
  char* base[kMaxBuf];
  int n;
};

struct Layout { int64_t tab, prog, partial, rowp, ring, arena, total; };

__host__ __device__ inline Layout layout(int64_t arena_bytes, bool arena_shared, int ring,
                                         int64_t slot) {
  Layout L;
  int64_t o = 0;
  L.tab = o; o += kChunk * kStepWords * 8;
  L.prog = o; o += 2 * kProgWords * 8;
  L.partial = o; o += 2 * 32 * 8;
  L.rowp = o; o += kMaxBuf * 8;
  L.ring = o; o += ring * slot;
  L.arena = o; o += arena_shared ? arena_bytes : 0;
  L.total = o;
  return L;
}

__device__ __forceinline__ int elem_bytes(int e) {
  return e == E_I8 || e == E_U8 ? 1 : e == E_I16 ? 2 : e == E_I32 || e == E_F32 ? 4 : 8;
}

// loads through generic pointers: shared or global, the same code
__device__ __forceinline__ int64_t load_elem(const char* p, int e, int i) {
  switch (e) {
    case E_I8: return ((const int8_t*)p)[i];
    case E_I16: return ((const int16_t*)p)[i];
    case E_I32: return ((const int32_t*)p)[i];
    case E_I64: return ((const int64_t*)p)[i];
    case E_U8: return ((const uint8_t*)p)[i];
    case E_F32: return (int64_t)((const float*)p)[i];
    default: return (int64_t)((const double*)p)[i];
  }
}

// register files and store stacks are int8 / int16 / int32: a wrapping cast
__device__ __forceinline__ void store_elem(char* p, int e, int i, int64_t v) {
  switch (e) {
    case E_I8: ((int8_t*)p)[i] = (int8_t)v; break;
    case E_I16: ((int16_t*)p)[i] = (int16_t)v; break;
    default: ((int32_t*)p)[i] = (int32_t)v; break;
  }
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gsrc) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gsrc) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// a prefetch source packed in one word: buffer | elem << 4 | n << 8 | col << 36
// (-1: none). The 4-byte words covering the span go to ring slot k % ring
// (ring a power of two); every thread commits one group per call, empty or
// not, so group k is always the k-th commit.
__device__ __forceinline__ void issue_prefetch(int64_t src, int64_t k, char* const* rowp,
                                               char* ring_buf, int ring, int64_t slot) {
  if (src >= 0) {
    const int es = elem_bytes((int)((src >> 4) & 15));
    const int64_t n = (src >> 8) & ((int64_t(1) << 28) - 1);
    const char* p = rowp[src & 15] + (src >> 36) * es;
    const char* a = (const char*)((uintptr_t)p & ~(uintptr_t)3);
    const int64_t words = ((p - a) + n * es + 3) >> 2;
    char* dst = ring_buf + (int)(k & (ring - 1)) * slot;
    for (int64_t w = threadIdx.x; w < words; w += blockDim.x) cp_async4(dst + 4 * w, a + 4 * w);
  }
  cp_async_commit();
}

template <typename T>
__device__ void run_fused(const int64_t* prog, int n_ops, int n_in, int n_out, int n,
                          T* reg, bool hazard, T* scratch) {
  const int64_t* in_slot = prog + 2 * n_ops;
  const int64_t* out_slot = in_slot + n_in;
  const int64_t* in_col = out_slot + n_out;
  const int64_t* out_col = in_col + n_in;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    T slot[kMaxSlots];
    for (int k = 0; k < n_in; ++k) slot[in_slot[k]] = reg[in_col[k] + e];
    run_slot_ops<T>(slot, prog, n_ops);
    if (hazard) {
      for (int k = 0; k < n_out; ++k) scratch[k * n + e] = slot[out_slot[k]];
    } else {
      for (int k = 0; k < n_out; ++k) reg[out_col[k] + e] = slot[out_slot[k]];
    }
  }
  if (hazard) {            // every input lane is read before any is written
    __syncthreads();
    for (int i = threadIdx.x; i < n_out * n; i += blockDim.x) {
      const int k = i / n;
      reg[out_col[k] + (i - k * n)] = scratch[i];
    }
  }
}

template <typename Tout>
__device__ __forceinline__ void flush_to(char* p, int col, uint64_t acc, int post,
                                         int64_t scalar) {
  ((Tout*)p)[col] = flush<Tout>(acc, post, scalar, MODE_ORACLE);
}

__global__ void __launch_bounds__(kMaxThreads)
    kvi_walk_kernel(const int64_t* __restrict__ table, int64_t n_steps,
                    const int64_t* __restrict__ pool, int64_t pf_off, int64_t n_pf,
                    Buffers bufs, int64_t arena_bytes, int arena_shared, int64_t scratch_off,
                    char* workspace, int ring, int64_t slot, int64_t rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(arena_bytes, arena_shared != 0, ring, slot);
  int64_t* tab = (int64_t*)(smem + L.tab);
  int64_t* progbuf = (int64_t*)(smem + L.prog);
  uint64_t* partial = (uint64_t*)(smem + L.partial);
  char** rowp = (char**)(smem + L.rowp);
  char* ring_buf = (char*)(smem + L.ring);
  char* arena = arena_shared ? (char*)(smem + L.arena)
                             : workspace + (int64_t)blockIdx.x * arena_bytes;
  const int64_t* pf = pool + pf_off;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = (nt + 31) >> 5;
  // prefetches in flight ahead of the copy that consumes one: ring - 1, so
  // that the next one can go to the slot the previous copy read
  const int lead = ring > 1 ? ring - 1 : ring;

  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    __syncthreads();       // the previous row is done with the arena and the ring
    for (int64_t i = tid; i < arena_bytes / 16; i += nt)
      ((int4*)arena)[i] = make_int4(0, 0, 0, 0);
    if (tid < bufs.n)
      rowp[tid] = (bufs.base[tid] ? bufs.base[tid] : arena) + bufs.off[tid] +
                  row * bufs.stride[tid];
    __syncthreads();
    for (int k = 0; k < lead; ++k)
      issue_prefetch(k < n_pf ? pf[k] : -1, k, rowp, ring_buf, ring, slot);

    for (int64_t c0 = 0; c0 < n_steps; c0 += kChunk) {
      const int64_t cn = n_steps - c0 < kChunk ? n_steps - c0 : kChunk;
      __syncthreads();
      for (int64_t i = tid; i < cn * kStepWords; i += nt) tab[i] = table[c0 * kStepWords + i];
      __syncthreads();
      for (int64_t s = 0; s < cn; ++s) {
        const int64_t* w = tab + s * kStepWords;
        const int64_t head = w[0];
        const int kind = (int)(head & 0xff);
        if (kind == COPY) {
          const int db = (int)w[1], sb = (int)w[3];
          const int dcol = (int)w[2], scol = (int)w[4], n = (int)w[5];
          const int de = (int)((head >> 16) & 0xff), se = (int)((head >> 24) & 0xff);
          char* dst = rowp[db];
          if (head & F_PREFETCH) {
            // wait for prefetch k, sync (every thread's words have landed
            // and every thread is done with the slot copy k - 1 read), send
            // prefetch k + ring - 1 to that slot, then convert slot k
            const int64_t k = w[6];
            cp_async_wait(lead - 1);
            __syncthreads();
            if (ring > 1) issue_prefetch(w[7], k + ring - 1, rowp, ring_buf, ring, slot);
            const int es = elem_bytes(se);
            const char* p = rowp[sb] + (int64_t)scol * es;
            const char* src = ring_buf + (int)(k & (ring - 1)) * slot + ((uintptr_t)p & 3);
            for (int e = tid; e < n; e += nt) store_elem(dst, de, dcol + e, load_elem(src, se, e));
          } else if (head & F_OVERLAP) {
            // memmove within one buffer: chunks of nt lanes, read, sync,
            // write, sync, in the direction that never overwrites a lane
            // still to be read
            const char* src = rowp[sb];
            const bool back = dcol > scol;
            for (int c = 0; c < n; c += nt) {
              const int e = back ? n - c - nt + tid : c + tid;
              const bool ok = e >= 0 && e < n;
              const int64_t v = ok ? load_elem(src, se, scol + e) : 0;
              __syncthreads();
              if (ok) store_elem(dst, de, dcol + e, v);
              __syncthreads();
            }
          } else {
            const char* src = rowp[sb];
            for (int e = tid; e < n; e += nt) store_elem(dst, de, dcol + e, load_elem(src, se, scol + e));
          }
        } else if (kind == FUSED) {
          const int rb = (int)w[1];
          const int n_ops = (int)w[3], n_in = (int)w[4], n_out = (int)w[5];
          const int n = (int)w[6];
          int64_t* prog = progbuf + ((head & F_PARITY) ? kProgWords : 0);
          const int64_t* src = pool + w[2];
          const int len = 2 * n_ops + 2 * (n_in + n_out);
          for (int i = tid; i < len; i += nt) prog[i] = src[i];
          __syncthreads();
          const bool hazard = (head & F_HAZARD) != 0;
          char* reg = rowp[rb];
          char* scratch = arena + scratch_off;
          switch ((head >> 16) & 0xff) {
            case E_I8: run_fused<int8_t>(prog, n_ops, n_in, n_out, n, (int8_t*)reg, hazard, (int8_t*)scratch); break;
            case E_I16: run_fused<int16_t>(prog, n_ops, n_in, n_out, n, (int16_t*)reg, hazard, (int16_t*)scratch); break;
            default: run_fused<int32_t>(prog, n_ops, n_in, n_out, n, (int32_t*)reg, hazard, (int32_t*)scratch); break;
          }
        } else {
          const int ab = (int)w[1];
          const int acol = (int)w[2], bcol = (int)w[3], n = (int)w[4];
          const int db = (int)(w[5] & 0xff), post = (int)((w[5] >> 8) & 0xff);
          const int ae = (int)((head >> 16) & 0xff);
          const char* a = rowp[ab];
          uint64_t acc = 0;
          if (bcol >= 0) {
            for (int e = tid; e < n; e += nt)
              acc += (uint64_t)load_elem(a, ae, acol + e) * (uint64_t)load_elem(a, ae, bcol + e);
          } else {
            for (int e = tid; e < n; e += nt) acc += (uint64_t)load_elem(a, ae, acol + e);
          }
          acc = warp_sum(acc);
          uint64_t* part = partial + ((head & F_PARITY) ? 32 : 0);
          if (n_warps > 1) {     // one warp: lane 0 holds the sum already
            if (lane == 0) part[warp] = acc;
            __syncthreads();
          }
          if (tid == 0) {
            uint64_t total = n_warps > 1 ? 0 : acc;
            for (int i = 0; n_warps > 1 && i < n_warps; ++i) total += part[i];
            switch ((head >> 24) & 0xff) {
              case E_I8: flush_to<int8_t>(rowp[db], (int)w[6], total, post, w[7]); break;
              case E_I16: flush_to<int16_t>(rowp[db], (int)w[6], total, post, w[7]); break;
              default: flush_to<int32_t>(rowp[db], (int)w[6], total, post, w[7]); break;
            }
          }
        }
        if (head & F_BARRIER) __syncthreads();
      }
    }
    cp_async_wait(0);      // only empty groups can be left
  }
}

int g_smem_set = 48 * 1024;   // the dynamic shared memory the kernel may take

}  // namespace

// The dynamic shared memory of one block (kvi_walk.py::smem_bytes).
extern "C" int64_t kvi_walk_smem_bytes(int64_t arena_bytes, int arena_shared, int ring,
                                       int64_t slot) {
  return layout(arena_bytes, arena_shared != 0, ring, slot).total;
}

// Runs the packed walk over `rows` instances in one launch of `grid`
// blocks of `threads`. table (n_steps x 8), pool: device int64. desc: host
// int64 [n_buf x 2] = byte offset, row stride in bytes; ptrs: host int64
// [n_buf] base pointers (0: the arena). workspace: device [grid x
// arena_bytes] when the arena is not in shared memory. smem_bytes must
// equal kvi_walk_smem_bytes(...).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int kvi_walk_launch(const int64_t* table, int64_t n_steps, const int64_t* pool,
                               int64_t pf_off, int64_t n_pf, const int64_t* desc,
                               const int64_t* ptrs, int n_buf, int64_t arena_bytes,
                               int arena_shared, int64_t scratch_off, void* workspace, int ring,
                               int64_t slot, int64_t rows, int grid, int threads,
                               int64_t smem_bytes, void* stream) {
  if (n_buf < 1 || n_buf > kMaxBuf || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || ring < 0 || ring > kMaxRing || (ring & (ring - 1)) != 0 ||
      (ring > 0) != (n_pf > 0) || (ring == 1 && n_pf > 1) ||
      slot % 16 != 0 || arena_bytes % 16 != 0 || arena_bytes < 0 || grid < 1 ||
      (!arena_shared && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes != layout(arena_bytes, arena_shared != 0, ring, slot).total ||
      smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n_steps <= 0) return 0;
  Buffers bufs;
  bufs.n = n_buf;
  for (int b = 0; b < kMaxBuf; ++b) {
    const bool on = b < n_buf;
    bufs.off[b] = on ? desc[2 * b] : 0;
    bufs.stride[b] = on ? desc[2 * b + 1] : 0;
    bufs.base[b] = on ? (char*)(intptr_t)ptrs[b] : nullptr;
  }
  if (smem_bytes > g_smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kvi_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    g_smem_set = (int)smem_bytes;
  }
  kvi_walk_kernel<<<(unsigned)grid, threads, (size_t)smem_bytes, (cudaStream_t)stream>>>(
      table, n_steps, pool, pf_off, n_pf, bufs, arena_bytes, arena_shared, scratch_off,
      (char*)workspace, ring, slot, rows);
  return (int)cudaGetLastError();
}
