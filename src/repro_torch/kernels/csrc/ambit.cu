// Ambit bulk bitwise page operations for the paged KV arena, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas kernels in
// src/repro/kernels/ambit/ambit.py:
//   am_bitwise_rows (AND, OR)  <- page_bitwise_batched  (ambit.py:48)
//   am_bitwise_rows (NOT)      <- page_not_batched      (ambit.py:91)
//   am_zero_scan               <- page_zero_scan        (ambit.py:135)
//
// What they compute, on the raw bits of an (L, P, row) arena:
//   AND/OR: arena[l, dst[i]] <- arena[l, src[i]] OP arena[l, dst[i]]
//   NOT:    arena[l, dst[i]] <- ~arena[l, src[i]]
//   scan:   flags[i] |= 1 where any bit of arena[l, pages[i]] is set, for
//           any layer l (the wrapper zeroes the flags first)
// The ops act on bits, never on values: a bf16 -0.0 (0x8000) is nonzero
// to the scan, and NOT of a float is the bit complement.
//
// What bounds them on an H100: bytes.  Each op reads its source row
// (AND/OR also the destination row) and writes the destination row, and
// does one logic instruction a word; the scan only reads.  At the
// serving path's shapes (granite-3-8b: 40 layers, a page row of 16 slots
// x 8 KV heads x 128 dims in bf16 = 32 KiB a layer) an AND over 16 pages
// moves 3 x 16 x 40 x 32 KiB = 63 MB, 19 us at 3.35 TB/s.
//
// Design: one thread per 16-byte word of a row (or per byte when a row
// is not a multiple of 16 bytes, or a base is not 16-byte aligned), a
// grid over (word block, op, layer), so every thread does one load or
// two and one store.  The arena is updated in place: untouched rows are
// never read.  A "copy" op (COPY) serves the wrapper's staging.
//
// Ordering: GPU blocks run in no order.  The reference reads every
// source before any write (the Pallas grid, in order, does too for the
// batches the op queue forms), so a batch in which a destination is
// another op's source is staged by the wrapper: one COPY launch gathers
// the sources into scratch, one launch of the op reads them from there.
// An op whose source is its own destination reads and writes each word
// in one thread, so it needs no staging.  The op queue never forms a
// batch with two ops on one destination.
//
// The scan's blocks each reduce their words with __syncthreads_or and
// set the page's flag with one atomicOr where a bit was found, so a
// page's flag is the OR over all its layers and word blocks.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kAnd = 0, kOr = 1, kNot = 2, kCopy = 3 };

template <int OP>
__device__ __forceinline__ unsigned char combine(unsigned char s,
                                                 unsigned char d) {
  if (OP == kAnd) return s & d;
  if (OP == kOr) return s | d;
  if (OP == kNot) return static_cast<unsigned char>(~s);
  return s;
}

template <int OP>
__device__ __forceinline__ unsigned int combine(unsigned int s,
                                                unsigned int d) {
  if (OP == kAnd) return s & d;
  if (OP == kOr) return s | d;
  if (OP == kNot) return ~s;
  return s;
}

template <int OP>
__device__ __forceinline__ uint4 combine(uint4 s, uint4 d) {
  return make_uint4(combine<OP>(s.x, d.x), combine<OP>(s.y, d.y),
                    combine<OP>(s.z, d.z), combine<OP>(s.w, d.w));
}

__device__ __forceinline__ bool nonzero(unsigned char w) { return w != 0; }

__device__ __forceinline__ bool nonzero(uint4 w) {
  return (w.x | w.y | w.z | w.w) != 0;
}

// grid (word blocks, n, L): dst[l, dst_idx[i]] <- OP(src[l, src_idx[i]],
// dst[l, dst_idx[i]]); a null index array means the identity (row i).
template <typename W, int OP>
__global__ void bitwise_rows_kernel(const W* src,
                                    const int* __restrict__ src_idx,
                                    long long src_rows, W* dst,
                                    const int* __restrict__ dst_idx,
                                    long long dst_rows, long long row_words) {
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (w >= row_words) return;
  const int i = blockIdx.y;
  const long long l = blockIdx.z;
  const long long sr = src_idx ? src_idx[i] : i;
  const long long dr = dst_idx ? dst_idx[i] : i;
  const W s = src[(l * src_rows + sr) * row_words + w];
  W* d = dst + (l * dst_rows + dr) * row_words + w;
  if (OP == kAnd || OP == kOr)
    *d = combine<OP>(s, *d);
  else
    *d = combine<OP>(s, s);
}

// grid (word blocks, n, L): flags[i] |= any bit set in arena[l, pages[i]]
template <typename W>
__global__ void zero_scan_kernel(const W* __restrict__ arena,
                                 const int* __restrict__ pages,
                                 long long rows, long long row_words,
                                 int* __restrict__ flags) {
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int i = blockIdx.y;
  const long long l = blockIdx.z;
  int nz = 0;
  if (w < row_words) nz = nonzero(arena[(l * rows + pages[i]) * row_words + w]);
  if (__syncthreads_or(nz) && threadIdx.x == 0) atomicOr(&flags[i], 1);
}

bool aligned16(const void* a, const void* b, long long row_bytes) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           static_cast<uintptr_t>(row_bytes)) & 15) == 0;
}

constexpr int kThreads = 256;

template <typename W, int OP>
void launch_op(const void* src, const int* src_idx, long long src_rows,
               void* dst, const int* dst_idx, long long dst_rows, int n,
               int L, long long row_words, cudaStream_t st) {
  dim3 grid(static_cast<unsigned>((row_words + kThreads - 1) / kThreads), n,
            L);
  bitwise_rows_kernel<W, OP><<<grid, kThreads, 0, st>>>(
      static_cast<const W*>(src), src_idx, src_rows, static_cast<W*>(dst),
      dst_idx, dst_rows, row_words);
}

template <typename W>
int launch_any(int op, const void* src, const int* src_idx,
               long long src_rows, void* dst, const int* dst_idx,
               long long dst_rows, int n, int L, long long row_words,
               cudaStream_t st) {
  switch (op) {
    case kAnd:
      launch_op<W, kAnd>(src, src_idx, src_rows, dst, dst_idx, dst_rows, n,
                         L, row_words, st);
      break;
    case kOr:
      launch_op<W, kOr>(src, src_idx, src_rows, dst, dst_idx, dst_rows, n,
                        L, row_words, st);
      break;
    case kNot:
      launch_op<W, kNot>(src, src_idx, src_rows, dst, dst_idx, dst_rows, n,
                         L, row_words, st);
      break;
    case kCopy:
      launch_op<W, kCopy>(src, src_idx, src_rows, dst, dst_idx, dst_rows, n,
                          L, row_words, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op: 0 AND, 1 OR, 2 NOT, 3 COPY; rows of row_bytes bytes, layer-major
// (layer l's rows start at l * rows * row_bytes); n <= 65535, L <= 65535
extern "C" int am_bitwise_rows(const void* src, const int* src_idx,
                               long long src_rows, void* dst,
                               const int* dst_idx, long long dst_rows, int n,
                               int L, long long row_bytes, int op,
                               void* stream) {
  if (n <= 0 || L <= 0 || row_bytes <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned16(src, dst, row_bytes))
    return launch_any<uint4>(op, src, src_idx, src_rows, dst, dst_idx,
                             dst_rows, n, L, row_bytes / 16, st);
  return launch_any<unsigned char>(op, src, src_idx, src_rows, dst, dst_idx,
                                   dst_rows, n, L, row_bytes, st);
}

// flags: n int32 words, zeroed by the caller; flags[i] becomes 1 where
// page pages[i] holds a nonzero bit in any layer
extern "C" int am_zero_scan(const void* arena, const int* pages,
                            long long rows, int n, int L, long long row_bytes,
                            int* flags, void* stream) {
  if (n <= 0 || L <= 0 || row_bytes <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(arena, arena, row_bytes);
  const long long row_words = vec ? row_bytes / 16 : row_bytes;
  dim3 grid(static_cast<unsigned>((row_words + kThreads - 1) / kThreads), n,
            L);
  if (vec)
    zero_scan_kernel<uint4><<<grid, kThreads, 0, st>>>(
        static_cast<const uint4*>(arena), pages, rows, row_words, flags);
  else
    zero_scan_kernel<unsigned char><<<grid, kThreads, 0, st>>>(
        static_cast<const unsigned char*>(arena), pages, rows, row_words,
        flags);
  return static_cast<int>(cudaGetLastError());
}
