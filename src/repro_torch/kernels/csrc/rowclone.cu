// RowClone data movers for the paged KV arena, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels in
// src/repro/kernels/rowclone/rowclone.py:
//   rc_kv_scatter  <- kv_scatter         (rowclone.py:215)
//   rc_copy_rows   <- page_copy_batched  (rowclone.py:140)
//   rc_init_rows   <- page_init_batched  (rowclone.py:178)
//
// What bounds them on an H100: bytes.  They do no arithmetic; the least
// time is (bytes read + bytes written) / 3.35 TB/s.  At the serving
// path's shapes (granite-3-8b: 40 layers, a page row of 16 slots x 8 KV
// heads x 128 dims in bf16 = 32 KiB per layer, a slot of 2 KiB) a
// decode round's scatter moves 40 x B x 2 KiB per arena and a CoW copy
// 40 x 32 KiB per page.
//
// Design: every kernel treats a row as raw bytes, so one kernel serves
// every dtype.  One block per (row, layer); its threads stream the row
// with 16-byte loads and stores when the row length and both base
// pointers allow it (the arena rows are multiples of 16 bytes), else
// byte by byte.  The arena is updated in place: untouched rows are
// never read or written.
//
// Ordering: GPU blocks run in no order.  A batched copy whose
// destination set meets its source set must read every source before
// any write (the Pallas grid ran in order and the reference gathers
// first), so the wrapper stages such a batch through a scratch buffer
// in two launches of rc_copy_rows (gather, then scatter).  Duplicate
// (page, slot) pairs in one scatter are allowed only with identical
// payloads (batch pad rows); the op queue removes real duplicates on
// the host before it launches.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool VEC>
__device__ __forceinline__ void copy_row(char* __restrict__ dst,
                                         const char* __restrict__ src,
                                         long long nbytes) {
  if (VEC) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    long long n = nbytes / 16;
    for (long long i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
  } else {
    for (long long i = threadIdx.x; i < nbytes; i += blockDim.x)
      dst[i] = src[i];
  }
}

// grid (B, L): arena[l, pages[b], slots[b]] <- src[l, b]
template <bool VEC>
__global__ void kv_scatter_kernel(char* __restrict__ arena,
                                  const char* __restrict__ src,
                                  const int* __restrict__ pages,
                                  const int* __restrict__ slots, int B,
                                  long long P, int S, long long row_bytes) {
  const int b = blockIdx.x;
  const long long l = blockIdx.y;
  const long long row = (l * P + pages[b]) * S + slots[b];
  copy_row<VEC>(arena + row * row_bytes, src + (l * B + b) * row_bytes,
                row_bytes);
}

// grid (n, L): dst[l, dst_idx[i]] <- src[l, src_idx[i]]; a null index
// array means the identity (row i).
template <bool VEC>
__global__ void copy_rows_kernel(const char* __restrict__ src,
                                 const int* __restrict__ src_idx,
                                 long long src_rows, char* __restrict__ dst,
                                 const int* __restrict__ dst_idx,
                                 long long dst_rows, long long row_bytes) {
  const int i = blockIdx.x;
  const long long l = blockIdx.y;
  const long long sr = src_idx ? src_idx[i] : i;
  const long long dr = dst_idx ? dst_idx[i] : i;
  copy_row<VEC>(dst + (l * dst_rows + dr) * row_bytes,
                src + (l * src_rows + sr) * row_bytes, row_bytes);
}

// grid (n, L): dst[l, dst_idx[i]] <- the 32-bit pattern, repeated
template <bool VEC>
__global__ void init_rows_kernel(char* __restrict__ dst,
                                 const int* __restrict__ dst_idx,
                                 long long dst_rows, long long row_bytes,
                                 unsigned int pattern) {
  const int i = blockIdx.x;
  const long long l = blockIdx.y;
  char* row = dst + (l * dst_rows + dst_idx[i]) * row_bytes;
  if (VEC) {
    uint4 v = make_uint4(pattern, pattern, pattern, pattern);
    uint4* d = reinterpret_cast<uint4*>(row);
    long long n = row_bytes / 16;
    for (long long k = threadIdx.x; k < n; k += blockDim.x) d[k] = v;
  } else {
    unsigned int* d = reinterpret_cast<unsigned int*>(row);
    long long n = row_bytes / 4;
    for (long long k = threadIdx.x; k < n; k += blockDim.x) d[k] = pattern;
  }
}

bool aligned16(const void* a, const void* b, long long row_bytes) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           static_cast<uintptr_t>(row_bytes)) & 15) == 0;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int rc_kv_scatter(void* arena, const void* src, const int* pages,
                             const int* slots, int L, int B, long long P,
                             int S, long long row_bytes, void* stream) {
  if (L <= 0 || B <= 0) return 0;
  dim3 grid(B, L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned16(arena, src, row_bytes))
    kv_scatter_kernel<true><<<grid, kThreads, 0, st>>>(
        static_cast<char*>(arena), static_cast<const char*>(src), pages,
        slots, B, P, S, row_bytes);
  else
    kv_scatter_kernel<false><<<grid, kThreads, 0, st>>>(
        static_cast<char*>(arena), static_cast<const char*>(src), pages,
        slots, B, P, S, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rc_copy_rows(const void* src, const int* src_idx,
                            long long src_rows, void* dst, const int* dst_idx,
                            long long dst_rows, int n, int L,
                            long long row_bytes, void* stream) {
  if (n <= 0 || L <= 0) return 0;
  dim3 grid(n, L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned16(src, dst, row_bytes))
    copy_rows_kernel<true><<<grid, kThreads, 0, st>>>(
        static_cast<const char*>(src), src_idx, src_rows,
        static_cast<char*>(dst), dst_idx, dst_rows, row_bytes);
  else
    copy_rows_kernel<false><<<grid, kThreads, 0, st>>>(
        static_cast<const char*>(src), src_idx, src_rows,
        static_cast<char*>(dst), dst_idx, dst_rows, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// row_bytes must be a multiple of 4 (the wrapper checks)
extern "C" int rc_init_rows(void* dst, const int* dst_idx, long long dst_rows,
                            int n, int L, long long row_bytes,
                            unsigned int pattern, void* stream) {
  if (n <= 0 || L <= 0) return 0;
  dim3 grid(n, L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned16(dst, dst, row_bytes))
    init_rows_kernel<true><<<grid, kThreads, 0, st>>>(
        static_cast<char*>(dst), dst_idx, dst_rows, row_bytes, pattern);
  else
    init_rows_kernel<false><<<grid, kThreads, 0, st>>>(
        static_cast<char*>(dst), dst_idx, dst_rows, row_bytes, pattern);
  return static_cast<int>(cudaGetLastError());
}
