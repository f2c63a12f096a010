// Ambit bulk bitwise page operations for the paged KV arena, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas kernels in
// src/repro/kernels/ambit/ambit.py:
//   am_page_rows (AND, OR)     <- page_bitwise_batched  (ambit.py:48)
//   am_page_rows (NOT)         <- page_not_batched      (ambit.py:91)
//   am_zero_scan               <- page_zero_scan        (ambit.py:135)
//
// What they compute, on the raw bits of an (L, P, row) arena:
//   AND/OR: arena[l, dst[i]] <- arena[l, src[i]] OP arena[l, dst[i]]
//   NOT:    arena[l, dst[i]] <- ~arena[l, src[i]]
//   scan:   out[i] = 1 where no bit of arena[l, pages[i]] is set, for every
//           layer l of every arena given (one arena, or a (K, V) pair)
// The ops act on bits, never on values: a bf16 -0.0 (0x8000) is nonzero
// to the scan, and NOT of a float is the bit complement.
//
// What bounds them on an H100: bytes.  Each op reads its source row
// (AND/OR also the destination row) and writes the destination row, and
// does one logic instruction a word; the scan only reads.  At the
// serving path's shapes (granite-3-8b: 40 layers, a page row of 16 slots
// x 8 KV heads x 128 dims in bf16 = 32 KiB a layer) an AND over 16 pages
// moves 3 x 16 x 40 x 32 KiB = 63 MB, 19 us at 3.35 TB/s (38 us for the
// (K, V) pair in one launch).  The scan of a
// pair over 16 pages reads 2 x 16 x 40 x 32 KiB = 42 MB, 12.5 us (a page
// found nonzero needs no more than the word that shows it, but its blocks
// run side by side with the others, so the kernel reads it all).
//
// Design of the bitwise ops (page_rows.cuh, shared with the RowClone page
// copy): one launch a flush over one arena or the (K, V) pair (each
// arena its own descriptor), the (src, dst) list of up to kInlinePairs
// ops in the launch's parameters (a longer one is uploaded), rows cut
// into 16 KiB chunks, one block a chunk.  The arena is updated in place:
// untouched rows are never read.
//
// Ordering: GPU blocks run in no order, and every op reads the arena as
// it was before the batch (the reference reads every source before any
// write; the Pallas grid, in order, does too for the batches the op
// queue forms).  A batch in which a destination is another op's source
// takes the cluster route: one thread-block cluster per (layer, arena)
// stages the layer's sources in shared memory, meets at one cluster
// barrier, then combines each staged source with its destination (which
// only its own op writes) and stores.  An op whose source is its own
// destination reads and writes each word in one thread, so it is no
// hazard.  A layer's batch past the cluster's capacity (am_cluster_chunks)
// is staged through scratch by the wrapper: a COPY gather, then the op.
// Destinations are distinct (the wrapper refuses duplicates; the op queue
// flushes before a second op on one page).
//
// The scan is one launch whatever it serves: grid z picks the arena (a
// (K, V) pair in one launch, as rc_init_rows does), a page list of up to
// kInlinePages pages travels in the launch's parameters, and the launch
// writes its answer itself, so no launch zeroes flags before it and none
// compares or ANDs after it.  Each block reads kThreads x kScanUnroll
// words of one row (eight independent 16-byte loads a thread, all issued
// before any is tested); a block that finds a set bit stores 1 into the
// page's word of a device scratch (the same value from every block, so a
// plain store).  The last block to finish (a
// counter in the scratch) writes out[i] = no bit found, to device memory
// (the single-arena call's bool tensor) and/or to mapped pinned host
// memory (the pair's host flags, read after one stream wait), and zeroes
// the scratch words it used: every launch finds its scratch zero.  The
// host flags are written by the kernel into mapped memory rather than
// copied back after it: the pair's answer then costs one launch and one
// wait, with no copy queued behind the kernel.
//
// Each launching entry point returns cudaGetLastError() after its launch;
// the others return their runtime call's error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "page_rows.cuh"

namespace {

__device__ __forceinline__ bool nonzero(unsigned char w) { return w != 0; }

__device__ __forceinline__ bool nonzero(uint4 w) {
  return (w.x | w.y | w.z | w.w) != 0;
}

constexpr int kThreads = 256;
constexpr int kScanUnroll = 8;
// page lists up to this long travel in a scan launch's parameters (the
// wrapper's INLINE_ROWS); longer ones are uploaded
constexpr int kInlinePages = 512;
struct PageList {
  int idx[kInlinePages];
};

// grid (segments x L, n, arenas): the block of segment s, layer l, page i
// and arena z reads words [s * kThreads * kScanUnroll, ...) of row
// (l, page i) of arena z (a whole 32 KiB row of the serving arena: eight
// independent 16-byte loads a thread).  scratch[0] counts finished
// blocks and scratch[1 + i] becomes 1 once page i is known to hold a set
// bit.
template <typename W>
__global__ void zero_scan_kernel(const W* __restrict__ a0,
                                 const W* __restrict__ a1,
                                 const int* __restrict__ dev_pages,
                                 const PageList pages, long long rows,
                                 long long row_words, int segments, int n,
                                 int* scratch, unsigned char* out_dev,
                                 unsigned char* out_host) {
  const int seg = blockIdx.x % segments;
  const long long l = blockIdx.x / segments;
  const int i = blockIdx.y;
  volatile int* found = scratch + 1;
  const long long page = dev_pages ? dev_pages[i] : pages.idx[i];
  const W* row = (blockIdx.z ? a1 : a0) + (l * rows + page) * row_words;
  const long long k0 =
      static_cast<long long>(seg) * kThreads * kScanUnroll + threadIdx.x;
  W w[kScanUnroll];
#pragma unroll
  for (int u = 0; u < kScanUnroll; ++u) {
    const long long k = k0 + u * kThreads;
    w[u] = k < row_words ? row[k] : W{};
  }
  int nz = 0;
#pragma unroll
  for (int u = 0; u < kScanUnroll; ++u) nz |= nonzero(w[u]);
  __shared__ bool last;
  nz = __syncthreads_or(nz);
  if (threadIdx.x == 0) {
    if (nz) {
      found[i] = 1;
      __threadfence();      // the flag lands before this block counts
    }
    const unsigned total = gridDim.x * gridDim.y * gridDim.z;
    last = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const unsigned char zero = found[k] == 0;
    if (out_dev) out_dev[k] = zero;
    if (out_host) out_host[k] = zero;
    found[k] = 0;
  }
  if (threadIdx.x == 0) scratch[0] = 0;
}

bool aligned16(const void* a, const void* b, long long row_bytes) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           static_cast<uintptr_t>(row_bytes)) & 15) == 0;
}

}  // namespace

// One page-op launch (page_rows.cuh's launch_page_rows) over `arenas`
// (1 or 2) arenas: op 0 AND, 1 OR, 2 NOT, 3 COPY (the staged route's
// gather).  desc: 6 values an arena (source base, destination base,
// source rows a layer, destination rows a layer, row bytes, layers).
// The ops' rows: dev_idx on the card, or (dev_idx null) host_idx on the
// host, at most kInlinePairs ops (the wrapper's INLINE_PAIRS), passed in
// the launch; each 2n ints, sources then destinations.  identity: bit 0,
// op i reads row i; bit 1, it writes row i.  route 0: direct; 1: cluster.
extern "C" int am_page_rows(const long long* desc, int arenas,
                            const int* dev_idx, const int* host_idx, int n,
                            int identity, int route, int op, void* stream) {
  switch (op) {
    case 0:
      return launch_page_rows<AndOp>(desc, arenas, dev_idx, host_idx, n,
                                     identity, route, stream);
    case 1:
      return launch_page_rows<OrOp>(desc, arenas, dev_idx, host_idx, n,
                                    identity, route, stream);
    case 2:
      return launch_page_rows<NotOp>(desc, arenas, dev_idx, host_idx, n,
                                     identity, route, stream);
    case 3:
      return launch_page_rows<CopyOp>(desc, arenas, dev_idx, host_idx, n,
                                      identity, route, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the chunks a cluster of the bitwise ops holds at most (the least over
// AND, OR and NOT): the wrapper stages a layer's batch of more through
// scratch instead
extern "C" int am_cluster_chunks() {
  const int a = page_cluster_chunks<AndOp>();
  const int o = page_cluster_chunks<OrOp>();
  const int n = page_cluster_chunks<NotOp>();
  return a < o ? (a < n ? a : n) : (o < n ? o : n);
}

// The zero scan of the same pages of `arenas` (1 or 2) arenas of one
// shape, in one launch (a1 is read only when arenas is 2).  Pages: dev_pages
// on the device, or (dev_pages null) host_pages on the host, at most
// kInlinePages of them, passed in the launch.  scratch: 1 + n int32 words
// on the device, zero (every launch leaves them so).  out_dev: n bytes on
// the device, or null; out_host: n bytes of mapped pinned host memory (see
// am_alloc_mapped), or null; each gets 1 where the page holds no set bit.
// n <= 65535.
extern "C" int am_zero_scan(const void* a0, const void* a1, int arenas,
                            const int* dev_pages, const int* host_pages,
                            long long rows, int n, int L, long long row_bytes,
                            int* scratch, unsigned char* out_dev,
                            unsigned char* out_host, void* stream) {
  if (n <= 0 || L <= 0 || row_bytes <= 0) return 0;
  if (arenas < 1 || arenas > 2 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (arenas == 1) a1 = a0;
  PageList pages;
  if (dev_pages == nullptr) {
    if (host_pages == nullptr || n > kInlinePages)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < n; ++i) pages.idx[i] = host_pages[i];
  }
  unsigned char* host_dev = nullptr;
  if (out_host != nullptr) {
    const cudaError_t e =
        cudaHostGetDevicePointer(reinterpret_cast<void**>(&host_dev),
                                 out_host, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(a0, a1, row_bytes);
  const long long row_words = vec ? row_bytes / 16 : row_bytes;
  const long long per_block = static_cast<long long>(kThreads) * kScanUnroll;
  const long long segments = (row_words + per_block - 1) / per_block;
  if (segments * L > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(segments * L), n, arenas);
  if (vec)
    zero_scan_kernel<uint4><<<grid, kThreads, 0, st>>>(
        static_cast<const uint4*>(a0), static_cast<const uint4*>(a1),
        dev_pages, pages, rows, row_words, static_cast<int>(segments), n,
        scratch, out_dev, host_dev);
  else
    zero_scan_kernel<unsigned char><<<grid, kThreads, 0, st>>>(
        static_cast<const unsigned char*>(a0),
        static_cast<const unsigned char*>(a1), dev_pages, pages, rows,
        row_words, static_cast<int>(segments), n, scratch, out_dev,
        host_dev);
  return static_cast<int>(cudaGetLastError());
}

// `bytes` of pinned host memory mapped into the device's address space on
// every device (the scan's host flags); *host gets its address.
extern "C" int am_alloc_mapped(long long bytes, void** host) {
  return static_cast<int>(cudaHostAlloc(
      host, static_cast<size_t>(bytes),
      cudaHostAllocMapped | cudaHostAllocPortable));
}

extern "C" int am_free_mapped(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}

// Wait for the work queued on `stream` (the scan's one wait before its
// host flags are read).
extern "C" int am_stream_wait(void* stream) {
  return static_cast<int>(
      cudaStreamSynchronize(static_cast<cudaStream_t>(stream)));
}
