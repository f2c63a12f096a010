// RowClone data movers for the paged KV arena, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels in
// src/repro/kernels/rowclone/rowclone.py:
//   rc_kv_scatter  <- kv_scatter         (rowclone.py:215; one arena, or
//                     a (K, V) arena pair in one launch)
//   rc_copy_pages  <- page_copy_batched  (rowclone.py:140; one arena,
//                     or one op list over a pair: (K, V), or the
//                     conv and SSD state arenas, rows of unequal size)
//                     and page_copy      (rowclone.py:105, one layer)
//   rc_init_rows   <- page_init_batched  (rowclone.py:178; one arena, or
//                     one page list in a (K, V) arena pair)
//                     and page_init      (rowclone.py:253, one layer)
//   rc_copy_flat   <- copy_2d            (rowclone.py:56)
//   rc_fill_flat   <- init_2d            (rowclone.py:76)
//
// What bounds them on an H100: bytes.  They do no arithmetic; the least
// time is (bytes read + bytes written) / 3.35 TB/s.  At the serving
// path's shapes (granite-3-8b: 40 layers, a page row of 16 slots x 8 KV
// heads x 128 dims in bf16 = 32 KiB per layer, a slot of 2 KiB) a
// decode round's scatter moves 40 x B x 2 KiB per arena and a CoW copy
// 40 x 32 KiB per page.  The flat copy and fill stream a whole buffer:
// 2 x bytes and 1 x bytes of traffic (the fill reads nothing: the
// calloc-vs-RowClone-Init point).
//
// Design: every kernel treats a row as raw bytes, so one kernel serves
// every dtype.  The scatter and the init run one block per (row,
// layer) (the page copy: see below); its threads stream the row with
// 16-byte loads and stores when the row length and both base pointers
// allow it (the arena rows are multiples of 16 bytes), else
// byte by byte.  The arena is updated in place: untouched rows are
// never read or written.  Fills write a 32-bit pattern word that
// repeats the value's bytes (1-, 2- and 4-byte dtypes); byte k of a
// buffer or row holds pattern byte k % 4, so a row whose length is not
// a multiple of 4 bytes is filled byte by byte.
//
// The flat copy and fill (RowClone's pim_copy and pim_init against
// memcpy and calloc) stream a whole buffer, up to GBs: nothing but DRAM
// bandwidth bounds them.  What loses bandwidth is the access pattern: a
// grid-stride loop of 16-byte words from a full grid of resident
// blocks spreads each moment's reads and writes over megabytes of
// address space; so do persistent blocks that each walk a contiguous
// span of the buffer (one span per SM, 132 streams at once).  What
// comes closest to memcpy is a grid of short-lived blocks, each moving a
// few consecutive tiles, which the hardware dispatches in address
// order: the card's work sweeps the buffer as one front.  So a buffer
// of at least kBulkMinBytes whose source and destination share their
// offset modulo 16 takes the bulk route, on the Tensor Memory
// Accelerator (TMA), in the same kernel (template MODE 2):
//   * the copy: a block's one thread bulk-loads its kCopyTilesPerBlock
//     tiles into dynamic shared memory (cp.async.bulk ...
//     mbarrier::complete_tx, one mbarrier per tile), all in flight at
//     once, and writes each back with a bulk store (bulk_group) as soon
//     as it lands; no register holds the data;
//   * the fill: the block writes the pattern into one shared tile once,
//     then one thread bulk-stores that tile kFillTilesPerBlock times; it
//     reads nothing from device memory;
//   * every bulk operation carries an L2 evict-first policy, so the
//     stream does not push the serving path's working set out of L2
//     (tools/rowclone_ab.py's reread_us: a 16 MiB set is read back
//     faster after a 256 MiB bulk copy or fill than after clone/zeros).
// The ragged head (up to the first 16-byte boundary) and tail (under 16
// bytes) are bytes written by block 0's threads in the same launch.
// Smaller buffers, and buffers whose offsets differ modulo 16, take the
// register route (MODE 1: 16-byte words; MODE 0: bytes), a grid-stride
// loop, where a launch's fixed cost and not the stream sets the time.
//
// At the serving path's shapes these kernels move a few MB or less
// (a decode round's scatter 2 x 40 x 8 x 2 KiB = 1.3 MB), so the card
// finishes them in microseconds and what a caller pays is the launch and
// the wrapper's host work.  Hence both take an arena count (1 or 2): one
// scatter block per (b, l) writes the K slot row and the V slot row
// (2 x 2 KiB at granite's shape, 256 threads with one 16-byte store
// each), and one init launch covers the K and V pages of a freed page
// list (grid z = arena), where two launches did before.
//
// The page copy (rows 2 and 13) serves the copy-on-write fork of a
// shared tail page (a K and a V row of 32 KiB in each of 40 layers) and
// the SSM state fork (a conv row of 26 KB and an SSD row of 2 MiB in
// each of 48 layers).  It is one launch per flush over both arenas,
// each with its own base, rows, row bytes and layers (grid z = arena on
// the cluster route, the arenas' chunks side by side on the direct
// one), with up to kInlinePairs (src, dst) pairs in the launch's
// parameters, so no upload precedes it.  Rows are cut into kChunk pieces, one block a
// piece, so a 32 KiB page and a 2 MiB row alike fill the card.  GPU
// blocks run in no order, and a batch whose destination is another op's
// source must read every source before any write (the Pallas grid ran
// in order; the reference gathers first).  Such a hazard stays inside
// one layer of one arena, so the wrapper sends that batch down the
// cluster route: one thread-block cluster per (layer, arena) stages the
// layer's sources in its blocks' shared memory (TMA bulk loads), meets
// at one cluster barrier, then writes: one read and one write of each
// row, no scratch.  A layer's batch over the cluster's capacity
// (rc_copy_cluster_chunks) is staged through a scratch buffer in two
// direct launches (gather, then scatter) instead.  Of several ops with
// one destination only the last reaches the kernel (the wrapper drops
// the rest).  Duplicate (page, slot) pairs in one scatter are allowed
// only with identical payloads (batch pad rows); the op queue removes
// real duplicates on the host before it launches.  The page copy's
// kernels (page_rows_kernel / page_rows_cluster_kernel with CopyOp) and
// the bulk PTX live in page_rows.cuh, which the Ambit page ops share.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "page_rows.cuh"

namespace {

// grid (B, L): dst_a[l, pages[b], slots[b]] <- src_a[l, b] for each arena
// a < arenas (arena 0 is dst0/src0, arena 1 dst1/src1); the block's
// threads walk the arenas' rows as one range of words
template <bool VEC>
__global__ void kv_scatter_kernel(char* __restrict__ dst0,
                                  char* __restrict__ dst1,
                                  const char* __restrict__ src0,
                                  const char* __restrict__ src1,
                                  const int* __restrict__ pages,
                                  const int* __restrict__ slots, int arenas,
                                  int B, long long P, int S,
                                  long long row_bytes) {
  const int b = blockIdx.x;
  const long long l = blockIdx.y;
  const long long dst = ((l * P + pages[b]) * S + slots[b]) * row_bytes;
  const long long src = (l * B + b) * row_bytes;
  const long long n = VEC ? row_bytes / 16 : row_bytes;
  for (long long i = threadIdx.x; i < arenas * n; i += blockDim.x) {
    const bool second = i >= n;
    const long long w = second ? i - n : i;
    char* d = (second ? dst1 : dst0) + dst;
    const char* s = (second ? src1 : src0) + src;
    if (VEC)
      reinterpret_cast<uint4*>(d)[w] = reinterpret_cast<const uint4*>(s)[w];
    else
      d[w] = s[w];
  }
}

// A short page list travels in the launch's parameters: no upload, no
// copy before the kernel can start (the serving path's init-on-free
// flushes a few pages to a few hundred).
constexpr int kInlineRows = 512;
struct RowList {
  int idx[kInlineRows];
};

// grid (n, L, arenas): arena z's [l, row i] <- the 32-bit pattern,
// repeated (arena 0 is dst0, arena 1 dst1); row i is dst_idx[i], or
// rows.idx[i] when dst_idx is null.  MODE 0: 16-byte words; 1: 4-byte
// words; 2: bytes (rows not a multiple of 4 bytes long).
template <int MODE>
__global__ void init_rows_kernel(char* __restrict__ dst0,
                                 char* __restrict__ dst1,
                                 const int* __restrict__ dst_idx,
                                 const RowList rows, long long dst_rows,
                                 long long row_bytes, unsigned int pattern) {
  const int i = blockIdx.x;
  const long long l = blockIdx.y;
  const long long r = dst_idx ? dst_idx[i] : rows.idx[i];
  char* row = (blockIdx.z ? dst1 : dst0) + (l * dst_rows + r) * row_bytes;
  if (MODE == 0) {
    uint4 v = make_uint4(pattern, pattern, pattern, pattern);
    uint4* d = reinterpret_cast<uint4*>(row);
    long long n = row_bytes / 16;
    for (long long k = threadIdx.x; k < n; k += blockDim.x) d[k] = v;
  } else if (MODE == 1) {
    unsigned int* d = reinterpret_cast<unsigned int*>(row);
    long long n = row_bytes / 4;
    for (long long k = threadIdx.x; k < n; k += blockDim.x) d[k] = pattern;
  } else {
    for (long long k = threadIdx.x; k < row_bytes; k += blockDim.x)
      row[k] = static_cast<char>((pattern >> (8 * (k & 3))) & 0xFF);
  }
}

// the bulk route: a copy block moves 4 tiles of 16 KiB, a fill block
// stores one; buffers of 1 MiB or more take it
constexpr long long kCopyTile = 16 * 1024;
constexpr int kCopyTilesPerBlock = 4;
constexpr long long kFillTile = 16 * 1024;
constexpr int kFillTilesPerBlock = 1;
constexpr long long kBulkMinBytes = 1 << 20;
static_assert(kCopyTile % 16 == 0 && kFillTile % 16 == 0,
              "bulk tiles are whole 16-byte words");
static_assert(kCopyTile * kCopyTilesPerBlock <= 227 * 1024 &&
              kFillTile <= 227 * 1024, "a block's tiles fit shared memory");

// the bytes of tile t of a body of `body` bytes in tiles of `tile`
__device__ __forceinline__ uint32_t tile_bytes(long long body,
                                               long long tile, long long t) {
  const long long left = body - t * tile;
  return static_cast<uint32_t>(left < tile ? left : tile);
}

// dst[0:nbytes) <- src[0:nbytes).  MODE 0: bytes, grid-stride; 1:
// 16-byte words, grid-stride, then a byte tail; 2: bulk, as the note at
// the top says, the body starting at byte `head` (src and dst are both
// 16-byte aligned there).
template <int MODE>
__global__ void copy_flat_kernel(char* __restrict__ dst,
                                 const char* __restrict__ src,
                                 long long nbytes, long long head) {
  if constexpr (MODE == 2) {
    extern __shared__ __align__(128) unsigned char ring[];
    __shared__ __align__(8) uint64_t full[kCopyTilesPerBlock];
    const long long body = (nbytes - head) & ~15LL;
    if (blockIdx.x == 0) {
      // the ragged head and tail: under 16 bytes each
      for (long long k = threadIdx.x; k < head; k += blockDim.x)
        dst[k] = src[k];
      for (long long k = head + body + threadIdx.x; k < nbytes;
           k += blockDim.x)
        dst[k] = src[k];
    }
    if (threadIdx.x != 0) return;
    for (int i = 0; i < kCopyTilesPerBlock; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const uint64_t policy = bulk_l2_policy();
    const long long tiles = (body + kCopyTile - 1) / kCopyTile;
    const long long t0 = static_cast<long long>(blockIdx.x) *
                         kCopyTilesPerBlock;
    const int n = static_cast<int>(
        tiles - t0 < kCopyTilesPerBlock ? tiles - t0 : kCopyTilesPerBlock);
    char* d = dst + head;
    const char* s = src + head;
    for (int i = 0; i < n; ++i)
      bulk_load(ring + i * kCopyTile, s + (t0 + i) * kCopyTile,
                tile_bytes(body, kCopyTile, t0 + i), &full[i], policy);
    for (int i = 0; i < n; ++i) {
      mbar_wait(&full[i], 0);
      fence_async_shared();
      bulk_store(d + (t0 + i) * kCopyTile, ring + i * kCopyTile,
                 tile_bytes(body, kCopyTile, t0 + i), policy);
    }
    bulk_wait_all();
  } else {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    long long done = 0;
    if (MODE == 1) {
      const uint4* s = reinterpret_cast<const uint4*>(src);
      uint4* d = reinterpret_cast<uint4*>(dst);
      const long long n = nbytes / 16;
      for (long long k = t; k < n; k += stride) d[k] = s[k];
      done = n * 16;
    }
    for (long long k = done + t; k < nbytes; k += stride) dst[k] = src[k];
  }
}

__device__ __forceinline__ char pattern_byte(unsigned int pattern,
                                             long long k) {
  return static_cast<char>((pattern >> (8 * (k & 3))) & 0xFF);
}

// dst[0:nbytes) <- the 32-bit pattern, repeated.  MODE as for the copy.
template <int MODE>
__global__ void fill_flat_kernel(char* __restrict__ dst, long long nbytes,
                                 unsigned int pattern, long long head) {
  if constexpr (MODE == 2) {
    extern __shared__ __align__(128) unsigned char tile[];
    const long long body = (nbytes - head) & ~15LL;
    // the body starts at byte `head`: rotate the pattern to its phase
    const int rot = static_cast<int>(head & 3);
    const unsigned int w =
        rot ? (pattern >> (8 * rot)) | (pattern << (32 - 8 * rot)) : pattern;
    const uint4 v = make_uint4(w, w, w, w);
    for (long long k = threadIdx.x; k < kFillTile / 16; k += blockDim.x)
      reinterpret_cast<uint4*>(tile)[k] = v;
    fence_async_shared();
    __syncthreads();
    if (blockIdx.x == 0) {
      for (long long k = threadIdx.x; k < head; k += blockDim.x)
        dst[k] = pattern_byte(pattern, k);
      for (long long k = head + body + threadIdx.x; k < nbytes;
           k += blockDim.x)
        dst[k] = pattern_byte(pattern, k);
    }
    if (threadIdx.x != 0) return;
    const uint64_t policy = bulk_l2_policy();
    const long long tiles = (body + kFillTile - 1) / kFillTile;
    const long long t0 = static_cast<long long>(blockIdx.x) *
                         kFillTilesPerBlock;
    for (long long t = t0; t < tiles && t < t0 + kFillTilesPerBlock; ++t)
      bulk_store(dst + head + t * kFillTile, tile,
                 tile_bytes(body, kFillTile, t), policy);
    bulk_wait_all();
  } else {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    long long done = 0;
    if (MODE == 1) {
      const uint4 v = make_uint4(pattern, pattern, pattern, pattern);
      uint4* d = reinterpret_cast<uint4*>(dst);
      const long long n = nbytes / 16;
      for (long long k = t; k < n; k += stride) d[k] = v;
      done = n * 16;
    }
    for (long long k = done + t; k < nbytes; k += stride)
      dst[k] = pattern_byte(pattern, k);
  }
}

bool aligned16(const void* a, const void* b, long long row_bytes) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           static_cast<uintptr_t>(row_bytes)) & 15) == 0;
}

constexpr int kThreads = 256;
// the bulk route's blocks: one thread issues, the rest write the fill's
// shared tile and the ragged bytes
constexpr int kBulkThreads = 128;
// flat kernels: at most this many blocks per SM, each thread then walks
// the buffer with a grid stride
constexpr int kFlatBlocksPerSM = 16;

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

int flat_blocks(long long work) {
  long long want = (work + kThreads - 1) / kThreads;
  long long cap = static_cast<long long>(sm_count()) * kFlatBlocksPerSM;
  if (want < 1) want = 1;
  return static_cast<int>(want < cap ? want : cap);
}

// the bulk route's blocks: one per `per` tiles of a body of `body` bytes
// in tiles of `tile`
long long bulk_blocks(long long body, long long tile, int per) {
  return ((body + tile - 1) / tile + per - 1) / per;
}

// the byte at which a bulk body starts (the first 16-byte boundary of
// both buffers), or -1 when the buffer takes the register route
long long bulk_head(const void* a, const void* b, long long nbytes) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(a) & 15;
  if (nbytes < kBulkMinBytes || (reinterpret_cast<uintptr_t>(b) & 15) != mis)
    return -1;
  return static_cast<long long>((16 - mis) & 15);
}

}  // namespace

// the B slot rows of each of `arenas` (1 or 2) arenas of one shape, in
// one launch; dst1 and src1 are read only when arenas is 2
extern "C" int rc_kv_scatter(void* dst0, void* dst1, const void* src0,
                             const void* src1, int arenas, const int* pages,
                             const int* slots, int L, int B, long long P,
                             int S, long long row_bytes, void* stream) {
  if (L <= 0 || B <= 0) return 0;
  if (arenas < 1 || arenas > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (arenas == 1) {
    dst1 = dst0;
    src1 = src0;
  }
  dim3 grid(B, L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* d0 = static_cast<char*>(dst0);
  char* d1 = static_cast<char*>(dst1);
  const char* s0 = static_cast<const char*>(src0);
  const char* s1 = static_cast<const char*>(src1);
  if (aligned16(dst0, src0, row_bytes) && aligned16(dst1, src1, 0))
    kv_scatter_kernel<true><<<grid, kThreads, 0, st>>>(
        d0, d1, s0, s1, pages, slots, arenas, B, P, S, row_bytes);
  else
    kv_scatter_kernel<false><<<grid, kThreads, 0, st>>>(
        d0, d1, s0, s1, pages, slots, arenas, B, P, S, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// the chunks a cluster holds at most: the wrapper stages a layer's batch
// of more through scratch (two direct launches) instead
extern "C" int rc_copy_cluster_chunks() {
  return page_cluster_chunks<CopyOp>();
}

// one copy over `arenas` (1 or 2) arenas in one launch (page_rows.cuh's
// launch_page_rows): desc, 6 values an arena (source base, destination
// base, source rows a layer, destination rows a layer, row bytes,
// layers).  The ops' rows: dev_idx on the card, or (dev_idx null)
// host_idx on the host, at most kInlinePairs ops (the wrapper's
// INLINE_PAIRS), passed in the launch; each 2n ints, sources then
// destinations.  identity: bit 0, op i reads row i; bit 1, it writes row
// i.  route 0: direct; 1: cluster (the wrapper picks it when a
// destination is another op's source and the batch fits).
extern "C" int rc_copy_pages(const long long* desc, int arenas,
                             const int* dev_idx, const int* host_idx, int n,
                             int identity, int route, void* stream) {
  return launch_page_rows<CopyOp>(desc, arenas, dev_idx, host_idx, n,
                                  identity, route, stream);
}

// the same rows of each of `arenas` (1 or 2) arenas of one shape, in one
// launch (dst1 is written only when arenas is 2).  rows: dst_idx on the
// device, or (dst_idx null) host_idx on the host, at most kInlineRows of
// them (the wrapper's INLINE_ROWS), passed in the launch
extern "C" int rc_init_rows(void* dst0, void* dst1, int arenas,
                            const int* dst_idx, const int* host_idx,
                            long long dst_rows, int n, int L,
                            long long row_bytes, unsigned int pattern,
                            void* stream) {
  if (n <= 0 || L <= 0) return 0;
  if (arenas < 1 || arenas > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (arenas == 1) dst1 = dst0;
  RowList rows;
  if (dst_idx == nullptr) {
    if (host_idx == nullptr || n > kInlineRows)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < n; ++i) rows.idx[i] = host_idx[i];
  }
  dim3 grid(n, L, arenas);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* d0 = static_cast<char*>(dst0);
  char* d1 = static_cast<char*>(dst1);
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst0) |
                      reinterpret_cast<uintptr_t>(dst1) |
                      static_cast<uintptr_t>(row_bytes);
  if ((a & 15) == 0)
    init_rows_kernel<0><<<grid, kThreads, 0, st>>>(d0, d1, dst_idx, rows,
                                                   dst_rows, row_bytes,
                                                   pattern);
  else if ((a & 3) == 0)
    init_rows_kernel<1><<<grid, kThreads, 0, st>>>(d0, d1, dst_idx, rows,
                                                   dst_rows, row_bytes,
                                                   pattern);
  else
    init_rows_kernel<2><<<grid, kThreads, 0, st>>>(d0, d1, dst_idx, rows,
                                                   dst_rows, row_bytes,
                                                   pattern);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rc_copy_flat(const void* src, void* dst, long long nbytes,
                            void* stream) {
  if (nbytes <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const long long head = bulk_head(src, dst, nbytes);
  if (head >= 0) {
    constexpr int smem = static_cast<int>(kCopyTilesPerBlock * kCopyTile);
    static const cudaError_t attr = cudaFuncSetAttribute(
        copy_flat_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const long long blocks = bulk_blocks((nbytes - head) & ~15LL, kCopyTile,
                                         kCopyTilesPerBlock);
    copy_flat_kernel<2><<<blocks, kBulkThreads, smem, st>>>(d, s, nbytes,
                                                            head);
  } else if (aligned16(src, dst, 0)) {
    copy_flat_kernel<1><<<flat_blocks(nbytes / 16), kThreads, 0, st>>>(
        d, s, nbytes, 0);
  } else {
    copy_flat_kernel<0><<<flat_blocks(nbytes), kThreads, 0, st>>>(
        d, s, nbytes, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rc_fill_flat(void* dst, long long nbytes, unsigned int pattern,
                            void* stream) {
  if (nbytes <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* d = static_cast<char*>(dst);
  const long long head = bulk_head(dst, dst, nbytes);
  if (head >= 0) {
    constexpr int smem = static_cast<int>(kFillTile);
    static const cudaError_t attr = cudaFuncSetAttribute(
        fill_flat_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const long long blocks = bulk_blocks((nbytes - head) & ~15LL, kFillTile,
                                         kFillTilesPerBlock);
    fill_flat_kernel<2><<<blocks, kBulkThreads, smem, st>>>(d, nbytes,
                                                            pattern, head);
  } else if (aligned16(dst, dst, 0)) {
    fill_flat_kernel<1><<<flat_blocks(nbytes / 16), kThreads, 0, st>>>(
        d, nbytes, pattern, 0);
  } else {
    fill_flat_kernel<0><<<flat_blocks(nbytes), kThreads, 0, st>>>(
        d, nbytes, pattern, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
