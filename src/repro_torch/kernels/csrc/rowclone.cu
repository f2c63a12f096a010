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
// real duplicates on the host before it launches.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

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

// --- the bulk route's PTX (sm_90) ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the L2 policy of every bulk operation: evict first
__device__ __forceinline__ uint64_t bulk_l2_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
}

// arrive on `bar` once, expecting `bytes` from the bulk loads that
// complete on it
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// global -> shared, completing `bytes` on `bar` (no arrival: one
// mbar_expect covers a block's loads), L2 policy left to the hardware
__device__ __forceinline__ void bulk_load_tx(void* smem, const void* gmem,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(smem)), "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global in the open bulk group, L2 policy left to the hardware
__device__ __forceinline__ void bulk_store_tx(void* gmem, const void* smem,
                                              uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
      ::"l"(gmem), "r"(smem_u32(smem)), "r"(bytes)
      : "memory");
}

// global -> shared, completing `bytes` on `bar`
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  mbar_expect(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      ::"r"(smem_u32(smem)), "l"(gmem), "r"(bytes), "r"(smem_u32(bar)),
      "l"(policy)
      : "memory");
}

// shared -> global, one bulk group
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;"
      ::"l"(gmem), "r"(smem_u32(smem)), "r"(bytes), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wait until every bulk group has completed its writes
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

// --- the page copy (rows 2 and 13) --------------------------------------

// the bytes of a row one block moves on the direct route, and one bulk
// tile on the cluster route
constexpr long long kChunk = 16 * 1024;
constexpr int kWordsPerThread = static_cast<int>(kChunk / 16 / kThreads);
static_assert(kWordsPerThread * 16 * kThreads == kChunk,
              "a direct block's threads cover a chunk in whole words");
// (src, dst) pairs that travel in the launch's parameters: 2 KiB of
// indices, inside the 4 KiB kernel-parameter limit of every CUDA version
constexpr int kInlinePairs = 256;
// the cluster route: at most this many blocks a cluster, each staging at
// most kClusterBlockBytes of its layer's sources in shared memory
constexpr int kMaxCluster = 16;
constexpr long long kClusterBlockBytes = 128 * 1024;

// one arena of a copy: row r of layer l starts at base + (l * rows + r) *
// row_bytes on either side (the arena on both, or the arena and a
// scratch buffer on the staged route's two launches)
struct CopyArena {
  const char* src;
  char* dst;
  long long src_rows;
  long long dst_rows;
  long long row_bytes;
  long long chunks;  // ceil(row_bytes / kChunk)
  long long layers;
};

// the whole launch, by value: no upload precedes it for up to
// kInlinePairs ops
struct CopyPlan {
  CopyArena arena[2];
  const int* dev_idx;  // 2n ints on the card, or null: idx below
  int n;
  int identity;        // bit 0: op i reads row i; bit 1: it writes row i
  int idx[2 * kInlinePairs];  // sources at [0, n), destinations at [n, 2n)
};

struct Chunk {
  const char* src;
  char* dst;
  int bytes;
};

// chunk t (op t / chunks, its (t % chunks)-th kChunk bytes) of layer l
__device__ __forceinline__ Chunk chunk_of(const CopyPlan& p,
                                          const CopyArena& a, long long l,
                                          long long t) {
  const long long i = t / a.chunks;
  const long long off = (t - i * a.chunks) * kChunk;
  const long long sr =
      (p.identity & 1) ? i : (p.dev_idx ? p.dev_idx[i] : p.idx[i]);
  const long long dr = (p.identity & 2)
                           ? i
                           : (p.dev_idx ? p.dev_idx[p.n + i] : p.idx[p.n + i]);
  const long long left = a.row_bytes - off;
  return {a.src + (l * a.src_rows + sr) * a.row_bytes + off,
          a.dst + (l * a.dst_rows + dr) * a.row_bytes + off,
          static_cast<int>(left < kChunk ? left : kChunk)};
}

// the direct route (no destination is another op's source), grid
// (n * chunks of arena 0 [+ n * chunks of arena 1], max layers): block
// (x, l) moves chunk x of layer l of arena 0, or chunk x - n * chunks_0
// of arena 1 (so a pair of unequal rows, a conv row of 26 KB beside an
// SSD row of 2 MiB, launches no idle blocks).  VEC: 16-byte words, a
// thread's loads all in flight before its stores; else bytes.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    copy_pages_kernel(const CopyPlan p) {
  const long long first = p.n * p.arena[0].chunks;
  const bool second = blockIdx.x >= first;
  const CopyArena a = second ? p.arena[1] : p.arena[0];
  const long long l = blockIdx.y;
  if (l >= a.layers) return;
  const Chunk c = chunk_of(p, a, l, blockIdx.x - (second ? first : 0));
  if (VEC) {
    const uint4* s = reinterpret_cast<const uint4*>(c.src);
    uint4* d = reinterpret_cast<uint4*>(c.dst);
    const int words = c.bytes / 16;
    uint4 v[kWordsPerThread];
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      const int w = threadIdx.x + k * kThreads;
      if (w < words) v[k] = s[w];
    }
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      const int w = threadIdx.x + k * kThreads;
      if (w < words) d[w] = v[k];
    }
  } else {
    for (int k = threadIdx.x; k < c.bytes; k += blockDim.x) c.dst[k] = c.src[k];
  }
}

// the cluster route (some destination is another op's source), grid
// (C, max layers, arenas) in clusters of (C, 1, 1): cluster (l, a) holds
// layer l's whole batch of arena a.  Its n * chunks chunks are dealt out
// ceil(n * chunks / C) to a block; the block's thread 0 bulk-loads its
// chunks into shared memory (one mbarrier), every block of the cluster
// meets at one barrier, so every source of the layer has been read before
// any destination is written, and thread 0 then bulk-stores each chunk
// to its destination.  Rows and bases are 16-byte aligned.
__global__ void __launch_bounds__(kBulkThreads)
    copy_pages_cluster_kernel(const CopyPlan p) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full;
  const CopyArena a = blockIdx.z ? p.arena[1] : p.arena[0];
  const long long l = blockIdx.y;
  // the whole cluster leaves together: its blocks share (l, a)
  if (l >= a.layers) return;
  const long long total = p.n * a.chunks;
  const long long per = (total + gridDim.x - 1) / gridDim.x;
  const long long t0 = blockIdx.x * per;
  const long long t1 = t0 + per < total ? t0 + per : total;
  if (threadIdx.x == 0 && t0 < t1) {
    mbar_init(&full);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    uint32_t bytes = 0;
    for (long long t = t0; t < t1; ++t) bytes += chunk_of(p, a, l, t).bytes;
    mbar_expect(&full, bytes);
    for (long long t = t0; t < t1; ++t) {
      const Chunk c = chunk_of(p, a, l, t);
      bulk_load_tx(stage + (t - t0) * kChunk, c.src, c.bytes, &full);
    }
    mbar_wait(&full, 0);
  }
  __syncthreads();
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;" ::: "memory");
  if (threadIdx.x == 0 && t0 < t1) {
    for (long long t = t0; t < t1; ++t) {
      const Chunk c = chunk_of(p, a, l, t);
      bulk_store_tx(c.dst, stage + (t - t0) * kChunk, c.bytes);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    bulk_wait_all();
  }
}

void cluster_launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           dim3 grid, int cluster, size_t smem,
                           cudaStream_t st) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(kBulkThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// the largest cluster the card schedules with every block at
// kClusterBlockBytes: kMaxCluster (beyond the portable 8) when the card
// holds one such cluster, else 8
int max_cluster() {
  static int size = 0;
  if (size == 0) {
    size = 8;
    cudaFuncSetAttribute(copy_pages_cluster_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kClusterBlockBytes));
    cudaFuncSetAttribute(copy_pages_cluster_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_launch_config(&cfg, &attr, dim3(kMaxCluster), kMaxCluster,
                          kClusterBlockBytes, nullptr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, copy_pages_cluster_kernel,
                                       &cfg) == cudaSuccess &&
        clusters > 0)
      size = kMaxCluster;
    cudaGetLastError();  // a refused query leaves no error behind
  }
  return size;
}

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
  return max_cluster() * static_cast<int>(kClusterBlockBytes / kChunk);
}

// one copy over `arenas` (1 or 2) arenas in one launch.  desc: 6 values an
// arena (source base, destination base, source rows a layer, destination
// rows a layer, row bytes, layers).  The ops' rows: dev_idx on the card,
// or (dev_idx null) host_idx on the host, at most kInlinePairs ops (the
// wrapper's INLINE_PAIRS), passed in the launch; each 2n ints, sources
// then destinations.  identity: bit 0, op i reads row i; bit 1, it writes
// row i.  route 0: direct; 1: cluster (the wrapper picks it when a
// destination is another op's source and the batch fits).
extern "C" int rc_copy_pages(const long long* desc, int arenas,
                             const int* dev_idx, const int* host_idx, int n,
                             int identity, int route, void* stream) {
  if (n <= 0) return 0;
  if (arenas < 1 || arenas > 2 || route < 0 || route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CopyPlan plan;
  plan.dev_idx = dev_idx;
  plan.n = n;
  plan.identity = identity;
  if (dev_idx == nullptr) {
    if (host_idx == nullptr || n > kInlinePairs)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < 2 * n; ++i) plan.idx[i] = host_idx[i];
  }
  long long most_chunks = 0, all_chunks = 0, most_layers = 0;
  uintptr_t align = 0;
  for (int z = 0; z < 2; ++z) {
    const long long* d = desc + 6 * (z < arenas ? z : 0);
    CopyArena& a = plan.arena[z];
    a.src = reinterpret_cast<const char*>(d[0]);
    a.dst = reinterpret_cast<char*>(d[1]);
    a.src_rows = d[2];
    a.dst_rows = d[3];
    a.row_bytes = d[4];
    a.layers = d[5];
    a.chunks = (a.row_bytes + kChunk - 1) / kChunk;
    if (a.row_bytes <= 0 || a.layers <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    most_chunks = n * a.chunks > most_chunks ? n * a.chunks : most_chunks;
    if (z < arenas) all_chunks += n * a.chunks;
    most_layers = a.layers > most_layers ? a.layers : most_layers;
    align |= static_cast<uintptr_t>(d[0]) | static_cast<uintptr_t>(d[1]) |
             static_cast<uintptr_t>(a.row_bytes);
  }
  if (most_layers > 65535 || all_chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (align & 15) == 0;
  if (route == 0) {
    dim3 grid(static_cast<unsigned>(all_chunks),
              static_cast<unsigned>(most_layers));
    if (vec)
      copy_pages_kernel<true><<<grid, kThreads, 0, st>>>(plan);
    else
      copy_pages_kernel<false><<<grid, kThreads, 0, st>>>(plan);
    return static_cast<int>(cudaGetLastError());
  }
  // the cluster route: as many blocks a cluster as the card allows, up to
  // one a chunk, each staging ceil(chunks / C) of them
  const int cluster = static_cast<int>(
      most_chunks < max_cluster() ? most_chunks : max_cluster());
  const long long per = (most_chunks + cluster - 1) / cluster;
  if (!vec || per * kChunk > kClusterBlockBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch_config(&cfg, &attr,
                        dim3(cluster, static_cast<unsigned>(most_layers),
                             arenas),
                        cluster, static_cast<size_t>(per * kChunk), st);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, copy_pages_cluster_kernel, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
