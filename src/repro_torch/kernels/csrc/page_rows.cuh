// Layer-batched page-row operations over one arena or a pair, for Hopper
// (sm_90a): the kernels the RowClone page copy (rowclone.cu,
// rc_copy_pages) and the Ambit page ops (ambit.cu, am_page_rows) share,
// and the bulk-copy PTX both files use.
//
// What one launch computes, for every layer l < layers of each arena and
// every op i < n of one op list:
//   COPY:  dst[l, d_i] <- src[l, s_i]
//   AND:   dst[l, d_i] <- src[l, s_i] & dst[l, d_i]
//   OR:    dst[l, d_i] <- src[l, s_i] | dst[l, d_i]
//   NOT:   dst[l, d_i] <- ~src[l, s_i]
// on raw bytes (any dtype), every op reading the arena as it was before
// the launch.  Each arena has its own bases, rows a layer, row bytes and
// layers (a (K, V) pair of one shape, or the conv and SSD state arenas,
// whose rows differ), so the pair's ops cost one launch.  Up to
// kInlinePairs (src, dst) pairs travel in the launch's by-value
// parameters; a longer list is read from the card.  Destinations are
// distinct (the wrappers make them so).
//
// What bounds them on an H100: bytes (a logic instruction a word at
// most).  Rows are cut into kChunk pieces, one block a piece, so a 32 KiB
// KV page and a 2 MiB SSD row alike fill the card.
//
// Two routes, picked by the wrapper on the host:
//   direct  - no op reads another op's destination: block (x, l) moves
//             chunk x of layer l, each thread's loads all in flight
//             before its stores;
//   cluster - some op reads a page another op writes: GPU blocks run in
//             no order, so one thread-block cluster per (layer, arena)
//             stages the layer's sources in its blocks' shared memory
//             (TMA bulk loads on one mbarrier a block), meets at one
//             cluster barrier, and only then writes (COPY: bulk stores
//             from shared memory; AND/OR/NOT: each thread combines the
//             staged source with the destination it reads, which no
//             other op writes).  One read and one write of each row, no
//             scratch.
// A layer's batch past the cluster's capacity, or rows that are not
// 16-byte aligned, are staged through scratch by the wrapper instead:
// two direct launches, a COPY gather of the sources into scratch rows
// (identity bit 1: op i writes row i) and the op from those rows
// (identity bit 0: op i reads row i).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --- the bulk route's PTX (sm_90) ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the L2 policy of every bulk operation of the flat movers: evict first
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

// --- the ops ------------------------------------------------------------

// Each op: apply(source word, destination word) for 16-byte words and
// for bytes; kReadsDst: whether the old destination is an operand;
// kBulkStore: the cluster route writes straight from shared memory.
struct CopyOp {
  static constexpr bool kReadsDst = false;
  static constexpr bool kBulkStore = true;
  __device__ static uint4 apply(uint4 s, uint4) { return s; }
  __device__ static unsigned char apply(unsigned char s, unsigned char) {
    return s;
  }
};

struct AndOp {
  static constexpr bool kReadsDst = true;
  static constexpr bool kBulkStore = false;
  __device__ static uint4 apply(uint4 s, uint4 d) {
    return make_uint4(s.x & d.x, s.y & d.y, s.z & d.z, s.w & d.w);
  }
  __device__ static unsigned char apply(unsigned char s, unsigned char d) {
    return s & d;
  }
};

struct OrOp {
  static constexpr bool kReadsDst = true;
  static constexpr bool kBulkStore = false;
  __device__ static uint4 apply(uint4 s, uint4 d) {
    return make_uint4(s.x | d.x, s.y | d.y, s.z | d.z, s.w | d.w);
  }
  __device__ static unsigned char apply(unsigned char s, unsigned char d) {
    return s | d;
  }
};

struct NotOp {
  static constexpr bool kReadsDst = false;
  static constexpr bool kBulkStore = false;
  __device__ static uint4 apply(uint4 s, uint4) {
    return make_uint4(~s.x, ~s.y, ~s.z, ~s.w);
  }
  __device__ static unsigned char apply(unsigned char s, unsigned char) {
    return static_cast<unsigned char>(~s);
  }
};

// --- the launch's plan --------------------------------------------------

constexpr int kPageThreads = 256;      // a direct block
constexpr int kPageBulkThreads = 128;  // a cluster block
// the bytes of a row one block moves on the direct route, and one bulk
// tile on the cluster route
constexpr long long kChunk = 16 * 1024;
constexpr int kWordsPerThread = static_cast<int>(kChunk / 16 / kPageThreads);
static_assert(kWordsPerThread * 16 * kPageThreads == kChunk,
              "a direct block's threads cover a chunk in whole words");
// (src, dst) pairs that travel in the launch's parameters: 2 KiB of
// indices, inside the 4 KiB kernel-parameter limit of every CUDA version
constexpr int kInlinePairs = 256;
// the cluster route: at most this many blocks a cluster, each staging at
// most kClusterBlockBytes of its layer's sources in shared memory
constexpr int kMaxCluster = 16;
constexpr long long kClusterBlockBytes = 128 * 1024;

// one arena of a launch: row r of layer l starts at base + (l * rows + r)
// * row_bytes on either side (the arena on both, or the arena and a
// scratch buffer on the staged route's two launches)
struct PageArena {
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
struct PagePlan {
  PageArena arena[2];
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
__device__ __forceinline__ Chunk chunk_of(const PagePlan& p,
                                          const PageArena& a, long long l,
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

// the direct route, grid (n * chunks of arena 0 [+ n * chunks of arena
// 1], max layers): block (x, l) serves chunk x of layer l of arena 0, or
// chunk x - n * chunks_0 of arena 1 (so a pair of unequal rows launches
// no idle blocks).  VEC: 16-byte words, a thread's loads all in flight
// before its stores; else bytes.
template <class Op, bool VEC>
__global__ void __launch_bounds__(kPageThreads)
    page_rows_kernel(const PagePlan p) {
  const long long first = p.n * p.arena[0].chunks;
  const bool second = blockIdx.x >= first;
  const PageArena a = second ? p.arena[1] : p.arena[0];
  const long long l = blockIdx.y;
  if (l >= a.layers) return;
  const Chunk c = chunk_of(p, a, l, blockIdx.x - (second ? first : 0));
  if (VEC) {
    const uint4* s = reinterpret_cast<const uint4*>(c.src);
    uint4* d = reinterpret_cast<uint4*>(c.dst);
    const int words = c.bytes / 16;
    uint4 v[kWordsPerThread];
    uint4 o[kWordsPerThread];
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      const int w = threadIdx.x + k * kPageThreads;
      if (w < words) {
        v[k] = s[w];
        o[k] = Op::kReadsDst ? d[w] : v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      const int w = threadIdx.x + k * kPageThreads;
      if (w < words) d[w] = Op::apply(v[k], o[k]);
    }
  } else {
    const unsigned char* s = reinterpret_cast<const unsigned char*>(c.src);
    unsigned char* d = reinterpret_cast<unsigned char*>(c.dst);
    for (int k = threadIdx.x; k < c.bytes; k += blockDim.x)
      d[k] = Op::apply(s[k], Op::kReadsDst ? d[k] : s[k]);
  }
}

// the cluster route, grid (C, max layers, arenas) in clusters of (C, 1,
// 1): cluster (l, a) holds layer l's whole batch of arena a.  Its n *
// chunks chunks are dealt out ceil(n * chunks / C) to a block; the
// block's thread 0 bulk-loads its chunks into shared memory (one
// mbarrier), every thread waits for them, every block of the cluster
// meets at one barrier, so every source of the layer has been read before
// any destination is written, and then the block writes its chunks.
// Rows and bases are 16-byte aligned.
template <class Op>
__global__ void __launch_bounds__(kPageBulkThreads)
    page_rows_cluster_kernel(const PagePlan p) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full;
  const PageArena a = blockIdx.z ? p.arena[1] : p.arena[0];
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
  }
  __syncthreads();  // the barrier is initialised before any thread waits
  if (t0 < t1) mbar_wait(&full, 0);
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;" ::: "memory");
  if (t0 >= t1) return;
  if (Op::kBulkStore) {
    if (threadIdx.x == 0) {
      for (long long t = t0; t < t1; ++t) {
        const Chunk c = chunk_of(p, a, l, t);
        bulk_store_tx(c.dst, stage + (t - t0) * kChunk, c.bytes);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      bulk_wait_all();
    }
    return;
  }
  for (long long t = t0; t < t1; ++t) {
    const Chunk c = chunk_of(p, a, l, t);
    const uint4* s = reinterpret_cast<const uint4*>(stage + (t - t0) * kChunk);
    uint4* d = reinterpret_cast<uint4*>(c.dst);
    const int words = c.bytes / 16;
    for (int w = threadIdx.x; w < words; w += blockDim.x)
      d[w] = Op::apply(s[w], Op::kReadsDst ? d[w] : s[w]);
  }
}

void page_cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                         dim3 grid, int cluster, size_t smem,
                         cudaStream_t st) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(kPageBulkThreads);
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
// holds one such cluster, else 8.  Also sets the kernel's attributes.
template <class Op>
int page_max_cluster() {
  static int size = 0;
  if (size == 0) {
    size = 8;
    cudaFuncSetAttribute(page_rows_cluster_kernel<Op>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kClusterBlockBytes));
    cudaFuncSetAttribute(page_rows_cluster_kernel<Op>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    page_cluster_config(&cfg, &attr, dim3(kMaxCluster), kMaxCluster,
                        kClusterBlockBytes, nullptr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters,
                                       page_rows_cluster_kernel<Op>,
                                       &cfg) == cudaSuccess &&
        clusters > 0)
      size = kMaxCluster;
    cudaGetLastError();  // a refused query leaves no error behind
  }
  return size;
}

// the chunks a cluster holds at most: the wrapper stages a layer's batch
// of more through scratch (two direct launches) instead
template <class Op>
int page_cluster_chunks() {
  return page_max_cluster<Op>() *
         static_cast<int>(kClusterBlockBytes / kChunk);
}

// One launch of `Op` over `arenas` (1 or 2) arenas.  desc: 6 values an
// arena (source base, destination base, source rows a layer, destination
// rows a layer, row bytes, layers).  The ops' rows: dev_idx on the card,
// or (dev_idx null) host_idx on the host, at most kInlinePairs ops,
// passed in the launch; each 2n ints, sources then destinations.
// identity: bit 0, op i reads row i; bit 1, it writes row i.  route 0:
// direct; 1: cluster.  Returns a cudaError_t.
template <class Op>
int launch_page_rows(const long long* desc, int arenas, const int* dev_idx,
                     const int* host_idx, int n, int identity, int route,
                     void* stream) {
  if (n <= 0) return 0;
  if (arenas < 1 || arenas > 2 || route < 0 || route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PagePlan plan;
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
    PageArena& a = plan.arena[z];
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
      page_rows_kernel<Op, true><<<grid, kPageThreads, 0, st>>>(plan);
    else
      page_rows_kernel<Op, false><<<grid, kPageThreads, 0, st>>>(plan);
    return static_cast<int>(cudaGetLastError());
  }
  // the cluster route: as many blocks a cluster as the card allows, up to
  // one a chunk, each staging ceil(chunks / C) of them
  const int most = page_max_cluster<Op>();
  const int cluster =
      static_cast<int>(most_chunks < most ? most_chunks : most);
  const long long per = (most_chunks + cluster - 1) / cluster;
  if (!vec || per * kChunk > kClusterBlockBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  page_cluster_config(&cfg, &attr,
                      dim3(cluster, static_cast<unsigned>(most_layers),
                           arenas),
                      cluster, static_cast<size_t>(per * kChunk), st);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, page_rows_cluster_kernel<Op>, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
