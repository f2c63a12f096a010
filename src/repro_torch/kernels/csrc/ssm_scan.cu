// SSM state-row scatter for the paged state arena, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel in
// src/repro/kernels/ssm_scan/ssm_scan.py:
//   ss_state_scatter  <- state_scatter  (ssm_scan.py:35; one arena, or
//                        the conv/SSD pair in one launch)
//
// What it computes, on the raw bytes of each arena's (L, R, row) view:
//   arena[l, rows[b]] <- new[l, b]   for every layer l and batch entry b
// L is groups x Mamba sublayers: the whole depth of the model writes in
// one launch, and a step's conv window and SSD state (rows of 26,112 B
// of bf16 and 2 MiB of float32 at mamba2-1.3b) write in the same one:
// each arena has its own bases, rows a layer, row bytes and layers, as
// in rc_kv_scatter and rc_copy_pages.  Duplicate rows must carry
// identical payloads (batch pad rows); their writes land in any order.
//
// What bounds it on an H100: bytes.  It reads `new` once and writes as
// many bytes into the arena; the arena is never read.  At mamba2-1.3b's
// decode shape (48 layers, 8 rows) the SSD rows move 805 MB each way,
// 0.48 ms at 3.35 TB/s, the conv rows 10 MB each way, 6 us.
//
// Design: the work is split by bytes, not by row.  Every row of both
// arenas is cut into kChunk pieces and the grid runs over the pieces of
// both arenas at once (grid x: the first arena's n * chunks pieces,
// then the second's; grid y: the layer), so the 26 KB conv rows take 7
// blocks each beside the SSD rows' 512 and no block idles.  Each of a
// block's 256 threads moves one 16-byte word (a byte path serves rows or
// bases that are not 16-byte aligned): on the card, 4 KiB pieces of one
// word a thread wrote the pair in 0.510 ms, 8 KiB of two words 0.513
// and 16 KiB of four 0.516 (chip_smoke phase 2's shape).  The source
// and destination never overlap, so no staging through shared memory is
// needed (a TMA round trip would add a pass through shared memory to
// the same bytes).  The row list is an int32
// array on the card (a captured step's static buffer, which a graph
// replays) or, for up to kInlineRows rows known on the host (the eager
// ssm_state_write flush), the launch's own parameters.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 4 * 1024;
static_assert(16 * kThreads == kChunk,
              "a block's threads cover a chunk, one 16-byte word each");
// rows that travel in the launch's parameters: 2 KiB, inside the 4 KiB
// kernel-parameter limit
constexpr int kInlineRows = 512;

// one arena of a launch: arena row r of layer l starts at
// dst + (l * rows + r) * row_bytes, batch entry b's new row at
// src + (l * n + b) * row_bytes
struct StateArena {
  char* dst;
  const char* src;
  long long rows;
  long long row_bytes;
  long long chunks;  // ceil(row_bytes / kChunk)
  long long layers;
};

struct ScatterPlan {
  StateArena arena[2];
  const int* dev_rows;  // n ints on the card, or null: rows below
  int n;
  int rows[kInlineRows];
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    state_scatter_kernel(const ScatterPlan p) {
  const long long first = p.n * p.arena[0].chunks;
  const bool second = blockIdx.x >= first;
  const StateArena a = second ? p.arena[1] : p.arena[0];
  const long long l = blockIdx.y;
  if (l >= a.layers) return;
  const long long t = blockIdx.x - (second ? first : 0);
  const long long b = t / a.chunks;
  const long long off = (t - b * a.chunks) * kChunk;
  const long long r = p.dev_rows ? p.dev_rows[b] : p.rows[b];
  const long long left = a.row_bytes - off;
  const int bytes = static_cast<int>(left < kChunk ? left : kChunk);
  const char* s = a.src + (l * p.n + b) * a.row_bytes + off;
  char* d = a.dst + (l * a.rows + r) * a.row_bytes + off;
  if (VEC) {
    if (static_cast<int>(threadIdx.x) < bytes / 16)
      reinterpret_cast<uint4*>(d)[threadIdx.x] =
          reinterpret_cast<const uint4*>(s)[threadIdx.x];
  } else {
    for (int k = threadIdx.x; k < bytes; k += kThreads) d[k] = s[k];
  }
}

}  // namespace

// One launch over `arenas` (1 or 2) arenas.  desc: 5 values an arena
// (arena base, new base, arena rows a layer, row bytes, layers); new is
// (layers, n, row bytes).  rows: dev_rows on the card, or (dev_rows
// null) host_rows on the host, at most kInlineRows of them (the
// wrapper's INLINE_ROWS), passed in the launch; each in [0, rows).
extern "C" int ss_state_scatter(const long long* desc, int arenas,
                                const int* dev_rows, const int* host_rows,
                                int n, void* stream) {
  if (n <= 0) return 0;
  if (arenas < 1 || arenas > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  ScatterPlan plan;
  plan.dev_rows = dev_rows;
  plan.n = n;
  if (dev_rows == nullptr) {
    if (host_rows == nullptr || n > kInlineRows)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < n; ++i) plan.rows[i] = host_rows[i];
  }
  long long all_chunks = 0, most_layers = 0;
  uintptr_t align = 0;
  for (int z = 0; z < 2; ++z) {
    const long long* d = desc + 5 * (z < arenas ? z : 0);
    StateArena& a = plan.arena[z];
    a.dst = reinterpret_cast<char*>(d[0]);
    a.src = reinterpret_cast<const char*>(d[1]);
    a.rows = d[2];
    a.row_bytes = d[3];
    a.layers = d[4];
    a.chunks = (a.row_bytes + kChunk - 1) / kChunk;
    if (a.row_bytes <= 0 || a.layers <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (z < arenas) all_chunks += n * a.chunks;
    most_layers = a.layers > most_layers ? a.layers : most_layers;
    align |= static_cast<uintptr_t>(d[0]) | static_cast<uintptr_t>(d[1]) |
             static_cast<uintptr_t>(a.row_bytes);
  }
  if (arenas == 1) plan.arena[1].layers = 0;  // no second arena's blocks
  if (most_layers > 65535 || all_chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(all_chunks),
            static_cast<unsigned>(most_layers));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((align & 15) == 0)
    state_scatter_kernel<true><<<grid, kThreads, 0, st>>>(plan);
  else
    state_scatter_kernel<false><<<grid, kThreads, 0, st>>>(plan);
  return static_cast<int>(cudaGetLastError());
}
