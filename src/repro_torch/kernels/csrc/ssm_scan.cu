// SSM state-row scatter for the paged state arena, and the decode
// step's SSD state update on arena rows, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel in
// src/repro/kernels/ssm_scan/ssm_scan.py:
//   ss_state_scatter  <- state_scatter  (ssm_scan.py:35; one arena, or
//                        the conv/SSD pair in one launch)
// and adds one with no Pallas counterpart (XLA fuses the JAX package's
// decode step, src/repro/models/ssm.py:158-163, inside its jitted
// round; PyTorch ran it as about eleven passes over the state):
//   ss_ssd_step       <- the SSD recurrence of one decode token (below)
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
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

// ---------------------------------------------------------------------
// ss_ssd_step: one decode token's SSD recurrence on arena rows.
//
// What it computes, for every batch row b and head h of one Mamba
// sublayer (S a row's old state, (h, p, n) float32 in the arena):
//   r            = rowmap[b]
//   new_q[p, n]  = S_q[p, n] * exp(dt[q, h] * A[h])
//                  + B[q, n] * (dt[q, h] * x[q, h, p])   (state of row q)
//   out[b]       = alive[r] ? new_r : S_r   (new_r with no alive mask)
//   y[b, h, p]   = sum_n C[b, n] * new_b[p, n]
// with S_q = arena[rows[q]].  That is the gather, the models' SSD step,
// the alive mask and the row fold the engine ran as PyTorch ops: a pad
// row b (rowmap[b] = 0 != b) writes row 0's state, bit for bit, and its
// own y.  Every state value is rounded as the ops round it (separate
// __fmul_rn / __fadd_rn, so nvcc cannot contract them into an FMA; expf,
// no fast math), so `out` equals the ops' result bit for bit; y's sum
// over n runs in another order than cuBLAS's float32 product.
//
// What bounds it on an H100: bytes.  Each state row is read once and
// written once (mamba2-1.3b: 64 heads x 64 x 128 float32, 2 MiB a row;
// 64 rows are 268 MB, 0.080 ms at 3.35 TB/s); x, dt, B, C and y are
// under 0.5% of that.
//
// Design: one block of 256 threads a (row, head) tile of P x N float32
// (32 KiB at p 64, n 128).  A state row p of N floats is N / 4 16-byte
// words; up to 32 lanes share one (more words take two a lane), so a
// warp instruction moves 512 contiguous bytes and the sum over n is a
// shuffle within the lanes of the row.  Each thread first loads kUnroll
// words of as many rows (128 B in flight a thread, the whole tile a
// block), then computes and stores them with streaming hints: nothing
// is read again, and no intermediate goes to device memory.  A pad row
// reads two tiles (row 0's for the state it writes, its own for y).
// ---------------------------------------------------------------------

namespace {

constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kUnroll = 8;

struct SsdStep {
  const float* arena;          // (R, H, P, N): one sublayer's SSD rows
  const int* rows;             // (Bp,) arena rows
  const long long* rowmap;     // (Bp,) the row whose state out[b] holds
  const unsigned char* alive;  // (Bp,) bool, or null
  const void* x;               // (Bp, H, P), rows x_stride apart
  const float* dt;             // (Bp, H)
  const float* A;              // (H,)
  const void* B;               // (Bp, N), rows b_stride apart
  const void* C;               // (Bp, N), rows c_stride apart
  float* out;                  // (Bp, H, P, N)
  float* y;                    // (Bp, H, P)
  long long x_stride, b_stride, c_stride;
  int heads, P;
};

__device__ __forceinline__ float step_f(float v) { return v; }
__device__ __forceinline__ float step_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 step_new(float4 s, float dA, const float* bn,
                                           float dtx) {
  float4 o;
  o.x = __fadd_rn(__fmul_rn(s.x, dA), __fmul_rn(bn[0], dtx));
  o.y = __fadd_rn(__fmul_rn(s.y, dA), __fmul_rn(bn[1], dtx));
  o.z = __fadd_rn(__fmul_rn(s.z, dA), __fmul_rn(bn[2], dtx));
  o.w = __fadd_rn(__fmul_rn(s.w, dA), __fmul_rn(bn[3], dtx));
  return o;
}

template <int N, typename T>
__global__ void __launch_bounds__(kStepThreads)
    ssd_step_kernel(const SsdStep p) {
  constexpr int kWords = N / 4;                      // 16-byte words a row
  constexpr int kLanes = kWords < 32 ? kWords : 32;  // lanes a state row
  constexpr int kPer = kWords / kLanes;              // words a lane
  constexpr int kRowsWarp = 32 / kLanes;
  constexpr int kRowsStep = kRowsWarp * kStepWarps;
  static_assert(kWords % kLanes == 0 && 32 % kLanes == 0, "N: 4 x 2^k");
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int H = p.heads, P = p.P;
  const int lane = threadIdx.x % 32;
  const int sub = (threadIdx.x / 32) * kRowsWarp + lane / kLanes;
  const int col = lane % kLanes;
  const long long tile = static_cast<long long>(P) * N;
  const long long r = p.rowmap[b];
  // pass 0: the state of row r, written to out[b] (and y[b] when r == b);
  // pass 1, a pad row's own: y[b] from row b's state
  for (int pass = 0; pass < 2; ++pass) {
    const long long q = pass == 0 ? r : b;
    if (pass == 1 && r == b) break;
    const bool write_y = q == b;
    const bool write_state = pass == 0;
    const bool keep_new = p.alive == nullptr || p.alive[q] != 0;
    const float4* src = reinterpret_cast<const float4*>(
        p.arena + (static_cast<long long>(p.rows[q]) * H + h) * tile);
    float4* dst = reinterpret_cast<float4*>(p.out + (b * H + h) * tile);
    const float dtq = p.dt[q * H + h];
    const float dA = expf(__fmul_rn(dtq, p.A[h]));
    const T* xq = static_cast<const T*>(p.x) + q * p.x_stride +
                  static_cast<long long>(h) * P;
    const T* Bq = static_cast<const T*>(p.B) + q * p.b_stride;
    const T* Cq = static_cast<const T*>(p.C) + b * p.c_stride;
    float bn[kPer][4], cn[kPer][4];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (k * kLanes + col) * 4 + e;
        bn[k][e] = step_f(Bq[n]);
        cn[k][e] = step_f(Cq[n]);
      }
    for (int p0 = 0; p0 < P; p0 += kRowsStep * kUnroll) {
      float4 s[kUnroll][kPer];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = p0 + u * kRowsStep + sub;
        if (row < P)
#pragma unroll
          for (int k = 0; k < kPer; ++k)
            s[u][k] = __ldcs(src + row * kWords + k * kLanes + col);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = p0 + u * kRowsStep + sub;
        float acc = 0.f;
        if (row < P) {
          const float dtx = __fmul_rn(dtq, step_f(xq[row]));
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const float4 nv = step_new(s[u][k], dA, bn[k], dtx);
            acc = fmaf(cn[k][0], nv.x, acc);
            acc = fmaf(cn[k][1], nv.y, acc);
            acc = fmaf(cn[k][2], nv.z, acc);
            acc = fmaf(cn[k][3], nv.w, acc);
            if (write_state)
              __stcs(dst + row * kWords + k * kLanes + col,
                     keep_new ? nv : s[u][k]);
          }
        }
        // every lane takes part in the shuffles (rows past P add 0)
#pragma unroll
        for (int off = kLanes / 2; off > 0; off /= 2)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (write_y && col == 0 && row < P)
          p.y[(b * H + h) * P + row] = acc;
      }
    }
  }
}

template <typename T>
cudaError_t launch_step(const SsdStep& p, int n, dim3 grid, cudaStream_t st) {
  switch (n) {
    case 16: ssd_step_kernel<16, T><<<grid, kStepThreads, 0, st>>>(p); break;
    case 32: ssd_step_kernel<32, T><<<grid, kStepThreads, 0, st>>>(p); break;
    case 64: ssd_step_kernel<64, T><<<grid, kStepThreads, 0, st>>>(p); break;
    case 128: ssd_step_kernel<128, T><<<grid, kStepThreads, 0, st>>>(p); break;
    case 256: ssd_step_kernel<256, T><<<grid, kStepThreads, 0, st>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// One launch over `batch` rows and `heads` heads of one Mamba sublayer.
// arena: the sublayer's (R, heads, p, n) float32 rows, 16-byte aligned;
// rows (int32), rowmap (int64), alive (bool, or null): batch entries on
// the card, each row in [0, R) and each rowmap entry in [0, batch); x
// (batch, heads, p), B and C (batch, n): bf16 (bf16 != 0) or float32,
// inner dims dense, rows x_stride / b_stride / c_stride elements apart;
// dt (batch, heads) and A (heads,) float32; out (batch, heads, p, n)
// and y (batch, heads, p) float32, dense.  n: 16, 32, 64, 128 or 256.
extern "C" int ss_ssd_step(const float* arena, const int* rows,
                           const long long* rowmap,
                           const unsigned char* alive, const void* x,
                           long long x_stride, const float* dt,
                           const float* A, const void* B, long long b_stride,
                           const void* C, long long c_stride, float* out,
                           float* y, int batch, int heads, int p, int n,
                           int bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || p <= 0) return 0;
  if (batch > 65535 || (reinterpret_cast<uintptr_t>(arena) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  SsdStep s;
  s.arena = arena;
  s.rows = rows;
  s.rowmap = rowmap;
  s.alive = alive;
  s.x = x;
  s.dt = dt;
  s.A = A;
  s.B = B;
  s.C = C;
  s.out = out;
  s.y = y;
  s.x_stride = x_stride;
  s.b_stride = b_stride;
  s.c_stride = c_stride;
  s.heads = heads;
  s.P = p;
  dim3 grid(static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_step<__nv_bfloat16>(s, n, grid, st)
                               : launch_step<float>(s, n, grid, st);
  return static_cast<int>(err);
}
