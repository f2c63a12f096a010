// SSM state-row scatter for the paged state arena, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel in
// src/repro/kernels/ssm_scan/ssm_scan.py:
//   ss_state_scatter  <- state_scatter  (ssm_scan.py:35)
//
// What it computes, on the raw bytes of an (L, R, row) arena:
//   arena[l, rows[b]] <- new[l, b]   for every layer l and batch entry b
// L is groups x Mamba sublayers: the whole depth of the model writes in
// one launch.  Duplicate rows must carry identical payloads (batch pad
// rows); their writes land in any order.
//
// What bounds it on an H100: bytes.  It reads `new` once and writes
// as many bytes into the arena; the arena is never read.  At
// mamba2-1.3b's decode shape (48 layers, 8 rows, an SSD state row of
// 64 heads x 64 x 128 float32 = 2 MiB) that is 805 MB each way, 0.48 ms
// at 3.35 TB/s; the conv window rows (3 x 4352 bf16 = 26,112 bytes)
// move 10 MB each way, 6 us.
//
// Design: a state row is 1000 times a KV slot, so one block per (row,
// layer) would leave too few blocks in flight for a small batch at
// shallow depth and give each a 2 MiB loop.  Instead the grid runs over
// (word block, row, layer) with one thread per 16-byte word, as the
// Ambit kernels do, so every thread does one load and one store; a
// byte path serves rows or bases that are not 16-byte aligned.  The
// row indices are an int32 array already on the card.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// grid (word blocks, B, L): arena[l, rows[b]] <- src[l, b]
template <typename W>
__global__ void state_scatter_kernel(W* __restrict__ arena,
                                     const W* __restrict__ src,
                                     const int* __restrict__ rows, int B,
                                     long long R, long long row_words) {
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (w >= row_words) return;
  const long long b = blockIdx.y;
  const long long l = blockIdx.z;
  arena[(l * R + rows[b]) * row_words + w] = src[(l * B + b) * row_words + w];
}

bool aligned16(const void* a, const void* b, long long row_bytes) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           static_cast<uintptr_t>(row_bytes)) & 15) == 0;
}

constexpr int kThreads = 256;

template <typename W>
void launch(void* arena, const void* src, const int* rows, int L, int B,
            long long R, long long row_words, cudaStream_t st) {
  dim3 grid(static_cast<unsigned>((row_words + kThreads - 1) / kThreads), B,
            L);
  state_scatter_kernel<W><<<grid, kThreads, 0, st>>>(
      static_cast<W*>(arena), static_cast<const W*>(src), rows, B, R,
      row_words);
}

}  // namespace

// arena (L, R, row_bytes), src (L, B, row_bytes), rows (B,) int32 in
// [0, R); B <= 65535, L <= 65535
extern "C" int ss_state_scatter(void* arena, const void* src,
                                const int* rows, int L, int B, long long R,
                                long long row_bytes, void* stream) {
  if (L <= 0 || B <= 0 || row_bytes <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned16(arena, src, row_bytes))
    launch<uint4>(arena, src, rows, L, B, R, row_bytes / 16, st);
  else
    launch<unsigned char>(arena, src, rows, L, B, R, row_bytes, st);
  return static_cast<int>(cudaGetLastError());
}
