// D-RaNGe block generator: Threefry2x32-20 over the flat element counter,
// for Hopper (sm_90a).
//
// Replaces random_u32() in the JAX package's
// src/repro/kernels/drange/drange.py:68 (the Pallas kernel _drange_kernel,
// :54, and threefry2x32, :37).  Same contract, bit for bit: element i of
// the (n_rows, n_cols) output is x0 of threefry2x32(k0, k1, i, i ^
// 0x9E3779B9), with the counter i the element's flat index in uint32.
//
// What bounds it on an H100: the integer operations.  Each word costs
// about 120 32-bit adds, shifts and xors (20 rounds of add, rotate, xor
// and 5 key injections) for 4 bytes written, so it sits above the
// card's balance point on the CUDA cores; nothing is read.
//
// Design: one thread per word in a grid-stride loop, the key passed by
// value (the seed is a host value, so no launch reads device memory
// first), the output written once with neighbouring threads on
// neighbouring words.  The sampled serving path draws one word per row
// (8 words), where the launch itself is the cost.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t threefry_x0(uint32_t k0, uint32_t k1,
                                                uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, rot[block % 2][i]);
      x1 ^= x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
  }
  return x0;
}

__global__ void drange_kernel(uint32_t k0, uint32_t k1,
                              uint32_t* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t ctr = (uint32_t)i;
    out[i] = threefry_x0(k0, k1, ctr, ctr ^ 0x9E3779B9u);
  }
}

}  // namespace

// out: n uint32 words, contiguous.  Returns a cudaError_t.
extern "C" int dr_random_u32(unsigned int k0, unsigned int k1, void* out,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  drange_kernel<<<(unsigned)blocks, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}
