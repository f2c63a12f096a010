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
// (8 words), where the launch itself is the cost: so dr_random_uniform
// writes the float32 uniforms of the JAX ops layer, (u >> 8) * 2**-24,
// itself, and takes an optional row map (the K-block's pad-row fold:
// output row b uses the counters of row rowmap[b]), so a token choice's
// draw is one launch with no elementwise passes or gather after it.

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

// out: (n_out / n_cols, n_cols) float32; element (b, c) is the uniform of
// counter b * n_cols + c, or rowmap[b] * n_cols + c with a row map
__global__ void drange_uniform_kernel(uint32_t k0, uint32_t k1,
                                      float* __restrict__ out,
                                      long long n_out, long long n_cols,
                                      const long long* __restrict__ rowmap) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_out; i += stride) {
    long long e = i;
    if (rowmap != nullptr) {
      const long long b = i / n_cols;
      e = rowmap[b] * n_cols + (i - b * n_cols);
    }
    const uint32_t ctr = (uint32_t)e;
    const uint32_t u = threefry_x0(k0, k1, ctr, ctr ^ 0x9E3779B9u);
    out[i] = (float)(u >> 8) * (1.0f / 16777216.0f);
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

unsigned blocks_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// out: n uint32 words, contiguous.  Returns a cudaError_t.
extern "C" int dr_random_u32(unsigned int k0, unsigned int k1, void* out,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  drange_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

// out: n_out float32 uniforms in [0, 1), rows of n_cols, contiguous: the
// top 24 bits of each word times 2**-24, bit for bit the JAX ops layer's
// pim_random_uniform.  rowmap: n_out / n_cols int64 row indices on the
// device, or null for the identity.  Returns a cudaError_t.
extern "C" int dr_random_uniform(unsigned int k0, unsigned int k1, void* out,
                                 long long n_out, long long n_cols,
                                 const void* rowmap, void* stream) {
  if (n_out <= 0) return 0;
  if (n_cols <= 0 || n_out % n_cols != 0) return (int)cudaErrorInvalidValue;
  drange_uniform_kernel<<<blocks_for(n_out), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<float*>(out), n_out, n_cols,
      static_cast<const long long*>(rowmap));
  return (int)cudaGetLastError();
}
