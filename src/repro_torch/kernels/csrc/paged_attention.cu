// Paged decode attention over the KV arena, for Hopper (sm_90a).
//
// Replaces paged_attention() in the JAX package's
// src/repro/kernels/paged_attention/paged_attention.py:124 (the Pallas
// kernel _paged_kernel).  Same contract: one query token per sequence,
// GQA (H query heads over KVH kv heads), keys and values read page by
// page through the block table, positions >= lengths[b] masked, the
// current token's k_self/v_self merged at position lengths[b], optional
// (m, l) softmax statistics out, and a row with l == 0 gives 0.
//
// What bounds it on an H100: bytes.  Per layer it must read the K and V
// of the live pages, 2 * sum(lengths) * KVH * D * 2 bytes in bf16, and
// does about 4 FLOPs per byte read, far below the card's ~295 FLOP/byte
// balance point.  Least time: those bytes / 3.35 TB/s.
//
// Design (simple and correct first): one block per (sequence, kv head),
// one warp per query head of the group (H / KVH = 4 for granite-3-8b),
// so the block reads each K/V page of its head once from device memory
// into shared memory and all query heads of the group use it.  Each warp
// keeps an fp32 online softmax (m, l, acc) with the head dim split
// across its 32 lanes.  Nothing specialises on lengths' values: the
// page loop bound is read from device memory.  Known limit: B * KVH
// blocks (64 at batch 8) cannot fill 132 SMs; splitting the page range
// across blocks (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (B, KVH); block 32 * G threads (warp g serves query head kh*G+g).
// Shared memory: K page (S x D), V page (S x D), the group's queries
// (G x D), all fp32.
template <typename T, int D>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_arena,
    const T* __restrict__ v_arena, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, const T* __restrict__ k_self,
    const T* __restrict__ v_self, T* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int H, int KVH,
    int S, int max_pages, float sm_scale) {
  constexpr int NP = D / 32;
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / KVH;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* Ks = smem;
  float* Vs = Ks + S * D;
  float* Qs = Vs + S * D;

  const long long q_base = ((long long)b * H + (long long)kh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    Qs[i] = to_f(q[q_base + i]) * sm_scale;

  const int len = lengths[b];
  int npages = (len + S - 1) / S;
  if (npages > max_pages) npages = max_pages;
  const long long tok_stride = (long long)KVH * D;  // one slot's elements

  float m = -1e30f, l = 0.f, acc[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) acc[j] = 0.f;
  const float* qrow = Qs + w * D;

  for (int p = 0; p < npages; ++p) {
    const long long page = block_tables[(long long)b * max_pages + p];
    __syncthreads();  // the previous page is no longer read
    const long long base = page * S * tok_stride + (long long)kh * D;
    for (int i = threadIdx.x; i < S * D; i += blockDim.x) {
      const int t = i / D, d = i % D;
      Ks[i] = to_f(k_arena[base + t * tok_stride + d]);
      Vs[i] = to_f(v_arena[base + t * tok_stride + d]);
    }
    __syncthreads();
    int tmax = len - p * S;
    if (tmax > S) tmax = S;
    for (int t = 0; t < tmax; ++t) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j)
        part += qrow[lane + 32 * j] * Ks[t * D + lane + 32 * j];
      const float s = warp_sum(part);
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float pe = expf(s - m_new);
      l = l * alpha + pe;
#pragma unroll
      for (int j = 0; j < NP; ++j)
        acc[j] = acc[j] * alpha + pe * Vs[t * D + lane + 32 * j];
      m = m_new;
    }
  }

  if (k_self != nullptr) {
    const long long sb = ((long long)b * KVH + kh) * D;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j)
      part += qrow[lane + 32 * j] * to_f(k_self[sb + lane + 32 * j]);
    const float s = warp_sum(part);
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float pe = expf(s - m_new);
    l = l * alpha + pe;
#pragma unroll
    for (int j = 0; j < NP; ++j)
      acc[j] = acc[j] * alpha + pe * to_f(v_self[sb + lane + 32 * j]);
    m = m_new;
  }

  const int h = kh * G + w;
  const float inv = (l == 0.f) ? 1.f : 1.f / l;
  const long long ob = ((long long)b * H + h) * D;
#pragma unroll
  for (int j = 0; j < NP; ++j) out[ob + lane + 32 * j] = from_f<T>(acc[j] * inv);
  if (m_out != nullptr && lane == 0) {
    m_out[(long long)b * H + h] = m;
    l_out[(long long)b * H + h] = l;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_arena, const void* v_arena,
           const int* bt, const int* lengths, const void* k_self,
           const void* v_self, void* out, float* m_out, float* l_out, int B,
           int H, int KVH, int S, int max_pages, float sm_scale,
           cudaStream_t st) {
  const int G = H / KVH;
  const size_t smem = (size_t)(2 * S + G) * D * sizeof(float);
  auto kern = paged_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, KVH);
  kern<<<grid, 32 * G, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_arena),
      static_cast<const T*>(v_arena), bt, lengths,
      static_cast<const T*>(k_self), static_cast<const T*>(v_self),
      static_cast<T*>(out), m_out, l_out, H, KVH, S, max_pages, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k_arena, const void* v_arena,
               const int* bt, const int* lengths, const void* k_self,
               const void* v_self, void* out, float* m_out, float* l_out,
               int B, int H, int KVH, int S, int max_pages, float sm_scale,
               cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k_arena, v_arena, bt, lengths, k_self,
                                  v_self, out, m_out, l_out, B, H, KVH, S,
                                  max_pages, sm_scale, st);
    case 64: return launch<T, 64>(q, k_arena, v_arena, bt, lengths, k_self,
                                  v_self, out, m_out, l_out, B, H, KVH, S,
                                  max_pages, sm_scale, st);
    case 128: return launch<T, 128>(q, k_arena, v_arena, bt, lengths, k_self,
                                    v_self, out, m_out, l_out, B, H, KVH, S,
                                    max_pages, sm_scale, st);
    case 256: return launch<T, 256>(q, k_arena, v_arena, bt, lengths, k_self,
                                    v_self, out, m_out, l_out, B, H, KVH, S,
                                    max_pages, sm_scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  k_self/v_self and m_out/l_out may be null.
// q (B,H,D), arenas (P,S,KVH,D), block_tables (B,max_pages), lengths (B,),
// k_self/v_self (B,KVH,D), out (B,H,D), m_out/l_out (B,H); all contiguous.
extern "C" int pa_paged_attention(const void* q, const void* k_arena,
                                  const void* v_arena, const int* bt,
                                  const int* lengths, const void* k_self,
                                  const void* v_self, void* out, float* m_out,
                                  float* l_out, int B, int H, int KVH, int D,
                                  int S, int max_pages, float sm_scale,
                                  int dtype, void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H / KVH > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<__nv_bfloat16>(D, q, k_arena, v_arena, bt, lengths,
                                     k_self, v_self, out, m_out, l_out, B, H,
                                     KVH, S, max_pages, sm_scale, st);
  if (dtype == 1)
    return dispatch_d<float>(D, q, k_arena, v_arena, bt, lengths, k_self,
                             v_self, out, m_out, l_out, B, H, KVH, S,
                             max_pages, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
