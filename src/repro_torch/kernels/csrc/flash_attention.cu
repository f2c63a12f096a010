// Tiled online-softmax attention forward (prefill), for Hopper (sm_90a).
//
// Replaces flash_attention() in the JAX package's
// src/repro/kernels/flash_attention/flash_attention.py:118 (the Pallas
// kernel _flash_kernel, :52), in all three of its modes: plain; with a
// per-sequence `lengths` key mask; and the prefix-KV mode of chunked
// prefill.  Same contract: q (B,H,Sq,D), k and v (B,KVH,Sk,D), GQA head
// h reads kv head h / (H/KVH), optional causal mask, keys at or beyond
// lengths[b] masked.  In the prefix-KV mode the queries also attend
// k_prefix/v_prefix (B,KVH,Sp,D) in full, masked only by
// prefix_lengths[b]; the chunk's own keys keep the causal and lengths
// masks (the Pallas kernel's columns shifted by Sp).  The prefix is read
// as a second K/V source, through its own strides, so the caller's
// gather of the paged arena is not concatenated with the chunk in
// memory.  A row with no unmasked key gives 0 (the Pallas kernel gives
// the mean of v there; the engine never forms such a row, since lengths
// >= 1 under causal).
//
// What bounds it on an H100: operations.  At the prefill path's shapes
// (S = 512..1024, D = 128) it does 4 * Sq * Sk * D FLOPs per (b, h)
// (half of that under the causal mask) on Sq*D + 2*Sk*D/(H/KVH)
// elements, far above the card's balance point; least time is the
// FLOPs over the bf16 tensor-core peak (989 TFLOP/s).
//
// Design (simple and correct first): one block of 128 threads per
// (64-row q tile, head, sequence).  The q tile stays in shared memory;
// the kernel walks 64-column k tiles, first those of the prefix up to
// prefix_lengths[b], then those of the chunk up to the last column any
// row of the tile may see (causal and length limits), staging K and V in
// shared memory as fp32.  Two threads share a q row: each computes 32
// scores of the tile (interleaved columns), the pair combines row max
// and sum with one shuffle, and each keeps half of the row's fp32 output
// accumulator (interleaved dims) in registers.  The products run on the
// CUDA cores in fp32; moving them to the tensor cores (mma / wgmma) is
// later work, and this kernel's time is far above its bound.

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

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 2 * BQ;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

// One k tile, keys [k0, k0 + BK) of a source whose key row c starts at
// src + base + c * row_stride (nrows rows).  A key column col is seen by
// the thread's q row when col < lim and, with `causal`, col <= crow.
// Updates the row's running max m, sum l and half accumulator acc.
template <typename T, int D>
__device__ __forceinline__ void attend_tile(
    const T* __restrict__ k, const T* __restrict__ v, long long base,
    long long row_stride, int k0, int nrows, int lim, bool causal, int crow,
    const float* Qs, float* Ks, float* Vs, float* Ps, int tid, float& m,
    float& l, float (&acc)[D / 2]) {
  constexpr int QP = D + 1;      // padded row stride of the q and k tiles
  constexpr int PP = BK + 1;     // padded row stride of the p tile
  constexpr int NC = BK / 2;     // score columns per thread
  constexpr int ND = D / 2;      // output dims per thread
  const int r = tid >> 1, hf = tid & 1;

  __syncthreads();  // every thread is done with the previous tiles
  for (int i = tid; i < BK * D; i += kThreads) {
    const int c = i / D, d = i % D, gc = k0 + c;
    const bool in = gc < nrows;
    const long long off = base + (long long)gc * row_stride + d;
    Ks[c * QP + d] = in ? to_f(k[off]) : 0.f;
    Vs[c * D + d] = in ? to_f(v[off]) : 0.f;
  }
  __syncthreads();

  float s[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) s[j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += 8) {
    float qv[8];
#pragma unroll
    for (int dd = 0; dd < 8; ++dd) qv[dd] = Qs[r * QP + d0 + dd];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float* kr = Ks + (2 * j + hf) * QP + d0;
#pragma unroll
      for (int dd = 0; dd < 8; ++dd) s[j] += qv[dd] * kr[dd];
    }
  }

  float mloc = -1e30f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = k0 + 2 * j + hf;
    const bool ok = col < lim && (!causal || col <= crow);
    if (ok) mloc = fmaxf(mloc, s[j]);
  }
  mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
  const float m_new = fmaxf(m, mloc);
  const float alpha = expf(m - m_new);
  float psum = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = k0 + 2 * j + hf;
    const bool ok = col < lim && (!causal || col <= crow);
    const float p = ok ? expf(s[j] - m_new) : 0.f;
    Ps[r * PP + 2 * j + hf] = p;
    psum += p;
  }
  psum += __shfl_xor_sync(0xffffffffu, psum, 1);
  l = l * alpha + psum;
  m = m_new;
  __syncwarp();  // the row's other half of p was written by lane ^ 1

#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] *= alpha;
  for (int c = 0; c < BK; ++c) {
    const float p = Ps[r * PP + c];
    const float* vr = Vs + c * D + hf;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] += p * vr[2 * i];
  }
}

// The prefix-KV operands (all null / 0 without a prefix): k_prefix and
// v_prefix share the strides sb, sh, ss (elements; the head dim is
// contiguous), prefix_lengths (B,) int32.
template <typename T>
struct Prefix {
  const T* k;
  const T* v;
  const int* lengths;
  int Sp;
  long long sb, sh, ss;
};

// grid (ceil(Sq/BQ), H, B), block 128 threads
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lengths,
             Prefix<T> pre, T* __restrict__ out, int H, int KVH, int Sq,
             int Sk, int causal, float sm_scale) {
  constexpr int QP = D + 1;
  constexpr int ND = D / 2;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * QP;
  float* Ps = Vs + BK * D;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x, hf = tid & 1;
  const int row = qt * BQ + (tid >> 1);
  const long long qbase = ((long long)b * H + h) * Sq * D;
  const long long kbase = ((long long)b * KVH + kh) * Sk * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int rr = i / D, d = i % D, gr = qt * BQ + rr;
    Qs[rr * QP + d] =
        gr < Sq ? to_f(q[qbase + (long long)gr * D + d]) * sm_scale : 0.f;
  }

  float m = -1e30f, l = 0.f;
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;

  if (pre.k != nullptr) {                      // the committed prefix
    int plim = pre.lengths[b];
    if (plim > pre.Sp) plim = pre.Sp;
    const long long pbase = b * pre.sb + kh * pre.sh;
    for (int k0 = 0; k0 < plim; k0 += BK)
      attend_tile<T, D>(pre.k, pre.v, pbase, pre.ss, k0, pre.Sp, plim,
                        false, row, Qs, Ks, Vs, Ps, tid, m, l, acc);
  }

  int klim = Sk;                               // keys any row may see
  if (lengths != nullptr && lengths[b] < klim) klim = lengths[b];
  int kend = klim;                             // ... and this tile's rows
  if (causal && (qt + 1) * BQ < kend) kend = (qt + 1) * BQ;
  for (int k0 = 0; k0 < kend; k0 += BK)
    attend_tile<T, D>(k, v, kbase, D, k0, Sk, klim, causal != 0, row, Qs,
                      Ks, Vs, Ps, tid, m, l, acc);

  if (row < Sq) {
    const float inv = (l == 0.f) ? 0.f : 1.f / l;
    T* o = out + qbase + (long long)row * D + hf;
#pragma unroll
    for (int i = 0; i < ND; ++i) o[2 * i] = from_f<T>(acc[i] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           const Prefix<T>& pre, void* out, int B, int H, int KVH, int Sq,
           int Sk, int causal, float sm_scale, cudaStream_t st) {
  const size_t smem = smem_bytes<D>();
  auto kern = flash_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, pre, static_cast<T*>(out), H, KVH,
      Sq, Sk, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* lengths, const void* kp, const void* vp,
               const int* plens, int Sp, long long sb, long long sh,
               long long ss, void* out, int B, int H, int KVH, int Sq,
               int Sk, int causal, float sm_scale, cudaStream_t st) {
  const Prefix<T> pre{static_cast<const T*>(kp), static_cast<const T*>(vp),
                      plens, Sp, sb, sh, ss};
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, lengths, pre, out, B, H, KVH, Sq,
                                  Sk, causal, sm_scale, st);
    case 64: return launch<T, 64>(q, k, v, lengths, pre, out, B, H, KVH, Sq,
                                  Sk, causal, sm_scale, st);
    case 128: return launch<T, 128>(q, k, v, lengths, pre, out, B, H, KVH,
                                    Sq, Sk, causal, sm_scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  lengths may be null.  q/k/v/out contiguous:
// q/out (B,H,Sq,D), k/v (B,KVH,Sk,D), lengths (B,) int32.  Prefix-KV
// mode when kp is not null (it needs lengths): kp/vp (B,KVH,Sp,D) with
// element strides sb, sh, ss and a contiguous head dim, prefix_lengths
// (B,) int32.
extern "C" int fa_flash_attention(const void* q, const void* k, const void* v,
                                  const int* lengths, const void* kp,
                                  const void* vp, const int* plens, void* out,
                                  int B, int H, int KVH, int Sq, int Sk,
                                  int Sp, int D, int causal, float sm_scale,
                                  int dtype, long long sb, long long sh,
                                  long long ss, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  if (kp != nullptr && (vp == nullptr || plens == nullptr ||
                        lengths == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, kp, vp, plens, Sp,
                                     sb, sh, ss, out, B, H, KVH, Sq, Sk,
                                     causal, sm_scale, st);
  if (dtype == 1)
    return dispatch_d<float>(D, q, k, v, lengths, kp, vp, plens, Sp, sb, sh,
                             ss, out, B, H, KVH, Sq, Sk, causal, sm_scale,
                             st);
  return (int)cudaErrorInvalidValue;
}
