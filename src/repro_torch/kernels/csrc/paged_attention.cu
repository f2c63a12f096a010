// Paged decode attention over the KV arena, split over the sequence, for
// Hopper (sm_90a).
//
// Replaces paged_attention() in the JAX package's
// src/repro/kernels/paged_attention/paged_attention.py:124 (the Pallas
// kernel _paged_kernel, :44).  Same contract: one query token per
// sequence, GQA (H query heads over KVH kv heads), keys and values read
// through the block table, positions >= lengths[b] masked, the current
// token's k_self/v_self merged at position lengths[b], optional (m, l)
// softmax statistics out, and a row with l == 0 gives 0.
//
// What bounds it on an H100: bytes.  Per layer it must read the K and V
// of the live tokens, 2 * sum(lengths) * KVH * D * 2 bytes in bf16, and
// does about 4 FLOPs per byte read, far below the card's ~295 FLOP/byte
// balance point.  Least time: those bytes / 3.35 TB/s.  So the card must
// keep enough loads in flight, which one block per (sequence, kv head)
// cannot: 64 blocks at batch 8 for 132 SMs, each walking its tokens in
// order.
//
// Design (flash-decoding): the grid is (B, KVH, NPART), a block per
// partition of `part` tokens (128 on the serving path) of one sequence
// and kv head.  NPART comes from the block table's width, a host shape,
// so the launch depends on no device value; a partition at or past a
// row's length exits at once (partition 0 always runs, so a row with no
// history still gets its self token and its statistics).  A block walks
// its partition in tiles of TT tokens (64 at D = 128 in bf16): each
// token's K and V rows are gathered through the block table as 16-byte
// cp.async words into a two-stage ring of shared memory in the arena's
// dtype, so the next tile loads while this one computes, and a
// partition boundary may fall inside a page.  The group's G query heads
// share each staged tile:
//
// * scores in parallel: thread (token, part of the row) forms the dot
//   products of its token with all G queries (fp32 in shared memory,
//   already scaled by sm_scale) over its 16-byte chunks;
// * one max and one rescale per tile and head: warp w owns heads
//   w, w + 4, ...;
// * P.V: thread (dim pair, token group) accumulates its two dims for all
//   G heads in fp32 registers.
//
// Each block writes its partial (m, l, acc) in fp32 to scratch that the
// wrapper allocates; the last block of a (b, kv head) to finish (an
// atomic ticket, which it resets to 0 for the next launch) merges them
// in fp32 with the current token:
//   m = max(m_i, s_self),  l = sum_i l_i exp(m_i - m) + exp(s_self - m),
//   o = (sum_i acc_i exp(m_i - m) + exp(s_self - m) v_self) / l.
// One launch a call, on the CUDA cores in fp32 (decode's 4 FLOPs a byte
// need no tensor core).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes global -> shared; with pred false the 16 bytes are zeroed
// and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 bf16 or 4 fp32 of a 16-byte chunk, as floats
__device__ __forceinline__ void chunk_f(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void chunk_f(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T, int D>
struct Cfg {
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements a chunk
  static constexpr int CH = D / EPC;               // chunks a row
  static constexpr int TT_FIT = 16384 / (D * (int)sizeof(T));
  static constexpr int TT = TT_FIT > 64 ? 64 : TT_FIT;  // tokens a tile
  static constexpr int NT = kThreads / TT;    // score threads a token
  static constexpr int CPT = CH / NT;         // chunks a score thread
  static constexpr int DP = D / 2;            // dim pairs
  static constexpr int NTG = DP >= kThreads ? 1 : kThreads / DP;
  static constexpr int TPG = TT / NTG;        // tokens a P.V thread
  static_assert(CH % NT == 0 && TPG % 4 == 0 && DP <= kThreads, "shape");

  // element offset of (row, chunk) in a [TT][D] tile, chunks XOR-swizzled
  // by row so that 8 consecutive rows at one chunk hit 8 bank groups
  __device__ static int swz(int row, int chunk) {
    const int x = CH >= 8 ? (row & 7) : ((row >> 1) & 3);
    return row * D + (chunk ^ x) * EPC;
  }
  // the K/V ring, or after the walk the token groups' P.V sums
  __host__ __device__ static size_t ring_bytes(int G) {
    const size_t kv = 4u * TT * D * sizeof(T);
    const size_t red = (size_t)NTG * G * D * sizeof(float);
    return kv > red ? kv : red;
  }
  __host__ __device__ static size_t smem_bytes(int G) {
    return ring_bytes(G) + sizeof(float) * ((size_t)G * D +
                                            (size_t)NT * G * TT + 3u * G);
  }
};

// grid (B, KVH, npart); block 128 threads.  part: tokens a partition (a
// multiple of 64); scratch: (B, KVH, npart, G, D + 2) floats, per head m,
// then l, then acc (the m's and l's of a partition first); tickets:
// (B * KVH) ints, 0 between launches.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_arena,
    const T* __restrict__ v_arena, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, const T* __restrict__ k_self,
    const T* __restrict__ v_self, T* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ scratch, int* __restrict__ tickets, int H, int KVH,
    int S, int max_pages, int npart, int part, float sm_scale) {
  using C = Cfg<T, D>;
  constexpr int TT = C::TT, EPC = C::EPC, CH = C::CH;
  constexpr int HW = (GM + 3) / 4;            // heads a warp owns
  const int b = blockIdx.x, kh = blockIdx.y, j = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;

  int len = lengths[b];
  if (len > max_pages * S) len = max_pages * S;
  if (len < 0) len = 0;
  const int nvalid = len > 0 ? (len + part - 1) / part : 1;
  if (j >= nvalid) return;                    // past the row's length
  const int t0 = j * part;
  const int t1 = len < t0 + part ? len : t0 + part;
  const int ntiles = (t1 - t0 + TT - 1) / TT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* Qs = reinterpret_cast<float*>(smem_raw + C::ring_bytes(G));
  float* Ss = Qs + G * D;                     // [NT][G][TT] scores, then P
  float* As = Ss + C::NT * G * TT;            // [G] a tile's rescale
  float* Ms = As + G;                         // [G] merged max
  float* Ws = Ms + G;                         // [G] the self token's weight

  const long long qb = ((long long)b * H + (long long)kh * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    Qs[i] = to_f(q[qb + i]) * sm_scale;

  const int* btb = block_tables + (long long)b * max_pages;
  auto load = [&](int it, int st) {
    T* Kt = ring + st * 2 * TT * D;
    T* Vt = Kt + TT * D;
    const int tok0 = t0 + it * TT;
    for (int i = tid; i < TT * CH; i += kThreads) {
      const int r = i / CH, c = i % CH, tok = tok0 + r;
      const bool in = tok < t1;
      long long off = 0;
      if (in) {
        const long long page = btb[tok / S];
        off = ((page * S + tok % S) * KVH + kh) * D + c * EPC;
      }
      cp_async16(Kt + C::swz(r, c), k_arena + off, in);
      cp_async16(Vt + C::swz(r, c), v_arena + off, in);
    }
  };

  float mrun[HW], lrun[HW];
#pragma unroll
  for (int i = 0; i < HW; ++i) {
    mrun[i] = -1e30f;
    lrun[i] = 0.f;
  }
  float acc[GM][2];
#pragma unroll
  for (int g = 0; g < GM; ++g) acc[g][0] = acc[g][1] = 0.f;
  const int s_tok = tid % TT, s_part = tid / TT;     // scores
  const int dp = tid % C::DP, tgrp = tid / C::DP;    // P.V

  if (ntiles > 0) load(0, 0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) load(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Kt = ring + st * 2 * TT * D;
    const T* Vt = Kt + TT * D;
    const int tok0 = t0 + it * TT;

    {  // scores of token s_tok over chunks [s_part * CPT, +CPT)
      float sc[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) sc[g] = 0.f;
      for (int cc = 0; cc < C::CPT; ++cc) {
        const int c = s_part * C::CPT + cc;
        float kf[EPC];
        chunk_f(Kt + C::swz(s_tok, c), kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float* qr = Qs + g * D + c * EPC;
#pragma unroll
            for (int e = 0; e < EPC; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              sc[g] += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] +
                       qv.w * kf[e + 3];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) Ss[(s_part * G + g) * TT + s_tok] = sc[g];
    }
    __syncthreads();

    // one max and one rescale per head and tile
#pragma unroll
    for (int i = 0; i < HW; ++i) {
      const int g = w + 4 * i;
      if (g >= G) continue;                   // warp-uniform
      constexpr int PER = TT >= 32 ? TT / 32 : 1;
      float sv[PER];
      float mx = -1e30f;
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int tt = lane + 32 * u;
        float s = -INFINITY;
        if (tt < TT && tok0 + tt < t1) {
          s = 0.f;
#pragma unroll
          for (int n = 0; n < C::NT; ++n) s += Ss[(n * G + g) * TT + tt];
        }
        sv[u] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(mrun[i], mx);
      const float alpha = expf(mrun[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int tt = lane + 32 * u;
        const float p = expf(sv[u] - m_new);
        if (tt < TT) Ss[g * TT + tt] = p;
        ps += p;
      }
      ps = warp_sum(ps);
      lrun[i] = lrun[i] * alpha + ps;
      mrun[i] = m_new;
      if (lane == 0) As[g] = alpha;
    }
    __syncthreads();

    {  // P.V: dims 2dp, 2dp + 1 over tokens [tgrp * TPG, +TPG)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float a = As[g];
          acc[g][0] *= a;
          acc[g][1] *= a;
        }
      }
      const int d0 = 2 * dp, dc = d0 / EPC, de = d0 % EPC;
      for (int t4 = 0; t4 < C::TPG; t4 += 4) {
        const int tt = tgrp * C::TPG + t4;
        float2 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[u] = pair_f(Vt + C::swz(tt + u, dc) + de);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float4 p = *reinterpret_cast<const float4*>(Ss + g * TT + tt);
            acc[g][0] += p.x * vv[0].x + p.y * vv[1].x + p.z * vv[2].x +
                         p.w * vv[3].x;
            acc[g][1] += p.x * vv[0].y + p.y * vv[1].y + p.z * vv[2].y +
                         p.w * vv[3].y;
          }
        }
      }
    }
    __syncthreads();   // this stage is free for the tile after next
  }
  cp_async_wait<0>();

  // this partition's (m, l, acc) to scratch
  const long long pstride = (long long)G * (D + 2);
  float* pb = scratch + ((long long)b * KVH + kh) * npart * pstride;
  float* pj = pb + j * pstride;
#pragma unroll
  for (int i = 0; i < HW; ++i) {
    const int g = w + 4 * i;
    if (g < G && lane == 0) {
      pj[g] = mrun[i];
      pj[G + g] = lrun[i];
    }
  }
  if (C::NTG == 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        pj[2 * G + g * D + 2 * dp] = acc[g][0];
        pj[2 * G + g * D + 2 * dp + 1] = acc[g][1];
      }
    }
  } else {
    float* red = reinterpret_cast<float*>(smem_raw);  // the ring is idle
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        red[(tgrp * G + g) * D + 2 * dp] = acc[g][0];
        red[(tgrp * G + g) * D + 2 * dp + 1] = acc[g][1];
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int n = 0; n < C::NTG; ++n) s += red[n * G * D + i];
      pj[2 * G + i] = s;
    }
  }

  // the last block of (b, kv head) to get here merges
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int is_last = 1;
    if (nvalid > 1) {
      int* tk = tickets + (long long)b * KVH + kh;
      is_last = atomicAdd(tk, 1) == nvalid - 1;
      if (is_last) atomicExch(tk, 0);
    }
    last = is_last;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  const long long sb = ((long long)b * KVH + kh) * D;
  for (int g = w; g < G; g += 4) {
    float mx = -1e30f;
    for (int i = lane; i < nvalid; i += 32)
      mx = fmaxf(mx, __ldcg(pb + i * pstride + g));
    mx = warp_max(mx);
    float s_self = 0.f;
    if (k_self != nullptr) {
      for (int d = lane; d < D; d += 32)
        s_self += Qs[g * D + d] * to_f(k_self[sb + d]);
      s_self = warp_sum(s_self);
      mx = fmaxf(mx, s_self);
    }
    float l = 0.f;
    for (int i = lane; i < nvalid; i += 32)
      l += __ldcg(pb + i * pstride + G + g) *
           expf(__ldcg(pb + i * pstride + g) - mx);
    l = warp_sum(l);
    float w_self = 0.f;
    if (k_self != nullptr) {
      w_self = expf(s_self - mx);
      l += w_self;
    }
    if (lane == 0) {
      Ms[g] = mx;
      As[g] = l == 0.f ? 0.f : 1.f / l;
      Ws[g] = w_self;
      if (m_out != nullptr) {
        m_out[(long long)b * H + kh * G + g] = mx;
        l_out[(long long)b * H + kh * G + g] = l;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float o = 0.f;
    for (int n = 0; n < nvalid; ++n)
      o += __ldcg(pb + n * pstride + 2 * G + i) *
           expf(__ldcg(pb + n * pstride + g) - Ms[g]);
    if (v_self != nullptr) o += Ws[g] * to_f(v_self[sb + d]);
    out[qb + i] = from_f<T>(o * As[g]);
  }
}

template <typename T, int D, int GM>
int launch(const void* q, const void* k_arena, const void* v_arena,
           const int* bt, const int* lengths, const void* k_self,
           const void* v_self, void* out, float* m_out, float* l_out,
           float* scratch, int* tickets, int B, int H, int KVH, int S,
           int max_pages, int npart, int part, float sm_scale,
           cudaStream_t st) {
  const size_t smem = Cfg<T, D>::smem_bytes(H / KVH);
  auto kern = paged_split_kernel<T, D, GM>;
  static size_t sized = 48 * 1024;   // the largest size set so far
  if (smem > sized) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  dim3 grid(B, KVH, npart);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_arena),
      static_cast<const T*>(v_arena), bt, lengths,
      static_cast<const T*>(k_self), static_cast<const T*>(v_self),
      static_cast<T*>(out), m_out, l_out, scratch, tickets, H, KVH, S,
      max_pages, npart, part, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_g(int G, const void* q, const void* k_arena,
               const void* v_arena, const int* bt, const int* lengths,
               const void* k_self, const void* v_self, void* out,
               float* m_out, float* l_out, float* scratch, int* tickets,
               int B, int H, int KVH, int S, int max_pages, int npart,
               int part, float sm_scale, cudaStream_t st) {
  if (G <= 4)
    return launch<T, D, 4>(q, k_arena, v_arena, bt, lengths, k_self, v_self,
                           out, m_out, l_out, scratch, tickets, B, H, KVH, S,
                           max_pages, npart, part, sm_scale, st);
  if (G <= 8)
    return launch<T, D, 8>(q, k_arena, v_arena, bt, lengths, k_self, v_self,
                           out, m_out, l_out, scratch, tickets, B, H, KVH, S,
                           max_pages, npart, part, sm_scale, st);
  return launch<T, D, 32>(q, k_arena, v_arena, bt, lengths, k_self, v_self,
                          out, m_out, l_out, scratch, tickets, B, H, KVH, S,
                          max_pages, npart, part, sm_scale, st);
}

template <typename T>
int dispatch_d(int D, int G, const void* q, const void* k_arena,
               const void* v_arena, const int* bt, const int* lengths,
               const void* k_self, const void* v_self, void* out,
               float* m_out, float* l_out, float* scratch, int* tickets,
               int B, int H, int KVH, int S, int max_pages, int npart,
               int part, float sm_scale, cudaStream_t st) {
#define PA_ARGS                                                            \
  G, q, k_arena, v_arena, bt, lengths, k_self, v_self, out, m_out, l_out, \
      scratch, tickets, B, H, KVH, S, max_pages, npart, part, sm_scale, st
  switch (D) {
    case 32: return dispatch_g<T, 32>(PA_ARGS);
    case 64: return dispatch_g<T, 64>(PA_ARGS);
    case 128: return dispatch_g<T, 128>(PA_ARGS);
    case 256: return dispatch_g<T, 256>(PA_ARGS);
  }
#undef PA_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  k_self/v_self and m_out/l_out may be null.
// q (B,H,D), arenas (P,S,KVH,D), block_tables (B,max_pages), lengths (B,),
// k_self/v_self (B,KVH,D), out (B,H,D), m_out/l_out (B,H); all
// contiguous, the arenas 16-byte aligned.  part: tokens a partition, a
// multiple of 64; npart = ceil(max_pages * S / part); scratch (B, KVH,
// npart, H/KVH, D + 2) fp32; tickets (B * KVH) int32, zero before the
// first launch (each launch leaves them zero).
extern "C" int pa_paged_attention(const void* q, const void* k_arena,
                                  const void* v_arena, const int* bt,
                                  const int* lengths, const void* k_self,
                                  const void* v_self, void* out, float* m_out,
                                  float* l_out, float* scratch, int* tickets,
                                  int B, int H, int KVH, int D, int S,
                                  int max_pages, int npart, int part,
                                  float sm_scale, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H / KVH > 32 || part <= 0 ||
      part % 64 != 0 || (long long)npart * part < (long long)max_pages * S)
    return (int)cudaErrorInvalidValue;
  if (npart <= 0) npart = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KVH;
  if (dtype == 0)
    return dispatch_d<__nv_bfloat16>(D, G, q, k_arena, v_arena, bt, lengths,
                                     k_self, v_self, out, m_out, l_out,
                                     scratch, tickets, B, H, KVH, S,
                                     max_pages, npart, part, sm_scale, st);
  if (dtype == 1)
    return dispatch_d<float>(D, G, q, k_arena, v_arena, bt, lengths, k_self,
                             v_self, out, m_out, l_out, scratch, tickets, B,
                             H, KVH, S, max_pages, npart, part, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
