// Tiled online-softmax attention forward (prefill), for Hopper (sm_90a).
//
// Replaces flash_attention() in the JAX package's
// src/repro/kernels/flash_attention/flash_attention.py:118 (the Pallas
// kernel _flash_kernel, :51), in all three of its modes: plain; with a
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
// What bounds it on an H100: at the prefill path's shapes (S = 256..1024,
// D = 128, 32/8 heads) the bytes and the operations come out close: it
// reads Sq*D + 2*Sk*D/(H/KVH) elements per (b, h) and does 4*Sq*Sk*D
// FLOPs (half of that under the causal mask), about 0.01 ms either way
// for a batch of 4.  So the products must run on the tensor cores and
// the loads must stream without stalling them.
//
// Two routes, chosen by dtype:
//
// * bf16 (the serving path): FA2's layout.  One block of 4 warps per
//   (64-row q tile, head, sequence); each warp owns 16 query rows.  Q,
//   K and V tiles stay bf16 in shared memory, written by 16-byte
//   cp.async with an XOR swizzle of the 16-byte chunks (conflict-free
//   ldmatrix), K and V in a two-stage ring so the next 64-key tile loads
//   while this one computes.  Q.K^T and P.V run as
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulate), fed by ldmatrix (.trans
//   for V); Q's fragments stay in registers for the whole row tile.  The
//   scores are scaled in fp32 after the product, sm_scale * log2(e)
//   folded into exp2; the online softmax keeps its row max and sum in
//   registers, the max combined across the 4 lanes that share a row.
//   P is rounded to bf16 for the P.V product, as FA2 does; the row sum
//   l is taken from the fp32 P.
// * fp32 (off the serving path): the CUDA-core kernel, two threads a
//   query row, K and V staged as fp32.
//
// Both walk the k tiles of the committed prefix up to prefix_lengths[b]
// first, then those of the chunk up to the last column any row of the
// tile may see (causal and length limits); key rows past a source's
// limit are never read (the bf16 route zero-fills them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // the fp32 route's q tile
constexpr int BK = 64;          // key tile, both routes
constexpr int kThreads = 128;   // the fp32 route's block
constexpr int TC_WARPS = 4;     // the bf16 route: 16 q rows a warp
constexpr int TC_BQ = 16 * TC_WARPS;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int NST = 2;          // K/V tiles in the bf16 route's ring

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

// ---------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with pred false the 16 bytes are zeroed
// and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
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

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// A [rows][D] bf16 tile in shared memory, its 16-byte chunks XOR-swizzled
// by row so that the 8 rows an ldmatrix reads at one logical chunk fall
// in 8 different bank groups (rows of 256 or 128 bytes: chunk ^ row % 8;
// rows of 64 bytes, two to a 128-byte line: chunk ^ (row / 2) % 4).
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int CH = D / 8;
  const int x = CH >= 8 ? (row & 7) : ((row >> 1) & 3);
  return row * D + ((chunk ^ x) << 3);
}

// rows [r0, r0 + 64) of a source (row r at src + base + r * stride) into
// a swizzled tile; rows at or beyond lim are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src,
                                          long long base, long long stride,
                                          int r0, int lim, int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = tid; i < BK * CH; i += TC_THREADS) {
    const int r = i / CH, c = i % CH, gr = r0 + r;
    const bool in = gr < lim;
    const __nv_bfloat16* g =
        in ? src + base + (long long)gr * stride + c * 8 : src;
    cp_async16(tile + swz<D>(r, c), g, in);
  }
}

// One k tile's source: rows [k0, k0 + 64) of k/v at base with the given
// row stride, columns below lim seen, and with `causal` only columns at
// or below the query row.
struct TileSrc {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long base, stride;
  int k0, lim;
  bool causal;
};

// grid (ceil(Sq/64), H, B), block 128 threads
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const int* __restrict__ lengths, Prefix<__nv_bfloat16> pre,
                __nv_bfloat16* __restrict__ out, int H, int KVH, int Sq,
                int Sk, int causal, float scale_log2) {
  constexpr int NKB = BK / 8;    // 8-key n-blocks of a score tile
  constexpr int NDB = D / 8;     // 8-dim n-blocks of the output
  constexpr int KD = D / 16;     // 16-deep k-steps of Q.K^T
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + TC_BQ * D;        // NST stages
  __nv_bfloat16* Vs = Ks + NST * BK * D;     // NST stages

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const long long qbase = ((long long)b * H + h) * Sq * D;
  const long long kbase = ((long long)b * KVH + kh) * Sk * D;

  // the tiles: those of the prefix, then those of the chunk
  int plim = 0;
  long long pbase = 0;
  if (pre.k != nullptr) {
    plim = pre.lengths[b] < pre.Sp ? pre.lengths[b] : pre.Sp;
    pbase = b * pre.sb + kh * pre.sh;
  }
  int klim = Sk;                               // keys any row may see
  if (lengths != nullptr && lengths[b] < klim) klim = lengths[b];
  if (klim < 0) klim = 0;
  int kend = klim;                             // ... and this tile's rows
  if (causal && (qt + 1) * TC_BQ < kend) kend = (qt + 1) * TC_BQ;
  const int npre = (plim + BK - 1) / BK;
  const int ntiles = npre + (kend + BK - 1) / BK;
  auto tile_src = [&](int t) {
    if (t < npre)
      return TileSrc{pre.k, pre.v, pbase, pre.ss, t * BK, plim, false};
    return TileSrc{k, v, kbase, (long long)D, (t - npre) * BK, klim,
                   causal != 0};
  };

  // Q tile (rows past Sq zeroed) and the first NST - 1 K/V tiles
#pragma unroll
  for (int i = tid; i < TC_BQ * (D / 8); i += TC_THREADS) {
    const int r = i / (D / 8), c = i % (D / 8), gr = qt * TC_BQ + r;
    const bool in = gr < Sq;
    cp_async16(Qs + swz<D>(r, c),
               in ? q + qbase + (long long)gr * D + c * 8 : q, in);
  }
  auto load_kv = [&](int t) {
    const TileSrc sn = tile_src(t);
    const int st = t % NST;
    load_tile<D>(Ks + st * BK * D, sn.k, sn.base, sn.stride, sn.k0, sn.lim,
                 tid);
    load_tile<D>(Vs + st * BK * D, sn.v, sn.base, sn.stride, sn.k0, sn.lim,
                 tid);
  };
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }

  unsigned qf[KD][4];
  float o[NDB][4];
#pragma unroll
  for (int i = 0; i < NDB; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  const int row0 = qt * TC_BQ + w * 16 + g;    // this lane's rows: +0, +8

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % NST;
    // tile t + NST - 1 goes where tile t - 1 was
    if (t + NST - 1 < ntiles) load_kv(t + NST - 1);
    cp_async_commit();
    cp_async_wait<NST - 1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], Qs + swz<D>(w * 16 + (lane & 15),
                                    kk * 2 + (lane >> 4)));
    }
    const __nv_bfloat16* Kt = Ks + st * BK * D;
    const __nv_bfloat16* Vt = Vs + st * BK * D;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NKB][4];
#pragma unroll
    for (int i = 0; i < NKB; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nb2 = 0; nb2 < NKB / 2; ++nb2) {
        unsigned r[4];
        ldsm_x4(r, Kt + swz<D>(nb2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                               kk * 2 + ((lane >> 3) & 1)));
        mma16816(s[2 * nb2], qf[kk], r[0], r[1]);
        mma16816(s[2 * nb2 + 1], qf[kk], r[2], r[3]);
      }
    }

    // scale, mask, online softmax (log2 domain)
    const TileSrc sc = tile_src(t);
    const bool edge = sc.k0 + BK > sc.lim ||
                      (sc.causal && sc.k0 + BK - 1 > qt * TC_BQ);
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int nb = 0; nb < NKB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale_log2;
        if (edge) {
          const int col = sc.k0 + nb * 8 + tg * 2 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= sc.lim || (sc.causal && col > row)) x = -INFINITY;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nb = 0; nb < NKB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - m[e >> 1]);
        s[nb][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < NDB; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A operand's, in bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd2 = 0; nd2 < NDB / 2; ++nd2) {
        unsigned r[4];
        ldsm_x4_t(r, Vt + swz<D>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 nd2 * 2 + (lane >> 4)));
        mma16816(o[2 * nd2], a, r[0], r[1]);
        mma16816(o[2 * nd2 + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();   // this stage is free for tile t + NST
  }
  cp_async_wait<0>();

  // the row sums across the 4 lanes of a row, then O / l in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= Sq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    __nv_bfloat16* orow = out + qbase + (long long)row * D + tg * 2;
#pragma unroll
    for (int nd = 0; nd < NDB; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8) =
          __floats2bfloat162_rn(o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v,
              const int* lengths, const Prefix<__nv_bfloat16>& pre,
              void* out, int B, int H, int KVH, int Sq, int Sk, int causal,
              float sm_scale, cudaStream_t st) {
  const size_t smem =
      (size_t)(TC_BQ + 2 * NST * BK) * D * sizeof(__nv_bfloat16);
  auto kern = flash_tc_kernel<D>;
  static bool sized = false;   // the attribute once per kernel
  if (!sized && smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sized = true;
  dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
  kern<<<grid, TC_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, pre,
      static_cast<__nv_bfloat16*>(out), H, KVH, Sq, Sk, causal,
      sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// fp32 route: CUDA cores
// ---------------------------------------------------------------------

template <int D>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

// One k tile, keys [k0, k0 + BK) of a source whose key row c starts at
// src + base + c * row_stride (nrows rows).  A key column col is seen by
// the thread's q row when col < lim and, with `causal`, col <= crow.
// Updates the row's running max m, sum l and half accumulator acc.
template <int D>
__device__ __forceinline__ void attend_tile(
    const float* __restrict__ k, const float* __restrict__ v, long long base,
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
    Ks[c * QP + d] = in ? k[off] : 0.f;
    Vs[c * D + d] = in ? v[off] : 0.f;
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

// grid (ceil(Sq/BQ), H, B), block 128 threads: two threads a q row, each
// computing 32 scores of a tile (interleaved columns) and half of the
// row's fp32 output (interleaved dims); the pair combines row max and
// sum with one shuffle.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const int* __restrict__ lengths, Prefix<float> pre,
                  float* __restrict__ out, int H, int KVH, int Sq, int Sk,
                  int causal, float sm_scale) {
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
        gr < Sq ? q[qbase + (long long)gr * D + d] * sm_scale : 0.f;
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
      attend_tile<D>(pre.k, pre.v, pbase, pre.ss, k0, pre.Sp, plim,
                        false, row, Qs, Ks, Vs, Ps, tid, m, l, acc);
  }

  int klim = Sk;                               // keys any row may see
  if (lengths != nullptr && lengths[b] < klim) klim = lengths[b];
  int kend = klim;                             // ... and this tile's rows
  if (causal && (qt + 1) * BQ < kend) kend = (qt + 1) * BQ;
  for (int k0 = 0; k0 < kend; k0 += BK)
    attend_tile<D>(k, v, kbase, D, k0, Sk, klim, causal != 0, row, Qs,
                      Ks, Vs, Ps, tid, m, l, acc);

  if (row < Sq) {
    const float inv = (l == 0.f) ? 0.f : 1.f / l;
    float* o = out + qbase + (long long)row * D + hf;
#pragma unroll
    for (int i = 0; i < ND; ++i) o[2 * i] = acc[i] * inv;
  }
}

template <int D>
int launch_simt(const void* q, const void* k, const void* v,
                const int* lengths, const Prefix<float>& pre, void* out,
                int B, int H, int KVH, int Sq, int Sk, int causal,
                float sm_scale, cudaStream_t st) {
  const size_t smem = simt_smem_bytes<D>();
  auto kern = flash_simt_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lengths, pre, static_cast<float*>(out),
      H, KVH, Sq, Sk, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
Prefix<T> prefix(const void* kp, const void* vp, const int* plens, int Sp,
                 long long sb, long long sh, long long ss) {
  return Prefix<T>{static_cast<const T*>(kp), static_cast<const T*>(vp),
                   plens, Sp, sb, sh, ss};
}

}  // namespace

// dtype: 0 = bf16 (tensor cores), 1 = fp32 (CUDA cores).  lengths may be
// null.  q/k/v/out contiguous: q/out (B,H,Sq,D), k/v (B,KVH,Sk,D),
// lengths (B,) int32.  Prefix-KV mode when kp is not null (it needs
// lengths): kp/vp (B,KVH,Sp,D) with element strides sb, sh, ss and a
// contiguous head dim, prefix_lengths (B,) int32.  The bf16 route reads
// q, k, v and the prefix by 16-byte words: their pointers must be
// 16-byte aligned and sb, sh, ss multiples of 8.
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
  if (dtype == 0) {
    const auto pre = prefix<__nv_bfloat16>(kp, vp, plens, Sp, sb, sh, ss);
    switch (D) {
      case 32: return launch_tc<32>(q, k, v, lengths, pre, out, B, H, KVH,
                                    Sq, Sk, causal, sm_scale, st);
      case 64: return launch_tc<64>(q, k, v, lengths, pre, out, B, H, KVH,
                                    Sq, Sk, causal, sm_scale, st);
      case 128: return launch_tc<128>(q, k, v, lengths, pre, out, B, H, KVH,
                                      Sq, Sk, causal, sm_scale, st);
    }
  } else if (dtype == 1) {
    const auto pre = prefix<float>(kp, vp, plens, Sp, sb, sh, ss);
    switch (D) {
      case 32: return launch_simt<32>(q, k, v, lengths, pre, out, B, H, KVH,
                                      Sq, Sk, causal, sm_scale, st);
      case 64: return launch_simt<64>(q, k, v, lengths, pre, out, B, H, KVH,
                                      Sq, Sk, causal, sm_scale, st);
      case 128: return launch_simt<128>(q, k, v, lengths, pre, out, B, H,
                                        KVH, Sq, Sk, causal, sm_scale, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
