// Causal flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels that container_engine_accelerators_tpu/
// ops/flash_attention.py reaches from `flash_causal_attention` (:136): the
// classic `_flash_fn` (:112, the stock Pallas TPU flash attention forward
// and its dq / dkv backward kernels) and `_splash_fn` (:90, seq 8192-65536).
// Both compute one function; this file computes it at every length.
//
// What it computes, per (batch, head): S = scale * Q K^T in f32 with the
// keys after each query masked (causal), P = softmax(S), O = P V rounded to
// bf16, and the row logsumexp L = max + log(sum exp) in f32 for the
// backward.  The backward is FA2's: D = rowsum(dO * O); per key tile
// dV = sum_i P^T dO and dK = scale * sum_i dS^T Q, per query tile
// dQ = scale * sum_j dS K, with P = exp(S - L) recomputed from L and
// dS = P * (dO V^T - D).
//
// Bound: operations (bf16 tensor cores).  At the LM shape (b 8, s 2048,
// h 8, d 128) the forward is 2 b h s^2 d = 69 GFLOP against 134 MB of
// q / k / v / o, the backward ~2.5x the forward's flops.  Design, simple
// first: a block of 4 warps owns 64 query rows (forward, dQ) or 64 key rows
// (dK / dV); each warp owns 16 of them and keeps its accumulators in
// registers in the fragment layout of mma.sync m16n8k16 (bf16 in, f32
// accumulate).  Tiles of the other operand stream through shared memory,
// rows padded to 136 elements so that every fragment load is free of bank
// conflicts.  Scores never leave registers: the S accumulator is scaled,
// masked, exponentiated and repacked to bf16 as the A operand of the next
// product (P V, P^T dO, dS^T Q, dS K).  Tiles above the diagonal are
// skipped in all three passes and only the diagonal tile is masked.  Every
// output element is summed by one thread in a fixed order: deterministic,
// no atomics.  No cp.async / TMA pipelining and no wgmma yet.
//
// q, k and v are read through their (batch, seq, head) strides with the
// head dim contiguous, so the strided q / k / v views of the fused qkv
// projection are read in place.  O, dO, dQ, dK and dV are contiguous
// (b, s, h, d); L and D are (b, h, s) f32.
//
// Plain C interface, bound with ctypes.  Each entry point returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef long long i64;

constexpr int D = 128;        // head dim: the only one built
constexpr int TILE = 64;      // rows of a block's own tile and of a streamed tile
constexpr int QSUB = 32;      // query rows per step of the dK / dV pass
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int LDS = D + 8;    // shared row stride in elements (272 bytes)
constexpr int DT = D / 8;     // n-tiles of 8 across the head dim
constexpr unsigned FULL = 0xffffffffu;

struct Qkv {  // q, k, v and their (batch, seq, head) strides in elements
  const bf16* q;
  const bf16* k;
  const bf16* v;
  i64 qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16).
// Fragments, lane = 4 g + t: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g,
// 2t+8..), a3 (g+8, 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
// c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment: rows [m0, m0 + 16) x cols [k0, k0 + 16) of a shared tile.
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* s, int m0,
                                       int k0, int g, int t) {
  const bf16* p = s + (m0 + g) * LDS + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LDS);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LDS + 8);
}

// A fragment for k-step kk from a 16-row f32 accumulator in C layout: its
// n-tiles 2 kk and 2 kk + 1 are A's columns [16 kk, 16 kk + 16).
__device__ __forceinline__ void frag_a_acc(uint32_t* a, float (*c)[4],
                                           int kk) {
  a[0] = pack_f32(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_f32(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_f32(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_f32(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// B fragment with B(k, n) = s[n0 + n][k0 + k]: the tile's rows are B's
// columns (K in Q K^T).
__device__ __forceinline__ void frag_b_rows(uint32_t& b0, uint32_t& b1,
                                            const bf16* s, int n0, int k0,
                                            int g, int t) {
  const bf16* p = s + (n0 + g) * LDS + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment with B(k, n) = s[k0 + k][n0 + n]: the tile's rows are B's
// rows (V in P V).
__device__ __forceinline__ void frag_b_cols(uint32_t& b0, uint32_t& b1,
                                            const bf16* s, int n0, int k0,
                                            int g, int t) {
  const bf16* p = s + (k0 + 2 * t) * LDS + n0 + g;
  b0 = pack_bf16(p[0], p[LDS]);
  b1 = pack_bf16(p[8 * LDS], p[9 * LDS]);
}

// c (16 x 8 NT) = rows [m0, m0 + 16) of tile a times the first 8 NT rows
// of tile b, transposed (a dot product over the head dim per element).
template <int NT>
__device__ __forceinline__ void dot_rows(float (*c)[4], const bf16* a_s,
                                         int m0, const bf16* b_s, int g,
                                         int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, a_s, m0, kk * 16, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b0, b1;
      frag_b_rows(b0, b1, b_s, n * 8, kk * 16, g, t);
      mma(c[n], a, b0, b1);
    }
  }
}

// acc (16 x D) += p (16 x 16 KT, an accumulator in C layout, as bf16)
// times the first 16 KT rows of tile b.
template <int KT>
__device__ __forceinline__ void acc_times(float (*acc)[4], float (*p)[4],
                                          const bf16* b_s, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    frag_a_acc(a, p, kk);
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      uint32_t b0, b1;
      frag_b_cols(b0, b1, b_s, n * 8, kk * 16, g, t);
      mma(acc[n], a, b0, b1);
    }
  }
}

// `rows` x D elements from device memory (row stride `stride`, head dim
// contiguous) into a shared tile, 16 bytes per thread and load.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          i64 stride, int rows) {
  for (int i = threadIdx.x; i < rows * (D / 8); i += THREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDS + c) =
        *reinterpret_cast<const uint4*>(src + r * stride + c);
  }
}

__device__ __forceinline__ void zero(float (*c)[4]) {
#pragma unroll
  for (int n = 0; n < DT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// Rows r and r + 8 of a 16-row accumulator, times `mul`, as bf16 into
// contiguous (b, s, h, d) rows.
__device__ __forceinline__ void store_rows(bf16* out, float (*c)[4],
                                           i64 row_r, i64 row_r8, float mul0,
                                           float mul1, int t) {
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    *reinterpret_cast<uint32_t*>(out + row_r + n * 8 + 2 * t) =
        pack_f32(c[n][0] * mul0, c[n][1] * mul0);
    *reinterpret_cast<uint32_t*>(out + row_r8 + n * 8 + 2 * t) =
        pack_f32(c[n][2] * mul1, c[n][3] * mul1);
  }
}

// Forward: grid (s / TILE query tiles, b * heads).
__global__ void __launch_bounds__(THREADS)
    flash_fwd(Qkv in, bf16* __restrict__ o, float* __restrict__ lse, int s,
              int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + TILE * LDS;
  bf16* v_s = k_s + TILE * LDS;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * TILE;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const bf16* kp = in.k + bi * in.kb + hi * in.kh;
  const bf16* vp = in.v + bi * in.vb + hi * in.vh;
  load_tile(q_s, in.q + bi * in.qb + hi * in.qh + q0 * in.qs, in.qs, TILE);

  float acc[DT][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int j = 0; j <= qt; ++j) {
    const int k0 = j * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_tile(k_s, kp + k0 * in.ks, in.ks, TILE);
    load_tile(v_s, vp + k0 * in.vs, in.vs, TILE);
    __syncthreads();
    float sc[TILE / 8][4];
    dot_rows<TILE / 8>(sc, q_s, warp * 16, k_s, g, t);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + (e >> 1) * 8;
        const int c = k0 + n * 8 + 2 * t + (e & 1);
        const float x = c > r ? -INFINITY : sc[n][e] * scale;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // Each row is spread over the 4 lanes of one g; key k0 <= row is
    // always visible, so the new max is finite.
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - m[e >> 1]);
        sc[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    acc_times<TILE / 16>(acc, sc, v_s, g, t);
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    inv[i] = 1.f / l[i];
    if (t == 0) {
      lse[(i64)blockIdx.y * s + row0 + 8 * i] = m[i] + logf(l[i]);
    }
  }
  const i64 base = (i64)bi * s * heads * D + (i64)hi * D;
  store_rows(o, acc, base + (i64)row0 * heads * D,
             base + (i64)(row0 + 8) * heads * D, inv[0], inv[1], t);
}

// D[b, h, r] = sum_d dO[b, r, h, d] * O[b, r, h, d]: one warp per row of
// the contiguous (b, s, h) rows.
__global__ void __launch_bounds__(THREADS)
    flash_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    float* __restrict__ delta, int s, int heads, int rows) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const bf16* op = o + (i64)row * D + lane * 4;
  const bf16* dp = dout + (i64)row * D + lane * 4;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sum += __bfloat162float(op[i]) * __bfloat162float(dp[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(FULL, sum, off);
  }
  if (lane == 0) {
    const int hi = row % heads;
    const int r = (row / heads) % s;
    const int bi = row / (heads * s);
    delta[((i64)bi * heads + hi) * s + r] = sum;
  }
}

// dK and dV: grid (s / TILE key tiles, b * heads).  Warp w owns keys
// [k0 + 16 w, k0 + 16 w + 16) and walks the queries from k0 to the end in
// steps of QSUB, holding S^T and dP^T (16 x QSUB) in registers.
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv(Qkv in, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int s, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + TILE * LDS;
  bf16* q_s = v_s + TILE * LDS;
  bf16* do_s = q_s + QSUB * LDS;
  float* l_s = reinterpret_cast<float*>(do_s + QSUB * LDS);
  float* d_s = l_s + QSUB;
  const int kt = blockIdx.x;  // the first key tiles see the most queries
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * TILE;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const i64 row_stride = (i64)heads * D;  // of the contiguous dO
  const bf16* qp = in.q + bi * in.qb + hi * in.qh;
  const bf16* dop = dout + (i64)bi * s * row_stride + (i64)hi * D;
  const float* lp = lse + (i64)blockIdx.y * s;
  const float* dp = delta + (i64)blockIdx.y * s;
  load_tile(k_s, in.k + bi * in.kb + hi * in.kh + k0 * in.ks, in.ks, TILE);
  load_tile(v_s, in.v + bi * in.vb + hi * in.vh + k0 * in.vs, in.vs, TILE);

  float dk_acc[DT][4], dv_acc[DT][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int i0 = k0; i0 < s; i0 += QSUB) {
    __syncthreads();  // the previous step's readers are done
    load_tile(q_s, qp + i0 * in.qs, in.qs, QSUB);
    load_tile(do_s, dop + i0 * row_stride, row_stride, QSUB);
    if (threadIdx.x < QSUB) {
      l_s[threadIdx.x] = lp[i0 + threadIdx.x];
      d_s[threadIdx.x] = dp[i0 + threadIdx.x];
    }
    __syncthreads();
    float st[QSUB / 8][4], dpt[QSUB / 8][4];
    dot_rows<QSUB / 8>(st, k_s, warp * 16, q_s, g, t);    // S^T = K Q^T
    dot_rows<QSUB / 8>(dpt, v_s, warp * 16, do_s, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < QSUB / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + (e >> 1) * 8;
        const int qc = n * 8 + 2 * t + (e & 1);
        const float p =
            i0 + qc < key ? 0.f : expf(st[n][e] * scale - l_s[qc]);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - d_s[qc]);  // dS^T
      }
    }
    acc_times<QSUB / 16>(dv_acc, st, do_s, g, t);  // dV += P^T dO
    acc_times<QSUB / 16>(dk_acc, dpt, q_s, g, t);  // dK += dS^T Q
  }
  const i64 base = (i64)bi * s * row_stride + (i64)hi * D;
  const i64 r0 = base + (i64)key0 * row_stride;
  const i64 r8 = base + (i64)(key0 + 8) * row_stride;
  store_rows(dk, dk_acc, r0, r8, scale, scale, t);
  store_rows(dv, dv_acc, r0, r8, 1.f, 1.f, t);
}

// dQ: grid (s / TILE query tiles, b * heads).  Warp w owns queries
// [q0 + 16 w, q0 + 16 w + 16) and walks the key tiles up to the diagonal.
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq(Qkv in, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int s, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + TILE * LDS;
  bf16* k_s = do_s + TILE * LDS;
  bf16* v_s = k_s + TILE * LDS;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * TILE;
  const int row0 = q0 + warp * 16 + g;
  const i64 row_stride = (i64)heads * D;
  const i64 base = (i64)bi * s * row_stride + (i64)hi * D;
  const bf16* kp = in.k + bi * in.kb + hi * in.kh;
  const bf16* vp = in.v + bi * in.vb + hi * in.vh;
  load_tile(q_s, in.q + bi * in.qb + hi * in.qh + q0 * in.qs, in.qs, TILE);
  load_tile(do_s, dout + base + q0 * row_stride, row_stride, TILE);
  const float* lp = lse + (i64)blockIdx.y * s;
  const float* dp = delta + (i64)blockIdx.y * s;
  const float lr[2] = {lp[row0], lp[row0 + 8]};
  const float dr[2] = {dp[row0], dp[row0 + 8]};

  float dq_acc[DT][4];
  zero(dq_acc);
  for (int j = 0; j <= qt; ++j) {
    const int k0 = j * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_tile(k_s, kp + k0 * in.ks, in.ks, TILE);
    load_tile(v_s, vp + k0 * in.vs, in.vs, TILE);
    __syncthreads();
    float sc[TILE / 8][4], dpr[TILE / 8][4];
    dot_rows<TILE / 8>(sc, q_s, warp * 16, k_s, g, t);    // S = Q K^T
    dot_rows<TILE / 8>(dpr, do_s, warp * 16, v_s, g, t);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + (e >> 1) * 8;
        const int c = k0 + n * 8 + 2 * t + (e & 1);
        const float p =
            c > r ? 0.f : expf(sc[n][e] * scale - lr[e >> 1]);
        dpr[n][e] = p * (dpr[n][e] - dr[e >> 1]);  // dS
      }
    }
    acc_times<TILE / 16>(dq_acc, dpr, k_s, g, t);  // dQ += dS K
  }
  store_rows(dq, dq_acc, base + (i64)row0 * row_stride,
             base + (i64)(row0 + 8) * row_stride, scale, scale, t);
}

constexpr size_t FWD_SMEM = sizeof(bf16) * 3 * TILE * LDS;
constexpr size_t DKDV_SMEM =
    sizeof(bf16) * (2 * TILE + 2 * QSUB) * LDS + sizeof(float) * 2 * QSUB;
constexpr size_t DQ_SMEM = sizeof(bf16) * 4 * TILE * LDS;

Qkv make_qkv(const void* q, const void* k, const void* v, i64 qb, i64 qs,
             i64 qh, i64 kb, i64 ks, i64 kh, i64 vb, i64 vs, i64 vh) {
  return Qkv{(const bf16*)q, (const bf16*)k, (const bf16*)v, qb, qs, qh,
             kb, ks, kh, vb, vs, vh};
}

}  // namespace

// q, k, v (b, s, heads, 128) bf16 at the given element strides (head dim
// contiguous, every stride a multiple of 8, pointers 16-byte aligned);
// s a multiple of 64.  out (b, s, heads, 128) bf16 and lse (b, heads, s)
// f32, both contiguous.
extern "C" int cea_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, long long qb,
                             long long qs, long long qh, long long kb,
                             long long ks, long long kh, long long vb,
                             long long vs, long long vh, int b, int s,
                             int heads, void* stream) {
  int err = (int)cudaFuncSetAttribute(
      flash_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (err) return err;
  flash_fwd<<<dim3(s / TILE, b * heads), THREADS, FWD_SMEM,
              (cudaStream_t)stream>>>(
      make_qkv(q, k, v, qb, qs, qh, kb, ks, kh, vb, vs, vh), (bf16*)out,
      (float*)lse, s, heads, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// The same q, k, v; out and lse from cea_flash_fwd; dout (b, s, heads,
// 128) bf16 contiguous; delta (b, heads, s) f32 scratch; dq, dk, dv
// (b, s, heads, 128) bf16 contiguous.
extern "C" int cea_flash_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* lse,
                             const void* dout, void* delta, void* dq,
                             void* dk, void* dv, long long qb, long long qs,
                             long long qh, long long kb, long long ks,
                             long long kh, long long vb, long long vs,
                             long long vh, int b, int s, int heads,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Qkv in = make_qkv(q, k, v, qb, qs, qh, kb, ks, kh, vb, vs, vh);
  const float scale = 1.0f / sqrtf((float)D);
  const int rows = b * s * heads;
  flash_bwd_delta<<<(rows + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      (const bf16*)out, (const bf16*)dout, (float*)delta, s, heads, rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = (int)cudaFuncSetAttribute(flash_bwd_dkdv,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)DKDV_SMEM);
  if (err) return err;
  flash_bwd_dkdv<<<dim3(s / TILE, b * heads), THREADS, DKDV_SMEM, st>>>(
      in, (const bf16*)dout, (const float*)lse, (const float*)delta,
      (bf16*)dk, (bf16*)dv, s, heads, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = (int)cudaFuncSetAttribute(
      flash_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DQ_SMEM);
  if (err) return err;
  flash_bwd_dq<<<dim3(s / TILE, b * heads), THREADS, DQ_SMEM, st>>>(
      in, (const bf16*)dout, (const float*)lse, (const float*)delta,
      (bf16*)dq, s, heads, scale);
  return (int)cudaGetLastError();
}
