// Causal flash attention, forward and backward, for Hopper (sm_90a), at
// every head dim that is a multiple of 8 up to 256: instances at d 64, 128
// and 256, each running any smaller d down to the next instance's; and
// one instance with v narrower than q and k, at (192, 128).
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
// q / k / v / o, the backward at least 2.5x the forward's flops.  The
// products do not depend on the h / d split of a width; the exponentials,
// b h s^2 / 2 of them, do: at d 32 (h 32) they, not the tensor cores, bound
// the kernels.
//
// Design (the primitives are in hopper_mma.cuh):
//   - Every product is a wgmma (m64nNk16, bf16 in, f32 sums).  A block is
//     two warpgroups; each owns 64 rows of the block's 128 (queries in the
//     forward and the dQ pass, keys in the dK / dV pass) and keeps its
//     accumulators in registers.  The first products of a step (Q K^T,
//     dO V^T, and their transposes K Q^T, V dO^T) take both operands from
//     shared memory; the second ones (P V, P^T dO, dS^T Q, dS K) take A
//     from registers, the f32 scores rounded to bf16 where they lie, and
//     B from the row-major tile through wgmma's transpose flag.
//   - Shared tiles are stored in the 128-byte swizzle (a 64-column atom a
//     row; d 128 is two atoms), with no padding.
//   - The streamed operand (K / V tiles of 128 keys in the forward and the
//     dQ pass, Q / dO tiles of 64 queries with their L and D in the dK / dV
//     pass) goes through a ring of 2-4 stages in shared memory that TMA
//     fills: one thread announces a stage's bytes to its mbarrier and
//     starts cp.async.bulk.tensor, the hardware writes the swizzle and
//     zero-fills rows past s, and every thread waits on the mbarrier when
//     it needs the tile.  The tensor maps are encoded on the host at each
//     call from the views' own strides (q, k, v are strided views of one
//     projection).  Copies run one or two steps ahead of their use, so they
//     are in flight while the tensor cores work; one __syncthreads() a step
//     tells the copying thread that a stage's readers are done.
//   - Each step first starts the products of the new scores and then the
//     ones that consume the previous step's P (or dS), waits for the first
//     only, and does the new tile's exponentials while the second run.
//     In the forward (and the dQ pass at d 64) the two warpgroups also take
//     turns: one does its softmax while the other's products run.
//   - Softmax in base 2: exp2(s * scale * log2(e) - m), one FFMA and one
//     MUFU an element; the accumulator is rescaled every tile; only the
//     tiles that cross the diagonal are masked, tiles above it skipped.
//   - The backward keeps two passes (7 tile products where 5 are the
//     least): each dq / dk / dv element is summed by one thread in a fixed
//     order, so two runs give the same bits, with no atomics and no f32
//     dQ scratch.  D is its own small launch with 16-byte loads.
//   - Launch order: a grid of (tiles, batch * heads) with the heaviest
//     tiles first in x (the last query tiles, the first key tiles), so
//     the light tiles fill the tail, and the blocks in flight share a few
//     heads' K / V in the L2.
//   - s is a multiple of 64, not of 128: the rows of a block's last tile
//     past s are zero-filled on load (so a masked P meets no garbage in
//     V), masked by the causal rule, and not stored.
//   - A head dim d below its instance's D (d 32 on the d-64 instance, d 96
//     on the d-128 one): the tensor maps' innermost extent is d, so TMA
//     zero-fills columns d..D-1 of every tile; zero columns add nothing to
//     Q K^T or dO V^T and give zero columns of O, dQ, dK and dV, which are
//     not stored.  The softmax scale is the true d's.  d 32 runs on the
//     d-64 instance rather than one of its own in the 64-byte swizzle:
//     there the exponentials bound the kernels, not the products it pads.
//   - d 256 (Tiles): a 64 x 256 f32 accumulator is 128 registers a thread
//     and a 64 x 256 bf16 tile 32 KB, so the forward takes 64-key stages in
//     rings of two, the dQ pass one warpgroup of 64 query rows a block (Q,
//     dO and five stages fill shared memory), and dK / dV its own pass
//     (flash_bwd_dkdv_split), one warpgroup for each sum.
//   - q . k wider than p . v: the (DQK, DV) = (192, 128) pair of latent
//     attention (DeepSeek-V3's MLA, q . k over 128 + 64 rope columns) has
//     kernels of its own (flash_fwd_wide_qk, flash_bwd_dq_wide_qk,
//     flash_bwd_dkdv_wide_qk; D by flash_bwd_delta<128>), so no product
//     runs at a padded width: on the d-256 instance, v zero-padded, the
//     forward did 1.6x and the backward 1.54x the true work, on d 256's
//     tiles.  v, O, dO and dV are DV wide; q, k, dQ and dK DQK.  The
//     forward keeps d 128's shape (O and S at 128 keys, 64 x 128 f32 each
//     a warpgroup) with 128-key stages in rings of two (Q 48 KB, a K stage
//     48, a V stage 32).  The dQ pass keeps two warpgroups of 64 query rows
//     with 64-key stages (dQ 96 registers a thread, S and dP 32 each; K in
//     a ring of four, V of three, both copied two steps ahead; 226 KB).  The
//     dK / dV pass holds dK (96) and dV (64) a thread, which leaves
//     registers for one 64-query step's S^T and dP^T (32 each) but not for
//     a second in flight: a warpgroup's step is serial, and the two
//     warpgroups run half a step apart, so one's exponentials run under the
//     other's products.  ptxas: 186 / 203 / 254 registers, no spills (the
//     dK / dV pass is at the edge: its first wait hoisted out of the
//     warpgroups' branches spilled 104 bytes and ran slower).
//     Measured at (8, 8192, 16) (NVIDIA H100 80GB HBM3, 700 W; CUDA events,
//     10 calls): forward 4.53-4.76 ms, backward 16.61-17.63 ms (dK / dV
//     8.61-9.15, dQ 6.71-7.08, D 0.18), against 8.07 / 29.18 ms on the
//     d-256 instance with v padded and true-width bounds of 2.78 / 7.23 ms.
//     Other dK / dV shapes measured so: 32-query stages, the next step's
//     products in flight (wgmma N 32; 237 registers), 11.35-11.91 ms;
//     64-query stages that way, 255 registers, 348 bytes spilled and wgmma
//     serialized (C7512), backward 24.57 ms; 64-query steps serial in both
//     warpgroups at once, 9.58-9.60 ms.
//
// q, k and v are read through their (batch, seq, head) strides with the
// head dim contiguous, so the strided q / k / v views of the fused qkv
// projection (and latent attention's v, a view of its kv projection) are
// read in place.  O, dO, dQ, dK and dV are contiguous (b, s, h, d, or
// v's width for O, dO and dV); L and D are (b, h, s) f32.
//
// Plain C interface, bound with ctypes.  Each entry point returns
// cudaGetLastError() after its launches (or the code of a tensor map that
// could not be encoded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "tma_host.cuh"

namespace {

using namespace cea;

constexpr int THREADS = 2 * WG_THREADS;  // two warpgroups a block
constexpr int BM = 128;  // rows a block owns: 64 a warpgroup
constexpr int BN = 128;  // keys a stage in the forward and the dQ pass
constexpr int BQ = 64;   // queries a stage in the dK / dV pass
// Ring depths: a tile read in one step and copied one step ahead needs 2
// stages; one more for a second step of reading or of copying ahead.
constexpr int STAGES = 2;       // V in the dQ pass
constexpr int LONG_STAGES = 3;  // K and V in the forward, K in the dQ pass
constexpr int DKDV_STAGES = 4;  // Q / dO with L and D in the dK / dV pass
// At d 256 a 64 x 256 bf16 tile is 32 KB: the d-128 tiling does not fit
// in shared memory or registers, so the d-256 instance takes 64-key stages
// in two-stage rings in the forward, 64 query rows a block (one warpgroup)
// in the dQ pass, and a dK / dV pass of its own (flash_bwd_dkdv_split).
template <int D>
struct Tiles {
  static constexpr int FWD_BN = D == 256 ? 64 : BN;  // keys a forward stage
  static constexpr int FWD_STAGES = D == 256 ? STAGES : LONG_STAGES;
  static constexpr int DQ_WGS = D == 256 ? 1 : 2;  // warpgroups a dQ block
  // Its query rows, and the keys of a dQ stage (the diagonal tile is
  // square); also the rows of the dK / dV pass's K and V tiles.
  static constexpr int DQ_BM = 64 * DQ_WGS;
};
constexpr int SPLIT_STAGES = 2;  // Q / dO stages of flash_bwd_dkdv_split
template <bool DK>
struct Role {  // a warpgroup's sum in flash_bwd_dkdv_split: dK or dV
  static constexpr bool dk = DK;
};
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// The first 1024-byte boundary of the dynamic shared memory: the kernels
// keep their mbarriers (8 bytes each) in the 1024 bytes from there, and
// their tiles after those.
__device__ __forceinline__ uint32_t align_1k(const void* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
}

// One thread sets up `count` mbarriers of one arrival each; then everyone
// may use them.
__device__ __forceinline__ void init_barriers(uint32_t bars, int count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < count; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// acc (64 x N) = rows [row_byte / 128, + 64) of the K-major tile a (A_ROWS
// rows) times the first N rows of the K-major tile b (B_ROWS rows),
// transposed: a dot product over the head dim per element.
template <int D, int N, int A_ROWS, int B_ROWS>
__device__ __forceinline__ void dot_rows(float (&acc)[N / 2], uint32_t a,
                                         uint32_t row_byte, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<N>(acc,
                desc_k(a + (kk / 4) * (A_ROWS * 128) + row_byte +
                       (kk % 4) * 32),
                desc_k(b + (kk / 4) * (B_ROWS * 128) + (kk % 4) * 32),
                kk > 0);
  }
}

// acc (64 x D) += p (64 x K, bf16 A operands) times the first K rows of
// the row-major tile b (B_ROWS rows x D).
template <int D, int K, int B_ROWS>
__device__ __forceinline__ void acc_times(float (&acc)[D / 2],
                                          const uint32_t (&p)[K / 4],
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    wgmma_rs<D>(acc, &p[4 * kk], desc_mn(b + kk * 2048, B_ROWS * 128), 1);
  }
}

// Rows r and r + 8 of a warpgroup accumulator (64 x D), times `mul`, as
// bf16 into contiguous (b, s, h, d) rows; rows at or past `limit` and
// columns at or past the head dim d (<= D) skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&c)[D / 2],
                                           i64 base, i64 row_stride, int row,
                                           int limit, float mul0, float mul1,
                                           int t, int d) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (n * 8 + 2 * t >= d) continue;
    if (row < limit) {
      *reinterpret_cast<uint32_t*>(out + base + (i64)row * row_stride +
                                   n * 8 + 2 * t) =
          pack_f32(c[4 * n] * mul0, c[4 * n + 1] * mul0);
    }
    if (row + 8 < limit) {
      *reinterpret_cast<uint32_t*>(out + base + (i64)(row + 8) * row_stride +
                                   n * 8 + 2 * t) =
          pack_f32(c[4 * n + 2] * mul1, c[4 * n + 3] * mul1);
    }
  }
}

template <int D>
__host__ __device__ constexpr int fwd_smem() {
  return 2048 + 2 * (BM * D + Tiles<D>::FWD_STAGES * 2 * Tiles<D>::FWD_BN * D);
}

// Forward: grid (ceil(s / BM) query tiles, b * heads).  Step j starts
// S_j = Q K_j^T and then O += P_{j-1} V_{j-1}, waits for S_j only, and does
// tile j's softmax while the P V product runs; K_{j+2} and V_{j+1} are
// copied meanwhile (V is used one step after its K).  At d 256 the stages
// hold 64 keys and the rings two: K_{j+1} and V_j are copied in step j.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              bf16* __restrict__ o, float* __restrict__ lse, int s, int heads,
              int d, float scale_log2) {
  extern __shared__ unsigned char smem[];
  constexpr int KN = Tiles<D>::FWD_BN;       // keys a stage
  constexpr int RING = Tiles<D>::FWD_STAGES;
  constexpr int AHEAD = RING - 1;  // steps a K copy runs ahead of its use
  constexpr uint32_t TILE_BYTES = KN * D * 2;
  const uint32_t bars = align_1k(smem);  // K's stages, then V's
  const uint32_t q_s = bars + 1024;
  const uint32_t k_ring = q_s + BM * D * 2;
  const uint32_t v_ring = k_ring + RING * TILE_BYTES;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int wg = threadIdx.x / WG_THREADS;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * BM;
  const int row_l = wg * 64 + warp * 16 + g;  // in the tile; and row_l + 8
  // The last key tile any row of this block sees (qt where KN == BM).
  const int last = (min(q0 + BM, s) + KN - 1) / KN - 1;
  // Tile j of K (or V) lives in stage j % RING, whose barrier it completes
  // for the (j / RING)-th time.
  auto copy_k = [&](int j, uint32_t extra) {
    const uint32_t bar = bars + 8 * (j % RING);
    mbar_expect(bar, TILE_BYTES + extra);
    tma_tile<D, KN>(k_ring + (j % RING) * TILE_BYTES, &map_k, bar, hi, j * KN,
                    bi);
  };
  auto copy_v = [&](int j) {
    const uint32_t bar = bars + 8 * (RING + j % RING);
    mbar_expect(bar, TILE_BYTES);
    tma_tile<D, KN>(v_ring + (j % RING) * TILE_BYTES, &map_v, bar, hi, j * KN,
                    bi);
  };
  auto wait_k = [&](int j) {
    mbar_wait(bars + 8 * (j % RING), (j / RING) & 1);
  };
  auto wait_v = [&](int j) {
    mbar_wait(bars + 8 * (RING + j % RING), (j / RING) & 1);
  };
  init_barriers(bars, 2 * RING);
  if (threadIdx.x == 0) {
    copy_k(0, BM * D * 2);  // Q rides on K_0's barrier
    tma_tile<D, BM>(q_s, &map_q, bars, hi, q0, bi);
    if constexpr (AHEAD == 2) {
      if (last > 0) copy_k(1, 0);
      copy_v(0);
    }
  }

  float acc[D / 2], sc[KN / 2];
  uint32_t p[KN / 4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY};  // running row max of the raw scores
  float l[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};  // what the last softmax owes the old O

  // K_j and V_{j-1} are in, and every thread is past step j - 1.
  auto arrive = [&](int j) {
    wait_k(j);
    if (j > 0) wait_v(j - 1);
    __syncthreads();
  };
  // Starts the copies of K_{j+AHEAD} and V_{j+AHEAD-1}, once step j - 1 is
  // over: AHEAD steps ahead of their use.
  auto copies = [&](int j) {
    if (threadIdx.x == 0) {
      if (j + AHEAD <= last) copy_k(j + AHEAD, 0);
      if (j + AHEAD - 1 <= last) copy_v(j + AHEAD - 1);
    }
  };
  // sc = Q K_j^T, in flight.
  auto scores = [&](int j) {
    dot_rows<D, KN, BM, KN>(sc, q_s, wg * 64 * 128,
                            k_ring + (j % RING) * TILE_BYTES);
    wgmma_commit();
  };
  // O = alpha O + P V_j, in flight: O owes the last softmax its alpha.
  auto times_v = [&](int j) {
    // Once the running max has settled alpha is 1 for whole warps.
    if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    pin(p);
    wgmma_fence();
    acc_times<D, KN, KN>(acc, p, v_ring + (j % RING) * TILE_BYTES);
    wgmma_commit();
  };
  // Tile j's online softmax on the raw scores in sc: m and l move on, alpha
  // is what O must be scaled by before P V is added, and P goes to p as
  // bf16 once the product that reads p is over.
  auto softmax = [&](int j) {
    if constexpr (KN == BM) {
      if (j == last) {  // the diagonal tile: compare in the tile
#pragma unroll
        for (int i = 0; i < KN / 2; ++i) {
          const int col = (i >> 2) * 8 + 2 * t + (i & 1);
          if (col > row_l + ((i >> 1) & 1) * 8) sc[i] = -INFINITY;
        }
      }
    } else if ((j + 1) * KN > q0) {  // a tile past the block's first row
      const int kb = j * KN - q0;
#pragma unroll
      for (int i = 0; i < KN / 2; ++i) {
        const int col = kb + (i >> 2) * 8 + 2 * t + (i & 1);
        if (col > row_l + ((i >> 1) & 1) * 8) sc[i] = -INFINITY;
      }
    }
    // Each row is spread over the 4 lanes of one g; key 0 of the first
    // tile is visible to every row, so the new max is finite (a later
    // tile wholly masked for a row leaves it where it was).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      alpha[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -ms[r]));
      l[r] += sc[i];
    }
    wgmma_wait<0>();
    pin(acc);
    pin(p);
    pack_a<KN>(p, sc);
  };

  // The two warpgroups take turns at the tensor cores inside each step:
  // the first starts its products at the step's start and does its softmax
  // after them; the second does the softmax of the scores it got in the
  // step before and then starts its own, so each one's softmax runs under the
  // other's products.
  arrive(0);
  copies(0);
  wgmma_fence();
  scores(0);
  wgmma_wait<0>();
  pin(sc);
  if (wg == 0) {
    softmax(0);
    for (int j = 1; j <= last; ++j) {
      arrive(j);
      wgmma_fence();
      scores(j);
      copies(j);
      times_v(j - 1);
      wgmma_wait<1>();  // S_j is there; P V may still run
      pin(sc);
      softmax(j);
    }
  } else {
    for (int j = 1; j <= last; ++j) {
      arrive(j);
      softmax(j - 1);
      times_v(j - 1);
      scores(j);
      wgmma_wait<0>();
      pin(acc);
      pin(p);
      pin(sc);
    }
    softmax(last);
  }
  wait_v(last);
  times_v(last);
  wgmma_wait<0>();
  pin(acc);
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    inv[r] = 1.f / l[r];
    const int row = q0 + row_l + 8 * r;
    if (t == 0 && row < s) {
      lse[(i64)blockIdx.y * s + row] =
          (m[r] * scale_log2 + log2f(l[r])) * LN2;
    }
  }
  store_rows<D>(o, acc, (i64)bi * s * heads * d + (i64)hi * d,
                (i64)heads * d, q0 + row_l, s, inv[0], inv[1], t, d);
}

// D[b, h, r] = sum_d dO[b, r, h, d] * O[b, r, h, d] over the contiguous
// (b, s, h) rows of d elements: D / 8 lanes a row, 16 bytes a lane (the
// lanes past d read nothing).
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    float* __restrict__ delta, int s, int heads, int rows,
                    int d) {
  constexpr int LPR = D / 8;  // lanes a row
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  const int row = idx / LPR;
  const int live = row < rows;  // whole warps stay for the shuffles
  const int col = (idx % LPR) * 8;
  const i64 at = (i64)(live ? row : 0) * d + (col < d ? col : 0);
  uint4 ov = *reinterpret_cast<const uint4*>(o + at);
  uint4 dv = *reinterpret_cast<const uint4*>(dout + at);
  if (col >= d) ov = dv = make_uint4(0u, 0u, 0u, 0u);
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(o2[i]);
    const float2 b = __bfloat1622float2(d2[i]);
    sum += a.x * b.x + a.y * b.y;
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(FULL, sum, off);
  }
  if (live && idx % LPR == 0) {
    const int hi = row % heads;
    const int r = (row / heads) % s;
    const int bi = row / (heads * s);
    delta[((i64)bi * heads + hi) * s + r] = sum;
  }
}

template <int D>
__host__ __device__ constexpr int dkdv_stage() {
  return 2 * BQ * D * 2 + 1024;  // Q, dO, then L and D (BQ floats each)
}

template <int D>
__host__ __device__ constexpr int dkdv_smem() {
  return 2048 + 2 * BM * D * 2 + DKDV_STAGES * dkdv_stage<D>();
}

// dK and dV: grid (ceil(s / BM) key tiles, b * heads).  Warpgroup w owns
// keys [k0 + 64 w, k0 + 64 w + 64) and walks the queries from k0 + 64 w to
// the end in steps of BQ, holding S^T and dP^T (64 x BQ) in registers.  Step
// `it` starts S^T = K Q^T and dP^T = V dO^T of its queries and then the
// dV / dK products of step it - 1, waits for the first two only, and does
// its exponentials while the others run; a stage is read for two steps and
// copied two steps ahead, so the ring has four.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv(const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int s, int heads, int d,
                   float scale) {
  extern __shared__ unsigned char smem[];
  const uint32_t bars = align_1k(smem);  // one a stage of the ring
  const uint32_t k_s = bars + 1024;
  const uint32_t v_s = k_s + BM * D * 2;
  const uint32_t ring = v_s + BM * D * 2;
  unsigned char* ring_p = smem + (ring - smem_u32(smem));
  constexpr uint32_t STAGE = dkdv_stage<D>();
  constexpr uint32_t TILE_BYTES = BQ * D * 2;
  const int kt = blockIdx.x;  // the first key tiles see the most queries
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int wg = threadIdx.x / WG_THREADS;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * BM;
  const int key = k0 + wg * 64 + warp * 16 + g;  // and key + 8
  const i64 row_stride = (i64)heads * d;  // of the contiguous dK, dV
  const float* lp = lse + (i64)blockIdx.y * s;
  const float* dp = delta + (i64)blockIdx.y * s;
  const float scale_log2 = scale * LOG2E;
  const int steps = (s - k0) / BQ;

  // Step `it` (queries from k0 + it BQ, a multiple of 64, so all below s)
  // lives in stage it % 4, whose barrier it completes for the (it / 4)-th
  // time: Q, dO, L and D.  One thread.
  auto copy_step = [&](int it, uint32_t extra) {
    const int i0 = k0 + it * BQ;
    const uint32_t at = ring + (it % DKDV_STAGES) * STAGE;
    const uint32_t bar = bars + 8 * (it % DKDV_STAGES);
    mbar_expect(bar, 2 * TILE_BYTES + 2 * BQ * 4 + extra);
    tma_tile<D, BQ>(at, &map_q, bar, hi, i0, bi);
    tma_tile<D, BQ>(at + TILE_BYTES, &map_do, bar, hi, i0, bi);
    bulk_load(at + 2 * TILE_BYTES, lp + i0, BQ * 4, bar);
    bulk_load(at + 2 * TILE_BYTES + BQ * 4, dp + i0, BQ * 4, bar);
  };
  init_barriers(bars, DKDV_STAGES);
  if (threadIdx.x == 0) {
    copy_step(0, 2 * BM * D * 2);  // K and V ride on step 0's barrier
    tma_tile<D, BM>(k_s, &map_k, bars, hi, k0, bi);
    tma_tile<D, BM>(v_s, &map_v, bars, hi, k0, bi);
    if (steps > 1) copy_step(1, 0);
  }

  float dk_acc[D / 2], dv_acc[D / 2], st[BQ / 2], dpt[BQ / 2];
  uint32_t pp[BQ / 4], ds[BQ / 4];
  zero(dk_acc);
  zero(dv_acc);

  // Step it is in and every thread is past step it - 1; then the copies of
  // step it + 2 start.
  auto advance = [&](int it) {
    mbar_wait(bars + 8 * (it % DKDV_STAGES), (it / DKDV_STAGES) & 1);
    __syncthreads();
    if (threadIdx.x == 0 && it + 2 < steps) copy_step(it + 2, 0);
  };
  // st = S^T = K Q^T and dpt = dP^T = V dO^T of step it, in flight.
  auto scores = [&](int it) {
    const uint32_t q_s = ring + (it % DKDV_STAGES) * STAGE;
    dot_rows<D, BQ, BM, BQ>(st, k_s, wg * 64 * 128, q_s);
    dot_rows<D, BQ, BM, BQ>(dpt, v_s, wg * 64 * 128, q_s + TILE_BYTES);
    wgmma_commit();
  };
  // dV += P^T dO and dK += dS^T Q of step it, in flight.
  auto sums = [&](int it) {
    const uint32_t q_s = ring + (it % DKDV_STAGES) * STAGE;
    acc_times<D, BQ, BQ>(dv_acc, pp, q_s + TILE_BYTES);
    acc_times<D, BQ, BQ>(dk_acc, ds, q_s);
    wgmma_commit();
  };
  // st becomes P^T and dpt dS^T, from step it's L and D.
  auto pointwise = [&](int it) {
    const int i0 = k0 + it * BQ;
    const float* l_s = reinterpret_cast<const float*>(
        ring_p + (it % DKDV_STAGES) * STAGE + 2 * TILE_BYTES);
    const float* d_s = l_s + BQ;
    const bool diagonal = i0 < k0 + BM;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(l_s + n * 8 + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(d_s + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = i0 + n * 8 + 2 * t + (e & 1);
        const float lq = (e & 1) ? l2.y : l2.x;
        const float dq = (e & 1) ? d2.y : d2.x;
        float p = fast_exp2(fmaf(st[4 * n + e], scale_log2, -lq * LOG2E));
        if (diagonal && qi < key + (e >> 1) * 8) p = 0.f;
        st[4 * n + e] = p;
        dpt[4 * n + e] = p * (dpt[4 * n + e] - dq);
      }
    }
  };

  // Step 0's queries all lie before the second warpgroup's keys: it only
  // copies and waits there, and starts at step 1.
  const int first = wg < steps ? wg : steps;
  for (int it = 0; it < first; ++it) advance(it);
  if (first < steps) {
    advance(first);
    wgmma_fence();
    scores(first);
    wgmma_wait<0>();
    pin(st);
    pin(dpt);
    pointwise(first);
    pack_a<BQ>(pp, st);
    pack_a<BQ>(ds, dpt);
    for (int it = first + 1; it < steps; ++it) {
      advance(it);
      pin(pp);
      pin(ds);
      wgmma_fence();
      scores(it);
      sums(it - 1);
      wgmma_wait<1>();  // S^T and dP^T are there; the sums may still run
      pin(st);
      pin(dpt);
      pointwise(it);
      wgmma_wait<0>();  // P^T and dS^T are free again
      pin(dv_acc);
      pin(dk_acc);
      pin(pp);
      pin(ds);
      pack_a<BQ>(pp, st);
      pack_a<BQ>(ds, dpt);
    }
    pin(pp);
    pin(ds);
    wgmma_fence();
    sums(steps - 1);
    wgmma_wait<0>();
    pin(dv_acc);
    pin(dk_acc);
  }
  const i64 base = (i64)bi * s * row_stride + (i64)hi * d;
  store_rows<D>(dk, dk_acc, base, row_stride, key, s, scale, scale, t, d);
  store_rows<D>(dv, dv_acc, base, row_stride, key, s, 1.f, 1.f, t, d);
}

template <int D>
__host__ __device__ constexpr int split_smem() {
  return 2048 + 2 * BQ * D * 2 + SPLIT_STAGES * dkdv_stage<D>();
}

// dK and dV at d 256: grid (s / BQ key tiles, b * heads).  The two 64 x 256
// f32 sums of a key's rows do not fit one thread's registers beside the
// score tiles (256 a thread), so a block owns BQ keys and its warpgroups
// split the sums: warpgroup 0 sums dV = sum P^T dO, warpgroup 1 dK =
// scale * sum dS^T Q, each over the queries from k0 in steps of BQ.  Both
// compute S^T = K Q^T (a fifth product a step where flash_bwd_dkdv does
// four), and warpgroup 1 also dP^T = V dO^T.  A step's stage is read inside
// its step, so a ring of two stages lets the copy run one step ahead (three
// do not fit beside K and V).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_split(const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int s,
                         int heads, int d, float scale) {
  extern __shared__ unsigned char smem[];
  const uint32_t bars = align_1k(smem);  // one a stage of the ring
  const uint32_t k_s = bars + 1024;
  const uint32_t v_s = k_s + BQ * D * 2;
  const uint32_t ring = v_s + BQ * D * 2;
  unsigned char* ring_p = smem + (ring - smem_u32(smem));
  constexpr uint32_t STAGE = dkdv_stage<D>();
  constexpr uint32_t TILE_BYTES = BQ * D * 2;
  const int k0 = blockIdx.x * BQ;
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int wg = threadIdx.x / WG_THREADS;  // 0: dV, 1: dK
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int key = k0 + warp * 16 + g;  // and key + 8
  const float* lp = lse + (i64)blockIdx.y * s;
  const float* dp = delta + (i64)blockIdx.y * s;
  const float scale_log2 = scale * LOG2E;
  const int steps = (s - k0) / BQ;

  // Step `it` (queries from k0 + it BQ) lives in stage it % 2, whose
  // barrier it completes for the (it / 2)-th time: Q, dO, L and D.  One
  // thread.
  auto copy_step = [&](int it, uint32_t extra) {
    const int i0 = k0 + it * BQ;
    const uint32_t at = ring + (it % SPLIT_STAGES) * STAGE;
    const uint32_t bar = bars + 8 * (it % SPLIT_STAGES);
    mbar_expect(bar, 2 * TILE_BYTES + 2 * BQ * 4 + extra);
    tma_tile<D, BQ>(at, &map_q, bar, hi, i0, bi);
    tma_tile<D, BQ>(at + TILE_BYTES, &map_do, bar, hi, i0, bi);
    bulk_load(at + 2 * TILE_BYTES, lp + i0, BQ * 4, bar);
    bulk_load(at + 2 * TILE_BYTES + BQ * 4, dp + i0, BQ * 4, bar);
  };
  init_barriers(bars, SPLIT_STAGES);
  if (threadIdx.x == 0) {
    copy_step(0, 2 * TILE_BYTES);  // K and V ride on step 0's barrier
    tma_tile<D, BQ>(k_s, &map_k, bars, hi, k0, bi);
    tma_tile<D, BQ>(v_s, &map_v, bars, hi, k0, bi);
  }

  // One warpgroup's whole pass, dV (Role<false>) or dK (Role<true>): each
  // warpgroup branches once, so no wgmma sits under a divergent branch
  // inside the loop (ptxas serializes those, C7520).
  const i64 row_stride = (i64)heads * d;  // of the contiguous dK, dV
  const i64 base = (i64)bi * s * row_stride + (i64)hi * d;
  auto pass = [&](auto role) {
    constexpr bool DK = decltype(role)::dk;
    float acc[D / 2], st[BQ / 2], dpt[BQ / 2];
    uint32_t pa[BQ / 4];
    zero(acc);
    for (int it = 0; it < steps; ++it) {
      mbar_wait(bars + 8 * (it % SPLIT_STAGES), (it / SPLIT_STAGES) & 1);
      __syncthreads();  // every thread is past step it - 1: its stage is free
      if (threadIdx.x == 0 && it + 1 < steps) copy_step(it + 1, 0);
      const uint32_t q_s = ring + (it % SPLIT_STAGES) * STAGE;
      const float* l_s = reinterpret_cast<const float*>(
          ring_p + (it % SPLIT_STAGES) * STAGE + 2 * TILE_BYTES);
      const float* d_s = l_s + BQ;
      wgmma_fence();
      dot_rows<D, BQ, BQ, BQ>(st, k_s, 0, q_s);
      if constexpr (DK) {
        dot_rows<D, BQ, BQ, BQ>(dpt, v_s, 0, q_s + TILE_BYTES);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(st);
      if constexpr (DK) pin(dpt);
      // st becomes P^T, and for dK dpt becomes dS^T.
      const int i0 = k0 + it * BQ;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(l_s + n * 8 + 2 * t);
        const float2 d2 =
            *reinterpret_cast<const float2*>(d_s + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = i0 + n * 8 + 2 * t + (e & 1);
          const float lq = (e & 1) ? l2.y : l2.x;
          float p = fast_exp2(fmaf(st[4 * n + e], scale_log2, -lq * LOG2E));
          if (it == 0 && qi < key + (e >> 1) * 8) p = 0.f;
          st[4 * n + e] = p;
          if constexpr (DK) {
            const float dq = (e & 1) ? d2.y : d2.x;
            dpt[4 * n + e] = p * (dpt[4 * n + e] - dq);
          }
        }
      }
      if constexpr (DK) {
        pack_a<BQ>(pa, dpt);
      } else {
        pack_a<BQ>(pa, st);
      }
      wgmma_fence();
      // dK += dS^T Q, or dV += P^T dO.
      acc_times<D, BQ, BQ>(acc, pa, DK ? q_s : q_s + TILE_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
    }
    if constexpr (DK) {
      store_rows<D>(dk, acc, base, row_stride, key, s, scale, scale, t, d);
    } else {
      store_rows<D>(dv, acc, base, row_stride, key, s, 1.f, 1.f, t, d);
    }
  };
  if (wg == 0) {
    pass(Role<false>{});
  } else {
    pass(Role<true>{});
  }
}

template <int D>
__host__ __device__ constexpr int dq_smem() {
  return 2048 + 2 * (2 + LONG_STAGES + STAGES) * Tiles<D>::DQ_BM * D;
}

// dQ: grid (ceil(s / QM) query tiles, b * heads).  Warpgroup w owns queries
// [q0 + 64 w, q0 + 64 w + 64) and walks the key tiles up to the diagonal.
// At d 256 a block is one warpgroup and the tiles 64 rows (QM == KN == 64):
// Q, dO and the five 64 x 256 stages fill shared memory.
// Step j starts S_j = Q K_j^T and dP_j = dO V_j^T and then dQ += dS_{j-1}
// K_{j-1}, waits for the first two only, and does its exponentials while
// the third runs; a K tile is read for two steps, so its ring has three
// stages, V's two.
template <int D>
__global__ void __launch_bounds__(Tiles<D>::DQ_WGS * WG_THREADS, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_do,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int s, int heads, int d, float scale) {
  extern __shared__ unsigned char smem[];
  constexpr int QM = Tiles<D>::DQ_BM;  // query rows a block
  constexpr int KN = QM;               // keys a stage
  constexpr uint32_t TILE_BYTES = KN * D * 2;
  const uint32_t bars = align_1k(smem);  // K's stages, then V's
  const uint32_t q_s = bars + 1024;
  const uint32_t do_s = q_s + QM * D * 2;
  const uint32_t k_ring = do_s + QM * D * 2;
  const uint32_t v_ring = k_ring + LONG_STAGES * TILE_BYTES;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int wg = threadIdx.x / WG_THREADS;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * QM;
  const int row_l = wg * 64 + warp * 16 + g;
  const i64 row_stride = (i64)heads * d;
  const i64 base = (i64)bi * s * row_stride + (i64)hi * d;
  const float scale_log2 = scale * LOG2E;
  // Tile j of K lives in stage j % 3 and of V in stage j % 2; each
  // completes its stage's barrier for the (j / 3)-th or (j / 2)-th time.
  // One thread.
  auto copy_tile = [&](int j, uint32_t extra) {
    const uint32_t k_bar = bars + 8 * (j % LONG_STAGES);
    const uint32_t v_bar = bars + 8 * (LONG_STAGES + (j & 1));
    mbar_expect(k_bar, TILE_BYTES + extra);
    tma_tile<D, KN>(k_ring + (j % LONG_STAGES) * TILE_BYTES, &map_k, k_bar,
                    hi, j * KN, bi);
    mbar_expect(v_bar, TILE_BYTES);
    tma_tile<D, KN>(v_ring + (j & 1) * TILE_BYTES, &map_v, v_bar, hi, j * KN,
                    bi);
  };
  init_barriers(bars, LONG_STAGES + STAGES);
  if (threadIdx.x == 0) {
    copy_tile(0, 2 * QM * D * 2);  // Q and dO ride on K_0's barrier
    tma_tile<D, QM>(q_s, &map_q, bars, hi, q0, bi);
    tma_tile<D, QM>(do_s, &map_do, bars, hi, q0, bi);
  }
  const float* lp = lse + (i64)blockIdx.y * s;
  const float* dp = delta + (i64)blockIdx.y * s;
  float lr[2], dr[2];  // L in base 2, and D, of this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_l + 8 * r;
    lr[r] = row < s ? lp[row] * LOG2E : 0.f;
    dr[r] = row < s ? dp[row] : 0.f;
  }

  float dq_acc[D / 2], sc[KN / 2], dpr[KN / 2];
  uint32_t ds[KN / 4];
  zero(dq_acc);

  // Tile j is in and every thread is past step j - 1; then the copies of
  // tile j + 1 start.
  auto advance = [&](int j) {
    mbar_wait(bars + 8 * (j % LONG_STAGES), (j / LONG_STAGES) & 1);
    mbar_wait(bars + 8 * (LONG_STAGES + (j & 1)), (j >> 1) & 1);
    __syncthreads();
    if (threadIdx.x == 0 && j < qt) copy_tile(j + 1, 0);
  };
  // sc = S = Q K_j^T and dpr = dP = dO V_j^T, in flight.
  auto scores = [&](int j) {
    dot_rows<D, KN, QM, KN>(sc, q_s, wg * 64 * 128,
                            k_ring + (j % LONG_STAGES) * TILE_BYTES);
    dot_rows<D, KN, QM, KN>(dpr, do_s, wg * 64 * 128,
                            v_ring + (j & 1) * TILE_BYTES);
    wgmma_commit();
  };
  // dQ += dS K_j, in flight.
  auto sums = [&](int j) {
    acc_times<D, KN, KN>(dq_acc, ds,
                         k_ring + (j % LONG_STAGES) * TILE_BYTES);
    wgmma_commit();
  };
  // dpr becomes dS.
  auto pointwise = [&](int j) {
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      const int r = (i >> 1) & 1;
      const int col = (i >> 2) * 8 + 2 * t + (i & 1);
      float p = fast_exp2(fmaf(sc[i], scale_log2, -lr[r]));
      if (j == qt && col > row_l + 8 * r) p = 0.f;  // QM == KN
      dpr[i] = p * (dpr[i] - dr[r]);
    }
  };

  // At d 64, where the exponentials weigh as much as the products, the two
  // warpgroups take turns at the tensor cores inside each step: the second
  // one starts step j's products in step j - 1 already, waits for them,
  // passes the barrier and does their exponentials in step j, under the
  // first one's products.  At d 128 that costs more than it hides (read
  // on the card), and both keep the same order.
  const int late = D == 64 ? wg : 0;
  advance(0);
  wgmma_fence();
  scores(0);
  wgmma_wait<0>();
  pin(sc);
  pin(dpr);
  if (late == 1 && qt > 0) advance(1);
  pointwise(0);
  pack_a<KN>(ds, dpr);
  for (int j = 1; j <= qt; ++j) {
    if (late == 0) advance(j);
    pin(ds);
    wgmma_fence();
    scores(j);
    sums(j - 1);
    wgmma_wait<1>();  // S and dP are there; dS K may still run
    if (late == 1) {
      wgmma_wait<0>();  // this step's readers of the rings are done
      if (j < qt) advance(j + 1);
    }
    pin(sc);
    pin(dpr);
    pointwise(j);
    wgmma_wait<0>();  // dS of step j - 1 is free again
    pin(dq_acc);
    pin(ds);
    pack_a<KN>(ds, dpr);
  }
  pin(ds);
  wgmma_fence();
  sums(qt);
  wgmma_wait<0>();
  pin(dq_acc);
  store_rows<D>(dq, dq_acc, base, row_stride, q0 + row_l, s, scale, scale,
                t, d);
}

// -- q . k wider than v: the (DQK, DV) = (192, 128) instance -----------------
// Latent attention (DeepSeek-V3's MLA) takes q . k over 192 columns and
// p . v over 128.  Its kernels are their own, beside the d-64 / 128 / 256
// ones: q, k, dQ and dK are DQK wide; v, O, dO and dV DV wide.
constexpr int WIDE_FWD_STAGES = 2;   // K and V stages of 128 keys (forward)
constexpr int WIDE_DQ_KN = 64;       // keys a stage in the dQ pass
constexpr int WIDE_DQ_K_STAGES = 4;  // its K ring: read for two steps,
constexpr int WIDE_DQ_V_STAGES = 3;  // its V ring: one; both copied 2 ahead
constexpr int WIDE_BQ = 64;          // queries a stage in the dK / dV pass,
constexpr int WIDE_DKDV_STAGES = 3;  // in a ring of three, copied 1 ahead

template <int DQK, int DV>
__host__ __device__ constexpr int wide_fwd_smem() {
  return 2048 + 2 * (BM * DQK + WIDE_FWD_STAGES * BN * (DQK + DV));
}

// Forward at (DQK, DV): grid (ceil(s / BM) query tiles, b * heads), as
// flash_fwd with 128-key stages in rings of two (K_{j+1} and V_j are
// copied in step j): Q (48 KB) and two K and two V stages (96 + 64 KB)
// fill shared memory; O is 64 x DV and S 64 x 128 f32 a warpgroup.
template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wide_qk(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      bf16* __restrict__ o, float* __restrict__ lse, int s,
                      int heads, float scale_log2) {
  extern __shared__ unsigned char smem[];
  constexpr int KN = BN;  // keys a stage, as many as the query tile's rows
  constexpr int RING = WIDE_FWD_STAGES;
  constexpr uint32_t K_BYTES = KN * DQK * 2, V_BYTES = KN * DV * 2;
  const uint32_t bars = align_1k(smem);  // K's stages, then V's
  const uint32_t q_s = bars + 1024;
  const uint32_t k_ring = q_s + BM * DQK * 2;
  const uint32_t v_ring = k_ring + RING * K_BYTES;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int wg = threadIdx.x / WG_THREADS;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * BM;
  const int row_l = wg * 64 + warp * 16 + g;  // in the tile; and row_l + 8
  // Tile j of K (or V) lives in stage j % 2, whose barrier it completes for
  // the (j / 2)-th time; key tile qt is the diagonal one, and the last.
  auto copy_k = [&](int j, uint32_t extra) {
    const uint32_t bar = bars + 8 * (j % RING);
    mbar_expect(bar, K_BYTES + extra);
    tma_tile<DQK, KN>(k_ring + (j % RING) * K_BYTES, &map_k, bar, hi,
                      j * KN, bi);
  };
  auto copy_v = [&](int j) {
    const uint32_t bar = bars + 8 * (RING + j % RING);
    mbar_expect(bar, V_BYTES);
    tma_tile<DV, KN>(v_ring + (j % RING) * V_BYTES, &map_v, bar, hi, j * KN,
                     bi);
  };
  auto wait_k = [&](int j) {
    mbar_wait(bars + 8 * (j % RING), (j / RING) & 1);
  };
  auto wait_v = [&](int j) {
    mbar_wait(bars + 8 * (RING + j % RING), (j / RING) & 1);
  };
  init_barriers(bars, 2 * RING);
  if (threadIdx.x == 0) {
    copy_k(0, BM * DQK * 2);  // Q rides on K_0's barrier
    tma_tile<DQK, BM>(q_s, &map_q, bars, hi, q0, bi);
  }

  float acc[DV / 2], sc[KN / 2];
  uint32_t p[KN / 4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY};  // running row max of the raw scores
  float l[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};  // what the last softmax owes the old O

  // K_j and V_{j-1} are in, and every thread is past step j - 1; then
  // K_{j+1} and V_j start.
  auto arrive = [&](int j) {
    wait_k(j);
    if (j > 0) wait_v(j - 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      if (j < qt) copy_k(j + 1, 0);
      copy_v(j);
    }
  };
  auto scores = [&](int j) {
    dot_rows<DQK, KN, BM, KN>(sc, q_s, wg * 64 * 128,
                              k_ring + (j % RING) * K_BYTES);
    wgmma_commit();
  };
  auto times_v = [&](int j) {
    if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    pin(p);
    wgmma_fence();
    acc_times<DV, KN, KN>(acc, p, v_ring + (j % RING) * V_BYTES);
    wgmma_commit();
  };
  // As flash_fwd's softmax.
  auto softmax = [&](int j) {
    if (j == qt) {  // the diagonal tile: compare in the tile
#pragma unroll
      for (int i = 0; i < KN / 2; ++i) {
        const int col = (i >> 2) * 8 + 2 * t + (i & 1);
        if (col > row_l + ((i >> 1) & 1) * 8) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      alpha[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -ms[r]));
      l[r] += sc[i];
    }
    wgmma_wait<0>();
    pin(acc);
    pin(p);
    pack_a<KN>(p, sc);
  };

  // The warpgroups take turns at the tensor cores, as in flash_fwd.
  arrive(0);
  wgmma_fence();
  scores(0);
  wgmma_wait<0>();
  pin(sc);
  if (wg == 0) {
    softmax(0);
    for (int j = 1; j <= qt; ++j) {
      arrive(j);
      wgmma_fence();
      scores(j);
      times_v(j - 1);
      wgmma_wait<1>();  // S_j is there; P V may still run
      pin(sc);
      softmax(j);
    }
  } else {
    for (int j = 1; j <= qt; ++j) {
      arrive(j);
      softmax(j - 1);
      times_v(j - 1);
      scores(j);
      wgmma_wait<0>();
      pin(acc);
      pin(p);
      pin(sc);
    }
    softmax(qt);
  }
  wait_v(qt);
  times_v(qt);
  wgmma_wait<0>();
  pin(acc);
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    inv[r] = 1.f / l[r];
    const int row = q0 + row_l + 8 * r;
    if (t == 0 && row < s) {
      lse[(i64)blockIdx.y * s + row] =
          (m[r] * scale_log2 + log2f(l[r])) * LN2;
    }
  }
  store_rows<DV>(o, acc, (i64)bi * s * heads * DV + (i64)hi * DV,
                 (i64)heads * DV, q0 + row_l, s, inv[0], inv[1], t, DV);
}

template <int DQK, int DV>
__host__ __device__ constexpr int wide_dq_smem() {
  return 2048 + 2 * (BM * (DQK + DV) +
                     WIDE_DQ_KN * (WIDE_DQ_K_STAGES * DQK +
                                   WIDE_DQ_V_STAGES * DV));
}

// dQ at (DQK, DV): grid (ceil(s / BM) query tiles, b * heads), two
// warpgroups of 64 query rows, 64-key stages (dQ is 64 x DQK f32, 96
// registers a thread, beside S and dP at 64 keys, 32 each).  Step j
// starts S_j = Q K_j^T and dP_j = dO V_j^T and then dQ += dS_{j-1}
// K_{j-1}, waits for the first two only, and does its exponentials while
// the third runs; the tiles of step j + 2 are copied in step j.  Key
// tiles 2 qt and 2 qt + 1 cross the block's diagonal (the second lies
// wholly above warpgroup 0's rows, which mask it).
template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_wide_qk(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int s, int heads,
                         float scale) {
  extern __shared__ unsigned char smem[];
  constexpr int QM = BM, KN = WIDE_DQ_KN;
  constexpr int KR = WIDE_DQ_K_STAGES, VR = WIDE_DQ_V_STAGES;
  constexpr uint32_t K_BYTES = KN * DQK * 2, V_BYTES = KN * DV * 2;
  const uint32_t bars = align_1k(smem);  // K's stages, then V's
  const uint32_t q_s = bars + 1024;
  const uint32_t do_s = q_s + QM * DQK * 2;
  const uint32_t k_ring = do_s + QM * DV * 2;
  const uint32_t v_ring = k_ring + KR * K_BYTES;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int wg = threadIdx.x / WG_THREADS;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * QM;
  const int row_l = wg * 64 + warp * 16 + g;
  const i64 row_stride = (i64)heads * DQK;
  const i64 base = (i64)bi * s * row_stride + (i64)hi * DQK;
  const float scale_log2 = scale * LOG2E;
  const int last = min(q0 + QM, s) / KN - 1;  // the block's last key tile
  // Tile j of K lives in stage j % 4 and of V in stage j % 3; each
  // completes its stage's barrier for the (j / 4)-th or (j / 3)-th time.
  // One thread.
  auto copy_tile = [&](int j, uint32_t extra) {
    const uint32_t k_bar = bars + 8 * (j % KR);
    const uint32_t v_bar = bars + 8 * (KR + j % VR);
    mbar_expect(k_bar, K_BYTES + extra);
    tma_tile<DQK, KN>(k_ring + (j % KR) * K_BYTES, &map_k, k_bar, hi, j * KN,
                      bi);
    mbar_expect(v_bar, V_BYTES);
    tma_tile<DV, KN>(v_ring + (j % VR) * V_BYTES, &map_v, v_bar, hi, j * KN,
                     bi);
  };
  init_barriers(bars, KR + VR);
  if (threadIdx.x == 0) {
    copy_tile(0, QM * (DQK + DV) * 2);  // Q and dO ride on K_0's barrier
    tma_tile<DQK, QM>(q_s, &map_q, bars, hi, q0, bi);
    tma_tile<DV, QM>(do_s, &map_do, bars, hi, q0, bi);
    if (last > 0) copy_tile(1, 0);
  }
  const float* lp = lse + (i64)blockIdx.y * s;
  const float* dp = delta + (i64)blockIdx.y * s;
  float lr[2], dr[2];  // L in base 2, and D, of this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_l + 8 * r;
    lr[r] = row < s ? lp[row] * LOG2E : 0.f;
    dr[r] = row < s ? dp[row] : 0.f;
  }

  float dq_acc[DQK / 2], sc[KN / 2], dpr[KN / 2];
  uint32_t ds[KN / 4];
  zero(dq_acc);

  // Tile j is in and every thread is past step j - 1; then the copies of
  // tile j + 2 start.
  auto advance = [&](int j) {
    mbar_wait(bars + 8 * (j % KR), (j / KR) & 1);
    mbar_wait(bars + 8 * (KR + j % VR), (j / VR) & 1);
    __syncthreads();
    if (threadIdx.x == 0 && j + 2 <= last) copy_tile(j + 2, 0);
  };
  // sc = S = Q K_j^T and dpr = dP = dO V_j^T, in flight.
  auto scores = [&](int j) {
    dot_rows<DQK, KN, QM, KN>(sc, q_s, wg * 64 * 128,
                              k_ring + (j % KR) * K_BYTES);
    dot_rows<DV, KN, QM, KN>(dpr, do_s, wg * 64 * 128,
                             v_ring + (j % VR) * V_BYTES);
    wgmma_commit();
  };
  // dQ += dS K_j, in flight.
  auto sums = [&](int j) {
    acc_times<DQK, KN, KN>(dq_acc, ds, k_ring + (j % KR) * K_BYTES);
    wgmma_commit();
  };
  // dpr becomes dS.
  auto pointwise = [&](int j) {
    const int kb = j * KN - q0;  // the tile's first key, from row q0
    const bool diagonal = kb + KN > 0;
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      const int r = (i >> 1) & 1;
      const int col = kb + (i >> 2) * 8 + 2 * t + (i & 1);
      float p = fast_exp2(fmaf(sc[i], scale_log2, -lr[r]));
      if (diagonal && col > row_l + 8 * r) p = 0.f;
      dpr[i] = p * (dpr[i] - dr[r]);
    }
  };

  advance(0);
  wgmma_fence();
  scores(0);
  wgmma_wait<0>();
  pin(sc);
  pin(dpr);
  pointwise(0);
  pack_a<KN>(ds, dpr);
  for (int j = 1; j <= last; ++j) {
    advance(j);
    pin(ds);
    wgmma_fence();
    scores(j);
    sums(j - 1);
    wgmma_wait<1>();  // S and dP are there; dS K may still run
    pin(sc);
    pin(dpr);
    pointwise(j);
    wgmma_wait<0>();  // dS of step j - 1 is free again
    pin(dq_acc);
    pin(ds);
    pack_a<KN>(ds, dpr);
  }
  pin(ds);
  wgmma_fence();
  sums(last);
  wgmma_wait<0>();
  pin(dq_acc);
  store_rows<DQK>(dq, dq_acc, base, row_stride, q0 + row_l, s, scale, scale,
                  t, DQK);
}

template <int DQK, int DV>
__host__ __device__ constexpr int wide_dkdv_stage() {
  // Q, dO, then L and D (WIDE_BQ floats each) in the next 1024 bytes.
  return WIDE_BQ * (DQK + DV) * 2 + 1024;
}

template <int DQK, int DV>
__host__ __device__ constexpr int wide_dkdv_smem() {
  return 2048 + BM * (DQK + DV) * 2 +
         WIDE_DKDV_STAGES * wide_dkdv_stage<DQK, DV>();
}

static_assert(wide_fwd_smem<192, 128>() <= 232448 &&
                  wide_dq_smem<192, 128>() <= 232448 &&
                  wide_dkdv_smem<192, 128>() <= 232448,
              "the (192, 128) kernels fit a block's shared memory");

// dK and dV at (DQK, DV): grid (ceil(s / BM) key tiles, b * heads).
// Warpgroup w owns keys [k0 + 64 w, k0 + 64 w + 64) and holds dK (64 x DQK)
// and dV (64 x DV) in f32, 160 registers a thread, and walks the queries
// from k0 + 64 w to the end in steps of 64.  That leaves registers for one
// step's S^T and dP^T (64 x 64, 32 each) but not for a second step's in
// flight, so a warpgroup's step is serial: S^T = K Q^T and dP^T = V dO^T,
// wait, the exponentials, then dV += P^T dO and dK += dS^T Q, wait; the
// two warpgroups run half a step apart instead.  A stage is read for two
// steps (warpgroup 1 sums the one before) and copied one step ahead.
template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_wide_qk(const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int s, int heads, float scale) {
  extern __shared__ unsigned char smem[];
  constexpr int BQW = WIDE_BQ, RING = WIDE_DKDV_STAGES;
  constexpr uint32_t STAGE = wide_dkdv_stage<DQK, DV>();
  constexpr uint32_t Q_BYTES = BQW * DQK * 2, DO_BYTES = BQW * DV * 2;
  const uint32_t bars = align_1k(smem);  // one a stage of the ring
  const uint32_t k_s = bars + 1024;
  const uint32_t v_s = k_s + BM * DQK * 2;
  const uint32_t ring = v_s + BM * DV * 2;
  unsigned char* ring_p = smem + (ring - smem_u32(smem));
  const int kt = blockIdx.x;  // the first key tiles see the most queries
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int wg = threadIdx.x / WG_THREADS;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * BM;
  const int key = k0 + wg * 64 + warp * 16 + g;  // and key + 8
  const float* lp = lse + (i64)blockIdx.y * s;
  const float* dp = delta + (i64)blockIdx.y * s;
  const float scale_log2 = scale * LOG2E;
  const int steps = (s - k0) / BQW;

  // Step `it` (queries from k0 + it BQW, all below s) lives in stage
  // it % RING, whose barrier it completes for the (it / RING)-th time: Q,
  // dO, L and D.  One thread.
  auto copy_step = [&](int it, uint32_t extra) {
    const int i0 = k0 + it * BQW;
    const uint32_t at = ring + (it % RING) * STAGE;
    const uint32_t bar = bars + 8 * (it % RING);
    mbar_expect(bar, Q_BYTES + DO_BYTES + 2 * BQW * 4 + extra);
    tma_tile<DQK, BQW>(at, &map_q, bar, hi, i0, bi);
    tma_tile<DV, BQW>(at + Q_BYTES, &map_do, bar, hi, i0, bi);
    bulk_load(at + Q_BYTES + DO_BYTES, lp + i0, BQW * 4, bar);
    bulk_load(at + Q_BYTES + DO_BYTES + BQW * 4, dp + i0, BQW * 4, bar);
  };
  init_barriers(bars, RING);
  if (threadIdx.x == 0) {
    copy_step(0, BM * (DQK + DV) * 2);  // K and V ride on step 0's barrier
    tma_tile<DQK, BM>(k_s, &map_k, bars, hi, k0, bi);
    tma_tile<DV, BM>(v_s, &map_v, bars, hi, k0, bi);
  }

  float dk_acc[DQK / 2], dv_acc[DV / 2], st[BQW / 2], dpt[BQW / 2];
  uint32_t pp[BQW / 4], ds[BQW / 4];
  zero(dk_acc);
  zero(dv_acc);

  // Step it is in and every thread is past step it - 1 (warpgroup 1 past
  // its sums of step it - 2); then the copies of step it + 1 start, into
  // the stage of step it - 2.
  auto advance = [&](int it) {
    mbar_wait(bars + 8 * (it % RING), (it / RING) & 1);
    __syncthreads();
    if (threadIdx.x == 0 && it + 1 < steps) copy_step(it + 1, 0);
  };
  // st becomes P^T and dpt dS^T, from step it's L and D.
  auto pointwise = [&](int it) {
    const int i0 = k0 + it * BQW;
    const float* l_s = reinterpret_cast<const float*>(
        ring_p + (it % RING) * STAGE + Q_BYTES + DO_BYTES);
    const float* d_s = l_s + BQW;
    const bool diagonal = i0 < k0 + BM;
#pragma unroll
    for (int n = 0; n < BQW / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(l_s + n * 8 + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(d_s + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = i0 + n * 8 + 2 * t + (e & 1);
        const float lq = (e & 1) ? l2.y : l2.x;
        const float dq = (e & 1) ? d2.y : d2.x;
        float p = fast_exp2(fmaf(st[4 * n + e], scale_log2, -lq * LOG2E));
        if (diagonal && qi < key + (e >> 1) * 8) p = 0.f;
        st[4 * n + e] = p;
        dpt[4 * n + e] = p * (dpt[4 * n + e] - dq);
      }
    }
  };

  // The queries before a warpgroup's first key are skipped: warpgroup 1
  // only waits out step 0.
  // S^T and dP^T of step it, then P^T and dS^T as A operands.
  auto scores = [&](int it) {
    const uint32_t q_s = ring + (it % RING) * STAGE;
    wgmma_fence();
    dot_rows<DQK, BQW, BM, BQW>(st, k_s, wg * 64 * 128, q_s);
    dot_rows<DV, BQW, BM, BQW>(dpt, v_s, wg * 64 * 128, q_s + Q_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    pin(st);
    pin(dpt);
    pointwise(it);
    pack_a<BQW>(pp, st);
    pack_a<BQW>(ds, dpt);
  };
  // dV += P^T dO and dK += dS^T Q of step it.
  auto sums = [&](int it) {
    const uint32_t q_s = ring + (it % RING) * STAGE;
    pin(pp);
    pin(ds);
    wgmma_fence();
    acc_times<DV, BQW, BQW>(dv_acc, pp, q_s + Q_BYTES);
    acc_times<DQK, BQW, BQW>(dk_acc, ds, q_s);
    wgmma_commit();
    wgmma_wait<0>();
    pin(dv_acc);
    pin(dk_acc);
  };

  // The warpgroups take turns at the tensor cores: warpgroup 0 does step
  // it's scores and sums, warpgroup 1 the sums of step it - 1 and then the
  // scores of step it, so each one's exponentials run under the other's
  // products.  Each branches once (a wgmma under a per-warpgroup branch
  // inside the loop makes ptxas serialize).  Warpgroup 1's keys start
  // after step 0's queries: it only waits that step out.
  if (wg == 0) {
    for (int it = 0; it < steps; ++it) {
      advance(it);
      scores(it);
      sums(it);
    }
  } else {
    advance(0);
    if (steps > 1) {
      advance(1);
      scores(1);
      for (int it = 2; it < steps; ++it) {
        advance(it);
        sums(it - 1);
        scores(it);
      }
      sums(steps - 1);
    }
  }
  store_rows<DQK>(dk, dk_acc, (i64)bi * s * heads * DQK + (i64)hi * DQK,
                  (i64)heads * DQK, key, s, scale, scale, t, DQK);
  store_rows<DV>(dv, dv_acc, (i64)bi * s * heads * DV + (i64)hi * DV,
                 (i64)heads * DV, key, s, 1.f, 1.f, t, DV);
}

struct Shape {
  int b, s, heads, d;
};

// A bf16 (b, s, heads, d) tensor at element strides (sb, ss, sh), head dim
// contiguous, and the tile its kernels copy from it.
struct View {
  const void* data;
  i64 sb, ss, sh;
};

// The map of `rows` x 64-column boxes (one swizzle atom) of a view, as
// (d, heads, seq, batch); 0, or a code that is not a cudaError_t's.
int tile_map(CUtensorMap* map, const View& t, const Shape& n, int rows) {
  return map_4d(map, t.data,
                {(unsigned long long)n.d, (unsigned long long)n.heads,
                 (unsigned long long)n.s, (unsigned long long)n.b},
                {(unsigned long long)t.sh * 2, (unsigned long long)t.ss * 2,
                 (unsigned long long)t.sb * 2},  // bytes
                {64u, 1u, (unsigned)rows, 1u});
}

View contiguous(const void* data, const Shape& n) {
  return View{data, (i64)n.s * n.heads * n.d, (i64)n.heads * n.d, (i64)n.d};
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_fwd(const View& q, const View& k, const View& v, void* out,
               void* lse, const Shape& n, cudaStream_t st) {
  constexpr int KN = Tiles<D>::FWD_BN;
  CUtensorMap map_q, map_k, map_v;
  int err = tile_map(&map_q, q, n, BM);
  if (!err) err = tile_map(&map_k, k, n, KN);
  if (!err) err = tile_map(&map_v, v, n, KN);
  if (!err) err = allow_smem(flash_fwd<D>, fwd_smem<D>());
  if (err) return err;
  flash_fwd<D><<<dim3((n.s + BM - 1) / BM, n.b * n.heads), THREADS,
                 fwd_smem<D>(), st>>>(map_q, map_k, map_v, (bf16*)out,
                                      (float*)lse, n.s, n.heads, n.d,
                                      LOG2E / sqrtf((float)n.d));
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const View& q, const View& k, const View& v, const void* out,
               const void* lse, const void* dout, void* delta, void* dq,
               void* dk, void* dv, const Shape& n, cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)n.d);
  const int rows = n.b * n.s * n.heads;
  const View d_out = contiguous(dout, n);
  // The rows of the resident tiles and of the dQ pass's key stages: Q and
  // dO there, K and V in the dK / dV pass (BM, or BQ in the split pass).
  constexpr int QM = Tiles<D>::DQ_BM;
  static_assert(QM == (D == 256 ? BQ : BM),
                "one map serves each of Q, dO, K and V at these rows");
  CUtensorMap q_qm, do_qm, q_bq, do_bq, k_qm, v_qm;
  int err = tile_map(&q_qm, q, n, QM);
  if (!err) err = tile_map(&do_qm, d_out, n, QM);
  if (!err) err = tile_map(&q_bq, q, n, BQ);
  if (!err) err = tile_map(&do_bq, d_out, n, BQ);
  if (!err) err = tile_map(&k_qm, k, n, QM);
  if (!err) err = tile_map(&v_qm, v, n, QM);
  if constexpr (D == 256) {
    if (!err) err = allow_smem(flash_bwd_dkdv_split<D>, split_smem<D>());
  } else {
    if (!err) err = allow_smem(flash_bwd_dkdv<D>, dkdv_smem<D>());
  }
  if (!err) err = allow_smem(flash_bwd_dq<D>, dq_smem<D>());
  if (err) return err;
  flash_bwd_delta<D><<<(rows * (D / 8) + THREADS - 1) / THREADS, THREADS, 0,
                       st>>>((const bf16*)out, (const bf16*)dout,
                             (float*)delta, n.s, n.heads, rows, n.d);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 kv_grid((n.s + QM - 1) / QM, n.b * n.heads);
  if constexpr (D == 256) {
    flash_bwd_dkdv_split<D><<<kv_grid, THREADS, split_smem<D>(), st>>>(
        k_qm, v_qm, q_bq, do_bq, (const float*)lse, (const float*)delta,
        (bf16*)dk, (bf16*)dv, n.s, n.heads, n.d, scale);
  } else {
    flash_bwd_dkdv<D><<<kv_grid, THREADS, dkdv_smem<D>(), st>>>(
        k_qm, v_qm, q_bq, do_bq, (const float*)lse, (const float*)delta,
        (bf16*)dk, (bf16*)dv, n.s, n.heads, n.d, scale);
  }
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dq<D><<<dim3((n.s + QM - 1) / QM, n.b * n.heads),
                    Tiles<D>::DQ_WGS * WG_THREADS, dq_smem<D>(), st>>>(
      q_qm, do_qm, k_qm, v_qm, (const float*)lse, (const float*)delta,
      (bf16*)dq, n.s, n.heads, n.d, scale);
  return (int)cudaGetLastError();
}

// The (DQK, DV) instance's forward; n.d is DQK.
template <int DQK, int DV>
int launch_fwd_wide(const View& q, const View& k, const View& v, void* out,
                    void* lse, const Shape& n, cudaStream_t st) {
  const Shape nv{n.b, n.s, n.heads, DV};
  CUtensorMap map_q, map_k, map_v;
  int err = tile_map(&map_q, q, n, BM);
  if (!err) err = tile_map(&map_k, k, n, BN);
  if (!err) err = tile_map(&map_v, v, nv, BN);
  if (!err) {
    err = allow_smem(flash_fwd_wide_qk<DQK, DV>, wide_fwd_smem<DQK, DV>());
  }
  if (err) return err;
  flash_fwd_wide_qk<DQK, DV><<<dim3((n.s + BM - 1) / BM, n.b * n.heads),
                               THREADS, wide_fwd_smem<DQK, DV>(), st>>>(
      map_q, map_k, map_v, (bf16*)out, (float*)lse, n.s, n.heads,
      LOG2E / sqrtf((float)DQK));
  return (int)cudaGetLastError();
}

// The (DQK, DV) instance's backward: D over DV columns (flash_bwd_delta),
// then the dK / dV pass and the dQ pass; n.d is DQK.
template <int DQK, int DV>
int launch_bwd_wide(const View& q, const View& k, const View& v,
                    const void* out, const void* lse, const void* dout,
                    void* delta, void* dq, void* dk, void* dv, const Shape& n,
                    cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)DQK);
  const Shape nv{n.b, n.s, n.heads, DV};
  const int rows = n.b * n.s * n.heads;
  const View d_out = contiguous(dout, nv);
  // Resident tiles (BM rows: Q and dO in the dQ pass, K and V in the
  // dK / dV pass) and the streamed ones (K and V stages of the dQ pass, Q
  // and dO stages of the dK / dV pass).
  CUtensorMap q_bm, do_bm, k_bm, v_bm, k_kn, v_kn, q_bq, do_bq;
  int err = tile_map(&q_bm, q, n, BM);
  if (!err) err = tile_map(&do_bm, d_out, nv, BM);
  if (!err) err = tile_map(&k_bm, k, n, BM);
  if (!err) err = tile_map(&v_bm, v, nv, BM);
  if (!err) err = tile_map(&k_kn, k, n, WIDE_DQ_KN);
  if (!err) err = tile_map(&v_kn, v, nv, WIDE_DQ_KN);
  if (!err) err = tile_map(&q_bq, q, n, WIDE_BQ);
  if (!err) err = tile_map(&do_bq, d_out, nv, WIDE_BQ);
  if (!err) {
    err = allow_smem(flash_bwd_dkdv_wide_qk<DQK, DV>,
                     wide_dkdv_smem<DQK, DV>());
  }
  if (!err) {
    err = allow_smem(flash_bwd_dq_wide_qk<DQK, DV>, wide_dq_smem<DQK, DV>());
  }
  if (err) return err;
  flash_bwd_delta<DV><<<(rows * (DV / 8) + THREADS - 1) / THREADS, THREADS,
                        0, st>>>((const bf16*)out, (const bf16*)dout,
                                 (float*)delta, n.s, n.heads, rows, DV);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((n.s + BM - 1) / BM, n.b * n.heads);
  flash_bwd_dkdv_wide_qk<DQK, DV><<<grid, THREADS, wide_dkdv_smem<DQK, DV>(),
                                    st>>>(
      k_bm, v_bm, q_bq, do_bq, (const float*)lse, (const float*)delta,
      (bf16*)dk, (bf16*)dv, n.s, n.heads, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dq_wide_qk<DQK, DV><<<grid, THREADS, wide_dq_smem<DQK, DV>(),
                                  st>>>(
      q_bm, do_bm, k_kn, v_kn, (const float*)lse, (const float*)delta,
      (bf16*)dq, n.s, n.heads, scale);
  return (int)cudaGetLastError();
}

// The instance a head dim runs: the smallest of 64, 128 and 256 at or
// above it (its columns past d zero-filled on load and not stored); 0 for
// a head dim the kernels do not take (not a multiple of 8, or above 256).
int instance(int d) {
  if (d < 8 || d > 256 || d % 8) return 0;
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

}  // namespace

// q, k (b, s, heads, d) and v (b, s, heads, dv) bf16 at the given element
// strides (head dim contiguous, every stride a multiple of 8, pointers
// 16-byte aligned); dv == d a multiple of 8 up to 256, or (d, dv) = (192,
// 128) (any other pair returns cudaErrorInvalidValue); s a multiple of
// 64.  out (b, s, heads, dv) bf16 and lse (b, heads, s) f32, both
// contiguous.  Returns 0, a cudaError_t, or 100000 + the CUresult of a
// tensor map that could not be encoded.
extern "C" int cea_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, long long qb,
                             long long qs, long long qh, long long kb,
                             long long ks, long long kh, long long vb,
                             long long vs, long long vh, int b, int s,
                             int heads, int d, int dv, void* stream) {
  const Shape n{b, s, heads, d};
  const View qv{q, qb, qs, qh}, kv{k, kb, ks, kh}, vv{v, vb, vs, vh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dv != d) {
    if (d == 192 && dv == 128) {
      return launch_fwd_wide<192, 128>(qv, kv, vv, out, lse, n, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (instance(d)) {
    case 64: return launch_fwd<64>(qv, kv, vv, out, lse, n, st);
    case 128: return launch_fwd<128>(qv, kv, vv, out, lse, n, st);
    case 256: return launch_fwd<256>(qv, kv, vv, out, lse, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The same q, k, v; out and lse from cea_flash_fwd; dout (b, s, heads, dv)
// bf16 contiguous; delta (b, heads, s) f32 scratch; dq, dk (b, s, heads,
// d) and dv_out (b, s, heads, dv) bf16 contiguous.
extern "C" int cea_flash_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* lse,
                             const void* dout, void* delta, void* dq,
                             void* dk, void* dv_out, long long qb,
                             long long qs, long long qh, long long kb,
                             long long ks, long long kh, long long vb,
                             long long vs, long long vh, int b, int s,
                             int heads, int d, int dv, void* stream) {
  const Shape n{b, s, heads, d};
  const View qv{q, qb, qs, qh}, kv{k, kb, ks, kh}, vv{v, vb, vs, vh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dv != d) {
    if (d == 192 && dv == 128) {
      return launch_bwd_wide<192, 128>(qv, kv, vv, out, lse, dout, delta, dq,
                                       dk, dv_out, n, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (instance(d)) {
    case 64:
      return launch_bwd<64>(qv, kv, vv, out, lse, dout, delta, dq, dk,
                            dv_out, n, st);
    case 128:
      return launch_bwd<128>(qv, kv, vv, out, lse, dout, delta, dq, dk,
                             dv_out, n, st);
    case 256:
      return launch_bwd<256>(qv, kv, vv, out, lse, dout, delta, dq, dk,
                             dv_out, n, st);
  }
  return (int)cudaErrorInvalidValue;
}
