// The GEMM core shared by csrc/fused_linear.cu (1x1 conv as a matmul) and
// csrc/fused_conv3x3.cu (3x3 conv as an implicit GEMM), for Hopper (sm_90a).
//
// What it computes: y = A' @ B with f32 accumulation, y stored as bf16,
// and optionally the column sum and sum of squares of the f32 accumulator
// (before the cast), where A' is A with an optional per-channel prologue
// relu(a * scale + shift) applied in f32 and rounded to bf16 before the
// product.  A is read from an NHWC tensor x (batch, H, W, C): for the 3x3
// conv, row p = (n, h, w) and column k = tap * C + c read x[n, h + dy,
// w + dx, c] with tap = (dy + 1) * 3 + (dx + 1), zero outside the image
// (after the prologue); a matmul is the same with one tap and x = A as (1,
// 1, M, K).  B is (taps, C, N): for the conv the tap-ordered weights.
//
// Design (the pieces are in hopper_mma.cuh and tma_host.cuh):
//   - Persistent blocks: grid = min(tiles, SMs), block b walks tiles b, b +
//     grid, ...; a tile is BM = 128 output pixels x BN (64 or 128)
//     columns, the column tile fastest, so the blocks that share one A
//     panel run together and its re-reads hit the L2.  The pixels of a
//     tile are a box of wb x r x bi (w, h, images): 128 rows of a matmul;
//     for the conv the box that leaves the fewest rows of its tiles empty
//     (ops/fused_conv3x3.py `tile_box`: 8 x 8 x 2 at 56 x 56, 7 x 6 x 3
//     at 28, 14 x 3 x 3 at 14, 7 x 7 x 2 at 7).
//   - Two consumer warpgroups, a producer warp and three prologue warps,
//     384 threads (up to 168 registers a thread, room for a 64 x 128 f32
//     accumulator and two A fragments without setmaxnreg).  One thread of
//     the producer warp
//     keeps two rings of shared-memory tiles full by TMA, with a "full"
//     and an "empty" mbarrier a stage: A tiles, one per 64 channels (a
//     matmul's 128 x 64 tile of A; the conv's box with a one-pixel halo,
//     whose out-of-image coordinates TMA fills with zeros), and B tiles,
//     one per 64 channels and tap (64 x BN).  The rings run on across
//     tiles, so the next tile's loads are in flight under this tile's
//     epilogue.
//   - The prologue (f32, rounded to bf16 by cvt.rn.relu): for the conv it
//     runs once per A tile, in place, as the tile lands, by three
//     prologue warps, which then arrive on the stage's "ready" mbarrier;
//     a pixel outside the image or past the batch is set to 0 there, so a
//     halo pixel is 0 after the prologue, not relu(shift).  For a matmul
//     the consumers apply it to their A registers (RS) as they read the
//     tile, rows past M set to 0, while the other half-step's products
//     run.
//   - Two consumer warpgroups own 64 rows each and run wgmma (m64nBNk16, B through
//     the transpose flag from its row-major tile).  A matmul reads A from
//     shared memory (SS).  The conv's nine taps read the same A tile:
//     each tap gathers its rows through ldmatrix with a row address per
//     lane (the swizzle applied by hand) and issues wgmma RS; rows that
//     are no output pixel are set to 0 in registers.  A tap is two
//     halves: the first half's product runs while the second's operand is
//     gathered, and the previous step's stages are released once its
//     products are done.
//   - Epilogue: y is rounded to bf16 into a swizzled staging tile
//     (stmatrix) and written by one TMA store, which clips rows and
//     columns past the output and runs under the next tile's products.
//     The f32 accumulator's column sums and sums of squares: a
//     reduce-scatter over each warp's rows by shuffles, then the 8 warps
//     in a fixed order into a per-block row of N partials in shared
//     memory; one row per block, summed over the blocks in a fixed order
//     by reduce_partials.  No atomics: results are bitwise repeatable on a
//     given card.
//
// Constraints (checked by the Python wrappers, which also plan the tiles):
// C and N multiples of 8; every pointer 16-byte aligned; bf16 operands,
// f32 scale / shift.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "tma_host.cuh"

namespace fused_gemm {

using namespace cea;

constexpr int BM = 128;  // output pixels a tile: 64 a consumer warpgroup
constexpr int BK = 64;   // channels a k-step: one 128-byte swizzle atom
constexpr int CONSUMERS = 2 * WG_THREADS;  // two consumer warpgroups,
constexpr int PRODUCER = CONSUMERS;        // the producer warp, and
constexpr int PROLOGUE = PRODUCER + 32;    // three prologue warps
constexpr int PROLOGUE_THREADS = 96;
constexpr int THREADS = PROLOGUE + PROLOGUE_THREADS;
constexpr int B_ATOM = BK * 128;   // 64 k-rows x 64 columns of B
constexpr int MAX_STAGES = 4;
constexpr int CONSUMER_BAR = 1;  // named barrier of the consumer threads

// The problem and its tiling.  x is (C, W, H, NB) innermost first (a
// matmul's A is (K, M, 1, 1)); B (N, C, taps); y (N, W, H, NB).
struct Geo {
  int C, W, H, NB, N, taps;
  int wb, r, bi;        // a tile's pixels: wb x r x bi <= BM
  int a_stages, b_stages;  // ring depths (the wrapper's plan)
  int tw, th, tn, ntn;  // tiles along w, h, images and columns
  int cchunks, tiles;   // ceil(C / BK); tw * th * tn * ntn
  int a_rows;           // rows of an A tile: the box with its halo
};

// Shared memory of one block, after the 1024-byte boundary: mbarriers
// (1 KB), the A ring, the B ring, the staging tile of y, the statistics'
// per-warp sums (two buffers) and per-block partials, then scale and
// shift.  ops/fused_linear.py `smem_bytes` mirrors it.
struct Smem {
  int a_stage, a_ring, b_ring, staging, red, part, scale, shift, bytes;
  __host__ __device__ Smem(const Geo& g, int bn, bool stats, bool affine) {
    a_stage = (g.a_rows * 128 + 1023) / 1024 * 1024;
    a_ring = 1024;
    b_ring = a_ring + g.a_stages * a_stage;
    staging = b_ring + g.b_stages * (bn / 64 * B_ATOM);
    red = staging + BM * bn * 2;
    part = red + (stats ? 2 * 8 * 2 * bn * 4 : 0);
    scale = part + (stats ? 8 * g.N : 0);
    shift = scale + (affine ? 4 * g.cchunks * BK : 0);
    bytes = shift + (affine ? 4 * g.cchunks * BK : 0) + 1024;  // + align
  }
};

__device__ __forceinline__ uint32_t align_1k(const void* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
}

struct Tile {
  int n0, w0, h0, b0;
};

template <int BN>
__device__ __forceinline__ Tile tile_at(const Geo& g, int t) {
  Tile x;
  x.n0 = (t % g.ntn) * BN;
  t /= g.ntn;
  x.w0 = (t % g.tw) * g.wb;
  t /= g.tw;
  x.h0 = (t % g.th) * g.r;
  x.b0 = (t / g.th) * g.bi;
  return x;
}

// A's 8 registers of k-steps kk0 and kk0 + 1 of this warp's 16 rows: lane
// l gives the address of row (l & 7) + 8 ((l >> 3) & 1) of the warp's
// rows, here row q of the swizzled A tile, 16-byte chunk 2 kk + (l >> 4).
__device__ __forceinline__ void load_a(uint32_t (&a)[8], uint32_t tile,
                                       int q, int hi, int kk0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = 2 * (kk0 + i) + hi;
    uint32_t r[4];
    ldsm_x4(r, tile + q * 128 + ((chunk ^ (q & 7)) << 4));
#pragma unroll
    for (int j = 0; j < 4; ++j) a[4 * i + j] = r[j];
  }
}

// bf16(relu(x * sc + sh)) of the 8 bf16 in v, in f32, in place.
__device__ __forceinline__ void affine_relu(uint4& v, const float* sc,
                                            const float* sh) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float lo = fmaf(__uint_as_float(w[e] << 16), sc[2 * e], sh[2 * e]);
    const float hi = fmaf(__uint_as_float(w[e] & 0xffff0000u), sc[2 * e + 1],
                          sh[2 * e + 1]);
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(w[e]) : "f"(hi),
        "f"(lo));
  }
}

// The prologue on the conv's A tile of channel chunk cc, in place, once:
// rows `item / 2` for item = first, first + step, ... < 2 * rows (step
// even, so a thread always takes the same half of a row: four 16-byte
// chunks, 32 channels, whose scale and shift it keeps in registers).  Row
// q is pixel (w, h, image) of the tile's box, which starts `hb` before
// the tile (its halo); a pixel outside the image or past the batch
// becomes 0, so the halo is 0 after the prologue.
__device__ __forceinline__ void transform(unsigned char* tile, const Geo& g,
                                          const Tile& x, int hb, int cc,
                                          int first, int step, int rows,
                                          const float* s_scale,
                                          const float* s_shift) {
  const int half = first & 1;
  float sc[32], sh[32];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ch = cc * BK + half * 32 + 4 * i;
    *reinterpret_cast<float4*>(sc + 4 * i) =
        *reinterpret_cast<const float4*>(s_scale + ch);
    *reinterpret_cast<float4*>(sh + 4 * i) =
        *reinterpret_cast<const float4*>(s_shift + ch);
  }
  const int qw = g.wb + 2 * hb, qh = g.r + 2 * hb;
  for (int item = first; item < 2 * rows; item += step) {
    const int q = item >> 1;
    const int b = q / (qw * qh);
    const int rem = q - b * (qw * qh);
    const int rr = rem / qw;
    const int h = x.h0 - hb + rr, w = x.w0 - hb + rem - rr * qw;
    const bool valid = x.b0 + b < g.NB && h >= 0 && h < g.H && w >= 0 &&
                       w < g.W;
    uint4* p[4];
    uint4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      p[k] = reinterpret_cast<uint4*>(tile + q * 128 +
                                      (((half * 4 + k) ^ (q & 7)) << 4));
      v[k] = valid ? *p[k] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (valid) affine_relu(v[k], sc + 8 * k, sh + 8 * k);
      *p[k] = v[k];
    }
  }
}

// bf16(relu(a * scale + shift)) in f32 on A's registers of k-steps kk0
// and kk0 + 1 (load_a's): register 4 i + j holds row g + 8 (j & 1),
// channels c + 2 t and c + 2 t + 1 with c = c0 + 16 (kk0 + i) + 8 (j >>
// 1).  Rows whose `live` is false become 0.
__device__ __forceinline__ void affine_regs(uint32_t (&a)[8],
                                            const bool (&live)[2],
                                            const float* s_scale,
                                            const float* s_shift, int c0,
                                            int kk0, int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ch = c0 + 16 * (kk0 + (i >> 2)) + 8 * ((i >> 1) & 1) + 2 * t;
    const float2 sc = *reinterpret_cast<const float2*>(s_scale + ch);
    const float2 sh = *reinterpret_cast<const float2*>(s_shift + ch);
    const float lo = fmaf(__uint_as_float(a[i] << 16), sc.x, sh.x);
    const float hi = fmaf(__uint_as_float(a[i] & 0xffff0000u), sc.y, sh.y);
    uint32_t v;
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(v) : "f"(hi), "f"(lo));
    a[i] = live[i & 1] ? v : 0u;
  }
}

// Rows whose `live` is false become 0.
__device__ __forceinline__ void mask_rows(uint32_t (&a)[8],
                                          const bool (&live)[2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = live[i & 1] ? a[i] : 0u;
}

// One level of a reduce-scatter over the lanes `off` apart: v[0 .. V / 2)
// becomes the sum of the two lanes' halves that this lane keeps (the
// upper one where `upper`).
template <int V>
__device__ __forceinline__ void reduce_half(float* v, int upper, int off) {
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float send = upper ? v[i] : v[i + V / 2];
    const float keep = upper ? v[i + V / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// CONV: A is the tile's input box with a one-pixel halo, once per 64
// channels; each of the nine taps gathers its rows from it through
// ldmatrix (RS); with AFFINE the prologue warps run the prologue on each
// A tile once, in place.  A matmul with AFFINE takes A through registers
// (RS) and applies the prologue there; without, wgmma reads A from
// shared memory (SS).  Grid: the persistent blocks; block: THREADS; part
// (2, gridDim.x, N) or null.
template <bool CONV, bool AFFINE, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_stats(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_y,
               const float* __restrict__ scale,
               const float* __restrict__ shift, float* __restrict__ part,
               const Geo g) {
  constexpr int HB = CONV ? 1 : 0;  // halo pixels around the tile's box
  constexpr bool RS = CONV || AFFINE;   // A through registers
  constexpr bool PRE = CONV && AFFINE;  // the prologue warps' pass
  constexpr uint32_t B_STAGE = BN / 64 * B_ATOM;
  extern __shared__ unsigned char smem[];
  const uint32_t base = align_1k(smem);
  unsigned char* gbase = smem + (base - smem_u32(smem));
  const bool stats = part != nullptr;
  const Smem lay(g, BN, stats, AFFINE);
  // mbarriers, MAX_STAGES each: A full (copied), ready (the prologue
  // done) and empty; B full and empty.
  const uint32_t a_full = base, a_empty = base + 8 * MAX_STAGES;
  const uint32_t b_full = base + 16 * MAX_STAGES;
  const uint32_t b_empty = base + 24 * MAX_STAGES;
  const uint32_t a_ready = base + 32 * MAX_STAGES;
  const uint32_t a_ring = base + lay.a_ring, b_ring = base + lay.b_ring;
  float* s_part = reinterpret_cast<float*>(gbase + lay.part);
  float* s_scale = reinterpret_cast<float*>(gbase + lay.scale);
  float* s_shift = reinterpret_cast<float*>(gbase + lay.shift);

  if (threadIdx.x == 0) {
    for (int i = 0; i < MAX_STAGES; ++i) {
      mbar_init(a_full + 8 * i, 1);
      mbar_init(a_empty + 8 * i, 8);  // one arrival a consumer warp
      mbar_init(b_full + 8 * i, 1);
      mbar_init(b_empty + 8 * i, 8);
      mbar_init(a_ready + 8 * i, PROLOGUE_THREADS);  // each prologue thread
    }
    mbar_init_fence();
  }
  if (stats) {
    for (int i = threadIdx.x; i < 2 * g.N; i += THREADS) s_part[i] = 0.f;
  }
  if (AFFINE) {
    for (int i = threadIdx.x; i < g.cchunks * BK; i += THREADS) {
      s_scale[i] = i < g.C ? scale[i] : 0.f;
      s_shift[i] = i < g.C ? shift[i] : 0.f;
    }
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER && threadIdx.x < PROLOGUE) {
    // The producer: one thread starts every copy of this block's tiles.
    if (threadIdx.x == PRODUCER) {
      int as = 0, ap = 0, an = 0, bs = 0, bp = 0, bn = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const Tile x = tile_at<BN>(g, t);
        for (int cc = 0; cc < g.cchunks; ++cc) {
          if (an++ >= g.a_stages) mbar_wait(a_empty + 8 * as, ap ^ 1);
          mbar_expect(a_full + 8 * as, g.a_rows * 128);
          tma_load_4d(a_ring + as * lay.a_stage, &map_a, a_full + 8 * as,
                      cc * BK, x.w0 - HB, x.h0 - HB, x.b0);
          if (++as == g.a_stages) {
            as = 0;
            ap ^= 1;
          }
          for (int tap = 0; tap < g.taps; ++tap) {
            if (bn++ >= g.b_stages) mbar_wait(b_empty + 8 * bs, bp ^ 1);
            const uint32_t st = b_ring + bs * B_STAGE;
            mbar_expect(b_full + 8 * bs, B_STAGE);
#pragma unroll
            for (int a = 0; a < BN / 64; ++a) {
              tma_load_4d(st + a * B_ATOM, &map_b, b_full + 8 * bs,
                          x.n0 + a * 64, cc * BK, tap, 0);
            }
            if (++bs == g.b_stages) {
              bs = 0;
              bp ^= 1;
            }
          }
        }
      }
    }
  } else if (threadIdx.x >= PROLOGUE) {
    // The prologue's warps: each A tile of the conv once, in place, as it
    // lands; "ready" tells the consumers.
    if (PRE) {
      int as = 0, ap = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const Tile x = tile_at<BN>(g, t);
        for (int cc = 0; cc < g.cchunks; ++cc) {
          mbar_wait(a_full + 8 * as, ap);
          transform(gbase + lay.a_ring + as * lay.a_stage, g, x, HB, cc,
                    threadIdx.x - PROLOGUE, PROLOGUE_THREADS, g.a_rows,
                    s_scale, s_shift);
          fence_proxy_async();  // before the next TMA write of the stage
          mbar_arrive(a_ready + 8 * as);
          if (++as == g.a_stages) {
            as = 0;
            ap ^= 1;
          }
        }
      }
    }
  } else {
    const int ct = threadIdx.x;
    const int wg = ct / WG_THREADS;
    const int warp = (ct >> 5) & 3, lane = ct & 31;
    const int gq = lane >> 2, t4 = lane & 3;
    const bool leader = ct == 0;
    const int row0 = wg * 64 + warp * 16 + gq;  // this thread's rows: + 0, 8
    const int ld_row =
        wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int ld_hi = lane >> 4;
    const int pix = g.wb * g.r * g.bi;
    const uint32_t staging = base + lay.staging;
    float* s_red = reinterpret_cast<float*>(gbase + lay.red);

    float acc[BN / 2];
    uint32_t alo[8], ahi[8];
    zero(acc);
    int as = 0, ap = 0, bs = 0, bp = 0, prev_a = 0, prev_b = 0, buf = 0;
    auto arrive = [&](uint32_t bars, int s) {
      if (lane == 0) mbar_arrive(bars + 8 * s);
    };

    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const Tile x = tile_at<BN>(g, t);
      // The rows this thread's accumulator holds: live output pixels?
      bool ok[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = row0 + 8 * j;
        const int b = p / (g.wb * g.r);
        const int rem = p - b * (g.wb * g.r);
        const int rr = rem / g.wb;
        ok[j] = p < pix && x.b0 + b < g.NB && x.h0 + rr < g.H &&
                x.w0 + rem - rr * g.wb < g.W;
      }
      // CONV: the box row (halo'd) of this lane's ldmatrix row at tap 4.
      int q_mid = g.wb + 3;
      if (CONV && ld_row < pix) {
        const int b = ld_row / (g.wb * g.r);
        const int rem = ld_row - b * (g.wb * g.r);
        const int rr = rem / g.wb;
        q_mid = (b * (g.r + 2) + rr + 1) * (g.wb + 2) + rem - rr * g.wb + 1;
      }
      int ks = 0;
      for (int cc = 0; cc < g.cchunks; ++cc) {
        mbar_wait((PRE ? a_ready : a_full) + 8 * as, ap);
        const uint32_t a_st = a_ring + as * lay.a_stage;
        for (int tap = 0; tap < g.taps; ++tap, ++ks) {
          mbar_wait(b_full + 8 * bs, bp);
          const uint32_t bst = b_ring + bs * B_STAGE;
          if (RS) {
            const int q = CONV ? q_mid + (tap / 3 - 1) * (g.wb + 2) +
                                     tap % 3 - 1
                               : ld_row;
            load_a(alo, a_st, q, ld_hi, 0);
            if (CONV) {
              mask_rows(alo, ok);
            } else {
              affine_regs(alo, ok, s_scale, s_shift, cc * BK, 0, t4);
            }
            pin(alo);
            wgmma_fence();
            wgmma_rs<BN>(acc, &alo[0], desc_mn(bst, B_ATOM), ks > 0);
            wgmma_rs<BN>(acc, &alo[4], desc_mn(bst + 2048, B_ATOM), 1);
            wgmma_commit();
            wgmma_wait<1>();  // the previous step is done
            pin(acc);
            pin(ahi);
            if (ks > 0) arrive(b_empty, prev_b);
            load_a(ahi, a_st, q, ld_hi, 2);
            if (tap == g.taps - 1) arrive(a_empty, as);  // A fully read
            if (CONV) {
              mask_rows(ahi, ok);
            } else {
              affine_regs(ahi, ok, s_scale, s_shift, cc * BK, 2, t4);
            }
            pin(ahi);
            wgmma_fence();
            wgmma_rs<BN>(acc, &ahi[0], desc_mn(bst + 4096, B_ATOM), 1);
            wgmma_rs<BN>(acc, &ahi[4], desc_mn(bst + 6144, B_ATOM), 1);
            wgmma_commit();
            wgmma_wait<1>();  // this step's first half is done
            pin(acc);
            pin(alo);
          } else {
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              wgmma_ss_t<BN>(acc, desc_k(a_st + wg * 64 * 128 + kk * 32),
                             desc_mn(bst + kk * 2048, B_ATOM),
                             ks > 0 || kk > 0);
            }
            wgmma_commit();
            wgmma_wait<1>();  // the previous step is done
            pin(acc);
            if (ks > 0) {
              arrive(a_empty, prev_a);
              arrive(b_empty, prev_b);
            }
          }
          prev_b = bs;
          if (++bs == g.b_stages) {
            bs = 0;
            bp ^= 1;
          }
        }
        prev_a = as;
        if (++as == g.a_stages) {
          as = 0;
          ap ^= 1;
        }
      }
      wgmma_wait<0>();
      pin(acc);
      arrive(b_empty, prev_b);
      if (!RS) arrive(a_empty, prev_a);

      // Epilogue.  The staging tile is free once the last store read it.
      if (leader) bulk_wait_read<0>();
      bar_sync(CONSUMER_BAR, CONSUMERS);
      {
        // y as bf16 into the swizzled staging tile, four 8 x 8 matrices a
        // stmatrix: lane 8 j + i gives row i of matrix j, which is n-tile
        // nt + (j >> 1), rows 8 (j & 1) .. + 7 of the warp's 16.
        const int j = lane >> 3, i = lane & 7;
        const int row = wg * 64 + warp * 16 + (j & 1) * 8 + i;
#pragma unroll
        for (int nt = 0; nt < BN / 8; nt += 2) {
          const int n = nt + (j >> 1);
          stsm_x4(staging + (n / 8) * (BM * 128) + row * 128 +
                      (((n % 8) ^ i) << 4),
                  pack_f32(acc[4 * nt], acc[4 * nt + 1]),
                  pack_f32(acc[4 * nt + 2], acc[4 * nt + 3]),
                  pack_f32(acc[4 * nt + 4], acc[4 * nt + 5]),
                  pack_f32(acc[4 * nt + 6], acc[4 * nt + 7]));
        }
      }
      float* red = s_red + buf * (8 * 2 * BN);
      if (stats) {
        // Per column, the sum (which 0) and then the sum of squares (1) of
        // this thread's two rows, v[2 nt + (0, 1)] for columns 8 nt + 2 t
        // (+ 1); a reduce-scatter over the warp's 8 row groups leaves lane
        // (g, t) n-tiles nt0 .. nt0 + BN / 64 - 1.
        const int nt0 = (gq & 1) * (BN / 16) + ((gq >> 1) & 1) * (BN / 32) +
                        ((gq >> 2) & 1) * (BN / 64);
        float* w = red + (wg * 4 + warp) * 2 * BN;
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          float v[BN / 4];
#pragma unroll
          for (int nt = 0; nt < BN / 8; ++nt) {
            const float* c = &acc[4 * nt];
            v[2 * nt] = which ? c[0] * c[0] + c[2] * c[2] : c[0] + c[2];
            v[2 * nt + 1] = which ? c[1] * c[1] + c[3] * c[3] : c[1] + c[3];
          }
          reduce_half<BN / 4>(v, gq & 1, 4);
          reduce_half<BN / 8>(v, (gq >> 1) & 1, 8);
          reduce_half<BN / 16>(v, (gq >> 2) & 1, 16);
#pragma unroll
          for (int k = 0; k < BN / 32; ++k) {
            w[which * BN + (nt0 + k / 2) * 8 + 2 * t4 + (k & 1)] = v[k];
          }
        }
      }
      fence_proxy_async();
      bar_sync(CONSUMER_BAR, CONSUMERS);
      if (leader) {
#pragma unroll
        for (int a = 0; a < BN / 64; ++a) {
          if (x.n0 + a * 64 < g.N) {
            tma_store_4d(&map_y, staging + a * (BM * 128), x.n0 + a * 64,
                         x.w0, x.h0, x.b0);
          }
        }
        bulk_commit();
      }
      if (stats) {
        // The 8 warps' sums in order into the block's partials; a column's
        // slot always has the same thread as its writer.
        for (int i = ct; i < 2 * BN; i += CONSUMERS) {
          const int which = i / BN, c = i % BN;
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < 8; ++w) v += red[w * 2 * BN + which * BN + c];
          if (x.n0 + c < g.N) s_part[which * g.N + x.n0 + c] += v;
        }
        buf ^= 1;
      }
    }
    bar_sync(CONSUMER_BAR, CONSUMERS);
    if (stats) {
      for (int i = ct; i < 2 * g.N; i += CONSUMERS) {
        const int which = i / g.N, c = i % g.N;
        part[((i64)which * gridDim.x + blockIdx.x) * g.N + c] = s_part[i];
      }
    }
    if (leader) bulk_wait_all();
  }
}

// out[which][n] = sum over the G partials part[which][g][n], in order of g
// within each of 8 strided groups, then the 8 groups in order.  Grid
// (ceil(N / 32), 2), block (32, 8).
__global__ void reduce_partials(const float* __restrict__ part, int groups,
                                int n, float* __restrict__ out) {
  __shared__ float acc[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int which = blockIdx.y;
  float v = 0.f;
  if (col < n) {
    const float* src = part + (i64)which * groups * n + col;
    for (int gi = threadIdx.y; gi < groups; gi += 8) v += src[(i64)gi * n];
  }
  acc[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && col < n) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += acc[j][threadIdx.x];
    out[which * n + col] = s;
  }
}

// The tile counts of g from its problem, box and column tile.
inline void finish(Geo& g, int bn) {
  const int hb = g.taps == 9 ? 1 : 0;
  g.tw = (g.W + g.wb - 1) / g.wb;
  g.th = (g.H + g.r - 1) / g.r;
  g.tn = (g.NB + g.bi - 1) / g.bi;
  g.ntn = (g.N + bn - 1) / bn;
  g.cchunks = (g.C + BK - 1) / BK;
  g.tiles = g.tw * g.th * g.tn * g.ntn;
  g.a_rows = (g.wb + 2 * hb) * (g.r + 2 * hb) * g.bi;
}

template <bool CONV, bool AFFINE, int BN>
int launch_kernel(const CUtensorMap& ma, const CUtensorMap& mb,
                  const CUtensorMap& my, const float* scale,
                  const float* shift, float* part, const Geo& g, int grid,
                  cudaStream_t st) {
  auto kernel = gemm_stats<CONV, AFFINE, BN>;
  const int bytes = Smem(g, BN, part != nullptr, AFFINE).bytes;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  kernel<<<grid, THREADS, bytes, st>>>(ma, mb, my, scale, shift, part, g);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_bn(const CUtensorMap& ma, const CUtensorMap& mb,
              const CUtensorMap& my, const float* scale, const float* shift,
              float* part, const Geo& g, int grid, cudaStream_t st) {
  const bool conv = g.taps == 9, affine = scale != nullptr;
  if (conv && affine) {
    return launch_kernel<true, true, BN>(ma, mb, my, scale, shift, part, g,
                                         grid, st);
  }
  if (conv) {
    return launch_kernel<true, false, BN>(ma, mb, my, scale, shift, part, g,
                                          grid, st);
  }
  if (affine) {
    return launch_kernel<false, true, BN>(ma, mb, my, scale, shift, part, g,
                                          grid, st);
  }
  return launch_kernel<false, false, BN>(ma, mb, my, scale, shift, part, g,
                                         grid, st);
}

// Encode x, B and y's maps, launch the GEMM on `grid` persistent blocks
// and, with part set, the reduction of the blocks' partials into stats
// ((2, N) f32: sums then sums of squares).  g holds the problem, the
// tile box and the ring depths.  Returns 0, a cudaError_t, or 100000 +
// the CUresult of a map that could not be encoded.
inline int launch(const void* x, const float* scale, const float* shift,
                  const void* b, void* y, float* part, float* stats, Geo g,
                  int bn, int grid, cudaStream_t st) {
  typedef unsigned long long u64;
  const int pix = g.wb * g.r * g.bi;
  const int hb = g.taps == 9 ? 1 : 0;
  if ((bn != 64 && bn != 128) || pix < 1 || pix > BM || grid < 1 ||
      g.a_stages < 1 || g.a_stages > MAX_STAGES || g.b_stages < 2 ||
      g.b_stages > MAX_STAGES || (scale == nullptr) != (shift == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  finish(g, bn);
  if (g.a_rows > 256) return (int)cudaErrorInvalidValue;  // a TMA box dim
  const u64 C = g.C, W = g.W, H = g.H, NB = g.NB, N = g.N, T = g.taps;
  const unsigned box_a[4] = {64u, (unsigned)(g.wb + 2 * hb),
                             (unsigned)(g.r + 2 * hb), (unsigned)g.bi};
  const unsigned box_y[4] = {64u, (unsigned)g.wb, (unsigned)g.r,
                             (unsigned)g.bi};
  CUtensorMap ma, mb, my;
  int err = map_4d(&ma, x, {C, W, H, NB}, {C * 2, W * C * 2, H * W * C * 2},
                   box_a);
  if (!err) {
    err = map_4d(&mb, b, {N, C, T, 1}, {N * 2, C * N * 2, T * C * N * 2},
                 {64u, 64u, 1u, 1u});
  }
  if (!err) {
    err = map_4d(&my, y, {N, W, H, NB}, {N * 2, W * N * 2, H * W * N * 2},
                 box_y);
  }
  if (err) return err;
  err = bn == 64 ? launch_bn<64>(ma, mb, my, scale, shift, part, g, grid, st)
                 : launch_bn<128>(ma, mb, my, scale, shift, part, g, grid,
                                  st);
  if (err || part == nullptr) return err;
  reduce_partials<<<dim3((g.N + 31) / 32, 2), dim3(32, 8), 0, st>>>(
      part, grid, g.N, stats);
  return (int)cudaGetLastError();
}

}  // namespace fused_gemm
