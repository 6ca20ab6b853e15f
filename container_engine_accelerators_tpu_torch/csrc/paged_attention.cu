// Single-query paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel container_engine_accelerators_tpu/
// ops/paged_attention.py `_paged_fn` (body :107-161, pallas_call :196),
// its bf16/f32 path and its int8 dequant-in-kernel twin.
//
// What it computes, per (row, head): walk the row's block table, and for
// every logical page j read physical page bt[row, j] of the K/V pools
// (n_pages, page, heads, d_head), score q . k over the page's slots
// (q pre-scaled by 1/sqrt(d) in f32, f32 scores, -1e30 mask fill), fold
// the scores into an online softmax (running max m, running sum l, f32
// accumulator), and write acc / l cast to q's type.  Masked p is forced
// to exactly 0, and a masked lane never touches the accumulator, so
// whatever the null page 0 (or a stale slot) holds cannot change one
// output bit.  The int8 twin multiplies the score by the K scale after
// the contraction and the V operand by the V scale.
//
// Bound: bytes, one read of every visible K/V row and a handful of flops
// a byte.  The design keeps those bytes in flight and spends few
// instructions on each:
//   - Grid (split, head, row); the splits of one (row, head) are one
//     thread-block cluster (1-8 blocks, `paged_plan` in the wrapper).
//     Each block walks a contiguous share of the row's pages.  At the end
//     each block leaves its (m, l, acc) in shared memory, and after a
//     cluster barrier block r merges a 1/splits share of the head
//     dimension over the blocks in rank order (distributed shared
//     memory) and writes it: one launch, no workspace, deterministic.
//   - A block first reads its pages' block-table entries and mask lanes
//     into shared memory and lists the chunks (CH slots of one page) that
//     hold a visible lane; a chunk with none is skipped, which is
//     bit-identical to folding it in (alpha = 1, p = 0).
//   - Each thread owns one 16-byte piece of the head dimension of CH / G
//     slots of every chunk, and copies exactly its own pieces (and, on the
//     first lane of a slot, the slot's two scales) by cp.async into a ring
//     of chunks, so no barrier is needed inside the loop.  The ring holds
//     as many chunks (2 to 8) as fit in 8 KB, and at least two: int8 at d
//     128 gets two chunks of 4.2 KB, bf16 two of 8 KB, f32 two of 16 KB,
//     so one chunk a block is in flight ahead of the one being scored,
//     and an SM holds several blocks.  A piece is read back with one
//     16-byte shared-memory load and converted in registers (int8 by byte
//     permute, exact).
//   - Head dims 32, 64, 128 and 256 have instances of their own.  Any
//     other d up to 256 (or a pool not 16-byte aligned) takes the d-256
//     instance with d at run time: the pieces past d are neither copied
//     nor read, and where a row is not a whole number of 16-byte pieces
//     each thread copies its pieces element by element, zero-filling the
//     tail of the last one (q's tail is zero too).
//   - The LPR lanes of a slot add their partial dot products by shuffles;
//     each warp keeps its own running max over its slots (a warp-wide
//     shuffle max, no serial loop and no barrier), and the block merges
//     its warps' states once, at the end, in a fixed order.
//
// Plain C interface, bound from Python with ctypes.  Returns the launch's
// cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kRingBytes = 8 << 10;  // the chunk ring's target size

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One 16-byte piece of a K or V row in shared memory, as f32.
__device__ __forceinline__ void piece(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void piece(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void piece(const int8_t* p, float (&f)[16]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float g[4];
    cea::i8x4_to_f32(w[i], g);
#pragma unroll
    for (int e = 0; e < 4; ++e) f[4 * i + e] = g[e];
  }
}

// The compile-time shape of one instance: KV type and head dim D.
template <typename KV, bool QUANT, int D>
struct Shape {
  static constexpr int EL = 16 / (int)sizeof(KV);  // elements a piece
  static constexpr int P = D / EL;                 // pieces a row
  static constexpr int LPR = P < 32 ? P : 32;      // lanes a slot
  static constexpr int PPT = P / LPR;              // pieces a thread
  static constexpr int G = kThreads / LPR;         // slots in parallel
  static constexpr int CH = G > 16 ? G : 16;       // slots a chunk
  static constexpr int SPT = CH / G;               // slots a thread
  static constexpr int KV_BYTES = CH * D * (int)sizeof(KV);
  static constexpr int STAGE = 2 * KV_BYTES + (QUANT ? 2 * CH * 4 : 0);
  static constexpr int S0 = kRingBytes / STAGE;
  static constexpr int STAGES = S0 < 2 ? 2 : (S0 > 8 ? 8 : S0);
  static constexpr int RING = STAGES * STAGE;
  static_assert(D % EL == 0 && P % LPR == 0, "head dim of whole pieces");
  static_assert(G * D * 4 + G * 4 + 4 * 4 <= RING,
                "the merge buffers alias the ring");
};

// Copies the first n of a piece's 16 / sizeof(KV) elements from src and
// zeros the rest: a piece that is not 16-byte aligned or not whole.
template <typename KV>
__device__ __forceinline__ void copy_piece(KV* dst, const KV* src, int n) {
  typedef typename std::conditional<
      sizeof(KV) == 1, uint8_t,
      typename std::conditional<sizeof(KV) == 2, uint16_t,
                                uint32_t>::type>::type U;
  const U* s = reinterpret_cast<const U*>(src);
  U* t = reinterpret_cast<U*>(dst);
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(KV); ++e) t[e] = e < n ? s[e] : U(0);
}

// VAR: the d-D instance run at a head dim d <= D given at run time;
// `whole` says every piece is whole and 16-byte aligned (cp.async).
template <typename TQ, typename KV, bool QUANT, int D, bool VAR>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const TQ* __restrict__ q,
                           const KV* __restrict__ k_pool,
                           const KV* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int32_t* __restrict__ bt,
                           const uint8_t* __restrict__ mask,
                           TQ* __restrict__ out, int pages, int page,
                           int heads, int per_split, float qscale,
                           int d_rt, bool whole) {
  using S = Shape<KV, QUANT, D>;
  constexpr int EL = S::EL, LPR = S::LPR, PPT = S::PPT, G = S::G;
  constexpr int CH = S::CH, SPT = S::SPT, STAGES = S::STAGES;
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int split = blockIdx.x;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gi = tid / LPR;  // this thread's slot group
  const int pi = tid % LPR;  // and its piece within the slot
  const int leader = lane - pi;
  const int j0 = split * per_split;
  const int np = max(0, min(pages, j0 + per_split) - j0);
  const int cpp = (page + CH - 1) / CH;  // chunks a page
  const int dd = VAR ? d_rt : D;          // the head dim
  const bool cp16 = !VAR || whole;
  // Whether piece pp of this thread holds any of the d elements.
  auto live = [&](int pp) { return !VAR || (pp * LPR + pi) * EL < dd; };

  // Shared memory: the ring, the block's merged state (D + 2 floats),
  // then its block-table entries, mask lanes and visible-chunk list.
  uint8_t* ring = smem;
  float* part = reinterpret_cast<float*>(smem + S::RING);
  int* bt_s = reinterpret_cast<int*>(part + D + 2);
  int* list = bt_s + per_split;
  int* n_vis_s = list + per_split * cpp;
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(n_vis_s + 1);

  const uint8_t* mrow = mask + ((size_t)row * pages + j0) * page;
  for (int i = tid; i < np; i += kThreads) {
    bt_s[i] = bt[(size_t)row * pages + j0 + i];
  }
  for (int i = tid; i < np * page; i += kThreads) mask_s[i] = mrow[i];

  float qr[PPT][EL];
  {
    const TQ* qrow = q + ((size_t)row * heads + head) * dd;
#pragma unroll
    for (int pp = 0; pp < PPT; ++pp) {
#pragma unroll
      for (int e = 0; e < EL; ++e) {
        const int i = (pp * LPR + pi) * EL + e;
        qr[pp][e] = (!VAR || i < dd) ? to_f(qrow[i]) * qscale : 0.f;
      }
    }
  }
  __syncthreads();

  // Warp 0 lists the chunks with a visible lane, in page order.
  if (warp == 0) {
    int n = 0;
    for (int c0 = 0; c0 < np * cpp; c0 += 32) {
      const int c = c0 + lane;
      bool vis = false;
      if (c < np * cpp) {
        const int jj = c / cpp;
        const int s0 = (c % cpp) * CH;
        const int s1 = min(page, s0 + CH);
        for (int s = s0; s < s1 && !vis; ++s) vis = mask_s[jj * page + s];
      }
      const unsigned bal = __ballot_sync(0xffffffffu, vis);
      if (vis) list[n + __popc(bal & ((1u << lane) - 1))] = c;
      n += __popc(bal);
    }
    if (lane == 0) *n_vis_s = n;
  }
  __syncthreads();
  const int n_vis = *n_vis_s;

  // Copies this thread's pieces (and scales) of visible chunk i.
  auto fetch = [&](int i) {
    uint8_t* st = ring + (i % STAGES) * S::STAGE;
    const int c = list[i];
    const int jj = c / cpp;
    const size_t pid = (size_t)bt_s[jj];
#pragma unroll
    for (int sp = 0; sp < SPT; ++sp) {
      const int sc = gi + G * sp;  // slot within the chunk
      const int slot = (c % cpp) * CH + sc;
      if (slot < page && mask_s[jj * page + slot]) {
        const size_t at = (pid * page + slot) * heads + head;
#pragma unroll
        for (int pp = 0; pp < PPT; ++pp) {
          if (!live(pp)) continue;
          const int off = (pp * LPR + pi) * EL;
          uint8_t* dst = st + (sc * D + off) * sizeof(KV);
          if (cp16) {
            cea::cp_async16(cea::smem_u32(dst), k_pool + at * dd + off, 16);
            cea::cp_async16(cea::smem_u32(dst + S::KV_BYTES),
                            v_pool + at * dd + off, 16);
          } else {
            copy_piece(reinterpret_cast<KV*>(dst), k_pool + at * dd + off,
                       dd - off);
            copy_piece(reinterpret_cast<KV*>(dst + S::KV_BYTES),
                       v_pool + at * dd + off, dd - off);
          }
        }
        if (QUANT && pi == 0) {
          const uint32_t dst = cea::smem_u32(st + 2 * S::KV_BYTES + sc * 4);
          cea::cp_async4(dst, k_scale + at, 4);
          cea::cp_async4(dst + CH * 4, v_scale + at, 4);
        }
      }
    }
  };

  float acc[PPT][EL];
#pragma unroll
  for (int pp = 0; pp < PPT; ++pp) {
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[pp][e] = 0.f;
  }
  float m = -1e30f;  // this warp's running max (uniform in the warp)
  float l = 0.f;     // this slot group's running sum

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_vis) fetch(i);
    cea::cp_async_commit();
  }
  for (int i = 0; i < n_vis; ++i) {
    if (i + STAGES - 1 < n_vis) fetch(i + STAGES - 1);
    cea::cp_async_commit();
    cea::cp_async_wait<STAGES - 1>();  // this thread's copies of chunk i
    const uint8_t* st = ring + (i % STAGES) * S::STAGE;
    const KV* ks = reinterpret_cast<const KV*>(st);
    const KV* vs = reinterpret_cast<const KV*>(st + S::KV_BYTES);
    const float* kss = reinterpret_cast<const float*>(st + 2 * S::KV_BYTES);
    const int c = list[i];
    const int jj = c / cpp;

    float s[SPT];
    bool vis[SPT];
    float mx = -1e30f;
#pragma unroll
    for (int sp = 0; sp < SPT; ++sp) {
      const int sc = gi + G * sp;
      const int slot = (c % cpp) * CH + sc;
      vis[sp] = slot < page && mask_s[jj * page + slot];
      float dot = 0.f;
#pragma unroll
      for (int pp = 0; pp < PPT; ++pp) {
        if (!live(pp)) continue;
        float f[EL];
        piece(ks + sc * D + (pp * LPR + pi) * EL, f);
#pragma unroll
        for (int e = 0; e < EL; ++e) dot += qr[pp][e] * f[e];
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      if (QUANT) {
        dot *= __shfl_sync(0xffffffffu, pi == 0 ? kss[sc] : 0.f, leader);
      }
      s[sp] = vis[sp] ? dot : -1e30f;
      mx = fmaxf(mx, s[sp]);
    }
#pragma unroll
    for (int off = 16; off >= LPR; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int pp = 0; pp < PPT; ++pp) {
#pragma unroll
      for (int e = 0; e < EL; ++e) acc[pp][e] *= alpha;
    }
#pragma unroll
    for (int sp = 0; sp < SPT; ++sp) {
      const int sc = gi + G * sp;
      const float p = vis[sp] ? expf(s[sp] - m_new) : 0.f;
      l += p;
      // A masked slot's scale was never copied, so it is read only
      // where p != 0.
      const float vsc =
          QUANT ? __shfl_sync(0xffffffffu, pi == 0 ? kss[CH + sc] : 0.f,
                              leader)
                : 1.f;
      // A p == 0 lane (masked or underflowed) is skipped, never
      // multiplied, so garbage there cannot leak.
      if (p != 0.f) {
        const float pv = QUANT ? p * vsc : p;
#pragma unroll
        for (int pp = 0; pp < PPT; ++pp) {
          if (!live(pp)) continue;
          float f[EL];
          piece(vs + sc * D + (pp * LPR + pi) * EL, f);
#pragma unroll
          for (int e = 0; e < EL; ++e) acc[pp][e] += pv * f[e];
        }
      }
    }
    m = m_new;
  }
  cea::cp_async_wait<0>();
  __syncthreads();  // the ring is drained: the merge buffers alias it

  // The block's state: its warps' (m, l, acc) merged in a fixed order.
  float* red_acc = reinterpret_cast<float*>(smem);  // (G, D)
  float* red_l = red_acc + G * D;                    // (G,)
  float* red_m = red_l + G;                          // (4,) one a warp
#pragma unroll
  for (int pp = 0; pp < PPT; ++pp) {
#pragma unroll
    for (int e = 0; e < EL; ++e) {
      red_acc[gi * D + (pp * LPR + pi) * EL + e] = acc[pp][e];
    }
  }
  if (pi == 0) red_l[gi] = l;
  if (lane == 0) red_m[warp] = m;
  __syncthreads();
  float mb = -1e30f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) mb = fmaxf(mb, red_m[w]);
  float wt[kThreads / 32];
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) wt[w] = expf(red_m[w] - mb);
  for (int d = tid; d < dd; d += kThreads) {
    float a = 0.f;
    for (int g = 0; g < G; ++g) a += wt[g * LPR / 32] * red_acc[g * D + d];
    part[d] = a;
  }
  if (tid == 0) {
    float lb = 0.f;
    for (int g = 0; g < G; ++g) lb += wt[g * LPR / 32] * red_l[g];
    part[D] = mb;
    part[D + 1] = lb;
  }
  cluster.sync();  // every split's state is in its shared memory

  // Block r writes dims [r share, (r + 1) share): the splits merged in
  // rank order.  A split that saw no visible lane holds m = -1e30, l = 0,
  // acc = 0 and weighs exp(-1e30 - M) = 0.
  const int splits = (int)cluster.num_blocks();
  const int share = (dd + splits - 1) / splits;
  const int d_end = min(dd, (split + 1) * share);
  for (int d = split * share + tid; d < d_end; d += kThreads) {
    float mx = -1e30f;
    for (int r = 0; r < splits; ++r) {
      mx = fmaxf(mx, cluster.map_shared_rank(part, r)[D]);
    }
    float ls = 0.f;
    float a = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* pr = cluster.map_shared_rank(part, r);
      const float w = expf(pr[D] - mx);
      ls += w * pr[D + 1];
      a += w * pr[d];
    }
    store(out + ((size_t)row * heads + head) * dd + d, a / ls);
  }
  cluster.sync();  // no block leaves while another reads its state
}

template <typename TQ, typename KV, bool QUANT, int D, bool VAR>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* bt, const void* mask, void* out,
           int b, int pages, int page, int heads, int d, bool whole,
           int splits, void* stream) {
  using S = Shape<KV, QUANT, D>;
  auto kernel = paged_attention_kernel<TQ, KV, QUANT, D, VAR>;
  const int per_split = (pages + splits - 1) / splits;
  const int cpp = (page + S::CH - 1) / S::CH;
  const size_t bytes = S::RING + (D + 2) * 4 +
                       4 * ((size_t)per_split * (1 + cpp) + 1) +
                       (size_t)per_split * page;
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;  // once per instantiation and size
  if (bytes > allowed) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err) return err;
    allowed = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, heads, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(
      &cfg, kernel, (const TQ*)q, (const KV*)k, (const KV*)v,
      (const float*)ks, (const float*)vs, (const int32_t*)bt,
      (const uint8_t*)mask, (TQ*)out, pages, page, heads, per_split,
      1.0f / sqrtf((float)d), d, whole);
  return err ? err : (int)cudaGetLastError();
}

template <typename TQ, typename KV, bool QUANT>
int by_dim(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* bt, const void* mask, void* out,
           int b, int pages, int page, int heads, int d, int splits,
           void* stream) {
  const bool whole = ((uintptr_t)k | (uintptr_t)v) % 16 == 0 &&
                     d * sizeof(KV) % 16 == 0;
#define CEA_PAGED_D(D, VAR)                                                \
  return launch<TQ, KV, QUANT, D, VAR>(q, k, v, ks, vs, bt, mask, out, b, \
                                       pages, page, heads, d, whole,      \
                                       splits, stream)
  if (whole && d == 32) CEA_PAGED_D(32, false);
  if (whole && d == 64) CEA_PAGED_D(64, false);
  if (whole && d == 128) CEA_PAGED_D(128, false);
  if (whole && d == 256) CEA_PAGED_D(256, false);
  if (d >= 1 && d <= 256) CEA_PAGED_D(256, true);
#undef CEA_PAGED_D
  return -1;
}

}  // namespace

// q_type: 0 = f32, 1 = bf16.  kv_type: 0 = f32, 1 = bf16, 2 = int8
// (k_scale / v_scale (n_pages, page, heads) f32 required; bf16 q only,
// as the int8 engine's activations are bf16).  d: 1 to 256.
// 1 <= splits <= 8 (one cluster), with splits * ceil(pages / splits)
// covering no more than one empty split (ops/paged_attention.py
// `paged_plan`).  Returns a cudaError_t; -1 for a type pair this file does
// not build or a head dim past 256.
extern "C" int cea_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale,
                                   const void* block_tables,
                                   const void* kv_mask, void* out,
                                   int q_type, int kv_type, int b,
                                   int pages, int page, int heads, int d,
                                   int splits, void* stream) {
  typedef __nv_bfloat16 bf16;
#define CEA_PAGED(TQ, TKV, QUANT)                                          \
  return by_dim<TQ, TKV, QUANT>(q, k_pool, v_pool, k_scale, v_scale,        \
                                block_tables, kv_mask, out, b, pages, page, \
                                heads, d, splits, stream)
  if (q_type == 0 && kv_type == 0) CEA_PAGED(float, float, false);
  if (q_type == 1 && kv_type == 1) CEA_PAGED(bf16, bf16, false);
  if (q_type == 1 && kv_type == 2) CEA_PAGED(bf16, int8_t, true);
#undef CEA_PAGED
  return -1;
}
