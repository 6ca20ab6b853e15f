// Int8 weight-only matmul for Hopper (sm_90a): out = (x @ W_i8) * scale.
//
// Replaces the Pallas TPU kernel container_engine_accelerators_tpu/
// ops/quant_matmul.py `_kernel` (:31) via `_int8_matmul_pallas` (:122,
// pallas_call :145), entry `int8_weight_matmul` (:77).
//
// What it computes: x (rows, in) bf16 or f32, W (in, out) int8 with a
// per-output-channel f32 scale (out,).  Each int8 tile is turned into
// bf16 on chip, the product accumulates in f32, and the scale multiplies
// the f32 sum once per output element; the result is cast to x's type.
// Device memory sees only the int8 weight bytes, as on the TPU.
//
// Bound: bytes.  At decode shapes (rows = the 16 slots, or 1 for the
// prefill head) the weight stream is the work: every byte is read once.
// At these sizes a call lasts a few microseconds, so the design is about
// keeping enough bytes in flight from the first cycle and paying one
// launch, not about arithmetic.
//
// Design, one launch a call:
//   - A block owns a tile of W's columns (64 for bf16 x, 128 for f32 x),
//     a tile of 16 rows of x and a slice of the `in` range.  The slices of
//     one column tile form a thread-block cluster along `in` (grid y, 1-8
//     blocks).  When its products are done, a block adds its warps'
//     partials in shared memory and pushes the sums, 1/ks of the tile to
//     each block of the cluster, through distributed shared memory
//     (st.async, whose bytes complete an mbarrier in the receiving block:
//     no closing cluster barrier and its cluster-wide fence, PERF.md);
//     once its barrier has all the bytes of its share, each block adds
//     the share over the ranks in order, scales (the scales were loaded
//     at the start), casts and stores it, four elements a thread.  A
//     fixed order: deterministic, no atomics, no global partials, no
//     second launch.
//   - Each warp (8 a block for bf16 x, 4 for f32 x) streams its own 16
//     of every 16 x warps weight rows through a private ring of 4 stages
//     by cp.async (16 bytes a copy; 8 where `out` is not a multiple of
//     16), with the matching x piece beside it.  A lane converts the
//     weight bytes it copied itself (a byte permute and one subtraction
//     per element, exact) into a swizzled bf16 tile, and the warp reads it
//     back with ldmatrix.trans as the B operand of mma.sync m16n8k16 (bf16
//     in, f32 accumulate): 16 rows are exactly one m16 tile, and an int8
//     weight is exact in bf16.  The warps never wait for each other until
//     the epilogue.
//   - f32 x (the vocab head): x is split into three bf16 parts hi + mid +
//     lo that together carry its 24 significant bits, and the three
//     products go into one f32 accumulator.  An int8 weight times a bf16
//     part is exact in f32, so the result keeps f32 accuracy (within
//     1e-4 of max|out|, where TF32 would not), and the tripled tensor-core
//     work is free in a stream bound by bytes.
//   - x is staged by cp.async where its rows are 16-byte aligned (every
//     shape of the model), else by plain loads.
//
// Plain C interface, bound from Python with ctypes.  Returns the launch's
// cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using cea::smem_u32;

constexpr int kRows = 16;  // rows of x per block: one m16 tile

// The block's shape by x's type (chosen by timing on the H100, PERF.md):
// bf16 x, 8 warps over 64 weight columns; f32 x (the vocab head, three
// products per weight), 4 warps over 128 columns, so each split of x
// feeds twice the weight.  Each warp takes 16 rows of every stage, and
// keeps a ring of 4 stages.
template <typename TX>
struct Layout {
  static constexpr bool kF32 = sizeof(TX) == 4;
  static constexpr int kWarps = kF32 ? 4 : 8;
  static constexpr int kThreads = kWarps * 32;
  // Blocks an SM must hold, for ptxas's register budget: left to itself
  // it capped the bf16 instances' registers and spilled; one block needs
  // no cap (bf16 x never runs two to an SM at these grids), three f32
  // blocks (the head's 250 over 132 SMs) cap it at 170.
  static constexpr int kMinBlocks = kF32 ? 3 : 1;
  static constexpr int kCols = kF32 ? 128 : 64;  // weight columns
  static constexpr int kStageRows = 16 * kWarps;  // weight rows a stage
  static constexpr int kStages = 4;              // ring depth per warp
  static constexpr int kLaneBytes = kCols / 2;   // a lane's bytes a row
  static constexpr int kTile = kRows * kCols;    // output elements
  // Per warp and stage: 16 weight rows x kCols int8, x's 16 rows x 16 k.
  static constexpr int kWBytes = 16 * kCols;
  static constexpr int kXBytes = kRows * 16 * (int)sizeof(TX);
  static constexpr int kSlot = kWBytes + kXBytes;
  static constexpr int kRing = kStages * kSlot;  // one warp's ring
  static constexpr int kCvt = 16 * kCols * 2;    // one warp's bf16 tile
  // The partials that the cluster's blocks push here: one a rank of this
  // block's 1/ks share of the tile, whole float4s (ks x 4 ceil(kTile /
  // 4 ks) floats, at most kTile + 28 for ks <= 8).
  static constexpr int kPush = (kTile + 32) * 4;
  // A row of the warps' tiles summed in the epilogue, padded by 8 floats
  // so that a fragment's float2 stores fall on distinct banks.
  static constexpr int kRowF = kCols + 8;
  static constexpr int kRed = kRows * kRowF;  // floats of one warp's tile
  // The scale of the block's columns, loaded at the start.
  static constexpr int kScaleAt = kWarps * (kRing + kCvt) + kPush;
  // The mbarrier that the pushes complete (their bytes).
  static constexpr int kBarAt = kScaleAt + kCols * 4;
  static constexpr int kBytes = kBarAt + 16;
  static_assert(kRed * 4 <= kRing, "the warps' tiles alias the rings");
  static_assert(kThreads >= kCols, "a thread loads each column's scale");
};

// Four consecutive outputs (16-byte aligned f32, 8-byte aligned bf16).
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(cea::pack_f32(v.x, v.y), cea::pack_f32(v.z, v.w));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The A fragments of x's 16 rows x 16 k (one stage of one warp, row-major
// in shared memory): bf16 x gives one fragment, f32 x three (hi, mid, lo).
__device__ __forceinline__ void x_frags(const __nv_bfloat16* xs, int g, int t,
                                        uint32_t (&a)[3][4]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(xs);
  a[0][0] = w[g * 8 + t];
  a[0][1] = w[(g + 8) * 8 + t];
  a[0][2] = w[g * 8 + t + 4];
  a[0][3] = w[(g + 8) * 8 + t + 4];
}

__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(r1 - __bfloat162float(p[1]));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void x_frags(const float* xs, int g, int t,
                                        uint32_t (&a)[3][4]) {
  // Register j of the fragment: row g (+8 for j odd), k 2t (+8 for j >= 2).
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = g + 8 * (j & 1);
    const int k = 2 * t + 8 * (j >> 1);
    const float2 v = *reinterpret_cast<const float2*>(xs + r * 16 + k);
    __nv_bfloat16 lo[3], hi[3];
    split3(v.x, lo);
    split3(v.y, hi);
#pragma unroll
    for (int p = 0; p < 3; ++p) a[p][j] = pack2(lo[p], hi[p]);
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of the same shared-memory word in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// Four floats into (another block's) shared memory, completing their 16
// bytes on that block's mbarrier: no fence, no cluster barrier.
__device__ __forceinline__ void st_async4(uint32_t addr, float4 v,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// cea::mbar_wait with acquire at cluster scope: the bytes that completed
// the phase came from other blocks of the cluster.  Bounded: traps
// rather than hanging the card.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  for (int spin = 0; spin < (1 << 20); ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity), "r"(1000)
        : "memory");
    if (done) return;
  }
  __trap();
}

// One launch: grid (column tiles, ks, row tiles), cluster (1, ks, 1).
// VEC16: 16-byte weight copies (out % 16 == 0, W 16-byte aligned), else 8.
// XVEC: x staged by 16-byte cp.async (rows 16-byte aligned), else loads.
template <typename TX, bool VEC16, bool XVEC>
__global__ void __launch_bounds__(Layout<TX>::kThreads,
                                  Layout<TX>::kMinBlocks)
    qmm_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, TX* __restrict__ out,
               int rows, int in_dim, int out_dim, int krange) {
  using L = Layout<TX>;
  constexpr int kPlanes = L::kF32 ? 3 : 1;
  constexpr int kCols = L::kCols, kStages = L::kStages;
  constexpr int kLaneBytes = L::kLaneBytes, kTile = L::kTile;
  constexpr int kWBytes = L::kWBytes, kWarps = L::kWarps;
  constexpr int kThreads = L::kThreads, kStageRows = L::kStageRows;
  extern __shared__ __align__(1024) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col0 = blockIdx.x * kCols;
  const int k0 = blockIdx.y * krange;
  const int r0 = blockIdx.z * kRows;
  const int kn = max(0, min(krange, in_dim - k0));
  const int stages = (kn + kStageRows - 1) / kStageRows;

  uint8_t* ring = smem + warp * L::kRing;
  uint8_t* cvt = smem + kWarps * L::kRing + warp * L::kCvt;
  float* push = reinterpret_cast<float*>(smem + kWarps * (L::kRing + L::kCvt));
  const uint32_t ring_u = smem_u32(ring);
  const uint32_t cvt_u = smem_u32(cvt);

  // This lane's piece of every stage: weight row wr (of the warp's 16),
  // bytes [kLaneBytes half, kLaneBytes (half + 1)) of the block's
  // columns; x row wr, k [8 half, 8 half + 8) of the warp's 16.
  const int wr = lane >> 1;
  const int half = lane & 1;
  const int wcol = col0 + kLaneBytes * half;

  auto fetch = [&](int s) {
    const uint32_t slot = ring_u + (s % kStages) * L::kSlot;
    const int k = kStageRows * s + 16 * warp + wr;  // within the slice
    const bool krow = k < kn;
    const int8_t* src = w + (size_t)(k0 + (krow ? k : 0)) * out_dim;
    constexpr int kCopy = VEC16 ? 16 : 8;
#pragma unroll
    for (int c = 0; c < kLaneBytes / kCopy; ++c) {
      const int col = wcol + kCopy * c;
      const bool in = krow && col < out_dim;
      const uint32_t dst = slot + wr * kCols + kLaneBytes * half + kCopy * c;
      if (VEC16) {
        cea::cp_async16(dst, in ? src + col : w, in ? 16 : 0);
      } else {
        cea::cp_async8(dst, in ? src + col : w, in ? 8 : 0);
      }
    }
    // x: row wr, k [8 half, 8 half + 8) of this warp's 16 rows of the stage.
    const int xk = kStageRows * s + 16 * warp + 8 * half;
    const int left = max(0, min(8, kn - xk));
    const bool xrow = r0 + wr < rows;
    const uint32_t xdst = slot + kWBytes + (wr * 16 + 8 * half) * sizeof(TX);
    const TX* xsrc = x + (size_t)(r0 + wr) * in_dim + k0 + xk;
    if (XVEC) {
      const int bytes = xrow ? left * (int)sizeof(TX) : 0;
#pragma unroll
      for (int c = 0; c < (int)sizeof(TX) / 2; ++c) {
        const int b = max(0, min(16, bytes - 16 * c));
        cea::cp_async16(xdst + 16 * c,
                        b ? (const void*)(xsrc + c * 16 / sizeof(TX))
                          : (const void*)x,
                        b);
      }
    } else {
      TX* dst = reinterpret_cast<TX*>(ring + (s % kStages) * L::kSlot +
                                      kWBytes) +
                wr * 16 + 8 * half;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        dst[e] = (xrow && e < left) ? xsrc[e] : TX(0.f);
      }
    }
  };

  float acc[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) fetch(s);
    cea::cp_async_commit();
  }
  // The block's scales, read now so that the load's round trip overlaps
  // the stream (the epilogue would wait a whole one for it otherwise).
  const float sc =
      tid < kCols && col0 + tid < out_dim ? __ldg(scale + col0 + tid) : 0.f;
  // The push barrier: one arrival (here) announcing the bytes of this
  // block's share from every rank; the pushes complete them.  The
  // cluster barrier's first phase then says that every block has
  // started and initialised its barrier; it is waited for only before
  // the first push, long after.
  const int ks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int share = (kTile + 4 * ks - 1) / (4 * ks) * 4;  // whole float4s
  const uint32_t bar = smem_u32(smem + L::kBarAt);
  if (tid == 0) {
    cea::mbar_init(bar, 1);
    cea::mbar_init_fence();
    cea::mbar_expect(bar, 4 * ks * max(0, min(share, kTile - rank * share)));
  }
  cluster_arrive_relaxed();
  for (int s = 0; s < stages; ++s) {
    // Every lane is done with stage s - 1 (its x in the slot refilled
    // now, and the bf16 tile rewritten below).
    __syncwarp();
    if (s + kStages - 1 < stages) fetch(s + kStages - 1);
    cea::cp_async_commit();
    cea::cp_async_wait<kStages - 1>();
    // This lane's weight bytes (its own copies) -> bf16 in the warp's
    // tile: row wr, 16-byte chunks from (kCols / 16) half, swizzled.
    const uint8_t* slot = ring + (s % kStages) * L::kSlot;
    const uint4* src = reinterpret_cast<const uint4*>(slot + wr * kCols +
                                                      kLaneBytes * half);
#pragma unroll
    for (int c = 0; c < kLaneBytes / 16; ++c) {
      const uint4 q = src[c];
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float f[4];
          cea::i8x4_to_f32(words[2 * h + i], f);
          b[2 * i] = cea::pack_f32(f[0], f[1]);
          b[2 * i + 1] = cea::pack_f32(f[2], f[3]);
        }
        const int chunk = (kCols / 16) * half + 2 * c + h;
        *reinterpret_cast<uint4*>(cvt + wr * (2 * kCols) +
                                  ((chunk ^ (wr & 7)) << 4)) =
            make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
    __syncwarp();  // the tile and x (other lanes' copies) are visible
    uint32_t a[3][4];
    x_frags(reinterpret_cast<const TX*>(slot + kWBytes), g, t, a);
    const int mi = lane >> 3;
    const int krow = (lane & 7) + 8 * (mi & 1);
#pragma unroll
    for (int j = 0; j < kCols / 16; ++j) {
      uint32_t b[4];
      const int chunk = 2 * j + (mi >> 1);
      ldsm_x4_t(b, cvt_u + krow * (2 * kCols) + ((chunk ^ (krow & 7)) << 4));
#pragma unroll
      for (int p = kPlanes - 1; p >= 0; --p) {
        mma_bf16(acc[2 * j], a[p], b[0], b[1]);
        mma_bf16(acc[2 * j + 1], a[p], b[2], b[3]);
      }
    }
  }

  // The block's partial tile, the warps' tiles summed in warp order
  // through shared memory (aliasing the drained rings), is pushed to the
  // blocks that finish it: element e to rank e / share, at row (this
  // rank) of its push buffer (distributed shared memory, st.async).  Each
  // block waits on its own barrier for its share from every rank and adds
  // them in rank order: deterministic.  A block leaves only after every
  // push into it has landed, and no block reads another's memory, so
  // none writes into a block that has left.
  cluster_wait();  // every block has started and set up its barrier
  cea::cp_async_wait<0>();
  float* scs = reinterpret_cast<float*>(smem + L::kScaleAt);
  if (tid < kCols) scs[tid] = sc;
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = (g + 8 * h) * L::kRowF + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(red + warp * L::kRed + e) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
  __syncthreads();
  // Four consecutive elements a thread (one row: kCols is a multiple of 4).
  for (int e = 4 * tid; e < kTile; e += 4 * kThreads) {
    const int at = (e / kCols) * L::kRowF + e % kCols;
    float4 v = *reinterpret_cast<const float4*>(red + at);
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) {
      const float4 u = *reinterpret_cast<const float4*>(red + wi * L::kRed +
                                                        at);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int to = e / share;
    st_async4(mapa(smem_u32(push + rank * share + e % share), to), v,
              mapa(bar, to));
  }
  mbar_wait_cluster(bar, 0);  // every rank's partials of this share
  for (int e = 4 * tid; e < share; e += 4 * kThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < ks; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(push + q * share + e);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    // te is a multiple of 4 and out_dim of 8: the four are in or out.
    const int te = rank * share + e;
    const int row = r0 + te / kCols;
    const int col = col0 + te % kCols;
    if (te < kTile && row < rows && col < out_dim) {
      const float4 c = *reinterpret_cast<const float4*>(scs + te % kCols);
      store4(out + (size_t)row * out_dim + col,
             make_float4(v.x * c.x, v.y * c.y, v.z * c.z, v.w * c.w));
    }
  }
}

template <typename TX, bool VEC16, bool XVEC>
int launch(const void* x, const void* w, const void* scale, void* out,
           int rows, int in_dim, int out_dim, int ksplit, int krange,
           void* stream) {
  auto kernel = qmm_kernel<TX, VEC16, XVEC>;
  const int bytes = Layout<TX>::kBytes;
  static bool attr = false;  // once per instantiation
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    attr = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((out_dim + Layout<TX>::kCols - 1) / Layout<TX>::kCols,
                     ksplit,
                     (rows + kRows - 1) / kRows);
  cfg.blockDim = dim3(Layout<TX>::kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = ksplit;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(
      &cfg, kernel, (const TX*)x, (const int8_t*)w, (const float*)scale,
      (TX*)out, rows, in_dim, out_dim, krange);
  return err ? err : (int)cudaGetLastError();
}

template <typename TX>
int dispatch(const void* x, const void* w, const void* scale, void* out,
             int rows, int in_dim, int out_dim, int ksplit, int krange,
             void* stream) {
  const bool vec16 = out_dim % 16 == 0 && (uintptr_t)w % 16 == 0;
  const bool xvec = ((size_t)in_dim * sizeof(TX)) % 16 == 0 &&
                    (uintptr_t)x % 16 == 0;
#define CEA_QMM(V, XV)                                                  \
  return launch<TX, V, XV>(x, w, scale, out, rows, in_dim, out_dim,     \
                           ksplit, krange, stream)
  if (vec16 && xvec) CEA_QMM(true, true);
  if (vec16) CEA_QMM(true, false);
  if (xvec) CEA_QMM(false, true);
  CEA_QMM(false, false);
#undef CEA_QMM
}

}  // namespace

// x_type: 0 = f32, 1 = bf16 (out has x's type).  Requires out_dim % 8 ==
// 0, W 8-byte aligned (the wrapper checks), 1 <= ksplit <= 8, krange a
// multiple of 64 and ksplit * krange >= in_dim (ops/quant_matmul.py
// `qmm_plan` chooses them; its tests hold that).  Returns a cudaError_t; -1 for an x type this
// file does not build.
extern "C" int cea_int8_matmul(const void* x, const void* w,
                               const void* scale, void* out, int x_type,
                               int rows, int in_dim, int out_dim,
                               int ksplit, int krange, void* stream) {
  if (x_type == 0)
    return dispatch<float>(x, w, scale, out, rows, in_dim, out_dim, ksplit,
                           krange, stream);
  if (x_type == 1)
    return dispatch<__nv_bfloat16>(x, w, scale, out, rows, in_dim, out_dim,
                                   ksplit, krange, stream);
  return -1;
}
