// The GEMM core shared by csrc/fused_linear.cu (1x1 conv as a matmul) and
// csrc/fused_conv3x3.cu (3x3 conv as an implicit GEMM), for Hopper (sm_90a).
//
// What it computes: y = A' @ B with f32 accumulation, y stored as bf16,
// and optionally the column sum and sum of squares of the f32 accumulator
// (before the cast), where A' is A with an optional per-channel prologue
// relu(a * scale + shift) applied in f32 and rounded to bf16 before the
// product.  A is either a row-major (M, K) matrix (LINEAR) or, for the
// 3x3 conv, the rows of the shifted input: row p = (n, h, w) and column
// k = tap * C + c read x[n, h + dy, w + dx, c] with tap = (dy + 1) * 3 +
// (dx + 1), zero outside the image.  B is row-major (K, N): for the conv
// the (9, C, C4) tap-ordered weights read as (9 C, C4).
//
// Design, simple first: a block of 8 warps owns output tiles of BM = 128
// rows x BN (64 or 128) columns and walks K in steps of BK = 32 through a
// two-stage cp.async ring in shared memory; each warp holds a 32 x BN/2
// accumulator in registers in mma.sync m16n8k16's C layout (bf16 in, f32
// accumulate), its operands loaded with ldmatrix (B transposed on the
// way).  Rows past M and halo pixels are zero-filled by cp.async; the
// prologue then runs in shared memory on the chunks that were read, by
// the thread that read them, so a zero-filled halo pixel stays 0 and does
// not become relu(shift).  The epilogue stages the bf16 tile in shared
// memory and writes it out 16 bytes a thread.  A block walks a fixed
// strided set of M tiles (gridDim.y blocks share them out), adds each
// tile's per-column sums into its own shared row per warp, and writes one
// partial per block; a second small kernel sums the partials in a fixed
// order.  No atomics: results are bitwise repeatable on a given card.
// No wgmma or TMA yet.
//
// Constraints (checked by the Python wrappers): K, C and N multiples of 8;
// every pointer 16-byte aligned; bf16 operands, f32 scale / shift.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fused_gemm {

typedef __nv_bfloat16 bf16;
typedef long long i64;

constexpr int BM = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int WARPS_M = 4;         // warps along M (32 rows each)
constexpr int WARPS_N = 2;         // warps along N (BN / 2 columns each)
constexpr int MT = 2;              // m16 tiles per warp
constexpr int LDA = BK + 8;        // shared A row stride: 80 bytes
constexpr int A_CHUNKS = BM * BK / 8 / THREADS;  // 16-byte A chunks a thread loads

template <int BN>
struct Cfg {
  static constexpr int LDB = BN + 8;  // shared B row stride
  static constexpr int LDY = BN + 8;  // shared y row stride (epilogue)
  static constexpr int WN = BN / WARPS_N;
  static constexpr int NT = WN / 8;   // n8 tiles per warp
  static constexpr int A_STAGE = BM * LDA;
  static constexpr int B_STAGE = BK * LDB;
  static constexpr int B_CHUNKS = BK * BN / 8 / THREADS;
  static constexpr int PIPE = 2 * (A_STAGE + B_STAGE);  // bf16 elements
  static constexpr int EPI = BM * LDY;
  static constexpr int SMEM = PIPE > EPI ? PIPE : EPI;
};

struct Problem {
  const bf16* a;       // LINEAR: (M, K); conv: x (batch, H, W, C)
  const float* scale;  // (C) prologue, or null
  const float* shift;
  const bf16* b;       // (K, N)
  bf16* y;             // (M, N)
  float* part;         // (2, gridDim.y, N) column partials, or null
  int M, K, N;         // conv: M = batch * H * W, K = 9 * C
  int C, H, W;         // conv only
};

__device__ __forceinline__ void cp16(void* smem, const void* gmem,
                                     bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16).
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Where one of a thread's A chunks of the current M tile starts: the
// global row (LINEAR) or the pixel (conv), kept for the whole K walk.
struct RowRef {
  int row;  // global row; >= M means a zero row
  int h, w;  // conv: the output pixel's coordinates
  i64 pix;   // conv: element offset of pixel (n, h, w) in x
};

template <bool CONV>
__device__ __forceinline__ RowRef row_ref(const Problem& p, int row) {
  RowRef r;
  r.row = row;
  r.h = r.w = 0;
  r.pix = 0;
  if (CONV && row < p.M) {
    const int hw = p.H * p.W;
    const int n = row / hw;
    const int rem = row - n * hw;
    r.h = rem / p.W;
    r.w = rem - r.h * p.W;
    r.pix = (i64)row * p.C;
  }
  return r;
}

// The source of the 8 A elements at (row, kk .. kk + 7), whether they lie
// inside the matrix / image, and their channel (for the prologue).
template <bool CONV>
__device__ __forceinline__ const bf16* a_src(const Problem& p,
                                             const RowRef& r, int kk,
                                             bool& valid, int& ch) {
  valid = r.row < p.M && kk < p.K;
  if (!CONV) {
    ch = kk;
    return valid ? p.a + (i64)r.row * p.K + kk : p.a;
  }
  const int tap = kk / p.C;
  ch = kk - tap * p.C;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int hh = r.h + dy, ww = r.w + dx;
  valid = valid && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
  return valid ? p.a + r.pix + (i64)(dy * p.W + dx) * p.C + ch : p.a;
}

template <bool CONV, bool TRANSFORM, int BN>
__global__ void __launch_bounds__(THREADS, 2) gemm_stats(Problem p) {
  typedef Cfg<BN> G;
  __shared__ __align__(16) bf16 smem[G::SMEM];
  __shared__ float s_acc[2][WARPS_M][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int mtiles = (p.M + BM - 1) / BM;
  const int ktiles = (p.K + BK - 1) / BK;
  const bool stats = p.part != nullptr;

  for (int i = tid; i < 2 * WARPS_M * BN; i += THREADS) {
    (&s_acc[0][0][0])[i] = 0.f;
  }

  // This thread's A chunks: rows (tid >> 2) + 64 i, columns 8 (tid & 3).
  const int a_row = tid >> 2, a_col = (tid & 3) * 8;

  for (int mt = blockIdx.y; mt < mtiles; mt += gridDim.y) {
    const int m0 = mt * BM;
    RowRef rows[A_CHUNKS];
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      rows[i] = row_ref<CONV>(p, m0 + a_row + i * (THREADS / 4));
    }

    auto load_stage = [&](int stage, int kt) {
      bf16* as = smem + stage * (G::A_STAGE + G::B_STAGE);
      bf16* bs = as + G::A_STAGE;
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < A_CHUNKS; ++i) {
        bool valid;
        int ch;
        const bf16* src = a_src<CONV>(p, rows[i], k0 + a_col, valid, ch);
        cp16(as + (a_row + i * (THREADS / 4)) * LDA + a_col, src, valid);
      }
#pragma unroll
      for (int i = 0; i < G::B_CHUNKS; ++i) {
        const int q = tid + i * THREADS;
        const int br = q / (BN / 8), bc = (q % (BN / 8)) * 8;
        const int kk = k0 + br, col = n0 + bc;
        const bool valid = kk < p.K && col < p.N;
        cp16(bs + br * G::LDB + bc, valid ? p.b + (i64)kk * p.N + col : p.b,
             valid);
      }
    };

    float acc[MT][G::NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int nj = 0; nj < G::NT; ++nj) {
        acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] =
            0.f;
      }
    }

    load_stage(0, 0);
    cp_commit();
    for (int kt = 0; kt < ktiles; ++kt) {
      if (kt + 1 < ktiles) load_stage((kt + 1) & 1, kt + 1);
      cp_commit();
      cp_wait1();
      bf16* as = smem + (kt & 1) * (G::A_STAGE + G::B_STAGE);
      const bf16* bs = as + G::A_STAGE;
      if (TRANSFORM) {
        // relu(a * scale + shift) in f32, rounded to bf16, on the chunks
        // this thread read; zero-filled chunks stay zero.
#pragma unroll
        for (int i = 0; i < A_CHUNKS; ++i) {
          bool valid;
          int ch;
          a_src<CONV>(p, rows[i], kt * BK + a_col, valid, ch);
          if (valid) {
            uint4* q = reinterpret_cast<uint4*>(
                as + (a_row + i * (THREADS / 4)) * LDA + a_col);
            uint4 v = *q;
            uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const __nv_bfloat162 x2 =
                  *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
              const float lo = fmaxf(
                  __low2float(x2) * __ldg(p.scale + ch + 2 * e) +
                      __ldg(p.shift + ch + 2 * e),
                  0.f);
              const float hi = fmaxf(
                  __high2float(x2) * __ldg(p.scale + ch + 2 * e + 1) +
                      __ldg(p.shift + ch + 2 * e + 1),
                  0.f);
              w[e] = pack_f32(lo, hi);
            }
            *q = v;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          ldsm_x4(af[mi], as + (wm * 32 + mi * 16 + (lane & 15)) * LDA +
                              ks * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int np = 0; np < G::NT / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4_t(bf, bs + (ks * 16 + (lane & 15)) * G::LDB +
                            wn * G::WN + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma(acc[mi][2 * np], af[mi], bf[0], bf[1]);
            mma(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
      __syncthreads();
    }

    // Column sums of the f32 accumulator: this thread's 4 rows per column,
    // then across the 8 row groups of the warp; lane t of row group 0 adds
    // the warp's sums into its own slots (one writer per slot).
    if (stats) {
#pragma unroll
      for (int nj = 0; nj < G::NT; ++nj) {
        float v[4] = {0.f, 0.f, 0.f, 0.f};  // s(2t), s(2t+1), ss(2t), ss(2t+1)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float* c = acc[mi][nj];
          v[0] += c[0] + c[2];
          v[1] += c[1] + c[3];
          v[2] += c[0] * c[0] + c[2] * c[2];
          v[3] += c[1] * c[1] + c[3] * c[3];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
          }
        }
        if (g == 0) {
          const int col = wn * G::WN + nj * 8 + 2 * t;
          s_acc[0][wm][col] += v[0];
          s_acc[0][wm][col + 1] += v[1];
          s_acc[1][wm][col] += v[2];
          s_acc[1][wm][col + 1] += v[3];
        }
      }
    }

    // y: bf16 through shared memory, then 16 bytes a thread.
    bf16* ys = smem;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int nj = 0; nj < G::NT; ++nj) {
        const int r = wm * 32 + mi * 16 + g;
        const int c = wn * G::WN + nj * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(ys + r * G::LDY + c) =
            pack_f32(acc[mi][nj][0], acc[mi][nj][1]);
        *reinterpret_cast<uint32_t*>(ys + (r + 8) * G::LDY + c) =
            pack_f32(acc[mi][nj][2], acc[mi][nj][3]);
      }
    }
    __syncthreads();
    for (int q = tid; q < BM * (BN / 8); q += THREADS) {
      const int r = q / (BN / 8), c = (q % (BN / 8)) * 8;
      const int row = m0 + r, col = n0 + c;
      if (row < p.M && col < p.N) {
        *reinterpret_cast<uint4*>(p.y + (i64)row * p.N + col) =
            *reinterpret_cast<const uint4*>(ys + r * G::LDY + c);
      }
    }
    __syncthreads();
  }

  if (stats) {
    __syncthreads();
    for (int i = tid; i < 2 * BN; i += THREADS) {
      const int which = i / BN, c = i % BN;
      if (n0 + c < p.N) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS_M; ++w) v += s_acc[which][w][c];
        p.part[((i64)which * gridDim.y + blockIdx.y) * p.N + n0 + c] = v;
      }
    }
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

// Launch the GEMM (and, with p.part set, the reduction into stats, (2, N)
// f32: sums then sums of squares) on `st`; `groups` blocks share the M
// tiles of each column tile.  Returns cudaGetLastError().
template <bool CONV>
int launch(const Problem& p, float* stats, int groups, cudaStream_t st) {
  const bool tf = p.scale != nullptr;
  const int bn = p.N <= 64 ? 64 : 128;
  const dim3 grid((p.N + bn - 1) / bn, groups);
  if (bn == 64) {
    if (tf) {
      gemm_stats<CONV, true, 64><<<grid, THREADS, 0, st>>>(p);
    } else {
      gemm_stats<CONV, false, 64><<<grid, THREADS, 0, st>>>(p);
    }
  } else {
    if (tf) {
      gemm_stats<CONV, true, 128><<<grid, THREADS, 0, st>>>(p);
    } else {
      gemm_stats<CONV, false, 128><<<grid, THREADS, 0, st>>>(p);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.part == nullptr) return (int)err;
  reduce_partials<<<dim3((p.N + 31) / 32, 2), dim3(32, 8), 0, st>>>(
      p.part, groups, p.N, stats);
  return (int)cudaGetLastError();
}

}  // namespace fused_gemm
