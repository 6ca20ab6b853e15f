// Int8 weight-only matmul for Hopper (sm_90a): out = (x @ W_i8) * scale.
//
// Replaces the Pallas TPU kernel container_engine_accelerators_tpu/
// ops/quant_matmul.py `_kernel` (:31) via `_int8_matmul_pallas` (:122,
// pallas_call :145), entry `int8_weight_matmul` (:77).
//
// What it computes: x (rows, in) bf16 or f32, W (in, out) int8 with a
// per-output-channel f32 scale (out,).  Each weight element is converted
// in registers, products accumulate in f32, and the scale multiplies the
// f32 sum once per output element in the epilogue; the result is cast to
// x's type.  Device memory sees only the int8 weight bytes.
//
// Bound: bytes at decode shapes (rows = the slot count, 16, or 1 for the
// prefill head): the weight stream dominates and is read exactly once.
// Design: a skinny GEMM.  Pass 1 gives each block a 256-column strip of
// W, a slice of the `in` range and a tile of up to 16 rows.  The block
// stages its x slice in shared memory as f32; each of its 8 warps walks
// a share of the slice's weight rows, every thread loading 8 int8
// columns with one 8-byte load (a warp reads 256 contiguous bytes, four
// rows in flight), and keeps a 16 x 8 f32 accumulator in registers.  The
// warps' sums are added row by row in a fixed order through shared
// memory and written as one partial per `in` slice.  Pass 2 adds the partials in slice order,
// applies the scale and casts: deterministic, no atomics.  The number of
// `in` slices is chosen by the caller so that enough blocks are in
// flight to fill the card.  Simple and right first: CUDA-core FMAs, no
// tensor cores, no cp.async pipelining yet.
//
// Plain C interface, bound from Python with ctypes.  Returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;      // rows per block tile
constexpr int kCols = 256;     // columns per block strip (32 lanes x 8)
constexpr int kWarps = 8;      // warps per block
constexpr int kLoads = 4;      // weight rows in flight per warp
static_assert(kWarps * 32 == kCols, "one thread per strip column");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename TX>
__global__ void __launch_bounds__(kWarps * 32)
    qmm_partial(const TX* __restrict__ x, const int8_t* __restrict__ w,
                float* __restrict__ partial, int rows, int in_dim,
                int out_dim, int krange) {
  extern __shared__ float smem[];
  float* xs = smem;                  // (kRows, krange)
  float* red = smem + kRows * krange;  // (kWarps, kCols)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col0 = blockIdx.x * kCols;
  const int k0 = blockIdx.y * krange;
  const int r0 = blockIdx.z * kRows;
  const int kn = min(krange, in_dim - k0);
  const int nr = min(kRows, rows - r0);

  for (int i = tid; i < kRows * krange; i += blockDim.x) {
    const int r = i / krange;
    const int k = i - r * krange;
    xs[i] = (r < nr && k < kn)
                ? to_f(x[(size_t)(r0 + r) * in_dim + k0 + k])
                : 0.f;
  }
  __syncthreads();

  float acc[kRows][8];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }
  const int col = col0 + lane * 8;
  if (col < out_dim) {
    // kLoads weight rows per warp step, all loads issued before any is
    // used, so each warp keeps several 8-byte loads in flight.
    for (int k = warp; k < kn; k += kLoads * kWarps) {
      int2 raw[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int ku = k + u * kWarps;
        raw[u] = ku < kn ? *reinterpret_cast<const int2*>(
                               w + (size_t)(k0 + ku) * out_dim + col)
                         : make_int2(0, 0);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int ku = min(k + u * kWarps, krange - 1);
        float wf[8];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          wf[c] = (float)(int8_t)((raw[u].x >> (8 * c)) & 0xff);
          wf[c + 4] = (float)(int8_t)((raw[u].y >> (8 * c)) & 0xff);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xr = xs[r * krange + ku];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] += xr * wf[c];
        }
      }
    }
  }
  // Cross-warp sum, one row at a time through shared memory: every warp
  // writes its partial row, then thread j adds column j over the warps
  // in warp order (deterministic) and writes this slice's partial.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) red[warp * kCols + lane * 8 + c] = acc[r][c];
    __syncthreads();
    const int c = col0 + tid;
    if (r < nr && c < out_dim) {
      float sum = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) sum += red[wi * kCols + tid];
      partial[((size_t)blockIdx.y * rows + r0 + r) * out_dim + c] = sum;
    }
    __syncthreads();
  }
}

template <typename TX>
__global__ void qmm_finish(const float* __restrict__ partial,
                           const float* __restrict__ scale,
                           TX* __restrict__ out, int rows, int out_dim,
                           int ksplit) {
  const size_t n = (size_t)rows * out_dim;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int ks = 0; ks < ksplit; ++ks) s += partial[(size_t)ks * n + i];
  store(out + i, s * scale[i % out_dim]);
}

template <typename TX>
int launch(const void* x, const void* w, const void* scale, void* partial,
           void* out, int rows, int in_dim, int out_dim, int ksplit,
           int krange, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((out_dim + kCols - 1) / kCols, ksplit, (rows + kRows - 1) / kRows);
  const size_t shm = sizeof(float) * ((size_t)kRows * krange + kWarps * kCols);
  qmm_partial<TX><<<grid, kWarps * 32, shm, s>>>(
      (const TX*)x, (const int8_t*)w, (float*)partial, rows, in_dim, out_dim,
      krange);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t n = (size_t)rows * out_dim;
  qmm_finish<TX><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)partial, (const float*)scale, (TX*)out, rows, out_dim,
      ksplit);
  return (int)cudaGetLastError();
}

}  // namespace

// x_type: 0 = f32, 1 = bf16 (out has x's type).  partial: caller-owned
// f32 scratch of ksplit * rows * out_dim.  Requires out_dim % 8 == 0,
// krange <= 256 and ksplit * krange >= in_dim (the wrapper checks).
// Returns a cudaError_t; -1 for an x type this file does not build.
extern "C" int cea_int8_matmul(const void* x, const void* w,
                               const void* scale, void* partial, void* out,
                               int x_type, int rows, int in_dim, int out_dim,
                               int ksplit, int krange, void* stream) {
  if (x_type == 0)
    return launch<float>(x, w, scale, partial, out, rows, in_dim, out_dim,
                         ksplit, krange, stream);
  if (x_type == 1)
    return launch<__nv_bfloat16>(x, w, scale, partial, out, rows, in_dim,
                                 out_dim, ksplit, krange, stream);
  return -1;
}
