// Fused softmax cross-entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels container_engine_accelerators_tpu/
// ops/fused_xent.py `_fwd_kernel` (:34, pallas_call :86) and
// `_bwd_kernel` (:46, pallas_call :104), entry `fused_softmax_xent` (:66).
//
// What it computes, per row of logits (rows, C) f32 or bf16 with an int32
// label: forward, loss = lse - x[label] in f32, where lse = log(sum
// exp(x - max)) + max, and the row's lse kept for the backward; backward,
// grad = (exp(x - lse) - onehot(label)) * g in the logits' type.  A label
// outside [0, C) picks 0, as the reference's one-hot compare does.
//
// Bound: bytes.  At the LM head (16384 x 32000 f32) one pass over the
// logits is 2.1 GB: the forward reads them once (0.63 ms at 3.35 TB/s)
// and the backward reads them once and writes the gradient once (1.25 ms).
// Design: one block of 256 threads per row.  The forward is one online
// pass: each thread keeps a running (max, sum of exp) over its strided
// share of the row, 16-byte loads where the row allows, then the block
// merges the pairs in a fixed order (a shuffle tree within each warp, then
// warp 0's partials in warp order) and reads the picked logit by index:
// no softmax, one-hot or padded copy of the logits is made.  The backward
// reads the forward's lse and writes each gradient element once.  The TPU
// kernel's padding of the classes to 128 lanes is not needed here.
//
// Plain C interface, bound with ctypes.  Each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef long long i64;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four consecutive elements (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  x[0] = __low2float(a);
  x[1] = __high2float(a);
  x[2] = __low2float(b);
  x[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float* x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Fold (m2, s2) into the running (m, s): max and sum of exp(x - max).
// An empty side holds (-inf, 0).
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// Grid (rows,).  vec: C % 4 == 0 and the logits 4-element aligned.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    xent_fwd(const T* __restrict__ logits, const int32_t* __restrict__ labels,
             float* __restrict__ loss, float* __restrict__ lse, int c,
             int vec) {
  const int row = blockIdx.x;
  const T* x = logits + (i64)row * c;
  float m = -INFINITY;
  float sum = 0.f;
  if (vec) {
#pragma unroll 4
    for (int i = threadIdx.x * 4; i < c; i += THREADS * 4) {
      float v[4];
      load4(x + i, v);
      const float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
      if (mx > m) {
        sum *= expf(m - mx);
        m = mx;
      }
      sum += expf(v[0] - m) + expf(v[1] - m) + expf(v[2] - m) +
             expf(v[3] - m);
    }
  } else {
    for (int i = threadIdx.x; i < c; i += THREADS) {
      const float v = load1(x + i);
      if (v > m) {
        sum *= expf(m - v);
        m = v;
      }
      sum += expf(v - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(FULL, m, off);
    const float s2 = __shfl_xor_sync(FULL, sum, off);
    merge(m, sum, m2, s2);
  }
  __shared__ float wm[WARPS], ws[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = wm[0];
    sum = ws[0];
    for (int w = 1; w < WARPS; ++w) merge(m, sum, wm[w], ws[w]);
    const float l = logf(sum) + m;
    const int lab = labels[row];
    const float picked = (lab >= 0 && lab < c) ? load1(x + lab) : 0.f;
    loss[row] = l - picked;
    lse[row] = l;
  }
}

// Grid (rows,).  grad may not alias logits.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    xent_bwd(const T* __restrict__ logits, const int32_t* __restrict__ labels,
             const float* __restrict__ lse, const float* __restrict__ g,
             T* __restrict__ grad, int c, int vec) {
  const int row = blockIdx.x;
  const T* x = logits + (i64)row * c;
  T* y = grad + (i64)row * c;
  const float l = lse[row];
  const float gr = g[row];
  const int lab = labels[row];
  if (vec) {
#pragma unroll 4
    for (int i = threadIdx.x * 4; i < c; i += THREADS * 4) {
      float v[4];
      load4(x + i, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = (expf(v[e] - l) - (i + e == lab ? 1.f : 0.f)) * gr;
      }
      store4(y + i, v);
    }
  } else {
    for (int i = threadIdx.x; i < c; i += THREADS) {
      store1(y + i, (expf(load1(x + i) - l) - (i == lab ? 1.f : 0.f)) * gr);
    }
  }
}

}  // namespace

// logits (rows, c) contiguous, type 0 = f32, 1 = bf16; labels (rows,)
// int32; loss and lse (rows,) f32.  Returns a cudaError_t; -1 for a type
// this file does not build.
extern "C" int cea_xent_fwd(const void* logits, const void* labels,
                            void* loss, void* lse, int type, int rows,
                            int c, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (type == 0) {
    xent_fwd<float><<<rows, THREADS, 0, st>>>(
        (const float*)logits, (const int32_t*)labels, (float*)loss,
        (float*)lse, c, vec);
  } else if (type == 1) {
    xent_fwd<bf16><<<rows, THREADS, 0, st>>>(
        (const bf16*)logits, (const int32_t*)labels, (float*)loss,
        (float*)lse, c, vec);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// The same logits and labels; lse from cea_xent_fwd; g (rows,) f32, the
// gradient of each row's loss; grad (rows, c) in the logits' type.
extern "C" int cea_xent_bwd(const void* logits, const void* labels,
                            const void* lse, const void* g, void* grad,
                            int type, int rows, int c, int vec,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (type == 0) {
    xent_bwd<float><<<rows, THREADS, 0, st>>>(
        (const float*)logits, (const int32_t*)labels, (const float*)lse,
        (const float*)g, (float*)grad, c, vec);
  } else if (type == 1) {
    xent_bwd<bf16><<<rows, THREADS, 0, st>>>(
        (const bf16*)logits, (const int32_t*)labels, (const float*)lse,
        (const float*)g, (bf16*)grad, c, vec);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
