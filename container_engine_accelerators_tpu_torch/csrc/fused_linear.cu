// Fused 1x1-conv matmul with BatchNorm statistics, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel container_engine_accelerators_tpu/ops/
// fused_linear.py `_fused_matmul_kernel` (:65) via `_fused_matmul_call`
// (:109, pallas_call :136), entries `matmul_stats` (:170) and
// `affine_relu_matmul_stats` (:206).
//
// What it computes: y = A' @ B for A (M, K) and B (K, N) bf16, with
// A' = A, or A' = bf16(relu(A * scale + shift)) per input channel in f32
// (the folded BatchNorm of the previous layer, so the normalized
// activation never reaches device memory); the product accumulates in
// f32 and y is stored as bf16; s and ss are the column sums of the f32
// accumulator and of its square, taken before the cast (the producer side
// of the next BatchNorm, so no statistics pass re-reads y).
//
// Bound: bytes.  At ResNet-50's shapes (batch 256) K and N are 64-2048 and
// M 12544-802816, so the product is 2 K flops per 2 bytes of A read and
// per 2 bytes of y written: far under the card's ~295 flops a byte.  The
// design (csrc/fused_gemm.cuh) reads A once per column tile (one tile for
// N <= 128) and writes y once, with the prologue and the statistics in
// registers and shared memory.
//
// Plain C interface, bound with ctypes.  The entry point returns
// cudaGetLastError() after its launches.

#include "fused_gemm.cuh"

// a (m, k) bf16; scale / shift (k,) f32 or both null; b (k, n) bf16; y (m,
// n) bf16; part (2, groups, n) f32 scratch; stats (2, n) f32 (sums, sums of
// squares).  k and n multiples of 8, every pointer 16-byte aligned.
extern "C" int cea_fused_matmul(const void* a, const void* scale,
                                const void* shift, const void* b, void* y,
                                void* part, void* stats, int m, int k, int n,
                                int groups, void* stream) {
  fused_gemm::Problem p;
  p.a = (const fused_gemm::bf16*)a;
  p.scale = (const float*)scale;
  p.shift = (const float*)shift;
  p.b = (const fused_gemm::bf16*)b;
  p.y = (fused_gemm::bf16*)y;
  p.part = (float*)part;
  p.M = m;
  p.K = k;
  p.N = n;
  p.C = p.H = p.W = 0;
  return fused_gemm::launch<false>(p, (float*)stats, groups,
                                   (cudaStream_t)stream);
}
