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
// per 2 bytes of y written: under the card's ~295 flops a byte except at
// (12544, 2048, 512) and (50176, 1024, 512), bound by operations by a
// little.  The design (csrc/fused_gemm.cuh) is a streaming kernel: one
// persistent block an SM, a TMA producer that keeps up to 4 stages of A
// and B tiles in flight across tile boundaries, wgmma (SS) consumers,
// the prologue applied once per A tile in shared memory, the statistics
// taken from the f32 accumulator in the epilogue and y written by TMA
// stores under the next tile's products.  Column tiles of one A panel
// run side by side, so A is read from device memory about once.
//
// Plain C interface, bound with ctypes.  The entry point returns 0, a
// cudaError_t, or 100000 + the CUresult of a tensor map it could not
// encode.

#include "fused_gemm.cuh"

// a (m, k) bf16; scale / shift (k,) f32 or both null; b (k, n) bf16; y (m,
// n) bf16; part (2, grid, n) f32 scratch; stats (2, n) f32 (sums, sums of
// squares).  k and n multiples of 8, every pointer 16-byte aligned.  bn
// (64 or 128), the ring depths (1-4 A tiles, 2-4 B tiles) and grid (the
// persistent blocks) come from the wrapper's plan (ops/fused_linear.py
// `plan_matmul`).
extern "C" int cea_fused_matmul(const void* a, const void* scale,
                                const void* shift, const void* b, void* y,
                                void* part, void* stats, int m, int k, int n,
                                int bn, int a_stages, int b_stages, int grid,
                                void* stream) {
  fused_gemm::Geo g = {};
  g.C = k;
  g.W = m;
  g.H = g.NB = 1;
  g.N = n;
  g.taps = 1;
  g.wb = fused_gemm::BM;
  g.r = g.bi = 1;
  g.a_stages = a_stages;
  g.b_stages = b_stages;
  return fused_gemm::launch(a, (const float*)scale, (const float*)shift, b,
                            y, (float*)part, (float*)stats, g, bn, grid,
                            (cudaStream_t)stream);
}
