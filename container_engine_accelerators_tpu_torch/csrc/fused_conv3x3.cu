// 3x3 SAME stride-1 convolution with a BatchNorm prologue and statistics
// epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel container_engine_accelerators_tpu/ops/
// fused_conv3x3.py `_conv_kernel` (:55) via `_conv_call` (:112,
// pallas_call :131), entry `conv3x3_bn_stats` (:166) and its data gradient
// (`_bwd` :196, the same kernel on the rotated, transposed weights).
//
// What it computes: for x (batch, H, W, C) NHWC bf16 and w9 (9, C, C4) bf16
// in tap order tap = (dy + 1) * 3 + (dx + 1),
//   y[n, h, w, :] = sum over taps of z[n, h + dy, w + dx, :] @ w9[tap]
// with f32 accumulation, stored bf16, where z = bf16(relu(x * scale +
// shift)) (or x with no prologue) and z is 0 outside the image: the
// prologue runs on the pixels read and the halo is zero-filled after it,
// as the reference transforms its block and then shifts in zeros.  s and
// ss are the per-channel sums of the f32 output and of its square.
//
// Bound: at ResNet-50's stride-1 shapes (batch 256: 56x56x64, 28x28x128,
// 14x14x256, 7x7x512) each conv is 2 * 9 * C * C4 * pixels = 59 GFLOP
// (0.06 ms at 989 TFLOP/s) against 103-205 MB of x and y (0.03-0.06 ms):
// the first shape is balanced, the deeper ones bound by operations.  The
// design is an implicit GEMM (csrc/fused_gemm.cuh): rows are output
// pixels, K walks the 9 taps x C, and each A chunk is read straight from
// the shifted input with a predicated cp.async, so no padded or im2col
// copy is made.
//
// Plain C interface, bound with ctypes.  The entry point returns
// cudaGetLastError() after its launches.

#include "fused_gemm.cuh"

// x (n, h, w, c) bf16; scale / shift (c,) f32 or both null; w9 (9, c, c4)
// bf16; y (n, h, w, c4) bf16; part (2, groups, c4) f32 scratch and stats
// (2, c4) f32, or both null to skip the statistics.  c and c4 multiples of
// 8, every pointer 16-byte aligned.
extern "C" int cea_conv3x3(const void* x, const void* scale,
                           const void* shift, const void* w9, void* y,
                           void* part, void* stats, int n, int h, int w,
                           int c, int c4, int groups, void* stream) {
  fused_gemm::Problem p;
  p.a = (const fused_gemm::bf16*)x;
  p.scale = (const float*)scale;
  p.shift = (const float*)shift;
  p.b = (const fused_gemm::bf16*)w9;
  p.y = (fused_gemm::bf16*)y;
  p.part = (float*)part;
  p.M = n * h * w;
  p.K = 9 * c;
  p.N = c4;
  p.C = c;
  p.H = h;
  p.W = w;
  return fused_gemm::launch<true>(p, (float*)stats, groups,
                                  (cudaStream_t)stream);
}
