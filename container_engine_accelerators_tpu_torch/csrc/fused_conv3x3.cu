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
// design is an implicit GEMM on wgmma (csrc/fused_gemm.cuh): a tile is a
// box of up to 128 output pixels (w x h x images, chosen to fill tiles);
// for each 64-channel chunk TMA copies the box with a one-pixel halo
// once (zeros outside the image), the prologue runs on it once in shared
// memory, and the nine taps gather their rows from it through ldmatrix
// into wgmma RS while the taps' (64 x C4 tile) weight slices stream
// through a second ring.  No padded or im2col copy is made, and x is
// read about (wb + 2)(r + 2) / (wb r) times, not nine.
//
// Plain C interface, bound with ctypes.  The entry point returns 0, a
// cudaError_t, or 100000 + the CUresult of a tensor map it could not
// encode.

#include "fused_gemm.cuh"

// x (n, h, w, c) bf16; scale / shift (c,) f32 or both null; w9 (9, c, c4)
// bf16; y (n, h, w, c4) bf16; part (2, grid, c4) f32 scratch and stats
// (2, c4) f32, or both null to skip the statistics.  c and c4 multiples of
// 8, every pointer 16-byte aligned.  The tile box (wb, r, bi: pixels along
// w, rows, images), bn, the ring depths and grid come from the wrapper's
// plan (ops/fused_conv3x3.py `plan_conv`).
extern "C" int cea_conv3x3(const void* x, const void* scale,
                           const void* shift, const void* w9, void* y,
                           void* part, void* stats, int n, int h, int w,
                           int c, int c4, int wb, int r, int bi, int bn,
                           int a_stages, int b_stages, int grid,
                           void* stream) {
  fused_gemm::Geo g = {};
  g.C = c;
  g.W = w;
  g.H = h;
  g.NB = n;
  g.N = c4;
  g.taps = 9;
  g.wb = wb;
  g.r = r;
  g.bi = bi;
  g.a_stages = a_stages;
  g.b_stages = b_stages;
  return fused_gemm::launch(x, (const float*)scale, (const float*)shift, w9,
                            y, (float*)part, (float*)stats, g, bn, grid,
                            (cudaStream_t)stream);
}
