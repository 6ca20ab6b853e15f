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
// the page into an online softmax (running max m, running sum l, f32
// accumulator), and write acc / l cast to q's type.  Masked p is forced
// to exactly 0 after the exp, and a masked lane never touches the
// accumulator, so whatever the null page 0 (or a stale slot) holds
// cannot change one output bit.  The int8 twin multiplies the score by
// the K scale after the contraction and the V operand by the V scale.
//
// Bound: bytes.  The work is one pass over the visible K/V pages and a
// handful of flops per byte.  Design (split pages, "flash decoding"):
// the grid is (row, head, split), each block walking its share of the
// row's pages with one thread per output dimension, so a decode batch of
// b x heads rows still puts several blocks on every SM.  A block reads
// its own block-table entries and mask lanes, skips a page whose lanes
// are all masked (bit-identical to folding it in: alpha = 1 and p = 0),
// computes the page's scores one warp per slot (coalesced reads of a K
// row, shuffle reduction, unrolled so several rows are in flight), and
// accumulates p . V with consecutive threads on consecutive elements of
// a V row.  Each block leaves its running max, sum and accumulator in an
// f32 workspace; a second kernel merges the splits in a fixed order
// (deterministic, no atomics) and writes acc / l.  Simple and right
// first: no cp.async / TMA pipelining yet.
//
// Plain C interface, bound from Python with ctypes.  Returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename TQ, typename TKV, bool QUANT>
__global__ void paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ bt,
    const uint8_t* __restrict__ mask, float* __restrict__ work, int pages,
    int page, int heads, int d, int per_split, float qscale) {
  extern __shared__ float smem[];
  float* q_s = smem;      // (d,)   pre-scaled query
  float* s_s = smem + d;  // (page,) this page's scores
  float* p_s = s_s + page;  // (page,) this page's probabilities

  const int row = blockIdx.x;
  const int head = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int view = pages * page;
  const uint8_t* mrow = mask + (size_t)row * view;

  for (int i = tid; i < d; i += blockDim.x) {
    q_s[i] = to_f(q[((size_t)row * heads + head) * d + i]) * qscale;
  }
  float acc = 0.f;
  float m = -1e30f;
  float l = 0.f;
  __syncthreads();

  const int j_end = min(pages, (split + 1) * per_split);
  for (int j = split * per_split; j < j_end; ++j) {
    int vis = 0;
    for (int t = tid; t < page; t += blockDim.x) vis |= mrow[j * page + t];
    if (!__syncthreads_or(vis)) continue;  // whole page masked: no-op
    const size_t pid = (size_t)bt[(size_t)row * pages + j];

    // Scores: one warp per slot, lanes split d_head; unrolled so a
    // warp has several K rows in flight.
#pragma unroll 4
    for (int t = warp; t < page; t += nwarps) {
      const size_t slot = (pid * page + t) * heads + head;
      const TKV* krow = k_pool + slot * d;
      float dot = 0.f;
      for (int i = lane; i < d; i += 32) dot += q_s[i] * to_f(krow[i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      if (lane == 0) {
        if (QUANT) dot *= k_scale[slot];
        s_s[t] = mrow[j * page + t] ? dot : -1e30f;
      }
    }
    __syncthreads();

    float mp = -1e30f;
    for (int t = 0; t < page; ++t) mp = fmaxf(mp, s_s[t]);
    const float m_new = fmaxf(m, mp);
    const float alpha = expf(m - m_new);
    for (int t = tid; t < page; t += blockDim.x) {
      p_s[t] = mrow[j * page + t] ? expf(s_s[t] - m_new) : 0.f;
    }
    __syncthreads();

    // p . V: one thread per output dimension.  The loads are issued
    // for every slot of the (mapped) page so the unrolled loop keeps
    // several in flight; a p == 0 lane (masked or underflowed) is
    // selected out, never multiplied, so garbage there cannot leak.
    float psum = 0.f;
    float pv = 0.f;
    const int dd = tid < d ? tid : 0;
#pragma unroll 8
    for (int t = 0; t < page; ++t) {
      const float p = p_s[t];
      const size_t slot = (pid * page + t) * heads + head;
      float v = to_f(v_pool[slot * d + dd]);
      if (QUANT) v *= v_scale[slot];
      psum += p;
      pv += (p != 0.f) ? p * v : 0.f;
    }
    l = alpha * l + psum;
    acc = alpha * acc + pv;
    m = m_new;
    __syncthreads();  // s_s / p_s are rewritten by the next page
  }
  // Workspace: acc (b, heads, splits, d), then m and l (b, heads, splits).
  const size_t part = ((size_t)row * heads + head) * splits + split;
  const size_t n_part = (size_t)gridDim.x * heads * splits;
  if (tid < d) work[part * d + tid] = acc;
  if (tid == 0) {
    work[n_part * d + part] = m;
    work[n_part * (d + 1) + part] = l;
  }
}

// Merge the splits of one (row, head) in split order and write acc / l.
// A split that saw no visible lane holds m = -1e30, l = 0, acc = 0 and
// weighs exp(-1e30 - M) = 0.
template <typename TQ>
__global__ void paged_attention_merge(const float* __restrict__ work,
                                      TQ* __restrict__ out, int heads,
                                      int d, int splits) {
  const int row = blockIdx.x;
  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t base = ((size_t)row * heads + head) * splits;
  const size_t n_part = (size_t)gridDim.x * heads * splits;
  const float* wm = work + n_part * d;
  const float* wl = wm + n_part;
  float mx = -1e30f;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, wm[base + s]);
  float l = 0.f;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(wm[base + s] - mx);
    l += w * wl[base + s];
    if (tid < d) acc += w * work[(base + s) * d + tid];
  }
  if (tid < d) {
    store(out + ((size_t)row * heads + head) * d + tid, acc / l);
  }
}

template <typename TQ, typename TKV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* bt, const void* mask, void* out,
           void* work, int b, int pages, int page, int heads, int d,
           int splits, void* stream) {
  const int threads = ((d + 31) / 32) * 32;
  const size_t shm = sizeof(float) * (size_t)(d + 2 * page);
  const int per_split = (pages + splits - 1) / splits;
  cudaStream_t s = (cudaStream_t)stream;
  paged_attention_kernel<TQ, TKV, QUANT>
      <<<dim3(b, heads, splits), threads, shm, s>>>(
          (const TQ*)q, (const TKV*)k, (const TKV*)v, (const float*)ks,
          (const float*)vs, (const int32_t*)bt, (const uint8_t*)mask,
          (float*)work, pages, page, heads, d, per_split,
          1.0f / sqrtf((float)d));
  int err = (int)cudaGetLastError();
  if (err) return err;
  paged_attention_merge<TQ><<<dim3(b, heads), threads, 0, s>>>(
      (const float*)work, (TQ*)out, heads, d, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// q_type: 0 = f32, 1 = bf16.  kv_type: 0 = f32, 1 = bf16, 2 = int8
// (k_scale / v_scale (n_pages, page, heads) f32 required; bf16 q only,
// as the int8 engine's activations are bf16).  work:
// caller-owned f32 scratch of b * heads * splits * (d + 2), with
// splits * ceil(pages / splits) covering no more than one empty split.
// Returns a cudaError_t; -1 for a type pair this file does not build.
extern "C" int cea_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale,
                                   const void* block_tables,
                                   const void* kv_mask, void* out,
                                   void* work, int q_type, int kv_type,
                                   int b, int pages, int page, int heads,
                                   int d, int splits, void* stream) {
  typedef __nv_bfloat16 bf16;
#define CEA_PAGED(TQ, TKV, QUANT)                                        \
  return launch<TQ, TKV, QUANT>(q, k_pool, v_pool, k_scale, v_scale,      \
                                block_tables, kv_mask, out, work, b,      \
                                pages, page, heads, d, splits, stream)
  if (q_type == 0 && kv_type == 0) CEA_PAGED(float, float, false);
  if (q_type == 1 && kv_type == 1) CEA_PAGED(bf16, bf16, false);
  if (q_type == 1 && kv_type == 2) CEA_PAGED(bf16, int8_t, true);
#undef CEA_PAGED
  return -1;
}
