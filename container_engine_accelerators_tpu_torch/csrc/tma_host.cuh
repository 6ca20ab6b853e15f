// Host side of TMA, shared by the sources whose kernels fill shared
// memory with cp.async.bulk.tensor (flash_attention.cu, fused_linear.cu,
// fused_conv3x3.cu): the tensor-map encoder, looked up once through the
// runtime so that no library links against libcuda, and a 4-d bf16 map in
// the 128-byte swizzle.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace cea {

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime.  Null
// where it is missing.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      entry = nullptr;
    }
    return (EncodeTiled)entry;
  }();
  return fn;
}

// The map of a bf16 tensor of dims[0..3] elements (innermost first, dims[0]
// contiguous) at byte strides[0..2] of dims 1-3, read or written in boxes
// of box[0..3] elements (box[0] * 2 == 128: one swizzle atom a row).
// Coordinates past the tensor read as zeros and are not written.  Returns
// 0, or 100000 + the CUresult (a code that is not a cudaError_t's).
inline int map_4d(CUtensorMap* map, const void* data,
                  const unsigned long long (&dims)[4],
                  const unsigned long long (&strides)[3],
                  const unsigned (&box)[4]) {
  const EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t s[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t b[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(data), d,
      s, b, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : 100000 + (int)rc;
}

}  // namespace cea
