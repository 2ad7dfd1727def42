// Stored weight types of the port's kernels (sparse_conv, sparse_matmul,
// dw_pw): bf16 (native), int8 codes (with a per-output-channel f32 scale
// that the epilogue, or the caller, applies) and f32. The codes are the
// codes of kernels/_build.WEIGHT_CODES.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wtypes {

constexpr int BF16 = 0;
constexpr int INT8 = 1;
constexpr int F32 = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// The type of the biases (and of dw_pw's depthwise weight) that go with a
// stored weight type: f32 beside f32 weights, bf16 beside bf16 and int8
// (the int8 store keeps 1-D leaves native).
template <typename W>
struct Param {
  using type = __nv_bfloat16;
};
template <>
struct Param<float> {
  using type = float;
};

// Eight int8 codes (8 bytes) as eight bf16 (16 bytes); exact, since
// |code| <= 127.
__device__ __forceinline__ uint4 widen8(uint2 v) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn((float)c[2 * i], (float)c[2 * i + 1]);
  return out;
}

}  // namespace wtypes
