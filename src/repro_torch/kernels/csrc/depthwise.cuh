// The depthwise arithmetic that depthwise_conv.cu and dw_pw.cu share, as
// the reference's two Pallas kernels share shifted_row_mac
// (src/repro/kernels/depthwise_conv.py:42-55).
//
// The order of f32 sums is the Pallas kernel's: for each kernel row ky the
// k taps of that row are summed from zero (row_mac, kx ascending), and the
// row sum is added to the accumulator (add_row, ky ascending). A product
// of two bf16 values is exact in f32, so fmaf(x, w, row) rounds exactly as
// row + x * w does. A tap in the SAME halo reads zero (in_image).
// Channels travel eight at a time: one 16-byte vector of bf16.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dw {

// Is input pixel (iy, ix) inside an H x W image (else: the SAME halo)?
__device__ __forceinline__ bool in_image(int iy, int ix, int H, int W) {
  return (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
}

// Eight bf16 values (one 16-byte vector) as f32.
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Eight f32 values rounded once to bf16, as one 16-byte vector.
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ void zero8(float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = 0.f;
}

// One tap of a kernel row: row += x * w, channel by channel.
__device__ __forceinline__ void row_mac(float (&row)[8], const float (&x)[8],
                                        const float (&w)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) row[i] = fmaf(x[i], w[i], row[i]);
}

// A finished kernel row into the accumulator.
__device__ __forceinline__ void add_row(float (&acc)[8],
                                        const float (&row)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] += row[i];
}

}  // namespace dw
