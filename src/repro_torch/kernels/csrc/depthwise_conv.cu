// Depthwise 2D convolution for Hopper (sm_90a).
//
// Replaces src/repro/kernels/depthwise_conv.py::depthwise_conv_pallas
// (the pallas_call at line 121, body _kernel at lines 91-102):
//
//   y[n,oy,ox,c] = round_bf16(sum_ky (sum_kx x[n, oy*s+ky-pad_h,
//                                             ox*s+kx-pad_w, c] * w[ky,kx,c]))
//
// with SAME padding (pad_lo = total // 2), no bias, and the Pallas
// kernel's order of f32 sums: for each kernel row ky the k taps are
// summed from zero (shifted_row_mac), and that row sum is added to the
// accumulator. The products of bf16 values are exact in f32, so an FMA
// gives the same bits as a multiply and an add.
//
// Design. The kernel is 3x3 (every MobileNet dw node; the wrapper
// refuses another size), unrolled at compile time. One thread per
// (output pixel, channel pair): neighbouring
// threads hold neighbouring NHWC channel pairs, so each tap of a warp
// reads up to 64 neighbouring channels (128 bytes) in one go. The SAME
// halo is decided per tap in the kernel (a tap outside the image adds
// nothing), so no padded copy of the input exists. The taps are read
// from global memory each time (they stay in L1); one bf16x2 store per
// thread.
//
// What bounds it. Per output element it does 2*9 operations on
// values it reads once from device memory (the halo rows are re-read
// from cache), far below the card's ridge point: the bound is the input
// read once, the taps and the output written once, over the memory rate.
// chip_smoke.py computes that bound per layer and PERF.md holds it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 3;   // the kernel size (every MobileNet dw node)
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
depthwise_kernel(const __nv_bfloat162* __restrict__ x,
                 const __nv_bfloat162* __restrict__ w,
                 __nv_bfloat162* __restrict__ out, int N, int H, int W,
                 int C2, int Ho, int Wo, int stride, int pad_h, int pad_w) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long total = (long long)N * Ho * Wo * C2;
  if (e >= total) return;
  const int cp = (int)(e % C2);
  const long long p = e / C2;
  const int ox = (int)(p % Wo);
  const long long t = p / Wo;
  const int oy = (int)(t % Ho);
  const int n = (int)(t / Ho);
  const int iy0 = oy * stride - pad_h, ix0 = ox * stride - pad_w;
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
  for (int ky = 0; ky < K; ++ky) {
    const int iy = iy0 + ky;
    const bool row_ok = iy >= 0 && iy < H;
    float r0 = 0.f, r1 = 0.f;   // this kernel row's sum, from zero
#pragma unroll
    for (int kx = 0; kx < K; ++kx) {
      const int ix = ix0 + kx;
      if (row_ok && ix >= 0 && ix < W) {
        const float2 xv = __bfloat1622float2(
            x[((size_t)(n * H + iy) * W + ix) * C2 + cp]);
        const float2 wv = __bfloat1622float2(w[(ky * K + kx) * C2 + cp]);
        r0 = fmaf(xv.x, wv.x, r0);
        r1 = fmaf(xv.y, wv.y, r1);
      }
    }
    acc0 += r0;
    acc1 += r1;
  }
  out[e] = __floats2bfloat162_rn(acc0, acc1);
}

}  // namespace

extern "C" {

// All tensors contiguous on the device: x (N,H,W,C) bf16; w (3,3,C)
// bf16; out (N,Ho,Wo,C) bf16; C even. Returns cudaGetLastError() after
// the launch.
int depthwise_conv_bf16(const void* x, const void* w, void* out, int N,
                        int H, int W, int C, int Ho, int Wo, int stride,
                        int pad_h, int pad_w, void* stream) {
  const int C2 = C / 2;
  const long long total = (long long)N * Ho * Wo * C2;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (blocks == 0) return 0;
  depthwise_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat162*)x, (const __nv_bfloat162*)w,
      (__nv_bfloat162*)out, N, H, W, C2, Ho, Wo, stride, pad_h, pad_w);
  return (int)cudaGetLastError();
}

const char* depthwise_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
