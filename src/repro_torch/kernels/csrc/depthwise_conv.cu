// Depthwise 2D convolution for Hopper (sm_90a).
//
// Replaces src/repro/kernels/depthwise_conv.py::depthwise_conv_pallas
// (the pallas_call at line 121, body _kernel at lines 91-102):
//
//   y[n,oy,ox,c] = round_bf16(sum_ky (sum_kx x[n, oy*s+ky-pad_h,
//                                             ox*s+kx-pad_w, c] * w[ky,kx,c]))
//
// with SAME padding (pad_lo = total // 2), no bias, and the Pallas
// kernel's order of f32 sums (depthwise.cuh): for each kernel row ky the
// k taps are summed from zero, and that row sum is added to the
// accumulator.
//
// Design. A thread owns 8 channels (one 16-byte vector) of a run of R
// output pixels along one output row; neighbouring threads hold
// neighbouring channel groups, so a warp's loads are contiguous. For
// each kernel row it loads that row's k taps of its 8 channels, then
// walks the (R - 1) * s + k input columns that its R pixels reach, each
// read once, and adds each into the row sums of the pixels whose window
// holds it (a sliding window in registers; kx ascends for every pixel,
// so the sums keep their order). The SAME halo reads zero (no padded
// copy). k (1..7), R (plan: 2 at stride 1, else 1: the best of R = 1, 2,
// 4 at every MobileNet shape in a sweep on the H100, PERF.md; the
// autotuner may pick 4) and the stride
// (1 where R = 2) are template arguments; the index math is 32-bit. k
// past 7 takes one more kernel (depthwise_kernel_rk: one pixel a thread,
// k and the stride at run time, the same order of sums), as the Pallas
// kernel takes any k. C that
// is not a multiple of 8 takes the same kernel with masked scalar loads and
// stores (VEC false). depthwise_conv.plan sizes the blocks so that the
// small layers still launch >= 132 of them.
//
// What bounds it. Per output element it does 2*k*k operations on values
// it reads once from device memory, far below the card's ridge point:
// the bound is the input read once, the taps and the output written once,
// over the memory rate (chip_smoke.py computes it per layer; PERF.md holds
// it). What sets the time at batch 1 is a launch and one round of
// dependent loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "depthwise.cuh"

namespace {

constexpr int K_MAX = 7;   // the largest templated kernel size

// Eight channels from c on at p; zero past C (the masked tail) or where
// !ok (the SAME halo). VEC: one 16-byte aligned vector (C % 8 == 0).
template <bool VEC>
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      int c, int C, bool ok, float (&f)[8]) {
  if constexpr (VEC) {
    const uint4 v = ok ? *reinterpret_cast<const uint4*>(p)
                       : make_uint4(0, 0, 0, 0);
    dw::unpack8(v, f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = ok && c + i < C ? __bfloat162float(p[i]) : 0.f;
  }
}

// S: the stride (0: given at run time, then R = 1); R output pixels a
// thread along a row; VEC: C % 8 == 0 (else the masked scalar tail).
template <int K, int S, int R, bool VEC>
__global__ void __launch_bounds__(256)
depthwise_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ out, int H, int W, int C,
                 int Ho, int Wo, int stride_rt, int pad_h, int pad_w, int G,
                 int WR, int total) {
  static_assert(S > 0 || R == 1, "a run-time stride takes one pixel");
  constexpr int SS = S > 0 ? S : 1;            // column step between pixels
  constexpr int NCOL = (R - 1) * SS + K;       // input columns a kernel row
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int stride = S > 0 ? S : stride_rt;
  const int c = (e % G) * 8;
  const int t = e / G;
  const int ox0 = (t % WR) * R;
  const int row = t / WR;                      // n * Ho + oy
  const int oy = row % Ho, n = row / Ho;
  const int iy0 = oy * stride - pad_h, ix0 = ox0 * stride - pad_w;

  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) dw::zero8(acc[r]);
#pragma unroll
  for (int ky = 0; ky < K; ++ky) {
    const int iy = iy0 + ky;
    float tap[K][8];
#pragma unroll
    for (int kx = 0; kx < K; ++kx)
      load8<VEC>(w + (ky * K + kx) * C + c, c, C, true, tap[kx]);
    float rs[R][8];   // each pixel's sum of this kernel row, from zero
#pragma unroll
    for (int r = 0; r < R; ++r) dw::zero8(rs[r]);
    const __nv_bfloat16* xrow = x + ((n * H + iy) * W) * C + c;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int ix = ix0 + j;
      float xv[8];
      load8<VEC>(xrow + ix * C, c, C, dw::in_image(iy, ix, H, W), xv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int kx = j - r * SS;
        if (kx >= 0 && kx < K) dw::row_mac(rs[r], xv, tap[kx]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) dw::add_row(acc[r], rs[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ox = ox0 + r;
    if (ox >= Wo) break;
    __nv_bfloat16* o = out + (row * Wo + ox) * C + c;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(o) = dw::pack8(acc[r]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c + i < C) o[i] = __float2bfloat16(acc[r][i]);
    }
  }
}

// k past K_MAX: one output pixel's 8 channels a thread, k and the stride
// at run time; per kernel row the k taps from zero, then into the
// accumulator, as depthwise_kernel does.
template <bool VEC>
__global__ void __launch_bounds__(256)
depthwise_kernel_rk(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ out, int H, int W, int C,
                    int Ho, int Wo, int k, int stride, int pad_h, int pad_w,
                    int G, int total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = (e % G) * 8;
  const int t = e / G;
  const int ox = t % Wo;
  const int row = t / Wo;                      // n * Ho + oy
  const int oy = row % Ho, n = row / Ho;
  const int iy0 = oy * stride - pad_h, ix0 = ox * stride - pad_w;

  float acc[8];
  dw::zero8(acc);
  for (int ky = 0; ky < k; ++ky) {
    const int iy = iy0 + ky;
    const __nv_bfloat16* xrow = x + ((n * H + iy) * W) * C + c;
    float rs[8];   // this kernel row's sum, from zero
    dw::zero8(rs);
    for (int kx = 0; kx < k; ++kx) {
      const int ix = ix0 + kx;
      float tap[8], xv[8];
      load8<VEC>(w + (ky * k + kx) * C + c, c, C, true, tap);
      load8<VEC>(xrow + ix * C, c, C, dw::in_image(iy, ix, H, W), xv);
      dw::row_mac(rs, xv, tap);
    }
    dw::add_row(acc, rs);
  }
  __nv_bfloat16* o = out + (row * Wo + ox) * C + c;
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(o) = dw::pack8(acc);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < C) o[i] = __float2bfloat16(acc[i]);
  }
}

struct DwArgs {
  const __nv_bfloat16 *x, *w;
  __nv_bfloat16* out;
  int N, H, W, C, Ho, Wo, stride, pad_h, pad_w;
};

template <int K, int S, int R, bool VEC>
int launch(const DwArgs& a, int threads, cudaStream_t stream) {
  const int G = (a.C + 7) / 8, WR = (a.Wo + R - 1) / R;
  const long long total = (long long)a.N * a.Ho * WR * G;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  depthwise_kernel<K, S, R, VEC><<<blocks, threads, 0, stream>>>(
      a.x, a.w, a.out, a.H, a.W, a.C, a.Ho, a.Wo, a.stride, a.pad_h, a.pad_w,
      G, WR, (int)total);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_rk(const DwArgs& a, int k, int threads, cudaStream_t stream) {
  const int G = (a.C + 7) / 8;
  const long long total = (long long)a.N * a.Ho * a.Wo * G;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  depthwise_kernel_rk<VEC><<<blocks, threads, 0, stream>>>(
      a.x, a.w, a.out, a.H, a.W, a.C, a.Ho, a.Wo, k, a.stride, a.pad_h,
      a.pad_w, G, (int)total);
  return (int)cudaGetLastError();
}

// R = 1 takes any stride, R = 2 and 4 stride 1; C % 8 != 0 takes the
// masked scalar tail, one pixel a thread.
template <int K>
int launch_k(const DwArgs& a, int r, int threads, cudaStream_t s) {
  if (r == 1)
    return a.C % 8 ? launch<K, 0, 1, false>(a, threads, s)
                   : launch<K, 0, 1, true>(a, threads, s);
  if (r == 2 && a.stride == 1 && a.C % 8 == 0)
    return launch<K, 1, 2, true>(a, threads, s);
  if (r == 4 && a.stride == 1 && a.C % 8 == 0)
    return launch<K, 1, 4, true>(a, threads, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// All tensors contiguous on the device: x (N,H,W,C) bf16; w (k,k,C) bf16;
// out (N,Ho,Wo,C) bf16; N*H*W*C and N*Ho*Wo*C < 2^31; k >= 1; where
// C % 8 == 0, x, w and out 16-byte aligned. r: output pixels a thread (1,
// or 2 or 4 at stride 1 where C % 8 == 0 and k <= 7); threads: a block's threads, a
// multiple of 32 up to 256. Anything else returns cudaErrorInvalidValue;
// else cudaGetLastError() after the launch.
int depthwise_conv_bf16(const void* x, const void* w, void* out, int N,
                        int H, int W, int C, int Ho, int Wo, int k,
                        int stride, int pad_h, int pad_w, int r, int threads,
                        void* stream) {
  const DwArgs a = {(const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
                    (__nv_bfloat16*)out, N, H, W, C, Ho, Wo, stride, pad_h,
                    pad_w};
  const cudaStream_t s = (cudaStream_t)stream;
  if (N * Ho * Wo == 0 || C == 0) return 0;
  if (k < 1 || stride < 1 || C < 1 || threads < 32 || threads > 256 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  if (k > K_MAX) {
    if (r != 1) return (int)cudaErrorInvalidValue;
    return C % 8 ? launch_rk<false>(a, k, threads, s)
                 : launch_rk<true>(a, k, threads, s);
  }
  switch (k) {
    case 1: return launch_k<1>(a, r, threads, s);
    case 2: return launch_k<2>(a, r, threads, s);
    case 3: return launch_k<3>(a, r, threads, s);
    case 4: return launch_k<4>(a, r, threads, s);
    case 5: return launch_k<5>(a, r, threads, s);
    case 6: return launch_k<6>(a, r, threads, s);
    default: return launch_k<7>(a, r, threads, s);
  }
}

const char* depthwise_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
