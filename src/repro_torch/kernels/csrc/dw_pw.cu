// Fused depthwise -> pointwise (1x1) convolution for Hopper (sm_90a):
// the MobileNet block body in one pass over device memory.
//
// Replaces src/repro/kernels/dw_pw_fused.py::dw_pw_pallas (the
// pallas_call at line 137, body _kernel at lines 55-92):
//
//   d[p,c]  = round_bf16(act_dw(sum_ky (sum_kx x[p shifted by ky,kx; c]
//                                                * dw_w[ky,kx,c]) + dw_b[c]))
//   y[p,co] = round_bf16(act(sum_c d[p,c] * pw_w[c,co] + pw_b[co] + res[p,co]))
//
// with SAME padding (pad_lo = total // 2) on the depthwise, its sums in
// the Pallas kernel's order (per kernel row ky the k taps from zero,
// then into the accumulator), the bias, ReLU and residual in f32, and
// the dw->pw boundary rounded to bf16 exactly where the unfused graph
// rounds it. The depthwise result d never reaches device memory: that
// is the TPU kernel's contract and this kernel's whole point.
//
// Design. The depthwise is 3x3 (every MobileNet block; the wrapper
// refuses another size), unrolled at compile time. A block owns TM = 64
// output pixels x TN = 64 output channels and walks the input channels
// in chunks of CK = 32. For each chunk it (1) computes the depthwise
// of its 64 pixels x 32 channels from global memory, one channel per
// thread and 8 neighbouring pixels each, one after another, neighbouring
// threads on neighbouring NHWC channels, the SAME halo decided per tap
// in the kernel (no padded copy); adds dw_b, applies ReLU, rounds to
// bf16 and keeps the tile in shared memory; (2) stages the matching
// pw_w[chunk, cout tile] in shared memory; (3) accumulates the tile
// product into 4 x 4 f32 registers per thread. The epilogue adds pw_b,
// the residual and ReLU, and stores bf16 once. Both C and Cout are
// masked: MobileNet-V2 has C = 144 and 960, Cout = 16, 24 and 160.
// All products are of bf16 values, exact in f32, on the CUDA cores.
//
// What bounds it. At batch 1 a block moves x, the weights and y once
// each and does 2*M*C*(k*k + Cout) operations: the bound is bytes over
// the memory rate (chip_smoke.py computes it per layer; PERF.md holds
// it). Known costs of this first design, recorded and not fixed here:
// the depthwise of a pixel tile is recomputed once per Cout tile, up to
// 16 times for MobileNet-V1's 1024 -> 1024 block (9 MACs per element
// against the 64 per element per tile of the pointwise); at 7x7 a layer
// has one pixel tile, so V1's last block launches 16 blocks and V2's
// s6b0 5 on 132 SMs; no tensor cores, no wgmma, no split of C.
//
// Compiled without --use_fast_math: at random init the activations fall
// by orders of magnitude per block, and flushing denormals to zero would
// change the logits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 3;          // the depthwise kernel size (the MobileNets')
constexpr int TM = 64;        // output pixels per block
constexpr int TN = 64;        // output channels per block
constexpr int CK = 32;        // input channels per chunk
constexpr int THREADS = 256;
constexpr int DW_PIX = TM * CK / THREADS;   // 8 depthwise pixels a thread
constexpr int TX = 16;                      // threads across the Cout tile
constexpr int TY = THREADS / TX;            // 16 across the pixel tile
constexpr int RM = TM / TY;                 // 4 pixels a thread
constexpr int RN = TN / TX;                 // 4 output channels a thread
constexpr int W_LOADS = CK * TN / THREADS;  // 8 pw weights a thread a chunk
constexpr int DS_LD = TM + 4;   // row of the depthwise tile, float4-aligned

__global__ void __launch_bounds__(THREADS)
dw_pw_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ dw_w,
             const __nv_bfloat16* __restrict__ dw_b,
             const __nv_bfloat16* __restrict__ pw_w,
             const __nv_bfloat16* __restrict__ pw_b,
             const __nv_bfloat16* __restrict__ res,
             __nv_bfloat16* __restrict__ out, int N, int H, int W, int C,
             int Ho, int Wo, int stride, int pad_h, int pad_w, int Cout,
             int dw_relu, int relu) {
  // the depthwise tile (bf16 values, channel-major) and the pointwise
  // weight tile of one chunk
  __shared__ __align__(16) float ds[CK][DS_LD];
  __shared__ __align__(16) float ws[CK][TN];
  const int M = N * Ho * Wo;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;

  // Depthwise role: channel dc of each chunk, the DW_PIX consecutive
  // pixels from dp on; the first one's coordinates are worked out once
  // and stepped one pixel at a time, with no division in the chunk loop.
  const int dc = tid % CK, dp = (tid / CK) * DW_PIX;
  const int p_first = m0 + dp;
  const int ox_first = p_first % Wo, oy_first = (p_first / Wo) % Ho;
  const int img_first = p_first / Wo / Ho;

  // Pointwise role: pixels ty * RM + i, output channels tx * RN + j.
  const int tx = tid % TX, ty = tid / TX;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    // (1) the depthwise of this chunk, into shared memory: this
    // channel's taps once, then one pixel at a time, so only one
    // pixel's 9 loads are in flight per thread (all 72 at once spill)
    const int c = c0 + dc;
    const bool c_ok = c < C;
    float tap[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t)
      tap[t] = c_ok ? __bfloat162float(dw_w[t * C + c]) : 0.f;
    const float b = c_ok ? __bfloat162float(dw_b[c]) : 0.f;
    int ox = ox_first, oy = oy_first, img = img_first;
#pragma unroll 2
    for (int i = 0; i < DW_PIX; ++i) {
      float d = 0.f;
      if (c_ok && p_first + i < M) {
        const int iy0 = oy * stride - pad_h, ix0 = ox * stride - pad_w;
        const __nv_bfloat16* xi = x + (size_t)img * H * W * C + c;
        float xv[K * K];
#pragma unroll
        for (int ky = 0; ky < K; ++ky)
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            const int iy = iy0 + ky, ix = ix0 + kx;
            xv[ky * K + kx] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                                  ? __bfloat162float(
                                        xi[((size_t)iy * W + ix) * C])
                                  : 0.f;   // the SAME halo
          }
        float sum = 0.f;
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          float row = 0.f;   // this kernel row's sum, from zero
#pragma unroll
          for (int kx = 0; kx < K; ++kx)
            row = fmaf(xv[ky * K + kx], tap[ky * K + kx], row);
          sum += row;
        }
        d = sum + b;
        if (dw_relu) d = fmaxf(d, 0.f);
        d = __bfloat162float(__float2bfloat16(d));   // the dw->pw round
      }
      ds[dc][dp + i] = d;
      if (++ox == Wo) {
        ox = 0;
        if (++oy == Ho) {
          oy = 0;
          ++img;
        }
      }
    }

    // (2) the pointwise weights of this chunk and Cout tile; zero where
    // the chunk or the tile runs past C or Cout
#pragma unroll
    for (int u = 0; u < W_LOADS; ++u) {
      const int e = tid + u * THREADS;
      const int cc = e / TN, nn = e % TN;
      const int ci = c0 + cc, co = n0 + nn;
      ws[cc][nn] = (ci < C && co < Cout)
                       ? __bfloat162float(pw_w[(size_t)ci * Cout + co])
                       : 0.f;
    }
    __syncthreads();

    // (3) the tile product, summed over the chunk in channel order; each
    // step reads 4 pixels and 4 weights as one float4 each
#pragma unroll 8
    for (int cc = 0; cc < CK; ++cc) {
      const float4 a4 = *reinterpret_cast<const float4*>(&ds[cc][ty * RM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&ws[cc][tx * RN]);
      const float a[RM] = {a4.x, a4.y, a4.z, a4.w};
      const float w[RN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();   // the tiles are consumed before the next chunk
  }

  // epilogue: pw bias, residual, ReLU in f32, one bf16 store
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int co = n0 + tx * RN + j;
    if (co >= Cout) continue;
    const float b = __bfloat162float(pw_b[co]);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int p = m0 + ty * RM + i;
      if (p >= M) continue;
      const size_t o = (size_t)p * Cout + co;
      float y = acc[i][j] + b;
      if (res != nullptr) y += __bfloat162float(res[o]);
      if (relu) y = fmaxf(y, 0.f);
      out[o] = __float2bfloat16(y);
    }
  }
}

}  // namespace

extern "C" {

// All tensors contiguous on the device: x (N,H,W,C) bf16; dw_w (3,3,C)
// bf16; dw_b (C,) bf16; pw_w (C,Cout) bf16; pw_b (Cout,) bf16; res
// (N,Ho,Wo,Cout) bf16 or null; out like res. Returns cudaGetLastError()
// after the launch.
int dw_pw_bf16(const void* x, const void* dw_w, const void* dw_b,
               const void* pw_w, const void* pw_b, const void* res,
               void* out, int N, int H, int W, int C, int Ho, int Wo,
               int stride, int pad_h, int pad_w, int Cout, int dw_relu,
               int relu, void* stream) {
  const int M = N * Ho * Wo;
  if (M == 0 || Cout == 0) return 0;
  dim3 grid((M + TM - 1) / TM, (Cout + TN - 1) / TN);
  dw_pw_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dw_w,
      (const __nv_bfloat16*)dw_b, (const __nv_bfloat16*)pw_w,
      (const __nv_bfloat16*)pw_b, (const __nv_bfloat16*)res,
      (__nv_bfloat16*)out, N, H, W, C, Ho, Wo, stride, pad_h, pad_w, Cout,
      dw_relu, relu);
  return (int)cudaGetLastError();
}

const char* dw_pw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
