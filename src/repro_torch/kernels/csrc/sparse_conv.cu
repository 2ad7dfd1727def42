// Fused implicit-GEMM block-sparse convolution for Hopper (sm_90a).
//
// Replaces src/repro/kernels/sparse_conv.py::sparse_conv_pallas (the
// pallas_call at line 203):
//
//   y[n,oy,ox,j*bn:+bn] = act(sum_l x[n, oy*s+ky_l-pad_h, ox*s+kx_l-pad_w,
//                                      cb_l*bm:+bm] @ vals[j,l] + b + res)
//
// with SAME padding (pad_lo = total // 2), f32 accumulation, and an
// epilogue of bias, optional residual and optional ReLU in f32 followed
// by one round to bf16: the order of sparse_conv.py:116-130.
//
// Design. The TPU kernel walks K as the innermost, sequential grid axis
// and carries a VMEM accumulator between grid steps. Here the grid is
// (ceil(N*Ho*Wo / TM), ob): one block owns TM output pixels of one
// output block column, and the K loop runs inside the block with the
// accumulator in registers. Each step stages one bm x bn weight block
// and the gathered TM x bm input tile in shared memory. The gather
// reads the unpadded NHWC input and writes zero where the tap falls in
// the SAME halo, so neither a padded copy nor an im2col tensor exists.
// The flat block id is decoded into (ky, kx, cb) here, as
// conv_block_coords does. A step's loads go to registers first, all
// issued together, and step l+1's are issued before step l's FMAs.
//
// What bounds it. At batch 1 a ResNet-50 layer does about 2*M*ob*K*bm*bn
// operations on bf16 inputs while moving the activation, the surviving
// blocks and the output once each; the operations per byte stay far
// below the card's ridge point, so the bound is bytes over the memory
// rate (chip_smoke.py computes it per layer, and PERF.md holds it).
// This kernel multiplies in f32 on the CUDA cores (no tensor cores, no
// wgmma, no TMA): each K step still waits on one global-load latency
// and two barriers, so it is limited by latency per step, not by that
// bound. Known weakness: at 7x7 (stage 3) M = 49 fits one TM tile, so a
// stage-3 conv launches only ob blocks (16 for the 3x3 s3b*_c2) on 132
// SMs. Split-K over the K loop and wgmma tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // output pixels per block
constexpr int BM_MAX = 32;    // weight block rows (input channels)
constexpr int BN_MAX = 32;    // weight block columns (output channels)
constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / BN_MAX;   // 8 pixel rows per pass
constexpr int ROWS = TM / ROW_STEP;          // 8 accumulators per thread
constexpr int W_LOADS = BM_MAX * BN_MAX / THREADS;   // 4 per thread per step
constexpr int X_LOADS = TM * BM_MAX / THREADS;       // 8 per thread per step

__global__ void __launch_bounds__(THREADS)
sparse_conv_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ vals,
                   const int32_t* __restrict__ idx,
                   const __nv_bfloat16* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ res,
                   __nv_bfloat16* __restrict__ out,
                   int N, int H, int W, int C, int Ho, int Wo, int k,
                   int stride, int pad_h, int pad_w, int ob, int K, int bm,
                   int bn, int relu) {
  __shared__ float xs[TM * (BM_MAX + 1)];
  __shared__ float ws[BM_MAX * BN_MAX];
  const int j = blockIdx.y;
  const int m0 = blockIdx.x * TM;
  const int M = N * Ho * Wo;
  const int tid = threadIdx.x;
  const int col = tid % BN_MAX;
  const int row = tid / BN_MAX;
  const int cpb = C / bm;   // channel blocks per kernel position

  // What this thread loads is the same at every step but for the tap
  // (ky, kx) and channel block, so its shared-memory slots and its
  // pixels' input origins are worked out once. A slot of -1 is unused;
  // an origin row of INT_MIN/2 marks a pixel past the last one (loads 0).
  int w_slot[W_LOADS];
#pragma unroll
  for (int u = 0; u < W_LOADS; ++u) {
    const int e = tid + u * THREADS;
    w_slot[u] = e < bm * bn ? (e / bn) * BN_MAX + e % bn : -1;
  }
  int x_slot[X_LOADS], x_c[X_LOADS], x_img[X_LOADS], x_iy[X_LOADS],
      x_ix[X_LOADS];
#pragma unroll
  for (int u = 0; u < X_LOADS; ++u) {
    const int e = tid + u * THREADS;
    const int m = e / bm, c = e % bm, p = m0 + m;
    x_slot[u] = e < TM * bm ? m * (BM_MAX + 1) + c : -1;
    x_c[u] = c;
    x_img[u] = 0;
    x_iy[u] = INT_MIN / 2;
    x_ix[u] = 0;
    if (e < TM * bm && p < M) {
      const int ox = p % Wo, t = p / Wo;
      x_img[u] = (t / Ho) * H;
      x_iy[u] = (t % Ho) * stride - pad_h;
      x_ix[u] = ox * stride - pad_w;
    }
  }

  // Step l's loads land in registers: every load of a step is issued
  // before the first is used, and the next step's are issued before
  // this step's FMAs, so their latencies overlap instead of adding up.
  float wv[W_LOADS], xv[X_LOADS];
  auto load = [&](int l) {
    const int blk = idx[j * K + l];
    const int pos = blk / cpb;
    const int ky = pos / k, kx = pos % k;
    const int c0 = (blk % cpb) * bm;
    const __nv_bfloat16* wb = vals + ((size_t)j * K + l) * bm * bn;
#pragma unroll
    for (int u = 0; u < W_LOADS; ++u)
      wv[u] = w_slot[u] >= 0 ? __bfloat162float(wb[tid + u * THREADS]) : 0.f;
#pragma unroll
    for (int u = 0; u < X_LOADS; ++u) {
      const int iy = x_iy[u] + ky, ix = x_ix[u] + kx;
      xv[u] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                  ? __bfloat162float(
                        x[((size_t)(x_img[u] + iy) * W + ix) * C + c0 + x_c[u]])
                  : 0.f;   // the SAME halo, or a pixel past the last
    }
  };

  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;

  if (K > 0) load(0);
  for (int l = 0; l < K; ++l) {
    __syncthreads();   // the previous step's tiles are consumed
#pragma unroll
    for (int u = 0; u < W_LOADS; ++u)
      if (w_slot[u] >= 0) ws[w_slot[u]] = wv[u];
#pragma unroll
    for (int u = 0; u < X_LOADS; ++u)
      if (x_slot[u] >= 0) xs[x_slot[u]] = xv[u];
    __syncthreads();
    if (l + 1 < K) load(l + 1);
    if (col < bn) {
      for (int c = 0; c < bm; ++c) {
        const float w = ws[c * BN_MAX + col];
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          acc[i] = fmaf(xs[(row + i * ROW_STEP) * (BM_MAX + 1) + c], w,
                        acc[i]);
      }
    }
  }

  if (col >= bn) return;
  const int cout = ob * bn;
  const int co = j * bn + col;
  const float b = __bfloat162float(bias[co]);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int p = m0 + row + i * ROW_STEP;
    if (p >= M) continue;
    const size_t o = (size_t)p * cout + co;
    float y = acc[i] + b;
    if (res != nullptr) y += __bfloat162float(res[o]);
    if (relu) y = fmaxf(y, 0.f);
    out[o] = __float2bfloat16(y);
  }
}

}  // namespace

extern "C" {

int sparse_conv_max_bm() { return BM_MAX; }
int sparse_conv_max_bn() { return BN_MAX; }

// All tensors contiguous on the device: x (N,H,W,C) bf16; vals
// (ob,K,bm,bn) bf16; idx (ob,K) int32 flat HWIO block ids; bias
// (ob*bn,) bf16; res (N,Ho,Wo,ob*bn) bf16 or null; out like res.
// Returns cudaGetLastError() after the launch.
int sparse_conv_bf16(const void* x, const void* vals, const void* idx,
                     const void* bias, const void* res, void* out, int N,
                     int H, int W, int C, int Ho, int Wo, int k, int stride,
                     int pad_h, int pad_w, int ob, int K, int bm, int bn,
                     int relu, void* stream) {
  const int M = N * Ho * Wo;
  dim3 grid((M + TM - 1) / TM, ob);
  sparse_conv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)vals,
      (const int32_t*)idx, (const __nv_bfloat16*)bias,
      (const __nv_bfloat16*)res, (__nv_bfloat16*)out, N, H, W, C, Ho, Wo,
      k, stride, pad_h, pad_w, ob, K, bm, bn, relu);
  return (int)cudaGetLastError();
}

const char* sparse_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
