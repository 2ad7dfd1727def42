// Gathered block-sparse matmul for Hopper (sm_90a).
//
// Replaces src/repro/kernels/sparse_matmul.py::sparse_matmul_pallas (the
// pallas_call at line 68):
//
//   y[m, j*bn:+bn] = sum_k x[m, idx[j,k]*bm:+bm] @ vals[j,k]
//
// with an f32 accumulator and the output in x's dtype; no epilogue.
//
// Design. The TPU kernel runs K as the innermost sequential grid axis
// with a VMEM accumulator; here the grid is (ceil(M/TM), ob) and the K
// loop runs inside the block, the accumulators in registers. Blocks are
// up to 64 x 64 (SmolLM-360M's FFN; the ResNet-50 classifier has
// 32 x 25). 256 threads as 8 row groups x 32 lanes: a thread owns RPT
// rows of x (TM = 8 * RPT rows a block) and the output columns lane and
// lane + 32. Each step stages one bm x bn weight block and the TM x bm
// gathered slice of x (transposed, so a thread reads its rows as
// float4) in shared memory; a step's loads go to registers first, all
// issued together, and step l+1's are issued before step l's FMAs.
// RPT is 1 for M <= 8 (decode, the classifier) and 8 otherwise
// (prefill, M = B*T). bn need not be a power of two: columns >= bn
// only help load, and every column index is checked against bn.
//
// What bounds it. At M = 1..8 every weight byte is used once, so the
// bound is the surviving blocks' bytes over the memory rate, and the
// kernel is limited by launch latency and one global-load latency per
// K step. At prefill (M = 2048) the bound is the multiply-adds on the
// tensor cores; this kernel does them in f32 on the CUDA cores, with
// two shared-memory reads of x (float4) and two of w per 16 FMAs.
// Tensor cores and split-K are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM_MAX = 64;
constexpr int BN_MAX = 64;
constexpr int THREADS = 256;
constexpr int LANES = 32;               // columns lane and lane + 32
constexpr int GROUPS = THREADS / LANES; // 8 row groups
constexpr int W_LOADS = BM_MAX * BN_MAX / THREADS;   // 16 per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int RPT>
__global__ void __launch_bounds__(THREADS)
sparse_matmul_kernel(const T* __restrict__ x,
                     const __nv_bfloat16* __restrict__ vals,
                     const int32_t* __restrict__ idx, T* __restrict__ out,
                     int M, int d_in, int ob, int K, int bm, int bn) {
  constexpr int TM = GROUPS * RPT;
  constexpr int XS = TM + 4;            // row stride of xs (floats)
  constexpr int X_LOADS = (TM * BM_MAX + THREADS - 1) / THREADS;
  __shared__ __align__(16) float xs[BM_MAX * XS];   // [c][m], transposed
  __shared__ float ws[BM_MAX * BN_MAX];             // [c][col]
  const int j = blockIdx.y;
  const int m0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int lane = tid % LANES;
  const int grp = tid / LANES;

  // This thread's shared-memory slots, the same at every step (-1:
  // unused), and the offset in x (without the step's column block) of
  // each of its x loads (-1: past M).
  int w_slot[W_LOADS];
#pragma unroll
  for (int u = 0; u < W_LOADS; ++u) {
    const int e = tid + u * THREADS;
    w_slot[u] = e < bm * bn ? (e / bn) * BN_MAX + e % bn : -1;
  }
  int x_slot[X_LOADS], x_off[X_LOADS];
#pragma unroll
  for (int u = 0; u < X_LOADS; ++u) {
    const int e = tid + u * THREADS;
    const int mm = e / bm, c = e % bm;
    const bool in = e < TM * bm;
    x_slot[u] = in ? c * XS + mm : -1;
    x_off[u] = (in && m0 + mm < M) ? (m0 + mm) * d_in + c : -1;
  }

  float wv[W_LOADS], xv[X_LOADS];
  auto load = [&](int l) {
    const int c0 = idx[j * K + l] * bm;
    const __nv_bfloat16* wb = vals + ((size_t)j * K + l) * bm * bn;
#pragma unroll
    for (int u = 0; u < W_LOADS; ++u)
      wv[u] = w_slot[u] >= 0 ? __bfloat162float(wb[tid + u * THREADS]) : 0.f;
#pragma unroll
    for (int u = 0; u < X_LOADS; ++u)
      xv[u] = x_off[u] >= 0 ? to_f32(x[x_off[u] + c0]) : 0.f;
  };

  float acc[RPT][2];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r][0] = acc[r][1] = 0.f;
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
#pragma unroll 8
    for (int c = 0; c < bm; ++c) {
      float xr[RPT];
      if constexpr (RPT % 4 == 0) {
#pragma unroll
        for (int r = 0; r < RPT; r += 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(&xs[c * XS + grp * RPT + r]);
          xr[r] = t.x; xr[r + 1] = t.y; xr[r + 2] = t.z; xr[r + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < RPT; ++r) xr[r] = xs[c * XS + grp * RPT + r];
      }
      const float w0 = ws[c * BN_MAX + lane];
      const float w1 = ws[c * BN_MAX + lane + LANES];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        acc[r][0] = fmaf(xr[r], w0, acc[r][0]);
        acc[r][1] = fmaf(xr[r], w1, acc[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int m = m0 + grp * RPT + r;
    if (m >= M) continue;
    T* row = out + (size_t)m * ob * bn + (size_t)j * bn;
    if (lane < bn) store(&row[lane], acc[r][0]);
    if (lane + LANES < bn) store(&row[lane + LANES], acc[r][1]);
  }
}

template <typename T, int RPT>
int launch_rpt(const void* x, const void* vals, const void* idx, void* out,
               int M, int d_in, int ob, int K, int bm, int bn,
               void* stream) {
  constexpr int TM = GROUPS * RPT;
  dim3 grid((M + TM - 1) / TM, ob);
  sparse_matmul_kernel<T, RPT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const __nv_bfloat16*)vals, (const int32_t*)idx, (T*)out,
      M, d_in, ob, K, bm, bn);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* vals, const void* idx, void* out,
           int M, int d_in, int ob, int K, int bm, int bn, void* stream) {
  if (M <= GROUPS)
    return launch_rpt<T, 1>(x, vals, idx, out, M, d_in, ob, K, bm, bn,
                            stream);
  return launch_rpt<T, 8>(x, vals, idx, out, M, d_in, ob, K, bm, bn, stream);
}

}  // namespace

extern "C" {

int sparse_matmul_max_bm() { return BM_MAX; }
int sparse_matmul_max_bn() { return BN_MAX; }

// x (M, d_in) f32 or bf16, M * d_in < 2^31; vals (ob,K,bm,bn) bf16,
// bm, bn <= 64; idx (ob,K) int32; out (M, ob*bn) in x's dtype; all
// contiguous on the device. Returns
// cudaGetLastError() after the launch.
int sparse_matmul_f32(const void* x, const void* vals, const void* idx,
                      void* out, int M, int d_in, int ob, int K, int bm,
                      int bn, void* stream) {
  return launch<float>(x, vals, idx, out, M, d_in, ob, K, bm, bn, stream);
}

int sparse_matmul_bf16(const void* x, const void* vals, const void* idx,
                       void* out, int M, int d_in, int ob, int K, int bm,
                       int bn, void* stream) {
  return launch<__nv_bfloat16>(x, vals, idx, out, M, d_in, ob, K, bm, bn,
                               stream);
}

const char* sparse_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
