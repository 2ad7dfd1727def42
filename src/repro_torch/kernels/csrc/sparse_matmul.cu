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
// loop runs inside the block, the accumulator in a register. Each step
// stages one bm x bn weight block and the TM x bm gathered slice of x in
// shared memory; a step's loads go to registers first, all issued
// together, and step l+1's are issued before step l's FMAs. bn need not
// be a power of two (the ResNet-50 classifier has bn = 25): threads
// whose column is >= bn only help load, and every column index is
// checked against bn.
//
// What bounds it. On the main path (the classifier, M = 1) every weight
// byte is used once, so the bound is the surviving blocks' bytes over
// the memory rate. The 40 blocks of the classifier's grid are fewer
// than the card's SMs; with M = 1 the kernel is limited by launch
// latency and by one global-load latency per K step, not by either
// bound. Splitting K across blocks is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 8;         // rows of x per block
constexpr int BM_MAX = 32;
constexpr int BN_MAX = 32;
constexpr int THREADS = TM * BN_MAX;
constexpr int W_LOADS = BM_MAX * BN_MAX / THREADS;   // 4 per thread per step
constexpr int X_LOADS = TM * BM_MAX / THREADS;       // 1 per thread per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sparse_matmul_kernel(const T* __restrict__ x,
                     const __nv_bfloat16* __restrict__ vals,
                     const int32_t* __restrict__ idx, T* __restrict__ out,
                     int M, int d_in, int ob, int K, int bm, int bn) {
  __shared__ float xs[TM * (BM_MAX + 1)];
  __shared__ float ws[BM_MAX * BN_MAX];
  const int j = blockIdx.y;
  const int m0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int col = tid % BN_MAX;
  const int row = tid / BN_MAX;

  // This thread's shared-memory slots, the same at every step (-1:
  // unused), and the row of x each of its x loads reads (-1: past M).
  int w_slot[W_LOADS];
#pragma unroll
  for (int u = 0; u < W_LOADS; ++u) {
    const int e = tid + u * THREADS;
    w_slot[u] = e < bm * bn ? (e / bn) * BN_MAX + e % bn : -1;
  }
  int x_slot[X_LOADS], x_row[X_LOADS], x_c[X_LOADS];
#pragma unroll
  for (int u = 0; u < X_LOADS; ++u) {
    const int e = tid + u * THREADS;
    const int m = e / bm;
    x_slot[u] = e < TM * bm ? m * (BM_MAX + 1) + e % bm : -1;
    x_row[u] = (e < TM * bm && m0 + m < M) ? m0 + m : -1;
    x_c[u] = e % bm;
  }

  // A step's loads go to registers, all issued together; step l+1's are
  // issued before step l's FMAs.
  float wv[W_LOADS], xv[X_LOADS];
  auto load = [&](int l) {
    const int c0 = idx[j * K + l] * bm;
    const __nv_bfloat16* wb = vals + ((size_t)j * K + l) * bm * bn;
#pragma unroll
    for (int u = 0; u < W_LOADS; ++u)
      wv[u] = w_slot[u] >= 0 ? __bfloat162float(wb[tid + u * THREADS]) : 0.f;
#pragma unroll
    for (int u = 0; u < X_LOADS; ++u)
      xv[u] = x_row[u] >= 0
                  ? to_f32(x[(size_t)x_row[u] * d_in + c0 + x_c[u]])
                  : 0.f;
  };

  float acc = 0.f;
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
      for (int c = 0; c < bm; ++c)
        acc = fmaf(xs[row * (BM_MAX + 1) + c], ws[c * BN_MAX + col], acc);
    }
  }
  const int m = m0 + row;
  if (col < bn && m < M) store(&out[(size_t)m * ob * bn + j * bn + col], acc);
}

template <typename T>
int launch(const void* x, const void* vals, const void* idx, void* out,
           int M, int d_in, int ob, int K, int bm, int bn, void* stream) {
  dim3 grid((M + TM - 1) / TM, ob);
  sparse_matmul_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const __nv_bfloat16*)vals, (const int32_t*)idx, (T*)out,
      M, d_in, ob, K, bm, bn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sparse_matmul_max_bm() { return BM_MAX; }
int sparse_matmul_max_bn() { return BN_MAX; }

// x (M, d_in) f32 or bf16; vals (ob,K,bm,bn) bf16; idx (ob,K) int32;
// out (M, ob*bn) in x's dtype; all contiguous on the device. Returns
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
