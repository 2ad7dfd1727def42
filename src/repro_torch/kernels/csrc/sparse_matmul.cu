// Gathered block-sparse matmul for Hopper (sm_90a).
//
// Replaces src/repro/kernels/sparse_matmul.py::sparse_matmul_pallas (the
// pallas_call at line 68):
//
//   y[m, j*bn:+bn] = sum_k x[m, idx[j,k]*bm:+bm] @ vals[j,k]
//
// with an f32 accumulator and the output in x's dtype; no epilogue.
//
// Two variants, chosen in Python (sparse_matmul.variant) and passed in.
// Both run the TPU kernel's sequential K grid axis as a loop inside the
// block, with the accumulators in registers; the grid is (ceil(M/TM),
// ob).
//
// "simt": f32 x (the ResNet-50 classifier), M <= 8 (decode) and bf16
// block shapes the mma variant does not take (bn = 25). Blocks up to
// 64 x 64. 256 threads as 8 row groups x 32 lanes: a thread owns RPT
// rows of x (TM = 8 * RPT rows a block) and the output columns lane and
// lane + 32. Each step stages one bm x bn weight block and the TM x bm
// gathered slice of x (transposed, so a thread reads its rows as
// float4) in shared memory as f32; a step's loads go to registers
// first, all issued together, and step l+1's are issued before step l's
// FMAs. RPT is 1 for M <= 8 and 8 otherwise. bn need not be a power of
// two: columns >= bn only help load, and every column index is checked
// against bn.
//
// "mma": bf16 x with M > 8 (the LM prefill, M = B*T), bm a multiple of
// 16 and bn of 8, both <= 64. A block of 4 warps owns TM = 64 rows (16 a
// warp) and one output block column j. For each surviving block l, a
// 2-stage cp.async ring copies the gathered x slice (TM rows of bm
// contiguous bf16 at column idx[j,l]*bm; rows >= M zero-filled) and
// vals[j,l] (bm x bn, contiguous) into shared memory, rows padded by 8
// elements; step l+1's copies (and its idx) are issued before step l's
// products. A fragments of x come from ldmatrix, B fragments of the
// weight from ldmatrix.trans, and mma.sync.m16n8k16 sums in f32 (bf16 x
// bf16 products are exact in f32: the Pallas kernel's f32 dot of
// upcast operands, up to sum order). The epilogue rounds to bf16, stages
// the tile in shared memory and writes rows < M as 16-byte stores.
//
// What bounds it. At M = 1..8 every weight byte is used once, so the
// bound is the surviving blocks' bytes over the memory rate, and the
// simt variant is limited by launch latency and one global-load
// latency per K step. At SmolLM-360M's prefill (M 2048; w1, w3 vals
// (40, 2, 64, 64), w2 (15, 6, 64, 64)) the bound is bytes too: 4.5 /
// 4.3 us for x, the surviving blocks and y at the memory rate, against
// 0.67 / 0.75 us of multiply-adds on the tensor cores. The mma variant's
// grid there is 32 x 40 = 1280 blocks (w1, w3) and 32 x 15 = 480 (w2):
// TM 128 would leave w2 240 blocks, under two waves of 132 SMs. Each
// block column re-reads its gathered x slices (from L2: x is 3.9 MB), so
// the traffic that moves is L2 -> SM, ob * K * M * bm * 2 bytes a call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int VARIANT_SIMT = 0;   // sparse_matmul.VARIANT_CODES
constexpr int VARIANT_MMA = 1;

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

// ---- mma: bf16 x, M > 8, tensor cores ----------------------------------

constexpr int MMA_TM = 64;               // rows a block, 16 a warp
constexpr int MMA_THREADS = 128;
constexpr int XLD = BM_MAX + 8;          // row strides (elements) in
constexpr int WLD = BN_MAX + 8;          // shared memory

__global__ void __launch_bounds__(MMA_THREADS)
sparse_matmul_mma(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ vals,
                  const int32_t* __restrict__ idx,
                  __nv_bfloat16* __restrict__ out, int M, int d_in, int ob,
                  int K, int bm, int bn) {
  // stage st: the x slice at xs + st * XS, the weight block at ws + st * WS
  constexpr int XS = MMA_TM * XLD, WS = BM_MAX * WLD;
  __shared__ __align__(128) __nv_bfloat16 xs[2 * XS];
  __shared__ __align__(128) __nv_bfloat16 ws[2 * WS];
  const int j = blockIdx.y;
  const int m0 = blockIdx.x * MMA_TM;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int x_chunks = bm / 8, w_chunks = bn / 8;   // 16 B each, a row
  const int n_tiles = bn / 8;

  auto load = [&](int l, int st) {
    const int c0 = idx[j * K + l] * bm;
    const __nv_bfloat16* wb = vals + ((size_t)j * K + l) * bm * bn;
    for (int e = tid; e < MMA_TM * x_chunks; e += MMA_THREADS) {
      const int r = e / x_chunks, c = (e % x_chunks) * 8;
      const bool in = m0 + r < M;
      tc::cp_async16(&xs[st * XS + r * XLD + c],
                     in ? x + (size_t)(m0 + r) * d_in + c0 + c : x, in);
    }
    for (int e = tid; e < bm * w_chunks; e += MMA_THREADS) {
      const int r = e / w_chunks, c = (e % w_chunks) * 8;
      tc::cp_async16(&ws[st * WS + r * WLD + c], wb + r * bn + c, true);
    }
  };

  float acc[BN_MAX / 8][4];
#pragma unroll
  for (int n = 0; n < BN_MAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  if (K > 0) {
    load(0, 0);
    tc::cp_async_commit();
  }
  for (int l = 0; l < K; ++l) {
    const int st = l & 1;
    if (l + 1 < K) {
      load(l + 1, st ^ 1);             // in flight during this step's math
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* xt = xs + st * XS;
    const __nv_bfloat16* wt = ws + st * WS;
#pragma unroll
    for (int kc = 0; kc < BM_MAX / 16; ++kc) {
      if (kc * 16 >= bm) break;
      uint32_t a[4];
      tc::ldmatrix_x4(a, &xt[(warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) *
                                 XLD + kc * 16 + (lane / 16) * 8]);
      const __nv_bfloat16* wrow =
          &wt[(kc * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) * WLD];
#pragma unroll
      for (int np = 0; np < BN_MAX / 16; ++np) {
        if (2 * np + 1 < n_tiles) {      // column tiles 2np and 2np+1
          uint32_t b[4];
          tc::ldmatrix_x4_trans(b, wrow + np * 16 + (lane / 16) * 8);
          tc::mma_bf16(acc[2 * np], a, b[0], b[1]);
          tc::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        } else if (2 * np < n_tiles) {   // the last, odd column tile
          uint32_t b[2];
          tc::ldmatrix_x2_trans(b, wrow + np * 16);
          tc::mma_bf16(acc[2 * np], a, b[0], b[1]);
        }
      }
    }
    __syncthreads();   // stage st is consumed before it is refilled
  }

  // the bf16 tile goes out through shared memory (stage 0's x slice, no
  // longer read) so that each row leaves as whole 16-byte stores
  __nv_bfloat16* tile = xs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
#pragma unroll
    for (int n = 0; n < BN_MAX / 8; ++n)
      if (n < n_tiles)
        *reinterpret_cast<__nv_bfloat162*>(
            &tile[row * XLD + n * 8 + 2 * tg]) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
  __syncthreads();
  for (int e = tid; e < MMA_TM * w_chunks; e += MMA_THREADS) {
    const int r = e / w_chunks, c = (e % w_chunks) * 8;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * ob * bn +
                                (size_t)j * bn + c) =
          *reinterpret_cast<const uint4*>(&tile[r * XLD + c]);
  }
}

// ---- launch --------------------------------------------------------------

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
int launch_simt(const void* x, const void* vals, const void* idx, void* out,
                int M, int d_in, int ob, int K, int bm, int bn,
                void* stream) {
  if (M <= GROUPS)
    return launch_rpt<T, 1>(x, vals, idx, out, M, d_in, ob, K, bm, bn,
                            stream);
  return launch_rpt<T, 8>(x, vals, idx, out, M, d_in, ob, K, bm, bn, stream);
}

int launch_mma(const void* x, const void* vals, const void* idx, void* out,
               int M, int d_in, int ob, int K, int bm, int bn, void* stream) {
  if (bm % 16 || bn % 8 || bm > BM_MAX || bn > BN_MAX)
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + MMA_TM - 1) / MMA_TM, ob);
  sparse_matmul_mma<<<grid, MMA_THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)vals,
      (const int32_t*)idx, (__nv_bfloat16*)out, M, d_in, ob, K, bm, bn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sparse_matmul_max_bm() { return BM_MAX; }
int sparse_matmul_max_bn() { return BN_MAX; }

// x (M, d_in) f32 or bf16, M * d_in < 2^31; vals (ob,K,bm,bn) bf16,
// bm, bn <= 64; idx (ob,K) int32; out (M, ob*bn) in x's dtype; all
// contiguous on the device (16-byte aligned for mma). variant: 0 simt,
// 1 mma (bf16 only; bm % 16 == 0, bn % 8 == 0). Returns
// cudaGetLastError() after the launch.
int sparse_matmul_f32(const void* x, const void* vals, const void* idx,
                      void* out, int M, int d_in, int ob, int K, int bm,
                      int bn, int variant, void* stream) {
  if (variant != VARIANT_SIMT) return (int)cudaErrorInvalidValue;
  return launch_simt<float>(x, vals, idx, out, M, d_in, ob, K, bm, bn,
                            stream);
}

int sparse_matmul_bf16(const void* x, const void* vals, const void* idx,
                       void* out, int M, int d_in, int ob, int K, int bm,
                       int bn, int variant, void* stream) {
  switch (variant) {
    case VARIANT_SIMT:
      return launch_simt<__nv_bfloat16>(x, vals, idx, out, M, d_in, ob, K,
                                        bm, bn, stream);
    case VARIANT_MMA:
      return launch_mma(x, vals, idx, out, M, d_in, ob, K, bm, bn, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* sparse_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
