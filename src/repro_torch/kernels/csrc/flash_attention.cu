// Flash attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the pallas_call at line 92): causal or sliding-window attention with
// a query offset, online softmax in f32,
//
//   o[b,t,h] = sum_s softmax_s(q[b,t,h] . k[b,s,h] / sqrt(D)) v[b,s,h]
//
// over the keys s that the masks keep (causal: s <= q_offset + t;
// window w > 0: s > q_offset + t - w). q is (B, Tq, H, D), k and v are
// (B, Tk, H, D) with GQA already expanded, all contiguous, f32 or bf16;
// the output has q's layout and dtype. Scores, the running max m, the
// running sum l and the accumulator are f32; p stays f32 (as in the
// Pallas kernel, which does not round it to bf16); masked scores are
// NEG_INF = -1e30 and l is floored at 1e-20, as there.
//
// Design. The TPU grid (b*h, q tile, kv tile) runs the kv axis in order
// with (m, l, acc) in VMEM scratch; here one thread block owns one
// (b*h, 64-row q tile) and loops over the 64-key tiles itself, with
// (m, l, acc) in registers. 256 threads as 16 x 16: thread (ty, tx)
// holds query rows 4*ty..4*ty+3, the scores of keys tx + 16*j (j < 4)
// and the output columns tx*D/16 .. +D/16. Per kv tile: K (transposed)
// and V go to shared memory as f32; S = Q K^T by f32 FMAs (Q transposed
// in shared memory, read as float4); the row max and row sum reduce
// over the 16 threads of a row by warp shuffles; P goes to shared
// memory (transposed) and O += P V by f32 FMAs. Tiles wholly above the
// diagonal (causal) or wholly before the window are skipped, which
// leaves (m, l, acc) as the Pallas kernel's masked steps do; a tile
// that is partly outside Tk is masked, so any length works. The q
// tiles with the most kv tiles (the last rows) are scheduled first.
//
// What bounds it. At SmolLM-360M's prefill (B 1, T 2048, H 15, D 64)
// the work is 2*B*H*T^2*D causal multiply-adds counted as operations,
// 8.1 GFLOP: 8 us on the tensor cores, against ~15 MB of q, k, v, o
// (4.7 us at the memory rate), so the bound is operations. This kernel
// does them on the CUDA cores in f32 (67 TFLOP/s peak), reading two
// shared-memory words per two FMAs in the inner loops; tensor cores
// (mma.sync / wgmma on bf16 operands) and a load pipeline are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int RPT = 4;          // query rows per thread
constexpr int CPT = 4;          // keys per thread per tile
constexpr int QS = BQ + 4;      // row stride (floats) of qt and pt
constexpr int KS = BK + 4;      // row stride (floats) of kt
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr int smem_floats() {
  return D * QS + D * KS + BK * D + BK * QS;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Tq, int Tk, int causal, int window, int q_offset,
                       float scale) {
  constexpr int DPT = D / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // [D][QS]  q tile, transposed
  float* kt = qt + D * QS;      // [D][KS]  k tile, transposed
  float* vs = kt + D * KS;      // [BK][D]  v tile
  float* pt = vs + BK * D;      // [BK][QS] p tile, transposed

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t rs = (size_t)H * D;                    // row stride
  const T* qb = q + (size_t)b * Tq * rs + (size_t)h * D;
  const T* kb = k + (size_t)b * Tk * rs + (size_t)h * D;
  const T* vb = v + (size_t)b * Tk * rs + (size_t)h * D;
  T* ob = out + (size_t)b * Tq * rs + (size_t)h * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    qt[d * QS + r] = q0 + r < Tq ? to_f32(qb[(size_t)(q0 + r) * rs + d]) : 0.f;
  }

  // The kv tiles some row of this q tile can see.
  const int pos_first = q_offset + q0;
  const int pos_last = q_offset + min(q0 + BQ, Tq) - 1;
  const int kv_end = causal ? min(Tk, pos_last + 1) : Tk;
  const int kv_begin = window > 0 ? max(0, pos_first - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int t_end = kv_begin < kv_end ? (kv_end + BK - 1) / BK : t_begin;

  float m[RPT], l[RPT], o[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) o[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's kt, vs, pt are consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const bool in = k0 + r < Tk;
      const size_t off = (size_t)(k0 + r) * rs + d;
      kt[d * KS + r] = in ? to_f32(kb[off]) : 0.f;
      vs[r * D + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows 4*ty+i, keys tx+16*j
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qt[d * QS + ty * RPT]);
      const float qr[RPT] = {qv.x, qv.y, qv.z, qv.w};
      float kr[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kr[j] = kt[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    // scale, mask, online softmax; a row's 64 keys live on 16 threads
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q_offset + q0 + ty * RPT + i;
      unsigned keep = 0;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        keep |= (unsigned)ok << j;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = (keep >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < DPT; ++c) o[i][c] *= corr;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      *reinterpret_cast<float4*>(&pt[(tx + 16 * j) * QS + ty * RPT]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // O += P V for rows 4*ty+i, columns tx*DPT+c
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(&pt[kk * QS + ty * RPT]);
      const float pr[RPT] = {pv.x, pv.y, pv.z, pv.w};
      float vr[DPT];
      const float* vrow = &vs[kk * D + tx * DPT];
      if constexpr (DPT % 4 == 0) {
#pragma unroll
        for (int c = 0; c < DPT; c += 4) {
          const float4 w = *reinterpret_cast<const float4*>(vrow + c);
          vr[c] = w.x; vr[c + 1] = w.y; vr[c + 2] = w.z; vr[c + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < DPT; ++c) vr[c] = vrow[c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) o[i][c] = fmaf(pr[i], vr[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    if (r < Tq) {
      const float li = fmaxf(l[i], 1e-20f);
#pragma unroll
      for (int c = 0; c < DPT; ++c)
        store(&ob[(size_t)r * rs + tx * DPT + c], o[i][c] / li);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Tq, int Tk, int causal, int window, int q_offset,
             float scale, void* stream) {
  constexpr int smem = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, Tq, Tk, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Tq, int Tk, int D, int causal, int window,
           int q_offset, float scale, void* stream) {
  switch (D) {
    case 32: return launch_d<T, 32>(q, k, v, out, B, H, Tq, Tk, causal,
                                    window, q_offset, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, out, B, H, Tq, Tk, causal,
                                    window, q_offset, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Tq, H, D), k and v (B, Tk, H, D), out like q; one dtype, all
// contiguous on the device; D in {32, 64}. scale = 1/sqrt(D)
// as an f32. Returns the cudaError_t of the launch.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Tq, int Tk, int D,
                        int causal, int window, int q_offset, float scale,
                        void* stream) {
  return launch<float>(q, k, v, out, B, H, Tq, Tk, D, causal, window,
                       q_offset, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int Tq, int Tk, int D,
                         int causal, int window, int q_offset, float scale,
                         void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, H, Tq, Tk, D, causal,
                               window, q_offset, scale, stream);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
