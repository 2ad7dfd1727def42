// Gathered block-sparse matmul for Hopper (sm_90a).
//
// Replaces src/repro/kernels/sparse_matmul.py::sparse_matmul_pallas (the
// pallas_call at line 68):
//
//   y[m, j*bn:+bn] = sum_k x[m, idx[j,k]*bm:+bm] @ vals[j,k]
//
// with an f32 accumulator and the output in x's dtype; no epilogue.
// Stored weights (a template argument, weights.cuh): bf16 (every
// variant), int8 codes (gemv, simt; the caller multiplies the output by
// the per-channel scale, as the reference does outside its Pallas
// kernel) or f32 (simt).
//
// Three variants, chosen in Python (sparse_matmul.variant) and passed in.
// The TPU kernel's sequential K grid axis becomes a loop inside a block
// (simt, mma) or rows spread over a block's threads (gemv).
//
// "gemv": M <= 8 (the ResNet-50 classifier in f32, the LM decode in
// bf16), any blocks. Column j's surviving blocks, vals[j],
// are one contiguous (K*bm) x bn matrix. A block of 64, 128 or 256
// threads (about one per two rows) owns 8 of its output columns (grid
// (ceil(bn/8), ob): 160 blocks for the classifier, 320 and 120 for
// SmolLM-360M's w1 and w2) and every row: thread t takes rows t,
// t + THREADS, ..., loading each row's 8 columns as one 16-byte vector
// (8 bytes for int8 codes; bn % 8 == 0; element by element otherwise, as
// for the classifier's bn = 25 and 125) and the gathered x values (idx,
// then x) into registers, every load issued before the first FMA; M
// rounded up to 1, 2, 4 or 8 is a template argument, so a thread holds
// that many x 8 sums. The f32 partials are summed over each warp's lanes
// by an xor butterfly, then over the warps in order: one barrier, no
// reduction across blocks, deterministic.
//
// "simt" and "mma" take blocks of any size, walked as SUB x SUB (64 x 64)
// pieces (SubBlocks), the last piece of a side that is no multiple of 64
// ragged. A thread block owns one column piece, min(64, bn - n0) columns
// n0.. of one block column (grid y = ob * ceil(bn / 64)), and its steps
// walk each surviving block's ceil(bm / 64) row pieces, so shared memory
// and registers stay those of a 64 x 64 block and the gathered x rows are
// read once per column piece.
//
// "simt": M > 8 with f32 x, f32 weights, or a block side the mma variant
// does not take (the classifier's 125 at SparsityConfig's default).
// 256 threads as 8 row groups x 32 lanes: a thread owns RPT = 8
// rows of x (TM = 64 rows a block) and the output columns lane and
// lane + 32; grid (ceil(M/64), ob * ceil(bn / 64)). Each step stages one
// weight piece and the TM x rows gathered slice of x
// (transposed, so a thread reads its rows as float4) in shared memory as
// f32, zero past a ragged piece's rows and columns; a step's loads go to
// registers first, all issued together, and step l+1's are issued before
// step l's FMAs. Every row and column index is checked against the
// piece's.
//
// "mma": bf16 x and weights with M > 8 (the LM prefill, M = B*T), bm and
// bn multiples of 8. A block of 4 warps owns TM = 64 rows (16 a warp) and
// one column piece of one output block column j. For each step (a row
// piece of surviving block l), a 2-stage cp.async ring copies the
// gathered x slice (TM rows of the piece's contiguous bf16 at column
// idx[j,l]*bm + rb; rows >= M zero-filled) and the piece of vals[j,l]
// into shared memory, rows padded by 8 elements; a piece of 8 rows past a
// multiple of 16 (bm % 16 == 8) is zero-filled to the next 16 in both,
// so the 16-deep products add nothing for it; step s+1's copies (and its
// idx) are issued before step s's
// products. A fragments of x come from ldmatrix, B fragments of the
// weight from ldmatrix.trans, and mma.sync.m16n8k16 sums in f32 (bf16 x
// bf16 products are exact in f32: the Pallas kernel's f32 dot of
// upcast operands, up to sum order). The epilogue rounds to bf16, stages
// the tile in shared memory and writes rows < M as 16-byte stores.
//
// What bounds it. At M = 1..8 every weight byte is used once, so the
// bound is the surviving blocks' bytes over the memory rate (0.2 us at
// the classifier's and SmolLM-360M's decode shapes); what costs is
// latency: a launch, a dependent idx -> x load, one reduction. At
// SmolLM-360M's prefill (M 2048; w1, w3 vals (40, 2, 64, 64), w2 (15, 6,
// 64, 64)) the bound is bytes too: 4.5 / 4.3 us for x, the surviving
// blocks and y at the memory rate, against 0.67 / 0.75 us of
// multiply-adds on the tensor cores. The mma variant's grid there is 32
// x 40 = 1280 blocks (w1, w3) and 32 x 15 = 480 (w2): TM 128 would
// leave w2 240 blocks, under two waves of 132 SMs. Each block column
// re-reads its gathered x slices (from L2: x is 3.9 MB), so the traffic
// that moves is L2 -> SM, ob * K * M * bm * 2 bytes a call. The large
// dense LMs' 128 x 128 blocks (Qwen3-32B: w1, w3 vals (200, 6, 128,
// 128), w2 (40, 30, 128, 128)) hold 39.3 MB a weight: 11.7 us at the
// memory rate, the bound of a decode step's product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "weights.cuh"

namespace {

constexpr int VARIANT_SIMT = 0;   // the codes of _build.VARIANT_CODES
constexpr int VARIANT_MMA = 1;
constexpr int VARIANT_GEMV = 2;

constexpr int SUB = 64;                 // simt and mma: the piece a
                                        // step stages at most
constexpr int THREADS = 256;
constexpr int LANES = 32;               // columns lane and lane + 32
constexpr int GROUPS = THREADS / LANES; // 8 row groups
constexpr int W_LOADS = SUB * SUB / THREADS;   // 16 per thread

using wtypes::to_f32;

// The pieces of a block side: ceil(side / SUB).
__host__ __device__ constexpr int pieces(int side) {
  return (side + SUB - 1) / SUB;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// A block of the simt and mma variants owns the cols = min(SUB, bn - n0)
// output columns n0.. of block column j; its steps walk the K surviving
// blocks and, in each, the n_m = ceil(bm / SUB) row pieces: step s stages
// rows rb.. of block l, rows(s) of them. sbm and sbn are a full piece's
// sides, min(bm, SUB) and min(bn, SUB).
struct SubBlocks {
  int bm, sbm, sbn, n_m, j, n0, cols;
  __device__ SubBlocks(int bm_, int bn) : bm(bm_) {
    sbm = min(bm, SUB);
    sbn = min(bn, SUB);
    n_m = pieces(bm);
    const int n_n = pieces(bn);
    j = blockIdx.y / n_n;
    n0 = (blockIdx.y % n_n) * SUB;
    cols = min(SUB, bn - n0);
  }
  __device__ int rb(int step) const { return (step % n_m) * SUB; }
  __device__ int rows(int step) const { return min(SUB, bm - rb(step)); }
};

template <typename T, typename WT>
__global__ void __launch_bounds__(THREADS)
sparse_matmul_simt(const T* __restrict__ x,
                     const WT* __restrict__ vals,
                     const int32_t* __restrict__ idx, T* __restrict__ out,
                     int M, int d_in, int ob, int K, int bm, int bn) {
  constexpr int RPT = 8;                // rows a thread
  constexpr int TM = GROUPS * RPT;
  constexpr int XS = TM + 4;            // row stride of xs (floats)
  constexpr int X_LOADS = (TM * SUB + THREADS - 1) / THREADS;
  __shared__ __align__(16) float xs[SUB * XS];   // [c][m], transposed
  __shared__ float ws[SUB * SUB];                // [c][col]
  const SubBlocks sb(bm, bn);
  const int j = sb.j, sbm = sb.sbm, sbn = sb.sbn;
  const int m0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int lane = tid % LANES;
  const int grp = tid / LANES;

  // This thread's shared-memory slots, the same at every step (-1:
  // unused), the offset in the sub-block of each of its weight loads,
  // and the offset in x (without the step's columns) of each of its x
  // loads (-1: past M).
  int w_slot[W_LOADS], w_r[W_LOADS], w_c[W_LOADS];
#pragma unroll
  for (int u = 0; u < W_LOADS; ++u) {
    const int e = tid + u * THREADS;
    w_r[u] = e / sbn;
    w_c[u] = e % sbn;
    w_slot[u] = e < sbm * sbn ? w_r[u] * SUB + w_c[u] : -1;
  }
  int x_slot[X_LOADS], x_off[X_LOADS], x_c[X_LOADS];
#pragma unroll
  for (int u = 0; u < X_LOADS; ++u) {
    const int e = tid + u * THREADS;
    const int mm = e / sbm, c = e % sbm;
    const bool in = e < TM * sbm;
    x_slot[u] = in ? c * XS + mm : -1;
    x_off[u] = (in && m0 + mm < M) ? (m0 + mm) * d_in + c : -1;
    x_c[u] = c;
  }

  // a ragged piece loads zero past its rows and columns
  float wv[W_LOADS], xv[X_LOADS];
  auto load = [&](int step) {
    const int l = step / sb.n_m, rb = sb.rb(step), rows = sb.rows(step);
    const int c0 = idx[j * K + l] * bm + rb;
    const WT* wb = vals + ((size_t)j * K + l) * bm * bn + (size_t)rb * bn +
                   sb.n0;
#pragma unroll
    for (int u = 0; u < W_LOADS; ++u)
      wv[u] = w_slot[u] >= 0 && w_r[u] < rows && w_c[u] < sb.cols
                  ? to_f32(wb[w_r[u] * bn + w_c[u]])
                  : 0.f;
#pragma unroll
    for (int u = 0; u < X_LOADS; ++u)
      xv[u] = x_off[u] >= 0 && x_c[u] < rows ? to_f32(x[x_off[u] + c0])
                                             : 0.f;
  };

  float acc[RPT][2];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r][0] = acc[r][1] = 0.f;
  const int steps = K * sb.n_m;
  if (steps > 0) load(0);
  for (int step = 0; step < steps; ++step) {
    __syncthreads();   // the previous step's tiles are consumed
#pragma unroll
    for (int u = 0; u < W_LOADS; ++u)
      if (w_slot[u] >= 0) ws[w_slot[u]] = wv[u];
#pragma unroll
    for (int u = 0; u < X_LOADS; ++u)
      if (x_slot[u] >= 0) xs[x_slot[u]] = xv[u];
    __syncthreads();
    if (step + 1 < steps) load(step + 1);
    const int rows = sb.rows(step);
#pragma unroll 8
    for (int c = 0; c < rows; ++c) {
      float xr[RPT];
#pragma unroll
      for (int r = 0; r < RPT; r += 4) {
        const float4 t =
            *reinterpret_cast<const float4*>(&xs[c * XS + grp * RPT + r]);
        xr[r] = t.x; xr[r + 1] = t.y; xr[r + 2] = t.z; xr[r + 3] = t.w;
      }
      const float w0 = ws[c * SUB + lane];
      const float w1 = ws[c * SUB + lane + LANES];
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
    T* row = out + (size_t)m * ob * bn + (size_t)j * bn + sb.n0;
    if (lane < sb.cols) store(&row[lane], acc[r][0]);
    if (lane + LANES < sb.cols) store(&row[lane + LANES], acc[r][1]);
  }
}

// ---- mma: bf16 x, M > 8, tensor cores ----------------------------------

constexpr int MMA_TM = 64;               // rows a block, 16 a warp
constexpr int MMA_THREADS = 128;
constexpr int XLD = SUB + 8;             // row strides (elements) in
constexpr int WLD = SUB + 8;             // shared memory

// REG: every piece whole, its rows a multiple of 16 (sides of at most 64
// or multiples of 64, bm % 16 == 0: every LM's blocks), so a step stages
// its full piece with no row predicate, as before blocks had ragged
// pieces; else the rows of each step are worked out and masked.
template <bool REG>
__global__ void __launch_bounds__(MMA_THREADS)
sparse_matmul_mma(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ vals,
                  const int32_t* __restrict__ idx,
                  __nv_bfloat16* __restrict__ out, int M, int d_in, int ob,
                  int K, int bm, int bn) {
  // stage st: the x slice at xs + st * XS, the weight block at ws + st * WS
  constexpr int XS = MMA_TM * XLD, WS = SUB * WLD;
  __shared__ __align__(128) __nv_bfloat16 xs[2 * XS];
  __shared__ __align__(128) __nv_bfloat16 ws[2 * WS];
  const SubBlocks sb(bm, bn);
  const int j = sb.j;
  const int m0 = blockIdx.x * MMA_TM;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int w_chunks = sb.cols / 8;      // 16 B each, a row
  const int n_tiles = sb.cols / 8;

  // a step's rows rounded up to 16 are staged, those past its rows (bm %
  // 16 == 8) zero-filled
  auto load = [&](int step, int st) {
    const int l = step / sb.n_m, rb = sb.rb(step);
    const int rows = REG ? sb.sbm : sb.rows(step);
    const int x_chunks = REG ? sb.sbm / 8 : (rows + 15) / 16 * 2;
    const int c0 = idx[j * K + l] * bm + rb;
    const __nv_bfloat16* wb = vals + ((size_t)j * K + l) * bm * bn +
                              (size_t)rb * bn + sb.n0;
    for (int e = tid; e < MMA_TM * x_chunks; e += MMA_THREADS) {
      const int r = e / x_chunks, c = (e % x_chunks) * 8;
      const bool in = m0 + r < M && (REG || c < rows);
      tc::cp_async16(&xs[st * XS + r * XLD + c],
                     in ? x + (size_t)(m0 + r) * d_in + c0 + c : x, in);
    }
    for (int e = tid; e < x_chunks * 8 * w_chunks; e += MMA_THREADS) {
      const int r = e / w_chunks, c = (e % w_chunks) * 8;
      const bool in = REG || r < rows;
      tc::cp_async16(&ws[st * WS + r * WLD + c], in ? wb + r * bn + c : wb,
                     in);
    }
  };

  float acc[SUB / 8][4];
#pragma unroll
  for (int n = 0; n < SUB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int steps = K * sb.n_m;
  if (steps > 0) {
    load(0, 0);
    tc::cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    const int st = step & 1;
    if (step + 1 < steps) {
      load(step + 1, st ^ 1);          // in flight during this step's math
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* xt = xs + st * XS;
    const __nv_bfloat16* wt = ws + st * WS;
    const int rows = REG ? sb.sbm : sb.rows(step);
#pragma unroll
    for (int kc = 0; kc < SUB / 16; ++kc) {
      if (kc * 16 >= rows) break;
      uint32_t a[4];
      tc::ldmatrix_x4(a, &xt[(warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) *
                                 XLD + kc * 16 + (lane / 16) * 8]);
      const __nv_bfloat16* wrow =
          &wt[(kc * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) * WLD];
#pragma unroll
      for (int np = 0; np < SUB / 16; ++np) {
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
    for (int n = 0; n < SUB / 8; ++n)
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
                                (size_t)j * bn + sb.n0 + c) =
          *reinterpret_cast<const uint4*>(&tile[r * XLD + c]);
  }
}

// ---- gemv: M <= 8, every load in flight, no cross-block reduction -------

constexpr int GEMV_COLS = 8;            // output columns a block

// A weight row's 8 columns as one vector load: 16 bytes of bf16, 8 bytes
// of int8 codes; widened to f32 before the FMAs.
template <typename WT>
struct Row8;
template <>
struct Row8<__nv_bfloat16> {
  using vec = uint4;
  __device__ static void widen(const uint4& v, float (&w)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      w[2 * i] = f.x;
      w[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Row8<int8_t> {
  using vec = uint2;
  __device__ static void widen(const uint2& v, float (&w)[8]) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = (float)c[i];
  }
};

// MT: M rounded up to 1, 2, 4 or 8 (x rows >= M load nothing);
// THREADS: 64, 128 or 256, about one thread per two weight rows
template <typename T, typename WT, int MT, int THREADS>
__global__ void __launch_bounds__(THREADS)
sparse_matmul_gemv(const T* __restrict__ x,
                   const WT* __restrict__ vals,
                   const int32_t* __restrict__ idx, T* __restrict__ out,
                   int M, int d_in, int ob, int K, int bm, int bn,
                   int vec) {
  constexpr int RB = THREADS >= 256 ? 2 : 4;   // rows a thread a round
  __shared__ float red[THREADS / 32][MT * GEMV_COLS];
  const int j = blockIdx.y;
  const int c0 = blockIdx.x * GEMV_COLS;
  const int nc = min(GEMV_COLS, bn - c0);  // this block's columns
  const int rows = K * bm;                  // column j's weight rows
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const WT* wj = vals + (size_t)j * rows * bn + c0;
  using V = typename Row8<WT>::vec;
  const int32_t* ij = idx + (size_t)j * K;

  float acc[MT][GEMV_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) acc[m][c] = 0.f;
  // thread t takes rows t, t + THREADS, ...: a round's loads (its rows'
  // 8 weight columns, then idx and the gathered x) are all issued before
  // its first FMA; at the classifier's and SmolLM-360M's shapes one
  // round holds every row
  for (int r0 = 0; r0 < rows; r0 += THREADS * RB) {
    V wv[RB];
    float xv[RB][MT];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const int R = r0 + tid + u * THREADS;
      wv[u] = V{};
      if (R >= rows) continue;
      const WT* wr = wj + (size_t)R * bn;
      if (vec) {
        wv[u] = *reinterpret_cast<const V*>(wr);
      } else {
        WT* e = reinterpret_cast<WT*>(&wv[u]);
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c)
          if (c < nc) e[c] = wr[c];
      }
    }
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const int R = r0 + tid + u * THREADS;
      const int col = R < rows ? ij[R / bm] * bm + R % bm : 0;
#pragma unroll
      for (int m = 0; m < MT; ++m)
        xv[u][m] = R < rows && m < M ? to_f32(x[(size_t)m * d_in + col])
                                     : 0.f;
    }
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      float w[GEMV_COLS];
      Row8<WT>::widen(wv[u], w);
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          acc[m][c] = fmaf(xv[u][m], w[c], acc[m][c]);
    }
  }

  // the threads' partials, summed in a fixed order: over a warp's lanes
  // by an xor butterfly (lane 0's sums are used), then over the warps in
  // order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) {
      float v = acc[m][c];
#pragma unroll
      for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][m * GEMV_COLS + c] = v;
    }
  __syncthreads();
  if (tid < M * GEMV_COLS && tid % GEMV_COLS < nc) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w][tid];
    store(&out[(size_t)(tid / GEMV_COLS) * ob * bn + (size_t)j * bn + c0 +
               tid % GEMV_COLS],
          s);
  }
}

// ---- launch --------------------------------------------------------------

template <typename T, typename WT>
int launch_simt(const void* x, const void* vals, const void* idx, void* out,
                int M, int d_in, int ob, int K, int bm, int bn,
                cudaStream_t stream) {
  if (bm < 1 || bn < 1 || (size_t)ob * pieces(bn) > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + GROUPS * 8 - 1) / (GROUPS * 8), ob * pieces(bn));
  sparse_matmul_simt<T, WT><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const WT*)vals, (const int32_t*)idx, (T*)out, M, d_in,
      ob, K, bm, bn);
  return (int)cudaGetLastError();
}

template <typename T, typename WT, int MT, int THREADS>
int launch_gemv_mt(const void* x, const void* vals, const void* idx,
                   void* out, int M, int d_in, int ob, int K, int bm, int bn,
                   int vec, cudaStream_t stream) {
  dim3 grid((bn + GEMV_COLS - 1) / GEMV_COLS, ob);
  sparse_matmul_gemv<T, WT, MT, THREADS><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const WT*)vals, (const int32_t*)idx, (T*)out, M, d_in,
      ob, K, bm, bn, vec);
  return (int)cudaGetLastError();
}

template <typename T, typename WT, int THREADS>
int launch_gemv_t(const void* x, const void* vals, const void* idx,
                  void* out, int M, int d_in, int ob, int K, int bm, int bn,
                  int vec, cudaStream_t stream) {
  if (M <= 1)
    return launch_gemv_mt<T, WT, 1, THREADS>(x, vals, idx, out, M, d_in, ob,
                                             K, bm, bn, vec, stream);
  if (M <= 2)
    return launch_gemv_mt<T, WT, 2, THREADS>(x, vals, idx, out, M, d_in, ob,
                                             K, bm, bn, vec, stream);
  if (M <= 4)
    return launch_gemv_mt<T, WT, 4, THREADS>(x, vals, idx, out, M, d_in, ob,
                                             K, bm, bn, vec, stream);
  return launch_gemv_mt<T, WT, 8, THREADS>(x, vals, idx, out, M, d_in, ob, K,
                                           bm, bn, vec, stream);
}

// The block size follows the rows: about two weight rows a thread with
// 16-byte loads, one with element loads (the fastest of 64, 128 and 256
// threads at the classifier's and SmolLM-360M's shapes on the H100;
// PERF.md).
template <typename T, typename WT>
int launch_gemv(const void* x, const void* vals, const void* idx, void* out,
                int M, int d_in, int ob, int K, int bm, int bn,
                cudaStream_t stream) {
  if (M < 1 || M > 8 || bm < 1 || bn < 1 || ob > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = bn % 8 == 0 && reinterpret_cast<uintptr_t>(vals) %
                                         (8 * sizeof(WT)) == 0;
  const int want = vec ? (K * bm + 1) / 2 : K * bm;   // threads wanted
  if (want <= 64)
    return launch_gemv_t<T, WT, 64>(x, vals, idx, out, M, d_in, ob, K, bm,
                                    bn, vec, stream);
  if (want <= 128)
    return launch_gemv_t<T, WT, 128>(x, vals, idx, out, M, d_in, ob, K, bm,
                                     bn, vec, stream);
  return launch_gemv_t<T, WT, 256>(x, vals, idx, out, M, d_in, ob, K, bm,
                                   bn, vec, stream);
}

// The simt and gemv launches of x type T by the stored weight type: gemv
// for bf16 and int8 weights, simt for all three.
template <typename T>
int launch_by_weight(const void* x, const void* vals, const void* idx,
                     void* out, int M, int d_in, int ob, int K, int bm,
                     int bn, int wtype, int variant, cudaStream_t s) {
  if (variant == VARIANT_GEMV) {
    switch (wtype) {
      case wtypes::BF16:
        return launch_gemv<T, __nv_bfloat16>(x, vals, idx, out, M, d_in, ob,
                                             K, bm, bn, s);
      case wtypes::INT8:
        return launch_gemv<T, int8_t>(x, vals, idx, out, M, d_in, ob, K, bm,
                                      bn, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (variant != VARIANT_SIMT) return (int)cudaErrorInvalidValue;
  switch (wtype) {
    case wtypes::BF16:
      return launch_simt<T, __nv_bfloat16>(x, vals, idx, out, M, d_in, ob, K,
                                           bm, bn, s);
    case wtypes::INT8:
      return launch_simt<T, int8_t>(x, vals, idx, out, M, d_in, ob, K, bm,
                                    bn, s);
    case wtypes::F32:
      return launch_simt<T, float>(x, vals, idx, out, M, d_in, ob, K, bm, bn,
                                   s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_mma(const void* x, const void* vals, const void* idx, void* out,
               int M, int d_in, int ob, int K, int bm, int bn,
               cudaStream_t stream) {
  if (bm < 1 || bn < 1 || bm % 8 || bn % 8 ||
      (size_t)ob * pieces(bn) > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + MMA_TM - 1) / MMA_TM, ob * pieces(bn));
  const bool reg = (bm <= SUB || bm % SUB == 0) && bm % 16 == 0 &&
                   (bn <= SUB || bn % SUB == 0);
  auto kern = reg ? sparse_matmul_mma<true> : sparse_matmul_mma<false>;
  kern<<<grid, MMA_THREADS, 0, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)vals,
      (const int32_t*)idx, (__nv_bfloat16*)out, M, d_in, ob, K, bm, bn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, d_in) f32 or bf16, M * d_in < 2^31; vals (ob,K,bm,bn) of the
// stored type wtype (0 bf16, 1 int8 codes, 2 f32), any bm that divides
// d_in and any bn, ob * ceil(bn / 64) <= 65535; idx
// (ob,K) int32; out (M, ob*bn) in x's dtype; all contiguous on the
// device (16-byte aligned for mma). variant: 0 simt, 1 mma (bf16 x and
// vals only; bm % 8 == 0, bn % 8 == 0), 2 gemv (M <= 8; bf16 or int8
// vals). Returns cudaErrorInvalidValue for a combination the kernels
// lack, else cudaGetLastError() after the launch.
int sparse_matmul_f32(const void* x, const void* vals, const void* idx,
                      void* out, int M, int d_in, int ob, int K, int bm,
                      int bn, int wtype, int variant, void* stream) {
  return launch_by_weight<float>(x, vals, idx, out, M, d_in, ob, K, bm, bn,
                                 wtype, variant, (cudaStream_t)stream);
}

int sparse_matmul_bf16(const void* x, const void* vals, const void* idx,
                       void* out, int M, int d_in, int ob, int K, int bm,
                       int bn, int wtype, int variant, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == VARIANT_MMA)
    return wtype == wtypes::BF16
               ? launch_mma(x, vals, idx, out, M, d_in, ob, K, bm, bn, s)
               : (int)cudaErrorInvalidValue;
  return launch_by_weight<__nv_bfloat16>(x, vals, idx, out, M, d_in, ob, K,
                                         bm, bn, wtype, variant, s);
}

const char* sparse_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
