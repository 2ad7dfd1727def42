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
// Two variants, chosen in Python (flash_attention.variant) and passed in.
// Both take any head size D >= 1, as the Pallas kernel (whose blocks span
// the whole head) does:
//
// "simt", f32 inputs (and bf16 past D = 256): the exact variant, f32
// FMAs on the CUDA cores. The TPU grid (b*h, q tile, kv tile) runs the kv
// axis in order with (m, l, acc) in VMEM scratch; here one thread block
// owns one (b*h, 64-row q tile, DC output columns) and loops over the
// 64-key tiles itself, with (m, l, acc) in registers. DC, a template
// argument, is the least of 16, 32, 64, 112, 128 and 256 that holds D
// (the columns past D zero); past 256 the head is cut into DC = 256
// chunks: grid z walks the output chunks and each block sums S = Q K^T
// over every chunk of D in turn (S recomputed once per output chunk).
// 256 threads as 16 x 16: thread (ty, tx) holds query rows
// 4*ty..4*ty+3, the scores of keys tx + 16*j (j < 4) and the output
// columns tx*DC/16 .. +DC/16. Per kv tile: K (transposed) and V go to
// shared memory as f32; S = Q K^T by f32 FMAs; the row max and row sum
// reduce over the 16 threads of a row by warp shuffles; P goes to shared
// memory (transposed) and O += P V by f32 FMAs.
//
// "mma", bf16 inputs with D <= 256: tensor cores. One block of 4 warps
// per (b*h, 64-row q tile), 16 query rows a warp. The head is padded to
// DP, a template argument: D rounded up to 16, 32, 48, ..., 128, 160,
// 192 or 256; the columns past D are zero-filled in shared memory (the
// source-size-0 form of the 16-byte cp.async where D is a multiple of 8,
// element loads otherwise: a row then does not start on 16 bytes) and
// never stored, so no padded copy exists. Q is loaded once into mma A
// fragments (ldmatrix) at DP <= 64; past it the fragments are read from
// shared memory at each tile instead, which keeps the DP / 2 f32
// accumulators a thread of O in registers. Every loop below walks DP in
// units of 16 k-steps, 8-column tiles and 16-byte chunks (D = 112,
// zamba2's heads: 7, 14 and 14), and the P V product pairs the column
// tiles as ldmatrix.x4.trans loads. The 64-key K and V tiles go
// through a 2-stage cp.async ring in shared memory (rows padded to DP + 8
// elements, so the 8 rows of an ldmatrix hit 8 distinct 16-byte bank
// groups); tile t+1's copies are issued before tile t's math. The
// shared memory is dynamic (Q, K and V take 640 * (DP + 8) B: 76,800 B at
// DP = 112, 87,040 B at 128 and 168,960 B at 256, over the 48 KB of a
// static array), its limit set at each launch. S = Q K^T
// is mma.sync.m16n8k16 on bf16 with f32 accumulators (bf16 x bf16
// products are exact in f32, so S is the Pallas kernel's up to sum
// order), scaled by 1/sqrt(D) after the product. The
// online softmax runs on the accumulator fragments: a row's max and sum
// reduce over the 4 lanes of a quad. O += P V keeps p's f32 value, as the
// Pallas kernel does: p is split into p_hi = bf16(p) and p_lo = bf16(p -
// p_hi) (p to ~2^-17 relative), two mma.sync against the same V
// fragment (ldmatrix.trans), straight from the S fragments without a
// trip through shared memory; l sums the f32 p.
//
// Both: tiles wholly above the diagonal (causal) or wholly before the
// window are skipped, which leaves (m, l, acc) as the Pallas kernel's
// masked steps do; a tile that is partly outside Tk is masked (its
// out-of-range K and V rows are zero), so any length works. The grid is
// (B*H, q tiles) with the q tile slowest, so that the blocks with the
// most kv tiles (the last rows), of every head, are scheduled first.
//
// What bounds it. At SmolLM-360M's prefill (B 1, T 2048, H 15, D 64)
// the work is 2*B*H*T^2*D causal multiply-adds counted as operations,
// 8.1 GFLOP: 8.1 us on the tensor cores at 989 TFLOP/s, against ~15 MB
// of q, k, v, o (4.7 us at the memory rate), so the bound is operations.
// The mma variant does them on the tensor cores, 1.5x over (the split
// p doubles the PV half), with mma.sync rather than Hopper's wgmma, and
// the exponentials on the SFU beside them; wgmma, TMA and warp
// specialisation are later work. At Qwen3-32B's prefill (H 64, D 128)
// a layer is 68.7 GFLOP, 69.5 us at the tensor-core rate; at zamba2-7b's
// shared attention (H 32, D 112, T 2048 under its window of 4096) 30.1
// GFLOP, 30.4 us; at whisper-large-v3's encoder (H 20, D 64, 1500 x 1500
// keys, not causal) 11.5 GFLOP, 11.6 us. A head that is no multiple of 16
// (D 40: DP 48) does the padded columns' products too, 1.2x here; at D
// 256 the O accumulators take 128 registers a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int VARIANT_SIMT = 0;   // flash_attention.VARIANT_CODES
constexpr int VARIANT_MMA = 1;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int RPT = 4;          // query rows per thread
constexpr int CPT = 4;          // keys per thread per tile
constexpr int QS = BQ + 4;      // row stride (floats) of qt and pt
constexpr int KS = BK + 4;      // row stride (floats) of kt
constexpr float NEG_INF = -1e30f;

template <int DC>
constexpr int smem_floats() {
  return DC * QS + DC * KS + BK * DC + BK * QS;
}

// [begin, end) of the kv tiles some query at absolute position
// pos_first..pos_last can see (flash_attention.kv_tile_range).
__device__ __forceinline__ int2 kv_tiles(int pos_first, int pos_last, int Tk,
                                         int causal, int window) {
  const int kv_end = causal ? min(Tk, pos_last + 1) : Tk;
  const int kv_begin = window > 0 ? max(0, pos_first - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  return make_int2(t_begin,
                   kv_begin < kv_end ? (kv_end + BK - 1) / BK : t_begin);
}

// ---- simt: f32 (bf16 past D = 256), CUDA cores ------------------------

__device__ __forceinline__ float ld_f32(const float* p) { return *p; }
__device__ __forceinline__ float ld_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_attention_simt(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int H,
                     int D, int Tq, int Tk, int causal, int window,
                     int q_offset, float scale) {
  constexpr int DPT = DC / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // [DC][QS]  q chunk, transposed
  float* kt = qt + DC * QS;     // [DC][KS]  k chunk, transposed
  float* vs = kt + DC * KS;     // [BK][DC]  v tile, this block's columns
  float* pt = vs + BK * DC;     // [BK][QS]  p tile, transposed

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int nd = (D + DC - 1) / DC;   // chunks of the head
  const int oc0 = blockIdx.z * DC;    // this block's output columns
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t rs = (size_t)H * D;                    // row stride
  const T* qb = q + (size_t)b * Tq * rs + (size_t)h * D;
  const T* kb = k + (size_t)b * Tk * rs + (size_t)h * D;
  const T* vb = v + (size_t)b * Tk * rs + (size_t)h * D;
  T* ob = out + (size_t)b * Tq * rs + (size_t)h * D;

  // chunk c of the q tile, transposed; zero past Tq and past D
  auto load_q = [&](int c) {
    for (int e = tid; e < BQ * DC; e += THREADS) {
      const int r = e / DC, d = e % DC, dd = c * DC + d;
      qt[d * QS + r] =
          q0 + r < Tq && dd < D ? ld_f32(qb + (size_t)(q0 + r) * rs + dd)
                                : 0.f;
    }
  };
  if (nd == 1) load_q(0);

  // The kv tiles some row of this q tile can see.
  const int2 tiles = kv_tiles(q_offset + q0, q_offset + min(q0 + BQ, Tq) - 1,
                              Tk, causal, window);
  const int t_begin = tiles.x, t_end = tiles.y;

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
    // S = Q K^T for rows 4*ty+i, keys tx+16*j, summed over the chunks of
    // D in order; V's chunk comes in with the first
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int c = 0; c < nd; ++c) {
      __syncthreads();   // the previous chunk's or tile's tiles are consumed
      if (nd > 1) load_q(c);
      for (int e = tid; e < BK * DC; e += THREADS) {
        const int r = e / DC, d = e % DC;
        const bool in = k0 + r < Tk;
        const size_t row = (size_t)(k0 + r) * rs;
        kt[d * KS + r] = in && c * DC + d < D ? ld_f32(kb + row + c * DC + d)
                                              : 0.f;
        if (c == 0)
          vs[r * DC + d] = in && oc0 + d < D ? ld_f32(vb + row + oc0 + d)
                                             : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < DC; ++d) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&qt[d * QS + ty * RPT]);
        const float qr[RPT] = {qv.x, qv.y, qv.z, qv.w};
        float kr[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) kr[j] = kt[d * KS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
      }
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
      const float* vrow = &vs[kk * DC + tx * DPT];
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
      for (int c = 0; c < DPT; ++c) {
        const int col = oc0 + tx * DPT + c;
        if (col < D) st_f32(ob + (size_t)r * rs + col, o[i][c] / li);
      }
    }
  }
}

// ---- mma: bf16, tensor cores -------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps of 16 query rows

template <int DP>
struct MmaSmem {
  static constexpr int LD = DP + 8;         // row stride (elements)
  static constexpr bool Q_IN_REGS = DP <= 64;  // else re-read each tile
  __nv_bfloat16 q[BQ * LD];
  __nv_bfloat16 k[2][BK * LD];              // the 2-stage ring
  __nv_bfloat16 v[2][BK * LD];
};

// Rows [0, 64) of N (rows, D) slices at src[i] (row stride rs) into
// (64, DP) tiles at dst[i] (row stride LD), the N copies of an element
// issued together: rows at or past n_rows and columns at or past D read
// zero (EXACT: D == DP, no column check). vec (D % 8 == 0, 16-byte
// aligned rows): 16-byte cp.async, zero-filled by the source-size-0
// form; else element loads (a row of such a D does not start on 16
// bytes).
template <int DP, bool EXACT, int N>
__device__ __forceinline__ void load_tiles(
    __nv_bfloat16* const (&dst)[N], const __nv_bfloat16* const (&src)[N],
    size_t rs, int n_rows, int D) {
  constexpr int LD = DP + 8, CH = DP / 8;
  if (EXACT || D % 8 == 0) {
    for (int e = threadIdx.x; e < BQ * CH; e += MMA_THREADS) {
      const int r = e / CH, c = (e % CH) * 8;
      const bool in = r < n_rows && (EXACT || c < D);
      const size_t off = in ? (size_t)r * rs + c : 0;
#pragma unroll
      for (int i = 0; i < N; ++i)
        tc::cp_async16(&dst[i][r * LD + c], src[i] + off, in);
    }
  } else {
    for (int e = threadIdx.x; e < BQ * DP; e += MMA_THREADS) {
      const int r = e / DP, c = e % DP;
      const bool in = r < n_rows && c < D;
#pragma unroll
      for (int i = 0; i < N; ++i)
        dst[i][r * LD + c] = in ? src[i][(size_t)r * rs + c]
                                : __float2bfloat16(0.f);
    }
  }
}

// EXACT: D == DP (16, 32, ..., 128, 160, 192 or 256: every config's D),
// so D is a compile-time constant and the column checks fold away, as in
// the kernel templated on D alone; else D < DP comes at run time.
template <int DP, bool EXACT>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int H, int d_arg,
                    int Tq, int Tk, int causal, int window, int q_offset,
                    float scale) {
  const int D = EXACT ? DP : d_arg;
  constexpr int LD = MmaSmem<DP>::LD;
  constexpr int KC = DP / 16;       // k-steps of S = Q K^T
  constexpr int NT = BK / 8;        // 8-key column tiles of S
  constexpr int DT = DP / 8;        // 8-wide column tiles of O
  constexpr bool Q_IN_REGS = MmaSmem<DP>::Q_IN_REGS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MmaSmem<DP>& sm = *reinterpret_cast<MmaSmem<DP>*>(smem_raw);

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const size_t rs = (size_t)H * D;                    // row stride
  const __nv_bfloat16* qb = q + (size_t)b * Tq * rs + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Tk * rs + (size_t)h * D;
  const __nv_bfloat16* vb = v + (size_t)b * Tk * rs + (size_t)h * D;
  __nv_bfloat16* ob = out + (size_t)b * Tq * rs + (size_t)h * D;

  const int pos_first = q_offset + q0;
  const int pos_last = q_offset + min(q0 + BQ, Tq) - 1;
  const int2 tiles = kv_tiles(pos_first, pos_last, Tk, causal, window);
  const int t_begin = tiles.x, t_end = tiles.y;

  // rows past Tq / Tk and columns past D are zero-filled (never read from
  // memory)
  {
    __nv_bfloat16* const dst[1] = {sm.q};
    const __nv_bfloat16* const src[1] = {qb + (size_t)q0 * rs};
    load_tiles<DP, EXACT>(dst, src, rs, Tq - q0, D);
  }
  auto load_kv = [&](int t, int st) {
    const int k0 = t * BK;
    __nv_bfloat16* const dst[2] = {sm.k[st], sm.v[st]};
    const __nv_bfloat16* const src[2] = {kb + (size_t)k0 * rs,
                                         vb + (size_t)k0 * rs};
    load_tiles<DP, EXACT>(dst, src, rs, Tk - k0, D);
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  tc::cp_async_commit();
  // this thread's rows: g and g + 8 of the warp's 16
  const int qpos0 = q_offset + q0 + warp * 16 + g;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  uint32_t qa[Q_IN_REGS ? KC : 1][4];
  auto load_q = [&](uint32_t (&a)[4], int kc) {
    tc::ldmatrix_x4(a, &sm.q[(warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) *
                             LD + kc * 16 + (lane / 16) * 8]);
  };

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_kv(t + 1, st ^ 1);          // in flight during this tile's math
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Q_IN_REGS) {
      if (t == t_begin) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) load_q(qa[kc], kc);
      }
    }
    const __nv_bfloat16* ks = sm.k[st];
    const __nv_bfloat16* vs = sm.v[st];

    // S = Q K^T: 16 rows x 64 keys a warp, as NT accumulator tiles
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      auto qk = [&](const uint32_t (&a)[4]) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kf[4];   // B of key tiles 2np, 2np+1 at this k-step
          tc::ldmatrix_x4(kf, &ks[(np * 16 + (lane / 16) * 8 + (lane % 8)) *
                                      LD + kc * 16 + ((lane / 8) % 2) * 8]);
          tc::mma_bf16(s[2 * np], a, kf[0], kf[1]);
          tc::mma_bf16(s[2 * np + 1], a, kf[2], kf[3]);
        }
      };
      if constexpr (Q_IN_REGS) {
        qk(qa[kc]);
      } else {
        uint32_t qs[4];
        load_q(qs, kc);
        qk(qs);
      }
    }

    // scale, mask (only where some key of the tile may be masked), and
    // the online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const int k0 = t * BK;
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > pos_first) ||
                      (window > 0 && k0 <= pos_last - window);
    uint32_t keep = 0xffffffffu;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[n][e] * scale;
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * tg + (e & 1);
          const int qpos = qpos0 + (e / 2) * 8;
          bool ok = kpos < Tk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) {
            val = NEG_INF;
            keep &= ~(1u << (n * 4 + e));
          }
        }
        s[n][e] = val;
        mx[e / 2] = fmaxf(mx[e / 2], val);
      }
    float corr[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      corr[r] = __expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (keep >> (n * 4 + e)) & 1u
                            ? __expf(s[n][e] - m_new[e / 2]) : 0.f;
        s[n][e] = p;
        sum[e / 2] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= corr[0]; o[n][1] *= corr[0];
      o[n][2] *= corr[1]; o[n][3] *= corr[1];
    }

    // O += P V over 16-key steps; P's A fragment is two S tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      tc::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      tc::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      tc::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      tc::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];   // B of column tiles 2dp, 2dp+1 at these keys
        tc::ldmatrix_x4_trans(vf, &vs[(kk * 16 + ((lane / 8) % 2) * 8 +
                                       (lane % 8)) * LD +
                                      dp * 16 + (lane / 16) * 8]);
        tc::mma_bf16(o[2 * dp], ph, vf[0], vf[1]);
        tc::mma_bf16(o[2 * dp], pl, vf[0], vf[1]);
        tc::mma_bf16(o[2 * dp + 1], ph, vf[2], vf[3]);
        tc::mma_bf16(o[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();   // stage st is consumed before it is refilled
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row < Tq) {
      const float li = fmaxf(l[r], 1e-20f);
      __nv_bfloat16* orow = ob + (size_t)row * rs;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const int col = n * 8 + 2 * tg;   // and col + 1; none past D
        if (col >= D) continue;
        const float y0 = o[n][2 * r] / li, y1 = o[n][2 * r + 1] / li;
        if (D % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(y0, y1);
        } else {
          orow[col] = __float2bfloat16(y0);
          if (col + 1 < D) orow[col + 1] = __float2bfloat16(y1);
        }
      }
    }
  }
}

// ---- launch --------------------------------------------------------------

template <typename T, int DC>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                int B, int H, int D, int Tq, int Tk, int causal, int window,
                int q_offset, float scale, void* stream) {
  constexpr int smem = smem_floats<DC>() * (int)sizeof(float);
  auto kern = flash_attention_simt<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + BQ - 1) / BQ, (D + DC - 1) / DC);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, D, Tq, Tk, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int H, int D, int Tq, int Tk, int causal, int window,
               int q_offset, float scale, void* stream) {
  constexpr int smem = (int)sizeof(MmaSmem<DP>);
  auto kern = D == DP ? flash_attention_mma<DP, true>
                      : flash_attention_mma<DP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kern<<<grid, MMA_THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, H, D, Tq, Tk, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

#define FLASH_ARGS q, k, v, out, B, H, D, Tq, Tk, causal, window, q_offset, \
                   scale, stream

}  // namespace

extern "C" {

// q (B, Tq, H, D), k and v (B, Tk, H, D), out like q; one dtype, all
// contiguous on the device (for the mma variant 16-byte aligned); any D
// >= 1. scale = 1/sqrt(D) as an f32. variant: 0 simt (f32, and bf16 at D
// > 256), 1 mma (bf16, D <= 256). Returns the cudaError_t of the launch.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Tq, int Tk, int D,
                        int causal, int window, int q_offset, float scale,
                        int variant, void* stream) {
  if (variant != VARIANT_SIMT || D < 1) return (int)cudaErrorInvalidValue;
  if (D <= 16) return launch_simt<float, 16>(FLASH_ARGS);
  if (D <= 32) return launch_simt<float, 32>(FLASH_ARGS);
  if (D <= 64) return launch_simt<float, 64>(FLASH_ARGS);
  if (D <= 112) return launch_simt<float, 112>(FLASH_ARGS);
  if (D <= 128) return launch_simt<float, 128>(FLASH_ARGS);
  return launch_simt<float, 256>(FLASH_ARGS);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int Tq, int Tk, int D,
                         int causal, int window, int q_offset, float scale,
                         int variant, void* stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  if (variant == VARIANT_SIMT && D > 256)
    return launch_simt<__nv_bfloat16, 256>(FLASH_ARGS);
  if (variant != VARIANT_MMA || D > 256) return (int)cudaErrorInvalidValue;
  if (D <= 16) return launch_mma<16>(FLASH_ARGS);
  if (D <= 32) return launch_mma<32>(FLASH_ARGS);
  if (D <= 48) return launch_mma<48>(FLASH_ARGS);
  if (D <= 64) return launch_mma<64>(FLASH_ARGS);
  if (D <= 80) return launch_mma<80>(FLASH_ARGS);
  if (D <= 96) return launch_mma<96>(FLASH_ARGS);
  if (D <= 112) return launch_mma<112>(FLASH_ARGS);
  if (D <= 128) return launch_mma<128>(FLASH_ARGS);
  if (D <= 160) return launch_mma<160>(FLASH_ARGS);
  if (D <= 192) return launch_mma<192>(FLASH_ARGS);
  return launch_mma<256>(FLASH_ARGS);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
