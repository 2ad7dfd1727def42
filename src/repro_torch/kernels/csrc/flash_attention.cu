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
// Two variants, chosen in Python (flash_attention.variant) and passed in:
//
// "simt", f32 inputs: the exact variant, f32 FMAs on the CUDA cores. The
// TPU grid (b*h, q tile, kv tile) runs the kv axis in order with
// (m, l, acc) in VMEM scratch; here one thread block owns one (b*h,
// 64-row q tile) and loops over the 64-key tiles itself, with (m, l,
// acc) in registers. 256 threads as 16 x 16: thread (ty, tx) holds query
// rows 4*ty..4*ty+3, the scores of keys tx + 16*j (j < 4) and the output
// columns tx*D/16 .. +D/16. Per kv tile: K (transposed) and V go to
// shared memory as f32; S = Q K^T by f32 FMAs; the row max and row sum
// reduce over the 16 threads of a row by warp shuffles; P goes to shared
// memory (transposed) and O += P V by f32 FMAs.
//
// "mma", bf16 inputs: tensor cores. One block of 4 warps per (b*h, 64-row
// q tile), 16 query rows a warp. Q is loaded once into mma A fragments
// (ldmatrix) at D <= 64; at D = 112 and 128 the fragments are read from
// shared memory at each tile instead, which keeps the 56 or 64 f32
// accumulators a thread of O in registers without spills. D = 112
// (zamba2's heads) is 7 k-steps of 16, 14 column tiles of 8 and 14
// 16-byte chunks a row: every loop below walks D in those units, and
// the P V product pairs the 14 tiles as 7 ldmatrix.x4.trans loads. The 64-key K and V tiles go
// through a 2-stage cp.async ring in shared memory (rows padded to D + 8
// elements, so the 8 rows of an ldmatrix hit 8 distinct 16-byte bank
// groups); tile t+1's copies are issued before tile t's math. The
// shared memory is dynamic (Q, K and V take 76,800 B at D = 112 and
// 87,040 B at D = 128, over the 48 KB of a static array), its limit set
// at each launch. A padded row of D + 8 = 120 elements is 240 B, so the
// 8 rows of an ldmatrix start 60 words apart and still fall on 8
// distinct 16-byte bank groups. S = Q K^T
// is mma.sync.m16n8k16 on bf16 with f32 accumulators (bf16 x bf16
// products are exact in f32, so S is the Pallas kernel's up to sum
// order), scaled after the product. The
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
// keys, not causal) 11.5 GFLOP, 11.6 us.
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

template <int D>
constexpr int smem_floats() {
  return D * QS + D * KS + BK * D + BK * QS;
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

// ---- simt: f32, CUDA cores --------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_simt(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int H, int Tq, int Tk, int causal, int window,
                     int q_offset, float scale) {
  constexpr int DPT = D / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // [D][QS]  q tile, transposed
  float* kt = qt + D * QS;      // [D][KS]  k tile, transposed
  float* vs = kt + D * KS;      // [BK][D]  v tile
  float* pt = vs + BK * D;      // [BK][QS] p tile, transposed

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t rs = (size_t)H * D;                    // row stride
  const float* qb = q + (size_t)b * Tq * rs + (size_t)h * D;
  const float* kb = k + (size_t)b * Tk * rs + (size_t)h * D;
  const float* vb = v + (size_t)b * Tk * rs + (size_t)h * D;
  float* ob = out + (size_t)b * Tq * rs + (size_t)h * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    qt[d * QS + r] = q0 + r < Tq ? qb[(size_t)(q0 + r) * rs + d] : 0.f;
  }

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
    __syncthreads();   // the previous tile's kt, vs, pt are consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const bool in = k0 + r < Tk;
      const size_t off = (size_t)(k0 + r) * rs + d;
      kt[d * KS + r] = in ? kb[off] : 0.f;
      vs[r * D + d] = in ? vb[off] : 0.f;
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
        ob[(size_t)r * rs + tx * DPT + c] = o[i][c] / li;
    }
  }
}

// ---- mma: bf16, tensor cores -------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps of 16 query rows

template <int D>
struct MmaSmem {
  static constexpr int LD = D + 8;          // row stride (elements)
  static constexpr bool Q_IN_REGS = D <= 64;  // else re-read each tile
  __nv_bfloat16 q[BQ * LD];
  __nv_bfloat16 k[2][BK * LD];              // the 2-stage ring
  __nv_bfloat16 v[2][BK * LD];
};

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int H, int Tq, int Tk,
                    int causal, int window, int q_offset, float scale) {
  constexpr int LD = MmaSmem<D>::LD;
  constexpr int KC = D / 16;        // k-steps of S = Q K^T
  constexpr int NT = BK / 8;        // 8-key column tiles of S
  constexpr int DT = D / 8;         // 8-wide column tiles of O
  constexpr int CH = D / 8;         // 16-byte chunks in a row
  constexpr bool Q_IN_REGS = MmaSmem<D>::Q_IN_REGS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MmaSmem<D>& sm = *reinterpret_cast<MmaSmem<D>*>(smem_raw);

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

  // rows past Tq / Tk are zero-filled (never read from memory)
  for (int e = tid; e < BQ * CH; e += MMA_THREADS) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool in = q0 + r < Tq;
    tc::cp_async16(&sm.q[r * LD + c], in ? qb + (size_t)(q0 + r) * rs + c : qb,
                   in);
  }
  auto load_kv = [&](int t, int st) {
    const int k0 = t * BK;
    for (int e = tid; e < BK * CH; e += MMA_THREADS) {
      const int r = e / CH, c = (e % CH) * 8;
      const bool in = k0 + r < Tk;
      const size_t off = in ? (size_t)(k0 + r) * rs + c : 0;
      tc::cp_async16(&sm.k[st][r * LD + c], kb + off, in);
      tc::cp_async16(&sm.v[st][r * LD + c], vb + off, in);
    }
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
      __nv_bfloat16* orow = ob + (size_t)row * rs + 2 * tg;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(o[n][2 * r] / li, o[n][2 * r + 1] / li);
    }
  }
}

// ---- launch --------------------------------------------------------------

template <int D>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                int B, int H, int Tq, int Tk, int causal, int window,
                int q_offset, float scale, void* stream) {
  constexpr int smem = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_attention_simt<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, H, Tq,
      Tk, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int H, int Tq, int Tk, int causal, int window, int q_offset,
               float scale, void* stream) {
  constexpr int smem = (int)sizeof(MmaSmem<D>);
  auto kern = flash_attention_mma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kern<<<grid, MMA_THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, H, Tq, Tk, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Tq, H, D), k and v (B, Tk, H, D), out like q; one dtype, all
// contiguous on the device (the bf16 ones 16-byte aligned); D in {32,
// 64, 112, 128}. scale = 1/sqrt(D) as an f32. variant: 0 simt (f32 only), 1 mma
// (bf16 only). Returns the cudaError_t of the launch.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Tq, int Tk, int D,
                        int causal, int window, int q_offset, float scale,
                        int variant, void* stream) {
  if (variant != VARIANT_SIMT) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch_simt<32>(q, k, v, out, B, H, Tq, Tk, causal,
                                    window, q_offset, scale, stream);
    case 64: return launch_simt<64>(q, k, v, out, B, H, Tq, Tk, causal,
                                    window, q_offset, scale, stream);
    case 112: return launch_simt<112>(q, k, v, out, B, H, Tq, Tk, causal,
                                     window, q_offset, scale, stream);
    case 128: return launch_simt<128>(q, k, v, out, B, H, Tq, Tk, causal,
                                     window, q_offset, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int Tq, int Tk, int D,
                         int causal, int window, int q_offset, float scale,
                         int variant, void* stream) {
  if (variant != VARIANT_MMA) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch_mma<32>(q, k, v, out, B, H, Tq, Tk, causal,
                                   window, q_offset, scale, stream);
    case 64: return launch_mma<64>(q, k, v, out, B, H, Tq, Tk, causal,
                                   window, q_offset, scale, stream);
    case 112: return launch_mma<112>(q, k, v, out, B, H, Tq, Tk, causal,
                                    window, q_offset, scale, stream);
    case 128: return launch_mma<128>(q, k, v, out, B, H, Tq, Tk, causal,
                                    window, q_offset, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
