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
// with SAME padding (pad_lo = total // 2) on the k x k depthwise (any k:
// 1..7 a template argument, every other k the simt variant with k given
// at run time), its sums in the Pallas kernel's order
// (depthwise.cuh), the bias, ReLU and residual in f32, and the dw->pw
// boundary rounded to bf16 exactly where the unfused graph rounds it. The
// depthwise result d never reaches device memory: that is the TPU
// kernel's contract and this kernel's point.
//
// Stored weights (a template argument, weights.cuh): all bf16; int8
// pointwise codes, whose (Cout,) f32 scale multiplies the f32 product in
// the epilogue before pw_b (the Pallas flush, dw_pw_fused.py:83-86; under
// the C split, the full sum after the rank-ordered reduction), with the
// depthwise weight and the biases bf16; or all weights and biases f32
// (simt only), at every k: templated instances at k = 3 (the MobileNets'
// depthwise), the simt variant with k at run time at every other k.
//
// Two variants, chosen in Python (dw_pw_fused.variant) and passed in:
//
// "mma" (bf16 pw_w at k 1..7, int8 at k 3; C and Cout multiples of 8:
// every MobileNet block). A block owns
// a pixel tile of TR whole output rows x TW columns of one image (TR*TW
// <= TM, TM = 16, 32 or 64), TN = 64 or 128 output channels on 2 * TN
// threads, and one slice of C, all from dw_pw_fused.plan. Per chunk of CK
// (32 or 64) channels a 3-stage cp.async ring brings the input halo of the
// tile ((TR-1)*s + k rows x (TW-1)*s + k columns, 16 bytes = 8 channels a
// copy, the SAME halo and channels past C zero-filled by the source-size-0
// form: no padded copy exists), the chunk's taps, dw_b and pw_w rows into
// shared memory, two chunks ahead of the compute. The depthwise runs from shared memory,
// 8 channels a thread, adds dw_b, applies ReLU, rounds to bf16 and writes
// the A tile (rows padded against bank conflicts); the pointwise is
// mma.sync.m16n8k16 on bf16 with f32 accumulators, A from ldmatrix, B
// from ldmatrix.trans. Split C: the grid's third axis is a thread-block
// cluster of S <= 8 blocks (no cluster at S = 1); rank r walks chunks
// [r*n/S, (r+1)*n/S) and owns rows [r*TM/S, (r+1)*TM/S) of the tile. Each
// block pushes its f32 partial rows into the owner's shared memory (slot
// = the writer's rank) through distributed shared memory; after one
// cluster barrier the owner sums its slots in rank order and applies the
// epilogue (pw_b and the residual were loaded before the C loop), storing
// 16-byte rows. One launch, no workspace, no atomics, deterministic. The
// plan keeps each block's chain at <= 3 chunks and the grid near or above
// 128 blocks; each Cout tile recomputes the depthwise of its C slice, the
// reason for 128-channel Cout tiles where Cout > 64.
// int8 pw_w: cp.async copies bytes and cannot widen, so the ring holds the
// chunk's ck x TN codes (8-byte copies) and, while the depthwise fills the
// A tile, the threads widen them into one bf16 B tile outside the ring
// (exact: |code| <= 127); the barrier the A tile needs covers it, so the
// chain gains no barrier, and the weight bytes read are halved. The TN
// scales come into shared memory with the first chunk.
//
// "simt" (C or Cout not a multiple of 8, f32 weights, k past 7, and int8
// at k != 3): f32
// FMAs on the CUDA cores, 64
// pixels x 64 output channels a block, C in chunks of 32, the depthwise
// read straight from global memory. k 1..7 is a template argument (the
// chunk's taps in shared memory) for bf16, k 3 for int8 and f32; one
// instance per stored type takes every other k at run time and reads the
// taps from global memory (L1), in the same order of sums.
//
// What bounds it. At batch 1 a block moves x, the weights and y once each
// and does 2*M*C*(k*k + Cout) operations: the bound is bytes over the
// memory rate, 0.1-0.8 us a MobileNet layer (chip_smoke.py computes it per
// layer; PERF.md holds it). What sets the time is latency: a launch, then
// a chain of dependent loads and products per block, which the ring
// overlaps and the split over C cuts short.
//
// Compiled without --use_fast_math: at random init the activations fall
// by orders of magnitude per block, and flushing denormals to zero would
// change the logits.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "depthwise.cuh"
#include "tensor_core.cuh"
#include "weights.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int VARIANT_SIMT = 0;   // the codes of _build.VARIANT_CODES
constexpr int VARIANT_MMA = 1;
constexpr int K_MAX = 7;          // the largest templated kernel size

// ---- simt: CUDA cores, any C and Cout -------------------------------------

constexpr int TM = 64;        // output pixels per block
constexpr int TN_SIMT = 64;   // output channels per block
constexpr int CK_SIMT = 32;   // input channels per chunk
constexpr int THREADS = 256;
constexpr int DW_PIX = TM * CK_SIMT / THREADS;   // 8 depthwise pixels a thread
constexpr int TX = 16;                           // threads across the Cout tile
constexpr int TY = THREADS / TX;                 // 16 across the pixel tile
constexpr int RM = TM / TY;                      // 4 pixels a thread
constexpr int RN = TN_SIMT / TX;                 // 4 output channels a thread
constexpr int W_LOADS = CK_SIMT * TN_SIMT / THREADS;   // 8 pw weights a thread
constexpr int DS_LD = TM + 4;   // row of the depthwise tile, float4-aligned

// K: the kernel size, 0 for k_rt at run time; WT: the pointwise weight's
// stored type; PT: the depthwise weight's and the biases' (f32 beside
// f32, else bf16)
template <int K, typename WT, typename PT = typename wtypes::Param<WT>::type>
__global__ void __launch_bounds__(THREADS)
dw_pw_simt(const __nv_bfloat16* __restrict__ x,
           const PT* __restrict__ dw_w,
           const PT* __restrict__ dw_b,
           const WT* __restrict__ pw_w,
           const PT* __restrict__ pw_b,
           const __nv_bfloat16* __restrict__ res,
           const float* __restrict__ pw_scale,
           __nv_bfloat16* __restrict__ out, int N, int H, int W, int C,
           int Ho, int Wo, int stride, int pad_h, int pad_w, int Cout,
           int dw_relu, int relu, int k_rt) {
  // the depthwise tile (bf16 values, channel-major) and the pointwise
  // weight tile of one chunk
  __shared__ __align__(16) float ds[CK_SIMT][DS_LD];
  __shared__ __align__(16) float ws[CK_SIMT][TN_SIMT];
  // the chunk's depthwise taps (a run-time k reads them from dw_w)
  __shared__ float taps[K > 0 ? K * K : 1][CK_SIMT];
  const int M = N * Ho * Wo;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN_SIMT;
  const int tid = threadIdx.x;

  // Depthwise role: channel dc of each chunk, the DW_PIX consecutive
  // pixels from dp on; the first one's coordinates are worked out once
  // and stepped one pixel at a time, with no division in the chunk loop.
  const int dc = tid % CK_SIMT, dp = (tid / CK_SIMT) * DW_PIX;
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

  for (int c0 = 0; c0 < C; c0 += CK_SIMT) {
    // (1) the depthwise of this chunk, into shared memory: the chunk's
    // taps first, then one pixel at a time and one kernel row at a time,
    // so only k loads are in flight per thread
    const int c = c0 + dc;
    const bool c_ok = c < C;
    if constexpr (K > 0) {
      for (int e = tid; e < K * K * CK_SIMT; e += THREADS) {
        const int ce = c0 + e % CK_SIMT;
        taps[e / CK_SIMT][e % CK_SIMT] =
            ce < C ? wtypes::to_f32(dw_w[(e / CK_SIMT) * C + ce]) : 0.f;
      }
      __syncthreads();
    }
    const float b = c_ok ? wtypes::to_f32(dw_b[c]) : 0.f;
    int ox = ox_first, oy = oy_first, img = img_first;
    for (int i = 0; i < DW_PIX; ++i) {
      float d = 0.f;
      if (c_ok && p_first + i < M) {
        const int iy0 = oy * stride - pad_h, ix0 = ox * stride - pad_w;
        const __nv_bfloat16* xi = x + (size_t)img * H * W * C + c;
        float sum = 0.f;
        if constexpr (K > 0) {
#pragma unroll
          for (int ky = 0; ky < K; ++ky) {
            const int iy = iy0 + ky;
            float xv[K];
#pragma unroll
            for (int kx = 0; kx < K; ++kx)
              xv[kx] = dw::in_image(iy, ix0 + kx, H, W)
                           ? __bfloat162float(
                                 xi[((size_t)iy * W + ix0 + kx) * C])
                           : 0.f;   // the SAME halo
            float row = 0.f;   // this kernel row's sum, from zero
#pragma unroll
            for (int kx = 0; kx < K; ++kx)
              row = fmaf(xv[kx], taps[ky * K + kx][dc], row);
            sum += row;
          }
        } else {
          for (int ky = 0; ky < k_rt; ++ky) {
            const int iy = iy0 + ky;
            float row = 0.f;   // this kernel row's sum, from zero
            for (int kx = 0; kx < k_rt; ++kx) {
              const float xv = dw::in_image(iy, ix0 + kx, H, W)
                                   ? __bfloat162float(
                                         xi[((size_t)iy * W + ix0 + kx) * C])
                                   : 0.f;   // the SAME halo
              row = fmaf(xv, wtypes::to_f32(dw_w[(ky * k_rt + kx) * C + c]),
                         row);
            }
            sum += row;
          }
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
      const int cc = e / TN_SIMT, nn = e % TN_SIMT;
      const int ci = c0 + cc, co = n0 + nn;
      ws[cc][nn] = (ci < C && co < Cout)
                       ? wtypes::to_f32(pw_w[(size_t)ci * Cout + co])
                       : 0.f;
    }
    __syncthreads();

    // (3) the tile product, summed over the chunk in channel order; each
    // step reads 4 pixels and 4 weights as one float4 each
#pragma unroll 8
    for (int cc = 0; cc < CK_SIMT; ++cc) {
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
    const float b = wtypes::to_f32(pw_b[co]);
    const float sc = pw_scale != nullptr ? pw_scale[co] : 1.f;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int p = m0 + ty * RM + i;
      if (p >= M) continue;
      const size_t o = (size_t)p * Cout + co;
      // int8: the code product times its scale, rounded before pw_b
      float y =
          (pw_scale != nullptr ? __fmul_rn(acc[i][j], sc) : acc[i][j]) + b;
      if (res != nullptr) y += __bfloat162float(res[o]);
      if (relu) y = fmaxf(y, 0.f);
      out[o] = __float2bfloat16(y);
    }
  }
}

// ---- mma: tensor cores, input halo in shared memory, C split over a
// cluster ------------------------------------------------------------------

// A block owns TN = 64 or 128 output channels on 2 * TN threads.
constexpr int STAGES = 3;           // the cp.async ring
constexpr int MAX_SPLIT = 8;        // the portable cluster size
constexpr int SMEM_MAX = 232448;    // what one block may hold on sm_90

__host__ __device__ constexpr int round16(int b) { return (b + 15) / 16 * 16; }

// The dynamic shared memory of one mma block, section by section: the
// ring, (int8) the widened B tile, the A tile, the partial rows and
// (int8) the scales. For bf16 weights the Python plan
// (dw_pw_fused.smem_bytes) computes the same numbers; int8 takes less
// (its ring holds ck x tn bytes of codes a stage). The B tile's rows are
// padded by 8 elements against bank conflicts and a partial row by 4
// floats.
struct MmaSmem {
  int halo, taps, dwb, wt, stage, btile, a, red, scl, total;
  __host__ __device__ MmaSmem(int k, int tm, int tn, int hr, int hc, int ck,
                              int split, bool codes) {
    halo = round16(hr * hc * ck * 2);
    taps = round16(k * k * ck * 2);
    dwb = round16(ck * 2);
    wt = codes ? ck * tn : ck * (tn + 8) * 2;
    stage = halo + taps + dwb + wt;
    btile = codes ? ck * (tn + 8) * 2 : 0;
    a = tm * (ck + 8) * 2;
    red = split * ((tm + split - 1) / split) * (tn + 4) * 4;
    scl = codes ? tn * 4 : 0;
    total = STAGES * stage + btile + a + red + scl;
  }
};

// WT: __nv_bfloat16, or int8_t pointwise codes with their scale
template <int K, int TM_, int TN, typename WT>
__global__ void __launch_bounds__(2 * TN)
dw_pw_mma(const __nv_bfloat16* __restrict__ x,
          const __nv_bfloat16* __restrict__ dw_w,
          const __nv_bfloat16* __restrict__ dw_b,
          const WT* __restrict__ pw_w,
          const __nv_bfloat16* __restrict__ pw_b,
          const __nv_bfloat16* __restrict__ res,
          const float* __restrict__ pw_scale,
          __nv_bfloat16* __restrict__ out, int H, int W, int C, int Ho,
          int Wo, int stride, int pad_h, int pad_w, int Cout, int dw_relu,
          int relu, int tr, int tw, int ck, int tiles_y, int tiles_x) {
  constexpr int MMA_THREADS = 2 * TN;
  constexpr int BLD = TN + 8;           // B tile row stride (elements)
  constexpr int PLD = TN + 4;           // partial row stride (floats)
  constexpr int WM = TM_ / 16;          // warps along the pixels
  constexpr int WN = MMA_THREADS / 32 / WM;   // warps along the columns
  constexpr int NT = TN / 8 / WN;       // 8-column tiles a warp owns
  constexpr int TG = TN / 8;            // 16-byte groups of a tile row
  constexpr int E_ITEMS = TM_ * TG / MMA_THREADS;   // epilogue items a
                                                    // thread (split 1)
  constexpr bool CODES = sizeof(WT) == 1;
  extern __shared__ __align__(128) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane / 4, tg = lane % 4;

  // this block's tile: image img, output rows oy0.., columns ox0..
  const int per_img = tiles_y * tiles_x;
  const int img = blockIdx.x / per_img;
  const int t_in = blockIdx.x % per_img;
  const int oy0 = (t_in / tiles_x) * tr, ox0 = (t_in % tiles_x) * tw;
  const int n0 = blockIdx.y * TN;
  const int n_tiles = min(TN, Cout - n0) / 8;
  const int hr = (tr - 1) * stride + K, hc = (tw - 1) * stride + K;
  const int iy_base = oy0 * stride - pad_h, ix_base = ox0 * stride - pad_w;
  const int lg = ck == 64 ? 3 : 2;      // log2 of the 16-byte groups a row
  const int groups = 1 << lg;
  const int chunks = (C + ck - 1) / ck;
  const int lo = rank * chunks / split;
  const int n = (rank + 1) * chunks / split - lo;   // this block's chunks

  const MmaSmem L(K, TM_, TN, hr, hc, ck, split, CODES);
  __nv_bfloat16* b_tile =      // int8: the chunk's codes, widened
      reinterpret_cast<__nv_bfloat16*>(smem + STAGES * L.stage);
  __nv_bfloat16* a_tile =
      reinterpret_cast<__nv_bfloat16*>(smem + STAGES * L.stage + L.btile);
  float* red = reinterpret_cast<float*>(smem + STAGES * L.stage + L.btile +
                                        L.a);
  float* scl = red + L.red / 4;  // int8: the Cout tile's scales
  const int ald = ck + 8;               // A row stride: 80 or 144 B

  // this block's output rows [r0, r1) of the tile, summed over the
  // cluster; each (row, 8 columns) item's bias and residual are loaded
  // now, so the epilogue waits on no global load
  const int r0 = rank * TM_ / split, r1 = (rank + 1) * TM_ / split;
  if (split > 1) tc::cluster_arrive_relaxed();   // this block runs
  uint4 e_bias[E_ITEMS], e_res[E_ITEMS];
  int e_out[E_ITEMS];   // output element offset, -1: nothing to store
#pragma unroll
  for (int i = 0; i < E_ITEMS; ++i) {
    const int e = tid + i * MMA_THREADS;
    const int row = r0 + e / TG, co = n0 + (e % TG) * 8;
    const int oy = oy0 + row / tw, ox = ox0 + row % tw;
    e_bias[i] = e_res[i] = make_uint4(0, 0, 0, 0);
    e_out[i] = -1;
    if (row < r1 && row < tr * tw && oy < Ho && ox < Wo && co < Cout) {
      e_out[i] = ((img * Ho + oy) * Wo + ox) * Cout + co;
      e_bias[i] = *reinterpret_cast<const uint4*>(pw_b + co);
      if (res != nullptr)
        e_res[i] = *reinterpret_cast<const uint4*>(res + e_out[i]);
    }
  }

  auto load = [&](int s, int st) {
    const int c0 = (lo + s) * ck;
    unsigned char* base = smem + st * L.stage;
    __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* taps = reinterpret_cast<__nv_bfloat16*>(base + L.halo);
    __nv_bfloat16* dwb =
        reinterpret_cast<__nv_bfloat16*>(base + L.halo + L.taps);
    __nv_bfloat16* wt =
        reinterpret_cast<__nv_bfloat16*>(base + L.halo + L.taps + L.dwb);
    for (int e = tid; e < hr * hc * groups; e += MMA_THREADS) {
      const int pos = e >> lg, ch = c0 + (e & (groups - 1)) * 8;
      const int r = pos / hc;
      const int iy = iy_base + r, ix = ix_base + pos - r * hc;
      const bool in = dw::in_image(iy, ix, H, W) && ch < C;
      tc::cp_async16(halo + pos * ck + (ch - c0),
                     in ? x + ((size_t)(img * H + iy) * W + ix) * C + ch : x,
                     in);   // the SAME halo, or channels past C
    }
    for (int e = tid; e < K * K * groups; e += MMA_THREADS) {
      const int t = e >> lg, ch = c0 + (e & (groups - 1)) * 8;
      tc::cp_async16(taps + t * ck + (ch - c0),
                     ch < C ? dw_w + t * C + ch : dw_w, ch < C);
    }
    if (tid < groups) {
      const int ch = c0 + tid * 8;
      tc::cp_async16(dwb + tid * 8, ch < C ? dw_b + ch : dw_b, ch < C);
    }
    for (int e = tid; e < ck * TG; e += MMA_THREADS) {
      const int r = e / TG, col = (e % TG) * 8;
      const bool in = c0 + r < C && n0 + col < Cout;
      const WT* src = in ? pw_w + (size_t)(c0 + r) * Cout + n0 + col : pw_w;
      if constexpr (CODES)
        tc::cp_async8(reinterpret_cast<int8_t*>(wt) + r * TN + col, src, in);
      else
        tc::cp_async16(wt + r * BLD + col, src, in);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  // the scales ride with chunk 0: the first wait of the loop below (a
  // block walks at least one chunk) and its barrier make them visible
  if constexpr (CODES) {
    for (int e = tid; e < TN / 4; e += MMA_THREADS) {
      const bool in = n0 + e * 4 < Cout;
      tc::cp_async16(scl + e * 4, in ? pw_scale + n0 + e * 4 : pw_scale, in);
    }
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, s);
    tc::cp_async_commit();                 // empty groups keep the count
  }
  for (int s = 0; s < n; ++s) {
    tc::cp_async_wait<STAGES - 2>();       // chunk s has landed
    __syncthreads();                       // and chunk s - 1 is consumed
    if (s + STAGES - 1 < n) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    tc::cp_async_commit();
    const unsigned char* base = smem + (s % STAGES) * L.stage;
    const __nv_bfloat16* halo = reinterpret_cast<const __nv_bfloat16*>(base);
    const __nv_bfloat16* taps =
        reinterpret_cast<const __nv_bfloat16*>(base + L.halo);
    const __nv_bfloat16* dwb =
        reinterpret_cast<const __nv_bfloat16*>(base + L.halo + L.taps);
    const __nv_bfloat16* wt =
        CODES ? b_tile
              : reinterpret_cast<const __nv_bfloat16*>(base + L.halo +
                                                       L.taps + L.dwb);
    if constexpr (CODES) {
      // this chunk's codes, widened into the B tile (read by the previous
      // chunk's products, which the barrier above has seen finish)
      const int8_t* w8 =
          reinterpret_cast<const int8_t*>(base + L.halo + L.taps + L.dwb);
      for (int e = tid; e < ck * TG; e += MMA_THREADS) {
        const int r = e / TG, col = (e % TG) * 8;
        *reinterpret_cast<uint4*>(b_tile + r * BLD + col) = wtypes::widen8(
            *reinterpret_cast<const uint2*>(w8 + r * TN + col));
      }
    }

    // the depthwise of this chunk into the A tile: per kernel row the k
    // taps from zero, then into the accumulator; + dw_b, ReLU, one round
    // (one item at a time: pixel row i of the A tile, 8-channel group gc;
    // the row is zero where it lies past the tile or the image)
#pragma unroll 1
    for (int e = tid; e < TM_ * groups; e += MMA_THREADS) {
      const int i = e >> lg, gc = (e & (groups - 1)) * 8;
      const int ty = i / tw, tx = i - ty * tw;
      const int pos = ty * stride * hc + tx * stride;   // tap (0, 0)
      float d[8];
      dw::zero8(d);
      if (i < tr * tw && oy0 + ty < Ho && ox0 + tx < Wo) {
        float row[8], xv[8], wv[8];
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          dw::zero8(row);
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            dw::unpack8(*reinterpret_cast<const uint4*>(
                            halo + (pos + ky * hc + kx) * ck + gc),
                        xv);
            dw::unpack8(*reinterpret_cast<const uint4*>(
                            taps + (ky * K + kx) * ck + gc),
                        wv);
            dw::row_mac(row, xv, wv);
          }
          dw::add_row(d, row);
        }
        dw::unpack8(*reinterpret_cast<const uint4*>(dwb + gc), wv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          d[j] += wv[j];
          if (dw_relu) d[j] = fmaxf(d[j], 0.f);
        }
      }
      *reinterpret_cast<uint4*>(a_tile + i * ald + gc) = dw::pack8(d);
    }
    __syncthreads();

    // the pointwise of this chunk on the tensor cores
    for (int kc = 0; kc < ck / 16; ++kc) {
      uint32_t a[4];
      tc::ldmatrix_x4(a, &a_tile[(wm * 16 + (lane % 8) +
                                  ((lane / 8) % 2) * 8) * ald +
                                 kc * 16 + (lane / 16) * 8]);
      const __nv_bfloat16* wrow =
          &wt[(kc * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) * BLD +
              wn * NT * 8];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int t0 = wn * NT + 2 * np;   // this pair's first column tile
        if (t0 + 1 < n_tiles) {
          uint32_t b[4];
          tc::ldmatrix_x4_trans(b, wrow + np * 16 + (lane / 16) * 8);
          tc::mma_bf16(acc[2 * np], a, b[0], b[1]);
          tc::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        } else if (t0 < n_tiles) {
          uint32_t b[2];
          tc::ldmatrix_x2_trans(b, wrow + np * 16);
          tc::mma_bf16(acc[2 * np], a, b[0], b[1]);
        }
      }
    }
  }

  // each partial row goes to the rank that owns it (rank q's into slot
  // q), so that one barrier suffices and no block reads a peer after it
  const int rs = (TM_ + split - 1) / split;   // rows a slot
  if (split > 1) tc::cluster_wait();         // every peer runs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wm * 16 + g + 8 * h;
    const int owner = ((row + 1) * split - 1) / TM_;
    float* slot = split > 1 ? cluster.map_shared_rank(red, owner) : red;
    slot += (rank * rs + row - owner * TM_ / split) * PLD;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      *reinterpret_cast<float2*>(&slot[(wn * NT + t) * 8 + 2 * tg]) =
          make_float2(acc[t][2 * h], acc[t][2 * h + 1]);
  }
  if (split > 1) {
    tc::cluster_arrive();                    // the partials are written
    tc::cluster_wait();
  } else {
    __syncthreads();
  }

  // rows [r0, r1): the slots summed in rank order, then (int8) the scale,
  // then pw_b, residual and ReLU in f32, one round to bf16, 16-byte stores
#pragma unroll
  for (int i = 0; i < E_ITEMS; ++i) {
    if (e_out[i] < 0) continue;
    const int e = tid + i * MMA_THREADS;
    const int row = r0 + e / TG, c = (e % TG) * 8;
    float v[8];
    dw::zero8(v);
    for (int q = 0; q < split; ++q) {
      const float* pq = &red[(q * rs + row - r0) * PLD + c];
      const float4 a = *reinterpret_cast<const float4*>(pq);
      const float4 b = *reinterpret_cast<const float4*>(pq + 4);
      v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
      v[4] += b.x; v[5] += b.y; v[6] += b.z; v[7] += b.w;
    }
    float bf[8], rf[8];
    dw::unpack8(e_bias[i], bf);
    dw::unpack8(e_res[i], rf);
    if constexpr (CODES) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(v[j], scl[c + j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] += bf[j];
      if (res != nullptr) v[j] += rf[j];
      if (relu) v[j] = fmaxf(v[j], 0.f);
    }
    *reinterpret_cast<uint4*>(out + e_out[i]) = dw::pack8(v);
  }
}

// ---- launch ----------------------------------------------------------------

struct DwPwArgs {
  const __nv_bfloat16* x;
  const void *dw_w, *dw_b, *pw_w, *pw_b;   // of the stored weight types
  const __nv_bfloat16* res;
  const float* scale;
  __nv_bfloat16* out;
  int N, H, W, C, Ho, Wo, k, stride, pad_h, pad_w, Cout, dw_relu, relu;
};

// K = 0: the run-time kernel size a.k
template <int K, typename WT>
int launch_simt(const DwPwArgs& a, cudaStream_t stream) {
  using PT = typename wtypes::Param<WT>::type;
  const int M = a.N * a.Ho * a.Wo;
  dim3 grid((M + TM - 1) / TM, (a.Cout + TN_SIMT - 1) / TN_SIMT);
  dw_pw_simt<K, WT><<<grid, THREADS, 0, stream>>>(
      a.x, (const PT*)a.dw_w, (const PT*)a.dw_b, (const WT*)a.pw_w,
      (const PT*)a.pw_b, a.res, a.scale, a.out, a.N, a.H, a.W, a.C, a.Ho,
      a.Wo, a.stride, a.pad_h, a.pad_w, a.Cout, a.dw_relu, a.relu, a.k);
  return (int)cudaGetLastError();
}

template <int K, int TM_, int TN, typename WT>
int launch_mma(const DwPwArgs& a, int tr, int tw, int ck, int split,
               cudaStream_t stream) {
  const int hr = (tr - 1) * a.stride + K, hc = (tw - 1) * a.stride + K;
  const MmaSmem L(K, TM_, TN, hr, hc, ck, split, sizeof(WT) == 1);
  if (L.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;   // what this instance may take now
  if (L.total > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_pw_mma<K, TM_, TN, WT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    smem_set = SMEM_MAX;
  }
  const int tiles_y = (a.Ho + tr - 1) / tr, tiles_x = (a.Wo + tw - 1) / tw;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.N * tiles_y * tiles_x, (a.Cout + TN - 1) / TN, split);
  cfg.blockDim = dim3(2 * TN);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1;              // split 1: no cluster, no barrier
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dw_pw_mma<K, TM_, TN, WT>, a.x, (const __nv_bfloat16*)a.dw_w,
      (const __nv_bfloat16*)a.dw_b, (const WT*)a.pw_w,
      (const __nv_bfloat16*)a.pw_b, a.res, a.scale, a.out, a.H, a.W, a.C,
      a.Ho, a.Wo, a.stride, a.pad_h, a.pad_w, a.Cout, a.dw_relu, a.relu, tr,
      tw, ck, tiles_y, tiles_x);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <int K, int TN, typename WT>
int launch_tm(const DwPwArgs& a, int tm, int tr, int tw, int ck, int split,
              cudaStream_t s) {
  switch (tm) {
    case 16: return launch_mma<K, 16, TN, WT>(a, tr, tw, ck, split, s);
    case 32: return launch_mma<K, 32, TN, WT>(a, tr, tw, ck, split, s);
    case 64: return launch_mma<K, 64, TN, WT>(a, tr, tw, ck, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int K, typename WT>
int launch(const DwPwArgs& a, int variant, int tm, int tn, int tr, int tw,
           int ck, int split, cudaStream_t s) {
  if (variant == VARIANT_SIMT) return launch_simt<K, WT>(a, s);
  if constexpr (sizeof(WT) == 4) {
    return (int)cudaErrorInvalidValue;     // f32 weights: simt only
  } else {
    if (tn == 64) return launch_tm<K, 64, WT>(a, tm, tr, tw, ck, split, s);
    return launch_tm<K, 128, WT>(a, tm, tr, tw, ck, split, s);
  }
}

// The simt variant with k at run time, every stored type: k past K_MAX,
// and int8 and f32 weights at every k but QUANT_K
int launch_runtime_k(const DwPwArgs& a, int wtype, cudaStream_t s) {
  if (wtype == wtypes::BF16) return launch_simt<0, __nv_bfloat16>(a, s);
  if (wtype == wtypes::INT8) return launch_simt<0, int8_t>(a, s);
  return launch_simt<0, float>(a, s);
}

// k = QUANT_K (the MobileNets' depthwise) has templated instances for
// every stored type; the other k for bf16 only
constexpr int QUANT_K = 3;

template <int K>
int launch_k(const DwPwArgs& a, int wtype, int variant, int tm, int tn,
             int tr, int tw, int ck, int split, cudaStream_t s) {
  if (wtype == wtypes::BF16)
    return launch<K, __nv_bfloat16>(a, variant, tm, tn, tr, tw, ck, split,
                                    s);
  if constexpr (K == QUANT_K) {
    if (wtype == wtypes::INT8)
      return launch<K, int8_t>(a, variant, tm, tn, tr, tw, ck, split, s);
    return launch<K, float>(a, variant, tm, tn, tr, tw, ck, split, s);
  } else {
    return launch_runtime_k(a, wtype, s);   // simt (checked by the caller)
  }
}

}  // namespace

extern "C" {

// All tensors contiguous on the device: x (N,H,W,C) bf16; pw_w (C,Cout)
// of the stored type wtype (0 bf16, 1 int8 codes, 2 f32); dw_w (k,k,C),
// dw_b (C,) and pw_b (Cout,) f32 with f32 pw_w, else bf16; res
// (N,Ho,Wo,Cout) bf16 or null; scale (Cout,) f32 with int8 pw_w, else
// null; out like res; N*H*W*C and N*Ho*Wo*Cout < 2^31; k >= 1 (past 7
// the simt variant only). variant 0: simt (tm, tn, tr, tw, ck, split
// unused). variant 1: mma (bf16 at k <= 7, int8 at k = 3; C % 8 == 0,
// Cout % 8 == 0,
// every pointer 16-byte aligned; tm 16, 32 or 64; tn 64 or 128; tr * tw
// <= tm; ck 32 or 64; split 1..8 <= ceil(C / ck); the shared memory
// within the limit). Anything else returns cudaErrorInvalidValue; else
// cudaGetLastError() after the launch.
int dw_pw_launch(const void* x, const void* dw_w, const void* dw_b,
                 const void* pw_w, const void* pw_b, const void* res,
                 const void* scale, void* out, int N, int H, int W, int C,
                 int Ho, int Wo, int k, int stride, int pad_h, int pad_w,
                 int Cout, int dw_relu, int relu, int wtype, int variant,
                 int tm, int tn, int tr, int tw, int ck, int split,
                 void* stream) {
  const DwPwArgs a = {(const __nv_bfloat16*)x, dw_w, dw_b, pw_w, pw_b,
                      (const __nv_bfloat16*)res, (const float*)scale,
                      (__nv_bfloat16*)out, N, H, W, C, Ho, Wo, k, stride,
                      pad_h, pad_w, Cout, dw_relu, relu};
  const cudaStream_t s = (cudaStream_t)stream;
  if (wtype < wtypes::BF16 || wtype > wtypes::F32 ||
      (scale != nullptr) != (wtype == wtypes::INT8))
    return (int)cudaErrorInvalidValue;
  if (N * Ho * Wo == 0 || Cout == 0) return 0;
  if (k < 1 || stride < 1 || C < 1 || (Cout + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  if (variant == VARIANT_MMA) {
    if (k > K_MAX || (wtype != wtypes::BF16 && k != QUANT_K) || C % 8 ||
        Cout % 8 || (ck != 32 && ck != 64) ||
        (tn != 64 && tn != 128) || tr < 1 || tw < 1 ||
        tr * tw > tm || split < 1 || split > MAX_SPLIT ||
        split > (C + ck - 1) / ck)
      return (int)cudaErrorInvalidValue;
  } else if (variant != VARIANT_SIMT) {
    return (int)cudaErrorInvalidValue;
  }
  if (k > K_MAX) return launch_runtime_k(a, wtype, s);
  switch (k) {
    case 1: return launch_k<1>(a, wtype, variant, tm, tn, tr, tw, ck, split, s);
    case 2: return launch_k<2>(a, wtype, variant, tm, tn, tr, tw, ck, split, s);
    case 3: return launch_k<3>(a, wtype, variant, tm, tn, tr, tw, ck, split, s);
    case 4: return launch_k<4>(a, wtype, variant, tm, tn, tr, tw, ck, split, s);
    case 5: return launch_k<5>(a, wtype, variant, tm, tn, tr, tw, ck, split, s);
    case 6: return launch_k<6>(a, wtype, variant, tm, tn, tr, tw, ck, split, s);
    default:
      return launch_k<7>(a, wtype, variant, tm, tn, tr, tw, ck, split, s);
  }
}

const char* dw_pw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
