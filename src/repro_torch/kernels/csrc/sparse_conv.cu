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
// Stored weights (a template argument, weights.cuh): bf16; int8 codes,
// whose (ob, bn) f32 scale multiplies the f32 sum once in the epilogue,
// before bias and residual (the Pallas flush, sparse_conv.py:117-121;
// under split-K, the full sum after the rank-ordered reduction, never a
// partial); or f32 with an f32 bias (simt only).
//
// The TPU kernel walks K as the innermost, sequential grid axis and
// carries a VMEM accumulator between grid steps. Here one block owns TM
// output pixels of one output block column and runs (its share of) the
// K loop inside, the accumulator in registers. The gather reads the
// unpadded NHWC input and puts zero where a tap falls in the SAME halo,
// so neither a padded copy nor an im2col tensor exists; the flat block
// id is decoded into (ky, kx, cb) here, as conv_block_coords does. Two
// variants, chosen in Python (sparse_conv.variant) and passed in:
//
// Both variants walk a stored block of any size as PIECE x PIECE (32 x 32)
// pieces: a thread block owns one 32-column piece of one output block
// column (grid y = ob * ceil(bn / 32)), and its K loop runs over the
// surviving blocks' row pieces, ceil(bm / 32) of them a block, so shared
// memory and registers stay those of a 32 x 32 block whatever the block
// (SparsityConfig's default 128 x 128: a 128-row block at tap (ky, kx) is
// four consecutive 32-channel gathers; the ragged last piece of a side
// that is no multiple of 32 is masked).
//
// "mma" (bf16 or int8 weights; bm a multiple of 16 and bn of 8, any size:
// ResNet-50's 32 x 32 blocks and, at SparsityConfig's default, its 128 x
// 128 and 64 x 64 ones). 4 warps; TM (16 or 32, from sparse_conv.plan)
// pixels x 32 columns, the warps laid out as TM/16 along the pixels and
// 64/TM along the columns. A 4-stage cp.async ring brings each row
// piece's gathered TM x 32 tile (one pixel's 32 channels are 64
// contiguous bytes: 16-byte copies, zero-filled by the source-size-0
// form in the halo and past the last pixel) and its 32 x 32 weight
// piece into shared memory, 3 steps ahead of the products. A fragments
// come from ldmatrix, B fragments from ldmatrix.trans, and
// mma.sync.m16n8k16 sums in f32 (bf16 x bf16 products are exact in
// f32). The block's idx entries come in before the loop, 32 a warp in
// registers, handed out by shuffles, so no gather waits on an idx load.
// int8 weights: cp.async copies bytes and cannot widen, so the ring holds
// the 32 x 32 codes (8-byte copies, rows of 40 bytes) and each thread
// builds its B fragments from them (4 byte loads and 2 conversions per
// fragment, exact in bf16): half the weight bytes from device memory, no
// extra barrier, the same mma.sync on bf16.
// Split-K: the grid's third axis is a thread-block cluster of S <= 8
// blocks (no cluster at S = 1), over the K * ceil(bm / 32) row-piece
// steps; block (rank r) walks steps [r*KS/S,
// (r+1)*KS/S) and owns rows [r*TM/S, (r+1)*TM/S) of the tile. Each block
// writes each f32 partial row into its owner's shared memory (slot =
// the writer's rank) through distributed shared memory; after one
// cluster barrier each block sums its slots in rank order, applies the
// epilogue (bias and residual were loaded before the K loop) and writes
// 16-byte rows. Deterministic, one launch, no workspace, and no block
// touches a peer after the barrier, so none waits for another to exit.
//
// "simt" (any other blocks: any bm that divides C, any bn; and f32
// weights): f32 FMAs on the CUDA cores, grid (ceil(M/64), ob * ceil(bn /
// 32)), 256 threads, all the row-piece steps in each block; a step's
// loads are issued together into registers, and the next step's before
// this step's FMAs.
//
// What bounds it. At batch 1 a ResNet-50 layer does about
// 2*M*ob*K*bm*bn operations on bf16 inputs while moving the activation,
// the surviving blocks and the output once each; operations per byte
// stay far below the card's ridge point, so the bound is bytes over the
// memory rate (chip_smoke.py computes it per layer; PERF.md holds it),
// 0.1-0.6 us a layer. What sets the time is latency: a launch, then K
// dependent rounds of gather and product. The mma variant overlaps 3
// rounds and cuts the chain to at most 3 steps a block through split-K
// (the plan), where the simt kernel walked all K. At 128 x 128 blocks a
// surviving block is 4 steps and each of a column's 4 column pieces
// gathers the same x tiles again (from L2), so the chain is 4x as long
// and the L2 -> SM traffic 4x the activation; the plan splits the longer
// chain over the cluster.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "weights.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int VARIANT_SIMT = 0;   // the codes of _build.VARIANT_CODES
constexpr int VARIANT_MMA = 1;

constexpr int PIECE = 32;     // a step's rows (input channels) and a
                              // block's columns (output channels) at most

// The row pieces of a bm-row block and the column pieces of a bn-column
// one: ceil(side / PIECE).
__host__ __device__ constexpr int pieces(int side) {
  return (side + PIECE - 1) / PIECE;
}

// ---- simt: CUDA cores, any blocks ------------------------------------------

constexpr int TM = 64;        // output pixels per block
constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / PIECE;    // 8 pixel rows per pass
constexpr int ROWS = TM / ROW_STEP;          // 8 accumulators per thread
constexpr int W_LOADS = PIECE * PIECE / THREADS;   // 4 per thread per step
constexpr int X_LOADS = TM * PIECE / THREADS;      // 8 per thread per step

template <typename WT>
__global__ void __launch_bounds__(THREADS)
sparse_conv_simt(const __nv_bfloat16* __restrict__ x,
                   const WT* __restrict__ vals,
                   const int32_t* __restrict__ idx,
                   const typename wtypes::Param<WT>::type* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ res,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out,
                   int N, int H, int W, int C, int Ho, int Wo, int k,
                   int stride, int pad_h, int pad_w, int ob, int K, int bm,
                   int bn, int relu) {
  __shared__ float xs[TM * (PIECE + 1)];
  __shared__ float ws[PIECE * PIECE];
  const int pm = pieces(bm), pn = pieces(bn);
  const int j = blockIdx.y / pn;
  const int n0 = (blockIdx.y % pn) * PIECE;   // this block's column piece
  const int cols = min(PIECE, bn - n0);
  const int m0 = blockIdx.x * TM;
  const int M = N * Ho * Wo;
  const int tid = threadIdx.x;
  const int col = tid % PIECE;
  const int row = tid / PIECE;
  const int cpb = C / bm;   // channel blocks per kernel position
  // a full piece's rows and columns; a ragged last piece masks the rest
  const int pr = min(bm, PIECE), pc = min(bn, PIECE);

  // What this thread loads is the same at every step but for the tap
  // (ky, kx), the channel block and the row piece, so its shared-memory
  // slots, its piece coordinates and its pixels' input origins are worked
  // out once. A slot of -1 is unused; an origin row of INT_MIN/2 marks a
  // pixel past the last one (loads 0).
  int w_slot[W_LOADS], w_r[W_LOADS], w_c[W_LOADS];
#pragma unroll
  for (int u = 0; u < W_LOADS; ++u) {
    const int e = tid + u * THREADS;
    w_r[u] = e / pc;
    w_c[u] = e % pc;
    w_slot[u] = e < pr * pc ? w_r[u] * PIECE + w_c[u] : -1;
  }
  int x_slot[X_LOADS], x_c[X_LOADS], x_img[X_LOADS], x_iy[X_LOADS],
      x_ix[X_LOADS];
#pragma unroll
  for (int u = 0; u < X_LOADS; ++u) {
    const int e = tid + u * THREADS;
    const int m = e / pr, c = e % pr, p = m0 + m;
    x_slot[u] = e < TM * pr ? m * (PIECE + 1) + c : -1;
    x_c[u] = c;
    x_img[u] = 0;
    x_iy[u] = INT_MIN / 2;
    x_ix[u] = 0;
    if (e < TM * pr && p < M) {
      const int ox = p % Wo, t = p / Wo;
      x_img[u] = (t / Ho) * H;
      x_iy[u] = (t % Ho) * stride - pad_h;
      x_ix[u] = ox * stride - pad_w;
    }
  }

  // Step s (row piece s % pm of surviving block s / pm) lands in
  // registers: every load of a step is issued before the first is used,
  // and the next step's are issued before this step's FMAs, so their
  // latencies overlap instead of adding up.
  float wv[W_LOADS], xv[X_LOADS];
  auto load = [&](int s) {
    const int l = s / pm, rb = (s % pm) * PIECE;
    const int rows = min(PIECE, bm - rb);
    const int blk = idx[j * K + l];
    const int pos = blk / cpb;
    const int ky = pos / k, kx = pos % k;
    const int c0 = (blk % cpb) * bm + rb;
    const WT* wb = vals + ((size_t)j * K + l) * bm * bn + (size_t)rb * bn +
                   n0;
#pragma unroll
    for (int u = 0; u < W_LOADS; ++u)
      wv[u] = w_slot[u] >= 0 && w_r[u] < rows && w_c[u] < cols
                  ? wtypes::to_f32(wb[w_r[u] * bn + w_c[u]])
                  : 0.f;
#pragma unroll
    for (int u = 0; u < X_LOADS; ++u) {
      const int iy = x_iy[u] + ky, ix = x_ix[u] + kx;
      xv[u] = (x_c[u] < rows && iy >= 0 && iy < H && ix >= 0 && ix < W)
                  ? __bfloat162float(
                        x[((size_t)(x_img[u] + iy) * W + ix) * C + c0 + x_c[u]])
                  : 0.f;   // the SAME halo, a pixel past the last, or
                           // channels past a ragged last piece
    }
  };

  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;

  const int steps = K * pm;
  if (steps > 0) load(0);
  for (int s = 0; s < steps; ++s) {
    __syncthreads();   // the previous step's tiles are consumed
#pragma unroll
    for (int u = 0; u < W_LOADS; ++u)
      if (w_slot[u] >= 0) ws[w_slot[u]] = wv[u];
#pragma unroll
    for (int u = 0; u < X_LOADS; ++u)
      if (x_slot[u] >= 0) xs[x_slot[u]] = xv[u];
    __syncthreads();
    if (s + 1 < steps) load(s + 1);
    const int rows = min(PIECE, bm - (s % pm) * PIECE);
    if (col < cols) {
      for (int c = 0; c < rows; ++c) {
        const float w = ws[c * PIECE + col];
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          acc[i] = fmaf(xs[(row + i * ROW_STEP) * (PIECE + 1) + c], w,
                        acc[i]);
      }
    }
  }

  if (col >= cols) return;
  const int cout = ob * bn;
  const int co = j * bn + n0 + col;
  const float b = wtypes::to_f32(bias[co]);
  const float sc = scale != nullptr ? scale[co] : 1.f;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int p = m0 + row + i * ROW_STEP;
    if (p >= M) continue;
    const size_t o = (size_t)p * cout + co;
    // int8: the code sum times its scale, rounded before the bias joins
    float y = (scale != nullptr ? __fmul_rn(acc[i], sc) : acc[i]) + b;
    if (res != nullptr) y += __bfloat162float(res[o]);
    if (relu) y = fmaxf(y, 0.f);
    out[o] = __float2bfloat16(y);
  }
}

// ---- mma: tensor cores, cluster split-K ----------------------------------

constexpr int MMA_THREADS = 128;
constexpr int STAGES = 4;                // the cp.async ring
constexpr int XLD = PIECE + 8;           // row strides (elements) of the
constexpr int WLD = PIECE + 8;           // staged tiles: 80 B, 16-aligned
constexpr int W8LD = PIECE + 8;          // an int8 tile's row: 40 B
constexpr int PLD = PIECE + 4;           // row stride (floats) of a partial
constexpr int MAX_SPLIT = 8;             // the portable cluster size

// WT: __nv_bfloat16, or int8_t codes with their scale. ONE: the block
// is one piece (bm, bn <= PIECE: every block of the 32 x 32 ResNet-50),
// so the piece arithmetic folds away at compile time and the K loop is
// the one-piece loop of the kernel before blocks were split into pieces.
template <int TM_, typename WT, bool ONE>
__global__ void __launch_bounds__(MMA_THREADS)
sparse_conv_mma(const __nv_bfloat16* __restrict__ x,
                const WT* __restrict__ vals,
                const int32_t* __restrict__ idx,
                const __nv_bfloat16* __restrict__ bias,
                const __nv_bfloat16* __restrict__ res,
                const float* __restrict__ scale,
                __nv_bfloat16* __restrict__ out, int N, int H, int W, int C,
                int Ho, int Wo, int k, int stride, int pad_h, int pad_w,
                int ob, int K, int bm, int bn, int relu) {
  constexpr int WM = TM_ / 16;           // warps along the pixels
  constexpr int NT = TM_ / 16;           // 8-column tiles a warp owns
  constexpr int XS = TM_ * XLD, WS = PIECE * WLD;
  constexpr int X_LOADS = (TM_ * (PIECE / 8) + MMA_THREADS - 1) /
                          MMA_THREADS;
  // epilogue items (a row's 8 columns) a thread at most, at split 1
  constexpr int E_ITEMS = (TM_ * (PIECE / 8) + MMA_THREADS - 1) /
                          MMA_THREADS;
  constexpr bool CODES = sizeof(WT) == 1;
  // stage st: the gathered x tile at ring + st * (XS + WS), then the
  // weight piece (int8: PIECE rows of W8LD bytes at its start)
  __shared__ __align__(128) __nv_bfloat16 ring[STAGES * (XS + WS)];
  // the partials of this block's rows: slot q (rank q's), ceil(TM/S)
  // rows of PLD floats each
  __shared__ __align__(16) float red[(TM_ + MAX_SPLIT - 1) * PLD];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int pm = ONE ? 1 : pieces(bm), pn = ONE ? 1 : pieces(bn);
  const int j = blockIdx.y / pn;
  const int n0 = (blockIdx.y % pn) * PIECE;  // this block's column piece
  const int m0 = blockIdx.x * TM_;
  const int M = N * Ho * Wo;
  // the steps: row piece s % pm of surviving block s / pm, K * pm of them
  const int steps = K * pm;
  const int lo = rank * steps / split;
  const int n = (rank + 1) * steps / split - lo;   // this block's steps
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane / 4, tg = lane % 4;
  const int cpb = C / bm;                  // channel blocks a tap
  const int xc = min(bm, PIECE) / 8;       // 16-byte chunks a full piece row
  const int wc = min(PIECE, bn - n0) / 8;  // ... and of this column piece
  const int n_tiles = wc;
  const int cout = ob * bn;
  const int cb0 = j * bn + n0;             // this piece's first channel out
  // this block's output rows [r0, r1) of the tile, summed over the
  // cluster; each (row, 8 columns) item's bias and residual are loaded
  // now, so the epilogue waits on no global load
  const int r0 = rank * TM_ / split, r1 = (rank + 1) * TM_ / split;
  if (split > 1) tc::cluster_arrive_relaxed();   // this block runs
  uint4 e_bias[E_ITEMS], e_res[E_ITEMS];
  float4 e_scale[E_ITEMS][2];   // int8: the item's 8 scales
#pragma unroll
  for (int i = 0; i < E_ITEMS; ++i) {
    const int e = tid + i * MMA_THREADS;
    const int row = r0 + e / wc, c = (e % wc) * 8, p = m0 + row;
    e_bias[i] = e_res[i] = make_uint4(0, 0, 0, 0);
    if (row < r1 && p < M) {
      e_bias[i] = *reinterpret_cast<const uint4*>(bias + cb0 + c);
      if (res != nullptr)
        e_res[i] = *reinterpret_cast<const uint4*>(
            res + (size_t)p * cout + cb0 + c);
      if constexpr (CODES) {
        e_scale[i][0] = *reinterpret_cast<const float4*>(scale + cb0 + c);
        e_scale[i][1] = *reinterpret_cast<const float4*>(scale + cb0 + c + 4);
      }
    }
  }

  // This thread's x chunks, the same at every step but for the tap, the
  // channel block and the row piece: shared-memory slot (-1: none), image
  // row base, the pixel's input origin (INT_MIN/2: past the last pixel)
  // and channel in the piece.
  int x_dst[X_LOADS], x_img[X_LOADS], x_iy[X_LOADS], x_ix[X_LOADS],
      x_c[X_LOADS];
#pragma unroll
  for (int u = 0; u < X_LOADS; ++u) {
    const int e = tid + u * MMA_THREADS;
    const int r = e / xc, p = m0 + r;
    x_dst[u] = e < TM_ * xc ? r * XLD + (e % xc) * 8 : -1;
    x_c[u] = (e % xc) * 8;
    x_img[u] = 0;
    x_iy[u] = INT_MIN / 2;
    x_ix[u] = 0;
    if (e < TM_ * xc && p < M) {
      const int ox = p % Wo, t = p / Wo;
      x_img[u] = (t / Ho) * H;
      x_iy[u] = (t % Ho) * stride - pad_h;
      x_ix[u] = ox * stride - pad_w;
    }
  }

  // idx[j, blo + b] for the blocks b of this window of 32 (iw0) and the
  // next (iw1), lane b % 32 holding block b; blocks are asked for in
  // order (a block's row pieces are consecutive steps)
  const int blo = lo / pm;
  const int nb = n > 0 ? (lo + n - 1) / pm - blo + 1 : 0;  // blocks touched
  const int32_t* irow = idx + (size_t)j * K + blo;
  int iw0 = lane < nb ? irow[lane] : 0;
  int iw1 = 32 + lane < nb ? irow[32 + lane] : 0;

  auto load = [&](int s, int st) {
    const int b = (lo + s) / pm - blo, rb = ((lo + s) % pm) * PIECE;
    if (b > 0 && b % 32 == 0 && rb == 0) {
      iw0 = iw1;
      iw1 = b + 32 + lane < nb ? irow[b + 32 + lane] : 0;
    }
    const int rows = min(PIECE, bm - rb);
    const int blk = __shfl_sync(0xffffffffu, iw0, b % 32);
    const int pos = blk / cpb;
    const int ky = pos / k, kx = pos % k;
    const int c0 = (blk % cpb) * bm + rb;
    __nv_bfloat16* xs = ring + st * (XS + WS);
    __nv_bfloat16* ws = xs + XS;
#pragma unroll
    for (int u = 0; u < X_LOADS; ++u) {
      if (x_dst[u] < 0 || x_c[u] >= rows) continue;
      const int iy = x_iy[u] + ky, ix = x_ix[u] + kx;
      const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
      tc::cp_async16(xs + x_dst[u],
                     in ? x + ((size_t)(x_img[u] + iy) * W + ix) * C + c0 +
                              x_c[u]
                        : x,
                     in);   // the SAME halo, or a pixel past the last
    }
    const WT* wb = vals + ((size_t)j * K + blo + b) * bm * bn +
                   (size_t)rb * bn + n0;
    for (int e = tid; e < rows * wc; e += MMA_THREADS) {
      const int r = e / wc, c = (e % wc) * 8;
      if constexpr (CODES)
        tc::cp_async8(reinterpret_cast<int8_t*>(ws) + r * W8LD + c,
                      wb + r * bn + c, true);
      else
        tc::cp_async16(ws + r * WLD + c, wb + r * bn + c, true);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, s);
    tc::cp_async_commit();                 // empty groups keep the count
  }
  for (int s = 0; s < n; ++s) {
    tc::cp_async_wait<STAGES - 2>();       // step s has landed
    __syncthreads();                       // and step s - 1 is consumed
    if (s + STAGES - 1 < n) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    tc::cp_async_commit();
    const __nv_bfloat16* xt = ring + (s % STAGES) * (XS + WS);
    const __nv_bfloat16* wt = xt + XS;
    const int rows = min(PIECE, bm - ((lo + s) % pm) * PIECE);
#pragma unroll
    for (int kc = 0; kc < PIECE / 16; ++kc) {
      if (kc * 16 >= rows) break;
      uint32_t a[4];
      tc::ldmatrix_x4(a, &xt[(wm * 16 + (lane % 8) + ((lane / 8) % 2) * 8) *
                                 XLD + kc * 16 + (lane / 16) * 8]);
      if constexpr (CODES) {
        // B fragment of column tile t: rows kc*16 + 2tg, +1 (b0) and +8,
        // +9 (b1) of column 8t + g, each code widened to bf16
        const int8_t* w8 =
            reinterpret_cast<const int8_t*>(wt) + (kc * 16 + 2 * tg) * W8LD;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int tile = wn * NT + t;
          if (tile >= n_tiles) continue;
          const int8_t* wc8 = w8 + tile * 8 + g;
          tc::mma_bf16(acc[t], a, tc::pack_codes(wc8[0], wc8[W8LD]),
                       tc::pack_codes(wc8[8 * W8LD], wc8[9 * W8LD]));
        }
        continue;
      }
      const __nv_bfloat16* wrow =
          &wt[(kc * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) * WLD +
              wn * NT * 8];
#pragma unroll
      for (int np = 0; np < (NT + 1) / 2; ++np) {
        const int t0 = wn * NT + 2 * np;   // this pair's first column tile
        if (NT > 1 && t0 + 1 < n_tiles) {
          uint32_t b[4];
          tc::ldmatrix_x4_trans(b, wrow + np * 16 + (lane / 16) * 8);
          tc::mma_bf16(acc[2 * np], a, b[0], b[1]);
          tc::mma_bf16(acc[(2 * np + 1) % NT], a, b[2], b[3]);
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
  // then bias, residual and ReLU in f32, one round to bf16, 16-byte stores
#pragma unroll
  for (int i = 0; i < E_ITEMS; ++i) {
    const int e = tid + i * MMA_THREADS;
    const int row = r0 + e / wc, c = (e % wc) * 8, p = m0 + row;
    if (row >= r1 || p >= M) continue;
    float v[8];
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8) v[k8] = 0.f;
    for (int q = 0; q < split; ++q) {
      const float* pq = &red[(q * rs + row - r0) * PLD + c];
      const float4 a = *reinterpret_cast<const float4*>(pq);
      const float4 b = *reinterpret_cast<const float4*>(pq + 4);
      v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
      v[4] += b.x; v[5] += b.y; v[6] += b.z; v[7] += b.w;
    }
    if constexpr (CODES) {
      const float* sc = reinterpret_cast<const float*>(e_scale[i]);
#pragma unroll
      for (int k8 = 0; k8 < 8; ++k8) v[k8] = __fmul_rn(v[k8], sc[k8]);
    }
    const __nv_bfloat162* b2 =
        reinterpret_cast<const __nv_bfloat162*>(&e_bias[i]);
    const __nv_bfloat162* r2 =
        reinterpret_cast<const __nv_bfloat162*>(&e_res[i]);
    uint4 ov;
    uint32_t* o32 = reinterpret_cast<uint32_t*>(&ov);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      const float2 bf = __bfloat1622float2(b2[k2]);
      float y0 = v[2 * k2] + bf.x, y1 = v[2 * k2 + 1] + bf.y;
      if (res != nullptr) {
        const float2 rf = __bfloat1622float2(r2[k2]);
        y0 += rf.x;
        y1 += rf.y;
      }
      if (relu) {
        y0 = fmaxf(y0, 0.f);
        y1 = fmaxf(y1, 0.f);
      }
      o32[k2] = tc::pack_bf16(y0, y1);
    }
    *reinterpret_cast<uint4*>(out + (size_t)p * cout + cb0 + c) = ov;
  }
}

// ---- launch ----------------------------------------------------------------

struct ConvArgs {
  const __nv_bfloat16* x;
  const void *vals, *bias;     // of the stored weight type (and its bias)
  const int32_t* idx;
  const __nv_bfloat16* res;
  const float* scale;
  __nv_bfloat16* out;
  int N, H, W, C, Ho, Wo, k, stride, pad_h, pad_w, ob, K, bm, bn, relu;
};

template <int TM_, typename WT, bool ONE>
int launch_mma(const ConvArgs& a, int split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3((a.N * a.Ho * a.Wo + TM_ - 1) / TM_, a.ob * pieces(a.bn), split);
  cfg.blockDim = dim3(MMA_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1;              // split 1: no cluster, no barrier
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, sparse_conv_mma<TM_, WT, ONE>, a.x, (const WT*)a.vals, a.idx,
      (const __nv_bfloat16*)a.bias, a.res, a.scale, a.out, a.N, a.H, a.W,
      a.C, a.Ho, a.Wo, a.k, a.stride, a.pad_h, a.pad_w, a.ob, a.K, a.bm,
      a.bn, a.relu);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <typename WT>
int launch_simt(const ConvArgs& a, cudaStream_t stream) {
  dim3 grid((a.N * a.Ho * a.Wo + TM - 1) / TM, a.ob * pieces(a.bn));
  sparse_conv_simt<WT><<<grid, THREADS, 0, stream>>>(
      a.x, (const WT*)a.vals, a.idx,
      (const typename wtypes::Param<WT>::type*)a.bias, a.res, a.scale, a.out,
      a.N, a.H, a.W, a.C, a.Ho, a.Wo, a.k, a.stride, a.pad_h, a.pad_w, a.ob,
      a.K, a.bm, a.bn, a.relu);
  return (int)cudaGetLastError();
}

template <typename WT, bool ONE>
int launch_mma_tm(const ConvArgs& a, int tm, int split, cudaStream_t s) {
  switch (tm) {
    case 16: return launch_mma<16, WT, ONE>(a, split, s);
    case 32: return launch_mma<32, WT, ONE>(a, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename WT>
int launch_mma_blocks(const ConvArgs& a, int tm, int split, cudaStream_t s) {
  return a.bm <= PIECE && a.bn <= PIECE
             ? launch_mma_tm<WT, true>(a, tm, split, s)
             : launch_mma_tm<WT, false>(a, tm, split, s);
}

}  // namespace

extern "C" {

// All tensors contiguous on the device: x (N,H,W,C) bf16; vals
// (ob,K,bm,bn) of the stored type wtype (0 bf16, 1 int8 codes, 2 f32);
// idx (ob,K) int32 flat HWIO block ids; bias (ob*bn,) f32 with f32
// vals, else bf16; res (N,Ho,Wo,ob*bn) bf16 or null; scale (ob,bn) f32
// with int8 vals, else null; out like res; N*H*W*C and N*Ho*Wo*ob*bn <
// 2^31; bm divides C; ob * ceil(bn / 32) <= 65535. variant: 0 simt (tm
// 64, split 1; any bm, bn), 1 mma (bf16 or int8; bm % 16 == 0, bn % 8 ==
// 0; tm 16 or 32; split 1..8 <= K * ceil(bm / 32); x, vals, bias, res,
// scale and out 16-byte aligned). Anything else returns
// cudaErrorInvalidValue; else cudaGetLastError() after the launch.
int sparse_conv_launch(const void* x, const void* vals, const void* idx,
                       const void* bias, const void* res, const void* scale,
                       void* out, int N, int H, int W, int C, int Ho, int Wo,
                       int k, int stride, int pad_h, int pad_w, int ob, int K,
                       int bm, int bn, int relu, int wtype, int variant,
                       int tm, int split, void* stream) {
  const ConvArgs a = {(const __nv_bfloat16*)x, vals, bias,
                      (const int32_t*)idx, (const __nv_bfloat16*)res,
                      (const float*)scale, (__nv_bfloat16*)out, N, H, W, C,
                      Ho, Wo, k, stride, pad_h, pad_w, ob, K, bm, bn, relu};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bm < 1 || bn < 1 || C % bm || (long long)ob * pieces(bn) > 65535 ||
      wtype < wtypes::BF16 || wtype > wtypes::F32 ||
      (scale != nullptr) != (wtype == wtypes::INT8))
    return (int)cudaErrorInvalidValue;
  if (variant == VARIANT_SIMT && tm == TM && split == 1) {
    switch (wtype) {
      case wtypes::BF16: return launch_simt<__nv_bfloat16>(a, s);
      case wtypes::INT8: return launch_simt<int8_t>(a, s);
      default: return launch_simt<float>(a, s);
    }
  }
  if (variant != VARIANT_MMA || wtype == wtypes::F32 || bm % 16 || bn % 8 ||
      split < 1 || split > MAX_SPLIT ||
      split > (K > 0 ? K * pieces(bm) : 1))
    return (int)cudaErrorInvalidValue;
  return wtype == wtypes::INT8
             ? launch_mma_blocks<int8_t>(a, tm, split, s)
             : launch_mma_blocks<__nv_bfloat16>(a, tm, split, s);
}

const char* sparse_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
