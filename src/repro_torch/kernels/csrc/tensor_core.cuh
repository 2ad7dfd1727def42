// Tensor-core building blocks for the port's kernels (sm_90a), as inline
// PTX: cp.async copies into shared memory (16 bytes, and 8 for int8 weight
// rows), ldmatrix fragment loads, the
// warp-level mma.sync.m16n8k16 product on bf16 operands with f32
// accumulators, and the split arrive / wait of a thread-block cluster's
// barrier.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, tg = lane % 4):
//   A (16 x 16, row-major), 4 registers of two bf16 each:
//     a0 (row g, cols 2tg..2tg+1)      a1 (row g+8, cols 2tg..)
//     a2 (row g, cols 2tg+8..)         a3 (row g+8, cols 2tg+8..)
//   B (16 x 8, "col": k pairs of one column n = g), 2 registers:
//     b0 (rows 2tg..2tg+1)             b1 (rows 2tg+8..)
//   C/D (16 x 8, f32), 4 registers:
//     c0, c1 (row g, cols 2tg, 2tg+1)  c2, c3 (row g+8, same cols)
// ldmatrix.x4 loads four 8 x 8 bf16 matrices whose row addresses come
// from lanes 0-7, 8-15, 16-23 and 24-31 into registers 0..3; lane l then
// holds (row l / 4, cols 2(l % 4)..+1) of each (.trans: of its
// transpose). Every row address is 16-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (the
// source is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 8 bytes global -> shared (through L1), zero-filled when !valid: the
// int8 weight rows, whose 8 columns are 8 bytes.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// Two matrices: row addresses from lanes 0-7 and 8-15.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(row)));
}

// d += a (16 x 16 bf16) * b (16 x 8 bf16), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 values as one register of two bf16 (x0 in the low half, the
// lower column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return bits(__floats2bfloat162_rn(x0, x1));
}

// Two int8 weight codes as one register of two bf16, x0 in the low half:
// |code| <= 127 is exact in bf16, so the tensor cores see the codes
// themselves.
__device__ __forceinline__ uint32_t pack_codes(int8_t x0, int8_t x1) {
  return pack_bf16((float)x0, (float)x1);
}

// x = hi + lo + O(2^-17 |x|): hi = bf16(x), lo = bf16(x - hi), both as
// packed bf16 pairs (x - hi is exact in f32).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The cluster barrier in two halves, so that a block can arrive early and
// wait only where it needs its peers. Every thread of every block of the
// cluster alternates arrive and wait. arrive_relaxed orders nothing (the
// first round only proves that every block runs, so that its shared
// memory may be written); arrive releases this thread's writes, shared
// memory of peers included, and wait acquires them.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace tc
