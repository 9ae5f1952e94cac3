// The tensor-core building blocks of the bf16 flash-attention kernels:
// 16-byte cp.async copies into padded bf16 tiles, ldmatrix fragment loads,
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) and the move of an f32
// accumulator into a bf16 A fragment. Included by flash_attn_fwd.cu (the
// forward), flash_attn_bwd.cu (the two-pass dQ and dK/dV kernels) and,
// through flash_attn_bwd_common.cuh, flash_attn_bwd_fused.cu (the fused
// one-pass kernel); ops/_build.py hashes it into every library's name.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane l = 4g + t
// holds, of a 16 x 8 f32 accumulator, rows g and g + 8, columns 2t and
// 2t + 1 (d[0..1] row g, d[2..3] row g + 8); of a 16 x 16 A fragment the
// same rows at columns 2t, 2t + 1 and 2t + 8, 2t + 9; of a 16 x 8 B
// fragment columns g at rows 2t, 2t + 1 and 2t + 8, 2t + 9. So the
// accumulators of two neighbouring n-tiles are, packed to bf16, the A
// fragment of the next product (accum_to_a), with no trip through shared
// memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros when !valid (src must
// still be a mapped address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l & 7 of
// matrix l >> 3 and receives, of each matrix, row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 (.trans: those rows of the transpose).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b for a 16 x 16 bf16 A fragment and a 16 x 8 B fragment, f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the MUFU unit alone (ex2.approx.ftz: a relative error of about
// 2^-22, results below 2^-126 flushed to 0, ex2(-inf) = 0), without the
// range reduction that exp2f adds around it.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to bf16, lo in the low half (the smaller column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of columns 16c..16c+15 of a 16-row accumulator held as
// n-tiles of 8 columns (acc[j][0..1]: row g, acc[j][2..3]: row g + 8).
template <int kNT>
__device__ __forceinline__ void accum_to_a(uint32_t (&a)[4],
                                           const float (&acc)[kNT][4], int c) {
  a[0] = pack_bf16(acc[2 * c][0], acc[2 * c][1]);
  a[1] = pack_bf16(acc[2 * c][2], acc[2 * c][3]);
  a[2] = pack_bf16(acc[2 * c + 1][0], acc[2 * c + 1][1]);
  a[3] = pack_bf16(acc[2 * c + 1][2], acc[2 * c + 1][3]);
}

// Shared-memory offset (elements) of this lane's ldmatrix row for
//  * an A fragment, or a B fragment read transposed from [k][n] storage:
//    rows r0 + (l & 15), columns c0 + 8 (l >> 4);
//  * two B fragments (n-tiles r0 and r0 + 8) read from [n][k] storage:
//    rows r0 + (l & 7) + 8 (l >> 4), columns c0 + 8 ((l >> 3) & 1).
template <int kPitch>
__device__ __forceinline__ int frag_a_offset(int lane, int r0, int c0) {
  return (r0 + (lane & 15)) * kPitch + c0 + ((lane >> 4) << 3);
}
template <int kPitch>
__device__ __forceinline__ int frag_b_offset(int lane, int r0, int c0) {
  return (r0 + (lane & 7) + ((lane >> 4) << 3)) * kPitch + c0 +
         (((lane >> 3) & 1) << 3);
}

// Rows [s0, s0 + kRows) of one head of a (B, S, H, D) bf16 operand into a
// shared [kRows][D + 8] tile by 16-byte cp.async, zeros past S; the block
// has kBlockThreads threads.
template <int D, int kRows, int kBlockThreads = kTcThreads>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long ss, int s0, int S) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kBlockThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int s = s0 + r;
    const bool in = s < S;
    cp_async_16(dst + r * (D + 8) + col, src + (in ? s : 0) * ss + col, in);
  }
}

// One f32 per row s in [s0, s0 + n) at src[s * stride], zeros past S.
template <int kBlockThreads = kTcThreads>
__device__ __forceinline__ void load_vec_async(float* dst, const float* src,
                                               long long stride, int s0,
                                               int n, int S) {
  for (int c = threadIdx.x; c < n; c += kBlockThreads) {
    const int s = s0 + c;
    const bool in = s < S;
    cp_async_4(dst + c, src + (in ? s : 0) * stride, in);
  }
}

// The 16-byte rule of the copies above, which the C entry points check in
// both dtypes: a (B, S, H, D) operand starts on 16 bytes and its batch and
// sequence strides (elements of `elem` bytes) are multiples of 16 bytes
// (ignored where that dimension is 1).
bool aligned_16(const void* p, long long sb, long long ss, int B, int S,
                int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (B == 1 || sb * elem % 16 == 0) && (S == 1 || ss * elem % 16 == 0);
}

}  // namespace
