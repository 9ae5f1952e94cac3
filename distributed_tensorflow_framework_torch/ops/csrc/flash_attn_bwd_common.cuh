// What the flash-attention backward kernels share: the operand record, the
// operand check of the C entry points, the launch helper and the two
// key-block bodies, each run by the two-pass dK/dV kernel
// (flash_attn_bwd.cu) and by the fused one-pass kernel
// (flash_attn_bwd_fused.cu):
//   * key_block_bwd<D, kWithDq>, the CUDA-core loop of the first kernels
//     (64 x 64 f32 tiles, 256 threads, f32 FMAs), f32 inputs only;
//   * key_block_bwd_tc<D, kSegmented, kWithDq>, the bf16 loop on the tensor
//     cores (mma.sync.m16n8k16, building blocks in flash_attn_mma.cuh).
// kWithDq adds the fused kernel's dq partials. With one body per dtype the
// fused kernel's dk, dv and dbias_h are the two-pass kernel's bits by
// construction: each key's sums over the query tiles run in the same order.
// ops/_build.py hashes this header into every library's name.
//
// The f32 loop replaces the TPU kernels' dK/dV block
// (distributed_tensorflow_framework_tpu/ops/flash_attention.py,
// _attn_bwd_dkv_kernel and _attn_bwd_dkv_kernel_kb for f32 inputs) and the
// body of _attn_bwd_fused_kernel_kb in f32. On the H100 it is bound by
// shared-memory loads feeding f32 FMAs (22-23 TFLOP/s, PERF.md), far from
// the 67 TFLOP/s f32 peak; it stays, since TF32 on the tensor cores would
// miss the f32 tolerance. The bf16 loop's design is described at
// key_block_bwd_tc below and in the notes of flash_attn_bwd.cu and
// flash_attn_bwd_fused.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attn_mma.cuh"

namespace {

constexpr int kTile = 64;       // query rows and keys per tile
constexpr int kTilePad = kTile + 1;
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 scores each
constexpr float kNegInf = -3.40282346638528859812e+38f;  // finite f32 min

// Everything the kernels read. q/k/v/dout are (B, S, H, D) with element
// (b, s, h, d) at b*sb + s*ss + h*D + d; bias, qseg, kseg are (B, S) f32
// (qseg and kseg both null when unsegmented); lse and delta are (B, S, H)
// f32, contiguous.
struct Operands {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss;
  const float* bias;
  const float* qseg;
  const float* kseg;
  const float* lse;
  const float* delta;
  int S, H;
  float scale;
};

// p for one (query row, key) pair that both exist: the TPU kernels'
// rounding points, scale then bias as two roundings.
__device__ __forceinline__ float recompute_p(float qk, float scale, float bias,
                                             bool other_segment, float lse) {
  float s = __fadd_rn(__fmul_rn(qk, scale), bias);
  if (other_segment) s = kNegInf;
  return expf(s - lse);
}

// Copy rows [s0, s0 + kTile) of one head of a (B, S, H, D) f32 operand into
// a shared [kTile][pitch] tile, zeros past S.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, long long ss,
                                          int s0, int S) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, s = s0 + r;
    dst[r * pitch + d] = s < S ? src[s * ss + d] : 0.f;
  }
}

// Shared memory of a block that holds one 64-key tile of K and V and
// streams 64-row tiles of Q and dO past it (the dK/dV and the fused
// kernels): k and v tiles, padded q and dO tiles, padded p and ds tiles,
// and the q-tile's lse, delta and segments.
template <int D>
constexpr size_t key_block_smem_bytes() {
  return sizeof(float) * (2 * kTile * D + 2 * kTile * (D + 1) +
                          2 * kTile * kTilePad + 3 * kTile);
}

// The body of a block that owns one (b, h, 64-key tile) and loops over all
// 64-row query tiles, f32 inputs only (bf16 takes key_block_bwd_tc, and in
// f32 the rounding to the input dtype is the identity): dK/dV and the
// per-head dbias, accumulated in registers and written once. kWithDq adds
// each query tile's dq partial (scale * sum over the block's 64 keys of
// ds k) into the f32 buffer dq_acc by atomicAdd: that is the fused kernel,
// and without it the two-pass dK/dV kernel, so their f32 dk, dv and dbias_h
// are equal.
template <int D, bool kWithDq>
__device__ __forceinline__ void key_block_bwd(const Operands& op,
                                              float* __restrict__ dq_acc,
                                              float* __restrict__ dk,
                                              float* __restrict__ dv,
                                              float* __restrict__ dbias_h) {
  constexpr int kPad = D + 1;
  constexpr int kDJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* ks = smem;                        // [kTile][D]
  float* vs = ks + kTile * D;              // [kTile][D]
  float* qs = vs + kTile * D;              // [kTile][kPad]
  float* dos = qs + kTile * kPad;          // [kTile][kPad]
  float* ps = dos + kTile * kPad;          // [key][q row], kTilePad pitch
  float* dss = ps + kTile * kTilePad;      // [key][q row], kTilePad pitch
  float* lse_s = dss + kTile * kTilePad;   // [kTile]
  float* delta_s = lse_s + kTile;          // [kTile]
  float* qseg_s = delta_s + kTile;         // [kTile]

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // q rows tx + 16j of the score tile
  const int ty = tid >> 4;   // keys ty + 16i of the score tile
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int S = op.S, H = op.H;
  const bool segmented = op.qseg != nullptr;

  const float* qb =
      static_cast<const float*>(op.q) + b * op.q_sb + (long long)h * D;
  const float* kb =
      static_cast<const float*>(op.k) + b * op.k_sb + (long long)h * D;
  const float* vb =
      static_cast<const float*>(op.v) + b * op.v_sb + (long long)h * D;
  const float* dob =
      static_cast<const float*>(op.dout) + b * op.do_sb + (long long)h * D;

  load_tile<D>(ks, D, kb, op.k_ss, k0, S);
  load_tile<D>(vs, D, vb, op.v_ss, k0, S);
  bool key_in[4];
  float kbias_r[4], kseg_r[4], dbias_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    key_in[i] = s < S;
    kbias_r[i] = key_in[i] ? op.bias[b * S + s] : 0.f;
    kseg_r[i] = (segmented && key_in[i]) ? op.kseg[b * S + s] : 0.f;
    dbias_r[i] = 0.f;
  }

  float acc_dk[4][kDJ], acc_dv[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(qs, kPad, qb, op.q_ss, q0, S);
    load_tile<D>(dos, kPad, dob, op.do_ss, q0, S);
    for (int r = tid; r < kTile; r += kThreads) {
      const int s = q0 + r;
      const bool in = s < S;
      const long long row = (b * S + s) * H + h;
      lse_s[r] = in ? op.lse[row] : 0.f;
      delta_s[r] = in ? op.delta[row] : 0.f;
      qseg_s[r] = (segmented && in) ? op.qseg[b * S + s] : 0.f;
    }
    __syncthreads();

    // Scores and dO.v for keys ty + 16i against q rows tx + 16j.
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty + 16 * i) * D + d];
        vv[i] = vs[(ty + 16 * i) * D + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * kPad + d];
        dov[j] = dos[(tx + 16 * j) * kPad + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
          dpt[i][j] = fmaf(dov[j], vv[i], dpt[i][j]);
        }
    }

    // One exp per pair: p and ds feed dv, dk, dbias (and dq) below.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float colsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (key_in[i] && q0 + r < S) {
          p = recompute_p(st[i][j], op.scale, kbias_r[i],
                          segmented && qseg_s[r] != kseg_r[i], lse_s[r]);
          ds = __fmul_rn(p, dpt[i][j] - delta_s[r]);
        }
        colsum += ds;
        ps[(ty + 16 * i) * kTilePad + r] = p;
        dss[(ty + 16 * i) * kTilePad + r] = ds;
      }
      // The 16 threads sharing key ty + 16i are lanes tx = 0..15 of one
      // half-warp: reduce the unrounded ds over this tile's q rows.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        colsum += __shfl_xor_sync(0xffffffffu, colsum, off);
      dbias_r[i] += colsum;
    }
    __syncthreads();

    // dv += p^T dO and dk += ds^T q for keys ty + 16i, columns tx + 16j.
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pv[4], dsv[4], dov[kDJ], qv[kDJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[(ty + 16 * i) * kTilePad + r];
        dsv[i] = dss[(ty + 16 * i) * kTilePad + r];
      }
#pragma unroll
      for (int j = 0; j < kDJ; ++j) {
        dov[j] = dos[r * kPad + tx + 16 * j];
        qv[j] = qs[r * kPad + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDJ; ++j) {
          acc_dv[i][j] = fmaf(pv[i], dov[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(dsv[i], qv[j], acc_dk[i][j]);
        }
    }

    if constexpr (kWithDq) {
      // This key tile's share of dq for q rows ty + 16i, columns tx + 16j,
      // added into the buffer that every key tile of (b, h) adds into.
      float acc_dq[4][kDJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDJ; ++j) acc_dq[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kTile; ++c) {
        float dsv[4], kv[kDJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = dss[c * kTilePad + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kDJ; ++j) kv[j] = ks[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kDJ; ++j)
            acc_dq[i][j] = fmaf(dsv[i], kv[j], acc_dq[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = q0 + ty + 16 * i;
        if (s >= S) continue;
        const long long row = (b * S + s) * H + h;
#pragma unroll
        for (int j = 0; j < kDJ; ++j)
          atomicAdd(&dq_acc[row * D + tx + 16 * j],
                    __fmul_rn(acc_dq[i][j], op.scale));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!key_in[i]) continue;
    const int s = k0 + ty + 16 * i;
    const long long row = (b * S + s) * H + h;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      dk[row * D + tx + 16 * j] = __fmul_rn(acc_dk[i][j], op.scale);
      dv[row * D + tx + 16 * j] = acc_dv[i][j];
    }
    if (tx == 0) dbias_h[(b * H + h) * S + s] = dbias_r[i];
  }
}

// ------------------------------------------------ bf16, tensor cores

// Tiles of key_block_bwd_tc: a block of kTcWarps (4) warps owns kN = 64 keys
// (each warp 16) and streams query tiles of kM rows past them.
template <int D>
struct DkvTc {
  static constexpr int kN = 16 * kTcWarps;        // keys of the block
  static constexpr int kM = D == 128 ? 32 : 64;   // query rows of a tile
  static constexpr int kP = D + 8;                // padded row pitch
  static constexpr int kDsP = kM + 8;             // pitch of the dS^T tile
  // K and V, a two-stage ring of Q and dO tiles with the rows' lse, delta
  // and segments; with dq, the block's round(dS^T) tile after them.
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * kN + 4 * kM) * kP + sizeof(float) * 6 * kM;
  static constexpr size_t kSmemWithDq = kSmem + sizeof(bf16) * kN * kDsP;
};

// Blocks of 4 warps an SM is to hold with key_block_bwd_tc, which caps
// registers at 65536 / (128 x blocks): per variant the most that compile
// without spills (chip_smoke.py phase 2 prints registers and spills). The
// body reaches its third block by packing p and ds early, and the cap keeps
// its D = 32 variant from spilling. The fused kernel's dq product runs when
// the S/dP accumulators are dead, so it fits the same caps.
template <int D, bool kSegmented>
constexpr int dkv_min_blocks() {
  return D == 128 || (D == 64 && kSegmented) ? 1 : 3;
}

// dK, dV and dbias_h for one (b, h, kN-key tile), bf16 on the tensor cores:
// the body of the two-pass dK/dV kernel and, with kWithDq, of the fused
// kernel, which adds each query tile's dq partial (scale * round(dS) K over
// the block's keys) into the f32 buffer dq_acc.
template <int D, bool kSegmented, bool kWithDq>
__device__ __forceinline__ void key_block_bwd_tc(const Operands& op,
                                                 float* __restrict__ dq_acc,
                                                 bf16* __restrict__ dk,
                                                 bf16* __restrict__ dv,
                                                 float* __restrict__ dbias_h) {
  using C = DkvTc<D>;
  constexpr int kN = C::kN, kM = C::kM, kP = C::kP, kT = kTcThreads;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);      // [kN][kP]
  bf16* vs = ks + kN * kP;                          // [kN][kP]
  bf16* qs = vs + kN * kP;                          // [2][kM][kP]
  bf16* dos = qs + 2 * kM * kP;                     // [2][kM][kP]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kM * kP);  // [2][kM]
  float* delta_s = lse_s + 2 * kM;                  // [2][kM]
  float* qseg_s = delta_s + 2 * kM;                 // [2][kM]
  bf16* dst = reinterpret_cast<bf16*>(qseg_s + 2 * kM);  // [kN][kDsP], dq

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kN;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int S = op.S, H = op.H;
  const bf16* qb = static_cast<const bf16*>(op.q) + b * op.q_sb + h * D;
  const bf16* kb = static_cast<const bf16*>(op.k) + b * op.k_sb + h * D;
  const bf16* vb = static_cast<const bf16*>(op.v) + b * op.v_sb + h * D;
  const bf16* dob = static_cast<const bf16*>(op.dout) + b * op.do_sb + h * D;

  auto load_queries = [&](int q0, int stage) {
    load_tile_async<D, kM, kT>(qs + stage * kM * kP, qb, op.q_ss, q0, S);
    load_tile_async<D, kM, kT>(dos + stage * kM * kP, dob, op.do_ss, q0, S);
    load_vec_async<kT>(lse_s + stage * kM, op.lse + b * S * H + h, H, q0, kM,
                       S);
    load_vec_async<kT>(delta_s + stage * kM, op.delta + b * S * H + h, H, q0,
                       kM, S);
    if (kSegmented)
      load_vec_async<kT>(qseg_s + stage * kM, op.qseg + b * S, 1, q0, kM, S);
  };
  load_tile_async<D, kN, kT>(ks, kb, op.k_ss, k0, S);
  load_tile_async<D, kN, kT>(vs, vb, op.v_ss, k0, S);
  load_queries(0, 0);
  cp_async_commit();

  // Bias and segment of this thread's keys g and g + 8 of the warp.
  bool key_in[2];
  float kbias_r[2], kseg_r[2], dbias_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = k0 + warp * 16 + g + 8 * i;
    key_in[i] = s < S;
    kbias_r[i] = key_in[i] ? op.bias[b * S + s] : 0.f;
    kseg_r[i] = (kSegmented && key_in[i]) ? op.kseg[b * S + s] : 0.f;
    dbias_r[i] = 0.f;
  }

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc_dk[j][r] = acc_dv[j][r] = 0.f;

  const int n_tiles = (S + kM - 1) / kM;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, q0 = it * kM;
    if (it + 1 < n_tiles) load_queries(q0 + kM, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();  // tile `it` has landed for every thread
    const bf16* qst = qs + stage * kM * kP;
    const bf16* dost = dos + stage * kM * kP;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x kM rows.
    float acc_s[kM / 8][4], acc_dp[kM / 8][4];
#pragma unroll
    for (int j = 0; j < kM / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_s[j][r] = acc_dp[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, ks + frag_a_offset<kP>(lane, warp * 16, kk * 16));
      ldmatrix_x4(va, vs + frag_a_offset<kP>(lane, warp * 16, kk * 16));
#pragma unroll
      for (int p = 0; p < kM / 16; ++p) {
        uint32_t qf[4], df[4];
        const int off = frag_b_offset<kP>(lane, p * 16, kk * 16);
        ldmatrix_x4(qf, qst + off);
        ldmatrix_x4(df, dost + off);
        mma_bf16(acc_s[2 * p], ka, qf[0], qf[1]);
        mma_bf16(acc_s[2 * p + 1], ka, qf[2], qf[3]);
        mma_bf16(acc_dp[2 * p], va, df[0], df[1]);
        mma_bf16(acc_dp[2 * p + 1], va, df[2], df[3]);
      }
    }

    // p and ds, ds summed per key, both rounded into the A fragments of the
    // dV and dK products as soon as a 16-row chunk is done; rows and keys
    // past S get p = 0.
    const bool edge = q0 + kM > S || k0 + kN > S;
    const float* lse_st = lse_s + stage * kM;
    const float* delta_st = delta_s + stage * kM;
    const float* qseg_st = qseg_s + stage * kM;
    uint32_t pa[kM / 16][4], sa[kM / 16][4];
#pragma unroll
    for (int j = 0; j < kM / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_st + c);
      const float2 delta2 = *reinterpret_cast<const float2*>(delta_st + c);
      float2 qseg2 = make_float2(0.f, 0.f);
      if (kSegmented) qseg2 = *reinterpret_cast<const float2*>(qseg_st + c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r >> 1;
        const bool odd = r & 1;
        float s = __fadd_rn(__fmul_rn(acc_s[j][r], op.scale), kbias_r[i]);
        if (kSegmented && (odd ? qseg2.y : qseg2.x) != kseg_r[i])
          s = kNegInf;
        float p = exp2f((s - (odd ? lse2.y : lse2.x)) * kLog2e);
        if (edge && (!key_in[i] || q0 + c + odd >= S)) p = 0.f;
        const float ds =
            __fmul_rn(p, acc_dp[j][r] - (odd ? delta2.y : delta2.x));
        dbias_r[i] += ds;
        acc_s[j][r] = p;
        acc_dp[j][r] = ds;
      }
      if (j & 1) {
        accum_to_a(pa[j >> 1], acc_s, j >> 1);
        accum_to_a(sa[j >> 1], acc_dp, j >> 1);
      }
    }

    if constexpr (kWithDq) {
      // round(dS^T), as packed for the dK product, into the block's
      // [key][query row] tile: rows g and g + 8 of the warp's keys, columns
      // 2t, 2t + 1 and 2t + 8, 2t + 9 of each 16-row chunk.
      bf16* row_g = dst + (warp * 16 + g) * C::kDsP + 2 * t;
#pragma unroll
      for (int c = 0; c < kM / 16; ++c) {
        uint32_t* lo = reinterpret_cast<uint32_t*>(row_g + c * 16);
        uint32_t* hi =
            reinterpret_cast<uint32_t*>(row_g + 8 * C::kDsP + c * 16);
        lo[0] = sa[c][0];
        hi[0] = sa[c][1];
        lo[4] = sa[c][2];
        hi[4] = sa[c][3];
      }
    }

    // dV += round(P^T) dO and dK += round(dS^T) Q: dO and Q read
    // transposed ([q][d] is [k][n]).
#pragma unroll
    for (int c = 0; c < kM / 16; ++c) {
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t df[4], qf[4];
        const int off = frag_a_offset<kP>(lane, c * 16, p * 16);
        ldmatrix_x4_trans(df, dost + off);
        ldmatrix_x4_trans(qf, qst + off);
        mma_bf16(acc_dv[2 * p], pa[c], df[0], df[1]);
        mma_bf16(acc_dv[2 * p + 1], pa[c], df[2], df[3]);
        mma_bf16(acc_dk[2 * p], sa[c], qf[0], qf[1]);
        mma_bf16(acc_dk[2 * p + 1], sa[c], qf[2], qf[3]);
      }
    }

    if constexpr (kWithDq) {
      // dQ of the tile's rows over the block's keys, round(dS) K: warp w
      // takes rows r0..r0+15 and columns d0..d0+kCols-1 (all of D when the
      // tile has 64 rows; one half of D = 128, whose tiles have 32), with
      // round(dS) read transposed from the [key][row] tile and K transposed
      // from the resident key tile. The partial, times scale, is added into
      // dq_acc two columns at a time.
      constexpr int kRowGroups = kM / 16;
      constexpr int kCols = D * kRowGroups / kTcWarps;
      static_assert(kTcWarps % kRowGroups == 0 && kCols % 16 == 0,
                    "each warp takes 16 rows and a multiple of 16 columns");
      const int r0 = (warp % kRowGroups) * 16;
      const int d0 = (warp / kRowGroups) * kCols;
      __syncthreads();  // every warp's round(dS^T) is in the tile
      float acc_dq[kCols / 8][4];
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc_dq[j][r] = 0.f;
#pragma unroll
      for (int c = 0; c < kN / 16; ++c) {
        uint32_t da[4];
        ldmatrix_x4_trans(da, dst + frag_b_offset<C::kDsP>(lane, c * 16, r0));
#pragma unroll
        for (int p = 0; p < kCols / 16; ++p) {
          uint32_t kf[4];
          ldmatrix_x4_trans(kf,
                            ks + frag_a_offset<kP>(lane, c * 16, d0 + p * 16));
          mma_bf16(acc_dq[2 * p], da, kf[0], kf[1]);
          mma_bf16(acc_dq[2 * p + 1], da, kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = q0 + r0 + g + 8 * i;
        if (s >= S) continue;
        float* out = dq_acc + ((b * S + s) * H + h) * D + d0 + 2 * t;
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j)
          atomicAdd(reinterpret_cast<float2*>(out + 8 * j),
                    make_float2(__fmul_rn(acc_dq[j][2 * i], op.scale),
                                __fmul_rn(acc_dq[j][2 * i + 1], op.scale)));
      }
    }
    __syncthreads();  // stage `stage` (and the dS^T tile) is refilled next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // The quad of lanes 4g..4g+3 holds key g + 8i's columns.
    float sum = dbias_r[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (!key_in[i]) continue;
    const int s = k0 + warp * 16 + g + 8 * i;
    const long long row = (b * S + s) * H + h;
    if (t == 0) dbias_h[(b * H + h) * S + s] = sum;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long long col = row * D + 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + col) = __floats2bfloat162_rn(
          __fmul_rn(acc_dk[j][2 * i], op.scale),
          __fmul_rn(acc_dk[j][2 * i + 1], op.scale));
      *reinterpret_cast<__nv_bfloat162*>(dv + col) =
          __floats2bfloat162_rn(acc_dv[j][2 * i], acc_dv[j][2 * i + 1]);
    }
  }
}

// One block per (b, h, 64-row tile of the sequence), kBlockThreads threads
// each.
template <int kBlockThreads = kThreads, typename Kernel, typename... Outs>
cudaError_t launch(Kernel kernel, size_t smem, int B, const Operands& op,
                   cudaStream_t stream, Outs... outs) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((op.S + kTile - 1) / kTile, op.H, B);
  kernel<<<grid, kBlockThreads, smem, stream>>>(op, outs...);
  return cudaGetLastError();
}

Operands make_operands(const void* q, const void* k, const void* v,
                       const void* dout, long long q_sb, long long q_ss,
                       long long k_sb, long long k_ss, long long v_sb,
                       long long v_ss, long long do_sb, long long do_ss,
                       const void* bias, const void* qseg, const void* kseg,
                       const void* lse, const void* delta, int S, int H,
                       float scale) {
  return Operands{q, k, v, dout, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb,
                  do_ss, static_cast<const float*>(bias),
                  static_cast<const float*>(qseg),
                  static_cast<const float*>(kseg),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), S, H, scale};
}

// What every backward entry point refuses: one of qseg/kseg without the
// other, and a (B, S, H, D) operand that breaks the 16-byte rule of the
// tensor-core kernels' copies (aligned_16, in both dtypes).
cudaError_t check_operands(const Operands& op, int B, int dtype) {
  if ((op.qseg == nullptr) != (op.kseg == nullptr))
    return cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const int S = op.S;
  if (!(aligned_16(op.q, op.q_sb, op.q_ss, B, S, elem) &&
        aligned_16(op.k, op.k_sb, op.k_ss, B, S, elem) &&
        aligned_16(op.v, op.v_sb, op.v_ss, B, S, elem) &&
        aligned_16(op.dout, op.do_sb, op.do_ss, B, S, elem)))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace
