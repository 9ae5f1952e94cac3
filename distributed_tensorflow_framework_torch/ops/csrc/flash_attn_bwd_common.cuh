// What the flash-attention backward kernels share: the operand record, the
// dtype conversions, and the CUDA-core path of the first kernels (64 x 64
// f32 tiles, 256 threads, f32 FMAs): the recomputation of p and the
// key-block loop that the fused one-pass kernel runs in both dtypes and the
// two-pass dK/dV kernel runs in f32.
// Included by flash_attn_bwd.cu (the two-pass dQ and dK/dV kernels, whose
// bf16 variants run on the tensor cores with their own tiles) and
// flash_attn_bwd_fused.cu (the one-pass kernel); ops/_build.py hashes it
// into every library's name.
//
// The loop here stays as it was written for the first kernels. It replaces
// the TPU kernels' dK/dV block (distributed_tensorflow_framework_tpu/ops/
// flash_attention.py, _attn_bwd_dkv_kernel and _attn_bwd_dkv_kernel_kb for
// f32 inputs) and the body of _attn_bwd_fused_kernel_kb. On the H100 it is
// bound by shared-memory loads feeding f32 FMAs (22-23 TFLOP/s, PERF.md),
// far from the 67 TFLOP/s f32 peak and the 989 TFLOP/s bf16 tensor-core
// peak; the bf16 two-pass kernels left it for mma.sync tiles (see
// flash_attn_bwd.cu), and the fused kernel's redesign is the next step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;       // query rows and keys per tile
constexpr int kTilePad = kTile + 1;
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 scores each
constexpr float kNegInf = -3.40282346638528859812e+38f;  // finite f32 min

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The value rounded to the input dtype, back in f32.
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_f32(from_f32<T>(x));
}

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

// Copy rows [s0, s0 + kTile) of one head of a (B, S, H, D) operand into a
// shared [kTile][pitch] f32 tile, zeros past S.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* src, long long ss, int s0,
                                          int S) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, s = s0 + r;
    dst[r * pitch + d] = s < S ? to_f32(src[s * ss + d]) : 0.f;
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
// 64-row query tiles: dK/dV and the per-head dbias, accumulated in registers
// and written once. kWithDq adds each query tile's dq partial (scale * sum
// over the block's 64 keys of round(ds) k) into the f32 buffer dq_acc by
// atomicAdd: that is the fused kernel, and without it the two-pass dK/dV
// kernel in f32. In f32 both run this one loop, so their dk, dv and dbias_h
// are equal; the bf16 two-pass kernel sums in another order.
template <typename T, int D, bool kWithDq>
__device__ __forceinline__ void key_block_bwd(const Operands& op,
                                              float* __restrict__ dq_acc,
                                              T* __restrict__ dk,
                                              T* __restrict__ dv,
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

  const T* qb = static_cast<const T*>(op.q) + b * op.q_sb + (long long)h * D;
  const T* kb = static_cast<const T*>(op.k) + b * op.k_sb + (long long)h * D;
  const T* vb = static_cast<const T*>(op.v) + b * op.v_sb + (long long)h * D;
  const T* dob =
      static_cast<const T*>(op.dout) + b * op.do_sb + (long long)h * D;

  load_tile<T, D>(ks, D, kb, op.k_ss, k0, S);
  load_tile<T, D>(vs, D, vb, op.v_ss, k0, S);
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
    load_tile<T, D>(qs, kPad, qb, op.q_ss, q0, S);
    load_tile<T, D>(dos, kPad, dob, op.do_ss, q0, S);
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
        ps[(ty + 16 * i) * kTilePad + r] = rounded<T>(p);
        dss[(ty + 16 * i) * kTilePad + r] = rounded<T>(ds);
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
      dk[row * D + tx + 16 * j] =
          from_f32<T>(__fmul_rn(acc_dk[i][j], op.scale));
      dv[row * D + tx + 16 * j] = from_f32<T>(acc_dv[i][j]);
    }
    if (tx == 0) dbias_h[(b * H + h) * S + s] = dbias_r[i];
  }
}

// One block per (b, h, 64-row tile of the sequence), kBlockThreads each.
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

}  // namespace
