// Flash-attention two-pass backward for Hopper (sm_90a): dQ, and dK/dV with
// the per-head key-bias gradient, at any sequence length.
//
// Replaces four TPU kernels of distributed_tensorflow_framework_tpu/ops/
// flash_attention.py: the whole-K _attn_bwd_dq_kernel and
// _attn_bwd_dkv_kernel (launched by _flash_bwd, S <= MAX_SEQ_VMEM) and the
// streaming _attn_bwd_dq_kernel_kb and _attn_bwd_dkv_kernel_kb (launched by
// _flash_bwd_kb above it). Both regimes compute the same function; only
// their VMEM tiling differs, and these kernels stream at every S (nothing
// of size S x S or 64 x S is kept, offsets are 64-bit). For every
// (batch b, head h, query row i, key j) they recompute the forward's
// probabilities from its logsumexp and form
//
//   s_ij  = (q_i . k_j) * scale + bias_bj        (f32; NEG_INF where the
//                                                 segments of i and j differ)
//   p_ij  = exp(s_ij - lse_i)                     (f32, not renormalised)
//   dp_ij = dO_i . v_j                            (f32)
//   ds_ij = p_ij * (dp_ij - delta_i)              (f32)
//   dq_i  = scale * sum_j round(ds_ij) k_j
//   dk_j  = scale * sum_i round(ds_ij) q_i
//   dv_j  = sum_i round(p_ij) dO_i
//   dbias_bhj = sum_i ds_ij                       (f32, from the unrounded ds)
//
// where round() is the cast to the input dtype that the TPU kernels make
// before their second products, delta_i = sum_d dO_id O_id (minus the lse
// cotangent on the chunk path) comes from the caller, and NEG_INF is the
// FINITE f32 minimum. A fully-masked row has lse = NEG_INF to f32 precision,
// so its p is exp(0) = 1 for every key, as on the TPU; that is kept. Keys
// and query rows past S do not exist: their p is exactly 0, never
// exp(NEG_INF - lse), which would be 1 on a fully-masked row.
//
// What bounds it on the H100. dQ does three S x S x D products (q.k, dO.v,
// ds.k) and dK/dV four (k.q, v.dO, p.dO, ds.q). At the BERT-base training
// shape (B=8, H=12, S=512, D=64, bf16) that is 9.7 and 12.9 GFLOP against
// 32 and 38 MB of operands; at the long-context shape (B=1, H=12, S=16384)
// 1.24 and 1.65 TFLOP against 126 and 151 MB. So the ideal kernels are bound
// by operations at the 989 TFLOP/s bf16 tensor-core peak (10 and 13 us at
// 512, 1.25 and 1.67 ms at 16384). These first kernels, like the forward,
// multiply with f32 FMAs on the CUDA cores fed from shared memory, so they
// are bound by the rate of shared-memory loads, well below the 67 TFLOP/s
// f32 FMA peak. PERF.md records the measured times beside the bounds.
//
// What the design does about it. The TPU kernels hold the whole opposing
// sequence and a 128 x S f32 score block in VMEM; that does not fit an SM.
// Here dQ runs one thread block per (b, h, 64-row q-tile) and loops over
// 64-key tiles of K and V; dK/dV runs one block per (b, h, 64-key tile) and
// loops over 64-row tiles of Q and dO. Each block owns its outputs, so there
// are no atomics and the result does not change from run to run. Each thread
// owns a 4 x 4 patch of the 64 x 64 score tile and 4 rows x D/16 columns of
// its block's f32 accumulators, in registers. Operands whose 16 distinct
// rows a warp reads in one step are padded by one word per row so the rows
// sit in distinct banks. Q, K, V and dO are read in the public (B, S, H, D)
// layout with arbitrary batch and sequence strides (the fused-QKV views need
// no copy). Tensor-core MMA (mma.sync / wgmma) and TMA are the next step.

#include "flash_attn_bwd_common.cuh"

namespace {

template <int D>
constexpr size_t dq_smem_bytes() {
  // q and dO tiles, padded k and v tiles, padded ds tile, key bias and
  // key segments.
  return sizeof(float) * (2 * kTile * D + 2 * kTile * (D + 1) +
                          kTile * kTilePad + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const Operands op, T* __restrict__ dq) {
  constexpr int kPad = D + 1;
  constexpr int kDJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                        // [kTile][D]
  float* dos = qs + kTile * D;             // [kTile][D]
  float* ks = dos + kTile * D;             // [kTile][kPad]
  float* vs = ks + kTile * kPad;           // [kTile][kPad]
  float* dss = vs + kTile * kPad;          // [kTile][kTilePad]
  float* kbias = dss + kTile * kTilePad;   // [kTile]
  float* kseg_s = kbias + kTile;           // [kTile]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int S = op.S, H = op.H;
  const bool segmented = op.qseg != nullptr;

  const T* qb = static_cast<const T*>(op.q) + b * op.q_sb + (long long)h * D;
  const T* kb = static_cast<const T*>(op.k) + b * op.k_sb + (long long)h * D;
  const T* vb = static_cast<const T*>(op.v) + b * op.v_sb + (long long)h * D;
  const T* dob =
      static_cast<const T*>(op.dout) + b * op.do_sb + (long long)h * D;

  load_tile<T, D>(qs, D, qb, op.q_ss, q0, S);
  load_tile<T, D>(dos, D, dob, op.do_ss, q0, S);
  float lse_r[4], delta_r[4], qseg_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    const bool in = s < S;
    const long long row = (b * S + s) * H + h;
    lse_r[i] = in ? op.lse[row] : 0.f;
    delta_r[i] = in ? op.delta[row] : 0.f;
    qseg_r[i] = (segmented && in) ? op.qseg[b * S + s] : 0.f;
  }

  float acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(ks, kPad, kb, op.k_ss, k0, S);
    load_tile<T, D>(vs, kPad, vb, op.v_ss, k0, S);
    for (int c = tid; c < kTile; c += kThreads) {
      const int s = k0 + c;
      kbias[c] = s < S ? op.bias[b * S + s] : 0.f;
      kseg_s[c] = (segmented && s < S) ? op.kseg[b * S + s] : 0.f;
    }
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * D + d];
        dov[i] = dos[(ty + 16 * i) * D + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * kPad + d];
        vv[j] = vs[(tx + 16 * j) * kPad + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (k0 + c < S) {
          const float p = recompute_p(sc[i][j], op.scale, kbias[c],
                                      segmented && qseg_r[i] != kseg_s[c],
                                      lse_r[i]);
          ds = __fmul_rn(p, dp[i][j] - delta_r[i]);
        }
        dss[(ty + 16 * i) * kTilePad + c] = rounded<T>(ds);
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[4], kv[kDJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * kTilePad + c];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) kv[j] = ks[c * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const long long row = (b * S + s) * H + h;
#pragma unroll
    for (int j = 0; j < kDJ; ++j)
      dq[row * D + tx + 16 * j] = from_f32<T>(__fmul_rn(acc[i][j], op.scale));
  }
}

// One block per (b, h, 64-key tile): the key-block loop of
// flash_attn_bwd_common.cuh, without the fused kernel's dq partials.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_kernel(const Operands op, T* __restrict__ dk,
                          T* __restrict__ dv, float* __restrict__ dbias_h) {
  key_block_bwd<T, D, false>(op, nullptr, dk, dv, dbias_h);
}

template <typename T, int D>
cudaError_t launch_dq(int B, const Operands& op, void* dq,
                      cudaStream_t stream) {
  return launch(flash_attn_bwd_dq_kernel<T, D>, dq_smem_bytes<D>(), B, op,
                stream, static_cast<T*>(dq));
}

template <typename T, int D>
cudaError_t launch_dkv(int B, const Operands& op, void* dk, void* dv,
                       void* dbias_h, cudaStream_t stream) {
  return launch(flash_attn_bwd_dkv_kernel<T, D>, key_block_smem_bytes<D>(), B,
                op, stream, static_cast<T*>(dk), static_cast<T*>(dv),
                static_cast<float*>(dbias_h));
}

template <typename T>
cudaError_t dispatch_dq(int D, int B, const Operands& op, void* dq,
                        cudaStream_t stream) {
  switch (D) {
    case 32: return launch_dq<T, 32>(B, op, dq, stream);
    case 64: return launch_dq<T, 64>(B, op, dq, stream);
    case 128: return launch_dq<T, 128>(B, op, dq, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dkv(int D, int B, const Operands& op, void* dk,
                         void* dv, void* dbias_h, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_dkv<T, 32>(B, op, dk, dv, dbias_h, stream);
    case 64: return launch_dkv<T, 64>(B, op, dk, dv, dbias_h, stream);
    case 128: return launch_dkv<T, 128>(B, op, dk, dv, dbias_h, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Both entry points take q, k, v, dout as (B, S, H, D) with element
// (b, s, h, d) at b*sb + s*ss + h*D + d; bias, qseg, kseg as (B, S) f32
// contiguous (qseg/kseg both null when unsegmented); lse and delta as
// (B, S, H) f32 contiguous. dq, dk, dv are (B, S, H, D) contiguous and
// dbias_h is (B, H, S) f32 contiguous. dtype: 0 = float32, 1 = bfloat16.
// They launch on `stream` without synchronising and return
// cudaGetLastError() of the launch.
int dtf_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                          const void* dout, long long q_sb, long long q_ss,
                          long long k_sb, long long k_ss, long long v_sb,
                          long long v_ss, long long do_sb, long long do_ss,
                          const void* bias, const void* qseg,
                          const void* kseg, const void* lse,
                          const void* delta, void* dq, int B, int S, int H,
                          int D, int dtype, float scale, void* stream) {
  if ((qseg == nullptr) != (kseg == nullptr)) return cudaErrorInvalidValue;
  const Operands op = make_operands(q, k, v, dout, q_sb, q_ss, k_sb, k_ss,
                                    v_sb, v_ss, do_sb, do_ss, bias, qseg,
                                    kseg, lse, delta, S, H, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dq<float>(D, B, op, dq, st);
  if (dtype == 1) return dispatch_dq<__nv_bfloat16>(D, B, op, dq, st);
  return cudaErrorInvalidValue;
}

int dtf_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                           const void* dout, long long q_sb, long long q_ss,
                           long long k_sb, long long k_ss, long long v_sb,
                           long long v_ss, long long do_sb, long long do_ss,
                           const void* bias, const void* qseg,
                           const void* kseg, const void* lse,
                           const void* delta, void* dk, void* dv,
                           void* dbias_h, int B, int S, int H, int D,
                           int dtype, float scale, void* stream) {
  if ((qseg == nullptr) != (kseg == nullptr)) return cudaErrorInvalidValue;
  const Operands op = make_operands(q, k, v, dout, q_sb, q_ss, k_sb, k_ss,
                                    v_sb, v_ss, do_sb, do_ss, bias, qseg,
                                    kseg, lse, delta, S, H, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dkv<float>(D, B, op, dk, dv, dbias_h, st);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(D, B, op, dk, dv, dbias_h, st);
  return cudaErrorInvalidValue;
}

const char* dtf_flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
