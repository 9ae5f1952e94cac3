// Flash-attention forward for Hopper (sm_90a), at any sequence length.
//
// Replaces two TPU kernels of distributed_tensorflow_framework_tpu/ops/
// flash_attention.py: the whole-K _attn_fwd_kernel (launched by _flash_fwd,
// S <= MAX_SEQ_VMEM) and the streaming _attn_fwd_kernel_kb (launched by
// _flash_fwd_kb above it, a running (m, l, acc) over 1024-key blocks). This
// kernel streams 64-key tiles at every S, so it computes both. It computes,
// for every (batch b, head h, query row i):
//
//   s_ij  = (q_i . k_j) * scale + bias_bj        (f32; dots accumulate in f32)
//   s_ij  = NEG_INF  where segment(q_i) != segment(k_j)   (segmented variant)
//   o_i   = sum_j round(exp(s_ij - m_i)) v_j / sum_j exp(s_ij - m_i)
//   lse_i = m_i + log(sum_j exp(s_ij - m_i))
//
// where NEG_INF is the FINITE f32 minimum (so a fully-masked row averages V
// uniformly instead of producing NaN, and its lse stays near NEG_INF — the
// ring merge relies on that) and round() is the cast of p to the input dtype
// before the PV product, as the TPU kernels do. The whole-K TPU kernel
// rounds p against the row's final max m_i, the streaming one against the
// running max of its k-blocks, this kernel against its running max over
// 64-key tiles: in bf16 the three can differ by one rounding of p.
//
// What bounds it on the H100. At the BERT-base serving shape (B=8, H=12,
// S=512, D=64, bf16) the work is 4*B*H*S^2*D = 6.4 GFLOP against 25 MB of
// q/k/v/o: 6.5 us at the 989 TFLOP/s bf16 tensor-core peak and 7.6 us at
// 3.35 TB/s, so the ideal kernel sits on the memory/compute ridge. At the
// long-context shape (B=1, H=12, S=16384) it is 0.82 TFLOP against 101 MB:
// 0.83 ms at the tensor-core peak, bound by operations. This
// first kernel is far from either: its dots are f32 FMAs on the CUDA cores
// (67 TFLOP/s peak, no tensor cores) fed from shared memory — eight shared
// loads for every sixteen FMAs in the inner loops — so it is bound by the
// rate of shared-memory loads, well below even the f32 FMA peak. PERF.md
// records the measured time beside the bound.
//
// What the design does about it. A 128 x S f32 score block (the TPU kernel's
// unit, 256 KB at S=512) does not fit an SM, so the TPU's one-shot softmax
// becomes an online softmax: one thread block per (b, h, 64-row q-tile);
// K and V stream through shared memory in 64-row tiles; each thread keeps the
// running max m, the running sum l and its slice of the output accumulator
// in registers, in f32, and rescales them by exp(m_old - m_new) per tile.
// Nothing of size S x S, or even 64 x S, leaves the SM: HBM traffic is one
// read of the q-tile, one read of K/V per q-tile (served mostly from L2),
// one write of o and lse. Each thread owns a 4 x 4 patch of the 64 x 64
// score tile (rows ty+16i, cols tx+16j) so the row reductions are 16-lane
// shuffles inside one warp, and the K tile is padded by one word per row so
// the 16 distinct K rows a warp reads sit in distinct banks. The q/k/v
// layout is the public (B, S, H, D) with arbitrary batch and sequence
// strides, so the fused-QKV projection's strided views need no copy.
// Tensor-core MMA (mma.sync / wgmma) and TMA are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
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

template <int D>
constexpr size_t smem_bytes() {
  // q tile, padded k tile, v tile, padded p tile, key bias, key segments.
  return sizeof(float) * (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D +
                          kBlockQ * (kBlockK + 1) + 2 * kBlockK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, long long q_sb, long long q_ss,
                      long long k_sb, long long k_ss, long long v_sb,
                      long long v_ss, const float* __restrict__ bias,
                      const float* __restrict__ qseg,
                      const float* __restrict__ kseg, T* __restrict__ o,
                      float* __restrict__ lse, int S, int H, float scale) {
  constexpr int kKPad = D + 1;
  constexpr int kPPad = kBlockK + 1;
  constexpr int kDJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBlockQ][D]
  float* ks = qs + kBlockQ * D;          // [kBlockK][kKPad]
  float* vs = ks + kBlockK * kKPad;      // [kBlockK][D]
  float* ps = vs + kBlockK * D;          // [kBlockQ][kPPad]
  float* kbias = ps + kBlockQ * kPPad;   // [kBlockK]
  float* kseg_s = kbias + kBlockK;       // [kBlockK]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const bool segmented = qseg != nullptr;

  const T* qb = q + b * q_sb + (long long)h * D;
  const T* kb = k + b * k_sb + (long long)h * D;
  const T* vb = v + b * v_sb + (long long)h * D;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    qs[idx] = s < S ? to_f32(qb[s * q_ss + d]) : 0.f;
  }
  float qseg_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    qseg_r[i] = (segmented && s < S) ? qseg[b * S + s] : 0.f;
  }

  float acc[4][kDJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D, s = k0 + r;
      const bool in = s < S;
      ks[r * kKPad + d] = in ? to_f32(kb[s * k_ss + d]) : 0.f;
      vs[idx] = in ? to_f32(vb[s * v_ss + d]) : 0.f;
    }
    for (int c = tid; c < kBlockK; c += kThreads) {
      const int s = k0 + c;
      // Keys past S do not exist: -inf drops them from max and sum alike.
      kbias[c] = s < S ? bias[b * S + s] : -INFINITY;
      kseg_s[c] = (segmented && s < S) ? kseg[b * S + s] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kKPad + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        // Scale then add the bias, two roundings, as the TPU kernel does.
        float s = __fadd_rn(__fmul_rn(sc[i][j], scale), kbias[c]);
        if (segmented && k0 + c < S && qseg_r[i] != kseg_s[c]) s = kNegInf;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // Every tile holds at least one existing key, so m_new is finite.
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        // p is rounded to the input dtype before the PV product; the sum
        // l keeps the unrounded value.
        ps[(ty + 16 * i) * kPPad + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[4], vv[kDJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kPPad + c];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const long long row = (b * S + s) * H + h;
#pragma unroll
    for (int j = 0; j < kDJ; ++j)
      o[row * D + tx + 16 * j] = from_f32<T>(acc[i][j] / l[i]);
    if (tx == 0) lse[row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, long long q_sb,
                   long long q_ss, long long k_sb, long long k_ss,
                   long long v_sb, long long v_ss, const void* bias,
                   const void* qseg, const void* kseg, void* o, void* lse,
                   int B, int S, int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attn_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
      static_cast<const float*>(bias), static_cast<const float*>(qseg),
      static_cast<const float*>(kseg), static_cast<T*>(o),
      static_cast<float*>(lse), S, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     long long q_sb, long long q_ss, long long k_sb,
                     long long k_ss, long long v_sb, long long v_ss,
                     const void* bias, const void* qseg, const void* kseg,
                     void* o, void* lse, int B, int S, int H, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, bias,
                           qseg, kseg, o, lse, B, S, H, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, bias,
                           qseg, kseg, o, lse, B, S, H, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, bias,
                            qseg, kseg, o, lse, B, S, H, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v: (B, S, H, D) with element (b, s, h, d) at b*sb + s*ss + h*D + d;
// bias, qseg, kseg: (B, S) f32 contiguous (qseg/kseg both null when
// unsegmented); o: (B, S, H, D) contiguous; lse: (B, S, H) f32 contiguous.
// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
int dtf_flash_attn_fwd(const void* q, const void* k, const void* v,
                       long long q_sb, long long q_ss, long long k_sb,
                       long long k_ss, long long v_sb, long long v_ss,
                       const void* bias, const void* qseg, const void* kseg,
                       void* o, void* lse, int B, int S, int H, int D,
                       int dtype, float scale, void* stream) {
  if ((qseg == nullptr) != (kseg == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                           bias, qseg, kseg, o, lse, B, S, H, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb,
                                   v_ss, bias, qseg, kseg, o, lse, B, S, H,
                                   scale, st);
  return cudaErrorInvalidValue;
}

const char* dtf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
