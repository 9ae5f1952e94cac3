// Fused one-pass flash-attention backward for Hopper (sm_90a): dQ, dK, dV
// and the per-head key-bias gradient from ONE evaluation of p per
// (query row, key) pair.
//
// Replaces the TPU kernel distributed_tensorflow_framework_tpu/ops/
// flash_attention.py:_attn_bwd_fused_kernel_kb (line 403, launched by
// _flash_bwd_fused_kb). It computes the same function as the two-pass pair
// in flash_attn_bwd.cu, with the same rounding points:
//
//   p_ij  = exp((q_i . k_j) * scale + bias_bj - lse_i)   (NEG_INF score where
//                                                         segments differ)
//   ds_ij = p_ij * (dO_i . v_j - delta_i)
//   dq_i  = scale * sum_j round(ds_ij) k_j
//   dk_j  = scale * sum_i round(ds_ij) q_i
//   dv_j  = sum_i round(p_ij) dO_i
//   dbias_bhj = sum_i ds_ij                       (f32, from the unrounded ds)
//
// round() is the cast to the input dtype; a fully-masked row (lse = NEG_INF)
// gets p = 1 for every key, as on the TPU, and rows or keys past S get
// p = 0. The two-pass pair recomputes p and dp in both of its kernels: seven
// S x S x D products and two exps per pair. This kernel does five products
// (q.k, dO.v, p.dO, ds.q, ds.k) and one exp.
//
// What bounds it on the H100. At the long-context shape (B=1, H=12,
// S=8192, D=64, bf16) the five products are 0.52 TFLOP against 88 MB of
// operands and results: 0.52 ms at the 989 TFLOP/s bf16 tensor-core peak,
// 0.026 ms at 3.35 TB/s, so the ideal kernel is bound by operations. This
// first kernel multiplies with f32 FMAs on the CUDA cores fed from shared
// memory, like the other three, and is bound by the rate of shared-memory
// loads. PERF.md records its time beside the bound.
//
// What the design does about it. The TPU kernel walks a sequential grid and
// keeps full-length dk/dv/dbias accumulators in VMEM, storing the running
// partial at every visit so that the last visit's store wins; CUDA blocks
// run in no order, so none of that carries over. Here one block owns one
// (b, h, 64-key tile) and loops over all 64-row query tiles: dk, dv and
// dbias_h accumulate in its registers and are written once, with no
// atomics: key_block_bwd in flash_attn_bwd_common.cuh, run with kWithDq set
// (the f32 two-pass dK/dV kernel runs the same loop without it; the bf16
// two-pass kernels run on the tensor cores and sum in another order, so
// the bf16 dk, dv and dbias_h of the two routes agree to within rounding,
// not bit for bit). Each query tile's dq
// partial (scale * sum over the block's 64 keys of round(ds) k) is added
// with f32 atomicAdd into an f32 (B, S, H, D) buffer that the caller zeroes
// and casts to the input dtype afterwards. Those additions arrive in the
// order the blocks run, so dq's f32 summation order, and with it dq's last
// bits, varies from run to run; dk, dv and dbias_h do not.

#include "flash_attn_bwd_common.cuh"

namespace {

// The key-block loop (flash_attn_bwd_common.cuh) with the dq partials.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_fused_kernel(const Operands op, float* __restrict__ dq_acc,
                            T* __restrict__ dk, T* __restrict__ dv,
                            float* __restrict__ dbias_h) {
  key_block_bwd<T, D, true>(op, dq_acc, dk, dv, dbias_h);
}

template <typename T, int D>
cudaError_t launch_fused(int B, const Operands& op, void* dq_acc, void* dk,
                         void* dv, void* dbias_h, cudaStream_t stream) {
  return launch(flash_attn_bwd_fused_kernel<T, D>, key_block_smem_bytes<D>(),
                B, op, stream, static_cast<float*>(dq_acc),
                static_cast<T*>(dk), static_cast<T*>(dv),
                static_cast<float*>(dbias_h));
}

template <typename T>
cudaError_t dispatch_fused(int D, int B, const Operands& op, void* dq_acc,
                           void* dk, void* dv, void* dbias_h,
                           cudaStream_t stream) {
  switch (D) {
    case 32: return launch_fused<T, 32>(B, op, dq_acc, dk, dv, dbias_h, stream);
    case 64: return launch_fused<T, 64>(B, op, dq_acc, dk, dv, dbias_h, stream);
    case 128:
      return launch_fused<T, 128>(B, op, dq_acc, dk, dv, dbias_h, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, dout: (B, S, H, D) with element (b, s, h, d) at
// b*sb + s*ss + h*D + d; bias, qseg, kseg: (B, S) f32 contiguous (qseg/kseg
// both null when unsegmented); lse and delta: (B, S, H) f32 contiguous.
// dq_acc: (B, S, H, D) f32 contiguous and zeroed by the caller (the kernel
// adds into it); dk, dv: (B, S, H, D) contiguous in the input dtype;
// dbias_h: (B, H, S) f32 contiguous. dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// of the launch.
int dtf_flash_attn_bwd_fused(const void* q, const void* k, const void* v,
                             const void* dout, long long q_sb, long long q_ss,
                             long long k_sb, long long k_ss, long long v_sb,
                             long long v_ss, long long do_sb, long long do_ss,
                             const void* bias, const void* qseg,
                             const void* kseg, const void* lse,
                             const void* delta, void* dq_acc, void* dk,
                             void* dv, void* dbias_h, int B, int S, int H,
                             int D, int dtype, float scale, void* stream) {
  if ((qseg == nullptr) != (kseg == nullptr)) return cudaErrorInvalidValue;
  const Operands op = make_operands(q, k, v, dout, q_sb, q_ss, k_sb, k_ss,
                                    v_sb, v_ss, do_sb, do_ss, bias, qseg,
                                    kseg, lse, delta, S, H, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fused<float>(D, B, op, dq_acc, dk, dv, dbias_h, st);
  if (dtype == 1)
    return dispatch_fused<__nv_bfloat16>(D, B, op, dq_acc, dk, dv, dbias_h,
                                         st);
  return cudaErrorInvalidValue;
}

const char* dtf_flash_attn_bwd_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
