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
// 0.026 ms at 3.35 TB/s, so the kernel is bound by operations. Beside them
// it sums dq across blocks: each 64-key block adds its partial of every
// query row, (S / 64) * H * S * D f32 values (3.2 GB of L2 reductions at
// that shape), which the tensor-core work has to hide.
//
// What the design does about it (bf16, the main path's dtype). One block of
// 4 warps owns one (b, h, 64-key tile) and runs the two-pass dK/dV kernel's
// tensor-core body (key_block_bwd_tc in flash_attn_bwd_common.cuh): each
// warp owns 16 keys and forms S^T = K Q^T and dP^T = V dO^T for each query
// tile with mma.sync.m16n8k16, p and ds go from the f32 accumulators into
// bf16 A fragments, and dV += P^T dO, dK += dS^T Q and dbias_h accumulate in
// registers, written once. To that the body adds, per query tile:
//   1. each warp stores its round(dS^T) fragments, already packed to bf16
//      for the dK product, into a [key][query row] bf16 tile in shared
//      memory (rows padded by 16 bytes, so ldmatrix reads are conflict-free);
//   2. after one barrier each warp takes 16 query rows (and, where the tile
//      has fewer than 16 rows per warp, a slice of D) and forms its share of
//      dQ_tile = round(dS) K on the tensor cores over the block's keys,
//      round(dS) read transposed by ldmatrix.trans from that tile and K from
//      the block's resident key tile, as the dQ kernel reads it;
//   3. the partial, times scale, is added into an f32 (B, S, H, D) buffer
//      that the caller zeroes and casts afterwards, two columns per
//      atomicAdd(float2) (a vector reduction, sm_90).
// The dq accumulator lives only after the dV/dK products, when the S/dP
// accumulators are dead, so the kernel keeps the pair's registers. The
// dS^T tile is written and read inside one tile step: the barrier before
// the dq product orders its writes before the reads, and the loop's closing
// barrier (which also frees the cp.async stage) orders the reads before the
// next step's writes.
//
// Since the dK/dV body is one template, the bf16 dk, dv and dbias_h equal
// the two-pass kernel's bit for bit, and do not vary between runs. dq's
// f32 additions arrive in the order the blocks run, so its last bits may
// vary from run to run. f32 inputs keep the CUDA-core loop (key_block_bwd
// with kWithDq, shared with the f32 two-pass dK/dV kernel the same way;
// TF32 would miss the f32 tolerance). Registers, spills and the count of
// HMMA instructions are printed by chip_smoke.py phase 2; PERF.md records
// the kernel's times beside the pair's and its bound.

#include "flash_attn_bwd_common.cuh"

namespace {

// f32: the CUDA-core key-block loop with the dq partials.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_fused_kernel(const Operands op, float* __restrict__ dq_acc,
                            float* __restrict__ dk, float* __restrict__ dv,
                            float* __restrict__ dbias_h) {
  key_block_bwd<D, true>(op, dq_acc, dk, dv, dbias_h);
}

// bf16: the tensor-core key-block body with the dq product, 4 warps (64
// keys) a block at the dK/dV kernel's register cap. 128-key blocks of 8
// warps halve the dq additions but were slower at one block an SM and
// spill at D = 64 at two (PERF.md).
template <int D, bool kSegmented>
__global__ void __launch_bounds__(kTcThreads, dkv_min_blocks<D, kSegmented>())
flash_attn_bwd_fused_tc_kernel(const Operands op, float* __restrict__ dq_acc,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               float* __restrict__ dbias_h) {
  key_block_bwd_tc<D, kSegmented, true>(op, dq_acc, dk, dv, dbias_h);
}

template <int D>
cudaError_t launch_fused(int B, const Operands& op, int dtype, void* dq_acc,
                         void* dk, void* dv, void* dbias_h,
                         cudaStream_t stream) {
  float* dq = static_cast<float*>(dq_acc);
  float* dbias = static_cast<float*>(dbias_h);
  if (dtype == 0)
    return launch(flash_attn_bwd_fused_kernel<D>, key_block_smem_bytes<D>(),
                  B, op, stream, dq, static_cast<float*>(dk),
                  static_cast<float*>(dv), dbias);
  constexpr size_t smem = DkvTc<D>::kSmemWithDq;
  bf16* k_out = static_cast<bf16*>(dk);
  bf16* v_out = static_cast<bf16*>(dv);
  if (op.qseg != nullptr)
    return launch<kTcThreads>(flash_attn_bwd_fused_tc_kernel<D, true>, smem,
                              B, op, stream, dq, k_out, v_out, dbias);
  return launch<kTcThreads>(flash_attn_bwd_fused_tc_kernel<D, false>, smem, B,
                            op, stream, dq, k_out, v_out, dbias);
}

}  // namespace

extern "C" {

// q, k, v, dout: (B, S, H, D) with element (b, s, h, d) at
// b*sb + s*ss + h*D + d, each starting on 16 bytes with sb and ss in
// multiples of 16 bytes; bias, qseg, kseg: (B, S) f32 contiguous
// (qseg/kseg both null when unsegmented); lse and delta: (B, S, H) f32
// contiguous. dq_acc: (B, S, H, D) f32 contiguous and zeroed by the caller
// (the kernel adds into it); dk, dv: (B, S, H, D) contiguous in the input
// dtype; dbias_h: (B, H, S) f32 contiguous. dtype: 0 = float32,
// 1 = bfloat16. Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for operands
// it does not take.
int dtf_flash_attn_bwd_fused(const void* q, const void* k, const void* v,
                             const void* dout, long long q_sb, long long q_ss,
                             long long k_sb, long long k_ss, long long v_sb,
                             long long v_ss, long long do_sb, long long do_ss,
                             const void* bias, const void* qseg,
                             const void* kseg, const void* lse,
                             const void* delta, void* dq_acc, void* dk,
                             void* dv, void* dbias_h, int B, int S, int H,
                             int D, int dtype, float scale, void* stream) {
  const Operands op = make_operands(q, k, v, dout, q_sb, q_ss, k_sb, k_ss,
                                    v_sb, v_ss, do_sb, do_ss, bias, qseg,
                                    kseg, lse, delta, S, H, scale);
  const cudaError_t bad = check_operands(op, B, dtype);
  if (bad != cudaSuccess) return bad;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_fused<32>(B, op, dtype, dq_acc, dk, dv, dbias_h, st);
    case 64:
      return launch_fused<64>(B, op, dtype, dq_acc, dk, dv, dbias_h, st);
    case 128:
      return launch_fused<128>(B, op, dtype, dq_acc, dk, dv, dbias_h, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* dtf_flash_attn_bwd_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
