// Flash-attention forward for Hopper (sm_90a), at any sequence length.
//
// Replaces two TPU kernels of distributed_tensorflow_framework_tpu/ops/
// flash_attention.py: the whole-K _attn_fwd_kernel (launched by _flash_fwd,
// S <= MAX_SEQ_VMEM) and the streaming _attn_fwd_kernel_kb (launched by
// _flash_fwd_kb above it, a running (m, l, acc) over 1024-key blocks). These
// kernels stream 64-key tiles at every S, so they compute both. For every
// (batch b, head h, query row i):
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
// running max of its k-blocks, these kernels against their running max over
// 64-key tiles: in bf16 the three can differ by one rounding of p.
//
// What bounds it on the H100. The work is two S x S x D products,
// 4*B*H*S^2*D operations. At the long-context shape (B=1, H=12, S=16384,
// D=64, bf16) that is 0.82 TFLOP against 101 MB of q/k/v/o: 0.83 ms at the
// 989 TFLOP/s bf16 tensor-core peak, bound by operations. At the BERT-base
// serving shape (B=8, H=12, S=512) it is 6.4 GFLOP against 25 MB, 6.5 us
// of operations and 7.6 us of bytes: the memory/compute ridge. The first
// kernel (kept for f32 below) multiplied with f32 FMAs on the CUDA cores
// from f32 shared tiles and ran at ~23 TFLOP/s, bound by shared-memory
// loads (PERF.md).
//
// What the design does about it (bf16, flash_attn_fwd_tc_kernel; the
// building blocks are those of the backward, flash_attn_mma.cuh):
//   * Both products run on the tensor cores, mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate) fed by ldmatrix. One block of 8 warps per (b, h,
//     128-row q-tile); warp w owns rows 16w..16w+15, so a row's 64 scores
//     of a tile live in the 4 lanes of one quad and its max is two
//     shuffles. K, V, the key bias and the key segments stream in 64-key
//     tiles through a two-stage cp.async ring (the next tile loads while
//     this one is multiplied), in bf16 rows padded by 16 bytes so that the
//     eight rows an ldmatrix phase reads fall in distinct bank groups; the
//     q-tile stays in shared memory and its A fragments are re-read per
//     tile (holding them in registers spilled at 128 registers). Every K/V
//     tile that reaches shared memory serves 128 query rows: at S = 16384
//     the blocks read 6.4 GB of K/V from L2 per call, half of what 64-row
//     tiles read; those ran slower there, and so did 256-row tiles.
//   * Online softmax in registers: S = Q K^T (16 x 64 f32 per warp); the
//     running max m and the per-thread part of the running sum l of each of
//     a thread's two rows; p = exp2((s - m) * log2 e) packed straight into
//     the bf16 A fragments of O += P V (accum_to_a), V read transposed by
//     ldmatrix.trans ([key][d] is [k][n]); O (16 x D f32 per warp) rescaled
//     by alpha = exp2((m_old - m_new) * log2 e) per tile. The quads sum l
//     once, at the end. Nothing of size S x S, or 64 x S, leaves registers.
//   * The exponentials go to the MUFU unit alone (ex2.approx.ftz, about 2
//     ulp, exp2_approx): exp2f's range reduction around it made the kernel
//     slower at S = 16384 on the H100, and a p below 2^-126, flushed to 0,
//     adds nothing visible to o. The kernel is bound by its instruction
//     count as much as by the tensor cores: per score, two roundings, a
//     max, a difference, a scale, an exponential, a sum and half a bf16
//     pack, against 1/16 of an HMMA.
//   * The epilogue stores o as bf16x2 and one lse per row; each block owns
//     its rows, no atomics, so a relaunch gives the same bits.
//   * Occupancy is set by registers: fwd_min_blocks asks for the most blocks
//     an SM holds that compile without spills (chip_smoke.py phase 2 prints
//     registers, spills and HMMA counts).
//   * mma.sync rather than wgmma: a wgmma version of the backward pair, each
//     product started and then waited for, was slower on the H100 (PERF.md).
//
// Traps that break parity, and what this kernel does about each:
//   1. Keys past S. cp.async zero-fills them, so they would arrive as
//      q.k = 0 and bias = 0, i.e. s = 0. Their s is set to -INFINITY BEFORE
//      the row max (on the last, ragged tile): a fully-masked row (all real
//      s = NEG_INF) would otherwise take m = 0 from a phantom key, get p = 0
//      for every real key, l = 0 and o = NaN. Every tile holds at least one
//      real key, so m stays finite.
//   2. exp2 in the log2 domain. s - m is formed first and then multiplied
//      by log2 e; scale * log2 e is not folded into the scores (FA2's
//      softmax_scale_log2): that would break the two roundings of s
//      (scale, then bias), and NEG_INF * log2 e overflows to -inf, so a
//      fully-masked row would form -inf - (-inf) = NaN. For the same reason
//      alpha = exp2((m_old - m_new) * log2 e), which is exp2(-inf) = 0 at
//      the first tile, where m_old = -INFINITY.
//   3. l sums the unrounded f32 p; only the PV operand is rounded to bf16.
//   4. Alignment. The 16-byte copies need every (B, S, H, D) operand to
//      start on 16 bytes with batch and sequence strides in multiples of 16
//      bytes. ops/flash_attention.py copies any other view once
//      (_head_view); the entry point refuses one (aligned_16) rather than
//      read it wrongly. BERT's fused-QKV views pass without a copy.
//
// f32 keeps the CUDA-core kernel of the first port (TF32 would break the
// f32 tolerance): flash_attn_fwd_kernel below, one block of 256 threads per
// (b, h, 64-row q-tile), each thread a 4 x 4 patch of the 64 x 64 score
// tile, f32 FMAs from f32 shared tiles.

#include <math.h>

#include "flash_attn_mma.cuh"

namespace {

constexpr float kNegInf = -3.40282346638528859812e+38f;  // finite f32 min

// Everything the kernels read and write. q, k, v are (B, S, H, D) with
// element (b, s, h, d) at b*sb + s*ss + h*D + d; bias, qseg, kseg are
// (B, S) f32 contiguous (qseg and kseg both null when unsegmented); o is
// (B, S, H, D) and lse (B, S, H) f32, contiguous.
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
  const float* bias;
  const float* qseg;
  const float* kseg;
  void* o;
  float* lse;
  int S, H;
  float scale;
};

// ----------------------------------------------------------------- f32

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;

template <int D>
constexpr size_t smem_bytes() {
  // q tile, padded k tile, v tile, padded p tile, key bias, key segments.
  return sizeof(float) * (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D +
                          kBlockQ * (kBlockK + 1) + 2 * kBlockK);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const FwdArgs a) {
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
  const int S = a.S;
  const bool segmented = a.qseg != nullptr;

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * D;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * D;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * D;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    qs[idx] = s < S ? qb[s * a.q_ss + d] : 0.f;
  }
  float qseg_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    qseg_r[i] = (segmented && s < S) ? a.qseg[b * S + s] : 0.f;
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
      ks[r * kKPad + d] = in ? kb[s * a.k_ss + d] : 0.f;
      vs[idx] = in ? vb[s * a.v_ss + d] : 0.f;
    }
    for (int c = tid; c < kBlockK; c += kThreads) {
      const int s = k0 + c;
      // Keys past S do not exist: -inf drops them from max and sum alike.
      kbias[c] = s < S ? a.bias[b * S + s] : -INFINITY;
      kseg_s[c] = (segmented && s < S) ? a.kseg[b * S + s] : 0.f;
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
        float s = __fadd_rn(__fmul_rn(sc[i][j], a.scale), kbias[c]);
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
        ps[(ty + 16 * i) * kPPad + tx + 16 * j] = p;
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

  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const long long row = (b * S + s) * a.H + h;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) o[row * D + tx + 16 * j] = acc[i][j] / l[i];
    if (tx == 0) a.lse[row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------- bf16, tensor cores

template <int D>
struct FwdTc {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kM = 16 * kWarps;  // query rows of the block
  static constexpr int kN = 64;           // keys of a streamed tile
  static constexpr int kP = D + 8;        // padded row pitch (elements)
  static constexpr size_t kSmem =
      sizeof(bf16) * (kM + 4 * kN) * kP + sizeof(float) * 4 * kN;
};

// Blocks an SM is to hold, which caps registers at 65536 / (256 x blocks):
// two (128 registers, 16 warps an SM) where that compiles without spills;
// one where the segment compare or D = 128 needs more registers.
template <int D, bool kSegmented>
constexpr int fwd_min_blocks() {
  return D == 128 || kSegmented ? 1 : 2;
}

// o and lse for one (b, h, 128-row q-tile), bf16 on the tensor cores.
template <int D, bool kSegmented>
__global__ void __launch_bounds__(FwdTc<D>::kThreads,
                                  fwd_min_blocks<D, kSegmented>())
flash_attn_fwd_tc_kernel(const FwdArgs a) {
  using C = FwdTc<D>;
  constexpr int kM = C::kM, kN = C::kN, kP = C::kP, kT = C::kThreads;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);      // [kM][kP]
  bf16* ks = qs + kM * kP;                          // [2][kN][kP]
  bf16* vs = ks + 2 * kN * kP;                      // [2][kN][kP]
  float* kbias = reinterpret_cast<float*>(vs + 2 * kN * kP);  // [2][kN]
  float* kseg = kbias + 2 * kN;                     // [2][kN]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kM;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int S = a.S;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * D;

  auto load_keys = [&](int k0, int stage) {
    load_tile_async<D, kN, kT>(ks + stage * kN * kP, kb, a.k_ss, k0, S);
    load_tile_async<D, kN, kT>(vs + stage * kN * kP, vb, a.v_ss, k0, S);
    load_vec_async<kT>(kbias + stage * kN, a.bias + b * S, 1, k0, kN, S);
    if (kSegmented)
      load_vec_async<kT>(kseg + stage * kN, a.kseg + b * S, 1, k0, kN, S);
  };
  load_tile_async<D, kM, kT>(qs, qb, a.q_ss, q0, S);
  load_keys(0, 0);
  cp_async_commit();

  // Segment, running max and this thread's part of the running sum of its
  // rows g and g + 8.
  float qseg_r[2], m_r[2], l_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + warp * 16 + g + 8 * i;
    qseg_r[i] = (kSegmented && s < S) ? a.qseg[b * S + s] : 0.f;
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }

  float acc_o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc_o[j][r] = 0.f;

  const int n_tiles = (S + kN - 1) / kN;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, k0 = it * kN;
    if (it + 1 < n_tiles) load_keys(k0 + kN, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();  // tile `it` (and at it = 0 the q-tile) has landed
    const bf16* kst = ks + stage * kN * kP;
    const bf16* vst = vs + stage * kN * kP;

    // S = Q K^T for the warp's 16 rows x kN keys.
    float acc_s[kN / 8][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_s[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, qs + frag_a_offset<kP>(lane, warp * 16, kk * 16));
#pragma unroll
      for (int p = 0; p < kN / 16; ++p) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kst + frag_b_offset<kP>(lane, p * 16, kk * 16));
        mma_bf16(acc_s[2 * p], qa, kf[0], kf[1]);
        mma_bf16(acc_s[2 * p + 1], qa, kf[2], kf[3]);
      }
    }

    // Scores with the TPU kernel's two roundings (scale, then bias); then,
    // on the last tile only, keys past S at -INFINITY before the max (trap
    // 1; after the segment compare, which would give them NEG_INF).
    const float* bias_st = kbias + stage * kN;
    const float* kseg_st = kseg + stage * kN;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 bias2 = *reinterpret_cast<const float2*>(bias_st + c);
      float2 kseg2 = make_float2(0.f, 0.f);
      if (kSegmented) kseg2 = *reinterpret_cast<const float2*>(kseg_st + c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool odd = r & 1;
        float s = __fadd_rn(__fmul_rn(acc_s[j][r], a.scale),
                            odd ? bias2.y : bias2.x);
        if (kSegmented && qseg_r[r >> 1] != (odd ? kseg2.y : kseg2.x))
          s = kNegInf;
        acc_s[j][r] = s;
      }
    }
    if (k0 + kN > S) {
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (k0 + j * 8 + 2 * t + (r & 1) >= S) acc_s[j][r] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        mx[r >> 1] = fmaxf(mx[r >> 1], acc_s[j][r]);

    // New running max (a row's scores are in the 4 lanes of a quad), and
    // the rescale of l and O by alpha (trap 2: 0 at the first tile).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      const float alpha = exp2_approx((m_r[i] - m_new) * kLog2e);
      m_r[i] = m_new;
      l_r[i] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc_o[j][2 * i] *= alpha;
        acc_o[j][2 * i + 1] *= alpha;
      }
    }

    // p = exp2((s - m) log2 e): summed unrounded into l (trap 3), rounded
    // into the A fragments of the PV product as each 16-key chunk is done.
    uint32_t pa[kN / 16][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r >> 1;
        const float p = exp2_approx((acc_s[j][r] - m_r[i]) * kLog2e);
        l_r[i] += p;
        acc_s[j][r] = p;
      }
      if (j & 1) accum_to_a(pa[j >> 1], acc_s, j >> 1);
    }

    // O += round(P) V: V read transposed ([key][d] is [k][n]).
#pragma unroll
    for (int c = 0; c < kN / 16; ++c) {
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vst + frag_a_offset<kP>(lane, c * 16, p * 16));
        mma_bf16(acc_o[2 * p], pa[c], vf[0], vf[1]);
        mma_bf16(acc_o[2 * p + 1], pa[c], vf[2], vf[3]);
      }
    }
    __syncthreads();  // stage `stage` is refilled two tiles on
  }

  bf16* o = static_cast<bf16*>(a.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // The quad of lanes 4g..4g+3 holds row g + 8i's parts of l.
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int s = q0 + warp * 16 + g + 8 * i;
    if (s >= S) continue;
    const long long row = (b * S + s) * a.H + h;
    bf16* out = o + row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc_o[j][2 * i] / l, acc_o[j][2 * i + 1] / l);
    if (t == 0) a.lse[row] = m_r[i] + logf(l);
  }
}

// ------------------------------------------------------------ dispatch

// One block per (b, h, `rows`-row q-tile), `threads` threads each.
template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, int rows, int B,
                   const FwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + rows - 1) / rows, a.H, B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, int B, const FwdArgs& a,
                     cudaStream_t stream) {
  if (dtype == 0)
    return launch(flash_attn_fwd_kernel<D>, kThreads, smem_bytes<D>(),
                  kBlockQ, B, a, stream);
  using C = FwdTc<D>;
  if (a.qseg != nullptr)
    return launch(flash_attn_fwd_tc_kernel<D, true>, C::kThreads, C::kSmem,
                  C::kM, B, a, stream);
  return launch(flash_attn_fwd_tc_kernel<D, false>, C::kThreads, C::kSmem,
                C::kM, B, a, stream);
}

}  // namespace

extern "C" {

// q, k, v: (B, S, H, D) with element (b, s, h, d) at b*sb + s*ss + h*D + d,
// each starting on 16 bytes with sb and ss in multiples of 16 bytes;
// bias, qseg, kseg: (B, S) f32 contiguous (qseg/kseg both null when
// unsegmented); o: (B, S, H, D) contiguous; lse: (B, S, H) f32 contiguous.
// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor cores).
// Launches on `stream` without synchronising and returns cudaGetLastError()
// of the launch, or cudaErrorInvalidValue for operands it does not take.
int dtf_flash_attn_fwd(const void* q, const void* k, const void* v,
                       long long q_sb, long long q_ss, long long k_sb,
                       long long k_ss, long long v_sb, long long v_ss,
                       const void* bias, const void* qseg, const void* kseg,
                       void* o, void* lse, int B, int S, int H, int D,
                       int dtype, float scale, void* stream) {
  if ((qseg == nullptr) != (kseg == nullptr) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  if (!(aligned_16(q, q_sb, q_ss, B, S, elem) &&
        aligned_16(k, k_sb, k_ss, B, S, elem) &&
        aligned_16(v, v_sb, v_ss, B, S, elem)))
    return cudaErrorInvalidValue;
  const FwdArgs a{q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                  static_cast<const float*>(bias),
                  static_cast<const float*>(qseg),
                  static_cast<const float*>(kseg), o,
                  static_cast<float*>(lse), S, H, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_d<32>(dtype, B, a, st);
    case 64: return launch_d<64>(dtype, B, a, st);
    case 128: return launch_d<128>(dtype, B, a, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* dtf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
