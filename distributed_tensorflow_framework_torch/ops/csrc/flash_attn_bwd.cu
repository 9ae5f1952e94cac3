// Flash-attention two-pass backward for Hopper (sm_90a): dQ, and dK/dV with
// the per-head key-bias gradient, at any sequence length.
//
// Replaces four TPU kernels of distributed_tensorflow_framework_tpu/ops/
// flash_attention.py: the whole-K _attn_bwd_dq_kernel and
// _attn_bwd_dkv_kernel (launched by _flash_bwd, S <= MAX_SEQ_VMEM) and the
// streaming _attn_bwd_dq_kernel_kb and _attn_bwd_dkv_kernel_kb (launched by
// _flash_bwd_kb above it). Both regimes compute the same function; only
// their VMEM tiling differs, and these kernels stream at every S (nothing
// of size S x S is kept, offsets are 64-bit). For every (batch b, head h,
// query row i, key j) they recompute the forward's probabilities from its
// logsumexp and form
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
// exp(NEG_INF - lse), which would be 1 on a fully-masked row. The bf16
// kernels evaluate the exponential as exp2((s - lse) * log2 e); the
// difference is formed first, so a fully-masked row still gets exp2(0) = 1.
//
// What bounds it on the H100. dQ does three S x S x D products (q.k, dO.v,
// ds.k) and dK/dV four (k.q, v.dO, p.dO, ds.q). At the BERT-base training
// shape (B=8, H=12, S=512, D=64, bf16) that is 9.7 and 12.9 GFLOP against
// 32 and 38 MB of operands; at the long-context shape (B=1, H=12, S=16384)
// 1.24 and 1.65 TFLOP against 126 and 151 MB. So both are bound by
// operations at the 989 TFLOP/s bf16 tensor-core peak (10 and 13 us at 512,
// 1.25 and 1.67 ms at 16384). The first kernels multiplied with f32 FMAs on
// the CUDA cores from f32 tiles in shared memory, one synchronous tile load
// at a time, and ran at 23-25 TFLOP/s (PERF.md).
//
// What the design does about it (bf16, the main path's dtype):
//   * Every product runs on the tensor cores: mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate) fed by ldmatrix from shared memory (the building
//     blocks, shared with the forward, are in flash_attn_mma.cuh). Each warp
//     owns 16 rows of the score tile, so the accumulator layout of one
//     product is the A-operand layout of the next, and p and ds go from the f32
//     accumulators to bf16 A fragments in registers, with no trip through
//     shared memory. mma.sync rather than wgmma, by measurement: a wgmma
//     version of both kernels (m64nNk16 per 64-row warpgroup, the same
//     register fragments, tiles in the core-matrix layout read through
//     descriptors, each product issued and then waited for) was right but
//     slower at S = 16384 on the H100 (PERF.md). Without a pipeline
//     that overlaps one tile's products with the exp and ds arithmetic of
//     another (warp specialisation), wgmma's higher peak does not show.
//   * dQ: one block of 4 warps per (b, h, 64-row q-tile); warp w owns rows
//     16w..16w+15. It streams 64-key tiles of K, V, bias and key segments
//     and forms S = Q K^T and dP = dO V^T (16 x 64 per warp), ds in
//     registers, then dQ += round(dS) K with K read transposed by
//     ldmatrix.trans. lse, delta and the query segments of a thread's two
//     rows live in registers.
//   * dK/dV: one block of 4 warps per (b, h, 64-key tile); warp w owns keys
//     16w..16w+15 and forms S^T = K Q^T and dP^T = V dO^T, so the
//     accumulator rows are keys. round(P^T) and round(dS^T), packed to bf16
//     in registers, are the A operands of dV += P^T dO and dK += dS^T Q,
//     whose B operands (dO, Q) are read transposed from shared memory.
//     dbias_h is a row sum of the f32 ds fragment: in-thread sums over the
//     tiles, one quad shuffle and one store per key at the end. This body
//     is key_block_bwd_tc in flash_attn_bwd_common.cuh, which the fused
//     one-pass kernel runs with its dq product added, so the two routes'
//     bf16 dk, dv and dbias_h are the same bits.
//   * Tiles stay bf16 in shared memory (no widening), in rows padded by 16
//     bytes so that the eight rows an ldmatrix phase reads fall in distinct
//     bank groups. They arrive by 16-byte cp.async with zero-fill past S,
//     through a two-stage ring: the next tile (Q, dO, lse, delta, query
//     segments for dK/dV; K, V, bias, key segments for dQ) loads while the
//     current one is multiplied.
//   * Each block owns its outputs: no atomics, so dq, dk, dv and dbias_h
//     are the same bits from run to run.
//   * Sizes at D = 64 (D = 128): dQ keeps 2 x 64 query rows and a 2-stage
//     ring of 2 x 64 keys, 47 KB (105 KB) of shared memory; dK/dV keeps
//     2 x 64 keys and a ring of 2 x 64 (2 x 32) query rows, 57 KB (70 KB).
//     128 threads a block. The f32 accumulators are 96 (128) registers a
//     thread for dQ and 128 (160) for dK/dV; p and ds are packed to bf16 as
//     soon as each 16-column chunk is done, which shortens their f32 lives.
//     Occupancy is set by registers, not shared memory: at D = 64 the
//     unsegmented dQ is compiled for 4 blocks an SM (16 warps, 128
//     registers) and dK/dV for 3 (12 warps), the most that compile without
//     spills (dq_min_blocks, dkv_min_blocks). Registers, spills and the
//     count of HMMA instructions are printed by chip_smoke.py phase 2.
//     Measured at (1,12,16384,64) on the H100: ~240 TFLOP/s (dQ) and
//     ~230 TFLOP/s (dK/dV), a quarter of the bf16 peak (PERF.md).
//   * Operands are read in the public (B, S, H, D) layout with free batch
//     and sequence strides, which must be multiples of 16 bytes, as must
//     the base pointers (ops/flash_attention.py copies any other view once;
//     the entry points refuse it).
//
// f32 keeps the CUDA-core loops of the first kernels (TF32 would break the
// f32 tolerance): dQ below, dK/dV the key-block loop of
// flash_attn_bwd_common.cuh.

#include <type_traits>

#include "flash_attn_bwd_common.cuh"
#include "flash_attn_mma.cuh"

namespace {

// ----------------------------------------------------------------- f32

template <int D>
constexpr size_t dq_smem_bytes() {
  // q and dO tiles, padded k and v tiles, padded ds tile, key bias and
  // key segments.
  return sizeof(float) * (2 * kTile * D + 2 * kTile * (D + 1) +
                          kTile * kTilePad + 2 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const Operands op, float* __restrict__ dq) {
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

  const float* qb =
      static_cast<const float*>(op.q) + b * op.q_sb + (long long)h * D;
  const float* kb =
      static_cast<const float*>(op.k) + b * op.k_sb + (long long)h * D;
  const float* vb =
      static_cast<const float*>(op.v) + b * op.v_sb + (long long)h * D;
  const float* dob =
      static_cast<const float*>(op.dout) + b * op.do_sb + (long long)h * D;

  load_tile<D>(qs, D, qb, op.q_ss, q0, S);
  load_tile<D>(dos, D, dob, op.do_ss, q0, S);
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
    load_tile<D>(ks, kPad, kb, op.k_ss, k0, S);
    load_tile<D>(vs, kPad, vb, op.v_ss, k0, S);
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
        dss[(ty + 16 * i) * kTilePad + c] = ds;
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
      dq[row * D + tx + 16 * j] = __fmul_rn(acc[i][j], op.scale);
  }
}

// One block per (b, h, 64-key tile): the key-block loop of
// flash_attn_bwd_common.cuh, without the fused kernel's dq partials.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_kernel(const Operands op, float* __restrict__ dk,
                          float* __restrict__ dv, float* __restrict__ dbias_h) {
  key_block_bwd<D, false>(op, nullptr, dk, dv, dbias_h);
}

// ---------------------------------------------------- bf16, tensor cores

constexpr int kTcRows = 16 * kTcWarps;  // the block's own rows (q or keys)
static_assert(kTcRows == kTile, "launch() tiles by kTile rows");

// Blocks an SM is to hold, which caps registers at 65536 / (128 x blocks):
// per variant the most that compile without spills (chip_smoke.py phase 2
// prints registers and spills). The kernels are bound by latency as much as
// by throughput, so the fourth dQ block (128 registers instead of 160) made
// dQ faster at S = 16384 on the H100. dK/dV: dkv_min_blocks in
// flash_attn_bwd_common.cuh.
template <int D, bool kSegmented>
constexpr int dq_min_blocks() {
  return D == 128 ? 1 : kSegmented ? 3 : 4;
}

template <int D>
struct DqTc {
  static constexpr int kM = kTcRows;  // query rows of the block
  static constexpr int kN = 64;       // keys of a streamed tile
  static constexpr int kP = D + 8;    // padded row pitch (elements)
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * kM + 4 * kN) * kP + sizeof(float) * 4 * kN;
};

// dQ for one (b, h, 64-row q-tile), bf16 on the tensor cores.
template <int D, bool kSegmented>
__global__ void __launch_bounds__(kTcThreads, dq_min_blocks<D, kSegmented>())
flash_attn_bwd_dq_tc_kernel(const Operands op, bf16* __restrict__ dq) {
  using C = DqTc<D>;
  constexpr int kM = C::kM, kN = C::kN, kP = C::kP;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);      // [kM][kP]
  bf16* dos = qs + kM * kP;                         // [kM][kP]
  bf16* ks = dos + kM * kP;                         // [2][kN][kP]
  bf16* vs = ks + 2 * kN * kP;                      // [2][kN][kP]
  float* kbias = reinterpret_cast<float*>(vs + 2 * kN * kP);  // [2][kN]
  float* kseg = kbias + 2 * kN;                     // [2][kN]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kM;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int S = op.S, H = op.H;
  const bf16* qb = static_cast<const bf16*>(op.q) + b * op.q_sb + h * D;
  const bf16* kb = static_cast<const bf16*>(op.k) + b * op.k_sb + h * D;
  const bf16* vb = static_cast<const bf16*>(op.v) + b * op.v_sb + h * D;
  const bf16* dob = static_cast<const bf16*>(op.dout) + b * op.do_sb + h * D;

  auto load_keys = [&](int k0, int stage) {
    load_tile_async<D, kN>(ks + stage * kN * kP, kb, op.k_ss, k0, S);
    load_tile_async<D, kN>(vs + stage * kN * kP, vb, op.v_ss, k0, S);
    load_vec_async(kbias + stage * kN, op.bias + b * S, 1, k0, kN, S);
    if (kSegmented)
      load_vec_async(kseg + stage * kN, op.kseg + b * S, 1, k0, kN, S);
  };
  load_tile_async<D, kM>(qs, qb, op.q_ss, q0, S);
  load_tile_async<D, kM>(dos, dob, op.do_ss, q0, S);
  load_keys(0, 0);
  cp_async_commit();

  // lse, delta and segment of this thread's rows g and g + 8.
  float lse_r[2], delta_r[2], qseg_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + warp * 16 + g + 8 * i;
    const bool in = s < S;
    const long long row = (b * S + s) * H + h;
    lse_r[i] = in ? op.lse[row] : 0.f;
    delta_r[i] = in ? op.delta[row] : 0.f;
    qseg_r[i] = (kSegmented && in) ? op.qseg[b * S + s] : 0.f;
  }

  float acc_dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc_dq[j][r] = 0.f;

  const int n_tiles = (S + kN - 1) / kN;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, k0 = it * kN;
    if (it + 1 < n_tiles) load_keys(k0 + kN, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();  // tile `it` has landed for every thread
    const bf16* kst = ks + stage * kN * kP;
    const bf16* vst = vs + stage * kN * kP;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x kN keys.
    float acc_s[kN / 8][4], acc_dp[kN / 8][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_s[j][r] = acc_dp[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, qs + frag_a_offset<kP>(lane, warp * 16, kk * 16));
      ldmatrix_x4(da, dos + frag_a_offset<kP>(lane, warp * 16, kk * 16));
#pragma unroll
      for (int p = 0; p < kN / 16; ++p) {
        uint32_t kf[4], vf[4];
        const int off = frag_b_offset<kP>(lane, p * 16, kk * 16);
        ldmatrix_x4(kf, kst + off);
        ldmatrix_x4(vf, vst + off);
        mma_bf16(acc_s[2 * p], qa, kf[0], kf[1]);
        mma_bf16(acc_s[2 * p + 1], qa, kf[2], kf[3]);
        mma_bf16(acc_dp[2 * p], da, vf[0], vf[1]);
        mma_bf16(acc_dp[2 * p + 1], da, vf[2], vf[3]);
      }
    }

    // ds = p (dp - delta), rounded into the A fragments of the dQ product
    // as soon as a 16-key chunk is done; keys past S get p = 0.
    const bool edge = k0 + kN > S;
    const float* bias_st = kbias + stage * kN;
    const float* kseg_st = kseg + stage * kN;
    uint32_t sa[kN / 16][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 bias2 = *reinterpret_cast<const float2*>(bias_st + c);
      float2 kseg2 = make_float2(0.f, 0.f);
      if (kSegmented) kseg2 = *reinterpret_cast<const float2*>(kseg_st + c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r >> 1;
        float s = __fadd_rn(__fmul_rn(acc_s[j][r], op.scale),
                            (r & 1) ? bias2.y : bias2.x);
        if (kSegmented && qseg_r[i] != ((r & 1) ? kseg2.y : kseg2.x))
          s = kNegInf;
        float p = exp2f((s - lse_r[i]) * kLog2e);
        if (edge && k0 + c + (r & 1) >= S) p = 0.f;
        acc_dp[j][r] = __fmul_rn(p, acc_dp[j][r] - delta_r[i]);
      }
      if (j & 1) accum_to_a(sa[j >> 1], acc_dp, j >> 1);
    }

    // dQ += round(dS) K: K read transposed ([key][d] is [k][n]).
#pragma unroll
    for (int c = 0; c < kN / 16; ++c) {
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, kst + frag_a_offset<kP>(lane, c * 16, p * 16));
        mma_bf16(acc_dq[2 * p], sa[c], kf[0], kf[1]);
        mma_bf16(acc_dq[2 * p + 1], sa[c], kf[2], kf[3]);
      }
    }
    __syncthreads();  // stage `stage` is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + warp * 16 + g + 8 * i;
    if (s >= S) continue;
    bf16* out = dq + ((b * S + s) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          __fmul_rn(acc_dq[j][2 * i], op.scale),
          __fmul_rn(acc_dq[j][2 * i + 1], op.scale));
  }
}

// dK, dV and dbias_h for one (b, h, 64-key tile), bf16 on the tensor cores:
// the key-block body of flash_attn_bwd_common.cuh, which the fused kernel
// runs with its dq partials.
template <int D, bool kSegmented>
__global__ void __launch_bounds__(kTcThreads, dkv_min_blocks<D, kSegmented>())
flash_attn_bwd_dkv_tc_kernel(const Operands op, bf16* __restrict__ dk,
                             bf16* __restrict__ dv,
                             float* __restrict__ dbias_h) {
  key_block_bwd_tc<D, kSegmented, false>(op, nullptr, dk, dv, dbias_h);
}

// ------------------------------------------------------------ dispatch

template <typename T, int D>
cudaError_t launch_dq(int B, const Operands& op, void* dq,
                      cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return launch(flash_attn_bwd_dq_kernel<D>, dq_smem_bytes<D>(), B,
                  op, stream, static_cast<float*>(dq));
  } else {
    bf16* out = static_cast<bf16*>(dq);
    constexpr size_t smem = DqTc<D>::kSmem;
    if (op.qseg != nullptr)
      return launch<kTcThreads>(flash_attn_bwd_dq_tc_kernel<D, true>, smem, B,
                                op, stream, out);
    return launch<kTcThreads>(flash_attn_bwd_dq_tc_kernel<D, false>, smem, B,
                              op, stream, out);
  }
}

template <typename T, int D>
cudaError_t launch_dkv(int B, const Operands& op, void* dk, void* dv,
                       void* dbias_h, cudaStream_t stream) {
  float* dbias = static_cast<float*>(dbias_h);
  if constexpr (std::is_same<T, float>::value) {
    return launch(flash_attn_bwd_dkv_kernel<D>,
                  key_block_smem_bytes<D>(), B, op, stream,
                  static_cast<float*>(dk), static_cast<float*>(dv), dbias);
  } else {
    bf16* k_out = static_cast<bf16*>(dk);
    bf16* v_out = static_cast<bf16*>(dv);
    constexpr size_t smem = DkvTc<D>::kSmem;
    if (op.qseg != nullptr)
      return launch<kTcThreads>(flash_attn_bwd_dkv_tc_kernel<D, true>, smem,
                                B, op, stream, k_out, v_out, dbias);
    return launch<kTcThreads>(flash_attn_bwd_dkv_tc_kernel<D, false>, smem, B,
                              op, stream, k_out, v_out, dbias);
  }
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
// (b, s, h, d) at b*sb + s*ss + h*D + d, each starting on 16 bytes with sb
// and ss in multiples of 16 bytes; bias, qseg, kseg as (B, S) f32
// contiguous (qseg/kseg both null when unsegmented); lse and delta as
// (B, S, H) f32 contiguous. dq, dk, dv are (B, S, H, D) contiguous and
// dbias_h is (B, H, S) f32 contiguous. dtype: 0 = float32, 1 = bfloat16.
// They launch on `stream` without synchronising and return
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for operands
// they do not take.
int dtf_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                          const void* dout, long long q_sb, long long q_ss,
                          long long k_sb, long long k_ss, long long v_sb,
                          long long v_ss, long long do_sb, long long do_ss,
                          const void* bias, const void* qseg,
                          const void* kseg, const void* lse,
                          const void* delta, void* dq, int B, int S, int H,
                          int D, int dtype, float scale, void* stream) {
  const Operands op = make_operands(q, k, v, dout, q_sb, q_ss, k_sb, k_ss,
                                    v_sb, v_ss, do_sb, do_ss, bias, qseg,
                                    kseg, lse, delta, S, H, scale);
  const cudaError_t bad = check_operands(op, B, dtype);
  if (bad != cudaSuccess) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dq<float>(D, B, op, dq, st);
  if (dtype == 1) return dispatch_dq<bf16>(D, B, op, dq, st);
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
  const Operands op = make_operands(q, k, v, dout, q_sb, q_ss, k_sb, k_ss,
                                    v_sb, v_ss, do_sb, do_ss, bias, qseg,
                                    kseg, lse, delta, S, H, scale);
  const cudaError_t bad = check_operands(op, B, dtype);
  if (bad != cudaSuccess) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dkv<float>(D, B, op, dk, dv, dbias_h, st);
  if (dtype == 1) return dispatch_dkv<bf16>(D, B, op, dk, dv, dbias_h, st);
  return cudaErrorInvalidValue;
}

const char* dtf_flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
