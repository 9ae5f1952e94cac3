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
//     f32 accumulate) fed by ldmatrix from shared memory. Each warp owns
//     16 rows of the score tile, so the accumulator layout of one product
//     is the A-operand layout of the next, and p and ds go from the f32
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
//     tiles, one quad shuffle and one store per key at the end.
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

#include <stdint.h>

#include <type_traits>

#include "flash_attn_bwd_common.cuh"

namespace {

// ----------------------------------------------------------------- f32

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

// ---------------------------------------------------- bf16, tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;  // the block's own rows (q or keys)
static_assert(kTcRows == kTile, "launch() tiles by kTile rows");
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
// shared [kRows][D + 8] tile by 16-byte cp.async, zeros past S.
template <int D, int kRows>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long ss, int s0, int S) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kTcThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int s = s0 + r;
    const bool in = s < S;
    cp_async_16(dst + r * (D + 8) + col, src + (in ? s : 0) * ss + col, in);
  }
}

// One f32 per row s in [s0, s0 + n) at src[s * stride], zeros past S.
__device__ __forceinline__ void load_vec_async(float* dst, const float* src,
                                               long long stride, int s0,
                                               int n, int S) {
  for (int c = threadIdx.x; c < n; c += kTcThreads) {
    const int s = s0 + c;
    const bool in = s < S;
    cp_async_4(dst + c, src + (in ? s : 0) * stride, in);
  }
}

// Blocks an SM is to hold, which caps registers at 65536 / (128 x blocks):
// per variant the most that compile without spills (chip_smoke.py phase 2
// prints registers and spills). The kernels are bound by latency as much as
// by throughput, so the fourth dQ block (128 registers instead of 160) made
// dQ faster at S = 16384 on the H100; dK/dV reaches its third block by
// packing p and ds early, and the cap keeps its D = 32 variant from
// spilling.
template <int D, bool kSegmented>
constexpr int dq_min_blocks() {
  return D == 128 ? 1 : kSegmented ? 3 : 4;
}
template <int D, bool kSegmented>
constexpr int dkv_min_blocks() {
  return D == 128 || (D == 64 && kSegmented) ? 1 : 3;
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

template <int D>
struct DkvTc {
  static constexpr int kN = kTcRows;           // keys of the block
  static constexpr int kM = D == 128 ? 32 : 64;  // query rows of a tile
  static constexpr int kP = D + 8;
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * kN + 4 * kM) * kP + sizeof(float) * 6 * kM;
};

// dK, dV and dbias_h for one (b, h, 64-key tile), bf16 on the tensor cores.
template <int D, bool kSegmented>
__global__ void __launch_bounds__(kTcThreads, dkv_min_blocks<D, kSegmented>())
flash_attn_bwd_dkv_tc_kernel(const Operands op, bf16* __restrict__ dk,
                             bf16* __restrict__ dv,
                             float* __restrict__ dbias_h) {
  using C = DkvTc<D>;
  constexpr int kN = C::kN, kM = C::kM, kP = C::kP;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);      // [kN][kP]
  bf16* vs = ks + kN * kP;                          // [kN][kP]
  bf16* qs = vs + kN * kP;                          // [2][kM][kP]
  bf16* dos = qs + 2 * kM * kP;                     // [2][kM][kP]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kM * kP);  // [2][kM]
  float* delta_s = lse_s + 2 * kM;                  // [2][kM]
  float* qseg_s = delta_s + 2 * kM;                 // [2][kM]

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
    load_tile_async<D, kM>(qs + stage * kM * kP, qb, op.q_ss, q0, S);
    load_tile_async<D, kM>(dos + stage * kM * kP, dob, op.do_ss, q0, S);
    load_vec_async(lse_s + stage * kM, op.lse + b * S * H + h, H, q0, kM, S);
    load_vec_async(delta_s + stage * kM, op.delta + b * S * H + h, H, q0, kM,
                   S);
    if (kSegmented)
      load_vec_async(qseg_s + stage * kM, op.qseg + b * S, 1, q0, kM, S);
  };
  load_tile_async<D, kN>(ks, kb, op.k_ss, k0, S);
  load_tile_async<D, kN>(vs, vb, op.v_ss, k0, S);
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
    __syncthreads();  // stage `stage` is refilled two tiles on
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

// ------------------------------------------------------------ dispatch

template <typename T, int D>
cudaError_t launch_dq(int B, const Operands& op, void* dq,
                      cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return launch(flash_attn_bwd_dq_kernel<float, D>, dq_smem_bytes<D>(), B,
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
    return launch(flash_attn_bwd_dkv_kernel<float, D>,
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

// The 16-byte rule of the bf16 kernels' copies, checked for both dtypes:
// every (B, S, H, D) operand starts on 16 bytes and its batch and sequence
// strides are multiples of 16 bytes (ignored where that dimension is 1).
bool aligned_16(const void* p, long long sb, long long ss, int B, int S,
                int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (B == 1 || sb * elem % 16 == 0) && (S == 1 || ss * elem % 16 == 0);
}

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
