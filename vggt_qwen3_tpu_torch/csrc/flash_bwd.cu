// Flash-attention backward for Hopper (sm_90a): two kernels, bf16 in and out,
// f32 accumulation.
//
// Replaces the Pallas TPU kernels of vggt_qwen3_tpu/ops/flash_attention.py
// reached through `_flash_backward`:
//   flash_bwd_dq_kernel  <- `_flash_bwd_dq_kernel`  (:363, pallas_call :538)
//   flash_bwd_dkv_kernel <- `_flash_bwd_dkv_kernel` (:435, pallas_call :575)
// Same function: P is recomputed from the forward's per-row logsumexp,
//   p_ij  = exp(scale * q_i.k_j - lse_i)   (0 where masked, 0 on dead rows)
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i)       (delta = rowsum(dO * out) - g_lse,
//                                            taken by the caller in torch)
//   dq_i = scale * sum_j ds_ij k_j,  dk_j = scale * sum_i ds_ij q_i,
//   dv_j = sum_i p_ij dO_i,
// with dk/dv summed over the query heads of each kv head's GQA group, the
// [kv_start, kv_end) frontier and the optional slot-causal mask of the
// forward. A dead row (no valid key: lse = -1e30) would give exp(s - lse) = 1
// through f32 absorption, so its lse is replaced by +inf (p = 0), as the TPU
// kernels zero such rows.
//
// Precision. QK^T and dO V^T run on wgmma in bf16 with f32 accumulation, as
// the TPU kernels run them at the input precision. The TPU kernels multiply p
// and ds by K, Q and dO in f32; here p and ds are rounded to bf16 for the
// tensor cores (FlashAttention-2's and -3's choice): one bf16 rounding of each
// term of a sum over up to 8232 keys or queries, random in sign, so the sums
// keep a relative error of about 1e-3 -- inside the 5e-3 relative RMS limit
// (utils/agreement.py) the kernels are held to against the plain version,
// which keeps p and ds in f32. exp is taken as exp2 with scale * log2(e)
// folded into one FMA (ex2.approx, 2 ulp).
//
// What bounds it on the H100: at the VGGT shapes (D=64; 1029 or 8232 keys)
// the work is 6 (dq) and 8 (dk/dv) * B*NH*S*T*D tensor-core FLOPs -- the TPU
// kernels' own cost estimates -- against a few MB of operands, so it is bound
// by operations: the products, and beside them one exponential per score and
// the bf16 conversions of P and dS, which the tensor cores cannot do.
//
// Design (FlashAttention-3's backward split in two, without atomics). Each
// block is three warpgroups: two consumers (warps 0-7) and a producer (warps
// 8-11) that gives its registers to the consumers (setmaxnreg 24 / 240) and
// of which one thread issues every copy. Operands come in by TMA, through
// 4-D tensor maps {D, H, S, B} over the strided [B, S, H, D] views, as
// 64-column boxes with the 128-byte swizzle (a D = 128 row is two boxes), into
// a ring of stages with full/empty mbarriers.
//  - dk/dv: one block per (128-key tile, kv head, batch row); each consumer
//    warpgroup owns 64 keys. K and V are loaded once and stay in shared memory
//    as the wgmma A operand of S^T = K Q^T and dP^T = V dO^T; the producer
//    streams the (GQA head, query tile) items' Q, dO, lse and delta through
//    a ring of 3 stages of 128 queries (D = 64) or 2 of 64 (D = 128, as many
//    as the registers allow). P^T and dS^T are formed in the accumulator
//    registers and fed back as the register A operand of dV += P^T dO and
//    dK += dS^T Q, with dO and Q read from their shared tiles through
//    MN-major descriptors: nothing is transposed, nothing goes back through
//    shared memory.
//  - dq: one block per (128-query tile, head, batch row); each consumer
//    warpgroup owns 64 queries. Q and dO are loaded once; K/V tiles of the
//    row's frontier (causal rows: up to the diagonal) stream through a ring
//    of 3 stages of 128 keys (D = 64) or 64 (D = 128); S = Q K^T and
//    dP = dO V^T from shared memory, dQ += dS K with dS from registers and K
//    as an MN-major B.
// The tile and ring sizes are the fastest of those measured on the H100
// (PERF.md, section 6); at D = 64 they are the defines below, which
// `python3 chip_smoke.py --tiles flash_bwd` sets with nvcc -D to time others.
// The mbarrier, TMA, wgmma and tensor-map helpers are hopper.cuh's, shared
// with the forward (flash_fwd.cu).
// Each consumer warpgroup commits S (S^T) and dP (dP^T) as two wgmma groups
// and takes the exponentials as soon as the first is in, under the second.
// The two warpgroups of a block work on the same ring stage independently
// (making them take turns to issue measured slower). Tiles wholly
// outside [kv_start, kv_end) or above the causal diagonal are skipped (a
// warpgroup with nothing to do on a stage only releases it); masks are built
// only on boundary tiles. Rows past S or T read TMA's zero fill; the caller
// pads lse (-1e30) and delta (0) to whole tiles. Every output element is
// summed by one thread of one block in a fixed order: no atomics, so the
// gradients are the same from run to run.

#include "hopper.cuh"

#ifndef DKV_QUERIES
#define DKV_QUERIES 128  // dk/dv at D = 64: queries per ring stage (a divisor of 128)
#endif
#ifndef DKV_STAGES
#define DKV_STAGES 3     // dk/dv at D = 64: ring stages
#endif
#ifndef DQ_KEYS
#define DQ_KEYS 128      // dq at D = 64: keys per ring stage
#endif
#ifndef DQ_STAGES
#define DQ_STAGES 3      // dq: ring stages
#endif

namespace {

constexpr float DEAD = -0.5e30f;  // lse at or below this: a row with no valid key
constexpr int THREADS = 384;      // two consumer warpgroups and the producer's
constexpr int BK = 128;           // dk/dv: keys per block
constexpr int BM = 128;           // dq: queries per block

// rows [r0, r0 + rows) of a [*, D] bf16 output (row stride `ld` elements,
// `limit` rows in all) set to 0 by the whole block
template <int D>
__device__ __forceinline__ void zero_rows(__nv_bfloat16* out, long long ld, int r0, int rows, int limit) {
  for (int i = threadIdx.x; i < rows * (D / 8); i += THREADS) {
    const int r = r0 + i / (D / 8);
    if (r < limit) *reinterpret_cast<uint4*>(out + r * ld + (i % (D / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// shared memory of the dk/dv kernel: K and V (BK rows), then NS stages of Q,
// dO (BQ rows each), lse and delta, then the barriers
template <int D>
struct DkvSmem {
  static constexpr int BQ = D == 64 ? DKV_QUERIES : 64;  // queries per stage (D = 128: the registers allow 64)
  static constexpr int NS = D == 64 ? DKV_STAGES : 2;  // ring stages
  static constexpr int KV = D / 64 * BK * ROW;
  static constexpr int QO = D / 64 * BQ * ROW;
  static constexpr int K_OFF = 0, V_OFF = KV, Q_OFF = 2 * KV, O_OFF = Q_OFF + NS * QO;
  static constexpr int LSE_OFF = O_OFF + NS * QO, DL_OFF = LSE_OFF + NS * BQ * 4;
  static constexpr int BAR_OFF = DL_OFF + NS * BQ * 4;  // kv, full[NS], empty[NS]
  static constexpr int BYTES = BAR_OFF + (1 + 2 * NS) * 8 + 1024;  // + slack for 1024-byte alignment
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_kernel(
    __grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
    __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap to,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_start, const int* __restrict__ kv_end,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int S, int S_pad, int T, int NH, int group, float scale, int causal) {
  using L = DkvSmem<D>;
  constexpr int BQ = L::BQ, NS = L::NS;
  const int tid = threadIdx.x, wg = tid / 128;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const long long ld = static_cast<long long>(gridDim.y) * D;  // NKV * D: one key's row of dk, dv
  __nv_bfloat16* dk_b = dk + static_cast<long long>(b) * T * ld + kvh * D;
  __nv_bfloat16* dv_b = dv + static_cast<long long>(b) * T * ld + kvh * D;
  const int start = max(0, min(kv_start[b], T)), end = max(0, min(kv_end[b], T));
  const int n_iq = (S + BQ - 1) / BQ;
  const int iq_lo = causal ? min(k0 / BQ, n_iq) : 0;  // earlier query tiles see none of these keys
  const int per_head = n_iq - iq_lo;
  const int n_items = (k0 < end && k0 + BK > start) ? group * per_head : 0;
  if (n_items == 0) {  // no query sees these keys
    zero_rows<D>(dk_b, ld, k0, BK, T);
    zero_rows<D>(dv_b, ld, k0, BK, T);
    return;
  }

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sb = (smem_u32(smem_raw) + 1023) & ~1023u;
  const unsigned char* smem = smem_raw + (sb - smem_u32(smem_raw));
  const uint32_t bar_kv = sb + L::BAR_OFF;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_kv + 8 + 8 * NS;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    setmaxnreg_producer();
    if (tid == 256) {
      mbar_expect_tx(bar_kv, 2 * L::KV);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sb + L::K_OFF + c * BK * ROW, &tk, bar_kv, c * 64, kvh, k0, b);
        tma_load(sb + L::V_OFF + c * BK * ROW, &tv, bar_kv, c * 64, kvh, k0, b);
      }
      int stage = 0, phase = 0;
      for (int n = 0; n < n_items; ++n) {
        const int h = kvh * group + n / per_head, q0 = (iq_lo + n % per_head) * BQ;
        const uint32_t full = bar_full + 8 * stage;
        mbar_wait(bar_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full, 2 * L::QO + 2 * BQ * 4);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(sb + L::Q_OFF + stage * L::QO + c * BQ * ROW, &tq, full, c * 64, h, q0, b);
          tma_load(sb + L::O_OFF + stage * L::QO + c * BQ * ROW, &to, full, c * 64, h, q0, b);
        }
        const long long row = (static_cast<long long>(b) * NH + h) * S_pad + q0;
        bulk_load(sb + L::LSE_OFF + stage * BQ * 4, lse + row, BQ * 4, full);
        bulk_load(sb + L::DL_OFF + stage * BQ * 4, delta + row, BQ * 4, full);
        if (++stage == NS) stage = 0, phase ^= 1;
      }
    }
  } else {  // consumers: warpgroup wg owns keys [kw0, kw0 + 64)
    setmaxnreg_consumer();
    const int lane = tid % 32, wi = (tid % 128) / 32, g = lane / 4, t = lane % 4;
    const int kw0 = k0 + 64 * wg;
    const int keyA = kw0 + 16 * wi + g, keyB = keyA + 8;
    const bool live = kw0 < end && kw0 + 64 > start;
    const bool inside = kw0 >= start && kw0 + 64 <= end;
    const float sl2 = scale * LOG2E;
    const uint32_t ka = sb + L::K_OFF + wg * 64 * ROW, va = sb + L::V_OFF + wg * 64 * ROW;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(bar_kv, 0);
    int stage = 0, phase = 0;
    for (int n = 0; n < n_items; ++n) {
      const int q0 = (iq_lo + n % per_head) * BQ;
      mbar_wait(bar_full + 8 * stage, phase);
      if (live && !(causal && q0 + BQ <= kw0)) {  // else nothing of this item reaches these keys
        const uint32_t qs = sb + L::Q_OFF + stage * L::QO, os = sb + L::O_OFF + stage * L::QO;
        float s[BQ / 2], dp[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BQ>::ss(s, desc(ka + (kk / 4) * BK * ROW + (kk % 4) * 32, 16),
                        desc(qs + (kk / 4) * BQ * ROW + (kk % 4) * 32, 16), kk);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BQ>::ss(dp, desc(va + (kk / 4) * BK * ROW + (kk % 4) * 32, 16),
                        desc(os + (kk / 4) * BQ * ROW + (kk % 4) * 32, 16), kk);
        wgmma_commit();
        wgmma_wait<1>();  // S^T is in; dP^T may still be running
        fence_regs(s);

        // P^T in s, under the dP^T product; the mask only on boundary tiles
        const float* ls = reinterpret_cast<const float*>(smem + L::LSE_OFF + stage * BQ * 4);
        const float* dl = reinterpret_cast<const float*>(smem + L::DL_OFF + stage * BQ * 4);
        const bool full = inside && (!causal || kw0 + 63 <= q0);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qi = 8 * j + 2 * t + c;
            const float l = ls[qi];
            const float l2 = l > DEAD ? l * LOG2E : inf();
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * j + 2 * r + c;
              float x = fmaf(s[i], sl2, -l2);
              if (!full) {
                const int key = r ? keyB : keyA;
                if (key < start || key >= end || (causal && key > q0 + qi)) x = -inf();
              }
              s[i] = ex2(x);
            }
          }
        }
        // dS^T in dp
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float d = dl[8 * j + 2 * t + c];
#pragma unroll
            for (int r = 0; r < 2; ++r) dp[4 * j + 2 * r + c] = s[4 * j + 2 * r + c] * (dp[4 * j + 2 * r + c] - d);
          }
        }

        // dV += bf16(P^T) dO, dK += bf16(dS^T) Q (k = queries); every
        // fragment is packed before the first product, so that no register
        // write falls between two of them
        uint32_t ap[BQ / 16][4], ad[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          a_frag(ap[kk], s, kk);
          a_frag(ad[kk], dp, kk);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          Wgmma<D>::rs(dva, ap[kk], desc(os + kk * 16 * ROW, BQ * ROW), 1);
          Wgmma<D>::rs(dka, ad[kk], desc(qs + kk * 16 * ROW, BQ * ROW), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dka);
        fence_regs(dva);
      }
      mbar_arrive(bar_empty + 8 * stage);
      if (++stage == NS) stage = 0, phase ^= 1;
    }

#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (keyA < T) {
        *reinterpret_cast<uint32_t*>(dk_b + keyA * ld + col) = pack_bf16(dka[4 * j] * scale, dka[4 * j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv_b + keyA * ld + col) = pack_bf16(dva[4 * j], dva[4 * j + 1]);
      }
      if (keyB < T) {
        *reinterpret_cast<uint32_t*>(dk_b + keyB * ld + col) =
            pack_bf16(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv_b + keyB * ld + col) = pack_bf16(dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  }
}

// shared memory of the dq kernel: Q and dO (BM rows), then NS stages of K
// and V (BN rows each), then the barriers
template <int D>
struct DqSmem {
  static constexpr int BN = D == 64 ? DQ_KEYS : 64;  // keys per stage
  static constexpr int NS = DQ_STAGES;
  static constexpr int QO = D / 64 * BM * ROW;
  static constexpr int KV = D / 64 * BN * ROW;
  static constexpr int Q_OFF = 0, O_OFF = QO, K_OFF = 2 * QO, V_OFF = K_OFF + NS * KV;
  static constexpr int BAR_OFF = V_OFF + NS * KV;  // qo, full[NS], empty[NS]
  static constexpr int BYTES = BAR_OFF + (1 + 2 * NS) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(
    __grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
    __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap to,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_start, const int* __restrict__ kv_end,
    __nv_bfloat16* __restrict__ dq, int S, int S_pad, int T, int NH, int group, float scale, int causal) {
  using L = DqSmem<D>;
  constexpr int BN = L::BN, NS = L::NS;
  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const long long ld = static_cast<long long>(NH) * D;
  __nv_bfloat16* dq_b = dq + static_cast<long long>(b) * S * ld + h * D;
  const int start = max(0, min(kv_start[b], T)), end = max(0, min(kv_end[b], T));
  const int j_lo = start / BN;
  int j_hi = (end + BN - 1) / BN;
  if (causal) j_hi = min(j_hi, (min(q0 + BM, S) - 1) / BN + 1);
  const int n_items = max(0, j_hi - j_lo);
  if (n_items == 0) {  // no row of the tile sees a key
    zero_rows<D>(dq_b, ld, q0, BM, S);
    return;
  }

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sb = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_qo = sb + L::BAR_OFF;
  const uint32_t bar_full = bar_qo + 8, bar_empty = bar_qo + 8 + 8 * NS;
  if (tid == 0) {
    mbar_init(bar_qo, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    setmaxnreg_producer();
    if (tid == 256) {
      mbar_expect_tx(bar_qo, 2 * L::QO);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sb + L::Q_OFF + c * BM * ROW, &tq, bar_qo, c * 64, h, q0, b);
        tma_load(sb + L::O_OFF + c * BM * ROW, &to, bar_qo, c * 64, h, q0, b);
      }
      int stage = 0, phase = 0;
      for (int n = 0; n < n_items; ++n) {
        const int t0 = (j_lo + n) * BN;
        const uint32_t full = bar_full + 8 * stage;
        mbar_wait(bar_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full, 2 * L::KV);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(sb + L::K_OFF + stage * L::KV + c * BN * ROW, &tk, full, c * 64, kvh, t0, b);
          tma_load(sb + L::V_OFF + stage * L::KV + c * BN * ROW, &tv, full, c * 64, kvh, t0, b);
        }
        if (++stage == NS) stage = 0, phase ^= 1;
      }
    }
  } else {  // consumers: warpgroup wg owns queries [m0, m0 + 64)
    setmaxnreg_consumer();
    const int lane = tid % 32, wi = (tid % 128) / 32, g = lane / 4, t = lane % 4;
    const int m0 = q0 + 64 * wg;
    const int rowA = m0 + 16 * wi + g, rowB = rowA + 8;
    int j_end = j_hi;  // this warpgroup's last key tile + 1
    if (m0 >= S) j_end = j_lo;
    else if (causal) j_end = min(j_hi, (min(m0 + 64, S) - 1) / BN + 1);
    const long long sr = (static_cast<long long>(b) * NH + h) * S_pad;  // rows < S_pad: padded by the caller
    const float lA = lse[sr + rowA], lB = lse[sr + rowB];
    const float l2A = lA > DEAD ? lA * LOG2E : inf(), l2B = lB > DEAD ? lB * LOG2E : inf();
    const float dlA = delta[sr + rowA], dlB = delta[sr + rowB];
    const float sl2 = scale * LOG2E;
    const uint32_t qa = sb + L::Q_OFF + wg * 64 * ROW, oa = sb + L::O_OFF + wg * 64 * ROW;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(bar_qo, 0);
    int stage = 0, phase = 0;
    for (int n = 0; n < n_items; ++n) {
      const int j = j_lo + n, t0 = j * BN;
      mbar_wait(bar_full + 8 * stage, phase);
      if (j < j_end) {  // else past this warpgroup's diagonal
        const uint32_t ks = sb + L::K_OFF + stage * L::KV, vs = sb + L::V_OFF + stage * L::KV;
        float s[BN / 2], dp[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BN>::ss(s, desc(qa + (kk / 4) * BM * ROW + (kk % 4) * 32, 16),
                        desc(ks + (kk / 4) * BN * ROW + (kk % 4) * 32, 16), kk);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BN>::ss(dp, desc(oa + (kk / 4) * BM * ROW + (kk % 4) * 32, 16),
                        desc(vs + (kk / 4) * BN * ROW + (kk % 4) * 32, 16), kk);
        wgmma_commit();
        wgmma_wait<1>();  // S is in; dP may still be running
        fence_regs(s);

        // P in s, under the dP product; the mask only on boundary tiles
        const bool full = t0 >= start && t0 + BN <= end && (!causal || t0 + BN - 1 <= m0);
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jn + e;
            const bool upper = e < 2;
            float x = fmaf(s[i], sl2, upper ? -l2A : -l2B);
            if (!full) {
              const int col = t0 + 8 * jn + 2 * t + (e & 1), row = upper ? rowA : rowB;
              if (col < start || col >= end || (causal && col > row)) x = -inf();
            }
            s[i] = ex2(x);
          }
        }
        // dS in s
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] *= dp[i] - (i % 4 < 2 ? dlA : dlB);

        // dQ += bf16(dS) K (k = keys), the fragments packed first
        uint32_t a[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) a_frag(a[kk], s, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) Wgmma<D>::rs(acc, a[kk], desc(ks + kk * 16 * ROW, BN * ROW), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      mbar_arrive(bar_empty + 8 * stage);
      if (++stage == NS) stage = 0, phase ^= 1;
    }

#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const int col = 8 * jd + 2 * t;
      if (rowA < S)
        *reinterpret_cast<uint32_t*>(dq_b + rowA * ld + col) = pack_bf16(acc[4 * jd] * scale, acc[4 * jd + 1] * scale);
      if (rowB < S)
        *reinterpret_cast<uint32_t*>(dq_b + rowB * ld + col) =
            pack_bf16(acc[4 * jd + 2] * scale, acc[4 * jd + 3] * scale);
    }
  }
}

// --- host ------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *kv_start, *kv_end;
  int B, S, S_pad, T, NH, NKV;
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh;
  float scale;
  int causal;
  cudaStream_t stream;
};

// the four tensor maps: Q and dO in boxes of `q_rows` rows, K and V of `kv_rows`
template <int D>
int make_maps(CUtensorMap (&m)[4], const Args& a, int q_rows, int kv_rows) {
  int rc;
  if ((rc = make_map(&m[0], a.q, a.B, a.S, a.NH, D, a.q_sb, a.q_ss, a.q_sh, q_rows))) return rc;
  if ((rc = make_map(&m[1], a.k, a.B, a.T, a.NKV, D, a.k_sb, a.k_st, a.k_sh, kv_rows))) return rc;
  if ((rc = make_map(&m[2], a.v, a.B, a.T, a.NKV, D, a.v_sb, a.v_st, a.v_sh, kv_rows))) return rc;
  return make_map(&m[3], a.dout, a.B, a.S, a.NH, D, a.o_sb, a.o_ss, a.o_sh, q_rows);
}

template <int D>
int launch_dq(const Args& a, void* dq) {
  CUtensorMap m[4];
  if (const int rc = make_maps<D>(m, a, BM, DqSmem<D>::BN)) return rc;
  constexpr int smem = DqSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BM - 1) / BM, a.NH, a.B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.kv_start), static_cast<const int*>(a.kv_end), static_cast<__nv_bfloat16*>(dq),
      a.S, a.S_pad, a.T, a.NH, a.NH / a.NKV, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  CUtensorMap m[4];
  if (const int rc = make_maps<D>(m, a, DkvSmem<D>::BQ, BK)) return rc;
  constexpr int smem = DkvSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T + BK - 1) / BK, a.NKV, a.B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.kv_start), static_cast<const int*>(a.kv_end), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.S, a.S_pad, a.T, a.NH, a.NH / a.NKV, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

static_assert(BM % DkvSmem<64>::BQ == 0 && BM % DkvSmem<128>::BQ == 0, "dk/dv stages must divide dq's tile");

// shapes the kernels do not take; lse and delta rows must hold whole tiles:
// dq reads BM rows a block, dk/dv a divisor of BM a stage
bool bad_shape(const Args& a, int D) {
  return a.B <= 0 || a.S <= 0 || a.T <= 0 || a.NH <= 0 || a.NKV <= 0 || a.NH % a.NKV != 0 ||
         a.S_pad % BM != 0 || a.S_pad < a.S || (D != 64 && D != 128);
}

}  // namespace

// Both entry points return 0, a cudaError_t, or 10000 + the CUresult of a
// tensor map that could not be encoded. lse and delta are [B, NH, S_pad] f32
// (S_pad a multiple of BM = 128; -1e30 and 0 past S).
extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    const void* kv_start, const void* kv_end, void* dq,
    int B, int S, int T, int NH, int NKV, int D, int S_pad,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, kv_start, kv_end, B, S, S_pad, T, NH, NKV,
               q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh,
               scale, causal, static_cast<cudaStream_t>(stream)};
  if (bad_shape(a, D)) return static_cast<int>(cudaErrorInvalidValue);
  return D == 64 ? launch_dq<64>(a, dq) : launch_dq<128>(a, dq);
}

extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    const void* kv_start, const void* kv_end, void* dk, void* dv,
    int B, int S, int T, int NH, int NKV, int D, int S_pad,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, kv_start, kv_end, B, S, S_pad, T, NH, NKV,
               q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh,
               scale, causal, static_cast<cudaStream_t>(stream)};
  if (bad_shape(a, D)) return static_cast<int>(cudaErrorInvalidValue);
  return D == 64 ? launch_dkv<64>(a, dk, dv) : launch_dkv<128>(a, dk, dv);
}
