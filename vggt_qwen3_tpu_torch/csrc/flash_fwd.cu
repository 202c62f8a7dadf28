// Flash-attention forward for Hopper (sm_90a), bf16 in and out, f32 softmax
// and accumulation.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (vggt_qwen3_tpu/ops/
// flash_attention.py:41, pallas_call at :274) reached through
// `flash_attention`. Same function: online-softmax attention with a per-row
// [kv_start, kv_end) frontier plus an optional slot-causal mask, GQA query
// head h reading kv head h / group, QK in bf16 with f32 accumulation and the
// scale applied to the f32 scores, the unnormalised P rounded to bf16 before
// PV, m/l/acc in f32, output acc / max(l, 1e-20) (a row with no valid key
// gives 0). With a non-null lse pointer the kernel also writes each row's
// logsumexp m + log(max(l, 1e-30)) in f32 ([B, NH, S], natural-log units;
// -1e30 on a row with no valid key), as the TPU kernel's lse output does
// (:130-139) -- the statistic the backward kernels (flash_bwd.cu) recompute P
// from. A null pointer writes none.
//
// What bounds it on the H100: 4 * B*NH*S*T*D tensor-core FLOPs against a few
// MB of q/k/v, so operations -- and beside the products one exponential per
// valid score on the special function units (16 a clock per SM), which at
// D = 64 take 92 % of the products' time: a kernel that takes its
// exponentials between its products cannot get near the bound.
//
// Design (FlashAttention-3's forward). A block is NC consumer warpgroups of
// 64 rows each (3 at D = 64, 2 at D = 128) and a producer warpgroup that
// gives its registers to the consumers (setmaxnreg) and of which one thread
// issues every copy. A tile's rows are the queries of one kv head's GQA group
// packed query by query (row r: query q0 + r / G, head h0 + r % G, one TMA
// box of G heads), so a short prefill fills the tile and the group reads
// each K/V tile once; a group that does not divide the tile packs 1 head.
// Q comes in once; K and V tiles of BN
// keys stream through a ring of NS stages, with a full barrier each for K and
// V (so S = Q K^T starts before V lands) and one empty barrier a stage. All
// copies are TMA through 4-D tensor maps {D, H, S, B} over the strided
// [B, S, H, D] views, 64-column boxes with the 128-byte swizzle (hopper.cuh);
// TMA's zero fill covers the ragged S and T. Both products are wgmma: S from
// shared memory (Q and K both K-major), O += P V with P converted to bf16 in
// registers as the A operand and V an MN-major B from its shared tile; nothing
// goes back through shared memory. Exponentials are ex2 with scale * log2(e)
// folded into one FMA; the running max is kept in the log2 domain and lse
// converted back to natural log. Two overlaps keep the tensor cores busy
// while the exponentials run:
//  - FWD_OVERLAP: a warpgroup issues S_{j+1} = Q K_{j+1}^T and P_j V_j together,
//    takes the softmax of S_{j+1} while P_j V_j runs, and waits for it only
//    before rescaling O;
//  - FWD_PINGPONG: named barriers make the consumer warpgroups issue their
//    products in turn, so one warpgroup's products run under another's
//    exponentials.
// Tiles wholly outside [kv_start, kv_end) or wholly above the causal diagonal
// are never visited; masks are built only on boundary tiles; O is rescaled
// exactly at every tile. Causal grids take the longest query tiles first.
// Every output is summed by one thread in a fixed order: no atomics, so two
// launches agree bit for bit. The epilogue stages a warpgroup's normalised
// bf16 rows in its rows of the Q tile (swizzled as TMA lays Q there) and each
// warp writes its 16 rows to out with 16-byte stores, a row to consecutive
// lanes. Tile, ring and warpgroup counts and the two overlaps are the nvcc
// defines below; their defaults are the fastest of those `python3
// chip_smoke.py --tiles flash_fwd` timed on the H100 (PERF.md, section 6).

#include "hopper.cuh"

#include <math.h>

#ifndef FWD_CONSUMERS_64
#define FWD_CONSUMERS_64 3  // D = 64: consumer warpgroups of 64 query rows (2 or 3)
#endif
#ifndef FWD_KEYS_64
#define FWD_KEYS_64 128     // D = 64: keys a ring stage (64 or 128)
#endif
#ifndef FWD_STAGES_64
#define FWD_STAGES_64 3     // D = 64: ring stages
#endif
#ifndef FWD_KEYS_128
#define FWD_KEYS_128 64     // D = 128: keys a ring stage (64 or 128)
#endif
#ifndef FWD_STAGES_128
#define FWD_STAGES_128 2    // D = 128: ring stages
#endif
#ifndef FWD_OVERLAP
#define FWD_OVERLAP 1       // issue S_{j+1} with P_j V_j; softmax of S_{j+1} under P_j V_j
#endif
#ifndef FWD_PINGPONG
#define FWD_PINGPONG 1      // consumer warpgroups issue their products in turn
#endif

namespace {

constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Fwd {
  static constexpr int NC = D == 64 ? FWD_CONSUMERS_64 : 2;      // consumer warpgroups
  static constexpr int BM = 64 * NC;                               // query rows a block
  static constexpr int BN = D == 64 ? FWD_KEYS_64 : FWD_KEYS_128;  // keys a stage
  static constexpr int NS = D == 64 ? FWD_STAGES_64 : FWD_STAGES_128;
  static constexpr int THREADS = 128 * (NC + 1);
  // registers a thread: the producer's 24, the rest shared by the consumers
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NC == 2 ? 240 : 160;
  static constexpr int QB = D / 64 * BM * ROW;  // bytes of the Q tile
  static constexpr int KB = D / 64 * BN * ROW;  // bytes of a K (or V) stage
  static constexpr int Q_OFF = 0, K_OFF = QB, V_OFF = K_OFF + NS * KB;
  static constexpr int BAR_OFF = V_OFF + NS * KB;  // q, full_k[NS], full_v[NS], empty[NS]
  static constexpr int BYTES = BAR_OFF + (1 + 3 * NS) * 8 + 1024;  // + slack for 1024-byte alignment
  static_assert(NC == 2 || NC == 3, "two or three consumer warpgroups");
  static_assert(BN == 64 || BN == 128, "64 or 128 keys a stage");
  static_assert(BYTES <= 232448, "shared memory of one block");
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * NC <= 65536, "registers of one SM");
};

// named barrier 1 + w orders warpgroup w's issue after warpgroup w - 1's
__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }
// named barrier id over one warpgroup's 128 threads
__device__ __forceinline__ void warpgroup_sync(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

// O += P V over one tile: p holds bf16(P) as wgmma's register A operand (k =
// the BN keys), V is an MN-major B from its shared tile at `vs`
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[BN / 16][4], uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) Wgmma<D>::rs(o, p[kk], desc(vs + kk * 16 * ROW, BN * ROW), 1);
  wgmma_commit();
}

// S = Q K^T for one warpgroup's 64 rows and a stage of BN keys, both K-major
// in their swizzled tiles (Q's BM rows a 64-column box, K's BN)
template <int D, int BN, int BM>
__device__ __forceinline__ void issue_s(float (&s)[BN / 2], uint32_t qa, uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<BN>::ss(s, desc(qa + (kk / 4) * BM * ROW + (kk % 4) * 32, 16),
                  desc(ks + (kk / 4) * BN * ROW + (kk % 4) * 32, 16), kk);
  wgmma_commit();
}

// one thread's online-softmax state of its two rows (A: the accumulator's
// upper 8 rows of a warp, B: the lower): the running max of the scores times
// scale * log2(e), and the thread's share of the row sums
struct Rows {
  float mA, mB, lA, lB;
};

// The softmax of one tile of scores, in place: the mask on boundary tiles
// only (keys outside [start, end), above the diagonal), the new row maxima,
// s = 2^(s * sl2 - m) (0 where masked, and on a row with no key so far), the
// row sums into r; aA and aB are the factors that rescale O (exactly 1 where
// the max stays)
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], Rows& r, float& aA, float& aB, int t0, int start,
                                             int end, int causal, int m0, int rowA, int rowB, int t, float sl2) {
  if (!(t0 >= start && t0 + BN <= end && (!causal || t0 + BN - 1 <= m0))) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = t0 + 8 * (i / 4) + 2 * t + (i & 1), row = i % 4 < 2 ? rowA : rowB;
      if (col < start || col >= end || (causal && col > row)) s[i] = -inf();
    }
  }
  float xA = -inf(), xB = -inf();
#pragma unroll
  for (int i = 0; i < BN / 2; i += 4) {
    xA = fmaxf(xA, fmaxf(s[i], s[i + 1]));
    xB = fmaxf(xB, fmaxf(s[i + 2], s[i + 3]));
  }
  xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 1));
  xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 1));
  xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 2));
  xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 2));
  const float nA = fmaxf(r.mA, xA * sl2), nB = fmaxf(r.mB, xB * sl2);
  const float bA = nA == -inf() ? 0.f : nA, bB = nB == -inf() ? 0.f : nB;  // no key so far: p = 0
  aA = ex2(r.mA - bA);
  aB = ex2(r.mB - bB);
  float sumA = 0.f, sumB = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float x = fmaf(s[i], sl2, i % 4 < 2 ? -bA : -bB);
    s[i] = ex2(x);
    if (i % 4 < 2) sumA += s[i];
    else sumB += s[i];
  }
  r.mA = nA;
  r.mB = nB;
  r.lA = fmaf(r.lA, aA, sumA);
  r.lB = fmaf(r.lB, aB, sumB);
}

template <int D>
__global__ void __launch_bounds__(Fwd<D>::THREADS, 1) flash_fwd_kernel(
    __grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
    __grid_constant__ const CUtensorMap tv, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    const int* __restrict__ kv_start, const int* __restrict__ kv_end, int S, int T, int NH, int group, int pack,
    float scale, int causal) {
  using L = Fwd<D>;
  constexpr int NC = L::NC, BM = L::BM, BN = L::BN, NS = L::NS;
  const int tid = threadIdx.x, wg = tid / 128;
  // the tile's row r is query q0 + r / pack of head h0 + r % pack
  const int rows_q = BM / pack;                                       // queries a tile
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // causal: the longest rows first
  const int q0 = qt * rows_q, h0 = blockIdx.y * pack, b = blockIdx.z;
  const int kvh = h0 / group;
  const long long ld = static_cast<long long>(NH) * D;  // one query's row of out
  __nv_bfloat16* out_b = out + static_cast<long long>(b) * S * ld;
  float* lse_b = lse == nullptr ? nullptr : lse + static_cast<long long>(b) * NH * S;
  const int start = max(0, min(kv_start[b], T)), end = max(0, min(kv_end[b], T));
  const int j_lo = start / BN;
  int j_hi = (end + BN - 1) / BN;
  if (causal) j_hi = min(j_hi, (min(q0 + rows_q, S) - 1) / BN + 1);
  const int n_tiles = max(0, j_hi - j_lo);
  if (n_tiles == 0) {  // no row of the tile sees a key
    for (int i = tid; i < BM * (D / 8); i += L::THREADS) {
      const int r = i / (D / 8), sq = q0 + r / pack, h = h0 + r % pack;
      if (sq < S) *reinterpret_cast<uint4*>(out_b + sq * ld + h * D + (i % (D / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    if (lse_b != nullptr)
      for (int r = tid; r < BM; r += L::THREADS)
        if (q0 + r / pack < S) lse_b[static_cast<long long>(h0 + r % pack) * S + q0 + r / pack] = -1e30f;
    return;
  }

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sb = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = sb + L::BAR_OFF;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * NS, empty = full_v + 8 * NS;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {  // producer
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (tid == NC * 128) {
      mbar_expect_tx(bar_q, L::QB);
      for (int c = 0; c < D / 64; ++c) tma_load(sb + L::Q_OFF + c * BM * ROW, &tq, bar_q, c * 64, h0, q0, b);
      int stage = 0, phase = 0;
      for (int n = 0; n < n_tiles; ++n) {
        const int t0 = (j_lo + n) * BN;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full_k + 8 * stage, L::KB);
        for (int c = 0; c < D / 64; ++c)
          tma_load(sb + L::K_OFF + stage * L::KB + c * BN * ROW, &tk, full_k + 8 * stage, c * 64, kvh, t0, b);
        mbar_expect_tx(full_v + 8 * stage, L::KB);
        for (int c = 0; c < D / 64; ++c)
          tma_load(sb + L::V_OFF + stage * L::KB + c * BN * ROW, &tv, full_v + 8 * stage, c * 64, kvh, t0, b);
        if (++stage == NS) stage = 0, phase ^= 1;
      }
    }
  } else {  // consumers: warpgroup wg owns the tile's rows [64 wg, 64 wg + 64)
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int lane = tid % 32, wi = (tid % 128) / 32, g = lane / 4, t = lane % 4;
    const int m0 = q0 + 64 * wg / pack;                   // the warpgroup's first query
    const int rA = 64 * wg + 16 * wi + g, rB = rA + 8;    // the two rows this thread holds:
    const int rowA = q0 + rA / pack, rowB = q0 + rB / pack;  // their queries
    const int hA = h0 + rA % pack, hB = h0 + rB % pack;      // and heads
    const float sl2 = scale * LOG2E;
    const uint32_t qa = sb + L::Q_OFF + wg * 64 * ROW;
    float o[D / 2], s[BN / 2];
    uint32_t p[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    Rows r{-inf(), -inf(), 0.f, 0.f};
    const bool last_wg = wg == NC - 1;
    mbar_wait(bar_q, 0);
    const int next = 1 + (wg + 1) % NC;  // the named barrier of the warpgroup that issues after this one
    if (FWD_PINGPONG && last_wg) named_arrive(1);  // warpgroup 0 issues first
    // tile 0: S_0 alone, then its softmax (O is still 0)
    int stage = 0, phase = 0;
    mbar_wait(full_k, 0);
    if (FWD_PINGPONG) named_sync(1 + wg);
    wgmma_fence();
    issue_s<D, BN, BM>(s, qa, sb + L::K_OFF);
    if (FWD_PINGPONG && !(last_wg && n_tiles == 1)) named_arrive(next);
    wgmma_wait<0>();
    fence_regs(s);
    float aA, aB;
    softmax_tile<BN>(s, r, aA, aB, j_lo * BN, start, end, causal, m0, rowA, rowB, t, sl2);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) a_frag(p[kk], s, kk);
    if (!FWD_OVERLAP) {
      mbar_wait(full_v, 0);
      wgmma_fence();
      issue_pv<D, BN>(o, p, sb + L::V_OFF);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty);
    }
    for (int n = 1; n < n_tiles; ++n) {
      const int prev = stage, prev_phase = phase;  // tile n - 1's
      if (++stage == NS) stage = 0, phase ^= 1;
      mbar_wait(full_k + 8 * stage, phase);
      if (FWD_OVERLAP) mbar_wait(full_v + 8 * prev, prev_phase);
      if (FWD_PINGPONG) named_sync(1 + wg);
      wgmma_fence();
      issue_s<D, BN, BM>(s, qa, sb + L::K_OFF + stage * L::KB);
      if (FWD_OVERLAP) issue_pv<D, BN>(o, p, sb + L::V_OFF + prev * L::KB);  // P_{n-1} V_{n-1} with S_n
      // the last warpgroup's last turn would open one more than warpgroup 0 takes
      if (FWD_PINGPONG && !(last_wg && n == n_tiles - 1)) named_arrive(next);
      if (FWD_OVERLAP) wgmma_wait<1>();  // S_n is in; P_{n-1} V_{n-1} may still run
      else wgmma_wait<0>();
      fence_regs(s);
      softmax_tile<BN>(s, r, aA, aB, (j_lo + n) * BN, start, end, causal, m0, rowA, rowB, t, sl2);
      if (FWD_OVERLAP) {
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty + 8 * prev);  // tile n - 1's K and V are read
      }
      // O rescaled before P_n V_n adds to it
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= i % 4 < 2 ? aA : aB;
      fence_regs(s);  // p is rewritten only after P_{n-1} V_{n-1} has read it
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) a_frag(p[kk], s, kk);
      if (!FWD_OVERLAP) {
        mbar_wait(full_v + 8 * stage, phase);
        wgmma_fence();
        issue_pv<D, BN>(o, p, sb + L::V_OFF + stage * L::KB);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty + 8 * stage);
      }
    }
    if (FWD_OVERLAP) {  // the last tile's P V
      mbar_wait(full_v + 8 * stage, phase);
      wgmma_fence();
      issue_pv<D, BN>(o, p, sb + L::V_OFF + stage * L::KB);
      wgmma_wait<0>();
      fence_regs(o);
    }
    float lA = r.lA, lB = r.lB;

    // full row sums over the lane quad, then normalise and store
    lA += __shfl_xor_sync(0xffffffffu, lA, 1);
    lB += __shfl_xor_sync(0xffffffffu, lB, 1);
    lA += __shfl_xor_sync(0xffffffffu, lA, 2);
    lB += __shfl_xor_sync(0xffffffffu, lB, 2);
    if (lse_b != nullptr && t == 0) {
      if (rowA < S)
        lse_b[static_cast<long long>(hA) * S + rowA] = r.mA == -inf() ? -1e30f : fmaf(r.mA, LN2, logf(fmaxf(lA, 1e-30f)));
      if (rowB < S)
        lse_b[static_cast<long long>(hB) * S + rowB] = r.mB == -inf() ? -1e30f : fmaf(r.mB, LN2, logf(fmaxf(lB, 1e-30f)));
    }
    const float iA = 1.f / fmaxf(lA, 1e-20f), iB = 1.f / fmaxf(lB, 1e-20f);
    // the warpgroup's rows of the Q tile take its bf16 output once all of its
    // products have read them: 16-byte chunk c of local row r at chunk
    // c ^ (r % 8) of the row, so neither the fragment writes nor the row
    // reads below meet a bank conflict
    unsigned char* const st = smem_raw + (qa - smem_u32(smem_raw));
    const int lr = 16 * wi + g;  // local row of A; B is lr + 8, with the same r % 8
    warpgroup_sync(1 + NC + wg);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* const at = st + (j / 8) * BM * ROW + lr * ROW + (((j % 8) ^ g) * 16) + 4 * t;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(o[4 * j] * iA, o[4 * j + 1] * iA);
      *reinterpret_cast<uint32_t*>(at + 8 * ROW) = pack_bf16(o[4 * j + 2] * iB, o[4 * j + 3] * iB);
    }
    __syncwarp();
    // each warp writes its own 16 rows: D / 8 consecutive lanes a row
#pragma unroll
    for (int i = lane; i < 16 * (D / 8); i += 32) {
      const int row = 16 * wi + i / (D / 8), j = i % (D / 8);
      const int sq = q0 + (64 * wg + row) / pack, h = h0 + (64 * wg + row) % pack;
      if (sq < S)
        *reinterpret_cast<uint4*>(out_b + sq * ld + h * D + 8 * j) =
            *reinterpret_cast<const uint4*>(st + (j / 8) * BM * ROW + row * ROW + (((j % 8) ^ (row % 8)) * 16));
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, const void* kv_start,
           const void* kv_end, int B, int S, int T, int NH, int NKV, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
           float scale, int causal, cudaStream_t stream) {
  using L = Fwd<D>;
  // a tile packs the query heads of a GQA group that divides its rows (one
  // TMA box of {64, pack, BM / pack}): short prefills fill its rows, and the
  // group reads each K/V tile once
  const int group = NH / NKV, pack = L::BM % group == 0 ? group : 1;
  CUtensorMap tq, tk, tv;
  int rc;
  if ((rc = make_map(&tq, q, B, S, NH, D, q_sb, q_ss, q_sh, L::BM / pack, pack))) return rc;
  if ((rc = make_map(&tk, k, B, T, NKV, D, k_sb, k_st, k_sh, L::BN))) return rc;
  if ((rc = make_map(&tv, v, B, T, NKV, D, v_sb, v_st, v_sh, L::BN))) return rc;
  const cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_q = L::BM / pack;
  const dim3 grid((S + rows_q - 1) / rows_q, NH / pack, B);
  flash_fwd_kernel<D><<<grid, L::THREADS, L::BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), static_cast<const int*>(kv_start),
      static_cast<const int*>(kv_end), S, T, NH, group, pack, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0, a cudaError_t, or 10000 + the CUresult of a tensor map that
// could not be encoded. q [B, S, NH, D], k and v [B, T, NKV, D] bf16 are read
// through their strides (in elements; the head dim contiguous, the others
// multiples of 8 and positive); out is a contiguous [B, S, NH, D] bf16, lse
// a contiguous [B, NH, S] f32 or null.
extern "C" int flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* kv_start, const void* kv_end,
    int B, int S, int T, int NH, int NKV, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || NH <= 0 || NKV <= 0 || NH % NKV != 0 || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(q, k, v, out, lse, kv_start, kv_end, B, S, T, NH, NKV, q_sb, q_ss, q_sh, k_sb, k_st,
                              k_sh, v_sb, v_st, v_sh, scale, causal, st)
                 : launch<128>(q, k, v, out, lse, kv_start, kv_end, B, S, T, NH, NKV, q_sb, q_ss, q_sh, k_sb, k_st,
                               k_sh, v_sb, v_st, v_sh, scale, causal, st);
}
