// GQA decode attention and speculative block-verify attention over the
// stacked head-major KV cache, for Hopper (sm_90a): one kernel body for
// both. bf16 queries; bf16 cache, or int8 cache with bf16 per-(token, head)
// scales.
//
// Replaces the Pallas TPU kernel `_decode_kernel` (vggt_qwen3_tpu/ops/
// decode_attention.py:55, pallas_call at :239), reached through
// `gqa_decode_attention` (:270) and `gqa_block_verify_attention` (:317).
// Same function: for batch row b, a block of S query tokens (S = 1 for
// decode) attends to layer li's cache, query j seeing the slots
// [start, end0 + j) with start = clip(kv_start, 0, T) and end0 = clip(kv_end,
// 0, T) for decode, clip(kv_off + 1, 0, T - (S - 1)) for verify. bf16 cache:
// scores x D^-0.5. int8 cache: scores x (ks * D^-0.5), the row sum l taken
// before p is multiplied by the V scale. f32 softmax; output divided by
// max(l, 1e-20), so a query with no valid slot gives exactly 0.
//
// What bounds it on the H100: bytes. Every valid K/V slot of the layer is
// read once for the S * group score rows of its kv head (4 at decode, 28 at
// the ARKit verify block), about 4 * S * group flops per K/V value pair, far
// below the card's ~295 flops/byte ridge. What the design does about it:
//
// - A split over the cache, merged inside a thread-block cluster. The grid is
//   (P, NKV, B) and the P splits of one (row, kv head) form one cluster. The
//   slots [start, end0 + S - 1) of the row are cut on the device, from the
//   row's own frontier, into P shares of a multiple of 16 slots counted back
//   from the frontier (a short row lies in the last splits only). Each split
//   keeps its own (m, l, acc) per score row (-inf, 0, 0 where it saw no valid
//   slot); after a cluster barrier each block merges a share of the output
//   elements from the P partials in split order through distributed shared
//   memory. No workspace in device memory, no atomics: a launch repeats bit
//   for bit. P is `split_plan(B, NKV, T)`, a function of the shapes alone
//   (never of the frontiers, which would cost a host sync a layer): more
//   splits while B * NKV * P stays within PLAN_BLOCKS blocks and each split
//   can get a tile, at most PLAN_MAX_SPLITS (a cluster; 1 at the W8 bench's
//   368 rows, whose 2944 (row, head) pairs fill the card).
// - Tensor-core scores and P V with mma.sync m16n8k16 (bf16 in, f32
//   accumulate); wgmma's 64-row minimum would waste most of its rows on 4-28
//   score rows, and the kernel is bound by bytes, so mma.sync serves. bf16 x
//   bf16 products are exact in f32, and int8 values are exact in bf16, so the
//   scores equal the plain version's up to summation order. P stays f32: p *
//   vs is split into a bf16 head and a bf16 residual and both go through the
//   tensor cores (the JAX kernel's pv_split; ~2^-16 relative), never rounded
//   to bf16 once. Two layouts (RowsOnM, RowsOnN below): the verify block puts
//   its score rows (r = j * group + g) on the M side, 16 a warp, and P's A
//   fragments are its score accumulators; decode (at most 8 rows) swaps the
//   operands, S^T = K Q^T and acc^T += V^T P^T, so that its rows fill an
//   8-wide n-tile with no padding to 16 (half the mma.sync and accumulators),
//   P^T's B fragments coming from the accumulators through movmatrix.trans.
//   A block has (rows / 16) x WS warps: each warp owns one row tile and SPW =
//   TILE_SLOTS / WS slots of every tile, with its own online softmax; the WS
//   warps of a row tile merge through shared memory before the cluster merge.
// - int8 K/V become bf16 fragments in registers: a byte b is put onto 2^23 +
//   128 + b by a byte permute and 2^23 + 128 is subtracted (exact). K rows go
//   through ldmatrix as b16 pairs, so a thread holds 4 consecutive depths of a
//   slot; the query fragments are read in the same permuted depth order, and
//   the products sum over the same pairs. V is read with ldmatrix.trans on
//   b16 pairs of depths: a register holds two depths of two slots, that is
//   the fragments of two tiles of depths (even and odd). bf16 V takes a plain
//   ldmatrix.trans.
// - A ring of RING_STAGES tiles of TILE_SLOTS slots, loaded with 16-byte
//   cp.async (no tensor map, so the host does no work a call beyond today's),
//   rows padded by 16 bytes so that ldmatrix hits distinct banks. Slots past
//   the split's end are not read: cp.async zero-fills their rows, and their p
//   is 0. A warp whose slots all lie past every one of its rows' frontiers
//   skips the tile. The layer is chosen by pointer offset: no per-layer copy.
//   The defaults (32-slot tiles, two stages, at most 8 splits) are the
//   fastest of the H100 sweep (`python3 chip_smoke.py --tiles
//   decode_attention`, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#ifndef TILE_SLOTS
#define TILE_SLOTS 32       // cache slots of a ring stage (32 or 64)
#endif
#ifndef RING_STAGES
#define RING_STAGES 2       // stages of the K/V ring
#endif
#ifndef PLAN_MAX_SPLITS
#define PLAN_MAX_SPLITS 8   // splits of a row at most: a cluster (1, 2, 4 or 8)
#endif

namespace {

constexpr int BT = TILE_SLOTS;
constexpr int NS = RING_STAGES;
constexpr int MAX_ROWS = 128;  // S * group score rows a block serves
constexpr int MAX_GROUP = 8;   // query heads per kv head (decode)
constexpr int DECODE_WARPS = BT / 16 < 4 ? BT / 16 : 4;  // a decode block: one row tile, 16 slots a warp
constexpr int DECODE_SM_WARPS = 16;  // decode warps an SM asked of ptxas (__launch_bounds__): 128 registers
constexpr int PLAN_BLOCKS = 264;     // blocks a launch may reach by splitting: two an SM
static_assert(BT == 32 || BT == 64, "TILE_SLOTS is 32 or 64");
static_assert(NS >= 2 && NS <= 6, "RING_STAGES is 2-6");
static_assert(PLAN_MAX_SPLITS == 1 || PLAN_MAX_SPLITS == 2 || PLAN_MAX_SPLITS == 4 || PLAN_MAX_SPLITS == 8,
              "PLAN_MAX_SPLITS is a portable cluster size");

struct Args {
  const __nv_bfloat16* q;   // [B, S, NH, D]
  const void* k;            // layer li: [B, NKV, T, D], bf16 or int8
  const void* v;
  const __nv_bfloat16* ks;  // layer li: [B, NKV, T] (int8 cache)
  const __nv_bfloat16* vs;
  __nv_bfloat16* out;       // [B, S, NH, D]
  const int* kv_start;      // [B]
  const int* kv_end;        // [B]: end0 = clip(kv_end + end_add, 0, T - (S - 1))
  int S, NH, NKV, T, end_add;
  float scale;
};

// --- small helpers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// an 8 x 8 b16 matrix held one row pair a thread (row l / 4, columns 2 (l % 4)
// and + 1), transposed: the thread then holds column l / 4, rows 2 (l % 4), + 1
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = head + residual, each rounded to bf16 once: the head's error, x -
// head, is exact in f32, so only the residual's rounding (~2^-16 of x) is lost
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& head, uint32_t& rest) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  head = *reinterpret_cast<const uint32_t*>(&h);
  rest = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// The four signed bytes of r as exact floats: byte b becomes the float
// 2^23 + 128 + b (bits 0x4B0000uu, uu = b ^ 0x80), less 2^23 + 128.
__device__ __forceinline__ void s8x4_to_f32(uint32_t r, float (&f)[4]) {
  const uint32_t u = r ^ 0x80808080u;
  constexpr float BIAS = 8388736.f;  // 2^23 + 128
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - BIAS;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - BIAS;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - BIAS;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - BIAS;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// block `rank`'s shared-memory address of the local address `addr`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

// --- shared memory -------------------------------------------------------------

// The ring: NS stages of a K tile and a V tile, [BT][KROW] bytes each (a row
// is one slot's D values and 16 bytes of padding: ldmatrix's 8 rows of a
// matrix then fall on distinct banks), then the tile's K scales x D^-0.5 and V
// scales, f32 [BT] each. After the main loop the same bytes hold the partials:
// the warps' (acc [WS][R][PROW], m [WS][R], l [WS][R]), then, with WS > 1, the
// block's (acc [R][PROW], m [R], l [R]).
template <int D, typename KV>
struct Smem {
  static constexpr int KROW = D * static_cast<int>(sizeof(KV)) + 16;
  static constexpr int TILE = BT * KROW;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int SCALES = NS * STAGE;
  static constexpr int LOOP = SCALES + 2 * BT * 4;
  // f32 row stride of the partials: the C fragments' stores hit distinct banks
  static constexpr int PROW = D + (sizeof(KV) == 1 ? 16 : 8);
  static __host__ __device__ constexpr int part_floats(int R) { return R * PROW + 2 * R; }
  static __host__ __device__ constexpr int bytes(int R, int WS) {
    const int parts = 4 * part_floats(R) * (WS > 1 ? WS + 1 : 1);
    return LOOP > parts ? LOOP : parts;
  }
};

// --- the two ways to lay a tile's products on the tensor cores -------------------

// Where a thread finds a score row's query in q (and its output in out).
struct Rows {
  const __nv_bfloat16* q;
  long long base;  // (b * S) * NH + kvh * G
  int NH, G;
  __device__ __forceinline__ long long offset(int r, int D) const {
    return (base + static_cast<long long>(r / G) * NH + r % G) * D;
  }
};

// Query fragments of row r (zero past R), depths of k-step kk as the K
// fragments hold them: bf16 K gives depths 2 tig, 2 tig + 1 and + 8; int8 K,
// read through ldmatrix as b16 pairs, gives a thread the 4 consecutive depths
// 4 tig .. 4 tig + 3 of each k-step, so the queries take that order too.
template <int D, bool QUANT>
__device__ __forceinline__ void query_words(const Rows& rows, int r, int R, int kk, int tig, uint32_t& w0,
                                            uint32_t& w2) {
  const __nv_bfloat16* p = rows.q + rows.offset(r < R ? r : R - 1, D);
  const int o0 = QUANT ? 16 * kk + 4 * tig : 16 * kk + 2 * tig;
  w0 = r < R ? *reinterpret_cast<const uint32_t*>(p + o0) : 0u;
  w2 = r < R ? *reinterpret_cast<const uint32_t*>(p + (QUANT ? o0 + 2 : o0 + 8)) : 0u;
}

// The online softmax's step for one row: the new running max, the factor
// alpha on what was summed before, and the base the new p are taken against
// (0 while the row has seen no valid slot, so that p = 0).
__device__ __forceinline__ float softmax_step(float& m_run, float mx, float& alpha) {
  const float m_new = fmaxf(m_run, mx);
  const float base = m_new == -INFINITY ? 0.f : m_new;
  alpha = expf(m_run - base);
  m_run = m_new;
  return base;
}

// Score rows on the M side (the verify block: up to 128 rows, 16 a warp):
// S = Q K^T (16 rows x SPW slots) and acc += P V (16 rows x D), P's A
// fragments straight from the score accumulators.
template <int D, typename KV, int SPW>
struct RowsOnM {
  static constexpr bool QUANT = sizeof(KV) == 1;
  static constexpr int KROW = Smem<D, KV>::KROW;
  static constexpr int NT = SPW / 8;  // n-tiles of the scores
  static constexpr int DT = D / 8;    // n-tiles of P V
  uint32_t qf[D / 16][4];
  float acc[DT][4];
  float m_run[2], l_run[2];  // rows rA, rB (l: this thread's share)
  int r0;                    // rA = r0 + g, rB = rA + 8
  int lim[2];                // one past the last slot of the split rows rA / rB see
  int warp_lim;              // the furthest of them over the warp's rows

  __device__ __forceinline__ void init(const Rows& rows, int R, int mt, int end0, int lo, int hi, int lane) {
    const int g = lane >> 2, tig = lane & 3;
    r0 = mt * 16;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      query_words<D, QUANT>(rows, r0 + g, R, kk, tig, qf[kk][0], qf[kk][2]);
      query_words<D, QUANT>(rows, r0 + g + 8, R, kk, tig, qf[kk][1], qf[kk][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      lim[h] = r < R ? min(end0 + r / rows.G, hi) : lo;
      m_run[h] = -INFINITY;
      l_run[h] = 0.f;
    }
    warp_lim = min(end0 + (min(R, r0 + 16) - 1) / rows.G, hi);
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  // the warp's SPW slots from w0 (K rows at kt, V rows at vt; their scales sk / sv)
  __device__ __forceinline__ void tile(uint32_t kt, uint32_t vt, const float* sk, const float* sv, int w0,
                                       float scale, int lane) {
    const int tig = lane & 3;
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const uint32_t krow = kt + (nt * 8 + (lane & 7)) * KROW + (lane >> 3) * 16;
      if constexpr (QUANT) {
#pragma unroll
        for (int kc = 0; kc < D / 64; ++kc) {  // 4 k-steps of 16 bytes each
          uint32_t r[4];
          ldsm_x4(r, krow + kc * 64);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float f[4];
            s8x4_to_f32(r[j], f);
            mma_16816(s[nt], qf[4 * kc + j], pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
          }
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < D / 32; ++kc) {  // 2 k-steps of 16 depths each
          uint32_t r[4];
          ldsm_x4(r, krow + kc * 64);
          mma_16816(s[nt], qf[2 * kc], r[0], r[1]);
          mma_16816(s[nt], qf[2 * kc + 1], r[2], r[3]);
        }
      }
    }

    // scale, mask, online softmax (a row's four threads share a lane quad)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * tig + (e & 1);
        const float x = s[nt][e] * (QUANT ? sk[c] : scale);
        s[nt][e] = w0 + c < lim[e >> 1] ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float base = softmax_step(m_run[h], mx[h], alpha[h]);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][2 * h] = expf(s[nt][2 * h] - base);
        s[nt][2 * h + 1] = expf(s[nt][2 * h + 1] - base);
        sum += s[nt][2 * h] + s[nt][2 * h + 1];
      }
      l_run[h] = l_run[h] * alpha[h] + sum;
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][0] *= alpha[0];
        acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1];
        acc[dt][3] *= alpha[1];
      }
    }

    // acc += (p vs) V, p vs as a bf16 head and residual: the score
    // accumulators of n-tiles 2 kc and 2 kc + 1 are the A fragments of k16 step kc
#pragma unroll
    for (int kc = 0; kc < SPW / 16; ++kc) {
      float p[8];  // (row A, row B) x slots 2 tig, 2 tig + 1, 8 + 2 tig, 9 + 2 tig of the step
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = kc * 16 + h * 8 + 2 * tig;
        const float v0 = QUANT ? sv[c] : 1.f, v1 = QUANT ? sv[c + 1] : 1.f;
        p[4 * h + 0] = s[2 * kc + h][0] * v0;
        p[4 * h + 1] = s[2 * kc + h][1] * v1;
        p[4 * h + 2] = s[2 * kc + h][2] * v0;
        p[4 * h + 3] = s[2 * kc + h][3] * v1;
      }
      uint32_t ah[4], al[4];
      split_bf16(p[0], p[1], ah[0], al[0]);
      split_bf16(p[2], p[3], ah[1], al[1]);
      split_bf16(p[4], p[5], ah[2], al[2]);
      split_bf16(p[6], p[7], ah[3], al[3]);
      // ldmatrix.trans rows: slots kc 16 + l % 8 (+ 8 for lanes 8-15, 24-31)
      const uint32_t vrow = vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KROW + (lane >> 4) * 16;
      if constexpr (QUANT) {
        // 16 b16 pairs (32 depths) a step: r[0]/r[1] the low 8 pairs at slots
        // 0-7 / 8-15, r[2]/r[3] the high 8; byte order (slot 2 tig, depth
        // even), (2 tig, odd), (2 tig + 1, even), (2 tig + 1, odd)
#pragma unroll
        for (int pb = 0; pb < D / 32; ++pb) {
          uint32_t r[4];
          ldsm_x4_trans(r, vrow + pb * 32);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float f0[4], f1[4];
            s8x4_to_f32(r[2 * hh], f0);
            s8x4_to_f32(r[2 * hh + 1], f1);
            const uint32_t e0 = pack_bf16(f0[0], f0[2]), e1 = pack_bf16(f1[0], f1[2]);
            const uint32_t o0 = pack_bf16(f0[1], f0[3]), o1 = pack_bf16(f1[1], f1[3]);
            float* ce = acc[pb * 4 + hh * 2];
            float* co = acc[pb * 4 + hh * 2 + 1];
            mma_16816(ce, ah, e0, e1);
            mma_16816(ce, al, e0, e1);
            mma_16816(co, ah, o0, o1);
            mma_16816(co, al, o0, o1);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {  // 16 depths a step: two n-tiles
          uint32_t r[4];
          ldsm_x4_trans(r, vrow + j * 32);
          mma_16816(acc[2 * j], ah, r[0], r[1]);
          mma_16816(acc[2 * j], al, r[0], r[1]);
          mma_16816(acc[2 * j + 1], ah, r[2], r[3]);
          mma_16816(acc[2 * j + 1], al, r[2], r[3]);
        }
      }
    }
  }

  // rows < R of (acc, m, l) into the warp's partial: acc [R][PROW], m [R], l [R]
  __device__ __forceinline__ void write(float* pacc, float* pm, float* pl, int R, int lane) {
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r >= R) continue;
      if (tig == 0) {
        pm[r] = m_run[h];
        pl[r] = l_run[h];
      }
      float* dst = pacc + r * Smem<D, KV>::PROW;
      if constexpr (QUANT) {  // tiles (pb, hh, even/odd) hold depths 32 pb + 16 hh + 4 tig + (0..3)
#pragma unroll
        for (int pb = 0; pb < D / 32; ++pb)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float* ce = acc[pb * 4 + hh * 2];
            const float* co = acc[pb * 4 + hh * 2 + 1];
            *reinterpret_cast<float4*>(dst + 32 * pb + 16 * hh + 4 * tig) =
                make_float4(ce[2 * h], co[2 * h], ce[2 * h + 1], co[2 * h + 1]);
          }
      } else {
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
          *reinterpret_cast<float2*>(dst + 8 * dt + 2 * tig) = make_float2(acc[dt][2 * h], acc[dt][2 * h + 1]);
      }
    }
  }
};

// Score rows on the N side (decode: at most 8 rows), the operands swapped so
// that the 8-row n-tiles hold the rows with no padding to 16: S^T = K Q^T (16
// slots x 8 rows) and acc^T += V^T P^T (D x 8 rows). P^T's B fragments come
// from the score accumulators through movmatrix.trans. Half the mma.sync of
// the M-side layout and half its accumulators, for 16 slots a warp.
template <int D, typename KV>
struct RowsOnN {
  static constexpr bool QUANT = sizeof(KV) == 1;
  static constexpr int KROW = Smem<D, KV>::KROW;
  static constexpr int MT = D / 16;  // m-tiles of acc^T
  uint32_t qb[D / 16][2];
  float acc[MT][4];
  float m_run[2], l_run[2];  // rows 2 tig, 2 tig + 1 (l: this thread's share)
  int lim[2];
  int warp_lim;

  __device__ __forceinline__ void init(const Rows& rows, int R, int mt, int end0, int lo, int hi, int lane) {
    const int g = lane >> 2, tig = lane & 3;
    (void)mt;  // one row tile
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) query_words<D, QUANT>(rows, g, R, kk, tig, qb[kk][0], qb[kk][1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * tig + h;
      lim[h] = r < R ? min(end0 + r / rows.G, hi) : lo;
      m_run[h] = -INFINITY;
      l_run[h] = 0.f;
    }
    warp_lim = min(end0 + (R - 1) / rows.G, hi);
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  // the warp's 16 slots from w0: C fragments hold slots g, g + 8 (c0, c1 /
  // c2, c3) of rows 2 tig, 2 tig + 1 (c0, c2 / c1, c3)
  __device__ __forceinline__ void tile(uint32_t kt, uint32_t vt, const float* sk, const float* sv, int w0,
                                       float scale, int lane) {
    const int g = lane >> 2;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // even and odd k-steps
    // ldmatrix rows: slots l % 8 (+ 8 for lanes 8-15, 24-31), lanes 16-31 16 bytes on
    const uint32_t krow = kt + ((lane & 7) + ((lane >> 3) & 1) * 8) * KROW + (lane >> 4) * 16;
    if constexpr (QUANT) {
#pragma unroll
      for (int kc = 0; kc < D / 32; ++kc) {  // two 16-byte k-steps of slots 0-7 and 8-15
        uint32_t r[4];
        ldsm_x4(r, krow + kc * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float f0[4], f1[4];
          s8x4_to_f32(r[2 * h], f0);
          s8x4_to_f32(r[2 * h + 1], f1);
          const uint32_t k[4] = {pack_bf16(f0[0], f0[1]), pack_bf16(f1[0], f1[1]), pack_bf16(f0[2], f0[3]),
                                 pack_bf16(f1[2], f1[3])};
          mma_16816(s[h], k, qb[2 * kc + h][0], qb[2 * kc + h][1]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t r[4];
        ldsm_x4(r, krow + kk * 32);
        mma_16816(s[kk & 1], r, qb[kk][0], qb[kk][1]);
      }
    }

    // scale, mask, online softmax: a row's 8 threads share tig
    const float k0 = QUANT ? sk[g] : scale, k1 = QUANT ? sk[g + 8] : scale;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y = (s[0][e] + s[1][e]) * (e < 2 ? k0 : k1);
      x[e] = w0 + g + (e >> 1) * 8 < lim[e & 1] ? y : -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(x[h], x[h + 2]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float base = softmax_step(m_run[h], mx, alpha[h]);
      x[h] = expf(x[h] - base);
      x[h + 2] = expf(x[h + 2] - base);
      l_run[h] = l_run[h] * alpha[h] + x[h] + x[h + 2];
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m][0] *= alpha[0];
        acc[m][1] *= alpha[1];
        acc[m][2] *= alpha[0];
        acc[m][3] *= alpha[1];
      }
    }

    // P^T's B fragments: (p vs) as a bf16 head and residual, each 8 x 8 block
    // (slots g, rows 2 tig..) transposed to (rows g, slots 2 tig..)
    const float v0 = QUANT ? sv[g] : 1.f, v1 = QUANT ? sv[g + 8] : 1.f;
    uint32_t h01, l01, h23, l23;
    split_bf16(x[0] * v0, x[1] * v0, h01, l01);
    split_bf16(x[2] * v1, x[3] * v1, h23, l23);
    const uint32_t bh0 = movmatrix_trans(h01), bh1 = movmatrix_trans(h23);
    const uint32_t bl0 = movmatrix_trans(l01), bl1 = movmatrix_trans(l23);

    if constexpr (QUANT) {
      // ldmatrix.trans on b16 pairs of depths: r[0] / r[1] pairs 16 pb .. + 7 of
      // slots 0-7 / 8-15, r[2] / r[3] the next 8 pairs; an m-tile's row g is the
      // even depth of pair g, row g + 8 the odd one
      const uint32_t vrow = vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * KROW + (lane >> 4) * 16;
#pragma unroll
      for (int pb = 0; pb < D / 32; ++pb) {
        uint32_t r[4];
        ldsm_x4_trans(r, vrow + pb * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float f0[4], f1[4];
          s8x4_to_f32(r[2 * h], f0);
          s8x4_to_f32(r[2 * h + 1], f1);
          const uint32_t v[4] = {pack_bf16(f0[0], f0[2]), pack_bf16(f0[1], f0[3]), pack_bf16(f1[0], f1[2]),
                                 pack_bf16(f1[1], f1[3])};
          mma_16816(acc[2 * pb + h], v, bh0, bh1);
          mma_16816(acc[2 * pb + h], v, bl0, bl1);
        }
      }
    } else {
      // ldmatrix.trans: depths 16 j .. + 7 / + 8 .. + 15 (lanes 8-15, 24-31) of
      // slots 0-7 / 8-15 (lanes 16-31)
      const uint32_t vrow = vt + ((lane & 7) + (lane >> 4) * 8) * KROW + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        uint32_t r[4];
        ldsm_x4_trans(r, vrow + j * 32);
        mma_16816(acc[j], r, bh0, bh1);
        mma_16816(acc[j], r, bl0, bl1);
      }
    }
  }

  __device__ __forceinline__ void write(float* pacc, float* pm, float* pl, int R, int lane) {
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 4);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 8);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 16);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * tig + h;
      if (r >= R) continue;
      if (g == 0) {
        pm[r] = m_run[h];
        pl[r] = l_run[h];
      }
      float* dst = pacc + r * Smem<D, KV>::PROW;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (QUANT) {  // m-tile (pb, hh): depths 32 pb + 16 hh + 2 g, + 1
          *reinterpret_cast<float2*>(dst + 16 * m + 2 * g) = make_float2(acc[m][h], acc[m][h + 2]);
        } else {  // m-tile j: depths 16 j + g and 16 j + 8 + g
          dst[16 * m + g] = acc[m][h];
          dst[16 * m + 8 + g] = acc[m][h + 2];
        }
      }
    }
  }
};

// --- the kernel body -------------------------------------------------------------

// Grid (P, NKV, B), cluster (P, 1, 1), (rows / 16) * WS warps, WS = TILE_SLOTS / SPW.
template <int D, typename KV, int SPW, typename Core>
__device__ __forceinline__ void attend(const Args& a, unsigned char* smem) {
  constexpr bool QUANT = sizeof(KV) == 1;
  using L = Smem<D, KV>;
  constexpr int WS = BT / SPW;     // warps along the slots of a tile
  constexpr int CPR = D * static_cast<int>(sizeof(KV)) / 16;  // 16-byte chunks of a slot row
  constexpr int PROW = L::PROW;
  static_assert(SPW % 16 == 0 && WS >= 1, "a warp takes whole k16 steps of P V");

  const int split = blockIdx.x, P = gridDim.x, kvh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, T = a.T, NH = a.NH, G = NH / a.NKV, R = S * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mt = warp / WS, ws = warp % WS;

  // this split's slots [lo, hi) of the row's [start, end0 + S - 1)
  const int start = min(max(a.kv_start[b], 0), T);
  const int end0 = min(max(a.kv_end[b] + a.end_add, 0), T - (S - 1));
  const int last = end0 + S - 1;  // one past the last slot any query sees
  const int n = last - start;
  const int chunk = n > 0 ? ((n + P - 1) / P + 15) / 16 * 16 : 0;
  const int hi = max(start, last - (P - 1 - split) * chunk);
  const int lo = max(start, hi - chunk);
  const int ntiles = (hi - lo + BT - 1) / BT;

  const long long row0 = (static_cast<long long>(b) * a.NKV + kvh) * T;
  const KV* kg = static_cast<const KV*>(a.k) + row0 * D;
  const KV* vg = static_cast<const KV*>(a.v) + row0 * D;
  const uint32_t ring = smem_addr(smem);
  float* ssk = reinterpret_cast<float*>(smem + L::SCALES);
  float* ssv = ssk + BT;

  // tile i's K/V rows into stage i % NS: 16-byte cp.async, slots at or past hi zero-filled
  auto stage = [&](int i) {
    const int t0 = lo + i * BT;
    const uint32_t st = ring + (i % NS) * L::STAGE;
    for (int c = tid; c < 2 * BT * CPR; c += blockDim.x) {
      const int is_v = c >= BT * CPR, cc = c - is_v * BT * CPR, s = cc / CPR, ch = cc % CPR;
      const int t = t0 + s;
      const bool in = t < hi;
      const KV* src = (is_v ? vg : kg) + static_cast<long long>(in ? t : lo) * D + ch * (16 / sizeof(KV));
      cp_async16(st + is_v * L::TILE + s * L::KROW + ch * 16, src, in ? 16 : 0);
    }
  };
  float sk = 0.f, sv = 0.f;  // thread tid < BT: its slot's scales of the next tile
  auto scales = [&](int i) {
    const int t = lo + i * BT + tid;
    if (QUANT && tid < BT) {
      sk = t < hi ? __bfloat162float(a.ks[row0 + t]) * a.scale : 0.f;
      sv = t < hi ? __bfloat162float(a.vs[row0 + t]) : 0.f;
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < ntiles) stage(i);
    cp_async_commit();
  }
  if (ntiles > 0) scales(0);

  const Rows rows{a.q, static_cast<long long>(b) * S * NH + kvh * G, NH, G};
  Core core;
  core.init(rows, R, mt, end0, lo, hi, lane);

  for (int i = 0; i < ntiles; ++i) {
    if (QUANT && tid < BT) {  // the previous tile's scales were read before the sync that ended it
      ssk[tid] = sk;
      ssv[tid] = sv;
    }
    if (i + 1 < ntiles) scales(i + 1);
    if (i + NS - 1 < ntiles) stage(i + NS - 1);  // into the stage tile i - 1 used
    cp_async_commit();
    cp_async_wait<NS - 1>();  // tile i has landed
    __syncthreads();
    const int w0 = lo + i * BT + ws * SPW;  // this warp's first slot
    if (w0 < core.warp_lim) {               // else every slot lies past its rows' frontiers
      const uint32_t kt = ring + (i % NS) * L::STAGE + ws * SPW * L::KROW;
      core.tile(kt, kt + L::TILE, ssk + ws * SPW, ssv + ws * SPW, w0, a.scale, lane);
    }
    __syncthreads();  // every warp is done with tile i's stage and scales
  }
  cp_async_wait<0>();

  // the warps' partials (acc [WS][R][PROW], m [WS][R], l [WS][R]), rows < R
  float* part = reinterpret_cast<float*>(smem);
  core.write(part + ws * R * PROW, part + WS * R * PROW + ws * R, part + WS * R * PROW + WS * R + ws * R, R, lane);

  // the block's partial: the WS warps of each row tile merged in warp order
  float* bpart = part;
  if constexpr (WS > 1) {
    __syncthreads();
    bpart = part + WS * L::part_floats(R);
    const float* wm = part + WS * R * PROW;
    const float* wl = wm + WS * R;
    for (int e = tid; e < R * (D / 4); e += blockDim.x) {
      const int r = e / (D / 4), d = 4 * (e % (D / 4));
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < WS; ++w) M = fmaxf(M, wm[w * R + r]);
      float l = 0.f;
      float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (M != -INFINITY) {
#pragma unroll
        for (int w = 0; w < WS; ++w) {
          const float c = expf(wm[w * R + r] - M);  // a warp that saw no slot: 0
          const float4 x = *reinterpret_cast<const float4*>(part + (w * R + r) * PROW + d);
          l += wl[w * R + r] * c;
          s4.x += x.x * c;
          s4.y += x.y * c;
          s4.z += x.z * c;
          s4.w += x.w * c;
        }
      }
      *reinterpret_cast<float4*>(bpart + r * PROW + d) = s4;
      if (d == 0) {
        bpart[R * PROW + r] = M;
        bpart[R * PROW + R + r] = l;
      }
    }
  }

  // the cluster's P partials merged in split order; this block writes its share
  // of the R x D outputs
  cluster_sync();
  {
    const uint32_t acc_addr = smem_addr(bpart), m_addr = smem_addr(bpart + R * PROW), l_addr = m_addr + 4 * R;
    const int E = R * (D / 4), e_lo = split * E / P, e_hi = (split + 1) * E / P;
    for (int e = e_lo + tid; e < e_hi; e += blockDim.x) {
      const int r = e / (D / 4), d = 4 * (e % (D / 4));
      float m[PLAN_MAX_SPLITS], l[PLAN_MAX_SPLITS];
      float4 x[PLAN_MAX_SPLITS];
#pragma unroll
      for (int p = 0; p < PLAN_MAX_SPLITS; ++p)
        if (p < P) {  // every load issued before the first add
          m[p] = ld_cluster_f32(map_rank(m_addr + 4 * r, p));
          l[p] = ld_cluster_f32(map_rank(l_addr + 4 * r, p));
          x[p] = ld_cluster_f4(map_rank(acc_addr + 4 * (r * PROW + d), p));
        }
      float M = -INFINITY;
#pragma unroll
      for (int p = 0; p < PLAN_MAX_SPLITS; ++p)
        if (p < P) M = fmaxf(M, m[p]);
      float den = 0.f;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (M != -INFINITY) {
#pragma unroll
        for (int p = 0; p < PLAN_MAX_SPLITS; ++p)
          if (p < P) {
            const float c = expf(m[p] - M);  // a split that saw no valid slot: 0
            den += l[p] * c;
            o.x += x[p].x * c;
            o.y += x[p].y * c;
            o.z += x[p].z * c;
            o.w += x[p].w * c;
          }
      }
      den = fmaxf(den, 1e-20f);
      *reinterpret_cast<uint2*>(a.out + rows.offset(r, D) + d) =
          make_uint2(pack_bf16(o.x / den, o.y / den), pack_bf16(o.z / den, o.w / den));
    }
  }
  cluster_sync();  // no block leaves while another reads its partials
}

template <int D, typename KV, int SPW>
__global__ void __launch_bounds__(32 * DECODE_WARPS, DECODE_SM_WARPS / DECODE_WARPS) decode_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  attend<D, KV, SPW, RowsOnN<D, KV>>(a, smem);
}

template <int D, typename KV, int SPW>
__global__ void __launch_bounds__(256) verify_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  attend<D, KV, SPW, RowsOnM<D, KV, SPW>>(a, smem);
}

// --- host ----------------------------------------------------------------------

// warps along a tile's slots for Mt row tiles: up to four warps a block
int warps_along_slots(int mt) {
  const int ws = mt >= 4 ? 1 : 4 / mt;
  return ws < BT / 16 ? ws : BT / 16;
}

// Splits of a row: the most (a power of two, at most PLAN_MAX_SPLITS) that
// keep B * NKV * P within PLAN_BLOCKS blocks and give each split at least
// one tile of the cache. A function of the shapes alone (the verify block's
// rows change a block's work, not the cut).
int split_plan(int B, int NKV, int T) {
  const long long pairs = static_cast<long long>(B) * NKV;
  const int tiles = (T + BT - 1) / BT;
  int p = 1;
  while (2 * p <= PLAN_MAX_SPLITS && pairs * 2 * p <= PLAN_BLOCKS && 2 * p <= tiles) p *= 2;
  return p;
}

struct Plan {
  int splits, warps, spw, smem;
};

template <int D, typename KV>
Plan make_plan(int B, int S, int NH, int NKV, int T) {
  const int R = S * (NH / NKV), mt = (R + 15) / 16, ws = warps_along_slots(mt);
  return Plan{split_plan(B, NKV, T), mt * ws, BT / ws, Smem<D, KV>::bytes(R, ws)};
}

Plan plan_for(int B, int S, int NH, int NKV, int T, int D, int quant) {
  if (D == 64) return quant ? make_plan<64, int8_t>(B, S, NH, NKV, T) : make_plan<64, __nv_bfloat16>(B, S, NH, NKV, T);
  return quant ? make_plan<128, int8_t>(B, S, NH, NKV, T) : make_plan<128, __nv_bfloat16>(B, S, NH, NKV, T);
}

// the most shared memory a launch of this instance asks for (over the row
// counts that pick its SPW)
template <int D, typename KV, int SPW>
int most_smem() {
  int most = 0;
  for (int mt = 1; mt <= MAX_ROWS / 16; ++mt) {
    const int ws = warps_along_slots(mt);
    const int bytes = Smem<D, KV>::bytes(16 * mt, ws);
    if (BT / ws == SPW && bytes > most) most = bytes;
  }
  return most;
}

// Lets `kern` take its shared memory, once for each device (a bit of
// `allowed` each; devices past 63 ask on every launch).
template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, std::atomic<unsigned long long>& allowed) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit != 0 && (allowed.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// Launches the plan; with `occupancy`, launches nothing and writes there
// the blocks an SM and the clusters the card can hold at once.
template <bool VERIFY, int D, typename KV, int SPW>
int launch_spw(const Args& a, int B, const Plan& p, cudaStream_t st, int* occupancy) {
  static std::atomic<unsigned long long> allowed{0};
  void (*kern)(const Args);
  if constexpr (VERIFY)
    kern = verify_kernel<D, KV, SPW>;
  else
    kern = decode_kernel<D, KV, SPW>;
  const cudaError_t attr = allow_smem(kern, most_smem<D, KV, SPW>(), allowed);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, a.NKV, B);
  cfg.blockDim = dim3(32 * p.warps);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cfg.attrs = cluster;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;  // one split: no cluster (faster to schedule, H100 sweep)
  if (occupancy != nullptr) {
    occupancy[1] = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[0], kern, cfg.blockDim.x, p.smem);
    if (e == cudaSuccess && cfg.numAttrs == 1) e = cudaOccupancyMaxActiveClusters(&occupancy[1], kern, &cfg);
    return static_cast<int>(e);
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <bool VERIFY, int D, typename KV>
int launch(const Args& a, int B, cudaStream_t st, int* occupancy) {
  const Plan p = make_plan<D, KV>(B, a.S, a.NH, a.NKV, a.T);
  if (p.spw == 16) return launch_spw<VERIFY, D, KV, 16>(a, B, p, st, occupancy);
  if constexpr (VERIFY) {  // decode has at most 8 rows: one row tile, 16 slots a warp
    if (p.spw == 32) return launch_spw<VERIFY, D, KV, 32>(a, B, p, st, occupancy);
    if constexpr (BT >= 64)
      if (p.spw == 64) return launch_spw<VERIFY, D, KV, 64>(a, B, p, st, occupancy);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool VERIFY>
int dispatch(const Args& a, int B, int D, int quant, cudaStream_t st, int* occupancy = nullptr) {
  if (D == 64)
    return quant ? launch<VERIFY, 64, int8_t>(a, B, st, occupancy) : launch<VERIFY, 64, __nv_bfloat16>(a, B, st, occupancy);
  if (D == 128)
    return quant ? launch<VERIFY, 128, int8_t>(a, B, st, occupancy)
                 : launch<VERIFY, 128, __nv_bfloat16>(a, B, st, occupancy);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// k/v (and ks/vs) point at layer li of the stacked cache; quant selects the
// int8 cache with bf16 scales. kv_start/kv_end are [B] int32.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    void* out, const void* kv_start, const void* kv_end,
    int B, int NH, int NKV, int T, int D, int quant, float scale, void* stream) {
  if (B <= 0 || NKV <= 0 || T <= 0 || NH % NKV != 0 || NH / NKV > MAX_GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const __nv_bfloat16*>(ks),
               static_cast<const __nv_bfloat16*>(vs), static_cast<__nv_bfloat16*>(out),
               static_cast<const int*>(kv_start), static_cast<const int*>(kv_end), 1, NH, NKV, T, 0, scale};
  return dispatch<false>(a, B, D, quant, static_cast<cudaStream_t>(stream));
}

// The verify block: q/out [B, S, NH, D]; kv_start/kv_off are [B] int32.
extern "C" int block_verify_attention(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    void* out, const void* kv_start, const void* kv_off,
    int B, int S, int NH, int NKV, int T, int D, int quant, float scale, void* stream) {
  if (B <= 0 || NKV <= 0 || NH % NKV != 0 || S < 1 || S > T || S * (NH / NKV) > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const __nv_bfloat16*>(ks),
               static_cast<const __nv_bfloat16*>(vs), static_cast<__nv_bfloat16*>(out),
               static_cast<const int*>(kv_start), static_cast<const int*>(kv_off), S, NH, NKV, T, 1, scale};
  return dispatch<true>(a, B, D, quant, static_cast<cudaStream_t>(stream));
}

// How a launch is cut, into out[8]: splits P (the cluster), warps a block,
// slots a warp takes of each tile, dynamic shared memory bytes, tile slots,
// ring stages; then the blocks an SM and the clusters the card holds at once
// (the CUDA occupancy calculator, for the kernel that launch would run: decode
// for one query and at most 8 heads a kv head, verify else). Returns 0, a
// cudaError_t, or cudaErrorInvalidValue for shapes no kernel takes.
extern "C" int attention_plan(int B, int S, int NH, int NKV, int T, int D, int quant, int* out) {
  if (B <= 0 || NKV <= 0 || NH % NKV != 0 || S < 1 || S > T || S * (NH / NKV) > MAX_ROWS || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(B, S, NH, NKV, T, D, quant);
  out[0] = p.splits;
  out[1] = p.warps;
  out[2] = p.spw;
  out[3] = p.smem;
  out[4] = BT;
  out[5] = NS;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, S, NH, NKV, T, 0, 1.f};
  return S == 1 && NH / NKV <= MAX_GROUP ? dispatch<false>(a, B, D, quant, nullptr, out + 6)
                                         : dispatch<true>(a, B, D, quant, nullptr, out + 6);
}
