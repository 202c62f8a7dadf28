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
// through f32 absorption, so it is zeroed explicitly, as the TPU kernels do.
//
// Precision. QK^T and dO V^T run on mma.sync m16n8k16 in bf16 with f32
// accumulation, as the TPU kernels run them at the input precision. The TPU
// kernels multiply p and ds by K, Q and dO in f32; here p and ds are rounded
// to bf16 for the tensor cores (FlashAttention-2's choice): one bf16 rounding
// of each term of a sum over up to 8232 keys or queries, random in sign, so
// the sums keep a relative error of about 1e-3 -- inside the 5e-3 relative
// RMS limit (utils/agreement.py) the kernels are held to against the plain
// version, which keeps p and ds in f32.
//
// What bounds it on the H100: at the VGGT shapes (D=64; 1029 or 8232 keys)
// the work is 6 (dq) and 8 (dk/dv) * B*NH*S*T*D tensor-core FLOPs -- the
// TPU kernels' own cost estimates -- against a few MB of operands, so it is
// bound by operations, not bytes.
//
// Design. The TPU grid's sequential axis becomes a loop inside the block:
//  - dq: one block per (64-query tile, head, batch), 4 warps x 16 query rows;
//    Q and dO fragments stay in registers; K/V tiles of BKV keys (64 at D=64,
//    32 at D=128) are staged in shared memory; the loop runs over the key
//    tiles of the row's frontier (causal: up to the diagonal).
//  - dk/dv: one block per (64-key tile, kv head, batch), 4 warps x 16 keys;
//    the K/V tile is staged once; the loop runs over the group's heads x the
//    query tiles (BQ = 64 at D=64, 32 at D=128, staged with their lse and
//    delta); the products are taken transposed (S^T = K Q^T, dP^T = V dO^T)
//    so each warp's accumulators are its own keys' rows of dk and dv.
// Tiles wholly outside [kv_start, kv_end) or above the causal diagonal are
// skipped; masks are built only on boundary tiles. Every output element is
// written by one thread of one block and summed in a fixed order: no atomics,
// so the gradients are the same from run to run.
// This first version is simple and right: no wgmma, no TMA, no cp.async
// pipelining (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PAD = 8;  // row padding (bf16 elements) against bank conflicts
constexpr float DEAD = -0.5e30f;  // lse at or below this: a row with no valid key

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(const __nv_bfloat16& lo, const __nv_bfloat16& hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + ROWS) of a [*, D] operand read through its strides into a
// padded shared tile; zeros past `limit`
template <int ROWS, int D>
__device__ __forceinline__ void stage(__nv_bfloat16 (*dst)[D + PAD], const __nv_bfloat16* src,
                                      long long row_stride, int r0, int limit, int tid) {
  for (int idx = tid; idx < ROWS * (D / 8); idx += 128) {
    const int r = idx / (D / 8);
    const int c = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh;
};

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_start, const int* __restrict__ kv_end,
    __nv_bfloat16* __restrict__ dq, int S, int T, int NH, int group, Strides st,
    float scale, int causal) {
  constexpr int BQ = 64;
  constexpr int BKV = D == 64 ? 64 : 32;  // keys per shared tile
  constexpr int KC = D / 16;   // k-steps over d (QK^T, dO V^T)
  constexpr int DT = D / 8;    // n-tiles over d (dS K)
  constexpr int NT = BKV / 8;  // n-tiles over keys
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV][D + PAD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int rowA = q0 + warp * 16 + g;
  const int rowB = rowA + 8;
  const int start = max(0, min(kv_start[b], T));
  const int end = max(0, min(kv_end[b], T));

  // Q and dO fragments (A operands), zero past S
  uint32_t qf[KC][4], of[KC][4];
  {
    const __nv_bfloat16* qb = q + b * st.q_sb + h * st.q_sh;
    const __nv_bfloat16* ob = dout + b * st.o_sb + h * st.o_sh;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int c0 = kc * 16 + tig * 2;
      qf[kc][0] = rowA < S ? ld32(qb + rowA * st.q_ss + c0) : 0u;
      qf[kc][1] = rowB < S ? ld32(qb + rowB * st.q_ss + c0) : 0u;
      qf[kc][2] = rowA < S ? ld32(qb + rowA * st.q_ss + c0 + 8) : 0u;
      qf[kc][3] = rowB < S ? ld32(qb + rowB * st.q_ss + c0 + 8) : 0u;
      of[kc][0] = rowA < S ? ld32(ob + rowA * st.o_ss + c0) : 0u;
      of[kc][1] = rowB < S ? ld32(ob + rowB * st.o_ss + c0) : 0u;
      of[kc][2] = rowA < S ? ld32(ob + rowA * st.o_ss + c0 + 8) : 0u;
      of[kc][3] = rowB < S ? ld32(ob + rowB * st.o_ss + c0 + 8) : 0u;
    }
  }
  const long long sr = (static_cast<long long>(b) * NH + h) * S;
  const float lseA = rowA < S ? lse[sr + rowA] : -1e30f;
  const float lseB = rowB < S ? lse[sr + rowB] : -1e30f;
  const float dlA = rowA < S ? delta[sr + rowA] : 0.f;
  const float dlB = rowB < S ? delta[sr + rowB] : 0.f;
  const bool liveA = lseA > DEAD, liveB = lseB > DEAD;

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int j_lo = start / BKV;
  int j_hi = (end + BKV - 1) / BKV;
  if (causal) j_hi = min(j_hi, (min(q0 + BQ, S) - 1) / BKV + 1);
  const __nv_bfloat16* kb = k + b * st.k_sb + kvh * st.k_sh;
  const __nv_bfloat16* vb = v + b * st.v_sb + kvh * st.v_sh;

  for (int j = j_lo; j < j_hi; ++j) {
    const int t0 = j * BKV;
    __syncthreads();  // the previous tile is no longer read
    stage<BKV, D>(Ks, kb, st.k_st, t0, T, tid);
    stage<BKV, D>(Vs, vb, st.v_st, t0, T, tid);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const int c = kc * 16 + tig * 2;
        mma_16816(s[nt], qf[kc], ld32(&Ks[nt * 8 + g][c]), ld32(&Ks[nt * 8 + g][c + 8]));
        mma_16816(dp[nt], of[kc], ld32(&Vs[nt * 8 + g][c]), ld32(&Vs[nt * 8 + g][c + 8]));
      }
    }

    // p and ds in place of s; the mask only on boundary tiles
    const bool full = t0 >= start && t0 + BKV <= end && (!causal || t0 + BKV - 1 <= q0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool upper = e < 2;
        const int row = upper ? rowA : rowB;
        bool ok = upper ? liveA : liveB;
        if (!full) {
          const int col = t0 + nt * 8 + tig * 2 + (e & 1);
          ok = ok && col >= start && col < end && (!causal || col <= row);
        }
        const float p = ok ? expf(s[nt][e] * scale - (upper ? lseA : lseB)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (upper ? dlA : dlB));
      }
    }

    // dq += bf16(dS) K: the score accumulators are exactly the A fragments
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const int kr = kc * 16 + tig * 2;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int col = dt * 8 + g;
        mma_16816(acc[dt], a, pack_raw(Ks[kr][col], Ks[kr + 1][col]), pack_raw(Ks[kr + 8][col], Ks[kr + 9][col]));
      }
    }
  }

  const long long NHD = static_cast<long long>(NH) * D;
  __nv_bfloat16* out = dq + static_cast<long long>(b) * S * NHD + static_cast<long long>(h) * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (rowA < S)
      *reinterpret_cast<uint32_t*>(out + rowA * NHD + col) = pack_bf16(acc[dt][0] * scale, acc[dt][1] * scale);
    if (rowB < S)
      *reinterpret_cast<uint32_t*>(out + rowB * NHD + col) = pack_bf16(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// the dk/dv kernel's query tile and dynamic shared memory: K, V, Q, dO tiles
// plus the query tile's lse and delta
template <int D>
struct DkvTile {
  static constexpr int BQ = D == 64 ? 64 : 32;
  static constexpr int SMEM = (2 * 64 + 2 * BQ) * (D + PAD) * 2 + 2 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_start, const int* __restrict__ kv_end,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int S, int T, int NH, int group, Strides st, float scale, int causal) {
  constexpr int BKV = 64;            // keys per block: 4 warps x 16
  constexpr int BQ = DkvTile<D>::BQ;  // queries per shared tile
  constexpr int KC = D / 16;         // k-steps over d (K Q^T, V dO^T)
  constexpr int DT = D / 8;          // n-tiles over d (P^T dO, dS^T Q)
  constexpr int NQ = BQ / 8;         // n-tiles over queries
  extern __shared__ __align__(16) unsigned char smem[];
  auto Ks = reinterpret_cast<__nv_bfloat16(*)[D + PAD]>(smem);
  auto Vs = Ks + BKV;
  auto Qs = Vs + BKV;
  auto Os = Qs + BQ;
  float* lse_s = reinterpret_cast<float*>(Os + BQ);
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * BKV;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int keyA = k0 + warp * 16 + g;
  const int keyB = keyA + 8;
  const int kr0 = warp * 16 + g;  // this thread's rows of the shared K/V tile
  const int start = max(0, min(kv_start[b], T));
  const int end = max(0, min(kv_end[b], T));

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  if (k0 < end && k0 + BKV > start) {  // else no query sees these keys: zeros
    stage<BKV, D>(Ks, k + b * st.k_sb + kvh * st.k_sh, st.k_st, k0, T, tid);
    stage<BKV, D>(Vs, v + b * st.v_sb + kvh * st.v_sh, st.v_st, k0, T, tid);
    const int iq_lo = causal ? k0 / BQ : 0;  // earlier query tiles see none of these keys
    const int n_iq = (S + BQ - 1) / BQ;
    for (int hh = 0; hh < group; ++hh) {
      const int h = kvh * group + hh;
      const __nv_bfloat16* qb = q + b * st.q_sb + h * st.q_sh;
      const __nv_bfloat16* ob = dout + b * st.o_sb + h * st.o_sh;
      const long long sr = (static_cast<long long>(b) * NH + h) * S;
      for (int iq = iq_lo; iq < n_iq; ++iq) {
        const int q0 = iq * BQ;
        __syncthreads();  // the previous query tile is no longer read
        stage<BQ, D>(Qs, qb, st.q_ss, q0, S, tid);
        stage<BQ, D>(Os, ob, st.o_ss, q0, S, tid);
        for (int i = tid; i < BQ; i += 128) {
          lse_s[i] = q0 + i < S ? lse[sr + q0 + i] : -1e30f;
          dl_s[i] = q0 + i < S ? delta[sr + q0 + i] : 0.f;
        }
        __syncthreads();

        // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries
        float s[NQ][4], dp[NQ][4];
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
          dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
        }
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          const int c = kc * 16 + tig * 2;
          const uint32_t ak[4] = {ld32(&Ks[kr0][c]), ld32(&Ks[kr0 + 8][c]),
                                  ld32(&Ks[kr0][c + 8]), ld32(&Ks[kr0 + 8][c + 8])};
          const uint32_t av[4] = {ld32(&Vs[kr0][c]), ld32(&Vs[kr0 + 8][c]),
                                  ld32(&Vs[kr0][c + 8]), ld32(&Vs[kr0 + 8][c + 8])};
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            mma_16816(s[n], ak, ld32(&Qs[n * 8 + g][c]), ld32(&Qs[n * 8 + g][c + 8]));
            mma_16816(dp[n], av, ld32(&Os[n * 8 + g][c]), ld32(&Os[n * 8 + g][c + 8]));
          }
        }

        // p^T in s, ds^T in dp; the key mask only on boundary tiles
        const bool full = k0 >= start && k0 + BKV <= end && (!causal || k0 + BKV - 1 <= q0);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int li = n * 8 + tig * 2 + (e & 1);
            const float l = lse_s[li];
            bool ok = l > DEAD;  // also false past S
            if (!full) {
              const int key = e < 2 ? keyA : keyB;
              ok = ok && key >= start && key < end && (!causal || key <= q0 + li);
            }
            const float p = ok ? expf(s[n][e] * scale - l) : 0.f;
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - dl_s[li]);
          }
        }

        // dv += bf16(P^T) dO, dk += bf16(dS^T) Q (k = queries)
#pragma unroll
        for (int qc = 0; qc < BQ / 16; ++qc) {
          const uint32_t ap[4] = {pack_bf16(s[2 * qc][0], s[2 * qc][1]), pack_bf16(s[2 * qc][2], s[2 * qc][3]),
                                  pack_bf16(s[2 * qc + 1][0], s[2 * qc + 1][1]),
                                  pack_bf16(s[2 * qc + 1][2], s[2 * qc + 1][3])};
          const uint32_t ad[4] = {pack_bf16(dp[2 * qc][0], dp[2 * qc][1]), pack_bf16(dp[2 * qc][2], dp[2 * qc][3]),
                                  pack_bf16(dp[2 * qc + 1][0], dp[2 * qc + 1][1]),
                                  pack_bf16(dp[2 * qc + 1][2], dp[2 * qc + 1][3])};
          const int r = qc * 16 + tig * 2;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            const int col = dt * 8 + g;
            mma_16816(dv_acc[dt], ap, pack_raw(Os[r][col], Os[r + 1][col]), pack_raw(Os[r + 8][col], Os[r + 9][col]));
            mma_16816(dk_acc[dt], ad, pack_raw(Qs[r][col], Qs[r + 1][col]), pack_raw(Qs[r + 8][col], Qs[r + 9][col]));
          }
        }
      }
    }
  }

  const long long KD = static_cast<long long>(gridDim.y) * D;  // NKV * D: one key's row
  const long long base = static_cast<long long>(b) * T * KD + static_cast<long long>(kvh) * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (keyA < T) {
      *reinterpret_cast<uint32_t*>(dk + base + keyA * KD + col) = pack_bf16(dk_acc[dt][0] * scale, dk_acc[dt][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + keyA * KD + col) = pack_bf16(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (keyB < T) {
      *reinterpret_cast<uint32_t*>(dk + base + keyB * KD + col) = pack_bf16(dk_acc[dt][2] * scale, dk_acc[dt][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + keyB * KD + col) = pack_bf16(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
              const void* kv_start, const void* kv_end, void* dq, int B, int S, int T, int NH, int NKV,
              const Strides& st, float scale, int causal, cudaStream_t stream) {
  const dim3 grid((S + 63) / 64, NH, B);
  flash_bwd_dq_kernel<D><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_start), static_cast<const int*>(kv_end),
      static_cast<__nv_bfloat16*>(dq), S, T, NH, NH / NKV, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
               const void* kv_start, const void* kv_end, void* dk, void* dv, int B, int S, int T, int NH, int NKV,
               const Strides& st, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = DkvTile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + 63) / 64, NKV, B);
  flash_bwd_dkv_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_start), static_cast<const int*>(kv_end),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, T, NH, NH / NKV, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int S, int T, int NH, int NKV) {
  return B <= 0 || S <= 0 || T <= 0 || NH <= 0 || NKV <= 0 || NH % NKV != 0;
}

}  // namespace

extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    const void* kv_start, const void* kv_end, void* dq,
    int B, int S, int T, int NH, int NKV, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  if (bad_shape(B, S, T, NH, NKV)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dq<64>(q, k, v, dout, lse, delta, kv_start, kv_end, dq, B, S, T, NH, NKV, st, scale, causal, s);
  if (D == 128) return launch_dq<128>(q, k, v, dout, lse, delta, kv_start, kv_end, dq, B, S, T, NH, NKV, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    const void* kv_start, const void* kv_end, void* dk, void* dv,
    int B, int S, int T, int NH, int NKV, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  if (bad_shape(B, S, T, NH, NKV)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dkv<64>(q, k, v, dout, lse, delta, kv_start, kv_end, dk, dv, B, S, T, NH, NKV, st, scale, causal, s);
  if (D == 128) return launch_dkv<128>(q, k, v, dout, lse, delta, kv_start, kv_end, dk, dv, B, S, T, NH, NKV, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
