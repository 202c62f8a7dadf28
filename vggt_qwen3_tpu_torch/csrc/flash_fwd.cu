// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax/accumulate.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (vggt_qwen3_tpu/ops/
// flash_attention.py:41, pallas_call at :274) reached through
// `flash_attention`. Same function: online-softmax attention with a per-row
// [kv_start, kv_end) frontier plus an optional slot-causal mask, GQA query
// head h reading kv head h / group, QK in bf16 with f32 accumulation and the
// scale applied to the f32 scores, the unnormalised P rounded to bf16 before
// PV, m/l/acc in f32, output acc / max(l, 1e-20) (a row with no valid key
// gives 0). With a non-null lse pointer the kernel also writes each row's
// logsumexp m + log(max(l, 1e-30)) in f32 ([B, NH, S]; -1e30 on a row with
// no valid key), as the TPU kernel's lse output does (:130-139) — the
// statistic the backward kernels (flash_bwd.cu) recompute P from. A null
// pointer writes none, so the inference paths are unchanged.
//
// What bounds it on the H100: at the VGGT shapes (D=64, 1029 or 8232 keys)
// and the Qwen3 prefill (D=128) the work is 4*B*NH*S*T*D tensor-core FLOPs
// against a few MB of q/k/v, so it is bound by operations, not bytes.
//
// Design: grid (q tiles of 64 rows, NH, B), 4 warps, each warp owning 16
// query rows. Q fragments stay in registers for the whole kernel; K/V tiles
// of 64 keys are staged in shared memory (at most 2 x 64 x 136 x 2 B = 34 KB
// at D=128), and QK and PV run on mma.sync m16n8k16 bf16 -> f32. The m/l/acc
// that the TPU kernel carried across its sequential kv grid axis become a
// loop inside the block. Tiles wholly outside [kv_start, kv_end) or wholly
// above the causal diagonal are never visited; masks are built only on
// boundary tiles. q/k/v are read through their strides and the ragged edge
// is masked here, so the caller makes no transpose or pad copy.
// This first version is simple and right: no wgmma, no TMA, no cp.async
// pipelining (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block: 4 warps x 16
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int PAD = 8;   // row padding (bf16 elements) against bank conflicts

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, const int* __restrict__ kv_start, const int* __restrict__ kv_end,
    int S, int T, int NH, int group,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, int causal) {
  constexpr int KC = D / 16;  // k-steps of the QK product
  constexpr int DT = D / 8;   // n-tiles of the PV product
  constexpr int NT = BK / 8;  // n-tiles of the QK product
  __shared__ __align__(16) __nv_bfloat16 Ks[BK][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK][D + PAD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int rowA = q0 + warp * 16 + g;  // rows this thread holds
  const int rowB = rowA + 8;

  const int start = max(0, min(kv_start[b], T));
  const int end = max(0, min(kv_end[b], T));

  // Q fragments (A operand, row-major 16x16 per k-step), zero past S
  uint32_t qf[KC][4];
  {
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int c0 = kc * 16 + tig * 2;
      qf[kc][0] = rowA < S ? *reinterpret_cast<const uint32_t*>(qb + rowA * q_ss + c0) : 0u;
      qf[kc][1] = rowB < S ? *reinterpret_cast<const uint32_t*>(qb + rowB * q_ss + c0) : 0u;
      qf[kc][2] = rowA < S ? *reinterpret_cast<const uint32_t*>(qb + rowA * q_ss + c0 + 8) : 0u;
      qf[kc][3] = rowB < S ? *reinterpret_cast<const uint32_t*>(qb + rowB * q_ss + c0 + 8) : 0u;
    }
  }

  float oacc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums

  int j_lo = start / BK;
  int j_hi = (end + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ, S) - 1;
    j_hi = min(j_hi, last_row / BK + 1);
  }

  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  for (int j = j_lo; j < j_hi; ++j) {
    const int t0 = j * BK;
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BK * (D / 8); idx += 128) {
      const int r = idx / (D / 8);
      const int c = (idx % (D / 8)) * 8;
      const int t = t0 + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (t < T) {
        kv4 = *reinterpret_cast<const uint4*>(kb + t * k_st + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + t * v_st + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c]) = kv4;
      *reinterpret_cast<uint4*>(&Vs[r][c]) = vv4;
    }
    __syncthreads();

    // scores S = Q K^T for this warp's 16 rows x 64 keys
    float sacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + g][kc * 16 + tig * 2]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + g][kc * 16 + 8 + tig * 2]);
        mma_16816(sacc[nt], qf[kc], b0, b1);
      }
    }

    // scale, then mask on boundary tiles only
    const bool full = t0 >= start && t0 + BK <= end && (!causal || t0 + BK - 1 <= q0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[nt][e] * scale;
        if (!full) {
          const int col = t0 + nt * 8 + tig * 2 + (e & 1);
          const int row = e < 2 ? rowA : rowB;
          const bool ok = col >= start && col < end && (!causal || col <= row);
          if (!ok) s = -INFINITY;
        }
        sacc[nt][e] = s;
      }
    }

    // online softmax per row (r = 0: rowA, r = 1: rowB); a row's four
    // threads share one lane group, so its max is reduced over xor 1, 2
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(sacc[nt][2 * r], sacc[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // dead so far: p = 0
      alpha[r] = expf(m_run[r] - base);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float p0 = expf(sacc[nt][2 * r] - base);
        const float p1 = expf(sacc[nt][2 * r + 1] - base);
        sacc[nt][2 * r] = p0;
        sacc[nt][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l_run[r] = l_run[r] * alpha[r] + sum;
      m_run[r] = m_new;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      oacc[dt][0] *= alpha[0];
      oacc[dt][1] *= alpha[0];
      oacc[dt][2] *= alpha[1];
      oacc[dt][3] *= alpha[1];
    }

    // O += bf16(P) V: the score accumulators are exactly the A fragments
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(sacc[2 * kc][0], sacc[2 * kc][1]);
      a[1] = pack_bf16(sacc[2 * kc][2], sacc[2 * kc][3]);
      a[2] = pack_bf16(sacc[2 * kc + 1][0], sacc[2 * kc + 1][1]);
      a[3] = pack_bf16(sacc[2 * kc + 1][2], sacc[2 * kc + 1][3]);
      const int kr = kc * 16 + tig * 2;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int col = dt * 8 + g;
        const uint16_t* v0 = reinterpret_cast<const uint16_t*>(&Vs[kr][col]);
        const uint16_t* v1 = reinterpret_cast<const uint16_t*>(&Vs[kr + 1][col]);
        const uint16_t* v8 = reinterpret_cast<const uint16_t*>(&Vs[kr + 8][col]);
        const uint16_t* v9 = reinterpret_cast<const uint16_t*>(&Vs[kr + 9][col]);
        mma_16816(oacc[dt], a, pack_raw(*v0, *v1), pack_raw(*v8, *v9));
      }
    }
  }

  // full row sums over the lane group, then normalise and store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if (lse != nullptr && tig == 0) {
    float* lb = lse + (static_cast<long long>(b) * NH + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? rowA : rowB;
      if (row < S) lb[row] = m_run[r] == -INFINITY ? -1e30f : m_run[r] + logf(fmaxf(l_run[r], 1e-30f));
    }
  }
  const float invA = 1.f / fmaxf(l_run[0], 1e-20f);
  const float invB = 1.f / fmaxf(l_run[1], 1e-20f);
  const long long NHD = static_cast<long long>(NH) * D;
  __nv_bfloat16* ob = out + static_cast<long long>(b) * S * NHD + static_cast<long long>(h) * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (rowA < S)
      *reinterpret_cast<uint32_t*>(ob + rowA * NHD + col) = pack_bf16(oacc[dt][0] * invA, oacc[dt][1] * invA);
    if (rowB < S)
      *reinterpret_cast<uint32_t*>(ob + rowB * NHD + col) = pack_bf16(oacc[dt][2] * invB, oacc[dt][3] * invB);
  }
}

}  // namespace

extern "C" int flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* kv_start, const void* kv_end,
    int B, int S, int T, int NH, int NKV, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || NH <= 0 || NKV <= 0 || NH % NKV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + BQ - 1) / BQ, NH, B);
  const dim3 block(128);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  const auto* sp = static_cast<const int*>(kv_start);
  const auto* ep = static_cast<const int*>(kv_end);
  const int group = NH / NKV;
  if (D == 64) {
    flash_fwd_kernel<64><<<grid, block, 0, st>>>(qp, kp, vp, op, lp, sp, ep, S, T, NH, group,
        q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal);
  } else if (D == 128) {
    flash_fwd_kernel<128><<<grid, block, 0, st>>>(qp, kp, vp, op, lp, sp, ep, S, T, NH, group,
        q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
