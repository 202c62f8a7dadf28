// Speculative block-verify GQA attention over the stacked head-major KV
// cache, for Hopper (sm_90a). bf16 queries; bf16 cache, or int8 cache with
// bf16 per-(token, head) scales.
//
// Replaces the Pallas TPU kernel `_decode_kernel` (vggt_qwen3_tpu/ops/
// decode_attention.py:55, pallas_call at :239) as reached through
// `gqa_block_verify_attention` (:317): a verify block of S tokens per batch
// row, query j attending to the slots [start, end0 + j) of layer li's cache,
// where start = clip(kv_start, 0, T) and end0 = clip(kv_off + 1, 0,
// T - (S - 1)). Numerics are the decode kernel's (csrc/decode_attention.cu):
// bf16 cache: f32 QK, scores x D^-0.5, f32 PV. int8 cache: scores x (ks *
// D^-0.5), the row sum l taken before p is multiplied by the V scale, f32 PV
// over the int8 values. Output divided by max(l, 1e-20); a query with no
// valid slot gives 0.
//
// What bounds it on the H100: bytes, in principle. The block reads the valid
// K/V slots of its (row, kv head) once for all S * group score rows (28 at
// the ARKit shape: S = 7, group 4), so it does 4 * 28 flops per K/V value
// pair, still far below the card's ~295 flops/byte ridge. At T <= 832 and
// B = 4 the grid has only NKV * B = 32 blocks on 132 SMs, so in this version
// latency, not bandwidth, sets its time.
//
// Design: grid (NKV, B); one block serves the R = S * group score rows that
// share one kv head (row r = j * group + g), so each K/V slot is read from
// memory once for all of them (the TPU kernel's block-diagonal
// [S * NH, NKV * T] flatten, which costs NKV x the flops, has no counterpart
// here). The block walks [start, end0 + S - 1) in tiles of 32 slots: 16-byte
// cp.async copies stage the raw bf16 or int8 K/V of the next tile in shared
// memory (double-buffered) while the current tile is computed, so a tile's
// load latency is hidden behind the one before. Each warp owns 4 score rows
// and keeps an online softmax per row: lane i scores slot i of the tile
// against its rows (q rows sit in shared memory as f32, read as broadcasts;
// K converts to f32 exactly on the way into registers), masks slot d for
// query j at d >= end0 + j, and writes p (times the V scale) to shared
// memory; then lane i accumulates dims [i * D/32, (i+1) * D/32) of P V for
// the same rows. A row's whole softmax lives in one warp, so warps never
// merge. The layer is chosen by pointer offset: no per-layer copy is made.
// Simple and right first: no split over T across blocks, no tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 32;          // cache slots per shared-memory tile: one per lane
constexpr int RPW = 4;          // score rows per warp
constexpr int MAX_ROWS = 128;   // S * group
constexpr int MAX_WARPS = MAX_ROWS / RPW;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void bf16x2_to_f32(unsigned w, float* f) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  f[0] = x.x;
  f[1] = x.y;
}

__device__ __forceinline__ void s8x4_to_f32(unsigned w, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
}

// N consecutive cache values in shared memory (aligned to their byte count)
// to f32, exactly: one 2-, 4-, 8- or 16-byte load.
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* f) {
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    bf16x2_to_f32(u.x, f); bf16x2_to_f32(u.y, f + 2); bf16x2_to_f32(u.z, f + 4); bf16x2_to_f32(u.w, f + 6);
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    bf16x2_to_f32(u.x, f); bf16x2_to_f32(u.y, f + 2);
  } else {
    static_assert(N == 2, "2, 4 or 8 bf16 values");
    bf16x2_to_f32(*reinterpret_cast<const unsigned*>(p), f);
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const int8_t* p, float* f) {
  if constexpr (N == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    s8x4_to_f32(u.x, f); s8x4_to_f32(u.y, f + 4); s8x4_to_f32(u.z, f + 8); s8x4_to_f32(u.w, f + 12);
  } else if constexpr (N == 4) {
    s8x4_to_f32(*reinterpret_cast<const unsigned*>(p), f);
  } else {
    static_assert(N == 2, "2, 4 or 16 int8 values");
    const unsigned short h = *reinterpret_cast<const unsigned short*>(p);
    f[0] = static_cast<float>(static_cast<int8_t>(h & 0xffu));
    f[1] = static_cast<float>(static_cast<int8_t>(h >> 8));
  }
}

// Shared memory: raw K tiles [2][BT][D + VEC] (the pad of one 16-byte chunk
// makes lane i's 16-byte reads of row i fall on distinct banks), raw V tiles
// [2][BT][D], the slots' K scale x D^-0.5 and V scale [BT] each, q [rows][D]
// f32 and p [rows][BT] f32.
template <int D, typename KV>
struct Layout {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(KV));  // values per 16-byte chunk
  static constexpr int KROW = D + VEC;
  static constexpr int K_BYTES = 2 * BT * KROW * static_cast<int>(sizeof(KV));
  static constexpr int V_BYTES = 2 * BT * D * static_cast<int>(sizeof(KV));
  static constexpr int SC_BYTES = 2 * BT * 4;
  static __host__ __device__ constexpr int bytes(int rows) {
    return K_BYTES + V_BYTES + SC_BYTES + rows * D * 4 + rows * BT * 4;
  }
};

template <int D, typename KV, bool QUANT>
__global__ void __launch_bounds__(MAX_WARPS * 32) verify_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, S, NH, D]
    const KV* __restrict__ k,              // layer li: [B, NKV, T, D]
    const KV* __restrict__ v,
    const __nv_bfloat16* __restrict__ ks,  // layer li: [B, NKV, T] (int8 cache)
    const __nv_bfloat16* __restrict__ vs,
    __nv_bfloat16* __restrict__ out,       // [B, S, NH, D]
    const int* __restrict__ kv_start, const int* __restrict__ kv_off,
    int S, int NH, int NKV, int T, float scale) {
  using Lay = Layout<D, KV>;
  constexpr int VEC = Lay::VEC, KROW = Lay::KROW;
  constexpr int EPL = D / 32;          // P V dims per lane
  constexpr int CPR = D / VEC;         // 16-byte chunks per cache row
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = NH / NKV, R = S * G;
  const int nwarps = blockDim.x >> 5, rpad = nwarps * RPW;
  KV* kraw = reinterpret_cast<KV*>(smem);                             // [2][BT][KROW]
  KV* vraw = reinterpret_cast<KV*>(smem + Lay::K_BYTES);              // [2][BT][D]
  float* ksc = reinterpret_cast<float*>(smem + Lay::K_BYTES + Lay::V_BYTES);  // [BT]
  float* vsc = ksc + BT;                                              // [BT]
  float* qs = vsc + BT;                                               // [rpad][D]
  float* ps = qs + rpad * D;                                          // [rpad][BT]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int start = min(max(kv_start[b], 0), T);
  const int end0 = min(max(kv_off[b] + 1, 0), T - (S - 1));
  const int hi = end0 + S - 1;  // one past the last slot any query sees
  const int ntiles = hi > start ? (hi - start + BT - 1) / BT : 0;
  const long long row0 = (static_cast<long long>(b) * NKV + kvh) * T;

  // stage tile i's raw K/V into buffer i & 1 (slots past T read slot T - 1:
  // finite values whose p is 0)
  auto stage_tile = [&](int i) {
    const int t0 = start + i * BT, bufi = i & 1;
    for (int c = tid; c < 2 * BT * CPR; c += blockDim.x) {
      const bool is_v = c >= BT * CPR;
      const int cc = is_v ? c - BT * CPR : c;
      const int s = cc / CPR, d0 = (cc % CPR) * VEC;
      const long long src = (row0 + min(t0 + s, T - 1)) * D + d0;
      if (is_v) cp_async16(vraw + (bufi * BT + s) * D + d0, v + src);
      else cp_async16(kraw + (bufi * BT + s) * KROW + d0, k + src);
    }
    cp_async_commit();
  };
  float sk = scale, sv = 1.f;  // this thread's slot scales of the next tile (tid < BT)
  auto scales = [&](int i) {
    if (QUANT && tid < BT) {
      const long long t = row0 + min(start + i * BT + tid, T - 1);
      sk = __bfloat162float(ks[t]) * scale;
      sv = __bfloat162float(vs[t]);
    }
  };
  if (ntiles > 0) {
    stage_tile(0);
    scales(0);
  }

  for (int idx = tid; idx < rpad * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    float x = 0.f;
    if (r < R) x = __bfloat162float(q[((static_cast<long long>(b) * S + r / G) * NH + kvh * G + r % G) * D + d]);
    qs[idx] = x;
  }

  float acc[RPW][EPL], m[RPW], l[RPW];
  int row_end[RPW];  // one past the last slot each of this warp's rows sees
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    m[i] = -INFINITY;
    l[i] = 0.f;
    row_end[i] = r < R ? end0 + r / G : start;  // padding rows see nothing
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  }

  for (int i = 0; i < ntiles; ++i) {
    if (tid < BT) {
      ksc[tid] = sk;
      vsc[tid] = sv;
    }
    if (i + 1 < ntiles) {
      stage_tile(i + 1);  // into the buffer tile i - 1 used, freed by the sync that ended it
      scales(i + 1);
      cp_async_wait<1>();  // tile i has landed; tile i + 1 may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const KV* kt = kraw + (i & 1) * BT * KROW;
    const KV* vt = vraw + (i & 1) * BT * D;

    // scores: lane = slot t0 + lane, against this warp's RPW rows
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += VEC) {
      float kf[VEC];
      load_f32<VEC>(kt + lane * KROW + d, kf);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float* qr = qs + (warp * RPW + r) * D + d;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
          s[r] += q4.x * kf[e] + q4.y * kf[e + 1] + q4.z * kf[e + 2] + q4.w * kf[e + 3];
        }
      }
    }
    const int t = start + i * BT + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float sc = t < row_end[r] ? s[r] * ksc[lane] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sc));
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {  // the same on every lane of the warp
        alpha = expf(m[r] - m_new);  // 0 while the row had seen no slot
        p = t < row_end[r] ? expf(sc - m_new) : 0.f;
      }
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      ps[(warp * RPW + r) * BT + lane] = p * vsc[lane];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
    }
    __syncwarp();

    // P V: lane owns dims [lane * EPL, (lane + 1) * EPL)
#pragma unroll 4
    for (int sl = 0; sl < BT; ++sl) {
      float vf[EPL];
      load_f32<EPL>(vt + sl * D + lane * EPL, vf);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = ps[(warp * RPW + r) * BT + sl];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] += p * vf[e];
      }
    }
    __syncthreads();  // every warp is done with this tile's buffers and scales
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp * RPW + r;
    if (row >= R) break;
    const long long o = ((static_cast<long long>(b) * S + row / G) * NH + kvh * G + row % G) * D + lane * EPL;
    const float den = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[o + e] = __float2bfloat16(acc[r][e] / den);
  }
}

template <int D, typename KV, bool QUANT>
int launch_t(const void* q, const void* k, const void* v, const void* ks, const void* vs, void* out,
             const void* s, const void* e, int B, int S, int NH, int NKV, int T, float scale,
             cudaStream_t st) {
  auto kern = verify_kernel<D, KV, QUANT>;
  static bool configured = false;  // one card: the attribute is set once per kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 Layout<D, KV>::bytes(MAX_ROWS));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int warps = (S * (NH / NKV) + RPW - 1) / RPW;
  kern<<<dim3(NKV, B), warps * 32, Layout<D, KV>::bytes(warps * RPW), st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const __nv_bfloat16*>(ks), static_cast<const __nv_bfloat16*>(vs),
      static_cast<__nv_bfloat16*>(out), static_cast<const int*>(s), static_cast<const int*>(e),
      S, NH, NKV, T, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs, void* out,
           const void* s, const void* e, int B, int S, int NH, int NKV, int T, int quant, float scale,
           cudaStream_t st) {
  if (quant) return launch_t<D, int8_t, true>(q, k, v, ks, vs, out, s, e, B, S, NH, NKV, T, scale, st);
  return launch_t<D, __nv_bfloat16, false>(q, k, v, nullptr, nullptr, out, s, e, B, S, NH, NKV, T, scale, st);
}

}  // namespace

// k/v (and ks/vs) point at layer li of the stacked cache; quant selects the
// int8 cache with bf16 scales. kv_start/kv_off are [B] int32.
extern "C" int block_verify_attention(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    void* out, const void* kv_start, const void* kv_off,
    int B, int S, int NH, int NKV, int T, int D, int quant, float scale, void* stream) {
  if (B <= 0 || NKV <= 0 || NH % NKV != 0 || S < 1 || S > T || S * (NH / NKV) > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, ks, vs, out, kv_start, kv_off, B, S, NH, NKV, T, quant, scale, st);
  if (D == 128) return launch<128>(q, k, v, ks, vs, out, kv_start, kv_off, B, S, NH, NKV, T, quant, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
