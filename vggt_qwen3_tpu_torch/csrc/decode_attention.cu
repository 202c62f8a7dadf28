// Single-token GQA decode attention over the stacked head-major KV cache,
// for Hopper (sm_90a). bf16 queries; bf16 cache, or int8 cache with bf16
// per-(token, head) scales.
//
// Replaces the Pallas TPU kernel `_decode_kernel` (vggt_qwen3_tpu/ops/
// decode_attention.py:55, pallas_call at :239) reached through
// `gqa_decode_attention`. Same function: for each batch row the queries of
// one step attend to the slots [kv_start, kv_end) of layer li's cache. bf16
// cache: f32 QK and f32 PV. int8 cache: the K scale and D^-0.5 fold onto the
// f32 scores, the row sum l is taken before p is multiplied by the V scale,
// and PV runs in f32. Output is divided by max(l, 1e-20).
//
// What bounds it on the H100: bytes. Each step reads every valid K/V slot of
// the layer once (2 bytes a value, or 1 byte plus the scales) and does only
// 4 flops per byte pair, far below the card's ~295 flops/byte ridge.
//
// Design: grid (NKV, B), 4 warps. A block serves the `group` query heads
// that share one kv head, so each K/V row is read once for all of them (the
// TPU kernel's block-diagonal [NH, NKV*T] flatten, which costs NKV x the
// flops, has no counterpart here). Each warp walks every fourth slot of
// [start, end) with its own online softmax (lane i holds dims
// [i*D/32, (i+1)*D/32)); the four partial (m, l, acc) merge through shared
// memory at the end. The layer is chosen by pointer offset: the wrapper
// passes layer li's base address, so no per-layer copy is made.
// This first version is simple and right: no split over T across blocks and
// no vector loads (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int MAXG = 8;  // query heads per kv head supported

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, typename KV, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32) decode_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, NH, D]
    const KV* __restrict__ k,              // layer li: [B, NKV, T, D]
    const KV* __restrict__ v,
    const __nv_bfloat16* __restrict__ ks,  // layer li: [B, NKV, T] (int8 cache)
    const __nv_bfloat16* __restrict__ vs,
    __nv_bfloat16* __restrict__ out,       // [B, NH, D]
    const int* __restrict__ kv_start, const int* __restrict__ kv_end,
    int NH, int NKV, int T, float scale) {
  constexpr int EPL = D / 32;  // elements per lane
  __shared__ float sm_m[WARPS][MAXG];
  __shared__ float sm_l[WARPS][MAXG];
  __shared__ float sm_acc[WARPS][MAXG][D];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = NH / NKV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int start = max(0, min(kv_start[b], T));
  const int end = max(0, min(kv_end[b], T));

  float qr[MAXG][EPL];
  float acc[MAXG][EPL];
  float m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      acc[g][i] = 0.f;
      qr[g][i] = g < G ? __bfloat162float(q[(static_cast<long long>(b) * NH + kvh * G + g) * D + lane * EPL + i]) : 0.f;
    }
  }

  const long long row0 = (static_cast<long long>(b) * NKV + kvh) * T;
  for (int t = start + warp; t < end; t += WARPS) {
    const KV* kr = k + (row0 + t) * D + lane * EPL;
    const KV* vr = v + (row0 + t) * D + lane * EPL;
    float kf[EPL], vf[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      kf[i] = to_f32(kr[i]);
      vf[i] = to_f32(vr[i]);
    }
    float kscale = scale, vscale = 1.f;
    if (QUANT) {
      kscale = __bfloat162float(ks[row0 + t]) * scale;
      vscale = __bfloat162float(vs[row0 + t]);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) s += qr[g][i] * kf[i];
      s = warp_sum(s) * kscale;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
      const float pv = p * vscale;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[g][i] = acc[g][i] * alpha + pv * vf[i];
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) sm_acc[warp][g][lane * EPL + i] = acc[g][i];
  }
  __syncthreads();

  for (int idx = tid; idx < G * D; idx += WARPS * 32) {
    const int g = idx / D, d = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float c = expf(sm_m[w][g] - M);  // a warp that saw no slot: 0
        L += sm_l[w][g] * c;
        A += sm_acc[w][g][d] * c;
      }
    }
    out[(static_cast<long long>(b) * NH + kvh * G + g) * D + d] = __float2bfloat16(A / fmaxf(L, 1e-20f));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           void* out, const void* s, const void* e, int B, int NH, int NKV, int T,
           int quant, float scale, cudaStream_t st) {
  const dim3 grid(NKV, B), block(WARPS * 32);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const auto* sp = static_cast<const int*>(s);
  const auto* ep = static_cast<const int*>(e);
  if (quant) {
    decode_kernel<D, int8_t, true><<<grid, block, 0, st>>>(
        qp, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
        static_cast<const __nv_bfloat16*>(ks), static_cast<const __nv_bfloat16*>(vs),
        op, sp, ep, NH, NKV, T, scale);
  } else {
    decode_kernel<D, __nv_bfloat16, false><<<grid, block, 0, st>>>(
        qp, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
        nullptr, nullptr, op, sp, ep, NH, NKV, T, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k/v (and ks/vs) point at layer li of the stacked cache; quant selects the
// int8 cache with bf16 scales.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    void* out, const void* kv_start, const void* kv_end,
    int B, int NH, int NKV, int T, int D, int quant, float scale, void* stream) {
  if (B <= 0 || NKV <= 0 || NH % NKV != 0 || NH / NKV > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, ks, vs, out, kv_start, kv_end, B, NH, NKV, T, quant, scale, st);
  if (D == 128) return launch<128>(q, k, v, ks, vs, out, kv_start, kv_end, B, NH, NKV, T, quant, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
