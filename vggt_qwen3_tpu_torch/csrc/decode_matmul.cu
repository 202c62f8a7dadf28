// W8 dequant-matmul kernels of the decode step, for Hopper (sm_90a): bf16
// activations times int8 weights with a bf16 scale per output channel.
//
// Replaces the four Pallas TPU kernels of vggt_qwen3_tpu/ops/decode_matmul.py:
//   `_qkv_kernel`    (:180, pallas_call :249) -> w8_gemm, three segments
//   `_linear_kernel` (:283, pallas_call :320) -> w8_gemm, one segment
//   `_mlp_kernel`    (:44,  pallas_call :157) -> w8_swiglu + w8_gemm (down)
//   `_head_argmax_kernel` (:345, pallas_call :418) -> head_argmax
//
// Same functions, same roundings:
// - layer kernels: each weight element is bf16(bf16(w8) * bf16 scale), which
//   is __float2bfloat16_rn(float(w8) * float(scale)) exactly (an int8 times a
//   bf16 is exact in f32); products summed in f32; each projection's output
//   rounded to bf16. The SwiGLU activation is bf16(bf16(silu_f32(g)) * u) with
//   g and u the bf16-rounded gate/up projections.
// - head: logits are f32 dot(x, bf16(w8)) and only then times the f32 scale
//   (no scale before the dot); argmax with the lowest index among equal maxima.
//
// w8_gemm (QKV, WO, the MLP's down projection). What bounds it on the H100:
// operations at the decode bench shape (368 rows: every weight byte feeds
// 2 * 368 = 736 flops, above the card's ~295 flops/byte ridge for bf16),
// bytes at a few rows (8 rows: 16 flops a weight byte; the int8 weights are
// the traffic). Design, swap-AB: outT [N, M] = deq(W)T . xT, so that 64 output
// channels are wgmma's M and the activation rows its N (a template width of
// 8 to 128 rows; the rows past M read TMA's zero fill and are never stored).
// A block is two consumer warpgroups and a producer warpgroup (which, at 96
// and 128 rows, gives the consumers its registers: setmaxnreg 24 / 240) and owns 256
// channels (128 a warpgroup: two m64 tiles that share the x operand) of one
// segment, one group of rows and one part of K:
//  - the producer keeps TMA loads of the int8 weight tile (two 128-channel x
//    64-deep boxes) and the bf16 x tile (rows x 64-deep, K-major) in flight
//    through a ring of up to 8 stages with full/empty mbarriers; both use the
//    128-byte swizzle. The weight of layer li is a 2-D tensor map {N, K} per
//    segment encoded at the layer's base (pointer offset); up to three
//    segments (wq|wk|wv) share one launch, a block's tile in one of them.
//  - the consumers read the int8 tile with ldmatrix.trans (the b16 elements
//    are channel pairs, so a register holds two channels at two depths) and
//    dequantize it straight into wgmma's register A fragments: A row g is
//    channel 2g and row g + 8 channel 2g + 1 of a warp's 16, the bytes become
//    f32 by a byte permute onto 2^23 and one FMA with the scale (exact: the
//    result is float(w8) * scale), and cvt.rn.bf16x2 rounds once. The x tile
//    is wgmma's B from shared memory (K-major descriptor). Each 16-deep step
//    is committed as one wgmma group; the next step's weights are dequantized
//    while it runs (wgmma.wait_group 1), and the int8 tile never exists as
//    bf16 in shared memory. Each weight tile is read and dequantized once per
//    block, for all of its rows.
//  - the grid is (K parts, row groups, channel tiles). With one part a block
//    stores its sums from the accumulators as bf16 pairs (each store
//    instruction fills whole 32-byte sectors). Otherwise the K parts of a
//    tile form a thread-block cluster (at most 8): each block leaves its f32
//    partial tile in its own shared memory, and after a cluster barrier block
//    q sums rows [q R / S, (q + 1) R / S) of all parts in part order 0..S-1
//    through distributed shared memory and writes them as bf16. No workspace,
//    no atomics: every output is summed in the same order on every launch.
// The row width, the number of K parts and so the order of every sum depend
// on (M, K) only (gemm_plan), never on N or the number of segments: a
// segment of the QKV launch equals, bit for bit, a launch over it alone. At a
// few rows K is cut finely (more blocks streaming the weights); at 368 rows
// WO and down take 128-row groups in 4 parts, and QKV (a short K, where a
// part's cluster epilogue does not pay) one part with 80-row groups, so that
// its 120 blocks fill the card in one wave (PERF.md, section 6).
// K must be a multiple of 64 and every N a multiple of 128 (a 256-channel
// tile may be half full: its second warpgroup then idles); the wrappers raise
// otherwise. How K and M are cut (gemm_plan) are nvcc defines, which
// `python3 chip_smoke.py --tiles decode_matmul` sweeps; w8_gemm_plan returns
// the cut of a launch. A launch encodes its two to four tensor maps on the
// host; the kernel's shared-memory attribute is set once a device.
//
// w8_swiglu and head_argmax (mma.sync m16n8k16 bf16 -> f32, the fragment code
// of flash_fwd.cu, with ldmatrix; synchronous staging, later work):
// - w8_swiglu reads each A tile (64 rows) once for both gate and up (64
//   columns each), dequantizing W with its scales on the way into shared
//   memory, and writes the activation a [M, F] bf16; down is then a w8_gemm.
//   On the TPU `a` never left VMEM; here it makes a round trip through
//   L2/HBM (7.2 MB at 368 rows), kept because splitting F with float atomics
//   would make the sums' order, and so the tokens, change from run to run.
// - head_argmax: blocks over (64-row tiles, 128-row vocab tiles); W [V, H] is
//   H-contiguous, the layout mma's B operand takes without a transpose. Each
//   block scales its logits in f32 and reduces each row to (max, lowest
//   index), written to partials [M, V/128]; a second launch reduces each
//   row's partials, one warp per row, by (greater value, or equal value and
//   lower index), which is what a scan in vocab order with a strict `>` and
//   argmax over the whole row give. No atomics; the [M, V] f32 logits never
//   reach device memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#ifndef W8_SMALL_PART_STEPS
#define W8_SMALL_PART_STEPS 10   // w8_gemm, row groups of <= 64 rows: 64-deep steps a K part at most
#endif
#ifndef W8_WIDE_PARTS
#define W8_WIDE_PARTS 4          // w8_gemm, wider row groups (<= 128 rows): K parts...
#endif
#ifndef W8_ONE_PART_STEPS
#define W8_ONE_PART_STEPS 48     // ...unless K has fewer steps: then one part,
#endif
#ifndef W8_ONE_PART_ROWS
#define W8_ONE_PART_ROWS 80      // and row groups of at most this many rows
#endif

namespace {

constexpr int BM = 64;       // rows of a block tile
constexpr int BK = 64;       // depth of a k-step
constexpr int THREADS = 128; // 4 warps, 2 x 2
constexpr int PAD = 8;       // bf16 row padding of the shared tiles (bank conflicts)
constexpr int HEAD_BV = 128; // vocab rows of a head tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans_at(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) { ldsm_x4_trans_at(r, smem_addr(p)); }

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (round to nearest even), lower column low
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- A tile: BM x BK bf16, 8 chunks of 16 bytes a row, 4 chunks a thread ----

__device__ __forceinline__ void load_a(const __nv_bfloat16* __restrict__ A, int M, int K, int m0, int k0,
                                       uint4* ra) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c >> 3, cc = (c & 7) * 8;
    const int row = m0 + r;
    ra[i] = row < M ? *reinterpret_cast<const uint4*>(A + static_cast<long long>(row) * K + k0 + cc)
                    : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_a(__nv_bfloat16 (*As)[BK + PAD], const uint4* ra) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + i * THREADS;
    *reinterpret_cast<uint4*>(&As[c >> 3][(c & 7) * 8]) = ra[i];
  }
}

// ---- W tile of a layer GEMM: BK x BN int8, N-contiguous, 16-byte chunks ----
// A thread's chunks all lie in one 16-column group (THREADS is a multiple of
// the chunks in a row), so it holds that group's 16 scales in registers.

template <int BN>
__device__ __forceinline__ void load_w(const int8_t* __restrict__ W, int N, int k0, int n0, uint4* rw) {
  constexpr int CPR = BN / 16;
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / CPR, cc = (c % CPR) * 16;
    rw[i] = *reinterpret_cast<const uint4*>(W + static_cast<long long>(k0 + r) * N + n0 + cc);
  }
}

template <int BN>
__device__ __forceinline__ void load_scales(const __nv_bfloat16* __restrict__ S, int n0, float* sc) {
  const int cc = (threadIdx.x % (BN / 16)) * 16;
#pragma unroll
  for (int j = 0; j < 16; ++j) sc[j] = __bfloat162float(S[n0 + cc + j]);
}

// dequantize on the way in: bf16(float(w8) * scale), each element rounded once
template <int BN>
__device__ __forceinline__ void store_w(__nv_bfloat16 (*Bs)[BN + PAD], const uint4* rw, const float* sc) {
  constexpr int CPR = BN / 16;
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / CPR, cc = (c % CPR) * 16;
    const int8_t* b = reinterpret_cast<const int8_t*>(&rw[i]);
    uint32_t p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      p[j] = pack_bf16(static_cast<float>(b[2 * j]) * sc[2 * j], static_cast<float>(b[2 * j + 1]) * sc[2 * j + 1]);
    *reinterpret_cast<uint4*>(&Bs[r][cc]) = make_uint4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<uint4*>(&Bs[r][cc + 8]) = make_uint4(p[4], p[5], p[6], p[7]);
  }
}

// One BK-deep step of a warp's 32 x (BN/2) tile; B is [k][n] in shared memory.
template <int BN>
__device__ __forceinline__ void warp_mma_kn(__nv_bfloat16 (*As)[BK + PAD], __nv_bfloat16 (*Bs)[BN + PAD],
                                            float (*acc)[BN / 16][4], int wm, int wn, int lane) {
  constexpr int WN = BN / 2;
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) ldsm_x4(af[mt], &As[wm * 32 + mt * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
#pragma unroll
    for (int p = 0; p < WN / 16; ++p) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, &Bs[ks * 16 + (lane & 15)][wn * WN + p * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_16816(acc[mt][2 * p], af[mt], bf[0], bf[1]);
        mma_16816(acc[mt][2 * p + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

// ---- w8_swiglu: a = bf16(bf16(silu(bf16(x@deq(gate)))) * bf16(x@deq(up))) ----

constexpr int SW_BN = 64;

__global__ void __launch_bounds__(THREADS) w8_swiglu_kernel(
    const __nv_bfloat16* __restrict__ A, int M, int K,
    const int8_t* __restrict__ Wg, const __nv_bfloat16* __restrict__ Sg,
    const int8_t* __restrict__ Wu, const __nv_bfloat16* __restrict__ Su,
    __nv_bfloat16* __restrict__ out, int F) {
  constexpr int NT = SW_BN / 16;
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];
  __shared__ __align__(16) __nv_bfloat16 Bg[BK][SW_BN + PAD];
  __shared__ __align__(16) __nv_bfloat16 Bu[BK][SW_BN + PAD];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * SW_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;

  float scg[16], scu[16];
  load_scales<SW_BN>(Sg, n0, scg);
  load_scales<SW_BN>(Su, n0, scu);
  float accg[2][NT][4], accu[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[mt][nt][e] = accu[mt][nt][e] = 0.f;

  uint4 ra[4], rg[SW_BN / 32], ru[SW_BN / 32];
  load_a(A, M, K, m0, 0, ra);
  load_w<SW_BN>(Wg, F, 0, n0, rg);
  load_w<SW_BN>(Wu, F, 0, n0, ru);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_a(As, ra);
    store_w<SW_BN>(Bg, rg, scg);
    store_w<SW_BN>(Bu, ru, scu);
    __syncthreads();
    if (k0 + BK < K) {
      load_a(A, M, K, m0, k0 + BK, ra);
      load_w<SW_BN>(Wg, F, k0 + BK, n0, rg);
      load_w<SW_BN>(Wu, F, k0 + BK, n0, ru);
    }
    warp_mma_kn<SW_BN>(As, Bg, accg, wm, wn, lane);
    warp_mma_kn<SW_BN>(As, Bu, accu, wm, wn, lane);
    __syncthreads();
  }

  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + mt * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * (SW_BN / 2) + nt * 8 + tig * 2;
        float a[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gv = bf16_round(accg[mt][nt][2 * h + e]);
          const float uv = bf16_round(accu[mt][nt][2 * h + e]);
          a[e] = bf16_round(gv / (1.f + expf(-gv))) * uv;
        }
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * F + col) = pack_bf16(a[0], a[1]);
      }
    }
  }
}

// ---- head_argmax: per (row tile, vocab tile) partial (max, lowest index) ----

// (v, i) beats (bv, bi): greater value, or an equal value at a lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS) head_tile_kernel(
    const __nv_bfloat16* __restrict__ X, int M, int K,
    const int8_t* __restrict__ W, const __nv_bfloat16* __restrict__ S,
    float* __restrict__ pval, int* __restrict__ pidx, int n_tiles) {
  constexpr int NT = HEAD_BV / 16;  // n8 tiles of a warp (64 vocab rows)
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];
  __shared__ __align__(16) __nv_bfloat16 Ws[HEAD_BV][BK + PAD];  // [v][k]
  __shared__ float red_v[2][BM];
  __shared__ int red_i[2][BM];

  const int m0 = blockIdx.x * BM, v0 = blockIdx.y * HEAD_BV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tig = lane & 3;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  // W tile: 128 vocab rows x 64 int8 = 4 chunks a row, 4 chunks a thread
  uint4 ra[4], rw[4];
  auto load_head_w = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = threadIdx.x + i * THREADS;
      rw[i] = *reinterpret_cast<const uint4*>(W + static_cast<long long>(v0 + (c >> 2)) * K + k0 + (c & 3) * 16);
    }
  };
  load_a(X, M, K, m0, 0, ra);
  load_head_w(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_a(As, ra);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // int8 -> bf16 is exact: no scale before the dot
      const int c = threadIdx.x + i * THREADS;
      const int r = c >> 2, cc = (c & 3) * 16;
      const int8_t* b = reinterpret_cast<const int8_t*>(&rw[i]);
      uint32_t p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = pack_bf16(static_cast<float>(b[2 * j]), static_cast<float>(b[2 * j + 1]));
      *reinterpret_cast<uint4*>(&Ws[r][cc]) = make_uint4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<uint4*>(&Ws[r][cc + 8]) = make_uint4(p[4], p[5], p[6], p[7]);
    }
    __syncthreads();
    if (k0 + BK < K) {
      load_a(X, M, K, m0, k0 + BK, ra);
      load_head_w(k0 + BK);
    }
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_x4(af[mt], &As[wm * 32 + mt * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        // matrices: (n-tile 2p, k 0-7), (2p, k 8-15), (2p+1, k 0-7), (2p+1, k 8-15)
        uint32_t bf[4];
        ldsm_x4(bf, &Ws[wn * 64 + p * 16 + (lane & 7) + ((lane >> 4) << 3)][ks * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_16816(acc[mt][2 * p], af[mt], bf[0], bf[1]);
          mma_16816(acc[mt][2 * p + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }

  // f32 scale after the dot, then each row's (max, lowest index) over the tile
  float sc[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) sc[nt][e] = __bfloat162float(S[v0 + wn * 64 + nt * 8 + tig * 2 + e]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float bv = acc[mt][0][2 * h] * sc[0][0];
      int bi = v0 + wn * 64 + tig * 2;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[mt][nt][2 * h + e] * sc[nt][e];
          const int i = v0 + wn * 64 + nt * 8 + tig * 2 + e;
          if (beats(v, i, bv, bi)) {
            bv = v;
            bi = i;
          }
        }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {  // the row's four threads
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (beats(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (tig == 0) {
        const int r = wm * 32 + mt * 16 + h * 8 + g;
        red_v[wn][r] = bv;
        red_i[wn][r] = bi;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < BM && m0 + threadIdx.x < M) {
    const int r = threadIdx.x;
    float bv = red_v[0][r];
    int bi = red_i[0][r];
    if (beats(red_v[1][r], red_i[1][r], bv, bi)) {
      bv = red_v[1][r];
      bi = red_i[1][r];
    }
    const long long o = static_cast<long long>(m0 + r) * n_tiles + blockIdx.y;
    pval[o] = bv;
    pidx[o] = bi;
  }
}

// one warp per row over its partials [n_tiles]
__global__ void __launch_bounds__(256) head_reduce_kernel(const float* __restrict__ pval, const int* __restrict__ pidx,
                                                          int M, int n_tiles, int* __restrict__ tok,
                                                          float* __restrict__ maxv) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  float bv = -INFINITY;
  int bi = INT_MAX;
  const long long base = static_cast<long long>(row) * n_tiles;
  for (int j = lane; j < n_tiles; j += 32) {
    const float v = pval[base + j];
    const int i = pidx[base + j];
    if (beats(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (beats(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    tok[row] = bi;
    maxv[row] = bv;
  }
}

// ===========================================================================
// w8_gemm: swap-AB wgmma over TMA-fed int8 weight tiles
// ===========================================================================

constexpr int GEMM_THREADS = 384;    // consumer warpgroups 0 and 1, then the producer's
constexpr int GEMM_CH = 256;         // output channels of a block, 128 a consumer warpgroup
constexpr int GEMM_MAX_ROWS = 128;   // rows of a row group at most
constexpr int GEMM_MAX_SPLITS = 8;   // K parts at most: the portable cluster size
constexpr int ENCODE_FAILED = 10000; // + CUresult: a tensor map could not be encoded
constexpr float DEQ_BIAS = 8388736.f;  // 2^23 + 128

// --- mbarriers, TMA, clusters ----------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 2-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; orders the shared-memory writes
// before it with the reads after it, across the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// 16 bytes of block `rank`'s shared memory at the offset of local `addr`
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote) : "memory");
  return v;
}

// --- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile written by TMA with the
// 128-byte swizzle (1024-byte atoms of 8 rows x 128 bytes): `addr` steps 32
// bytes per k16 inside the row, SBO = 1024 (the next 8 rows), LBO unused.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void setmaxnreg_producer() { asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n"); }
__device__ __forceinline__ void setmaxnreg_consumer() { asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// until at most N of this warpgroup's committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that a running
// wgmma writes (accumulators) or reads (A fragments) across the asynchronous
// region, and from giving their registers to other values before it ends.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_frags(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// m64nRk16, f32 += bf16 x bf16: A from registers (the m16n8k16 A fragment of
// each warp's 16 rows), B from shared memory, K-major; R / 2 floats a thread
template <int R>
struct WgmmaRS;

#define W8_R4 "%0, %1, %2, %3"
#define W8_R8 W8_R4 ", %4, %5, %6, %7"
#define W8_R16 W8_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define W8_R32 W8_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define W8_R40 W8_R32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define W8_R48 W8_R40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define W8_R64 W8_R48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define W8_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define W8_D8(i) W8_D4(i), W8_D4(i + 4)
#define W8_D16(i) W8_D8(i), W8_D8(i + 8)
#define W8_D32(i) W8_D16(i), W8_D16(i + 16)
// REGS: the accumulator operands; A, DESC, ACC: the operand numbers after them
#define W8_WGMMA_RS(R, REGS, A, DESC, ACC, ...)                                                          \
  template <>                                                                                            \
  struct WgmmaRS<R> {                                                                                    \
    static __device__ __forceinline__ void mma(float (&d)[R / 2], const uint32_t (&a)[4], uint64_t b) {  \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " ACC ", 0;\n"                                      \
                   "wgmma.mma_async.sync.aligned.m64n" #R "k16.f32.bf16.bf16 {" REGS "}, {" A "}, " DESC \
                   ", p, 1, 1, 0;\n}\n"                                                                  \
                   : __VA_ARGS__                                                                         \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                       \
    }                                                                                                    \
  };
W8_WGMMA_RS(8, W8_R4, "%4, %5, %6, %7", "%8", "%9", W8_D4(0))
W8_WGMMA_RS(16, W8_R8, "%8, %9, %10, %11", "%12", "%13", W8_D8(0))
W8_WGMMA_RS(32, W8_R16, "%16, %17, %18, %19", "%20", "%21", W8_D16(0))
W8_WGMMA_RS(64, W8_R32, "%32, %33, %34, %35", "%36", "%37", W8_D32(0))
W8_WGMMA_RS(80, W8_R40, "%40, %41, %42, %43", "%44", "%45", W8_D32(0), W8_D8(32))
W8_WGMMA_RS(96, W8_R48, "%48, %49, %50, %51", "%52", "%53", W8_D32(0), W8_D16(32))
W8_WGMMA_RS(128, W8_R64, "%64, %65, %66, %67", "%68", "%69", W8_D32(0), W8_D32(32))
#undef W8_WGMMA_RS

// --- dequantization into A fragments -----------------------------------------

// One ldmatrix.trans register of the int8 tile holds the bytes w[k][c],
// w[k][c+1], w[k+1][c], w[k+1][c+1]. Out: the A fragment registers of rows c
// (lo) and c + 1 (hi) at depths (k, k + 1), each element bf16(w8 * scale)
// rounded once. A byte b becomes the float 2^23 + 128 + b (bits 0x4B0000uu,
// uu = b ^ 0x80), and fma(that, s, -(2^23 + 128) s) = b s exactly: for a bf16
// scale, (2^23 + 128) s has at most 24 significant bits.
__device__ __forceinline__ void dequant(uint32_t r, float s0, float n0, float s1, float n1, uint32_t& lo,
                                        uint32_t& hi) {
  const uint32_t u = r ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651));
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652));
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653));
  lo = pack_bf16(fmaf(f0, s0, n0), fmaf(f2, s0, n0));
  hi = pack_bf16(fmaf(f1, s1, n1), fmaf(f3, s1, n1));
}

// A 16-deep step's A fragments of both tiles of a warpgroup: one
// ldmatrix.x4.trans at this lane's address in the int8 box (tile 0 depths
// 0-7, 8-15, then tile 1's), dequantized with the thread's channels' scales
__device__ __forceinline__ void load_frags(uint32_t addr, const float (&sc)[2][2], const float (&sn)[2][2],
                                           uint32_t (&f)[2][4]) {
  uint32_t r[4];
  ldsm_x4_trans_at(r, addr);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dequant(r[2 * i], sc[i][0], sn[i][0], sc[i][1], sn[i][1], f[i][0], f[i][1]);
    dequant(r[2 * i + 1], sc[i][0], sn[i][0], sc[i][1], sn[i][1], f[i][2], f[i][3]);
  }
}

// --- the kernel ----------------------------------------------------------------

struct GemmSeg {
  const __nv_bfloat16* s;  // the layer's scales [n]
  __nv_bfloat16* out;      // [M, n]
  int n;                   // a multiple of 128
  int tiles;               // ceil(n / GEMM_CH)
};

struct GemmSegs {
  GemmSeg seg[3];
  int count;
};

// Shared memory of a block with R rows: NS ring stages (two int8 weight
// boxes of 128 channels x 64 deep, then the bf16 x tile of R rows x 64 deep,
// each 1024-byte aligned), reused after the main loop for the f32 partial
// tile [R][GEMM_CH] (rows padded by 16 bytes); then the full and empty
// barriers.
template <int R>
struct GemmSmem {
  static constexpr int W_BOX = 64 * 128;
  static constexpr int X_TILE = R * 128;
  static constexpr int STAGE = 2 * W_BOX + X_TILE;
  // up to 32 rows a ring small enough for two or three blocks an SM
  static constexpr int RING_KB = R <= 32 ? 72 : 200;
  static constexpr int NS = RING_KB * 1024 / STAGE < 8 ? RING_KB * 1024 / STAGE : 8;
  static constexpr int P_ROW = GEMM_CH * 4 + 16;
  static constexpr int RING = NS * STAGE;
  static constexpr int BAR_OFF = RING > R * P_ROW ? RING : R * P_ROW;
  static constexpr int BYTES = BAR_OFF + 2 * NS * 8 + 1024;  // + slack for the 1024-byte alignment
  // rows above 80 take 240 registers a consumer thread (in 168, ptxas spills
  // at 96 rows and serializes the wgmmas at 128; above 32 rows the ring keeps
  // one block an SM anyway); narrower ones fit in 168, and blocks of up to 32
  // rows fit two or three an SM
  static constexpr bool MOVE_REGS = R > 80;
    static_assert(BYTES <= 232448, "more shared memory than a block can have");
};

// A tile's accumulator into the f32 partial tile (rows P_ROW bytes apart):
// D[row c][column m], held by the thread as columns 8j + 2t and 8j + 2t + 1
// of rows c and c + 1, is out[m][c]
template <int R, int P_ROW>
__device__ __forceinline__ void store_partial(unsigned char* smem, const float (&d)[R / 2], int c, int t) {
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
    const int m = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(smem + m * P_ROW + c * 4) = make_float2(d[4 * j], d[4 * j + 2]);
    *reinterpret_cast<float2*>(smem + (m + 1) * P_ROW + c * 4) = make_float2(d[4 * j + 1], d[4 * j + 3]);
  }
}

// A tile's accumulator (channels c, c + 1 of the segment; see store_partial)
// as bf16 pairs into out's rows row0 + m below M
template <int R>
__device__ __forceinline__ void store_rows(const GemmSeg& sg, const float (&d)[R / 2], int row0, int M, int c, int t) {
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + 8 * j + 2 * t + e;
      if (row < M)
        *reinterpret_cast<uint32_t*>(sg.out + static_cast<long long>(row) * sg.n + c) =
            pack_bf16(d[4 * j + e], d[4 * j + 2 + e]);
    }
}

template <int R>
__global__ void __launch_bounds__(GEMM_THREADS, 1) w8_gemm_kernel(
    __grid_constant__ const CUtensorMap tx, __grid_constant__ const CUtensorMap tw0,
    __grid_constant__ const CUtensorMap tw1, __grid_constant__ const CUtensorMap tw2,
    const GemmSegs segs, int M, int k_steps) {
  using L = GemmSmem<R>;
  constexpr int NS = L::NS;
  const int tid = threadIdx.x, wg = tid / 128;
  const int splits = gridDim.x, part = static_cast<int>(cluster_rank());
  const int row0 = blockIdx.y * R;
  int tile = blockIdx.z, si = 0;
  if (segs.count > 1 && tile >= segs.seg[0].tiles) {
    tile -= segs.seg[0].tiles;
    si = 1;
    if (segs.count > 2 && tile >= segs.seg[1].tiles) {
      tile -= segs.seg[1].tiles;
      si = 2;
    }
  }
  const GemmSeg sg = si == 0 ? segs.seg[0] : (si == 1 ? segs.seg[1] : segs.seg[2]);
  const CUtensorMap* tw = si == 0 ? &tw0 : (si == 1 ? &tw1 : &tw2);
  const int ch0 = tile * GEMM_CH;
  const int wgs = sg.n - ch0 >= GEMM_CH ? 2 : 1;  // consumer warpgroups with channels
  const int ks0 = part * k_steps / splits, nsteps = (part + 1) * k_steps / splits - ks0;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sb = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (sb - smem_addr(smem_raw));
  const uint32_t bar_full = sb + L::BAR_OFF, bar_empty = bar_full + 8 * NS;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128 * wgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: gives its registers to the consumers; one thread issues every copy
    if constexpr (L::MOVE_REGS) setmaxnreg_producer();
    if (tid == 256) {
      int stage = 0, phase = 0;
      for (int n = 0; n < nsteps; ++n) {
        const uint32_t full = bar_full + 8 * stage, base = sb + stage * L::STAGE;
        const int k = (ks0 + n) * 64;
        mbar_wait(bar_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full, wgs * L::W_BOX + L::X_TILE);
        for (int b = 0; b < wgs; ++b) tma_load_2d(base + b * L::W_BOX, tw, full, ch0 + 128 * b, k);
        tma_load_2d(base + 2 * L::W_BOX, &tx, full, k, row0);
        if (++stage == NS) stage = 0, phase ^= 1;
      }
    }
    if (splits > 1) {  // the consumers' two (the paths do not meet again, or setmaxnreg is dropped)
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  if constexpr (L::MOVE_REGS) setmaxnreg_consumer();
  if (wg < wgs) {  // consumers: warpgroup wg owns channels [128 wg, 128 wg + 128) of the tile
    const int w = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
    // A tile i (64 channels) of this warp: rows g and g + 8 are channels
    // c = 64 i + 16 w + 2 g and c + 1 of the warpgroup's box
    float sc[2][2], sn[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[i][e] = __bfloat162float(sg.s[ch0 + 128 * wg + 64 * i + 16 * w + 2 * g + e]);
        sn[i][e] = -DEQ_BIAS * sc[i][e];
      }
    // ldmatrix rows: lane l addresses depth kr = 8 ((l / 8) % 2) + l % 8 of a
    // 16-deep step in the 16-byte chunk 4 (l / 16) + w of the box (A tile
    // l / 16), which the swizzle moves to chunk ^ (kr % 8) in every step
    const int kr = 8 * ((lane >> 3) & 1) + (lane & 7);
    const uint32_t lane_off = kr * 128 + (((4 * (lane >> 4) + w) ^ (kr & 7)) << 4);
    float acc0[R / 2], acc1[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) acc0[i] = acc1[i] = 0.f;
    // Each 16-deep step is one wgmma group; the next step is read and
    // dequantized while it runs (into the other of two fragment buffers).
    // (Dequantizing two steps ahead, with four buffers and two groups in
    // flight, was slower on the H100.)
    uint32_t a[2][2][4] = {};  // [step parity][A tile][fragment register]
    const uint32_t my_box = sb + wg * L::W_BOX + lane_off;
    int stage = 0, phase = 0;
    for (int n = 0; n < nsteps; ++n) {
      const uint32_t wbox = my_box + stage * L::STAGE;
      const uint64_t xdesc = kmajor_desc(sb + stage * L::STAGE + 2 * L::W_BOX);  // + 2 j: depth 16 j
      mbar_wait(bar_full + 8 * stage, phase);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        load_frags(wbox + 16 * 128 * j, sc, sn, a[j & 1]);
        wgmma_fence();
        WgmmaRS<R>::mma(acc0, a[j & 1][0], xdesc + 2 * j);
        WgmmaRS<R>::mma(acc1, a[j & 1][1], xdesc + 2 * j);
        wgmma_commit();
        wgmma_wait<1>();  // the step before this one has ended: its buffer and, at j = 0, its stage are free
        fence_frags(a[(j + 1) & 1]);
        if (j == 0 && n > 0) mbar_arrive(bar_empty + 8 * (stage == 0 ? NS - 1 : stage - 1));
      }
      if (++stage == NS) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_frags(a[0]);
    fence_frags(a[1]);
    fence_regs(acc0);
    fence_regs(acc1);
    if (splits == 1) {  // whole sums: straight to the output, 4 rows x 32 bytes a store instruction
      const int c = ch0 + 128 * wg + 16 * w + 2 * g;
      store_rows<R>(sg, acc0, row0, M, c, t);
      store_rows<R>(sg, acc1, row0, M, c + 64, t);
      return;
    }
    // both warpgroups are past the ring before either overwrites it
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    // the f32 partial tile of the block's rows and channels
    store_partial<R, L::P_ROW>(smem, acc0, 128 * wg + 16 * w + 2 * g, t);
    store_partial<R, L::P_ROW>(smem, acc1, 128 * wg + 64 + 16 * w + 2 * g, t);
  } else if (splits > 1) {  // the second warpgroup of a half tile: nothing to sum
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  } else {
    return;
  }

  // each block sums its rows of the K parts' partial tiles, in part order;
  // a thread takes two 4-channel chunks a pass and issues every part's load
  // of both before the first add, so the remote reads overlap
  cluster_sync();
  {
    const int r_lo = part * R / splits, r_hi = (part + 1) * R / splits;
    const int chunks = 32 * wgs;  // 4-channel chunks of the tile
    for (int i0 = tid; i0 < (r_hi - r_lo) * 64; i0 += 512) {
      float4 p[2][GEMM_MAX_SPLITS];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 256 * h, r = r_lo + i / 64;
        if (r < r_hi)
#pragma unroll
          for (int q = 0; q < GEMM_MAX_SPLITS; ++q)
            if (q < splits) p[h][q] = ld_cluster_f4(sb + r * L::P_ROW + (i % 64) * 16, q);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 256 * h, r = r_lo + i / 64, c4 = i % 64, m = row0 + r;
        if (r >= r_hi || m >= M || c4 >= chunks) continue;
        float4 v = p[h][0];
#pragma unroll
        for (int q = 1; q < GEMM_MAX_SPLITS; ++q)
          if (q < splits) {
            v.x += p[h][q].x;
            v.y += p[h][q].y;
            v.z += p[h][q].z;
            v.w += p[h][q].w;
          }
        *reinterpret_cast<uint2*>(sg.out + static_cast<long long>(m) * sg.n + ch0 + 4 * c4) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      }
    }
  }
  cluster_sync();  // no block leaves while another reads its partials
}

// --- host ----------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [outer, inner] matrix (rows `row_bytes` apart) read in boxes of
// box_inner x box_outer with the 128-byte swizzle; boxes past an edge read zeros
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, int inner, int outer,
              long long row_bytes, int box_inner, int box_outer) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ENCODE_FAILED + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + static_cast<int>(r);
}

// How a launch of M rows and depth K is cut. Every choice that orders a sum
// is a function of (M, K) alone (w8_gemm_plan returns it).
struct GemmPlan {
  int rows;    // the row width R: rows of a row group, padded to a template width
  int groups;  // row groups
  int splits;  // K parts (one cluster), each of k_steps / splits 64-deep steps, or one more
  int stages;  // ring stages
  int smem;    // dynamic shared memory of a block, bytes
};

template <int R>
GemmPlan with_rows(int groups, int splits) {
  return GemmPlan{R, groups, splits, GemmSmem<R>::NS, GemmSmem<R>::BYTES};
}

// the least power of two (<= cap, <= steps) that cuts `steps` into parts of at most `most` steps
int parts(int steps, int most, int cap) {
  int p = 1;
  while (p < cap && 2 * p <= steps && p * most < steps) p *= 2;
  return p;
}

// Row groups of at most 128 rows. Up to 64 rows a group (bytes-bound) K is cut
// into the fewest parts of at most W8_SMALL_PART_STEPS steps, up to 8: more
// blocks stream the weights. Wider groups (operation-bound) take
// W8_WIDE_PARTS parts, or one part, with groups of at most W8_ONE_PART_ROWS
// rows, when K has fewer than W8_ONE_PART_STEPS steps: a part's partials cost
// a cluster epilogue, worth it only for a long K. Parts are a power of two:
// clusters of 1, 2, 4 or 8 blocks pack the GPCs' SMs.
GemmPlan gemm_plan(int M, int K) {
  const int steps = K / BK;
  int groups = (M + GEMM_MAX_ROWS - 1) / GEMM_MAX_ROWS;
  int per = (M + groups - 1) / groups, splits;
  if (per <= 64) {
    splits = parts(steps, W8_SMALL_PART_STEPS, GEMM_MAX_SPLITS);
  } else if (steps >= W8_ONE_PART_STEPS) {
    splits = parts(steps, 1, W8_WIDE_PARTS);
  } else {
    splits = 1;
    groups = (M + W8_ONE_PART_ROWS - 1) / W8_ONE_PART_ROWS;
    per = (M + groups - 1) / groups;
  }
  if (per <= 8) return with_rows<8>(groups, splits);
  if (per <= 16) return with_rows<16>(groups, splits);
  if (per <= 32) return with_rows<32>(groups, splits);
  if (per <= 64) return with_rows<64>(groups, splits);
  if (per <= 80) return with_rows<80>(groups, splits);
  if (per <= 96) return with_rows<96>(groups, splits);
  return with_rows<128>(groups, splits);
}

// Lets w8_gemm_kernel<R> take its shared memory, once for each device (a bit
// of `allowed` each; devices past 63 ask on every launch).
template <int R>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit != 0 && (allowed.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(w8_gemm_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, GemmSmem<R>::BYTES);
  if (e == cudaSuccess) allowed.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <int R>
int launch_gemm(const CUtensorMap& tx, const CUtensorMap (&tw)[3], const GemmSegs& segs, int M, int K,
                const GemmPlan& p, int tiles, cudaStream_t stream) {
  const cudaError_t attr = allow_smem<R>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.groups, tiles);
  cfg.blockDim = dim3(GEMM_THREADS);
  cfg.dynamicSmemBytes = GemmSmem<R>::BYTES;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, w8_gemm_kernel<R>, tx, tw[0], tw[1], tw[2], segs, M, K / BK);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// out_j [M, n_j] = a [M, K] @ deq(w_j [K, n_j], s_j [n_j]) for j < nseg (1..3),
// one launch. Each w_j/s_j points at the layer's weight and scales. Returns
// 0, a cudaError_t, or 10000 + the CUresult of a tensor map it could not encode.
extern "C" int w8_gemm(const void* a, int M, int K,
                       const void* w0, const void* s0, void* o0, int n0,
                       const void* w1, const void* s1, void* o1, int n1,
                       const void* w2, const void* s2, void* o2, int n2,
                       int nseg, void* stream) {
  if (M <= 0 || K <= 0 || K % BK != 0 || nseg < 1 || nseg > 3) return static_cast<int>(cudaErrorInvalidValue);
  const GemmPlan p = gemm_plan(M, K);
  CUtensorMap tx, tw[3];
  int rc = encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, K, M, 2LL * K, BK, p.rows);
  if (rc != 0) return rc;
  const void* ws[3] = {w0, w1, w2};
  const void* ss[3] = {s0, s1, s2};
  void* os[3] = {o0, o1, o2};
  const int ns[3] = {n0, n1, n2};
  GemmSegs segs{};
  int tiles = 0;
  for (int j = 0; j < nseg; ++j) {
    if (ns[j] <= 0 || ns[j] % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if ((rc = encode_2d(&tw[j], CU_TENSOR_MAP_DATA_TYPE_UINT8, ws[j], ns[j], K, ns[j], 128, BK)) != 0) return rc;
    segs.seg[j] = GemmSeg{static_cast<const __nv_bfloat16*>(ss[j]), static_cast<__nv_bfloat16*>(os[j]), ns[j],
                          (ns[j] + GEMM_CH - 1) / GEMM_CH};
    tiles += segs.seg[j].tiles;
  }
  for (int j = nseg; j < 3; ++j) tw[j] = tw[0];  // never read
  segs.count = nseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.rows) {
    case 8: return launch_gemm<8>(tx, tw, segs, M, K, p, tiles, st);
    case 16: return launch_gemm<16>(tx, tw, segs, M, K, p, tiles, st);
    case 32: return launch_gemm<32>(tx, tw, segs, M, K, p, tiles, st);
    case 64: return launch_gemm<64>(tx, tw, segs, M, K, p, tiles, st);
    case 80: return launch_gemm<80>(tx, tw, segs, M, K, p, tiles, st);
    case 96: return launch_gemm<96>(tx, tw, segs, M, K, p, tiles, st);
    default: return launch_gemm<128>(tx, tw, segs, M, K, p, tiles, st);
  }
}

// plan[0..4] = the row width, row groups, K parts, ring stages and shared
// memory bytes of a w8_gemm launch of M rows and depth K
extern "C" int w8_gemm_plan(int M, int K, int* plan) {
  if (M <= 0 || K <= 0 || K % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const GemmPlan p = gemm_plan(M, K);
  plan[0] = p.rows;
  plan[1] = p.groups;
  plan[2] = p.splits;
  plan[3] = p.stages;
  plan[4] = p.smem;
  return 0;
}

// out [M, F] = bf16(silu(bf16(x @ deq(gate)))) * bf16(x @ deq(up)), rounded to bf16
extern "C" int w8_swiglu(const void* x, int M, int K, const void* wg, const void* sg,
                         const void* wu, const void* su, void* out, int F, void* stream) {
  if (M <= 0 || K <= 0 || K % BK != 0 || F <= 0 || F % SW_BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, F / SW_BN);
  w8_swiglu_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), M, K, static_cast<const int8_t*>(wg),
      static_cast<const __nv_bfloat16*>(sg), static_cast<const int8_t*>(wu),
      static_cast<const __nv_bfloat16*>(su), static_cast<__nv_bfloat16*>(out), F);
  return static_cast<int>(cudaGetLastError());
}

// tok [M], maxv [M] = argmax / max over v of (x [M, K] . bf16(w [v, :])) * s[v];
// pval/pidx are scratch of M * (V / 128) elements.
extern "C" int head_argmax(const void* x, int M, int K, const void* w, const void* s, int V,
                           void* pval, void* pidx, void* tok, void* maxv, void* stream) {
  if (M <= 0 || K <= 0 || K % BK != 0 || V <= 0 || V % HEAD_BV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = V / HEAD_BV;
  head_tile_kernel<<<dim3((M + BM - 1) / BM, n_tiles), THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), M, K, static_cast<const int8_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<float*>(pval), static_cast<int*>(pidx), n_tiles);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  head_reduce_kernel<<<(M + 7) / 8, 256, 0, st>>>(static_cast<const float*>(pval), static_cast<const int*>(pidx), M,
                                                  n_tiles, static_cast<int*>(tok), static_cast<float*>(maxv));
  return static_cast<int>(cudaGetLastError());
}
