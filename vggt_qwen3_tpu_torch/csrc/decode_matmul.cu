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
// What bounds them on the H100: operations. At the decode bench shape (368
// rows) every weight byte feeds 2 * 368 = 736 flops, above the card's ~295
// flops/byte ridge for bf16; the head alone is 286 GFLOP a step.
//
// Design: one tile shape for the GEMMs, 64 rows x BN columns x 64 deep, 4
// warps in a 2 x 2 grid, mma.sync m16n8k16 bf16 -> f32 (the fragment code of
// flash_fwd.cu, with ldmatrix). Per 64-deep step a thread loads its 16-byte
// chunks of the A tile and of the int8 W tile into registers for the next
// step while the tensor cores work on the current one; W is dequantized with
// its scales on the way into shared memory, where it sits as bf16 [k][n]
// (N-contiguous, read with ldmatrix.trans). Blocks walk M fastest, so the
// (at most six) blocks that read one weight tile run side by side and share
// it through L2. The layer of a stacked [L, K, N] weight is picked by the
// wrapper's pointer offset, and every element offset is 64-bit. The ragged M
// edge (368 = 5.75 x 64, or 8 rows) is masked here. K must be a multiple of
// 64 and every N a multiple of BN; the wrappers raise otherwise.
// - w8_gemm walks the concatenated N tiles of up to three weights (wq|wk|wv
//   for QKV), each block writing its own output.
// - w8_swiglu reads each A tile once for both gate and up (BN = 64 each) and
//   writes the activation a [M, F] bf16; down is then a plain w8_gemm. On the
//   TPU `a` never left VMEM; here it makes a round trip through L2/HBM
//   (7.2 MB at 368 rows), kept because splitting F with float atomics would
//   make the sums' order, and so the tokens, change from run to run.
// - head_argmax: blocks over (64-row tiles, 128-row vocab tiles); W [V, H] is
//   H-contiguous, the layout mma's B operand takes without a transpose. Each
//   block scales its logits in f32 and reduces each row to (max, lowest
//   index), written to partials [M, V/128]; a second launch reduces each
//   row's partials, one warp per row, by (greater value, or equal value and
//   lower index), which is what a scan in vocab order with a strict `>` and
//   argmax over the whole row give. No atomics; the [M, V] f32 logits never
//   reach device memory.
// This first version is simple and right: no wgmma, no TMA, no cp.async ring
// (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // rows of a block tile
constexpr int BK = 64;       // depth of a k-step
constexpr int THREADS = 128; // 4 warps, 2 x 2
constexpr int PAD = 8;       // bf16 row padding of the shared tiles (bank conflicts)
constexpr int HEAD_BV = 128; // vocab rows of a head tile

struct Seg {
  const int8_t* w;            // layer li of the stacked weight: [K, n]
  const __nv_bfloat16* s;     // its scales: [n]
  __nv_bfloat16* out;         // [M, n]
  int n;
  int tiles;                  // n / BN
};

struct Segs {
  Seg seg[3];
  int count;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

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

// ---- w8_gemm: out_seg = A @ deq(W_seg) over up to three segments ----

template <int BN>
__global__ void __launch_bounds__(THREADS) w8_gemm_kernel(const __nv_bfloat16* __restrict__ A, int M, int K,
                                                           Segs segs) {
  constexpr int NT = BN / 16;  // n8 tiles of a warp (its BN/2 columns)
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];
  __shared__ __align__(16) __nv_bfloat16 Bs[BK][BN + PAD];

  int tile = blockIdx.y;
  int si = 0;
  if (segs.count > 1 && tile >= segs.seg[0].tiles) {
    tile -= segs.seg[0].tiles;
    si = 1;
    if (segs.count > 2 && tile >= segs.seg[1].tiles) {
      tile -= segs.seg[1].tiles;
      si = 2;
    }
  }
  const Seg sg = si == 0 ? segs.seg[0] : (si == 1 ? segs.seg[1] : segs.seg[2]);
  const int m0 = blockIdx.x * BM, n0 = tile * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;

  float sc[16];
  load_scales<BN>(sg.s, n0, sc);
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  uint4 ra[4], rw[BN / 32];
  load_a(A, M, K, m0, 0, ra);
  load_w<BN>(sg.w, sg.n, 0, n0, rw);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_a(As, ra);
    store_w<BN>(Bs, rw, sc);
    __syncthreads();
    if (k0 + BK < K) {  // next step's loads are in flight during the mma
      load_a(A, M, K, m0, k0 + BK, ra);
      load_w<BN>(sg.w, sg.n, k0 + BK, n0, rw);
    }
    warp_mma_kn<BN>(As, Bs, acc, wm, wn, lane);
    __syncthreads();
  }

  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row = m0 + wm * 32 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * (BN / 2) + nt * 8 + tig * 2;
      if (row < M)
        *reinterpret_cast<uint32_t*>(sg.out + static_cast<long long>(row) * sg.n + col) =
            pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      if (row + 8 < M)
        *reinterpret_cast<uint32_t*>(sg.out + static_cast<long long>(row + 8) * sg.n + col) =
            pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
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

constexpr int GEMM_BN = 128;

}  // namespace

// out_j [M, n_j] = a [M, K] @ deq(w_j [K, n_j], s_j [n_j]) for j < nseg (1..3),
// one launch. Each w_j/s_j points at the layer's weight and scales.
extern "C" int w8_gemm(const void* a, int M, int K,
                       const void* w0, const void* s0, void* o0, int n0,
                       const void* w1, const void* s1, void* o1, int n1,
                       const void* w2, const void* s2, void* o2, int n2,
                       int nseg, void* stream) {
  if (M <= 0 || K <= 0 || K % BK != 0 || nseg < 1 || nseg > 3) return static_cast<int>(cudaErrorInvalidValue);
  Segs segs{};
  const void* ws[3] = {w0, w1, w2};
  const void* ss[3] = {s0, s1, s2};
  void* os[3] = {o0, o1, o2};
  const int ns[3] = {n0, n1, n2};
  int tiles = 0;
  for (int j = 0; j < nseg; ++j) {
    if (ns[j] <= 0 || ns[j] % GEMM_BN != 0) return static_cast<int>(cudaErrorInvalidValue);
    segs.seg[j] = Seg{static_cast<const int8_t*>(ws[j]), static_cast<const __nv_bfloat16*>(ss[j]),
                      static_cast<__nv_bfloat16*>(os[j]), ns[j], ns[j] / GEMM_BN};
    tiles += ns[j] / GEMM_BN;
  }
  segs.count = nseg;
  const dim3 grid((M + BM - 1) / BM, tiles);
  w8_gemm_kernel<GEMM_BN><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), M, K, segs);
  return static_cast<int>(cudaGetLastError());
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
