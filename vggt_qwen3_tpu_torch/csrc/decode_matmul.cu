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
// All three are one design, swap-AB wgmma fed by TMA: outT = deq(W)T . xT, so
// that 64 weight rows (output channels, or vocab rows for the head) are
// wgmma's M and the activation rows its N (a template width of 8 to 128
// rows, and 184 for the head; the rows past M read TMA's zero fill and are
// never stored). A block is two consumer warpgroups and a producer warpgroup
// (which gives the consumers its registers where they need them: setmaxnreg
// 24 / 240); each consumer warpgroup holds two m64 accumulator tiles that
// share the x operand.
//  - the producer keeps TMA loads of two int8 weight boxes (8 KB each) and the
//    bf16 x tile (rows x 64-deep, K-major, 128-byte swizzle) in flight through
//    a ring of up to 8 stages with full/empty mbarriers. A layer weight of
//    layer li is a 2-D tensor map {N, K} encoded at the layer's base (pointer
//    offset).
//  - the consumers build wgmma's register A fragments from the int8 boxes
//    (the int8 tile never exists as bf16 in shared memory) and take x as B
//    from shared memory. Each 16-deep step is committed as one wgmma group; the
//    next step's fragments are built while it runs (wgmma.wait_group 1).
//  - w8_swiglu with one K part and head_argmax are persistent: one block an SM
//    walks the launch's items (row group, tile; the groups of a tile one
//    after another, so that they read its weights from HBM once while the
//    others find them in L2), its producer streaming the next item's boxes
//    while the consumers finish the last (on an H100 at 368 rows: gate/up
//    -3 %, the head -7 %, against a block an item; PERF.md, section 6).
// Measured on the H100 and left out: sharing boxes across a cluster by TMA
// multicast (the x tile of neighbouring tiles, or a tile's weight boxes across
// its row groups; slower in every shape tried), and building fragments two
// steps ahead with two wgmma groups in flight (no faster).
//
// What bounds them on the H100: operations at the decode bench shape (368
// rows: every weight byte feeds 2 * 368 = 736 flops, above the card's ~295
// flops/byte ridge for bf16), bytes at a few rows (8 rows: 16 flops a weight
// byte; the int8 weights are the traffic).
//
// w8_gemm (QKV, WO, the MLP's down projection) owns 256 channels a block (128
// a warpgroup) of one segment, one group of rows and one part of K:
//  - the weight [K, N] is N-contiguous: a box is 128 channels x 64 deep
//    (128-byte swizzle), read with ldmatrix.trans (the b16 elements are channel
//    pairs, so a register holds two channels at two depths) and dequantized
//    straight into A fragments: A row g is channel 2g and row g + 8 channel
//    2g + 1 of a warp's 16, the bytes become f32 by a byte permute onto 2^23
//    and one FMA with the scale (exact: the result is float(w8) * scale), and
//    cvt.rn.bf16x2 rounds once. Up to three segments (wq|wk|wv) share one
//    launch, a block's tile in one of them.
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
// the cut of a launch. A launch encodes its tensor maps on the host; a
// kernel's shared-memory attribute is set once a device.
//
// w8_swiglu (the MLP's gate/up) is w8_gemm over the gate and the up weight at
// once: an item is 128 channels, each consumer warpgroup the same 64 channels
// of gate (its first accumulator tile) and of up (its second); a stage holds
// the gate box and the up box of the item's channels. The cut is
// gemm_plan(M, K), so g and u have the summation order of a w8_gemm launch
// over that weight alone, bit for bit; with one K part the epilogue forms
// a = bf16(bf16(silu(bf16 g)) * bf16 u) in registers, otherwise the K parts
// of an item form a cluster that sums g and u in part order first. The
// activation a [M, F] then feeds the down w8_gemm: on the TPU `a` never left
// VMEM; here it makes a round trip through L2/HBM (7.2 MB at 368 rows, ~4 us
// at 3.35 TB/s), kept because cutting F across blocks of the down projection
// would need float atomics, and so sums in an order that changes from run to
// run. F must be a multiple of 128.
//
// head_argmax (the LM head with its greedy argmax): the table w8 [V, H] is
// H-contiguous (K-major), so a box is 128 vocab rows x 64 deep (64-byte rows,
// 64-byte swizzle) and ldmatrix (not .trans) gives a thread 4 consecutive
// depths 4t..4t+3 of a vocab row, where an A fragment wants depths 2t, 2t + 1
// and 2t + 8, 2t + 9. Two shuffles inside each quad regroup the bytes (each
// thread sends one half of its rows g and g + 8 to each of two partners) and
// the int8 values become bf16 exactly (no scale before the dot). An item is
// 256 vocab rows (151936 = 593 * 256 + 128: the last tile's second box lies
// past V, read as zeros and never reduced) and one group of at most
// HEAD_MAX_ROWS rows, all of K: at 368 rows two groups of 184, wgmma n184,
// which ran 0.43 ms on an H100 against 0.53 for three groups of 128 (less padding, the
// table read twice, not three times, and more products behind each fragment
// built). The epilogue scales the f32 logits, reduces each row to (max,
// lowest index) over the item's vocab rows (within a thread, across the
// quad's rows by shuffles, across the warps in shared memory of its own, as
// the ring is already filling with the next item) and writes the partial to
// [M, ceil(V / 256)]; a second launch reduces each row's partials, one warp a
// row. "Greater value, or equal value at a lower index" is a total order
// (-0.0 and +0.0 are equal, as in torch.argmax), so the result is the same
// whatever the order of reduction; the [M, V] f32 logits never reach device
// memory.

#include "hopper.cuh"

#include <limits.h>
#include <math.h>

#include <atomic>
#include <type_traits>

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
#ifndef HEAD_MAX_ROWS
#define HEAD_MAX_ROWS 184        // head_argmax: rows of a row group at most (above 128: a group of 184)
#endif

namespace {

constexpr int BK = 64;               // depth of a ring stage
constexpr int GEMM_THREADS = 384;    // consumer warpgroups 0 and 1, then the producer's
constexpr int GEMM_CH = 256;         // w8_gemm: output channels of a block, 128 a consumer warpgroup
constexpr int SWIGLU_CH = 128;       // w8_swiglu: channels of an item (gate and up), 64 a warpgroup
constexpr int HEAD_TILE = 256;       // head_argmax: vocab rows of an item, 128 a warpgroup
constexpr int GEMM_MAX_ROWS = 128;   // rows of a w8_gemm / w8_swiglu row group at most
constexpr int GEMM_MAX_SPLITS = 8;   // K parts at most: the portable cluster size
constexpr float DEQ_BIAS = 8388736.f;  // 2^23 + 128
constexpr unsigned FULL_MASK = 0xffffffffu;

static_assert(HEAD_MAX_ROWS >= 8 && HEAD_MAX_ROWS <= 184, "HEAD_MAX_ROWS: 8..184");

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ void ldsm_x4_at(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans_at(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// --- TMA and clusters -----------------------------------------------------------

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

// the two consumer warpgroups (named barrier 1; the producer never takes it)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// --- wgmma -------------------------------------------------------------------

// Keep the compiler from moving reads or writes of the A fragments a running
// wgmma reads across the asynchronous region, and from giving their registers
// to other values before it ends (fence_regs does the same for accumulators).
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
#define W8_R92 W8_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
                      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91"
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
W8_WGMMA_RS(184, W8_R92, "%92, %93, %94, %95", "%96", "%97", W8_D32(0), W8_D32(32), W8_D16(64), W8_D8(80), W8_D4(88))
#undef W8_WGMMA_RS

// --- A fragments from an N-contiguous int8 box (w8_gemm, w8_swiglu) ------------

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
// ldmatrix.x4.trans at this lane's address (tile 0 depths 0-7, 8-15, then
// tile 1's), dequantized with the thread's channels' scales
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

// The lane's ldmatrix.trans address in a 128-channel x 64-deep box (128-byte
// swizzle) for the channels of 16-byte chunk `chunk` at step 0 (+ 16 * 128 j
// for step j): lane l addresses depth kr = 8 ((l / 8) % 2) + l % 8, which the
// swizzle moves to chunk ^ (kr % 8)
__device__ __forceinline__ uint32_t trans_lane_off(int lane, int chunk) {
  const int kr = 8 * ((lane >> 3) & 1) + (lane & 7);
  return kr * 128 + ((chunk ^ (kr & 7)) << 4);
}

// The thread's scales for its A rows: tile i's rows g and g + 8 are channels
// c_i and c_i + 1 (sc) and -(2^23 + 128) times them (sn)
__device__ __forceinline__ void load_scales(const __nv_bfloat16* s0, const __nv_bfloat16* s1, float (&sc)[2][2],
                                            float (&sn)[2][2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    sc[0][e] = __bfloat162float(s0[e]);
    sc[1][e] = __bfloat162float(s1[e]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) sn[i][e] = -DEQ_BIAS * sc[i][e];
}

// --- A fragments from a K-major int8 box (head_argmax) ------------------------

// two int8 bytes (byte selectors s0, s1 of u, already ^ 0x80) as an exact bf16 pair
__device__ __forceinline__ uint32_t widen(uint32_t u, uint32_t s0, uint32_t s1) {
  return pack_bf16(__uint_as_float(__byte_perm(u, 0x4B000000u, s0)) - DEQ_BIAS,
                   __uint_as_float(__byte_perm(u, 0x4B000000u, s1)) - DEQ_BIAS);
}

// Per-lane constants of the quad exchange. After ldmatrix a thread t of a
// quad holds depths 4t..4t+3 of A rows g and g + 8; it needs 2t, 2t + 1
// ("lo", held by quad lane t / 2) and 2t + 8, 2t + 9 ("hi", quad lane
// 2 + t / 2), each half (t % 2) of the holder's register. Each thread packs
// one half of both rows' registers as P_lo (bytes 0, 1) or P_hi (2, 3):
// shuffle 1 sends (t < 2 ? P_lo : P_hi) and reads quad lane [0, 2, 1, 3][t],
// shuffle 2 sends the other and reads [2, 0, 3, 1][t]; an even t then has
// lo from shuffle 1 and hi from shuffle 2, an odd t the other way round.
struct Quad {
  uint32_t sel1, sel2;  // byte selectors of the two values sent
  int src1, src2;       // lanes read
  bool odd;
  __device__ __forceinline__ explicit Quad(int lane) {
    const int t = lane & 3;
    sel1 = t < 2 ? 0x5410u : 0x7632u;
    sel2 = t < 2 ? 0x7632u : 0x5410u;
    src1 = (lane & ~3) | ((t & 1) << 1) | (t >> 1);
    src2 = src1 ^ 2;
    odd = t & 1;
  }
};

// A 16-deep step's A fragments of both tiles: one ldmatrix.x4 at this lane's
// row address (tile 0 rows 0-7, 8-15, tile 1 rows 0-7, 8-15 of the warp's),
// regrouped across the quad and widened to bf16 (exact; no scale)
__device__ __forceinline__ void load_frags_kmajor(uint32_t addr, const Quad& q, uint32_t (&f)[2][4]) {
  uint32_t r[4];
  ldsm_x4_at(r, addr);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t r0 = r[2 * i] ^ 0x80808080u, r1 = r[2 * i + 1] ^ 0x80808080u;
    const uint32_t u1 = __shfl_sync(FULL_MASK, __byte_perm(r0, r1, q.sel1), q.src1);
    const uint32_t u2 = __shfl_sync(FULL_MASK, __byte_perm(r0, r1, q.sel2), q.src2);
    const uint32_t lo = q.odd ? u2 : u1, hi = q.odd ? u1 : u2;  // bytes: row g (0, 1), row g + 8 (2, 3)
    f[i][0] = widen(lo, 0x7650, 0x7651);
    f[i][1] = widen(lo, 0x7652, 0x7653);
    f[i][2] = widen(hi, 0x7650, 0x7651);
    f[i][3] = widen(hi, 0x7652, 0x7653);
  }
}

// --- the ring ------------------------------------------------------------------

// Shared memory of a block with R rows: NS ring stages (two int8 weight
// boxes of 8 KB, then the bf16 x tile of R rows x 64 deep, each 1024-byte
// aligned), then EXTRA bytes (the head's per-warp maxima), the ring reused
// after the main loop for the f32 partial tile [R][256] (rows padded by 16
// bytes) of a K part; then the full and empty barriers.
template <int R_, int EXTRA = 0>
struct GemmSmem {
  static constexpr int R = R_;
  static constexpr int W_BOX = 64 * 128;
  static constexpr int X_TILE = R * 128;
  static constexpr int STAGE = 2 * W_BOX + X_TILE;
  // up to 32 rows a ring small enough for two or three blocks an SM
  static constexpr int RING_KB = R <= 32 ? 72 : 200;
  static constexpr int NS = RING_KB * 1024 / STAGE < 8 ? RING_KB * 1024 / STAGE : 8;
  static constexpr int P_ROW = GEMM_CH * 4 + 16;
  static constexpr int RING = NS * STAGE;
  static constexpr int EXTRA_OFF = RING;
  static constexpr int BAR_OFF = RING + EXTRA > R * P_ROW ? RING + EXTRA : R * P_ROW;
  static constexpr int BYTES = BAR_OFF + 2 * NS * 8 + 1024;  // + slack for the 1024-byte alignment
  // rows above 80 take 240 registers a consumer thread (in 168, ptxas spills
  // at 96 rows and serializes the wgmmas at 128; above 32 rows the ring keeps
  // one block an SM anyway); narrower ones fit in 168, and blocks of up to 32
  // rows fit two or three an SM
  static constexpr bool MOVE_REGS = R > 80;
  static_assert(BYTES <= 232448, "more shared memory than a block can have");
};

// The block's 1024-byte aligned shared memory; thread 0 sets up the ring's
// barriers (the empty ones wait for `consumers` arrivals)
template <typename L>
__device__ __forceinline__ uint32_t ring_setup(unsigned char* smem_raw, int consumers, unsigned char*& smem) {
  const uint32_t sb = (smem_u32(smem_raw) + 1023) & ~1023u;
  smem = smem_raw + (sb - smem_u32(smem_raw));
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::NS; ++s) {
      mbar_init(sb + L::BAR_OFF + 8 * s, 1);
      mbar_init(sb + L::BAR_OFF + 8 * (L::NS + s), consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return sb;
}

// The producer's one thread: `nsteps` stages from (stage, phase) on, each
// `bytes` of boxes that load(stage base, full barrier, step) asks for
template <typename L, typename Load>
__device__ __forceinline__ void produce(uint32_t sb, int nsteps, int bytes, int& stage, int& phase, Load load) {
  const uint32_t bar_full = sb + L::BAR_OFF, bar_empty = bar_full + 8 * L::NS;
  for (int n = 0; n < nsteps; ++n) {
    const uint32_t full = bar_full + 8 * stage;
    mbar_wait(bar_empty + 8 * stage, phase ^ 1);
    mbar_expect_tx(full, bytes);
    load(sb + stage * L::STAGE, full, n);
    if (++stage == L::NS) stage = 0, phase ^= 1;
  }
}

// A consumer warpgroup's main loop over `nsteps` stages from (stage, phase)
// on: frags(stage base, j, fragments) builds step j's A fragments of both
// tiles, which multiply the x tile into acc0 and acc1. Each 16-deep step is
// one wgmma group; the next step's fragments are built while it runs, into
// the other of two buffers. (Building two steps ahead, with four buffers and
// two groups in flight, was slower on the H100 for w8_gemm and no faster for
// the head and gate/up.) A stage is released (each thread arrives on its
// empty barrier) once its last step has ended.
template <typename L, typename Frags>
__device__ __forceinline__ void mma_loop(uint32_t sb, int nsteps, float (&acc0)[L::R / 2], float (&acc1)[L::R / 2],
                                         int& stage, int& phase, Frags frags) {
  constexpr int R = L::R;
  const uint32_t bar_full = sb + L::BAR_OFF, bar_empty = bar_full + 8 * L::NS;
#pragma unroll
  for (int i = 0; i < R / 2; ++i) acc0[i] = acc1[i] = 0.f;
  uint32_t a[2][2][4] = {};  // [step parity][A tile][fragment register]
  for (int n = 0; n < nsteps; ++n) {
    const uint32_t base = sb + stage * L::STAGE;
    const uint64_t xdesc = desc(base + 2 * L::W_BOX, 16);  // K-major; + 2 j: depth 16 j
    mbar_wait(bar_full + 8 * stage, phase);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      frags(base, j, a[j & 1]);
      wgmma_fence();
      WgmmaRS<R>::mma(acc0, a[j & 1][0], xdesc + 2 * j);
      WgmmaRS<R>::mma(acc1, a[j & 1][1], xdesc + 2 * j);
      wgmma_commit();
      wgmma_wait<1>();  // the step before this one has ended: its buffer and, at j = 0, its stage are free
      fence_frags(a[(j + 1) & 1]);
      if (j == 0 && n > 0) mbar_arrive(bar_empty + 8 * (stage == 0 ? L::NS - 1 : stage - 1));
    }
    if (++stage == L::NS) stage = 0, phase ^= 1;
  }
  wgmma_wait<0>();
  fence_frags(a[0]);
  fence_frags(a[1]);
  fence_regs(acc0);
  fence_regs(acc1);
  mbar_arrive(bar_empty + 8 * (stage == 0 ? L::NS - 1 : stage - 1));  // the last stage
}

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

// ===========================================================================
// w8_gemm
// ===========================================================================

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
  unsigned char* smem;
  const uint32_t sb = ring_setup<L>(smem_raw, 128 * wgs, smem);

  if (wg == 2) {  // producer: gives its registers to the consumers; one thread issues every copy
    if constexpr (L::MOVE_REGS) setmaxnreg_producer();
    int stage = 0, phase = 0;
    if (tid == 256)
      produce<L>(sb, nsteps, wgs * L::W_BOX + L::X_TILE, stage, phase, [&](uint32_t base, uint32_t full, int n) {
        const int k = (ks0 + n) * BK;
        for (int b = 0; b < wgs; ++b) tma_load_2d(base + b * L::W_BOX, tw, full, ch0 + 128 * b, k);
        tma_load_2d(base + 2 * L::W_BOX, &tx, full, k, row0);
      });
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
    // c = 64 i + 16 w + 2 g and c + 1 of the warpgroup's box, its 16-byte
    // chunk 4 i + w (lanes 16 i..16 i + 15 address tile i)
    const int c = ch0 + 128 * wg + 16 * w + 2 * g;
    float sc[2][2], sn[2][2];
    load_scales(sg.s + c, sg.s + c + 64, sc, sn);
    const uint32_t lane_off = wg * L::W_BOX + trans_lane_off(lane, 4 * (lane >> 4) + w);
    float acc0[R / 2], acc1[R / 2];
    int stage = 0, phase = 0;
    mma_loop<L>(sb, nsteps, acc0, acc1, stage, phase, [&](uint32_t base, int j, uint32_t (&f)[2][4]) {
      load_frags(base + lane_off + 16 * 128 * j, sc, sn, f);
    });
    if (splits == 1) {  // whole sums: straight to the output, 4 rows x 32 bytes a store instruction
      store_rows<R>(sg, acc0, row0, M, c, t);
      store_rows<R>(sg, acc1, row0, M, c + 64, t);
      return;
    }
    // both warpgroups are past the ring before either overwrites it
    consumers_sync();
    // the f32 partial tile of the block's rows and channels
    store_partial<R, L::P_ROW>(smem, acc0, 128 * wg + 16 * w + 2 * g, t);
    store_partial<R, L::P_ROW>(smem, acc1, 128 * wg + 64 + 16 * w + 2 * g, t);
  } else if (splits > 1) {  // the second warpgroup of a half tile: nothing to sum
    consumers_sync();
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

// ===========================================================================
// w8_swiglu: a = bf16(bf16(silu(bf16(x@deq(gate)))) * bf16(x@deq(up)))
// ===========================================================================

// the activation of one channel from its f32 gate and up sums
__device__ __forceinline__ float swiglu(float g, float u) {
  const float gv = bf16_round(g), uv = bf16_round(u);
  return bf16_round(gv / (1.f + expf(-gv))) * uv;
}

struct SwigluArgs {
  const __nv_bfloat16* sg;  // the layer's gate and up scales [F]
  const __nv_bfloat16* su;
  __nv_bfloat16* out;       // a [M, F]
  int F;                    // a multiple of 128
};

template <int R>
__global__ void __launch_bounds__(GEMM_THREADS, 1) w8_swiglu_kernel(
    __grid_constant__ const CUtensorMap tx, __grid_constant__ const CUtensorMap tg,
    __grid_constant__ const CUtensorMap tu, const SwigluArgs args, int M, int k_steps, int groups) {
  using L = GemmSmem<R>;
  // from 64 rows on, the persistent loop needs the producer's registers (in
  // 168 it spills); the ring keeps one block an SM there anyway
  constexpr bool move_regs = R > 32;
  const int tid = threadIdx.x, wg = tid / 128;
  const int splits = gridDim.x, part = static_cast<int>(cluster_rank());
  // item i: row group i % groups of channel tile i / groups. One K part: the
  // grid is (1, blocks) and a block walks the items; K parts: the grid is
  // (parts, groups, tiles), a cluster an item
  const int items = groups * (args.F / SWIGLU_CH);
  const int first = splits == 1 ? blockIdx.y : blockIdx.z * groups + blockIdx.y;
  const int stride = splits == 1 ? gridDim.y : items;
  const int ks0 = part * k_steps / splits, nsteps = (part + 1) * k_steps / splits - ks0;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t sb = ring_setup<L>(smem_raw, 256, smem);

  if (wg == 2) {  // producer: the gate box, the up box of the same channels, the x tile
    if constexpr (move_regs) setmaxnreg_producer();
    if (tid == 256) {
      int stage = 0, phase = 0;
      for (int item = first; item < items; item += stride) {
        const int row0 = item % groups * R, ch0 = item / groups * SWIGLU_CH;
        produce<L>(sb, nsteps, 2 * L::W_BOX + L::X_TILE, stage, phase, [&](uint32_t base, uint32_t full, int n) {
          const int k = (ks0 + n) * BK;
          tma_load_2d(base, &tg, full, ch0, k);
          tma_load_2d(base + L::W_BOX, &tu, full, ch0, k);
          tma_load_2d(base + 2 * L::W_BOX, &tx, full, k, row0);
        });
      }
    }
    if (splits > 1) {  // the consumers' two (the paths do not meet again, or setmaxnreg is dropped)
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  if constexpr (move_regs) setmaxnreg_consumer();
  // warpgroup wg owns channels [64 wg, 64 wg + 64) of the item's 128 in both
  // boxes: A tile 0 is gate, tile 1 up; rows g and g + 8 of warp w are
  // channels c = 64 wg + 16 w + 2 g and c + 1 (16-byte chunk 4 wg + w of
  // each box; lanes 16 i..16 i + 15 address box i)
  const int w = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int cl = 64 * wg + 16 * w + 2 * g;
  const uint32_t lane_off = (lane >> 4) * L::W_BOX + trans_lane_off(lane, 4 * wg + w);
  int stage = 0, phase = 0;
  for (int item = first; item < items; item += stride) {
    const int row0 = item % groups * R, ch0 = item / groups * SWIGLU_CH, c = ch0 + cl;
    float sc[2][2], sn[2][2];
    load_scales(args.sg + c, args.su + c, sc, sn);
    float acc0[R / 2], acc1[R / 2];
    mma_loop<L>(sb, nsteps, acc0, acc1, stage, phase, [&](uint32_t base, int j, uint32_t (&f)[2][4]) {
      load_frags(base + lane_off + 16 * 128 * j, sc, sn, f);
    });
    if (splits == 1) {  // acc0 and acc1 hold g and u of the same (row, channel): a from registers
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = row0 + 8 * j + 2 * t + e;
          if (row < M)
            *reinterpret_cast<uint32_t*>(args.out + static_cast<long long>(row) * args.F + c) = pack_bf16(
                swiglu(acc0[4 * j + e], acc1[4 * j + e]), swiglu(acc0[4 * j + 2 + e], acc1[4 * j + 2 + e]));
        }
      continue;
    }
    consumers_sync();  // both warpgroups are past the ring
    // the f32 partial tile: gate at columns [0, 128), up at [128, 256)
    store_partial<R, L::P_ROW>(smem, acc0, cl, t);
    store_partial<R, L::P_ROW>(smem, acc1, 128 + cl, t);

    // each block sums its rows of the parts' gate and up partials in part
    // order (the order of a w8_gemm launch over either weight) and writes a
    cluster_sync();
    const int r_lo = part * R / splits, r_hi = (part + 1) * R / splits;
    for (int i = tid; i < (r_hi - r_lo) * 32; i += 256) {
      const int r = r_lo + i / 32, c4 = i % 32, m = row0 + r;
      float4 pg[GEMM_MAX_SPLITS], pu[GEMM_MAX_SPLITS];
#pragma unroll
      for (int q = 0; q < GEMM_MAX_SPLITS; ++q)
        if (q < splits) {
          pg[q] = ld_cluster_f4(sb + r * L::P_ROW + c4 * 16, q);
          pu[q] = ld_cluster_f4(sb + r * L::P_ROW + 512 + c4 * 16, q);
        }
      if (m >= M) continue;
      float4 vg = pg[0], vu = pu[0];
#pragma unroll
      for (int q = 1; q < GEMM_MAX_SPLITS; ++q)
        if (q < splits) {
          vg.x += pg[q].x;
          vg.y += pg[q].y;
          vg.z += pg[q].z;
          vg.w += pg[q].w;
          vu.x += pu[q].x;
          vu.y += pu[q].y;
          vu.z += pu[q].z;
          vu.w += pu[q].w;
        }
      *reinterpret_cast<uint2*>(args.out + static_cast<long long>(m) * args.F + ch0 + 4 * c4) =
          make_uint2(pack_bf16(swiglu(vg.x, vu.x), swiglu(vg.y, vu.y)),
                     pack_bf16(swiglu(vg.z, vu.z), swiglu(vg.w, vu.w)));
    }
    cluster_sync();  // no block leaves while another reads its partials
  }
}

// ===========================================================================
// head_argmax
// ===========================================================================

// (v, i) beats (bv, bi): greater value, or an equal value at a lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (beats(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

struct HeadArgs {
  const __nv_bfloat16* s;  // scales [V]
  float* pval;             // partials [M, n_tiles]
  int* pidx;
  int V;                   // a multiple of 128
  int n_tiles;             // ceil(V / HEAD_TILE)
};

// the head's ring, then the per-warp maxima [8][R] (f32 values, then int
// indices) of a tile's epilogue, apart from the ring that the producer goes
// on filling with the next tile
template <int R>
using HeadSmem = GemmSmem<R, 64 * R>;

template <int R>
__global__ void __launch_bounds__(GEMM_THREADS, 1) head_argmax_kernel(
    __grid_constant__ const CUtensorMap tx, __grid_constant__ const CUtensorMap tw, const HeadArgs args, int M,
    int k_steps, int groups) {
  using L = HeadSmem<R>;
  const int tid = threadIdx.x, wg = tid / 128;
  const int items = groups * args.n_tiles;  // item i: row group i % groups of vocab tile i / groups

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t sb = ring_setup<L>(smem_raw, 256, smem);

  if (wg == 2) {  // producer: the item's two boxes of 128 vocab rows (past V: zeros) and x tile, item after item
    if constexpr (L::MOVE_REGS) setmaxnreg_producer();
    if (tid == 256) {
      int stage = 0, phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int row0 = item % groups * R, v0 = item / groups * HEAD_TILE;
        produce<L>(sb, k_steps, 2 * L::W_BOX + L::X_TILE, stage, phase, [&](uint32_t base, uint32_t full, int n) {
          const int k = n * BK;
          tma_load_2d(base, &tw, full, k, v0);
          tma_load_2d(base + L::W_BOX, &tw, full, k, v0 + 128);
          tma_load_2d(base + 2 * L::W_BOX, &tx, full, k, row0);
        });
      }
    }
    return;
  }
  if constexpr (L::MOVE_REGS) setmaxnreg_consumer();
  const int w = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
  float* red_v = reinterpret_cast<float*>(smem + L::EXTRA_OFF);
  int* red_i = reinterpret_cast<int*>(smem + L::EXTRA_OFF) + 8 * R;
  // warpgroup wg's box holds vocab rows v0 + 128 wg + [0, 128); A tile i of
  // warp w: rows g and g + 8 are vocab rows 64 i + 16 w + g and + 8. Lane l
  // addresses row r = 64 (l / 16) + 16 w + l % 16 of the box; the 64-byte
  // swizzle moves its 16-byte chunk j (depths 16 j..16 j + 15) to j ^ (r / 2 % 4)
  const int r = 64 * (lane >> 4) + 16 * w + (lane & 15);
  const uint32_t row_off = wg * L::W_BOX + r * 64;
  const int rsw = (r >> 1) & 3;
  const Quad quad(lane);
  int stage = 0, phase = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int row0 = item % groups * R, tile = item / groups, v0 = tile * HEAD_TILE;
    const int wgs = args.V - v0 >= HEAD_TILE ? 2 : 1;  // warpgroups with vocab rows below V
    float acc0[R / 2], acc1[R / 2];
    mma_loop<L>(sb, k_steps, acc0, acc1, stage, phase, [&](uint32_t base, int j, uint32_t (&f)[2][4]) {
      load_frags_kmajor(base + row_off + ((j ^ rsw) << 4), quad, f);
    });
    consumers_sync();  // the previous item's maxima have been read
    if (wg < wgs) {
      // the f32 logits times the f32 scale; each column (x row) n = 8 j + 2 t
      // + e of the accumulators: the best of the thread's four vocab rows,
      // then of the quad rows' (lanes with the same t), then of the 8 warps
      const int vr = v0 + 128 * wg + 16 * w + g;  // tile i, half h: vocab row vr + 64 i + 8 h
      float s[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) s[i][h] = __bfloat162float(args.s[vr + 64 * i + 8 * h]);
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float bv = acc0[4 * j + e] * s[0][0];
          int bi = vr;
          take(acc0[4 * j + 2 + e] * s[0][1], vr + 8, bv, bi);
          take(acc1[4 * j + e] * s[1][0], vr + 64, bv, bi);
          take(acc1[4 * j + 2 + e] * s[1][1], vr + 72, bv, bi);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
            const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
            take(ov, oi, bv, bi);
          }
          if (g == 0) {
            const int n = 8 * j + 2 * t + e;
            red_v[(4 * wg + w) * R + n] = bv;
            red_i[(4 * wg + w) * R + n] = bi;
          }
        }
    }
    consumers_sync();
    if (tid < R && row0 + tid < M) {
      float bv = red_v[tid];
      int bi = red_i[tid];
      for (int q = 1; q < 4 * wgs; ++q) take(red_v[q * R + tid], red_i[q * R + tid], bv, bi);
      const long long o = static_cast<long long>(row0 + tid) * args.n_tiles + tile;
      args.pval[o] = bv;
      args.pidx[o] = bi;
    }
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
  for (int j = lane; j < n_tiles; j += 32) take(pval[base + j], pidx[base + j], bv, bi);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
    const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
    take(ov, oi, bv, bi);
  }
  if (lane == 0) {
    tok[row] = bi;
    maxv[row] = bv;
  }
}

// --- host ----------------------------------------------------------------------

// a row-major [outer, inner] matrix (rows `row_bytes` apart) read in boxes of
// box_inner x box_outer with the given swizzle; boxes past an edge read zeros
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, int inner, int outer,
              long long row_bytes, int box_inner, int box_outer,
              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ENCODE_FAILED + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + static_cast<int>(r);
}

// the activation x [M, K] in K-major boxes of 64 deep x `rows` rows
int encode_x(CUtensorMap* map, const void* x, int M, int K, int rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K, BK, rows);
}

// a layer weight [K, n] in boxes of 128 channels x 64 deep
int encode_w(CUtensorMap* map, const void* w, int K, int n) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, n, K, n, 128, BK);
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

// groups of `per` rows, padded to the least template width that holds them
GemmPlan rows_for(int per, int groups, int splits) {
  if (per <= 8) return with_rows<8>(groups, splits);
  if (per <= 16) return with_rows<16>(groups, splits);
  if (per <= 32) return with_rows<32>(groups, splits);
  if (per <= 64) return with_rows<64>(groups, splits);
  if (per <= 80) return with_rows<80>(groups, splits);
  if (per <= 96) return with_rows<96>(groups, splits);
  return with_rows<128>(groups, splits);
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
  return rows_for(per, groups, splits);
}

// The head: equal groups of at most HEAD_MAX_ROWS rows, all of K in one block
// (V / 256 vocab tiles give the card its blocks at any M); a group of 129 to
// 184 rows takes the width 184 (the decode bench's 368 rows: two groups, no
// padding)
GemmPlan head_plan(int M) {
  const int groups = (M + HEAD_MAX_ROWS - 1) / HEAD_MAX_ROWS, per = (M + groups - 1) / groups;
  return per > GEMM_MAX_ROWS ? with_rows<184>(groups, 1) : rows_for(per, groups, 1);
}

// Lets `kernel` take `bytes` of dynamic shared memory, once for each device
// (a bit of `allowed`, the kernel's own, each; devices past 63 ask on every
// launch).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<unsigned long long>& allowed) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit != 0 && (allowed.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// `kernel` (its shared memory laid out as L) on the grid in clusters of
// `cluster` blocks
template <typename L, typename Kernel, typename... Args>
int launch(Kernel kernel, std::atomic<unsigned long long>& allowed, dim3 grid, dim3 cluster, cudaStream_t stream,
           Args... args) {
  const cudaError_t attr = allow_smem(kernel, L::BYTES, allowed);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster.x;
  at[0].val.clusterDim.y = cluster.y;
  at[0].val.clusterDim.z = cluster.z;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(GEMM_THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int R>
int launch_gemm(const CUtensorMap& tx, const CUtensorMap (&tw)[3], const GemmSegs& segs, int M, int K,
                const GemmPlan& p, int tiles, cudaStream_t stream) {
  static std::atomic<unsigned long long> allowed{0};
  return launch<GemmSmem<R>>(w8_gemm_kernel<R>, allowed, dim3(p.splits, p.groups, tiles), dim3(p.splits), stream, tx, tw[0],
                   tw[1], tw[2], segs, M, K / BK);
}

// the blocks of a persistent launch of `items` items: one an SM, at most one an item
int persistent_blocks(int items, int& blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  blocks = sms < items ? sms : items;
  return static_cast<int>(e);
}

template <int R>
int launch_swiglu(const CUtensorMap& tx, const CUtensorMap& tg, const CUtensorMap& tu, const SwigluArgs& args,
                  int M, int K, const GemmPlan& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> allowed{0};
  const int tiles = args.F / SWIGLU_CH;
  int blocks = 0;
  if (p.splits == 1) {
    const int rc = persistent_blocks(p.groups * tiles, blocks);
    if (rc != 0) return rc;
  }
  const dim3 grid = p.splits == 1 ? dim3(1, blocks) : dim3(p.splits, p.groups, tiles);
  return launch<GemmSmem<R>>(w8_swiglu_kernel<R>, allowed, grid, dim3(p.splits), stream, tx, tg, tu, args, M, K / BK,
                             p.groups);
}

template <int R>
int launch_head(const CUtensorMap& tx, const CUtensorMap& tw, const HeadArgs& args, int M, int K, const GemmPlan& p,
                cudaStream_t stream) {
  static std::atomic<unsigned long long> allowed{0};
  int blocks = 0;
  const int rc = persistent_blocks(p.groups * args.n_tiles, blocks);
  if (rc != 0) return rc;
  return launch<HeadSmem<R>>(head_argmax_kernel<R>, allowed, dim3(blocks), dim3(1), stream, tx, tw, args, M, K / BK,
                             p.groups);
}

// the launch of the row width R a plan chose: F(integral_constant<R>)
template <typename F>
int by_rows(int rows, F f) {
  switch (rows) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    default: return f(std::integral_constant<int, 128>{});
  }
}

// by_rows with the head's width 184 besides
template <typename F>
int by_head_rows(int rows, F f) {
  return rows == 184 ? f(std::integral_constant<int, 184>{}) : by_rows(rows, f);
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
  int rc = encode_x(&tx, a, M, K, p.rows);
  if (rc != 0) return rc;
  const void* ws[3] = {w0, w1, w2};
  const void* ss[3] = {s0, s1, s2};
  void* os[3] = {o0, o1, o2};
  const int ns[3] = {n0, n1, n2};
  GemmSegs segs{};
  int tiles = 0;
  for (int j = 0; j < nseg; ++j) {
    if (ns[j] <= 0 || ns[j] % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if ((rc = encode_w(&tw[j], ws[j], K, ns[j])) != 0) return rc;
    segs.seg[j] = GemmSeg{static_cast<const __nv_bfloat16*>(ss[j]), static_cast<__nv_bfloat16*>(os[j]), ns[j],
                          (ns[j] + GEMM_CH - 1) / GEMM_CH};
    tiles += segs.seg[j].tiles;
  }
  for (int j = nseg; j < 3; ++j) tw[j] = tw[0];  // never read
  segs.count = nseg;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_rows(p.rows, [&](auto r) { return launch_gemm<decltype(r)::value>(tx, tw, segs, M, K, p, tiles, st); });
}

// plan[0..4] = the row width, row groups, K parts, ring stages and shared
// memory bytes of a w8_gemm (and so w8_swiglu) launch of M rows and depth K
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

// out [M, F] = bf16(silu(bf16(x @ deq(gate)))) * bf16(x @ deq(up)), rounded to
// bf16; wg/sg and wu/su point at the layer's [K, F] weights and [F] scales.
// Returns as w8_gemm does.
extern "C" int w8_swiglu(const void* x, int M, int K, const void* wg, const void* sg,
                         const void* wu, const void* su, void* out, int F, void* stream) {
  if (M <= 0 || K <= 0 || K % BK != 0 || F <= 0 || F % SWIGLU_CH != 0) return static_cast<int>(cudaErrorInvalidValue);
  const GemmPlan p = gemm_plan(M, K);
  CUtensorMap tx, tg, tu;
  int rc;
  if ((rc = encode_x(&tx, x, M, K, p.rows)) != 0 || (rc = encode_w(&tg, wg, K, F)) != 0 ||
      (rc = encode_w(&tu, wu, K, F)) != 0)
    return rc;
  const SwigluArgs args{static_cast<const __nv_bfloat16*>(sg), static_cast<const __nv_bfloat16*>(su),
                        static_cast<__nv_bfloat16*>(out), F};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_rows(p.rows, [&](auto r) { return launch_swiglu<decltype(r)::value>(tx, tg, tu, args, M, K, p, st); });
}

// tok [M], maxv [M] = argmax / max over v of (x [M, K] . bf16(w [v, :])) * s[v];
// pval/pidx are scratch of M * ceil(V / 256) elements. Returns as w8_gemm does.
extern "C" int head_argmax(const void* x, int M, int K, const void* w, const void* s, int V,
                           void* pval, void* pidx, void* tok, void* maxv, void* stream) {
  if (M <= 0 || K <= 0 || K % BK != 0 || V <= 0 || V % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const GemmPlan p = head_plan(M);
  CUtensorMap tx, tw;
  int rc;
  if ((rc = encode_x(&tx, x, M, K, p.rows)) != 0 ||
      (rc = encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, V, K, BK, 128, CU_TENSOR_MAP_SWIZZLE_64B)) != 0)
    return rc;
  const HeadArgs args{static_cast<const __nv_bfloat16*>(s), static_cast<float*>(pval), static_cast<int*>(pidx), V,
                      (V + HEAD_TILE - 1) / HEAD_TILE};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  rc = by_head_rows(p.rows, [&](auto r) { return launch_head<decltype(r)::value>(tx, tw, args, M, K, p, st); });
  if (rc != 0) return rc;
  head_reduce_kernel<<<(M + 7) / 8, 256, 0, st>>>(args.pval, args.pidx, M, args.n_tiles, static_cast<int*>(tok),
                                                  static_cast<float*>(maxv));
  return static_cast<int>(cudaGetLastError());
}
