// Backward of kernel K6 (streaming attention with a per-key bias) in bf16,
// for Hopper (sm_90a): wgmma products on TMA-fed tiles.
//
// Replaces the TPU (Pallas) kernel _bwd_fused_kernel of the JAX package's
// ops/pallas/flash_attention.py (via _flash_backward, entry flash_attention)
// for bf16 inputs; the fp32 backward keeps its FMA kernels in
// flash_attention.cu. q and dO [B, H, Nq, D], k and v [B, H, Nk, D] (each
// with its own strides, head dim contiguous, read in place through TMA
// tensor maps), the fp32 key bias [B, Nk] of the forward (or none) and the
// forward's fp32 log-sum-exp -> dq, dk, dv in bf16. The bias gets no
// gradient. D <= 256 runs as Dp = 64, 128 or 256 columns; the tensor maps
// fill the columns past D, the keys past Nk and the queries past Nq with
// zeros.
//
// Math (that of the port's first K6 backward): P = exp2(s * scale * log2(e)
// + bias * log2(e) - lse * log2(e)) from the fp32 scores; keys past Nk get
// P = 0; delta = rowsum(P * dP) / rowsum(P) from the backward's own P and
// dP = dO.V^T (the division cancels the rounding of the log-sum-exp); dS0 =
// P * (dP - delta) in fp32, carried into dQ and dK as bf16(dS0) plus its
// bf16 residual; dV from bf16(P); the scale applied after the products.
// Each row of dS0 then sums to 0 at fp32 precision. Where the keys are
// rotated after a projection with a bias (RoPE in SAM2's memory attention),
// that bias's gradient, the keys' sum of the rotated dK rows, is a residue
// of this cancellation. The TPU kernel takes delta = rowsum(dO * O) from the
// output in the input dtype and rounds dS0 to it; even from an fp32 O,
// delta was 1.7e-5 off at SAM2's memory self-attention, which put that sum
// 12x as far from its float64 value as the plain path's, and the memory
// attention's key biases off the plain path's floor in chip_smoke.py's SAM2
// gradient check.
//
// Bound on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at SAM2's
// memory cross-attention (B = H = 1, Nq = 4096, Nk = 28,736 of which 28,704
// are valid at frame 7, D = 256) the five Nq x Nk x D products over the
// valid keys are 301 GFLOP = 0.304 ms, against ~67 MB of q, k, v, dO and
// the gradients = 0.02 ms: bound by operations. This design computes 11
// such products, not 5: S and dP twice more for delta (a walk of its own,
// before any dS0 exists), and the bf16 residual of dS0 in dQ and in dK.
//   delta kernel: S, dP                       (2)
//   dQ kernel:    S, dP, dS0.K, residual.K    (4)
//   dK/dV kernel: S^T, dP^T, P^T.dO, dS0^T.Q, residual^T.Q (5)
//
// Tiles. Every tile is 64 rows x Dp columns, in shared memory as Dp / 64
// boxes of 64 x 64 bf16 (128-byte rows) in the 128-byte swizzle that TMA
// writes and wgmma reads. One copy of each tile feeds both of its products:
// the score products read it K-major, the gradient products MN-major (the
// descriptor's transpose bit), so nothing is transposed. A block is two
// consumer warpgroups and a producer warpgroup (384 threads: Hopper
// allocates registers by warpgroup) of which one warp works; the producer
// warpgroup gives up its registers to the consumers (setmaxnreg 40 / 232).
//   - The producer warp loads the block's own tiles (Q and dO in the delta
//     and dQ kernels, K and V in the dK/dV kernel) once, then streams the
//     other two (K and V, or Q and dO) through a ring of 2 stages with
//     full/empty mbarriers, one TMA per 64 x 64 box, and writes each
//     stage's row terms beside it (the key tile's bias, or the query
//     tile's lse and delta, 512 bytes).
//   - Dp = 128 and 256: the block owns 64 rows. Warpgroup 0 computes S
//     (S^T) and P, warpgroup 1 dP (dP^T); P goes to warpgroup 1 through
//     shared memory in fp32 (16 KB, each thread's fragment in place), which
//     computes dS0 and writes bf16(dS0) and its residual over it (2 x 8 KB,
//     swizzled, the A operand of the gradient products); in the dK/dV kernel
//     warpgroup 0 also writes bf16(P^T) (8 KB). Then each warpgroup
//     multiplies them into its own half of the output columns of dQ (or of
//     dK and dV): at Dp = 256 dK and dV of 64 x 128 fp32 are 128 registers
//     a thread, where 64 x 256 would not fit. Named barriers order the
//     exchange.
//   - Dp = 64: each warpgroup owns 64 rows of its own, the block 128 (the
//     notes at query_side_rows).
//   Shared memory (dK/dV in brackets): Dp = 256: 64 KB own tiles + 128 KB
//   of stages + 16 KB exchange (+ 8 KB P^T) + 1 KB row terms = 210 (218)
//   KB; Dp = 128: 114 (122) KB; Dp = 64: 98 (114) KB. ptxas: 168 registers
//   a thread at launch.
//
// Split keys. At B * H = 1 the 64 query tiles of SAM2's memory attention
// would fill half the card, so the delta and dQ walks split the keys: block
// (query block, split s) takes key tiles j with j mod S = s (interleaved,
// so that empty memory slots spread evenly), S = the SMs over the query
// blocks of all heads, rounded down (2 there: 128 blocks). Each block writes
// fp32 partials, rowsum(P) and rowsum(P * dP) [S, B * H, Nq] and (S > 1) dQ
// [S, B * H, Nq, Dp]; the dQ kernel sums the former and a reduction kernel
// the latter, each in the fixed order s = 0, 1, ..., S - 1. No atomics: the
// result is the same bit for bit from run to run. The dK/dV walk over the query tiles splits the
// same way where the key tiles are fewer than the SMs (the memory
// self-attention: 64 key tiles), with fp32 partials of dK and dV.
//
// Skipped tiles. A (query tile, key tile) pair is skipped, in every kernel,
// only when every key of the key tile has a bias <= -5e8 (or lies past Nk)
// and every query row of the query tile has lse > -2.5e8, that is, at least
// one unmasked key set it. Then s * scale + bias - lse < |s * scale| - 7.5e8
// and P underflows to exactly 0 in fp32 for any real input: the pair adds
// exact zeros to rowsum(P), rowsum(P * dP), dQ, and the masked keys' dK and
// dV, so nothing changes. A dK/dV block whose keys are all masked walks no
// tile and writes zero rows; a row whose keys are all masked (it averages V,
// as on the TPU) keeps every pair of its query tile. The producer decides
// for 32 tiles at once (a lane a tile, a ballot) and hands each kept tile's
// index to the consumers in its stage; -1 ends the walk.
//
// The tensor maps need libcuda's cuTensorMapEncodeTiled, fetched through
// the runtime (cudaGetDriverEntryPoint, by version from CUDA 12.5), so
// nothing links against libcuda. The wrapper copies an operand whose base or strides are
// not 16-byte aligned (TMA's rule) before the call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace saicv;

constexpr int kStages = 2;
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBox = 64 * 64 * 2;          // bytes of one 64 x 64 bf16 box
constexpr int kXchgBytes = 16384;          // fp32 P [32][128], then bf16 dS0 hi and lo
constexpr int kRowTerms = 128;             // floats a stage: the tile's bias, or lse and delta
constexpr float kMaskedBias = -5e8f;       // a key with a bias at or below: masked
constexpr float kRowSet = -2.5e8f;         // a row with an lse above: an unmasked key set it

// named barriers (0 is __syncthreads)
constexpr int kBarP = 1;     // warpgroup 0's P is in the exchange
constexpr int kBarDs = 2;    // warpgroup 1's dS0 is in the exchange
constexpr int kBarDone = 3;  // warpgroup 1 is done with this tile's exchange
constexpr int kBarWg1 = 4;   // within warpgroup 1

struct BwdParams {
  CUtensorMap tq, tk, tv, tdo;  // 4-D maps {D, N, H, B} of q, k, v, dout
  const float* lse;             // [B * H, Nq], natural log
  const float* bias;            // [B, Nk] or null
  long long bias_sb;
  float* stats;                 // [2][splits_q][B * H][Nq]: rowsum(P), rowsum(P * dP)
  float* delta;                 // [B * H][Nq], written by the dQ kernel's split 0
  bf16 *dq, *dk, *dv;
  long long dq_sb, dq_sh, dq_sn, dkv_sb, dkv_sh, dkv_sn;
  float* dq_part;               // [splits_q][B * H][Nq][Dp] when splits_q > 1
  float* dkv_part;              // [2][splits_kv][B * H][Nk][Dp] when splits_kv > 1
  int B, H, Nq, Nk, D;
  int q_tiles, k_tiles, splits_q, splits_kv;
  int out_vec;                  // bf16 pairs of dq, dk, dv stored as 32-bit words
  float scale;
};

// ------------------------------------------------------------ primitives

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Registers a thread of this warpgroup: the producer warpgroup gives them
// up (40), the consumers take them (232; at launch 168 each).
template <int N>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One 64 x 64 box of a 4-D map {D, N, H, B} at (col, row, head, batch).
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                        int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(head),
      "r"(batch)
      : "memory");
}

// A 64 x Dp tile: Dp / 64 boxes, 8 KB apart.
template <int kBlk>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int head, int batch) {
#pragma unroll
  for (int c = 0; c < kBlk; ++c) tma_box(dst + c * kBox, map, bar, 64 * c, row, head, batch);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from touching accumulators across wgmma's asynchrony.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands (rows
// of 64 K-values, 128 bytes): 8-row groups 1024 bytes apart (SBO), the
// leading offset unused. MN-major operands (K rows of 64 MN-values): 8-row
// groups of K 1024 bytes apart (SBO), 64-column boxes 8 KB apart (LBO).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) { return sw128_desc(addr, 16); }
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) { return sw128_desc(addr, kBox); }

// d (64 x N, fp32) = (acc ? d : 0) + A (64 x 16) . B (16 x N), A K-major,
// B K-major (kTransB = 0) or MN-major (1).
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<64, 0>(float (&d)[32], uint64_t a, uint64_t b,
                                                  int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64, 1>(float (&d)[32], uint64_t a, uint64_t b,
                                                  int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128, 1>(float (&d)[64], uint64_t a, uint64_t b,
                                                  int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}


// ------------------------------------------------------------- tile math
//
// Accumulator layout of a 64 x N product in a warpgroup: warp w holds rows
// 16w.. 16w+15; register i of a thread (lane = 4g + t) is row 16w + g + 8 *
// ((i >> 1) & 1), column 8 * (i >> 2) + 2t + (i & 1).

// s (64 x 64) = A (64 x Dp) . B (64 x Dp)^T, both tiles K-major; committed,
// not waited for.
template <int kBlk>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a, uint32_t b) {
  wg_fence();
#pragma unroll
  for (int c = 0; c < kBlk; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<64, 0>(s, kmajor(a + c * kBox + 32 * kk), kmajor(b + c * kBox + 32 * kk),
                      c | kk);
  wg_commit();
}

// acc (64 x NH) += X (64 x 64, K-major) . T[:, col0 : col0 + NH] (T a 64 x
// Dp tile read MN-major).
template <int NH>
__device__ __forceinline__ void times_tile(float (&acc)[NH / 2], uint32_t x, uint32_t tile,
                                           int col0) {
  const uint32_t b0 = tile + (col0 / 64) * kBox + (col0 % 64) * 2;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<NH, 1>(acc, kmajor(x + 32 * kk), mnmajor(b0 + 16 * 128 * kk), 1);
}

// The 64 x 64 fp32 fragments of a warpgroup in the exchange, each thread's
// 32 values in place (conflict-free); the other warpgroup's thread tw reads
// element i at xchg[i * 128 + tw].
__device__ __forceinline__ void put_fragments(float* xchg, const float (&s)[32], int tw) {
#pragma unroll
  for (int i = 0; i < 32; ++i) xchg[i * 128 + tw] = s[i];
}

// A 64 x 64 fp32 tile as a bf16 wgmma operand (K-major, 128-byte swizzle):
// its rounding at hi, and with lo its bf16 residual.
template <bool kResidual>
__device__ __forceinline__ void put_bf16(unsigned char* hi, unsigned char* lo,
                                         const float (&s)[32], int warp, int g, int t) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h;
      const int off = row * 128 + ((jj ^ g) << 4) + 4 * t;
      const float a = s[4 * jj + 2 * h], b = s[4 * jj + 2 * h + 1];
      *reinterpret_cast<uint32_t*>(hi + off) = pack_bf16(a, b);
      if (kResidual) *reinterpret_cast<uint32_t*>(lo + off) = pack_bf16_residual(a, b);
    }
}

// Rows row0 + 16w + g (+8) of a warpgroup's 64 x NH accumulators, columns
// col0.., as bf16 (times scale) at out (row stride sn), or as fp32 at part
// (row stride Dp).
template <int NH>
__device__ __forceinline__ void store_bf16(bf16* out, long long sn, const float (&acc)[NH / 2],
                                           float scale, int row0, int N, int col0, int D, int t,
                                           int vec) {
#pragma unroll
  for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const int col = col0 + 8 * jj + 2 * t;
      if (row >= N || col >= D) continue;
      const float a = acc[4 * jj + 2 * h] * scale, b = acc[4 * jj + 2 * h + 1] * scale;
      bf16* dst = out + row * sn + col;
      if (vec) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
      } else {
        dst[0] = __float2bfloat16_rn(a);
        if (col + 1 < D) dst[1] = __float2bfloat16_rn(b);
      }
    }
}

template <int NH>
__device__ __forceinline__ void store_f32(float* part, int Dp, const float (&acc)[NH / 2],
                                          int row0, int N, int col0, int t) {
#pragma unroll
  for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= N) continue;
      *reinterpret_cast<float2*>(part + static_cast<long long>(row) * Dp + col0 + 8 * jj + 2 * t) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
    }
}

// ------------------------------------------------------------- skip rule

__device__ __forceinline__ bool key_masked(const float* bias, int key, int Nk) {
  return key >= Nk || __ldg(bias + key) <= kMaskedBias;
}

// A lane's test of one key tile (bias not null).
__device__ __forceinline__ bool key_tile_masked(const float* bias, int tile, int Nk) {
  bool masked = true;
#pragma unroll 16
  for (int i = 0; i < 64; ++i) masked &= key_masked(bias, 64 * tile + i, Nk);
  return masked;
}

__device__ __forceinline__ bool row_set(const float* lse, int row, int Nq) {
  return row >= Nq || __ldg(lse + row) > kRowSet;
}

// A lane's test of one query tile.
__device__ __forceinline__ bool query_tile_set(const float* lse, int tile, int Nq) {
  bool set = true;
#pragma unroll 16
  for (int i = 0; i < 64; ++i) set &= row_set(lse, 64 * tile + i, Nq);
  return set;
}

// ------------------------------------------------------------- layout

// Dynamic shared memory of one block: the block's own two tiles, the ring
// of streamed tile pairs, the exchange, (dK/dV) bf16 P^T, each stage's row
// terms, the barriers and the ring's tile indices; 1024-byte aligned for
// the swizzle.
template <int Dp, bool kPt>
struct Layout {
  static constexpr bool kRows = Dp == 64;  // rows a warpgroup (further down)
  static constexpr int kBlk = Dp / 64;
  static constexpr int kTile = kBlk * kBox;
  static constexpr int kStage = (kRows ? 4 : 2) * kTile;  // after the own tiles
  // the exchange; with kRows each warpgroup's bf16 operands
  static constexpr int kXchg = kStage + kStages * 2 * kTile;
  static constexpr int kPt_ = kXchg + kXchgBytes;
  static constexpr int kTerms =
      kRows ? kXchg + 2 * (kPt ? 3 : 2) * kBox : kPt_ + (kPt ? kBox : 0);
  static constexpr int kBars = kTerms + kStages * kRowTerms * 4;
  static constexpr int kBytes = kBars + 64 + 1024;
};

struct Ring {
  uint64_t* full;  // arrived on by the producer warp's 32 lanes (lane 0 with the bytes)
  uint64_t* empty;
  uint64_t* own;   // the block's own tiles
  volatile int* tile;
  float* terms;    // [kStages][kRowTerms]

  __device__ __forceinline__ Ring(unsigned char* bars, unsigned char* row_terms) {
    full = reinterpret_cast<uint64_t*>(bars);
    empty = full + kStages;
    own = empty + kStages;
    tile = reinterpret_cast<volatile int*>(own + 1);
    terms = reinterpret_cast<float*>(row_terms);
  }
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
}

// The producer warp's walk: for 32 candidate tiles at a time (tile =
// first + step * (base + lane)), `keep(tile)` decides; each kept tile goes
// into the ring in order: lane 0 loads its two tiles (load(stage buffer,
// barrier, tile)), every lane writes its share of the tile's row terms
// (terms(stage's terms, tile, lane)). Then the consumers get -1.
template <typename Keep, typename Load, typename Terms>
__device__ __forceinline__ void produce(Ring& ring, unsigned char* stages, int stage_bytes,
                                        int first, int step, int tiles, Keep keep, Load load,
                                        Terms terms) {
  const int lane = threadIdx.x % 32;
  int stage = 0, parity = 1;  // the ring starts empty
  auto push = [&](int tile) {
    if (lane == 0) mbar_wait(&ring.empty[stage], parity);
    __syncwarp();
    if (tile >= 0) terms(ring.terms + stage * kRowTerms, tile, lane);
    if (lane == 0) {
      ring.tile[stage] = tile;
      if (tile >= 0) {
        mbar_expect_tx(&ring.full[stage], stage_bytes);
        load(stages + stage * stage_bytes, &ring.full[stage], tile);
      } else {
        mbar_arrive(&ring.full[stage]);
      }
    } else {
      mbar_arrive(&ring.full[stage]);
    }
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1;
    }
  };
  for (int base = first; base < tiles; base += 32 * step) {
    const int tile = base + lane * step;
    unsigned kept = __ballot_sync(0xffffffffu, tile < tiles && keep(tile));
    while (kept) {
      const int l = __ffs(kept) - 1;
      kept &= kept - 1;
      push(base + l * step);
    }
  }
  push(-1);
}

// ------------------------------------------------- delta and dQ kernels
//
// Block (query tile, key split) of one (batch, head). kDelta: the first
// walk, rowsum(P) and rowsum(P * dP) partials; else the dQ walk. A stage's
// row terms: bias * log2(e) of the key tile's 64 keys (-inf past Nk).
template <int Dp, bool kDelta>
__device__ __forceinline__ void query_side(const BwdParams& p) {
  using L = Layout<Dp, false>;
  constexpr int kBlk = L::kBlk;
  constexpr int kHalf = Dp / 2;  // dQ columns a warpgroup
  unsigned char* sm = aligned_smem();
  Ring ring(sm + L::kBars, sm + L::kTerms);

  const int S = p.splits_q;
  const int qt = blockIdx.x / S, split = blockIdx.x % S;
  const int hy = blockIdx.y, bz = blockIdx.z;
  const long long bh = static_cast<long long>(bz) * p.H + hy;
  const int q0 = 64 * qt;
  const float* lse = p.lse + bh * p.Nq;
  const float* bias = p.bias ? p.bias + bz * p.bias_sb : nullptr;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup; its first warp loads
    regs_down<40>();
    if (threadIdx.x < kConsumers + 32) {
      if (threadIdx.x == kConsumers) {
        mbar_expect_tx(ring.own, 2 * L::kTile);
        tma_tile<kBlk>(sm, &p.tq, ring.own, q0, hy, bz);
        tma_tile<kBlk>(sm + L::kTile, &p.tdo, ring.own, q0, hy, bz);
      }
      const int lane = threadIdx.x % 32;
      const bool rows_set =
          bias != nullptr && __all_sync(0xffffffffu, row_set(lse, q0 + lane, p.Nq) &&
                                                         row_set(lse, q0 + 32 + lane, p.Nq));
      produce(
          ring, sm + L::kStage, 2 * L::kTile, split, S, p.k_tiles,
          [&](int j) { return !(rows_set && key_tile_masked(bias, j, p.Nk)); },
          [&](unsigned char* dst, uint64_t* bar, int j) {
            tma_tile<kBlk>(dst, &p.tk, bar, 64 * j, hy, bz);
            tma_tile<kBlk>(dst + L::kTile, &p.tv, bar, 64 * j, hy, bz);
          },
          [&](float* terms, int j, int lane_) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int key = 64 * j + lane_ + 32 * h;
              terms[lane_ + 32 * h] =
                  key >= p.Nk ? -INFINITY : bias ? __ldg(bias + key) * kLog2e : 0.f;
            }
          });
    }
  } else {
    regs_up<232>();
    const int wg = threadIdx.x / 128;  // 0: S and P; 1: dP and dS0
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int row0 = q0 + 16 * warp + g;  // and row0 + 8
    const float sc = p.scale * kLog2e;
    float* xchg = reinterpret_cast<float*>(sm + L::kXchg);
    unsigned char* ds_hi = sm + L::kXchg;
    unsigned char* ds_lo = ds_hi + kBox;
    const uint32_t own0 = smem_addr(sm), own1 = own0 + L::kTile;

    // warpgroup 0: lse * log2(e) of its rows (+inf past Nq: P = 0);
    // warpgroup 1 (dQ): delta, summed over the splits in order
    float rowv[2] = {0.f, 0.f};
    const long long nstat = static_cast<long long>(S) * p.B * p.H * p.Nq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (wg == 0) {
        rowv[h] = row < p.Nq ? lse[row] * kLog2e : INFINITY;
      } else if (!kDelta && row < p.Nq) {
        float psum = 0.f, pdp = 0.f;
        for (int s = 0; s < S; ++s) {
          const long long at = (s * p.B * static_cast<long long>(p.H) + bh) * p.Nq + row;
          psum += p.stats[at];
          pdp += p.stats[nstat + at];
        }
        rowv[h] = pdp / psum;
        if (split == 0 && t == 0) p.delta[bh * p.Nq + row] = rowv[h];
      }
    }

    float acc[kHalf / 2];  // dQ, columns wg * kHalf..
    float psum[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) acc[i] = 0.f;

    mbar_wait(ring.own, 0);
    int stage = 0, parity = 0;
    for (;;) {
      mbar_wait(&ring.full[stage], parity);
      const int j = ring.tile[stage];
      if (j < 0) break;
      const uint32_t kt = own0 + L::kStage + stage * 2 * L::kTile, vt = kt + L::kTile;
      const float* kb = ring.terms + stage * kRowTerms + 2 * t;  // + 8 * (i >> 2) + (i & 1)
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      if (wg == 0) {
        scores<kBlk>(s, own0, kt);
        wg_wait_all();
        fence_regs(s);
        // the logit as the forward forms it (bias first), then lse: a row
        // whose keys are all masked gets the forward's P
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = exp2_approx(fmaf(s[i], sc, kb[8 * (i >> 2) + (i & 1)]) - rowv[(i >> 1) & 1]);
        put_fragments(xchg, s, tw);
        named_arrive(kBarP, kConsumers);
        if constexpr (!kDelta) {
          named_sync(kBarDs, kConsumers);
          wg_fence();
          times_tile<kHalf>(acc, smem_addr(ds_hi), kt, 0);
          times_tile<kHalf>(acc, smem_addr(ds_lo), kt, 0);
          wg_commit();
          wg_wait_all();
          fence_regs(acc);
        }
        named_sync(kBarDone, kConsumers);
      } else {
        scores<kBlk>(s, own1, vt);
        wg_wait_all();
        fence_regs(s);
        named_sync(kBarP, kConsumers);
        if constexpr (kDelta) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float pv = xchg[i * 128 + tw];
            psum[(i >> 1) & 1] += pv;
            pdp[(i >> 1) & 1] += pv * s[i];
          }
          named_arrive(kBarDone, kConsumers);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = xchg[i * 128 + tw] * (s[i] - rowv[(i >> 1) & 1]);
          named_sync(kBarWg1, 128);  // every P read before dS0 overwrites it
          put_bf16<true>(ds_hi, ds_lo, s, warp, g, t);
          fence_proxy_async();
          named_arrive(kBarDs, kConsumers);
          wg_fence();
          times_tile<kHalf>(acc, smem_addr(ds_hi), kt, kHalf);
          times_tile<kHalf>(acc, smem_addr(ds_lo), kt, kHalf);
          wg_commit();
          wg_wait_all();
          fence_regs(acc);
          named_arrive(kBarDone, kConsumers);
        }
      }
      if (lane == 0) mbar_arrive(&ring.empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }

    if constexpr (kDelta) {
      if (wg == 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int x = 1; x < 4; x <<= 1) {
            psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], x);
            pdp[h] += __shfl_xor_sync(0xffffffffu, pdp[h], x);
          }
          const int row = row0 + 8 * h;
          if (t == 0 && row < p.Nq) {
            const long long at = (split * p.B * static_cast<long long>(p.H) + bh) * p.Nq + row;
            p.stats[at] = psum[h];
            p.stats[nstat + at] = pdp[h];
          }
        }
      }
    } else {
      const int col0 = wg * kHalf;
      if (S == 1) {
        store_bf16<kHalf>(p.dq + bz * p.dq_sb + hy * p.dq_sh, p.dq_sn, acc, p.scale, row0, p.Nq,
                          col0, p.D, t, p.out_vec);
      } else {
        float* part = p.dq_part + (split * p.B * static_cast<long long>(p.H) + bh) * p.Nq * Dp;
        store_f32<kHalf>(part, Dp, acc, row0, p.Nq, col0, t);
      }
    }
  }
}

// ------------------------------------------------------- dK/dV kernel
//
// Block (key tile, query split) of one (batch, head): S^T = K.Q^T, dP^T =
// V.dO^T, P^T, dS0^T; dV += bf16(P^T).dO, dK += (bf16(dS0^T) + residual).Q.
// A stage's row terms: lse * log2(e) of the query tile's 64 rows (+inf past
// Nq), then their delta (0 past Nq).
template <int Dp>
__device__ __forceinline__ void key_side(const BwdParams& p) {
  using L = Layout<Dp, true>;
  constexpr int kBlk = L::kBlk;
  constexpr int kHalf = Dp / 2;
  unsigned char* sm = aligned_smem();
  Ring ring(sm + L::kBars, sm + L::kTerms);

  const int S = p.splits_kv;
  const int ktile = blockIdx.x / S, split = blockIdx.x % S;
  const int hy = blockIdx.y, bz = blockIdx.z;
  const long long bh = static_cast<long long>(bz) * p.H + hy;
  const int k0 = 64 * ktile;
  const float* lse = p.lse + bh * p.Nq;
  const float* delta = p.delta + bh * p.Nq;
  const float* bias = p.bias ? p.bias + bz * p.bias_sb : nullptr;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup; its first warp loads
    regs_down<40>();
    if (threadIdx.x < kConsumers + 32) {
      if (threadIdx.x == kConsumers) {
        mbar_expect_tx(ring.own, 2 * L::kTile);
        tma_tile<kBlk>(sm, &p.tk, ring.own, k0, hy, bz);
        tma_tile<kBlk>(sm + L::kTile, &p.tv, ring.own, k0, hy, bz);
      }
      const int lane = threadIdx.x % 32;
      const bool keys_masked =
          bias != nullptr && __all_sync(0xffffffffu, key_masked(bias, k0 + lane, p.Nk) &&
                                                         key_masked(bias, k0 + 32 + lane, p.Nk));
      produce(
          ring, sm + L::kStage, 2 * L::kTile, split, S, p.q_tiles,
          [&](int i) { return !(keys_masked && query_tile_set(lse, i, p.Nq)); },
          [&](unsigned char* dst, uint64_t* bar, int i) {
            tma_tile<kBlk>(dst, &p.tq, bar, 64 * i, hy, bz);
            tma_tile<kBlk>(dst + L::kTile, &p.tdo, bar, 64 * i, hy, bz);
          },
          [&](float* terms, int i, int lane_) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 64 * i + lane_ + 32 * h;
              const bool in = row < p.Nq;
              terms[lane_ + 32 * h] = in ? __ldg(lse + row) * kLog2e : INFINITY;
              terms[64 + lane_ + 32 * h] = in ? __ldg(delta + row) : 0.f;
            }
          });
    }
  } else {
    regs_up<232>();
    const int wg = threadIdx.x / 128;  // 0: S^T and P^T; 1: dP^T and dS0^T
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int row0 = k0 + 16 * warp + g;  // keys row0 and row0 + 8
    const float sc = p.scale * kLog2e;
    float* xchg = reinterpret_cast<float*>(sm + L::kXchg);
    unsigned char* ds_hi = sm + L::kXchg;
    unsigned char* ds_lo = ds_hi + kBox;
    unsigned char* pt = sm + L::kPt_;
    const uint32_t own0 = smem_addr(sm), own1 = own0 + L::kTile;

    float kb[2];  // warpgroup 0: bias * log2(e) of its two keys; -inf past Nk
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = row0 + 8 * h;
      kb[h] = key >= p.Nk ? -INFINITY : bias ? __ldg(bias + key) * kLog2e : 0.f;
    }
    float dk[kHalf / 2], dv[kHalf / 2];  // columns wg * kHalf..
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(ring.own, 0);
    int stage = 0, parity = 0;
    for (;;) {
      mbar_wait(&ring.full[stage], parity);
      const int it = ring.tile[stage];
      if (it < 0) break;
      const uint32_t qtile = own0 + L::kStage + stage * 2 * L::kTile, dotile = qtile + L::kTile;
      // the thread's 16 queries' terms: + 8 * (i >> 2) + (i & 1)
      const float* cv = ring.terms + stage * kRowTerms + 64 * wg + 2 * t;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      if (wg == 0) {
        scores<kBlk>(s, own0, qtile);
        wg_wait_all();
        fence_regs(s);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = exp2_approx(fmaf(s[i], sc, kb[(i >> 1) & 1]) - cv[8 * (i >> 2) + (i & 1)]);
        put_fragments(xchg, s, tw);
        put_bf16<false>(pt, nullptr, s, warp, g, t);
        fence_proxy_async();
        named_arrive(kBarP, kConsumers);
        named_sync(kBarDs, kConsumers);
        wg_fence();
        times_tile<kHalf>(dv, smem_addr(pt), dotile, 0);
        times_tile<kHalf>(dk, smem_addr(ds_hi), qtile, 0);
        times_tile<kHalf>(dk, smem_addr(ds_lo), qtile, 0);
        wg_commit();
        wg_wait_all();
        fence_regs(dv);
        fence_regs(dk);
        named_sync(kBarDone, kConsumers);
      } else {
        scores<kBlk>(s, own1, dotile);
        wg_wait_all();
        fence_regs(s);
        named_sync(kBarP, kConsumers);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = xchg[i * 128 + tw] * (s[i] - cv[8 * (i >> 2) + (i & 1)]);
        named_sync(kBarWg1, 128);  // every P^T read before dS0^T overwrites it
        put_bf16<true>(ds_hi, ds_lo, s, warp, g, t);
        fence_proxy_async();
        named_arrive(kBarDs, kConsumers);
        wg_fence();
        times_tile<kHalf>(dv, smem_addr(pt), dotile, kHalf);
        times_tile<kHalf>(dk, smem_addr(ds_hi), qtile, kHalf);
        times_tile<kHalf>(dk, smem_addr(ds_lo), qtile, kHalf);
        wg_commit();
        wg_wait_all();
        fence_regs(dv);
        fence_regs(dk);
        named_arrive(kBarDone, kConsumers);
      }
      if (lane == 0) mbar_arrive(&ring.empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }

    const int col0 = wg * kHalf;
    if (S == 1) {
      const long long off = bz * p.dkv_sb + hy * p.dkv_sh;
      store_bf16<kHalf>(p.dk + off, p.dkv_sn, dk, p.scale, row0, p.Nk, col0, p.D, t, p.out_vec);
      store_bf16<kHalf>(p.dv + off, p.dkv_sn, dv, 1.f, row0, p.Nk, col0, p.D, t, p.out_vec);
    } else {
      const long long per = static_cast<long long>(S) * p.B * p.H * p.Nk * Dp;
      float* part = p.dkv_part + (split * p.B * static_cast<long long>(p.H) + bh) * p.Nk * Dp;
      store_f32<kHalf>(part, Dp, dk, row0, p.Nk, col0, t);
      store_f32<kHalf>(part + per, Dp, dv, row0, p.Nk, col0, t);
    }
  }
}

// ------------------------------------------------ Dp = 64: rows a warpgroup
//
// At 64 columns the products are a quarter of those at 256 while the
// elementwise work of a tile is the same, so the exchange above would
// leave the tensor cores idle most of the time. Here each consumer
// warpgroup owns 64 rows of its own (the block 128) and computes S and dP
// (S^T and dP^T) itself, with dQ (dK and dV) over all 64 columns in its
// registers: the two warpgroups share the streamed tiles and run
// independently, one's products overlapping the other's elementwise work.
// Its bf16 dS0, residual (and P^T) go through shared memory of its own.

template <bool kDelta>
__device__ __forceinline__ void query_side_rows(const BwdParams& p) {
  using L = Layout<64, false>;
  constexpr int kOwn = L::kStage;  // Q and dO of both warpgroups, then the ring,
  constexpr int kStageAt = L::kStage;
  constexpr int kMine = L::kXchg;  // then dS0 hi and lo a warpgroup
  unsigned char* sm = aligned_smem();
  Ring ring(sm + L::kBars, sm + L::kTerms);

  const int S = p.splits_q;
  const int qb = blockIdx.x / S, split = blockIdx.x % S;
  const int hy = blockIdx.y, bz = blockIdx.z;
  const long long bh = static_cast<long long>(bz) * p.H + hy;
  const int q0 = 128 * qb;
  const float* lse = p.lse + bh * p.Nq;
  const float* bias = p.bias ? p.bias + bz * p.bias_sb : nullptr;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    regs_down<40>();
    if (threadIdx.x < kConsumers + 32) {
      if (threadIdx.x == kConsumers) {
        mbar_expect_tx(ring.own, kOwn);
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          tma_tile<1>(sm + 2 * w * kBox, &p.tq, ring.own, q0 + 64 * w, hy, bz);
          tma_tile<1>(sm + (2 * w + 1) * kBox, &p.tdo, ring.own, q0 + 64 * w, hy, bz);
        }
      }
      const int lane = threadIdx.x % 32;
      bool set = true;
#pragma unroll
      for (int i = 0; i < 4; ++i) set &= row_set(lse, q0 + lane + 32 * i, p.Nq);
      const bool rows_set = bias != nullptr && __all_sync(0xffffffffu, set);
      produce(
          ring, sm + kStageAt, 2 * kBox, split, S, p.k_tiles,
          [&](int j) { return !(rows_set && key_tile_masked(bias, j, p.Nk)); },
          [&](unsigned char* dst, uint64_t* bar, int j) {
            tma_tile<1>(dst, &p.tk, bar, 64 * j, hy, bz);
            tma_tile<1>(dst + kBox, &p.tv, bar, 64 * j, hy, bz);
          },
          [&](float* terms, int j, int lane_) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int key = 64 * j + lane_ + 32 * h;
              terms[lane_ + 32 * h] =
                  key >= p.Nk ? -INFINITY : bias ? __ldg(bias + key) * kLog2e : 0.f;
            }
          });
    }
  } else {
    regs_up<232>();
    const int wg = threadIdx.x / 128;
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * wg + 16 * warp + g;  // and row0 + 8
    const float sc = p.scale * kLog2e;
    unsigned char* ds_hi = sm + kMine + 2 * kBox * wg;
    unsigned char* ds_lo = ds_hi + kBox;
    const uint32_t own_q = smem_addr(sm) + 2 * kBox * wg, own_do = own_q + kBox;

    float lse2[2], dlt[2] = {0.f, 0.f};
    const long long nstat = static_cast<long long>(S) * p.B * p.H * p.Nq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      lse2[h] = row < p.Nq ? lse[row] * kLog2e : INFINITY;
      if (!kDelta && row < p.Nq) {
        float psum = 0.f, pdp = 0.f;
        for (int s = 0; s < S; ++s) {
          const long long at = (s * p.B * static_cast<long long>(p.H) + bh) * p.Nq + row;
          psum += p.stats[at];
          pdp += p.stats[nstat + at];
        }
        dlt[h] = pdp / psum;
        if (split == 0 && t == 0) p.delta[bh * p.Nq + row] = dlt[h];
      }
    }

    float acc[32];  // dQ, all 64 columns
    float psum[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    mbar_wait(ring.own, 0);
    int stage = 0, parity = 0;
    for (;;) {
      mbar_wait(&ring.full[stage], parity);
      const int j = ring.tile[stage];
      if (j < 0) break;
      const uint32_t kt = smem_addr(sm) + kStageAt + stage * 2 * kBox, vt = kt + kBox;
      const float* kb = ring.terms + stage * kRowTerms + 2 * t;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      scores<1>(s, own_q, kt);
      scores<1>(dp, own_do, vt);
      wg_wait_all();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float pv =
            exp2_approx(fmaf(s[i], sc, kb[8 * (i >> 2) + (i & 1)]) - lse2[(i >> 1) & 1]);
        if constexpr (kDelta) {
          psum[(i >> 1) & 1] += pv;
          pdp[(i >> 1) & 1] += pv * dp[i];
        } else {
          s[i] = pv * (dp[i] - dlt[(i >> 1) & 1]);
        }
      }
      if constexpr (!kDelta) {
        named_sync(kBarP + wg, 128);  // the last tile's products have read dS0
        put_bf16<true>(ds_hi, ds_lo, s, warp, g, t);
        fence_proxy_async();
        named_sync(kBarP + wg, 128);
        wg_fence();
        times_tile<64>(acc, smem_addr(ds_hi), kt, 0);
        times_tile<64>(acc, smem_addr(ds_lo), kt, 0);
        wg_commit();
        wg_wait_all();
        fence_regs(acc);
      }
      if (lane == 0) mbar_arrive(&ring.empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }

    if constexpr (kDelta) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
          psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], x);
          pdp[h] += __shfl_xor_sync(0xffffffffu, pdp[h], x);
        }
        const int row = row0 + 8 * h;
        if (t == 0 && row < p.Nq) {
          const long long at = (split * p.B * static_cast<long long>(p.H) + bh) * p.Nq + row;
          p.stats[at] = psum[h];
          p.stats[nstat + at] = pdp[h];
        }
      }
    } else if (S == 1) {
      store_bf16<64>(p.dq + bz * p.dq_sb + hy * p.dq_sh, p.dq_sn, acc, p.scale, row0, p.Nq, 0,
                     p.D, t, p.out_vec);
    } else {
      float* part = p.dq_part + (split * p.B * static_cast<long long>(p.H) + bh) * p.Nq * 64;
      store_f32<64>(part, 64, acc, row0, p.Nq, 0, t);
    }
  }
}

__device__ __forceinline__ void key_side_rows(const BwdParams& p) {
  using L = Layout<64, true>;
  constexpr int kOwn = L::kStage;  // K and V of both warpgroups, then the ring,
  constexpr int kStageAt = L::kStage;
  constexpr int kMine = L::kXchg;  // then P^T, dS0^T hi and lo a warpgroup
  unsigned char* sm = aligned_smem();
  Ring ring(sm + L::kBars, sm + L::kTerms);

  const int S = p.splits_kv;
  const int kblk = blockIdx.x / S, split = blockIdx.x % S;
  const int hy = blockIdx.y, bz = blockIdx.z;
  const long long bh = static_cast<long long>(bz) * p.H + hy;
  const int k0 = 128 * kblk;
  const float* lse = p.lse + bh * p.Nq;
  const float* delta = p.delta + bh * p.Nq;
  const float* bias = p.bias ? p.bias + bz * p.bias_sb : nullptr;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    regs_down<40>();
    if (threadIdx.x < kConsumers + 32) {
      if (threadIdx.x == kConsumers) {
        mbar_expect_tx(ring.own, kOwn);
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          tma_tile<1>(sm + 2 * w * kBox, &p.tk, ring.own, k0 + 64 * w, hy, bz);
          tma_tile<1>(sm + (2 * w + 1) * kBox, &p.tv, ring.own, k0 + 64 * w, hy, bz);
        }
      }
      const int lane = threadIdx.x % 32;
      bool masked = true;
#pragma unroll
      for (int i = 0; i < 4; ++i) masked &= bias != nullptr && key_masked(bias, k0 + lane + 32 * i, p.Nk);
      const bool keys_masked = __all_sync(0xffffffffu, masked);
      produce(
          ring, sm + kStageAt, 2 * kBox, split, S, p.q_tiles,
          [&](int i) { return !(keys_masked && query_tile_set(lse, i, p.Nq)); },
          [&](unsigned char* dst, uint64_t* bar, int i) {
            tma_tile<1>(dst, &p.tq, bar, 64 * i, hy, bz);
            tma_tile<1>(dst + kBox, &p.tdo, bar, 64 * i, hy, bz);
          },
          [&](float* terms, int i, int lane_) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 64 * i + lane_ + 32 * h;
              const bool in = row < p.Nq;
              terms[lane_ + 32 * h] = in ? __ldg(lse + row) * kLog2e : INFINITY;
              terms[64 + lane_ + 32 * h] = in ? __ldg(delta + row) : 0.f;
            }
          });
    }
  } else {
    regs_up<232>();
    const int wg = threadIdx.x / 128;
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int row0 = k0 + 64 * wg + 16 * warp + g;  // keys row0 and row0 + 8
    const float sc = p.scale * kLog2e;
    unsigned char* pt = sm + kMine + 3 * kBox * wg;
    unsigned char* ds_hi = pt + kBox;
    unsigned char* ds_lo = ds_hi + kBox;
    const uint32_t own_k = smem_addr(sm) + 2 * kBox * wg, own_v = own_k + kBox;

    float kb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = row0 + 8 * h;
      kb[h] = key >= p.Nk ? -INFINITY : bias ? __ldg(bias + key) * kLog2e : 0.f;
    }
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(ring.own, 0);
    int stage = 0, parity = 0;
    for (;;) {
      mbar_wait(&ring.full[stage], parity);
      const int it = ring.tile[stage];
      if (it < 0) break;
      const uint32_t qtile = smem_addr(sm) + kStageAt + stage * 2 * kBox, dotile = qtile + kBox;
      const float* cv = ring.terms + stage * kRowTerms + 2 * t;  // lse; delta at + 64
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      scores<1>(s, own_k, qtile);
      scores<1>(dp, own_v, dotile);
      wg_wait_all();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i >> 2) + (i & 1);
        s[i] = exp2_approx(fmaf(s[i], sc, kb[(i >> 1) & 1]) - cv[c]);
        dp[i] = s[i] * (dp[i] - cv[64 + c]);
      }
      named_sync(kBarP + wg, 128);  // the last tile's products have read P^T and dS0^T
      put_bf16<false>(pt, nullptr, s, warp, g, t);
      put_bf16<true>(ds_hi, ds_lo, dp, warp, g, t);
      fence_proxy_async();
      named_sync(kBarP + wg, 128);
      wg_fence();
      times_tile<64>(dv, smem_addr(pt), dotile, 0);
      times_tile<64>(dk, smem_addr(ds_hi), qtile, 0);
      times_tile<64>(dk, smem_addr(ds_lo), qtile, 0);
      wg_commit();
      wg_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      if (lane == 0) mbar_arrive(&ring.empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }

    if (S == 1) {
      const long long off = bz * p.dkv_sb + hy * p.dkv_sh;
      store_bf16<64>(p.dk + off, p.dkv_sn, dk, p.scale, row0, p.Nk, 0, p.D, t, p.out_vec);
      store_bf16<64>(p.dv + off, p.dkv_sn, dv, 1.f, row0, p.Nk, 0, p.D, t, p.out_vec);
    } else {
      const long long per = static_cast<long long>(S) * p.B * p.H * p.Nk * 64;
      float* part = p.dkv_part + (split * p.B * static_cast<long long>(p.H) + bh) * p.Nk * 64;
      store_f32<64>(part, 64, dk, row0, p.Nk, 0, t);
      store_f32<64>(part + per, 64, dv, row0, p.Nk, 0, t);
    }
  }
}

// The kernels, named by walk so that a profile tells them apart.
template <int Dp>
__global__ void __launch_bounds__(kThreads, 1)
    flash_keybias_bwd_delta(const __grid_constant__ BwdParams p) {
  if constexpr (Dp == 64)
    query_side_rows<true>(p);
  else
    query_side<Dp, true>(p);
}

template <int Dp>
__global__ void __launch_bounds__(kThreads, 1)
    flash_keybias_bwd_dq(const __grid_constant__ BwdParams p) {
  if constexpr (Dp == 64)
    query_side_rows<false>(p);
  else
    query_side<Dp, false>(p);
}

template <int Dp>
__global__ void __launch_bounds__(kThreads, 1)
    flash_keybias_bwd_dkv(const __grid_constant__ BwdParams p) {
  if constexpr (Dp == 64)
    key_side_rows(p);
  else
    key_side<Dp>(p);
}

// out[b, h, row, col] = bf16(scale * sum over s of part[s][b * H + h][row][col]),
// the splits summed in order; one thread an element.
__global__ void __launch_bounds__(256)
    flash_keybias_bwd_reduce(const float* part, int splits, long long split_stride, int H, int N,
                             int D, int Dp, bf16* out, long long sb, long long sh, long long sn,
                             float scale, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int col = static_cast<int>(idx % D);
  const long long rowg = idx / D;  // (b * H + h) * N + row
  const int row = static_cast<int>(rowg % N);
  const long long bh = rowg / N;
  const float* src = part + rowg * Dp + col;
  float x = 0.f;
  for (int s = 0; s < splits; ++s) x += src[s * split_stride];
  out[(bh / H) * sb + (bh % H) * sh + row * sn + col] = __float2bfloat16_rn(x * scale);
}


// ------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map {D, N, H, B} of one bf16 operand (strides in elements, each a
// multiple of 8, the base 16-byte aligned): boxes of 64 x 64, 128-byte
// swizzle, zeros past every edge. A stride of an axis of size 1 is never
// used and is set to a packed one.
bool make_map(CUtensorMap* map, const void* base, long long sb, long long sh, long long sn, int B,
              int H, int N, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const long long given[3] = {sn, sh, sb};
  cuuint64_t strides[3];
  long long packed = (static_cast<long long>(D) * 2 + 15) / 16 * 16;  // bytes
  for (int i = 0; i < 3; ++i) {
    strides[i] = static_cast<cuuint64_t>(dims[i + 1] == 1 ? packed : given[i] * 2);
    packed = static_cast<long long>(strides[i]) * static_cast<long long>(dims[i + 1]);
  }
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int smem, const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int reduce(const float* part, int splits, int BH, int H, int N, int D, int Dp, bf16* out,
           long long sb, long long sh, long long sn, float scale, cudaStream_t stream) {
  const long long total = static_cast<long long>(BH) * N * D;
  const long long split_stride = static_cast<long long>(BH) * N * Dp;
  flash_keybias_bwd_reduce<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      part, splits, split_stride, H, N, D, Dp, out, sb, sh, sn, scale, total);
  return static_cast<int>(cudaGetLastError());
}

// delta walk, dQ walk, dK/dV walk, then the split reductions, in order on
// one stream.
template <int Dp>
int launch_all(const BwdParams& p, cudaStream_t stream) {
  constexpr int kBlockRows = Dp == 64 ? 128 : 64;  // rows of a block's own tiles
  const dim3 q_grid((p.Nq + kBlockRows - 1) / kBlockRows * p.splits_q, p.H, p.B);
  const dim3 k_grid((p.Nk + kBlockRows - 1) / kBlockRows * p.splits_kv, p.H, p.B);
  int err = launch(flash_keybias_bwd_delta<Dp>, q_grid, Layout<Dp, false>::kBytes, p, stream);
  if (err == 0) err = launch(flash_keybias_bwd_dq<Dp>, q_grid, Layout<Dp, false>::kBytes, p, stream);
  if (err == 0) err = launch(flash_keybias_bwd_dkv<Dp>, k_grid, Layout<Dp, true>::kBytes, p, stream);
  const int BH = p.B * p.H;
  if (err == 0 && p.splits_q > 1)
    err = reduce(p.dq_part, p.splits_q, BH, p.H, p.Nq, p.D, Dp, p.dq, p.dq_sb, p.dq_sh, p.dq_sn,
                 p.scale, stream);
  if (err == 0 && p.splits_kv > 1) {
    const long long per = static_cast<long long>(p.splits_kv) * BH * p.Nk * Dp;
    err = reduce(p.dkv_part, p.splits_kv, BH, p.H, p.Nk, p.D, Dp, p.dk, p.dkv_sb, p.dkv_sh,
                 p.dkv_sn, p.scale, stream);
    if (err == 0)
      err = reduce(p.dkv_part + per, p.splits_kv, BH, p.H, p.Nk, p.D, Dp, p.dv, p.dkv_sb,
                   p.dkv_sh, p.dkv_sn, 1.f, stream);
  }
  return err;
}

}  // namespace

// Backward of kernel K6 in bf16: dq [B, H, Nq, D] (strides dq_*), dk and dv
// [B, H, Nk, D] (one stride set, dkv_*) from q, k, v, dout (each with its
// own strides in elements, head dim contiguous; every base 16-byte aligned
// and every stride a multiple of 8 elements, as TMA reads them), the key
// bias of the forward ([B, Nk] fp32 with batch stride bias_sb, or null) and
// the forward's log-sum-exp, fp32 [B * H, Nq]. Scratch from the caller:
// stats fp32 [2, splits_q, B * H, Nq]; delta fp32 [B * H, Nq]; dq_part fp32
// [splits_q, B * H, Nq, Dp] when splits_q > 1, dkv_part fp32 [2, splits_kv,
// B * H, Nk, Dp] when splits_kv > 1, Dp = D rounded up to 64, 128 or 256.
// Launches on `stream` and returns a cudaError_t (0 = every launch made;
// cudaErrorInvalidValue also when a tensor map cannot be made).
extern "C" int saicv_flash_keybias_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
    const float* lse, const float* bias, float* stats, float* delta, float* dq_part,
    float* dkv_part, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh, long long v_sn,
    long long do_sb, long long do_sh, long long do_sn, long long dq_sb, long long dq_sh,
    long long dq_sn, long long dkv_sb, long long dkv_sh, long long dkv_sn, long long bias_sb,
    int B, int H, int Nq, int Nk, int D, int splits_q, int splits_kv, float scale,
    void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Nq < 1 || Nq > (1 << 24) || Nk < 1 ||
      Nk > (1 << 24) || D < 1 || D > 256 || splits_q < 1 || splits_kv < 1 || !lse || !stats ||
      !delta || (splits_q > 1 && !dq_part) || (splits_kv > 1 && !dkv_part))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{};
  if (!make_map(&p.tq, q, q_sb, q_sh, q_sn, B, H, Nq, D) ||
      !make_map(&p.tk, k, k_sb, k_sh, k_sn, B, H, Nk, D) ||
      !make_map(&p.tv, v, v_sb, v_sh, v_sn, B, H, Nk, D) ||
      !make_map(&p.tdo, dout, do_sb, do_sh, do_sn, B, H, Nq, D))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = lse;
  p.bias = bias;
  p.bias_sb = bias_sb;
  p.stats = stats;
  p.delta = delta;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dq_sb = dq_sb;
  p.dq_sh = dq_sh;
  p.dq_sn = dq_sn;
  p.dkv_sb = dkv_sb;
  p.dkv_sh = dkv_sh;
  p.dkv_sn = dkv_sn;
  p.dq_part = dq_part;
  p.dkv_part = dkv_part;
  p.B = B;
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.D = D;
  p.q_tiles = (Nq + 63) / 64;
  p.k_tiles = (Nk + 63) / 64;
  p.splits_q = splits_q;
  p.splits_kv = splits_kv;
  const auto even = [](const void* ptr, long long a, long long b, long long c) {
    return (reinterpret_cast<uintptr_t>(ptr) & 3u) == 0 && a % 2 == 0 && b % 2 == 0 && c % 2 == 0;
  };
  p.out_vec = D % 2 == 0 && even(dq, dq_sb, dq_sh, dq_sn) && even(dk, dkv_sb, dkv_sh, dkv_sn) &&
              even(dv, dkv_sb, dkv_sh, dkv_sn);
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_all<64>(p, s);
  if (D <= 128) return launch_all<128>(p, s);
  return launch_all<256>(p, s);
}
