// Backward of the short-sequence attention kernels without a bias in bf16,
// for Hopper (sm_90a): wgmma products on TMA-fed tiles.
//
// Replaces, for bf16 inputs, the TPU (Pallas) kernels of the JAX package's
// ops/pallas/fused_attention.py:
//   K1  _bwd_kernel_pairs (via _pallas_bwd_pairs, entry
//       fused_attention_dense): packed qkv [B, N, 3C] and dout [B, N, C] ->
//       the packed dqkv, an optional sm_scale;
//   K2  _bwd_kernel (via _pallas_bwd, entry fused_attention): q, k, v, dout
//       [B, H, N, D] through their strides -> dq, dk, dv;
//   K9  _bwd_kernel_packed (via _pallas_bwd_packed, entry
//       fused_attention_qkv): a packed [B, N, 3, H, D] qkv -> the packed
//       dqkv.
// K8's attention core (attn_block.cu) runs it too. q, k, v and dout are
// read in place through 4-D tensor maps {D, N, H, B}, each with its own
// strides; dq, dk and dv are written through one stride set. fp32 inputs
// keep fused_attention.cu's FMA backward, and so do the biased modes (K2b,
// K3, K4) for now: the bias is a template value of both kernels here, of
// which only kNoBias is instantiated.
//
// Math, as the TPU kernels: s = q.k^T * scale in fp32; keys at or past
// n_real get -1e9, padding -inf; P in fp32, normalised, as the forward
// (short_attention_fwd.cu) forms it: P = 2^(logit - lse2), logit = s *
// scale * log2(e), lse2 = max + log2(sum of 2^(logit - max)); dV =
// bf16(P)^T.dO; dP = dO.V^T in fp32; row = sum_k dP * P with the fp32 P
// (not rowsum(dO * O)); dS = P * (dP - row) * scale rounded to bf16; dQ =
// dS.K and dK = dS^T.Q; fp32 accumulation, bf16 outputs. Masked keys get P
// = 0 and so exactly zero dk and dv. Every output row has one owner and no
// sum crosses blocks: no atomics, and two runs give the same bits.
// N <= 1024, D <= 128.
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at ViT-B/16
// (B = 256, N = 197, H = 12, D = 64) a backward reads q, k, v, dout and
// writes dq, dk, dv, 7 * B * N * C * 2 B = 542 MB: 0.162 ms, against the
// five products' 10 * B * H * N^2 * D = 76 GFLOP = 0.077 ms; at ViT-H/14
// (B = 256, H = 16, N = 257, D = 80) 1180 MB, 0.352 ms, against 217 GFLOP =
// 0.219 ms. Bound by bytes.
//
// Design. Two kernels, each a warpgroup (128 threads) a block that owns 64
// rows of one (batch, head), and stages the other two operands' rows of the
// head in shared memory by TMA (the same 4-D maps, 128-byte swizzle, D = 80's
// columns 64-79 in 16-column boxes with the 32-byte swizzle, as the
// forward), the row tiles of a head adjacent in launch order so that the
// staged rows come from L2 after the first block:
//   short_attention_bwd_dq: owns 64 query rows, stages Q and dO tiles and
//     the head's K and V (N <= 264: one box of N rows rounded up to 16, two
//     past 256 rows; 53 KB at ViT-B). S = Q.K^T runs as wgmma m64nNk16 with
//     the whole row in the accumulators (100 registers at N = 197, 132 at
//     257: four chunks of 64 keys and one of 8), so one pass gives the max,
//     the sum, lse2 and P. dP = dO.V^T then runs in 64-key chunks against
//     the resident fp32 P, twice: the first walk sums row, the second forms
//     dS, rounds it to bf16 as a register-A operand (the accumulator layout
//     is the A operand's) and runs dQ += dS.K with K read MN-major. It
//     writes lse2 and row of its rows to a small fp32 scratch [2, B, H, N].
//   short_attention_bwd_dkv: owns 64 key rows, stages its K and V tiles and
//     the head's Q and dO rows, and their lse2 and row; for each chunk of 64
//     queries S^T = K.Q^T and dP^T = V.dO^T on wgmma, P^T = 2^(S^T * scale *
//     log2(e) - lse2[q]) (no row reduction), dS^T = P^T * (dP^T - row[q]) *
//     scale, then dV += bf16(P^T).dO and dK += bf16(dS^T).Q as register-A
//     products, dO and Q read MN-major: nothing is transposed through shared
//     memory.
// Products: S, dP twice and dQ in the first kernel, S^T, dP^T, dV and dK in
// the second: eight of 64 x N x D, where five are the least. The five
// product design (one walk, dQ summed across key tiles) would write dQ
// partial sums in fp32 that at ViT-B outweigh the whole bound (~620 MB
// against 542 MB), so it does not pay at these lengths; keeping dP in
// shared memory instead of computing it again (fp32, 51 KB at N = 197)
// would cost a block of the two an SM that the registers allow.
// Where N > 264 (up to 1024) the same code walks the keys in groups of 256:
// the first kernel takes three passes (online max and sum, row, dS and dQ),
// computing S in each; the second walks the query groups in turn.
// Head dims: the k-steps run over D rounded up to 16, the maps filling the
// columns past D with zeros.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_tiles.cuh"
#include "short_attention.cuh"

namespace saicv {
namespace short_attn {
namespace bwd {

// Byte offsets in a block's dynamic shared memory (1024-byte aligned): the
// block's own two tiles (64 rows), the two staged operands (`rows` rows),
// their column tails (columns 64..), (dK/dV) the staged queries' lse2 and
// row, three mbarriers.
struct Smem {
  int own[2], all[2], own_t[2], all_t[2], stats, bars, bytes;
};

struct BwdParams {
  // the first kernel: own Q and dO, staged K and V; the second: own K and
  // V, staged Q and dO. Boxes of 64 columns (128-byte swizzle) and, for D
  // in (64, 80], of 16 (32-byte swizzle); own 64 rows a box, staged `box`.
  CUtensorMap own[2], own_t[2], all[2], all_t[2];
  float* lse2;  // [B, H, N]: max + log2(sum) of each query row's logits
  float* row;   // [B, H, N]: sum_k dP * P
  bf16 *dq, *dk, *dv;
  long long g_sb, g_sh, g_sn;  // strides of dq, dk and dv
  int N, D, n_real;
  int groups;   // groups of kGroupKeys rows (1: the whole head at once)
  int rows;     // rows of a staged group
  int box;      // rows of a staged box (rows in one or two)
  int narrow;   // the row's last chunk is an 8-wide one (groups == 1)
  int out_vec;  // bf16 pairs of the gradients stored as 32-bit words
  float scale;
  Smem sm;
};

// Thread 0: the block's own two tiles (with_own) on `own_bar`, and rows
// row0.. of the two staged operands, the first on bar_a, the second on
// bar_b (with_b).
template <int kTail>
__device__ __forceinline__ void load_tiles(const BwdParams& p, unsigned char* sm, uint64_t* own_bar,
                                      uint64_t* bar_a, uint64_t* bar_b, int own0, int row0,
                                      bool with_own, bool with_b, int hd, int b) {
  constexpr int kTb = tail_bytes<kTail>();
  if (with_own) {
    mbar_expect_tx(own_bar, 2 * kRows * (128 + kTb));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tma_box(sm + p.sm.own[i], &p.own[i], own_bar, 0, own0, hd, b);
      if (kTail) tma_box(sm + p.sm.own_t[i], kTail == 16 ? &p.own_t[i] : &p.own[i], own_bar, 64,
                         own0, hd, b);
    }
  }
  for (int i = 0; i < (with_b ? 2 : 1); ++i) {
    uint64_t* bar = i == 0 ? bar_a : bar_b;
    mbar_expect_tx(bar, p.rows * (128 + kTb));
    for (int r = 0; r < p.rows; r += p.box) {
      tma_box(sm + p.sm.all[i] + r * 128, &p.all[i], bar, 0, row0 + r, hd, b);
      if (kTail) tma_box(sm + p.sm.all_t[i] + r * kTb, kTail == 16 ? &p.all_t[i] : &p.all[i], bar,
                         64, row0 + r, hd, b);
    }
  }
}

__device__ __forceinline__ void init_bars(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ------------------------------------------------------------- dQ kernel
//
// Block (query tile, head, batch). KC: 64-key chunks of a group (4 when the
// keys go in groups, 5 for 257..264 keys); kLast: keys of the last chunk
// (8, or 64 with the width decided at run time); kTail: the head columns
// past 64 (0, 16 or 64).
template <int KC, int kLast, int kTail, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    short_attention_bwd_dq(const __grid_constant__ BwdParams p) {
  static_assert(MODE == kNoBias, "the biased modes' dbias and drel are not written here yet");
  unsigned char* sm = aligned_smem();
  const int hd = blockIdx.y, b = blockIdx.z;
  const int q0 = kRows * blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + p.sm.bars);  // Q and dO, K, V
  const uint32_t base = smem_addr(sm);
  const uint32_t qa = base + p.sm.own[0], doa = base + p.sm.own[1];
  const uint32_t qta = base + p.sm.own_t[0], dota = base + p.sm.own_t[1];
  const uint32_t ka = base + p.sm.all[0], va = base + p.sm.all[1];
  const uint32_t kta = base + p.sm.all_t[0], vta = base + p.sm.all_t[1];
  init_bars(bars);

  const float sc = p.scale * kLog2e;
  const float masked = kNegInf * kLog2e;
  const int N = p.N, groups = p.groups;

  float s[KC][32];                       // logits, then P
  float dq[32], dq_t[tail_regs<kTail>()];  // dQ, columns 0-63 and 64..
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < tail_regs<kTail>(); ++i) dq_t[i] = 0.f;
  fence_regs(dq);
  fence_regs(dq_t);
  // rows g and g + 8: running max, then lse2; running sum; row
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, row[2] = {0.f, 0.f};
  int k_phase = 0, v_phase = 0;

  // groups == 1: one pass takes the statistics, P is kept, pass 1 sums row
  // and pass 2 forms dS and dQ; groups > 1: pass 0 the online statistics,
  // and S again in each pass
  for (int pass = groups == 1 ? 1 : 0; pass < 3; ++pass) {
    for (int gi = 0; gi < groups; ++gi) {
      const int key0 = gi * kGroupKeys;
      const bool first = gi == 0 && pass == (groups == 1 ? 1 : 0);
      if (first || groups > 1) {  // stage the group's K (and V)
        if (!first) __syncthreads();  // every thread is done with the last group
        if (tid == 0) load_tiles<kTail>(p, sm, bars, bars + 1, bars + 2, q0, key0, first, pass > 0, hd, b);
        mbar_wait(bars + 1, k_phase);
        k_phase ^= 1;
        if (first) mbar_wait(bars, 0);
      }
      if (first || groups > 1) {  // S = Q.K^T -> logits (-> P)
        scores<KC, kLast, kTail>(s, qa, qta, ka, kta, 64);
        wg_wait_all();
#pragma unroll
        for (int c = 0; c < KC; ++c) fence_regs(s[c]);
        plain_logits<KC, kLast>(s, key0, t, N, p.n_real, sc, masked);
        if (pass == 0) {  // online row max and sum
          float mx[2], sum[2];
          row_max<KC, kLast>(s, mx);
#pragma unroll
          for (int h = 0; h < 2; ++h) mx[h] = fmaxf(mx[h], m[h]);
          exp2_rows<KC, kLast>(s, mx, sum);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            l[h] = l[h] * exp2_approx(m[h] - mx[h]) + quad_sum(sum[h]);
            m[h] = mx[h];
          }
          continue;
        }
        if (groups == 1) row_lse2<KC, kLast>(s, m);  // the whole row is here
        // P = 2^(logit - lse2)
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int i = 0; i < regs_of<KC, kLast>(c); ++i)
            s[c][i] = exp2_approx(s[c][i] - m[(i >> 1) & 1]);
        mbar_wait(bars + 2, v_phase);
        v_phase ^= 1;
      }
      // dP = dO.V^T a chunk at a time: pass 1 sums row, pass 2 forms dS and
      // dQ += dS.K
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (key0 + 64 * c >= N) break;
        constexpr bool kNarrow = kLast == 8;  // of the last chunk
        const bool narrow = kNarrow && c + 1 == KC;
        float dp[32];
        wg_fence();
        if (narrow)
          chunk_scores<kTail, 8>(dp, doa, dota, va, vta, 64 * c);
        else
          chunk_scores<kTail, 64>(dp, doa, dota, va, vta, 64 * c);
        wg_wait_all();
        fence_regs(dp);
        if (pass == 1) {
#pragma unroll
          for (int i = 0; i < regs_of<KC, kLast>(c); ++i) row[(i >> 1) & 1] += s[c][i] * dp[i];
          continue;
        }
#pragma unroll
        for (int i = 0; i < regs_of<KC, kLast>(c); ++i)
          dp[i] = s[c][i] * (dp[i] - row[(i >> 1) & 1]) * p.scale;
        uint32_t a[4][4];
        if (narrow) {
          a_fragments<4>(a, dp);
          wg_fence();
          times_rows<kTail, 1>(dq, dq_t, a, ka, kta, 64 * c);
        } else {
          a_fragments<32>(a, dp);
          wg_fence();
          times_rows<kTail, 4>(dq, dq_t, a, ka, kta, 64 * c);
        }
        wg_wait_all();
        fence_regs(dq);
        fence_regs(dq_t);
#pragma unroll
        for (int j = 0; j < 4; ++j) settle(a[j]);  // live until their products are done
      }
    }
    if (pass == 0) {  // fold log2(sum) into the max
#pragma unroll
      for (int h = 0; h < 2; ++h) m[h] += __log2f(l[h]);
    } else if (pass == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) row[h] = quad_sum(row[h]);
    }
  }

  const int row0 = q0 + 16 * warp + g;
  const long long goff = b * p.g_sb + hd * p.g_sh;
  store_bf16<64>(p.dq + goff, p.g_sn, dq, 1.f, row0, N, 0, p.D, t, p.out_vec);
  if constexpr (kTail > 0) store_bf16<kTail>(p.dq + goff, p.g_sn, dq_t, 1.f, row0, N, 64, p.D, t, p.out_vec);
  if (t == 0) {
    const long long at = (static_cast<long long>(b) * gridDim.y + hd) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row0 + 8 * h < N) {
        p.lse2[at + row0 + 8 * h] = m[h];
        p.row[at + row0 + 8 * h] = row[h];
      }
  }
}

// ---------------------------------------------------------- dK/dV kernel
//
// Block (key tile, head, batch): the query groups in turn, 64 queries a
// chunk.
template <int kTail, int MODE>
__global__ void __launch_bounds__(kThreads, kTail == 0 ? 3 : 2)
    short_attention_bwd_dkv(const __grid_constant__ BwdParams p) {
  static_assert(MODE == kNoBias, "the biased modes' dbias and drel are not written here yet");
  unsigned char* sm = aligned_smem();
  const int hd = blockIdx.y, b = blockIdx.z;
  const int k0 = kRows * blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + p.sm.bars);  // K and V, Q, dO
  const uint32_t base = smem_addr(sm);
  const uint32_t ka = base + p.sm.own[0], va = base + p.sm.own[1];
  const uint32_t kta = base + p.sm.own_t[0], vta = base + p.sm.own_t[1];
  const uint32_t qa = base + p.sm.all[0], doa = base + p.sm.all[1];
  const uint32_t qta = base + p.sm.all_t[0], dota = base + p.sm.all_t[1];
  const int rows64 = (p.rows + 63) & ~63;
  float* lse_s = reinterpret_cast<float*>(sm + p.sm.stats);  // [rows64], then row [rows64]
  float* row_s = lse_s + rows64;
  init_bars(bars);

  const float sc = p.scale * kLog2e;
  const int N = p.N;
  const long long at = (static_cast<long long>(b) * gridDim.y + hd) * N;
  const int key_lo = k0 + 16 * warp + g;  // the thread's keys key_lo and key_lo + 8
  const bool live[2] = {key_lo < p.n_real, key_lo + 8 < p.n_real};

  float dk[32], dk_t[tail_regs<kTail>()], dv[32], dv_t[tail_regs<kTail>()];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < tail_regs<kTail>(); ++i) dk_t[i] = dv_t[i] = 0.f;
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(dk_t);
  fence_regs(dv_t);

  // one chunk of queries c0.. of the staged group: 64 wide, or 8 (kWidth) at
  // the end of a row of N = 64k + 1..8
  auto chunk = [&](int c0, auto width) {
    constexpr int kWidth = decltype(width)::value;
    constexpr int kRegs = kWidth / 2;
    float st[32], dpt[32];
    wg_fence();
    chunk_scores<kTail, kWidth>(st, ka, kta, qa, qta, c0);
    chunk_scores<kTail, kWidth>(dpt, va, vta, doa, dota, c0);
    wg_wait_all();
    fence_regs(st);
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < kRegs; ++i) {
      const int ql = c0 + 8 * (i >> 2) + 2 * t + (i & 1);  // query in the group
      const float pt = live[(i >> 1) & 1] ? exp2_approx(st[i] * sc - lse_s[ql]) : 0.f;
      st[i] = pt;
      dpt[i] = pt * (dpt[i] - row_s[ql]) * p.scale;
    }
    uint32_t ap[4][4], ad[4][4];
    a_fragments<kRegs>(ap, st);
    a_fragments<kRegs>(ad, dpt);
    constexpr int kSteps = (kWidth + 15) / 16;
    wg_fence();
    times_rows<kTail, kSteps>(dv, dv_t, ap, doa, dota, c0);
    times_rows<kTail, kSteps>(dk, dk_t, ad, qa, qta, c0);
    wg_wait_all();
    fence_regs(dv);
    fence_regs(dv_t);
    fence_regs(dk);
    fence_regs(dk_t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // live until their products are done
      settle(ap[j]);
      settle(ad[j]);
    }
  };

  for (int gi = 0; gi < p.groups; ++gi) {
    const int qbase = gi * kGroupKeys;
    if (gi > 0) __syncthreads();  // every thread is done with the last group
    if (tid == 0) load_tiles<kTail>(p, sm, bars, bars + 1, bars + 2, k0, qbase, gi == 0, true, hd, b);
    for (int i = tid; i < rows64; i += kThreads) {  // +inf past N: P = 0
      const bool in = qbase + i < N;
      lse_s[i] = in ? p.lse2[at + qbase + i] : INFINITY;
      row_s[i] = in ? p.row[at + qbase + i] : 0.f;
    }
    __syncthreads();
    if (gi == 0) mbar_wait(bars, 0);
    mbar_wait(bars + 1, gi & 1);
    mbar_wait(bars + 2, gi & 1);
    const int queries = p.groups == 1 ? N : min(N - qbase, kGroupKeys);
    // whole chunks, then the narrow one (groups == 1 only)
    const int whole = p.narrow ? queries / 64 : (queries + 63) / 64;
    for (int c = 0; c < whole; ++c) chunk(64 * c, std::integral_constant<int, 64>{});
    if (p.narrow) chunk(64 * whole, std::integral_constant<int, 8>{});
  }

  const long long goff = b * p.g_sb + hd * p.g_sh;
  store_bf16<64>(p.dk + goff, p.g_sn, dk, 1.f, key_lo, N, 0, p.D, t, p.out_vec);
  store_bf16<64>(p.dv + goff, p.g_sn, dv, 1.f, key_lo, N, 0, p.D, t, p.out_vec);
  if constexpr (kTail > 0) {
    store_bf16<kTail>(p.dk + goff, p.g_sn, dk_t, 1.f, key_lo, N, 64, p.D, t, p.out_vec);
    store_bf16<kTail>(p.dv + goff, p.g_sn, dv_t, 1.f, key_lo, N, 64, p.D, t, p.out_vec);
  }
}

// ------------------------------------------------------------- host side

Smem layout(int kTail, int rows, bool stats) {
  const int tail = kTail == 16 ? 32 : kTail == 64 ? 128 : 0;
  Smem s;
  s.own[0] = 0;
  s.own[1] = kRows * 128;
  s.all[0] = 2 * kRows * 128;
  s.all[1] = s.all[0] + rows * 128;
  s.own_t[0] = s.all[1] + rows * 128;
  s.own_t[1] = s.own_t[0] + kRows * tail;
  s.all_t[0] = s.own_t[1] + kRows * tail;
  s.all_t[1] = s.all_t[0] + rows * tail;
  s.stats = s.all_t[1] + rows * tail;
  s.bars = s.stats + (stats ? 2 * ((rows + 63) & ~63) * 4 : 0);
  s.bytes = s.bars + 24;
  return s;
}

template <typename Kernel>
int launch(Kernel kernel, const BwdParams& p, int B, int H, cudaStream_t stream) {
  const int smem = p.sm.bytes + 1024;  // room to align the base to 1024 bytes
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // all of the SM's 228 KB as shared memory, so that two blocks fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((p.N + kRows - 1) / kRows, H, B), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The first kernel at the chunk shape N asks for, as the forward chooses it.
template <int kTail>
int launch_dq(const BwdParams& p, int B, int H, cudaStream_t stream) {
  const int chunks = p.groups > 1 ? 4 : (p.N + 63) / 64;
  if (p.groups == 1 && chunks == 4 && (p.N + 7) / 8 * 8 == 200)  // N = 193..200
    return launch(short_attention_bwd_dq<4, 8, kTail, kNoBias>, p, B, H, stream);
  if constexpr (kTail != 64) {
    if (p.groups == 1 && chunks == 5)  // 257..264 keys
      return launch(short_attention_bwd_dq<5, 8, kTail, kNoBias>, p, B, H, stream);
  }
  switch (chunks) {
    case 1: return launch(short_attention_bwd_dq<1, 64, kTail, kNoBias>, p, B, H, stream);
    case 2: return launch(short_attention_bwd_dq<2, 64, kTail, kNoBias>, p, B, H, stream);
    case 3: return launch(short_attention_bwd_dq<3, 64, kTail, kNoBias>, p, B, H, stream);
    default: return launch(short_attention_bwd_dq<4, 64, kTail, kNoBias>, p, B, H, stream);
  }
}

template <int kTail>
int launch_both(BwdParams& dq, BwdParams& dkv, int B, int H, cudaStream_t stream) {
  dq.sm = layout(kTail, dq.rows, false);
  dkv.sm = layout(kTail, dkv.rows, true);
  const int err = launch_dq<kTail>(dq, B, H, stream);
  return err != 0 ? err : launch(short_attention_bwd_dkv<kTail, kNoBias>, dkv, B, H, stream);
}

// K1, K2, K9 and K8's attention core: dq, dk, dv (`grads`, strides st[12..14])
// from q, k, v and dout (`in`, strides st[0..11]), scratch `stats` fp32 [2, B,
// H, N]; kOnly >= 0: only that tail's kernels. Returns 0 or a cudaError_t.
template <int kOnly = -1>
int run_plain(const void* const (&in)[4], void* const (&grads)[3], float* stats,
              const long long (&st)[15], int B, int H, int N, int D, int n_real, float scale,
              cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || N > kMaxN || D < 1 || D > 128 ||
      n_real < 1 || n_real > N || !stats)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 4; ++i)
    if (!tma_ok(in[i], st[3 * i], st[3 * i + 1], st[3 * i + 2], B, H, N))
      return static_cast<int>(cudaErrorInvalidValue);
  BwdParams dq{};
  // 257..264 keys in one pass where the dQ accumulators leave room (D <= 80)
  const int one_pass = D <= 80 ? kOnePassKeys : kGroupKeys;
  dq.groups = N <= one_pass ? 1 : (N + kGroupKeys - 1) / kGroupKeys;
  // the staged rows cover every chunk's rows: whole chunks of 64, and the
  // 8-wide last chunk (N = 193..200 and 257..264 in the first kernel, N =
  // 64k + 1..8 in the second) rounded up to a 16-row k-step
  const int by64 = (N + 63) / 64 * 64, by16 = (N + 15) / 16 * 16;
  const bool dq_narrow = (N + 7) / 8 * 8 == 200 || (N > 256 && N <= kOnePassKeys);
  dq.rows = dq.groups > 1 ? kGroupKeys : dq_narrow ? by16 : by64;
  dq.box = box_rows(dq.rows);
  dq.lse2 = stats;
  dq.row = stats + static_cast<long long>(B) * H * N;
  dq.dq = static_cast<bf16*>(grads[0]);
  dq.dk = static_cast<bf16*>(grads[1]);
  dq.dv = static_cast<bf16*>(grads[2]);
  dq.g_sb = st[12];
  dq.g_sh = st[13];
  dq.g_sn = st[14];
  dq.N = N;
  dq.D = D;
  dq.n_real = n_real;
  bool even = D % 2 == 0 && st[12] % 2 == 0 && st[13] % 2 == 0 && st[14] % 2 == 0;
  for (int i = 0; i < 3; ++i) even = even && (reinterpret_cast<uintptr_t>(grads[i]) & 3u) == 0;
  dq.out_vec = even;
  dq.scale = scale;
  BwdParams dkv = dq;
  dkv.narrow = dq.groups == 1 && narrow_tail(N);
  dkv.rows = dq.groups > 1 ? kGroupKeys : dkv.narrow ? by16 : by64;
  dkv.box = box_rows(dkv.rows);
  // the first kernel owns q and dout (in[0], in[3]) and stages k and v; the
  // second the other way round
  const int own_dq[2] = {0, 3}, own_dkv[2] = {1, 2};
  for (int i = 0; i < 2; ++i) {
    const int a = own_dq[i], c = own_dkv[i];
    if (!make_maps(&dq.own[i], &dq.own_t[i], in[a], st[3 * a], st[3 * a + 1], st[3 * a + 2], B,
                   H, N, D, kRows) ||
        !make_maps(&dq.all[i], &dq.all_t[i], in[c], st[3 * c], st[3 * c + 1], st[3 * c + 2], B,
                   H, N, D, dq.box) ||
        !make_maps(&dkv.own[i], &dkv.own_t[i], in[c], st[3 * c], st[3 * c + 1], st[3 * c + 2], B,
                   H, N, D, kRows) ||
        !make_maps(&dkv.all[i], &dkv.all_t[i], in[a], st[3 * a], st[3 * a + 1], st[3 * a + 2], B,
                   H, N, D, dkv.box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (kOnly >= 0) {
    return launch_both<kOnly>(dq, dkv, B, H, stream);
  } else {
    if (D <= 64) return launch_both<0>(dq, dkv, B, H, stream);
    if (D <= 80) return launch_both<16>(dq, dkv, B, H, stream);
    return launch_both<64>(dq, dkv, B, H, stream);
  }
}

}  // namespace bwd
}  // namespace short_attn
}  // namespace saicv

// The C entry point; a source that includes this file for its kernels
// (attn_block.cu) defines SAICV_ATTENTION_DEVICE_ONLY.
#ifndef SAICV_ATTENTION_DEVICE_ONLY

// K1, K2, K9 (no bias, bf16): dq, dk, dv (one stride set g_*) from q, k, v
// and dout, each with its own (batch, head, row) strides in elements and a
// contiguous head dim, each readable by TMA (16-byte aligned bases, strides
// multiples of 8 elements on axes longer than 1: the wrapper copies an
// operand that is not); scores scaled by `scale`. `stats` is fp32 scratch
// of 2 * B * H * N elements. Two launches on `stream`; returns a
// cudaError_t (0 = both launched; cudaErrorInvalidValue for a shape, an
// operand or a tensor map the kernels cannot take).
extern "C" int saicv_short_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
    float* stats, long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long do_sb,
    long long do_sh, long long do_sn, long long g_sb, long long g_sh, long long g_sn, int B,
    int H, int N, int D, int n_real, float scale, void* stream) {
  const void* const in[4] = {q, k, v, dout};
  void* const grads[3] = {dq, dk, dv};
  const long long st[15] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh,
                            v_sn, do_sb, do_sh, do_sn, g_sb, g_sh, g_sn};
  return saicv::short_attn::bwd::run_plain(in, grads, stats, st, B, H, N, D, n_real, scale,
                                           static_cast<cudaStream_t>(stream));
}

#endif  // SAICV_ATTENTION_DEVICE_ONLY
