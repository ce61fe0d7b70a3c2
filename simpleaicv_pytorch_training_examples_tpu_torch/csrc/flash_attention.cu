// Streaming (flash) attention with SAM's decomposed relative-position bias
// (kernel K5) and with a per-key bias (kernel K6): the fp32 forward of both,
// K5's bf16 backward and the fp32 backward of both. The bf16 forward of both
// is flash_attention_fwd.cu, K6's bf16 backward flash_keybias_bwd.cu.
//
// Replaces the TPU (Pallas) kernels of the JAX package's
// ops/pallas/flash_attention.py: _fwd_rel_kernel (via _flash_rel_forward,
// entry flash_attention_relpos) for fp32 inputs and _bwd_rel_fused_kernel
// (via _flash_rel_backward; its notes are further down); _fwd_kernel (via
// _flash_forward, entry flash_attention) and _bwd_fused_kernel for fp32
// inputs. q, k, v [B, H, N, D] (K5: one set of strides with the head dim
// contiguous; K6: each its own, Nq queries and Nk keys), rel_h [B, H, N,
// KH] and rel_w [B, H, N, KW] fp32 with N = KH * KW (K5) or an fp32 key
// bias [B, Nk] read through its batch stride and shared by the heads and
// the queries (K6) -> out (its own strides) and the fp32 log-sum-exp of
// every query row, [B * H, Nq]. The score of query i and key j = jh * KW +
// jw is q_i.k_j * scale + rel_h[i, jh] + rel_w[i, jw] (K5), or q_i.k_j *
// sm_scale + bias[j] (K6; keys past Nk get -inf, the bias stays finite, so
// a row whose keys are all masked averages V, as on the TPU); the score
// matrix never leaves the chip.
//
// Math, as the TPU kernels: fp32 scores, one walk over the keys with an
// online row max and sum, the output divided by the sum at the end.
//
// fp32 design (not on the main path): a block of 4 warps owns 16 query rows;
// a lane scores one key of a 32-key tile in plain FMA loops and owns D / 32
// output columns, so fp32 inputs keep fp32 precision. The same bodies with
// the template flag kRel off are K6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace saicv;

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows a block (bf16)
constexpr int kTile = 64;           // keys a pipeline stage (bf16)
constexpr int kChunk = 128;         // output columns a block when D > 128

// Strides in elements (batch, head, row) of one [B, H, N, D] operand.
struct Strides {
  long long b, h, n;
};

struct FlashArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;  // [B * H, Nq]
  Strides qs, ks, vs, os;
  RelPos rel;          // kRel (K5): the decomposed rel-pos bias, Nq = Nk
  const float* kbias;  // !kRel (K6): the key bias [B, Nk] or nullptr
  long long kbias_sb;
  int B, H, Nq, Nk, D;
  float scale;
};

// ------------------------------------------------------- bf16 backward
//
// K5's backward (K6's bf16 backward is flash_keybias_bwd.cu). Two kernels,
// no atomics, every output element written by one thread in a
// fixed order (reproducible bit for bit). Both recompute P = exp(s - lse)
// from the forward's log-sum-exp; delta = rowsum(dO * O) comes from the
// wrapper (one torch op, as the JAX package computes it outside its kernel).
//   dK/dV kernel: a block of 4 warps owns 64 keys (16 a warp, their K and V
//     fragments in registers) and walks the query tiles:
//     S^T = K.Q^T, dP^T = V.dO^T, P^T, dS0^T = P^T * (dP^T - delta), then
//     dV += bf16(P^T).dO and dK += bf16(dS0^T).Q (times the scale at the end).
//   dQ kernel: a block of 4 warps owns 64 query rows and walks the key
//     tiles: S, dP, P, dS0 as above, dQ += bf16(dS0).K; K5 also sums the
//     fp32 dS0 into drel_h and drel_w by the key's grid row and column.
//     With KW = 64 a key tile is one row jh of the key grid: drel_h[i, jh] is
//     the tile's row sum (one store a tile) and a lane's 16 columns of
//     drel_w accumulate in registers over the whole walk, in the forward's
//     layout. Other KW: the warp writes its dS0 tile to shared memory and
//     lane r (r + 16) adds row r's terms into drel_h (drel_w) in device
//     memory, which it alone touches.
// The rel terms of the dK/dV kernel are indexed by query (the columns): with
// KW = 64 the query tile's rel_w rows and its rel_h column jh are staged in
// shared memory with the Q and dO tiles, by cp.async as they are (plain
// loads stored to shared memory ran one after another, each waiting for
// device memory: 22 ms a launch instead of ~5); other KW read them through
// L1.
// dS0 is rounded to bf16 before the products and the scale applied after,
// as the TPU kernel does (K6 carries it at fp32 precision, see
// flash_keybias_bwd.cu). Head dims above 128 run in 128-column output
// chunks that each recompute the scores over the whole head dim; there the
// block's own fragments (K and V, or Q and dO) are read again from shared
// memory for each product instead of being held in registers, which would
// spill.
//
// Bound on one H100 SXM: at SAM-B's global blocks (B=8, H=12, N=4096, D=64)
// the five N x N x D products are 10*B*H*N^2*D = 1.03 TFLOP = 1.04 ms of
// tensor-core time, against 8*B*H*N*D*2 B + the fp32 rel terms and
// statistics = 0.31 GB = 0.09 ms: bound by operations. The two kernels
// compute seven products (S and dP in each).
//
// K6's fp32 backward (off the main path) is the fp32 pair further down
// with the rel-pos flag off; it takes delta = rowsum(dO * O) from its fp32
// output through the wrapper.

struct FlashBwdArgs {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  const float *lse, *delta;  // [B * H, Nq] each; lse in natural log
  Strides qs, ks, vs, dos;   // the inputs
  Strides dqs, dkvs;         // dq; dk and dv (one set)
  RelPos rel;                // kRel (K5): Nq = Nk
  RelGrad drel;
  const float* kbias;  // fp32 K6: the key bias [B, Nk] or nullptr
  long long kbias_sb;
  int B, H, Nq, Nk, D;
  float scale;
  int q_vec, k_vec, v_vec, do_vec, out_vec;
  int rel_vec;           // rel_w rows 16-byte aligned
  int q_tiles, k_tiles;  // 64-row tiles of the queries, of the keys
};

constexpr int kDsLD = kTile + 1;  // row stride of a warp's fp32 dS0 tile

template <int DQ, int DV>
__device__ __forceinline__ void flash_bwd_dkv_bf16(const FlashBwdArgs& a) {
  constexpr int LDQ = DQ + 8;
  constexpr int QT = DQ <= 64 ? 64 : 32;  // queries a step (registers)
  constexpr int kFrags = QT / 8;
  constexpr int LDW = kTile + 4;  // staged rel_w rows: conflict-free reads
  constexpr bool kReload = DQ > 128;
  const int Nq = a.Nq, Nk = a.Nk;
  const float sc = a.scale * kLog2e;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ko = reinterpret_cast<bf16*>(smem);  // own keys [kRows][LDQ]
  bf16* Vo = Ko + kRows * LDQ;               // own values [kRows][LDQ]
  bf16* Qs = Vo + kRows * LDQ;               // [2][QT][LDQ]
  bf16* dOs = Qs + 2 * QT * LDQ;             // [2][QT][LDQ]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * QT * LDQ);  // [2][QT]
  float* delta_s = lse_s + 2 * QT;                               // [2][QT]
  float* relh_s = delta_s + 2 * QT;                              // [2][QT]
  float* relw_s = relh_s + 2 * QT;                               // [2][QT][LDW]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int chunk = blockIdx.x / a.k_tiles;
  const int k0 = (blockIdx.x % a.k_tiles) * kRows;
  const int dv0 = chunk * kChunk;
  const int dv = min(DV, a.D - dv0);
  const int bz = blockIdx.z, hy = blockIdx.y;
  const bf16* qh = static_cast<const bf16*>(a.q) + bz * a.qs.b + hy * a.qs.h;
  const bf16* doh = static_cast<const bf16*>(a.dout) + bz * a.dos.b + hy * a.dos.h;
  const long long stat_off = (static_cast<long long>(bz) * a.H + hy) * Nq;
  const int KW = a.rel.KW;
  const bool grid_row = KW == kTile;  // the block's 64 keys: one key-grid row
  const int key_jh = k0 / KW;
  const float* relh = a.rel.h + bz * a.rel.h_sb + hy * a.rel.h_sh;
  const float* relw = a.rel.w + bz * a.rel.w_sb + hy * a.rel.w_sh;

  const int row0 = k0 + 16 * warp;  // this warp's first key row
  const bool active = row0 < Nk;
  int jh[2], jw[2];  // key-grid row and column of the lane's two keys
#pragma unroll
  for (int r = 0; r < 2; ++r)
    col_split(min(row0 + g + 8 * r, Nk - 1), a.rel.inv_kw, KW, jh[r], jw[r]);

  const int qtiles = (Nq + QT - 1) / QT;
  auto issue = [&](int tile) {
    const int buf = tile & 1;
    const int q0 = tile * QT;
    const long long off = static_cast<long long>(q0);
    load_tile_bf16<DQ, LDQ>(Qs + buf * QT * LDQ, qh + off * a.qs.n, a.qs.n, QT, Nq - q0, a.D,
                            a.q_vec);
    load_tile_bf16<DQ, LDQ>(dOs + buf * QT * LDQ, doh + off * a.dos.n, a.dos.n, QT, Nq - q0,
                            a.D, a.do_vec);
    // the tile's statistics and rel terms, asynchronously as the tiles
    for (int i = threadIdx.x; i < QT; i += blockDim.x) {
      const bool valid = q0 + i < Nq;
      const long long row = valid ? q0 + i : 0;
      cp_async4(lse_s + buf * QT + i, a.lse + stat_off + row, valid);
      cp_async4(delta_s + buf * QT + i, a.delta + stat_off + row, valid);
      if (grid_row) cp_async4(relh_s + buf * QT + i, relh + row * a.rel.h_sn + key_jh, valid);
    }
    if (grid_row) {
      const int per_row = a.rel_vec ? kTile / 4 : kTile;
      for (int i = threadIdx.x; i < QT * per_row; i += blockDim.x) {
        const int r = i / per_row;
        const bool valid = q0 + r < Nq;
        const float* src = relw + (valid ? q0 + r : 0) * a.rel.w_sn;
        float* dst = relw_s + (buf * QT + r) * LDW;
        if (a.rel_vec)
          cp_async16(dst + 4 * (i % per_row), src + 4 * (i % per_row), valid);
        else
          cp_async4(dst + i % per_row, src + i % per_row, valid);
      }
    }
  };

  load_tile_bf16<DQ, LDQ>(
      Ko, static_cast<const bf16*>(a.k) + bz * a.ks.b + hy * a.ks.h + k0 * a.ks.n, a.ks.n,
      kRows, Nk - k0, a.D, a.k_vec);
  load_tile_bf16<DQ, LDQ>(
      Vo, static_cast<const bf16*>(a.v) + bz * a.vs.b + hy * a.vs.h + k0 * a.vs.n, a.vs.n,
      kRows, Nk - k0, a.D, a.v_vec);
  issue(0);
  cp_async_commit();

  uint32_t kf[DQ / 16][4], vf[kReload ? 1 : DQ / 16][4];
  float dk[DV / 8][4], dvacc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dvacc[j][0] = dvacc[j][1] = dvacc[j][2] = dvacc[j][3] = 0.f;
  }

  for (int tile = 0; tile < qtiles; ++tile) {
    if (tile + 1 < qtiles) issue(tile + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if constexpr (!kReload) {
      if (tile == 0 && active) {
        load_a_frags<DQ, LDQ>(kf, Ko + 16 * warp * LDQ, g, t);
        load_a_frags<DQ, LDQ>(vf, Vo + 16 * warp * LDQ, g, t);
      }
    }
    if (active) {
      const int buf = tile & 1;
      const int qt = tile * QT;
      const bf16* Qb = Qs + buf * QT * LDQ;
      const bf16* dOb = dOs + buf * QT * LDQ;
      float st[kFrags][4], dpt[kFrags][4];  // S^T, dP^T: rows keys, columns queries
      if constexpr (kReload) {
        load_a_frags<DQ, LDQ>(kf, Ko + 16 * warp * LDQ, g, t);
        own_times_other_t<DQ, LDQ, kFrags>(st, kf, Qb, qt, Nq, lane);
        load_a_frags<DQ, LDQ>(kf, Vo + 16 * warp * LDQ, g, t);
        own_times_other_t<DQ, LDQ, kFrags>(dpt, kf, dOb, qt, Nq, lane);
      } else {
        own_times_other_t<DQ, LDQ, kFrags>(st, kf, Qb, qt, Nq, lane);
        own_times_other_t<DQ, LDQ, kFrags>(dpt, vf, dOb, qt, Nq, lane);
      }
#pragma unroll
      for (int j = 0; j < kFrags; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * j + 2 * t + (e & 1);
          const int qi = qt + ql;
          const int r = e >> 1;
          float bias;  // rel_h + rel_w of (query qi, this key)
          if (grid_row) {
            bias = relh_s[buf * QT + ql] + relw_s[(buf * QT + ql) * LDW + jw[r]];
          } else {
            const int qc = min(qi, Nq - 1);
            bias = __ldg(relh + qc * a.rel.h_sn + jh[r]) + __ldg(relw + qc * a.rel.w_sn + jw[r]);
          }
          // log2-domain exponent of P
          const float logit = fmaf(st[j][e], sc, (bias - lse_s[buf * QT + ql]) * kLog2e);
          const float p = qi < Nq ? exp2_approx(logit) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - delta_s[buf * QT + ql]);
        }
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        if (qt + 16 * kk >= Nq) break;
        const float* p0 = st[2 * kk];
        const float* p1 = st[2 * kk + 1];
        const uint32_t pf[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                                pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
        accumulate_ax<DV, LDQ>(dvacc, pf, dOb + 16 * kk * LDQ + dv0, lane);
        const float* d0 = dpt[2 * kk];
        const float* d1 = dpt[2 * kk + 1];
        const uint32_t df[4] = {pack_bf16(d0[0], d0[1]), pack_bf16(d0[2], d0[3]),
                                pack_bf16(d1[0], d1[1]), pack_bf16(d1[2], d1[3])};
        accumulate_ax<DV, LDQ>(dk, df, Qb + 16 * kk * LDQ + dv0, lane);
      }
    }
    __syncthreads();  // this tile's buffers are free for tile + 2
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] *= a.scale;
  const long long out_off = bz * a.dkvs.b + hy * a.dkvs.h + dv0;
  store_rows_bf16<DV>(static_cast<bf16*>(a.dk) + out_off, a.dkvs.n, dk, row0, Nk, dv, g, t,
                      a.out_vec);
  store_rows_bf16<DV>(static_cast<bf16*>(a.dv) + out_off, a.dkvs.n, dvacc, row0, Nk, dv, g, t,
                      a.out_vec);
}

template <int DQ, int DV>
__device__ __forceinline__ void flash_bwd_dq_bf16(const FlashBwdArgs& a) {
  constexpr int LDQ = DQ + 8;
  constexpr int kFrags = kTile / 8;
  constexpr bool kReload = DQ > 128;
  const int Nq = a.Nq, Nk = a.Nk;
  const float sc = a.scale * kLog2e;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kRows][LDQ]
  bf16* dOs = Qs + kRows * LDQ;              // [kRows][LDQ]
  bf16* Ks = dOs + kRows * LDQ;              // [2][kTile][LDQ]
  bf16* Vs = Ks + 2 * kTile * LDQ;           // [2][kTile][LDQ]
  float* ds_s = reinterpret_cast<float*>(Vs + 2 * kTile * LDQ);  // [kWarps][16][kDsLD]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int chunk = blockIdx.x / a.q_tiles;
  const int q0 = (blockIdx.x % a.q_tiles) * kRows;
  const int dv0 = chunk * kChunk;
  const int dv = min(DV, a.D - dv0);
  const int bz = blockIdx.z, hy = blockIdx.y;
  const bf16* kh = static_cast<const bf16*>(a.k) + bz * a.ks.b + hy * a.ks.h;
  const bf16* vh = static_cast<const bf16*>(a.v) + bz * a.vs.b + hy * a.vs.h;
  const long long stat_off = (static_cast<long long>(bz) * a.H + hy) * Nq;

  const int tiles = (Nk + kTile - 1) / kTile;
  auto issue = [&](int tile) {
    const int buf = tile & 1;
    const long long key0 = static_cast<long long>(tile) * kTile;
    load_tile_bf16<DQ, LDQ>(Ks + buf * kTile * LDQ, kh + key0 * a.ks.n, a.ks.n, kTile,
                            Nk - tile * kTile, a.D, a.k_vec);
    load_tile_bf16<DQ, LDQ>(Vs + buf * kTile * LDQ, vh + key0 * a.vs.n, a.vs.n, kTile,
                            Nk - tile * kTile, a.D, a.v_vec);
  };
  load_tile_bf16<DQ, LDQ>(
      Qs, static_cast<const bf16*>(a.q) + bz * a.qs.b + hy * a.qs.h + q0 * a.qs.n, a.qs.n,
      kRows, Nq - q0, a.D, a.q_vec);
  load_tile_bf16<DQ, LDQ>(
      dOs, static_cast<const bf16*>(a.dout) + bz * a.dos.b + hy * a.dos.h + q0 * a.dos.n,
      a.dos.n, kRows, Nq - q0, a.D, a.do_vec);
  issue(0);
  cp_async_commit();

  const int row0 = q0 + 16 * warp;
  const bool active = row0 < Nq;
  const bool drel = chunk == 0;  // one chunk writes drel
  const RelRows rr = a.rel.rows(bz, hy, row0 + g, Nq);
  const int KW = a.rel.KW;
  const bool grid_row = KW == kTile;  // each key tile: one key-grid row
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(row0 + g + 8 * r, Nq - 1);
    lse2[r] = a.lse[stat_off + row] * kLog2e;
    delta[r] = a.delta[stat_off + row];
  }
  float rwc[2][kFrags][2], rw_acc[2][kFrags][2];  // KW = 64: rel_w * log2(e), drel_w
  if (grid_row) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < kFrags; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          rwc[r][j][h2] = __ldg(rr.w[r] + 8 * j + 2 * t + h2) * kLog2e;
          rw_acc[r][j][h2] = 0.f;
        }
  }
  float* ds_w = ds_s + warp * 16 * kDsLD;

  uint32_t qf[DQ / 16][4], dof[kReload ? 1 : DQ / 16][4];
  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) issue(tile + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if constexpr (!kReload) {
      if (tile == 0 && active) {
        load_a_frags<DQ, LDQ>(qf, Qs + 16 * warp * LDQ, g, t);
        load_a_frags<DQ, LDQ>(dof, dOs + 16 * warp * LDQ, g, t);
      }
    }
    if (active) {
      const int key0 = tile * kTile;
      const bf16* Kb = Ks + (tile & 1) * kTile * LDQ;
      const bf16* Vb = Vs + (tile & 1) * kTile * LDQ;
      float s[kFrags][4], dp[kFrags][4];
      if constexpr (kReload) {
        load_a_frags<DQ, LDQ>(qf, Qs + 16 * warp * LDQ, g, t);
        own_times_other_t<DQ, LDQ, kFrags>(s, qf, Kb, key0, Nk, lane);
        load_a_frags<DQ, LDQ>(qf, dOs + 16 * warp * LDQ, g, t);
        own_times_other_t<DQ, LDQ, kFrags>(dp, qf, Vb, key0, Nk, lane);
      } else {
        own_times_other_t<DQ, LDQ, kFrags>(s, qf, Kb, key0, Nk, lane);
        own_times_other_t<DQ, LDQ, kFrags>(dp, dof, Vb, key0, Nk, lane);
      }
      const int tile_jh = key0 / KW;
      if (grid_row) {  // N is a multiple of 64 here: no key past N
        const float bh[2] = {__ldg(rr.h[0] + tile_jh) * kLog2e,
                             __ldg(rr.h[1] + tile_jh) * kLog2e};
#pragma unroll
        for (int j = 0; j < kFrags; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = fmaf(s[j][e], sc, bh[e >> 1] + rwc[e >> 1][j][e & 1]);
      } else {
        rel_logits(s, rr, key0, t, Nk, Nk, sc, -INFINITY, KW, a.rel.inv_kw);
      }
      // dS0 = P * (dP - delta), P = 2^(logit - lse * log2(e))
#pragma unroll
      for (int j = 0; j < kFrags; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = exp2_approx(s[j][e] - lse2[e >> 1]) * (dp[j][e] - delta[e >> 1]);
      if (drel && grid_row) {
        float hsum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kFrags; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hsum[e >> 1] += s[j][e];
            rw_acc[e >> 1][j][e & 1] += s[j][e];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          hsum[r] += __shfl_xor_sync(0xffffffffu, hsum[r], 1);
          hsum[r] += __shfl_xor_sync(0xffffffffu, hsum[r], 2);
          const int row = row0 + g + 8 * r;
          if (t == 0 && row < Nq) a.drel.h_row(bz, hy, row)[tile_jh] = hsum[r];
        }
      } else if (drel) {
#pragma unroll
        for (int j = 0; j < kFrags; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds_w[(g + 8 * (e >> 1)) * kDsLD + 8 * j + 2 * t + (e & 1)] = s[j][e];
        __syncwarp();
        const int r = lane & 15;
        const int row = row0 + r;
        if (row < Nq) {
          float* h_row = a.drel.h_row(bz, hy, row);
          float* w_row = a.drel.w_row(bz, hy, row);
          const int cols = min(kTile, Nk - key0);
          int run_jh = -1;
          float run = 0.f;
          for (int jj = 0; jj < cols; ++jj) {
            int jh, jw;
            col_split(key0 + jj, a.rel.inv_kw, KW, jh, jw);
            const float x = ds_w[r * kDsLD + jj];
            if (lane >= 16) {
              w_row[jw] += x;
            } else {
              if (jh != run_jh) {
                if (run_jh >= 0) h_row[run_jh] += run;
                run_jh = jh;
                run = 0.f;
              }
              run += x;
            }
          }
          if (lane < 16 && run_jh >= 0) h_row[run_jh] += run;
        }
        __syncwarp();
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        if (key0 + 16 * kk >= Nk) break;
        const float* s0 = s[2 * kk];
        const float* s1 = s[2 * kk + 1];
        const uint32_t af[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s0[2], s0[3]),
                                pack_bf16(s1[0], s1[1]), pack_bf16(s1[2], s1[3])};
        accumulate_ax<DV, LDQ>(acc, af, Kb + 16 * kk * LDQ + dv0, lane);
      }
    }
    __syncthreads();  // this tile's buffers are free for tile + 2
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= a.scale;
  bf16* dqh = static_cast<bf16*>(a.dq) + bz * a.dqs.b + hy * a.dqs.h + dv0;
  store_rows_bf16<DV>(dqh, a.dqs.n, acc, row0, Nq, dv, g, t, a.out_vec);
  if (drel && grid_row) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= Nq) continue;
      float* w_row = a.drel.w_row(bz, hy, row);
#pragma unroll
      for (int j = 0; j < kFrags; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) w_row[8 * j + 2 * t + h2] = rw_acc[r][j][h2];
    }
  }
}

template <int DQ, int DV>
__global__ void __launch_bounds__(32 * kWarps) flash_relpos_bwd_dkv_bf16(FlashBwdArgs a) {
  flash_bwd_dkv_bf16<DQ, DV>(a);
}

template <int DQ, int DV>
__global__ void __launch_bounds__(32 * kWarps) flash_relpos_bwd_dq_bf16(FlashBwdArgs a) {
  flash_bwd_dq_bf16<DQ, DV>(a);
}


// ------------------------------------------------------------- fp32 path

constexpr int kRowsF = 16;  // query rows a block
constexpr int kTileF = 32;  // keys a tile, one a lane

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows rows of one head (row stride sn) -> shared [rows][LD], zero past
// nvalid and D
__device__ void load_rows_f32(float* dst, const float* src, long long sn, int rows,
                              int nvalid, int D, int LD) {
  for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
    const int r = i / LD;
    const int c = i % LD;
    dst[i] = (r < nvalid && c < D) ? src[r * sn + c] : 0.f;
  }
}

// DC = output columns a lane (D <= 32 * DC)
template <int DC, bool kRel>
__device__ __forceinline__ void flash_fwd_f32(const FlashArgs& a) {
  constexpr int LD = 32 * DC + 1;  // odd stride: a lane a bank
  constexpr int kPerWarp = kRowsF / kWarps;
  const int Nq = a.Nq, Nk = a.Nk, D = a.D;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kRowsF][LD]
  float* Ks = Qs + kRowsF * LD;                // [kTileF][LD]
  float* Vs = Ks + kTileF * LD;                // [kTileF][LD]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRowsF;
  const int bz = blockIdx.z, hy = blockIdx.y;
  const float* qh = static_cast<const float*>(a.q) + bz * a.qs.b + hy * a.qs.h;
  const float* kh = static_cast<const float*>(a.k) + bz * a.ks.b + hy * a.ks.h;
  const float* vh = static_cast<const float*>(a.v) + bz * a.vs.b + hy * a.vs.h;
  const float* kbias = a.kbias ? a.kbias + bz * a.kbias_sb : nullptr;

  load_rows_f32(Qs, qh + q0 * a.qs.n, a.qs.n, kRowsF, Nq - q0, D, LD);
  float m[kPerWarp], l[kPerWarp], acc[kPerWarp][DC];
  RelRows rr[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    if constexpr (kRel) rr[i] = a.rel.rows(bz, hy, q0 + warp * kPerWarp + i, Nq);
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int key0 = 0; key0 < Nk; key0 += kTileF) {
    __syncthreads();
    load_rows_f32(Ks, kh + key0 * a.ks.n, a.ks.n, kTileF, Nk - key0, D, LD);
    load_rows_f32(Vs, vh + key0 * a.vs.n, a.vs.n, kTileF, Nk - key0, D, LD);
    __syncthreads();
    const int col = key0 + lane;
    int jh = 0, jw = 0;
    float kb = 0.f;  // K6: this lane's key bias
    if constexpr (kRel) {
      if (col < Nk) col_split(col, a.rel.inv_kw, a.rel.KW, jh, jw);
    } else {
      if (col < Nk && kbias) kb = kbias[col];
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const float* qr = Qs + (warp * kPerWarp + i) * LD;
      const float* kr = Ks + lane * LD;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      if constexpr (kRel) kb = rr[i].h[0][jh] + rr[i].w[0][jw];
      s = col < Nk ? s * a.scale + kb : -INFINITY;
      const float mnew = fmaxf(m[i], warp_max(s));
      const float alpha = expf(m[i] - mnew);
      const float p = expf(s - mnew);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float x = acc[i][c] * alpha;
        for (int j = 0; j < kTileF; ++j)
          x = fmaf(__shfl_sync(0xffffffffu, p, j), Vs[j * LD + lane + 32 * c], x);
        acc[i][c] = x;
      }
    }
  }

  const long long lse_base = (static_cast<long long>(bz) * a.H + hy) * Nq;
  float* oh = static_cast<float*>(a.o) + bz * a.os.b + hy * a.os.h;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int row = q0 + warp * kPerWarp + i;
    if (row >= Nq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (lane + 32 * c < D) oh[row * a.os.n + lane + 32 * c] = acc[i][c] / l[i];
    if (lane == 0) a.lse[lse_base + row] = m[i] + logf(l[i]);
  }
}

template <int DC>
__global__ void __launch_bounds__(32 * kWarps) flash_relpos_fwd_f32(FlashArgs a) {
  flash_fwd_f32<DC, true>(a);
}

template <int DC>
__global__ void __launch_bounds__(32 * kWarps) flash_keybias_fwd_f32(FlashArgs a) {
  flash_fwd_f32<DC, false>(a);
}

// fp32 backward (not on the main path), in the forward's fp32 layout: a
// block of 4 warps owns 16 rows (4 a warp), a lane takes one query or key of
// a 32-wide tile and owns D / 32 output columns. K5's drel goes through a
// warp's tile of dS0 in shared memory: lane r (r + 4) adds row r's terms
// into drel_h (drel_w) in device memory, in key order. K6 (kRel off) takes
// the key bias of each key instead, and keys past Nk get P = 0.

// DC = output columns a lane (D <= 32 * DC)
template <int DC, bool kRel>
__device__ __forceinline__ void flash_bwd_dkv_f32(const FlashBwdArgs& a) {
  constexpr int LD = 32 * DC + 1;
  constexpr int kPerWarp = kRowsF / kWarps;
  const int Nq = a.Nq, Nk = a.Nk, D = a.D;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ko = reinterpret_cast<float*>(smem);  // own keys [kRowsF][LD]
  float* Vo = Ko + kRowsF * LD;                // own values [kRowsF][LD]
  float* Qs = Vo + kRowsF * LD;                // [kTileF][LD]
  float* dOs = Qs + kTileF * LD;               // [kTileF][LD]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kRowsF;
  const int bz = blockIdx.z, hy = blockIdx.y;
  const float* qh = static_cast<const float*>(a.q) + bz * a.qs.b + hy * a.qs.h;
  const float* doh = static_cast<const float*>(a.dout) + bz * a.dos.b + hy * a.dos.h;
  const long long stat_off = (static_cast<long long>(bz) * a.H + hy) * Nq;
  const float* relh = kRel ? a.rel.h + bz * a.rel.h_sb + hy * a.rel.h_sh : nullptr;
  const float* relw = kRel ? a.rel.w + bz * a.rel.w_sb + hy * a.rel.w_sh : nullptr;

  load_rows_f32(Ko, static_cast<const float*>(a.k) + bz * a.ks.b + hy * a.ks.h + k0 * a.ks.n,
                a.ks.n, kRowsF, Nk - k0, D, LD);
  load_rows_f32(Vo, static_cast<const float*>(a.v) + bz * a.vs.b + hy * a.vs.h + k0 * a.vs.n,
                a.vs.n, kRowsF, Nk - k0, D, LD);
  int jh[kPerWarp], jw[kPerWarp];
  float kb[kPerWarp];  // K6: the key's bias
  float dk[kPerWarp][DC], dv[kPerWarp][DC];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int key = min(k0 + warp * kPerWarp + i, Nk - 1);
    jh[i] = jw[i] = 0;
    kb[i] = 0.f;
    if constexpr (kRel)
      col_split(key, a.rel.inv_kw, a.rel.KW, jh[i], jw[i]);
    else if (a.kbias)
      kb[i] = a.kbias[bz * a.kbias_sb + key];
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  for (int q0 = 0; q0 < Nq; q0 += kTileF) {
    __syncthreads();
    load_rows_f32(Qs, qh + q0 * a.qs.n, a.qs.n, kTileF, Nq - q0, D, LD);
    load_rows_f32(dOs, doh + q0 * a.dos.n, a.dos.n, kTileF, Nq - q0, D, LD);
    __syncthreads();
    const int qi = q0 + lane;
    const bool valid = qi < Nq;
    const int qc = min(qi, Nq - 1);
    const float lse = a.lse[stat_off + qc];
    const float delta = a.delta[stat_off + qc];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const float* kr = Ko + (warp * kPerWarp + i) * LD;
      const float* vr = Vo + (warp * kPerWarp + i) * LD;
      const float* qr = Qs + lane * LD;
      const float* dor = dOs + lane * LD;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(dor[d], vr[d], dp);
      }
      float bias = kb[i];
      if constexpr (kRel)
        bias = relh[qc * a.rel.h_sn + jh[i]] + relw[qc * a.rel.w_sn + jw[i]];
      const float p = valid ? expf(s * a.scale + bias - lse) : 0.f;
      const float ds0 = p * (dp - delta);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float xv = dv[i][c], xk = dk[i][c];
        for (int j = 0; j < kTileF; ++j) {
          xv = fmaf(__shfl_sync(0xffffffffu, p, j), dOs[j * LD + lane + 32 * c], xv);
          xk = fmaf(__shfl_sync(0xffffffffu, ds0, j), Qs[j * LD + lane + 32 * c], xk);
        }
        dv[i][c] = xv;
        dk[i][c] = xk;
      }
    }
  }

  const long long out_off = bz * a.dkvs.b + hy * a.dkvs.h;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int row = k0 + warp * kPerWarp + i;
    if (row >= Nk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = lane + 32 * c;
      if (col >= D) continue;
      static_cast<float*>(a.dk)[out_off + row * a.dkvs.n + col] = dk[i][c] * a.scale;
      static_cast<float*>(a.dv)[out_off + row * a.dkvs.n + col] = dv[i][c];
    }
  }
}

template <int DC, bool kRel>
__device__ __forceinline__ void flash_bwd_dq_f32(const FlashBwdArgs& a) {
  constexpr int LD = 32 * DC + 1;
  constexpr int kPerWarp = kRowsF / kWarps;
  const int Nq = a.Nq, Nk = a.Nk, D = a.D;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kRowsF][LD]
  float* dOs = Qs + kRowsF * LD;               // [kRowsF][LD]
  float* Ks = dOs + kRowsF * LD;               // [kTileF][LD]
  float* Vs = Ks + kTileF * LD;                // [kTileF][LD]
  float* ds_s = Vs + kTileF * LD;              // [kWarps][kPerWarp][kTileF]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRowsF;
  const int bz = blockIdx.z, hy = blockIdx.y;
  const float* kh = static_cast<const float*>(a.k) + bz * a.ks.b + hy * a.ks.h;
  const float* vh = static_cast<const float*>(a.v) + bz * a.vs.b + hy * a.vs.h;
  const long long stat_off = (static_cast<long long>(bz) * a.H + hy) * Nq;
  const float* kbias = !kRel && a.kbias ? a.kbias + bz * a.kbias_sb : nullptr;

  load_rows_f32(Qs, static_cast<const float*>(a.q) + bz * a.qs.b + hy * a.qs.h + q0 * a.qs.n,
                a.qs.n, kRowsF, Nq - q0, D, LD);
  load_rows_f32(dOs,
                static_cast<const float*>(a.dout) + bz * a.dos.b + hy * a.dos.h + q0 * a.dos.n,
                a.dos.n, kRowsF, Nq - q0, D, LD);
  float acc[kPerWarp][DC], lse[kPerWarp], delta[kPerWarp];
  RelRows rr[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int row = min(q0 + warp * kPerWarp + i, Nq - 1);
    lse[i] = a.lse[stat_off + row];
    delta[i] = a.delta[stat_off + row];
    if constexpr (kRel) rr[i] = a.rel.rows(bz, hy, row, Nq);
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  float* ds_w = ds_s + warp * kPerWarp * kTileF;

  for (int key0 = 0; key0 < Nk; key0 += kTileF) {
    __syncthreads();
    load_rows_f32(Ks, kh + key0 * a.ks.n, a.ks.n, kTileF, Nk - key0, D, LD);
    load_rows_f32(Vs, vh + key0 * a.vs.n, a.vs.n, kTileF, Nk - key0, D, LD);
    __syncthreads();
    const int col = key0 + lane;
    int jh = 0, jw = 0;
    float kb = 0.f;  // K6: this lane's key bias
    if constexpr (kRel) {
      if (col < Nk) col_split(col, a.rel.inv_kw, a.rel.KW, jh, jw);
    } else {
      if (col < Nk && kbias) kb = kbias[col];
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const float* qr = Qs + (warp * kPerWarp + i) * LD;
      const float* dor = dOs + (warp * kPerWarp + i) * LD;
      const float* kr = Ks + lane * LD;
      const float* vr = Vs + lane * LD;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(dor[d], vr[d], dp);
      }
      if constexpr (kRel) kb = rr[i].h[0][jh] + rr[i].w[0][jw];
      const float p = col < Nk ? expf(s * a.scale + kb - lse[i]) : 0.f;
      const float ds0 = p * (dp - delta[i]);
      if constexpr (kRel) ds_w[i * kTileF + lane] = ds0;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float x = acc[i][c];
        for (int j = 0; j < kTileF; ++j)
          x = fmaf(__shfl_sync(0xffffffffu, ds0, j), Ks[j * LD + lane + 32 * c], x);
        acc[i][c] = x;
      }
    }
    if constexpr (kRel) {
      __syncwarp();
      if (lane < 2 * kPerWarp) {  // lane i: row i's drel_h; lane kPerWarp + i: drel_w
        const int i = lane % kPerWarp;
        const int row = q0 + warp * kPerWarp + i;
        if (row < Nq) {
          float* h_row = a.drel.h_row(bz, hy, row);
          float* w_row = a.drel.w_row(bz, hy, row);
          const int cols = min(kTileF, Nk - key0);
          int run_jh = -1;
          float run = 0.f;
          for (int jj = 0; jj < cols; ++jj) {
            int kh_, kw_;
            col_split(key0 + jj, a.rel.inv_kw, a.rel.KW, kh_, kw_);
            const float x = ds_w[i * kTileF + jj];
            if (lane >= kPerWarp) {
              w_row[kw_] += x;
            } else {
              if (kh_ != run_jh) {
                if (run_jh >= 0) h_row[run_jh] += run;
                run_jh = kh_;
                run = 0.f;
              }
              run += x;
            }
          }
          if (lane < kPerWarp && run_jh >= 0) h_row[run_jh] += run;
        }
      }
      __syncwarp();
    }
  }

  float* dqh = static_cast<float*>(a.dq) + bz * a.dqs.b + hy * a.dqs.h;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int row = q0 + warp * kPerWarp + i;
    if (row >= Nq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (lane + 32 * c < D) dqh[row * a.dqs.n + lane + 32 * c] = acc[i][c] * a.scale;
  }
}

template <int DC>
__global__ void __launch_bounds__(32 * kWarps) flash_relpos_bwd_dkv_f32(FlashBwdArgs a) {
  flash_bwd_dkv_f32<DC, true>(a);
}

template <int DC>
__global__ void __launch_bounds__(32 * kWarps) flash_relpos_bwd_dq_f32(FlashBwdArgs a) {
  flash_bwd_dq_f32<DC, true>(a);
}

template <int DC>
__global__ void __launch_bounds__(32 * kWarps) flash_keybias_bwd_dkv_f32(FlashBwdArgs a) {
  flash_bwd_dkv_f32<DC, false>(a);
}

template <int DC>
__global__ void __launch_bounds__(32 * kWarps) flash_keybias_bwd_dq_f32(FlashBwdArgs a) {
  flash_bwd_dq_f32<DC, false>(a);
}


// ------------------------------------------------------------- launchers

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const FlashArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DC, bool kRel>
int launch_f32(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kRowsF + 2 * kTileF) * (32 * DC + 1);
  const dim3 grid((a.Nq + kRowsF - 1) / kRowsF, a.H, a.B);
  if constexpr (kRel) return launch(flash_relpos_fwd_f32<DC>, grid, smem, a, stream);
  return launch(flash_keybias_fwd_f32<DC>, grid, smem, a, stream);
}

// The forward of either entry point in fp32, by head dim (bf16 is
// flash_attention_fwd.cu: cudaErrorInvalidValue here).
template <bool kRel>
int launch_fwd(const FlashArgs& a, int is_bf16, cudaStream_t s) {
  if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  switch ((a.D + 31) / 32) {
    case 1: return launch_f32<1, kRel>(a, s);
    case 2: return launch_f32<2, kRel>(a, s);
    case 3: return launch_f32<3, kRel>(a, s);
    case 4: return launch_f32<4, kRel>(a, s);
    case 5: return launch_f32<5, kRel>(a, s);
    case 6: return launch_f32<6, kRel>(a, s);
    case 7: return launch_f32<7, kRel>(a, s);
    default: return launch_f32<8, kRel>(a, s);
  }
}

template <typename Kernel>
int launch_bwd(Kernel kernel, dim3 grid, size_t smem, const FlashBwdArgs& a,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DQ, int DV>
int launch_bwd_bf16(FlashBwdArgs a, cudaStream_t stream) {
  constexpr int QT = DQ <= 64 ? 64 : 32;
  a.q_tiles = (a.Nq + kRows - 1) / kRows;
  a.k_tiles = (a.Nk + kRows - 1) / kRows;
  const int chunks = (a.D + kChunk - 1) / kChunk;
  const size_t dkv_smem = sizeof(bf16) * (2 * kRows + 4 * QT) * (DQ + 8) +
                          sizeof(float) * (6 * QT + 2 * QT * (kTile + 4));
  const size_t dq_smem = sizeof(bf16) * (2 * kRows + 4 * kTile) * (DQ + 8) +
                         sizeof(float) * kWarps * 16 * kDsLD;
  const dim3 dkv_grid(a.k_tiles * chunks, a.H, a.B), dq_grid(a.q_tiles * chunks, a.H, a.B);
  const int err = launch_bwd(flash_relpos_bwd_dkv_bf16<DQ, DV>, dkv_grid, dkv_smem, a, stream);
  if (err != 0) return err;
  return launch_bwd(flash_relpos_bwd_dq_bf16<DQ, DV>, dq_grid, dq_smem, a, stream);
}

template <int DC, bool kRel>
int launch_bwd_f32(const FlashBwdArgs& a, cudaStream_t stream) {
  const dim3 dkv_grid((a.Nk + kRowsF - 1) / kRowsF, a.H, a.B);
  const dim3 dq_grid((a.Nq + kRowsF - 1) / kRowsF, a.H, a.B);
  const size_t dkv_smem = sizeof(float) * (2 * kRowsF + 2 * kTileF) * (32 * DC + 1);
  const size_t dq_smem = sizeof(float) * ((2 * kRowsF + 2 * kTileF) * (32 * DC + 1) +
                                          kRowsF * kTileF);
  int err;
  if constexpr (kRel)
    err = launch_bwd(flash_relpos_bwd_dkv_f32<DC>, dkv_grid, dkv_smem, a, stream);
  else
    err = launch_bwd(flash_keybias_bwd_dkv_f32<DC>, dkv_grid, dkv_smem, a, stream);
  if (err != 0) return err;
  if constexpr (kRel) return launch_bwd(flash_relpos_bwd_dq_f32<DC>, dq_grid, dq_smem, a, stream);
  return launch_bwd(flash_keybias_bwd_dq_f32<DC>, dq_grid, dq_smem, a, stream);
}

// The backward of either entry point, by dtype and head dim, as launch_fwd;
// bf16 only for K5 (K6's bf16 backward is flash_keybias_bwd.cu).
template <bool kRel>
int launch_bwd_all(const FlashBwdArgs& a, int is_bf16, cudaStream_t s) {
  if (!is_bf16) {
    switch ((a.D + 31) / 32) {
      case 1: return launch_bwd_f32<1, kRel>(a, s);
      case 2: return launch_bwd_f32<2, kRel>(a, s);
      case 3: return launch_bwd_f32<3, kRel>(a, s);
      case 4: return launch_bwd_f32<4, kRel>(a, s);
      case 5: return launch_bwd_f32<5, kRel>(a, s);
      case 6: return launch_bwd_f32<6, kRel>(a, s);
      case 7: return launch_bwd_f32<7, kRel>(a, s);
      default: return launch_bwd_f32<8, kRel>(a, s);
    }
  }
  if constexpr (!kRel) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    switch ((a.D + 15) / 16 * 16) {
      case 16: return launch_bwd_bf16<16, 16>(a, s);
      case 32: return launch_bwd_bf16<32, 32>(a, s);
      case 48: return launch_bwd_bf16<48, 48>(a, s);
      case 64: return launch_bwd_bf16<64, 64>(a, s);
      case 80: return launch_bwd_bf16<80, 80>(a, s);
      case 96: return launch_bwd_bf16<96, 96>(a, s);
      case 112: return launch_bwd_bf16<112, 112>(a, s);
      case 128: return launch_bwd_bf16<128, 128>(a, s);
      default: return launch_bwd_bf16<256, kChunk>(a, s);  // chunked output columns
    }
  }
}


bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Rows of D elements of es bytes, at these strides, can be copied 16 bytes
// at a time (given a 16-byte aligned base).
bool rows_vec(const Strides& st, int D, long long es) {
  return (D * es) % 16 == 0 && (st.b * es) % 16 == 0 && (st.h * es) % 16 == 0 &&
         (st.n * es) % 16 == 0;
}

// bf16 output pairs can be stored as 32-bit words.
bool out_vec(const void* o, const Strides& st, int D) {
  return (reinterpret_cast<uintptr_t>(o) & 3u) == 0 && D % 2 == 0 && st.b % 2 == 0 &&
         st.h % 2 == 0 && st.n % 2 == 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes. q, k, v and o are device pointers
// of the input dtype (is_bf16 = 0: float32; bf16 is flash_attention_fwd.cu
// and returns cudaErrorInvalidValue here); lse, rel_h and rel_w are fp32.
// Strides are in elements, (batch, head, row); the last axis of every
// tensor is contiguous. Returns a cudaError_t (0 = launched).
extern "C" int saicv_flash_attention_relpos_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, const float* rel_h,
    const float* rel_w, long long in_sb, long long in_sh, long long in_sn, long long out_sb,
    long long out_sh, long long out_sn, long long h_sb, long long h_sh, long long h_sn,
    long long w_sb, long long w_sh, long long w_sn, int B, int H, int N, int D, int KH, int KW,
    float scale, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || N > (1 << 20) || D < 1 ||
      D > 256 || KH < 1 || KW < 1 || static_cast<long long>(KH) * KW != N || !rel_h ||
      !rel_w || !lse)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides in{in_sb, in_sh, in_sn};
  FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.qs = a.ks = a.vs = in;
  a.os = Strides{out_sb, out_sh, out_sn};
  a.rel = RelPos{rel_h, rel_w, h_sb, h_sh, h_sn, w_sb, w_sh, w_sn, KH, KW, 1.f / KW};
  a.B = B;
  a.H = H;
  a.Nq = a.Nk = N;
  a.D = D;
  a.scale = scale;
  return launch_fwd<true>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

// Kernel K6: q [B, H, Nq, D], k and v [B, H, Nk, D] and o [B, H, Nq, D],
// each with its own (batch, head, row) strides in elements and the head dim
// contiguous, fp32 (is_bf16 = 0; bf16 is flash_attention_fwd.cu and
// returns cudaErrorInvalidValue here); bias: the fp32 key bias [B, Nk] with
// batch stride bias_sb and the keys contiguous, or null; lse: fp32 [B * H,
// Nq]. Returns a cudaError_t (0 = launched).
extern "C" int saicv_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, const float* bias,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long out_sb,
    long long out_sh, long long out_sn, long long bias_sb, int B, int H, int Nq, int Nk, int D,
    float scale, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Nq < 1 || Nq > (1 << 24) || Nk < 1 ||
      Nk > (1 << 24) || D < 1 || D > 256 || !lse)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.qs = Strides{q_sb, q_sh, q_sn};
  a.ks = Strides{k_sb, k_sh, k_sn};
  a.vs = Strides{v_sb, v_sh, v_sn};
  a.os = Strides{out_sb, out_sh, out_sn};
  a.kbias = bias;
  a.kbias_sb = bias_sb;
  a.B = B;
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.D = D;
  a.scale = scale;
  return launch_fwd<false>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

// Backward of the same function: dq, dk, dv (one stride set, head dim
// contiguous; the input dtype) and drel_h, drel_w (fp32, the shapes of
// rel_h and rel_w, their own strides; zero-filled by the caller unless KW =
// 64, where every element is written) from q, k, v (one stride set), dout
// (its own strides), rel_h, rel_w, and the forward's log-sum-exp and delta
// = rowsum(dout * out), both fp32 [B * H, N]. Two launches on `stream`;
// returns a cudaError_t (0 = both launched).
extern "C" int saicv_flash_attention_relpos_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
    void* dv, const float* lse, const float* delta, const float* rel_h, const float* rel_w,
    float* drel_h, float* drel_w, long long in_sb, long long in_sh, long long in_sn,
    long long do_sb, long long do_sh, long long do_sn, long long out_sb, long long out_sh,
    long long out_sn, long long h_sb, long long h_sh, long long h_sn, long long w_sb,
    long long w_sh, long long w_sn, long long dh_sb, long long dh_sh, long long dh_sn,
    long long dw_sb, long long dw_sh, long long dw_sn, int B, int H, int N, int D, int KH,
    int KW, float scale, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || N > (1 << 20) || D < 1 ||
      D > 256 || KH < 1 || KW < 1 || static_cast<long long>(KH) * KW != N || !rel_h ||
      !rel_w || !drel_h || !drel_w || !lse || !delta)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long es = is_bf16 ? 2 : 4;
  const Strides in{in_sb, in_sh, in_sn}, out{out_sb, out_sh, out_sn};
  FlashBwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = lse;
  a.delta = delta;
  a.qs = a.ks = a.vs = in;
  a.dos = Strides{do_sb, do_sh, do_sn};
  a.dqs = a.dkvs = out;
  a.rel = RelPos{rel_h, rel_w, h_sb, h_sh, h_sn, w_sb, w_sh, w_sn, KH, KW, 1.f / KW};
  a.drel = RelGrad{drel_h, drel_w, dh_sb, dh_sh, dh_sn, dw_sb, dw_sh, dw_sn};
  a.B = B;
  a.H = H;
  a.Nq = a.Nk = N;
  a.D = D;
  a.scale = scale;
  a.q_vec = a.k_vec = a.v_vec =
      aligned16(q) && aligned16(k) && aligned16(v) && rows_vec(in, D, es);
  a.do_vec = aligned16(dout) && rows_vec(a.dos, D, es);
  a.out_vec = out_vec(dq, out, D) && out_vec(dk, out, D) && out_vec(dv, out, D);
  a.rel_vec = aligned16(rel_w) && w_sb % 4 == 0 && w_sh % 4 == 0 && w_sn % 4 == 0;
  return launch_bwd_all<true>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

// Backward of kernel K6 in fp32 (is_bf16 = 0; bf16 is flash_keybias_bwd.cu
// and returns cudaErrorInvalidValue here): dq [B, H, Nq, D] (strides dq_*),
// dk and dv [B, H, Nk, D] (one stride set, dkv_*), from q, k, v and dout
// (each with its own strides, head dim contiguous), the key bias of the
// forward ([B, Nk] fp32 with batch stride bias_sb, or null), the forward's
// log-sum-exp and delta = rowsum(dout * out), fp32 [B * H, Nq] each. The
// bias gets no gradient. Two launches on `stream`; returns a cudaError_t
// (0 = both launched).
extern "C" int saicv_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
    void* dv, const float* lse, const float* delta, const float* bias, long long q_sb,
    long long q_sh, long long q_sn, long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn, long long do_sb, long long do_sh,
    long long do_sn, long long dq_sb, long long dq_sh, long long dq_sn, long long dkv_sb,
    long long dkv_sh, long long dkv_sn, long long bias_sb, int B, int H, int Nq, int Nk,
    int D, float scale, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Nq < 1 || Nq > (1 << 24) || Nk < 1 ||
      Nk > (1 << 24) || D < 1 || D > 256 || !lse || !delta)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long es = is_bf16 ? 2 : 4;
  FlashBwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = lse;
  a.delta = delta;
  a.qs = Strides{q_sb, q_sh, q_sn};
  a.ks = Strides{k_sb, k_sh, k_sn};
  a.vs = Strides{v_sb, v_sh, v_sn};
  a.dos = Strides{do_sb, do_sh, do_sn};
  a.dqs = Strides{dq_sb, dq_sh, dq_sn};
  a.dkvs = Strides{dkv_sb, dkv_sh, dkv_sn};
  a.kbias = bias;
  a.kbias_sb = bias_sb;
  a.B = B;
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.D = D;
  a.scale = scale;
  a.q_vec = aligned16(q) && rows_vec(a.qs, D, es);
  a.k_vec = aligned16(k) && rows_vec(a.ks, D, es);
  a.v_vec = aligned16(v) && rows_vec(a.vs, D, es);
  a.do_vec = aligned16(dout) && rows_vec(a.dos, D, es);
  a.out_vec = out_vec(dq, a.dqs, D) && out_vec(dk, a.dkvs, D) && out_vec(dv, a.dkvs, D);
  return launch_bwd_all<false>(a, is_bf16, static_cast<cudaStream_t>(stream));
}
