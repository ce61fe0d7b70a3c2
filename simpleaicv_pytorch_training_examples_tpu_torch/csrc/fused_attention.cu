// Short-sequence fused self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels of the JAX package's
// ops/pallas/fused_attention.py:
//   K1  _fwd_kernel_pairs (via _pallas_fwd_pairs, entry fused_attention_dense):
//       packed qkv [B, N, 3C] (column order [3, H, D]) -> out [B, N, C];
//   K2  _fwd_kernel (via _pallas_fwd, entry fused_attention):
//       q, k, v, out [B, H, N, D].
// One kernel body per dtype serves both: the wrapper passes the (batch,
// head, row) strides of the inputs and of the output, and each head's
// columns are read in place from either layout (no layout copies).
//
// Math, as the TPU kernels: s = q.k^T * scale in fp32; keys at or past
// n_real get -1e9 (not -inf); softmax over the whole row in fp32; P is
// normalised, then cast to the input dtype; P.V accumulates in fp32 and the
// output is written in the input dtype. N <= 1024, D <= 128.
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the ViT-B/16
// eval shape (B=256, N=197, H=12, D=64, bf16) one launch reads 232 MB of qkv
// and writes 77 MB, 92 us of memory time, against 30.5 GFLOP = 31 us of
// tensor-core time: the kernel is bound by bytes. At the ViT-H/14 shape
// (B=256, H=16, N=257, D=80) it moves 4 x 256*16*257*80*2 B = 674 MB, 201 us,
// against 4*B*H*N^2*D = 86.6 GFLOP = 88 us: bound by bytes as well.
//
// bf16 design: one warp per 16 query rows, the head's row tiles split
// evenly over the fewest blocks of at most 8 warps (ViT-B/16: 13 tiles, two
// blocks of 7 warps), scores in registers (mma.sync m16n8k16, fp32
// accumulation). The block copies K and V of its head into shared memory
// once with cp.async (V landing while the first pass runs); a head too
// large for that streams 64-key tiles through a two-stage pipeline. Two
// passes over the keys: the first keeps each row's running max and sum
// (online softmax), the second recomputes the scores, forms P = exp(s - max)
// / sum, casts it to bf16 and multiplies it by V. P is thus normalised
// before its cast, as on the TPU, and the score matrix never leaves the
// registers. exp runs as one FFMA and one ex2.approx per score, with the
// scale and 1/sum folded in: P differs from the plain version's in the last
// fp32 bits, far below its bf16 rounding. The head dim is zero-padded to a
// multiple of 16 in shared memory and every tile masks its ragged edge
// (N = 197 and 257 are not multiples of 16; D = 80 is not a power of two).
//
// What bounds it now (diagnostic builds, H100): the copies from L2 and the
// Q.K^T products, which the second pass repeats; the softmax arithmetic and
// P.V cost little beside them.
//
// fp32 design (not on the main path): one block per 32 query rows keeps
// the whole fp32 score row in shared memory and uses plain FMA loops, so
// fp32 inputs keep full fp32 precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1024;
constexpr float kNegInf = -1e9f;  // _NEG_INF of the TPU kernels

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

// ------------------------------------------------------------ bf16 path

constexpr int kMaxWarps = 8;   // one warp per 16 query rows, up to 8 a block
constexpr int kKeyTile = 64;   // keys per pipeline stage
// K and V of a whole head stay in shared memory when Q, K and V fit in this
// budget (ViT-B/16's and ViT-H/14's heads do); larger heads stream through
// the two-stage pipeline.
constexpr int kResidentBytes = 160000;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 2^x on the special-function unit (~2 ulp; 0 for -inf and below -126).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Start copying `rows` rows of one head (row stride `sn`, D contiguous
// elements) into shared memory [rows][LD]; rows at or past `nvalid` and
// columns at or past D become zero. With vec (16-byte aligned rows, D % 8
// == 0) the copy is asynchronous; otherwise it is done here element-wise.
template <int DP, int LD>
__device__ void load_tile_bf16(bf16* dst, const bf16* src, long long sn, int rows,
                               int nvalid, int D, bool vec) {
  if (vec) {
    constexpr int kVecPerRow = DP / 8;
    for (int i = threadIdx.x; i < rows * kVecPerRow; i += blockDim.x) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const bool valid = r < nvalid && c < D;
      cp_async16(dst + r * LD + c, valid ? src + r * sn + c : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += blockDim.x) {
      const int r = i / DP;
      const int c = i % DP;
      dst[r * LD + c] = (r < nvalid && c < D) ? src[r * sn + c] : __float2bfloat16_rn(0.f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(32 * kMaxWarps)
attention_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   long long in_sb, long long in_sh, long long in_sn,
                   long long out_sb, long long out_sh, long long out_sn,
                   int N, int D, int n_real, float scale, int vec, int out_vec,
                   int resident) {
  constexpr int LD = DP + 8;       // 16-byte pad: conflict-free fragment loads
  // exp(s*scale - max) = 2^(s*c - max*log2 e): one FFMA and one ex2 per score
  const float sc = scale * 1.4426950408889634f;
  const float masked_raw = kNegInf / sc;  // raw score that scales to -1e9
  constexpr int kSteps = DP / 16;  // k-steps of Q.K^T
  constexpr int kOutTiles = DP / 8;
  constexpr int kKeyFrags = kKeyTile / 8;

  extern __shared__ __align__(128) unsigned char smem[];
  // Q [rows][LD]; K and V each [NP][LD] when resident, else
  // [2][kKeyTile][LD] (two pipeline stages)
  const int rows = 16 * (blockDim.x / 32);  // query rows of this block
  const int NP = (N + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + rows * LD;
  bf16* Vs = Ks + (resident ? NP : 2 * kKeyTile) * LD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and +8)
  const int t = lane % 4;  // fragment column pair
  const int q0 = blockIdx.x * rows;
  const long long in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const bf16* qh = q + in_off;
  const bf16* kh = k + in_off;
  const bf16* vh = v + in_off;
  bf16* oh = o + blockIdx.z * out_sb + blockIdx.y * out_sh;

  const int tiles = (N + kKeyTile - 1) / kKeyTile;
  const int steps = 2 * tiles;  // pass 1: K tiles; pass 2: K and V tiles
  auto issue = [&](int step) {
    const int tile = step < tiles ? step : step - tiles;
    const int buf = step & 1;
    const long long off = static_cast<long long>(tile) * kKeyTile * in_sn;
    load_tile_bf16<DP, LD>(Ks + buf * kKeyTile * LD, kh + off, in_sn, kKeyTile,
                           N - tile * kKeyTile, D, vec);
    if (step >= tiles)
      load_tile_bf16<DP, LD>(Vs + buf * kKeyTile * LD, vh + off, in_sn, kKeyTile,
                             N - tile * kKeyTile, D, vec);
  };

  load_tile_bf16<DP, LD>(Qs, qh + q0 * in_sn, in_sn, rows, N - q0, D, vec);
  if (resident) {  // two groups: Q and all of K, then all of V
    load_tile_bf16<DP, LD>(Ks, kh, in_sn, NP, N, D, vec);
    cp_async_commit();
    load_tile_bf16<DP, LD>(Vs, vh, in_sn, NP, N, D, vec);
  } else {
    issue(0);
  }
  cp_async_commit();

  const int row0 = q0 + 16 * warp;  // this warp's first query row
  const bool active = row0 < N;
  uint32_t qf[kSteps][4];
  // rows g and g+8: running max of s*c, then max + log2(sum); sum per lane
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kOutTiles][4];
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int step = 0; step < steps; ++step) {
    if (!resident) {
      if (step + 1 < steps) issue(step + 1);
      cp_async_commit();  // one group per step, possibly empty
      cp_async_wait_one();
      __syncthreads();
    } else if (step == 0) {  // Q and K have landed
      cp_async_wait_one();
      __syncthreads();
    } else if (step == tiles) {  // V has landed
      cp_async_wait_all();
      __syncthreads();
    }

    if (step == 0 && active) {
      const bf16* qw = Qs + 16 * warp * LD;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        qf[ks][0] = ld_u32(qw + g * LD + 16 * ks + 2 * t);
        qf[ks][1] = ld_u32(qw + (g + 8) * LD + 16 * ks + 2 * t);
        qf[ks][2] = ld_u32(qw + g * LD + 16 * ks + 8 + 2 * t);
        qf[ks][3] = ld_u32(qw + (g + 8) * LD + 16 * ks + 8 + 2 * t);
      }
    }

    if (active) {
      const int tile = step < tiles ? step : step - tiles;
      const int key0 = tile * kKeyTile;
      const bf16* Kb = Ks + (resident ? key0 : (step & 1) * kKeyTile) * LD;
      float s[kKeyFrags][4];
#pragma unroll
      for (int j = 0; j < kKeyFrags; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        if (key0 + 8 * j < N) {
          const bf16* kr = Kb + (8 * j + g) * LD + 2 * t;
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks)
            mma_16816(s[j], qf[ks], ld_u32(kr + 16 * ks), ld_u32(kr + 16 * ks + 8));
        }
        if (key0 + kKeyTile > n_real) {  // edge tile: mask padding and n_real
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = key0 + 8 * j + 2 * t + (e & 1);
            s[j][e] = col >= N ? -INFINITY : (col >= n_real ? masked_raw : s[j][e]);
          }
        }
      }

      if (step < tiles) {  // pass 1: online row max and sum
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < kKeyFrags; ++j)
            tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          const float mnew = fmaxf(m[r], tmax * sc);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kKeyFrags; ++j)
            if (key0 + 8 * j < N)
              sum += exp2_approx(fmaf(s[j][2 * r], sc, -mnew)) +
                     exp2_approx(fmaf(s[j][2 * r + 1], sc, -mnew));
          l[r] = l[r] * exp2_approx(m[r] - mnew) + sum;
          m[r] = mnew;
        }
        if (step == tiles - 1) {  // row sums over the quad; fold 1/sum into m
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            m[r] += __log2f(l[r]);
          }
        }
      } else {  // pass 2: P = 2^(s*c - max - log2 sum) in bf16, O += P.V
        const bf16* Vb = Vs + (resident ? key0 : (step & 1) * kKeyTile) * LD;
#pragma unroll
        for (int kk = 0; kk < kKeyTile / 16; ++kk) {
          if (key0 + 16 * kk >= N) break;
          const float* s0 = s[2 * kk];
          const float* s1 = s[2 * kk + 1];
          uint32_t a[4];
          a[0] = pack_bf16(exp2_approx(fmaf(s0[0], sc, -m[0])), exp2_approx(fmaf(s0[1], sc, -m[0])));
          a[1] = pack_bf16(exp2_approx(fmaf(s0[2], sc, -m[1])), exp2_approx(fmaf(s0[3], sc, -m[1])));
          a[2] = pack_bf16(exp2_approx(fmaf(s1[0], sc, -m[0])), exp2_approx(fmaf(s1[1], sc, -m[0])));
          a[3] = pack_bf16(exp2_approx(fmaf(s1[2], sc, -m[1])), exp2_approx(fmaf(s1[3], sc, -m[1])));
          // lane -> row of one of four 8x8 matrices: keys +0/+8, dims +0/+8
          const int mi = lane / 8;
          const bf16* vrow = Vb + (16 * kk + (mi & 1) * 8 + lane % 8) * LD + (mi >> 1) * 8;
#pragma unroll
          for (int e2 = 0; e2 < kOutTiles / 2; ++e2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vrow + 16 * e2);
            mma_16816(acc[2 * e2], a, b[0], b[1]);
            mma_16816(acc[2 * e2 + 1], a, b[2], b[3]);
          }
        }
      }
    }
    if (!resident) __syncthreads();  // this step's buffers are free for step + 2
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= N) continue;
      bf16* dst = oh + row * out_sn + c;
      if (out_vec) {  // D even, 4-byte aligned rows: one bf16x2 store
        if (c < D)
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        if (c < D) dst[0] = __float2bfloat16_rn(acc[j][2 * r]);
        if (c + 1 < D) dst[1] = __float2bfloat16_rn(acc[j][2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------- fp32 path

constexpr int kQTile = 32;   // query rows per block
constexpr int kKChunk = 64;  // keys staged in shared memory at a time
constexpr int kPadF = 1;     // row padding (floats) against bank conflicts

// Row stride (floats) of the score rows.
__host__ __device__ inline int score_stride(int N) { return ((N + 31) & ~31) + 4; }

// Copy `rows` rows into shared memory [rows][LD], zero past nvalid / D.
template <int DP, int LD>
__device__ void load_rows_f32(float* dst, const float* src, long long sn, int rows,
                              int nvalid, int D) {
  for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i % DP;
    dst[r * LD + c] = (r < nvalid && c < D) ? src[r * sn + c] : 0.f;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  long long in_sb, long long in_sh, long long in_sn,
                  long long out_sb, long long out_sh, long long out_sn,
                  int N, int D, int n_real, float scale) {
  constexpr int LD = DP + kPadF;
  constexpr int kPer = kMaxN / 32;
  const int NP = (N + 15) & ~15;
  const int LDS = score_stride(N);
  const int q0 = blockIdx.x * kQTile;
  const long long in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const float* qh = q + in_off;
  const float* kh = k + in_off;
  const float* vh = v + in_off;
  float* oh = o + blockIdx.z * out_sb + blockIdx.y * out_sh;

  extern __shared__ __align__(128) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);  // [kQTile][LDS]
  float* Qs = S + kQTile * LDS;               // [kQTile][LD]
  float* KVs = Qs + kQTile * LD;              // [kKChunk][LD]

  load_rows_f32<DP, LD>(Qs, qh + q0 * in_sn, in_sn, kQTile, N - q0, D);
  for (int c0 = 0; c0 < NP; c0 += kKChunk) {  // raw scores, chunk by chunk
    const int cols = min(kKChunk, NP - c0);
    __syncthreads();
    load_rows_f32<DP, LD>(KVs, kh + c0 * in_sn, in_sn, cols, N - c0, D);
    __syncthreads();
    for (int i = threadIdx.x; i < kQTile * cols; i += kThreads) {
      const float* qr = Qs + (i / cols) * LD;
      const float* kr = KVs + (i % cols) * LD;
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < DP; ++d) a = fmaf(qr[d], kr[d], a);
      S[(i / cols) * LDS + c0 + i % cols] = a;
    }
  }
  __syncthreads();

  // whole-row softmax, one warp per row; P overwrites the scores
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kQTile; r += kWarps) {
    float* row = S + r * LDS;
    float vals[kPer];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (32 * i >= N) break;
      const int c = lane + 32 * i;
      vals[i] = c >= N ? -INFINITY : (c < n_real ? row[c] * scale : kNegInf);
      mx = fmaxf(mx, vals[i]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (32 * i >= N) break;
      vals[i] = lane + 32 * i < N ? expf(vals[i] - mx) : 0.f;
      sum += vals[i];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (32 * i >= NP) break;
      const int c = lane + 32 * i;
      if (c < NP) row[c] = c < N ? vals[i] / sum : 0.f;
    }
  }

  constexpr int kOutPerThread = kQTile * DP / kThreads;
  float acc[kOutPerThread];
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < NP; c0 += kKChunk) {  // O = P.V, V chunk by chunk
    const int cols = min(kKChunk, NP - c0);
    __syncthreads();
    load_rows_f32<DP, LD>(KVs, vh + c0 * in_sn, in_sn, cols, N - c0, D);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const float* prow = S + (i / DP) * LDS + c0;
      const float* vcol = KVs + (i % DP);
      float a = acc[j];
      for (int kk = 0; kk < cols; ++kk) a = fmaf(prow[kk], vcol[kk * LD], a);
      acc[j] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / DP;
    const int c = i % DP;
    if (q0 + r < N && c < D) oh[(q0 + r) * out_sn + c] = acc[j];
  }
}

// ------------------------------------------------------------- launchers

struct Args {
  const void *q, *k, *v;
  void* o;
  long long in_sb, in_sh, in_sn, out_sb, out_sh, out_sn;
  int B, H, N, D, n_real;
  float scale;
  int vec, out_vec;
  cudaStream_t stream;
};

template <int DP>
int launch_bf16(const Args& a) {
  constexpr int LD = DP + 8;
  // the head's 16-row tiles split evenly over the fewest blocks of <= 8 warps
  const int row_tiles = (a.N + 15) / 16;
  const int blocks = (row_tiles + kMaxWarps - 1) / kMaxWarps;
  const int warps = (row_tiles + blocks - 1) / blocks;
  const int NP = 16 * row_tiles;
  const size_t resident_bytes = sizeof(bf16) * (16 * warps + 2 * NP) * LD;
  const int resident = resident_bytes <= kResidentBytes;
  const size_t smem =
      resident ? resident_bytes : sizeof(bf16) * (16 * warps + 4 * kKeyTile) * LD;
  auto kernel = attention_fwd_bf16<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, a.H, a.B);
  kernel<<<grid, 32 * warps, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.in_sb, a.in_sh, a.in_sn,
      a.out_sb, a.out_sh, a.out_sn, a.N, a.D, a.n_real, a.scale, a.vec, a.out_vec,
      resident);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_f32(const Args& a) {
  constexpr int LD = DP + kPadF;
  const size_t smem =
      sizeof(float) * (kQTile * score_stride(a.N) + (kQTile + kKChunk) * LD);
  auto kernel = attention_fwd_f32<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.N + kQTile - 1) / kQTile, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.in_sb, a.in_sh, a.in_sn,
      a.out_sb, a.out_sh, a.out_sn, a.N, a.D, a.n_real, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dtype(const Args& a, int is_bf16) {
  return is_bf16 ? launch_bf16<DP>(a) : launch_f32<DP>(a);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers of
// the input dtype (is_bf16 = 1: bfloat16, 0: float32); strides are in
// elements; the head dim is contiguous. Returns a cudaError_t (0 = launched).
extern "C" int saicv_fused_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    long long in_sb, long long in_sh, long long in_sn,
    long long out_sb, long long out_sh, long long out_sn,
    int B, int H, int N, int D, int n_real, float scale, int is_bf16,
    void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || N > kMaxN || D < 1 ||
      D > 128 || n_real < 1 || n_real > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long es = is_bf16 ? 2 : 4;
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) && (D * es) % 16 == 0 &&
                  (in_sb * es) % 16 == 0 && (in_sh * es) % 16 == 0 &&
                  (in_sn * es) % 16 == 0;
  const int out_vec = (reinterpret_cast<uintptr_t>(o) & 3u) == 0 && D % 2 == 0 &&
                      out_sb % 2 == 0 && out_sh % 2 == 0 && out_sn % 2 == 0;
  const Args a{q,     k,     v,      o, in_sb, in_sh, in_sn,   out_sb, out_sh,
               out_sn, B,    H,      N, D,     n_real, scale, vec,    out_vec,
               static_cast<cudaStream_t>(stream)};
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_dtype<16>(a, is_bf16);
    case 32: return launch_dtype<32>(a, is_bf16);
    case 48: return launch_dtype<48>(a, is_bf16);
    case 64: return launch_dtype<64>(a, is_bf16);
    case 80: return launch_dtype<80>(a, is_bf16);
    case 96: return launch_dtype<96>(a, is_bf16);
    case 112: return launch_dtype<112>(a, is_bf16);
    default: return launch_dtype<128>(a, is_bf16);
  }
}
