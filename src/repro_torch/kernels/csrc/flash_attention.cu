// Blocked GQA flash attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// and computes what src/repro/models/attention.py::_chunked_attention
// computes: o = softmax(q k^T / sqrt(D) + mask) v per (batch, query head),
// with KV head h / (H / KV) (GQA), a query at position q_offset + i, a key
// kept where q_pos >= k_pos (causal) and q_pos - k_pos < window (sliding
// window), masked scores set to -1e30, running max, sum and accumulator in
// fp32, and a final division by max(l, 1e-30).  q, k and v are f32 or bf16;
// o is written in q's type.
//
// What bounds it on this card: one call reads q, k, v and writes o once,
// and does 4 * Sq * Sk * D flops per head (half of that under a causal
// mask).  At the serving engine's prompt lengths (S <= a few dozen) that is
// a few hundred KB against 3.35 TB/s: bound by bytes, and in practice by
// launch latency.  At long prefill (S in the thousands) the flops dominate
// and the bound is the tensor cores' 989 TFLOP/s (bf16).
//
// bf16 runs an FA2-style tensor-core kernel.  One block of 4 warps owns 64
// query rows of one (batch, head), 16 rows per warp; the grid hands out the
// query blocks last first, so under a causal mask the blocks with the most
// keys start first.  K and V tiles of BC keys (64 for D <= 128; 32 above,
// where the fp32 output accumulator alone takes 128 registers a thread) are
// staged in shared memory as bf16 by 16-byte cp.async copies into a
// two-stage ring, so the next tile loads while the current one is
// multiplied; at D <= 128 Q passes through the ring on its way to the
// registers, so a block takes 68 KB of shared memory.  Shared rows are padded by 16 bytes so that ldmatrix reads its
// 8 rows without a bank conflict.  S = Q K^T is mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), Q's A-fragments by ldmatrix (held in registers for
// D <= 128, re-read from shared memory per k-step above) and K's
// B-fragments by ldmatrix.  S is scaled by 1/sqrt(D) in fp32 after the
// product, as the reference scales in fp32.  Each row's running max and sum
// live in the 4 lanes of its quad and are reduced by quad shuffles.  P is
// rounded to bf16 once (the one rounding the fp32 reference lacks) and
// multiplied with V's B-fragments (ldmatrix.trans) into an fp32 O
// accumulator.  The mask is
// computed from each fragment element's (row, key) only on tiles that the
// diagonal, a window edge or the ragged end crosses.  D is zero-filled in
// shared memory to DP (32, 64, 96, 128, 192 or 256) and columns >= D are not
// written; ragged Sq and Sk are zero-filled and masked.  Operands whose rows
// do not start on 16 bytes (base pointer, a stride, or D % 8) are staged by
// element loads instead of cp.async: the ALIGNED template flag, which the
// wrapper picks from the pointers and strides.  The same tensor-core kernel
// runs either way.  What remains between it and the bound: wgmma (Hopper's
// warpgroup product, the only way to the full tensor-core rate), TMA loads
// with a producer warp feeding consumer warpgroups (FA3's warp
// specialisation), and one K/V tile shared by the H / KV query heads of a
// GQA group.
//
// f32 runs the first kernel, on the CUDA cores: TF32 tensor cores would not
// meet the 2e-5 tolerance.  One block of 4 warps owns 16 query rows of one
// (batch, head); each warp keeps the online-softmax state of 4 rows in
// registers.  A loop over 32-key tiles stages K and V in shared memory: for
// q k^T, lane j scores key j against the 4 rows (K rows padded by one float
// so the lanes hit distinct banks); for p v, lane d accumulates output dims
// d, d + 32, ... and takes each p_j by a warp shuffle.
//
// Both kernels skip the tiles that every row of the block masks out, and
// only when every row has a valid key; that is exact, because such a
// tile's contribution is cancelled by a zero correction factor
// (exp(-1e30 - m) = 0) in the reference as well.  A row with no valid key
// averages v over all Sk keys, as both references do.  Any Sq, Sk >= 1 and
// 1 <= D <= 256 work, and inputs are read through their strides (unit
// stride along D), so the model passes (B, S, H, D) activations as
// (B, H, S, D) views.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;      // 4 warps, both kernels
constexpr float kMasked = -1e30f;  // the references' mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;  // batch, head and sequence strides, in elements
};

// Keys [lo, hi] that a query at position p may see (lo > hi: none).
__device__ __forceinline__ void key_range(long long p, int Sk, int causal, int has_window,
                                          int window, long long& lo, long long& hi) {
  lo = has_window ? max(0LL, p - window + 1) : 0LL;
  hi = causal ? min(static_cast<long long>(Sk) - 1, p) : static_cast<long long>(Sk) - 1;
}

// Keys [k_begin, k_end) that a block of queries at positions [p_first,
// p_last] visits, k_begin a multiple of `tile`: the union of the rows'
// ranges when every row has a valid key (each row's range moves with p, so
// the two end rows decide), else all Sk keys.
__device__ __forceinline__ void block_keys(long long p_first, long long p_last, int Sk, int causal,
                                           int has_window, int window, int tile, int& k_begin,
                                           int& k_end) {
  long long lo_a, hi_a, lo_b, hi_b;
  key_range(p_first, Sk, causal, has_window, window, lo_a, hi_a);
  key_range(p_last, Sk, causal, has_window, window, lo_b, hi_b);
  k_begin = 0;
  k_end = Sk;
  if (lo_a <= hi_a && lo_b <= hi_b) {
    k_begin = static_cast<int>(lo_a) / tile * tile;
    k_end = static_cast<int>(hi_b) + 1;
  }
}

// ---------------------------------------------------------------- bf16 ---

constexpr int kBlockM = 64;  // query rows per block: 16 per warp

// Rows [0, ROWS) x columns [0, DP) of a bf16 operand (row stride `stride`)
// into shared memory of pitch DP + 8; rows >= n and columns >= D are zero
// (0 * garbage could be NaN).  ALIGNED: 16-byte cp.async copies (D % 8 == 0,
// so a chunk is wholly in or out), committed by the caller; else element
// loads.
template <int ROWS, int DP, bool ALIGNED>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long stride, int n,
                                           int D) {
  constexpr int LD = DP + 8;
  if constexpr (ALIGNED) {
    constexpr int kChunks = ROWS * DP / 8;
    static_assert(kChunks % kThreads == 0, "whole rounds of 16-byte chunks");
    // staging loops are not unrolled: unrolled, their addresses and loads
    // stay live across the tile loop and push D = 256 past 255 registers
#pragma unroll 1
    for (int it = 0; it < kChunks / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (DP / 8), c = i % (DP / 8) * 8;
      const bool in = r < n && c < D;
      mma_sm90::cp_async_16(dst + r * LD + c, in ? src + r * stride + c : src, in ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] = (r < n && c < D) ? src[r * stride + c] : __float2bfloat16(0.f);
    }
  }
}

// Rows [0, n) x columns [0, D) of a shared tile (pitch DP + 8) to dst.
template <int ROWS, int DP, bool ALIGNED>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride, const bf16* src, int n,
                                           int D) {
  constexpr int LD = DP + 8;
  if constexpr (ALIGNED) {
#pragma unroll 1
    for (int it = 0; it < ROWS * DP / 8 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (DP / 8), c = i % (DP / 8) * 8;
      if (r < n && c < D)
        *reinterpret_cast<uint4*>(dst + r * stride + c) =
            *reinterpret_cast<const uint4*>(src + r * LD + c);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      if (r < n && c < D) dst[r * stride + c] = src[r * LD + c];
    }
  }
}

template <int DP, int BC, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, bf16* __restrict__ o, int group,
                                int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs,
                                Strides os, int causal, int q_offset, int has_window, int window,
                                float scale) {
  using namespace mma_sm90;
  constexpr int LD = DP + 8;            // shared row pitch, in elements
  constexpr int KT = DP / 16;           // k-steps of Q K^T
  constexpr bool kQInRegs = DP <= 128;  // above, Q's fragments would take 64+ registers
  static_assert(!kQInRegs || BC == kBlockM, "Q is staged in K's second stage");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kS = reinterpret_cast<bf16*>(smem_raw);  // [2][BC][LD]
  bf16* vS = kS + 2 * BC * LD;                   // [2][BC][LD]
  // [kBlockM][LD], O at the end: while Q lives in registers it passes
  // through K's second stage, 17 KB of shared memory less a block
  bf16* qS = kQInRegs ? kS + BC * LD : vS + 2 * BC * LD;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int nq = min(kBlockM, Sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * qs.b + h * qs.h + q0 * qs.s;
  const bf16* kb = k + b * ks.b + (h / group) * ks.h;
  const bf16* vb = v + b * vs.b + (h / group) * vs.h;
  bf16* ob = o + b * os.b + h * os.h + q0 * os.s;

  const long long p_first = static_cast<long long>(q_offset) + q0;
  const long long p_last = p_first + nq - 1;
  int k_begin, k_end;
  block_keys(p_first, p_last, Sk, causal, has_window, window, BC, k_begin, k_end);
  const int n_tiles = (k_end - k_begin + BC - 1) / BC;

  stage_rows<kBlockM, DP, ALIGNED>(qS, qb, qs.s, nq, D);
  cp_async_commit();
  stage_rows<BC, DP, ALIGNED>(kS, kb + k_begin * ks.s, ks.s, Sk - k_begin, D);
  stage_rows<BC, DP, ALIGNED>(vS, vb + k_begin * vs.s, vs.s, Sk - k_begin, D);
  cp_async_commit();

  const int r_lo = warp * 16 + g;  // this thread's rows of the block: r_lo and r_lo + 8
  const long long pos[2] = {p_first + r_lo, p_first + r_lo + 8};
  uint32_t qf[kQInRegs ? KT : 1][4];
  if constexpr (kQInRegs) {  // Q's A-fragments, before the loop refills K's second stage
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      ldmatrix_x4(qf[kk], qS + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    __syncthreads();
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_begin + it * BC;
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // the next tile loads while this one is multiplied
      const int t1 = t0 + BC;
      stage_rows<BC, DP, ALIGNED>(kS + (st ^ 1) * BC * LD, kb + t1 * ks.s, ks.s, Sk - t1, D);
      stage_rows<BC, DP, ALIGNED>(vS + (st ^ 1) * BC * LD, vb + t1 * vs.s, vs.s, Sk - t1, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T: n-tile j holds keys t0 + 8 j .. + 7
    float s[BC / 8][4];
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* kt = kS + st * BC * LD;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, qS + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nn = 0; nn < BC / 16; ++nn) {
        uint32_t bk[4];  // keys 16 nn .. + 15 by d kk*16 .. + 15: two n-tiles' B-fragments
        ldmatrix_x4(bk, kt + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * nn], a, bk[0], bk[1]);
        mma_bf16_16816(s[2 * nn + 1], a, bk[2], bk[3]);
      }
    }

    // scale in fp32, then mask where the tile crosses a diagonal, window edge or the end
    const bool edge = t0 + BC > Sk || (causal && t0 + BC - 1 > p_first) ||
                      (has_window && p_last - t0 >= window);
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int key = t0 + j * 8 + 2 * t + (e & 1);
          const long long p = pos[e >> 1];
          if (key >= Sk)
            x = -CUDART_INF_F;  // past the end: no part at all
          else if ((causal && p < key) || (has_window && p - key >= window))
            x = kMasked;
        }
        s[j][e] = x;
      }

    // online softmax; a row's max is >= -1e30 (key t0 is in range)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - mx[e >> 1]) * kLog2e);
        rowsum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rowsum[r];  // this lane's share
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V: P's C-fragments, rounded to bf16 once, are the
    // A-fragments of the next product
    const bf16* vt = vS + st * BC * LD;
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        uint32_t bv[4];  // keys 16 kk .. + 15 by d 16 dn .. + 15: two n-tiles' B-fragments
        ldmatrix_x4_trans(bv, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dn * 16 + (lane >> 4) * 8);
        mma_bf16_16816(acc[2 * dn], pa, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * dn + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // o = acc / max(l, 1e-30), through Q's shared tile (no warp reads it or
  // the stages any more) so that the stores to device memory are 16 bytes wide
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    *reinterpret_cast<uint32_t*>(qS + r_lo * LD + j * 8 + 2 * t) =
        pack_bf16(acc[j][0] / l[0], acc[j][1] / l[0]);
    *reinterpret_cast<uint32_t*>(qS + (r_lo + 8) * LD + j * 8 + 2 * t) =
        pack_bf16(acc[j][2] / l[1], acc[j][3] / l[1]);
  }
  __syncthreads();
  store_rows<kBlockM, DP, ALIGNED>(ob, os.s, qS, nq, D);
}

template <int DP, bool ALIGNED>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, Strides os, int causal,
                int q_offset, int has_window, int window, float scale, cudaStream_t stream) {
  constexpr int BC = DP <= 128 ? 64 : 32;
  auto kern = flash_attention_bf16_kernel<DP, BC, ALIGNED>;
  constexpr int smem = ((DP <= 128 ? 0 : kBlockM) + 4 * BC) * (DP + 8) * static_cast<int>(sizeof(bf16));
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H / KV, Sq, Sk, D, qs, ks, vs, os, causal, q_offset, has_window,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool ALIGNED>
int launch_bf16_d(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                  int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, Strides os,
                  int causal, int q_offset, int has_window, int window, float scale,
                  cudaStream_t stream) {
#define FLASH_BF16(DP)                                                                     \
  return launch_bf16<DP, ALIGNED>(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal, \
                                  q_offset, has_window, window, scale, stream)
  if (D <= 32) FLASH_BF16(32);
  if (D <= 64) FLASH_BF16(64);
  if (D <= 96) FLASH_BF16(96);
  if (D <= 128) FLASH_BF16(128);
  if (D <= 192) FLASH_BF16(192);
  FLASH_BF16(256);
#undef FLASH_BF16
}

// ----------------------------------------------------------------- f32 ---

constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = 4 * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                // keys per tile: one per lane

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int DPL>  // DPL: output dims per lane, 32 * DPL >= D
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ o, int group,
                               int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs,
                               Strides os, int causal, int q_offset, int has_window, int window,
                               float scale) {
  extern __shared__ float smem[];
  const int ldk = D + 1;
  float* kS = smem;                // [kBlockK][D + 1]
  float* vS = kS + kBlockK * ldk;  // [kBlockK][D]
  float* qS = vS + kBlockK * D;    // [kBlockQ][D], pre-scaled

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int kvh = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRowsPerWarp;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  float* ob = o + b * os.b + h * os.h;

  // q scaled in fp32 first, as both references do
  for (int i = threadIdx.x; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    qS[i] = (q0 + r < Sq) ? qb[(q0 + r) * qs.s + d] * scale : 0.f;
  }

  // the tiles this block must visit
  const int q_last = min(q0 + kBlockQ, Sq) - 1;
  int k_begin, k_end;
  block_keys(static_cast<long long>(q_offset) + q0, static_cast<long long>(q_offset) + q_last, Sk,
             causal, has_window, window, kBlockK, k_begin, k_end);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int t0 = k_begin; t0 < k_end; t0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read (and qS is written)
    const int n = min(kBlockK, Sk - t0);
    for (int i = threadIdx.x; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D;
      const bool in = j < n;  // zero-fill the ragged tail: 0 * garbage could be NaN
      kS[j * ldk + d] = in ? kb[(t0 + j) * ks.s + d] : 0.f;
      vS[j * D + d] = in ? vb[(t0 + j) * vs.s + d] : 0.f;
    }
    __syncthreads();

    // scores: lane j <-> key t0 + j
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = kS + lane * ldk;
    const float* qrow = qS + r0 * D;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qrow[r * D + d], kd, s[r]);
    }

    // online softmax per row
    const int key = t0 + lane;
    const bool in_range = lane < n;
    float p[kRowsPerWarp], corr[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const long long qp = static_cast<long long>(q_offset) + q0 + r0 + r;
      const bool keep = (!causal || qp >= key) && (!has_window || qp - key < window);
      // out-of-range keys take no part at all; masked keys score -1e30
      const float sr = in_range ? (keep ? s[r] : kMasked) : -CUDART_INF_F;
      const float m_new = fmaxf(m[r], warp_max(sr));  // >= -1e30: lane 0 is in range
      p[r] = in_range ? expf(sr - m_new) : 0.f;
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + warp_sum(p[r]);
      m[r] = m_new;
    }

    // acc = acc * corr + p v; lane owns dims lane, lane + 32, ...
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr[r];
    for (int j = 0; j < n; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = __shfl_sync(kFull, p[r], j);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float vd = vS[j * D + d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][i] = fmaf(pj[r], vd, acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + r0 + r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) ob[row * os.s + d] = acc[r][i] / denom;
    }
  }
}

template <int DPL>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
               int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, Strides os, int causal,
               int q_offset, int has_window, int window, float scale, cudaStream_t stream) {
  auto kern = flash_attention_f32_kernel<DPL>;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBlockK) * (D + 1) +
                                       static_cast<size_t>(kBlockK) * D +
                                       static_cast<size_t>(kBlockQ) * D);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H / KV, Sq, Sk, D, qs, ks, vs, os, causal, q_offset, has_window,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32_d(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                 int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int q_offset, int has_window, int window, float scale,
                 cudaStream_t stream) {
#define FLASH_F32(DPL)                                                                      \
  return launch_f32<DPL>(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal, q_offset, \
                         has_window, window, scale, stream)
  if (D <= 32) FLASH_F32(1);
  if (D <= 64) FLASH_F32(2);
  if (D <= 128) FLASH_F32(4);
  FLASH_F32(8);
#undef FLASH_F32
}

}  // namespace

// Plain C entry point for ctypes.  q (B, H, Sq, D), k/v (B, KV, Sk, D) and
// o (B, H, Sq, D) by their batch, head and sequence strides (unit stride
// along D); bf16 != 0 means all four are bf16, else f32.  aligned != 0
// (bf16 only) promises that every row of the four starts on 16 bytes and
// D % 8 == 0, so rows are staged by 16-byte cp.async copies.  The wrapper
// keeps 1 <= D <= 256, H % KV == 0, Sq, Sk >= 1.  Launches on `stream`,
// does not synchronise, and returns the CUDA error code (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int bf16, int aligned, int B, int H, int KV, int Sq,
                                      int Sk, int D, long long q_sb, long long q_sh,
                                      long long q_ss, long long k_sb, long long k_sh,
                                      long long k_ss, long long v_sb, long long v_sh,
                                      long long v_ss, long long o_sb, long long o_sh,
                                      long long o_ss, int causal, int q_offset, int has_window,
                                      int window, float scale, void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16 && aligned)
    return launch_bf16_d<true>(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal, q_offset,
                               has_window, window, scale, st);
  if (bf16)
    return launch_bf16_d<false>(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal,
                                q_offset, has_window, window, scale, st);
  return launch_f32_d(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal, q_offset,
                      has_window, window, scale, st);
}
