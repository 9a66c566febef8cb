// Grouped expert matmul for Hopper (sm_90a): y[e] = x[e] @ w[e].
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py::_kernel: the
// MoE FFN's expert GEMMs over capacity-dispatched activations,
// x (E, C, D) x w (E, D, F) -> y (E, C, F), products and sums in fp32, the
// result rounded once to x's type (f32 or bf16).
//
// What bounds it on this card: at the serving shapes every expert's weight
// matrix is read once for a handful of rows.  granite-moe-3b-a800m at 4
// slots has C = 32 (capacity 8 per batch row): w_gate is 40 x 1536 x 512
// bf16 = 62.9 MB against 2.0 GFLOP, so the bound is the bytes, about
// 0.020 ms at 3.35 TB/s.  Only at C in the hundreds would the products
// (989 TFLOP/s in bf16 on the tensor cores) be the limit.
//
// bf16 runs a pipelined tensor-core grouped GEMM built to stream w at the
// memory's rate.  One block of 4 warps owns up to 32 rows of C (16 where
// C <= 16) by 64 columns of F of one expert; each warp owns 16 of the
// columns for all the rows.  D is walked in steps of 64 through a 4-stage
// ring of shared-memory tiles filled by 16-byte cp.async copies, so three
// steps are in flight while one is multiplied.  Products are mma.sync
// m16n8k16 (bf16 in, fp32 accumulate): x's A-fragments by ldmatrix, w's
// (D, F) row-major B-fragments by ldmatrix.trans; shared rows are padded by
// 16 bytes so ldmatrix reads without a bank conflict.  Bytes in flight: a
// stage holds 8 KB of w and up to 4 KB of x, and a block takes 54 KB of
// shared memory, so 4 blocks fit an SM, each with 3 stages (24 KB of w)
// loading: about 96 KB of w in flight per SM, against the ~20 KB that
// 3.35 TB/s over 132 SMs needs at a microsecond of latency.  Grid: granite's
// wi (F = 512) is 8 x 40 = 320 blocks, its wo (F = 1536) 24 x 40 = 960:
// 2.4 and 7.3 blocks per SM.  D is not split across blocks.  Operands whose
// rows do not start on 16 bytes (base pointer, a stride, an inner stride
// other than 1, or D, F not multiples of 8) are staged by element loads
// instead of cp.async: the ALIGNED template flag, which the wrapper picks.
//
// Routed rows.  The model lays x out as (E, B * cap, D): expert e's slots of
// batch row b are rows b * cap .. b * cap + cap - 1, and only the first
// rows[b][e] of them hold a (token, expert) pair; the rest are zero rows of
// the dispatch.  Given rows (B, E) int32 on the device, a block first reads
// the counts its tile spans; a tile that holds no pair reads no byte of x or
// w, writes zeros to its y tile and exits.  A tile that holds a pair runs as
// without rows (the same tiles and the same order of sums, so a filled row's
// y is the same bit for bit) and writes 0 to its rows that hold none.  At
// granite's decode (one token, 10 of 72 experts) a layer then reads 10
// experts' weights, not 72.  Exact: an unfilled row's zero x gives 0 for
// finite weights, and the model never reads an unfilled row (the Pallas
// kernel computes every slot, so non-finite weights reach unfilled rows
// there; the combine reads neither).  The counts are device data, so a
// captured graph reads each replay's own routing.  With `tally`, each block
// that runs adds its tile's rows to it (one atomicAdd, at blockIdx.x == 0):
// the rows the products ran, read by the host when it reads its counters.  What
// is left: a block of an empty expert is still launched, reads its counts and
// writes its zeros, 3-5 us of granite's 26-27 us decode launch (a grid over
// only the tiles that hold pairs would need a bound on them from the host);
// the 120 blocks of its routed wi read w at about 60 % of HBM's bytes/s,
// and a deeper ring (3 to 12 stages) does not raise that.
// What remains: TMA loads and wgmma, and a persistent grid that balances
// the 2.4 blocks per SM of wi.
//
// f32 runs the first kernel, on the CUDA cores (TF32 would not meet the 1e-4
// tolerance): one block of 128 threads owns a 32 x 64 output tile and walks
// D in steps of 32, the x tile (padded by one float so the two rows a warp
// reads sit in distinct banks) and the w tile staged in shared memory, each
// thread keeping a 4 x 4 register tile of sums (rows ty + 8 r, columns
// tx + 16 j).
//
// Both take any C, D and F (the Pallas kernel asserts exact tiling): loads
// are masked and zero-filled at the ragged edges, and every operand is read
// through its strides.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;

struct Strides {
  long long e, r, c;  // expert, row and column strides, in elements
};

// ---------------------------------------------------------------- bf16 ---

constexpr int kTF = 64;          // output columns per block: 16 per warp
constexpr int kTK = 64;          // depth per pipeline stage
constexpr int kStages = 4;       // ring of shared-memory stages
constexpr int kLdX = kTK + 8;    // shared pitches, in elements: 16 bytes of
constexpr int kLdW = kTF + 8;    // padding keep ldmatrix free of bank conflicts

template <int BM>
constexpr int bf16_smem_bytes() {
  return kStages * (BM * kLdX + kTK * kLdW) * static_cast<int>(sizeof(bf16));
}

// Whether rows [c0, c0 + nc) of expert e hold a routed pair: row r of the
// (B * cap) rows holds one iff r % cap < rows[r / cap][e] (rows is (B, E),
// row-major).
__device__ __forceinline__ bool tile_routed(const int* __restrict__ rows, int cap, int e, int c0,
                                            int nc) {
  const int E = gridDim.z;
  for (int b = c0 / cap; b * cap < c0 + nc; ++b)
    if (max(c0 - b * cap, 0) < rows[b * E + e]) return true;
  return false;
}

__device__ __forceinline__ void set_zero(bf16& v) { v = __float2bfloat16(0.f); }
__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }

// The routed-rows prologue of a block that owns rows [c0, c0 + nc) and
// columns [f0, f0 + nf) of expert e: false, after zeroing that tile of y,
// when no row of it holds a pair; else true, after adding nc to the tally.
template <typename T>
__device__ __forceinline__ bool tile_runs(const int* __restrict__ rows, int cap,
                                          unsigned long long* tally, T* ye, Strides ys,
                                          int e, int c0, int nc, int f0, int nf) {
  if (rows == nullptr) return true;
  if (!tile_routed(rows, cap, e, c0, nc)) {
    for (int i = threadIdx.x; i < nc * nf; i += blockDim.x)
      set_zero(ye[(c0 + i / nf) * ys.r + (f0 + i % nf) * ys.c]);
    return false;
  }
  if (tally != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(tally, static_cast<unsigned long long>(nc));
  return true;
}

// One depth step's x tile (BM x kTK) and w tile (kTK x kTF) into a ring slot,
// zero outside [0, nc) x [0, D) and [0, D) x [0, nf).
template <int BM, bool ALIGNED>
__device__ __forceinline__ void stage_step(bf16* xd, bf16* wd, const bf16* xe, const bf16* we,
                                           int d0, int nc, int nf, int D, const Strides& xs,
                                           const Strides& ws) {
  if constexpr (ALIGNED) {  // unit inner strides, D % 8 == 0, nf % 8 == 0
    static_assert(BM * kTK / 8 % kThreads == 0 && kTK * kTF / 8 % kThreads == 0, "whole rounds");
#pragma unroll
    for (int it = 0; it < BM * kTK / 8 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (kTK / 8), c = i % (kTK / 8) * 8;
      const bool in = r < nc && d0 + c < D;
      mma_sm90::cp_async_16(xd + r * kLdX + c, in ? xe + r * xs.r + d0 + c : xe, in ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < kTK * kTF / 8 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (kTF / 8), c = i % (kTF / 8) * 8;
      const bool in = d0 + r < D && c < nf;
      mma_sm90::cp_async_16(wd + r * kLdW + c, in ? we + (d0 + r) * ws.r + c : we, in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < BM * kTK; i += kThreads) {
      const int r = i / kTK, c = i % kTK;
      xd[r * kLdX + c] = (r < nc && d0 + c < D) ? xe[r * xs.r + (d0 + c) * xs.c] : zero;
    }
    for (int i = threadIdx.x; i < kTK * kTF; i += kThreads) {
      const int r = i / kTF, c = i % kTF;
      wd[r * kLdW + c] = (d0 + r < D && c < nf) ? we[(d0 + r) * ws.r + c * ws.c] : zero;
    }
  }
}

template <int MT, bool ALIGNED>  // MT: m16 tiles of rows per block (BM = 16 MT rows)
__global__ void __launch_bounds__(kThreads)
    moe_gmm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        bf16* __restrict__ y, int C, int D, int F, Strides xs, Strides ws,
                        Strides ys, const int* __restrict__ rows, int cap,
                        unsigned long long* tally) {
  using namespace mma_sm90;
  constexpr int BM = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xS = reinterpret_cast<bf16*>(smem_raw);  // [kStages][BM][kLdX]
  bf16* wS = xS + kStages * BM * kLdX;           // [kStages][kTK][kLdW]

  const int e = blockIdx.z, c0 = blockIdx.y * BM, f0 = blockIdx.x * kTF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nc = min(BM, C - c0), nf = min(kTF, F - f0);
  if (!tile_runs(rows, cap, tally, y + e * ys.e, ys, e, c0, nc, f0, nf)) return;
  const bf16* xe = x + e * xs.e + c0 * xs.r;
  const bf16* we = w + e * ws.e + f0 * ws.c;
  const int n_k = (D + kTK - 1) / kTK;

  // prologue: kStages - 1 steps in flight (one commit group per step, empty
  // past the end, so that wait_group counts steps)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k)
      stage_step<BM, ALIGNED>(xS + s * BM * kLdX, wS + s * kTK * kLdW, xe, we, s * kTK, nc, nf, D,
                              xs, ws);
    cp_async_commit();
  }

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();  // step kt has landed for this thread ...
    __syncthreads();               // ... and for all; step kt - 1's slot is free
    const int next = kt + kStages - 1;
    if (next < n_k) {
      const int slot = next % kStages;
      stage_step<BM, ALIGNED>(xS + slot * BM * kLdX, wS + slot * kTK * kLdW, xe, we, next * kTK,
                              nc, nf, D, xs, ws);
    }
    cp_async_commit();

    const bf16* xt = xS + (kt % kStages) * BM * kLdX;
    const bf16* wt = wS + (kt % kStages) * kTK * kLdW;
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], xt + (mt * 16 + (lane & 15)) * kLdX + kk * 16 + (lane >> 4) * 8);
      uint32_t b[4];  // d kk*16 .. + 15 by this warp's 16 columns: two n-tiles' B-fragments
      ldmatrix_x4_trans(b, wt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdW +
                               warp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(acc[mt][0], a[mt], b[0], b[1]);
        mma_bf16_16816(acc[mt][1], a[mt], b[2], b[3]);
      }
    }
  }

  // C-fragments straight to y: (row g, columns 2t, 2t + 1) and row g + 8;
  // a row that holds no pair gets 0
  const int g = lane >> 2, t = lane & 3;
  bf16* ye = y + e * ys.e;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = c0 + mt * 16 + g + 8 * half;
      if (row >= C) continue;
      const bool routed = rows == nullptr || __ldg(rows + row / cap * gridDim.z + e) > row % cap;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = f0 + warp * 16 + nt * 8 + 2 * t;
        if (col >= F) continue;
        const float lo = routed ? acc[mt][nt][2 * half] : 0.f;
        const float hi = routed ? acc[mt][nt][2 * half + 1] : 0.f;
        bf16* dst = ye + row * ys.r + col * ys.c;
        if constexpr (ALIGNED) {  // F % 8 == 0: col < F means col + 1 < F; 4-byte aligned
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
        } else {
          dst[0] = __float2bfloat16_rn(lo);
          if (col + 1 < F) dst[ys.c] = __float2bfloat16_rn(hi);
        }
      }
    }
}

// The routed rows of a launch: rows (B, E) int32 or null, cap = C / B, and
// the tally or null.
struct Routed {
  const int* rows;
  int cap;
  unsigned long long* tally;
};

template <int MT, bool ALIGNED>
int launch_bf16(const void* x, const void* w, void* y, int E, int C, int D, int F, Strides xs,
                Strides ws, Strides ys, Routed rt, cudaStream_t stream) {
  auto kern = moe_gmm_bf16_kernel<MT, ALIGNED>;
  constexpr int smem = bf16_smem_bytes<16 * MT>();
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((F + kTF - 1) / kTF, (C + 16 * MT - 1) / (16 * MT), E);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                         static_cast<bf16*>(y), C, D, F, xs, ws, ys, rt.rows,
                                         rt.cap, rt.tally);
  return static_cast<int>(cudaGetLastError());
}

template <bool ALIGNED>
int launch_bf16_c(const void* x, const void* w, void* y, int E, int C, int D, int F, Strides xs,
                  Strides ws, Strides ys, Routed rt, cudaStream_t stream) {
  if (C <= 16) return launch_bf16<1, ALIGNED>(x, w, y, E, C, D, F, xs, ws, ys, rt, stream);
  return launch_bf16<2, ALIGNED>(x, w, y, E, C, D, F, xs, ws, ys, rt, stream);
}

// ----------------------------------------------------------------- f32 ---

constexpr int kBC = 32;  // output rows (capacity slots) per block
constexpr int kBF = 64;  // output columns per block
constexpr int kBD = 32;  // depth per shared-memory step
constexpr int kTX = 16, kTY = 8;
constexpr int kRows = kBC / kTY;  // rows per thread
constexpr int kCols = kBF / kTX;  // columns per thread

__global__ void __launch_bounds__(kThreads)
    moe_gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ y, int C, int D, int F, Strides xs, Strides ws,
                       Strides ys, const int* __restrict__ rows, int cap,
                       unsigned long long* tally) {
  __shared__ float xS[kBC][kBD + 1];
  __shared__ float wS[kBD][kBF];

  const int e = blockIdx.z, c0 = blockIdx.y * kBC, f0 = blockIdx.x * kBF;
  if (!tile_runs(rows, cap, tally, y + e * ys.e, ys, e, c0, min(kBC, C - c0), f0, min(kBF, F - f0)))
    return;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const float* xe = x + e * xs.e;
  const float* we = w + e * ws.e;

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kBD) {
    // neighbouring threads on neighbouring d (x) and f (w): coalesced when
    // the innermost stride is 1; out-of-range elements are zero
    for (int i = tid; i < kBC * kBD; i += kThreads) {
      const int r = i / kBD, d = i % kBD;
      const int c = c0 + r, dd = d0 + d;
      xS[r][d] = (c < C && dd < D) ? xe[c * xs.r + dd * xs.c] : 0.f;
    }
    for (int i = tid; i < kBD * kBF; i += kThreads) {
      const int d = i / kBF, f = i % kBF;
      const int dd = d0 + d, ff = f0 + f;
      wS[d][f] = (dd < D && ff < F) ? we[dd * ws.r + ff * ws.c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < kBD; ++d) {
      float xv[kRows], wv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) xv[r] = xS[ty + kTY * r][d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) wv[j] = wS[d][tx + kTX * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(xv[r], wv[j], acc[r][j]);
    }
    __syncthreads();  // the tiles are read before the next step overwrites them
  }

  float* ye = y + e * ys.e;  // a row that holds no pair gets 0
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int c = c0 + ty + kTY * r;
    if (c >= C) continue;
    const bool routed = rows == nullptr || __ldg(rows + c / cap * gridDim.z + e) > c % cap;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int f = f0 + tx + kTX * j;
      if (f < F) ye[c * ys.r + f * ys.c] = routed ? acc[r][j] : 0.f;
    }
  }
}

int launch_f32(const void* x, const void* w, void* y, int E, int C, int D, int F, Strides xs,
               Strides ws, Strides ys, Routed rt, cudaStream_t stream) {
  const dim3 grid((F + kBF - 1) / kBF, (C + kBC - 1) / kBC, E);
  moe_gmm_f32_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), C, D, F,
      xs, ws, ys, rt.rows, rt.cap, rt.tally);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  x (E, C, D), w (E, D, F) and y (E, C, F)
// by their three strides each, in elements; bf16 != 0 means all three are
// bf16, else f32.  aligned != 0 (bf16 only) promises unit inner strides,
// D % 8 == 0, F % 8 == 0 and every row of the three starting on 16 bytes,
// so rows are staged by 16-byte cp.async copies.  rows, if not null, is a
// contiguous (C / cap, E) int32 array of routed rows on the device (the
// wrapper keeps C a multiple of cap >= 1); tally, if not null, an int64 on
// the device that the launch adds the rows it runs to.  The wrapper keeps
// E, C, F >= 1, D >= 0, C <= 65535 * 32 and E <= 65535.  Launches on
// `stream`, does not synchronise, and returns the CUDA error code (0 =
// launched).
extern "C" int moe_gmm_launch(const void* x, const void* w, void* y, int bf16, int aligned,
                              int E, int C, int D, int F, long long x_se, long long x_sc,
                              long long x_sd, long long w_se, long long w_sd, long long w_sf,
                              long long y_se, long long y_sc, long long y_sf, const void* rows,
                              int cap, void* tally, void* stream) {
  const Strides xs{x_se, x_sc, x_sd}, ws{w_se, w_sd, w_sf}, ys{y_se, y_sc, y_sf};
  const Routed rt{static_cast<const int*>(rows), cap, static_cast<unsigned long long*>(tally)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16 && aligned) return launch_bf16_c<true>(x, w, y, E, C, D, F, xs, ws, ys, rt, st);
  if (bf16) return launch_bf16_c<false>(x, w, y, E, C, D, F, xs, ws, ys, rt, st);
  return launch_f32(x, w, y, E, C, D, F, xs, ws, ys, rt, st);
}
