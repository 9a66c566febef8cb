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
// This first kernel is built to be right, not to reach that bound.  One
// block of 128 threads owns a 32 x 64 tile of one expert's output and
// walks D in steps of 32: the x tile (32 x 32, padded by one float so the
// two rows a warp reads sit in distinct banks) and the w tile (32 x 64)
// are staged in shared memory as fp32, and each thread keeps a 4 x 4
// register tile of sums (rows ty + 8 r, columns tx + 16 j).  Arithmetic is
// fp32 FMA on the CUDA cores for both types, so f32 meets the reference's
// 1e-4 and a bf16 product is exact in fp32, as the Pallas kernel's
// .astype(float32) makes it.  Loads are masked at the ragged edges of C, D
// and F (the Pallas kernel asserts exact tiling), and every operand is
// read through its strides.  Tensor cores (mma.sync / wgmma on bf16),
// TMA staging and skipping the capacity slots that no token fills are
// later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBC = 32;  // output rows (capacity slots) per block
constexpr int kBF = 64;  // output columns per block
constexpr int kBD = 32;  // depth per shared-memory step
constexpr int kTX = 16, kTY = 8;
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBC / kTY;  // rows per thread
constexpr int kCols = kBF / kTX;  // columns per thread

struct Strides {
  long long e, r, c;  // expert, row and column strides, in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int C,
                   int D, int F, Strides xs, Strides ws, Strides ys) {
  __shared__ float xS[kBC][kBD + 1];
  __shared__ float wS[kBD][kBF];

  const int e = blockIdx.z, c0 = blockIdx.y * kBC, f0 = blockIdx.x * kBF;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const T* xe = x + e * xs.e;
  const T* we = w + e * ws.e;

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
      xS[r][d] = (c < C && dd < D) ? to_f32(xe[c * xs.r + dd * xs.c]) : 0.f;
    }
    for (int i = tid; i < kBD * kBF; i += kThreads) {
      const int d = i / kBF, f = i % kBF;
      const int dd = d0 + d, ff = f0 + f;
      wS[d][f] = (dd < D && ff < F) ? to_f32(we[dd * ws.r + ff * ws.c]) : 0.f;
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

  T* ye = y + e * ys.e;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int c = c0 + ty + kTY * r;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int f = f0 + tx + kTX * j;
      if (f < F) ye[c * ys.r + f * ys.c] = from_f32<T>(acc[r][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int E, int C, int D, int F, Strides xs,
           Strides ws, Strides ys, cudaStream_t stream) {
  const dim3 grid((F + kBF - 1) / kBF, (C + kBC - 1) / kBC, E);
  moe_gmm_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                   static_cast<const T*>(w), static_cast<T*>(y),
                                                   C, D, F, xs, ws, ys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  x (E, C, D), w (E, D, F) and y (E, C, F)
// by their three strides each, in elements; bf16 != 0 means all three are
// bf16, else f32.  The wrapper keeps E, C, F >= 1, D >= 0, C <= 65535 * 32
// and E <= 65535.  Launches on `stream`, does not synchronise, and returns
// the CUDA error code (0 = launched).
extern "C" int moe_gmm_launch(const void* x, const void* w, void* y, int bf16, int E, int C,
                              int D, int F, long long x_se, long long x_sc, long long x_sd,
                              long long w_se, long long w_sd, long long w_sf, long long y_se,
                              long long y_sc, long long y_sf, void* stream) {
  const Strides xs{x_se, x_sc, x_sd}, ws{w_se, w_sd, w_sf}, ys{y_se, y_sc, y_sf};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, w, y, E, C, D, F, xs, ws, ys, st);
  return launch<float>(x, w, y, E, C, D, F, xs, ws, ys, st);
}
