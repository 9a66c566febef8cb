// int8 GEMM with a fused requantization epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul_requant.py::_kernel
// (with its _round_shift_even epilogue): out = clip(requant(a @ w * mult +
// bias)), int8 x int8 -> int32 accumulate, then per output channel
// y = acc * mult + bias, an arithmetic right shift by S that floors or
// rounds half to even, optional ReLU, clip to [-128, 127], store int8.
//
// What bounds it on this card: every call on the compiled CNN path has
// M = 1 (batch 1), a GEMV over at most K x N = 640 x 128 int8 weights
// (80 KB).  That is a few hundred thousand operations against 3.35 TB/s of
// memory and 1979 TOP/s of int8 tensor cores: bound by bytes, and in
// practice by launch latency.  So the design spends nothing on tensor cores
// or shared-memory tiling.  One warp computes one output element: its lanes
// walk K together (coalesced), four int8 products at a time as packed words
// through __dp4a when K and the pointers allow it, byte by byte otherwise;
// a shuffle tree reduces the lanes and lane 0 runs the epilogue in int32
// registers.  W is read through its strides, so the caller can pass the
// (K, N) view of a dense weight stored (N, K) without copying it.
// Any M, N, K >= 1 works: there is no tiling to divide.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ int32_t requant(int32_t acc, int32_t mult, int32_t bias, int shift,
                                           bool even, bool relu) {
  // acc * mult + bias wraps modulo 2^32 like the int32 reference arithmetic
  int32_t y = static_cast<int32_t>(static_cast<uint32_t>(acc) * static_cast<uint32_t>(mult) +
                                   static_cast<uint32_t>(bias));
  if (even) {
    if (shift > 0) {  // round-half-even(y / 2^S); shift <= 0 passes y through
      int32_t q = y >> shift;  // floor(y / 2^S)
      // remainder y - q * 2^S in [0, 2^S), in unsigned arithmetic: a left
      // shift of a negative int is undefined in C++17
      uint32_t r = static_cast<uint32_t>(y) - static_cast<uint32_t>(q) * (1u << shift);
      uint32_t half = 1u << (shift - 1);
      y = q + ((r > half) ? 1 : ((r == half) ? (q & 1) : 0));
    }
  } else {
    y = y >> shift;  // floor; the wrapper keeps 0 <= shift <= 31
  }
  if (relu) y = max(y, 0);
  return min(max(y, -128), 127);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    matmul_requant_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                          const int32_t* __restrict__ mult, const int32_t* __restrict__ bias,
                          int8_t* __restrict__ out, int M, int N, int K, long long lda,
                          long long w_sk, long long w_sn, int shift, int even, int relu,
                          int packed) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(M) * N) return;  // uniform across the warp
  const int m = static_cast<int>(warp / N);
  const int n = static_cast<int>(warp % N);
  const int8_t* arow = a + m * lda;
  const int8_t* wcol = w + n * w_sn;

  // |acc| <= K * 2^14 < 2^31: the wrapper keeps K < 2^17
  int32_t acc = 0;
  if (packed) {  // K % 4 == 0, W contiguous along K, 4-byte aligned rows
    const int* a4 = reinterpret_cast<const int*>(arow);
    const int* w4 = reinterpret_cast<const int*>(wcol);
    for (int k = lane; k < K / 4; k += 32) acc = __dp4a(a4[k], w4[k], acc);
  } else {
    for (int k = lane; k < K; k += 32) acc += static_cast<int32_t>(arow[k]) * wcol[k * w_sk];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    out[static_cast<long long>(m) * N + n] =
        static_cast<int8_t>(requant(acc, mult[n], bias[n], shift, even != 0, relu != 0));
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int matmul_requant_launch(const void* a, const void* w, const void* mult,
                                     const void* bias, void* out, int M, int N, int K,
                                     long long lda, long long w_sk, long long w_sn, int shift,
                                     int even, int relu, void* stream) {
  const bool packed = (K % 4 == 0) && w_sk == 1 && (lda % 4 == 0) && (w_sn % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(a) % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  const long long warps = static_cast<long long>(M) * N;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  matmul_requant_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(mult), static_cast<const int32_t*>(bias),
      static_cast<int8_t*>(out), M, N, K, lda, w_sk, w_sn, shift, even, relu, packed ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
