// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py::_kernel:
// per (batch, channel), over time, starting from h_0 = 0, with the state
// carried across the whole sequence.  a and b are (B, T, W) in f32 or bf16
// (both of one type), read through their strides and cast to f32 as the
// Pallas body does; h is (B, T, W) f32, contiguous.  Any T and W (the
// Pallas kernel asserts W % bw = T % bt = 0).
//
// What bounds it on this card: the bytes.  Each element of a and b is read
// once and each h written once, 12 bytes per (b, t, w) in f32, against two
// flops: at recurrentgemma-2b's width (W = 2560) a prefill of (B, T) =
// (4, 512) moves 62.9 MB, 0.019 ms at 3.35 TB/s.
//
// This first kernel is built to be right.  One thread owns one (b, w)
// channel and keeps h in a register; the grid is (ceil(W / 128), B) blocks
// of 128 threads, and each thread walks T in order, so the time loop takes
// the place of the TPU's sequential grid axis and nothing carries between
// blocks.  A warp's 32 threads hold consecutive w, so every time step's
// loads and stores are coalesced when the channel stride is 1.  The loads
// do not depend on h: the loop is unrolled by kU steps and issues all kU
// loads of a and b before the kU FMAs, which keeps 2 kU loads in flight per
// thread behind the serial dependence on h.
//
// What it leaves open: at B = 1 only W threads run (20 blocks of 128 for
// 132 SMs at W = 2560), far too few to cover the memory latency, so long
// single-sequence prefills are latency-bound well above the bound.  The fix
// is a T-split two-pass scan (each block scans a time chunk from h = 0 and
// keeps the chunk's product of a; a carry pass then folds the chunk-final
// states in order and corrects each chunk), for a later PR.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kU = 8;          // time steps whose loads are issued together

struct Strides {
  long long b, t, w;  // batch, time and channel strides, in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ h,
                      int Tn, int W, Strides as, Strides bs) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long bb = blockIdx.y;
  const T* ap = a + bb * as.b + w * as.w;
  const T* bp = b + bb * bs.b + w * bs.w;
  float* hp = h + bb * Tn * static_cast<long long>(W) + w;

  float state = 0.f;
  int t0 = 0;
  for (; t0 + kU <= Tn; t0 += kU) {
    float av[kU], bv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      av[u] = to_f32(ap[(t0 + u) * as.t]);
      bv[u] = to_f32(bp[(t0 + u) * bs.t]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      state = fmaf(av[u], state, bv[u]);
      hp[(t0 + u) * static_cast<long long>(W)] = state;
    }
  }
  for (int t = t0; t < Tn; ++t) {
    state = fmaf(to_f32(ap[t * as.t]), state, to_f32(bp[t * bs.t]));
    hp[t * static_cast<long long>(W)] = state;
  }
}

template <typename T>
int launch(const void* a, const void* b, float* h, int B, int Tn, int W, Strides as, Strides bs,
           cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(a),
                                                     static_cast<const T*>(b), h, Tn, W, as, bs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  a and b (B, T, W) by their three strides
// each, in elements; bf16 != 0 means both are bf16, else f32.  h is a
// contiguous (B, T, W) f32 buffer.  The wrapper keeps B, T, W >= 1 and
// B <= 65535.  Launches on `stream`, does not synchronise, and returns the
// CUDA error code (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h, int bf16, int B, int T,
                                 int W, long long a_sb, long long a_st, long long a_sw,
                                 long long b_sb, long long b_st, long long b_sw, void* stream) {
  const Strides as{a_sb, a_st, a_sw}, bs{b_sb, b_st, b_sw};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(h);
  if (bf16) return launch<__nv_bfloat16>(a, b, hf, B, T, W, as, bs, st);
  return launch<float>(a, b, hf, B, T, W, as, bs, st);
}
