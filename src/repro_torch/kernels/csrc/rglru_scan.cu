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
// flops: at recurrentgemma-2b's width (W = 2560) a 4096-token prefill moves
// 126 MB, 0.038 ms at 3.35 TB/s.  A sequential walk over T reaches that
// only with enough independent channels in flight: at B = 1 one thread per
// channel is 20 blocks of 128 threads for 132 SMs, latency-bound at 12x the
// bound.  So the design splits T as well.
//
// The design: a time-split scan over (channel tile, chunk of kTc steps,
// batch), at (1, 4096, 2560) 1280 blocks where one thread per channel
// walking all of T would be 20:
//   1. rglru_scan_chunk_kernel: each (b, chunk k, w) of every chunk but the
//      last scans its kTc steps from h = 0 and writes the pair
//      (prod of a, final h) to a (B, nk - 1, W) scratch.
//   2. rglru_scan_fix_kernel: each (b, chunk k, w) folds the pairs of the
//      chunks before it in order, h = prod * h + h_k, which is the state
//      entering chunk k (the carry pass of the three-pass form, done by every
//      chunk for itself: at most nk - 1 = 63 loads of 8 bytes from L2 at
//      4096 steps, where a separate carry launch would be one thread per
//      channel again), then rescans its chunk from that state and writes h.
//   This reads a and b twice and writes h once, 20 bytes an element against
//   the bound's 12.  A one-pass chained scan (decoupled look-back) would
//   move 12, but its blocks wait on one another through flags in device
//   memory, with a ticket counter to reset on every call; the two-launch
//   form has no inter-block wait and nothing to reset, and captures in a
//   CUDA graph as it is.
// A call of one chunk (T <= kTc: the serving prefill) has no pairs: kernel 1
// is skipped and kernel 2 walks the chunk from h = 0, one thread per
// channel, which is a launch's latency at (4, 24).  Each thread issues the
// kU loads of a and b of kU steps before their kU FMAs, which keeps 2 kU
// loads in flight behind the serial dependence on h.
// A warp's 32 threads hold consecutive w, so every time step's loads and
// stores are coalesced when the channel stride is 1.  The products of a
// underflow to 0 on long decaying chunks, which is exact to within the
// smallest float: the carry then does not reach past the chunk.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kU = 8;          // time steps whose loads are issued together
constexpr int kTc = 64;        // time steps per chunk of the split scan

int chunks(int Tn) { return (Tn + kTc - 1) / kTc; }

struct Strides {
  long long b, t, w;  // batch, time and channel strides, in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// h <- a_t h + b_t for t in [t0, t1), from `state`; with `hp`, each h_t is
// stored at hp[t * W].  Returns the last h; with `prod`, the product of a.
template <typename T, bool kStore, bool kProd>
__device__ __forceinline__ float walk(const T* ap, const T* bp, float* hp, int t0, int t1, long long W,
                                      Strides as, Strides bs, float state, float* prod) {
  float pr = 1.f;
  int t = t0;
  for (; t + kU <= t1; t += kU) {
    float av[kU], bv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      av[u] = to_f32(ap[(t + u) * as.t]);
      bv[u] = to_f32(bp[(t + u) * bs.t]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      state = fmaf(av[u], state, bv[u]);
      if (kProd) pr *= av[u];
      if (kStore) hp[(t + u) * W] = state;
    }
  }
  for (; t < t1; ++t) {
    const float av = to_f32(ap[t * as.t]);
    state = fmaf(av, state, to_f32(bp[t * bs.t]));
    if (kProd) pr *= av;
    if (kStore) hp[t * W] = state;
  }
  if (kProd) *prod = pr;
  return state;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_chunk_kernel(const T* __restrict__ a, const T* __restrict__ b, float2* __restrict__ pairs,
                            int Tn, int W, int nk, Strides as, Strides bs) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int k = blockIdx.y;
  const long long bb = blockIdx.z;
  const int t0 = k * kTc;
  float prod;
  const float last = walk<T, false, true>(a + bb * as.b + w * as.w, b + bb * bs.b + w * bs.w, nullptr, t0,
                                          min(Tn, t0 + kTc), W, as, bs, 0.f, &prod);
  pairs[(bb * (nk - 1) + k) * W + w] = make_float2(prod, last);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_fix_kernel(const T* __restrict__ a, const T* __restrict__ b,
                          const float2* __restrict__ pairs, float* __restrict__ h, int Tn, int W, int nk,
                          Strides as, Strides bs) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int k = blockIdx.y;
  const long long bb = blockIdx.z;
  float state = 0.f;  // chunk 0 (the only one when nk == 1, and pairs null) starts from h = 0
#pragma unroll 8
  for (int j = 0; j < k; ++j) {
    const float2 p = pairs[(bb * (nk - 1) + j) * W + w];
    state = fmaf(p.x, state, p.y);
  }
  const int t0 = k * kTc;
  walk<T, true, false>(a + bb * as.b + w * as.w, b + bb * bs.b + w * bs.w,
                       h + bb * Tn * static_cast<long long>(W) + w, t0, min(Tn, t0 + kTc), W, as, bs,
                       state, nullptr);
}

template <typename T>
int launch(const void* a, const void* b, float* h, float2* pairs, int B, int Tn, int W, Strides as,
           Strides bs, cudaStream_t stream) {
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  const int wt = (W + kThreads - 1) / kThreads, nk = chunks(Tn);
  if (nk > 1) {
    rglru_scan_chunk_kernel<T><<<dim3(wt, nk - 1, B), kThreads, 0, stream>>>(at, bt, pairs, Tn, W, nk, as, bs);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  rglru_scan_fix_kernel<T><<<dim3(wt, nk, B), kThreads, 0, stream>>>(at, bt, pairs, h, Tn, W, nk, as, bs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Float32 scratch one call of `rglru_scan_launch` needs: the pairs of every
// chunk but the last, 2 B (ceil(T / kTc) - 1) W floats (0 for one chunk).
extern "C" long long rglru_scan_scratch_floats(int B, int T, int W) {
  return 2LL * B * (chunks(T) - 1) * W;
}

// Plain C entry point for ctypes.  a and b (B, T, W) by their three strides
// each, in elements; bf16 != 0 means both are bf16, else f32.  h is a
// contiguous (B, T, W) f32 buffer; `pairs` a contiguous f32 scratch of
// rglru_scan_scratch_floats(B, T, W) floats (may be null when that is 0).
// The wrapper keeps B, T, W >= 1 and B <= 65535; ceil(T / kTc) over 65535
// fails the launch (a grid limit).  Launches one kernel (one chunk) or two
// on `stream`, does not synchronise, and returns the first CUDA error code
// (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h, void* pairs, int bf16, int B,
                                 int T, int W, long long a_sb, long long a_st, long long a_sw,
                                 long long b_sb, long long b_st, long long b_sw, void* stream) {
  const Strides as{a_sb, a_st, a_sw}, bs{b_sb, b_st, b_sw};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(h);
  float2* pf = static_cast<float2*>(pairs);
  if (bf16) return launch<__nv_bfloat16>(a, b, hf, pf, B, T, W, as, bs, st);
  return launch<float>(a, b, hf, pf, B, T, W, as, bs, st);
}
