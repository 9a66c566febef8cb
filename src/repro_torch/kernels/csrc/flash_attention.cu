// Blocked GQA flash attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// and computes what src/repro/models/attention.py::_chunked_attention
// computes: o = softmax(q k^T / sqrt(D) + mask) v per (batch, query head),
// with KV head h / (H / KV) (GQA), a query at position q_offset + i, a key
// kept where q_pos >= k_pos (causal) and q_pos - k_pos < window (sliding
// window), masked scores set to -1e30, running max, sum and accumulator in
// fp32, and a final division by max(l, 1e-30).  q, k and v are f32 or bf16;
// products are taken in fp32; o is written in q's type.
//
// What bounds it on this card: one call reads q, k, v and writes o once,
// and does 4 * Sq * Sk * D flops per head (half of that under a causal
// mask).  At the serving engine's prompt lengths (S <= a few dozen) that is
// a few hundred KB against 3.35 TB/s: bound by bytes, and in practice by
// launch latency.  At long prefill (S in the thousands) the flops dominate
// and the bound is the tensor cores' 989 TFLOP/s (bf16).
//
// This first kernel is built to be right, not to reach that bound.  It does
// its arithmetic in fp32 on the CUDA cores, which the f32 path needs
// anyway (tensor-core TF32 would not meet the 2e-5 tolerance), and which
// keeps bf16 products exact in fp32 as the Pallas kernel's
// .astype(float32) does.  One block of 4 warps owns 16 query rows of one
// (batch, head); each warp keeps the online-softmax state of 4 rows in
// registers.  A loop over 32-key tiles stages K and V in shared memory as
// fp32: for q k^T, lane j scores key j against the 4 rows (K rows padded by
// one float so the lanes hit distinct banks); for p v, lane d accumulates
// output dims d, d + 32, ... and takes each p_j by a warp shuffle.  Tiles
// that every row of the block masks out are skipped when every row has a
// valid key; that is exact, because such a tile's contribution is cancelled
// by a zero correction factor (exp(-1e30 - m) = 0) in the reference as well.
// Any Sq, Sk >= 1 and 1 <= D <= 256 work: the kernel masks the ragged
// edges itself.  Inputs are read through their strides (unit stride along
// D), so the model passes (B, S, H, D) activations as (B, H, S, D) views.
// wgmma, TMA and a tensor-core path for bf16 are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr float kMasked = -1e30f;               // the references' mask value
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;  // batch, head and sequence strides, in elements
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

// Keys [lo, hi] that a query at position p may see (lo > hi: none).
__device__ __forceinline__ void key_range(long long p, int Sk, int causal, int has_window,
                                          int window, long long& lo, long long& hi) {
  lo = has_window ? max(0LL, p - window + 1) : 0LL;
  hi = causal ? min(static_cast<long long>(Sk) - 1, p) : static_cast<long long>(Sk) - 1;
}

template <typename T, int DPL>  // DPL: output dims per lane, 32 * DPL >= D
__global__ void __launch_bounds__(kWarps * 32)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int group, int Sq,
                           int Sk, int D, Strides qs, Strides ks, Strides vs, Strides os,
                           int causal, int q_offset, int has_window, int window, float scale) {
  extern __shared__ float smem[];
  const int ldk = D + 1;
  float* kS = smem;                 // [kBlockK][D + 1]
  float* vS = kS + kBlockK * ldk;   // [kBlockK][D]
  float* qS = vS + kBlockK * D;     // [kBlockQ][D], pre-scaled

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int kvh = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRowsPerWarp;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  // q scaled in fp32 first, as both references do
  for (int i = threadIdx.x; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    qS[i] = (q0 + r < Sq) ? to_f32(qb[(q0 + r) * qs.s + d]) * scale : 0.f;
  }

  // the tiles this block must visit
  const int q_last = min(q0 + kBlockQ, Sq) - 1;
  long long lo_a, hi_a, lo_b, hi_b;
  key_range(static_cast<long long>(q_offset) + q0, Sk, causal, has_window, window, lo_a, hi_a);
  key_range(static_cast<long long>(q_offset) + q_last, Sk, causal, has_window, window, lo_b,
            hi_b);
  int k_begin = 0, k_end = Sk;
  if (lo_a <= hi_a && lo_b <= hi_b) {  // every row has a valid key: skip dead tiles
    k_begin = static_cast<int>(lo_a) / kBlockK * kBlockK;
    k_end = static_cast<int>(hi_b) + 1;
  }

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
      kS[j * ldk + d] = in ? to_f32(kb[(t0 + j) * ks.s + d]) : 0.f;
      vS[j * D + d] = in ? to_f32(vb[(t0 + j) * vs.s + d]) : 0.f;
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
      if (d < D) ob[row * os.s + d] = from_f32<T>(acc[r][i] / denom);
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int Sq,
           int Sk, int D, Strides qs, Strides ks, Strides vs, Strides os, int causal,
           int q_offset, int has_window, int window, float scale, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, DPL>;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBlockK) * (D + 1) +
                                       static_cast<size_t>(kBlockK) * D +
                                       static_cast<size_t>(kBlockQ) * D);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H / KV, Sq, Sk, D, qs, ks, vs, os, causal, q_offset, has_window,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int Sq,
             int Sk, int D, Strides qs, Strides ks, Strides vs, Strides os, int causal,
             int q_offset, int has_window, int window, float scale, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 1>(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal, q_offset,
                        has_window, window, scale, stream);
  if (D <= 64)
    return launch<T, 2>(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal, q_offset,
                        has_window, window, scale, stream);
  if (D <= 128)
    return launch<T, 4>(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal, q_offset,
                        has_window, window, scale, stream);
  return launch<T, 8>(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal, q_offset,
                      has_window, window, scale, stream);
}

}  // namespace

// Plain C entry point for ctypes.  q (B, H, Sq, D), k/v (B, KV, Sk, D) and
// o (B, H, Sq, D) by their batch, head and sequence strides (unit stride
// along D); bf16 != 0 means all four are bf16, else f32.  The wrapper keeps
// 1 <= D <= 256, H % KV == 0, Sq, Sk >= 1.  Launches on `stream`, does not
// synchronise, and returns the CUDA error code (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int bf16, int B, int H, int KV, int Sq, int Sk, int D,
                                      long long q_sb, long long q_sh, long long q_ss,
                                      long long k_sb, long long k_sh, long long k_ss,
                                      long long v_sb, long long v_sh, long long v_ss,
                                      long long o_sb, long long o_sh, long long o_ss,
                                      int causal, int q_offset, int has_window, int window,
                                      float scale, void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal,
                                   q_offset, has_window, window, scale, st);
  return launch_d<float>(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal, q_offset,
                         has_window, window, scale, st);
}
