// int8 GEMM with a fused requantization epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul_requant.py::_kernel
// (with its _round_shift_even epilogue): out = clip(requant(a @ w * mult +
// bias)), int8 x int8 -> int32 accumulate, then per output channel
// y = acc * mult + bias, an arithmetic right shift by S that floors or
// rounds half to even, optional ReLU, clip to [-128, 127].
//
// Two entries (matmul_requant_launch's `segment` flag) on one templated pair
// of kernels that share the loads, conversions and epilogue:
//  * int8: A (M, K) and W (K, N) int8 with any strides, int32 mult and
//    bias, int8 out: the TPU kernel's contract;
//  * segment, the GEMM segment of the compiled CNN path: A (M, K) the
//    segment's integer-valued float32 activations, W the dense weight as
//    stored, float32 (N, K), a float32 bias or none, no mult (read as 1),
//    float32 out.  Operands are converted in registers (cvt.rzi: truncation toward
//    zero, as Tensor.to(torch.int8) does), so a segment is this one launch
//    and no cast, fill or copy kernel around it.
//
// What bounds it on this card: the CNN path calls it at M = 1 per request
// and M = 16 per served batch, over at most K x N = 640 x 128 weights (80 KB
// int8, 320 KB float32).  Operations (at most 2.6 M) take under 0.01 µs at
// the int8 tensor-core rate and the bytes under 0.1 µs at 3.35 TB/s; what
// is left is the launch (about 1 µs, the floor of launch_floor.cu) and each
// warp's path: dependent trips to memory, and instructions, of which the
// float32 -> int8 conversions (F2I, a quarter-rate pipe) are the dearest.
// So every load of a warp is in flight at once, the epilogue's per-channel
// values are loaded first, nothing past K is loaded or converted, and:
//  * the int8 tensor cores (mma.sync m16n8k32): a block takes 16
//    rows of A (rows past M are zeros in registers, never loaded) and one to
//    eight n8 tiles of W, each tile's K split over a power of two of warps
//    (up to eight); each warp issues its loads of W first (per lane 16
//    consecutive k of one W row per 64-wide chunk, two chunks), while the
//    block stages its rows of A once in shared memory as packed int8
//    (cp.async for 16-byte aligned int8 A; float32 A converted on the way;
//    element loads where A is only 4-byte aligned, as a float32 arena view
//    may be); then two m16n8k32 products per chunk, the k order inside a
//    chunk permuted identically in A and B so that a lane's 16 loaded k feed
//    its own fragment registers (see mma_sm90.cuh); the warps of a K split
//    add their accumulators through shared memory in a fixed order and the
//    first runs the epilogue on its fragments.  A block has at least four
//    warps: those past its tiles only help stage A.  wgmma needs M = 64 and
//    four warps per product, four times the rows a served batch has.
//  * a plain __dp4a GEMV: one warp per output (m, n), its lanes along K
//    (one 4-element quad each per step).
// The rule (plan_of) takes the GEMV up to 512 blocks and the tensor cores
// beyond; the sweep in chip_smoke.py times both branches at M = 1 and 16 on
// the CNN path's shapes and across that knee.  The GEMV takes every M = 1
// call of the CNN path and DAE's served (16, K, N) but (16, 128, 640), by a
// shorter path per warp (at M = 1 the tensor cores would multiply 15 rows
// of zeros).
// Ragged M, N and K are predicated (N = 2 and 10 heads, K = 8 and 13 occur).
// K beyond 1024 is staged 1024 columns at a time (the GEMV: walked in
// passes of 1024).

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kRows = 16;                         // rows of A per block: the mma's M
constexpr int kChunk = 64;                        // k per chunk: two m16n8k32 steps
constexpr int kChunksPerWarp = 2;                 // chunks of W a warp holds in flight
constexpr int kSlice = kChunk * kChunksPerWarp;  // k per warp per stage
constexpr int kMaxWarps = 8;                      // warps per block
constexpr int kMinWarps = 4;                      // warps per block at least: they stage A
constexpr int kMaxSplit = 8;                      // warps along K per n8 tile
constexpr int kMaxStage = kMaxSplit * kSlice;     // k of A staged at once (1024)
// shared row pitch: the stage plus 64 bytes, an odd multiple of 64, so the
// 16-byte fragment reads of rows g and g + 1 fall in different bank halves
constexpr int kMaxPitch = kMaxStage + 64;
constexpr int kStageBatch = 4;  // 16-column groups of A a thread loads before it stores one
constexpr int kGemvWarps = 8;   // output columns per block of the GEMV branch
constexpr int kGemvQuads = 8;   // 4-column steps a lane of that branch loads at once
constexpr int kGemvSpan = kGemvQuads * 32 * 4;  // k per pass of its warp (1024)
constexpr int kMaxGridY = 65535;                // the largest gridDim.y
constexpr long long kGemvBlocks = 512;  // the rule's knee: the GEMV up to this many blocks (plan_of)
// which kernel a call takes: by the rule (plan_of), or either one forced, for
// the sweep that times both
enum Path : int { kByRule = 0, kTensorCores = 1, kGemv = 2 };

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

// one element as int8, in the low byte: float32 truncated toward zero
// (cvt.rzi, as Tensor.to(torch.int8) does inside int8 range)
__device__ __forceinline__ uint32_t byte_of(int8_t v) { return static_cast<uint8_t>(v); }
__device__ __forceinline__ uint32_t byte_of(float v) {
  return static_cast<uint32_t>(__float2int_rz(v)) & 0xffu;
}

// the bias as stored: int32 for the int8 entry, float32 for the segment
// entry (converted as Tensor.to(torch.int32) does: truncation toward zero)
template <typename T>
using Bias = std::conditional_t<std::is_same_v<T, float>, float, int32_t>;
__device__ __forceinline__ int32_t bias_of(int32_t b) { return b; }
__device__ __forceinline__ int32_t bias_of(float b) { return __float2int_rz(b); }

// How a row may be read: with any element stride, or with unit stride and
// rows 4- or 16-byte aligned (a float32 arena view may be 4-byte aligned only)
enum Access : int { kStrided = 0, kVec4 = 1, kVec16 = 2 };

// 4 consecutive k of one row, as loaded: kept in this form while the loads
// are in flight, packed to int8 only when the products need them
template <typename T>
struct Raw4;
template <>
struct Raw4<int8_t> {
  uint32_t v;
};
template <>
struct Raw4<float> {
  float4 v;
};

// elements kq .. kq + 3 one by one, zero past kend: only for a ragged K, a
// row not aligned for vector loads, or (sk != 1) a strided int8 weight
template <typename T>
__device__ __forceinline__ void quad_of(const T* row, int kq, int kend, long long sk, T (&v)[4]) {
  if (sk == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = kq + i < kend ? row[kq + i] : T(0);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = kq + i < kend ? row[(kq + i) * sk] : T(0);
  }
}

// elements k .. k + 3 of `row` (element stride `sk`), zero past `kend`: one
// vector load where `access` allows (float32 needs 16-byte rows, int8 4-byte
// rows), one by one otherwise; nothing is loaded past K
template <typename T>
__device__ __forceinline__ Raw4<T> load4(const T* row, int k, int kend, long long sk, int access) {
  Raw4<T> r;
  if constexpr (std::is_same_v<T, int8_t>) {
    r.v = 0;
    if (access != kStrided && k + 4 <= kend) {
      r.v = __ldg(reinterpret_cast<const uint32_t*>(row + k));
    } else if (k < kend) {
      int8_t v[4];
      quad_of(row, k, kend, sk, v);
      r.v = byte_of(v[0]) | (byte_of(v[1]) << 8) | (byte_of(v[2]) << 16) | (byte_of(v[3]) << 24);
    }
  } else {
    r.v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (access == kVec16 && k + 4 <= kend) {
      r.v = __ldg(reinterpret_cast<const float4*>(row + k));
    } else if (k < kend) {
      float v[4];
      quad_of(row, k, kend, sk, v);
      r.v = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  return r;
}

__device__ __forceinline__ uint32_t pack4(const Raw4<int8_t>& r) { return r.v; }
__device__ __forceinline__ uint32_t pack4(const Raw4<float>& r) {
  return byte_of(r.v.x) | (byte_of(r.v.y) << 8) | (byte_of(r.v.z) << 16) | (byte_of(r.v.w) << 24);
}

// 16 consecutive k of one row: four quads (int8 with 16-byte rows: one load)
template <typename T>
struct Raw16 {
  Raw4<T> q[4];
};

template <typename T>
__device__ __forceinline__ Raw16<T> load16(const T* row, int k, int kend, long long sk, int access) {
  Raw16<T> r;
  if constexpr (std::is_same_v<T, int8_t>) {
    if (access == kVec16 && k + 16 <= kend) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + k));
      r.q[0].v = v.x, r.q[1].v = v.y, r.q[2].v = v.z, r.q[3].v = v.w;
      return r;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) r.q[j] = load4(row, k + 4 * j, kend, sk, access);
  return r;
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const Raw16<T>& r) {
  return make_uint4(pack4(r.q[0]), pack4(r.q[1]), pack4(r.q[2]), pack4(r.q[3]));
}

// T: the element type of A and W (int8_t, or float: the segment entry, with
// a float32 bias and out and no mult).  Block: wn n8 tiles x
// 2^ks_log2 warps along K, warp = tile * 2^ks_log2 + split, and at least
// kMinWarps warps (the ones past wn tiles only help stage A).  Grid:
// (ceil(M / 16), ceil(ceil(N / 8) / wn)).  a_access, w_access: Access.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
    matmul_requant_mma_kernel(const T* __restrict__ a, const T* __restrict__ w,
                              const int32_t* __restrict__ mult, const void* __restrict__ bias,
                              void* __restrict__ out, int M, int N, int K, long long lda,
                              long long a_sk, long long w_sn, long long w_sk, int ks_log2, int wn,
                              int shift, int even, int relu, int a_access, int w_access) {
  constexpr bool kSegment = std::is_same_v<T, float>;
  constexpr bool kAsync = !kSegment;  // int8 A is copied to shared as it is
  __shared__ __align__(16) int8_t sa[kRows * kMaxPitch];
  __shared__ int4 red[kMaxWarps * 32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ks = 1 << ks_log2;
  const int split = warp & (ks - 1);
  // this warp's n8 tile (a helper warp's lies past N: it loads no W, stores nothing)
  const int tile = (warp >> ks_log2) < wn ? blockIdx.y * wn + (warp >> ks_log2) : (N + 7) / 8;
  const int m0 = blockIdx.x * kRows;
  const int rows = min(kRows, M - m0);
  const int n = tile * 8 + g;  // the W row (B column) this lane loads
  const int stage = kSlice << ks_log2;
  const int pitch = stage + 64;
  const int groups_log2 = ks_log2 + 3;  // 16-column groups per staged row: stage / 16
  const T* wrow = w + static_cast<long long>(min(n, N - 1)) * w_sn;

  // the epilogue's per-channel values of this lane's two columns, loaded
  // first so that their trip to memory overlaps the operands' (a float32
  // bias is converted only in the epilogue, so nothing waits for it here)
  int32_t mu[2];
  Bias<T> bi[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = tile * 8 + 2 * t + j;
    mu[j] = (mult != nullptr && col < N) ? mult[col] : 1;
    bi[j] = (bias != nullptr && col < N) ? static_cast<const Bias<T>*>(bias)[col] : Bias<T>(0);
  }

  int acc[4] = {0, 0, 0, 0};
  for (int kb = 0; kb < K; kb += stage) {
    // 1. every load of W this warp needs in the stage, issued first
    Raw16<T> wr[kChunksPerWarp];
#pragma unroll
    for (int c = 0; c < kChunksPerWarp; ++c) {
      const int k = kb + split * kSlice + c * kChunk + 16 * t;
      wr[c] = load16(wrow, k, n < N ? K : 0, w_sk, w_access);
    }
    // 2. the block's rows of A over the stage, as packed int8 in shared
    //    memory, columns past K zero up to the end of their chunk; a thread
    //    issues the loads of kStageBatch groups before it stores any
    const int units = rows << groups_log2;
    const int span = min(stage, (K - kb + kChunk - 1) / kChunk * kChunk);  // columns the chunks read
    for (int u0 = threadIdx.x; u0 < units; u0 += kStageBatch * blockDim.x) {
      Raw16<T> ra[kStageBatch];
#pragma unroll
      for (int j = 0; j < kStageBatch; ++j) {
        const int u = u0 + j * blockDim.x;
        if (u >= units) break;
        const int r = u >> groups_log2, c = (u & ((1 << groups_log2) - 1)) * 16;
        if (c >= span) continue;
        const T* arow = a + static_cast<long long>(m0 + r) * lda;
        if (kAsync && a_access == kVec16 && kb + c + 16 <= K) {
          mma_sm90::cp_async_16(sa + r * pitch + c, arow + kb + c, 16);
        } else {
          ra[j] = load16(arow, kb + c, K, a_sk, a_access);
        }
      }
#pragma unroll
      for (int j = 0; j < kStageBatch; ++j) {
        const int u = u0 + j * blockDim.x;
        if (u >= units) break;
        const int r = u >> groups_log2, c = (u & ((1 << groups_log2) - 1)) * 16;
        if (c >= span) continue;
        const bool copied = kAsync && a_access == kVec16 && kb + c + 16 <= K;  // by cp.async above
        if (!copied) *reinterpret_cast<uint4*>(sa + r * pitch + c) = pack16(ra[j]);
      }
    }
    // W packed before the barrier, so its loads cannot sink past it
    uint4 b[kChunksPerWarp];
#pragma unroll
    for (int c = 0; c < kChunksPerWarp; ++c) {
      b[c] = make_uint4(0, 0, 0, 0);
      if (kb + split * kSlice + c * kChunk < K) b[c] = pack16(wr[c]);  // no conversions past K
    }
    mma_sm90::cp_async_commit();
    mma_sm90::cp_async_wait<0>();
    __syncthreads();
    // 3. two m16n8k32 products per chunk.  Lane (g, t) holds k 16t .. 16t+15
    //    of the chunk in W's registers x, y, z, w; it reads the same k of
    //    rows g and g + 8 of A, so step one takes (x, y) and step two (z, w)
#pragma unroll
    for (int c = 0; c < kChunksPerWarp; ++c) {
      const int kc = split * kSlice + c * kChunk;
      if (kb + kc >= K) break;  // uniform across the warp
      const uint4 zero = make_uint4(0, 0, 0, 0);
      const uint4 lo = g < rows ? *reinterpret_cast<const uint4*>(sa + g * pitch + kc + 16 * t) : zero;
      const uint4 hi =
          g + 8 < rows ? *reinterpret_cast<const uint4*>(sa + (g + 8) * pitch + kc + 16 * t) : zero;
      const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y};
      const uint32_t a1[4] = {lo.z, hi.z, lo.w, hi.w};
      mma_sm90::mma_s8_16832(acc, a0, b[c].x, b[c].y);
      mma_sm90::mma_s8_16832(acc, a1, b[c].z, b[c].w);
    }
    __syncthreads();  // the next stage overwrites sa
  }

  // 4. the K split's partial sums, added in split order by the first warp
  if (ks > 1) {
    red[warp * 32 + lane] = make_int4(acc[0], acc[1], acc[2], acc[3]);
    __syncthreads();
    if (split != 0) return;
    for (int j = 1; j < ks; ++j) {
      const int4 v = red[(warp + j) * 32 + lane];
      acc[0] += v.x;
      acc[1] += v.y;
      acc[2] += v.z;
      acc[3] += v.w;
    }
  }

  // 5. epilogue on the fragments: lane (g, t) holds rows g and g + 8,
  //    columns 2t and 2t + 1 of the tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), col = tile * 8 + 2 * t + (i % 2);
    if (r >= rows || col >= N) continue;
    const int32_t y = requant(acc[i], mu[i % 2], bias_of(bi[i % 2]), shift, even != 0, relu != 0);
    const long long at = static_cast<long long>(m0 + r) * N + col;
    if constexpr (kSegment) {
      static_cast<float*>(out)[at] = static_cast<float>(y);
    } else {
      static_cast<int8_t*>(out)[at] = static_cast<int8_t>(y);
    }
  }
}

// One warp per output (m, n), its lanes along K (4 consecutive k each per
// step, up to kGemvQuads steps in flight), one __dp4a per step and a shuffle
// tree; the same loads, conversions and epilogue as above.  Grid: (column
// blocks, row groups); a block walks rows blockIdx.y, + gridDim.y, ...
template <typename T>
__global__ void __launch_bounds__(kGemvWarps * 32)
    matmul_requant_gemv_kernel(const T* __restrict__ a, const T* __restrict__ w,
                               const int32_t* __restrict__ mult, const void* __restrict__ bias,
                               void* __restrict__ out, int M, int N, int K, long long lda,
                               long long a_sk, long long w_sn, long long w_sk, int shift, int even,
                               int relu, int a_access, int w_access) {
  constexpr bool kSegment = std::is_same_v<T, float>;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kGemvWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // uniform across the warp
  int32_t mu = 1;
  Bias<T> bi(0);
  if (lane == 0) {  // the epilogue's values first, as in the tensor-core kernel
    if (mult != nullptr) mu = mult[n];
    if (bias != nullptr) bi = static_cast<const Bias<T>*>(bias)[n];
  }
  const T* wrow = w + static_cast<long long>(n) * w_sn;
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const T* arow = a + static_cast<long long>(m) * lda;
    int acc = 0;
    for (int kb = 0; kb < K; kb += kGemvSpan) {
      Raw4<T> wq[kGemvQuads];
      Raw4<T> aq[kGemvQuads];
#pragma unroll
      for (int i = 0; i < kGemvQuads; ++i) {
        if (kb + 128 * i >= K) break;  // uniform: no lane has a quad this far
        const int k = kb + 128 * i + 4 * lane;
        wq[i] = load4(wrow, k, K, w_sk, w_access);
        aq[i] = load4(arow, k, K, a_sk, a_access);
      }
#pragma unroll
      for (int i = 0; i < kGemvQuads; ++i) {
        if (kb + 128 * i >= K) break;
        acc = __dp4a(static_cast<int>(pack4(aq[i])), static_cast<int>(pack4(wq[i])), acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const int32_t y = requant(acc, mu, bias_of(bi), shift, even != 0, relu != 0);
      const long long at = static_cast<long long>(m) * N + n;
      if constexpr (kSegment) {
        static_cast<float*>(out)[at] = static_cast<float>(y);
      } else {
        static_cast<int8_t*>(out)[at] = static_cast<int8_t>(y);
      }
    }
  }
}

struct Plan {
  bool gemv;    // the GEMV branch
  int ks_log2;  // tensor cores: 2^ks_log2 warps along K per n8 tile
  int wn;       // tensor cores: n8 tiles per block
  dim3 grid;    // tensor cores: (row tiles, n8 tile groups); GEMV: (column blocks, row groups)
  int threads;  // tensor cores: (n8 tiles per block) x 2^ks_log2 warps
};

// The rule: the GEMV up to kGemvBlocks blocks (M x ceil(N / 8), each eight
// outputs of one row), the tensor cores beyond.  Each warp of the GEMV is short, but with one per
// output (m, n) the blocks outnumber what the card runs at once, and there
// the tensor cores' 16 rows x 8 columns per warp, W read once per 16 rows,
// win.  The knee is the branch sweep's in chip_smoke.py (NVIDIA H100 80GB
// HBM3): the GEMV faster for both entries at 512 blocks and below, the
// tensor cores at 768 and above, DAE's served (16, 128, 640) among them.
Plan plan_of(int M, int N, int K, int path) {
  const long long gemv_blocks = static_cast<long long>(M) * ((N + kGemvWarps - 1) / kGemvWarps);
  if (path == kGemv || (path == kByRule && gemv_blocks <= kGemvBlocks)) {
    return {true, 0, 0, dim3((N + kGemvWarps - 1) / kGemvWarps, std::min(M, kMaxGridY)), kGemvWarps * 32};
  }
  const int tiles = (N + 7) / 8;
  int ks_log2 = 0;  // the fewest warps along K, a power of two, that cover K in one stage
  while ((kSlice << ks_log2) < K && (1 << ks_log2) < kMaxSplit) ++ks_log2;
  const int wn = std::min(kMaxWarps >> ks_log2, tiles);
  return {false, ks_log2, wn, dim3((M + kRows - 1) / kRows, (tiles + wn - 1) / wn),
          std::max(wn << ks_log2, kMinWarps) * 32};
}

// how rows of `elem`-byte elements `pitch` elements apart, stride `sk`, may be read
int access_of(const void* p, long long pitch, long long sk, int elem) {
  if (sk != 1) return kStrided;
  const auto at = reinterpret_cast<uintptr_t>(p);
  const long long bytes = pitch * elem;
  if (at % 16 == 0 && bytes % 16 == 0) return kVec16;
  return (at % 4 == 0 && bytes % 4 == 0) ? kVec4 : kStrided;
}

template <typename T>
int launch(const void* a, const void* w, const void* mult, const void* bias, void* out, int M, int N,
           int K, long long lda, long long a_sk, long long w_sn, long long w_sk, int shift, int even,
           int relu, int path, cudaStream_t stream) {
  const Plan p = plan_of(M, N, K, path);
  const int a_access = access_of(a, lda, a_sk, sizeof(T)), w_access = access_of(w, w_sn, w_sk, sizeof(T));
  const auto* at = static_cast<const T*>(a);
  const auto* wt = static_cast<const T*>(w);
  const auto* mt = static_cast<const int32_t*>(mult);
  if (p.gemv) {
    matmul_requant_gemv_kernel<T><<<p.grid, p.threads, 0, stream>>>(
        at, wt, mt, bias, out, M, N, K, lda, a_sk, w_sn, w_sk, shift, even, relu, a_access, w_access);
  } else {
    if (p.grid.y > kMaxGridY) return static_cast<int>(cudaErrorInvalidConfiguration);
    matmul_requant_mma_kernel<T><<<p.grid, p.threads, 0, stream>>>(
        at, wt, mt, bias, out, M, N, K, lda, a_sk, w_sn, w_sk, p.ks_log2, p.wn, shift, even, relu,
        a_access, w_access);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  Element (m, k) of A is a[m * lda + k *
// a_sk] and element (k, n) of the product's right operand is w[n * w_sn + k *
// w_sk] (strides in elements).  segment = 0: int8 A and W, int32 mult and
// bias, int8 out; segment = 1: float32 A and W, mult null, float32 bias or
// null, float32 out.  Out is (M, N) contiguous.
// path: Path (kByRule but for the sweep).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int matmul_requant_launch(const void* a, const void* w, const void* mult,
                                     const void* bias, void* out, int M, int N, int K,
                                     long long lda, long long a_sk, long long w_sn, long long w_sk,
                                     int shift, int even, int relu, int segment, int path,
                                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return segment ? launch<float>(a, w, mult, bias, out, M, N, K, lda, a_sk, w_sn, w_sk, shift, even,
                                 relu, path, s)
                 : launch<int8_t>(a, w, mult, bias, out, M, N, K, lda, a_sk, w_sn, w_sk, shift, even,
                                  relu, path, s);
}

// The launch shape of an (M, K) x (K, N) call on `path`: blocks in all,
// threads per block, and the branch taken (kTensorCores or kGemv).
extern "C" void matmul_requant_launch_shape(int M, int N, int K, int path, int* blocks, int* threads,
                                            int* branch) {
  const Plan p = plan_of(M, N, K, path);
  *blocks = static_cast<int>(p.grid.x * p.grid.y);
  *threads = p.threads;
  *branch = p.gemv ? kGemv : kTensorCores;
}
