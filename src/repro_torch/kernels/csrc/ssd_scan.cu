// Mamba-2 SSD chunk scan with a carried state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::_kernel and
// also returns the final state, as src/repro/models/ssd.py::ssd_chunked_ref
// does (prefill writes it to the cache).  Per (batch b, head h), over time
// chunks of kL rows, with the (P, N) state h carried from chunk to chunk:
//
//   a_cs   = cumsum(a) over the chunk
//   S[i,j] = (C_i . B_j) exp(a_cs_i - a_cs_j)          for j <= i, else 0
//   y_i    = sum_j S[i,j] xb_j + exp(a_cs_i) (C_i . h_p)   for every p
//   h     <- exp(a_cs_last) h + sum_j exp(a_cs_last - a_cs_j) xb_j B_j^T
//
// which is the dual form of h_t = e^{a_t} h_{t-1} + xb_t B_t^T,
// y_t = h_t C_t.  Inputs: xb (B, H, T, P) and a (B, H, T) in f32, Bm and Cm
// (B, T, N) in f32 or bf16, all read through their strides; outputs y
// (B, H, T, P) f32 through its strides and h_final (B, H, P, N) f32,
// contiguous.  All arithmetic is fp32.
//
// What bounds it on this card: per token and head the recurrence needs
// about 5 P N flops (decay, outer product, add; then the read-out), and the
// function moves xb, y and the final state.  At mamba2-1.3b's serving
// prefill (B=4, T=24, H=64, P=64, N=128) the two bounds are close (about
// 0.004 ms each: 8.4 MB of final state, and 0.25 GFLOP at the 67 TFLOP/s
// the card has for fp32 outside the tensor cores); long prompts are bound
// by the flops.
//
// This first kernel is built to be right.  One block of 256 threads owns one
// (b, h) and walks the chunks in order: that loop takes the place of the
// TPU's sequential grid axis, and nothing carries between blocks.  The
// state lives in shared memory for the whole walk (P x (N + 1) floats, 33
// KB at P = 64, N = 128), with one chunk's B (padded to N + 1), C, xb and
// the masked scores beside it: 79 KB in all at kL = 32, so two blocks fit
// on an SM.  A chunk of 128 rows, the reference's, would not fit 227 KB in
// fp32; the chunk length only changes the rounding.  The cumulative sum is
// one warp's shuffle scan (one row per lane).  Rows past T are loaded as
// zeros with a = 0, which leaves both y and the final state exact.  The
// products run as fp32 FMA on the CUDA cores, reading both operands from
// shared memory; the padded rows keep a warp's 32 reads in distinct banks.
// A tensor-core chunk product and a register-blocked state update are later
// work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 32;  // chunk rows: one per lane of the scan warp
constexpr int kThreads = 256;
constexpr int kLdS = kL + 1;  // padded row of the score tile
constexpr unsigned kFull = 0xffffffffu;

struct Strides4 {
  long long b, h, t, p;
};
struct StridesA {
  long long b, h, t;
};
struct StridesBC {
  long long b, t, n;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TB>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ xb, const float* __restrict__ a,
                    const TB* __restrict__ Bm, const TB* __restrict__ Cm, float* __restrict__ y,
                    float* __restrict__ h_out, int H, int T, int P, int N, Strides4 xs,
                    StridesA as, StridesBC bs, StridesBC cs, Strides4 ys) {
  extern __shared__ float smem[];
  const int ldh = N + 1;
  float* hS = smem;              // [P][N + 1]  the carried state
  float* bS = hS + P * ldh;      // [kL][N + 1]
  float* cS = bS + kL * ldh;     // [kL][N]
  float* xS = cS + kL * N;       // [kL][P]
  float* sS = xS + kL * P;       // [kL][kL + 1] masked scores
  float* acs = sS + kL * kLdS;   // [kL] cumulative a
  float* dec = acs + kL;         // [kL] exp(a_cs_last - a_cs_j)
  float* eac = dec + kL;         // [kL] exp(a_cs_i)

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float* xbb = xb + b * xs.b + h * xs.h;
  const float* ab = a + b * as.b + h * as.h;
  const TB* Bb = Bm + b * bs.b;
  const TB* Cb = Cm + b * cs.b;
  float* yb = y + b * ys.b + h * ys.h;

  for (int i = tid; i < P * ldh; i += kThreads) hS[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += kL) {
    const int n = min(kL, T - t0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < kL * P; i += kThreads) {
      const int j = i / P, p = i - j * P;
      xS[i] = j < n ? xbb[(t0 + j) * xs.t + p * xs.p] : 0.f;
    }
    for (int i = tid; i < kL * N; i += kThreads) {
      const int j = i / N, k = i - j * N;
      const bool in = j < n;
      bS[j * ldh + k] = in ? to_f32(Bb[(t0 + j) * bs.t + k * bs.n]) : 0.f;
      cS[i] = in ? to_f32(Cb[(t0 + j) * cs.t + k * cs.n]) : 0.f;
    }
    if (tid < kL) {  // inclusive scan of a over the chunk; rows past T add 0
      float v = tid < n ? ab[(t0 + tid) * as.t] : 0.f;
#pragma unroll
      for (int off = 1; off < kL; off <<= 1) {
        const float u = __shfl_up_sync(kFull, v, off);
        if (tid >= off) v += u;
      }
      const float last = __shfl_sync(kFull, v, kL - 1);
      acs[tid] = v;
      dec[tid] = expf(last - v);
      eac[tid] = expf(v);
    }
    __syncthreads();

    // masked scores; a warp has one row i and lane j (B rows padded: no conflicts)
    for (int idx = tid; idx < kL * kL; idx += kThreads) {
      const int i = idx / kL, j = idx - i * kL;
      float s = 0.f;
      if (j <= i && i < n) {
        const float* ci = cS + i * N;
        const float* bj = bS + j * ldh;
        for (int k = 0; k < N; ++k) s = fmaf(ci[k], bj[k], s);
        s *= expf(acs[i] - acs[j]);
      }
      sS[i * kLdS + j] = s;
    }
    __syncthreads();

    // outputs of the chunk's valid rows; a warp has one row i and lanes on p
    for (int idx = tid; idx < n * P; idx += kThreads) {
      const int i = idx / P, p = idx - i * P;
      const float* si = sS + i * kLdS;
      float yd = 0.f;
      for (int j = 0; j <= i; ++j) yd = fmaf(si[j], xS[j * P + p], yd);
      const float* ci = cS + i * N;
      const float* hp = hS + p * ldh;
      float yo = 0.f;
      for (int k = 0; k < N; ++k) yo = fmaf(ci[k], hp[k], yo);
      yb[(t0 + i) * ys.t + p * ys.p] = yd + yo * eac[i];
    }
    __syncthreads();  // every read of the old state is done

    // state update; a warp has one p and lanes on k
    const float total = eac[kL - 1];
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, k = idx - p * N;
      float v = hS[p * ldh + k] * total;
      for (int j = 0; j < n; ++j) v = fmaf(dec[j] * xS[j * P + p], bS[j * ldh + k], v);
      hS[p * ldh + k] = v;
    }
  }
  __syncthreads();
  float* hb = h_out + (static_cast<long long>(b) * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, k = idx - p * N;
    hb[idx] = hS[p * ldh + k];
  }
}

size_t smem_bytes(int P, int N) {
  return sizeof(float) * (static_cast<size_t>(P) * (N + 1) + static_cast<size_t>(kL) * (N + 1) +
                          static_cast<size_t>(kL) * N + static_cast<size_t>(kL) * P +
                          static_cast<size_t>(kL) * kLdS + 3 * kL);
}

template <typename TB>
int launch(const float* xb, const float* a, const void* Bm, const void* Cm, float* y,
           float* h_out, int B, int H, int T, int P, int N, Strides4 xs, StridesA as,
           StridesBC bs, StridesBC cs, Strides4 ys, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<TB>;
  const size_t smem = smem_bytes(P, N);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(H, B), kThreads, smem, stream>>>(xb, a, static_cast<const TB*>(Bm),
                                               static_cast<const TB*>(Cm), y, h_out, H, T, P, N,
                                               xs, as, bs, cs, ys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs, in bytes (the wrapper refuses more than
// the card's 227 KB).
extern "C" long long ssd_scan_smem_bytes(int P, int N) {
  return static_cast<long long>(smem_bytes(P, N));
}

// Plain C entry point for ctypes.  xb (B, H, T, P) and y by four strides
// each, a (B, H, T), Bm and Cm (B, T, N) by three, in elements; h_out is a
// contiguous (B, H, P, N) f32 buffer.  bf16 != 0 means Bm and Cm are bf16,
// else f32; xb, a and y are always f32.  The wrapper keeps B <= 65535,
// H >= 1, P, N >= 1 and the shared memory within the card's limit.
// Launches on `stream`, does not synchronise, and returns the CUDA error
// code (0 = launched).
extern "C" int ssd_scan_launch(const void* xb, const void* a, const void* Bm, const void* Cm,
                               void* y, void* h_out, int bf16, int B, int H, int T, int P, int N,
                               long long xb_sb, long long xb_sh, long long xb_st, long long xb_sp,
                               long long a_sb, long long a_sh, long long a_st, long long b_sb,
                               long long b_st, long long b_sn, long long c_sb, long long c_st,
                               long long c_sn, long long y_sb, long long y_sh, long long y_st,
                               long long y_sp, void* stream) {
  const Strides4 xs{xb_sb, xb_sh, xb_st, xb_sp}, ys{y_sb, y_sh, y_st, y_sp};
  const StridesA as{a_sb, a_sh, a_st};
  const StridesBC bs{b_sb, b_st, b_sn}, cs{c_sb, c_st, c_sn};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(xb);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_out);
  if (bf16)
    return launch<__nv_bfloat16>(xf, af, Bm, Cm, yf, hf, B, H, T, P, N, xs, as, bs, cs, ys, st);
  return launch<float>(xf, af, Bm, Cm, yf, hf, B, H, T, P, N, xs, as, bs, cs, ys, st);
}
