// Mamba-2 SSD chunk scan with a carried state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::_kernel and
// also returns the final state, as src/repro/models/ssd.py::ssd_chunked_ref
// does (prefill writes it to the cache).  Per (batch b, head h), over time
// chunks of kL rows, with the (P, N) state carried from chunk to chunk:
//
//   a_cs   = cumsum(a) over the chunk
//   S[i,j] = (C_i . B_j) exp(a_cs_i - a_cs_j)              for j <= i, else 0
//   s_c    = sum_j exp(a_cs_last - a_cs_j) xb_j B_j^T         the chunk's own state
//   h_c    = exp(a_cs_last) h_{c-1} + s_c                     the carry
//   y_i    = sum_j S[i,j] xb_j + exp(a_cs_i) (C_i . h_{c-1})   for every p
//
// which is the dual form of h_t = e^{a_t} h_{t-1} + xb_t B_t^T,
// y_t = h_t C_t.  Inputs: xb (B, H, T, P) and a (B, H, T) in f32, Bm and Cm
// (B, T, N) in f32 or bf16, all read through their strides; outputs y
// (B, H, T, P) f32 through its strides and h_final (B, H, P, N) f32,
// contiguous.  All arithmetic is fp32.  Every exponent is a difference of
// one chunk's own cumulative sum (or that sum itself, which is <= 0), never
// a sum over the sequence: exp of that underflows, and its differences
// cancel.
//
// What bounds it on this card: the flops.  Per token and head the dual form
// needs 2 P N multiply-adds for the chunk state, P N for the read-out of the
// carried state and about kL P / 2 for the masked scores' product, all in
// fp32 (67 TFLOP/s outside the tensor cores); the bytes (xb and y once, the
// final state, B and C) are a quarter of that time at mamba2-1.3b's long
// prefill (H = 64, P = 64, N = 128).  The chunk states this design keeps in
// device memory add 4 passes of B H T P N / kL floats (the state kernel's
// write, the carry's read and write, the output kernel's read): 0.54 GB,
// about 0.16 ms at 3.35 TB/s, at (1, 4096).
//
// The design: three kernels per call, each parallel over the chunks (the
// old design, one block per (b, h) walking the chunks in order, left 68 of
// 132 SMs idle at B = 1 and read every FMA operand from shared memory).
//   1. state   grid (chunk, head, batch): a_cs by one warp's shuffle scan,
//              then s_c = (w xb)^T B as a (P, N) product over the chunk's
//              rows, w_j = exp(a_cs_last - a_cs_j); writes s_c and a_cs_last
//              to scratch the wrapper allocates (ssd_scan_scratch_floats).
//   2. carry   one thread per four elements of (b, h, p, n): walks the
//              chunks in order, h = exp(a_cs_last) h + s_c, overwriting each
//              s_c with the state that enters its chunk, and writes h_final.
//              It loads eight chunks' states before it stores any, to keep
//              the memory busy.  A call of one chunk skips it: kernel 1 then
//              writes h_final itself.
//   3. output  grid (chunk, group of G heads, batch), G picked by the
//              wrapper from the card's SM count: C . B^T once per (b, chunk)
//              for the G heads of the block (Bm and Cm have no head
//              index), kept in registers; then per head the masked
//              scores, y = S xb + exp(a_cs) C h_{c-1}, written once.  The
//              carried state is copied in by cp.async while the masked
//              scores' product runs.
// The masked scores' product sits in kernel 3 rather than in kernel 1, so y
// is written once and no (B, H, T, P) scratch is written and read again.
// Every product is register-tiled: each thread owns a 4 x 4 (kernel 3) or
// 4 x 8 (kernel 1) tile of the output and reads its operands from shared
// memory as 16-byte vectors, one vector feeding 4 to 8 FMAs, in layouts
// where a warp's vectors fall in distinct banks or are one broadcast.
// Operands are staged a warp per row, four elements a lane, as one 16-byte
// (f32) or 8-byte (bf16) load where the strides and alignment allow it (the
// model's views always do), else element by element.
// The products run in fp32 on the CUDA cores, not on the tensor cores:
// TF32 errs by about 5e-4 per product, beyond the 2e-4 that the port holds
// the kernel to, and a split (3xTF32) product would triple the tensor-core
// work and its register fragments for a kernel whose chunk products are
// 64 x 64 x 128; the fp32 rate puts the long prefill's floor at 0.16 ms.
// Chunks are kL = 64 rows: kernel 3 then needs 103 KB of shared memory at
// P = 64, N = 128 and two blocks fit on an SM (128 rows would need about
// 200 KB, one block).  Rows past T are loaded as zeros with a = 0, which
// leaves both y and the final state exact.  Nothing synchronises with the
// host: the three launches capture in one CUDA graph.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// 16 bytes global -> shared, bypassing L1; the first src_bytes come from src
// and the rest are zero (src must be a valid address).  Both 16-byte aligned.
__device__ __forceinline__ void cp_async_16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

constexpr int kL = 64;          // chunk rows
constexpr int kThreads = 256;   // kernels 1 and 3
constexpr int kWarps = kThreads / 32;
constexpr int kLdL = kL + 4;    // row pitch of a kL-wide tile: 16-byte rows, 4 banks apart
constexpr int kPB = 64;         // rows of p that kernel 3 handles at once
constexpr int kCarryThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kL == 64, "chunk_cumsum gives each lane of one warp two rows");
static_assert(kPB == kL, "rS holds kL rows of B, then kPB rows of the state");

// bits of the `vec` argument: which operands are read as 4-element vectors
constexpr int kVecX = 1;   // xb: unit p stride, P % 4 == 0, rows on 16 bytes
constexpr int kVecBC = 2;  // Bm and Cm: unit n stride, N % 4 == 0, rows on 4 elements
constexpr int kVecH = 4;   // the carried states (the wrapper's scratch): N % 4 == 0

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

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// four consecutive elements from global memory, as one 16- or 8-byte load
__device__ __forceinline__ float4 vec_load4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 vec_load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Elements k .. k + 3 of a row of K elements at stride sk, zero past K: one
// vector load when `vec` (then sk == 1 and K % 4 == 0), else four loads.
template <typename TE>
__device__ __forceinline__ float4 load_row4(const TE* row, int k, long long sk, int K, bool vec) {
  if (vec) return k < K ? vec_load4(row + k) : make_float4(0.f, 0.f, 0.f, 0.f);
  float r[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) r[u] = k + u < K ? to_f32(row[(k + u) * sk]) : 0.f;
  return make_float4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ float4 scale4(float s, float4 v) {
  return make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
}

__device__ __forceinline__ float dot4(float4 u, float4 v, float acc) {
  acc = fmaf(u.x, v.x, acc);
  acc = fmaf(u.y, v.y, acc);
  acc = fmaf(u.z, v.z, acc);
  return fmaf(u.w, v.w, acc);
}

// Inclusive cumulative sum of the chunk's a (rows at or past n add 0) into
// acs[0..kL), by warp 0, two rows per lane; with `dec`, also
// dec[j] = exp(a_cs_last - a_cs_j); with `eac`, eac[i] = exp(a_cs_i).
// Returns a_cs_last to the lanes of warp 0.  The caller syncs before
// reading the arrays.
__device__ __forceinline__ float chunk_cumsum(const float* ab, long long st, int t0, int n, float* acs,
                                              float* dec, float* eac) {
  const int l = threadIdx.x;
  const int r0 = 2 * l, r1 = 2 * l + 1;
  const float v0 = r0 < n ? ab[(t0 + r0) * st] : 0.f;
  const float v1 = r1 < n ? ab[(t0 + r1) * st] : 0.f;
  float s = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, s, off);
    if (l >= off) s += u;
  }
  float before = __shfl_up_sync(kFull, s, 1);  // the sum of the rows before r0
  if (l == 0) before = 0.f;
  const float c0 = before + v0, c1 = c0 + v1;
  const float last = __shfl_sync(kFull, c1, 31);
  acs[r0] = c0;
  acs[r1] = c1;
  if (dec != nullptr) {
    dec[r0] = expf(last - c0);
    dec[r1] = expf(last - c1);
  }
  if (eac != nullptr) {
    eac[r0] = expf(c0);
    eac[r1] = expf(c1);
  }
  return last;
}

// The chunk's rows of Bm or Cm into a [kL][ld] f32 tile, zero past n rows
// and N columns: a warp per row, four columns a lane.
template <typename TB>
__device__ __forceinline__ void fill_bc(float* dst, int ld, const TB* src, StridesBC s, int t0, int n,
                                        int N, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < kL; j += kWarps) {
    const TB* row = src + (t0 + j) * s.t;
    for (int k = 4 * lane; k < ld; k += 128)
      st4(dst + j * ld + k, j < n ? load_row4(row, k, s.n, N, vec) : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// ---------------------------------------------------------------------------
// 1. the chunk's own state: s_c[p][n] = sum_j w_j xb_j[p] B_j[n]
// ---------------------------------------------------------------------------

// Shared memory: xw [kL][4 PT], bS [kL][8 NT], acs and dec [kL] each.
size_t state_smem_bytes(int P, int N) {
  const size_t PT = (P + 3) / 4, NT = (N + 7) / 8;
  return sizeof(float) * (static_cast<size_t>(kL) * (4 * PT + 8 * NT) + 2 * kL);
}

template <typename TB>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_state_kernel(const float* __restrict__ xb, const float* __restrict__ a,
                          const TB* __restrict__ Bm, float* __restrict__ states,
                          float* __restrict__ totals, int H, int T, int P, int N, int nc, int vec,
                          Strides4 xs, StridesA as, StridesBC bs) {
  extern __shared__ float4 smem4[];
  const int PT = (P + 3) / 4, NT = (N + 7) / 8;
  const int ldx = 4 * PT, ldb = 8 * NT;
  float* xw = reinterpret_cast<float*>(smem4);  // [kL][ldx]  w_j xb_j, zero-padded
  float* bS = xw + kL * ldx;                    // [kL][ldb]  B_j, zero-padded
  float* acs = bS + kL * ldb;                   // [kL]
  float* dec = acs + kL;                        // [kL]  w_j

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t0 = c * kL, n = min(kL, T - t0);
  const long long bh = static_cast<long long>(b) * H + h;
  if (tid < 32) {
    const float last = chunk_cumsum(a + b * as.b + h * as.h, as.t, t0, n, acs, dec, nullptr);
    if (tid == 0 && totals != nullptr) totals[bh * nc + c] = last;
  }
  fill_bc(bS, ldb, Bm + b * bs.b, bs, t0, n, N, vec & kVecBC);
  __syncthreads();  // dec is ready
  const float* xbb = xb + b * xs.b + h * xs.h;
  for (int j = warp; j < kL; j += kWarps) {
    const float* row = xbb + (t0 + j) * xs.t;
    for (int p = 4 * lane; p < ldx; p += 128)
      st4(xw + j * ldx + p, j < n ? scale4(dec[j], load_row4(row, p, xs.p, P, vec & kVecX))
                                  : make_float4(0.f, 0.f, 0.f, 0.f));
  }
  __syncthreads();

  // A thread owns rows p in [4 tp, 4 tp + 4) and columns n in [4 tn, 4 tn + 4)
  // and [4 NT + 4 tn, ...): a warp reads 16 consecutive vectors of bS (no
  // conflict) and two of xw (broadcast).
  float* out = states + (bh * nc + c) * static_cast<long long>(P) * N;
  for (int tile = tid; tile < PT * NT; tile += kThreads) {
    const int tn = tile % NT, tp = tile / NT;
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 x4 = ld4(xw + j * ldx + 4 * tp);
      const float4 b0 = ld4(bS + j * ldb + 4 * tn);
      const float4 b1 = ld4(bS + j * ldb + 4 * NT + 4 * tn);
      const float xr[4] = {x4.x, x4.y, x4.z, x4.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(xr[r], br[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = 4 * tp + r;
      if (p >= P) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k0 = half * 4 * NT + 4 * tn;
        float* dst = out + static_cast<long long>(p) * N + k0;
        if ((N & 3) == 0) {
          if (k0 < N)
            st4(dst, make_float4(acc[r][4 * half], acc[r][4 * half + 1], acc[r][4 * half + 2],
                                 acc[r][4 * half + 3]));
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (k0 + q < N) dst[q] = acc[r][4 * half + q];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the carry across chunks, in place: states[c] <- the state entering c
// ---------------------------------------------------------------------------

constexpr int kCarryU = 8;  // chunks whose states are loaded together

__device__ __forceinline__ float axpy(float e, float h, float v) { return fmaf(e, h, v); }
__device__ __forceinline__ float4 axpy(float e, float4 h, float4 v) {
  return make_float4(fmaf(e, h.x, v.x), fmaf(e, h.y, v.y), fmaf(e, h.z, v.z), fmaf(e, h.w, v.w));
}

// V = float4 when P N % 4 == 0 (four elements a thread), else float;
// PNv = P N / (elements of V).
template <typename V>
__global__ void __launch_bounds__(kCarryThreads)
    ssd_scan_carry_kernel(V* __restrict__ states, const float* __restrict__ totals, V* __restrict__ h_out,
                          long long BH, long long PNv, int nc) {
  const long long e = static_cast<long long>(blockIdx.x) * kCarryThreads + threadIdx.x;
  if (e >= BH * PNv) return;
  const long long bh = e / PNv;
  V* s = states + bh * nc * PNv + (e - bh * PNv);
  const float* tot = totals + bh * nc;
  V h{};
  int c0 = 0;
  // the loads of kCarryU chunks are issued before their stores: each address
  // is read once and then written once, in that order
  for (; c0 + kCarryU <= nc; c0 += kCarryU) {
    V v[kCarryU];
#pragma unroll
    for (int u = 0; u < kCarryU; ++u) v[u] = s[(c0 + u) * PNv];
#pragma unroll
    for (int u = 0; u < kCarryU; ++u) {
      s[(c0 + u) * PNv] = h;
      h = axpy(expf(tot[c0 + u]), h, v[u]);
    }
  }
  for (int c = c0; c < nc; ++c) {
    const V v = s[c * PNv];
    s[c * PNv] = h;
    h = axpy(expf(tot[c]), h, v);
  }
  h_out[e] = h;
}

// ---------------------------------------------------------------------------
// 3. the output: y_i = sum_j S[i,j] xb_j + exp(a_cs_i) C_i . h_{c-1}
// ---------------------------------------------------------------------------

// Shared memory: cS [kL][ldk], rS [kPB][ldk] (B rows, then a block of the
// carried state), sS [kL][kLdL], xT [kPB][kLdL], acs and eac [kL] each;
// ldk = N rounded up to 4, plus 4.
size_t output_smem_bytes(int N) {
  const size_t ldk = 4 * ((N + 3) / 4) + 4;
  return sizeof(float) * ((static_cast<size_t>(kL) + kPB) * ldk + (static_cast<size_t>(kL) + kPB) * kLdL + 2 * kL);
}

template <typename TB>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_output_kernel(const float* __restrict__ xb, const float* __restrict__ a,
                           const TB* __restrict__ Bm, const TB* __restrict__ Cm,
                           const float* __restrict__ states, float* __restrict__ y, int H, int T, int P,
                           int N, int nc, int G, int vec, Strides4 xs, StridesA as, StridesBC bs,
                           StridesBC cs, Strides4 ys) {
  extern __shared__ float4 smem4[];
  const int kN = 4 * ((N + 3) / 4), ldk = kN + 4;
  float* cS = reinterpret_cast<float*>(smem4);  // [kL][ldk]  C rows, zero-padded
  float* rS = cS + kL * ldk;                    // [kPB][ldk] B rows, then h_{c-1}[p][n]
  float* sS = rS + kPB * ldk;                   // [kL][kLdL] masked scores of one head
  float* xT = sS + kL * kLdL;                   // [kPB][kLdL] xb^T: xT[p][j]
  float* acs = xT + kPB * kLdL;                 // [kL]
  float* eac = acs + kL;                        // [kL] exp(a_cs_i)

  const int c = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t0 = c * kL, n = min(kL, T - t0);
  // A thread owns output rows i = ti + 16 r and columns tp + 16 q (j for
  // C.B^T, p for y), r, q < 4.  A warp has 16 consecutive tp and two ti:
  // its vectors of the column operand are 16 rows 4 banks apart (no
  // conflict), those of the row operand two broadcasts, and its stores of y
  // are runs of 16 consecutive p.
  const int tp = tid & 15, ti = tid >> 4;

  fill_bc(cS, ldk, Cm + b * cs.b, cs, t0, n, N, vec & kVecBC);
  fill_bc(rS, ldk, Bm + b * bs.b, bs, t0, n, N, vec & kVecBC);
  __syncthreads();

  // C . B^T for every head of the block, kept in registers
  float cb[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) cb[r][q] = 0.f;
  for (int k = 0; k < kN; k += 4) {
    float4 ci[4], bj[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) ci[r] = ld4(cS + (ti + 16 * r) * ldk + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) bj[q] = ld4(rS + (tp + 16 * q) * ldk + k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) cb[r][q] = dot4(ci[r], bj[q], cb[r][q]);
  }
  const int jn = (n + 3) & ~3;  // score columns past n are zero
  const bool vec_x = vec & kVecX, vec_h = vec & kVecH;

  for (int g = 0; g < G; ++g) {
    const int h = blockIdx.y * G + g;
    if (h >= H) break;
    const long long bh = static_cast<long long>(b) * H + h;
    __syncthreads();  // the previous head (or C . B^T) no longer reads sS, xT, rS, acs
    if (tid < 32) chunk_cumsum(a + b * as.b + h * as.h, as.t, t0, n, acs, nullptr, eac);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti + 16 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = tp + 16 * q;
        sS[i * kLdL + j] = (j <= i && i < n) ? cb[r][q] * expf(acs[i] - acs[j]) : 0.f;
      }
    }
    const float* xbh = xb + b * xs.b + h * xs.h;
    const float* hprev = states + (bh * nc + c) * static_cast<long long>(P) * N;
    float* yh = y + b * ys.b + h * ys.h;
    for (int p0 = 0; p0 < P; p0 += kPB) {
      if (p0 > 0) __syncthreads();  // the previous block of p no longer reads xT, rS
      // the carried state's rows p0 .. p0 + kPB, in flight while the masked
      // scores' product runs
      if (c > 0) {
        if (vec_h) {
          for (int p = warp; p < kPB; p += kWarps) {
            const float* row = hprev + static_cast<long long>(p0 + p) * N;
            for (int k = 4 * lane; k < ldk; k += 128) {
              const bool in = p0 + p < P && k < N;
              cp_async_16(rS + p * ldk + k, in ? row + k : hprev, in ? 16 : 0);
            }
          }
          cp_async_commit();
        } else {
          for (int p = warp; p < kPB; p += kWarps) {
            const float* row = hprev + static_cast<long long>(p0 + p) * N;
            for (int k = 4 * lane; k < ldk; k += 128)
              st4(rS + p * ldk + k, p0 + p < P ? load_row4(row, k, 1, N, false) : make_float4(0.f, 0.f, 0.f, 0.f));
          }
        }
      }
      // xb^T: a half-warp per row j, four p a lane
      for (int j = 2 * warp + (lane >> 4); j < kL; j += 2 * kWarps) {
        const int p = 4 * (lane & 15);
        const float4 v = j < n ? load_row4(xbh + (t0 + j) * xs.t, p0 + p, xs.p, P, vec_x)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        xT[p * kLdL + j] = v.x;
        xT[(p + 1) * kLdL + j] = v.y;
        xT[(p + 2) * kLdL + j] = v.z;
        xT[(p + 3) * kLdL + j] = v.w;
      }
      __syncthreads();

      float yd[4][4], yo[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) yd[r][q] = yo[r][q] = 0.f;
      for (int j = 0; j < jn; j += 4) {
        float4 si[4], xp[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) si[r] = ld4(sS + (ti + 16 * r) * kLdL + j);
#pragma unroll
        for (int q = 0; q < 4; ++q) xp[q] = ld4(xT + (tp + 16 * q) * kLdL + j);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) yd[r][q] = dot4(si[r], xp[q], yd[r][q]);
      }
      if (c > 0) {
        if (vec_h) {
          cp_async_wait_all();
          __syncthreads();
        }
        for (int k = 0; k < kN; k += 4) {
          float4 ci[4], hp[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) ci[r] = ld4(cS + (ti + 16 * r) * ldk + k);
#pragma unroll
          for (int q = 0; q < 4; ++q) hp[q] = ld4(rS + (tp + 16 * q) * ldk + k);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) yo[r][q] = dot4(ci[r], hp[q], yo[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        if (i >= n) continue;
        const float e = eac[i];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = p0 + tp + 16 * q;
          if (p < P) yh[(t0 + i) * ys.t + p * ys.p] = fmaf(e, yo[r][q], yd[r][q]);
        }
      }
    }
  }
}

template <typename K>
int allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;  // above 48 KB only as opted-in dynamic shared memory
  return static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// Whether rows of K elements at stride s_col, whose starts lie at multiples
// of the outer strides from `base`, can be read four elements at a time.
bool rows_vec4(const void* base, size_t elem, int K, long long s_col, long long s1, long long s2,
               long long s3) {
  return s_col == 1 && K % 4 == 0 && reinterpret_cast<uintptr_t>(base) % (4 * elem) == 0 && s1 % 4 == 0 &&
         s2 % 4 == 0 && s3 % 4 == 0;
}

int chunks(int T) { return T > kL ? (T + kL - 1) / kL : 1; }

template <typename TB>
int launch(const float* xb, const float* a, const void* Bm, const void* Cm, float* y, float* h_out,
           float* scratch, int B, int H, int T, int P, int N, int G, Strides4 xs, StridesA as,
           StridesBC bs, StridesBC cs, Strides4 ys, cudaStream_t stream) {
  const int nc = chunks(T);
  // the scratch: every chunk's (P, N) state, then every chunk's sum of a; one
  // chunk needs neither, its own state being the final state
  float* s = nc == 1 ? h_out : scratch;
  float* totals = nc == 1 ? nullptr : scratch + static_cast<long long>(B) * H * nc * P * N;
  const int vec = (rows_vec4(xb, sizeof(float), P, xs.p, xs.b, xs.h, xs.t) ? kVecX : 0) |
                  (rows_vec4(Bm, sizeof(TB), N, bs.n, bs.b, bs.t, 0) &&
                           rows_vec4(Cm, sizeof(TB), N, cs.n, cs.b, cs.t, 0)
                       ? kVecBC
                       : 0) |
                  (N % 4 == 0 ? kVecH : 0);

  auto k1 = ssd_scan_state_kernel<TB>;
  const size_t smem1 = state_smem_bytes(P, N);
  int err = allow_smem(k1, smem1);
  if (err) return err;
  k1<<<dim3(nc, H, B), kThreads, smem1, stream>>>(xb, a, static_cast<const TB*>(Bm), s, totals, H, T, P,
                                                 N, nc, vec, xs, as, bs);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  if (nc > 1) {
    const long long BH = static_cast<long long>(B) * H, PN = static_cast<long long>(P) * N;
    if (PN % 4 == 0) {
      const long long blocks = (BH * (PN / 4) + kCarryThreads - 1) / kCarryThreads;
      ssd_scan_carry_kernel<float4><<<static_cast<unsigned>(blocks), kCarryThreads, 0, stream>>>(
          reinterpret_cast<float4*>(s), totals, reinterpret_cast<float4*>(h_out), BH, PN / 4, nc);
    } else {
      const long long blocks = (BH * PN + kCarryThreads - 1) / kCarryThreads;
      ssd_scan_carry_kernel<float><<<static_cast<unsigned>(blocks), kCarryThreads, 0, stream>>>(
          s, totals, h_out, BH, PN, nc);
    }
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }

  auto k3 = ssd_scan_output_kernel<TB>;
  const size_t smem3 = output_smem_bytes(N);
  err = allow_smem(k3, smem3);
  if (err) return err;
  k3<<<dim3(nc, (H + G - 1) / G, B), kThreads, smem3, stream>>>(
      xb, a, static_cast<const TB*>(Bm), static_cast<const TB*>(Cm), s, y, H, T, P, N, nc, G, vec, xs, as,
      bs, cs, ys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the larger of the per-chunk kernels needs, in bytes (the
// wrapper refuses more than the card's 227 KB).
extern "C" long long ssd_scan_smem_bytes(int P, int N) {
  const size_t s1 = state_smem_bytes(P, N), s3 = output_smem_bytes(N);
  return static_cast<long long>(s1 > s3 ? s1 : s3);
}

// Time chunks of a call of T tokens (the output kernel's grid x).
extern "C" int ssd_scan_chunks(int T) { return chunks(T); }

// Float32 scratch one call needs: B H nc (P N + 1) floats, nc = ceil(T / kL),
// or 0 for one chunk.
extern "C" long long ssd_scan_scratch_floats(int B, int H, int T, int P, int N) {
  const long long nc = chunks(T);
  return nc == 1 ? 0 : static_cast<long long>(B) * H * nc * (static_cast<long long>(P) * N + 1);
}

// Plain C entry point for ctypes.  xb (B, H, T, P) and y by four strides
// each, a (B, H, T), Bm and Cm (B, T, N) by three, in elements; h_out is a
// contiguous (B, H, P, N) f32 buffer; `scratch` a contiguous f32 buffer of
// ssd_scan_scratch_floats(B, H, T, P, N) floats, 16-byte aligned (may be
// null when that is 0).  G heads share one output block.  bf16 != 0 means
// Bm and Cm are bf16, else f32; xb, a and y are always f32.  The wrapper
// keeps B <= 65535, 1 <= H, T and nc <= 2^31 - 1, ceil(H / G) <= 65535,
// P, N >= 1 and the shared memory within the card's limit.  Launches two
// kernels (one chunk) or three on `stream`, does not synchronise, and
// returns the first CUDA error code (0 = launched).
extern "C" int ssd_scan_launch(const void* xb, const void* a, const void* Bm, const void* Cm,
                               void* y, void* h_out, void* scratch, int bf16, int B, int H, int T,
                               int P, int N, int G, long long xb_sb, long long xb_sh, long long xb_st,
                               long long xb_sp, long long a_sb, long long a_sh, long long a_st,
                               long long b_sb, long long b_st, long long b_sn, long long c_sb,
                               long long c_st, long long c_sn, long long y_sb, long long y_sh,
                               long long y_st, long long y_sp, void* stream) {
  const Strides4 xs{xb_sb, xb_sh, xb_st, xb_sp}, ys{y_sb, y_sh, y_st, y_sp};
  const StridesA as{a_sb, a_sh, a_st};
  const StridesBC bs{b_sb, b_st, b_sn}, cs{c_sb, c_st, c_sn};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(xb);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_out);
  float* sf = static_cast<float*>(scratch);
  if (bf16) return launch<__nv_bfloat16>(xf, af, Bm, Cm, yf, hf, sf, B, H, T, P, N, G, xs, as, bs, cs, ys, st);
  return launch<float>(xf, af, Bm, Cm, yf, hf, sf, B, H, T, P, N, G, xs, as, bs, cs, ys, st);
}
