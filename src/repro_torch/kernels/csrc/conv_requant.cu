// int8 SAME convolution with the bias / requant / ReLU epilogue in registers,
// for Hopper (sm_90a): one launch per conv segment of the compiled CNN path.
//
// Replaces no Pallas kernel: the JAX package's tiled_conv
// (src/repro/kernels/tiled_conv.py::tiled_conv2d) is lax.conv per output
// band, and the interpreter's bias_add / requant / relu follow it as
// separate ops.  On the card that was F.conv2d (cuDNN) per band after a
// permuted NCHW view and a padded copy from F.pad, and then up to seven
// eager elementwise kernels for the epilogue.  This kernel computes the
// whole segment
//   out = clip(round_half_even((conv(x, w) + bias) / 2^S)), then ReLU,
// in one launch: it reads the segment's integer-valued float32 NHWC
// activations with any strides and the HWIO float32 weight as stored,
// converts both to int8 in registers (truncation toward zero, as
// Tensor.to(torch.int8) does), puts out-of-range taps of the XLA SAME
// padding to zero (the odd extra row or column at the bottom or right),
// accumulates in int32 and writes float32 NHWC.
//
// What bounds it on this card: the largest conv of MobileNetV1-0.25 has
// 0.59 M MACs and the net 208 KB of weights, so operations take well under
// a microsecond at the int8 rate and bytes about as little at 3.35 TB/s;
// every call is bound by the launch (about 1 µs, launch_floor.cu) and by
// each block's chain of dependent steps: its loads from memory, then a
// short run of products.  So the design is one launch, enough blocks and
// one trip to memory per block, not tensor-core throughput:
//  * a block computes a tile of output rows and columns of one stripe of
//    `block_oy` rows (the LOMA schedule's OY tile; a tile never crosses a
//    stripe) for up to 32 output channels; threads run along the output
//    channel, so with NHWC and HWIO the weight reads and the output stores
//    are coalesced, and each thread computes one output;
//  * the block stages what its tile reads in shared memory as int8, issuing
//    every load of the activations and of the weights before it converts
//    any (16-byte loads where the layout allows), so that staging costs one
//    memory latency;
//  * a dense conv (groups 1) is a product over the reduction index
//    r = (fy * FX + fx) * C + c: the weight read as stored is its (R, K)
//    matrix, the tile's activations are staged as the matching (pixels, R)
//    rows (im2col in shared memory), four consecutive r packed into one
//    32-bit word, and each thread runs __dp4a along its row; a small C (the
//    stem's 3, DS-CNN's 1) so packs taps and not zeros.  A reduction longer
//    than the shared memory holds is staged in chunks;
//  * a depthwise conv (groups C) stages the input patch of its tile, halo
//    and padding included, one int32 per element, and uses plain integer
//    MACs (one input channel per output channel);
//  * each launch allows programmatic dependent launch: the next conv
//    segment's grid is launched while this one runs and waits for it
//    before its first read of memory, which hides part of every launch in
//    a chain of conv segments (MobileNet's 27 run back to back).
// Integer sums are exact and wrap as int32 does, so the result is
// bit-identical whatever the tiling, the chunking or the banding.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // threads per block
constexpr int kMaxTk = 32;         // output channels per block at most
constexpr int kSmemWords = 12288;  // 48 KB of shared memory, in 32-bit words
constexpr int kMaxGridY = 65535;

// round-half-even(y / 2^S) in int32, as matmul_requant.cu's requant with
// mult 1 (shift 0 passes y through), then ReLU and the clip to int8
__device__ __forceinline__ int32_t requant(int32_t y, int shift, bool relu) {
  if (shift > 0) {
    const int32_t q = y >> shift;  // floor(y / 2^S)
    // the remainder in [0, 2^S), in unsigned arithmetic (no signed overflow)
    const uint32_t r = static_cast<uint32_t>(y) - static_cast<uint32_t>(q) * (1u << shift);
    const uint32_t half = 1u << (shift - 1);
    y = q + ((r > half) ? 1 : ((r == half) ? (q & 1) : 0));
  }
  if (relu) y = max(y, 0);
  return min(max(y, -128), 127);
}

// one float32 element as int8, truncated toward zero (cvt.rzi)
__device__ __forceinline__ int32_t int8_of(float v) {
  return static_cast<int32_t>(static_cast<int8_t>(__float2int_rz(v) & 0xff));
}
__device__ __forceinline__ uint32_t byte_of(float v) {
  return static_cast<uint32_t>(__float2int_rz(v)) & 0xffu;
}
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  return byte_of(a) | (byte_of(b) << 8) | (byte_of(c) << 16) | (byte_of(d) << 24);
}
// Programmatic dependent launch (sm_90): the next kernel on the stream may be
// launched once every block of this one has started, and runs up to its own
// wait, which returns when this grid has completed and its writes are
// visible.  So a conv segment's launch overlaps the one before it, and no
// block reads memory before its producer is done.
__device__ __forceinline__ void launch_dependents() { asm volatile("griddepcontrol.launch_dependents;" ::: "memory"); }
__device__ __forceinline__ void wait_for_producer() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

__device__ __forceinline__ void load4(const float* p, float* raw) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  raw[0] = v.x, raw[1] = v.y, raw[2] = v.z, raw[3] = v.w;
}

struct Geom {
  int batch, iy, ix, c, oy, ox, k, fy, fx, stride, pad_y, pad_x;
  long long sxb, sxy, sxx, sxc;  // x's element strides (B, Y, X, C)
};

// How a call is cut: a tile of `ty` x `tx` outputs of one stripe for `tk`
// channels per block; a dense conv stages `rq` quads of its reduction per
// pass, in rows of `pitch` words
struct Plan {
  int tk, ty, tx, rq, pitch, stripe, stripes, row_tiles, col_tiles, k_tiles;
  int ok;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// shared words of a tile of `ty` x `tx` outputs: the dense conv's rows of
// `rq` quads and its (rq, tk) weights, or the depthwise conv's patch and taps
inline int smem_words(const Geom& g, bool dw, int tk, int ty, int tx, int rq) {
  if (dw) return ((ty - 1) * g.stride + g.fy) * ((tx - 1) * g.stride + g.fx) * tk + g.fy * g.fx * tk;
  return ty * tx * (rq | 1) + rq * tk;
}

Plan plan_of(const Geom& g, bool dw, int block_oy) {
  Plan p{};
  const int ch = dw ? g.c : g.k;
  p.tk = 1;
  while (p.tk < ch && p.tk < kMaxTk) p.tk *= 2;
  const int lanes = kThreads / p.tk;
  p.stripe = (block_oy <= 0 || block_oy > g.oy) ? g.oy : block_oy;
  p.stripes = ceil_div(g.oy, p.stripe);
  // rows of a tile: the stripe in as few even tiles as the lanes allow
  p.ty = ceil_div(p.stripe, ceil_div(p.stripe, lanes));
  p.tx = std::min(g.ox, std::max(1, lanes / p.ty));
  const int rq_all = ceil_div(g.fy * g.fx * g.c, 4);
  for (;;) {
    p.rq = dw ? 0 : rq_all;
    while (p.rq > 1 && smem_words(g, dw, p.tk, p.ty, p.tx, p.rq) > kSmemWords) p.rq = ceil_div(p.rq, 2);
    if (smem_words(g, dw, p.tk, p.ty, p.tx, p.rq) <= kSmemWords) break;
    if (p.tx > 1) {
      p.tx = ceil_div(p.tx, 2);
    } else if (p.ty > 1) {
      p.ty = ceil_div(p.ty, 2);
    } else {
      return p;  // ok = 0: not even one output fits
    }
  }
  p.pitch = p.rq | 1;  // odd: the warps' lanes that read other pixels fall in other banks
  p.row_tiles = ceil_div(p.stripe, p.ty);
  p.col_tiles = ceil_div(g.ox, p.tx);
  p.k_tiles = ceil_div(ch, p.tk);
  p.ok = static_cast<long long>(p.stripes) * p.row_tiles <= kMaxGridY && g.batch <= kMaxGridY;
  return p;
}

// Stage two sets of shared words, A (`na` units of LA floats) and B (`nb`
// units of LB floats): a thread issues the loads of up to NA units of A and
// NB of B, all before it converts and stores any, so a round of staging
// costs one memory latency; most tiles take one round.  load(i, raw) reads
// unit i (zeros where there is nothing), store(i, raw) writes it.
template <int LA, int NA, int LB, int NB, typename LoadA, typename StoreA, typename LoadB, typename StoreB>
__device__ __forceinline__ void stage(int na, LoadA load_a, StoreA store_a, int nb, LoadB load_b,
                                      StoreB store_b) {
  const int rounds = max(ceil_div(na, NA * kThreads), ceil_div(nb, NB * kThreads));
  for (int rd = 0; rd < rounds; ++rd) {
    const int ia = rd * NA * kThreads + threadIdx.x, ib = rd * NB * kThreads + threadIdx.x;
    float ra[NA][LA], rb[NB][LB];
#pragma unroll
    for (int u = 0; u < NA; ++u) {
      if (ia + u * kThreads < na) load_a(ia + u * kThreads, ra[u]);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      if (ib + u * kThreads < nb) load_b(ib + u * kThreads, rb[u]);
    }
#pragma unroll
    for (int u = 0; u < NA; ++u) {
      if (ia + u * kThreads < na) store_a(ia + u * kThreads, ra[u]);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      if (ib + u * kThreads < nb) store_b(ib + u * kThreads, rb[u]);
    }
  }
}

// What a block and its thread compute: the tile, the thread's output, its bias
struct Tile {
  int b, oy0, ox0, rows, cols, k0, kl, lane, kk;
  bool active;
  float bias;
};

__device__ __forceinline__ bool tile_of(const Geom& g, const Plan& p, const float* bias, int ch, Tile& t) {
  launch_dependents();
  const int kt = blockIdx.x % p.k_tiles, ct = blockIdx.x / p.k_tiles;
  const int stripe = blockIdx.y / p.row_tiles, rt = blockIdx.y % p.row_tiles;
  const int s_end = min((stripe + 1) * p.stripe, g.oy);
  t.b = blockIdx.z;
  t.oy0 = stripe * p.stripe + rt * p.ty;
  if (t.oy0 >= s_end) return false;
  t.rows = min(p.ty, s_end - t.oy0);
  t.ox0 = ct * p.tx;
  t.cols = min(p.tx, g.ox - t.ox0);
  t.k0 = kt * p.tk;
  t.kl = threadIdx.x & (p.tk - 1);  // tk is a power of two
  t.lane = threadIdx.x / p.tk;
  t.kk = t.k0 + t.kl;
  t.active = t.lane < t.rows * t.cols && t.kk < ch;
  wait_for_producer();  // before any read of memory
  // read now, so that its latency hides under the staging
  t.bias = t.active && bias != nullptr ? __ldg(bias + t.kk) : 0.0f;
  return true;
}

__device__ __forceinline__ void epilogue(const Geom& g, const Tile& t, int ch, uint32_t acc, int shift, int relu,
                                         float* out) {
  // the bias as Tensor.to(torch.int32) converts it: truncation toward zero;
  // sums wrap modulo 2^32, as the int32 arithmetic of the plain version
  const int32_t y = static_cast<int32_t>(acc + static_cast<uint32_t>(__float2int_rz(t.bias)));
  const int r = t.lane / t.cols, cc = t.lane % t.cols;
  const long long o = ((static_cast<long long>(t.b) * g.oy + t.oy0 + r) * g.ox + t.ox0 + cc) * ch + t.kk;
  out[o] = static_cast<float>(requant(y, shift, relu != 0));
}

// groups 1: out[p, k] = sum_r x_im2col[p, r] * w[r, k], r = (fy * FX + fx) * C + c.
// kVecX: C % 4 == 0 and x's channels contiguous and 16-byte aligned, so a
// quad of r is one 16-byte load; kVecW: K % 4 == 0 and w 16-byte aligned, so
// a thread loads 4 x 4 weights (4 r by 4 k) and packs four words of them.
template <bool kVecX, bool kVecW>
__global__ void __launch_bounds__(kThreads) conv_requant_dense_kernel(const float* __restrict__ x,
                                                                      const float* __restrict__ w,
                                                                      const float* __restrict__ bias,
                                                                      float* __restrict__ out, Geom g, Plan p,
                                                                      int shift, int relu) {
  extern __shared__ uint32_t smem_u[];
  Tile t;
  if (!tile_of(g, p, bias, g.k, t)) return;  // the whole block: no barrier reached
  const int tk = p.tk, pix = t.rows * t.cols;
  const int r_all = g.fy * g.fx * g.c, rq_all = ceil_div(r_all, 4);
  const float* xb = x + t.b * g.sxb;
  uint32_t* xs = smem_u;  // [pixel][quad], rows of p.pitch words
  uint32_t acc = 0;
  for (int q0 = 0; q0 < rq_all; q0 += p.rq) {
    const int rq = min(p.rq, rq_all - q0);
    uint32_t* ws = xs + pix * p.pitch;  // [quad][channel]
    if (q0 > 0) __syncthreads();        // every thread is done with the last chunk
    // the input element of pixel `pp` at reduction index rr, or null where it lies outside
    auto at = [&](int pp, int rr) -> const float* {
      const int tap = rr / g.c, ci = rr - tap * g.c, dy = tap / g.fx, dx = tap - dy * g.fx;
      const int orow = pp / t.cols, ocol = pp - orow * t.cols;
      const int gy = (t.oy0 + orow) * g.stride - g.pad_y + dy, gx = (t.ox0 + ocol) * g.stride - g.pad_x + dx;
      const bool in = rr < r_all && gy >= 0 && gy < g.iy && gx >= 0 && gx < g.ix;
      return in ? xb + gy * g.sxy + gx * g.sxx + ci * g.sxc : nullptr;
    };
    auto load_x = [&](int i, float* raw) {
      const int pp = i / rq, rr = (q0 + i - pp * rq) * 4;
      if constexpr (kVecX) {  // four channels of one tap
        const float* src = at(pp, rr);
        if (src != nullptr) {
          load4(src, raw);
        } else {
          raw[0] = raw[1] = raw[2] = raw[3] = 0.0f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* src = at(pp, rr + j);
          raw[j] = src != nullptr ? __ldg(src) : 0.0f;
        }
      }
    };
    auto store_x = [&](int i, const float* raw) {
      const int pp = i / rq;
      xs[pp * p.pitch + i - pp * rq] = pack4(raw[0], raw[1], raw[2], raw[3]);
    };
    if constexpr (kVecW) {
      const int groups = tk / 4;  // four channels a unit
      stage<4, 4, 16, 2>(
          pix * rq, load_x, store_x, rq * groups,
          [&](int i, float* raw) {
            const int q = i / groups, ko = t.k0 + (i - q * groups) * 4;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int rr = (q0 + q) * 4 + j;
              if (rr < r_all && ko < g.k) {
                load4(w + static_cast<long long>(rr) * g.k + ko, raw + 4 * j);
              } else {
                raw[4 * j] = raw[4 * j + 1] = raw[4 * j + 2] = raw[4 * j + 3] = 0.0f;
              }
            }
          },
          [&](int i, const float* raw) {
            const int q = i / groups, kq = (i - q * groups) * 4;
#pragma unroll
            for (int m = 0; m < 4; ++m) ws[q * tk + kq + m] = pack4(raw[m], raw[4 + m], raw[8 + m], raw[12 + m]);
          });
    } else {
      stage<4, 4, 4, 8>(
          pix * rq, load_x, store_x, rq * tk,
          [&](int i, float* raw) {  // i = q * tk + channel
            const int q = i / tk, ko = t.k0 + (i - q * tk);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int rr = (q0 + q) * 4 + j;
              raw[j] = rr < r_all && ko < g.k ? __ldg(w + static_cast<long long>(rr) * g.k + ko) : 0.0f;
            }
          },
          [&](int i, const float* raw) { ws[i] = pack4(raw[0], raw[1], raw[2], raw[3]); });
    }
    __syncthreads();
    if (t.active) {
      // four partial sums, so that the products do not wait on each other
      const uint32_t* xq = xs + t.lane * p.pitch;
      const uint32_t* wq = ws + t.kl;
      int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
      int q = 0;
      for (; q + 4 <= rq; q += 4) {
        a0 = __dp4a(static_cast<int>(xq[q]), static_cast<int>(wq[q * tk]), a0);
        a1 = __dp4a(static_cast<int>(xq[q + 1]), static_cast<int>(wq[(q + 1) * tk]), a1);
        a2 = __dp4a(static_cast<int>(xq[q + 2]), static_cast<int>(wq[(q + 2) * tk]), a2);
        a3 = __dp4a(static_cast<int>(xq[q + 3]), static_cast<int>(wq[(q + 3) * tk]), a3);
      }
      for (; q < rq; ++q) a0 = __dp4a(static_cast<int>(xq[q]), static_cast<int>(wq[q * tk]), a0);
      acc += static_cast<uint32_t>(a0) + static_cast<uint32_t>(a1) + static_cast<uint32_t>(a2) +
             static_cast<uint32_t>(a3);
    }
  }
  if (t.active) epilogue(g, t, g.k, acc, shift, relu, out);
}

// groups C: out[p, c] = sum over the taps of x[patch, c] * w[tap, c].  kVec:
// C % 4 == 0 and x's channels contiguous, x and w 16-byte aligned, so four
// channels are one 16-byte load.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) conv_requant_depthwise_kernel(const float* __restrict__ x,
                                                                          const float* __restrict__ w,
                                                                          const float* __restrict__ bias,
                                                                          float* __restrict__ out, Geom g, Plan p,
                                                                          int shift, int relu) {
  extern __shared__ int32_t smem_i[];
  Tile t;
  if (!tile_of(g, p, bias, g.c, t)) return;  // the whole block: no barrier reached
  const int tk = p.tk, taps = g.fy * g.fx;
  const int ph = (t.rows - 1) * g.stride + g.fy, pw = (t.cols - 1) * g.stride + g.fx;
  const int iy0 = t.oy0 * g.stride - g.pad_y, ix0 = t.ox0 * g.stride - g.pad_x;
  const float* xb = x + t.b * g.sxb;
  int32_t* xs = smem_i;                 // [pixel of the patch][channel]
  int32_t* ws = smem_i + ph * pw * tk;  // [tap][channel]
  constexpr int kV = kVec ? 4 : 1;      // channels a unit
  const int groups = tk / kV;
  stage<kV, kVec ? 4 : 8, kV, kVec ? 1 : 4>(
      ph * pw * groups,
      [&](int i, float* raw) {
        const int pix = i / groups, ci = t.k0 + (i - pix * groups) * kV;
        const int gy = iy0 + pix / pw, gx = ix0 + pix % pw;
        const bool in = ci < g.c && gy >= 0 && gy < g.iy && gx >= 0 && gx < g.ix;
        const float* src = xb + gy * g.sxy + gx * g.sxx + ci * g.sxc;
        if constexpr (kVec) {
          if (in) {
            load4(src, raw);
          } else {
            raw[0] = raw[1] = raw[2] = raw[3] = 0.0f;
          }
        } else {
          raw[0] = in ? __ldg(src) : 0.0f;
        }
      },
      [&](int i, const float* raw) {
#pragma unroll
        for (int m = 0; m < kV; ++m) xs[i * kV + m] = int8_of(raw[m]);
      },
      taps * groups,
      [&](int i, float* raw) {  // HWIO (FY, FX, 1, C)
        const int tap = i / groups, ci = t.k0 + (i - tap * groups) * kV;
        if constexpr (kVec) {
          if (ci < g.c) {
            load4(w + tap * g.c + ci, raw);
          } else {
            raw[0] = raw[1] = raw[2] = raw[3] = 0.0f;
          }
        } else {
          raw[0] = ci < g.c ? __ldg(w + tap * g.c + ci) : 0.0f;
        }
      },
      [&](int i, const float* raw) {
#pragma unroll
        for (int m = 0; m < kV; ++m) ws[i * kV + m] = int8_of(raw[m]);
      });
  __syncthreads();
  if (!t.active) return;
  const int r = t.lane / t.cols, cc = t.lane % t.cols;
  uint32_t acc = 0;
  for (int dy = 0; dy < g.fy; ++dy) {
    const int32_t* xrow = xs + ((r * g.stride + dy) * pw + cc * g.stride) * tk + t.kl;
    const int32_t* wrow = ws + dy * g.fx * tk + t.kl;
#pragma unroll 4
    for (int dx = 0; dx < g.fx; ++dx) acc += static_cast<uint32_t>(xrow[dx * tk] * wrow[dx * tk]);
  }
  epilogue(g, t, g.c, acc, shift, relu, out);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

using Kernel = void (*)(const float*, const float*, const float*, float*, Geom, Plan, int, int);

// One launch that allows programmatic dependent launch after the kernel
// before it on the stream (and, captured in a CUDA graph, a programmatic edge)
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s, const float* x, const float* w,
                   const float* bias, float* out, const Geom& g, const Plan& p, int shift, int relu) {
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, w, bias, out, g, p, shift, relu);
}

}  // namespace

// The launch shape of a call: blocks in all and threads per block (0 blocks
// where no tile fits the shared memory).
extern "C" void conv_requant_launch_shape(int batch, int iy, int ix, int c, int k, int fy, int fx,
                                          int stride, int depthwise, int block_oy, int* blocks,
                                          int* threads) {
  Geom g{batch, iy, ix, c, ceil_div(iy, stride), ceil_div(ix, stride), k, fy, fx, stride, 0, 0, 0, 0, 0, 0};
  const Plan p = plan_of(g, depthwise != 0, block_oy);
  *blocks = p.ok ? p.col_tiles * p.k_tiles * p.stripes * p.row_tiles * batch : 0;
  *threads = kThreads;
}

// One launch on `stream`: x (B, IY, IX, C) float32 with element strides
// sxb..sxc, w (FY, FX, C, K) float32 contiguous (depthwise: (FY, FX, 1, C)),
// bias (K,) float32 or null, out (B, OY, OX, K) float32 contiguous.  Returns
// a CUDA error code, or -1 where no tile fits the shared memory.
extern "C" int conv_requant_launch(const float* x, const float* w, const float* bias, float* out, int batch,
                                   int iy, int ix, int c, int k, int fy, int fx, int stride, int pad_y,
                                   int pad_x, long long sxb, long long sxy, long long sxx, long long sxc,
                                   int depthwise, int block_oy, int shift, int relu, void* stream) {
  const Geom g{batch, iy, ix, c, ceil_div(iy, stride), ceil_div(ix, stride), k, fy, fx, stride, pad_y,
               pad_x, sxb, sxy, sxx, sxc};
  const bool dw = depthwise != 0;
  const Plan p = plan_of(g, dw, block_oy);
  if (!p.ok) return -1;
  const dim3 grid(p.col_tiles * p.k_tiles, p.stripes * p.row_tiles, batch);
  const size_t smem = sizeof(int32_t) * smem_words(g, dw, p.tk, p.ty, p.tx, p.rq);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec_x = c % 4 == 0 && sxc == 1 && sxx % 4 == 0 && sxy % 4 == 0 && sxb % 4 == 0 && aligned16(x);
  Kernel kernel;
  if (dw) {
    kernel = vec_x && aligned16(w) ? conv_requant_depthwise_kernel<true> : conv_requant_depthwise_kernel<false>;
  } else {
    const bool vec_w = k % 4 == 0 && aligned16(w);
    kernel = vec_x ? (vec_w ? conv_requant_dense_kernel<true, true> : conv_requant_dense_kernel<true, false>)
                   : (vec_w ? conv_requant_dense_kernel<false, true> : conv_requant_dense_kernel<false, false>);
  }
  const cudaError_t err = launch(kernel, grid, smem, s, x, w, bias, out, g, p, shift, relu);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
