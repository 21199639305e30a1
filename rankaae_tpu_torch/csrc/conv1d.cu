// Grouped 1-D convolutions with few channels per group, hand-written for
// Hopper (sm_90a): the forward (C1), the input gradient (C2) and the weight
// and bias gradient (C3) of the trial-stacked conv layers of the conv forms.
//
// They replace no TPU kernel: the JAX package leaves its convolutions to
// XLA.  They replace cuDNN on the training path, where the trial-stacked
// convolutions are T * groups groups of 1-8 channels over lengths of 1-256
// with 1-17 taps, and cuDNN's float32 heuristics pick FFT convolutions and
// generic weight-gradient engines that ran two orders of magnitude above
// the bytes these convolutions move (rankaae_tpu_torch/ops/conv1d_cuda.py
// has the measurements' origin).
//
// Layouts (all float32, contiguous):
//   x  (N, G*CIN, LX)      group g's channels at [g*CIN, (g+1)*CIN)
//   y  (N, G*COUT, LY)     LY = (LX + 2P - K) / S + 1
//   w  (G*COUT, CIN, K)    the flattened weight of a grouped conv1d
//   bias (G*COUT)
// Padding P is zero padding or replicate padding (x clamped to its ends).
//   C1  y[n, g*COUT+o, l] = bias + sum_c sum_k w[g*COUT+o, c, k] * xp[n, g*CIN+c, l*S + k]
//       with xp the padded x (xp[j] = x[j - P], clamped or zero).
//   C2  dx = the adjoint of C1 in x: the gradient dxp over the padded
//       domain [0, LX + 2P), then dx[p] = dxp[p + P], and with replicate
//       padding the pad's gradient folded onto the ends (dx[0] += sum of
//       dxp[0, P), dx[LX-1] += sum of dxp[LX+P, LX+2P)); an optional bias
//       (G*CIN) is added (C2 is the forward of a transposed convolution).
//   C3  dw[g*COUT+o, c, k] = sum_n sum_l dy[n, g*COUT+o, l] * xp[n, g*CIN+c, l*S+k]
//       and db = the sum of dy over (n, l) per channel, or (for a transposed
//       convolution, whose bias sits on the input side of C1) the sum of x.
// A transposed convolution with kernel == stride (the decoding blocks') is
// C2 forward, C1 input gradient and C3 weight gradient of the conv with the
// same weight: the wrapper swaps the roles, no kernel of its own.
//
// What bounds them.  At the main path's largest shape (4 -> 4 channels, 11
// taps, L 256, B 1024, T 32) C1 reads 134 MB and writes 134 MB and does
// 2.95 GFLOP: ~11 FLOP a byte, under the card's float32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20), so bytes bound it (0.080 ms).  C2 is the same; C3
// reads both tensors once and writes a few hundred floats a group.
//
// The design moves each byte once, and keeps the loads in flight:
//   * A block takes one group and walks over tiles of NB batch rows.  It
//     stages each tile's rows in shared memory once with cp.async (4-byte
//     copies, coalesced: a warp per row and channel, lanes along L), with
//     replicate padding as a clamped source index and zero padding as a
//     zero-filled copy, so no padded copy is ever made in device memory.
//     Two buffers: the next tile's copies are in flight while the block
//     computes on the current one, and a copy holds no register.  The
//     group's weights sit in shared memory beside them.
//   * A thread computes R = 8 consecutive outputs for every channel of its
//     side (4 where 8 would not fit in 128 registers): it loads the input
//     window once into registers and reuses each value for every tap and
//     channel (C1: a window of (R-1)S + K per input channel for R * COUT
//     sums; C2: (R-1)/S + ceil((K-1)/S) + 1 dy values per output channel for
//     R * CIN sums).  The weights are read from shared memory as float4s,
//     the same address across the warp (a broadcast).  Every per-group size
//     is a template argument, so the loops unroll into straight-line FMAs on
//     registers.
//   * Rows of shared memory are skewed by one word every 32 (sk() below):
//     lanes that read windows 8 * S words apart then hit distinct banks.
//   * C1 writes each output once from registers (16-byte stores where L
//     allows), the bias added last.  C2 writes its padded-domain sums to
//     shared memory, then a coalesced pass folds the pad and stores dx.
//   * C3 needs a sum over the whole batch.  A block takes a group and a
//     tile of rows, which it walks in double-buffered sub-tiles.  Threads
//     are split by input channel (whole warps per channel); each keeps
//     COUT * K sums in registers over its items, then a fixed-order
//     xor-shuffle tree and a fixed-order sum over its channel's warps give
//     one partial per block, written to its own slot (no atomics).  A
//     second kernel sums the slots over the tiles in tile order.  The
//     result is bit-identical from run to run, which cuDNN's
//     weight-gradient reductions are not.
//
// Interface: plain C functions, loaded with ctypes; the Python wrapper
// (ops/conv1d_cuda.py) checks shapes and allocates every buffer (C3's
// per-tile slots too).  Each function returns the cudaError_t of its
// launch (0 = success), or kUnsupported when no kernel is instantiated for
// the per-group shape (CIN, COUT, K, S); conv1d_shape lists the table,
// which the wrapper holds against its own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 8;                     // consecutive outputs a thread computes (at most)
constexpr int kStageBudget = 96 * 1024;   // bytes of staged rows a block holds (both buffers)
constexpr int kBlocksPerSm = 4;           // C1 and C2 blocks a launch asks for, per SM
constexpr int kUnsupported = -1;

// The per-group shapes (CIN, COUT, K, S) the model zoo builds, in conv terms
// (a transposed convolution (in, out, k) appears as (out, in, k, k)).  Keep
// in step with SHAPES in ops/conv1d_cuda.py.
#define CONV1D_SHAPES(X)                                                      \
  X(1, 1, 2, 2) X(1, 1, 4, 4) X(1, 1, 17, 1) X(1, 2, 4, 4) X(1, 2, 5, 1)      \
  X(1, 2, 8, 8) X(1, 4, 1, 1) X(1, 4, 2, 2) X(1, 4, 4, 4) X(1, 4, 11, 1)      \
  X(1, 4, 11, 2) X(2, 1, 1, 1) X(2, 1, 5, 1) X(2, 2, 5, 1) X(2, 2, 11, 1)     \
  X(3, 4, 1, 1) X(4, 1, 1, 1) X(4, 2, 11, 1) X(4, 3, 4, 4) X(4, 3, 8, 8)      \
  X(4, 4, 2, 2) X(4, 4, 4, 4) X(4, 4, 5, 1) X(4, 4, 5, 2) X(4, 4, 7, 1)       \
  X(4, 4, 7, 2) X(4, 4, 11, 1) X(4, 4, 11, 2) X(4, 8, 2, 2) X(8, 6, 2, 2)     \
  X(8, 8, 2, 2) X(8, 8, 4, 4)

__host__ __device__ __forceinline__ int sk(int j) { return j + (j >> 5); }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Taps rounded up to a multiple of 4: the weights of one (output, input)
// channel pair sit 16-byte aligned in shared memory, read as float4s.
__host__ __device__ constexpr int padded_taps(int k) { return (k + 3) & ~3; }

// Shared-memory words of a staged row of `len` values (skewed).
__host__ __device__ __forceinline__ int row_words(int len) { return sk(len - 1) + 1; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest complete (the current tile's rows are in)
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start copying rows [n0, n0 + nb) of a (N, G*C, L) tensor's group g into
// shared memory: row (r, c) at dst + (r*C + c)*stride, value j = src[j - off]
// (clamped to [0, L) when clamp, else 0 outside), for j in [0, span).
template <int C>
__device__ __forceinline__ void stage(float* dst, int stride, const float* __restrict__ src,
                                      int n0, int nb, int n, int g, int groups, int len,
                                      int span, int off, bool clamp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rc = warp; rc < nb * C; rc += kWarps) {
    const int row = n0 + rc / C;
    if (row >= n) continue;
    const float* s = src + (((size_t)row * groups + g) * C + rc % C) * len;
    float* d = dst + rc * stride;
    for (int j = lane; j < span; j += 32) {
      const int p = j - off;
      const bool in = p >= 0 && p < len;
      const int q = clamp ? imin(imax(p, 0), len - 1) : (in ? p : 0);
      cp_async4(d + sk(j), s + q, (clamp || in) ? 4 : 0);
    }
  }
}

// Group g's weights (COUT*CIN, K) into shared memory as (COUT*CIN, KP),
// zero past K.
template <int CIN, int COUT, int K>
__device__ __forceinline__ void stage_weights(float* sw, const float* __restrict__ w, int g) {
  constexpr int KP = padded_taps(K);
  for (int i = threadIdx.x; i < COUT * CIN * KP; i += kThreads) {
    const int pair = i / KP, k = i % KP;
    sw[i] = k < K ? __ldg(w + ((size_t)g * COUT * CIN + pair) * K + k) : 0.0f;
  }
}

// The K weights of one channel pair from shared memory, four at a time.
template <int K>
__device__ __forceinline__ void load_taps(float (&wk)[padded_taps(K)], const float* sw_pair) {
  const float4* q = reinterpret_cast<const float4*>(sw_pair);
#pragma unroll
  for (int t = 0; t < padded_taps(K) / 4; ++t) {
    const float4 v = q[t];
    wk[4 * t] = v.x;
    wk[4 * t + 1] = v.y;
    wk[4 * t + 2] = v.z;
    wk[4 * t + 3] = v.w;
  }
}

// The blocks a C1 or C2 launch asks for per group: about kBlocksPerSm a
// multiprocessor over all groups, at most one a tile.
int blocks_per_group(int tiles, int groups) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return imax(1, imin(tiles, cdiv(kBlocksPerSm * sms, groups)));
}

// Allow a kernel more than 48 KB of dynamic shared memory, once per size.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& granted) {
  if (bytes <= 48 * 1024 || bytes <= granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

// ----------------------------------------------------------------------------
// C1: forward
// ----------------------------------------------------------------------------

struct FwdShape {
  int nch, span, stride, nb;   // chunks a row, staged values a row, its words, rows a tile
};

// C1's outputs a thread: kR, or half where kR outputs of every channel and
// their window would not fit beside the rest in 128 registers
template <int COUT, int K, int S>
__host__ __device__ constexpr int fwd_r() {
  return COUT * kR + (kR - 1) * S + K > 88 ? kR / 2 : kR;
}

template <int CIN, int COUT, int K, int S>
__host__ __device__ FwdShape fwd_shape(int ly) {
  constexpr int R = fwd_r<COUT, K, S>();
  FwdShape f;
  f.nch = cdiv(ly, R);
  f.span = (f.nch * R - 1) * S + K;
  f.stride = row_words(f.span);
  f.nb = imax(1, imin(kThreads / f.nch, kStageBudget / (2 * CIN * f.stride * 4)));
  return f;
}

template <int CIN, int COUT, int K, int S>
__host__ __device__ size_t fwd_smem(const FwdShape& f) {
  return (size_t)(COUT * CIN * padded_taps(K) + COUT + 2 * f.nb * CIN * f.stride) * 4;
}

template <int CIN, int COUT, int K, int S>
__global__ void __launch_bounds__(kThreads, 2)
conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y, int n, int groups,
                int lx, int ly, int pad, int clamp) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KP = padded_taps(K), R = fwd_r<COUT, K, S>();
  const FwdShape f = fwd_shape<CIN, COUT, K, S>(ly);
  float* sw = smem;
  float* sb = sw + COUT * CIN * KP;
  float* buf0 = sb + COUT;
  float* buf1 = buf0 + f.nb * CIN * f.stride;
  const int g = blockIdx.y, tiles = cdiv(n, f.nb);
  stage_weights<CIN, COUT, K>(sw, w, g);
  if (threadIdx.x < COUT) sb[threadIdx.x] = bias ? __ldg(bias + g * COUT + threadIdx.x) : 0.0f;

  int tile = blockIdx.x;
  if (tile < tiles)
    stage<CIN>(buf0, f.stride, x, tile * f.nb, f.nb, n, g, groups, lx, f.span, pad, clamp);
  cp_async_commit();
  constexpr int W = (R - 1) * S + K;
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const float* cur = (it & 1) ? buf1 : buf0;
    const int next = tile + gridDim.x;
    if (next < tiles)
      stage<CIN>((it & 1) ? buf0 : buf1, f.stride, x, next * f.nb, f.nb, n, g, groups, lx,
                 f.span, pad, clamp);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const int n0 = tile * f.nb;
    for (int item = threadIdx.x; item < f.nb * f.nch; item += kThreads) {
      const int r = item / f.nch, q = item % f.nch, row = n0 + r;
      if (row >= n) continue;
      float acc[R][COUT];
#pragma unroll
      for (int o = 0; o < COUT; ++o)
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][o] = 0.0f;
      // one input channel at a time: its window and the weights it meets
      // are all the registers an iteration holds beside the sums
#pragma unroll 1
      for (int c = 0; c < CIN; ++c) {
        const float* src = cur + (r * CIN + c) * f.stride;
        const int j0 = q * R * S;
        float win[W];
#pragma unroll
        for (int i = 0; i < W; ++i) win[i] = src[sk(j0 + i)];
#pragma unroll
        for (int o = 0; o < COUT; ++o) {
          float wk[KP];
          load_taps<K>(wk, sw + (o * CIN + c) * KP);
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int i = 0; i < R; ++i) acc[i][o] = fmaf(wk[k], win[i * S + k], acc[i][o]);
        }
      }
      // the bias last, one rounding: added first, it would sit in every
      // partial sum, and where it is large beside the taps' sum (a conv
      // before a PReLU and a BatchNorm that takes the mean out again) each
      // of the K * CIN roundings would be of its size
      const int l0 = q * R;
#pragma unroll
      for (int o = 0; o < COUT; ++o) {
        const float b = sb[o];
        float* dst = y + (((size_t)row * groups + g) * COUT + o) * ly + l0;
        if (l0 + R <= ly && (ly & 3) == 0) {
#pragma unroll
          for (int i = 0; i < R; i += 4)
            *reinterpret_cast<float4*>(dst + i) = make_float4(
                acc[i][o] + b, acc[i + 1][o] + b, acc[i + 2][o] + b, acc[i + 3][o] + b);
        } else {
#pragma unroll
          for (int i = 0; i < R; ++i)
            if (l0 + i < ly) dst[i] = acc[i][o] + b;
        }
      }
    }
    __syncthreads();   // the buffer just read is the next prefetch's target
  }
}

// ----------------------------------------------------------------------------
// C2: input gradient
// ----------------------------------------------------------------------------

struct DgradShape {
  int lxp, nch, halo, ylen, ystride, xstride, nb;
};

// C2's padded positions a thread: kR, or half where kR of every input
// channel would hold more than 48 registers (and the stride allows it)
template <int CIN, int S>
__host__ __device__ constexpr int dgrad_r() {
  return CIN * kR > 48 && (kR / 2) % S == 0 ? kR / 2 : kR;
}

template <int CIN, int COUT, int K, int S>
__host__ __device__ DgradShape dgrad_shape(int lx, int pad) {
  constexpr int R = dgrad_r<CIN, S>();
  DgradShape d;
  d.lxp = lx + 2 * pad;                         // the padded domain
  d.nch = cdiv(d.lxp, R);
  d.halo = (K - 1 + S - 1) / S;                 // dy values left of a chunk's first
  d.ylen = (d.nch * R - 1) / S + d.halo + 1;   // staged dy values a row
  d.ystride = row_words(d.ylen);
  d.xstride = row_words(d.nch * R);
  const int per_row = (2 * COUT * d.ystride + CIN * d.xstride) * 4;
  d.nb = imax(1, imin(kThreads / d.nch, kStageBudget / per_row));
  return d;
}

template <int CIN, int COUT, int K, int S>
__host__ __device__ size_t dgrad_smem(const DgradShape& d) {
  return (size_t)(COUT * CIN * padded_taps(K) +
                  d.nb * (2 * COUT * d.ystride + CIN * d.xstride)) * 4;
}

template <int CIN, int COUT, int K, int S>
__global__ void __launch_bounds__(kThreads, 2)
conv_dgrad_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ dx, int n, int groups,
                  int lx, int ly, int pad, int clamp) {
  constexpr int R = dgrad_r<CIN, S>();
  static_assert(R % S == 0, "a chunk must start on a multiple of the stride");
  extern __shared__ __align__(16) float smem[];
  constexpr int KP = padded_taps(K);
  const DgradShape d = dgrad_shape<CIN, COUT, K, S>(lx, pad);
  float* sw = smem;
  float* buf0 = sw + COUT * CIN * KP;
  float* buf1 = buf0 + d.nb * COUT * d.ystride;
  float* sdx = buf1 + d.nb * COUT * d.ystride;
  const int g = blockIdx.y, tiles = cdiv(n, d.nb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_weights<CIN, COUT, K>(sw, w, g);

  // dy at staged index i is dy[i - halo], zero outside [0, ly)
  int tile = blockIdx.x;
  if (tile < tiles)
    stage<COUT>(buf0, d.ystride, dy, tile * d.nb, d.nb, n, g, groups, ly, d.ylen, d.halo, false);
  cp_async_commit();
  constexpr int H = (K - 1 + S - 1) / S;
  constexpr int WN = (R - 1) / S + H + 1;
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const float* cur = (it & 1) ? buf1 : buf0;
    const int next = tile + gridDim.x;
    if (next < tiles)
      stage<COUT>((it & 1) ? buf0 : buf1, d.ystride, dy, next * d.nb, d.nb, n, g, groups, ly,
                  d.ylen, d.halo, false);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();   // also: the last tile's store pass is done with sdx
    const int n0 = tile * d.nb;
    for (int item = threadIdx.x; item < d.nb * d.nch; item += kThreads) {
      const int r = item / d.nch, q = item % d.nch;
      if (n0 + r >= n) continue;
      float acc[R][CIN];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CIN; ++c) acc[i][c] = 0.0f;
      const int lb = q * R / S;                // the chunk's first position, over S
#pragma unroll
      for (int o = 0; o < COUT; ++o) {
        const float* src = cur + (r * COUT + o) * d.ystride;
        float win[WN];                          // win[t] = dy[lb + t - H]
#pragma unroll
        for (int t = 0; t < WN; ++t) win[t] = src[sk(lb + t)];
#pragma unroll
        for (int c = 0; c < CIN; ++c) {
          float wk[KP];
          load_taps<K>(wk, sw + (o * CIN + c) * KP);
#pragma unroll
          for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int i = 0; i < R; ++i) {
              // padded position j = q*R + i takes dy[l] through tap k where
              // l*S + k = j: l = lb + (i - k)/S, when i - k is a multiple of S
              if ((i - k) % S == 0) acc[i][c] = fmaf(wk[k], win[(i - k) / S + H], acc[i][c]);
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CIN; ++c) {
        float* out = sdx + (r * CIN + c) * d.xstride;
#pragma unroll
        for (int i = 0; i < R; ++i) out[sk(q * R + i)] = acc[i][c];
      }
    }
    __syncthreads();   // sdx complete, and the dy buffer free for the next prefetch

    if (clamp) {
      // the replicate pad's gradient onto the ends: a thread a (row,
      // channel, end), the pad's terms summed in order onto the end's own
      for (int e = threadIdx.x; e < 2 * d.nb * CIN; e += kThreads) {
        const bool right = e & 1;
        if (right && lx == 1) continue;         // one position: the left thread folds both
        float* row_dx = sdx + (e >> 1) * d.xstride;
        const int end = sk(right ? lx - 1 + pad : pad);
        float v = row_dx[end];
        if (!right)
          for (int j = 0; j < pad; ++j) v += row_dx[sk(j)];
        if (right || lx == 1)
          for (int j = lx + pad; j < d.lxp; ++j) v += row_dx[sk(j)];
        row_dx[end] = v;
      }
      __syncthreads();
    }
    // store dx, a warp per (row, channel), lanes along L
    for (int rc = warp; rc < d.nb * CIN; rc += kWarps) {
      const int row = n0 + rc / CIN, c = rc % CIN;
      if (row >= n) continue;
      const float* src = sdx + rc * d.xstride;
      float* dst = dx + (((size_t)row * groups + g) * CIN + c) * lx;
      const float b = bias ? __ldg(bias + g * CIN + c) : 0.0f;
      for (int p = lane; p < lx; p += 32) dst[p] = src[sk(p + pad)] + b;
    }
  }
}

// ----------------------------------------------------------------------------
// C3: weight and bias gradient, per-tile partials, then their fixed-order sum
// ----------------------------------------------------------------------------

enum BiasOf { kBiasNone = 0, kBiasDy = 1, kBiasX = 2 };

struct WgradShape {
  int nch, span, xstride, ylen, ystride, nb;
};

template <int CIN, int COUT, int K, int S>
__host__ __device__ WgradShape wgrad_shape(int ly) {
  WgradShape s;
  s.nch = cdiv(ly, kR);
  s.span = (s.nch * kR - 1) * S + K;
  s.xstride = row_words(s.span);
  s.ylen = s.nch * kR;
  s.ystride = row_words(s.ylen);
  const int per_row = 2 * (CIN * s.xstride + COUT * s.ystride) * 4;
  // about four items for each thread of a channel's warps
  s.nb = imax(1, imin(4 * (kWarps / CIN) * 32 / s.nch, kStageBudget / per_row));
  return s;
}

template <int CIN, int COUT, int K, int S>
__host__ __device__ size_t wgrad_smem(const WgradShape& s) {
  return (size_t)(kWarps * (COUT * K + COUT) + 2 * s.nb * (CIN * s.xstride + COUT * s.ystride)) * 4;
}

template <int CIN, int COUT, int K>
__host__ __device__ __forceinline__ int slot_words(int bias_of) {
  return COUT * CIN * K + (bias_of == kBiasDy ? COUT : bias_of == kBiasX ? CIN : 0);
}

template <int CIN, int COUT, int K, int S>
__global__ void __launch_bounds__(kThreads, 2)
conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ partial, int n, int groups, int lx, int ly, int pad,
                  int clamp, int bias_of, int rows_per_tile) {
  static_assert(CIN <= kWarps, "C3 gives each input channel at least one warp");
  extern __shared__ __align__(16) float smem[];
  const WgradShape s = wgrad_shape<CIN, COUT, K, S>(ly);
  constexpr int WPC = kWarps / CIN;             // warps an input channel
  constexpr int NV = COUT * K + COUT;           // a thread's sums: taps, then bias
  float* red = smem;                            // kWarps * NV
  float* x0 = red + kWarps * NV;
  float* x1 = x0 + s.nb * CIN * s.xstride;
  float* y0 = x1 + s.nb * CIN * s.xstride;
  float* y1 = y0 + s.nb * COUT * s.ystride;
  const int g = blockIdx.y, tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = warp / WPC, lt = (warp % WPC) * 32 + lane;
  const bool active = c < CIN;
  const int r0 = tile * rows_per_tile, r1 = imin(n, r0 + rows_per_tile);
  const int subs = r1 > r0 ? cdiv(r1 - r0, s.nb) : 0;

  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.0f;

  if (subs > 0) {
    const int nb = imin(s.nb, r1 - r0);
    stage<CIN>(x0, s.xstride, x, r0, nb, n, g, groups, lx, s.span, pad, clamp);
    stage<COUT>(y0, s.ystride, dy, r0, nb, n, g, groups, ly, s.ylen, 0, false);
  }
  cp_async_commit();
  constexpr int W = (kR - 1) * S + K;
  for (int sub = 0; sub < subs; ++sub) {
    const float* xs_buf = (sub & 1) ? x1 : x0;
    const float* ys_buf = (sub & 1) ? y1 : y0;
    const int n0 = r0 + sub * s.nb, nb = imin(s.nb, r1 - n0);
    if (sub + 1 < subs) {
      const int m0 = n0 + s.nb, mb = imin(s.nb, r1 - m0);
      stage<CIN>((sub & 1) ? x0 : x1, s.xstride, x, m0, mb, n, g, groups, lx, s.span, pad, clamp);
      stage<COUT>((sub & 1) ? y0 : y1, s.ystride, dy, m0, mb, n, g, groups, ly, s.ylen, 0, false);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (active) {
      for (int item = lt; item < nb * s.nch; item += WPC * 32) {
        const int r = item / s.nch, q = item % s.nch;
        const float* xs = xs_buf + (r * CIN + c) * s.xstride;
        float win[W];
#pragma unroll
        for (int i = 0; i < W; ++i) win[i] = xs[sk(q * kR * S + i)];
        if (bias_of == kBiasX) {
          // kernel == stride and no padding: the windows of the chunks
          // tile x, each value once (past LX they are zero)
          float t = 0.0f;
#pragma unroll
          for (int i = 0; i < W; ++i) t += win[i];
          acc[COUT * K] += t;
        }
#pragma unroll
        for (int o = 0; o < COUT; ++o) {
          const float* ds = ys_buf + (r * COUT + o) * s.ystride;
          float dv[kR];
#pragma unroll
          for (int i = 0; i < kR; ++i) dv[i] = ds[sk(q * kR + i)];
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int i = 0; i < kR; ++i)
              acc[o * K + k] = fmaf(dv[i], win[i * S + k], acc[o * K + k]);
          if (bias_of == kBiasDy && c == 0) {
            float t = 0.0f;
#pragma unroll
            for (int i = 0; i < kR; ++i) t += dv[i];
            acc[COUT * K + o] += t;
          }
        }
      }
    }
    __syncthreads();   // the buffers just read are the next prefetch's target
  }

  // a fixed-order tree over the warp, then the channel's warps in order
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float t = acc[v];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) t += __shfl_xor_sync(0xffffffffu, t, m);
    if (lane == 0) red[warp * NV + v] = t;
  }
  __syncthreads();
  const int words = slot_words<CIN, COUT, K>(bias_of);
  float* out = partial + ((size_t)tile * groups + g) * words;
  for (int idx = threadIdx.x; idx < words; idx += kThreads) {
    int cc, v;
    if (idx < COUT * CIN * K) {                 // (o, c, k) -> channel c's sum o*K + k
      const int o = idx / (CIN * K), rem = idx % (CIN * K);
      cc = rem / K;
      v = o * K + rem % K;
    } else if (bias_of == kBiasDy) {            // dy's channel o: channel 0's warps
      cc = 0;
      v = COUT * K + (idx - COUT * CIN * K);
    } else {                                    // x's channel c
      cc = idx - COUT * CIN * K;
      v = COUT * K;
    }
    float t = 0.0f;
    for (int i = 0; i < WPC; ++i) t += red[(cc * WPC + i) * NV + v];
    out[idx] = t;
  }
}

// dw (G*COUT*CIN*K) and db (G*nbias) from the per-tile slots, summed in tile order.
__global__ void __launch_bounds__(kThreads)
conv_wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                      float* __restrict__ db, int groups, int taps, int words, int tiles) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= groups * words) return;
  const int g = idx / words, v = idx % words;
  float t = 0.0f;
  for (int i = 0; i < tiles; ++i) t += partial[((size_t)i * groups + g) * words + v];
  if (v < taps) dw[(size_t)g * taps + v] = t;
  else db[(size_t)g * (words - taps) + (v - taps)] = t;
}

// ----------------------------------------------------------------------------
// launchers
// ----------------------------------------------------------------------------

template <int CIN, int COUT, int K, int S>
int launch_fwd(const float* x, const float* w, const float* bias, float* y, int n, int groups,
               int lx, int ly, int pad, int clamp, cudaStream_t stream) {
  static size_t granted = 0;
  const FwdShape f = fwd_shape<CIN, COUT, K, S>(ly);
  const size_t smem = fwd_smem<CIN, COUT, K, S>(f);
  cudaError_t err = allow_smem(conv_fwd_kernel<CIN, COUT, K, S>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks_per_group(cdiv(n, f.nb), groups), groups);
  conv_fwd_kernel<CIN, COUT, K, S><<<grid, kThreads, smem, stream>>>(x, w, bias, y, n, groups,
                                                                     lx, ly, pad, clamp);
  return (int)cudaGetLastError();
}

template <int CIN, int COUT, int K, int S>
int launch_dgrad(const float* dy, const float* w, const float* bias, float* dx, int n,
                 int groups, int lx, int ly, int pad, int clamp, cudaStream_t stream) {
  static size_t granted = 0;
  const DgradShape d = dgrad_shape<CIN, COUT, K, S>(lx, pad);
  const size_t smem = dgrad_smem<CIN, COUT, K, S>(d);
  cudaError_t err = allow_smem(conv_dgrad_kernel<CIN, COUT, K, S>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks_per_group(cdiv(n, d.nb), groups), groups);
  conv_dgrad_kernel<CIN, COUT, K, S><<<grid, kThreads, smem, stream>>>(dy, w, bias, dx, n,
                                                                       groups, lx, ly, pad, clamp);
  return (int)cudaGetLastError();
}

template <int CIN, int COUT, int K, int S>
int launch_wgrad(const float* x, const float* dy, float* partial, float* dw, float* db, int n,
                 int groups, int lx, int ly, int pad, int clamp, int bias_of, int tiles,
                 cudaStream_t stream) {
  static size_t granted = 0;
  const WgradShape s = wgrad_shape<CIN, COUT, K, S>(ly);
  const size_t smem = wgrad_smem<CIN, COUT, K, S>(s);
  cudaError_t err = allow_smem(conv_wgrad_kernel<CIN, COUT, K, S>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_tile = cdiv(n, tiles);
  conv_wgrad_kernel<CIN, COUT, K, S><<<dim3(tiles, groups), kThreads, smem, stream>>>(
      x, dy, partial, n, groups, lx, ly, pad, clamp, bias_of, rows_per_tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int words = slot_words<CIN, COUT, K>(bias_of);
  conv_wgrad_sum_kernel<<<cdiv(groups * words, kThreads), kThreads, 0, stream>>>(
      partial, dw, db, groups, COUT * CIN * K, words, tiles);
  return (int)cudaGetLastError();
}

constexpr int kShapes[][4] = {
#define CONV1D_ROW(a, b, c, d) {a, b, c, d},
    CONV1D_SHAPES(CONV1D_ROW)
#undef CONV1D_ROW
};

}  // namespace

extern "C" {

int conv1d_num_shapes() { return (int)(sizeof(kShapes) / sizeof(kShapes[0])); }

// (CIN, COUT, K, S) of table entry i into out[0..3]
void conv1d_shape(int i, int* out) {
  for (int j = 0; j < 4; ++j) out[j] = kShapes[i][j];
}

int conv1d_forward(int cin, int cout, int k, int s, const float* x, const float* w,
                   const float* bias, float* y, int n, int groups, int lx, int ly, int pad,
                   int clamp, void* stream) {
#define CONV1D_FWD(a, b, c, d)                                                        \
  if (cin == a && cout == b && k == c && s == d)                                      \
    return launch_fwd<a, b, c, d>(x, w, bias, y, n, groups, lx, ly, pad, clamp,      \
                                  (cudaStream_t)stream);
  CONV1D_SHAPES(CONV1D_FWD)
#undef CONV1D_FWD
  return kUnsupported;
}

int conv1d_input_grad(int cin, int cout, int k, int s, const float* dy, const float* w,
                      const float* bias, float* dx, int n, int groups, int lx, int ly, int pad,
                      int clamp, void* stream) {
#define CONV1D_DGRAD(a, b, c, d)                                                      \
  if (cin == a && cout == b && k == c && s == d)                                      \
    return launch_dgrad<a, b, c, d>(dy, w, bias, dx, n, groups, lx, ly, pad, clamp,  \
                                    (cudaStream_t)stream);
  CONV1D_SHAPES(CONV1D_DGRAD)
#undef CONV1D_DGRAD
  return kUnsupported;
}

int conv1d_weight_grad(int cin, int cout, int k, int s, const float* x, const float* dy,
                       float* partial, float* dw, float* db, int n, int groups, int lx, int ly,
                       int pad, int clamp, int bias_of, int tiles, void* stream) {
#define CONV1D_WGRAD(a, b, c, d)                                                      \
  if (cin == a && cout == b && k == c && s == d)                                      \
    return launch_wgrad<a, b, c, d>(x, dy, partial, dw, db, n, groups, lx, ly, pad,  \
                                    clamp, bias_of, tiles, (cudaStream_t)stream);
  CONV1D_SHAPES(CONV1D_WGRAD)
#undef CONV1D_WGRAD
  return kUnsupported;
}

const char* conv1d_error_string(int err) {
  if (err == kUnsupported) return "no kernel is instantiated for this per-group shape";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
