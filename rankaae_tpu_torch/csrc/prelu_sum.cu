// The channel PReLUs of the trial-stacked conv blocks and the sum of a
// block's branches, hand-written for Hopper (sm_90a): one forward launch
// (P1) and one backward launch plus a small fixed-order sum.
//
// It replaces no TPU kernel: the JAX package leaves its PReLUs and adds to
// XLA, which fuses them.  It replaces PyTorch's broadcast PReLU, its
// backward and the residual adds on the conv forms' training path.  There
// each block ends in  relu2(y_main) + relu_short(y_short) + relu_e(y_excit):
// three PReLU kernels (the slope broadcast over (B, L) sends them down
// PyTorch's non-vectorized path), two adds, and in the backward three PReLU
// backwards that each write the input gradient and a full-size slope
// gradient, which a third pass sums over (B, L).
//
// Layouts (all float32): every tensor (B, C, L) in one dense layout, walked
// as (outer, C, inner) -- channel c of outer row n at (n*C + c)*inner:
//   y_k, out, dout, dy_k  a contiguous tensor has outer B and inner L; a
//                         (C, B, L) one seen as (B, C, L) outer 1, inner B*L
//   w_k                   (C)            the slopes (T*C of a stacked module)
// Terms k = 0 .. kTerms-1; bit k of kAct says whether term k is a PReLU
// (act(y) = y > 0 ? y : w*y) or the identity (a stride-1 block's residual).
//   forward   out = (act_0(y_0) + act_1(y_1)) + act_2(y_2), added in that
//             order with __fadd_rn and multiplied with __fmul_rn (no FMA
//             contraction): bit for bit PyTorch's prelu and adds.
//   backward  for an activated term k:
//               dy_k = y_k > 0 ? dout : w_k*dout      (bit for bit PyTorch's)
//               dw_k[c] = sum over (n, l) of (y_k > 0 ? 0 : y_k*dout)
//             an identity term's gradient is dout itself: nothing written.
//
// What bounds it: bytes.  Forward: (terms + 1) * N * 4 bytes, one add and
// at most one multiply an element a term.  Backward: (1 + 2 * activated) *
// N * 4 bytes.  At a normal-form block's end at T 256 (B 1024, C 1024, L
// 256, three terms) that is 4.3 GB forward and 7.5 GB backward: 1.28 and
// 2.24 ms at 3.35 TB/s.  The design moves each byte once:
//   * The forward is one thread a 16-byte group of four elements (inner %
//     4 == 0 and every pointer 16-byte aligned; else one element): the
//     terms' loads, their slopes from L1, one store.  No branch output is
//     written, and no loop: a launch is N/4 threads.
//   * The backward's block takes a chunk of whole channels (as many as fill
//     256 threads x 4 elements: 4 at L 256) and a tile of outer rows.  A
//     thread owns 4 elements of one channel (several in turn where inner >
//     1024) and walks the tile's rows: it reads dout and each activated y once,
//     writes each dy once, and adds y*dout where y <= 0 into a double per
//     term.  The block then sums its threads per channel in a fixed order
//     (shared memory, then an xor-shuffle tree) and writes one partial a
//     channel and term into its tile's slot (no atomics).  A second launch
//     sums the slots over the tiles in tile order.  The tiles depend on the
//     shape alone, so the slope gradients are bit-identical run to run and
//     card to card, and no full-size slope gradient is ever made.
//
// Interface: plain C functions, loaded with ctypes; the Python wrapper
// (ops/prelu_cuda.py) checks shapes, decides the 16-byte path and the tiles
// and allocates every buffer.  Each returns the cudaError_t of its launch (0
// = success), or kUnsupported for a term pattern with no kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTerms = 3;
constexpr int kUnsupported = -1;
constexpr int kBadLayout = -2;

// the term patterns (terms, activated-bit mask) with kernels: a PReLU
// alone, and a block's end, three PReLUs or the identity residual between two
#define PRELU_PATTERNS(X) X(1, 1) X(3, 5) X(3, 7)

struct Terms {
  const float* y[kMaxTerms];
  const float* w[kMaxTerms];   // null for an identity term
  float* dy[kMaxTerms];        // the backward's outputs (activated terms)
  float* dw[kMaxTerms];        // the slope gradients (activated terms)
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float act(float y, float w) { return y > 0.0f ? y : __fmul_rn(w, y); }

__device__ __forceinline__ float4 act4(float4 v, float w) {
  return make_float4(act(v.x, w), act(v.y, w), act(v.z, w), act(v.w, w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// dy of one element, and its slope term added to s
__device__ __forceinline__ float grad(float y, float g, float w, double& s) {
  if (y > 0.0f) return g;
  s += (double)__fmul_rn(y, g);
  return __fmul_rn(w, g);
}

// One thread a group of V = 4 (kVec) or 1 elements; `items` groups in all,
// `per_row` of them a channel's inner run.
template <int kTerms, int kAct, bool kVec>
__global__ void __launch_bounds__(kThreads)
    prelu_sum_fwd_kernel(const Terms t, float* __restrict__ out, unsigned items,
                         unsigned per_row, unsigned channels) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const unsigned c = (i / per_row) % channels;
  if constexpr (kVec) {
    float4 acc;
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      float4 v = ld4(t.y[k] + 4 * (size_t)i);
      if ((kAct >> k) & 1) v = act4(v, __ldg(t.w[k] + c));
      if (k == 0) acc = v;
      else acc = add4(acc, v);
    }
    reinterpret_cast<float4*>(out)[i] = acc;
  } else {
    float acc;
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      float v = __ldg(t.y[k] + i);
      if ((kAct >> k) & 1) v = act(v, __ldg(t.w[k] + c));
      if (k == 0) acc = v;
      else acc = __fadd_rn(acc, v);
    }
    out[i] = acc;
  }
}

// grid (channel chunks, outer tiles).  A chunk is `chans` whole channels,
// whose `tpc` threads each hold V elements of a row (inner <= V * kThreads),
// or one channel walked by all the threads (inner > V * kThreads, chans 1).
// Block (x, y) writes partial[(y * kTerms + k) * channels + c] for its
// channels.
template <int kTerms, int kAct, bool kVec>
__global__ void __launch_bounds__(kThreads)
    prelu_sum_bwd_kernel(const Terms t, const float* __restrict__ dout,
                         double* __restrict__ partial, int outer, int channels,
                         int inner, int chans, int tpc, int rows) {
  constexpr int V = kVec ? 4 : 1;
  __shared__ double red[kTerms][kThreads];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * chans;
  const int nch = imin(chans, channels - c0);
  const int span = nch * inner;        // the chunk's elements in one row
  const int n0 = blockIdx.y * rows, n1 = imin(outer, n0 + rows);
  const bool mine = V * tid < span;
  const int c = c0 + (mine ? V * tid / inner : 0);
  float w[kTerms];
  double acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    w[k] = ((kAct >> k) & 1) && mine ? __ldg(t.w[k] + c) : 0.0f;
    acc[k] = 0.0;
  }
  for (int j = V * tid; j < span; j += V * kThreads) {
#pragma unroll 4
    for (int n = n0; n < n1; ++n) {
      const size_t off = ((size_t)n * channels + c0) * inner + j;
      if constexpr (kVec) {
        const float4 g = ld4(dout + off);
#pragma unroll
        for (int k = 0; k < kTerms; ++k) {
          if (!((kAct >> k) & 1)) continue;
          const float4 y = ld4(t.y[k] + off);
          double s = 0.0;
          float4 d;
          d.x = grad(y.x, g.x, w[k], s);
          d.y = grad(y.y, g.y, w[k], s);
          d.z = grad(y.z, g.z, w[k], s);
          d.w = grad(y.w, g.w, w[k], s);
          acc[k] += s;
          *reinterpret_cast<float4*>(t.dy[k] + off) = d;
        }
      } else {
        const float g = __ldg(dout + off);
#pragma unroll
        for (int k = 0; k < kTerms; ++k) {
          if (!((kAct >> k) & 1)) continue;
          t.dy[k][off] = grad(__ldg(t.y[k] + off), g, w[k], acc[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kTerms; ++k) red[k][tid] = acc[k];
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int ci = warp; ci < nch; ci += kWarps) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      if (!((kAct >> k) & 1)) continue;
      double s = 0.0;
      for (int m = lane; m < tpc; m += 32) s += red[k][ci * tpc + m];
#pragma unroll
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) partial[((size_t)blockIdx.y * kTerms + k) * channels + c0 + ci] = s;
    }
  }
}

// dw_k[c] = the tiles' partials of (k, c) summed in tile order, rounded once.
__global__ void __launch_bounds__(kThreads)
    prelu_slope_sum_kernel(const Terms t, const double* __restrict__ partial, int terms,
                           int act_mask, int channels, int tiles) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= terms * channels) return;
  const int k = idx / channels, c = idx % channels;
  if (!((act_mask >> k) & 1)) return;
  double s = 0.0;
  for (int i = 0; i < tiles; ++i) s += partial[((size_t)i * terms + k) * channels + c];
  t.dw[k][c] = (float)s;
}

// ----------------------------------------------------------------------------
// launchers
// ----------------------------------------------------------------------------

template <int kTerms, int kAct>
int launch_fwd(const Terms& t, float* out, int outer, int channels, int inner, bool vec,
               cudaStream_t stream) {
  const int v = vec ? 4 : 1;
  const unsigned items = (unsigned)((size_t)outer * channels * inner / v);
  const unsigned blocks = (items + kThreads - 1) / kThreads;
  if (vec)
    prelu_sum_fwd_kernel<kTerms, kAct, true><<<blocks, kThreads, 0, stream>>>(
        t, out, items, (unsigned)(inner / v), (unsigned)channels);
  else
    prelu_sum_fwd_kernel<kTerms, kAct, false><<<blocks, kThreads, 0, stream>>>(
        t, out, items, (unsigned)(inner / v), (unsigned)channels);
  return (int)cudaGetLastError();
}

template <int kTerms, int kAct>
int launch_bwd(const Terms& t, const float* dout, double* partial, int outer, int channels,
               int inner, bool vec, int tiles, cudaStream_t stream) {
  const int v = vec ? 4 : 1;
  const int wide = inner >= v * kThreads;
  const int chans = wide ? 1 : v * kThreads / inner;
  const int tpc = wide ? kThreads : inner / v;
  const int rows = cdiv(outer, tiles);
  const dim3 grid(cdiv(channels, chans), cdiv(outer, rows));
  if (vec)
    prelu_sum_bwd_kernel<kTerms, kAct, true><<<grid, kThreads, 0, stream>>>(
        t, dout, partial, outer, channels, inner, chans, tpc, rows);
  else
    prelu_sum_bwd_kernel<kTerms, kAct, false><<<grid, kThreads, 0, stream>>>(
        t, dout, partial, outer, channels, inner, chans, tpc, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  prelu_slope_sum_kernel<<<cdiv(kTerms * channels, kThreads), kThreads, 0, stream>>>(
      t, partial, kTerms, kAct, channels, (int)grid.y);
  return (int)cudaGetLastError();
}

Terms make_terms(const float* y0, const float* y1, const float* y2, const float* w0,
                 const float* w1, const float* w2) {
  Terms t = {};
  t.y[0] = y0; t.y[1] = y1; t.y[2] = y2;
  t.w[0] = w0; t.w[1] = w1; t.w[2] = w2;
  return t;
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// out = the sum of the `terms` terms y_k, activated where bit k of act_mask
// is set (w_k its slopes, else null); vec: the 16-byte path (L % 4 == 0, every
// pointer 16-byte aligned).  Every tensor (outer, channels, inner) in memory.
int prelu_sum_forward(int terms, int act_mask, const float* y0, const float* y1,
                      const float* y2, const float* w0, const float* w1, const float* w2,
                      float* out, int outer, int channels, int inner, int vec, void* stream) {
  if ((size_t)outer * channels * inner == 0) return 0;
  Terms t = make_terms(y0, y1, y2, w0, w1, w2);
  if (vec) {
    if (inner % 4 || !aligned(out)) return kBadLayout;
    for (int k = 0; k < terms && k < kMaxTerms; ++k)
      if (!aligned(t.y[k])) return kBadLayout;
  }
#define PRELU_FWD(a, b)                                                                    \
  if (terms == a && act_mask == b)                                                         \
    return launch_fwd<a, b>(t, out, outer, channels, inner, vec != 0, (cudaStream_t)stream);
  PRELU_PATTERNS(PRELU_FWD)
#undef PRELU_FWD
  return kUnsupported;
}

// dy_k (activated terms) and dw_k (channels) from dout and the y_k; partial
// holds tiles * terms * channels doubles (scratch).
int prelu_sum_backward(int terms, int act_mask, const float* dout, const float* y0,
                       const float* y1, const float* y2, const float* w0, const float* w1,
                       const float* w2, float* dy0, float* dy1, float* dy2, float* dw0,
                       float* dw1, float* dw2, double* partial, int outer, int channels,
                       int inner, int vec, int tiles, void* stream) {
  if ((size_t)outer * channels * inner == 0) return 0;
  Terms t = make_terms(y0, y1, y2, w0, w1, w2);
  t.dy[0] = dy0; t.dy[1] = dy1; t.dy[2] = dy2;
  t.dw[0] = dw0; t.dw[1] = dw1; t.dw[2] = dw2;
  if (tiles < 1) return kBadLayout;
  if (vec) {
    if (inner % 4 || !aligned(dout)) return kBadLayout;
    for (int k = 0; k < terms && k < kMaxTerms; ++k)
      if (((act_mask >> k) & 1) && (!aligned(t.y[k]) || !aligned(t.dy[k]))) return kBadLayout;
  }
#define PRELU_BWD(a, b)                                                                    \
  if (terms == a && act_mask == b)                                                         \
    return launch_bwd<a, b>(t, dout, partial, outer, channels, inner, vec != 0, tiles,     \
                            (cudaStream_t)stream);
  PRELU_PATTERNS(PRELU_BWD)
#undef PRELU_BWD
  return kUnsupported;
}

const char* prelu_sum_error_string(int err) {
  if (err == kUnsupported) return "no kernel is instantiated for this term pattern";
  if (err == kBadLayout) return "the 16-byte path needs inner % 4 == 0 and aligned pointers";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
