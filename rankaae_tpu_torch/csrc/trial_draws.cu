// The trial sampler's random draws on the card, hand-written for Hopper
// (sm_90a): one launch (D1) fills a whole (T, ...) draw, every trial's
// slice from that trial's own counter-based stream.
//
// It replaces no TPU kernel: the JAX package splits and folds jax.random
// keys.  It replaces T torch.Generator calls a draw site and their
// torch.stack (rankaae_tpu_torch/utils/sampler.py: one launch a trial, each
// waiting on the host), and the float32 tensor a keep-mask passed through.
//
// The stream.  Philox4x32-10 (Salmon et al., SC'11; the generator a CUDA
// torch.Generator runs): a 128-bit counter enciphered under a 64-bit key
// gives four 32-bit words.  Trial t's key is its seed (the run's seed s +
// t; rankaae_tpu_torch/ops/draws_cuda.py passes one per trial).  Element i
// of a draw of n elements a trial takes counter (offset + i / 4, kStream)
// -- its low 64 bits offset + i / 4, its high 64 bits the constant kStream
// -- and word i % 4 of its output.  Each call advances the offset by
// ceil(n / 4), the same for every trial, so trial t's stream depends only
// on its key and on the sequence of draw shapes: trial g of a T-trial run
// draws what a 1-trial run of seed s + g draws, whatever T is.  A CUDA
// torch.Generator of the same seed (which the trainer's initialisation
// draws from) runs thread j of a launch at counter (offset', j): its high
// word is 0 below 2^32 threads, never kStream, so the two never share a
// counter.
//
// The outputs, from the words w (uint32):
//   BITS     the word itself (int32; the permutation's sort keys);
//   UNIFORM  u = (w >> 8) * 2^-24, in [0, 1);
//   NORMAL   Box-Muller on the pair (w0, w1) -> elements 0, 1 and (w2, w3)
//            -> elements 2, 3 of a counter: u1 = ((w0 >> 8) + 1) * 2^-24 in
//            (0, 1] (never log 0), u2 = (w1 >> 8) * 2^-24, r = sqrt(-2 log
//            u1), theta = fl(2 pi) * u2: r cos theta, r sin theta.  logf and
//            sincosf are CUDA's accurate ones (no fast math: 1 and 2 ulp),
//            sqrtf is correctly rounded;
//   KEEP     a bool (one byte) keep-mask, (w >> 8) < threshold: the same
//            decision as u < keep in float32, with threshold = ceil(keep *
//            2^24) from the wrapper; no float tensor is made.
// The plain version (draws_cuda.py) computes the same numbers with int64
// torch ops: BITS, UNIFORM and KEEP bit-identical, NORMAL within the ulps
// of the two libraries' log, sin and cos.
//
// What bounds it.  A counter's four elements are one 16-byte store of
// floats or words, or one 4-byte store of mask bytes, where n is a multiple
// of 4 (every draw of the conv and FC forms); element by element otherwise.
// Enciphering it takes more: the keep-mask's loop body is 73 instructions a
// counter (21 IMAD.WIDE.U32 for the rounds' 32 x 32 -> 64-bit products, 21
// LOP3 for their three-way XORs; cuobjdump of sm_90a).  At the largest draw
// of the benchmark's cells, a T 256 (B 1024, 4, 256) keep-mask, that is 67M
// counters: 0.146 ms of the card's instruction issue (132 SMs x 128 a clock
// at 1.98 GHz) and 0.169 ms of its wide multiplies if they issue at 32 a
// clock an SM, against 0.080 ms for the 268 MB written at 3.35 TB/s.  So
// the cipher bounds D1, and each thread enciphers up to kPerThread counters
// of its trial, which spreads the thread's own set-up (its index, its key)
// over them.  On an H100 SXM at 700 W the cipher alone takes 0.379 ms there
// at one counter a thread and 0.195 ms at 16; D1's keep-mask 0.405 and
// 0.275 ms.
//
// Interface: plain C functions, loaded with ctypes; the wrapper allocates
// the output.  trial_draws returns the cudaError_t of its launch (0 =
// success) or kBadMode.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;   // the key schedule's Weyl constants
constexpr uint32_t kW1 = 0xBB67AE85u;
// the counter's high 64 bits: (0, kStream) in words 2 and 3
constexpr uint32_t kStream = 0x44310001u;
constexpr int kBadMode = -1;
constexpr int kThreads = 256;
// a thread's counters, at most; the grid keeps at least kFillBlocks blocks
// over all trials (a few waves of the card's 132 SMs)
constexpr int64_t kPerThread = 16;
constexpr int64_t kFillBlocks = 2048;

enum Mode { kBits = 0, kUniform = 1, kNormal = 2, kKeep = 3 };

__device__ __forceinline__ uint4 philox(uint64_t counter, uint64_t key) {
  uint32_t c0 = (uint32_t)counter, c1 = (uint32_t)(counter >> 32), c2 = 0u, c3 = kStream;
  uint32_t k0 = (uint32_t)key, k1 = (uint32_t)(key >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float unit(uint32_t w) { return (float)(w >> 8) * 0x1p-24f; }

__device__ __forceinline__ float2 box_muller(uint32_t a, uint32_t b) {
  const float u1 = (float)((a >> 8) + 1u) * 0x1p-24f;
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(6.2831855f * unit(b), &s, &c);
  return make_float2(r * c, r * s);
}

// one counter's four elements of trial t, from element 4c; n elements a
// trial, `vec` when n is a multiple of 4 (the whole group in one store)
template <int kMode>
__device__ __forceinline__ void put(void* out, int64_t at, int rem, bool vec, uint4 w,
                                    uint32_t threshold) {
  if (kMode == kNormal || kMode == kUniform) {
    float v[4];
    if (kMode == kNormal) {
      const float2 p = box_muller(w.x, w.y), q = box_muller(w.z, w.w);
      v[0] = p.x, v[1] = p.y, v[2] = q.x, v[3] = q.y;
    } else {
      v[0] = unit(w.x), v[1] = unit(w.y), v[2] = unit(w.z), v[3] = unit(w.w);
    }
    float* o = static_cast<float*>(out) + at;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int k = 0; k < rem; ++k) o[k] = v[k];
    }
  } else if (kMode == kKeep) {
    const uint32_t v[4] = {w.x, w.y, w.z, w.w};
    unsigned char m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = (v[k] >> 8) < threshold;
    unsigned char* o = static_cast<unsigned char*>(out) + at;
    if (vec) {
      *reinterpret_cast<uchar4*>(o) = make_uchar4(m[0], m[1], m[2], m[3]);
    } else {
      for (int k = 0; k < rem; ++k) o[k] = m[k];
    }
  } else {
    uint32_t* o = static_cast<uint32_t*>(out) + at;
    if (vec) {
      *reinterpret_cast<uint4*>(o) = w;
    } else {
      const uint32_t v[4] = {w.x, w.y, w.z, w.w};
      for (int k = 0; k < rem; ++k) o[k] = v[k];
    }
  }
}

// grid: x over the counters of a trial, y over the trials (each loop strides
// by its grid dimension)
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    trial_draws_kernel(const uint64_t* __restrict__ keys, uint64_t offset, int64_t n,
                       int trials, uint32_t threshold, void* __restrict__ out) {
  const int64_t q = (n + 3) / 4;
  const bool vec = (n & 3) == 0;
  for (int t = blockIdx.y; t < trials; t += gridDim.y) {
    const uint64_t key = keys[t];
    for (int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x; c < q;
         c += (int64_t)gridDim.x * kThreads) {
      const uint4 w = philox(offset + (uint64_t)c, key);
      const int64_t first = 4 * c;
      const int64_t left = n - first;
      put<kMode>(out, (int64_t)t * n + first, left < 4 ? (int)left : 4, vec, w, threshold);
    }
  }
}

template <int kMode>
int launch(const uint64_t* keys, uint64_t offset, int64_t n, int trials, uint32_t threshold,
           void* out, cudaStream_t stream) {
  const int64_t q = (n + 3) / 4;
  const int64_t full = (q + kThreads - 1) / kThreads;   // one counter a thread
  const int64_t fill = (kFillBlocks + trials - 1) / trials;
  int64_t bx = (full + kPerThread - 1) / kPerThread;
  if (bx < fill) bx = fill < full ? fill : full;
  const dim3 grid((unsigned)(bx < 65535 ? bx : 65535), (unsigned)(trials < 65535 ? trials : 65535));
  trial_draws_kernel<kMode><<<grid, kThreads, 0, stream>>>(keys, offset, n, trials, threshold,
                                                            out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the constant in the counter's fourth word, for the plain version to match
unsigned int trial_draws_stream() { return kStream; }

// Fill out (trials, n) with the draw `mode` (0 bits, 1 uniform, 2 normal, 3
// keep-mask with `threshold`) of counters offset .. offset + ceil(n/4) - 1
// under the per-trial keys (trials uint64, on the device).
int trial_draws(int mode, const void* keys, unsigned long long offset, long long n, int trials,
                unsigned int threshold, void* out, void* stream) {
  if (n <= 0 || trials <= 0) return 0;
  const uint64_t* k = static_cast<const uint64_t*>(keys);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kBits: return launch<kBits>(k, offset, n, trials, threshold, out, s);
    case kUniform: return launch<kUniform>(k, offset, n, trials, threshold, out, s);
    case kNormal: return launch<kNormal>(k, offset, n, trials, threshold, out, s);
    case kKeep: return launch<kKeep>(k, offset, n, trials, threshold, out, s);
    default: return kBadMode;
  }
}

const char* trial_draws_error_string(int err) {
  if (err == kBadMode) return "no such draw mode";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
