// The eval-mode stride-1 EncodingBlock with c_in == c_out (K3), hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/fused_block_probe.py::fused_block_kernel
// (via fused_block, :50-121, :132-154).  Per sample x (C, L), L = 256:
//   xb  = (x - bn1_mean) * rsqrt(bn1_var + 1e-5)                 (residual)
//   h   = prelu_a1(conv1(xb, replicate pad 5) + b1)
//   hb  = (h - bn2_mean) * rsqrt(bn2_var + 1e-5)
//   h2  = prelu_a2(conv2(hb, zero pad 5) + b2)
//   ex  = prelu_ae2(fc2 . prelu_ae1(fc1 . xb + fc1_b) + fc2_b)  (over L, per channel)
//   out = h2 + xb + ex
// with 11-tap convs of weights (C, C, 11), fc1 (E, L) and fc2 (L, E), E = 2:
// the layouts of the port's nn.Conv1d / nn.Linear, so the wrapper passes the
// module parameters as they are.  Instantiated for C = 4 (the TPU kernel's,
// the decoders' 4-channel blocks) and C = 2 (the normal decoder's eblock3/4).
//
// What bounds it on the H100.  Per sample the two convs take 2 * C^2 * K * L
// FMAs (90,112 at C = 4, 2,816 a lane) and the rest ~(15 + 4E) C L
// operations; the bytes are one read of x and one write of out,
// 2 * C * L * 4.  At C = 4 that is operation-bound (B 1024: 3.1 us at the
// card's 67 TFLOP/s fp32 rate outside the tensor cores, against 2.5 us of
// bytes at 3.35 TB/s); at C = 2 (a quarter of the operations, half the
// bytes) byte-bound (1.25 us).  So the FMA pipes have to set the pace: each
// SM issues four warp-wide FMAs a clock, but serves only about one warp-wide
// 32-bit shared-memory load (or shuffle) a clock.  The first version (one
// sample per 256-thread block, thread = position) loaded a tap from shared
// memory for every FMA and re-added the excitation's cross-warp partials in
// every thread, ~510 shared loads against 352 FMAs a thread a sample: 15.6
// us at C 4, B 1024 (NVIDIA H100 80GB HBM3, 700.00 W).
//
// Design.
// * One warp per sample, lane l owns the kP = 8 positions 8l..8l+7 of every
//   channel: 32 lanes x 8 = L.  A lane keeps its C x 8 accumulators in
//   registers and, per input channel, a window of 8 + 10 inputs: its own 8
//   and 5 on each side taken from the neighbouring lanes by shuffles (10
//   shuffles a channel).  conv1's replicate pad and conv2's zero pad are
//   what the first and last lane put in the halo, so both convs run one
//   loop.  Per (input channel, tap) one 16-byte (C 4) or 8-byte (C 2)
//   broadcast load gives the taps of all C outputs (staged [c][t][o]) for
//   8 C FMAs: at C 4, 2,816 FMAs a lane a sample against ~270 shared loads
//   and shuffles.
// * A lane's own bn1(x) and bn2(h) values sit in a per-warp stash in shared
//   memory, [channel][half][lane] float4s (conflict-free; only the lane that
//   wrote a value reads it), so the loop over input channels is a rolled
//   loop and the code stays small; bn1(x) is also the residual.
// * The excitation's C x E dot products over L: each lane's partial over its
//   8 positions, then a xor butterfly (5 shuffles each, a fixed order that
//   leaves every lane with the same sum).  fc1 and fc2 per lane, and fc2's
//   bias, are staged once per block as [slot][lane] float4s.
// * No barrier inside the sample loop (a warp needs none: its lanes share
//   data only by shuffles); one __syncthreads after the block stages the
//   taps and constants, with every load of a thread in flight before its
//   stores.  No atomics, so the result is bit-identical from call to call.
// * A persistent grid: as many 128-thread blocks as the card keeps resident
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, found
//   once per device), fewer when B needs fewer; warp w of block k takes
//   samples w * gridDim + k, then every (gridDim * 4)-th, so a small B
//   spreads over all SMs and a ragged B is a loop bound.  x is read and out
//   written once, 16 bytes a lane an access: a warp's two accesses to a
//   channel cover its 1 KB row.
// * fp32 on the FMA pipes; no tensor cores (N = C = 4 would fill half the
//   smallest mma tile, and TF32 keeps ~3 digits).
//
// Measured (chip_smoke.py phase 5; NVIDIA H100 80GB HBM3, 700.00 W): device
// time 10.2 us at C 4, B 1024 (3.3x its bound), 25.1 us at C 4, B 4096
// (2.0x), 5.3 us at C 2, B 1024 (4.2x), 10.7 us at C 2, B 4096 (2.1x); 95
// and 68 registers (C 4, C 2), no spills.  With the convs taken out
// (tools/k3_ablate.py) C 4, B 4096 takes 12.8 us: the convs add the 11 us
// their FMAs need at the pipes' rate, and what bounds the kernel now is the
// rest of its work per sample (the excitation, the elementwise steps, the
// stash: the C 4 kernel's SASS holds 2,576 instructions, 832 of them FFMA,
// tools/time_fused_block.py --sass), plus ~3.6 us a call of launch,
// staging and first reads (the no-conv copy's intercept over B 1024, 4096).
//
// Interface: plain C functions, loaded with ctypes by
// rankaae_tpu_torch/ops/fused_block_cuda.py, which checks and allocates
// everything.  Each returns the cudaError_t of its launch (0 = success).

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kL = 256;
constexpr int kK = 11;                     // taps
constexpr int kPad = (kK - 1) / 2;
constexpr int kE = 2;                      // excitation width
constexpr int kP = 8;                      // positions a lane owns
constexpr int kQuads = kP / 4;             // float4s a lane holds per channel
constexpr int kWin = kP + 2 * kPad;        // inputs a lane's kP outputs read
constexpr int kWarps = 4;                  // samples a block has in flight
constexpr int kThreads = 32 * kWarps;
// per lane: fc1 (E x kQuads float4s), fc2 (E x kQuads), fc2's bias (kQuads)
constexpr int kFc2 = kE * kQuads, kFc2Bias = 2 * kE * kQuads, kSlots = kFc2Bias + kQuads;
constexpr float kEps = 1e-5f;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxDevices = 64;
static_assert(32 * kP == kL, "one warp covers the length of one sample");

struct Params {
  const float* bn1_mean; const float* bn1_var;
  const float* w1; const float* b1; const float* a1;
  const float* bn2_mean; const float* bn2_var;
  const float* w2; const float* b2; const float* a2;
  const float* fc1_w; const float* fc1_b; const float* ae1;
  const float* fc2_w; const float* fc2_b; const float* ae2;
};

// per channel: bn1 mean, bn1 scale, b1, a1, bn2 mean, bn2 scale, b2, a2, ae1, ae2
enum { kBn1Mean, kBn1Scale, kB1, kA1, kBn2Mean, kBn2Scale, kB2, kA2, kAe1, kAe2, kConsts };

__device__ __forceinline__ float prelu(float v, float a) { return v >= 0.f ? v : a * v; }

__device__ __forceinline__ void unpack(float4 v, float* a) {
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}

// The taps of all C outputs for one (input channel, tap): one vector load.
template <int C>
__device__ __forceinline__ void load_taps(const float* w, float (&t)[C]) {
  static_assert(C == 4 || C == 2, "C is 4 or 2");
  if constexpr (C == 4) {
    unpack(*reinterpret_cast<const float4*>(w), t);
  } else {
    const float2 v = *reinterpret_cast<const float2*>(w);
    t[0] = v.x; t[1] = v.y;
  }
}

// acc[o][p] = bias[o] + sum over (c, t) of w[c][t][o] * in[c][8 lane + p + t - 5],
// the input read from a lane's own stash entries and its neighbours' by
// shuffles; outside [0, L) it is the edge value (replicate) or 0.
template <int C, bool kReplicate>
__device__ __forceinline__ void conv(const float4 (*in)[kQuads][32], const float* w,
                                     const float* bias, int lane, float (&acc)[C][kP]) {
#pragma unroll
  for (int o = 0; o < C; ++o)
#pragma unroll
    for (int p = 0; p < kP; ++p) acc[o][p] = bias[o];
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    float v[kWin];                         // v[kPad + k]: this lane's position 8 lane + k
#pragma unroll
    for (int q = 0; q < kQuads; ++q) unpack(in[c][q][lane], &v[kPad + 4 * q]);
#pragma unroll
    for (int i = 0; i < kPad; ++i) {
      const float left = __shfl_up_sync(kAll, v[kP + i], 1);
      const float right = __shfl_down_sync(kAll, v[kPad + i], 1);
      v[i] = lane > 0 ? left : (kReplicate ? v[kPad] : 0.f);
      v[kPad + kP + i] = lane < 31 ? right : (kReplicate ? v[kPad + kP - 1] : 0.f);
    }
    const float* wc = w + c * kK * C;
#pragma unroll
    for (int t = 0; t < kK; ++t) {
      float wt[C];
      load_taps<C>(wc + t * C, wt);
#pragma unroll
      for (int o = 0; o < C; ++o)
#pragma unroll
        for (int p = 0; p < kP; ++p) acc[o][p] = fmaf(wt[o], v[p + t], acc[o][p]);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 4)
fused_block_kernel(const float* __restrict__ x, Params prm, int B, float* __restrict__ out) {
  __shared__ __align__(16) float w1[C * kK * C], w2[C * kK * C];   // [c][t][o]
  __shared__ float ch[kConsts][C];
  __shared__ float fc1_b[kE];
  __shared__ float4 fc[kSlots][32];
  // per warp: a lane's bn1(x) ([0]) and bn2(h) ([1]) values
  __shared__ float4 stash[kWarps][2][C][kQuads][32];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // Stage the taps and constants, every load of a thread in flight before
  // its stores (one round trip to L2 for the block)
  constexpr int kTaps = C * kK * C, kTapRounds = (kTaps + kThreads - 1) / kThreads;
  constexpr int kFcRounds = kSlots * 32 * 4 / kThreads;
  static_assert(kSlots * 32 * 4 % kThreads == 0, "the fc table fills in whole rounds");
  float tap1[kTapRounds], tap2[kTapRounds], fcv[kFcRounds];
#pragma unroll
  for (int r = 0; r < kTapRounds; ++r) {
    const int i = tid + r * kThreads, o = i % C, t = i / C % kK, c = i / (C * kK);
    if (i < kTaps) {
      tap1[r] = prm.w1[(o * C + c) * kK + t];
      tap2[r] = prm.w2[(o * C + c) * kK + t];
    }
  }
#pragma unroll
  for (int r = 0; r < kFcRounds; ++r) {
    const int i = tid + r * kThreads, s = i / 128, l = i / 4 % 32;
    const int pos = kP * l + 4 * (s % kQuads) + i % 4;
    fcv[r] = s < kFc2 ? prm.fc1_w[s / kQuads * kL + pos]
           : s < kFc2Bias ? prm.fc2_w[pos * kE + (s - kFc2) / kQuads]
           : prm.fc2_b[pos];
  }
  if (tid < C) {
    ch[kBn1Mean][tid] = prm.bn1_mean[tid];
    ch[kBn1Scale][tid] = rsqrtf(prm.bn1_var[tid] + kEps);
    ch[kB1][tid] = prm.b1[tid];
    ch[kA1][tid] = prm.a1[tid];
    ch[kBn2Mean][tid] = prm.bn2_mean[tid];
    ch[kBn2Scale][tid] = rsqrtf(prm.bn2_var[tid] + kEps);
    ch[kB2][tid] = prm.b2[tid];
    ch[kA2][tid] = prm.a2[tid];
    ch[kAe1][tid] = prm.ae1[tid];
    ch[kAe2][tid] = prm.ae2[tid];
  }
  if (tid < kE) fc1_b[tid] = prm.fc1_b[tid];
#pragma unroll
  for (int r = 0; r < kTapRounds; ++r) {
    const int i = tid + r * kThreads;
    if (i < kTaps) {
      w1[i] = tap1[r];
      w2[i] = tap2[r];
    }
  }
  float* fcf = reinterpret_cast<float*>(fc);
#pragma unroll
  for (int r = 0; r < kFcRounds; ++r) fcf[tid + r * kThreads] = fcv[r];
  __syncthreads();

  float4 (*xs)[kQuads][32] = stash[warp][0];
  float4 (*hs)[kQuads][32] = stash[warp][1];
  const int step = gridDim.x * kWarps;
  for (int b = warp * gridDim.x + blockIdx.x; b < B; b += step) {
    const size_t base = static_cast<size_t>(b) * C * kL + kP * lane;
    float4 xv[C][kQuads];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int q = 0; q < kQuads; ++q)
        xv[c][q] = __ldcs(reinterpret_cast<const float4*>(x + base + c * kL + 4 * q));

    // bn1 into the stash; the excitation's first layer: C x E dot products
    float part[C][kE];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int j = 0; j < kE; ++j) part[c][j] = 0.f;
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        float v[4];
        unpack(xv[c][q], v);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = (v[k] - ch[kBn1Mean][c]) * ch[kBn1Scale][c];
        xs[c][q][lane] = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
        for (int j = 0; j < kE; ++j) {
          float f[4];
          unpack(fc[j * kQuads + q][lane], f);
#pragma unroll
          for (int k = 0; k < 4; ++k) part[c][j] = fmaf(v[k], f[k], part[c][j]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < kE; ++j) part[c][j] += __shfl_xor_sync(kAll, part[c][j], off);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int j = 0; j < kE; ++j) part[c][j] = prelu(part[c][j] + fc1_b[j], ch[kAe1][c]);

    // conv1 (replicate pad) -> PReLU -> bn2, into the stash
    float acc[C][kP];
    conv<C, true>(xs, w1, ch[kB1], lane, acc);
#pragma unroll
    for (int o = 0; o < C; ++o)
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = (prelu(acc[o][4 * q + k], ch[kA1][o]) - ch[kBn2Mean][o]) * ch[kBn2Scale][o];
        hs[o][q][lane] = make_float4(v[0], v[1], v[2], v[3]);
      }

    // conv2 (zero pad) -> PReLU, + residual, + the excitation's second layer
    conv<C, false>(hs, w2, ch[kB2], lane, acc);
    float* dst = out + base;
#pragma unroll
    for (int o = 0; o < C; ++o)
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        float r[4], bias[4], f[kE][4], y[4];
        unpack(xs[o][q][lane], r);
        unpack(fc[kFc2Bias + q][lane], bias);
#pragma unroll
        for (int j = 0; j < kE; ++j) unpack(fc[kFc2 + j * kQuads + q][lane], f[j]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float e = 0.f;
#pragma unroll
          for (int j = 0; j < kE; ++j) e = fmaf(part[o][j], f[j][k], e);
          y[k] = prelu(acc[o][4 * q + k], ch[kA2][o]) + r[k] + prelu(e + bias[k], ch[kAe2][o]);
        }
        __stcs(reinterpret_cast<float4*>(dst + o * kL + 4 * q), make_float4(y[0], y[1], y[2], y[3]));
      }
  }
}

// Blocks of fused_block_kernel<C> the current device keeps resident at once,
// asked once per device.
template <int C>
cudaError_t resident_blocks(int* blocks) {
  static int cached[kMaxDevices];          // 0: not asked yet
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  // the largest shared-memory carveout, so that launches get the residency
  // the occupancy query reports and the grid is sized by
  err = cudaFuncSetAttribute(fused_block_kernel<C>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_block_kernel<C>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

template <int C>
int launch(const float* x, const Params& p, int B, float* out, cudaStream_t st) {
  int resident = 0;
  const cudaError_t err = resident_blocks<C>(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = min((B + kWarps - 1) / kWarps, resident);
  fused_block_kernel<C><<<grid, kThreads, 0, st>>>(x, p, B, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fused_block_length() { return kL; }
int fused_block_taps() { return kK; }
int fused_block_excitation() { return kE; }

const char* fused_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fused_block_params_bytes() { return static_cast<int>(sizeof(Params)); }

// Samples one wave of the persistent grid holds on the current device (the
// resident blocks x kWarps), or minus the cudaError_t of asking.
int fused_block_wave(int C) {
  int blocks = 0;
  const cudaError_t err = C == 4 ? resident_blocks<4>(&blocks)
                        : C == 2 ? resident_blocks<2>(&blocks) : cudaErrorInvalidValue;
  return err == cudaSuccess ? blocks * kWarps : -static_cast<int>(err);
}

// x, out: (B, C, 256) f32, contiguous, 16-byte aligned.  params: the 16
// parameter pointers in Params order (any alignment): per-channel vectors
// (C,), w1 and w2 (C, C, 11), fc1_w (2, 256), fc1_b (2,), fc2_w (256, 2),
// fc2_b (256,).  Returns cudaErrorInvalidValue for a C other than 2 or 4,
// or B < 1.
int fused_block(const float* x, int B, int C, const void* params, float* out, void* stream) {
  Params p;
  std::memcpy(&p, params, sizeof(Params));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 4: return launch<4>(x, p, B, out, st);
    case 2: return launch<2>(x, p, B, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
