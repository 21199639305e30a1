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
// What bounds it on the H100.  At B = 1024, C = 4 the two convs take
// 2 * 2 * C^2 * K * L ~ 180 kFLOP per sample and the elementwise work and
// the excitation ~20 kFLOP: ~0.2 GFLOP, ~3 us at the card's 67 TFLOP/s fp32
// rate outside the tensor cores.  The bytes are one read of x and one write
// of out, 2 * B * C * L * 4 ~ 8.4 MB, ~2.5 us at 3.35 TB/s.  So it is
// operation-bound at C = 4 and byte-bound at C = 2 (a quarter of the
// operations, half the bytes).
//
// Design (simple first).  One block of 256 threads per sample, thread l owns
// position l; a block grid-strides over the batch, so any B >= 1 is a loop
// bound.  At block start the conv taps and per-channel constants go to
// shared memory (read as broadcasts); each thread keeps its own column of
// fc1 and row of fc2 in registers.  Per sample, x is read once, coalesced,
// into shared memory; the conv inputs never leave shared memory, and out is
// written once, coalesced.  So device memory sees exactly the bound's
// bytes; the operations run on the fp32 pipes, one FMA per tap.  The fc1
// dot products over L are a fixed-order block reduction (warp shuffles, then
// one pass over the 8 warps' partials): no atomics, so the result is
// deterministic.  Tensor cores (the conv as an implicit GEMM), TMA and more
// samples per block are later work.
//
// Interface: plain C functions, loaded with ctypes by
// rankaae_tpu_torch/ops/fused_block_cuda.py, which checks and allocates
// everything.  Each returns the cudaError_t of its launch (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int kL = 256;                // length: one thread per position
constexpr int kK = 11;                 // taps
constexpr int kPad = (kK - 1) / 2;
constexpr int kE = 2;                  // excitation width
constexpr int kWarps = kL / 32;
constexpr float kEps = 1e-5f;
constexpr int kBlocksPerSM = 8;        // 8 x 256 threads fill an SM
constexpr int kSMs = 132;

struct Params {
  const float* bn1_mean; const float* bn1_var;
  const float* w1; const float* b1; const float* a1;
  const float* bn2_mean; const float* bn2_var;
  const float* w2; const float* b2; const float* a2;
  const float* fc1_w; const float* fc1_b; const float* ae1;
  const float* fc2_w; const float* fc2_b; const float* ae2;
};

__device__ __forceinline__ float prelu(float v, float a) { return v >= 0.f ? v : a * v; }

template <int C>
__global__ void __launch_bounds__(kL)
fused_block_kernel(const float* __restrict__ x, Params p, int B,
                   float* __restrict__ out) {
  constexpr int kW = C * C * kK;
  __shared__ float w1[kW], w2[kW];
  // per channel: bn1 mean, bn1 scale, b1, a1, bn2 mean, bn2 scale, b2, a2, ae1, ae2
  __shared__ float ch[10][C];
  __shared__ float fc1_b[kE];
  __shared__ float xs[C][kL];                 // bn1(x): conv1 input, clamped reads
  __shared__ float hs[C][kL + 2 * kPad];      // bn2(h) with a zero halo
  __shared__ float red[kWarps][C * kE];

  const int l = threadIdx.x, lane = l % 32, warp = l / 32;
  for (int i = l; i < kW; i += kL) {
    w1[i] = p.w1[i];
    w2[i] = p.w2[i];
  }
  if (l < C) {
    ch[0][l] = p.bn1_mean[l];
    ch[1][l] = rsqrtf(p.bn1_var[l] + kEps);
    ch[2][l] = p.b1[l];
    ch[3][l] = p.a1[l];
    ch[4][l] = p.bn2_mean[l];
    ch[5][l] = rsqrtf(p.bn2_var[l] + kEps);
    ch[6][l] = p.b2[l];
    ch[7][l] = p.a2[l];
    ch[8][l] = p.ae1[l];
    ch[9][l] = p.ae2[l];
  }
  if (l < kE) fc1_b[l] = p.fc1_b[l];
  if (l < kPad) {
    for (int c = 0; c < C; ++c) {
      hs[c][l] = 0.f;
      hs[c][kPad + kL + l] = 0.f;
    }
  }
  float f1[kE], f2[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    f1[j] = p.fc1_w[j * kL + l];
    f2[j] = p.fc2_w[l * kE + j];
  }
  const float f2b = p.fc2_b[l];
  // conv1's replicate pad: the clamped source position of each tap
  int src[kK];
#pragma unroll
  for (int t = 0; t < kK; ++t) src[t] = min(max(l + t - kPad, 0), kL - 1);
  __syncthreads();

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float* xb_in = x + static_cast<size_t>(b) * C * kL;
    float xb[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      xb[c] = (xb_in[c * kL + l] - ch[0][c]) * ch[1][c];
      xs[c][l] = xb[c];
    }
    // excitation, first layer: C x E dot products over L
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        float v = xb[c] * f1[j];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][c * kE + j] = v;
      }
    }
    __syncthreads();

    // conv1 (replicate pad) -> PReLU -> bn2, into hs
    float acc[C];
#pragma unroll
    for (int o = 0; o < C; ++o) acc[o] = ch[2][o];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int t = 0; t < kK; ++t) {
        const float v = xs[c][src[t]];
#pragma unroll
        for (int o = 0; o < C; ++o) acc[o] = fmaf(w1[(o * C + c) * kK + t], v, acc[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < C; ++o)
      hs[o][kPad + l] = (prelu(acc[o], ch[3][o]) - ch[4][o]) * ch[5][o];
    // excitation, second layer (red is complete after the barrier above)
    float ex[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float e = f2b;
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        float s = fc1_b[j];
        for (int w = 0; w < kWarps; ++w) s += red[w][c * kE + j];
        e = fmaf(prelu(s, ch[8][c]), f2[j], e);
      }
      ex[c] = prelu(e, ch[9][c]);
    }
    __syncthreads();

    // conv2 (zero pad) -> PReLU, then the three branches
#pragma unroll
    for (int o = 0; o < C; ++o) acc[o] = ch[6][o];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int t = 0; t < kK; ++t) {
        const float v = hs[c][l + t];
#pragma unroll
        for (int o = 0; o < C; ++o) acc[o] = fmaf(w2[(o * C + c) * kK + t], v, acc[o]);
      }
    }
    float* o_out = out + static_cast<size_t>(b) * C * kL;
#pragma unroll
    for (int o = 0; o < C; ++o) o_out[o * kL + l] = prelu(acc[o], ch[7][o]) + xb[o] + ex[o];
    __syncthreads();     // xs, hs and red are rewritten by the next sample
  }
}

template <int C>
int launch(const float* x, const Params& p, int B, float* out, cudaStream_t st) {
  const int grid = min(B, kSMs * kBlocksPerSM);
  fused_block_kernel<C><<<grid, kL, 0, st>>>(x, p, B, out);
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

// x, out: (B, C, 256) f32, contiguous.  Per-channel vectors: (C,).  w1, w2:
// (C, C, 11).  fc1_w: (2, 256), fc1_b: (2,), fc2_w: (256, 2), fc2_b: (256,).
// Returns cudaErrorInvalidValue for a C other than 2 or 4.
int fused_block(const float* x, int B, int C,
                const float* bn1_mean, const float* bn1_var, const float* w1,
                const float* b1, const float* a1, const float* bn2_mean,
                const float* bn2_var, const float* w2, const float* b2,
                const float* a2, const float* fc1_w, const float* fc1_b,
                const float* ae1, const float* fc2_w, const float* fc2_b,
                const float* ae2, float* out, void* stream) {
  const Params p{bn1_mean, bn1_var, w1, b1, a1, bn2_mean, bn2_var, w2, b2, a2,
                 fc1_w, fc1_b, ae1, fc2_w, fc2_b, ae2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 4: return launch<4>(x, p, B, out, st);
    case 2: return launch<2>(x, p, B, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
