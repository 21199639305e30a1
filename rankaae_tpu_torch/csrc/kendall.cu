// Kendall rank-correlation loss: the pair-sum forward (K1) and the
// gradient-row backward (K2), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of rankaae_tpu/ops/kendall_pallas.py:
//   K1 kendall_pair_sums <- _fwd_kernel via _pair_sums_pallas (:49-88, :129-145)
//   K2 kendall_grad_rows <- _bwd_kernel via _grad_rows_pallas (:91-126, :148-161)
//
// Math, per trial t and descriptor k, over all pairs (i, j) of the batch:
//   tgt = sign(d_i - d_j), p = (s_i - s_j) * tgt
//   K1: sum and count of p > 0 and of p < 0; then the activation weight
//       w_k = max(n_neg,1) / max(max(n_pos,1), max(n_neg,1)) (or 1) and
//       loss_t = -sum_k (w_k * sum_pos_k + sum_neg_k) / ((B^2 - B) K).
//   K2: grad[t, a, k] = scale_t * sum_j (p_aj > 0 ? w_k : 1) * tgt_aj,
//       scale_t = -2 g_t / ((B^2 - B) K), g_t read from device memory.
//       Exactly tied pairs (p == 0) keep weight 1, as the reference's
//       in-place masked scale does (kendall_pallas.py:115-119).
//
// What bounds it on the H100.  At the main path's shape (T=1, B=1024, K=5)
// one call is ~5.2M pair evaluations of ~6 fp32 operations on 40 KB of
// input: about 0.5 us of the card's 67 TFLOP/s fp32 rate and 0.01 us of its
// memory rate.  Nothing here is large enough to fill 132 SMs for long, so
// the real limits are the launch and the latency of each thread's serial
// loop.  The design therefore spreads the pairs wide: a block takes 32 rows
// (one per lane) and all B columns, and its 8 warps split the columns, so a
// thread runs only B/8 iterations; column tiles are staged once in shared
// memory and read as broadcasts (every lane of a warp reads the same
// column).  Ragged edges are loop bounds; there is no padding.
//
// Determinism.  Each block writes its partial sums to its own slot (warp
// shuffles, then a fixed-order sum over warps); a second tiny kernel adds
// the slots in order and computes w and the loss on the device.  No float
// atomics, so the loss is bit-identical from run to run, and no host sync.
//
// Interface: plain C functions, loaded with ctypes; pointers and the stream
// are passed by the Python wrapper (rankaae_tpu_torch/ops/kendall_cuda.py),
// which allocates every buffer.  Each function returns the cudaError_t of
// its launches (0 = success).  Inputs are (T, B, K) float32, contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;              // rows per block: one per lane
constexpr int kGroups = 8;             // warps per block: column groups
constexpr int kThreads = kRows * kGroups;
constexpr int kCols = kThreads;        // columns staged per shared tile
constexpr int kMaxK = 32;              // finish kernel: one lane per descriptor

__device__ __forceinline__ float sign_of_diff(float a, float b) {
  return static_cast<float>((a > b) - (a < b));
}

__global__ void __launch_bounds__(kThreads)
pair_sums_kernel(const float* __restrict__ d, const float* __restrict__ s,
                 int B, int K, float* __restrict__ part_sum,
                 int* __restrict__ part_cnt) {
  const int tile = blockIdx.x, k = blockIdx.y, t = blockIdx.z;
  const int lane = threadIdx.x % kRows, group = threadIdx.x / kRows;
  const float* dt = d + static_cast<size_t>(t) * B * K;
  const float* st = s + static_cast<size_t>(t) * B * K;
  const int i = tile * kRows + lane;
  const bool row_ok = i < B;
  const float di = row_ok ? dt[static_cast<size_t>(i) * K + k] : 0.f;
  const float si = row_ok ? st[static_cast<size_t>(i) * K + k] : 0.f;

  __shared__ float sd[kCols], ss[kCols];
  float sum_pos = 0.f, sum_neg = 0.f;
  int cnt_pos = 0, cnt_neg = 0;
  for (int j0 = 0; j0 < B; j0 += kCols) {
    const int n = min(kCols, B - j0);
    if (threadIdx.x < n) {
      sd[threadIdx.x] = dt[static_cast<size_t>(j0 + threadIdx.x) * K + k];
      ss[threadIdx.x] = st[static_cast<size_t>(j0 + threadIdx.x) * K + k];
    }
    __syncthreads();
    if (row_ok) {
#pragma unroll 4
      for (int c = group; c < n; c += kGroups) {
        const float p = (si - ss[c]) * sign_of_diff(di, sd[c]);
        const bool pos = p > 0.f, neg = p < 0.f;
        sum_pos += pos ? p : 0.f;
        sum_neg += neg ? p : 0.f;
        cnt_pos += pos;
        cnt_neg += neg;
      }
    }
    __syncthreads();
  }

  // fixed-order block reduction: across lanes by xor shuffles, then warp 0
  // adds the 8 warps' values in order
  for (int off = 16; off > 0; off >>= 1) {
    sum_pos += __shfl_xor_sync(0xffffffffu, sum_pos, off);
    sum_neg += __shfl_xor_sync(0xffffffffu, sum_neg, off);
    cnt_pos += __shfl_xor_sync(0xffffffffu, cnt_pos, off);
    cnt_neg += __shfl_xor_sync(0xffffffffu, cnt_neg, off);
  }
  __shared__ float wsum[2][kGroups];
  __shared__ int wcnt[2][kGroups];
  if (lane == 0) {
    wsum[0][group] = sum_pos;
    wsum[1][group] = sum_neg;
    wcnt[0][group] = cnt_pos;
    wcnt[1][group] = cnt_neg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    int ca = 0, cb = 0;
    for (int g = 0; g < kGroups; ++g) {
      a += wsum[0][g];
      b += wsum[1][g];
      ca += wcnt[0][g];
      cb += wcnt[1][g];
    }
    const size_t o = (static_cast<size_t>(t * K + k) * gridDim.x + tile) * 2;
    part_sum[o] = a;
    part_sum[o + 1] = b;
    part_cnt[o] = ca;
    part_cnt[o + 1] = cb;
  }
}

// One block per trial, one lane per descriptor: add the per-tile partials
// in order, then the activation weights and the loss.
__global__ void pair_sums_finish_kernel(const float* __restrict__ part_sum,
                                        const int* __restrict__ part_cnt,
                                        int K, int n_tiles, int activate,
                                        float norm, float* __restrict__ sums,
                                        int* __restrict__ cnts,
                                        float* __restrict__ w,
                                        float* __restrict__ loss) {
  const int t = blockIdx.x, k = threadIdx.x;
  __shared__ float num[kMaxK];
  if (k < K) {
    const size_t base = static_cast<size_t>(t * K + k) * n_tiles * 2;
    float a = 0.f, b = 0.f;
    int ca = 0, cb = 0;
    for (int tile = 0; tile < n_tiles; ++tile) {
      a += part_sum[base + 2 * tile];
      b += part_sum[base + 2 * tile + 1];
      ca += part_cnt[base + 2 * tile];
      cb += part_cnt[base + 2 * tile + 1];
    }
    const size_t o = static_cast<size_t>(t * K + k) * 2;
    sums[o] = a;
    sums[o + 1] = b;
    cnts[o] = ca;
    cnts[o + 1] = cb;
    float wk = 1.f;
    if (activate) {
      const int n_same = max(ca, 1), n_opp = max(cb, 1);
      wk = static_cast<float>(n_opp) / static_cast<float>(max(n_same, n_opp));
    }
    w[t * K + k] = wk;
    num[k] = wk * a + b;
  }
  __syncthreads();
  if (k == 0) {
    float total = 0.f;
    for (int kk = 0; kk < K; ++kk) total += num[kk];
    loss[t] = -total / norm;
  }
}

__global__ void __launch_bounds__(kThreads)
grad_rows_kernel(const float* __restrict__ d, const float* __restrict__ s,
                 const float* __restrict__ w, const float* __restrict__ g,
                 int B, int K, float norm, float* __restrict__ grad) {
  const int tile = blockIdx.x, k = blockIdx.y, t = blockIdx.z;
  const int lane = threadIdx.x % kRows, group = threadIdx.x / kRows;
  const float* dt = d + static_cast<size_t>(t) * B * K;
  const float* st = s + static_cast<size_t>(t) * B * K;
  const int a = tile * kRows + lane;
  const bool row_ok = a < B;
  const float da = row_ok ? dt[static_cast<size_t>(a) * K + k] : 0.f;
  const float sa = row_ok ? st[static_cast<size_t>(a) * K + k] : 0.f;
  const float wk = w[t * K + k];

  __shared__ float sd[kCols], ss[kCols];
  float acc = 0.f;
  for (int j0 = 0; j0 < B; j0 += kCols) {
    const int n = min(kCols, B - j0);
    if (threadIdx.x < n) {
      sd[threadIdx.x] = dt[static_cast<size_t>(j0 + threadIdx.x) * K + k];
      ss[threadIdx.x] = st[static_cast<size_t>(j0 + threadIdx.x) * K + k];
    }
    __syncthreads();
    if (row_ok) {
#pragma unroll 4
      for (int c = group; c < n; c += kGroups) {
        const float tgt = sign_of_diff(da, sd[c]);
        const float p = (sa - ss[c]) * tgt;
        acc += (p > 0.f) ? wk * tgt : tgt;
      }
    }
    __syncthreads();
  }

  // fixed-order sum of the 8 column groups of each row
  __shared__ float part[kGroups][kRows];
  part[group][lane] = acc;
  __syncthreads();
  if (group == 0 && row_ok) {
    float row = 0.f;
    for (int gi = 0; gi < kGroups; ++gi) row += part[gi][lane];
    const float scale = -2.f * g[t] / norm;
    grad[(static_cast<size_t>(t) * B + a) * K + k] = row * scale;
  }
}

}  // namespace

extern "C" {

int kendall_tile_rows() { return kRows; }

const char* kendall_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1.  part_sum/part_cnt: (T, K, n_tiles, 2) scratch, n_tiles = ceil(B/32).
// sums: (T, K, 2) f32 [pos, neg]; cnts: (T, K, 2) int32; w: (T, K); loss: (T,).
int kendall_pair_sums(const float* d, const float* s, int T, int B, int K,
                      int activate, float norm, float* part_sum, int* part_cnt,
                      float* sums, int* cnts, float* w, float* loss,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + kRows - 1) / kRows;
  pair_sums_kernel<<<dim3(n_tiles, K, T), kThreads, 0, st>>>(d, s, B, K,
                                                             part_sum, part_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_sums_finish_kernel<<<T, kMaxK, 0, st>>>(part_sum, part_cnt, K, n_tiles,
                                               activate, norm, sums, cnts, w,
                                               loss);
  return static_cast<int>(cudaGetLastError());
}

// K2.  w: (T, K) from K1; g: (T,) incoming gradient of each trial's loss;
// grad: (T, B, K), already scaled by -2 g / norm.
int kendall_grad_rows(const float* d, const float* s, const float* w,
                      const float* g, int T, int B, int K, float norm,
                      float* grad, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + kRows - 1) / kRows;
  grad_rows_kernel<<<dim3(n_tiles, K, T), kThreads, 0, st>>>(d, s, w, g, B, K,
                                                             norm, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
