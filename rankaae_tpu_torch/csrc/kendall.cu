// Kendall rank-correlation loss: the pair-sum forward (K1) and the
// elementwise gradient finish (K2), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of rankaae_tpu/ops/kendall_pallas.py:
//   K1 kendall_pair_sums <- _fwd_kernel via _pair_sums_pallas (:49-88, :129-145)
//   K2 kendall_grad_rows <- _bwd_kernel via _grad_rows_pallas (:91-126, :148-161)
// Each C function launches exactly one kernel per call.
//
// Math, per trial t and descriptor k, over all pairs (a, j) of the batch:
//   tgt = sign(d_a - d_j), p = (s_a - s_j) * tgt
//   K1: sum and count of p > 0 and of p < 0; the activation weight
//       w_k = max(n_neg,1) / max(max(n_pos,1), max(n_neg,1)) (or 1);
//       loss_t = -sum_k (w_k * sum_pos_k + sum_neg_k) / ((B^2 - B) K);
//       and, when a gradient is wanted, the integer row sums
//       P[t,a,k] = sum_{j: p_aj > 0} tgt_aj,  N[t,a,k] = sum_{j: p_aj <= 0} tgt_aj.
//   K2: grad[t,a,k] = -2 g_t / ((B^2 - B) K) * (w_k P[t,a,k] + N[t,a,k]).
//       Exactly tied pairs (p == 0, tgt != 0) fall in N and keep weight 1,
//       as the reference's in-place masked scale does (kendall_pallas.py:115-119).
//   P and N do not depend on w or g and are sums of +-1: exact in int32 in
//   any order, so the backward needs no second pass over the pairs.
//
// What bounds them on the H100.  At the main path's shape (T=1, B=1024, K=5)
// K1 is ~5.2M ordered-pair evaluations of ~7 operations on 40 KB of input:
// about 0.5 us of the card's 67 TFLOP/s fp32 rate and 0.03 us of its memory
// rate, so K1 is bound by operations; in practice by instruction issue
// (the compiled loop issues ~16 instructions a pair with the row sums, ~12
// without: compares, sign-bit logic and predicated adds), by the launch
// and by the tail of its last block.  K2 moves 3 x T*B*K words and does 3
// operations per element: bound by bytes (0.02 us), in practice by its
// launch.
//
// The design, against the five faults of the first version:
//   1. One pass over the pairs per training step: K1 writes P and N as a
//      by-product (a template flag; validation passes a null pointer and
//      runs the instantiation without them) and K2 is elementwise, O(T*B*K).
//   2. One launch per call each: K1's finish runs in the block that finishes
//      last for its trial (below), not in a second kernel.
//   3. A parallel finish: the last block gives each descriptor to a warp,
//      whose lanes read the per-block slots in parallel (one 16-byte load
//      per slot, lanes on consecutive slots) and add them by a fixed-order
//      xor-shuffle tree in registers; no serial walk over the slots.
//   4. The grid fills the card: a block takes kRows = 8 rows of one (t, k),
//      one warp per row, lanes split the columns.  At the main shape that is
//      128 x 5 = 640 blocks of 8 warps, all resident at once (5 blocks, 40
//      warps per SM at <= 48 registers: the launch bounds ask for it), so one
//      wave.  Each thread runs B/32 iterations into kUnroll independent
//      accumulator sets, and whole groups of 32 * kUnroll columns run
//      without a bound check so that the sets' chains interleave.  The
//      pair's sign is bit logic (p = x with y's sign bit, tgt = +-1.0 from
//      it), not a multiply of an int converted to float.  Column tiles are
//      staged once per block in shared memory as (d, s) float2 and read by
//      consecutive lanes (one 8-byte load a pair, no bank conflicts).
//      Ragged B is a loop bound; there is no padding.
//   5. The host wrapper (ops/kendall_cuda.py) makes one allocation per call,
//      reads this library's constants once and takes the raw stream handle.
//
// Determinism and the ticket.  Each block writes its partial sums to its own
// slot (xor shuffles, then a fixed-order sum over the warps), then takes a
// ticket for its trial with atomicAdd after a __threadfence().  The block
// that draws the last ticket (n_tiles * K - 1) adds the trial's slots in a
// fixed order, writes sums, cnts, w and loss, and resets the ticket to 0
// before it exits, so back-to-back calls and replays of a captured CUDA
// graph start from zero.  No float atomics: the loss is bit-identical from
// run to run.  The tickets live in a zeroed int32 buffer, one word per
// trial, that the wrapper keeps per (device, stream): it allocates one on a
// stream's first call and passes it to every later call on that stream.
// Two calls in flight at once on one buffer would draw from the same
// tickets and corrupt each other's count; calls on one stream are ordered,
// and calls on two streams draw from two buffers.  A CUDA graph keeps the
// buffer of the stream it was captured on, so the buffer must be allocated
// (by a warm-up call on that stream) before capture, and a replay must not
// overlap an eager K1 call on the capture stream.
//
// Interface: plain C functions, loaded with ctypes; pointers and the stream
// are passed by the Python wrapper, which allocates every buffer.  Each
// function returns the cudaError_t of its launch (0 = success).  Inputs are
// (T, B, K) float32, contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;               // rows per block: one per warp
constexpr int kThreads = 32 * kRows;
constexpr int kCols = 1024;            // columns staged per shared tile
constexpr int kUnroll = 4;             // independent accumulator sets per thread
constexpr int kBlocksPerSM = 5;        // all 640 blocks of the main shape resident
constexpr int kMaxK = 32;              // descriptors per trial (wrapper checks)
constexpr int kGradThreads = 256;      // K2's block
constexpr int kGradBlocks = 132 * 16;  // K2's grid cap: 16 blocks on each of 132 SMs

struct __align__(16) Slot {            // one block's partials: [pos, neg] sums, counts
  float pos, neg;
  int npos, nneg;
};

constexpr unsigned kSignBit = 0x80000000u, kOne = 0x3f800000u;   // bits of 1.0f

// One accumulator set: sums and counts of the pairs with p > 0 and p < 0
// and, with the row sums, the sums of tgt over p > 0 and over all j.  The
// counts and row sums are integers below 2^24 (a thread sees at most B/32
// columns), so float adds keep them exact.
template <bool kRowSums>
struct Acc {
  float sum_pos = 0.f, sum_neg = 0.f, cnt_pos = 0.f, cnt_neg = 0.f;
  float row_pos = 0.f, row_all = 0.f;

  // pair (a, j): y = d_a - d_j, x = s_a - s_j.  p = x * sign(y) is x with
  // y's sign bit flipped in when y != 0; where y == 0 the pair counts
  // nowhere (tgt = 0, p = 0), so no multiply and no int-to-float convert.
  __device__ __forceinline__ void visit(float da, float sa, float2 col) {
    const float y = da - col.x, x = sa - col.y;
    const bool nz = y != 0.f;
    const float p = __uint_as_float(__float_as_uint(x) ^ (__float_as_uint(y) & kSignBit));
    const float tgt = __uint_as_float((__float_as_uint(y) & kSignBit) | kOne);  // if nz
    if (nz && p > 0.f) {
      sum_pos += p;
      cnt_pos += 1.f;
      if (kRowSums) row_pos += tgt;
    }
    if (nz && p < 0.f) {
      sum_neg += p;
      cnt_neg += 1.f;
    }
    if (kRowSums && nz) row_all += tgt;
  }

  __device__ __forceinline__ void add(const Acc& o) {
    sum_pos += o.sum_pos;
    sum_neg += o.sum_neg;
    cnt_pos += o.cnt_pos;
    cnt_neg += o.cnt_neg;
    row_pos += o.row_pos;
    row_all += o.row_all;
  }
};

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool kRowSums>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
pair_sums_kernel(const float* __restrict__ d, const float* __restrict__ s, int B,
                 int K, int activate, float norm, int* __restrict__ tickets,
                 Slot* __restrict__ slots, float* __restrict__ sums,
                 int* __restrict__ cnts, float* __restrict__ w,
                 float* __restrict__ loss, int* __restrict__ pos_rows,
                 int* __restrict__ neg_rows) {
  const int tile = blockIdx.x, k = blockIdx.y, t = blockIdx.z;
  const int n_tiles = gridDim.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t base = static_cast<size_t>(t) * B * K;
  const float* dt = d + base;
  const float* st = s + base;
  const int a = tile * kRows + warp;
  const bool row_ok = a < B;           // uniform over the warp
  const float da = row_ok ? dt[static_cast<size_t>(a) * K + k] : 0.f;
  const float sa = row_ok ? st[static_cast<size_t>(a) * K + k] : 0.f;

  // column tile: (d, s) of each column side by side, one 8-byte load a pair
  __shared__ float2 cols[kCols];
  Acc<kRowSums> acc[kUnroll];
  for (int j0 = 0; j0 < B; j0 += kCols) {
    const int n = min(kCols, B - j0);
    for (int c = threadIdx.x; c < n; c += kThreads) {
      const size_t o = static_cast<size_t>(j0 + c) * K + k;
      cols[c] = make_float2(dt[o], st[o]);
    }
    __syncthreads();
    if (row_ok) {
      // whole groups of 32 * kUnroll columns without a bound check, so the
      // kUnroll independent chains interleave; then the ragged rest
      const int n_full = n - n % (32 * kUnroll);
      for (int c0 = lane; c0 < n_full; c0 += 32 * kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc[u].visit(da, sa, cols[c0 + 32 * u]);
      }
      for (int c = n_full + lane; c < n; c += 32) acc[0].visit(da, sa, cols[c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 1; u < kUnroll; ++u) acc[0].add(acc[u]);     // fixed order
  if (kRowSums) {
    const int rp = warp_sum(static_cast<int>(acc[0].row_pos));
    const int rn = warp_sum(static_cast<int>(acc[0].row_all - acc[0].row_pos));
    if (lane == 0 && row_ok) {
      const size_t o = base + static_cast<size_t>(a) * K + k;
      pos_rows[o] = rp;
      neg_rows[o] = rn;
    }
  }

  // this block's slot: across lanes by xor shuffles, then thread 0 adds the
  // warps in order
  __shared__ Slot wpart[kRows];
  __shared__ bool is_last;
  const float a_pos = warp_sum(acc[0].sum_pos), a_neg = warp_sum(acc[0].sum_neg);
  const int n_pos = warp_sum(static_cast<int>(acc[0].cnt_pos));
  const int n_neg = warp_sum(static_cast<int>(acc[0].cnt_neg));
  if (lane == 0) wpart[warp] = Slot{a_pos, a_neg, n_pos, n_neg};
  __syncthreads();
  Slot* trial_slots = slots + static_cast<size_t>(t) * K * n_tiles;
  if (threadIdx.x == 0) {
    Slot tot = wpart[0];
    for (int g = 1; g < kRows; ++g) {
      tot.pos += wpart[g].pos;
      tot.neg += wpart[g].neg;
      tot.npos += wpart[g].npos;
      tot.nneg += wpart[g].nneg;
    }
    trial_slots[static_cast<size_t>(k) * n_tiles + tile] = tot;
    __threadfence();                   // the slot is visible before the ticket
    is_last = atomicAdd(&tickets[t], 1) == n_tiles * K - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // the last block of trial t: one warp per descriptor adds its slots (lanes
  // on consecutive slots, read past L1), then a fixed-order shuffle tree
  __threadfence();
  __shared__ float num[kMaxK];
  for (int kk = warp; kk < K; kk += kRows) {
    const float4* ks = reinterpret_cast<const float4*>(trial_slots + static_cast<size_t>(kk) * n_tiles);
    float p = 0.f, q = 0.f;
    int np = 0, nq = 0;
    for (int i = lane; i < n_tiles; i += 32) {
      const float4 v = __ldcg(ks + i);
      p += v.x;
      q += v.y;
      np += __float_as_int(v.z);
      nq += __float_as_int(v.w);
    }
    p = warp_sum(p);
    q = warp_sum(q);
    np = warp_sum(np);
    nq = warp_sum(nq);
    if (lane == 0) {
      const size_t o = static_cast<size_t>(t * K + kk) * 2;
      sums[o] = p;
      sums[o + 1] = q;
      cnts[o] = np;
      cnts[o + 1] = nq;
      float wk = 1.f;
      if (activate) {
        const int n_same = max(np, 1), n_opp = max(nq, 1);
        wk = static_cast<float>(n_opp) / static_cast<float>(max(n_same, n_opp));
      }
      w[t * K + kk] = wk;
      num[kk] = __fadd_rn(__fmul_rn(wk, p), q);   // the plain version's roundings
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int kk = 0; kk < K; ++kk) total += num[kk];
    loss[t] = -total / norm;
    tickets[t] = 0;                    // every block of trial t has drawn
  }
}

__global__ void __launch_bounds__(kGradThreads)
grad_rows_kernel(const int* __restrict__ pos_rows, const int* __restrict__ neg_rows,
                 const float* __restrict__ w, const float* __restrict__ g,
                 long long n, int BK, int K, float norm, float* __restrict__ grad) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += stride) {
    const int t = static_cast<int>(e / BK), k = static_cast<int>(e % K);
    // the plain version's order and roundings: (-2 g) / norm, w * P, + N, *
    const float scale = __fdiv_rn(-2.f * g[t], norm);
    const float row = __fadd_rn(__fmul_rn(w[t * K + k], static_cast<float>(pos_rows[e])),
                                static_cast<float>(neg_rows[e]));
    grad[e] = __fmul_rn(scale, row);
  }
}

}  // namespace

extern "C" {

int kendall_tile_rows() { return kRows; }

const char* kendall_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1.  tickets: (T,) int32, zero between calls (the kernel leaves it so).
// slots: (T, K, n_tiles) 16-byte Slots, n_tiles = ceil(B / kRows), scratch.
// sums: (T, K, 2) f32 [pos, neg]; cnts: (T, K, 2) int32; w: (T, K); loss: (T,).
// rows: null, or (2, T, B, K) int32 [P, N].
int kendall_pair_sums(const float* d, const float* s, int T, int B, int K,
                      int activate, float norm, int* tickets, void* slots,
                      float* sums, int* cnts, float* w, float* loss, int* rows,
                      void* stream) {
  const int n_tiles = (B + kRows - 1) / kRows;
  const dim3 grid(n_tiles, K, T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Slot* sl = static_cast<Slot*>(slots);
  if (rows == nullptr) {
    pair_sums_kernel<false><<<grid, kThreads, 0, st>>>(d, s, B, K, activate, norm, tickets,
                                                      sl, sums, cnts, w, loss, nullptr,
                                                      nullptr);
  } else {
    const size_t n = static_cast<size_t>(T) * B * K;
    pair_sums_kernel<true><<<grid, kThreads, 0, st>>>(d, s, B, K, activate, norm, tickets,
                                                     sl, sums, cnts, w, loss, rows, rows + n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2.  pos_rows, neg_rows: (T, B, K) int32 P and N from K1; w: (T, K) from
// K1; g: (T,) incoming gradient of each trial's loss; grad: (T, B, K).
int kendall_grad_rows(const int* pos_rows, const int* neg_rows, const float* w,
                      const float* g, int T, int B, int K, float norm, float* grad,
                      void* stream) {
  const long long n = static_cast<long long>(T) * B * K;
  const long long blocks = (n + kGradThreads - 1) / kGradThreads;
  const int grid = static_cast<int>(blocks < kGradBlocks ? blocks : kGradBlocks);
  grad_rows_kernel<<<grid, kGradThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pos_rows, neg_rows, w, g, n, B * K, K, norm, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
