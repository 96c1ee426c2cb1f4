// Forward pass of one SearchCell, for Hopper (sm_90a).
//
// Replaces nbasr_tpu/ops/fused_cell.py::_fwd_kernel (with its helpers
// _emit_conv and _emit_linear), which the JAX package reaches through
// fused_cell_apply -> _forward -> pl.pallas_call.  The backward kernel,
// _bwd_kernel's replacement, is fused_cell_bwd.cu.
//
// What a cell computes, for x [B, T, C] in f32 or bf16:
//   outs[0] = x
//   for each node n:  a = op_n(outs[n]) + bias           (f32 sums, f32 bias)
//                     y = clip(a, 0, 20)                  (0 for a zero node)
//                     y = keep ? y / (1 - p) : 0          (dropout, training)
//                     total = y + sum of outs[j], j in branches   (f32)
//                     outs[n+1] = round(total)            (activation dtype)
//   out = LayerNorm(outs[n_nodes]) over C, two-pass f32 statistics, eps given
// op_n is a grouped dilated conv1d (tap k reads outs[n][t + k*d - lpad],
// zero outside [0, T); compact weights [K, ci, C]), a dense [C, C] product,
// or nothing.  The rounding points are the TPU kernel's: its outs_ref holds
// node outputs in the activation dtype.
//
// Dropout: keep iff bits < threshold, where bits is the JAX kernel's
// interpret-mode hash (_Prng.bits) of (seed, batch row b, node counter, t,
// c) in uint32 arithmetic; the counter runs 1, 2, ... over the conv and
// linear nodes.  The TPU's hardware generator cannot be reproduced; this
// hash can, so the kernel, its plain version and the JAX package in
// interpret mode draw the same mask.  A training forward (mults != null)
// also writes each conv or linear node's multiplier, gate * keep / (1 - p)
// with the clip-ReLU gate 1 inside (0, 20), 0.5 at exactly 0 or 20 (the
// VJP of jnp.clip) and 0 outside, into mults [n_nodes, B, T, C] in the
// activation dtype (0, 0.5, 1 times 1/(1-p): exact in bf16 for p = 0.2 or
// 0.5); with scratch, which then holds every node output, that is all the
// backward reads.  Inference passes no seed and no mults and runs its own
// instantiation of the node kernels (kTrain false), which computes no gate
// and no hash.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): a conv-only cell must read x and write y once, 2*B*T*C elements;
// at B=4, T=772, C=600 in f32 that is 14.8 MB, 4.4 us, against about
// 0.1 GFLOP of conv arithmetic per node (1.7 us), so it is bound by bytes.
// A linear node adds 2*B*T*C*C operations, which bound such a cell by
// operations.  A training forward must also write the node outputs and
// multipliers it keeps, 2*n_nodes more passes over [B, T, C].
//
// Design: one launch per node and one LayerNorm launch.  Node outputs pass
// through a scratch buffer [n_nodes, B, T, C] in the activation dtype, so a
// cell moves about 2*n_nodes + 2 passes over [B, T, C] where its inference
// bound counts 2; keeping the node chain on chip is the next step.
//   conv:   one thread per output element, K*ci <= 84 FMAs, operands
//           read through L1 (neighbouring threads share input groups).
//   linear: 64x64 output tiles in shared memory, 4x4 outputs per thread.
//   zero:   an elementwise sum of the node's branches.
//   norm:   one warp per (b, t) row.
// Every launch is checked with cudaGetLastError(); the entry point returns
// the first error and launches nothing after it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOutputs = 8;     // the cell input and up to 7 nodes
constexpr int kDescInts = 7;       // kind, K, d, lpad, ci, co, branch mask
constexpr int kConv = 0, kLinear = 1, kZero = 2;
constexpr int kThreads = 256;
constexpr int kTile = 64;          // linear: output tile edge
constexpr int kTileK = 16;         // linear: reduction slice per stage
constexpr long kMaxGridY = 65535;

struct Outputs {
  void* p[kMaxOutputs];
};

__device__ __forceinline__ float load(const float* p, long i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// A conv or linear node's dropout and saving: seed null = no dropout, mult
// null = nothing saved.
template <typename T>
struct NodeTail {
  const int* seed;      // device int32 [2]
  unsigned threshold;   // keep iff bits < threshold
  float inv_keep;       // float32(1 / (1 - p))
  unsigned counter;     // this node's draw: 1, 2, ... over conv/linear nodes
  T* mult;              // [B, T, C] multiplier of this node, or null
};

// nbasr_tpu/ops/fused_cell.py _Prng.bits in interpret mode, at i = t,
// j = c, pid = b; uint32 arithmetic wraps as JAX's does.
__device__ __forceinline__ unsigned dropout_bits(unsigned s0, unsigned s1, unsigned b,
                                                 unsigned t, unsigned c, unsigned counter) {
  unsigned x = (t * 0x9E3779B1u) ^ (c * 0x85EBCA6Bu) ^ (s0 * 0xC2B2AE35u) ^
               (s1 + 0x27D4EB2Fu) ^ (b * 0x165667B1u) ^ (counter * 0x5851F42Du);
  x ^= x >> 15;
  x *= 0x2545F491u;
  x ^= x >> 13;
  x *= 0x2545F491u;
  x ^= x >> 16;
  x *= 0x2545F491u;
  return x ^ (x >> 16);
}

// The branch adds in f32 and the rounding of the node output to the
// activation dtype.
template <typename T>
__device__ __forceinline__ void add_branches(float total, unsigned branches, const Outputs& outs,
                                             long idx, T* dst) {
#pragma unroll
  for (int j = 0; j < kMaxOutputs; ++j)
    if (branches >> j & 1u) total += load(static_cast<const T*>(outs.p[j]), idx);
  store(dst, idx, total);
}

// clip-ReLU, dropout and the saved multiplier of output (row r, channel c),
// then the branch adds.  The inference instantiation (kTrain false) reads
// no tail: it is the clip and the branch adds alone.
template <typename T, bool kTrain>
__device__ __forceinline__ void finish_node(float acc, long r, int c, int C, int t_len,
                                            const NodeTail<T>& tail, unsigned branches,
                                            const Outputs& outs, T* dst) {
  float y = fminf(fmaxf(acc, 0.0f), 20.0f);
  const long idx = r * C + c;
  if (!kTrain) {
    add_branches(y, branches, outs, idx, dst);
    return;
  }
  float m = (acc > 0.0f && acc < 20.0f) ? 1.0f : ((acc == 0.0f || acc == 20.0f) ? 0.5f : 0.0f);
  if (tail.seed) {
    const long b = r / t_len;
    const unsigned t = static_cast<unsigned>(r - b * t_len);
    const bool keep = dropout_bits(static_cast<unsigned>(__ldg(tail.seed)),
                                   static_cast<unsigned>(__ldg(tail.seed + 1)),
                                   static_cast<unsigned>(b), t, static_cast<unsigned>(c),
                                   tail.counter) < tail.threshold;
    y = keep ? y * tail.inv_keep : 0.0f;
    m = keep ? m * tail.inv_keep : 0.0f;
  }
  if (tail.mult) store(tail.mult, idx, m);
  add_branches(y, branches, outs, idx, dst);
}

// grid: (ceil(C / kThreads), min(rows, 65535)); thread = channel c, block row
// loop over the B*T rows.
template <typename T, bool kTrain>
__global__ void __launch_bounds__(kThreads) nbasr_conv_node(
    const T* __restrict__ src, const T* __restrict__ w, const float* __restrict__ bias,
    T* __restrict__ dst, Outputs outs, unsigned branches, NodeTail<T> tail, long rows,
    int t_len, int C, int ci, int co, int K, int d, int lpad) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int in0 = (c / co) * ci;
  const float b = bias[c];
  for (long r = blockIdx.y; r < rows; r += gridDim.y) {
    const int t = static_cast<int>(r % t_len);
    const long first = r - t;  // row of t = 0 in this batch entry
    float acc = b;
    for (int k = 0; k < K; ++k) {
      const int ts = t + k * d - lpad;
      if (ts < 0 || ts >= t_len) continue;  // zero padding
      const T* xs = src + (first + ts) * C + in0;
      const T* wk = w + static_cast<long>(k) * ci * C + c;
      float part = 0.0f;
      for (int i = 0; i < ci; ++i) part += load(xs, i) * load(wk, static_cast<long>(i) * C);
      acc += part;
    }
    finish_node<T, kTrain>(acc, r, c, C, t_len, tail, branches, outs, dst);
  }
}

// grid: (ceil(C / 64), ceil(rows / 64)); 256 threads as 16 x 16, each
// thread owns rows ty*4 + i and columns tx + 16*j of the tile.
template <typename T, bool kTrain>
__global__ void __launch_bounds__(kThreads) nbasr_linear_node(
    const T* __restrict__ src, const T* __restrict__ w, const float* __restrict__ bias,
    T* __restrict__ dst, Outputs outs, unsigned branches, NodeTail<T> tail, long rows,
    int t_len, int C) {
  __shared__ float a_tile[kTileK][kTile + 1];  // [k][row], padded against bank conflicts
  __shared__ float w_tile[kTileK][kTile];      // [k][col]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long row0 = static_cast<long>(blockIdx.y) * kTile;
  const int col0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < C; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTile * kTileK; e += kThreads) {
      const int rr = e / kTileK, kk = e % kTileK;
      const long r = row0 + rr;
      const int k = k0 + kk;
      a_tile[kk][rr] = (r < rows && k < C) ? load(src, r * C + k) : 0.0f;
    }
    for (int e = threadIdx.x; e < kTile * kTileK; e += kThreads) {
      const int kk = e / kTile, cc = e % kTile;
      const int k = k0 + kk, col = col0 + cc;
      w_tile[kk][cc] = (k < C && col < C) ? load(w, static_cast<long>(k) * C + col) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_tile[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = w_tile[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long r = row0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < C)
        finish_node<T, kTrain>(bias[col] + acc[i][j], r, col, C, t_len, tail, branches, outs,
                               dst);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) nbasr_zero_node(T* __restrict__ dst, Outputs outs,
                                                             unsigned branches, long numel) {
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < numel;
       i += static_cast<long>(gridDim.x) * blockDim.x)
    add_branches(0.0f, branches, outs, i, dst);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per row: mean, then the mean of squared deviations (two passes,
// as the TPU kernel), then xhat * scale + shift rounded to the dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads) nbasr_layer_norm(
    const T* __restrict__ src, const float* __restrict__ scale, const float* __restrict__ shift,
    T* __restrict__ dst, long rows, int C, float eps) {
  const long r = static_cast<long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* x = src + r * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += load(x, c);
  const float mu = warp_sum(s) / C;
  float v = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float dv = load(x, c) - mu;
    v += dv * dv;
  }
  const float inv = rsqrtf(warp_sum(v) / C + eps);
  T* y = dst + r * C;
  for (int c = lane; c < C; c += 32) store(y, c, (load(x, c) - mu) * inv * scale[c] + shift[c]);
}

template <typename T>
int run_cell(int batch, int t_len, int C, int n_nodes, const int* desc,
             const void* const* weights, const void* const* biases, const void* x,
             void* scratch, void* y, const float* ln_scale, const float* ln_shift, int use_norm,
             float eps, const int* seed, unsigned threshold, float inv_keep, T* mults,
             cudaStream_t stream) {
  const long rows = static_cast<long>(batch) * t_len;
  const long numel = rows * C;
  Outputs outs = {};
  outs.p[0] = const_cast<void*>(x);
  for (int n = 0; n < n_nodes; ++n)
    outs.p[n + 1] = (n + 1 == n_nodes && !use_norm) ? y : static_cast<T*>(scratch) + n * numel;
  cudaError_t err;
  unsigned counter = 0;
  const bool train = seed || mults;
  const auto conv_node = train ? nbasr_conv_node<T, true> : nbasr_conv_node<T, false>;
  const auto linear_node = train ? nbasr_linear_node<T, true> : nbasr_linear_node<T, false>;
  for (int n = 0; n < n_nodes; ++n) {
    const int* nd = desc + n * kDescInts;
    const unsigned branches = static_cast<unsigned>(nd[6]);
    const T* src = static_cast<const T*>(outs.p[n]);
    T* dst = static_cast<T*>(outs.p[n + 1]);
    const T* w = static_cast<const T*>(weights[n]);
    const float* b = static_cast<const float*>(biases[n]);
    const NodeTail<T> tail = {seed, threshold, inv_keep, nd[0] == kZero ? 0u : ++counter,
                              mults ? mults + n * numel : nullptr};
    if (nd[0] == kConv) {
      const dim3 grid((C + kThreads - 1) / kThreads,
                      static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
      conv_node<<<grid, kThreads, 0, stream>>>(src, w, b, dst, outs, branches, tail, rows, t_len,
                                                C, nd[4], nd[5], nd[1], nd[2], nd[3]);
    } else if (nd[0] == kLinear) {
      const dim3 grid((C + kTile - 1) / kTile, static_cast<unsigned>((rows + kTile - 1) / kTile));
      linear_node<<<grid, kThreads, 0, stream>>>(src, w, b, dst, outs, branches, tail, rows,
                                                  t_len, C);
    } else if (nd[0] == kZero) {
      const long blocks = (numel + kThreads - 1) / kThreads;
      nbasr_zero_node<T><<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), kThreads, 0,
                            stream>>>(dst, outs, branches, numel);
    } else {
      return cudaErrorInvalidValue;
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (use_norm) {
    const long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    nbasr_layer_norm<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(outs.p[n_nodes]), ln_scale, ln_shift, static_cast<T*>(y), rows, C,
        eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Runs one cell on `stream`.  desc holds kDescInts ints per node; weights[n]
// and biases[n] are node n's weight (activation dtype) and f32 bias, null for
// a zero node.  scratch holds n_nodes [B, T, C] buffers of the activation
// dtype.  seed (device int32 [2]) turns dropout on, with keep iff bits <
// threshold and kept values scaled by inv_keep; mults (n_nodes [B, T, C]
// buffers of the activation dtype), when given, receives each conv or
// linear node's multiplier for the backward.  Returns a cudaError_t, 0 on
// success.
extern "C" int nbasr_fused_cell_forward(int bf16, int batch, int t_len, int C, int n_nodes,
                                        const int* desc, const void* const* weights,
                                        const void* const* biases, const void* x, void* scratch,
                                        void* y, const void* ln_scale, const void* ln_shift,
                                        int use_norm, float eps, const void* seed,
                                        unsigned threshold, float inv_keep, void* mults,
                                        void* stream) {
  if (n_nodes < 1 || n_nodes >= kMaxOutputs) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<const float*>(ln_scale);
  const auto sh = static_cast<const float*>(ln_shift);
  const auto sd = static_cast<const int*>(seed);
  if (bf16)
    return run_cell<__nv_bfloat16>(batch, t_len, C, n_nodes, desc, weights, biases, x, scratch, y,
                                   sc, sh, use_norm, eps, sd, threshold, inv_keep,
                                   static_cast<__nv_bfloat16*>(mults), s);
  return run_cell<float>(batch, t_len, C, n_nodes, desc, weights, biases, x, scratch, y, sc, sh,
                         use_norm, eps, sd, threshold, inv_keep, static_cast<float*>(mults), s);
}

extern "C" const char* nbasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
