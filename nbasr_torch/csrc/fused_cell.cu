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
// node outputs in the activation dtype.  The clip is two comparisons, so a
// NaN pre-activation stays NaN (jnp.clip's and torch.clamp's rule) and
// +-inf clip to 20 and 0.
//
// Dropout: keep iff bits < threshold, where bits is the JAX kernel's
// interpret-mode hash (_Prng.bits) of (seed, batch row b, node counter, t,
// c0 + c) in uint32 arithmetic, c0 the channel offset of a tensor-parallel
// shard (0 for a whole cell), so that a shard of C/tp channels draws the
// whole cell's masks on its channels; the counter runs 1, 2, ... over the
// conv and linear nodes.  The TPU's hardware generator cannot be reproduced; this
// hash can, so the kernel, its plain version and the JAX package in
// interpret mode draw the same mask.  A training forward (mults != null)
// also writes each conv or linear node's multiplier, gate * keep / (1 - p)
// with the clip-ReLU gate 1 inside (0, 20), 0.5 at exactly 0 or 20 (the
// VJP of jnp.clip) and 0 outside (NaN included), into mults [n_nodes, B,
// T, C] in the activation dtype (0, 0.5, 1 times 1/(1-p): exact in bf16
// for p = 0.2 or 0.5); with scratch, which then holds every node output,
// that is all the backward reads.  Inference passes no seed and no mults
// and runs its own instantiation of the node kernels (kTrain false), which
// computes no gate and no hash.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): a conv-only cell must read x and write y once, 2*B*T*C elements;
// at B=4, T=772, C=600 in f32 that is 14.8 MB, 4.4 us, against about
// 0.1 GFLOP of conv arithmetic per node (1.7 us), so it is bound by bytes.
// A linear node adds 2*B*T*C*C operations, which bound such a cell by
// operations.  A training forward must also write the node outputs and
// multipliers it keeps, 2*n_nodes more passes over [B, T, C].
//
// Design: one launch per node and one LayerNorm launch (4 for the
// flagship's three conv nodes).  Node outputs pass through a scratch buffer
// [n_nodes, B, T, C] in the activation dtype, so a cell moves about
// 2*n_nodes + 2 passes over [B, T, C] where its inference bound counts 2.
//   conv:   the grouped conv forward's body (gconv_body.cuh's conv_units:
//           each unit's x tile staged by cp.async with its halo, the f32
//           weights staged once, a 7 x OT register tile of times by
//           outputs, blocks walking units with the next tile in flight) on
//           the node input seen as the [B, c, T, G] view with strides
//           (T*C, 1, C, ci), planned in Python (fused_cell.forward_plans:
//           grouped_conv.fwd_plan with an f32 output tile) and checked
//           again here.  The plain f32 sums go to an f32 output tile (over
//           the x tile where they fit); the node epilogue, a template
//           parameter of conv_units, is its store pass: per vector of up
//           to four elements, in registers at each output's (b, t, c), the
//           f32 bias, the clip, and in training the gate and the dropout
//           hash, the multipliers stored as one vector, then the branches
//           added in f32 and the total rounded once into the node output,
//           so the JAX kernel's rounding points hold.  The epilogue runs
//           after the register tile is dead, and every store is a vector
//           along the contiguous (g, c) run: applied inside the register
//           tile's loop it took the bf16 tiles to 128 registers and
//           200-byte spills, with scalar multiplier stores a channel group
//           apart.
//   linear: in bf16, where C % 8 == 0 and the operands lie on 16 bytes
//           (the plan, fused_cell.linear_plans, checked again here), the
//           tensor-core GEMM of linear_mma.cuh (TMA ring, wgmma, 128 x 128
//           tiles) with the same epilogue on each thread's column pairs
//           straight from its f32 accumulators; in f32 (and bf16 otherwise)
//           64x64 output tiles in shared memory, 4x4 outputs per thread on
//           FMAs (f32 on the tensor cores would be TF32), the same
//           epilogue, then the branch adds.
//   zero:   an elementwise sum of the node's branches in vectors.
//   norm:   one warp per (b, t) row, three passes over it through L1.
// Every launch is checked with cudaGetLastError(); the entry point returns
// the first error and launches nothing after it.

#include "gconv_body.cuh"
#include "linear_mma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

namespace {

using gconv::FwdPlan;
using gconv::Stage;
using gconv::View;

constexpr int kMaxOutputs = 8;  // the cell input and up to 7 nodes
// A node's descriptor: kind, K, d, lpad, ci, co, branch mask, then a conv
// node's launch plan (fwd_plan's FWD_PLAN_FIELDS), a linear node's path
// (then zeros), zeros for a zero node
constexpr int kPlanAt = 7;
constexpr int kDescInts = kPlanAt + gconv::kFwdPlanInts;
constexpr int kConv = 0, kLinear = 1, kZero = 2;
// a linear node's path, the first int of its plan: the SIMT kernel or the
// tensor-core GEMM (fused_cell.LINEAR_FMA, LINEAR_MMA)
constexpr int kLinearFma = 0, kLinearMma = 1;
constexpr int kThreads = 256;
constexpr int kTile = 64;   // linear: output tile edge
constexpr int kTileK = 16;  // linear: reduction slice per stage

struct Outputs {
  const void* p[kMaxOutputs];
};

__device__ __forceinline__ float load(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// N consecutive values (one vector of 4N bytes in f32, 2N in bf16) to and
// from f32; the address is aligned to the vector.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      v[i] = a.x, v[i + 1] = a.y, v[i + 2] = a.z, v[i + 3] = a.w;
    }
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float (&v)[N]) {
  if constexpr (N == 8 || N == 4 || N == 2) {
    using V = std::conditional_t<N == 8, uint4, std::conditional_t<N == 4, uint2, unsigned>>;
    const V a = *reinterpret_cast<const V*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __bfloat162float(h[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __bfloat162float(p[i]);
  }
}
template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}
template <int N>
__device__ __forceinline__ void store_n(__nv_bfloat16* p, const float (&v)[N]) {
  if constexpr (N == 8 || N == 4 || N == 2) {
    using V = std::conditional_t<N == 8, uint4, std::conditional_t<N == 4, uint2, unsigned>>;
    union {
      __nv_bfloat16 h[N];
      V u;
    } a;
#pragma unroll
    for (int i = 0; i < N; ++i) a.h[i] = __float2bfloat16_rn(v[i]);
    *reinterpret_cast<V*>(p) = a.u;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// nbasr_tpu/ops/fused_cell.py _Prng.bits in interpret mode, at i = t,
// j = c, pid = b; uint32 arithmetic wraps as JAX's does.  bits = the mix of
// (the row's key) ^ c * 0x85EBCA6B, so a row's key is computed once.
__device__ __forceinline__ unsigned dropout_row_key(unsigned s0, unsigned s1, unsigned b,
                                                    unsigned t, unsigned counter) {
  return (t * 0x9E3779B1u) ^ (s0 * 0xC2B2AE35u) ^ (s1 + 0x27D4EB2Fu) ^ (b * 0x165667B1u) ^
         (counter * 0x5851F42Du);
}
__device__ __forceinline__ unsigned dropout_bits(unsigned key, unsigned c) {
  unsigned x = key ^ (c * 0x85EBCA6Bu);
  x ^= x >> 15;
  x *= 0x2545F491u;
  x ^= x >> 13;
  x *= 0x2545F491u;
  x ^= x >> 16;
  x *= 0x2545F491u;
  return x ^ (x >> 16);
}

// A conv or linear node's epilogue at one output: the f32 bias, the
// clip-ReLU(0, 20) by comparisons (not fmaxf/fminf, which drop NaN), and in
// training (kTrain) the gate, the dropout and the multiplier.  The
// inference instantiation reads no seed, hash or multiplier.
template <typename T, bool kTrain>
struct NodeEpilogue {
  const float* bias;  // f32 [C] (16-byte aligned for a conv node)
  const int* seed;    // device int32 [2], or null: no dropout
  unsigned threshold; // keep iff bits < threshold
  float inv_keep;     // float32(1 / (1 - p))
  unsigned counter;   // this node's draw: 1, 2, ... over conv/linear nodes
  T* mult;            // [B, T, C] multiplier of this node, or null
  int t_len, C;
  int c0;             // the hash's channel offset: a shard's first channel

  // The dropout hash's key of row (b, t): what the outputs of one row share.
  __device__ __forceinline__ unsigned row_key(int b, int t) const {
    if (!kTrain || !seed) return 0u;
    return dropout_row_key(static_cast<unsigned>(__ldg(seed)),
                           static_cast<unsigned>(__ldg(seed + 1)), static_cast<unsigned>(b),
                           static_cast<unsigned>(t), counter);
  }

  // The value of output (row key, c) before the branch adds, from its f32
  // sum and bias; in training its multiplier goes to *m.
  __device__ __forceinline__ float value(float acc, float bias_c, unsigned key, int c,
                                         float* m) const {
    const float a = acc + bias_c;
    float y = a < 0.0f ? 0.0f : a;
    y = y > 20.0f ? 20.0f : y;
    if constexpr (kTrain) {
      float g = (a > 0.0f && a < 20.0f) ? 1.0f : ((a == 0.0f || a == 20.0f) ? 0.5f : 0.0f);
      if (seed) {
        const bool keep = dropout_bits(key, static_cast<unsigned>(c0 + c)) < threshold;
        y = keep ? y * inv_keep : 0.0f;
        g = keep ? g * inv_keep : 0.0f;
      }
      *m = g;
    }
    return y;
  }
};

// The conv node's epilogue for conv_units, in its store pass over the f32
// tile of plain sums: per vector of the plan's y_vec / 4 elements at (b, t,
// c), ..., their bias as one vector and the row's hash key once, then
// NodeEpilogue's value of each in registers, the multipliers stored as one
// vector, and the branches (outs[j] at the same elements, in f32, j in
// order) added before the one rounding into dst.
template <typename T, bool kTrain>
struct ConvEpilogue : NodeEpilogue<T, kTrain> {
  T* dst;
  Outputs outs;
  unsigned branches;

  template <int N>
  __device__ __forceinline__ void finish(long long e, const float* s, int b, int t) const {
    const int c = static_cast<int>(e - (static_cast<long long>(b) * this->t_len + t) * this->C);
    const unsigned key = this->row_key(b, t);
    float v[N], m[N], bias[N];
    load_n<N>(s, v);
    load_n<N>(this->bias + c, bias);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = this->value(v[i], bias[i], key, c + i, &m[i]);
    if (kTrain && this->mult) store_n<N>(this->mult + e, m);
#pragma unroll
    for (int j = 0; j < kMaxOutputs; ++j) {
      if (!(branches >> j & 1u)) continue;
      float a[N];
      load_n<N>(static_cast<const T*>(outs.p[j]) + e, a);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += a[i];
    }
    store_n<N>(dst + e, v);
  }

  // The dense view's runs (mode 1): one (g, c) run of the slab per time.
  __device__ __forceinline__ void store(int b, int t0, long long at, const float* sm,
                                        const Stage& st, int nrows, int gs, int geff) const {
    const int per_vec = st.vec / static_cast<int>(sizeof(float));
    gconv::for_each_vector(st, nrows, gs, geff * st.nch / per_vec,
                           [&](int soff, long long goff, int trow, int v) {
                             const float* s = sm + soff + v * per_vec;
                             const long long e = at + goff + trow * st.v.t + v * per_vec;
                             if (per_vec == 4)
                               finish<4>(e, s, b, t0 + trow);
                             else if (per_vec == 2)
                               finish<2>(e, s, b, t0 + trow);
                             else
                               finish<1>(e, s, b, t0 + trow);
                           });
  }
};

// One conv node: conv_units on src (the dense [B, T, C] node input as the
// [B, ci, T, G] view), no bias of T and no clip of its own, the plain sums
// in an f32 output tile (Y = float), written out by the epilogue above.
template <typename T, int KT, int OT, bool kTrain>
__global__ void __launch_bounds__(gconv::kFwdThreads)
    nbasr_fused_conv_fwd(const T* __restrict__ src, Stage xs, const T* __restrict__ w, Stage ys,
                         FwdPlan p, int batch, int t_len, int groups, int ci, int K, int d,
                         int lpad, const __grid_constant__ ConvEpilogue<T, kTrain> epi) {
  gconv::conv_units<T, KT, gconv::kFwdRt, OT, false, false, float, false, ConvEpilogue<T, kTrain>>(
      src, xs, w, nullptr, nullptr, ys, p, batch, t_len, groups, ci, ci, K, d, lpad, epi);
}

// The branch adds in f32 and the rounding of the node output to the
// activation dtype, one element.
template <typename T>
__device__ __forceinline__ void add_branches(float total, unsigned branches, const Outputs& outs,
                                             long long idx, T* dst) {
#pragma unroll
  for (int j = 0; j < kMaxOutputs; ++j)
    if (branches >> j & 1u) total += load(static_cast<const T*>(outs.p[j]), idx);
  store(dst, idx, total);
}

// grid: (ceil(C / 64), ceil(rows / 64)); 256 threads as 16 x 16, each
// thread owns rows ty*4 + i and columns tx + 16*j of the tile.
template <typename T, bool kTrain>
__global__ void __launch_bounds__(kThreads) nbasr_linear_node(
    const T* __restrict__ src, const T* __restrict__ w, T* __restrict__ dst, Outputs outs,
    unsigned branches, const __grid_constant__ NodeEpilogue<T, kTrain> epi, long long rows) {
  __shared__ float a_tile[kTileK][kTile + 1];  // [k][row], padded against bank conflicts
  __shared__ float w_tile[kTileK][kTile];      // [k][col]
  const int C = epi.C, t_len = epi.t_len;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row0 = static_cast<long long>(blockIdx.y) * kTile;
  const int col0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < C; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTile * kTileK; e += kThreads) {
      const int rr = e / kTileK, kk = e % kTileK;
      const long long r = row0 + rr;
      const int k = k0 + kk;
      a_tile[kk][rr] = (r < rows && k < C) ? load(src, r * C + k) : 0.0f;
    }
    for (int e = threadIdx.x; e < kTile * kTileK; e += kThreads) {
      const int kk = e / kTile, cc = e % kTile;
      const int k = k0 + kk, col = col0 + cc;
      w_tile[kk][cc] = (k < C && col < C) ? load(w, static_cast<long long>(k) * C + col) : 0.0f;
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
    const long long r = row0 + ty * 4 + i;
    if (r >= rows) continue;
    const int b = static_cast<int>(r / t_len);
    const int t = static_cast<int>(r - static_cast<long long>(b) * t_len);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= C) continue;
      float m;
      const float y = epi.value(acc[i][j], __ldg(epi.bias + col), epi.row_key(b, t), col, &m);
      if (kTrain && epi.mult) store(epi.mult, r * C + col, m);
      add_branches(y, branches, outs, r * C + col, dst);
    }
  }
}

// The linear node's epilogue on the tensor-core path, over the staged f32
// tile in vectors of kV columns, kP rows of them a thread at a time:
// NodeEpilogue's value of each element, the multipliers stored as one
// vector, then each branch's kP vectors loaded together and added in f32
// in order, and one rounding into dst: nbasr_linear_node's arithmetic.
// Two rows, not four: four spilled in training and ran the forward 1.4x
// slower on an H100.
template <bool kTrain>
struct LinearMmaEpilogue : NodeEpilogue<__nv_bfloat16, kTrain> {
  static constexpr int kV = 8, kP = 2;
  __nv_bfloat16* dst;
  Outputs outs;
  unsigned branches;

  __device__ __forceinline__ void tile(const float* s, long long m0, int n0, long long M,
                                       int N) const {
    lmma::tile_pass<kV, kP>(s, m0, n0, M, N, [&](const auto& sv, const auto& r, int c,
                                                 const auto& live) {
      float bias[kV], v[kP][kV];
      long long e[kP];
#pragma unroll
      for (int i = 0; i < kV; ++i) bias[i] = __ldg(this->bias + c + i);
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        e[q] = r[q] * this->C + c;
        if (!live[q]) continue;
        const int row = static_cast<int>(r[q]);  // rows < 2^31 (lmma::launch)
        const int b = row / this->t_len;
        const unsigned key = this->row_key(b, row - b * this->t_len);
        float a[kV], m[kV];
        load_n<kV>(sv[q], a);
#pragma unroll
        for (int i = 0; i < kV; ++i) v[q][i] = this->value(a[i], bias[i], key, c + i, &m[i]);
        if (kTrain && this->mult) store_n<kV>(this->mult + e[q], m);
      }
#pragma unroll
      for (int j = 0; j < kMaxOutputs; ++j) {
        if (!(branches >> j & 1u)) continue;
        const auto* src = static_cast<const __nv_bfloat16*>(outs.p[j]);
        float a[kP][kV];
#pragma unroll
        for (int q = 0; q < kP; ++q)
          if (live[q]) load_n<kV>(src + e[q], a[q]);
#pragma unroll
        for (int q = 0; q < kP; ++q)
#pragma unroll
          for (int i = 0; i < kV; ++i) v[q][i] += a[q][i];
      }
#pragma unroll
      for (int q = 0; q < kP; ++q)
        if (live[q]) store_n<kV>(dst + e[q], v[q]);
    });
  }
};

// z = src W on the tensor cores: src [rows, C] read K-major, W [C, C]
// (k, c) read N-major, then the epilogue above.
template <bool kTrain>
__global__ void __launch_bounds__(lmma::kThreads, 2)
    nbasr_linear_node_mma(const __grid_constant__ CUtensorMap src, const __grid_constant__ CUtensorMap w,
                          long long rows, int C, int k_tiles,
                          const __grid_constant__ LinearMmaEpilogue<kTrain> epi) {
  lmma::gemm_tile<false, true>(src, w, rows, C, k_tiles, epi);
}

// The sum of the branches, N elements a thread at a time (numel % N == 0).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) nbasr_zero_node(T* __restrict__ dst, Outputs outs,
                                                             unsigned branches, long long numel) {
  for (long long i = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) * N;
       i < numel; i += static_cast<long long>(gridDim.x) * blockDim.x * N) {
    float v[N] = {};
#pragma unroll
    for (int j = 0; j < kMaxOutputs; ++j) {
      if (!(branches >> j & 1u)) continue;
      float a[N];
      load_n<N>(static_cast<const T*>(outs.p[j]) + i, a);
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] += a[k];
    }
    store_n<N>(dst + i, v);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per row: mean, then the mean of squared deviations (two passes,
// as the TPU kernel), then xhat * scale + shift rounded to the dtype.  Each
// pass reads the row again, through L1: a warp's load covers 32
// consecutive elements, and lane l sums elements l, l + 32, ... in order
// before the warp's xor tree.  Holding the row in registers in this order
// ran slower on an H100 (121-128 registers a thread), and 16-byte vectors
// a lane would change the f32 summation order.
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

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<unsigned long long>(p) % static_cast<unsigned long long>(bytes) == 0;
}

// f(KT, OT) as integral constants for a conv node's register tile (kt, ot)
// of kFwdRt times, else -1: in bf16 the grouped forward's tiles
// (with_fwd_tile: taps 5 and 7 by outputs 6, 8, 10); in f32, the serving
// dtype, taps 5 by outputs 6, 8, 10 (fused_cell.F32_TILES: conv7 nodes
// take a chunk of 5 taps and one of 2).
template <typename T, typename F>
int with_conv_tile(int kt, int ot, F&& f) {
  if constexpr (std::is_same_v<T, float>) {
#define NBASR_F32_TILE(KT, OT) \
  if (kt == KT && ot == OT)    \
    return f(std::integral_constant<int, KT>{}, std::integral_constant<int, OT>{});
    NBASR_F32_TILE(5, 6)
    NBASR_F32_TILE(5, 8)
    NBASR_F32_TILE(5, 10)
#undef NBASR_F32_TILE
    return -1;
  } else {
    return gconv::with_fwd_tile<T>(kt, ot, f);
  }
}

// A dense [B, T, C] tensor of nch-channel groups as the [B, c, T, G] view.
View dense(int t_len, int C, int nch) {
  return View{static_cast<long long>(t_len) * C, 1, C, nch};
}

// One conv node on the plan Python made (fwd_plan of the conv with an f32
// output tile), checked again here with the pointers' alignment: the
// staged input to its x_vec bytes, dst and the branches to the store
// pass's vectors.
template <typename T, bool kTrain>
int conv_node(const int* nd, int batch, int t_len, int C, const T* src, const T* w,
              const ConvEpilogue<T, kTrain>& epi, cudaStream_t s) {
  const int K = nd[1], d = nd[2], lpad = nd[3], ci = nd[4];
  if (K < 1 || d < 1 || ci < 1 || nd[5] != ci || C % ci != 0 || lpad < 0 || lpad > (K - 1) * d)
    return cudaErrorInvalidValue;
  FwdPlan p;
  std::memcpy(&p, nd + kPlanAt, sizeof(p));
  const int groups = C / ci;
  if (gconv::bad_fwd_plan(p, sizeof(T), sizeof(float), batch, t_len, groups, ci, ci, K, d) ||
      p.y_mode != 1)
    return cudaErrorInvalidValue;
  const Stage xs{dense(t_len, C, ci), ci, p.x_mode, p.x_vec};
  const Stage ys{dense(t_len, C, ci), ci, p.y_mode, p.y_vec};
  if (!gconv::stage_fits(xs, sizeof(T)) || !gconv::stage_fits(ys, sizeof(float)))
    return cudaErrorInvalidValue;
  const long long vec = static_cast<long long>(p.y_vec) / 4 * sizeof(T);
  bool ok = aligned(src, p.x_vec) && aligned(epi.dst, vec) && aligned(epi.bias, 16);
  for (int j = 0; j < kMaxOutputs; ++j)
    if (epi.branches >> j & 1u) ok = ok && aligned(epi.outs.p[j], vec);
  if (!ok) return cudaErrorInvalidValue;
  const int err = with_conv_tile<T>(p.kt, p.ot, [&](auto kt, auto ot) {
    return gconv::launch_units(
        nbasr_fused_conv_fwd<T, decltype(kt)::value, decltype(ot)::value, kTrain>, p, batch, s,
        src, xs, w, ys, p, batch, t_len, groups, ci, K, d, lpad, epi);
  });
  return err < 0 ? cudaErrorInvalidValue : err;
}

template <typename T, bool kTrain>
int run_cell(int batch, int t_len, int C, int n_nodes, const int* desc,
             const void* const* weights, const void* const* biases, const void* x,
             void* scratch, void* y, const float* ln_scale, const float* ln_shift, int use_norm,
             float eps, const int* seed, unsigned threshold, float inv_keep, int c0,
             T* mults, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * t_len;
  const long long numel = rows * C;
  if (rows == 0) return cudaSuccess;
  Outputs outs = {};
  outs.p[0] = x;
  for (int n = 0; n < n_nodes; ++n)
    outs.p[n + 1] = (n + 1 == n_nodes && !use_norm) ? y : static_cast<T*>(scratch) + n * numel;
  // every node's descriptor first: nothing launches before all pass
  for (int n = 0; n < n_nodes; ++n) {
    const int* nd = desc + n * kDescInts;
    if (nd[0] != kConv && nd[0] != kLinear && nd[0] != kZero) return cudaErrorInvalidValue;
    if (nd[6] >> (n + 1)) return cudaErrorInvalidValue;
    if (nd[0] != kLinear) continue;
    if (nd[kPlanAt] != kLinearFma && nd[kPlanAt] != kLinearMma) return cudaErrorInvalidValue;
    if (nd[kPlanAt] == kLinearFma) continue;
    // the tensor-core path: bf16, rows of 8 elements and every operand on
    // 16 bytes (TMA's, and the epilogue's vectors)
    bool ok = std::is_same_v<T, __nv_bfloat16> && C % 8 == 0 && aligned(outs.p[n], 16) &&
              aligned(weights[n], 16) && aligned(outs.p[n + 1], 16) &&
              (!mults || aligned(mults + n * numel, 16));
    for (int j = 0; j < kMaxOutputs; ++j)
      if (nd[6] >> j & 1) ok = ok && aligned(outs.p[j], 16);
    if (!ok) return cudaErrorInvalidValue;
  }
  int err;
  unsigned counter = 0;
  for (int n = 0; n < n_nodes; ++n) {
    const int* nd = desc + n * kDescInts;
    const unsigned branches = static_cast<unsigned>(nd[6]);
    const T* src = static_cast<const T*>(outs.p[n]);
    T* dst = static_cast<T*>(const_cast<void*>(outs.p[n + 1]));
    const T* w = static_cast<const T*>(weights[n]);
    NodeEpilogue<T, kTrain> epi{static_cast<const float*>(biases[n]),
                                seed,
                                threshold,
                                inv_keep,
                                nd[0] == kZero ? 0u : ++counter,
                                mults ? mults + n * numel : nullptr,
                                t_len,
                                C,
                                c0};
    if (nd[0] == kConv) {
      ConvEpilogue<T, kTrain> conv;
      static_cast<NodeEpilogue<T, kTrain>&>(conv) = epi;
      conv.dst = dst;
      conv.outs = outs;
      conv.branches = branches;
      err = conv_node<T, kTrain>(nd, batch, t_len, C, src, w, conv, stream);
    } else if (nd[0] == kLinear && nd[kPlanAt] == kLinearMma) {
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        LinearMmaEpilogue<kTrain> mma;
        static_cast<NodeEpilogue<T, kTrain>&>(mma) = epi;
        mma.dst = dst;
        mma.outs = outs;
        mma.branches = branches;
        err = lmma::launch<false, true>(nbasr_linear_node_mma<kTrain>, src, w, rows, C, C, 1, mma,
                                        stream);
      } else {
        err = cudaErrorInvalidValue;
      }
    } else if (nd[0] == kLinear) {
      const dim3 grid((C + kTile - 1) / kTile, static_cast<unsigned>((rows + kTile - 1) / kTile));
      nbasr_linear_node<T, kTrain><<<grid, kThreads, 0, stream>>>(src, w, dst, outs, branches, epi,
                                                                  rows);
      err = cudaGetLastError();
    } else {
      constexpr int kVec = 16 / sizeof(T);
      bool vec = numel % kVec == 0 && aligned(dst, 16);
      for (int j = 0; j < kMaxOutputs; ++j)
        if (branches >> j & 1u) vec = vec && aligned(outs.p[j], 16);
      const long long per = vec ? kVec : 1;
      const long long blocks = (numel / per + kThreads - 1) / kThreads;
      const unsigned grid = static_cast<unsigned>(blocks < 8192 ? blocks : 8192);
      if (vec)
        nbasr_zero_node<T, kVec><<<grid, kThreads, 0, stream>>>(dst, outs, branches, numel);
      else
        nbasr_zero_node<T, 1><<<grid, kThreads, 0, stream>>>(dst, outs, branches, numel);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return err;
  }
  if (!use_norm && mults) {
    // without a LayerNorm the last node wrote y; the saved node outputs
    // hold it too, as the plain version's do
    err = cudaMemcpyAsync(static_cast<T*>(scratch) + (n_nodes - 1) * numel, y,
                          numel * sizeof(T), cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return err;
  }
  if (use_norm) {
    const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    nbasr_layer_norm<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(outs.p[n_nodes]), ln_scale, ln_shift, static_cast<T*>(y), rows, C,
        eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
int run(int batch, int t_len, int C, int n_nodes, const int* desc, const void* const* weights,
        const void* const* biases, const void* x, void* scratch, void* y, const float* ln_scale,
        const float* ln_shift, int use_norm, float eps, const int* seed, unsigned threshold,
        float inv_keep, int c0, void* mults, cudaStream_t stream) {
  if (seed || mults)
    return run_cell<T, true>(batch, t_len, C, n_nodes, desc, weights, biases, x, scratch, y,
                             ln_scale, ln_shift, use_norm, eps, seed, threshold, inv_keep, c0,
                             static_cast<T*>(mults), stream);
  return run_cell<T, false>(batch, t_len, C, n_nodes, desc, weights, biases, x, scratch, y,
                            ln_scale, ln_shift, use_norm, eps, seed, threshold, inv_keep, c0,
                            nullptr, stream);
}

// The fewer resident blocks per SM of a conv node's two instantiations.
template <typename T, int KT, int OT>
int conv_occupancy(int threads, int smem) {
  const int infer = gconv::occupancy(nbasr_fused_conv_fwd<T, KT, OT, false>, threads, smem);
  const int train = gconv::occupancy(nbasr_fused_conv_fwd<T, KT, OT, true>, threads, smem);
  return infer < train ? infer : train;
}

}  // namespace

// Runs one cell on `stream`.  desc holds kDescInts ints per node: kind, K,
// d, lpad, ci, co, branch mask, then a conv node's launch plan
// (fused_cell.forward_plans, in FWD_PLAN_FIELDS order), a linear node's
// path (fused_cell.linear_plans: kLinearFma or kLinearMma, then zeros),
// zeros for a zero node; weights[n] and biases[n] are node n's weight (activation dtype)
// and f32 bias, null for a zero node.  scratch holds n_nodes [B, T, C]
// buffers of the activation dtype.  seed (device int32 [2]) turns dropout
// on, with keep iff bits < threshold and kept values scaled by inv_keep,
// the hash taking channel c as c0 + c (a tensor-parallel shard's offset);
// mults (n_nodes [B, T, C] buffers of the activation dtype), when given,
// receives each conv or linear node's multiplier for the backward, and
// scratch then holds every node's output (without a LayerNorm the last
// node writes y, copied into its scratch buffer).  Returns a cudaError_t, 0
// on success.
extern "C" int nbasr_fused_cell_forward(int bf16, int batch, int t_len, int C, int n_nodes,
                                        const int* desc, const void* const* weights,
                                        const void* const* biases, const void* x, void* scratch,
                                        void* y, const void* ln_scale, const void* ln_shift,
                                        int use_norm, float eps, const void* seed,
                                        unsigned threshold, float inv_keep, int c0,
                                        void* mults, void* stream) {
  if (n_nodes < 1 || n_nodes >= kMaxOutputs || !desc || batch < 0 || t_len < 0 || C < 1 ||
      c0 < 0)
    return cudaErrorInvalidValue;
  static_assert(sizeof(FwdPlan) == gconv::kFwdPlanInts * sizeof(int),
                "FwdPlan is kFwdPlanInts ints");
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<const float*>(ln_scale);
  const auto sh = static_cast<const float*>(ln_shift);
  const auto sd = static_cast<const int*>(seed);
  if (bf16)
    return run<__nv_bfloat16>(batch, t_len, C, n_nodes, desc, weights, biases, x, scratch, y, sc,
                              sh, use_norm, eps, sd, threshold, inv_keep, c0, mults, s);
  return run<float>(batch, t_len, C, n_nodes, desc, weights, biases, x, scratch, y, sc, sh,
                    use_norm, eps, sd, threshold, inv_keep, c0, mults, s);
}

// Resident blocks per SM of the conv node kernel with a plan's register
// tile (kt, ot), threads and shared memory bytes (the fewer of its
// inference and training instantiations), from the CUDA occupancy
// calculator; -1 for a tile that is not instantiated or an error.
extern "C" int nbasr_fused_conv_fwd_blocks_per_sm(int bf16, int kt, int ot, int threads,
                                                  int smem) {
  if (threads < 1 || threads > gconv::kFwdThreads || smem < 0 || smem > 232448) return -1;
  if (bf16)
    return with_conv_tile<__nv_bfloat16>(kt, ot, [&](auto a, auto b) {
      return conv_occupancy<__nv_bfloat16, decltype(a)::value, decltype(b)::value>(threads, smem);
    });
  return with_conv_tile<float>(kt, ot, [&](auto a, auto b) {
    return conv_occupancy<float, decltype(a)::value, decltype(b)::value>(threads, smem);
  });
}

extern "C" const char* nbasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
