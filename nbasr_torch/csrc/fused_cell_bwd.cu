// Backward pass of one SearchCell, for Hopper (sm_90a).
//
// Replaces nbasr_tpu/ops/fused_cell.py::_bwd_kernel, which the JAX package
// reaches through fused_cell_apply's custom VJP (_fused_bwd -> _backward ->
// pl.pallas_call).  The forward kernel (fused_cell.cu) of a training step
// keeps every node output (scratch) and every conv or linear node's
// multiplier (clip-ReLU gate * dropout keep / (1 - p)) in the activation
// dtype, so this kernel recomputes nothing: the TPU kernel recomputes the
// forward only because a cell has to fit one VMEM residency.
//
// What it computes, for x [B, T, C] in f32 or bf16 and dy like x:
//   LayerNorm backward over outs[n_nodes] (two-pass f32 statistics):
//     g[n_nodes] = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * inv,
//     dxhat = dy * scale;  dscale = sum dy * xhat, dbias = sum dy over B, T
//   (without LayerNorm g[n_nodes] = dy); then, for each node n in reverse:
//     g[j] += g[n+1] for each branch j
//     dz = g[n+1] * mult[n]             (f32; a zero node stops here)
//     db = sum of dz over B, T          (f32)
//     dzc = round(dz)                   (activation dtype, as the TPU kernel)
//     conv:   dW[k, i, c] = sum_rows src[t + k*d - lpad, g(c)*ci + i] * dzc[t, c]
//             g[n][t', g*ci + i] += sum_k sum_{c in group g} dzc[t' + lpad - k*d, c] * w[k, i, c]
//     linear: dW = src^T dzc,  g[n] += dzc w^T
//   dx = round(g[0]).  Gradient buffers g are f32 (the TPU kernel's choice:
//   bf16 buffers lose the bias gradients to cancellation); dW is rounded to
//   the activation dtype, the weight operand's, as the JAX VJP returns it.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the tensor
// cores): the function must read x, dy, the n_nodes node outputs and the
// n_nodes multipliers and write dx, (2*n_nodes + 3) passes over [B, T, C]
// in the activation dtype, against 2 * (2*B*T*C*K*ci) conv operations per
// node (dW and dx).  For the flagship cell (three conv5 nodes, ci 6-12) the
// bytes bound it.  This design also moves the f32 gradient buffers: each
// node reads g[n+1] and writes g[n] and its branches, about (3*n_nodes + 3)
// passes in all counting them, and its dW rereads src.
//
// Design (deterministic: no float atomics, one owner and one order of
// summation per output, so two runs give the same bits):
//   LayerNorm: one warp per (b, t) row writes g[n_nodes] and the row's
//     (mean, 1/std); dscale/dbias are a column pass's partial sums.
//   dz:      a column pass: the branch adds, dz into a dzc buffer, db
//            partial sums.
//   Column passes (dz, the LayerNorm's parameters): a block spans kColVec
//     vectors of 4 channels (where C and the operands allow, else one) by
//     kLanes row lanes of one row chunk, up to kChunks chunks of about
//     kChunkRows rows, so the card holds enough loads in flight; the lanes'
//     sums meet in shared memory in lane order, the chunks' in a second
//     pass that gives each output eight lanes of chunks in a fixed order.
//   conv dW and dx: the grouped conv's own kernels (gconv_body.cuh), on src
//     and dzc seen as the dense [B, ci, T, G] view (strides (T*C, 1, C,
//     ci)), planned in Python (nbasr_torch/ops/fused_cell.py, the grouped
//     conv's dw_plan and fwd_plan) and checked again here:
//     - dW: nbasr_gconv_dw, staged tiles and register blocking, one f32
//       partial set per block and a reduce in order, rounded once to the
//       activation dtype (the JAX VJP's rounding points);
//     - dx: the grouped conv's forward body on dzc with the weights staged
//       transposed and tap-reversed and the halo mirrored (rpad on the
//       left), its f32 register sums left in an f32 output tile and stored
//       (g[n] not yet written: no later node names n among its branches)
//       or added (g[n] holds branch adds) into g[n] unrounded, as the JAX
//       kernel adds its f32 acc into g_ref; node 0, when nothing else wrote
//       g[0], rounds its sums straight into dx instead (no g[0], no
//       convert).  Only the g buffers that something adds into first are
//       zeroed.
//   linear:  in bf16 where C % 8 == 0 and src and w lie on 16 bytes (the
//            plan, fused_cell.linear_plans, checked again here), the
//            tensor-core GEMM of linear_mma.cuh: g[n] += dzc w^T with w
//            read K-major, and dW = src^T dzc with both operands read
//            MN-major, its rows split into the plan's chunks so that tiles
//            x chunks fill the SMs, each chunk's f32 partial tile into the
//            workspace and nbasr_linear_dw_reduce summing them in chunk
//            order and rounding once (one chunk: rounded straight into
//            dW); in f32 (and bf16 otherwise) 64x64 shared-memory tiles
//            like the forward's FMA kernel: dW with the whole row
//            reduction in one block per tile, and g[n] += dzc w^T.
// Every launch is checked with cudaGetLastError(); the entry point returns
// the first error and launches nothing after it.

#include "gconv_body.cuh"
#include "linear_mma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

namespace {

using gconv::DwPlan;
using gconv::FwdPlan;
using gconv::Stage;
using gconv::View;

constexpr int kMaxOutputs = 8;     // the cell input and up to 7 nodes
// A node's descriptor: kind, K, d, lpad, ci, co, branch mask, the dx's
// output (kDx*), then a conv node's dW plan and dx plan; a linear node has
// its path (kLinear*) in the dx output's place and dW's row chunks first
// in the dW plan's (zeros otherwise)
constexpr int kDwPlanAt = 8;
constexpr int kDxPlanAt = kDwPlanAt + gconv::kDwPlanInts;
constexpr int kDescInts = kDxPlanAt + gconv::kFwdPlanInts;
constexpr int kConv = 0, kLinear = 1, kZero = 2;
// where a conv node's dx goes: rounded into dx (node 0, g[0] unwritten),
// stored into g[n] (g[n] unwritten), or added into g[n] (branch adds there)
constexpr int kDxOut = 0, kDxStore = 1, kDxAdd = 2;
// a linear node's path: the SIMT kernels or the tensor-core GEMMs
constexpr int kLinearFma = 0, kLinearMma = 1;
constexpr int kThreads = 256;
constexpr int kTile = 64;          // linear: output tile edge
constexpr int kTileK = 16;         // linear: reduction slice per stage
// Row chunks of the column passes' partial sums: up to kChunks, about
// kChunkRows rows each; kLanes row lanes of a block split a chunk's rows.
constexpr int kChunks = 128;
constexpr int kChunkRows = 32;
constexpr int kLanes = 4;
constexpr int kColVec = 64;         // channel vectors a column block spans

__device__ __forceinline__ float load(const float* p, long i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// [first, last) rows of chunk `chunk` of `chunks`.
__device__ __forceinline__ void chunk_rows(long rows, int chunk, int chunks, long* first,
                                           long* last) {
  *first = rows * chunk / chunks;
  *last = rows * (chunk + 1) / chunks;
}

// V consecutive values from p (16 or 8-byte vectors where V = 4) to f32.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(h[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    union {
      __nv_bfloat16 h[4];
      uint2 u;
    } a;
#pragma unroll
    for (int i = 0; i < 4; ++i) a.h[i] = __float2bfloat16_rn(v[i]);
    *reinterpret_cast<uint2*>(p) = a.u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// grid ceil(n / 32), 256 threads: out[e] (e < split; out2[e - split]
// beyond) = the sum over chunks k of part[k * stride + e], rounded to
// OutT.  Lane l of an output's eight sums the chunks l, l + 8, ... in
// order, then lane 0 sums the eight in order: one fixed order.
template <typename OutT>
__global__ void __launch_bounds__(kThreads) nbasr_reduce_chunks(const float* __restrict__ part,
                                                                int chunks, long n, long stride,
                                                                OutT* __restrict__ out, long split,
                                                                OutT* __restrict__ out2) {
  __shared__ float red[8][33];
  const int o = threadIdx.x % 32, lane = threadIdx.x / 32;
  const long e = blockIdx.x * 32L + o;
  float s = 0.0f;
  if (e < n)
#pragma unroll 4
    for (int k = lane; k < chunks; k += 8) s += part[k * stride + e];
  red[lane][o] = s;
  __syncthreads();
  if (lane != 0 || e >= n) return;
  for (int l = 1; l < 8; ++l) s += red[l][o];
  if (e < split)
    store(out, e, s);
  else
    store(out2, e - split, s);
}

// The chunks of a column pass over `rows` rows, and its grid for C channels
// in vectors of V.
int col_chunks(long rows) {
  const long c = (rows + kChunkRows - 1) / kChunkRows;
  return static_cast<int>(c < 1 ? 1 : c > kChunks ? kChunks : c);
}
dim3 col_grid(int C, int V, long rows) {
  return dim3((C / V + kColVec - 1) / kColVec, col_chunks(rows));
}

// The kLanes row lanes' V sums of each of nsums partial sets, summed in
// lane order through shared memory; lane 0 writes them to
// part[(chunk * nsums + s) * C + c0 + i].
template <int V, int S>
__device__ __forceinline__ void write_partials(const float (&sums)[S][V], float* part, int C,
                                               int c0, bool live) {
  __shared__ float red[kLanes][S][kColVec * V];
  const int tx = threadIdx.x, ly = threadIdx.y;
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < V; ++i) red[ly][s][tx * V + i] = sums[s][i];
  __syncthreads();
  if (ly != 0 || !live) return;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] = red[0][s][tx * V + i];
      for (int l = 1; l < kLanes; ++l) v[i] += red[l][s][tx * V + i];
    }
    store_vec<V>(part + (static_cast<long>(blockIdx.y) * S + s) * C + c0, v);
  }
}

template <typename SrcT, typename DstT>
__global__ void __launch_bounds__(kThreads) nbasr_convert(const SrcT* __restrict__ src,
                                                          DstT* __restrict__ dst, long n) {
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x)
    store(dst, i, load(src, i));
}

// One warp per row: g = LayerNorm backward of dy, and the row's (mean, inv).
template <typename T>
__global__ void __launch_bounds__(kThreads) nbasr_ln_backward_rows(
    const T* __restrict__ xn, const T* __restrict__ dy, const float* __restrict__ scale,
    float* __restrict__ g, float* __restrict__ stats, long rows, int C, float eps) {
  const long r = static_cast<long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* x = xn + r * C;
  const T* d = dy + r * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += load(x, c);
  const float mu = warp_sum(s) / C;
  float v = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float dv = load(x, c) - mu;
    v += dv * dv;
  }
  const float inv = rsqrtf(warp_sum(v) / C + eps);
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float dxhat = load(d, c) * scale[c];
    s1 += dxhat;
    s2 += dxhat * ((load(x, c) - mu) * inv);
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
  float* gr = g + r * C;
  for (int c = lane; c < C; c += 32) {
    const float xhat = (load(x, c) - mu) * inv;
    gr[c] = (load(d, c) * scale[c] - m1 - xhat * m2) * inv;
  }
  if (lane == 0) {
    stats[2 * r] = mu;
    stats[2 * r + 1] = inv;
  }
}

// col_grid(C, V, rows), (kColVec, kLanes) threads: thread (x, y) owns the
// V channels from c0 = V * (blockIdx.x * kColVec + x) and the rows y, y +
// kLanes, ... of row chunk blockIdx.y; partial sums of dy * xhat and dy
// into part[chunk][0 | 1][c].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) nbasr_ln_param_partials(
    const T* __restrict__ xn, const T* __restrict__ dy, const float* __restrict__ stats,
    float* __restrict__ part, long rows, int C) {
  const int c0 = V * (blockIdx.x * kColVec + threadIdx.x);
  const bool live = c0 < C;
  long first, last;
  chunk_rows(rows, blockIdx.y, gridDim.y, &first, &last);
  float sums[2][V] = {};
  if (live) {
#pragma unroll 2
    for (long r = first + threadIdx.y; r < last; r += kLanes) {
      float d[V], x[V];
      load_vec<V>(dy + r * C + c0, d);
      load_vec<V>(xn + r * C + c0, x);
      const float mu = stats[2 * r], inv = stats[2 * r + 1];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sums[0][i] += d[i] * ((x[i] - mu) * inv);
        sums[1][i] += d[i];
      }
    }
  }
  write_partials<V, 2>(sums, part, C, c0, live);
}

// col_grid(C, V, rows), (kColVec, kLanes) threads, as
// nbasr_ln_param_partials: node n's branch adds g[j] += g[n+1] (buffer j at
// g + j * gstride) and, for a conv or linear node (mult != null), dz =
// g[n+1] * mult rounded into dzc, with db partial sums into part[chunk][c].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) nbasr_node_dz(
    const float* __restrict__ gout, const T* __restrict__ mult, T* __restrict__ dzc,
    float* __restrict__ part, float* __restrict__ g, long gstride, unsigned branches, long rows,
    int C) {
  const int c0 = V * (blockIdx.x * kColVec + threadIdx.x);
  const bool live = c0 < C;
  long first, last;
  chunk_rows(rows, blockIdx.y, gridDim.y, &first, &last);
  float db[1][V] = {};
  if (live) {
#pragma unroll 2
    for (long r = first + threadIdx.y; r < last; r += kLanes) {
      const long idx = r * C + c0;
      float dt[V];
      load_vec<V>(gout + idx, dt);
#pragma unroll
      for (int j = 0; j < kMaxOutputs; ++j) {
        if (!(branches >> j & 1u)) continue;
        float a[V];
        load_vec<V>(g + j * gstride + idx, a);
#pragma unroll
        for (int i = 0; i < V; ++i) a[i] += dt[i];
        store_vec<V>(g + j * gstride + idx, a);
      }
      if (mult) {
        float m[V];
        load_vec<V>(mult + idx, m);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          m[i] *= dt[i];
          db[0][i] += m[i];
        }
        store_vec<V>(dzc + idx, m);
      }
    }
  }
  if (mult) write_partials<V, 1>(db, part, C, c0, live);
}

// grid (ceil(C / 64) over c, ceil(C / 64) over i); 256 threads as 16 x 16,
// thread owns rows i = ty*4 + a and columns c = tx + 16*b of the tile;
// dW[i, c] = sum over all rows of src[r, i] * dzc[r, c].
template <typename T>
__global__ void __launch_bounds__(kThreads) nbasr_linear_dw(const T* __restrict__ src,
                                                            const T* __restrict__ dzc,
                                                            T* __restrict__ dw, long rows,
                                                            int C) {
  __shared__ float a_tile[kTileK][kTile + 1];  // [row][i]
  __shared__ float b_tile[kTileK][kTile];      // [row][c]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  for (long r0 = 0; r0 < rows; r0 += kTileK) {
    for (int e = threadIdx.x; e < kTile * kTileK; e += kThreads) {
      const int rr = e / kTile, cc = e % kTile;
      const long r = r0 + rr;
      a_tile[rr][cc] = (r < rows && i0 + cc < C) ? load(src, r * C + i0 + cc) : 0.0f;
      b_tile[rr][cc] = (r < rows && c0 + cc < C) ? load(dzc, r * C + c0 + cc) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) a[p] = a_tile[kk][ty * 4 + p];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = b_tile[kk][tx + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] += a[p] * b[q];
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty * 4 + p;
    if (i >= C) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx + 16 * q;
      if (c < C) store(dw, static_cast<long>(i) * C + c, acc[p][q]);
    }
  }
}

// grid (ceil(C / 64) over i, ceil(rows / 64)); the forward's tiling with the
// weight read transposed: g[r, i] += sum_c dzc[r, c] * w[i, c].
template <typename T>
__global__ void __launch_bounds__(kThreads) nbasr_linear_dx(const T* __restrict__ dzc,
                                                            const T* __restrict__ w,
                                                            float* __restrict__ g, long rows,
                                                            int C) {
  __shared__ float a_tile[kTileK][kTile + 1];  // [c][row]
  __shared__ float w_tile[kTileK][kTile + 1];  // [c][i]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long row0 = static_cast<long>(blockIdx.y) * kTile;
  const int col0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < C; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTile * kTileK; e += kThreads) {
      const int rr = e / kTileK, kk = e % kTileK;
      const long r = row0 + rr;
      const int k = k0 + kk, col = col0 + rr;
      a_tile[kk][rr] = (r < rows && k < C) ? load(dzc, r * C + k) : 0.0f;
      w_tile[kk][rr] = (col < C && k < C) ? load(w, static_cast<long>(col) * C + k) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) a[p] = a_tile[kk][ty * 4 + p];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = w_tile[kk][tx + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] += a[p] * b[q];
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long r = row0 + ty * 4 + p;
    if (r >= rows) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = col0 + tx + 16 * q;
      if (col < C) g[r * C + col] += acc[p][q];
    }
  }
}

// The tensor-core dx's epilogue: the staged f32 sums added into the
// gradient buffer g [rows, C] unrounded, 4-float vectors, eight rows of
// them a thread with their loads in flight together (sixteen spilled).
struct LinearDxEpilogue {
  float* g;
  int C;
  __device__ __forceinline__ void tile(const float* s, long long m0, int n0, long long M,
                                       int N) const {
    constexpr int kP = 8;
    lmma::tile_pass<4, kP>(s, m0, n0, M, N, [&](const auto& sv, const auto& r, int c,
                                                const auto& live) {
      float4 v[kP];
#pragma unroll
      for (int q = 0; q < kP; ++q)
        if (live[q]) v[q] = *reinterpret_cast<const float4*>(g + r[q] * C + c);
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        if (!live[q]) continue;
        const float4 a = *reinterpret_cast<const float4*>(sv[q]);
        v[q].x += a.x;
        v[q].y += a.y;
        v[q].z += a.z;
        v[q].w += a.w;
        *reinterpret_cast<float4*>(g + r[q] * C + c) = v[q];
      }
    });
  }
};

// The tensor-core dW's epilogue at dW[i, c], 4-float vectors: with one
// row chunk the sums rounded once into dw, else row chunk blockIdx.y's
// f32 partial tile into part [chunks, C, C] for nbasr_linear_dw_reduce.
struct LinearDwEpilogue {
  __nv_bfloat16* dw;
  float* part;
  int C;
  __device__ __forceinline__ void tile(const float* s, long long m0, int n0, long long M,
                                       int N) const {
    lmma::tile_pass<4, 4>(s, m0, n0, M, N, [&](const auto& sv, const auto& r, int c,
                                               const auto& live) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!live[q]) continue;
        const long long e = r[q] * C + c;
        const float4 a = *reinterpret_cast<const float4*>(sv[q]);
        if (gridDim.y == 1) {
          const float v[4] = {a.x, a.y, a.z, a.w};
          store_vec<4>(dw + e, v);
        } else {
          *reinterpret_cast<float4*>(part + blockIdx.y * static_cast<long long>(C) * C + e) = a;
        }
      }
    });
  }
};

// dw [n] = the sum of part [chunks, n] over the chunks in order, rounded
// once; 4 outputs a thread (n % 4 == 0).
__global__ void __launch_bounds__(kThreads) nbasr_linear_dw_reduce(const float* __restrict__ part,
                                                                   int chunks, long n,
                                                                   __nv_bfloat16* __restrict__ dw) {
  for (long i = 4 * (blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x); i < n;
       i += 4L * gridDim.x * blockDim.x) {
    float4 s = *reinterpret_cast<const float4*>(part + i);
    for (int k = 1; k < chunks; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(part + k * n + i);
      s.x += a.x;
      s.y += a.y;
      s.z += a.z;
      s.w += a.w;
    }
    const float v[4] = {s.x, s.y, s.z, s.w};
    store_vec<4>(dw + i, v);
  }
}

// g[n] += dzc w^T on the tensor cores: dzc [rows, C] and w [C, C] (i, c)
// both read K-major.
__global__ void __launch_bounds__(lmma::kThreads, 2)
    nbasr_linear_dx_mma(const __grid_constant__ CUtensorMap dzc, const __grid_constant__ CUtensorMap w,
                        long long rows, int C, int k_tiles,
                        const __grid_constant__ LinearDxEpilogue epi) {
  lmma::gemm_tile<false, false>(dzc, w, rows, C, k_tiles, epi);
}

// dW = src^T dzc on the tensor cores, row chunk blockIdx.y: src [rows, C]
// (r, i) and dzc [rows, C] (r, c) both read MN-major.
__global__ void __launch_bounds__(lmma::kThreads, 2)
    nbasr_linear_dw_mma(const __grid_constant__ CUtensorMap src, const __grid_constant__ CUtensorMap dzc,
                        long long C_rows, int C, int k_tiles,
                        const __grid_constant__ LinearDwEpilogue epi) {
  lmma::gemm_tile<true, true>(src, dzc, C_rows, C, k_tiles, epi);
}

// The fused backward's conv dx: grouped_conv.cu's nbasr_gconv_dx (the
// forward's body on dz, weights staged transposed and tap-reversed, halo
// mirrored) with the output in Y: T rounds the f32 sums into dx, f32 stores
// (kAdd false) or adds (kAdd true) them into a gradient buffer unrounded.
template <typename T, int KT, int OT, typename Y, bool kAdd>
__global__ void __launch_bounds__(gconv::kFwdThreads)
    nbasr_fused_conv_dx(const T* __restrict__ dz, Stage zs, const T* __restrict__ w,
                        Y* __restrict__ dx, Stage xs, FwdPlan p, int batch, int t_len, int groups,
                        int ci, int co, int K, int d, int rpad) {
  gconv::conv_units<T, KT, gconv::kFwdRt, OT, false, true, Y, kAdd>(
      dz, zs, w, nullptr, dx, xs, p, batch, t_len, groups, co, ci, K, d, rpad);
}

unsigned blocks_for(long n, int threads = kThreads) {
  const long b = (n + threads - 1) / threads;
  return static_cast<unsigned>(b < 8192 ? b : 8192);
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

// The workspace, in floats from its start, every buffer on 16 bytes (the
// plans' vectors count on it): g [n_nodes + 1] buffers of gstride floats,
// row stats [rows, 2], the dzc buffer [B, T, C] (activation dtype), the
// db/LayerNorm partials [kChunks, 2, C] and the conv dW partials of the
// widest conv node's plan (chunks * K * ci * C, none for one chunk).
struct Work {
  long long gstride, stats, dzc, part, part_dw, total;
};

Work work_layout(int batch, int t_len, int C, int n_nodes, const int* desc) {
  const long long rows = static_cast<long long>(batch) * t_len, numel = rows * C;
  Work w;
  w.gstride = round4(numel);
  w.stats = (n_nodes + 1) * w.gstride;
  w.dzc = w.stats + round4(2 * rows);
  w.part = w.dzc + round4(numel);
  w.part_dw = w.part + round4(kChunks * 2LL * C);
  long long dw = 0;
  for (int n = 0; n < n_nodes; ++n) {
    const int* nd = desc + n * kDescInts;
    DwPlan p;
    std::memcpy(&p, nd + kDwPlanAt, sizeof(p));
    const long long need = static_cast<long long>(p.chunks) * nd[1] * nd[4] * C;
    if (nd[0] == kConv && p.chunks > 1 && need > dw) dw = need;
    // a tensor-core dW's partial tiles: chunks x [C, C]
    const long long lin = static_cast<long long>(nd[kDwPlanAt]) * C * C;
    if (nd[0] == kLinear && nd[7] == kLinearMma && nd[kDwPlanAt] > 1 && lin > dw) dw = lin;
  }
  w.total = w.part_dw + round4(dw);
  return w;
}

// A dense [B, T, C] tensor of nch-channel groups as the [B, c, T, G] view.
View dense(int t_len, int C, int nch) {
  return View{static_cast<long long>(t_len) * C, 1, C, nch};
}

// g[n] (or dx) from dzc through the conv node's weights, as `mode` says,
// on the plan Python made (fwd_plan of the conv on dz), checked again.
template <typename T>
int conv_dx(int mode, int batch, int t_len, int C, int ci, int K, int d, int lpad, const T* dzc,
            const T* w, void* out, const FwdPlan& p, cudaStream_t s) {
  const int groups = C / ci;  // a cell's conv keeps the width: co = ci
  const int ysize = mode == kDxOut ? sizeof(T) : sizeof(float);
  if (gconv::bad_fwd_plan(p, sizeof(T), ysize, batch, t_len, groups, ci, ci, K, d))
    return cudaErrorInvalidValue;
  const Stage zs{dense(t_len, C, ci), ci, p.x_mode, p.x_vec};
  const Stage xs{dense(t_len, C, ci), ci, p.y_mode, p.y_vec};
  if (!gconv::stage_fits(zs, sizeof(T)) || !gconv::stage_fits(xs, ysize))
    return cudaErrorInvalidValue;
  const int rpad = (K - 1) * d - lpad;
  const int err = gconv::with_fwd_tile<T>(p.kt, p.ot, [&](auto kt, auto ot) {
    constexpr int KT = decltype(kt)::value, OT = decltype(ot)::value;
    if (mode == kDxOut)
      return gconv::launch_units(nbasr_fused_conv_dx<T, KT, OT, T, false>, p, batch, s, dzc, zs, w,
                                 static_cast<T*>(out), xs, p, batch, t_len, groups, ci, ci, K, d,
                                 rpad);
    if (mode == kDxAdd)
      return gconv::launch_units(nbasr_fused_conv_dx<T, KT, OT, float, true>, p, batch, s, dzc, zs,
                                 w, static_cast<float*>(out), xs, p, batch, t_len, groups, ci, ci,
                                 K, d, rpad);
    return gconv::launch_units(nbasr_fused_conv_dx<T, KT, OT, float, false>, p, batch, s, dzc, zs,
                               w, static_cast<float*>(out), xs, p, batch, t_len, groups, ci, ci, K,
                               d, rpad);
  });
  return err < 0 ? cudaErrorInvalidValue : err;
}

template <typename T>
int run_backward(int batch, int t_len, int C, int n_nodes, const int* desc,
                 const void* const* weights, const T* x, const T* outs, const T* mults,
                 const T* dy, const float* ln_scale, int use_norm, float eps, T* dx,
                 void* const* dweights, void* const* dbiases, float* dscale, float* dshift,
                 float* work, cudaStream_t stream) {
  const long rows = static_cast<long>(batch) * t_len;
  const long numel = rows * C;
  const Work wl = work_layout(batch, t_len, C, n_nodes, desc);
  float* const g = work;
  const auto gbuf = [&](int k) { return g + k * wl.gstride; };
  float* stats = work + wl.stats;
  T* dzc = reinterpret_cast<T*>(work + wl.dzc);
  float* part = work + wl.part;
  float* part_dw = work + wl.part_dw;
  const T* in[kMaxOutputs];
  in[0] = x;
  for (int n = 0; n < n_nodes; ++n) in[n + 1] = outs + n * numel;
  // the column passes: 4-channel vectors where C and the operands allow
  // (the workspace's buffers lie on 16 bytes), else one channel a thread
  const auto on = [](const void* p, unsigned long long bytes) {
    return reinterpret_cast<unsigned long long>(p) % bytes == 0;
  };
  const bool v4 = C % 4 == 0 && on(outs, 4 * sizeof(T)) && on(mults, 4 * sizeof(T)) &&
                  on(dy, 4 * sizeof(T));
  const int chunks = col_chunks(rows);
  const dim3 cols(kColVec, kLanes);
  const dim3 grid_cols = col_grid(C, v4 ? 4 : 1, rows);

  // The outputs some node's branch adds reach (node m names only j <= m, so
  // they reach g[j] before node j's own dx).  Each conv node's dx output
  // must be the one this gives; nothing launches before every node passed.
  unsigned named = 0;
  for (int n = 0; n < n_nodes; ++n) named |= static_cast<unsigned>(desc[n * kDescInts + 6]);
  for (int n = 0; n < n_nodes; ++n) {
    const int* nd = desc + n * kDescInts;
    if (nd[0] != kConv && nd[0] != kLinear && nd[0] != kZero) return cudaErrorInvalidValue;
    if (nd[0] == kLinear) {
      if (nd[7] == kLinearFma) continue;
      // the tensor-core path: bf16, TMA's 16-byte operands and rows of 8
      // elements, at least one k tile of rows a chunk
      const long long k_tiles = (rows + lmma::kBK - 1) / lmma::kBK;
      if (nd[7] != kLinearMma || !std::is_same_v<T, __nv_bfloat16> || C % 8 != 0 ||
          !on(in[n], 16) || !on(weights[n], 16) || !on(dweights[n], 16) || nd[kDwPlanAt] < 1 ||
          nd[kDwPlanAt] > k_tiles)
        return cudaErrorInvalidValue;
      continue;
    }
    if (nd[0] != kConv) continue;
    const int want = named >> n & 1u ? kDxAdd : n == 0 ? kDxOut : kDxStore;
    if (nd[7] != want || nd[4] < 1 || nd[4] != nd[5] || C % nd[4] != 0)
      return cudaErrorInvalidValue;
  }
  const bool dx_direct = desc[0] == kConv && desc[7] == kDxOut;
  cudaError_t err;
#define NBASR_CHECK()                                           \
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // zero the buffers something adds into before anything stores there:
  // branch targets, and a linear or zero node's input (its dx adds, or
  // nothing writes it and the node before reads it)
  for (int k = 0; k < n_nodes; ++k) {
    if (k == 0 && dx_direct) continue;
    if ((named >> k & 1u) || desc[k * kDescInts] != kConv)
      if ((err = cudaMemsetAsync(gbuf(k), 0, sizeof(float) * numel, stream)) != cudaSuccess)
        return err;
  }
  float* g_last = gbuf(n_nodes);
  if (use_norm) {
    const long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    nbasr_ln_backward_rows<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        in[n_nodes], dy, ln_scale, g_last, stats, rows, C, eps);
    NBASR_CHECK();
    if (v4)
      nbasr_ln_param_partials<T, 4><<<grid_cols, cols, 0, stream>>>(in[n_nodes], dy, stats, part,
                                                                    rows, C);
    else
      nbasr_ln_param_partials<T, 1><<<grid_cols, cols, 0, stream>>>(in[n_nodes], dy, stats, part,
                                                                    rows, C);
    NBASR_CHECK();
    nbasr_reduce_chunks<float><<<static_cast<unsigned>((2L * C + 31) / 32), kThreads, 0, stream>>>(
        part, chunks, 2L * C, 2L * C, dscale, C, dshift);
    NBASR_CHECK();
  } else {
    nbasr_convert<T, float><<<blocks_for(numel), kThreads, 0, stream>>>(dy, g_last, numel);
    NBASR_CHECK();
  }

  for (int n = n_nodes - 1; n >= 0; --n) {
    const int* nd = desc + n * kDescInts;
    const unsigned branches = static_cast<unsigned>(nd[6]);
    const bool zero = nd[0] == kZero;
    if (zero && !branches) continue;
    const T* mult = zero ? nullptr : mults + n * numel;
    if (v4)
      nbasr_node_dz<T, 4><<<grid_cols, cols, 0, stream>>>(gbuf(n + 1), mult, dzc, part, g,
                                                          wl.gstride, branches, rows, C);
    else
      nbasr_node_dz<T, 1><<<grid_cols, cols, 0, stream>>>(gbuf(n + 1), mult, dzc, part, g,
                                                          wl.gstride, branches, rows, C);
    NBASR_CHECK();
    if (zero) continue;
    float* db = static_cast<float*>(dbiases[n]);
    nbasr_reduce_chunks<float><<<static_cast<unsigned>((C + 31) / 32), kThreads, 0, stream>>>(
        part, chunks, C, C, db, C, db);
    NBASR_CHECK();
    const T* w = static_cast<const T*>(weights[n]);
    T* dw = static_cast<T*>(dweights[n]);
    if (nd[0] == kConv) {
      const int K = nd[1], d = nd[2], lpad = nd[3], ci = nd[4];
      DwPlan dwp;
      FwdPlan dxp;
      std::memcpy(&dwp, nd + kDwPlanAt, sizeof(dwp));
      std::memcpy(&dxp, nd + kDxPlanAt, sizeof(dxp));
      int e = gconv::weight_grad<T>(batch, t_len, C / ci, ci, ci, K, d, lpad, in[n],
                                    dense(t_len, C, ci), dzc, dense(t_len, C, ci), dw, part_dw,
                                    dwp, stream);
      if (e != cudaSuccess) return e;
      void* out = nd[7] == kDxOut ? static_cast<void*>(dx) : static_cast<void*>(gbuf(n));
      e = conv_dx<T>(nd[7], batch, t_len, C, ci, K, d, lpad, dzc, w, out, dxp, stream);
      if (e != cudaSuccess) return e;
    } else if (nd[7] == kLinearMma) {
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        const int chunks = nd[kDwPlanAt];
        int e = lmma::launch<true, true>(nbasr_linear_dw_mma, in[n], dzc, C, C, rows, chunks,
                                         LinearDwEpilogue{dw, part_dw, C}, stream);
        if (e != cudaSuccess) return e;
        if (chunks > 1) {
          const long cc = static_cast<long>(C) * C;
          nbasr_linear_dw_reduce<<<blocks_for(cc / 4), kThreads, 0, stream>>>(part_dw, chunks, cc,
                                                                            dw);
          NBASR_CHECK();
        }
        e = lmma::launch<false, false>(nbasr_linear_dx_mma, dzc, w, rows, C, C, 1,
                                       LinearDxEpilogue{gbuf(n), C}, stream);
        if (e != cudaSuccess) return e;
      } else {
        return cudaErrorInvalidValue;
      }
    } else {
      const dim3 dw_grid((C + kTile - 1) / kTile, (C + kTile - 1) / kTile);
      nbasr_linear_dw<T><<<dw_grid, kThreads, 0, stream>>>(in[n], dzc, dw, rows, C);
      NBASR_CHECK();
      const dim3 dx_grid((C + kTile - 1) / kTile,
                         static_cast<unsigned>((rows + kTile - 1) / kTile));
      nbasr_linear_dx<T><<<dx_grid, kThreads, 0, stream>>>(dzc, w, gbuf(n), rows, C);
      NBASR_CHECK();
    }
  }
  if (!dx_direct) {
    nbasr_convert<float, T><<<blocks_for(numel), kThreads, 0, stream>>>(gbuf(0), dx, numel);
    NBASR_CHECK();
  }
#undef NBASR_CHECK
  return cudaSuccess;
}

// The fewer resident blocks per SM of the dx kernel's instances for one
// output (T, or f32 stored and added).
template <typename T, int KT, int OT>
int dx_occupancy(int f32_out, int threads, int smem) {
  if (!f32_out)
    return gconv::occupancy(nbasr_fused_conv_dx<T, KT, OT, T, false>, threads, smem);
  const int store = gconv::occupancy(nbasr_fused_conv_dx<T, KT, OT, float, false>, threads, smem);
  const int add = gconv::occupancy(nbasr_fused_conv_dx<T, KT, OT, float, true>, threads, smem);
  return store < add ? store : add;
}

}  // namespace

// Floats of f32 workspace nbasr_fused_cell_backward needs for this cell
// (desc as nbasr_fused_cell_backward takes it).
extern "C" long long nbasr_fused_cell_backward_workspace(int batch, int t_len, int C, int n_nodes,
                                                         const int* desc) {
  if (n_nodes < 1 || n_nodes >= kMaxOutputs) return -1;
  return work_layout(batch, t_len, C, n_nodes, desc).total;
}

// Backward of one cell on `stream`.  desc: kDescInts ints per node (the
// forward's seven, then where a conv node's dx goes, its dW plan, dw_plan's
// DW_PLAN_FIELDS, and its dx plan, fwd_plan's FWD_PLAN_FIELDS for the conv
// on dz; a linear node's path and dW row chunks, fused_cell.linear_plans,
// then zeros); weights as the forward's; outs and mults are what the training
// forward kept ([n_nodes, B, T, C], activation dtype); dy like x.  Writes
// dx (activation dtype), dweights[n] (activation dtype, the weight's shape)
// and dbiases[n] (f32 [C]) for each conv or linear node, and dscale/dshift
// (f32 [C]) with LayerNorm.  work holds nbasr_fused_cell_backward_workspace
// floats, on 16 bytes.  Returns a cudaError_t, 0 on success.
extern "C" int nbasr_fused_cell_backward(int bf16, int batch, int t_len, int C, int n_nodes,
                                         const int* desc, const void* const* weights,
                                         const void* x, const void* outs, const void* mults,
                                         const void* dy, const void* ln_scale, int use_norm,
                                         float eps, void* dx, void* const* dweights,
                                         void* const* dbiases, void* dscale, void* dshift,
                                         void* work, void* stream) {
  if (n_nodes < 1 || n_nodes >= kMaxOutputs || !desc ||
      reinterpret_cast<unsigned long long>(work) % 16 != 0)
    return cudaErrorInvalidValue;
  static_assert(sizeof(DwPlan) == gconv::kDwPlanInts * sizeof(int), "DwPlan is kDwPlanInts ints");
  static_assert(sizeof(FwdPlan) == gconv::kFwdPlanInts * sizeof(int),
                "FwdPlan is kFwdPlanInts ints");
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<const float*>(ln_scale);
  const auto ds = static_cast<float*>(dscale);
  const auto dh = static_cast<float*>(dshift);
  const auto wk = static_cast<float*>(work);
  if (bf16) {
    using T = __nv_bfloat16;
    return run_backward<T>(batch, t_len, C, n_nodes, desc, weights, static_cast<const T*>(x),
                           static_cast<const T*>(outs), static_cast<const T*>(mults),
                           static_cast<const T*>(dy), sc, use_norm, eps, static_cast<T*>(dx),
                           dweights, dbiases, ds, dh, wk, s);
  }
  return run_backward<float>(batch, t_len, C, n_nodes, desc, weights,
                             static_cast<const float*>(x), static_cast<const float*>(outs),
                             static_cast<const float*>(mults), static_cast<const float*>(dy), sc,
                             use_norm, eps, static_cast<float*>(dx), dweights, dbiases, ds, dh,
                             wk, s);
}

// Resident blocks per SM of the conv dx kernel with a plan's register tile
// (kt, ot), threads and shared memory bytes, for an output in the
// activation dtype (f32_out 0) or f32 (the fewer of store and add), from
// the CUDA occupancy calculator; -1 for a tile that is not instantiated or
// an error.
extern "C" int nbasr_fused_conv_dx_blocks_per_sm(int bf16, int f32_out, int kt, int ot,
                                                 int threads, int smem) {
  if (threads < 1 || threads > gconv::kFwdThreads || smem < 0 || smem > 232448) return -1;
  if (bf16)
    return gconv::with_fwd_tile<__nv_bfloat16>(kt, ot, [&](auto a, auto b) {
      return dx_occupancy<__nv_bfloat16, decltype(a)::value, decltype(b)::value>(f32_out, threads,
                                                                                 smem);
    });
  return gconv::with_fwd_tile<float>(kt, ot, [&](auto a, auto b) {
    return dx_occupancy<float, decltype(a)::value, decltype(b)::value>(f32_out, threads, smem);
  });
}

// The same for the conv dW kernel (this library's nbasr_gconv_dw).
extern "C" int nbasr_fused_conv_dw_blocks_per_sm(int bf16, int kt, int ot, int threads,
                                                 int smem) {
  if (threads < 1 || threads > gconv::kDwThreads || smem < 0 || smem > 232448) return -1;
  if (bf16)
    return gconv::with_tile<__nv_bfloat16>(kt, ot, [&](auto a, auto b) {
      return gconv::occupancy(
          gconv::nbasr_gconv_dw<__nv_bfloat16, decltype(a)::value, decltype(b)::value>, threads,
          smem);
    });
  return gconv::with_tile<float>(kt, ot, [&](auto a, auto b) {
    return gconv::occupancy(gconv::nbasr_gconv_dw<float, decltype(a)::value, decltype(b)::value>,
                            threads, smem);
  });
}

extern "C" const char* nbasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
