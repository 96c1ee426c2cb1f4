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
// node reads g[n+1] and adds into g[n] and its branches, about
// (3*n_nodes + 3) passes in all counting them, and it rereads src for dW.
//
// Design (simple and deterministic first; no float atomics, so two runs
// give the same bits and a card-against-CPU check does not wander):
//   LayerNorm: one warp per (b, t) row writes g[n_nodes] and the row's
//     (mean, 1/std); dscale/dbias are partial sums over kChunks row chunks,
//     one thread per channel, then a second pass sums the chunks in order.
//   dz:      one thread per channel walks a row chunk: the branch adds, dz
//            into a dzc buffer, db partial sums (then the chunk reduction).
//   conv dW: one thread per (channel c, tap k, slice of at most kMaxCi input
//            channels) walks a row chunk holding the slice's partial sums in
//            registers, so a group of any width runs (ci = 24 at 50 groups
//            of C = 1200 takes two slices); then the chunk reduction, rounded.
//   conv dx: the gather form (taps flipped), one thread per input element,
//            K*co FMAs read through L1, added into g[n].
//   linear:  64x64 shared-memory tiles like the forward's: dW = src^T dzc
//            with the whole row reduction in one block per tile, and
//            g[n] += dzc w^T.
// Every launch is checked with cudaGetLastError(); the entry point returns
// the first error and launches nothing after it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOutputs = 8;     // the cell input and up to 7 nodes
constexpr int kDescInts = 7;       // kind, K, d, lpad, ci, co, branch mask
constexpr int kConv = 0, kLinear = 1, kZero = 2;
constexpr int kThreads = 256;
constexpr int kDwThreads = 128;
constexpr int kTile = 64;          // linear: output tile edge
constexpr int kTileK = 16;         // linear: reduction slice per stage
constexpr long kMaxGridY = 65535;
constexpr int kChunks = 64;        // row chunks of the partial sums
constexpr int kMaxCi = 16;         // input channels a dW thread sums at once (wider: slices)

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

// out[e] = sum over chunks k (in order) of part[k * stride + e], rounded to OutT.
template <typename OutT>
__global__ void __launch_bounds__(kThreads) nbasr_reduce_chunks(const float* __restrict__ part,
                                                                int chunks, long n, long stride,
                                                                OutT* __restrict__ out) {
  for (long e = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < chunks; ++k) s += part[k * stride + e];
    store(out, e, s);
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

// grid (ceil(C / kThreads), kChunks): partial sums of dy * xhat and dy over
// a row chunk, into part[chunk][0 | 1][c].
template <typename T>
__global__ void __launch_bounds__(kThreads) nbasr_ln_param_partials(
    const T* __restrict__ xn, const T* __restrict__ dy, const float* __restrict__ stats,
    float* __restrict__ part, long rows, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  long first, last;
  chunk_rows(rows, blockIdx.y, gridDim.y, &first, &last);
  float ds = 0.0f, db = 0.0f;
  for (long r = first; r < last; ++r) {
    const float d = load(dy, r * C + c);
    ds += d * ((load(xn, r * C + c) - stats[2 * r]) * stats[2 * r + 1]);
    db += d;
  }
  part[(2L * blockIdx.y) * C + c] = ds;
  part[(2L * blockIdx.y + 1) * C + c] = db;
}

// grid (ceil(C / kThreads), kChunks): node n's branch adds g[j] += g[n+1]
// and, for a conv or linear node (mult != null), dz = g[n+1] * mult rounded
// into dzc, with db partial sums into part[chunk][c].
template <typename T>
__global__ void __launch_bounds__(kThreads) nbasr_node_dz(
    const float* __restrict__ gout, const T* __restrict__ mult, T* __restrict__ dzc,
    float* __restrict__ part, float* __restrict__ g, long numel, unsigned branches, long rows,
    int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  long first, last;
  chunk_rows(rows, blockIdx.y, gridDim.y, &first, &last);
  float db = 0.0f;
  for (long r = first; r < last; ++r) {
    const long idx = r * C + c;
    const float dt = gout[idx];
#pragma unroll
    for (int j = 0; j < kMaxOutputs; ++j)
      if (branches >> j & 1u) g[j * numel + idx] += dt;
    if (mult) {
      const float dz = dt * load(mult, idx);
      db += dz;
      store(dzc, idx, dz);
    }
  }
  if (mult) part[static_cast<long>(blockIdx.y) * C + c] = db;
}

// grid (ceil(C / kDwThreads), kChunks, K * ceil(ci / kMaxCi)): thread =
// output channel c at tap k and input slice [i0, i0 + kMaxCi) of its group
// (blockIdx.z = k * slices + i0 / kMaxCi); partial sums over a row chunk
// into part[chunk][k][i][c] (the [K, ci, C] layout per chunk).  A group of
// any width runs, in slices of at most kMaxCi register sums.
template <typename T>
__global__ void __launch_bounds__(kDwThreads) nbasr_conv_dw_partials(
    const T* __restrict__ src, const T* __restrict__ dzc, float* __restrict__ part, long rows,
    int t_len, int C, int ci, int co, int K, int d, int lpad) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int slices = (ci + kMaxCi - 1) / kMaxCi;
  const int k = blockIdx.z / slices;
  const int i0 = (blockIdx.z % slices) * kMaxCi;
  const int width = ci - i0 < kMaxCi ? ci - i0 : kMaxCi;
  const int in0 = (c / co) * ci + i0;
  long first, last;
  chunk_rows(rows, blockIdx.y, gridDim.y, &first, &last);
  float acc[kMaxCi];
#pragma unroll
  for (int i = 0; i < kMaxCi; ++i) acc[i] = 0.0f;
  for (long r = first; r < last; ++r) {
    const int t = static_cast<int>(r % t_len);
    const int ts = t + k * d - lpad;
    if (ts < 0 || ts >= t_len) continue;
    const float dz = load(dzc, r * C + c);
    const T* xs = src + (r - t + ts) * C + in0;
#pragma unroll
    for (int i = 0; i < kMaxCi; ++i)
      if (i < width) acc[i] += load(xs, i) * dz;
  }
  float* out = part + ((static_cast<long>(blockIdx.y) * K + k) * ci + i0) * C + c;
#pragma unroll
  for (int i = 0; i < kMaxCi; ++i)
    if (i < width) out[static_cast<long>(i) * C] = acc[i];
}

// grid (ceil(C / kThreads), min(rows, 65535)); thread = input channel, block
// row loop: g[n] += the conv's input gradient, gathered with flipped taps.
template <typename T>
__global__ void __launch_bounds__(kThreads) nbasr_conv_dx(
    const T* __restrict__ dzc, const T* __restrict__ w, float* __restrict__ g, long rows,
    int t_len, int C, int ci, int co, int K, int d, int lpad) {
  const int cin = blockIdx.x * blockDim.x + threadIdx.x;
  if (cin >= C) return;
  const int grp = cin / ci;
  const int i = cin - grp * ci;
  const int c0 = grp * co;
  for (long r = blockIdx.y; r < rows; r += gridDim.y) {
    const int t = static_cast<int>(r % t_len);
    const long first = r - t;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int tz = t + lpad - k * d;
      if (tz < 0 || tz >= t_len) continue;
      const T* dz = dzc + (first + tz) * C + c0;
      const T* wk = w + (static_cast<long>(k) * ci + i) * C + c0;
      float part = 0.0f;
      for (int o = 0; o < co; ++o) part += load(dz, o) * load(wk, o);
      acc += part;
    }
    g[r * C + cin] += acc;
  }
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

unsigned blocks_for(long n, int threads = kThreads) {
  const long b = (n + threads - 1) / threads;
  return static_cast<unsigned>(b < 8192 ? b : 8192);
}

// Floats of workspace: g [n_nodes + 1, B, T, C], row stats [rows, 2], the
// dzc buffer [B, T, C], db/LayerNorm partials [kChunks, 2, C] and conv dW
// partials [kChunks, K, ci, C] for the widest conv node.
long long workspace_floats(int batch, int t_len, int C, int n_nodes, const int* desc) {
  const long long rows = static_cast<long long>(batch) * t_len, numel = rows * C;
  long long kcic = 0;
  for (int n = 0; n < n_nodes; ++n) {
    const int* nd = desc + n * kDescInts;
    if (nd[0] == kConv && static_cast<long long>(nd[1]) * nd[4] * C > kcic)
      kcic = static_cast<long long>(nd[1]) * nd[4] * C;
  }
  return (n_nodes + 1) * numel + 2 * rows + numel + kChunks * 2LL * C + kChunks * kcic;
}

template <typename T>
int run_backward(int batch, int t_len, int C, int n_nodes, const int* desc,
                 const void* const* weights, const T* x, const T* outs, const T* mults,
                 const T* dy, const float* ln_scale, int use_norm, float eps, T* dx,
                 void* const* dweights, void* const* dbiases, float* dscale, float* dshift,
                 float* work, cudaStream_t stream) {
  const long rows = static_cast<long>(batch) * t_len;
  const long numel = rows * C;
  float* g = work;
  float* stats = g + (n_nodes + 1) * numel;
  T* dzc = reinterpret_cast<T*>(stats + 2 * rows);
  float* part = stats + 2 * rows + numel;
  float* part_dw = part + kChunks * 2L * C;
  const T* in[kMaxOutputs];
  in[0] = x;
  for (int n = 0; n < n_nodes; ++n) in[n + 1] = outs + n * numel;
  const dim3 col_grid((C + kThreads - 1) / kThreads, kChunks);
  cudaError_t err;
#define NBASR_CHECK()                                           \
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = cudaMemsetAsync(g, 0, sizeof(float) * n_nodes * numel, stream)) != cudaSuccess)
    return err;
  float* g_last = g + n_nodes * numel;
  if (use_norm) {
    const long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    nbasr_ln_backward_rows<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        in[n_nodes], dy, ln_scale, g_last, stats, rows, C, eps);
    NBASR_CHECK();
    nbasr_ln_param_partials<T><<<col_grid, kThreads, 0, stream>>>(in[n_nodes], dy, stats, part,
                                                                  rows, C);
    NBASR_CHECK();
    nbasr_reduce_chunks<float><<<blocks_for(C), kThreads, 0, stream>>>(part, kChunks, C, 2L * C,
                                                                       dscale);
    NBASR_CHECK();
    nbasr_reduce_chunks<float><<<blocks_for(C), kThreads, 0, stream>>>(part + C, kChunks, C,
                                                                       2L * C, dshift);
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
    if (nd[0] != kConv && nd[0] != kLinear && !zero) return cudaErrorInvalidValue;
    nbasr_node_dz<T><<<col_grid, kThreads, 0, stream>>>(
        g + (n + 1) * numel, zero ? nullptr : mults + n * numel, dzc, part, g, numel, branches,
        rows, C);
    NBASR_CHECK();
    if (zero) continue;
    nbasr_reduce_chunks<float><<<blocks_for(C), kThreads, 0, stream>>>(
        part, kChunks, C, C, static_cast<float*>(dbiases[n]));
    NBASR_CHECK();
    const T* w = static_cast<const T*>(weights[n]);
    T* dw = static_cast<T*>(dweights[n]);
    if (nd[0] == kConv) {
      const int K = nd[1], d = nd[2], lpad = nd[3], ci = nd[4], co = nd[5];
      if (ci < 1 || co < 1) return cudaErrorInvalidValue;
      const long kcic = static_cast<long>(K) * ci * C;
      const dim3 dw_grid((C + kDwThreads - 1) / kDwThreads, kChunks,
                         K * ((ci + kMaxCi - 1) / kMaxCi));
      nbasr_conv_dw_partials<T><<<dw_grid, kDwThreads, 0, stream>>>(
          in[n], dzc, part_dw, rows, t_len, C, ci, co, K, d, lpad);
      NBASR_CHECK();
      nbasr_reduce_chunks<T><<<blocks_for(kcic), kThreads, 0, stream>>>(part_dw, kChunks, kcic,
                                                                        kcic, dw);
      NBASR_CHECK();
      const dim3 dx_grid((C + kThreads - 1) / kThreads,
                         static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
      nbasr_conv_dx<T><<<dx_grid, kThreads, 0, stream>>>(dzc, w, g + n * numel, rows, t_len, C,
                                                         ci, co, K, d, lpad);
      NBASR_CHECK();
    } else {
      const dim3 dw_grid((C + kTile - 1) / kTile, (C + kTile - 1) / kTile);
      nbasr_linear_dw<T><<<dw_grid, kThreads, 0, stream>>>(in[n], dzc, dw, rows, C);
      NBASR_CHECK();
      const dim3 dx_grid((C + kTile - 1) / kTile,
                         static_cast<unsigned>((rows + kTile - 1) / kTile));
      nbasr_linear_dx<T><<<dx_grid, kThreads, 0, stream>>>(dzc, w, g + n * numel, rows, C);
      NBASR_CHECK();
    }
  }
  nbasr_convert<float, T><<<blocks_for(numel), kThreads, 0, stream>>>(g, dx, numel);
  NBASR_CHECK();
#undef NBASR_CHECK
  return cudaSuccess;
}

}  // namespace

// Floats of f32 workspace nbasr_fused_cell_backward needs for this cell.
extern "C" long long nbasr_fused_cell_backward_workspace(int batch, int t_len, int C, int n_nodes,
                                                         const int* desc) {
  return workspace_floats(batch, t_len, C, n_nodes, desc);
}

// Backward of one cell on `stream`.  desc and weights as the forward's;
// outs and mults are what the training forward kept ([n_nodes, B, T, C],
// activation dtype); dy like x.  Writes dx (activation dtype), dweights[n]
// (activation dtype, the weight's shape) and dbiases[n] (f32 [C]) for each
// conv or linear node, and dscale/dshift (f32 [C]) with LayerNorm.  work
// holds nbasr_fused_cell_backward_workspace floats.  Returns a cudaError_t,
// 0 on success.
extern "C" int nbasr_fused_cell_backward(int bf16, int batch, int t_len, int C, int n_nodes,
                                         const int* desc, const void* const* weights,
                                         const void* x, const void* outs, const void* mults,
                                         const void* dy, const void* ln_scale, int use_norm,
                                         float eps, void* dx, void* const* dweights,
                                         void* const* dbiases, void* dscale, void* dshift,
                                         void* work, void* stream) {
  if (n_nodes < 1 || n_nodes >= kMaxOutputs) return cudaErrorInvalidValue;
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

extern "C" const char* nbasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
