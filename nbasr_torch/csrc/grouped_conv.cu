// Grouped 1-D convolution, stride 1, dilated, for Hopper (sm_90a): the
// forward (with an optional bias + clip-ReLU(0, 20) epilogue), its input
// gradient and its weight gradient.
//
// Replaces the Pallas TPU kernels of nbasr_tpu/ops/grouped_conv.py
// (_fwd_kernel, _dx_kernel and _dw_kernel, which grouped_conv1d and its
// custom VJP reach: grouped_impl='pallas') and of nbasr_tpu/ops/cell_ops.py
// (_fwd_kernel with its bias and clip-ReLU, _dx_kernel, and grouped_conv's
// _dw_kernel again: grouped_impl='pallas_split').
//
// Layouts.  Every activation is addressed as the view [B, c, T, G] through
// the four strides the caller gives, in elements.  A dense [B, T, C] tensor
// whose channel is c_full = g*c + c_in is that view with strides
// (T*C, 1, C, c); the split layout [B, c, T, G] is the same view
// contiguous.  So one kernel serves both layouts and neither needs a
// transpose (the TPU wrappers materialise them).  Weights are the compact
// [K, ci, C_out], C_out = G*co group-major, contiguous, in x's dtype.
//
// What they compute, with f32 sums, in f32 or bf16:
//   forward: y[b,o,t,g] = epi(sum_{k,c} x[b,c,t+k*d-lpad,g] * w[k,c,g*co+o]),
//            x zero outside [0, T); epi is the identity, or a sum that
//            starts at bias[g*co+o] and is clipped to [0, 20] (NaN passes,
//            as jnp.clip); one rounding to y's dtype at the end
//   dx:      dx[b,c,t,g] = sum_{k,o} dz[b,o,t+lpad-k*d,g] * w[k,c,g*co+o]
//   dW:      dw[k,c,g*co+o] = sum_{b,t} x[b,c,t+k*d-lpad,g] * dz[b,o,t,g],
//            summed in f32 over the batch and time, then rounded to the
//            weight's dtype (the JAX VJP's .astype(w.dtype))
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  Each kernel must read one
// [B, T, C] activation and write another (forward, dx) or read two (dW):
// two passes, 23 MB for a flagship conv5 node in bf16 at B=32, C=600,
// T=300, about 7 us.  The operations, 2*B*T*C*K*ci, are 2*K*ci = 60-170
// per element moved, under the card's rate even without the tensor cores.
//
// Design:
//   forward, dx (simple first): one thread per (b, t, g), g fastest,
//     holding up to kOut outputs of its group (co for the forward, ci for
//     dx) in registers; the K*ci (K*co) activations of its window and the
//     weights are read through L1, where the threads of a warp share them.
//   dW: per group a product [K*ci, rows] x [rows, co] over the B*T rows, so
//     it is bound by how often each activation is read and by how many
//     partial sums go back to memory.  The launch plan (dw_plan in
//     nbasr_torch/ops/grouped_conv.py, checked again here) answers:
//     - staging: a block owns a slab of gs groups and a chunk of row tiles
//       (up to 64 time steps of one utterance, so the halo reads zero at
//       the utterance's own edges, never the next row of the batch).  Each
//       tile's x, with its (K-1)*d halo, and dz go to shared memory by
//       cp.async of 16, 8 or 4-byte vectors along the contiguous axis (a
//       slab's (g, c) in the dense layout, g in the split layout; any
//       other view element by element along g), the next tile in flight
//       while this one is summed;
//     - register blocking: a thread holds a KT x OT tile of (tap, output)
//       sums for one (group, channel): per row it reads KT x values and
//       OT dz values from shared memory for KT*OT FMAs (5 x 6-12 on the
//       flagship); lanes of threads split a tile's rows and are summed in
//       order in shared memory at the end;
//     - few partials: one partial set per block, as many row chunks as one
//       wave of resident blocks holds (the CUDA occupancy calculator,
//       nbasr_grouped_conv_dw_blocks_per_sm) while the partials' f32 bytes
//       stay within a quarter of the activation bytes (one chunk writes dW
//       directly), the slab size chosen to fill that wave; a second pass
//       sums the chunks in order.  No float atomics, so two runs give the
//       same bits.
//     Any ci, co, K, d, lpad, B, T run: taps past the instantiated tile
//     (KT 7, else chunks of 5) and outputs past OT (6, 8, 10, 12) take
//     further items of the same kernel, whose overhanging sums are dropped.
// Each entry point returns the first cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kOut = 16;  // outputs a thread holds at once (search space: <= 12)

struct View {
  long long b, c, t, g;
};

__device__ __forceinline__ float load(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Thread i of `items` = B*T*G as (b, t, g), g fastest.
__device__ __forceinline__ bool thread_btg(long long items, int t_len, int groups, long long* b,
                                           int* t, int* g) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= items) return false;
  *g = static_cast<int>(i % groups);
  const long long bt = i / groups;
  *t = static_cast<int>(bt % t_len);
  *b = bt / t_len;
  return true;
}

template <typename T, bool kBiasRelu>
__global__ void __launch_bounds__(kThreads)
    nbasr_gconv_forward(const T* __restrict__ x, View xv, const T* __restrict__ w,
                        const T* __restrict__ bias, T* __restrict__ y, View yv, long long items,
                        int t_len, int groups, int ci, int co, int K, int d, int lpad) {
  long long b;
  int t, g;
  if (!thread_btg(items, t_len, groups, &b, &t, &g)) return;
  const long long c_out = static_cast<long long>(groups) * co;
  const T* xb = x + b * xv.b + g * xv.g;
  T* yb = y + b * yv.b + t * yv.t + g * yv.g;
  const T* wg = w + static_cast<long long>(g) * co;
  for (int o0 = 0; o0 < co; o0 += kOut) {
    float acc[kOut];
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      acc[j] = (kBiasRelu && o0 + j < co) ? load(bias, static_cast<long long>(g) * co + o0 + j)
                                          : 0.0f;
    for (int k = 0; k < K; ++k) {
      const int ts = t + k * d - lpad;
      if (ts < 0 || ts >= t_len) continue;
      const T* xs = xb + ts * xv.t;
      for (int c = 0; c < ci; ++c) {
        const float xval = load(xs, c * xv.c);
        const T* wk = wg + (static_cast<long long>(k) * ci + c) * c_out + o0;
#pragma unroll
        for (int j = 0; j < kOut; ++j)
          if (o0 + j < co) acc[j] += xval * load(wk, j);
      }
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      if (o0 + j < co) {
        float v = acc[j];
        if (kBiasRelu) {
          v = v < 0.0f ? 0.0f : v;
          v = v > 20.0f ? 20.0f : v;
        }
        store(yb, (o0 + j) * yv.c, v);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    nbasr_gconv_dx(const T* __restrict__ dz, View zv, const T* __restrict__ w, T* __restrict__ dx,
                   View xv, long long items, int t_len, int groups, int ci, int co, int K, int d,
                   int lpad) {
  long long b;
  int t, g;
  if (!thread_btg(items, t_len, groups, &b, &t, &g)) return;
  const long long c_out = static_cast<long long>(groups) * co;
  const T* zb = dz + b * zv.b + g * zv.g;
  T* xb = dx + b * xv.b + t * xv.t + g * xv.g;
  const T* wg = w + static_cast<long long>(g) * co;
  for (int c0 = 0; c0 < ci; c0 += kOut) {
    float acc[kOut];
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int tz = t + lpad - k * d;
      if (tz < 0 || tz >= t_len) continue;
      const T* zs = zb + tz * zv.t;
      const T* wk = wg + (static_cast<long long>(k) * ci + c0) * c_out;
      for (int o = 0; o < co; ++o) {
        const float zval = load(zs, o * zv.c);
#pragma unroll
        for (int j = 0; j < kOut; ++j)
          if (c0 + j < ci) acc[j] += zval * load(wk, j * c_out + o);
      }
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      if (c0 + j < ci) store(xb, (c0 + j) * xv.c, acc[j]);
  }
}

// ---------------------------------------------------------------------------
// dW: staged tiles, register blocking, one partial set per block
// ---------------------------------------------------------------------------

constexpr int kDwThreads = 256;
constexpr int kDwPlanInts = 19;

// How nbasr_grouped_conv_dw cuts the work, in the order of
// nbasr_torch/ops/grouped_conv.py DW_PLAN_FIELDS (dw_plan says what each is).
struct DwPlan {
  int gs, items, lanes, rows, x_rows, tiles, chunks, item_chunks, kt, ot, nk, no, x_mode, x_vec,
      z_mode, z_vec, x_buf, z_buf, smem;
};

// One operand as a block stages it: its [b, c, t, g] strides, its channels
// per group, and the plan's mode (0: runs over the slab's groups, shared
// [t][c][g], element by element where g is not contiguous; 1: one run over
// the slab's (g, c) per time step, the dense layout, shared [t][g][c]) and
// vector bytes (16, 8, 4, or one 2-byte element copied by hand).
struct Stage {
  View v;
  int nch, mode, vec;
};

// Element strides of a staged tile in shared memory.
struct SmemView {
  int c, t, g;
};

// A warp's threads read neighbouring addresses of one row in either layout,
// so its loads fall in distinct banks.
__device__ __forceinline__ SmemView smem_view(int mode, int nch, int gs) {
  if (mode == 0) return SmemView{gs, nch * gs, 1};
  return SmemView{1, gs * nch, nch};
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async(void* dst, const void* src, int vec) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (vec == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void zero_fill(void* dst, int vec) {
  if (vec == 16)
    *static_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  else if (vec == 8)
    *static_cast<uint2*>(dst) = make_uint2(0u, 0u);
  else if (vec == 4)
    *static_cast<unsigned*>(dst) = 0u;
  else
    *static_cast<unsigned short*>(dst) = 0;
}

// Copies the times [ts0, ts0 + nrows) of `geff` groups of one operand (src
// at its (b, c = 0, t = 0, g0)) into `sm`, laid out for its mode with `gs`
// groups; a time outside [0, T) of this utterance reads zero.  Vectors of
// 4 bytes and more go by cp.async.  Not inlined: one copy per dtype serves
// every register tile, which keeps the build short.
template <typename T>
__device__ __noinline__ void stage_tile(T* sm, const T* src, Stage st, int ts0, int nrows,
                                        int gs, int geff, int t_len) {
  // 32-bit index arithmetic: a tile fits shared memory
  const int runs = st.mode == 0 ? st.nch * nrows : nrows;
  const int run_len = st.mode == 0 ? geff : geff * st.nch;
  const int per_vec = st.vec / static_cast<int>(sizeof(T));
  const int vpr = run_len / per_vec;
  const long long step = st.mode == 0 ? st.v.g : 1;  // element stride within a run
  for (int i = threadIdx.x; i < runs * vpr; i += blockDim.x) {
    const int r = i / vpr;
    const int v = i - r * vpr;
    int trow, soff;
    long long goff;
    if (st.mode == 0) {
      const int c = r / nrows;
      trow = r - c * nrows;
      soff = (trow * st.nch + c) * gs;
      goff = c * st.v.c;
    } else {
      trow = r;
      soff = trow * gs * st.nch;
      goff = 0;
    }
    const int ts = ts0 + trow;
    T* dst = sm + soff + v * per_vec;
    if (ts < 0 || ts >= t_len) {
      zero_fill(dst, st.vec);
      continue;
    }
    const T* s = src + goff + ts * st.v.t + v * per_vec * step;
    if (st.vec >= 4)
      cp_async(dst, s, st.vec);
    else
      *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(s);
  }
}

// acc[a][b] += sum over the tile's rows j = j0, j0 + lanes, ... < rt of
// x[row j + (k0+a)*d] * dz[row j, o0+b]: koff and ooff hold each tap's and
// output's shared-memory offset for this thread's (group, channel).  A tap
// or output past the real ones reads a valid address of the tile and its
// sum is never written, so the loop needs no masks.
template <int KT, int OT, typename T>
__device__ __forceinline__ void tile_sums(float (&acc)[KT][OT], const T* xt, const T* zt,
                                          const int (&koff)[KT], const int (&ooff)[OT], int j0,
                                          int rt, int lanes, int sx_t, int sz_t) {
  for (int j = j0; j < rt; j += lanes) {
    const T* xr = xt + j * sx_t;
    const T* zr = zt + j * sz_t;
    float xv[KT], zv[OT];
#pragma unroll
    for (int a = 0; a < KT; ++a) xv[a] = to_f(xr[koff[a]]);
#pragma unroll
    for (int b = 0; b < OT; ++b) zv[b] = to_f(zr[ooff[b]]);
#pragma unroll
    for (int a = 0; a < KT; ++a)
#pragma unroll
      for (int b = 0; b < OT; ++b) acc[a][b] = fmaf(xv[a], zv[b], acc[a][b]);
  }
}

// The tile of unit u (utterance b, time tile i): its first time and length.
__device__ __forceinline__ void unit_rows(long long u, const DwPlan& p, int t_len, long long* b,
                                          int* t0, int* rt) {
  *b = u / p.tiles;
  *t0 = static_cast<int>(u - *b * p.tiles) * p.rows;
  *rt = min(p.rows, t_len - *t0);
}

// grid (slabs * item_chunks, chunks), p.items * p.lanes threads.  A block
// owns the groups [g0, g0 + gs) and items of (group, input channel, tap
// tile, output tile); lane l of an item sums the tile rows l, l + lanes, ...
// of the block's row units, every unit staged in shared memory while the
// one before it is summed.  The lanes are summed in order, then the block
// writes its partial set part[chunk][k][c][g*co + o] (or dw itself, rounded,
// when there is one chunk).
template <typename T, int KT, int OT>
__global__ void __launch_bounds__(kDwThreads)
    nbasr_gconv_dw(const T* __restrict__ x, Stage xs, const T* __restrict__ dz, Stage zs,
                   float* __restrict__ part, T* __restrict__ dw, DwPlan p, int batch, int t_len,
                   int groups, int ci, int co, int K, int d, int lpad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const xbuf0 = reinterpret_cast<T*>(smem_raw);
  T* const zbuf0 = xbuf0 + p.x_buf;
  T* const xbuf1 = zbuf0 + p.z_buf;
  T* const zbuf1 = xbuf1 + p.x_buf;
  const int slab = blockIdx.x / p.item_chunks;
  const int g0 = slab * p.gs;
  const int geff = min(p.gs, groups - g0);
  const int lane = threadIdx.x / p.items;
  const int slot = threadIdx.x - lane * p.items;
  const int item = (blockIdx.x - slab * p.item_chunks) * p.items + slot;
  const int pairs = p.gs * ci;
  const int pair = item % pairs, q = item / pairs;
  int gl, cl;
  if (xs.mode == 0) {  // neighbouring threads on neighbouring groups
    gl = pair % p.gs;
    cl = pair / p.gs;
  } else {             // ... or channels, as the tile lies in shared memory
    cl = pair % ci;
    gl = pair / ci;
  }
  const int k0 = (q % p.nk) * KT, o0 = (q / p.nk) * OT;
  const bool live = q < p.nk * p.no && gl < geff;
  const int kn = min(KT, K - k0), on = min(OT, co - o0);
  const SmemView sx = smem_view(xs.mode, ci, p.gs);
  const SmemView sz = smem_view(zs.mode, co, p.gs);
  int koff[KT], ooff[OT];
#pragma unroll
  for (int a = 0; a < KT; ++a) koff[a] = (a < kn ? (k0 + a) * d * sx.t : 0) + cl * sx.c + gl * sx.g;
#pragma unroll
  for (int b = 0; b < OT; ++b) ooff[b] = (b < on ? (o0 + b) * sz.c : 0) + gl * sz.g;

  const long long units = static_cast<long long>(batch) * p.tiles;
  const long long u0 = units * blockIdx.y / gridDim.y;
  const long long u1 = units * (blockIdx.y + 1) / gridDim.y;
  const int halo = (K - 1) * d;
  const T* const xg = x + static_cast<long long>(g0) * xs.v.g;
  const T* const zg = dz + static_cast<long long>(g0) * zs.v.g;
  float acc[KT][OT];
#pragma unroll
  for (int a = 0; a < KT; ++a)
#pragma unroll
    for (int b = 0; b < OT; ++b) acc[a][b] = 0.0f;

  long long b;
  int t0, rt;
  if (u0 < u1) {
    unit_rows(u0, p, t_len, &b, &t0, &rt);
    stage_tile(xbuf0, xg + b * xs.v.b, xs, t0 - lpad, rt + halo, p.gs, geff, t_len);
    stage_tile(zbuf0, zg + b * zs.v.b, zs, t0, rt, p.gs, geff, t_len);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (long long u = u0; u < u1; ++u) {
    const bool odd = (u - u0) & 1;
    if (u + 1 < u1) {  // the next unit into the other buffers
      unit_rows(u + 1, p, t_len, &b, &t0, &rt);
      stage_tile(odd ? xbuf0 : xbuf1, xg + b * xs.v.b, xs, t0 - lpad, rt + halo, p.gs, geff,
                 t_len);
      stage_tile(odd ? zbuf0 : zbuf1, zg + b * zs.v.b, zs, t0, rt, p.gs, geff, t_len);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    if (live) {
      unit_rows(u, p, t_len, &b, &t0, &rt);
      const T* xt = odd ? xbuf1 : xbuf0;
      const T* zt = odd ? zbuf1 : zbuf0;
      tile_sums(acc, xt, zt, koff, ooff, lane, rt, p.lanes, sx.t, sz.t);
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::);

  if (p.lanes > 1) {  // lanes 1.. hand their sums to lane 0 through shared memory
    float* red = reinterpret_cast<float*>(smem_raw);
    __syncthreads();
    if (lane > 0) {
#pragma unroll
      for (int a = 0; a < KT; ++a)
#pragma unroll
        for (int b2 = 0; b2 < OT; ++b2)
          red[((lane - 1) * KT * OT + a * OT + b2) * p.items + slot] = acc[a][b2];
    }
    __syncthreads();
    if (lane == 0) {
      for (int l = 1; l < p.lanes; ++l)
#pragma unroll
        for (int a = 0; a < KT; ++a)
#pragma unroll
          for (int b2 = 0; b2 < OT; ++b2)
            acc[a][b2] += red[((l - 1) * KT * OT + a * OT + b2) * p.items + slot];
    }
  }
  if (lane != 0 || !live) return;
  const long long n = static_cast<long long>(K) * ci * groups * co;
  const int g = g0 + gl;
#pragma unroll
  for (int a = 0; a < KT; ++a) {
#pragma unroll
    for (int b2 = 0; b2 < OT; ++b2) {
      if (a >= kn || b2 >= on) continue;
      const long long e =
          ((static_cast<long long>(k0 + a) * ci + cl) * groups + g) * co + o0 + b2;
      if (part)
        part[blockIdx.y * n + e] = acc[a][b2];
      else
        store(dw, e, acc[a][b2]);
    }
  }
}

// out[e] = sum over chunks (in order) of part[chunk * n + e], rounded to T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    nbasr_gconv_dw_reduce(const float* __restrict__ part, int chunks, long long n,
                          T* __restrict__ out) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < chunks; ++k) s += part[k * n + e];
    store(out, e, s);
  }
}

View view(const long long* s) { return View{s[0], s[1], s[2], s[3]}; }

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 2147483647LL ? b : 2147483647LL);
}

bool bad_dims(int batch, int t_len, int groups, int ci, int co, int K, int d, int lpad) {
  return batch < 0 || t_len < 0 || groups < 1 || ci < 1 || co < 1 || K < 1 || d < 1 ||
         lpad < 0 || lpad > (K - 1) * d;
}

template <typename T>
int forward(int batch, int t_len, int groups, int ci, int co, int K, int d, int lpad, const T* x,
            View xv, const T* w, const T* bias, T* y, View yv, cudaStream_t s) {
  const long long items = static_cast<long long>(batch) * t_len * groups;
  if (items == 0) return cudaSuccess;
  if (bias)
    nbasr_gconv_forward<T, true><<<blocks_for(items), kThreads, 0, s>>>(
        x, xv, w, bias, y, yv, items, t_len, groups, ci, co, K, d, lpad);
  else
    nbasr_gconv_forward<T, false><<<blocks_for(items), kThreads, 0, s>>>(
        x, xv, w, nullptr, y, yv, items, t_len, groups, ci, co, K, d, lpad);
  return cudaGetLastError();
}

template <typename T>
int input_grad(int batch, int t_len, int groups, int ci, int co, int K, int d, int lpad,
               const T* dz, View zv, const T* w, T* dx, View xv, cudaStream_t s) {
  const long long items = static_cast<long long>(batch) * t_len * groups;
  if (items == 0) return cudaSuccess;
  nbasr_gconv_dx<T><<<blocks_for(items), kThreads, 0, s>>>(dz, zv, w, dx, xv, items, t_len,
                                                           groups, ci, co, K, d, lpad);
  return cudaGetLastError();
}

// A plan the kernel can run: what dw_plan makes, checked again here.
bool bad_plan(const DwPlan& p, int esize, int t_len, int groups, int ci, int co, int K, int d) {
  const auto bad_vec = [esize](int v) {
    return !(v == esize || ((v == 4 || v == 8 || v == 16) && v > esize));
  };
  const long long items_all = static_cast<long long>(p.gs) * ci * p.nk * p.no;
  const long long stages = 2LL * (static_cast<long long>(p.x_buf) + p.z_buf) * esize;
  const long long reduce = 4LL * (p.lanes - 1) * p.items * p.kt * p.ot;
  return p.gs < 1 || p.gs > groups || p.items < 1 || p.lanes < 1 ||
         p.items * p.lanes > kDwThreads || p.rows < 1 || p.tiles < 1 ||
         static_cast<long long>(p.rows) * p.tiles < t_len ||
         static_cast<long long>(p.rows) * (p.tiles - 1) >= t_len ||
         p.x_rows != p.rows + (K - 1) * d || p.chunks < 1 || p.chunks > 65535 ||
         p.item_chunks < 1 || static_cast<long long>(p.items) * p.item_chunks < items_all ||
         p.nk * p.kt < K || p.no * p.ot < co || p.x_mode < 0 || p.x_mode > 1 || p.z_mode < 0 ||
         p.z_mode > 1 || bad_vec(p.x_vec) || bad_vec(p.z_vec) ||
         static_cast<long long>(p.x_buf) < static_cast<long long>(ci) * p.x_rows * p.gs ||
         static_cast<long long>(p.z_buf) < static_cast<long long>(co) * p.rows * p.gs ||
         (static_cast<long long>(p.x_buf) * esize) % 16 != 0 ||
         (static_cast<long long>(p.z_buf) * esize) % 16 != 0 || p.smem < stages ||
         p.smem < reduce || p.smem > 232448;
}

// The strides allow the staging mode: one (g, c) run per time step needs
// the dense layout's strides, a vector along g needs g contiguous.
bool stage_fits(const Stage& st, int esize) {
  if (st.mode == 1) return (st.v.c == 1 || st.nch == 1) && st.v.g == st.nch;
  return st.vec == esize || st.v.g == 1;
}

template <typename T, int KT, int OT>
int launch_dw(const DwPlan& p, int batch, int t_len, int groups, int ci, int co, int K, int d,
              int lpad, const T* x, const Stage& xs, const T* dz, const Stage& zs, T* dw,
              float* part, cudaStream_t s) {
  const auto kernel = nbasr_gconv_dw<T, KT, OT>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>((groups + p.gs - 1) / p.gs) * p.item_chunks, p.chunks);
  kernel<<<grid, p.items * p.lanes, p.smem, s>>>(x, xs, dz, zs, part, dw, p, batch, t_len, groups,
                                                 ci, co, K, d, lpad);
  return cudaGetLastError();
}

template <typename T, int KT, int OT>
int dw_occupancy(int threads, int smem) {
  const auto kernel = nbasr_gconv_dw<T, KT, OT>;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// f(KT, OT) as integral constants for the register tile (kt, ot) when it is
// instantiated, else -1: every tile dw_plan picks in bf16, the train step's
// dtype; in f32, the checks' dtype, the widest one alone (fewer kernels to
// build).
template <typename T, typename F>
int with_tile(int kt, int ot, F&& f) {
#define NBASR_DW_TILE(KT, OT) \
  if (kt == KT && ot == OT)   \
    return f(std::integral_constant<int, KT>{}, std::integral_constant<int, OT>{});
  if constexpr (std::is_same_v<T, float>) {
    NBASR_DW_TILE(7, 12)
  } else {
    NBASR_DW_TILE(5, 6)
    NBASR_DW_TILE(5, 8)
    NBASR_DW_TILE(5, 10)
    NBASR_DW_TILE(5, 12)
    NBASR_DW_TILE(7, 6)
    NBASR_DW_TILE(7, 8)
    NBASR_DW_TILE(7, 10)
    NBASR_DW_TILE(7, 12)
  }
#undef NBASR_DW_TILE
  return -1;
}

template <typename T>
int weight_grad(int batch, int t_len, int groups, int ci, int co, int K, int d, int lpad,
                const T* x, View xv, const T* dz, View zv, T* dw, float* work, const DwPlan& p,
                cudaStream_t s) {
  const long long n = static_cast<long long>(K) * ci * groups * co;
  const long long rows = static_cast<long long>(batch) * t_len;
  if (rows == 0) return cudaMemsetAsync(dw, 0, sizeof(T) * n, s);
  if (bad_plan(p, sizeof(T), t_len, groups, ci, co, K, d) || (p.chunks > 1 && !work))
    return cudaErrorInvalidValue;
  const Stage xs{xv, ci, p.x_mode, p.x_vec}, zs{zv, co, p.z_mode, p.z_vec};
  if (!stage_fits(xs, sizeof(T)) || !stage_fits(zs, sizeof(T))) return cudaErrorInvalidValue;
  float* part = p.chunks > 1 ? work : nullptr;
  const int err = with_tile<T>(p.kt, p.ot, [&](auto kt, auto ot) {
    return launch_dw<T, decltype(kt)::value, decltype(ot)::value>(
        p, batch, t_len, groups, ci, co, K, d, lpad, x, xs, dz, zs, dw, part, s);
  });
  if (err < 0) return cudaErrorInvalidValue;
  if (err != cudaSuccess || !part) return err;
  const long long nb = (n + kThreads - 1) / kThreads;
  nbasr_gconv_dw_reduce<T><<<static_cast<unsigned>(nb < 8192 ? nb : 8192), kThreads, 0, s>>>(
      work, p.chunks, n, dw);
  return cudaGetLastError();
}

}  // namespace

// y (a [B, co, T, G] view) = the grouped conv of x (a [B, ci, T, G] view)
// with w [K, ci, G*co]; with bias [G*co] (non-null) the bias + clip-ReLU
// epilogue.  Strides are four elements each, [b, c, t, g] order.  Returns a
// cudaError_t, 0 on success.
extern "C" int nbasr_grouped_conv_forward(int bf16, int batch, int t_len, int groups, int ci,
                                          int co, int K, int d, int lpad, const void* x,
                                          const long long* x_strides, const void* w,
                                          const void* bias, void* y, const long long* y_strides,
                                          void* stream) {
  if (bad_dims(batch, t_len, groups, ci, co, K, d, lpad)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return forward<T>(batch, t_len, groups, ci, co, K, d, lpad, static_cast<const T*>(x),
                      view(x_strides), static_cast<const T*>(w), static_cast<const T*>(bias),
                      static_cast<T*>(y), view(y_strides), s);
  }
  return forward<float>(batch, t_len, groups, ci, co, K, d, lpad, static_cast<const float*>(x),
                        view(x_strides), static_cast<const float*>(w),
                        static_cast<const float*>(bias), static_cast<float*>(y), view(y_strides),
                        s);
}

// dx (a [B, ci, T, G] view) = the input gradient for dz (a [B, co, T, G]
// view) through w [K, ci, G*co].
extern "C" int nbasr_grouped_conv_dx(int bf16, int batch, int t_len, int groups, int ci, int co,
                                     int K, int d, int lpad, const void* dz,
                                     const long long* dz_strides, const void* w, void* dx,
                                     const long long* dx_strides, void* stream) {
  if (bad_dims(batch, t_len, groups, ci, co, K, d, lpad)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return input_grad<T>(batch, t_len, groups, ci, co, K, d, lpad, static_cast<const T*>(dz),
                         view(dz_strides), static_cast<const T*>(w), static_cast<T*>(dx),
                         view(dx_strides), s);
  }
  return input_grad<float>(batch, t_len, groups, ci, co, K, d, lpad,
                           static_cast<const float*>(dz), view(dz_strides),
                           static_cast<const float*>(w), static_cast<float*>(dx),
                           view(dx_strides), s);
}

// dw [K, ci, G*co] (contiguous, x's dtype) = the weight gradient for x (a
// [B, ci, T, G] view) and dz (a [B, co, T, G] view), summed over the batch,
// cut as plan says (kDwPlanInts ints, dw_plan's DW_PLAN_FIELDS); work holds
// plan.chunks * K * ci * G * co floats of partial sums, or is null for one
// chunk.
extern "C" int nbasr_grouped_conv_dw(int bf16, int batch, int t_len, int groups, int ci, int co,
                                     int K, int d, int lpad, const void* x,
                                     const long long* x_strides, const void* dz,
                                     const long long* dz_strides, void* dw, void* work,
                                     const int* plan, void* stream) {
  if (bad_dims(batch, t_len, groups, ci, co, K, d, lpad) || !plan) return cudaErrorInvalidValue;
  static_assert(sizeof(DwPlan) == kDwPlanInts * sizeof(int), "DwPlan is kDwPlanInts ints");
  DwPlan p;
  std::memcpy(&p, plan, sizeof(p));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto wk = static_cast<float*>(work);
  if (bf16) {
    using T = __nv_bfloat16;
    return weight_grad<T>(batch, t_len, groups, ci, co, K, d, lpad, static_cast<const T*>(x),
                          view(x_strides), static_cast<const T*>(dz), view(dz_strides),
                          static_cast<T*>(dw), wk, p, s);
  }
  return weight_grad<float>(batch, t_len, groups, ci, co, K, d, lpad,
                            static_cast<const float*>(x), view(x_strides),
                            static_cast<const float*>(dz), view(dz_strides),
                            static_cast<float*>(dw), wk, p, s);
}

// Resident blocks per SM of the dW kernel with a plan's register tile (kt,
// ot), threads and shared memory bytes, from the CUDA occupancy calculator;
// -1 for a tile that is not instantiated or an error.
extern "C" int nbasr_grouped_conv_dw_blocks_per_sm(int bf16, int kt, int ot, int threads,
                                                   int smem) {
  if (threads < 1 || threads > kDwThreads || smem < 0 || smem > 232448) return -1;
  if (bf16)
    return with_tile<__nv_bfloat16>(kt, ot, [&](auto a, auto b) {
      return dw_occupancy<__nv_bfloat16, decltype(a)::value, decltype(b)::value>(threads, smem);
    });
  return with_tile<float>(kt, ot, [&](auto a, auto b) {
    return dw_occupancy<float, decltype(a)::value, decltype(b)::value>(threads, smem);
  });
}

extern "C" const char* nbasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
