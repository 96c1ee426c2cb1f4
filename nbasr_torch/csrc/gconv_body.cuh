// The grouped conv's device body, shared by the grouped conv library
// (grouped_conv.cu: the forward, dx and dW of grouped_impl 'pallas' and
// 'pallas_split') and the fused cell backward (fused_cell_bwd.cu: each conv
// node's dW and dx).  grouped_conv.cu's header states the bound and the
// design; this file holds its machinery: the plan structs and their C
// checks, the loader (stage_tile) and the stores (store_tile, add_tile),
// the dW kernel (nbasr_gconv_dw, its reduce, weight_grad), the forward's
// weight staging and register tiles (stage_weights, sum_channels) and its
// unit walk (conv_units), the occupancy query and the launchers.
//
// Every mode is a template parameter, never a runtime branch inside the
// body: ptxas's register choice follows the code's shape as well as its
// work, so a variable in the body costs the kernels that do not use it
// (one weight-staging loop for the forward and dx took the forward's bf16
// 5 x 6 tile from 120 registers to 80 and spills).  conv_units' output type
// Y and kAdd are the fused backward's: its dx leaves the f32 register sums
// in an f32 output tile and stores or adds them into the f32 gradient
// buffer, with no rounding in between; Y = T and kAdd = false are the
// grouped kernels' own, which compile as they did before the split.  Its
// epilogue type Epi is the fused forward's (fused_cell.cu: the node's f32
// bias, clip, dropout and multipliers in registers, then a store pass with
// the branch adds); the default NoEpilogue compiles to the code without it.
//
// Everything lives in namespace gconv inside an unnamed namespace, so each
// library that includes it gets its own copy and no name meets the
// includer's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {
namespace gconv {

constexpr int kThreads = 128;

struct View {
  long long b, c, t, g;
};

__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
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

// Calls f(soff, goff, trow, v) for the vectors of a tile of nrows times
// that this thread copies: run (mode 0: one per (channel, time), mode 1:
// one per time) at shared offset soff and channel offset goff in device
// memory, time row trow, vector v of the run.  Consecutive threads take
// consecutive vectors of a run and the runs after it; a thread steps over
// the runs with no division in the loop.
template <typename F>
__device__ __forceinline__ void for_each_vector(const Stage& st, int nrows, int gs, int vpr,
                                                F&& f) {
  const int runs = st.mode == 0 ? st.nch * nrows : nrows;
  const auto offsets = [&](int c, int trow, int* soff, long long* goff) {
    *soff = st.mode == 0 ? (trow * st.nch + c) * gs : trow * gs * st.nch;
    *goff = st.mode == 0 ? c * st.v.c : 0;
  };
  int soff;
  long long goff;
  if (vpr <= static_cast<int>(blockDim.x)) {
    const int per = blockDim.x / vpr;  // runs in flight at a time
    const int first = threadIdx.x / vpr;
    if (first >= per) return;
    const int v = threadIdx.x - first * vpr;
    int c = st.mode == 0 ? first / nrows : 0;
    int trow = first - c * nrows;
    for (int r = first; r < runs; r += per) {
      offsets(c, trow, &soff, &goff);
      f(soff, goff, trow, v);
      trow += per;
      while (st.mode == 0 && trow >= nrows) {
        trow -= nrows;
        ++c;
      }
    }
  } else {  // runs longer than the block: all threads on one run at a time
    for (int r = 0; r < runs; ++r) {
      const int c = st.mode == 0 ? r / nrows : 0;
      const int trow = r - c * nrows;
      offsets(c, trow, &soff, &goff);
      for (int v = threadIdx.x; v < vpr; v += blockDim.x) f(soff, goff, trow, v);
    }
  }
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
  const int run_len = st.mode == 0 ? geff : geff * st.nch;
  const int per_vec = st.vec / static_cast<int>(sizeof(T));
  const long long step = st.mode == 0 ? st.v.g : 1;  // element stride within a run
  for_each_vector(st, nrows, gs, run_len / per_vec, [&](int soff, long long goff, int trow, int v) {
    const int ts = ts0 + trow;
    T* dst = sm + soff + v * per_vec;
    if (ts < 0 || ts >= t_len) {
      zero_fill(dst, st.vec);
      return;
    }
    const T* s = src + goff + ts * st.v.t + v * per_vec * step;
    if (st.vec >= 4)
      cp_async(dst, s, st.vec);
    else
      *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(s);
  });
}

// The reverse of stage_tile: copies the times [0, nrows) of `geff` groups of
// a tile laid out for st's mode from `sm` to dst (the operand at its (b,
// c = 0, t0, g0)), in vectors of st.vec bytes.
template <typename T>
__device__ __noinline__ void store_tile(T* dst, const T* sm, Stage st, int nrows, int gs,
                                        int geff) {
  const int run_len = st.mode == 0 ? geff : geff * st.nch;
  const int per_vec = st.vec / static_cast<int>(sizeof(T));
  const long long step = st.mode == 0 ? st.v.g : 1;
  for_each_vector(st, nrows, gs, run_len / per_vec, [&](int soff, long long goff, int trow, int v) {
    const T* s = sm + soff + v * per_vec;
    T* g = dst + goff + trow * st.v.t + v * per_vec * step;
    if (st.vec == 16)
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(s);
    else if (st.vec == 8)
      *reinterpret_cast<uint2*>(g) = *reinterpret_cast<const uint2*>(s);
    else if (st.vec == 4)
      *reinterpret_cast<unsigned*>(g) = *reinterpret_cast<const unsigned*>(s);
    else
      *reinterpret_cast<unsigned short*>(g) = *reinterpret_cast<const unsigned short*>(s);
  });
}

// store_tile's twin that adds: dst += the f32 tile, vector by vector (the
// fused backward's dx into a gradient buffer that already holds branch
// adds).  One owner per element, so the order of the adds is fixed.
__device__ __noinline__ void add_tile(float* dst, const float* sm, Stage st, int nrows, int gs,
                                      int geff) {
  const int run_len = st.mode == 0 ? geff : geff * st.nch;
  const int per_vec = st.vec / static_cast<int>(sizeof(float));
  const long long step = st.mode == 0 ? st.v.g : 1;
  for_each_vector(st, nrows, gs, run_len / per_vec, [&](int soff, long long goff, int trow, int v) {
    const float* s = sm + soff + v * per_vec;
    float* g = dst + goff + trow * st.v.t + v * per_vec * step;
    if (st.vec == 16) {
      float4 a = *reinterpret_cast<const float4*>(g);
      const float4 b = *reinterpret_cast<const float4*>(s);
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
      *reinterpret_cast<float4*>(g) = a;
    } else if (st.vec == 8) {
      float2 a = *reinterpret_cast<const float2*>(g);
      const float2 b = *reinterpret_cast<const float2*>(s);
      a.x += b.x;
      a.y += b.y;
      *reinterpret_cast<float2*>(g) = a;
    } else {
      *g += *s;
    }
  });
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

// ---------------------------------------------------------------------------
// forward: staged x tile and weights, register tile along time and output
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 256;
constexpr int kFwdRt = 7;  // times a thread holds (odd: a warp's time tiles on other banks)
constexpr int kFwdPlanInts = 21;

// How nbasr_grouped_conv_forward (and nbasr_grouped_conv_dx, as the
// forward on dz) cuts the work, in the order of
// nbasr_torch/ops/grouped_conv.py FWD_PLAN_FIELDS (fwd_plan says what each
// is).
struct FwdPlan {
  int gs, slabs, rows, tiles, span, rt, kt, ot, nk, no, wstride, cc, x_mode, x_vec, y_mode, y_vec,
      x_buf, y_buf, w_buf, smem, threads;
};

// The weights of the cn input channels from c0, in f32: for the forward
// (kDx false) wsm[((k*cc + c)*gs + g)*wstride + o] = w[k, c0 + c, (g0 +
// g)*co + o]; for the input gradient (kDx true, ci the channels of dz and
// co those of dx, w [K, co, G*ci]) the same layout transposed and with its
// taps reversed, wsm[((k*cc + c)*gs + g)*wstride + o] = w[K-1-k, o, (g0 +
// g)*ci + c0 + c].  Either way consecutive threads read along w's
// contiguous run (the slab's (g, o) in the forward, its (g, c) in dx), one
// division per element of the run, and per tap the loads of up to 8 of
// w's rows are in flight before their stores (the weights come from L2,
// whose latency a load-store loop would pay per element).  Two loops, not
// one with the roles as variables: with that form ptxas gave the forward's
// bf16 5 x 6 tile 80 registers and spills, and the forward slowed
// (nbasr_torch/tools/step_ab.py --gconv reports both).
template <bool kDx, typename T>
__device__ __forceinline__ void stage_weights(float* wsm, const T* __restrict__ w, int c0, int cn,
                                              const FwdPlan& p, int geff, int g0, int groups,
                                              int ci, int co, int K) {
  constexpr int kBatch = 8;
  const int tap = p.cc * p.gs * p.wstride;
  const int chan = p.gs * p.wstride;
  if constexpr (!kDx) {
    const long long c_out = static_cast<long long>(groups) * co;
    const T* const wg = w + static_cast<long long>(c0) * c_out + static_cast<long long>(g0) * co;
    for (int j = threadIdx.x; j < geff * co; j += blockDim.x) {
      const int g = j / co;
      float* const dst = wsm + g * p.wstride + (j - g * co);
      for (int k = 0; k < K; ++k) {
        for (int cb = 0; cb < cn; cb += kBatch) {
          const T* const src = wg + (static_cast<long long>(k) * ci + cb) * c_out + j;
          float v[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) v[i] = cb + i < cn ? to_f(src[i * c_out]) : 0.0f;
#pragma unroll
          for (int i = 0; i < kBatch; ++i)
            if (cb + i < cn) dst[k * tap + (cb + i) * chan] = v[i];
        }
      }
    }
  } else {
    const long long row = static_cast<long long>(groups) * ci;  // w's [K, co, G*ci] rows
    const T* const wg = w + static_cast<long long>(g0) * ci + c0;
    for (int j = threadIdx.x; j < geff * cn; j += blockDim.x) {
      const int g = j / cn;
      const int c = j - g * cn;
      float* const dst = wsm + g * p.wstride + c * chan;
      const T* const src0 = wg + static_cast<long long>(g) * ci + c;
      for (int k = 0; k < K; ++k) {
        const T* const src = src0 + static_cast<long long>(K - 1 - k) * co * row;
        float* const dk = dst + k * tap;
        for (int ob = 0; ob < co; ob += kBatch) {
          float v[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) v[i] = ob + i < co ? to_f(src[(ob + i) * row]) : 0.0f;
#pragma unroll
          for (int i = 0; i < kBatch; ++i)
            if (ob + i < co) dk[ob + i] = v[i];
        }
      }
    }
  }
}

// acc[j][o] += sum over the cn staged channels c and the K taps k of
// x[c, row r0 + d*(j + k)] * w[k, c, o0 + o] for this thread's group gl:
// per channel and chunk of KT taps, the RT + KT - 1 window values are read
// once, the weights as float2.
template <typename T, int KT, int RT, int OT>
__device__ __forceinline__ void sum_channels(float (&acc)[RT][OT], const T* tile, const float* wsm,
                                             int c0, int cn, SmemView sx, int gl, int r0,
                                             int xstep, int wtap, int gs, int wstride, int o0,
                                             int K) {
  for (int c = 0; c < cn; ++c) {
    const T* const xc = tile + (c0 + c) * sx.c + gl * sx.g + r0 * sx.t;
    const float* const wc = wsm + (c * gs + gl) * wstride + o0;
    for (int k0 = 0; k0 < K; k0 += KT) {
      const int kn = min(KT, K - k0);
      const T* const xk = xc + k0 * xstep;
      float xw[RT + KT - 1];
#pragma unroll
      for (int m = 0; m < RT + KT - 1; ++m) xw[m] = m < RT + kn - 1 ? to_f(xk[m * xstep]) : 0.0f;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (k >= kn) break;
        const float* const wk = wc + (k0 + k) * wtap;
        float wv[OT];
#pragma unroll
        for (int o = 0; o < OT; o += 2) {
          const float2 v = *reinterpret_cast<const float2*>(wk + o);
          wv[o] = v.x;
          wv[o + 1] = v.y;
        }
#pragma unroll
        for (int j = 0; j < RT; ++j)
#pragma unroll
          for (int o = 0; o < OT; ++o) acc[j][o] = fmaf(xw[j + k], wv[o], acc[j][o]);
      }
    }
  }
}

// conv_units' default epilogue: none beyond kBiasRelu, and the output tile
// stored (store_tile) or added (add_tile) into y.  Another Epi takes the
// tile of plain sums (kBiasRelu false) and writes it out itself:
//   void store(int b, int t0, long long at, const Y* tile, const Stage& ys,
//     int nrows, int gs, int geff): the rows [0, nrows) of the unit at
//     times t0, ... of utterance b, `at` its element offset in ys's view (y
//     itself is not used).
struct NoEpilogue {};

// grid slabs * ceil(B * tiles / span), p.threads threads.  Block (slab, q)
// owns the groups [g0, g0 + gs) and walks the units u = q*span, ... (unit
// u: the times [t0, t0 + rows) of utterance b = u / tiles); with more than
// one unit the next unit's x tile is in flight while this one is summed,
// and the weights are staged once where one chunk holds every input
// channel.  Thread (gl, tt, oq), gl fastest, owns the outputs [o0, o0 +
// OT) of group g0 + gl at the RT times t0 + r0 + d*j, r0 = tt%d +
// d*RT*(tt/d): one dilation phase, so tap k of time j reads window element
// j + k.  The block holds ow = threads / (gs * rows/RT) output tiles at a
// time, and its threads walk the no tiles in passes of ow; with more than
// one pass the output goes to a tile of its own (y_buf elements), else it
// takes the x tile's place.  Taps come in chunks of KT (a last, shorter
// chunk skips its missing taps), input channels in chunks of cc whose
// weights are staged in turn.  Outputs past co and times past T are summed
// and dropped.  kDx: the weights are the input gradient's, staged
// transposed and tap-reversed (stage_weights), x is dz and y is dx.  Y is
// the output's type (T, or f32 for the fused backward: the output tile then
// holds f32, y_buf counts f32 elements, and the sums reach y unrounded);
// kAdd adds the tile into y (add_tile) instead of storing it.  Epi, with
// its state epi (a __grid_constant__ kernel parameter: read in place, not
// copied into registers), replaces the store (NoEpilogue above).
template <typename T, int KT, int RT, int OT, bool kBiasRelu, bool kDx, typename Y = T,
          bool kAdd = false, typename Epi = NoEpilogue>
__device__ __forceinline__ void conv_units(const T* __restrict__ x, Stage xs,
                                           const T* __restrict__ w, const T* __restrict__ bias,
                                           Y* __restrict__ y, Stage ys, FwdPlan p, int batch,
                                           int t_len, int groups, int ci, int co, int K, int d,
                                           int lpad, const Epi& epi = Epi{}) {
  constexpr bool kEpi = !std::is_same_v<Epi, NoEpilogue>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the x tiles (two where a block walks more than one unit), the output
  // tile where the threads make more than one pass, then the weights
  T* const tile0 = reinterpret_cast<T*>(smem_raw);
  T* const tile1 = tile0 + (p.span > 1 ? p.x_buf : 0);
  Y* const out_tile = reinterpret_cast<Y*>(tile0 + (p.span > 1 ? 2 : 1) * p.x_buf);
  float* const wsm = reinterpret_cast<float*>(out_tile + p.y_buf);
  const int slab = blockIdx.x % p.slabs;
  const int u0 = (blockIdx.x / p.slabs) * p.span;
  const int u1 = min(batch * p.tiles, u0 + p.span);
  const int g0 = slab * p.gs;
  const int geff = min(p.gs, groups - g0);
  const int halo = (K - 1) * d;
  const T* const xg = x + g0 * xs.v.g;
  {
    const int b = u0 / p.tiles;
    stage_tile(tile0, xg + b * xs.v.b, xs, (u0 - b * p.tiles) * p.rows - lpad, p.rows + halo,
               p.gs, geff, t_len);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  const int ntt = p.rows / RT;
  const int ow = p.threads / (p.gs * ntt);  // output tiles a pass holds
  const int gl = threadIdx.x % p.gs;
  const int rest = threadIdx.x / p.gs;
  const int tt = rest % ntt;
  const int oq = rest / ntt;
  const int r0 = tt % d + d * RT * (tt / d);
  const bool live = gl < geff;
  const SmemView sx = smem_view(xs.mode, ci, p.gs);
  const SmemView sy = smem_view(ys.mode, co, p.gs);
  const int xstep = d * sx.t;  // one window element
  const int wtap = p.cc * p.gs * p.wstride;
  const bool restage = p.cc < ci;  // the weights of a chunk at a time

  for (int u = u0; u < u1; ++u) {
    const bool odd = (u - u0) & 1;
    T* const tile = odd ? tile1 : tile0;
    Y* const yt = p.y_buf ? out_tile : reinterpret_cast<Y*>(tile);
    const int b = u / p.tiles;
    const int t0 = (u - b * p.tiles) * p.rows;
    if (u + 1 < u1) {  // the next unit into the other tile
      const int bn = (u + 1) / p.tiles;
      stage_tile(odd ? tile0 : tile1, xg + bn * xs.v.b, xs, (u + 1 - bn * p.tiles) * p.rows - lpad,
                 p.rows + halo, p.gs, geff, t_len);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    for (int q0 = 0; q0 < p.no; q0 += ow) {
      const int o0 = (q0 + oq) * OT;
      const bool on = live && q0 + oq < p.no;
      float acc[RT][OT];
#pragma unroll
      for (int o = 0; o < OT; ++o) {
        const float b0 = kBiasRelu && on && o0 + o < co
                             ? to_f(bias[static_cast<long long>(g0 + gl) * co + o0 + o])
                             : 0.0f;
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[j][o] = b0;
      }
      for (int c0 = 0; c0 < ci; c0 += p.cc) {
        const int cn = min(p.cc, ci - c0);
        if (restage || (u == u0 && q0 == 0)) {
          if (c0 > 0 || q0 > 0) __syncthreads();  // the chunk before is no longer read
          stage_weights<kDx>(wsm, w, c0, cn, p, geff, g0, groups, ci, co, K);
        }
        if (c0 == 0 && q0 == 0)
          asm volatile("cp.async.wait_group 1;\n" ::);  // this unit's tile is in
        __syncthreads();
        if (!on) continue;
        sum_channels<T, KT, RT, OT>(acc, tile, wsm, c0, cn, sx, gl, r0, xstep, wtap, p.gs,
                                    p.wstride, o0, K);
      }
      if (!p.y_buf) __syncthreads();  // the x tile is read; the output tile takes its place
      if (on) {
#pragma unroll
        for (int o = 0; o < OT; ++o) {
          if (o0 + o >= co) break;
#pragma unroll
          for (int j = 0; j < RT; ++j) {
            float v = acc[j][o];
            if (kBiasRelu) {  // comparisons, not fmaxf/fminf: NaN passes
              v = v < 0.0f ? 0.0f : v;
              v = v > 20.0f ? 20.0f : v;
            }
            store(yt, (r0 + d * j) * sy.t + (o0 + o) * sy.c + gl * sy.g, v);
          }
        }
      }
    }
    __syncthreads();
    if constexpr (kEpi)
      epi.store(b, t0, b * ys.v.b + g0 * ys.v.g + t0 * ys.v.t, yt, ys, min(p.rows, t_len - t0),
                p.gs, geff);
    else if constexpr (kAdd)
      add_tile(y + b * ys.v.b + g0 * ys.v.g + t0 * ys.v.t, yt, ys, min(p.rows, t_len - t0), p.gs,
               geff);
    else
      store_tile(y + b * ys.v.b + g0 * ys.v.g + t0 * ys.v.t, yt, ys, min(p.rows, t_len - t0), p.gs,
                 geff);
    __syncthreads();  // the tiles are free for the unit after next
  }
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

// Resident blocks per SM of `kernel` with `threads` threads and `smem` bytes
// of dynamic shared memory, from the CUDA occupancy calculator; -1 on an
// error.
template <typename Kernel>
int occupancy(Kernel kernel, int threads, int smem) {
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

// A forward plan the kernel can run: what fwd_plan makes, checked again;
// esize is the staged operand's element size, ysize the output's (its
// y_esize: esize, or 4 for an f32 output).
bool bad_fwd_plan(const FwdPlan& p, int esize, int ysize, int batch, int t_len, int groups, int ci,
                  int co, int K, int d) {
  const auto bad_vec = [](int v, int size) {
    return !(v == size || ((v == 4 || v == 8 || v == 16) && v > size));
  };
  if (p.gs < 1 || p.rt != kFwdRt || p.rows < 1 || p.rows % (p.rt * d) != 0 || p.no < 1)
    return true;
  const int per_pass = p.gs * (p.rows / p.rt);  // threads of one output tile
  const int ow = p.threads / per_pass;          // output tiles a pass holds
  const long long halo = static_cast<long long>(K - 1) * d;
  const long long x_need = static_cast<long long>(ci) * (p.rows + halo) * p.gs;
  const long long y_need = static_cast<long long>(co) * p.rows * p.gs;
  const long long w_need = static_cast<long long>(K) * p.cc * p.gs * p.wstride;
  const long long units = static_cast<long long>(batch) * p.tiles;
  const long long x_bytes = (p.span > 1 ? 2LL : 1LL) * p.x_buf * esize;
  return p.gs > groups || p.slabs != (groups + p.gs - 1) / p.gs || p.tiles < 1 ||
         static_cast<long long>(p.rows) * p.tiles < t_len ||
         static_cast<long long>(p.rows) * (p.tiles - 1) >= t_len || p.span < 1 ||
         units > 2147483647LL || p.nk * p.kt < K || p.no * p.ot < co ||
         p.wstride < p.no * p.ot || p.wstride % 2 != 0 || p.cc < 1 || p.cc > ci ||
         p.threads % per_pass != 0 || ow < 1 || ow > p.no || p.threads > kFwdThreads ||
         p.x_mode < 0 || p.x_mode > 1 || p.y_mode < 0 || p.y_mode > 1 ||
         bad_vec(p.x_vec, esize) || bad_vec(p.y_vec, ysize) || p.x_buf < x_need ||
         (p.y_buf == 0 &&
          (ow < p.no || static_cast<long long>(p.x_buf) * esize < y_need * ysize)) ||
         (p.y_buf != 0 && p.y_buf < y_need) || p.y_buf < 0 ||
         (static_cast<long long>(p.x_buf) * esize) % 16 != 0 ||
         (static_cast<long long>(p.y_buf) * ysize) % 16 != 0 || p.w_buf < w_need ||
         p.smem < x_bytes + static_cast<long long>(p.y_buf) * ysize + 4LL * p.w_buf ||
         p.smem > 232448 || p.slabs * ((units + p.span - 1) / p.span) > 2147483647LL;
}

// f(KT, OT) as integral constants for the register tile (kt, ot) of kFwdRt
// times when it is instantiated, else -1: in bf16, the train step's dtype,
// taps 5 and 7 by outputs 6, 8, 10 (co = 12 as two tiles of 6: a 7 x 12
// tile took 174 registers, or 128 and spills with the epilogue); in f32, the
// checks' dtype, one tile (fewer kernels to build).
template <typename T, typename F>
int with_fwd_tile(int kt, int ot, F&& f) {
#define NBASR_FWD_TILE(KT, OT) \
  if (kt == KT && ot == OT)    \
    return f(std::integral_constant<int, KT>{}, std::integral_constant<int, OT>{});
  if constexpr (std::is_same_v<T, float>) {
    NBASR_FWD_TILE(7, 6)
  } else {
    NBASR_FWD_TILE(5, 6)
    NBASR_FWD_TILE(5, 8)
    NBASR_FWD_TILE(5, 10)
    NBASR_FWD_TILE(7, 6)
    NBASR_FWD_TILE(7, 8)
    NBASR_FWD_TILE(7, 10)
  }
#undef NBASR_FWD_TILE
  return -1;
}

// Launches one of the plan's kernels (the forward or dx) on its grid:
// slabs * ceil(B * tiles / span) blocks of p.threads threads.
template <typename Kernel, typename... Args>
int launch_units(Kernel kernel, const FwdPlan& p, int batch, cudaStream_t s, Args... args) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  const long long units = static_cast<long long>(batch) * p.tiles;
  const long long blocks = p.slabs * ((units + p.span - 1) / p.span);
  kernel<<<static_cast<unsigned>(blocks), p.threads, p.smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace gconv
}  // namespace
