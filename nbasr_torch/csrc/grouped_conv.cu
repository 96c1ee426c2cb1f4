// Grouped 1-D convolution, stride 1, dilated, for Hopper (sm_90a): the
// forward (with an optional bias + clip-ReLU(0, 20) epilogue), its input
// gradient and its weight gradient.
//
// Replaces the Pallas TPU kernels of nbasr_tpu/ops/grouped_conv.py
// (_fwd_kernel, _dx_kernel and _dw_kernel, which grouped_conv1d and its
// custom VJP reach: grouped_impl='pallas') and of nbasr_tpu/ops/cell_ops.py
// (_fwd_kernel with its bias and clip-ReLU, _dx_kernel, and grouped_conv's
// _dw_kernel again: grouped_impl='pallas_split').  The input gradient,
// nbasr_gconv_dx, replaces both _dx_kernel bodies:
// nbasr_tpu/ops/grouped_conv.py:56 (pallas_call :182) and
// nbasr_tpu/ops/cell_ops.py:78 (pallas_call :171).
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
//   forward: K*ci = 30-60 FMAs per output, so on the CUDA cores alone (67
//     TFLOP/s f32) the operations take 0.75-1.5 times the byte time (0.357
//     against 0.321 ms for a flagship bf16 train step's 54 nodes), if the
//     FMAs keep the issue slots.  The launch plan (fwd_plan in
//     nbasr_torch/ops/grouped_conv.py, checked again here) cuts the output
//     into slabs of gs groups and units of `rows` time steps of one
//     utterance; a block walks `span` units of one slab:
//     - staging: each unit's x tile, with the (K-1)*d halo, zero outside
//       [0, T) of its own utterance (never the next row of the batch), goes
//       to shared memory by the dW's loader (stage_tile): cp.async along
//       whichever axis has stride 1, 16-byte vectors of the dense slab's
//       (g, c) run per time step, 8-byte vectors of the split layout's g
//       run, any other view element by element; the next unit's tile is in
//       flight while this one is summed.  The slab's weights are converted
//       to f32 once per block into [K][cc][gs][wstride] (chunks of cc input
//       channels where a group's weights do not fit at once), their loads
//       batched so that L2's latency is paid per tap, not per element;
//     - register blocking: a thread owns RT = 7 times of one dilation phase
//       (t, t+d, ...) by OT outputs of one group, OT instantiated for the
//       search space's co (6, 8, 10; co = 12 and larger take further output
//       tiles, which the block's threads walk in passes where they are more
//       than it holds at once), so no FMA slot is dead on the flagship.  Per input channel
//       it reads the RT+KT-1 x values of its window once and reuses them
//       across the taps, with the K*OT weights read as float2: K*RT*OT FMAs
//       (210-350) for 26-36 shared loads (11 of x, 15-25 float2 of
//       weights at K=5), where one thread per output row made one load
//       per FMA;
//     - warp mapping: g fastest, then the time tiles, then the output
//       tiles.  Lanes on neighbouring groups read neighbouring weight rows
//       (a row is an odd number of float2, so a half-warp's 8-byte reads
//       fall in distinct banks) and neighbouring x elements; lanes on the
//       same group read one address (a broadcast).  A warp's time tiles lie
//       RT*d rows apart: with RT odd they fall on other banks (RT = 8 put
//       them all on the same ones, up to 4-way conflicts); the plan counts
//       the conflicts its slab leaves (fwd_candidates; resident blocks from
//       the CUDA occupancy calculator, nbasr_grouped_conv_fwd_blocks_per_sm);
//     - the output tile goes back through shared memory (over the x tile,
//       or a tile of its own where the output tiles take several passes)
//       and out in the widest vectors along the contiguous axis (the dense
//       (g, o) run per time step, the split g run per (o, t)), so both
//       layouts' stores are coalesced; the epilogue (the sum starts at the
//       bias; clip by comparisons, so NaN passes as in jnp.clip) is applied
//       in f32 before the one rounding;
//     - each output has one owner and a fixed order of summation, so two
//       calls give the same bits.
//   dx: the forward above, run on dz with the weights transposed and their
//     taps reversed (the identity the JAX wrappers use when they pad dz by
//     (span - lpad, lpad) and transpose the weights):
//       dx[b,c,t,g] = sum_{k',o} dz[b,o,t+k'*d-rpad,g] * w'[k',o,g*ci+c],
//       k' = K-1-k, rpad = (K-1)*d - lpad, w'[k',o,g*ci+c] = w[K-1-k',c,g*co+o],
//     so its "input" has co channels a group, its "output" ci, and its
//     halo is mirrored (rpad on the left: the cells pad asymmetrically).
//     The same bound, 0.3214 ms of bytes for a flagship bf16 train step's
//     54 nodes, and the same 11.95 G FMAs.  nbasr_gconv_dx shares the
//     forward's body (conv_units) and differs only where it stages the
//     weights: per block or per chunk, off the inner loop, into the same
//     f32 [K][cc][gs][wstride] layout, wsm[k'][o][g][c] = w[K-1-k', c,
//     g*co+o], read along w's contiguous (g, o) run, per tap the loads of
//     up to 8 of its channels c in flight; chunks of cc then run over o
//     and wstride follows ci, so the register tile, the loader (dz staged
//     with the mirrored halo, zero outside its own utterance, any strides)
//     and the output tile (the identity epilogue, one rounding, wide
//     vectors) are the forward's.  Its own launch plan (fwd_plan with the dims swapped)
//     and occupancy entry point; each dx element has one owner and a fixed
//     order of summation, so two calls give the same bits.
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
//     further items of the same kernel, whose overhanging sums are dropped
//     (the forward and dx likewise, with their own tiles).
// Each entry point returns the first cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

namespace {

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
// transposed and tap-reversed (stage_weights), x is dz and y is dx.
template <typename T, int KT, int RT, int OT, bool kBiasRelu, bool kDx>
__device__ __forceinline__ void conv_units(const T* __restrict__ x, Stage xs,
                                           const T* __restrict__ w, const T* __restrict__ bias,
                                           T* __restrict__ y, Stage ys, FwdPlan p, int batch,
                                           int t_len, int groups, int ci, int co, int K, int d,
                                           int lpad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the x tiles (two where a block walks more than one unit), the output
  // tile where the threads make more than one pass, then the weights
  T* const tile0 = reinterpret_cast<T*>(smem_raw);
  T* const tile1 = tile0 + (p.span > 1 ? p.x_buf : 0);
  T* const out_tile = tile0 + (p.span > 1 ? 2 : 1) * p.x_buf;
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
    T* const yt = p.y_buf ? out_tile : tile;
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
    store_tile(y + b * ys.v.b + g0 * ys.v.g + t0 * ys.v.t, yt, ys, min(p.rows, t_len - t0), p.gs,
               geff);
    __syncthreads();  // the tiles are free for the unit after next
  }
}

// The forward: y (co channels) = the grouped conv of x (ci channels) with
// w [K, ci, G*co], with or without the bias + clip-ReLU epilogue.
template <typename T, int KT, int RT, int OT, bool kBiasRelu>
__global__ void __launch_bounds__(kFwdThreads)
    nbasr_gconv_fwd(const T* __restrict__ x, Stage xs, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ y, Stage ys, FwdPlan p, int batch,
                    int t_len, int groups, int ci, int co, int K, int d, int lpad) {
  conv_units<T, KT, RT, OT, kBiasRelu, false>(x, xs, w, bias, y, ys, p, batch, t_len, groups, ci,
                                              co, K, d, lpad);
}

// The input gradient: dx (ci channels) for dz (co channels) through w [K,
// ci, G*co] of a conv padded lpad on the left, as the forward on dz with
// the weights transposed, the taps reversed and the halo mirrored (rpad =
// (K-1)*d - lpad on the left); no epilogue.
template <typename T, int KT, int RT, int OT>
__global__ void __launch_bounds__(kFwdThreads)
    nbasr_gconv_dx(const T* __restrict__ dz, Stage zs, const T* __restrict__ w,
                   T* __restrict__ dx, Stage xs, FwdPlan p, int batch, int t_len, int groups,
                   int ci, int co, int K, int d, int rpad) {
  conv_units<T, KT, RT, OT, false, true>(dz, zs, w, nullptr, dx, xs, p, batch, t_len, groups, co,
                                         ci, K, d, rpad);
}

View view(const long long* s) { return View{s[0], s[1], s[2], s[3]}; }

bool bad_dims(int batch, int t_len, int groups, int ci, int co, int K, int d, int lpad) {
  return batch < 0 || t_len < 0 || groups < 1 || ci < 1 || co < 1 || K < 1 || d < 1 ||
         lpad < 0 || lpad > (K - 1) * d;
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

// A forward plan the kernel can run: what fwd_plan makes, checked again.
bool bad_fwd_plan(const FwdPlan& p, int esize, int batch, int t_len, int groups, int ci, int co,
                  int K, int d) {
  const auto bad_vec = [esize](int v) {
    return !(v == esize || ((v == 4 || v == 8 || v == 16) && v > esize));
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
         p.x_mode < 0 || p.x_mode > 1 || p.y_mode < 0 || p.y_mode > 1 || bad_vec(p.x_vec) ||
         bad_vec(p.y_vec) || p.x_buf < x_need || (p.y_buf == 0 && (ow < p.no || p.x_buf < y_need)) ||
         (p.y_buf != 0 && p.y_buf < y_need) || p.y_buf < 0 ||
         (static_cast<long long>(p.x_buf) * esize) % 16 != 0 ||
         (static_cast<long long>(p.y_buf) * esize) % 16 != 0 || p.w_buf < w_need ||
         p.smem < x_bytes + static_cast<long long>(p.y_buf) * esize + 4LL * p.w_buf ||
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

template <typename T>
int forward(int batch, int t_len, int groups, int ci, int co, int K, int d, int lpad, const T* x,
            View xv, const T* w, const T* bias, T* y, View yv, const FwdPlan& p,
            cudaStream_t s) {
  if (static_cast<long long>(batch) * t_len == 0) return cudaSuccess;
  if (bad_fwd_plan(p, sizeof(T), batch, t_len, groups, ci, co, K, d)) return cudaErrorInvalidValue;
  const Stage xs{xv, ci, p.x_mode, p.x_vec}, ys{yv, co, p.y_mode, p.y_vec};
  if (!stage_fits(xs, sizeof(T)) || !stage_fits(ys, sizeof(T))) return cudaErrorInvalidValue;
  const int err = with_fwd_tile<T>(p.kt, p.ot, [&](auto kt, auto ot) {
    constexpr int KT = decltype(kt)::value, OT = decltype(ot)::value;
    if (bias)
      return launch_units(nbasr_gconv_fwd<T, KT, kFwdRt, OT, true>, p, batch, s, x, xs, w, bias,
                          y, ys, p, batch, t_len, groups, ci, co, K, d, lpad);
    return launch_units(nbasr_gconv_fwd<T, KT, kFwdRt, OT, false>, p, batch, s, x, xs, w,
                        static_cast<const T*>(nullptr), y, ys, p, batch, t_len, groups, ci, co,
                        K, d, lpad);
  });
  return err < 0 ? cudaErrorInvalidValue : err;
}

// The plan is the forward's for the conv on dz: co input channels, ci
// outputs, rpad = (K-1)*d - lpad on the left.
template <typename T>
int dx_as_forward(int batch, int t_len, int groups, int ci, int co, int K, int d, int rpad,
                  const T* dz, View zv, const T* w, T* dx, View xv, const FwdPlan& p,
                  cudaStream_t s) {
  if (static_cast<long long>(batch) * t_len == 0) return cudaSuccess;
  if (bad_fwd_plan(p, sizeof(T), batch, t_len, groups, co, ci, K, d)) return cudaErrorInvalidValue;
  const Stage zs{zv, co, p.x_mode, p.x_vec}, xs{xv, ci, p.y_mode, p.y_vec};
  if (!stage_fits(zs, sizeof(T)) || !stage_fits(xs, sizeof(T))) return cudaErrorInvalidValue;
  const int err = with_fwd_tile<T>(p.kt, p.ot, [&](auto kt, auto ot) {
    return launch_units(nbasr_gconv_dx<T, decltype(kt)::value, kFwdRt, decltype(ot)::value>, p,
                        batch, s, dz, zs, w, dx, xs, p, batch, t_len, groups, ci, co, K, d, rpad);
  });
  return err < 0 ? cudaErrorInvalidValue : err;
}

// The fewer resident blocks per SM of the forward's two epilogues.
template <typename T, int KT, int OT>
int fwd_occupancy(int threads, int smem) {
  const int plain = occupancy(nbasr_gconv_fwd<T, KT, kFwdRt, OT, false>, threads, smem);
  const int relu = occupancy(nbasr_gconv_fwd<T, KT, kFwdRt, OT, true>, threads, smem);
  return plain < relu ? plain : relu;
}

}  // namespace

// y (a [B, co, T, G] view) = the grouped conv of x (a [B, ci, T, G] view)
// with w [K, ci, G*co]; with bias [G*co] (non-null) the bias + clip-ReLU
// epilogue.  Strides are four elements each, [b, c, t, g] order; the launch
// is cut as plan says (kFwdPlanInts ints, fwd_plan's FWD_PLAN_FIELDS).
// Returns a cudaError_t, 0 on success.
extern "C" int nbasr_grouped_conv_forward(int bf16, int batch, int t_len, int groups, int ci,
                                          int co, int K, int d, int lpad, const void* x,
                                          const long long* x_strides, const void* w,
                                          const void* bias, void* y, const long long* y_strides,
                                          const int* plan, void* stream) {
  if (bad_dims(batch, t_len, groups, ci, co, K, d, lpad) || !plan) return cudaErrorInvalidValue;
  static_assert(sizeof(FwdPlan) == kFwdPlanInts * sizeof(int), "FwdPlan is kFwdPlanInts ints");
  FwdPlan p;
  std::memcpy(&p, plan, sizeof(p));
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return forward<T>(batch, t_len, groups, ci, co, K, d, lpad, static_cast<const T*>(x),
                      view(x_strides), static_cast<const T*>(w), static_cast<const T*>(bias),
                      static_cast<T*>(y), view(y_strides), p, s);
  }
  return forward<float>(batch, t_len, groups, ci, co, K, d, lpad, static_cast<const float*>(x),
                        view(x_strides), static_cast<const float*>(w),
                        static_cast<const float*>(bias), static_cast<float*>(y), view(y_strides),
                        p, s);
}

// Resident blocks per SM of the forward kernel with a plan's register tile
// (kt, ot), threads and shared memory bytes (the fewer of its two
// epilogues), from the CUDA occupancy calculator; -1 for a tile that is not
// instantiated or an error.
extern "C" int nbasr_grouped_conv_fwd_blocks_per_sm(int bf16, int kt, int ot, int threads,
                                                    int smem) {
  if (threads < 1 || threads > kFwdThreads || smem < 0 || smem > 232448) return -1;
  if (bf16)
    return with_fwd_tile<__nv_bfloat16>(kt, ot, [&](auto a, auto b) {
      return fwd_occupancy<__nv_bfloat16, decltype(a)::value, decltype(b)::value>(threads, smem);
    });
  return with_fwd_tile<float>(kt, ot, [&](auto a, auto b) {
    return fwd_occupancy<float, decltype(a)::value, decltype(b)::value>(threads, smem);
  });
}

// dx (a [B, ci, T, G] view) = the input gradient for dz (a [B, co, T, G]
// view) through w [K, ci, G*co] of a conv padded (K-1)*d - rpad on the
// left: the forward on dz with the weights transposed and their taps
// reversed, padded rpad on the left, cut as plan says (fwd_plan of the
// conv on dz: G groups of co input and ci output channels).
extern "C" int nbasr_grouped_conv_dx(int bf16, int batch, int t_len, int groups, int ci, int co,
                                     int K, int d, int rpad, const void* dz,
                                     const long long* dz_strides, const void* w, void* dx,
                                     const long long* dx_strides, const int* plan, void* stream) {
  if (bad_dims(batch, t_len, groups, ci, co, K, d, rpad) || !plan) return cudaErrorInvalidValue;
  FwdPlan p;
  std::memcpy(&p, plan, sizeof(p));
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return dx_as_forward<T>(batch, t_len, groups, ci, co, K, d, rpad, static_cast<const T*>(dz),
                            view(dz_strides), static_cast<const T*>(w), static_cast<T*>(dx),
                            view(dx_strides), p, s);
  }
  return dx_as_forward<float>(batch, t_len, groups, ci, co, K, d, rpad,
                              static_cast<const float*>(dz), view(dz_strides),
                              static_cast<const float*>(w), static_cast<float*>(dx),
                              view(dx_strides), p, s);
}

// Resident blocks per SM of the dx kernel with a plan's register tile (kt,
// ot), threads and shared memory bytes, from the CUDA occupancy
// calculator; -1 for a tile that is not instantiated or an error.
extern "C" int nbasr_grouped_conv_dx_blocks_per_sm(int bf16, int kt, int ot, int threads,
                                                   int smem) {
  if (threads < 1 || threads > kFwdThreads || smem < 0 || smem > 232448) return -1;
  if (bf16)
    return with_fwd_tile<__nv_bfloat16>(kt, ot, [&](auto a, auto b) {
      constexpr int KT = decltype(a)::value, OT = decltype(b)::value;
      return occupancy(nbasr_gconv_dx<__nv_bfloat16, KT, kFwdRt, OT>, threads, smem);
    });
  return with_fwd_tile<float>(kt, ot, [&](auto a, auto b) {
    constexpr int KT = decltype(a)::value, OT = decltype(b)::value;
    return occupancy(nbasr_gconv_dx<float, KT, kFwdRt, OT>, threads, smem);
  });
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
      return occupancy(nbasr_gconv_dw<__nv_bfloat16, decltype(a)::value, decltype(b)::value>,
                       threads, smem);
    });
  return with_tile<float>(kt, ot, [&](auto a, auto b) {
    return occupancy(nbasr_gconv_dw<float, decltype(a)::value, decltype(b)::value>, threads, smem);
  });
}

extern "C" const char* nbasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
