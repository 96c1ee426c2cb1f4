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
//
// The machinery below the thin kernels of this file (plans, loader,
// register tiles, unit walk, the dW kernel, launchers) is in
// gconv_body.cuh, which the fused cell backward (fused_cell_bwd.cu) shares
// for its conv nodes' dW and dx.

#include "gconv_body.cuh"

#include <cstring>

using namespace gconv;

namespace {

View view(const long long* s) { return View{s[0], s[1], s[2], s[3]}; }

bool bad_dims(int batch, int t_len, int groups, int ci, int co, int K, int d, int lpad) {
  return batch < 0 || t_len < 0 || groups < 1 || ci < 1 || co < 1 || K < 1 || d < 1 ||
         lpad < 0 || lpad > (K - 1) * d;
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

template <typename T>
int forward(int batch, int t_len, int groups, int ci, int co, int K, int d, int lpad, const T* x,
            View xv, const T* w, const T* bias, T* y, View yv, const FwdPlan& p,
            cudaStream_t s) {
  if (static_cast<long long>(batch) * t_len == 0) return cudaSuccess;
  if (bad_fwd_plan(p, sizeof(T), sizeof(T), batch, t_len, groups, ci, co, K, d))
    return cudaErrorInvalidValue;
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
  if (bad_fwd_plan(p, sizeof(T), sizeof(T), batch, t_len, groups, co, ci, K, d))
    return cudaErrorInvalidValue;
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
