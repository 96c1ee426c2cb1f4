// The CTC forward (alpha) and backward (beta) recursions in log space, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of nbasr_tpu/ops/ctc_pallas.py:
//   nbasr_ctc_alpha: _alpha_kernel (pallas_call in alpha_scan_pallas), the
//     kernel form of the forward scan _alpha_scan of nbasr_tpu/ops/ctc.py;
//   nbasr_ctc_beta:  _beta_kernel (pallas_call in beta_scan_pallas), the
//     kernel form of the backward scan _beta_scan.
// nbasr_torch/ops/ctc.py runs the alpha kernel in the CTC loss's forward and
// the beta kernel in its closed-form backward.
//
// What they compute, in f32, over em [T, B, S] (the emission log-probs of
// the S = 2U+1 extended-label states), for each batch row b:
//   alpha: alpha[0, s] = em[0, s] for s < 2, -1e30 elsewhere;
//          alpha[t, s] = la(la(alpha[t-1, s], alpha[t-1, s-1]),
//                           alpha[t-1, s-2] where skip[s]) + em[t, s]
//   beta:  beta[T-1, s] = 0 where final[s], -1e30 elsewhere;
//          inc[s] = beta[t+1, s] + em[t+1, s];
//          beta[t, s] = la(la(inc[s], inc[s+1]), inc[s+2] where skip[s+2])
// where a state shifted in from outside [0, S) is -1e30, and la is the JAX
// package's log_add: mx = max(a, b), 0 where mx <= -1e30, then
// mx + log(exp(a - mx) + exp(b - mx)).  So la(-1e30, -1e30) is -inf, and a
// row carries a mix of -1e30, -inf and finite states.  expf and logf are
// the accurate ones: the build has no --use_fast_math.  Each state runs the
// same operations in the same order as the plain versions of
// nbasr_torch/ops/ctc_pallas.py, so the stacks are bit-equal to them.
//
// Bound on an H100 SXM: neither bytes nor operations.  Each kernel reads em
// once and writes one [T, B, S] f32 stack (1.25 MB at the train step's
// T=75, B=32, S=65: 0.4 us at 3.35 TB/s), but step t needs every state of
// step t-1, so a row is T dependent steps.  Two log_adds one after the
// other (an expf and a logf each, ~32 dependent instructions) take 0.17 us
// on one warp, and one warp starts about one instruction every second
// cycle: two independent chains fit in a step, four take 2.4 times as long
// (tools/ctc_probe.py on an H100).  So a step is fast only where
// a warp holds two states a lane, and a longer row must spread over warps.
// The first version (one block per row, a thread a state, the state in
// shared memory, one __syncthreads a step) ran 0.47-0.50 us a step; a
// single warp holding the whole row in registers ran 0.46 us at S=65 (four
// states a lane) and 0.61-0.86 at S=161 (six).  Two paths now, planned in
// Python (ctc_pallas.recursion_plan) and checked again here:
//   - warp (S <= kWarpRow = 256, every user shape): a row over W warps of
//     one block, W = ceil(S / kOwn).  Warp p holds 64 states in registers,
//     two a lane (s0 = 2*lane and s0+1 above its base: the even one a
//     blank, into which the loss's masks never skip, so its skip log_add is
//     compiled out unless a mask of the warp does: a select on the flag
//     alone ran 15-33% slower, tools/step_ab.py --ctc); the s-1/s-2 (alpha) or
//     s+1/s+2 (beta) neighbours in the lane below or above come by two
//     shuffles.  Of the 64 states a warp owns kOwn = 48 and carries 2*kHalo
//     = 16 of its neighbour's (below it for alpha, above for beta): a
//     state's dependencies spread two states a step, so after kHalo steps
//     the borrowed states are wrong and the owned ones still right.  Every
//     kHalo steps the neighbour hands over its 16 states through shared
//     memory (a tagged slot, polled; the handover runs one way, so no warp
//     waits for a slower one but the one it reads), and the warp's own
//     steps in between hold no barrier and no exchange.  em arrives
//     through a per-warp cp.async ring kAhead steps ahead; each step's
//     owned states go straight to the output, which nothing reads back.
//     One row a block: its warps spread over the SM's four schedulers, and
//     the batch's rows over the SMs.
//   - block (longer rows): one block of up to 1024 threads per row (a
//     thread a state up to S = 1024), states tid + j*threads a thread, the
//     state double-buffered in shared memory
//     (in a global scratch row where it does not fit beside the ring), one
//     __syncthreads a step; em arrives through a cp.async ring of kRing = 2
//     rows in shared memory, started two steps ahead and waited with
//     cp.async.wait_group before the step's barrier, so the barrier does
//     not wait on a global load, and a thread's first 64 skip flags sit in
//     a register.  A row whose ring does not fit shared memory (S > 29056
//     on an H100) is refused.
// Both entry points run on the caller's stream and return the cudaError_t
// of their launch.  A poll that waits longer than any run could traps, so
// a broken handover fails the launch rather than hanging the card.

#include <cuda_runtime.h>

#include "ctc_log_add.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// warp path
constexpr int kWarpStates = 64;                   // a warp's states, two a lane
constexpr int kHalo = 8;                          // steps between handovers
constexpr int kOwn = kWarpStates - 2 * kHalo;     // states a warp owns
constexpr int kWarpRow = 256;                     // the warp path's longest row
constexpr int kMaxWarps = (kWarpRow + kOwn - 1) / kOwn;
constexpr int kAhead = 4;                         // em rows in a warp's ring
constexpr int kSlots = 4;                         // handovers in flight between two warps
constexpr int kSpinLimit = 1 << 26;               // polls before a trap (seconds)
// block path
constexpr int kMaxThreads = 1024;
constexpr int kRing = 2;  // em rows in a block's ring

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// warp path
// ---------------------------------------------------------------------------

struct WarpShared {
  float ring[kMaxWarps][kAhead][kWarpStates];  // em rows, per warp
  float halo[kMaxWarps][kSlots][2 * kHalo];    // states warp p hands over
  int tag[kMaxWarps][kSlots];                  // the handover each slot holds
  int done[kMaxWarps];                         // the last handover warp p read
};

__device__ void init_shared(WarpShared& sh) {
  for (int i = threadIdx.x; i < kMaxWarps * kSlots; i += blockDim.x) (&sh.tag[0][0])[i] = -1;
  for (int i = threadIdx.x; i < kMaxWarps; i += blockDim.x) sh.done[i] = -1;
  __syncthreads();  // once, before the recursion
}

// Handover `n` from warp `from`: waits for it, then returns (in h0, h1) the
// two states of slot entry `i`, and marks it read for warp `me`.
__device__ __forceinline__ void take(WarpShared& sh, int from, int me, int n, int i, float& h0,
                                     float& h1) {
  const int slot = n % kSlots;
  const volatile int* tag = &sh.tag[from][slot];
  int spins = 0;
  while (*tag != n)
    if (++spins > kSpinLimit) __trap();
  __threadfence_block();
  h0 = sh.halo[from][slot][2 * i];
  h1 = sh.halo[from][slot][2 * i + 1];
  __threadfence_block();  // the reads are done before the slot is freed
  __syncwarp();
  *reinterpret_cast<volatile int*>(&sh.done[me]) = n;
}

// Hands over `n` from warp `me` (the lanes with give, entry i), once warp
// `reader` has read handover n - kSlots from the same slot.
__device__ __forceinline__ void give(WarpShared& sh, int me, int reader, int n, bool gives, int i,
                                     float x0, float x1) {
  const int slot = n % kSlots;
  const volatile int* read = &sh.done[reader];
  int spins = 0;
  while (*read < n - kSlots)
    if (++spins > kSpinLimit) __trap();
  if (gives) {
    sh.halo[me][slot][2 * i] = x0;
    sh.halo[me][slot][2 * i + 1] = x1;
  }
  __threadfence_block();
  __syncwarp();
  *reinterpret_cast<volatile int*>(&sh.tag[me][slot]) = n;
}

// Warp `part` of a row: global states base + 2*lane + (0, 1), base =
// part*kOwn - 2*kHalo; it owns lanes >= kHalo and borrows the rest from
// warp part-1.
template <bool kEvenSkips>
__device__ __forceinline__ void alpha_warp(const float* __restrict__ e, unsigned sk,
                                           float* __restrict__ out, int T, long long row, int S,
                                           int lane, int part, int warps, WarpShared& sh) {
  const int s0 = part * kOwn - 2 * kHalo + 2 * lane;
  const bool v0 = s0 >= 0 && s0 < S, v1 = s0 + 1 >= 0 && s0 + 1 < S;
  const bool own = lane >= kHalo;
  float* ring = &sh.ring[part][0][0];
  float a0 = (v0 && s0 < 2) ? e[s0] : kNegInf;
  float a1 = (v1 && s0 + 1 < 2) ? e[s0 + 1] : kNegInf;
  if (own && v0) out[s0] = a0;
  if (own && v1) out[s0 + 1] = a1;
  for (int r = 0; r < kAhead; ++r) {  // em[1 .. kAhead]
    if (1 + r < T) {
      if (v0) copy_async(ring + ((1 + r) % kAhead) * kWarpStates + 2 * lane, e + (1 + r) * row + s0);
      if (v1)
        copy_async(ring + ((1 + r) % kAhead) * kWarpStates + 2 * lane + 1,
                   e + (1 + r) * row + s0 + 1);
    }
    commit_async();
  }
  int t = 1;
  for (int n = 0; t < T; ++n) {
    if (n > 0 && part > 0) {  // alpha[t-1] of the borrowed states, from warp part-1
      float h0, h1;
      take(sh, part - 1, part, n, lane % kHalo, h0, h1);
      if (!own) a0 = h0, a1 = h1;
    }
    const int t_end = t + kHalo < T ? t + kHalo : T;
#pragma unroll 1
    for (; t < t_end; ++t) {
      float* slot = ring + (t % kAhead) * kWarpStates + 2 * lane;
      wait_async<kAhead - 1>();  // this lane's copies of em[t]
      const float e0 = slot[0], e1 = slot[1];
      // a[s-1] and a[s-2] of the lane's first state, from the lane below
      float up1 = __shfl_up_sync(kFull, a1, 1);
      float up2 = __shfl_up_sync(kFull, a0, 1);
      if (lane == 0) up1 = up2 = kNegInf;
      float n0 = log_add(a0, up1);
      float n1 = log_add(a1, a0);
      if (kEvenSkips) {
        const float w = log_add(n0, up2);
        n0 = (sk & 1u) ? w : n0;
      }
      {
        const float w = log_add(n1, up1);
        n1 = (sk & 2u) ? w : n1;
      }
      a0 = v0 ? n0 + e0 : kNegInf;
      a1 = v1 ? n1 + e1 : kNegInf;
      const long long at = t * row;
      if (own && v0) out[at + s0] = a0;
      if (own && v1) out[at + s0 + 1] = a1;
      if (t + kAhead < T) {
        if (v0) copy_async(slot, e + at + kAhead * row + s0);
        if (v1) copy_async(slot + 1, e + at + kAhead * row + s0 + 1);
      }
      commit_async();
    }
    if (part + 1 < warps && t < T)  // the top 2*kHalo states, borrowed by warp part+1
      give(sh, part, part + 1, n + 1, lane >= 32 - kHalo, lane % kHalo, a0, a1);
  }
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    nbasr_ctc_alpha_warp(const float* __restrict__ em, const unsigned char* __restrict__ skip,
                         float* __restrict__ alphas, int T, int B, int S) {
  __shared__ WarpShared sh;
  init_shared(sh);
  const int warps = blockDim.x >> 5, part = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = blockIdx.x;
  const long long row = static_cast<long long>(B) * S;  // stride of t
  const int s0 = part * kOwn - 2 * kHalo + 2 * lane;
  unsigned sk = 0;  // skip bits of the lane's two states
  if (s0 >= 0 && s0 < S && skip[b * S + s0]) sk |= 1u;
  if (s0 + 1 >= 0 && s0 + 1 < S && skip[b * S + s0 + 1]) sk |= 2u;
  const float* e = em + b * S;
  float* out = alphas + b * S;
  if (__any_sync(kFull, sk & 1u))  // warp-uniform, once a row
    alpha_warp<true>(e, sk, out, T, row, S, lane, part, warps, sh);
  else
    alpha_warp<false>(e, sk, out, T, row, S, lane, part, warps, sh);
}

// Warp `part` of a row: global states base + 2*lane + (0, 1), base =
// part*kOwn; it owns lanes < kOwn/2 and borrows the rest from warp part+1.
// The state it carries is inc = beta + em of the step after the one
// computed, -1e30 past the row.
template <bool kEvenSkips>
__device__ __forceinline__ void beta_warp(const float* __restrict__ e, unsigned sk,
                                          const unsigned char* __restrict__ fin,
                                          float* __restrict__ out, int T, long long row, int S,
                                          int lane, int part, int warps, WarpShared& sh) {
  const int s0 = part * kOwn + 2 * lane;
  const bool v0 = s0 < S, v1 = s0 + 1 < S;
  const bool own = 2 * lane < kOwn;
  float* ring = &sh.ring[part][0][0];
  const long long last = (T - 1) * row;
  float i0 = kNegInf, i1 = kNegInf;
  if (v0) {
    const float v = fin[s0] ? 0.0f : kNegInf;
    if (own) out[last + s0] = v;
    i0 = v + e[last + s0];
  }
  if (v1) {
    const float v = fin[s0 + 1] ? 0.0f : kNegInf;
    if (own) out[last + s0 + 1] = v;
    i1 = v + e[last + s0 + 1];
  }
  for (int r = 0; r < kAhead; ++r) {  // em[T-2 .. T-1-kAhead]
    if (T - 2 - r >= 0) {
      if (v0) copy_async(ring + r * kWarpStates + 2 * lane, e + (T - 2 - r) * row + s0);
      if (v1) copy_async(ring + r * kWarpStates + 2 * lane + 1, e + (T - 2 - r) * row + s0 + 1);
    }
    commit_async();
  }
  int i = 0;  // steps done: beta[T-2-i] is next
  for (int n = 0; i < T - 1; ++n) {
    if (n > 0 && part + 1 < warps) {  // inc of the borrowed states, from warp part+1
      float h0, h1;
      take(sh, part + 1, part, n, lane % kHalo, h0, h1);
      if (!own) i0 = h0, i1 = h1;
    }
    const int i_end = i + kHalo < T - 1 ? i + kHalo : T - 1;
#pragma unroll 1
    for (; i < i_end; ++i) {
      const int t = T - 2 - i;
      float* slot = ring + (i % kAhead) * kWarpStates + 2 * lane;
      wait_async<kAhead - 1>();  // this lane's copies of em[t]
      const float e0 = slot[0], e1 = slot[1];
      // inc[s+1] and inc[s+2] of the lane's last state, from the lane above
      float dn1 = __shfl_down_sync(kFull, i0, 1);
      float dn2 = __shfl_down_sync(kFull, i1, 1);
      if (lane == 31) dn1 = dn2 = kNegInf;
      float n0 = log_add(i0, i1);
      float n1 = log_add(i1, dn1);
      if (kEvenSkips) {
        const float w = log_add(n0, dn1);
        n0 = (sk & 1u) ? w : n0;
      }
      {
        const float w = log_add(n1, dn2);
        n1 = (sk & 2u) ? w : n1;
      }
      const long long at = t * row;
      if (own && v0) out[at + s0] = n0;
      if (own && v1) out[at + s0 + 1] = n1;
      i0 = v0 ? n0 + e0 : kNegInf;
      i1 = v1 ? n1 + e1 : kNegInf;
      if (t - kAhead >= 0) {
        if (v0) copy_async(slot, e + at - kAhead * row + s0);
        if (v1) copy_async(slot + 1, e + at - kAhead * row + s0 + 1);
      }
      commit_async();
    }
    if (part > 0 && i < T - 1)  // the bottom 2*kHalo states, borrowed by warp part-1
      give(sh, part, part - 1, n + 1, lane < kHalo, lane % kHalo, i0, i1);
  }
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    nbasr_ctc_beta_warp(const float* __restrict__ em, const unsigned char* __restrict__ skip,
                        const unsigned char* __restrict__ final_states,
                        float* __restrict__ betas, int T, int B, int S) {
  __shared__ WarpShared sh;
  init_shared(sh);
  const int warps = blockDim.x >> 5, part = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = blockIdx.x;
  const long long row = static_cast<long long>(B) * S;
  const int s0 = part * kOwn + 2 * lane;
  unsigned sk = 0;  // skip_next[s] = skip[s+2], false in the last two states
  if (s0 + 2 < S && skip[b * S + s0 + 2]) sk |= 1u;
  if (s0 + 3 < S && skip[b * S + s0 + 3]) sk |= 2u;
  const float* e = em + b * S;
  float* out = betas + b * S;
  if (__any_sync(kFull, sk & 1u))
    beta_warp<true>(e, sk, final_states + b * S, out, T, row, S, lane, part, warps, sh);
  else
    beta_warp<false>(e, sk, final_states + b * S, out, T, row, S, lane, part, warps, sh);
}

// ---------------------------------------------------------------------------
// block path
// ---------------------------------------------------------------------------

// The em row `src` (this thread's states) into ring slot `dst`, as one
// copy group; an empty group where src is null, so that every thread
// commits one group a step.
__device__ __forceinline__ void ring_row(float* dst, const float* src, int S) {
  if (src)
    for (int s = threadIdx.x; s < S; s += blockDim.x) copy_async(dst + s, src + s);
  commit_async();
}

// A thread's first 64 flags (states tid + j*threads), offset by `shift`.
__device__ __forceinline__ unsigned long long flag_bits(const unsigned char* flags, int S,
                                                        int shift) {
  unsigned long long bits = 0;
  int j = 0;
  for (int s = threadIdx.x; s < S && j < 64; s += blockDim.x, ++j)
    if (s + shift < S && flags[s + shift]) bits |= 1ull << j;
  return bits;
}

// kGlobal: the state in global_state rather than in shared memory after
// the ring.
template <bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads)
    nbasr_ctc_alpha_block(const float* __restrict__ em, const unsigned char* __restrict__ skip,
                          float* __restrict__ alphas, float* __restrict__ global_state, int T,
                          int B, int S) {
  extern __shared__ float shared[];
  const int b = blockIdx.x, nt = blockDim.x, tid = threadIdx.x;
  float* rows = shared;  // ring slots of S floats
  float* buf = kGlobal ? global_state + 2LL * b * S : shared + kRing * S;
  const long long row = static_cast<long long>(B) * S;
  const float* e = em + static_cast<long long>(b) * S;
  const unsigned char* sk = skip + static_cast<long long>(b) * S;
  float* out = alphas + static_cast<long long>(b) * S;
  const unsigned long long bits = flag_bits(sk, S, 0);

  for (int r = 0; r < kRing; ++r)  // em[1 .. kRing]
    ring_row(rows + r * S, 1 + r < T ? e + (1 + r) * row : nullptr, S);
  for (int s = tid; s < S; s += nt) {
    const float v = s < 2 ? e[s] : kNegInf;
    buf[s] = v;
    out[s] = v;
  }
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    const float* prev = buf + ((t - 1) & 1) * S;
    float* next = buf + (t & 1) * S;
    const long long at = t * row;
    float* slot = rows + ((t - 1) % kRing) * S;
    wait_async<kRing - 1>();  // this thread's em[t]
    int j = 0;
    for (int s = tid; s < S; s += nt, ++j) {
      const bool skips = j < 64 ? (bits >> j & 1ull) != 0 : sk[s] != 0;
      float v = log_add(prev[s], s >= 1 ? prev[s - 1] : kNegInf);
      if (skips) v = log_add(v, s >= 2 ? prev[s - 2] : kNegInf);
      v += slot[s];
      next[s] = v;
      out[at + s] = v;
    }
    ring_row(slot, t + kRing < T ? e + (t + kRing) * row : nullptr, S);
    __syncthreads();
  }
}

template <bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads)
    nbasr_ctc_beta_block(const float* __restrict__ em, const unsigned char* __restrict__ skip,
                         const unsigned char* __restrict__ final_states,
                         float* __restrict__ betas, float* __restrict__ global_state, int T,
                         int B, int S) {
  extern __shared__ float shared[];
  const int b = blockIdx.x, nt = blockDim.x, tid = threadIdx.x;
  float* rows = shared;
  // the buffers hold inc = beta + em of the step after the one computed
  float* buf = kGlobal ? global_state + 2LL * b * S : shared + kRing * S;
  const long long row = static_cast<long long>(B) * S;
  const float* e = em + static_cast<long long>(b) * S;
  const unsigned char* sk = skip + static_cast<long long>(b) * S;
  const unsigned char* fin = final_states + static_cast<long long>(b) * S;
  float* out = betas + static_cast<long long>(b) * S;
  const unsigned long long bits = flag_bits(sk, S, 2);  // skip_next[s] = skip[s+2]

  const long long last = (T - 1) * row;
  for (int r = 0; r < kRing; ++r)  // em[T-2 .. T-1-kRing]
    ring_row(rows + r * S, T - 2 - r >= 0 ? e + (T - 2 - r) * row : nullptr, S);
  for (int s = tid; s < S; s += nt) {
    const float v = fin[s] ? 0.0f : kNegInf;
    out[last + s] = v;
    buf[s] = v + e[last + s];
  }
  __syncthreads();

  for (int i = 0; i < T - 1; ++i) {
    const int t = T - 2 - i;
    const float* inc = buf + (i & 1) * S;
    float* next = buf + ((i + 1) & 1) * S;
    const long long at = t * row;
    float* slot = rows + (i % kRing) * S;
    wait_async<kRing - 1>();  // this thread's em[t]
    int j = 0;
    for (int s = tid; s < S; s += nt, ++j) {
      const bool skips = j < 64 ? (bits >> j & 1ull) != 0 : s + 2 < S && sk[s + 2];
      float v = log_add(inc[s], s + 1 < S ? inc[s + 1] : kNegInf);
      if (skips) v = log_add(v, inc[s + 2]);
      out[at + s] = v;
      next[s] = v + slot[s];
    }
    ring_row(slot, t - kRing >= 0 ? e + (t - kRing) * row : nullptr, S);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// launch: the plan made in Python, checked again here
// ---------------------------------------------------------------------------

enum Path { kWarpPath = 0, kBlockPath = 1 };

int shared_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  return bytes;
}

// A plan (path, warps, threads, ring) of ctc_pallas.recursion_plan, with
// the shared bytes of the block path; an error where the kernels do not
// take it.
cudaError_t check_plan(const int* plan, int S, const void* global_state, size_t* smem) {
  const int path = plan[0], warps = plan[1], threads = plan[2], ring = plan[3];
  *smem = 0;
  if (path == kWarpPath)
    return S <= kWarpRow && warps == (S + kOwn - 1) / kOwn && threads == 32 * warps &&
                   ring == 0 && !global_state
               ? cudaSuccess
               : cudaErrorInvalidValue;
  if (path != kBlockPath || threads < 32 || threads > kMaxThreads || threads % 32 ||
      warps != threads / 32 || ring != kRing)
    return cudaErrorInvalidValue;
  const long long bytes = 4LL * S * (ring + (global_state ? 0 : 2));
  const int limit = shared_limit();
  if (limit < 0 || bytes > limit) return cudaErrorInvalidValue;
  *smem = static_cast<size_t>(bytes);
  return cudaSuccess;
}

// Launches a block-path kernel, opted in to more than 48 KB of dynamic
// shared memory where it needs it.
template <typename K, typename... A>
cudaError_t launch_block(K kernel, int B, int threads, size_t smem, cudaStream_t s, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

bool bad_dims(int T, int B, int S) { return T < 1 || B < 0 || S < 1; }

}  // namespace

// em [T, B, S] f32, skip [B, S] bool (the s-2 transition allowed) ->
// alphas [T, B, S] f32; all contiguous.  plan: the four ints of
// ctc_pallas.recursion_plan (path, warps, threads, ring).  global_state is
// null, or on the block path a [B, 2, S] f32 scratch for a state that does
// not fit beside the ring.
extern "C" int nbasr_ctc_alpha(int T, int B, int S, const float* em, const unsigned char* skip,
                               float* alphas, float* global_state, const int* plan,
                               void* stream) {
  if (bad_dims(T, B, S) || !plan) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  size_t smem = 0;
  cudaError_t err = check_plan(plan, S, global_state, &smem);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (plan[0] == kWarpPath) {
    nbasr_ctc_alpha_warp<<<B, plan[2], 0, s>>>(em, skip, alphas, T, B, S);
    return cudaGetLastError();
  }
  return launch_block(global_state ? nbasr_ctc_alpha_block<true> : nbasr_ctc_alpha_block<false>,
                      B, plan[2], smem, s, em, skip, alphas, global_state, T, B, S);
}

// em [T, B, S] f32, skip [B, S] bool (the unshifted mask: the kernel reads
// skip[s+2]), final_states [B, S] bool (the states a path may end in) ->
// betas [T, B, S] f32; plan and global_state as for nbasr_ctc_alpha.
extern "C" int nbasr_ctc_beta(int T, int B, int S, const float* em, const unsigned char* skip,
                              const unsigned char* final_states, float* betas,
                              float* global_state, const int* plan, void* stream) {
  if (bad_dims(T, B, S) || !plan) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  size_t smem = 0;
  cudaError_t err = check_plan(plan, S, global_state, &smem);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (plan[0] == kWarpPath) {
    nbasr_ctc_beta_warp<<<B, plan[2], 0, s>>>(em, skip, final_states, betas, T, B, S);
    return cudaGetLastError();
  }
  return launch_block(global_state ? nbasr_ctc_beta_block<true> : nbasr_ctc_beta_block<false>,
                      B, plan[2], smem, s, em, skip, final_states, betas, global_state, T, B, S);
}

// The shared memory a block of the current device may opt in to, in bytes
// (-1 on an error): the block path's budget for its ring and state.
extern "C" int nbasr_ctc_shared_limit() { return shared_limit(); }

extern "C" const char* nbasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
