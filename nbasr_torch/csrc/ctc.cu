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
//          beta[t, s] = la(la(inc[s], inc[s+1]), inc[s+2] where skip_next[s])
// where a state shifted in from outside [0, S) is -1e30, and la is the JAX
// package's log_add: mx = max(a, b), 0 where mx <= -1e30, then
// mx + log(exp(a - mx) + exp(b - mx)).  So la(-1e30, -1e30) is -inf, and a
// row carries a mix of -1e30, -inf and finite states.  expf and logf are
// the accurate ones: the build has no --use_fast_math.
//
// Bound on an H100 SXM: neither bytes nor operations.  Each kernel reads em
// once and writes one [T, B, S] f32 stack (1.25 MB at the train step's
// T=75, B=32, S=65: 0.4 us at 3.35 TB/s), but step t needs every state of
// step t-1, so a row is T dependent steps, each a round of exp/log latency
// and a barrier.  The design keeps that chain as short as it can:
//   - one thread block per batch row, the threads over the states (a loop
//     over s where S exceeds the block);
//   - the [S] state double-buffered in shared memory, one __syncthreads per
//     step (in a global scratch row per block where 2*S floats exceed the
//     48 KB a block gets without opting in);
//   - each thread's em values of the next step loaded into registers one
//     step ahead;
//   - every step's row written straight to the output, which nothing in the
//     block reads again.
// Measured on an H100 at T=75, B=32, S=65: 1.15 us per step for alpha,
// 2.0 for beta.  The barrier waits until the prefetched loads are
// performed, so their latency still sits on the chain; a cp.async ring of
// em rows, or a warp per row exchanging neighbours by shuffles with no
// block barrier, would take it off.
// Both entry points run on the caller's stream and return the cudaError_t
// of their launch.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxThreads = 256;
constexpr int kAhead = 4;  // states per thread whose next em value is held in a register
constexpr long long kSharedStateBytes = 48 * 1024;

__device__ __forceinline__ float log_add(float a, float b) {
  float mx = fmaxf(a, b);
  if (mx <= kNegInf) mx = 0.0f;
  return mx + logf(expf(a - mx) + expf(b - mx));
}

// alpha[t, s] before its emission, from the previous step's row `a`.
__device__ __forceinline__ float alpha_in(const float* a, int s, bool skip) {
  float v = log_add(a[s], s >= 1 ? a[s - 1] : kNegInf);
  if (skip) v = log_add(v, s >= 2 ? a[s - 2] : kNegInf);
  return v;
}

// beta[t, s] from inc = beta[t+1] + em[t+1] of the step after it.
__device__ __forceinline__ float beta_from(const float* inc, int s, int S, bool skip) {
  float v = log_add(inc[s], s + 1 < S ? inc[s + 1] : kNegInf);
  if (skip) v = log_add(v, s + 2 < S ? inc[s + 2] : kNegInf);
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
    nbasr_ctc_alpha(const float* __restrict__ em, const float* __restrict__ skip_mask,
                    float* __restrict__ alphas, float* __restrict__ global_state, int T, int B,
                    int S) {
  extern __shared__ float shared_state[];
  const int b = blockIdx.x, nt = blockDim.x, tid = threadIdx.x;
  float* buf = global_state ? global_state + 2LL * b * S : shared_state;
  const long long row = static_cast<long long>(B) * S;  // stride of t
  const float* e = em + static_cast<long long>(b) * S;
  const float* sk = skip_mask + static_cast<long long>(b) * S;
  float* out = alphas + static_cast<long long>(b) * S;

  float ahead[kAhead];  // em[t] of states tid + j*nt, loaded during step t-1
  bool skip[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int s = tid + j * nt;
    ahead[j] = (s < S && T > 1) ? e[row + s] : 0.0f;
    skip[j] = s < S && sk[s] > 0.0f;
  }
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
    const bool more = t + 1 < T;
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int s = tid + j * nt;
      if (s < S) {
        const float e_t = ahead[j];
        if (more) ahead[j] = e[at + row + s];
        const float v = alpha_in(prev, s, skip[j]) + e_t;
        next[s] = v;
        out[at + s] = v;
      }
    }
    for (int s = tid + kAhead * nt; s < S; s += nt) {
      const float v = alpha_in(prev, s, sk[s] > 0.0f) + e[at + s];
      next[s] = v;
      out[at + s] = v;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    nbasr_ctc_beta(const float* __restrict__ em, const float* __restrict__ skip_next,
                   const float* __restrict__ final_states, float* __restrict__ betas,
                   float* __restrict__ global_state, int T, int B, int S) {
  extern __shared__ float shared_state[];
  const int b = blockIdx.x, nt = blockDim.x, tid = threadIdx.x;
  // the buffers hold inc = beta + em of the step after the one computed
  float* buf = global_state ? global_state + 2LL * b * S : shared_state;
  const long long row = static_cast<long long>(B) * S;
  const float* e = em + static_cast<long long>(b) * S;
  const float* sk = skip_next + static_cast<long long>(b) * S;
  const float* fin = final_states + static_cast<long long>(b) * S;
  float* out = betas + static_cast<long long>(b) * S;

  float ahead[kAhead];  // em[t] of states tid + j*nt, loaded during step t+1
  bool skip[kAhead];
  const long long last = (T - 1) * row;
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int s = tid + j * nt;
    ahead[j] = (s < S && T > 1) ? e[last - row + s] : 0.0f;
    skip[j] = s < S && sk[s] > 0.0f;
  }
  for (int s = tid; s < S; s += nt) {
    const float v = fin[s] > 0.0f ? 0.0f : kNegInf;
    out[last + s] = v;
    buf[s] = v + e[last + s];
  }
  __syncthreads();

  for (int i = 0; i < T - 1; ++i) {
    const int t = T - 2 - i;
    const float* inc = buf + (i & 1) * S;
    float* next = buf + ((i + 1) & 1) * S;
    const long long at = t * row;
    const bool more = t > 0;
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int s = tid + j * nt;
      if (s < S) {
        const float e_t = ahead[j];
        if (more) ahead[j] = e[at - row + s];
        const float v = beta_from(inc, s, S, skip[j]);
        out[at + s] = v;
        next[s] = v + e_t;
      }
    }
    for (int s = tid + kAhead * nt; s < S; s += nt) {
      const float v = beta_from(inc, s, S, sk[s] > 0.0f);
      out[at + s] = v;
      next[s] = v + e[at + s];
    }
    __syncthreads();
  }
}

// Threads per block: the states rounded up to a warp, at most kMaxThreads.
int block_threads(int S) {
  const int warps = (S + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

// Shared memory for the state, or 0 where it lives in global_state.  An
// error where neither holds it.
cudaError_t state_bytes(int S, const void* global_state, size_t* bytes) {
  const long long need = 2LL * S * static_cast<long long>(sizeof(float));
  if (global_state) {
    *bytes = 0;
    return cudaSuccess;
  }
  if (need > kSharedStateBytes) return cudaErrorInvalidValue;
  *bytes = static_cast<size_t>(need);
  return cudaSuccess;
}

bool bad_dims(int T, int B, int S) { return T < 1 || B < 0 || S < 1; }

}  // namespace

// em [T, B, S], skip [B, S] (1.0 where the s-2 transition is allowed) ->
// alphas [T, B, S]; all f32, contiguous.  global_state is null, or a
// [B, 2, S] f32 scratch that the wrapper passes where 2*S floats exceed
// nbasr_ctc_shared_state_bytes().
extern "C" int nbasr_ctc_alpha(int T, int B, int S, const float* em, const float* skip,
                               float* alphas, float* global_state, void* stream) {
  if (bad_dims(T, B, S)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  size_t smem = 0;
  cudaError_t err = state_bytes(S, global_state, &smem);
  if (err != cudaSuccess) return err;
  nbasr_ctc_alpha<<<static_cast<unsigned>(B), block_threads(S), smem,
                    static_cast<cudaStream_t>(stream)>>>(em, skip, alphas, global_state, T, B, S);
  return cudaGetLastError();
}

// em [T, B, S], skip_next [B, S] (skip[s+2], pre-shifted; 0 in the last two
// states), final_states [B, S] (1.0 on the states a path may end in) ->
// betas [T, B, S]; global_state as for nbasr_ctc_alpha.
extern "C" int nbasr_ctc_beta(int T, int B, int S, const float* em, const float* skip_next,
                              const float* final_states, float* betas, float* global_state,
                              void* stream) {
  if (bad_dims(T, B, S)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  size_t smem = 0;
  cudaError_t err = state_bytes(S, global_state, &smem);
  if (err != cudaSuccess) return err;
  nbasr_ctc_beta<<<static_cast<unsigned>(B), block_threads(S), smem,
                   static_cast<cudaStream_t>(stream)>>>(em, skip_next, final_states, betas,
                                                        global_state, T, B, S);
  return cudaGetLastError();
}

extern "C" long long nbasr_ctc_shared_state_bytes() { return kSharedStateBytes; }

extern "C" const char* nbasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
