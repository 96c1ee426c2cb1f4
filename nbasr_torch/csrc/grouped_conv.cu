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
// Design, simple first:
//   forward, dx: one thread per (b, t, g), g fastest, holding up to kOut
//     outputs of its group (co for the forward, ci for dx) in registers;
//     the K*ci (K*co) activations of its window and the weights are read
//     through L1, where the threads of a warp share them.
//   dW: one thread per (k, c, g) and row chunk, holding up to kOut partial
//     sums over the chunk's (b, t) rows; a second pass sums the chunks in
//     order.  No float atomics, so two runs give the same bits.
// Each entry point returns the first cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// grid (ceil(K*ci*G / kThreads), chunks): thread = (k, c, g), g fastest, over
// the rows [first, last) of its chunk; partial sums into
// part[chunk][k][c][g*co + o], the [K, ci, C_out] layout per chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    nbasr_gconv_dw_partials(const T* __restrict__ x, View xv, const T* __restrict__ dz, View zv,
                            float* __restrict__ part, long long rows, int t_len, int groups, int ci,
                            int co, int K, int d, int lpad) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long kcg = static_cast<long long>(K) * ci * groups;
  if (i >= kcg) return;
  const int g = static_cast<int>(i % groups);
  const int kc = static_cast<int>(i / groups);
  const int c = kc % ci, k = kc / ci;
  const long long first = rows * blockIdx.y / gridDim.y;
  const long long last = rows * (blockIdx.y + 1) / gridDim.y;
  const long long c_out = static_cast<long long>(groups) * co;
  float* out = part + (static_cast<long long>(blockIdx.y) * K * ci + kc) * c_out +
               static_cast<long long>(g) * co;
  const T* xg = x + c * xv.c + g * xv.g;
  const T* zg = dz + g * zv.g;
  for (int o0 = 0; o0 < co; o0 += kOut) {
    float acc[kOut];
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[j] = 0.0f;
    long long b = first / t_len;
    int t = static_cast<int>(first - b * t_len);
    for (long long r = first; r < last; ++r) {
      const int ts = t + k * d - lpad;
      if (ts >= 0 && ts < t_len) {
        const float xval = load(xg, b * xv.b + ts * xv.t);
        const T* zs = zg + b * zv.b + t * zv.t + o0 * zv.c;
#pragma unroll
        for (int j = 0; j < kOut; ++j)
          if (o0 + j < co) acc[j] += xval * load(zs, j * zv.c);
      }
      if (++t == t_len) {
        t = 0;
        ++b;
      }
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      if (o0 + j < co) out[o0 + j] = acc[j];
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

template <typename T>
int weight_grad(int batch, int t_len, int groups, int ci, int co, int K, int d, int lpad,
                const T* x, View xv, const T* dz, View zv, T* dw, float* work, int chunks,
                cudaStream_t s) {
  const long long n = static_cast<long long>(K) * ci * groups * co;
  const long long rows = static_cast<long long>(batch) * t_len;
  if (rows == 0) return cudaMemsetAsync(dw, 0, sizeof(T) * n, s);
  const dim3 grid(blocks_for(static_cast<long long>(K) * ci * groups), chunks);
  nbasr_gconv_dw_partials<T><<<grid, kThreads, 0, s>>>(x, xv, dz, zv, work, rows, t_len, groups,
                                                       ci, co, K, d, lpad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nb = (n + kThreads - 1) / kThreads;
  nbasr_gconv_dw_reduce<T><<<static_cast<unsigned>(nb < 8192 ? nb : 8192), kThreads, 0, s>>>(
      work, chunks, n, dw);
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
// [B, ci, T, G] view) and dz (a [B, co, T, G] view), summed over the batch;
// work holds chunks * K * ci * G * co floats of partial sums.
extern "C" int nbasr_grouped_conv_dw(int bf16, int batch, int t_len, int groups, int ci, int co,
                                     int K, int d, int lpad, const void* x,
                                     const long long* x_strides, const void* dz,
                                     const long long* dz_strides, void* dw, void* work,
                                     int chunks, void* stream) {
  if (bad_dims(batch, t_len, groups, ci, co, K, d, lpad) || chunks < 1 || chunks > 65535)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto wk = static_cast<float*>(work);
  if (bf16) {
    using T = __nv_bfloat16;
    return weight_grad<T>(batch, t_len, groups, ci, co, K, d, lpad, static_cast<const T*>(x),
                          view(x_strides), static_cast<const T*>(dz), view(dz_strides),
                          static_cast<T*>(dw), wk, chunks, s);
  }
  return weight_grad<float>(batch, t_len, groups, ci, co, K, d, lpad,
                            static_cast<const float*>(x), view(x_strides),
                            static_cast<const float*>(dz), view(dz_strides),
                            static_cast<float*>(dw), wk, chunks, s);
}

extern "C" const char* nbasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
