// A probe of the CTC recursions' step on one warp, for
// nbasr_torch/tools/ctc_probe.py: n independent chains a lane, each step two
// log_adds one after the other and an add, as a label state's step in ctc.cu
// (the same log_add).  No memory traffic inside the loop, so the time a step
// is the chain's latency (n = 1) or the warp's instruction rate (n large).

#include <cuda_runtime.h>

#include "ctc_log_add.cuh"

namespace {

template <int N>
__global__ void chains(float* out, int T) {
  float a[N], b[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] = -3.0f - i - 0.01f * threadIdx.x;
    b[i] = -4.0f + 0.5f * i;
  }
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float v = log_add(log_add(a[i], b[i]), b[i]);
      b[i] = a[i];
      a[i] = v + 0.25f;
    }
  }
  float r = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) r += a[i];
  out[threadIdx.x] = r;
}

}  // namespace

// One warp, n chains a lane (1, 2, 4 or 8), T steps; the cudaError_t of
// the launch.
extern "C" int nbasr_ctc_probe(int n, int T, float* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: chains<1><<<1, 32, 0, s>>>(out, T); break;
    case 2: chains<2><<<1, 32, 0, s>>>(out, T); break;
    case 4: chains<4><<<1, 32, 0, s>>>(out, T); break;
    case 8: chains<8><<<1, 32, 0, s>>>(out, T); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
