// The JAX package's log_add in f32, shared by the CTC recursions (ctc.cu)
// and the probe of their step (ctc_probe.cu): mx = max(a, b), 0 where
// mx <= -1e30, then mx + log(exp(a - mx) + exp(b - mx)), with the accurate
// expf and logf.

#pragma once

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float log_add(float a, float b) {
  float mx = fmaxf(a, b);
  if (mx <= kNegInf) mx = 0.0f;
  return mx + logf(expf(a - mx) + expf(b - mx));
}

}  // namespace
