// One SURF feature's response at one window from its box values: the
// per-feature math shared by the SCD kernels, K1 (scd_cascade.cu, the whole
// cascade with early exit, port of ccv_tpu/ops/pallas/scd_cascade.py
// _get_cascade_call) and K3 (scd_phase.cu, a run of stages over every
// window with no early exit, port of ccv_tpu/ops/pallas/scd_phase.py
// _get_phase_a_call). Both fetch the box values off the SAT's phase planes
// (scd_planes.cuh).
//
// 4 SURF boxes x 8 channels, each read off the zero-padded SAT as
// c0 - c1 - c2 + c3; L2Hys (norm + 1e-6, clip to +-2/sqrt(32), renorm); dot
// with 32 weights + bias; tanh(0.5 * logit).
//
// Numerics follow the JAX op order: each box ((c0 - c1) - c2) + c3, squares
// summed over boxes then channels, IEEE sqrt and division (no fast math),
// and __fmul_rn wherever the reference multiplies and then adds, so no FMA
// contraction changes the rounding. tanhf is CUDA's (2 ulp). K1 and K3
// share this code and the fetch, so they give the same stage sums.

#pragma once

#include <cuda_runtime.h>

namespace scd {

constexpr int kChannels = 8;
constexpr int kFeatFloats = 33;  // per feature: w[box * 8 + channel], bias
constexpr float kTheta = 0.35355339059327373f;  // 2 / sqrt(32)

__device__ __forceinline__ float clip_theta(float v) {
  return fminf(fmaxf(v, -kTheta), kTheta);
}

// The response of a feature from its box values val[box][channel] and its
// weights and bias `wf` (kFeatFloats floats in device memory, read through
// the read-only cache).
__device__ __forceinline__ float box_response(const float (&val)[4][kChannels],
                                              const float* wf) {
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    float q = __fmul_rn(val[0][c], val[0][c]);
#pragma unroll
    for (int b = 1; b < 4; ++b) q = q + __fmul_rn(val[b][c], val[b][c]);
    ss = ss + q;
  }
  const float inv = 1.0f / (sqrtf(ss) + 1e-6f);
  float ss2 = 0.f, dot = 0.f;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    float q2 = 0.f, acc = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float u = clip_theta(__fmul_rn(val[b][c], inv));
      q2 = q2 + __fmul_rn(u, u);
      acc = acc + __fmul_rn(u, __ldg(wf + b * kChannels + c));
    }
    ss2 = ss2 + q2;
    dot = dot + acc;
  }
  const float inv2 = 1.0f / (sqrtf(ss2) + 1e-6f);
  const float logit = __fmul_rn(dot, inv2) + __ldg(wf + 32);
  return tanhf(0.5f * logit);
}

}  // namespace scd
