// One SURF feature's response at one window: the per-feature math shared by
// the SCD kernels, K1 (scd_cascade.cu, the whole cascade with early exit,
// port of ccv_tpu/ops/pallas/scd_cascade.py _get_cascade_call) and K3
// (scd_phase.cu, phase A of the staged cascade, no early exit, port of
// ccv_tpu/ops/pallas/scd_phase.py _get_phase_a_call).
//
// 4 SURF boxes x 8 channels, each read off the zero-padded SAT as
// c0 - c1 - c2 + c3; L2Hys (norm + 1e-6, clip to +-2/sqrt(32), renorm); dot
// with 32 weights + bias; tanh(0.5 * logit).
//
// Two ways to fetch the corners, one response (box_response):
//   feature_response (K3, here): 16 corners, straight off the channels-first
//     SAT (L, 8, H1, W1) at stride `step`; each box reads its own 4.
//   K1's feature_response_planes (scd_cascade.cu): off the SAT's step x step
//     phase planes, where the same corner of 32 neighbouring windows is 32
//     neighbouring floats, and each distinct corner of a feature once.
// Bound: both kernels are bound by the SAT bytes they must read (66.5 MB
// for a 1080p level 0 against 0.02 ms at 3.35 TB/s), K1 at open thresholds
// by its FP32 operations.
//
// Numerics follow the JAX op order: each box ((c0 - c1) - c2) + c3, squares
// summed over boxes then channels, IEEE sqrt and division (no fast math),
// and __fmul_rn wherever the reference multiplies and then adds, so no FMA
// contraction changes the rounding. tanhf is CUDA's (2 ulp). Both fetches
// give the same box values, so K1 and K3 give the same stage sums.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace scd {

constexpr int kChannels = 8;
constexpr int kBoxInts = 16;     // per feature: 4 boxes x (sy, sx, dy, dx)
constexpr int kFeatFloats = 33;  // per feature: w[box * 8 + channel], bias
constexpr float kTheta = 0.35355339059327373f;  // 2 / sqrt(32)

// A word of the cascade tables: through the read-only cache from device
// memory (kLdg), or a plain load from shared memory.
template <bool kLdg, typename T>
__device__ __forceinline__ T table_word(const T* p) {
  if constexpr (kLdg) {
    return __ldg(p);
  } else {
    return *p;
  }
}

__device__ __forceinline__ float clip_theta(float v) {
  return fminf(fmaxf(v, -kTheta), kTheta);
}

// The response of a feature from its box values val[box][channel] and its
// weights and bias `wf` (kFeatFloats floats).
template <bool kLdg>
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
      acc = acc + __fmul_rn(u, table_word<kLdg>(wf + b * kChannels + c));
    }
    ss2 = ss2 + q2;
    dot = dot + acc;
  }
  const float inv2 = 1.0f / (sqrtf(ss2) + 1e-6f);
  const float logit = __fmul_rn(dot, inv2) + table_word<kLdg>(wf + 32);
  return tanhf(0.5f * logit);
}

// The response of the feature whose corners are `bx` (kBoxInts ints) and
// whose weights and bias are `wf` (kFeatFloats floats), at the window whose
// corner (0, 0) in channel 0 is `base`; channels lie `plane` floats apart,
// rows W1.
template <bool kLdg>
__device__ __forceinline__ float feature_response(const float* base,
                                                  size_t plane, int W1,
                                                  const int* bx,
                                                  const float* wf) {
  float val[4][kChannels];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int sy = table_word<kLdg>(bx + 4 * b);
    const int sx = table_word<kLdg>(bx + 4 * b + 1);
    const int dy = table_word<kLdg>(bx + 4 * b + 2);
    const int dx = table_word<kLdg>(bx + 4 * b + 3);
    const float* p0 = base + sy * W1 + sx;
    const float* p1 = base + sy * W1 + dx;
    const float* p2 = base + dy * W1 + sx;
    const float* p3 = base + dy * W1 + dx;
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      const size_t o = c * plane;
      val[b][c] = ((__ldg(p0 + o) - __ldg(p1 + o)) - __ldg(p2 + o)) +
                  __ldg(p3 + o);
    }
  }
  return box_response<kLdg>(val, wf);
}

}  // namespace scd
