// SURF features off the SAT's phase planes, shared by the SCD kernels K1
// (scd_cascade.cu, the whole cascade with early exit) and K3 (scd_phase.cu,
// a run of stages over every window with no early exit).
//
// Layout: an octave's SAT as step x step phase planes, (L, step*step, 8, hs,
// ws) float32, planes[l, py*step + px, c, h, w] = sat[l, c, h*step + py,
// w*step + px] (ccv_tpu's _planes_cf; the wrappers make them with one copy,
// ops/kernels/scd_cascade.py kernel_planes). Window (wy, wx), corner (oy,
// ox) reads plane (oy % step)*step + ox % step at row wy + oy / step,
// column wx + ox / step: the same corner of neighbouring windows is
// neighbouring floats, so a warp's 32 windows of one row read each corner
// channel as one 128-byte line.
//
// A feature's corner record (kRecInts ints, made by CascadeTables.records)
// is its layout, then the float offsets in a level's planes (plane * 8 * hs
// * ws + row * ws + column) of the corners the layout's slots name.

#pragma once

#include <cuda_runtime.h>

#include "scd_feature.cuh"

namespace scd {

constexpr int kRecInts = 17;  // per feature: layout, 16 corner offsets

// Box layouts. A layout gives, for the 16 box corners in box order and in
// each box the order (sy,sx), (sy,dx), (dy,sx), (dy,dx), the index of the
// corner in the feature's corner list, 4 bits each, corner 0 lowest. Layout
// 0 reads the 16 box corners as they come (any feature); layouts 1.. are
// SCD's generator layouts with their distinct corners, defined once, in
// ops/kernels/scd_cascade.py LAYOUTS, which the build passes in as
// SCD_LAYOUT_SLOTS (SCD_SLOT(code) for each, no commas: nvcc splits a -D
// value at them). Compiled in, so a feature's corners stay in registers.
#ifndef SCD_LAYOUT_SLOTS
#error "SCD_LAYOUT_SLOTS is set by the build (ops/kernels/scd_cascade.py)"
#endif
#define SCD_SLOT(code) code,
__host__ __device__ constexpr unsigned long long layout_code(int l) {
  const unsigned long long codes[] = {0xfedcba9876543210ull,
                                      SCD_LAYOUT_SLOTS};
  return codes[l];
}
__host__ __device__ constexpr int n_layouts() {
  const unsigned long long codes[] = {0, SCD_LAYOUT_SLOTS};
  return sizeof(codes) / sizeof(codes[0]);
}

__host__ __device__ constexpr int layout_slot(unsigned long long code, int i) {
  return (int)((code >> (4 * i)) & 15ull);
}
__host__ __device__ constexpr int layout_corners(unsigned long long code) {
  int n = 0;
  for (int i = 0; i < 16; ++i)
    n = layout_slot(code, i) + 1 > n ? layout_slot(code, i) + 1 : n;
  return n;
}

template <int L>
struct Layout {
  static constexpr unsigned long long kSlots = layout_code(L);
  static constexpr int kCorners = layout_corners(kSlots);
};

// The responses of a feature of layout L at R windows, off phase planes:
// window r's float in a plane is lvl[at[r]], channel c of the same plane
// lies c * chan floats further, and the feature's corners lie
// offs[0 .. kCorners-1] floats from there. Every corner of every window is
// loaded before the first response is computed, so the R windows' loads are
// in flight together. Weights and bias `wf` as for box_response, read
// through the read-only cache (the same words for the R windows).
template <int L, int R>
__device__ __forceinline__ void feature_response_planes(
    const float* __restrict__ lvl, const int (&at)[R], int chan,
    const int* offs, const float* wf, float (&resp)[R]) {
  constexpr int kN = Layout<L>::kCorners;
  constexpr unsigned long long kS = Layout<L>::kSlots;
  int off[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) off[k] = offs[k];
  float val[R][4][kChannels];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      float cv[kN];
#pragma unroll
      for (int k = 0; k < kN; ++k)
        cv[k] = __ldg(lvl + at[r] + off[k] + c * chan);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        val[r][b][c] = ((cv[layout_slot(kS, 4 * b)] -
                         cv[layout_slot(kS, 4 * b + 1)]) -
                        cv[layout_slot(kS, 4 * b + 2)]) +
                       cv[layout_slot(kS, 4 * b + 3)];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) resp[r] = box_response(val[r], wf);
}

// The responses of feature `rec` (its record, in shared memory) at R
// windows: layout L, or one below it. The same feature across the warp: no
// divergence.
template <int L, int R>
__device__ __forceinline__ void feature_at(const float* __restrict__ lvl,
                                           const int (&at)[R], int chan,
                                           const int* rec, const float* wf,
                                           float (&resp)[R]) {
  if constexpr (L == 0) {
    feature_response_planes<0, R>(lvl, at, chan, rec + 1, wf, resp);
  } else {
    if (rec[0] == L)
      feature_response_planes<L, R>(lvl, at, chan, rec + 1, wf, resp);
    else
      feature_at<L - 1, R>(lvl, at, chan, rec, wf, resp);
  }
}

}  // namespace scd
