// Phase A of the staged SCD cascade: the leading stages over every
// stride-`step` window of every pyramid level of one octave, in one launch,
// with no early exit. Hopper (sm_90a) port of the Pallas TPU kernel built in
// ccv_tpu/ops/pallas/scd_phase.py (_get_phase_a_call, entry phase_a);
// reference hot loop ccv_scd.c:1719-1768.
//
// What it computes, per window (wy, wx) of level l: every feature of every
// phase-A stage (scd_feature.cuh, the math K1 runs), summed per stage.
// Unlike the full-cascade kernel (scd_cascade.cu) a window never stops
// early:
//   conf   = the LAST stage's sum, for every window;
//   passed = AND over the stages of (sum > threshold).
// Windows outside the level's (ny, nx) grid get conf 0, passed 0.
//
// Layout: as scd_cascade.cu. sat is the (L, 8, H1, W1) float32 stack of one
// octave's SATs, zero-padded to the largest level; window (wy, wx), corner
// (oy, ox) reads sat[l, c, wy*step + oy, wx*step + ox]. The TPU kernel's
// phase planes and static corner slices were a lane layout for the TPU.
//
// Design: one thread per window, blocks of 32 x 4 windows, blockIdx.z the
// level, each level's real (ny, nx) from a small device array. The Pallas
// kernel unrolled the phase's features at trace time with the weights as
// constants; here no feature count is compiled in: each block first copies
// the phase's tables (per feature 16 corner ints + 32 weights + bias, per
// stage its end and threshold: 196 B a feature, 2.4 KB for the face
// cascade's 12) into dynamic shared memory, and every thread of a warp then
// reads the same word, a broadcast.
//
// Bound on the card: the SAT bytes read, as for K1. Each feature reads 16
// corners x 8 channels x 4 B = 512 B per window; neighbouring threads read
// addresses step * 4 = 16 B apart, so a warp's load touches 512 B of which
// it uses 128 B and leans on L1/L2 reuse between overlapping windows (44 of
// 48 columns shared at step 4). With no early exit every window pays every
// phase-A feature. A later PR would stage each block's SAT tile (its 32 x 4
// windows plus the 48-pixel corner extent, 8 channels) in shared memory with
// TMA and share a feature's corners across its boxes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scd_feature.cuh"

namespace {

using scd::kBoxInts;
using scd::kChannels;
using scd::kFeatFloats;

constexpr int kBlockX = 32;
constexpr int kBlockY = 4;
constexpr int kThreads = kBlockX * kBlockY;

__global__ void __launch_bounds__(kThreads)
scd_phase_a_kernel(const float* __restrict__ sat, int H1, int W1,
                   const int* __restrict__ dims,
                   const int* __restrict__ stage_end,
                   const float* __restrict__ thresholds, int n_stages,
                   const int* __restrict__ boxes,
                   const float* __restrict__ feats, int n_features, int step,
                   int NY, int NX, float* __restrict__ conf,
                   uint8_t* __restrict__ passed) {
  // shared tables: feats | thresholds | boxes | stage_end (4-byte words)
  extern __shared__ float smem[];
  float* s_feats = smem;
  float* s_th = s_feats + n_features * kFeatFloats;
  int* s_boxes = reinterpret_cast<int*>(s_th + n_stages);
  int* s_end = s_boxes + n_features * kBoxInts;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int i = tid; i < n_features * kFeatFloats; i += kThreads)
    s_feats[i] = __ldg(feats + i);
  for (int i = tid; i < n_features * kBoxInts; i += kThreads)
    s_boxes[i] = __ldg(boxes + i);
  for (int i = tid; i < n_stages; i += kThreads) {
    s_th[i] = __ldg(thresholds + i);
    s_end[i] = __ldg(stage_end + i);
  }
  __syncthreads();

  const int l = blockIdx.z;
  const int wx = blockIdx.x * kBlockX + threadIdx.x;
  const int wy = blockIdx.y * kBlockY + threadIdx.y;
  if (wx >= NX || wy >= NY) return;
  const size_t out = ((size_t)l * NY + wy) * NX + wx;
  if (wy >= __ldg(dims + 2 * l) || wx >= __ldg(dims + 2 * l + 1)) {
    conf[out] = 0.f;
    passed[out] = 0;
    return;
  }
  const size_t plane = (size_t)H1 * W1;
  const float* base = sat + (size_t)l * kChannels * plane +
                      (size_t)wy * step * W1 + (size_t)wx * step;
  float vs = 0.f;
  bool alive = true;
  int f = 0;
  for (int s = 0; s < n_stages; ++s) {
    const int f1 = s_end[s];
    vs = 0.f;
    for (; f < f1; ++f) {
      vs = vs + scd::feature_response<false>(base, plane, W1,
                                             s_boxes + f * kBoxInts,
                                             s_feats + f * kFeatFloats);
    }
    alive = alive && (vs > s_th[s]);
  }
  conf[out] = vs;
  passed[out] = alive ? 1 : 0;
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of CUDA device `device`
// and returns the first CUDA error as an int (0 = launched).
extern "C" int scd_phase_a_levels(int device, const float* sat, int L, int H1,
                                  int W1, const int* dims, int NY, int NX,
                                  const int* stage_end,
                                  const float* thresholds, int n_stages,
                                  const int* boxes, const float* feats,
                                  int n_features, int step, float* conf,
                                  uint8_t* passed, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      (size_t)n_features * (kFeatFloats + kBoxInts) * 4 + (size_t)n_stages * 8;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(scd_phase_a_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((NX + kBlockX - 1) / kBlockX, (NY + kBlockY - 1) / kBlockY,
                  L);
  scd_phase_a_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      sat, H1, W1, dims, stage_end, thresholds, n_stages, boxes, feats,
      n_features, step, NY, NX, conf, passed);
  return (int)cudaGetLastError();
}
