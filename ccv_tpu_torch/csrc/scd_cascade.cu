// Full SCD cascade over every stride-`step` window of every pyramid level
// of one octave, in one launch. Hopper (sm_90a) port of the Pallas TPU
// kernel built in ccv_tpu/ops/pallas/scd_cascade.py (_get_cascade_call,
// entries cascade_eval_levels / cascade_eval); reference hot loop
// ccv_scd.c:1719-1768.
//
// What it computes, per window (wy, wx) of level l, per feature:
//   4 SURF boxes x 8 channels, each read off the zero-padded SAT as
//   c0 - c1 - c2 + c3; L2Hys (norm + 1e-6, clip to +-2/sqrt(32), renorm);
//   dot with 32 weights + bias; tanh(0.5 * logit); summed per stage and
//   compared with the stage threshold. A window stops at the first stage
//   it fails. conf = the sum of the last stage evaluated, passed = all
//   stages passed.
//
// Layout: sat is the (L, 8, H1, W1) float32 stack of one octave's SATs,
// zero-padded to the octave's largest level; window (wy, wx), corner
// (oy, ox) reads sat[l, c, wy*step + oy, wx*step + ox]. The TPU kernel's
// (step*step) phase planes were a lane layout for the TPU and are gone.
//
// Design: one thread per window, blocks of 32 x 4 windows, blockIdx.z is
// the level and each level's real (ny, nx) comes from a small device
// array, so one launch serves the whole octave. The per-thread stage loop
// breaks when the window dies; a warp retires once all 32 of its windows
// are dead, which takes the place of the TPU's per-(8, 128)-block skip.
// The cascade tables (318 features x (16 corner ints + 33 floats) = 62 KB
// for the face cascade) live in device buffers read with warp-uniform
// __ldg loads: every thread of a warp reads the same address. Unlike
// __constant__ memory they have no 64 KB limit and no per-module state, so
// two cascades can be in flight at once.
//
// Bound on the card: the SAT bytes read. Each feature reads 16 corners x
// 8 channels x 4 B = 512 B per window. Neighbouring threads read addresses
// step * 4 = 16 B apart, so a warp's load touches 512 B of which it uses
// 128 B: poorly coalesced, and it leans on L1/L2 reuse, since windows 4
// pixels apart overlap in 44 of their 48 columns. A level-0 SAT at 1080p
// is 8 x 1081 x 1921 x 4 B = 66 MB, more than the 50 MB L2. The early exit
// keeps most windows to the first stages (12 features); shared-memory SAT
// tiles (TMA) are the next step.
//
// The per-feature math and its numerics are in scd_feature.cuh, shared
// with the phase-A kernel (scd_phase.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scd_feature.cuh"

namespace {

using scd::kBoxInts;
using scd::kChannels;
using scd::kFeatFloats;

constexpr int kBlockX = 32;
constexpr int kBlockY = 4;

__global__ void __launch_bounds__(kBlockX * kBlockY)
scd_cascade_kernel(const float* __restrict__ sat, int H1, int W1,
                   const int* __restrict__ dims,
                   const int* __restrict__ stage_end,
                   const float* __restrict__ thresholds, int n_stages,
                   const int* __restrict__ boxes,
                   const float* __restrict__ feats, int step, int NY,
                   int NX, float* __restrict__ conf,
                   uint8_t* __restrict__ passed) {
  const int l = blockIdx.z;
  const int wx = blockIdx.x * kBlockX + threadIdx.x;
  const int wy = blockIdx.y * kBlockY + threadIdx.y;
  if (wx >= NX || wy >= NY) return;
  const size_t out = ((size_t)l * NY + wy) * NX + wx;
  const int ny = __ldg(dims + 2 * l);
  const int nx = __ldg(dims + 2 * l + 1);
  if (wy >= ny || wx >= nx) {
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
  for (int s = 0; s < n_stages && alive; ++s) {
    const int f1 = __ldg(stage_end + s);
    vs = 0.f;
    for (; f < f1; ++f) {
      vs = vs + scd::feature_response<true>(base, plane, W1,
                                            boxes + f * kBoxInts,
                                            feats + f * kFeatFloats);
    }
    alive = vs > __ldg(thresholds + s);
  }
  conf[out] = vs;
  passed[out] = alive ? 1 : 0;
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of CUDA device
// `device` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int scd_cascade_levels(int device, const float* sat, int L, int H1,
                                  int W1, const int* dims, int NY, int NX,
                                  const int* stage_end,
                                  const float* thresholds, int n_stages,
                                  const int* boxes, const float* feats,
                                  int step, float* conf, uint8_t* passed,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((NX + kBlockX - 1) / kBlockX, (NY + kBlockY - 1) / kBlockY,
                  L);
  scd_cascade_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      sat, H1, W1, dims, stage_end, thresholds, n_stages, boxes, feats, step,
      NY, NX, conf, passed);
  return (int)cudaGetLastError();
}
