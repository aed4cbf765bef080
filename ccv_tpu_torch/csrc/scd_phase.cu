// A run of stages of the SCD cascade over every stride-`step` window of
// every pyramid level of one octave, in one launch, with no early exit: the
// staged cascade's phase A (its leading stages) and, on the same kernel,
// its phase B1 (the next block of stages). Hopper (sm_90a) port of the
// Pallas TPU kernel built in ccv_tpu/ops/pallas/scd_phase.py
// (_get_phase_a_call, entry phase_a); reference hot loop
// ccv_scd.c:1719-1768.
//
// What it computes, per window (wy, wx) of level l: every feature of every
// stage of the run (scd_feature.cuh, the math K1 runs), summed per stage in
// feature order. Unlike the full-cascade kernel (scd_cascade.cu) a window
// never stops early:
//   conf   = the LAST stage's sum, for every window;
//   passed = AND over the stages of (sum > threshold).
// Windows outside the level's (ny, nx) grid get conf 0, passed 0.
//
// Layout: the octave's SAT as step x step phase planes with the corner
// records and box layouts of scd_planes.cuh, the input K1 reads. The
// staged cascade makes the planes once per octave and passes them to both
// of its launches (phase A and B1), so their copy is paid once.
//
// Bound on this card, for the face cascade at the 1080p level 0: phase A
// (12 features) by its bytes, the SAT read once (66.5 MB: 0.020 ms at 3.35
// TB/s); phase B1 (49 features) by its FP32 operations (2.43 GFLOP: 0.036
// ms at 67 TFLOP/s). The thread-per-window kernel this replaces read the
// channels-first SAT with 16 bytes between neighbouring threads, so a warp
// load of one corner used a quarter of each sector it touched, and it read
// all 16 box corners of a feature where 9 or 10 are distinct. What this
// design does:
//   - bytes: a warp's 32 windows of one tile row read each corner channel
//     off the phase planes as one 128-byte line, and each feature of SCD's
//     three box layouts reads its distinct corners once;
//   - operations: every thread stays busy (no window leaves early, so there
//     is nothing to compact), on kRows windows of neighbouring tile rows (a
//     feature's record, layout branch and weights serve all of them, and
//     their corner loads are in flight together). On the card one window a
//     thread (80 registers, no spills; 8 warps a block, 3 blocks a SM) beat
//     2 and 4 windows: their registers cost more occupancy, or spills, than
//     their shared loads saved (PERF.md);
//   - tables: each block copies the corner records (17 ints a feature) into
//     shared memory in runs of kChunk features, so any number of features
//     runs and a stage may straddle two runs; weights and biases stay in
//     device memory, read with warp-uniform __ldg.
// Tile, windows a thread and blocks a SM were chosen on the card
// (python -m ccv_tpu_torch.bin.k3_tile_trial, PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scd_feature.cuh"
#include "scd_planes.cuh"

namespace {

using scd::kChannels;
using scd::kFeatFloats;
using scd::kRecInts;

constexpr int kTileX = 32;  // windows along a tile row: one warp
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 1;    // windows a thread, in neighbouring tile rows
constexpr int kTileY = kWarps * kRows;
constexpr int kBlocksPerSm = 3;
// features whose records a block holds in shared memory at once (34.8 KB;
// 3 blocks a SM take 104 KB); a longer run of stages is staged in runs of
// this many
constexpr int kChunk = 512;

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
scd_phase_a_kernel(const float* __restrict__ planes, int n_planes, int hs,
                   int ws, const int* __restrict__ dims,
                   const int* __restrict__ stage_end,
                   const float* __restrict__ thresholds, int n_stages,
                   const int* __restrict__ recs, int n_features,
                   const float* __restrict__ feats, int NY, int NX,
                   float* __restrict__ conf, uint8_t* __restrict__ passed) {
  extern __shared__ int s_recs[];  // records of features [res0, res1)
  const int l = blockIdx.z;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const int gx = x0 + threadIdx.x % 32;
  const int gy = y0 + threadIdx.x / 32 * kRows;  // the thread's first row
  const int ny = __ldg(dims + 2 * l), nx = __ldg(dims + 2 * l + 1);
  const int chan = hs * ws;
  const float* lvl = planes + (size_t)l * n_planes * kChannels * chan;

  // a window outside the level's grid reads window (0, 0) and is dropped
  int at[kRows];
  bool live[kRows], any = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    live[r] = gy + r < ny && gx < nx;
    any = any || live[r];
    at[r] = live[r] ? (gy + r) * ws + gx : 0;
  }
  const bool warp_live = __any_sync(0xffffffffu, any);
  float vs[kRows];
  bool ok[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    vs[r] = 0.f;
    ok[r] = true;
  }
  if (y0 < ny && x0 < nx) {  // block-uniform: the tile holds a window
    int f = 0, res0 = 0, res1 = 0;  // all block-uniform
    for (int s = 0; s < n_stages; ++s) {
      const int f1 = __ldg(stage_end + s);
#pragma unroll
      for (int r = 0; r < kRows; ++r) vs[r] = 0.f;
      for (int g0 = f; g0 < f1;) {
        if (g0 >= res1) {  // stage the next run of records
          __syncthreads();
          res0 = g0;
          res1 = min(n_features, g0 + kChunk);
          for (int i = threadIdx.x; i < (res1 - res0) * kRecInts;
               i += kThreads)
            s_recs[i] = __ldg(recs + res0 * kRecInts + i);
          __syncthreads();
        }
        const int g1 = min(f1, res1);
        if (warp_live) {
          for (int g = g0; g < g1; ++g) {
            float rsp[kRows];
            scd::feature_at<scd::n_layouts() - 1, kRows>(
                lvl, at, chan, s_recs + (g - res0) * kRecInts,
                feats + g * kFeatFloats, rsp);
#pragma unroll
            for (int r = 0; r < kRows; ++r) vs[r] = vs[r] + rsp[r];
          }
        }
        g0 = g1;
      }
      const float th = __ldg(thresholds + s);
#pragma unroll
      for (int r = 0; r < kRows; ++r) ok[r] = ok[r] && vs[r] > th;
      f = f1;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (gy + r < NY && gx < NX) {
      const size_t out = ((size_t)l * NY + gy + r) * NX + gx;
      conf[out] = live[r] ? vs[r] : 0.f;
      passed[out] = live[r] && ok[r] ? 1 : 0;
    }
  }
}

}  // namespace

// planes (L, n_planes, 8, hs, ws) float32; recs (F, 17) int32; feats
// (F, 33) float32 (K1's interface). Launches the kernel on `stream` (a
// cudaStream_t) of CUDA device `device` and returns the first CUDA error as
// an int (0 = launched).
extern "C" int scd_phase_a_levels(int device, const float* planes, int L,
                                  int n_planes, int hs, int ws,
                                  const int* dims, int NY, int NX,
                                  const int* stage_end,
                                  const float* thresholds, int n_stages,
                                  const int* recs, int n_features,
                                  const float* feats, float* conf,
                                  uint8_t* passed, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      (size_t)(n_features < kChunk ? n_features : kChunk) * kRecInts *
      sizeof(int);
  const dim3 grid((NX + kTileX - 1) / kTileX, (NY + kTileY - 1) / kTileY, L);
  scd_phase_a_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      planes, n_planes, hs, ws, dims, stage_end, thresholds, n_stages, recs,
      n_features, feats, NY, NX, conf, passed);
  return (int)cudaGetLastError();
}
