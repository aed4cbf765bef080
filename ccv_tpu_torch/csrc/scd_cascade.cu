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
// Layout: the octave's SAT as step x step phase planes, read as
// scd_planes.cuh says (shared with K3, scd_phase.cu); the wrapper makes them
// with one copy, hs and ws the rows and columns the windows read.
//
// Bound on this card: the SAT bytes, read once (66.5 MB for the 1080p
// level 0: 0.020 ms at 3.35 TB/s; at open thresholds the FP32 operations,
// 0.24 ms). The thread-per-window kernel this replaces read the SAT
// channels-first at stride 4, so a warp load of one corner touched 16
// sectors and used a quarter of each; it read all 16 corners of a feature
// where 9 or 10 are distinct; and a warp ran a stage while any of its 32
// windows lived, so the late stages (49, 89 and 168 of the 318 features)
// ran on mostly masked warps. What this design does:
//   - phase planes: a warp's 32 windows of one tile row read each corner
//     channel as 32 consecutive floats, one 128-byte line;
//   - each distinct corner of a feature once, in registers, for the three
//     box layouts that SCD's feature generator makes (scd_planes.cuh; 11-13%
//     faster than reading the 16 box corners, PERF.md);
//   - survivor compaction: a block of 4 warps owns a 32 x 4 tile of
//     windows of one level. After every stage it packs the live windows
//     into a shared list with a block prefix sum over their flags, and its
//     threads take the list in order, so each stage runs on as few warps
//     as its live windows fill; the block stops when the list is empty.
//     Each window keeps its last stage sum in shared memory and the block
//     writes conf and passed for its tile at the end. Grid entries outside
//     a level's (ny, nx) get conf 0, not passed.
//   - the late stages are a chain of dependent loads for the few windows
//     left: each block first copies the corner records (17 ints a feature,
//     21.6 KB for the face cascade; a cascade of more than 512 features in
//     runs of 512, so any size runs) into shared memory, so a feature's
//     layout and offsets come from there and only its corner loads go to
//     L2; 5 blocks a SM (96 registers) keep more such chains in flight.
//     Tile, block and blocks a SM were chosen on the card (PERF.md).
// The weights and biases (33 floats a feature) stay in a device buffer
// read with warp-uniform __ldg loads. What is left: a block's SAT strip in
// shared memory (as the TPU kernel's VMEM strip) does not fit here: a
// 32 x 4 tile with its 48-pixel corner extent needs 16 planes x 8 channels
// x 16 x 44 floats = 360 KB, past the 227 KB a block may have; and a
// window that passes deep runs its 318 features one after another.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scd_feature.cuh"
#include "scd_planes.cuh"

namespace {

using scd::kChannels;
using scd::kFeatFloats;
using scd::kRecInts;

constexpr int kTileX = 32;  // windows along a tile row: one warp
constexpr int kTileY = 4;
constexpr int kTile = kTileX * kTileY;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = kTile / kThreads;  // list entries per thread
constexpr int kBlocksPerSm = 5;
// features whose records a block holds in shared memory at once (34.8 KB,
// so 5 blocks fit a SM); a longer cascade is staged in runs of this many
constexpr int kChunk = 512;

// Packs the windows wv[r] whose keep[r] is set (entry r * kThreads + tid of
// the list of n) into list[0 ..], in list order; returns how many. Every
// thread of the block calls it; the list is read before the first barrier.
__device__ __forceinline__ int compact(const bool (&keep)[kRounds],
                                       const int (&wv)[kRounds], int n,
                                       uint16_t* list, int* warp_n) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int total = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (r * kThreads >= n) break;  // the same for every thread
    const unsigned m = __ballot_sync(0xffffffffu, keep[r]);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int before = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_n[w];
      before += w < warp ? c : 0;
      sum += c;
    }
    if (keep[r])
      list[total + before + __popc(m & ((1u << lane) - 1u))] =
          (uint16_t)wv[r];
    total += sum;
    __syncthreads();
  }
  return total;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
scd_cascade_kernel(const float* __restrict__ planes, int n_planes, int hs,
                   int ws, const int* __restrict__ dims,
                   const int* __restrict__ stage_end,
                   const float* __restrict__ thresholds, int n_stages,
                   const int* __restrict__ recs, int n_features,
                   const float* __restrict__ feats, int NY, int NX,
                   float* __restrict__ conf, uint8_t* __restrict__ passed) {
  extern __shared__ int s_recs[];     // records of features [res0, res1)
  __shared__ float s_conf[kTile];     // each window's last stage sum
  __shared__ uint16_t s_list[kTile];  // the live windows, in tile order
  __shared__ uint8_t s_pass[kTile];
  __shared__ int s_warp_n[kWarps];
  const int l = blockIdx.z;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const int ny = __ldg(dims + 2 * l), nx = __ldg(dims + 2 * l + 1);
  const int chan = hs * ws;
  const float* lvl = planes + (size_t)l * n_planes * kChannels * chan;

  // the tile's windows inside the level's grid
  int wv[kRounds];
  bool keep[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int w = r * kThreads + threadIdx.x;
    wv[r] = w;
    keep[r] = y0 + w / kTileX < ny && x0 + w % kTileX < nx;
    s_conf[w] = 0.f;
    s_pass[w] = 0;
  }
  int n = compact(keep, wv, kTile, s_list, s_warp_n);

  int f = 0, res0 = 0, res1 = 0;  // all block-uniform
  for (int s = 0; s < n_stages && n > 0; ++s) {
    const int f1 = __ldg(stage_end + s);
    const float th = __ldg(thresholds + s);
    float vs[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) vs[r] = 0.f;
    for (int g0 = f; g0 < f1;) {
      if (g0 >= res1) {  // stage the next run of records
        __syncthreads();
        res0 = g0;
        res1 = min(n_features, g0 + kChunk);
        for (int i = threadIdx.x; i < (res1 - res0) * kRecInts; i += kThreads)
          s_recs[i] = __ldg(recs + res0 * kRecInts + i);
        __syncthreads();
      }
      const int g1 = min(f1, res1);
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int i = r * kThreads + threadIdx.x;
        if (i < n) {
          const int w = s_list[i];
          const int at[1] = {(y0 + w / kTileX) * ws + x0 + w % kTileX};
          for (int g = g0; g < g1; ++g) {
            float rsp[1];
            scd::feature_at<scd::n_layouts() - 1, 1>(
                lvl, at, chan, s_recs + (g - res0) * kRecInts,
                feats + g * kFeatFloats, rsp);
            vs[r] = vs[r] + rsp[0];
          }
        }
      }
      g0 = g1;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int i = r * kThreads + threadIdx.x;
      keep[r] = false;
      if (i < n) {
        const int w = s_list[i];
        wv[r] = w;
        s_conf[w] = vs[r];
        keep[r] = vs[r] > th;
      }
    }
    f = f1;
    n = compact(keep, wv, n, s_list, s_warp_n);
  }
  // n > 0 only if the last stage ran: the list holds the windows that
  // passed every stage
  for (int i = threadIdx.x; i < n; i += kThreads) s_pass[s_list[i]] = 1;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int w = r * kThreads + threadIdx.x;
    const int gy = y0 + w / kTileX, gx = x0 + w % kTileX;
    if (gy < NY && gx < NX) {
      const size_t out = ((size_t)l * NY + gy) * NX + gx;
      conf[out] = s_conf[w];
      passed[out] = s_pass[w];
    }
  }
}

}  // namespace

// planes (L, n_planes, 8, hs, ws) float32; recs (F, 17) int32; feats
// (F, 33) float32. Launches the kernel on `stream` (a cudaStream_t) of CUDA
// device `device` and returns the first CUDA error as an int (0 =
// launched).
extern "C" int scd_cascade_levels(int device, const float* planes, int L,
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
  scd_cascade_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      planes, n_planes, hs, ws, dims, stage_end, thresholds, n_stages, recs,
      n_features, feats, NY, NX, conf, passed);
  return (int)cudaGetLastError();
}
