// Flash attention for Hopper (sm_90a), the "wmma-smem" design: the forward
// (K2a), dq backward (K2b) and dk/dv backward (K2c) at head dim 32 in bf16
// and float16, the one range the other designs leave to it. bf16 and
// float16 at head dim 64, 128 or 256 run the "wgmma-tma" design of
// flash_attention_sm90.cu; float32 at every head dim (D 32 zero-padded to
// 64) and every type above D 256 the mma.sync designs of
// flash_attention_tf32.cu ("tc-f32", "tc-wide"). Port of the Pallas TPU
// kernels in ccv_tpu/ops/pallas/flash_attention.py:
//   K2a  _flash_kernel  (via _flash_fwd_bthd)
//   K2b  _dq_kernel     (via _flash_bwd_bthd)
//   K2c  _dkv_kernel    (via _flash_bwd_bthd)
//
// What they compute, on (BH, T, 32) row-major tensors (bf16 or float16;
// lse and delta are (BH, Tq) f32):
//   s = (q . k) * scale in f32; a key counts if k_pos < Tk and, when causal,
//   k_pos <= q_pos + (Tk - Tq) (the mask is aligned bottom-right). Masked
//   scores are -1e30, as in the Pallas kernel.
//   K2a: online softmax over k-tiles; p is cast to the input type before
//        p @ v; o = acc / l; lse = m + log(l).
//   K2b: p = exp(s - lse) (0 where masked), dp = do . v,
//        ds = p * (dp - delta) * scale, dq = sum over keys of ds @ k.
//   K2c: dv = sum over queries of p^T @ do, dk = sum of ds^T @ q.
//   p and ds are cast to the input type before their products; every
//   product accumulates in f32.
//
// Design. The TPU ran the innermost grid axis in order and carried the
// running state in VMEM scratch. Here the sequential axis is a loop inside
// the block: K2a and K2b take one block per (bh, 64-query tile) and loop
// over 64-key tiles, K2c one block per (bh, 64-key tile) and loops over
// query tiles. Each block has 8 warps. The tiles of q, k, v and do sit in
// shared memory; the products run tile by tile out of shared memory through
// the tensor cores with nvcuda::wmma (16x16x16 fragments, f32
// accumulators). The score tile and the running accumulators (o, dq, dk,
// dv) stay in shared memory in f32, so the softmax rescale and the masks
// are plain per-element code. The loops stop at the causal diagonal: a
// k-tile counts only if j*64 <= i*64 + 63 + (Tk - Tq). Ragged tails are
// masked in the kernel; the tensors are not padded. The split of the
// backward into a dq kernel and a dk/dv kernel needs no atomics, so the
// gradients are deterministic.
//
// Bound on this card. The backward is bound by its operations (K2b causal
// at BH 256, T 1024, D 32 is 25.8 GFLOP on 50 MB: 0.026 ms at 989 TFLOP/s
// bf16). wmma's mma.sync path reaches a fraction of the card's bf16 rate
// (wgmma is the only path to all of it), and every product here
// round-trips its f32 result through shared memory, so shared-memory
// bandwidth and the block barriers between the phases bound the kernels
// before the tensor cores do.
//
// A query row with no valid key (causal with Tq > Tk) is refused by the
// wrapper: the Pallas kernel gives such rows the mean of v over the keys of
// its 512-wide blocks, a value tied to the TPU's block size.
//
// Numerics: no fast math; expf and logf are the IEEE-accurate versions.
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kTile = 64;              // query and key rows per tile
constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;                // padding elements per shared row
constexpr int kLdS = kTile + kPad;     // row stride of a 64x64 score tile
constexpr float kNegInf = -1e30f;      // NEG_INF of the Pallas kernel

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA
}
template <>
__device__ __forceinline__ f16 from_f32<f16>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// C[M][N] (f32, row stride ldc) = (ACC ? C : 0) + A (M x K) * B (K x N).
// A(m, k) is A[m*lda + k] when A_ROW, else A[k*lda + m]; B(k, n) is
// B[k*ldb + n] when B_ROW, else B[n*ldb + k]. A, B and C in shared memory,
// 32-byte aligned; the whole block calls it between barriers.
template <typename T, int M, int N, int K, bool A_ROW, bool B_ROW, bool ACC>
__device__ __forceinline__ void tile_mm(const T* A, int lda, const T* B,
                                        int ldb, float* C, int ldc) {
  using ALayout = std::conditional_t<A_ROW, wmma::row_major, wmma::col_major>;
  using BLayout = std::conditional_t<B_ROW, wmma::row_major, wmma::col_major>;
  constexpr int kNf = N / 16;
  const int warp = threadIdx.x / 32;
  for (int f = warp; f < (M / 16) * kNf; f += kWarps) {
    const int m0 = (f / kNf) * 16, n0 = (f % kNf) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (ACC)
      wmma::load_matrix_sync(c, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, ALayout> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLayout> b;
      wmma::load_matrix_sync(a, A_ROW ? A + m0 * lda + k0 : A + k0 * lda + m0,
                             lda);
      wmma::load_matrix_sync(b, B_ROW ? B + k0 * ldb + n0 : B + n0 * ldb + k0,
                             ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
  }
}

// Rows row0 .. row0+63 of a row-major (rows, D) tensor into a shared tile
// of row stride D + kPad; rows past `rows` are zero. 16-byte copies.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int ldt = D + kPad;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, e = (c % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + e);
    *reinterpret_cast<uint4*>(dst + r * ldt + e) = val;
  }
}

// Rows row0 .. row0+63 of a (rows,) f32 vector; rows past the end are 0.
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int row0, int rows) {
  if (threadIdx.x < kTile)
    dst[threadIdx.x] = row0 + (int)threadIdx.x < rows ? src[row0 + threadIdx.x]
                                                       : 0.f;
}

// A shared f32 accumulator tile (row stride D + kPad) to rows row0.. of a
// row-major (rows, D) tensor of type T, rows past `rows` dropped.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* dst, const float* acc, int row0,
                                           int rows) {
  constexpr int ldt = D + kPad;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (row0 + r < rows)
      dst[(size_t)(row0 + r) * D + d] = from_f32<T>(acc[r * ldt + d]);
  }
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = 0.f;
}

// Whether key k_pos counts for query q_pos (the backward also drops padded
// query rows).
__device__ __forceinline__ bool key_ok(int q_pos, int k_pos, int tk, int diag,
                                       int causal) {
  return k_pos < tk && (!causal || k_pos <= q_pos + diag);
}

// Number of k-tiles a query tile starting at q0 visits.
__device__ __forceinline__ int k_tiles(int q0, int tk, int diag, int causal) {
  const int n = (tk + kTile - 1) / kTile;
  return causal ? min(n, (q0 + kTile - 1 + diag) / kTile + 1) : n;
}

template <typename T, int D>
constexpr size_t fwd_smem() {
  constexpr int ldt = D + kPad;
  return 3 * kTile * ldt * sizeof(T)              // q, k, v
         + kTile * kLdS * sizeof(T)               // p
         + kTile * kLdS * sizeof(float)           // s
         + kTile * ldt * sizeof(float)            // o accumulator
         + 3 * kTile * sizeof(float);             // m, l, corr
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int tq, int tk, float scale,
               int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldt = D + kPad;
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kTile * ldt;
  T* vs = ks + kTile * ldt;
  T* ps = vs + kTile * ldt;
  float* s = reinterpret_cast<float*>(ps + kTile * kLdS);
  float* acc = s + kTile * kLdS;
  float* m_s = acc + kTile * ldt;
  float* l_s = m_s + kTile;

  const int n_qt = (tq + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * kTile;  // long first
  const int diag = tk - tq;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<T, D>(qs, q + (size_t)bh * tq * D, q0, tq);
  zero(acc, kTile * ldt);
  if (threadIdx.x < kTile) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  const int n_kt = k_tiles(q0, tk, diag, causal);
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's products are done
    load_tile<T, D>(ks, kb, k0, tk);
    load_tile<T, D>(vs, vb, k0, tk);
    __syncthreads();
    tile_mm<T, kTile, kTile, D, true, false, false>(qs, ldt, ks, ldt, s, kLdS);
    __syncthreads();
    // online softmax: a warp per row, two keys per lane
    for (int r = warp; r < kTile; r += kWarps) {
      const int q_pos = q0 + r;
      const float s0 = key_ok(q_pos, k0 + lane, tk, diag, causal)
                           ? s[r * kLdS + lane] * scale
                           : kNegInf;
      const float s1 = key_ok(q_pos, k0 + lane + 32, tk, diag, causal)
                           ? s[r * kLdS + lane + 32] * scale
                           : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      const float corr = expf(m_prev - m_new);
      ps[r * kLdS + lane] = from_f32<T>(p0);
      ps[r * kLdS + lane + 32] = from_f32<T>(p1);
      for (int d = lane; d < D; d += 32) acc[r * ldt + d] *= corr;
      __syncwarp();
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    tile_mm<T, kTile, D, kTile, true, true, true>(ps, kLdS, vs, ldt, acc, ldt);
  }
  __syncthreads();
  T* ob = o + (size_t)bh * tq * D;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q0 + r < tq)
      ob[(size_t)(q0 + r) * D + d] =
          from_f32<T>(acc[r * ldt + d] / fmaxf(l_s[r], 1e-30f));
  }
  if (threadIdx.x < kTile && q0 + (int)threadIdx.x < tq)
    lse[(size_t)bh * tq + q0 + threadIdx.x] =
        m_s[threadIdx.x] + logf(fmaxf(l_s[threadIdx.x], 1e-30f));
}

template <typename T, int D>
constexpr size_t dq_smem() {
  constexpr int ldt = D + kPad;
  return 4 * kTile * ldt * sizeof(T)              // q, do, k, v
         + 2 * kTile * kLdS * sizeof(float)       // s, dp
         + kTile * kLdS * sizeof(T)               // ds
         + kTile * ldt * sizeof(float)            // dq accumulator
         + 2 * kTile * sizeof(float);             // lse, delta
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int tq, int tk, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldt = D + kPad;
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kTile * ldt;
  T* ks = dos + kTile * ldt;
  T* vs = ks + kTile * ldt;
  T* dss = vs + kTile * ldt;
  float* s = reinterpret_cast<float*>(dss + kTile * kLdS);
  float* dp = s + kTile * kLdS;
  float* acc = dp + kTile * kLdS;
  float* lse_s = acc + kTile * ldt;
  float* dl_s = lse_s + kTile;

  const int n_qt = (tq + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * kTile;
  const int diag = tk - tq;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  load_tile<T, D>(qs, q + (size_t)bh * tq * D, q0, tq);
  load_tile<T, D>(dos, dout + (size_t)bh * tq * D, q0, tq);
  load_rows_f32(lse_s, lse + (size_t)bh * tq, q0, tq);
  load_rows_f32(dl_s, delta + (size_t)bh * tq, q0, tq);
  zero(acc, kTile * ldt);
  const int n_kt = k_tiles(q0, tk, diag, causal);
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    load_tile<T, D>(ks, kb, k0, tk);
    load_tile<T, D>(vs, vb, k0, tk);
    __syncthreads();
    tile_mm<T, kTile, kTile, D, true, false, false>(qs, ldt, ks, ldt, s, kLdS);
    tile_mm<T, kTile, kTile, D, true, false, false>(dos, ldt, vs, ldt, dp, kLdS);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      const int q_pos = q0 + r;
      const float p = q_pos < tq && key_ok(q_pos, k0 + c, tk, diag, causal)
                          ? expf(s[r * kLdS + c] * scale - lse_s[r])
                          : 0.f;
      dss[r * kLdS + c] = from_f32<T>(p * (dp[r * kLdS + c] - dl_s[r]) * scale);
    }
    __syncthreads();
    tile_mm<T, kTile, D, kTile, true, true, true>(dss, kLdS, ks, ldt, acc, ldt);
  }
  __syncthreads();
  store_tile<T, D>(dq + (size_t)bh * tq * D, acc, q0, tq);
}

template <typename T, int D>
constexpr size_t dkv_smem() {
  constexpr int ldt = D + kPad;
  return 4 * kTile * ldt * sizeof(T)              // k, v, q, do
         + 2 * kTile * kLdS * sizeof(float)       // s, dp; then p, ds
         + 2 * kTile * ldt * sizeof(float)        // dk, dv accumulators
         + 2 * kTile * sizeof(float);             // lse, delta
}

constexpr int kPerThread = kTile * kTile / kThreads;  // score elements

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int tq, int tk,
               float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldt = D + kPad;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kTile * ldt;
  T* qs = vs + kTile * ldt;
  T* dos = qs + kTile * ldt;
  float* s = reinterpret_cast<float*>(dos + kTile * ldt);
  float* dp = s + kTile * kLdS;
  // p and ds, [query][key] in the input type, overwrite s and dp once they
  // are read: 18 KB less shared memory, two blocks per SM in bf16
  T* pss = reinterpret_cast<T*>(s);
  T* dss = reinterpret_cast<T*>(dp);
  float* dk_acc = dp + kTile * kLdS;
  float* dv_acc = dk_acc + kTile * ldt;
  float* lse_s = dv_acc + kTile * ldt;
  float* dl_s = lse_s + kTile;

  const int n_kt = (tk + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (int)(blockIdx.x % n_kt) * kTile;  // causal: long first
  const int diag = tk - tq;
  const T* qb = q + (size_t)bh * tq * D;
  const T* dob = dout + (size_t)bh * tq * D;
  const float* lseb = lse + (size_t)bh * tq;
  const float* dlb = delta + (size_t)bh * tq;

  load_tile<T, D>(ks, k + (size_t)bh * tk * D, k0, tk);
  load_tile<T, D>(vs, v + (size_t)bh * tk * D, k0, tk);
  zero(dk_acc, kTile * ldt);
  zero(dv_acc, kTile * ldt);
  const int n_qt = (tq + kTile - 1) / kTile;
  // causal: the first query tile that reaches key k0 holds q_pos = k0 - diag
  const int i0 = causal ? max(0, k0 - diag) / kTile : 0;
  for (int i = i0; i < n_qt; ++i) {
    const int q0 = i * kTile;
    __syncthreads();
    load_tile<T, D>(qs, qb, q0, tq);
    load_tile<T, D>(dos, dob, q0, tq);
    load_rows_f32(lse_s, lseb, q0, tq);
    load_rows_f32(dl_s, dlb, q0, tq);
    __syncthreads();
    tile_mm<T, kTile, kTile, D, true, false, false>(qs, ldt, ks, ldt, s, kLdS);
    tile_mm<T, kTile, kTile, D, true, false, false>(dos, ldt, vs, ldt, dp, kLdS);
    __syncthreads();
    float pr[kPerThread], dsr[kPerThread];
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      const int idx = threadIdx.x + t * kThreads;
      const int r = idx / kTile, c = idx % kTile;
      const int q_pos = q0 + r;
      pr[t] = q_pos < tq && key_ok(q_pos, k0 + c, tk, diag, causal)
                  ? expf(s[r * kLdS + c] * scale - lse_s[r])
                  : 0.f;
      dsr[t] = pr[t] * (dp[r * kLdS + c] - dl_s[r]) * scale;
    }
    __syncthreads();  // every s and dp is read before p and ds overwrite them
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      const int idx = threadIdx.x + t * kThreads;
      const int r = idx / kTile, c = idx % kTile;
      pss[r * kLdS + c] = from_f32<T>(pr[t]);
      dss[r * kLdS + c] = from_f32<T>(dsr[t]);
    }
    __syncthreads();
    // dv[key][d] += sum_q p[q][key] do[q][d]; dk likewise from ds and q
    tile_mm<T, kTile, D, kTile, false, true, true>(pss, kLdS, dos, ldt, dv_acc,
                                                   ldt);
    tile_mm<T, kTile, D, kTile, false, true, true>(dss, kLdS, qs, ldt, dk_acc,
                                                   ldt);
  }
  __syncthreads();
  store_tile<T, D>(dk + (size_t)bh * tk * D, dk_acc, k0, tk);
  store_tile<T, D>(dv + (size_t)bh * tk * D, dv_acc, k0, tk);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline int n_tiles(int t) { return (t + kTile - 1) / kTile; }

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int tq, int tk, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = fwd_smem<T, D>();
  cudaError_t err = set_smem(fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<T, D><<<bh * n_tiles(tq), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, tq, tk, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int tq,
              int tk, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem<T, D>();
  cudaError_t err = set_smem(dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, D><<<bh * n_tiles(tq), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int bh, int tq, int tk, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = dkv_smem<T, D>();
  cudaError_t err = set_smem(dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<T, D><<<bh * n_tiles(tk), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

// Instantiates the launcher for a 16-bit dtype at head dim 32 or returns
// cudaErrorInvalidValue: 16-bit head dims 64 to 256 run in
// flash_attention_sm90.cu, float32 at every head dim (D 32 zero-padded to
// 64 by the wrappers) and 16-bit above 256 in flash_attention_tf32.cu.
#define FLASH_DISPATCH(dtype, head_dim, LAUNCH, ...)                      \
  do {                                                                    \
    if ((head_dim) != 32) return (int)cudaErrorInvalidValue;              \
    if ((dtype) == 1) return LAUNCH<bf16, 32>(__VA_ARGS__);               \
    if ((dtype) == 2) return LAUNCH<f16, 32>(__VA_ARGS__);                \
    return (int)cudaErrorInvalidValue;                                    \
  } while (0)

}  // namespace

// K2a at 16-bit head dim 32. q (bh, tq, D), k and v (bh, tk, D) -> o (bh,
// tq, D), lse (bh, tq). Above, K2a runs in flash_attention_sm90.cu and
// flash_attention_tf32.cu.
extern "C" int flash_attention_fwd(int device, int dtype, int head_dim,
                                   const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int bh, int tq, int tk, float scale,
                                   int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dtype, head_dim, launch_fwd, q, k, v, o, lse, bh, tq, tk,
                 scale, causal, st);
}

// K2b at 16-bit head dim 32. dout (bh, tq, D), lse and delta (bh, tq) ->
// dq (bh, tq, D).
extern "C" int flash_attention_dq(int device, int dtype, int head_dim,
                                  const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq, int bh,
                                  int tq, int tk, float scale, int causal,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dtype, head_dim, launch_dq, q, k, v, dout, lse, delta, dq,
                 bh, tq, tk, scale, causal, st);
}

// K2c at 16-bit head dim 32. The same inputs -> dk, dv (bh, tk, D).
extern "C" int flash_attention_dkv(int device, int dtype, int head_dim,
                                   const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int bh, int tq, int tk,
                                   float scale, int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dtype, head_dim, launch_dkv, q, k, v, dout, lse, delta, dk,
                 dv, bh, tq, tk, scale, causal, st);
}
