// Flash attention for Hopper (sm_90a) in float32 at head dims 256 to 512,
// the "tc-f32" design: the forward (K2a) and the dk/dv backward (K2c) on the
// tensor cores, their products in three TF32 parts. They replace the
// chunked float32 form of flash_attention.cu (fwd_wide_kernel and
// dkv_wide_kernel) at those head dims; that file keeps the dq backward
// (K2b), float32 above D 512 and 16-bit above D 256. Ports of the Pallas
// TPU kernels in ccv_tpu/ops/pallas/flash_attention.py:
//   K2a  _flash_kernel  (:36, via _flash_fwd_bthd)
//   K2c  _dkv_kernel    (:210, via _flash_bwd_bthd)
//
// What they compute, on (BH, T, D) row-major f32 tensors, D a multiple of
// 64 from 256 to 512 (lse and delta are (BH, Tq) f32), exactly what
// flash_attention.cu computes:
//   s = (q . k) * scale; a key counts if k_pos < Tk and, when causal,
//   k_pos <= q_pos + (Tk - Tq) (bottom-right). Masked scores are -1e30.
//   K2a: online softmax over 64-key tiles; o = acc / max(l, 1e-30);
//        lse = m + log(max(l, 1e-30)).
//   K2c: p = exp(s * scale - lse) (0 where masked or past Tq),
//        dp = do . v, ds = p * (dp - delta) * scale;
//        dv = sum_q p^T do, dk = sum_q ds^T q.
//   p and ds are "rounded to the input type" (float32: unchanged) and every
//   product accumulates in f32.
//
// Bound on this card. At BH 32, T 1024, D 256, causal, K2a does 17.2 GFLOP
// on 0.27 GB and K2c 34.4 GFLOP on 0.54 GB: operations bound them. In
// float32 outside the tensor cores (67 TFLOP/s) that is 0.257 and 0.513 ms;
// the chunked form reached 6% of it, its products FMA loops out of shared
// memory and its accumulators in a global scratch. Here the products run
// on the tensor cores as mma.sync m16n8k8 TF32 in the "3xTF32" split of
// CUTLASS's OpMultiplyAddFastF32 (PyTorch's memory-efficient attention
// uses it for float32): each operand x becomes hi = x rounded to TF32 and
// lo = x - hi (exact in f32; the instruction reads lo's top 19 bits), and
// a b accumulates lo_a hi_b + hi_a lo_b + hi_a hi_b in f32. That keeps
// about 21 of float32's 24 bits per product, against plain TF32's 11, at
// three TF32 products a product: 495 / 3 = 165 TFLOP/s dense at most, the
// "tf32x3" bound of ops/kernels/roofline.py (0.104 and 0.208 ms here).
//
// Design. 256 threads (8 warps) a block; the accumulators stay in
// registers; tiles arrive through cp.async into a ring of stages in shared
// memory, the next stage's copies in flight while this one multiplies, one
// block barrier a stage. Each stage holds up to four 64-row x 64-column
// chunks (row stride 72 floats). Fragments load from shared memory and are
// split in registers; bank-conflict-free: an operand read along D uses
// lane t's columns 2t and 2t+1 as the k-step's k = t and t + 4 (A and B
// permuted alike, 8-byte loads; a row stride of 8 mod 32 words puts the
// 16 lanes of each half-warp on distinct banks), an operand read along the
// sequence a row stride of 8 (B) or 4 (A) mod 32. Blocks are numbered by
// tile first and bh second, the longest (causal) tiles first, so the card,
// which starts blocks in that order, ends with short ones: at one block a
// SM, numbered by bh first, a long block of the last heads ran alone at
// the end.
//   K2a: one block per (bh, 64-query tile, output slice of at most 256
//   columns of D). q (64 x D) is loaded once and stays in shared memory.
//   Per 64-key tile: S = Q K^T from 128-column units of K (warp w: query
//   rows 16 (w/2).., keys 32 (w%2)..: 16 f32 a thread), the online softmax
//   in registers (the two warps of a row band trade row maxima through
//   shared memory; each keeps its own partial row sum, summed at the end),
//   P written once to shared memory (64 x 68) with the row rescale factor,
//   then O += P V from 128-column units of V (warp w: rows 32 (w%2)..,
//   columns 32 (w/2).. of the unit; O is 64 x 256 f32 over the block, 64
//   registers a thread). Above D 256 a second block takes columns 256..
//   and computes S again. 3 stages of 36 KB (2 where q leaves no room).
//   K2c: one block per (bh, 64-key tile, dk/dv slice of at most 256
//   columns): no atomics, deterministic. Per query tile from the first
//   that reaches the keys: S = Q K^T and dP = dO V^T from 64-column units
//   of q, do, k and v (warp w: queries 16 (w/2).., keys 32 (w%2)..),
//   p and ds in registers, written transposed (key-major, 64 x 68) to
//   shared memory, then dV += P^T dO and dK += dS^T Q from 64-column units
//   of do and q (warp w: keys 16 (w%4).., columns 32 (w/4)..; dk and dv
//   are 2 x 64 x 256 f32 over the block, 128 registers a thread). k and v
//   are read again for each query tile (from L2): they and the q and do
//   units do not fit in 227 KB together. 2 stages of 72 KB.
//
// A query row with no valid key (causal with Tq > Tk) is refused by the
// wrapper. Numerics: no fast math; expf and logf are the IEEE-accurate
// versions. Each entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                  // query and key rows per tile
constexpr int kThreads = 256;              // 8 warps
constexpr int kChunk = 64;                 // columns of a staged chunk
constexpr int kLdC = kChunk + 8;           // its row stride (8 mod 32)
constexpr int kChunkFloats = kTile * kLdC;
constexpr int kLdP = kTile + 4;            // P's row stride (4 mod 32)
constexpr int kSlice = 256;                // output columns a block keeps
constexpr int kMinD = 256, kMaxD = 512;
constexpr float kNegInf = -1e30f;          // NEG_INF of the Pallas kernel
constexpr size_t kMaxSmem = 232448;        // a block's shared memory

// ---- primitives --------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));  // 0 bytes read: zero-fill
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo: hi rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32, but in two integer operations: the conversion
// instruction made the kernels slower), lo the exact rest
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA {  // a 16 x 8 A operand, split
  uint32_t hi[4], lo[4];
};
struct FragB {  // an 8 x 8 B operand, split
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in three TF32 products, the small ones first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4): A a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1
// (t + 4, g); C c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, 2t, 2t + 1).

// A from a row-major [m][k] array at (0, 0), k read along D: lane t takes
// columns 2t and 2t + 1 as k = t and t + 4 (load_b_perm reads alike).
__device__ __forceinline__ FragA load_a_perm(const float* s, int ld,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float2 x0 = *reinterpret_cast<const float2*>(s + g * ld + 2 * t);
  const float2 x1 =
      *reinterpret_cast<const float2*>(s + (g + 8) * ld + 2 * t);
  FragA a;
  split(x0.x, a.hi[0], a.lo[0]);
  split(x1.x, a.hi[1], a.lo[1]);
  split(x0.y, a.hi[2], a.lo[2]);
  split(x1.y, a.hi[3], a.lo[3]);
  return a;
}

// B with B(k, n) = s[n * ld + k] (rows of k or v, k read along D), k
// permuted as load_a_perm's.
__device__ __forceinline__ FragB load_b_perm(const float* s, int ld,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float2 x = *reinterpret_cast<const float2*>(s + g * ld + 2 * t);
  FragB b;
  split(x.x, b.hi[0], b.lo[0]);
  split(x.y, b.hi[1], b.lo[1]);
  return b;
}

// A from a row-major [m][k] array at (0, 0), k in order.
__device__ __forceinline__ FragA load_a(const float* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  FragA a;
  split(s[g * ld + t], a.hi[0], a.lo[0]);
  split(s[(g + 8) * ld + t], a.hi[1], a.lo[1]);
  split(s[g * ld + t + 4], a.hi[2], a.lo[2]);
  split(s[(g + 8) * ld + t + 4], a.hi[3], a.lo[3]);
  return a;
}

// B with B(k, n) = s[k * ld + n] (v, do or q read along the sequence).
__device__ __forceinline__ FragB load_b(const float* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  FragB b;
  split(s[t * ld + g], b.hi[0], b.lo[0]);
  split(s[(t + 4) * ld + g], b.hi[1], b.lo[1]);
  return b;
}

// Rows row0 .. row0+63 and columns col0 .. col0+63 of a row-major (rows, d)
// tensor into a shared chunk of row stride kLdC, rows past `rows` zero.
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int row0, int rows, int d,
                                           int col0) {
  for (int c = threadIdx.x; c < kTile * (kChunk / 4); c += kThreads) {
    const int r = c / (kChunk / 4), e = (c % (kChunk / 4)) * 4;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * kLdC + e,
               src + (size_t)(ok ? row0 + r : 0) * d + col0 + e, ok);
  }
}

__device__ __forceinline__ bool key_ok(int q_pos, int k_pos, int tk,
                                       int diag, int causal) {
  return k_pos < tk && (!causal || k_pos <= q_pos + diag);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- K2a ---------------------------------------------------------------

// shared memory of the forward at head dim d with `stages` ring stages
inline size_t fwd_smem(int d, int stages) {
  return sizeof(float) * ((size_t)kTile * (d + 8)         // q
                          + (size_t)stages * 2 * kChunkFloats  // ring
                          + kTile * kLdP                  // p
                          + 2 * kTile                     // row maxima
                          + kTile                         // rescale
                          + 2 * kTile                     // row sums
                          + kTile);                       // m
}

// O (this warp's 32 x 32 of a 128-column unit) += P V: P 64 x 64 (row
// stride kLdP), v the unit's chunk holding the warp's columns.
__device__ __forceinline__ void pv_unit(float (&acc)[2][4][4],
                                        const float* ps, const float* v,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 8) {
    FragA a[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) a[mi] = load_a(ps + mi * 16 * kLdP + kk,
                                                  kLdP, lane);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const FragB b = load_b(v + kk * kLdC + ni * 8, kLdC, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma3(acc[mi][ni], a[mi], b);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int tq, int tk, int d,
                  float scale, int causal, int stages) {
  extern __shared__ __align__(128) float smem[];
  const int ldq = d + 8;
  float* qs = smem;
  float* ring = qs + kTile * ldq;
  float* ps = ring + stages * 2 * kChunkFloats;
  float* pmax = ps + kTile * kLdP;  // [2][64]
  float* corr_s = pmax + 2 * kTile;
  float* lsum = corr_s + kTile;     // [2][64]
  float* m_s = lsum + 2 * kTile;

  // blocks by query tile, the last (the longest when causal) first, then by
  // bh: the card takes them longest first
  const int n_qt = (tq + kTile - 1) / kTile;
  const int n_bh = gridDim.x / n_qt;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / n_bh)) * kTile;
  const int c0 = blockIdx.y * kSlice;          // this block's columns of o
  const int nv = min(kSlice, d - c0);
  const int diag = tk - tq;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  // q, once: its own cp.async group, ahead of the ring's
  const float* qb = q + (size_t)bh * tq * d;
  for (int c = threadIdx.x; c < kTile * (d / 4); c += kThreads) {
    const int r = c / (d / 4), e = (c % (d / 4)) * 4;
    const bool ok = q0 + r < tq;
    cp_async16(qs + r * ldq + e, qb + (size_t)(ok ? q0 + r : 0) * d + e, ok);
  }
  cp_async_commit();

  // units of a key tile: D / 128 of k (128 columns of D each, the last
  // maybe 64), then nv / 128 of v (this block's columns)
  const int n_ku = (d + 127) / 128, n_vu = (nv + 127) / 128;
  const int per_tile = n_ku + n_vu;
  const int n_kt = [&] {
    const int n = (tk + kTile - 1) / kTile;
    return causal ? min(n, (q0 + kTile - 1 + diag) / kTile + 1) : n;
  }();
  const int total = n_kt * per_tile;
  auto fetch = [&](int u) {
    if (u < total) {
      const int k0 = (u / per_tile) * kTile, p = u % per_tile;
      float* st = ring + (u % stages) * 2 * kChunkFloats;
      const bool is_k = p < n_ku;
      const int col = is_k ? p * 128 : c0 + (p - n_ku) * 128;
      const int end = is_k ? d : c0 + nv;
      for (int h = 0; h < 2; ++h)
        if (col + h * kChunk < end)
          load_chunk(st + h * kChunkFloats, is_k ? kb : vb, k0, tk, d,
                     col + h * kChunk);
    }
    cp_async_commit();
  };

  // S-phase roles: query rows 16 * (warp / 2) + g (+ 8), keys 32 * (warp %
  // 2) + 8 n + 2t (+ 1); P V roles: rows 32 * (warp % 2) + 16 mi + g (+ 8),
  // columns 32 * (warp / 2) + 8 ni + 2t (+ 1) of a unit
  const int mq = warp >> 1, kh = warp & 1;
  const int rg = warp & 1, cg = warp >> 1;
  float s[4][4];
  float acc[2][2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][c][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int u = 0; u < stages - 1; ++u) fetch(u);
  for (int u = 0; u < total; ++u) {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // unit u is in; every warp is done with unit u - 1
    fetch(u + stages - 1);
    const float* st = ring + (u % stages) * 2 * kChunkFloats;
    const int k0 = (u / per_tile) * kTile, p = u % per_tile;
    if (p < n_ku) {
      // S += Q K^T over this unit's columns of D
      if (p == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      }
      for (int h = 0; h < 2; ++h) {
        const int col = p * 128 + h * kChunk;
        if (col >= d) break;
        const float* qa = qs + mq * 16 * ldq + col;
        const float* kc = st + h * kChunkFloats + kh * 32 * kLdC;
#pragma unroll
        for (int kk = 0; kk < kChunk; kk += 8) {
          const FragA a = load_a_perm(qa + kk, ldq, lane);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma3(s[n], a, load_b_perm(kc + n * 8 * kLdC + kk, kLdC, lane));
        }
      }
      if (p == n_ku - 1) {
        // online softmax of the tile: mask, row maxima across the warp
        // pair, p to shared memory, the rescale factor of each row
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int q_pos = q0 + mq * 16 + g + 8 * r;
            const int k_pos = k0 + kh * 32 + n * 8 + 2 * t + (e & 1);
            s[n][e] = key_ok(q_pos, k_pos, tk, diag, causal)
                          ? s[n][e] * scale
                          : kNegInf;
            mx[r] = fmaxf(mx[r], s[n][e]);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = quad_max(mx[r]);
          if (t == 0) pmax[kh * kTile + mq * 16 + g + 8 * r] = mx[r];
        }
        __syncthreads();
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = mq * 16 + g + 8 * r;
          const float m_new =
              fmaxf(m_run[r], fmaxf(pmax[row], pmax[kTile + row]));
          corr[r] = expf(m_run[r] - m_new);
          m_run[r] = m_new;
          l_run[r] *= corr[r];
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p0 = expf(s[n][2 * r] - m_run[r]);
            const float p1 = expf(s[n][2 * r + 1] - m_run[r]);
            l_run[r] += p0 + p1;
            *reinterpret_cast<float2*>(
                ps + (mq * 16 + g + 8 * r) * kLdP + kh * 32 + n * 8 +
                2 * t) = make_float2(p0, p1);
          }
        if (kh == 0 && t == 0) {
          corr_s[mq * 16 + g] = corr[0];
          corr_s[mq * 16 + g + 8] = corr[1];
        }
      }
    } else {
      // O += P V over this unit's 128 columns (the warp's 32 of them)
      const int vi = p - n_ku;
      if (vi == 0) {  // the tile's rescale, before its first product
        float cr[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            cr[mi][r] = corr_s[rg * 32 + mi * 16 + g + 8 * r];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[a][mi][ni][e] *= cr[mi][e >> 1];
      }
      if (vi * 128 + cg * 32 < nv) {
        const float* vc = st + (cg >> 1) * kChunkFloats + (cg & 1) * 32;
        const float* pa = ps + rg * 32 * kLdP;
        if (vi == 0)
          pv_unit(acc[0], pa, vc, lane);
        else
          pv_unit(acc[1], pa, vc, lane);
      }
    }
  }

  // row sums over the quad and the warp pair; o = acc / l; lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    const int row = mq * 16 + g + 8 * r;
    if (t == 0) {
      lsum[kh * kTile + row] = l;
      if (kh == 0) m_s[row] = m_run[r];
    }
  }
  __syncthreads();
  float* ob = o + (size_t)bh * tq * d;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rg * 32 + mi * 16 + g + 8 * r;
      if (q0 + row >= tq) continue;
      const float inv =
          1.f / fmaxf(lsum[row] + lsum[kTile + row], 1e-30f);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int col = a * 128 + cg * 32;
        if (col >= nv) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          *reinterpret_cast<float2*>(ob + (size_t)(q0 + row) * d + c0 + col +
                                     ni * 8 + 2 * t) =
              make_float2(acc[a][mi][ni][2 * r] * inv,
                          acc[a][mi][ni][2 * r + 1] * inv);
      }
    }
  if (blockIdx.y == 0 && threadIdx.x < kTile && q0 + (int)threadIdx.x < tq) {
    const float l = fmaxf(lsum[threadIdx.x] + lsum[kTile + threadIdx.x],
                          1e-30f);
    lse[(size_t)bh * tq + q0 + threadIdx.x] = m_s[threadIdx.x] + logf(l);
  }
}

// ---- K2c ---------------------------------------------------------------

constexpr int kDkvStages = 2;
// shared memory of the dk/dv backward: the ring (q, do, k, v chunks a
// stage) and p^T, ds^T
constexpr size_t kDkvSmem =
    sizeof(float) * ((size_t)kDkvStages * 4 * kChunkFloats + 2 * kTile * kLdP);

// dV and dK (this warp's 16 keys x 32 columns of a 64-column unit) +=
// P^T dO and dS^T Q: pt and dst are [key][query] (row stride kLdP) at the
// warp's keys, dO and Q the unit's chunks at the warp's columns.
__device__ __forceinline__ void dkv_unit(float (&dv)[4][4], float (&dk)[4][4],
                                         const float* pt, const float* dst,
                                         const float* dO, const float* qc,
                                         int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 8) {
    const FragA ap = load_a(pt + kk, kLdP, lane);
    const FragA ad = load_a(dst + kk, kLdP, lane);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      mma3(dv[ni], ap, load_b(dO + kk * kLdC + ni * 8, kLdC, lane));
      mma3(dk[ni], ad, load_b(qc + kk * kLdC + ni * 8, kLdC, lane));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    dkv_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int tq, int tk, int d, float scale,
                  int causal) {
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;
  float* pt = ring + kDkvStages * 4 * kChunkFloats;  // p^T [key][query]
  float* dst = pt + kTile * kLdP;                    // ds^T

  // blocks by key tile, the first (the longest when causal) first, then by
  // bh
  const int n_kt = (tk + kTile - 1) / kTile;
  const int n_bh = gridDim.x / n_kt;
  const int bh = blockIdx.x % n_bh;
  const int k0 = (int)(blockIdx.x / n_bh) * kTile;
  const int c0 = blockIdx.y * kSlice;               // this block's columns
  const int nv = min(kSlice, d - c0);
  const int diag = tk - tq;
  const float* qb = q + (size_t)bh * tq * d;
  const float* dob = dout + (size_t)bh * tq * d;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;
  const float* lseb = lse + (size_t)bh * tq;
  const float* dlb = delta + (size_t)bh * tq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  // units of a query tile: D / 64 of (q, do, k, v) for S and dP, then
  // nv / 64 of (q, do) at this block's columns for dV and dK
  const int n_su = d / kChunk, n_pu = nv / kChunk;
  const int per_tile = n_su + n_pu;
  const int n_qt = (tq + kTile - 1) / kTile;
  // causal: the first query tile that reaches key k0 holds q_pos = k0 - diag
  const int i0 = causal ? max(0, k0 - diag) / kTile : 0;
  const int total = max(0, n_qt - i0) * per_tile;
  auto fetch = [&](int u) {
    if (u < total) {
      const int q0 = (i0 + u / per_tile) * kTile, p = u % per_tile;
      float* st = ring + (u % kDkvStages) * 4 * kChunkFloats;
      const int col = p < n_su ? p * kChunk : c0 + (p - n_su) * kChunk;
      load_chunk(st, qb, q0, tq, d, col);
      load_chunk(st + kChunkFloats, dob, q0, tq, d, col);
      if (p < n_su) {
        load_chunk(st + 2 * kChunkFloats, kb, k0, tk, d, col);
        load_chunk(st + 3 * kChunkFloats, vb, k0, tk, d, col);
      }
    }
    cp_async_commit();
  };

  // S-phase roles: queries 16 * (warp / 2) + g (+ 8), keys 32 * (warp % 2)
  // + 8 n + 2t (+ 1); product roles: keys 16 * (warp % 4) + g (+ 8),
  // columns 32 * (warp / 4) + 8 ni + 2t (+ 1) of a unit
  const int mq = warp >> 1, kh = warp & 1;
  const int mk = warp & 3, ch = warp >> 2;
  float s[4][4], dp[4][4];
  float dv_acc[4][4][4], dk_acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[a][b][e] = dk_acc[a][b][e] = 0.f;

  fetch(0);
  for (int u = 0; u < total; ++u) {
    cp_async_wait<0>();
    __syncthreads();  // unit u is in; every warp is done with unit u - 1
    fetch(u + 1);
    const float* st = ring + (u % kDkvStages) * 4 * kChunkFloats;
    const int q0 = (i0 + u / per_tile) * kTile, p = u % per_tile;
    if (p < n_su) {
      if (p == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      const float* qa = st + mq * 16 * kLdC;
      const float* da = st + kChunkFloats + mq * 16 * kLdC;
      const float* kc = st + 2 * kChunkFloats + kh * 32 * kLdC;
      const float* vc = st + 3 * kChunkFloats + kh * 32 * kLdC;
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 8) {
        const FragA aq = load_a_perm(qa + kk, kLdC, lane);
        const FragA ad = load_a_perm(da + kk, kLdC, lane);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          mma3(s[n], aq, load_b_perm(kc + n * 8 * kLdC + kk, kLdC, lane));
          mma3(dp[n], ad, load_b_perm(vc + n * 8 * kLdC + kk, kLdC, lane));
        }
      }
      if (p == n_su - 1) {
        // p and ds of the tile, to shared memory key-major
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = mq * 16 + g + 8 * r;
          const int q_pos = q0 + row;
          const bool q_ok = q_pos < tq;
          const float l = q_ok ? lseb[q_pos] : 0.f;
          const float dl = q_ok ? dlb[q_pos] : 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int key = kh * 32 + n * 8 + 2 * t + x;
              const float pr =
                  q_ok && key_ok(q_pos, k0 + key, tk, diag, causal)
                      ? expf(s[n][2 * r + x] * scale - l)
                      : 0.f;
              pt[key * kLdP + row] = pr;
              dst[key * kLdP + row] = pr * (dp[n][2 * r + x] - dl) * scale;
            }
        }
      }
    } else {
      const int ci = p - n_su;
      const float* qc = st + ch * 32;
      const float* dO = st + kChunkFloats + ch * 32;
      const float* pa = pt + mk * 16 * kLdP;
      const float* da = dst + mk * 16 * kLdP;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c == ci) dkv_unit(dv_acc[c], dk_acc[c], pa, da, dO, qc, lane);
    }
  }

  float* dkb = dk + (size_t)bh * tk * d;
  float* dvb = dv + (size_t)bh * tk * d;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= n_pu) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + mk * 16 + g + 8 * r;
      if (key >= tk) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const size_t at = (size_t)key * d + c0 + c * kChunk + ch * 32 +
                          ni * 8 + 2 * t;
        *reinterpret_cast<float2*>(dkb + at) =
            make_float2(dk_acc[c][ni][2 * r], dk_acc[c][ni][2 * r + 1]);
        *reinterpret_cast<float2*>(dvb + at) =
            make_float2(dv_acc[c][ni][2 * r], dv_acc[c][ni][2 * r + 1]);
      }
    }
  }
}

inline int n_tiles(int t) { return (t + kTile - 1) / kTile; }

inline bool dim_ok(int d) { return d % kChunk == 0 && d >= kMinD && d <= kMaxD; }

inline int n_slices(int d) { return (d + kSlice - 1) / kSlice; }

}  // namespace

// K2a. q (bh, tq, d), k and v (bh, tk, d) f32 -> o (bh, tq, d), lse (bh,
// tq). d: a multiple of 64 from 256 to 512; anything else is refused.
extern "C" int flash_attention_fwd_tf32(int device, int d, const float* q,
                                        const float* k, const float* v,
                                        float* o, float* lse, int bh, int tq,
                                        int tk, float scale, int causal,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dim_ok(d)) return (int)cudaErrorInvalidValue;
  const int stages = fwd_smem(d, 3) <= kMaxSmem ? 3 : 2;
  const size_t smem = fwd_smem(d, stages);
  err = cudaFuncSetAttribute(fwd_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh * n_tiles(tq), n_slices(d));
  fwd_tc_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, lse, tq, tk, d, scale, causal, stages);
  return (int)cudaGetLastError();
}

// K2c. The same inputs, dout (bh, tq, d), lse and delta (bh, tq) -> dk, dv
// (bh, tk, d); d as K2a's.
extern "C" int flash_attention_dkv_tf32(int device, int d, const float* q,
                                        const float* k, const float* v,
                                        const float* dout, const float* lse,
                                        const float* delta, float* dk,
                                        float* dv, int bh, int tq, int tk,
                                        float scale, int causal,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dim_ok(d)) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(dkv_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh * n_tiles(tk), n_slices(d));
  dkv_tc_kernel<<<grid, kThreads, kDkvSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, delta, dk, dv, tq, tk, d, scale, causal);
  return (int)cudaGetLastError();
}
