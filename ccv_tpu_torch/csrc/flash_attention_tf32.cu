// Flash attention for Hopper (sm_90a) on mma.sync tensor cores: in float32
// the "tc-f32" design, the dq backward (K2b) and the dk/dv backward (K2c) at
// every head dim from 64 (D 32 zero-padded to 64 by the wrappers) and the
// forward (K2a) up to 256, their products in three TF32 parts; and above D
// 256 the "tc-wide" design, K2a in every type (fwd_wide_tc_kernel) and K2b
// and K2c in bf16 and float16 (dq_tc_kernel and dkv_tc_kernel, the same
// templates as float32's above D 128), 16-bit operands through native
// 16-bit products, float32 through the same three TF32 parts. They replace
// the FMA kernels and the chunked form (64-column chunks, accumulators in
// a global scratch) that flash_attention.cu held; that file keeps 16-bit D
// 32. Ports of the Pallas TPU kernels in
// ccv_tpu/ops/pallas/flash_attention.py:
//   K2a  _flash_kernel  (:36, via _flash_fwd_bthd)
//   K2b  _dq_kernel     (:173, via _flash_bwd_bthd)
//   K2c  _dkv_kernel    (:210, via _flash_bwd_bthd)
//
// What they compute, on (BH, T, D) row-major tensors, D a multiple of 64
// (K2a in float32 on tc-f32: 64, 128, 192 or 256), f32, bf16 or float16
// (lse and delta are (BH, Tq) f32), exactly what flash_attention.cu
// computes at D 32:
//   s = (q . k) * scale; a key counts if k_pos < Tk and, when causal,
//   k_pos <= q_pos + (Tk - Tq) (bottom-right). Masked scores are -1e30.
//   K2a: online softmax over 64-key tiles; o = acc / max(l, 1e-30);
//        lse = m + log(max(l, 1e-30)).
//   K2b, K2c: p = exp(s * scale - lse) (0 where masked or past Tq),
//        dp = do . v, ds = p * (dp - delta) * scale;
//   K2b: dq = sum_k ds k;
//   K2c: dv = sum_q p^T do, dk = sum_q ds^T q.
//   p and ds are rounded to the input type (float32: unchanged) and every
//   product accumulates in f32.
//
// Bound on this card. Causal at T 1024, K2a does 17.2 GFLOP, K2b 25.8 and
// K2c 34.4 at BH 32 x D 256, BH 64 x D 128 and BH 128 x D 64 alike, on
// 0.27-0.54 GB: operations bound them. In float32 outside the tensor cores
// (67 TFLOP/s) that is 0.257, 0.385 and 0.513 ms; the FMA and chunked
// forms they replace reached 3.1-9.4% of it, their products loops out of
// shared memory.
// Here the products run
// on the tensor cores as mma.sync m16n8k8 TF32 in the "3xTF32" split of
// CUTLASS's OpMultiplyAddFastF32 (PyTorch's memory-efficient attention
// uses it for float32): each operand x becomes hi = x rounded to TF32 and
// lo = x - hi (exact in f32; the instruction reads lo's top 19 bits), and
// a b accumulates lo_a hi_b + hi_a lo_b + hi_a hi_b in f32. That keeps
// about 21 of float32's 24 bits per product, against plain TF32's 11, at
// three TF32 products a product: 495 / 3 = 165 TFLOP/s dense at most, the
// "tf32x3" bound of ops/kernels/roofline.py (0.104, 0.156 and 0.208 ms
// here).
//
// Design. 256 threads (8 warps) a block; the accumulators stay in
// registers; tiles arrive through cp.async into a ring of stages in shared
// memory, the next stages' copies in flight while this one multiplies, one
// block barrier a stage; the ring has the most stages, up to 4, that leave
// the kernel's blocks a SM room. A stage holds 64-row x 64-column chunks
// (row stride 72 floats). Fragments load from shared memory and are split
// in registers; bank-conflict-free: an operand read along D uses lane t's
// columns 2t and 2t+1 as the k-step's k = t and t + 4 (A and B permuted
// alike, 8-byte loads; a row stride of 8 mod 32 words puts the 16 lanes of
// each half-warp on distinct banks), an operand read along the sequence a
// row stride of 8 (B) or 4 (A) mod 32. Blocks are numbered by tile first
// and bh second, the longest (causal) tiles first, so the card, which
// starts blocks in that order, ends with short ones: at one block a SM,
// numbered by bh first, a long block of the last heads ran alone at the
// end.
//   K2a up to D 256 (fwd_tc_kernel<SW>, SW the o a block keeps: 64, 128,
//   or 256 at D 192 and 256): one block per (bh, 64-query tile; the kernel
//   can take a slice of o a block, but above D 256 K2a runs tc-wide, below,
//   whose one block over all of D forms S once). q (64 x D) is loaded
//   once and stays in shared memory. Per 64-key tile: S = Q K^T from
//   "units" of K, a stage each (128 columns of D at SW 256, one 64-column
//   chunk below; warp w: query rows 16 (w/2).., keys 32 (w%2)..: 16 f32 a
//   thread), the online softmax in registers (the two warps of a row band
//   trade row maxima through shared memory; each keeps its own partial row
//   sum, summed at the end), P written once to shared memory (64 x 68) with
//   the row rescale factor, then O += P V from units of V (warp w: rows
//   32 (w%2).., a quarter of the unit's columns). O is 64 x SW f32 over the
//   block: 16, 32 or 64 registers a thread. At D 64 and 128 two blocks fit
//   a SM (4 and 3 stages of 18 KB), at D 192 and 256 one (3 stages of 36
//   KB).
//   K2b at D 64 and 128 (dq_res_kernel<D>): one block per (bh, 64-query
//   tile); its q and do tiles stay in shared memory, loaded once, and k and
//   v stream through the ring, all of D a stage: per key tile, dP = dO V^T
//   from the v tile, then S = Q K^T from the k tile (S-phase roles as
//   K2c's below), p and ds in registers, ds written once to shared memory
//   (64 x 68), and dQ += dS K from the same k stage (warp w: rows 32
//   (w%2).., columns 16 (w/2).. of each chunk), so each k tile is read
//   once. dq is 64 x D f32 over the block, D / 4 registers a thread. Two
//   blocks a SM at D 64 (3 stages of 18 KB), one at D 128 (3 of 36 KB),
//   where q and do take 70 KB.
//   K2b above (dq_tc_kernel<T, DM>, DM 256 up to D 256, else 512): one
//   block per (bh, 64-query tile, slice of dq of at most DM columns; ceil(D
//   / DM) slices as even as whole chunks allow: D 576 runs 320 + 256), dq
//   in registers (DM / 4 a thread, 128 at 512), so S and dP are formed once
//   a key tile up to D 512 (a block per 256-column slice, as K2c's, would
//   form them twice at D 512). Per key tile: S and dP from stages of
//   64-column chunks of q, do, k and v, ds rounded to T in shared memory,
//   then dQ from stages of up to four k chunks of the block's columns. In
//   float32 q and do are read again for each key tile (from L2), as K2c's k
//   and v: 2 stages of 72 KB. In 16-bit q and do (64 x D) stay in shared
//   memory where two ring stages of 36 KB fit beside them (up to D 576),
//   and an S stage holds k and v chunks of two columns; above, they stream
//   as in float32, up to 4 stages.
//   K2c at D 64 and 128 (dkv_res_kernel<D>): one block per (bh, 64-key
//   tile); its k and v tiles stay in shared memory, loaded once, and only q
//   and do stream through the ring, a 64-column chunk a stage: per query
//   tile from the first that reaches the keys, dP = dO V^T then S = Q K^T
//   (warp w: queries 16 (w/2).., keys 32 (w%2)..), p and ds in registers,
//   written transposed (key-major, 64 x 68) to shared memory, then dK +=
//   dS^T Q and dV += P^T dO (warp w: keys 16 (w%4).., columns 32 (w/4)..
//   of a chunk); the last S chunk of q serves dK at once, so a query tile
//   takes 4 D / 64 - 1 stages. dk and dv are 2 x 64 x D f32 over the block,
//   D / 4 registers a thread each. Two blocks a SM at D 64 (2 stages),
//   one at D 128 (4 stages), where k and v take 70 KB.
//   K2c above (dkv_tc_kernel<T>): one block per (bh, 64-key tile, dk/dv
//   slice of at most 256 columns; slices as even as whole chunks allow: D
//   320 runs 192 + 128, D 576 3 x 192). Per query tile: S = Q K^T and dP =
//   dO V^T from stages of 64-column chunks of q, do, k and v, p and ds
//   rounded to T in shared memory (key-major), then dV and dK from stages
//   of do and q chunks at the block's columns (one column of chunks a stage
//   in float32, two in 16-bit; dk and dv 2 x 64 x 256 f32 over the block,
//   128 registers a thread). In float32 k and v are read again for each
//   query tile (from L2): they and the q and do chunks do not fit in 227 KB
//   together; 2 stages of 72 KB. In 16-bit k and v stay in shared memory
//   where two ring stages fit beside them (up to D 512), and an S stage
//   holds q and do chunks of two columns; above, they stream.
//   K2a above (fwd_wide_tc_kernel<T, 512>, "tc-wide"): one block per (bh,
//   64-query tile, slice of o of at most 512 columns, ceil(D / 512) slices
//   as even as whole chunks allow), so S is formed once a key tile up to D
//   512. q stays in shared memory where three ring stages still fit beside
//   it (16-bit up to D 832, float32 up to 384) and otherwise streams
//   through the ring beside k, so the kernel takes any multiple of 64 (a
//   resident q saves a third of the bytes a key tile). Per key tile: S
//   stages of k chunks (with q's chunks where q streams: 36 KB a stage in
//   either type), the softmax as fwd_tc_kernel's, P rounded to T in shared
//   memory (the reference's rounding), then V stages of the block's v
//   columns (two chunks in f32, four in 16-bit). O is 64 x 512 f32 over the
//   block, 128 registers a thread; up to 4 stages, one block a SM. 16-bit
//   fragments come from ldmatrix (.trans for v, read along the sequence)
//   and go through m16n8k16 in one native product; f32 goes through mma3.
//   Bound: bf16 D 512 (BH 32, T 1024, causal) is 34.4 GFLOP on 134 MB,
//   0.040 ms by its bytes; each block reads k and v once a key tile from
//   L2, 128 KB there.
//   K2b and K2c above D 256 in 16-bit ("tc-wide"): the templates above with
//   ldmatrix x4 fragments (.trans where an operand is read along the
//   sequence: k in dQ = dS K, do and q in dV = P^T dO and dK = dS^T Q) and
//   native m16n8k16 products; rows of 72 values (and resident rows of D + 8)
//   put each 8 x 8 matrix's rows on distinct banks. Bound: bf16 D 512 K2b
//   is 51.6 GFLOP, K2c 68.8, 0.052 and 0.070 ms by their operations.
// No atomics: each block owns its rows of o, dq, dk and dv, so the results
// are deterministic.
//
// A query row with no valid key (causal with Tq > Tk) is refused by the
// wrapper. Numerics: no fast math; expf and logf are the IEEE-accurate
// versions. Each entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;                  // query and key rows per tile
constexpr int kThreads = 256;              // 8 warps
constexpr int kChunk = 64;                 // columns of a staged chunk
constexpr int kLdC = kChunk + 8;           // its row stride (8 mod 32)
constexpr int kChunkFloats = kTile * kLdC;
constexpr int kLdP = kTile + 4;            // P's row stride (4 mod 32)
constexpr int kSlice = 256;                // output columns a block keeps
constexpr int kDqCols = 512;               // dq columns a K2b block keeps
constexpr float kNegInf = -1e30f;          // NEG_INF of the Pallas kernel
constexpr int kMaxStages = 4;              // of a cp.async ring

// the shared memory a block may take with `blocks` blocks a SM (228 KB an
// SM, 1 KB of it held back a block)
constexpr size_t smem_budget(int blocks) { return 233472 / blocks - 1024; }

// ---- primitives --------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// waits for the oldest group of a ring of `stages` (2 to kMaxStages) stages
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4)
    cp_async_wait<2>();
  else if (stages == 3)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
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
// tensor of T into a shared chunk of row stride kLdC, rows past `rows` zero.
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int row0,
                                           int rows, int d, int col0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecs = kChunk / kVec;
  for (int c = threadIdx.x; c < kTile * kVecs; c += kThreads) {
    const int r = c / kVecs, e = (c % kVecs) * kVec;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * kLdC + e,
               src + (size_t)(ok ? row0 + r : 0) * d + col0 + e, ok);
  }
}

// Rows row0 .. row0+63 and all d columns of a row-major (rows, d) tensor of
// T into shared memory of row stride d + 8, rows past `rows` zero.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int rows, int d) {
  constexpr int kVec = 16 / sizeof(T);
  for (int c = threadIdx.x; c < kTile * (d / kVec); c += kThreads) {
    const int r = c / (d / kVec), e = (c % (d / kVec)) * kVec;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * (d + 8) + e,
               src + (size_t)(ok ? row0 + r : 0) * d + e, ok);
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

// S += A B^T over one 64-column chunk of D: A this warp's 16 rows (row
// stride lda), B its 32 rows (row stride ldb), both read along D.
__device__ __forceinline__ void s_chunk(float (&acc)[4][4], const float* a,
                                        int lda, const float* b, int ldb,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < kChunk; kk += 8) {
    const FragA fa = load_a_perm(a + kk, lda, lane);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      mma3(acc[n], fa, load_b_perm(b + n * 8 * ldb + kk, ldb, lane));
  }
}

// acc (this warp's 16 keys x 32 columns of a chunk) += A^T B: at is
// [key][query] (row stride kLdP) at the warp's keys, b the chunk at the
// warp's columns.
__device__ __forceinline__ void kv_chunk(float (&acc)[4][4], const float* at,
                                         const float* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 8) {
    const FragA a = load_a(at + kk, kLdP, lane);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma3(acc[ni], a, load_b(b + kk * kLdC + ni * 8, kLdC, lane));
  }
}

// x rounded to T (to nearest even, as torch)
template <typename T>
__device__ __forceinline__ T to_t(float x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(x);
  else
    return __float2half_rn(x);
}

// The row stride of a 64 x 64 p or ds tile in T: 4 mod 32 words in float32
// (for load_a), 72 values in 16-bit (for ldmatrix: 4 mod 32 words too)
template <typename T>
__host__ __device__ constexpr int ld_p() {
  return std::is_same<T, float>::value ? kLdP : kLdC;
}

// K2c's p and ds of a query tile from this warp's s and dp (queries 16 mq
// + g (+ 8), keys 32 kh + 8 n + 2t (+ 1)), rounded to T and written
// key-major to pt and dst
template <typename T>
__device__ __forceinline__ void p_ds_tile(
    T* pt, T* dst, const float (&s)[4][4], const float (&dp)[4][4],
    const float* lseb, const float* dlb, int q0, int k0, int tq, int tk,
    int diag, int causal, float scale, int mq, int kh, int g, int t) {
  constexpr int ld = ld_p<T>();
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
        const float pr = q_ok && key_ok(q_pos, k0 + key, tk, diag, causal)
                             ? expf(s[n][2 * r + x] * scale - l)
                             : 0.f;
        pt[key * ld + row] = to_t<T>(pr);
        dst[key * ld + row] = to_t<T>(pr * (dp[n][2 * r + x] - dl) * scale);
      }
  }
}

// ---- K2a ---------------------------------------------------------------

// The forward's shape for an o slice of SW columns (64, 128 or 256): a
// ring stage ("unit") holds kUnit columns of k or v, 128 at SW 256 and one
// 64-column chunk below, so that two blocks fit a SM there; in P V a warp
// takes kUnit / 4 columns of a unit, kNi 8-column tiles.
template <int SW>
struct Fwd {
  static constexpr int kUnit = SW > 128 ? 128 : 64;
  static constexpr int kHalves = kUnit / kChunk;  // chunks a unit
  static constexpr int kUnits = SW / kUnit;       // units of the slice
  static constexpr int kCols = kUnit / 4;         // a warp's columns
  static constexpr int kNi = kCols / 8;
  static constexpr int kBlocks = SW > 128 ? 1 : 2;  // blocks a SM
};

// shared memory of the forward at head dim d with `stages` ring stages of
// `halves` chunks
inline size_t fwd_smem(int d, int stages, int halves) {
  return sizeof(float) * ((size_t)kTile * (d + 8)         // q
                          + (size_t)stages * halves * kChunkFloats  // ring
                          + kTile * kLdP                  // p
                          + 2 * kTile                     // row maxima
                          + kTile                         // rescale
                          + 2 * kTile                     // row sums
                          + kTile);                       // m
}

// O (this warp's 32 rows x 8 NI columns of a unit) += P V: P 64 x 64 (row
// stride kLdP), v the unit's chunk holding the warp's columns.
template <int NI>
__device__ __forceinline__ void pv_unit(float (&acc)[2][NI][4],
                                        const float* ps, const float* v,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 8) {
    FragA a[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) a[mi] = load_a(ps + mi * 16 * kLdP + kk,
                                                  kLdP, lane);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const FragB b = load_b(v + kk * kLdC + ni * 8, kLdC, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma3(acc[mi][ni], a[mi], b);
    }
  }
}

template <int SW>
__global__ void __launch_bounds__(kThreads, Fwd<SW>::kBlocks)
    fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int tq, int tk, int d,
                  float scale, int causal, int stages) {
  using C = Fwd<SW>;
  constexpr int kStage = C::kHalves * kChunkFloats;  // floats a stage
  extern __shared__ __align__(128) float smem[];
  const int ldq = d + 8;
  float* qs = smem;
  float* ring = qs + kTile * ldq;
  float* ps = ring + stages * kStage;
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
  const int c0 = blockIdx.y * SW;              // this block's columns of o
  const int nv = min(SW, d - c0);
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

  // units of a key tile: D / kUnit of k (kUnit columns of D each, the
  // last maybe 64), then nv / kUnit of v (this block's columns)
  const int n_ku = (d + C::kUnit - 1) / C::kUnit;
  const int n_vu = (nv + C::kUnit - 1) / C::kUnit;
  const int per_tile = n_ku + n_vu;
  const int n_kt = [&] {
    const int n = (tk + kTile - 1) / kTile;
    return causal ? min(n, (q0 + kTile - 1 + diag) / kTile + 1) : n;
  }();
  const int total = n_kt * per_tile;
  auto fetch = [&](int u) {
    if (u < total) {
      const int k0 = (u / per_tile) * kTile, p = u % per_tile;
      float* st = ring + (u % stages) * kStage;
      const bool is_k = p < n_ku;
      const int col = is_k ? p * C::kUnit : c0 + (p - n_ku) * C::kUnit;
      const int end = is_k ? d : c0 + nv;
      for (int h = 0; h < C::kHalves; ++h)
        if (col + h * kChunk < end)
          load_chunk(st + h * kChunkFloats, is_k ? kb : vb, k0, tk, d,
                     col + h * kChunk);
    }
    cp_async_commit();
  };

  // S-phase roles: query rows 16 * (warp / 2) + g (+ 8), keys 32 * (warp %
  // 2) + 8 n + 2t (+ 1); P V roles: rows 32 * (warp % 2) + 16 mi + g (+ 8),
  // columns kCols * (warp / 2) + 8 ni + 2t (+ 1) of a unit
  const int mq = warp >> 1, kh = warp & 1;
  const int rg = warp & 1, cg = warp >> 1;
  float s[4][4];
  float acc[C::kUnits][2][C::kNi][4];
#pragma unroll
  for (int a = 0; a < C::kUnits; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < C::kNi; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][c][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int u = 0; u < stages - 1; ++u) fetch(u);
  for (int u = 0; u < total; ++u) {
    cp_async_wait_ring(stages);
    __syncthreads();  // unit u is in; every warp is done with unit u - 1
    fetch(u + stages - 1);
    const float* st = ring + (u % stages) * kStage;
    const int k0 = (u / per_tile) * kTile, p = u % per_tile;
    if (p < n_ku) {
      // S += Q K^T over this unit's columns of D
      if (p == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      }
      for (int h = 0; h < C::kHalves; ++h) {
        const int col = p * C::kUnit + h * kChunk;
        if (col >= d) break;
        s_chunk(s, qs + mq * 16 * ldq + col, ldq,
                st + h * kChunkFloats + kh * 32 * kLdC, kLdC, lane);
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
      // O += P V over this unit's kUnit columns (the warp's kCols)
      const int vi = p - n_ku;
      if (vi == 0) {  // the tile's rescale, before its first product
        float cr[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            cr[mi][r] = corr_s[rg * 32 + mi * 16 + g + 8 * r];
#pragma unroll
        for (int a = 0; a < C::kUnits; ++a)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < C::kNi; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[a][mi][ni][e] *= cr[mi][e >> 1];
      }
      const int wc = cg * C::kCols;  // the warp's first column of the unit
      if (vi * C::kUnit + wc < nv) {
        const float* vc = st + (wc / kChunk) * kChunkFloats + wc % kChunk;
        const float* pa = ps + rg * 32 * kLdP;
#pragma unroll
        for (int a = 0; a < C::kUnits; ++a)
          if (a == vi) pv_unit<C::kNi>(acc[a], pa, vc, lane);
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
      for (int a = 0; a < C::kUnits; ++a) {
        const int col = a * C::kUnit + cg * C::kCols;
        if (col >= nv) continue;
#pragma unroll
        for (int ni = 0; ni < C::kNi; ++ni)
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

// ---- K2a above the tc-f32 forward's range: the "tc-wide" design -------

// Why mma.sync and not wgmma: one block keeps up to 512 columns of o in
// registers, 64 x 512 f32 over the block, 128 a thread at 256 threads. On
// one wgmma warpgroup that accumulator would be 256 registers a thread, over
// the 255 a thread may hold, and at 16-bit D 256 the wgmma-tma forward
// already sits near the 168 registers a thread that two warpgroups and a
// producer warp leave. mma.sync's m16n8 tiles let eight warps share it.

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a b, m16n8k16 with 16-bit operands of type T (bf16 or f16) and f32
// accumulators: a product of two 16-bit values is exact in f32, so one
// native product takes the place of mma3's three
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two values rounded to T (to nearest even, as torch) at p, p + 1.
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else if constexpr (std::is_same<T, __nv_bfloat16>::value)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Fragments of m16n8k16 from ldmatrix (r = lane % 8, sel = lane / 8 names
// the 8 x 8 matrix whose row the lane addresses): A 16 x 16 from a
// row-major array, matrices (rows, columns) +(0, 0), (8, 0), (0, 8), (8, 8)
// as a0-a3; B for two 8-column n-tiles at once, {r0, r1} the first and {r2,
// r3} the second. A row stride of 72 16-bit values (36 words, 4 mod 32) puts
// the eight 16-byte rows of each matrix on distinct banks.

// S += A B^T over one 64-column chunk of D, 16-bit: A this warp's 16 rows
// of q (row stride lda), B its 32 rows of k (row stride ldb), both read
// along D.
template <typename T>
__device__ __forceinline__ void s_chunk16(float (&acc)[4][4], const T* a,
                                          int lda, const T* b, int ldb,
                                          int lane) {
  const int r = lane & 7, sel = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kChunk; kk += 16) {
    uint32_t fa[4];
    ldsm_x4(fa, a + (r + 8 * (sel & 1)) * lda + kk + 8 * (sel >> 1));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t fb[4];  // keys 16 np + 8 (sel >> 1) + r, D kk + 8 (sel & 1)
      ldsm_x4(fb, b + (np * 16 + 8 * (sel >> 1) + r) * ldb + kk +
                      8 * (sel & 1));
      mma16<T>(acc[2 * np], fa, fb[0], fb[1]);
      mma16<T>(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// O (this warp's 32 rows x 8 NI columns) += P V, 16-bit: P 64 x 64 at the
// warp's rows (row stride kLdC), v the chunk at the warp's first column,
// read along the sequence (ldmatrix.trans).
template <typename T, int NI>
__device__ __forceinline__ void pv16(float (&acc)[2][NI][4], const T* ps,
                                     const T* v, int lane) {
  const int r = lane & 7, sel = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 16) {
    uint32_t fa[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(fa[mi], ps + (mi * 16 + r + 8 * (sel & 1)) * kLdC + kk +
                          8 * (sel >> 1));
#pragma unroll
    for (int np = 0; np < NI / 2; ++np) {
      uint32_t fb[4];  // keys kk + 8 (sel & 1) + r, columns 16 np + 8 (sel >> 1)
      ldsm_x4_t(fb, v + (kk + 8 * (sel & 1) + r) * kLdC + np * 16 +
                        8 * (sel >> 1));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma16<T>(acc[mi][2 * np], fa[mi], fb[0], fb[1]);
        mma16<T>(acc[mi][2 * np + 1], fa[mi], fb[2], fb[3]);
      }
    }
  }
}

// acc (this warp's 16 keys x 32 columns of a chunk) += A^T B, 16-bit: at
// is [key][query] (row stride kLdC) at the warp's keys, b the chunk at the
// warp's columns, read along the sequence (ldmatrix.trans).
template <typename T>
__device__ __forceinline__ void kv_chunk16(float (&acc)[4][4], const T* at,
                                           const T* b, int lane) {
  const int r = lane & 7, sel = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 16) {
    uint32_t fa[4];
    ldsm_x4(fa, at + (r + 8 * (sel & 1)) * kLdC + kk + 8 * (sel >> 1));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t fb[4];  // queries kk + 8 (sel & 1) + r, columns 16 np + 8 (sel >> 1)
      ldsm_x4_t(fb, b + (kk + 8 * (sel & 1) + r) * kLdC + np * 16 +
                        8 * (sel >> 1));
      mma16<T>(acc[2 * np], fa, fb[0], fb[1]);
      mma16<T>(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// The wide forward's shape in type T. A ring stage is kWideStage bytes,
// kCps 64-column chunks (two in float32, four in 16-bit): an S stage holds
// kCps chunks of k where q is resident, else kCps / 2 of q and as many of
// k; a V stage kVUnit columns of v. In P V a warp takes a quarter of a V
// stage's columns, kNi 8-column tiles. A block keeps up to MC columns of o:
// kUnits V stages' worth, MC / 4 f32 registers a thread (128 at 512).
constexpr int kWideStage = 36864;
template <typename T, int MC>
struct Wide {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kChunkElems = kTile * kLdC;
  static constexpr int kCps = kWideStage / (kChunkElems * (int)sizeof(T));
  static constexpr int kVUnit = kCps * kChunk;
  static constexpr int kCols = kVUnit / 4;
  static constexpr int kNi = kCols / 8;
  static constexpr int kUnits = MC / kVUnit;
};

// shared memory of the wide forward at head dim d with `stages` ring
// stages: q where resident (qr), the ring, P in T, row maxima, rescale, row
// sums, m
template <typename T>
inline size_t wide_smem(int d, int stages, bool qr) {
  return (qr ? (size_t)kTile * (d + 8) * sizeof(T) : 0) +
         (size_t)stages * kWideStage +
         (size_t)kTile * ld_p<T>() * sizeof(T) +
         6 * kTile * sizeof(float);
}

// the most columns of o a tc-wide block keeps, by type
template <typename T>
constexpr int wide_cols() { return 512; }

// K2a at any head dim d, a multiple of 64, in T: one block per (bh, 64-query
// tile, slice of `cols` <= MC columns of o). q (64 x d) stays in shared
// memory where `qres`, else streams through the ring beside k, so d has no
// limit. Per key tile: S from the S stages, the online softmax as
// fwd_tc_kernel's, P to shared memory rounded to T, then O += P V from the
// V stages of the block's columns.
template <typename T, int MC>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_wide_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int tq, int tk, int d,
                       int cols, float scale, int causal, int stages,
                       int qres) {
  using C = Wide<T, MC>;
  constexpr int kCe = C::kChunkElems;
  constexpr int kStageElems = C::kCps * kCe;
  extern __shared__ __align__(128) unsigned char wsmem[];
  const int ldq = d + 8;
  T* qs = reinterpret_cast<T*>(wsmem);  // resident q (qres)
  T* ring = qs + (qres ? kTile * ldq : 0);
  T* ps = ring + stages * kStageElems;
  float* pmax = reinterpret_cast<float*>(ps + kTile * ld_p<T>());  // [2][64]
  float* corr_s = pmax + 2 * kTile;
  float* lsum = corr_s + kTile;  // [2][64]
  float* m_s = lsum + 2 * kTile;

  const int n_qt = (tq + kTile - 1) / kTile;
  const int n_bh = gridDim.x / n_qt;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / n_bh)) * kTile;
  const int c0 = blockIdx.y * cols;  // this block's columns of o
  const int nv = min(cols, d - c0);
  const int diag = tk - tq;
  const T* qb = q + (size_t)bh * tq * d;
  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  if (qres) {  // q, once: its own cp.async group, ahead of the ring's
    load_rows(qs, qb, q0, tq, d);
    cp_async_commit();
  }

  // stages of a key tile: n_su S stages of su columns (k chunks h at h, or
  // q and k chunks h at 2h, 2h + 1), then n_vu V stages (v chunks of this
  // block's columns)
  const int s_chunks = qres ? C::kCps : C::kCps / 2;
  const int su = s_chunks * kChunk;
  const int n_su = (d + su - 1) / su;
  const int n_vu = (nv + C::kVUnit - 1) / C::kVUnit;
  const int per_tile = n_su + n_vu;
  const int n_kt = [&] {
    const int n = (tk + kTile - 1) / kTile;
    return causal ? min(n, (q0 + kTile - 1 + diag) / kTile + 1) : n;
  }();
  const int total = n_kt * per_tile;
  auto fetch = [&](int u) {
    if (u < total) {
      const int k0 = (u / per_tile) * kTile, p = u % per_tile;
      T* st = ring + (u % stages) * kStageElems;
      if (p < n_su) {
        for (int h = 0; h < s_chunks; ++h) {
          const int col = p * su + h * kChunk;
          if (col < d) {
            if (!qres) load_chunk(st + 2 * h * kCe, qb, q0, tq, d, col);
            load_chunk(st + (qres ? h : 2 * h + 1) * kCe, kb, k0, tk, d,
                         col);
          }
        }
      } else {
        const int col = c0 + (p - n_su) * C::kVUnit;
        for (int h = 0; h < C::kCps; ++h)
          if (col + h * kChunk < c0 + nv)
            load_chunk(st + h * kCe, vb, k0, tk, d, col + h * kChunk);
      }
    }
    cp_async_commit();
  };

  // S-phase roles: query rows 16 * (warp / 2) + g (+ 8), keys 32 * (warp %
  // 2) + 8 n + 2t (+ 1); P V roles: rows 32 * (warp % 2) + 16 mi + g (+ 8),
  // columns kCols * (warp / 2) + 8 ni + 2t (+ 1) of a V stage
  const int mq = warp >> 1, kh = warp & 1;
  const int rg = warp & 1, cg = warp >> 1;
  float s[4][4];
  float acc[C::kUnits][2][C::kNi][4];
#pragma unroll
  for (int a = 0; a < C::kUnits; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < C::kNi; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][c][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int u = 0; u < stages - 1; ++u) fetch(u);
  for (int u = 0; u < total; ++u) {
    cp_async_wait_ring(stages);
    __syncthreads();  // stage u is in; every warp is done with stage u - 1
    fetch(u + stages - 1);
    const T* st = ring + (u % stages) * kStageElems;
    const int k0 = (u / per_tile) * kTile, p = u % per_tile;
    if (p < n_su) {
      // S += Q K^T over this stage's columns of D
      if (p == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      }
#pragma unroll
      for (int h = 0; h < C::kCps; ++h) {
        const int col = p * su + h * kChunk;
        if (h >= s_chunks || col >= d) break;
        const T* qa = qres ? qs + mq * 16 * ldq + col
                           : st + 2 * h * kCe + mq * 16 * kLdC;
        const int lda = qres ? ldq : kLdC;
        const T* ka = st + (qres ? h : 2 * h + 1) * kCe + kh * 32 * kLdC;
        if constexpr (C::kF32)
          s_chunk(s, qa, lda, ka, kLdC, lane);
        else
          s_chunk16<T>(s, qa, lda, ka, kLdC, lane);
      }
      if (p == n_su - 1) {
        // online softmax of the tile, as fwd_tc_kernel's; p rounded to T
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
            store2(ps + (mq * 16 + g + 8 * r) * ld_p<T>() + kh * 32 + n * 8 +
                       2 * t,
                   p0, p1);
          }
        if (kh == 0 && t == 0) {
          corr_s[mq * 16 + g] = corr[0];
          corr_s[mq * 16 + g + 8] = corr[1];
        }
      }
    } else {
      // O += P V over this stage's kVUnit columns (the warp's kCols)
      const int vi = p - n_su;
      if (vi == 0) {  // the tile's rescale, before its first product
        float cr[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            cr[mi][r] = corr_s[rg * 32 + mi * 16 + g + 8 * r];
#pragma unroll
        for (int a = 0; a < C::kUnits; ++a)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < C::kNi; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[a][mi][ni][e] *= cr[mi][e >> 1];
      }
      const int wc = cg * C::kCols;  // the warp's first column of the stage
      if (vi * C::kVUnit + wc < nv) {
        const T* vc = st + (wc / kChunk) * kCe + wc % kChunk;
        const T* pa = ps + rg * 32 * ld_p<T>();
#pragma unroll
        for (int a = 0; a < C::kUnits; ++a)
          if (a == vi) {
            if constexpr (C::kF32)
              pv_unit<C::kNi>(acc[a], pa, vc, lane);
            else
              pv16<T, C::kNi>(acc[a], pa, vc, lane);
          }
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
  T* ob = o + (size_t)bh * tq * d;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rg * 32 + mi * 16 + g + 8 * r;
      if (q0 + row >= tq) continue;
      const float inv =
          1.f / fmaxf(lsum[row] + lsum[kTile + row], 1e-30f);
#pragma unroll
      for (int a = 0; a < C::kUnits; ++a) {
        const int col = a * C::kVUnit + cg * C::kCols;
        if (col >= nv) continue;
#pragma unroll
        for (int ni = 0; ni < C::kNi; ++ni)
          store2(ob + (size_t)(q0 + row) * d + c0 + col + ni * 8 + 2 * t,
                 acc[a][mi][ni][2 * r] * inv, acc[a][mi][ni][2 * r + 1] * inv);
      }
    }
  if (blockIdx.y == 0 && threadIdx.x < kTile && q0 + (int)threadIdx.x < tq) {
    const float l = fmaxf(lsum[threadIdx.x] + lsum[kTile + threadIdx.x],
                          1e-30f);
    lse[(size_t)bh * tq + q0 + threadIdx.x] = m_s[threadIdx.x] + logf(l);
  }
}

// ---- K2b ---------------------------------------------------------------

// K2b's ds of a key tile from this warp's s and dp (queries 16 mq + g (+ 8),
// keys 32 kh + 8 n + 2t (+ 1)), rounded to T and written query-major to ds;
// l and dl are the lse and delta of the warp's two rows
template <typename T>
__device__ __forceinline__ void ds_tile(
    T* ds, const float (&s)[4][4], const float (&dp)[4][4],
    const float (&l)[2], const float (&dl)[2], int q0, int k0, int tq,
    int tk, int diag, int causal, float scale, int mq, int kh, int g,
    int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = mq * 16 + g + 8 * r;
    const int q_pos = q0 + row;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float x2[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int key = kh * 32 + n * 8 + 2 * t + x;
        const float pr =
            q_pos < tq && key_ok(q_pos, k0 + key, tk, diag, causal)
                ? expf(s[n][2 * r + x] * scale - l[r])
                : 0.f;
        x2[x] = pr * (dp[n][2 * r + x] - dl[r]) * scale;
      }
      store2(ds + row * ld_p<T>() + kh * 32 + n * 8 + 2 * t, x2[0], x2[1]);
    }
  }
}

// The lse and delta of this thread's two S-phase rows (16 mq + g (+ 8)),
// 0 past tq.
__device__ __forceinline__ void row_stats(float (&l)[2], float (&dl)[2],
                                          const float* lseb,
                                          const float* dlb, int q0, int tq,
                                          int mq, int g) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = q0 + mq * 16 + g + 8 * r;
    l[r] = q_pos < tq ? lseb[q_pos] : 0.f;
    dl[r] = q_pos < tq ? dlb[q_pos] : 0.f;
  }
}

// dq (this warp's rows 32 rg + 16 mi + g (+ 8), columns 16 cg + 8 ni + 2t
// (+ 1) of each of its NC chunks) to rows q0.. of a (tq, d) tensor of T
// from column 0 of dqb: the first n chunks
template <typename T, int NC>
__device__ __forceinline__ void store_dq(T* dqb,
                                         const float (&acc)[NC][2][2][4],
                                         int q0, int tq, int d, int n,
                                         int rg, int cg, int g, int t) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c >= n) break;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + rg * 32 + mi * 16 + g + 8 * r;
        if (row >= tq) continue;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          store2(dqb + (size_t)row * d + c * kChunk + cg * 16 + ni * 8 + 2 * t,
                 acc[c][mi][ni][2 * r], acc[c][mi][ni][2 * r + 1]);
      }
  }
}

// blocks a SM of the dq backward at head dim D <= 128: at D 128 its q and
// do tiles leave room for one
constexpr int dq_res_blocks(int d) { return d > 64 ? 1 : 2; }

// shared memory of the dq backward at head dim D <= 128 with `stages`
// ring stages: q and do resident, ds, the ring of k or v tiles (all of D a
// stage)
inline size_t dq_res_smem(int d, int stages) {
  return sizeof(float) * (2 * (size_t)kTile * (d + 8) + kTile * kLdP +
                          (size_t)stages * (d / kChunk) * kChunkFloats);
}

// K2b at D 64 and 128: q and do resident, per key tile a stage of v (dP)
// then one of k (S, ds, and dQ from the same stage).
template <int D>
__global__ void __launch_bounds__(kThreads, dq_res_blocks(D))
    dq_res_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int tq, int tk, float scale, int causal, int stages) {
  constexpr int kN = D / kChunk;       // chunks of D
  constexpr int kLdR = D + 8;          // resident rows' stride (8 mod 32)
  constexpr int kStage = kN * kChunkFloats;
  extern __shared__ __align__(128) float smem[];
  float* qr = smem;
  float* dor = qr + kTile * kLdR;
  float* dss = dor + kTile * kLdR;     // ds [query][key]
  float* ring = dss + kTile * kLdP;

  // blocks by query tile, the last (the longest when causal) first, then by
  // bh
  const int n_qt = (tq + kTile - 1) / kTile;
  const int n_bh = gridDim.x / n_qt;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / n_bh)) * kTile;
  const int diag = tk - tq;
  const float* kb = k + (size_t)bh * tk * D;
  const float* vb = v + (size_t)bh * tk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  // q and do, once: their own cp.async group, ahead of the ring's
  {
    const float* qb = q + (size_t)bh * tq * D;
    const float* dob = dout + (size_t)bh * tq * D;
    for (int c = threadIdx.x; c < kTile * (D / 4); c += kThreads) {
      const int r = c / (D / 4), e = (c % (D / 4)) * 4;
      const bool ok = q0 + r < tq;
      const size_t at = (size_t)(ok ? q0 + r : 0) * D + e;
      cp_async16(qr + r * kLdR + e, qb + at, ok);
      cp_async16(dor + r * kLdR + e, dob + at, ok);
    }
    cp_async_commit();
  }

  // stages: the v tile, then the k tile, of each key tile
  const int n_kt = [&] {
    const int n = (tk + kTile - 1) / kTile;
    return causal ? min(n, (q0 + kTile - 1 + diag) / kTile + 1) : n;
  }();
  const int total = 2 * n_kt;
  auto fetch = [&](int f) {
    if (f < total) {
      float* st = ring + (f % stages) * kStage;
#pragma unroll
      for (int h = 0; h < kN; ++h)
        load_chunk(st + h * kChunkFloats, f & 1 ? kb : vb, (f >> 1) * kTile,
                   tk, D, h * kChunk);
    }
    cp_async_commit();
  };

  const int mq = warp >> 1, kh = warp & 1;
  const int rg = warp & 1, cg = warp >> 1;
  float l[2], dl[2];
  row_stats(l, dl, lse + (size_t)bh * tq, delta + (size_t)bh * tq, q0, tq,
            mq, g);
  float s[4][4], dp[4][4];
  float acc[kN][2][2][4];
#pragma unroll
  for (int a = 0; a < kN; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][c][e] = 0.f;

  for (int f = 0; f < stages - 1; ++f) fetch(f);
  for (int f = 0; f < total; ++f) {
    cp_async_wait_ring(stages);
    __syncthreads();  // stage f is in; every warp is done with stage f - 1
    fetch(f + stages - 1);
    const float* st = ring + (f % stages) * kStage;
    if (!(f & 1)) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
#pragma unroll
      for (int h = 0; h < kN; ++h)
        s_chunk(dp, dor + mq * 16 * kLdR + h * kChunk, kLdR,
                st + h * kChunkFloats + kh * 32 * kLdC, kLdC, lane);
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int h = 0; h < kN; ++h)
        s_chunk(s, qr + mq * 16 * kLdR + h * kChunk, kLdR,
                st + h * kChunkFloats + kh * 32 * kLdC, kLdC, lane);
      ds_tile(dss, s, dp, l, dl, q0, (f >> 1) * kTile, tq, tk, diag, causal,
              scale, mq, kh, g, t);
      __syncthreads();  // ds is whole
#pragma unroll
      for (int h = 0; h < kN; ++h)
        pv_unit<2>(acc[h], dss + rg * 32 * kLdP,
                   st + h * kChunkFloats + cg * 16, lane);
    }
  }
  cp_async_wait<0>();

  store_dq(dq + (size_t)bh * tq * D, acc, q0, tq, D, kN, rg, cg, g, t);
}

// The backward's shape above D 128 in type T: a ring stage holds four
// 64-column chunks (72 KB in float32, 36 KB in 16-bit), p and ds are 64 x 64
// in T. K2b's q and do, or K2c's k and v, stay in shared memory ("res")
// where they fit beside two ring stages, in 16-bit only (up to D 576 for
// K2b and 512 for K2c; 16-bit rings take up to four stages); float32
// streams them through two stages of 72 KB, fixed at compile time (a ring
// depth and stage layout read at run time made float32 4-7% slower).
template <typename T>
struct Bwd {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kCe = kTile * kLdC;  // values of a chunk
  static constexpr int kStage = 4 * kCe;    // values of a stage
  // float32's ring depth, fixed (0: the launch's): two 72 KB stages
  static constexpr int kStages = kF32 ? 2 : 0;
  // columns of q and do chunks in a stage of K2c's products
  static constexpr int kPc = kF32 ? 1 : 2;
};

// shared memory of the dq backward above D 128: q and do where resident,
// the ring, ds
template <typename T>
inline size_t dq_tc_smem(int d, int stages, bool res) {
  return sizeof(T) * ((res ? 2 * (size_t)kTile * (d + 8) : 0) +
                      (size_t)stages * Bwd<T>::kStage + kTile * ld_p<T>());
}

// K2b above D 128: one block per (bh, 64-query tile, slice of `cols` <= DM
// columns of dq). Per key tile: S and dP over all of D from the S stages
// (streamed: q, do, k and v chunks of one column; q and do resident: k
// and v chunks of two), ds to shared memory in T, then dQ += dS K from
// stages of up to four k chunks of the block's columns.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads, 1)
    dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 int tq, int tk, int d, int cols, float scale, int causal,
                 int stages_arg, int res_arg) {
  using C = Bwd<T>;
  constexpr int kN = DM / kChunk;      // chunks of dq the block keeps
  constexpr int kCe = C::kCe;
  const int stages = C::kStages ? C::kStages : stages_arg;
  const int res = C::kF32 ? 0 : res_arg;
  extern __shared__ __align__(128) unsigned char bsmem[];
  const int ldr = d + 8;               // resident rows' stride
  T* qr = reinterpret_cast<T*>(bsmem);
  T* dor = qr + (res ? kTile * ldr : 0);
  T* ring = dor + (res ? kTile * ldr : 0);
  T* dss = ring + stages * C::kStage;  // ds [query][key]

  const int n_qt = (tq + kTile - 1) / kTile;
  const int n_bh = gridDim.x / n_qt;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / n_bh)) * kTile;
  const int c0 = blockIdx.y * cols;    // this block's columns of dq
  const int nc = min(cols, d - c0) / kChunk;
  const int diag = tk - tq;
  const T* qb = q + (size_t)bh * tq * d;
  const T* dob = dout + (size_t)bh * tq * d;
  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  if (res) {  // q and do, once: their own cp.async group, ahead of the ring's
    load_rows(qr, qb, q0, tq, d);
    load_rows(dor, dob, q0, tq, d);
    cp_async_commit();
  }

  // stages of a key tile: n_su S stages of s_cols columns of chunks, then
  // n_pu of up to four k chunks of this block's columns
  const int s_cols = res ? 2 : 1;
  const int n_su = (d / kChunk + s_cols - 1) / s_cols, n_pu = (nc + 3) / 4;
  const int per_tile = n_su + n_pu;
  const int n_kt = [&] {
    const int n = (tk + kTile - 1) / kTile;
    return causal ? min(n, (q0 + kTile - 1 + diag) / kTile + 1) : n;
  }();
  const int total = n_kt * per_tile;
  auto fetch = [&](int u) {
    if (u < total) {
      const int k0 = (u / per_tile) * kTile, p = u % per_tile;
      T* st = ring + (u % stages) * C::kStage;
      if (p < n_su && res) {  // k and v chunks h at 2h, 2h + 1
        for (int h = 0; h < 2; ++h) {
          const int col = (2 * p + h) * kChunk;
          if (col < d) {
            load_chunk(st + 2 * h * kCe, kb, k0, tk, d, col);
            load_chunk(st + (2 * h + 1) * kCe, vb, k0, tk, d, col);
          }
        }
      } else if (p < n_su) {  // q, do, k and v chunks
        const int col = p * kChunk;
        load_chunk(st, qb, q0, tq, d, col);
        load_chunk(st + kCe, dob, q0, tq, d, col);
        load_chunk(st + 2 * kCe, kb, k0, tk, d, col);
        load_chunk(st + 3 * kCe, vb, k0, tk, d, col);
      } else {
        for (int h = 0; h < 4; ++h) {
          const int c = (p - n_su) * 4 + h;
          if (c < nc)
            load_chunk(st + h * kCe, kb, k0, tk, d, c0 + c * kChunk);
        }
      }
    }
    cp_async_commit();
  };

  // S-phase roles: query rows 16 * (warp / 2) + g (+ 8), keys 32 * (warp %
  // 2) + 8 n + 2t (+ 1); dQ roles: rows 32 * (warp % 2) + 16 mi + g (+ 8),
  // columns 16 * (warp / 2) + 8 ni + 2t (+ 1) of each chunk
  const int mq = warp >> 1, kh = warp & 1;
  const int rg = warp & 1, cg = warp >> 1;
  float l[2], dl[2];
  row_stats(l, dl, lse + (size_t)bh * tq, delta + (size_t)bh * tq, q0, tq,
            mq, g);
  float s[4][4], dp[4][4];
  float acc[kN][2][2][4];
#pragma unroll
  for (int a = 0; a < kN; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][c][e] = 0.f;

  for (int u = 0; u < stages - 1; ++u) fetch(u);
  for (int u = 0; u < total; ++u) {
    cp_async_wait_ring(stages);
    __syncthreads();  // stage u is in; every warp is done with stage u - 1
    fetch(u + stages - 1);
    const T* st = ring + (u % stages) * C::kStage;
    const int p = u % per_tile;
    if (p < n_su) {
      if (p == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = (s_cols * p + h) * kChunk;
        if (h >= s_cols || col >= d) break;
        const int lda = res ? ldr : kLdC;
        const T* qa = res ? qr + mq * 16 * ldr + col : st + mq * 16 * kLdC;
        const T* da = res ? dor + mq * 16 * ldr + col
                          : st + kCe + mq * 16 * kLdC;
        const T* ka = st + (res ? 2 * h : 2) * kCe + kh * 32 * kLdC;
        if constexpr (C::kF32) {
          s_chunk(s, qa, lda, ka, kLdC, lane);
          s_chunk(dp, da, lda, ka + kCe, kLdC, lane);
        } else {
          s_chunk16<T>(s, qa, lda, ka, kLdC, lane);
          s_chunk16<T>(dp, da, lda, ka + kCe, kLdC, lane);
        }
      }
      if (p == n_su - 1)  // ds of the tile, whole at the next barrier
        ds_tile(dss, s, dp, l, dl, q0, (u / per_tile) * kTile, tq, tk, diag,
                causal, scale, mq, kh, g, t);
    } else {
      // dQ += dS K over this stage's k chunks
      const int pu = p - n_su;
      const T* da = dss + rg * 32 * ld_p<T>();
#pragma unroll
      for (int c = 0; c < kN; ++c)
        if (c / 4 == pu && c < nc) {
          const T* kc = st + (c % 4) * kCe + cg * 16;
          if constexpr (C::kF32)
            pv_unit<2>(acc[c], da, kc, lane);
          else
            pv16<T, 2>(acc[c], da, kc, lane);
        }
    }
  }
  cp_async_wait<0>();

  store_dq(dq + (size_t)bh * tq * d + c0, acc, q0, tq, d, nc, rg, cg, g, t);
}

// ---- K2c ---------------------------------------------------------------

// shared memory of the dk/dv backward above D 128: k and v where resident,
// the ring, p^T and ds^T
template <typename T>
inline size_t dkv_tc_smem(int d, int stages, bool res) {
  return sizeof(T) * ((res ? 2 * (size_t)kTile * (d + 8) : 0) +
                      (size_t)stages * Bwd<T>::kStage +
                      2 * kTile * ld_p<T>());
}

// K2c above D 128: one block per (bh, 64-key tile, slice of `cols` <= 256
// columns of dk and dv). Per query tile: S and dP over all of D from the S
// stages (streamed: q, do, k and v chunks of one column; k and v resident:
// q and do chunks of two), p and ds to shared memory key-major in T, then
// dV += P^T dO and dK += dS^T Q from stages of q and do chunks of the
// block's columns (a column of chunks a stage in float32, two in 16-bit).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int tq, int tk, int d, int cols,
                  float scale, int causal, int stages_arg, int res_arg) {
  using C = Bwd<T>;
  constexpr int kCe = C::kCe;
  constexpr int kLd = ld_p<T>();
  const int stages = C::kStages ? C::kStages : stages_arg;
  const int res = C::kF32 ? 0 : res_arg;
  extern __shared__ __align__(128) unsigned char bsmem[];
  const int ldr = d + 8;               // resident rows' stride
  T* kr = reinterpret_cast<T*>(bsmem);
  T* vr = kr + (res ? kTile * ldr : 0);
  T* ring = vr + (res ? kTile * ldr : 0);
  T* pt = ring + stages * C::kStage;   // p^T [key][query]
  T* dst = pt + kTile * kLd;           // ds^T

  // blocks by key tile, the first (the longest when causal) first, then by
  // bh
  const int n_kt = (tk + kTile - 1) / kTile;
  const int n_bh = gridDim.x / n_kt;
  const int bh = blockIdx.x % n_bh;
  const int k0 = (int)(blockIdx.x / n_bh) * kTile;
  const int c0 = blockIdx.y * cols;    // this block's columns
  const int nc = min(cols, d - c0) / kChunk;
  const int diag = tk - tq;
  const T* qb = q + (size_t)bh * tq * d;
  const T* dob = dout + (size_t)bh * tq * d;
  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * d;
  const float* lseb = lse + (size_t)bh * tq;
  const float* dlb = delta + (size_t)bh * tq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  if (res) {  // k and v, once: their own cp.async group, ahead of the ring's
    load_rows(kr, kb, k0, tk, d);
    load_rows(vr, vb, k0, tk, d);
    cp_async_commit();
  }

  // stages of a query tile: n_su S stages of s_cols columns of chunks, then
  // n_pu of q and do chunks of kPc of this block's columns
  const int s_cols = res ? 2 : 1;
  const int n_su = (d / kChunk + s_cols - 1) / s_cols;
  const int n_pu = (nc + C::kPc - 1) / C::kPc;
  const int per_tile = n_su + n_pu;
  const int n_qt = (tq + kTile - 1) / kTile;
  // causal: the first query tile that reaches key k0 holds q_pos = k0 - diag
  const int i0 = causal ? max(0, k0 - diag) / kTile : 0;
  const int total = max(0, n_qt - i0) * per_tile;
  auto fetch = [&](int u) {
    if (u < total) {
      const int q0 = (i0 + u / per_tile) * kTile, p = u % per_tile;
      T* st = ring + (u % stages) * C::kStage;
      if (p < n_su && !res) {  // q, do, k and v chunks
        const int col = p * kChunk;
        load_chunk(st, qb, q0, tq, d, col);
        load_chunk(st + kCe, dob, q0, tq, d, col);
        load_chunk(st + 2 * kCe, kb, k0, tk, d, col);
        load_chunk(st + 3 * kCe, vb, k0, tk, d, col);
      } else {  // q and do chunks h at 2h, 2h + 1: all of D, or the block's
        for (int h = 0; h < (p < n_su ? 2 : C::kPc); ++h) {
          const int c = (p < n_su ? 2 * p : C::kPc * (p - n_su)) + h;
          const int col = p < n_su ? c * kChunk : c0 + c * kChunk;
          if (p < n_su ? col < d : c < nc) {
            load_chunk(st + 2 * h * kCe, qb, q0, tq, d, col);
            load_chunk(st + (2 * h + 1) * kCe, dob, q0, tq, d, col);
          }
        }
      }
    }
    cp_async_commit();
  };

  // S-phase roles: queries 16 * (warp / 2) + g (+ 8), keys 32 * (warp % 2)
  // + 8 n + 2t (+ 1); product roles: keys 16 * (warp % 4) + g (+ 8),
  // columns 32 * (warp / 4) + 8 ni + 2t (+ 1) of a chunk
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

  for (int u = 0; u < stages - 1; ++u) fetch(u);
  for (int u = 0; u < total; ++u) {
    cp_async_wait_ring(stages);
    __syncthreads();  // stage u is in; every warp is done with stage u - 1
    fetch(u + stages - 1);
    const T* st = ring + (u % stages) * C::kStage;
    const int q0 = (i0 + u / per_tile) * kTile, p = u % per_tile;
    if (p < n_su) {
      if (p == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = (s_cols * p + h) * kChunk;
        if (h >= s_cols || col >= d) break;
        const T* qa = st + 2 * h * kCe + mq * 16 * kLdC;
        const int ldb = res ? ldr : kLdC;
        const T* ka = res ? kr + kh * 32 * ldr + col
                          : st + 2 * kCe + kh * 32 * kLdC;
        const T* va = res ? vr + kh * 32 * ldr + col : ka + kCe;
        if constexpr (C::kF32) {
          s_chunk(s, qa, kLdC, ka, ldb, lane);
          s_chunk(dp, qa + kCe, kLdC, va, ldb, lane);
        } else {
          s_chunk16<T>(s, qa, kLdC, ka, ldb, lane);
          s_chunk16<T>(dp, qa + kCe, kLdC, va, ldb, lane);
        }
      }
      if (p == n_su - 1)  // p and ds of the tile, to shared memory
        p_ds_tile(pt, dst, s, dp, lseb, dlb, q0, k0, tq, tk, diag, causal,
                  scale, mq, kh, g, t);
    } else {
      // dV += P^T dO and dK += dS^T Q over this stage's columns
      const int ci = C::kPc * (p - n_su);
      const T* pa = pt + mk * 16 * kLd;
      const T* da = dst + mk * 16 * kLd;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c - ci;
        if (h >= 0 && h < C::kPc && c < nc) {
          const T* qc = st + 2 * h * kCe + ch * 32;
          if constexpr (C::kF32) {
            kv_chunk(dv_acc[c], pa, qc + kCe, lane);
            kv_chunk(dk_acc[c], da, qc, lane);
          } else {
            kv_chunk16<T>(dv_acc[c], pa, qc + kCe, lane);
            kv_chunk16<T>(dk_acc[c], da, qc, lane);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // k and v's group, where no query tile came

  T* dkb = dk + (size_t)bh * tk * d;
  T* dvb = dv + (size_t)bh * tk * d;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= nc) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + mk * 16 + g + 8 * r;
      if (key >= tk) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const size_t at = (size_t)key * d + c0 + c * kChunk + ch * 32 +
                          ni * 8 + 2 * t;
        store2(dkb + at, dk_acc[c][ni][2 * r], dk_acc[c][ni][2 * r + 1]);
        store2(dvb + at, dv_acc[c][ni][2 * r], dv_acc[c][ni][2 * r + 1]);
      }
    }
  }
}

// blocks a SM of the dk/dv backward at head dim D <= 128: at D 128 its k
// and v tiles leave room for one
constexpr int dkv_res_blocks(int d) { return d > 64 ? 1 : 2; }

// shared memory of the dk/dv backward at head dim D <= 128 with `stages`
// ring stages: k and v resident, p^T and ds^T, the ring of q and do chunks
inline size_t dkv_res_smem(int d, int stages) {
  return sizeof(float) * (2 * (size_t)kTile * (d + 8) + 2 * kTile * kLdP +
                          (size_t)stages * kChunkFloats);
}

// K2c at D 64 and 128: the block's k and v tiles stay in shared memory and
// only q and do stream through the ring, one 64-column chunk a stage. Per
// query tile, with n = D / 64, the 4n - 1 stages are do chunks 0..n-1 (dP
// = dO V^T), q chunks 0..n-1 (S = Q K^T; after the last, p and ds to
// shared memory and dK's chunk n-1 from the same stage), q chunks n-2..0
// (dK += dS^T Q), do chunks 0..n-1 (dV += P^T dO). Warp roles as
// dkv_tc_kernel's; dk and dv are 2 x 64 x D f32 over the block, D / 4
// registers a thread each. Two blocks a SM at D 64.
template <int D>
__global__ void __launch_bounds__(kThreads, dkv_res_blocks(D))
    dkv_res_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int tq, int tk, float scale,
                   int causal, int stages) {
  constexpr int kN = D / kChunk;       // chunks of D
  constexpr int kLdR = D + 8;          // resident rows' stride (8 mod 32)
  constexpr int kPer = 4 * kN - 1;     // stages a query tile
  extern __shared__ __align__(128) float smem[];
  float* kr = smem;
  float* vr = kr + kTile * kLdR;
  float* pt = vr + kTile * kLdR;       // p^T [key][query]
  float* dst = pt + kTile * kLdP;      // ds^T
  float* ring = dst + kTile * kLdP;

  // blocks by key tile, the first (the longest when causal) first, then by
  // bh
  const int n_kt = (tk + kTile - 1) / kTile;
  const int n_bh = gridDim.x / n_kt;
  const int bh = blockIdx.x % n_bh;
  const int k0 = (int)(blockIdx.x / n_bh) * kTile;
  const int diag = tk - tq;
  const float* qb = q + (size_t)bh * tq * D;
  const float* dob = dout + (size_t)bh * tq * D;
  const float* lseb = lse + (size_t)bh * tq;
  const float* dlb = delta + (size_t)bh * tq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  // k and v, once: their own cp.async group, ahead of the ring's
  {
    const float* kb = k + (size_t)bh * tk * D;
    const float* vb = v + (size_t)bh * tk * D;
    for (int c = threadIdx.x; c < kTile * (D / 4); c += kThreads) {
      const int r = c / (D / 4), e = (c % (D / 4)) * 4;
      const bool ok = k0 + r < tk;
      const size_t at = (size_t)(ok ? k0 + r : 0) * D + e;
      cp_async16(kr + r * kLdR + e, kb + at, ok);
      cp_async16(vr + r * kLdR + e, vb + at, ok);
    }
    cp_async_commit();
  }

  const int n_qt = (tq + kTile - 1) / kTile;
  // causal: the first query tile that reaches key k0 holds q_pos = k0 - diag
  const int i0 = causal ? max(0, k0 - diag) / kTile : 0;
  const int total = max(0, n_qt - i0) * kPer;
  // stage j of a query tile: whether it holds do, and its chunk
  auto is_do = [](int j) { return j < kN || j >= 3 * kN - 1; };
  auto chunk = [](int j) {
    return j < kN ? j : j < 2 * kN ? j - kN
                      : j < 3 * kN - 1 ? 3 * kN - 2 - j : j - (3 * kN - 1);
  };
  auto fetch = [&](int f) {
    if (f < total) {
      const int q0 = (i0 + f / kPer) * kTile, j = f % kPer;
      load_chunk(ring + (f % stages) * kChunkFloats, is_do(j) ? dob : qb, q0,
                 tq, D, chunk(j) * kChunk);
    }
    cp_async_commit();
  };

  // S-phase roles: queries 16 * (warp / 2) + g (+ 8), keys 32 * (warp % 2)
  // + 8 n + 2t (+ 1); product roles: keys 16 * (warp % 4) + g (+ 8),
  // columns 32 * (warp / 4) + 8 ni + 2t (+ 1) of a chunk
  const int mq = warp >> 1, kh = warp & 1;
  const int mk = warp & 3, ch = warp >> 2;
  float s[4][4], dp[4][4];
  float dv_acc[kN][4][4], dk_acc[kN][4][4];
#pragma unroll
  for (int a = 0; a < kN; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[a][b][e] = dk_acc[a][b][e] = 0.f;
  const float* pa = pt + mk * 16 * kLdP;
  const float* da = dst + mk * 16 * kLdP;

  for (int f = 0; f < stages - 1; ++f) fetch(f);
  for (int f = 0; f < total; ++f) {
    cp_async_wait_ring(stages);
    __syncthreads();  // stage f is in; every warp is done with stage f - 1
    fetch(f + stages - 1);
    const float* st = ring + (f % stages) * kChunkFloats;
    const int q0 = (i0 + f / kPer) * kTile, j = f % kPer, c = chunk(j);
    if (j < 2 * kN) {
      if (j == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      const float* a = st + mq * 16 * kLdC;
      const int bo = kh * 32 * kLdR + c * kChunk;
      if (j < kN)
        s_chunk(dp, a, kLdC, vr + bo, kLdR, lane);
      else
        s_chunk(s, a, kLdC, kr + bo, kLdR, lane);
      if (j == 2 * kN - 1) {
        // p and ds of the tile, to shared memory key-major
        p_ds_tile(pt, dst, s, dp, lseb, dlb, q0, k0, tq, tk, diag, causal,
                  scale, mq, kh, g, t);
        __syncthreads();  // p^T and ds^T are whole
        kv_chunk(dk_acc[kN - 1], da, st + ch * 32, lane);
      }
    } else {
      // dK += dS^T Q or dV += P^T dO over chunk c
#pragma unroll
      for (int cc = 0; cc < kN; ++cc)
        if (cc == c) {
          if (is_do(j))
            kv_chunk(dv_acc[cc], pa, st + ch * 32, lane);
          else
            kv_chunk(dk_acc[cc], da, st + ch * 32, lane);
        }
    }
  }
  cp_async_wait<0>();  // k and v's group, where no query tile came

  float* dkb = dk + (size_t)bh * tk * D;
  float* dvb = dv + (size_t)bh * tk * D;
#pragma unroll
  for (int cc = 0; cc < kN; ++cc)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + mk * 16 + g + 8 * r;
      if (key >= tk) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const size_t at =
            (size_t)key * D + cc * kChunk + ch * 32 + ni * 8 + 2 * t;
        *reinterpret_cast<float2*>(dkb + at) =
            make_float2(dk_acc[cc][ni][2 * r], dk_acc[cc][ni][2 * r + 1]);
        *reinterpret_cast<float2*>(dvb + at) =
            make_float2(dv_acc[cc][ni][2 * r], dv_acc[cc][ni][2 * r + 1]);
      }
    }
}

inline int n_tiles(int t) { return (t + kTile - 1) / kTile; }

// a multiple of 64, from 64 up
inline bool dim_ok(int d) { return d >= kChunk && d % kChunk == 0; }

// the columns of each of ceil(d / most) slices of d, as even as whole
// chunks allow (d 576 by at most 512: 320; by at most 256: 192)
inline int slice_cols(int d, int most) {
  const int slices = (d + most - 1) / most;
  return (d / kChunk + slices - 1) / slices * kChunk;
}

// the most ring stages, at least 2, whose shared memory `bytes(stages)`
// leaves `blocks` blocks a SM
template <typename F>
int ring_stages(F bytes, int blocks) {
  int stages = kMaxStages;
  while (stages > 2 && bytes(stages) > smem_budget(blocks)) --stages;
  return stages;
}

template <int SW>
int launch_fwd(int d, const float* q, const float* k, const float* v,
               float* o, float* lse, int bh, int tq, int tk, float scale,
               int causal, cudaStream_t stream) {
  using C = Fwd<SW>;
  const int stages = ring_stages(
      [&](int n) { return fwd_smem(d, n, C::kHalves); }, C::kBlocks);
  const size_t smem = fwd_smem(d, stages, C::kHalves);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_tc_kernel<SW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh * n_tiles(tq), (d + SW - 1) / SW);
  fwd_tc_kernel<SW><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, tq, tk, d, scale, causal, stages);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_res(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dk, float* dv, int bh, int tq, int tk, float scale,
                   int causal, cudaStream_t stream) {
  const int stages = ring_stages(
      [](int n) { return dkv_res_smem(D, n); }, dkv_res_blocks(D));
  const size_t smem = dkv_res_smem(D, stages);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_res_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dkv_res_kernel<D><<<bh * n_tiles(tk), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, tq, tk, scale, causal, stages);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_res(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  float* dq, int bh, int tq, int tk, float scale, int causal,
                  cudaStream_t stream) {
  const int stages = ring_stages(
      [](int n) { return dq_res_smem(D, n); }, dq_res_blocks(D));
  const size_t smem = dq_res_smem(D, stages);
  cudaError_t err = cudaFuncSetAttribute(
      dq_res_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dq_res_kernel<D><<<bh * n_tiles(tq), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, tq, tk, scale, causal, stages);
  return (int)cudaGetLastError();
}

// The dq backward above D 128 in T: q and do resident where two ring
// stages fit beside them (16-bit up to D 576), slices of at most DM
// columns of dq, each a block per query tile
template <typename T, int DM>
int launch_dq_tc(int d, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int bh, int tq, int tk, float scale, int causal,
                 cudaStream_t stream) {
  const bool res = !Bwd<T>::kF32 && dq_tc_smem<T>(d, 2, true) <=
                                         smem_budget(1);
  const int stages = Bwd<T>::kStages
                         ? Bwd<T>::kStages
                         : ring_stages(
                               [&](int n) { return dq_tc_smem<T>(d, n, res); },
                               1);
  const size_t smem = dq_tc_smem<T>(d, stages, res);
  cudaError_t err = cudaFuncSetAttribute(
      dq_tc_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cols = slice_cols(d, DM);
  const dim3 grid(bh * n_tiles(tq), (d + cols - 1) / cols);
  dq_tc_kernel<T, DM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), tq, tk, d, cols, scale, causal, stages, (int)res);
  return (int)cudaGetLastError();
}

// The dk/dv backward above D 128 in T: k and v resident where two ring
// stages fit beside them (16-bit up to D 512), slices of at most 256
// columns of dk and dv, each a block per key tile
template <typename T>
int launch_dkv_tc(int d, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int bh, int tq, int tk, float scale,
                  int causal, cudaStream_t stream) {
  const bool res = !Bwd<T>::kF32 && dkv_tc_smem<T>(d, 2, true) <=
                                         smem_budget(1);
  const int stages = Bwd<T>::kStages
                         ? Bwd<T>::kStages
                         : ring_stages(
                               [&](int n) { return dkv_tc_smem<T>(d, n, res); },
                               1);
  const size_t smem = dkv_tc_smem<T>(d, stages, res);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cols = slice_cols(d, kSlice);
  const dim3 grid(bh * n_tiles(tk), (d + cols - 1) / cols);
  dkv_tc_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, d, cols, scale,
      causal, stages, (int)res);
  return (int)cudaGetLastError();
}

// the wide forward: q resident where three ring stages fit beside it
// (16-bit up to D 832, float32 up to 384; streamed, a third more bytes a
// key tile, above), ceil(d / MC) slices of o, their widths as even as whole
// chunks allow (D 576: 320 and 256), each a block per query tile
template <typename T>
int launch_fwd_wide(int d, const void* q, const void* k, const void* v,
                    void* o, float* lse, int bh, int tq, int tk, float scale,
                    int causal, cudaStream_t stream) {
  constexpr int kMc = wide_cols<T>();
  const bool qres = wide_smem<T>(d, 3, true) <= smem_budget(1);
  const int stages = ring_stages(
      [&](int n) { return wide_smem<T>(d, n, qres); }, 1);
  const size_t smem = wide_smem<T>(d, stages, qres);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_wide_tc_kernel<T, kMc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cols = slice_cols(d, kMc);
  const dim3 grid(bh * n_tiles(tq), (d + cols - 1) / cols);
  fwd_wide_tc_kernel<T, kMc><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, tq, tk, d, cols,
      scale, causal, stages, (int)qres);
  return (int)cudaGetLastError();
}

}  // namespace

// K2a. q (bh, tq, d), k and v (bh, tk, d) f32 -> o (bh, tq, d), lse (bh,
// tq). d: 64, 128, 192 or 256 (above, flash_attention_fwd_wide); anything
// else is refused.
extern "C" int flash_attention_fwd_tf32(int device, int d, const float* q,
                                        const float* k, const float* v,
                                        float* o, float* lse, int bh, int tq,
                                        int tk, float scale, int causal,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dim_ok(d) || d > kSlice) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_fwd<64>(d, q, k, v, o, lse, bh, tq, tk, scale, causal, st);
  if (d == 128)
    return launch_fwd<128>(d, q, k, v, o, lse, bh, tq, tk, scale, causal, st);
  return launch_fwd<kSlice>(d, q, k, v, o, lse, bh, tq, tk, scale, causal,
                            st);
}

// K2b in the "tc-f32" (dtype 0 = float32) and "tc-wide" (1 = bfloat16, 2 =
// float16) designs. q (bh, tq, d), k and v (bh, tk, d), dout (bh, tq, d)
// of that type, lse and delta (bh, tq) f32 -> dq (bh, tq, d) of that type.
// d: any multiple of 64; anything else is refused.
extern "C" int flash_attention_dq_tc(int device, int dtype, int d,
                                     const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, int bh, int tq, int tk,
                                     float scale, int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dim_ok(d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *df = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  if (dtype == 0 && d == 64)
    return launch_dq_res<64>(qf, kf, vf, df, lse, delta, dqf, bh, tq, tk,
                             scale, causal, st);
  if (dtype == 0 && d == 128)
    return launch_dq_res<128>(qf, kf, vf, df, lse, delta, dqf, bh, tq, tk,
                              scale, causal, st);
  if (dtype == 0 && d <= kSlice)
    return launch_dq_tc<float, kSlice>(d, q, k, v, dout, lse, delta, dq, bh,
                                       tq, tk, scale, causal, st);
  if (dtype == 0)
    return launch_dq_tc<float, kDqCols>(d, q, k, v, dout, lse, delta, dq, bh,
                                        tq, tk, scale, causal, st);
  if (dtype == 1)
    return launch_dq_tc<__nv_bfloat16, kDqCols>(
        d, q, k, v, dout, lse, delta, dq, bh, tq, tk, scale, causal, st);
  if (dtype == 2)
    return launch_dq_tc<__half, kDqCols>(d, q, k, v, dout, lse, delta, dq, bh,
                                         tq, tk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// K2c in the same designs: the same inputs -> dk, dv (bh, tk, d) of that
// type; dtype and d as K2b's.
extern "C" int flash_attention_dkv_tc(int device, int dtype, int d,
                                      const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dk, void* dv, int bh, int tq,
                                      int tk, float scale, int causal,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dim_ok(d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *df = static_cast<const float*>(dout);
  float *dkf = static_cast<float*>(dk), *dvf = static_cast<float*>(dv);
  if (dtype == 0 && d == 64)
    return launch_dkv_res<64>(qf, kf, vf, df, lse, delta, dkf, dvf, bh, tq,
                              tk, scale, causal, st);
  if (dtype == 0 && d == 128)
    return launch_dkv_res<128>(qf, kf, vf, df, lse, delta, dkf, dvf, bh, tq,
                               tk, scale, causal, st);
  if (dtype == 0)
    return launch_dkv_tc<float>(d, q, k, v, dout, lse, delta, dk, dv, bh, tq,
                                tk, scale, causal, st);
  if (dtype == 1)
    return launch_dkv_tc<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dk, dv,
                                        bh, tq, tk, scale, causal, st);
  if (dtype == 2)
    return launch_dkv_tc<__half>(d, q, k, v, dout, lse, delta, dk, dv, bh, tq,
                                 tk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// K2a in the "tc-wide" design. dtype: 0 = float32, 1 = bfloat16, 2 =
// float16; q (bh, tq, d), k and v (bh, tk, d) of that type -> o (bh, tq, d)
// of it, lse (bh, tq) f32. d: any multiple of 64; anything else is refused.
extern "C" int flash_attention_fwd_wide(int device, int dtype, int d,
                                        const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int bh, int tq, int tk, float scale,
                                        int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dim_ok(d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_wide<float>(d, q, k, v, o, lse, bh, tq, tk, scale,
                                  causal, st);
  if (dtype == 1)
    return launch_fwd_wide<__nv_bfloat16>(d, q, k, v, o, lse, bh, tq, tk,
                                          scale, causal, st);
  if (dtype == 2)
    return launch_fwd_wide<__half>(d, q, k, v, o, lse, bh, tq, tk, scale,
                                   causal, st);
  return (int)cudaErrorInvalidValue;
}
