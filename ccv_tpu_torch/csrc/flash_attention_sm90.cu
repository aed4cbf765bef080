// Flash attention for Hopper (sm_90a) at bf16 and float16, head dim 32, 64,
// 128 or 256: the forward (K2a), the dq backward (K2b) and the dk/dv backward
// (K2c) around wgmma, TMA and register-resident accumulators. Every 16-bit
// head dim up to 256 runs here; float32, and every type above D 256, run the
// mma.sync designs of flash_attention_tf32.cu. Ports of the Pallas TPU
// kernels in ccv_tpu/ops/pallas/flash_attention.py:
//   K2a  _flash_kernel  (via _flash_fwd_bthd)
//   K2b  _dq_kernel     (via _flash_bwd_bthd)
//   K2c  _dkv_kernel    (via _flash_bwd_bthd)
//
// What they compute, on (BH, T, D) row-major bf16 or float16 tensors, D =
// 32, 64, 128 or 256 (lse and delta are (BH, Tq) f32):
//   s = (q . k) * scale in f32; a key counts if k_pos < Tk and, when causal,
//   k_pos <= q_pos + (Tk - Tq) (bottom-right). Masked scores are -1e30.
//   K2a: online softmax over key tiles; p is rounded to the input type
//        before p @ v; o = acc / max(l, 1e-30); lse = m + log(l) (natural
//        log: the kernel keeps m in base 2 and converts before the store).
//   K2b: p = exp(s - lse) (0 where masked), dp = do . v,
//        ds = p * (dp - delta) * scale, rounded to the input type;
//        dq = sum_k ds k.
//   K2c: the same p and ds; dv = sum_q p^T do, dk = sum_q ds^T q.
//   p and ds are rounded to the input type before their products, which
//   accumulate in f32. The element type T is a template parameter: the two
//   types differ only in the wgmma instruction's type suffix, the TMA data
//   type and the f32 conversions.
//
// Bound on this card. At the LM's shape (BH 128, T 1024, D 64, causal) K2a
// does 17.2 GFLOP on 67.6 MB, K2b 25.8 GFLOP on 84.9 MB and K2c 34.4 GFLOP
// on 101.7 MB: at the H100's 989 TFLOP/s bf16 and 3.35 TB/s the bounds are
// 0.020 ms (bytes), 0.026 ms and 0.035 ms (operations); at BH 32, D 256 and
// at BH 256, D 32 the same work and about the same bytes, so the same
// bounds. The tile products are what the tensor cores must do fast, and on
// Hopper only wgmma reaches their full rate. At D 32 the exponentials set a
// floor that the roofline leaves out: BH 256 x 524,800 causal pairs is 134 M
// exp2 a kernel, and the SFU computes 16 a clock an SM (about 3.7 T/s over 132
// SMs at ~1.75 GHz): ~0.036 ms, above K2a's bytes bound (K2b and K2c form p
// once more each).
//
// Design (FlashAttention-3's layout, without its pingpong and
// intra-warpgroup overlap):
//   K2a: one block per (bh, 128-query tile): two consumer warpgroups of 64
//   query rows and one producer warp (at D 256 a 64-query tile and one
//   consumer warpgroup: see kFwdGroups). The producer TMA-loads the q tile
//   once and streams 64-key k and v tiles through a 2-stage ring, signalled
//   by mbarriers (full: bytes landed; empty: all 8 consumer warps done).
//   S = Q K^T is a wgmma with both operands in shared memory (128-byte
//   swizzle: a 16-bit row of 64 is exactly 128 B; above D 64 a tile is
//   D / 64 such 64-column halves, one after the other, each TMA-loaded as
//   its own box, and the K steps over D address half kk / 4); S stays
//   in registers, the
//   row max and row sum reduce over the 4 threads of a quad, only tiles on
//   the causal diagonal or the ragged tail run the mask, and P is rounded
//   to the input type in registers, where the accumulator layout of S is
//   already the A-operand layout of O += P V (a register-A wgmma, V
//   MN-major). O stays in registers in f32 until the epilogue (m64n128
//   wgmmas, D / 128 of them above D 64, whose MN-major V operand steps from
//   one half to the next by the descriptor's leading byte offset). TMA
//   zero-fills rows past T.
//   K2c: one block per (bh, 64-key tile): one consumer warpgroup and a
//   producer warp. K and V are TMA-loaded once; the producer streams q and
//   do tiles (TMA) and their lse and delta rows (plain loads) from the
//   first query tile that reaches the key tile. S^T = K Q^T and
//   dP^T = V dO^T are shared-memory wgmmas, so P^T and dS^T come out in
//   accumulator layout (a row is a key, a column a query,
//   whose lse and delta are read from the staged rows); rounded to the
//   input type they are the A operands of dV += P^T dO and dK += dS^T Q
//   (register-A wgmmas, dO and Q MN-major). dK and dV stay in registers; no
//   atomics, so the gradients are deterministic. At D 256 the two
//   accumulators would take 256 registers a thread, past the 255 a thread
//   may have, so D 256 runs two blocks per key tile, each owning 128
//   columns of dK and dV (128 registers); each computes the whole S^T and
//   dP^T itself (over all of D: half as many products again as one block
//   holding all columns would do, and no exchange between the two).
//   K2b: K2a's loop with K2c's arithmetic. One block per (bh, 64-query
//   tile): one consumer warpgroup and a producer warp (three 32-register
//   accumulators, S, dP and dQ, and the dS fragments leave no room for a
//   second warpgroup at two blocks a SM). The producer TMA-loads q and do
//   once and streams 64-key k and v tiles through the 2-stage ring.
//   S = Q K^T and dP = dO V^T are shared-memory wgmmas (all four operands
//   K-major); each thread owns query rows r0 and r0 + 8 for the whole
//   block, so their lse and delta are loaded once into registers; dS is
//   packed to the input type in registers, already the A-operand layout of
//   dQ += dS K (a register-A wgmma, K MN-major). dQ stays in registers
//   until the epilogue; no atomics. It asks for 3 blocks a SM at D 64 (the
//   register cap that follows), which measured faster than 2 (PERF.md).
//   No loop has a block barrier: only mbarrier waits and wgmma
//   fence/commit/wait. The longest causal tiles are scheduled first.
//   At D 128 the accumulators over D double (O: 64 f32 registers a thread;
//   dK and dV: 128), so K2a and K2c ask for one block a SM and K2b for two
//   (Sm90Cfg); shared memory is 96 KB a block for each kernel. At D 256 O
//   and dQ take 128 registers, every kernel one warpgroup a block and one
//   block a SM, in 160-192 KB of shared memory (K2a: q 32 KB and a 2-stage
//   k/v ring of 128 KB). This is the D 64 design made wider, not yet tuned
//   for D 128 or 256.
//   At D 32 a 16-bit row is 64 B: tiles are TMA-loaded as boxes of 32
//   columns with 64-byte swizzle, the matrix descriptors take layout B64
//   (8-row atoms 512 B apart), a K step is 32 B inside the row (two over D)
//   and 16 rows (1024 B) down an MN-major tile. The products over D are
//   m64n32 (16 f32 registers a thread): O += P V, dQ += dS K, dV += P^T dO,
//   dK += dS^T Q. A score carries half the matrix work it carries at D 64,
//   so per-tile costs (row max and sum, exp2, mbarrier round trips) weigh
//   twice as much and the exp floor above, not the products, is the one to
//   beat; exp2 is ex2.approx.ftz there (one SFU operation, no range
//   fix-up; exp2f elsewhere). D 32 runs the D 64 design's shape with more
//   blocks in flight: K2a one warpgroup of 64 query rows on 64-key tiles
//   through a 3-stage ring, four blocks a SM; K2b one warpgroup of 64 query
//   rows, three blocks a SM; K2c one of 64 keys, two blocks a SM. Two K2a
//   warpgroups sharing each k / v stage, with or without FA3's ping-pong,
//   and two K2b or K2c warpgroups sharing each streamed stage measured
//   slower on the card (PERF.md): at D 32 the exponentials take far longer
//   than the products, so ordering the groups' wgmmas made each group's
//   exp2 wait for the other's, and one block a SM left fewer warps to hide
//   the SFU latency than four small ones.

// The tensor maps are encoded on the host in the launch function through
// cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint(ByVersion), so
// the library needs no -lcuda; they reach the kernel as __grid_constant__
// parameters. Each entry point launches on the given stream, does not
// synchronise, and returns a CUDA error code as an int (0 = launched).

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
template <typename T>
constexpr bool kIsF16 = std::is_same<T, f16>::value;

constexpr int kRows = 64;                 // rows of a tile (one wgmma M)
constexpr int kStages = 2;                // ring depth
// Columns of one swizzle row ("half" of a tile) at head dim D: 64 (128 B,
// 128-byte swizzle) from D 64 up, 32 (64 B, 64-byte swizzle) at D 32.
template <int D>
constexpr int kSw = D < 64 ? D : 64;
template <int D>
constexpr int kSwBytes = kSw<D> * 2;
// Blocks per SM asked of the compiler for head dim D (it caps registers a
// thread to fit them); what was tried on the card at D 64 is in PERF.md.
template <int D>
struct Sm90Cfg {
  static constexpr int kTileBytes = kRows * D * 2;  // 8 KB at D 64
  static constexpr int kFwdBlocksPerSm = D == 32 ? 4 : D == 64 ? 2 : 1;
  static constexpr int kDkvBlocksPerSm = D <= 64 ? 2 : 1;
  static constexpr int kDqBlocksPerSm = D <= 64 ? 3 : D == 128 ? 2 : 1;
};
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- PTX: shared addresses, mbarriers, TMA ------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// Waits until the phase of parity `parity` of the barrier has completed. A
// wait of more than 2^32 clocks (seconds) can only be a lost arrival: it
// traps, so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ---- PTX: wgmma ----------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins the accumulator registers at this point of the program, so the
// compiler moves no read or write of them across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptor of a tile of swizzle rows of head dim D written by TMA:
// 128-byte rows with 128-byte swizzle (layout B128, atoms of 8 rows 1024 B
// apart: the stride byte offset), or at D 32 64-byte rows with 64-byte
// swizzle (layout B64, atoms 512 B apart). For a K-major operand the
// leading byte offset is unused (a wgmma's 16-element K slice lies inside a
// row); for an MN-major one it is the stride `lbo` between column blocks of
// one swizzle row: an operand one row wide has one (lbo is unused), a
// 128-wide one two, its halves a tile's rows x 128 B apart.
template <int D>
__device__ __forceinline__ uint64_t desc_sw(const void* tile,
                                            uint32_t lbo = 16) {
  const uint64_t addr = smem_u32(tile);
  constexpr uint64_t kLayout = kSwBytes<D> == 128 ? 1 : 2;  // B128 : B64
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(8 * kSwBytes<D> >> 4) << 32) | (kLayout << 62);
}
// Advance of a descriptor by 16 elements of K: 32 B along a K-major row,
// 16 rows (2048 B, or 1024 B at D 32) down an MN-major tile. The start
// address field is in 16-byte units.
constexpr uint64_t kStepKMajor = 32 >> 4;
template <int D>
constexpr uint64_t kStepMNMajor = 16 * kSwBytes<D> >> 4;
// The element offset of column half h of a tile of `rows` rows.
template <int D>
__device__ __forceinline__ int half_at(int rows, int h) {
  return h * rows * kSw<D>;
}
// The descriptor of K step kk (16 columns) of a K-major tile of `rows`
// rows: half kk / (kSw / 16), 32 B a step inside it.
template <int D, typename T>
__device__ __forceinline__ uint64_t kmajor_step(const T* tile, int rows,
                                                int kk) {
  constexpr int kPer = kSw<D> / 16;
  return desc_sw<D>(tile + half_at<D>(rows, kk / kPer)) +
         (kk % kPer) * kStepKMajor;
}

#define WG_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_ACC64(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WG_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

#define WG_ACC16(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// The wgmma instructions of element type TY ("bf16" or "f16").
#define WGMMA_SS(TY)                                                       \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WG_D32      \
  ", %32, %33, p, 1, 1, 0, 0;\n}\n"
#define WGMMA_RS32(TY)                                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " WG_D16      \
  ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
#define WGMMA_RS64(TY)                                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WG_D32      \
  ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
#define WGMMA_RS128(TY)                                                    \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " WG_D64     \
  ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"

// d (64 x 64, f32) = (scale_d ? d : 0) + A (64 x 16) B (16 x 64), both
// from shared memory, both K-major.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (kIsF16<T>)
    asm volatile(WGMMA_SS("f16")
                 : WG_ACC32(d)
                 : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile(WGMMA_SS("bf16")
                 : WG_ACC32(d)
                 : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, N = 32, 64 or 128) += A (64 x 16, 16-bit pairs in registers)
// B (16 x N, shared, MN-major: N / 64 halves, or at N 32 one 64-byte row);
// d is N / 2 registers.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "m64n32, m64n64, m64n128");
  if constexpr (N == 32 && kIsF16<T>)
    asm volatile(WGMMA_RS32("f16")
                 : WG_ACC16(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  else if constexpr (N == 32)
    asm volatile(WGMMA_RS32("bf16")
                 : WG_ACC16(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  else if constexpr (N == 64 && kIsF16<T>)
    asm volatile(WGMMA_RS64("f16")
                 : WG_ACC32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  else if constexpr (N == 64)
    asm volatile(WGMMA_RS64("bf16")
                 : WG_ACC32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  else if constexpr (kIsF16<T>)
    asm volatile(WGMMA_RS128("f16")
                 : WG_ACC64(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  else
    asm volatile(WGMMA_RS128("bf16")
                 : WG_ACC64(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
}

// The descriptor of the MN-major operand made of columns col0 .. col0 +
// N - 1 (col0 a multiple of kSw) of a tile of head dim D and kRows rows:
// N = kSw is one half (lbo unused), N = 128 two, a tile's rows x 128 B
// apart.
template <int N, int D, typename T>
__device__ __forceinline__ uint64_t mn_desc(const T* tile, int col0) {
  const T* at = tile + half_at<D>(kRows, col0 / kSw<D>);
  return N == kSw<D> ? desc_sw<D>(at) : desc_sw<D>(at, kRows * 128);
}

// d (64 x N, f32; N / 2 registers) += A (64 x 16: the K step kk of a
// product over the tile's rows, in registers) times rows 16 kk .. 16 kk +
// 15 of columns col0 .. col0 + N - 1 of an MN-major tile of head dim D
// (kRows rows a column half): one m64n32, m64n64 or m64n128 wgmma, or
// N / 128 of the latter.
template <typename T, int N, int D>
__device__ __forceinline__ void wgmma_rs_cols(float* d, const uint32_t* a,
                                              const T* tile, int col0,
                                              int kk) {
  constexpr int kN = N < 128 ? N : 128;
#pragma unroll
  for (int c = 0; c < N / kN; ++c)
    wgmma_rs<T, kN>(d + c * (kN / 2), a,
                    mn_desc<kN, D>(tile, col0 + c * kN) +
                        kk * kStepMNMajor<D>);
}

// Two f32 values as one register of the element type (lo in the low half),
// and stored as a pair to global memory.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsF16<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2<T>(lo, hi);
}

// Accumulator layout of an m64nN wgmma: thread t of the warpgroup holds, for
// each 8-column block j, rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8,
// columns 8 j + 2 (t % 4) + {0, 1}, as d[4 j + 2 h + c] (h: row r0 + 8 h).
// The pairs d[2 i], d[2 i + 1] of a 16-column block are, in order, the
// four registers of the A operand of the next wgmma over those columns.
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + (i & 1); }

// Number of 64-row tiles of keys that the query rows q_lo .. q_lo+rows-1
// reach.
__device__ __forceinline__ int key_tiles(int q_lo, int rows, int tk, int diag,
                                         int causal) {
  const int n = (tk + kRows - 1) / kRows;
  return causal ? min(n, (q_lo + rows - 1 + diag) / kRows + 1) : n;
}

// 2^x: exp2f, and at D 32, where the exponentials set the floor, the bare
// SFU instruction (ex2.approx.ftz: no range fix-up around it).
template <int D>
__device__ __forceinline__ float exp2_at(float x) {
  if constexpr (D == 32) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
  } else {
    return exp2f(x);
  }
}

// TMA-loads rows row0 .. row0 + rows - 1 of head bh into a tile: one box of
// kSw columns (128 B, the widest a 128-byte swizzle takes, or 64 B at D 32)
// per column half.
template <int D, typename T>
__device__ __forceinline__ void tma_tile(T* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int row0,
                                         int bh) {
#pragma unroll
  for (int h = 0; h < D / kSw<D>; ++h)
    tma_load_3d(dst + half_at<D>(rows, h), map, bar, kSw<D> * h, row0, bh);
}

template <typename T>
__device__ __forceinline__ T* align1024(unsigned char* p) {
  return reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                              ~uintptr_t(1023));
}

// ---- K2a ---------------------------------------------------------------

// Consumer warpgroups of K2a at head dim D (64 query rows each), its query
// rows and its threads (the groups and a producer warp). A block's threads
// count in whole warpgroups against the register file, so 2 groups and the
// producer warp cap a thread at 168 registers, which D 256's O (128) and S
// (32) accumulators and P (16) overflow: D 256 runs one group (cap 255).
// D 32 runs one group at four blocks a SM, which measured faster than two
// sharing each k / v stage (see the header).
template <int D>
constexpr int kFwdGroups = D > 128 || D == 32 ? 1 : 2;
template <int D>
constexpr int kFwdRows = kRows * kFwdGroups<D>;
template <int D>
constexpr int kFwdThreads = 128 * kFwdGroups<D> + 32;
// Depth of K2a's k / v ring: 3 stages at D 32 (8 KB a stage), else 2.
template <int D>
constexpr int kFwdStages = D == 32 ? 3 : kStages;

template <typename T, int D>
struct FwdSmem {
  T q[kFwdRows<D> * D];
  T k[kFwdStages<D>][kRows * D];
  T v[kFwdStages<D>][kRows * D];
  uint64_t q_full, full[kFwdStages<D>], empty[kFwdStages<D>];
};

// One key tile of K2a's online softmax in base 2. sc is the 64 x 64 score
// tile (accumulator layout) of the query rows q_lo + r0 and q_lo + r0 + 8
// against keys k0 ..: it is scaled and, on the causal diagonal or the
// ragged tail, masked; the running max m and this thread's share of the
// row sum l move on, O (D / 2 registers) is rescaled and P is packed to
// the input type into pf (the A operands of O += P V).
template <typename T, int D>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float* o_acc,
                                             uint32_t (&pf)[16], int k0,
                                             int q_lo, int r0, int cq, int tk,
                                             int diag, int causal,
                                             float scale_log2) {
  const bool edge =
      k0 + kRows > tk || (causal && k0 + kRows - 1 > q_lo + diag);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = sc[i] * scale_log2;
    if (edge) {
      const int kp = k0 + acc_col(i) + cq;
      const int qp = q_lo + r0 + acc_row(i);
      if (!(kp < tk && (!causal || kp <= qp + diag))) x = kNegInf;
    }
    sc[i] = x;
  }
  // rows r0 (h = 0) and r0 + 8 (h = 1)
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * h], sc[4 * jj + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    corr[h] = exp2_at<D>(m[h] - m_new);
    m[h] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    sc[i] = exp2_at<D>(sc[i] - m[h]);
    sum[h] += sc[i];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] *= corr[(i >> 1) & 1];
  l[0] = l[0] * corr[0] + sum[0];  // this thread's share of the row
  l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
  for (int t = 0; t < 16; ++t)
    pf[t] = pack2<T>(sc[2 * t], sc[2 * t + 1]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads<D>,
                                  Sm90Cfg<D>::kFwdBlocksPerSm)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    T* __restrict__ o, float* __restrict__ lse, int tq,
                    int tk, float scale_log2, int causal) {
  constexpr int kTileBytes = Sm90Cfg<D>::kTileBytes;
  constexpr int kSt = kFwdStages<D>;
  extern __shared__ unsigned char smem_raw[];
  constexpr int kQRows = kFwdRows<D>;
  FwdSmem<T, D>& sm = *align1024<FwdSmem<T, D>>(smem_raw);
  const int n_qt = (tq + kQRows - 1) / kQRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * kQRows;
  const int diag = tk - tq;
  const int n_kt = key_tiles(q0, kQRows, tk, diag, causal);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kQRows / 16);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kQRows / 16) {
    // producer: the q tile once, then k and v tiles through the ring
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, kQRows * D * 2);
      tma_tile<D>(sm.q, &q_map, &sm.q_full, kQRows, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kSt;
        mbar_wait(&sm.empty[s], ((j / kSt) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        tma_tile<D>(sm.k[s], &k_map, &sm.full[s], kRows, j * kRows, bh);
        tma_tile<D>(sm.v[s], &v_map, &sm.full[s], kRows, j * kRows, bh);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q_lo .. q_lo + 63
  const int wg = threadIdx.x / 128;
  const int r0 = 16 * (warp % 4) + lane / 4;  // this thread's rows r0, r0+8
  const int cq = 2 * (lane % 4);              // and columns 8j + cq + {0,1}
  const int q_lo = q0 + kRows * wg;
  const int n_kt_wg = q_lo < tq ? key_tiles(q_lo, kRows, tk, diag, causal) : 0;
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // this warpgroup's 64 rows of each column half of the q tile
  const T* q_wg = sm.q + kRows * kSw<D> * wg;

  mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kSt;
    mbar_wait(&sm.full[s], (j / kSt) & 1);
    if (j < n_kt_wg) {
      float sc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T>(sc, kmajor_step<D>(q_wg, kQRows, kk),
                    kmajor_step<D>(sm.k[s], kRows, kk), kk);
      wg_commit();
      wg_wait_all();
      fence_regs(sc);
      uint32_t pf[16];
      softmax_tile<T, D>(sc, m, l, o_acc, pf, j * kRows, q_lo, r0, cq, tk,
                         diag, causal, scale_log2);

      fence_regs(o_acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs_cols<T, D, D>(o_acc, pf + 4 * kk, sm.v[s], 0, kk);
      wg_commit();
      wg_wait_all();
      fence_regs(o_acc);
    }
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  // epilogue: the row sums over the quad, o = acc / l, lse = m ln 2 + ln l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q_lo + r0 + 8 * h;
    if (qp >= tq) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    T* orow = o + ((size_t)bh * tq + qp) * D + cq;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      store2<T>(orow + 8 * jj, o_acc[4 * jj + 2 * h] * inv,
                o_acc[4 * jj + 2 * h + 1] * inv);
    if (cq == 0)
      lse[(size_t)bh * tq + qp] = m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f));
  }
}

// ---- K2c ---------------------------------------------------------------

constexpr int kDkvThreads = 128 + 32;  // 1 warpgroup + producer
// Blocks of K2c per key tile at head dim D, each owning D / split columns
// of dK and dV: their accumulators take D registers a thread, past the 255
// a thread may have at D 256 (and two warpgroups in one block would cap a
// thread at 168, as in K2a).
template <int D>
constexpr int kDkvSplit = D > 128 ? D / 128 : 1;

template <typename T, int D>
struct DkvSmem {
  T k[kRows * D];
  T v[kRows * D];
  T q[kStages][kRows * D];
  T dout[kStages][kRows * D];
  float lse[kStages][kRows];
  float delta[kStages][kRows];
  uint64_t kv_full, full[kStages], empty[kStages];
};

template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads, Sm90Cfg<D>::kDkvBlocksPerSm)
    dkv_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int tq, int tk, float scale,
                    int causal) {
  constexpr int kTileBytes = Sm90Cfg<D>::kTileBytes;
  constexpr int kCols = D / kDkvSplit<D>;  // columns of dK and dV it owns
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<T, D>& sm = *align1024<DkvSmem<T, D>>(smem_raw);
  const int n_kt = (tk + kRows - 1) / kRows;
  const int tile = blockIdx.x / kDkvSplit<D>;
  const int c0 = (int)(blockIdx.x % kDkvSplit<D>) * kCols;
  const int bh = tile / n_kt;
  const int k0 = (tile % n_kt) * kRows;  // causal: long first
  const int diag = tk - tq;
  const int n_qt = (tq + kRows - 1) / kRows;
  // causal: the first query tile that reaches key k0 holds q_pos = k0 - diag
  const int i0 = causal ? max(0, k0 - diag) / kRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1 + 32);  // the TMA bytes, the producer lanes
      mbar_init(&sm.empty[s], 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // producer: k and v once; per query tile, q and do by TMA, and lse and
    // delta (rows of Tq f32 values: a tile may start off a 16-byte
    // boundary, which a TMA box may not) by the warp's own loads, each
    // lane arriving once its rows are in shared memory
    if (lane == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * kTileBytes);
      tma_tile<D>(sm.k, &k_map, &sm.kv_full, kRows, k0, bh);
      tma_tile<D>(sm.v, &v_map, &sm.kv_full, kRows, k0, bh);
    }
    for (int i = i0; i < n_qt; ++i) {
      const int it = i - i0, s = it % kStages;
      mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        tma_tile<D>(sm.q[s], &q_map, &sm.full[s], kRows, i * kRows, bh);
        tma_tile<D>(sm.dout[s], &do_map, &sm.full[s], kRows, i * kRows, bh);
      }
      for (int r = lane; r < kRows; r += 32) {
        const int qp = i * kRows + r;
        const size_t at = (size_t)bh * tq + qp;
        sm.lse[s][r] = qp < tq ? lse[at] : 0.f;
        sm.delta[s][r] = qp < tq ? delta[at] : 0.f;
      }
      mbar_arrive(&sm.full[s]);
    }
    return;
  }

  // consumer warpgroup: keys k0 .. k0 + 63, columns c0 .. c0 + kCols - 1
  // of dK and dV
  const int r0 = 16 * warp + lane / 4;  // key rows k0 + r0, k0 + r0 + 8
  const int cq = 2 * (lane % 4);        // query columns 8j + cq + {0, 1}
  const float scale_log2 = scale * kLog2e;
  float dk_acc[kCols / 2], dv_acc[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(&sm.kv_full, 0);
  for (int i = i0; i < n_qt; ++i) {
    const int it = i - i0, s = it % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    float st[32], dpt[32];  // S^T and dP^T: rows keys, columns queries
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T>(st, kmajor_step<D>(sm.k, kRows, kk),
                  kmajor_step<D>(sm.q[s], kRows, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T>(dpt, kmajor_step<D>(sm.v, kRows, kk),
                  kmajor_step<D>(sm.dout[s], kRows, kk), kk);
    wg_commit();
    wg_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    const int qs0 = i * kRows;
    const bool edge = qs0 + kRows > tq || k0 + kRows > tk ||
                      (causal && k0 + kRows - 1 > qs0 + diag);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = acc_col(e) + cq;
      float p = exp2_at<D>(st[e] * scale_log2 - sm.lse[s][col] * kLog2e);
      if (edge) {
        const int qp = qs0 + col, kp = k0 + r0 + acc_row(e);
        if (!(qp < tq && kp < tk && (!causal || kp <= qp + diag))) p = 0.f;
      }
      dpt[e] = p * (dpt[e] - sm.delta[s][col]) * scale;
      st[e] = p;
    }
    uint32_t pf[16], dsf[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      pf[t] = pack2<T>(st[2 * t], st[2 * t + 1]);
      dsf[t] = pack2<T>(dpt[2 * t], dpt[2 * t + 1]);
    }
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_rs_cols<T, kCols, D>(dv_acc, pf + 4 * kk, sm.dout[s], c0, kk);
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_rs_cols<T, kCols, D>(dk_acc, dsf + 4 * kk, sm.q[s], c0, kk);
    wg_commit();
    wg_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = k0 + r0 + 8 * h;
    if (kp >= tk) continue;
    const size_t row = ((size_t)bh * tk + kp) * D + c0 + cq;
#pragma unroll
    for (int jj = 0; jj < kCols / 8; ++jj) {
      store2<T>(dk + row + 8 * jj, dk_acc[4 * jj + 2 * h],
                dk_acc[4 * jj + 2 * h + 1]);
      store2<T>(dv + row + 8 * jj, dv_acc[4 * jj + 2 * h],
                dv_acc[4 * jj + 2 * h + 1]);
    }
  }
}

// ---- K2b ---------------------------------------------------------------

constexpr int kDqThreads = 128 + 32;  // 1 warpgroup + producer

template <typename T, int D>
struct DqSmem {
  T q[kRows * D];
  T dout[kRows * D];
  T k[kStages][kRows * D];
  T v[kStages][kRows * D];
  uint64_t qd_full, full[kStages], empty[kStages];
};

template <typename T, int D>
__global__ void __launch_bounds__(kDqThreads, Sm90Cfg<D>::kDqBlocksPerSm)
    dq_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int tq, int tk, float scale, int causal) {
  constexpr int kTileBytes = Sm90Cfg<D>::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  DqSmem<T, D>& sm = *align1024<DqSmem<T, D>>(smem_raw);
  const int n_qt = (tq + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * kRows;  // long first
  const int diag = tk - tq;
  const int n_kt = key_tiles(q0, kRows, tk, diag, causal);

  if (threadIdx.x == 0) {
    mbar_init(&sm.qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // producer: q and do once, then k and v tiles through the ring
    if (lane == 0) {
      mbar_expect_tx(&sm.qd_full, 2 * kTileBytes);
      tma_tile<D>(sm.q, &q_map, &sm.qd_full, kRows, q0, bh);
      tma_tile<D>(sm.dout, &do_map, &sm.qd_full, kRows, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        tma_tile<D>(sm.k[s], &k_map, &sm.full[s], kRows, j * kRows, bh);
        tma_tile<D>(sm.v[s], &v_map, &sm.full[s], kRows, j * kRows, bh);
      }
    }
    return;
  }

  // consumer warpgroup: query rows q0 + r0 and q0 + r0 + 8 of every tile,
  // so this thread's lse (in base 2) and delta are two registers each
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);  // key columns 8j + cq + {0, 1}
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + r0 + 8 * h;
    const size_t at = (size_t)bh * tq + qp;
    lse2[h] = qp < tq ? lse[at] * kLog2e : 0.f;
    dl[h] = qp < tq ? delta[at] : 0.f;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait(&sm.qd_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    float sc[32], dp[32];  // S = Q K^T and dP = dO V^T: rows queries
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T>(sc, kmajor_step<D>(sm.q, kRows, kk),
                  kmajor_step<D>(sm.k[s], kRows, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T>(dp, kmajor_step<D>(sm.dout, kRows, kk),
                  kmajor_step<D>(sm.v[s], kRows, kk), kk);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const int k0 = j * kRows;
    const bool edge =
        k0 + kRows > tk || (causal && k0 + kRows - 1 > q0 + diag);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2_at<D>(sc[i] * scale_log2 - lse2[h]);
      if (edge) {
        const int kp = k0 + acc_col(i) + cq, qp = q0 + r0 + acc_row(i);
        if (!(kp < tk && (!causal || kp <= qp + diag))) p = 0.f;
      }
      sc[i] = p * (dp[i] - dl[h]) * scale;  // ds
    }
    uint32_t dsf[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) dsf[t] = pack2<T>(sc[2 * t], sc[2 * t + 1]);

    fence_regs(dq_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_rs_cols<T, D, D>(dq_acc, dsf + 4 * kk, sm.k[s], 0, kk);
    wg_commit();
    wg_wait_all();
    fence_regs(dq_acc);
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + r0 + 8 * h;
    if (qp >= tq) continue;
    T* row = dq + ((size_t)bh * tq + qp) * D + cq;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      store2<T>(row + 8 * jj, dq_acc[4 * jj + 2 * h],
                dq_acc[4 * jj + 2 * h + 1]);
  }
}

// ---- host: tensor maps and launches -------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &got);
#endif
    if (err != cudaSuccess || got != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (bh, t, D) 16-bit tensor as a 3-d map with boxes of kSw columns and
// `rows` rows of one head, 128-byte swizzle (64-byte at D 32); rows past t
// read as zero.
template <typename T, int D>
bool map_rows(CUtensorMap* map, const void* ptr, int bh, int t, int rows) {
  constexpr int d = D;
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {kSw<D>, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map,
             kIsF16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             kSwBytes<D> == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Each launcher asks for its shared struct and 1024 bytes more, the most
// that aligning the struct to the 1024 bytes of a swizzle atom can take.
template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int tq, int tk, float scale, int causal,
               cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!map_rows<T, D>(&q_map, q, bh, tq, kFwdRows<D>) ||
      !map_rows<T, D>(&k_map, k, bh, tk, kRows) ||
      !map_rows<T, D>(&v_map, v, bh, tk, kRows))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(FwdSmem<T, D>) + 1024;
  cudaError_t err = set_smem(fwd_sm90_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = bh * ((tq + kFwdRows<D> - 1) / kFwdRows<D>);
  fwd_sm90_kernel<T, D><<<blocks, kFwdThreads<D>, smem, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(o), lse, tq, tk, scale * kLog2e,
      causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int tq,
              int tk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!map_rows<T, D>(&q_map, q, bh, tq, kRows) ||
      !map_rows<T, D>(&k_map, k, bh, tk, kRows) ||
      !map_rows<T, D>(&v_map, v, bh, tk, kRows) ||
      !map_rows<T, D>(&do_map, dout, bh, tq, kRows))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(DqSmem<T, D>) + 1024;
  cudaError_t err = set_smem(dq_sm90_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = bh * ((tq + kRows - 1) / kRows);
  dq_sm90_kernel<T, D><<<blocks, kDqThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<T*>(dq), tq, tk,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int bh, int tq, int tk, float scale, int causal,
               cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!map_rows<T, D>(&q_map, q, bh, tq, kRows) ||
      !map_rows<T, D>(&k_map, k, bh, tk, kRows) ||
      !map_rows<T, D>(&v_map, v, bh, tk, kRows) ||
      !map_rows<T, D>(&do_map, dout, bh, tq, kRows))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(DkvSmem<T, D>) + 1024;
  cudaError_t err = set_smem(dkv_sm90_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = bh * ((tk + kRows - 1) / kRows) * kDkvSplit<D>;
  dkv_sm90_kernel<T, D><<<blocks, kDkvThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

// Instantiates the launcher for dtype 1 (bfloat16) or 2 (float16) and head
// dim 32, 64, 128 or 256, or returns cudaErrorInvalidValue. Built with
// -DFLASH_SM90_DTYPE=1 or 2 the library holds that type's kernels alone, so
// the wrapper builds the two types' libraries with two nvcc runs at once.
#ifndef FLASH_SM90_DTYPE
#define FLASH_SM90_DTYPE 0  // both types
#endif
#define SM90_DIMS(T, head_dim, LAUNCH, ...)                          \
  do {                                                               \
    if ((head_dim) == 32) return LAUNCH<T, 32>(__VA_ARGS__);         \
    if ((head_dim) == 64) return LAUNCH<T, 64>(__VA_ARGS__);         \
    if ((head_dim) == 128) return LAUNCH<T, 128>(__VA_ARGS__);       \
    if ((head_dim) == 256) return LAUNCH<T, 256>(__VA_ARGS__);       \
  } while (0)
#if FLASH_SM90_DTYPE == 1
#define SM90_TYPES(dtype, head_dim, LAUNCH, ...) \
  if ((dtype) == 1) SM90_DIMS(bf16, head_dim, LAUNCH, __VA_ARGS__);
#elif FLASH_SM90_DTYPE == 2
#define SM90_TYPES(dtype, head_dim, LAUNCH, ...) \
  if ((dtype) == 2) SM90_DIMS(f16, head_dim, LAUNCH, __VA_ARGS__);
#else
#define SM90_TYPES(dtype, head_dim, LAUNCH, ...)                     \
  if ((dtype) == 1) SM90_DIMS(bf16, head_dim, LAUNCH, __VA_ARGS__);  \
  if ((dtype) == 2) SM90_DIMS(f16, head_dim, LAUNCH, __VA_ARGS__);
#endif
#define SM90_DISPATCH(dtype, head_dim, LAUNCH, ...)                  \
  do {                                                               \
    SM90_TYPES(dtype, head_dim, LAUNCH, __VA_ARGS__)                 \
    return (int)cudaErrorInvalidValue;                               \
  } while (0)

}  // namespace

// K2a. q (bh, tq, d), k and v (bh, tk, d), bf16 (dtype 1) or float16
// (dtype 2), d = 32, 64, 128 or 256 -> o (bh, tq, d), lse (bh, tq) f32.
extern "C" int flash_attention_fwd_sm90(int device, int dtype, int head_dim,
                                        const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int bh, int tq, int tk, float scale,
                                        int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  SM90_DISPATCH(dtype, head_dim, launch_fwd, q, k, v, o, lse, bh, tq, tk,
                scale, causal, static_cast<cudaStream_t>(stream));
}

// K2b. q, dout (bh, tq, d), k, v (bh, tk, d), 16-bit, lse and delta
// (bh, tq) f32 -> dq (bh, tq, d).
extern "C" int flash_attention_dq_sm90(int device, int dtype, int head_dim,
                                       const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dq, int bh, int tq, int tk,
                                       float scale, int causal,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  SM90_DISPATCH(dtype, head_dim, launch_dq, q, k, v, dout, lse, delta, dq,
                bh, tq, tk, scale, causal, static_cast<cudaStream_t>(stream));
}

// K2c. The same inputs as K2b -> dk, dv (bh, tk, d).
extern "C" int flash_attention_dkv_sm90(int device, int dtype, int head_dim,
                                        const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        void* dk, void* dv, int bh, int tq,
                                        int tk, float scale, int causal,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  SM90_DISPATCH(dtype, head_dim, launch_dkv, q, k, v, dout, lse, delta, dk,
                dv, bh, tq, tk, scale, causal,
                static_cast<cudaStream_t>(stream));
}
