// Flash attention for Hopper (sm_90a) at bf16, head dim 64: the forward
// (K2a), the dq backward (K2b) and the dk/dv backward (K2c) redesigned
// around wgmma, TMA and register-resident accumulators. They replace the
// bf16, D 64 path of flash_attention.cu's kernels (that file keeps the f32
// and D 32 kernels that the parity tests use). Ports of the Pallas TPU
// kernels in ccv_tpu/ops/pallas/flash_attention.py:
//   K2a  _flash_kernel  (via _flash_fwd_bthd)
//   K2b  _dq_kernel     (via _flash_bwd_bthd)
//   K2c  _dkv_kernel    (via _flash_bwd_bthd)
//
// What they compute, on (BH, T, 64) row-major bf16 tensors (lse and delta
// are (BH, Tq) f32), exactly what flash_attention.cu computes:
//   s = (q . k) * scale in f32; a key counts if k_pos < Tk and, when causal,
//   k_pos <= q_pos + (Tk - Tq) (bottom-right). Masked scores are -1e30.
//   K2a: online softmax over 64-key tiles; p is rounded to bf16 before
//        p @ v; o = acc / max(l, 1e-30); lse = m + log(l) (natural log: the
//        kernel keeps m in base 2 and converts before the store).
//   K2b: p = exp(s - lse) (0 where masked), dp = do . v,
//        ds = p * (dp - delta) * scale, rounded to bf16; dq = sum_k ds k.
//   K2c: the same p and ds; dv = sum_q p^T do, dk = sum_q ds^T q.
//   p and ds are rounded to bf16 before their products, which accumulate
//   in f32.
//
// Bound on this card. At the LM's shape (BH 128, T 1024, D 64, causal) K2a
// does 17.2 GFLOP on 67.6 MB, K2b 25.8 GFLOP on 84.9 MB and K2c 34.4 GFLOP
// on 101.7 MB: at the H100's 989 TFLOP/s bf16 and 3.35 TB/s the bounds are
// 0.020 ms (bytes), 0.026 ms and 0.035 ms (operations). The tile products
// are what the tensor cores must do fast, and on Hopper only wgmma reaches
// their full rate.
//
// Design (FlashAttention-3's layout, without its pingpong and intra-
// warpgroup overlap):
//   K2a: one block per (bh, 128-query tile): two consumer warpgroups of 64
//   query rows and one producer warp. The producer TMA-loads the q tile
//   once and streams 64-key k and v tiles through a 2-stage ring, signalled
//   by mbarriers (full: bytes landed; empty: all 8 consumer warps done).
//   S = Q K^T is a wgmma with both operands in shared memory (128-byte
//   swizzle: a bf16 row of 64 is exactly 128 B); S stays in registers, the
//   row max and row sum reduce over the 4 threads of a quad, only tiles on
//   the causal diagonal or the ragged tail run the mask, and P is rounded
//   to bf16 in registers, where the accumulator layout of S is already the
//   A-operand layout of O += P V (a register-A wgmma, V MN-major). O stays
//   in registers in f32 until the epilogue. TMA zero-fills rows past T.
//   K2c: one block per (bh, 64-key tile): one consumer warpgroup and a
//   producer warp. K and V are TMA-loaded once; the producer streams q and
//   do tiles (TMA) and their lse and delta rows (plain loads) from the
//   first query tile that reaches the key tile. S^T = K Q^T and
//   dP^T = V dO^T are shared-memory wgmmas, so P^T and dS^T come out in
//   accumulator layout (a row is a key, a column a query,
//   whose lse and delta are read from the staged rows); rounded to bf16
//   they are the A operands of dV += P^T dO and dK += dS^T Q (register-A
//   wgmmas, dO and Q MN-major). dK and dV stay in registers; no atomics, so
//   the gradients are deterministic.
//   K2b: K2a's loop with K2c's arithmetic. One block per (bh, 64-query
//   tile): one consumer warpgroup and a producer warp (three 32-register
//   accumulators, S, dP and dQ, and the dS fragments leave no room for a
//   second warpgroup at two blocks a SM). The producer TMA-loads q and do
//   once and streams 64-key k and v tiles through the 2-stage ring.
//   S = Q K^T and dP = dO V^T are shared-memory wgmmas (all four operands
//   K-major); each thread owns query rows r0 and r0 + 8 for the whole
//   block, so their lse and delta are loaded once into registers; dS is
//   packed to bf16 in registers, already the A-operand layout of
//   dQ += dS K (a register-A wgmma, K MN-major). dQ stays in registers
//   until the epilogue; no atomics. It asks for 3 blocks a SM (the register
//   cap that follows), which measured faster than 2 (PERF.md).
//   No loop has a block barrier: only mbarrier waits and wgmma
//   fence/commit/wait. The longest causal tiles are scheduled first.
//
// The tensor maps are encoded on the host in the launch function through
// cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint(ByVersion), so
// the library needs no -lcuda; they reach the kernel as __grid_constant__
// parameters. Each entry point launches on the given stream, does not
// synchronise, and returns a CUDA error code as an int (0 = launched).

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                    // head dim: one 128-byte row
constexpr int kRows = 64;                 // rows of a tile (one wgmma M)
constexpr int kTileBytes = kRows * kD * 2;  // 8 KB
// Ring depth, and blocks per SM asked of the compiler (it caps registers a
// thread to fit them); what was tried on the card is in PERF.md.
constexpr int kStages = 2;
constexpr int kFwdBlocksPerSm = 2;
constexpr int kDkvBlocksPerSm = 2;
constexpr int kDqBlocksPerSm = 3;
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
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptor of a tile of 128-byte rows written by TMA with 128-byte
// swizzle (atoms of 8 rows, 1024 B apart: the stride byte offset). For a
// K-major operand the leading byte offset is unused (a wgmma's 16-element K
// slice lies inside a row); for an MN-major one it is the stride between
// 64-element column blocks, of which a 64-wide operand has one.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
// Advance of a descriptor by 16 elements of K: 32 B along a K-major row,
// 16 rows (2048 B) down an MN-major tile. The start address field is in
// 16-byte units.
constexpr uint64_t kStepKMajor = 32 >> 4;
constexpr uint64_t kStepMNMajor = 2048 >> 4;

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

// d (64 x 64, f32) = (scale_d ? d : 0) + A (64 x 16) B (16 x 64), both from
// shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A (64 x 16, bf16 pairs in registers) B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

template <typename T>
__device__ __forceinline__ T* align1024(unsigned char* p) {
  return reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                              ~uintptr_t(1023));
}

// ---- K2a ---------------------------------------------------------------

constexpr int kFwdRows = 2 * kRows;            // query rows per block
constexpr int kFwdThreads = 2 * 128 + 32;      // 2 warpgroups + producer

struct FwdSmem {
  bf16 q[kFwdRows * kD];
  bf16 k[kStages][kRows * kD];
  bf16 v[kStages][kRows * kD];
  uint64_t q_full, full[kStages], empty[kStages];
};

__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSm)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    bf16* __restrict__ o, float* __restrict__ lse, int tq,
                    int tk, float scale_log2, int causal) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem& sm = *align1024<FwdSmem>(smem_raw);
  const int n_qt = (tq + kFwdRows - 1) / kFwdRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * kFwdRows;
  const int diag = tk - tq;
  const int n_kt = key_tiles(q0, kFwdRows, tk, diag, causal);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    // producer: the q tile once, then k and v tiles through the ring
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, kFwdRows * kD * 2);
      tma_load_3d(sm.q, &q_map, &sm.q_full, 0, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        tma_load_3d(sm.k[s], &k_map, &sm.full[s], 0, j * kRows, bh);
        tma_load_3d(sm.v[s], &v_map, &sm.full[s], 0, j * kRows, bh);
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
  float o_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint64_t q_desc = desc_sw128(sm.q + kRows * kD * wg);

  mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    if (j < n_kt_wg) {
      float sc[32];
      const uint64_t k_desc = desc_sw128(sm.k[s]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss(sc, q_desc + kk * kStepKMajor, k_desc + kk * kStepKMajor,
                 kk);
      wg_commit();
      wg_wait_all();
      fence_regs(sc);

      const int k0 = j * kRows;
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
      // online softmax in base 2: rows r0 (h = 0) and r0 + 8 (h = 1)
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
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        sc[i] = exp2f(sc[i] - m[h]);
        sum[h] += sc[i];
        o_acc[i] *= corr[h];
      }
      l[0] = l[0] * corr[0] + sum[0];  // this thread's share of the row
      l[1] = l[1] * corr[1] + sum[1];
      uint32_t pf[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) pf[t] = pack_bf16(sc[2 * t], sc[2 * t + 1]);

      const uint64_t v_desc = desc_sw128(sm.v[s]);
      fence_regs(o_acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs(o_acc, pf + 4 * kk, v_desc + kk * kStepMNMajor);
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
    bf16* orow = o + ((size_t)bh * tq + qp) * kD + cq;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) =
          __floats2bfloat162_rn(o_acc[4 * jj + 2 * h] * inv,
                                o_acc[4 * jj + 2 * h + 1] * inv);
    }
    if (cq == 0)
      lse[(size_t)bh * tq + qp] = m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f));
  }
}

// ---- K2c ---------------------------------------------------------------

constexpr int kDkvThreads = 128 + 32;  // 1 warpgroup + producer

struct DkvSmem {
  bf16 k[kRows * kD];
  bf16 v[kRows * kD];
  bf16 q[kStages][kRows * kD];
  bf16 dout[kStages][kRows * kD];
  float lse[kStages][kRows];
  float delta[kStages][kRows];
  uint64_t kv_full, full[kStages], empty[kStages];
};

__global__ void __launch_bounds__(kDkvThreads, kDkvBlocksPerSm)
    dkv_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int tq, int tk, float scale,
                    int causal) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& sm = *align1024<DkvSmem>(smem_raw);
  const int n_kt = (tk + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (int)(blockIdx.x % n_kt) * kRows;  // causal: long first
  const int diag = tk - tq;
  const int n_qt = (tq + kRows - 1) / kRows;
  // causal: the first query tile that reaches key k0 holds q_pos = k0 - diag
  const int i0 = causal ? max(0, k0 - diag) / kRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1 + 32);  // the TMA bytes, the producer lanes
      mbar_init(&sm.empty[s], 4);
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
      tma_load_3d(sm.k, &k_map, &sm.kv_full, 0, k0, bh);
      tma_load_3d(sm.v, &v_map, &sm.kv_full, 0, k0, bh);
    }
    for (int i = i0; i < n_qt; ++i) {
      const int it = i - i0, s = it % kStages;
      mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        tma_load_3d(sm.q[s], &q_map, &sm.full[s], 0, i * kRows, bh);
        tma_load_3d(sm.dout[s], &do_map, &sm.full[s], 0, i * kRows, bh);
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

  const int r0 = 16 * warp + lane / 4;  // key rows k0 + r0, k0 + r0 + 8
  const int cq = 2 * (lane % 4);        // query columns 8j + cq + {0, 1}
  const float scale_log2 = scale * kLog2e;
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint64_t k_desc = desc_sw128(sm.k), v_desc = desc_sw128(sm.v);

  mbar_wait(&sm.kv_full, 0);
  for (int i = i0; i < n_qt; ++i) {
    const int it = i - i0, s = it % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    const uint64_t q_desc = desc_sw128(sm.q[s]);
    const uint64_t do_desc = desc_sw128(sm.dout[s]);
    float st[32], dpt[32];  // S^T and dP^T: rows keys, columns queries
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(st, k_desc + kk * kStepKMajor, q_desc + kk * kStepKMajor, kk);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(dpt, v_desc + kk * kStepKMajor, do_desc + kk * kStepKMajor,
               kk);
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
      float p = exp2f(st[e] * scale_log2 - sm.lse[s][col] * kLog2e);
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
      pf[t] = pack_bf16(st[2 * t], st[2 * t + 1]);
      dsf[t] = pack_bf16(dpt[2 * t], dpt[2 * t + 1]);
    }
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_rs(dv_acc, pf + 4 * kk, do_desc + kk * kStepMNMajor);
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_rs(dk_acc, dsf + 4 * kk, q_desc + kk * kStepMNMajor);
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
    const size_t row = ((size_t)bh * tk + kp) * kD + cq;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * jj) =
          __floats2bfloat162_rn(dk_acc[4 * jj + 2 * h],
                                dk_acc[4 * jj + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * jj) =
          __floats2bfloat162_rn(dv_acc[4 * jj + 2 * h],
                                dv_acc[4 * jj + 2 * h + 1]);
    }
  }
}

// ---- K2b ---------------------------------------------------------------

constexpr int kDqThreads = 128 + 32;  // 1 warpgroup + producer

struct DqSmem {
  bf16 q[kRows * kD];
  bf16 dout[kRows * kD];
  bf16 k[kStages][kRows * kD];
  bf16 v[kStages][kRows * kD];
  uint64_t qd_full, full[kStages], empty[kStages];
};

__global__ void __launch_bounds__(kDqThreads, kDqBlocksPerSm)
    dq_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int tq, int tk, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = *align1024<DqSmem>(smem_raw);
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
      tma_load_3d(sm.q, &q_map, &sm.qd_full, 0, q0, bh);
      tma_load_3d(sm.dout, &do_map, &sm.qd_full, 0, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        tma_load_3d(sm.k[s], &k_map, &sm.full[s], 0, j * kRows, bh);
        tma_load_3d(sm.v[s], &v_map, &sm.full[s], 0, j * kRows, bh);
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
  float dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
  const uint64_t q_desc = desc_sw128(sm.q), do_desc = desc_sw128(sm.dout);

  mbar_wait(&sm.qd_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    const uint64_t k_desc = desc_sw128(sm.k[s]);
    const uint64_t v_desc = desc_sw128(sm.v[s]);
    float sc[32], dp[32];  // S = Q K^T and dP = dO V^T: rows queries
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(sc, q_desc + kk * kStepKMajor, k_desc + kk * kStepKMajor, kk);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(dp, do_desc + kk * kStepKMajor, v_desc + kk * kStepKMajor,
               kk);
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
      float p = exp2f(sc[i] * scale_log2 - lse2[h]);
      if (edge) {
        const int kp = k0 + acc_col(i) + cq, qp = q0 + r0 + acc_row(i);
        if (!(kp < tk && (!causal || kp <= qp + diag))) p = 0.f;
      }
      sc[i] = p * (dp[i] - dl[h]) * scale;  // ds
    }
    uint32_t dsf[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) dsf[t] = pack_bf16(sc[2 * t], sc[2 * t + 1]);

    fence_regs(dq_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_rs(dq_acc, dsf + 4 * kk, k_desc + kk * kStepMNMajor);
    wg_commit();
    wg_wait_all();
    fence_regs(dq_acc);
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + r0 + 8 * h;
    if (qp >= tq) continue;
    bf16* row = dq + ((size_t)bh * tq + qp) * kD + cq;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * jj) =
          __floats2bfloat162_rn(dq_acc[4 * jj + 2 * h],
                                dq_acc[4 * jj + 2 * h + 1]);
    }
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

// A (bh, t, 64) bf16 tensor as a 3-d map with boxes of `rows` rows of one
// head, 128-byte swizzle; rows past t read as zero.
bool map_rows(CUtensorMap* map, const void* ptr, int bh, int t, int rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {kD, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {kD * 2, (cuuint64_t)t * kD * 2};
  const cuuint32_t box[3] = {kD, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// K2a. q (bh, tq, 64), k and v (bh, tk, 64), bf16 -> o (bh, tq, 64),
// lse (bh, tq) f32.
extern "C" int flash_attention_fwd_sm90(int device, const void* q,
                                        const void* k, const void* v, void* o,
                                        float* lse, int bh, int tq, int tk,
                                        float scale, int causal,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap q_map, k_map, v_map;
  if (!map_rows(&q_map, q, bh, tq, kFwdRows) ||
      !map_rows(&k_map, k, bh, tk, kRows) || !map_rows(&v_map, v, bh, tk, kRows))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(FwdSmem) + 1024;
  err = set_smem(fwd_sm90_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = bh * ((tq + kFwdRows - 1) / kFwdRows);
  fwd_sm90_kernel<<<blocks, kFwdThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), lse, tq, tk,
      scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

// K2b. q, dout (bh, tq, 64), k, v (bh, tk, 64), bf16, lse and delta
// (bh, tq) f32 -> dq (bh, tq, 64).
extern "C" int flash_attention_dq_sm90(int device, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const float* lse,
                                       const float* delta, void* dq, int bh,
                                       int tq, int tk, float scale,
                                       int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!map_rows(&q_map, q, bh, tq, kRows) ||
      !map_rows(&k_map, k, bh, tk, kRows) ||
      !map_rows(&v_map, v, bh, tk, kRows) ||
      !map_rows(&do_map, dout, bh, tq, kRows))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(DqSmem) + 1024;
  err = set_smem(dq_sm90_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = bh * ((tq + kRows - 1) / kRows);
  dq_sm90_kernel<<<blocks, kDqThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<bf16*>(dq), tq,
      tk, scale, causal);
  return (int)cudaGetLastError();
}

// K2c. The same inputs as K2b -> dk, dv (bh, tk, 64).
extern "C" int flash_attention_dkv_sm90(int device, const void* q,
                                        const void* k, const void* v,
                                        const void* dout, const float* lse,
                                        const float* delta, void* dk, void* dv,
                                        int bh, int tq, int tk, float scale,
                                        int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!map_rows(&q_map, q, bh, tq, kRows) ||
      !map_rows(&k_map, k, bh, tk, kRows) ||
      !map_rows(&v_map, v, bh, tk, kRows) ||
      !map_rows(&do_map, dout, bh, tq, kRows))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(DkvSmem) + 1024;
  err = set_smem(dkv_sm90_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = bh * ((tk + kRows - 1) / kRows);
  dkv_sm90_kernel<<<blocks, kDkvThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), tq, tk, scale, causal);
  return (int)cudaGetLastError();
}
