// Flash attention forward for Hopper (sm_90a) in bf16, plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel) for bf16 inputs: online-softmax attention with scale
// D^-0.5, running (m, l, acc) in fp32, causal / sliding-window
// (qp - kp < window) / bidirectional masks, KV tiles that no row of a
// block sees skipped,
// GQA by kv_head = q_head / group, masked scores set to -1e30 and the
// normaliser floored at 1e-30.  fp32 inputs stay on the CUDA-core kernel of
// flash_attention.cu (TF32 cannot hold the fp32 limit).
//
// What bounds it on an H100: at the main path's S the two matrix products
// (2 * B * Hq * S^2 * D operations when causal), which only the tensor cores
// can run near the card's rate.  The design is the Hopper shape:
//
// * One block of 288 threads per (128 query rows, query head, batch): two
//   consumer warpgroups, each owning 64 of the 128 rows, and one producer
//   warp, of which one thread issues every copy.  There is no
//   `setmaxnreg`: with it (a producer warpgroup at 40 registers, consumers
//   at 232) ptxas still compiled the consumers' code within the launch
//   bound's 168 registers a thread and spilled, so the consumers' code is
//   written to fit 168, and one producer warp replaces the warpgroup.
// * TMA copies Q once and streams K and V tiles of 128 keys into rings of
//   two stages; each K and each V stage has a "full" mbarrier and an
//   "empty" one the consumer warps arrive on when they are done with it,
//   so K runs a tile ahead of V.  The tensor maps are built on the host for
//   each call from the
//   tensors' strides, so q/k/v are read in place (the model's [B, S, H, D]
//   projections included).  A row of a tile is one 128-byte swizzled
//   panel of 64 head-dim columns; D = 128 is two panels.  Columns past D
//   and rows past S come in as zeros (TMA's out-of-bounds fill), which pads
//   the contraction of Q K^T for D = 56 or 80 exactly.
// * Both products run on the tensor cores with `wgmma` (bf16 in, fp32
//   accumulate): S = Q K^T as m64n128k16 with both operands in shared
//   memory, then O += P V as m64nDk16 with P in registers (the score
//   accumulator's layout is the A operand's) and V read through the B
//   operand's transpose bit.
// * P is split into bf16 hi = bf16(P) and lo = bf16(P - hi), and O takes
//   both products: P in bf16 alone puts an rms error of about 2e-3 of the
//   output's rms into the result (the main path's limit is 2e-4), the
//   split about 7e-5.  l is summed from the fp32 P before the split.
// * The two consumer warpgroups take turns on the tensor cores (two named
//   barriers): in its turn a warpgroup runs P V of the previous tile and
//   Q K^T of this one, then hands over and does this tile's softmax while
//   the other's products run.  Scores, P and O are never all live at once
//   (192 registers would not fit in 168), and no branch separates a
//   product's issue from its wait or its operands' producer (ptxas then
//   serialises every wgmma).
// * The softmax runs in base 2: scores are scaled by D^-0.5 log2(e), so one
//   ex2 per score; a masked score is -1e30 in those units, which gives the
//   same p = 0 (or the same uniform p of a row with nothing live yet, which
//   a later live tile rescales to 0).
// * Blocks are ordered by their work: the grid's fastest axis is the query
//   head (the heads of one KV group are adjacent and share its K/V tiles
//   in L2), and the query tiles run from the last (with causal masks, the
//   most KV tiles) to the first.
//
// Layout: q [B, Hq, S, D] and k, v [B, Hkv, S, D] given by element strides
// (batch, head, sequence; the head-dim stride must be 1); every other
// stride of a dimension longer than 1 must be a multiple of 8 elements and
// each base address 16-byte aligned (TMA's rules).  Any S, D <= 128 with
// D % 8 == 0.  The output is written with its own strides.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;        // query rows per block (two warpgroups of 64)
constexpr int BK = 128;        // keys per KV tile
constexpr int STAGES = 2;      // K and V ring depth
constexpr int PANEL = 64;      // head-dim columns per 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr int NT = 288;        // two consumer warpgroups + one producer warp
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
// A wait on an mbarrier that has not completed after this long means the
// pipeline is broken: trap (a CUDA error) rather than hang the card.
constexpr unsigned long long WATCHDOG_NS = 10000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  for (uint32_t n = 1;; ++n) {
    if (mbar_try_wait(bar, parity)) return;
    if ((n & 0xfff) == 0 && global_ns() - t0 > WATCHDOG_NS) __trap();
  }
}

// One TMA copy of a [rows, 64] box of a 4-D tensor map (coordinates
// innermost first: column, row, head, batch) into shared memory; the
// barrier counts its bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B.  Tiles start on 1024-byte boundaries, so the base offset
// is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving register reads or writes of an operand of
// an asynchronous wgmma across its issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory
// (both K-major, 128-byte swizzle); ``accumulate`` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (bf16 pairs), B
// from shared memory, transposed (MN-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (bf16 pairs), B
// from shared memory, transposed (MN-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

static_assert(BQ == BK, "one TMA box shape serves Q, K and V");

template <int DP>
struct Smem {
  static constexpr int NP = DP / PANEL;                // panels of a row
  static constexpr int Q_BYTES = NP * BQ * ROW_BYTES;
  static constexpr int KV_BYTES = NP * BK * ROW_BYTES;  // one K or V tile
  static constexpr int BARS = 1 + 4 * STAGES;  // q; k, v full; k, v empty
  static constexpr int BYTES =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;  // 1024: alignment
};

// The block's mbarriers lie 8 bytes apart from `bars`: Q's, then for K
// (which 0) and V (which 1) a "full" one per stage, then an "empty" one per
// stage (one arrival per consumer warp).
constexpr int K_TILE = 0, V_TILE = 1;
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int which,
                                             int stage) {
  return bars + 8 * (1 + which * STAGES + stage);
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int which,
                                              int stage) {
  return bars + 8 * (1 + (2 + which) * STAGES + stage);
}

// Named hardware barriers 1 and 2 (0 is __syncthreads) hand the tensor
// cores back and forth between the two consumer warpgroups.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// S = Q K^T for one warpgroup's 64 rows and a 128-key tile: DP / 16
// steps of m64n128k16, both operands K-major in shared memory.
template <int DP>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_base,
                                         uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t off = (ks / 4) * BQ * ROW_BYTES + (ks % 4) * 32;
    const uint32_t koff = (ks / 4) * BK * ROW_BYTES + (ks % 4) * 32;
    wgmma_ss_n128(s, smem_desc(q_base + off, 16, 1024),
                  smem_desc(k_tile + koff, 16, 1024), ks > 0);
  }
  wgmma_commit();
}

// O += P V with P = hi + lo: 128 / 16 key steps, each two m64nDPk16 with
// A from registers and V's [keys, D] tile read through the transpose bit.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         uint32_t (&phi)[32],
                                         uint32_t (&plo)[32],
                                         uint32_t v_tile) {
  fence_regs(o);
  fence_regs(phi);
  fence_regs(plo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv =
        smem_desc(v_tile + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024);
    if constexpr (DP == 128) {
      wgmma_rs_n128(o, &phi[4 * kk], dv);
      wgmma_rs_n128(o, &plo[4 * kk], dv);
    } else {
      wgmma_rs_n64(o, &phi[4 * kk], dv);
      wgmma_rs_n64(o, &plo[4 * kk], dv);
    }
  }
  wgmma_commit();
}

// Online softmax of one tile's scores s (rows row0 and row0 + 8 of this
// thread, keys k0 + 8 j + col (+1)): scale to base-2 units, mask where the
// tile needs it, update (m, l), rescale O, and leave P = hi + lo in bf16,
// laid out as the A operand of the 16-key steps of P V.
template <int NO>
__device__ __forceinline__ void softmax_tile(
    float (&s)[64], float (&o)[NO], uint32_t (&phi)[32], uint32_t (&plo)[32],
    float& m0, float& m1, float& l0, float& l1, int k0, int qa, int row0,
    int col, int S, int causal, int window, float scale_log2) {
  const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > qa) ||
                      (window > 0 && qa + 63 - k0 >= window);
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (masked) {
        const int qp = row0 + (e >= 2 ? 8 : 0);
        const int kp = k0 + 8 * j + col + (e & 1);
        bool live = kp < S;
        if (causal) live = live && qp >= kp;
        if (window > 0) live = live && qp - kp < window;
        x = live ? x : NEG_INF;
      }
      s[4 * j + e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float alpha0 = ex2(m0 - mx0), alpha1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool r1 = (i & 1) != 0;      // pairs alternate rows 0 / 8
    const float p0 = ex2(s[2 * i] - (r1 ? mx1 : mx0));
    const float p1 = ex2(s[2 * i + 1] - (r1 ? mx1 : mx0));
    if (r1) sum1 += p0 + p1;
    else sum0 += p0 + p1;
    const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
    const float2 hf = __bfloat1622float2(hi);
    phi[i] = bf16x2_bits(hi);
    plo[i] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
  }
  l0 = l0 * alpha0 + sum0;   // per thread; the quad is summed at the end
  l1 = l1 * alpha1 + sum1;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? alpha1 : alpha0;
}

// Consumer warpgroup `cw` (0 or 1): rows q0 + 64 cw .. + 63 of the block.
//
// Each turn on the tensor cores issues P V of the previous tile and Q K^T
// of this one; the warpgroups take turns (ping-pong), so one's softmax
// runs while the other's products do.  Every tile of the block's range is
// computed (the masks zero what a warpgroup's rows do not see), so the
// loop has no branch around its products.
template <int DP>
__device__ __forceinline__ void consume(
    const uint8_t* sQ, const uint8_t* sK, const uint8_t* sV, uint32_t bars,
    int cw, int q0, int kt_begin, int ntiles, int S, int D, int causal,
    int window, float scale_log2, __nv_bfloat16* __restrict__ ob,
    long long oss) {
  using L = Smem<DP>;
  constexpr int NO = DP / 2;          // accumulator registers of O
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int qa = q0 + 64 * cw;        // first row of this warpgroup
  const int row0 = qa + 16 * warp + (lane >> 2);   // and row0 + 8
  const int col = 2 * (lane & 3);     // and col + 1, + 8 j
  const uint32_t q_base = smem_u32(sQ) + 64 * cw * ROW_BYTES;
  const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
  const int mine = 1 + cw, other = 2 - cw;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  uint32_t phi[32], plo[32];

  mbar_wait(bars, 0);                 // Q
  if (cw == 1) turn_pass(1);          // warpgroup 0 takes the first turn
  {
    float s[64];
    turn_wait(mine);
    mbar_wait(full_bar(bars, K_TILE, 0), 0);
    issue_qk<DP>(s, q_base, k_base);
    turn_pass(other);
    wgmma_wait_all();
    fence_regs(s);
    if (lane == 0) mbar_arrive(empty_bar(bars, K_TILE, 0));
    softmax_tile(s, o, phi, plo, m0, m1, l0, l1, kt_begin * BK, qa, row0,
                 col, S, causal, window, scale_log2);
  }
  for (int it = 1; it < ntiles; ++it) {
    const int ps = (it - 1) % STAGES, cs = it % STAGES;
    float s[64];
    turn_wait(mine);
    mbar_wait(full_bar(bars, V_TILE, ps), ((it - 1) / STAGES) & 1);
    issue_pv<DP>(o, phi, plo, v_base + ps * L::KV_BYTES);
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty_bar(bars, V_TILE, ps));
    mbar_wait(full_bar(bars, K_TILE, cs), (it / STAGES) & 1);
    issue_qk<DP>(s, q_base, k_base + cs * L::KV_BYTES);
    turn_pass(other);
    wgmma_wait_all();
    fence_regs(s);
    if (lane == 0) mbar_arrive(empty_bar(bars, K_TILE, cs));
    softmax_tile(s, o, phi, plo, m0, m1, l0, l1, (kt_begin + it) * BK, qa,
                 row0, col, S, causal, window, scale_log2);
  }
  {
    const int ps = (ntiles - 1) % STAGES;
    turn_wait(mine);
    mbar_wait(full_bar(bars, V_TILE, ps), ((ntiles - 1) / STAGES) & 1);
    issue_pv<DP>(o, phi, plo, v_base + ps * L::KV_BYTES);
    turn_pass(other);
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty_bar(bars, V_TILE, ps));
  }
  if (cw == 0) turn_wait(1);          // the other warpgroup's last pass

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = 8 * j + col;
    if (c >= D) continue;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * oss + c) =
          __floats2bfloat162_rn(o[4 * j] / l0, o[4 * j + 1] / l0);
    if (row0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * oss + c) =
          __floats2bfloat162_rn(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
  }
}

// The producer's copy of K (which 0) or V (which 1) tile `it` into its
// stage, once both warpgroups have released the stage (the first pass over
// the ring finds every stage free).
template <int DP>
__device__ __forceinline__ void load_kv(const CUtensorMap* map, uint8_t* ring,
                                        uint32_t bars, int it, int which,
                                        int kt_begin, int kvh, int b) {
  using L = Smem<DP>;
  const int stage = it % STAGES;
  const uint32_t full = full_bar(bars, which, stage);
  mbar_wait(empty_bar(bars, which, stage), ((it / STAGES) & 1) ^ 1);
  mbar_expect_tx(full, L::KV_BYTES);
  uint8_t* dst = ring + stage * L::KV_BYTES;
  for (int p = 0; p < L::NP; ++p)
    tma_load(smem_u32(dst + p * BK * ROW_BYTES), map, full, p * PANEL,
             (kt_begin + it) * BK, kvh, b);
}

template <int DP>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int group, int S, int D,
               long long osb, long long osh, long long oss, int causal,
               int window, float scale_log2) {
  using L = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + L::Q_BYTES;
  uint8_t* sV = sK + STAGES * L::KV_BYTES;
  const uint32_t bars = smem_u32(sV + STAGES * L::KV_BYTES);

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // most work first
  const int kvh = h / group;
  // Live KV tiles, as the TPU kernel's pl.when(live) culls them.
  const int nk = (S + BK - 1) / BK;
  const int kt_end = causal ? (min(q0 + BQ, S) - 1) / BK + 1 : nk;
  const int lo = q0 - window + 1;      // oldest key any row of the block sees
  const int kt_begin = (window > 0 && lo > 0) ? lo / BK : 0;
  const int ntiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s)
      for (int which = K_TILE; which <= V_TILE; ++which) {
        mbar_init(full_bar(bars, which, s), 1);
        mbar_init(empty_bar(bars, which, s), 8);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, read through a shuffle so that the compiler
  // knows it is uniform across each warp: the roles' branches, and the
  // wgmma code under them, are then not divergent paths.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // Producer warp: one thread issues every copy.
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(bars, L::Q_BYTES);
      for (int p = 0; p < L::NP; ++p)
        tma_load(smem_u32(sQ + p * BQ * ROW_BYTES), &tq, bars, p * PANEL, q0,
                 h, b);
      // K runs one tile ahead of V: Q K^T of a tile comes a turn before
      // its P V.  A stage is reused once both warpgroups have released it
      // (the first pass over the ring finds every stage free).
      load_kv<DP>(&tk, sK, bars, 0, K_TILE, kt_begin, kvh, b);
      for (int it = 0; it < ntiles; ++it) {
        if (it + 1 < ntiles)
          load_kv<DP>(&tk, sK, bars, it + 1, K_TILE, kt_begin, kvh, b);
        load_kv<DP>(&tv, sV, bars, it, V_TILE, kt_begin, kvh, b);
      }
    }
  } else {
    consume<DP>(sQ, sK, sV, bars, wg, q0, kt_begin, ntiles, S, D, causal,
                window, scale_log2, o + b * osb + h * osh, oss);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; it is fetched through the
// runtime, so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a [B, H, S, D] bf16 tensor with element strides
// st[0..2] (batch, head, sequence): boxes of 64 columns x 128 rows,
// 128-byte swizzle, zeros outside the tensor.  A dimension of length 1
// gets a stride TMA accepts (its coordinate is always 0).
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int H, int S,
                  int D, const long long* st) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t row = static_cast<cuuint64_t>(st[2]) * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  cuuint64_t strides[3] = {row, static_cast<cuuint64_t>(st[1]) * 2,
                           static_cast<cuuint64_t>(st[0]) * 2};
  if (S == 1) strides[0] = 16;
  if (H == 1) strides[1] = 16;
  if (B == 1) strides[2] = 16;
  const cuuint32_t box[4] = {PANEL, BQ, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, void* o, int B, int Hq, int Hkv, int S,
           int D, const long long* st, int causal, int window, float scale,
           cudaStream_t stream) {
  const int smem = Smem<DP>::BYTES;
  // Above 48 KB a kernel must opt in to dynamic shared memory; the opt-in
  // is per device, so it is made on every call (microseconds).
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, (S + BQ - 1) / BQ, B);
  flash_fwd_bf16<DP><<<grid, NT, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq / Hkv, S, D, st[9],
      st[10], st[11], causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, head, sequence) for q, k, v, o.
// window <= 0 means no window.  Returns 0 on success, a CUDA runtime error
// code after a failed launch, or -(CUresult) when a tensor map cannot be
// built.
int odin_flash_attention_bf16_fwd(const void* q, const void* k,
                                  const void* v, void* o, int B, int Hq,
                                  int Hkv, int S, int D,
                                  const long long* strides, int causal,
                                  int window, float scale, void* stream) {
  if (D <= 0 || D > MAX_D || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(&tq, q, B, Hq, S, D, strides);
  if (r == CUDA_SUCCESS) r = make_map(&tk, k, B, Hkv, S, D, strides + 3);
  if (r == CUDA_SUCCESS) r = make_map(&tv, v, B, Hkv, S, D, strides + 6);
  if (r != CUDA_SUCCESS) return -(int)r;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<64>(tq, tk, tv, o, B, Hq, Hkv, S, D, strides, causal,
                      window, scale, s);
  return launch<128>(tq, tk, tv, o, B, Hq, Hkv, S, D, strides, causal,
                     window, scale, s);
}

// Dynamic shared memory a launch at head dim D asks for (bytes).
int odin_flash_attention_bf16_smem_bytes(int D) {
  return D <= 64 ? Smem<64>::BYTES : Smem<128>::BYTES;
}

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
