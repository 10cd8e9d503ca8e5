// Flash attention backward for Hopper (sm_90a) in bf16, plain C interface.
//
// The gradient of the port's bf16 K1 forward (flash_attention_bf16.cu,
// which replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention).  The JAX package
// has no Pallas backward: it differentiates its jnp flash_attention_jnp,
// which computes in fp32 and rounds the output to bf16, so the gradient of
// bf16 q, k and v is the fp32 gradient rounded to bf16 once.  This kernel
// computes that from q, k, v, the incoming gradient dO, and what the
// forward's LSE entry point (odin_flash_attention_bf16_fwd_lse) saved: the
// row log-sum-exp lse and the fp32 output O.  It never writes an S x S
// matrix to device memory:
//
//   delta = rowsum(dO o O)                          (launch 1)
//   P     = exp(scale Q K^T - lse),  dS = P o (dO V^T - delta)
//   dV    = P^T dO,  dK = scale dS^T Q              (launch 2)
//   dQ    = scale dS K                              (launch 2)
//
// What bounds it on an H100: operations.  It needs five products over the
// kept (query, key) pairs (2 * 5 * B * Hq * pairs * D operations), which
// only the tensor cores run near the card's rate (989 TFLOP/s dense bf16).
// Q, K, V and dO are exact in bf16, so S and dP are exact products summed
// in fp32.  P and dS are fp32 on chip: each is split into bf16 hi = bf16(x)
// and lo = bf16(x - hi) and dV, dK and dQ take both products, lo first.  A
// CPU model of this rounding (tests/test_torch_kernels.py) reads 0.7-1.4e-4
// of each gradient's rms against jax.grad of the JAX model's attention; P
// or dS in bf16 alone, or in fp16 with power-of-two scales, reads 8.7e-4
// to 2.7e-3, and delta from the bf16 O 1.1-1.5e-3, each over
// BACKWARD_BF16_RMS_LIMIT (7e-4).  So where five products over the kept
// pairs are needed, it executes six for each (64-key, 64-query) tile pair
// of a dK/dV warpgroup and four for each (64-query, 64-key) pair of a dQ
// warpgroup, over whole tiles at the padded width.  The design is the
// forward's Hopper shape, applied to both kinds of block:
//
// * Launch 2 holds two kinds of block, each with two consumer warpgroups
//   owning 64 rows apiece of the block's fixed tiles X (128 rows).  dK/dV
//   blocks fix K and V of 128 keys and stream Q and dO tiles of 64 queries
//   past them (with the queries' lse, in base-2 units, and delta); dQ
//   blocks fix Q and dO of 128 queries and stream K and V tiles of 64 keys
//   (S and dP recomputed rather than dQ summed across blocks).
// * TMA copies X once and the streamed tiles Y into a ring of STAGES
//   stages, each with a "full" mbarrier (the producer's 32 lanes arrive
//   after writing the tile's lse and delta, lane 0 with the copies' bytes)
//   and an "empty" one (one arrival per consumer warp when the stage's last
//   product is done).  No block-wide barrier runs per Y tile.  At D <= 64 a
//   ninth warp produces, as in the forward; at D 128 warp 0 does, sending
//   tile it + STAGES - 1 at the top of iteration it.  Nine warps put three
//   on one of the SM's four sub-partitions, which caps a thread at 168
//   registers (16384 / 96): enough at D 64, but a dK/dV warpgroup at D 128
//   spilled 564 bytes, and `setmaxnreg` with a producer warpgroup of 384
//   threads did not raise ptxas' cap; eight warps leave 255.
//   The tensor maps are built on the host from the strides, so the model's
//   [B, S, H, D] views are read in place; boxes are [64 rows, 64 columns]
//   with the 128-byte swizzle, X's two halves two boxes (a half wholly past
//   S is not copied: its warpgroup has no tiles).  Rows past S and columns
//   past D come in as zeros (TMA's fill).
// * Every product is a `wgmma` (hopper_bf16.cuh, shared with the forward):
//   S^T = K Q^T and dP^T = V dO^T (dQ blocks: S = Q K^T, dP = dO V^T) as
//   m64n64k16 with both operands in shared memory, issued together; then
//   dV += P^T dO and dK += dS^T Q (dQ blocks: dQ += dS K) as m64nDk16 with
//   the hi and lo halves of P^T and dS^T as register A operands (an
//   m64n64 accumulator is the A operand of four k16 steps, as the forward's
//   scores are) and dO, Q or K read through the B operand's transpose bit.
//   dV's products run before dS^T is split.  A dK/dV warpgroup's peak: dK
//   and dV (DP registers), S^T and dP^T (64) and their halves: 254
//   registers at D 128, 168 at D 64, no spill.  No branch separates a
//   product's issue from its wait.
// * Each warpgroup skips the streamed tiles its own rows do not see (it
//   still waits for them and releases them), so the diagonal's wholly
//   masked halves cost no products.
// * GQA: each dK/dV block writes its query head's share of dK and dV to
//   an fp32 scratch [group, B, Hkv, S, D], and launch 3 adds the group's
//   shares in head order and rounds once, with no atomics in any sum, so
//   two calls give the same bits.  (The last of a key block's group to
//   finish summing them, found by an arrival counter, and one dK/dV block
//   per kv head taking the whole group in registers were each slower at
//   the three timed shapes; PERF.md has their times.)
// * Blocks are ordered by their work: the grid's fastest axis is the block
//   kind and head (the dK/dV blocks first), then the batch, and the
//   slowest the tile, the heaviest first under a causal mask (key block 0,
//   the last query block), so the light blocks fill the card behind the
//   heavy ones.
//
// Layout: q, k, v, dO, dq, dk, dv [B, H, S, D] given by element strides
// (batch, head, sequence; the head-dim stride must be 1), so the model's
// [B, S, H, D] views are read and written in place; every other stride of
// q, k, v and dO (of a dimension longer than 1) must be a multiple of 8
// elements and each base 16-byte aligned (TMA's rules).  lse and the delta
// scratch are fp32 [B, Hq, S] contiguous, O fp32 [B, Hq, S, D] contiguous.
// Any S (the ragged last tile is masked), D <= 128 with D % 8 == 0.

#include "hopper_bf16.cuh"

namespace {

constexpr int BX = 128;         // rows of the fixed tiles (two warpgroups)
constexpr int BY = 64;          // rows of a streamed tile
constexpr int STAGES = 2;       // depth of the Y ring (3 measured no faster)
// Threads of launch 2 (see the header).
template <int DP>
struct Threads {
  static constexpr bool PRODUCER_WARP = DP <= 64;
  static constexpr int N = 256 + (PRODUCER_WARP ? 32 : 0);
};
constexpr int DELTA_ROWS = 32;  // rows per block of launch 1
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct View {
  long long b, h, s;            // element strides; the head dim's is 1
};

struct Views {
  View q, k, v, dout, dq, dk, dv;
};

// Launch 2's arguments besides the tensor maps.
struct Args {
  const float* lse;             // [B, Hq, S]
  const float* delta;           // [B, Hq, S]
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* pdk;                   // shares [group, B, Hkv, S, D] (GQA)
  float* pdv;
  Views st;
  int Hq, group, S, D, causal, window;
  float scale;
};

template <int DP>
struct Smem {
  static constexpr int NP = DP / PANEL;                // panels of a row
  static constexpr int X = NP * BX * ROW_BYTES;        // one fixed tile
  static constexpr int Y = NP * BY * ROW_BYTES;        // one streamed tile
  static constexpr int STATS = 2 * BY * 4;             // lse, delta of Y
  static constexpr int BARS = 1 + 2 * STAGES;          // X; full, empty
  static constexpr int BAR_AT = 2 * X + STAGES * (2 * Y + STATS);
  static constexpr int BYTES = 1024 + BAR_AT + 8 * BARS;
};

// The block's mbarriers lie 8 bytes apart from `bars`: X's, then a "full"
// one per stage, then an "empty" one per stage.
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int stage) {
  return bars + 8 * (1 + stage);
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int stage) {
  return bars + 8 * (1 + STAGES + stage);
}

// What a block of launch 2 does.  dK/dV blocks: the keys [x0, x0 + 128) of
// kv head kvh, the query tiles y_begin .. y_begin + ny - 1 of query head h
// streamed past them.  dQ blocks: the queries [x0, x0 + 128) of head h,
// the key tiles y_begin .. + ny - 1.
struct Work {
  bool dkv;
  int h, kvh, x0, y_begin, ny;
};

__device__ __forceinline__ Work block_work(const Args& a) {
  Work w;
  const int S = a.S, ntiles = (S + BY - 1) / BY;
  w.dkv = (int)blockIdx.x < a.Hq;
  if (w.dkv) {
    w.h = blockIdx.x;
    w.x0 = blockIdx.z * BX;     // key block 0 sees the most query tiles
    const int x_last = min(w.x0 + BX, S) - 1;
    w.y_begin = a.causal ? w.x0 / BY : 0;
    const int end = a.window > 0
                        ? min(ntiles, (x_last + a.window - 1) / BY + 1)
                        : ntiles;
    w.ny = end - w.y_begin;
  } else {
    w.h = blockIdx.x - a.Hq;
    const int qb = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
    w.x0 = qb * BX;             // the last query block sees the most keys
    const int x_last = min(w.x0 + BX, S) - 1;
    w.y_begin = a.window > 0 ? max(w.x0 - a.window + 1, 0) / BY : 0;
    const int end = a.causal ? x_last / BY + 1 : ntiles;
    w.ny = end - w.y_begin;
  }
  w.kvh = w.h / a.group;
  return w;
}

// The streamed tiles [begin, end) that the 64 rows from r0 of a warpgroup
// see (empty when r0 is past S).
__device__ __forceinline__ void own_range(const Args& a, bool dkv, int r0,
                                          int& begin, int& end) {
  const int S = a.S, ntiles = (S + BY - 1) / BY;
  begin = end = 0;
  if (r0 >= S) return;
  const int r_last = min(r0 + 64, S) - 1;
  if (dkv) {                    // the query tiles that see these keys
    begin = a.causal ? r0 / BY : 0;
    end = a.window > 0 ? min(ntiles, (r_last + a.window - 1) / BY + 1)
                       : ntiles;
  } else {                      // the key tiles these queries see
    begin = a.window > 0 ? max(r0 - a.window + 1, 0) / BY : 0;
    end = a.causal ? r_last / BY + 1 : ntiles;
  }
}

// The tensor maps of q, k, v and dO.
struct Maps {
  const CUtensorMap *q, *k, *v, *dout;
};

// Thread 0: the fixed tiles X (K and V, or Q and dO), once.
template <int DP>
__device__ __forceinline__ void load_x(const Maps& m, const Args& a,
                                       const Work& w, uint8_t* smem,
                                       uint32_t bars, int b) {
  using L = Smem<DP>;
  const uint32_t sX = smem_u32(smem);
  const CUtensorMap* x1 = w.dkv ? m.k : m.q;
  const CUtensorMap* x2 = w.dkv ? m.v : m.dout;
  const int xh = w.dkv ? w.kvh : w.h;
  const int halves = w.x0 + BY < a.S ? 2 : 1;
  mbar_expect_tx(bars, 2 * halves * L::NP * BY * ROW_BYTES);
  for (int p = 0; p < L::NP; ++p)
    for (int hh = 0; hh < halves; ++hh) {
      const uint32_t off = p * BX * ROW_BYTES + hh * BY * ROW_BYTES;
      tma_load(sX + off, x1, bars, p * PANEL, w.x0 + hh * BY, xh, b);
      tma_load(sX + L::X + off, x2, bars, p * PANEL, w.x0 + hh * BY, xh, b);
    }
}

// The producer (the producer warp, or warp 0): streamed tile `it` into its
// stage once both warpgroups have released the stage (the first pass over
// the ring finds every stage free); for dK/dV blocks its lanes also write
// the tile's lse (base 2) and delta into the stage before they arrive on
// its "full" barrier, lane 0 with the copies' bytes.
template <int DP>
__device__ __forceinline__ void produce(const Maps& m, const Args& a,
                                        const Work& w, uint8_t* smem,
                                        uint32_t bars, int b, int it) {
  using L = Smem<DP>;
  const int lane = threadIdx.x & 31;
  const int stage = it % STAGES;
  const int y0 = (w.y_begin + it) * BY;
  mbar_wait(empty_bar(bars, stage), ((it / STAGES) & 1) ^ 1);
  if (w.dkv) {
    const long long row = ((long long)b * a.Hq + w.h) * a.S + y0;
    float* st = reinterpret_cast<float*>(smem + 2 * L::X +
                                         2 * STAGES * L::Y) +
                stage * 2 * BY;
    for (int r = lane; r < BY; r += 32) {
      const bool in = y0 + r < a.S;
      st[r] = in ? a.lse[row + r] * LOG2E : 0.f;
      st[BY + r] = in ? a.delta[row + r] : 0.f;
    }
  }
  const uint32_t full = full_bar(bars, stage);
  if (lane == 0) {
    const CUtensorMap* y1 = w.dkv ? m.q : m.k;
    const CUtensorMap* y2 = w.dkv ? m.dout : m.v;
    const int yh = w.dkv ? w.h : w.kvh;
    const uint32_t dst = smem_u32(smem) + 2 * L::X + stage * 2 * L::Y;
    mbar_expect_tx(full, 2 * L::Y);
    for (int p = 0; p < L::NP; ++p) {
      tma_load(dst + p * BY * ROW_BYTES, y1, full, p * PANEL, y0, yh, b);
      tma_load(dst + L::Y + p * BY * ROW_BYTES, y2, full, p * PANEL, y0, yh,
               b);
    }
  } else {
    mbar_arrive(full);
  }
}

// Where there is no producer warp, warp 0 sends tile it + STAGES - 1 at the
// top of iteration `it` (the first STAGES before the loop): it waits for
// both warpgroups to release tile it - 1, so the copy is in flight while
// tile it is computed.  (Sending only tiles whose stage was already free,
// and not waiting, left tiles unsent until the next iteration and took 5%
// longer at D 128.)
template <int DP>
__device__ __forceinline__ void produce_ahead(const Maps& m, const Args& a,
                                              const Work& w, uint8_t* smem,
                                              uint32_t bars, int b, int it,
                                              int n) {
  if (!Threads<DP>::PRODUCER_WARP && threadIdx.x < 32 && it > 0 &&
      it + STAGES - 1 < n)
    produce<DP>(m, a, w, smem, bars, b, it + STAGES - 1);
}

// At D 128, `x` as a value the compiler cannot see through: the wgmma
// descriptors are then built at each issue (a few integer operations)
// rather than hoisted out of the tile loop, where they spilled 36 bytes at
// 255 registers.  At D 64 (168 registers, no spill) hoisting them is 5%
// faster.
template <int DP>
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  if constexpr (DP == 128) asm volatile("" : "+r"(x));
  return x;
}

// s = X1 Y1^T and dp = X2 Y2^T for a warpgroup's 64 rows and a 64-row Y
// tile: DP / 16 steps of m64n64k16 each, every operand K-major in shared
// memory; one commit group.
template <int DP>
__device__ __forceinline__ void issue_scores(float (&s)[32], float (&dp)[32],
                                             uint32_t x1, uint32_t x2,
                                             uint32_t y1, uint32_t y2) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t xo = (ks / 4) * BX * ROW_BYTES + (ks % 4) * 32;
    const uint32_t yo = (ks / 4) * BY * ROW_BYTES + (ks % 4) * 32;
    wgmma_ss_n64(s, smem_desc(x1 + xo, 16, 1024),
                 smem_desc(y1 + yo, 16, 1024), ks > 0);
  }
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t xo = (ks / 4) * BX * ROW_BYTES + (ks % 4) * 32;
    const uint32_t yo = (ks / 4) * BY * ROW_BYTES + (ks % 4) * 32;
    wgmma_ss_n64(dp, smem_desc(x2 + xo, 16, 1024),
                 smem_desc(y2 + yo, 16, 1024), ks > 0);
  }
  wgmma_commit();
}

// acc += (hi + lo) Y, lo first at each of the 64 / 16 k steps: A from
// registers, Y's [64, DP] tile read through the transpose bit; one commit
// group.
template <int DP>
__device__ __forceinline__ void issue_update(float (&acc)[DP / 2],
                                             uint32_t (&hi)[16],
                                             uint32_t (&lo)[16], uint32_t y) {
  fence_regs(acc);
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BY / 16; ++kk) {
    const uint64_t desc =
        smem_desc(y + kk * 16 * ROW_BYTES, BY * ROW_BYTES, 1024);
    if constexpr (DP == 128) {
      wgmma_rs_n128(acc, &lo[4 * kk], desc);
      wgmma_rs_n128(acc, &hi[4 * kk], desc);
    } else {
      wgmma_rs_n64(acc, &lo[4 * kk], desc);
      wgmma_rs_n64(acc, &hi[4 * kk], desc);
    }
  }
  wgmma_commit();
}

// bf16 hi = bf16(x) and lo = bf16(x - hi) of an m64n64 accumulator, as the
// A operand of four k16 steps (pair i is elements 2i and 2i + 1).
__device__ __forceinline__ void split(const float (&x)[32], uint32_t (&hi)[16],
                                      uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = bf16x2_bits(h);
    lo[i] = bf16x2_bits(
        __floats2bfloat162_rn(x[2 * i] - hf.x, x[2 * i + 1] - hf.y));
  }
}

// P = exp2(s scale_log2 - lse2) where the mask keeps (row, col), else 0, in
// s; dS = P o (dp - delta) in dp.  Element 4 j + e of the m64n64
// accumulators is row r + 8 (e >> 1), column c + 8 j + (e & 1); the key and
// query of an element are the row and the column (dK/dV, ``rows_are_keys``)
// or the column and the row (dQ).  lse2 and delta come from ``stat_of(j,
// e)``.
template <bool ROWS_ARE_KEYS, typename Stat>
__device__ __forceinline__ void probabilities(float (&s)[32], float (&dp)[32],
                                              int r, int c, bool whole,
                                              const Args& a,
                                              float scale_log2,
                                              Stat stat_of) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float l2, dl;
      stat_of(j, e, l2, dl);
      float x = s[i] * scale_log2 - l2;
      if (!whole) {
        const int row = r + 8 * (e >> 1), col = c + 8 * j + (e & 1);
        const int kp = ROWS_ARE_KEYS ? row : col;
        const int qp = ROWS_ARE_KEYS ? col : row;
        bool live = kp < a.S && qp < a.S;
        if (a.causal) live = live && qp >= kp;
        if (a.window > 0) live = live && qp - kp < a.window;
        x = live ? x : NEG_INF;
      }
      const float p = ex2(x);
      s[i] = p;
      dp[i] = p * (dp[i] - dl);
    }
  }
}

// Whether every (query, key) of the query rows [q0, q0 + 64) and keys
// [k0, k0 + 64) is kept by the mask.
__device__ __forceinline__ bool whole_tile(const Args& a, int q0, int k0) {
  return q0 + 63 < a.S && k0 + 63 < a.S && (!a.causal || q0 >= k0 + 63) &&
         (a.window <= 0 || q0 + 63 - k0 < a.window);
}

// A dK/dV warpgroup (cw 0 or 1): keys x0 + 64 cw .. + 63.  Returns dK
// (before its scale) and dV in the m64nDP accumulator layout.
template <int DP>
__device__ __forceinline__ void consume_dkv(const Maps& m, const Args& a,
                                            const Work& w, uint8_t* smem,
                                            uint32_t bars, int cw, int b,
                                            float (&dk)[DP / 2],
                                            float (&dv)[DP / 2]) {
  using L = Smem<DP>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
  const int ka = w.x0 + 64 * cw;
  const int row = ka + 16 * warp + (lane >> 2);   // and row + 8
  const int col = 2 * (lane & 3);                  // and col + 1, + 8 j
  int begin, end;
  own_range(a, true, ka, begin, end);
  const uint32_t x1 = smem_u32(smem) + cw * BY * ROW_BYTES, x2 = x1 + L::X;
  const uint32_t sY = smem_u32(smem) + 2 * L::X;
  const float* stats =
      reinterpret_cast<const float*>(smem + 2 * L::X + 2 * STAGES * L::Y);
  const float scale_log2 = a.scale * LOG2E;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bars, 0);                              // K and V
  for (int it = 0; it < w.ny; ++it) {
    produce_ahead<DP>(m, a, w, smem, bars, b, it, w.ny);
    const int stage = it % STAGES;
    const int yt = w.y_begin + it, y0 = yt * BY;
    mbar_wait(full_bar(bars, stage), (it / STAGES) & 1);
    if (yt < begin || yt >= end) {                 // no key here sees it
      if (lane == 0) mbar_arrive(empty_bar(bars, stage));
      continue;
    }
    const uint32_t y1 = sY + stage * 2 * L::Y, y2 = y1 + L::Y;   // Q, dO
    float s[32], dp[32];
    // S^T = K Q^T, dP^T = V dO^T
    issue_scores<DP>(s, dp, opaque<DP>(x1), opaque<DP>(x2),
                     opaque<DP>(y1), opaque<DP>(y2));
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    const float* l2 = stats + stage * 2 * BY;
    probabilities<true>(
        s, dp, row, y0 + col, whole_tile(a, y0, ka), a, scale_log2,
        [&](int j, int e, float& lv, float& dl) {
          lv = l2[8 * j + col + (e & 1)];
          dl = l2[BY + 8 * j + col + (e & 1)];
        });
    // dV's products are done before dS^T is split, so P^T's halves and
    // dS^T's are not live together (32 registers at the peak).
    uint32_t hi[16], lo[16];
    split(s, hi, lo);
    issue_update<DP>(dv, hi, lo, y2);              // dV += P^T dO
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(hi);                                // live until the wait
    fence_regs(lo);
    split(dp, hi, lo);
    issue_update<DP>(dk, hi, lo, y1);              // dK += dS^T Q
    wgmma_wait_all();
    fence_regs(dk);
    fence_regs(hi);
    fence_regs(lo);
    if (lane == 0) mbar_arrive(empty_bar(bars, stage));
  }
}

// A dQ warpgroup (cw 0 or 1): queries x0 + 64 cw .. + 63 of head h.
// Returns dQ (before its scale) in the m64nDP accumulator layout.
template <int DP>
__device__ __forceinline__ void consume_dq(const Maps& m, const Args& a,
                                           const Work& w, uint8_t* smem,
                                           uint32_t bars, int cw, int b,
                                           float (&dq)[DP / 2]) {
  using L = Smem<DP>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
  const int qa = w.x0 + 64 * cw;
  const int row = qa + 16 * warp + (lane >> 2);   // and row + 8
  const int col = 2 * (lane & 3);
  int begin, end;
  own_range(a, false, qa, begin, end);
  const uint32_t x1 = smem_u32(smem) + cw * BY * ROW_BYTES, x2 = x1 + L::X;
  const uint32_t sY = smem_u32(smem) + 2 * L::X;
  const float scale_log2 = a.scale * LOG2E;
  // The two rows' lse (base 2) and delta.
  const long long rows = ((long long)b * a.Hq + w.h) * a.S;
  float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row + 8 * i < a.S) {
      rl[i] = a.lse[rows + row + 8 * i] * LOG2E;
      rd[i] = a.delta[rows + row + 8 * i];
    }
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  mbar_wait(bars, 0);                              // Q and dO
  for (int it = 0; it < w.ny; ++it) {
    produce_ahead<DP>(m, a, w, smem, bars, b, it, w.ny);
    const int stage = it % STAGES;
    const int yt = w.y_begin + it, y0 = yt * BY;
    mbar_wait(full_bar(bars, stage), (it / STAGES) & 1);
    if (yt < begin || yt >= end) {                 // these queries see none
      if (lane == 0) mbar_arrive(empty_bar(bars, stage));
      continue;
    }
    const uint32_t y1 = sY + stage * 2 * L::Y, y2 = y1 + L::Y;   // K, V
    float s[32], dp[32];
    // S = Q K^T, dP = dO V^T
    issue_scores<DP>(s, dp, opaque<DP>(x1), opaque<DP>(x2),
                     opaque<DP>(y1), opaque<DP>(y2));
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    probabilities<false>(
        s, dp, row, y0 + col, whole_tile(a, qa, y0), a, scale_log2,
        [&](int, int e, float& lv, float& dl) {
          lv = rl[e >> 1];
          dl = rd[e >> 1];
        });
    uint32_t dh[16], dl[16];
    split(dp, dh, dl);
    issue_update<DP>(dq, dh, dl, y1);              // dQ += dS K
    wgmma_wait_all();
    fence_regs(dq);
    fence_regs(dh);                                // live until the wait
    fence_regs(dl);
    if (lane == 0) mbar_arrive(empty_bar(bars, stage));
  }
}

// Write a warpgroup's accumulator pair (rows r0 + 16 warp + lane / 4 (+ 8),
// columns 8 j + 2 (lane % 4) (+ 1)) as bf16 x scale to `out` rows at
// stride ss, rows past S and columns past D skipped.
template <int DP>
__device__ __forceinline__ void store_bf16(const float (&acc)[DP / 2],
                                           bf16* out, long long ss, int r0,
                                           int S, int D, float scale) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
  const int row = r0 + 16 * warp + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int x = row + 8 * i;
    if (x >= S) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col;
      if (c >= D) continue;             // D % 8 == 0: c + 1 < D too
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)x * ss + c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale,
                                acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// The same as fp32 into a contiguous [S, D] share.
template <int DP>
__device__ __forceinline__ void store_share(const float (&acc)[DP / 2],
                                            float* out, int r0, int S, int D,
                                            float scale) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
  const int row = r0 + 16 * warp + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int x = row + 8 * i;
    if (x >= S) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col;
      if (c >= D) continue;
      *reinterpret_cast<float2*>(out + (long long)x * D + c) =
          make_float2(acc[4 * j + 2 * i] * scale,
                      acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// Launch 2: see the header.
template <int DP>
__global__ void __launch_bounds__(Threads<DP>::N, 1)
bwd_tiles(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ Args a) {
  using L = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t bars = smem_u32(smem + L::BAR_AT);
  const Work w = block_work(a);
  const int b = blockIdx.y;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(bars, s), 32);
      mbar_init(empty_bar(bars, s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, read through a shuffle so that the compiler
  // knows it is uniform across each warp.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const Maps m{&tq, &tk, &tv, &tdo};
  if (threadIdx.x == 0) load_x<DP>(m, a, w, smem, bars, b);
  if (wg == 2) {                      // the producer warp, where there is one
    for (int it = 0; it < w.ny; ++it) produce<DP>(m, a, w, smem, bars, b, it);
    return;
  }
  if (!Threads<DP>::PRODUCER_WARP && threadIdx.x < 32)
    for (int it = 0; it < min(STAGES, w.ny); ++it)
      produce<DP>(m, a, w, smem, bars, b, it);
  const int r0 = w.x0 + 64 * wg;
  if (!w.dkv) {
    float dq[DP / 2];
    consume_dq<DP>(m, a, w, smem, bars, wg, b, dq);
    store_bf16<DP>(dq, a.dq + b * a.st.dq.b + w.h * a.st.dq.h, a.st.dq.s,
                   r0, a.S, a.D, a.scale);
    return;
  }
  float dk[DP / 2], dv[DP / 2];
  consume_dkv<DP>(m, a, w, smem, bars, wg, b, dk, dv);
  if (a.group == 1) {
    store_bf16<DP>(dk, a.dk + b * a.st.dk.b + w.kvh * a.st.dk.h, a.st.dk.s,
                   r0, a.S, a.D, a.scale);
    store_bf16<DP>(dv, a.dv + b * a.st.dv.b + w.kvh * a.st.dv.h, a.st.dv.s,
                   r0, a.S, a.D, 1.f);
    return;
  }
  // This head's share, [group, B, Hkv, S, D] fp32.
  const int Hkv = a.Hq / a.group;
  const long long share =
      (((long long)(w.h % a.group) * gridDim.y + b) * Hkv + w.kvh) * a.S *
      a.D;
  store_share<DP>(dk, a.pdk + share, r0, a.S, a.D, a.scale);
  store_share<DP>(dv, a.pdv + share, r0, a.S, a.D, 1.f);
}

// Launch 1: delta = rowsum(dO o O), 8 lanes per row of [B, Hq, S], O fp32
// contiguous, dO bf16 strided (4 columns a lane a step, every step's loads
// issued before the sums).
template <int DP>
__global__ void __launch_bounds__(DELTA_ROWS * 8)
bwd_delta(const float* __restrict__ o, const bf16* __restrict__ dout,
          float* __restrict__ delta, int Hq, int S, int D, View st,
          long long rows) {
  constexpr int STEPS = DP / 32;
  const long long row =
      (long long)blockIdx.x * DELTA_ROWS + (threadIdx.x >> 3);
  const int l = threadIdx.x & 7;
  float acc = 0.f;
  if (row < rows) {
    const int i = (int)(row % S);
    const long long bh = row / S;
    const int h = (int)(bh % Hq), b = (int)(bh / Hq);
    const float* orow = o + row * D;
    const bf16* drow = dout + b * st.b + h * st.h + i * st.s;
    float4 x[STEPS];
    uint2 y[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int c = 4 * l + 32 * s;
      x[s] = c < D ? *reinterpret_cast<const float4*>(orow + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      y[s] = c < D ? *reinterpret_cast<const uint2*>(drow + c)
                   : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const float2 y01 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&y[s].x));
      const float2 y23 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&y[s].y));
      acc = fmaf(x[s].x, y01.x, acc);
      acc = fmaf(x[s].y, y01.y, acc);
      acc = fmaf(x[s].z, y23.x, acc);
      acc = fmaf(x[s].w, y23.y, acc);
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (l == 0 && row < rows) delta[row] = acc;
}

// Launch 3 (GQA): dk and dv as the sums of the group's shares,
// added in head order and rounded to bf16 once; one thread per element
// pair of [B, Hkv, S, D].
__global__ void __launch_bounds__(256)
bwd_dkv_sum(const float* __restrict__ pdk, const float* __restrict__ pdv,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int group,
            int Hkv, int S, int D, Views st, long long n) {
  const long long i = 2 * ((long long)blockIdx.x * 256 + threadIdx.x);
  if (i >= n) return;
  const int c = (int)(i % D);
  const long long row = i / D;
  const int s = (int)(row % S);
  const long long bh = row / S;
  const int h = (int)(bh % Hkv), b = (int)(bh / Hkv);
  float2 ak = make_float2(0.f, 0.f), av = ak;
  for (int g = 0; g < group; ++g) {
    const float2 x = *reinterpret_cast<const float2*>(pdk + g * n + i);
    const float2 y = *reinterpret_cast<const float2*>(pdv + g * n + i);
    ak.x += x.x;
    ak.y += x.y;
    av.x += y.x;
    av.y += y.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(
      dk + b * st.dk.b + h * st.dk.h + (long long)s * st.dk.s + c) =
      __floats2bfloat162_rn(ak.x, ak.y);
  *reinterpret_cast<__nv_bfloat162*>(
      dv + b * st.dv.b + h * st.dv.h + (long long)s * st.dv.s + c) =
      __floats2bfloat162_rn(av.x, av.y);
}

View view(const long long* st, int t) { return {st[3 * t], st[3 * t + 1],
                                                st[3 * t + 2]}; }

int launch_delta(const void* o, const void* dout, void* delta, int B,
                 int Hq, int S, int D, View st, cudaStream_t stream) {
  const long long rows = (long long)B * Hq * S;
  auto kernel = D <= 64 ? bwd_delta<64> : bwd_delta<128>;
  kernel<<<(unsigned)((rows + DELTA_ROWS - 1) / DELTA_ROWS), DELTA_ROWS * 8,
           0, stream>>>(
      static_cast<const float*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), Hq, S, D, st, rows);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_tiles(const CUtensorMap (&maps)[4], const Args& a, int B,
                 cudaStream_t stream) {
  const int smem = Smem<DP>::BYTES;
  const int Hkv = a.Hq / a.group;
  // Above 48 KB a kernel must opt in to dynamic shared memory, per device,
  // so on every call.
  cudaError_t e = cudaFuncSetAttribute(
      bwd_tiles<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(2 * a.Hq, B, (a.S + BX - 1) / BX);
  bwd_tiles<DP><<<grid, Threads<DP>::N, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.group == 1) return (int)e;
  const long long n = (long long)B * Hkv * a.S * a.D;
  bwd_dkv_sum<<<(unsigned)((n / 2 + 255) / 256), 256, 0, stream>>>(
      a.pdk, a.pdv, a.dk, a.dv, a.group, Hkv, a.S, a.D, a.st, n);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Hq, int Hkv, int S, int D) {
  return D <= 0 || D > MAX_D || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
         S <= 0 || B <= 0;
}

}  // namespace

extern "C" {

// strides: 21 element strides, (batch, head, sequence) for q, k, v, dout,
// dq, dk, dv in that order.  bf16 q, k, v, dout, dq, dk, dv; o (the
// forward's output before its rounding) fp32 [B, Hq, S, D] contiguous; lse
// and the delta scratch fp32 [B, Hq, S] contiguous (delta is written
// here); when Hq > Hkv the scratch `shares` holds 2 x [Hq / Hkv, B, Hkv,
// S, D] fp32 (dK's shares, then dV's), otherwise it is not read.  window
// <= 0 means no window.  Returns the first CUDA error of the launches (0 on
// success), or -(CUresult) when a tensor map cannot be built.
int odin_flash_attention_bwd_bf16(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  void* delta, void* shares, void* dq,
                                  void* dk, void* dv, int B, int Hq,
                                  int Hkv, int S, int D,
                                  const long long* strides, int causal,
                                  int window, float scale, void* stream_) {
  if (bad_shape(B, Hq, Hkv, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const Views st{view(strides, 0), view(strides, 1), view(strides, 2),
                 view(strides, 3), view(strides, 4), view(strides, 5),
                 view(strides, 6)};
  const int group = Hq / Hkv;
  int e = launch_delta(o, dout, delta, B, Hq, S, D, st.dout, stream);
  if (e != 0) return e;

  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  const int heads[4] = {Hq, Hkv, Hkv, Hq};
  for (int t = 0; t < 4; ++t) {
    const CUresult r =
        make_map(&maps[t], ptrs[t], B, heads[t], S, D, strides + 3 * t, BY);
    if (r != CUDA_SUCCESS) return -(int)r;
  }
  const long long n = (long long)B * Hkv * S * D;
  float* pdk = static_cast<float*>(shares);
  Args a{static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<bf16*>(dq), static_cast<bf16*>(dk),
         static_cast<bf16*>(dv), pdk, group > 1 ? pdk + group * n : nullptr,
         st, Hq, group, S, D, causal, window, scale};
  return D <= 64 ? launch_tiles<64>(maps, a, B, stream)
                 : launch_tiles<128>(maps, a, B, stream);
}

// Launch 1 alone (delta), for timing it apart; arguments as above
// (strides: dout's three).
int odin_flash_attention_bwd_bf16_delta(const void* o, const void* dout,
                                        void* delta, int B, int Hq, int Hkv,
                                        int S, int D,
                                        const long long* strides,
                                        void* stream) {
  if (bad_shape(B, Hq, Hkv, S, D)) return (int)cudaErrorInvalidValue;
  return launch_delta(o, dout, delta, B, Hq, S, D, view(strides, 0),
                      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory and threads of a block of launch 2 at head dim D.
int odin_flash_attention_bwd_bf16_smem_bytes(int D) {
  return D <= 64 ? Smem<64>::BYTES : Smem<128>::BYTES;
}

int odin_flash_attention_bwd_bf16_threads(int D) {
  return D <= 64 ? Threads<64>::N : Threads<128>::N;
}

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
