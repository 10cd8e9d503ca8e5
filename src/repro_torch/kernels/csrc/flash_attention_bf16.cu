// Flash attention forward for Hopper (sm_90a) in bf16, plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel) for bf16 inputs: online-softmax attention with scale
// D^-0.5, running (m, l, acc) in fp32, causal / sliding-window
// (qp - kp < window) / bidirectional masks, KV tiles that no row of a
// block sees skipped,
// GQA by kv_head = q_head / group, masked scores set to -1e30 and the
// normaliser floored at 1e-30.  fp32 inputs go to flash_attention.cu, whose
// products are TF32 split three ways (one TF32 product cannot hold the fp32
// limit).
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
// * A second entry point, odin_flash_attention_bf16_fwd_lse, is the
//   forward of training: the template flag LSE also writes each row's
//   log-sum-exp of its scaled scores, m + log(max(l, 1e-30)) in natural-log
//   units (m ln 2 + log l from the base-2 m), and the fp32 output before
//   its rounding to bf16, which the backward's delta = rowsum(dO o O)
//   reads (from the bf16 O it costs about 1e-3 of dQ's and dK's rms, a
//   CPU model of the backward shows; tests/test_torch_kernels.py).  Both
//   are written at the end, where m, l and O are live anyway; the plain
//   entry point's instantiation (LSE false) is the code it was.
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
//
// The TMA, mbarrier, descriptor and wgmma helpers live in hopper_bf16.cuh,
// which the bf16 backward (flash_attention_bwd_bf16.cu) shares.

#include "hopper_bf16.cuh"

namespace {

constexpr int BQ = 128;        // query rows per block (two warpgroups of 64)
constexpr int BK = 128;        // keys per KV tile
constexpr int STAGES = 2;      // K and V ring depth
constexpr int NT = 288;        // two consumer warpgroups + one producer warp
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
// With LSE, also each row's log-sum-exp (lse, from this head's row 0) and
// the fp32 output (o32, rows of D floats from this head's row 0).
//
// Each turn on the tensor cores issues P V of the previous tile and Q K^T
// of this one; the warpgroups take turns (ping-pong), so one's softmax
// runs while the other's products do.  Every tile of the block's range is
// computed (the masks zero what a warpgroup's rows do not see), so the
// loop has no branch around its products.
template <int DP, bool LSE>
__device__ __forceinline__ void consume(
    const uint8_t* sQ, const uint8_t* sK, const uint8_t* sV, uint32_t bars,
    int cw, int q0, int kt_begin, int ntiles, int S, int D, int causal,
    int window, float scale_log2, __nv_bfloat16* __restrict__ ob,
    long long oss, float* __restrict__ lse, float* __restrict__ o32) {
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
    if constexpr (LSE) {
      if (row0 < S)
        *reinterpret_cast<float2*>(o32 + (long long)row0 * D + c) =
            make_float2(o[4 * j] / l0, o[4 * j + 1] / l0);
      if (row0 + 8 < S)
        *reinterpret_cast<float2*>(o32 + (long long)(row0 + 8) * D + c) =
            make_float2(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
    }
  }
  if constexpr (LSE) {
    if ((lane & 3) == 0) {
      if (row0 < S) lse[row0] = m0 * LN2 + logf(l0);
      if (row0 + 8 < S) lse[row0 + 8] = m1 * LN2 + logf(l1);
    }
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

template <int DP, bool LSE>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int group, int S, int D,
               long long osb, long long osh, long long oss, int causal,
               int window, float scale_log2, float* __restrict__ lse,
               float* __restrict__ o32) {
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
    const long long row = ((long long)b * gridDim.x + h) * S;  // lse, o32
    consume<DP, LSE>(sQ, sK, sV, bars, wg, q0, kt_begin, ntiles, S, D,
                     causal, window, scale_log2, o + b * osb + h * osh, oss,
                     LSE ? lse + row : nullptr, LSE ? o32 + row * D : nullptr);
  }
}

template <int DP, bool LSE>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, void* o, float* lse, float* o32, int B,
           int Hq, int Hkv, int S, int D, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
  const int smem = Smem<DP>::BYTES;
  // Above 48 KB a kernel must opt in to dynamic shared memory; the opt-in
  // is per device, so it is made on every call (microseconds).
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<DP, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, (S + BQ - 1) / BQ, B);
  flash_fwd_bf16<DP, LSE><<<grid, NT, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq / Hkv, S, D, st[9],
      st[10], st[11], causal, window, scale * LOG2E, lse, o32);
  return (int)cudaGetLastError();
}

// Both entry points: check, build the tensor maps, launch.
template <bool LSE>
int forward(const void* q, const void* k, const void* v, void* o, void* lse,
            void* o32, int B, int Hq, int Hkv, int S, int D,
            const long long* strides, int causal, int window, float scale,
            void* stream) {
  if (D <= 0 || D > MAX_D || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(&tq, q, B, Hq, S, D, strides, BQ);
  if (r == CUDA_SUCCESS) r = make_map(&tk, k, B, Hkv, S, D, strides + 3, BK);
  if (r == CUDA_SUCCESS) r = make_map(&tv, v, B, Hkv, S, D, strides + 6, BK);
  if (r != CUDA_SUCCESS) return -(int)r;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fl = static_cast<float*>(lse);
  float* fo = static_cast<float*>(o32);
  if (D <= 64)
    return launch<64, LSE>(tq, tk, tv, o, fl, fo, B, Hq, Hkv, S, D, strides,
                           causal, window, scale, s);
  return launch<128, LSE>(tq, tk, tv, o, fl, fo, B, Hq, Hkv, S, D, strides,
                          causal, window, scale, s);
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
  return forward<false>(q, k, v, o, nullptr, nullptr, B, Hq, Hkv, S, D,
                        strides, causal, window, scale, stream);
}

// The same, and also lse (fp32 [B, Hq, S], contiguous: each row's
// log-sum-exp of its scaled scores) and o32 (fp32 [B, Hq, S, D],
// contiguous: the output before its rounding to bf16).
int odin_flash_attention_bf16_fwd_lse(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      void* o32, int B, int Hq, int Hkv,
                                      int S, int D, const long long* strides,
                                      int causal, int window, float scale,
                                      void* stream) {
  return forward<true>(q, k, v, o, lse, o32, B, Hq, Hkv, S, D, strides,
                       causal, window, scale, stream);
}

// Dynamic shared memory a launch at head dim D asks for (bytes).
int odin_flash_attention_bf16_smem_bytes(int D) {
  return D <= 64 ? Smem<64>::BYTES : Smem<128>::BYTES;
}

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
