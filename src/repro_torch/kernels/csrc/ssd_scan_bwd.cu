// Mamba2 SSD chunk scan backward for Hopper (sm_90a), plain C interface.
//
// The gradient of the port's K3 forward (ssd_scan.cu), which replaces the
// TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan.  The JAX package has
// no Pallas backward: its model differentiates the jnp ssd_chunked
// (models/mamba2.py), and this kernel gives that gradient.  Per (batch,
// head, chunk), with positions i, j of the chunk (j <= i throughout), a_t =
// dt_t A, cs its inclusive cumulative sum within the chunk, u_j = dt_j x_j,
// L_ij = exp(cs_i - cs_j), h- the state entering the chunk (the forward's
// scratch) and G the gradient of the state leaving it:
//
//   G_{c-1} = exp(cs_last,c) G_c + sum_i exp(cs_i) dy_i (x) C_i      (1, 2)
//   W = (C_i . B_j) L_ij,  M = (dy_i . u_j) L_ij,  s_ij = W_ij (dy_i . u_j)
//   du_j = sum_i W_ij dy_i + exp(cs_last - cs_j) G B_j                (3)
//   dB_j = sum_i M_ij C_i  + exp(cs_last - cs_j) G^T u_j               (3)
//   dC_i = sum_j M_ij B_j  + exp(cs_i) h-^T dy_i                       (3)
//   dx_j = dt_j du_j;  dcs_i = sum_j s_ij - sum_k s_ki + r_i - w_i     (4)
//   with r_i = exp(cs_i) dy_i . (h- C_i), w_j = exp(cs_last - cs_j)
//   u_j . (G B_j); dcs_last gains sum_j w_j + exp(cs_last) <h-, G>;
//   da_t = sum_{i >= t} dcs_i;  ddt_t = x_t . du_t + A da_t;
//   dA = sum_t dt_t da_t; dB and dC summed over heads (n_groups = 1)   (4, 5)
//
// Five launches:
// 1. ssd_bwd_chunk_dstates, one block per (chunk >= 1, head, batch): the
//    chunk's own term sum_i exp(cs_i) dy_i (x) C_i into an fp32 scratch
//    shaped like the forward's chunk states (chunk 0's is never needed).
// 2. ssd_bwd_state_pass, one thread per (state element, head, batch): the
//    reverse recurrence from the last chunk back, in fp32, overwriting the
//    scratch with G_c.
// 3. ssd_bwd_tiles: three kinds of block, each holding a fixed tile of 64
//    positions and streaming the chunk's other tiles past it:
//      du blocks: fixed B_j, x_j; streamed C_i, dy_i over the row tiles at
//        or after it; du (to dx and the x . du part of ddt), the column
//        sums of s, w_j, and each streamed row's sum of s over the fixed
//        keys (the only place s is computed);
//      dB blocks: fixed x_j; streamed C_i, dy_i; the head's share of dB;
//      row blocks: fixed dy_i; streamed B_j, x_j over the key tiles at or
//        before it; the head's share of dC and r_i.
//    Each writes per-position partials (fp64) and its head's share of dB or
//    dC (fp32) to scratch; no block adds into another's output.  The du
//    blocks (three products a pair) go first.
// 4. ssd_bwd_chunk_finish, one block per (chunk, head, batch): dcs (the
//    rows' sums of s added over the key tiles in order), its reverse
//    cumulative sum da, ddt, and the chunk's share of dA.
// 5. ssd_bwd_sums: dB and dC summed over heads in head order, dA over
//    (batch, chunk) in order.  No float atomics: two calls give the same
//    bits.
//
// What bounds it on an H100: operations.  At mamba2-370m's training shape
// (b 8, S 256, H 32, P 64, N 128, one chunk, fp32) the five products of
// pairs (C.B, dy.u, du, dB, dC) need about 6.5 GFLOP against about 55 MB
// of inputs and gradients, far above the ridge.  The products run on the
// tensor cores, mma.sync m16n8k8 with TF32 operands (tf32_mma.cuh): every
// fp32 operand is split into hi = tf32(v) and lo = tf32(v - hi) as its
// fragment is read (no hi/lo tiles in shared memory), and a product of two
// fp32 operands runs as lo.hi + hi.lo + hi.hi ("3xTF32", about 22 bits;
// one TF32 product keeps 11 and misses the fp32 limit).  The splits round
// ties to even (split_rn: cvt.rn is one instruction, cvt.rna four): with
// cvt.rna they outnumbered the HMMAs several times over, and the fp32 call
// took 1.5x as long.  bf16 inputs take the same route: a bf16 value is
// exact in TF32, so it has no lo term, and a product of two bf16 inputs
// (C.B, dy.x) runs once, one of a bf16 input and an fp32 operand (the
// weighted scores, the state) twice.
//
// Each block's 8 warps take 16 fixed rows each (four row groups) and half
// of every streamed tile (32 positions) for the scores, decay, mask and W
// or M applied in registers.  In du blocks a warp's W enters the output
// product straight from the accumulator layout as its A fragment (k slots
// t and t + 4 on the streamed positions 2t and 2t + 1, the columns a lane
// holds); the two halves' du meet once, in shared memory, at the end, and
// each half then owns half of du's columns.  dB and row blocks hand M
// through shared memory (after one barrier a tile every warp takes all 64
// positions as k for its half of the output's columns), so each of their
// threads holds 32 accumulators instead of 64.  u = dt x is never formed:
// dy . u_j is dt_j (dy . x_j), and G^T u_j is dt_j (G^T x_j).  One block
// computing du and dB together would hold 96 accumulators a thread beside
// the scores; in three kinds (dB blocks recompute dy . u, a product with k
// = P) two blocks of 256 threads fit an SM: at most 128 registers with no
// spill, and 105984 B of shared memory (fp32, one stage of streamed
// tiles) or 85248 B (bf16, two stages).  Products with the state are
// skipped where it is zero (G of the last chunk without a dstate, h- of
// the first).
//
// Precision: dcs is a sum of terms of both signs that cancel (the s terms
// of a pair enter two positions with opposite signs), so the row and column
// sums of s, dcs, its reverse cumulative sum and the dA partials are taken
// in fp64, as the forward sums cs in fp64.  s_ij is computed once, in the
// du block of key tile j's, which writes both of its sums: the column sum
// over its rows (fp64, per key) and each row's partial over the key tile
// (fp64 scratch [b, H, S, 4 + tiles]), which launch 4 adds in tile order.
// So the pair's two terms are the same bits and cancel exactly in
// sum_t dcs_t.  The decays exp(cs_i - cs_j) come from the forward's fp32
// (hi, lo) pairs of cs; pairs j > i are an exact 0, never exp(+x).
//
// Measured (chip_smoke.py and tools/k23_variants.py ssd_scan_bwd on an
// NVIDIA H100 80GB HBM3, 700.00 W): 0.418 ms at the training shape in
// fp32 and 0.302 ms in bf16, against 1.33 ms for both when the products
// ran as fp32 FMA on the CUDA cores (in one process); 0.283 ms at S 1024
// (0.80) and 1.86 ms at jamba's H 256 (5.39).  That is 11x its bound (6.5
// GFLOP as 3xTF32 at 495 TFLOP/s); the tile launch is 85% of a call.  With
// cvt.rna splits the fp32 call took 0.64 ms.  In a full-width mamba2-370m
// fp32 train step the backward takes 19.7 ms of device time (63.9 on the
// CUDA cores).
//
// Layout: x [b, S, H, P], dt [b, S, H], B and C [b, S, N] and dy [b, S, H,
// P] are read through element strides (last dimension's stride 1; the
// strides of x, B, C and dy multiples of 16 bytes and their bases 16-byte
// aligned, for cp.async), so the model's views into its conv output are
// read in place.  The gradients are written contiguous: dx [b, S, H, P],
// ddt [b, S, H], dA [H], dB and dC [b, S, N], each in the inputs' dtype.
// P <= 64 and N <= 128, multiples of 8 (bf16) or 4 (fp32).  Any S and any
// chunk; a short last chunk is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int TR = 64;             // positions of a tile
constexpr int PP = 64;             // P, padded
constexpr int NP = 128;            // N, padded
constexpr int NT_DSTATES = 256;    // launch 1: 8 warps, 16 x 64 of [P, N]
constexpr int NT_PASS = 256;       // launch 2
constexpr int NT_TILES = 256;      // launch 3: 8 warps
constexpr int NT_FINISH = 256;     // launches 4 and 5
constexpr int NPART0 = 4;          // fp64 slots per position before the
                                   // key tiles' partial row sums of s
constexpr int LDG_COLS = NP + 4;   // the state read as [column][k]
constexpr int LDG_ROWS = NP + 8;   // the state read as [k][column]
constexpr int LDM = TR + 8;        // M in dB and row blocks, [row][k]

// Shared tiles' row strides: 16-byte rows, and k slots t, t + 4 of rows
// g (or 2t, 2t + 1 of columns g) read without bank conflicts.
template <typename T>
struct Tile {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int VE = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int LDN = NP + VE;
  static constexpr int LDP = PP + VE;
  static constexpr int TI = F32 ? 2 : 1;      // TF32 terms of an input
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// cs_i - cs_j of two cumulative sums kept as fp32 (hi, lo) pairs (as in
// ssd_scan.cu).
__device__ __forceinline__ float cs_diff(float2 i, float2 j) {
  return (i.x - j.x) + (i.y - j.y);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Strides {
  long long xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css, ysb, yss, ysh;
};

// Copy rows [0, rows) of width `width` (a multiple of 16 bytes) from
// global rows `src + r * rs` into a shared tile with row stride `ld`; rows
// at or past `valid` are zero-filled.  Every block has NT threads; thread
// k copies pieces k, k + NT, ... of 16 bytes, its (row, piece) advanced
// without a division.
template <int NT, typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long rs, int rows, int valid,
                                          int width) {
  constexpr int VE = Tile<T>::VE;
  const int pieces = width / VE;
  const int dr = NT / pieces, dc = NT - dr * pieces;
  int r = threadIdx.x / pieces, c = threadIdx.x - r * pieces;
  while (r < rows) {
    const bool ok = r < valid;
    cp_async16(dst + r * ld + c * VE, src + (ok ? r * rs : 0) + c * VE, ok);
    r += dr;
    c += dc;
    if (c >= pieces) {
      c -= pieces;
      ++r;
    }
  }
}

// Zero columns [width, padded) of every row of a shared tile (the columns
// the copies never write).
template <typename T>
__device__ __forceinline__ void zero_columns(T* dst, int ld, int rows,
                                             int width, int padded) {
  const int w = padded - width;
  for (int e = threadIdx.x; e < rows * w; e += blockDim.x)
    dst[(e / w) * ld + width + e % w] = T(0.f);
}

// An operand as TERMS TF32 values: hi (and lo = tf32(v - hi) where TERMS
// is 2), each rounded to nearest even (tf32_mma.cuh's split_rn).  With one
// term v must be exact in TF32 (a bf16 input).
template <int TERMS>
__device__ __forceinline__ void terms(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (TERMS == 2) {
    split_rn(v, hi, lo);
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

// d[n] += a b[n] for NTL column tiles, a in TA TF32 terms and b in TB: the
// lo.hi and hi.lo terms that exist first, then hi.hi (with two terms each,
// tf32_mma.cuh's mma3).  Each term runs over all tiles before the next.
template <int TA, int TB, int NTL>
__device__ __forceinline__ void mma_terms(float (*d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[NTL][2],
                                          const uint32_t (&bl)[NTL][2]) {
  if constexpr (TA == 2) {
#pragma unroll
    for (int n = 0; n < NTL; ++n) mma_tf32(d[n], al, bh[n]);
  }
  if constexpr (TB == 2) {
#pragma unroll
    for (int n = 0; n < NTL; ++n) mma_tf32(d[n], ah, bl[n]);
  }
#pragma unroll
  for (int n = 0; n < NTL; ++n) mma_tf32(d[n], ah, bh[n]);
}

// Fragments of one 8-wide k-slice of m16n8k8: lane = 4 g + t holds A rows
// g, g + 8 at k slots t and t + 4, and B k slots t and t + 4 of column g.
//
// A of a [row][k] tile, k slots in order; p points at (row g, k t).
template <int TERMS, typename T>
__device__ __forceinline__ void frag_rows(const T* p, int ld,
                                          uint32_t (&ah)[4],
                                          uint32_t (&al)[4]) {
  terms<TERMS>(to_f32(p[0]), ah[0], al[0]);
  terms<TERMS>(to_f32(p[8 * ld]), ah[1], al[1]);
  terms<TERMS>(to_f32(p[4]), ah[2], al[2]);
  terms<TERMS>(to_f32(p[8 * ld + 4]), ah[3], al[3]);
}

// B of NTL column tiles of a [column][k] tile, k slots in order; p points
// at (column g, k t).
template <int TERMS, int NTL, typename T>
__device__ __forceinline__ void frag_cols(const T* p, int ld,
                                          uint32_t (&bh)[NTL][2],
                                          uint32_t (&bl)[NTL][2]) {
#pragma unroll
  for (int n = 0; n < NTL; ++n) {
    terms<TERMS>(to_f32(p[8 * n * ld]), bh[n][0], bl[n][0]);
    terms<TERMS>(to_f32(p[8 * n * ld + 4]), bh[n][1], bl[n][1]);
  }
}

// B of NTL column tiles of a [k][column] tile, k slots t and t + 4 on rows
// 2t and 2t + 1: the positions of an accumulator fed in as A (frag_acc);
// p points at (row 2t, column g).
template <int TERMS, int NTL, typename T>
__device__ __forceinline__ void frag_pairs(const T* p, int ld,
                                           uint32_t (&bh)[NTL][2],
                                           uint32_t (&bl)[NTL][2]) {
#pragma unroll
  for (int n = 0; n < NTL; ++n) {
    terms<TERMS>(to_f32(p[8 * n]), bh[n][0], bl[n][0]);
    terms<TERMS>(to_f32(p[ld + 8 * n]), bh[n][1], bl[n][1]);
  }
}

// B of NTL column tiles of a [k][column] tile, k slots in order (rows t
// and t + 4); p points at (row t, column g).
template <int TERMS, int NTL, typename T>
__device__ __forceinline__ void frag_krows(const T* p, int ld,
                                           uint32_t (&bh)[NTL][2],
                                           uint32_t (&bl)[NTL][2]) {
#pragma unroll
  for (int n = 0; n < NTL; ++n) {
    terms<TERMS>(to_f32(p[8 * n]), bh[n][0], bl[n][0]);
    terms<TERMS>(to_f32(p[4 * ld + 8 * n]), bh[n][1], bl[n][1]);
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&a)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) a[r][c] = 0.f;
}

// The sum of one double per thread of the block, in a fixed order; every
// thread gets it.  `red` holds NT_FINISH / 32 doubles of shared memory.
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < NT_FINISH / 32; ++w) total += red[w];
  return total;
}

template <typename T>
int dstates_smem() {
  using L = Tile<T>;
  return TR * (L::LDP + L::LDN) * sizeof(T) + TR * 4;
}

// Launch 1: one block per (chunk c >= 1, head, batch).  Warp w holds rows
// 16 (w % 4) of the [P, N] sum and its columns 64 (w / 4); the product
// A[p][i] = exp(cs_i) dy_i[p] (fp32, two terms) times C_i[n], with k slots
// t and t + 4 on positions 2t and 2t + 1.  (Without a second block an SM
// in its bounds, ptxas spills the bf16 instantiation at 80 registers.)
template <typename T>
__global__ void __launch_bounds__(NT_DSTATES, 2)
ssd_bwd_chunk_dstates(const T* __restrict__ Cm, const T* __restrict__ dy,
                      const float2* __restrict__ cs, float* __restrict__ g,
                      int S, int H, int P, int N, int chunk, int nc,
                      Strides st) {
  using L = Tile<T>;
  constexpr int TI = L::TI;
  extern __shared__ __align__(16) uint8_t smem[];
  T* sDy = reinterpret_cast<T*>(smem);                    // [TR][LDP]
  T* sC = sDy + TR * L::LDP;                              // [TR][LDN]
  float* sE = reinterpret_cast<float*>(sC + TR * L::LDN); // [TR]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t2 = 2 * (lane & 3);
  const int c = blockIdx.x + 1, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * chunk, cl = min(chunk, S - c0);
  const float2* csb = cs + ((long long)b * H + h) * S + c0;
  const T* yb = dy + b * st.ysb + h * st.ysh + c0 * st.yss;
  const T* Cb = Cm + b * st.csb + c0 * st.css;
  const int p0 = 16 * (warp & 3), n0 = 64 * (warp >> 2);

  zero_columns(sDy, L::LDP, TR, P, PP);
  zero_columns(sC, L::LDN, TR, N, NP);
  float acc[8][4];
  zero(acc);
  for (int i0 = 0; i0 < cl; i0 += TR) {
    const int ni = min(TR, cl - i0);
    __syncthreads();  // the last tile is consumed
    load_rows<NT_DSTATES>(sC, L::LDN, Cb + i0 * st.css, st.css, TR, ni, N);
    load_rows<NT_DSTATES>(sDy, L::LDP, yb + i0 * st.yss, st.yss, TR, ni, P);
    if (tid < TR) {
      const float2 v = tid < ni ? csb[i0 + tid] : make_float2(0.f, 0.f);
      sE[tid] = tid < ni ? expf(v.x + v.y) : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (p0 < P) {
#pragma unroll
      for (int k8 = 0; k8 < TR; k8 += 8) {
        const int i = k8 + t2;
        const T* yp = sDy + i * L::LDP + p0 + gq;
        const float e0 = sE[i], e1 = sE[i + 1];
        uint32_t ah[4], al[4], bh[8][2], bl[8][2];
        split_rn(to_f32(yp[0]) * e0, ah[0], al[0]);
        split_rn(to_f32(yp[8]) * e0, ah[1], al[1]);
        split_rn(to_f32(yp[L::LDP]) * e1, ah[2], al[2]);
        split_rn(to_f32(yp[L::LDP + 8]) * e1, ah[3], al[3]);
        frag_pairs<TI, 8>(sC + i * L::LDN + n0 + gq, L::LDN, bh, bl);
        mma_terms<2, TI, 8>(acc, ah, al, bh, bl);
      }
    }
  }
  float* out = g + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + gq + (e >= 2 ? 8 : 0);
      const int n = n0 + 8 * nt + t2 + (e & 1);
      if (p < P && n < N) out[p * N + n] = acc[nt][e];
    }
}

// Launch 2: the reverse recurrence over chunks, one thread per (p, n) of a
// head.  Scratch chunk c holds its own term on entry (c >= 1) and G_c, the
// gradient of the state leaving chunk c, on exit.
__global__ void __launch_bounds__(NT_PASS)
ssd_bwd_state_pass(const float2* __restrict__ cs,
                   const float* __restrict__ dstate, float* __restrict__ g,
                   int S, int H, int PN, int chunk, int nc) {
  const int e = blockIdx.x * NT_PASS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const float2* csb = cs + ((long long)b * H + h) * S;
  float* gb = g + ((long long)b * nc * H + h) * PN + e;
  const long long step = (long long)H * PN;   // from chunk to chunk
  float grad = dstate != nullptr ? dstate[((long long)b * H + h) * PN + e]
                                 : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const float own = c > 0 ? gb[c * step] : 0.f;
    gb[c * step] = grad;
    const float2 last = csb[min((c + 1) * chunk, S) - 1];
    grad = fmaf(grad, expf(last.x + last.y), own);
  }
}

// Launch 3's shared memory: a fixed tile of N columns (du blocks: B_j) and
// one of P columns (x_j, or dy_i in row blocks), ST stages of streamed
// tiles (C_i and dy_i, or B_j and x_j), the positions' cs and dt, and fp64
// sums.  fp32 streams through one stage (two blocks an SM), bf16 two.
template <typename T>
struct TileSmem {
  using L = Tile<T>;
  static constexpr int ST = L::F32 ? 1 : 2;
  static constexpr int TILE_N = TR * L::LDN * (int)sizeof(T);
  static constexpr int TILE_P = TR * L::LDP * (int)sizeof(T);
  static constexpr int FN = 0;      // du blocks B_j; dB and row blocks M
                                    // ([TR][LDM] fp32), then C_i
  static constexpr int FP = FN + (TILE_N > TR * LDM * 4 ? TILE_N
                                                        : TR * LDM * 4);
  static constexpr int SN = FP + TILE_P;              // ST stages
  static constexpr int SP = SN + ST * TILE_N;         // ST stages
  static constexpr int FCS = SP + ST * TILE_P;        // [TR] float2
  static constexpr int FDT = FCS + TR * 8;            // [TR] float
  static constexpr int SCS = FDT + TR * 4;            // ST x [TR] float2
  static constexpr int SDT = SCS + ST * TR * 8;       // ST x [TR] float
  static constexpr int RED = SDT + ST * TR * 4;       // [4][TR] double
  static constexpr int BYTES = RED + 4 * TR * 8;
  // After the streamed tiles their stages hold the du blocks' exchange
  // ([TR][PP + 4] fp32), then the state tile (fp32).
  static constexpr int FREE = ST * (TILE_N + TILE_P);
  static_assert(TR * (PP + 4) * 4 <= FREE, "room for the exchange");
  static_assert(PP * LDG_ROWS * 4 <= FREE, "room for the state");
};

template <typename T>
struct Args {
  const T *x, *dt, *Bm, *Cm, *dy;
  const float2* cs;
  const float *states, *g;
  double* part;
  float *dBh, *dCh;
  T* dx;
  int S, H, P, N, chunk, nc, tiles, npart;
  bool has_dstate;
  Strides st;
};

// One block's place: its chunk, its fixed tile and its warp's share.
struct Ctx {
  int b, h, bh, c, c0, cl, ft, f0, nf, ntiles;   // bh = b H + h
  int tid, g, t, rg, r0, half, kh;
  // Position f0 + r of the fixed tile in [b, H, S] order.
  __device__ long long pos(int S, int r) const {
    return (long long)bh * S + c0 + f0 + r;
  }
};

// Streamed tiles pass through ST stages: stream_begin issues the first
// (two stages), stream_in brings tile ts in and returns its stage,
// stream_out releases it.  fetch(ts, s) issues tile ts's copies into s.
template <int ST, typename Fetch>
__device__ __forceinline__ void stream_begin(int begin, Fetch& fetch) {
  if constexpr (ST == 2) {
    fetch(begin, 0);
    cp_async_commit();
  }
}

template <int ST, typename Fetch>
__device__ __forceinline__ int stream_in(int ts, int begin, int end,
                                         Fetch& fetch) {
  const int s = (ts - begin) % ST;
  if constexpr (ST == 2) {
    if (ts + 1 < end) {
      fetch(ts + 1, s ^ 1);  // its stage was released after tile ts - 1
      cp_async_commit();
      cp_async_wait<1>();    // all but the newest group: tile ts is in
    } else {
      cp_async_wait_all();
    }
  } else {
    __syncthreads();         // the last tile's stage is consumed
    fetch(ts, 0);
    cp_async_wait_all();
  }
  __syncthreads();
  return s;
}

template <int ST>
__device__ __forceinline__ void stream_out() {
  if constexpr (ST == 2) __syncthreads();  // the stage is free for ts + 2
}

// du blocks: the two halves' partial du (16 rows, all 8 column tiles of
// P each) meet in shared memory: each half hands over the columns of the
// other's half and keeps the sum over its own, 4 column tiles from 4
// half.  Returns after every thread has read.
__device__ __forceinline__ void exchange(const float (&acc)[8][4],
                                         float (&own)[4][4], float* xch,
                                         const Ctx& q) {
  constexpr int HT = 4, LDX = PP + 4;
  __syncthreads();  // the stages are consumed
#pragma unroll
  for (int nt = 0; nt < HT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q.r0 + q.g + 8 * (e >> 1);
      const int col = 8 * ((1 - q.half) * HT + nt) + 2 * q.t + (e & 1);
      xch[row * LDX + col] = q.half ? acc[nt][e] : acc[HT + nt][e];
    }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < HT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q.r0 + q.g + 8 * (e >> 1);
      const int col = 8 * (q.half * HT + nt) + 2 * q.t + (e & 1);
      own[nt][e] = (q.half ? acc[HT + nt][e] : acc[nt][e]) +
                   xch[row * LDX + col];
    }
  __syncthreads();  // the exchange is read
}

// dB and row blocks: a warp's weighted scores (16 rows, its half's 32
// positions) go to shared memory, and after the block's barrier each warp
// takes all 64 positions as k of out += M B for its half's 64 columns
// (8 column tiles from column 64 half): A from M's rows as float2 pairs (k
// slots t, t + 4 on positions 2t, 2t + 1), B from rows 2t, 2t + 1 of the
// streamed tile.  Each warp so holds 32 accumulators, none shared.
template <int TI, typename T>
__device__ __forceinline__ void m_product(const float (&m)[4][4],
                                          float* sM, const T* tN, int ldn,
                                          float (&acc)[8][4], const Ctx& q) {
  const int g = q.g, t = q.t;
#pragma unroll
  for (int n4 = 0; n4 < 4; ++n4)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2)
      *reinterpret_cast<float2*>(sM + (q.r0 + g + 8 * e2) * LDM + q.kh +
                                 8 * n4 + 2 * t) =
          make_float2(m[n4][2 * e2], m[n4][2 * e2 + 1]);
  __syncthreads();
  const float* mp = sM + (q.r0 + g) * LDM + 2 * t;
  const T* bp = tN + 2 * t * ldn + 64 * q.half + g;
#pragma unroll
  for (int ks = 0; ks < TR / 8; ++ks) {
    const float2 m0 = *reinterpret_cast<const float2*>(mp + 8 * ks);
    const float2 m1 = *reinterpret_cast<const float2*>(mp + 8 * LDM + 8 * ks);
    uint32_t ah[4], al[4];
    split_rn(m0.x, ah[0], al[0]);
    split_rn(m1.x, ah[1], al[1]);
    split_rn(m0.y, ah[2], al[2]);
    split_rn(m1.y, ah[3], al[3]);
#pragma unroll
    for (int q4 = 0; q4 < 8; q4 += 4) {
      uint32_t bh[4][2], bl[4][2];
      frag_pairs<TI, 4>(bp + 8 * ks * ldn + 8 * q4, ldn, bh, bl);
      mma_terms<2, TI, 4>(acc + q4, ah, al, bh, bl);
    }
  }
}

// The state [P, N] (G or h-) into shared memory with row stride ld; rows
// past P and columns past N zero.
__device__ __forceinline__ void load_state(float* dst, int ld,
                                           const float* src, int P, int N) {
  load_rows<NT_TILES>(dst, ld, src, (long long)N, PP, P, N);
  zero_columns(dst, ld, PP, N, NP);
  cp_async_wait_all();
  __syncthreads();
}

// A thread's two values of a row (rows g, g + 8 of its warp) summed over
// the four lanes that share g, in a fixed order.
template <typename V>
__device__ __forceinline__ V quad_sum(V v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// du blocks: fixed key tile ft (B_j, x_j), streamed row tiles [ft, ntiles)
// (C_i, dy_i).  Scores S^T = B_j C_i^T and (dy . x)^T = x_j dy_i^T; s; du_j
// += W^T dy_i.  Writes dx, and per key the column sum of s plus w_j, w_j
// and x_j . du_j; per streamed row the partial sum of s over the tile.
template <typename T, typename Fetch>
__device__ __forceinline__ void du_block(const Args<T>& a, const Ctx& q,
                                         uint8_t* smem, Fetch& fetch) {
  using L = Tile<T>;
  using M = TileSmem<T>;
  constexpr int TI = L::TI;
  const T* fN = reinterpret_cast<const T*>(smem + M::FN);
  const T* fP = reinterpret_cast<const T*>(smem + M::FP);
  const float2* fcs = reinterpret_cast<const float2*>(smem + M::FCS);
  const float* fdt = reinterpret_cast<const float*>(smem + M::FDT);
  double* red = reinterpret_cast<double*>(smem + M::RED);
  const int g = q.g, t = q.t, r0 = q.r0, kh = q.kh;

  float acc[8][4];
  zero(acc);
  double ssum[2] = {0.0, 0.0};     // s over the streamed rows, per key
  stream_begin<M::ST>(q.ft, fetch);
  for (int ts = q.ft; ts < q.ntiles; ++ts) {
    const int s = stream_in<M::ST>(ts, q.ft, q.ntiles, fetch);
    const T* tN = reinterpret_cast<const T*>(smem + M::SN) + s * TR * L::LDN;
    const T* tP = reinterpret_cast<const T*>(smem + M::SP) + s * TR * L::LDP;
    const float2* tcs = reinterpret_cast<const float2*>(smem + M::SCS) +
                        s * TR;
    float cb[4][4], du[4][4];
    zero(cb);
    zero(du);
#pragma unroll
    for (int ks = 0; ks < NP / 8; ++ks) {
      uint32_t ah[4], al[4], bh[4][2], bl[4][2];
      frag_rows<TI>(fN + (r0 + g) * L::LDN + 8 * ks + t, L::LDN, ah, al);
      frag_cols<TI, 4>(tN + (kh + g) * L::LDN + 8 * ks + t, L::LDN, bh, bl);
      mma_terms<TI, TI, 4>(cb, ah, al, bh, bl);
    }
#pragma unroll
    for (int ks = 0; ks < PP / 8; ++ks) {
      uint32_t ah[4], al[4], bh[4][2], bl[4][2];
      frag_rows<TI>(fP + (r0 + g) * L::LDP + 8 * ks + t, L::LDP, ah, al);
      frag_cols<TI, 4>(tP + (kh + g) * L::LDP + 8 * ks + t, L::LDP, bh, bl);
      mma_terms<TI, TI, 4>(du, ah, al, bh, bl);
    }
    // W^T = cb L^T and s^T = W^T dt_j (dy . x)^T, with L an exact 0 where
    // j > i or a position lies past the chunk.
    // Each streamed row's sum over the 64 keys: its two keys here, the
    // eight lanes that share t, then the four warps of rows through shared
    // memory.
    const int t0 = ts * TR, nt = min(TR, q.cl - t0);
#pragma unroll
    for (int n4 = 0; n4 < 4; ++n4) {
      double rows[2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = r0 + g + 8 * (e >> 1);
        const int i = kh + 8 * n4 + 2 * t + (e & 1);
        const bool valid = j < q.nf && i < nt && q.f0 + j <= t0 + i;
        const float l = valid ? expf(cs_diff(tcs[i], fcs[j])) : 0.f;
        const float w = cb[n4][e] * l;
        const float sv = w * (du[n4][e] * fdt[j]);
        cb[n4][e] = w;
        ssum[e >> 1] += static_cast<double>(sv);
        if (e < 2)
          rows[e] = static_cast<double>(sv);
        else
          rows[e & 1] += static_cast<double>(sv);
      }
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        double v = rows[cc];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[q.rg * TR + kh + 8 * n4 + 2 * t + cc] = v;
      }
    }
    __syncthreads();
    if (q.tid < nt)
      a.part[q.pos(a.S, t0 - q.f0 + q.tid) * a.npart + NPART0 + q.ft] =
          ((red[q.tid] + red[TR + q.tid]) + red[2 * TR + q.tid]) +
          red[3 * TR + q.tid];
    // du_j += W^T dy_i: score tile n4 is the A fragment of positions
    // kh + 8 n4 + .. with k slots t, t + 4 on the columns 2t, 2t + 1.
#pragma unroll
    for (int n4 = 0; n4 < 4; ++n4) {
      uint32_t ah[4], al[4];
      frag_acc_rn(cb[n4], ah, al);
#pragma unroll
      for (int q4 = 0; q4 < 8; q4 += 4) {
        uint32_t bh[4][2], bl[4][2];
        frag_pairs<TI, 4>(tP + (kh + 8 * n4 + 2 * t) * L::LDP + 8 * q4 + g,
                          L::LDP, bh, bl);
        mma_terms<2, TI, 4>(acc + q4, ah, al, bh, bl);
      }
    }
    stream_out<M::ST>();
  }

  float own[4][4];                 // du of columns 32 half + ..
  exchange(acc, own, reinterpret_cast<float*>(smem + M::SN), q);
  const float2 cs_last =
      a.cs[((long long)q.b * a.H + q.h) * a.S + q.c0 + q.cl - 1];
  float ej[2], wsum[2] = {0.f, 0.f};
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int j = r0 + g + 8 * e2;
    ej[e2] = j < q.nf ? expf(cs_diff(cs_last, fcs[j])) : 0.f;
  }
  const int pc = 32 * q.half;      // this half's first column
  if (q.c < a.nc - 1 || a.has_dstate) {
    // du_j += e_j G B_j, and u_j . (G B_j) for w_j.
    float* sG = reinterpret_cast<float*>(smem + M::SN);
    load_state(sG, LDG_COLS, a.g + (((long long)q.b * a.nc + q.c) * a.H +
                                     q.h) * a.P * a.N, a.P, a.N);
    float gb[4][4];
    zero(gb);
#pragma unroll 2
    for (int ks = 0; ks < NP / 8; ++ks) {
      uint32_t ah[4], al[4], bh[4][2], bl[4][2];
      frag_rows<TI>(fN + (r0 + g) * L::LDN + 8 * ks + t, L::LDN, ah, al);
      frag_cols<2, 4>(sG + (pc + g) * LDG_COLS + 8 * ks + t, LDG_COLS, bh,
                      bl);
      mma_terms<TI, 2, 4>(gb, ah, al, bh, bl);
    }
#pragma unroll
    for (int n4 = 0; n4 < 4; ++n4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = r0 + g + 8 * (e >> 1);
        const int p = pc + 8 * n4 + 2 * t + (e & 1);
        own[n4][e] = fmaf(ej[e >> 1], gb[n4][e], own[n4][e]);
        wsum[e >> 1] =
            fmaf(to_f32(fP[j * L::LDP + p]), gb[n4][e], wsum[e >> 1]);
      }
  }
  // dx_j = dt_j du_j, and x_j . du_j for ddt.
  T* dxb = a.dx + (((long long)q.b * a.S + q.c0 + q.f0) * a.H + q.h) * a.P;
  float xdu[2] = {0.f, 0.f};
#pragma unroll
  for (int n4 = 0; n4 < 4; ++n4)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = r0 + g + 8 * (e >> 1);
      const int p = pc + 8 * n4 + 2 * t + (e & 1);
      if (j < q.nf && p < a.P) {
        xdu[e >> 1] = fmaf(to_f32(fP[j * L::LDP + p]), own[n4][e], xdu[e >> 1]);
        store(dxb + (long long)j * a.H * a.P + p, fdt[j] * own[n4][e]);
      }
    }
  // Per key: the four lanes of a row, then the second half's sums meet the
  // first's in shared memory (the rows' partials are read).
  double sk[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    sk[e2] = quad_sum(ssum[e2]);
    wsum[e2] = quad_sum(wsum[e2]);
    xdu[e2] = quad_sum(xdu[e2]);
  }
  if (q.half == 1 && t == 0)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int j = r0 + g + 8 * e2;
      red[3 * j] = sk[e2];
      red[3 * j + 1] = wsum[e2];
      red[3 * j + 2] = xdu[e2];
    }
  __syncthreads();
  if (q.half == 0 && t == 0)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int j = r0 + g + 8 * e2;
      if (j < q.nf) {
        const float w = ej[e2] * fdt[j] *
                        (wsum[e2] + static_cast<float>(red[3 * j + 1]));
        double* pp = a.part + q.pos(a.S, j) * a.npart;
        pp[1] = (sk[e2] + red[3 * j]) + w;     // column sum of s and w_j
        pp[2] = w;                             // w_j
        pp[3] = xdu[e2] + static_cast<float>(red[3 * j + 2]);
      }
    }
}

// dB blocks: fixed key tile ft (x_j), streamed row tiles [ft, ntiles) (C_i,
// dy_i).  M^T = dt_j (x_j dy_i^T) L^T; dB_j += M^T C_i, then e_j dt_j G^T
// x_j; the head's share of dB to dBh.
template <typename T, typename Fetch>
__device__ __forceinline__ void db_block(const Args<T>& a, const Ctx& q,
                                         uint8_t* smem, Fetch& fetch) {
  using L = Tile<T>;
  using M = TileSmem<T>;
  constexpr int TI = L::TI;
  const T* fP = reinterpret_cast<const T*>(smem + M::FP);
  const float2* fcs = reinterpret_cast<const float2*>(smem + M::FCS);
  const float* fdt = reinterpret_cast<const float*>(smem + M::FDT);
  float* sM = reinterpret_cast<float*>(smem + M::FN);
  const int g = q.g, t = q.t, r0 = q.r0, kh = q.kh;

  float own[8][4];                 // dB of columns 64 half + ..
  zero(own);
  stream_begin<M::ST>(q.ft, fetch);
  for (int ts = q.ft; ts < q.ntiles; ++ts) {
    const int s = stream_in<M::ST>(ts, q.ft, q.ntiles, fetch);
    const T* tN = reinterpret_cast<const T*>(smem + M::SN) + s * TR * L::LDN;
    const T* tP = reinterpret_cast<const T*>(smem + M::SP) + s * TR * L::LDP;
    const float2* tcs = reinterpret_cast<const float2*>(smem + M::SCS) +
                        s * TR;
    float du[4][4];
    zero(du);
#pragma unroll
    for (int ks = 0; ks < PP / 8; ++ks) {
      uint32_t ah[4], al[4], bh[4][2], bl[4][2];
      frag_rows<TI>(fP + (r0 + g) * L::LDP + 8 * ks + t, L::LDP, ah, al);
      frag_cols<TI, 4>(tP + (kh + g) * L::LDP + 8 * ks + t, L::LDP, bh, bl);
      mma_terms<TI, TI, 4>(du, ah, al, bh, bl);
    }
    const int t0 = ts * TR, nt = min(TR, q.cl - t0);
#pragma unroll
    for (int n4 = 0; n4 < 4; ++n4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = r0 + g + 8 * (e >> 1);
        const int i = kh + 8 * n4 + 2 * t + (e & 1);
        const bool valid = j < q.nf && i < nt && q.f0 + j <= t0 + i;
        const float l = valid ? expf(cs_diff(tcs[i], fcs[j])) : 0.f;
        du[n4][e] = (du[n4][e] * fdt[j]) * l;
      }
    m_product<TI>(du, sM, tN, L::LDN, own, q);
    stream_out<M::ST>();
  }

  __syncthreads();                 // the stages are consumed
  const int nc0 = 64 * q.half;
  if (q.c < a.nc - 1 || a.has_dstate) {
    // dB_j += e_j dt_j G^T x_j.
    float* sG = reinterpret_cast<float*>(smem + M::SN);
    load_state(sG, LDG_ROWS, a.g + (((long long)q.b * a.nc + q.c) * a.H +
                                     q.h) * a.P * a.N, a.P, a.N);
    // In two passes of four column tiles.
#pragma unroll
    for (int q4 = 0; q4 < 8; q4 += 4) {
      float xg[4][4];
      zero(xg);
#pragma unroll 2
      for (int ks = 0; ks < PP / 8; ++ks) {
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        frag_rows<TI>(fP + (r0 + g) * L::LDP + 8 * ks + t, L::LDP, ah, al);
        frag_krows<2, 4>(sG + (8 * ks + t) * LDG_ROWS + nc0 + 8 * q4 + g,
                         LDG_ROWS, bh, bl);
        mma_terms<TI, 2, 4>(xg, ah, al, bh, bl);
      }
      const float2 cs_last =
          a.cs[((long long)q.b * a.H + q.h) * a.S + q.c0 + q.cl - 1];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int j = r0 + g + 8 * e2;
        const float ed =
            j < q.nf ? expf(cs_diff(cs_last, fcs[j])) * fdt[j] : 0.f;
#pragma unroll
        for (int n4 = 0; n4 < 4; ++n4)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1)
            own[q4 + n4][2 * e2 + e1] =
                fmaf(ed, xg[n4][2 * e2 + e1], own[q4 + n4][2 * e2 + e1]);
      }
    }
  }
  float* dN = a.dBh + q.pos(a.S, 0) * a.N;
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int j = r0 + g + 8 * e2;
      const int n = nc0 + 8 * n8 + 2 * t;
      if (j < q.nf && n < a.N)
        *reinterpret_cast<float2*>(dN + (long long)j * a.N + n) =
            make_float2(own[n8][2 * e2], own[n8][2 * e2 + 1]);
    }
}

// Row blocks: fixed row tile ft (dy_i), streamed key tiles [0, ft] (B_j,
// x_j).  M = (dy_i x_j^T) dt_j L;
// dC_i += M B_j, then e_i h-^T dy_i; the head's share of dC to dCh and
// r_i.
template <typename T, typename Fetch>
__device__ __forceinline__ void row_block(const Args<T>& a, const Ctx& q,
                                          uint8_t* smem, Fetch& fetch) {
  using L = Tile<T>;
  using M = TileSmem<T>;
  constexpr int TI = L::TI;
  T* fN = reinterpret_cast<T*>(smem + M::FN);
  const T* fP = reinterpret_cast<const T*>(smem + M::FP);
  const float2* fcs = reinterpret_cast<const float2*>(smem + M::FCS);
  double* red = reinterpret_cast<double*>(smem + M::RED);
  float* sM = reinterpret_cast<float*>(smem + M::FN);
  const int g = q.g, t = q.t, r0 = q.r0, kh = q.kh;

  float own[8][4];                 // dC of columns 64 half + ..
  zero(own);
  stream_begin<M::ST>(0, fetch);
  for (int ts = 0; ts <= q.ft; ++ts) {
    const int s = stream_in<M::ST>(ts, 0, q.ft + 1, fetch);
    const T* tN = reinterpret_cast<const T*>(smem + M::SN) + s * TR * L::LDN;
    const T* tP = reinterpret_cast<const T*>(smem + M::SP) + s * TR * L::LDP;
    const float2* tcs = reinterpret_cast<const float2*>(smem + M::SCS) +
                        s * TR;
    const float* tdt = reinterpret_cast<const float*>(smem + M::SDT) + s * TR;
    float du[4][4];
    zero(du);
#pragma unroll
    for (int ks = 0; ks < PP / 8; ++ks) {
      uint32_t ah[4], al[4], bh[4][2], bl[4][2];
      frag_rows<TI>(fP + (r0 + g) * L::LDP + 8 * ks + t, L::LDP, ah, al);
      frag_cols<TI, 4>(tP + (kh + g) * L::LDP + 8 * ks + t, L::LDP, bh, bl);
      mma_terms<TI, TI, 4>(du, ah, al, bh, bl);
    }
    const int t0 = ts * TR, nt = min(TR, q.cl - t0);
#pragma unroll
    for (int n4 = 0; n4 < 4; ++n4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + g + 8 * (e >> 1);
        const int j = kh + 8 * n4 + 2 * t + (e & 1);
        const bool valid = i < q.nf && j < nt && t0 + j <= q.f0 + i;
        const float l = valid ? expf(cs_diff(fcs[i], tcs[j])) : 0.f;
        du[n4][e] = (du[n4][e] * tdt[j]) * l;
      }
    m_product<TI>(du, sM, tN, L::LDN, own, q);
    stream_out<M::ST>();
  }

  __syncthreads();                 // the stages and M are consumed
  const int nc0 = 64 * q.half;
  float ei[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int i = r0 + g + 8 * e2;
    const float2 v = fcs[i];
    ei[e2] = i < q.nf ? expf(v.x + v.y) : 0.f;
  }
  if (q.c > 0) {
    // dC_i += e_i h-^T dy_i, and C_i . (h-^T dy_i) for r_i.
    const Strides& st = a.st;
    load_rows<NT_TILES>(fN, L::LDN,
                        a.Cm + q.b * st.csb + (q.c0 + q.f0) * st.css, st.css,
                        TR, q.nf, a.N);
    zero_columns(fN, L::LDN, TR, a.N, NP);
    float* sH = reinterpret_cast<float*>(smem + M::SN);
    load_state(sH, LDG_ROWS, a.states + (((long long)q.b * a.nc + q.c) *
                                         a.H + q.h) * a.P * a.N, a.P, a.N);
    // In two passes of four column tiles.
#pragma unroll
    for (int q4 = 0; q4 < 8; q4 += 4) {
      float hd[4][4];
      zero(hd);
#pragma unroll 2
      for (int ks = 0; ks < PP / 8; ++ks) {
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        frag_rows<TI>(fP + (r0 + g) * L::LDP + 8 * ks + t, L::LDP, ah, al);
        frag_krows<2, 4>(sH + (8 * ks + t) * LDG_ROWS + nc0 + 8 * q4 + g,
                         LDG_ROWS, bh, bl);
        mma_terms<TI, 2, 4>(hd, ah, al, bh, bl);
      }
#pragma unroll
      for (int n4 = 0; n4 < 4; ++n4)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + g + 8 * (e >> 1);
          const int n = nc0 + 8 * (q4 + n4) + 2 * t + (e & 1);
          own[q4 + n4][e] = fmaf(ei[e >> 1], hd[n4][e], own[q4 + n4][e]);
          rsum[e >> 1] = fmaf(to_f32(fN[i * L::LDN + n]), hd[n4][e],
                              rsum[e >> 1]);
        }
    }
  }
  float* dN = a.dCh + q.pos(a.S, 0) * a.N;
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int i = r0 + g + 8 * e2;
      const int n = nc0 + 8 * n8 + 2 * t;
      if (i < q.nf && n < a.N)
        *reinterpret_cast<float2*>(dN + (long long)i * a.N + n) =
            make_float2(own[n8][2 * e2], own[n8][2 * e2 + 1]);
    }
  // r_i: the four lanes of a row, then the two halves in order.
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) rsum[e2] = quad_sum(rsum[e2]);
  if (q.half == 1 && t == 0)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) red[r0 + g + 8 * e2] = rsum[e2];
  __syncthreads();
  if (q.half == 0 && t == 0)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int i = r0 + g + 8 * e2;
      if (i < q.nf)
        a.part[q.pos(a.S, i) * a.npart] =
            ei[e2] * (rsum[e2] + static_cast<float>(red[i]));   // r_i
    }
}

// Launch 3: blocks [0, n) are du blocks, [n, 2n) dB blocks and [2n, 3n)
// row blocks, n = tiles * nc; within a kind the blocks with the most
// streamed tiles come first.
template <typename T>
__global__ void __launch_bounds__(NT_TILES, 2)   // two blocks fill an SM
ssd_bwd_tiles(const Args<T> a) {
  using L = Tile<T>;
  using M = TileSmem<T>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int per = a.tiles * a.nc;
  const int kind = blockIdx.x / per, rem = blockIdx.x - kind * per;
  Ctx q;
  q.c = rem % a.nc;
  const int k = rem / a.nc;
  q.h = blockIdx.y;
  q.b = blockIdx.z;
  q.c0 = q.c * a.chunk;
  q.cl = min(a.chunk, a.S - q.c0);
  q.ft = kind < 2 ? k : a.tiles - 1 - k;
  q.f0 = q.ft * TR;
  if (q.f0 >= q.cl) return;                     // past a short last chunk
  q.nf = min(TR, q.cl - q.f0);
  q.ntiles = (q.cl + TR - 1) / TR;
  q.bh = q.b * a.H + q.h;
  q.tid = threadIdx.x;
  const int warp = q.tid >> 5, lane = q.tid & 31;
  q.g = lane >> 2;
  q.t = lane & 3;
  q.rg = warp & 3;
  q.r0 = 16 * q.rg;
  q.half = warp >> 2;
  q.kh = 32 * q.half;

  const Strides& st = a.st;
  T* fN = reinterpret_cast<T*>(smem + M::FN);
  T* fP = reinterpret_cast<T*>(smem + M::FP);

  // Padded columns are zero in every tile; the copies never write them.
  if (kind == 0) zero_columns(fN, L::LDN, TR, a.N, NP);
  zero_columns(fP, L::LDP, TR, a.P, PP);
  for (int s = 0; s < M::ST; ++s) {
    zero_columns(reinterpret_cast<T*>(smem + M::SN) + s * TR * L::LDN,
                 L::LDN, TR, a.N, NP);
    zero_columns(reinterpret_cast<T*>(smem + M::SP) + s * TR * L::LDP,
                 L::LDP, TR, a.P, PP);
  }
  // The fixed tile: du blocks B_j and x_j, dB blocks x_j, row blocks dy_i;
  // its cs and dt.
  const long long f0 = q.c0 + q.f0;   // its first position
  if (kind == 0)
    load_rows<NT_TILES>(fN, L::LDN, a.Bm + q.b * st.bsb + f0 * st.bss,
                        st.bss, TR, q.nf, a.N);
  if (kind < 2)
    load_rows<NT_TILES>(fP, L::LDP,
                        a.x + q.b * st.xsb + q.h * st.xsh + f0 * st.xss,
                        st.xss, TR, q.nf, a.P);
  else
    load_rows<NT_TILES>(fP, L::LDP,
                        a.dy + q.b * st.ysb + q.h * st.ysh + f0 * st.yss,
                        st.yss, TR, q.nf, a.P);
  if (q.tid < TR) {
    const bool ok = q.tid < q.nf;
    const long long pos = f0 + q.tid;
    reinterpret_cast<float2*>(smem + M::FCS)[q.tid] =
        ok ? a.cs[((long long)q.b * a.H + q.h) * a.S + pos]
           : make_float2(0.f, 0.f);
    reinterpret_cast<float*>(smem + M::FDT)[q.tid] =
        ok ? to_f32(a.dt[q.b * st.dsb + q.h * st.dsh + pos * st.dss]) : 0.f;
  }

  // Streamed tile ts into stage s: key blocks' C_i and dy_i, row blocks'
  // B_j and x_j; cs and dt stored.  The sources are found anew from the
  // arguments (held in the constant bank) on each call.
  auto fetch = [&](int ts, int s) {
    const long long p0 = q.c0 + ts * TR;
    const int nt = min(TR, q.cl - ts * TR);
    T* dN = reinterpret_cast<T*>(smem + M::SN) + s * TR * L::LDN;
    T* dP = reinterpret_cast<T*>(smem + M::SP) + s * TR * L::LDP;
    if (kind < 2) {
      load_rows<NT_TILES>(dN, L::LDN, a.Cm + q.b * st.csb + p0 * st.css,
                          st.css, TR, nt, a.N);
      load_rows<NT_TILES>(dP, L::LDP,
                          a.dy + q.b * st.ysb + q.h * st.ysh + p0 * st.yss,
                          st.yss, TR, nt, a.P);
    } else {
      load_rows<NT_TILES>(dN, L::LDN, a.Bm + q.b * st.bsb + p0 * st.bss,
                          st.bss, TR, nt, a.N);
      load_rows<NT_TILES>(dP, L::LDP,
                          a.x + q.b * st.xsb + q.h * st.xsh + p0 * st.xss,
                          st.xss, TR, nt, a.P);
    }
    if (q.tid < TR) {
      const bool ok = q.tid < nt;
      const long long pos = p0 + q.tid;
      reinterpret_cast<float2*>(smem + M::SCS)[s * TR + q.tid] =
          ok ? a.cs[((long long)q.b * a.H + q.h) * a.S + pos]
             : make_float2(0.f, 0.f);
      reinterpret_cast<float*>(smem + M::SDT)[s * TR + q.tid] =
          ok ? to_f32(a.dt[q.b * st.dsb + q.h * st.dsh + pos * st.dss])
             : 0.f;
    }
  };
  if (kind == 0)
    du_block<T>(a, q, smem, fetch);
  else if (kind == 1)
    db_block<T>(a, q, smem, fetch);
  else
    row_block<T>(a, q, smem, fetch);
}

// Launch 4: one block per (chunk, head, batch).  dcs_t = the rows' sums of
// s over the key tiles at or before t (in tile order) + r_t - (the column
// sum of s and w_t) (+ sum_j w_j + exp(cs_last) <h-, G> at the last
// position), da its reverse cumulative sum, ddt_t = x_t . du_t + A da_t,
// and the chunk's share of dA, sum_t dt_t da_t; all in fp64.
template <typename T>
__global__ void __launch_bounds__(NT_FINISH)
ssd_bwd_chunk_finish(const T* __restrict__ dt, const T* __restrict__ A,
                     const float2* __restrict__ cs,
                     const float* __restrict__ states,
                     const float* __restrict__ g,
                     const double* __restrict__ part, T* __restrict__ ddt,
                     double* __restrict__ da_part, int S, int H, int PN,
                     int chunk, int nc, int npart, Strides st) {
  __shared__ double red[NT_FINISH / 32];
  __shared__ double wsum[NT_FINISH / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * chunk, cl = min(chunk, S - c0);
  const long long soff = (((long long)b * nc + c) * H + h) * PN;
  const double* pb = part + (((long long)b * H + h) * S + c0) * npart;
  const T* db = dt + b * st.dsb + h * st.dsh + c0 * st.dss;
  const double a = to_f32(A[h]);

  // <h-, G> and sum_j w_j.
  double hg = 0.0;
  for (int e = tid; e < PN; e += NT_FINISH)
    hg += static_cast<double>(states[soff + e]) * g[soff + e];
  hg = block_sum(hg, red);
  double w = 0.0;
  for (int t = tid; t < cl; t += NT_FINISH) w += pb[t * npart + 2];
  w = block_sum(w, red);
  const float2 last = cs[((long long)b * H + h) * S + c0 + cl - 1];
  const double at_last = w + static_cast<double>(expf(last.x + last.y)) * hg;

  // The reverse cumulative sum over segments of NT_FINISH positions from
  // the end: thread k takes position s1 - 1 - k, so a forward scan over
  // threads sums the positions at or after it.
  double carry = 0.0, dA_sum = 0.0;
  for (int s1 = cl; s1 > 0; s1 -= NT_FINISH) {
    const int t = s1 - 1 - tid;
    double v = 0.0;
    if (t >= 0) {
      const double* pt = pb + (long long)t * npart;
      double rows = 0.0;
      for (int k = 0; k <= t / TR; ++k) rows += pt[NPART0 + k];
      v = (rows + pt[0]) - pt[1];
      if (t == cl - 1) v += at_last;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    double before = carry, total = carry;
    for (int k = 0; k < NT_FINISH / 32; ++k) {
      const double u = wsum[k];
      if (k < warp) before += u;
      total += u;
    }
    if (t >= 0) {
      const double da = v + before;
      const double dtv = to_f32(db[t * st.dss]);
      store(ddt + ((long long)b * S + c0 + t) * H + h,
            static_cast<float>(pb[(long long)t * npart + 3] + a * da));
      dA_sum += dtv * da;
    }
    carry = total;
    __syncthreads();  // wsum is read before the next segment writes it
  }
  dA_sum = block_sum(dA_sum, red);
  if (tid == 0) da_part[((long long)b * nc + c) * H + h] = dA_sum;
}

// Launch 5: dB and dC summed over heads in head order, one thread per
// element of [b, S, N]; the first H threads also sum dA over (batch,
// chunk) in order.
template <typename T>
__global__ void __launch_bounds__(NT_FINISH)
ssd_bwd_sums(const float* __restrict__ dBh, const float* __restrict__ dCh,
             const double* __restrict__ da_part, T* __restrict__ dB,
             T* __restrict__ dC, T* __restrict__ dA, int nb, int S, int H,
             int N, int nc) {
  const long long e = (long long)blockIdx.x * NT_FINISH + threadIdx.x;
  const long long SN = (long long)S * N;
  if (e < nb * SN) {
    const long long bb = e / SN, rest = e - bb * SN;
    const float* pb = dBh + bb * H * SN + rest;
    const float* pc = dCh + bb * H * SN + rest;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += pb[h * SN];
      sc += pc[h * SN];
    }
    store(dB + e, sb);
    store(dC + e, sc);
  }
  if (e < H) {
    double s = 0.0;
    for (int k = 0; k < nb * nc; ++k) s += da_part[(long long)k * H + e];
    store(dA + e, static_cast<float>(s));
  }
}

// Dynamic shared memory of launch 1 (which 0) or 3 (which 2), and the
// kernel it is for.
template <typename T>
int smem_bytes(int which) {
  return which == 0 ? dstates_smem<T>() : TileSmem<T>::BYTES;
}

template <typename T>
const void* kernel_of(int which) {
  return which == 0 ? reinterpret_cast<const void*>(ssd_bwd_chunk_dstates<T>)
                    : reinterpret_cast<const void*>(ssd_bwd_tiles<T>);
}

// Above 48 KB a kernel must opt in to dynamic shared memory.
template <typename T>
cudaError_t opt_in(int which) {
  return cudaFuncSetAttribute(kernel_of<T>(which),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<T>(which));
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* dy, const float2* cs,
           const float* states, const float* dstate, float* g, double* part,
           float* dBh, float* dCh, double* da_part, void* dx, void* ddt,
           void* dA, void* dB, void* dC, int b, int S, int H, int P, int N,
           int chunk, const long long* s, cudaStream_t stream) {
  constexpr int VE = Tile<T>::VE;
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0 || P > PP || P % VE != 0 ||
      N <= 0 || N > NP || N % VE != 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides st = {s[0], s[1], s[2], s[3], s[4], s[5], s[6],
                      s[7], s[8], s[9], s[10], s[11], s[12]};
  const T* tdt = static_cast<const T*>(dt);
  const T* tC = static_cast<const T*>(C);
  const T* tdy = static_cast<const T*>(dy);
  const int nc = (S + chunk - 1) / chunk;
  const int tiles = ((chunk < S ? chunk : S) + TR - 1) / TR;
  cudaError_t e = opt_in<T>(0);
  if (e == cudaSuccess) e = opt_in<T>(2);
  if (e != cudaSuccess) return (int)e;
  if (nc > 1) {
    ssd_bwd_chunk_dstates<T><<<dim3(nc - 1, H, b), NT_DSTATES,
                               smem_bytes<T>(0), stream>>>(
        tC, tdy, cs, g, S, H, P, N, chunk, nc, st);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ssd_bwd_state_pass<<<dim3((P * N + NT_PASS - 1) / NT_PASS, H, b), NT_PASS,
                       0, stream>>>(cs, dstate, g, S, H, P * N, chunk, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.dt = tdt;
  a.Bm = static_cast<const T*>(B);
  a.Cm = tC;
  a.dy = tdy;
  a.cs = cs;
  a.states = states;
  a.g = g;
  a.part = part;
  a.dBh = dBh;
  a.dCh = dCh;
  a.dx = static_cast<T*>(dx);
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.chunk = chunk;
  a.nc = nc;
  a.tiles = tiles;
  a.npart = NPART0 + tiles;
  a.has_dstate = dstate != nullptr;
  a.st = st;
  ssd_bwd_tiles<T><<<dim3(3 * tiles * nc, H, b), NT_TILES, smem_bytes<T>(2),
                     stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk_finish<T><<<dim3(nc, H, b), NT_FINISH, 0, stream>>>(
      tdt, static_cast<const T*>(A), cs, states, g, part,
      static_cast<T*>(ddt), da_part, S, H, P * N, chunk, nc, a.npart, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long elems = (long long)b * S * N;
  const long long n5 = elems > H ? elems : H;
  ssd_bwd_sums<T><<<dim3((unsigned)((n5 + NT_FINISH - 1) / NT_FINISH)),
                    NT_FINISH, 0, stream>>>(
      dBh, dCh, da_part, static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<T*>(dA), b, S, H, N, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int which) {
  cudaError_t e = opt_in<T>(which);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel_of<T>(which), which == 0 ? NT_DSTATES : NT_TILES,
        smem_bytes<T>(which));
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" {

// strides: 13 element strides: x (batch, seq, head), dt (batch, seq, head),
// B (batch, seq), C (batch, seq), dy (batch, seq, head).  cs and states are
// the forward's scratch (odin_ssd_scan_fwd: cs the fp32 (hi, lo) pairs of
// the cumulative dA, b * H * S of them; states b * ceil(S / chunk) * H * P *
// N fp32, the state entering each chunk).  dstate: the fp32 gradient of
// the final state, contiguous [b, H, P, N], or null for zero.  Scratch: g
// shaped as states (fp32), part b * H * S * (4 + tiles) doubles (tiles =
// ceil(min(chunk, S) / 64)), dBh and dCh b * H * S * N fp32 each, da_part
// b * ceil(S / chunk) * H doubles.  Gradients, contiguous, in the inputs'
// dtype: dx [b, S, H, P], ddt [b, S, H], dA [H], dB and dC [b, S, N].
// dtype: 0 = float32, 1 = bfloat16.  Returns the CUDA error code of the
// launches (0 on success).
int odin_ssd_scan_bwd(const void* x, const void* dt, const void* A,
                      const void* B, const void* C, const void* dy,
                      const void* cs, const void* states, const void* dstate,
                      void* g, void* part, void* dBh, void* dCh,
                      void* da_part, void* dx, void* ddt, void* dA, void* dB,
                      void* dC, int b, int S, int H, int P, int N, int chunk,
                      const long long* strides, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* fcs = static_cast<const float2*>(cs);
  const float* fst = static_cast<const float*>(states);
  const float* fds = static_cast<const float*>(dstate);
  float* fg = static_cast<float*>(g);
  double* fpart = static_cast<double*>(part);
  float* fdb = static_cast<float*>(dBh);
  float* fdc = static_cast<float*>(dCh);
  double* fda = static_cast<double*>(da_part);
  if (dtype == 0)
    return launch<float>(x, dt, A, B, C, dy, fcs, fst, fds, fg, fpart, fdb,
                         fdc, fda, dx, ddt, dA, dB, dC, b, S, H, P, N, chunk,
                         strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, dy, fcs, fst, fds, fg, fpart,
                                 fdb, fdc, fda, dx, ddt, dA, dB, dC, b, S, H,
                                 P, N, chunk, strides, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a block of launch 1 (which 0) or 3 (which 2).
int odin_ssd_scan_bwd_smem_bytes(int which, int dtype) {
  return dtype == 0 ? smem_bytes<float>(which)
                    : smem_bytes<__nv_bfloat16>(which);
}

// Blocks of launch 1 (which 0) or 3 (which 2) that fit one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a CUDA error.
int odin_ssd_scan_bwd_blocks_per_sm(int which, int dtype) {
  return dtype == 0 ? blocks_per_sm<float>(which)
                    : blocks_per_sm<__nv_bfloat16>(which);
}

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
