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
// 3. ssd_bwd_tiles: two kinds of block, as K1's backward
//    (flash_attention_bwd.cu) has, each holding a fixed tile of 64
//    positions and streaming the chunk's other tiles past it:
//      key blocks: fixed B_j, u_j; streamed C_i, dy_i over the row tiles at
//        or after it; du (to dx and the x . du part of ddt), the head's
//        share of dB, the column sums of s and w_j;
//      row blocks: fixed C_i, dy_i; streamed B_j, u_j over the key tiles
//        at or before it; the head's share of dC, the row sums of s and r_i.
//    Both recompute the scores C_i . B_j and dy_i . u_j rather than sum an
//    output across blocks.  Each writes per-position partials (fp64) and
//    its head's share of dB or dC (fp32) to scratch; no block adds into
//    another's output.  The key blocks (two output products) go first.
// 4. ssd_bwd_chunk_finish, one block per (chunk, head, batch): dcs, its
//    reverse cumulative sum da, ddt, and the chunk's share of dA.
// 5. ssd_bwd_sums: dB and dC summed over heads in head order, dA over
//    (batch, chunk) in order.  No float atomics: two calls give the same
//    bits.
//
// What bounds it on an H100: operations.  At mamba2-370m's training shape
// (b 8, S 256, H 32, P 64, N 128, one chunk, fp32) the five products of
// pairs (C.B, dy.u, du, dB, dC) need about 6.5 GFLOP against about 55 MB
// of inputs and gradients, above the fp32 CUDA cores' ridge.  This first
// design keeps every product on the CUDA cores in fp32 FMA for both input
// dtypes (bf16 inputs are widened as they are loaded; each gradient is
// rounded to its input's dtype once, at the end): each thread of a block
// holds a 4 x 4 tile of the 64 x 64 scores and a 4 x 8 tile of a 64 x 128
// output, with operands in shared memory rows padded to an odd stride (no
// bank conflicts).  Tensor cores are work for a later design.
//
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W): 1.35 ms
// at the training shape in fp32, 34x its bound (3xTF32 products at the
// tensor-core peak), 96% of it the tile launch: its blocks hold 142 KB of
// shared memory and 168 registers a thread, so one fits an SM.
//
// Precision: dcs is a sum of terms of both signs that cancel (the s terms
// of a pair enter two positions with opposite signs), so the row and column
// sums of s, dcs, its reverse cumulative sum and the dA partials are taken
// in fp64, as the forward sums cs in fp64.  The decays exp(cs_i - cs_j)
// come from the forward's fp32 (hi, lo) pairs of cs; pairs j > i are an
// exact 0, never exp(+x).  A key block and a row block compute the same
// s_ij bit for bit (the same FMAs in the same order), so the pairs' terms
// cancel exactly in sum_t dcs_t.
//
// Layout: x [b, S, H, P], dt [b, S, H], B and C [b, S, N] and dy [b, S, H,
// P] are read through element strides (last dimension's stride 1), so the
// model's views into its conv output are read in place.  The gradients are
// written contiguous: dx [b, S, H, P], ddt [b, S, H], dA [H], dB and dC
// [b, S, N], each in the inputs' dtype.  P <= 64 and N <= 128.  Any S and
// any chunk; a short last chunk is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 64;          // positions of a tile
constexpr int PP = 64;          // P, at most
constexpr int NP = 128;         // N, at most
constexpr int LDN = NP + 1;     // row strides of fp32 tiles in shared memory
constexpr int LDP = PP + 1;     // (odd: a column read hits 16 banks)
constexpr int NT = 256;         // threads of every block
constexpr int NPART = 4;        // fp64 partials per (batch, head, position)

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

struct Strides {
  long long xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css, ysb, yss, ysh;
};

// Rows [0, TR) of width `width` from global rows `src + r * rs` into a
// shared fp32 tile with row stride `ld`, each row times `scale[r * ss]`
// where `scale` is given; rows at or past `valid` are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long rs, int valid, int width,
                                          const T* scale = nullptr,
                                          long long ss = 0) {
  for (int e = threadIdx.x; e < TR * width; e += NT) {
    const int r = e / width, col = e - r * width;
    float v = 0.f;
    if (r < valid) {
      v = to_f32(src[r * rs + col]);
      if (scale != nullptr) v *= to_f32(scale[r * ss]);
    }
    dst[r * ld + col] = v;
  }
}

// The sum of one double per thread of the block, in a fixed order; every
// thread gets it.  `red` holds NT / 32 doubles of shared memory.
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < NT / 32; ++w) total += red[w];
  return total;
}

// Launch 1: one block per (chunk c >= 1, head, batch).  Thread (ty, tx)
// holds rows p = ty + 16 a and columns n = tx + 16 k of the [P, N] sum.
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_chunk_dstates(const T* __restrict__ Cm, const T* __restrict__ dy,
                      const float2* __restrict__ cs, float* __restrict__ g,
                      int S, int H, int P, int N, int chunk, int nc,
                      Strides st) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* sDy = reinterpret_cast<float*>(smem);   // [TR][LDP], exp(cs_i) dy_i
  float* sC = sDy + TR * LDP;                    // [TR][LDN]
  float* sE = sC + TR * LDN;                     // [TR]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c = blockIdx.x + 1, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * chunk, cl = min(chunk, S - c0);
  const float2* csb = cs + ((long long)b * H + h) * S + c0;
  const T* yb = dy + b * st.ysb + h * st.ysh + c0 * st.yss;
  const T* Cb = Cm + b * st.csb + c0 * st.css;

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[a][k] = 0.f;

  for (int i0 = 0; i0 < cl; i0 += TR) {
    const int ni = min(TR, cl - i0);
    __syncthreads();  // the last tile is consumed
    if (tid < TR) {
      const float2 v = tid < ni ? csb[i0 + tid] : make_float2(0.f, 0.f);
      sE[tid] = tid < ni ? expf(v.x + v.y) : 0.f;
    }
    load_tile(sC, LDN, Cb + i0 * st.css, st.css, ni, N);
    __syncthreads();
    for (int e = tid; e < TR * P; e += NT) {
      const int r = e / P, p = e - r * P;
      sDy[r * LDP + p] =
          r < ni ? to_f32(yb[(i0 + r) * st.yss + p]) * sE[r] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < ni; ++r) {
      float dv[4], cv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = sDy[r * LDP + ty + 16 * a];
#pragma unroll
      for (int k = 0; k < 8; ++k) cv[k] = sC[r * LDN + tx + 16 * k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[a][k] = fmaf(dv[a], cv[k], acc[a][k]);
    }
  }
  float* out = g + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int p = ty + 16 * a, n = tx + 16 * k;
      if (p < P && n < N) out[p * N + n] = acc[a][k];
    }
}

// Launch 2: the reverse recurrence over chunks, one thread per (p, n) of a
// head.  Scratch chunk c holds its own term on entry (c >= 1) and G_c, the
// gradient of the state leaving chunk c, on exit.
__global__ void __launch_bounds__(NT)
ssd_bwd_state_pass(const float2* __restrict__ cs,
                   const float* __restrict__ dstate, float* __restrict__ g,
                   int S, int H, int PN, int chunk, int nc) {
  const int e = blockIdx.x * NT + threadIdx.x;
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

struct TileSmem {
  static constexpr int FN = 0;                          // [TR][LDN] fixed
  static constexpr int FP = FN + TR * LDN * 4;          // [TR][LDP] fixed
  static constexpr int TN = FP + TR * LDP * 4;          // [TR][LDN] streamed
  static constexpr int TP = TN + TR * LDN * 4;          // [TR][LDP] streamed
  static constexpr int M = TP + TR * LDP * 4;           // [TR][LDP] M[t][f]
  static constexpr int W = M + TR * LDP * 4;            // [TR][LDP] W[t][f]
  static constexpr int FCS = W + TR * LDP * 4;          // [TR] float2
  static constexpr int TCS = FCS + TR * 8;              // [TR] float2
  static constexpr int EXTRA = TCS + TR * 8;            // [TR] float
  static constexpr int RED = EXTRA + TR * 4;            // [16][TR] double
  static constexpr int BYTES = RED + 16 * TR * 8;
  // After the streamed tiles, the state (G or h-) [PP][LDN] takes TN.
  static_assert(PP * LDN * 4 <= TP - TN, "room for the state");
};

// Launch 3: blocks [0, nkey) are key blocks, the rest row blocks; nkey =
// tiles * nc.  Key blocks with the most row tiles after them come first,
// then row blocks with the most key tiles before them.  In the score phase
// thread (ty, tx) holds streamed rows t = ty + 16 a and fixed rows f = tx +
// 16 b; in the output phase fixed rows f = ty + 16 a and columns tx + 16 k.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_tiles(const T* __restrict__ x, const T* __restrict__ dt,
              const T* __restrict__ Bm, const T* __restrict__ Cm,
              const T* __restrict__ dy, const float2* __restrict__ cs,
              const float* __restrict__ states, const float* __restrict__ g,
              double* __restrict__ part, float* __restrict__ dBh,
              float* __restrict__ dCh, T* __restrict__ dx, int S, int H,
              int P, int N, int chunk, int nc, int tiles, Strides st) {
  extern __shared__ __align__(16) uint8_t smem[];
  using L = TileSmem;
  float* fN = reinterpret_cast<float*>(smem + L::FN);
  float* fP = reinterpret_cast<float*>(smem + L::FP);
  float* tN = reinterpret_cast<float*>(smem + L::TN);
  float* tP = reinterpret_cast<float*>(smem + L::TP);
  float* sM = reinterpret_cast<float*>(smem + L::M);
  float* sW = reinterpret_cast<float*>(smem + L::W);
  float2* fcs = reinterpret_cast<float2*>(smem + L::FCS);
  float2* tcs = reinterpret_cast<float2*>(smem + L::TCS);
  float* extra = reinterpret_cast<float*>(smem + L::EXTRA);
  double* red = reinterpret_cast<double*>(smem + L::RED);

  const int nkey = tiles * nc;
  const bool key = blockIdx.x < nkey;
  const int rem = key ? blockIdx.x : blockIdx.x - nkey;
  const int c = rem % nc, k = rem / nc;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * chunk, cl = min(chunk, S - c0);
  const int ft = key ? k : tiles - 1 - k;       // the fixed tile
  const int f0 = ft * TR;
  if (f0 >= cl) return;                         // past a short last chunk
  const int nf = min(TR, cl - f0);
  const int ntiles = (cl + TR - 1) / TR;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* xb = x + b * st.xsb + h * st.xsh + c0 * st.xss;
  const T* db = dt + b * st.dsb + h * st.dsh + c0 * st.dss;
  const T* Bb = Bm + b * st.bsb + c0 * st.bss;
  const T* Cb = Cm + b * st.csb + c0 * st.css;
  const T* yb = dy + b * st.ysb + h * st.ysh + c0 * st.yss;
  const float2* csb = cs + ((long long)b * H + h) * S + c0;

  // The fixed tile: key blocks B_j and u_j = dt_j x_j, row blocks C_i and
  // dy_i.
  if (key) {
    load_tile(fN, LDN, Bb + f0 * st.bss, st.bss, nf, N);
    load_tile(fP, LDP, xb + f0 * st.xss, st.xss, nf, P, db + f0 * st.dss,
              st.dss);
  } else {
    load_tile(fN, LDN, Cb + f0 * st.css, st.css, nf, N);
    load_tile(fP, LDP, yb + f0 * st.yss, st.yss, nf, P);
  }
  if (tid < TR) fcs[tid] = tid < nf ? csb[f0 + tid] : make_float2(0.f, 0.f);

  float accN[4][8], accP[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int q = 0; q < 8; ++q) accN[a][q] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) accP[a][q] = 0.f;
  }
  double ssum[4] = {0.0, 0.0, 0.0, 0.0};   // sums of s over t, fixed rows
                                           // tx + 16 b

  // Key blocks stream the row tiles [ft, ntiles), row blocks the key
  // tiles [0, ft].
  const int ts_begin = key ? ft : 0, ts_end = key ? ntiles : ft + 1;
  for (int ts = ts_begin; ts < ts_end; ++ts) {
    const int t0 = ts * TR, nt = min(TR, cl - t0);
    __syncthreads();  // the last tile's products are done
    if (key) {
      load_tile(tN, LDN, Cb + t0 * st.css, st.css, nt, N);
      load_tile(tP, LDP, yb + t0 * st.yss, st.yss, nt, P);
    } else {
      load_tile(tN, LDN, Bb + t0 * st.bss, st.bss, nt, N);
      load_tile(tP, LDP, xb + t0 * st.xss, st.xss, nt, P, db + t0 * st.dss,
                st.dss);
    }
    if (tid < TR)
      tcs[tid] = tid < nt ? csb[t0 + tid] : make_float2(0.f, 0.f);
    __syncthreads();

    // Scores: cb = C_i . B_j and du = dy_i . u_j for t = ty + 16 a and
    // f = tx + 16 b.  Each product is fmaf(streamed, fixed): the two kinds
    // of block give the same bits for the same pair.
    float cb[4][4], du[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) cb[a][q] = du[a][q] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float tv[4], fv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) tv[a] = tN[(ty + 16 * a) * LDN + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) fv[q] = fN[(tx + 16 * q) * LDN + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) cb[a][q] = fmaf(tv[a], fv[q], cb[a][q]);
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float tv[4], fv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) tv[a] = tP[(ty + 16 * a) * LDP + p];
#pragma unroll
      for (int q = 0; q < 4; ++q) fv[q] = fP[(tx + 16 * q) * LDP + p];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) du[a][q] = fmaf(tv[a], fv[q], du[a][q]);
    }
    // Decay-weighted: W = cb L, M = du L, s = W du, with L an exact 0 where
    // j > i or a row lies past the chunk.
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = ty + 16 * a, f = tx + 16 * q;
        const int i = key ? t0 + t : f0 + f, j = key ? f0 + f : t0 + t;
        const bool valid = t < nt && f < nf && j <= i;
        const float2 cs_i = key ? tcs[t] : fcs[f];
        const float2 cs_j = key ? fcs[f] : tcs[t];
        const float l = valid ? expf(cs_diff(cs_i, cs_j)) : 0.f;
        const float w = cb[a][q] * l;
        const float m = du[a][q] * l;
        ssum[q] += static_cast<double>(w * du[a][q]);
        sM[t * LDP + f] = m;
        if (key) sW[t * LDP + f] = w;
      }
    __syncthreads();

    // Outputs of fixed rows f = ty + 16 a: key blocks dB_f += sum_t M[t][f]
    // C_t and du_f += sum_t W[t][f] dy_t; row blocks dC_f += sum_t M[t][f]
    // B_t.
    for (int t = 0; t < nt; ++t) {
      float mv[4], nv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) mv[a] = sM[t * LDP + ty + 16 * a];
#pragma unroll
      for (int q = 0; q < 8; ++q) nv[q] = tN[t * LDN + tx + 16 * q];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          accN[a][q] = fmaf(mv[a], nv[q], accN[a][q]);
      if (key) {
        float wv[4], pv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) wv[a] = sW[t * LDP + ty + 16 * a];
#pragma unroll
        for (int q = 0; q < 4; ++q) pv[q] = tP[t * LDP + tx + 16 * q];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            accP[a][q] = fmaf(wv[a], pv[q], accP[a][q]);
      }
    }
  }

  // The state's terms.  Q is G_c (key blocks) or h- (row blocks), [P, N].
  // QF_f = sum_p fP[f][p] Q[p][.] (G^T u_j, or h-^T dy_i) joins dB_j or dC_i
  // with the decay e_f (exp(cs_last - cs_j), or exp(cs_i)), and e_f fN_f .
  // QF_f is w_j or r_i.  Key blocks also add e_f G B_j to du_j.
  __syncthreads();  // the streamed tiles are consumed
  const long long qoff = (((long long)b * nc + c) * H + h) * P * N;
  const float* Q = (key ? g : states) + qoff;
  float* sQ = tN;                                     // [PP][LDN]
  for (int e = tid; e < PP * N; e += NT) {
    const int p = e / N, n = e - p * N;
    sQ[p * LDN + n] = p < P ? Q[p * N + n] : 0.f;
  }
  __syncthreads();
  const float2 cs_last = csb[cl - 1];
  float ef[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float2 v = fcs[ty + 16 * a];
    ef[a] = ty + 16 * a < nf
                ? (key ? expf(cs_diff(cs_last, v)) : expf(v.x + v.y))
                : 0.f;
  }
  {
    float qf[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) qf[a][q] = 0.f;
#pragma unroll 2
    for (int p = 0; p < P; ++p) {
      float fv[4], qv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) fv[a] = fP[(ty + 16 * a) * LDP + p];
#pragma unroll
      for (int q = 0; q < 8; ++q) qv[q] = sQ[p * LDN + tx + 16 * q];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) qf[a][q] = fmaf(fv[a], qv[q], qf[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tx + 16 * q;
        if (n < N) dot = fmaf(fN[(ty + 16 * a) * LDN + n], qf[a][q], dot);
        accN[a][q] = fmaf(ef[a], qf[a][q], accN[a][q]);
      }
      // The 16 threads of a half-warp share ty: their sum, tx order fixed.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (tx == 0) extra[ty + 16 * a] = ef[a] * dot;
    }
  }
  if (key) {
    float gb[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) gb[a][q] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float fv[4], qv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) fv[a] = fN[(ty + 16 * a) * LDN + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) qv[q] = sQ[(tx + 16 * q) * LDN + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) gb[a][q] = fmaf(fv[a], qv[q], gb[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        accP[a][q] = fmaf(ef[a], gb[a][q], accP[a][q]);
  }

  // The sums of s over t: the 16 threads that share tx hold shares of the
  // same fixed rows; they meet in shared memory and add in ty order.
#pragma unroll
  for (int q = 0; q < 4; ++q) red[ty * TR + tx + 16 * q] = ssum[q];
  __syncthreads();
  const long long pos0 = ((long long)b * H + h) * S + c0 + f0;
  if (tid < nf) {
    double total = 0.0;
    for (int y = 0; y < 16; ++y) total += red[y * TR + tid];
    double* pp = part + (pos0 + tid) * NPART;
    const double e = extra[tid];
    if (key) {
      pp[1] = total + e;          // column sum of s and w_j
      pp[2] = e;                  // w_j
    } else {
      pp[0] = total + e;          // row sum of s and r_i
    }
  }

  // This head's share of dB (key) or dC (row), fp32.
  float* dN = (key ? dBh : dCh) + (pos0)*N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int f = ty + 16 * a;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = tx + 16 * q;
      if (f < nf && n < N) dN[(long long)f * N + n] = accN[a][q];
    }
  }
  if (!key) return;

  // Key blocks: dx_j = dt_j du_j, and x_j . du_j for ddt (a half-warp's
  // sum, as above).
  T* dxb = dx + (((long long)b * S + c0 + f0) * H + h) * P;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int f = ty + 16 * a;
    const bool ok = f < nf;
    const float dtf = ok ? to_f32(db[(f0 + f) * st.dss]) : 0.f;
    float dot = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = tx + 16 * q;
      if (ok && p < P) {
        dot = fmaf(to_f32(xb[(f0 + f) * st.xss + p]), accP[a][q], dot);
        store(dxb + (long long)f * H * P + p, dtf * accP[a][q]);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (ok && tx == 0) part[(pos0 + f) * NPART + 3] = dot;
  }
}

// Launch 4: one block per (chunk, head, batch).  dcs_t = part0 - part1 (+
// sum_j w_j + exp(cs_last) <h-, G> at the last position), da its reverse
// cumulative sum, ddt_t = x_t . du_t + A da_t, and the chunk's share of
// dA, sum_t dt_t da_t; all in fp64.
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_chunk_finish(const T* __restrict__ dt, const T* __restrict__ A,
                     const float2* __restrict__ cs,
                     const float* __restrict__ states,
                     const float* __restrict__ g,
                     const double* __restrict__ part, T* __restrict__ ddt,
                     double* __restrict__ da_part, int S, int H, int PN,
                     int chunk, int nc, Strides st) {
  __shared__ double red[NT / 32];
  __shared__ double wsum[NT / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * chunk, cl = min(chunk, S - c0);
  const long long soff = (((long long)b * nc + c) * H + h) * PN;
  const double* pb = part + (((long long)b * H + h) * S + c0) * NPART;
  const T* db = dt + b * st.dsb + h * st.dsh + c0 * st.dss;
  const double a = to_f32(A[h]);

  // <h-, G> and sum_j w_j.
  double hg = 0.0;
  for (int e = tid; e < PN; e += NT)
    hg += static_cast<double>(states[soff + e]) * g[soff + e];
  hg = block_sum(hg, red);
  double w = 0.0;
  for (int t = tid; t < cl; t += NT) w += pb[t * NPART + 2];
  w = block_sum(w, red);
  const float2 last = cs[((long long)b * H + h) * S + c0 + cl - 1];
  const double at_last = w + static_cast<double>(expf(last.x + last.y)) * hg;

  // The reverse cumulative sum over segments of NT positions from the end:
  // thread k takes position s1 - 1 - k, so a forward scan over threads
  // sums the positions at or after it.
  double carry = 0.0, dA_sum = 0.0;
  for (int s1 = cl; s1 > 0; s1 -= NT) {
    const int t = s1 - 1 - tid;
    double v = 0.0;
    if (t >= 0) {
      v = pb[t * NPART + 0] - pb[t * NPART + 1];
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
    for (int k = 0; k < NT / 32; ++k) {
      const double u = wsum[k];
      if (k < warp) before += u;
      total += u;
    }
    if (t >= 0) {
      const double da = v + before;
      const double dtv = to_f32(db[t * st.dss]);
      store(ddt + ((long long)b * S + c0 + t) * H + h,
            static_cast<float>(pb[t * NPART + 3] + a * da));
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
__global__ void __launch_bounds__(NT)
ssd_bwd_sums(const float* __restrict__ dBh, const float* __restrict__ dCh,
             const double* __restrict__ da_part, T* __restrict__ dB,
             T* __restrict__ dC, T* __restrict__ dA, int nb, int S, int H,
             int N, int nc) {
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
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

int chunk_dstates_smem() { return (TR * LDP + TR * LDN + TR) * 4; }

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* dy, const float2* cs,
           const float* states, const float* dstate, float* g, double* part,
           float* dBh, float* dCh, double* da_part, void* dx, void* ddt,
           void* dA, void* dB, void* dC, int b, int S, int H, int P, int N,
           int chunk, const long long* s, cudaStream_t stream) {
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0 || P > PP || N <= 0 || N > NP ||
      chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides st = {s[0], s[1], s[2], s[3], s[4], s[5], s[6],
                      s[7], s[8], s[9], s[10], s[11], s[12]};
  const T* tx = static_cast<const T*>(x);
  const T* tdt = static_cast<const T*>(dt);
  const T* tA = static_cast<const T*>(A);
  const T* tB = static_cast<const T*>(B);
  const T* tC = static_cast<const T*>(C);
  const T* tdy = static_cast<const T*>(dy);
  const int nc = (S + chunk - 1) / chunk;
  const int tiles = ((chunk < S ? chunk : S) + TR - 1) / TR;
  const int smem1 = chunk_dstates_smem(), smem3 = TileSmem::BYTES;
  // Above 48 KB a kernel must opt in to dynamic shared memory.
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_chunk_dstates<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_tiles<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem3);
  if (e != cudaSuccess) return (int)e;
  if (nc > 1) {
    ssd_bwd_chunk_dstates<T><<<dim3(nc - 1, H, b), NT, smem1, stream>>>(
        tC, tdy, cs, g, S, H, P, N, chunk, nc, st);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ssd_bwd_state_pass<<<dim3((P * N + NT - 1) / NT, H, b), NT, 0, stream>>>(
      cs, dstate, g, S, H, P * N, chunk, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_tiles<T><<<dim3(2 * tiles * nc, H, b), NT, smem3, stream>>>(
      tx, tdt, tB, tC, tdy, cs, states, g, part, dBh, dCh,
      static_cast<T*>(dx), S, H, P, N, chunk, nc, tiles, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk_finish<T><<<dim3(nc, H, b), NT, 0, stream>>>(
      tdt, tA, cs, states, g, part, static_cast<T*>(ddt), da_part, S, H,
      P * N, chunk, nc, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long elems = (long long)b * S * N;
  const long long n5 = elems > H ? elems : H;
  ssd_bwd_sums<T><<<dim3((unsigned)((n5 + NT - 1) / NT)), NT, 0, stream>>>(
      dBh, dCh, da_part, static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<T*>(dA), b, S, H, N, nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 13 element strides: x (batch, seq, head), dt (batch, seq, head),
// B (batch, seq), C (batch, seq), dy (batch, seq, head).  cs and states are
// the forward's scratch (odin_ssd_scan_fwd: cs the fp32 (hi, lo) pairs of
// the cumulative dA, b * H * S of them; states b * ceil(S / chunk) * H * P *
// N fp32, the state entering each chunk).  dstate: the fp32 gradient of
// the final state, contiguous [b, H, P, N], or null for zero.  Scratch: g
// shaped as states (fp32), part b * H * S * 4 doubles, dBh and dCh b * H *
// S * N fp32 each, da_part b * ceil(S / chunk) * H doubles.  Gradients,
// contiguous, in the inputs' dtype: dx [b, S, H, P], ddt [b, S, H], dA [H],
// dB and dC [b, S, N].  dtype: 0 = float32, 1 = bfloat16.  Returns the
// CUDA error code of the launches (0 on success).
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
int odin_ssd_scan_bwd_smem_bytes(int which) {
  return which == 0 ? chunk_dstates_smem() : TileSmem::BYTES;
}

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
