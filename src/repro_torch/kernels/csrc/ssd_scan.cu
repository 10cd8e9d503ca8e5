// Mamba2 SSD chunk scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel): with dA = dt * A and cs its inclusive cumulative sum within
// a chunk,
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j      (intra)
//         + exp(cs_i) C_i . h                                       (state read)
//   h    <- exp(cs_last) h + sum_j exp(cs_last - cs_j) dt_j x_j (x) B_j
// per (batch, head), with n_groups = 1 (B and C shared by the heads).
// Unlike the Pallas kernel it also returns the final state h [b, H, P, N] in
// fp32, which the model's prefill keeps as its cache.
//
// What bounds it on an H100: the bytes.  At mamba2-370m's shape (b 1,
// S 1024, H 32, P 64, N 128, bf16) it must read x, dt, B, C and write y and
// the fp32 state, about 10 MB, against about 1.65 GFLOP of products: far
// below the ~295 operations per byte at which Hopper's tensor cores would
// be the limit.  The Pallas grid carries the state along a sequential chunk
// axis; only that [P, N] state has to pass from chunk to chunk, so this
// design runs the rest in parallel over chunks, in three launches:
//
// 1. ssd_chunk_states, one block per (chunk, head, batch): the chunk's
//    cumulative dA (to a scratch [b, H, S] of fp32 pairs) and its own state
//    sum_j exp(cs_last - cs_j) dt_j x_j (x) B_j, a [P, chunk] x [chunk, N]
//    product, to an fp32 scratch [b, nc, H, P, N] that stays in L2.
// 2. ssd_state_pass, one thread per (state element, head, batch): the
//    recurrence over chunks, h_c = exp(cs_last_c) h_{c-1} + state_c, in
//    fp32; it overwrites each chunk's scratch with the state that enters
//    the chunk and writes the final state.
// 3. ssd_chunk_outputs, one block of 8 warps per (64-row tile, chunk, head,
//    batch): the intra-chunk term over the key tiles at or before its rows,
//    and the read of the entering state.  Two warps share 16 rows, each
//    taking half of every key tile (and of N), and add their sums at the
//    end.  Blocks with the most key tiles go first; key tiles stream
//    through two stages of shared memory.
//
// The products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), their bf16 operands read by ldmatrix.  A chunk's tiles
// are ragged at the chunk's and the sequence's end (a short last chunk,
// chunk 96 or 37, S 17), and P and N may be 32: mma.sync's 16 x 8 tiles
// follow such edges where wgmma's 64-row tiles and swizzled layouts would
// not, and the operations are far from the bound either way.
//
// Three operands are fp32: the decay-weighted scores, exp(cs_last - cs_j)
// dt_j x_j and the state h.  Each is split into three bf16 terms, v =
// bf16(v) + bf16(rest) + bf16(rest'), and the product runs three times: y
// is rounded to bf16, and a relative difference d before that rounding
// flips roundings at an rms of about sqrt(d) of a bf16 ulp, so the two
// terms of a hi / lo split (d about 2^-17) would leave y's rms error at
// half its limit, three terms at the fp32 floor.  C . B^T (two bf16
// operands) runs once and is exact with fp32 accumulation.  The cumulative
// sum cs is summed in fp64 and kept as an fp32 (hi, lo) pair: where dt A is
// large (the JAX test's dt) |cs| reaches hundreds within a chunk, and
// cs_i - cs_j of fp32 sums carries an error of ulp(|cs|), about 3e-5, into
// each decay weight.  fp32 inputs take the same three launches with the
// products on the fp32 CUDA cores (the fp32 limit is beyond bf16 operands).
// Tiles come in by 16-byte cp.async; rows past the end are zero-filled.
// Pairs j > i are an exact 0, never exp(+x).
//
// Measured (chip_smoke.py and tools/k23_variants.py on an NVIDIA H100 80GB
// HBM3 at 700 W): 0.073 ms at the shape above, against 0.936 ms for the
// first design (one block per head, fp32 CUDA cores); launch 3 takes about
// 47 us of it, launch 1 15 us, launch 2 4 us.  That is 25x the byte bound,
// with 8% of the bf16 tensor-core peak executed and 4% of HBM's rate used:
// 16 warps an SM each wait on their own chain of ldmatrix, mma and expf.
//
// Layout: x [b, S, H, P], dt [b, S, H], B and C [b, S, N] and y [b, S, H, P]
// are given by element strides (the last dimension's stride must be 1, the
// strides of x, B and C multiples of 16 bytes and their bases 16-byte
// aligned), so the model's views into its conv output are read in place.
// P <= 64 and N <= 128, multiples of 8 (bf16) or 4 (fp32); A in the
// inputs' dtype.  Any S and any chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TR = 64;          // rows of a position tile
constexpr int PP = 64;          // P, padded
constexpr int NP = 128;         // N, padded
constexpr int LDH = NP + 4;     // row stride of the fp32 state tile
constexpr int NT_STATES = 256;  // launch 1: 8 warps, 16 x 64 of the state each
constexpr int NT_PASS = 256;    // launch 2
constexpr int NT_OUT = 256;     // launch 3: 8 warps

template <typename T>
struct Tile {
  static constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int VE = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int LDN = NP + VE;         // row strides (16-byte rows,
  static constexpr int LDP = PP + VE;         // few bank conflicts)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros when `valid` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for every committed group of copies but the newest.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy rows [0, rows) of width `width` (a multiple of 16 bytes) from
// global rows `src + r * rs` into a shared tile with row stride `ld`; rows
// at or past `valid` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long rs, int rows, int valid,
                                          int width) {
  constexpr int VE = Tile<T>::VE;
  const int pieces = width / VE;
  for (int e = threadIdx.x; e < rows * pieces; e += blockDim.x) {
    const int r = e / pieces, c = e - r * pieces;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + c * VE, src + (ok ? r * rs : 0) + c * VE, ok);
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

// (x0, x1) as TERMS bf16 pairs: o[0] = bf16(x), o[1] = bf16(x - o[0]), ...
// Three terms carry 24 bits of mantissa, an fp32 value's.
template <int TERMS>
__device__ __forceinline__ void split(float x0, float x1, uint32_t (&o)[TERMS]) {
#pragma unroll
  for (int i = 0; i < TERMS; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    o[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    x0 -= f.x;
    x1 -= f.y;
  }
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of m16n8k16 from (x0..x7) = A[g][2t, 2t+1], A[g+8][2t,
// 2t+1], A[g][2t+8, 2t+9], A[g+8][2t+8, 2t+9], in TA bf16 terms.
template <int TA>
__device__ __forceinline__ void frag_a(uint32_t (&f)[TA][4], float x0,
                                       float x1, float x2, float x3,
                                       float x4, float x5, float x6,
                                       float x7) {
  uint32_t r0[TA], r1[TA], r2[TA], r3[TA];
  split<TA>(x0, x1, r0);
  split<TA>(x2, x3, r1);
  split<TA>(x4, x5, r2);
  split<TA>(x6, x7, r3);
#pragma unroll
  for (int i = 0; i < TA; ++i) {
    f[i][0] = r0[i];
    f[i][1] = r1[i];
    f[i][2] = r2[i];
    f[i][3] = r3[i];
  }
}

// d += A B for one m16n8k16 tile, with A in TA bf16 terms and B in TB
// (one side has one term: its operand is bf16 already).  Fragment layouts
// of m16n8k16: lane = 4 g + t holds A rows g, g + 8 and columns 2t, 2t + 1,
// 2t + 8, 2t + 9; B rows 2t, 2t + 1, 2t + 8, 2t + 9 of column g; d rows g,
// g + 8 and columns 2t, 2t + 1.
template <int TA, int TB>
__device__ __forceinline__ void mma_terms(float (&d)[4],
                                          const uint32_t (&a)[TA][4],
                                          const uint32_t (&b0)[TB],
                                          const uint32_t (&b1)[TB]) {
  static_assert(TA == 1 || TB == 1, "one operand is bf16");
#pragma unroll
  for (int i = 0; i < TA; ++i) mma16816(d, a[i], b0[0], b1[0]);
#pragma unroll
  for (int i = 1; i < TB; ++i) mma16816(d, a[0], b0[i], b1[i]);
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; with _t each matrix is transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// For lane l of an ldmatrix.x4, the (row, column) offsets in a tile:
// the A operand of a 16 x 16 step stored [row][k] (lda), a pair of B
// operands of 8-column tiles stored [column][k] (ldb), and either stored
// transposed, [k][row] or [k][column] (lda_t, ldb_t).
__device__ __forceinline__ int lda(int lane, int ld) {
  return (lane & 15) * ld + ((lane >> 4) << 3);
}
__device__ __forceinline__ int ldb(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int lda_t(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int ldb_t(int lane, int ld) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + ((lane >> 4) << 3);
}

// The fp32 route: acc[16 x 8 NTL] += A[16 x 16] B[16 x 8 NTL] on the CUDA
// cores, with a(r, k) and b(k, col) giving the operands and the output in
// the mma layout above.  Its inner loop stays rolled: unrolled, it made
// this source's build take 15.8 s, nearly three times any other's
// (chip_smoke.py prints each), for a route only the fp32 checks take.
template <int NTL, class FA, class FB>
__device__ __forceinline__ void fma_step(float (&acc)[NTL][4], FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    const int c = 8 * nt + t2;
#pragma unroll 1
    for (int k = 0; k < 16; ++k) {
      const float a0 = a(g, k), a1 = a(g + 8, k);
      const float b0 = b(k, c), b1 = b(k, c + 1);
      acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
    }
  }
}

// cs_i - cs_j of two cumulative sums kept as fp32 (hi, lo) pairs: the
// difference of the his is exact where they are close, which is where the
// decay exp(cs_i - cs_j) is not negligible.
__device__ __forceinline__ float cs_diff(float2 i, float2 j) {
  return (i.x - j.x) + (i.y - j.y);
}

struct Strides {
  long long xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css, ysb, yss, ysh;
};

// Launch 1: one block per (chunk, head, batch).
template <typename T>
__global__ void __launch_bounds__(NT_STATES)
ssd_chunk_states(const T* __restrict__ x, const T* __restrict__ dt,
                 const T* __restrict__ A, const T* __restrict__ Bm,
                 float2* cs, float* __restrict__ states, int S, int H, int P,
                 int N, int chunk, int nc, Strides st) {
  using L = Tile<T>;
  extern __shared__ __align__(16) uint8_t smem[];
  T* sB = reinterpret_cast<T*>(smem);                // [TR][LDN]
  T* sX = sB + TR * L::LDN;                          // [TR][LDP]
  double* sPart = reinterpret_cast<double*>(sX + TR * L::LDP);  // [NW]
  float2* sLast = reinterpret_cast<float2*>(sPart + NT_STATES / 32);
  float* sW = reinterpret_cast<float*>(sLast + 1);   // [TR]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * chunk, cl = min(chunk, S - c0);
  const float a = to_f32(A[h]);
  const T* db = dt + b * st.dsb + h * st.dsh + c0 * st.dss;
  const T* xb = x + b * st.xsb + h * st.xsh + c0 * st.xss;
  const T* Bb = Bm + b * st.bsb + c0 * st.bss;
  float2* csb = cs + ((long long)b * H + h) * S + c0;

  zero_columns(sB, L::LDN, TR, N, NP);
  zero_columns(sX, L::LDP, TR, P, PP);

  // Inclusive cumulative sum of dA (an fp32 product) over the chunk, summed
  // in fp64 and kept as an fp32 (hi, lo) pair: a warp scan per 32
  // positions, warp totals combined through sPart, segments of 256 chained.
  double carry = 0.0;
  for (int s0 = 0; s0 < cl; s0 += NT_STATES) {
    const int j = s0 + tid;
    double v = j < cl ? to_f32(db[(long long)j * st.dss]) * a : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane == 31) sPart[warp] = v;
    __syncthreads();
    double before = carry, total = carry;
    for (int w = 0; w < NT_STATES / 32; ++w) {
      const double t = sPart[w];
      if (w < warp) before += t;
      total += t;
    }
    if (j < cl) {
      const double sum = v + before;
      const float hi = static_cast<float>(sum);
      const float2 pair = make_float2(hi, static_cast<float>(sum - hi));
      csb[j] = pair;
      if (j == cl - 1) *sLast = pair;
    }
    carry = total;
    __syncthreads();  // sPart is read before the next segment writes it
  }
  const float2 cs_last = *sLast;

  // This warp's 16 x 64 block of the [P, N] state: rows 16 (warp % 4),
  // columns 64 (warp / 4).
  const int p0 = 16 * (warp & 3), n0 = 64 * (warp >> 2);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int t2 = 2 * (lane & 3);
  for (int j0 = 0; j0 < cl; j0 += TR) {
    const int nj = min(TR, cl - j0);
    __syncthreads();  // the previous tile is consumed; cs is written
    load_rows(sB, L::LDN, Bb + j0 * st.bss, st.bss, TR, nj, N);
    load_rows(sX, L::LDP, xb + j0 * st.xss, st.xss, TR, nj, P);
    if (tid < TR) {
      const int j = j0 + tid;
      sW[tid] = tid < nj ? expf(cs_diff(cs_last, csb[j])) *
                               to_f32(db[(long long)j * st.dss])
                         : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (p0 < P) {
#pragma unroll
      for (int ks = 0; ks < TR / 16; ++ks) {
        const int k0 = 16 * ks;
        if constexpr (L::TC) {
          // A[p][j] = x_j[p] w_j from x's [j][p] tile, in three terms.
          uint32_t xr[4], f[3][4];
          ldsm_x4_t(xr, sX + k0 * L::LDP + p0 + lda_t(lane, L::LDP));
          const float w0 = sW[k0 + t2], w1 = sW[k0 + t2 + 1];
          const float w8 = sW[k0 + t2 + 8], w9 = sW[k0 + t2 + 9];
          const float2 x0 = unpack(xr[0]), x1 = unpack(xr[1]);
          const float2 x2 = unpack(xr[2]), x3 = unpack(xr[3]);
          frag_a<3>(f, x0.x * w0, x0.y * w1, x1.x * w0, x1.y * w1,
                    x2.x * w8, x2.y * w9, x3.x * w8, x3.y * w9);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t br[4];
            ldsm_x4_t(br, sB + k0 * L::LDN + n0 + 16 * np +
                              ldb_t(lane, L::LDN));
            const uint32_t b0[1] = {br[0]}, b1[1] = {br[1]};
            const uint32_t b2[1] = {br[2]}, b3[1] = {br[3]};
            mma_terms<3, 1>(acc[2 * np], f, b0, b1);
            mma_terms<3, 1>(acc[2 * np + 1], f, b2, b3);
          }
        } else {
          fma_step<8>(
              acc,
              [&](int r, int k) {
                return to_f32(sX[(k0 + k) * L::LDP + p0 + r]) * sW[k0 + k];
              },
              [&](int k, int col) {
                return to_f32(sB[(k0 + k) * L::LDN + n0 + col]);
              });
        }
      }
    }
  }

  const int g = lane >> 2;
  float* out = states + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + g + (e >= 2 ? 8 : 0);
      const int n = n0 + 8 * nt + t2 + (e & 1);
      if (p < P && n < N) out[p * N + n] = acc[nt][e];
    }
}

// Launch 2: the recurrence over chunks, one thread per (p, n) of a head,
// with the loads of four chunks in flight at a time.  Scratch chunk c then
// holds the state entering chunk c.
__global__ void __launch_bounds__(NT_PASS)
ssd_state_pass(const float2* __restrict__ cs, float* __restrict__ states,
               float* __restrict__ final_state, int S, int H, int PN,
               int chunk, int nc) {
  const int e = blockIdx.x * NT_PASS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const float2* csb = cs + ((long long)b * H + h) * S;
  float* sb = states + ((long long)b * nc * H + h) * PN + e;
  const long long step = (long long)H * PN;   // from chunk to chunk
  float state = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float own[4], decay[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = min(c0 + u, nc - 1);
      own[u] = sb[c * step];
      const float2 last = csb[min((c + 1) * chunk, S) - 1];
      decay[u] = last.x + last.y;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        const float in = c == 0 ? 0.f : state;
        sb[c * step] = in;
        state = fmaf(in, expf(decay[u]), own[u]);
      }
    }
  }
  final_state[((long long)b * H + h) * PN + e] = state;
}

template <typename T>
struct OutSmem {
  using L = Tile<T>;
  static constexpr int TILE_B = TR * L::LDN * sizeof(T);   // B rows
  static constexpr int TILE_X = TR * L::LDP * sizeof(T);   // x rows
  static constexpr int C = 0;                               // [TR][LDN] T
  static constexpr int B = C + TILE_B;                      // 2 stages
  static constexpr int X = B + 2 * TILE_B;                  // 2 stages
  static constexpr int H = X + 2 * TILE_X;                  // [PP][LDH] f32
  static constexpr int CS = H + PP * LDH * 4;               // 2 x [TR] f32x2
  static constexpr int DT = CS + 2 * TR * 8;                // 2 x [TR] f32
  // fp32 inputs: each warp's weighted scores go through shared memory.
  static constexpr int SW = DT + 2 * TR * 4;                // 8 x [16][36]
  static constexpr int BYTES = SW + (L::TC ? 0 : 8 * 16 * 36 * 4);
  // After the key tiles, the halves' sums meet in the B stages.
  static constexpr int RED = B;                             // [TR][PP+4] f32
  static_assert(TR * (PP + 4) * 4 <= 2 * TILE_B, "room for the reduction");
};

// Launch 3: one block per (64-row tile, chunk, head, batch), 8 warps.  Warp
// w takes rows 16 (w % 4) of the tile and half w / 4 of each key tile (and
// of N for the state read); the two halves' sums are added at the end.
// The key tiles at or before the row tile stream through two stages: the
// copies of the next run while this one's products do.
template <typename T>
__global__ void __launch_bounds__(NT_OUT, 2)   // two blocks fill an SM
ssd_chunk_outputs(const T* __restrict__ x, const T* __restrict__ dt,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float2* __restrict__ cs,
                  const float* __restrict__ states, T* __restrict__ y, int S,
                  int H, int P, int N, int chunk, int nc, int tiles,
                  Strides st) {
  using L = Tile<T>;
  using M = OutSmem<T>;
  extern __shared__ __align__(16) uint8_t smem[];
  T* sC = reinterpret_cast<T*>(smem + M::C);
  float* sH = reinterpret_cast<float*>(smem + M::H);
  auto sB = [&](int s) {
    return reinterpret_cast<T*>(smem + M::B) + s * TR * L::LDN;
  };
  auto sX = [&](int s) {
    return reinterpret_cast<T*>(smem + M::X) + s * TR * L::LDP;
  };
  auto sCs = [&](int s) {
    return reinterpret_cast<float2*>(smem + M::CS) + s * TR;
  };
  auto sDt = [&](int s) {
    return reinterpret_cast<float*>(smem + M::DT) + s * TR;
  };

  // The row tiles with the most key tiles come first.
  const int c = blockIdx.x % nc, rt = tiles - 1 - blockIdx.x / nc;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * chunk, cl = min(chunk, S - c0), i0 = rt * TR;
  if (i0 >= cl) return;  // past a short last chunk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int w16 = 16 * (warp & 3);          // this warp's rows of the tile
  const int half = warp >> 2;               // and its half of keys and N
  const int kh = 32 * half;                 // its first key of a tile
  const T* xb = x + b * st.xsb + h * st.xsh + c0 * st.xss;
  const T* db = dt + b * st.dsb + h * st.dsh + c0 * st.dss;
  const T* Bb = Bm + b * st.bsb + c0 * st.bss;
  const T* Cb = Cm + b * st.csb + c0 * st.css;
  const float2* csb = cs + ((long long)b * H + h) * S + c0;

  // Key tile jt into stage s: B and x rows by cp.async, cs and dt stored.
  auto fetch = [&](int jt, int s) {
    const int j0 = jt * TR, nj = min(TR, cl - j0);
    load_rows(sB(s), L::LDN, Bb + j0 * st.bss, st.bss, TR, nj, N);
    load_rows(sX(s), L::LDP, xb + j0 * st.xss, st.xss, TR, nj, P);
    if (tid < TR) {
      sCs(s)[tid] = tid < nj ? csb[j0 + tid] : make_float2(0.f, 0.f);
      sDt(s)[tid] =
          tid < nj ? to_f32(db[(long long)(j0 + tid) * st.dss]) : 0.f;
    }
  };

  zero_columns(sC, L::LDN, TR, N, NP);
  for (int s = 0; s < 2; ++s) {
    zero_columns(sB(s), L::LDN, TR, N, NP);
    zero_columns(sX(s), L::LDP, TR, P, PP);
  }
  load_rows(sC, L::LDN, Cb + i0 * st.css, st.css, TR, cl - i0, N);
  if (c > 0) {
    // The state entering the chunk, [P, N] fp32 (rows past P are zero).
    load_rows(sH, LDH, states + (((long long)b * nc + c) * H + h) * P * N,
              (long long)N, PP, P, N);
    zero_columns(sH, LDH, PP, N, NP);
  }
  fetch(0, 0);
  // cs of this warp's two rows per thread: rows w16 + g and w16 + g + 8.
  const int ia = i0 + w16 + g, ib = ia + 8;
  const float2 cs_a = ia < cl ? csb[ia] : make_float2(0.f, 0.f);
  const float2 cs_b = ib < cl ? csb[ib] : make_float2(0.f, 0.f);

  float yacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[i][e] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  // State read: exp(cs_i) C_i . h over this warp's half of N.
  if (c > 0) {
#pragma unroll
    for (int ks = 0; ks < NP / 32; ++ks) {
      const int k0 = NP / 2 * half + 16 * ks;
      if constexpr (L::TC) {
        uint32_t ar[4];
        ldsm_x4(ar, sC + w16 * L::LDN + k0 + lda(lane, L::LDN));
        const uint32_t f[1][4] = {{ar[0], ar[1], ar[2], ar[3]}};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* hp = sH + (8 * nt + g) * LDH + k0 + t2;
          const float2 h0 = *reinterpret_cast<const float2*>(hp);
          const float2 h1 = *reinterpret_cast<const float2*>(hp + 8);
          uint32_t b0[3], b1[3];
          split<3>(h0.x, h0.y, b0);
          split<3>(h1.x, h1.y, b1);
          mma_terms<1, 3>(yacc[nt], f, b0, b1);
        }
      } else {
        fma_step<8>(
            yacc,
            [&](int r, int k) {
              return to_f32(sC[(w16 + r) * L::LDN + k0 + k]);
            },
            [&](int k, int col) { return sH[col * LDH + k0 + k]; });
      }
    }
    const float ea = expf(cs_a.x + cs_a.y), eb = expf(cs_b.x + cs_b.y);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      yacc[nt][0] *= ea;
      yacc[nt][1] *= ea;
      yacc[nt][2] *= eb;
      yacc[nt][3] *= eb;
    }
  }

  // Intra-chunk terms from the key tiles at or before this row tile.
  for (int jt = 0; jt <= rt; ++jt) {
    const int s = jt & 1, j0 = jt * TR;
    if (jt < rt) {
      fetch(jt + 1, s ^ 1);   // its stage was released at the end of jt - 1
      cp_async_commit();
      cp_async_wait_one();    // all but the newest group: tile jt is in
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const T* tB = sB(s);
    const T* tX = sX(s);
    const float2* tCs = sCs(s);
    const float* tDt = sDt(s);

    // Scores C_i . B_j for this warp's 16 rows and its 32 keys.
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks) {
      const int k0 = 16 * ks;
      if constexpr (L::TC) {
        uint32_t ar[4];
        ldsm_x4(ar, sC + w16 * L::LDN + k0 + lda(lane, L::LDN));
        const uint32_t f[1][4] = {{ar[0], ar[1], ar[2], ar[3]}};
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t br[4];
          ldsm_x4(br, tB + (kh + 16 * np) * L::LDN + k0 + ldb(lane, L::LDN));
          const uint32_t b0[1] = {br[0]}, b1[1] = {br[1]};
          const uint32_t b2[1] = {br[2]}, b3[1] = {br[3]};
          mma_terms<1, 1>(sacc[2 * np], f, b0, b1);
          mma_terms<1, 1>(sacc[2 * np + 1], f, b2, b3);
        }
      } else {
        fma_step<4>(
            sacc,
            [&](int r, int k) {
              return to_f32(sC[(w16 + r) * L::LDN + k0 + k]);
            },
            [&](int k, int col) {
              return to_f32(tB[(kh + col) * L::LDN + k0 + k]);
            });
      }
    }
    // Weighted by exp(cs_i - cs_j) dt_j where j <= i, exactly 0 elsewhere.
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >= 2 ? ib : ia;
        const int jj = kh + 8 * nt + t2 + (e & 1), j = j0 + jj;
        const float2 cs_i = e >= 2 ? cs_b : cs_a;
        sacc[nt][e] = (i < cl && j <= i)
                          ? sacc[nt][e] *
                                (expf(cs_diff(cs_i, tCs[jj])) * tDt[jj])
                          : 0.f;
      }

    // y += S_w x over this warp's 32 keys.
    if constexpr (L::TC) {
      // The score accumulator is laid out as the A operand of the next
      // product: key tiles 2 kk and 2 kk + 1 make the 16 keys of step kk.
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t f[3][4];
        frag_a<3>(f, sacc[2 * kk][0], sacc[2 * kk][1], sacc[2 * kk][2],
                  sacc[2 * kk][3], sacc[2 * kk + 1][0], sacc[2 * kk + 1][1],
                  sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t br[4];
          ldsm_x4_t(br, tX + (kh + 16 * kk) * L::LDP + 16 * np +
                            ldb_t(lane, L::LDP));
          const uint32_t b0[1] = {br[0]}, b1[1] = {br[1]};
          const uint32_t b2[1] = {br[2]}, b3[1] = {br[3]};
          mma_terms<3, 1>(yacc[2 * np], f, b0, b1);
          mma_terms<3, 1>(yacc[2 * np + 1], f, b2, b3);
        }
      }
    } else {
      float* sw = reinterpret_cast<float*>(smem + M::SW) + warp * 16 * 36;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sw[(g + (e >= 2 ? 8 : 0)) * 36 + 8 * nt + t2 + (e & 1)] =
              sacc[nt][e];
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        fma_step<8>(
            yacc, [&](int r, int k) { return sw[r * 36 + 16 * kk + k]; },
            [&](int k, int col) {
              return to_f32(tX[(kh + 16 * kk + k) * L::LDP + col]);
            });
      __syncwarp();
    }
    __syncthreads();  // stage s is released for tile jt + 2
  }

  // The second half's sums meet the first's in shared memory (the B
  // stages are free now); the first half writes y.
  float* red = reinterpret_cast<float*>(smem + M::RED);
  if (half == 1) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(w16 + g + (e >= 2 ? 8 : 0)) * (PP + 4) + 8 * nt + t2 +
            (e & 1)] = yacc[nt][e];
  }
  __syncthreads();
  if (half == 1) return;
  T* yb = y + b * st.ysb + h * st.ysh + c0 * st.yss;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = w16 + g + (e >= 2 ? 8 : 0);
      const int i = i0 + r, p = 8 * nt + t2 + (e & 1);
      if (i < cl && p < P)
        store(yb + (long long)i * st.yss + p,
              yacc[nt][e] + red[r * (PP + 4) + p]);
    }
}

template <typename T>
int states_smem() {
  using L = Tile<T>;
  return TR * (L::LDN + L::LDP) * sizeof(T) + (NT_STATES / 32) * 8 + 8 +
         TR * 4;
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, float* state, float2* cs, float* states,
           int b, int S, int H, int P, int N, int chunk,
           const long long* s, cudaStream_t stream) {
  constexpr int VE = Tile<T>::VE;
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0 || P > PP || P % VE != 0 ||
      N <= 0 || N > NP || N % VE != 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides st = {s[0], s[1], s[2], s[3], s[4], s[5], s[6],
                      s[7], s[8], s[9], s[10], s[11], s[12]};
  const int nc = (S + chunk - 1) / chunk;
  const int tiles = ((chunk < S ? chunk : S) + TR - 1) / TR;
  const int smem1 = states_smem<T>(), smem3 = OutSmem<T>::BYTES;
  // Above 48 KB a kernel must opt in to dynamic shared memory.
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_outputs<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem3);
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_states<T><<<dim3(nc, H, b), NT_STATES, smem1, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(A), static_cast<const T*>(B), cs, states, S, H, P,
      N, chunk, nc, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_state_pass<<<dim3((P * N + NT_PASS - 1) / NT_PASS, H, b), NT_PASS, 0,
                   stream>>>(cs, states, state, S, H, P * N, chunk, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_outputs<T><<<dim3(tiles * nc, H, b), NT_OUT, smem3, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(B), static_cast<const T*>(C), cs, states,
      static_cast<T*>(y), S, H, P, N, chunk, nc, tiles, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 13 element strides: x (batch, seq, head), dt (batch, seq, head),
// B (batch, seq), C (batch, seq), y (batch, seq, head).  state is a
// contiguous fp32 [b, H, P, N] buffer; cs an fp32 scratch of b * H * S
// (hi, lo) pairs and states one of b * ceil(S / chunk) * H * P * N.
// dtype: 0 = float32, 1 = bfloat16.  Returns the CUDA error code of the
// launches (0 on success).
int odin_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                      const void* B, const void* C, void* y, void* state,
                      void* cs, void* states, int b, int S, int H, int P,
                      int N, int chunk, const long long* strides, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fs = static_cast<float*>(state);
  float2* fcs = static_cast<float2*>(cs);
  float* fst = static_cast<float*>(states);
  if (dtype == 0)
    return launch<float>(x, dt, A, B, C, y, fs, fcs, fst, b, S, H, P, N,
                         chunk, strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, fs, fcs, fst, b, S, H, P,
                                 N, chunk, strides, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a block of launch 1 (which 0) or 3 (which 2).
int odin_ssd_scan_smem_bytes(int which, int dtype) {
  if (which == 0)
    return dtype == 0 ? states_smem<float>() : states_smem<__nv_bfloat16>();
  return dtype == 0 ? OutSmem<float>::BYTES : OutSmem<__nv_bfloat16>::BYTES;
}

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
