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
// row log-sum-exp lse and the fp32 output O.  It has the structure of the
// fp32 backward (flash_attention_bwd.cu) and never writes an S x S matrix
// to device memory:
//
//   delta = rowsum(dO o O)                          (launch 1)
//   P     = exp(scale Q K^T - lse),  dS = P o (dO V^T - delta)
//   dV    = P^T dO,  dK = scale dS^T Q              (launch 2; 2b)
//   dQ    = scale dS K                              (launch 2)
//
// Launch 2 holds two kinds of block, one template (x_tile).  A block of 4
// warps holds a fixed tile X of 64 rows, 16 a warp, and streams tiles Y of
// 32 rows past it, two Y tiles in flight (cp.async into a second buffer
// while the first is read):
//
//   dK/dV blocks: X = K, V of 64 keys; Y = Q, dO of 32 queries: S^T = K Q^T
//     and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q;
//   dQ blocks: X = Q, dO of 64 queries; Y = K, V of 32 keys: S = Q K^T,
//     dP = dO V^T, then dQ += dS K (S and dP recomputed rather than dQ
//     summed across blocks).
//
// Block 2i is a dK/dV block and 2i + 1 a dQ block, the heaviest tiles of
// each kind (key tile 0, the last query tile, under a causal mask) first,
// so the light blocks fill the card behind the heavy ones.  Under GQA each
// dK/dV block writes its query head's share of dK and dV to an fp32
// scratch [group, B, Hkv, S, D], and launch 2b adds the group's shares in
// head order and rounds once; no atomics, so two calls give the same bits.
// Masks are the forward's (causal, qp - kp < window, bidirectional); only
// the Y tiles the mask keeps are visited.
//
// What bounds it on an H100: operations.  It needs five products over the
// kept (query, key) pairs (2 * 5 * B * Hq * pairs * D operations); every
// product runs on the tensor cores as mma.sync m16n8k16 with bf16 operands
// and fp32 accumulators (989 TFLOP/s dense on the card).  Q, K, V and dO
// are exact in bf16, so S and dP are exact products summed in fp32.  P and
// dS are fp32 on chip: each is split into bf16 hi = bf16(x) and lo =
// bf16(x - hi) and dV, dK and dQ take both products, small terms first.  A
// CPU model of this rounding (tests/test_torch_kernels.py) reads 0.7-1.4e-4
// of each gradient's rms against jax.grad of the JAX model's attention; P
// or dS in bf16 alone reads about 2.6e-3, and delta from the bf16 O about
// 1.1-1.5e-3, both over MAIN_RMS_LIMIT (2e-4), the bf16 forward's standard.
// So where five products over the kept pairs are needed, it executes six
// for each (64-key, 32-query) tile pair of a dK/dV block (S, dP, two for
// dV and two for dK) and four for each (64-query, 32-key) tile pair of a
// dQ block (S, dP and two for dQ), over whole tiles.
//
// Fragments: an m16n8 accumulator pair (n tiles 2kk, 2kk + 1) is exactly
// one m16n8k16 A fragment, so P^T, dS^T (dK/dV blocks) and dS (dQ blocks)
// go from the S and dP accumulators to the second products' A operands in
// registers.  Every other operand comes from shared memory by ldmatrix:
// X's rows as A, Y's rows as B of S and dP, and Y's columns (Q for dK, dO
// for dV, K for dQ) as B through ldmatrix's transpose.  Tiles are rows of
// 64 or 128 bf16 with their 16-byte chunks XOR-swizzled by the row's low
// three bits, so both kinds of ldmatrix read eight rows without a bank
// conflict.  Columns past D are zero in every tile and rows past S
// zero-filled by the copies, so each product runs over the template's 64
// or 128 columns with no test per tile.
//
// Layout: q, k, v, dO, dq, dk, dv [B, H, S, D] given by element strides
// (batch, head, sequence; the head-dim stride must be 1), so the model's
// [B, S, H, D] views are read and written in place; every other stride of
// q, k, v and dO (of a dimension longer than 1) must be a multiple of 8
// elements and each base 16-byte aligned (16-byte copies).  lse and the
// delta scratch are fp32 [B, Hq, S] contiguous, O fp32 [B, Hq, S, D]
// contiguous, the shares of dK and dV fp32 [group, B, Hkv, S, D]
// contiguous.  Any S (the ragged last tile is masked), D <= 128 with
// D % 8 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 64;          // rows of the fixed tiles (16 a warp)
constexpr int BY = 32;          // rows of the streamed tiles
constexpr int NT = 128;         // threads per block (4 warps)
constexpr int DELTA_ROWS = 32;  // rows per block of launch 1
constexpr int MAX_D = 128;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct View {
  long long b, h, s;            // element strides; the head dim's is 1
};

struct Views {
  View q, k, v, dout, dq, dk, dv;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte chunk `ch` of row `r` in a tile of rows of DP bf16.
template <int DP>
__device__ __forceinline__ uint32_t chunk_at(int r, int ch) {
  return r * (DP * 2) + ((ch ^ (r & 7)) << 4);
}

// Four 8 x 8 bf16 matrices from shared memory, each lane giving one row
// address; with ``trans`` each matrix arrives transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments (bf16 hi and lo) of the accumulator pair c0, c1 (n tiles
// 2kk and 2kk + 1 of an m16n8 product): rows g and g + 8, k 2t, 2t + 1 from
// c0 and k 8 + 2t, 9 + 2t from c1.
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* src[4] = {c0, c0 + 2, c1, c1 + 2};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(src[i][0], src[i][1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = bits(h);
    lo[i] = bits(__floats2bfloat162_rn(src[i][0] - hf.x, src[i][1] - hf.y));
  }
}

// Copy rows [r0, r0 + R) of one head (D columns, 8 per chunk) into a tile;
// rows at or past S are zero-filled.
template <int DP>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src,
                                          long long ss, int r0, int R, int S,
                                          int D) {
  const int per_row = D / 8;
  for (int e = threadIdx.x; e < R * per_row; e += NT) {
    const int r = e / per_row, c = e - r * per_row;
    const bool ok = r0 + r < S;
    cp_async16(dst + chunk_at<DP>(r, c),
               src + (ok ? (long long)(r0 + r) * ss : 0) + 8 * c, ok);
  }
}

// Launch 1: delta = rowsum(dO o O), 8 lanes per row of [B, Hq, S], O fp32
// contiguous, dO bf16 strided (4 columns a lane a step).
__global__ void __launch_bounds__(DELTA_ROWS * 8)
bwd_delta(const float* __restrict__ o, const bf16* __restrict__ dout,
          float* __restrict__ delta, int Hq, int S, int D, Views st,
          long long rows) {
  const long long row =
      (long long)blockIdx.x * DELTA_ROWS + (threadIdx.x >> 3);
  const int l = threadIdx.x & 7;
  float acc = 0.f;
  if (row < rows) {
    const int i = (int)(row % S);
    const long long bh = row / S;
    const int h = (int)(bh % Hq), b = (int)(bh / Hq);
    const float* orow = o + row * D;
    const bf16* drow = dout + b * st.dout.b + h * st.dout.h + i * st.dout.s;
    for (int c = 4 * l; c < D; c += 32) {
      const float4 x = *reinterpret_cast<const float4*>(orow + c);
      const uint2 y = *reinterpret_cast<const uint2*>(drow + c);
      const float2 y01 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y.x));
      const float2 y23 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y.y));
      acc = fmaf(x.x, y01.x, acc);
      acc = fmaf(x.y, y01.y, acc);
      acc = fmaf(x.z, y23.x, acc);
      acc = fmaf(x.w, y23.y, acc);
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (l == 0 && row < rows) delta[row] = acc;
}

template <int DP>
struct Smem {
  static constexpr int ROW = DP * 2;                   // bytes a row
  static constexpr int X = BX * ROW;                   // one X tile
  static constexpr int Y = BY * ROW;                   // one Y tile
  static constexpr int BYTES = 2 * X + 2 * 2 * Y + 2 * 2 * BY * 4;
};

// One X tile's work: its dK and dV (DKV) or its dQ; see the header.
template <int DP, bool DKV>
__device__ __forceinline__ void x_tile(
    uint8_t* smem, int xt, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ out1,
    bf16* __restrict__ out2, float* __restrict__ pdk,
    float* __restrict__ pdv, int group, int S, int D, const Views& st,
    int causal, int window, float scale) {
  using L = Smem<DP>;
  constexpr int NJ = BY / 8;            // n8 tiles of S and dP
  constexpr int NO = DP / 8;            // n8 tiles of an output row block
  const uint32_t sX1 = smem_u32(smem), sX2 = sX1 + L::X;
  const uint32_t sY = sX2 + L::X;       // stage s: Y1 at sY + 2 s Y, Y2 + Y
  float* sL = reinterpret_cast<float*>(smem + 2 * L::X + 4 * L::Y);
  float* sD = sL + 2 * BY;              // [2][BY] each: lse (base 2), delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y, Hkv = Hq / group;
  const int kvh = h / group;
  const int r0 = warp * 16;
  const int x0 = xt * BX;
  const long long row0 = ((long long)b * Hq + h) * S;  // of lse and delta
  const float scale_log2 = scale * LOG2E;

  // Each lane's ldmatrix rows: A of X and B^T of Y read rows R + (lane &
  // 15), chunk C + (lane >> 4); B of Y reads rows R + (lane & 7) + 8 (lane
  // >> 4), chunk C + ((lane >> 3) & 1).  R is a multiple of 8, so the
  // swizzle of the row is the lane's own.
  const int ra = lane & 15, ca = lane >> 4;
  const int rb = (lane & 7) + ((lane >> 4) << 3), cb = (lane >> 3) & 1;

  const bf16* qb = q + b * st.q.b + h * st.q.h;
  const bf16* db = dout + b * st.dout.b + h * st.dout.h;
  const bf16* kb = k + b * st.k.b + kvh * st.k.h;
  const bf16* vb = v + b * st.v.b + kvh * st.v.h;
  const bf16 *x1 = DKV ? kb : qb, *x2 = DKV ? vb : db;
  const bf16 *y1 = DKV ? qb : kb, *y2 = DKV ? db : vb;
  const long long x1s = DKV ? st.k.s : st.q.s, x2s = DKV ? st.v.s : st.dout.s;
  const long long y1s = DKV ? st.q.s : st.k.s, y2s = DKV ? st.dout.s : st.v.s;

  // Chunks [D / 8, DP / 8) are never copied: zero them in every tile (the
  // products run over all DP columns).
  if (D < DP) {
    const int w = (DP - D) / 8;
    for (int e = tid; e < (2 * BX + 4 * BY) * w; e += NT) {
      const int r = e / w;
      const uint32_t at = sX1 + chunk_at<DP>(r, D / 8 + e % w);
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at),
                   "r"(0)
                   : "memory");
    }
  }

  // The Y tiles that the mask keeps.
  const int ny = (S + BY - 1) / BY;
  const int x_last = min(x0 + BX, S) - 1;
  int yt_begin, yt_end;
  if (DKV) {                            // the query tiles that see these keys
    yt_begin = causal ? x0 / BY : 0;
    yt_end = window > 0 ? min(ny, (x_last + window - 1) / BY + 1) : ny;
  } else {                              // the key tiles these queries see
    yt_end = causal ? x_last / BY + 1 : ny;
    yt_begin = window > 0 ? max(x0 - window + 1, 0) / BY : 0;
  }

  // Y tile yt into stage s: its two tiles by cp.async and, for dK/dV
  // blocks, its queries' lse (in base-2 units) and delta.
  auto load_y = [&](int yt, int s) {
    const int y0 = yt * BY;
    copy_tile<DP>(sY + 2 * s * L::Y, y1, y1s, y0, BY, S, D);
    copy_tile<DP>(sY + (2 * s + 1) * L::Y, y2, y2s, y0, BY, S, D);
    if (DKV && tid < BY) {
      const bool in = y0 + tid < S;
      sL[s * BY + tid] = in ? lse[row0 + y0 + tid] * LOG2E : 0.f;
      sD[s * BY + tid] = in ? delta[row0 + y0 + tid] : 0.f;
    }
  };

  copy_tile<DP>(sX1, x1, x1s, x0, BX, S, D);
  copy_tile<DP>(sX2, x2, x2s, x0, BX, S, D);
  if (yt_begin < yt_end) load_y(yt_begin, 0);
  cp_async_commit();

  // dQ: the row statistics of the warp's two rows, in registers.
  float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  if (!DKV) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int x = x0 + r0 + g + 8 * i;
      if (x < S) {
        rl[i] = lse[row0 + x] * LOG2E;
        rd[i] = delta[row0 + x];
      }
    }
  }

  float o1[NO][4], o2[NO][4];           // o2: dV (dK/dV blocks only)
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o1[n][e] = o2[n][e] = 0.f;

  for (int yt = yt_begin; yt < yt_end; ++yt) {
    const int y0 = yt * BY, stage = (yt - yt_begin) & 1;
    // The next tile's copies go out before this one's products.
    if (yt + 1 < yt_end) load_y(yt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                 // this tile's (and X's) copies
    __syncthreads();
    const uint32_t sY1 = sY + 2 * stage * L::Y, sY2 = sY1 + L::Y;

    // S = X1 Y1^T and dP = X2 Y2^T for the warp's 16 rows.
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t a1[4], a2[4];
      ldsm_x4(a1, sX1 + chunk_at<DP>(r0 + ra, 2 * ks + ca));
      ldsm_x4(a2, sX2 + chunk_at<DP>(r0 + ra, 2 * ks + ca));
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        uint32_t b1[4], b2[4];
        ldsm_x4(b1, sY1 + chunk_at<DP>(16 * jj + rb, 2 * ks + cb));
        ldsm_x4(b2, sY2 + chunk_at<DP>(16 * jj + rb, 2 * ks + cb));
        mma_bf16(s[2 * jj], a1, b1[0], b1[1]);
        mma_bf16(s[2 * jj + 1], a1, b1[2], b1[3]);
        mma_bf16(dp[2 * jj], a2, b2[0], b2[1]);
        mma_bf16(dp[2 * jj + 1], a2, b2[2], b2[3]);
      }
    }

    // P and dS on the fragments: element e of tile j is X row
    // r0 + g + 8 (e >> 1), Y row 8 j + 2 t + (e & 1).  A pair of tiles
    // that the mask keeps whole skips the test.
    const int q_lo = DKV ? y0 : x0, q_hi = (DKV ? y0 + BY : x0 + BX) - 1;
    const int k_lo = DKV ? x0 : y0, k_hi = (DKV ? x0 + BX : y0 + BY) - 1;
    const bool whole = q_hi < S && k_hi < S && (!causal || q_lo >= k_hi) &&
                       (window <= 0 || q_hi - k_lo < window);
    const float* tl = sL + stage * BY;
    const float* td = sD + stage * BY;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = x0 + r0 + g + 8 * (e >> 1);
        const int yl = 8 * j + 2 * t + (e & 1);
        const int qp = DKV ? y0 + yl : x, kp = DKV ? x : y0 + yl;
        bool live = whole || (qp < S && kp < S);
        if (!whole && causal) live = live && qp >= kp;
        if (!whole && window > 0) live = live && qp - kp < window;
        const float l2 = DKV ? tl[yl] : rl[e >> 1];
        const float dl = DKV ? td[yl] : rd[e >> 1];
        const float p = live ? ex2(s[j][e] * scale_log2 - l2) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl);
      }

    // dK += dS^T Q and dV += P^T dO (dK/dV blocks), dQ += dS K (dQ
    // blocks): A from the accumulators, split; B = Y's columns.
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t dh[4], dl[4];
      split_a(dp[2 * kk], dp[2 * kk + 1], dh, dl);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bq[4];
        ldsm_x4_t(bq, sY1 + chunk_at<DP>(16 * kk + ra, n + ca));
        mma_bf16(o1[n], dl, bq[0], bq[1]);
        mma_bf16(o1[n + 1], dl, bq[2], bq[3]);
        mma_bf16(o1[n], dh, bq[0], bq[1]);
        mma_bf16(o1[n + 1], dh, bq[2], bq[3]);
      }
      if constexpr (DKV) {
        uint32_t ph[4], pl[4];
        split_a(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bo[4];
          ldsm_x4_t(bo, sY2 + chunk_at<DP>(16 * kk + ra, n + ca));
          mma_bf16(o2[n], pl, bo[0], bo[1]);
          mma_bf16(o2[n + 1], pl, bo[2], bo[3]);
          mma_bf16(o2[n], ph, bo[0], bo[1]);
          mma_bf16(o2[n + 1], ph, bo[2], bo[3]);
        }
      }
    }
    __syncthreads();                    // every warp is done with this stage
  }
  cp_async_wait<0>();

  // Element (n, e): row x0 + r0 + g + 8 (e >> 1), column 8 n + 2 t + (e & 1).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int x = x0 + r0 + g + 8 * i;
    if (x >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = 8 * n + 2 * t;
      if (c >= D) continue;             // D % 8 == 0: c + 1 < D too
      const float a0 = o1[n][2 * i], a1 = o1[n][2 * i + 1];
      if (!DKV) {
        *reinterpret_cast<__nv_bfloat162*>(
            out1 + b * st.dq.b + h * st.dq.h + (long long)x * st.dq.s + c) =
            __floats2bfloat162_rn(a0 * scale, a1 * scale);
      } else if (group == 1) {
        *reinterpret_cast<__nv_bfloat162*>(
            out1 + b * st.dk.b + kvh * st.dk.h + (long long)x * st.dk.s + c) =
            __floats2bfloat162_rn(a0 * scale, a1 * scale);
        *reinterpret_cast<__nv_bfloat162*>(
            out2 + b * st.dv.b + kvh * st.dv.h + (long long)x * st.dv.s + c) =
            __floats2bfloat162_rn(o2[n][2 * i], o2[n][2 * i + 1]);
      } else {  // scratch [group, B, Hkv, S, D], contiguous
        const long long off =
            ((((long long)(h % group) * gridDim.z + b) * Hkv + kvh) * S + x) *
                D + c;
        *reinterpret_cast<float2*>(pdk + off) =
            make_float2(a0 * scale, a1 * scale);
        *reinterpret_cast<float2*>(pdv + off) =
            make_float2(o2[n][2 * i], o2[n][2 * i + 1]);
      }
    }
  }
}

// Launch 2: blocks 2i take key tile i (dK, dV) and blocks 2i + 1 a query
// tile (dQ), the last first when causal, so that the heaviest tiles of both
// kinds start first and the light ones fill the card behind them.
template <int DP>
__global__ void __launch_bounds__(NT)
bwd_tiles(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, bf16* __restrict__ dk,
          bf16* __restrict__ dv, float* __restrict__ pdk,
          float* __restrict__ pdv, int group, int S, int D, Views st,
          int causal, int window, float scale) {
  extern __shared__ uint4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int i = blockIdx.x >> 1, nx = gridDim.x >> 1;
  if ((blockIdx.x & 1) == 0)
    x_tile<DP, true>(smem, i, q, k, v, dout, lse, delta, dk, dv, pdk, pdv,
                     group, S, D, st, causal, window, scale);
  else
    x_tile<DP, false>(smem, causal ? nx - 1 - i : i, q, k, v, dout, lse,
                      delta, dq, nullptr, nullptr, nullptr, group, S, D, st,
                      causal, window, scale);
}

// Launch 2b (group > 1): dk and dv as the sums of the group's shares, added
// in head order and rounded to bf16 once; one thread per element pair of
// [B, Hkv, S, D].
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

int smem_bytes(int D) { return D <= 64 ? Smem<64>::BYTES : Smem<128>::BYTES; }

View view(const long long* st, int t) { return {st[3 * t], st[3 * t + 1],
                                                st[3 * t + 2]}; }

template <int DP>
int launch_tiles(const bf16* q, const bf16* k, const bf16* v,
                 const bf16* dout, const float* lse, const float* delta,
                 bf16* dq, bf16* dk, bf16* dv, float* pdk, float* pdv, int B,
                 int Hq, int group, int S, int D, const Views& st, int causal,
                 int window, float scale, cudaStream_t stream) {
  const int smem = Smem<DP>::BYTES;
  const int Hkv = Hq / group;
  const long long n = (long long)B * Hkv * S * D;
  // Above 48 KB a kernel must opt in to dynamic shared memory, per device,
  // so on every call.
  cudaError_t e = cudaFuncSetAttribute(
      bwd_tiles<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bwd_tiles<DP><<<dim3(2 * ((S + BX - 1) / BX), Hq, B), NT, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, pdk, pdv, group, S, D, st,
      causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || group == 1) return (int)e;
  bwd_dkv_sum<<<(unsigned)((n / 2 + 255) / 256), 256, 0, stream>>>(
      pdk, pdv, dk, dv, group, Hkv, S, D, st, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 21 element strides, (batch, head, sequence) for q, k, v, dout,
// dq, dk, dv in that order.  bf16 q, k, v, dout, dq, dk, dv; o (the
// forward's output before its rounding) fp32 [B, Hq, S, D] contiguous; lse
// and the delta scratch fp32 [B, Hq, S] contiguous (delta is written
// here); when Hq > Hkv the scratch `shares` holds 2 x [Hq / Hkv, B, Hkv, S,
// D] fp32 (dK's shares, then dV's), else it is not read.  window <= 0
// means no window.  Returns the first CUDA error of the launches (0 on
// success).
int odin_flash_attention_bwd_bf16(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  void* delta, void* shares, void* dq,
                                  void* dk, void* dv, int B, int Hq, int Hkv,
                                  int S, int D, const long long* strides,
                                  int causal, int window, float scale,
                                  void* stream_) {
  if (D <= 0 || D > MAX_D || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const Views st{view(strides, 0), view(strides, 1), view(strides, 2),
                 view(strides, 3), view(strides, 4), view(strides, 5),
                 view(strides, 6)};
  const int group = Hq / Hkv;
  const bf16* bq = static_cast<const bf16*>(q);
  const bf16* bk = static_cast<const bf16*>(k);
  const bf16* bv = static_cast<const bf16*>(v);
  const bf16* bdo = static_cast<const bf16*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);

  const long long rows = (long long)B * Hq * S;
  bwd_delta<<<(unsigned)((rows + DELTA_ROWS - 1) / DELTA_ROWS),
              DELTA_ROWS * 8, 0, stream>>>(static_cast<const float*>(o), bdo,
                                           fdelta, Hq, S, D, st, rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long n = (long long)B * Hkv * S * D;
  float* pdk = static_cast<float*>(shares);
  float* pdv = group > 1 ? pdk + group * n : nullptr;
  auto run = D <= 64 ? launch_tiles<64> : launch_tiles<128>;
  return run(bq, bk, bv, bdo, flse, fdelta, static_cast<bf16*>(dq),
             static_cast<bf16*>(dk), static_cast<bf16*>(dv), pdk, pdv, B, Hq,
             group, S, D, st, causal, window, scale, stream);
}

// Dynamic shared memory of launch 2 at head dim D.
int odin_flash_attention_bwd_bf16_smem_bytes(int D) { return smem_bytes(D); }

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
