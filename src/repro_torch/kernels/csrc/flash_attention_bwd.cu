// Flash attention backward for Hopper (sm_90a) in fp32, plain C interface.
//
// The gradient of the port's K1 forward (flash_attention.cu, which replaces
// the TPU kernel src/repro/kernels/flash_attention.py::flash_attention).
// The JAX package has no Pallas backward: it differentiates its jnp
// attention.  This is FlashAttention-2's backward, written for this card:
// from q, k, v, the forward's output o, the incoming gradient dO and the
// row log-sum-exp lse that the forward saved (odin_flash_attention_fwd_lse)
// it rebuilds each probability tile P = exp(s * scale - lse) on chip and
// never writes an S x S matrix to device memory:
//
//   delta = rowsum(dO o O)                          (launch 1)
//   dS    = P o (dO V^T - delta)
//   dV    = P^T dO,  dK = scale dS^T Q              (launch 2; 2b)
//   dQ    = scale dS K                              (launch 2)
//
// Launch 2 holds two kinds of block, one template (x_tile).  A block holds
// a fixed tile X of 64 rows, 16 a warp, and streams tiles Y of 32 rows
// past it:
//
//   dK/dV blocks: X = K, V of 64 keys; Y = Q, dO of 32 queries; they
//     compute S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//     dK += dS^T Q, and keep dK and dV in mma fragments;
//   dQ blocks: X = Q, dO of 64 queries; Y = K, V of 32 keys; S = Q K^T,
//     dP = dO V^T, then dQ += dS K (S and dP recomputed rather than dQ
//     summed across blocks).
//
// The two kinds share no output, so they run side by side in one launch,
// block 2i a dK/dV block and 2i + 1 a dQ block, the heaviest tiles of each
// (key tile 0, the last query tile, under a causal mask) first: the light
// blocks fill the card behind the heavy ones, which as two launches each set
// their launch's time alone. One block per (X tile, query head, batch) and
// kind. Under GQA (group > 1) each dK/dV block writes its head's share of dK
// and dV to a scratch [group, B, Hkv, S, D], and launch 2b adds the group's
// shares in head order; no atomics, so two calls give the same bits. Masks
// are the forward's (causal, qp - kp < window, bidirectional); only the Y
// tiles the mask keeps are visited.  Launch 1 takes 8 lanes per row, with
// 16-byte loads where the rows allow them.
//
// What bounds it on an H100: operations.  It needs five products of
// pairs x D (2 * 5 * B * Hq * pairs * D operations) and executes seven,
// tile-granular, over D padded to the template's 64 or 128 columns.  All
// of them run on the tensor cores, mma.sync m16n8k8 with TF32 operands and
// fp32 accumulators, in the 3xTF32 split of the forward (x = hi + lo, both
// TF32 by cvt.rna; a product is lo.hi + hi.lo + hi.hi, small terms first):
// one TF32 product keeps 11 bits and misses the fp32 limits, the split
// carries about 22.  Three TF32 products bound the fp32-exact work at about
// 165 TFLOP/s, against 67 on the CUDA cores; mma.sync itself reaches about
// 300 of the 495 TFLOP/s of TF32 on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/k1_fp32_variants.py --mma-rate), so about 100 TFLOP/s of fp32
// products is this design's ceiling.
//
// Tiles: X and Y land by 16-byte cp.async copies, rows past S zero-filled
// and columns past D zero, so every product runs over all 64 or 128
// columns with no test per tile; the thread that copied a piece splits it
// once it lands, hi in place and lo into the tile's lo buffer.  A Y tile
// takes two block barriers: one before its copies (the last tile's products
// are done), one after its split.  As in the forward, the k index of every
// product is permuted so that slot t of a thread's pair is column 2t and
// slot t + 4 column 2t + 1: A fragments of X and B fragments of Y^T are
// adjacent pairs of a shared row, and the accumulator fragments of S^T / S
// and of dS are already the A fragments of the second products, which take
// Y's columns as B (two scalar loads).  The shared tiles' XOR swizzle keeps
// both kinds of load free of bank conflicts, and each lane's swizzled
// offsets are computed once (Lanes, in tf32_mma.cuh with the rest of the
// 3xTF32 machinery), so every fragment load is a register plus an
// immediate.
//
// Measured (chip_smoke.py on the same card): 0.172 ms at q [8, 14, 256,
// 64], k/v [8, 2, 256, 64], causal (autograd's backward of fp32
// scaled_dot_product_attention: 0.227 ms), 0.303 ms at [1, 14, 1024, 64]
// (0.405 ms); about 70 TFLOP/s of TF32 products, a quarter of mma.sync's
// rate.  ptxas: 213 registers at width 64, no spills, 96 KB of dynamic
// shared memory (two blocks an SM); 255 registers and about 100-200 B of
// spills at 128.
//
// Not taken: rounding to TF32 by (bits + 0x1000) & ~0x1fff, two integer
// instructions where ptxas lowers cvt.rna.tf32.f32 to four with a test for
// inf and NaN, ran 4-5% faster on the same card (tools/k1_fp32_variants.py)
// but turns CUDA's canonical NaN 0x7fffffff into -0.
//
// Layout: every tensor [B, H, S, D] given by element strides (batch, head,
// sequence; the head-dim stride must be 1), so the model's [B, S, H, D]
// views are read and written in place; lse and the delta scratch are fp32
// [B, Hq, S] contiguous, the shares of dK and dV fp32 [group, B, Hkv, S, D]
// contiguous (scratch the wrapper allocates: twice q's size).  Any S (the
// ragged last tile is masked), D <= 128 with D % 4 == 0, fp32 inputs and
// accumulation.  Strides that are not multiples of 4 elements, or bases not
// 16-byte aligned, take 4-byte copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int BX = 64;          // rows of the fixed tiles (16 a warp)
constexpr int BY = 32;          // rows of the streamed tiles
constexpr int DELTA_ROWS = 32;  // rows per block of launch 1
constexpr int MAX_D = 128;

struct View {
  long long b, h, s;            // element strides; the head dim's is 1
};

struct Views {
  View q, k, v, o, dout, dq, dk, dv;
};

// a1 = X1 Y1^T and a2 = X2 Y2^T for the warp's 16 rows of X (from row R)
// and BY rows of Y, together: eight independent accumulators (each product
// alone has four, and the backward ran 1.03-1.07x slower so,
// tools/k1_fp32_variants.py).
template <int DPM>
__device__ __forceinline__ void product_xyt(
    float (&a1)[BY / 8][4], float (&a2)[BY / 8][4], const float* x1h,
    const float* x1l, const float* y1h, const float* y1l, const float* x2h,
    const float* x2l, const float* y2h, const float* y2l, const Lanes& L,
    int R) {
  constexpr int lds = DPM, N = BY / 8;
  float acc[2 * N][4];
#pragma unroll
  for (int j = 0; j < 2 * N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DPM / 8; ++ks) {
    uint32_t ah[2][4], al[2][4], bh[2 * N][2], bl[2 * N][2];
    frag_a(x1h, x1l, L, R, ks, lds, ah[0], al[0]);
    frag_a(x2h, x2l, L, R, ks, lds, ah[1], al[1]);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      frag_b_row(y1h, y1l, L, 8 * j, ks, lds, bh[j], bl[j]);
      frag_b_row(y2h, y2l, L, 8 * j, ks, lds, bh[N + j], bl[N + j]);
    }
#pragma unroll
    for (int j = 0; j < 2 * N; ++j) mma_tf32(acc[j], al[j / N], bh[j]);
#pragma unroll
    for (int j = 0; j < 2 * N; ++j) mma_tf32(acc[j], ah[j / N], bl[j]);
#pragma unroll
    for (int j = 0; j < 2 * N; ++j) mma_tf32(acc[j], ah[j / N], bh[j]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a1[j][e] = acc[j][e];
      a2[j][e] = acc[N + j][e];
    }
}

// out += A Y, A the warp's 16 x BY accumulator tile, Y [BY, DPM] split;
// eight head-dim tiles at a time.
template <int DPM>
__device__ __forceinline__ void product_ay(float (&out)[DPM / 8][4],
                                           const float (&a)[BY / 8][4],
                                           const float* yh, const float* yl,
                                           const Lanes& L) {
  constexpr int lds = DPM;
#pragma unroll
  for (int j = 0; j < BY / 8; ++j) {
    uint32_t ah[4], al[4];
    frag_acc(a[j], ah, al);
#pragma unroll
    for (int n0 = 0; n0 < DPM / 8; n0 += 8) {
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        frag_b_col(yh, yl, L, 8 * j, n0 + n, lds, bh[n], bl[n]);
      mma3<8>(out + n0, ah, al, bh, bl);
    }
  }
}

// Launch 1: delta = rowsum(dO o O), 8 lanes per row of [B, Hq, S], with
// 16-byte loads where the rows allow them (vec).
__global__ void __launch_bounds__(DELTA_ROWS * 8)
bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
          float* __restrict__ delta, int Hq, int S, int D, Views st,
          long long rows, int vec) {
  const long long row =
      (long long)blockIdx.x * DELTA_ROWS + (threadIdx.x >> 3);
  const int l = threadIdx.x & 7;
  float acc = 0.f;
  if (row < rows) {
    const int i = (int)(row % S);
    const long long bh = row / S;
    const int h = (int)(bh % Hq), b = (int)(bh / Hq);
    const float* orow = o + b * st.o.b + h * st.o.h + i * st.o.s;
    const float* drow = dout + b * st.dout.b + h * st.dout.h + i * st.dout.s;
    if (vec) {
      for (int c = 4 * l; c < D; c += 32) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = *reinterpret_cast<const float4*>(drow + c);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    } else {
      for (int c = l; c < D; c += 8) acc = fmaf(orow[c], drow[c], acc);
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (l == 0 && row < rows) delta[row] = acc;
}

// One X tile's work: its dK and dV (DKV) or its dQ; see the header.
template <int DPM, bool DKV>
__device__ __forceinline__ void x_tile(
    float* smem, int xt, const float* __restrict__ q,
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ out1,
    float* __restrict__ out2, float* __restrict__ pdk,
    float* __restrict__ pdv, int group, int S, int D, const Views& st,
    int causal, int window, float scale, int vec) {
  constexpr int lds = DPM;              // row stride of every tile
  float* sX1 = smem;                    // [BX] rows each, swizzled
  float* sX1l = sX1 + BX * lds;
  float* sX2 = sX1l + BX * lds;
  float* sX2l = sX2 + BX * lds;
  float* sY1 = sX2l + BX * lds;         // [BY] rows each
  float* sY1l = sY1 + BY * lds;
  float* sY2 = sY1l + BY * lds;
  float* sY2l = sY2 + BY * lds;
  float* sL = sY2l + BY * lds;          // [BY] lse of Y's queries (DKV)
  float* sD = sL + BY;                  // [BY] delta

  const int tid = threadIdx.x, warp = tid >> 5;
  const Lanes L(lds);
  const int g = L.g, t = L.t;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y, Hkv = Hq / group;
  const int kvh = h / group;
  const int r0 = warp * 16;
  const Pieces pieces(D, vec);
  const int x0 = xt * BX;
  const long long row0 = ((long long)b * Hq + h) * S;  // of lse and delta

  const float* qb = q + b * st.q.b + h * st.q.h;
  const float* db = dout + b * st.dout.b + h * st.dout.h;
  const float* kb = k + b * st.k.b + kvh * st.k.h;
  const float* vb = v + b * st.v.b + kvh * st.v.h;
  const float *x1 = DKV ? kb : qb, *x2 = DKV ? vb : db;
  const float *y1 = DKV ? qb : kb, *y2 = DKV ? db : vb;
  const long long x1s = DKV ? st.k.s : st.q.s, x2s = DKV ? st.v.s : st.dout.s;
  const long long y1s = DKV ? st.q.s : st.k.s, y2s = DKV ? st.dout.s : st.v.s;

  // Columns [D, DPM) are never copied: zero them in every tile (the
  // products run over all DPM columns).
  if (D < DPM) {
    const int w = DPM - D;
    for (int e = tid; e < (4 * BX + 4 * BY) * w; e += NT)
      smem[at(e / w, D + e % w, lds)] = 0.f;
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

  copy_tile(sX1, x1, x1s, x0, BX, S, lds, pieces);
  copy_tile(sX2, x2, x2s, x0, BX, S, lds, pieces);
  cp_async_commit();
  cp_async_wait<0>();
  split_tile(sX1, sX1l, BX, lds, pieces);
  split_tile(sX2, sX2l, BX, lds, pieces);

  // dQ: the row statistics of the warp's two rows, in registers.
  float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  if (!DKV) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int x = x0 + r0 + g + 8 * i;
      if (x < S) {
        rl[i] = lse[row0 + x];
        rd[i] = delta[row0 + x];
      }
    }
  }

  float o1[DPM / 8][4], o2[DPM / 8][4];   // o2: dV (launch 2 only)
#pragma unroll
  for (int n = 0; n < DPM / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o1[n][e] = o2[n][e] = 0.f;

  for (int yt = yt_begin; yt < yt_end; ++yt) {
    const int y0 = yt * BY;
    __syncthreads();                    // every warp is done with the last Y
    copy_tile(sY1, y1, y1s, y0, BY, S, lds, pieces);
    copy_tile(sY2, y2, y2s, y0, BY, S, lds, pieces);
    cp_async_commit();
    if (DKV && tid < BY) {
      const bool in = y0 + tid < S;
      sL[tid] = in ? lse[row0 + y0 + tid] : 0.f;
      sD[tid] = in ? delta[row0 + y0 + tid] : 0.f;
    }
    cp_async_wait<0>();
    split_tile(sY1, sY1l, BY, lds, pieces);
    split_tile(sY2, sY2l, BY, lds, pieces);
    __syncthreads();

    float s[BY / 8][4], dp[BY / 8][4];
    product_xyt<DPM>(s, dp, sX1, sX1l, sY1, sY1l, sX2, sX2l, sY2, sY2l, L,
                      r0);

    // P and dS on the fragments: element e of tile j is X row
    // r0 + g + 8 (e >> 1), Y row 8 j + 2 t + (e & 1).  A pair of tiles
    // that the mask keeps whole skips it.
    const int q_lo = DKV ? y0 : x0, q_hi = (DKV ? y0 + BY : x0 + BX) - 1;
    const int k_lo = DKV ? x0 : y0, k_hi = (DKV ? x0 + BX : y0 + BY) - 1;
    const bool whole = q_hi < S && k_hi < S && (!causal || q_lo >= k_hi) &&
                       (window <= 0 || q_hi - k_lo < window);
#pragma unroll
    for (int j = 0; j < BY / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = x0 + r0 + g + 8 * (e >> 1);
        const int yl = 8 * j + 2 * t + (e & 1);
        const int qp = DKV ? y0 + yl : x, kp = DKV ? x : y0 + yl;
        bool live = whole || (qp < S && kp < S);
        if (!whole && causal) live = live && qp >= kp;
        if (!whole && window > 0) live = live && qp - kp < window;
        const float ls = DKV ? sL[yl] : rl[e >> 1];
        const float dl = DKV ? sD[yl] : rd[e >> 1];
        const float p = live ? expf(s[j][e] * scale - ls) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl);
      }

    // dK += dS^T Q, dV += P^T dO (launch 2); dQ += dS K (launch 3).
    product_ay<DPM>(o1, dp, sY1, sY1l, L);
    if constexpr (DKV) product_ay<DPM>(o2, s, sY2, sY2l, L);
  }

  float *ob1, *ob2 = nullptr;
  long long s1, s2 = 0;
  if (!DKV) {
    ob1 = out1 + b * st.dq.b + h * st.dq.h;
    s1 = st.dq.s;
  } else if (group == 1) {
    ob1 = out1 + b * st.dk.b + kvh * st.dk.h;
    ob2 = out2 + b * st.dv.b + kvh * st.dv.h;
    s1 = st.dk.s;
    s2 = st.dv.s;
  } else {  // scratch [group, B, Hkv, S, D], contiguous
    const long long off =
        (((long long)(h % group) * gridDim.z + b) * Hkv + kvh) * S * D;
    ob1 = pdk + off;
    ob2 = pdv + off;
    s1 = s2 = D;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int x = x0 + r0 + g + 8 * i;
    if (x >= S) continue;
#pragma unroll
    for (int n = 0; n < DPM / 8; ++n) {
      const int c = 8 * n + 2 * t;
      if (c >= D) continue;             // D % 4 == 0: c + 1 < D too
      *reinterpret_cast<float2*>(ob1 + (long long)x * s1 + c) =
          make_float2(o1[n][2 * i] * scale, o1[n][2 * i + 1] * scale);
      if constexpr (DKV)
        *reinterpret_cast<float2*>(ob2 + (long long)x * s2 + c) =
            make_float2(o2[n][2 * i], o2[n][2 * i + 1]);
    }
  }
}

// Launch 2: blocks 2i take key tile i (dK, dV) and blocks 2i + 1 a query
// tile (dQ), the last first when causal, so that the heaviest tiles of both
// kinds start first and the light ones fill the card behind them.
template <int DPM>
__global__ void __launch_bounds__(NT)
bwd_tiles(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, float* __restrict__ dk,
          float* __restrict__ dv, float* __restrict__ pdk,
          float* __restrict__ pdv, int group, int S, int D, Views st,
          int causal, int window, float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int i = blockIdx.x >> 1, nx = gridDim.x >> 1;
  if ((blockIdx.x & 1) == 0)
    x_tile<DPM, true>(smem, i, q, k, v, dout, lse, delta, dk, dv, pdk, pdv,
                      group, S, D, st, causal, window, scale, vec);
  else
    x_tile<DPM, false>(smem, causal ? nx - 1 - i : i, q, k, v, dout, lse,
                       delta, dq, nullptr, nullptr, nullptr, group, S, D, st,
                       causal, window, scale, vec);
}

// Launch 2b (group > 1): dk and dv as the sums of the group's shares, added
// in head order; one thread per element of [B, Hkv, S, D].
__global__ void __launch_bounds__(256)
bwd_dkv_sum(const float* __restrict__ pdk, const float* __restrict__ pdv,
            float* __restrict__ dk, float* __restrict__ dv, int group,
            int Hkv, int S, int D, Views st, long long n) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % D);
  const long long row = i / D;
  const int s = (int)(row % S);
  const long long bh = row / S;
  const int h = (int)(bh % Hkv), b = (int)(bh / Hkv);
  float ak = 0.f, av = 0.f;
  for (int g = 0; g < group; ++g) {
    ak += pdk[g * n + i];
    av += pdv[g * n + i];
  }
  dk[b * st.dk.b + h * st.dk.h + (long long)s * st.dk.s + c] = ak;
  dv[b * st.dv.b + h * st.dv.h + (long long)s * st.dv.s + c] = av;
}

int smem_bytes(int D) {
  const int lds = D <= 64 ? 64 : 128;
  return ((4 * BX + 4 * BY) * lds + 2 * BY) * (int)sizeof(float);
}

View view(const long long* st, int t) { return {st[3 * t], st[3 * t + 1],
                                                st[3 * t + 2]}; }

bool copies16(const void* p, View s, int B, int H, int S) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         (B == 1 || s.b % 4 == 0) && (H == 1 || s.h % 4 == 0) &&
         (S == 1 || s.s % 4 == 0);
}

template <int DPM>
int launch_tiles(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, const float* delta,
                 float* dq, float* dk, float* dv, float* pdk, float* pdv,
                 int B, int Hq, int group, int S, int D, const Views& st,
                 int causal, int window, float scale, int vec,
                 cudaStream_t stream) {
  const int smem = smem_bytes(D);
  const int Hkv = Hq / group;
  const long long n = (long long)B * Hkv * S * D;
  // Above 48 KB a kernel must opt in to dynamic shared memory, per device,
  // so on every call.
  cudaError_t e = cudaFuncSetAttribute(
      bwd_tiles<DPM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bwd_tiles<DPM><<<dim3(2 * ((S + BX - 1) / BX), Hq, B), NT, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, pdk, pdv, group, S, D, st,
      causal, window, scale, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || group == 1) return (int)e;
  bwd_dkv_sum<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      pdk, pdv, dk, dv, group, Hkv, S, D, st, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 24 element strides, (batch, head, sequence) for q, k, v, o, dout,
// dq, dk, dv in that order.  float32 tensors; lse and the delta scratch
// fp32 [B, Hq, S] contiguous (delta is written here); when Hq > Hkv the
// scratch `shares` holds 2 x [Hq / Hkv, B, Hkv, S, D] fp32 (dK's shares,
// then dV's), else it is not read.  window <= 0 means no window.  Returns
// the first CUDA error of the launches (0 on success).
int odin_flash_attention_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const void* lse, void* delta, void* shares,
                             void* dq, void* dk, void* dv, int B, int Hq,
                             int Hkv, int S, int D, const long long* strides,
                             int causal, int window, float scale,
                             void* stream_) {
  if (D <= 0 || D > MAX_D || D % 4 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const Views st{view(strides, 0), view(strides, 1), view(strides, 2),
                 view(strides, 3), view(strides, 4), view(strides, 5),
                 view(strides, 6), view(strides, 7)};
  const int group = Hq / Hkv;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);
  const int vec = copies16(q, st.q, B, Hq, S) && copies16(k, st.k, B, Hkv, S) &&
                  copies16(v, st.v, B, Hkv, S) &&
                  copies16(dout, st.dout, B, Hq, S);

  const long long rows = (long long)B * Hq * S;
  const int vec_delta = copies16(o, st.o, B, Hq, S) &&
                        copies16(dout, st.dout, B, Hq, S);
  bwd_delta<<<(unsigned)((rows + DELTA_ROWS - 1) / DELTA_ROWS),
              DELTA_ROWS * 8, 0, stream>>>(static_cast<const float*>(o), fdo,
                                           fdelta, Hq, S, D, st, rows,
                                           vec_delta);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long n = (long long)B * Hkv * S * D;
  float* pdk = static_cast<float*>(shares);
  float* pdv = group > 1 ? pdk + group * n : nullptr;
  auto run = D <= 64 ? launch_tiles<64> : launch_tiles<128>;
  return run(fq, fk, fv, fdo, flse, fdelta, static_cast<float*>(dq),
             static_cast<float*>(dk), static_cast<float*>(dv), pdk, pdv, B,
             Hq, group, S, D, st, causal, window, scale, vec, stream);
}

// Dynamic shared memory of launch 2 at head dim D.
int odin_flash_attention_bwd_smem_bytes(int D) { return smem_bytes(D); }

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
