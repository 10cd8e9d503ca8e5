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
//   dV    = P^T dO,  dK = scale dS^T Q              (launches 2, 2b)
//   dQ    = scale dS K                              (launch 3)
//
// Launch 2 runs one block per (32-key tile, query head, batch): it loops
// over the query tiles that see its keys and keeps that head's share of dK
// and dV in registers.  Under GQA (group > 1) each block writes its share
// to a scratch [group, B, Hkv, S, D] and launch 2b adds the group's shares
// in head order; no atomics, so the result is deterministic.  (A block per
// kv head that looped over the group, the first design, had B x Hkv x S/32
// blocks -- 64 at qwen2-0.5b's heads over 1024 tokens, under one per SM --
// and took 2.6x as long there.)  Launch 3 runs one block per (64-row query
// tile, query head, batch) and loops over the live key tiles, as the
// forward does.  Masks are the forward's (causal, qp - kp < window,
// bidirectional), with the same tiles culled.
//
// What bounds it on an H100: operations.  It needs five products of
// pairs x D (S, dP, dV, dK, dQ; 2 * 5 * B * Hq * pairs * D operations) and
// executes seven (launch 3 recomputes S and dP rather than sum dQ across
// blocks), tile-granular, on the fp32 CUDA cores (67 TFLOP/s): TF32, the
// only tensor-core type that takes fp32 operands, keeps ~3 digits, and the
// JAX package's fp32 limit (2e-5) rules it out, as in the forward.  Bytes
// (q, k, v, o, dO, lse read once, dq, dk, dv written once) are a small
// share at S >= 256.  Simple and right first: register-tiled as the
// forward (4 x 2 scores and 4 x 8 or 2 x 8 x 2 accumulators a thread,
// float4 shared-memory reads), no tensor cores.
//
// Layout: every tensor [B, H, S, D] given by element strides (batch, head,
// sequence; the head-dim stride must be 1), so the model's [B, S, H, D]
// views are read and written in place; lse and the delta scratch are fp32
// [B, Hq, S] contiguous, the shares of dK and dV fp32 [group, B, Hkv, S, D]
// contiguous (scratch the wrapper allocates: twice q's size).  Any S (the ragged last tile is masked),
// D <= 128 with D % 4 == 0, fp32 inputs and accumulation.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 32;          // keys per tile
constexpr int NT = 256;         // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int LDP = BK + 4;     // row stride of the P and dS tiles
constexpr int MAX_D = 128;

struct View {
  long long b, h, s;            // element strides; the head dim's is 1
};

struct Views {
  View q, k, v, o, dout, dq, dk, dv;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [r0, r0 + R) of one head into a shared tile with row stride ld;
// rows at or beyond S are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int r0, int R, int S,
                                          int D, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += NW) {
    const int row = r0 + r;
    const float* s = src + (long long)row * ss;
    for (int c = lane; c < D; c += 32) dst[r * ld + c] = row < S ? s[c] : 0.f;
  }
}

__device__ __forceinline__ bool live(int qp, int kp, int S, int causal,
                                     int window) {
  bool ok = qp < S && kp < S;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && qp - kp < window;
  return ok;
}

// The row statistics of a query tile: lse and delta into shared memory.
__device__ __forceinline__ void load_rows(float* sL, float* sD,
                                          const float* lse,
                                          const float* delta, long long row0,
                                          int q0, int S) {
  const int t = threadIdx.x;
  if (t < BQ) {
    const bool in = q0 + t < S;
    sL[t] = in ? lse[row0 + q0 + t] : 0.f;
    sD[t] = in ? delta[row0 + q0 + t] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for thread (ty, tx)'s rows ty + 16 i and keys
// tx + 16 j, then P = exp(S scale - lse) (0 where masked) and
// dS = P (dP - delta).
__device__ __forceinline__ void scores(const float* sQ, const float* sdO,
                                       const float* sK, const float* sV,
                                       const float* sL, const float* sD,
                                       int D, int ld, int q0, int k0, int S,
                                       int causal, int window, float scale,
                                       float p[4][2], float ds[4][2]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sc[4][2], dp[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) sc[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 a[4], e[4], c[2], w[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * ld + d]);
      e[i] = *reinterpret_cast<const float4*>(&sdO[(ty + 16 * i) * ld + d]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      c[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * ld + d]);
      w[j] = *reinterpret_cast<const float4*>(&sV[(tx + 16 * j) * ld + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s = sc[i][j], t = dp[i][j];
        s = fmaf(a[i].x, c[j].x, s);
        s = fmaf(a[i].y, c[j].y, s);
        s = fmaf(a[i].z, c[j].z, s);
        s = fmaf(a[i].w, c[j].w, s);
        t = fmaf(e[i].x, w[j].x, t);
        t = fmaf(e[i].y, w[j].y, t);
        t = fmaf(e[i].z, w[j].z, t);
        t = fmaf(e[i].w, w[j].w, t);
        sc[i][j] = s;
        dp[i][j] = t;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = ty + 16 * i;
      const float pr = live(q0 + r, k0 + tx + 16 * j, S, causal, window)
                           ? expf(sc[i][j] * scale - sL[r])
                           : 0.f;
      p[i][j] = pr;
      ds[i][j] = pr * (dp[i][j] - sD[r]);
    }
}

// Launch 1: delta = rowsum(dO o O), one warp per row of [B, Hq, S].
__global__ void __launch_bounds__(NT)
bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
          float* __restrict__ delta, int Hq, int S, int D, Views st,
          long long rows) {
  const long long row = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = (int)(row % S);
  const long long bh = row / S;
  const int h = (int)(bh % Hq), b = (int)(bh / Hq);
  const float* orow = o + b * st.o.b + h * st.o.h + i * st.o.s;
  const float* drow = dout + b * st.dout.b + h * st.dout.h + i * st.dout.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(orow[c], drow[c], acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// Launch 2: one query head's share of dK and dV of one 32-key tile: into
// dk and dv when group == 1, else into the scratch pdk, pdv.
__global__ void __launch_bounds__(NT)
bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv,
        float* __restrict__ pdk, float* __restrict__ pdv, int group, int S,
        int D, Views st, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4;  // D % 4 == 0, so every tile row is 16 B aligned
  float* sK = smem;             // [BK][ld]
  float* sV = sK + BK * ld;     // [BK][ld]
  float* sQ = sV + BK * ld;     // [BQ][ld]
  float* sdO = sQ + BQ * ld;    // [BQ][ld]
  float* sP = sdO + BQ * ld;    // [BQ][LDP] probabilities
  float* sS = sP + BQ * LDP;    // [BQ][LDP] dS
  float* sL = sS + BQ * LDP;    // [BQ] lse
  float* sD = sL + BQ;          // [BQ] delta

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group, g = h % group;
  const int Hq = gridDim.y, Hkv = Hq / group;

  load_tile(sK, k + b * st.k.b + kvh * st.k.h, st.k.s, k0, BK, S, D, ld);
  load_tile(sV, v + b * st.v.b + kvh * st.v.h, st.v.s, k0, BK, S, D, ld);

  // The query tiles that see this key tile.
  const int nq = (S + BQ - 1) / BQ;
  const int k_last = min(k0 + BK, S) - 1;
  const int qt_begin = causal ? k0 / BQ : 0;
  const int qt_end =
      window > 0 ? min(nq, (k_last + window - 1) / BQ + 1) : nq;

  // Thread owns keys ty + 16 jk and head-dim columns 4 tx + 64 jj .. + 3.
  float akk[2][8], avv[2][8];
#pragma unroll
  for (int jk = 0; jk < 2; ++jk)
#pragma unroll
    for (int e = 0; e < 8; ++e) akk[jk][e] = avv[jk][e] = 0.f;

  const float* qb = q + b * st.q.b + h * st.q.h;
  const float* db = dout + b * st.dout.b + h * st.dout.h;
  const long long row0 = ((long long)b * Hq + h) * S;
  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile is done with sQ .. sD
    load_tile(sQ, qb, st.q.s, q0, BQ, S, D, ld);
    load_tile(sdO, db, st.dout.s, q0, BQ, S, D, ld);
    load_rows(sL, sD, lse, delta, row0, q0, S);
    __syncthreads();

    float p[4][2], ds[4][2];
    scores(sQ, sdO, sK, sV, sL, sD, D, ld, q0, k0, S, causal, window,
           scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p[i][j];
        sS[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the tile's 64 rows.
    for (int r = 0; r < BQ; ++r) {
      float pk[2], sk[2];
#pragma unroll
      for (int jk = 0; jk < 2; ++jk) {
        pk[jk] = sP[r * LDP + ty + 16 * jk];
        sk[jk] = sS[r * LDP + ty + 16 * jk];
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = 4 * tx + 64 * jj;
        if (c >= D) continue;
        const float4 o4 = *reinterpret_cast<const float4*>(&sdO[r * ld + c]);
        const float4 q4 = *reinterpret_cast<const float4*>(&sQ[r * ld + c]);
#pragma unroll
        for (int jk = 0; jk < 2; ++jk) {
          avv[jk][4 * jj + 0] = fmaf(pk[jk], o4.x, avv[jk][4 * jj + 0]);
          avv[jk][4 * jj + 1] = fmaf(pk[jk], o4.y, avv[jk][4 * jj + 1]);
          avv[jk][4 * jj + 2] = fmaf(pk[jk], o4.z, avv[jk][4 * jj + 2]);
          avv[jk][4 * jj + 3] = fmaf(pk[jk], o4.w, avv[jk][4 * jj + 3]);
          akk[jk][4 * jj + 0] = fmaf(sk[jk], q4.x, akk[jk][4 * jj + 0]);
          akk[jk][4 * jj + 1] = fmaf(sk[jk], q4.y, akk[jk][4 * jj + 1]);
          akk[jk][4 * jj + 2] = fmaf(sk[jk], q4.z, akk[jk][4 * jj + 2]);
          akk[jk][4 * jj + 3] = fmaf(sk[jk], q4.w, akk[jk][4 * jj + 3]);
        }
      }
    }
  }

  float *dkb, *dvb;
  long long ssk, ssv;
  if (group == 1) {
    dkb = dk + b * st.dk.b + kvh * st.dk.h;
    dvb = dv + b * st.dv.b + kvh * st.dv.h;
    ssk = st.dk.s;
    ssv = st.dv.s;
  } else {  // scratch [group, B, Hkv, S, D], contiguous
    const long long off = (((long long)g * gridDim.z + b) * Hkv + kvh) * S * D;
    dkb = pdk + off;
    dvb = pdv + off;
    ssk = ssv = D;
  }
#pragma unroll
  for (int jk = 0; jk < 2; ++jk) {
    const int kp = k0 + ty + 16 * jk;
    if (kp >= S) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dkb[(long long)kp * ssk + c + e] = akk[jk][4 * jj + e] * scale;
        dvb[(long long)kp * ssv + c + e] = avv[jk][4 * jj + e];
      }
    }
  }
}

// Launch 2b (group > 1): dk and dv as the sums of the group's shares, added
// in head order; one thread per element of [B, Hkv, S, D].
__global__ void __launch_bounds__(NT)
bwd_dkv_sum(const float* __restrict__ pdk, const float* __restrict__ pdv,
            float* __restrict__ dk, float* __restrict__ dv, int group,
            int Hkv, int S, int D, Views st, long long n) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
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

// Launch 3: dQ of one 64-row query tile of one query head.
__global__ void __launch_bounds__(NT)
bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       float* __restrict__ dq, int group, int S, int D, Views st, int causal,
       int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4;
  float* sQ = smem;             // [BQ][ld]
  float* sdO = sQ + BQ * ld;    // [BQ][ld]
  float* sK = sdO + BQ * ld;    // [BK][ld]
  float* sV = sK + BK * ld;     // [BK][ld]
  float* sS = sV + BK * ld;     // [BQ][LDP] dS
  float* sL = sS + BQ * LDP;    // [BQ] lse
  float* sD = sL + BQ;          // [BQ] delta

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const float* kb = k + b * st.k.b + kvh * st.k.h;
  const float* vb = v + b * st.v.b + kvh * st.v.h;

  load_tile(sQ, q + b * st.q.b + h * st.q.h, st.q.s, q0, BQ, S, D, ld);
  load_tile(sdO, dout + b * st.dout.b + h * st.dout.h, st.dout.s, q0, BQ, S,
            D, ld);
  load_rows(sL, sD, lse, delta, ((long long)b * gridDim.y + h) * S, q0, S);

  // The live key tiles, as the forward culls them.
  const int nk = (S + BK - 1) / BK;
  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_end = causal ? q_last / BK + 1 : nk;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    if (lo > 0) kt_begin = lo / BK;
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is done with sK, sV and sS
    load_tile(sK, kb, st.k.s, k0, BK, S, D, ld);
    load_tile(sV, vb, st.v.s, k0, BK, S, D, ld);
    __syncthreads();

    float p[4][2], ds[4][2];
    scores(sQ, sdO, sK, sV, sL, sD, D, ld, q0, k0, S, causal, window, scale,
           p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        sS[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // acc += dS K: rows ty + 16 i, head-dim columns 4 tx + 64 jj .. + 3.
    for (int kk = 0; kk < BK; kk += 4) {
      float4 s4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s4[i] = *reinterpret_cast<const float4*>(&sS[(ty + 16 * i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 w[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = 4 * tx + 64 * jj;
          w[jj] = c < D ? *reinterpret_cast<const float4*>(
                              &sK[(kk + u) * ld + c])
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float su = u == 0 ? s4[i].x
                                  : (u == 1 ? s4[i].y
                                            : (u == 2 ? s4[i].z : s4[i].w));
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            acc[i][4 * jj + 0] = fmaf(su, w[jj].x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(su, w[jj].y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(su, w[jj].z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(su, w[jj].w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

  float* dqb = dq + b * st.dq.b + h * st.dq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dqb[(long long)qp * st.dq.s + c + e] = acc[i][4 * jj + e] * scale;
    }
  }
}

int dkv_smem_bytes(int D) {
  return ((2 * BK + 2 * BQ) * (D + 4) + 2 * BQ * LDP + 2 * BQ) *
         (int)sizeof(float);
}

int dq_smem_bytes(int D) {
  return ((2 * BQ + 2 * BK) * (D + 4) + BQ * LDP + 2 * BQ) *
         (int)sizeof(float);
}

View view(const long long* st, int t) { return {st[3 * t], st[3 * t + 1],
                                                st[3 * t + 2]}; }

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

  const long long rows = (long long)B * Hq * S;
  bwd_delta<<<(unsigned)((rows + NW - 1) / NW), NT, 0, stream>>>(
      static_cast<const float*>(o), fdo, fdelta, Hq, S, D, st, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // Above 48 KB a kernel must opt in to dynamic shared memory, per device,
  // so on every call.
  const int smem_kv = dkv_smem_bytes(D), smem_q = dq_smem_bytes(D);
  e = cudaFuncSetAttribute(bwd_dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_q);
  if (e != cudaSuccess) return (int)e;

  const long long n = (long long)B * Hkv * S * D;
  float* pdk = static_cast<float*>(shares);
  float* pdv = group > 1 ? pdk + group * n : nullptr;
  bwd_dkv<<<dim3((S + BK - 1) / BK, Hq, B), NT, smem_kv, stream>>>(
      fq, fk, fv, fdo, flse, fdelta, static_cast<float*>(dk),
      static_cast<float*>(dv), pdk, pdv, group, S, D, st, causal, window,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (group > 1) {
    bwd_dkv_sum<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(
        pdk, pdv, static_cast<float*>(dk), static_cast<float*>(dv), group,
        Hkv, S, D, st, n);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  bwd_dq<<<dim3((S + BQ - 1) / BQ, Hq, B), NT, smem_q, stream>>>(
      fq, fk, fv, fdo, flse, fdelta, static_cast<float*>(dq), group, S, D, st,
      causal, window, scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of launch 2 (which = 0) or launch 3 (which = 1).
int odin_flash_attention_bwd_smem_bytes(int which, int D) {
  return which == 0 ? dkv_smem_bytes(D) : dq_smem_bytes(D);
}

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
