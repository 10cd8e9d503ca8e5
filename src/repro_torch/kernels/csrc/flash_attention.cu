// Flash attention forward for Hopper (sm_90a) in fp32, plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel) for fp32 inputs: online-softmax attention with scale
// D^-0.5, running (m, l, acc) in fp32, causal / sliding-window
// (qp - kp < window) / bidirectional masks, fully masked KV tiles skipped,
// GQA by kv_head = q_head / group, masked scores set to -1e30 and the
// normaliser floored at 1e-30 -- the same arithmetic, tile for tile.  bf16
// inputs go to the tensor-core kernel of flash_attention_bf16.cu.
//
// What bounds it on an H100: for long sequences the two matrix products
// (2 * B * Hq * S^2 * D operations when causal) -- the work grows as S^2
// while the bytes (q, k, v, o once each) grow as S; for short sequences the
// bytes and the launch.  It keeps the S x S score matrix out of device
// memory entirely (each 64 x 32 score tile lives in shared memory and is
// consumed at once), reads each K/V tile once per 64 query rows, and skips
// tiles beyond the causal frontier or outside the window, which halves the
// causal work.  The products run on the fp32 CUDA cores with float4
// shared-memory reads (register-tiled 4 x 2 scores and 4 x 8 outputs per
// thread): the JAX package's fp32 limit (2e-5) rules out TF32, the only
// tensor-core type that takes fp32 operands.
//
// Layout: q [B, Hq, S, D] and k, v [B, Hkv, S, D] given by element strides
// (batch, head, sequence; the head-dim stride must be 1), so the model's
// [B, S, H, D] projections are read in place.  The output is written with
// its own strides.  Any S (the ragged last tile is masked), D <= 128 with
// D % 4 == 0, fp32 inputs and accumulation.
//
// Grid: one block of 256 threads per (64-row query tile, query head, batch);
// the KV axis is a loop inside the block, not a grid axis.
//
// A second entry point, odin_flash_attention_fwd_lse, is the same kernel
// that also writes each row's log-sum-exp of its scaled scores,
// m + log(max(l, 1e-30)), as fp32 [B, Hq, S]: the saved statistic from
// which the backward (flash_attention_bwd.cu) rebuilds the probabilities.
// The LSE write is a compile-time branch, so the first entry point's code
// is what it was without it.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // keys per KV tile (one per lane in softmax)
constexpr int NT = 256;         // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int LDP = BK + 4;     // row stride of the score tile (16 B rows)
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy rows [r0, r0 + R) of one head into a shared fp32 tile with row
// stride ld; rows at or beyond S are zero.  Warps take rows, lanes take
// consecutive head-dim elements, so each row read is coalesced.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int R,
                                          int S, int D, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += NW) {
    const int row = r0 + r;
    const T* s = src + (long long)row * ss;
    for (int c = lane; c < D; c += 32)
      dst[r * ld + c] = row < S ? to_f32(s[c]) : 0.f;
  }
}

template <typename T, bool LSE>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int group, int S,
          int D, long long qsb, long long qsh, long long qss, long long ksb,
          long long ksh, long long kss, long long vsb, long long vsh,
          long long vss, long long osb, long long osh, long long oss,
          int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4;  // D % 4 == 0, so every tile row is 16 B aligned
  float* sQ = smem;            // [BQ][ld]
  float* sK = sQ + BQ * ld;    // [BK][ld]
  float* sV = sK + BK * ld;    // [BK][ld]
  float* sP = sV + BK * ld;    // [BQ][LDP] scores, then probabilities
  float* sM = sP + BQ * LDP;   // [BQ] running max
  float* sL = sM + BQ;         // [BQ] running normaliser
  float* sA = sL + BQ;         // [BQ] rescale factor of this tile

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  T* ob = o + b * osb + h * osh;

  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  load_tile(sQ, qb, qss, q0, BQ, S, D, ld);

  // Live KV tiles, as the TPU kernel's pl.when(live) culls them.
  const int nk = (S + BK - 1) / BK;
  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_end = causal ? q_last / BK + 1 : nk;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // oldest key any row of the tile sees
    if (lo > 0) kt_begin = lo / BK;
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P V is done with sV and sP
    load_tile(sK, kb, kss, k0, BK, S, D, ld);
    load_tile(sV, vb, vss, k0, BK, S, D, ld);
    __syncthreads();

    // Scores: thread (ty, tx) owns rows ty + 16 i and keys tx + 16 j.
    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * ld + d]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        c[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * ld + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float s = sc[i][j];
          s = fmaf(a[i].x, c[j].x, s);
          s = fmaf(a[i].y, c[j].y, s);
          s = fmaf(a[i].z, c[j].z, s);
          s = fmaf(a[i].w, c[j].w, s);
          sc[i][j] = s;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, kc = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + kc;
        bool live = kp < S;
        if (causal) live = live && qp >= kp;
        if (window > 0) live = live && qp - kp < window;
        sP[r * LDP + kc] = live ? sc[i][j] * scale : NEG_INF;
      }
    __syncthreads();

    // Online softmax: warp w owns rows 8 w .. 8 w + 7, one key per lane.
#pragma unroll
    for (int rr = 0; rr < BQ / NW; ++rr) {
      const int r = warp * (BQ / NW) + rr;
      const float s = sP[r * LDP + lane];
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float l_tile = warp_sum(p);
      sP[r * LDP + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + l_tile;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: thread owns rows ty + 16 i and head-dim
    // columns 4 tx + 64 jj .. + 3.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sA[ty + 16 * i];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(&sP[(ty + 16 * i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 w[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = 4 * tx + 64 * jj;
          w[jj] = c < D ? *reinterpret_cast<const float4*>(
                              &sV[(kk + u) * ld + c])
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = comp(p[i], u);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            acc[i][4 * jj + 0] = fmaf(pu, w[jj].x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(pu, w[jj].y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(pu, w[jj].z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(pu, w[jj].w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }
  __syncthreads();  // sL is final (also when no tile was live)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= S) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    T* orow = ob + (long long)qp * oss;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) store(orow + c + e, acc[i][4 * jj + e] / l);
    }
  }
  if (LSE && tid < BQ && q0 + tid < S)   // lse is [B, Hq, S], contiguous
    lse[((long long)b * gridDim.y + h) * S + q0 + tid] =
        sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
}

int smem_bytes(int D) {
  return ((BQ + 2 * BK) * (D + 4) + BQ * LDP + 3 * BQ) * (int)sizeof(float);
}

template <typename T, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int S, int D, const long long* st,
           int causal, int window, float scale, cudaStream_t stream) {
  if (D <= 0 || D > MAX_D || D % 4 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(D);
  // Above 48 KB a kernel must opt in to dynamic shared memory.  The opt-in
  // is per device, so it is made on every call (it costs microseconds).
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd<T, LSE><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq / Hkv, S, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, head, sequence) for q, k, v, o.
// float32 q/k/v/o.  window <= 0 means no window.  Returns
// cudaGetLastError() after the launch (0 on success).
int odin_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* o, int B, int Hq, int Hkv, int S, int D,
                             const long long* strides, int causal,
                             int window, float scale, void* stream) {
  return launch<float, false>(q, k, v, o, nullptr, B, Hq, Hkv, S, D, strides,
                              causal, window, scale,
                              static_cast<cudaStream_t>(stream));
}

// The same, and each row's log-sum-exp into lse, fp32 [B, Hq, S]
// contiguous.
int odin_flash_attention_fwd_lse(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int Hq, int Hkv,
                                 int S, int D, const long long* strides,
                                 int causal, int window, float scale,
                                 void* stream) {
  return launch<float, true>(q, k, v, o, static_cast<float*>(lse), B, Hq,
                             Hkv, S, D, strides, causal, window, scale,
                             static_cast<cudaStream_t>(stream));
}

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
