// Mamba2 SSD chunk scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel): with dA = dt * A and cs its cumulative sum within a chunk,
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j      (intra)
//         + exp(cs_i) C_i . h                                       (state read)
//   h    <- exp(cs_last) h + sum_j exp(cs_last - cs_j) dt_j x_j (x) B_j
// per (batch, head), all in fp32, with n_groups = 1 (B and C shared by the
// heads).  Unlike the Pallas kernel it also returns the final state h
// [b, H, P, N] in fp32, which the model's prefill keeps as its cache.
//
// What bounds it on an H100: the bytes.  At mamba2-370m's shape (b 1,
// S 1024, H 32, P 64, N 128, bf16) it must read x, dt, B, C and write y and
// the fp32 state, about 10 MB, while the products are about 2 GFLOP: far
// below the ~295 operations per byte at which Hopper's tensor cores would
// become the limit.  This first design reads x, B and C from device memory
// once per chunk and tile (re-reads hit L2), keeps the [P, N] state of its
// head in shared memory for the whole sequence, so the state never goes
// back to device memory between chunks, and never forms the [chunk, chunk]
// score matrix: 64 x 64 score tiles live in shared memory and are consumed
// at once.  The products run on the fp32 CUDA cores (fp32 parity with the
// token recurrence rules out TF32); with one block per (batch, head) only
// b * H blocks are in flight (32 of 132 SMs at batch 1), so it is far from
// the byte bound.  Tensor cores and a split over P are later work.
//
// The Pallas grid carries the state across a sequential chunk axis; Hopper
// blocks run in no order, so the chunk axis is a loop inside the block.
// Any S and any chunk size are taken (a short last chunk is masked), and
// the result depends on the chunk size only through rounding.  Every
// exponent of a live pair is cs_i - cs_j <= 0 (dA < 0); pairs j > i are
// written as an exact 0, never as exp(-inf).
//
// Layout: x [b, S, H, P], dt [b, S, H], B and C [b, S, N] and y [b, S, H, P]
// are given by element strides (the last dimension's stride must be 1), so
// the model's views into its conv output are read in place.  P <= 64 and
// N <= 128, both multiples of 4; fp32 or bf16 inputs, A in the same dtype.
//
// Grid: one block of 256 threads per (head, batch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;         // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int TI = 64;          // rows of an output tile
constexpr int TJ = 64;          // rows of a key tile
constexpr int LDS = TJ + 4;     // row stride of the score tile
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Copy rows [r0, r0 + R) (sequence positions) of a [*, W] slice into a
// shared fp32 tile with row stride ld; rows at or past r0 + valid are zero.
// Warps take rows, lanes take consecutive columns (coalesced reads).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ss, int r0, int R,
                                          int valid, int W, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += NW) {
    const T* s = src + (long long)(r0 + r) * ss;
    for (int c = lane; c < W; c += 32)
      dst[r * ld + c] = r < valid ? to_f32(s[c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_fwd(const T* __restrict__ x, const T* __restrict__ dt,
        const T* __restrict__ A, const T* __restrict__ Bm,
        const T* __restrict__ Cm, T* __restrict__ y,
        float* __restrict__ state_out, int S, int H, int P, int N, int chunk,
        long long xsb, long long xss, long long xsh, long long dsb,
        long long dss, long long dsh, long long bsb, long long bss,
        long long csb, long long css, long long ysb, long long yss,
        long long ysh) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldn = N + 4, ldp = P + 4;  // multiples of 4: 16 B aligned rows
  float* sSt = smem;               // [P][ldn]  the running state h
  float* sC = sSt + P * ldn;       // [TI][ldn] C rows of the output tile
  float* sB = sC + TI * ldn;       // [TJ][ldn] B rows of the key tile
  float* sX = sB + TJ * ldn;       // [TJ][ldp] x rows of the key tile
  float* sS = sX + TJ * ldp;       // [TI][LDS] weighted scores
  float* sDt = sS + TI * LDS;      // [chunk] dt
  float* sCs = sDt + chunk;        // [chunk] cumulative dA
  float* sW = sCs + chunk;         // [chunk] exp(cs_last - cs_j) dt_j
  float* sPart = sW + chunk;       // [NW] warp sums of the scan

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = to_f32(A[h]);
  const T* xb = x + b * xsb + h * xsh;
  const T* db = dt + b * dsb + h * dsh;
  const T* Bb = Bm + b * bsb;
  const T* Cb = Cm + b * csb;
  T* yb = y + b * ysb + h * ysh;
  // This thread's columns of the output tile: p = 4 tx .. 4 tx + 3.
  const bool has_p = 4 * tx < P;

  for (int e = tid; e < P * ldn; e += NT) sSt[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int cl = min(chunk, S - c0);
    __syncthreads();  // the previous chunk is done with sDt, sCs, sW, sSt

    // 1. dt and the inclusive cumulative sum of dA over the chunk: a warp
    //    scan per 32 positions, warp totals combined through sPart.
    float carry = 0.f;
    for (int s0 = 0; s0 < cl; s0 += NT) {
      const int j = s0 + tid;
      const float d = j < cl ? to_f32(db[(long long)(c0 + j) * dss]) : 0.f;
      float v = d * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      if (lane == 31) sPart[warp] = v;
      __syncthreads();
      float before = carry, total = carry;
      for (int w = 0; w < NW; ++w) {
        const float t = sPart[w];
        if (w < warp) before += t;
        total += t;
      }
      if (j < cl) {
        sDt[j] = d;
        sCs[j] = v + before;
      }
      carry = total;
      __syncthreads();  // sPart is read before the next segment writes it
    }
    const float cs_last = sCs[cl - 1];
    for (int j = tid; j < cl; j += NT)
      sW[j] = expf(cs_last - sCs[j]) * sDt[j];

    // 2. The chunk's outputs, one tile of TI rows at a time, all reading
    //    the state as it was at the start of the chunk.
    for (int i0 = 0; i0 < cl; i0 += TI) {
      __syncthreads();  // sC, sB, sX, sS are free
      load_rows(sC, Cb, css, c0 + i0, TI, min(TI, cl - i0), N, ldn);
      __syncthreads();

      // State read: acc[r][c] = exp(cs_i) sum_n C_i[n] h[p][n] for rows
      // i = i0 + ty + 16 r and columns p = 4 tx + c.
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      if (has_p) {
        for (int n = 0; n < N; n += 4) {
          float4 cc[4], hh[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cc[r] = *reinterpret_cast<const float4*>(
                &sC[(ty + 16 * r) * ldn + n]);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            hh[c] = *reinterpret_cast<const float4*>(
                &sSt[(4 * tx + c) * ldn + n]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = dot4(cc[r], hh[c],
                                                         acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < cl ? expf(sCs[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }

      // Intra-chunk terms from the key tiles at or before this tile.
      for (int j0 = 0; j0 <= i0; j0 += TJ) {
        const int nj = min(TJ, cl - j0);
        __syncthreads();  // the previous key tile's sB, sX, sS are consumed
        load_rows(sB, Bb, bss, c0 + j0, TJ, nj, N, ldn);
        load_rows(sX, xb, xss, c0 + j0, TJ, nj, P, ldp);
        __syncthreads();

        // Scores C_i . B_j for rows ty + 16 r and keys tx + 16 q, weighted
        // by exp(cs_i - cs_j) dt_j where j <= i, and exactly 0 elsewhere.
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) sc[r][q] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cc[4], bb[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cc[r] = *reinterpret_cast<const float4*>(
                &sC[(ty + 16 * r) * ldn + n]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bb[q] = *reinterpret_cast<const float4*>(
                &sB[(tx + 16 * q) * ldn + n]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) sc[r][q] = dot4(cc[r], bb[q],
                                                        sc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * q;
            const float w = (j <= i && i < cl)
                                ? expf(sCs[i] - sCs[j]) * sDt[j] : 0.f;
            sS[(ty + 16 * r) * LDS + tx + 16 * q] = sc[r][q] * w;
          }
        __syncthreads();

        // acc += sS @ sX over the tile's keys.
        if (has_p) {
          for (int jj = 0; jj < TJ; jj += 4) {
            float4 pr[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              pr[r] = *reinterpret_cast<const float4*>(
                  &sS[(ty + 16 * r) * LDS + jj]);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 xv = *reinterpret_cast<const float4*>(
                  &sX[(jj + u) * ldp + 4 * tx]);
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float pu = comp(pr[r], u);
                acc[r][0] = fmaf(pu, xv.x, acc[r][0]);
                acc[r][1] = fmaf(pu, xv.y, acc[r][1]);
                acc[r][2] = fmaf(pu, xv.z, acc[r][2]);
                acc[r][3] = fmaf(pu, xv.w, acc[r][3]);
              }
            }
          }
        }
      }

      if (has_p) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
          if (i >= cl) continue;
          T* row = yb + (long long)(c0 + i) * yss + 4 * tx;
#pragma unroll
          for (int c = 0; c < 4; ++c) store(row + c, acc[r][c]);
        }
      }
    }

    // 3. State update: h <- exp(cs_last) h + sum_j sW_j x_j (x) B_j.  This
    //    thread owns h[p][n] for p = ty + 16 r and n = 4 tx + 64 m + e.
    float st[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) st[r][e] = 0.f;
    for (int j0 = 0; j0 < cl; j0 += TJ) {
      const int nj = min(TJ, cl - j0);
      __syncthreads();  // sB and sX are free
      load_rows(sB, Bb, bss, c0 + j0, TJ, nj, N, ldn);
      load_rows(sX, xb, xss, c0 + j0, TJ, nj, P, ldp);
      __syncthreads();
      for (int jj = 0; jj < nj; ++jj) {
        const float w = sW[j0 + jj];
        float xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = ty + 16 * r;
          xv[r] = p < P ? sX[jj * ldp + p] * w : 0.f;
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int n = 4 * tx + 64 * m;
          if (n >= N) continue;
          const float4 bv = *reinterpret_cast<const float4*>(
              &sB[jj * ldn + n]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            st[r][4 * m + 0] = fmaf(xv[r], bv.x, st[r][4 * m + 0]);
            st[r][4 * m + 1] = fmaf(xv[r], bv.y, st[r][4 * m + 1]);
            st[r][4 * m + 2] = fmaf(xv[r], bv.z, st[r][4 * m + 2]);
            st[r][4 * m + 3] = fmaf(xv[r], bv.w, st[r][4 * m + 3]);
          }
        }
      }
    }
    __syncthreads();  // no thread still reads the old state
    const float decay = expf(cs_last);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
      if (p >= P) continue;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int n = 4 * tx + 64 * m;
        if (n >= N) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* hp = &sSt[p * ldn + n + e];
          *hp = fmaf(*hp, decay, st[r][4 * m + e]);
        }
      }
    }
  }
  __syncthreads();

  float* so = state_out + ((long long)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += NT) so[e] = sSt[(e / N) * ldn + e % N];
}

size_t smem_bytes(int P, int N, int chunk) {
  return ((size_t)(P + TI + TJ) * (N + 4) + (size_t)TJ * (P + 4) +
          (size_t)TI * LDS + 3 * (size_t)chunk + NW) * sizeof(float);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, float* state, int b, int S, int H, int P,
           int N, int chunk, const long long* st, cudaStream_t stream) {
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0 || P > MAX_P || P % 4 != 0 ||
      N <= 0 || N > MAX_N || N % 4 != 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(P, N, chunk);
  // Above 48 KB a kernel must opt in to dynamic shared memory; a chunk too
  // long for the SM's shared memory is refused here.
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd<T><<<dim3(H, b), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), state, S, H, P, N, chunk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 13 element strides: x (batch, seq, head), dt (batch, seq, head),
// B (batch, seq), C (batch, seq), y (batch, seq, head).  state is a
// contiguous fp32 [b, H, P, N] buffer.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 on success).
int odin_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                      const void* B, const void* C, void* y, void* state,
                      int b, int S, int H, int P, int N, int chunk,
                      const long long* strides, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(state);
  if (dtype == 0)
    return launch<float>(x, dt, A, B, C, y, st, b, S, H, P, N, chunk,
                         strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, st, b, S, H, P, N,
                                 chunk, strides, s);
  return (int)cudaErrorInvalidValue;
}

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
