// One-token GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _decode_kernel): the new token's query heads
// attend to a KV cache whose slots past `index` are stale, with scale
// D^-0.5, an optional window (slot kp is live when index - window < kp <=
// index), masked scores set to -1e30, running (m, l, acc) in fp32, KV tiles
// wholly past `index` or outside the window skipped, and the normaliser
// floored at 1e-30 -- the Pallas kernel's arithmetic.
//
// What bounds it on an H100: the bytes.  The live part of the cache streams
// from device memory once, against about 4 operations per byte loaded, far
// below the ~295 at which the tensor cores would be the limit.  As in the
// Pallas tiling, the whole group of query heads that share one KV head
// rides in one block, so each KV tile is read once per KV head.  A block
// per (batch, KV head) alone would keep 8 of 132 SMs busy for qwen3-4b at
// batch 1, so the slots are split among blocks as well (flash-decoding):
// kernel 1 runs one block per (split, KV head, batch) and writes each
// query head's partial (acc, m, l) to a scratch buffer; kernel 2 merges the
// splits with the usual rescaling.  With one split the result is the
// Pallas kernel's expression exactly.
//
// `index` is read from device memory (the Pallas kernel takes it as a
// scalar prefetch), so a decode loop needs no host synchronisation; the
// number of splits is fixed by the cache length, and blocks whose slots lie
// wholly past `index` exit at once.
//
// Layout: q [B, Hq, D] and k, v [B, Hkv, S, D] given by element strides
// (head-dim stride 1), so the model's [B, S, Hkv, D] cache is read in place;
// out [B, Hq, D] by strides.  Any S and group size, D <= 128 with
// D % 4 == 0; fp32 or bf16 inputs with fp32 statistics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;         // threads per block of kernel 1 (4 warps)
constexpr int NW = NT / 32;
constexpr int TK = 32;          // slots per KV tile (one per lane)
constexpr int MAX_D = 128;      // also the threads per block of kernel 2
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

// Slot kp is live for the query at `index`.
__device__ __forceinline__ bool live_slot(int kp, int index, int window) {
  return kp <= index && (window <= 0 || kp > index - window);
}

// Kernel 1: the partial attention of one split of the slots.  part holds,
// per (batch, query head, split), D accumulator values, then m, then l.
template <typename T>
__global__ void __launch_bounds__(NT)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ index_ptr,
               float* __restrict__ part, int G, int S, int D, int split_len,
               int nsplit, long long qsb, long long qsh, long long ksb,
               long long ksh, long long kss, long long vsb, long long vsh,
               long long vss, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4;           // D % 4 == 0: 16 B aligned rows
  float* sQ = smem;               // [G][D]
  float* sAcc = sQ + G * D;       // [G][D]
  float* sK = sAcc + G * D;       // [TK][ld]
  float* sV = sK + TK * ld;       // [TK][ld]
  float* sP = sV + TK * ld;       // [G][TK] scores, then probabilities
  float* sM = sP + G * TK;        // [G] running max
  float* sL = sM + G;             // [G] running normaliser
  float* sA = sL + G;             // [G] rescale factor of this tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Hkv = gridDim.y;
  const int index = *index_ptr;
  const int s0 = split * split_len, s1 = min(s0 + split_len, S);
  const T* qb = q + b * qsb + (long long)h * G * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  for (int e = tid; e < G * D; e += NT) {
    const int g = e / D, d = e - g * D;
    sQ[e] = to_f32(qb[g * qsh + d]);
    sAcc[e] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    sM[g] = NEG_INF;
    sL[g] = 0.f;
  }

  const int D4 = D / 4;
  for (int k0 = s0; k0 < s1; k0 += TK) {
    // Cull the tile as the Pallas kernel culls a block: live when its
    // first slot is at or before index and, with a window, its last slot
    // is inside the window.  A live tile has at least one live slot.
    const int kl = min(k0 + TK, s1) - 1;
    if (!(k0 <= index && (window <= 0 || kl > index - window))) continue;
    __syncthreads();  // the previous tile's readers are done
    const int warp_rows = TK / NW;
    for (int r = warp * warp_rows; r < (warp + 1) * warp_rows; ++r) {
      const int kp = k0 + r;
      const T* kr = kb + (long long)kp * kss;
      const T* vr = vb + (long long)kp * vss;
      for (int c = lane; c < D; c += 32) {
        sK[r * ld + c] = kp < s1 ? to_f32(kr[c]) : 0.f;
        sV[r * ld + c] = kp < s1 ? to_f32(vr[c]) : 0.f;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * TK; e += NT) {
      const int g = e / TK, kk = e - g * TK;
      const int kp = k0 + kk;
      float s = 0.f;
      for (int d = 0; d < D; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(&sQ[g * D + d]);
        const float4 c = *reinterpret_cast<const float4*>(&sK[kk * ld + d]);
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      sP[e] = (kp < s1 && live_slot(kp, index, window)) ? s * scale
                                                         : NEG_INF;
    }
    __syncthreads();

    // Online softmax: warp w owns query heads w, w + NW, ...; one slot per
    // lane.
    for (int g = warp; g < G; g += NW) {
      const float s = sP[g * TK + lane];
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float l_tile = warp_sum(p);
      sP[g * TK + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[g] = alpha;
        sL[g] = sL[g] * alpha + l_tile;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, four head-dim columns per entry.
    for (int e = tid; e < G * D4; e += NT) {
      const int g = e / D4, c = 4 * (e - g * D4);
      float4 acc = *reinterpret_cast<float4*>(&sAcc[g * D + c]);
      const float alpha = sA[g];
      acc.x *= alpha;
      acc.y *= alpha;
      acc.z *= alpha;
      acc.w *= alpha;
      for (int kk = 0; kk < TK; ++kk) {
        const float p = sP[g * TK + kk];
        const float4 w = *reinterpret_cast<const float4*>(&sV[kk * ld + c]);
        acc.x = fmaf(p, w.x, acc.x);
        acc.y = fmaf(p, w.y, acc.y);
        acc.z = fmaf(p, w.z, acc.z);
        acc.w = fmaf(p, w.w, acc.w);
      }
      *reinterpret_cast<float4*>(&sAcc[g * D + c]) = acc;
    }
  }
  __syncthreads();  // sAcc, sM, sL are final (also when no tile was live)

  const int Hq = Hkv * G;
  for (int e = tid; e < G * (D + 2); e += NT) {
    const int g = e / (D + 2), r = e - g * (D + 2);
    const float val = r < D ? sAcc[g * D + r] : (r == D ? sM[g] : sL[g]);
    part[(((long long)b * Hq + h * G + g) * nsplit + split) * (D + 2) + r] =
        val;
  }
}

// Kernel 2: merge the splits of one (query head, batch); thread d writes
// output column d.
template <typename T>
__global__ void __launch_bounds__(MAX_D)
decode_combine(const float* __restrict__ part, T* __restrict__ out,
               int nsplit, int D, long long osb, long long osh) {
  const int hq = blockIdx.x, b = blockIdx.y, Hq = gridDim.x;
  const int d = threadIdx.x;
  const float* pp = part + ((long long)b * Hq + hq) * nsplit * (D + 2);
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pp[s * (D + 2) + D]);
  if (d >= D) return;
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float* r = pp + s * (D + 2);
    const float w = expf(r[D] - M);
    L = fmaf(w, r[D + 1], L);
    acc = fmaf(w, r[d], acc);
  }
  store(out + b * osb + hq * osh + d, acc / fmaxf(L, 1e-30f));
}

size_t smem_bytes(int G, int D) {
  return ((size_t)2 * G * D + (size_t)2 * TK * (D + 4) + (size_t)G * TK +
          3 * (size_t)G) * sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* index,
           float* part, void* out, int B, int Hq, int Hkv, int S, int D,
           int split_len, int nsplit, const long long* st, int window,
           float scale, cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || D <= 0 ||
      D > MAX_D || D % 4 != 0 || split_len <= 0 ||
      (long long)split_len * nsplit < S || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes(G, D);
  const cudaError_t e = cudaFuncSetAttribute(
      decode_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  decode_partial<T><<<dim3(nsplit, Hkv, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), index, part, G, S, D, split_len, nsplit,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], window,
      scale);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  decode_combine<T><<<dim3(Hq, B), MAX_D, 0, stream>>>(
      part, static_cast<T*>(out), nsplit, D, st[8], st[9]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 10 element strides: q (batch, head), k (batch, head, seq),
// v (batch, head, seq), out (batch, head).  index: one int32 in device
// memory.  part: fp32 scratch of B * Hq * nsplit * (D + 2) values.
// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Returns cudaGetLastError() after the launches (0 on success).
int odin_decode_attention_fwd(const void* q, const void* k, const void* v,
                              const void* index, void* part, void* out,
                              int B, int Hq, int Hkv, int S, int D,
                              int split_len, int nsplit,
                              const long long* strides, int window,
                              float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(index);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return launch<float>(q, k, v, idx, p, out, B, Hq, Hkv, S, D, split_len,
                         nsplit, strides, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, idx, p, out, B, Hq, Hkv, S, D,
                                 split_len, nsplit, strides, window, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
