// One-token GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _decode_kernel): the new token's query heads
// attend to a KV cache whose slots past `index` are stale, with scale
// D^-0.5, an optional window (slot kp is live when index - window < kp <=
// index), a running (m, l, acc) with m starting at -1e30 and the
// normaliser floored at 1e-30 -- the Pallas kernel's arithmetic, which runs
// in fp32 (here in fp64, below).
//
// What bounds it on an H100: the bytes.  The live part of the cache streams
// from device memory once, against about 4 operations per byte loaded, far
// below the ~295 at which the tensor cores would be the limit; at qwen3-4b's
// decode shape that is 4.3 MB, 1.3 us at 3.35 TB/s.  Reaching that rate
// takes megabytes in flight at once, so the design is about memory-level
// parallelism and one launch:
//
// * The grid is fixed by the cache's shape -- one thread-block cluster of
//   NSPLIT blocks per (KV head, batch) -- so a later CUDA graph can
//   capture it.  Each block reads `index` from device memory and takes an
//   equal share of the live range [max(0, index - window + 1), index]:
//   every block has work wherever `index` stands (at index 1040 of 2048
//   with 16 splits, 66 slots each).
// * A block starts the copies of its whole share at once: 16-byte
//   `cp.async` copies of its K and V rows into shared memory (up to about
//   64 KB of them; a longer share goes in passes of that size), then one
//   wait.  The whole query group of the KV head rides in the block, so each
//   K/V row is read once, and each element is converted to fp64 once per
//   four query heads.
// * The splits merge inside the launch: each block leaves its (acc, m, l)
//   in shared memory, and after a cluster barrier every block merges a
//   share of the output elements, reading the other blocks' partials
//   through distributed shared memory.  A split with no live slot
//   contributes m = -1e30, l = 0.  Stale slots are never read, and the
//   merge order is fixed, so they cannot change the output.
// * The arithmetic is fp64 (products of bf16 or fp32 inputs are exact
//   there), and the result is rounded to fp32, then to the output's type.
//   Two fp32 computations of the same output that sum in different orders
//   differ by about 1e-7 of it, which moves one bf16 output in a few
//   thousand across a rounding boundary: at the main shape one such ulp
//   reads an rms of 3.6e-5 of rms(ref), over the 2e-5 the cases hold the
//   kernel to.  In fp64 the kernel and the plain version (ref.py, also
//   fp64) agree to about 1e-15 of a value, so their rounded outputs differ
//   only where the exact value lies that close to an fp32 rounding
//   boundary.  The work is ~4 operations a byte, so fp64 at half the fp32
//   rate stays far from the bound.
//
// The cluster size is NSPLIT = ODIN_DECODE_CLUSTER (16 unless the build
// defines it; tools/k23_variants.py compiles other sizes with -D).
// Measured (chip_smoke.py and tools/k23_variants.py on an NVIDIA H100 80GB
// HBM3 at 700 W), at qwen3-4b's decode shape with the L2 flushed: 0.0218 ms
// with clusters of 16 (8: 0.0233), against 0.0236-0.0241 ms for
// scaled_dot_product_attention and 0.029 ms for the first design (two
// launches, 2-byte loads); 0.016 ms with the L2 warm.  In fp32 this design
// read 0.018 ms: fp64 costs the rest.  It is 17x the byte bound: a chain of
// dependent steps (index, copies, scores, softmax, P V, cluster barrier,
// merge) each waits its latency, and a block's share is too small to hide
// it.  What moved it: padding the K and V rows of shared memory by 16 bytes
// (their 16-byte reads conflicted eight-fold), 0.0214 to 0.0185 ms in fp32;
// in fp64, two blocks an SM (at most 128 registers; at 176 one block fits
// an SM, so a cluster of 16 needs 16 SMs of one GPC), with each element
// converted once per four heads, 0.0309 to 0.0218 ms.  What did not: one block an SM or 512 threads a block (fp32);
// K and V as two copy groups, so that the scores need not wait for V.
//
// Layout: q [B, Hq, D] and k, v [B, Hkv, S, D] given by element strides
// (head-dim stride 1), so the model's [B, S, Hkv, D] cache is read in place;
// out [B, Hq, D] by strides.  Any S and group size; D <= 128 with D a
// multiple of 8 (bf16) or 4 (fp32), k/v strides multiples of 16 bytes and
// 16-byte aligned bases (cp.async); fp64 statistics.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;               // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int MAX_D = 128;
#ifndef ODIN_DECODE_CLUSTER
#define ODIN_DECODE_CLUSTER 16
#endif
// Blocks per cluster, one cluster per (KV head, batch); above the portable
// 8 the launch allows a non-portable size.
constexpr int NSPLIT = ODIN_DECODE_CLUSTER;
static_assert(NSPLIT >= 1 && NSPLIT <= 16, "clusters hold 1 to 16 blocks");
constexpr int MAX_PARTS = 8;          // slot groups of the P V loop
constexpr int PART_BYTES = 16 * 1024;  // their fp64 partials, at most
constexpr int KV_PASS_BYTES = 64 * 1024;   // K and V of one pass
constexpr double NEG_INF = -1e30;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Sixteen bytes of T from shared memory, as floats (scores), and four
// elements (P V).
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  load16(p, o);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ double to_f64(float x) { return x; }
__device__ __forceinline__ double to_f64(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// fp64 to fp32, then to the output's type (the plain version's rounding).
__device__ __forceinline__ void store(float* p, double x) {
  *p = __double2float_rn(x);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, double x) {
  *p = __float2bfloat16_rn(__double2float_rn(x));
}

__device__ __forceinline__ double warp_max(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmax(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared memory of one block: K and V rows of a pass (T), then fp64 q,
// acc, the P V partials, the scores of a pass, m, l, the pass's rescale,
// and the merge's weights [G][NSPLIT] and normalisers.  K and V rows are
// padded by 16 bytes, so that the 16-byte reads of eight consecutive rows
// fall in different banks.
struct Layout {
  int kv, q, acc, part, p, m, l, a, w, lt, bytes;
  __host__ __device__ Layout(int G, int D, int cap, int parts, int esz) {
    kv = cap * (D * esz + 16);          // bytes of K (and of V)
    q = 2 * kv;
    acc = q + G * D * 8;
    part = acc + G * D * 8;
    p = part + parts * G * D * 8;
    m = p + G * cap * 8;
    l = m + G * 8;
    a = l + G * 8;
    w = a + G * 8;
    lt = w + G * NSPLIT * 8;
    bytes = lt + G * 8;
  }
};

// Each K and V element is converted to fp64 once per GT query heads: the
// scores give a slot to QS adjacent threads, each with a share of the head
// dim, and P V gives each thread four head-dim elements of GT heads.
constexpr int GT = 4;                 // query heads per pass over K or V
constexpr int QS = 4;                 // threads per slot in the scores

// Two blocks fit an SM (at most 128 registers a thread), so a cluster of
// 16 needs 8 SMs of a GPC.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ index_ptr,
           T* __restrict__ out, int G, int S, int D, int cap, int parts,
           long long qsb, long long qsh, long long ksb, long long ksh,
           long long kss, long long vsb, long long vsh, long long vss,
           long long osb, long long osh, int window, double scale) {
  constexpr int VE = Vec<T>::N;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L(G, D, cap, parts, sizeof(T));
  const int ld = D + VE;                // row stride of sK and sV
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + L.kv);
  double* sQ = reinterpret_cast<double*>(smem + L.q);      // [G][D]
  double* sAcc = reinterpret_cast<double*>(smem + L.acc);  // [G][D]
  double* sPart = reinterpret_cast<double*>(smem + L.part);  // [parts][G][D]
  double* sP = reinterpret_cast<double*>(smem + L.p);      // [G][cap]
  double* sM = reinterpret_cast<double*>(smem + L.m);      // [G]
  double* sL = reinterpret_cast<double*>(smem + L.l);      // [G]
  double* sA = reinterpret_cast<double*>(smem + L.a);      // [G]
  double* sW = reinterpret_cast<double*>(smem + L.w);      // [G][NSPLIT]
  double* sLt = reinterpret_cast<double*>(smem + L.lt);    // [G]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;

  // This block's share of the live slots [lo, hi].
  const int index = *index_ptr;
  const int hi = min(index, S - 1);
  const int lo = window > 0 ? max(0, index - window + 1) : 0;
  const int live = max(hi - lo + 1, 0);
  const int share = (live + NSPLIT - 1) / NSPLIT;
  const int s0 = lo + split * share;
  const int s1 = min(s0 + share, hi + 1);

  const T* qb = q + b * qsb + (long long)h * G * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;
  const int chunks = D / VE;            // 16-byte pieces of a row
  const int pieces = D / 4;             // four-element pieces of P V
  // Every K and V row of a pass in flight at once; one wait follows.
  auto fetch = [&](int p0, int n) {
    for (int e = tid; e < 2 * n * chunks; e += NT) {
      const int which = e >= n * chunks;
      const int r = e - which * n * chunks;
      const int slot = r / chunks, c = r - slot * chunks;
      const T* src = which ? vb + (long long)(p0 + slot) * vss
                           : kb + (long long)(p0 + slot) * kss;
      cp_async16((which ? sV : sK) + slot * ld + c * VE, src + c * VE);
    }
  };
  // The first pass is fetched before q is read, so their latencies overlap.
  if (s0 < s1) fetch(s0, min(cap, s1 - s0));
  for (int e = tid; e < G * D; e += NT) {
    const int g = e / D, d = e - g * D;
    sQ[e] = to_f64(qb[g * qsh + d]);
    sAcc[e] = 0.0;
  }
  for (int g = tid; g < G; g += NT) {
    sM[g] = NEG_INF;
    sL[g] = 0.0;
  }

  for (int p0 = s0; p0 < s1; p0 += cap) {
    const int n = min(cap, s1 - p0);
    if (p0 > s0) {
      __syncthreads();  // the previous pass is consumed
      fetch(p0, n);
    }
    cp_async_wait_all();
    __syncthreads();

    // Scores: QS adjacent lanes per slot, lane t taking the 16-byte pieces
    // t, t + QS, ... of the row for GT heads at a time, then summed over
    // the QS lanes by shuffles (every lane of a warp takes part).
    const int rows = (n * QS + 31) / 32 * 32;
    for (int e = tid; e < rows; e += NT) {
      const int slot = e / QS, t = e - slot * QS;
      const bool valid = slot < n;
      for (int g0 = 0; g0 < G; g0 += GT) {
        double s[GT];
#pragma unroll
        for (int j = 0; j < GT; ++j) s[j] = 0.0;
        if (valid) {
          for (int c = t; c < chunks; c += QS) {
            float kf[VE];
            load16(sK + slot * ld + c * VE, kf);
#pragma unroll
            for (int u = 0; u < VE; ++u) {
              const double kd = kf[u];
#pragma unroll
              for (int j = 0; j < GT; ++j)
                s[j] = fma(sQ[min(g0 + j, G - 1) * D + c * VE + u], kd, s[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < GT; ++j) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], 2);
        }
        if (valid && t == 0) {
#pragma unroll
          for (int j = 0; j < GT; ++j)
            if (g0 + j < G) sP[(g0 + j) * cap + slot] = s[j] * scale;
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp per query head.
    for (int g = warp; g < G; g += NW) {
      double mx = NEG_INF;
      for (int slot = lane; slot < n; slot += 32)
        mx = fmax(mx, sP[g * cap + slot]);
      const double m_prev = sM[g];
      const double m_new = fmax(m_prev, warp_max(mx));
      double sum = 0.0;
      for (int slot = lane; slot < n; slot += 32) {
        const double p = exp(sP[g * cap + slot] - m_new);
        sP[g * cap + slot] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const double alpha = exp(m_prev - m_new);
        sA[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // P V: thread (part, piece) sums slots part, part + parts, ... of four
    // head-dim elements for GT heads at a time; the parts are then added
    // in a fixed order.
    for (int e = tid; e < pieces * parts; e += NT) {
      const int part = e / pieces, c = e - part * pieces;
      for (int g0 = 0; g0 < G; g0 += GT) {
        double acc[GT][4];
#pragma unroll
        for (int j = 0; j < GT; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[j][u] = 0.0;
        for (int slot = part; slot < n; slot += parts) {
          float vf[4];
          load4(sV + slot * ld + c * 4, vf);
          double vd[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) vd[u] = vf[u];
#pragma unroll
          for (int j = 0; j < GT; ++j) {
            const double p = sP[min(g0 + j, G - 1) * cap + slot];
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[j][u] = fma(p, vd[u], acc[j][u]);
          }
        }
#pragma unroll
        for (int j = 0; j < GT; ++j) {
          if (g0 + j < G) {
            double* dst = sPart + (part * G + g0 + j) * D + c * 4;
#pragma unroll
            for (int u = 0; u < 4; ++u) dst[u] = acc[j][u];
          }
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += NT) {
      double s = 0.0;
      for (int part = 0; part < parts; ++part) s += sPart[part * G * D + e];
      sAcc[e] = fma(sAcc[e], sA[e / D], s);
    }
  }

  // Merge the cluster's splits.  Each block first forms the splits'
  // weights exp(m_r - M) of every query head, and the normaliser
  // sum_r w_r l_r, in a fixed order; then block `split` writes output
  // elements split, split + NSPLIT, ... of this (KV head, batch).
  cluster.sync();  // every block's sAcc, sM, sL are final and visible
  for (int e = tid; e < G * NSPLIT; e += NT) {
    const int g = e / NSPLIT, r = e - g * NSPLIT;
    double M = NEG_INF;
#pragma unroll
    for (int i = 0; i < NSPLIT; ++i)
      M = fmax(M, *cluster.map_shared_rank(sM + g, i));
    sW[e] = exp(*cluster.map_shared_rank(sM + g, r) - M);
  }
  __syncthreads();
  for (int g = tid; g < G; g += NT) {
    double Ls = 0.0;
#pragma unroll
    for (int r = 0; r < NSPLIT; ++r)
      Ls = fma(sW[g * NSPLIT + r], *cluster.map_shared_rank(sL + g, r), Ls);
    sLt[g] = Ls;
  }
  __syncthreads();
  for (int e = split + NSPLIT * tid; e < G * D; e += NSPLIT * NT) {
    const int g = e / D, d = e - g * D;
    // Every split's acc is read at once (unrolled loads), then combined in
    // a fixed order.
    double a[NSPLIT];
#pragma unroll
    for (int r = 0; r < NSPLIT; ++r)
      a[r] = *cluster.map_shared_rank(sAcc + e, r);
    double acc = 0.0;
#pragma unroll
    for (int r = 0; r < NSPLIT; ++r) acc = fma(sW[g * NSPLIT + r], a[r], acc);
    store(out + b * osb + (long long)(h * G + g) * osh + d,
          acc / fmax(sLt[g], 1e-30));
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// Slots of one pass: the largest share of the cache, capped so that its K
// and V take at most KV_PASS_BYTES.
int pass_slots(int S, int D, int esz) {
  const int share = (S + NSPLIT - 1) / NSPLIT;
  const int cap = KV_PASS_BYTES / (2 * D * esz);
  return share < cap ? share : cap;
}

// Slot groups of P V: enough that every thread has a (group, piece), at
// most MAX_PARTS, and their fp64 partials at most PART_BYTES.
int pv_parts(int G, int D) {
  int parts = NT / (D / 4);
  if (parts > MAX_PARTS) parts = MAX_PARTS;
  if (parts * G * D * 8 > PART_BYTES) parts = PART_BYTES / (G * D * 8);
  return parts < 1 ? 1 : parts;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* index,
           void* out, int B, int Hq, int Hkv, int S, int D,
           const long long* st, int window, double scale,
           cudaStream_t stream) {
  constexpr int VE = Vec<T>::N;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || D <= 0 ||
      D > MAX_D || D % VE != 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv, esz = sizeof(T);
  const int cap = pass_slots(S, D, esz);
  const int parts = pv_parts(G, D);
  const int smem = Layout(G, D, cap, parts, esz).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      decode_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && NSPLIT > 8)
    e = cudaFuncSetAttribute(decode_fwd<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NSPLIT, Hkv, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NSPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, decode_fwd<T>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), index, static_cast<T*>(out), G, S, D, cap,
      parts, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], window, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 10 element strides: q (batch, head), k (batch, head, seq),
// v (batch, head, seq), out (batch, head).  index: one int32 in device
// memory.  dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Returns the launch's CUDA error code (0 on success).
int odin_decode_attention_fwd(const void* q, const void* k, const void* v,
                              const void* index, void* out, int B, int Hq,
                              int Hkv, int S, int D,
                              const long long* strides, int window,
                              double scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(index);
  if (dtype == 0)
    return launch<float>(q, k, v, idx, out, B, Hq, Hkv, S, D, strides,
                         window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, idx, out, B, Hq, Hkv, S, D,
                                 strides, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
