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
// (2 * B * Hq * pairs * D operations each) -- the work grows as S^2 while
// the bytes (q, k, v, o once each) grow as S; for short sequences the bytes
// and the launch.  It keeps the S x S score matrix out of device memory (a
// warp's 16 x 64 score tile lives in its mma fragments), reads each K/V
// tile once per 64 query rows, and skips tiles beyond the causal frontier
// or outside the window, which halves the causal work.
//
// Both products run on the tensor cores, mma.sync m16n8k8 with TF32
// operands and fp32 accumulators, in the 3xTF32 split: each fp32 operand x
// is hi = tf32(x) plus lo = tf32(x - hi) (cvt.rna), and a product is
// lo.hi + hi.lo + hi.hi, the small terms accumulated first (CUTLASS's
// fast-fp32 path).  That carries about 22 significant bits into the fp32
// accumulator; the dropped lo.lo is about 2^-22 of a product.  One TF32
// product keeps 11 bits (a relative error near 2^-11 in every score), far
// outside the fp32 limit of 2e-5; the split meets it.  At 495 TFLOP/s of
// dense TF32, three products bound the fp32-exact work at about 165
// TFLOP/s, 2.5x the 67 TFLOP/s of the fp32 CUDA cores.  mma.sync and not
// wgmma: wgmma takes TF32 operands only K-major from shared memory, and V,
// the B operand of P V, is not; mma.sync's 16 x 8 tiles also follow D 56,
// D 80 and a ragged S.
//
// Tiles: one block of 4 warps per (64-row query tile, query head, batch),
// each warp owning 16 rows, the causal blocks with the most key tiles
// first; the KV axis is a loop inside the block over tiles of 64 keys.  K
// and V tiles take turns in a two-stage ring of 16-byte cp.async copies
// (zero-filled past S): V(t) lands while S(t) = Q K(t)^T runs, K(t+1)
// while P V(t) runs.  The thread that copied a piece splits it when it
// lands: hi in place, lo into the tile's lo buffer, so each element is
// split once per block, not once per use; Q is split once when the block
// starts.  D is padded with zero columns to the template's 64 or 128, over
// which every product runs with no test per tile (a test per 8-column
// tile, with the swizzled address computed at each load, put a branch and
// integer work before every load in the SASS).  A tile that every row of
// the block sees whole skips the mask.
//
// Fragments: the k index of an m16n8k8 product may be permuted, as long as
// A and B agree.  Slot t of a thread's k pair carries column 2t of the
// 8-wide slice and slot t + 4 column 2t + 1.  Then (i) A fragments of Q and
// B fragments of K are adjacent pairs of a shared-memory row (one 8-byte
// load each), and (ii) the accumulator fragment of S, which holds columns
// 2t and 2t + 1 of rows g and g + 8, is already the A fragment of P V:
// P goes from the online softmax to the second product in registers, with
// no shuffle and no shared memory.  V's B fragments are two scalar loads of
// one column.  Shared tiles are stored with the 8-word column groups of row
// r XOR-swizzled by ((r & 3) ^ ((r >> 2) & 1)), which makes both the pair
// loads (4 rows x 8 words a half-warp) and the column loads (rows 2t, 2t + 1
// across 8 columns) free of bank conflicts; each lane's swizzled offsets are
// computed once (Lanes), so every fragment load is a register plus an
// immediate.  Each 3xTF32 product issues its three terms over 8 tiles in
// turn, so 8 independent mma separate two on one accumulator.  These pieces
// live in tf32_mma.cuh, which the backward shares.
//
// Online softmax on the accumulator fragments: each row's max by two quad
// shuffles per tile, the row sums kept per thread and added across the quad
// at the end.
//
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W): 0.062 ms at
// q [8, 14, 256, 64], k/v [8, 2, 256, 64], causal, with the LSE (fp32
// scaled_dot_product_attention: 0.216 ms), 0.118 ms at [1, 14, 1024, 64]
// (0.369 ms).  That is about 57 TFLOP/s of TF32 products, a fifth of what
// mma.sync TF32 reaches on this card (about 300 TFLOP/s,
// tools/k1_fp32_variants.py --mma-rate).  Rounding to TF32 by (bits +
// 0x1000) & ~0x1fff, two integer instructions where ptxas lowers
// cvt.rna.tf32.f32 to four with a test for inf and NaN, ran 5-6% faster
// (tools/k1_fp32_variants.py) but turns CUDA's canonical NaN 0x7fffffff into
// -0, so cvt.rna stays.  ptxas: 168 registers at width 64 and 216-219 at
// 128, no spills; 96 KB of dynamic shared memory at 64 (two blocks an SM),
// 192 KB at 128.
//
// Layout: q [B, Hq, S, D] and k, v [B, Hkv, S, D] given by element strides
// (batch, head, sequence; the head-dim stride must be 1), so the model's
// [B, S, H, D] projections are read in place.  The output is written with
// its own strides.  Any S (the ragged last tile is masked), D <= 128 with
// D % 4 == 0, fp32 inputs and accumulation.  Strides that are not multiples
// of 4 elements, or bases not 16-byte aligned, take 4-byte copies.
//
// A second entry point, odin_flash_attention_fwd_lse, is the same kernel
// that also writes each row's log-sum-exp of its scaled scores,
// m + log(max(l, 1e-30)), as fp32 [B, Hq, S]: the saved statistic from
// which the backward (flash_attention_bwd.cu) rebuilds the probabilities.
// The LSE write is a compile-time branch, so the first entry point's code
// is what it was without it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block (16 per warp)
constexpr int BK = 64;          // keys per K/V tile
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

template <int DPM, bool LSE>
__global__ void __launch_bounds__(NT)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int group, int S, int D, long long qsb,
          long long qsh, long long qss, long long ksb, long long ksh,
          long long kss, long long vsb, long long vsh, long long vss,
          long long osb, long long osh, long long oss, int causal, int window,
          float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int lds = DPM;              // row stride of every tile
  float* sQ = smem;                     // [BQ] rows each, swizzled
  float* sQl = sQ + BQ * lds;
  float* sK = sQl + BQ * lds;           // [BK] rows each
  float* sKl = sK + BK * lds;
  float* sV = sKl + BK * lds;
  float* sVl = sV + BK * lds;

  const int tid = threadIdx.x, warp = tid >> 5;
  const Lanes L(lds);
  const int g = L.g, t = L.t;
  // Causal: the query tiles with the most key tiles first.
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int r0 = warp * 16;             // the warp's rows in the tile
  const Pieces pieces(D, vec);

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;
  float* ob = o + b * osb + h * osh;

  // Columns [D, DPM) are never copied: zero them in every tile (the
  // products run over all DPM columns).
  if (D < DPM) {
    const int w = DPM - D;
    for (int e = tid; e < (2 * BQ + 4 * BK) * w; e += NT)
      smem[at(e / w, D + e % w, lds)] = 0.f;
  }

  // Live KV tiles, as the TPU kernel's pl.when(live) culls them.
  const int nk = (S + BK - 1) / BK;
  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_end = causal ? q_last / BK + 1 : nk;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // oldest key any row of the tile sees
    if (lo > 0) kt_begin = lo / BK;
  }

  copy_tile(sQ, qb, qss, q0, BQ, S, lds, pieces);
  cp_async_commit();
  copy_tile(sK, kb, kss, kt_begin * BK, BK, S, lds, pieces);
  cp_async_commit();
  cp_async_wait<1>();                   // this thread's pieces of Q
  split_tile(sQ, sQl, BQ, lds, pieces);

  float acc[DPM / 8][4];
#pragma unroll
  for (int n = 0; n < DPM / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();                 // this thread's pieces of K(kt)
    __syncthreads();                    // every warp is done with V(kt - 1)
    copy_tile(sV, vb, vss, k0, BK, S, lds, pieces);
    cp_async_commit();
    split_tile(sK, sKl, BK, lds, pieces);
    __syncthreads();

    // S = Q K^T: the warp's 16 rows x 64 keys.
    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DPM / 8; ++ks) {
      uint32_t ah[4], al[4], bh[BK / 8][2], bl[BK / 8][2];
      frag_a(sQ, sQl, L, r0, ks, lds, ah, al);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        frag_b_row(sK, sKl, L, 8 * j, ks, lds, bh[j], bl[j]);
      mma3<BK / 8>(sc, ah, al, bh, bl);
    }

    // Online softmax on the fragments: element e of tile j is row
    // g + 8 (e >> 1), key 8 j + 2 t + (e & 1).  A tile that every row sees
    // whole skips the mask.
    const bool whole = k0 + BK <= S && (!causal || q0 >= k0 + BK - 1) &&
                       (window <= 0 || q0 + BQ - 1 - k0 < window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + r0 + g + 8 * (e >> 1);
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        bool live = whole || kp < S;
        if (!whole && causal) live = live && qp >= kp;
        if (!whole && window > 0) live = live && qp - kp < window;
        const float s = live ? sc[j][e] * scale : NEG_INF;
        sc[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[j][e] - m[e >> 1]);
        sc[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < DPM / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    cp_async_wait<0>();                 // this thread's pieces of V(kt)
    __syncthreads();                    // every warp is done with K(kt)
    if (kt + 1 < kt_end) {
      copy_tile(sK, kb, kss, k0 + BK, BK, S, lds, pieces);
      cp_async_commit();
    }
    split_tile(sV, sVl, BK, lds, pieces);
    __syncthreads();

    // acc += P V: P's A fragments are S's accumulator fragments.  Eight
    // head-dim tiles at a time.
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      uint32_t ph[4], pl[4];
      frag_acc(sc[j], ph, pl);
#pragma unroll
      for (int n0 = 0; n0 < DPM / 8; n0 += 8) {
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          frag_b_col(sV, sVl, L, 8 * j, n0 + n, lds, bh[n], bl[n]);
        mma3<8>(acc + n0, ph, pl, bh, bl);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r0 + g + 8 * i;
    if (qp >= S) continue;
    float* orow = ob + (long long)qp * oss;
#pragma unroll
    for (int n = 0; n < DPM / 8; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < D)   // D % 4 == 0: c + 1 < D too
        *reinterpret_cast<float2*>(orow + c) =
            make_float2(acc[n][2 * i] / l[i], acc[n][2 * i + 1] / l[i]);
    }
    if (LSE && t == 0)   // lse is [B, Hq, S], contiguous
      lse[((long long)b * gridDim.y + h) * S + qp] = m[i] + logf(l[i]);
  }
}

int smem_bytes(int D) {
  const int lds = D <= 64 ? 64 : 128;     // the kernel's DPM
  return (2 * BQ + 4 * BK) * lds * (int)sizeof(float);
}

// 16-byte copies need 16-byte aligned bases and strides that are multiples
// of 4 elements (a stride of an extent-1 dimension is never used).
bool copies16(const void* p, const long long* st, int B, int H, int S) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         (B == 1 || st[0] % 4 == 0) && (H == 1 || st[1] % 4 == 0) &&
         (S == 1 || st[2] % 4 == 0);
}

template <bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int S, int D, const long long* st,
           int causal, int window, float scale, cudaStream_t stream) {
  if (D <= 0 || D > MAX_D || D % 4 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(D);
  const int vec = copies16(q, st, B, Hq, S) && copies16(k, st + 3, B, Hkv, S) &&
                  copies16(v, st + 6, B, Hkv, S);
  auto kernel = D <= 64 ? flash_fwd<64, LSE> : flash_fwd<128, LSE>;
  // Above 48 KB a kernel must opt in to dynamic shared memory.  The opt-in
  // is per device, so it is made on every call (it costs microseconds).
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hq / Hkv, S,
      D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, scale, vec);
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
  return launch<false>(q, k, v, o, nullptr, B, Hq, Hkv, S, D, strides, causal,
                       window, scale, static_cast<cudaStream_t>(stream));
}

// The same, and each row's log-sum-exp into lse, fp32 [B, Hq, S]
// contiguous.
int odin_flash_attention_fwd_lse(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int Hq, int Hkv,
                                 int S, int D, const long long* strides,
                                 int causal, int window, float scale,
                                 void* stream) {
  return launch<true>(q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, S, D,
                      strides, causal, window, scale,
                      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of a launch at head dim D.
int odin_flash_attention_smem_bytes(int D) { return smem_bytes(D); }

const char* odin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
