// The 3xTF32 tile machinery that K1's fp32 kernels share
// (flash_attention.cu, flash_attention_bwd.cu): shared-memory tiles filled
// by cp.async and split once into TF32 hi and lo, the lanes' fragment
// addressing, and the m16n8k8 TF32 products run as lo.hi + hi.lo + hi.hi.
// Both kernels run blocks of NT threads.  K3's fp32 route (ssd_scan.cu)
// takes its copies, splits and products, with fragment reads of its own
// padded tiles.  Each kernel's source includes it once, outside its own
// anonymous namespace.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;         // threads per block (4 warps)

// Tiles are rows of lds floats (lds a multiple of 32); element (r, c) lies
// at at(r, c, lds), the 8-word column groups of row r XOR-swizzled by
// swz(r).
__device__ __forceinline__ int swz(int r) {
  return ((r & 3) ^ ((r >> 2) & 1)) << 3;
}

__device__ __forceinline__ int at(int r, int c, int lds) {
  return r * lds + (c ^ swz(r));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The pieces of a tile a thread copies and later splits: pieces tid,
// tid + NT, ... of rows of D / w pieces, w = 4 elements (16-byte copies) or
// 1; (r, c) advance by (dr, dc) without a division.
struct Pieces {
  int w, per_row, r, c, dr, dc;
  __device__ Pieces(int D, bool vec) {
    w = vec ? 4 : 1;
    per_row = D / w;
    r = threadIdx.x / per_row;
    c = threadIdx.x % per_row;
    dr = NT / per_row;
    dc = NT % per_row;
  }
};

// Copy rows [r0, r0 + R) of one head (D columns) into a shared tile; rows
// at or past S are zero-filled.
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long ss, int r0, int R, int S,
                                          int lds, const Pieces& p) {
  for (int r = p.r, c = p.c; r < R;) {
    const bool ok = r0 + r < S;
    const float* s = src + (ok ? (long long)(r0 + r) * ss : 0) + c * p.w;
    float* d = dst + at(r, c * p.w, lds);
    if (p.w == 4)
      cp_async16(d, s, ok);
    else
      cp_async4(d, s, ok);
    r += p.dr;
    c += p.dc;
    if (c >= p.per_row) {
      c -= p.per_row;
      ++r;
    }
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 22 bits, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// Split the pieces this thread copied once they have landed: hi in place,
// lo into the lo tile.
__device__ __forceinline__ void split_tile(float* hi, float* lo, int R,
                                           int lds, const Pieces& p) {
  for (int r = p.r, c = p.c; r < R;) {
    const int i = at(r, c * p.w, lds);
    if (p.w == 4) {
      const float4 x = *reinterpret_cast<const float4*>(hi + i);
      uint32_t h[4], l[4];
      split(x.x, h[0], l[0]);
      split(x.y, h[1], l[1]);
      split(x.z, h[2], l[2]);
      split(x.w, h[3], l[3]);
      *reinterpret_cast<uint4*>(hi + i) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + i) = make_uint4(l[0], l[1], l[2], l[3]);
    } else {
      uint32_t h, l;
      split(hi[i], h, l);
      hi[i] = __uint_as_float(h);
      lo[i] = __uint_as_float(l);
    }
    r += p.dr;
    c += p.dc;
    if (c >= p.per_row) {
      c -= p.per_row;
      ++r;
    }
  }
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// Each lane's fragment addressing, computed once.  Row R + g (R a multiple
// of 8) has swizzle swz(g), so the pair at columns 8 ks + 2t, 8 ks + 2t + 1
// lies at pa + R lds + (8 ks ^ sa); row R + 2t + e has swizzle swz(2t + e),
// so column 8 n + g lies at pc[e] + R lds + (8 n ^ sc[e]).  With R, ks and n
// compile-time, every load is a register plus an immediate.
struct Lanes {
  int g, t, pa, sa, pc[2], sc[2];
  __device__ Lanes(int lds) {
    const int lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    pa = g * lds + 2 * t;
    sa = swz(g);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      pc[e] = (2 * t + e) * lds + g;
      sc[e] = swz(2 * t + e);
    }
  }
};

__device__ __forceinline__ float2 pair(const float* tile, const Lanes& L,
                                       int R, int ks, int lds) {
  return *reinterpret_cast<const float2*>(tile + L.pa + R * lds +
                                          ((8 * ks) ^ L.sa));
}

__device__ __forceinline__ uint32_t col(const float* tile, const Lanes& L,
                                        int R, int n, int e, int lds) {
  return bits(tile[L.pc[e] + R * lds + ((8 * n) ^ L.sc[e])]);
}

// d += a b, m16n8k8, TF32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[n] += a b[n] for N tiles, in 3xTF32: lo.hi and hi.lo first, then
// hi.hi.  Each term runs over all tiles before the next, so N independent
// products separate two that share an accumulator.
template <int N>
__device__ __forceinline__ void mma3(float (*d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[N][2],
                                     const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ah, bh[n]);
}

// The A fragments (hi, lo) of rows R + g and R + g + 8 of a split tile at
// columns 8 ks + 2t, + 1 (k slots t and t + 4).
__device__ __forceinline__ void frag_a(const float* hi, const float* lo,
                                       const Lanes& L, int R, int ks, int lds,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float2 h0 = pair(hi, L, R, ks, lds), h1 = pair(hi, L, R + 8, ks, lds);
  const float2 l0 = pair(lo, L, R, ks, lds), l1 = pair(lo, L, R + 8, ks, lds);
  ah[0] = bits(h0.x); ah[1] = bits(h1.x);
  ah[2] = bits(h0.y); ah[3] = bits(h1.y);
  al[0] = bits(l0.x); al[1] = bits(l1.x);
  al[2] = bits(l0.y); al[3] = bits(l1.y);
}

// The B fragment of row R + g (its n index) at columns 8 ks + 2t, + 1.
__device__ __forceinline__ void frag_b_row(const float* hi, const float* lo,
                                           const Lanes& L, int R, int ks,
                                           int lds, uint32_t (&bh)[2],
                                           uint32_t (&bl)[2]) {
  const float2 h = pair(hi, L, R, ks, lds), l = pair(lo, L, R, ks, lds);
  bh[0] = bits(h.x); bh[1] = bits(h.y);
  bl[0] = bits(l.x); bl[1] = bits(l.y);
}

// The B fragment of column 8 n + g (its n index) at rows R + 2t, R + 2t + 1.
__device__ __forceinline__ void frag_b_col(const float* hi, const float* lo,
                                           const Lanes& L, int R, int n,
                                           int lds, uint32_t (&bh)[2],
                                           uint32_t (&bl)[2]) {
  bh[0] = col(hi, L, R, n, 0, lds); bh[1] = col(hi, L, R, n, 1, lds);
  bl[0] = col(lo, L, R, n, 0, lds); bl[1] = col(lo, L, R, n, 1, lds);
}

// The A fragments of an accumulator tile (rows g, g + 8; columns 2t, 2t + 1),
// split into hi and lo.
__device__ __forceinline__ void frag_acc(const float (&x)[4], uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  split(x[0], ah[0], al[0]);
  split(x[2], ah[1], al[1]);
  split(x[1], ah[2], al[2]);
  split(x[3], ah[3], al[3]);
}

// The same split with ties rounded to even: cvt.rn.tf32.f32 is one
// instruction on sm_90 (F2FP), where cvt.rna takes four (a finiteness
// test, an add, a select and a mask), so a split costs three instructions
// where split's takes up to nine.  hi + lo carries x to about 22 bits as
// before.  K3's backward (ssd_scan_bwd.cu) splits with these.
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_rn(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

__device__ __forceinline__ void frag_acc_rn(const float (&x)[4],
                                            uint32_t (&ah)[4],
                                            uint32_t (&al)[4]) {
  split_rn(x[0], ah[0], al[0]);
  split_rn(x[2], ah[1], al[1]);
  split_rn(x[1], ah[2], al[2]);
  split_rn(x[3], ah[3], al[3]);
}

}  // namespace
