// Tensor-core building blocks shared by the chunked scans and their
// gradients (ssd.cu, wkv6.cu, ssd_bwd.cu, wkv6_bwd.cu).
//
// Products run as `mma.sync` m16n8k16 (bf16 in, float32 accumulate), fed
// by `ldmatrix` from shared tiles whose rows are padded by 16 bytes (every
// 8-row phase of an `ldmatrix` then hits 32 distinct banks).  An operand
// is carried as NP bf16 parts whose sum approximates it:
//   * an input that is bf16 already: one part, exact;
//   * a float32 value: hi = bf16(x), then each further part rounds what is
//     left (x - hi, ...): two parts keep about 16 mantissa bits, three
//     about 24, i.e. float32.
// A product of an NA-part and an NB-part operand sums the part products
// (i, j) with i + j < max(NA, NB): 1 x 2 parts -> 2 `mma`s (exact x 16 bits),
// 2 x 2 -> 3 (hi·hi, hi·lo, lo·hi), 3 x 3 -> 6 (the terms of order <= 2,
// as in 3xTF32).  The bf16 instances take one part per input and two per
// computed float32 operand; the float32 instances three of each.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// parts per input operand and per computed float32 operand
template <typename T>
struct Parts;
template <>
struct Parts<bf16> {
  static constexpr int kIn = 1, kCalc = 2;
};
template <>
struct Parts<float> {
  static constexpr int kIn = 3, kCalc = 3;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes = 0 reads nothing and
// zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// 4 bytes from global to shared (a float32 scalar); src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] · b[16x8], bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the parts products of an NA-part A fragment and an NB-part B fragment
template <int NA, int NB>
__device__ __forceinline__ void mma_parts(float* c,
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][2]) {
  constexpr int kMax = NA > NB ? NA : NB;
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (i + j < kMax) mma(c, a[i], b[j][0], b[j][1]);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t r) {
  const __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r);
  return __bfloat1622float2(v);
}

// (x0, x1) as NP packed bf16 parts: out[p] holds part p of both
template <int NP>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t* out) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    out[p] = *reinterpret_cast<const uint32_t*>(&h);
    if (p + 1 < NP) {
      const float2 f = __bfloat1622float2(h);
      x0 -= f.x;
      x1 -= f.y;
    }
  }
}

// The B fragment (k 16 x n 8) of a float32 matrix in shared memory, as NP
// bf16 parts: element (k, n) at m[k·ld + n] (`frag_b_rows`: a pair along k
// is two loads) or at m[n·ld + k] (`frag_b_cols`: one 8-byte load)
template <int NP>
__device__ __forceinline__ void frag_b_rows(const float* m, int ld, int lane,
                                            uint32_t (&b)[NP][2]) {
  const float* p = m + 2 * (lane & 3) * ld + (lane >> 2);
  uint32_t lo[NP], hi[NP];
  split2<NP>(p[0], p[ld], lo);
  split2<NP>(p[8 * ld], p[9 * ld], hi);
#pragma unroll
  for (int pp = 0; pp < NP; ++pp) {
    b[pp][0] = lo[pp];
    b[pp][1] = hi[pp];
  }
}
template <int NP>
__device__ __forceinline__ void frag_b_cols(const float* m, int ld, int lane,
                                            uint32_t (&b)[NP][2]) {
  const float* p = m + (lane >> 2) * ld + 2 * (lane & 3);
  const float2 x = *reinterpret_cast<const float2*>(p);
  const float2 y = *reinterpret_cast<const float2*>(p + 8);
  uint32_t lo[NP], hi[NP];
  split2<NP>(x.x, x.y, lo);
  split2<NP>(y.x, y.y, hi);
#pragma unroll
  for (int pp = 0; pp < NP; ++pp) {
    b[pp][0] = lo[pp];
    b[pp][1] = hi[pp];
  }
}

// The A fragment (m 16 x k 16) of values f(row, k) computed by the lane,
// as NP bf16 parts: rows g, g + 8 and k 2q, 2q + 1, 2q + 8, 2q + 9
template <int NP, typename F>
__device__ __forceinline__ void frag_a(F f, int lane, uint32_t (&a)[NP][4]) {
  const int g = lane >> 2, k = 2 * (lane & 3);
  uint32_t r[4][NP];
  split2<NP>(f(g, k), f(g, k + 1), r[0]);
  split2<NP>(f(g + 8, k), f(g + 8, k + 1), r[1]);
  split2<NP>(f(g, k + 8), f(g, k + 9), r[2]);
  split2<NP>(f(g + 8, k + 8), f(g + 8, k + 9), r[3]);
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[pp][e] = r[e][pp];
}

// the A fragment of a bf16 plane tile (row-major [m][k], row stride sp
// elements) at (row 0, column k0), NP planes `plane` elements apart
template <int NP>
__device__ __forceinline__ void ldsm_a(const bf16* sm, int sp, int plane,
                                       int k0, int lane, uint32_t (&a)[NP][4]) {
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
    ldsm_x4(sm + pp * plane + (lane & 15) * sp + k0 + (lane >> 4) * 8, a[pp]);
}

// two B fragments (n 0-7 and 8-15) of a bf16 plane tile: `ldsm_b_nk` for
// B[k][n] stored as rows n (row n at sm + n·sp, k from k0), `ldsm_b_kn`
// for B[k][n] stored as rows k (row k at sm + k·sp, n from n0)
template <int NP>
__device__ __forceinline__ void ldsm_b_nk(const bf16* sm, int sp, int plane,
                                          int k0, int lane,
                                          uint32_t (&b)[2][NP][2]) {
#pragma unroll
  for (int pp = 0; pp < NP; ++pp) {
    uint32_t r[4];
    ldsm_x4(sm + pp * plane + ((lane & 7) + ((lane >> 4) << 3)) * sp + k0 +
                ((lane >> 3) & 1) * 8,
            r);
    b[0][pp][0] = r[0];
    b[0][pp][1] = r[1];
    b[1][pp][0] = r[2];
    b[1][pp][1] = r[3];
  }
}
template <int NP>
__device__ __forceinline__ void ldsm_b_kn(const bf16* sm, int sp, int plane,
                                          int n0, int lane,
                                          uint32_t (&b)[2][NP][2]) {
#pragma unroll
  for (int pp = 0; pp < NP; ++pp) {
    uint32_t r[4];
    ldsm_x4_trans(sm + pp * plane + ((lane & 7) + ((lane >> 3) & 1) * 8) * sp +
                      n0 + (lane >> 4) * 8,
                  r);
    b[0][pp][0] = r[0];
    b[0][pp][1] = r[1];
    b[1][pp][0] = r[2];
    b[1][pp][1] = r[3];
  }
}

// the value at (r, c) of a bf16 plane tile, its NP parts summed
template <int NP>
__device__ __forceinline__ float plane_at(const bf16* sm, int sp, int plane,
                                          int r, int c) {
  float x = 0.f;
#pragma unroll
  for (int pp = 0; pp < NP; ++pp) x += __bfloat162float(sm[pp * plane + r * sp + c]);
  return x;
}

// A ROWS x COLS tile of a T matrix (row r at g + r·pitch) into NP bf16
// planes in shared memory (row stride `sp` elements, planes `plane`
// elements apart); entries at r >= nr or c >= nc are zeros.  `vec`: T is
// bf16, NP = 1, nc and pitch are multiples of 8 and g is 16-byte aligned,
// so whole 16-byte pieces go by `cp.async` (commit and wait are the
// caller's); otherwise element by element, split into parts.  The NTHR
// threads of the caller share the copy; shapes are compile-time, so the
// index arithmetic is shifts and masks.
template <typename T, int NP, int ROWS, int COLS, int NTHR>
__device__ __forceinline__ void stage(bf16* sm, int sp, int plane, const T* g,
                                      int64_t pitch, int nr, int nc, bool vec,
                                      int tid) {
  if constexpr (NP == 1 && sizeof(T) == 2) {
    if (vec) {
      constexpr int kPieces = COLS / 8;
#pragma unroll
      for (int e = tid; e < ROWS * kPieces; e += NTHR) {
        const int r = e / kPieces, c = (e % kPieces) * 8;
        const bool ok = r < nr && c < nc;
        cp_async16(sm + r * sp + c, ok ? g + r * pitch + c : g, ok ? 16 : 0);
      }
      return;
    }
  }
#pragma unroll 4
  for (int e = tid; e < ROWS * COLS; e += NTHR) {
    const int r = e / COLS, c = e % COLS;
    float x = (r < nr && c < nc) ? to_f(g[r * pitch + c]) : 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const bf16 h = __float2bfloat16(x);
      sm[p * plane + r * sp + c] = h;
      x -= __bfloat162float(h);
    }
  }
}

// a float32 (or packed bf16) tile of ROWS x COLS 4-byte words (COLS a
// multiple of 4; g and pitch 16-byte aligned) into shared rows of stride
// `sp` words, by `cp.async`
template <int ROWS, int COLS, int NTHR, typename W>
__device__ __forceinline__ void stage_words(W* sm, int sp, const W* g,
                                            int64_t pitch, int tid) {
  static_assert(sizeof(W) == 4, "4-byte words");
  constexpr int kPieces = COLS / 4;
#pragma unroll
  for (int e = tid; e < ROWS * kPieces; e += NTHR) {
    const int r = e / kPieces, c = (e % kPieces) * 4;
    cp_async16(sm + r * sp + c, g + r * pitch + c, 16);
  }
}

// barrier `id` (1..15) over `threads` threads of the block (a multiple of
// 32), for a group of warps that share a shared-memory reduction
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Opt `kernel` into `bytes` of dynamic shared memory, once per device:
// `raised` is the caller's flag array for this kernel.
template <typename K>
inline cudaError_t raise_smem(K kernel, int bytes, bool* raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && raised[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) raised[dev] = true;
  return err;
}

}  // namespace scan
