// Tensor-core building blocks of the bf16 flash-attention kernels: the
// forward (flash_attention.cu, `flash_tc_kernel`) and its gradient
// (flash_attention_bwd.cu, `dkdv_tc_kernel`, `dq_tc_kernel`).
//
// Products run as `mma.sync` m16n8k16 (bf16 in, float32 accumulate) on
// fragments loaded by `ldmatrix` (`.trans` for an operand read across its
// rows) from shared tiles filled by `cp.async`.  A tile's rows hold the
// head dim padded to DP (a multiple of 16) plus 8 elements (16 bytes), so
// every 8-row phase of an `ldmatrix` hits 32 distinct banks.  Rows past the
// matrix and columns past d are zero-filled without a read.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tc {

using bf16 = __nv_bfloat16;

// elements between two rows of a shared tile of head dims padded to DP
template <int DP>
__host__ __device__ constexpr int stride() {
  return DP + 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (16, 8 or 4) from global to shared; src_bytes = 0 reads nothing
// and zero-fills the destination
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (16 x 16) of the columns 16·kk .. 16·kk + 15 of a 16-row
// float32 product held as C fragments c[8-column tile][4], rounded to
// bf16: the C layout of two neighbouring column tiles is the A layout.
__device__ __forceinline__ void a_from_c(const float (*c)[4], int kk,
                                         uint32_t* a) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// rows [row0, row0 + rows) of a matrix with `pitch` elements between rows
// into shared rows of stride<DP>(); rows >= n_rows and columns >= d
// zero-filled.  VEC elements (8 or 4) per copy; d is a multiple of VEC.
// The NTHR threads of the block share the copy.
template <int DP, int VEC, int NTHR>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* g,
                                          int64_t pitch, int row0, int rows,
                                          int n_rows, int d) {
  constexpr int kChunks = DP / VEC;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += NTHR) {
    const int r = idx / kChunks;
    const int col = (idx % kChunks) * VEC;
    const bool ok = row0 + r < n_rows && col < d;
    const bf16* src = ok ? g + (row0 + r) * pitch + col : g;
    cp_async<VEC * 2>(sm + r * stride<DP>() + col, src, ok ? VEC * 2 : 0);
  }
}

// 16-byte copies when `vec16` (d a multiple of 8, 16-byte aligned rows),
// else 8-byte ones
template <int DP, int NTHR>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g,
                                          int64_t pitch, int row0, int rows,
                                          int n_rows, int d, bool vec16) {
  if (vec16)
    load_rows<DP, 8, NTHR>(sm, g, pitch, row0, rows, n_rows, d);
  else
    load_rows<DP, 4, NTHR>(sm, g, pitch, row0, rows, n_rows, d);
}

// Opt `kernel` into `bytes` of dynamic shared memory (above 48 KB only
// after this), once per device: `raised` is the caller's flag array for
// this kernel.
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

}  // namespace flash_tc
