// Flash-attention backward: dQ, dK and dV of causal / sliding-window GQA
// attention, the gradient of csrc/flash_attention.cu's function.
//
// Replaces: no Pallas kernel.  The reference trains by differentiating its
// jnp attention (src/repro/models/attention.py:35) under jax.value_and_grad
// (src/repro/training/loop.py:36), and none of its Pallas kernels has a
// backward; the port's prefill attention on the card is the hand-written
// forward kernel, so its gradient is a kernel of its own, behind a
// torch.autograd.Function (kernels/ops.py).
//
// Function: q [B, Sq, H, d], k/v [B, Sk, Hkv, d], o and dO [B, Sq, H, d]
// -> dQ [B, Sq, H, d], dK/dV [B, Sk, Hkv, d], float32 or bf16 in and out,
// float32 inside.  Query head h reads KV head h / (H / Hkv).  With
// S = scale·Q·Kᵀ under the causal and window masks (a masked pair is the
// forward's -1e30, so its P is exactly 0) and P = softmax(S):
//   D_i  = Σ_c dO_ic·O_ic                 (rowsum(dO ∘ O))
//   dP   = dO·Vᵀ,  dS = P ∘ (dP − D)
//   dV   = Pᵀ·dO,  dQ = scale·dS·K,  dK = scale·dSᵀ·Q
// dK and dV of a KV head sum over the H / Hkv query heads of its group.
//
// Bound on an H100: 10·H·d operations per unmasked (query, key) pair (five
// products of the pair with a d-vector: Q·Kᵀ again, dO·Vᵀ, P·dO, dS·K,
// dS·Q) against q, o, dO, dQ and k, v, dK, dV moved once; at qwen3-8b's
// 4,096-token causal call (32 / 8 heads of 128, bf16) that is 3.4e11
// operations, 0.35 ms at the tensor cores' 989 TFLOP/s: operations bound
// it by far.  This first kernel is deliberately simple: float32 CUDA-core
// arithmetic for both input types (bf16 is widened on load), no tensor
// cores, no wgmma or TMA, and the row log-sum-exp recomputed rather than
// saved by the forward kernel (which this PR does not edit).  It is many
// times its bound; making it fast is later work (PERF.md).
//
// Three launches, each writing its outputs from one thread in a fixed
// order, with no atomics, so two runs give the same bits:
//   (a) stats_kernel: a block per (32 query rows, batch·head); each row's
//       log-sum-exp over its unmasked keys (online max and sum, recomputed
//       from q and k) and D.
//   (b) dkdv_kernel: a block per (32 keys, batch·KV head); every key row
//       keeps its k, v and its dK, dV sums in registers and walks the
//       group's query heads and the query tiles its masks reach, staged in
//       shared memory; no other block writes its keys.
//   (c) dq_kernel: a block per (32 query rows, batch·head); every row keeps
//       its q, dO and dQ sum in registers and walks the key tiles its masks
//       reach, staged in shared memory.
// Eight lanes share a row (of q or of k), each holding every eighth float4
// chunk of the head dim; a dot product is reduced over the eight lanes with
// a butterfly of shuffles, which leaves the same bits in every lane.
// The TPU-era design of the forward (the sequential key-block grid) does
// not apply: each block's loop takes the place of a sequential dimension,
// and nothing is carried between blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;                     // largest head dim taken
constexpr int kLanes = 8;                      // lanes sharing one row
constexpr int kChunks = kMaxD / 4 / kLanes;    // float4 chunks per lane
constexpr int kRows = 32;                      // rows (query or key) a block owns
constexpr int kTile = 32;                      // rows staged per shared tile
constexpr int kThreads = kRows * kLanes;       // 256

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float s, float4 x, float4 y) {
  return make_float4(fmaf(s, x.x, y.x), fmaf(s, x.y, y.y),
                     fmaf(s, x.z, y.z), fmaf(s, x.w, y.w));
}

// the sum over the eight lanes of a row, the same bits in each of them
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// the lane's dot product of two rows held as chunks, summed over the row
__device__ __forceinline__ float row_dot(const float4 (&a)[kChunks],
                                         const float4* b, int lane, int nch) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = lane + kLanes * t;
    if (c < nch) s = dot4(a[t], b[c], s);
  }
  return row_sum(s);
}

__device__ __forceinline__ bool unmasked(int i, int j, int sq, int sk,
                                         int causal, int window) {
  return i < sq && j < sk && (!causal || j <= i) &&
         (!window || i - j < window);
}

// the lane's chunks of row `row` of a [.., d] tensor at element offset off
template <typename T>
__device__ __forceinline__ void load_row(float4 (&r)[kChunks], const T* p,
                                         int64_t off, bool ok, int lane,
                                         int nch) {
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = lane + kLanes * t;
    r[t] = (ok && c < nch) ? load4(p + off + 4 * c) : zero4();
  }
}

template <typename T>
__device__ __forceinline__ void store_row(T* p, int64_t off,
                                          const float4 (&r)[kChunks],
                                          float scale, int lane, int nch) {
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = lane + kLanes * t;
    if (c < nch)
      store4(p + off + 4 * c, make_float4(r[t].x * scale, r[t].y * scale,
                                          r[t].z * scale, r[t].w * scale));
  }
}

// rows r0 .. r0 + kTile - 1 of one head of a [B, S, heads, d] tensor into
// shared memory as float4 chunks; rows at or past `s` are zeros
template <typename T>
__device__ __forceinline__ void stage(float4 (*dst)[kMaxD / 4], const T* p,
                                      int b, int r0, int s, int heads,
                                      int head, int d) {
  const int nch = d / 4;
  for (int idx = threadIdx.x; idx < kTile * nch; idx += kThreads) {
    const int r = idx / nch;
    const int c = idx % nch;
    const int pos = r0 + r;
    dst[r][c] = pos < s ? load4(p + ((static_cast<int64_t>(b) * s + pos) *
                                         heads + head) * d + 4 * c)
                        : zero4();
  }
}

// (a): lse[b, h, i] = log Σ_j exp(S_ij) over unmasked keys, delta[b, h, i]
// = Σ_c dO_ic·O_ic
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ lse, float* __restrict__ delta, int sq,
                 int sk, int h, int hkv, int d, float scale, int causal,
                 int window) {
  __shared__ float4 ks[kTile][kMaxD / 4];
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh % h;
  const int kvh = head / (h / hkv);
  const int i0 = blockIdx.x * kRows;
  const int i = i0 + row;
  const int nch = d / 4;
  const int64_t off = ((static_cast<int64_t>(b) * sq + i) * h + head) * d;

  float4 qr[kChunks], a[kChunks], g[kChunks];
  load_row(qr, q, off, i < sq, lane, nch);
  load_row(a, o, off, i < sq, lane, nch);
  load_row(g, dout, off, i < sq, lane, nch);
  float dsum = 0.f;
#pragma unroll
  for (int t = 0; t < kChunks; ++t) dsum = dot4(g[t], a[t], dsum);
  dsum = row_sum(dsum);

  const int k_begin = window ? max(0, i0 - window + 1) : 0;
  const int k_end = causal ? min(sk, i0 + kRows) : sk;
  float m = -INFINITY;
  float l = 0.f;
  for (int j0 = k_begin; j0 < k_end; j0 += kTile) {
    __syncthreads();
    stage(ks, k, b, j0, sk, hkv, kvh, d);
    __syncthreads();
    const int n = min(kTile, k_end - j0);
    for (int r = 0; r < n; ++r) {
      const float s = row_dot(qr, ks[r], lane, nch) * scale;
      if (unmasked(i, j0 + r, sq, sk, causal, window)) {
        if (s > m) {
          l = l * expf(m - s) + 1.f;
          m = s;
        } else {
          l += expf(s - m);
        }
      }
    }
  }
  if (i < sq && lane == 0) {
    const int64_t at = static_cast<int64_t>(bh) * sq + i;
    lse[at] = l > 0.f ? m + logf(l) : INFINITY;   // no unmasked key: P = 0
    delta[at] = dsum;
  }
}

// (b): dK, dV of 32 keys of one KV head, summed over its query heads
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int sq, int sk, int h, int hkv, int d,
                float scale, int causal, int window) {
  __shared__ float4 qs[kTile][kMaxD / 4];
  __shared__ float4 gs[kTile][kMaxD / 4];
  __shared__ float ls[kTile];
  __shared__ float ds_[kTile];
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int bk = blockIdx.y;
  const int b = bk / hkv;
  const int kvh = bk % hkv;
  const int group = h / hkv;
  const int j0 = blockIdx.x * kRows;
  const int j = j0 + row;
  const int nch = d / 4;
  const int64_t off = ((static_cast<int64_t>(b) * sk + j) * hkv + kvh) * d;

  float4 kr[kChunks], vr[kChunks], dkr[kChunks], dvr[kChunks];
  load_row(kr, k, off, j < sk, lane, nch);
  load_row(vr, v, off, j < sk, lane, nch);
#pragma unroll
  for (int t = 0; t < kChunks; ++t) dkr[t] = dvr[t] = zero4();

  // queries some key of this tile sees: at or after the first key
  // (causal), less than `window` after the last one (window)
  const int i_begin = causal ? j0 : 0;
  const int i_end = window ? min(sq, j0 + kRows - 1 + window) : sq;
  for (int gi = 0; gi < group; ++gi) {
    const int head = kvh * group + gi;
    const float* lse_h = lse + (static_cast<int64_t>(b) * h + head) * sq;
    const float* delta_h = delta + (static_cast<int64_t>(b) * h + head) * sq;
    for (int q0 = i_begin; q0 < i_end; q0 += kTile) {
      __syncthreads();
      stage(qs, q, b, q0, sq, h, head, d);
      stage(gs, dout, b, q0, sq, h, head, d);
      if (threadIdx.x < kTile) {
        const int i = q0 + threadIdx.x;
        ls[threadIdx.x] = i < sq ? lse_h[i] : INFINITY;
        ds_[threadIdx.x] = i < sq ? delta_h[i] : 0.f;
      }
      __syncthreads();
      const int n = min(kTile, i_end - q0);
      for (int r = 0; r < n; ++r) {
        const float s = row_dot(kr, qs[r], lane, nch) * scale;
        const float dp = row_dot(vr, gs[r], lane, nch);
        if (!unmasked(q0 + r, j, sq, sk, causal, window)) continue;
        const float p = expf(s - ls[r]);
        const float dsc = p * (dp - ds_[r]);
#pragma unroll
        for (int t = 0; t < kChunks; ++t) {
          const int c = lane + kLanes * t;
          if (c < nch) {
            dvr[t] = axpy4(p, gs[r][c], dvr[t]);
            dkr[t] = axpy4(dsc, qs[r][c], dkr[t]);
          }
        }
      }
    }
  }
  if (j < sk) {
    store_row(dk, off, dkr, scale, lane, nch);
    store_row(dv, off, dvr, 1.f, lane, nch);
  }
}

// (c): dQ of 32 query rows of one head
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int sq, int sk, int h, int hkv, int d,
              float scale, int causal, int window) {
  __shared__ float4 ks[kTile][kMaxD / 4];
  __shared__ float4 vs[kTile][kMaxD / 4];
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh % h;
  const int kvh = head / (h / hkv);
  const int i0 = blockIdx.x * kRows;
  const int i = i0 + row;
  const int nch = d / 4;
  const int64_t off = ((static_cast<int64_t>(b) * sq + i) * h + head) * d;

  float4 qr[kChunks], gr[kChunks], dqr[kChunks];
  load_row(qr, q, off, i < sq, lane, nch);
  load_row(gr, dout, off, i < sq, lane, nch);
#pragma unroll
  for (int t = 0; t < kChunks; ++t) dqr[t] = zero4();
  const int64_t at = static_cast<int64_t>(bh) * sq + i;
  const float lse_i = i < sq ? lse[at] : INFINITY;
  const float delta_i = i < sq ? delta[at] : 0.f;

  const int k_begin = window ? max(0, i0 - window + 1) : 0;
  const int k_end = causal ? min(sk, i0 + kRows) : sk;
  for (int j0 = k_begin; j0 < k_end; j0 += kTile) {
    __syncthreads();
    stage(ks, k, b, j0, sk, hkv, kvh, d);
    stage(vs, v, b, j0, sk, hkv, kvh, d);
    __syncthreads();
    const int n = min(kTile, k_end - j0);
    for (int r = 0; r < n; ++r) {
      const float s = row_dot(qr, ks[r], lane, nch) * scale;
      const float dp = row_dot(gr, vs[r], lane, nch);
      if (!unmasked(i, j0 + r, sq, sk, causal, window)) continue;
      const float dsc = expf(s - lse_i) * (dp - delta_i);
#pragma unroll
      for (int t = 0; t < kChunks; ++t) {
        const int c = lane + kLanes * t;
        if (c < nch) dqr[t] = axpy4(dsc, ks[r][c], dqr[t]);
      }
    }
  }
  if (i < sq) store_row(dq, off, dqr, scale, lane, nch);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* lse, float* delta, int b, int sq, int sk,
                   int h, int hkv, int d, float scale, int causal, int window,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const dim3 rows_grid((sq + kRows - 1) / kRows, b * h);
  stats_kernel<T><<<rows_grid, kThreads, 0, stream>>>(
      qt, kt, static_cast<const T*>(o), gt, lse, delta, sq, sk, h, hkv, d,
      scale, causal, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 keys_grid((sk + kRows - 1) / kRows, b * hkv);
  dkdv_kernel<T><<<keys_grid, kThreads, 0, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, h, hkv, d, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T><<<rows_grid, kThreads, 0, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), sq, sk, h, hkv, d,
      scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq [b, sq, h, d]; k, v, dk, dv [b, sk, hkv, d]: contiguous, on
// the device, all float32 (is_bf16 = 0) or all bf16 (is_bf16 = 1), 16-byte
// aligned; lse, delta float32 scratch of b·h·sq each.  h % hkv == 0,
// d % 4 == 0, 0 < d <= 128, b·h <= 65535, sq, sk > 0.  Launches the three
// kernels on `stream` in order; returns the first launch error, else
// cudaSuccess.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int b, int sq, int sk, int h, int hkv, int d, float scale, int causal,
    int window, int is_bf16, void* stream) {
  if (d <= 0 || d > kMaxD || d % 4 != 0 || hkv <= 0 || h % hkv != 0 ||
      b <= 0 || sq <= 0 || sk <= 0 || static_cast<int64_t>(b) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, dl, b,
                                       sq, sk, h, hkv, d, scale, causal,
                                       window, s)
              : launch<float>(q, k, v, o, dout, dq, dk, dv, l, dl, b, sq, sk,
                              h, hkv, d, scale, causal, window, s);
  return static_cast<int>(err);
}
