// One-token GQA attention against a contiguous KV cache (decode).
//
// Replaces: the Pallas kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (body `_decode_kernel`, and the
// log-sum-exp combine it runs in jnp afterwards): q [B, H, d], k/v caches
// [B, M, Hkv, d], valid [B, M] bool -> o [B, H, d], float32 or bf16.  Query
// head h reads KV head h / (H / Hkv); a slot with valid = false scores
// -1e30, as in the TPU kernel.
//
// Bound on an H100: bytes.  A step reads the whole cache of its KV heads
// (2·M·Hkv·d elements) once and does 4·H·M·d FLOPs on it, one FMA per
// element and query head of the group, H / Hkv = 4 FLOPs per byte in bf16
// for qwen3-8b: far below the card's ~295, so the cache read
// is the bound (4 MiB, ~1.3 µs at M = 1024, Hkv = 8, d = 128 in bf16).  At
// that size the launches themselves cost more than the bytes.
//
// Design: pass 1 splits the cache into 64-slot pieces, one block per
// (batch·KV head, piece), so 16 pieces x 8 KV heads fill 128 of the 132
// SMs at M = 1024 where one block per KV head would leave most idle.  The
// block holds the G = H / Hkv query heads of its KV head in shared memory;
// one warp per slot reads the slot's key once (coalesced along d) and
// finishes G dot products with warp shuffles; one warp per query head
// takes the piece's max and sum of exponentials; then one thread per
// dimension of d reads the value rows once and accumulates all G heads.
// It writes float32 partials (max, sum, weighted V) per piece.  Pass 2, a
// second small kernel, combines the pieces by log-sum-exp, one block per
// (batch, query head), and casts to the output type.  The TPU kernel's
// grid order carried nothing between pieces either; its jnp combine
// becomes the second kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;     // largest head dim taken
constexpr int kMaxG = 16;      // largest query-head group taken
constexpr int kPiece = 64;     // cache slots per pass-1 block
constexpr int kThreads = 128;  // 4 warps; one thread per dim in the PV loop
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// grid (pieces, B·Hkv).  Partials: m_part/l_part [B·Hkv, pieces, G],
// acc_part [B·Hkv, pieces, G, d], float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                          const T* __restrict__ vc,
                          const uint8_t* __restrict__ valid,
                          float* __restrict__ m_part,
                          float* __restrict__ l_part,
                          float* __restrict__ acc_part, int h, int hkv,
                          int m, int d, float scale) {
  __shared__ float qs[kMaxG][kMaxD];
  __shared__ float ps[kMaxG][kPiece];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int piece = blockIdx.x;
  const int pieces = gridDim.x;
  const int bkv = blockIdx.y;
  const int b = bkv / hkv;
  const int kvh = bkv % hkv;
  const int g_n = h / hkv;
  const int slot0 = piece * kPiece;
  const int n_slots = min(kPiece, m - slot0);

  // q [B, H, d]: the group of KV head kvh is heads kvh·G .. kvh·G + G - 1
  const T* qg = q + (static_cast<int64_t>(b) * h + kvh * g_n) * d;
  for (int idx = tid; idx < g_n * d; idx += kThreads)
    qs[idx / d][idx % d] = to_f(qg[idx]);
  __syncthreads();

  // caches [B, M, Hkv, d]: slot t of this KV head at ((b·M + t)·Hkv + kvh)·d
  const int64_t stride = static_cast<int64_t>(hkv) * d;
  const int64_t base = (static_cast<int64_t>(b) * m * hkv + kvh) * d;

  // scores: one warp per slot, lanes over d
  for (int j = warp; j < n_slots; j += kWarps) {
    const int t = slot0 + j;
    const T* krow = kc + base + t * stride;
    float kr[kMaxD / 32];
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int dim = lane + 32 * i;
      kr[i] = dim < d ? to_f(krow[dim]) : 0.f;
    }
    const bool ok = valid[static_cast<int64_t>(b) * m + t] != 0;
    for (int g = 0; g < g_n; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int dim = lane + 32 * i;
        if (dim < d) dot = fmaf(qs[g][dim], kr[i], dot);
      }
      dot = warp_sum(dot);
      if (lane == 0) ps[g][j] = ok ? dot * scale : kNegInf;
    }
  }
  __syncthreads();

  // per query head: the piece's max and sum of exponentials
  const int64_t part = static_cast<int64_t>(bkv) * pieces + piece;
  for (int g = warp; g < g_n; g += kWarps) {
    float mx = kNegInf;
    for (int j = lane; j < n_slots; j += 32) mx = fmaxf(mx, ps[g][j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n_slots; j += 32) {
      const float p = expf(ps[g][j] - mx);
      ps[g][j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_part[part * g_n + g] = mx;
      l_part[part * g_n + g] = sum;
    }
  }
  __syncthreads();

  // weighted values: one thread per dim, all G heads at once
  for (int dim = tid; dim < d; dim += kThreads) {
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    for (int j = 0; j < n_slots; ++j) {
      const float val = to_f(vc[base + (slot0 + j) * stride + dim]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < g_n) acc[g] = fmaf(ps[g][j], val, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < g_n) acc_part[(part * g_n + g) * d + dim] = acc[g];
  }
}

// grid (B·H): combine the pieces of one query head by log-sum-exp.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ m_part,
                          const float* __restrict__ l_part,
                          const float* __restrict__ acc_part,
                          T* __restrict__ o, int h, int hkv, int d,
                          int pieces) {
  const int bhead = blockIdx.x;
  const int b = bhead / h;
  const int head = bhead % h;
  const int g_n = h / hkv;
  const int g = head % g_n;
  const int64_t bkv = static_cast<int64_t>(b) * hkv + head / g_n;

  float m_star = kNegInf;
  for (int p = 0; p < pieces; ++p)
    m_star = fmaxf(m_star, m_part[(bkv * pieces + p) * g_n + g]);
  float l = 0.f;
  for (int p = 0; p < pieces; ++p) {
    const int64_t i = (bkv * pieces + p) * g_n + g;
    l += l_part[i] * expf(m_part[i] - m_star);
  }
  const float denom = fmaxf(l, 1e-30f);
  for (int dim = threadIdx.x; dim < d; dim += kThreads) {
    float acc = 0.f;
    for (int p = 0; p < pieces; ++p) {
      const int64_t i = (bkv * pieces + p) * g_n + g;
      acc += acc_part[i * d + dim] * expf(m_part[i] - m_star);
    }
    o[static_cast<int64_t>(bhead) * d + dim] = from_f<T>(acc / denom);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* valid, float* m_part, float* l_part,
                   float* acc_part, void* o, int b, int h, int hkv, int m,
                   int d, float scale, cudaStream_t stream) {
  const int pieces = (m + kPiece - 1) / kPiece;
  decode_partial_kernel<T><<<dim3(pieces, b * hkv), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const uint8_t*>(valid), m_part,
      l_part, acc_part, h, hkv, m, d, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<b * h, kThreads, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<T*>(o), h, hkv, d, pieces);
  return cudaGetLastError();
}

}  // namespace

// Cache slots per pass-1 piece: the wrapper sizes the partials
// [b·hkv, ceil(m / piece), h / hkv] (and ·d for acc) with it.
extern "C" int decode_attention_piece(void) { return kPiece; }

// q [b, h, d], k/v caches [b, m, hkv, d], valid [b, m] bool (one byte),
// o [b, h, d]: contiguous, on the device, all float32 (is_bf16 = 0) or all
// bf16 (is_bf16 = 1); float32 partials as above.  h % hkv == 0,
// h / hkv <= 16, d <= 128, m >= 1.  Launches both passes on `stream`;
// returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* valid,
                                       void* m_part, void* l_part,
                                       void* acc_part, void* o, int b, int h,
                                       int hkv, int m, int d, float scale,
                                       int is_bf16, void* stream) {
  if (d <= 0 || d > kMaxD || hkv <= 0 || h % hkv != 0 || h / hkv > kMaxG ||
      m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, kc, vc, valid, mp, lp, ap, o, b, h,
                                      hkv, m, d, scale, s)
              : launch<float>(q, kc, vc, valid, mp, lp, ap, o, b, h, hkv, m,
                              d, scale, s);
  return static_cast<int>(err);
}
