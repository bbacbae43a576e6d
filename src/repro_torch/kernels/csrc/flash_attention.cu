// Causal / sliding-window GQA flash attention (prefill).
//
// Replaces: the Pallas kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_flash_kernel`):
// q [B, Sq, H, d], k/v [B, Sk, Hkv, d] -> o [B, Sq, H, d], float32 or bf16.
// Query head h reads KV head h / (H / Hkv).  Online softmax with a float32
// running max, sum and accumulator per query row.  A key is masked when
// k_pos >= Sk, when it lies above the diagonal (causal) and when it lies
// `window` or more positions behind the query (sliding window); a masked
// score is -1e30, as in the TPU kernel, so the arithmetic is the same.
//
// Bound on an H100: at the serving engine's prefill shapes (Sq = Sk = 16 ..
// 1024, 32 query heads over 8 KV heads, d = 128, bf16) the work is
// 2·Sq·Sk·H·d FLOPs under the causal mask against (2·Sq·H + 2·Sk·Hkv)·d·2
// bytes, about 205 FLOPs per byte at 512 tokens: near the card's balance
// point, so operations and bytes bound it about equally on the tensor cores.
// This kernel does not reach that bound: it runs on the float32 CUDA cores
// (67 TFLOP/s, not the tensor cores' 989), which is the simple, exact
// first version; a wgmma/TMA version is later work.
//
// Design: one block per (batch·head, 32-row query tile), 128 threads.  Four
// neighbouring lanes share one query row, each holding a quarter of the head
// dimension (float4 chunks c = part + 4·i) of q and of the float32
// accumulator in registers; the row's dot products are finished with two
// xor shuffles inside the 4-lane group.  K and V tiles of 32 keys are staged
// in shared memory as float (coalesced loads along d).  Each tile updates the
// row max once, so the accumulator is rescaled once per tile, not per key.
// Tiles wholly above the causal diagonal, or wholly behind the window, of
// every row of the query tile are skipped: each of their scores would be
// -1e30 and would change nothing.  The TPU kernel's sequential k-block grid
// dimension becomes the loop inside the block; nothing is carried between
// blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;                      // largest head dim taken
constexpr int kRowThreads = 4;                  // lanes sharing a query row
constexpr int kBQ = 32;                         // query rows per block
constexpr int kBK = 32;                         // keys per shared tile
constexpr int kThreads = kBQ * kRowThreads;     // 128
constexpr int kChunks = kMaxD / 4 / kRowThreads;  // float4 chunks per lane
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

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return make_float4(to_f(p[0]), to_f(p[1]), to_f(p[2]), to_f(p[3]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int h, int hkv, int d, float scale, int causal, int window) {
  __shared__ float4 ks[kBK][kMaxD / 4];
  __shared__ float4 vs[kBK][kMaxD / 4];

  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int part = tid % kRowThreads;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh % h;
  const int kvh = head / (h / hkv);
  const int q0 = blockIdx.x * kBQ;
  const int qpos = q0 + row;
  const int nch = d / 4;

  // q [B, Sq, H, d]: this row's vector starts at ((b·Sq + qpos)·H + head)·d
  const int64_t qoff = ((static_cast<int64_t>(b) * sq + qpos) * h + head) * d;
  float4 qr[kChunks];
  float4 acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = part + kRowThreads * i;
    qr[i] = (c < nch && qpos < sq) ? load4(q + qoff + 4 * c)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf;
  float l = 0.f;

  // keys every row of this tile masks: above the last row's diagonal, and
  // window or more behind the first row
  int k_end = sk;
  if (causal) k_end = min(sk, q0 + kBQ);
  int k_begin = 0;
  if (window) k_begin = max(0, q0 - window + 1) / kBK * kBK;

  // k/v [B, Sk, Hkv, d]: key kp of this KV head at ((b·Sk + kp)·Hkv + kvh)·d
  const int64_t kv_stride = static_cast<int64_t>(hkv) * d;
  const int64_t kv_base = (static_cast<int64_t>(b) * sk * hkv + kvh) * d;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBK * nch; idx += kThreads) {
      const int j = idx / nch;
      const int c = idx % nch;
      const int kp = k0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (kp < sk) {
        const int64_t off = kv_base + kp * kv_stride + 4 * c;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      ks[j][c] = kk;
      vs[j][c] = vv;
    }
    __syncthreads();

    float s[kBK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = part + kRowThreads * i;
        if (c < nch) {
          const float4 kk = ks[j][c];
          dot = fmaf(qr[i].x, kk.x, dot);
          dot = fmaf(qr[i].y, kk.y, dot);
          dot = fmaf(qr[i].z, kk.z, dot);
          dot = fmaf(qr[i].w, kk.w, dot);
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kp = k0 + j;
      bool ok = kp < sk;
      if (causal) ok = ok && kp <= qpos;
      if (window) ok = ok && (qpos - kp) < window;
      s[j] = ok ? dot * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = part + kRowThreads * i;
        if (c < nch) {
          const float4 vv = vs[j][c];
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
    }
    m = m_new;
  }

  if (qpos < sq) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = part + kRowThreads * i;
      if (c < nch) {
        T* out = o + qoff + 4 * c;
        out[0] = from_f<T>(acc[i].x / denom);
        out[1] = from_f<T>(acc[i].y / denom);
        out[2] = from_f<T>(acc[i].z / denom);
        out[3] = from_f<T>(acc[i].w / denom);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int sk, int h, int hkv, int d, float scale,
                   int causal, int window, cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  flash_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, hkv, d, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

// q [b, sq, h, d], k/v [b, sk, hkv, d], o [b, sq, h, d]: contiguous, on the
// device, all float32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); h % hkv == 0,
// d % 4 == 0, d <= 128.  Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int sk, int h, int hkv, int d,
                                      float scale, int causal, int window,
                                      int is_bf16, void* stream) {
  if (d <= 0 || d > kMaxD || d % 4 != 0 || hkv <= 0 || h % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || sq == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, hkv, d, scale,
                                      causal, window, s)
              : launch<float>(q, k, v, o, b, sq, sk, h, hkv, d, scale, causal,
                              window, s);
  return static_cast<int>(err);
}
