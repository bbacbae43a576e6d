// Causal / sliding-window GQA flash attention (prefill).
//
// Replaces: the Pallas kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_flash_kernel`):
// q [B, Sq, H, d], k/v [B, Sk, Hkv, d] -> o [B, Sq, H, d], float32 or bf16.
// Query head h reads KV head h / (H / Hkv).  Online softmax with a float32
// running max, sum and accumulator per query row.  A key is masked when
// k_pos >= Sk, when it lies above the diagonal (causal) and when it lies
// `window` or more positions behind the query (sliding window); a masked
// score is -1e30, as in the TPU kernel, so the arithmetic is the same; the
// denominator is max(l, 1e-30).
//
// The row log-sum-exp, on request (the training path's forward, which the
// backward kernel reads; the serving path asks for none and its output is
// the same bits either way): lse [B, H, Sq] float32 in natural-log units,
// lse_i = ln Σ_j exp(scale·q_i·k_j) over the row's unmasked keys, written
// as m + ln max(l, 1e-30) from the row's final max m and sum l (the bf16
// kernel's m and l are in log2 units: (m + log2 max(l, 1e-30))·ln 2).  A
// row with no unmasked key stores about -1e30, the masked score (the
// wrapper's gates leave no such row: key 0 is in every row's reach).
//
// Bound on an H100: at the serving engine's prefill shapes (Sq = Sk = 16 ..
// 1024, 32 query heads over 8 KV heads of 128, or zamba2's 32 / 32 of 112,
// bf16) the work is 2·Sq·Sk·H·d FLOPs under the causal mask against
// (2·Sq·H + 2·Sk·Hkv)·d·2 bytes, about 205 FLOPs per byte at 512 tokens:
// near the card's balance point, so on the tensor cores bytes and
// operations bound it about equally (3.1 µs and 2.2 µs at 512 tokens),
// and at these small grids (256 blocks at 512 tokens) the latency of one
// block's key loop is what a call costs: on an H100 80GB HBM3 at 700 W it
// took 0.021 ms of device time per 512-token qwen3-8b call, 7x its bound
// and under PyTorch's SDPA (PERF.md).
//
// Two kernels, chosen by the input type:
//
// bf16 -> `flash_tc_kernel`, on the tensor cores.  Route: `mma.sync`
// m16n8k16 (bf16 in, float32 accumulate) fed by `ldmatrix` from a
// `cp.async` ring, FlashAttention-2's layout.  It was taken over `wgmma` +
// TMA because it is raw PTX that builds in seconds and is right at every
// head dim the wrapper takes (multiples of 4 up to 128, padded to 16 in
// shared memory) without a TMA descriptor per call; at these shapes a
// block runs 1–16 key tiles, so what `wgmma` would add (the full
// tensor-core rate, a producer warp keeping TMA loads in flight, registers
// freed from address math) pays off at long prompts more than here.
// One block per (batch·head, 64-row query tile), 4 warps of 16 query rows;
// the grid walks query tiles from the last (the heaviest under the causal
// mask) to the first, so the long blocks start in the first wave.  Q's
// fragments are loaded once with `ldmatrix` and stay in registers.  K and
// V tiles of 64 keys sit in a two-stage shared-memory ring filled by
// `cp.async` (16 bytes a thread; 8 where d is not a multiple of 8; rows
// past Sk and columns past d are zero-filled without a read), so the next
// tile is in flight while this one is computed.  Rows are padded by 16
// bytes, which makes every `ldmatrix` free of bank conflicts.  S = Q·Kᵀ is
// `mma.sync` on `ldmatrix` fragments of K; the softmax runs in float32
// registers in the log2 domain (scores times scale·log2 e, `exp2f`), with
// the row max and sum over the 4-lane quad and the accumulator rescaled
// once per tile; masks are computed only on the tiles that need them (the
// diagonal, the window edge, the ragged Sk edge).  P is rounded to bf16 in
// registers and used directly as the A fragment of P·V (the sum l keeps the
// float32 P); V comes in with `ldmatrix.trans`.  The output is normalised
// in float32, staged through the warp's own Q rows and stored as bf16 with
// 16-byte stores.  Tiles wholly above the diagonal, or wholly behind the
// window, of every row of the query tile are skipped.
//
// float32 -> `flash_kernel`, the CUDA-core kernel of the first port (the
// reference's 2e-5 float32 tolerance rules out TF32 and bf16 operands; it
// serves the float32 lockstep and the tests): one block per (batch·head,
// 32-row query tile), 128 threads, four lanes per query row each holding a
// quarter of the head dimension of q and of the accumulator, K and V tiles
// of 32 keys staged as float, the accumulator rescaled once per tile.
//
// The TPU kernel's sequential k-block grid dimension becomes the loop
// inside the block; nothing is carried between blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

constexpr int kMaxD = 128;                      // largest head dim taken
constexpr int kRowThreads = 4;                  // lanes sharing a query row
constexpr int kBQ = 32;                         // query rows per block
constexpr int kBK = 32;                         // keys per shared tile
constexpr int kThreads = kBQ * kRowThreads;     // 128
constexpr int kChunks = kMaxD / 4 / kRowThreads;  // float4 chunks per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return make_float4(to_f(p[0]), to_f(p[1]), to_f(p[2]), to_f(p[3]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int h, int hkv,
                 int d, float scale, int causal, int window) {
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
    if (lse && part == 0)
      lse[static_cast<int64_t>(bh) * sq + qpos] = m + logf(denom);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int sk, int h, int hkv, int d,
                   float scale, int causal, int window, cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  flash_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, h, hkv, d,
      scale, causal, window);
  return cudaGetLastError();
}


// ---------------------------------------------------------------- bf16 --
namespace tc {

using namespace flash_tc;
constexpr int kBQ = 64;       // query rows per block, 16 per warp
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;
constexpr int kStages = 2;    // K/V tiles in flight

// shared memory of the instance for head dims padded to DP: the Q tile,
// then kStages K tiles, then kStages V tiles, rows of DP + 8 bf16
template <int DP>
struct Layout {
  static constexpr int kStride = stride<DP>();
  static constexpr int kTile = kBK * kStride;
  static constexpr int kBytes = (kBQ * kStride + 2 * kStages * kTile) * 2;
};

// grid (B·H, ceil(Sq / 64)); 128 threads; Layout<DP>::kBytes of dynamic
// shared memory.  scale_log2 = log2(e) / sqrt(d).  lse: null, or [B, H, Sq]
// for the rows' log-sum-exp.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int sq, int sk, int h, int hkv,
                    int d, float scale_log2, int causal, int window,
                    int vec16) {
  using L = Layout<DP>;
  constexpr int S = L::kStride;
  constexpr int KD = DP / 16;  // k-steps of Q·Kᵀ
  constexpr int ND = DP / 8;   // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * S;
  bf16* vs = ks + kStages * L::kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh % h;
  const int kvh = head / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int64_t q_pitch = static_cast<int64_t>(h) * d;
  const int64_t kv_pitch = static_cast<int64_t>(hkv) * d;
  // q [B, Sq, H, d]: row s of this head at ((b·Sq + s)·H + head)·d;
  // k/v [B, Sk, Hkv, d]: key t of this KV head at ((b·Sk + t)·Hkv + kvh)·d
  const bf16* qg = q + (static_cast<int64_t>(b) * sq * h + head) * d;
  const bf16* kg = k + (static_cast<int64_t>(b) * sk * hkv + kvh) * d;
  const bf16* vg = v + (static_cast<int64_t>(b) * sk * hkv + kvh) * d;
  const bool vec = vec16 != 0;

  // keys every row of this tile masks: above the last row's diagonal, and
  // window or more behind the first row
  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  const int k_begin = window ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  load_tile<DP, kThreads>(qs, qg, q_pitch, q0, kBQ, sq, d, vec);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<DP, kThreads>(ks, kg, kv_pitch, k_begin, kBK, sk, d, vec);
    load_tile<DP, kThreads>(vs, vg, kv_pitch, k_begin, kBK, sk, d, vec);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // this warp's 16 rows of Q as A fragments, for the whole key loop
  uint32_t qf[KD][4];
  {
    const bf16* base = qs + (warp * 16 + (lane & 15)) * S + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldsm_x4(smem_addr(base + kk * 16), qf[kk]);
  }

  float oacc[ND][4];
#pragma unroll
  for (int t = 0; t < ND; ++t) oacc[t][0] = oacc[t][1] = oacc[t][2] =
      oacc[t][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // rows row_a and row_a + 8
  float l_r[2] = {0.f, 0.f};          // this lane's part of the row sums
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const int tq = lane & 3;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBK;
    const int st = it % kStages;
    if (it + 1 < n_tiles) {
      const int nx = (it + 1) % kStages;
      load_tile<DP, kThreads>(ks + nx * L::kTile, kg, kv_pitch, k0 + kBK,
                              kBK, sk, d, vec);
      load_tile<DP, kThreads>(vs + nx * L::kTile, vg, kv_pitch, k0 + kBK,
                              kBK, sk, d, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile `it` has landed
    __syncthreads();
    const bf16* kt = ks + st * L::kTile;
    const bf16* vt = vs + st * L::kTile;

    // S = Q·Kᵀ: 16 rows x 64 keys per warp, 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // two key tiles per ldmatrix.x4
        uint32_t bfr[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(smem_addr(kt + key * S + col), bfr);
        mma(s[2 * np], qf[kk], bfr[0], bfr[1]);
        mma(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // scale into the log2 domain; masks only where a key of this tile can
    // be masked for a row of this query tile
    const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > q0) ||
                      (window && q0 + kBQ - 1 - k0 >= window);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale_log2;
        if (edge) {
          const int row = row_a + (e >> 1) * 8;
          const int key = k0 + t * 8 + tq * 2 + (e & 1);
          bool ok = key < sk;
          if (causal) ok = ok && key <= row;
          if (window) ok = ok && row - key < window;
          x = ok ? x : kNegInf;
        }
        s[t][e] = x;
      }
    }

    // online softmax: the tile's row max over the quad, one rescale
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      mx[0] = fmaxf(mx[0], fmaxf(s[t][0], s[t][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[t][2], s[t][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float corr0 = exp2f(m_r[0] - mx[0]);
    const float corr1 = exp2f(m_r[1] - mx[1]);
    m_r[0] = mx[0];
    m_r[1] = mx[1];
    l_r[0] *= corr0;
    l_r[1] *= corr1;
#pragma unroll
    for (int t = 0; t < ND; ++t) {
      oacc[t][0] *= corr0;
      oacc[t][1] *= corr0;
      oacc[t][2] *= corr1;
      oacc[t][3] *= corr1;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[t][e] - mx[e >> 1]);
        l_r[e >> 1] += p;
        s[t][e] = p;
      }
    }

    // O += P·V: P as bf16 A fragments straight from the S registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys per step
      uint32_t a[4];
      a_from_c(s, kk, a);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {  // two column tiles per x4
        uint32_t bfr[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = dp * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(smem_addr(vt + key * S + col), bfr);
        mma(oacc[2 * dp], a, bfr[0], bfr[1]);
        mma(oacc[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }

  // normalise, stage the bf16 rows in this warp's own Q rows, store
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  const float inv0 = 1.f / fmaxf(l_r[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l_r[1], 1e-30f);
  if (lse && tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_a + 8 * i;
      if (row < sq)
        lse[static_cast<int64_t>(bh) * sq + row] =
            (m_r[i] + log2f(fmaxf(l_r[i], 1e-30f))) * 0.6931471805599453f;
    }
  }
  bf16* os = qs + warp * 16 * S;
  const int r = lane >> 2;
#pragma unroll
  for (int t = 0; t < ND; ++t) {
    const int c = t * 8 + tq * 2;
    *reinterpret_cast<__nv_bfloat162*>(os + r * S + c) =
        __floats2bfloat162_rn(oacc[t][0] * inv0, oacc[t][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(os + (r + 8) * S + c) =
        __floats2bfloat162_rn(oacc[t][2] * inv1, oacc[t][3] * inv1);
  }
  __syncwarp();
  const int vec_n = vec ? 8 : 4;
  const int chunks = DP / vec_n;
  bf16* og = o + (static_cast<int64_t>(b) * sq * h + head) * d;
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int rr = idx / chunks;
    const int col = (idx % chunks) * vec_n;
    const int row = q0 + warp * 16 + rr;
    if (row < sq && col < d) {
      bf16* dst = og + row * q_pitch + col;
      const bf16* src = os + rr * S + col;
      if (vec)
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      else
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    }
  }
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   float* lse, int b, int sq, int sk, int h, int hkv, int d,
                   float scale, int causal, int window, int vec16,
                   cudaStream_t stream) {
  static bool raised[64] = {};
  const cudaError_t err =
      raise_smem(flash_tc_kernel<DP>, Layout<DP>::kBytes, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + kBQ - 1) / kBQ);
  flash_tc_kernel<DP><<<grid, kThreads, Layout<DP>::kBytes, stream>>>(
      q, k, v, o, lse, sq, sk, h, hkv, d, scale * 1.4426950408889634f,
      causal, window, vec16);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int b, int sq, int sk, int h, int hkv, int d,
                     float scale, int causal, int window,
                     cudaStream_t stream) {
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (!(aligned(q, 8) && aligned(k, 8) && aligned(v, 8) && aligned(o, 8)))
    return cudaErrorInvalidValue;
  const int vec16 = d % 8 == 0 && aligned(q, 16) && aligned(k, 16) &&
                    aligned(v, 16) && aligned(o, 16);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
#define FLASH_TC_CASE(DP)                                                  \
  case DP:                                                                \
    return launch<DP>(qb, kb, vb, ob, lse, b, sq, sk, h, hkv, d, scale,    \
                      causal, window, vec16, stream);
  switch ((d + 15) / 16 * 16) {
    FLASH_TC_CASE(16)
    FLASH_TC_CASE(32)
    FLASH_TC_CASE(48)
    FLASH_TC_CASE(64)
    FLASH_TC_CASE(80)
    FLASH_TC_CASE(96)
    FLASH_TC_CASE(112)
    FLASH_TC_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_TC_CASE
}

}  // namespace tc

}  // namespace

// q [b, sq, h, d], k/v [b, sk, hkv, d], o [b, sq, h, d]: contiguous, on the
// device, all float32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); h % hkv == 0,
// d % 4 == 0, d <= 128; bf16 pointers 8-byte aligned (16 for 16-byte
// copies).  lse: null, or float32 [b, h, sq] for the rows' natural-log
// log-sum-exp.  bf16 runs on the tensor cores, float32 on the CUDA cores.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int b, int sq, int sk, int h, int hkv,
                                      int d, float scale, int causal,
                                      int window, int is_bf16, void* stream) {
  if (d <= 0 || d > kMaxD || d % 4 != 0 || hkv <= 0 || h % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || sq == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      is_bf16 ? tc::dispatch(q, k, v, o, l, b, sq, sk, h, hkv, d, scale,
                             causal, window, s)
              : launch<float>(q, k, v, o, l, b, sq, sk, h, hkv, d, scale,
                              causal, window, s);
  return static_cast<int>(err);
}
