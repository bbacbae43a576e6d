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
// Function: q [B, Sq, H, d], k/v [B, Sk, Hkv, d], o and dO [B, Sq, H, d],
// and the forward kernel's row log-sum-exp lse [B, H, Sq] (float32, natural
// log) -> dQ [B, Sq, H, d], dK/dV [B, Sk, Hkv, d], float32 or bf16 in and
// out.  Query head h reads KV head h / (H / Hkv).  With S = scale·Q·Kᵀ
// under the causal and window masks (a masked pair's P is exactly 0) and
// P = exp(S − lse):
//   D_i  = Σ_c dO_ic·O_ic                 (rowsum(dO ∘ O))
//   dP   = dO·Vᵀ,  dS = P ∘ (dP − D)
//   dV   = Pᵀ·dO,  dQ = scale·dS·K,  dK = scale·dSᵀ·Q
// dK and dV of a KV head sum over the H / Hkv query heads of its group.
//
// Bound on an H100: 10·H·d operations per unmasked (query, key) pair (five
// products of the pair with a d-vector: Q·Kᵀ again, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q,
// dS·K) against q, o, dO, dQ and k, v, dK, dV moved once; at qwen3-8b's
// 4,096-token causal call (32 / 8 heads of 128, bf16) that is 3.4e11
// operations, 0.35 ms at the tensor cores' 989 TFLOP/s: operations bound
// it by far.  The two kernels below recompute S and dP each, so they run
// seven products where the bound counts five.
//
// Three launches for either input type, each output written by one block
// in a fixed order, with no atomics, so two runs give the same bits:
//   (a) delta_kernel: D of every query row and head (one read of o, dO).
//   (b) the dK / dV kernel: a block per (64 keys, batch·KV head); it walks
//       the group's query heads in order and, for each, the query tiles its
//       masks reach, and no other block writes its keys.
//   (c) the dQ kernel: a block per (64 query rows, batch·head), walking the
//       key tiles its masks reach.
//
// bf16 -> `dkdv_tc_kernel` and `dq_tc_kernel`, on the tensor cores, with
// the forward's building blocks (csrc/flash_tc.cuh): all five pair
// products are `mma.sync` m16n8k16 (bf16 in, float32 accumulate) on
// `ldmatrix` fragments of shared tiles whose rows are padded by 16 bytes,
// filled by a two-stage `cp.async` ring with zero-fill at ragged edges.
// 4 warps, each owning 16 of the block's 64 rows.
//   dkdv_tc_kernel: the block's K and V tiles stay in shared memory, and a
//   warp reloads its 16 keys' A fragments for every step: Sᵀ = K·Qᵀ and
//   dPᵀ = V·dOᵀ come out in the C layout with the keys as rows, so Pᵀ and
//   dSᵀ are A fragments of dV += Pᵀ·dO and dK += dSᵀ·Q as they stand
//   (Q and dO come in with `ldmatrix.trans` for those).  The ring streams
//   64 rows of Q and dO, and of lse and D, a tile; a warp takes them 32
//   queries a step.
//   dq_tc_kernel: the block's Q and dO rows are A fragments in registers
//   for the whole walk (S = Q·Kᵀ, dP = dO·Vᵀ); the ring streams 64 keys of
//   K and V a tile, taken 32 a step; dQ += dS·K with K through
//   `ldmatrix.trans`.
// P = exp2(S·scale·log2 e − lse·log2 e) and dS = P ∘ (dP − D) in float32
// registers; each is rounded to bf16 only as the A operand of its products,
// as the forward rounds P for P·V (tests/torch_port/
// test_torch_flash_bwd_design.py replays this on the CPU: one bf16 part
// keeps every row inside the card's 2e-2 gate, so neither goes as two
// parts).  Tiles wholly above the diagonal or behind the window are not
// visited; masks are computed only on the tiles that a ragged edge, the
// diagonal or the window's edge cuts.  Registers: a dK/dV warp holds its
// 16 keys' dK and dV sums (2·DP/8·4 floats, 128 at DP = 128) and one
// step's Sᵀ and dPᵀ (2·16); a dQ warp its dQ sum (64), Q and dO fragments
// (2·32) and one step's S and dP (2·16); that is why K and V (dK/dV) are
// not held in registers and why a step is 32 rows and not the tile's 64.
// Both kernels declare two blocks an SM (`__launch_bounds__(128, 2)`,
// which the shared memory allows at DP = 128: 105,472 / 104,448 B):
// without it ptxas aimed at more, capped the instances below DP = 112 at
// 96–168 registers, and eight of them spilled 4–48 B (DP = 64 among
// them); with it no instance spills (dQ / dK-dV: 248 / 252
// registers at DP = 128, 200 / 202 at DP = 64; ptxas -v on an H100,
// chip_smoke.py phase 2).  `wgmma` and TMA are later work.
//
// float32 -> `dkdv_kernel` and `dq_kernel`, the CUDA-core kernels of the
// first port (the 1e-4 float32 gate rules out bf16 operands): 32 rows a
// block, eight lanes a row, each holding every eighth float4 chunk of the
// head dim, a dot product reduced over the eight lanes with a butterfly of
// shuffles (the same bits in every lane); K/V or Q/dO staged 32 rows at a
// time in shared memory.
//
// The TPU-era design of the forward (the sequential key-block grid) does
// not apply: each block's loop takes the place of a sequential dimension,
// and nothing is carried between blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tc.cuh"

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

// (a): delta[b, h, i] = Σ_c dO_ic·O_ic, a block per (32 query rows,
// batch·head)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int sq, int h, int d) {
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int bh = blockIdx.y;
  const int i = blockIdx.x * kRows + row;
  const int nch = d / 4;
  const int64_t off =
      ((static_cast<int64_t>(bh / h) * sq + i) * h + bh % h) * d;
  float4 a[kChunks], g[kChunks];
  load_row(a, o, off, i < sq, lane, nch);
  load_row(g, dout, off, i < sq, lane, nch);
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < kChunks; ++t) s = dot4(g[t], a[t], s);
  s = row_sum(s);
  if (i < sq && lane == 0) delta[static_cast<int64_t>(bh) * sq + i] = s;
}

// (b) on the CUDA cores: dK, dV of 32 keys of one KV head, summed over its
// query heads
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

// (c) on the CUDA cores: dQ of 32 query rows of one head
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

// ---------------------------------------------------------------- bf16 --
namespace tcb {

using namespace flash_tc;
constexpr int kBlk = 64;       // rows a block owns, and rows of a streamed tile
constexpr int kStep = 32;      // streamed rows a warp takes a step
constexpr int kThreads = 128;  // 4 warps of 16 owned rows
constexpr int kStages = 2;     // streamed tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
static_assert(2 * kBlk == kThreads, "one lse or D value per thread a tile");

// dynamic shared memory of either kernel at head dims padded to DP: two
// owned tiles and kStages pairs of streamed tiles of 64 rows; the dK/dV
// kernel also streams kStages x 64 lse and 64 D values
template <int DP>
struct Layout {
  static constexpr int kTile = kBlk * stride<DP>();
  static constexpr int kDqBytes = (2 + 2 * kStages) * kTile * 2;
  static constexpr int kDkdvBytes = kDqBytes + 2 * kStages * kBlk * 4;
};

// whether the (64-query tile at q0, 64-key tile at k0) pair holds a masked
// pair: a ragged edge, the diagonal or the window's edge cuts it
__device__ __forceinline__ bool cut(int q0, int k0, int sq, int sk,
                                    int causal, int window) {
  return q0 + kBlk > sq || k0 + kBlk > sk || (causal && k0 + kBlk - 1 > q0) ||
         (window && q0 + kBlk - 1 - k0 >= window);
}

// (b) on the tensor cores: grid (B·Hkv, ceil(Sk / 64)), the first keys
// (under a causal mask, the most queries) first; 128 threads;
// Layout<DP>::kDkdvBytes of dynamic shared memory
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int sq, int sk, int h, int hkv,
                   int d, float scale, float scale_log2, int causal,
                   int window, int vec16) {
  constexpr int S = stride<DP>();
  constexpr int T = Layout<DP>::kTile;
  constexpr int KD = DP / 16;    // k-steps over the head dim
  constexpr int ND = DP / 8;     // 8-wide column tiles of dK and dV
  constexpr int NQ = kStep / 8;  // 8-query column tiles of a step
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + T;
  bf16* qs = vs + T;                // kStages Q tiles
  bf16* gs = qs + kStages * T;      // kStages dO tiles
  float* ls = reinterpret_cast<float*>(gs + kStages * T);  // kStages x 64
  float* ds = ls + kStages * kBlk;                          // kStages x 64

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x / hkv;
  const int kvh = blockIdx.x % hkv;
  const int group = h / hkv;
  const int k0 = blockIdx.y * kBlk;
  const int64_t q_pitch = static_cast<int64_t>(h) * d;
  const int64_t kv_pitch = static_cast<int64_t>(hkv) * d;
  // k/v [B, Sk, Hkv, d]: key t of this KV head at ((b·Sk + t)·Hkv + kvh)·d
  const int64_t kv_off = (static_cast<int64_t>(b) * sk * hkv + kvh) * d;
  const bool vec = vec16 != 0;

  // query tiles some key of this tile sees, for each head of the group:
  // from its first key's diagonal (causal) to the last query inside its
  // last key's window
  const int i_begin = causal ? k0 : 0;
  const int i_end = window ? min(sq, k0 + kBlk - 1 + window) : sq;
  const int n_qt = i_end > i_begin ? (i_end - i_begin + kBlk - 1) / kBlk : 0;
  const int n_it = n_qt * group;

  // tile `it` of the walk (head kvh·group + it / n_qt, query tile
  // it % n_qt) into stage it % kStages: Q, dO and the rows' lse and D
  const auto stage_in = [&](int it) {
    const int st = it % kStages;
    const int head = kvh * group + it / n_qt;
    const int q0 = i_begin + (it % n_qt) * kBlk;
    const int64_t off = (static_cast<int64_t>(b) * sq * h + head) * d;
    load_tile<DP, kThreads>(qs + st * T, q + off, q_pitch, q0, kBlk, sq, d,
                            vec);
    load_tile<DP, kThreads>(gs + st * T, dout + off, q_pitch, q0, kBlk, sq,
                            d, vec);
    const int r = threadIdx.x % kBlk;
    const bool ok = q0 + r < sq;
    const float* src = (threadIdx.x < kBlk ? lse : delta) +
                       (static_cast<int64_t>(b) * h + head) * sq +
                       (ok ? q0 + r : 0);
    cp_async<4>((threadIdx.x < kBlk ? ls : ds) + st * kBlk + r, src,
                ok ? 4 : 0);
  };

  load_tile<DP, kThreads>(ks, k + kv_off, kv_pitch, k0, kBlk, sk, d, vec);
  load_tile<DP, kThreads>(vs, v + kv_off, kv_pitch, k0, kBlk, sk, d, vec);
  if (n_it > 0) stage_in(0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int t = 0; t < ND; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;
  const int tq = lane & 3;
  const int key_a = k0 + warp * 16 + (lane >> 2);  // rows key_a, key_a + 8
  // this warp's 16 keys as A fragments: ldmatrix row addresses of K and V
  const int a_off = (warp * 16 + (lane & 15)) * S + (lane >> 4) * 8;
  const uint32_t k_addr = smem_addr(ks + a_off);
  const uint32_t v_addr = smem_addr(vs + a_off);

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    if (it + 1 < n_it) stage_in(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile `it` (and K, V) have landed
    __syncthreads();
    const int q0 = i_begin + (it % n_qt) * kBlk;
    const bf16* qt = qs + st * T;
    const bf16* gt = gs + st * T;
    const float* lt = ls + st * kBlk;
    const float* dt = ds + st * kBlk;
    const bool edge = cut(q0, k0, sq, sk, causal, window);

#pragma unroll 1
    for (int s0 = 0; s0 < kBlk; s0 += kStep) {
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys x kStep queries a warp
      float sa[NQ][4], pa[NQ][4];
#pragma unroll
      for (int t = 0; t < NQ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[t][e] = pa[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kf[4], vf[4];
        ldsm_x4(k_addr + kk * 32, kf);
        ldsm_x4(v_addr + kk * 32, vf);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {  // two query tiles per x4
          const int row = s0 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int col = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t qb[4], gb[4];
          ldsm_x4(smem_addr(qt + row * S + col), qb);
          ldsm_x4(smem_addr(gt + row * S + col), gb);
          mma(sa[2 * np], kf, qb[0], qb[1]);
          mma(sa[2 * np + 1], kf, qb[2], qb[3]);
          mma(pa[2 * np], vf, gb[0], gb[1]);
          mma(pa[2 * np + 1], vf, gb[2], gb[3]);
        }
      }
      // Pᵀ and dSᵀ in float32; masked pairs 0, tested on cut tiles only
#pragma unroll
      for (int t = 0; t < NQ; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = s0 + t * 8 + tq * 2 + (e & 1);  // query of the tile
          float p = exp2f(sa[t][e] * scale_log2 - lt[c] * kLog2e);
          if (edge && !unmasked(q0 + c, key_a + (e >> 1) * 8, sq, sk, causal,
                                window))
            p = 0.f;
          sa[t][e] = p;
          pa[t][e] = p * (pa[t][e] - dt[c]);
        }
      }
      // dV += Pᵀ·dO and dK += dSᵀ·Q, 16 queries a k-step; Pᵀ and dSᵀ are
      // rounded to bf16 here, as A fragments
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        uint32_t pf[4], sf[4];
        a_from_c(sa, kk, pf);
        a_from_c(pa, kk, sf);
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {  // two column tiles per x4
          const int row = s0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = dp * 16 + (lane >> 4) * 8;
          uint32_t gb[4], qb[4];
          ldsm_x4_trans(smem_addr(gt + row * S + col), gb);
          ldsm_x4_trans(smem_addr(qt + row * S + col), qb);
          mma(dva[2 * dp], pf, gb[0], gb[1]);
          mma(dva[2 * dp + 1], pf, gb[2], gb[3]);
          mma(dka[2 * dp], sf, qb[0], qb[1]);
          mma(dka[2 * dp + 1], sf, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  cp_async_wait<0>();  // nothing in flight when the block ends

  // dK = scale·Σ dSᵀ·Q and dV, stored as bf16 pairs
#pragma unroll
  for (int t = 0; t < ND; ++t) {
    const int c = t * 8 + tq * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = key_a + 8 * i;
      if (j < sk && c < d) {
        const int64_t off = kv_off + j * kv_pitch + c;
        *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
            dka[t][2 * i] * scale, dka[t][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) =
            __floats2bfloat162_rn(dva[t][2 * i], dva[t][2 * i + 1]);
      }
    }
  }
}

// (c) on the tensor cores: grid (B·H, ceil(Sq / 64)), the last query tiles
// (under a causal mask, the most keys) first; 128 threads;
// Layout<DP>::kDqBytes of dynamic shared memory
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int sq, int sk, int h, int hkv, int d, float scale,
                 float scale_log2, int causal, int window, int vec16) {
  constexpr int S = stride<DP>();
  constexpr int T = Layout<DP>::kTile;
  constexpr int KD = DP / 16;    // k-steps over the head dim
  constexpr int ND = DP / 8;     // 8-wide column tiles of dQ
  constexpr int NK = kStep / 8;  // 8-key column tiles of a step
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + T;
  bf16* ks = gs + T;             // kStages K tiles
  bf16* vs = ks + kStages * T;   // kStages V tiles

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh % h;
  const int kvh = head / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlk;  // heaviest first
  const int64_t q_pitch = static_cast<int64_t>(h) * d;
  const int64_t kv_pitch = static_cast<int64_t>(hkv) * d;
  // q [B, Sq, H, d]: row s of this head at ((b·Sq + s)·H + head)·d
  const int64_t q_off = (static_cast<int64_t>(b) * sq * h + head) * d;
  const int64_t kv_off = (static_cast<int64_t>(b) * sk * hkv + kvh) * d;
  const bf16* kg = k + kv_off;
  const bf16* vg = v + kv_off;
  const bool vec = vec16 != 0;

  // keys every row of this tile masks: above the last row's diagonal, and
  // window or more behind the first row (the forward's walk)
  const int k_end = causal ? min(sk, q0 + kBlk) : sk;
  const int k_begin = window ? max(0, q0 - window + 1) / kBlk * kBlk : 0;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kBlk - 1) / kBlk : 0;

  load_tile<DP, kThreads>(qs, q + q_off, q_pitch, q0, kBlk, sq, d, vec);
  load_tile<DP, kThreads>(gs, dout + q_off, q_pitch, q0, kBlk, sq, d, vec);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<DP, kThreads>(ks, kg, kv_pitch, k_begin, kBlk, sk, d, vec);
    load_tile<DP, kThreads>(vs, vg, kv_pitch, k_begin, kBlk, sk, d, vec);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();

  // this warp's 16 rows of Q and dO as A fragments, for the whole walk
  uint32_t qf[KD][4], gf[KD][4];
  {
    const int a_off = (warp * 16 + (lane & 15)) * S + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ldsm_x4(smem_addr(qs + a_off + kk * 16), qf[kk]);
      ldsm_x4(smem_addr(gs + a_off + kk * 16), gf[kk]);
    }
  }
  const int tq = lane & 3;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // rows row_a, row_a + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    const int64_t at = static_cast<int64_t>(bh) * sq + row;
    lse2[i] = row < sq ? lse[at] * kLog2e : 0.f;
    dl[i] = row < sq ? delta[at] : 0.f;
  }
  float dqa[ND][4];
#pragma unroll
  for (int t = 0; t < ND; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[t][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBlk;
    const int st = it % kStages;
    if (it + 1 < n_tiles) {
      const int nx = (it + 1) % kStages;
      load_tile<DP, kThreads>(ks + nx * T, kg, kv_pitch, k0 + kBlk, kBlk, sk,
                              d, vec);
      load_tile<DP, kThreads>(vs + nx * T, vg, kv_pitch, k0 + kBlk, kBlk, sk,
                              d, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile `it` has landed
    __syncthreads();
    const bf16* kt = ks + st * T;
    const bf16* vt = vs + st * T;
    const bool edge = cut(q0, k0, sq, sk, causal, window);

#pragma unroll 1
    for (int s0 = 0; s0 < kBlk; s0 += kStep) {
      // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows x kStep keys a warp
      float sa[NK][4], pa[NK][4];
#pragma unroll
      for (int t = 0; t < NK; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[t][e] = pa[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {  // two key tiles per x4
          const int key = s0 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int col = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t kb[4], vb[4];
          ldsm_x4(smem_addr(kt + key * S + col), kb);
          ldsm_x4(smem_addr(vt + key * S + col), vb);
          mma(sa[2 * np], qf[kk], kb[0], kb[1]);
          mma(sa[2 * np + 1], qf[kk], kb[2], kb[3]);
          mma(pa[2 * np], gf[kk], vb[0], vb[1]);
          mma(pa[2 * np + 1], gf[kk], vb[2], vb[3]);
        }
      }
      // dS = P ∘ (dP − D) in float32; masked pairs 0, tested on cut tiles
#pragma unroll
      for (int t = 0; t < NK; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + s0 + t * 8 + tq * 2 + (e & 1);
          float p = exp2f(sa[t][e] * scale_log2 - lse2[e >> 1]);
          if (edge && !unmasked(row_a + (e >> 1) * 8, key, sq, sk, causal,
                                window))
            p = 0.f;
          pa[t][e] = p * (pa[t][e] - dl[e >> 1]);
        }
      }
      // dQ += dS·K, 16 keys a k-step; dS rounded to bf16 as A fragments
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        uint32_t sf[4];
        a_from_c(pa, kk, sf);
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {  // two column tiles per x4
          const int key = s0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = dp * 16 + (lane >> 4) * 8;
          uint32_t kb[4];
          ldsm_x4_trans(smem_addr(kt + key * S + col), kb);
          mma(dqa[2 * dp], sf, kb[0], kb[1]);
          mma(dqa[2 * dp + 1], sf, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  cp_async_wait<0>();  // nothing in flight when the block ends

  // dQ = scale·Σ dS·K, stored as bf16 pairs
#pragma unroll
  for (int t = 0; t < ND; ++t) {
    const int c = t * 8 + tq * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_a + 8 * i;
      if (row < sq && c < d)
        *reinterpret_cast<__nv_bfloat162*>(dq + q_off + row * q_pitch + c) =
            __floats2bfloat162_rn(dqa[t][2 * i] * scale,
                                  dqa[t][2 * i + 1] * scale);
    }
  }
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dout, const float* lse, const float* delta,
                   bf16* dq, bf16* dk, bf16* dv, int b, int sq, int sk, int h,
                   int hkv, int d, float scale, int causal, int window,
                   int vec16, cudaStream_t stream) {
  using L = Layout<DP>;
  static bool raised_kv[64] = {};
  static bool raised_q[64] = {};
  cudaError_t err = raise_smem(dkdv_tc_kernel<DP>, L::kDkdvBytes, raised_kv);
  if (err != cudaSuccess) return err;
  err = raise_smem(dq_tc_kernel<DP>, L::kDqBytes, raised_q);
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  dkdv_tc_kernel<DP><<<dim3(b * hkv, (sk + kBlk - 1) / kBlk), kThreads,
                       L::kDkdvBytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, sq, sk, h, hkv, d, scale,
      scale_log2, causal, window, vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_tc_kernel<DP><<<dim3(b * h, (sq + kBlk - 1) / kBlk), kThreads,
                     L::kDqBytes, stream>>>(
      q, k, v, dout, lse, delta, dq, sq, sk, h, hkv, d, scale, scale_log2,
      causal, window, vec16);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, int b, int sq, int sk,
                     int h, int hkv, int d, float scale, int causal,
                     int window, cudaStream_t stream) {
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const void* ptrs[] = {q, k, v, dout, dq, dk, dv};
  int vec16 = d % 8 == 0;
  for (const void* p : ptrs) {
    if (!aligned(p, 8)) return cudaErrorInvalidValue;
    vec16 = vec16 && aligned(p, 16);
  }
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* gb = static_cast<const bf16*>(dout);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
#define FLASH_BWD_TC_CASE(DP)                                              \
  case DP:                                                                \
    return launch<DP>(qb, kb, vb, gb, lse, delta, dqb, dkb, dvb, b, sq, sk, \
                      h, hkv, d, scale, causal, window, vec16, stream);
  switch ((d + 15) / 16 * 16) {
    FLASH_BWD_TC_CASE(16)
    FLASH_BWD_TC_CASE(32)
    FLASH_BWD_TC_CASE(48)
    FLASH_BWD_TC_CASE(64)
    FLASH_BWD_TC_CASE(80)
    FLASH_BWD_TC_CASE(96)
    FLASH_BWD_TC_CASE(112)
    FLASH_BWD_TC_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_TC_CASE
}

}  // namespace tcb

// (a), then (b) and (c) on the CUDA cores (float32) or the tensor cores
// (bf16), in order on `stream`; the first launch error, else cudaSuccess
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, const float* lse, float* delta, int b, int sq,
                   int sk, int h, int hkv, int d, float scale, int causal,
                   int window, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const dim3 rows_grid((sq + kRows - 1) / kRows, b * h);
  delta_kernel<T><<<rows_grid, kThreads, 0, stream>>>(
      static_cast<const T*>(o), gt, delta, sq, h, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (sizeof(T) == 2) {
    return tcb::dispatch(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, h,
                         hkv, d, scale, causal, window, stream);
  } else {
    const dim3 keys_grid((sk + kRows - 1) / kRows, b * hkv);
    dkdv_kernel<T><<<keys_grid, kThreads, 0, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), sq, sk, h, hkv, d, scale, causal, window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq_kernel<T><<<rows_grid, kThreads, 0, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), sq, sk, h, hkv, d,
        scale, causal, window);
    return cudaGetLastError();
  }
}

}  // namespace

// q, o, dout, dq [b, sq, h, d]; k, v, dk, dv [b, sk, hkv, d]: contiguous, on
// the device, all float32 (is_bf16 = 0) or all bf16 (is_bf16 = 1), 16-byte
// aligned; lse float32 [b, h, sq], the forward kernel's (natural log);
// delta float32 scratch of b·h·sq.  h % hkv == 0, d % 4 == 0,
// 0 < d <= 128, b·h <= 65535, sq, sk > 0.  Launches the three kernels on
// `stream` in order; returns the first launch error, else cudaSuccess.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* delta, int b, int sq, int sk, int h, int hkv, int d, float scale,
    int causal, int window, int is_bf16, void* stream) {
  if (d <= 0 || d > kMaxD || d % 4 != 0 || hkv <= 0 || h % hkv != 0 ||
      b <= 0 || sq <= 0 || sk <= 0 || static_cast<int64_t>(b) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, dl, b,
                                       sq, sk, h, hkv, d, scale, causal,
                                       window, s)
              : launch<float>(q, k, v, o, dout, dq, dk, dv, l, dl, b, sq, sk,
                              h, hkv, d, scale, causal, window, s);
  return static_cast<int>(err);
}
