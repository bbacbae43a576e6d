// One-token GQA attention against a contiguous KV cache (decode).
//
// Replaces: the Pallas kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (body `_decode_kernel`, and the
// log-sum-exp combine it runs in jnp afterwards): q [B, H, d], k/v caches
// [B, M, Hkv, d], valid [B, M] bool -> o [B, H, d], float32 or bf16.  Query
// head h reads KV head h / (H / Hkv); a slot with valid = false scores
// -1e30, as in the TPU kernel, so a row with no valid slot at all gets a
// uniform softmax: the mean of V over all M slots.
//
// Bound on an H100: bytes.  A step does 4·H·d FLOPs per valid slot on
// 2·Hkv·d elements of it, H / Hkv = 4 FLOPs per byte in bf16 for
// qwen3-8b: far below the card's ~295, so the bytes that decide the output
// are the bound (the K and V rows of the valid slots: ~2.4 MB, ~0.7 µs at
// 600 valid slots of [1, 1024, 8, 128] in bf16).  At that size the two
// launches cost more than the bytes, so the design moves only those bytes
// and keeps every block's loads in flight together: on an H100 80GB HBM3
// at 700 W both kernels take 0.013 ms of device time per qwen3-8b step
// (PERF.md).
//
// Design.  Pass 1 (`decode_split_kernel`): one block per (split, batch·KV
// head); the wrapper's split plan (`kernels/decode_attention.py::
// split_plan`) cuts the M slots into contiguous ranges so that about one
// wave of blocks covers the card.  A block first reads the whole mask row:
// a range with no valid slot, in a row that has one elsewhere, cannot
// change the output, so it writes an empty partial (l = 0) and reads no
// K or V.  Otherwise it streams its range in tiles of 32 slots through a
// two-stage shared-memory ring with `cp.async` (16 bytes a thread; an
// invalid slot's copy has source size 0, so its bytes are never read and
// land as zeros).  The G <= 16 query heads of the group keep their 16-byte
// chunk of q in registers; a slot's dot products are split over the lanes
// of its chunks and finished with shuffles.  One warp per head updates the
// running max and sum; for P·V each thread owns two dimensions and a
// subset of the tile's slots, accumulating acc[G][2] in registers, and the
// subsets are summed in shared memory at the end.  Pass 2
// (`decode_combine_kernel`), one block per (batch, query head), weighs the
// non-empty partials by exp(m_p − m*) once per partial and sums them over
// d.  Head dims whose rows are not a whole number of 16-byte chunks (or
// unaligned tensors) take plain element loads into the same ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;     // largest head dim taken
constexpr int kMaxG = 16;      // largest query-head group taken
constexpr int kTile = 32;      // slots per staged tile (one per lane)
constexpr int kStages = 2;     // tiles in flight
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; with src_bytes = 0 nothing is read and
// the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
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

// A 16-byte chunk of T as floats.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kE = 4;
  __device__ static void to_f(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kE = 8;
  __device__ static void to_f(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Two neighbouring elements (4- or 8-byte aligned) as floats.
__device__ __forceinline__ void load_pair(const float* p, float& a,
                                          float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a,
                                          float& b) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
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

// A chunk of `n` <= kE elements (zeros past n) by plain loads.
template <typename T>
__device__ __forceinline__ uint4 load_chunk_slow(const T* p, int n) {
  uint4 u = make_uint4(0, 0, 0, 0);
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < Chunk<T>::kE; ++i)
    if (i < n) e[i] = p[i];
  return u;
}

// Shared memory of pass 1 for head dims padded to dp, in bytes: the K/V
// ring (the slot groups' sums alias it after the loop), then the scores
// [GMAX][kTile] and the per-head running max, sum and correction.
template <typename T, int GMAX>
__host__ __device__ constexpr int ring_bytes(int dp) {
  const int ring = kStages * 2 * kTile * dp * static_cast<int>(sizeof(T));
  const int sums = (kThreads / (dp / 2)) * GMAX * dp * 4;
  return ring > sums ? ring : sums;
}
template <typename T, int GMAX>
__host__ __device__ constexpr int split_smem_bytes(int dp) {
  return ring_bytes<T, GMAX>(dp) + GMAX * kTile * 4 + 3 * GMAX * 4;
}

// grid (splits, B·Hkv).  Partials: m_part/l_part [B·Hkv, splits, G] and
// acc_part [B·Hkv, splits, G, d], float32; an empty range writes l = 0.
template <typename T, int GMAX>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ m_part,
                        float* __restrict__ l_part,
                        float* __restrict__ acc_part, int h, int hkv, int m,
                        int d, int chunk, float scale, int fast) {
  constexpr int kE = Chunk<T>::kE;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int bkv = blockIdx.y;
  const int b = bkv / hkv;
  const int kvh = bkv % hkv;
  const int g_n = h / hkv;
  const int s0 = split * chunk;
  const int s1 = min(m, s0 + chunk);
  const int n_chunks = (d + kE - 1) / kE;  // 16-byte chunks per row
  const int dp = n_chunks * kE;            // row length in shared memory
  const int64_t part = static_cast<int64_t>(bkv) * splits + split;

  T* ring = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem);  // after the loop
  float* ps = reinterpret_cast<float*>(smem + ring_bytes<T, GMAX>(dp));
  float* m_s = ps + GMAX * kTile;
  float* l_s = m_s + GMAX;
  float* corr_s = l_s + GMAX;

  // the mask first: does this row, and this range, hold a valid slot?
  const uint8_t* vrow = valid + static_cast<int64_t>(b) * m;
  int row_any = 0, range_any = 0;
  for (int t = tid; t < m; t += kThreads)
    if (vrow[t]) {
      row_any = 1;
      range_any |= t >= s0 && t < s1;
    }
  row_any = __syncthreads_or(row_any);
  range_any = __syncthreads_or(range_any);
  if (row_any && !range_any) {  // exp(-1e30 - m*) = 0 for all of it
    if (tid < g_n) {
      m_part[part * g_n + tid] = kNegInf;
      l_part[part * g_n + tid] = 0.f;
    }
    return;
  }
  const bool all = !row_any;  // no valid slot: every slot scores -1e30

  // caches [B, M, Hkv, d]: slot t of this KV head at ((b·M + t)·Hkv + kvh)·d
  const int64_t stride = static_cast<int64_t>(hkv) * d;
  const int64_t base = (static_cast<int64_t>(b) * m * hkv + kvh) * d;

  auto load_tile = [&](int t0, int stage) {
    T* kt = ring + stage * 2 * kTile * dp;
    T* vt = kt + kTile * dp;
    for (int idx = tid; idx < kTile * n_chunks; idx += kThreads) {
      const int j = idx / n_chunks;
      const int c = idx - j * n_chunks;
      const int t = t0 + j;
      const bool live = t < s1 && (all || vrow[t]);
      const int64_t off = base + (live ? t : 0) * stride + c * kE;
      if (fast) {
        cp_async16(kt + j * dp + c * kE, kc + off, live ? 16 : 0);
        cp_async16(vt + j * dp + c * kE, vc + off, live ? 16 : 0);
      } else {
        const int n = live ? min(kE, d - c * kE) : 0;
        *reinterpret_cast<uint4*>(kt + j * dp + c * kE) =
            load_chunk_slow(kc + off, n);
        *reinterpret_cast<uint4*>(vt + j * dp + c * kE) =
            load_chunk_slow(vc + off, n);
      }
    }
  };

  const int n_tiles = (s1 - s0 + kTile - 1) / kTile;
  load_tile(s0, 0);
  cp_async_commit();

  // this lane's chunk of q for each head of the group, in registers: the
  // lanes of one slot are its cp = 2^k >= n_chunks chunks
  int cp = 1;
  while (cp < n_chunks) cp *= 2;
  const int my_c = lane % cp;
  const int slots_per_pass = 32 / cp;
  const T* qg = q + (static_cast<int64_t>(b) * h + kvh * g_n) * d;
  uint4 qr[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    qr[g] = make_uint4(0, 0, 0, 0);
    if (g < g_n && my_c < n_chunks) {
      const T* p = qg + g * d + my_c * kE;
      qr[g] = fast ? *reinterpret_cast<const uint4*>(p)
                   : load_chunk_slow(p, min(kE, d - my_c * kE));
    }
  }
  if (tid < GMAX) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // P·V: thread = (pair of dims, group of slots)
  const int n_pairs = dp / 2;
  const int n_groups = kThreads / n_pairs;
  const int pair = tid % n_pairs;
  const int grp = tid / n_pairs;  // >= n_groups: idle in P·V
  float acc[GMAX][2];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = s0 + it * kTile;
    if (it + 1 < n_tiles) load_tile(t0 + kTile, (it + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* kt = ring + (it % kStages) * 2 * kTile * dp;
    const T* vt = kt + kTile * dp;

    // scores: cp lanes per slot, each one chunk; all G heads at once
    for (int j0 = warp * slots_per_pass; j0 < kTile;
         j0 += kWarps * slots_per_pass) {
      const int j = j0 + lane / cp;
      float kf[kE];
      uint4 ku = make_uint4(0, 0, 0, 0);
      if (my_c < n_chunks)
        ku = *reinterpret_cast<const uint4*>(kt + j * dp + my_c * kE);
      Chunk<T>::to_f(ku, kf);
      float dot[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float qf[kE];
        Chunk<T>::to_f(qr[g], qf);
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) s = fmaf(qf[e], kf[e], s);
        dot[g] = s;
      }
      for (int off = cp / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      }
      if (my_c == 0) {
        const int t = t0 + j;
        const bool ok = t < s1 && !all && vrow[t];
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < g_n) ps[g * kTile + j] = ok ? dot[g] * scale : kNegInf;
      }
    }
    __syncthreads();

    // per head: running max and sum; slots past the range weigh nothing
    const bool in_range = t0 + lane < s1;
    for (int g = warp; g < g_n; g += kWarps) {
      const float x = ps[g * kTile + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(in_range ? x : kNegInf));
      const float e = in_range ? expf(x - m_new) : 0.f;
      const float corr = expf(m_old - m_new);
      ps[g * kTile + lane] = e;
      const float sum = warp_sum(e);
      __syncwarp();
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    if (grp < n_groups) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float c = g < g_n ? corr_s[g] : 0.f;
        acc[g][0] *= c;
        acc[g][1] *= c;
      }
      for (int j = grp; j < kTile; j += n_groups) {
        float v0, v1;
        load_pair(vt + j * dp + 2 * pair, v0, v1);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < g_n) {
            const float p = ps[g * kTile + j];
            acc[g][0] = fmaf(p, v0, acc[g][0]);
            acc[g][1] = fmaf(p, v1, acc[g][1]);
          }
        }
      }
    }
    __syncthreads();  // the stage and the scores are free again
  }

  // sum the slot groups; red [n_groups][GMAX][dp] aliases the ring
  if (grp < n_groups) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      red[(grp * GMAX + g) * dp + 2 * pair] = acc[g][0];
      red[(grp * GMAX + g) * dp + 2 * pair + 1] = acc[g][1];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g_n * d; idx += kThreads) {
    const int g = idx / d;
    const int dim = idx - g * d;
    float s = 0.f;
    for (int r = 0; r < n_groups; ++r) s += red[(r * GMAX + g) * dp + dim];
    acc_part[(part * g_n + g) * d + dim] = s;
  }
  if (tid < g_n) {
    m_part[part * g_n + tid] = m_s[tid];
    l_part[part * g_n + tid] = l_s[tid];
  }
}

// grid (B·H): combine one query head's partials by log-sum-exp.  Each
// non-empty partial's weight exp(m_p - m*) is computed once; empty ones
// (l = 0) are never read further.  Dynamic shared memory: splits floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ m_part,
                          const float* __restrict__ l_part,
                          const float* __restrict__ acc_part,
                          T* __restrict__ o, int h, int hkv, int d,
                          int splits) {
  extern __shared__ float w_s[];
  __shared__ float denom_s;
  const int bhead = blockIdx.x;
  const int b = bhead / h;
  const int head = bhead % h;
  const int g_n = h / hkv;
  const int g = head % g_n;
  const int64_t bkv = static_cast<int64_t>(b) * hkv + head / g_n;
  const int tid = threadIdx.x;

  if (tid < 32) {
    float mx = kNegInf;  // no partial's max is below it
    for (int p = tid; p < splits; p += 32) {
      const int64_t i = (bkv * splits + p) * g_n + g;
      if (l_part[i] > 0.f) mx = fmaxf(mx, m_part[i]);
    }
    mx = warp_max(mx);
    float l = 0.f;
    for (int p = tid; p < splits; p += 32) {
      const int64_t i = (bkv * splits + p) * g_n + g;
      const float w = l_part[i] > 0.f ? expf(m_part[i] - mx) : 0.f;
      w_s[p] = w;
      l += w * l_part[i];
    }
    l = warp_sum(l);
    if (tid == 0) denom_s = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float denom = denom_s;
  for (int dim = tid; dim < d; dim += kThreads) {
    float acc = 0.f;
    for (int p = 0; p < splits; ++p) {
      const float w = w_s[p];
      if (w != 0.f)
        acc = fmaf(w, acc_part[((bkv * splits + p) * g_n + g) * d + dim],
                   acc);
    }
    o[static_cast<int64_t>(bhead) * d + dim] = from_f<T>(acc / denom);
  }
}

template <typename T, int GMAX>
cudaError_t launch_split(const T* q, const T* kc, const T* vc,
                         const uint8_t* valid, float* mp, float* lp,
                         float* ap, T* o, int b, int h, int hkv, int m, int d,
                         int chunk, float scale, int fast,
                         cudaStream_t stream) {
  constexpr int kEl = Chunk<T>::kE;
  const int dp = (d + kEl - 1) / kEl * kEl;
  // above 48 KB only after raising the limit, once per device
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(decode_split_kernel<T, GMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               split_smem_bytes<T, GMAX>(kMaxD));
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  const int splits = (m + chunk - 1) / chunk;
  decode_split_kernel<T, GMAX><<<dim3(splits, b * hkv), kThreads,
                                 split_smem_bytes<T, GMAX>(dp), stream>>>(
      q, kc, vc, valid, mp, lp, ap, h, hkv, m, d, chunk, scale, fast);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<b * h, kThreads, splits * sizeof(float),
                             stream>>>(mp, lp, ap, o, h, hkv, d, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* valid, float* mp, float* lp, float* ap,
                   void* o, int b, int h, int hkv, int m, int d, int chunk,
                   float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(kc);
  const T* vt = static_cast<const T*>(vc);
  const uint8_t* vm = static_cast<const uint8_t*>(valid);
  T* ot = static_cast<T*>(o);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int fast = (d * static_cast<int>(sizeof(T))) % 16 == 0 &&
                   aligned(q) && aligned(kc) && aligned(vc);
  const int g_n = h / hkv;
  if (g_n <= 1)
    return launch_split<T, 1>(qt, kt, vt, vm, mp, lp, ap, ot, b, h, hkv, m,
                              d, chunk, scale, fast, stream);
  if (g_n <= 2)
    return launch_split<T, 2>(qt, kt, vt, vm, mp, lp, ap, ot, b, h, hkv, m,
                              d, chunk, scale, fast, stream);
  if (g_n <= 4)
    return launch_split<T, 4>(qt, kt, vt, vm, mp, lp, ap, ot, b, h, hkv, m,
                              d, chunk, scale, fast, stream);
  if (g_n <= 8)
    return launch_split<T, 8>(qt, kt, vt, vm, mp, lp, ap, ot, b, h, hkv, m,
                              d, chunk, scale, fast, stream);
  return launch_split<T, 16>(qt, kt, vt, vm, mp, lp, ap, ot, b, h, hkv, m, d,
                             chunk, scale, fast, stream);
}

}  // namespace

// q [b, h, d], k/v caches [b, m, hkv, d], valid [b, m] bool (one byte),
// o [b, h, d]: contiguous, on the device, all float32 (is_bf16 = 0) or all
// bf16 (is_bf16 = 1).  Slots per split `chunk` (a multiple of 32, from the
// wrapper's split plan); float32 partials m_part/l_part [b·hkv, splits,
// h / hkv] and acc_part [b·hkv, splits, h / hkv, d] with splits =
// ceil(m / chunk).  h % hkv == 0, h / hkv <= 16, d <= 128, m >= 1.
// Launches both passes on `stream`; returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* valid,
                                       void* m_part, void* l_part,
                                       void* acc_part, void* o, int b, int h,
                                       int hkv, int m, int d, int chunk,
                                       float scale, int is_bf16,
                                       void* stream) {
  if (d <= 0 || d > kMaxD || hkv <= 0 || h % hkv != 0 || h / hkv > kMaxG ||
      m <= 0 || chunk <= 0 || chunk % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, kc, vc, valid, mp, lp, ap, o, b, h,
                                      hkv, m, d, chunk, scale, s)
              : launch<float>(q, kc, vc, valid, mp, lp, ap, o, b, h, hkv, m,
                              d, chunk, scale, s);
  return static_cast<int>(err);
}
