// RWKV-6 (WKV6) recurrence in chunks of 16 tokens, from an initial state.
//
// Replaces: the Pallas kernel `wkv6` in src/repro/kernels/wkv6.py (body
// `_wkv6_kernel`): r, k, v [B, S, H, dk] (float32 or bf16), log_w
// [B, S, H, dk] float32, u [H, dk] -> o [B, S, H, dk] (r's dtype) and the
// final state sT [B, H, dk, dk] float32.  Per head the recurrence is
//   o_t = r_t @ (S_{t-1} + (u*k_t)^T v_t),  S_t = diag(exp(log_w_t)) S_{t-1}
//                                                   + k_t^T v_t.
// The TPU kernel starts from a zero state; this one takes an initial state
// s0 (zeros from the wrapper when there is none), which is the function the
// reference's model runs for an extend (`models/ssm.py::wkv6_chunked`).
// Per chunk of 16 tokens, in float32: p = inclusive cumsum of log_w,
// p_shift = exclusive cumsum; the inter-chunk term (r·exp(p_shift)) @ S;
// the intra-chunk matrix A[t][s] = Σ_d r[t,d] k[s,d] exp(p_shift[t,d] -
// p[s,d]) for s < t plus the bonus diagonal A[t][t] = Σ_d r u k; o += A v;
// then S = diag(exp(p_last)) S + (k·exp(p_last - p))^T v.  p_shift[t] is
// the running sum before token t, so p_shift[t] - p[s] <= 0 holds exactly
// for s < t (adding a non-positive float never increases a sum): every
// exponent is <= 0, and a masked pair is never evaluated at all.  A ragged
// last chunk reads r = k = v = 0 and log_w = 0 past S: the identity.
//
// Bound on an H100: per call it reads r, k, v (2 or 4 bytes each), log_w
// (4 bytes) per element, the initial state, and writes o and the final
// state: ~17 MB for rwkv6-3b at S = 512 (H = 40, dk = 64, bf16), ~5 µs at
// 3.35 TB/s.  Its float32 work is ~0.45 GFLOP (the intra-chunk matrix with
// one exp per (t, s, d), the state product and update), ~7 µs at 67
// TFLOP/s: operations bound it, on the CUDA cores, not the tensor cores.
// This first version does not approach either: each chunk is a short
// dependent sequence of shared-memory passes separated by barriers, so a
// block's time is latency (one global load round trip and four barriers per
// chunk, 32 chunks at S = 512).
//
// Design: the TPU's sequential chunk grid and VMEM state scratch become a
// loop over chunks inside one block that keeps its float32 state slice in
// shared memory.  Columns of the state are independent (S[:, j] depends
// only on v[:, j]), so a block owns one (batch·head, 16 state columns):
// 4 blocks per head at dk = 64, 160 blocks for rwkv6-3b's 40 heads on the
// card's 132 SMs.  The intra-chunk [16, 16, dk] decay tensor is never
// stored: each of 256 threads owns one (t, s) pair and sums over d, with
// the exp computed in the loop (each block recomputes A for its columns,
// 16·15/2·dk exps per chunk).  Shared rows are padded to dk + 1 floats so
// the 16 threads of a warp that read 16 different rows at one d hit 16
// different banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;                  // tokens per chunk
constexpr int kMaxK = 64;                   // largest head size taken
constexpr int kCols = 16;                   // state columns per block
constexpr int kThreads = kChunk * kCols;    // 256: one (t, j) or (t, s) each
constexpr int kPad = kMaxK + 1;             // padded shared row

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
__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ log_w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ o, float* __restrict__ s_out, int s_len,
                int h, int dk) {
  __shared__ float rs[kChunk][kPad];   // r, then r·exp(p_shift)
  __shared__ float ks[kChunk][kPad];   // k, then k·exp(p_last - p)
  __shared__ float ps[kChunk][kPad];   // log_w, then p (inclusive)
  __shared__ float qs[kChunk][kPad];   // p_shift (exclusive)
  __shared__ float vs[kChunk][kCols];  // this block's columns of v
  __shared__ float as[kChunk][kChunk + 1];
  __shared__ float st[kMaxK][kCols];   // state slice S[:, j0 : j0 + kCols]
  __shared__ float us[kMaxK];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh % h;
  const int j0 = blockIdx.y * kCols;
  const int ncol = min(kCols, dk - j0);
  const size_t step = static_cast<size_t>(h) * dk;   // between tokens
  const size_t base = static_cast<size_t>(b) * s_len * step +
                      static_cast<size_t>(head) * dk;
  const size_t sbase = static_cast<size_t>(bh) * dk * dk;

  for (int e = tid; e < kMaxK * kCols; e += kThreads) {
    const int d = e / kCols, j = e % kCols;
    st[d][j] = (d < dk && j < ncol) ? s0[sbase + static_cast<size_t>(d) * dk +
                                         j0 + j]
                                    : 0.f;
  }
  for (int d = tid; d < kMaxK; d += kThreads)
    us[d] = d < dk ? u[head * dk + d] : 0.f;

  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int t0 = ic * kChunk;
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < kChunk * kMaxK; e += kThreads) {
      const int t = e / kMaxK, d = e % kMaxK;
      const bool in = t0 + t < s_len && d < dk;
      const size_t off = base + static_cast<size_t>(t0 + t) * step + d;
      rs[t][d] = in ? to_f(r[off]) : 0.f;
      ks[t][d] = in ? to_f(k[off]) : 0.f;
      ps[t][d] = in ? log_w[off] : 0.f;
    }
    {
      const int t = tid / kCols, j = tid % kCols;
      const bool in = t0 + t < s_len && j < ncol;
      vs[t][j] = in ? to_f(v[base + static_cast<size_t>(t0 + t) * step + j0 +
                             j])
                    : 0.f;
    }
    __syncthreads();
    if (tid < kMaxK) {  // cumulative decay along the chunk, per channel
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        qs[t][tid] = acc;
        acc += ps[t][tid];
        ps[t][tid] = acc;
      }
    }
    __syncthreads();
    {  // A[t][s]: strict lower triangle with decay, bonus diagonal
      const int t = tid / kChunk, s = tid % kChunk;
      float acc = 0.f;
      if (s < t) {
        for (int d = 0; d < dk; ++d)
          acc += rs[t][d] * ks[s][d] * expf(qs[t][d] - ps[s][d]);
      } else if (s == t) {
        for (int d = 0; d < dk; ++d) acc += rs[t][d] * us[d] * ks[t][d];
      }
      as[t][s] = acc;
    }
    __syncthreads();
    for (int e = tid; e < kChunk * kMaxK; e += kThreads) {
      const int t = e / kMaxK, d = e % kMaxK;
      rs[t][d] *= expf(qs[t][d]);
      ks[t][d] *= expf(ps[kChunk - 1][d] - ps[t][d]);
    }
    __syncthreads();
    {  // o[t][j] = (r·exp(p_shift))[t] @ S[:, j] + Σ_{s<=t} A[t][s] v[s][j]
      const int t = tid / kCols, j = tid % kCols;
      float acc = 0.f;
      for (int d = 0; d < dk; ++d) acc += rs[t][d] * st[d][j];
      for (int s = 0; s <= t; ++s) acc += as[t][s] * vs[s][j];
      if (t0 + t < s_len && j < ncol)
        o[base + static_cast<size_t>(t0 + t) * step + j0 + j] = from_f<T>(acc);
    }
    __syncthreads();  // every reader of the old state is done
    for (int e = tid; e < kMaxK * kCols; e += kThreads) {
      const int d = e / kCols, j = e % kCols;
      if (d < dk) {
        float acc = st[d][j] * expf(ps[kChunk - 1][d]);
        for (int s = 0; s < kChunk; ++s) acc += ks[s][d] * vs[s][j];
        st[d][j] = acc;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kMaxK * kCols; e += kThreads) {
    const int d = e / kCols, j = e % kCols;
    if (d < dk && j < ncol)
      s_out[sbase + static_cast<size_t>(d) * dk + j0 + j] = st[d][j];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* log_w, const void* u, const void* s0, void* o,
                   void* s_out, int b, int s_len, int h, int dk,
                   cudaStream_t stream) {
  const dim3 grid(b * h, (dk + kCols - 1) / kCols);
  wkv6_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(log_w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(o), static_cast<float*>(s_out), s_len, h, dk);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, o [b, s_len, h, dk] (all float32: is_bf16 = 0, or all bf16:
// is_bf16 = 1), log_w [b, s_len, h, dk] float32, u [h, dk] float32, s0 and
// s_out [b, h, dk, dk] float32: contiguous, on the device; 0 < dk <= 64.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* log_w, const void* u, const void* s0,
                           void* o, void* s_out, int b, int s_len, int h,
                           int dk, int is_bf16, void* stream) {
  if (dk <= 0 || dk > kMaxK || s_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(r, k, v, log_w, u, s0, o, s_out, b,
                                      s_len, h, dk, st)
              : launch<float>(r, k, v, log_w, u, s0, o, s_out, b, s_len, h,
                              dk, st);
  return static_cast<int>(err);
}
