// Mamba-2 SSD scan in chunks of 16 tokens, from an initial state.
//
// Replaces: the Pallas kernel `ssd` in src/repro/kernels/ssd.py (body
// `_ssd_kernel`): x [B, S, H, hd] (float32 or bf16), B and C [B, S, ds]
// (x's dtype, shared by all heads), dt [B, S, H] float32 (after the
// softplus), a_log and the skip D [H] float32 -> y [B, S, H, hd] (x's
// dtype) and the final state sT [B, H, hd, ds] float32.  Per head the
// recurrence is
//   S_t = a_t S_{t-1} + dt_t (x_t outer B_t),  y_t = S_t @ C_t + D x_t,
// with the scalar decay a_t = exp(la_t), la_t = -exp(a_log) dt_t.  The TPU
// kernel starts from a zero state; this one takes an initial state s0
// (zeros from the wrapper when there is none), the function of the
// reference's `models/ssm.py::ssd_chunked`.  Per chunk of 16 tokens, in
// float32: p = inclusive cumsum of la; M[t][s] = (C_t·B_s) exp(p_t - p_s)
// dt_s for s <= t (inclusive, unlike WKV6's strict mask); y = M x +
// exp(p)·(C Sᵀ) + D x; S = exp(p_last) S + Σ_s exp(p_last - p_s) dt_s
// x_s Bᵀ_s.  dt >= 0, so la <= 0 and the running sum p never increases:
// every exponent p_t - p_s with s <= t is <= 0 exactly, and a masked pair
// is never evaluated.  A ragged last chunk reads x = B = C = 0 and dt = 0
// past S: the identity.
//
// Bound on an H100: per call it reads x (2 or 4 bytes per element), B and
// C once (not once per head: the TPU wrapper's broadcast copies are not
// made), dt, and the initial state, and writes y and the final state:
// ~19 MB for zamba2-7b at S = 512 (H = 112, hd = 64, ds = 64, bf16), ~6 µs
// at 3.35 TB/s.  Its float32 work is ~1.2 GFLOP (the C·B product and the
// masked mix, the C·Sᵀ inter term and the state update), ~18 µs at 67
// TFLOP/s: operations bound it, on the CUDA cores.  Like the WKV6 kernel,
// this first version is latency-bound: a dependent sequence of shared-memory
// passes with four barriers per chunk.
//
// Design: one block per (batch·head, 16 rows of the state): rows are
// independent (S[i, :] depends only on x[:, i]), so zamba2-7b's 112 heads
// of 64 give 448 blocks.  The float32 state slice stays in shared memory
// across the loop over chunks that replaces the TPU's sequential chunk
// grid.  Each block reads B and C for its chunk straight from the shared
// [B, S, ds] rows and recomputes the 16 × 16 C·Bᵀ product for its head
// (the decay differs per head).  Shared rows are padded to ds + 1 floats so
// that a warp reading 16 rows at one n hits 16 banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;                  // tokens per chunk
constexpr int kMaxN = 64;                   // largest state size ds taken
constexpr int kRows = 16;                   // state rows (of hd) per block
constexpr int kThreads = kChunk * kRows;    // 256: one (t, i) or (t, s) each
constexpr int kPad = kMaxN + 1;             // padded shared row

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
    ssd_kernel(const T* __restrict__ x, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dt,
               const float* __restrict__ a_log,
               const float* __restrict__ d_skip, const float* __restrict__ s0,
               T* __restrict__ y, float* __restrict__ s_out, int s_len, int h,
               int hd, int ds) {
  __shared__ float bs[kChunk][kPad];
  __shared__ float cs[kChunk][kPad];
  __shared__ float xs[kChunk][kRows];   // this block's rows of x
  __shared__ float ms[kChunk][kChunk + 1];
  __shared__ float st[kRows][kPad];     // state slice S[i0 : i0 + kRows, :]
  __shared__ float dts[kChunk];
  __shared__ float pss[kChunk];         // p, inclusive cumsum of la
  __shared__ float ws[kChunk];          // exp(p_last - p_s) dt_s

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh % h;
  const int i0 = blockIdx.y * kRows;
  const int nrow = min(kRows, hd - i0);
  const float neg_a = -expf(a_log[head]);
  const float dsk = d_skip[head];
  const size_t xstep = static_cast<size_t>(h) * hd;  // between tokens
  const size_t xbase = static_cast<size_t>(b) * s_len * xstep +
                       static_cast<size_t>(head) * hd + i0;
  const size_t bbase = static_cast<size_t>(b) * s_len * ds;
  const size_t dbase = static_cast<size_t>(b) * s_len * h + head;
  const size_t sbase = (static_cast<size_t>(bh) * hd + i0) * ds;

  for (int e = tid; e < kRows * kMaxN; e += kThreads) {
    const int i = e / kMaxN, n = e % kMaxN;
    st[i][n] = (i < nrow && n < ds)
                   ? s0[sbase + static_cast<size_t>(i) * ds + n]
                   : 0.f;
  }

  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int t0 = ic * kChunk;
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < kChunk * kMaxN; e += kThreads) {
      const int t = e / kMaxN, n = e % kMaxN;
      const bool in = t0 + t < s_len && n < ds;
      const size_t off = bbase + static_cast<size_t>(t0 + t) * ds + n;
      bs[t][n] = in ? to_f(bm[off]) : 0.f;
      cs[t][n] = in ? to_f(cm[off]) : 0.f;
    }
    {
      const int t = tid / kRows, i = tid % kRows;
      const bool in = t0 + t < s_len && i < nrow;
      xs[t][i] = in ? to_f(x[xbase + static_cast<size_t>(t0 + t) * xstep + i])
                    : 0.f;
    }
    if (tid < kChunk)
      dts[tid] = t0 + tid < s_len
                     ? dt[dbase + static_cast<size_t>(t0 + tid) * h]
                     : 0.f;
    __syncthreads();
    if (tid == 0) {  // cumulative log decay along the chunk
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        acc += neg_a * dts[t];
        pss[t] = acc;
      }
    }
    __syncthreads();
    {  // M[t][s] = (C_t·B_s) exp(p_t - p_s) dt_s, s <= t
      const int t = tid / kChunk, s = tid % kChunk;
      float acc = 0.f;
      if (s <= t) {
        for (int n = 0; n < ds; ++n) acc += cs[t][n] * bs[s][n];
        acc = acc * expf(pss[t] - pss[s]) * dts[s];
      }
      ms[t][s] = acc;
      if (tid < kChunk)
        ws[tid] = expf(pss[kChunk - 1] - pss[tid]) * dts[tid];
    }
    __syncthreads();
    {  // y[t][i] = Σ_{s<=t} M[t][s] x[s][i] + exp(p_t) C_t·S[i] + D x[t][i]
      const int t = tid / kRows, i = tid % kRows;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += ms[t][s] * xs[s][i];
      float inter = 0.f;
      for (int n = 0; n < ds; ++n) inter += cs[t][n] * st[i][n];
      acc += expf(pss[t]) * inter + dsk * xs[t][i];
      if (t0 + t < s_len && i < nrow)
        y[xbase + static_cast<size_t>(t0 + t) * xstep + i] = from_f<T>(acc);
    }
    __syncthreads();  // every reader of the old state is done
    const float decay = expf(pss[kChunk - 1]);
    for (int e = tid; e < kRows * kMaxN; e += kThreads) {
      const int i = e / kMaxN, n = e % kMaxN;
      if (i < nrow && n < ds) {
        float acc = st[i][n] * decay;
        for (int s = 0; s < kChunk; ++s) acc += ws[s] * xs[s][i] * bs[s][n];
        st[i][n] = acc;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kRows * kMaxN; e += kThreads) {
    const int i = e / kMaxN, n = e % kMaxN;
    if (i < nrow && n < ds)
      s_out[sbase + static_cast<size_t>(i) * ds + n] = st[i][n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* bm, const void* cm,
                   const void* dt, const void* a_log, const void* d_skip,
                   const void* s0, void* y, void* s_out, int b, int s_len,
                   int h, int hd, int ds, cudaStream_t stream) {
  const dim3 grid(b * h, (hd + kRows - 1) / kRows);
  ssd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<const float*>(s0), static_cast<T*>(y),
      static_cast<float*>(s_out), s_len, h, hd, ds);
  return cudaGetLastError();
}

}  // namespace

// x, y [b, s_len, h, hd] and bm, cm [b, s_len, ds] (all float32: is_bf16 =
// 0, or all bf16: is_bf16 = 1), dt [b, s_len, h], a_log and d_skip [h], s0
// and s_out [b, h, hd, ds] float32: contiguous, on the device; 0 < ds <= 64.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int ssd_launch(const void* x, const void* bm, const void* cm,
                          const void* dt, const void* a_log,
                          const void* d_skip, const void* s0, void* y,
                          void* s_out, int b, int s_len, int h, int hd, int ds,
                          int is_bf16, void* stream) {
  if (ds <= 0 || ds > kMaxN || hd <= 0 || s_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, bm, cm, dt, a_log, d_skip, s0, y,
                                      s_out, b, s_len, h, hd, ds, st)
              : launch<float>(x, bm, cm, dt, a_log, d_skip, s0, y, s_out, b,
                              s_len, h, hd, ds, st);
  return static_cast<int>(err);
}
