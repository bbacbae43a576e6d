// The gradient of the RWKV-6 (WKV6) chunked recurrence, in chunks of 16.
//
// Replaces: no Pallas kernel.  The reference trains its RWKV-6 models by
// differentiating `models/ssm.py::wkv6_chunked` under `jax.value_and_grad`
// (its Pallas kernel `kernels/wkv6.py::wkv6` has no backward); this is
// that gradient on the card.  Per head the forward is
//   o_t = r_t @ (S_{t-1} + (u*k_t)^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t
// with w_t = exp(log_w_t).  Given dO and the final state's gradient dsT
// (a null pointer: zeros), it returns dr, dk, dv (r's dtype), dlog_w,
// du and, when asked, ds0 (float32), from the forward's saved incoming
// state of every chunk (`wkv6.cu`, `states`) and its final state.
//
// Per chunk of 16 tokens, with p the inclusive and q the exclusive running
// sum of log_w per channel (summed serially, so q_t - p_s <= 0 for s < t
// exactly, and no exponent is positive), S_in the chunk's incoming state
// and dS_out the gradient of its outgoing one:
//   dr_t = exp(q_t)·(S_in dO_t) + Σ_{s<t} exp(q_t - p_s)∘k_s (v_s·dO_t)
//          + u∘k_t (v_t·dO_t)
//   dk_s = exp(p_last - p_s)·(dS_out v_s) + Σ_{t>s} exp(q_t - p_s)∘r_t
//          (v_s·dO_t) + u∘r_s (v_s·dO_s)
//   dv_s = (k_s∘exp(p_last - p_s))ᵀ dS_out + Σ_{t>=s} A[t][s] dO_t
//          (A the forward's intra-chunk matrix with its bonus diagonal)
//   du   = Σ_t r_t∘k_t (v_t·dO_t)
//   dS_in = diag(exp(p_last)) dS_out + Σ_t (r_t∘exp(q_t))ᵀ dO_t.
// The log-decay gradient, w_τ·Σ_v S_{τ-1}∘dS_τ, is formed without a state
// per token, by the identity (the chunk as a recurrence of its own, from
// S_in to S_out):
//   dlog_w_τ = Σ_{t>τ} r_t∘dr'_t - Σ_{s>=τ} k_s∘dk'_s + Σ_v S_out∘dS_out,
// dr' and dk' being dr and dk without their bonus (u) terms; the suffix
// sums stay inside the chunk, and S_out is the next chunk's saved state
// (the final state for the last chunk).
//
// Bound on an H100: per call it reads r, k, v, dO (2 or 4 bytes), log_w
// and the saved states (4 bytes; dk·dk floats per chunk and head) and
// writes dr, dk, dv, dlog_w: ~0.4 GB for rwkv6-3b at 4,096 tokens (40 heads
// of 64, bf16), ~0.12 ms at 3.35 TB/s; its float32 work (three 16·64·64
// products and the pair sums, with one exp per pair and channel, per chunk
// and head) ~8 GFLOP, ~0.12 ms at 67 TFLOP/s on the CUDA cores.  It runs
// far above that bound (PERF.md §6, row 5b): the reverse pass's serial walk
// takes most of the call.
//
// Design: three launches per call, every sum in one fixed order (two runs
// give the same bits), every product in float32 on the CUDA cores (bf16
// enters as inputs, exact in float32, and leaves as the rounded dr, dk,
// dv).
//
// `wkv6_bwd_state_kernel` (the reverse pass), one block of 256 threads per
// (batch·head, 16 state columns): the serial walk from the last chunk to
// the first.  dS's columns are independent (the decay scales rows), so
// each thread keeps 4 entries of one row of dS in registers and forms its
// own running sums of log_w: no shared memory and no barrier; a chunk's
// loads are all issued before its serial sums.  What bounds it is that
// walk: 256 dependent chunk steps at 4,096 tokens, each waiting on its
// loads (PERF.md).  It writes
// each chunk's dS_out to a float32 scratch buffer [B, H, n, dk, dk] (168 MB
// for rwkv6-3b at 4,096 tokens), and dS_in of the first chunk as ds0.
//
// `wkv6_bwd_chunk_kernel` (the chunk-parallel pass), one block of 256
// threads per (batch, chunk, head): the chunk's r, k, v, dO, log_w, S_in
// and dS_out staged in shared memory (rows padded to 65 floats, so a warp
// walking a row index hits 32 banks), the running sums, v·dO and A per
// pair, then dr, dk (a thread per 4 (token, channel) entries), dv (4
// (token, column) entries), and the log-decay suffix sums and u's partial
// sum per channel.  `wkv6_bwd_du_kernel` sums u's partials over batch and
// chunks in one fixed order.
#include "scan_mma.cuh"

namespace {

using scan::bf16;

constexpr int kChunk = 16;            // tokens per chunk
constexpr int kMaxK = 64;             // largest head size taken
constexpr int kR = kMaxK + 1;         // row stride of the staged tiles
constexpr int kP = kChunk + 1;        // row stride of pair tables
constexpr int kThreads = 256;
constexpr int kCols = 16;             // dS columns per reverse-pass block
constexpr unsigned kFull = 0xffffffffu;

// floats of the chunk pass's dynamic shared memory: r, k, v, dO, p, q,
// r∘dr', k∘dk', k_dec [16][kR]; S_in, dS_out [64][kR]; v·dO and A
// [16][kP]; u and Σ_v S_out∘dS_out [64]
constexpr int kSmemFloats =
    9 * kChunk * kR + 2 * kMaxK * kR + 2 * kChunk * kP + 2 * kMaxK;

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_state_kernel(const T* __restrict__ r,
                          const float* __restrict__ log_w,
                          const T* __restrict__ dout,
                          const float* __restrict__ dst,
                          float* __restrict__ dstates,
                          float* __restrict__ ds0, int s_len, int n_chunks,
                          int h, int dk) {
  const int tid = threadIdx.x, d = tid >> 2;
  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const int j = blockIdx.y * kCols + (tid & 3) * 4;  // 4 columns from j
  if (d >= dk || j >= dk) return;  // no barrier follows
  const int nj = min(4, dk - j);
  const int64_t step = static_cast<int64_t>(h) * dk;  // between tokens
  const int64_t base = static_cast<int64_t>(b) * s_len * step +
                       static_cast<int64_t>(head) * dk;
  const int64_t row = (static_cast<int64_t>(bh) * dk + d) * dk + j;
  float ds[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) ds[e] = (dst && e < nj) ? dst[row + e] : 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    float* out = dstates +
                 ((static_cast<int64_t>(bh) * n_chunks + c) * dk + d) * dk + j;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < nj) out[e] = ds[e];
    const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
    // the chunk's loads first, all in flight at once (a ragged chunk's
    // missing tokens read as zeros and add nothing)
    float lw[kChunk], rdec[kChunk], go[kChunk][4];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const bool in = t < nr;
      const int64_t off = base + (t0 + t) * step;
      lw[t] = in ? log_w[off + d] : 0.f;
      rdec[t] = in ? scan::to_f(r[off + d]) : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        go[t][e] = (in && e < nj) ? scan::to_f(dout[off + j + e]) : 0.f;
    }
    // r∘exp(q) per token, q the running sum before it, as the chunk pass
    // forms it
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      rdec[t] *= expf(acc);
      acc += lw[t];
    }
    const float el = expf(acc);
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[e] *= el;
#pragma unroll
    for (int t = 0; t < kChunk; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e] += rdec[t] * go[t][e];
  }
  if (ds0) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < nj) ds0[row + e] = ds[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ log_w,
                          const float* __restrict__ u,
                          const T* __restrict__ dout,
                          const float* __restrict__ states,
                          const float* __restrict__ s_t,
                          const float* __restrict__ dstates,
                          T* __restrict__ dr, T* __restrict__ dkk,
                          T* __restrict__ dv, float* __restrict__ dlog_w,
                          float* __restrict__ du_part, int s_len,
                          int n_chunks, int h, int dk) {
  extern __shared__ float sm[];
  float* rs = sm;                     // [16][kR] each, zero-padded
  float* ks = rs + kChunk * kR;
  float* vs = ks + kChunk * kR;
  float* os = vs + kChunk * kR;       // dO
  float* ps = os + kChunk * kR;       // log_w, then p (inclusive)
  float* qs = ps + kChunk * kR;       // q (exclusive)
  float* rdr = qs + kChunk * kR;      // r∘dr'
  float* kdk = rdr + kChunk * kR;     // k∘dk'
  float* kdec = kdk + kChunk * kR;    // k∘exp(p_last - p)
  float* s_in = kdec + kChunk * kR;    // S_in [64][kR]
  float* ds_out = s_in + kMaxK * kR;      // dS_out [64][kR]
  float* vd = ds_out + kMaxK * kR;       // v_s·dO_t at [t][s]
  float* am = vd + kChunk * kP;       // A[t][s], s <= t
  float* us = am + kChunk * kP;       // u
  float* sod = us + kMaxK;            // Σ_v S_out∘dS_out per channel

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / n_chunks, c = blockIdx.x % n_chunks;
  const int head = blockIdx.y;
  const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
  const int64_t step = static_cast<int64_t>(h) * dk;
  const int64_t base = (static_cast<int64_t>(b) * s_len + t0) * step +
                       static_cast<int64_t>(head) * dk;
  const int64_t bh = static_cast<int64_t>(b) * h + head;
  const int64_t mat = static_cast<int64_t>(dk) * dk;
  const float* s_in_g = states + (bh * n_chunks + c) * mat;
  const float* ds_out_g = dstates + (bh * n_chunks + c) * mat;
  const float* sout_g = c + 1 < n_chunks ? s_in_g + mat : s_t + bh * mat;

  for (int e = tid; e < kChunk * kMaxK; e += kThreads) {
    const int t = e / kMaxK, d = e % kMaxK;
    const bool in = t < nr && d < dk;
    const int64_t off = base + t * step + d;
    rs[t * kR + d] = in ? scan::to_f(r[off]) : 0.f;
    ks[t * kR + d] = in ? scan::to_f(k[off]) : 0.f;
    vs[t * kR + d] = in ? scan::to_f(v[off]) : 0.f;
    os[t * kR + d] = in ? scan::to_f(dout[off]) : 0.f;
    ps[t * kR + d] = in ? log_w[off] : 0.f;
  }
  for (int e = tid; e < kMaxK * kMaxK; e += kThreads) {
    const int d = e / kMaxK, j = e % kMaxK;
    const bool in = d < dk && j < dk;
    s_in[d * kR + j] = in ? s_in_g[d * dk + j] : 0.f;
    ds_out[d * kR + j] = in ? ds_out_g[d * dk + j] : 0.f;
  }
  if (tid < kMaxK) us[tid] = tid < dk ? u[head * dk + tid] : 0.f;
  for (int d = warp; d < kMaxK; d += kThreads / 32) {  // a row per warp
    float a = 0.f;
    if (d < dk)
      for (int j = lane; j < dk; j += 32)
        a += sout_g[d * dk + j] * ds_out_g[d * dk + j];
    a = warp_sum(a);
    if (lane == 0) sod[d] = a;
  }
  __syncthreads();
  if (tid < kMaxK) {  // the running sums of channel tid, in token order
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      qs[t * kR + tid] = acc;
      acc += ps[t * kR + tid];
      ps[t * kR + tid] = acc;
    }
  }
  __syncthreads();
  {  // v_s·dO_t and A[t][s] (strict pairs with the decay, the bonus
     // diagonal), a pair a thread
    const int t = tid / kChunk, s = tid % kChunk;
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < kMaxK; ++j) a += vs[s * kR + j] * os[t * kR + j];
    vd[t * kP + s] = a;
    float w = 0.f;
    if (s < t) {
#pragma unroll 8
      for (int d = 0; d < kMaxK; ++d)
        w += rs[t * kR + d] * ks[s * kR + d] *
             expf(qs[t * kR + d] - ps[s * kR + d]);
    } else if (s == t) {
#pragma unroll 8
      for (int d = 0; d < kMaxK; ++d)
        w += rs[t * kR + d] * us[d] * ks[t * kR + d];
    }
    am[t * kP + s] = w;
  }
  __syncthreads();

  // dr and dk at 4 (token, channel) entries a thread; the warp shares the
  // token, so S_in's and dS_out's rows are read across 32 banks
  {
    const int d = tid % kMaxK;
    const float pl = ps[(kChunk - 1) * kR + d];
#pragma unroll
    for (int i = 0; i < kChunk * kMaxK / kThreads; ++i) {
      const int t = tid / kMaxK + i * (kThreads / kMaxK);
      const float qt = qs[t * kR + d], pt = ps[t * kR + d];
      float sdo = 0.f, dsv = 0.f;
#pragma unroll 8
      for (int j = 0; j < kMaxK; ++j) {
        sdo += s_in[d * kR + j] * os[t * kR + j];
        dsv += ds_out[d * kR + j] * vs[t * kR + j];
      }
      float intra = 0.f;
      for (int s = 0; s < t; ++s)
        intra += expf(qt - ps[s * kR + d]) * ks[s * kR + d] * vd[t * kP + s];
      float intra2 = 0.f;
      for (int t2 = t + 1; t2 < kChunk; ++t2)
        intra2 +=
            expf(qs[t2 * kR + d] - pt) * rs[t2 * kR + d] * vd[t2 * kP + t];
      const float ekl = expf(pl - pt);
      const float drp = expf(qt) * sdo + intra;
      const float dkp = ekl * dsv + intra2;
      const float bonus = us[d] * vd[t * kP + t];
      rdr[t * kR + d] = rs[t * kR + d] * drp;
      kdk[t * kR + d] = ks[t * kR + d] * dkp;
      kdec[t * kR + d] = ks[t * kR + d] * ekl;
      if (t < nr && d < dk) {
        const int64_t off = base + t * step + d;
        dr[off] = scan::from_f<T>(drp + bonus * ks[t * kR + d]);
        dkk[off] = scan::from_f<T>(dkp + bonus * rs[t * kR + d]);
      }
    }
  }
  __syncthreads();

  {  // dv at 4 (token, column) entries a thread
    const int j = tid % kMaxK;
#pragma unroll
    for (int i = 0; i < kChunk * kMaxK / kThreads; ++i) {
      const int s = tid / kMaxK + i * (kThreads / kMaxK);
      float a = 0.f;
#pragma unroll 8
      for (int d = 0; d < kMaxK; ++d) a += kdec[s * kR + d] * ds_out[d * kR + j];
      for (int t = s; t < kChunk; ++t) a += am[t * kP + s] * os[t * kR + j];
      if (s < nr && j < dk) dv[base + s * step + j] = scan::from_f<T>(a);
    }
  }
  if (tid < dk) {  // dlog_w by suffix sums in token order, u's partial
    const int d = tid;
    float sr = 0.f, sk = 0.f;   // Σ_{t>τ} r∘dr', Σ_{s>=τ} k∘dk'
    for (int tau = kChunk - 1; tau >= 0; --tau) {
      sk += kdk[tau * kR + d];
      if (tau < nr) dlog_w[base + tau * step + d] = (sr - sk) + sod[d];
      sr += rdr[tau * kR + d];
    }
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kChunk; ++t)
      acc += rs[t * kR + d] * ks[t * kR + d] * vd[t * kP + t];
    du_part[((static_cast<int64_t>(b) * n_chunks + c) * h + head) * dk + d] =
        acc;
  }
}

// du[h][d] = Σ over (batch, chunk) of the partials, in that order
__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_du_kernel(const float* __restrict__ du_part,
                       float* __restrict__ du, int n_part, int hdk) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= hdk) return;
  float a = 0.f;
  for (int i = 0; i < n_part; ++i) a += du_part[static_cast<int64_t>(i) * hdk + e];
  du[e] = a;
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* log_w, const void* u, const void* dout,
                   const void* states, const void* s_t, const void* dst,
                   void* dstates, void* du_part, void* dr, void* dkk,
                   void* dv, void* dlog_w, void* du, void* ds0, int b,
                   int s_len, int h, int dk, cudaStream_t stream) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  wkv6_bwd_state_kernel<T><<<dim3(b * h, (dk + kCols - 1) / kCols), kThreads,
                             0, stream>>>(
      static_cast<const T*>(r), static_cast<const float*>(log_w),
      static_cast<const T*>(dout), static_cast<const float*>(dst),
      static_cast<float*>(dstates), static_cast<float*>(ds0), s_len,
      n_chunks, h, dk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n_chunks > 0) {
    static bool raised[64] = {};
    constexpr int kBytes = kSmemFloats * 4;
    err = scan::raise_smem(wkv6_bwd_chunk_kernel<T>, kBytes, raised);
    if (err != cudaSuccess) return err;
    wkv6_bwd_chunk_kernel<T><<<dim3(b * n_chunks, h), kThreads, kBytes,
                               stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(log_w),
        static_cast<const float*>(u), static_cast<const T*>(dout),
        static_cast<const float*>(states), static_cast<const float*>(s_t),
        static_cast<const float*>(dstates), static_cast<T*>(dr),
        static_cast<T*>(dkk), static_cast<T*>(dv),
        static_cast<float*>(dlog_w), static_cast<float*>(du_part), s_len,
        n_chunks, h, dk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int hdk = h * dk;
  wkv6_bwd_du_kernel<<<(hdk + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(static_cast<const float*>(du_part),
                                 static_cast<float*>(du), b * n_chunks, hdk);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, dout, dr, dk, dv [b, s_len, h, dk] (all float32: is_bf16 = 0,
// or all bf16: is_bf16 = 1), log_w and dlog_w [b, s_len, h, dk], u and du
// [h, dk], states [b, h, n_chunks, dk, dk] (the forward's, `wkv6_launch`),
// s_t, dst (or null: zeros) and ds0 (or null: not wanted) [b, h, dk, dk],
// all float32; scratch dstates [b, h, n_chunks, dk, dk] and du_part
// [b, n_chunks, h, dk] float32: contiguous, on the device; 0 < dk <= 64.
// Three launches on `stream`; returns the first failing cudaGetLastError().
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* log_w, const void* u,
                               const void* dout, const void* states,
                               const void* s_t, const void* dst,
                               void* dstates, void* du_part, void* dr,
                               void* dkk, void* dv, void* dlog_w, void* du,
                               void* ds0, int b, int s_len, int h, int dk,
                               int is_bf16, void* stream) {
  if (dk <= 0 || dk > kMaxK || s_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<bf16>(r, k, v, log_w, u, dout, states, s_t, dst,
                             dstates, du_part, dr, dkk, dv, dlog_w, du, ds0,
                             b, s_len, h, dk, st)
              : launch<float>(r, k, v, log_w, u, dout, states, s_t, dst,
                              dstates, du_part, dr, dkk, dv, dlog_w, du, ds0,
                              b, s_len, h, dk, st);
  return static_cast<int>(err);
}
