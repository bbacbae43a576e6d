// The gradient of the Mamba-2 SSD chunked scan, in chunks of 16 tokens.
//
// Replaces: no Pallas kernel.  The reference trains its Mamba-2 layers by
// differentiating `models/ssm.py::ssd_chunked` under `jax.value_and_grad`
// (its Pallas kernel `kernels/ssd.py::ssd` has no backward); this is that
// gradient on the card.  Per head the forward is
//   S_t = a_t S_{t-1} + dt_t (x_t outer B_t),  y_t = S_t C_t + D x_t,
// a_t = exp(la_t), la_t = -exp(a_log)·dt_t, B and C shared by the heads.
// Given dY and the final state's gradient dsT (a null pointer: zeros), it
// returns dx, dB, dC (x's dtype), ddt, da_log, dD and, when asked, ds0
// (float32), from the forward's saved incoming state of every chunk
// (`ssd.cu`, `states`) and its final state.
//
// Per chunk of 16 tokens and head, with p the inclusive running sum of la
// (summed serially; every exponent p_t - p_s, s <= t, is clamped at 0 as
// in the forward), E[t][s] = exp(p_t - p_s) and G[t][s] = (C_t·B_s)·E[t][s]
// for s <= t, w_s = exp(p_last - p_s), S_in the chunk's incoming state and
// dS_out the gradient of its outgoing one:
//   dx_s  = dt_s·(Σ_{t>=s} G[t][s] dY_t + w_s·dS_out B_s) + D·dY_s
//   dC_t  = Σ_{s<=t} E[t][s] dt_s (x_s·dY_t) B_s + exp(p_t)·S_inᵀ dY_t
//   dB_s  = dt_s·(Σ_{t>=s} E[t][s] (x_s·dY_t) C_t + w_s·dS_outᵀ x_s)
//   ddt_s = Σ_{t>=s} G[t][s] (x_s·dY_t) + w_s·x_sᵀ dS_out B_s
//           - exp(a_log)·dla_s
//   dD    = Σ_t x_t·dY_t,  da_log = Σ_s dla_s·la_s
//   dS_in = exp(p_last)·dS_out + Σ_t exp(p_t)·dY_t C_tᵀ,
// dB and dC summed over the heads.  The log-decay gradient
// dla_τ = a_τ·Σ S_{τ-1}∘dS_τ is formed without a state per token, as the
// four kinds of term that expand it, each a product of decays through τ:
//   dla_τ = Σ_{t>=τ, s<τ} dt_s G[t][s] (x_s·dY_t)
//         + Σ_{t>=τ} exp(p_t)·C_t·S_inᵀ dY_t + exp(p_last)·Σ S_in∘dS_out
//         + Σ_{s<τ} w_s dt_s·x_sᵀ dS_out B_s.
// The identity Σ_{t>=τ} C_t·dC_t^h - Σ_{s>=τ} B_s·dB_s^h + Σ S_out∘dS_out
// gives the same value as a difference of sums, which at strong decays
// (la_τ ~ -40) cancels to noise that da_log = Σ dla·la multiplies: its
// replay missed the 1e-4 gate there (test_torch_scan_bwd.py), the
// expansion meets it.
//
// Bound on an H100: per call it reads x, dY (2 or 4 bytes), B and C once,
// dt and the saved states (4 bytes; hd·ds floats per chunk and head) and
// writes dx, dB, dC, ddt: ~0.8 GB for zamba2-7b at 4,096 tokens (112 heads
// of 64, ds 64, bf16; the states 0.47 GB of it), ~0.25 ms at 3.35 TB/s;
// its float32 work (three 16·64·64 products per chunk and head) ~19 GFLOP,
// ~0.28 ms at 67 TFLOP/s on the CUDA cores.  It runs far above that
// bound (PERF.md §6, row 6b): the reverse pass's serial walk and the chunk
// pass's shared-memory products take about half the call each.
//
// Design: four launches per call, every sum in one fixed order (two runs
// give the same bits), every product in float32 on the CUDA cores (bf16
// enters as inputs, exact in float32, and leaves as the rounded dx, dB,
// dC).
//
// `ssd_bwd_state_kernel` (the reverse pass), one block of 256 threads per
// (batch·head, 16 state rows): the serial walk from the last chunk to the
// first.  dS's rows are independent, so each thread keeps 4 entries of one
// column in registers and forms its own running sums of la: no shared
// memory and no barrier; a chunk's loads are all issued before its serial
// sums, as in `wkv6_bwd.cu`.  It writes each chunk's dS_out to a float32
// scratch buffer [B, H, n, hd, ds] (470 MB for zamba2-7b at 4,096 tokens),
// and dS_in of the first chunk as ds0.
//
// `ssd_bwd_chunk_kernel` (the chunk-parallel pass), one block of 256
// threads per (batch, chunk, 8 heads): C, B and C·Bᵀ once for the block,
// then per head, in head order, x, dY, S_in and dS_out staged in shared
// memory (rows padded by one float, so a warp walking a row index hits 32
// banks), the running sums, E, G and x·dY per pair, dx, the head's dB^h and
// dC^h, the per-token dots and the log-decay sums.  Each
// thread owns the same 4 (token, state column) entries of dB and dC for
// every head, so their sums over the block's heads run in head order;
// the blocks' sums go to a scratch buffer [B, S, groups, ds] that
// `ssd_bwd_sum_kernel` adds up in group order, and D's and a_log's
// per-chunk partials likewise (`ssd_bwd_head_kernel`).
#include "scan_mma.cuh"

namespace {

using scan::bf16;

constexpr int kChunk = 16;            // tokens per chunk
constexpr int kMaxN = 64;             // largest state size ds taken
constexpr int kMaxHd = 256;           // largest head size hd taken
constexpr int kR = kMaxN + 1;         // row stride of C, B, dB^h, dC^h
constexpr int kP = kChunk + 1;        // row stride of pair tables
constexpr int kThreads = 256;
constexpr int kHeads = 8;             // heads per chunk-pass block
constexpr int kRows = 16;             // dS rows per reverse-pass block
constexpr int kEntries = kChunk * kMaxN / kThreads;   // of dB / dC a thread
constexpr unsigned kFull = 0xffffffffu;

// floats of the chunk pass's dynamic shared memory for head size hd
__host__ __device__ inline int smem_floats(int hd) {
  const int hr = hd + 1;
  return 3 * kChunk * kR +            // C, B, S_inᵀ dY
         3 * kChunk * hr +            // x, dY, dS_out·B
         2 * hd * kR +                // S_in, dS_out
         4 * kChunk * kP +            // C·Bᵀ, E, G, x·dY
         9 * kChunk + kThreads / 32 + 1;  // coefficients, the sums
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_state_kernel(const T* __restrict__ cm,
                         const float* __restrict__ dt,
                         const float* __restrict__ a_log,
                         const T* __restrict__ dy,
                         const float* __restrict__ dst,
                         float* __restrict__ dstates,
                         float* __restrict__ ds0, int s_len, int n_chunks,
                         int h, int hd, int ds) {
  const int tid = threadIdx.x, n = tid % kMaxN;
  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const int i = blockIdx.y * kRows + (tid / kMaxN) * 4;  // 4 rows from i
  if (n >= ds || i >= hd) return;  // no barrier follows
  const int ni = min(4, hd - i);
  const float a = expf(a_log[head]);
  const int64_t xp = static_cast<int64_t>(h) * hd;       // dY between tokens
  float dss[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    dss[e] = (dst && e < ni)
                 ? dst[(static_cast<int64_t>(bh) * hd + i + e) * ds + n]
                 : 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    float* out = dstates +
                 ((static_cast<int64_t>(bh) * n_chunks + c) * hd + i) * ds + n;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < ni) out[e * ds] = dss[e];
    const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
    const int64_t row0 = static_cast<int64_t>(b) * s_len + t0;
    // the chunk's loads first, all in flight at once (a ragged chunk's
    // missing tokens read as zeros and add nothing)
    float dtv[kChunk], ec[kChunk], gy[kChunk][4];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const bool in = t < nr;
      dtv[t] = in ? dt[(row0 + t) * h + head] : 0.f;
      ec[t] = in ? scan::to_f(cm[(row0 + t) * ds + n]) : 0.f;
      const T* g = dy + (row0 + t) * xp + static_cast<int64_t>(head) * hd + i;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gy[t][e] = (in && e < ni) ? scan::to_f(g[e]) : 0.f;
    }
    // exp(p_t)·C_t, p the running sum of la as the chunk pass forms it
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      acc += -a * dtv[t];
      ec[t] *= expf(acc);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dss[e] *= expf(acc);
#pragma unroll
    for (int t = 0; t < kChunk; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dss[e] += ec[t] * gy[t][e];
  }
  if (ds0) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < ni) ds0[(static_cast<int64_t>(bh) * hd + i + e) * ds + n] = dss[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                         const T* __restrict__ cm,
                         const float* __restrict__ dt,
                         const float* __restrict__ a_log,
                         const float* __restrict__ d_skip,
                         const T* __restrict__ dy,
                         const float* __restrict__ states,
                         const float* __restrict__ dstates,
                         T* __restrict__ dx, float* __restrict__ ddt,
                         float* __restrict__ db_part,
                         float* __restrict__ dc_part,
                         float* __restrict__ dd_part,
                         float* __restrict__ da_part, int s_len,
                         int n_chunks, int h, int hd, int ds) {
  extern __shared__ float sm[];
  const int hr = hd + 1;
  float* cs = sm;                      // C [16][kR], zero-padded
  float* bs = cs + kChunk * kR;        // B
  float* sdy = bs + kChunk * kR;       // S_inᵀ dY_t at [t][n]
  float* xs = sdy + kChunk * kR;       // x [16][hr]
  float* ys = xs + kChunk * hr;        // dY
  float* sb = ys + kChunk * hr;        // dS_out·B_s [16][hr]
  float* s_in = sb + kChunk * hr;      // S_in [hd][kR]
  float* ds_out = s_in + hd * kR;      // dS_out [hd][kR]
  float* cb = ds_out + hd * kR;        // C_t·B_s at [t][s]
  float* em = cb + kChunk * kP;        // E[t][s], s <= t
  float* gm = em + kChunk * kP;        // G[t][s]
  float* xd = gm + kChunk * kP;        // x_s·dY_t at [t][s]
  float* dts = xd + kChunk * kP;       // dt
  float* las = dts + kChunk;           // la
  float* ps = las + kChunk;            // p
  float* ep = ps + kChunk;             // exp(p)
  float* wl = ep + kChunk;             // exp(p_last - p)
  float* csd = wl + kChunk;            // C_t·S_inᵀ dY_t
  float* xsb = csd + kChunk;           // x_s·dS_out B_s
  float* rect = xsb + kChunk;          // Σ_{t>=τ, s<τ} of the pair terms
  float* dir = rect + kChunk;          // ddt's direct term
  float* red = dir + kChunk;           // the warps' partial sums, total

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / n_chunks, c = blockIdx.x % n_chunks;
  const int group = blockIdx.y, n_groups = gridDim.y;
  const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
  const int64_t row0 = static_cast<int64_t>(b) * s_len + t0;
  const int64_t xp = static_cast<int64_t>(h) * hd;   // x between tokens
  const int64_t mat = static_cast<int64_t>(hd) * ds;

  for (int e = tid; e < kChunk * kMaxN; e += kThreads) {
    const int t = e / kMaxN, n = e % kMaxN;
    const bool in = t < nr && n < ds;
    cs[t * kR + n] = in ? scan::to_f(cm[(row0 + t) * ds + n]) : 0.f;
    bs[t * kR + n] = in ? scan::to_f(bm[(row0 + t) * ds + n]) : 0.f;
  }
  __syncthreads();
  {  // C_t·B_s, a pair a thread
    const int t = tid / kChunk, s = tid % kChunk;
    float a = 0.f;
#pragma unroll 8
    for (int n = 0; n < kMaxN; ++n) a += cs[t * kR + n] * bs[s * kR + n];
    cb[t * kP + s] = a;
  }
  float db_acc[kEntries] = {}, dc_acc[kEntries] = {};

  for (int hh = 0; hh < kHeads; ++hh) {
    const int head = group * kHeads + hh;
    if (head >= h) break;  // uniform over the block
    const int64_t bh = static_cast<int64_t>(b) * h + head;
    const float* s_in_g = states + (bh * n_chunks + c) * mat;
    const float* ds_out_g = dstates + (bh * n_chunks + c) * mat;
    const int64_t xbase = row0 * xp + static_cast<int64_t>(head) * hd;
    const float a = expf(a_log[head]), dsk = d_skip[head];
    __syncthreads();  // the previous head's readers are done
    for (int e = tid; e < kChunk * hd; e += kThreads) {
      const int t = e / hd, i = e % hd;
      const bool in = t < nr;
      xs[t * hr + i] = in ? scan::to_f(x[xbase + t * xp + i]) : 0.f;
      ys[t * hr + i] = in ? scan::to_f(dy[xbase + t * xp + i]) : 0.f;
    }
    float so = 0.f;  // Σ S_in∘dS_out, this thread's share
    for (int e = tid; e < hd * kMaxN; e += kThreads) {
      const int i = e / kMaxN, n = e % kMaxN;
      const bool in = n < ds;
      const float sv = in ? s_in_g[i * ds + n] : 0.f;
      const float dv = in ? ds_out_g[i * ds + n] : 0.f;
      s_in[i * kR + n] = sv;
      ds_out[i * kR + n] = dv;
      so += sv * dv;
    }
    so = warp_sum(so);
    if (lane == 0) red[warp] = so;
    if (tid < kChunk) dts[tid] = tid < nr ? dt[(row0 + tid) * h + head] : 0.f;
    __syncthreads();
    if (tid == 0) {  // the running sums of la, in token order
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        las[t] = -a * dts[t];
        acc += las[t];
        ps[t] = acc;
      }
      float sum = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) sum += red[w];
      red[kThreads / 32] = sum;
    }
    __syncthreads();
    if (tid < kChunk) {
      ep[tid] = expf(ps[tid]);
      wl[tid] = expf(fminf(ps[kChunk - 1] - ps[tid], 0.f));
    }
    {  // E, G and x·dY, a pair a thread
      const int t = tid / kChunk, s = tid % kChunk;
      const float ev = s <= t ? expf(fminf(ps[t] - ps[s], 0.f)) : 0.f;
      em[t * kP + s] = ev;
      gm[t * kP + s] = cb[t * kP + s] * ev;
      float a2 = 0.f;
      for (int i = 0; i < hd; ++i) a2 += xs[s * hr + i] * ys[t * hr + i];
      xd[t * kP + s] = a2;
    }
    __syncthreads();
    // dx, with dS_out·B_s kept for ddt
    for (int e = tid; e < kChunk * hd; e += kThreads) {
      const int s = e / hd, i = e % hd;
      float sbv = 0.f;
#pragma unroll 8
      for (int n = 0; n < kMaxN; ++n) sbv += ds_out[i * kR + n] * bs[s * kR + n];
      sb[s * hr + i] = sbv;
      float intra = 0.f;
      for (int t = s; t < kChunk; ++t) intra += gm[t * kP + s] * ys[t * hr + i];
      if (s < nr)
        dx[xbase + s * xp + i] = scan::from_f<T>(
            dts[s] * (intra + wl[s] * sbv) + dsk * ys[s * hr + i]);
    }
    // the head's dC^h and dB^h at this thread's 4 (token, column) entries
#pragma unroll
    for (int k = 0; k < kEntries; ++k) {
      const int e = tid + k * kThreads, t = e / kMaxN, n = e % kMaxN;
      float sdy_v = 0.f, dsx = 0.f;
      for (int i = 0; i < hd; ++i) {
        sdy_v += s_in[i * kR + n] * ys[t * hr + i];
        dsx += ds_out[i * kR + n] * xs[t * hr + i];
      }
      float intra = 0.f;
      for (int s = 0; s <= t; ++s)
        intra += em[t * kP + s] * dts[s] * xd[t * kP + s] * bs[s * kR + n];
      float intra2 = 0.f;
      for (int t2 = t; t2 < kChunk; ++t2)
        intra2 += em[t2 * kP + t] * xd[t2 * kP + t] * cs[t2 * kR + n];
      const float dcv = intra + ep[t] * sdy_v;
      const float dbv = dts[t] * (intra2 + wl[t] * dsx);
      sdy[t * kR + n] = sdy_v;
      dc_acc[k] += dcv;
      db_acc[k] += dbv;
    }
    __syncthreads();
    for (int t = warp; t < kChunk; t += kThreads / 32) {  // a token a warp
      float xv = 0.f, cv = 0.f;
      for (int i = lane; i < hd; i += 32) xv += xs[t * hr + i] * sb[t * hr + i];
      for (int n = lane; n < kMaxN; n += 32)
        cv += cs[t * kR + n] * sdy[t * kR + n];
      xv = warp_sum(xv);
      cv = warp_sum(cv);
      if (lane == 0) {
        float direct = wl[t] * xv;
        for (int t2 = t; t2 < kChunk; ++t2)
          direct += gm[t2 * kP + t] * xd[t2 * kP + t];
        dir[t] = direct;
        xsb[t] = xv;
        csd[t] = cv;
      }
    }
    if (tid < kChunk) {  // the pair terms with s < τ <= t, τ = tid
      const int tau = tid;
      float acc = 0.f;
      for (int t = tau; t < kChunk; ++t)
        for (int s = 0; s < tau; ++s)
          acc += dts[s] * gm[t * kP + s] * xd[t * kP + s];
      rect[tau] = acc;
    }
    __syncthreads();
    if (tid == 0) {  // dla in token order; ddt, the partials
      const float inner = ep[kChunk - 1] * red[kThreads / 32];
      float pre[kChunk], acc = 0.f;   // Σ_{s<τ} w_s dt_s x_sᵀ dS_out B_s
      for (int tau = 0; tau < kChunk; ++tau) {
        pre[tau] = acc;
        acc += wl[tau] * dts[tau] * xsb[tau];
      }
      float suf = 0.f, da = 0.f, dd = 0.f;   // Σ_{t>=τ} exp(p_t) C·S_inᵀdY
      for (int tau = kChunk - 1; tau >= 0; --tau) {
        suf += ep[tau] * csd[tau];
        const float dla = rect[tau] + suf + inner + pre[tau];
        if (tau < nr) ddt[(row0 + tau) * h + head] = dir[tau] - a * dla;
        da += dla * las[tau];
      }
      for (int t = 0; t < kChunk; ++t) dd += xd[t * kP + t];
      const int64_t at = (static_cast<int64_t>(b) * n_chunks + c) * h + head;
      dd_part[at] = dd;
      da_part[at] = da;
    }
  }
  // this block's sums of dB^h and dC^h over its heads
#pragma unroll
  for (int k = 0; k < kEntries; ++k) {
    const int e = tid + k * kThreads, t = e / kMaxN, n = e % kMaxN;
    if (t < nr && n < ds) {
      const int64_t at = ((row0 + t) * n_groups + group) * ds + n;
      db_part[at] = db_acc[k];
      dc_part[at] = dc_acc[k];
    }
  }
}

// dB and dC [rows, ds] in x's dtype: the head groups' sums in group order
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_sum_kernel(const float* __restrict__ db_part,
                       const float* __restrict__ dc_part, T* __restrict__ db,
                       T* __restrict__ dc, int64_t n_out, int n_groups,
                       int ds) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_out) return;
  const int64_t row = e / ds, n = e % ds;
  float sb = 0.f, sc = 0.f;
  for (int g = 0; g < n_groups; ++g) {
    sb += db_part[(row * n_groups + g) * ds + n];
    sc += dc_part[(row * n_groups + g) * ds + n];
  }
  db[e] = scan::from_f<T>(sb);
  dc[e] = scan::from_f<T>(sc);
}

// dD and da_log [h]: the (batch, chunk) partials summed in that order
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_head_kernel(const float* __restrict__ dd_part,
                        const float* __restrict__ da_part,
                        float* __restrict__ dd, float* __restrict__ da,
                        int n_part, int h) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= h) return;
  float sd = 0.f, sa = 0.f;
  for (int i = 0; i < n_part; ++i) {
    sd += dd_part[static_cast<int64_t>(i) * h + e];
    sa += da_part[static_cast<int64_t>(i) * h + e];
  }
  dd[e] = sd;
  da[e] = sa;
}

template <typename T>
cudaError_t launch(const void* x, const void* bm, const void* cm,
                   const void* dt, const void* a_log, const void* d_skip,
                   const void* dy, const void* states, const void* dst,
                   void* dstates, void* db_part, void* dc_part,
                   void* dd_part, void* da_part, void* dx,
                   void* db, void* dc, void* ddt, void* da_log, void* dd,
                   void* ds0, int b, int s_len, int h, int hd, int ds,
                   cudaStream_t stream) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int n_groups = (h + kHeads - 1) / kHeads;
  ssd_bwd_state_kernel<T><<<dim3(b * h, (hd + kRows - 1) / kRows), kThreads,
                            0, stream>>>(
      static_cast<const T*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(dy),
      static_cast<const float*>(dst), static_cast<float*>(dstates),
      static_cast<float*>(ds0), s_len, n_chunks, h, hd, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n_chunks > 0) {
    const int bytes = smem_floats(hd) * 4;
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    ssd_bwd_chunk_kernel<T><<<dim3(b * n_chunks, n_groups), kThreads, bytes,
                              stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(bm),
        static_cast<const T*>(cm), static_cast<const float*>(dt),
        static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
        static_cast<const T*>(dy), static_cast<const float*>(states),
        static_cast<const float*>(dstates), static_cast<T*>(dx),
        static_cast<float*>(ddt),
        static_cast<float*>(db_part), static_cast<float*>(dc_part),
        static_cast<float*>(dd_part), static_cast<float*>(da_part), s_len,
        n_chunks, h, hd, ds);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t n_out = static_cast<int64_t>(b) * s_len * ds;
    ssd_bwd_sum_kernel<T><<<static_cast<unsigned>(
                                (n_out + kThreads - 1) / kThreads),
                            kThreads, 0, stream>>>(
        static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
        static_cast<T*>(db), static_cast<T*>(dc), n_out, n_groups, ds);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ssd_bwd_head_kernel<<<(h + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(
      static_cast<const float*>(dd_part), static_cast<const float*>(da_part),
      static_cast<float*>(dd), static_cast<float*>(da_log), b * n_chunks, h);
  return cudaGetLastError();
}

}  // namespace

// Head groups of the chunk pass: the partials of dB / dC per row.
extern "C" int ssd_bwd_groups(int h) { return (h + kHeads - 1) / kHeads; }

// x, dy, dx [b, s_len, h, hd] and bm, cm, db, dc [b, s_len, ds] (all
// float32: is_bf16 = 0, or all bf16: is_bf16 = 1), dt and ddt [b, s_len,
// h], a_log, d_skip, da_log, dd [h], states [b, h, n_chunks, hd, ds] (the
// forward's, `ssd_launch`), dst (or null: zeros) and ds0 (or null:
// not wanted) [b, h, hd, ds], all float32; scratch dstates [b, h,
// n_chunks, hd, ds], db_part and dc_part [b, s_len, ssd_bwd_groups(h),
// ds], dd_part and da_part [b, n_chunks, h] float32: contiguous, on the
// device; 0 < ds <= 64, 0 < hd <= 256.  Four launches on `stream`;
// returns the first failing cudaGetLastError().
extern "C" int ssd_bwd_launch(const void* x, const void* bm, const void* cm,
                              const void* dt, const void* a_log,
                              const void* d_skip, const void* dy,
                              const void* states, const void* dst,
                              void* dstates, void* db_part, void* dc_part,
                              void* dd_part, void* da_part,
                              void* dx, void* db, void* dc, void* ddt,
                              void* da_log, void* dd, void* ds0, int b,
                              int s_len, int h, int hd, int ds, int is_bf16,
                              void* stream) {
  if (ds <= 0 || ds > kMaxN || hd <= 0 || hd > kMaxHd || s_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<bf16>(x, bm, cm, dt, a_log, d_skip, dy, states, dst,
                             dstates, db_part, dc_part, dd_part, da_part, dx,
                             db, dc, ddt, da_log, dd, ds0, b, s_len, h, hd,
                             ds, st)
              : launch<float>(x, bm, cm, dt, a_log, d_skip, dy, states, dst,
                              dstates, db_part, dc_part, dd_part, da_part, dx,
                              db, dc, ddt, da_log, dd, ds0, b, s_len, h, hd,
                              ds, st);
  return static_cast<int>(err);
}
