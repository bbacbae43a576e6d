// The gradient of the RWKV-6 (WKV6) chunked recurrence, in chunks of 16.
//
// Replaces: no Pallas kernel.  The reference trains its RWKV-6 models by
// differentiating `models/ssm.py::wkv6_chunked` under `jax.value_and_grad`
// (its Pallas kernel `kernels/wkv6.py::wkv6` has no backward); this is
// that gradient on the card.  Per head the forward is
//   o_t = r_t @ (S_{t-1} + (u*k_t)^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t
// with w_t = exp(log_w_t).  Given dO and the final state's gradient dsT
// (a null pointer: zeros), it returns dr, dk, dv (r's dtype), dlog_w,
// du and, when asked, ds0 (float32), from the forward's kept incoming
// states (`wkv6.cu`, `states`): every chunk's, or every 16th chunk's, the
// checkpoints of the reference's `chunk_scan_checkpointed`.
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
// sums stay inside the chunk, and Σ_v S_out∘dS_out is formed from S_in as
// exp(p_last)·Σ_v S_in∘dS_out + Σ_s k_dec,s∘(dS_out v_s), S_out being
// diag(exp(p_last))·S_in + k_decᵀ·v: the next chunk's state is not read.
//
// Bound on an H100: per call it reads r, k, v, dO (2 or 4 bytes), log_w
// and the saved states (4 bytes; dk·dk floats per chunk and head) and
// writes dr, dk, dv, dlog_w: ~0.4 GB for rwkv6-3b at 4,096 tokens (40 heads
// of 64, bf16), ~0.12 ms at 3.35 TB/s.  The design adds the float32
// dS_out scratch (written by the reverse pass, read by the chunk pass:
// another 0.34 GB of traffic).  On an H100 80GB HBM3 at 700 W
// (tools/scan_bwd_probe.py, bf16, 1 x 4,096 tokens) the reverse pass took
// 0.3679 ms (1.44 µs a chunk, 40 blocks: its barrier, building r_dec from
// the channels' running sums, two dependent `mma` rounds) and the chunk
// pass 0.59 ms, of which the CUDA-core pair sums of dr and dk took ~0.14
// and A ~0.05 (timed by leaving each out); the first version took 2.6509
// and 0.9431 (PERF.md, row 5b).
//
// Design: two launches per run of chunks and one for u's sum, every sum in
// one fixed order (two runs give the same bits), every product on the
// tensor cores (`mma.sync` through `scan_mma.cuh`), no atomics.  From
// every state the run is the whole sequence.  From the checkpoints one C
// call (`wkv6_bwd_ckpt_launch`) issues the plan of `kernels/wkv6.py::
// checkpoint_plan` (`scan_ckpt.cuh`), per segment of 16 chunks from the
// last: the state-only recompute of its 16 incoming states from its
// checkpoint (`wkv6_fwd.cuh`: pass A writes only k_dec and exp(p_last),
// pass B only updates the state) on one side stream, beside its reverse
// pass on another (the reverse pass reads no state: it walks the segment
// from the dS the later segment handed down, dst for the last, and hands
// its own down, ds0 for the first); then its chunk pass, on the caller's
// stream or a third (even / odd segments), under which the earlier
// segment's recompute and reverse pass run.  The states and dS go to two
// buffers each, segment g's in g % 2, which segment g - 2 rewrites only
// once segment g's chunk pass is done (an event).  The float32 state and
// dS scratch is two segments' of each (42 MB for rwkv6-3b at 4,096
// tokens, batch 1, against 168 MB of dS from every state), in one
// workspace a call with the recompute's scratch and u's partials; the
// recompute repeats the forward's arithmetic on the same values, the
// reverse pass carries dS through memory exactly, and u's partials are
// summed once in (batch, chunk) order, so the result is the whole-state
// backward's bits whatever the streams' timing.  Of the two ways to run
// the walks beside the chunk passes, side streams ordered by events and
// one persistent launch whose blocks take roles ordered by flags, the
// streams were chosen: the kernels stay as they are, the block scheduler
// fills the SMs the walks leave, and nothing spins.  The intra-chunk sums
// whose decay is per channel (A and the pair terms of dr and dk: an exp
// per token pair and channel) are not products; they run on the CUDA
// cores, as in the forward's pass A.
//
// `wkv6_bwd_reverse_kernel` (the reverse pass), shaped as the forward's
// pass B (`wkv6_fwd.cuh::wkv6_state_kernel`) walking the chunks from the last:
// one block of 16 warps per batch·head, each warp a 16 x 16 piece of dSᵀ
// (16 columns by 16 channels) in `mma` accumulator fragments.  Per chunk
// it stores dS_out to a float32 scratch [B, H, n_run, dk, dk] (168 MB for
// rwkv6-3b at 4,096 tokens from every state, 10.5 MB for a segment) and
// updates dSᵀ = dSᵀ·diag(exp(p_last)) +
// dOᵀ·r_dec on `mma`, r_dec = r∘exp(q) built by each lane for its fragment
// from its channels' running sums; r, log_w and dO are staged by
// `cp.async` into a ring of shared stages three chunks ahead, each thread
// with one fixed copy slot.  dS of the first chunk goes out as ds0.
//
// `wkv6_bwd_intra_kernel` (the chunk-parallel pass), one block of 4 warps
// per (batch, chunk, head): the chunk's inputs, S_in and dS_out staged in
// shared memory; the running sums a thread per channel (times log2 e, for
// exp2f); v·dOᵀ on `mma`; on the CUDA cores A (a strict pair a thread)
// and the pair terms of dr and dk (a thread per channel and token parity:
// one exp per pair feeds both); then each warp, for 16 channels, dO·S_inᵀ
// and v·dS_outᵀ on `mma`, added to the pair terms in the fragment layout
// (dr and dk written at once), and for 16 columns of v, k_dec·dS_out and
// Aᵀ·dO on `mma` (dv); last the log-decay suffix sums and u's partial sum
// a thread per channel.
// `wkv6_bwd_du_kernel` sums u's partials over batch and chunks in one
// fixed order.
//
// Precision (scan_mma.cuh): in the bf16 instance v and dO enter the `mma`s
// exactly; the states, dS and every computed operand (r_dec, k_dec, A) are
// split into two bf16 parts.  The float32 instance splits every operand
// into three.  A head size that is not a multiple of 8, or float32 inputs,
// is staged element by element.
#include "scan_ckpt.cuh"
#include "scan_mma.cuh"
#include "wkv6_fwd.cuh"

namespace {

using scan::bf16;
using scan::Parts;

constexpr int kChunk = 16;            // tokens per chunk
constexpr int kSegment = 16;          // chunks between two checkpoints
constexpr int kMaxK = 64;             // largest head size taken
constexpr int kNS = kMaxK + 8;        // bf16 row stride of plane tiles
constexpr int kFS = kMaxK + 4;        // float row stride of float tiles
constexpr int kPlane = kChunk * kNS;  // elements of one bf16 plane
constexpr int kRevWarps = 16;         // reverse pass: 4 x 4 pieces
constexpr int kWarps = 4;             // chunk pass
constexpr int kThreads = kWarps * 32;
constexpr int kPairs = kChunk * (kChunk + 1) / 2;   // s <= t
constexpr int kStrict = kChunk * (kChunk - 1) / 2;  // s < t
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
  return a;
}

// the reverse pass's dynamic shared memory: kStages stages of the r and
// dO planes and log_w [16][kFS]
template <typename T>
struct RevSmem {
  static constexpr int kStages = 4;
  static constexpr int kAhead = kStages - 1;
  static constexpr int kPlanes = Parts<T>::kIn * kPlane * 2;   // bytes
  static constexpr int kStageBytes = 2 * kPlanes + kChunk * kFS * 4;
  static constexpr int kBytes = kStages * kStageBytes;
};

template <typename T>
__global__ void __launch_bounds__(kRevWarps * 32, 1)
    wkv6_bwd_reverse_kernel(const T* __restrict__ r,
                            const float* __restrict__ log_w,
                            const T* __restrict__ dout,
                            const float* __restrict__ dst,
                            float* __restrict__ dstates,
                            float* __restrict__ ds0, int s_len, int c0,
                            int n_run, int h, int dk, int vec) {
  constexpr int NI = Parts<T>::kIn, NC = Parts<T>::kCalc;
  using L = RevSmem<T>;
  constexpr int kStages = L::kStages, kAhead = L::kAhead;
  constexpr int kThr = kRevWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  // stage st: r planes, dO planes, log_w
  auto rsp = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * L::kStageBytes);
  };
  auto osp = [&](int st) { return rsp(st) + NI * kPlane; };
  auto lws = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStageBytes +
                                    2 * L::kPlanes);
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int sl = warp >> 2, qu = warp & 3;   // 16 columns, 16 channels
  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const int j0 = sl * 16, d0 = qu * 16, ncol = min(16, dk - j0);
  const int64_t step = static_cast<int64_t>(h) * dk;   // between tokens
  const int64_t hbase = static_cast<int64_t>(head) * dk;
  float* const dsb = dstates + static_cast<int64_t>(bh) * n_run * dk * dk;

  // this warp's piece dSᵀ[j0 + j][d0 + d]: acc[nt] holds rows j = g and
  // g + 8, columns d = 8·nt + 2q and + 1
  float acc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = g + (e >> 1) * 8, d = d0 + nt * 8 + 2 * q + (e & 1);
      acc[nt][e] = (dst && j < ncol && d < dk)
                       ? dst[(static_cast<int64_t>(bh) * dk + d) * dk + j0 + j]
                       : 0.f;
    }

  // the bf16 path's fixed copy slots, one 16-byte copy a thread: r or dO
  // (row sr, 8 columns from sc8), or log_w (row lr, 4 columns from lc4)
  const int e2 = tid & 127;
  const int sr = e2 >> 3, sc8 = (e2 & 7) * 8;
  const int lr = (tid - 256) >> 4, lc4 = ((tid - 256) & 15) * 4;
  const int64_t tok0 = static_cast<int64_t>(b) * s_len;
  auto load = [&](int c, int st) {
    const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
    const int64_t base = (tok0 + t0) * step + hbase;
    if (NI == 1 && vec) {
      if (tid < 256) {
        const bool ok = sr < nr && sc8 < dk;
        const T* src = tid < 128 ? r : dout;
        scan::cp_async16((tid < 128 ? rsp(st) : osp(st)) + sr * kNS + sc8,
                         ok ? src + base + sr * step + sc8 : src,
                         ok ? 16 : 0);
      } else {
        const bool ok = lr < nr && lc4 < dk;
        scan::cp_async16(lws(st) + lr * kFS + lc4,
                         ok ? log_w + base + lr * step + lc4 : log_w,
                         ok ? 16 : 0);
      }
      return;
    }
    scan::stage<T, NI, kChunk, kMaxK, kThr>(rsp(st), kNS, kPlane, r + base,
                                            step, nr, dk, vec, tid);
    scan::stage<T, NI, kChunk, kMaxK, kThr>(osp(st), kNS, kPlane, dout + base,
                                            step, nr, dk, vec, tid);
    for (int e = tid; e < kChunk * kMaxK; e += kThr) {
      const int t = e / kMaxK, d = e % kMaxK;
      lws(st)[t * kFS + d] =
          t < nr && d < dk ? log_w[base + t * step + d] : 0.f;
    }
  };

  const int c_end = c0 + n_run;       // the run's chunks c0 .. c_end - 1
  for (int k = 0; k < kAhead; ++k) {  // the last chunks in flight
    if (k < n_run) load(c_end - 1 - k, k % kStages);
    scan::cp_async_commit();
  }
  for (int k = 0; k < n_run; ++k) {
    const int c = c_end - 1 - k, st = k % kStages;
    scan::cp_async_wait<kAhead - 1>();  // chunk c has landed (elementwise
                                        // copies were stored already)
    __syncthreads();  // ... for every warp; the chunk after c is consumed
    if (k + kAhead < n_run) load(c - kAhead, (k + kAhead) % kStages);
    scan::cp_async_commit();
    {  // dS_out of chunk c, for the chunk pass
      float* out = dsb + static_cast<int64_t>(c - c0) * dk * dk;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = g + (e >> 1) * 8, d = d0 + nt * 8 + 2 * q + (e & 1);
          if (j < ncol && d < dk)
            out[static_cast<int64_t>(d) * dk + j0 + j] = acc[nt][e];
        }
    }
    const bf16* rs = rsp(st);
    const float* lw = lws(st);
    // r_dec [t x d] as B fragments: channel d0 + 8·nt + g at tokens 2q,
    // 2q + 1, 2q + 8, 2q + 9, from the channel's serial running sums;
    // the channel's total gives exp(p_last)
    uint32_t bt[2][NC][2];
    float el_g[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int d = d0 + nt * 8 + g;
      float run = 0.f, qv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        if (t == 2 * q) qv[0] = run;
        if (t == 2 * q + 1) qv[1] = run;
        if (t == 2 * q + 8) qv[2] = run;
        if (t == 2 * q + 9) qv[3] = run;
        run += lw[t * kFS + d];
      }
      el_g[nt] = expf(run);
      float rd[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        rd[m] = scan::plane_at<NI>(rs, kNS, kPlane, 2 * q + (m & 1) + (m >> 1) * 8,
                                   d) *
                expf(qv[m]);
      uint32_t lo[NC], hi[NC];
      scan::split2<NC>(rd[0], rd[1], lo);
      scan::split2<NC>(rd[2], rd[3], hi);
#pragma unroll
      for (int pp = 0; pp < NC; ++pp) {
        bt[nt][pp][0] = lo[pp];
        bt[nt][pp][1] = hi[pp];
      }
    }
    // dOᵀ [j x t] as an A fragment
    uint32_t of[NI][4];
#pragma unroll
    for (int pp = 0; pp < NI; ++pp)
      scan::ldsm_x4_trans(osp(st) + pp * kPlane +
                              ((lane >> 4) * 8 + (lane & 7)) * kNS + j0 +
                              ((lane >> 3) & 1) * 8,
                          of[pp]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      // exp(p_last) of this lane's columns d0 + 8·nt + 2q (+ 1), from the
      // lanes whose channel they are
      const float e0 = __shfl_sync(kFull, el_g[nt], (2 * q) * 4);
      const float e1 = __shfl_sync(kFull, el_g[nt], (2 * q + 1) * 4);
      acc[nt][0] *= e0;
      acc[nt][1] *= e1;
      acc[nt][2] *= e0;
      acc[nt][3] *= e1;
      scan::mma_parts<NI, NC>(acc[nt], of, bt[nt]);
    }
  }
  if (ds0) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = g + (e >> 1) * 8, d = d0 + nt * 8 + 2 * q + (e & 1);
        if (j < ncol && d < dk)
          ds0[(static_cast<int64_t>(bh) * dk + d) * dk + j0 + j] = acc[nt][e];
      }
  }
}

// the chunk pass's dynamic shared memory, in bytes from the start: v and
// dO planes; then float tiles [16][kFS]: r, k, p, q, the pair terms of dr
// (then r∘dr'), of dk from even and from odd tokens t (the first then
// k∘dk'); S_in and dS_out [64][kFS]; v·dO and A [16][17]; u and the two
// terms of Σ_j S_out∘dS_out [64]
template <typename T>
struct IntraSmem {
  static constexpr int kPlanes = Parts<T>::kIn * kPlane * 2;   // bytes
  static constexpr int kV = 0, kO = kPlanes, kF = 2 * kPlanes;
  static constexpr int kTile = kChunk * kFS;                   // floats
  static constexpr int kR = 0, kK = kTile, kP = 2 * kTile, kQ = 3 * kTile,
                       kDr = 4 * kTile, kDk0 = 5 * kTile, kDk1 = 6 * kTile,
                       kSin = 7 * kTile, kDso = kSin + kMaxK * kFS,
                       kVd = kDso + kMaxK * kFS, kAm = kVd + kChunk * 17,
                       kU = kAm + kChunk * 17, kSo1 = kU + kMaxK,
                       kSo2 = kSo1 + kMaxK, kFloats = kSo2 + kMaxK;
  static constexpr int kBytes = kF + kFloats * 4;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_intra_kernel(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ log_w,
                          const float* __restrict__ u,
                          const T* __restrict__ dout,
                          const float* __restrict__ states,
                          const float* __restrict__ dstates,
                          T* __restrict__ dr, T* __restrict__ dkk,
                          T* __restrict__ dv, float* __restrict__ dlog_w,
                          float* __restrict__ du_part, int s_len, int c0,
                          int n_run, int h, int dk, int vec, int vec_s) {
  constexpr int NI = Parts<T>::kIn, NC = Parts<T>::kCalc;
  using L = IntraSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* vs = reinterpret_cast<bf16*>(smem + L::kV);
  bf16* os = reinterpret_cast<bf16*>(smem + L::kO);
  float* f = reinterpret_cast<float*>(smem + L::kF);
  float* rs = f + L::kR;
  float* ks = f + L::kK;
  float* ps = f + L::kP;       // log_w, then p (inclusive) times log2(e)
  float* qs = f + L::kQ;       // q (exclusive) times log2(e)
  float* drt = f + L::kDr;     // the pair terms of dr, then r∘dr'
  float* dkt = f + L::kDk0;    // those of dk from even t, then k∘dk'
  float* dk1 = f + L::kDk1;    // those of dk from odd t
  float* sin = f + L::kSin;    // S_in [d][j]
  float* dso = f + L::kDso;    // dS_out [d][j]
  float (*vd)[17] = reinterpret_cast<float (*)[17]>(f + L::kVd);  // [t][s]
  float (*am)[17] = reinterpret_cast<float (*)[17]>(f + L::kAm);  // [t][s]
  float* us = f + L::kU;
  float* so1 = f + L::kSo1;    // Σ_j S_in∘dS_out per channel
  float* so2 = f + L::kSo2;    // Σ_s k_dec∘(v·dS_outᵀ) per channel

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.x / n_run, ir = blockIdx.x % n_run, c = c0 + ir;
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int head = blockIdx.y;
  const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
  const int64_t step = static_cast<int64_t>(h) * dk;
  const int64_t base = (static_cast<int64_t>(b) * s_len + t0) * step +
                       static_cast<int64_t>(head) * dk;
  const int64_t bh = static_cast<int64_t>(b) * h + head;
  const int64_t mat = static_cast<int64_t>(dk) * dk;
  const float* s_in_g = states + (bh * n_run + ir) * mat;
  const float* ds_out_g = dstates + (bh * n_run + ir) * mat;
  const int w16 = warp * 16;   // this warp's 16 channels (or columns)

  scan::stage<T, NI, kChunk, kMaxK, kThreads>(vs, kNS, kPlane, v + base, step,
                                              nr, dk, vec, tid);
  scan::stage<T, NI, kChunk, kMaxK, kThreads>(os, kNS, kPlane, dout + base,
                                              step, nr, dk, vec, tid);
  if (vec_s) {  // S_in and dS_out, 4 floats a copy
    for (int e = tid; e < kMaxK * kMaxK / 4; e += kThreads) {
      const int d = e / (kMaxK / 4), j = (e % (kMaxK / 4)) * 4;
      const bool ok = d < dk && j < dk;
      scan::cp_async16(sin + d * kFS + j, ok ? s_in_g + d * dk + j : s_in_g,
                       ok ? 16 : 0);
      scan::cp_async16(dso + d * kFS + j,
                       ok ? ds_out_g + d * dk + j : ds_out_g, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kMaxK * kMaxK; e += kThreads) {
      const int d = e / kMaxK, j = e % kMaxK;
      const bool ok = d < dk && j < dk;
      sin[d * kFS + j] = ok ? s_in_g[d * dk + j] : 0.f;
      dso[d * kFS + j] = ok ? ds_out_g[d * dk + j] : 0.f;
    }
  }
  scan::cp_async_commit();
  for (int e = tid; e < kChunk * kMaxK; e += kThreads) {
    const int t = e / kMaxK, d = e % kMaxK;
    const bool in = t < nr && d < dk;
    const int64_t off = base + t * step + d;
    rs[t * kFS + d] = in ? scan::to_f(r[off]) : 0.f;
    ks[t * kFS + d] = in ? scan::to_f(k[off]) : 0.f;
    ps[t * kFS + d] = in ? log_w[off] : 0.f;
  }
  if (tid < kMaxK) us[tid] = tid < dk ? u[head * dk + tid] : 0.f;
  scan::cp_async_wait<0>();
  __syncthreads();

  if (tid < kMaxK) {  // the running sums of channel tid, in token order,
    const int d = tid;  // kept times log2(e) for exp2f (a monotone
    float acc = 0.f;    // rounding: q_t <= p_s still holds for s < t)
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      qs[t * kFS + d] = acc * kLog2e;
      acc += ps[t * kFS + d];
      ps[t * kFS + d] = acc * kLog2e;
    }
  } else {  // Σ_j S_in∘dS_out, a row at a time per warp of warps 2-3
    for (int d = warp - 2; d < kMaxK; d += kWarps - 2) {
      float a = sin[d * kFS + lane] * dso[d * kFS + lane] +
                sin[d * kFS + lane + 32] * dso[d * kFS + lane + 32];
      a = warp_sum(a);
      if (lane == 0) so1[d] = a;
    }
  }
  if (warp == 0) {  // v_s·dO_t [t x s] on the tensor cores
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kMaxK; kk += 16) {
      uint32_t af[NI][4], bt[2][NI][2];
      scan::ldsm_a<NI>(os, kNS, kPlane, kk, lane, af);
      scan::ldsm_b_nk<NI>(vs, kNS, kPlane, kk, lane, bt);
      scan::mma_parts<NI, NI>(acc[0], af, bt[0]);
      scan::mma_parts<NI, NI>(acc[1], af, bt[1]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vd[g + (e >> 1) * 8][nt * 8 + 2 * q + (e & 1)] = acc[nt][e];
  }
  __syncthreads();
  // A[t][s], s <= t: a strict pair with its decay a thread (threads
  // 0-119), the bonus diagonal two entries a thread (120-127); zeros above
  // the diagonal
  static_assert(kStrict + 2 * (kThreads - kStrict) == kPairs,
                "every pair of A has one thread");
  if (tid < kStrict) {
    int t = 1;
    while (t * (t + 1) / 2 <= tid) ++t;
    const int s = tid - t * (t - 1) / 2;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int d = 0; d < kMaxK; d += 4) {
      const float4 rr = *reinterpret_cast<const float4*>(rs + t * kFS + d);
      const float4 kv = *reinterpret_cast<const float4*>(ks + s * kFS + d);
      const float4 qq = *reinterpret_cast<const float4*>(qs + t * kFS + d);
      const float4 pp = *reinterpret_cast<const float4*>(ps + s * kFS + d);
      acc.x += rr.x * kv.x * exp2f(qq.x - pp.x);
      acc.y += rr.y * kv.y * exp2f(qq.y - pp.y);
      acc.z += rr.z * kv.z * exp2f(qq.z - pp.z);
      acc.w += rr.w * kv.w * exp2f(qq.w - pp.w);
    }
    am[t][s] = (acc.x + acc.y) + (acc.z + acc.w);
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int t = 2 * (tid - kStrict) + m;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int d = 0; d < kMaxK; d += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(rs + t * kFS + d);
        const float4 kv = *reinterpret_cast<const float4*>(ks + t * kFS + d);
        const float4 w = *reinterpret_cast<const float4*>(us + d);
        acc.x += rr.x * kv.x * w.x;
        acc.y += rr.y * kv.y * w.y;
        acc.z += rr.z * kv.z * w.z;
        acc.w += rr.w * kv.w * w.w;
      }
      am[t][t] = (acc.x + acc.y) + (acc.z + acc.w);
    }
  }
  for (int e = tid; e < kChunk * kChunk; e += kThreads) {
    const int t = e / kChunk, s = e % kChunk;
    if (s > t) am[t][s] = 0.f;
  }
  {  // the pair terms of dr and dk, a thread per channel and token parity
     // (warps 0-1 the even tokens t, 2-3 the odd): one exp per pair s < t
    const int d = tid % kMaxK, par = tid / kMaxK;
    float dki[kChunk];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) dki[s] = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) {
      const int t = 2 * i + par;   // uniform over the warp
      const float qt = qs[t * kFS + d], rt = rs[t * kFS + d];
      float dri = 0.f;
#pragma unroll
      for (int s = 0; s < kChunk - 1; ++s) {
        if (s < t) {   // t is uniform over the warp: no divergence
          const float e = exp2f(qt - ps[s * kFS + d]) * vd[t][s];
          dri += e * ks[s * kFS + d];
          dki[s] += e * rt;
        }
      }
      drt[t * kFS + d] = dri;
    }
    float* dkp = par ? dk1 : dkt;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) dkp[s * kFS + d] = dki[s];
  }
  __syncthreads();

  // dr and dk at this warp's 16 channels: dO·S_inᵀ and v·dS_outᵀ on the
  // tensor cores, the pair terms added in the same fragment layout
  {
    float dsi[2][4] = {}, vds[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kMaxK; kk += 16) {
      uint32_t oa[NI][4], va[NI][4];
      scan::ldsm_a<NI>(os, kNS, kPlane, kk, lane, oa);
      scan::ldsm_a<NI>(vs, kNS, kPlane, kk, lane, va);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t sb[NC][2], db[NC][2];
        scan::frag_b_cols<NC>(sin + (w16 + nt * 8) * kFS + kk, kFS, lane, sb);
        scan::frag_b_cols<NC>(dso + (w16 + nt * 8) * kFS + kk, kFS, lane, db);
        scan::mma_parts<NI, NC>(dsi[nt], oa, sb);
        scan::mma_parts<NI, NC>(vds[nt], va, db);
      }
    }
    float so[2][2] = {};   // Σ over this lane's two tokens of k_dec∘vds
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = g + (e >> 1) * 8, d = w16 + nt * 8 + 2 * q + (e & 1);
        const float qt = qs[t * kFS + d], pt = ps[t * kFS + d];
        const float ekl = exp2f(ps[(kChunk - 1) * kFS + d] - pt);
        const float drp = exp2f(qt) * dsi[nt][e] + drt[t * kFS + d];
        const float dkp = ekl * vds[nt][e] + dkt[t * kFS + d] +
                          dk1[t * kFS + d];
        const float rv = rs[t * kFS + d], kv = ks[t * kFS + d];
        const float bonus = us[d] * vd[t][t];
        so[nt][e & 1] += kv * ekl * vds[nt][e];
        drt[t * kFS + d] = rv * drp;   // each entry read and written by
        dkt[t * kFS + d] = kv * dkp;   // this lane alone
        if (t < nr && d < dk) {
          const int64_t off = base + t * step + d;
          dr[off] = scan::from_f<T>(drp + bonus * kv);
          dkk[off] = scan::from_f<T>(dkp + bonus * rv);
        }
      }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {   // the sum over the 8 lanes g
        float x = so[nt][cc];
        x += __shfl_xor_sync(kFull, x, 4);
        x += __shfl_xor_sync(kFull, x, 8);
        x += __shfl_xor_sync(kFull, x, 16);
        if (g == 0) so2[w16 + nt * 8 + 2 * q + cc] = x;
      }
  }
  __syncthreads();   // A, r∘dr', k∘dk' and the S_out terms complete

  // dv at this warp's 16 columns: k_dec·dS_out + Aᵀ·dO on the tensor cores
  {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kMaxK; kk += 16) {
      uint32_t ka[NC][4];
      scan::frag_a<NC>(
          [&](int s, int d) {
            return ks[s * kFS + kk + d] *
                   exp2f(ps[(kChunk - 1) * kFS + kk + d] -
                         ps[s * kFS + kk + d]);
          },
          lane, ka);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t db[NC][2];
        scan::frag_b_rows<NC>(dso + kk * kFS + w16 + nt * 8, kFS, lane, db);
        scan::mma_parts<NC, NC>(acc[nt], ka, db);
      }
    }
    uint32_t aa[NC][4], bt[2][NI][2];
    scan::frag_a<NC>([&](int s, int t) { return am[t][s]; }, lane, aa);
    scan::ldsm_b_kn<NI>(os, kNS, kPlane, w16, lane, bt);
    scan::mma_parts<NC, NI>(acc[0], aa, bt[0]);
    scan::mma_parts<NC, NI>(acc[1], aa, bt[1]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = g + (e >> 1) * 8, j = w16 + nt * 8 + 2 * q + (e & 1);
        if (s < nr && j < dk)
          dv[base + s * step + j] = scan::from_f<T>(acc[nt][e]);
      }
  }
  if (tid < dk) {  // dlog_w by suffix sums in token order, u's partial
    const int d = tid;
    // Σ_j S_out∘dS_out, S_out = diag(exp(p_last))·S_in + k_decᵀ·v
    const float sod = exp2f(ps[(kChunk - 1) * kFS + d]) * so1[d] + so2[d];
    float sr = 0.f, sk = 0.f;   // Σ_{t>τ} r∘dr', Σ_{s>=τ} k∘dk'
    for (int tau = kChunk - 1; tau >= 0; --tau) {
      sk += dkt[tau * kFS + d];
      if (tau < nr) dlog_w[base + tau * step + d] = (sr - sk) + sod;
      sr += drt[tau * kFS + d];
    }
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kChunk; ++t)
      acc += rs[t * kFS + d] * ks[t * kFS + d] * vd[t][t];
    du_part[((static_cast<int64_t>(b) * n_chunks + c) * h + head) * dk + d] =
        acc;
  }
}

// du[h][d] = Σ over (batch, chunk) of the partials, in that order
__global__ void __launch_bounds__(256)
    wkv6_bwd_du_kernel(const float* __restrict__ du_part,
                       float* __restrict__ du, int n_part, int hdk) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= hdk) return;
  float a = 0.f;
  for (int i = 0; i < n_part; ++i) a += du_part[static_cast<int64_t>(i) * hdk + e];
  du[e] = a;
}

template <typename T>
cudaError_t launch_reverse(const void* r, const void* log_w, const void* dout,
                           const void* dst, void* dstates, void* ds0, int b,
                           int s_len, int h, int dk, int c0, int n_run,
                           int vec, cudaStream_t stream) {
  static bool raised[64] = {};
  const cudaError_t err = scan::raise_smem(wkv6_bwd_reverse_kernel<T>,
                                           RevSmem<T>::kBytes, raised);
  if (err != cudaSuccess) return err;
  wkv6_bwd_reverse_kernel<T><<<b * h, kRevWarps * 32, RevSmem<T>::kBytes,
                               stream>>>(
      static_cast<const T*>(r), static_cast<const float*>(log_w),
      static_cast<const T*>(dout), static_cast<const float*>(dst),
      static_cast<float*>(dstates), static_cast<float*>(ds0), s_len, c0,
      n_run, h, dk, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chunk(const void* r, const void* k, const void* v,
                         const void* log_w, const void* u, const void* dout,
                         const void* states, const void* dstates,
                         void* du_part, void* dr, void* dkk, void* dv,
                         void* dlog_w, int b, int s_len, int h, int dk,
                         int c0, int n_run, int vec, int vec_s,
                         cudaStream_t stream) {
  if (n_run == 0) return cudaSuccess;
  static bool raised[64] = {};
  const cudaError_t err = scan::raise_smem(wkv6_bwd_intra_kernel<T>,
                                           IntraSmem<T>::kBytes, raised);
  if (err != cudaSuccess) return err;
  wkv6_bwd_intra_kernel<T><<<dim3(b * n_run, h), kThreads,
                             IntraSmem<T>::kBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(log_w),
      static_cast<const float*>(u), static_cast<const T*>(dout),
      static_cast<const float*>(states),
      static_cast<const float*>(dstates), static_cast<T*>(dr),
      static_cast<T*>(dkk), static_cast<T*>(dv),
      static_cast<float*>(dlog_w), static_cast<float*>(du_part), s_len, c0,
      n_run, h, dk, vec, vec_s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* log_w, const void* u, const void* dout,
                   const void* states, const void* dst,
                   void* dstates, void* du_part, void* dr, void* dkk,
                   void* dv, void* dlog_w, void* ds0, int b,
                   int s_len, int h, int dk, int c0, int n_run, int vec,
                   int vec_s, cudaStream_t stream) {
  const cudaError_t err =
      launch_reverse<T>(r, log_w, dout, dst, dstates, ds0, b, s_len, h, dk,
                        c0, n_run, vec, stream);
  if (err != cudaSuccess) return err;
  return launch_chunk<T>(r, k, v, log_w, u, dout, states, dstates, du_part,
                         dr, dkk, dv, dlog_w, b, s_len, h, dk, c0, n_run, vec,
                         vec_s, stream);
}

cudaError_t launch_du(const void* du_part, void* du, int n_part, int hdk,
                      cudaStream_t stream) {
  if (hdk == 0) return cudaSuccess;
  wkv6_bwd_du_kernel<<<(hdk + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), n_part,
      hdk);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The workspace of a backward from the checkpoints, in floats from its
// start (each piece 16-byte aligned): two segments' incoming states and
// two segments' dS_out (used in turn, segment g in buffer g % 2), the two
// carries of dS between segments, the recompute's state-only scratch (one
// segment's: the recompute stream runs one segment at a time) and u's
// per-(batch, chunk) partials.
struct CkptSpace {
  int64_t states[2], dstates[2], carry[2], rc, du_part, total;
  CkptSpace(int b, int h, int dk, int n_chunks, int is_bf16) {
    auto up4 = [](int64_t n) { return (n + 3) & ~int64_t{3}; };
    const int64_t seg = up4(static_cast<int64_t>(b) * h * kSegment * dk * dk);
    const int64_t mat = up4(static_cast<int64_t>(b) * h * dk * dk);
    int64_t at = 0;
    for (int i = 0; i < 2; ++i) states[i] = at, at += seg;
    for (int i = 0; i < 2; ++i) dstates[i] = at, at += seg;
    for (int i = 0; i < 2; ++i) carry[i] = at, at += mat;
    rc = at;
    at += up4(wkv6_fwd::scratch_floats(b, kSegment, h, is_bf16, false));
    du_part = at;
    at += up4(static_cast<int64_t>(b) * n_chunks * h * dk);
    total = at;
  }
};

template <typename T>
cudaError_t launch_ckpt(const void* r, const void* k, const void* v,
                        const void* log_w, const void* u, const void* dout,
                        const float* ckpt, const void* dst, void* dr,
                        void* dkk, void* dv, void* dlog_w, void* du,
                        void* ds0, float* work, const int* plan, int n_steps,
                        int b, int s_len, int h, int dk, int device,
                        cudaStream_t caller) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int n_seg = n_chunks / kSegment;
  const CkptSpace sp(b, h, dk, n_chunks, sizeof(T) == 2);
  const int64_t mat = static_cast<int64_t>(dk) * dk;
  const bool bf = sizeof(T) == 2;
  const int vec = bf && dk % 8 == 0 && aligned16(r) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(log_w);
  const int vec_v = bf && dk % 8 == 0 && aligned16(v);
  const int vec_s = dk % 4 == 0 && aligned16(work);
  auto issue = [&](int op, int g, cudaStream_t st) -> cudaError_t {
    if (op != ckpt::kSums && (g < 0 || g >= n_seg))
      return cudaErrorInvalidValue;
    const int c0 = g * kSegment, buf = g % 2;
    switch (op) {
      case ckpt::kRecompute:
        return wkv6_fwd::launch_recompute<T>(
            k, v, log_w, ckpt + g * mat, static_cast<int>(n_seg * mat),
            work + sp.rc, work + sp.states[buf], b, s_len, h, dk, vec_v, c0,
            kSegment, st);
      case ckpt::kReverse:
        return launch_reverse<T>(
            r, log_w, dout, g == n_seg - 1 ? dst : work + sp.carry[(g + 1) % 2],
            work + sp.dstates[buf], g == 0 ? ds0 : work + sp.carry[buf], b,
            s_len, h, dk, c0, kSegment, vec, st);
      case ckpt::kChunkPass:
        return launch_chunk<T>(r, k, v, log_w, u, dout, work + sp.states[buf],
                               work + sp.dstates[buf], work + sp.du_part, dr,
                               dkk, dv, dlog_w, b, s_len, h, dk, c0, kSegment,
                               vec, vec_s, st);
      case ckpt::kSums:
        return launch_du(work + sp.du_part, du, b * n_chunks, h * dk, st);
      default:
        return cudaErrorInvalidValue;
    }
  };
  return ckpt::run(plan, n_steps, device, caller, issue);
}

}  // namespace

// The gradient over the chunks c0 .. c0 + n_run - 1 of the sequence: the
// reverse pass from dst, the gradient of the state after chunk
// c0 + n_run - 1 (or null: zeros), down to ds0 (or null: not wanted), the
// gradient of the state before chunk c0; then the chunk pass over the
// run.  r, k, v, dout, dr, dk, dv [b, s_len, h, dk] (all float32:
// is_bf16 = 0, or all bf16: is_bf16 = 1), log_w and dlog_w [b, s_len, h,
// dk], u [h, dk], states [b, h, n_run, dk, dk] (the run's incoming states:
// the forward's, `wkv6_launch`), dst and ds0 [b, h, dk, dk], all float32;
// scratch dstates [b, h, n_run, dk, dk] and du_part [b, n_chunks, h, dk]
// float32 (the run fills its chunks' rows): contiguous, on the device;
// 0 < dk <= 64.  dr, dk, dv and dlog_w receive the run's rows.  vec: bf16
// r, k, v, dout and log_w 16-byte aligned with dk a multiple of 8; vec_s:
// states and dstates 16-byte aligned with dk a multiple of 4: their tiles
// go by cp.async.  Two launches on `stream`; returns the first failing
// cudaGetLastError().
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* log_w, const void* u,
                               const void* dout, const void* states,
                               const void* dst,
                               void* dstates, void* du_part, void* dr,
                               void* dkk, void* dv, void* dlog_w, void* ds0,
                               int b, int s_len, int h, int dk, int c0,
                               int n_run, int is_bf16, int vec, int vec_s,
                               void* stream) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  if (dk <= 0 || dk > kMaxK || s_len < 0 || c0 < 0 || n_run < 0 ||
      c0 + n_run > n_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<bf16>(r, k, v, log_w, u, dout, states, dst,
                             dstates, du_part, dr, dkk, dv, dlog_w, ds0, b,
                             s_len, h, dk, c0, n_run, vec, vec_s, st)
              : launch<float>(r, k, v, log_w, u, dout, states, dst,
                              dstates, du_part, dr, dkk, dv, dlog_w, ds0, b,
                              s_len, h, dk, c0, n_run, 0, vec_s, st);
  return static_cast<int>(err);
}

// du [h, dk] float32: du_part [b, n_chunks, h, dk] summed over (batch,
// chunk) in that order, once every chunk's partial is in.  One launch on
// `stream`.
extern "C" int wkv6_bwd_du_launch(const void* du_part, void* du,
                                  int n_part, int hdk, void* stream) {
  if (n_part < 0 || hdk < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_du(du_part, du, n_part, hdk, static_cast<cudaStream_t>(stream)));
}

// Floats of the workspace of `wkv6_bwd_ckpt_launch`.
extern "C" long long wkv6_bwd_ckpt_floats(int b, int h, int dk,
                                          int n_chunks, int is_bf16) {
  return CkptSpace(b, h, dk, n_chunks, is_bf16).total;
}

// The whole gradient from the checkpoints, in one call: the inputs and
// outputs of `wkv6_bwd_launch` over the whole sequence (n_chunks = 16·n_seg,
// n_seg >= 2), ckpt [b, h, n_seg, dk, dk] float32 the forward's incoming
// state of every 16th chunk (`wkv6_launch` with every = 16), du [h, dk]
// float32, ds0 (or null: not wanted); `work` holds wkv6_bwd_ckpt_floats(
// b, h, dk, n_chunks, is_bf16) floats, 16-byte aligned.  Issues the n_steps
// rows (op, segment, stream, event) of `plan` (kernels/wkv6.py::
// checkpoint_plan) from the caller's `stream` on `device`: per segment the
// state-only recompute (wkv6_fwd.cuh) from its checkpoint, the reverse
// pass and the chunk pass, then u's sum; every launch ordered after the
// caller's earlier work and before its later.  Returns the first failing
// CUDA error.
extern "C" int wkv6_bwd_ckpt_launch(
    const void* r, const void* k, const void* v, const void* log_w,
    const void* u, const void* dout, const void* ckpt, const void* dst,
    void* dr, void* dkk, void* dv, void* dlog_w, void* du, void* ds0,
    void* work, const int* plan, int n_steps, int b, int s_len, int h,
    int dk, int is_bf16, int device, void* stream) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  if (dk <= 0 || dk > kMaxK || s_len < 0 || n_chunks % kSegment != 0 ||
      n_chunks < 2 * kSegment)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kept = static_cast<const float*>(ckpt);
  float* ws = static_cast<float*>(work);
  const cudaError_t err =
      is_bf16
          ? launch_ckpt<bf16>(r, k, v, log_w, u, dout, kept, dst, dr, dkk, dv,
                              dlog_w, du, ds0, ws, plan, n_steps, b, s_len, h,
                              dk, device, st)
          : launch_ckpt<float>(r, k, v, log_w, u, dout, kept, dst, dr, dkk,
                               dv, dlog_w, du, ds0, ws, plan, n_steps, b,
                               s_len, h, dk, device, st);
  return static_cast<int>(err);
}
