// RWKV-6 (WKV6) recurrence in chunks of 16 tokens, from an initial state.
//
// Replaces: the Pallas kernel `wkv6` in src/repro/kernels/wkv6.py (body
// `_wkv6_kernel`): r, k, v [B, S, H, dk] (float32 or bf16), log_w
// [B, S, H, dk] float32, u [H, dk] -> o [B, S, H, dk] (r's dtype) and the
// final state sT [B, H, dk, dk] float32.  Per head the recurrence is
//   o_t = r_t @ (S_{t-1} + (u*k_t)^T v_t),  S_t = diag(exp(log_w_t)) S_{t-1}
//                                                   + k_t^T v_t.
// The TPU kernel starts from a zero state; this one takes an initial state
// s0 (a null pointer: zeros, with no buffer filled), which is the function
// the reference's model runs for an extend (`models/ssm.py::wkv6_chunked`).
// Per chunk of 16 tokens, in float32: p = inclusive cumsum of log_w per
// channel, p_shift = the sum before each token; A[t][s] = Σ_d r[t,d] k[s,d]
// exp(p_shift[t,d] - p[s,d]) for s < t plus the bonus diagonal
// A[t][t] = Σ_d r u k; o = A v + (r·exp(p_shift)) S; then
// S = diag(exp(p_last)) S + (k·exp(p_last - p))ᵀ v.  The sums run serially
// per channel, so p_shift[t] - p[s] <= 0 holds exactly for s < t (adding a
// non-positive float never increases a sum): every exponent is <= 0 and a
// masked pair is never evaluated.  The per-(t, s, d) exp stays: the
// factorised exp(p_shift_t - ref)·exp(ref - p_s) has positive exponents,
// and log_w = -exp(w_raw) has no lower bound.  A ragged last chunk reads
// r = k = v = 0 and log_w = 0 past S: the identity.
//
// Bound on an H100: per call it reads r, k, v (2 or 4 bytes each), log_w
// (4 bytes) per element, the initial state, and writes o and the final
// state: ~17 MB for rwkv6-3b at S = 512 (H = 40, dk = 64, bf16), ~5 µs at
// 3.35 TB/s; its float32 work (~0.45 GFLOP with one exp per (t, s < t, d))
// is ~7 µs at 67 TFLOP/s on the CUDA cores.  What bounded the first version
// (one block per head and 16 state columns walking the chunks, one output
// per thread) was neither: 2–4 shared-memory loads per FMA, each head's
// A recomputed by all 4 of its column blocks, and 160 blocks of 8 warps,
// too few warps to hide the dependent sums.  What bounds this one is the
// serial pass's step, ~0.8 µs a chunk whatever the heads or bytes (a block
// per head, one SM each): its barriers, starting its copies and two
// dependent rounds of `mma`s and reductions; then pass A's pair sums
// (~5 µs at 314 tokens; neither `ex2.approx` nor halving their shared
// loads moved them, so latency, not the exps, sets them).  On an
// H100 80GB HBM3 at 700 W it took 0.0141 ms of device time per rwkv6-3b
// main-path call, 10x its bound (PERF.md).
//
// Design: two launches per call.
//
// `wkv6_intra_kernel` (pass A), one block of 5 warps per (batch, chunk,
// head): all that does not need the carried state, for all chunks at once.
// The chunk's loads are all in flight at once; a thread per channel runs
// its cumulative sums (kept times log2 e, for exp2f); A (136 pairs s <= t,
// one a thread, 5 warps) is summed on the CUDA cores with float4 shared
// loads, once per head; o_intra = A·v runs on the tensor cores, 16
// columns of v per warp.  o_intra and exp(p_last) in float32, and
// r_dec = r·exp(p_shift) and k_dec = k·exp(p_last - p) already split into
// their bf16 parts (planes [parts, 16, 64], 4 bytes per value in the bf16
// instance, as in float32), go to one scratch buffer that the wrapper
// allocates as float32: 3136 words per (batch, chunk, head) at dk <= 64,
// 10.0 MB for rwkv6-3b at 314 tokens (3.2 MB each for o_intra, r_dec and
// k_dec), inside the 50 MB L2.  Splitting there, once, spares the serial
// pass the conversions; the parts are the ones a split in pass B would
// make.
//
// `wkv6_state_kernel` (pass B), one block of 16 warps per batch·head: the
// serial walk over chunks with only the two state products,
// o = o_intra + r_dec·S and S = diag(exp(p_last))·S + k_decᵀ·v.  Each warp
// holds a 16 x 16 piece of Sᵀ (16 state columns by a quarter of dk) in
// registers as `mma` accumulator fragments, which are also, element for
// element, the B fragments of r_dec·S; r_dec and k_dec come by `ldmatrix`
// from their planes.  Per chunk each warp forms its part of r_dec·S and
// updates its piece; the 4 warps of a column slice then sum their parts
// through shared memory (a named barrier per slice) and each writes 4 rows
// of o.  The warps share the staging of the chunks' operands by `cp.async`
// into a ring of shared stages (one block barrier per chunk), three chunks
// ahead of the one computed, each thread with fixed copy slots (at most
// two 16-byte copies a chunk): staging through a general tile loop spent
// most of a chunk's instructions on address arithmetic.  The incoming
// state of every `every`-th chunk is stored when the caller gives a
// `states` buffer: training keeps every 16th, the backward's checkpoints
// (10.5 MB for rwkv6-3b at 4,096 tokens, against 167.8 MB for every
// chunk's), as the reference's `chunk_scan_checkpointed` keeps every 16th
// state; what is kept never changes the output's bits.  A launch runs a
// range of chunks from a given state, s0 read with a stride (a checkpoint
// inside `states` serves as one): the backward recomputes one segment's
// 16 states this way, with no o, whose products it then skips
// (wkv6_bwd.cu).
//
// Precision (scan_mma.cuh): in the bf16 instance v enters the `mma`s
// exactly; A, r_dec, k_dec and the state are split into two bf16 parts
// (about 16 mantissa bits; a single rounding of a state of magnitude ~4
// would be ~1e-2).  The float32 instance splits every operand into three
// parts (about float32's 24 bits).
//
// Ragged widths: dk is zero-padded to 64 in shared memory and scratch (the
// products stop at the multiple of 16 that covers it); a v whose width is
// not a multiple of 8 (or float32 inputs) is staged element by element
// instead of by `cp.async`.
#include "scan_mma.cuh"

namespace {

using scan::bf16;
using scan::Parts;

constexpr int kChunk = 16;            // tokens per chunk
constexpr int kMaxK = 64;             // largest head size taken
constexpr int kRS = kMaxK + 4;        // float row stride of pass A's tiles
constexpr int kNS = kMaxK + 8;        // bf16 / float row stride of tiles
constexpr int kWarps = 5;             // warps per pass A block (160 >= 136)
constexpr int kStateWarps = 16;       // warps per pass B block: 4 x 4 pieces
constexpr int kPairs = kChunk * (kChunk + 1) / 2;   // s <= t
static_assert(kPairs <= kWarps * 32, "one pair a thread in pass A");
constexpr int kPlaneW = kChunk * kMaxK / 2;         // words of a bf16 plane
constexpr float kLog2e = 1.4426950408889634f;

// scratch per (batch, chunk, head), in 4-byte words: r_dec and k_dec as
// NC bf16 planes [16, 64] each, o_intra [16, 64] and exp(p_last) [64]
template <int NC>
struct Scratch {
  static constexpr int kRdec = 0, kKdec = NC * kPlaneW;
  static constexpr int kOi = 2 * NC * kPlaneW, kEl = kOi + kChunk * kMaxK;
  static constexpr int kPer = kEl + kMaxK;
};

// pass B's dynamic shared memory: kStages stages of the r_dec, k_dec and
// v planes, o_intra and exp(p_last), then each warp's part of r_dec·S;
// kAhead = 3 chunks in flight (7 measured no faster)
template <typename T>
struct StateSmem {
  static constexpr int kStages = 4;
  static constexpr int kAhead = kStages - 1;
  static constexpr int kStageBytes =
      (2 * Parts<T>::kCalc + Parts<T>::kIn) * kChunk * kNS * 2 +
      (kChunk * kNS + kMaxK) * 4;
  static constexpr int kBytes =
      kStages * kStageBytes + kStateWarps * kChunk * 16 * 4;
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    wkv6_intra_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ log_w,
                      const float* __restrict__ u, float* __restrict__ scr,
                      int s_len, int c0, int n_run, int h, int dk, int vec) {
  constexpr int NI = Parts<T>::kIn, NC = Parts<T>::kCalc;
  constexpr int kPlane = kChunk * kNS, kThreads = kWarps * 32;
  constexpr int kHalf = kMaxK / 2;    // channel pairs
  using Sc = Scratch<NC>;
  __shared__ __align__(16) float rs[kChunk][kRS];
  __shared__ __align__(16) float ks[kChunk][kRS];
  __shared__ __align__(16) float ps[kChunk][kRS];   // log_w, then p
  __shared__ __align__(16) float qs[kChunk][kRS];   // p_shift
  __shared__ __align__(16) float us[kMaxK];
  __shared__ float am[kChunk][kChunk + 1];
  __shared__ __align__(16) uint16_t vs_raw[NI * kPlane];
  bf16* vs = reinterpret_cast<bf16*>(vs_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.x / n_run, ir = blockIdx.x % n_run, c = c0 + ir;
  const int head = blockIdx.y;
  const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
  const int64_t step = static_cast<int64_t>(h) * dk;  // between tokens
  const int64_t base = (static_cast<int64_t>(b) * s_len + t0) * step +
                       static_cast<int64_t>(head) * dk;
  float* out = scr + ((static_cast<int64_t>(b) * n_run + ir) * h + head) *
                         Sc::kPer;

  // the chunk's r, k, log_w, u and v, every load in flight at once
  scan::stage<T, NI, kChunk, kMaxK, kThreads>(vs, kNS, kPlane, v + base, step,
                                              nr, dk, vec, tid);
  scan::cp_async_commit();
#pragma unroll
  for (int e = tid; e < kChunk * kHalf; e += kThreads) {
    const int t = e / kHalf, d = 2 * (e % kHalf);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = t < nr && d + i < dk;
      const int64_t off = base + t * step + d + i;
      rs[t][d + i] = in ? scan::to_f(r[off]) : 0.f;
      ks[t][d + i] = in ? scan::to_f(k[off]) : 0.f;
      ps[t][d + i] = in ? log_w[off] : 0.f;
    }
  }
  if (tid < kMaxK) us[tid] = tid < dk ? u[head * dk + tid] : 0.f;
  __syncthreads();
  if (tid < kMaxK) {  // the running sums of channel tid, in token order,
    float acc = 0.f;  // kept times log2(e) for exp2f (a monotone rounding:
#pragma unroll        // p_shift[t] <= p[s] still holds for s < t)
    for (int t = 0; t < kChunk; ++t) {
      qs[t][tid] = acc * kLog2e;
      acc += ps[t][tid];
      ps[t][tid] = acc * kLog2e;
    }
  }
  __syncthreads();

  // A[t][s], s <= t: strict pairs with the decay, the bonus diagonal
  if (tid < kPairs) {  // one pair a thread; padded channels are zeros
    const int pr = tid;
    int t = 0;
    while ((t + 1) * (t + 2) / 2 <= pr) ++t;
    const int s = pr - t * (t + 1) / 2;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);  // four short chains
#pragma unroll
    for (int d = 0; d < kMaxK; d += 4) {
      const float4 rr = *reinterpret_cast<const float4*>(&rs[t][d]);
      const float4 kk = *reinterpret_cast<const float4*>(&ks[s][d]);
      float4 w;
      if (s < t) {
        const float4 qq = *reinterpret_cast<const float4*>(&qs[t][d]);
        const float4 pp = *reinterpret_cast<const float4*>(&ps[s][d]);
        w = make_float4(exp2f(qq.x - pp.x), exp2f(qq.y - pp.y),
                        exp2f(qq.z - pp.z), exp2f(qq.w - pp.w));
      } else {
        w = *reinterpret_cast<const float4*>(&us[d]);
      }
      acc.x += rr.x * kk.x * w.x;
      acc.y += rr.y * kk.y * w.y;
      acc.z += rr.z * kk.z * w.z;
      acc.w += rr.w * kk.w * w.w;
    }
    am[t][s] = (acc.x + acc.y) + (acc.z + acc.w);
  }
  for (int e = tid; e < kChunk * kChunk; e += kThreads) {
    const int t = e / kChunk, s = e % kChunk;
    if (s > t) am[t][s] = 0.f;
  }
  // r_dec, k_dec (as bf16 parts) and exp(p_last) to the scratch
  uint32_t* words = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int e = tid; e < kChunk * kHalf; e += kThreads) {
    const int t = e / kHalf, d = 2 * (e % kHalf);
    uint32_t rp[NC], kp[NC];
    scan::split2<NC>(rs[t][d] * exp2f(qs[t][d]),
                     rs[t][d + 1] * exp2f(qs[t][d + 1]), rp);
    scan::split2<NC>(
        ks[t][d] * exp2f(ps[kChunk - 1][d] - ps[t][d]),
        ks[t][d + 1] * exp2f(ps[kChunk - 1][d + 1] - ps[t][d + 1]), kp);
#pragma unroll
    for (int pp = 0; pp < NC; ++pp) {
      words[Sc::kRdec + pp * kPlaneW + e] = rp[pp];
      words[Sc::kKdec + pp * kPlaneW + e] = kp[pp];
    }
  }
  if (tid < kMaxK) out[Sc::kEl + tid] = exp2f(ps[kChunk - 1][tid]);
  scan::cp_async_wait<0>();
  __syncthreads();

  // o_intra = A·v on the tensor cores, 16 columns of v per warp
  uint32_t af[NC][4];
  {
    uint32_t r0[NC], r1[NC], r2[NC], r3[NC];
    scan::split2<NC>(am[g][2 * q], am[g][2 * q + 1], r0);
    scan::split2<NC>(am[g + 8][2 * q], am[g + 8][2 * q + 1], r1);
    scan::split2<NC>(am[g][2 * q + 8], am[g][2 * q + 9], r2);
    scan::split2<NC>(am[g + 8][2 * q + 8], am[g + 8][2 * q + 9], r3);
#pragma unroll
    for (int pp = 0; pp < NC; ++pp) {
      af[pp][0] = r0[pp];
      af[pp][1] = r1[pp];
      af[pp][2] = r2[pp];
      af[pp][3] = r3[pp];
    }
  }
  if (warp >= kMaxK / 16) return;  // no barrier follows
  const int dp = warp;
  uint32_t bt[2][NI][2];
#pragma unroll
  for (int pp = 0; pp < NI; ++pp) {  // v rows (k = s, column = j)
    uint32_t rr[4];
    scan::ldsm_x4_trans(vs + pp * kPlane +
                            ((lane & 7) + ((lane >> 3) & 1) * 8) * kNS +
                            dp * 16 + (lane >> 4) * 8,
                        rr);
    bt[0][pp][0] = rr[0];
    bt[0][pp][1] = rr[1];
    bt[1][pp][0] = rr[2];
    bt[1][pp][1] = rr[3];
  }
  float oa[2][4] = {};
  scan::mma_parts<NC, NI>(oa[0], af, bt[0]);
  scan::mma_parts<NC, NI>(oa[1], af, bt[1]);
  float* oi = out + Sc::kOi;
#pragma unroll
  for (int jt = 0; jt < 2; ++jt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(oi + (g + 8 * hf) * kMaxK + dp * 16 +
                                 jt * 8 + 2 * q) =
          make_float2(oa[jt][2 * hf], oa[jt][2 * hf + 1]);
}

template <typename T>
__global__ void __launch_bounds__(kStateWarps * 32)
    wkv6_state_kernel(const T* __restrict__ v, const float* __restrict__ scr,
                      const float* __restrict__ s0, int s0_stride,
                      T* __restrict__ o, float* __restrict__ s_out,
                      float* __restrict__ states, int s_len, int c0,
                      int n_run, int every, int h, int dk, int vec) {
  constexpr int NI = Parts<T>::kIn, NC = Parts<T>::kCalc;
  using L = StateSmem<T>;
  constexpr int kStages = L::kStages, kAhead = L::kAhead;
  constexpr int kPlane = kChunk * kNS, kThreads = kStateWarps * 32;
  using Sc = Scratch<NC>;
  extern __shared__ __align__(16) unsigned char smem[];
  // stage st: r_dec and k_dec planes, v planes (bf16), o_intra, exp(p_last);
  // after the stages, each warp's part of r_dec·S [16 t][16 j]
  auto rdp = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * L::kStageBytes);
  };
  auto kdp = [&](int st) { return rdp(st) + NC * kPlane; };
  auto vsp = [&](int st) { return kdp(st) + NC * kPlane; };
  auto ois = [&](int st) {
    return reinterpret_cast<float*>(vsp(st) + NI * kPlane);
  };
  auto els = [&](int st) { return ois(st) + kChunk * kNS; };
  float* red = reinterpret_cast<float*>(smem + kStages * L::kStageBytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int sl = warp >> 2, qu = warp & 3;   // 16 columns, 16 channels
  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const int j0 = sl * 16, d0 = qu * 16, ncol = min(16, dk - j0);
  const int64_t step = static_cast<int64_t>(h) * dk;

  // this warp's piece Sᵀ[j0 + j][d0 + d] as accumulators: acc[nt] holds
  // rows j = g and g + 8, columns d = 8·nt + 2q and + 1
  float acc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = g + (e >> 1) * 8, d = d0 + nt * 8 + 2 * q + (e & 1);
      acc[nt][e] = (s0 && j < ncol && d < dk)
                       ? s0[static_cast<int64_t>(bh) * s0_stride +
                            static_cast<int64_t>(d) * dk + j0 + j]
                       : 0.f;
    }

  // the bf16 path's fixed copy slots (at most two 16-byte copies a
  // thread), as offsets from the chunk's scratch and sources that advance
  // by a fixed stride a chunk
  const int e2 = tid & 255;
  const int pr = e2 >> 3, pc = (e2 & 7) * 8;       // plane row, 8 columns
  const int orow = e2 >> 4, ocol = (e2 & 15) * 4;  // o_intra row, 4 columns
  const int vr = (e2 >> 3) & 15, vc = (e2 & 7) * 8;  // v row, 8 columns
  const T* src_v = v + (static_cast<int64_t>(b) * s_len + vr) * step +
                   static_cast<int64_t>(head) * dk + vc;
  auto load = [&](int ir, int st) {   // the run's chunk ir
    const int t0 = (c0 + ir) * kChunk, nr = min(kChunk, s_len - t0);
    const float* in = scr + ((static_cast<int64_t>(b) * n_run + ir) * h +
                             head) * Sc::kPer;
    const bf16* planes = reinterpret_cast<const bf16*>(in);
    if constexpr (NI == 1) {
      static_assert(kThreads == 512 && NC * kChunk * kMaxK / 8 == 256,
                    "the slots below assume 512 threads, two-part planes");
    }
    if (NI == 1 && vec) {
      if (tid < NC * kChunk * kMaxK / 8) {  // r_dec and k_dec planes
        scan::cp_async16(rdp(st) + pr * kNS + pc,
                         planes + 2 * Sc::kRdec + pr * kMaxK + pc, 16);
        scan::cp_async16(kdp(st) + pr * kNS + pc,
                         planes + 2 * Sc::kKdec + pr * kMaxK + pc, 16);
      } else if (tid >= 256) {
        scan::cp_async16(ois(st) + orow * kNS + ocol,
                         in + Sc::kOi + orow * kMaxK + ocol, 16);
        if (e2 < 128) {  // v: row vr, 8 columns from vc
          const bool ok = vr < nr && vc < dk;
          scan::cp_async16(vsp(st) + vr * kNS + vc,
                           ok ? src_v + static_cast<int64_t>(t0) * step : v,
                           ok ? 16 : 0);
        } else if (e2 < 128 + kMaxK / 4) {  // exp(p_last)
          scan::cp_async16(els(st) + 4 * (e2 - 128),
                           in + Sc::kEl + 4 * (e2 - 128), 16);
        }
      }
      return;
    }
    scan::stage<bf16, 1, NC * kChunk, kMaxK, kThreads>(
        rdp(st), kNS, 0, planes + 2 * Sc::kRdec, kMaxK, NC * kChunk, kMaxK,
        true, tid);
    scan::stage<bf16, 1, NC * kChunk, kMaxK, kThreads>(
        kdp(st), kNS, 0, planes + 2 * Sc::kKdec, kMaxK, NC * kChunk, kMaxK,
        true, tid);
    scan::stage_words<kChunk, kMaxK, kThreads>(ois(st), kNS, in + Sc::kOi,
                                               kMaxK, tid);
    scan::stage_words<1, kMaxK, kThreads>(els(st), 0, in + Sc::kEl, 0, tid);
    scan::stage<T, NI, kChunk, kMaxK, kThreads>(
        vsp(st), kNS, kPlane,
        v + (static_cast<int64_t>(b) * s_len + t0) * step +
            static_cast<int64_t>(head) * dk,
        step, nr, dk, vec, tid);
  };

  for (int ir = 0; ir < kAhead; ++ir) {  // the first chunks in flight
    if (ir < n_run) load(ir, ir % kStages);
    scan::cp_async_commit();
  }
  // the two outputs this thread writes per chunk: row qu·4 + lane / 8 of
  // the chunk, columns j0 + 2·(lane % 8) and + 1, at chunk 0
  T* const o_out = o + (static_cast<int64_t>(b) * s_len + qu * 4 +
                        (lane >> 3)) * step + static_cast<int64_t>(head) * dk +
                   j0 + 2 * (lane & 7);
  for (int ir = 0; ir < n_run; ++ir) {
    const int c = c0 + ir, st = ir % kStages;
    scan::cp_async_wait<kAhead - 1>();  // chunk c has landed (elementwise
                                        // copies were stored already)
    __syncthreads();  // ... for every warp; chunk c - 1 is consumed
    if (ir + kAhead < n_run) load(ir + kAhead, (ir + kAhead) % kStages);
    scan::cp_async_commit();
    if (states && ir % every == 0) {  // the chunk's incoming state, for the
                                     // backward: every `every`-th chunk's
      float* sc = states +
                  (static_cast<int64_t>(bh) * ((n_run + every - 1) / every) +
                   ir / every) * dk * dk;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = g + (e >> 1) * 8, d = d0 + nt * 8 + 2 * q + (e & 1);
          if (j < ncol && d < dk)
            sc[static_cast<int64_t>(d) * dk + j0 + j] = acc[nt][e];
        }
    }
    const bf16* rdc = rdp(st);
    const bf16* kdc = kdp(st);
    const bf16* vsc = vsp(st);
    const float* oic = ois(st);
    const float* elc = els(st);

    // this warp's part of r_dec·S (its 16 channels), with the state before
    // this chunk, to the slice's reduction tiles (none without o: a
    // recompute of the states)
    if (o) {
      uint32_t af[NC][4];
#pragma unroll
      for (int pp = 0; pp < NC; ++pp)
        scan::ldsm_x4(rdc + pp * kPlane + (lane & 15) * kNS + d0 +
                          (lane >> 4) * 8,
                      af[pp]);
      float oa[2][4] = {};
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        // B operand (k = d, column = j): the accumulators' own elements
        uint32_t lo[NC], hi[NC], bt[NC][2];
        scan::split2<NC>(acc[0][2 * jt], acc[0][2 * jt + 1], lo);
        scan::split2<NC>(acc[1][2 * jt], acc[1][2 * jt + 1], hi);
#pragma unroll
        for (int pp = 0; pp < NC; ++pp) {
          bt[pp][0] = lo[pp];
          bt[pp][1] = hi[pp];
        }
        scan::mma_parts<NC, NC>(oa[jt], af, bt);
      }
      float* mine = red + warp * 256;
#pragma unroll
      for (int jt = 0; jt < 2; ++jt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(mine + (g + 8 * hf) * 16 + jt * 8 +
                                     2 * q) =
              make_float2(oa[jt][2 * hf], oa[jt][2 * hf + 1]);
    }

    // S = diag(exp(p_last))·S + k_decᵀ·v on this warp's piece, i.e.
    // Sᵀ = Sᵀ·diag + vᵀ·k_dec
    {
      uint32_t vf[NI][4], bt[2][NC][2];
#pragma unroll
      for (int pp = 0; pp < NI; ++pp)  // vᵀ [j x s] as an A fragment
        scan::ldsm_x4_trans(vsc + pp * kPlane +
                                ((lane >> 4) * 8 + (lane & 7)) * kNS + j0 +
                                ((lane >> 3) & 1) * 8,
                            vf[pp]);
#pragma unroll
      for (int pp = 0; pp < NC; ++pp) {  // k_dec rows (k = s, column = d)
        uint32_t rr[4];
        scan::ldsm_x4_trans(kdc + pp * kPlane +
                                ((lane & 7) + ((lane >> 3) & 1) * 8) * kNS +
                                d0 + (lane >> 4) * 8,
                            rr);
        bt[0][pp][0] = rr[0];
        bt[0][pp][1] = rr[1];
        bt[1][pp][0] = rr[2];
        bt[1][pp][1] = rr[3];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 el =
            *reinterpret_cast<const float2*>(&elc[d0 + nt * 8 + 2 * q]);
        acc[nt][0] *= el.x;
        acc[nt][1] *= el.y;
        acc[nt][2] *= el.x;
        acc[nt][3] *= el.y;
        scan::mma_parts<NI, NC>(acc[nt], vf, bt[nt]);
      }
    }

    // o = o_intra + r_dec·S on 4 rows t of the slice, r_dec·S the sum of
    // the slice's 4 parts
    if (o) {
      scan::group_sync(1 + sl, 4 * 32);
      const int t = qu * 4 + (lane >> 3), j = 2 * (lane & 7);
      const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
      const float* part = red + sl * 4 * 256 + t * 16 + j;
      float2 sum = *reinterpret_cast<const float2*>(oic + t * kNS + j0 + j);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 x = *reinterpret_cast<const float2*>(part + k * 256);
        sum.x += x.x;
        sum.y += x.y;
      }
      if (t < nr) {
        T* oo = o_out + static_cast<int64_t>(t0) * step;
        if (j < ncol) oo[0] = scan::from_f<T>(sum.x);
        if (j + 1 < ncol) oo[1] = scan::from_f<T>(sum.y);
      }
    }
  }

  if (!s_out) return;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = g + (e >> 1) * 8, d = d0 + nt * 8 + 2 * q + (e & 1);
      if (j < ncol && d < dk)
        s_out[(static_cast<int64_t>(bh) * dk + d) * dk + j0 + j] = acc[nt][e];
    }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* log_w, const void* u, const void* s0,
                   int s0_stride, void* scratch, void* o, void* s_out,
                   void* states, int b, int s_len, int h, int dk, int vec,
                   int c0, int n_run, int every, cudaStream_t stream) {
  if (n_run > 0) {
    wkv6_intra_kernel<T><<<dim3(b * n_run, h), kWarps * 32, 0, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(log_w),
        static_cast<const float*>(u), static_cast<float*>(scratch), s_len,
        c0, n_run, h, dk, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  static bool raised[64] = {};
  const cudaError_t err = scan::raise_smem(
      wkv6_state_kernel<T>, StateSmem<T>::kBytes, raised);
  if (err != cudaSuccess) return err;
  wkv6_state_kernel<T><<<b * h, kStateWarps * 32, StateSmem<T>::kBytes,
                         stream>>>(
      static_cast<const T*>(v), static_cast<const float*>(scratch),
      static_cast<const float*>(s0), s0_stride, static_cast<T*>(o),
      static_cast<float*>(s_out), static_cast<float*>(states), s_len, c0,
      n_run, every, h, dk, vec);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch a run over n_run chunks needs (the wrapper allocates
// them).
extern "C" long long wkv6_scratch_floats(int b, int n_run, int h, int dk,
                                         int is_bf16) {
  const int per = is_bf16 ? Scratch<Parts<bf16>::kCalc>::kPer
                          : Scratch<Parts<float>::kCalc>::kPer;
  return static_cast<long long>(b) * n_run * h * per;
}
// r, k, v [b, s_len, h, dk] (all float32: is_bf16 = 0, or all bf16:
// is_bf16 = 1), log_w [b, s_len, h, dk] float32, u [h, dk] float32:
// contiguous, on the device; 0 < dk <= 64.  Runs the chunks c0 ..
// c0 + n_run - 1 of the sequence, from s0 (or null: a zero state), the
// state of batch·head bh at s0 + bh·s0_stride floats, each a contiguous
// [dk, dk] float32 matrix (s0_stride = dk·dk for a [b, h, dk, dk] s0; a
// checkpoint of `states` has a longer stride).  o (or null: not written,
// and its products skipped) [b, s_len, h, dk] in r's type receives those
// chunks' rows; s_out (or null) [b, h, dk, dk] float32 the state after
// them; states (or null: none kept) [b, h, ceil(n_run / every), dk, dk]
// float32 the incoming state of every `every`-th chunk of the run, from
// its first (the backward's checkpoints: wkv6_bwd.cu).  o, s_out and the
// kept states are the same bits whatever is kept.  scratch holds
// wkv6_scratch_floats(b, n_run, ...) floats.  vec: bf16 v 16-byte aligned
// with dk a multiple of 8, so its tiles go by cp.async.  Two launches on
// `stream`; returns the first failing cudaGetLastError().
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* log_w, const void* u, const void* s0,
                           int s0_stride, void* scratch, void* o,
                           void* s_out, void* states, int b, int s_len,
                           int h, int dk, int is_bf16, int vec, int c0,
                           int n_run, int every, void* stream) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  if (dk <= 0 || dk > kMaxK || s_len < 0 || c0 < 0 || n_run < 0 ||
      c0 + n_run > n_chunks || every < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<bf16>(r, k, v, log_w, u, s0, s0_stride, scratch, o,
                             s_out, states, b, s_len, h, dk, vec, c0, n_run,
                             every, st)
              : launch<float>(r, k, v, log_w, u, s0, s0_stride, scratch, o,
                              s_out, states, b, s_len, h, dk, 0, c0, n_run,
                              every, st);
  return static_cast<int>(err);
}
