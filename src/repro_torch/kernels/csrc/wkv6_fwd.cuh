// The two passes of the WKV6 forward (design: wkv6.cu), shared by the
// forward's launcher (wkv6.cu) and the backward's recompute from the
// checkpoints (wkv6_bwd.cu).
//
// Each pass has two instances of one body: with the output (`kOut`, the
// forward: `wkv6_intra_kernel`, `wkv6_state_kernel`) and state-only (the
// recompute: `wkv6_recompute_intra_kernel`, `wkv6_recompute_state_kernel`).
// The state-only pass A writes only what the state update reads, k_dec
// (as its bf16 parts) and exp(p_last): no A, o_intra or r_dec, and it
// loads neither r, v nor u; its scratch is 1088 words per (batch, chunk,
// head) against 3136.  The state-only pass B stages only the k_dec and v
// planes and exp(p_last), and keeps every chunk's incoming state.  Both
// instances run the same arithmetic on the values the state reads (the
// running sums, k_dec, its split, the `mma`s of the update), so the
// recomputed states are the forward's bits.
#pragma once

#include "scan_mma.cuh"

namespace wkv6_fwd {

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

// scratch per (batch, chunk, head), in 4-byte words: r_dec (with the
// output only) and k_dec as NC bf16 planes [16, 64] each, o_intra
// [16, 64] (with the output only) and exp(p_last) [64]
template <int NC, bool kOut>
struct Scratch {
  static constexpr int kRdec = 0, kKdec = kOut ? NC * kPlaneW : 0;
  static constexpr int kOi = kKdec + NC * kPlaneW;
  static constexpr int kEl = kOut ? kOi + kChunk * kMaxK : kOi;
  static constexpr int kPer = kEl + kMaxK;
};

// pass B's dynamic shared memory: kStages stages of the (r_dec,) k_dec and
// v planes, (o_intra) and exp(p_last), then (with the output) each warp's
// part of r_dec·S; kAhead = 3 chunks in flight (7 measured no faster)
template <typename T, bool kOut>
struct StateSmem {
  static constexpr int kStages = 4;
  static constexpr int kAhead = kStages - 1;
  static constexpr int kStageBytes =
      ((kOut ? 2 : 1) * Parts<T>::kCalc + Parts<T>::kIn) * kChunk * kNS * 2 +
      ((kOut ? kChunk * kNS : 0) + kMaxK) * 4;
  static constexpr int kBytes =
      kStages * kStageBytes + (kOut ? kStateWarps * kChunk * 16 * 4 : 0);
};

template <typename T, bool kOut>
__device__ __forceinline__ void intra_pass(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ log_w, const float* __restrict__ u,
    float* __restrict__ scr, int s_len, int c0, int n_run, int h, int dk,
    int vec) {
  constexpr int NI = Parts<T>::kIn, NC = Parts<T>::kCalc;
  constexpr int kPlane = kChunk * kNS, kThreads = kWarps * 32;
  constexpr int kHalf = kMaxK / 2;    // channel pairs
  using Sc = Scratch<NC, kOut>;
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

  // the chunk's r, k, log_w, u and v (state-only: k and log_w), every load
  // in flight at once
  if constexpr (kOut) {
    scan::stage<T, NI, kChunk, kMaxK, kThreads>(vs, kNS, kPlane, v + base,
                                                step, nr, dk, vec, tid);
    scan::cp_async_commit();
  }
#pragma unroll
  for (int e = tid; e < kChunk * kHalf; e += kThreads) {
    const int t = e / kHalf, d = 2 * (e % kHalf);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = t < nr && d + i < dk;
      const int64_t off = base + t * step + d + i;
      if constexpr (kOut) rs[t][d + i] = in ? scan::to_f(r[off]) : 0.f;
      ks[t][d + i] = in ? scan::to_f(k[off]) : 0.f;
      ps[t][d + i] = in ? log_w[off] : 0.f;
    }
  }
  if constexpr (kOut) {
    if (tid < kMaxK) us[tid] = tid < dk ? u[head * dk + tid] : 0.f;
  }
  __syncthreads();
  if (tid < kMaxK) {  // the running sums of channel tid, in token order,
    float acc = 0.f;  // kept times log2(e) for exp2f (a monotone rounding:
#pragma unroll        // p_shift[t] <= p[s] still holds for s < t)
    for (int t = 0; t < kChunk; ++t) {
      if constexpr (kOut) qs[t][tid] = acc * kLog2e;
      acc += ps[t][tid];
      ps[t][tid] = acc * kLog2e;
    }
  }
  __syncthreads();

  // A[t][s], s <= t: strict pairs with the decay, the bonus diagonal
  if constexpr (kOut) {
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
  }
  // (r_dec and) k_dec as bf16 parts, and exp(p_last), to the scratch
  uint32_t* words = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int e = tid; e < kChunk * kHalf; e += kThreads) {
    const int t = e / kHalf, d = 2 * (e % kHalf);
    uint32_t kp[NC];
    scan::split2<NC>(
        ks[t][d] * exp2f(ps[kChunk - 1][d] - ps[t][d]),
        ks[t][d + 1] * exp2f(ps[kChunk - 1][d + 1] - ps[t][d + 1]), kp);
#pragma unroll
    for (int pp = 0; pp < NC; ++pp)
      words[Sc::kKdec + pp * kPlaneW + e] = kp[pp];
    if constexpr (kOut) {
      uint32_t rp[NC];
      scan::split2<NC>(rs[t][d] * exp2f(qs[t][d]),
                       rs[t][d + 1] * exp2f(qs[t][d + 1]), rp);
#pragma unroll
      for (int pp = 0; pp < NC; ++pp)
        words[Sc::kRdec + pp * kPlaneW + e] = rp[pp];
    }
  }
  if (tid < kMaxK) out[Sc::kEl + tid] = exp2f(ps[kChunk - 1][tid]);
  if constexpr (!kOut) return;
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

template <typename T, bool kOut>
__device__ __forceinline__ void state_pass(
    const T* __restrict__ v, const float* __restrict__ scr,
    const float* __restrict__ s0, int s0_stride, T* __restrict__ o,
    float* __restrict__ s_out, float* __restrict__ states, int s_len, int c0,
    int n_run, int every, int h, int dk, int vec) {
  constexpr int NI = Parts<T>::kIn, NC = Parts<T>::kCalc;
  using L = StateSmem<T, kOut>;
  constexpr int kStages = L::kStages, kAhead = L::kAhead;
  constexpr int kPlane = kChunk * kNS, kThreads = kStateWarps * 32;
  using Sc = Scratch<NC, kOut>;
  extern __shared__ __align__(16) unsigned char smem[];
  // stage st: (r_dec,) k_dec and v planes (bf16), (o_intra,) exp(p_last);
  // after the stages, with the output, each warp's part of r_dec·S
  // [16 t][16 j]
  auto rdp = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * L::kStageBytes);
  };
  auto kdp = [&](int st) { return rdp(st) + (kOut ? NC * kPlane : 0); };
  auto vsp = [&](int st) { return kdp(st) + NC * kPlane; };
  auto ois = [&](int st) {
    return reinterpret_cast<float*>(vsp(st) + NI * kPlane);
  };
  auto els = [&](int st) { return ois(st) + (kOut ? kChunk * kNS : 0); };
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
      if (tid < NC * kChunk * kMaxK / 8) {  // (r_dec and) k_dec planes
        if constexpr (kOut)
          scan::cp_async16(rdp(st) + pr * kNS + pc,
                           planes + 2 * Sc::kRdec + pr * kMaxK + pc, 16);
        scan::cp_async16(kdp(st) + pr * kNS + pc,
                         planes + 2 * Sc::kKdec + pr * kMaxK + pc, 16);
      } else if (tid >= 256) {
        if constexpr (kOut)
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
    if constexpr (kOut) {
      scan::stage<bf16, 1, NC * kChunk, kMaxK, kThreads>(
          rdp(st), kNS, 0, planes + 2 * Sc::kRdec, kMaxK, NC * kChunk, kMaxK,
          true, tid);
      scan::stage_words<kChunk, kMaxK, kThreads>(ois(st), kNS, in + Sc::kOi,
                                                 kMaxK, tid);
    }
    scan::stage<bf16, 1, NC * kChunk, kMaxK, kThreads>(
        kdp(st), kNS, 0, planes + 2 * Sc::kKdec, kMaxK, NC * kChunk, kMaxK,
        true, tid);
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
    const bf16* kdc = kdp(st);
    const bf16* vsc = vsp(st);
    const float* elc = els(st);

    // this warp's part of r_dec·S (its 16 channels), with the state before
    // this chunk, to the slice's reduction tiles
    if constexpr (kOut) {
      uint32_t af[NC][4];
#pragma unroll
      for (int pp = 0; pp < NC; ++pp)
        scan::ldsm_x4(rdp(st) + pp * kPlane + (lane & 15) * kNS + d0 +
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
    if constexpr (kOut) {
      scan::group_sync(1 + sl, 4 * 32);
      const int t = qu * 4 + (lane >> 3), j = 2 * (lane & 7);
      const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
      const float* part = red + sl * 4 * 256 + t * 16 + j;
      float2 sum =
          *reinterpret_cast<const float2*>(ois(st) + t * kNS + j0 + j);
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

// pass A of the forward, one block of 5 warps per (batch, chunk, head)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    wkv6_intra_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ log_w,
                      const float* __restrict__ u, float* __restrict__ scr,
                      int s_len, int c0, int n_run, int h, int dk, int vec) {
  intra_pass<T, true>(r, k, v, log_w, u, scr, s_len, c0, n_run, h, dk, vec);
}

// pass B of the forward, one block of 16 warps per batch·head
template <typename T>
__global__ void __launch_bounds__(kStateWarps * 32)
    wkv6_state_kernel(const T* __restrict__ v, const float* __restrict__ scr,
                      const float* __restrict__ s0, int s0_stride,
                      T* __restrict__ o, float* __restrict__ s_out,
                      float* __restrict__ states, int s_len, int c0,
                      int n_run, int every, int h, int dk, int vec) {
  state_pass<T, true>(v, scr, s0, s0_stride, o, s_out, states, s_len, c0,
                      n_run, every, h, dk, vec);
}

// the recompute's pass A: k_dec and exp(p_last) only
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    wkv6_recompute_intra_kernel(const T* __restrict__ k,
                                const float* __restrict__ log_w,
                                float* __restrict__ scr, int s_len, int c0,
                                int n_run, int h, int dk) {
  intra_pass<T, false>(nullptr, k, nullptr, log_w, nullptr, scr, s_len, c0,
                       n_run, h, dk, 0);
}

// the recompute's pass B: every chunk's incoming state, no output
template <typename T>
__global__ void __launch_bounds__(kStateWarps * 32)
    wkv6_recompute_state_kernel(const T* __restrict__ v,
                                const float* __restrict__ scr,
                                const float* __restrict__ s0, int s0_stride,
                                float* __restrict__ states, int s_len,
                                int c0, int n_run, int h, int dk, int vec) {
  state_pass<T, false>(v, scr, s0, s0_stride, nullptr, nullptr, states,
                       s_len, c0, n_run, 1, h, dk, vec);
}

// Floats of pass A's scratch over n_run chunks, with the output or
// state-only.
inline long long scratch_floats(int b, int n_run, int h, int is_bf16,
                                bool out) {
  const int per =
      out ? (is_bf16 ? Scratch<Parts<bf16>::kCalc, true>::kPer
                     : Scratch<Parts<float>::kCalc, true>::kPer)
          : (is_bf16 ? Scratch<Parts<bf16>::kCalc, false>::kPer
                     : Scratch<Parts<float>::kCalc, false>::kPer);
  return static_cast<long long>(b) * n_run * h * per;
}

// The forward over chunks c0 .. c0 + n_run - 1 (wkv6.cu's wkv6_launch):
// two launches on `stream`.
template <typename T>
cudaError_t launch_forward(const void* r, const void* k, const void* v,
                           const void* log_w, const void* u, const void* s0,
                           int s0_stride, void* scratch, void* o, void* s_out,
                           void* states, int b, int s_len, int h, int dk,
                           int vec, int c0, int n_run, int every,
                           cudaStream_t stream) {
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
      wkv6_state_kernel<T>, StateSmem<T, true>::kBytes, raised);
  if (err != cudaSuccess) return err;
  wkv6_state_kernel<T><<<b * h, kStateWarps * 32,
                         StateSmem<T, true>::kBytes, stream>>>(
      static_cast<const T*>(v), static_cast<const float*>(scratch),
      static_cast<const float*>(s0), s0_stride, static_cast<T*>(o),
      static_cast<float*>(s_out), static_cast<float*>(states), s_len, c0,
      n_run, every, h, dk, vec);
  return cudaGetLastError();
}

// The states of chunks c0 .. c0 + n_run - 1 from s0 (read with a stride:
// a checkpoint), every chunk's incoming state to `states` [b, h, n_run,
// dk, dk]: the state-only passes, two launches on `stream`.  scratch holds
// scratch_floats(b, n_run, h, is_bf16, false) floats.
template <typename T>
cudaError_t launch_recompute(const void* k, const void* v, const void* log_w,
                             const void* s0, int s0_stride, void* scratch,
                             void* states, int b, int s_len, int h, int dk,
                             int vec, int c0, int n_run,
                             cudaStream_t stream) {
  if (n_run <= 0) return cudaSuccess;
  wkv6_recompute_intra_kernel<T><<<dim3(b * n_run, h), kWarps * 32, 0,
                                   stream>>>(
      static_cast<const T*>(k), static_cast<const float*>(log_w),
      static_cast<float*>(scratch), s_len, c0, n_run, h, dk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static bool raised[64] = {};
  err = scan::raise_smem(wkv6_recompute_state_kernel<T>,
                         StateSmem<T, false>::kBytes, raised);
  if (err != cudaSuccess) return err;
  wkv6_recompute_state_kernel<T><<<b * h, kStateWarps * 32,
                                   StateSmem<T, false>::kBytes, stream>>>(
      static_cast<const T*>(v), static_cast<const float*>(scratch),
      static_cast<const float*>(s0), s0_stride, static_cast<float*>(states),
      s_len, c0, n_run, h, dk, vec);
  return cudaGetLastError();
}

}  // namespace wkv6_fwd
