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
// (float32), from the forward's kept incoming states (`ssd.cu`,
// `states`): every chunk's, or every 16th chunk's, the checkpoints of the
// reference's `chunk_scan_checkpointed`.
//
// Per chunk of 16 tokens and head, with p the inclusive running sum of la
// (every exponent p_t - p_s, s <= t, clamped at 0 as in the forward),
// E[t][s] = exp(p_t - p_s) and G[t][s] = (C_t·B_s)·E[t][s] for s <= t,
// w_s = exp(p_last - p_s), S_in the chunk's incoming state and dS_out the
// gradient of its outgoing one:
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
// writes dx, dB, dC, ddt: ~0.65 GB for zamba2-7b at 4,096 tokens (112 heads
// of 64, ds 64, bf16; the states 0.47 GB of it), ~0.19 ms at 3.35 TB/s;
// its products are ~20 GFLOP, far less at the bf16 tensor-core rate.  The
// design adds the float32 dS_out scratch (written by the reverse pass and
// read by the chunk pass: another 0.94 GB of traffic).  On an H100 80GB
// HBM3 at 700 W (tools/scan_bwd_probe.py, bf16, 1 x 4,096 tokens) the
// reverse pass took 0.3184 ms (1.24 µs a chunk: its barrier, the copies'
// wait and two dependent `mma` rounds) and the chunk pass 0.8254 ms, with
// 215 registers two blocks an SM (at three, ptxas spilled); the first
// version took 4.4419 and 2.9240 (PERF.md, row 6b).
//
// Design: two launches per run of chunks and two for the sums, every sum
// in one fixed order (two runs give the same bits), every product on the
// tensor cores (`mma.sync` through `scan_mma.cuh`), no atomics.  From
// every state the run is the whole sequence.  From the checkpoints one C
// call (`ssd_bwd_ckpt_launch`) issues the plan of `kernels/wkv6.py::
// checkpoint_plan` as wkv6_bwd.cu does: per segment of 16 chunks from
// the last, the state-only recompute of its states (`ssd_fwd.cuh`: pass A
// writes only w and exp(p_last), pass B stages only B, x and those) on
// one side stream beside the reverse pass on another, then the chunk pass
// under the earlier segment's two walks, states and dS in two buffers of
// each used in turn, and the partials of dB, dC, dD and da_log summed
// once at the end in their fixed orders: the whole-state backward's bits,
// with two segments' float32 state and dS scratch (117 MB for zamba2-7b
// at 4,096 tokens, batch 1, against 470 MB of dS from every state).
//
// `ssd_bwd_reverse_kernel` (the reverse pass), shaped as the forward's pass
// B (`ssd_fwd.cuh::ssd_state_kernel`) walking the chunks from the last: one
// block of 16 warps per (batch·head, 64 rows of dS), each warp a 16 x 16
// piece of dS in `mma` accumulator fragments.  Per chunk it stores dS_out
// to a float32 scratch [B, H, n_run, hd, ds] (470 MB for zamba2-7b at
// 4,096 tokens from every state, 29.4 MB for a segment), forms p by a
// warp scan of la and updates dS = exp(p_last)·dS + (exp(p)∘dY)ᵀ·C on
// `mma`; dY, C and dt are staged by
// `cp.async` into a ring of shared stages three chunks ahead of the one
// computed, each thread with fixed copy slots.  dS of the first chunk goes
// out as ds0.
//
// `ssd_bwd_intra_kernel` (the chunk-parallel pass), one block of 4 warps
// per (batch, chunk, 8 heads): C·Bᵀ once per block, then per head, in head
// order, x, dY (bf16 planes, `cp.async`), S_in and dS_out (float32, by
// `cp.async`, split into parts as the fragments are built) staged in shared
// memory, and on `mma`: the pair table dY·xᵀ, dY·S_in and x·dS_out (each
// warp 16 state columns), B·dS_outᵀ and Gᵀ·dY (16 head columns a warp,
// giving dx at once), then (E∘dt∘(x·dY))·B and (E∘(x·dY))ᵀ·C into the
// head's dC^h and dB^h.  Each warp keeps the same 16 state columns of dB
// and dC for every head in its accumulators, so their sums over the
// block's heads run in head order; the blocks' sums go to a scratch
// buffer [B, S, groups, ds] that `ssd_bwd_sum_kernel` adds up in group
// order, and D's and a_log's per-chunk partials likewise
// (`ssd_bwd_head_kernel`).  The per-token sums of the log-decay gradient
// run on one warp, a token a lane.
//
// Precision (scan_mma.cuh): in the bf16 instance x, dY, B and C enter the
// `mma`s exactly; the states, dS and every computed operand are split into
// two bf16 parts.  The float32 instance splits every operand into three.
//
// Ragged widths: ds is zero-padded to 64 (the products over it stop at the
// multiple of 16 that covers it), hd is walked in pieces of 64; a width
// that is not a multiple of 8 (x, B, C) or of 4 (the states), or float32
// inputs, is staged element by element.
#include "scan_ckpt.cuh"
#include "scan_mma.cuh"
#include "ssd_fwd.cuh"

namespace {

using scan::bf16;
using scan::Parts;

constexpr int kChunk = 16;            // tokens per chunk
constexpr int kSegment = 16;          // chunks between two checkpoints
constexpr int kMaxN = 64;             // largest state size ds taken
constexpr int kMaxHd = 256;           // largest head size hd taken
constexpr int kNS = kMaxN + 8;        // bf16 row stride of plane tiles
constexpr int kFS = kMaxN + 4;        // float row stride of state tiles
constexpr int kPlane = kChunk * kNS;  // elements of one bf16 plane
constexpr int kRevWarps = 16;         // reverse pass: 4 x 4 pieces
constexpr int kWarps = 4;             // chunk pass
constexpr int kThreads = kWarps * 32;
constexpr int kHeads = 8;             // heads per chunk-pass block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
  return a;
}

// p (inclusive running sum of la = -a·dt over the chunk) in lanes 0..15,
// by the forward's warp scan; lanes past 15 hold partial sums, unused
__device__ __forceinline__ float scan_la(float dtl, float a, int lane) {
  float p = -a * dtl;
#pragma unroll
  for (int off = 1; off < kChunk; off <<= 1) {
    const float v = __shfl_up_sync(kFull, p, off);
    if (lane >= off) p += v;
  }
  return p;
}

// the reverse pass's dynamic shared memory: kStages stages of the dY and C
// planes and dt
template <typename T>
struct RevSmem {
  static constexpr int kStages = 4;
  static constexpr int kAhead = kStages - 1;
  static constexpr int kStageBytes =
      2 * Parts<T>::kIn * kPlane * 2 + kChunk * 4;
  static constexpr int kBytes = kStages * kStageBytes;
};

template <typename T>
__global__ void __launch_bounds__(kRevWarps * 32, 1)
    ssd_bwd_reverse_kernel(const T* __restrict__ cm,
                           const float* __restrict__ dt,
                           const float* __restrict__ a_log,
                           const T* __restrict__ dy,
                           const float* __restrict__ dst,
                           float* __restrict__ dstates,
                           float* __restrict__ ds0, int s_len, int c0,
                           int n_run, int h, int hd, int ds, int vec_x,
                           int vec_bc) {
  constexpr int NI = Parts<T>::kIn, NC = Parts<T>::kCalc;
  using L = RevSmem<T>;
  constexpr int kStages = L::kStages, kAhead = L::kAhead;
  constexpr int kThr = kRevWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  // stage st: dY planes, C planes, dt
  auto tile = [&](int st, int which) {
    return reinterpret_cast<bf16*>(smem + st * L::kStageBytes) +
           which * NI * kPlane;
  };
  auto dts = [&](int st) { return reinterpret_cast<float*>(tile(st, 2)); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int sl = warp >> 2, qu = warp & 3;   // 16 rows, 16 state columns
  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const int i0b = blockIdx.y * kMaxN, ncb = min(kMaxN, hd - i0b);
  const int iw = sl * 16, n0 = qu * 16;
  const int i0 = i0b + iw, nri = min(16, hd - i0);
  const int64_t xp = static_cast<int64_t>(h) * hd;   // dY between tokens
  const float a = expf(a_log[head]);
  float* const dsb = dstates + static_cast<int64_t>(bh) * n_run * hd * ds;

  // this warp's piece dS[i0 + i][n0 + n]: acc[nt] holds rows g and g + 8,
  // columns 8·nt + 2q and + 1
  float acc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = g + (e >> 1) * 8, n = n0 + nt * 8 + 2 * q + (e & 1);
      acc[nt][e] = (dst && i < nri && n < ds)
                       ? dst[(static_cast<int64_t>(bh) * hd + i0 + i) * ds + n]
                       : 0.f;
    }

  // the bf16 path's fixed copy slots (one 16-byte copy a thread), as
  // sources at chunk 0 that move by a fixed stride a chunk
  const int sr = (tid & 127) >> 3, scol = (tid & 7) * 8;
  const int64_t row0 = static_cast<int64_t>(b) * s_len + sr;
  const T* src_c = cm + row0 * ds + scol;                  // tid < 128
  const T* src_y = dy + row0 * xp + static_cast<int64_t>(head) * hd + i0b +
                   scol;                                    // 128 <= tid < 256
  auto load = [&](int c, int st) {
    const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
    const int64_t brow = static_cast<int64_t>(b) * s_len + t0;
    if (tid >= 256 && tid < 256 + kChunk) {  // dt, zeros past the end
      const int t = tid - 256;
      const bool ok = t < nr;
      scan::cp_async4(dts(st) + t, ok ? dt + (brow + t) * h + head : dt,
                      ok ? 4 : 0);
    }
    if (NI == 1 && vec_x && vec_bc) {
      if (tid < 128) {
        const bool ok = sr < nr && scol < ds;
        scan::cp_async16(tile(st, 1) + sr * kNS + scol,
                         ok ? src_c + static_cast<int64_t>(t0) * ds : cm,
                         ok ? 16 : 0);
      } else if (tid < 256) {
        const bool ok = sr < nr && scol < ncb;
        scan::cp_async16(tile(st, 0) + sr * kNS + scol,
                         ok ? src_y + static_cast<int64_t>(t0) * xp : dy,
                         ok ? 16 : 0);
      }
      return;
    }
    scan::stage<T, NI, kChunk, kMaxN, kThr>(
        tile(st, 0), kNS, kPlane,
        dy + brow * xp + static_cast<int64_t>(head) * hd + i0b, xp, nr, ncb,
        vec_x, tid);
    scan::stage<T, NI, kChunk, kMaxN, kThr>(tile(st, 1), kNS, kPlane,
                                            cm + brow * ds, ds, nr, ds,
                                            vec_bc, tid);
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
      float* out = dsb + static_cast<int64_t>(c - c0) * hd * ds;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = g + (e >> 1) * 8, n = n0 + nt * 8 + 2 * q + (e & 1);
          if (i < nri && n < ds)
            out[static_cast<int64_t>(i0 + i) * ds + n] = acc[nt][e];
        }
    }
    const float p = scan_la(lane < kChunk ? dts(st)[lane] : 0.f, a, lane);
    const float ep = expf(p);
    const float el = expf(__shfl_sync(kFull, p, kChunk - 1));
    const float w[4] = {__shfl_sync(kFull, ep, 2 * q),
                        __shfl_sync(kFull, ep, 2 * q + 1),
                        __shfl_sync(kFull, ep, 2 * q + 8),
                        __shfl_sync(kFull, ep, 2 * q + 9)};
    // (exp(p)∘dY)ᵀ [i x t] as an A fragment, C [t x n] as B fragments
    uint32_t yr[NI][4], af[NC][4];
#pragma unroll
    for (int pp = 0; pp < NI; ++pp)
      scan::ldsm_x4_trans(tile(st, 0) + pp * kPlane +
                              ((lane >> 4) * 8 + (lane & 7)) * kNS + iw +
                              ((lane >> 3) & 1) * 8,
                          yr[pp]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float2 v = make_float2(0.f, 0.f);
#pragma unroll
      for (int pp = 0; pp < NI; ++pp) {
        const float2 u = scan::unpack(yr[pp][r]);
        v.x += u.x;
        v.y += u.y;
      }
      const int wj = r >= 2 ? 2 : 0;
      uint32_t parts[NC];
      scan::split2<NC>(v.x * w[wj], v.y * w[wj + 1], parts);
#pragma unroll
      for (int pp = 0; pp < NC; ++pp) af[pp][r] = parts[pp];
    }
    uint32_t bt[2][NI][2];
    scan::ldsm_b_kn<NI>(tile(st, 1), kNS, kPlane, n0, lane, bt);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= el;
      scan::mma_parts<NC, NI>(acc[nt], af, bt[nt]);
    }
  }
  if (ds0) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g + (e >> 1) * 8, n = n0 + nt * 8 + 2 * q + (e & 1);
        if (i < nri && n < ds)
          ds0[(static_cast<int64_t>(bh) * hd + i0 + i) * ds + n] = acc[nt][e];
      }
  }
}

// the chunk pass's dynamic shared memory, in bytes from the start: C, B,
// x and dY planes; S_in and dS_out (float32, a piece of 64 rows); C·Bᵀ,
// the pair tables and the per-warp partial sums
template <typename T>
struct IntraSmem {
  static constexpr int kPlanes = Parts<T>::kIn * kPlane * 2;  // bytes
  static constexpr int kC = 0, kB = kPlanes, kX = 2 * kPlanes,
                       kY = 3 * kPlanes;
  static constexpr int kSin = 4 * kPlanes;
  static constexpr int kDso = kSin + kMaxN * kFS * 4;
  static constexpr int kTab = kDso + kMaxN * kFS * 4;
  // floats from kTab: cb, xd, gx and the prefix table [16][17]; per-warp
  // pair partials [4][16][16]; per-warp xsb, csd [4][16]; per-warp
  // Σ S_in∘dS_out [4]; dt of two heads [2][16]; p, exp(p), w [16]
  static constexpr int kCb = 0, kXd = kCb + kChunk * 17,
                       kGx = kXd + kChunk * 17, kPre = kGx + kChunk * 17,
                       kXdp = kPre + kChunk * 17, kXsb = kXdp + kWarps * 256,
                       kCsd = kXsb + kWarps * 16, kSo = kCsd + kWarps * 16,
                       kDt = kSo + kWarps, kP = kDt + 2 * kChunk,
                       kEp = kP + kChunk, kWl = kEp + kChunk,
                       kFloats = kWl + kChunk;
  static constexpr int kBytes = kTab + kFloats * 4;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_intra_kernel(const T* __restrict__ x, const T* __restrict__ bm,
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
                         float* __restrict__ da_part, int s_len, int c0,
                         int n_run, int h, int hd, int ds, int vec_x,
                         int vec_bc, int vec_s) {
  constexpr int NI = Parts<T>::kIn, NC = Parts<T>::kCalc;
  using L = IntraSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* cs = reinterpret_cast<bf16*>(smem + L::kC);
  bf16* bs = reinterpret_cast<bf16*>(smem + L::kB);
  bf16* xs = reinterpret_cast<bf16*>(smem + L::kX);
  bf16* ys = reinterpret_cast<bf16*>(smem + L::kY);
  float* sin = reinterpret_cast<float*>(smem + L::kSin);
  float* dso = reinterpret_cast<float*>(smem + L::kDso);
  float* tab = reinterpret_cast<float*>(smem + L::kTab);
  float (*cb)[17] = reinterpret_cast<float (*)[17]>(tab + L::kCb);
  float (*xdt)[17] = reinterpret_cast<float (*)[17]>(tab + L::kXd);
  float (*gxt)[17] = reinterpret_cast<float (*)[17]>(tab + L::kGx);
  float (*pre)[17] = reinterpret_cast<float (*)[17]>(tab + L::kPre);
  float* xdp = tab + L::kXdp;
  float* xsbp = tab + L::kXsb;
  float* csdp = tab + L::kCsd;
  float* sop = tab + L::kSo;
  float* dt2 = tab + L::kDt;   // dt of the head and of the next one
  float* ps = tab + L::kP;
  float* eps = tab + L::kEp;
  float* wls = tab + L::kWl;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.x / n_run, ir = blockIdx.x % n_run, c = c0 + ir;
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int group = blockIdx.y, n_groups = gridDim.y;
  const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
  const int64_t row0 = static_cast<int64_t>(b) * s_len + t0;
  const int64_t xp = static_cast<int64_t>(h) * hd;   // x between tokens
  const int64_t mat = static_cast<int64_t>(hd) * ds;
  const int dsp = (ds + 15) & ~15;
  const int w16 = warp * 16;   // this warp's 16 state (or head) columns

  scan::stage<T, NI, kChunk, kMaxN, kThreads>(cs, kNS, kPlane, cm + row0 * ds,
                                              ds, nr, ds, vec_bc, tid);
  scan::stage<T, NI, kChunk, kMaxN, kThreads>(bs, kNS, kPlane, bm + row0 * ds,
                                              ds, nr, ds, vec_bc, tid);
  scan::cp_async_commit();
  scan::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) {  // C·Bᵀ [16 t x 16 s], once for the block's heads
    float acc[2][4] = {};
    for (int kk = 0; kk < dsp; kk += 16) {
      uint32_t af[NI][4], bt[2][NI][2];
      scan::ldsm_a<NI>(cs, kNS, kPlane, kk, lane, af);
      scan::ldsm_b_nk<NI>(bs, kNS, kPlane, kk, lane, bt);
      scan::mma_parts<NI, NI>(acc[0], af, bt[0]);
      scan::mma_parts<NI, NI>(acc[1], af, bt[1]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cb[g + (e >> 1) * 8][nt * 8 + 2 * q + (e & 1)] = acc[nt][e];
  }
  // this warp's 16 state columns of the block's Σ_h dC^h [t x n] and
  // Σ_h dB^h [s x n]
  float dc_acc[2][4] = {}, db_acc[2][4] = {};

  // x, dY, S_in and dS_out rows i0.. of head `head` (and its dt, at i0 = 0,
  // into dt2 + 16·(hh & 1)) into shared memory; commit is the caller's
  auto stage_piece = [&](int hh, int i0) {
    const int head = group * kHeads + hh;
    const int ncb = min(kMaxN, hd - i0);
    const int64_t bh = static_cast<int64_t>(b) * h + head;
    const float* s_in_g = states + (bh * n_run + ir) * mat;
    const float* ds_out_g = dstates + (bh * n_run + ir) * mat;
    const int64_t xbase = row0 * xp + static_cast<int64_t>(head) * hd;
    scan::stage<T, NI, kChunk, kMaxN, kThreads>(
        xs, kNS, kPlane, x + xbase + i0, xp, nr, ncb, vec_x, tid);
    scan::stage<T, NI, kChunk, kMaxN, kThreads>(
        ys, kNS, kPlane, dy + xbase + i0, xp, nr, ncb, vec_x, tid);
    if (vec_s) {  // 4 floats a copy
#pragma unroll 2
      for (int e = tid; e < kMaxN * kMaxN / 4; e += kThreads) {
        const int i = e / (kMaxN / 4), n = (e % (kMaxN / 4)) * 4;
        const bool ok = i < ncb && n < ds;
        const int64_t off = static_cast<int64_t>(i0 + i) * ds + n;
        scan::cp_async16(sin + i * kFS + n, ok ? s_in_g + off : s_in_g,
                         ok ? 16 : 0);
        scan::cp_async16(dso + i * kFS + n, ok ? ds_out_g + off : ds_out_g,
                         ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kMaxN * kMaxN; e += kThreads) {
        const int i = e / kMaxN, n = e % kMaxN;
        const bool ok = i < ncb && n < ds;
        const int64_t off = static_cast<int64_t>(i0 + i) * ds + n;
        sin[i * kFS + n] = ok ? s_in_g[off] : 0.f;
        dso[i * kFS + n] = ok ? ds_out_g[off] : 0.f;
      }
    }
    if (i0 == 0 && tid < kChunk)
      scan::cp_async4(dt2 + (hh & 1) * kChunk + tid,
                      tid < nr ? dt + (row0 + tid) * h + head : dt,
                      tid < nr ? 4 : 0);
  };
  stage_piece(0, 0);   // the first head's first piece
  scan::cp_async_commit();

  for (int hh = 0; hh < kHeads; ++hh) {
    const int head = group * kHeads + hh;
    if (head >= h) break;  // uniform over the block
    const int64_t xbase = row0 * xp + static_cast<int64_t>(head) * hd;
    const float a = expf(a_log[head]), dsk = d_skip[head];
    const float* dts = dt2 + (hh & 1) * kChunk;

    float xd_acc[2][4] = {}, dsi[2][4] = {}, xds[2][4] = {};
    float xsb2[2] = {0.f, 0.f}, so = 0.f;
    float p = 0.f, dtl = 0.f, wl = 0.f;   // lane t: p_t, dt_t, w_t
    for (int i0 = 0; i0 < hd; i0 += kMaxN) {   // 64 head rows at a time
      const int ncb = min(kMaxN, hd - i0);
      if (i0 > 0) {   // piece 0 was staged ahead
        __syncthreads();  // the previous piece's readers are done
        stage_piece(hh, i0);
        scan::cp_async_commit();
      }
      scan::cp_async_wait<0>();
      __syncthreads();

      if (i0 == 0) {  // the decays, in every warp's lanes
        dtl = lane < kChunk ? dts[lane] : 0.f;
        p = scan_la(dtl, a, lane);
        const float p_last = __shfl_sync(kFull, p, kChunk - 1);
        wl = expf(fminf(p_last - p, 0.f));
        if (warp == 0 && lane < kChunk) {  // read after the next barrier
          ps[lane] = p;
          eps[lane] = expf(p);
          wls[lane] = wl;
        }
      }
      // Σ S_in∘dS_out, this thread's share, in a fixed order
#pragma unroll 2
      for (int e = tid; e < kMaxN * kMaxN / 4; e += kThreads) {
        const int i = e / (kMaxN / 4), n = (e % (kMaxN / 4)) * 4;
        const float4 u = *reinterpret_cast<const float4*>(sin + i * kFS + n);
        const float4 v = *reinterpret_cast<const float4*>(dso + i * kFS + n);
        so += (u.x * v.x + u.y * v.y) + (u.z * v.z + u.w * v.w);
      }
      // the pair table's part over this warp's 16 head rows: dY·xᵀ
      if (w16 < ncb) {
        uint32_t af[NI][4], bt[2][NI][2];
        scan::ldsm_a<NI>(ys, kNS, kPlane, w16, lane, af);
        scan::ldsm_b_nk<NI>(xs, kNS, kPlane, w16, lane, bt);
        scan::mma_parts<NI, NI>(xd_acc[0], af, bt[0]);
        scan::mma_parts<NI, NI>(xd_acc[1], af, bt[1]);
      }
      // dY·S_in and x·dS_out at this warp's 16 state columns
      for (int kk = 0; kk < ncb; kk += 16) {
        uint32_t ya[NI][4], xa[NI][4];
        scan::ldsm_a<NI>(ys, kNS, kPlane, kk, lane, ya);
        scan::ldsm_a<NI>(xs, kNS, kPlane, kk, lane, xa);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t sb[NC][2], db[NC][2];
          scan::frag_b_rows<NC>(sin + kk * kFS + w16 + nt * 8, kFS, lane, sb);
          scan::frag_b_rows<NC>(dso + kk * kFS + w16 + nt * 8, kFS, lane, db);
          scan::mma_parts<NI, NC>(dsi[nt], ya, sb);
          scan::mma_parts<NI, NC>(xds[nt], xa, db);
        }
      }
      // B·dS_outᵀ and Gᵀ·dY at this warp's 16 head columns, then dx
      if (w16 < ncb) {
        const float wlr[2] = {__shfl_sync(kFull, wl, g),
                              __shfl_sync(kFull, wl, g + 8)};
        const float dtr[2] = {__shfl_sync(kFull, dtl, g),
                              __shfl_sync(kFull, dtl, g + 8)};
        float sbv[2][4] = {}, gd[2][4] = {};
        for (int kk = 0; kk < dsp; kk += 16) {
          uint32_t ba[NI][4];
          scan::ldsm_a<NI>(bs, kNS, kPlane, kk, lane, ba);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t db[NC][2];
            scan::frag_b_cols<NC>(dso + (w16 + nt * 8) * kFS + kk, kFS, lane,
                                  db);
            scan::mma_parts<NI, NC>(sbv[nt], ba, db);
          }
        }
        {
          uint32_t gda[NC][4], bt[2][NI][2];   // Gᵀ [s x t], k = t
          scan::frag_a<NC>(
              [&](int s, int t) {
                const float pt = __shfl_sync(kFull, p, t);
                const float psv = __shfl_sync(kFull, p, s);
                return t >= s ? cb[t][s] * expf(fminf(pt - psv, 0.f)) : 0.f;
              },
              lane, gda);
          scan::ldsm_b_kn<NI>(ys, kNS, kPlane, w16, lane, bt);
          scan::mma_parts<NC, NI>(gd[0], gda, bt[0]);
          scan::mma_parts<NC, NI>(gd[1], gda, bt[1]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = g + (e >> 1) * 8, ic = w16 + nt * 8 + 2 * q + (e & 1);
            const float yv = scan::plane_at<NI>(ys, kNS, kPlane, s, ic);
            const float xv = scan::plane_at<NI>(xs, kNS, kPlane, s, ic);
            xsb2[e >> 1] += xv * sbv[nt][e];
            if (s < nr && ic < ncb)
              dx[xbase + s * xp + i0 + ic] = scan::from_f<T>(
                  dtr[e >> 1] * (gd[nt][e] + wlr[e >> 1] * sbv[nt][e]) +
                  dsk * yv);
          }
      }
    }

    // the warps' partial sums to shared memory
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = xsb2[hf];
      v += __shfl_xor_sync(kFull, v, 1);
      v += __shfl_xor_sync(kFull, v, 2);
      if (q == 0) xsbp[warp * 16 + g + 8 * hf] = v;
    }
    so = warp_sum(so);
    if (lane == 0) sop[warp] = so;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xdp[warp * 256 + (g + (e >> 1) * 8) * 16 + nt * 8 + 2 * q + (e & 1)] =
            xd_acc[nt][e];
    {  // C_t·(S_inᵀ dY_t) over this warp's 16 state columns
      float cv[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cv[e >> 1] += scan::plane_at<NI>(cs, kNS, kPlane, g + (e >> 1) * 8,
                                           w16 + nt * 8 + 2 * q + (e & 1)) *
                        dsi[nt][e];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float v = cv[hf];
        v += __shfl_xor_sync(kFull, v, 1);
        v += __shfl_xor_sync(kFull, v, 2);
        if (q == 0) csdp[warp * 16 + g + 8 * hf] = v;
      }
    }
    __syncthreads();
    // x, dY, S_in and dS_out are read no more: the next head's first piece
    // goes in flight behind the rest of this one
    if (hh + 1 < kHeads && head + 1 < h) {
      stage_piece(hh + 1, 0);
      scan::cp_async_commit();
    }
    // the pair table x_s·dY_t (the warps' parts in warp order), G∘(x·dY)
    // and its prefix sums Σ_{s<τ} dt_s·G[t][s](x_s·dY_t), a row t to 8
    // threads, two columns s each
    {
      const int t = tid >> 3, s0 = 2 * (tid & 7);
      float m[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = s0 + j, e = t * kChunk + s;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += xdp[w * 256 + e];
        xdt[t][s] = v;
        const float gx =
            s <= t ? cb[t][s] * expf(fminf(ps[t] - ps[s], 0.f)) * v : 0.f;
        gxt[t][s] = gx;
        m[j] = dts[s] * gx;
      }
      const float pair = m[0] + m[1];
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        const float v = __shfl_up_sync(kFull, incl, off, 8);
        if ((tid & 7) >= off) incl += v;
      }
      pre[t][s0] = incl - pair;
      pre[t][s0 + 1] = incl - pair + m[0];
    }
    __syncthreads();

    // the head's dC^h = (E∘dt∘(x·dY))·B + exp(p)·(dY·S_in) and
    // dB^h = dt∘((E∘(x·dY))ᵀ·C + w·(x·dS_out)) at this warp's columns
    {
      uint32_t wa[NC][4], bt[2][NI][2];
      scan::frag_a<NC>(
          [&](int t, int s) {
            return s <= t ? expf(fminf(ps[t] - ps[s], 0.f)) * dts[s] *
                                xdt[t][s]
                          : 0.f;
          },
          lane, wa);
      scan::ldsm_b_kn<NI>(bs, kNS, kPlane, w16, lane, bt);
      float dc1[2][4] = {};
      scan::mma_parts<NC, NI>(dc1[0], wa, bt[0]);
      scan::mma_parts<NC, NI>(dc1[1], wa, bt[1]);
      scan::frag_a<NC>(
          [&](int s, int t) {
            return t >= s ? expf(fminf(ps[t] - ps[s], 0.f)) * xdt[t][s] : 0.f;
          },
          lane, wa);
      scan::ldsm_b_kn<NI>(cs, kNS, kPlane, w16, lane, bt);
      float db1[2][4] = {};
      scan::mma_parts<NC, NI>(db1[0], wa, bt[0]);
      scan::mma_parts<NC, NI>(db1[1], wa, bt[1]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + (e >> 1) * 8;
          dc_acc[nt][e] += dc1[nt][e] + eps[r] * dsi[nt][e];
          db_acc[nt][e] += dts[r] * (db1[nt][e] + wls[r] * xds[nt][e]);
        }
    }
    if (warp == 0) {  // ddt and the log-decay sums, a token τ a lane
      const int tau = lane;
      const bool in = tau < kChunk;
      float xsb = 0.f, csd = 0.f, sov = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (in) {
          xsb += xsbp[w * 16 + tau];
          csd += csdp[w * 16 + tau];
        }
        sov += sop[w];
      }
      float direct = 0.f, rect = 0.f;   // Σ_{t>=τ} of G∘(x·dY) and of
      if (in) {                         // its prefixes
#pragma unroll
        for (int t = 0; t < kChunk; ++t)
          if (t >= tau) {
            direct += gxt[t][tau];
            rect += pre[t][tau];
          }
        direct += wls[tau] * xsb;
      }
      // Σ_{t>=τ} exp(p_t)·csd_t and Σ_{s<τ} w_s dt_s xsb_s by warp scans
      float suf = in ? eps[tau] * csd : 0.f;
#pragma unroll
      for (int off = 1; off < kChunk; off <<= 1) {
        const float v = __shfl_down_sync(kFull, suf, off);
        if (tau + off < kChunk) suf += v;
      }
      const float bef = in ? wls[tau] * dts[tau] * xsb : 0.f;
      float pre = bef;
#pragma unroll
      for (int off = 1; off < kChunk; off <<= 1) {
        const float v = __shfl_up_sync(kFull, pre, off);
        if (lane >= off) pre += v;
      }
      pre -= bef;
      const float inner = expf(__shfl_sync(kFull, p, kChunk - 1)) * sov;
      const float dla = rect + suf + inner + pre;
      if (in && tau < nr) ddt[(row0 + tau) * h + head] = direct - a * dla;
      const float da = warp_sum(in ? dla * (-a * dtl) : 0.f);
      const float dd = warp_sum(in ? xdt[tau][tau] : 0.f);
      if (lane == 0) {
        const int64_t at = (static_cast<int64_t>(b) * n_chunks + c) * h + head;
        dd_part[at] = dd;
        da_part[at] = da;
      }
    }
  }
  // this block's sums of dB^h and dC^h over its heads
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = g + (e >> 1) * 8, n = w16 + nt * 8 + 2 * q + (e & 1);
      if (t < nr && n < ds) {
        const int64_t at = ((row0 + t) * n_groups + group) * ds + n;
        db_part[at] = db_acc[nt][e];
        dc_part[at] = dc_acc[nt][e];
      }
    }
}

// dB and dC [rows, ds] in x's dtype: the head groups' sums in group order
template <typename T>
__global__ void __launch_bounds__(256)
    ssd_bwd_sum_kernel(const float* __restrict__ db_part,
                       const float* __restrict__ dc_part, T* __restrict__ db,
                       T* __restrict__ dc, int64_t n_out, int n_groups,
                       int ds) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
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
__global__ void __launch_bounds__(256)
    ssd_bwd_head_kernel(const float* __restrict__ dd_part,
                        const float* __restrict__ da_part,
                        float* __restrict__ dd, float* __restrict__ da,
                        int n_part, int h) {
  const int e = blockIdx.x * 256 + threadIdx.x;
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
cudaError_t launch_reverse(const void* cm, const void* dt, const void* a_log,
                           const void* dy, const void* dst, void* dstates,
                           void* ds0, int b, int s_len, int h, int hd, int ds,
                           int c0, int n_run, int vec_x, int vec_bc,
                           cudaStream_t stream) {
  static bool raised[64] = {};
  const cudaError_t err = scan::raise_smem(ssd_bwd_reverse_kernel<T>,
                                           RevSmem<T>::kBytes, raised);
  if (err != cudaSuccess) return err;
  ssd_bwd_reverse_kernel<T><<<dim3(b * h, (hd + kMaxN - 1) / kMaxN),
                              kRevWarps * 32, RevSmem<T>::kBytes, stream>>>(
      static_cast<const T*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(dy),
      static_cast<const float*>(dst), static_cast<float*>(dstates),
      static_cast<float*>(ds0), s_len, c0, n_run, h, hd, ds, vec_x, vec_bc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chunk(const void* x, const void* bm, const void* cm,
                         const void* dt, const void* a_log,
                         const void* d_skip, const void* dy,
                         const void* states, const void* dstates,
                         void* db_part, void* dc_part, void* dd_part,
                         void* da_part, void* dx, void* ddt, int b,
                         int s_len, int h, int hd, int ds, int c0, int n_run,
                         int vec_x, int vec_bc, int vec_s,
                         cudaStream_t stream) {
  if (n_run == 0) return cudaSuccess;
  const int n_groups = (h + kHeads - 1) / kHeads;
  static bool raised[64] = {};
  const cudaError_t err = scan::raise_smem(ssd_bwd_intra_kernel<T>,
                                           IntraSmem<T>::kBytes, raised);
  if (err != cudaSuccess) return err;
  ssd_bwd_intra_kernel<T><<<dim3(b * n_run, n_groups), kThreads,
                            IntraSmem<T>::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<const T*>(dy), static_cast<const float*>(states),
      static_cast<const float*>(dstates), static_cast<T*>(dx),
      static_cast<float*>(ddt),
      static_cast<float*>(db_part), static_cast<float*>(dc_part),
      static_cast<float*>(dd_part), static_cast<float*>(da_part), s_len, c0,
      n_run, h, hd, ds, vec_x, vec_bc, vec_s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* bm, const void* cm,
                   const void* dt, const void* a_log, const void* d_skip,
                   const void* dy, const void* states, const void* dst,
                   void* dstates, void* db_part, void* dc_part,
                   void* dd_part, void* da_part, void* dx, void* ddt,
                   void* ds0, int b, int s_len, int h, int hd, int ds,
                   int c0, int n_run, int vec_x, int vec_bc, int vec_s,
                   cudaStream_t stream) {
  const cudaError_t err =
      launch_reverse<T>(cm, dt, a_log, dy, dst, dstates, ds0, b, s_len, h,
                        hd, ds, c0, n_run, vec_x, vec_bc, stream);
  if (err != cudaSuccess) return err;
  return launch_chunk<T>(x, bm, cm, dt, a_log, d_skip, dy, states, dstates,
                         db_part, dc_part, dd_part, da_part, dx, ddt, b,
                         s_len, h, hd, ds, c0, n_run, vec_x, vec_bc, vec_s,
                         stream);
}

template <typename T>
cudaError_t launch_sums(const void* db_part, const void* dc_part,
                        const void* dd_part, const void* da_part, void* db,
                        void* dc, void* dd, void* da_log, int b, int s_len,
                        int h, int ds, cudaStream_t stream) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int n_groups = (h + kHeads - 1) / kHeads;
  const int64_t n_out = static_cast<int64_t>(b) * s_len * ds;
  if (n_out > 0) {
    ssd_bwd_sum_kernel<T><<<static_cast<unsigned>((n_out + 255) / 256), 256,
                            0, stream>>>(
        static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
        static_cast<T*>(db), static_cast<T*>(dc), n_out, n_groups, ds);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ssd_bwd_head_kernel<<<(h + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(dd_part), static_cast<const float*>(da_part),
      static_cast<float*>(dd), static_cast<float*>(da_log), b * n_chunks, h);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The workspace of a backward from the checkpoints, in floats from its
// start (each piece 16-byte aligned): two segments' incoming states and
// two segments' dS_out (used in turn, segment g in buffer g % 2), the two
// carries of dS between segments, the state update's coefficients of
// every chunk (36 floats a chunk and head, one launch at the first
// recompute) and the partials of dB, dC (per row and head group), dD and
// da_log (per batch, chunk and head).
struct CkptSpace {
  int64_t states[2], dstates[2], carry[2], rc, db_part, dc_part, dd_part,
      da_part, total;
  CkptSpace(int b, int s_len, int h, int hd, int ds) {
    auto up4 = [](int64_t n) { return (n + 3) & ~int64_t{3}; };
    const int n_chunks = (s_len + kChunk - 1) / kChunk;
    const int n_groups = (h + kHeads - 1) / kHeads;
    const int64_t mat = static_cast<int64_t>(b) * h * hd * ds;
    const int64_t seg = up4(mat * kSegment);
    const int64_t rows = up4(static_cast<int64_t>(b) * s_len * n_groups * ds);
    const int64_t heads = up4(static_cast<int64_t>(b) * n_chunks * h);
    int64_t at = 0;
    for (int i = 0; i < 2; ++i) states[i] = at, at += seg;
    for (int i = 0; i < 2; ++i) dstates[i] = at, at += seg;
    for (int i = 0; i < 2; ++i) carry[i] = at, at += up4(mat);
    rc = at;
    at += up4(ssd_fwd::scratch_floats(b, n_chunks, h, hd, false));
    db_part = at, at += rows;
    dc_part = at, at += rows;
    dd_part = at, at += heads;
    da_part = at, at += heads;
    total = at;
  }
};

template <typename T>
cudaError_t launch_ckpt(const void* x, const void* bm, const void* cm,
                        const void* dt, const void* a_log, const void* d_skip,
                        const void* dy, const float* ckpt, const void* dst,
                        void* dx, void* db, void* dc, void* ddt,
                        void* da_log, void* dd, void* ds0, float* work,
                        const int* plan, int n_steps, int b, int s_len, int h,
                        int hd, int ds, int device, cudaStream_t caller) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int n_seg = n_chunks / kSegment;
  const CkptSpace sp(b, s_len, h, hd, ds);
  const int64_t mat = static_cast<int64_t>(hd) * ds;
  const bool bf = sizeof(T) == 2;
  const int vec_x = bf && hd % 8 == 0 && aligned16(x) && aligned16(dy);
  const int vec_bc = bf && ds % 8 == 0 && aligned16(bm) && aligned16(cm);
  const int vec_s = ds % 4 == 0 && aligned16(work);
  bool coefficients = false;   // every chunk's, at the first recompute
  auto issue = [&](int op, int g, cudaStream_t st) -> cudaError_t {
    if (op != ckpt::kSums && (g < 0 || g >= n_seg))
      return cudaErrorInvalidValue;
    const int c0 = g * kSegment, buf = g % 2;
    switch (op) {
      case ckpt::kRecompute:
        if (!coefficients) {
          const cudaError_t err = ssd_fwd::launch_coefficients<T>(
              dt, a_log, work + sp.rc, b, s_len, h, hd, st);
          if (err != cudaSuccess) return err;
          coefficients = true;
        }
        return ssd_fwd::launch_recompute<T>(
            x, bm, ckpt + g * mat, static_cast<int>(n_seg * mat),
            work + sp.rc, work + sp.states[buf], b, s_len, h, hd, ds,
            bf && hd % 8 == 0 && aligned16(x), vec_bc, c0, kSegment, st);
      case ckpt::kReverse:
        return launch_reverse<T>(
            cm, dt, a_log, dy,
            g == n_seg - 1 ? dst : work + sp.carry[(g + 1) % 2],
            work + sp.dstates[buf], g == 0 ? ds0 : work + sp.carry[buf], b,
            s_len, h, hd, ds, c0, kSegment, vec_x, vec_bc, st);
      case ckpt::kChunkPass:
        return launch_chunk<T>(
            x, bm, cm, dt, a_log, d_skip, dy, work + sp.states[buf],
            work + sp.dstates[buf], work + sp.db_part, work + sp.dc_part,
            work + sp.dd_part, work + sp.da_part, dx, ddt, b, s_len, h, hd,
            ds, c0, kSegment, vec_x, vec_bc, vec_s, st);
      case ckpt::kSums:
        return launch_sums<T>(work + sp.db_part, work + sp.dc_part,
                              work + sp.dd_part, work + sp.da_part, db, dc,
                              dd, da_log, b, s_len, h, ds, st);
      default:
        return cudaErrorInvalidValue;
    }
  };
  return ckpt::run(plan, n_steps, device, caller, issue);
}

}  // namespace

// Head groups of the chunk pass: the partials of dB / dC per row.
extern "C" int ssd_bwd_groups(int h) { return (h + kHeads - 1) / kHeads; }

// The gradient over the chunks c0 .. c0 + n_run - 1 of the sequence: the
// reverse pass from dst, the gradient of the state after chunk
// c0 + n_run - 1 (or null: zeros), down to ds0 (or null: not wanted), the
// gradient of the state before chunk c0; then the chunk pass over the
// run.  x, dy, dx [b, s_len, h, hd] and bm, cm [b, s_len, ds] (all
// float32: is_bf16 = 0, or all bf16: is_bf16 = 1), dt and ddt [b, s_len,
// h], a_log, d_skip [h], states [b, h, n_run, hd, ds] (the run's incoming
// states: the forward's, `ssd_launch`, or a segment's recomputed from its
// checkpoint), dst and ds0 [b, h, hd, ds], all float32; scratch dstates
// [b, h, n_run, hd, ds], db_part and dc_part [b, s_len,
// ssd_bwd_groups(h), ds], dd_part and da_part [b, n_chunks, h] float32
// (the run fills its chunks' rows): contiguous, on the device; 0 < ds <=
// 64, 0 < hd <= 256.  dx and ddt receive the run's rows.  vec_x / vec_bc:
// bf16 x and dy (B and C) 16-byte aligned with hd (ds) a multiple of 8;
// vec_s: states and dstates 16-byte aligned with ds a multiple of 4: their
// tiles go by cp.async.  Two launches on `stream`; returns the first
// failing cudaGetLastError().
extern "C" int ssd_bwd_launch(const void* x, const void* bm, const void* cm,
                              const void* dt, const void* a_log,
                              const void* d_skip, const void* dy,
                              const void* states, const void* dst,
                              void* dstates, void* db_part, void* dc_part,
                              void* dd_part, void* da_part, void* dx,
                              void* ddt, void* ds0, int b, int s_len, int h,
                              int hd, int ds, int c0, int n_run, int is_bf16,
                              int vec_x, int vec_bc, int vec_s,
                              void* stream) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  if (ds <= 0 || ds > kMaxN || hd <= 0 || hd > kMaxHd || s_len < 0 ||
      c0 < 0 || n_run < 0 || c0 + n_run > n_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<bf16>(x, bm, cm, dt, a_log, d_skip, dy, states, dst,
                             dstates, db_part, dc_part, dd_part, da_part, dx,
                             ddt, ds0, b, s_len, h, hd, ds, c0, n_run, vec_x,
                             vec_bc, vec_s, st)
              : launch<float>(x, bm, cm, dt, a_log, d_skip, dy, states, dst,
                              dstates, db_part, dc_part, dd_part, da_part, dx,
                              ddt, ds0, b, s_len, h, hd, ds, c0, n_run, 0, 0,
                              vec_s, st);
  return static_cast<int>(err);
}

// dB, dC [b, s_len, ds] (x's type) and dD, da_log [h] float32: the
// partials of every chunk (`ssd_bwd_launch`) summed in fixed orders, the
// head groups' per row and the (batch, chunk) ones per head.  Two
// launches on `stream`; returns the first failing cudaGetLastError().
extern "C" int ssd_bwd_sums_launch(const void* db_part, const void* dc_part,
                                   const void* dd_part, const void* da_part,
                                   void* db, void* dc, void* dd,
                                   void* da_log, int b, int s_len, int h,
                                   int ds, int is_bf16, void* stream) {
  if (ds <= 0 || ds > kMaxN || s_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_sums<bf16>(db_part, dc_part, dd_part, da_part, db, dc,
                                  dd, da_log, b, s_len, h, ds, st)
              : launch_sums<float>(db_part, dc_part, dd_part, da_part, db,
                                   dc, dd, da_log, b, s_len, h, ds, st);
  return static_cast<int>(err);
}

// Floats of the workspace of `ssd_bwd_ckpt_launch`.
extern "C" long long ssd_bwd_ckpt_floats(int b, int s_len, int h, int hd,
                                         int ds) {
  return CkptSpace(b, s_len, h, hd, ds).total;
}

// The whole gradient from the checkpoints, in one call: the inputs and
// outputs of `ssd_bwd_launch` and `ssd_bwd_sums_launch` over the whole
// sequence (n_chunks = 16·n_seg, n_seg >= 2), ckpt [b, h, n_seg, hd, ds]
// float32 the forward's incoming state of every 16th chunk (`ssd_launch`
// with every = 16), ds0 (or null: not wanted); `work` holds
// ssd_bwd_ckpt_floats(b, s_len, h, hd, ds) floats, 16-byte aligned.
// Issues the n_steps rows (op, segment, stream, event) of `plan`
// (kernels/wkv6.py::checkpoint_plan) from the caller's `stream` on
// `device`: per segment the state-only recompute (ssd_fwd.cuh) from its
// checkpoint, the reverse pass and the chunk pass, then the sums; every
// launch ordered after the caller's earlier work and before its later.
// Returns the first failing CUDA error.
extern "C" int ssd_bwd_ckpt_launch(
    const void* x, const void* bm, const void* cm, const void* dt,
    const void* a_log, const void* d_skip, const void* dy, const void* ckpt,
    const void* dst, void* dx, void* db, void* dc, void* ddt, void* da_log,
    void* dd, void* ds0, void* work, const int* plan, int n_steps, int b,
    int s_len, int h, int hd, int ds, int is_bf16, int device,
    void* stream) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  if (ds <= 0 || ds > kMaxN || hd <= 0 || hd > kMaxHd || s_len < 0 ||
      n_chunks % kSegment != 0 || n_chunks < 2 * kSegment)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kept = static_cast<const float*>(ckpt);
  float* ws = static_cast<float*>(work);
  const cudaError_t err =
      is_bf16
          ? launch_ckpt<bf16>(x, bm, cm, dt, a_log, d_skip, dy, kept, dst, dx,
                              db, dc, ddt, da_log, dd, ds0, ws, plan, n_steps,
                              b, s_len, h, hd, ds, device, st)
          : launch_ckpt<float>(x, bm, cm, dt, a_log, d_skip, dy, kept, dst,
                               dx, db, dc, ddt, da_log, dd, ds0, ws, plan,
                               n_steps, b, s_len, h, hd, ds, device, st);
  return static_cast<int>(err);
}
