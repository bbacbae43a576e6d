// The two passes of the SSD forward (design: ssd.cu), shared by the
// forward's launcher (ssd.cu) and the backward's recompute from the
// checkpoints (ssd_bwd.cu).
//
// Each pass has two instances of one body: with the output (`kOut`, the
// forward: `ssd_intra_kernel`, `ssd_state_kernel`) and state-only (the
// recompute: `ssd_recompute_intra_kernel`, `ssd_recompute_state_kernel`).
// The state-only pass A writes only the state update's coefficients, w and
// exp(p_last): no C·Bᵀ, M or y_intra, and it loads neither C, B nor x; its
// scratch is the 36 coefficients per (batch, chunk, head), against
// 16·hdq + 36, so the backward runs it once for the whole sequence.  The
// state-only pass B stages only B, x and the coefficients, and keeps every
// chunk's incoming state.  Both instances
// run the same arithmetic on the values the state reads (the warp scan of
// la, w, exp(p_last), w∘x and its split, the `mma`s of the update), so
// the recomputed states are the forward's bits.
#pragma once

#include "scan_mma.cuh"

namespace ssd_fwd {

using scan::bf16;
using scan::Parts;

constexpr int kChunk = 16;           // tokens per chunk
constexpr int kMaxN = 64;            // largest state size ds taken
constexpr int kNS = kMaxN + 8;       // bf16 row stride of C, B and x tiles
constexpr int kYS = kMaxN + 8;       // float row stride of y_intra tiles
constexpr int kCoef = 36;            // w[16], exp(p)[16], exp(p_last), pad
constexpr int kHeads = 4;            // heads per pass A block, one a warp
constexpr int kWarps = 4;            // warps per pass A block
constexpr int kStateWarps = 16;      // warps per pass B block: 4 x 4 pieces
constexpr unsigned kFull = 0xffffffffu;

// pass B's dynamic shared memory: kStages stages of the (C,) B and x
// planes, (the y_intra tile) and the coefficients, then (with the output)
// each warp's part of C·Sᵀ; kAhead = 3 chunks in flight (7 measured no
// faster)
template <typename T, bool kOut>
struct StateSmem {
  static constexpr int kStages = 4;
  static constexpr int kAhead = kStages - 1;
  static constexpr int kTiles = kOut ? 3 : 2;
  static constexpr int kStageBytes =
      kTiles * Parts<T>::kIn * kChunk * kNS * 2 +
      ((kOut ? kChunk * kYS : 0) + kCoef) * 4;
  static constexpr int kBytes =
      kStages * kStageBytes + (kOut ? kStateWarps * kChunk * 16 * 4 : 0);
};

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int round64(int n) { return (n + 63) & ~63; }

// scratch layout: y_intra [B, n, H, 16, hdq] (with the output only), then
// coefficients [B, n, H, kCoef]
struct Scratch {
  int64_t y_per, y_total;
  __host__ __device__ Scratch(int b, int n, int h, int hd, bool out)
      : y_per(out ? static_cast<int64_t>(kChunk) * round64(hd) : 0),
        y_total(static_cast<int64_t>(b) * n * h * y_per) {}
  __device__ int64_t y(int64_t bch) const { return bch * y_per; }
  __device__ int64_t coef(int64_t bch) const { return y_total + bch * kCoef; }
};

template <typename T, bool kOut>
__device__ __forceinline__ void intra_pass(
    const T* __restrict__ x, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ dt,
    const float* __restrict__ a_log, const float* __restrict__ d_skip,
    float* __restrict__ scr, int s_len, int c0, int n_run, int h, int hd,
    int ds, int vec_x, int vec_bc) {
  constexpr int NI = Parts<T>::kIn, NC = Parts<T>::kCalc;
  constexpr int kPlane = kChunk * kNS;
  __shared__ __align__(16) uint16_t cs_raw[NI * kPlane];
  __shared__ __align__(16) uint16_t bs_raw[NI * kPlane];
  __shared__ __align__(16) uint16_t xs_raw[kWarps][NI * kPlane];
  __shared__ float cb[kChunk][kChunk + 1];
  bf16* cs = reinterpret_cast<bf16*>(cs_raw);
  bf16* bs = reinterpret_cast<bf16*>(bs_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.x / n_run, ir = blockIdx.x % n_run, c = c0 + ir;
  const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
  const int dsp = round16(ds), hdq = round64(hd);
  const int64_t brow = static_cast<int64_t>(b) * s_len + t0;
  const Scratch sc(gridDim.x / n_run, n_run, h, hd, kOut);

  if constexpr (kOut) {
    scan::stage<T, NI, kChunk, kMaxN, kWarps * 32>(
        cs, kNS, kPlane, cm + brow * ds, ds, nr, ds, vec_bc, tid);
    scan::stage<T, NI, kChunk, kMaxN, kWarps * 32>(
        bs, kNS, kPlane, bm + brow * ds, ds, nr, ds, vec_bc, tid);
    scan::cp_async_commit();
    scan::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) {  // C·Bᵀ [16 t x 16 s], once for the block's heads
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kMaxN / 16; ++kk) {
        if (kk * 16 >= dsp) break;
        uint32_t af[NI][4], bt[2][NI][2];
#pragma unroll
        for (int p = 0; p < NI; ++p) {
          uint32_t r[4];
          scan::ldsm_x4(cs + p * kPlane + (lane & 15) * kNS + kk * 16 +
                            (lane >> 4) * 8,
                        af[p]);
          scan::ldsm_x4(bs + p * kPlane +
                            ((lane & 7) + ((lane >> 4) << 3)) * kNS +
                            kk * 16 + ((lane >> 3) & 1) * 8,
                        r);
          bt[0][p][0] = r[0];
          bt[0][p][1] = r[1];
          bt[1][p][0] = r[2];
          bt[1][p][1] = r[3];
        }
        scan::mma_parts<NI, NI>(acc[0], af, bt[0]);
        scan::mma_parts<NI, NI>(acc[1], af, bt[1]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cb[g + (e >> 1) * 8][nt * 8 + 2 * q + (e & 1)] = acc[nt][e];
    }
    __syncthreads();
  }

  bf16* xw = reinterpret_cast<bf16*>(xs_raw[warp]);
  const int64_t xp = static_cast<int64_t>(h) * hd;  // between tokens
  {
    const int head = blockIdx.y * kHeads + warp;
    if (head >= h) return;  // uniform over the warp; no barrier follows
    const int64_t bch = (static_cast<int64_t>(b) * n_run + ir) * h + head;
    const float dtl = lane < nr ? dt[(brow + lane) * h + head] : 0.f;
    float p = -expf(a_log[head]) * dtl;  // la; lanes past nr add 0
#pragma unroll
    for (int off = 1; off < kChunk; off <<= 1) {
      const float v = __shfl_up_sync(kFull, p, off);
      if (lane >= off) p += v;
    }
    const float p_last = __shfl_sync(kFull, p, kChunk - 1);
    float* coef = scr + sc.coef(bch);
    if (lane < kChunk) {
      coef[lane] = expf(fminf(p_last - p, 0.f)) * dtl;  // w
      if constexpr (kOut) coef[kChunk + lane] = expf(p);
    }
    if (lane == 0) coef[2 * kChunk] = expf(p_last);
    if constexpr (!kOut) return;

    // M = C·Bᵀ ∘ exp(p_t - p_s) ∘ dt_s (s <= t) as the A fragment of M·x
    const float pt0 = __shfl_sync(kFull, p, g);
    const float pt1 = __shfl_sync(kFull, p, g + 8);
    // this lane's columns s = 2q, 2q + 1, 2q + 8, 2q + 9
    auto col = [&](int j) { return 2 * q + (j & 1) + (j >> 1) * 8; };
    float ps[4], dts[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ps[j] = __shfl_sync(kFull, p, col(j));
      dts[j] = __shfl_sync(kFull, dtl, col(j));
    }
    auto mval = [&](int ti, int j) {
      const int t = g + 8 * ti, s = col(j);
      return s <= t ? cb[t][s] * expf(fminf((ti ? pt1 : pt0) - ps[j], 0.f)) *
                          dts[j]
                    : 0.f;
    };
    uint32_t mf[NC][4];
    {
      uint32_t r0[NC], r1[NC], r2[NC], r3[NC];
      scan::split2<NC>(mval(0, 0), mval(0, 1), r0);
      scan::split2<NC>(mval(1, 0), mval(1, 1), r1);
      scan::split2<NC>(mval(0, 2), mval(0, 3), r2);
      scan::split2<NC>(mval(1, 2), mval(1, 3), r3);
#pragma unroll
      for (int pp = 0; pp < NC; ++pp) {
        mf[pp][0] = r0[pp];
        mf[pp][1] = r1[pp];
        mf[pp][2] = r2[pp];
        mf[pp][3] = r3[pp];
      }
    }

    const float dsk = d_skip[head];
    const int64_t xbase = brow * xp + static_cast<int64_t>(head) * hd;
    float* yi = scr + sc.y(bch);
    for (int i0 = 0; i0 < hd; i0 += kMaxN) {  // 64 columns of x at a time
      const int nc = min(kMaxN, hd - i0);
      __syncwarp();  // the previous piece's readers are done
      scan::stage<T, NI, kChunk, kMaxN, 32>(xw, kNS, kPlane, x + xbase + i0,
                                            xp, nr, nc, vec_x, lane);
      scan::cp_async_commit();
      scan::cp_async_wait<0>();
      __syncwarp();
      float ya[kMaxN / 8][4] = {};
#pragma unroll
      for (int dp = 0; dp < kMaxN / 16; ++dp) {
        uint32_t bt[2][NI][2];
#pragma unroll
        for (int pp = 0; pp < NI; ++pp) {
          uint32_t r[4];
          scan::ldsm_x4_trans(
              xw + pp * kPlane + ((lane & 7) + ((lane >> 3) & 1) * 8) * kNS +
                  dp * 16 + (lane >> 4) * 8,
              r);
          bt[0][pp][0] = r[0];
          bt[0][pp][1] = r[1];
          bt[1][pp][0] = r[2];
          bt[1][pp][1] = r[3];
        }
        scan::mma_parts<NC, NI>(ya[2 * dp], mf, bt[0]);
        scan::mma_parts<NC, NI>(ya[2 * dp + 1], mf, bt[1]);
      }
#pragma unroll
      for (int nt = 0; nt < kMaxN / 8; ++nt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = g + hf * 8, i = nt * 8 + 2 * q;
          float xv[2] = {0.f, 0.f};  // x from its parts (exact in bf16)
#pragma unroll
          for (int pp = 0; pp < NI; ++pp)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              xv[e] += __bfloat162float(xw[pp * kPlane + t * kNS + i + e]);
          *reinterpret_cast<float2*>(yi + t * hdq + i0 + i) =
              make_float2(ya[nt][2 * hf] + dsk * xv[0],
                          ya[nt][2 * hf + 1] + dsk * xv[1]);
        }
      }
    }
  }
}

// scr holds pass A's output for scr_chunks chunks, the run's first at
// scr_c0 (the forward: the run's own, scr_chunks = n_run and scr_c0 = 0)
template <typename T, bool kOut>
__device__ __forceinline__ void state_pass(
    const T* __restrict__ x, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ scr,
    const float* __restrict__ s0, int s0_stride, T* __restrict__ y,
    float* __restrict__ s_out, float* __restrict__ states, int s_len, int c0,
    int n_run, int every, int h, int hd, int ds, int vec_x, int vec_bc,
    int scr_chunks, int scr_c0) {
  constexpr int NI = Parts<T>::kIn, NC = Parts<T>::kCalc;
  using L = StateSmem<T, kOut>;
  constexpr int kStages = L::kStages, kAhead = L::kAhead;
  constexpr int kPlane = kChunk * kNS, kThreads = kStateWarps * 32;
  // the tiles of a stage: (C,) B, x
  constexpr int kTC = 0, kTB = kOut ? 1 : 0, kTX = kOut ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  // stage st: the (C,) B and x planes (bf16), (the y_intra tile,) the
  // coefficients; after the stages, with the output, each warp's part of
  // C·Sᵀ [16 t][16 i]
  auto tile = [&](int st, int which) {
    return reinterpret_cast<bf16*>(smem + st * L::kStageBytes) +
           which * NI * kPlane;
  };
  auto yis = [&](int st) {
    return reinterpret_cast<float*>(tile(st, L::kTiles));
  };
  auto cof = [&](int st) { return yis(st) + (kOut ? kChunk * kYS : 0); };
  float* red = reinterpret_cast<float*>(smem + kStages * L::kStageBytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int sl = warp >> 2, qu = warp & 3;   // 16 rows, 16 state columns
  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const int i0b = blockIdx.y * kMaxN, ncb = min(kMaxN, hd - i0b);
  const int iw = sl * 16, n0 = qu * 16;
  const int i0 = i0b + iw, nri = min(16, hd - i0);
  const int hdq = round64(hd);
  const int64_t xp = static_cast<int64_t>(h) * hd;
  const Scratch sc(gridDim.x / h, scr_chunks, h, hd, kOut);

  // this warp's piece S[i0 + i][n0 + n] as accumulators: acc[nt] holds rows
  // g and g + 8, columns 8·nt + 2q and + 1
  float acc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = g + (e >> 1) * 8, n = n0 + nt * 8 + 2 * q + (e & 1);
      acc[nt][e] = (s0 && i < nri && n < ds)
                       ? s0[static_cast<int64_t>(bh) * s0_stride +
                            static_cast<int64_t>(i0 + i) * ds + n]
                       : 0.f;
    }

  // the bf16 path's fixed copy slots (at most two 16-byte copies a
  // thread), as sources at chunk 0 that advance by a fixed stride a chunk
  static_assert(kThreads == 512, "the slots below assume 512 threads");
  const int slot = tid < 256 ? tid & 127 : tid - 256;
  const int sr = tid < 256 ? slot >> 3 : slot >> 4;      // tile row
  const int scol = tid < 256 ? (slot & 7) * 8 : (slot & 15) * 4;
  const int64_t row0 = static_cast<int64_t>(b) * s_len + sr;
  const T* src_c = cm + row0 * ds + scol;                   // tid < 128
  const T* src_b = bm + row0 * ds + scol;
  const T* src_x = x + row0 * xp + static_cast<int64_t>(head) * hd + i0b +
                   scol;                                     // 128 <= tid < 256
  const int64_t bch0 =
      (static_cast<int64_t>(b) * scr_chunks + scr_c0) * h + head;
  const float* src_y = scr + sc.y(bch0) + i0b + sr * hdq + scol;  // >= 256
  const float* src_co = scr + sc.coef(bch0) + 4 * slot;     // slot < 9
  auto load = [&](int ir, int st) {   // the run's chunk ir
    const int c = c0 + ir;
    const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
    const int64_t brow = static_cast<int64_t>(b) * s_len + t0;
    const int64_t bch = bch0 + static_cast<int64_t>(ir) * h;
    if (NI == 1 && vec_x && vec_bc) {
      if (tid < 128) {  // (C and) B: row sr, 8 columns from scol
        const bool ok = sr < nr && scol < ds;
        const int64_t step = static_cast<int64_t>(c) * kChunk * ds;
        if constexpr (kOut)
          scan::cp_async16(tile(st, kTC) + sr * kNS + scol,
                           ok ? src_c + step : cm, ok ? 16 : 0);
        scan::cp_async16(tile(st, kTB) + sr * kNS + scol,
                         ok ? src_b + step : bm, ok ? 16 : 0);
      } else if (tid < 256) {  // x: row sr, 8 of the block's 64 columns
        const bool ok = sr < nr && scol < ncb;
        scan::cp_async16(tile(st, kTX) + sr * kNS + scol,
                         ok ? src_x + static_cast<int64_t>(c) * kChunk * xp
                            : x,
                         ok ? 16 : 0);
        if (slot < kCoef / 4)
          scan::cp_async16(cof(st) + 4 * slot,
                           src_co + static_cast<int64_t>(ir) * h * kCoef, 16);
      } else if (kOut) {  // y_intra: row sr, 4 of the block's 64 columns
        scan::cp_async16(yis(st) + sr * kYS + scol,
                         src_y + static_cast<int64_t>(ir) * h * sc.y_per, 16);
      }
      return;
    }
    if constexpr (kOut) {
      scan::stage<T, NI, kChunk, kMaxN, kThreads>(
          tile(st, kTC), kNS, kPlane, cm + brow * ds, ds, nr, ds, vec_bc,
          tid);
      scan::stage_words<kChunk, kMaxN, kThreads>(
          yis(st), kYS, scr + sc.y(bch) + i0b, hdq, tid);
    }
    scan::stage<T, NI, kChunk, kMaxN, kThreads>(
        tile(st, kTB), kNS, kPlane, bm + brow * ds, ds, nr, ds, vec_bc, tid);
    scan::stage<T, NI, kChunk, kMaxN, kThreads>(
        tile(st, kTX), kNS, kPlane,
        x + brow * xp + static_cast<int64_t>(head) * hd + i0b, xp, nr, ncb,
        vec_x, tid);
    scan::stage_words<1, kCoef, kThreads>(cof(st), 0, scr + sc.coef(bch), 0,
                                          tid);
  };

  for (int ir = 0; ir < kAhead; ++ir) {  // the first chunks in flight
    if (ir < n_run) load(ir, ir % kStages);
    scan::cp_async_commit();
  }
  // the two outputs this thread writes per chunk: row qu·4 + lane / 8 of
  // the chunk, columns i0 + 2·(lane % 8) and + 1, at chunk 0
  T* const y_out = y + ((static_cast<int64_t>(b) * s_len + qu * 4 +
                         (lane >> 3)) * h + head) * hd + i0 + 2 * (lane & 7);
  for (int ir = 0; ir < n_run; ++ir) {
    const int c = c0 + ir, st = ir % kStages;
    scan::cp_async_wait<kAhead - 1>();  // chunk c has landed (elementwise
                                        // copies were stored already)
    __syncthreads();  // ... for every warp; chunk c - 1 is consumed
    if (ir + kAhead < n_run) load(ir + kAhead, (ir + kAhead) % kStages);
    scan::cp_async_commit();
    if (states && ir % every == 0) {  // the chunk's incoming state, for
                                      // the backward: every `every`-th
      float* sc = states +
                  (static_cast<int64_t>(bh) * ((n_run + every - 1) / every) +
                   ir / every) * hd * ds;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = g + (e >> 1) * 8, n = n0 + nt * 8 + 2 * q + (e & 1);
          if (i < nri && n < ds)
            sc[static_cast<int64_t>(i0 + i) * ds + n] = acc[nt][e];
        }
    }
    const bf16* bs = tile(st, kTB);
    const bf16* xs = tile(st, kTX);
    const float* co = cof(st);

    // this warp's part of C·Sᵀ (its 16 state columns), with the state
    // before this chunk, to the slice's reduction tiles
    if constexpr (kOut) {
      uint32_t af[NI][4];
#pragma unroll
      for (int pp = 0; pp < NI; ++pp)
        scan::ldsm_x4(tile(st, kTC) + pp * kPlane + (lane & 15) * kNS + n0 +
                          (lane >> 4) * 8,
                      af[pp]);
      float ya[2][4] = {};
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        // B operand (k = n, column = i): the accumulators' own elements
        uint32_t lo[NC], hi[NC], bt[NC][2];
        scan::split2<NC>(acc[0][2 * jt], acc[0][2 * jt + 1], lo);
        scan::split2<NC>(acc[1][2 * jt], acc[1][2 * jt + 1], hi);
#pragma unroll
        for (int pp = 0; pp < NC; ++pp) {
          bt[pp][0] = lo[pp];
          bt[pp][1] = hi[pp];
        }
        scan::mma_parts<NI, NC>(ya[jt], af, bt);
      }
      float* mine = red + warp * 256;
#pragma unroll
      for (int jt = 0; jt < 2; ++jt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(mine + (g + 8 * hf) * 16 + jt * 8 +
                                     2 * q) =
              make_float2(ya[jt][2 * hf], ya[jt][2 * hf + 1]);
    }

    // S = exp(p_last)·S + (w∘x)ᵀ·B on this warp's piece
    {
      const float el = co[2 * kChunk];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] *= el;
      uint32_t xr[NI][4], af[NC][4];
#pragma unroll
      for (int pp = 0; pp < NI; ++pp)  // xᵀ [i x s] as an A fragment
        scan::ldsm_x4_trans(xs + pp * kPlane +
                                ((lane >> 4) * 8 + (lane & 7)) * kNS + iw +
                                ((lane >> 3) & 1) * 8,
                            xr[pp]);
      const float w[4] = {co[2 * q], co[2 * q + 1], co[2 * q + 8],
                          co[2 * q + 9]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float2 v = make_float2(0.f, 0.f);
#pragma unroll
        for (int pp = 0; pp < NI; ++pp) {
          const float2 u = scan::unpack(xr[pp][r]);
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
#pragma unroll
      for (int pp = 0; pp < NI; ++pp) {  // B rows (k = s, column = n)
        uint32_t r[4];
        scan::ldsm_x4_trans(bs + pp * kPlane +
                                ((lane & 7) + ((lane >> 3) & 1) * 8) * kNS +
                                n0 + (lane >> 4) * 8,
                            r);
        bt[0][pp][0] = r[0];
        bt[0][pp][1] = r[1];
        bt[1][pp][0] = r[2];
        bt[1][pp][1] = r[3];
      }
      scan::mma_parts<NC, NI>(acc[0], af, bt[0]);
      scan::mma_parts<NC, NI>(acc[1], af, bt[1]);
    }

    // y = y_intra + exp(p)·(C·Sᵀ) on 4 rows t of the slice, C·Sᵀ the sum
    // of the slice's 4 parts
    if constexpr (kOut) {
      scan::group_sync(1 + sl, 4 * 32);
      const int t = qu * 4 + (lane >> 3), i = 2 * (lane & 7);
      const int t0 = c * kChunk, nr = min(kChunk, s_len - t0);
      const float* part = red + sl * 4 * 256 + t * 16 + i;
      float2 sum = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 v = *reinterpret_cast<const float2*>(part + k * 256);
        sum.x += v.x;
        sum.y += v.y;
      }
      if (t < nr) {
        const float ept = co[kChunk + t];
        const float2 yi =
            *reinterpret_cast<const float2*>(yis(st) + t * kYS + iw + i);
        T* yo = y_out + static_cast<int64_t>(t0) * xp;
        if (i < nri) yo[0] = scan::from_f<T>(yi.x + ept * sum.x);
        if (i + 1 < nri) yo[1] = scan::from_f<T>(yi.y + ept * sum.y);
      }
    }
  }

  if (!s_out) return;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = g + (e >> 1) * 8, n = n0 + nt * 8 + 2 * q + (e & 1);
      if (i < nri && n < ds)
        s_out[(static_cast<int64_t>(bh) * hd + i0 + i) * ds + n] = acc[nt][e];
    }
}

// pass A of the forward, one block of 4 warps per (batch, chunk, 4 heads)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    ssd_intra_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ dt,
                     const float* __restrict__ a_log,
                     const float* __restrict__ d_skip,
                     float* __restrict__ scr, int s_len, int c0, int n_run,
                     int h, int hd, int ds, int vec_x, int vec_bc) {
  intra_pass<T, true>(x, bm, cm, dt, a_log, d_skip, scr, s_len, c0, n_run,
                      h, hd, ds, vec_x, vec_bc);
}

// pass B of the forward, one block of 16 warps per (batch·head, 64 rows)
template <typename T>
__global__ void __launch_bounds__(kStateWarps * 32)
    ssd_state_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ scr,
                     const float* __restrict__ s0, int s0_stride,
                     T* __restrict__ y, float* __restrict__ s_out,
                     float* __restrict__ states, int s_len, int c0,
                     int n_run, int every, int h, int hd, int ds, int vec_x,
                     int vec_bc) {
  state_pass<T, true>(x, bm, cm, scr, s0, s0_stride, y, s_out, states,
                      s_len, c0, n_run, every, h, hd, ds, vec_x, vec_bc,
                      n_run, 0);
}

// the recompute's pass A: w and exp(p_last) only
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    ssd_recompute_intra_kernel(const float* __restrict__ dt,
                               const float* __restrict__ a_log,
                               float* __restrict__ scr, int s_len, int c0,
                               int n_run, int h, int hd) {
  intra_pass<T, false>(nullptr, nullptr, nullptr, dt, a_log, nullptr, scr,
                       s_len, c0, n_run, h, hd, 0, 0, 0);
}

// the recompute's pass B: every chunk's incoming state, no output, the
// coefficients of the whole sequence in scr
template <typename T>
__global__ void __launch_bounds__(kStateWarps * 32)
    ssd_recompute_state_kernel(const T* __restrict__ x,
                               const T* __restrict__ bm,
                               const float* __restrict__ scr,
                               const float* __restrict__ s0, int s0_stride,
                               float* __restrict__ states, int s_len, int c0,
                               int n_run, int h, int hd, int ds, int vec_x,
                               int vec_bc, int n_chunks) {
  state_pass<T, false>(x, bm, nullptr, scr, s0, s0_stride, nullptr, nullptr,
                       states, s_len, c0, n_run, 1, h, hd, ds, vec_x,
                       vec_bc, n_chunks, c0);
}

// Floats of pass A's scratch over n_run chunks, with the output or
// state-only.
inline long long scratch_floats(int b, int n_run, int h, int hd, bool out) {
  return static_cast<long long>(b) * n_run * h *
         ((out ? kChunk * round64(hd) : 0) + kCoef);
}

// The forward over chunks c0 .. c0 + n_run - 1 (ssd.cu's ssd_launch): two
// launches on `stream`.
template <typename T>
cudaError_t launch_forward(const void* x, const void* bm, const void* cm,
                           const void* dt, const void* a_log,
                           const void* d_skip, const void* s0, int s0_stride,
                           void* scratch, void* y, void* s_out, void* states,
                           int b, int s_len, int h, int hd, int ds,
                           int vec_x, int vec_bc, int c0, int n_run,
                           int every, cudaStream_t stream) {
  if (n_run > 0) {
    const dim3 grid(b * n_run, (h + kHeads - 1) / kHeads);
    ssd_intra_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(bm),
        static_cast<const T*>(cm), static_cast<const float*>(dt),
        static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
        static_cast<float*>(scratch), s_len, c0, n_run, h, hd, ds, vec_x,
        vec_bc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  static bool raised[64] = {};
  const cudaError_t err = scan::raise_smem(
      ssd_state_kernel<T>, StateSmem<T, true>::kBytes, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (hd + kMaxN - 1) / kMaxN);
  ssd_state_kernel<T><<<grid, kStateWarps * 32, StateSmem<T, true>::kBytes,
                        stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(scratch),
      static_cast<const float*>(s0), s0_stride, static_cast<T*>(y),
      static_cast<float*>(s_out), static_cast<float*>(states), s_len, c0,
      n_run, every, h, hd, ds, vec_x, vec_bc);
  return cudaGetLastError();
}

// The state update's coefficients of every chunk of the sequence to
// `scratch` (scratch_floats(b, n_chunks, h, hd, false) floats): the
// state-only pass A, one launch on `stream`.
template <typename T>
cudaError_t launch_coefficients(const void* dt, const void* a_log,
                                void* scratch, int b, int s_len, int h,
                                int hd, cudaStream_t stream) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  if (n_chunks == 0) return cudaSuccess;
  const dim3 grid(b * n_chunks, (h + kHeads - 1) / kHeads);
  ssd_recompute_intra_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(a_log),
      static_cast<float*>(scratch), s_len, 0, n_chunks, h, hd);
  return cudaGetLastError();
}

// The states of chunks c0 .. c0 + n_run - 1 from s0 (read with a stride:
// a checkpoint), every chunk's incoming state to `states` [b, h, n_run,
// hd, ds]: the state-only pass B, one launch on `stream`, from the
// coefficients `launch_coefficients` left in scratch.
template <typename T>
cudaError_t launch_recompute(const void* x, const void* bm, const void* s0,
                             int s0_stride, const void* scratch,
                             void* states, int b, int s_len, int h, int hd,
                             int ds, int vec_x, int vec_bc, int c0, int n_run,
                             cudaStream_t stream) {
  if (n_run <= 0) return cudaSuccess;
  static bool raised[64] = {};
  const cudaError_t err = scan::raise_smem(ssd_recompute_state_kernel<T>,
                                           StateSmem<T, false>::kBytes,
                                           raised);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (hd + kMaxN - 1) / kMaxN);
  ssd_recompute_state_kernel<T><<<grid, kStateWarps * 32,
                                  StateSmem<T, false>::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const float*>(scratch), static_cast<const float*>(s0),
      s0_stride, static_cast<float*>(states), s_len, c0, n_run, h, hd, ds,
      vec_x, vec_bc, (s_len + kChunk - 1) / kChunk);
  return cudaGetLastError();
}

}  // namespace ssd_fwd
