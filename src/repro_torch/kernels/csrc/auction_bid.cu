// The capacitated column auction of Phase 2: one forward-bidding round
// (`bid_rows` and `bid_decode`) and the whole staged ε-scaling solve, one
// thread block per market (`auction_solve_kernel`).
//
// Replaces: the Pallas kernel `auction_bid` in src/repro/kernels/auction_bid.py
// (body `_bid_kernel`), and around it the reference's staged solve, four
// nested `lax.while_loop`s in src/repro/core/solvers/dense_jax.py (`solve`).
//
// The bidding round.  Per active request row j of W [n, m]:
//   P = W - ask;  v1, k1 = max and lowest argmax of P;
//   v2 = max of P with ask2 in place of ask at k1, floored at 0;
//   wants = v1 > 0;  bid = ask[k1] + (v1 - v2) + eps;
// per agent i: best = largest bid at i (-FLT_MAX/4 if none), winner = lowest
// row at that bid (n if none).  One warp per row (`bid_row`): lanes stride
// the row and combine (max, lowest index) with shuffles.  The segment max is
// one 64-bit atomicMax per bidding row on the key
// (ordered_bits(bid) << 32) | (0xFFFFFFFF - j): the largest bid wins and, at
// equal bids, the lowest j, whatever order the atomics land in.  A bidding
// row has v1 > 0 and v2 <= v1, so bid >= eps > 0 and -0.0 never competes.
//
// The solve.  Bound on an H100: neither bytes nor operations.  A market of
// the router (n <= 64 requests, m <= 128 agents, <= 12 units each) is tens
// of KB read once, nanoseconds of memory traffic; what costs is the chain
// of ~400 dependent rounds, each a few block-wide steps.  The TPU program
// keeps that chain on the device as nested while loops; a port that reads
// each loop's condition on the host pays a launch and a sync per step.
// Here one block runs a market's whole solve: the state (W, the unit-price
// and unit-owner grids, agent_of / unit_of / parked, the asks and the
// reverse round's scratch) sits in shared memory, every loop condition is a
// block-wide __syncthreads_or, and the host sees the result once.  The
// markets of one call (the hubs of a batch) are packed with offsets, one
// block each.  A market whose W does not fit in shared memory reads it from
// global memory through L1/L2 (the `kSharedW = false` instance).  W's rows
// sit in shared memory at an odd stride, so a warp reading a row (bidding)
// or a column (reverse rounds) hits 32 distinct banks.
//
// The fused mode (`auction_fused_kernel`) is the same solve for the fused
// routing step: one market whose W the fused Phase-1 kernel
// (csrc/routing_fused.cu) left on the device, the ε schedule derived in the
// block from that kernel's wmax, the warm attempt under its budget and, if
// it trips, the cold re-solve in the same launch; nothing is read by the
// host in between.
//
// Bit-exactness with the plain version (`core/solvers/dense_torch.py::
// _StagedMarket`, PyTorch on the CPU): every arithmetic step uses the _rn
// intrinsics (no contraction); the ε schedule runs in float32 with IEEE
// division; every argmax / argmin takes the first index; drop-sentinel
// scatters become guarded writes; the request-side conflict of the reverse
// round (scatter-max of the offers, then the lowest agent at the best offer)
// is a 64-bit atomicMax on (ordered_bits(offer) << 32) | (0xFFFFFFFF - i)
// with -0.0 canonicalised to +0.0, so equal offers give equal keys.
#include <cfloat>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr int kSolveThreads = 512;
constexpr float kBig = FLT_MAX / 4.0f;  // torch.finfo(float32).max / 4
constexpr float kNoBid = -kBig;
constexpr int kMetaInts = 9;  // n, m, cmax, cap, w_off, p_off, c_off, g_off, r_off

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ unsigned long long max_key(float value,
                                                      int index) {
  return (static_cast<unsigned long long>(ordered_bits(value)) << 32) |
         static_cast<unsigned long long>(0xffffffffu -
                                         static_cast<uint32_t>(index));
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(0xffffffffu -
                          static_cast<uint32_t>(key & 0xffffffffull));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = kWarp / 2; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// (max, lowest index at the max) over the warp; every lane gets the result
__device__ __forceinline__ void warp_argmax(float& v, int& k) {
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int ok = __shfl_xor_sync(0xffffffffu, k, off);
    if (ov > v || (ov == v && ok < k)) {
      v = ov;
      k = ok;
    }
  }
}

struct Bid {
  bool wants;
  int k1;
  float bid;
};

// The forward bid of one active request row `w` [m] (one warp; every lane
// returns the same values).
__device__ __forceinline__ Bid bid_row(const float* w, const float* ask,
                                       const float* ask2, int m, float eps,
                                       int lane) {
  // top profit v1 at its lowest index k1
  float v1 = -CUDART_INF_F;
  int k1 = m;
  for (int i = lane; i < m; i += kWarp) {
    const float p = __fsub_rn(w[i], ask[i]);
    if (p > v1) {  // strict: the lane keeps its first maximum
      v1 = p;
      k1 = i;
    }
  }
  warp_argmax(v1, k1);
  // runner-up: the favourite agent re-enters at its second-cheapest unit
  float v2 = -CUDART_INF_F;
  for (int i = lane; i < m; i += kWarp) {
    const float a = (i == k1) ? ask2[i] : ask[i];
    v2 = fmaxf(v2, __fsub_rn(w[i], a));
  }
  v2 = warp_max(v2);
  v2 = v2 > 0.0f ? v2 : 0.0f;
  Bid b;
  b.wants = v1 > 0.0f;
  b.k1 = k1;
  b.bid = b.wants ? __fadd_rn(__fadd_rn(ask[k1], __fsub_rn(v1, v2)), eps)
                  : 0.0f;
  return b;
}

// ------------------------------------------------------- one round ------

__global__ void bid_rows(const float* __restrict__ W,
                         const float* __restrict__ ask,
                         const float* __restrict__ ask2,
                         const uint8_t* __restrict__ active, float eps,
                         uint8_t* __restrict__ wants,
                         unsigned long long* __restrict__ keys, int n, int m) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;  // uniform across the warp
  if (active[row] == 0) {
    if (lane == 0) wants[row] = 0;
    return;
  }
  const Bid b = bid_row(W + row * m, ask, ask2, m, eps, lane);
  if (lane == 0) {
    wants[row] = b.wants ? 1 : 0;
    if (b.wants) atomicMax(keys + b.k1, max_key(b.bid, static_cast<int>(row)));
  }
}

__global__ void bid_decode(const unsigned long long* __restrict__ keys,
                           float* __restrict__ best,
                           int32_t* __restrict__ winner, int n, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const unsigned long long key = keys[i];
  if (key == 0ull) {
    best[i] = kNoBid;
    winner[i] = n;
  } else {
    best[i] = from_ordered_bits(static_cast<uint32_t>(key >> 32));
    winner[i] = key_index(key);
  }
}

// ------------------------------------------------------- the solve ------

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// W's row stride in shared memory: odd, so rows and columns are both
// conflict-free
__host__ __device__ __forceinline__ int w_stride(int m) { return m | 1; }

// Byte offsets of a market's arrays in dynamic shared memory.  Every
// section grows with n, m and cmax, so the layout of the largest market of
// a launch bounds every block's.
struct Layout {
  size_t keys, w, price, owner, ask, ask2, ku, cnt, agent_of, unit_of, pi,
      rj1, rnewp, rus, rflag, parked, rq, total;
};

__host__ __device__ inline Layout solve_layout(int n, int m, int cmax,
                                               bool shared_w) {
  Layout l;
  const size_t grid = static_cast<size_t>(m) * cmax;
  size_t at = 0;
  l.keys = at;  // one 64-bit key per agent (bidding) or request (reverse)
  at = align16(at + 8 * static_cast<size_t>(n > m ? n : m));
  l.w = at;
  at = align16(at + (shared_w ? 4 * static_cast<size_t>(n) * w_stride(m)
                              : 0));
  l.price = at;
  at = align16(at + 4 * grid);
  l.owner = at;
  at = align16(at + 4 * grid);
  l.ask = at;
  at = align16(at + 4 * static_cast<size_t>(m));
  l.ask2 = at;
  at = align16(at + 4 * static_cast<size_t>(m));
  l.ku = at;
  at = align16(at + 4 * static_cast<size_t>(m));
  l.cnt = at;
  at = align16(at + 4 * static_cast<size_t>(m));
  l.agent_of = at;
  at = align16(at + 4 * static_cast<size_t>(n));
  l.unit_of = at;
  at = align16(at + 4 * static_cast<size_t>(n));
  l.pi = at;
  at = align16(at + 4 * static_cast<size_t>(n));
  l.rj1 = at;
  at = align16(at + 4 * static_cast<size_t>(m));
  l.rnewp = at;
  at = align16(at + 4 * static_cast<size_t>(m));
  l.rus = at;
  at = align16(at + 4 * static_cast<size_t>(m));
  l.rflag = at;
  at = align16(at + static_cast<size_t>(m));
  l.parked = at;
  at = align16(at + static_cast<size_t>(n));
  l.rq = at;
  at = align16(at + static_cast<size_t>(n));
  l.total = at;
  return l;
}

// reverse-round agent flags
constexpr uint8_t kStale = 1;   // the agent has a stale unit this round
constexpr uint8_t kStrong = 2;  // ... and a supporter above eps

// One market's state and its loops; every member function is called by
// all threads of the block, and every loop condition is block-uniform.
struct Market {
  int n, m, cmax, cap, ws;
  const float* W;  // shared (stride ws) or global (stride m)
  float* price;    // [m, cmax]
  int* owner;      // [m, cmax]
  float *ask, *ask2;
  int *ku, *cnt, *agent_of, *unit_of;
  float* pi;
  unsigned long long* keys;
  int *rj1, *rus;
  float* rnewp;
  uint8_t *rflag, *parked, *rq;
  float tol;
  int rounds;
  int tid, lane, warp, nwarps;

  __device__ float w(int j, int i) const { return W[j * ws + i]; }

  __device__ bool stale(int i, int u) const {
    const int c = i * cmax + u;
    return owner[c] < 0 && price[c] > 0.0f;
  }

  // Cheapest / second-cheapest unit price per agent (+big where the agent
  // has fewer than one/two units) and the cheapest unit's index; clears the
  // bid keys.
  __device__ void asks() {
    for (int i = tid; i < m; i += blockDim.x) {
      const int c = cnt[i];
      const float* p = price + i * cmax;
      float a = c > 0 ? p[0] : kBig;
      int k = 0;
      for (int u = 1; u < cmax; ++u) {
        const float q = u < c ? p[u] : kBig;
        if (q < a) {  // strict: the first minimum
          a = q;
          k = u;
        }
      }
      float a2 = kBig;
      for (int u = 0; u < cmax; ++u)
        if (u != k) a2 = fminf(a2, u < c ? p[u] : kBig);
      ask[i] = a;
      ask2[i] = a2;
      ku[i] = k;
      keys[i] = 0ull;
    }
    __syncthreads();
  }

  // The settle loop's condition (any unpark, evict, stale unit or active
  // request); records each request's unpark (bit 0) and evict (bit 1).
  __device__ bool cs_state(float eps) {
    const float unpark_at = __fadd_rn(eps, tol);
    bool any = false;
    for (int j = warp; j < n; j += nwarps) {
      float v1 = -CUDART_INF_F;
      for (int i = lane; i < m; i += kWarp)
        v1 = fmaxf(v1, __fsub_rn(w(j, i), ask[i]));
      v1 = warp_max(v1);
      if (lane == 0) {
        const int a = agent_of[j];
        const bool assigned = a >= 0;
        const float prof =
            assigned ? __fsub_rn(w(j, a), price[a * cmax + unit_of[j]])
                     : 0.0f;
        const bool unpark = parked[j] && v1 > unpark_at;
        const float v1c = v1 < 0.0f ? 0.0f : v1;
        const bool viol =
            assigned && prof < __fsub_rn(__fsub_rn(v1c, eps), tol);
        rq[j] = static_cast<uint8_t>((unpark ? 1 : 0) | (viol ? 2 : 0));
        any = any || unpark || viol || (!assigned && !parked[j]);
      }
    }
    for (int i = tid; i < m && !any; i += blockDim.x)
      for (int u = 0; u < cnt[i]; ++u)
        if (stale(i, u)) {
          any = true;
          break;
        }
    return __syncthreads_or(any) != 0;
  }

  // Unpark and evict as cs_state recorded them; prices are kept.
  __device__ void evict() {
    for (int j = tid; j < n; j += blockDim.x) {
      const uint8_t f = rq[j];
      if (f & 1) parked[j] = 0;
      if (f & 2) {
        owner[agent_of[j] * cmax + unit_of[j]] = -1;
        agent_of[j] = -1;
        unit_of[j] = -1;
      }
    }
    __syncthreads();
  }

  __device__ void bid_until_settled(float eps) {
    while (rounds < cap) {
      bool any = false;
      for (int j = tid; j < n; j += blockDim.x)
        any = any || (agent_of[j] < 0 && !parked[j]);
      if (!__syncthreads_or(any)) break;
      asks();
      for (int j = warp; j < n; j += nwarps) {
        if (agent_of[j] >= 0 || parked[j]) continue;  // uniform per warp
        const Bid b = bid_row(W + j * ws, ask, ask2, m, eps, lane);
        if (lane == 0) {
          if (!b.wants)
            parked[j] = 1;
          else
            atomicMax(keys + b.k1, max_key(b.bid, j));
        }
      }
      __syncthreads();
      // each agent that sold: its old owner loses the unit, the winner
      // takes it at the winning bid (owners never bid, so the displaced and
      // the winners are different requests)
      for (int i = tid; i < m; i += blockDim.x) {
        const unsigned long long key = keys[i];
        if (key == 0ull) continue;
        const int winner = key_index(key);
        const int u = ku[i];
        const int c = i * cmax + u;
        const int old = owner[c];
        if (old >= 0) {
          agent_of[old] = -1;
          unit_of[old] = -1;
        }
        agent_of[winner] = i;
        unit_of[winner] = u;
        owner[c] = winner;
        price[c] = from_ordered_bits(static_cast<uint32_t>(key >> 32));
      }
      __syncthreads();
      ++rounds;
    }
  }

  __device__ void reverse_until_clean(float eps) {
    while (rounds < cap) {
      // which agents hold a stale unit, and their lowest-index one; each
      // request's profit at its unit; clear the request keys
      bool any = false;
      for (int i = tid; i < m; i += blockDim.x) {
        int first = -1;
        for (int u = 0; u < cnt[i]; ++u)
          if (stale(i, u)) {
            first = u;
            break;
          }
        rflag[i] = first >= 0 ? kStale : 0;
        rus[i] = first >= 0 ? first : 0;
        any = any || first >= 0;
      }
      for (int j = tid; j < n; j += blockDim.x) {
        const int a = agent_of[j];
        pi[j] = a >= 0 ? __fsub_rn(w(j, a), price[a * cmax + unit_of[j]])
                       : 0.0f;
        keys[j] = 0ull;
      }
      if (!__syncthreads_or(any)) break;
      // per stale agent: best / second-best support over requests; a weak
      // agent re-anchors its stale units to 0, a strong one offers
      for (int i = warp; i < m; i += nwarps) {
        if (!(rflag[i] & kStale)) continue;  // uniform per warp
        float b1 = -CUDART_INF_F;
        int j1 = n;
        for (int j = lane; j < n; j += kWarp) {
          const float v = __fsub_rn(w(j, i), pi[j]);
          if (v > b1) {
            b1 = v;
            j1 = j;
          }
        }
        warp_argmax(b1, j1);
        float b2 = -kBig;
        for (int j = lane; j < n; j += kWarp)
          if (j != j1) b2 = fmaxf(b2, __fsub_rn(w(j, i), pi[j]));
        b2 = warp_max(b2);
        if (b1 <= eps) {
          for (int u = lane; u < cnt[i]; u += kWarp)
            if (stale(i, u)) price[i * cmax + u] = 0.0f;
          continue;
        }
        const float x = __fsub_rn(b2, eps);
        const float newp = x < 0.0f ? 0.0f : x;
        // +0.0f turns an offer of -0.0 into +0.0: equal offers, equal keys
        const float off = __fadd_rn(__fsub_rn(w(j1, i), newp), 0.0f);
        if (lane == 0) {
          rflag[i] = kStale | kStrong;
          rj1[i] = j1;
          rnewp[i] = newp;
          if (off >= -kBig) atomicMax(keys + j1, max_key(off, i));
        }
      }
      __syncthreads();
      // the agent whose offer a request takes grabs it into its
      // lowest-index stale unit; the request's old unit is freed, its
      // price kept (it goes stale and re-anchors next round)
      for (int i = tid; i < m; i += blockDim.x) {
        if (rflag[i] != (kStale | kStrong)) continue;
        const int j = rj1[i];
        if (key_index(keys[j]) != i) continue;
        const int old_a = agent_of[j];
        if (old_a >= 0) owner[old_a * cmax + unit_of[j]] = -1;
        const int u = rus[i];
        price[i * cmax + u] = rnewp[i];
        owner[i * cmax + u] = j;
        agent_of[j] = i;
        unit_of[j] = u;
        parked[j] = 0;
      }
      __syncthreads();
      ++rounds;
    }
  }

  // Alternate forward bidding and reverse rounds at this eps.
  __device__ void settle(float eps) {
    while (rounds < cap) {
      asks();
      if (!cs_state(eps)) break;
      evict();
      bid_until_settled(eps);
      reverse_until_clean(eps);
    }
  }
};

// Points a block's Market at its dynamic shared memory, stages W there
// (kSharedW) or reads it in place, and loads the unit counts.
template <bool kSharedW>
__device__ void market_setup(Market& s, unsigned char* smem, const float* Wg,
                             const int32_t* counts) {
  const int n = s.n, m = s.m, cmax = s.cmax;
  const Layout l = solve_layout(n, m, cmax, kSharedW);
  s.tid = threadIdx.x;
  s.lane = threadIdx.x % kWarp;
  s.warp = threadIdx.x / kWarp;
  s.nwarps = blockDim.x / kWarp;
  s.keys = reinterpret_cast<unsigned long long*>(smem + l.keys);
  s.price = reinterpret_cast<float*>(smem + l.price);
  s.owner = reinterpret_cast<int*>(smem + l.owner);
  s.ask = reinterpret_cast<float*>(smem + l.ask);
  s.ask2 = reinterpret_cast<float*>(smem + l.ask2);
  s.ku = reinterpret_cast<int*>(smem + l.ku);
  s.cnt = reinterpret_cast<int*>(smem + l.cnt);
  s.agent_of = reinterpret_cast<int*>(smem + l.agent_of);
  s.unit_of = reinterpret_cast<int*>(smem + l.unit_of);
  s.pi = reinterpret_cast<float*>(smem + l.pi);
  s.rj1 = reinterpret_cast<int*>(smem + l.rj1);
  s.rnewp = reinterpret_cast<float*>(smem + l.rnewp);
  s.rus = reinterpret_cast<int*>(smem + l.rus);
  s.rflag = smem + l.rflag;
  s.parked = smem + l.parked;
  s.rq = smem + l.rq;
  if (kSharedW) {
    float* Ws = reinterpret_cast<float*>(smem + l.w);
    const int ws = w_stride(m);
    for (int e = threadIdx.x; e < n * m; e += blockDim.x)
      Ws[(e / m) * ws + e % m] = Wg[e];
    s.W = Ws;
    s.ws = ws;
  } else {
    s.W = Wg;
    s.ws = m;
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) s.cnt[i] = counts[i];
}

// A fresh market state from start grid p0 (all zeros when p0 is null), then
// the ε phases (the reference tests eps > eps_final * 1.0000000001 in
// float32, where the factor rounds to 1.0) and one final settle.
__device__ void market_solve(Market& s, const float* p0, float eps0,
                             float eps_final, float theta) {
  for (int e = threadIdx.x; e < s.m * s.cmax; e += blockDim.x) {
    s.price[e] = p0 != nullptr ? p0[e] : 0.0f;
    s.owner[e] = -1;
  }
  for (int j = threadIdx.x; j < s.n; j += blockDim.x) {
    s.agent_of[j] = -1;
    s.unit_of[j] = -1;
    s.parked[j] = 0;
  }
  __syncthreads();
  s.tol = __fdiv_rn(eps_final, 8.0f);
  s.rounds = 0;
  float eps = eps0;
  while (eps > eps_final && s.rounds < s.cap) {
    s.settle(eps);
    eps = fmaxf(__fdiv_rn(eps, theta), eps_final);
  }
  s.settle(eps_final);
}

__device__ void market_store(const Market& s, float* price_out,
                             int32_t* agent_out, int32_t* unit_out) {
  for (int e = threadIdx.x; e < s.m * s.cmax; e += blockDim.x)
    price_out[e] = s.price[e];
  for (int j = threadIdx.x; j < s.n; j += blockDim.x) {
    agent_out[j] = s.agent_of[j];
    unit_out[j] = s.unit_of[j];
  }
}

template <bool kSharedW>
__global__ void __launch_bounds__(kSolveThreads, 1)
    auction_solve_kernel(const float* __restrict__ fbuf,
                         const int32_t* __restrict__ ibuf,
                         int32_t* __restrict__ out, int markets,
                         int total_grid, int total_req) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x;
  const int32_t* meta = ibuf + g * kMetaInts;
  Market s;
  s.n = meta[0];
  s.m = meta[1];
  s.cmax = meta[2];
  s.cap = meta[3];
  market_setup<kSharedW>(s, smem, fbuf + meta[4], ibuf + meta[6]);
  market_solve(s, fbuf + meta[5], fbuf[3 * g], fbuf[3 * g + 1],
               fbuf[3 * g + 2]);
  int32_t* agent_out = out + markets + total_grid + meta[8];
  market_store(s, reinterpret_cast<float*>(out + markets) + meta[7],
               agent_out, agent_out + total_req);
  if (threadIdx.x == 0) out[g] = s.rounds;
}

}  // namespace

// The fused mode (the reference's fused program, routing_fused.py:308-333):
// one market whose W the fused Phase-1 kernel wrote on the device, the ε
// schedule derived here from its wmax in float32, the warm attempt under
// its round budget and, when it trips, the cold re-solve from zero prices
// in the same launch (the reference's lax.cond), with no host read between.
struct FusedSolveArgs {
  const float* W;        // [n, m], written by fused_phase1_kernel
  const int32_t* counts; // [m]
  const float* p0;       // [m, cmax] warm-start grid (zeros when cold)
  float* hdr;            // [0] wmax in; [1] rounds, [2] tripped (int32),
                         // [3] eps_final out
  float* price;          // [m, cmax] out
  int32_t* agent_of;     // [n] out
  int32_t* unit_of;      // [n] out
  float theta;
  int32_t n, m, cmax, budget, max_rounds, warm;
};

namespace {

template <bool kSharedW>
__global__ void __launch_bounds__(kSolveThreads, 1)
    auction_fused_kernel(const FusedSolveArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Market s;
  s.n = a.n;
  s.m = a.m;
  s.cmax = a.cmax;
  market_setup<kSharedW>(s, smem, a.W, a.counts);
  // the ε schedule (dense_common.jax_eps_final / warm_eps0 as float32
  // scalars): every thread derives the same values
  const float wmax = a.hdr[0];
  const float anchor = fmaxf(wmax, 1.0f);
  const float eps_final = fmaxf(__fmul_rn(1e-5f, anchor),
                                __fmul_rn(64.0f * FLT_EPSILON, anchor));
  const float cold_eps0 = fmaxf(__fdiv_rn(wmax, a.theta), eps_final);
  float eps0 = cold_eps0;
  if (a.warm) {
    // fine schedule iff the seed carries price mass above it; each warp
    // takes the whole grid's max, so every thread holds it
    float p0max = -CUDART_INF_F;
    for (int e = s.lane; e < s.m * s.cmax; e += kWarp)
      p0max = fmaxf(p0max, a.p0[e]);
    p0max = warp_max(p0max);
    const float theta3 = __fmul_rn(__fmul_rn(a.theta, a.theta), a.theta);
    const float fine = fmaxf(__fdiv_rn(wmax, theta3), eps_final);
    if (p0max > fine) eps0 = fine;
  }
  s.cap = a.warm ? a.budget : a.max_rounds;
  market_solve(s, a.p0, eps0, eps_final, a.theta);
  const bool tripped = a.warm && s.rounds >= a.budget;
  if (tripped) {  // block-uniform: every thread holds the same rounds
    __syncthreads();
    s.cap = a.max_rounds;
    market_solve(s, nullptr, cold_eps0, eps_final, a.theta);
  }
  market_store(s, a.price, a.agent_of, a.unit_of);
  if (threadIdx.x == 0) {
    reinterpret_cast<int32_t*>(a.hdr)[1] = s.rounds;
    reinterpret_cast<int32_t*>(a.hdr)[2] = tripped ? 1 : 0;
    a.hdr[3] = eps_final;
  }
}

template <bool kSharedW>
cudaError_t launch_solve(const void* fbuf, const void* ibuf, void* out,
                         int markets, int total_grid, int total_req,
                         size_t smem, cudaStream_t stream) {
  auto* kernel = auction_solve_kernel<kSharedW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<markets, kSolveThreads, smem, stream>>>(
      static_cast<const float*>(fbuf), static_cast<const int32_t*>(ibuf),
      static_cast<int32_t*>(out), markets, total_grid, total_req);
  return cudaGetLastError();
}

template <bool kSharedW>
cudaError_t launch_fused(const FusedSolveArgs& a, size_t smem,
                         cudaStream_t stream) {
  auto* kernel = auction_fused_kernel<kSharedW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<1, kSolveThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// W [n, m] float32, ask/ask2 [m] float32, active [n] bool; outputs best [m]
// float32, winner [m] int32, wants [n] bool; keys [m] uint64 scratch.  All
// contiguous on the device.  Launches on `stream`; returns the first CUDA
// error (cudaSuccess = 0).
extern "C" int auction_bid_launch(const void* W, const void* ask,
                                  const void* ask2, const void* active,
                                  float eps, void* best, void* winner,
                                  void* wants, void* keys, int n, int m,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m > 0) {
    const cudaError_t err = cudaMemsetAsync(
        keys, 0, static_cast<size_t>(m) * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n > 0 && m > 0) {
    const int64_t blocks =
        (static_cast<int64_t>(n) * kWarp + kBlock - 1) / kBlock;
    bid_rows<<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        static_cast<const float*>(W), static_cast<const float*>(ask),
        static_cast<const float*>(ask2), static_cast<const uint8_t*>(active),
        eps, static_cast<uint8_t*>(wants),
        static_cast<unsigned long long*>(keys), n, m);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (m > 0) {
    bid_decode<<<(m + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        static_cast<const unsigned long long*>(keys),
        static_cast<float*>(best), static_cast<int32_t*>(winner), n, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// Which instance a solve over markets bounded by (max_n, max_m, max_cmax)
// launches: info[0] = 1 if W sits in shared memory (it does unless that
// exceeds the card's opt-in limit), info[1] = the dynamic shared memory per
// block.  Returns cudaErrorInvalidValue if even the state without W does
// not fit.
extern "C" int auction_solve_plan(int max_n, int max_m, int max_cmax,
                                  int* info) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t with_w = solve_layout(max_n, max_m, max_cmax, true).total;
  const size_t without_w = solve_layout(max_n, max_m, max_cmax, false).total;
  info[0] = with_w <= static_cast<size_t>(optin) ? 1 : 0;
  info[1] = static_cast<int>(info[0] ? with_w : without_w);
  if (!info[0] && without_w > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSuccess);
}

// The staged solve of `markets` markets, one block each.  fbuf float32:
// [eps0, eps_final, theta] per market, then each market's W [n, m] at w_off
// and start grid p0 [m, cmax] at p_off.  ibuf int32: (n, m, cmax, cap,
// w_off, p_off, c_off, g_off, r_off) per market, then each market's counts
// [m] at c_off.  out int32: rounds [markets], the unit-price grids (float32
// bits) at markets + g_off, agent_of at markets + total_grid + r_off and
// unit_of total_req further.  max_n / max_m / max_cmax bound every market;
// the instance and the shared memory are `auction_solve_plan`'s.  Returns
// the first CUDA error.
extern "C" int auction_solve_launch(const void* fbuf, const void* ibuf,
                                    void* out, int markets, int max_n,
                                    int max_m, int max_cmax, int total_grid,
                                    int total_req, void* stream) {
  if (markets == 0) return static_cast<int>(cudaSuccess);
  int info[2];
  const int err = auction_solve_plan(max_n, max_m, max_cmax, info);
  if (err != static_cast<int>(cudaSuccess)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(info[1]);
  return static_cast<int>(
      info[0] ? launch_solve<true>(fbuf, ibuf, out, markets, total_grid,
                                   total_req, smem, s)
              : launch_solve<false>(fbuf, ibuf, out, markets, total_grid,
                                    total_req, smem, s));
}

// The fused mode: one market of `*args` (device pointers), one block, on
// `stream`; the instance and the shared memory are `auction_solve_plan`'s
// for (n, m, cmax).  Returns the first CUDA error.
extern "C" int auction_fused_launch(const FusedSolveArgs* args, void* stream) {
  int info[2];
  const int err = auction_solve_plan(args->n, args->m, args->cmax, info);
  if (err != static_cast<int>(cudaSuccess)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(info[1]);
  return static_cast<int>(info[0] ? launch_fused<true>(*args, smem, s)
                                  : launch_fused<false>(*args, smem, s));
}

// sizeof(FusedSolveArgs), so the caller can check its mirror of the layout
extern "C" int auction_fused_args_size() {
  return static_cast<int>(sizeof(FusedSolveArgs));
}
