// Phase 1 of the fused routing step in one pass: for every (request, agent)
// pair of the padded (nb, mb) grid, the Eq.-4 affinity from the gathered
// LCP, the parent credit, the 10 Eq.-5 features, three stacked-forest
// descents, the cold-start prior blend, the Eq.-1 value and the pruned,
// masked welfare weight, plus the largest weight any agent with units can
// sell at (wmax, the anchor of the auction's ε schedule).
//
// Replaces: the Phase-1 half of the reference's fused program,
// src/repro/core/routing_fused.py:212-308 (one XLA program on the TPU; it
// has no Pallas kernel).  The LCP itself comes from `lcp_gather_kernel`
// (csrc/lcp_affinity.cu), launched just before over the request rows and
// the parent-candidate rows stacked.
//
// One thread per pair.  The body is ~100 small element-wise steps (three
// forests of depth >= 4, the blend, the value), which XLA fuses into a few
// loops on the TPU; as separate PyTorch launches they would leave the card
// idle between tiny kernels.  The pair reads its ledger length and the
// forests' nodes by index (L1/L2), writes lat, cst, qual, the value, the 10
// features and W, and folds its W into wmax: a warp max, then one integer
// atomicMax per warp on the float bits (W >= 0, so the order of the bits is
// the order of the values, and max is exact in any order).
//
// Bit-exactness with the plain version (`kernels/routing_fused.py::
// fused_phase1_plain`, PyTorch float32 on the CPU): every arithmetic step
// is an _rn intrinsic in the plain version's op order (the compiler never
// contracts those into an FMA), the comparisons, min/max and truncf are
// exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarp = 32;
constexpr int kFeatures = 10;

}  // namespace

// One target's stacked forest on the device: node arrays padded to a pow-2
// pool (padded nodes are leaves), the root of each (padded) agent's tree,
// and the bucketed walk depth.
struct Forest {
  const int32_t* feature;
  const int32_t* left;
  const int32_t* right;
  const int32_t* roots;
  const float* threshold;
  const float* value;
  int32_t depth;
  int32_t pad_;
};

// Every input and output of one launch (device pointers), laid out as the
// ctypes structure of kernels/routing_fused.py.
struct Phase1Args {
  const int32_t* lcp;         // [nb + cb, mb] gathered LCP (requests, then
  const int32_t* rows;        // [nb + cb, mb] arena rows  candidates)
  const int32_t* alen;        // [S] arena row lengths
  const int32_t* plen;        // [nb] prompt lengths
  const int32_t* cj;          // [cb] request of each candidate (nb: none)
  const int32_t* keep;        // [nb, mb] LRU keep mask
  const int32_t* ckeep;       // [cb, mb] candidates' keep mask
  const int32_t* ext;         // [mb] extension-only (recurrent) agents
  const int32_t* req_mask;    // [nb]
  const int32_t* agent_mask;  // [mb]
  const int32_t* counts;      // [mb] units per agent
  const float* turns;         // [nb]
  const float* dom;           // [nb, mb] domain match
  const float* router;        // [2] router in-flight, router rps
  const float* inflight;      // [mb]
  const float* rps;           // [mb]
  const float* caps;          // [mb]
  const float* blend;         // [11, mb] per-agent prior and blend knobs
  const float* val_cfg;       // [3] delta, latency scale, value scale
  Forest forest[3];           // lat, cost, quality
  float* wmax;                // [1], zeroed by the launcher
  float* lat;                 // [nb, mb]
  float* cst;                 // [nb, mb]
  float* qual;                // [nb, mb]
  float* values;              // [nb, mb]
  float* X;                   // [nb, mb, 10]
  float* W;                   // [nb, mb]
  int32_t nb, mb, cb;
};

namespace {

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Eq.-4 score of one (prompt, ledger row) pair from its raw LCP
__device__ __forceinline__ float affinity(int raw, int llen, int plen,
                                          bool ext) {
  const int lcp = min(raw, min(plen, llen));
  const float pl1 = static_cast<float>(max(plen, 1));
  if (ext)  // recurrent agents: exact-extension-only cache reuse
    return (lcp == llen && llen > 0)
               ? __fdiv_rn(static_cast<float>(llen), pl1)
               : 0.0f;
  return __fdiv_rn(static_cast<float>(lcp), pl1);
}

__device__ __forceinline__ float descend(const Forest& f, const float* x,
                                         int agent) {
  int cur = f.roots[agent];
  for (int it = 0; it < f.depth; ++it) {
    const int ft = f.feature[cur];
    if (ft < 0) break;  // a leaf stays where it is for the remaining steps
    cur = x[ft] <= f.threshold[cur] ? f.left[cur] : f.right[cur];
  }
  return f.value[cur];
}

__global__ void __launch_bounds__(kBlock)
    fused_phase1_kernel(const Phase1Args a) {
  const int pairs = a.nb * a.mb;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  float wm = 0.0f;
  if (p < pairs) {
    const int j = p / a.mb, i = p % a.mb;
    const bool ext = a.ext[i] != 0;
    const int pl = a.plen[j];
    // (a) Eq.-4 affinity, LRU-masked, raised by the parent credit
    float o = a.keep[p] ? affinity(a.lcp[p], a.alen[a.rows[p]], pl, ext)
                        : 0.0f;
    for (int c = 0; c < a.cb; ++c) {
      if (a.cj[c] != j) continue;
      const int q = (a.nb + c) * a.mb + i;
      const float cred =
          a.ckeep[c * a.mb + i]
              ? affinity(a.lcp[q], a.alen[a.rows[q]], pl, ext)
              : 0.0f;
      o = fmaxf(o, cred);
    }
    // (b) the Eq.-5 features
    float x[kFeatures];
    x[0] = static_cast<float>(pl);
    x[1] = a.turns[j];
    x[2] = o;
    x[3] = a.router[0];
    x[4] = a.router[1];
    x[5] = a.inflight[i];
    x[6] = a.rps[i];
    x[7] = a.caps[i];
    x[8] = __fdiv_rn(a.inflight[i], fmaxf(1.0f, a.caps[i]));
    x[9] = a.dom[p];
    // (c) the stacked forests, then the prior blend
    const float raw_lat = descend(a.forest[0], x, i);
    const float raw_cst = descend(a.forest[1], x, i);
    const float raw_q = descend(a.forest[2], x, i);
    const float* b = a.blend;
    const int mb = a.mb;
    const float lpt = b[0 * mb + i], lb = b[1 * mb + i], miss = b[2 * mb + i],
                hit = b[3 * mb + i], out = b[4 * mb + i],
                ewma = b[5 * mb + i], n_obs = b[6 * mb + i],
                warm_n = b[7 * mb + i], prior_q = b[8 * mb + i],
                rep = b[9 * mb + i], expl = b[10 * mb + i];
    const float uncached = __fmul_rn(x[0], __fsub_rn(1.0f, x[2]));
    const float prior_lat = __fmul_rn(__fadd_rn(lb, __fmul_rn(lpt, uncached)),
                                      __fadd_rn(1.0f, x[8]));
    const float npmt = truncf(x[0]);
    const float nhit = __fmul_rn(x[2], npmt);
    const float prior_cst =
        __fadd_rn(__fadd_rn(__fmul_rn(miss, __fsub_rn(npmt, nhit)),
                            __fmul_rn(hit, nhit)),
                  __fmul_rn(out, ewma));
    const float wgt = __fmul_rn(fminf(1.0f, __fdiv_rn(n_obs, 60.0f)), rep);
    const float keep_w = __fsub_rn(1.0f, wgt);
    float lat = __fadd_rn(__fmul_rn(keep_w, prior_lat),
                          __fmul_rn(wgt, fmaxf(0.0f, raw_lat)));
    float cst = __fadd_rn(__fmul_rn(keep_w, prior_cst),
                          __fmul_rn(wgt, fmaxf(0.0f, raw_cst)));
    const bool cold = n_obs < warm_n;
    if (cold) {
      lat = prior_lat;
      cst = prior_cst;
    }
    float qual = cold ? __fmul_rn(prior_q, rep) : __fmul_rn(clip01(raw_q), rep);
    if (expl != 0.0f)  // the optimism bonus, only where the knob is set
      qual = fminf(1.0f, __fadd_rn(qual, __fdiv_rn(expl, __fsqrt_rn(
                                                        __fadd_rn(1.0f, n_obs)))));
    // Eq.-1 value, then the pruned and masked welfare weight
    const float delta = a.val_cfg[0], lscale = a.val_cfg[1],
                vscale = a.val_cfg[2];
    const float value = __fmul_rn(
        vscale, __fsub_rn(__fmul_rn(delta, clip01(qual)),
                          __fdiv_rn(__fmul_rn(__fsub_rn(1.0f, delta), lat),
                                    lscale)));
    float w = __fsub_rn(value, cst);
    w = w > 0.0f ? w : 0.0f;
    if (!(a.req_mask[j] && a.agent_mask[i])) w = 0.0f;
    wm = a.counts[i] > 0 ? w : 0.0f;
    a.lat[p] = lat;
    a.cst[p] = cst;
    a.qual[p] = qual;
    a.values[p] = value;
    a.W[p] = w;
    float* xo = a.X + static_cast<int64_t>(p) * kFeatures;
#pragma unroll
    for (int k = 0; k < kFeatures; ++k) xo[k] = x[k];
  }
  for (int off = kWarp / 2; off > 0; off /= 2)
    wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, off));
  if (threadIdx.x % kWarp == 0 && wm > 0.0f)
    atomicMax(reinterpret_cast<int*>(a.wmax), __float_as_int(wm));
}

}  // namespace

// One launch over the (nb, mb) grid of `*args` (device pointers), on
// `stream`; zeroes wmax first.  Returns the first CUDA error.
extern "C" int fused_phase1_launch(const Phase1Args* args, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(args->wmax, 0, sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = args->nb * args->mb;
  if (pairs == 0) return static_cast<int>(cudaSuccess);
  fused_phase1_kernel<<<(pairs + kBlock - 1) / kBlock, kBlock, 0, s>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(Phase1Args), so the caller can check its mirror of the layout
extern "C" int fused_phase1_args_size() {
  return static_cast<int>(sizeof(Phase1Args));
}
