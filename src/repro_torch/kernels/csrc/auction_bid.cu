// One Jacobi forward-bidding round of the capacitated column auction (Phase 2).
//
// Replaces: the Pallas kernel `auction_bid` in src/repro/kernels/auction_bid.py
// (body `_bid_kernel`).  Per active request row j of W [n, m]:
//   P = W - ask;  v1, k1 = max and lowest argmax of P;
//   v2 = max of P with ask2 in place of ask at k1, floored at 0;
//   wants = v1 > 0;  bid = ask[k1] + (v1 - v2) + eps;
// per agent i: best = largest bid at i (-FLT_MAX/4 if none), winner = lowest
// row at that bid (n if none).
//
// Bound on an H100: bytes (W is read once; a few operations per element), but
// at the router's markets (n <= a few hundred rows, m = 128 agents) W is tens
// of KB, nanoseconds of memory traffic, so in practice a round costs its
// launches and the wait for the host to read the loop condition.  The TPU
// kernel folds the per-agent segment max through a grid that runs in order on
// one core; blocks on this card run in no order, so the fold becomes atomics.
//
// Design: one warp per request row.  Lanes stride the row (coalesced loads),
// keep a lane-local (max, lowest index) and combine them with shuffles that
// break ties to the lower index, so k1 is the first argmax as in the
// reference.  The segment max is one 64-bit atomicMax per bidding row on the
// key (ordered_bits(bid) << 32) | (0xFFFFFFFF - j): the largest bid wins and,
// at equal bids, the lowest j, whatever order the atomics land in.  The key
// is safe because a bidding row has v1 > 0 and v2 <= v1 (ask2 >= ask), so
// bid >= eps > 0 and -0.0 never competes.  A second small kernel decodes the
// keys; untouched keys (0) become best = -FLT_MAX/4, winner = n.  Every
// arithmetic step uses the _rn intrinsics, so nothing is contracted and the
// result is bit-identical to the plain version.
#include <cfloat>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr float kNoBid = -(FLT_MAX / 4.0f);

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

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
  const float* w = W + row * m;

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
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float ov = __shfl_xor_sync(0xffffffffu, v1, off);
    const int ok = __shfl_xor_sync(0xffffffffu, k1, off);
    if (ov > v1 || (ov == v1 && ok < k1)) {
      v1 = ov;
      k1 = ok;
    }
  }

  // runner-up: the favourite agent re-enters at its second-cheapest unit
  float v2 = -CUDART_INF_F;
  for (int i = lane; i < m; i += kWarp) {
    const float a = (i == k1) ? ask2[i] : ask[i];
    const float p = __fsub_rn(w[i], a);
    v2 = p > v2 ? p : v2;
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float ov = __shfl_xor_sync(0xffffffffu, v2, off);
    v2 = ov > v2 ? ov : v2;
  }
  v2 = v2 > 0.0f ? v2 : 0.0f;

  const bool bids = v1 > 0.0f;
  if (lane == 0) {
    wants[row] = bids ? 1 : 0;
    if (bids) {
      const float bid = __fadd_rn(__fadd_rn(ask[k1], __fsub_rn(v1, v2)), eps);
      const unsigned long long key =
          (static_cast<unsigned long long>(ordered_bits(bid)) << 32) |
          static_cast<unsigned long long>(0xffffffffu -
                                          static_cast<uint32_t>(row));
      atomicMax(keys + k1, key);
    }
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
    winner[i] = static_cast<int32_t>(
        0xffffffffu - static_cast<uint32_t>(key & 0xffffffffull));
  }
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
