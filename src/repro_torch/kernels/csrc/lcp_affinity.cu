// Batched longest-common-prefix for the router's Eq.-4 affinity (Phase 1a).
//
// Replaces: the Pallas kernel `lcp_affinity` in src/repro/kernels/lcp_affinity.py
// (body `_lcp_kernel`): prompts [N, L] int32 (pad -1) against each request's M
// ledger rows [N, M, L] int32 (pad -2) -> lcp [N, M] int32.
//
// Bound on an H100: bytes.  One pair needs its ledger tokens up to the first
// mismatch (plus the prompt's, which the M pairs of a request share through
// L2) and does one integer compare per token, far below the card's operation
// rate.  The TPU kernel reads every token of every row: its lanes cannot
// leave a loop early, so it computes the prefix as a cumulative product of
// equalities over the whole width.
//
// Design: one warp per (request, agent) pair.  The warp walks the row in
// 32-token chunks, each lane comparing one token (neighbouring lanes on
// neighbouring addresses, so a chunk is one 128-byte load per operand), takes
// __ballot_sync of the mismatches and stops at the first set bit (__ffs).  A
// pair whose ledger row diverges early, or is absent (the all-pad row), costs
// one chunk instead of L / 32.  Lanes past L count as a mismatch at L, so the
// width need not be a multiple of 32.  The padding tokens never match each
// other, so a prefix never runs into padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;  // 8 warps = 8 pairs per block

__global__ void lcp_kernel(const int32_t* __restrict__ prompts,
                           const int32_t* __restrict__ ledgers,
                           int32_t* __restrict__ out,
                           int64_t pairs, int m, int length) {
  const int64_t pair =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (pair >= pairs) return;  // uniform across the warp
  const int64_t request = pair / m;
  const int32_t* p = prompts + request * length;
  const int32_t* l = ledgers + pair * length;
  int lcp = length;
  for (int base = 0; base < length; base += kWarp) {
    const int t = base + lane;
    const bool mismatch = (t >= length) || (__ldg(p + t) != __ldg(l + t));
    const unsigned ballot = __ballot_sync(0xffffffffu, mismatch);
    if (ballot != 0u) {
      lcp = base + __ffs(ballot) - 1;
      break;
    }
  }
  if (lane == 0) out[pair] = lcp < length ? lcp : length;
}

}  // namespace

// prompts [n, length], ledgers [n, m, length], out [n, m]: int32, contiguous,
// on the device.  Launches on `stream`; returns cudaGetLastError().
extern "C" int lcp_affinity_launch(const void* prompts, const void* ledgers,
                                   void* out, int n, int m, int length,
                                   void* stream) {
  const int64_t pairs = static_cast<int64_t>(n) * m;
  if (pairs == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (pairs * kWarp + kBlock - 1) / kBlock;
  lcp_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(prompts),
      static_cast<const int32_t*>(ledgers), static_cast<int32_t*>(out), pairs,
      m, length);
  return static_cast<int>(cudaGetLastError());
}
