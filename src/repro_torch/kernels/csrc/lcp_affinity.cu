// Batched longest-common-prefix for the router's Eq.-4 affinity (Phase 1a):
// over a dense ledger tile (`lcp_kernel`) and gathered from a
// device-resident ledger arena by row index (`lcp_gather_kernel`).
//
// Replaces: the Pallas kernel `lcp_affinity` in src/repro/kernels/lcp_affinity.py
// (body `_lcp_kernel`): prompts [N, L] int32 (pad -1) against each request's M
// ledger rows [N, M, L] int32 (pad -2) -> lcp [N, M] int32.  The reference's
// fused routing step keeps the ledger arena on the device and gathers the
// rows by index (src/repro/core/routing_fused.py, `lcp_scores`); the gather
// kernel is that form.
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

// The gather form: one block per request.  The block stages its prompt in
// shared memory once for its m pairs; one warp per pair reads the pair's
// arena row in place (rows[j, i], row 0 being the all-pad sentinel) with the
// same first-mismatch ballot.  Tokens past the arena's width la count as a
// mismatch, tokens past the prompt's width lp end the walk at lp.  Bound on
// an H100: bytes, as above; the arena stays on the device, so what crosses
// from the host per batch is the prompts, the row indices and the arena
// rows written since the last batch, instead of the whole [n, m, L] tile.
__global__ void lcp_gather_kernel(const int32_t* __restrict__ prompts,
                                  const int32_t* __restrict__ arena,
                                  const int32_t* __restrict__ rows,
                                  int32_t* __restrict__ out, int m, int lp,
                                  int la) {
  extern __shared__ int32_t prompt[];
  const int64_t request = blockIdx.x;
  for (int t = threadIdx.x; t < lp; t += blockDim.x)
    prompt[t] = prompts[request * lp + t];
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  for (int i = threadIdx.x / kWarp; i < m; i += warps) {
    const int32_t* row = arena + static_cast<int64_t>(rows[request * m + i]) * la;
    int lcp = lp;
    for (int base = 0; base < lp; base += kWarp) {
      const int t = base + lane;
      const bool mismatch =
          t >= lp || t >= la || prompt[t] != __ldg(row + t);
      const unsigned ballot = __ballot_sync(0xffffffffu, mismatch);
      if (ballot != 0u) {
        lcp = base + __ffs(ballot) - 1;
        break;
      }
    }
    if (lane == 0) out[request * m + i] = lcp < lp ? lcp : lp;
  }
}

}  // namespace

// prompts [n, lp] (pad -1), arena [s, la] (pad -2), rows [n, m] (indices
// into the arena's rows), out [n, m]: int32, contiguous, on the device.
// Launches on `stream` with lp * 4 bytes of dynamic shared memory; returns
// the first CUDA error.
extern "C" int lcp_gather_launch(const void* prompts, const void* arena,
                                 const void* rows, void* out, int n, int m,
                                 int lp, int la, void* stream) {
  if (n == 0 || m == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(lp) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      lcp_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lcp_gather_kernel<<<n, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(prompts), static_cast<const int32_t*>(arena),
      static_cast<const int32_t*>(rows), static_cast<int32_t*>(out), m, lp,
      la);
  return static_cast<int>(cudaGetLastError());
}

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
