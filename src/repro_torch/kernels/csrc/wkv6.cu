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
// inside `states` serves as one).  The backward from the checkpoints
// (wkv6_bwd.cu) recomputes each segment's 16 states from its checkpoint
// with the state-only instances of both passes (wkv6_fwd.cuh, where the
// kernels live): pass A writes only k_dec and exp(p_last), pass B stages
// only what the update reads; the states are the forward's bits.
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
#include "wkv6_fwd.cuh"

using wkv6_fwd::bf16;

// Floats of scratch a run over n_run chunks needs (the wrapper allocates
// them).
extern "C" long long wkv6_scratch_floats(int b, int n_run, int h, int dk,
                                         int is_bf16) {
  return dk > 0 ? wkv6_fwd::scratch_floats(b, n_run, h, is_bf16, true) : 0;
}
// r, k, v [b, s_len, h, dk] (all float32: is_bf16 = 0, or all bf16:
// is_bf16 = 1), log_w [b, s_len, h, dk] float32, u [h, dk] float32:
// contiguous, on the device; 0 < dk <= 64.  Runs the chunks c0 ..
// c0 + n_run - 1 of the sequence, from s0 (or null: a zero state), the
// state of batch·head bh at s0 + bh·s0_stride floats, each a contiguous
// [dk, dk] float32 matrix (s0_stride = dk·dk for a [b, h, dk, dk] s0; a
// checkpoint of `states` has a longer stride).  o [b, s_len, h, dk] in r's
// type receives those chunks' rows; s_out (or null) [b, h, dk, dk]
// float32 the state after them; states (or null: none kept) [b, h,
// ceil(n_run / every), dk, dk] float32 the incoming state of every
// `every`-th chunk of the run, from its first (the backward's
// checkpoints: wkv6_bwd.cu).  o, s_out and the kept states are the same
// bits whatever is kept.  scratch holds wkv6_scratch_floats(b, n_run, h,
// dk, is_bf16) floats.  vec: bf16 v 16-byte aligned with dk a multiple
// of 8, so its tiles go by cp.async.  Two launches on `stream`; returns
// the first failing cudaGetLastError().
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* log_w, const void* u, const void* s0,
                           int s0_stride, void* scratch, void* o,
                           void* s_out, void* states, int b, int s_len,
                           int h, int dk, int is_bf16, int vec, int c0,
                           int n_run, int every, void* stream) {
  const int n_chunks = (s_len + wkv6_fwd::kChunk - 1) / wkv6_fwd::kChunk;
  if (dk <= 0 || dk > wkv6_fwd::kMaxK || s_len < 0 || c0 < 0 || n_run < 0 ||
      c0 + n_run > n_chunks || every < 1 || !o)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? wkv6_fwd::launch_forward<bf16>(
                    r, k, v, log_w, u, s0, s0_stride, scratch, o, s_out,
                    states, b, s_len, h, dk, vec, c0, n_run, every, st)
              : wkv6_fwd::launch_forward<float>(
                    r, k, v, log_w, u, s0, s0_stride, scratch, o, s_out,
                    states, b, s_len, h, dk, 0, c0, n_run, every, st);
  return static_cast<int>(err);
}
