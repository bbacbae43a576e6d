// Mamba-2 SSD scan in chunks of 16 tokens, from an initial state.
//
// Replaces: the Pallas kernel `ssd` in src/repro/kernels/ssd.py (body
// `_ssd_kernel`): x [B, S, H, hd] (float32 or bf16), B and C [B, S, ds]
// (x's dtype, shared by all heads), dt [B, S, H] float32 (after the
// softplus), a_log and the skip D [H] float32 -> y [B, S, H, hd] (x's
// dtype) and the final state sT [B, H, hd, ds] float32.  Per head the
// recurrence is
//   S_t = a_t S_{t-1} + dt_t (x_t outer B_t),  y_t = S_t @ C_t + D x_t,
// with the scalar decay a_t = exp(la_t), la_t = -exp(a_log) dt_t.  The TPU
// kernel starts from a zero state; this one takes an initial state s0 (a
// null pointer: zeros, with no buffer filled), the function of the
// reference's `models/ssm.py::ssd_chunked`.  Per chunk of 16 tokens, in
// float32: p = inclusive cumsum of la; M[t][s] = (C_t·B_s) exp(p_t - p_s)
// dt_s for s <= t; y = M x + exp(p)·(C Sᵀ) + D x; S = exp(p_last) S +
// Σ_s w_s x_s Bᵀ_s with w_s = exp(p_last - p_s) dt_s.  la <= 0, so every
// exponent p_t - p_s (s <= t) and p_last - p_s is <= 0; the warp scan sums
// in another order than a serial one, so the kernel clamps each such
// exponent at 0, and a masked pair is never evaluated.  A ragged last
// chunk reads x = B = C = 0 and dt = 0 past S: the identity.
//
// Bound on an H100: per call it reads x, B and C once (not once per head),
// dt and the initial state and writes y and the final state: ~19 MB for
// zamba2-7b at S = 512 (H = 112, hd = ds = 64, bf16), ~6 µs at 3.35 TB/s.
// The products are ~1.2 GFLOP, ~1.2 µs at the bf16 tensor-core rate even
// with the split operands below.  What bounded the first version (one
// block per head and 16 state rows walking the chunks, one output per
// thread) was neither: 2–4 shared-memory loads per FMA, C·Bᵀ recomputed by
// every (head, row block), and a serial cumsum behind two barriers.  What
// bounds this one is the serial pass's step, ~0.8 µs a chunk whatever the
// heads or bytes (a block per head, one SM each): its barriers, starting
// its copies and two dependent rounds of `mma`s and reductions.
// On an H100 80GB HBM3 at 700 W it took 0.0203 ms of device time per
// zamba2-7b main-path call, 3.3x its bound (PERF.md).
//
// Design: two launches per call.
//
// `ssd_intra_kernel` (pass A), one block of 4 warps per (batch, chunk,
// 4 heads): everything that does not need the carried state, for all
// chunks at once.  C·Bᵀ is formed once per block on the tensor cores; per
// head (a warp each) p is a warp scan (`__shfl_up_sync`), M is built in
// registers as the A fragment of M·x, and y_intra = M·x + D·x, the state
// update's weights w_s, exp(p_t) and exp(p_last) go to a float32 scratch
// buffer that the wrapper allocates: per (batch, chunk, head) a [16, hdq]
// tile of y_intra (hdq = hd rounded up to 64) and 36 coefficients.  For
// zamba2-7b at 314 tokens that is 9.5 MB (14.9 MB at 512), inside the 50 MB
// L2.  w is kept rather than w∘x (16 floats, not 16·hd): pass B multiplies
// it into the x it reads anyway.
//
// `ssd_state_kernel` (pass B), one block of 16 warps per (batch·head, 64
// rows of the state): the serial walk over chunks, with only the two
// products that need the state.  Each warp holds a 16 x 16 piece of the
// float32 state (16 rows by a quarter of ds) in registers as `mma`
// accumulator fragments, which are also, element for element, the B
// fragments of C·Sᵀ: no shuffle or shared round trip.  Per chunk each warp
// forms its part of C·Sᵀ and updates its piece,
// S = exp(p_last)·S + (w∘x)ᵀ·B; the 4 warps of a row slice then sum their
// parts through shared memory (a named barrier per slice) and each writes
// 4 rows of y = y_intra + exp(p)·(C·Sᵀ) in x's type.  The warps share the
// staging of the chunks' C, B, x, y_intra and coefficients by `cp.async`
// into a ring of shared stages (one block barrier per chunk), three chunks
// ahead of the one computed, each thread with fixed copy slots (at most
// two 16-byte copies a chunk, their sources advancing by a fixed stride):
// staging through a general tile loop spent most of a chunk's
// instructions on address arithmetic.  The incoming state of every
// `every`-th chunk (16 KiB per head and chunk) is stored when the caller
// gives a `states` buffer: training keeps every 16th, the backward's
// checkpoints (29.4 MB for zamba2-7b at 4,096 tokens, against 469.8 MB for
// every chunk's), as the reference's `chunk_scan_checkpointed` keeps every
// 16th state; what is kept never changes the output's bits.  A launch
// runs a range of chunks from a given state, s0 read with a stride (a
// checkpoint inside `states` serves as one).  The backward from the checkpoints
// (ssd_bwd.cu) recomputes each segment's 16 states from its checkpoint
// with the state-only instances of both passes (ssd_fwd.cuh, where the
// kernels live): pass A writes only w and exp(p_last), pass B stages only
// B, x and those; the states are the forward's bits.
//
// Precision (scan_mma.cuh): in the bf16 instance x, B and C enter the
// `mma`s exactly; M, w∘x and the state are split into two bf16 parts
// (about 16 mantissa bits), one rounding being too coarse for a state that
// accumulates over every chunk.  The float32 instance splits every operand
// into three parts (six products, about float32's 24 bits).
//
// Ragged widths: ds is zero-padded to 64 in shared memory (the products
// stop at the multiple of 16 that covers it), hd is walked in pieces of 64,
// and widths that are not multiples of 8 (or float32 inputs) are staged
// element by element instead of by `cp.async`.
#include "ssd_fwd.cuh"

using ssd_fwd::bf16;

// Floats of scratch a run over n_run chunks needs (the wrapper allocates
// them).
extern "C" long long ssd_scratch_floats(int b, int n_run, int h, int hd) {
  return ssd_fwd::scratch_floats(b, n_run, h, hd, true);
}

// x [b, s_len, h, hd] and bm, cm [b, s_len, ds] (all float32: is_bf16 =
// 0, or all bf16: is_bf16 = 1), dt [b, s_len, h], a_log and d_skip [h]
// float32: contiguous, on the device; 0 < ds <= 64.  Runs the chunks c0
// .. c0 + n_run - 1 of the sequence, from s0 (or null: a zero state), the
// state of batch·head bh at s0 + bh·s0_stride floats, each a contiguous
// [hd, ds] float32 matrix (s0_stride = hd·ds for a [b, h, hd, ds] s0; a
// checkpoint of `states` has a longer stride).  y [b, s_len, h, hd] in x's
// type receives those chunks' rows; s_out (or null) [b, h, hd, ds]
// float32 the state after them; states (or null: none kept) [b, h,
// ceil(n_run / every), hd, ds] float32 the incoming state of every
// `every`-th chunk of the run, from its first (the backward's
// checkpoints: ssd_bwd.cu).  y, s_out and the kept states are the same
// bits whatever is kept.  scratch holds ssd_scratch_floats(b, n_run, h,
// hd) floats.  vec_x / vec_bc: bf16 x (B and C) 16-byte aligned with hd
// (ds) a multiple of 8, so their tiles go by cp.async.  Two launches on
// `stream`; returns the first failing cudaGetLastError().
extern "C" int ssd_launch(const void* x, const void* bm, const void* cm,
                          const void* dt, const void* a_log,
                          const void* d_skip, const void* s0,
                          int s0_stride, void* scratch, void* y,
                          void* s_out, void* states, int b, int s_len, int h,
                          int hd, int ds, int is_bf16, int vec_x, int vec_bc,
                          int c0, int n_run, int every, void* stream) {
  const int n_chunks = (s_len + ssd_fwd::kChunk - 1) / ssd_fwd::kChunk;
  if (ds <= 0 || ds > ssd_fwd::kMaxN || hd <= 0 || s_len < 0 || c0 < 0 ||
      n_run < 0 || c0 + n_run > n_chunks || every < 1 || !y)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? ssd_fwd::launch_forward<bf16>(
                    x, bm, cm, dt, a_log, d_skip, s0, s0_stride, scratch, y,
                    s_out, states, b, s_len, h, hd, ds, vec_x, vec_bc, c0,
                    n_run, every, st)
              : ssd_fwd::launch_forward<float>(
                    x, bm, cm, dt, a_log, d_skip, s0, s0_stride, scratch, y,
                    s_out, states, b, s_len, h, hd, ds, 0, 0, c0, n_run,
                    every, st);
  return static_cast<int>(err);
}
