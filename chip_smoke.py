#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA device and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order (any failure raises and ends the run with a non-zero exit):

1. Device report: ``nvidia-smi`` name and power limit, torch and CUDA
   versions.
2. Build: all ten kernel libraries from ``src/repro_torch/kernels/csrc``
   with one ``nvcc`` each, started together; prints each kernel instance's
   registers, static shared memory and spills from ``-Xptxas -v``
   (``auction_solve_kernel``, ``auction_fused_kernel``,
   ``lcp_gather_kernel``, ``fused_phase1_kernel``, the flash backward's
   ``delta_kernel``, ``dkdv_kernel``, ``dq_kernel``, ``dkdv_tc_kernel``
   and ``dq_tc_kernel``, and the scan backwards' kernels
   ``wkv6_bwd_reverse_kernel``, ``wkv6_bwd_intra_kernel``,
   ``wkv6_bwd_du_kernel``, ``ssd_bwd_reverse_kernel``,
   ``ssd_bwd_intra_kernel``, ``ssd_bwd_sum_kernel`` and
   ``ssd_bwd_head_kernel`` must be among them), and the count of
   tensor-core instructions (``HMMA``/``HGMMA``) in the SASS of every
   instance of the bf16 flash kernel, of the bf16 flash backward's two
   kernels (16 instances; a spill at head dims padded to 64 or 128 also
   fails), of both passes of each scan (``wkv6_intra_kernel``,
   ``wkv6_state_kernel``, ``ssd_intra_kernel``, ``ssd_state_kernel``,
   bf16 and float32) and of both tensor-core passes of each scan backward
   (the four kernels named ``*_bwd_reverse_kernel`` and
   ``*_bwd_intra_kernel``, bf16 and float32: 8 instances, where a spill
   also fails; ``cuobjdump -sass``): 0 fails.  Then the forward's LSE at
   phase 25's calls against the plain LSE within 1e-4, its output the
   same bits with and without the LSE.
3. The router's kernels against their plain PyTorch versions, bit for bit,
   at the router path's shapes: LCP at prompts [64, 1024] x ledgers
   [64, 128, 1024] and at a width that is not a multiple of 32; the row
   gather at prompts [64, 1024] against a 300-row arena whose rows many
   pairs share, at width 1000 and with prompts wider than the arena; the
   bidding round at (64, 128), (1024, 128) and (64, 16), with ties; the
   staged solve (``auction_solve``, against the host-driven staged market
   on host copies: unit prices, assignment and rounds) on a 64 x 128 x 12
   market cold and warm, 8 uneven hub markets in one launch, a warm market
   whose budget trips, tied weights, and a market whose W does not fit in
   shared memory.  Each timed with CUDA events.
4. Router lockstep (the router's main path), twice: at one hub and at the
   ``SCALE_128`` preset's 8 hubs, spill on.  Two ``IEMASRouter``s over the
   128-agent fleet (warm starts, settlement ledger), one on the card with
   the kernels and one on the CPU with the plain versions, route the same
   seeded coqa_like + quac_like closed loop (batches of <= 64, >= 300
   requests) served on the port's analytic engines.  Decisions, accounts,
   the ledger head and every solve's bid rounds must be identical;
   ``lcp_gather`` must launch once per batch, ``auction_bid`` and
   ``lcp_affinity`` never, and ``auction_solve`` once per solve (a
   ``solve_batch`` call, a single or spill solve, a cold re-solve).  Prints
   route_batch latency, throughput, ms per router phase, the host time of
   the solve calls and of the Clarke payments, bid rounds per solve and
   the ledger bytes sent per batch.
5. Each router kernel against its plain version again, and timed, at the
   inputs of every call the main path made to it in phase 4
   (``auction_solve``, ``lcp_gather``); the one-round ``auction_bid`` and
   the dense-tile ``lcp_affinity``, which the main path no longer
   launches, at the same data (the bidding rounds of the plain replay of
   those solves, the gathers' dense tiles).  Every kernel's figures
   (here and in phases 6, 8, 10, 12, 13, 19, 21–23) give two times per
   call: ``ms``, CUDA events around back-to-back wrapper calls,
   and ``device_ms``, the CUDA time of the op's kernels in a
   ``torch.profiler`` trace over the op's calls (opened by spin kernels
   that take the loss of a trace's first records; CUPTI kept attached
   between traces), counted only when the trace holds a record of each
   of the op's kernels for every call (after three traces short of that,
   CUDA events with the host queued ahead; each printed device time and
   the JSON line's ``device_ms_from`` say which); where the first is much
   larger, the wrapper (host), not the kernel body, bounds the op.
6. The attention kernels against their plain versions (2e-5 in float32,
   3e-2 in bfloat16) at synthetic full-width shapes: qwen3-8b's layers
   (prefill buckets 128 and 512) and zamba2-7b's shared block (32 / 32
   heads of 112; prompts of 61 and 512), decode at M = 1024 under a random
   mask; each timed beside its plain version and PyTorch's
   ``scaled_dot_product_attention`` (the yardstick only: the port never
   calls it).
7. Serving-engine lockstep: qwen3-8b at full width, 2 layers, float32
   (TF32 off), the same weights on the card and on the CPU; two dialogues
   of three turns (fresh, extend, identical, LRU evictions with
   ``cache_slots=1``) must give identical tokens, cache hits and modes,
   and last-token logits within 2e-3 of their max.
8. The serving slice (the engine's main path): one qwen3-8b
   ``AgentEngine`` at full width in bf16 (36 layers, ``max_len`` 1024)
   serves multi-turn quac_like / coqa_like requests (fresh prefill, extend
   with a cache hit, an identical repeat); prints TTFT, decode time per
   token, tokens/s and cache hits per mode; ``flash_attention`` must launch
   36 times per fresh prefill and ``decode_attention`` 36 times per decode
   step, no-op steps included.  Then both attention kernels against their
   plain versions, and timed, at a sample of the inputs phase 8 gave them.
9. Router to real engines (the quickstart chain at full width): the CUDA
   router routes turn 1 and then turn 2 of two dialogues over two
   full-width qwen3-8b engines (phase 8's and one more, each seeded as the
   reference's cluster seeds its agents), fed back through
   ``on_complete``; every request is served, logits are finite, and a turn
   2 that returns to its turn-1 agent hits the cache.
10. The scan kernels against their plain versions at synthetic full-width
    shapes: WKV6 at rwkv6-3b's 40 heads of 64, SSD at zamba2-7b's 112
    heads of 64 (state 64); S = 61 and 512; float32 and bf16; zero and
    stored initial states; and, in both dtypes at S = 512 from a stored
    state, decays far past the usual clip (log_w down to -50, dt up to
    20), whose output must stay finite.  Float32 within 1e-3; a bf16 output
    within one bf16 rounding (|got - want| <= 2^-7·|want| + 1e-3) and the
    float32 state within 1e-3.  Each timed beside its plain version, with
    its bound.
11. Recurrent engine lockstep, CUDA vs CPU, float32 (TF32 off), the same
    weights: rwkv6-3b at full width and 2 layers (fresh, exact extension,
    the no-op repeat, a non-extension, LRU evictions), zamba2-7b at full
    width with 3 layers and ``attn_every=2`` (fresh, repeat,
    non-extension; an exact extension raises in both, as the reference's
    engine does).  Identical tokens, hits and modes; last-token logits
    within 2e-3 of their max; launch counts as below.
12. The rwkv6-3b slice: one ``AgentEngine`` at full width in bf16 (32
    layers, d_model 2560, 40 heads of 64) serves phase 8's multi-turn plan
    (fresh, extends with a hit, the no-op repeat); ``wkv6`` must launch 32
    times per fresh prefill or extend, the attention kernels never.  Then
    the kernel against its plain version at a sample of its main-path
    inputs, and timed.
13. The zamba2-7b slice: one ``AgentEngine`` at full width in bf16 (81
    Mamba-2 layers in 13 groups of 6 and a tail of 3, 112 SSD heads of
    64, a shared block of 32 heads of 112) serves first turns, no-op
    repeats and later turns that omit the answer (fresh); ``ssd`` must
    launch 81 times and ``flash_attention`` 13 times per fresh prefill,
    ``decode_attention`` 13 times per decode or no-op step.  Phases 12 and
    13 print TTFT, decode time per token, tokens/s and hits per mode, hold
    a direct prefill's greedy token against the engine's first, and read
    one prefill and one decode step with the profiler.
14. Mixed fleet: the CUDA router over phase 8's qwen3-8b engine and phase
    12's rwkv6-3b engine, ``AgentInfo.recurrent`` taken from the engines,
    routes two two-turn dialogues; every request is served, and a turn 2
    that returns to the rwkv agent as an exact extension hits the cache.
15. The fused router (``IEMASRouter(fused=True)``, the reference's
    ``core/routing_fused.py``): the SCALE_128 fleet at one hub, solver
    ``cuda``, warm starts and spill on, phase 4's closed loop on the
    analytic engines plus one batch whose DAG steps name parent sessions.
    The CUDA and the CPU fused routers must give identical decisions,
    payments, accounts, ledger head and rounds per solve; against the
    staged CUDA router the two-tier gate of tests/test_routing_fused.py
    holds on every batch until the first tier-2 batch (another assignment
    within the ε-optimality gap), where the comparison stops as the test's
    does.  Per batch exactly one launch each of ``lcp_gather``,
    ``fused_phase1`` and ``auction_fused`` (the fused mode of the solve,
    its cold fallback in the same launch), none of ``auction_bid`` and
    ``lcp_affinity``, ``auction_solve`` only for spill solves.  No sync
    between a step's first launch and the return of its fused solve
    (PyTorch's sync debug mode is "error" there, so one raises) and one
    synchronizing call after it, the copy (counted in "warn" mode); one
    device-to-host copy per step in a ``torch.profiler`` trace of each
    further step, until three traces hold kernel records (at most 8
    steps).  Then the steps'
    gathers and both fused kernels against
    their plain versions at every main-path input (the plain Phase-1 pass
    on the plain gather's LCP), timed, and on synthetic cases (cold
    and trained agents, recurrent and LRU-capped agents, the optimism
    bonus, parents, padding; the solve cold, warm and with a tripped warm
    budget).
16. Closed-loop serving on real engines, through the serving CLI
    (``repro_torch.launch.serve.main``, its cluster and router kept): the
    CLI's defaults (9 agents of ``agent_profiles(9)``: llama3-7b / qwen-8b /
    qwen-4b classes, float32, 6 / 6 / 4 layers, heads of 64 / 72 / 48; 16
    coqa_like dialogues; 6 new tokens; engine warm-up) with ``--solver
    cuda --warm-start --audit-ledger``, run twice: staged at 2 hubs and
    ``--fused`` at 1 hub.  Every dialogue finishes, the KV hit rate is
    above 0.5, the surplus is not negative and the settlement ledger
    audits clean; per routed batch exactly one ``lcp_gather`` launch (and
    one each of ``fused_phase1`` and ``auction_fused`` when fused),
    ``auction_solve`` once per solve, ``auction_bid`` and ``lcp_affinity``
    never; ``flash_attention`` once per layer of every fresh prefill and
    ``decode_attention`` once per layer of every decode and no-op step,
    warm-up included, exactly.  Each agent's requests are served again, in
    order, on a CPU engine holding the card engine's weights: the same
    tokens and hits.  Then the attention kernels at up to 2 of the run's
    inputs of each shape (d = 48, 64, 72) against their plain versions
    (2e-5), timed.
17. Open-loop serving at the ``SCALE_128`` preset: ``EventSimulator`` over
    128 analytic agents, the ``cuda`` solver at 8 hubs with warm starts and
    spill, Poisson arrivals at 96 dialogues/s of a streamed coqa_like
    workload, ``max_inflight`` 256, batches of <= 64 every 0.05 virtual s,
    a ``RoutingProfiler``.  The CUDA and the CPU routers each run the first
    100 dialogues: equal metrics (every key but the wall-clock ones, left
    out by name), accounts and settlement head, and ``lcp_gather`` once
    per batch.  Then the CUDA router alone over 500 of the preset's
    10,000 dialogues, printing requests dispatched and completed, KV hit
    rate, latency p50 / p95, mean cost, route_batch p50 / p90 (host
    clock), requests/s, the profiler's report and the router kernels'
    launches.
18. The hubs-of-hubs federation (``repro_torch.serving.federation``), every
    super-hub shard's router on the card.  (a) The reference's overloaded
    federation: 12 agents in 3 super-hubs, 40 coqa_like dialogues (the
    reference test's 150, cut) forced into one domain, Poisson 300/s, ``max_inflight`` 900, faults
    (``fail_prob`` 0.1), epoch 0.25, spill after 0.2 s, solver ``cuda``
    with warm starts and ledgers, inline on the card and on the CPU: equal
    reports (wall clock aside), accounts and every shard's ledger head;
    dialogues migrate (in == out > 0) and settle exactly once.  (b) The
    ``SCALE_1K`` fleet (1024 agents, 8 super-hubs recut into inner hubs
    of 16 agents, Poisson 768 dialogues/s, ``max_inflight`` 2048 over the
    shards, batches of <= 64 every 0.05 s, epoch 0.5) over 60 coqa_like
    dialogues: CUDA inline = CPU inline, and CUDA process shards (one
    spawned process and CUDA context each) = CUDA inline; on the inline
    run ``lcp_gather`` once per route_batch call over all shards,
    ``auction_solve`` once per solve, ``auction_bid``, ``lcp_affinity``,
    ``fused_phase1`` and ``auction_fused`` never, and nothing in the
    federation's own spill rounds; route_batch p50 / p90 inline and in
    processes, the device-busy share of an inline run (a profiler lower
    bound), and both router kernels against their plain versions at up
    to 2 of the run's calls per shape.  (c) The scale run: ``SCALE_1K``
    with 8 process shards on the card over 500 dialogues (the
    preset's 100,000, cut), under the reference scale benchmark's gates
    (exactly-once, 8 ledgers, nothing lost, migrations balanced,
    completed + unfinished = dialogues, not truncated, consumed
    staleness <= 1 epoch, overhead in (0, 0.5)); prints the wall seconds,
    requests/s, KV hit rate, latency, cost, epochs, spill, staleness,
    overhead, each phase's share and each shard's ``n``.
19. The attention kernels against their plain versions and SDPA, bf16,
    at the head layouts the reference's larger configs add: qwen2.5-32b
    (40 / 8), deepseek-coder-33b (56 / 8) and qwen2-72b (64 / 8), heads of
    128, at prompts of 128 and 512 and decode at M = 1024 under a random
    mask; mixtral-8x22b (48 / 8, window 4096) flash over 6,144 tokens and
    decode over M = 4096 with every slot valid (a full window).  At these
    shapes an output row averages hundreds to thousands of keys and is
    small (about 0.03), so besides the 3e-2 absolute gate each kernel's
    output rows are held to 2e-2 of the row's largest plain output (about
    2.5 bf16 ulps; a dropped 128-key split or a window off by one moves
    some row by 0.3 or more of its largest output).
20. Engine lockstep, CUDA vs CPU, float32 (TF32 off), full width, 2
    layers: deepseek-v2-lite-16b (its dense layer and one MoE + MLA
    layer), mixtral-8x22b (two MoE layers, its window cut to 16 so the
    40- to 52-token dialogue wraps the ring and the window masks) and
    qwen2.5-32b (QKV biases drawn nonzero).  Fresh, exact extension, a partial prefix hit
    (truncate, extend, decode: the path of the reference's MLA
    stale-latent fault, reproduced on both devices) and the no-op repeat:
    identical tokens, hits and modes, logits within 2e-3 of their max;
    every MoE routing call's top-k experts compared, a flip printed with
    its margin.
21. The new families at full width, bf16, random weights, batch 1,
    serving phase 8's plan through ``AgentEngine`` (phase 8's figures and
    gates): deepseek-v2-lite-16b whole (27 layers; MLA launches no
    attention kernel, and the gate is 0), mixtral-8x22b at 8 of its 56
    layers, qwen2.5-32b whole (64 layers).  Each decode step's weight-read
    bound (every expert's bucket is computed, as in the reference's
    layout, against the active weights), and the attention kernels
    against their plain versions and SDPA at the calls mixtral and
    qwen2.5 made.
22. The encoder-decoder and the patch-input model, CUDA vs CPU, float32
    (TF32 off), the same weights: seamless-m4t-medium whole (12 encoder +
    12 decoder layers) and llava-next-34b at full width and 2 layers.
    Model level: a prefill with seeded frames (0.1·N(0, 1), [1, 1024,
    1024]) or 2,880 seeded patches ahead of 128 tokens, 4 greedy decode
    steps and, for llava, an extend; then one engine dialogue on the
    engine's own inputs (zero frames; text alone): fresh, the no-op
    repeat, a truncation-only hit and, for llava, an exact extension, which
    for seamless raises `NotImplementedError` on both devices (the
    reference's engine has no fallback).  Identical greedy tokens, hits
    and modes, logits within 2e-3 of their max, exact launches; both
    attention kernels against their plain versions (2e-5) at one
    model-level call of each shape and mode.
23. Both models whole at full width, bf16, random weights, batch 1:
    seamless through `AgentEngine` (a warm-up per prefill bucket; fresh
    turns, identical repeats, truncation-only hits) and llava through
    phase 8's plan on text alone; then each at model level with seeded
    frames (a 512-token prompt) or 2,880 patches + 128 tokens, 32 decode
    steps and, for llava, one extend.  Exact launches: seamless 36
    ``flash_attention`` per fresh prefill (12 encoder non-causal, 12
    decoder causal, 12 cross non-causal with Sq != Sk) and 24
    ``decode_attention`` per step (12 self, 12 cross over 1,024 valid
    frames), llava 60 and 60.  TTFT, decode ms a token, the busy share,
    peak memory and the decode step's weight-read bound; both kernels at
    the model-level calls (each shape and mode apart) against their plain
    versions, SDPA and their bounds, each bf16 row within 2e-2 of its
    largest plain output.
23b. Both scans' backward kernels (``wkv6_bwd``, ``ssd_bwd``) against
    their plain versions (autograd through the plain forwards) at the
    same head layouts, batch 2, float32 and bf16, at S = 61 (every state
    kept), 512 and 4,096 (the training shape; 2 and 16 segments of 16
    chunks) without s0 and dsT and with both, and at S = 512 under the
    strong decays; where the forward keeps every 16th state (the
    reference's checkpoints: the whole-state run's states at every 16th
    chunk, the output the same bits), the backward from them (one C call:
    each segment's state-only recompute beside its reverse pass, under the
    later segment's chunk pass, on their own streams) equal to the
    backward from every state bit for bit, on the current stream and on
    another, the saved state bytes and each backward's scratch printed for
    both, with each pass's device time and the share of the recompute's
    kernel time inside a chunk or reverse pass (profiler): each gradient within
    1e-4 (float32) / 3e-2 (bf16) of its largest plain magnitude, each
    row (a token and head of dr / dk / dv / dlog_w / dx, a token of dB /
    dC) within 2e-2 of its own largest plain value, counted as at least
    1e-3 of the gradient's largest; a second call the same bits; the
    forward the same bits with and without its saved states; each timed
    beside its plain version (CUDA events), with its bound; at 4,096
    tokens each pass's device time (profiler), float32 beside bf16, and
    the bf16 call no slower than the float32 one.
24. Training lockstep, CUDA vs CPU, float32 (TF32 off), the same init
    weights drawn on the CPU and copied: qwen3-8b (2 layers, 32 / 8 heads
    of 128, d_model 1024, vocab 8,192), mixtral-8x22b (2 layers, 48 / 8
    heads of 128, 8 experts of 2,048, window 16 so the backward's window
    mask bites), seamless-m4t-medium (2 + 2 layers at full width,
    src_len 256, seeded frames), rwkv6-3b (2 layers, 16 scan heads of 64)
    and zamba2-7b (3 layers, ``attn_every=2``: two Mamba-2 layers and the
    shared block of 32 heads of 112, then a tail layer; 32 scan heads of
    64, state 64), d_model 1024, vocab 8,192, batches of 2 x 512 tokens.
    Step 0's loss within 1e-5 relative and every gradient leaf within
    1e-4 of its largest CPU magnitude (rwkv6-3b's, ill-conditioned at
    these weights, within ILL_GRAD_TOL = 3e-4 of the CPU's and of a
    float64 CPU gradient computed each run),
    with 2 forward and 1 backward launch of each kernel per call (flash
    attention, WKV6, SSD; remat); then 4 ``make_train_step`` steps
    (plain, ``accum_steps=2``, int8 compression, plain; mixtral the first
    two) with losses within 1e-4 relative.  Then the
    training CLI (``python -m repro_torch.launch.train --arch ARCH
    --smoke --steps 20``, called in process, for qwen3-8b with
    ``--ckpt-dir``, rwkv6-3b and zamba2-7b) with its printed lines and
    exact launches; ``train_loop`` crashed after step 15 and resumed from
    its step-10 checkpoint against an uninterrupted run (the losses and
    parameters bit for bit, else the difference printed and held to
    2e-3); and decode attention raising under grad on the card (training
    never calls it; it has no backward kernel).
25. Training at full width, bf16, random weights, through ``train_loop``:
    qwen3-8b at 16 of its 36 layers (``TRAIN_LAYERS``, the deepest cut whose
    peak memory, with the float32 master weights and moments, stays under
    72 GiB of the card's 80 GB), train_4k's 4,096
    tokens, batch 1; seamless-m4t-medium whole, 512 decoder tokens, 1,024
    seeded frames, batch 2; rwkv6-3b whole (32 layers) and zamba2-7b at
    full width and 48 of its 81 layers (``ZAMBA_TRAIN_LAYERS``, the
    deepest multiple of its group of 6 under 72 GiB), 4,096 tokens, batch
    1; 6 steps each.  Finite losses that fall by more than the batches
    alone move them; exactly 2 forward and 1 backward launch of each
    kernel per call and step; step ms, tokens/s, peak memory, MODEL_FLOPS
    against the bf16 peak and the busy share of one more step under the
    profiler.  Then each backward kernel at every recorded call shape and
    mode against its plain version (float32 within 1e-4, bf16 within 3e-2
    of each output's largest plain magnitude, each row within 2e-2 of its
    own), timed beside the plain version (and SDPA's backward for flash
    attention), with its bound.
26. Training under the sharding policy: ``remesh`` over the visible
    cards (a one-rank process group over an in-process HashStore, so no
    TCP); qwen3-8b at full width and 4 layers (``POLICY_LAYERS``), 4,096
    tokens, batch 1, bf16, 3 steps through ``train_loop`` under
    ``ShardingPolicy(mesh, TRAIN_RULES, TRAIN_PARAM_RULES)`` against the
    same run with no policy: losses and parameters bit for bit, the flash
    kernels' exact launches in both, the plain attention patched to raise
    in the policy run.  Then the port's dry run (``launch/dryrun.py``, on
    the host under fake tensors) of phase 25's qwen3-8b cell and of this
    run's cell: per-card bytes within 2x of each run's measured peak,
    FLOPs beside MODEL_FLOPS, the roofline's three terms and fraction
    beside the measured step, which must be no shorter than the memory
    term (the step's bytes per fused region, `launch/traffic.py`, at the
    card's memory rate: a bound, held in each dry run of 26c–30c); their
    figures as a JSON line (``dry_run``).
27. Each sequence split over a ``model`` axis of 2, the reference
    launcher's mesh for two devices.  (a) The flash forward and backward
    kernels on a block of query rows at an offset (``q_offset``) against
    their plain versions at qwen3-8b's heads, 2,048 query rows against
    4,096 keys, offsets 0, 2,048 and 1,000 (off both kernels' tiles),
    float32 and bf16, under phase 6's and phase 25's gates, timed beside
    the plain version and SDPA with the mask, with their bounds; an offset
    of 0 the same bits as the call without one.  (b) ``launch/train.py``
    in two processes as ``torchrun`` starts it, at (1, 2) (gloo on this
    card's CUDA tensors where the ranks share one card, NCCL with a card
    each), against one process: phase 24's reduced float32 qwen3-8b, 3
    steps, losses within 1e-5 relative, the ranks' first-step gradients
    gathered within 1e-4 of each leaf's largest one-process value.  (c) The
    same at full width, 2 layers, 4,096 tokens, bf16, 2 steps (phase 26's
    cell cut to 2 layers for the script's time): losses within 2e-2
    relative, each rank's flash launches exact (2 forward and 1
    backward per layer and step, at 2,048 rows against
    4,096 keys and the rank's offset) with the plain versions refused,
    per-rank peak memory and step time, and the dry run's bytes a rank
    against the measured peak within 2x; the figures as a JSON line
    (``split``).  Each of 27c–30c also prints a rank's peak and step
    beside the step that gathered every parameter whole at the same depth
    (``WHOLE_STEP``) and the layers' leaf gathers a step (each rank's
    parameters stay its shards: each checkpointed layer gathers its
    leaves in its forward and again in its re-run, the table and the
    head stay vocab-sharded); the (b) gates read each rank's first-step
    gradients gathered whole from its reduced shards.
28. rwkv6-3b and zamba2-7b with each sequence split the same way, the
    token shifts, the conv rows and the scan states passed from rank to
    rank.  (a) The scan kernels at a rank's calls (40 heads of 64; 112
    of 64 with a state of 64; 2,048 tokens; float32 and bf16): the
    forward from a stored state under phase 10's gates, the backward
    with both the final state's and the incoming state's gradients under
    phase 23b's, from the checkpoints (8 segments, as training runs it)
    bit for bit against from every state, on the current stream and on
    another, with its passes' device ms, their overlap and its scratch;
    the flash kernels at zamba2-7b's shared block (32 / 32
    heads of 112, offsets 0 and 2,048) under phase 27a's.  (b) Both
    models at phase 24's reduced float32 widths, two ranks against one
    process under phase 27b's gates, each scan launched twice a layer
    and pass.  (c) Both at full width in bf16, 4,096 tokens, 2 steps,
    rwkv6-3b at 4 layers and zamba2-7b at 6 (cut for the script's time
    from 32 and 30, the deepest at which two ranks fit the card): losses
    within 2e-2 of one process, the launches exact with every plain
    version refused, per-rank peak memory and
    step time, the collectives, and the dry run a rank within 2x of the
    measured peak (its dry runs start with the script, in a process of
    their own); the figures as a JSON line (``split_recurrent``).  Each
    (c) run's processes start with its phase's (b), import and warm up
    (one narrow training step each) beside it, and train in turn.
29. mixtral-8x22b and deepseek-v2-lite-16b with each sequence split over
    a model axis of 2, each rank keeping its half of the experts (the
    rows gathered to them, the outputs reduce-scattered back) and MLA's
    latent gathered.  (a) The flash forward and
    backward kernels where mixtral's window masks at an offset (48 / 8
    heads of 128, bf16, 4,096 query rows at offset 4,096 against 8,192
    keys, window 4,096) under phase 27a's gates.  (b) Both at reduced
    float32 widths (phase 24's mixtral; deepseek at 2 layers, d_model
    1,024), two ranks against one process under phase 27b's gates, the
    launches exact (none for MLA), the top-k flips against one process,
    each rank's dropped pairs (their sum one process's but for the pairs
    flips move), no expert leaf gathered over model, each rank's leaf and
    row GiB a step.  (c) Both at full width in bf16, 4,096 tokens, 2 steps,
    mixtral-8x22b at 1 of 56 layers and deepseek-v2-lite-16b at 7 of 27
    (the deepest at which two ranks' measured peaks stay under 72 GiB,
    one layer more checked over it): (b)'s gates at 2e-2, per-rank peak
    memory against the dry run and step time against one process, the
    collectives a step; the figures as a JSON line (``split_moe``).
30. llava-next-34b with its 2,880 patches and its tokens split together
    over a model axis of 2 (a rank's block may hold patches only) and
    seamless-m4t-medium with its encoder's frames split beside its
    decoder's tokens (each encoder layer's K/V and each decoder layer's
    cross K/V gathered).  (a) The flash forward and backward kernels at a
    rank's new calls, bf16, under phase 27a's gates: llava's 56 / 8 heads
    of 128, 2,048 rows at offsets 0 and 2,048 against 4,096 keys;
    seamless's 16 / 16 heads of 64, batch 2: its encoder's 512 frame
    rows and its cross-attention's 256 rows against 1,024 frames,
    non-causal, and its self-attention's 256 rows at offsets 0 and 256
    against 512 keys.  (b) Both at reduced float32 widths (llava at 2
    layers, d_model 1,024, 320 patches and 192 tokens, so rank 0's block
    is all patches; phase 24's seamless), two ranks against one process
    under phase 27b's gates, the launches and call shapes exact.  (c)
    Both at full width in bf16 through ``train_loop`` with the patches or
    frames of ``FramedData``, 2 steps: llava at 6 of 60 layers over 4,096
    positions (the deepest at which two ranks' measured peaks stay under
    72 GiB, one layer more checked over it), seamless whole at phase 25's
    cell: (b)'s gates at 2e-2, per-rank peak memory against the dry run
    and step time against one process, the collectives a step; the
    figures as a JSON line (``split_encdec_vlm``).
    Then the time of all phases, the card line, the JSON line of the
    thirteen kernels' records (the six TPU kernels' counterparts, the
    router's two redesigned entries, the fused step's two kernels and the
    three backward kernels: flash attention's, WKV6's and SSD's;
    ``serving_launches`` gives each one's launches in phase 16's two runs,
    phase 17's scale run and 18b's CUDA inline federation,
    ``family_launches`` in phase 21's engines, ``encdec_vlm_launches`` in
    phase 22 and in phase 23's runs, ``training_launches`` in phase 24's
    locksteps, phase 25's runs, phase 26's policy run and rank 0 of phases
    27c, 28c, 29c and 30c, ``family_replays`` and
    ``encdec_vlm_replays`` the attention kernels' figures at phase 21's
    and phases 22–23's model-level calls, ``training_replays`` each
    backward kernel's at phase 25's calls (the scans' from the
    checkpoints: rows 5c / 6c), ``checkpointed`` the scan backwards' at
    phase 23b's 4,096-token calls with the whole-state call's device ms,
    the saved state bytes and the scratch of both, ``split_checkpointed``
    theirs at phase 28a's calls from the checkpoints and from every state
    (rows 5co / 6co, 5bo / 6bo), ``split_window`` the flash kernels' at
    phase 29a's call, ``split_encdec_vlm`` at phase 30a's) and the device
    line last.

Without a CUDA device, or outside the repository, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import atexit
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import time
import zlib
from collections import Counter
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12              # same, float32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # same, bf16 on the tensor cores (dense)
N_AGENTS = 128
MIN_REQUESTS = 300
BIG = 3.4028234663852886e38 / 4    # float32 max / 4, the no-bid price
# the per-kernel figures of the JSON line that phases 5 and 8 measure
MEASURED = ("max_abs_err", "ms", "device_ms", "device_ms_from", "plain_ms",
            "bound_ms", "bound_by")
# the error figures a replay keeps the worst of (those a figure has): max
# abs error, and each output's and each row's over their largest plain value
ERROR_FIGURES = ("max_abs_err", "max_rel_err", "max_row_rel_err")
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # the reference's
# phase 19: each bf16 output row's max abs error over its largest plain
# output, about 2.5 bf16 ulps (2^-7 each) of the row's scale
ATTN_ROW_TOL = 2e-2
ENGINE_LOGIT_TOL = 2e-3            # tests/test_models.py's
ARCH = "qwen3-8b"
RWKV = "rwkv6-3b"
ZAMBA = "zamba2-7b"
MAX_LEN = 1024
SLICE_AGENT = "agent-0"            # phase 8's engine serves as it in phase 9


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, timed
    with CUDA events after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# what each op launches on the device once per call: its hand-written
# kernels (by name stem) and, for auction_bid, the memset of its keys
OP_KERNELS = {"lcp_affinity": ("lcp_kernel",),
              "lcp_gather": ("lcp_gather_kernel",),
              "auction_bid": ("Memset", "bid_rows", "bid_decode"),
              "auction_solve": ("auction_solve_kernel",),
              "fused_phase1": ("Memset", "fused_phase1_kernel"),
              "auction_fused": ("auction_fused_kernel",),
              "flash_attention": ("flash_",),
              # D's row pass, then the dK/dV and dQ kernels of either
              # type (dkdv_tc_kernel / dkdv_kernel, dq_tc_kernel / dq_kernel)
              "flash_attention_bwd": ("delta_kernel", "dkdv_", "dq_"),
              "decode_attention": ("decode_split_kernel",
                                   "decode_combine_kernel"),
              "wkv6": ("wkv6_intra_kernel", "wkv6_state_kernel"),
              "ssd": ("ssd_intra_kernel", "ssd_state_kernel"),
              # the reverse pass, the chunk pass, the fixed-order sums
              "wkv6_bwd": ("wkv6_bwd_reverse_kernel", "wkv6_bwd_intra_kernel",
                           "wkv6_bwd_du_kernel"),
              "ssd_bwd": ("ssd_bwd_reverse_kernel", "ssd_bwd_intra_kernel",
                          "ssd_bwd_sum_kernel", "ssd_bwd_head_kernel")}
# a backward from the checkpoints also runs the state-only instances of
# its forward's two passes, once a segment, to recompute the segment's
# states beside its reverse pass
OP_KERNELS.update({f"{op}_bwd_checkpointed": (
    *OP_KERNELS[f"{op}_bwd"], f"{op}_recompute_intra_kernel",
    f"{op}_recompute_state_kernel") for op in ("wkv6", "ssd")})


PROFILE_TRIES = 3                  # traces of one op before events
TRACE_MARGIN_S = 0.2               # idle time at each end of a step's trace
TRACE_PRIMERS = 64                 # spin kernels that open each trace


def prime_trace() -> None:
    """Open a trace with TRACE_PRIMERS one-cycle spin kernels and wait for
    them.  On an H100 a trace loses its first records (the first kernel
    of each, or a fused step's uploads and first kernels; PERF.md §7):
    these take that loss.  Counters skip them by name (``spin_kernel``)."""
    import torch

    for _ in range(TRACE_PRIMERS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def profiled_kernel_means(fn, op: str) -> tuple[dict[str, float], Counter]:
    """Mean CUDA microseconds of each of ``op``'s kernels (by stem) in one
    ``torch.profiler`` trace of ``fn``, and the number of records of each;
    a kernel the trace lacks is absent.  After long traces the profiler
    drops some kernel records (each recorded time stays right), so the
    caller checks the counts; an empty trace taken first absorbs records
    of earlier work that arrive late."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prime_trace()
        fn()
        torch.cuda.synchronize()
    total, count = Counter(), Counter()
    for e in prof.key_averages():
        stem = next((k for k in OP_KERNELS[op] if k in e.key), None)
        if e.device_type == DeviceType.CUDA and stem and e.count:
            total[stem] += e.device_time_total
            count[stem] += e.count
    return {k: total[k] / count[k] for k in count}, count


# a scan backward's kernels by role: the recompute of a segment's states
# (the state-only passes, or a parent checkout's forward passes) and the
# passes it may run beside (the chunk and reverse passes)
RECOMPUTE_KERNEL = r"(?<!bwd)_(?:intra|state)_kernel"
BWD_PASS_KERNEL = r"_bwd_(?:intra|reverse)_kernel"


def traced_kernels(fn) -> list[tuple[str, float, float]]:
    """(name, start, end) in microseconds of every kernel of one
    ``torch.profiler`` trace of ``fn()`` but the primers, in start
    order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prime_trace()
        fn()
        torch.cuda.synchronize()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "_kernel" in e.name and "spin_kernel" not in e.name),
                  key=lambda k: k[1])


def kernel_totals(kernels) -> dict[str, float]:
    """Device ms of each kernel name stem (``*_kernel``) in ``kernels``
    (`traced_kernels`), summed over its launches."""
    total: Counter = Counter()
    for name, start, end in kernels:
        m = re.search(r"(\w+_kernel)", name)
        total[m.group(1) if m else name] += (end - start) / 1e3
    return dict(total)


def overlap_share(kernels, inner: str, outer: str) -> float:
    """The share of the device time of the kernels whose name matches
    ``inner`` (a regex) that falls inside the union of the intervals of
    those matching ``outer``: how much of one kind of pass ran beside
    another."""
    merged: list[list[float]] = []
    for s, e in sorted((s, e) for n, s, e in kernels if re.search(outer, n)):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total = inside = 0.0
    for name, s, e in kernels:
        if re.search(inner, name):
            total += e - s
            inside += sum(max(0.0, min(e, b) - max(s, a)) for a, b in merged)
    return inside / total if total else float("nan")


def queued_event_ms(calls) -> float:
    """Device milliseconds of all ``calls`` (zero-argument callables),
    timed with CUDA events while the device is held in a spin
    (``torch.cuda._sleep``) long enough for the host to queue each group of
    calls first, so no host time falls between the events.  Groups of 128
    calls stay inside the driver's launch queue.  Counts every kernel a
    call launches, the wrapper's allocations' fills included."""
    import torch

    total = 0.0
    for i in range(0, len(calls), 128):
        group = calls[i:i + 128]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for c in group:
            c()
        host_s = time.perf_counter() - t
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(max(host_s, 1e-3) * 4e9))   # >= 2x at 2 GHz
        start.record()
        for c in group:
            c()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total


def device_ms(calls, op: str, launches=None) -> tuple[float, str]:
    """Device milliseconds per call of ``op`` (a key of OP_KERNELS) over
    ``calls`` (zero-argument callables, each one call of the op): the mean
    CUDA time of each of the op's kernels in a ``torch.profiler`` trace,
    times its launches per call (``launches``, by stem; 1 where absent),
    summed over the kernels one call launches.  A trace counts only if it
    holds every launch of each of the op's kernels for every call traced;
    the profiler sometimes drops records after long traces of other work,
    and a mean over the records it kept is not the mean over the calls.
    After ``PROFILE_TRIES`` short traces the time comes from CUDA events
    with the host run ahead (``queued_event_ms``).  Returns the time and
    its source, "profiler" or "events", which every figure keeps beside
    it."""
    check(bool(calls), f"no {op} call to time")
    per = {k: (launches or {}).get(k, 1) for k in OP_KERNELS[op]}
    count: Counter = Counter()
    for _ in range(PROFILE_TRIES):
        seen, count = profiled_kernel_means(lambda: [c() for c in calls], op)
        if all(count[k] >= per[k] * len(calls) for k in OP_KERNELS[op]):
            return sum(seen[k] * per[k] for k in seen) / 1e3, "profiler"
    print(f"    {op}: {PROFILE_TRIES} profiler traces of {len(calls)} calls "
          f"held fewer records of a kernel (last {dict(count)}); its device "
          "time comes from CUDA events")
    return queued_event_ms(calls) / len(calls), "events"


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program: on the PATH or under /usr/local/cuda/bin."""
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    check(Path(found).exists(), f"{name} not found")
    return found


def ptxas_entries(log: str) -> list[dict]:
    """One entry per kernel instance of an ``nvcc -Xptxas -v`` log: its
    mangled ``name``, ``registers``, static shared memory (``smem``) and
    spill bytes (``spill_stores``, ``spill_loads``)."""
    rows, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            fn, spill = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append({"name": fn, "registers": int(m.group(1)),
                         "smem": int(smem.group(1)) if smem else 0,
                         "spill_stores": spill[0], "spill_loads": spill[1]})
            fn = None
    return rows


def ptxas_report(log: str) -> list[str]:
    """One line per kernel instance of an ``nvcc -Xptxas -v`` log: its
    (demangled) name, registers, static shared memory and spill bytes."""
    rows = ptxas_entries(log)
    names = subprocess.run([cuda_tool("cu++filt")], input="\n".join(
        r["name"] for r in rows), capture_output=True, text=True,
        timeout=60).stdout.splitlines() if rows else []
    return [f"{(names[i] if i < len(names) else r['name'])[:90]}: "
            f"{r['registers']} registers, {r['smem']} B static smem, spills "
            f"{r['spill_stores']}/{r['spill_loads']} B (store/load)"
            for i, r in enumerate(rows)]


def tensor_core_counts(lib: Path, kernel: str) -> dict[str, int]:
    """``HMMA``/``HGMMA`` instructions per function of shared library
    ``lib`` whose (mangled) name holds ``kernel``, from its SASS."""
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = m.group(1) if kernel in m.group(1) else None
            if fn:
                counts[fn] = 0
        elif fn and re.search(r"\bHG?MMA\b", line):
            counts[fn] += 1
    return counts


def bwd_tensor_core_spills(log: str) -> None:
    """Phase 2's checks of the bf16 backward kernels (``dkdv_tc_kernel``
    and ``dq_tc_kernel``, one instance per head dim padded to 16): the
    ``HMMA`` count in each instance's SASS (0 fails: every pair product
    runs on the tensor cores) and its ptxas spill bytes (a spill at DP = 64
    or 128, the training path's head dims, fails)."""
    from repro_torch.kernels import build

    entries = {r["name"]: r for r in ptxas_entries(log)}
    hmma = tensor_core_counts(build.library_path("flash_attention_bwd"),
                              "_tc_kernel")
    shown = []
    for name, count in sorted(hmma.items()):
        m = re.search(r"(dkdv_tc_kernel|dq_tc_kernel)ILi(\d+)E", name)
        r = entries.get(name)
        check(m is not None and r is not None,
              f"no ptxas report for the backward instance {name}")
        spill = r["spill_stores"] + r["spill_loads"]
        shown.append(f"{m.group(1)}<{m.group(2)}> {count} HMMA, "
                     f"{r['registers']} registers, {spill} B spilled")
        check(count > 0, f"{name} has no tensor-core instruction")
        check(spill == 0 or int(m.group(2)) not in (64, 128),
              f"{name} spills {r['spill_stores']}/{r['spill_loads']} B")
    print("    the bf16 flash backward's instances: " + "; ".join(shown))
    check(len(hmma) == 16, f"{len(hmma)} bf16 backward instances, not 16 "
          "(two kernels x eight padded head dims)")


def scan_bwd_tensor_core_spills(reports: dict[str, str]) -> None:
    """Phase 2's checks of the scan backwards' tensor-core passes
    (``*_bwd_reverse_kernel`` and ``*_bwd_intra_kernel`` of ``wkv6_bwd``
    and ``ssd_bwd``, bf16 and float32): the ``HMMA`` count in each
    instance's SASS (0 fails) and its ptxas spill bytes (any spill
    fails); and the ``HMMA`` count of the recompute's state pass in each
    library (``*_recompute_state_kernel``, bf16 and float32: 0 fails), its
    spills shown."""
    from repro_torch.kernels import build

    shown = []
    for name in ("wkv6_bwd", "ssd_bwd"):
        entries = {r["name"]: r for r in ptxas_entries(reports[name])}
        hmma = {n: c for n, c in tensor_core_counts(
            build.library_path(name), f"{name}_").items()
            if "_reverse_kernel" in n or "_intra_kernel" in n}
        for fn, count in sorted(hmma.items()):
            m = re.search(r"((?:ssd|wkv6)_bwd_(?:reverse|intra)_kernel)I"
                          r"(13__nv_bfloat16|f)E", fn)
            r = entries.get(fn)
            check(m is not None and r is not None,
                  f"no ptxas report for the scan backward instance {fn}")
            spill = r["spill_stores"] + r["spill_loads"]
            label = f"{m.group(1)}<{m.group(2).replace('13__nv_', '')}>"
            shown.append(f"{label} {count} HMMA, {r['registers']} registers, "
                         f"{spill} B spilled")
            check(count > 0, f"{label} has no tensor-core instruction")
            check(spill == 0, f"{label} spills {r['spill_stores']}/"
                  f"{r['spill_loads']} B")
        check(len(hmma) == 4, f"{name}: {len(hmma)} tensor-core pass "
              "instances, not 4 (two passes x two types)")
        stem = f"{name.removesuffix('_bwd')}_recompute_state_kernel"
        rec = tensor_core_counts(build.library_path(name), stem)
        for fn, count in sorted(rec.items()):
            r = entries.get(fn)
            check(r is not None, f"no ptxas report for {fn}")
            shown.append(f"{stem}<{'bf16' if 'bfloat16' in fn else 'f'}> "
                         f"{count} HMMA, {r['registers']} registers, "
                         f"{r['spill_stores'] + r['spill_loads']} B spilled")
        check(len(rec) == 2 and min(rec.values()) > 0,
              f"{name}: the recompute's state pass instances {rec} (two "
              "types, each with tensor-core instructions)")
    print("    the scan backwards' tensor-core passes: " + "; ".join(shown))


# ---------------------------------------------------------------- inputs --
def lcp_inputs(n, m, length, seed, dev):
    """Prompts and ledger rows with shared prefixes of seeded lengths,
    absent rows (all padding) and full matches."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    plen = rng.integers(length // 4, length + 1, n)
    prompts = np.full((n, length), -1, np.int32)
    ledgers = np.full((n, m, length), -2, np.int32)
    for j in range(n):
        prompts[j, :plen[j]] = rng.integers(1, 255, plen[j])
        shared = rng.integers(0, plen[j] + 1, m)
        for i in range(m):
            if i % 5 == 0:
                continue
            ledgers[j, i, :shared[i]] = prompts[j, :shared[i]]
            ledgers[j, i, shared[i]:plen[j]] = rng.integers(
                1, 255, plen[j] - shared[i])
        ledgers[j, 1, :plen[j]] = prompts[j, :plen[j]]
    return (torch.from_numpy(prompts).to(dev),
            torch.from_numpy(ledgers).to(dev))


def bid_inputs(n, m, seed, dev):
    """Seeded bidding-round inputs with tied profits and tied bids."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    W = np.maximum(rng.uniform(-1, 4, (n, m)), 0.0).astype(np.float32)
    ask = rng.uniform(0, 3, m).astype(np.float32)
    ask2 = (ask + rng.uniform(0, 2, m)).astype(np.float32)
    ask2 = np.where(rng.random(m) < 0.2, np.float32(BIG), ask2)
    W[:, 1] = W[:, 0] - ask[0] + ask[1]
    W[1::2] = W[::2][: n // 2]
    active = rng.random(n) < 0.8
    tensors = [torch.from_numpy(x).to(dev) for x in (W, ask, ask2, active)]
    return (*tensors, np.float32(rng.uniform(1e-4, 0.5)))


def solve_market(n, m, cmax, seed, *, warm=False, tie=False,
                 cap=200_000):
    """One seeded column market for ``auction_solve`` (host arrays): W
    [n, m], counts [m] (agent 0 at cmax, some agents without units), a
    zero start grid (cold, ε₀ = wmax/5) or seeded unit prices (warm, ε₀ =
    wmax/125), under round cap ``cap``; ``tie`` repeats columns and rows so
    profits, bids and offers tie."""
    import numpy as np

    from repro_torch.core.solvers.dense_common import float32_eps_final

    rng = np.random.default_rng(seed)
    W = np.maximum(rng.uniform(-1, 4, (n, m)), 0.0).astype(np.float32)
    if tie:
        W[:, 1::2] = W[:, 0::2][:, : m // 2]
        W[1::2] = W[0::2][: n // 2]
    counts = rng.integers(0, cmax + 1, m).astype(np.int32)
    counts[0] = cmax
    wmax = float(W[:, counts > 0].max())
    eps_f = float32_eps_final(wmax, np.float32)
    p0 = np.zeros((m, cmax), np.float32)
    eps0 = max(wmax / 5.0, eps_f)
    if warm:
        p0 = (rng.uniform(0, 3, (m, cmax))
              * (np.arange(cmax)[None, :] < counts[:, None])).astype(
                  np.float32)
        eps0 = max(wmax / 125.0, eps_f)
    return W, counts, p0, eps0, eps_f, 5.0, cap


def gather_inputs(n, m, lp, la, rows_in_arena, seed, dev):
    """Prompts [n, lp] against an arena [rows_in_arena, la] whose rows are
    shared by many (request, agent) pairs (recycled), row 0 all padding;
    each prompt starts with one of its rows, so prefixes run long."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    arena = np.full((rows_in_arena, la), -2, np.int32)
    for r in range(1, rows_in_arena):
        k = int(rng.integers(0, la + 1))
        arena[r, :k] = rng.integers(1, 4, k)
    rows = rng.integers(0, rows_in_arena, (n, m)).astype(np.int32)
    rows[:, 0] = 0
    prompts = np.full((n, lp), -1, np.int32)
    for j in range(n):
        k = int(rng.integers(lp // 4, lp + 1))
        prompts[j, :k] = rng.integers(1, 4, k)
        src = arena[rows[j, 1], :min(k, la)]
        prompts[j, :len(src)] = np.where(src >= 0, src, prompts[j, :len(src)])
    return tuple(torch.from_numpy(x).to(dev) for x in (prompts, arena, rows))


def dense_tile(prompts, arena, rows):
    """The dense [n, m, lp] ledger tile of a gather call (what the gather
    reads in place): ``arena[rows]`` cut or padded (-2) to the prompt
    width."""
    import torch

    lp = prompts.shape[1]
    tile = arena[rows.long()][:, :, :lp]
    if tile.shape[2] < lp:
        tile = torch.cat([tile, tile.new_full(
            (*tile.shape[:2], lp - tile.shape[2]), -2)], dim=-1)
    return prompts, tile.contiguous()


# ---------------------------------------------------------------- bounds --
def lcp_work(prompts, ledgers, lcp) -> tuple[int, int]:
    """(bytes, operations) this data needs: each pair's ledger tokens up
    to its first mismatch, each prompt's tokens up to the furthest such
    point over its pairs, the [n, m] int32 output; one comparison per
    ledger token read."""
    length = prompts.shape[1]
    need = (lcp.long() + 1).clamp(max=length)
    nbytes = 4 * (int(need.sum()) + int(need.amax(dim=1).sum())
                  + lcp.numel())
    return nbytes, int(need.sum())


def bid_work(W, ask, ask2, active, eps) -> tuple[int, int]:
    """(bytes, operations) one round needs: the W rows of the active
    requests (an inactive row is never read and changes nothing), all of
    ask, ask2 only at each active row's favourite agent, the active mask,
    and the three outputs; per W element read, one subtraction and two
    comparisons (the top and the runner-up profit)."""
    import torch

    n, m = W.shape
    rows = int(active.sum())
    k1 = (W[active] - ask[None, :]).argmax(dim=1)
    nbytes = (4 * m * rows + 4 * m + 4 * int(torch.unique(k1).numel()) + n
              + 4 * m + 4 * m + n)
    return nbytes, 3 * m * rows


def gather_work(prompts, arena, rows, lcp) -> tuple[int, int]:
    """(bytes, operations) this data needs: each pair's arena tokens up to
    its first mismatch (none past the arena's width), its row index, each
    prompt's tokens up to the furthest such point over its pairs, the
    [n, m] int32 output; one comparison per arena token read."""
    lp, la = prompts.shape[1], arena.shape[1]
    need = (lcp.long() + 1).clamp(max=min(lp, la))
    reach = (lcp.long() + 1).clamp(max=lp).amax(dim=1)
    nbytes = 4 * (int(need.sum()) + int(reach.sum()) + 2 * lcp.numel())
    return nbytes, int(need.sum())


def solve_bytes(meta) -> int:
    """Bytes one ``auction_solve`` call must move: every market's W,
    counts, start grid and ε values read once, its unit-price grid,
    agent_of, unit_of and rounds written once."""
    n, m, cmax = (meta[:, k].astype(int) for k in range(3))
    return int((4 * n * m + 4 * m + 4 * m * cmax + 12).sum()
               + (4 * m * cmax + 8 * n + 4).sum())


def roofline(nbytes: int, ops: int,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The least time in ms for this work, and what bounds it: bytes over
    the HBM rate or operations over the peak rate of their type."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def exact_diff(a, b) -> float:
    """0.0 when the tensors are bit-identical, else the max abs error."""
    import torch

    if a.dtype == torch.float32:
        if torch.equal(a.view(torch.int32), b.view(torch.int32)):
            return 0.0
    elif torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max())


# ----------------------------------------------------------------- phases --
def phase_kernels(dev) -> dict:
    """Kernel vs plain version on synthetic inputs at the main path's
    shapes, with ties and corner cases."""
    from repro_torch.kernels.auction_bid import (auction_bid_cuda,
                                                 auction_bid_plain)
    from repro_torch.kernels.lcp_affinity import (lcp_affinity_cuda,
                                                  lcp_affinity_plain)

    for length in (1024, 1000):
        p, led = lcp_inputs(64, N_AGENTS, length, length, dev)
        got = lcp_affinity_cuda(p, led)
        err = exact_diff(got, lcp_affinity_plain(p, led))
        check(err == 0.0, f"lcp kernel != plain at L={length}")
        ms = cuda_time_ms(lambda: lcp_affinity_cuda(p, led))
        plain_ms = cuda_time_ms(lambda: lcp_affinity_plain(p, led), 20, 3)
        bound, by = roofline(*lcp_work(p, led, got))
        print(f"lcp_affinity [64,{length}]x[64,{N_AGENTS},{length}]: "
              f"bit-exact, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.7f} ms ({by})")
    from repro_torch.kernels.lcp_affinity import (lcp_gather_cuda,
                                                  lcp_gather_plain)

    # prompts [64, 1024] against 128 agents' rows of a 300-row arena
    # (rows recycled across pairs), at a width that is not a multiple of
    # 32, and with prompts wider than the arena
    for lp, la in ((1024, 1024), (1000, 1024), (1100, 1024)):
        args = gather_inputs(64, N_AGENTS, lp, la, 300, lp + la, dev)
        got = lcp_gather_cuda(*args)
        err = exact_diff(got, lcp_gather_plain(*args))
        check(err == 0.0, f"lcp_gather kernel != plain at lp={lp}, la={la}")
        ms = cuda_time_ms(lambda: lcp_gather_cuda(*args))
        plain_ms = cuda_time_ms(lambda: lcp_gather_plain(*args), 20, 3)
        bound, by = roofline(*gather_work(*args, got))
        print(f"lcp_gather [64,{lp}] x arena [300,{la}] rows [64,{N_AGENTS}]"
              f": bit-exact (longest prefix {int(got.max())}), kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.7f} ms "
              f"({by}), {4 * lp} B dynamic smem")
    for n, m in ((64, N_AGENTS), (1024, N_AGENTS), (64, 16)):
        args = bid_inputs(n, m, n + m, dev)
        got = auction_bid_cuda(*args)
        want = auction_bid_plain(*args)
        err = max(exact_diff(g, w) for g, w in zip(got, want))
        check(err == 0.0, f"auction_bid kernel != plain at ({n}, {m})")
        ms = cuda_time_ms(lambda: auction_bid_cuda(*args))
        plain_ms = cuda_time_ms(lambda: auction_bid_plain(*args))
        bound, by = roofline(*bid_work(*args))
        print(f"auction_bid ({n}, {m}) synthetic: bit-exact, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.7f} ms "
              f"({by})")


def solve_case(label, markets, dev) -> list[int]:
    """``auction_solve`` on ``markets`` (host tuples, one launch) against
    its plain version on the host, bit for bit (unit prices, agent_of,
    unit_of and rounds); returns the rounds per market."""
    import numpy as np
    import torch

    from repro_torch.kernels.auction_bid import (auction_solve_cuda,
                                                 auction_solve_plain,
                                                 auction_solve_plan,
                                                 pack_markets,
                                                 unpack_solution)

    fbuf, ibuf, meta = pack_markets(markets)
    fdev = torch.from_numpy(fbuf).to(dev)
    idev = torch.from_numpy(ibuf).to(dev)
    got = auction_solve_cuda(fdev, idev, meta).cpu()
    t = time.perf_counter()
    want = auction_solve_plain(torch.from_numpy(fbuf),
                               torch.from_numpy(ibuf), meta)
    plain_ms = (time.perf_counter() - t) * 1e3
    check(torch.equal(got, want), f"auction_solve kernel != plain ({label})")
    rounds = [r[3] for r in unpack_solution(want.numpy(), meta)]
    ms = cuda_time_ms(lambda: auction_solve_cuda(fdev, idev, meta), 20, 3)
    shared_w, smem = auction_solve_plan(meta)
    print(f"auction_solve {label}: bit-exact (prices, assignment, rounds "
          f"{rounds}), kernel {ms:.4f} ms ({ms / max(1, max(rounds)) * 1e3:.2f}"
          f" us per round of the longest market), plain (host) "
          f"{plain_ms:.1f} ms; W in {'shared' if shared_w else 'global'} "
          f"memory, {smem} B dynamic smem per block, "
          f"{len(markets)} block(s)")
    return rounds


def phase_solve_kernels(dev) -> None:
    """The staged-solve kernel against the host-driven staged market on
    synthetic markets at the router's shapes: one hub (64 requests, 128
    agents, 12 units), cold and warm; SCALE_128's 8 hub markets of uneven
    size in one launch; a warm market whose budget trips; tied weights; a
    market whose W does not fit in shared memory."""
    solve_case("(64, 128, cmax 12) cold", [solve_market(64, N_AGENTS, 12, 0)],
               dev)
    solve_case("(64, 128, cmax 12) warm",
               [solve_market(64, N_AGENTS, 12, 1, warm=True)], dev)
    hubs = [(8, 16, 8), (3, 16, 3), (12, 16, 12), (1, 16, 1), (20, 16, 12),
            (9, 15, 5), (16, 17, 12), (5, 16, 2)]
    solve_case("8 uneven hubs", [solve_market(n, m, c, 10 + h)
                                 for h, (n, m, c) in enumerate(hubs)], dev)
    rounds = solve_case("warm, budget 20",
                        [solve_market(64, N_AGENTS, 12, 2, warm=True,
                                      cap=20)], dev)
    check(rounds == [20], f"the warm market did not trip its budget: {rounds}")
    solve_case("tied weights", [solve_market(64, N_AGENTS, 12, 3, tie=True)],
               dev)
    solve_case("(200, 400, cmax 12), W past shared memory",
               [solve_market(200, 400, 12, 4)], dev)


class ClosedLoop:
    """Seeded coqa_like + quac_like dialogues in FIFO micro-batches; every
    matched request is served on its agent's analytic engine and both
    routers receive the same completion."""

    def __init__(self, profiles, batch_cap: int, max_new: int, seed: int):
        import numpy as np

        from repro_torch.serving.analytic import AnalyticEngine
        from repro_torch.serving.workload import WorkloadSpec, generate

        scripts = generate(WorkloadSpec("coqa_like", 48, seed=seed)) + \
            generate(WorkloadSpec("quac_like", 48, seed=seed))
        self.scripts = {s.dialogue_id: s for s in scripts}
        self.turn = {d: 0 for d in self.scripts}
        self.history = {d: np.zeros(0, np.int32) for d in self.scripts}
        self.ready = list(self.scripts)
        self.engines = {p.agent_id: AnalyticEngine(
            p.model_class, seed=i, speed=p.speed, cache_slots=p.cache_slots,
            max_new_tokens=max_new) for i, p in enumerate(profiles)}
        self.profile = {p.agent_id: p for p in profiles}
        self.batch_cap = batch_cap
        self.max_new = max_new
        self.rid = 0
        self.now = 0.0

    def next_batch(self):
        from repro_torch.core.mechanism import Request

        import numpy as np

        reqs = []
        for did in self.ready[: self.batch_cap]:
            s = self.scripts[did]
            toks = np.concatenate([self.history[did],
                                   s.turns[self.turn[did]]]).astype(np.int32)
            reqs.append(Request(f"r{self.rid}", did, toks, self.turn[did],
                                s.domain, self.max_new,
                                {"difficulty": s.difficulty}))
            self.rid += 1
        self.ready = self.ready[self.batch_cap:]
        return reqs

    def complete(self, decisions, routers) -> None:
        """Serve every matched request and feed both routers."""
        import numpy as np

        from repro_torch.core.mechanism import CompletionObs

        back = []
        self.now += 0.5
        for d in decisions:
            req = d.request
            if d.agent_id is None:
                back.append(req.dialogue_id)
                continue
            res = self.engines[d.agent_id].serve(req.dialogue_id, req.tokens,
                                                 now=self.now)
            prof = self.profile[d.agent_id]
            quality = min(1.0, max(0.0, 0.25 + 0.05 * prof.scale
                                   + 0.15 * (req.domain in prof.domains)
                                   - 0.3 * float(req.meta["difficulty"])))
            obs = CompletionObs(res.ttft, res.n_prompt, res.n_hit, res.n_gen,
                                quality)
            for r in routers:
                r.on_complete(req.request_id, obs)
            self.history[req.dialogue_id] = np.concatenate(
                [req.tokens, res.output_tokens])
            self.turn[req.dialogue_id] += 1
            if self.turn[req.dialogue_id] < len(
                    self.scripts[req.dialogue_id].turns):
                self.ready.append(req.dialogue_id)
        self.ready = back + self.ready


MODE_KEYS = ("causal", "window", "q_offset")   # an attention call's mode


def shape_key(args, kw=None) -> tuple:
    """The shapes of a call's tensor arguments, then its attention mode
    (``causal``, ``window``) where the call names it: calls of one shape in
    two modes (an encoder's 1024 x 1024 non-causal flash, a decoder's
    causal one at a 1024 bucket) are counted, sampled and checked apart."""
    import torch

    shapes = tuple(tuple(a.shape) for a in args
                   if isinstance(a, torch.Tensor))
    return shapes + tuple((k, kw[k]) for k in MODE_KEYS if kw and k in kw)


def shown_key(key) -> tuple:
    """A key as printed: the first two shapes and the mode."""
    return key[:2] + tuple(m for m in key[2:]
                           if m and isinstance(m[0], str))


class Recorder:
    """Stands in for an op of `repro_torch.kernels.ops` during a main
    path's run.  It passes every call on to the op unchanged and keeps the
    inputs (args, kwargs) of calls made on the card, so that a later phase
    can check and time the kernel at the main path's own inputs: all of
    them, or the first ``per_shape`` of each shape signature, counting
    every call per shape (``count``) so that a sample can be weighted by
    how often the main path made it.  Nothing writes an op's inputs after
    the call (the router makes fresh tensors per call; the model's caches
    are functional), so references are enough, except for the router's
    ledger arena, which the router updates in place between batches: with
    ``copy`` the tensors are cloned.  The op's launch count is untouched by
    this."""

    def __init__(self, op, per_shape: int | None = None,
                 copy: bool = False):
        self.op = op
        self.per_shape = per_shape
        self.copy = copy
        self.calls = []
        self.count = Counter()

    def __call__(self, *args, **kwargs):
        if args[0].is_cuda:
            key = shape_key(args, kwargs)
            self.count[key] += 1
            if self.per_shape is None or self.count[key] <= self.per_shape:
                kept = args
                if self.copy:      # an input the caller updates later
                    kept = tuple(a.clone() if hasattr(a, "clone") else a
                                 for a in args)
                self.calls.append((kept, kwargs))
        return self.op(*args, **kwargs)


@contextmanager
def recording(ops, names, per_shape: int | None = None, copy: bool = False):
    """Replace each named op of module ``ops`` by a Recorder, and put the
    op back afterwards."""
    ops_before = {name: getattr(ops, f"{name}_op") for name in names}
    recorders = {name: Recorder(op, per_shape, copy)
                 for name, op in ops_before.items()}
    for name, rec in recorders.items():
        setattr(ops, f"{name}_op", rec)
    try:
        yield recorders
    finally:
        for name, op in ops_before.items():
            setattr(ops, f"{name}_op", op)


class PhaseClock:
    """Host wall-clock per router phase, through the router's duck-typed
    ``profiler.phase(name)`` hook (the CUDA router's phases end with their
    results on the host, so the host clock covers their device work)."""

    def __init__(self):
        self.ms: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.ms[name] = self.ms.get(name, 0.0) + \
                (time.perf_counter() - t) * 1e3


def same_decisions(a_list, b_list) -> bool:
    if len(a_list) != len(b_list):
        return False
    for a, b in zip(a_list, b_list):
        if (a.request.request_id, a.agent_id, a.hub_id, a.payment,
                a.welfare_weight) != (b.request.request_id, b.agent_id,
                                      b.hub_id, b.payment, b.welfare_weight):
            return False
        if (a.estimate is None) != (b.estimate is None):
            return False
        if a.estimate is not None and (
                a.estimate.latency, a.estimate.cost, a.estimate.quality) != (
                b.estimate.latency, b.estimate.cost, b.estimate.quality):
            return False
    return True


class SolveTally:
    """While active, counts the routers' Phase-2 solves: calls of the
    ``cuda`` backend's ``solve_batch`` and ``solve`` on the card and the
    cold re-solves of its tripped warm attempts (each may launch
    ``auction_solve`` once), and keeps the round counts of every
    ``auction_solve`` call, per device, as the solves return them.  It also
    keeps the host seconds spent in ``solve_markets`` (packing, the call,
    the copy back) and in the Clarke payments, so a phase's time can be
    split between them."""

    def __enter__(self):
        import torch

        from repro_torch.core.solvers import dense_common, dense_torch
        from repro_torch.core.solvers.cuda_backend import CudaBackend

        self.batch_calls = self.single_calls = self.resolves = 0
        self.rounds = []        # (device type, [rounds per market]) per call
        self.solve_s = self.pay_s = 0.0
        self._saved = (dense_torch.solve_markets, CudaBackend.solve,
                       CudaBackend.solve_batch,
                       dense_common.dense_clarke_payments)
        solve_markets, solve, solve_batch, payments = self._saved

        def markets(mk, device):
            t = time.perf_counter()
            out = solve_markets(mk, device)
            self.solve_s += time.perf_counter() - t
            self.rounds.append((torch.device(device).type,
                                [r[3] for r in out]))
            return out

        def pay(*args):
            t = time.perf_counter()
            out = payments(*args)
            self.pay_s += time.perf_counter() - t
            return out

        def one(backend, *args, device="cuda", **kw):
            res = solve(backend, *args, device=device, **kw)
            if torch.device(device).type == "cuda":
                self.single_calls += 1
                self.resolves += bool(res.solver_stats["warm_fallback"])
            return res

        def batch(backend, *args, device="cuda", **kw):
            if torch.device(device).type == "cuda":
                self.batch_calls += 1
            return solve_batch(backend, *args, device=device, **kw)

        dense_torch.solve_markets = markets
        CudaBackend.solve, CudaBackend.solve_batch = one, batch
        dense_common.dense_clarke_payments = pay
        return self

    def __exit__(self, *exc):
        from repro_torch.core.solvers import dense_common, dense_torch
        from repro_torch.core.solvers.cuda_backend import CudaBackend

        (dense_torch.solve_markets, CudaBackend.solve,
         CudaBackend.solve_batch,
         dense_common.dense_clarke_payments) = self._saved


def phase_router(dev, n_hubs: int, cpu="cpu") -> dict:
    """CUDA router vs CPU router in lockstep over the closed loop on the
    SCALE_128 fleet cut into ``n_hubs`` hubs (spill on); returns the run's
    figures and the inputs of every kernel call it made."""
    import torch

    from repro_torch.configs.iemas_cluster import (SCALE_128, agent_infos,
                                                   agent_profiles,
                                                   make_router)
    from repro_torch.kernels import ops

    profiles = agent_profiles(SCALE_128.n_agents)
    infos = agent_infos(profiles)
    cfg = dataclasses.replace(SCALE_128.router_config(), n_hubs=n_hubs,
                              audit_ledger=True)
    gpu = make_router(infos, cfg, device=dev)
    ref = make_router(infos, cfg, device=cpu)
    check(len(gpu.hubs) == n_hubs, f"{len(gpu.hubs)} hubs, not {n_hubs}")
    gpu.profiler = PhaseClock()
    loop = ClosedLoop(profiles, SCALE_128.batch_cap,
                      SCALE_128.max_new_tokens, seed=0)
    lat, ref_lat, routed, solve_s, pay_s = [], [], 0, 0.0, 0.0
    with recording(ops, ("auction_solve", "lcp_gather"), copy=True) as rec, \
            SolveTally() as tally:
        ops.reset_launch_counts()          # the main path's run starts here
        while routed < MIN_REQUESTS or len(lat) < 5:
            reqs = loop.next_batch()
            check(bool(reqs), "closed loop ran dry before enough requests")
            before = ops.launch_counts()
            solves_before = len(tally.rounds)
            telemetry = {"router_inflight": len(reqs), "router_rps": 2.0}
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            host0 = (tally.solve_s, tally.pay_s)
            got = gpu.route_batch(reqs, telemetry)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            solve_s += tally.solve_s - host0[0]
            pay_s += tally.pay_s - host0[1]
            after = ops.launch_counts()
            t0 = time.perf_counter()
            want = ref.route_batch(
                [type(r)(r.request_id, r.dialogue_id, r.tokens.copy(),
                         r.turn, r.domain, r.max_new_tokens, dict(r.meta))
                 for r in reqs], telemetry)
            ref_lat.append(time.perf_counter() - t0)
            check(same_decisions(got, want), "CUDA and CPU routers decided "
                  f"differently at batch {len(lat)}")
            solved = tally.rounds[solves_before:]
            check([r for d, r in solved if d == dev.type]
                  == [r for d, r in solved if d == "cpu"],
                  f"bid rounds differ between the kernel and the CPU "
                  f"router's solver at batch {len(lat)}: {solved}")
            if dev.type == "cuda":
                check(after["lcp_gather"] == before["lcp_gather"] + 1,
                      "lcp_gather kernel did not launch once per batch")
            routed += len(reqs)
            loop.complete(got, [gpu, ref])
            check(gpu.accounts == ref.accounts, "accounts diverged")
            check(gpu.settlement.head == ref.settlement.head,
                  "settlement ledger heads diverged")
        counts = ops.launch_counts()       # ... and ends here
    gpu.settlement.audit(gpu.accounts)
    check(gpu.accounts["matched"] > 0, "nothing was matched")
    card_rounds = [r for d, rs in tally.rounds if d == dev.type for r in rs]
    launches = sum(d == dev.type for d, _ in tally.rounds)
    if dev.type == "cuda":
        check(counts["auction_bid"] == 0 and counts["lcp_affinity"] == 0,
              f"a replaced kernel launched on the main path: {counts}")
        check(counts["auction_solve"] == launches > 0,
              f"auction_solve launched {counts['auction_solve']} times for "
              f"{launches} solves on the card")
        check(launches <= tally.batch_calls + tally.single_calls
              + tally.resolves, "auction_solve launched more than once per "
              "solve_batch call, spill or single solve and cold re-solve")
    ms = sorted(x * 1e3 for x in lat)
    return {"counts": counts, "route_ms": ms, "routed": routed,
            "cpu_route_ms": sorted(x * 1e3 for x in ref_lat),
            "phase_ms": {k: v / len(lat)
                         for k, v in gpu.profiler.ms.items()},
            "solve_ms": solve_s * 1e3 / len(lat),
            "payments_ms": pay_s * 1e3 / len(lat),
            "batches": len(lat), "matched": gpu.accounts["matched"],
            "spill_rescued": gpu.accounts["spill_rescued"],
            "solves": {"solve_batch": tally.batch_calls,
                       "solve": tally.single_calls,
                       "cold re-solves": tally.resolves},
            "rounds": card_rounds,
            "ledger_bytes": gpu.ledger.bytes_sent / len(lat),
            "calls": {name: r.calls for name, r in rec.items()},
            "req_per_s": routed / sum(lat), "head": gpu.settlement.head}


def print_router(run) -> None:
    counts, ms, cpu_ms = run["counts"], run["route_ms"], run["cpu_route_ms"]
    print(f"    {run['routed']} requests in {run['batches']} batches, "
          f"{run['matched']} matched ({run['spill_rescued']} by the spill "
          f"round), identical decisions/accounts/ledger head "
          f"{run['head'][:16]}")
    print(f"    route_batch p50 {percentile(ms, 0.5):.2f} ms, p90 "
          f"{percentile(ms, 0.9):.2f} ms, {run['req_per_s']:.1f} requests/s "
          f"(CUDA router, host clock, synchronised)")
    print(f"    CPU router (plain versions): p50 {percentile(cpu_ms, 0.5):.2f}"
          f" ms, p90 {percentile(cpu_ms, 0.9):.2f} ms")
    print("    CUDA router per batch: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in sorted(run["phase_ms"].items())))
    print(f"    of phase2_solve and phase2_spill: {run['solve_ms']:.2f} ms in "
          f"the auction_solve calls (packing, the launch, the copy back), "
          f"{run['payments_ms']:.2f} ms in the host's Clarke payments "
          f"(dense_clarke_payments, NumPy float64) per batch")
    rounds = run["rounds"]
    print(f"    launches: {counts}; solves on the card {run['solves']}; "
          f"bid rounds per market solve (the kernel's, equal to the CPU "
          f"router's): mean {statistics.mean(rounds):.1f}, max "
          f"{max(rounds)}, over {len(rounds)} markets")
    print(f"    ledger bytes sent to the card per batch: "
          f"{run['ledger_bytes']:.0f} (prompts, row indices and dirty arena "
          f"rows; the first batch uploads the arena)")


def replay(calls, kernel, plain, work, iters: int, plain_iters: int) -> dict:
    """Every recorded call once through the kernel and its plain version,
    bit for bit, then each timed over the whole recorded sequence.  Times
    and the bound are per call, averaged over the calls; the bound counts
    the bytes and operations each call's own data needs."""
    check(bool(calls), "no kernel call was recorded on the main path")
    err, nbytes, nops = 0.0, 0, 0
    for args, kw in calls:
        got, want = kernel(*args, **kw), plain(*args, **kw)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        err = max(err, *(exact_diff(g, w) for g, w in zip(got, want)))
        b, o = work(args, got)
        nbytes, nops = nbytes + b, nops + o
    check(err == 0.0, f"{kernel.__name__} != plain at a main-path input")
    ms = cuda_time_ms(lambda: [kernel(*a, **kw) for a, kw in calls], iters, 1)
    dev_ms, dev_from = device_ms([lambda a=a, kw=kw: kernel(*a, **kw)
                                  for a, kw in calls],
                                 kernel.__name__.removesuffix("_cuda"))
    plain_ms = cuda_time_ms(lambda: [plain(*a, **kw) for a, kw in calls],
                            plain_iters, 1)
    bound, by = roofline(nbytes / len(calls), nops / len(calls))
    shapes = sorted({shape_key(args)[:2] for args, _ in calls})
    return {"calls": len(calls), "shapes": shapes, "max_abs_err": err,
            "ms": ms / len(calls), "device_ms": dev_ms,
            "device_ms_from": dev_from, "plain_ms": plain_ms / len(calls),
            "bound_ms": bound, "bound_by": by}


def replay_solve(calls, dev) -> tuple[dict, list]:
    """Every recorded ``auction_solve`` call once through the kernel and,
    on host copies, through its plain version (the host-driven staged
    market), bit for bit; then the kernel timed over the whole sequence.
    The plain replay also keeps every forward-bidding round it ran (the
    inputs of ``auction_bid`` at the main path's markets).  Returns the
    figures per call and those rounds' inputs."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.auction_bid import (auction_solve_cuda,
                                                 auction_solve_plain,
                                                 unpack_solution)

    check(bool(calls), "no auction_solve call was recorded on the main path")
    bids = []
    plain_bid = ops.auction_bid_op

    def keep_bid(*args):
        bids.append(args)
        return plain_bid(*args)

    ops.auction_bid_op = keep_bid
    err, plain_s, rounds, nbytes, nops = 0.0, 0.0, 0, 0, 0
    try:
        for (fbuf, ibuf, meta), _ in calls:
            got = auction_solve_cuda(fbuf, ibuf, meta).cpu()
            first = len(bids)
            t = time.perf_counter()
            want = auction_solve_plain(fbuf.cpu(), ibuf.cpu(), meta)
            plain_s += time.perf_counter() - t
            err = max(err, exact_diff(got, want))
            rounds += sum(r[3] for r in unpack_solution(want.numpy(), meta))
            nbytes += solve_bytes(meta)
            # forward bidding alone: 3 operations per active row and agent
            nops += sum(3 * b[0].shape[1] * int(b[3].sum())
                        for b in bids[first:])
    finally:
        ops.auction_bid_op = plain_bid
    check(err == 0.0, "auction_solve kernel != plain at a main-path input")
    ms = cuda_time_ms(lambda: [auction_solve_cuda(*a) for a, _ in calls],
                      5, 1)
    dev_ms, dev_from = device_ms([lambda a=a: auction_solve_cuda(*a)
                                  for a, _ in calls], "auction_solve")
    bound, by = roofline(nbytes / len(calls), nops / len(calls))
    return ({"calls": len(calls), "max_abs_err": err,
             "ms": ms / len(calls), "device_ms": dev_ms,
             "device_ms_from": dev_from,
             "plain_ms": plain_s * 1e3 / len(calls), "bound_ms": bound,
             "bound_by": by, "rounds_per_call": rounds / len(calls),
             "markets": sum(len(a[2]) for a, _ in calls)}, bids)


def bid_calls_on_card(bids, dev, most: int = 2048) -> list:
    """Up to ``most`` of the recorded bidding rounds, evenly spaced, moved
    to the card as replayable calls."""
    step = max(1, len(bids) // most)
    return [(tuple(a.to(dev) if hasattr(a, "to") else a for a in b), {})
            for b in bids[::step][:most]]


def phase_router_kernels(dev) -> tuple[Counter, dict]:
    """Phases 3-5: the router's kernels against their plain versions on
    synthetic inputs, the router lockstep at one hub and at SCALE_128's
    hubs, and the kernels at every main-path input.  Returns the main
    path's launch counts (both runs) and each router kernel's figures."""
    from repro_torch.configs.iemas_cluster import SCALE_128
    from repro_torch.kernels.auction_bid import (auction_bid_cuda,
                                                 auction_bid_plain)
    from repro_torch.kernels.lcp_affinity import (lcp_affinity_cuda,
                                                  lcp_affinity_plain,
                                                  lcp_gather_cuda,
                                                  lcp_gather_plain)

    print("[3] router kernels against their plain versions")
    phase_kernels(dev)
    phase_solve_kernels(dev)

    runs = {}
    for hubs in (1, SCALE_128.n_hubs()):
        print(f"[4] router lockstep, CUDA vs CPU, SCALE_128 fleet, {hubs} "
              f"hub(s), spill on")
        runs[hubs] = run = phase_router(dev, hubs)
        print_router(run)
    counts = Counter()
    for run in runs.values():
        counts.update(run["counts"])
    check(counts["lcp_gather"] > 0 and counts["auction_solve"] > 0,
          f"a kernel of the main path never launched: {counts}")

    print("[5] router kernels at the inputs of every main-path call")
    calls = {name: [c for run in runs.values() for c in run["calls"][name]]
             for name in ("auction_solve", "lcp_gather")}
    solve, bids = replay_solve(calls["auction_solve"], dev)
    gather = replay(calls["lcp_gather"], lcp_gather_cuda, lcp_gather_plain,
                    lambda args, out: gather_work(*args, out[0]), 50, 10)
    # the one-round and dense-tile kernels, which the main path no longer
    # launches, at the same data: the bidding rounds of the plain replay
    # and the dense tiles of the gather calls
    bid = replay(bid_calls_on_card(bids, dev), auction_bid_cuda,
                 auction_bid_plain, lambda args, out: bid_work(*args), 5, 2)
    lcp = replay([(dense_tile(*args), {}) for args, _ in calls["lcp_gather"]],
                 lcp_affinity_cuda, lcp_affinity_plain,
                 lambda args, out: lcp_work(*args, out[0]), 50, 10)
    print(f"    auction_solve over {solve['calls']} calls ({solve['markets']} "
          f"markets, {solve['rounds_per_call']:.1f} rounds per call): "
          f"bit-exact, kernel {solve['ms']:.4f} ms ({dev_text(solve)}, "
          f"{solve['device_ms'] / solve['rounds_per_call'] * 1e3:.2f} us per "
          f"round), plain (host) {solve['plain_ms']:.1f} ms, bound "
          f"{solve['bound_ms']:.7f} ms ({solve['bound_by']}) per call")
    for name, r in (("lcp_gather", gather), ("auction_bid", bid),
                    ("lcp_affinity", lcp)):
        print(f"    {name} over {r['calls']} calls {r['shapes']}: bit-exact, "
              f"kernel {r['ms']:.4f} ms ({dev_text(r)}), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.7f} ms "
              f"({r['bound_by']}) per call")
    return counts, {"lcp_gather": gather, "auction_solve": solve,
                    "auction_bid": bid, "lcp_affinity": lcp}


# ------------------------------------------------------- attention, 6 --
def ops_rate(dtype) -> float:
    """Peak operations per second for inputs of ``dtype``."""
    import torch

    return BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S


def kernel_work(name: str):
    """``repro_torch.kernels.work``'s ``name``, imported at its first
    call (torch loads after ``main`` has set its environment): the bytes
    and operations of one kernel call, the ones the dry run counts."""
    def work(*args, **kw):
        from repro_torch.kernels import work as counts

        return getattr(counts, name)(*args, **kw)
    work.__name__ = name
    return work


flash_work = kernel_work("flash_work")
bwd_work = kernel_work("bwd_work")
decode_work = kernel_work("decode_work")
wkv6_work = kernel_work("wkv6_work")
ssd_work = kernel_work("ssd_work")
wkv6_bwd_work = kernel_work("wkv6_bwd_work")
ssd_bwd_work = kernel_work("ssd_bwd_work")


def sdpa_flash(q, k, v, *, causal=True, window=0, q_offset=0):
    """PyTorch's one call for the same function (the yardstick)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window or q_offset:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = ((kpos <= qpos) | (not causal)) & (
            ((qpos - kpos) < window) | (not window))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)
    return out.transpose(1, 2)


def sdpa_decode(q, k_cache, v_cache, valid):
    """PyTorch's one call for the same function (the yardstick)."""
    import torch.nn.functional as F

    out = F.scaled_dot_product_attention(
        q[:, :, None, :], k_cache.transpose(1, 2), v_cache.transpose(1, 2),
        attn_mask=valid[:, None, None, :], enable_gqa=True)
    return out[:, :, 0]


def attn_err(got, want, what: str) -> float:
    """Max abs error of ``got`` against ``want``, checked against the
    reference's tolerance for their dtype."""
    err = float((got.float() - want.float()).abs().max())
    tol = ATTN_TOL[str(got.dtype).removeprefix("torch.")]
    check(err < tol, f"{what}: max abs error {err} >= {tol}")
    return err


def row_rel_err(got, want, what: str, floor: float = 0.0) -> float:
    """The largest over output rows (the last axis: one query and head) of
    the row's max abs error over its largest plain output, checked against
    ``ATTN_ROW_TOL``: the gate for outputs far below the absolute one.
    With ``floor``, a row's largest plain output counts as at least
    ``floor`` of the whole output's (for rows whose exact value is 0,
    where both versions hold only rounding noise)."""
    got, want = got.float(), want.float()
    least = max(floor * float(want.abs().max()), 1e-30)
    err = float(((got - want).abs().amax(-1)
                 / want.abs().amax(-1).clamp_min(least)).max())
    check(err < ATTN_ROW_TOL, f"{what}: a row's error is {err} of its "
          f"largest output (>= {ATTN_ROW_TOL})")
    return err


def attn_figures(kernel, plain, library, work, args, kw, iters=50,
                 rows=False) -> dict:
    """One call's kernel, plain and library times (CUDA events) and bound,
    after checking the kernel and the library against the plain version;
    with ``rows``, the kernel's rows also within ``ATTN_ROW_TOL``."""
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    what = f"{kernel.__name__} {shape_key(args, kw)}"
    err = attn_err(got, want, what)
    row_err = row_rel_err(got, want, what) if rows else None
    attn_err(library(*args, **kw), want, f"library {shape_key(args, kw)}")
    bound, by = roofline(*work(*args, **kw), ops_rate(args[0].dtype))
    dev_ms, dev_from = device_ms([lambda: kernel(*args, **kw)] * iters,
                                 kernel.__name__.removesuffix("_cuda"))
    return {"max_abs_err": err, "max_row_rel_err": row_err,
            "ms": cuda_time_ms(lambda: kernel(*args, **kw), iters, 5),
            "device_ms": dev_ms, "device_ms_from": dev_from,
            "plain_ms": cuda_time_ms(lambda: plain(*args, **kw), 10, 2),
            "library_ms": cuda_time_ms(lambda: library(*args, **kw), iters,
                                       5),
            "bound_ms": bound, "bound_by": by}


def dev_text(f) -> str:
    """A figure's device time per call and where it came from."""
    return f"device {f['device_ms']:.4f} from {f['device_ms_from']}"


def print_figures(name, shape, f) -> None:
    lib = ("" if f["library_ms"] is None
           else f", library {f['library_ms']:.4f} ms")
    rows = ("" if f.get("max_row_rel_err") is None else
            f" (rows within {f['max_row_rel_err']:.3g} of their max)")
    if f.get("max_rel_err") is not None:
        rows += (f" (each output within {f['max_rel_err']:.3g} of its "
                 "largest plain value)")
    print(f"    {name} {shape}: max abs err {f['max_abs_err']:.3g}{rows}, "
          f"kernel {f['ms']:.4f} ms ({dev_text(f)}), plain "
          f"{f['plain_ms']:.4f} ms{lib}, bound {f['bound_ms']:.6f} ms "
          f"({f['bound_by']})")


def phase_attention(dev) -> None:
    """Both attention kernels against their plain versions at synthetic
    full-width shapes, in float32 and bf16: qwen3-8b's layers (32 query / 8
    KV heads of 128) and zamba2-7b's shared block (32 / 32 heads of 112)."""
    from repro_torch.configs import get_config

    for arch, lengths in ((ARCH, (128, 512)), (ZAMBA, (61, 512))):
        cfg = get_config(arch)
        print(f"    {arch}: {cfg.n_heads} query / {cfg.n_kv_heads} KV heads "
              f"of {cfg.hd}")
        attention_shapes(dev, cfg.n_heads, cfg.n_kv_heads, cfg.hd, lengths)


def attention_shapes(dev, h, hkv, d, lengths, dtypes=None,
                     rows=False) -> None:
    """Flash attention at each prompt length and decode attention at
    M = MAX_LEN under a random mask, for one head layout, in float32 and
    bf16 (or ``dtypes``); ``rows`` as in ``attn_figures``."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)

    rng = np.random.default_rng(6 + d)

    def normal(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(dtype)

    for dtype in dtypes or (torch.float32, torch.bfloat16):
        for s in lengths:
            args = (normal((1, s, h, d), dtype), normal((1, s, hkv, d), dtype),
                    normal((1, s, hkv, d), dtype))
            f = attn_figures(flash_attention_cuda, flash_attention_plain,
                             sdpa_flash, flash_work, args, {}, rows=rows)
            print_figures(f"flash_attention {dtype}", shape_key(args), f)
        valid = rng.random((1, MAX_LEN)) < 0.6
        valid[:, 0] = True
        args = (normal((1, h, d), dtype), normal((1, MAX_LEN, hkv, d), dtype),
                normal((1, MAX_LEN, hkv, d), dtype),
                torch.from_numpy(valid).to(dev))
        f = attn_figures(decode_attention_cuda, decode_attention_plain,
                         sdpa_decode, decode_work, args, {}, rows=rows)
        print_figures(f"decode_attention {dtype}", shape_key(args), f)


def replay_sampled(rec, name: str, figures) -> dict:
    """The kernel against its plain version at every sampled main-path
    input, each timed alone (``figures(args, kw)``); per-call figures
    weighted by how many calls of the sample's shape the main path made, so
    they are means per call of the main path."""
    check(bool(rec.calls), f"no {name} call was recorded")
    sampled = Counter(shape_key(args, kw) for args, kw in rec.calls)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")
    total = dict.fromkeys(keys, 0.0)
    weight, by, froms = 0.0, Counter(), set()
    worst = {}                  # each error figure's worst over the samples
    for args, kw in rec.calls:
        key = shape_key(args, kw)
        w = rec.count[key] / sampled[key]
        f = figures(args, kw)
        for k in ERROR_FIGURES:
            if f.get(k) is not None:
                worst[k] = max(worst.get(k, 0.0), f[k])
        for k in keys:
            total[k] = None if f[k] is None else total[k] + w * f[k]
        by[f["bound_by"]] += w
        froms.add(f["device_ms_from"])
        weight += w
        print_figures(f"{name} x{rec.count[key]}", shown_key(key), f)
    return {"calls": sum(rec.count.values()), "sampled": len(rec.calls),
            **worst, "bound_by": by.most_common(1)[0][0],
            "device_ms_from": "+".join(sorted(froms)),
            **{k: None if v is None else v / weight
               for k, v in total.items()}}


def replay_attention(rec, kernel, plain, library, work,
                     rows: bool = False) -> dict:
    """``replay_sampled`` through ``attn_figures`` (``rows`` as there)."""
    return replay_sampled(rec, kernel.__name__, lambda args, kw: attn_figures(
        kernel, plain, library, work, args, kw, iters=20, rows=rows))


# ------------------------------------------------------------ engines --
def mode_of(res, prev_prompt) -> str:
    """The engine's serving mode for a result, from its cache accounting
    and the session's stored prompt before the call (the engine's rule)."""
    if res.n_hit == 0:
        return "fresh"
    if res.n_hit == res.n_prompt:
        return ("identical" if prev_prompt is not None
                and len(prev_prompt) == res.n_prompt else "extend-noop")
    return "extend"


def rel_logit_err(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def session_logits(engine, did):
    """Logits of one uncommitted decode step on a stored session's cache
    (the stored cache is left as it was)."""
    import torch

    sess = engine.sessions[did]
    tok = torch.tensor([int(sess.prompt[-1])], dtype=torch.int32,
                       device=engine.device)
    with torch.no_grad():
        logits, _ = engine.model.decode_step(engine.params, sess.cache, tok)
    return logits


def phase_engine_lockstep(dev) -> None:
    """A CUDA engine and a CPU engine on the same weights (full width, two
    layers, float32) serve the same two dialogues in lockstep."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import AgentEngine
    from repro_torch.serving.workload import WorkloadSpec, generate

    cfg = dataclasses.replace(get_config(ARCH), n_layers=2, dtype="float32")
    kw = {"max_len": MAX_LEN, "max_new_tokens": 4, "cache_slots": 1}
    gpu = AgentEngine(cfg, seed=7, device=dev, **kw)
    cpu = AgentEngine(cfg, device="cpu",
                      params=copy.deepcopy(gpu.params).cpu(), **kw)
    scripts = generate(WorkloadSpec("coqa_like", 2, seed=7))
    history = {s.dialogue_id: np.zeros(0, np.int32) for s in scripts}
    plan = [(0, 0), (0, 1), (0, None), (1, 0), (1, 1), (0, 2)]
    modes, worst, flash_launches = [], 0.0, 0
    for i, (d, t) in enumerate(plan):
        did = scripts[d].dialogue_id
        prev = gpu.sessions.get(did)
        prev = None if prev is None else prev.prompt
        prompt = prev if t is None else np.concatenate(
            [history[did], scripts[d].turns[t]]).astype(np.int32)
        before = ops.launch_counts()["flash_attention"]
        a = gpu.serve(did, prompt, now=float(i))
        flash_launches += ops.launch_counts()["flash_attention"] - before
        b = cpu.serve(did, prompt, now=float(i))
        check(np.array_equal(a.output_tokens, b.output_tokens)
              and (a.n_hit, a.n_prompt) == (b.n_hit, b.n_prompt),
              f"CUDA and CPU engines diverged at step {i} ({did}): "
              f"{a.output_tokens} / {b.output_tokens}, hits {a.n_hit} / "
              f"{b.n_hit}")
        mode = mode_of(a, prev)
        check(mode == mode_of(b, prev), "engine modes diverged")
        err = rel_logit_err(session_logits(gpu, did), session_logits(cpu, did))
        check(err < ENGINE_LOGIT_TOL, f"last-token logits differ by {err} "
              f"at step {i}")
        worst = max(worst, err)
        modes.append(mode)
        history[did] = np.concatenate([prompt, a.output_tokens])
    check(gpu.evictions == cpu.evictions > 0, "no eviction, or a different "
          "count")
    check({"fresh", "extend", "identical"} <= set(modes),
          f"modes not all covered: {modes}")
    check(flash_launches == cfg.n_layers * modes.count("fresh"),
          f"the CUDA engine launched flash_attention {flash_launches} times "
          f"for modes {modes}")
    print(f"    {len(plan)} requests, modes {modes}, evictions "
          f"{gpu.evictions}: identical tokens and cache hits, last-token "
          f"logits within {worst:.2e} of their max (limit "
          f"{ENGINE_LOGIT_TOL})")


def slice_requests():
    """Multi-turn requests for the full-width slice: two quac_like and one
    coqa_like dialogue, turns interleaved, then an identical repeat."""
    from repro_torch.serving.workload import WorkloadSpec, generate

    quac = generate(WorkloadSpec("quac_like", 2, seed=8))
    coqa = generate(WorkloadSpec("coqa_like", 1, seed=8))
    plan = [(quac[0], 0), (quac[1], 0), (coqa[0], 0), (quac[0], 1),
            (coqa[0], 1), (quac[1], 1), (quac[0], 2), (coqa[0], None)]
    return plan


def phase_slice(dev, seed: int, cfg=None):
    """One full-width bf16 engine (``cfg``, default qwen3-8b) serves the
    slice's requests; returns the engine, the launch counts of the run and
    the recorded kernel calls.  Each GQA layer launches one flash call per
    fresh prefill and one decode call per decode or no-op step; MLA layers
    launch neither (no kernel in the reference)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import AgentEngine, _bucket

    cfg = cfg or get_config(ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = AgentEngine(cfg, seed=seed, device=dev, max_len=MAX_LEN,
                         max_new_tokens=8, cache_slots=12)
    torch.cuda.synchronize()
    kind = cfg.attn_kind
    if cfg.sliding_window:
        kind += f", window {cfg.sliding_window}"
    if cfg.is_moe:
        kind += f", {cfg.n_experts} experts, top {cfg.top_k}"
    print(f"    {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd} ({kind}), "
          f"{cfg.dtype}; "
          f"{sum(p.numel() for p in engine.params.parameters()) / 1e9:.3f} B "
          f"parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    engine.warmup()
    history, rows, fresh, noops, steps = {}, [], 0, 0, 0
    with recording(ops, ("flash_attention", "decode_attention"),
                   per_shape=2) as rec:
        ops.reset_launch_counts()          # the engine's main path starts
        for i, (script, t) in enumerate(slice_requests()):
            did = script.dialogue_id
            prev = engine.sessions.get(did)
            prev = None if prev is None else prev.prompt
            prompt = prev if t is None else np.concatenate(
                [history.get(did, np.zeros(0, np.int32)),
                 script.turns[t]]).astype(np.int32)
            check(len(prompt) + engine.max_new <= MAX_LEN,
                  "a dialogue outgrew max_len")
            res = engine.serve(did, prompt, now=float(i))
            mode = mode_of(res, prev)
            fresh += mode == "fresh"
            noops += mode in ("identical", "extend-noop")
            steps += res.n_gen
            rows.append((mode, res))
            history[did] = np.concatenate([prompt, res.output_tokens])
        counts = ops.launch_counts()       # ... and ends here
    layers = 0 if cfg.attn_kind == "mla" else cfg.n_layers
    check(counts["flash_attention"] == layers * fresh,
          f"flash_attention launched {counts['flash_attention']} times for "
          f"{fresh} fresh prefills of {layers} layers")
    check(counts["decode_attention"] == layers * (steps + noops),
          f"decode_attention launched {counts['decode_attention']} times for "
          f"{steps} decode steps and {noops} no-op steps of {layers} layers")
    print_modes(rows, ("fresh", "extend", "identical"))
    # what comes out: finite logits of the right shape, and the greedy
    # token of a direct prefill (padded as the engine pads) equals what the
    # engine generated first
    script, t = slice_requests()[0]
    prompt = np.asarray(script.turns[t], np.int32)
    pad = np.zeros((1, _bucket(len(prompt))), np.int32)
    pad[0, :len(prompt)] = prompt
    with torch.no_grad():
        logits, _ = engine.model.prefill(engine.params, {
            "tokens": torch.from_numpy(pad).to(dev),
            "lens": torch.tensor([len(prompt)], dtype=torch.int32,
                                 device=dev),
            "max_len": MAX_LEN})
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits are not "
          "finite values of shape [1, vocab]")
    check(int(logits.argmax(-1)[0]) == int(rows[0][1].output_tokens[0]),
          "a direct prefill's greedy token differs from the engine's")
    print(f"    launches {counts} for {fresh} fresh prefills, {steps} decode "
          f"steps and {noops} no-op steps; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    # where a step's time goes: host clock against the device's kernel
    # time from a profiler trace (outside the counted run)
    batch = {"tokens": torch.from_numpy(pad).to(dev),
             "lens": torch.tensor([len(prompt)], dtype=torch.int32,
                                  device=dev), "max_len": MAX_LEN}
    cache = engine.sessions[script.dialogue_id].cache
    tok = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for what, fn, n in (
                (f"prefill of {pad.shape[1]} tokens",
                 lambda: engine.model.prefill(engine.params, batch), 2),
                ("decode step", lambda: engine.model.decode_step(
                    engine.params, cache, tok), 8)):
            print(f"    {what}: " + device_share(fn, n))
    return engine, counts, rec


def print_modes(rows, modes) -> None:
    """Per serving mode: TTFT, decode time per token, tokens/s and cache
    hits of the (mode, ServeResult) rows; every mode must occur."""
    check(set(modes) <= {m for m, _ in rows},
          f"modes not all covered: {[m for m, _ in rows]}")
    for mode in modes:
        got = [r for m, r in rows if m == mode]
        ttft = [r.ttft * 1e3 for r in got]
        dec_s = sum(r.total_time - r.ttft for r in got)
        ntok = sum(r.n_gen for r in got)
        check(all(r.n_hit > 0 for r in got) == (mode != "fresh"),
              f"cache hits do not fit mode {mode}")
        print(f"    {mode:9s} x{len(got)}: TTFT mean {statistics.mean(ttft):.2f}"
              f" ms (min {min(ttft):.2f}, max {max(ttft):.2f}), decode "
              f"{dec_s / ntok * 1e3:.2f} ms/token, {ntok / dec_s:.1f} tokens/s"
              f", hits {sum(r.n_hit for r in got)}/"
              f"{sum(r.n_prompt for r in got)} prompt tokens")


def device_share(fn, steps: int) -> str:
    """Host ms per call of ``fn`` and the device's busy share over
    ``steps`` calls, from a ``torch.profiler`` trace of the device alone
    (the sum of CUDA kernel times over the host clock; a trace of the
    host's operators too would slow the calls it times, and at full width
    holds ~10^5 events a step to sort), with the kernels that take most
    of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prime_trace()
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.key]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    if busy_ms == 0.0:
        return (f"host {wall_ms:.2f} ms per call; device time not measured "
                "(the trace holds no kernel)")
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:5]
    return (f"host {wall_ms:.2f} ms per call, device kernels {busy_ms:.2f} "
            f"ms ({busy_ms / wall_ms:.1%} busy); top: " + "; ".join(
                f"{e.key[:60]} {e.device_time_total / 1e3 / steps:.3f} ms "
                f"x{e.count // steps}" for e in top))


def phase_router_engines(dev, engine0) -> None:
    """The quickstart chain at full width: the CUDA router over two
    full-width engines, turn 1 then turn 2 of two dialogues."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.iemas_cluster import (RouterConfig, agent_infos,
                                                   agent_profiles,
                                                   make_router)
    from repro_torch.core.mechanism import CompletionObs, Request
    from repro_torch.serving.engine import AgentEngine

    profiles = agent_profiles(2)
    engines = {}
    for prof in profiles:
        if prof.agent_id == SLICE_AGENT:   # phase 8's engine, same seed
            engine = engine0
            engine.sessions.clear()
        else:
            engine = AgentEngine(get_config(ARCH),
                                 seed=agent_seed(prof.agent_id), device=dev,
                                 max_len=MAX_LEN, max_new_tokens=8)
        engine.speed = prof.speed
        engine.cache_slots = prof.cache_slots
        engines[prof.agent_id] = engine
    router = make_router(agent_infos(profiles), RouterConfig(), device=dev,
                         predictor_kw={"warm_n": 2})
    rng = np.random.default_rng(9)
    dialogues = {f"session-{j}": rng.integers(1, 250, n).astype(np.int32)
                 for j, n in enumerate((40, 64))}
    first = {}
    for turn in (0, 1):
        reqs = [Request(f"r{turn}-{did}", did, toks, turn=turn,
                        domain="dialogue", max_new_tokens=8)
                for did, toks in dialogues.items()]
        decisions = router.route_batch(reqs, {})
        check(all(d.agent_id is not None for d in decisions),
              f"turn {turn + 1}: a request was not matched")
        for d in decisions:
            req = d.request
            engine = engines[d.agent_id]
            aff = router.ledger.affinity(d.agent_id, req.dialogue_id,
                                         req.tokens)
            res = engine.serve(req.dialogue_id, req.tokens)
            check(bool(torch.isfinite(session_logits(
                engine, req.dialogue_id)).all()), "logits are not finite")
            router.on_complete(req.request_id, CompletionObs(
                res.ttft, res.n_prompt, res.n_hit, res.n_gen, 0.7))
            if turn == 0:
                first[req.dialogue_id] = d.agent_id
                dialogues[req.dialogue_id] = np.concatenate(
                    [req.tokens, res.output_tokens,
                     rng.integers(1, 250, 8).astype(np.int32)])
                print(f"    turn 1 {req.dialogue_id} -> {d.agent_id}, "
                      f"payment {d.payment:.4f}, TTFT {res.ttft * 1e3:.1f} ms, "
                      f"hit {res.n_hit}/{res.n_prompt}")
            else:
                same = d.agent_id == first[req.dialogue_id]
                check(not same or res.n_hit > 0, f"turn 2 of "
                      f"{req.dialogue_id} returned to its agent but missed "
                      "the cache")
                print(f"    turn 2 {req.dialogue_id} -> {d.agent_id} "
                      f"(same agent as turn 1: {same}), affinity o_ij "
                      f"{aff:.3f}, TTFT {res.ttft * 1e3:.1f} ms, hit "
                      f"{res.n_hit}/{res.n_prompt}")
    print(f"    accounts {dict(router.accounts)}")


# ---------------------------------------------- recurrent scans, 10 --
SCAN_TOL = 1e-3                    # tests/test_kernels.py's, float32
CHUNK = 16


def scan_err(got, want, what: str) -> float:
    """Max abs error of a kernel's (output, state) against its plain
    version's: float32 within 1e-3; a bf16 output within one bf16 rounding
    of the plain one (|got - want| <= 2^-7·|want| + 1e-3: both round
    float32 sums that differ in their last bits) and the float32 state
    within 1e-3."""
    import torch

    (go, gs), (wo, ws) = got, want
    diff = (go.float() - wo.float()).abs()
    if go.dtype == torch.bfloat16:
        ok = bool((diff <= 2.0 ** -7 * wo.float().abs() + SCAN_TOL).all())
    else:
        ok = float(diff.max()) < SCAN_TOL
    serr = float((gs - ws).abs().max())
    check(ok and serr < SCAN_TOL and go.dtype == wo.dtype,
          f"{what}: output error {float(diff.max())}, state error {serr}")
    return max(float(diff.max()), serr)


def scan_figures(kernel, plain, work, args, kw, iters=50) -> dict:
    """One call's kernel and plain times (CUDA events) and bound, after
    checking the kernel against the plain version.  No one PyTorch call
    computes either scan: ``library_ms`` is None."""
    err = scan_err(kernel(*args, **kw), plain(*args, **kw),
                   f"{kernel.__name__} {shape_key(args)}")
    bound, by = roofline(*work(*args, **kw), ops_rate(args[0].dtype))
    dev_ms, dev_from = device_ms([lambda: kernel(*args, **kw)] * iters,
                                 kernel.__name__.removesuffix("_cuda"))
    return {"max_abs_err": err,
            "ms": cuda_time_ms(lambda: kernel(*args, **kw), iters, 5),
            "device_ms": dev_ms, "device_ms_from": dev_from,
            "plain_ms": cuda_time_ms(lambda: plain(*args, **kw), 5, 1),
            "library_ms": None, "bound_ms": bound, "bound_by": by}


def phase_scans(dev) -> None:
    """Both scan kernels against their plain versions at synthetic
    full-width shapes: WKV6 at rwkv6-3b's 40 heads of 64, SSD at
    zamba2-7b's 112 heads of 64 with a state of 64; S = 61 (a ragged last
    chunk) and 512; float32 and bf16; zero and stored initial states; then
    strong decays (log_w down to -50, dt up to 20) at S = 512."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd_cuda, ssd_plain
    from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain

    rng = np.random.default_rng(10)

    def normal(shape, dtype=torch.float32, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) * scale).to(dev).to(dtype)

    rw, zb = get_config(RWKV), get_config(ZAMBA)
    h, dk = rw.ssm_heads, rw.ssm_state
    zh, ds = zb.ssm_heads, zb.ssm_state
    hd = 2 * zb.d_model // zh
    for dtype in (torch.float32, torch.bfloat16):
        for s in (61, 512):
            for stored in (False, True):
                lw = torch.from_numpy(np.clip(-np.exp(rng.standard_normal(
                    (1, s, h, dk))), -4.0, -1e-3).astype(np.float32)).to(dev)
                args = (normal((1, s, h, dk), dtype),
                        normal((1, s, h, dk), dtype),
                        normal((1, s, h, dk), dtype), lw, normal((h, dk)),
                        normal((1, h, dk, dk)) if stored else None)
                f = scan_figures(wkv6_cuda, wkv6_plain, wkv6_work, args, {})
                print_figures(f"wkv6 {dtype} s0={'stored' if stored else 0}",
                              shape_key(args)[:1], f)
                dt = torch.from_numpy((np.abs(rng.standard_normal(
                    (1, s, zh))) * 0.5).astype(np.float32)).to(dev)
                args = (normal((1, s, zh, hd), dtype),
                        normal((1, s, ds), dtype), normal((1, s, ds), dtype),
                        dt, normal((zh,), scale=0.3), normal((zh,)),
                        normal((1, zh, hd, ds)) if stored else None)
                f = scan_figures(ssd_cuda, ssd_plain, ssd_work, args, {})
                print_figures(f"ssd {dtype} s0={'stored' if stored else 0}",
                              shape_key(args)[:1], f)
    for dtype in (torch.float32, torch.bfloat16):   # strong decays
        s = 512
        lw = torch.from_numpy(np.clip(-np.exp(rng.standard_normal(
            (1, s, h, dk)) * 2.0 + 1.0), -50.0, -1e-3).astype(np.float32))
        args = (normal((1, s, h, dk), dtype), normal((1, s, h, dk), dtype),
                normal((1, s, h, dk), dtype), lw.to(dev), normal((h, dk)),
                normal((1, h, dk, dk)))
        check(all(bool(torch.isfinite(t.float()).all())
                  for t in wkv6_cuda(*args)), "wkv6: strong decays")
        f = scan_figures(wkv6_cuda, wkv6_plain, wkv6_work, args, {})
        print_figures(f"wkv6 {dtype} log_w to {float(lw.min()):.1f}",
                      shape_key(args)[:1], f)
        # x / 20 keeps dt·x of order one: with dt up to 20 and x ~ N(0, 1)
        # y reaches ~2e3, where float32 sums (the plain version's too,
        # 8e-3 from float64) cannot meet an absolute 1e-3
        dt = torch.from_numpy(np.minimum(np.abs(rng.standard_normal(
            (1, s, zh))) * 10.0, 20.0).astype(np.float32)).to(dev)
        args = (normal((1, s, zh, hd), dtype, 0.05),
                normal((1, s, ds), dtype),
                normal((1, s, ds), dtype), dt, normal((zh,), scale=0.3),
                normal((zh,)), normal((1, zh, hd, ds)))
        check(all(bool(torch.isfinite(t.float()).all())
                  for t in ssd_cuda(*args)), "ssd: strong decays")
        f = scan_figures(ssd_cuda, ssd_plain, ssd_work, args, {})
        print_figures(f"ssd {dtype} dt to {float(dt.max()):.1f}",
                      shape_key(args)[:1], f)


def replay_scan(rec, kernel, plain, work) -> dict:
    return replay_sampled(rec, kernel.__name__, lambda args, kw: scan_figures(
        kernel, plain, work, args, kw, iters=20))


# ------------------------------------------------ scan backward, 23b --
SCAN_BWD_LENGTHS = (61, 512, 4096)   # ragged, phase 24's, train_4k's
SCAN_BWD_BATCH = 2
# the outputs of each backward whose rows are gated (a token and head of
# dr / dk / dv / dlog_w / dx, a token of dB / dC: the last axis a row)
SCAN_BWD_NAMES = {"wkv6_bwd": ("dr", "dk", "dv", "dlog_w", "du", "ds0"),
                  "ssd_bwd": ("dx", "dB", "dC", "ddt", "da_log", "dD",
                              "ds0")}
SCAN_BWD_ROWS = {"wkv6_bwd": {"dr", "dk", "dv", "dlog_w"},
                 "ssd_bwd": {"dx", "dB", "dC"}}


def scan_bwd_parts(op: str):
    """(kernel, plain version, work) of a scan's backward; the plain
    version takes the forward's inputs with s0, as the kept states' first
    (every chunk's or the checkpoints') holds it."""
    from repro_torch.kernels.ssd import ssd_bwd_cuda, ssd_bwd_plain
    from repro_torch.kernels.wkv6 import wkv6_bwd_cuda, wkv6_bwd_plain

    if op == "wkv6_bwd":
        def plain(r, k, v, log_w, u, states, do, dst=None, **_):
            return wkv6_bwd_plain(r, k, v, log_w, u, states[:, :, 0], do,
                                  dst)
        return wkv6_bwd_cuda, plain, wkv6_bwd_work

    def plain(x, bmat, cmat, dt, a_log, d_skip, states, dy, dst=None, **_):
        return ssd_bwd_plain(x, bmat, cmat, dt, a_log, d_skip,
                             states[:, :, 0], dy, dst)
    return ssd_bwd_cuda, plain, ssd_bwd_work


def scan_bwd_launches(op: str, args) -> tuple[str, dict]:
    """The OP_KERNELS key of one backward call of a scan (``op`` from
    every chunk's state, ``op``_checkpointed from the checkpoints) and its
    launches per call by stem (1 where absent): from the checkpoints the
    reverse and chunk passes and the recompute's state pass once a
    segment, its pass A once a segment (WKV6) or once for every segment's
    coefficients (SSD), the fixed-order sums once."""
    states = args[6 if op == "ssd_bwd" else 5]
    if states.shape[2] == -(-args[0].shape[1] // CHUNK):
        return op, {}
    key = f"{op}_checkpointed"
    launches = {k: states.shape[2]
                for k in (*OP_KERNELS[op][:2], *OP_KERNELS[key][-2:])}
    if op == "ssd_bwd":
        launches["ssd_recompute_intra_kernel"] = 1
    return key, launches


def scan_bwd_figures(op: str, args, kw, iters: int = 10,
                     profile: bool = True) -> dict:
    """One backward call of a scan (``op``: wkv6_bwd or ssd_bwd) against
    its plain version: each gradient within BWD_TOL of its largest plain
    magnitude, each row of the SCAN_BWD_ROWS outputs within ATTN_ROW_TOL
    of its own largest, floored at BWD_ROW_FLOOR; a second call the same
    bits; timed beside the plain version (its one call, CUDA events), with
    its bound (operations at the peak rate of the inputs' type).  Without
    ``profile``, and from the checkpoints, whose passes run side by side on
    several streams (a sum of kernel times would count the overlap twice),
    the device time comes from CUDA events alone (``queued_event_ms``).
    No one PyTorch call computes either: ``library_ms`` is None."""
    import torch

    kernel, plain, work = scan_bwd_parts(op)
    args = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in args)
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(*args, **kw)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    again = kernel(*args, **kw)
    tol = BWD_TOL[str(args[0].dtype).removeprefix("torch.")]
    err, rel, row = 0.0, 0.0, 0.0
    for name, g, w, a in zip(SCAN_BWD_NAMES[op], got, want, again):
        if g is None:               # ds0 not asked for
            continue
        what = f"{op} {name} {shape_key(args)[:1]}"
        check(torch.equal(g, a), f"{what}: two runs differ")
        check(g.dtype == w.dtype and bool(torch.isfinite(g.float()).all()),
              f"{what}: dtype {g.dtype} / {w.dtype} or not finite")
        e = float((g.float() - w.float()).abs().max())
        r = e / max(float(w.float().abs().max()), 1e-30)
        check(r <= tol, f"{what}: {r:.3g} of its largest plain value "
              f"(limit {tol})")
        if name in SCAN_BWD_ROWS[op]:
            row = max(row, row_rel_err(g, w, what, floor=BWD_ROW_FLOOR))
        err, rel = max(err, e), max(rel, r)
    del got, want, again
    bound, by = roofline(*work(*args, **kw), ops_rate(args[0].dtype))
    calls = [lambda: kernel(*args, **kw)] * iters
    key, launches = scan_bwd_launches(op, args)
    dev_ms, dev_from = (device_ms(calls, key, launches)
                        if profile and key == op else
                        (queued_event_ms(calls) / iters, "events"))
    return {"max_abs_err": err, "max_rel_err": rel, "max_row_rel_err": row,
            "ms": cuda_time_ms(lambda: kernel(*args, **kw), iters, 2),
            "device_ms": dev_ms, "device_ms_from": dev_from,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
            "bound_by": by}


def scan_bwd_pass_ms(op: str, args, kw, calls: int = 5) -> dict[str, float]:
    """Device ms per call of each kernel of a scan backward (``op``), by
    its OP_KERNELS stem: the profiler's mean launch over ``calls`` calls in
    one trace times its launches a call.  The trace must hold each stem's
    launches a call (`scan_bwd_launches`) times the calls, exactly: fewer
    (a record the profiler lost) traces again, up to PROFILE_TRIES times
    (a stem still short is absent from the result), and more fails."""
    kernel, _, _ = scan_bwd_parts(op)
    key, launches = scan_bwd_launches(op, args)
    want = {k: launches.get(k, 1) * calls for k in OP_KERNELS[key]}
    for _ in range(PROFILE_TRIES):
        means, count = profiled_kernel_means(
            lambda: [kernel(*args, **kw) for _ in range(calls)], key)
        if all(count[k] >= n for k, n in want.items()):
            break
    check(all(count[k] <= n for k, n in want.items()),
          f"{op}: {dict(count)} launches in {calls} calls, beyond the "
          f"design's {want}")
    return {k: v * launches.get(k, 1) / 1e3 for k, v in means.items()
            if count[k] == want[k]}


def scan_bwd_schedule(op: str, args, kw) -> dict:
    """One traced backward call of a scan from the checkpoints: each
    pass's device ms (kernel time, summed over its launches) and the share
    of the recompute's kernel time that falls inside a chunk or reverse
    pass (``recompute_inside``), and of the reverse passes' inside a chunk
    pass (``reverse_inside``)."""
    kernel, _, _ = scan_bwd_parts(op)
    kernels = traced_kernels(lambda: kernel(*args, **kw))
    return {"passes_ms": kernel_totals(kernels),
            "recompute_inside": overlap_share(kernels, RECOMPUTE_KERNEL,
                                              BWD_PASS_KERNEL),
            "reverse_inside": overlap_share(kernels, r"_bwd_reverse_kernel",
                                            r"_bwd_intra_kernel")}


def print_schedule(f: dict, seg_bytes: int, whole_ds_bytes: int) -> None:
    """The figures of `scan_bwd_schedule` and the scratch of a backward
    from the checkpoints (``f``), beside its state and dS buffers (two
    segments' of each, ``seg_bytes`` a segment's) and the whole-state
    backward's dS."""
    print("      passes (profiler, device ms a call): " + ", ".join(
        f"{k} {v:.4f}" for k, v in f["passes_ms"].items())
        + f"; the recompute's kernel time inside a chunk or reverse pass "
        f"{f['recompute_inside']:.3f}, the reverse passes' inside a chunk "
        f"pass {f['reverse_inside']:.3f}; scratch {f['scratch_bytes']} B, "
        f"of it the states and dS {4 * seg_bytes} B (two segments' each: "
        f"{4 * seg_bytes / whole_ds_bytes:.3f} of the whole-state dS, "
        f"{whole_ds_bytes} B)")


def on_side_stream(fn):
    """``fn()`` issued under a new, non-default stream that first waits for
    the current stream's work; the current stream then waits for it."""
    import torch

    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


def bwd_scratch(fn) -> tuple[tuple, int]:
    """``fn()``'s outputs and the device bytes it held beyond them at its
    peak (``max_memory_allocated`` above the bytes allocated before it,
    less its outputs'): a backward's scratch."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for t in out if t is not None)
    return out, torch.cuda.max_memory_allocated() - base - held


def phase_scan_bwd(dev) -> dict:
    """Phase 23b: both backward kernels against their plain versions
    (autograd through the plain forwards) on the card: WKV6 at rwkv6-3b's
    40 heads of 64, SSD at zamba2-7b's 112 heads of 64 with a state of 64;
    S = 61 (ragged: every state kept), 512 (2 segments of 16 chunks) and
    4,096 (the training shape, 16 segments), without s0 and dsT and with
    both, batch 2; float32 and bf16; then strong decays (log_w down to
    -50, dt up to 20) at 512.  Each call's forward gives the same bits
    with every state kept, with every 16th (the checkpoints: the
    whole-state run's states at every 16th chunk) and with none; where
    the checkpoints apply, the backward from them (each segment's states
    recomputed beside its reverse pass) is the backward from every state
    bit for bit, on the current stream and under another, and it is the
    one held against the plain version; the saved state bytes and each
    backward's scratch (device bytes beyond its outputs at its peak)
    printed for both, with its passes' device ms and their overlap
    (`scan_bwd_schedule`).  Device times from CUDA events; at 4,096 tokens
    each pass's device time from the profiler, its launches a call exact
    (`scan_bwd_pass_ms`), bf16 beside float32, and the bf16 call no slower
    than the float32 one.  Returns, per backward, the bf16 figures at
    4,096 tokens without s0 (rows 5c / 6c at batch 2) with the
    whole-state call's device ms, saved bytes and scratch beside them."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd_bwd_cuda, ssd_cuda
    from repro_torch.kernels.wkv6 import (kept_stride, wkv6_bwd_cuda,
                                          wkv6_cuda)

    gen = torch.Generator(device=dev).manual_seed(1010)

    def normal(shape, dtype=torch.float32, scale=1.0):
        """Drawn on the card: the 4,096-token cases hold ~60 M values."""
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    rw, zb = get_config(RWKV), get_config(ZAMBA)
    h, dk = rw.ssm_heads, rw.ssm_state
    zh, ds = zb.ssm_heads, zb.ssm_state
    hd = 2 * zb.d_model // zh
    b = SCAN_BWD_BATCH
    cases = [(dtype, s, stored, False) for dtype in (torch.float32,
                                                      torch.bfloat16)
             for s in SCAN_BWD_LENGTHS for stored in (False, True)]
    cases += [(dtype, 512, True, True) for dtype in (torch.float32,
                                                      torch.bfloat16)]
    passes = {}   # (op, dtype) -> (ms per pass, the call's device ms)
    rows = {}

    def one(op, label, fwd, kernel, bwd, dout, dst, stored, shape):
        """A forward's three runs, the backward from every state and from
        the checkpoints, the figures of the one a training step runs."""
        out, s_t, every = kernel(*fwd, return_states=True)
        out0, s_t0 = kernel(*fwd)
        check(torch.equal(out, out0) and torch.equal(s_t, s_t0),
              f"{op} {label}: the output changed with return_states")
        stride = kept_stride(every.shape[2])
        n_in = len(fwd) - 1
        kw = {"want_ds0": stored}
        whole_args = (*fwd[:n_in], every, dout, dst)
        if stride == 1:
            f = scan_bwd_figures(f"{op}_bwd", whole_args, kw, profile=False)
            print_figures(f"{op}_bwd {label}", shape, f)
            return f, whole_args, None
        out1, s_t1, ckpt = kernel(*fwd, return_states=True,
                                  keep_every=stride)
        check(torch.equal(out, out1) and torch.equal(s_t, s_t1)
              and torch.equal(ckpt, every[:, :, ::stride]),
              f"{op} {label}: the checkpoints are not the whole run's "
              "states at every 16th chunk, or the output changed")
        del out, out0, out1, s_t, s_t0, s_t1
        args = (*fwd[:n_in], ckpt, dout, dst)
        whole, whole_scr = bwd_scratch(lambda: bwd(*whole_args, **kw))
        got, scr = bwd_scratch(lambda: bwd(*args, **kw))
        side = on_side_stream(lambda: bwd(*args, **kw))
        check(all((g is None and w is None) or
                  (torch.equal(g, w) and torch.equal(o, w))
                  for g, o, w in zip(got, side, whole)),
              f"{op}_bwd {label}: the checkpointed backward (on the current "
              "stream or another) is not the whole-state one bit for bit")
        del got, side, whole
        f = scan_bwd_figures(f"{op}_bwd", args, kw, profile=False)
        f["whole_device_ms"] = queued_event_ms(
            [lambda: bwd(*whole_args, **kw)] * 10) / 10
        f["saved_state_bytes"] = 4 * ckpt.numel()
        f["whole_saved_state_bytes"] = 4 * every.numel()
        f["scratch_bytes"], f["whole_scratch_bytes"] = scr, whole_scr
        f.update(scan_bwd_schedule(f"{op}_bwd", args, kw))
        print_figures(f"{op}_bwd {label}, from the checkpoints", shape, f)
        print(f"      saved state bytes a call {f['saved_state_bytes']} "
              f"(every state: {f['whole_saved_state_bytes']}); the "
              f"backward's scratch {scr} B (from every state: {whole_scr} "
              f"B); the whole-state call {f['whole_device_ms']:.4f} ms "
              f"(events); {card_line()}")
        print_schedule(f, f["saved_state_bytes"] // ckpt.shape[2] * stride,
                       f["whole_saved_state_bytes"])
        return f, args, whole_args

    for dtype, s, stored, strong in cases:
        label = (f"{str(dtype).removeprefix('torch.')} S={s} "
                 f"{'s0, dsT' if stored else 'no s0 / dsT'}"
                 f"{', strong decays' if strong else ''}")
        raw = normal((b, s, h, dk))
        lw = (torch.clamp(-torch.exp(raw * 2.0 + 1.0), -50.0, -1e-3)
              if strong else torch.clamp(-torch.exp(raw), -4.0, -1e-3))
        fwd = (normal((b, s, h, dk), dtype), normal((b, s, h, dk), dtype),
               normal((b, s, h, dk), dtype), lw,
               normal((h, dk)), normal((b, h, dk, dk)) if stored else None)
        f, args, _ = one("wkv6", label, fwd, wkv6_cuda, wkv6_bwd_cuda,
                         normal((b, s, h, dk), dtype),
                         normal((b, h, dk, dk)) if stored else None, stored,
                         (b, s, h, dk))
        if s == 4096:
            passes["wkv6_bwd", dtype] = (scan_bwd_pass_ms(
                "wkv6_bwd", args, {"want_ds0": stored}), f["device_ms"])
            if dtype == torch.bfloat16 and not stored:
                rows["wkv6_bwd"] = f
        del args, fwd, raw, lw
        torch.cuda.empty_cache()

        dt = (torch.clamp(normal((b, s, zh)).abs() * 10.0, max=20.0)
              if strong else normal((b, s, zh)).abs() * 0.5)
        fwd = (normal((b, s, zh, hd), dtype, 0.05 if strong else 1.0),
               normal((b, s, ds), dtype), normal((b, s, ds), dtype),
               dt, normal((zh,), scale=0.3), normal((zh,)),
               normal((b, zh, hd, ds)) if stored else None)
        f, args, _ = one("ssd", label, fwd, ssd_cuda, ssd_bwd_cuda,
                         normal((b, s, zh, hd), dtype),
                         normal((b, zh, hd, ds)) if stored else None, stored,
                         (b, s, zh, hd, ds))
        if s == 4096:
            passes["ssd_bwd", dtype] = (scan_bwd_pass_ms(
                "ssd_bwd", args, {"want_ds0": stored}), f["device_ms"])
            if dtype == torch.bfloat16 and not stored:
                rows["ssd_bwd"] = f
        del args, fwd, dt
        torch.cuda.empty_cache()
    for op in ("wkv6_bwd", "ssd_bwd"):
        if len([k for k in passes if k[0] == op]) < 2:
            continue    # SCAN_BWD_LENGTHS cut below 4,096
        (f32, f32_ms), (bf, bf_ms) = (passes[op, torch.float32],
                                      passes[op, torch.bfloat16])
        shown = ", ".join(
            f"{k} {f32.get(k, float('nan')):.4f} / {bf.get(k, float('nan')):.4f}"
            for k in OP_KERNELS[f"{op}_checkpointed"])
        print(f"    {op} at S=4096, batch {b}, from the checkpoints, device "
              f"ms per call of each pass (profiler), float32 / bf16: "
              f"{shown}; the call (events) {f32_ms:.4f} / {bf_ms:.4f}")
        check(bf_ms <= f32_ms, f"{op}: the bf16 call ({bf_ms:.4f} ms) is "
              f"slower than the float32 one ({f32_ms:.4f} ms) at 4,096 tokens")
    return rows


# -------------------------------------------- recurrent engines, 11-14 --
def serve_mode(res) -> str:
    """A recurrent engine's mode from its cache accounting: fresh (no hit),
    no-op (the whole stored prompt again), or extend."""
    if res.n_hit == 0:
        return "fresh"
    return "no-op" if res.n_hit == res.n_prompt else "extend"


def recurrent_gates(cfg, counts, fresh, extends, steps, noops) -> None:
    """The launches a recurrent engine's main path must make: WKV6 once per
    layer per fresh prefill or extend with new tokens (rwkv); SSD once per
    Mamba-2 layer per fresh prefill, flash attention once per group per
    fresh prefill and decode attention once per group per decode or no-op
    step (zamba); nothing else."""
    if cfg.ssm_kind == "rwkv6":
        want = {"wkv6": cfg.n_layers * (fresh + extends), "ssd": 0,
                "flash_attention": 0, "decode_attention": 0}
    else:
        groups = cfg.n_layers // cfg.attn_every
        want = {"wkv6": 0, "ssd": cfg.n_layers * fresh,
                "flash_attention": groups * fresh,
                "decode_attention": groups * (steps + noops)}
    got = {k: counts[k] for k in want}
    check(got == want, f"{cfg.name}: launches {got}, expected {want} for "
          f"{fresh} fresh prefills, {extends} extends, {steps} decode and "
          f"{noops} no-op steps")


def phase_recurrent_lockstep(dev) -> None:
    """A CUDA and a CPU engine on the same weights (full width, cut depth,
    float32) serve the CPU engine tests' plans in lockstep: rwkv6-3b at 2
    layers (fresh, exact extension, the no-op repeat, a non-extension, LRU
    evictions at cache_slots=1); zamba2-7b at 3 layers with attn_every=2
    (one group of two Mamba-2 layers, the shared block, a tail of one:
    fresh, repeat, non-extension, and an exact extension that raises in
    both, as the reference's does)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import AgentEngine

    rng = np.random.default_rng(11)
    new = lambda n: rng.integers(1, 250, n).astype(np.int32)  # noqa: E731
    build = {"fresh": lambda src: new(40),
             "extend": lambda src: np.concatenate([src, new(9)]),
             "repeat": lambda src: src,
             "other": lambda src: np.concatenate([src[:20], new(7)])}
    cases = [
        (dataclasses.replace(get_config(RWKV), n_layers=2, dtype="float32"),
         1, [("a", "fresh"), ("a", "extend"), ("a", "repeat"),
             ("a", "other"), ("a", "extend"), ("b", "fresh"),
             ("a", "extend")]),
        (dataclasses.replace(get_config(ZAMBA), n_layers=3, attn_every=2,
                             dtype="float32"),
         2, [("a", "fresh"), ("a", "repeat"), ("a", "other"), ("b", "fresh"),
             ("a", "repeat"), ("a", "extend")]),
    ]
    for cfg, slots, plan in cases:
        kw = {"max_len": MAX_LEN, "max_new_tokens": 4, "cache_slots": slots}
        gpu = AgentEngine(cfg, seed=11, device=dev, **kw)
        cpu = AgentEngine(cfg, device="cpu",
                          params=copy.deepcopy(gpu.params).cpu(), **kw)
        stored, modes, worst, raised = {}, [], 0.0, 0
        launched = Counter()
        for i, (did, how) in enumerate(plan):
            prompt = build[how](stored.get(did))
            before = ops.launch_counts()
            try:
                a = gpu.serve(did, prompt, now=float(i))
            except NotImplementedError:
                a = None
            launched.update({k: v - before[k]
                             for k, v in ops.launch_counts().items()})
            try:
                b = cpu.serve(did, prompt, now=float(i))
            except NotImplementedError:
                b = None
            check((a is None) == (b is None), f"{cfg.name}: only one engine "
                  f"raised at step {i}")
            if a is None:
                check(cfg.attn_every and how == "extend", f"{cfg.name}: "
                      f"step {i} ({how}) raised")
                raised += 1
                continue
            check(np.array_equal(a.output_tokens, b.output_tokens)
                  and (a.n_hit, a.n_prompt) == (b.n_hit, b.n_prompt),
                  f"{cfg.name}: CUDA and CPU engines diverged at step {i}: "
                  f"{a.output_tokens} / {b.output_tokens}, hits {a.n_hit} / "
                  f"{b.n_hit}")
            err = rel_logit_err(session_logits(gpu, did),
                                session_logits(cpu, did))
            check(err < ENGINE_LOGIT_TOL, f"{cfg.name}: last-token logits "
                  f"differ by {err} at step {i}")
            worst = max(worst, err)
            modes.append(serve_mode(a))
            stored[did] = gpu.sessions[did].prompt
        check(gpu.evictions == cpu.evictions, "eviction counts differ")
        want_modes = ({"fresh", "extend", "no-op"} if cfg.ssm_kind == "rwkv6"
                      else {"fresh", "no-op"})
        check(set(modes) == want_modes, f"{cfg.name}: modes {modes}")
        steps = kw["max_new_tokens"] * len(modes)
        recurrent_gates(cfg, launched, modes.count("fresh"),
                        modes.count("extend"), steps, modes.count("no-op"))
        print(f"    {cfg.name} ({cfg.n_layers} layers): modes {modes}"
              f"{', 1 exact extension raised in both' if raised else ''}, "
              f"evictions {gpu.evictions}: identical tokens and cache hits, "
              f"last-token logits within {worst:.2e} of their max (limit "
              f"{ENGINE_LOGIT_TOL}); launches {dict(launched)}")
        del gpu, cpu
        gc.collect()


def rwkv_requests():
    """phase 8's multi-turn plan: each later turn extends the stored prompt
    (previous prompt + answer + the new turn), then the repeat of a stored
    prompt (the no-op)."""
    return [(script.dialogue_id, t, True) for script, t in slice_requests()]


def zamba_requests():
    """What the reference serves for zamba2: first turns, repeats of the
    stored prompt (no-op), and later turns whose prompt omits the answer
    (not an exact extension, so a fresh prefill)."""
    plan = slice_requests()
    first = [(script.dialogue_id, 0, True) for script, t in plan if t == 0]
    (d0, _, _), (d1, _, _), (d2, _, _) = first
    return [first[0], first[1], (d0, None, True), first[2], (d0, 1, False),
            (d1, None, True), (d2, 1, False), (d2, None, True)]


def phase_recurrent_slice(dev, arch: str, seed: int, requests, record):
    """One full-width bf16 engine of a recurrent family serves
    ``requests`` ((dialogue, turn or None for the repeat, whether the
    prompt carries the previous answers)); returns the engine, the launch
    counts of the run and the recorded calls of the ``record`` ops."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import AgentEngine

    cfg = get_config(arch)
    scripts = {s.dialogue_id: s for s, _ in slice_requests()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = AgentEngine(cfg, seed=seed, device=dev, max_len=MAX_LEN,
                         max_new_tokens=8, cache_slots=12)
    torch.cuda.synchronize()
    print(f"    {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.ssm_heads} {cfg.ssm_kind} heads, state {cfg.ssm_state}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; "
          f"{sum(p.numel() for p in engine.params.parameters()) / 1e9:.3f} B "
          f"parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    # zamba2 cannot extend (the reference's gap): warm prefills only
    engine.warmup(extend_buckets=() if cfg.attn_every else (16, 32, 64))
    history, rows = {}, []
    with recording(ops, record, per_shape=2) as rec:
        ops.reset_launch_counts()          # the engine's main path starts
        for i, (did, t, answers) in enumerate(requests):
            turns = scripts[did].turns
            if t is None:
                prompt = engine.sessions[did].prompt
            elif answers:
                prompt = np.concatenate([history.get(did, np.zeros(
                    0, np.int32)), turns[t]]).astype(np.int32)
            else:
                prompt = np.concatenate(turns[:t + 1]).astype(np.int32)
            check(len(prompt) + engine.max_new <= MAX_LEN,
                  "a dialogue outgrew max_len")
            res = engine.serve(did, prompt, now=float(i))
            rows.append((serve_mode(res), res))
            history[did] = np.concatenate([prompt, res.output_tokens])
        counts = ops.launch_counts()       # ... and ends here
    modes = [m for m, _ in rows]
    steps = sum(r.n_gen for _, r in rows)
    recurrent_gates(cfg, counts, modes.count("fresh"), modes.count("extend"),
                    steps, modes.count("no-op"))
    print_modes(rows, ("fresh", "extend", "no-op") if cfg.ssm_kind == "rwkv6"
                else ("fresh", "no-op"))
    # what comes out: finite logits of the right shape, and the greedy
    # token of a direct exact-length prefill equals the engine's first
    did, t, _ = requests[0]
    batch = {"tokens": torch.from_numpy(np.asarray(
        scripts[did].turns[t], np.int32)[None]).to(dev), "max_len": MAX_LEN}
    with torch.no_grad():
        logits, _ = engine.model.prefill(engine.params, batch)
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits are not "
          "finite values of shape [1, vocab]")
    check(int(logits.argmax(-1)[0]) == int(rows[0][1].output_tokens[0]),
          "a direct prefill's greedy token differs from the engine's")
    print(f"    launches {counts} for modes {modes} and {steps} decode "
          f"steps; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    cache = engine.sessions[did].cache
    tok = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for what, fn, n in (
                (f"prefill of {batch['tokens'].shape[1]} tokens",
                 lambda: engine.model.prefill(engine.params, batch), 2),
                ("decode step", lambda: engine.model.decode_step(
                    engine.params, cache, tok), 8)):
            print(f"    {what}: " + device_share(fn, n))
    return engine, counts, rec


def phase_mixed_fleet(dev, qwen_engine, rwkv_engine) -> None:
    """The CUDA router over a mixed fleet: phase 8's qwen3-8b engine and
    phase 12's rwkv6-3b engine, with ``AgentInfo.recurrent`` taken from
    each engine (as the reference's cluster does), so the exact-extension
    mask reaches the Eq.-4 affinity on the card; two dialogues, two turns
    each, turn 2 extending turn 1's prompt and answer."""
    import numpy as np
    import torch

    from repro_torch.configs.iemas_cluster import (RouterConfig, agent_infos,
                                                   agent_profiles,
                                                   make_router)
    from repro_torch.core.mechanism import CompletionObs, Request

    profiles = agent_profiles(2)
    engines = dict(zip((p.agent_id for p in profiles),
                       (rwkv_engine, qwen_engine)))
    for prof in profiles:
        engine = engines[prof.agent_id]
        engine.sessions.clear()
        engine.speed = prof.speed
        engine.cache_slots = prof.cache_slots
    infos = [dataclasses.replace(i, recurrent=engines[i.agent_id].recurrent)
             for i in agent_infos(profiles)]
    check([i.recurrent for i in infos] == [True, False],
          "the fleet is not one attention and one recurrent agent")
    router = make_router(infos, RouterConfig(), device=dev,
                         predictor_kw={"warm_n": 2})
    rng = np.random.default_rng(14)
    dialogues = {f"mixed-{j}": rng.integers(1, 250, n).astype(np.int32)
                 for j, n in enumerate((48, 72))}
    first, served = {}, 0
    for turn in (0, 1):
        reqs = [Request(f"m{turn}-{did}", did, toks, turn=turn,
                        domain="dialogue", max_new_tokens=8)
                for did, toks in dialogues.items()]
        decisions = router.route_batch(reqs, {})
        check(all(d.agent_id is not None for d in decisions),
              f"turn {turn + 1}: a request was not matched")
        for d in decisions:
            req = d.request
            engine = engines[d.agent_id]
            aff = {aid: router.ledger.affinity(
                aid, req.dialogue_id, req.tokens,
                extension_only=engines[aid].recurrent) for aid in engines}
            res = engine.serve(req.dialogue_id, req.tokens)
            served += 1
            check(bool(torch.isfinite(session_logits(
                engine, req.dialogue_id)).all()), "logits are not finite")
            router.on_complete(req.request_id, CompletionObs(
                res.ttft, res.n_prompt, res.n_hit, res.n_gen, 0.7))
            kind = "rwkv6-3b" if engine.recurrent else "qwen3-8b"
            if turn == 0:
                first[req.dialogue_id] = d.agent_id
                dialogues[req.dialogue_id] = np.concatenate(
                    [req.tokens, res.output_tokens,
                     rng.integers(1, 250, 8).astype(np.int32)])
            elif d.agent_id == first[req.dialogue_id] and engine.recurrent:
                check(res.n_hit > 0, f"turn 2 of {req.dialogue_id} returned "
                      "to the rwkv agent as an exact extension but missed "
                      "the cache")
            print(f"    turn {turn + 1} {req.dialogue_id} -> {d.agent_id} "
                  f"({kind}), affinities o_ij " + ", ".join(
                      f"{a} {v:.3f}" for a, v in aff.items())
                  + f", TTFT {res.ttft * 1e3:.1f} ms, hit "
                  f"{res.n_hit}/{res.n_prompt}")
    check(served == 4, "not every request was served")
    print(f"    accounts {dict(router.accounts)}")


# ----------------------------------------------------- fused router, 15 --
PAY_TOL = 1e-5       # tests/test_routing_fused.py's two-tier gate
EST_TOL = 1e-4
# what PyTorch's sync debug mode says of a synchronizing call (a warning in
# "warn" mode, the error's message in "error" mode)
SYNC_WARNING = "called a synchronizing CUDA operation"


def gate_tier(staged, fused, batch: int) -> int:
    """tests/test_routing_fused.py's two-tier gate of the fused decisions
    against the staged ones: 1 when the assignments are identical (then
    payments within PAY_TOL, estimates within EST_TOL), 2 when they differ
    but the total welfare is within the auction's ε-optimality gap; fails
    otherwise."""
    a_s = [d.agent_id for d in staged]
    a_f = [d.agent_id for d in fused]
    w_s = sum(d.welfare_weight for d in staged)
    w_f = sum(d.welfare_weight for d in fused)
    if a_f != a_s:
        check(abs(w_f - w_s) <= 1e-5 * max(1.0, abs(w_s)),
              f"batch {batch}: fused welfare {w_f} vs staged {w_s} beyond "
              "the ε-optimality gap")
        return 2
    for s, f in zip(staged, fused):
        check(abs(s.payment - f.payment) < PAY_TOL,
              f"batch {batch}: payment {f.payment} vs {s.payment}")
        if s.agent_id:
            for k in ("latency", "cost", "quality"):
                check(abs(getattr(s.estimate, k) - getattr(f.estimate, k))
                      < EST_TOL, f"batch {batch}: estimate {k} differs")
    return 1


@contextmanager
def recording_fused(ops):
    """Keep copies of the inputs of every card call of ``fused_phase1_op``
    and ``auction_fused_op`` (the step's buffers and the ledger arena are
    reused from batch to batch, and the fused solve writes into its
    buffer), each ``fused_phase1`` call with the inputs of the
    ``lcp_gather_op`` call whose output is its ``lcp`` (None if there is
    none; a staged router's gathers are left out, phase 5 replays those);
    the calls go on unchanged."""
    import torch

    phase1, fused, gather = (ops.fused_phase1_op, ops.auction_fused_op,
                             ops.lcp_gather_op)
    calls = {"fused_phase1": [], "auction_fused": []}
    last = {}

    def rec_gather(prompts, arena, rows):
        out = gather(prompts, arena, rows)
        if out.is_cuda:
            last.update(out=out, args=(prompts, arena, rows))
        return out

    def rec_phase1(args, out, lay):
        if out.is_cuda:
            g = None
            if last.get("out") is args.lcp:
                g = tuple(t.clone() for t in last["args"])
            calls["fused_phase1"].append((args.map(torch.clone), lay, g))
        return phase1(args, out, lay)

    def rec_fused(out, counts, p0, lay, **kw):
        if out.is_cuda:
            calls["auction_fused"].append(
                ((out.clone(), counts.clone(), p0.clone(), lay), kw))
        return fused(out, counts, p0, lay, **kw)

    ops.fused_phase1_op, ops.auction_fused_op, ops.lcp_gather_op = (
        rec_phase1, rec_fused, rec_gather)
    try:
        yield calls
    finally:
        ops.fused_phase1_op, ops.auction_fused_op, ops.lcp_gather_op = (
            phase1, fused, gather)


def keep_rounds(router, sink: list, starts: Counter | None = None) -> None:
    """Append the rounds of each of ``router``'s fused solves to ``sink``
    and count its warm starts and their trips into the cold re-solve in
    ``starts`` (from the packaged result the step returns: no extra device
    read)."""
    step = router._fused.step

    def wrapped(*args, **kw):
        out = step(*args, **kw)
        stats = out[5].solver_stats
        sink.append(stats.get("rounds"))
        if starts is not None:
            starts["warm"] += bool(stats.get("warm_started"))
            starts["tripped"] += bool(stats.get("warm_fallback"))
        return out

    router._fused.step = wrapped


@contextmanager
def guarding_syncs(router, ops):
    """Measure the device syncs of every step of ``router``'s fused step on
    the card.  From the step's first launch (``lcp_gather``) until its
    fused solve returns, PyTorch's sync debug mode is "error", so any
    synchronizing call there raises and fails the phase; from then until
    the step returns it is "warn", and the synchronizing calls there (the
    step's one device-to-host copy) are counted.  Yields a Counter of
    ``steps`` and ``tail_syncs``; the blocking uploads before the first
    launch are not counted."""
    import warnings

    import torch

    step = router._fused.step
    tally = Counter()

    def guarded(*args, **kw):
        gather, fused = ops.lcp_gather_op, ops.auction_fused_op

        def first(*a):
            torch.cuda.set_sync_debug_mode("error")
            return gather(*a)

        def last(*a, **k):
            out = fused(*a, **k)
            torch.cuda.set_sync_debug_mode("warn")
            return out

        ops.lcp_gather_op, ops.auction_fused_op = first, last
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                out = step(*args, **kw)
        except RuntimeError as e:
            check(SYNC_WARNING not in str(e), f"a fused step synced between "
                  f"its launches: {e}")
            raise
        finally:
            torch.cuda.set_sync_debug_mode("default")
            ops.lcp_gather_op, ops.auction_fused_op = gather, fused
        tally["steps"] += 1
        tally["tail_syncs"] += sum(SYNC_WARNING in str(w.message)
                                   for w in seen)
        return out

    router._fused.step = guarded
    try:
        yield tally
    finally:
        router._fused.step = step


def profiled_copies(router, loop, steps: int,
                    tries: int) -> list[tuple[int, int, int]]:
    """Route more batches of ``loop`` through ``router`` alone, each fused
    step inside its own ``torch.profiler`` trace (after an empty trace that
    takes late records of earlier work), until ``steps`` traces hold kernel
    records, ``tries`` steps were traced or the loop runs dry (late in a
    long run the profiler sometimes drops a whole trace's records); returns
    each trace's (device-to-host copies, host-to-device copies, kernel
    records)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = router._fused.step
    seen = []

    def traced(*args, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prime_trace()
            # idle margins inside the trace window: device records whose
            # converted timestamps fall a little outside it are kept
            time.sleep(TRACE_MARGIN_S)
            out = step(*args, **kw)
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
        d2h = h2d = kernels = 0
        for e in prof.key_averages():
            if e.key.startswith("Memcpy DtoH"):
                d2h += e.count
            elif e.key.startswith("Memcpy HtoD"):
                h2d += e.count
            elif e.device_type == DeviceType.CUDA and e.count \
                    and not e.key.startswith("Mem") \
                    and "spin_kernel" not in e.key:
                kernels += e.count
        seen.append((d2h, h2d, kernels))
        return out

    router._fused.step = traced
    try:
        while len(seen) < tries and sum(k > 0 for *_, k in seen) < steps:
            reqs = loop.next_batch()
            if not reqs:
                break
            got = router.route_batch(reqs, {"router_inflight": len(reqs),
                                            "router_rps": 2.0})
            loop.complete(got, [router])
    finally:
        router._fused.step = step
    return seen


def phase1_work(args, lay) -> tuple[int, int]:
    """(bytes, operations) one ``fused_phase1`` call must move and do:
    every input array read once (the arena lengths only at the pairs' rows,
    each forest's node pool whole), the outputs (lat, cst, qual, values, W,
    the 10 features, wmax) written once; ~110 float32 operations a pair
    (Eq. 4, the features, the prior blend, Eq. 1; the descents' compares
    counted as one a level)."""
    pairs = args.nb * args.mb
    rows = args.lcp.shape[0] * args.mb
    # lcp, rows and alen at the rows; keep and dom; ckeep; plen, turns and
    # req_mask; cj; ext, agent_mask, counts, inflight, rps and caps; the
    # router scalars; blend; val_cfg
    nbytes = 4 * (3 * rows + 2 * pairs + args.cb * args.mb + 3 * args.nb
                  + args.cb + 6 * args.mb + 2 + args.blend.numel() + 3)
    for fo in args.forests:
        nbytes += 4 * (5 * fo.feature.numel() + fo.roots.numel())
    nbytes += 4 * (15 * pairs + 1)
    depth = sum(fo.depth for fo in args.forests)
    return nbytes, pairs * (110 + depth)


def fused_router_small(dev):
    """tests/test_routing_fused.py's heterogeneous 5-agent fleet (a
    recurrent agent, an LRU-capped one) as a fused router on ``dev``, with
    the optimism bonus on two agents."""
    from repro_torch.core.mechanism import AgentInfo, IEMASRouter
    from repro_torch.core.pricing import TokenPrices

    agents = [AgentInfo(f"a{i}", TokenPrices(0.01 * (1 + i / 5),
                                             0.001 * (1 + i / 5),
                                             0.03 * (1 + i / 5)), 2,
                        ("dialogue",) if i % 2 == 0
                        else ("dialogue", "reasoning"), scale=4.0 + i,
                        recurrent=(i == 3), cache_slots=2 if i == 1 else 0)
              for i in range(5)]
    r = IEMASRouter(agents, solver="cuda", n_hubs=1, fused=True,
                    warm_start=True, device=dev)
    for aid in ("a0", "a2"):
        r.pool[aid].explore = 0.05
    return r


def small_batch(n, t, parents):
    import numpy as np

    from repro_torch.core.mechanism import Request

    rng = np.random.default_rng(1000 + t)
    return [Request(f"s{t}_{j}", f"d{j % 4}",
                    rng.integers(0, 50, int(rng.integers(5, 30))), turn=t,
                    domain="dialogue" if j % 2 == 0 else "reasoning",
                    meta={"parent_sessions": (f"d{(j + 1) % 4}",
                                              f"d{(j + 2) % 4}")}
                    if parents and j % 3 == 1 else {})
            for j in range(n)]


def phase1_synthetic(dev, ops) -> None:
    """``fused_phase1`` against its plain version on the 5-agent fleet's
    calls: cold agents, then trained trees (split), recurrent and
    LRU-capped agents, the optimism bonus, parents, padded rows and
    agents."""
    import numpy as np
    import torch

    from repro_torch.core.predictor import PredictorInput
    from repro_torch.kernels.routing_fused import (fused_phase1_cuda,
                                                   fused_phase1_plain)

    r = fused_router_small(dev)
    tel = {"router_inflight": 2, "router_rps": 1.0,
           "agent_inflight": {"a0": 1}, "agent_rps": {"a1": 0.5}}
    rng = np.random.default_rng(4)
    with recording_fused(ops) as calls:
        r.route_batch(small_batch(3, 0, False), dict(tel))
        for k in range(700):
            x = rng.uniform(0, 1, 10) * np.array([30, 4, 1, 3, 2, 2, 1, 2,
                                                  1, 1])
            r.pool[f"a{k % 5}"].update(PredictorInput(*x),
                                       0.02 + 0.3 * (x[0] > 15),
                                       0.01 + 2.0 * (x[2] > 0.5),
                                       float(x[9] > 0.5))
        for k in range(12):
            r.ledger.update(f"a{k % 5}", f"d{k % 4}",
                            rng.integers(0, 50, int(rng.integers(5, 30))))
        r.route_batch(small_batch(6, 1, True), dict(tel))
        r.route_batch(small_batch(5, 2, False), dict(tel))
    check(r.pool["a0"].lat.compiled().depth >= 1, "the trees did not split")
    got_parents = False
    for args, lay, _ in calls["fused_phase1"]:
        got = fused_phase1_cuda(args, torch.zeros(lay.total, device=dev),
                                lay)
        want = fused_phase1_plain(args.map(lambda t: t.cpu()),
                                  torch.zeros(lay.total), lay)
        check(exact_diff(got.cpu(), want) == 0.0,
              f"fused_phase1 kernel != plain at (nb, mb, cb) = "
              f"({args.nb}, {args.mb}, {args.cb})")
        got_parents |= args.cb > 0
    check(got_parents, "no synthetic fused_phase1 call had parents")
    print(f"    fused_phase1 on the 5-agent fleet: {len(calls['fused_phase1'])}"
          " calls (cold, trained trees, recurrent and LRU-capped agents, "
          "explore 0.05 on two agents, parents, padded rows and agents): "
          "bit-exact")


def fused_solve_synthetic(dev) -> None:
    """The fused mode against its plain version at the one-hub padded
    shape (64 x 128, 16 unit columns): cold, warm, and a warm budget of 5
    that trips into the cold re-solve in the same launch; and a (256, 512)
    market whose W does not fit in shared memory."""
    import numpy as np
    import torch

    from repro_torch.core.solvers.dense_common import THETA
    from repro_torch.kernels.auction_bid import (auction_fused_cuda,
                                                 auction_fused_plain,
                                                 auction_solve_plan)
    from repro_torch.kernels.routing_fused import packed_layout

    rng = np.random.default_rng(6)
    for case, (nb, mb, cbu) in (("cold", (64, N_AGENTS, 16)),
                                ("warm", (64, N_AGENTS, 16)),
                                ("tripped", (64, N_AGENTS, 16)),
                                ("W past shared memory", (256, 512, 4))):
        n, m = nb * 25 // 32, mb * 25 // 32
        W = np.zeros((nb, mb), np.float32)
        W[:n, :m] = rng.uniform(0, 4, (n, m)) * (rng.random((n, m)) > 0.3)
        counts = np.zeros(mb, np.int32)
        counts[:m] = rng.integers(0, cbu + 1, m)
        lay = packed_layout(nb, mb, cbu)
        grid = np.zeros((mb, cbu), np.float32)
        warm = case in ("warm", "tripped")
        if warm:
            grid[:m] = rng.uniform(0, 2, (m, cbu))
        out = torch.zeros(lay.total)
        out[0] = float(W[:, counts > 0].max())
        out[lay.W:lay.W + nb * mb] = torch.from_numpy(W.ravel())
        kw = dict(budget=5 if case == "tripped" else 10_000,
                  max_rounds=200_000, warm=warm, theta=THETA)
        t = time.perf_counter()
        want = auction_fused_plain(out.clone(), torch.from_numpy(counts),
                                   torch.from_numpy(grid.ravel()), lay, **kw)
        plain_ms = (time.perf_counter() - t) * 1e3
        args = (out.to(dev), torch.from_numpy(counts).to(dev),
                torch.from_numpy(grid.ravel()).to(dev), lay)
        got = auction_fused_cuda(*args, **kw)
        check(exact_diff(got.cpu().view(torch.int32),
                         want.view(torch.int32)) == 0.0,
              f"auction_fused kernel != plain ({case})")
        ints = want.view(torch.int32)
        check(bool(ints[2]) == (case == "tripped"),
              f"the trip flag is wrong ({case})")
        shared_w, smem = auction_solve_plan(np.array([[nb, mb, cbu]]))
        check(shared_w == (case != "W past shared memory"),
              f"W in the wrong memory ({case})")
        ms = cuda_time_ms(lambda: auction_fused_cuda(*args, **kw), 5, 1)
        print(f"    auction_fused ({nb}, {mb}, cbu {cbu}) {case}: bit-exact "
              f"(prices, assignment, rounds {int(ints[1])}, tripped "
              f"{bool(ints[2])}), kernel {ms:.4f} ms, plain (host) "
              f"{plain_ms:.1f} ms; W in {'shared' if shared_w else 'global'}"
              f" memory, {smem} B dynamic smem")


def replay_fused_calls(calls, dev) -> dict:
    """Every recorded main-path call of the two fused kernels once through
    the kernel and, on host copies, through its plain version, bit for bit;
    then each kernel timed over the recorded sequence.  Each step's gather
    (the request and parent-candidate rows) is held against its plain
    version too, and the plain Phase-1 replay takes the plain gather's LCP,
    so the plain chain does not lean on the card.  The plain replay of
    the fused solves keeps its forward-bidding rounds, whose active rows
    count the bound's operations."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.auction_bid import (auction_fused_cuda,
                                                 auction_fused_plain)
    from repro_torch.kernels.lcp_affinity import (lcp_gather_cuda,
                                                  lcp_gather_plain)
    from repro_torch.kernels.routing_fused import (fused_phase1_cuda,
                                                   fused_phase1_plain)

    p1 = calls["fused_phase1"]
    check(bool(p1), "no fused_phase1 call was recorded on the main path")
    err, gerr, nbytes, nops, plain_s = 0.0, 0.0, 0, 0, 0.0
    outs = []
    for args, lay, gathered in p1:
        check(gathered is not None, "a fused step's fused_phase1 did not "
              "take the LCP of the step's lcp_gather")
        host_in = tuple(t.cpu() for t in gathered)
        lcp = lcp_gather_plain(*host_in)
        gerr = max(gerr, exact_diff(lcp_gather_cuda(*gathered).cpu(), lcp),
                   exact_diff(args.lcp.cpu(), lcp))
        out = torch.zeros(lay.total, device=dev)
        got = fused_phase1_cuda(args, out, lay).cpu()
        host = dataclasses.replace(args.map(lambda t: t.cpu()), lcp=lcp)
        t = time.perf_counter()
        want = fused_phase1_plain(host, torch.zeros(lay.total), lay)
        plain_s += time.perf_counter() - t
        err = max(err, exact_diff(got.view(torch.int32),
                                  want.view(torch.int32)))
        b, o = phase1_work(args, lay)
        nbytes, nops = nbytes + b, nops + o
        outs.append(out)
    check(gerr == 0.0, "lcp_gather kernel != plain at a fused step's "
          "request and candidate rows")
    check(err == 0.0, "fused_phase1 kernel != plain at a main-path input")
    ms = cuda_time_ms(lambda: [fused_phase1_cuda(a, o, lay)
                               for (a, lay, _), o in zip(p1, outs)], 50, 2)
    dev_ms, dev_from = device_ms(
        [lambda a=a, o=o, lay=lay: fused_phase1_cuda(a, o, lay)
         for (a, lay, _), o in zip(p1, outs)], "fused_phase1")
    bound, by = roofline(nbytes / len(p1), nops / len(p1))
    phase1 = {"calls": len(p1), "max_abs_err": err, "ms": ms / len(p1),
              "device_ms": dev_ms, "device_ms_from": dev_from,
              "plain_ms": plain_s * 1e3 / len(p1),
              "bound_ms": bound, "bound_by": by,
              "gathers": len(p1), "gather_max_abs_err": gerr,
              "shapes": sorted({(a.nb, a.mb, a.cb) for a, _, _ in p1})}

    fc = calls["auction_fused"]
    check(bool(fc), "no auction_fused call was recorded on the main path")
    bids = []
    plain_bid = ops.auction_bid_op

    def keep_bid(*args):
        bids.append(args)
        return plain_bid(*args)

    ops.auction_bid_op = keep_bid
    err, nbytes, nops, plain_s, rounds = 0.0, 0, 0, 0.0, 0
    try:
        for (out, counts, p0, lay), kw in fc:
            got = auction_fused_cuda(out.clone(), counts, p0, lay, **kw).cpu()
            first = len(bids)
            t = time.perf_counter()
            want = auction_fused_plain(out.cpu(), counts.cpu(), p0.cpu(),
                                       lay, **kw)
            plain_s += time.perf_counter() - t
            err = max(err, exact_diff(got.view(torch.int32),
                                      want.view(torch.int32)))
            rounds += int(want.view(torch.int32)[1])
            # W, counts, the start grid and wmax read once; the prices,
            # the assignment and the header written once
            nbytes += 4 * (lay.nb * lay.mb + 2 * lay.mb + lay.mb * lay.cbu
                           + 1) + 4 * (lay.mb * lay.cbu + 2 * lay.nb + 3)
            nops += sum(3 * b[0].shape[1] * int(b[3].sum())
                        for b in bids[first:])
    finally:
        ops.auction_bid_op = plain_bid
    check(err == 0.0, "auction_fused kernel != plain at a main-path input")
    ms = cuda_time_ms(lambda: [auction_fused_cuda(*a, **kw) for a, kw in fc],
                      5, 1)
    dev_ms, dev_from = device_ms(
        [lambda a=a, kw=kw: auction_fused_cuda(*a, **kw) for a, kw in fc],
        "auction_fused")
    bound, by = roofline(nbytes / len(fc), nops / len(fc))
    solve = {"calls": len(fc), "max_abs_err": err, "ms": ms / len(fc),
             "device_ms": dev_ms, "device_ms_from": dev_from,
             "plain_ms": plain_s * 1e3 / len(fc),
             "bound_ms": bound, "bound_by": by,
             "rounds_per_call": rounds / len(fc)}
    return {"fused_phase1": phase1, "auction_fused": solve}


def phase_fused_router(dev) -> tuple[Counter, dict]:
    """Phase 15: the fused routing step (``IEMASRouter(fused=True)``) on the
    card at SCALE_128's fleet and one hub, against the fused CPU router bit
    for bit and the staged CUDA router under the two-tier gate; then both
    fused kernels at every main-path input and on synthetic cases.
    Returns the main path's launch counts and the two kernels' figures."""
    import torch

    from repro_torch.configs.iemas_cluster import (SCALE_128, agent_infos,
                                                   agent_profiles,
                                                   make_router)
    from repro_torch.kernels import ops

    profiles = agent_profiles(SCALE_128.n_agents)
    infos = agent_infos(profiles)
    cfg = dataclasses.replace(SCALE_128.router_config(), n_hubs=1,
                              audit_ledger=True, fused=True)
    gpu = make_router(infos, cfg, device=dev)
    cpu = make_router(infos, cfg, device="cpu")
    staged = make_router(infos, dataclasses.replace(cfg, fused=False),
                         device=dev)
    gpu.profiler = clock = PhaseClock()
    gpu_rounds, cpu_rounds, starts = [], [], Counter()
    keep_rounds(gpu, gpu_rounds, starts)
    keep_rounds(cpu, cpu_rounds)
    loop = ClosedLoop(profiles, SCALE_128.batch_cap,
                      SCALE_128.max_new_tokens, seed=0)
    lat, staged_lat, tiers, routed, pay_s = [], [], [], 0, 0.0
    per_batch = ("lcp_gather", "fused_phase1", "auction_fused")
    counts = Counter()      # the fused CUDA router's launches only

    def clone(reqs):
        return [type(r)(r.request_id, r.dialogue_id, r.tokens.copy(),
                        r.turn, r.domain, r.max_new_tokens, dict(r.meta))
                for r in reqs]

    def route(reqs, telemetry):
        """One batch through the three routers; returns the fused CUDA
        router's decisions and whether the staged router took part."""
        before = ops.launch_counts()
        nonlocal pay_s
        spill_before = tally.single_calls + tally.resolves
        pay0 = tally.pay_s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = gpu.route_batch(reqs, telemetry)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        pay_s += tally.pay_s - pay0
        after = ops.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        counts.update(delta)
        check(all(delta[k] == 1 for k in per_batch)
              and delta["auction_bid"] == 0 and delta["lcp_affinity"] == 0,
              f"batch {len(lat)}: launches {delta}, not one of each fused "
              "kernel and none of the replaced ones")
        check(delta["auction_solve"] == tally.single_calls + tally.resolves
              - spill_before, "auction_solve launched beyond the spill "
              "round's solves")
        want = cpu.route_batch(clone(reqs), telemetry)
        check(same_decisions(got, want), "CUDA and CPU fused routers decided "
              f"differently at batch {len(lat)}")
        check(gpu_rounds == cpu_rounds, "the fused solves' rounds differ "
              f"between the card and the CPU: {gpu_rounds} {cpu_rounds}")
        with_staged = not tiers or tiers[-1] == 1
        if with_staged:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = staged.route_batch(clone(reqs), telemetry)
            torch.cuda.synchronize()
            staged_lat.append(time.perf_counter() - t0)
            tiers.append(gate_tier(st, got, len(lat)))
        return got, with_staged

    with recording_fused(ops) as calls, SolveTally() as tally, \
            guarding_syncs(gpu, ops) as syncs:
        ops.reset_launch_counts()          # the main path's run starts here
        while routed < MIN_REQUESTS or len(lat) < 5:
            reqs = loop.next_batch()
            check(bool(reqs), "closed loop ran dry before enough requests")
            telemetry = {"router_inflight": len(reqs), "router_rps": 2.0}
            got, with_staged = route(reqs, telemetry)
            routed += len(reqs)
            loop.complete(got, [gpu, cpu] + ([staged] if with_staged
                                             and tiers[-1] == 1 else []))
            check(gpu.accounts == cpu.accounts, "fused accounts diverged")
            check(gpu.settlement.head == cpu.settlement.head,
                  "fused settlement ledger heads diverged")
        # one batch whose DAG steps name parent sessions
        reqs = loop.next_batch()
        check(len(reqs) >= 3, "closed loop ran dry before the parents batch")
        ids = [r.dialogue_id for r in reqs]
        for j, r in enumerate(reqs):
            if j % 3 == 1:
                r.meta["parent_sessions"] = (ids[(j + 1) % len(ids)],
                                             ids[(j + 2) % len(ids)])
        got, with_staged = route(reqs, {"router_inflight": len(reqs),
                                        "router_rps": 2.0})
        routed += len(reqs)
        check(calls["fused_phase1"][-1][0].cb > 0,
              "the parents batch ran no candidate rows")
        loop.complete(got, [gpu, cpu])
    check(gpu.accounts == cpu.accounts, "fused accounts diverged")
    gpu.settlement.audit(gpu.accounts)
    batches = len(lat)
    check(syncs["steps"] == batches and syncs["tail_syncs"] == batches,
          f"{syncs['tail_syncs']} synchronizing calls after the fused solve "
          f"in {syncs['steps']} fused steps of {batches} batches, not one "
          "each")
    ms = sorted(x * 1e3 for x in lat)
    sms = sorted(x * 1e3 for x in staged_lat)
    print(f"    {routed} requests in {batches} batches (the last with parent "
          f"sessions), {gpu.accounts['matched']} matched, the CUDA and CPU "
          f"fused routers identical (decisions, payments, accounts, ledger "
          f"head {gpu.settlement.head[:16]}, rounds per solve {gpu_rounds})")
    print(f"    against the staged CUDA router: {tiers.count(1)} batches in "
          f"tier 1 (same assignment, payments within {PAY_TOL}, estimates "
          f"within {EST_TOL}), {tiers.count(2)} in tier 2 (another "
          "assignment within the ε-optimality gap; the comparison stops "
          "there, as tests/test_routing_fused.py's does)")
    print(f"    launches {dict(counts)}; per batch exactly one lcp_gather, "
          "fused_phase1 and auction_fused; no sync from the first launch to "
          "the fused solve's return (sync debug mode \"error\") and "
          f"{syncs['tail_syncs']} synchronizing calls after it in "
          f"{batches} fused steps (\"warn\"); "
          f"{gpu._fused.cache_size()} padded shape keys")
    print(f"    fused router route_batch p50 {percentile(ms, 0.5):.2f} ms, p90 "
          f"{percentile(ms, 0.9):.2f} ms, {routed / sum(lat):.1f} requests/s;"
          " per batch " + ", ".join(
              f"{k} {v / batches:.2f} ms" for k, v in
              sorted(clock.ms.items())))
    print(f"    of fused_route: {pay_s * 1e3 / batches:.2f} ms per batch in the "
          "host's Clarke payments (dense_clarke_payments, NumPy float64); "
          f"{starts['warm']} of {batches} solves warm-started, "
          f"{starts['tripped']} tripped into the cold re-solve")
    print(f"    staged CUDA router at one hub on the first {len(sms)} of "
          f"these batches: route_batch p50 {percentile(sms, 0.5):.2f} ms, "
          f"p90 {percentile(sms, 0.9):.2f} ms")
    print("    route_batch ms per batch, fused: " + ", ".join(
        f"{x * 1e3:.2f}" for x in lat) + "; staged, same batches: "
        + ", ".join(f"{x * 1e3:.2f}" for x in staged_lat))
    gpu.profiler = None
    traced = profiled_copies(gpu, loop, 3, tries=8)
    check(any(k > 0 for _, _, k in traced), f"no traced fused step held a "
          f"kernel record: {traced}")
    check(all(d == 1 for d, _, k in traced if k > 0),
          f"device-to-host copies per traced fused step: {traced}")
    print(f"    {len(traced)} more fused steps, each in its own profiler "
          "trace, until 3 held kernel records: (device-to-host copies, "
          f"host-to-device copies, kernel records) {traced}")
    print("    the two fused kernels at every main-path input")
    figures = replay_fused_calls(calls, dev)
    r1, r2 = figures["fused_phase1"], figures["auction_fused"]
    print(f"    lcp_gather at the {r1['gathers']} fused steps' request and "
          "parent-candidate rows: bit-exact against its plain version, whose "
          "LCP fed the plain fused_phase1")
    print(f"    fused_phase1 over {r1['calls']} calls {r1['shapes']}: "
          f"bit-exact, kernel {r1['ms']:.4f} ms ({dev_text(r1)})"
          f", plain {r1['plain_ms']:.4f} ms, bound {r1['bound_ms']:.7f} ms "
          f"({r1['bound_by']}) per call")
    print(f"    auction_fused over {r2['calls']} calls "
          f"({r2['rounds_per_call']:.1f} rounds per call): bit-exact, kernel "
          f"{r2['ms']:.4f} ms ({dev_text(r2)}, "
          f"{r2['device_ms'] / max(1.0, r2['rounds_per_call']) * 1e3:.2f} us "
          f"per round), plain (host) {r2['plain_ms']:.1f} ms, bound "
          f"{r2['bound_ms']:.7f} ms ({r2['bound_by']}) per call")
    print("    the two fused kernels on synthetic cases")
    phase1_synthetic(dev, ops)
    fused_solve_synthetic(dev)
    return counts, figures


# ------------------------------------------------ serving stack, 16-17 --
SERVE_FLAGS = ["--agents", "9", "--dialogues", "16", "--workload",
               "coqa_like", "--solver", "cuda", "--warm-start",
               "--audit-ledger"]            # the CLI's defaults otherwise
SCALE_LOCKSTEP = 100          # dialogues, CUDA vs CPU router (200, cut to
                              # leave phases 24-25 their room)
SCALE_DIALOGUES = 500          # the scale run's (SCALE_128's 10,000, cut
                               # to leave phases 18-25 their room)
# the metrics that read the host clock: a federation's report adds its two
# routing walls, every shard's report has its own copy of the first three,
# and phase 18's profiler lists each route_batch call's host ms
WALL_KEYS = ("wall_time_s", "routing.routing_wall_s", "routing.overhead_frac",
             "routing.federation_wall_s", "routing.shard_routing_wall_s",
             "routing.route_batch_ms")


def flat_metrics(metrics: dict, pre: str = "") -> dict:
    """Nested metric dicts as one dict of dotted keys (a list of dicts,
    such as a federation's ``shards``, by position: ``shards.0.n``)."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, dict):
            out.update(flat_metrics(v, f"{pre}{k}."))
        elif isinstance(v, list) and v and all(isinstance(e, dict)
                                               for e in v):
            for i, e in enumerate(v):
                out.update(flat_metrics(e, f"{pre}{k}.{i}."))
        else:
            out[f"{pre}{k}"] = v
    return out


def without_wall_clock(metrics: dict) -> dict:
    """The metrics as dotted keys, less the ones that read the host clock
    (left out by name, at the top or inside a federation shard's report:
    ``WALL_KEYS`` and each profiler phase's ``wall_s`` and
    ``frac_of_engine``)."""
    out = {}
    for k, v in flat_metrics(metrics).items():
        key = re.sub(r"^shards\.\d+\.", "", k)
        if key in WALL_KEYS or (key.startswith("routing.phases.")
                                and key.rsplit(".", 1)[1] in
                                ("wall_s", "frac_of_engine")):
            continue
        out[k] = v
    return out


@contextmanager
def serve_cli_capture(serve, per_batch):
    """Run ``serve.main`` with its cluster and router kept: every real
    engine's ``serve`` call, its warm-up's included, is logged per engine
    (arguments and result, so that the calls can be served again on
    another engine in the same order), and every ``route_batch`` call is
    timed on the host clock (synchronised) and handed to
    ``per_batch(before, after)`` with the launch counts around it."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import AgentEngine

    made = {"logs": {}, "route_ms": []}
    sim_cluster, build_router = serve.SimCluster, serve.build_router
    engine_serve = AgentEngine.serve

    def logged(self, session, prompt, now=0.0, max_new_tokens=None,
               parents=()):
        res = engine_serve(self, session, prompt, now=now,
                           max_new_tokens=max_new_tokens, parents=parents)
        made["logs"].setdefault(id(self), []).append(
            (session, np.array(prompt, np.int32), now, max_new_tokens,
             tuple(parents), res))
        return res

    def cluster(*args, **kwargs):
        made["cluster"] = c = sim_cluster(*args, **kwargs)
        return c

    def router(*args, **kwargs):
        made["router"] = r = build_router(*args, **kwargs)
        route_batch = r.route_batch

        def timed(*a, **kw):
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = route_batch(*a, **kw)
            torch.cuda.synchronize()
            made["route_ms"].append((time.perf_counter() - t0) * 1e3)
            per_batch(before, ops.launch_counts())
            return out
        r.route_batch = timed
        return r

    serve.SimCluster, serve.build_router = cluster, router
    AgentEngine.serve = logged
    try:
        yield made
    finally:
        serve.SimCluster, serve.build_router = sim_cluster, build_router
        AgentEngine.serve = engine_serve
        built = made.get("cluster")
        made["logs"] = {} if built is None else {
            aid: made["logs"].get(id(rt.engine), [])
            for aid, rt in built.agents.items()}


def serve_closed(dev, flags, record=False):
    """One closed-loop CLI run on the card (``launch.serve.main``, real
    engines) under the phase's gates; returns the run's launch counts, the
    cluster, the engines' logs and the recorded attention calls."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    fused = "--fused" in flags
    batches = Counter()

    def per_batch(before, after):
        delta = {k: after[k] - before[k] for k in after}
        batches["n"] += 1
        if fused:
            check(delta["lcp_gather"] == delta["fused_phase1"]
                  == delta["auction_fused"] == 1, f"fused batch "
                  f"{batches['n']}: launches {delta}, not one of each")
        else:
            check(delta["lcp_gather"] == 1, f"staged batch {batches['n']}: "
                  f"lcp_gather launched {delta['lcp_gather']} times")
        check(delta["auction_bid"] == delta["lcp_affinity"] == 0,
              f"a replaced kernel launched: {delta}")

    names = ("flash_attention", "decode_attention") if record else ()
    out = io.StringIO()
    with serve_cli_capture(serve, per_batch) as made, \
            recording(ops, names, per_shape=2) as rec, \
            SolveTally() as tally, redirect_stdout(out):
        ops.reset_launch_counts()          # the path's run starts here
        t0 = time.perf_counter()
        metrics = serve.main(flags + ["--device", dev.type])
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()       # ... and ends here
    printed = json.loads(out.getvalue())
    check(without_wall_clock(printed) == without_wall_clock(
        json.loads(json.dumps(metrics, default=float))),
          "the CLI printed other metrics than it returned")
    cluster, router = made["cluster"], made["router"]
    check(not metrics["truncated"] and metrics["unfinished_dialogues"] == 0,
          f"dialogues left unfinished: {metrics['unfinished_dialogues']}")
    check(metrics["kv_hit_rate"] > 0.5,
          f"KV hit rate {metrics['kv_hit_rate']} <= 0.5")
    check(metrics["accounts"]["surplus"] >= 0, "negative surplus")
    check(metrics["ledger"]["settled"] == metrics["n"],
          "the settlement ledger does not settle every completed request")
    n = batches["n"]
    check(counts["lcp_gather"] == n > 0, f"lcp_gather launched "
          f"{counts['lcp_gather']} times over {n} batches")
    check(counts["auction_bid"] == counts["lcp_affinity"] == 0,
          f"a replaced kernel launched on the path: {counts}")
    solves = sum(d == dev.type for d, _ in tally.rounds)
    if fused:
        check(counts["fused_phase1"] == counts["auction_fused"] == n,
              f"fused kernels launched {counts} over {n} batches")
        check(counts["auction_solve"] == solves, "auction_solve launched "
              "beyond the spill round's solves")
    else:
        check(counts["auction_solve"] == solves > 0,
              f"auction_solve launched {counts['auction_solve']} times for "
              f"{solves} solves on the card")
        check(dev.type != "cuda" or solves <= tally.batch_calls
              + tally.single_calls + tally.resolves, "auction_solve "
              "launched more than once per solve")
    # the attention kernels: exact counts from what each engine served
    fresh = steps = 0
    for aid, log in made["logs"].items():
        layers = cluster.agents[aid].engine.cfg.n_layers
        for *_, res in log:
            fresh += layers * (res.n_hit == 0)
            steps += layers * (res.n_gen + (res.n_hit == res.n_prompt))
    check(counts["flash_attention"] == fresh > 0,
          f"flash_attention launched {counts['flash_attention']} times for "
          f"{fresh} layer prefills")
    check(counts["decode_attention"] == steps > 0,
          f"decode_attention launched {counts['decode_attention']} times for "
          f"{steps} layer decode steps")
    ms = sorted(made["route_ms"])
    print(f"    {metrics['dispatched_requests']} requests in {n} batches, "
          f"{metrics['n']} completed, KV hit rate "
          f"{metrics['kv_hit_rate']:.4f}, latency p50 "
          f"{metrics['latency_ms_median']:.2f} ms / p95 "
          f"{metrics['latency_ms_p95']:.2f} ms, mean cost "
          f"{metrics['cost_mean']:.4f}, quality {metrics['quality_mean']:.3f}"
          f", surplus {metrics['accounts']['surplus']:.4f}, ledger head "
          f"{metrics['ledger']['head'][:16]}")
    print(f"    route_batch p50 {percentile(ms, 0.5):.2f} ms, p90 "
          f"{percentile(ms, 0.9):.2f} ms (host clock, synchronised); "
          f"{metrics['dispatched_requests'] / wall:.1f} requests/s over the "
          f"CLI call's {wall:.1f} s (engine build and warm-up included); "
          f"launches {counts}")
    return counts, cluster, made["logs"], rec


def rebuild_on_cpu(cluster, logs) -> int:
    """Every agent's requests again, in order and after the same warm-up,
    on a CPU engine holding the card engine's weights: the same tokens and
    hits per request."""
    import numpy as np

    from repro_torch.serving.engine import AgentEngine

    served = 0
    for aid, log in logs.items():
        eng = cluster.agents[aid].engine
        cpu = AgentEngine(eng.cfg, device="cpu",
                          params=copy.deepcopy(eng.params).cpu(),
                          speed=eng.speed, cache_slots=eng.cache_slots,
                          max_len=eng.max_len, max_new_tokens=eng.max_new)
        cpu.warmup()
        for session, prompt, now, max_new, parents, res in log:
            if session == "__warm__":
                continue                   # served by the warm-up above
            got = cpu.serve(session, prompt, now=now, max_new_tokens=max_new,
                            parents=parents)
            check(np.array_equal(got.output_tokens, res.output_tokens)
                  and (got.n_hit, got.n_prompt) == (res.n_hit, res.n_prompt),
                  f"{aid}: the CPU engine on the card's weights served "
                  f"{session} otherwise: {got.output_tokens} / "
                  f"{res.output_tokens}, hits {got.n_hit} / {res.n_hit}")
            served += 1
    return served


def phase_serving_closed(dev) -> dict:
    """Phase 16: ``launch.serve.main`` in its closed loop on real engines,
    staged (2 hubs) and fused (1 hub); returns each run's launch counts."""
    from repro_torch.configs.iemas_cluster import MODEL_CLASSES
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)

    print("    fleet: " + ", ".join(
        f"{c} ({n} layers, d_model {d}, {h} heads of {d // h})"
        for c, (n, d, h, _, _) in MODEL_CLASSES.items()) + ", float32")
    runs = {}
    for label, extra in (("staged", ["--hubs", "2"]),
                         ("fused", ["--hubs", "1", "--fused"])):
        print(f"    {label}: serve {' '.join(SERVE_FLAGS + extra)} "
              f"--device {dev.type}")
        counts, cluster, logs, rec = serve_closed(
            dev, SERVE_FLAGS + extra, record=label == "staged")
        served = rebuild_on_cpu(cluster, logs)
        print(f"    the {served} requests again on CPU engines holding the "
              "card's weights: the same tokens and hits")
        runs[label] = counts
        if label == "staged":
            dims = {args[0].shape[-1] for args, _ in
                    rec["flash_attention"].calls}
            check({48, 64, 72} <= dims, f"flash head dims {dims}")
            print("    the attention kernels at the run's inputs (up to 2 "
                  "calls of each shape, weighted by the calls made), "
                  "float32, d = 48 / 64 / 72")
            for name, kernel, plain, lib, work in (
                    ("flash_attention", flash_attention_cuda,
                     flash_attention_plain, sdpa_flash, flash_work),
                    ("decode_attention", decode_attention_cuda,
                     decode_attention_plain, sdpa_decode, decode_work)):
                r = replay_attention(rec[name], kernel, plain, lib, work)
                print(f"    {name} per call ({r['calls']} calls, "
                      f"{r['sampled']} sampled): max abs err "
                      f"{r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms "
                      f"({dev_text(r)}), plain "
                      f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} "
                      f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
        del cluster, logs, rec
    return runs


@contextmanager
def device_traced(dev):
    """A ``torch.profiler`` trace of the card's activity only (kernels and
    copies) around the block; yields a function that returns their summed
    device ms once the block is done (0.0 for a CPU device)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        yield lambda: 0.0
        return
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield lambda: sum(e.device_time_total for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA) / 1e3
        torch.cuda.synchronize()


def batch_timing_profiler():
    """A `RoutingProfiler` whose report also lists every route_batch
    call's host ms (``route_batch_ms``, a wall-clock key); a module-level
    factory, so a process shard builds one in its own process
    (``loop_kwargs["profile"]``)."""
    from repro_torch.serving.simulator import RoutingProfiler

    class BatchTimes(RoutingProfiler):
        def __init__(self):
            super().__init__()
            self.batch_ms = []

        @contextmanager
        def phase(self, name):
            t0 = time.perf_counter()
            with super().phase(name):
                yield
            if name == "route_batch":
                self.batch_ms.append((time.perf_counter() - t0) * 1e3)

        def report(self):
            return {**super().report(), "route_batch_ms": self.batch_ms}

    return BatchTimes()


def scale_sim(dev, n_dialogues: int):
    """The SCALE_128 preset's open loop: 128 analytic agents, the ``cuda``
    solver at 8 hubs with warm starts and spill, Poisson arrivals at the
    preset's rate over a streamed coqa_like workload, the admission window,
    batch cap and window of the preset, and a `RoutingProfiler` that also
    reports each route_batch's host ms (``routing.route_batch_ms``).
    Returns (metrics, router, wall seconds)."""
    from repro_torch.configs.iemas_cluster import SCALE_128
    from repro_torch.serving import (EventSimulator, PoissonArrivals,
                                     SimCluster, WorkloadSpec,
                                     iter_dialogues, make_router)

    cluster = SimCluster(SCALE_128.n_agents, seed=0,
                         max_new_tokens=SCALE_128.max_new_tokens,
                         engine_mode=SCALE_128.engine_mode, device=dev)
    router = make_router(cluster, SCALE_128.router_config(),
                         audit_ledger=True)
    check(len(router.hubs) == 8 and router.spill and router.warm_start,
          "not the SCALE_128 router")
    sim = EventSimulator(
        cluster, router, iter_dialogues(WorkloadSpec(
            "coqa_like", n_dialogues, seed=1)),
        arrivals=PoissonArrivals(rate=SCALE_128.arrival_rate(), seed=2),
        batch_cap=SCALE_128.batch_cap, batch_window=SCALE_128.batch_window,
        max_inflight=SCALE_128.max_inflight, max_new_tokens=SCALE_128.
        max_new_tokens, profiler=batch_timing_profiler(), lean=True)
    t0 = time.perf_counter()
    metrics = sim.run()
    return metrics, router, time.perf_counter() - t0


def phase_serving_scale(dev) -> dict:
    """Phase 17: the SCALE_128 open loop, CUDA router against CPU router
    over the first dialogues, then the CUDA router alone at scale; returns
    the scale run's launch counts."""
    from repro_torch.configs.iemas_cluster import SCALE_128
    from repro_torch.kernels import ops

    print(f"    {SCALE_128.n_agents} analytic agents, {SCALE_128.n_hubs()} "
          f"hubs, Poisson {SCALE_128.arrival_rate():g} dialogues/s, "
          f"max_inflight {SCALE_128.max_inflight}, batch_cap "
          f"{SCALE_128.batch_cap}, batch_window {SCALE_128.batch_window}")
    with SolveTally() as tally, device_traced(dev) as kernel_ms:
        ops.reset_launch_counts()          # the lockstep run starts here
        gpu, gpu_router, gpu_s = scale_sim(dev, SCALE_LOCKSTEP)
        counts = ops.launch_counts()       # ... and ends here
        solves = sum(d == dev.type for d, _ in tally.rounds)
    cpu, cpu_router, cpu_s = scale_sim("cpu", SCALE_LOCKSTEP)
    a, b = without_wall_clock(gpu), without_wall_clock(cpu)
    check(a == b, "CUDA and CPU routers' runs differ: " + str(
        {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
         if a.get(k) != b.get(k)}))
    check(gpu_router.accounts == cpu_router.accounts, "accounts differ")
    check(gpu_router.settlement.head == cpu_router.settlement.head,
          "settlement heads differ")
    check(not gpu["truncated"]
          and gpu["dialogues_completed"] == SCALE_LOCKSTEP,
          "the lockstep run did not finish")
    batches = gpu["routing"]["phases"]["route_batch"]["calls"]
    check(counts["lcp_gather"] == batches > 0
          and counts["auction_solve"] == solves > 0
          and counts["auction_bid"] == counts["lcp_affinity"] == 0,
          f"launches {counts} over {batches} batches and {solves} solves")
    print(f"    lockstep over {SCALE_LOCKSTEP} dialogues: equal metrics "
          f"(wall clock aside), accounts and ledger head "
          f"{gpu_router.settlement.head[:16]}; {gpu['dispatched_requests']} "
          f"requests in {batches} batches, KV hit rate "
          f"{gpu['kv_hit_rate']:.4f}; CUDA router run {gpu_s:.2f} s, CPU "
          f"router run {cpu_s:.2f} s")
    busy = kernel_ms()
    print("    device busy over the CUDA router's run: " + (
        "not measured (the trace holds no device record)" if not busy else
        f"{busy:.1f} ms of kernels and copies in {gpu_s * 1e3:.1f} ms "
        f"({busy / (gpu_s * 1e3):.2%}; torch.profiler, device activity "
        "only, a lower bound)"))
    del gpu_router, cpu_router
    n = SCALE_DIALOGUES or SCALE_128.n_dialogues
    ops.reset_launch_counts()              # the scale run starts here
    m, router, wall = scale_sim(dev, n)
    counts = ops.launch_counts()           # ... and ends here
    batches = m["routing"]["phases"]["route_batch"]["calls"]
    check(counts["lcp_gather"] == batches > 0 and counts["auction_solve"] > 0
          and counts["auction_bid"] == counts["lcp_affinity"] == 0,
          f"scale run launches {counts} over {batches} batches")
    check(not m["truncated"] and m["dialogues_completed"] == n,
          "the scale run did not finish")
    check(router.accounts["surplus"] >= 0, "negative surplus")
    ms = sorted(m["routing"].pop("route_batch_ms"))
    print(f"    scale run, {n} dialogues: "
          f"{m['dispatched_requests']} requests dispatched, {m['n']} "
          f"completed, KV hit rate {m['kv_hit_rate']:.4f}, latency p50 "
          f"{m['latency_ms_median']:.2f} ms / p95 "
          f"{m['latency_ms_p95']:.2f} ms, mean cost {m['cost_mean']:.4f}, "
          f"{m['sim_time_s']:.1f} virtual s")
    print(f"    route_batch p50 {percentile(ms, 0.5):.2f} ms, p90 "
          f"{percentile(ms, 0.9):.2f} ms over {batches} batches; "
          f"{m['dispatched_requests'] / wall:.1f} requests/s over the run's "
          f"{wall:.1f} s (host clock); launches lcp_gather "
          f"{counts['lcp_gather']}, auction_solve {counts['auction_solve']}")
    print("    RoutingProfiler: " + json.dumps(m["routing"]))
    return counts


# --------------------------------------------------- the federation, 18 --
FED_MIGRATION = 40         # dialogues of 18a (the reference test's 150,
                           # cut to leave phases 23b-28 their room; 58
                           # still migrate on the CPU)
FED_LOCKSTEP = 60          # dialogues of 18b at the SCALE_1K fleet (200,
                           # cut to leave phases 24-28 their room)
FED_DIALOGUES = 500        # the scale run's (SCALE_1K's 100,000, cut to
                           # leave phases 19-27 their room)
FED_LAUNCHES_NONE = ("auction_bid", "lcp_affinity", "fused_phase1",
                     "auction_fused")


@contextmanager
def spill_launches():
    """While active, the kernel launches made inside each of the
    federation's own spill rounds, one entry per round."""
    from repro_torch.kernels import ops
    from repro_torch.serving.federation import FederatedSimulator

    spill_round = FederatedSimulator._spill_round
    made = []

    def counted(self, *args):
        before = sum(ops.launch_counts().values())
        try:
            return spill_round(self, *args)
        finally:
            made.append(sum(ops.launch_counts().values()) - before)

    FederatedSimulator._spill_round = counted
    try:
        yield made
    finally:
        FederatedSimulator._spill_round = spill_round


@contextmanager
def phase1_calls():
    """While active, the routers' Phase-1 passes (route_batch calls that
    have requests and a live agent: each gathers the LCP once), in a
    one-element list."""
    from repro_torch.core.mechanism import IEMASRouter

    phase1 = IEMASRouter._phase1
    made = [0]

    def counted(self, *args):
        made[0] += 1
        return phase1(self, *args)

    IEMASRouter._phase1 = counted
    try:
        yield made
    finally:
        IEMASRouter._phase1 = phase1


def fed_migration(dev):
    """18a's federation: the reference test's overloaded one (12 agents, 3
    super-hubs, every coqa_like dialogue in one domain, Poisson 300/s,
    faults, spill after 0.2 s) on the ``cuda`` solver with warm starts and
    ledgers, every shard inline on ``dev``.  Returns (report, seconds)."""
    from repro_torch.serving import (PoissonArrivals, WorkloadSpec,
                                     build_federation, generate)

    dlg = generate(WorkloadSpec("coqa_like", n_dialogues=FED_MIGRATION,
                                seed=1))
    dom = sorted({d.domain for d in dlg})[0]
    dlg = [type(d)(d.dialogue_id, dom, d.turns, d.difficulty) for d in dlg]
    fed = build_federation(
        dlg, n_agents=12, super_hubs=3,
        arrivals=PoissonArrivals(rate=300.0, seed=2), seed=0,
        router_kwargs=dict(solver="cuda", warm_start=True, audit_ledger=True),
        loop_kwargs=dict(batch_cap=32, batch_window=0.05, max_new_tokens=4),
        cluster_kwargs=dict(max_new_tokens=4, fail_prob=0.1),
        max_inflight=900, epoch=0.25, spill_min_wait=0.2, device=dev)
    t0 = time.perf_counter()
    out = fed.run()
    return out, time.perf_counter() - t0


def fed_scale(dev, n_dialogues: int, parallel: str):
    """The SCALE_1K preset's federation as the reference's scale benchmark
    builds it (1024 analytic agents, 8 super-hubs recut into inner hubs of
    ``agents_per_hub``, Poisson 0.75 dialogues/s per agent of streamed
    coqa_like, ``max_inflight`` 2048 split over the shards, batches of <= 64
    every 0.05 s, epoch 0.5 s, the ``cuda`` solver with warm starts, ledgers
    on) over ``n_dialogues``, with its shards ``parallel`` on ``dev`` and
    every shard's route_batch calls timed.  Returns (report, seconds to
    build the federation, seconds to run it)."""
    from repro_torch.configs.iemas_cluster import SCALE_1K as c
    from repro_torch.serving import (PoissonArrivals, WorkloadSpec,
                                     build_federation, iter_dialogues)

    t0 = time.perf_counter()
    fed = build_federation(
        iter_dialogues(WorkloadSpec("coqa_like", n_dialogues, seed=1)),
        n_agents=c.n_agents, super_hubs=c.super_hubs,
        arrivals=PoissonArrivals(rate=c.arrival_rate(), seed=2), seed=0,
        engine_mode=c.engine_mode, agents_per_hub=c.agents_per_hub,
        max_inflight=c.max_inflight,
        router_kwargs=dict(solver=c.solver, warm_start=c.warm_start,
                           audit_ledger=True),
        loop_kwargs=dict(batch_cap=c.batch_cap, batch_window=c.batch_window,
                         max_new_tokens=c.max_new_tokens, lean=True,
                         max_events=20_000_000, max_rounds=2_000_000,
                         profile=batch_timing_profiler),
        cluster_kwargs=dict(max_new_tokens=c.max_new_tokens),
        epoch=c.epoch, parallel=parallel, device=dev)
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fed.run()
    return out, built, time.perf_counter() - t0


def shard_heads(out) -> list:
    return [s["ledger"]["head"] for s in out["shards"]]


def same_federation(a, b, what: str) -> None:
    """Two federation reports of one seeded run: every metric but the
    wall-clock ones equal, the accounts and every shard's ledger head."""
    x, y = without_wall_clock(a), without_wall_clock(b)
    check(x == y, f"{what}: reports differ: " + str(
        {k: (x.get(k), y.get(k)) for k in set(x) | set(y)
         if x.get(k) != y.get(k)}))
    check(a["accounts"] == b["accounts"], f"{what}: accounts differ")
    check(shard_heads(a) == shard_heads(b), f"{what}: ledger heads differ")


def batch_ms(out) -> list:
    """Every shard's route_batch host ms, sorted."""
    return sorted(x for s in out["shards"]
                  for x in s["routing"]["route_batch_ms"])


def gate_federation(out: dict, n_dialogues: int, super_hubs: int) -> None:
    """The reference scale benchmark's federation gates
    (benchmarks/serving_scale.py, ``_gate_federation``)."""
    eo = out["federation"]["exactly_once"]
    check(eo["ok"], f"exactly-once audit failed: {eo}")
    check(eo["ledger_replay_ok"] and eo["ledgers_attached"] == super_hubs,
          f"ledgers: {eo}")
    check(eo["lost_dialogues"] == 0 and eo["dialogues_conserved"],
          f"dialogues lost: {eo}")
    check(eo["migrations_balanced"], f"migrations unbalanced: {eo}")
    check(out["dialogues_completed"] + out["unfinished_dialogues"]
          == n_dialogues, "completed + unfinished != dialogues")
    check(not out["truncated"], "federation run truncated")
    check(out["federation"]["gossip"]["max_staleness_epochs"] <= 1,
          "spill consumed a digest older than one epoch")
    over = out["routing"]["overhead_frac"]
    check(over is not None and 0 < over < 0.5,
          f"routing+boundary overhead {over} out of (0, 0.5)")


def print_shards(out) -> None:
    print("    per shard (agents, n, router host s): " + ", ".join(
        f"{s['super_id']}: {s['n_agents']}, {s['n']}, "
        f"{s['routing']['routing_wall_s']:.2f}" for s in out["shards"]))


def phase_federation(dev) -> Counter:
    """Phase 18: the hubs-of-hubs federation with every shard's router on
    the card; returns the launch counts of 18b's CUDA inline run."""

    from repro_torch.configs.iemas_cluster import SCALE_1K as c
    from repro_torch.configs.iemas_cluster import agent_profiles
    from repro_torch.core.hub import cluster_super_hubs
    from repro_torch.distributed.federation import worker_slots
    from repro_torch.kernels import ops
    from repro_torch.kernels.lcp_affinity import (lcp_gather_cuda,
                                                  lcp_gather_plain)

    print(f"    (a) migration lockstep: 12 agents, 3 super-hubs, "
          f"{FED_MIGRATION} coqa_like dialogues in one domain, Poisson 300/s, "
          "max_inflight 900, fail_prob 0.1, epoch 0.25, spill_min_wait 0.2, "
          "solver cuda, warm starts, ledgers; inline on the card and on "
          "the CPU")
    with SolveTally() as tally, spill_launches() as spills, \
            phase1_calls() as passes:
        ops.reset_launch_counts()          # 18a's CUDA run starts here
        gpu, gpu_s = fed_migration(dev)
        counts = ops.launch_counts()       # ... and ends here
        solves = sum(d == dev.type for d, _ in tally.rounds)
    cpu, cpu_s = fed_migration("cpu")
    same_federation(gpu, cpu, "18a, CUDA and CPU shards")
    fed = gpu["federation"]
    check(fed["spill_migrated"] > 0
          and gpu["migrated_in"] == gpu["migrated_out"] > 0,
          f"18a migrated nothing: {fed['spill_migrated']}, "
          f"{gpu['migrated_in']} / {gpu['migrated_out']}")
    check(fed["exactly_once"]["ok"], f"18a: {fed['exactly_once']}")
    batches = gpu["routing"]["phases"]["route_batch"]["calls"]
    check(counts["lcp_gather"] == passes[0] > 0
          and counts["auction_solve"] == solves > 0
          and all(counts[k] == 0 for k in FED_LAUNCHES_NONE)
          and spills and sum(spills) == 0,
          f"18a launches {counts} over {passes[0]} Phase-1 passes and "
          f"{solves} solves; spill rounds launched {sum(spills)}")
    print(f"    equal reports (wall clock aside), accounts and ledger heads "
          f"{[h[:12] for h in shard_heads(gpu)]}; {gpu['n']} requests, "
          f"{fed['spill_migrated']} dialogues migrated of "
          f"{fed['spill_candidates']} candidates, {gpu['epochs']} epochs, "
          f"{batches} route_batch calls ({passes[0]} with a live agent, the "
          f"rest while faults quarantined a whole shard); launches "
          f"lcp_gather "
          f"{counts['lcp_gather']}, auction_solve {counts['auction_solve']}, "
          f"none in {len(spills)} spill rounds; CUDA run {gpu_s:.2f} s, CPU "
          f"run {cpu_s:.2f} s")
    del gpu, cpu

    profiles = agent_profiles(c.n_agents)
    supers = cluster_super_hubs([p.domains for p in profiles],
                                [p.scale for p in profiles], c.super_hubs,
                                agents_per_hub=c.agents_per_hub)
    print(f"    (b) the SCALE_1K fleet in lockstep: {c.n_agents} analytic "
          f"agents in {len(supers)} super-hubs of "
          f"{[len(h.agent_indices) for h in supers]} agents and "
          f"{[h.n_inner_hubs for h in supers]} inner hubs, Poisson "
          f"{c.arrival_rate():g} dialogues/s, max_inflight {c.max_inflight} "
          f"({c.max_inflight // c.super_hubs} a shard), batch_cap "
          f"{c.batch_cap}, batch_window {c.batch_window}, epoch {c.epoch}, "
          f"{FED_LOCKSTEP} coqa_like dialogues")
    with recording(ops, ("auction_solve", "lcp_gather"), per_shape=2,
                   copy=True) as rec, SolveTally() as tally, \
            spill_launches() as spills, phase1_calls() as passes:
        ops.reset_launch_counts()          # 18b's CUDA inline run starts
        inline, _, inline_s = fed_scale(dev, FED_LOCKSTEP, "inline")
        counts = ops.launch_counts()       # ... and ends here
        solves = sum(d == dev.type for d, _ in tally.rounds)
    cpu, _, cpu_s = fed_scale("cpu", FED_LOCKSTEP, "inline")
    same_federation(inline, cpu, "18b, CUDA and CPU shards")
    proc, proc_built, proc_s = fed_scale(dev, FED_LOCKSTEP, "process")
    same_federation(proc, inline, "18b, CUDA process and inline shards")
    batches = inline["routing"]["phases"]["route_batch"]["calls"]
    check(counts["lcp_gather"] == batches == passes[0] > 0
          and counts["auction_solve"] == solves > 0
          and all(counts[k] == 0 for k in FED_LAUNCHES_NONE)
          and sum(spills) == 0,
          f"18b launches {counts} over {batches} batches ({passes[0]} "
          f"Phase-1 passes) and {solves} solves; spill rounds launched "
          f"{sum(spills)}")
    with device_traced(dev) as kernel_ms:
        traced, _, traced_s = fed_scale(dev, FED_LOCKSTEP, "inline")
    busy = kernel_ms()
    same_federation(traced, inline, "18b, traced and untraced runs")
    ms_in, ms_proc = batch_ms(inline), batch_ms(proc)
    print(f"    CUDA inline = CPU inline and CUDA process = CUDA inline: "
          f"equal reports (wall clock aside), accounts and ledger heads; "
          f"{inline['n']} requests in {batches} route_batch calls, KV hit "
          f"rate {inline['kv_hit_rate']:.4f}; launches lcp_gather "
          f"{counts['lcp_gather']}, auction_solve {counts['auction_solve']} "
          f"({solves} solves), none in {len(spills)} spill rounds")
    print_shards(inline)
    print(f"    route_batch p50 / p90 (host, every shard): inline "
          f"{percentile(ms_in, 0.5):.2f} / {percentile(ms_in, 0.9):.2f} ms, "
          f"process {percentile(ms_proc, 0.5):.2f} / "
          f"{percentile(ms_proc, 0.9):.2f} ms; runs: CUDA inline "
          f"{inline_s:.2f} s, CPU inline {cpu_s:.2f} s, CUDA process "
          f"{proc_s:.2f} s (its 8 workers started in {proc_built:.2f} s)")
    print("    device busy over a CUDA inline run: " + (
        "not measured (the trace holds no device record)" if not busy else
        f"{busy:.1f} ms of kernels and copies in {traced_s * 1e3:.1f} ms "
        f"({busy / (traced_s * 1e3):.2%}; torch.profiler, device activity "
        "only, a lower bound)"))
    solve, _ = replay_solve(rec["auction_solve"].calls, dev)
    gather = replay(rec["lcp_gather"].calls, lcp_gather_cuda,
                    lcp_gather_plain,
                    lambda args, out: gather_work(*args, out[0]), 50, 10)

    def span(axis: int) -> str:      # the range of the gathers' n and m
        sizes = [args[2].shape[axis] for args, _ in rec["lcp_gather"].calls]
        return f"{min(sizes)}-{max(sizes)}"
    print(f"    at 18b's shapes (up to 2 calls of each): auction_solve over "
          f"{solve['calls']} calls ({solve['markets']} markets, "
          f"{solve['rounds_per_call']:.1f} rounds a call) bit-exact, kernel "
          f"{solve['ms']:.4f} ms ({dev_text(solve)}), plain "
          f"(host) {solve['plain_ms']:.2f} ms, bound {solve['bound_ms']:.7f} "
          f"ms ({solve['bound_by']}); lcp_gather over {gather['calls']} calls "
          f"(prompts of {span(0)} requests, {span(1)} agents) bit-exact, "
          f"kernel {gather['ms']:.4f} ms "
          f"({dev_text(gather)}), plain {gather['plain_ms']:.4f}"
          f" ms, bound {gather['bound_ms']:.7f} ms ({gather['bound_by']})")
    del inline, cpu, proc, traced, rec

    print(f"    (c) scale run: SCALE_1K, {FED_DIALOGUES} dialogues (the "
          f"preset's {c.n_dialogues}, cut), {c.super_hubs} process shards "
          f"on the card; os.cpu_count() {os.cpu_count()}, worker_slots() "
          f"{worker_slots()}")
    m, built, wall = fed_scale(dev, FED_DIALOGUES, "process")
    gate_federation(m, FED_DIALOGUES, c.super_hubs)
    fed, ms = m["federation"], batch_ms(m)
    g = fed["gossip"]
    print(f"    {wall:.1f} s (host clock; the 8 workers started in "
          f"{built:.2f} s before it), {m['dispatched_requests']} requests "
          f"dispatched, {m['n']} completed, "
          f"{m['dispatched_requests'] / wall:.1f} requests/s; KV hit rate "
          f"{m['kv_hit_rate']:.4f}, latency p50 {m['latency_ms_median']:.2f} "
          f"/ p95 {m['latency_ms_p95']:.2f} ms (virtual), mean cost "
          f"{m['cost_mean']:.4f}, {m['sim_time_s']:.1f} virtual s")
    print(f"    {m['epochs']} epochs, spilled {fed['spill_migrated']} / "
          f"{fed['spill_candidates']} candidates, staleness max "
          f"{g['max_staleness_epochs']} / mean "
          f"{g['mean_staleness_epochs']:.3f} epochs, overhead "
          f"{m['routing']['overhead_frac']:.4%} of engine seconds; "
          f"route_batch p50 {percentile(ms, 0.5):.2f} / p90 "
          f"{percentile(ms, 0.9):.2f} ms over {len(ms)} calls")
    phases = m["routing"]["phases"]
    print("    phase shares of engine seconds: " + ", ".join(
        f"{k} {v['frac_of_engine']:.4%} ({v['wall_s']:.2f} s, {v['calls']} "
        f"calls)" for k, v in phases.items()))
    print_shards(m)
    return counts


# ------------------------------- the MoE / MLA and larger dense families --
DEEPSEEK = "deepseek-v2-lite-16b"
MIXTRAL = "mixtral-8x22b"
QWEN25 = "qwen2.5-32b"
# the head layouts the earlier phases never ran: 40 / 8, 56 / 8, 64 / 8
GROUP_ARCHS = (QWEN25, "deepseek-coder-33b", "qwen2-72b")
WINDOW_SEQ = 6144          # mixtral's flash past its 4096-token window
MIXTRAL_LAYERS = 8         # of 56 (~40 GB in bf16 on one card)
FAMILY_SEEDS = {DEEPSEEK: "agent-3", MIXTRAL: "agent-4", QWEN25: "agent-5"}
LOCKSTEP_WINDOW = 16       # phase 20's mixtral window: its dialogue wraps it


def phase_attention_groups(dev) -> None:
    """Both attention kernels against their plain versions and SDPA at the
    new configs' head layouts, bf16, full width: qwen2.5-32b (40 / 8),
    deepseek-coder-33b (56 / 8) and qwen2-72b (64 / 8) at prompts of 128
    and 512 and decode at M = MAX_LEN; mixtral-8x22b (48 / 8, window 4096)
    with flash over 6,144 tokens and decode over M = 4096 with every slot
    valid.  Every output row is held within ``ATTN_ROW_TOL`` of its
    largest plain output besides the absolute gate."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)

    for arch in GROUP_ARCHS:
        cfg = get_config(arch)
        print(f"    {arch}: {cfg.n_heads} query / {cfg.n_kv_heads} KV heads "
              f"of {cfg.hd}, bf16")
        attention_shapes(dev, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         (128, 512), dtypes=(torch.bfloat16,), rows=True)
    cfg = get_config(MIXTRAL)
    h, hkv, d, w = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.sliding_window
    print(f"    {MIXTRAL}: {h} query / {hkv} KV heads of {d}, window {w}, "
          "bf16")
    rng = np.random.default_rng(19)

    def normal(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(torch.bfloat16)

    s = WINDOW_SEQ
    args = (normal((1, s, h, d)), normal((1, s, hkv, d)),
            normal((1, s, hkv, d)))
    f = attn_figures(flash_attention_cuda, flash_attention_plain, sdpa_flash,
                     flash_work, args, {"window": w}, iters=10, rows=True)
    print_figures("flash_attention window",
                  shape_key(args, {"window": w}), f)
    del args
    # the decode step after that prompt: a full window, every one of the
    # ring's w slots valid
    valid = torch.ones((1, w), dtype=torch.bool, device=dev)
    args = (normal((1, h, d)), normal((1, w, hkv, d)), normal((1, w, hkv, d)),
            valid)
    f = attn_figures(decode_attention_cuda, decode_attention_plain,
                     sdpa_decode, decode_work, args, {}, rows=True)
    print_figures("decode_attention full mask", shape_key(args), f)


@contextmanager
def recording_routes():
    """Keep each MoE routing call's top-k experts and router
    probabilities, per device (`models/moe._route`), to find the calls
    where the card and the CPU chose other experts."""
    import torch

    from repro_torch.models import moe

    route = moe._route
    calls = {"cuda": [], "cpu": []}

    def recorded(p, x, cfg):
        gates, idx = route(p, x, cfg)
        with torch.no_grad():
            probs = torch.softmax(torch.einsum(
                "bsd,de->bse", x, p["router"]).float(), dim=-1)
        calls[x.device.type].append((idx.cpu(), probs.cpu()))
        return gates, idx

    moe._route = recorded
    try:
        yield calls
    finally:
        moe._route = route


def route_flips(calls, k: int) -> str:
    """Where the card's top-k expert sets differ from the CPU's, with the
    CPU's margin there (k-th minus (k+1)-th probability); else the
    smallest margin of any token."""
    import torch

    check(len(calls["cuda"]) == len(calls["cpu"]),
          "the devices made different numbers of routing calls")
    flips, margins, least = 0, [], float("inf")
    for (gi, _), (ci, cp) in zip(calls["cuda"], calls["cpu"]):
        top = torch.sort(cp, dim=-1, descending=True).values
        gap = top[..., k - 1] - top[..., k]
        least = min(least, float(gap.min()))
        diff = (torch.sort(gi, -1).values != torch.sort(ci, -1).values) \
            .any(-1)
        flips += int(diff.sum())
        margins += gap[diff].tolist()
    if flips:
        return (f"{flips} top-{k} expert flips between card and CPU, CPU "
                f"margins {sorted(margins)[:5]}")
    return (f"no top-{k} expert flip in {len(calls['cpu'])} routing calls; "
            f"the closest token's margin {least:.3g}")


def phase_family_lockstep(dev) -> None:
    """A CUDA engine and a CPU engine on the same weights, full width, two
    layers, float32: deepseek-v2-lite-16b (its dense layer and one MoE +
    MLA layer), mixtral-8x22b (two MoE layers, its window cut to
    LOCKSTEP_WINDOW so the ring wraps and the window masks) and
    qwen2.5-32b (the QKV biases drawn nonzero).  Per model one dialogue:
    fresh, exact extension, a partial prefix hit (truncate, extend,
    decode: the path of the reference's MLA stale-latent fault, reproduced
    on both devices) and the no-op repeat.  Identical greedy tokens, hits
    and modes; logits within 2e-3 of their max."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import AgentEngine

    kw = {"max_len": MAX_LEN, "max_new_tokens": 4, "cache_slots": 2}
    for arch in (DEEPSEEK, MIXTRAL, QWEN25):
        cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                  dtype="float32")
        if cfg.sliding_window:
            cfg = dataclasses.replace(cfg, sliding_window=LOCKSTEP_WINDOW)
        t0 = time.perf_counter()
        gpu = AgentEngine(cfg, seed=20, device=dev, **kw)
        if cfg.qkv_bias:
            gen = torch.Generator(device=dev).manual_seed(20)
            with torch.no_grad():
                for layer in gpu.params["stack0"]:
                    for name in ("bq", "bk", "bv"):
                        b = layer["attn"][name]
                        b.copy_(0.2 * torch.randn(b.shape, generator=gen,
                                                  device=dev))
        cpu = AgentEngine(cfg, device="cpu",
                          params=copy.deepcopy(gpu.params).cpu(), **kw)
        rng = np.random.default_rng(20)
        prompt = rng.integers(1, cfg.vocab_size, 40).astype(np.int32)
        modes, worst = [], 0.0
        ops.reset_launch_counts()
        with recording_routes() as routes:
            for i in range(4):
                prev = gpu.sessions.get("d")
                prev = None if prev is None else prev.prompt
                a = gpu.serve("d", prompt, now=float(i))
                b = cpu.serve("d", prompt, now=float(i))
                check(np.array_equal(a.output_tokens, b.output_tokens)
                      and (a.n_hit, a.n_prompt) == (b.n_hit, b.n_prompt),
                      f"{arch}: CUDA and CPU engines diverged at request "
                      f"{i}: {a.output_tokens} / {b.output_tokens}, hits "
                      f"{a.n_hit} / {b.n_hit}")
                err = rel_logit_err(session_logits(gpu, "d"),
                                    session_logits(cpu, "d"))
                check(err < ENGINE_LOGIT_TOL, f"{arch}: last-token logits "
                      f"differ by {err} at request {i}")
                worst = max(worst, err)
                modes.append(mode_of(a, prev))
                full = gpu.sessions["d"].prompt
                more = rng.integers(1, cfg.vocab_size, 12).astype(np.int32)
                prompt = (np.concatenate([full, more]) if i == 0 else
                          np.concatenate([full[:30], more[:9]]) if i == 1
                          else full)
        counts = ops.launch_counts()
        check(modes == ["fresh", "extend", "extend", "identical"],
              f"{arch}: modes {modes}")
        layers = 0 if cfg.attn_kind == "mla" else cfg.n_layers
        check(counts["flash_attention"] == layers
              and counts["decode_attention"] > 0 if layers else
              counts["flash_attention"] == counts["decode_attention"] == 0,
              f"{arch}: attention launches {counts}")
        flips = route_flips(routes, cfg.top_k) if cfg.is_moe else \
            "no router"
        if cfg.sliding_window:
            end = int(gpu.sessions["d"].cache["pos"].max())
            check(end > cfg.sliding_window, f"{arch}: a dialogue of "
                  f"{end} tokens does not wrap the ring")
            flips += (f"; window {cfg.sliding_window}, the ring wrapped by "
                      f"position {end}")
        print(f"    {arch} (2 layers, float32): modes {modes}, identical "
              f"tokens and hits, logits within {worst:.2e} of their max "
              f"(limit {ENGINE_LOGIT_TOL}); {flips}; flash "
              f"{counts['flash_attention']}, decode "
              f"{counts['decode_attention']} launches; "
              f"{time.perf_counter() - t0:.1f} s")
        del gpu, cpu
        gc.collect()
        torch.cuda.empty_cache()


def decode_bounds(engine) -> str:
    """A decode step's least time, reading each weight once at the HBM
    rate: every weight but the embedding table (one row of it is read),
    all experts included (the reference's bucket layout computes every
    expert's bucket), against the weights one token needs (its top-k
    experts of each MoE layer)."""
    params = engine.params
    es = params["embed"].element_size()
    every = sum(p.numel() for p in params.parameters()) \
        - params["embed"].numel()
    idle = 0                  # expert weights outside a token's top-k
    cfg = engine.cfg
    for name, _ in params.named_children():
        for layer in params[name] if name.startswith("stack") else ():
            if "moe" in layer:
                experts = sum(layer["moe"][w].numel()
                              for w in ("wg", "wu", "wd"))
                idle += experts * (cfg.n_experts - cfg.top_k) \
                    // cfg.n_experts
    ms = lambda n: n * es / HBM_BYTES_PER_S * 1e3  # noqa: E731
    text = f"weight-read bound {ms(every):.3f} ms ({every / 1e9:.3f} B)"
    if idle:
        text += (f" with every expert computed, {ms(every - idle):.3f} ms "
                 f"for the active {(every - idle) / 1e9:.3f} B")
    return text


def phase_family_slices(dev) -> tuple[dict, dict]:
    """The new families at full width, bf16, random weights, batch 1,
    serving phase 8's plan through `AgentEngine`: deepseek-v2-lite-16b
    whole (no attention kernel: MLA), mixtral-8x22b cut to
    MIXTRAL_LAYERS of 56 layers, qwen2.5-32b whole.  Returns the launch
    counts per model and the replays of the recorded attention calls."""
    import torch

    from repro_torch.configs import get_config

    counts, replays = {}, {}
    for arch in (DEEPSEEK, MIXTRAL, QWEN25):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if arch == MIXTRAL:
            cfg = dataclasses.replace(cfg, n_layers=MIXTRAL_LAYERS)
        torch.cuda.reset_peak_memory_stats(dev)
        engine, c, rec = phase_slice(dev, agent_seed(FAMILY_SEEDS[arch]),
                                     cfg)
        print(f"    {arch} decode step: {decode_bounds(engine)}")
        counts[arch] = c
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        if cfg.attn_kind != "mla":
            print(f"    the attention kernels at the inputs of {arch} (up to "
                  "2 calls of each shape, weighted by the calls made)")
            replays[arch] = replay_both(rec, rows=False)
            print_replays(arch, replays[arch])
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        print(f"    ({arch}: {time.perf_counter() - t0:.1f} s)")
    return counts, replays


# --------------------- the encoder-decoder and the patch-input model --
SEAMLESS = "seamless-m4t-medium"
LLAVA = "llava-next-34b"
ENCDEC_SEEDS = {SEAMLESS: "agent-6", LLAVA: "agent-7"}
VLM_LOCKSTEP_LAYERS = 2    # phase 22's llava (~8 GB a side in float32)
VLM_TEXT = 128             # text tokens after llava's 2,880 patches
VLM_MAX_LEN = 4096         # the patched prompt's cache
ENCDEC_PROMPT = 512        # seamless's model-level prompt
MODEL_STEPS = 32           # decode steps of phase 23's model-level runs
EXTEND_TOKENS = 16         # llava's extend after them


def attention_launches(cfg) -> tuple[int, int]:
    """(flash launches per fresh prefill, decode launches per decode
    step): one flash per encoder layer and two per decoder layer (self,
    cross) and two decode per decoder layer for an encoder-decoder; one
    and one per layer for the attention decoder."""
    if cfg.is_encdec:
        return cfg.enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    return cfg.n_layers, cfg.n_layers


def side_inputs(cfg, dev, seed: int) -> dict:
    """0.1 · N(0, 1) float32 frames [1, src_len, D] (encoder-decoder) or
    patches [1, P, D] (patch input) drawn on ``dev`` from a seeded
    generator, the scale of the reference's model tests; zero frames, the
    engine's, would leave the encoder and the cross-attention at zero."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    key, n = (("frames", cfg.src_len) if cfg.is_encdec
              else ("patches", cfg.n_patches))
    return {key: 0.1 * torch.randn((1, n, cfg.d_model), generator=gen,
                                   device=dev)}


def encdec_vlm_configs(dtype: str):
    """seamless-m4t-medium whole and llava-next-34b at VLM_LOCKSTEP_LAYERS
    (float32 lockstep) or whole (bf16)."""
    from repro_torch.configs import get_config

    llava = get_config(LLAVA)
    if dtype == "float32":
        llava = dataclasses.replace(llava, n_layers=VLM_LOCKSTEP_LAYERS)
    return [dataclasses.replace(get_config(SEAMLESS), dtype=dtype),
            dataclasses.replace(llava, dtype=dtype)]


def model_lockstep(model, gpu_p, cpu_p, dev, seed: int) -> float:
    """Model level, CUDA vs CPU on the same weights: a prefill with seeded
    frames or patches, 4 greedy decode steps and, for the patch model, one
    extend; each step's greedy token the same, logits within 2e-3 of their
    max, and exactly the launches of one fresh prefill and 4 steps.
    Returns the worst logit error."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    cfg = model.config
    rng = np.random.default_rng(seed)
    n_text = VLM_TEXT if cfg.n_patches else 40
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, n_text))
                            .astype(np.int32))
    side = side_inputs(cfg, dev, seed)
    max_len = VLM_MAX_LEN if cfg.n_patches else MAX_LEN
    worst = 0.0

    def agree(a, b, what):
        nonlocal worst
        err = rel_logit_err(a, b)
        check(err < ENGINE_LOGIT_TOL and int(a.argmax()) == int(b.argmax()),
              f"{cfg.name}: {what}: CUDA and CPU logits differ by {err}, "
              f"greedy {int(a.argmax())} / {int(b.argmax())}")
        worst = max(worst, err)
        return a.argmax(-1).to(torch.int32)

    def on(device):
        return {"tokens": toks.to(device), "max_len": max_len,
                **{k: v.to(device) for k, v in side.items()}}

    ops.reset_launch_counts()
    with torch.no_grad():
        lg, cg = model.prefill(gpu_p, on(dev))
        lc, cc = model.prefill(cpu_p, on("cpu"))
        tok = agree(lg, lc, "prefill")
        for i in range(4):
            lg, cg = model.decode_step(gpu_p, cg, tok)
            lc, cc = model.decode_step(cpu_p, cc, tok.cpu())
            tok = agree(lg, lc, f"decode step {i}")
        counts = ops.launch_counts()
        if cfg.n_patches:
            ext = torch.from_numpy(rng.integers(1, cfg.vocab_size, (
                1, EXTEND_TOKENS)).astype(np.int32))
            n = torch.tensor([EXTEND_TOKENS - 3], dtype=torch.int32)
            lg, _ = model.extend(gpu_p, cg, ext.to(dev), n.to(dev))
            lc, _ = model.extend(cpu_p, cc, ext, n)
            agree(lg, lc, "extend")
    flash, per_step = attention_launches(cfg)
    check(counts["flash_attention"] == flash
          and counts["decode_attention"] == 4 * per_step,
          f"{cfg.name}: launches {counts} for one prefill and 4 steps")
    return worst


def engine_lockstep(cfg, gpu_p, cpu_p, dev) -> tuple[list, float, Counter]:
    """A CUDA and a CPU engine on the same weights serve one dialogue on
    the engine's own inputs (zero frames; text alone): fresh, the no-op
    repeat, a truncation-only hit and, for the patch model, an exact
    extension; for the encoder-decoder that extension needs ``extend`` and
    raises on both devices, as the reference's engine does.  Returns the
    modes, the worst logit error and the launches of the served turns."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import AgentEngine

    kw = {"max_len": MAX_LEN, "max_new_tokens": 4, "cache_slots": 2}
    gpu = AgentEngine(cfg, device=dev, params=gpu_p, **kw)
    cpu = AgentEngine(cfg, device="cpu", params=cpu_p, **kw)
    rng = np.random.default_rng(22)
    prompt = rng.integers(1, cfg.vocab_size, 40).astype(np.int32)
    modes, worst, launched = [], 0.0, Counter()
    for i, kind in enumerate(("fresh", "repeat", "truncate", "extend")):
        stored = gpu.sessions.get("d")
        stored = None if stored is None else stored.prompt
        if kind == "repeat":
            prompt = stored
        elif kind == "truncate":
            prompt = stored[:30]
        elif kind == "extend":
            prompt = np.concatenate([stored, rng.integers(
                1, cfg.vocab_size, 12).astype(np.int32)])
        if kind == "extend" and cfg.is_encdec:
            for eng in (gpu, cpu):
                raised = False
                try:
                    eng.serve("d", prompt, now=float(i))
                except NotImplementedError:
                    raised = True
                check(raised, f"{cfg.name}: an exact extension did not "
                      f"raise on {eng.device}")
            modes.append("extend raised")
            break
        before = ops.launch_counts()
        a = gpu.serve("d", prompt, now=float(i))
        launched.update({k: v - before[k]
                         for k, v in ops.launch_counts().items()})
        b = cpu.serve("d", prompt, now=float(i))
        check(np.array_equal(a.output_tokens, b.output_tokens)
              and (a.n_hit, a.n_prompt) == (b.n_hit, b.n_prompt),
              f"{cfg.name}: CUDA and CPU engines diverged at request {i}: "
              f"{a.output_tokens} / {b.output_tokens}, hits {a.n_hit} / "
              f"{b.n_hit}")
        err = rel_logit_err(session_logits(gpu, "d"),
                            session_logits(cpu, "d"))
        check(err < ENGINE_LOGIT_TOL, f"{cfg.name}: last-token logits "
              f"differ by {err} at request {i}")
        worst = max(worst, err)
        modes.append(mode_of(a, stored))
    want = ["fresh", "identical", "extend-noop",
            "extend raised" if cfg.is_encdec else "extend"]
    check(modes == want, f"{cfg.name}: modes {modes}, expected {want}")
    flash, per_step = attention_launches(cfg)
    served = len(want) - cfg.is_encdec
    steps = 4 * served + 2                  # and the two no-op steps
    check(launched["flash_attention"] == flash
          and launched["decode_attention"] == per_step * steps,
          f"{cfg.name}: engine launches {dict(launched)}")
    return modes, worst, launched


def phase_encdec_vlm_lockstep(dev) -> tuple[Counter, dict]:
    """Phase 22: seamless-m4t-medium at full depth and llava-next-34b at
    full width and VLM_LOCKSTEP_LAYERS layers, float32 (TF32 off), the same
    weights on the card and on the CPU: ``model_lockstep`` (seeded frames;
    2,880 seeded patches) and ``engine_lockstep``.  Returns the card's
    launches and both attention kernels' figures at the card's
    model-level calls (one per shape and mode), against their plain
    versions (2e-5) and SDPA."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    launches, replays = Counter(), {}
    for cfg in encdec_vlm_configs("float32"):
        t0 = time.perf_counter()
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(22)
        gpu_p = model.init(gen)
        cpu_p = copy.deepcopy(gpu_p).cpu()
        with recording(ops, ("flash_attention", "decode_attention"),
                       per_shape=1) as rec:
            model_err = model_lockstep(model, gpu_p, cpu_p, dev, 22)
        launches.update(ops.launch_counts())
        modes, eng_err, eng_launches = engine_lockstep(cfg, gpu_p, cpu_p,
                                                       dev)
        launches.update(eng_launches)
        layers = (f"{cfg.enc_layers} + {cfg.n_layers} layers"
                  if cfg.is_encdec else f"{cfg.n_layers} layers")
        print(f"    {cfg.name} ({layers}, float32): model-level prefill, 4 "
              f"steps{', extend' if cfg.n_patches else ''} within "
              f"{model_err:.2e}; engine modes {modes}, identical tokens and "
              f"hits, logits within {eng_err:.2e} (limit "
              f"{ENGINE_LOGIT_TOL}); {time.perf_counter() - t0:.1f} s")
        del model, gpu_p, cpu_p
        gc.collect()
        torch.cuda.empty_cache()
        print(f"    the attention kernels at the float32 model-level inputs "
              f"of {cfg.name} (one call of each shape and mode)")
        replays[cfg.name] = replay_both(rec, rows=False)
        print_replays(cfg.name, replays[cfg.name])
        del rec
    return launches, replays


def encdec_requests(engine):
    """seamless's serving plan over the three dialogues that open phase
    8's plan: each first turn fresh, its identical repeat, the first turn
    again (a prefix of the stored prompt and answer: a truncation-only
    hit), and the first two turns as a fresh dialogue of their own (an
    extension of the stored prompt would need the extend the
    encoder-decoder lacks).  Yields (dialogue, prompt), reading a stored
    prompt when its turn comes."""
    import numpy as np

    scripts = [s for s, t in slice_requests() if t == 0]
    for s in scripts:
        yield s.dialogue_id, np.asarray(s.turns[0], np.int32)
    for s in scripts:
        yield s.dialogue_id, engine.sessions[s.dialogue_id].prompt
    for s in scripts:
        yield s.dialogue_id, np.asarray(s.turns[0], np.int32)
    for s in scripts:
        yield (s.dialogue_id + "/2",
               np.concatenate(s.turns[:2]).astype(np.int32))


def serve_encdec(dev, cfg, seed: int):
    """The seamless engine at full width serves ``encdec_requests`` under
    exact launch gates; returns the engine and the launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import AgentEngine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = AgentEngine(cfg, seed=seed, device=dev, max_len=MAX_LEN,
                         max_new_tokens=8, cache_slots=12)
    torch.cuda.synchronize()
    print(f"    {cfg.name}: {cfg.enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.hd}, src_len {cfg.src_len}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}; "
          f"{sum(p.numel() for p in engine.params.parameters()) / 1e9:.3f} B "
          f"parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    # one warm-up session per bucket: a second bucket under the same
    # session would extend the first, which raises (the reference's gap)
    for b in (32, 64, 128, 256, 512):
        engine.warmup(prefill_buckets=(b,), extend_buckets=())
    rows = []
    ops.reset_launch_counts()              # the engine's main path starts
    for i, (did, prompt) in enumerate(encdec_requests(engine)):
        check(len(prompt) + engine.max_new <= MAX_LEN,
              "a dialogue outgrew max_len")
        prev = engine.sessions.get(did)
        prev = None if prev is None else prev.prompt
        res = engine.serve(did, prompt, now=float(i))
        rows.append((mode_of(res, prev), res))
    counts = ops.launch_counts()           # ... and ends here
    modes = [m for m, _ in rows]
    fresh = modes.count("fresh")
    noops = len(modes) - fresh
    steps = sum(r.n_gen for _, r in rows)
    flash, per_step = attention_launches(cfg)
    check(counts["flash_attention"] == flash * fresh
          and counts["decode_attention"] == per_step * (steps + noops),
          f"{cfg.name}: launches {counts} for {fresh} fresh prefills, "
          f"{steps} decode and {noops} no-op steps")
    print_modes(rows, ("fresh", "identical", "extend-noop"))
    print(f"    launches {counts} for {fresh} fresh prefills, {steps} decode "
          f"steps and {noops} no-op steps")
    return engine, counts


def model_run(engine, dev, seed: int):
    """Phase 23's model-level run on an engine's weights, with seeded
    frames (an ENCDEC_PROMPT-token prompt) or patches (VLM_TEXT text
    tokens after them): a prefill, MODEL_STEPS greedy decode steps and, for
    the patch model, one extend, under exact launch gates; prints TTFT,
    decode ms a token and the device's busy share, and returns the
    recorded attention calls (up to 2 per shape and mode) and the
    launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    cfg, model, params = engine.cfg, engine.model, engine.params
    rng = np.random.default_rng(seed)
    n_text = VLM_TEXT if cfg.n_patches else ENCDEC_PROMPT
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (1, n_text)).astype(np.int32)).to(dev),
        "max_len": VLM_MAX_LEN if cfg.n_patches else MAX_LEN,
        **side_inputs(cfg, dev, seed)}
    flash, per_step = attention_launches(cfg)
    text = ""
    with recording(ops, ("flash_attention", "decode_attention"),
                   per_shape=2) as rec, torch.no_grad():
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch)
        torch.cuda.synchronize()
        ttft = (time.perf_counter() - t0) * 1e3
        check(tuple(logits.shape) == (1, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), f"{cfg.name}: prefill "
              "logits are not finite values of shape [1, vocab]")
        t0 = time.perf_counter()
        for _ in range(MODEL_STEPS):
            tok = logits.argmax(-1).to(torch.int32)
            logits, cache = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / MODEL_STEPS
        check(bool(torch.isfinite(logits).all()), f"{cfg.name}: decode "
              "logits are not finite")
        counts = ops.launch_counts()
        if cfg.n_patches:
            ext = torch.from_numpy(rng.integers(1, cfg.vocab_size, (
                1, EXTEND_TOKENS)).astype(np.int32)).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.extend(params, cache, ext, torch.tensor(
                [EXTEND_TOKENS], dtype=torch.int32, device=dev))
            torch.cuda.synchronize()
            check(bool(torch.isfinite(logits).all())
                  and ops.launch_counts() == counts, f"{cfg.name}: extend "
                  "logits not finite, or it launched an attention kernel")
            text = (f", extend of {EXTEND_TOKENS} tokens "
                    f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    check(counts["flash_attention"] == flash
          and counts["decode_attention"] == per_step * MODEL_STEPS,
          f"{cfg.name}: model-level launches {counts}, expected {flash} "
          f"flash and {per_step * MODEL_STEPS} decode")
    side = (f"{cfg.src_len} frames" if cfg.is_encdec
            else f"{cfg.n_patches} patches")
    print(f"    model level, {side} (0.1·N(0, 1)) + {n_text} tokens: TTFT "
          f"{ttft:.2f} ms, decode {step_ms:.2f} ms/token over "
          f"{MODEL_STEPS} steps{text}; launches {counts}")
    tok = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for what, fn, n in (
                (f"prefill of {side} + {n_text} tokens",
                 lambda: model.prefill(params, batch), 2),
                ("decode step", lambda: model.decode_step(params, cache,
                                                          tok), 8)):
            print(f"    {what}: " + device_share(fn, n))
    return rec, counts


def encdec_decode_bound(engine) -> str:
    """A decoder step's least time at the HBM rate: each decoder weight
    read once but the cross-attention's wk / wv (the cross K/V are
    cached), the final norm and the head, then every layer's cross K/V
    over all src_len frames."""
    params, cfg = engine.params, engine.cfg
    es = params["embed"].element_size()
    layers = params["decoder"]
    n = (sum(p.numel() for p in layers.parameters())
         - sum(layer["xattn"][w].numel() for layer in layers
               for w in ("wk", "wv"))
         + params["final_norm"].numel() + params["lm_head"].numel())
    cross = 2 * cfg.n_layers * cfg.src_len * cfg.n_kv_heads * cfg.hd * es
    ms = lambda nbytes: nbytes / HBM_BYTES_PER_S * 1e3  # noqa: E731
    return (f"weight-read bound {ms(n * es):.3f} ms ({n / 1e6:.1f} M "
            f"parameters), cross K/V {ms(cross):.3f} ms "
            f"({cross / 1e6:.1f} MB)")


def print_replays(name: str, replays: dict) -> None:
    for op, r in replays.items():
        print(f"    {op} per {name} call ({r['calls']} calls, "
              f"{r['sampled']} sampled): max abs err "
              f"{r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms "
              f"({dev_text(r)}), plain {r['plain_ms']:.4f} ms, "
              f"SDPA {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})")


def replay_both(rec, rows: bool) -> dict:
    """Both attention kernels against their plain versions and SDPA at the
    recorded calls (``replay_attention``)."""
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)

    return {"flash_attention": replay_attention(
                rec["flash_attention"], flash_attention_cuda,
                flash_attention_plain, sdpa_flash, flash_work, rows=rows),
            "decode_attention": replay_attention(
                rec["decode_attention"], decode_attention_cuda,
                decode_attention_plain, sdpa_decode, decode_work,
                rows=rows)}


def phase_encdec_vlm_slices(dev) -> tuple[dict, dict]:
    """Phase 23: seamless-m4t-medium and llava-next-34b whole at full
    width, bf16, random weights, batch 1.  seamless through `AgentEngine`
    (``serve_encdec``), llava through phase 8's plan on text alone
    (``phase_slice``); then each model level (``model_run``) and the
    attention kernels against their plain versions and SDPA at the
    model-level calls, each bf16 row within ATTN_ROW_TOL of its largest
    plain output.  Returns the launches per model (engine and model level
    together) and the replays."""
    import torch

    counts, replays = {}, {}
    for cfg in encdec_vlm_configs("bfloat16"):
        t0 = time.perf_counter()
        seed = agent_seed(ENCDEC_SEEDS[cfg.name])
        torch.cuda.reset_peak_memory_stats(dev)
        if cfg.is_encdec:
            engine, c = serve_encdec(dev, cfg, seed)
            bound = encdec_decode_bound(engine)
        else:
            engine, c, _ = phase_slice(dev, seed, cfg)
            bound = decode_bounds(engine)
        engine.sessions.clear()
        rec, c2 = model_run(engine, dev, seed)
        counts[cfg.name] = Counter(c) + Counter(c2)
        print(f"    {cfg.name} decode step: {bound}; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        print(f"    the attention kernels at the model-level inputs of "
              f"{cfg.name} (up to 2 calls of each shape and mode, weighted "
              "by the calls made)")
        replays[cfg.name] = replay_both(rec, rows=True)
        print_replays(cfg.name, replays[cfg.name])
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        print(f"    ({cfg.name}: {time.perf_counter() - t0:.1f} s)")
    return counts, replays


# ------------------------------------------------------------ training --
TRAIN_SEQ, TRAIN_BATCH = 512, 2    # phase 24's batches
TRAIN_LOCK_STEPS = ("plain", "accum", "compress", "plain")
# mixtral-8x22b's CPU twin is phase 24's slowest (its router, 8 experts):
# its lockstep keeps the first two steps
LOCK_STEPS = {MIXTRAL: TRAIN_LOCK_STEPS[:2]}
TRAIN_VOCAB = 8192                 # phase 24's vocab (the CPU twin's head)
TRAIN_LAYERS = 16                  # phase 25's qwen3-8b depth (of 36)
# phase 25's zamba2-7b depth (of 81): the deepest multiple of its group of
# 6 whose peak stays under 72 GiB of the card's 80 GB (PERF.md §4)
ZAMBA_TRAIN_LAYERS = 48
TRAIN_STEPS = 6                    # phase 25's steps per model
TRAIN_4K = 4096                    # train_4k's sequence length
# phase 25's peak learning rates: at qwen3-8b's 1e-3 its loss rose; at
# seamless-m4t-medium's 4e-4 its loss fell by less than the batches move
# it; rwkv6-3b's and zamba2-7b's fall past that spread at 1e-4; the MoE
# models' (phase 29) and llava-next-34b's (phase 30) take qwen3-8b's
TRAIN_LR = {ARCH: 1e-4, SEAMLESS: 2e-3, RWKV: 1e-4, ZAMBA: 1e-4,
            MIXTRAL: 1e-4, DEEPSEEK: 1e-4, LLAVA: 1e-4}
GRAD_TOL = 1e-4                    # a gradient leaf, of its largest CPU value
# rwkv6-3b's float32 gradient at phase 24's weights is ill-conditioned: a
# float64 CPU gradient puts the CPU's float32 leaves up to 1.38e-4 of a
# leaf's max from it and the card's 9.57e-5, so the two float32 gradients
# differ by up to ~2.5e-4 (PERF.md §6, ROADMAP §3).  Its leaves are held
# to this bound, against the CPU's float32 gradient and against float64.
ILL_GRAD_TOL = {RWKV: 3e-4}
# the only float32 results a float64 twin may make: factories of exact
# constants (zero states, the chunk's identity mask, and the empty buffers
# some builds of torch fill them from) that promote on use
EXACT_FLOAT32_OPS = {"aten.zeros.default", "aten.eye.default",
                     "aten.empty.memory_format"}
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# phase 25's rows of dQ (a query and head) and dK / dV (a key and KV head):
# each within ATTN_ROW_TOL of the row's largest plain value, a row counting
# as at least BWD_ROW_FLOOR of the output's largest (dQ's first row under a
# causal mask is 0: one key, P = 1, dS = 0; both versions hold noise there)
BWD_ROW_FLOOR = 1e-3


def training_configs():
    """Phase 24's reduced float32 configs: qwen3-8b and mixtral-8x22b at
    2 layers of their head layouts (32 / 8 and 48 / 8 heads of 128),
    d_model 1024, TRAIN_VOCAB (mixtral's window cut to 16, 8 experts of
    2048); seamless-m4t-medium at full width (16 / 16 heads of 64) with 2
    + 2 layers, src_len 256 and TRAIN_VOCAB; rwkv6-3b at 2 layers and
    zamba2-7b at 3 (attn_every 2: one group of two Mamba-2 layers and the
    shared block, a tail of one), d_model 1024, d_ff 3072, TRAIN_VOCAB,
    with the scans' head size and state of 64 (16 and 32 scan heads) and
    zamba2's shared attention at its 32 / 32 heads of 112."""
    from repro_torch.configs import get_config

    narrow = dict(n_layers=2, d_model=1024, vocab_size=TRAIN_VOCAB,
                  dtype="float32")
    return [
        dataclasses.replace(get_config(ARCH), d_ff=3072, **narrow),
        dataclasses.replace(get_config(MIXTRAL), d_ff=2048, moe_d_ff=2048,
                            sliding_window=LOCKSTEP_WINDOW, **narrow),
        dataclasses.replace(get_config(SEAMLESS), n_layers=2, enc_layers=2,
                            src_len=256, vocab_size=TRAIN_VOCAB,
                            dtype="float32"),
        dataclasses.replace(get_config(RWKV), d_ff=3072, ssm_heads=16,
                            **narrow),
        dataclasses.replace(get_config(ZAMBA), d_ff=3072, ssm_heads=32,
                            **{**narrow, "n_layers": 3}, attn_every=2)]


def kernel_calls(cfg) -> dict:
    """Each training kernel's calls in one forward: flash attention once
    per layer (per encoder layer and twice per decoder layer for an
    encoder-decoder, once per shared-block application for zamba2, never
    for MLA, which runs plain PyTorch on both devices), WKV6
    once per RWKV-6 layer, SSD once per Mamba-2 layer.  Under remat each
    runs twice a step and its backward once."""
    if cfg.ssm_kind == "rwkv6":
        return {"flash_attention": 0, "wkv6": cfg.n_layers, "ssd": 0}
    if cfg.ssm_kind == "mamba2":
        return {"flash_attention": cfg.n_layers // cfg.attn_every,
                "wkv6": 0, "ssd": cfg.n_layers}
    return {"flash_attention": 0 if cfg.attn_kind == "mla" else
            attention_launches(cfg)[0], "wkv6": 0, "ssd": 0}


def launches_per_step(cfg, steps: int = 1) -> dict:
    """The exact launches of ``steps`` remat training steps: 2 forward and
    1 backward launch per kernel call."""
    out = {}
    for op, n in kernel_calls(cfg).items():
        out[op], out[f"{op}_bwd"] = 2 * n * steps, n * steps
    return out


def launch_text(counts, want) -> str:
    """The training kernels' launches, the ones the step makes."""
    return ", ".join(f"{op} {counts[op]}" for op in want if want[op])


class FramedData:
    """``SyntheticLM``'s tokens and, for an encoder-decoder, seeded
    0.1 · N(0, 1) frames [B, src_len, D] per step, for a patch-input
    model patches [B, n_patches, D] (the reference's data has neither,
    and those models' losses need them); records the host time of each
    ``batch_at`` call, which ``train_loop`` makes at the start of each
    step, after the previous step's loss was read.  ``lm`` stands in for
    the port's ``SyntheticLM`` (the CPU tests pass the reference's, whose
    batches are the same, to feed the reference's step)."""

    def __init__(self, cfg, seq: int, batch: int, seed: int, lm=None):
        if lm is None:
            from repro_torch.training import SyntheticLM

            lm = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
        self.cfg, self.seed, self.lm = cfg, seed, lm
        self.times = []

    def batch_at(self, step: int) -> dict:
        import numpy as np

        self.times.append(time.perf_counter())
        out = self.lm.batch_at(step)
        cfg = self.cfg
        n, key = ((cfg.src_len, "frames") if cfg.is_encdec else
                  (cfg.n_patches, "patches"))
        if n:
            rng = np.random.default_rng(self.seed * 1_000 + step)
            out[key] = (0.1 * rng.standard_normal(
                (self.lm.batch, n, cfg.d_model))).astype(np.float32)
        return out


def leaf_errors(got, want) -> tuple[float, str]:
    """The largest over leaves of a leaf's max abs error over its largest
    reference magnitude, and that leaf's name."""
    from repro_torch.utils.tree import tree_leaves, tree_paths_and_leaves

    worst, name = 0.0, ""
    for (n, g), w in zip(tree_paths_and_leaves(got), tree_leaves(want)):
        w = w.detach().double()
        err = float((g.detach().cpu().double() - w).abs().max()
                    / w.abs().max().clamp_min(1e-30))
        if err >= worst:
            worst, name = err, n
    return worst, name


@contextmanager
def float64_islands():
    """The port's float32 islands (``Tensor.float()``: the norms, the
    scans' plain versions, the loss) computed in float64 instead, for a
    CPU twin whose parameters are float64; yields the names of the
    operations that still returned a float32 tensor."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Float32Results(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(o, torch.Tensor) and o.dtype == torch.float32
                   for o in (out if isinstance(out, (tuple, list))
                             else (out,))):
                self.ops.add(str(func))
            return out

    to_float = torch.Tensor.float
    torch.Tensor.float = lambda self: self.double()
    try:
        with Float32Results() as mode:
            yield mode.ops
    finally:
        torch.Tensor.float = to_float


def float64_gradient(model, params, batch):
    """The model's gradient on the CPU in float64 (parameters, islands and
    scans): the reference that tells a float32 gradient's rounding at
    ill-conditioned weights from a fault.  Fails if any operation of it
    but an exact constant (EXACT_FLOAT32_OPS) computed in float32."""
    import torch

    from repro_torch.training.loop import loss_and_grads
    from repro_torch.utils.tree import tree_leaves

    p64 = copy.deepcopy(params)
    with torch.no_grad():
        for p in tree_leaves(p64):
            p.data = p.data.double()
    with float64_islands() as float32_ops:
        grads = loss_and_grads(model, p64, batch)[1]
    check(float32_ops <= EXACT_FLOAT32_OPS and all(
        g.dtype == torch.float64 for g in tree_leaves(grads)),
        f"the float64 twin computed in float32: {sorted(float32_ops)}")
    return grads


def training_lockstep(cfg, dev) -> dict:
    """One model of phase 24: the same init weights (drawn on the CPU,
    copied to the card) trained on both devices.  Step 0's loss and every
    gradient leaf, then 3 ``make_train_step`` steps (plain, accum_steps=2,
    int8 compression) with the losses compared; exact launches.
    Every leaf within GRAD_TOL of the CPU's, but for a model of
    ILL_GRAD_TOL (rwkv6-3b, whose float32 gradient is ill-conditioned at
    these weights): its leaves within that bound of the CPU's float32
    gradient and of a float64 CPU gradient, the CPU's own distance from
    float64 printed beside them."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.training import CompressionConfig, OptConfig
    from repro_torch.training.loop import (init_opt_state, loss_and_grads,
                                           make_train_step)
    from repro_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    model = build_model(cfg)
    cpu_p = model.init(torch.Generator().manual_seed(24))
    gpu_p = copy.deepcopy(cpu_p).to(dev)
    for p in (*tree_leaves(cpu_p), *tree_leaves(gpu_p)):
        p.requires_grad_(True)
    data = FramedData(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=24)

    def batch(step, device):
        return {k: torch.as_tensor(v, device=device)
                for k, v in data.batch_at(step).items()}

    want = launches_per_step(cfg)
    with recording_routes() as routes:
        ops.reset_launch_counts()
        lg, gg = loss_and_grads(model, gpu_p, batch(0, dev))
        counts = ops.launch_counts()
        lc, gc_ = loss_and_grads(model, cpu_p, batch(0, "cpu"))
    check(all(counts[k] == n for k, n in want.items()),
          f"{cfg.name}: launches {counts} for one remat step, expected "
          f"{want}")
    loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
    grad_err, leaf = leaf_errors(gg, gc_)
    flips = route_flips(routes, cfg.top_k) if cfg.is_moe else "no router"
    check(loss_err <= 1e-5, f"{cfg.name}: step-0 loss {float(lg)} on the "
          f"card, {float(lc)} on the CPU")
    tol = ILL_GRAD_TOL.get(cfg.name, GRAD_TOL)
    conditioning = ""
    if cfg.name in ILL_GRAD_TOL:
        g64 = float64_gradient(model, cpu_p, batch(0, "cpu"))
        cpu_off, cpu_leaf = leaf_errors(gc_, g64)
        card_off, card_leaf = leaf_errors(gg, g64)
        conditioning = (f"; against a float64 CPU gradient the card's "
                        f"leaves within {card_off:.2e} (worst {card_leaf}; "
                        f"limit {tol}), the CPU's float32 within "
                        f"{cpu_off:.2e} (worst {cpu_leaf})")
        check(card_off <= tol, f"{cfg.name}: gradient leaf {card_leaf} off "
              f"by {card_off:.3g} of its largest float64 value")
        del g64
    check(grad_err <= tol, f"{cfg.name}: gradient leaf {leaf} off by "
          f"{grad_err:.3g} of its largest CPU value{conditioning}; {flips}")
    del gg, gc_

    opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    comp = CompressionConfig(enabled=True)
    steps = {"plain": make_train_step(model, opt),
             "accum": make_train_step(model, opt, accum_steps=2),
             "compress": make_train_step(model, opt, comp)}
    gs, cs = init_opt_state(gpu_p, comp), init_opt_state(cpu_p, comp)
    losses, worst = [], 0.0
    kinds = LOCK_STEPS.get(cfg.name, TRAIN_LOCK_STEPS)
    for i, kind in enumerate(kinds):
        gpu_p, gs, mg = steps[kind](gpu_p, gs, batch(i, dev))
        cpu_p, cs, mc = steps[kind](cpu_p, cs, batch(i, "cpu"))
        err = abs(float(mg["loss"]) - float(mc["loss"])) / float(mc["loss"])
        check(err <= 1e-4 and np.isfinite(float(mg["loss"])),
              f"{cfg.name}: step {i} ({kind}) loss {float(mg['loss'])} on "
              f"the card, {float(mc['loss'])} on the CPU")
        losses.append(float(mg["loss"]))
        worst = max(worst, err)
    layers = (f"{cfg.enc_layers} + {cfg.n_layers} layers" if cfg.is_encdec
              else f"{cfg.n_layers} layers")
    heads = (f"{cfg.ssm_heads} scan heads of 64"
             if cfg.ssm_kind == "rwkv6" else
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}"
             + (f", {cfg.ssm_heads} scan heads of 64" if cfg.ssm_kind
                else ""))
    print(f"    {cfg.name} ({layers}, d_model {cfg.d_model}, {heads}, vocab "
          f"{cfg.vocab_size}{f', window {cfg.sliding_window}' if cfg.sliding_window else ''}, "
          f"float32): step-0 loss within {loss_err:.2e}, gradients within "
          f"{grad_err:.2e} of a leaf's max (worst {leaf}; limit "
          f"{tol}){conditioning}; {flips}; launches "
          f"{launch_text(counts, want)}; "
          f"steps {'/'.join(kinds)} losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} within {worst:.2e}; "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


def training_cli_and_resume(dev, tmp: Path) -> None:
    """Phase 24's entry points on the card: the CLI's smoke runs (qwen3-8b
    with a checkpoint directory, rwkv6-3b and zamba2-7b without), then
    ``train_loop`` crashed after step 15 and resumed from its step-10
    checkpoint against an uninterrupted run."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.training import (OptConfig, SyntheticLM, latest_step,
                                      train_loop)
    from repro_torch.utils.tree import tree_leaves

    for arch in (ARCH, RWKV, ZAMBA):
        argv = ["--arch", arch, "--smoke", "--steps", "20"]
        ckpt = ["--ckpt-dir", str(tmp / "cli")] if arch == ARCH else []
        out = io.StringIO()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            train_cli.main(argv + ckpt)
        counts = ops.launch_counts()
        lines = out.getvalue().splitlines()
        want = launches_per_step(get_config(arch).scaled(dtype="float32"),
                                 20)
        check([ln.split()[1] for ln in lines[:-1]] == ["0", "10", "19"]
              and lines[-1].startswith("done: 20 steps in ")
              and (not ckpt or latest_step(str(tmp / "cli")) == 20)
              and all(counts[k] == n for k, n in want.items()),
              f"the training CLI ({arch}) printed {lines}, launched "
              f"{counts}, expected {want}")
        print(f"    python -m repro_torch.launch.train {' '.join(argv)}"
              f"{' --ckpt-dir <tmp>' if ckpt else ''}: " + " | ".join(lines)
              + f"; launches {launch_text(counts, want)}")

    cfg = get_config(ARCH).scaled(dtype="float32")
    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, 64, 8, seed=3)
    kw = dict(steps=30, opt_cfg=OptConfig(lr=3e-3, warmup_steps=5,
                                          total_steps=30),
              device=dev, log_every=1)
    d = str(tmp / "resume")
    crashed = False
    try:
        train_loop(model, data, ckpt_dir=d, ckpt_every=10,
                   crash_at_step=15, **kw)
    except RuntimeError as e:
        crashed = "injected crash" in str(e)
    check(crashed and latest_step(d) == 10, "the injected crash did not "
          "leave the step-10 checkpoint")
    resumed = train_loop(model, data, ckpt_dir=d, ckpt_every=10, **kw)
    ref = train_loop(model, data, **kw)
    same = resumed["losses"] == ref["losses"][10:]
    diff = max(abs(a[1] - b[1]) for a, b in zip(resumed["losses"],
                                               ref["losses"][10:]))
    params_same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(resumed["params"]), tree_leaves(ref["params"])))
    print(f"    train_loop crashed after step 15, resumed from step "
          f"{resumed['losses'][0][0]}: losses of steps 10-29 "
          f"{'equal bit for bit' if same else f'differ by up to {diff:.3g}'}"
          f", parameters {'equal bit for bit' if params_same else 'differ'}"
          f" (final loss {ref['losses'][-1][1]:.4f})")
    check(diff <= 2e-3, f"resumed losses differ by {diff} (the reference "
          "test allows 2e-3)")


def forward_only_op_raises(dev) -> None:
    """On the card, decode attention (which training never calls) has no
    backward kernel: under grad it raises instead of returning an output
    without a gradient; without grad it runs."""
    import torch

    from repro_torch.kernels import ops

    q = torch.randn((1, 2, 16), device=dev, requires_grad=True)
    cache = torch.randn((1, 8, 2, 16), device=dev)
    valid = torch.ones((1, 8), dtype=torch.bool, device=dev)
    msg = ""
    try:
        ops.decode_attention_op(q, cache, cache, valid)
    except NotImplementedError as e:
        msg = str(e)
    check(msg.startswith("decode_attention: no backward kernel"),
          f"decode attention did not raise under grad on the card: {msg!r}")
    with torch.no_grad():
        out = ops.decode_attention_op(q, cache, cache, valid)
    check(out.grad_fn is None, "decode attention without grad")
    print(f"    decode attention under grad raised (\"{msg.split(' (')[0]}"
          "\"); without grad it ran")


def phase_training_lockstep(dev) -> Counter:
    """Phase 24: CUDA = CPU training (float32, TF32 off), then the CLI,
    crash and resume, and decode attention raising under grad.  Returns
    the launches of the locksteps' card side."""
    import tempfile

    launches = Counter()
    for cfg in training_configs():
        launches.update(training_lockstep(cfg, dev))
        gc.collect()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        training_cli_and_resume(dev, Path(tmp))
    forward_only_op_raises(dev)
    return launches


def sdpa_bwd_ms(q, k, v, o, do, lse=None, *, causal=True, window=0,
                q_offset=0, iters: int = 10) -> float:
    """PyTorch's SDPA backward for the same call (the yardstick): its
    forward + backward less its forward, CUDA events."""
    import torch

    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]

    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def both():
        out = sdpa_flash(*leaves, **kw)
        torch.autograd.grad(out, leaves, do)

    def fwd():
        sdpa_flash(*leaves, **kw)

    return cuda_time_ms(both, iters, 2) - cuda_time_ms(fwd, iters, 2)


LSE_TOL = 1e-4      # the forward's LSE (float32, bf16 inputs), absolute


def forward_lse_check(dev) -> None:
    """Phase 2: the forward kernel's LSE against the plain one
    (``attention_lse_ref``) within LSE_TOL at phase 25's calls, bf16 —
    qwen3-8b's 4,096-token causal call, seamless-m4t-medium's encoder,
    cross and decoder calls at batch 2 — and the kernel's output with the
    LSE asked for the same bits as without."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                     flash_attention_cuda)

    qwen, seam = get_config(ARCH), get_config(SEAMLESS)
    calls = [(qwen, 1, TRAIN_4K, TRAIN_4K, True),
             (seam, 2, seam.src_len, seam.src_len, False),
             (seam, 2, ENCDEC_PROMPT, seam.src_len, False),
             (seam, 2, ENCDEC_PROMPT, ENCDEC_PROMPT, True)]
    for i, (cfg, b, sq, sk, causal) in enumerate(calls):
        rng = np.random.default_rng(2400 + i)
        h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, torch.bfloat16) for shape in (
            (b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        return_lse=True)
        same = torch.equal(out, flash_attention_cuda(q, k, v, causal=causal))
        err = float((lse - attention_lse_ref(q, k, causal=causal))
                    .abs().max())
        print(f"    forward LSE at {cfg.name}'s {sq} x {sk} "
              f"{'causal' if causal else 'non-causal'} call ({h} / {hkv} "
              f"heads of {d}, batch {b}, bf16): max abs err {err:.3g} "
              f"against the plain LSE; output with it the same bits: {same}")
        check(same and err <= LSE_TOL, f"the forward's LSE at {cfg.name}'s "
              f"{sq} x {sk} call: err {err} (limit {LSE_TOL}), output the "
              f"same bits {same}")
        del q, k, v, out, lse


def bwd_figures(args, kw, iters: int = 10) -> dict:
    """One backward call against its plain version (each output within
    BWD_TOL of its largest plain magnitude, each row within ATTN_ROW_TOL
    of its own, floored at BWD_ROW_FLOOR), timed beside the plain version
    and SDPA's backward, with its bound."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)

    args = tuple(a.detach() for a in args)    # saved by the autograd node
    got = flash_attention_bwd_cuda(*args, **kw)
    want = flash_attention_bwd_plain(*args, **kw)
    tol = BWD_TOL[str(args[0].dtype).removeprefix("torch.")]
    err, rel, row = 0.0, 0.0, 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        what = f"flash_attention_bwd {name} {shape_key(args, kw)}"
        e = float((g.float() - w.float()).abs().max())
        r = e / float(w.float().abs().max())
        check(r <= tol, f"{what}: {r:.3g} of its largest plain value "
              f"(limit {tol})")
        row = max(row, row_rel_err(g, w, what, floor=BWD_ROW_FLOOR))
        err, rel = max(err, e), max(rel, r)
    del got, want
    bound, by = roofline(*bwd_work(*args, **kw), ops_rate(args[0].dtype))
    dev_ms, dev_from = device_ms(
        [lambda: flash_attention_bwd_cuda(*args, **kw)] * iters,
        "flash_attention_bwd")
    return {"max_abs_err": err, "max_rel_err": rel, "max_row_rel_err": row,
            "ms": cuda_time_ms(lambda: flash_attention_bwd_cuda(*args, **kw),
                               iters, 2),
            "device_ms": dev_ms, "device_ms_from": dev_from,
            "plain_ms": cuda_time_ms(
                lambda: flash_attention_bwd_plain(*args, **kw), 3, 1),
            "library_ms": sdpa_bwd_ms(*args, **kw),
            "bound_ms": bound, "bound_by": by}


def initial_losses(model, data, dev, steps: int) -> list:
    """The loss of ``train_loop``'s first weights (seed 0) on each of the
    run's ``steps`` batches, without grad: how far the batch alone moves
    the loss, at fixed weights."""
    import torch

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    out = []
    with torch.no_grad():
        for step in range(steps):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in data.batch_at(step).items()}
            out.append(float(model.loss(params, batch)))
    return out


def step_times_ms(times, t_end) -> list:
    """Step times from the start times of the steps and the loop's end."""
    return [(b - a) * 1e3 for a, b in zip(times, [*times[1:], t_end])]


def train_full_width(cfg, dev, seq: int, batch: int) -> tuple[Counter, dict]:
    """Phase 25 for one model: ``train_loop`` on the card for TRAIN_STEPS
    steps from random bf16 weights, every backward call recorded (one per
    shape and mode).  Gates: finite losses; the mean of the last two below
    the first by more than the batches alone move the loss (the spread of
    the first weights' losses over the run's batches), and each of the
    last two below the first weights' loss on the same batch; the
    launches exact (2 forward and 1 backward launch per kernel call and
    step: flash attention, WKV6, SSD).  Prints step ms, tokens/s, peak
    memory, the losses, MODEL_FLOPS against the bf16 peak, and the busy
    share of one further step under the profiler; then replays every
    recorded backward call."""
    import torch

    from repro_torch.configs.base import ShapeConfig, model_flops
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig
    from repro_torch.training.loop import make_train_step, train_loop

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg)
    data = FramedData(cfg, seq, batch, seed=25)
    opt = OptConfig(lr=TRAIN_LR[cfg.name], warmup_steps=2,
                    total_steps=TRAIN_STEPS + 3)
    want = launches_per_step(cfg, TRAIN_STEPS)
    bwd_ops = [f"{op}_bwd" for op, n in kernel_calls(cfg).items() if n]
    base = initial_losses(model, FramedData(cfg, seq, batch, seed=25), dev,
                          TRAIN_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    with recording(ops, bwd_ops, per_shape=1) as rec:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_loop(model, data, steps=TRAIN_STEPS, opt_cfg=opt,
                         log_every=1, device=dev)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    losses = [loss for _, loss in out["losses"]]
    check(all(counts[k] == n for k, n in want.items()),
          f"{cfg.name}: launches {counts} over {TRAIN_STEPS} steps, "
          f"expected {want}")
    spread = max(base) - min(base)
    fall = losses[0] - statistics.mean(losses[-2:])
    paired = [b - x for b, x in zip(base[-2:], losses[-2:])]
    print(f"    {cfg.name}: the first weights' losses on the run's batches "
          f"{', '.join(f'{x:.4f}' for x in base)} (spread {spread:.4f}); "
          f"the last two steps' mean {fall:.4f} below the first loss, "
          f"{', '.join(f'{x:.4f}' for x in paired)} below the first "
          "weights' on the same batches")
    check(all(map(math.isfinite, losses)) and len(losses) == TRAIN_STEPS
          and fall > spread and min(paired) > 0,
          f"{cfg.name}: losses {losses} do not fall by more than the "
          f"batches move them ({base})")
    step_ms = step_times_ms(data.times, t_end)
    steady = statistics.mean(step_ms[1:])
    tokens = seq * batch
    flops = model_flops(cfg, ShapeConfig("train", "train", seq, batch))
    n_params = sum(p.numel() for p in out["params"].parameters())
    print(f"    {cfg.name}: {n_params / 1e9:.3f} B parameters, bf16, "
          f"{TRAIN_STEPS} steps of {batch} x {seq} tokens in "
          f"{(t_end - t0):.1f} s: first step {step_ms[0]:.1f} ms, then "
          f"{steady:.1f} ms a step ({tokens / steady * 1e3:.0f} tokens/s); "
          f"peak device memory {peak:.2f} GiB; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; MODEL_FLOPS "
          f"{flops:.4g} a step, {flops / (steady / 1e3) / 1e12:.1f} TFLOP/s"
          f" = {flops / (steady / 1e3) / BF16_OPS_PER_S:.1%} of the bf16 "
          f"peak; launches {launch_text(counts, want)}")
    params, state = out["params"], out["opt_state"]
    step_fn = make_train_step(model, opt)
    on = {k: torch.as_tensor(v, device=dev)
          for k, v in data.batch_at(TRAIN_STEPS).items()}
    print("    one more step under the profiler (after a warm-up step): "
          + device_share(lambda: step_fn(params, state, on), 1))
    del out, params, state, step_fn, on
    gc.collect()
    torch.cuda.empty_cache()
    replays = {}
    for op in bwd_ops:
        print(f"    {op} at {cfg.name}'s backward calls (one of each shape "
              "and mode, weighted by the calls made)")
        figures = bwd_figures if op == "flash_attention_bwd" else \
            functools.partial(scan_bwd_figures, op)
        replays[op] = replay_sampled(rec[op], op, figures)
        replays[op]["step_ms"], replays[op]["peak_gib"] = steady, peak
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    return counts, replays


def phase_training_full_width(dev) -> tuple[dict, dict]:
    """Phase 25: qwen3-8b at full width and TRAIN_LAYERS of its 36 layers
    (train_4k's 4,096 tokens, batch 1), seamless-m4t-medium whole (512
    decoder tokens, 1,024 frames, batch 2), rwkv6-3b whole and zamba2-7b
    at full width and ZAMBA_TRAIN_LAYERS of its 81 layers (4,096 tokens,
    batch 1), bf16.  Returns each model's launches and its backward
    kernels' replays (by op)."""
    from repro_torch.configs import get_config

    qwen = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_LAYERS)
    zamba = dataclasses.replace(get_config(ZAMBA),
                                n_layers=ZAMBA_TRAIN_LAYERS)
    counts, replays = {}, {}
    for cfg, seq, batch in ((qwen, TRAIN_4K, 1),
                            (get_config(SEAMLESS), ENCDEC_PROMPT, 2),
                            (get_config(RWKV), TRAIN_4K, 1),
                            (zamba, TRAIN_4K, 1)):
        t0 = time.perf_counter()
        counts[cfg.name], replays[cfg.name] = train_full_width(
            cfg, dev, seq, batch)
        print(f"    ({cfg.name}: {time.perf_counter() - t0:.1f} s)")
    return counts, replays


POLICY_LAYERS = 4                  # phase 26's qwen3-8b depth (of 36)
POLICY_STEPS = 3                   # phase 26's steps a run
DRY_RATIO = 2.0                    # the dry run's bytes against a peak


@contextmanager
def plain_training_refused():
    """The plain attention and scan forwards and backwards patched to
    raise, in ``ops`` and in the kernel modules: a training run inside
    reaches only the kernels."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.kernels import wkv6 as wkv6_mod

    def refuse(*args, **kw):
        raise AssertionError("a plain attention or scan version ran on "
                             "the card")

    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (ops, "flash_attention_plain"), (fa, "flash_attention_plain"),
        (fa, "flash_attention_bwd_plain"), (ops, "wkv6_plain"),
        (ops, "ssd_plain"), (wkv6_mod, "wkv6_plain"),
        (wkv6_mod, "wkv6_bwd_plain"), (ssd_mod, "ssd_plain"),
        (ssd_mod, "ssd_bwd_plain"))]
    for mod, name, _ in saved:
        setattr(mod, name, refuse)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def dry_run_cell(cfg, mesh, seq: int,
                 batch: int = 1) -> tuple[dict, dict, float]:
    """The port's dry run of ``cfg`` at ``seq`` positions (a patch-input
    model's patches and tokens) and ``batch`` rows, no accumulation, on
    ``mesh``: (record, roofline row, host seconds)."""
    from repro_torch import roofline
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun

    shape = ShapeConfig("train_4k", "train", seq, batch)
    t0 = time.perf_counter()
    rec = dryrun.run_cell(cfg.name, shape.name, mesh, cfg=cfg, shape=shape,
                          accum=1, out_dir=str(ROOT / "build" / "dryrun"),
                          verbose=False)
    check(rec.get("ok"), f"the dry run of {cfg.name} at {cfg.n_layers} "
          f"layers failed: {rec.get('error')}")
    return rec, roofline.analyze(rec), time.perf_counter() - t0


def dry_run_against(cfg, mesh, seq: int, peak_gib: float, step_ms: float,
                    label: str, dry=None, batch: int = 1) -> dict:
    """Phase 26c for one cell: the dry run (``dry``, or `dry_run_cell`'s
    now) printed beside the measured peak memory and step time; fails if
    its per-card bytes are off the peak by more than DRY_RATIO either
    way, or if the step is shorter than the roofline's memory term, the
    step's traffic per fused region (`launch/traffic.py`: each kernel's
    own bytes, each elementwise chain once, AdamW) at the card's memory
    rate, a bound as the compute term is."""
    from repro_torch.configs import ShapeConfig, model_flops

    rec, row, secs = dry if dry is not None else dry_run_cell(cfg, mesh, seq,
                                                              batch)
    mem = rec["full"]["memory"]
    resident = row["mem_resident_gb"] * 1e9
    ratio = resident / (peak_gib * 2**30)
    mf = model_flops(cfg, ShapeConfig("train_4k", "train", seq, batch))
    print(f"    {label}: dry run in {secs:.1f} s on the "
          f"host: per card {resident / 2**30:.2f} GiB (parameters "
          f"{rec['state']['params'] / 2**30:.2f}, AdamW "
          f"{rec['state']['opt'] / 2**30:.2f}, gradients "
          f"{rec['state']['grads'] / 2**30:.2f}, activations "
          f"{mem['activations'] / 2**30:.2f}) against the measured peak "
          f"{peak_gib:.2f} GiB (x{ratio:.3f}); says "
          f"{'fits' if row['fits_hbm80'] else 'does not fit'} in 80 GB")
    print(f"    {label}: FLOPs {rec['full']['flops']:.4g} (forward, backward "
          f"and remat's second forward) against MODEL_FLOPS {mf:.4g} "
          f"(x{rec['full']['flops'] / mf:.3f}); roofline terms compute "
          f"{row['t_compute_s'] * 1e3:.2f} ms (a bound), memory "
          f"{row['t_memory_s'] * 1e3:.2f} ms (a bound: "
          f"{rec['full']['bytes'] / 1e9:.2f} GB per fused region), "
          f"collective "
          f"{row['t_collective_s'] * 1e3:.2f} ms; the roofline's "
          f"fraction {row['mfu_at_roofline']:.3f} (at its largest term, "
          f"{row['dominant']}) against the measured step {step_ms:.1f} ms: "
          f"{mf / (step_ms / 1e3) / BF16_OPS_PER_S:.3f} of the bf16 peak; "
          f"the step is x{step_ms / (row['t_compute_s'] * 1e3):.3f} the "
          f"compute bound and x{step_ms / (row['t_memory_s'] * 1e3):.3f} "
          f"the memory bound")
    check(step_ms >= row["t_memory_s"] * 1e3,
          f"{label}: the step {step_ms:.1f} ms is shorter than the "
          f"roofline's memory term {row['t_memory_s'] * 1e3:.2f} ms, a "
          "bound")
    check(1 / DRY_RATIO <= ratio <= DRY_RATIO,
          f"{label}: the dry run's {resident / 2**30:.2f} GiB a card is "
          f"off the measured peak {peak_gib:.2f} GiB by more than "
          f"{DRY_RATIO}x")
    return {"resident_gib": resident / 2**30, "peak_gib": peak_gib,
            "ratio": ratio, "fits": row["fits_hbm80"],
            "flops": rec["full"]["flops"], "model_flops": mf,
            "roofline": {k: row[k] for k in (
                "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                "mfu_at_roofline")},
            "step_ms": step_ms}


def phase_policy(dev, phase25: dict) -> tuple[Counter, dict]:
    """Phase 26: the training policy on the card.  (a) ``remesh`` over
    the visible cards (a one-rank process group over a HashStore for
    one).  (b) qwen3-8b at full width and POLICY_LAYERS layers, train_4k's
    4,096 tokens, batch 1, bf16, POLICY_STEPS steps through ``train_loop``
    under ``ShardingPolicy(mesh, TRAIN_RULES, TRAIN_PARAM_RULES)`` against
    the same run with no policy: losses and every parameter bit for bit
    (every placement resolves to Replicate on one card), exactly 2 forward
    and 1 backward flash launch per layer and step in both, the plain
    attention refused in the policy run.  (c) the port's dry run of phase
    25's qwen3-8b cell (``phase25``: its measured peak GiB and step ms)
    and of (b)'s cell on the same mesh against their measured peaks
    (within DRY_RATIO), FLOPs beside MODEL_FLOPS, the roofline beside the
    step; (b)'s cell is dry-run before (b) runs, and a dry run that says
    "fits" for a step that ran out of memory fails.  Returns the policy
    run's launches and (c)'s figures."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.elastic import remesh
    from repro_torch.distributed.sharding import (TRAIN_PARAM_RULES,
                                                  TRAIN_RULES,
                                                  ShardingPolicy,
                                                  apply_policy, mesh_shape)
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig
    from repro_torch.training.loop import gathered, train_loop
    from repro_torch.utils.tree import tree_leaves

    n = torch.cuda.device_count()
    mesh = remesh(n, device_type=dev.type)
    print(f"    (a) remesh({n}) = {mesh}: mesh shape {mesh_shape(mesh)}")
    check(mesh_shape(mesh) == {"data": 1, "model": 1},
          f"remesh({n}) gave {mesh_shape(mesh)}")
    policy = ShardingPolicy(mesh, acts=TRAIN_RULES, params=TRAIN_PARAM_RULES)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=POLICY_LAYERS)
    model = build_model(cfg)
    opt = OptConfig(lr=TRAIN_LR[ARCH], warmup_steps=2,
                    total_steps=POLICY_STEPS + 3)
    want = launches_per_step(cfg, POLICY_STEPS)
    dry_b = dry_run_cell(cfg, mesh, TRAIN_4K)
    runs = {}
    oom = False
    for name, pol in (("plain", None), ("policy", policy)):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        data = FramedData(cfg, TRAIN_4K, 1, seed=26)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with apply_policy(pol), (plain_training_refused() if pol
                                     else nullcontext()):
                out = train_loop(model, data, steps=POLICY_STEPS,
                                 opt_cfg=opt, log_every=1, device=dev)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            oom = True
            break
        t_end = time.perf_counter()
        counts = ops.launch_counts()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        params = [p.detach().clone() for p in
                  tree_leaves(gathered(out["params"]))]
        steps = step_times_ms(data.times, t_end)
        runs[name] = {"losses": [x for _, x in out["losses"]],
                      "params": params, "counts": counts, "peak": peak,
                      "step_ms": statistics.mean(steps[1:])}
        print(f"    (b) {name}: {POLICY_STEPS} steps in "
              f"{t_end - t0:.1f} s, {runs[name]['step_ms']:.1f} ms a step "
              f"after the first; peak {peak:.2f} GiB; losses "
              f"{', '.join(f'{x:.6f}' for x in runs[name]['losses'])}; "
              f"launches {launch_text(counts, want)}")
        check(all(counts[k] == v for k, v in want.items()),
              f"{name} run: launches {counts}, expected {want}")
        del out
    if not oom:
        plain, placed = runs["plain"], runs["policy"]
        same = all(torch.equal(a, b) for a, b in zip(plain["params"],
                                                     placed["params"]))
        print(f"    (b) policy = plain: losses "
              f"{plain['losses'] == placed['losses']}, all "
              f"{len(plain['params'])} parameters bit for bit {same}")
        check(plain["losses"] == placed["losses"] and same,
              "the policy run is not the plain run bit for bit")
        for r in runs.values():
            del r["params"]
    gc.collect()
    torch.cuda.empty_cache()
    full = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_LAYERS)
    figures = {"phase25": dry_run_against(
        full, mesh, TRAIN_4K, phase25["peak_gib"], phase25["step_ms"],
        f"(c) phase 25's {ARCH} cell, {TRAIN_LAYERS} layers")}
    check(not (oom and dry_b[1]["fits_hbm80"]),
          "(b) ran out of memory where the dry run says it fits")
    check(not oom, "(b) ran out of memory")
    figures["phase26b"] = dry_run_against(
        cfg, mesh, TRAIN_4K, runs["policy"]["peak"],
        runs["policy"]["step_ms"], f"(c) (b)'s cell, {POLICY_LAYERS} layers",
        dry=dry_b)
    if dist.is_initialized():
        dist.destroy_process_group()
    return runs["policy"]["counts"], figures


SPLIT_STEPS = 3                    # phases 27b–30b's steps a run
# phases 27c–30c's steps a run, the second timed: a step of two ranks
# sharing the card is gloo's traffic through the host (PERF.md §5)
SPLIT_FULL_STEPS = 2
SPLIT_OFFSETS = (0, 2048, 1000)    # 27a: the two ranks' and one off the tiles
# phase 27c's qwen3-8b depth: phase 26's POLICY_LAYERS cut to 2 to make
# room for phase 29 in the script's time (PERF.md §4)
SPLIT_LAYERS = 2
SPLIT_WORKER = r"""
import dataclasses, functools, json, os, sys, time
import torch
import torch.distributed as dist
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.distributed import param_gather, seq_parallel
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.training import loop
from repro_torch.utils.tree import tree_leaves

spec, out = json.loads(sys.argv[1]), sys.argv[2]
cfg = dataclasses.replace(get_config(spec["arch"]), **spec["over"])


def warm_up():
    # one training step of the run's family at phase 24's (29b's, 30b's)
    # narrow widths in the run's dtype: a fresh process's first training
    # step otherwise spends ~10 s loading what the path runs (PERF.md §5),
    # in the first timed step
    from repro_torch.models import build_model
    narrow = {c.name: c for c in (*cs.training_configs(),
                                  *cs.split_moe_configs(),
                                  *cs.split_encdec_vlm_configs())}
    small = dataclasses.replace(narrow[spec["arch"]], dtype=cfg.dtype)
    model = build_model(small)
    dev = torch.device("cpu")
    if torch.cuda.is_available():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in cs.FramedData(
        small, 512, 1, 0).batch_at(0).items()}
    torch.autograd.grad(model.loss(params, batch), leaves)
    torch.cuda.synchronize()
    del model, params, leaves
    torch.cuda.empty_cache()


if spec.get("warm_ahead"):
    warm_up()              # beside the phase's (b), off this run's clock
    open(f"{spec['warm_ahead']}.{os.environ.get('RANK', '0')}", "w").close()
while spec.get("hold") and not os.path.exists(spec["hold"]):
    time.sleep(0.05)       # started ahead, imports done: wait for the card
train.get_config = lambda name: cfg
train.train_loop = functools.partial(loop.train_loop, log_every=1)
times, calls, grads = [], [], []


class Timed(cs.FramedData):
    # the launcher's tokens, with the patches or frames its model reads
    def batch_at(self, step):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        return super().batch_at(step)


train.SyntheticLM = lambda vocab, seq, batch, seed=0: Timed(cfg, seq, batch,
                                                            seed)
lag = loop.loss_and_grads


def first_grads(model, params, batch, accum_steps=1):
    loss, g = lag(model, params, batch, accum_steps)
    if spec["grads"] and not grads:     # a rank's reduced shards
        grads.extend(x.detach().clone() for x in tree_leaves(g))
    return loss, g


loop.loss_and_grads = first_grads
# the layers' leaf gathers: how many made a leaf whole, and its bytes; an
# MoE expert leaf [E, ., .] made whole over its expert dim
gathers = {"count": 0, "bytes": 0, "experts_over_model": 0}
gather_leaf = param_gather._GatherLeaf.forward


def counted_gather(ctx, shard, *args):
    whole = gather_leaf(ctx, shard, *args)
    if whole.numel() > shard.numel():
        gathers["count"] += 1
        gathers["bytes"] += whole.numel() * whole.element_size()
        if cfg.is_moe and whole.dim() == 3 and whole.shape[0] == \
                cfg.n_experts > shard.shape[0]:
            gathers["experts_over_model"] += 1
    return whole


param_gather._GatherLeaf.forward = staticmethod(counted_gather)
for name in ("flash_attention_cuda", "flash_attention_bwd_cuda"):
    def wrap(*a, _fn=getattr(ops, name), _name=name, **kw):
        calls.append((_name, tuple(a[0].shape), tuple(a[1].shape),
                      kw.get("q_offset", 0)))
        return _fn(*a, **kw)
    setattr(ops, name, wrap)
# each MoE call's experts, its tokens' margins (the k-th router
# probability less the next) and its dropped pairs; the rows the MoE
# layers move to the ranks' experts and back (`moe._to_row` /
# `_to_block`, forward and re-run, and their gradients in the backward)
routes, margins, drops = [], [], []
tokens = {"count": 0, "bytes": 0}
if spec.get("moe"):
    from repro_torch.models import moe
    route, prefix = moe._route, seq_parallel.count_prefix
    dispatch, to_row, to_block = (moe._sort_dispatch, moe._to_row,
                                  moe._to_block)

    def moved(t):
        tokens["count"] += 1
        tokens["bytes"] += t.numel() * t.element_size()

    class Moved(torch.autograd.Function):
        # the identity, counting its gradient: a whole row's, moved
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            moved(g)
            return g

    def counted_row(x, s):
        row = to_row(x, s)
        moved(row)
        return Moved.apply(row)

    def counted_block(part, s):
        moved(part)
        return to_block(Moved.apply(part), s)

    def dispatched(w, x, gates, idx, e, c, cb, lo=0, before=None):
        if before is None and seq_parallel.current() is not None:
            # a rank's experts over the whole row: its drops
            flat = idx.reshape(idx.shape[0], -1)
            n = torch.zeros((flat.shape[0], e), dtype=torch.int64,
                            device=idx.device).scatter_add_(
                1, flat, torch.ones_like(flat))
            drops.append(int((n[:, lo:lo + w["wg"].shape[0]] - c)
                             .clamp(min=0).sum()))
        return dispatch(w, x, gates, idx, e, c, cb, lo, before)

    moe._to_row, moe._to_block = counted_row, counted_block
    moe._sort_dispatch = dispatched

    def recorded(p, x, c):
        gates, idx = route(p, x, c)
        routes.append(idx.to(torch.int16).cpu())
        with torch.no_grad():
            probs = torch.softmax(torch.einsum(
                "bsd,de->bse", x, p["router"]).float(), dim=-1)
            top = torch.topk(probs, c.top_k + 1, dim=-1).values
            margins.append((top[..., -2] - top[..., -1]).cpu())
        if seq_parallel.current() is None:      # one process: whole rows
            flat = idx.reshape(idx.shape[0], -1)
            n = torch.zeros((flat.shape[0], c.n_experts), dtype=torch.int64,
                            device=idx.device).scatter_add_(
                1, flat, torch.ones_like(flat))
            cap = moe._capacity(x.shape[1], c.top_k, c.n_experts,
                                c.capacity_factor)
            drops.append(int((n - cap).clamp(min=0).sum()))
        return gates, idx

    def counted(counts, s):
        before = prefix(counts, s)          # the gathered prefix itself
        cap = moe._capacity(s.s_local * s.size, cfg.top_k, cfg.n_experts,
                            cfg.capacity_factor)
        kept = torch.minimum((cap - before).clamp(min=0), counts)
        drops.append(int((counts - kept).sum()))
        return before

    moe._route, seq_parallel.count_prefix = recorded, counted
ops.reset_launch_counts()
seq_parallel.reset_collective_counts()
torch.cuda.reset_peak_memory_stats()
with cs.plain_training_refused():
    res = train.main(spec["args"])
torch.cuda.synchronize()
t_end = time.perf_counter()
rec = {"losses": [x for _, x in res["losses"]],
       "step_ms": cs.step_times_ms(times, t_end),
       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
       "launches": ops.launch_counts(), "calls": calls,
       "collectives": seq_parallel.collective_counts(),
       "leaf_gathers": gathers, "token_moves": tokens,
       "backend": dist.get_backend() if dist.is_initialized() else None,
       "device": str(torch.cuda.current_device()),
       "routes": routes, "margins": margins, "drops": drops}
if grads and dist.is_initialized():     # the shards gathered whole
    grads = loop.gathered(loop._placed_like(grads, res["params"]))
rec["grads"] = [g.float().cpu() for g in grads]
torch.save(rec, out)
if dist.is_initialized():
    dist.destroy_process_group()
"""


class SplitRun:
    """``launch/train.py`` in ``ranks`` processes as ``torchrun
    --nproc-per-node`` starts them (one process without a process group
    for ranks = 1), through SPLIT_WORKER, started at construction;
    ``wait`` returns each rank's record, ``kill`` stops what still
    runs.  A ``held`` run starts its processes, which import, warm up
    if ``warm_ahead`` (one narrow training step on the card, which takes
    a fresh process's ~10 s of loading off its first step; ``warm``
    says when every process has) and then wait for ``release`` before
    they train: it can start while the run before it holds the card."""

    def __init__(self, spec: dict, ranks: int, tag: str,
                 held: bool = False, warm_ahead: bool = False):
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        for key in ("WORLD_SIZE", "LOCAL_WORLD_SIZE", "RANK", "LOCAL_RANK"):
            env.pop(key, None)
        if ranks > 1:
            env.update(WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks))
        self.tag = tag
        self.go = ROOT / "build" / f"split_{tag}.go"
        self.go.unlink(missing_ok=True)
        self.warmed = [ROOT / "build" / f"split_{tag}.warm.{r}"
                       for r in range(ranks)] if warm_ahead else []
        for path in self.warmed:
            path.unlink(missing_ok=True)
        if held:
            spec = dict(spec, hold=str(self.go))
        if warm_ahead:
            spec = dict(spec, warm_ahead=str(ROOT / "build" /
                                             f"split_{tag}.warm"))
        self.outs = [ROOT / "build" / f"split_{tag}_{r}.pt"
                     for r in range(ranks)]
        atexit.register(self.kill)      # a failed phase stops them too
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", SPLIT_WORKER, json.dumps(spec), str(out)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)) if ranks > 1
            else env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r, out in enumerate(self.outs)]

    def release(self) -> None:
        self.go.touch()

    def warm(self) -> bool:
        """Every process has warmed up, or one has ended (``wait`` says
        how)."""
        return (all(path.exists() for path in self.warmed)
                or any(p.poll() is not None for p in self.procs))

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for path in (self.go, *self.warmed):
            path.unlink(missing_ok=True)

    def wait(self) -> list[dict]:
        import torch

        try:
            logs = [p.communicate(timeout=600)[0] for p in self.procs]
        finally:
            self.kill()
        n = len(self.procs)
        for p, log in zip(self.procs, logs):     # every failed rank's log
            if p.returncode:
                print(log[-4000:])
        for r, p in enumerate(self.procs):
            check(p.returncode == 0, f"{self.tag}: rank {r} of {n} exited "
                  f"{p.returncode}")
        recs = [torch.load(out) for out in self.outs]
        for out in self.outs:
            out.unlink()
        return recs


def split_launches(cfg, steps: int) -> dict:
    """The exact launches of a rank's ``steps`` split steps: as
    `launches_per_step`, but each scan twice over (its block from zeros,
    then from the state the earlier blocks pass on)."""
    want = launches_per_step(cfg, steps)
    for op in ("wkv6", "ssd"):
        want[op] *= 2
        want[f"{op}_bwd"] *= 2
    return want


def start_in_turn(jobs: list) -> list:
    """``SplitRun(spec, ranks, tag)`` for each (spec, ranks, tag) of
    ``jobs``, all started at once, held and warming up ahead: a phase
    starts them when its (b) starts, so their imports and warm-ups run
    beside (b), whose small steps the host's collectives bound."""
    return [SplitRun(*job, held=True, warm_ahead=True) for job in jobs]


def run_in_turn(runs: list) -> list:
    """`start_in_turn`'s runs one after another on the card, the first
    once every one has warmed up (so no warm-up runs beside a timed
    step): each run's records and its seconds from its release to its
    end."""
    out, t0 = [], time.perf_counter()
    try:
        while not all(run.warm() for run in runs):
            check(time.perf_counter() - t0 < 600, "the split runs did not "
                  "warm up in 600 s")
            time.sleep(0.1)
        for run in runs:
            run.release()
            t0 = time.perf_counter()
            out.append((run.wait(), time.perf_counter() - t0))
    finally:
        for run in runs:
            run.kill()
    return out


def split_calls(cfg, seq: int, rank: int) -> set:
    """The flash calls (forward and backward, Sq, Sk, q_offset) a rank of
    a two-rank split makes: an attention layer's at Sq = seq / 2 against
    Sk = seq at the rank's offset; an encoder-decoder's also its
    encoder's, src_len / 2 frame rows against src_len, and its
    cross-attention's, seq / 2 rows against src_len (both non-causal,
    offset 0)."""
    sl = seq // 2
    shapes = {(sl, seq, rank * sl)}
    if cfg.is_encdec:
        shapes |= {(cfg.src_len // 2, cfg.src_len, 0), (sl, cfg.src_len, 0)}
    return {(name, *shape) for shape in shapes
            for name in ("flash_attention", "flash_attention_bwd")}


def split_launch_gate(cfg, recs, seq: int, label: str,
                      steps: int = SPLIT_STEPS) -> None:
    """Each rank's launches over ``steps`` steps (`split_launches`): per
    layer and step a flash call 2 forward and 1 backward, a scan 4 and 2,
    every flash call at its shapes (`split_calls`; ``seq`` the positions
    of a row, a patch-input model's patches and tokens); printed with the
    backend and the collectives."""
    want = split_launches(cfg, steps)
    for r, rec in enumerate(recs):
        counts = rec["launches"]
        shapes = Counter((n.removesuffix("_cuda"), q[1], k[1], off)
                         for n, q, k, off in rec["calls"])
        print(f"    {label} rank {r} ({rec['backend']}, cuda:"
              f"{rec['device']}): launches {launch_text(counts, want)}; "
              f"calls {dict(shapes)}; collectives {rec['collectives']}")
        check(all(counts[k] == v for k, v in want.items()),
              f"{label} rank {r}: launches {counts}, expected {want}")
        calls = split_calls(cfg, seq, r) if want["flash_attention"] \
            else set()
        check(set(shapes) == calls, f"{label} rank {r}: calls "
              f"{dict(shapes)}")


# Each full-width split cell (arch, layers) under the step that gathered
# every parameter whole at its start and took whole gradients: a rank's
# peak GiB (the larger rank's) and step ms (the ranks' mean, the second
# step), two ranks sharing an NVIDIA H100 80GB HBM3 at 700 W over gloo
# (`tools/split_probe.py` on that commit, beside this one's; PERF.md §6);
# None where two ranks could not fit the card at that depth.
WHOLE_STEP = {(ARCH, 2): (19.68, 11881.7), (RWKV, 4): (8.38, 4613.9),
              (ZAMBA, 6): (13.62, 7270.2), (MIXTRAL, 1): (33.30, 13056.9),
              (DEEPSEEK, 5): (32.03, 12373.0), (DEEPSEEK, 6): None,
              (DEEPSEEK, 7): None, (LLAVA, 4): (35.62, 21572.7),
              (LLAVA, 6): None, (SEAMLESS, 12): (11.32, 6751.7)}


def against_whole(label: str, cfg, ranks, steps: int) -> dict:
    """Prints (and returns) a split cell's per-rank peak and step beside
    WHOLE_STEP's at the same depth, and the layers' leaf gathers a step
    a rank (how many made a leaf whole, and their GiB)."""
    peak = max(r["peak_gib"] for r in ranks)
    step = statistics.mean(r["step_mean_ms"] for r in ranks)
    gathers = ranks[0]["leaf_gathers"]
    before = WHOLE_STEP.get((cfg.name, cfg.n_layers), "not measured")
    then = ("two ranks did not fit the card" if before is None else
            before if isinstance(before, str) else
            f"{before[0]:.2f} GiB and {before[1]:.1f} ms")
    print(f"    {label}: a rank's peak {peak:.2f} GiB and step {step:.1f} "
          f"ms; the whole-parameter step at this depth: {then}; leaf "
          f"gathers a step a rank {gathers['count'] / steps:.0f} "
          f"({gathers['bytes'] / steps / 2**30:.2f} GiB made whole)")
    return {"peak_gib": peak, "step_ms": step, "whole_step": before,
            "leaf_gathers_per_step": gathers["count"] / steps,
            "gathered_gib_per_step": gathers["bytes"] / steps / 2**30}


def phase_split_kernels(dev) -> dict:
    """Phase 27a: the flash forward and backward kernels on a block of
    query rows at an offset, against their plain versions at qwen3-8b's
    heads (32 / 8 of 128), Sq = 2,048 against Sk = 4,096, offsets
    SPLIT_OFFSETS, float32 and bf16: the forward within ATTN_TOL (and its
    rows within ATTN_ROW_TOL), the backward within BWD_TOL of each
    output's largest plain value and each row within ATTN_ROW_TOL, and an
    offset of 0 the same bits as the call without one.  Returns the
    bf16 figures at each offset."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda,
        flash_attention_plain)

    cfg = get_config(ARCH)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sq, sk = TRAIN_4K // 2, TRAIN_4K
    figures = {}
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(27)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype) for shape in (
            (1, sq, h, d), (1, sk, hkv, d), (1, sk, hkv, d), (1, sq, h, d)))
        name = str(dtype).removeprefix("torch.")
        for off in SPLIT_OFFSETS:
            kw = dict(causal=True, window=0, q_offset=off)
            f = attn_figures(flash_attention_cuda, flash_attention_plain,
                             sdpa_flash, flash_work, (q, k, v), kw,
                             iters=20, rows=True)
            print_figures(f"flash_attention {name}", shape_key((q, k, v),
                                                               kw), f)
            o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            b = bwd_figures((q, k, v, o, do, lse), kw, iters=5)
            print_figures(f"flash_attention_bwd {name}",
                          shape_key((q, k, v), kw), b)
            if dtype == torch.bfloat16:
                figures[off] = {"flash_attention": f,
                                "flash_attention_bwd": b}
        o0, l0 = flash_attention_cuda(q, k, v, return_lse=True, q_offset=0)
        o1, l1 = flash_attention_cuda(q, k, v, return_lse=True)
        g0 = flash_attention_bwd_cuda(q, k, v, o1, do, l1, q_offset=0)
        g1 = flash_attention_bwd_cuda(q, k, v, o1, do, l1)
        same = (torch.equal(o0, o1) and torch.equal(l0, l1)
                and all(torch.equal(x, y) for x, y in zip(g0, g1)))
        print(f"    {name}: offset 0 the same bits as no offset (output, "
              f"LSE, dQ, dK, dV): {same}")
        check(same, f"{name}: an offset of 0 changed the kernels' bits")
        del q, k, v, do, o, lse, o0, l0, o1, l1, g0, g1
        gc.collect()
        torch.cuda.empty_cache()
    return figures


def phase_split(dev) -> tuple[dict, dict]:
    """Phase 27: each sequence split over a ``model`` axis of 2, the
    reference launcher's mesh for two devices.  (a) `phase_split_kernels`.
    (b) ``launch/train.py`` in two processes at (1, 2) (gloo on this
    card's CUDA tensors where the ranks share it, NCCL with a card each)
    against one process, phase 24's reduced float32 qwen3-8b
    (TRAIN_SEQ x TRAIN_BATCH), SPLIT_STEPS steps: each step's loss within
    1e-5 relative, the ranks' first-step gradients gathered within GRAD_TOL
    of each leaf's largest one-process value.  (c) qwen3-8b at full width
    and SPLIT_LAYERS layers, bf16, TRAIN_4K tokens, SPLIT_FULL_STEPS steps
    (phase 26's cell, cut in depth), the same way: losses within 2e-2
    relative, each rank's flash launches exact (2 forward + 1 backward
    per layer and step, Sq = 2,048 against Sk = 4,096 at its offset) with
    the plain
    versions refused, per-rank peak memory and step time, and the dry
    run's bytes a rank against the measured peak (within DRY_RATIO).
    Returns (c)'s rank-0 launches and the phase's figures."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh

    cfg_b = [c for c in training_configs() if c.name == ARCH][0]
    over = {f: getattr(cfg_b, f) for f in ("n_layers", "d_model", "d_ff",
                                           "vocab_size", "dtype")}
    args = ["--arch", ARCH, "--steps", str(SPLIT_STEPS), "--lr",
            str(TRAIN_LR[ARCH])]
    spec = {"arch": ARCH, "over": over, "grads": True,
            "args": [*args, "--seq-len", str(TRAIN_SEQ), "--batch",
                     str(TRAIN_BATCH)]}
    spec_c = {"arch": ARCH, "over": {"n_layers": SPLIT_LAYERS},
              "grads": False,
              "args": ["--arch", ARCH, "--steps", str(SPLIT_FULL_STEPS),
                       "--lr", str(TRAIN_LR[ARCH]), "--seq-len",
                       str(TRAIN_4K), "--batch", "1"]}
    # (b)'s processes import and warm up while (a) runs (a fresh process's
    # first step otherwise took ~12 s, PERF.md §5); both are small, so
    # they train at once after it
    runs = [SplitRun(spec, 1, "b1", held=True, warm_ahead=True),
            SplitRun(spec, 2, "b2", held=True, warm_ahead=True)]
    try:
        figures = {"kernels": phase_split_kernels(dev)}
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        for run in runs:
            run.release()
        # (c)'s runs import and warm up while (b) trains
        chain = start_in_turn([(spec_c, 1, "c1"), (spec_c, 2, "c2")])
        one, ranks = runs[0].wait()[0], runs[1].wait()
    finally:
        for run in runs:
            run.kill()
    split_launch_gate(cfg_b, ranks, TRAIN_SEQ, "(b)")
    check(ranks[0]["losses"] == ranks[1]["losses"],
          "(b) the ranks' losses differ")
    rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                  one["losses"]))
    worst, worst_at = split_grad_err(ranks, one)
    print(f"    (b) {ARCH} at {over}: losses {ranks[0]['losses']} against "
          f"one process's {one['losses']} (largest relative gap {rel:.3g}); "
          f"the ranks' first-step gradients: worst leaf {worst:.3g} "
          f"of its largest one-process value (leaf {worst_at} of "
          f"{len(one['grads'])}); {time.perf_counter() - t0:.1f} s")
    check(rel <= 1e-5, f"(b) losses {rel} apart relative (limit 1e-5)")
    check(worst <= GRAD_TOL, f"(b) a gradient leaf is {worst} of its "
          f"largest value off (limit {GRAD_TOL})")
    figures["b"] = {"losses": ranks[0]["losses"], "one": one["losses"],
                    "rel": rel, "grad_err": worst}
    del one, ranks
    gc.collect()
    torch.cuda.empty_cache()

    cfg_c = dataclasses.replace(get_config(ARCH), n_layers=SPLIT_LAYERS)
    mesh = AbstractMesh((1, 2), ("data", "model"))
    dry = dry_run_cell(cfg_c, mesh, TRAIN_4K)
    # one process (alone on the card), then the two ranks
    ((one, one_s), (ranks, ranks_s)) = run_in_turn(chain)
    one, wall = one[0], one_s + ranks_s
    split_launch_gate(cfg_c, ranks, TRAIN_4K, "(c)", SPLIT_FULL_STEPS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                  one["losses"]))
    card = card_line()
    for label, rec in (("one process", one), ("rank 0", ranks[0]),
                       ("rank 1", ranks[1])):
        rec["step_mean_ms"] = statistics.mean(rec["step_ms"][1:])
        print(f"    (c) {label}: losses "
              f"{', '.join(f'{x:.6f}' for x in rec['losses'])}; steps "
              f"{', '.join(f'{x:.1f}' for x in rec['step_ms'])} ms "
              f"({rec['step_mean_ms']:.1f} after the first); peak "
              f"{rec['peak_gib']:.2f} GiB; {card}")
    print(f"    (c) the split's losses within {rel:.3g} relative of one "
          f"process's; both runs {wall:.1f} s from their release")
    against = against_whole("(c)", cfg_c, ranks, SPLIT_FULL_STEPS)
    check(ranks[0]["losses"] == ranks[1]["losses"],
          "(c) the ranks' losses differ")
    check(rel <= 2e-2, f"(c) losses {rel} apart relative (limit 2e-2)")
    peak = max(r["peak_gib"] for r in ranks)
    step_ms = statistics.mean(r["step_mean_ms"] for r in ranks)
    figures["c"] = {
        "losses": ranks[0]["losses"], "one": one["losses"], "rel": rel,
        "peak_gib": [r["peak_gib"] for r in ranks],
        "step_ms": [r["step_mean_ms"] for r in ranks],
        "one_peak_gib": one["peak_gib"], "one_step_ms": one["step_mean_ms"],
        "backend": ranks[0]["backend"],
        "collectives": ranks[0]["collectives"], "against_whole": against,
        "dry_run": dry_run_against(
            cfg_c, mesh, TRAIN_4K, peak, step_ms,
            f"(c) a rank of the split, {SPLIT_LAYERS} layers", dry=dry)}
    return ranks[0]["launches"], figures


# phase 28's full-width depths: cut (from 32 and 30, the deepest at which
# two ranks stayed under 72 GiB of the card together while the step
# gathered every parameter whole) to make room for phase 29 in the
# script's time; zamba2-7b at one group of 6 (PERF.md §4)
SPLIT_DEPTH = {RWKV: 4, ZAMBA: 6}
# phases 28c's, 29c's and 30c's dry runs, in a process of their own that
# `main` starts before phase 1: a full-width zamba2-7b cell takes minutes of
# the host to trace; each keyed (arch, depth)
SPLIT_DRY = r"""
import dataclasses, json, pickle, sys
import torch
torch.set_num_threads(1)
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.launch.mesh import AbstractMesh
mesh = AbstractMesh((1, 2), ("data", "model"))
out = {(arch, depth): cs.dry_run_cell(dataclasses.replace(
           get_config(arch), n_layers=depth), mesh, seq, batch)
       for arch, depth, seq, batch in json.loads(sys.argv[1])}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def split_scan_inputs(dev, seed: int, dtype):
    """A split rank's WKV6 and SSD calls at full width (rwkv6-3b's 40
    heads of 64, zamba2-7b's 112 of 64 with a state of 64), S_local =
    TRAIN_4K / 2 tokens, batch 1, each with a stored incoming state:
    ((r, k, v, log_w, u, s0), (x, B, C, dt, A_log, D, s0)), drawn on the
    card."""
    import torch

    from repro_torch.configs import get_config

    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    rw, zb = get_config(RWKV), get_config(ZAMBA)
    s = TRAIN_4K // 2
    h, dk = rw.ssm_heads, rw.ssm_state
    zh, ds = zb.ssm_heads, zb.ssm_state
    hd = 2 * zb.d_model // zh
    wkv6 = (normal((1, s, h, dk), dtype), normal((1, s, h, dk), dtype),
            normal((1, s, h, dk), dtype),
            torch.clamp(-torch.exp(normal((1, s, h, dk))), -4.0, -1e-3),
            normal((h, dk)), normal((1, h, dk, dk)))
    ssd = (normal((1, s, zh, hd), dtype), normal((1, s, ds), dtype),
           normal((1, s, ds), dtype), normal((1, s, zh)).abs() * 0.5,
           normal((zh,), scale=0.3), normal((zh,)), normal((1, zh, hd, ds)))
    return wkv6, ssd


def phase_split_recurrent_kernels(dev) -> dict:
    """Phase 28a: the kernels at a split rank's calls, against their plain
    versions.  The scans at S_local = 2,048 (`split_scan_inputs`), float32
    and bf16: the forward from a stored state (a rank's second pass, whose
    s0 requires grad in training) under phase 10's gates, and the
    backward with both the final state's gradient and the incoming
    state's (`want_ds0`) under phase 23b's, from the checkpoints (8
    segments, as training runs it) and from every state, the two the same
    bits.  The flash kernels at
    zamba2-7b's shared block (32 / 32 heads of 112), 2,048 query rows
    against 4,096 keys at offsets 0 and 2,048, under phase 27a's gates.
    Returns the bf16 figures."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssd import ssd_cuda, ssd_plain
    from repro_torch.kernels.wkv6 import kept_stride, wkv6_cuda, wkv6_plain

    figures = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        wkv6, ssd = split_scan_inputs(dev, 2828, dtype)
        gen = torch.Generator(device=dev).manual_seed(2829)
        for op, fwd, kernel, plain, work in (
                ("wkv6", wkv6, wkv6_cuda, wkv6_plain, wkv6_work),
                ("ssd", ssd, ssd_cuda, ssd_plain, ssd_work)):
            f = scan_figures(kernel, plain, work, fwd, {}, iters=20)
            print_figures(f"{op} {name} from s0", shape_key(fwd), f)
            out, s_t, states = kernel(*fwd, return_states=True)
            stride = kept_stride(states.shape[2])
            _, _, ckpt = kernel(*fwd, return_states=True, keep_every=stride)
            grads = (torch.randn(out.shape, generator=gen, device=dev)
                     .to(dtype),
                     torch.randn(s_t.shape, generator=gen, device=dev))
            whole_args = (*fwd[:-1], states, *grads)
            args = (*fwd[:-1], ckpt, *grads)
            bwd = scan_bwd_parts(f"{op}_bwd")[0]
            whole = bwd(*whole_args, want_ds0=True)
            same = [torch.equal(g, w) and torch.equal(o, w)
                    for g, o, w in zip(
                        bwd(*args, want_ds0=True),
                        on_side_stream(lambda: bwd(*args, want_ds0=True)),
                        whole)]
            check(all(same), f"{op}_bwd {name}: from the checkpoints (on the "
                  "current stream or another) not the whole-state backward "
                  f"bit for bit ({same})")
            del whole
            b = scan_bwd_figures(f"{op}_bwd", args, {"want_ds0": True},
                                 iters=5)
            b.update(scan_bwd_schedule(f"{op}_bwd", args, {"want_ds0": True}))
            _, b["scratch_bytes"] = bwd_scratch(
                lambda: bwd(*args, want_ds0=True))
            print_figures(f"{op}_bwd {name} with dsT and ds0, from the "
                          f"checkpoints (every {stride}th state)",
                          shape_key(fwd), b)
            print_schedule(b, 4 * ckpt.numel() // ckpt.shape[2] * stride,
                           4 * states.numel())
            bw = scan_bwd_figures(f"{op}_bwd", whole_args,
                                  {"want_ds0": True}, iters=5)
            print_figures(f"{op}_bwd {name} with dsT and ds0, from every "
                          "state", shape_key(fwd), bw)
            if dtype == torch.bfloat16:
                figures[op], figures[f"{op}_bwd"] = f, b
                figures[f"{op}_bwd whole"] = bw
            del out, s_t, states, ckpt, grads, args, whole_args
        del wkv6, ssd
        gc.collect()
        torch.cuda.empty_cache()

    cfg = get_config(ZAMBA)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sq, sk = TRAIN_4K // 2, TRAIN_4K
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(28)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype) for shape in (
            (1, sq, h, d), (1, sk, hkv, d), (1, sk, hkv, d), (1, sq, h, d)))
        name = str(dtype).removeprefix("torch.")
        for off in (0, sk - sq):
            kw = dict(causal=True, window=0, q_offset=off)
            f = attn_figures(flash_attention_cuda, flash_attention_plain,
                             sdpa_flash, flash_work, (q, k, v), kw,
                             iters=20, rows=True)
            print_figures(f"flash_attention {name} d=112",
                          shape_key((q, k, v), kw), f)
            o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            b = bwd_figures((q, k, v, o, do, lse), kw, iters=5)
            print_figures(f"flash_attention_bwd {name} d=112",
                          shape_key((q, k, v), kw), b)
            if dtype == torch.bfloat16:
                figures[f"flash_attention {off}"] = f
                figures[f"flash_attention_bwd {off}"] = b
            del o, lse
        del q, k, v, do
        gc.collect()
        torch.cuda.empty_cache()
    return figures


def split_grad_err(ranks, one) -> tuple[float, int]:
    """The ranks' first-step gradients (each rank's reduced shards,
    gathered whole: the same bits on every rank) against one process's:
    the worst leaf's largest difference over its largest one-process
    value, and that leaf's index."""
    import torch

    for r in ranks[1:]:
        check(all(torch.equal(a, b) for a, b in zip(r["grads"],
                                                    ranks[0]["grads"])),
              "the ranks' gathered first-step gradients differ")
    worst, worst_at = 0.0, 0
    for i, (g, w) in enumerate(zip(ranks[0]["grads"], one["grads"])):
        e = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        if e > worst:
            worst, worst_at = e, i
    return worst, worst_at


def phase_split_recurrent(dev, dry=None) -> tuple[dict, dict]:
    """Phase 28: rwkv6-3b and zamba2-7b with each sequence split over a
    ``model`` axis of 2, the scan states and token shifts passed from rank
    to rank.  (a) `phase_split_recurrent_kernels`.  (b) Both at phase
    24's reduced float32 widths (TRAIN_SEQ x TRAIN_BATCH), two ranks
    sharing the card over gloo against one process, SPLIT_STEPS steps:
    each step's loss within 1e-5 relative, the ranks' first-step
    gradients gathered within GRAD_TOL of each leaf's largest one-process
    value, each rank's launches exact (`split_launch_gate`: every scan
    twice a layer and pass, the shared block's flash at its offset).
    (c) Both at full width, bf16, TRAIN_4K tokens, SPLIT_DEPTH layers,
    SPLIT_FULL_STEPS steps, one process and then two ranks: the losses within
    2e-2 relative, the launches exact with every plain version refused,
    each rank's peak memory and step time, the dry run's bytes a rank
    against the measured peak (within DRY_RATIO), the collectives.
    ``dry`` is the running `SplitDry` (one is started here without it).
    Returns (c)'s rank-0 launches of both models summed and the phase's
    figures."""
    dry = dry or SplitDry(("28",))
    try:
        return phase_split_recurrent_runs(dev, dry)
    finally:
        dry.kill()


def split_dry_cells(*phases: str) -> list:
    """The (arch, depth, positions, batch) cells of phase 28c's, 29c's and
    30c's dry runs: each model at its depth, and the MoE models and
    llava-next-34b one layer deeper too (where two ranks would pass 72
    GiB)."""
    cells = []
    if "28" in phases:
        cells += [(a, d, TRAIN_4K, 1) for a, d in SPLIT_DEPTH.items()]
    if "29" in phases:
        cells += [(a, d + i, TRAIN_4K, 1) for a, d in SPLIT_MOE_DEPTH.items()
                  for i in (0, 1)]
    if "30" in phases:
        for cfg, seq, batch in split_full_cells():
            cells += [(cfg.name, cfg.n_layers + i, seq, batch)
                      for i in ((0, 1) if cfg.name == LLAVA else (0,))]
    return cells


class SplitDry:
    """Phases 28c's, 29c's and 30c's dry runs (SPLIT_DRY; ``phases`` of
    them) in a process started at construction; ``result`` waits for
    them."""

    def __init__(self, phases=("28", "29", "30")):
        self.out = ROOT / "build" / "split_dry.pkl"
        self.done = None
        self.proc = subprocess.Popen(
            [sys.executable, "-c", SPLIT_DRY,
             json.dumps(split_dry_cells(*phases)), str(self.out)],
            cwd=ROOT, env=dict(os.environ,
                               PYTHONPATH=f"{ROOT / 'src'}:{ROOT}"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result(self) -> dict:
        if self.done is None:
            log = self.proc.communicate(timeout=900)[0]
            if self.proc.returncode:
                print(log[-4000:])
            check(self.proc.returncode == 0, f"the split phases' dry runs "
                  f"exited {self.proc.returncode}")
            self.done = pickle.loads(self.out.read_bytes())
        return self.done

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def phase_split_recurrent_runs(dev, dry: SplitDry) -> tuple[dict, dict]:
    """`phase_split_recurrent` beside the process of its dry runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh

    reduced = {c.name: c for c in training_configs()}
    runs = {}
    for arch in (RWKV, ZAMBA):
        cfg_b = reduced[arch]
        over = {f: getattr(cfg_b, f) for f in (
            "n_layers", "d_model", "d_ff", "vocab_size", "dtype",
            "ssm_heads", "attn_every")}
        spec = {"arch": arch, "over": over, "grads": True,
                "args": ["--arch", arch, "--steps", str(SPLIT_STEPS),
                         "--lr", str(TRAIN_LR[arch]), "--seq-len",
                         str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH)]}
        # (b)'s processes import and warm up while (a) runs; they train
        # after it
        runs[arch] = (cfg_b, [
            SplitRun(spec, 1, f"rb1_{arch}", held=True, warm_ahead=True),
            SplitRun(spec, 2, f"rb2_{arch}", held=True, warm_ahead=True)])
    jobs = []
    for arch in (RWKV, ZAMBA):
        spec = {"arch": arch, "over": {"n_layers": SPLIT_DEPTH[arch]},
                "grads": False,
                "args": ["--arch", arch, "--steps", str(SPLIT_FULL_STEPS),
                         "--lr", str(TRAIN_LR[arch]), "--seq-len",
                         str(TRAIN_4K), "--batch", "1"]}
        jobs += [(spec, 1, f"rc1_{arch}"), (spec, 2, f"rc2_{arch}")]
    try:
        t0 = time.perf_counter()
        figures = {"kernels": phase_split_recurrent_kernels(dev)}
        print(f"    (a) {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        figures["b"] = {}
        t0 = time.perf_counter()
        for _, pair in runs.values():
            for run in pair:
                run.release()
        # (c)'s runs import and warm up while (b) trains
        chain = start_in_turn(jobs)
        for arch, (cfg_b, (run1, run2)) in runs.items():
            one, ranks = run1.wait()[0], run2.wait()
            split_launch_gate(cfg_b, ranks, TRAIN_SEQ, f"(b) {arch}")
            check(ranks[0]["losses"] == ranks[1]["losses"],
                  f"(b) {arch}: the ranks' losses differ")
            rel = max(abs(a - b) / abs(b) for a, b in zip(
                ranks[0]["losses"], one["losses"]))
            worst, worst_at = split_grad_err(ranks, one)
            print(f"    (b) {arch} at {cfg_b.n_layers} layers, d_model "
                  f"{cfg_b.d_model}: losses {ranks[0]['losses']} against "
                  f"one process's {one['losses']} (largest relative gap "
                  f"{rel:.3g}); the ranks' gathered first-step gradients: "
                  f"worst leaf {worst:.3g} of its largest one-process "
                  f"value (leaf {worst_at} of {len(one['grads'])})")
            check(rel <= 1e-5, f"(b) {arch}: losses {rel} apart relative "
                  "(limit 1e-5)")
            check(worst <= GRAD_TOL, f"(b) {arch}: a gradient leaf is "
                  f"{worst} of its largest value off (limit {GRAD_TOL})")
            figures["b"][arch] = {"losses": ranks[0]["losses"],
                                  "one": one["losses"], "rel": rel,
                                  "grad_err": worst}
            del one, ranks
    finally:
        for _, pair in runs.values():
            for run in pair:
                run.kill()
    print(f"    (b) both models {time.perf_counter() - t0:.1f} s from their "
          "release")
    gc.collect()
    torch.cuda.empty_cache()

    mesh = AbstractMesh((1, 2), ("data", "model"))
    card = card_line()
    launches = Counter()
    figures["c"] = {}
    # each model's one process, then its ranks
    done = run_in_turn(chain)
    runs = {arch: (done[2 * i][0][0], done[2 * i + 1][0],
                   done[2 * i][1] + done[2 * i + 1][1])
            for i, arch in enumerate((RWKV, ZAMBA))}
    t0 = time.perf_counter()
    dry_runs = dry.result()
    print(f"    (c) waited {time.perf_counter() - t0:.1f} s for the dry runs")
    for arch, (one, ranks, wall) in runs.items():
        cfg_c = dataclasses.replace(get_config(arch),
                                    n_layers=SPLIT_DEPTH[arch])
        split_launch_gate(cfg_c, ranks, TRAIN_4K, f"(c) {arch}",
                          SPLIT_FULL_STEPS)
        rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                      one["losses"]))
        for label, rec in (("one process", one), ("rank 0", ranks[0]),
                           ("rank 1", ranks[1])):
            rec["step_mean_ms"] = statistics.mean(rec["step_ms"][1:])
            print(f"    (c) {arch} at {SPLIT_DEPTH[arch]} layers, {label}: "
                  f"losses {', '.join(f'{x:.6f}' for x in rec['losses'])};"
                  f" steps {', '.join(f'{x:.1f}' for x in rec['step_ms'])}"
                  f" ms ({rec['step_mean_ms']:.1f} after the first); peak "
                  f"{rec['peak_gib']:.2f} GiB; {card}")
        print(f"    (c) {arch}: the split's losses within {rel:.3g} "
              f"relative of one process's; both runs {wall:.1f} s from "
              "their release")
        against = against_whole(f"(c) {arch}", cfg_c, ranks,
                                SPLIT_FULL_STEPS)
        check(ranks[0]["losses"] == ranks[1]["losses"],
              f"(c) {arch}: the ranks' losses differ")
        check(rel <= 2e-2, f"(c) {arch}: losses {rel} apart relative "
              "(limit 2e-2)")
        peak = max(r["peak_gib"] for r in ranks)
        step_ms = statistics.mean(r["step_mean_ms"] for r in ranks)
        launches.update(ranks[0]["launches"])
        figures["c"][arch] = {
            "layers": SPLIT_DEPTH[arch], "losses": ranks[0]["losses"],
            "one": one["losses"], "rel": rel,
            "peak_gib": [r["peak_gib"] for r in ranks],
            "step_ms": [r["step_mean_ms"] for r in ranks],
            "one_peak_gib": one["peak_gib"],
            "one_step_ms": one["step_mean_ms"],
            "launches": [r["launches"] for r in ranks],
            "backend": ranks[0]["backend"],
            "collectives": ranks[0]["collectives"],
            "against_whole": against,
            "dry_run": dry_run_against(
                cfg_c, mesh, TRAIN_4K, peak, step_ms,
                f"(c) {arch}, a rank of the split, {SPLIT_DEPTH[arch]} "
                "layers", dry=dry_runs[arch, SPLIT_DEPTH[arch]])}
    return launches, figures


# ------------------------------------------------------------ phase 29 --
# phase 29c's full-width depths: the deepest at which two ranks, each with
# its shards (an MoE rank its own experts), one layer's other leaves whole
# at a time and half of AdamW's state, stay under 72 GiB of the card
# together; the phase checks the measured peaks and that one layer more,
# grown as the dry run grows, would not fit (PERF.md §4, §6); the
# one-process run at the same depth fits the card
SPLIT_MOE_DEPTH = {MIXTRAL: 1, DEEPSEEK: 7}
SPLIT_TWO_RANKS_GIB = 72.0
WINDOW_ROWS = 4096        # 29a: a rank's query rows at mixtral's window


def split_moe_configs():
    """Phase 29b's reduced float32 configs: phase 24's mixtral-8x22b (2
    layers of its 48 / 8 heads of 128, d_model 1,024, window 16, 8
    experts of 2,048, top 2) and deepseek-v2-lite-16b at 2 layers (its
    dense layer and one MLA + MoE layer: its 16 heads, its latent 512 +
    64, its 64 experts top 6 and 2 shared, each expert 352 wide and the
    dense FFN 2,048, as phase 24 narrows mixtral's), d_model 1,024,
    TRAIN_VOCAB."""
    from repro_torch.configs import get_config

    mixtral = [c for c in training_configs() if c.name == MIXTRAL][0]
    deepseek = dataclasses.replace(get_config(DEEPSEEK), n_layers=2,
                                   d_model=1024, moe_d_ff=352, d_ff=352,
                                   dense_d_ff=2048,
                                   vocab_size=TRAIN_VOCAB, dtype="float32")
    return [mixtral, deepseek]


def phase_split_moe_kernels(dev) -> dict:
    """Phase 29a (rows 3ow / 3bow): the flash forward and backward kernels
    at a split rank's call where mixtral-8x22b's window masks: its 48 / 8
    heads of 128, bf16, WINDOW_ROWS query rows at offset WINDOW_ROWS
    against twice as many keys, window 4,096 (query i sees keys i + 1 ..
    i + 4,096), under phase 27a's gates.  Returns the figures."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)

    cfg = get_config(MIXTRAL)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sq, sk = WINDOW_ROWS, 2 * WINDOW_ROWS
    rng = np.random.default_rng(29)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, torch.bfloat16) for shape in (
        (1, sq, h, d), (1, sk, hkv, d), (1, sk, hkv, d), (1, sq, h, d)))
    kw = dict(causal=True, window=cfg.sliding_window, q_offset=sk - sq)
    f = attn_figures(flash_attention_cuda, flash_attention_plain, sdpa_flash,
                     flash_work, (q, k, v), kw, iters=20, rows=True)
    print_figures("flash_attention bfloat16 window", shape_key((q, k, v),
                                                               kw), f)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    b = bwd_figures((q, k, v, o, do, lse), kw, iters=5)
    print_figures("flash_attention_bwd bfloat16 window",
                  shape_key((q, k, v), kw), b)
    del q, k, v, do, o, lse
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": f, "flash_attention_bwd": b}


def split_route_flips(ranks, one) -> dict:
    """The ranks' MoE routes against one process's, call by call (their
    blocks side by side, or, where each rank routed the gathered rows for
    its experts, the rows, the same on every rank): the tokens whose
    top-k expert sets differ
    (``flips``, and ``by_call`` in the order of the calls: each step's
    forward layer by layer, then its re-runs in the backward), the
    (token, slot) pairs those moved to another expert (``moved``), the
    calls, and one process's margins (its k-th router probability less
    the next): the largest at a flipped token and the median over all
    tokens."""
    import torch

    n = len(one["routes"])
    check(all(len(r["routes"]) == n for r in ranks),
          f"the ranks made {[len(r['routes']) for r in ranks]} routing "
          f"calls, one process {n}")
    by_call, pairs, at_flips = [], 0, []
    for i, want in enumerate(one["routes"]):
        parts = [r["routes"][i] for r in ranks]
        if parts[0].shape == want.shape:     # each rank routed the row
            check(all(torch.equal(x, parts[0]) for x in parts[1:]),
                  f"the ranks routed call {i}'s gathered rows apart")
            got = parts[0].long()
        else:                                # each rank its block
            got = torch.cat(parts, dim=1).long()
        want = want.long()
        same = (got[..., :, None] == want[..., None, :]).any(-1).sum(-1)
        flipped = same < want.shape[-1]
        by_call.append(int(flipped.sum()))
        pairs += int((want.shape[-1] - same).sum())
        at_flips.append(one["margins"][i][flipped])
    at_flips = torch.cat(at_flips)
    tokens = sum(by_call)
    return {"flips": tokens, "by_call": by_call, "moved": pairs,
            "routing_calls": n,
            "flip_margin_max": float(at_flips.max()) if tokens else None,
            "margin_median": float(torch.cat(
                [m.flatten() for m in one["margins"]]).median())}


def split_moe_gates(cfg, ranks, one, label: str, steps: int) -> dict:
    """What phases 29b and 29c hold for a model: the ranks' losses the
    same, their launches (`split_launch_gate`), the top-k flips against
    one process, each rank's dropped pairs and the collectives a step;
    the ranks' drops summed equal one process's but for what the flipped
    pairs move.  Returns the figures."""
    f = split_route_flips(ranks, one)
    drops = [sum(r["drops"]) for r in ranks]
    one_drops = sum(one["drops"])
    per_step = {k: v / steps for k, v in ranks[0]["collectives"].items()}
    at = ("" if f["flip_margin_max"] is None else
          f" (one process's margin there at most {f['flip_margin_max']:.3g}"
          ")")
    print(f"    {label}: top-{cfg.top_k} flips against one process: "
          f"{f['flips']} tokens{at}, {f['moved']} pairs moved, over "
          f"{f['routing_calls']} routing calls (by call {f['by_call']}; "
          f"of {one['routes'][0][..., 0].numel()} tokens a call; a token's "
          "median margin "
          f"{f['margin_median']:.3g}); dropped pairs a rank {drops} (sum "
          f"{sum(drops)}) against one process's {one_drops}; collectives "
          f"a step a rank {per_step}")
    check(ranks[0]["losses"] == ranks[1]["losses"],
          f"{label}: the ranks' losses differ")
    check(abs(sum(drops) - one_drops) <= f["moved"],
          f"{label}: the ranks dropped {sum(drops)} pairs, one process "
          f"{one_drops}, with {f['moved']} pairs moved by flips")
    over = [r["leaf_gathers"]["experts_over_model"] for r in ranks]
    check(over == [0] * len(ranks), f"{label}: expert leaves gathered "
          f"over model {over} times a rank (each rank keeps its experts)")
    return {**f, "drops": drops, "one_drops": one_drops,
            "collectives_a_step": per_step}


def split_moe_moves(ranks, steps: int, label: str) -> list:
    """Per rank of a split MoE run: the GiB its layers' leaf gathers made
    whole a step, the GiB of rows its MoE layers moved to its experts and
    back a step (`moe._to_row` / `_to_block` and their gradients), its
    peak, its step (the steps after the first) and its collectives a
    step; printed and returned."""
    out = []
    for r, rec in enumerate(ranks):
        leaf, rows = rec["leaf_gathers"], rec["token_moves"]
        row = {"leaf_gib": leaf["bytes"] / steps / 2**30,
               "leaf_gathers": leaf["count"] / steps,
               "token_gib": rows["bytes"] / steps / 2**30,
               "token_moves": rows["count"] / steps,
               "peak_gib": rec["peak_gib"],
               "step_ms": rec.get("step_mean_ms"),
               "collectives": {k: v / steps for k, v in
                               rec["collectives"].items()}}
        step = ("" if row["step_ms"] is None else
                f"; step {row['step_ms']:.1f} ms")
        print(f"    {label} rank {r}: a step {row['leaf_gib']:.3f} GiB of "
              f"leaves made whole ({row['leaf_gathers']:.0f} gathers), "
              f"{row['token_gib']:.3f} GiB of rows moved to the experts "
              f"and back ({row['token_moves']:.0f} moves); peak "
              f"{row['peak_gib']:.2f} GiB{step}; collectives a step "
              f"{row['collectives']}")
        out.append(row)
    return out


def phase_split_moe(dev, dry=None) -> tuple[dict, dict]:
    """Phase 29: mixtral-8x22b and deepseek-v2-lite-16b with each
    sequence split over a ``model`` axis of 2, each rank keeping its half
    of the experts and the rows gathered to them (the outputs
    reduce-scattered back), and MLA's latent gathered.  (a)
    `phase_split_moe_kernels`.  (b) Both at `split_moe_configs`' reduced
    float32 widths (TRAIN_SEQ x TRAIN_BATCH),
    two ranks sharing the card over gloo against one process, SPLIT_STEPS
    steps: each step's loss within 1e-5 relative, the ranks' first-step
    gradients gathered within GRAD_TOL of each leaf's largest one-process
    value, the launches exact (mixtral's flash at its window and offset,
    none for MLA), the top-k flips and dropped pairs and no expert leaf
    gathered over ``model`` (`split_moe_gates`), each rank's leaf and row
    GiB a step (`split_moe_moves`).
    (c) Both at full width, bf16, TRAIN_4K tokens, SPLIT_MOE_DEPTH layers,
    SPLIT_FULL_STEPS steps, one process and then two ranks: losses within
    2e-2 relative, the launches exact with every plain version refused,
    each rank's peak memory and step time, the dry run's bytes a rank
    against the measured peak (within DRY_RATIO), two ranks' peaks under
    SPLIT_TWO_RANKS_GIB where one layer more (the dry run's growth at the
    measured scale) is not, (b)'s flips, drops, expert gathers and moves.
    ``dry`` is the running `SplitDry` (one is started here without it).
    Returns (c)'s rank-0 launches of both models summed and the phase's
    figures."""
    dry = dry or SplitDry(("29",))
    try:
        return phase_split_moe_runs(dev, dry)
    finally:
        dry.kill()


def phase_split_moe_runs(dev, dry: SplitDry) -> tuple[dict, dict]:
    """`phase_split_moe` beside the process of its dry runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh

    runs = {}
    for cfg_b in split_moe_configs():
        base = get_config(cfg_b.name)
        over = {k: v for k, v in dataclasses.asdict(cfg_b).items()
                if getattr(base, k) != v}
        spec = {"arch": cfg_b.name, "over": over, "grads": True,
                "moe": True,
                "args": ["--arch", cfg_b.name, "--steps", str(SPLIT_STEPS),
                         "--lr", str(TRAIN_LR[cfg_b.name]), "--seq-len",
                         str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH)]}
        # (b)'s processes import and warm up while (a) runs; they train
        # after it
        runs[cfg_b.name] = (cfg_b, [
            SplitRun(spec, 1, f"mb1_{cfg_b.name}", held=True,
                     warm_ahead=True),
            SplitRun(spec, 2, f"mb2_{cfg_b.name}", held=True,
                     warm_ahead=True)])
    jobs = []
    for arch, depth in SPLIT_MOE_DEPTH.items():
        spec = {"arch": arch, "over": {"n_layers": depth}, "grads": False,
                "moe": True,
                "args": ["--arch", arch, "--steps", str(SPLIT_FULL_STEPS),
                         "--lr", str(TRAIN_LR[arch]), "--seq-len",
                         str(TRAIN_4K), "--batch", "1"]}
        jobs += [(spec, 1, f"mc1_{arch}"), (spec, 2, f"mc2_{arch}")]
    try:
        t0 = time.perf_counter()
        figures = {"kernels": phase_split_moe_kernels(dev)}
        print(f"    (a) {time.perf_counter() - t0:.1f} s")
        figures["b"] = {}
        t0 = time.perf_counter()
        for _, pair in runs.values():
            for run in pair:
                run.release()
        # (c)'s runs import and warm up while (b) trains
        chain = start_in_turn(jobs)
        for arch, (cfg_b, (run1, run2)) in runs.items():
            one, ranks = run1.wait()[0], run2.wait()
            split_launch_gate(cfg_b, ranks, TRAIN_SEQ, f"(b) {arch}")
            moe_figures = split_moe_gates(cfg_b, ranks, one, f"(b) {arch}",
                                          SPLIT_STEPS)
            rel = max(abs(a - b) / abs(b) for a, b in zip(
                ranks[0]["losses"], one["losses"]))
            worst, worst_at = split_grad_err(ranks, one)
            print(f"    (b) {arch} at {cfg_b.n_layers} layers, d_model "
                  f"{cfg_b.d_model}: losses {ranks[0]['losses']} against "
                  f"one process's {one['losses']} (largest relative gap "
                  f"{rel:.3g}); the ranks' gathered first-step gradients: "
                  f"worst leaf {worst:.3g} of its largest one-process "
                  f"value (leaf {worst_at} of {len(one['grads'])})")
            check(rel <= 1e-5, f"(b) {arch}: losses {rel} apart relative "
                  "(limit 1e-5)")
            check(worst <= GRAD_TOL, f"(b) {arch}: a gradient leaf is "
                  f"{worst} of its largest value off (limit {GRAD_TOL})")
            figures["b"][arch] = {"losses": ranks[0]["losses"],
                                  "one": one["losses"], "rel": rel,
                                  "grad_err": worst, **moe_figures,
                                  "moves": split_moe_moves(
                                      ranks, SPLIT_STEPS, f"(b) {arch}")}
            del one, ranks
    finally:
        for _, pair in runs.values():
            for run in pair:
                run.kill()
    print(f"    (b) both models {time.perf_counter() - t0:.1f} s from their "
          "release")
    gc.collect()
    torch.cuda.empty_cache()

    mesh = AbstractMesh((1, 2), ("data", "model"))
    card = card_line()
    launches = Counter()
    figures["c"] = {}
    # each model's one process, then its ranks
    done = run_in_turn(chain)
    runs = {arch: (done[2 * i][0][0], done[2 * i + 1][0],
                   done[2 * i][1] + done[2 * i + 1][1])
            for i, arch in enumerate(SPLIT_MOE_DEPTH)}
    t0 = time.perf_counter()
    dry_runs = dry.result()
    print(f"    (c) waited {time.perf_counter() - t0:.1f} s for the dry runs")
    for arch, (one, ranks, wall) in runs.items():
        depth = SPLIT_MOE_DEPTH[arch]
        cfg_c = dataclasses.replace(get_config(arch), n_layers=depth)
        label = f"(c) {arch} at {depth} layers"
        split_launch_gate(cfg_c, ranks, TRAIN_4K, label, SPLIT_FULL_STEPS)
        moe_figures = split_moe_gates(cfg_c, ranks, one, label,
                                      SPLIT_FULL_STEPS)
        rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                      one["losses"]))
        for who, rec in (("one process", one), ("rank 0", ranks[0]),
                         ("rank 1", ranks[1])):
            rec["step_mean_ms"] = statistics.mean(rec["step_ms"][1:])
            print(f"    {label}, {who}: losses "
                  f"{', '.join(f'{x:.6f}' for x in rec['losses'])}; steps "
                  f"{', '.join(f'{x:.1f}' for x in rec['step_ms'])} ms "
                  f"({rec['step_mean_ms']:.1f} after the first); peak "
                  f"{rec['peak_gib']:.2f} GiB; {card}")
        print(f"    {label}: the split's losses within {rel:.3g} relative "
              f"of one process's; both runs {wall:.1f} s from their "
              "release")
        check(rel <= 2e-2, f"{label}: losses {rel} apart relative (limit "
              "2e-2)")
        peak = max(r["peak_gib"] for r in ranks)
        step_ms = statistics.mean(r["step_mean_ms"] for r in ranks)
        launches.update(ranks[0]["launches"])
        against = against_whole(label, cfg_c, ranks, SPLIT_FULL_STEPS)
        moves = split_moe_moves(ranks, SPLIT_FULL_STEPS, label)
        deeper = dry_runs[arch, depth + 1][1]["mem_resident_gb"] * 1e9 / 2**30
        figures["c"][arch] = {
            "layers": depth, "losses": ranks[0]["losses"],
            "one": one["losses"], "rel": rel,
            "peak_gib": [r["peak_gib"] for r in ranks],
            "step_ms": [r["step_mean_ms"] for r in ranks],
            "one_peak_gib": one["peak_gib"],
            "one_step_ms": one["step_mean_ms"],
            "launches": [r["launches"] for r in ranks],
            "backend": ranks[0]["backend"], **moe_figures,
            "against_whole": against, "moves": moves,
            "dry_run": dry_run_against(
                cfg_c, mesh, TRAIN_4K, peak, step_ms,
                f"{label}, a rank of the split", dry=dry_runs[arch, depth]),
            "dry_run_one_deeper_gib": deeper}
        here = figures["c"][arch]["dry_run"]["resident_gib"]
        grown = peak * deeper / here     # one layer more, measured scale
        figures["c"][arch]["one_deeper_gib"] = grown
        print(f"    {label}: two ranks {2 * peak:.2f} GiB measured "
              f"({2 * here:.2f} by the dry run); at {depth + 1} layers "
              f"{2 * deeper:.2f} by the dry run, {2 * grown:.2f} at the "
              f"measured scale (limit {SPLIT_TWO_RANKS_GIB})")
        check(2 * peak <= SPLIT_TWO_RANKS_GIB < 2 * grown,
              f"{label}: {depth} layers is not the deepest under "
              f"{SPLIT_TWO_RANKS_GIB} GiB for two ranks")
    return launches, figures


# ------------------------------------ phase 30: patches and frames split --
SPLIT_PATCHES = 320        # 30b's llava patches: 512 positions, 192 tokens
# phase 30c's llava-next-34b depth (of 60): the deepest at which two ranks'
# measured peaks stay under SPLIT_TWO_RANKS_GIB (PERF.md §4); the
# one-process run at the same depth fits the card
SPLIT_VLM_DEPTH = 6


def split_encdec_vlm_configs():
    """Phase 30b's reduced float32 configs: llava-next-34b at 2 layers of
    its 56 / 8 heads of 128, d_model 1,024, d_ff 3,072, SPLIT_PATCHES
    patches (so rank 0's block of 256 positions is all patches, rank 1's
    64 patches and 192 tokens), TRAIN_VOCAB; phase 24's
    seamless-m4t-medium (full width, 2 + 2 layers, src_len 256,
    TRAIN_VOCAB)."""
    from repro_torch.configs import get_config

    llava = dataclasses.replace(get_config(LLAVA), n_layers=2, d_model=1024,
                                d_ff=3072, n_patches=SPLIT_PATCHES,
                                vocab_size=TRAIN_VOCAB, dtype="float32")
    seamless = [c for c in training_configs() if c.name == SEAMLESS][0]
    return [llava, seamless]


def phase_split_encdec_vlm_kernels(dev) -> dict:
    """Phase 30a (rows 3vo / 3bvo, 3eo / 3beo): the flash forward and
    backward kernels at a split rank's new calls, bf16, under phase 27a's
    gates: llava-next-34b's 56 / 8 heads of 128, TRAIN_4K / 2 query rows
    against TRAIN_4K keys at offsets 0 and TRAIN_4K / 2, causal;
    seamless-m4t-medium's 16 / 16 heads of 64, batch TRAIN_BATCH, its
    encoder's src_len / 2 frame rows against src_len frames and its
    cross-attention's TRAIN_SEQ / 2 decoder rows against them,
    non-causal, and its self-attention's TRAIN_SEQ / 2 rows against
    TRAIN_SEQ keys at offsets 0 and TRAIN_SEQ / 2.  Returns the figures
    by call."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)

    llava, seamless = get_config(LLAVA), get_config(SEAMLESS)
    src, half = seamless.src_len, TRAIN_SEQ // 2
    causal = lambda off: dict(causal=True, window=0,  # noqa: E731
                              q_offset=off)
    whole = dict(causal=False, window=0, q_offset=0)
    cases = [*((f"llava {off}", llava, 1, TRAIN_4K // 2, TRAIN_4K,
                causal(off)) for off in (0, TRAIN_4K // 2)),
             ("seamless encoder", seamless, TRAIN_BATCH, src // 2, src,
              whole),
             ("seamless cross", seamless, TRAIN_BATCH, half, src, whole),
             *((f"seamless self {off}", seamless, TRAIN_BATCH, half,
                TRAIN_SEQ, causal(off)) for off in (0, half))]
    figures = {}
    for label, cfg, b, sq, sk, kw in cases:
        h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        rng = np.random.default_rng(30)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, torch.bfloat16) for shape in (
            (b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d)))
        f = attn_figures(flash_attention_cuda, flash_attention_plain,
                         sdpa_flash, flash_work, (q, k, v), kw, iters=20,
                         rows=True)
        print_figures(f"flash_attention bfloat16 {label}",
                      shape_key((q, k, v), kw), f)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        bw = bwd_figures((q, k, v, o, do, lse), kw, iters=5)
        print_figures(f"flash_attention_bwd bfloat16 {label}",
                      shape_key((q, k, v), kw), bw)
        figures[label] = {"flash_attention": f, "flash_attention_bwd": bw}
        del q, k, v, do, o, lse
        gc.collect()
        torch.cuda.empty_cache()
    return figures


def phase_split_encdec_vlm(dev, dry=None) -> tuple[dict, dict]:
    """Phase 30: llava-next-34b with its patches and tokens split together
    over a ``model`` axis of 2 and seamless-m4t-medium with its encoder's
    frames split beside its decoder's tokens.  (a)
    `phase_split_encdec_vlm_kernels`.  (b) Both at
    `split_encdec_vlm_configs`' reduced float32 widths (TRAIN_SEQ
    positions x TRAIN_BATCH), two ranks sharing the card over gloo against
    one process, SPLIT_STEPS steps: each step's loss within 1e-5
    relative, the ranks' first-step gradients gathered within GRAD_TOL of
    each leaf's largest one-process value, the launches and call shapes
    exact (`split_launch_gate`).  (c) Both at full width in bf16 through
    `train_loop` with `FramedData` (its patches or frames), one process
    and then two ranks, SPLIT_FULL_STEPS steps: llava at SPLIT_VLM_DEPTH
    layers over TRAIN_4K positions (2,880 patches and 1,216 tokens),
    batch 1; seamless whole, phase 25's cell (TRAIN_SEQ x TRAIN_BATCH,
    1,024 frames): losses within 2e-2 relative, the launches exact with
    every plain version refused, each rank's peak and step time, the dry
    run's bytes a rank against the measured peak (within DRY_RATIO), two
    ranks' peaks under SPLIT_TWO_RANKS_GIB, and for llava one layer more
    (the dry run's growth at the measured scale) not.  ``dry`` is the
    running `SplitDry` (one is started here without it).  Returns (c)'s
    rank-0 launches of both models summed and the phase's figures."""
    dry = dry or SplitDry(("30",))
    try:
        return phase_split_encdec_vlm_runs(dev, dry)
    finally:
        dry.kill()


def split_full_cells():
    """Phase 30c's (config, positions of a row, batch): a patch-input
    model's row is its patches, then its text."""
    from repro_torch.configs import get_config

    return [(dataclasses.replace(get_config(LLAVA),
                                 n_layers=SPLIT_VLM_DEPTH), TRAIN_4K, 1),
            (get_config(SEAMLESS), TRAIN_SEQ, TRAIN_BATCH)]


def phase_split_encdec_vlm_runs(dev, dry: SplitDry) -> tuple[dict, dict]:
    """`phase_split_encdec_vlm` beside the process of its dry runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh

    runs = {}
    for cfg_b in split_encdec_vlm_configs():
        base = get_config(cfg_b.name)
        over = {k: v for k, v in dataclasses.asdict(cfg_b).items()
                if getattr(base, k) != v}
        spec = {"arch": cfg_b.name, "over": over, "grads": True,
                "args": ["--arch", cfg_b.name, "--steps", str(SPLIT_STEPS),
                         "--lr", str(TRAIN_LR[cfg_b.name]), "--seq-len",
                         str(TRAIN_SEQ - cfg_b.n_patches), "--batch",
                         str(TRAIN_BATCH)]}
        # (b)'s processes import and warm up while (a) runs; they train
        # after it
        runs[cfg_b.name] = (cfg_b, [
            SplitRun(spec, 1, f"vb1_{cfg_b.name}", held=True,
                     warm_ahead=True),
            SplitRun(spec, 2, f"vb2_{cfg_b.name}", held=True,
                     warm_ahead=True)])
    jobs = []
    for cfg_c, seq, batch in split_full_cells():
        spec = {"arch": cfg_c.name, "over": {"n_layers": cfg_c.n_layers},
                "grads": False,
                "args": ["--arch", cfg_c.name, "--steps",
                         str(SPLIT_FULL_STEPS), "--lr",
                         str(TRAIN_LR[cfg_c.name]), "--seq-len",
                         str(seq - cfg_c.n_patches), "--batch", str(batch)]}
        jobs += [(spec, 1, f"vc1_{cfg_c.name}"),
                 (spec, 2, f"vc2_{cfg_c.name}")]
    try:
        t0 = time.perf_counter()
        figures = {"kernels": phase_split_encdec_vlm_kernels(dev)}
        print(f"    (a) {time.perf_counter() - t0:.1f} s")
        figures["b"] = {}
        t0 = time.perf_counter()
        for _, pair in runs.values():
            for run in pair:
                run.release()
        # (c)'s runs import and warm up while (b) trains
        chain = start_in_turn(jobs)
        for arch, (cfg_b, (run1, run2)) in runs.items():
            one, ranks = run1.wait()[0], run2.wait()
            split_launch_gate(cfg_b, ranks, TRAIN_SEQ, f"(b) {arch}")
            check(ranks[0]["losses"] == ranks[1]["losses"],
                  f"(b) {arch}: the ranks' losses differ")
            rel = max(abs(a - b) / abs(b) for a, b in zip(
                ranks[0]["losses"], one["losses"]))
            worst, worst_at = split_grad_err(ranks, one)
            per_step = {k: v / SPLIT_STEPS
                        for k, v in ranks[0]["collectives"].items()}
            print(f"    (b) {arch} at {cfg_b.n_layers} layers, d_model "
                  f"{cfg_b.d_model}: losses {ranks[0]['losses']} against "
                  f"one process's {one['losses']} (largest relative gap "
                  f"{rel:.3g}); the ranks' gathered first-step gradients: "
                  f"worst leaf {worst:.3g} of its largest one-process "
                  f"value (leaf {worst_at} of {len(one['grads'])}); "
                  f"collectives a step a rank {per_step}; steps "
                  f"{[round(x) for x in one['step_ms']]} ms in one "
                  f"process, {[round(x) for x in ranks[0]['step_ms']]} a "
                  "rank")
            check(rel <= 1e-5, f"(b) {arch}: losses {rel} apart relative "
                  "(limit 1e-5)")
            check(worst <= GRAD_TOL, f"(b) {arch}: a gradient leaf is "
                  f"{worst} of its largest value off (limit {GRAD_TOL})")
            figures["b"][arch] = {"losses": ranks[0]["losses"],
                                  "one": one["losses"], "rel": rel,
                                  "grad_err": worst,
                                  "collectives": ranks[0]["collectives"]}
            del one, ranks
    finally:
        for _, pair in runs.values():
            for run in pair:
                run.kill()
    print(f"    (b) both models {time.perf_counter() - t0:.1f} s from their "
          "release")
    gc.collect()
    torch.cuda.empty_cache()

    mesh = AbstractMesh((1, 2), ("data", "model"))
    card = card_line()
    launches = Counter()
    figures["c"] = {}
    # each model's one process, then its ranks
    done = run_in_turn(chain)
    t0 = time.perf_counter()
    dry_runs = dry.result()
    print(f"    (c) waited {time.perf_counter() - t0:.1f} s for the dry runs")
    for i, (cfg_c, seq, batch) in enumerate(split_full_cells()):
        one, ranks = done[2 * i][0][0], done[2 * i + 1][0]
        wall = done[2 * i][1] + done[2 * i + 1][1]
        depth = cfg_c.n_layers
        label = f"(c) {cfg_c.name} at {depth} layers"
        split_launch_gate(cfg_c, ranks, seq, label, SPLIT_FULL_STEPS)
        check(ranks[0]["losses"] == ranks[1]["losses"],
              f"{label}: the ranks' losses differ")
        rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                      one["losses"]))
        for who, rec in (("one process", one), ("rank 0", ranks[0]),
                         ("rank 1", ranks[1])):
            rec["step_mean_ms"] = statistics.mean(rec["step_ms"][1:])
            print(f"    {label}, {who}: losses "
                  f"{', '.join(f'{x:.6f}' for x in rec['losses'])}; steps "
                  f"{', '.join(f'{x:.1f}' for x in rec['step_ms'])} ms "
                  f"({rec['step_mean_ms']:.1f} after the first); peak "
                  f"{rec['peak_gib']:.2f} GiB; {card}")
        per_step = {k: v / SPLIT_FULL_STEPS
                    for k, v in ranks[0]["collectives"].items()}
        print(f"    {label}: the split's losses within {rel:.3g} relative "
              f"of one process's; both runs {wall:.1f} s from their "
              f"release; collectives a step a rank {per_step}")
        check(rel <= 2e-2, f"{label}: losses {rel} apart relative (limit "
              "2e-2)")
        peak = max(r["peak_gib"] for r in ranks)
        step_ms = statistics.mean(r["step_mean_ms"] for r in ranks)
        launches.update(ranks[0]["launches"])
        against = against_whole(label, cfg_c, ranks, SPLIT_FULL_STEPS)
        figures["c"][cfg_c.name] = {
            "layers": depth, "positions": seq, "batch": batch,
            "losses": ranks[0]["losses"], "one": one["losses"], "rel": rel,
            "peak_gib": [r["peak_gib"] for r in ranks],
            "step_ms": [r["step_mean_ms"] for r in ranks],
            "one_peak_gib": one["peak_gib"],
            "one_step_ms": one["step_mean_ms"],
            "launches": [r["launches"] for r in ranks],
            "collectives": ranks[0]["collectives"],
            "backend": ranks[0]["backend"], "against_whole": against,
            "dry_run": dry_run_against(
                cfg_c, mesh, seq, peak, step_ms,
                f"{label}, a rank of the split", dry=dry_runs[
                    cfg_c.name, depth], batch=batch)}
        here = figures["c"][cfg_c.name]["dry_run"]["resident_gib"]
        check(2 * peak <= SPLIT_TWO_RANKS_GIB,
              f"{label}: two ranks' peaks {2 * peak:.2f} GiB pass "
              f"{SPLIT_TWO_RANKS_GIB}")
        if cfg_c.name != LLAVA:
            print(f"    {label}: two ranks {2 * peak:.2f} GiB measured "
                  f"({2 * here:.2f} by the dry run; limit "
                  f"{SPLIT_TWO_RANKS_GIB})")
            continue
        deeper = dry_runs[cfg_c.name, depth + 1][1]["mem_resident_gb"] \
            * 1e9 / 2**30
        grown = peak * deeper / here     # one layer more, measured scale
        figures["c"][cfg_c.name].update(dry_run_one_deeper_gib=deeper,
                                        one_deeper_gib=grown)
        print(f"    {label}: two ranks {2 * peak:.2f} GiB measured "
              f"({2 * here:.2f} by the dry run); at {depth + 1} layers "
              f"{2 * deeper:.2f} by the dry run, {2 * grown:.2f} at the "
              f"measured scale (limit {SPLIT_TWO_RANKS_GIB})")
        check(SPLIT_TWO_RANKS_GIB < 2 * grown,
              f"{label}: {depth} layers is not the deepest under "
              f"{SPLIT_TWO_RANKS_GIB} GiB for two ranks")
    return launches, figures


def agent_seed(agent_id: str) -> int:
    """The engine seed the reference's cluster gives an agent."""
    return zlib.crc32(agent_id.encode()) % (2**31)


def percentile(sorted_ms, q: float) -> float:
    k = min(len(sorted_ms) - 1, max(0, int(round(q * (len(sorted_ms) - 1)))))
    return sorted_ms[k]


def main() -> int:
    # Keep CUPTI attached between torch.profiler sessions (set before torch
    # loads).  By default each session's end tears CUPTI down and the next
    # re-attaches it lazily; once the process has loaded many CUDA modules
    # that drops the first records of a trace, often all of a short one
    # (PERF.md §7).
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    # Python's bytecode cache under build/ for this process and every one
    # it starts (set before torch loads): the card's machine writes none,
    # so each fresh process would compile every module it imports
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    # float32 products in full float32 (the engine lockstep of phase 7)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)

    t_start = time.perf_counter()
    # phases 28c's, 29c's and 30c's dry runs take minutes of one host core:
    # they run from here on beside the phases, and stop with the script in
    # any case
    split_dry = SplitDry()
    atexit.register(split_dry.kill)

    def phase(title: str) -> None:
        """The time since the start, then the next phase's header."""
        print(f"    ({time.perf_counter() - t_start:.1f} s since the start)")
        print(title)

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    reports = build.build()
    print(f"[2] built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in sorted(reports.items()):
        lines = ptxas_report(log)
        for line in lines:
            print(f"    {name}: {line}")
        for kernel in {"auction_bid": ("auction_solve_kernel",
                                       "auction_fused_kernel"),
                       "lcp_affinity": ("lcp_gather_kernel",),
                       "routing_fused": ("fused_phase1_kernel",),
                       "flash_attention_bwd": (
                           "delta_kernel", "dkdv_kernel", "dq_kernel",
                           "dkdv_tc_kernel", "dq_tc_kernel"),
                       "wkv6_bwd": OP_KERNELS["wkv6_bwd"],
                       "ssd_bwd": OP_KERNELS["ssd_bwd"]
                       }.get(name, ()):
            check(any(kernel in line for line in lines),
                  f"no ptxas report for {kernel}")
    if "flash_attention_bwd" in reports:
        bwd_tensor_core_spills(reports["flash_attention_bwd"])
    if "wkv6_bwd" in reports and "ssd_bwd" in reports:
        scan_bwd_tensor_core_spills(reports)
    hmma = tensor_core_counts(build.library_path("flash_attention"),
                              "flash_tc_kernel")
    label = {n: re.sub(r".*flash_tc_kernelILi(\d+)E.*", r"DP=\1", n)
             for n in hmma}
    print("    tensor-core instructions (HMMA/HGMMA) in the SASS of the bf16 "
          "flash kernel: " + ", ".join(f"{label[n]} {c}" for n, c in
                                       sorted(hmma.items())))
    check(bool(hmma) and min(hmma.values()) > 0,
          f"an instance of the bf16 flash kernel has no tensor-core "
          f"instruction: {hmma}")
    for name in ("wkv6", "ssd"):
        hmma = tensor_core_counts(build.library_path(name), f"{name}_")
        label = {n: re.sub(r".*\d((?:ssd|wkv6)_\w+?_kernel)I"
                           r"(13__nv_bfloat16|f)E.*", r"\1<\2>",
                           n).replace("13__nv_", "")
                 for n in hmma}
        print(f"    tensor-core instructions in the SASS of the {name} "
              "kernels: " + ", ".join(f"{label[n]} {c}" for n, c in
                                      sorted(hmma.items())))
        check(len(hmma) == 4 and min(hmma.values()) > 0,
              f"an instance of the {name} kernels has no tensor-core "
              f"instruction: {hmma}")

    forward_lse_check(dev)

    counts, router_figures = phase_router_kernels(dev)

    phase("[6] attention kernels against their plain versions, synthetic "
          f"full-width {ARCH} shapes")
    phase_attention(dev)

    phase(f"[7] serving-engine lockstep, CUDA vs CPU, {ARCH} full width, 2 "
          "layers, float32")
    phase_engine_lockstep(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[8] the serving slice: {ARCH} AgentEngine at full width on the "
          "card")
    engine, engine_counts, attn_rec = phase_slice(dev,
                                                  agent_seed(SLICE_AGENT))
    print("    the attention kernels at the inputs of phase 8 (up to 2 calls "
          "of each shape, weighted by the calls made)")
    flash = replay_attention(attn_rec["flash_attention"],
                             flash_attention_cuda, flash_attention_plain,
                             sdpa_flash, flash_work)
    dec = replay_attention(attn_rec["decode_attention"],
                           decode_attention_cuda, decode_attention_plain,
                           sdpa_decode, decode_work)
    for name, r in (("flash_attention", flash), ("decode_attention", dec)):
        print(f"    {name} per main-path call ({r['calls']} calls, "
              f"{r['sampled']} sampled): max abs err {r['max_abs_err']:.3g},"
              f" kernel {r['ms']:.4f} ms ({dev_text(r)}), "
              f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms,"
              f" bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    del attn_rec

    phase("[9] router to real engines: the CUDA router over two full-width "
          f"{ARCH} engines")
    phase_router_engines(dev, engine)
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.kernels.ssd import ssd_cuda, ssd_plain
    from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain

    phase("[10] scan kernels against their plain versions, synthetic "
          f"full-width {RWKV} / {ZAMBA} shapes")
    phase_scans(dev)

    phase(f"[11] recurrent engine lockstep, CUDA vs CPU, {RWKV} and {ZAMBA} "
          "at full width and cut depth, float32")
    phase_recurrent_lockstep(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[12] the {RWKV} slice: AgentEngine at full width on the card")
    rwkv, rwkv_counts, rec = phase_recurrent_slice(
        dev, RWKV, agent_seed("agent-1"), rwkv_requests(),
        ("wkv6",))
    print("    the wkv6 kernel at the inputs of phase 12 (up to 2 calls of "
          "each shape, weighted by the calls made)")
    wkv6 = replay_scan(rec["wkv6"], wkv6_cuda, wkv6_plain, wkv6_work)
    del rec

    phase(f"[13] the {ZAMBA} slice: AgentEngine at full width on the card")
    zamba, zamba_counts, rec = phase_recurrent_slice(
        dev, ZAMBA, agent_seed("agent-2"), zamba_requests(),
        ("ssd",))
    print("    the ssd kernel at the inputs of phase 13 (up to 2 calls of "
          "each shape, weighted by the calls made)")
    ssd = replay_scan(rec["ssd"], ssd_cuda, ssd_plain, ssd_work)
    del rec, zamba
    gc.collect()
    torch.cuda.empty_cache()
    for name, r in (("wkv6", wkv6), ("ssd", ssd)):
        print(f"    {name} per main-path call ({r['calls']} calls, "
              f"{r['sampled']} sampled): max abs err {r['max_abs_err']:.3g},"
              f" kernel {r['ms']:.4f} ms ({dev_text(r)}), "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})")

    phase(f"[14] mixed fleet: the CUDA router over the {ARCH} engine of "
          f"phase 8 and the {RWKV} engine of phase 12")
    phase_mixed_fleet(dev, engine, rwkv)
    del rwkv, engine
    gc.collect()
    torch.cuda.empty_cache()

    phase("[15] fused router, CUDA vs CPU, SCALE_128 fleet, 1 hub, spill on")
    fused_counts, fused_figures = phase_fused_router(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[16] closed-loop serving on real engines: launch.serve.main, "
          "9 agents, 16 coqa_like dialogues, staged and fused")
    serving = phase_serving_closed(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[17] open-loop serving at the SCALE_128 preset: EventSimulator, "
          "CUDA router")
    serving["scale"] = phase_serving_scale(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[18] the hubs-of-hubs federation: every super-hub shard's router "
          "on the card, inline and in processes of their own")
    serving["federation"] = phase_federation(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[19] attention kernels against their plain versions at the head "
          f"layouts of {', '.join(GROUP_ARCHS)} and {MIXTRAL}, bf16")
    phase_attention_groups(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[20] engine lockstep, CUDA vs CPU, {DEEPSEEK}, {MIXTRAL} and "
          f"{QWEN25} at full width, 2 layers, float32")
    phase_family_lockstep(dev)

    phase(f"[21] the new families at full width on the card: {DEEPSEEK} "
          f"whole, {MIXTRAL} at {MIXTRAL_LAYERS} of 56 layers, {QWEN25} "
          "whole")
    family_counts, family_replays = phase_family_slices(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[22] encoder-decoder and patch-input lockstep, CUDA vs CPU, "
          f"float32: {SEAMLESS} whole, {LLAVA} at full width and "
          f"{VLM_LOCKSTEP_LAYERS} layers")
    lock_counts, lock_replays = phase_encdec_vlm_lockstep(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[23] the encoder-decoder and the patch-input model at full width "
          f"on the card: {SEAMLESS} and {LLAVA} whole, bf16")
    encdec_counts, encdec_replays = phase_encdec_vlm_slices(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[23b] scan backward kernels against their plain versions, "
          f"synthetic full-width {RWKV} / {ZAMBA} shapes")
    scan_bwd_rows = phase_scan_bwd(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[24] training lockstep, CUDA vs CPU, float32: {ARCH}, "
          f"{MIXTRAL} and {RWKV} at 2 layers, {ZAMBA} at 3, {SEAMLESS} at 2 "
          "+ 2 layers; the training CLI, crash and resume, decode attention "
          "raising under grad")
    train_lock_counts = phase_training_lockstep(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[25] training at full width on the card, bf16: {ARCH} at "
          f"{TRAIN_LAYERS} of 36 layers, {RWKV} whole and {ZAMBA} at "
          f"{ZAMBA_TRAIN_LAYERS} of 81 over {TRAIN_4K} tokens, {SEAMLESS} "
          "whole")
    train_counts, train_replays = phase_training_full_width(dev)
    bwd = train_replays[ARCH]["flash_attention_bwd"]
    wkv6_bwd = train_replays[RWKV]["wkv6_bwd"]
    ssd_bwd = train_replays[ZAMBA]["ssd_bwd"]
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[26] training under the sharding policy on the card: remesh, "
          f"{ARCH} at {POLICY_LAYERS} layers under the policy and without, "
          "the dry run and roofline against phase 25's measured step")
    policy_counts, policy_figures = phase_policy(dev, bwd)
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[27] each sequence split over a model axis of 2: the flash "
          f"kernels with a query offset, then {ARCH} trained by two ranks "
          "at (1, 2) against one process, reduced in float32 and at full "
          "width in bf16")
    split_counts, split_figures = phase_split(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[28] {RWKV} and {ZAMBA} with each sequence split over a model "
          "axis of 2, the scan states and token shifts passed from rank to "
          "rank: the kernels at a rank's calls, two ranks against one "
          "process, reduced in float32 and at full width in bf16")
    rec_split_counts, rec_split_figures = phase_split_recurrent(dev,
                                                                split_dry)
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[29] {MIXTRAL} and {DEEPSEEK} with each sequence split over a "
          "model axis of 2, each rank keeping its experts, the rows and "
          "MLA's latent gathered: the flash kernels where mixtral's window "
          "masks at an offset, two ranks against one process, reduced in "
          "float32 and at full width in bf16")
    moe_split_counts, moe_split_figures = phase_split_moe(dev, split_dry)
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[30] {LLAVA} with its patches and tokens split together and "
          f"{SEAMLESS} with its encoder's frames split beside its tokens "
          "over a model axis of 2: the flash kernels at a rank's new calls, "
          "two ranks against one process, reduced in float32 and at full "
          "width in bf16")
    vlm_split_counts, vlm_split_figures = phase_split_encdec_vlm(dev,
                                                                 split_dry)

    kernels = [
        {"name": "lcp_gather", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lcp_affinity.cu",
         "replaces": "src/repro/kernels/lcp_affinity.py:40",
         "launches": counts["lcp_gather"],
         **{k: router_figures["lcp_gather"][k] for k in MEASURED},
         "library_ms": None},
        {"name": "auction_solve", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/auction_bid.cu",
         "replaces": "src/repro/kernels/auction_bid.py:112",
         "launches": counts["auction_solve"],
         **{k: router_figures["auction_solve"][k] for k in MEASURED},
         "library_ms": None},
        {"name": "lcp_affinity", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lcp_affinity.cu",
         "replaces": "src/repro/kernels/lcp_affinity.py:40",
         "launches": counts["lcp_affinity"],
         **{k: router_figures["lcp_affinity"][k] for k in MEASURED},
         "library_ms": None},
        {"name": "auction_bid", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/auction_bid.cu",
         "replaces": "src/repro/kernels/auction_bid.py:112",
         "launches": counts["auction_bid"],
         **{k: router_figures["auction_bid"][k] for k in MEASURED},
         "library_ms": None},
        {"name": "fused_phase1", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/routing_fused.cu",
         "replaces": "src/repro/core/routing_fused.py:212",
         "launches": fused_counts["fused_phase1"],
         **{k: fused_figures["fused_phase1"][k] for k in MEASURED},
         "library_ms": None},
        {"name": "auction_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/auction_bid.cu",
         "replaces": "src/repro/kernels/auction_bid.py:112",
         "launches": fused_counts["auction_fused"],
         **{k: fused_figures["auction_fused"][k] for k in MEASURED},
         "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:65",
         "launches": engine_counts["flash_attention"],
         **{k: flash[k] for k in MEASURED},
         "library_ms": flash["library_ms"]},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:43",
         "launches": engine_counts["decode_attention"],
         **{k: dec[k] for k in MEASURED},
         "library_ms": dec["library_ms"]},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/wkv6.py:72",
         "launches": rwkv_counts["wkv6"],
         **{k: wkv6[k] for k in MEASURED},
         "library_ms": None},
        {"name": "ssd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd.cu",
         "replaces": "src/repro/kernels/ssd.py:70",
         "launches": zamba_counts["ssd"],
         **{k: ssd[k] for k in MEASURED},
         "library_ms": None},
        # no Pallas kernel: the gradient of the reference's jnp attention,
        # which its training differentiates under jax.value_and_grad
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/models/attention.py:35",
         "launches": train_counts[ARCH]["flash_attention_bwd"],
         **{k: bwd[k] for k in MEASURED},
         "library_ms": bwd["library_ms"]},
        # no Pallas kernel: the gradients of the reference's chunked scans,
        # which its training differentiates under jax.value_and_grad
        {"name": "wkv6_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
         "replaces": "src/repro/models/ssm.py:121",
         "launches": train_counts[RWKV]["wkv6_bwd"],
         **{k: wkv6_bwd[k] for k in MEASURED},
         "library_ms": None},
        {"name": "ssd_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_bwd.cu",
         "replaces": "src/repro/models/ssm.py:261",
         "launches": train_counts[ZAMBA]["ssd_bwd"],
         **{k: ssd_bwd[k] for k in MEASURED},
         "library_ms": None},
    ]
    for row in kernels:
        # launches on the serving paths of phases 16 (staged, fused), 17
        # and 18 (18b's CUDA inline federation)
        row["serving_launches"] = {path: c[row["name"]]
                                   for path, c in serving.items()}
        # launches in phase 21's engines; the attention kernels' figures
        # at the inputs those engines gave them
        row["family_launches"] = {arch: c[row["name"]]
                                  for arch, c in family_counts.items()}
        # launches in phase 22 (both models, card side) and in phase 23's
        # engines and model-level runs; the attention kernels' figures at
        # the model-level calls of phase 22 (float32) and 23 (bf16)
        row["encdec_vlm_launches"] = {
            "lockstep": lock_counts[row["name"]],
            **{arch: c[row["name"]] for arch, c in encdec_counts.items()}}
        # launches in phase 24's locksteps (card side), phase 25's runs,
        # phase 26's run under the sharding policy, rank 0 of phase 27c's
        # sequence split and rank 0 of phase 28c's, 29c's and 30c's two runs
        row["training_launches"] = {
            "lockstep": train_lock_counts[row["name"]],
            **{arch: c[row["name"]] for arch, c in train_counts.items()},
            "policy": policy_counts[row["name"]],
            "split": split_counts[row["name"]],
            "split_recurrent": rec_split_counts[row["name"]],
            "split_moe": moe_split_counts[row["name"]],
            "split_encdec_vlm": vlm_split_counts[row["name"]]}
        if row["name"] in scan_bwd_rows:
            # phase 23b at 4,096 tokens, batch 2, bf16 (rows 5c / 6c beside
            # 5b / 6b): from the checkpoints, the whole-state call's device
            # ms, the saved state bytes and the scratch of both; phase
            # 28a's rank calls from the checkpoints and from every state
            # (rows 5co / 6co beside 5bo / 6bo)
            row["checkpointed"] = {
                k: scan_bwd_rows[row["name"]].get(k) for k in (
                    *MEASURED, "library_ms", "whole_device_ms",
                    "saved_state_bytes", "whole_saved_state_bytes",
                    "scratch_bytes", "whole_scratch_bytes")}
            row["split_checkpointed"] = {
                call: {k: rec_split_figures["kernels"][key][k]
                       for k in (*MEASURED, "library_ms")}
                for call, key in (("checkpoints", row["name"]),
                                  ("every_state", f"{row['name']} whole"))}
        if row["name"].endswith("_bwd"):
            row["training_replays"] = {
                arch: {k: r[row["name"]].get(k) for k in (
                    *MEASURED, *ERROR_FIGURES[1:], "library_ms", "calls",
                    "step_ms", "peak_gib")}
                for arch, r in train_replays.items() if row["name"] in r}
        if row["name"] in ("flash_attention", "flash_attention_bwd"):
            # phase 29a's call (rows 3ow / 3bow): mixtral's window masking
            # at a rank's offset
            row["split_window"] = {
                k: moe_split_figures["kernels"][row["name"]][k]
                for k in (*MEASURED, "library_ms")}
            # phase 30a's calls (rows 3vo / 3bvo, 3eo / 3beo): llava's and
            # seamless's blocks of a rank
            row["split_encdec_vlm"] = {
                call: {k: f[row["name"]][k] for k in (*MEASURED,
                                                      "library_ms")}
                for call, f in vlm_split_figures["kernels"].items()}
        if row["name"] in ("flash_attention", "decode_attention"):
            pick = lambda r: {k: r[row["name"]][k] for k in  # noqa: E731
                              (*MEASURED, "library_ms", "calls")}
            row["family_replays"] = {arch: pick(r) for arch, r in
                                     family_replays.items()}
            row["encdec_vlm_replays"] = {
                **{f"{arch} float32": pick(r)
                   for arch, r in lock_replays.items()},
                **{arch: pick(r) for arch, r in encdec_replays.items()}}
    # phase 26c's dry-run figures beside phase 25's and 26b's measurements
    print(json.dumps({"dry_run": policy_figures}))
    # phase 27: the offset kernels (bf16) and the split runs
    print(json.dumps({"split": split_figures}))
    # phase 28: the recurrent kernels at a rank's calls (bf16) and the runs
    print(json.dumps({"split_recurrent": rec_split_figures}))
    # phase 29: the windowed offset kernels (rows 3ow / 3bow) and the runs
    print(json.dumps({"split_moe": moe_split_figures}))
    # phase 30: the kernels at llava's and seamless's blocks and the runs
    print(json.dumps({"split_encdec_vlm": vlm_split_figures}))
    print(f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
