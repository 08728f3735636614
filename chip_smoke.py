#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (a failing run exits non-zero
and never prints the final ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the build: every kernel from a cold ``build/repro_torch`` (one nvcc
   per CUDA C++ source — paged attention, flash attention, the selective
   scan, the sLSTM — started
   together and linked into one library; Triton's JIT for the RMSNorm
   forward and backward), nvcc and Triton in parallel;
3. each serving kernel against its plain PyTorch version on the card at
   the serving shapes (decode rows; a free slot's idle row in a pow2-wide
   table; the widest one-shot prefill's norm rows; paged attention's split
   edges: rows ending on and one token past a split boundary, empty
   splits, idle rows, a batch of idle rows, a one-page table, K = 1 and
   5) within f32 2e-5, bf16 2e-2, with its time (CUDA events, median of
   30 after warm-up, L2 flushed before each launch), the plain version's
   time (the slow flash and scan references: median of 5), the library
   call's time and the bound; paged attention's
   library time is the faster of SDPA over K/V repeated to all heads and
   SDPA with ``enable_gqa=True`` (named in ``library``), and each case
   prints the split plan the wrapper chose;
4. the training kernels the same way: flash-attention forward and
   backward at the train cell's heads with B = 1 and the train step's
   B = 4 (S = 4096), a ragged S = 1000 (bf16 and f32), MHA, and bf16 at
   D = 64 (S = 1000) and D = 16 (S = 300), and the RMSNorm forward and
   backward at the train cell's three row shapes and at 262143 x 128, a
   row count no row tile divides (each case prints the plan the wrapper
   chose; two backward calls must agree bit for bit);
5. serve: qwen3-0.6b at full width in bf16 (random weights from a seed)
   through the continuous-batching paged scheduler: 16 requests, 8
   slots, prompts 128/256/512, 64 new tokens each, greedy; every logit
   row must be finite and both kernels' launch counters must match the
   decode and prefill steps taken; then one decode step over 8 filled
   slots under the profiler (device time by kernel group, busy share);
6. an f32 recompute at full width: 2 served requests re-run through the
   dense causal forward (no pages, no paged kernel) must pick the served
   token at every generated position, save top-2 ties within 1e-4;
7. train: qwen3-0.6b at full width in bf16 (seed 0), B = 4, S = 4096,
   Adam lr 1e-3, clip 1.0, remat full, 6 steps through
   ``repro_torch.launch.train``'s functions; every loss finite, the
   validation loss (seed 987654) lower after the steps than before, a
   nonzero finite gradient on every parameter, and per step 56 flash
   forward, 28 flash backward, 225 RMSNorm forward and 113 RMSNorm
   backward launches; prints step time, tokens/s, peak memory and mfu,
   then profiles one more step (device time by kernel group, busy share);
8. train parity: full width at 2 layers, f32, TF32 off, B = 1,
   S = 4096: two train steps through the kernels against two through
   their plain versions on the same card (loss, every gradient, each
   tensor's weight update; tolerances at ``PARITY_TOL``);
9. the recurrent slice's kernels against their plain versions in f32
   (``|err| <= 1e-4 + 1e-4 |want|`` over up to 500 sequential steps, y /
   h and the final state): the selective scan at jamba's serve shape
   (B = 1, S = 500, d_in = 16384, N = 16), a ragged S = 37, B = 2, and
   (2, 100, 1000, 8), a d_in no channel block divides, each printing the
   lane split the wrapper chose and a bound that counts the exponentials
   at the special-function units' rate; the
   sLSTM at xlstm-125m's (B = 1, S = 500, d = 768, H = 4), at (3, 33, 96,
   2) and at (2, 40, 392, 2), a head of 196 channels that a cluster of 8
   does not divide, each printing the cluster size the wrapper chose; and
   the kernels the recurrent serve phases give new widths: paged
   attention at jamba's 8 query heads per KV head (K = 1 and 5, f32 and
   bf16, and the split edges as in phase 3), RMSNorm at d = 768 and
   d = 8192;
10. serve_xlstm: xlstm-125m FULL in bf16 (seed 0), 16 requests, 8 slots,
    16-token pages, prompts 100/300/500, 64 new tokens, greedy; every
    logit row finite, 3 sLSTM-scan launches per prefill and 13 RMSNorm
    launches per model call;
11. serve_hybrid: jamba without experts, one period at the published
    widths (``jamba_15_large.NOEXP_8L``, ~9.0 B parameters) in bf16 (seed
    0), 8 requests, 8 slots, prompts 100/300/500, 32 new tokens; every
    logit row finite, 7 selective-scan launches per prefill, 1
    paged-attention launch per decode step and 17 RMSNorm launches per
    model call;
12. recompute_recurrent: both configs in f32, TF32 off, 2 requests each
    (prompts 100 and 300, 16 new tokens): every served token is the
    argmax of ``lm_forward`` over the served sequence, save top-2 ties
    within 1e-4;
13. gan_parity: the paper's CycleGAN at full width (101,322,365
    parameters) in f32, TF32 off, B = 32, the same seed weights and JAG
    batches: two ``make_gan_steps`` train steps on the card against two on
    the CPU, each from the same weights and Adam state (``g_loss`` and
    ``d_loss`` to 1e-5 relative, each weight tensor's Adam update to 1e-3
    of its L2 norm over its well-conditioned elements, save the few whose
    update flips sign), and each step run in f64 on the card and on the
    CPU as the witness over every element (the f64 updates agree to 1e-6,
    the f32 card's stays within the step's f32 floor as the CPU shows it;
    each tensor's ill-conditioned share is printed; ``GAN_PARITY_TOL``);
14. ltfb: LTFB tournament training of the full-width CycleGAN through
    ``repro_torch.launch.ltfb``'s functions: 4,096 JAG samples in 8
    bundles of 512 at 64 x 64 in a temp dir (7 training files, 1 held
    out), K = 4 trainers time-sharing the card, batch 32, 3 rounds x 25
    steps, scope ``generator``, store ``preload``; every metric finite,
    the best validation metric after round 3 below the initial
    population's best on the same batch, the tournament's exchange bytes
    equal to the paired candidates times the generator's bytes, and a
    population checkpoint saved after round 3 restoring bit-equal into a
    fresh orchestrator at the same round; prints step time, samples/s,
    data wait and tournament time, the efficiency snapshot, peak memory,
    one profiled GAN step (device time by group) and its bound; then both
    CLIs as a user calls them: ``repro_torch.launch.ltfb.main`` resuming
    from that checkpoint for a fourth round and ``repro_torch.launch.
    train.main`` with ``--arch icf-cyclegan`` for 20 steps (on 1,024 JAG
    samples since the eighteenth slice; the CLI's default 8,000 before),
    each printing
    finite values; no kernel of the port may launch (the nets are f32
    MLPs); the ltfb CLI's round is saved, both population steps' winners
    are exported for phase 17 and the trainer files deleted;
15. ltfb_lm: LTFB over two qwen3-0.6b trainers at full width, cut to
    ``LM_POP_LAYERS`` = 8 of its 28 layers (``--num-layers``; all 28
    until the eighteenth slice, which cut it for room), in bf16
    through ``repro_torch.launch.ltfb``'s functions (B = 2, S = 4096,
    Adam, 2 rounds x 3 steps, scope full; 64 rows of 4,097 tokens in 4
    shards), round 1's winner file written from the trainers in memory
    (as ``export_winner`` picks it; until the sixteenth slice round 1
    saved a population checkpoint to export it from) and a population
    checkpoint of ~12 GB after round 2, its winner exported; every
    loss and metric finite, the flash and RMSNorm counters equal to the
    steps times the train phase's per-step launches plus the metric
    forwards' (28 flash forward and 113 RMSNorm launches each), the
    exchange bytes equal to the paired candidates times the model's bytes,
    no step writing into weights it was given (round 2 steps from round
    1's tensors, and trainer 0 adopts trainer 1's weights by reference and
    steps), and the round-2 population restoring bit-equal into a fresh
    orchestrator; prints step ms, tokens/s per trainer, tournament
    seconds, the checkpoint's bytes and save/restore seconds, peak memory;
16. serve_swap: qwen3-0.6b at phase 15's depth in f32, TF32 off, served
    from phase 15's winners through ``Scheduler(registry=..., watch_every=2,
    swap_mode="drain")`` with pinned prefix pages: 8 requests over 4
    slots, prompts 128/256 (requests 4-7 repeat 0-3's prompts), 32 new
    tokens, greedy; round 2's winner lands in the directory before step 6;
    one hot swap, no request across both weights, every served token the
    argmax of ``lm_forward`` on the weights that served it (save top-2 ties
    within 1e-4), no request admitted after the swap mapping an old page,
    the paged-attention and RMSNorm counters matching the steps; then a
    torn ``winner_step_3.ckpt`` is quarantined while round 2's serves on;
    prints the swap's latency (the poll that finds the file to the first
    token on the new weights);
17. surrogate: the CycleGAN surrogate at full width (49,167 outputs a row)
    in f32, TF32 off, served from phase 14's winners through
    ``SurrogateEngine`` (max_batch 128, bucket 8): 256 queries of 8 rows,
    the next step's winner landing mid-run; every row matches ``predict``
    on the weights that answered it to 1e-5, some staging overlapped, no
    kernel counter moves; prints rows/s, one profiled batch's device time
    and its copy to the host, and the batch's bound;
18. the CLIs as a user calls them, each printing finite values: the serve
    CLI for ``--arch icf-cyclegan --ckpt-dir`` (phase 14's winners) and for
    ``--arch qwen3-0.6b --ckpt-dir --num-layers 8 --requests 4`` (phase
    15's population:
    the winner exported on the way), the LM ltfb CLI for one round without
    saving under ``--log-json`` (from scratch since the sixteenth slice;
    it resumed phase 15's population before), and the train CLI with
    ``--batch 1 --seq 1024 --steps 3`` (until the sixteenth slice also
    ``--ckpt-every 2`` and a rerun that resumed at step 2); since the
    thirteenth slice also the serve CLI with ``--layout dense`` on phase
    15's population and the train CLI with ``--optimizer adafactor
    --ckpt-every 2`` (checkpoints in JAX's layout) and its rerun that
    resumes at step 2;
19. arch_kernels (in the kernel phases, after phase 9): each kernel at
    the shapes the seven archs of the ninth slice give it, against its
    plain version and timed as in phase 3: paged attention in bf16 at
    K = 1 over 8 rows of 100-544 tokens for 24 heads of 64 over 24 KV
    heads (musicgen), 32 over 32 (codeqwen), 16 over 2 (qwen2.5), 32
    over 8 (granite, phi) and 16 over 16 (deepseek), all D = 128 but
    musicgen's; flash forward and backward in bf16 at B = 2, S = 4096
    for 28 heads over 4 (qwen2-vl) and 16 over 16 (deepseek); the
    RMSNorm forward at 8 rows and the forward and backward at 8192 rows
    of d = 1536, 2048, 3584 and 4096;
20. serve_archs: qwen2.5-3b, codeqwen1.5-7b, granite-8b and
    musicgen-medium at FULL in bf16 (seed 0), one at a time: 8 requests
    over 4 slots, prompts 128/256, 32 new tokens, greedy; every logit
    row finite, one paged-attention launch per layer and decode step and
    the RMSNorm launches of every model call exact; prints decode
    tokens/s, TTFT, peak memory;
21. serve_moe: deepseek-moe-16b FULL (16.38 B parameters, 2.83 B active)
    and phi3.5-moe ``CUT_16L`` (16 of 32 layers, 21.07 B) in bf16: 8
    requests over 8 slots, prompts 128/256/512, 32 new tokens, MoE
    dropless; the same checks, and one decode step over every slot
    profiled by part (attention, routing, the expert products, other);
22. recompute_archs: the six new token archs at full width cut to 2
    layers, in f32, TF32 off: two served requests each (prompts 64 and
    200, 16 new tokens) re-run through ``lm_forward`` (MoE dropless, as
    the served paths run it) pick every served token, save top-2 ties
    within 1e-4;
23. train_moe: deepseek-moe-16b at full width cut to 4 layers (1 dense +
    3 MoE, 2.27 B parameters) in bf16, B = 2, S = 4096, Adam lr 1e-3,
    remat full, 6 steps: losses and aux losses finite (aux positive), a
    nonzero finite gradient on every weight, the flash and RMSNorm
    launches of each step exact; prints step time, tokens/s, the mfu
    over active parameters, peak memory and the share of (token, choice)
    pairs dropped;
24. train_vlm: qwen2-vl-7b at full width cut to 8 layers (2.95 B) the
    same way, on ``train_batch``'s embeddings and M-RoPE positions (flash
    at 7 query heads a KV head; the token embedding, which the
    embeddings replace, takes no gradient); then a 2-layer forward at
    S = 256 in f32 (TF32 off) on the card against the CPU within 1e-3;
25. serve_spec (run right after phase 15, while its population is on
    disk): population speculative decoding.  The paged kernel at the
    verify shapes against its plain version, timed as in phase 3 (bf16
    H = 16 over 2 KV heads, D = 128, K = 5 and 8 -- qwen2.5-3b's 40 and 64
    rows; H = 16 over 8 at K = 5 in bf16 and f32 -- qwen3-0.6b's; lengths
    114-499 and the split edges of a 36-page table).  spec_arch:
    qwen2.5-3b FULL in bf16 (random weights, seed 0), 16 requests over 8
    slots (the first 8 admitted in one step), prompts 128/256/512, 16 new
    tokens, greedy, 4 draft tokens a round: target-only, a self drafter
    and a qwen3-0.6b FULL drafter (``draft_cfg``), each speculative
    stream equal to the target-only one
    save where it first parts at a target-only top-2 gap below 0.25 (bf16;
    such partings are counted); one plain decode round and one speculative
    round profiled with every slot busy, the round's device time split by
    the ranges ``draft``, ``verify`` and ``rollback``.  spec_pop: phase
    15's latest winner in f32 (TF32 off) verifies, its earliest winner
    drafts (``load_draft``): 8 requests over 4 slots, prompts 128/256, 8
    new tokens, fused, sequential, fused at temperature 0.8 (a seed a
    request) and ``spec_adapt``, each identical to target-only decoding
    save top-2 ties within 1e-4; then the serve CLI with ``--draft-ckpt
    --spec-tokens 3 --spec-adapt``.  spec_recurrent: xlstm-125m FULL in
    f32 with a self and a fresh-seed drafter (exact save ties; the fresh
    one must replay) and jamba ``NOEXP_8L`` in bf16 with a self drafter
    (the bf16 rule; 8 requests admitted in one step, one round profiled
    with every slot busy), its snapshot timed.  A run with more requests
    than slots admits each late one into a freed slot (counted and
    checked).  Every run's launches are exact: per verify, replay or
    plain step one paged launch per attention layer of the session, per
    fused round Kv per drafter attention layer, the RMSNorm
    launches of every forward, a scan per recurrent layer and prefill;
    a fused run drafts once a round, a sequential one more than K times;
26. recurrent_bwd_kernels (in the kernel phases, after phase 19): the
    two backward kernels (no TPU kernel is their counterpart: JAX
    differentiates the ``lax.scan`` twins) against their plain backwards
    in f32, every gradient within 1e-4 of its largest entry
    (``SCAN_BWD_TOL``) and bit-equal over two calls:
    ``mamba_scan_bwd`` at jamba's train shape (B = 2, S = 4096, d_in =
    16384, N = 16), its serve prompt (1, 500), (2, 100, 1000, 8) with a
    channel tail, a case with a nonzero final-state cotangent and (1, 45,
    200, 8), whose last 64-channel block holds 8 channels, each line with
    the sweep's blocks an SM and shared bytes a block
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and its share of
    the bound; ``slstm_scan_bwd`` at xlstm's train shape (4, 4096, 768,
    4), (1, 500, 768, 4), (2, 40, 392, 2) with a masked tail, a case with
    nonzero final-state cotangents and (2, 64, 768, 4) at exact ties of
    the stabiliser's max (checked on the forward's saved values), each
    line with the product ``d_r_h`` timed alone and the recurrence's us
    a step; the plain versions timed at S <= 500 only (at S = 4096 their
    one comparison call is timed on the host clock); and the RMSNorm
    forward and backward at jamba's train rows (8192 x 8192 bf16);
27. train_recurrent: xlstm-125m FULL (B = 4, Adam) and jamba
    ``NOEXP_8L`` (9.0 B parameters, published widths, no experts; B = 2,
    Adafactor: Adam's two f32 moments would not fit one card beside the
    bf16 weights and gradients) in bf16, S = 4096, remat full, 4 steps on
    ``launch.train``'s batches: every loss finite, a finite nonzero
    gradient on every weight at steps 0 and 3, the per-step launches of
    both scans and their backwards (each scan forward twice a step, its
    backward once), flash (jamba) and RMSNorm both ways exact; prints
    step ms, tokens/s, peak memory, mfu and one profiled step by kernel
    group; then a 4-layer xlstm and a 1-layer jamba (its Mamba layer; 2
    layers until the eighteenth slice) at full width in f32
    (TF32 off), B = 1, S = 256: the card's loss and every gradient
    against the CPU's (``PARITY_TOL``'s loss and gradient tolerances;
    xlstm's gradients within twice a measured f32 floor,
    ``RECURRENT_PARITY``);
28. ltfb_recurrent: ``repro_torch.launch.ltfb.main`` over xlstm-125m at
    full width in bf16 as a user calls it: 2 trainers, 1 round x 2 steps,
    B = 2, S = 1024, Adam, ``--ckpt-dir``, then a rerun under
    ``--log-json`` that resumes for a second round (its ``ltfb_resumed``
    record at round 1, one ``ltfb_round``); finite values, the sLSTM scan,
    its backward and RMSNorm launched; prints the tournament lines, the
    step ms and the checkpoint seconds;
29. a ``kernels`` line (``launches_by_path`` with one entry per new
    path and arch), the ``nvidia-smi`` line, and the ``ok`` line.
30. serve_dense (run after phase 6): phase 5's trace (qwen3-0.6b FULL
    bf16, 16 requests over 8 slots, prompts 128/256/512, 64 new) through
    ``Scheduler(layout="dense")``, slot rows of 576 tokens: every logit
    row finite, no paged-attention launch, the RMSNorm launches of every
    prefill and decode step exact; prints tokens/s, TTFT and TPOT beside
    phase 5's and one profiled decode step; then one 4,096-token prompt
    and 32 new tokens on a one-slot pool, whose prefill launches flash
    forward once a layer (28);
31. recompute_dense (after phase 30), f32, TF32 off: qwen3-0.6b FULL (8
    prompts of 128, 64 new) and xlstm-125m FULL (4 of 128): the dense
    scheduler, the paged scheduler and ``Engine.generate`` over one
    uniform batch of the same prompts give the same greedy tokens (the
    schedulers' streams may part only at a top-2 tie within 1e-4; the
    engine's, whose prefill is one batch, at a gap below twice the
    logit difference this run measures between a batched and a one-row
    prefill), and every dense token is the argmax of ``lm_forward``,
    save ties within 1e-4;
32. train_remat (after phase 7): the train cell (B = 4, S = 4096, Adam,
    seed 0) for 4 steps under ``remat`` full, dots and dots_no_batch
    from the same weights: first-step losses bit-equal, each step's
    launches the train phase's, step ms (median of the last 3) and peak
    memory per policy;
33. serve_lifecycle (after phase 31): qwen3-0.6b at full width and 8 of
    its 28 layers (since PR 30) in f32, TF32 off,
    8 requests over 4 slots, prompts 128/256/512, 32 new tokens, the even
    rids greedy and the odd ones at temperature 0.8: (1) the crash drill
    -- the trace with a write-ahead journal, then again with ``crash@20``,
    the journal replayed into a fresh scheduler whose stitched streams
    equal the uninterrupted ones (a parting only at a top-2 gap below
    1e-4, counted); (2) the lifecycle script -- ``max_queue=4`` refuses a
    fifth submit, ``shed_expired`` takes a queued request past its TTFT
    deadline, ``cancel`` takes one in a chunked prefill (``prefill_chunk
    =64``) and one in decode, ``stall``, ``oom`` and ``disconnect`` fire,
    every counter exact, the pool's free pages back at their start, the
    completed streams equal to (1)'s; (3) the HTTP gateway on port 0 --
    the 8 requests at once (4 streamed), tokens equal to (1)'s, a 429 at
    ``max_queue`` and on a missed deadline, an idempotent replay,
    ``/metrics`` as text and JSON, a drain with 503s; the paged and
    RMSNorm launches of (1)-(3) exact (8 per decode step, 33 per model
    call); (4) the serve CLI's SIGKILL drill in subprocesses (at
    ``--num-layers 8``) --
    ``--journal J --fault-spec kill@10`` returns -9, ``--resume-journal J
    --out-json R`` finishes without rebuilding a kernel, R's streams equal
    an in-process run of the same trace; prints the journal's lines,
    bytes and cost a step, the gateway's tokens/s beside the scheduler's.
34. serve_arena (after phase 16, before phase 17): the online LTFB arena
    on phase 15's round-2 population, each part on hard links of its
    files so phase 18 reads it untouched: 8 requests over 4 slots,
    prompts 128/256, 32 new tokens, 4 draft tokens a round.  (a) twins
    (both trainers link trainer 0's file) in f32, TF32 off, policy
    shadow, window 64, min_samples 8, margin 0.3, hysteresis 1, a match
    every 2 steps, ``swap_mode="drain"``, a journal and write-back (rows
    of 65 tokens, 4 a shard): exactly one rule-driven promotion to
    trainer_1 with both archives' sidecars verified, the journal's matches
    and one promotion, streams identical to target-only decoding (save
    top-2 ties within 1e-4), two (4, 65) shards whose rows are prompt +
    generated tokens, the lineage CLI ending at the promotion; then the
    trace again with ``crash@N`` 3 steps after its promotion, a fresh
    ``Arena.from_population`` restored from ``replay_arena`` equal to the
    journaled snapshot, the resumed streams stitched equal to the
    uninterrupted ones and the write-back's rows the same.  (c) the real
    roster in bf16 behind an in-process gateway on port 0:
    ``/population``, ``/arena/promote`` of an unknown member, the
    champion and the challenger (400, 400, 200 queued), 4 requests, the
    override promoting in step 1 through verified archives, ``/population``
    naming the new champion, ``/metrics`` the arena's families; the paged
    and RMSNorm launches of (a) and (c) exact.  (b) the serve CLI's
    ``--arena`` on the real roster (``--arena-policy epsilon``): rc 0,
    finite ``[arena]`` rates, the members' offered and accepted summing to
    the run's ``spec_draft_proposed`` / ``spec_draft_accepted``.  Prints
    the seconds of ``prepare_promotion`` (two archives and their sha256
    inside one scheduler step), of a drafter's ``set_params`` and of the
    rosters' loads.
35. ltfb_mesh (after phase 14): LTFB across process ranks, every rank a
    process on the one card over gloo (NCCL refuses two ranks on one
    device), all parts started together.  (a) four ranks of the
    full-width CycleGAN in f32, generator scope, ``--backend mesh``,
    2 rounds x 5 steps through ``TournamentOrchestrator.run``: every
    rank's decision equals a replay of both candidates' metrics from the
    pair's pre-tournament states (swapped again in full precision for
    the check), an adopted generator is bit-equal to the partner's, the
    discriminator and the pre-tournament weights untouched, wins and
    adoptions the same on every rank; (b) the same under the int8
    exchange, every adopted tensor within half a quantization step of
    the partner's; (c) ``repro_torch.launch.ltfb.main --backend mesh
    --quantize-exchange`` in torchrun's form over qwen3-0.6b at full
    width cut to 2 layers, bf16, K = 2, B = 1, S = 4096, 1 round x 2
    steps: rc 0, rank 0's records JAX's (``backend=mesh``), each rank's
    flash and RMSNorm launches exact; (d) the ltfb CLI's two ranks, rank
    1 SIGKILLed after rank 0's first round: rank 0 fails on its own
    within ``--dist-timeout``; (e) ``init_ranks("nccl", "cuda")`` with two
    ranks on the card raises the port's ``RankLayoutError`` before any
    process group.  Prints the dist backend, the ranks, each exchange's
    ms and bytes on the wire.
36. serve_mesh (after phase 5, on its model and traffic): mesh serving.
    (b) the sharded paged dispatch at qwen3's serve shape (B = 8, H = 16
    over 8 KV heads, D = 128, K = 1 and 5, bf16 and f32, data 2 and 4,
    the last row of every shard idle on its shard's null page) against
    its plain version and one unsharded launch over the global tables,
    within phase 3's tolerances, each timed; (a) phase 5's trace through
    ``MeshScheduler`` at data 2 and 4 in bf16 (every logit finite, data x
    28 paged launches a decode step and the RMSNorm launches of every
    model call exact; tokens/s and TPOT beside phase 5's), then the model
    in f32 (TF32 off) through the single-device scheduler and the mesh at
    data 2 and 4: every stream equal to the single-device one, save
    partings at a top-2 gap below 1e-4 (counted); (c)
    ``repro_torch.launch.distributed`` with qwen3-0.6b FULL bf16 replicas
    on a 2,1 mesh over gloo, as 1 and 2 torchrun ranks: both ranks'
    streams bit-identical to each other, to the 1-rank run and to the
    same trace through this process's mesh, rank 0's Prometheus text with
    rank 1's series, every rank's launches exact; and the spawner's drill
    (``--procs 2 --journal --fault-spec kill@12:rank=1
    --restart-on-failure 1``): the job restarts once and its stitched
    streams equal the uninterrupted ones, save partings at a bf16 top-2
    gap below 0.25 (counted); prints the seconds rank 0 took to fail after
    its peer's SIGKILL.
37. serve_tp (after phase 36, its ranks started inside phase 36's window
    of ranks): the serving mesh's ``model`` axis. (a) the paged kernel at
    a model rank's shape (qwen3 at model 2: bf16 B = 8, H = 8 over 4 KV
    heads, D = 128, 16-token pages, K = 1, rows of 170-569 tokens)
    against its plain version, timed beside its bound and SDPA, and
    RMSNorm at the rank's k-norm rows (8 x 4 x 128); (b)
    ``repro_torch.launch.distributed --procs 2 --mesh 1,2 --dist-backend
    gloo``: two model ranks of qwen3-0.6b FULL sharing the card, 8
    requests over 8 slots, prompts 128/256/512, 16 new tokens, in bf16
    and (``--dtype float32``) in f32, each against the single-device
    scheduler in this process on the same weights and trace: the two
    ranks' streams identical, a stream parting from the single-device
    one only at a top-2 gap below 1e-4 (f32) or 0.25 (bf16), counted;
    each rank's launches exact (28 paged a decode step over its 8 q
    heads, 113 RMSNorm a model call); 58 model-group collectives a
    decode step; prints tokens/s and TPOT beside phase 5's and the
    single-device runs', the model group's ms and bytes a decode step;
    (c) rank 1 of a bf16 job SIGKILLs itself at step 6 and rank 0 fails
    on its own, naming the dead peer, within its step timeout.  One pair
    of rank processes runs (b) in bf16, (b) in f32 and (c), one after
    the other.

Needs one CUDA card, the CUDA toolkit (``nvcc``) and ``triton``; exits 1
without a card and 2 when run outside a checkout of the repo.
"""
import dataclasses
import functools
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 rate and dense peak rates (the paged
# kernel and the plain versions compute in f32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# exponentials run on the special-function units, 16 results per clock per
# SM against the 256 f32 flops (128 FMAs) per clock the f32 peak counts
SFU_PER_S = PEAK_OPS_PER_S["float32"] / 16
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:106",
            "rmsnorm": "src/repro/kernels/rmsnorm.py:25",
            "rmsnorm_bwd": "src/repro/kernels/rmsnorm.py:25",
            "flash_attention_fwd": "src/repro/kernels/flash_attention.py:85",
            "flash_attention_bwd": "src/repro/kernels/flash_attention.py:85",
            "mamba_scan": "src/repro/kernels/mamba_scan.py:65",
            "slstm_scan": "src/repro/kernels/slstm.py:86",
            "mamba_scan_bwd": "none: JAX differentiates the lax.scan twins "
                              "ssm._mamba_core / xlstm.slstm_block "
                              "(src/repro/models/ssm.py:96)",
            "slstm_scan_bwd": "none: JAX differentiates the lax.scan twins "
                              "ssm._mamba_core / xlstm.slstm_block "
                              "(src/repro/models/xlstm.py:288)"}
SOURCES = {"paged_attention": "src/repro_torch/csrc/paged_attention.cu",
           "rmsnorm": "src/repro_torch/kernels/rmsnorm.py",
           "rmsnorm_bwd": "src/repro_torch/kernels/rmsnorm.py",
           "flash_attention_fwd": "src/repro_torch/csrc/flash_attention.cu",
           "flash_attention_bwd": "src/repro_torch/csrc/flash_attention.cu",
           "mamba_scan": "src/repro_torch/csrc/mamba_scan.cu",
           "slstm_scan": "src/repro_torch/csrc/slstm.cu",
           "mamba_scan_bwd": "src/repro_torch/csrc/mamba_scan.cu",
           "slstm_scan_bwd": "src/repro_torch/csrc/slstm.cu"}
ROUTES = {"paged_attention": "cuda", "rmsnorm": "triton",
          "rmsnorm_bwd": "triton", "flash_attention_fwd": "cuda",
          "flash_attention_bwd": "cuda", "mamba_scan": "cuda",
          "slstm_scan": "cuda", "mamba_scan_bwd": "cuda",
          "slstm_scan_bwd": "cuda"}
# the scans: f32 over up to 500 sequential steps
SCAN_TOL = 1e-4
# the scans' backwards: f32, each gradient within 1e-4 of its largest entry
# (d_a sums B * S terms, d_B and d_C the d_in channels, each in another
# order than the plain version's; the kernels' exponentials are ex2.approx
# on the special-function units)
SCAN_BWD_TOL = 1e-4
# the plain backwards are timed (median of the Timer's launches) up to this
# many steps; past it their one comparison call is timed on the host clock
PLAIN_TIMED_S = 500
# train_recurrent: (phase's name for the model, arch, B, optimizer) at S =
# 4096, bf16, remat full, 4 steps (6 took the whole script past 1000 s of
# its 1200; the step time is the median of steps 1-3)
TRAIN_RECURRENT = (("xlstm", "xlstm-125m", 4, "adam"),
                   ("jamba", "jamba-1.5-large-398b", 2, "adafactor"))
TRAIN_RECURRENT_STEPS = 4
# the parity runs at B = 1, S = 256, f32: (layers, each recurrent kind of
# the stack present; a conditioning witness).  Each gradient is held to
# PARITY_TOL["grad_rel"] of its largest entry against the CPU's, or, with
# the witness, to FLOOR_X times the step's f32 floor: the largest change
# of a gradient on the CPU when the token embeddings move by 1e-7 of
# themselves (an f32 rounding of the stack's input).  At random weights
# the mLSTM's gradients are ill-conditioned in f32 (its stabilised
# division max(|den|, exp(-m)) and the chunk's exponentials): such a
# change moved xlstm's mLSTM weight gradients by up to 1.2e-4 of their
# largest entry on a CPU, and in a run on the card, where the forward's
# loss matched the CPU's to the bit, blocks.1.mixer.wv read 3.1e-4 from
# the CPU's while the floor there read 6.4e-4.  jamba's stack has no mLSTM
# (its parity held at 1.5e-5) and takes no witness; its Mamba layer alone
# since the eighteenth slice (its second layer was one more of the same
# kind, ~17 s of the CPU's copies and products)
RECURRENT_PARITY = {"xlstm": (4, True), "jamba": (1, False)}
RECURRENT_PARITY_S = 256
FLOOR_EPS, FLOOR_X = 1e-7, 2.0
# ltfb_recurrent: the ltfb CLI over xlstm-125m FULL, bf16 (its dtype); one
# round, saved, then a rerun that resumes for a second (2 + 1 rounds took
# the whole script past 1000 s of its 1200)
LTFB_RECURRENT_ARGS = ["--arch", "xlstm-125m", "--trainers", "2",
                       "--rounds", "1", "--steps-per-round", "2", "--batch",
                       "2", "--seq", "1024", "--samples", "64",
                       "--samples-per-file", "16", "--scope", "full",
                       "--seed", "0"]
# the train phase: qwen3-0.6b FULL, bf16
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 4096, 6
# kernel launches per train step with remat full: 28 attention layers,
# each forward once and recomputed once; 4 norms per block (ln1, ln2,
# q-norm, k-norm) plus the final norm, the block norms recomputed
TRAIN_PER_STEP = {"flash_attention_fwd": 56, "flash_attention_bwd": 28,
                  "rmsnorm": 225, "rmsnorm_bwd": 113}
# train parity (f32, TF32 off): the loss to 1e-5 of itself; each gradient
# to 1e-4 of its largest entry (attention sums 64-key tiles on the card
# and 1024-key chunks in the plain version, the norms reduce in other
# orders); each weight tensor's Adam update (lr 1e-3) to 1e-3 of its L2
# norm, and no weight more than one lr apart: Adam's first steps move an
# element by about lr * g / (|g| + 1e-8), so where |g| is near 1e-8 an
# f32 rounding gap in g shows as a visible fraction of lr
PARITY_TOL = {"loss_rel": 1e-5, "grad_rel": 1e-4, "update_rel": 1e-3,
              "weight_abs": 1e-3}
# gan_parity (f32, TF32 off): card against CPU, each step from equal
# weights and Adam state, with a third step in f64 on the CPU as the
# witness.  The losses to 1e-5 of themselves.  Each weight tensor's Adam
# update to 1e-3 of its L2 norm over its well-conditioned elements: Adam's
# first steps move an element by lr * m / (sqrt(v) + eps) ~ lr * sign(g),
# which turns with the gradient's last bits where sqrt(v) is within 10 eps
# of zero (in a run on the card dec.1's first update read 2.8e-3 apart
# over every element, 6.4e-5 without those); and the MAE losses' gradient
# is a sign, so where |y_hat - y| is within f32 rounding of zero the two
# devices' summation orders pick opposite signs and a few updates flip: at
# most 1e-5 of a tensor's elements (one allowed) may be more than lr/2
# apart (12 of dec.2's 50.3M weights at the second step of that run).
# Over every element, the ill-conditioned and the flipped ones included,
# the same step runs in f64 on the card and on the CPU: the two f64
# updates agree to 1e-6 of their norm (the port's Adam computes in f32
# from the f64 gradient, so they part only where an f64 gradient rounds to
# another f32 value) and the losses to 1e-10.  And the f32 card's update
# is no further from the f64 update than the larger of 1e-3 of its norm
# and twice the f32 CPU's farthest tensor at that step: the two devices
# round differently layer by layer (in a run on the card the card's
# enc.1 read 1.7e-3 from f64 and the CPU's 9e-6 at step 1, the CPU's dec.2
# 8.7e-4 and the card's 6e-7 at step 2), so the CPU's worst tensor sets
# the f32 floor of the step
CYCLEGAN_PARAMS = 101_322_365            # the FULL config's weights
GAN_B = 32
GAN_FLIP_SHARE = 1e-5
GAN_PARITY_TOL = {"loss_rel": 1e-5, "update_rel": 1e-3,
                  "flips_over_allowed": 1.0, "f64_loss_rel": 1e-10,
                  "f64_update_rel": 1e-6, "f32_from_f64_rel": 1e-3,
                  "f32_over_cpu_floor": 2.0}
# ltfb_lm: LTFB over qwen3-0.6b FULL in bf16, K = 2 trainers time-sharing
# the card, B = 2, S = 4096, Adam (the CLI's default), 2 rounds x 3 steps,
# scope full, over 64 rows of 4,097 tokens in 4 shards (3 for training, 1
# held out).  LM_SMOKE rehearses it on the CPU.  Since the eighteenth
# slice the population is qwen3-0.6b at full width cut to LM_POP_LAYERS of
# its 28 layers (``--num-layers``): its ~12 GB checkpoint's save, restore
# and exports, and every phase that serves from it (serve_spec's spec_pop
# and CLI, serve_swap, serve_arena, the serve CLIs of clis), took ~5.6 GB
# a member at 28 layers
LM_POP_LAYERS = 8
LM_LTFB_ARGS = ["--arch", "qwen3-0.6b", "--trainers", "2", "--rounds", "2",
                "--steps-per-round", "3", "--batch", "2", "--seq", "4096",
                "--samples", "64", "--samples-per-file", "16", "--scope",
                "full", "--seed", "0"]
LM_SMOKE = ["--smoke", "--seq", "64"]


def _pop_flags(smoke: bool) -> list:
    """The CLI flags of ltfb_lm's population depth (none on SMOKE)."""
    return [] if smoke else ["--num-layers", str(LM_POP_LAYERS)]


def _pop_cfg(smoke: bool, **kw):
    """qwen3-0.6b as ltfb_lm trains it (FULL cut to ``LM_POP_LAYERS``
    layers; SMOKE as it is), with ``kw`` replaced."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config

    cfg = get_config("qwen3-0.6b", smoke=smoke)
    if not smoke:
        cfg = replace(cfg, num_layers=LM_POP_LAYERS)
    return replace(cfg, **kw) if kw else cfg

# serve_swap: 8 requests over 4 slots, prompts 128/256, 32 new tokens
SWAP_PROMPTS, SWAP_MAX_NEW = [128, 256], 32
# surrogate: 256 queries of 8 rows in batches of 128 (8 slots x 16);
# rows against predict on their weights to 1e-5 (abs + rel, f32, TF32 off)
SURROGATE_QUERIES, SURROGATE_BATCH, SURROGATE_TOL = (256, 8), 128, 1e-5
# the host link of an H100 SXM: PCIe Gen5 x16, 64 GB/s a direction
PCIE_BYTES_PER_S = 64e9
# the ltfb phase: the CLI's defaults at the FULL widths, cut to 4,096
# samples (8 bundles of 512) and 3 rounds of 25 steps
# the train CLI's CycleGAN run in the ltfb phase: JAG training samples
# (the CLI's default is 8,000; the eighteenth slice's cut, ~11 s)
GAN_CLI_SAMPLES = 1024
LTFB_ARGS = ["--arch", "icf-cyclegan", "--trainers", "4", "--rounds", "3",
             "--steps-per-round", "25", "--batch", "32", "--samples",
             "4096", "--samples-per-file", "512", "--store-mode", "preload",
             "--scope", "generator", "--seed", "0"]


# ltfb_mesh: LTFB across process ranks sharing the card over gloo.  (a)
# and (b): the CycleGAN at full width, K = 4, 2 rounds x 5 steps over
# 1,024 JAG samples in 8 bundles (7 for training, 1 held out); (c) the
# ltfb CLI over qwen3-0.6b cut to MESH_LM_LAYERS layers at S = 4096 (the
# attention dispatch runs flash from S = 4096, dense below, as JAX's
# "auto"); (d) the CLI's two SMOKE ranks, rank 1 killed after rank 0's
# first round
MESH_ARGS = ["--arch", "icf-cyclegan", "--trainers", "4", "--rounds", "2",
             "--steps-per-round", "5", "--batch", "32", "--samples", "1024",
             "--samples-per-file", "128", "--scope", "generator", "--seed",
             "0", "--backend", "mesh", "--dist-backend", "gloo"]
MESH_LM_LAYERS = 2
MESH_LM_ARGS = ["--arch", "qwen3-0.6b", "--num-layers", str(MESH_LM_LAYERS),
                "--trainers", "2", "--rounds", "1",
                "--steps-per-round", "2", "--batch", "1", "--seq", "4096",
                "--samples", "64", "--samples-per-file", "8", "--scope",
                "full", "--seed", "0", "--backend", "mesh",
                "--quantize-exchange", "--dist-backend", "gloo",
                "--log-json"]
MESH_KILL_ARGS = ["--arch", "icf-cyclegan", "--smoke", "--trainers", "2",
                  "--rounds", "1000", "--steps-per-round", "20", "--batch",
                  "8", "--samples", "256", "--samples-per-file", "32",
                  "--backend", "mesh", "--dist-backend", "gloo"]
MESH_TIMEOUT_S = 120          # --dist-timeout of (a)-(c)
MESH_KILL_TIMEOUT_S = 20      # --dist-timeout of (d)
MESH_JOB_S = 300              # the longest any part may take
# a rank's process: chip_smoke's function ``argv[2]`` with the rest
_RANK_MAIN = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + "
              "'/src']; import chip_smoke; "
              "sys.exit(getattr(chip_smoke, sys.argv[2])(*sys.argv[3:]))")


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's or a kernel case's line carries
    ``t_s``, the script's seconds so far."""
    if "phase" in obj or "kernel" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    """Raise unless ``cond``: every phase's checks go through here."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def exact_f32(phase):
    """Run ``phase(torch, ...)`` with TF32 off for matmuls and cuDNN, and
    give both flags back as they were, so no phase sets them for the
    next."""
    @functools.wraps(phase)
    def run(torch, *args, **kwargs):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return phase(torch, *args, **kwargs)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
    return run


class Timer:
    """Median device time of a callable (CUDA events), L2 flushed first.

    The device is held in a spin kernel while the host enqueues every
    timed launch, so the events bracket device work only: the host's
    launch overhead (large for Triton's launcher) is not counted.  The
    spin lasts twice the host's enqueue of the timed launches, as the
    warm-up calls measure it, plus 10 ms, and at most ~0.1 s.
    """

    # spin cycles a second: the H100's top SM clock (1.98 GHz) rounded
    # up, so a spin at a lower clock only lasts longer
    CYCLES_PER_S = 2e9
    MAX_SPIN_S = 0.1

    def __init__(self, torch, reps: int = 30, warmup: int = 5):
        self.torch = torch
        self.reps, self.warmup = reps, warmup
        # larger than the H100's 50 MB L2: every timed launch reads cold
        self._flush = torch.empty(96 << 20, dtype=torch.uint8,
                                  device="cuda")

    def ms(self, fn) -> float:
        """Median milliseconds of ``fn()`` over ``reps`` launches."""
        torch = self.torch
        t0 = time.perf_counter()
        for _ in range(self.warmup):
            fn()
        host_s = (time.perf_counter() - t0) / max(self.warmup, 1)
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(self.reps)]
        # each timed launch also enqueues the flush and two events
        spin_s = min(2 * self.reps * (host_s + 50e-6) + 0.01,
                     self.MAX_SPIN_S)
        torch.cuda._sleep(int(spin_s * self.CYCLES_PER_S))
        for start, end in events:
            self._flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def release(torch) -> None:
    """Free the last phase's device memory before the next: collect the
    reference cycles a phase leaves (a session whose methods are wrapped
    in closures over it), then return the cached blocks, so that no phase's
    peak memory counts another's model."""
    gc.collect()
    torch.cuda.empty_cache()


def bound(bytes_moved: float, ops: float, dtype: str, exps: float = 0):
    """Least time the card could take: (ms, 'bytes' | 'operations' |
    'exponentials'), the largest of the bytes over the memory rate, the
    operations over the peak for ``dtype`` and the exponentials over the
    special-function units' rate."""
    times = {"bytes": bytes_moved / HBM_BYTES_PER_S,
             "operations": ops / PEAK_OPS_PER_S[dtype],
             "exponentials": exps / SFU_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": line,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return line


def phase_build(torch):
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rn

    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)    # cold build

    def nvcc():
        t0 = time.perf_counter()
        log = build.build_library(["-Xptxas", "-v"])
        build.load_library()
        return time.perf_counter() - t0, log

    def triton():
        t0 = time.perf_counter()
        # one row, a row count that is and one that is not a multiple of
        # 16 (Triton specialises on each), and a full row tile of each
        # width: the compiles the serve phases would otherwise pay
        for d in (1024, 128, 8192):
            for rows in (1, 2, 16, rn.SMS * 64):
                x = torch.ones((rows, d), device="cuda", dtype=torch.bfloat16)
                s = torch.ones(d, device="cuda", dtype=torch.bfloat16)
                rn.rmsnorm(x, s)
                rn.rmsnorm_bwd(x, s, x)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        f_nvcc, f_triton = pool.submit(nvcc), pool.submit(triton)
        nvcc_s, log = f_nvcc.result()
        triton_s = f_triton.result()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "nvcc_s": round(nvcc_s, 3),
          "sources": [str(p.relative_to(ROOT)) for p in build.sources()],
          "rmsnorm_triton_s": round(triton_s, 3), "ptxas": ptxas})


def _paged_inputs(torch, gen, B, H, Hkv, D, bs, K, dtype, lengths, W=None):
    """Random q and pools, scattered tables with null-page tails.  ``W``
    widens the tables past the longest reach (the scheduler's pow2 width
    bucket); a row of length 1 is idle, as the scheduler passes a free
    slot: its table holds the null page only."""
    W = W or -(-(int(max(lengths)) + K - 1) // bs)
    P = B * W                                   # pages; page P is null
    dt = getattr(torch, dtype)
    q = torch.randn((B, K, H, D), generator=gen, device="cuda").to(dt)
    kp = torch.randn((P + 1, bs, Hkv, D), generator=gen,
                     device="cuda").to(dt)
    vp = torch.randn((P + 1, bs, Hkv, D), generator=gen,
                     device="cuda").to(dt)
    perm = torch.randperm(P, generator=gen, device="cuda").to(torch.int32)
    tables = perm.reshape(B, W).clone()
    for b, n in enumerate(lengths):
        used = -(-(int(n) + K - 1) // bs)
        tables[b, used:] = P                    # null-page tail
        if n == 1:
            tables[b] = P                       # idle row
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables.contiguous(), lens


def _sdpa_calls(torch, q, kp, vp, tables, lengths):
    """SDPA over pages gathered beforehand (the gather itself is not
    timed), the library yardsticks: ``{name: call}``.  One call over K/V
    repeated to all H heads (g times the bytes the paged kernel reads) and,
    where the installed torch takes it, one with ``enable_gqa=True`` over
    the Hkv heads as they are."""
    import torch.nn.functional as F

    B, K, H, D = q.shape
    _, bs, Hkv, _ = kp.shape
    t = tables.long()
    k = kp[t].reshape(B, -1, Hkv, D).transpose(1, 2).contiguous()
    v = vp[t].reshape(B, -1, Hkv, D).transpose(1, 2).contiguous()
    kr = k.repeat_interleave(H // Hkv, dim=1).contiguous()
    vr = v.repeat_interleave(H // Hkv, dim=1).contiguous()
    qh = q.transpose(1, 2).contiguous()         # (B, H, K, D)
    pos = torch.arange(k.shape[2], device=q.device)
    reach = lengths.long()[:, None] + torch.arange(K, device=q.device)
    mask = (pos[None, None, :] < reach[..., None])[:, None]  # (B,1,K,S)
    calls = {"sdpa_repeat_kv": lambda: F.scaled_dot_product_attention(
        qh, kr, vr, attn_mask=mask)}
    try:
        F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                       enable_gqa=True)
    except TypeError:                           # torch before enable_gqa
        return calls
    calls["sdpa_enable_gqa"] = lambda: F.scaled_dot_product_attention(
        qh, k, v, attn_mask=mask, enable_gqa=True)
    return calls


def _split_edge_lengths(torch, B, Hkv, W, bs, K):
    """Row lengths at the kernel's split edges for a ``(B, W)`` table: a
    reach ending exactly on a split boundary, one token past it, on the
    second boundary, a short row (every later split empty), a full table,
    and an idle last row."""
    from repro_torch.kernels import paged_attention as pa

    _, pps = pa.split_plan(B, Hkv, W, pa.sm_count(0))
    edge = min(pps, W) * bs - (K - 1)
    pool = [edge, edge + 1, 2 * pps * bs - (K - 1), 2, bs,
            W * bs - (K - 1), (W - 1) * bs]
    lengths = [min(max(1, n), W * bs - (K - 1)) for n in pool]
    return (lengths * B)[:B - 1] + [1]


def _paged_check(torch, timer, gen, B, H, Hkv, D, bs, K, dtype, lengths,
                 width=None):
    """The paged kernel against its plain version on one random case,
    timed beside SDPA over pages gathered beforehand (``library_ms`` the
    faster of :func:`_sdpa_calls`, named in ``library``); returns the
    case with the split plan the wrapper chose."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    args = _paged_inputs(torch, gen, B, H, Hkv, D, bs, K, dtype, lengths,
                         W=width)
    q, kp, vp, tables, lens = args
    got = pa.paged_attention(*args)
    want = ref.paged_attention_ref(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    check(bool((err <= tol + tol * want.float().abs()).all()),
          f"paged_attention {dtype} H={H} Hkv={Hkv} D={D} K={K}: max |err| "
          f"{err.max().item()} over tolerance {tol}")
    lib_ms, lib_err = {}, 0.0
    for name, fn in _sdpa_calls(torch, *args).items():
        lib_err = max(lib_err, (fn().transpose(1, 2).float()
                                - want.float()).abs().max().item())
        lib_ms[name] = timer.ms(fn)
    library = min(lib_ms, key=lib_ms.get)
    splits, pps = pa.split_plan(B, Hkv, tables.shape[1], pa.sm_count(0))
    esize = q.element_size()
    reach = sum(int(n) + K - 1 for n in lengths)
    moved = 2 * q.numel() * esize + 2 * reach * Hkv * D * esize \
        + tables.numel() * 4 + lens.numel() * 4
    ops = sum((int(n) + t) * H * D * 4 for n in lengths for t in range(K))
    b_ms, b_by = bound(moved, ops, dtype)
    case = {"kernel": "paged_attention", "dtype": dtype, "B": B, "H": H,
            "Hkv": Hkv, "D": D, "bs": bs, "K": K, "W": tables.shape[1],
            "splits": splits, "pages_per_split": pps,
            "lengths": lengths, "max_abs_err": err.max().item(),
            "tol": tol, "library_max_abs_err": lib_err,
            "kernel_ms": timer.ms(lambda: pa.paged_attention(*args)),
            "plain_ms": timer.ms(lambda: ref.paged_attention_ref(*args)),
            "library_ms": lib_ms[library], "library": library,
            "library_ms_each": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bytes": moved}
    case["share_of_bound"] = b_ms / case["kernel_ms"]
    emit(case)
    return case


def _rms_check(torch, timer, gen, shape, dtype):
    """The RMSNorm kernel against its plain version on one random case,
    timed beside ``F.rms_norm``; returns the case."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    dt = getattr(torch, dtype)
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    s = torch.randn(shape[-1], generator=gen, device="cuda").to(dt)
    got = rn.rmsnorm(x, s, 1e-6)
    want = ref.rmsnorm_ref(x, s, 1e-6)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    check(bool((err <= tol + tol * want.float().abs()).all()),
          f"rmsnorm {dtype} {shape}: max |err| {err.max().item()} "
          f"over tolerance {tol}")
    moved = 2 * x.numel() * x.element_size() + s.numel() * s.element_size()
    b_ms, b_by = bound(moved, 4 * x.numel(), dtype)
    rows = x.numel() // shape[-1]
    case = {"kernel": "rmsnorm", "dtype": dtype, "shape": list(shape),
            "plan": rn.plan(rows, shape[-1]),
            "max_abs_err": err.max().item(), "tol": tol,
            "kernel_ms": timer.ms(lambda: rn.rmsnorm(x, s, 1e-6)),
            "plain_ms": timer.ms(lambda: ref.rmsnorm_ref(x, s, 1e-6)),
            "library_ms": timer.ms(
                lambda: F.rms_norm(x, (shape[-1],), s, 1e-6)),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": moved}
    emit(case)
    return case


def phase_kernels(torch, timer):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng_lengths = torch.randint(100, 601, (8,), generator=gen,
                                device="cuda").tolist()
    # the serve phase's decode step: its widths are pow2 buckets capped at
    # 36 pages (32 for up to 512 tokens), free slots are idle rows
    bucket_lengths = [min(n, 500) for n in rng_lengths[:-1]] + [1]
    results = {"paged_attention": [], "rmsnorm": []}
    cases = [(D, K, dt, rng_lengths, None) for dt in ("bfloat16", "float32")
             for K in (1, 5) for D in (128,)]
    cases += [(64, 1, "bfloat16", rng_lengths, None)]
    cases += [(128, 1, dt, bucket_lengths, 32)
              for dt in ("bfloat16", "float32")]
    # the split edges: rows ending on and one past a split boundary, empty
    # splits, an idle row, at a serve-wide table and a one-page one
    for K in (1, 5):
        cases += [(128, K, dt, _split_edge_lengths(torch, 8, 8, 36, 16, K),
                   36) for dt in ("bfloat16", "float32")]
        cases += [(128, K, "bfloat16", [16 - K + 1, 3, 9, 2, 16 - K, 5, 1,
                                        1], 1)]
    # every slot free: the launch's latency floor
    cases += [(128, 1, "bfloat16", [1] * 8, 36)]
    for D, K, dtype, case_lengths, width in cases:
        results["paged_attention"].append(_paged_check(
            torch, timer, gen, 8, 16, 8, D, 16, K, dtype, case_lengths,
            width))

    # decode rows (ln1/ln2/final, q-norm, k-norm) in both dtypes, and the
    # serve phase's widest one-shot prefill (a 512-token bucket) in bf16
    rms_shapes = [((8, 1024), dt) for dt in ("bfloat16", "float32")]
    rms_shapes += [((8, 16, 128), dt) for dt in ("bfloat16", "float32")]
    rms_shapes += [((8, 8, 128), dt) for dt in ("bfloat16", "float32")]
    rms_shapes += [((512, 1024), "bfloat16"), ((512, 16, 128), "bfloat16"),
                   ((512, 8, 128), "bfloat16")]
    for shape, dtype in rms_shapes:
        results["rmsnorm"].append(_rms_check(torch, timer, gen, shape,
                                             dtype))
    return results


def _check_finite(torch, session, counter):
    """Wrap a session's step and both prefills so every logit row is
    checked."""
    import numpy as np

    step = session.step

    def checked_step(*a, **k):
        out = step(*a, **k)
        check(bool(torch.isfinite(out).all()), "non-finite decode logits")
        counter[0] += out.shape[0] * out.shape[1]
        return out

    def checked(prefill):
        def run(*a, **k):
            out = prefill(*a, **k)
            check(bool(np.isfinite(out).all()), "non-finite prefill logits")
            counter[0] += 1
            return out
        return run

    session.step = checked_step
    session.prefill = checked(session.prefill)
    session.prefill_chunk = checked(session.prefill_chunk)


def phase_serve(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Scheduler

    cfg = get_config("qwen3-0.6b")                     # FULL, bfloat16
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompt_lens, max_new, n_req = [128, 256, 512], 64, 16
    sched = Scheduler(cfg, model, num_slots=8, block_size=16,
                      max_len=max(prompt_lens) + max_new, device="cuda")
    rows = [0]
    _check_finite(torch, sched.session, rows)
    reqs = build_requests(cfg, n_req, prompt_lens, max_new, seed=0)
    for r in reqs:
        sched.submit(r)
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = 0
    rn.rmsnorm.launches = 0
    results = sched.run()
    launches = {"paged_attention": pa.paged_attention.launches,
                "rmsnorm": rn.rmsnorm.launches}
    st = sched.stats.as_dict()
    check(st["completed"] == n_req and len(results) == n_req,
          f"{st['completed']} of {n_req} requests completed")
    check(all(len(results[r.rid]) == max_new for r in reqs),
          "a request ended short of max_new")
    per_step = len(model.blocks)
    norms_per_call = 4 * len(model.blocks) + 1
    check(launches["paged_attention"] == per_step * st["decode_steps"] > 0,
          f"paged_attention launches {launches['paged_attention']} != "
          f"{per_step} x {st['decode_steps']} decode steps")
    calls = st["decode_steps"] + st["prefill_chunks"]
    check(launches["rmsnorm"] == norms_per_call * calls > 0,
          f"rmsnorm launches {launches['rmsnorm']} != {norms_per_call} x "
          f"{calls} model calls")
    telemetry = _telemetry_twins(
        torch, lambda **kw: Scheduler(
            cfg, model, num_slots=8, block_size=16,
            max_len=max(prompt_lens) + max_new, device="cuda", **kw),
        lambda: build_requests(cfg, n_req, prompt_lens, max_new, seed=0),
        sched, results, launches, "cuda")
    emit({"phase": "serve", "arch": cfg.name, "dtype": cfg.dtype,
          "params": n_params, "init_s": init_s, "requests": n_req,
          "slots": 8, "block_size": 16, "prompt_lens": prompt_lens,
          "max_new": max_new, "completed": st["completed"],
          "tokens_per_s": st["tokens_per_s"], "wall_s": st["wall_s"],
          "ttft_p50_s": st["ttft_p50_s"], "ttft_p99_s": st["ttft_p99_s"],
          "tpot_mean_s": st["tpot_mean_s"],
          "decode_steps": st["decode_steps"],
          "prefill_chunks": st["prefill_chunks"],
          "logit_rows_checked": rows[0], "launches": launches,
          "paged_attention_per_decode_step":
              launches["paged_attention"] / st["decode_steps"],
          "rmsnorm_per_model_call": launches["rmsnorm"] / calls,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "sample": results[0][:8].tolist(), "telemetry": telemetry,
          "profiled_decode_step": _profile_decode(
              torch, sched, [r.prompt for r in reqs[:8]])})
    return launches, {k: st[k] for k in SERVE_FIGURES}, model


# the span chain every request served from a paged pool by an
# attention-only stack leaves on its trace row (its prompt prefills in
# one or more chunks)
SPAN_CHAIN = ("enqueue", "queued", "admit", "prefill_chunk", "first_token",
              "finish")


def _span_rows(trace: dict) -> dict:
    """Every request's event names in emission order, by rid, from a
    Chrome-trace export."""
    rows = {}
    for ev in trace["traceEvents"]:
        if ev["ph"] in ("X", "i") and "rid" in ev["args"]:
            rows.setdefault(ev["args"]["rid"], []).append(ev["name"])
    return rows


def _chain_complete(names) -> bool:
    """``names`` opens with ``enqueue``, closes with ``finish`` and holds
    :data:`SPAN_CHAIN` in order."""
    it = iter(names)
    return bool(names) and names[0] == SPAN_CHAIN[0] \
        and names[-1] == SPAN_CHAIN[-1] \
        and all(any(n == want for n in it) for want in SPAN_CHAIN)


def _phase_split(sched) -> dict:
    """A served run's host wall time by scheduler phase: each phase's
    share of the run's wall, its calls and its ms a call."""
    tel, wall = sched.telemetry, sched.stats.wall
    return {"wall_s": wall,
            "share": {ph: v / wall for ph, v in
                      sorted(tel.phase_seconds.items())},
            "calls": dict(tel.phase_calls),
            "ms_per_call": {ph: 1e3 * v / tel.phase_calls[ph]
                            for ph, v in sorted(tel.phase_seconds.items())}}


def _telemetry_twins(torch, make, requests, first, first_results,
                     first_launches, device) -> dict:
    """The serve phase's trace twice more after its default run (telemetry
    on): on a fresh scheduler with ``telemetry=False``, then with it on
    again.  Fails unless every run serves the same tokens with the same
    kernel launches, every request of a telemetry run leaves a complete
    span chain with no event dropped, and the telemetry-off run leaves no
    event.  Returns each run's tokens/s, events and phase split, and the
    overhead ``1 - median(on tokens/s) / median(off tokens/s)`` (reported,
    not gated: the host's speed varies between runs)."""
    def figures(sched, results, launches):
        tr = sched.telemetry.tracer
        rows = _span_rows(tr.export())
        complete = sum(_chain_complete(rows.get(str(rid), []))
                       for rid in results)
        return {"telemetry": sched.telemetry.enabled,
                "tokens_per_s": sched.stats.as_dict()["tokens_per_s"],
                "events": tr.emitted, "dropped": tr.dropped,
                "chains_complete": complete, "launches": launches,
                "phases": _phase_split(sched)}

    runs = [figures(first, first_results, first_launches)]
    for telemetry in (False, True):
        sched = make(telemetry=telemetry)
        for r in requests():
            sched.submit(r)
        counters = {n: _all_counters()[n] for n in first_launches}
        before = {n: fn.launches for n, fn in counters.items()}
        results = sched.run()
        _sync(torch, device)
        launches = {n: fn.launches - before[n] for n, fn in counters.items()}
        check(sorted(results) == sorted(first_results) and all(
            results[rid].tolist() == first_results[rid].tolist()
            for rid in results),
            f"serve: the telemetry={telemetry} run served other tokens")
        check(launches == first_launches,
              f"serve: telemetry={telemetry} launches {launches} != "
              f"{first_launches}")
        runs.append(figures(sched, results, launches))
        del sched
    n = len(first_results)
    for run in runs:
        if run["telemetry"]:
            check(run["chains_complete"] == n and run["dropped"] == 0,
                  f"serve: {run['chains_complete']} of {n} span chains "
                  f"complete, {run['dropped']} events dropped")
        else:
            check(run["events"] == 0,
                  f"serve: telemetry off emitted {run['events']} events")
    on = statistics.median(r["tokens_per_s"] for r in runs
                           if r["telemetry"])
    off = statistics.median(r["tokens_per_s"] for r in runs
                            if not r["telemetry"])
    # the first run also pays the scheduler's first calls; the last two
    # are both warm
    warm = 1.0 - runs[2]["tokens_per_s"] / runs[1]["tokens_per_s"]
    return {"order": ["on", "off", "on"], "runs": runs,
            "tokens_per_s_on_median": on, "tokens_per_s_off_median": off,
            "overhead": 1.0 - on / off, "overhead_warm_pair": warm,
            "tokens_identical": True}


def _profile_decode(torch, sched, prompts, ranges=()):
    """After a serve run (every slot free): each slot prefilled with one of
    ``prompts``, then one decode step over all of them under
    torch.profiler -- the steady decode batch of the serve phase
    (``ranges``: profiler ranges whose device time is reported)."""
    import numpy as np

    pool, session = sched.pool, sched.session
    index = np.full((pool.num_slots,), -1, np.int32)
    rids = [f"profiled{i}" for i in range(len(prompts))]
    for rid, prompt in zip(rids, prompts):
        pool.admit(rid, len(prompt) + 1)
        session.prefill(rid, prompt)
        index[pool.slot_of(rid)] = len(prompt)
    tokens = np.zeros((pool.num_slots, 1), np.int32)
    width = pool.table_width_for(max(len(p) for p in prompts) + 1)
    out = _profile(torch, lambda: session.step(tokens, index, width=width),
                   ranges)
    for rid in rids:
        pool.release(rid)
    return out


@exact_f32
def phase_recompute(torch):
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Scheduler

    cfg = replace(get_config("qwen3-0.6b"), dtype="float32")
    model = init_lm(cfg, seed=1, device="cuda")
    prompt_lens, max_new = [64, 200], 16
    sched = Scheduler(cfg, model, num_slots=2, block_size=16,
                      max_len=max(prompt_lens) + max_new, device="cuda")
    reqs = build_requests(cfg, 2, prompt_lens, max_new, seed=1)
    for r in reqs:
        sched.submit(r)
    sched.run()
    checked, ties, mismatches = _recompute_check(torch, model, sched, reqs,
                                                 max_new)
    emit({"phase": "recompute", "dtype": "float32", "allow_tf32": False,
          "positions": checked, "ties": ties, "tie_count": len(ties),
          "mismatches": mismatches})
    check(not mismatches, f"served tokens differ from the f32 dense "
          f"recompute at {len(mismatches)} positions")


def _recompute_check(torch, model, sched, reqs, max_new, dropless=False):
    """Re-run each served request through ``lm_forward`` (no cache; MoE
    layers ``dropless`` as the served paths run them): every generated
    token must be the argmax of its position's logits, save top-2 ties
    within 1e-4.  Returns (positions, ties, mismatches)."""
    from repro_torch.models.lm import lm_forward

    ties, mismatches, checked = [], [], 0
    with torch.no_grad():
        for r in reqs:
            seq = torch.from_numpy(sched.full_sequence(r)).long().to(
                model.device)
            logits = lm_forward(model, seq[None, :-1],
                                dropless=dropless)[0]
            P = r.prompt_len
            for i in range(max_new):
                row = logits[P - 1 + i]
                top2 = torch.topk(row, 2).values
                served = int(seq[P + i])
                gap = (top2[0] - top2[1]).item()
                checked += 1
                if gap < 1e-4:
                    ties.append({"rid": r.rid, "pos": P + i, "gap": gap})
                elif int(row.argmax()) != served:
                    mismatches.append({"rid": r.rid, "pos": P + i,
                                       "served": served,
                                       "recompute": int(row.argmax()),
                                       "gap": gap})
    return checked, ties, mismatches


def _within(got, want, tol) -> tuple:
    """(ok, max |err|) of ``|got - want| <= tol + tol * |want|``, in f32."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all())
    return ok, err.max().item()


def _sdpa_train(torch, q, k, v, causal):
    """SDPA on the (B, S, H, D) tensors viewed as (B, H, S, D): forward,
    and a retained graph whose backward is the library's backward time."""
    import torch.nn.functional as F

    def fwd(a, b, c):
        return F.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            is_causal=causal, enable_gqa=True)

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fwd(*leaves)
    return (lambda: fwd(q, k, v)), out, leaves


def phase_train_kernels(torch, timer, plain_timer):
    """Flash attention and the RMSNorm forward/backward at the train
    phase's shapes, each against its plain version (same inputs)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    results = {"flash_attention_fwd": [], "flash_attention_bwd": [],
               "rmsnorm": [], "rmsnorm_bwd": []}
    # (B, S, H, Hkv, D, dtype): the train cell's heads at B = 1 and at the
    # train step's B = 4, a ragged S in both dtypes, MHA, and bf16 at the
    # other head dims the kernels serve (D = 64 and 16, S not a multiple of
    # the 128-row tile)
    cases = [(1, 4096, 16, 8, 128, "bfloat16"),
             (TRAIN_B, TRAIN_S, 16, 8, 128, "bfloat16"),
             (1, 1000, 16, 8, 128, "bfloat16"),
             (1, 1000, 16, 8, 128, "float32"),
             (1, 4096, 16, 16, 128, "bfloat16"),
             (1, 1000, 16, 8, 64, "bfloat16"),
             (2, 300, 4, 2, 16, "bfloat16")]
    for B, S, H, Hkv, D, dtype in cases:
        fwd, bwd = _flash_cases(torch, timer, plain_timer, gen, B, S, H,
                                Hkv, D, dtype)
        results["flash_attention_fwd"].append(fwd)
        results["flash_attention_bwd"].append(bwd)

    # the train cell's norm rows: ln1/ln2/final (B*S, 1024), q-norm
    # (B*S*16, 128), k-norm (B*S*8, 128); and q-norm's less one, a row
    # count no row tile of the plan divides
    rows = TRAIN_B * TRAIN_S
    for shape in ((rows, 1024), (rows * 16, 128), (rows * 8, 128),
                  (rows * 16 - 1, 128)):
        fwd, bwd = _rms_train_cases(torch, timer, gen, shape)
        results["rmsnorm"].append(fwd)
        results["rmsnorm_bwd"].append(bwd)
    return results


def _flash_cases(torch, timer, plain_timer, gen, B, S, H, Hkv, D, dtype):
    """Flash attention forward and backward against their plain versions
    on one random causal case, each timed beside SDPA; returns (forward
    case, backward case)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dt = getattr(torch, dtype)
    q, do = (torch.randn((B, S, H, D), generator=gen,
                         device="cuda").to(dt) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=gen,
                        device="cuda").to(dt) for _ in range(2))
    tol = TOL[dtype]
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v, True)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    errs = {}
    for name, got, w in (("out", out, want_out), ("lse", lse, want_lse),
                         ("dq", grads[0], want[0]),
                         ("dk", grads[1], want[1]),
                         ("dv", grads[2], want[2])):
        ok, errs[name] = _within(got, w, tol)
        check(ok, f"flash attention {dtype} B={B} S={S} H={H} "
              f"Hkv={Hkv}: {name} max |err| {errs[name]} over {tol}")
    del want_out, want_lse, want
    es = q.element_size()
    pairs = B * H * S * (S + 1) // 2          # causal (query, key) pairs
    qo = B * S * H * D * es
    kv = 2 * B * S * Hkv * D * es
    lse_b = B * S * H * 4
    lib_fwd, lib_out, leaves = _sdpa_train(torch, q, k, v, True)
    shape = {"dtype": dtype, "B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
             "causal": True, "tol": tol}
    b_ms, b_by = bound(2 * qo + kv + lse_b, 4 * D * pairs, dtype)
    fwd = {"kernel": "flash_attention_fwd", **shape,
           "max_abs_err": max(errs["out"], errs["lse"]),
           "kernel_ms": timer.ms(
               lambda: fa.flash_attention_fwd(q, k, v, True)),
           "plain_ms": plain_timer.ms(
               lambda: ref.flash_attention_fwd_ref(q, k, v, True)),
           "library_ms": timer.ms(lib_fwd), "bound_ms": b_ms,
           "bound_by": b_by, "flops": 4 * D * pairs}
    emit(fwd)
    b_ms, b_by = bound(3 * qo + 2 * kv + lse_b, 10 * D * pairs, dtype)
    bwd = {"kernel": "flash_attention_bwd", **shape,
           "max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]),
           "kernel_ms": timer.ms(lambda: fa.flash_attention_bwd(
               q, k, v, out, lse, do, True)),
           "plain_ms": plain_timer.ms(lambda: ref.flash_attention_bwd_ref(
               q, k, v, out, lse, do, True)),
           "library_ms": timer.ms(lambda: torch.autograd.grad(
               lib_out, leaves, do.transpose(1, 2), retain_graph=True)),
           "bound_ms": b_ms, "bound_by": b_by, "flops": 10 * D * pairs}
    emit(bwd)
    del lib_out, leaves, grads
    torch.cuda.empty_cache()
    return fwd, bwd


def _rms_train_cases(torch, timer, gen, shape, path="train"):
    """The RMSNorm forward and backward kernels against their plain
    versions on one random bf16 case (two backward calls must agree bit
    for bit), each timed beside ``F.rms_norm``; returns (forward case,
    backward case)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    dtype = "bfloat16"
    x, dy = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    s = torch.randn(shape[-1], generator=gen, device="cuda").to(
        torch.bfloat16)
    tol = TOL[dtype]
    ok, err = _within(rn.rmsnorm(x, s, 1e-6), ref.rmsnorm_ref(x, s, 1e-6),
                      tol)
    check(ok, f"rmsnorm {shape}: max |err| {err} over {tol}")
    xs = x.numel() * x.element_size()
    ss = s.numel() * s.element_size()
    b_ms, b_by = bound(2 * xs + ss, 4 * x.numel(), dtype)
    fwd = {"kernel": "rmsnorm", "dtype": dtype, "shape": list(shape),
           "path": path, "plan": rn.plan(*shape),
           "max_abs_err": err, "tol": tol,
           "kernel_ms": timer.ms(lambda: rn.rmsnorm(x, s, 1e-6)),
           "plain_ms": timer.ms(lambda: ref.rmsnorm_ref(x, s, 1e-6)),
           "library_ms": timer.ms(
               lambda: F.rms_norm(x, (shape[-1],), s, 1e-6)),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": 2 * xs + ss}
    emit(fwd)
    dx, ds = rn.rmsnorm_bwd(x, s, dy, 1e-6)
    rdx, rds = ref.rmsnorm_bwd_ref(x, s, dy, 1e-6)
    ok_x, err_x = _within(dx, rdx, tol)
    ok_s, err_s = _within(ds, rds, tol)
    check(ok_x and ok_s, f"rmsnorm_bwd {shape}: max |err| dx {err_x}, "
          f"dscale {err_s} over {tol}")
    # dscale sums the programs' partial rows in a fixed order: two
    # launches on the same inputs agree bit for bit
    again = rn.rmsnorm_bwd(x, s, dy, 1e-6)
    check(torch.equal(again[0], dx) and torch.equal(again[1], ds),
          f"rmsnorm_bwd {shape}: dx or dscale differ between two calls")
    xl, sl = x.detach().requires_grad_(), s.detach().requires_grad_()
    lib_y = F.rms_norm(xl, (shape[-1],), sl, 1e-6)
    moved = 3 * xs + 2 * ss
    b_ms, b_by = bound(moved, 8 * x.numel(), dtype)
    bwd = {"kernel": "rmsnorm_bwd", "dtype": dtype,
           "shape": list(shape), "path": path,
           "plan": rn.plan(*shape, backward=True),
           "max_abs_err": max(err_x, err_s),
           "tol": tol,
           "kernel_ms": timer.ms(lambda: rn.rmsnorm_bwd(x, s, dy, 1e-6)),
           "plain_ms": timer.ms(
               lambda: ref.rmsnorm_bwd_ref(x, s, dy, 1e-6)),
           "library_ms": timer.ms(lambda: torch.autograd.grad(
               lib_y, (xl, sl), dy, retain_graph=True)),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": moved}
    emit(bwd)
    return fwd, bwd


def _train_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "rmsnorm": rn.rmsnorm, "rmsnorm_bwd": rn.rmsnorm_bwd}


def _all_counters():
    """Every kernel wrapper of the port, by the kernels line's names."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import slstm as sl

    return {**_train_counters(), "paged_attention": pa.paged_attention,
            "mamba_scan": ms.mamba_scan, "slstm_scan": sl.slstm_scan,
            "mamba_scan_bwd": ms.mamba_scan_bwd,
            "slstm_scan_bwd": sl.slstm_scan_bwd}


def _check_grads(torch, model, where):
    """Every parameter holds a finite gradient with a nonzero entry."""
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not bool((p.grad != 0).any())]
    check(not bad, f"{where}: {len(bad)} parameters without a nonzero "
          f"finite gradient, e.g. {bad[:5]}")


# device-time groups of the profiled train step and serve calls, by
# kernel name
PROFILE_GROUPS = (("flash_attention_fwd", ("flash_fwd",)),
                  ("flash_attention_bwd", ("flash_bwd",)),
                  ("rmsnorm", ("rmsnorm",)),
                  ("paged_attention", ("paged_attention",)),
                  ("mamba_scan_bwd", ("mamba_scan_bwd", "sum_parts")),
                  ("mamba_scan", ("mamba_scan",)),
                  ("slstm_scan_bwd", ("slstm_bwd",)),
                  ("slstm_scan", ("slstm",)),
                  ("matmul", ("gemm", "sm90", "cutlass", "nvjet", "xmma",
                              "cublas")),
                  ("memcpy_dtoh", ("memcpy dtoh",)),
                  ("memcpy_htod", ("memcpy htod",)))


def _profile(torch, fn, ranges=()):
    """One call of ``fn`` under torch.profiler: device time by kernel
    group, the busiest kernels, and the device's busy share of the call's
    wall time (None where the profiler saw no device time).  ``ranges``
    names ``record_function`` ranges whose kernels' device time is
    reported under ``range_ms``; the model's own ranges (attention, the
    MoE's routing and expert products) are never counted as kernels.  The
    host's operators are recorded only for ``ranges``: the kernels' times
    come from the device records alone, and on an H100 host an xlstm train
    step's 320k host and device events took ~41 s to read where its 90k
    device events take ~11 s."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import layers, lm

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if ranges else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    range_ms = {r: 0.0 for r in ranges}
    named = set(ranges) | {lm.ATTENTION_RANGE, layers.MOE_ROUTE_RANGE,
                           layers.MOE_EXPERTS_RANGE}
    for e in prof.key_averages():
        on_device = str(e.device_type).endswith("CUDA")
        if e.key in named:
            # the host-side range counts the kernels launched inside it;
            # its device-side annotation would count them twice
            if not on_device and e.key in range_ms:
                us = getattr(e, "device_time_total", None)
                if us is None:
                    us = getattr(e, "cuda_time_total", 0)
                range_ms[e.key] += us / 1e3
            continue
        if not on_device:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    busy = sum(kernels.values())
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in PROFILE_GROUPS
                      if any(k in low for k in keys)), "other")
        groups[group] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "busy_share": busy / (wall * 1e3) if busy else None,
            "group_ms": groups, "kernels": len(kernels),
            "top": [[name[:80], ms] for name, ms in top],
            **({"range_ms": range_ms} if ranges else {})}


def phase_train(torch):
    """Train qwen3-0.6b FULL through the launcher's functions."""
    from repro_torch.launch import train as tl

    args = tl.build_parser().parse_args([
        "--arch", "qwen3-0.6b", "--steps", str(TRAIN_STEPS), "--batch",
        str(TRAIN_B), "--seq", str(TRAIN_S), "--lr", "1e-3", "--optimizer",
        "adam", "--remat", "full", "--seed", "0"])
    t0 = time.perf_counter()
    tr = tl.build_trainer(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, model = tr.cfg, tr.state["model"]
    check(cfg.dtype == "bfloat16" and tr.opt_cfg.grad_clip_norm == 1.0,
          "train config: bf16 weights and clip 1.0 expected")
    n_params = sum(p.numel() for p in model.parameters())
    val = tl.device_batch(cfg, TRAIN_B, TRAIN_S, tl.VAL_SEED, tr.device)
    val_before = float(tr.metric(model, val))
    batches = [tl.device_batch(cfg, TRAIN_B, TRAIN_S, i, tr.device)
               for i in range(TRAIN_STEPS)]
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, lrs, gnorms, step_s, per_step = [], [], [], [], []
    for i, batch in enumerate(batches):
        before = {n: fn.launches for n, fn in counters.items()}
        t0 = time.perf_counter()
        _, m = tr.step(tr.state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append({n: fn.launches - before[n]
                         for n, fn in counters.items()})
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        gnorms.append(float(m["grad_norm"]))
        if i in (0, TRAIN_STEPS - 1):
            _check_grads(torch, model, f"train step {i}")
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    val_after = float(tr.metric(model, val))
    profile = _profile(torch, lambda: tr.step(tr.state, batches[0]))
    check(all(map(math.isfinite, losses + gnorms)),
          f"non-finite train loss or grad norm: {losses} {gnorms}")
    check(math.isfinite(val_after) and val_after < val_before,
          f"validation loss did not fall: {val_before} -> {val_after}")
    for i, got in enumerate(per_step):
        check(got == TRAIN_PER_STEP, f"train step {i} launches {got} != "
              f"{TRAIN_PER_STEP}")
    step = statistics.median(step_s[-4:])
    tokens = TRAIN_B * TRAIN_S
    attn_flops = 2 * TRAIN_B * cfg.num_heads * TRAIN_S ** 2 \
        * cfg.resolved_head_dim
    model_flops = 6 * n_params * tokens + 3 * attn_flops * cfg.num_layers
    stats = {"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
             "params": n_params, "batch": TRAIN_B, "seq": TRAIN_S,
             "steps": TRAIN_STEPS, "optimizer": tr.opt_cfg.name,
             "lr": tr.opt_cfg.lr, "warmup_steps": tr.opt_cfg.warmup_steps,
             "remat": args.remat, "init_s": init_s, "losses": losses,
             "lrs": lrs, "grad_norms": gnorms, "step_s": step_s,
             "step_ms": step * 1e3, "tokens_per_s": tokens / step,
             "peak_mem_gib": peak / 2**30,
             "mfu": model_flops / step / PEAK_OPS_PER_S["bfloat16"],
             "model_flops_per_step": model_flops,
             "val_before": val_before, "val_after": val_after,
             "launches": launches, "launches_per_step": per_step[-1],
             "grads_checked": "every parameter, steps 0 and last",
             "profiled_step": profile}
    emit(stats)
    del tr, model, batches, val
    return launches, stats


@exact_f32
def phase_train_parity(torch):
    """Two f32 train steps through the kernels == through the plain
    versions (same card, same weights and batches)."""
    from repro_torch.configs.base import OptimizerConfig, replace
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import train as tl
    from repro_torch.train.steps import init_lm_state, make_lm_train_step

    cfg = replace(get_config("qwen3-0.6b"), dtype="float32", num_layers=2)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=1)
    batches = [tl.device_batch(cfg, 1, TRAIN_S, i, "cuda") for i in range(2)]
    plain = {(fa, "flash_attention_fwd"): fa.flash_attention_fwd_ref,
             (fa, "flash_attention_bwd"): fa.flash_attention_bwd_ref,
             (rn, "rmsnorm"): rn.rmsnorm_ref,
             (rn, "rmsnorm_bwd"): rn.rmsnorm_bwd_ref}

    def run(use_plain):
        saved = {key: getattr(*key) for key in plain}
        if use_plain:                  # the ops dispatch reads these names
            for (mod, name), fn in plain.items():
                setattr(mod, name, fn)
        try:
            state = init_lm_state(cfg, opt_cfg, seed=0, device="cuda")
            step = make_lm_train_step(cfg, opt_cfg, remat="full")
            losses, grads = [], []
            init = {n: p.detach().clone() for n, p in
                    state["model"].named_parameters()}
            for batch in batches:
                _, m = step(state, batch)
                losses.append(float(m["loss"]))
                grads.append({n: p.grad.clone() for n, p in
                              state["model"].named_parameters()})
            updates = {n: p.detach() - init[n] for n, p in
                       state["model"].named_parameters()}
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
        return losses, grads, updates

    k_loss, k_grads, k_u = run(False)
    p_loss, p_grads, p_u = run(True)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss))
    grad_rel, worst = 0.0, ""
    for kg, pg in zip(k_grads, p_grads):
        for n in pg:
            rel = ((kg[n] - pg[n]).abs().max()
                   / pg[n].abs().max().clamp(min=1e-30)).item()
            if rel > grad_rel:
                grad_rel, worst = rel, n
    # the two runs start from the same weights: the weights' gap is the
    # updates' gap
    w_err = max((k_u[n] - p_u[n]).abs().max().item() for n in p_u)
    upd_rel = max((torch.linalg.vector_norm(k_u[n] - p_u[n])
                   / torch.linalg.vector_norm(p_u[n]).clamp(min=1e-30)
                   ).item() for n in p_u)
    check(min(torch.linalg.vector_norm(u).item() for u in p_u.values()) > 0,
          "train parity: a weight tensor did not move")
    emit({"phase": "train_parity", "dtype": "float32", "allow_tf32": False,
          "layers": cfg.num_layers, "batch": 1, "seq": TRAIN_S, "steps": 2,
          "optimizer": "adam", "lr": opt_cfg.lr,
          "losses_kernel": k_loss, "losses_plain": p_loss,
          "loss_rel_err": loss_rel, "grad_rel_err": grad_rel,
          "worst_grad": worst, "update_rel_err": upd_rel,
          "weight_abs_err": w_err, "tol": PARITY_TOL})
    check(loss_rel <= PARITY_TOL["loss_rel"],
          f"train parity: loss rel err {loss_rel}")
    check(grad_rel <= PARITY_TOL["grad_rel"],
          f"train parity: gradient {worst} rel err {grad_rel}")
    check(upd_rel <= PARITY_TOL["update_rel"],
          f"train parity: weight update rel err {upd_rel}")
    check(w_err <= PARITY_TOL["weight_abs"],
          f"train parity: weight abs err {w_err}")


def _scan_case(torch, timer, plain_timer, name, fn, plain, args, moved, ops,
               exps=0):
    """A scan kernel against its plain version (every output, f32, within
    ``SCAN_TOL``), timed; ``library_ms`` is None: no PyTorch call computes
    either recurrence."""
    got = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: [t for x in out for t in
                        (x if isinstance(x, (tuple, list)) else (x,))]
    errs = []
    for g, w in zip(flat(got), flat(want)):
        ok, err = _within(g, w, SCAN_TOL)
        check(ok, f"{name} {[tuple(a.shape) for a in args]}: max |err| "
              f"{err} over tolerance {SCAN_TOL}")
        errs.append(err)
    b_ms, b_by = bound(moved, ops, "float32", exps)
    return {"kernel": name, "dtype": "float32", "max_abs_err": max(errs),
            "tol": SCAN_TOL, "kernel_ms": timer.ms(lambda: fn(*args)),
            "plain_ms": plain_timer.ms(lambda: plain(*args)),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": moved, "ops": ops,
            "exps": exps}


def phase_recurrent_kernels(torch, timer, plain_timer):
    """The selective scan and the sLSTM against their plain versions at
    the recurrent serve phases' shapes, and paged attention and RMSNorm at
    the new widths those phases give them."""
    import torch.nn.functional as F

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm as sl

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    results = {"mamba_scan": [], "slstm_scan": [], "paged_attention": [],
               "rmsnorm": []}
    # jamba's serve shape, a ragged S, B = 2, and a d_in no channel block
    # of the plan divides at N = 8
    for B, S, d, N in ((1, 500, 16384, 16), (1, 37, 16384, 16),
                       (2, 500, 16384, 16), (2, 100, 1000, 8)):
        rand = lambda *shape: torch.randn(shape, generator=gen,
                                          device="cuda")
        # dt around the model's softplus(dt_bias = -4.6) ~ 0.01
        dt = F.softplus(rand(B, S, d) - 4.6)
        a = -torch.arange(1, N + 1, dtype=torch.float32,
                          device="cuda").repeat(d, 1)
        args = (dt, rand(B, S, d), rand(B, S, N), rand(B, S, N), a)
        moved = 4 * (3 * B * S * d + 2 * B * S * N + d * N + B * d * N)
        # per (step, channel, state): one exponential, and two products and
        # two fmas on the f32 pipes
        case = _scan_case(torch, timer, plain_timer, "mamba_scan",
                          ms.mamba_scan,
                          ref.mamba_scan_ref, args, moved, 4 * B * S * d * N,
                          B * S * d * N)
        lanes, channels = ms.scan_plan(d, N)
        case.update(B=B, S=S, d_in=d, N=N, lanes=lanes,
                    channels_per_block=channels)
        emit(case)
        results["mamba_scan"].append(case)
    # xlstm-125m (a cluster of 8), the JAX test's ragged shape, and a head
    # of 196 channels over a cluster of 8 (the last block's tail masked)
    for B, S, d, H in ((1, 500, 768, 4), (3, 33, 96, 2), (2, 40, 392, 2)):
        dh = d // H
        gx = torch.randn((B, S, 4 * d), generator=gen, device="cuda")
        r = torch.randn((H, dh, 4 * dh), generator=gen,
                        device="cuda") / math.sqrt(dh)
        moved = 4 * (5 * B * S * d + H * dh * 4 * dh + 4 * B * d)
        # per step: the (dh x 4dh) product of every head, ~16 flops of
        # gate math per channel
        ops = B * S * (8 * d * dh + 16 * d)
        case = _scan_case(torch, timer, plain_timer, "slstm_scan",
                          sl.slstm_scan,
                          ref.slstm_ref, (gx, r), moved, ops)
        C, cb = sl.cluster_plan(dh)
        case.update(B=B, S=S, d=d, H=H, cluster=C, channels_per_block=cb)
        emit(case)
        results["slstm_scan"].append(case)
    # jamba's decode step: 64 query heads over 8 KV heads (g = 8), one
    # attention layer, prompts up to 500 + 32 new tokens
    lengths = torch.randint(100, 533, (8,), generator=gen,
                            device="cuda").tolist()
    paged = [(K, dt, lengths, None) for K in (1, 5)
             for dt in ("bfloat16", "float32")]
    # the split edges at g = 8, K * g = 8 and 40 rows a block
    for K in (1, 5):
        paged += [(K, "bfloat16",
                   _split_edge_lengths(torch, 8, 8, 36, 16, K), 36),
                  (K, "bfloat16", [16 - K + 1, 2, 9, 1, 4, 16 - K, 7, 1],
                   1)]
    for K, dtype, case_lengths, width in paged:
        results["paged_attention"].append(_paged_check(
            torch, timer, gen, 8, 64, 8, 128, 16, K, dtype, case_lengths,
            width))
    # xlstm-125m (d = 768, a masked 1024 block) and jamba (d = 8192, one
    # 8192-wide row per program): decode rows and a 500-token prefill
    for d in (768, 8192):
        for shape, dtype in (((8, d), "bfloat16"), ((8, d), "float32"),
                             ((500, d), "bfloat16")):
            results["rmsnorm"].append(_rms_check(torch, timer, gen, shape,
                                                 dtype))
    return results


def _serve_phase(torch, phase, cfg, n_req, prompt_lens, max_new, expect):
    """Serve a trace through the scheduler on the card and hold the kernel
    counters to ``expect``: {kernel: (step counter, launches per count)},
    the counters set to 0 just before the run and read just after."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import slstm as sl
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Scheduler

    counters = {"mamba_scan": ms.mamba_scan, "slstm_scan": sl.slstm_scan,
                "paged_attention": pa.paged_attention, "rmsnorm": rn.rmsnorm}
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    sched = Scheduler(cfg, model, num_slots=8, block_size=16,
                      max_len=max(prompt_lens) + max_new, device="cuda")
    rows = [0]
    _check_finite(torch, sched.session, rows)
    reqs = build_requests(cfg, n_req, prompt_lens, max_new, seed=0)
    for r in reqs:
        sched.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    results = sched.run()
    launches = {n: fn.launches for n, fn in counters.items()}
    st = sched.stats.as_dict()
    profiled = _profile_serve(torch, sched, reqs[prompt_lens.index(
        max(prompt_lens))].prompt)
    check(st["completed"] == n_req and len(results) == n_req,
          f"{phase}: {st['completed']} of {n_req} requests completed")
    check(all(len(results[r.rid]) == max_new for r in reqs),
          f"{phase}: a request ended short of max_new")
    check(st["prefill_chunks"] == 0 and st["prefills"] == n_req
          and st["padded_prefill_tokens"] == st["prefill_tokens"]
          == sum(r.prompt_len for r in reqs),
          f"{phase}: expected one exact-length prefill per request, got "
          f"{st['prefills']} prefills, {st['prefill_chunks']} chunks")
    counts = {"prefills": st["prefills"],
              "decode_steps": st["decode_steps"],
              "model_calls": st["prefills"] + st["decode_steps"]}
    for name, (per, k) in expect.items():
        check(launches[name] == k * counts[per] > 0,
              f"{phase}: {name} launches {launches[name]} != {k} x "
              f"{counts[per]} {per}")
    emit({"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
          "params": n_params, "init_s": init_s, "requests": n_req,
          "slots": 8, "block_size": 16, "prompt_lens": prompt_lens,
          "max_new": max_new, "completed": st["completed"],
          "tokens_per_s": st["tokens_per_s"], "wall_s": st["wall_s"],
          "ttft_p50_s": st["ttft_p50_s"], "ttft_p99_s": st["ttft_p99_s"],
          "tpot_mean_s": st["tpot_mean_s"], **counts,
          "logit_rows_checked": rows[0], "launches": launches,
          "expected_per": {n: list(v) for n, v in expect.items()},
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "sample": results[0][:8].tolist(), "profiled": profiled})
    return {n: launches[n] for n in expect}


def _profile_serve(torch, sched, prompt):
    """After a serve run (every slot free): one more exact-length prefill
    of ``prompt`` and one decode step over all slots, each under
    torch.profiler."""
    import numpy as np

    pool, session = sched.pool, sched.session
    P = len(prompt)
    pool.admit("profiled", P + 1)
    index = np.full((pool.num_slots,), -1, np.int32)
    index[pool.slot_of("profiled")] = P
    tokens = np.zeros((pool.num_slots, 1), np.int32)
    out = {"prompt_len": P,
           "prefill": _profile(torch, lambda: session.prefill("profiled",
                                                             prompt)),
           "decode_step": _profile(torch, lambda: session.step(
               tokens, index, width=pool.table_width_for(P + 1)))}
    pool.release("profiled")
    return out


def phase_serve_recurrent(torch):
    """serve_xlstm and serve_hybrid: the two recurrent families at full
    width in bf16 through the scheduler."""
    from repro_torch.configs.jamba_15_large import NOEXP_8L
    from repro_torch.configs.registry import get_config

    out = {"serve_xlstm": _serve_phase(
        torch, "serve_xlstm", get_config("xlstm-125m"), 16, [100, 300, 500],
        64, {"slstm_scan": ("prefills", 3),
             "rmsnorm": ("model_calls", 13)})}
    release(torch)
    out["serve_hybrid"] = _serve_phase(
        torch, "serve_hybrid", NOEXP_8L, 8, [100, 300, 500], 32,
        {"mamba_scan": ("prefills", 7), "paged_attention": ("decode_steps", 1),
         "rmsnorm": ("model_calls", 17)})
    release(torch)
    return out


@exact_f32
def phase_recompute_recurrent(torch):
    """Both recurrent configs in f32 (TF32 off): two served requests each
    re-run through ``lm_forward`` must pick every served token."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.jamba_15_large import NOEXP_8L
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Scheduler

    prompt_lens, max_new = [100, 300], 16
    report = {}
    for base in (get_config("xlstm-125m"), NOEXP_8L):
        cfg = replace(base, dtype="float32")
        model = init_lm(cfg, seed=1, device="cuda")
        sched = Scheduler(cfg, model, num_slots=2, block_size=16,
                          max_len=max(prompt_lens) + max_new, device="cuda")
        reqs = build_requests(cfg, 2, prompt_lens, max_new, seed=1)
        for r in reqs:
            sched.submit(r)
        sched.run()
        checked, ties, mismatches = _recompute_check(torch, model, sched,
                                                     reqs, max_new)
        report[cfg.name] = {"positions": checked, "ties": ties,
                            "tie_count": len(ties),
                            "mismatches": mismatches}
        del model, sched
        release(torch)
    emit({"phase": "recompute_recurrent", "dtype": "float32",
          "allow_tf32": False, "prompt_lens": prompt_lens,
          "max_new": max_new, **report})
    for name, r in report.items():
        check(not r["mismatches"], f"{name}: served tokens differ from the "
              f"f32 recompute at {len(r['mismatches'])} positions")


def _jag_batches(jag, cfg, n_batches, batch, seed=0):
    """``n_batches`` JAG batches of ``batch`` samples as numpy (x, y)."""
    sim = jag.jag_simulate(jag.sample_inputs(n_batches * batch, seed=seed),
                           cfg.image_size)
    x, y = sim["x"], jag.flatten_outputs(sim)
    return [{"x": x[i * batch:(i + 1) * batch],
             "y": y[i * batch:(i + 1) * batch]} for i in range(n_batches)]


@exact_f32
def phase_gan_parity(torch, device="cuda"):
    """Two full-width f32 GAN steps on the card == two on the CPU (same
    seed weights, same batches), each witnessed by the step in f64 on the
    card and on the CPU; the second step starts on every side from the f32
    CPU's first, so each step is compared from equal inputs."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.configs.icf_cyclegan import FULL
    from repro_torch.data import jag
    from repro_torch.models.icf_cyclegan import init_cyclegan
    from repro_torch.train.steps import make_gan_steps

    opt_cfg = OptimizerConfig(name="adam", lr=1e-3)
    lr = opt_cfg.lr
    batches = _jag_batches(jag, FULL, 2, GAN_B)
    # (device, dtype) of each side; the f64 sides run the forward, the
    # backward and the losses in f64 (the port's Adam computes in f32 for
    # every dtype)
    sides = {"card": (device, torch.float32), "cpu": ("cpu", torch.float32),
             "card_f64": (device, torch.float64),
             "f64": ("cpu", torch.float64)}
    steps_of = {s: make_gan_steps(FULL, opt_cfg, dev)[1]
                for s, (dev, _) in sides.items()}

    def to(tree, dev, dtype):
        if isinstance(tree, dict):
            return {k: to(v, dev, dtype) for k, v in tree.items()}
        if tree.is_floating_point():
            return tree.to(dev, dtype, copy=True)
        return tree.to(dev, copy=True)

    params = init_cyclegan(FULL, seed=0, device="cpu")
    opt_state = make_gan_steps(FULL, opt_cfg, "cpu")[0](0)[1]
    n_params = sum(t.numel() for d in params.values() for t in d.values())
    losses = {s: [] for s in sides}
    secs = {s: 0.0 for s in sides}
    steps, moved = [], True
    for b in batches:
        out = {}
        for side, (dev, dt) in sides.items():
            batch = {k: torch.from_numpy(v).to(dev, dt)
                     for k, v in b.items()}
            t0 = time.perf_counter()
            new_p, new_o, m = steps_of[side](
                to(params, dev, dt), to(opt_state, dev, torch.float32),
                batch, {"lr": lr})
            losses[side].append({k: float(m[k])
                                 for k in ("g_loss", "d_loss")})
            secs[side] += time.perf_counter() - t0
            out[side] = (to(new_p, "cpu", torch.float64), new_o)
        tensors, flipped, ill = [], 0, 0
        for h, d in params.items():
            cpu_opt = out["cpu"][1][h]
            bc2 = 1 - opt_cfg.b2 ** int(cpu_opt["step"])
            for n, w in d.items():
                w = w.double()
                u = {s: out[s][0][h][n] - w for s in sides}
                gap = (u["card"] - u["cpu"]).abs()
                norm = torch.linalg.vector_norm(u["cpu"]).item()
                norm64 = torch.linalg.vector_norm(u["f64"]).item()
                moved = moved and norm > 0
                # Adam's denominator: between 0 (no gradient yet: no
                # update on either side) and 10 eps an element's update
                # turns with the gradient's last bits
                den = torch.sqrt(cpu_opt["v"][n] / bc2)
                cond = (den >= 10 * opt_cfg.eps) | (den == 0)
                flip = (gap > lr / 2) & cond
                rel = (torch.linalg.vector_norm(gap[cond & ~flip]).item()
                       / max(norm, 1e-30))
                flipped += int(flip.sum())
                ill += int((~cond).sum())
                tensors.append({
                    "name": f"{h}.{n}", "numel": w.numel(),
                    "ill_share": (~cond).sum().item() / w.numel(),
                    "update_rel": rel,
                    "update_rel_all": (torch.linalg.vector_norm(gap).item()
                                       / max(norm, 1e-30)),
                    "flips": int(flip.sum()),
                    "flips_allowed": max(1.0, GAN_FLIP_SHARE * w.numel()),
                    **{f"{side}_from_f64_rel": (torch.linalg.vector_norm(
                        u[side] - u["f64"]).item() / max(norm64, 1e-30))
                       for side in ("card_f64", "card", "cpu")}})
        steps.append({"tensors": tensors, "flipped": flipped,
                      "ill_conditioned": ill,
                      "ill_share": ill / n_params,
                      "cpu_floor": max(t["cpu_from_f64_rel"]
                                       for t in tensors)})
        params, opt_state = to(out["cpu"][0], "cpu", torch.float32), \
            out["cpu"][1]
    def loss_rel(side, ref):
        return max(abs(a[k] - b[k]) / abs(b[k])
                   for a, b in zip(losses[side], losses[ref]) for k in b)

    f32_loss_rel, f64_loss_rel = loss_rel("card", "cpu"), \
        loss_rel("card_f64", "f64")
    emit({"phase": "gan_parity", "arch": FULL.name, "params": n_params,
          "dtype": "float32", "allow_tf32": False, "batch": GAN_B,
          "steps": 2, "optimizer": "adam", "lr": lr,
          "losses_card": losses["card"], "losses_cpu": losses["cpu"],
          "losses_f64": losses["f64"], "loss_rel_err": f32_loss_rel,
          "f64_loss_rel_err": f64_loss_rel, "per_step": steps,
          "seconds": secs, "tol": GAN_PARITY_TOL,
          "flip_share": GAN_FLIP_SHARE})
    check(n_params == FULL.param_count() == CYCLEGAN_PARAMS,
          f"gan_parity: {n_params} parameters")
    check(moved, "gan_parity: a weight tensor did not move")
    check(f32_loss_rel <= GAN_PARITY_TOL["loss_rel"],
          f"gan_parity: loss rel err {f32_loss_rel}")
    check(f64_loss_rel <= GAN_PARITY_TOL["f64_loss_rel"],
          f"gan_parity: f64 loss rel err {f64_loss_rel}")
    for i, st in enumerate(steps):
        for t in st["tensors"]:
            where = f"gan_parity: step {i} {t['name']}"
            check(t["update_rel"] <= GAN_PARITY_TOL["update_rel"],
                  f"{where} update rel err {t['update_rel']}")
            check(t["flips"] <= GAN_PARITY_TOL["flips_over_allowed"]
                  * t["flips_allowed"], f"{where} {t['flips']} flips")
            check(t["card_f64_from_f64_rel"]
                  <= GAN_PARITY_TOL["f64_update_rel"],
                  f"{where} f64 card {t['card_f64_from_f64_rel']} from the "
                  "f64 CPU")
            floor = max(GAN_PARITY_TOL["f32_from_f64_rel"],
                        GAN_PARITY_TOL["f32_over_cpu_floor"]
                        * st["cpu_floor"])
            check(t["card_from_f64_rel"] <= floor,
                  f"{where} f32 card {t['card_from_f64_rel']} from the f64 "
                  f"update, over {floor}")


def _mlp_params(dims) -> int:
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def gan_step_bound(cfg, batch: int):
    """(ms, bound_by, bytes, flops) of one f32 GAN step at ``batch``.

    Bytes: Adam reads p, g, m and v and writes p, m and v of every weight
    (7 x 4 bytes a parameter); the discriminator step reads the ``fwd`` and
    ``enc`` weights, the generator step reads every generator weight in
    its forward and again in its backward and writes its gradient once.
    Operations: 2 per multiply-add; the discriminator step runs ``fwd`` and
    ``enc`` forward, the generator step ``fwd``, ``enc``, ``inv`` and
    ``dec`` twice forward and backward (weight and input gradients: twice
    the forward's); the latent discriminator's share is left out (< 0.01%).
    """
    z, d_out = cfg.latent_dim, cfg.output_dim
    n_fwd = _mlp_params((cfg.input_dim, *cfg.fwd_hidden, z))
    n_inv = _mlp_params((z, *cfg.inv_hidden, cfg.input_dim))
    n_enc = _mlp_params((d_out, *cfg.enc_hidden, z))
    n_dec = _mlp_params((z, *cfg.dec_hidden, d_out))
    n_all = cfg.param_count()
    n_gen = n_fwd + n_inv + n_enc + n_dec
    moved = 4 * (7 * n_all + (n_fwd + n_enc) + 3 * n_gen)
    flops = 2 * batch * (n_fwd + n_enc) \
        + 3 * 2 * batch * (n_fwd + n_enc + n_inv + 2 * n_dec)
    ms, by = bound(moved, flops, "float32")
    return ms, by, moved, flops


def phase_ltfb(torch, device="cuda", workdir=None):
    """LTFB tournament training of the full-width CycleGAN on the card.

    With ``workdir`` the population directory stays for the surrogate
    phase: the winners of its two steps (3, and 4 from the CLI's round)
    are exported, step 4's set aside to land mid-run, and the trainer
    files pruned.  Returns ``(population dir, dir of the next winner)``
    then, else None."""
    import tempfile

    import numpy as np

    from repro_torch.configs.icf_cyclegan import FULL
    from repro_torch.core import ltfb as core_ltfb
    from repro_torch.core.tournament import TournamentOrchestrator
    from repro_torch.launch import ltfb as lt
    from repro_torch.train.steps import OPTIMIZER_RANGE

    tf32 = torch.backends.cuda.matmul.allow_tf32
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ltfb_", dir=workdir)
    args = lt.finish_args(lt.build_parser().parse_args(
        LTFB_ARGS + ["--device", device, "--data-dir", f"{tmp}/data",
                     "--ckpt-dir", f"{tmp}/ckpt"]))
    lt.check_ported(args)
    orch = fresh = None
    try:
        t0 = time.perf_counter()
        plan = lt.build_plan(args)
        data_s = time.perf_counter() - t0
        fns, cfg = lt.build_fns(args), lt.build_config(args)
        t0 = time.perf_counter()
        orch = TournamentOrchestrator(fns, plan, cfg)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        trainers = orch.population.trainers
        p0 = trainers[0].params
        n_params = sum(t.numel() for d in p0.values() for t in d.values())
        check(n_params == FULL.param_count() == CYCLEGAN_PARAMS,
              f"ltfb: {n_params} parameters")
        val_init = [float(fns.metric(t.params, orch.val_batch))
                    for t in trainers]
        per_round = []

        def on_round(o):
            st = o.stats()
            per_round.append({
                "train_s": [d["train_seconds"] for d in st["per_trainer"]],
                "wait_s": [d["data_wait_seconds"]
                           for d in st["per_trainer"]],
                "steps": [d["steps"] for d in st["per_trainer"]],
                "tournament_s": st["tournament_seconds"],
                "efficiency": dict(o.last_efficiency)})

        orch.on_round = on_round
        counters = _all_counters()
        before = {n: fn.launches for n, fn in counters.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trace = orch.run(args.rounds, args.steps_per_round)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {n: fn.launches - before[n] for n, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        st = orch.stats()
        # ms a step and samples/s, per trainer and round after the first
        # (the first pays the card's warm-up)
        step_ms, rates = [], []
        for prev, rec in zip(per_round, per_round[1:]):
            for i in range(len(trainers)):
                dt = rec["train_s"][i] - prev["train_s"][i]
                n = rec["steps"][i] - prev["steps"][i]
                if n:
                    step_ms.append(dt / n * 1e3)
                    rates.append(n * args.batch / dt)
        k = len(trainers)
        gen_bytes = core_ltfb.tree_nbytes(p0["gen"])
        disc_params = _mlp_params((FULL.latent_dim, *FULL.disc_hidden, 1))
        pairs = sum(int((core_ltfb.random_pairing(k, r, cfg.seed)
                         != np.arange(k)).sum())
                    for r in range(args.rounds))
        metrics = [v for t in trainers for v in t.last_metrics.values()] \
            + [t.tournament_metric for t in trainers] + list(trace)
        # one GAN step of trainer 0 under the profiler
        t = trainers[0]
        batch = t.loader()
        prof = _profile(torch, lambda: fns.train_step(
            t.params, t.opt_state, batch, t.hparams),
            ranges=(OPTIMIZER_RANGE,))
        opt_ms = prof["range_ms"][OPTIMIZER_RANGE]
        mm_ms = prof["group_ms"]["matmul"]
        prof["gan_groups_ms"] = {
            "matmul": mm_ms, "optimizer_elementwise": opt_ms,
            "other": prof["device_busy_ms"] - mm_ms - opt_ms}
        b_ms, b_by, b_bytes, b_flops = gan_step_bound(FULL, args.batch)
        # a checkpoint after round 3, restored into a fresh orchestrator
        t0 = time.perf_counter()
        orch.save_checkpoint()
        save_s = time.perf_counter() - t0
        fresh = TournamentOrchestrator(fns, plan, cfg)
        t0 = time.perf_counter()
        resumed = fresh.maybe_resume()
        restore_s = time.perf_counter() - t0
        mismatched = []
        for i, (a, b) in enumerate(zip(trainers, fresh.population.trainers)):
            for h in a.params:
                for n, w in a.params[h].items():
                    pairs_ab = (("w", w, b.params[h][n]),
                                ("m", a.opt_state[h]["m"][n],
                                 b.opt_state[h]["m"][n]),
                                ("v", a.opt_state[h]["v"][n],
                                 b.opt_state[h]["v"][n]))
                    mismatched += [f"{i}.{h}.{n}.{what}"
                                   for what, x, y in pairs_ab
                                   if not torch.equal(x, y)]
            if (a.hparams, a.steps, a.wins) != (b.hparams, b.steps, b.wins):
                mismatched.append(f"{i}.meta")
        fresh_round = fresh.population.round
        # the CLI's round is saved (step 4) when the surrogate phase
        # serves from this population
        clis = _ltfb_clis(torch, device, [
            *LTFB_ARGS, "--rounds", "1", "--ckpt-every",
            "1" if workdir else "0", "--device", device, "--data-dir",
            f"{tmp}/data", "--ckpt-dir", f"{tmp}/ckpt",
            "--trace-out", f"{tmp}/ltfb_trace.json",
            "--prom-out", f"{tmp}/ltfb.prom",
            "--genealogy", f"{tmp}/genealogy.jsonl", "--metrics-port", "0"])
        clis["ltfb"]["telemetry"] = _ltfb_telemetry(
            tmp, clis["ltfb"].pop("scraped"), len(trainers))
        served = _keep_winners(fns, trainers[0], f"{tmp}/ckpt",
                               f"{tmp}/next") if workdir else None
    finally:
        for o in (orch, fresh):
            if o is not None:
                o.close()
        shutil.rmtree(f"{tmp}/data", ignore_errors=True)
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "ltfb", "arch": FULL.name, "params": n_params,
          "dtype": FULL.dtype,
          "allow_tf32": tf32,
          "trainers": k, "batch": args.batch, "rounds": args.rounds,
          "steps_per_round": args.steps_per_round, "scope": cfg.scope,
          "store_mode": cfg.store_mode, "samples": args.samples,
          "files": len(plan.files), "image_size": FULL.image_size,
          "data_gen_s": data_s, "setup_s": setup_s, "run_s": run_s,
          "val_init": val_init, "best_val_trace": trace,
          "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
          "samples_per_s_per_trainer_median": statistics.median(rates),
          "data_wait_s": st["data_wait_seconds"],
          "prefetch_wait_s": st["prefetch_wait_seconds"],
          "tournament_s": st["tournament_seconds"],
          "round_wall_s": st["round_wall_seconds"], "per_round": per_round,
          "efficiency_note": "the trainers time-share one card; speedup "
                             "and efficiency count one card per trainer",
          "efficiency": st["efficiency"],
          "exchange_bytes": st["tournament_exchange_bytes"],
          "generator_bytes": gen_bytes, "paired_candidates": pairs,
          "wins": [d["wins"] for d in st["per_trainer"]],
          "adoptions": [d["adoptions"] for d in st["per_trainer"]],
          "lrs": [tr.hparams["lr"] for tr in trainers],
          "peak_mem_gib": peak / 2**30, "profiled_step": prof,
          "step_bound_ms": b_ms, "step_bound_by": b_by,
          "step_bound_bytes": b_bytes, "step_flops": b_flops,
          "ckpt_save_s": save_s, "ckpt_restore_s": restore_s,
          "resumed_round": fresh_round, "ckpt_mismatches": mismatched[:8],
          "kernel_launches": launches, "clis": clis})
    check(not any(launches.values()),
          f"ltfb: the f32 MLP path launched a kernel: {launches}")
    check(not tf32, "ltfb: TF32 is on; the config is f32")
    check(all(math.isfinite(v) for v in metrics + val_init),
          f"ltfb: non-finite metric in {metrics}")
    check(trace[-1] < min(val_init),
          f"ltfb: best_val {trace[-1]} not below the initial best "
          f"{min(val_init)}")
    check(gen_bytes == 4 * (FULL.param_count() - disc_params),
          f"ltfb: generator bytes {gen_bytes}")
    check(st["tournament_exchange_bytes"] == pairs * gen_bytes,
          f"ltfb: exchange bytes {st['tournament_exchange_bytes']} != "
          f"{pairs} x {gen_bytes}")
    check(resumed and fresh_round == args.rounds and not mismatched,
          f"ltfb: checkpoint restore: resumed={resumed} round="
          f"{fresh_round} mismatches={mismatched[:8]}")
    for name, run in clis.items():
        check(run["rc"] == 0 and not any(run["launches"].values()),
              f"ltfb: {name} CLI: rc={run['rc']} launches={run['launches']}")
        check(run["values"] and all(map(math.isfinite, run["values"])),
              f"ltfb: {name} CLI printed {run['values']}")
    check(clis["ltfb"]["resumed"],
          "ltfb: the ltfb CLI did not resume from the phase's checkpoint")
    return served


def _keep_winners(fns, trainer, pop_dir, next_dir):
    """Export the winner of each population step in ``pop_dir`` (by
    recorded wins), move the newest one's files to ``next_dir`` (they land
    mid-run later, as a trainer's export would), and delete the trainer
    files and manifests: the serving phases read winners only.  Returns
    ``(pop_dir, next_dir)``."""
    from repro_torch.serve import registry as reg

    like, _ = fns.to_ckpt(trainer.params, trainer.opt_state)
    steps = reg.population_steps(pop_dir)
    check(len(steps) >= 2, f"need two population steps, got {steps}")
    for step in steps:
        reg.export_winner(pop_dir, like, step=step)
    _move_winner(pop_dir, next_dir, steps[-1])
    _prune_members(pop_dir, steps)
    return pop_dir, next_dir


def _move_winner(src, dst, step):
    """Move ``winner_step_<step>.ckpt`` and its sidecar from ``src`` to
    ``dst`` (sidecar first: a poll never sees a winner without it)."""
    from repro_torch.serve import registry as reg

    os.makedirs(dst, exist_ok=True)
    path = reg.winner_path(src, step)
    for a in (reg.checksum_path(path), path):
        os.replace(a, os.path.join(dst, os.path.basename(a)))


def _prune_members(pop_dir, steps):
    """Delete the trainer files and manifests of ``steps``."""
    for f in os.listdir(pop_dir):
        if any(f.startswith(f"step_{s}_trainer_") or f == f"step_{s}.manifest"
               for s in steps):
            os.remove(os.path.join(pop_dir, f))


def _ltfb_clis(torch, device, ltfb_argv):
    """Both CycleGAN entry points as a user calls them, on the card: the
    ltfb CLI resuming from the phase's checkpoint for one more round (its
    ``--metrics-port`` endpoint scraped over HTTP just before the CLI
    closes it), and the train CLI's CycleGAN path for 20 steps on
    ``GAN_CLI_SAMPLES`` JAG samples
    (:func:`_run_cli`)."""
    import re
    import urllib.request

    from repro_torch.launch import ltfb as lt
    from repro_torch.launch import train as tlaunch
    from repro_torch.train import telemetry as train_tel

    number = re.compile(r"\b(?:best_val|speedup|val|g|d)=([^\s,x]+)")
    scraped = []
    close = train_tel.MetricsServer.close

    def scrape_then_close(server):
        url = f"http://127.0.0.1:{server.port}/metrics"
        with urllib.request.urlopen(url, timeout=60) as r:
            scraped.append(r.read().decode())
        close(server)

    train_tel.MetricsServer.close = scrape_then_close
    try:
        ltfb_run = _run_cli(torch, lt.main, ltfb_argv, "[ltfb]", number)
    finally:
        train_tel.MetricsServer.close = close
    ltfb_run["scraped"] = scraped
    runs = {"ltfb": ltfb_run,
            "train": _run_cli(torch, tlaunch.main,
                              ["--arch", "icf-cyclegan", "--steps", "20",
                               "--samples", str(GAN_CLI_SAMPLES),
                               "--device", device], "", number)}
    runs["ltfb"]["resumed"] = any("[ltfb] resumed at round 3" in ln
                                  for ln in runs["ltfb"]["lines"])
    return runs


TRAINER_SPANS = {"data_wait", "step", "train_round", "tournament_eval",
                 "partner_exchange"}


def _ltfb_telemetry(tmp, scraped, k) -> dict:
    """The ltfb CLI's telemetry outputs: every trainer's row in the trace
    holds :data:`TRAINER_SPANS`, the Prometheus file states a finite
    model FLOP/s, the HTTP endpoint served the file's text, and
    ``python -m repro_torch.launch.lineage`` walks the champion's
    ancestry back to the population's init."""
    trace = json.load(open(f"{tmp}/ltfb_trace.json"))
    rows = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
            if e["ph"] == "M"}
    spans = {}
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            spans.setdefault(rows[e["tid"]], set()).add(e["name"])
    prom = open(f"{tmp}/ltfb.prom").read()
    samples = dict(ln.rsplit(" ", 1) for ln in prom.splitlines()
                   if not ln.startswith("#"))
    flops_s = float(samples.get("repro_train_model_flops_per_s", "nan"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lineage", "--genealogy",
         f"{tmp}/genealogy.jsonl", "--json"], env=env, capture_output=True,
        text=True, timeout=300)
    lineage = json.loads(proc.stdout) if proc.returncode == 0 else {}
    chain = lineage.get("ancestry", [])
    out = {"trace_events": trace["otherData"]["emitted"],
           "dropped": trace["otherData"]["dropped"],
           "trainer_rows": {r: sorted(v) for r, v in sorted(spans.items())},
           "flops_per_step": float(samples.get("repro_train_flops_per_step",
                                               "nan")),
           "model_flops_per_s": flops_s,
           "prom_lines": len(prom.splitlines()),
           "http_equals_file": scraped == [prom],
           "lineage_rc": proc.returncode,
           "champion": lineage.get("champion"),
           "lineage_summary": lineage.get("summary"),
           "ancestry": [r.get("t") for r in chain]}
    check(all(spans.get(f"trainer {i}") == TRAINER_SPANS for i in range(k))
          and out["dropped"] == 0,
          f"ltfb CLI trace: rows {out['trainer_rows']}")
    check(math.isfinite(flops_s) and flops_s > 0,
          f"ltfb CLI --prom-out: model FLOP/s {flops_s}")
    check(out["http_equals_file"],
          f"ltfb CLI --metrics-port served {len(scraped)} bodies, not the "
          "--prom-out text")
    check(proc.returncode == 0 and chain and chain[0]["t"] == "init",
          f"lineage: rc={proc.returncode} {proc.stderr[-400:]} "
          f"ancestry={out['ancestry']}")
    return out


def _run_cli(torch, main, argv, pick, number):
    """One entry point as a user calls it: its exit code, wall seconds,
    the numbers its ``pick`` lines print (``number`` a regex with one
    group), its kernel launches and those lines."""
    import contextlib
    import io

    counters = _all_counters()
    before = {n: fn.launches for n, fn in counters.items()}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith(pick)]
    return {"argv": argv, "rc": rc, "s": time.perf_counter() - t0,
            "values": [float(v) for ln in lines
                       for v in number.findall(ln)],
            "launches": {n: fn.launches - before[n]
                         for n, fn in counters.items()},
            "lines": lines}


# ---------------------------------------------------------------------------
# from the tournament to serving: LM trainers in LTFB, the winner registry
# with hot swap, the CycleGAN surrogate
# ---------------------------------------------------------------------------


def _sync(torch, device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _peak_gib(torch, device):
    if not str(device).startswith("cuda"):
        return None
    return torch.cuda.max_memory_allocated() / 2**30


def _reset_peak(torch, device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()


def _bytes_of(directory, prefix) -> int:
    return sum(os.path.getsize(os.path.join(directory, f))
               for f in os.listdir(directory) if f.startswith(prefix))


def phase_ltfb_lm(torch, workdir, device="cuda", extra=()):
    """LTFB over two qwen3-0.6b trainers at full width cut to
    ``LM_POP_LAYERS`` layers, in bf16, through
    ``repro_torch.launch.ltfb``'s functions: round 1's winner written from
    memory, a population checkpoint after round 2 (its winner exported),
    the round-2 population restored into a fresh orchestrator.  Returns
    the kernel launches and the directories the next phases read."""
    import numpy as np

    import threading

    from repro_torch import bridge
    from repro_torch.core import ltfb as core_ltfb
    from repro_torch.core.tournament import TournamentOrchestrator
    from repro_torch.launch import ltfb as lt
    from repro_torch.serve import registry as reg

    data, pop = f"{workdir}/lm_data", f"{workdir}/lm_pop"
    smoke = "--smoke" in extra
    args = lt.finish_args(lt.build_parser().parse_args(
        [*LM_LTFB_ARGS, *_pop_flags(smoke), *extra, "--device", device,
         "--data-dir", data, "--ckpt-dir", pop]))
    lt.check_ported(args)
    cfg = lt.lm_config(args)
    t0 = time.perf_counter()
    plan = lt.build_plan(args)
    data_s = time.perf_counter() - t0
    fns, tcfg = lt.build_fns(args), lt.build_config(args)
    forwards, lock = [0], threading.Lock()
    metric = fns.metric

    def counted(params, batch):
        with lock:
            forwards[0] += 1
        return metric(params, batch)

    fns = dataclasses.replace(fns, metric=counted)
    orch = fresh = None
    try:
        t0 = time.perf_counter()
        orch = TournamentOrchestrator(fns, plan, tcfg)
        _sync(torch, device)
        setup_s = time.perf_counter() - t0
        trainers = orch.population.trainers
        p0 = trainers[0].params
        n_params = sum(t.numel() for t in p0.values())
        model_bytes = core_ltfb.tree_nbytes(p0)
        like = bridge.params_to_jax_layout(p0, cfg)
        rounds, held = [], {}

        def on_round(o):
            st = o.stats()
            rounds.append({
                "train_s": [d["train_seconds"] for d in st["per_trainer"]],
                "steps": [d["steps"] for d in st["per_trainer"]],
                "tournament_s": st["tournament_seconds"],
                "wins": [d["wins"] for d in st["per_trainer"]],
                "adoptions": [d["adoptions"] for d in st["per_trainer"]],
                "metrics": [[v for v in d["train_metrics"].values()]
                            + [d["tournament_metric"]]
                            for d in st["per_trainer"]]})
            if o.population.round == 1:
                # round 2 steps from these tensors (shared where a trainer
                # adopted): by reference, and a copy
                for i, t in enumerate(o.population.trainers):
                    held[i] = (t.params, {n: x.clone()
                                          for n, x in t.params.items()})

        orch.on_round = on_round
        counters = _train_counters()
        before = {n: fn.launches for n, fn in counters.items()}
        forwards[0] = 0
        _sync(torch, device)
        _reset_peak(torch, device)
        t0 = time.perf_counter()
        # round 1 saves no population checkpoint (the sixteenth slice's
        # cut, ~30 s): its winner file is written from memory; round 2's
        # checkpoint and export run that path
        trace = orch.run(1, args.steps_per_round)
        t1 = time.perf_counter()
        winner1 = _winner_from_memory(pop, 1, trainers, cfg)
        export_s = time.perf_counter() - t1
        trace += orch.run(1, args.steps_per_round, ckpt_every=1)
        ckpt_bytes = _bytes_of(pop, "step_2_trainer_")
        _sync(torch, device)
        run_s = time.perf_counter() - t0
        launches = {n: fn.launches - before[n] for n, fn in counters.items()}
        n_forwards = forwards[0]
        steps_taken = sum(t.steps for t in trainers)
        peak = _peak_gib(torch, device)
        save_s = orch.checkpoint_seconds
        st = orch.stats()
        written = [f"{i}.{n}" for i, (ref, copy) in held.items()
                   for n in ref if not torch.equal(ref[n], copy[n])]
        held.clear()
        # and by force: trainer 0 adopts trainer 1's weights and steps on
        # its own optimizer state (outside the counted run)
        ta, tb = trainers
        shared = tb.params
        snap = {n: x.clone() for n, x in shared.items()}
        stepped, _, _ = fns.train_step(shared, ta.opt_state, ta.loader(),
                                       ta.hparams)
        written += [f"forced.{n}" for n in snap
                    if not torch.equal(shared[n], snap[n])]
        moved = any(not torch.equal(stepped[n], snap[n]) for n in snap)
        del snap, stepped
        # the round-2 population into a fresh orchestrator
        fresh = TournamentOrchestrator(fns, plan, tcfg)
        t0 = time.perf_counter()
        resumed = fresh.maybe_resume()
        _sync(torch, device)
        restore_s = time.perf_counter() - t0
        mismatched = []
        for i, (a, b) in enumerate(zip(trainers,
                                       fresh.population.trainers)):
            for n, w in a.params.items():
                mismatched += [f"{i}.{n}.{what}" for what, x, y in (
                    ("w", w, b.params[n]),
                    ("m", a.opt_state["m"][n], b.opt_state["m"][n]),
                    ("v", a.opt_state["v"][n], b.opt_state["v"][n]))
                    if not torch.equal(x, y)]
            if (a.hparams, a.steps, a.wins, int(a.opt_state["step"])) != \
                    (b.hparams, b.steps, b.wins, int(b.opt_state["step"])):
                mismatched.append(f"{i}.meta")
        fresh_round = fresh.population.round
        # a third round from the same state twice: resumed (its loaders
        # start the epoch again, as the ltfb CLI's do) and without a stop
        round3 = {"resumed": fresh.run(1, args.steps_per_round)[0],
                  "uninterrupted": orch.run(1, args.steps_per_round)[0]}
        fresh.close()
        fresh = None
        t1 = time.perf_counter()
        _, winner2 = reg.export_winner(pop, like, step=2)
        export_s = (export_s, time.perf_counter() - t1)
    finally:
        for o in (orch, fresh):
            if o is not None:
                o.close()
    k = len(trainers)
    # per trainer: ms a step and tokens/s in round 2 (round 1 warms up)
    step_ms = [(b - a) / (sb - sa) * 1e3 for a, b, sa, sb in zip(
        rounds[0]["train_s"], rounds[1]["train_s"], rounds[0]["steps"],
        rounds[1]["steps"])]
    tokens = args.batch * args.seq
    pairs = sum(int((core_ltfb.random_pairing(k, r, tcfg.seed)
                     != np.arange(k)).sum()) for r in range(args.rounds))
    cuda = str(device).startswith("cuda")
    expect = {n: v if cuda else 0 for n, v in _lm_launches(
        cfg.num_layers, steps_taken, n_forwards).items()}
    metrics = [v for r in rounds for m in r["metrics"] for v in m] \
        + list(trace)
    emit({"phase": "ltfb_lm", "arch": cfg.name, "dtype": cfg.dtype,
          "params": n_params, "model_bytes": model_bytes, "trainers": k,
          "batch": args.batch, "seq": args.seq, "rounds": args.rounds,
          "steps_per_round": args.steps_per_round, "scope": tcfg.scope,
          "optimizer": args.optimizer, "samples": args.samples,
          "shards": len(plan.files), "data_gen_s": data_s,
          "setup_s": setup_s, "run_s": run_s, "best_val_trace": trace,
          "step_ms_round2": step_ms,
          "tokens_per_s_per_trainer": [tokens / ms * 1e3 for ms in step_ms],
          "tournament_s": st["tournament_seconds"], "per_round": rounds,
          "exchange_bytes": st["tournament_exchange_bytes"],
          "paired_candidates": pairs, "metric_forwards": n_forwards,
          "steps": steps_taken, "launches": launches, "expected": expect,
          "ckpt_bytes": ckpt_bytes, "ckpt_save_s": save_s,
          "ckpt_restore_s": restore_s, "winner_export_s": export_s,
          "winners": [winner1, winner2], "peak_mem_gib": peak,
          "round3_best_val": round3,
          "adopted_in_round_1": any(rounds[0]["adoptions"]),
          "forced_adoption_step_moved": moved,
          "written_through": written[:8], "resumed_round": fresh_round,
          "ckpt_mismatches": mismatched[:8]})
    check(all(math.isfinite(v) for v in metrics),
          f"ltfb_lm: non-finite loss or metric in {metrics}")
    check(launches == expect, f"ltfb_lm: launches {launches} != {expect} "
          f"({steps_taken} steps, {n_forwards} metric forwards)")
    check(st["tournament_exchange_bytes"] == pairs * model_bytes,
          f"ltfb_lm: exchange bytes {st['tournament_exchange_bytes']} != "
          f"{pairs} x {model_bytes}")
    check(not written and moved,
          f"ltfb_lm: a step wrote into weights it was given: {written[:8]}")
    check(resumed and fresh_round == args.rounds and not mismatched,
          f"ltfb_lm: restore: resumed={resumed} round={fresh_round} "
          f"mismatches={mismatched[:8]}")
    check(winner1["step"] == 1 and winner2["step"] == 2,
          f"ltfb_lm: winners {winner1} {winner2}")
    return launches, {"pop": pop, "data": data}


def _winner_from_memory(pop_dir, step, trainers, cfg) -> dict:
    """Write round ``step``'s winner file from the trainers in memory as
    ``export_winner`` writes it from a population checkpoint: the trainer
    with the most wins (the first on a tie), its params in the
    checkpoint's layout, its metadata and sha256 sidecar."""
    from repro_torch import bridge
    from repro_torch.checkpoint import ckpt
    from repro_torch.serve import registry as reg

    idx = max(range(len(trainers)), key=lambda i: (trainers[i].wins, -i))
    t = trainers[idx]
    info = {"step": step, "trainer": idx, "steps": int(t.steps),
            "wins": int(t.wins), "selected_by": "wins"}
    path = reg.winner_path(pop_dir, step)
    ckpt.save(path, {"params": bridge.params_to_jax_layout(t.params, cfg)},
              metadata=info)
    reg.write_checksum(path)
    return info


def _lm_tracer(sched, registry, land):
    """Wrap a scheduler so a run records, per request, the swap count at
    admission and at the finish, its shared prefix tokens and first-token
    time, and the swap's events; ``land()`` runs before step 6 (the winner
    lands mid-run)."""
    rec = {"admit": {}, "finish": {}, "shared": {}, "first": {},
           "events": {}}
    ev = rec["events"]
    admit, pool_admit = sched._admit, sched.pool.admit
    finish, set_params = sched._finish, sched.set_params
    refresh, step = registry.refresh, sched.step

    def traced_admit(req):
        rec["admit"][req.rid] = sched.stats.hot_swaps
        admit(req)

    def traced_pool_admit(rid, *a, **k):
        slot, shared_len = pool_admit(rid, *a, **k)
        rec["shared"][rid] = shared_len
        return slot, shared_len

    def traced_finish(act):
        rec["finish"][act.req.rid] = sched.stats.hot_swaps
        rec["first"][act.req.rid] = act.first_token_t
        finish(act)

    def traced_refresh():
        t = time.perf_counter()
        found = refresh()
        if found:
            ev["found"] = t
            ev["load_s"] = time.perf_counter() - t
        return found

    def traced_set(params):
        ev["pinned_before"] = sched.pool.as_dict()["pinned_blocks"]
        t = time.perf_counter()
        set_params(params)
        ev["swapped"] = t
        ev["set_s"] = time.perf_counter() - t

    def landing_step():
        if sched._step_count == 5 and "landed" not in ev:
            land()
            ev["landed"] = time.perf_counter()
        step()

    sched._admit, sched.pool.admit = traced_admit, traced_pool_admit
    sched._finish, sched.set_params = traced_finish, traced_set
    registry.refresh, sched.step = traced_refresh, landing_step
    return rec


@exact_f32
def phase_serve_swap(torch, pop_dir, workdir, device="cuda", smoke=False):
    """Serve qwen3-0.6b at the LM tournament's depth in f32 from its
    winners, with
    a drain-mode hot swap from round 1's winner to round 2's, then
    quarantine a torn winner while round 2's keeps serving."""
    import numpy as np

    from repro_torch import bridge
    from repro_torch.data.tokens import token_stream
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models.lm import init_lm
    from repro_torch.serve import registry as reg
    from repro_torch.serve.scheduler import Request, Scheduler
    from repro_torch.train.steps import params_from_ckpt

    cfg = _pop_cfg(smoke, dtype="float32")
    serve_dir = f"{workdir}/serve_lm"
    _move_winner(pop_dir, serve_dir, 1)
    model = init_lm(cfg, seed=0, device=device)
    like = bridge.params_to_jax_layout(model, cfg)
    registry = reg.ModelRegistry(
        serve_dir, like, from_ckpt=lambda tree: params_from_ckpt(
            cfg, tree, model.device, torch.float32))
    t0 = time.perf_counter()
    first = registry.load()
    load_s = time.perf_counter() - t0
    model.load_state_dict(first)
    lens, max_new = SWAP_PROMPTS, SWAP_MAX_NEW
    stream = token_stream(2 * sum(lens), cfg.vocab_size, seed=2)
    prompts, off = [], 0
    for i in range(4):
        n = lens[i % len(lens)]
        prompts.append(np.asarray(stream[off:off + n], np.int32))
        off += n
    # requests 4-7 repeat 0-3's prompts: pinned old-weight pages would
    # serve them were the prefix cache not flushed at the swap
    reqs = [Request(rid=i, prompt=prompts[i % 4], max_new=max_new)
            for i in range(8)]
    sched = Scheduler(cfg, model, num_slots=4, block_size=16,
                      max_len=max(lens) + max_new, registry=registry,
                      watch_every=2, swap_mode="drain", pin_prefix=True,
                      device=device)
    rec = _lm_tracer(sched, registry,
                     lambda: _move_winner(pop_dir, serve_dir, 2))
    for r in reqs:
        sched.submit(r)
    before = (pa.paged_attention.launches, rn.rmsnorm.launches)
    t0 = time.perf_counter()
    results = sched.run()
    _sync(torch, device)
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.paged_attention.launches - before[0],
                "rmsnorm": rn.rmsnorm.launches - before[1]}
    st = sched.stats.as_dict()
    second = registry.params
    ev = rec["events"]
    old = [r for r in reqs if rec["admit"][r.rid] == 0]
    new = [r for r in reqs if rec["admit"][r.rid] == 1]
    latency = min(rec["first"][r.rid] for r in new) - ev["found"] \
        if new and "found" in ev else None
    model.load_state_dict(first)
    chk_old = _recompute_check(torch, model, sched, old, max_new)
    model.load_state_dict(second)
    chk_new = _recompute_check(torch, model, sched, new, max_new)
    # a torn winner lands; round 2's keeps serving
    good, bad = reg.winner_path(serve_dir, 2), reg.winner_path(serve_dir, 3)
    shutil.copy(good, bad)
    reg.write_checksum(bad)
    with open(bad, "r+b") as f:
        f.truncate(os.path.getsize(bad) // 2)
    more = [Request(rid=8 + i, prompt=prompts[i], max_new=8)
            for i in range(2)]
    for r in more:
        sched.submit(r)
    sched.run()
    chk_more = _recompute_check(torch, model, sched, more, 8)
    quarantined = os.path.exists(bad + ".corrupt")
    shutil.rmtree(serve_dir, ignore_errors=True)
    blocks, norms = len(model.blocks), 4 * len(model.blocks) + 1
    calls = st["decode_steps"] + st["prefill_chunks"]
    cuda = str(device).startswith("cuda")
    expect = {"paged_attention": blocks * st["decode_steps"] if cuda else 0,
              "rmsnorm": norms * calls if cuda else 0}
    mismatches = chk_old[2] + chk_new[2] + chk_more[2]
    emit({"phase": "serve_swap", "arch": cfg.name, "dtype": cfg.dtype,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "requests": len(reqs), "slots": 4, "prompt_lens": lens,
          "max_new": max_new, "swap_mode": "drain", "watch_every": 2,
          "winner_load_s": load_s, "wall_s": wall,
          "tokens_per_s": st["tokens_per_s"], "completed": st["completed"],
          "hot_swaps": st["hot_swaps"],
          "swap_load_s": ev.get("load_s"), "swap_set_s": ev.get("set_s"),
          "drain_s": ev["swapped"] - ev["found"] if "swapped" in ev
          else None,
          "swap_latency_s": latency,
          "admitted_old": [r.rid for r in old],
          "admitted_new": [r.rid for r in new],
          "shared_tokens": rec["shared"],
          "pinned_before_swap": ev.get("pinned_before"),
          "positions": chk_old[0] + chk_new[0] + chk_more[0],
          "ties": len(chk_old[1] + chk_new[1] + chk_more[1]),
          "mismatches": mismatches[:8], "launches": launches,
          "expected": expect, "decode_steps": st["decode_steps"],
          "prefill_chunks": st["prefill_chunks"],
          "rejected_corrupt": registry.rejected_corrupt,
          "swap_rejected_corrupt": sched.stats.swap_rejected_corrupt,
          "serving_step": registry.step, "quarantined": quarantined})
    check(st["completed"] == len(reqs) and all(
        len(results[r.rid]) == max_new for r in reqs),
          f"serve_swap: {st['completed']} of {len(reqs)} completed")
    check(st["hot_swaps"] == 1 and old and new,
          f"serve_swap: hot_swaps={st['hot_swaps']}, {len(old)} requests "
          f"before and {len(new)} after")
    check(all(rec["admit"][r] == rec["finish"][r] for r in rec["admit"]),
          "serve_swap: a request spans both sets of weights")
    check(not mismatches, f"serve_swap: served tokens differ from the "
          f"recompute on their weights at {len(mismatches)} positions")
    check(ev.get("pinned_before", 0) > 0
          and all(rec["shared"][r.rid] == 0 for r in new),
          "serve_swap: a request admitted after the swap shares an "
          f"old-weight page: {rec['shared']}")
    check(launches == expect, f"serve_swap: launches {launches} != "
          f"{expect}")
    check(registry.rejected_corrupt == 1 and quarantined
          and sched.stats.swap_rejected_corrupt == 1
          and sched.stats.hot_swaps == 1 and registry.step == 2
          and sched.stats.completed == len(reqs) + len(more),
          "serve_swap: the torn winner was not quarantined while round "
          "2's served on")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "serve_swap: TF32 is on; the check is f32")
    return launches


def surrogate_bound(cfg, rows: int):
    """(ms, bound_by, bytes, flops, host_ms) of one surrogate batch of
    ``rows``: ``predict`` is the ``fwd`` MLP then ``dec``; the weights are
    read once, the inputs and outputs moved once, 2 operations a
    multiply-add; ``host_ms`` the results' copy over a PCIe Gen5 x16
    link at its 64 GB/s."""
    fwd = (cfg.input_dim, *cfg.fwd_hidden, cfg.latent_dim)
    dec = (cfg.latent_dim, *cfg.dec_hidden, cfg.output_dim)
    n_fwd, n_dec = _mlp_params(fwd), _mlp_params(dec)
    macs = sum(a * b for dims in (fwd, dec)
               for a, b in zip(dims[:-1], dims[1:]))
    out = 4 * rows * cfg.output_dim
    moved = 4 * (n_fwd + n_dec) + 4 * rows * cfg.input_dim + out
    flops = 2 * rows * macs
    ms, by = bound(moved, flops, "float32")
    return ms, by, moved, flops, out / PCIE_BYTES_PER_S * 1e3


@exact_f32
def phase_surrogate(torch, pop_dir, next_dir, device="cuda", smoke=False):
    """The full-width CycleGAN surrogate served from the CycleGAN
    tournament's winners through ``SurrogateEngine``, hot-swapping from
    one population step's winner to the next mid-run."""
    import numpy as np

    from repro_torch import bridge
    from repro_torch.configs.icf_cyclegan import FULL, SMOKE
    from repro_torch.data import jag
    from repro_torch.models import icf_cyclegan as cg
    from repro_torch.serve import registry as reg
    from repro_torch.serve.surrogate import SurrogateEngine
    from repro_torch.train.steps import tree_to

    ccfg = SMOKE if smoke else FULL
    like = bridge.cyclegan_params_to_jax_layout(
        cg.init_cyclegan(ccfg, 0, device))
    registry = reg.ModelRegistry(
        pop_dir, like, from_ckpt=lambda tree: tree_to(
            bridge.cyclegan_params_from_jax(tree), device))
    first = registry.load()
    steps = [registry.step, reg.latest_winner_step(next_dir)]
    eng = SurrogateEngine(ccfg, first, max_batch=SURROGATE_BATCH,
                          bucket=8, registry=registry, watch_every=4,
                          device=device)
    n_q, q_rows = SURROGATE_QUERIES
    xs = jag.sample_inputs(n_q * q_rows, seed=1)
    for i in range(n_q):
        eng.submit(i, xs[i * q_rows:(i + 1) * q_rows])
    ev = {}
    step, refresh = eng.step, registry.refresh

    def landing_step():
        if eng._step_count == 6 and "landed" not in ev:
            _move_winner(next_dir, pop_dir, steps[1])
            ev["landed"] = True
        step()

    def traced_refresh():
        t = time.perf_counter()
        found = refresh()
        if found:
            ev["load_s"] = time.perf_counter() - t
        return found

    host_ms = {"step": [], "_stage": [], "_dispatch": [], "_collect": []}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            host_ms[name].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    for name in ("_stage", "_dispatch", "_collect"):
        setattr(eng, name, timed(name, getattr(eng, name)))
    eng.step, registry.refresh = timed("step", landing_step), traced_refresh
    counters = _all_counters()
    before = {n: fn.launches for n, fn in counters.items()}
    _sync(torch, device)
    t0 = time.perf_counter()
    results = eng.run()
    _sync(torch, device)
    wall = time.perf_counter() - t0
    launches = {n: fn.launches - before[n] for n, fn in counters.items()}
    second = registry.params
    weights = (first, second)
    served = [eng.served_by[i] for i in range(n_q)]
    per_batch = SURROGATE_BATCH // q_rows
    bad, err = [], 0.0
    with torch.no_grad():
        for b in range(0, n_q, per_batch):
            gens = set(served[b:b + per_batch])
            if len(gens) != 1:
                bad.append(f"batch {b // per_batch} mixes weights {gens}")
                continue
            rows = torch.from_numpy(
                xs[b * q_rows:(b + per_batch) * q_rows]).to(device)
            want = cg.predict(weights[gens.pop()]["gen"], rows).cpu()
            got = torch.from_numpy(np.concatenate(
                [results[i] for i in range(b, b + per_batch)]))
            ok, e = _within(got, want, SURROGATE_TOL)
            err = max(err, e)
            if not ok:
                bad.append(f"batch {b // per_batch}: max err {e}")
    batch_ms = _surrogate_batch_ms(torch, cg, second, xs, device)
    b_ms, b_by, b_bytes, b_flops, link_ms = surrogate_bound(
        ccfg, SURROGATE_BATCH)
    n_rows = n_q * q_rows
    emit({"phase": "surrogate", "arch": ccfg.name, "dtype": ccfg.dtype,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "output_dim": ccfg.output_dim, "queries": n_q,
          "rows_per_query": q_rows, "rows": n_rows,
          "max_batch": SURROGATE_BATCH, "bucket": 8, "watch_every": 4,
          "winner_steps": steps, "wall_s": wall, "rows_per_s": n_rows / wall,
          "swap_load_s": ev.get("load_s"),
          "host_ms_median": {n: statistics.median(v)
                             for n, v in host_ms.items()},
          "step_ms": host_ms["step"],
          "rows_per_s_steady": SURROGATE_BATCH * 1e3
          / statistics.median(host_ms["step"]),
          "hot_swaps": eng.stats.hot_swaps,
          "served_by_counts": [served.count(0), served.count(1)],
          "overlapped_stages": eng.overlapped_stages,
          "max_abs_err": err, "bad": bad[:8], "kernel_launches": launches,
          "batch_device_ms": batch_ms, "batch_bound_ms": b_ms,
          "batch_bound_by": b_by, "batch_bytes": b_bytes,
          "batch_flops": b_flops,
          "batch_output_bytes": 4 * SURROGATE_BATCH * ccfg.output_dim,
          "host_link_ms_at_64GBps": link_ms})
    check(eng.stats.completed == n_q and eng.stats.hot_swaps == 1
          and served == sorted(served) and set(served) == {0, 1},
          f"surrogate: completed={eng.stats.completed} hot_swaps="
          f"{eng.stats.hot_swaps} served_by={served}")
    check(not bad, f"surrogate: rows disagree with predict on their "
          f"weights: {bad[:8]}")
    check(eng.overlapped_stages > 0, "surrogate: no staging overlapped")
    check(not any(launches.values()),
          f"surrogate: the f32 MLP path launched a kernel: {launches}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "surrogate: TF32 is on; the config is f32")


def _surrogate_batch_ms(torch, cg, params, xs, device):
    """Median device ms (CUDA events, 10 of 12 runs) of one batch as the
    engine runs it on a stream of its own: the upload from pinned memory,
    ``predict``, the results' copy into a pinned buffer, and for
    comparison the same copy into pageable memory, a reused buffer and a
    fresh one (its pages touched first by the copy).  None off the card."""
    if not str(device).startswith("cuda"):
        return None
    stream = torch.cuda.Stream()
    names = ("upload", "predict", "copy_pinned", "copy_pageable",
             "copy_pageable_fresh")
    runs = {n: [] for n in names}
    x = torch.from_numpy(xs[:SURROGATE_BATCH]).pin_memory()
    with torch.no_grad():
        y_dev = cg.predict(params["gen"], x.to(device))
        pinned = torch.empty(y_dev.shape, pin_memory=True)
        pageable = torch.empty(y_dev.shape)
        for rep in range(12):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            fresh = torch.empty(y_dev.shape)
            with torch.cuda.stream(stream):
                ev[0].record()
                xd = x.to(device, non_blocking=True)
                ev[1].record()
                y = cg.predict(params["gen"], xd)
                ev[2].record()
                pinned.copy_(y, non_blocking=True)
                ev[3].record()
                pageable.copy_(y)
                ev[4].record()
                fresh.copy_(y)
                ev[5].record()
            torch.cuda.synchronize()
            if rep >= 2:
                for n, a, b in zip(names, ev, ev[1:]):
                    runs[n].append(a.elapsed_time(b))
    return {n: statistics.median(v) for n, v in runs.items()}


def phase_clis(torch, workdir, surrogate_dir, lm, device="cuda",
               smoke=False):
    """The serving, ltfb and train CLIs as a user calls them, on the
    checkpoints of the phases before: each prints finite values."""
    import re

    from repro_torch.launch import ltfb as lt
    from repro_torch.launch import serve
    from repro_torch.launch import train as tl

    from repro_torch.telemetry import enable_json_logs

    size = ["--smoke"] if smoke else []
    train_dir = f"{workdir}/train_ckpt"
    serve_trace = f"{workdir}/serve_trace.json"
    profile_dir = f"{workdir}/serve_profile"
    runs = {}
    runs["serve_surrogate"] = _run_cli(
        torch, serve.main, ["--arch", "icf-cyclegan", "--ckpt-dir",
                            surrogate_dir, "--device", device, *size],
        "[serve]", re.compile(r"output_mean=(\S+)"))
    runs["serve_lm"] = _run_cli(
        torch, serve.main, ["--arch", "qwen3-0.6b", "--ckpt-dir", lm["pop"],
                            "--requests", "4", "--device", device,
                            "--trace-out", serve_trace, "--profile-steps",
                            "4", "--profile-dir", profile_dir, *size,
                            *_pop_flags(smoke)],
        "[serve]", re.compile(r"([\d.]+) tok/s"))
    runs["serve_lm"]["telemetry"] = _serve_cli_telemetry(
        runs["serve_lm"], serve_trace, profile_dir)
    runs["serve_lm_dense"] = _run_cli(
        torch, serve.main, ["--arch", "qwen3-0.6b", "--ckpt-dir", lm["pop"],
                            "--requests", "4", "--layout", "dense",
                            "--device", device, *size, *_pop_flags(smoke)],
        "[serve]", re.compile(r"([\d.]+) tok/s"))
    # under --log-json every report line is one JSON record; the switch
    # is global, so it goes off again before the next CLI reports
    # the LM ltfb CLI trains a round from scratch: the sixteenth slice cut
    # its resume of phase 15's ~12 GB population (41-62 s; phase 15
    # restores it bit-equal, and ltfb_recurrent's CLI rerun resumes an LM
    # population under --log-json)
    try:
        runs["ltfb_lm"] = _run_cli(
            torch, lt.main, [*LM_LTFB_ARGS, *(LM_SMOKE if smoke else ()),
                             "--rounds", "1", "--ckpt-every", "0",
                             "--device", device, "--data-dir", lm["data"],
                             "--ckpt-dir", f"{workdir}/ltfb_lm_cli",
                             "--log-json"],
            "", re.compile(r'"(?:best_val|speedup)": ([^\s,}]+)'))
    finally:
        enable_json_logs(False)
    runs["ltfb_lm"]["events"] = _json_events(runs["ltfb_lm"]["lines"])
    shutil.rmtree(lm["pop"], ignore_errors=True)
    shutil.rmtree(lm["data"], ignore_errors=True)
    train = ["--arch", "qwen3-0.6b", "--batch", "1", "--seq", "1024",
             "--steps", "3", "--ckpt-dir", train_dir, "--log-every", "1",
             "--device", device, *size]
    number = re.compile(r"\b(?:loss|val)=([^\s,]+)")
    # Adam's run takes no checkpoint: the Adafactor pair below drives the
    # CLI's checkpoint and resume, and ltfb_lm writes Adam's moments in
    # the checkpoint's layout and restores them bit-equal (the sixteenth
    # slice cut Adam's step-2 checkpoint and its resuming rerun, ~65 s)
    runs["train_lm"] = _run_cli(torch, tl.main, [*train, "--ckpt-every",
                                                 "0"], "", number)
    adafactor = [*train, "--ckpt-every", "2", "--optimizer", "adafactor"]
    runs["train_adafactor"] = _run_cli(torch, tl.main, adafactor, "",
                                       number)
    runs["train_adafactor_resumed"] = _run_cli(torch, tl.main, adafactor,
                                               "", number)
    shutil.rmtree(train_dir, ignore_errors=True)
    flags = {"serve_surrogate": "[serve] winner: step=",
             "serve_lm": "[serve] winner: step=2",
             "serve_lm_dense": "layout=dense",
             "ltfb_lm": '"event": "ltfb_round"',
             "train_adafactor_resumed": "[train] resumed from"}
    for name, tag in flags.items():
        runs[name]["flag"] = any(tag in ln for ln in runs[name]["lines"])
    emit({"phase": "clis", **{n: {k: v for k, v in r.items()
                                  if k != "lines"} | {
        "lines": r["lines"][-6:]} for n, r in runs.items()}})
    cuda = str(device).startswith("cuda")
    for name, run in runs.items():
        check(run["rc"] == 0 and run["values"]
              and all(map(math.isfinite, run["values"])),
              f"clis: {name}: rc={run['rc']} values={run['values']}")
        check(run.get("flag", True), f"clis: {name} lacks its "
              f"'{flags.get(name)}' line: {run['lines'][-6:]}")
        moved = any(run["launches"].values())
        want = cuda and name != "serve_surrogate"
        check(moved == want, f"clis: {name} launches {run['launches']}")
    events = runs["ltfb_lm"]["events"]
    check(events is not None and events.count("ltfb_round") == 1
          and "ltfb_efficiency" in events,
          f"clis: ltfb_lm --log-json printed {events}")


def _json_events(lines):
    """The event names of a ``--log-json`` run's output, every non-empty
    line one JSON record (None when a line is not one)."""
    try:
        return [json.loads(ln)["event"] for ln in lines if ln.strip()]
    except (ValueError, KeyError):
        return None


def _serve_cli_telemetry(run, trace_path, profile_dir) -> dict:
    """The serve CLI's ``--trace-out`` and ``--profile-steps`` outputs:
    every request's span chain complete with nothing dropped, one
    profile window taken with no error, one trace file written."""
    trace = json.load(open(trace_path))
    tracer_rows = _span_rows(trace)
    complete = sum(map(_chain_complete, tracer_rows.values()))
    profiles = sorted(os.listdir(profile_dir)) \
        if os.path.isdir(profile_dir) else []
    line = next((ln for ln in run["lines"]
                 if ln.startswith("[serve] profile:")), "")
    out = {"requests_traced": len(tracer_rows), "chains_complete": complete,
           "dropped": trace["otherData"]["dropped"],
           "events": trace["otherData"]["emitted"], "profile_line": line,
           "profile_files": profiles,
           "profile_bytes": sum(os.path.getsize(os.path.join(
               profile_dir, f)) for f in profiles)}
    check(len(tracer_rows) == 4 and complete == 4 and out["dropped"] == 0,
          f"clis: serve_lm --trace-out: {out}")
    check("taken=1 " in line and "error=None" in line
          and len(profiles) == 1,
          f"clis: serve_lm --profile-steps: {out}")
    shutil.rmtree(profile_dir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# the seven archs of the ninth slice: dense, audio, MoE, the VLM backbone
# ---------------------------------------------------------------------------

# serve_archs: the new dense and audio archs at FULL in bf16; 8 requests
# over 4 slots, prompts 128/256, 32 new tokens
SERVE_ARCHS = ("qwen2.5-3b", "codeqwen1.5-7b", "granite-8b",
               "musicgen-medium")
SERVE_ARCHS_TRAFFIC = dict(n_req=8, prompt_lens=[128, 256], max_new=32,
                           slots=4)
# serve_moe: deepseek-moe-16b FULL and phi3.5-moe CUT_16L in bf16; 8
# requests over 8 slots, prompts 128/256/512, 32 new tokens
SERVE_MOE_TRAFFIC = dict(n_req=8, prompt_lens=[128, 256, 512], max_new=32,
                         slots=8)
# recompute_archs: every new token arch at full width cut to 2 layers, f32
RECOMPUTE_ARCHS = SERVE_ARCHS + ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")
# train_moe / train_vlm: full widths, depth cut (1 dense + 3 MoE layers of
# deepseek, 8 of qwen2-vl's 28), bf16, B = 2, S = 4096, Adam, 6 steps
CUT_TRAIN = {"train_moe": ("deepseek-moe-16b", 4),
             "train_vlm": ("qwen2-vl-7b", 8)}
CUT_B, CUT_S, CUT_STEPS = 2, 4096, 6
# train_vlm's parity check: a 2-layer full-width forward at S = 256 in
# f32 (TF32 off) on the card against the CPU
VLM_PARITY_S, VLM_PARITY_TOL = 256, 1e-3


def phase_arch_kernels(torch, timer, plain_timer):
    """The kernels at the shapes the new archs give them, each against its
    plain version: paged attention in bf16 at K = 1 over every new served
    head layout (musicgen's 24 heads of 64 with one query head a KV head,
    codeqwen's 32 MHA heads, qwen2.5's 8 query heads a KV head, granite's
    and phi's 4, deepseek's 16 MHA heads); flash forward and backward at
    B = 2, S = 4096 for qwen2-vl (7 query heads a KV head) and deepseek
    (MHA); the RMSNorm forward and backward at the widths d = 1536, 2048,
    3584 and 4096 (the first and third masked into 2048- and 4096-wide
    blocks), decode rows and a train step's rows."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    results = {"paged_attention": [], "flash_attention_fwd": [],
               "flash_attention_bwd": [], "rmsnorm": [], "rmsnorm_bwd": []}
    lengths = torch.randint(100, 545, (8,), generator=gen,
                            device="cuda").tolist()
    for H, Hkv, D in ((24, 24, 64), (32, 32, 128), (16, 2, 128),
                      (32, 8, 128), (16, 16, 128)):
        results["paged_attention"].append(_paged_check(
            torch, timer, gen, 8, H, Hkv, D, 16, 1, "bfloat16", lengths))
    for H, Hkv in ((28, 4), (16, 16)):
        fwd, bwd = _flash_cases(torch, timer, plain_timer, gen, CUT_B,
                                CUT_S, H, Hkv, 128, "bfloat16")
        results["flash_attention_fwd"].append(fwd)
        results["flash_attention_bwd"].append(bwd)
    for d in (1536, 2048, 3584, 4096):
        results["rmsnorm"].append(_rms_check(torch, timer, gen, (8, d),
                                             "bfloat16"))
        fwd, bwd = _rms_train_cases(torch, timer, gen, (CUT_B * CUT_S, d),
                                    path="train_archs")
        results["rmsnorm"].append(fwd)
        results["rmsnorm_bwd"].append(bwd)
    return results


def _bwd_case(torch, timer, plain_timer, name, fn, plain, S, moved, ops,
              exps):
    """A backward kernel against its plain backward (every gradient, f32,
    within ``SCAN_BWD_TOL`` of its largest entry) and against itself (two
    calls, equal bits), timed; the plain version (a Python loop over the
    steps) is timed by ``plain_timer`` up to ``PLAIN_TIMED_S`` steps, past
    it its one comparison call on the host clock.  ``library_ms`` is None:
    no PyTorch call computes either gradient."""
    got = fn()
    again = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_once_ms = (time.perf_counter() - t0) * 1e3
    errs, rel = [], []
    for g, a, w in zip(got, again, want):
        check(torch.equal(g, a), f"{name} S={S}: two calls differ")
        err = (g - w).abs().max().item()
        scale = w.abs().max().item()
        check(err <= SCAN_BWD_TOL * scale, f"{name} S={S}: max |err| {err} "
              f"over {SCAN_BWD_TOL} x {scale}")
        errs.append(err)
        rel.append(err / scale if scale else 0.0)
    b_ms, b_by = bound(moved, ops, "float32", exps)
    timed = S <= PLAIN_TIMED_S
    return {"kernel": name, "dtype": "float32", "max_abs_err": max(errs),
            "max_err_over_scale": max(rel), "tol": SCAN_BWD_TOL,
            "bit_equal_twice": True, "kernel_ms": timer.ms(fn),
            "plain_ms": plain_timer.ms(plain) if timed else plain_once_ms,
            "plain_timing": f"median of {plain_timer.reps}" if timed
            else "one call, host clock",
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": moved, "ops": ops, "exps": exps}


def phase_recurrent_bwd_kernels(torch, timer, plain_timer):
    """recurrent_bwd_kernels: the selective scan's and the sLSTM's
    backward kernels against their plain backwards at the train shapes,
    a serve-length prompt, a ragged tail and nonzero final-state
    cotangents; RMSNorm both ways at jamba's train rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm as sl

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    results = {"mamba_scan_bwd": [], "slstm_scan_bwd": [], "rmsnorm": [],
               "rmsnorm_bwd": []}
    # the sweep's blocks an SM and shared memory a block, by state size
    occupancy = {N: ms.bwd_occupancy(N) for N in ms.STATE_SIZES}
    # (B, S, d_in, N, a nonzero cotangent of the final state); d_in = 200
    # leaves the last 64-channel block 8 channels
    for B, S, d, N, final in ((2, 4096, 16384, 16, False),
                              (1, 500, 16384, 16, False),
                              (2, 100, 1000, 8, False),
                              (1, 77, 2048, 16, True),
                              (1, 45, 200, 8, True)):
        dt = F.softplus(rand(B, S, d) - 4.6)
        a = -torch.arange(1, N + 1, dtype=torch.float32,
                          device="cuda").repeat(d, 1)
        args = (dt, rand(B, S, d), rand(B, S, N), rand(B, S, N), a)
        dy = rand(B, S, d)
        dh = rand(B, d, N) if final else torch.zeros((B, d, N),
                                                     device="cuda")
        h_ckpt = torch.empty(ms.ckpt_shape(dt, a), device="cuda")
        ms.mamba_scan(*args, h_ckpt=h_ckpt)
        tiles = h_ckpt.shape[1]
        # read dt, xc, dy, B_t, C_t, a, the checkpoints and dh_last once;
        # write d_dt, d_xc, d_B, d_C, d_a once.  Per (step, channel,
        # state): one exponential and ~16 f32 flops
        moved = 4 * (5 * B * S * d + 4 * B * S * N + 2 * d * N
                     + B * tiles * d * N + B * d * N)
        case = _bwd_case(
            torch, timer, plain_timer, "mamba_scan_bwd",
            lambda: ms.mamba_scan_bwd(*args, h_ckpt, dy, dh),
            lambda: ref.mamba_scan_bwd_ref(*args, dy, dh), S, moved,
            16 * B * S * d * N, B * S * d * N)
        case.update(B=B, S=S, d_in=d, N=N, nonzero_final=final,
                    ckpt_tiles=tiles, blocks_per_sm=occupancy[N][0],
                    smem_bytes=occupancy[N][1],
                    share_of_bound=case["bound_ms"] / case["kernel_ms"])
        emit(case)
        results["mamba_scan_bwd"].append(case)
        del args, dt, dy, dh, h_ckpt
    # (B, S, d, H, a nonzero cotangent of the final state, exact ties of
    # the stabiliser's max from step 1 on: the i gate 0.5, the f gate 100,
    # r_h's i and f columns zero)
    for B, S, d, H, final, ties in ((4, 4096, 768, 4, False, False),
                                    (1, 500, 768, 4, False, False),
                                    (2, 40, 392, 2, False, False),
                                    (3, 33, 96, 2, True, False),
                                    (2, 64, 768, 4, True, True)):
        dh = d // H
        gx = rand(B, S, 4 * d)
        r = rand(H, dh, 4 * dh) / math.sqrt(dh)
        if ties:
            gx[..., :d], gx[..., d:2 * d] = 0.5, 100.0
            r[..., :2 * dh] = 0.0
        saved = sl.residuals(gx)
        out, _ = sl.slstm_scan(gx, r, saved)
        dy = rand(B, S, d)
        dfin = tuple(rand(B, d) if final else torch.zeros((B, d),
                                                          device="cuda")
                     for _ in range(4))
        # read the gates, the states, dy, h, r_h and the final cotangents;
        # write d_gx and d_r_h.  Per step the transposed recurrent product
        # and d_r_h's (8 d dh flops each), ~40 flops and 6 exponentials of
        # the cell's backward a channel
        moved = 4 * (8 * B * S * d + 3 * B * S * d + 2 * B * S * d
                     + 2 * H * dh * 4 * dh + 4 * B * d)
        case = _bwd_case(
            torch, timer, plain_timer, "slstm_scan_bwd",
            lambda: sl.slstm_scan_bwd(r, out, saved, dy, dfin),
            lambda: ref.slstm_bwd_ref(gx, r, dy, dfin), S, moved,
            B * S * (16 * d * dh + 40 * d), 6 * B * S * d)
        if ties:
            lf = F.logsigmoid(saved[0][:, 1:, d:2 * d])
            check(torch.equal(lf + saved[3][:, :-1], saved[0][:, 1:, :d]),
                  "slstm_scan_bwd ties: lf + m_{t-1} != i")
        C, cb, ks, kl = sl.bwd_plan(dh)
        # the product d_r_h after the recurrence, alone
        d_gx = sl.slstm_scan_bwd(r, out, saved, dy, dfin)[0]
        r_h_grad_ms = timer.ms(lambda: ref.slstm_r_h_grad(out, d_gx, H))
        case.update(B=B, S=S, d=d, H=H, nonzero_final=final, ties=ties,
                    cluster=C, channels_per_block=cb, lanes_per_row=ks,
                    weights_per_lane=kl,
                    share_of_bound=case["bound_ms"] / case["kernel_ms"],
                    r_h_grad_ms=r_h_grad_ms,
                    us_per_step=(case["kernel_ms"] - r_h_grad_ms) * 1e3 / S)
        emit(case)
        results["slstm_scan_bwd"].append(case)
        del gx, r, saved, out, dy, dfin, d_gx
    # jamba's train rows: 2 x 4096 tokens of d_model 8192 (queue B item 6)
    fwd, bwd = _rms_train_cases(torch, timer, gen, (8192, 8192),
                                path="train_recurrent")
    results["rmsnorm"].append(fwd)
    results["rmsnorm_bwd"].append(bwd)
    return results


def _release(torch, device) -> None:
    """:func:`release` on the card; a garbage collection on the CPU."""
    if str(device).startswith("cuda"):
        release(torch)
    else:
        gc.collect()


def _norms_per_forward(cfg) -> int:
    """RMSNorm launches of one forward: ln1, ln2 with an FFN, q- and
    k-norm with qk-norm, and the final norm."""
    from repro_torch.models.lm import layer_specs

    n = 1
    for spec in layer_specs(cfg):
        n += 1 + (spec.ffn != "none") + 2 * (spec.kind == "a"
                                             and cfg.qk_norm)
    return n


def _launch_check(torch, device, got: dict, want: dict, what: str) -> None:
    """On the card every counter equals its expected launches (none of
    them 0); on the CPU rehearsal, where the plain versions run, every
    counter stays 0."""
    if not str(device).startswith("cuda"):
        want = {n: 0 for n in want}
    else:
        check(all(want.values()), f"{what}: a kernel of the path is "
              f"expected no launch: {want}")
    check(got == want, f"{what}: launches {got} != {want}")


def _serve_lm(torch, phase, cfg, n_req, prompt_lens, max_new, slots,
              ranges=None, device="cuda"):
    """Serve a trace of an attention-only stack through the paged
    scheduler on ``device`` (random weights from seed 0): every logit row
    finite, one paged-attention launch per attention layer and decode
    step and the RMSNorm launches of every model call, the counters set
    to 0 just before the run and read just after; with ``ranges`` one
    decode step over every slot is profiled, its device time split by
    those ranges.  Returns the launches."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import init_lm, layer_specs
    from repro_torch.serve.scheduler import Scheduler

    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    sched = Scheduler(cfg, model, num_slots=slots, block_size=16,
                      max_len=max(prompt_lens) + max_new, device=device)
    rows = [0]
    _check_finite(torch, sched.session, rows)
    reqs = build_requests(cfg, n_req, prompt_lens, max_new, seed=0)
    for r in reqs:
        sched.submit(r)
    _sync(torch, device)
    _reset_peak(torch, device)
    pa.paged_attention.launches = 0
    rn.rmsnorm.launches = 0
    results = sched.run()
    launches = {"paged_attention": pa.paged_attention.launches,
                "rmsnorm": rn.rmsnorm.launches}
    st = sched.stats.as_dict()
    peak = _peak_gib(torch, device)
    check(st["completed"] == n_req and len(results) == n_req,
          f"{phase} {cfg.name}: {st['completed']} of {n_req} requests "
          "completed")
    check(all(len(results[r.rid]) == max_new for r in reqs),
          f"{phase} {cfg.name}: a request ended short of max_new")
    attn = sum(s.kind == "a" for s in layer_specs(cfg))
    calls = st["decode_steps"] + st["prefill_chunks"]
    norms = _norms_per_forward(cfg)
    # one paged launch per attention layer and decode step, the norms of
    # every model call (a padded one-shot prefill counts as one chunk)
    _launch_check(torch, device, launches,
                  {"paged_attention": attn * st["decode_steps"],
                   "rmsnorm": norms * calls}, f"{phase} {cfg.name}")
    out = {"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
           "layers": cfg.num_layers, "params": n_params,
           "active_params": cfg.param_count(active_only=True),
           "weight_gb": sum(p.numel() * p.element_size()
                            for p in model.parameters()) / 1e9,
           "init_s": init_s, "requests": n_req, "slots": slots,
           "block_size": 16, "prompt_lens": prompt_lens,
           "max_new": max_new, "completed": st["completed"],
           "tokens_per_s": st["tokens_per_s"], "wall_s": st["wall_s"],
           "ttft_p50_s": st["ttft_p50_s"], "ttft_p99_s": st["ttft_p99_s"],
           "tpot_mean_s": st["tpot_mean_s"],
           "decode_steps": st["decode_steps"],
           "prefill_chunks": st["prefill_chunks"],
           "logit_rows_checked": rows[0], "launches": launches,
           "paged_attention_per_decode_step": attn,
           "rmsnorm_per_model_call": norms, "peak_mem_gib": peak,
           "sample": results[0][:8].tolist()}
    if ranges is not None:
        prof = _profile_decode(torch, sched, [r.prompt for r in
                                              reqs[:slots]], ranges)
        named = dict(zip(("attention", "moe_routing", "moe_products"),
                         (prof["range_ms"][r] for r in ranges)))
        named["other"] = prof["device_busy_ms"] - sum(named.values())
        prof["by_part_ms"] = named
        out["profiled_decode_step"] = prof
    emit(out)
    del model, sched
    _release(torch, device)
    return launches


def phase_serve_archs(torch, device="cuda", smoke=False):
    """serve_archs: qwen2.5-3b, codeqwen1.5-7b, granite-8b and
    musicgen-medium at FULL in bf16 through the scheduler (``smoke``: the
    SMOKE configs, for a CPU rehearsal)."""
    from repro_torch.configs.registry import get_config

    return {f"serve_archs.{a}": _serve_lm(
        torch, "serve_archs", get_config(a, smoke=smoke), device=device,
        **SERVE_ARCHS_TRAFFIC) for a in SERVE_ARCHS}


def phase_serve_moe(torch, device="cuda", smoke=False):
    """serve_moe: deepseek-moe-16b FULL and phi3.5-moe ``CUT_16L`` in bf16
    through the scheduler (MoE dropless), one decode step profiled by part:
    attention, routing, the expert products, the rest."""
    from repro_torch.configs import phi35_moe
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers, lm

    # the model's profiler ranges, in the order _serve_lm names them
    ranges = (lm.ATTENTION_RANGE, layers.MOE_ROUTE_RANGE,
              layers.MOE_EXPERTS_RANGE)
    out = {}
    for cfg in (get_config("deepseek-moe-16b", smoke=smoke),
                phi35_moe.SMOKE if smoke else phi35_moe.CUT_16L):
        out[f"serve_moe.{cfg.name}"] = _serve_lm(
            torch, "serve_moe", cfg, ranges=ranges, device=device,
            **SERVE_MOE_TRAFFIC)
    return out


@exact_f32
def phase_recompute_archs(torch, device="cuda", smoke=False):
    """Every new token arch at full width cut to 2 layers, in f32 (TF32
    off): two served requests each re-run through ``lm_forward`` (MoE
    dropless, as prefill and decode run it) must pick every served token,
    save top-2 ties within 1e-4."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Scheduler

    prompt_lens, max_new = [64, 200], 16
    report = {}
    for arch in RECOMPUTE_ARCHS:
        cfg = replace(get_config(arch, smoke=smoke), dtype="float32",
                      num_layers=2)
        model = init_lm(cfg, seed=1, device=device)
        sched = Scheduler(cfg, model, num_slots=2, block_size=16,
                          max_len=max(prompt_lens) + max_new, device=device)
        reqs = build_requests(cfg, 2, prompt_lens, max_new, seed=1)
        for r in reqs:
            sched.submit(r)
        sched.run()
        checked, ties, mismatches = _recompute_check(
            torch, model, sched, reqs, max_new, dropless=cfg.moe is not None)
        report[arch] = {"positions": checked, "ties": ties,
                        "tie_count": len(ties), "mismatches": mismatches}
        del model, sched
        _release(torch, device)
    emit({"phase": "recompute_archs", "dtype": "float32",
          "allow_tf32": False, "layers": 2, "prompt_lens": prompt_lens,
          "max_new": max_new, "moe_yardstick": "lm_forward dropless",
          **report})
    for name, r in report.items():
        check(not r["mismatches"], f"recompute_archs {name}: served tokens "
              f"differ from the f32 recompute at {len(r['mismatches'])} "
              "positions")


def _train_cut(torch, phase, arch, layers, device="cuda", smoke=False,
               batch=CUT_B, optimizer="adam", moe=True, profile=False,
               steps=CUT_STEPS):
    """Train ``arch`` at its published widths cut to ``layers`` layers in
    bf16 (seed 0), B = ``batch`` (2), S = 4096, ``optimizer`` (Adam) at lr
    1e-3 with the CLI's warmup, clip 1.0, remat full, ``steps`` (6) on
    ``launch.train``'s batches: losses and the MoE aux losses finite (and
    positive with MoE), a finite nonzero gradient on every weight the loss
    reads, the launches of every step exact (flash, RMSNorm, the scans and
    their backwards, those the stack runs; no other kernel); prints step
    time, tokens/s, peak memory, the mfu over active parameters and, with
    MoE, the share of (token, choice) pairs dropped; ``moe=False`` drops
    the experts (jamba's ``NOEXP_8L`` cut), ``profile`` profiles one more
    step by kernel group (``smoke``: the SMOKE widths, for a CPU
    rehearsal).  Returns the launches."""
    from repro_torch.configs.base import OptimizerConfig, replace
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as tl
    from repro_torch.models.lm import layer_specs
    from repro_torch.train.steps import init_lm_state, make_lm_train_step

    cfg = replace(get_config(arch, smoke=smoke), num_layers=layers,
                  **({} if moe else {"moe": None}))
    opt_cfg = OptimizerConfig(name=optimizer, lr=1e-3,
                              warmup_steps=min(100, steps // 10 + 1))
    t0 = time.perf_counter()
    state = init_lm_state(cfg, opt_cfg, seed=0, device=device)
    step_fn = make_lm_train_step(cfg, opt_cfg, remat="full")
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    model = state["model"]
    n_params = sum(p.numel() for p in model.parameters())
    active = cfg.param_count(active_only=True)
    batches = [tl.device_batch(cfg, batch, CUT_S, i, device)
               for i in range(steps)]
    specs = layer_specs(cfg)
    per = {k: sum(s.kind == k for s in specs) for k in "aMs"}
    norms = _norms_per_forward(cfg)
    # remat full: every block's forward runs twice (a scan's forward once
    # outside the graph, once in the recompute before its backward), the
    # final norm once
    expect = {"flash_attention_fwd": 2 * per["a"],
              "flash_attention_bwd": per["a"],
              "rmsnorm": 2 * norms - 1, "rmsnorm_bwd": norms,
              "mamba_scan": 2 * per["M"], "mamba_scan_bwd": per["M"],
              "slstm_scan": 2 * per["s"], "slstm_scan_bwd": per["s"]}
    expect = {n: v for n, v in expect.items() if v}
    moe_blocks = [b.ffn for b in model.blocks if b.ffn_kind == "moe"]
    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    _sync(torch, device)
    _reset_peak(torch, device)
    losses, step_s, per_step, aux, drops = [], [], [], [], []
    for i, b in enumerate(batches):
        before = {n: fn.launches for n, fn in counters.items()}
        t0 = time.perf_counter()
        _, m = step_fn(state, b)
        _sync(torch, device)
        step_s.append(time.perf_counter() - t0)
        per_step.append({n: fn.launches - before[n]
                         for n, fn in counters.items()})
        losses.append(float(m["loss"]))
        aux.append({k: float(m[k]) for k in ("ce", "moe_load_balance",
                                              "moe_z", "grad_norm")})
        if moe_blocks:
            drops.append(sum(int(b.routed[0]) for b in moe_blocks)
                         / sum(b.routed[1] for b in moe_blocks))
        if i in (0, steps - 1):
            # a vlm's token embedding is not read: the embeddings replace it
            unread = ("embed.weight",) if "embeds" in b else ()
            bad = [n for n, p in model.named_parameters() if n not in unread
                   and (p.grad is None or not bool(torch.isfinite(
                       p.grad).all()) or not bool((p.grad != 0).any()))]
            check(not bad, f"{phase} step {i}: {len(bad)} parameters "
                  f"without a nonzero finite gradient, e.g. {bad[:5]}")
    launches = {n: fn.launches for n, fn in counters.items()
                if n in expect}
    off_path = {n: fn.launches for n, fn in counters.items()
                if n not in expect and fn.launches}
    peak = _peak_gib(torch, device)
    t0 = time.perf_counter()
    prof = _profile(torch, lambda: step_fn(state, batches[0])) \
        if profile and str(device).startswith("cuda") else None
    profile_s = time.perf_counter() - t0
    check(not off_path, f"{phase}: kernels off the path launched: "
          f"{off_path}")
    check(all(map(math.isfinite, losses)) and all(
        math.isfinite(v) for a in aux for v in a.values()),
        f"{phase}: non-finite loss or metric: {losses} {aux}")
    if moe_blocks:
        check(all(a["moe_load_balance"] > 0 and a["moe_z"] > 0
                  for a in aux), f"{phase}: aux losses not positive: {aux}")
    for i, got in enumerate(per_step):
        _launch_check(torch, device, {n: got[n] for n in expect}, expect,
                      f"{phase} step {i}")
    step = statistics.median(step_s[-4:] if steps > 4 else step_s[1:])
    tokens = batch * CUT_S
    attn_flops = 2 * batch * cfg.num_heads * CUT_S ** 2 \
        * cfg.resolved_head_dim
    model_flops = 6 * active * tokens + 3 * attn_flops * per["a"]
    stats = {"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
             "layers": layers,
             "cut_from_layers": get_config(arch, smoke=smoke).num_layers,
             "params": n_params, "active_params": active,
             "batch": batch, "seq": CUT_S, "steps": steps,
             "optimizer": optimizer, "lr": opt_cfg.lr, "remat": "full",
             "init_s": init_s, "losses": losses, "metrics": aux,
             "step_s": step_s, "step_ms": step * 1e3,
             "tokens_per_s": tokens / step, "peak_mem_gib": peak,
             "mfu_active": model_flops / step / PEAK_OPS_PER_S["bfloat16"],
             "mfu_counts": "6 * active params * tokens + causal attention "
                           "x3, over 989 TFLOP/s bf16",
             "model_flops_per_step": model_flops,
             "dropped_pair_share": drops or None,
             "launches": launches, "launches_per_step": per_step[-1],
             "expected_per_step": expect, "profiled_step": prof,
             "profile_s": profile_s if prof else None}
    emit(stats)
    del state, model, batches, step_fn
    _release(torch, device)
    return launches


def phase_train_moe(torch, device="cuda", smoke=False):
    """train_moe: deepseek-moe-16b at full width, 1 dense + 3 MoE layers
    (capacity dispatch, aux losses in the loss)."""
    return _train_cut(torch, "train_moe", *CUT_TRAIN["train_moe"],
                      device=device, smoke=smoke)


@exact_f32
def _vlm_parity(torch, device="cuda", smoke=False):
    """qwen2-vl-7b at full width, 2 layers, f32 (TF32 off): the logits of
    one forward over ``train_batch``'s embeddings and M-RoPE positions at
    S = 256 on the card against the same weights on the CPU."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as tl
    from repro_torch.models.lm import LM, init_lm, lm_forward

    cfg = replace(get_config("qwen2-vl-7b", smoke=smoke), dtype="float32",
                  num_layers=2)
    model = init_lm(cfg, seed=0, device=device)
    with torch.device("cpu"):
        cpu_model = LM(cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    batch = tl.device_batch(cfg, 1, VLM_PARITY_S, 0, device)
    with torch.no_grad():
        got = lm_forward(model, None, embeds=batch["embeds"],
                         positions=batch["positions"]).cpu()
        want = lm_forward(cpu_model.eval(), None,
                          embeds=batch["embeds"].cpu(),
                          positions=batch["positions"].cpu())
    ok, err = _within(got, want, VLM_PARITY_TOL)
    out = {"layers": 2, "seq": VLM_PARITY_S, "dtype": "float32",
           "max_abs_err": err, "tol": VLM_PARITY_TOL,
           "finite": bool(torch.isfinite(got).all())}
    check(ok and out["finite"], f"train_vlm: card logits differ from the "
          f"CPU's by {err} (tolerance {VLM_PARITY_TOL})")
    del model, cpu_model
    return out


def phase_train_vlm(torch, device="cuda", smoke=False):
    """train_vlm: qwen2-vl-7b at full width, 8 of 28 layers, on the stub
    frontend's embeddings and M-RoPE positions (flash at 7 query heads a
    KV head), then the card-against-CPU forward check."""
    launches = _train_cut(torch, "train_vlm", *CUT_TRAIN["train_vlm"],
                          device=device, smoke=smoke)
    emit({"phase": "train_vlm_parity", **_vlm_parity(torch, device, smoke)})
    _release(torch, device)
    return launches


def phase_train_recurrent(torch, device="cuda", smoke=False):
    """train_recurrent: xlstm-125m FULL and jamba ``NOEXP_8L`` trained
    through the scans' backward kernels (``_train_cut``, one profiled step
    each), then each stack's f32 parity of the card against the CPU.
    Returns the launches."""
    from repro_torch.configs.registry import get_config

    launches = {}
    for name, arch, batch, optimizer in TRAIN_RECURRENT:
        layers = 8 if name == "jamba" else get_config(arch).num_layers
        launches[name] = _train_cut(
            torch, f"train_recurrent.{name}", arch, layers, device=device,
            smoke=smoke, batch=batch, optimizer=optimizer, moe=False,
            profile=True, steps=TRAIN_RECURRENT_STEPS)
    for name, arch, _, _ in TRAIN_RECURRENT:
        _recurrent_parity(torch, f"train_recurrent.{name}_parity", arch,
                          *RECURRENT_PARITY[name], device, smoke)
        _release(torch, device)
    return {f"train_recurrent.{k}": v for k, v in launches.items()}


def _rel(got, want) -> float:
    """``max |got - want|`` over ``max |want|``."""
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


@exact_f32
def _recurrent_parity(torch, phase, arch, layers, witness, device="cuda",
                      smoke=False):
    """``arch`` at full width cut to ``layers`` layers (no experts), f32
    (TF32 off), B = 1, S = ``RECURRENT_PARITY_S``: ``lm_loss`` and every
    gradient on the card (the kernels) against the same weights on the
    CPU (the plain versions), the loss to ``PARITY_TOL["loss_rel"]`` of
    itself and each gradient to ``PARITY_TOL["grad_rel"]`` of its largest
    entry, or, with the conditioning ``witness``, within ``FLOOR_X`` times
    the step's f32 floor (``RECURRENT_PARITY``)."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as tl
    from repro_torch.models.lm import LM, init_lm, layer_specs, lm_loss

    cfg = replace(get_config(arch, smoke=smoke), dtype="float32",
                  num_layers=layers, moe=None)
    model = init_lm(cfg, seed=0, device=device).train()
    batch = tl.device_batch(cfg, 1, RECURRENT_PARITY_S, 0, device)
    t0 = time.perf_counter()
    loss, _ = lm_loss(model, batch)
    loss.backward()
    _sync(torch, device)
    card_s = time.perf_counter() - t0
    got = {n: p.grad.cpu() for n, p in model.named_parameters()}
    weights = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    cpu_batch = {k: v.cpu() for k, v in batch.items()}

    def on_cpu(embed_eps=0.0):
        state = dict(weights)
        if embed_eps:
            e = weights["embed.weight"]
            noise = torch.randn(e.shape, generator=torch.Generator()
                                .manual_seed(5))
            state["embed.weight"] = e * (1 + embed_eps * noise)
        # built on "meta" and handed the card's weights (no CPU init of
        # jamba's 3.1 B weights only to overwrite them)
        with torch.device("meta"):
            m = LM(cfg)
        m.load_state_dict(state, assign=True)
        m.train()
        t0 = time.perf_counter()
        value, _ = lm_loss(m, cpu_batch)
        value.backward()
        grads = {n: p.grad for n, p in m.named_parameters()}
        return value.item(), grads, time.perf_counter() - t0

    want_loss, want, cpu_s = on_cpu()
    loss_rel = abs(loss.item() - want_loss) / abs(want_loss)
    rel = {n: _rel(got[n], want[n]) for n in want}
    out = {"arch": cfg.name, "layers": layers,
           "kinds": "".join(s.kind for s in layer_specs(cfg)),
           "dtype": "float32", "allow_tf32": False, "batch": 1,
           "seq": RECURRENT_PARITY_S, "loss_card": loss.item(),
           "loss_cpu": want_loss, "loss_rel_err": loss_rel,
           "grad_rel_err": max(rel.values()),
           "worst_grad": max(rel, key=rel.get), "card_s": card_s,
           "cpu_s": cpu_s,
           "tol": {k: PARITY_TOL[k] for k in ("loss_rel", "grad_rel")}}
    tol = PARITY_TOL["grad_rel"]
    if witness:
        _, moved, _ = on_cpu(FLOOR_EPS)
        floor = max(_rel(moved[n], want[n]) for n in want)
        tol = max(tol, FLOOR_X * floor)
        out.update(f32_floor=floor, floor_eps=FLOOR_EPS, floor_x=FLOOR_X,
                   over_grad_rel={n: r for n, r in rel.items()
                                  if r > PARITY_TOL["grad_rel"]})
    out["grad_tol"] = tol
    bad = {n: r for n, r in rel.items() if r > tol}
    emit({"phase": phase, **out})
    check(loss_rel <= PARITY_TOL["loss_rel"] and math.isfinite(loss_rel),
          f"{arch} parity: loss rel err {loss_rel}")
    check(not bad, f"{arch} parity: gradients past tolerance: {bad}")
    return out


def phase_ltfb_recurrent(torch, workdir, device="cuda", smoke=False):
    """ltfb_recurrent: the ltfb CLI over xlstm-125m as a user calls it,
    with ``--ckpt-dir``, then a rerun that resumes under ``--log-json``
    (each step timed by wrapping the CLI's trainer step).  Returns the
    launches."""
    import re

    from repro_torch.launch import ltfb as lt
    from repro_torch.telemetry import enable_json_logs

    step_ms = []
    build_fns = lt.build_fns

    def timed_fns(args):
        fns = build_fns(args)

        def train_step(*a, **kw):
            t0 = time.perf_counter()
            out = fns.train_step(*a, **kw)
            _sync(torch, device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return dataclasses.replace(fns, train_step=train_step)

    argv = LTFB_RECURRENT_ARGS + [
        "--device", device, "--ckpt-dir", os.path.join(workdir, "rec_pop"),
        "--data-dir", os.path.join(workdir, "rec_data")]
    if smoke:
        argv += ["--smoke", "--seq", "64"]
    number = re.compile(r"\b(?:best_val|speedup|ckpt_s|tournament_s)="
                        r"([^\s,x]+)")
    lt.build_fns = timed_fns
    try:
        first = _run_cli(torch, lt.main, argv, "[ltfb]", number)
        steps_first = len(step_ms)
        # the rerun resumes and trains a round without saving it, under
        # --log-json: one JSON record a line (the switch is global, so it
        # goes off again after)
        rerun = _run_cli(torch, lt.main, argv + ["--ckpt-every", "0",
                                                 "--log-json"], "",
                         re.compile(r'"(?:best_val|speedup)": ([^\s,}]+)'))
    finally:
        lt.build_fns = build_fns
        enable_json_logs(False)
    cuda = str(device).startswith("cuda")
    runs = {"first": first, "rerun": rerun}
    for what, run in runs.items():
        check(run["rc"] == 0 and run["values"]
              and all(map(math.isfinite, run["values"])),
              f"ltfb_recurrent {what}: rc={run['rc']} {run['lines'][-6:]}")
        on = ("slstm_scan", "slstm_scan_bwd", "rmsnorm", "rmsnorm_bwd")
        check(all(bool(run["launches"][n]) == cuda for n in on),
              f"ltfb_recurrent {what}: launches {run['launches']}")
    events = _json_events(rerun["lines"])
    resumed = [json.loads(ln) for ln in rerun["lines"]
               if '"event": "ltfb_resumed"' in ln]
    check(events is not None and events.count("ltfb_round") == 1
          and [r.get("round") for r in resumed] == [1],
          f"ltfb_recurrent: the rerun did not resume under --log-json: "
          f"{events}")
    ckpt_s = [float(m) for run in runs.values() for ln in run["lines"]
              if ln.startswith("[ltfb] tournament:")
              for m in re.findall(r"ckpt_s=([0-9.]+)", ln)]
    emit({"phase": "ltfb_recurrent", "argv": argv,
          "step_ms": step_ms, "steps_first_run": steps_first,
          "step_ms_median": statistics.median(step_ms) if step_ms else None,
          "ckpt_s": ckpt_s, "wall_s": {k: r["s"] for k, r in runs.items()},
          "launches": {k: r["launches"] for k, r in runs.items()},
          "lines": {k: r["lines"] for k, r in runs.items()}})
    return {n: sum(run["launches"][n] for run in runs.values())
            for n in first["launches"]
            if any(run["launches"][n] for run in runs.values())}


# ---------------------------------------------------------------------------
# population speculative decoding: drafter sessions, the fused draft, the
# K-token verify, rollback over recurrent state, load_draft
# ---------------------------------------------------------------------------

# the verify shapes of the paged kernel: (H, Hkv, K, dtype) at D = 128 for
# qwen2.5-3b (g = 8; K = 8 fills the kernel's 64 rows) and qwen3-0.6b
SPEC_VERIFY = ((16, 2, 5, "bfloat16"), (16, 2, 8, "bfloat16"),
               (16, 8, 5, "bfloat16"), (16, 8, 5, "float32"))
# spec_arch: qwen2.5-3b FULL in bf16, 16 requests over 8 slots (two
# waves: the second decodes in the rows and pages the first freed), the
# first 8 admitted in one step (``admit``, the scheduler's
# ``max_prefills_per_step``; 1 where not given) so that the profiled round
# has every slot busy, prompts 128/256/512, 16 new tokens (64 before the
# fifteenth slice cut them for time), greedy, 4 draft tokens a round
SPEC_ARCH_TRAFFIC = dict(n_req=16, prompt_lens=[128, 256, 512], max_new=16,
                         slots=8, admit=8)
# spec_pop: qwen3-0.6b FULL in f32 (TF32 off) from the LM tournament's
# winners, 8 requests over 4 slots (two waves), prompts 128/256, 8 new
# tokens (32 before the fifteenth slice cut them for time)
SPEC_POP_TRAFFIC = dict(n_req=8, prompt_lens=[128, 256], max_new=8, slots=4)
# spec_recurrent: xlstm-125m FULL in f32, 4 requests over 4 slots, prompts
# 100/300; jamba NOEXP_8L in bf16, 8 requests over 8 slots admitted in one
# step (its self-drafter round is profiled), prompts 100/300/500; 32 new
# tokens
SPEC_XLSTM_TRAFFIC = dict(n_req=4, prompt_lens=[100, 300], max_new=32,
                          slots=4)
SPEC_HYBRID_TRAFFIC = dict(n_req=8, prompt_lens=[100, 300, 500], max_new=32,
                           slots=8, admit=8)
SPEC_K = 4
# token identity: in f32 (TF32 off) a speculative stream may part from the
# target-only one only where the target-only sampling objective (the
# logits, or logits / T + the Gumbel draw) has a top-2 tie within 1e-4, as
# phase_recompute allows.  In bf16 the verify's logits are not the decode's
# bit for bit (its matmuls take B (K+1) rows, the paged kernel another
# split plan), so a parting is allowed where the target-only top-2 gap is
# below 0.25: bf16 keeps 8 bits, so a logit near 8-16 moves by 0.0625 an
# ulp, and 36 layers of bf16 rounding move it by a few.  After the first
# parting the two streams are no longer comparable
SPEC_TIE = {"float32": 1e-4, "bfloat16": 0.25}
# the profiled round: the steady batch, every slot busy (a run that
# profiles admits a whole batch in its first step, and a request lasts
# more than two rounds; ``_spec_run`` checks the round's rows)
SPEC_PROFILE_ROUND = 2


def _count_calls(sched) -> dict:
    """Wrap a scheduler's sessions so that every model call is counted by
    session and kind: the target's prefills, prefill chunks and steps
    (verify, replay or plain decode), the drafter's prefills, steps
    (sequential draft or replay) and fused rounds with their steps."""
    calls = dict.fromkeys(("t_prefill", "t_chunk", "t_step", "d_prefill",
                           "d_step", "d_block", "d_block_steps"), 0)

    def wrap(obj, name, key):
        fn = getattr(obj, name)

        def run(*a, **kw):
            calls[key] += 1
            if name == "draft_block":
                calls["d_block_steps"] += a[2] if len(a) > 2 \
                    else kw["steps"]
            return fn(*a, **kw)
        setattr(obj, name, run)

    wrap(sched.session, "prefill", "t_prefill")
    wrap(sched.session, "prefill_chunk", "t_chunk")
    wrap(sched.session, "step", "t_step")
    if sched.draft is not None:
        wrap(sched.draft, "prefill", "d_prefill")
        wrap(sched.draft, "step", "d_step")
        wrap(sched.draft, "draft_block", "d_block")
    return calls


def _record_gaps(sched, gaps: dict) -> None:
    """Record, for every token the scheduler samples, the top-2 gap of its
    sampling objective (the logits at temperature 0, else logits / T plus
    the request's Gumbel draw) under ``(rid, ntok)``."""
    import numpy as np

    sample = sched._sample

    def recorded(row, req, ntok):
        tok = sample(row, req, ntok)
        obj = np.asarray(row, np.float64)
        if req.temperature > 0:
            obj = obj / req.temperature + np.random.default_rng(
                [req.seed, req.ntok_base + ntok]).gumbel(size=obj.shape[-1])
        top2 = np.partition(obj, -2)[-2:]
        gaps[(req.rid, ntok)] = float(top2[1] - top2[0])
        return tok
    sched._sample = recorded


def _profile_round(torch, sched, n: int, out: dict) -> None:
    """Run the scheduler's ``n``-th decode round (speculative or plain)
    under the profiler, its device time split by ``SPEC_RANGES``."""
    from repro_torch.serve.scheduler import SPEC_RANGES

    name = "_spec_round" if sched.spec_tokens > 0 else "_decode_round"
    fn, seen = getattr(sched, name), [0]

    def run():
        seen[0] += 1
        if seen[0] != n:
            return fn()
        out.update(_profile(torch, fn, SPEC_RANGES), round=n,
                   rows=len(sched.active))
    setattr(sched, name, run)


def _partings(base: dict, spec: dict, gaps: dict, tol: float) -> list:
    """Per request, the first position where ``spec``'s tokens part from
    ``base``'s (the target-only run), with the target-only top-2 gap
    there and whether it is a tie within ``tol``."""
    out = []
    for rid, want in base.items():
        got = spec[rid]
        i = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b),
                 None)
        if i is None and len(want) == len(got):
            continue
        i = min(len(want), len(got)) if i is None else i
        gap = gaps.get((rid, i))
        out.append({"rid": rid, "pos": i, "gap": gap,
                    "tie": gap is not None and gap < tol})
    return out


def _call_launches(cfg, dcfg, c, drafted: bool) -> dict:
    """The kernel launches of the model calls ``c`` (:func:`_count_calls`)
    of a target of ``cfg`` and, when ``drafted``, a drafter of ``dcfg``:
    per verify, replay or plain step one paged launch per attention layer
    of that session, per fused round ``Kv`` per drafter attention layer,
    the RMSNorm launches of every forward, a scan per recurrent layer and
    prefill."""
    from repro_torch.models.lm import layer_specs

    def per(cf, kinds):
        return sum(s.kind in kinds for s in layer_specs(cf))

    d_fwd = c["d_step"] + c["d_block_steps"]
    return {"paged_attention": per(cfg, "a") * c["t_step"]
            + per(dcfg, "a") * d_fwd * drafted,
            "rmsnorm": _norms_per_forward(cfg) * (
                c["t_prefill"] + c["t_chunk"] + c["t_step"])
            + _norms_per_forward(dcfg) * (c["d_prefill"] + d_fwd) * drafted,
            "mamba_scan": per(cfg, "M") * c["t_prefill"]
            + per(dcfg, "M") * c["d_prefill"] * drafted,
            "slstm_scan": per(cfg, "s") * c["t_prefill"]
            + per(dcfg, "s") * c["d_prefill"] * drafted}


def _spec_run(torch, what, cfg, model, traffic, device, draft=None, k=0,
              draft_cfg=None, fused=True, adapt=False, temperature=0.0,
              gaps=None, profile=False):
    """Serve one trace through ``Scheduler`` (a drafter when ``draft``):
    every target logit row finite, every kernel counter (set to 0 just
    before the run, read just after) equal to the launches of the model
    calls the run made -- per verify, replay or plain step one paged
    launch per attention layer of that session, per fused round ``Kv``
    per drafter attention layer, the RMSNorm launches of every forward,
    a scan per recurrent layer and prefill -- and those calls to the
    spec counters.  Returns the run's record (tokens under ``tokens``)."""
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import layer_specs
    from repro_torch.serve.scheduler import Scheduler

    n_req, lens, max_new, slots = (traffic[k_] for k_ in (
        "n_req", "prompt_lens", "max_new", "slots"))
    sched = Scheduler(cfg, model, num_slots=slots, block_size=16,
                      max_len=max(lens) + max_new, draft_params=draft,
                      spec_tokens=k, draft_cfg=draft_cfg, spec_fused=fused,
                      spec_adapt=adapt, device=device,
                      max_prefills_per_step=traffic.get("admit", 1))
    calls = _count_calls(sched)
    # admissions made after a request finished: into a freed slot (the
    # target's and the drafter's rows and pages, a new spec_adapt depth)
    reused = [0]
    admit = sched._admit

    def admitted(req):
        reused[0] += sched.stats.completed > 0
        return admit(req)
    sched._admit = admitted
    rows = [0]
    _check_finite(torch, sched.session, rows)
    if gaps is not None:
        _record_gaps(sched, gaps)
    prof = {}
    if profile:
        _profile_round(torch, sched, SPEC_PROFILE_ROUND, prof)
    for r in build_requests(cfg, n_req, lens, max_new,
                            temperature=temperature, seed=0):
        sched.submit(r)
    counters = _all_counters()
    _sync(torch, device)
    _reset_peak(torch, device)
    for fn in counters.values():
        fn.launches = 0
    results = sched.run()
    _sync(torch, device)
    got = {n: fn.launches for n, fn in counters.items()}
    st = sched.stats.as_dict()
    check(st["completed"] == n_req and all(
        len(v) == max_new for v in results.values()),
        f"{what}: {st['completed']} of {n_req} requests completed in full")
    check(reused[0] >= n_req - slots,
          f"{what}: {reused[0]} admissions into a freed slot, "
          f"{n_req - slots} requests over the {slots} slots")
    check(not profile or prof.get("rows") == slots,
          f"{what}: the profiled round {SPEC_PROFILE_ROUND} ran with "
          f"{prof.get('rows')} of {slots} rows")
    dcfg = draft_cfg or cfg

    def per(c, kinds):
        return sum(s.kind in kinds for s in layer_specs(c))

    c = calls
    want = _call_launches(cfg, dcfg, c, draft is not None)
    on_path = {n for n, kinds in (("paged_attention", "a"),
                                  ("rmsnorm", "aMms"), ("mamba_scan", "M"),
                                  ("slstm_scan", "s"))
               if per(cfg, kinds) or (draft is not None and per(dcfg, kinds))}
    _launch_check(torch, device, {n: got[n] for n in on_path},
                  {n: want[n] for n in on_path}, what)
    check(not any(got[n] for n in got if n not in on_path)
          or not str(device).startswith("cuda"),
          f"{what}: a kernel off the path launched: {got}")
    if k > 0:
        check(c["t_step"] + c["d_step"] == st["spec_rounds"]
              + st["spec_replays"] + (0 if fused else st["spec_draft_steps"]),
              f"{what}: model steps {c} against the spec counters {st}")
        if fused:
            check(c["d_block"] == st["spec_rounds"] == st["spec_draft_steps"],
                  f"{what}: fused rounds {c['d_block']}, spec_rounds "
                  f"{st['spec_rounds']}, draft steps {st['spec_draft_steps']}")
        else:
            check(st["spec_draft_steps"] > k * st["spec_rounds"],
                  f"{what}: sequential draft steps {st['spec_draft_steps']} "
                  f"<= {k} x {st['spec_rounds']} rounds")
        check(c["d_prefill"] == n_req, f"{what}: drafter prefills {c}")
    else:
        check(c["t_step"] == st["decode_steps"], f"{what}: steps {c}")
    rec = {"run": what, "spec_tokens": k, "fused": fused, "adapt": adapt,
           "temperature": temperature, "completed": st["completed"],
           "tokens_per_s": st["tokens_per_s"], "wall_s": st["wall_s"],
           "ttft_p50_s": st["ttft_p50_s"], "ttft_p99_s": st["ttft_p99_s"],
           "tpot_mean_s": st["tpot_mean_s"],
           "decode_steps": st["decode_steps"],
           **{n: st[n] for n in ("spec_rounds", "spec_draft_steps",
                                 "spec_draft_proposed", "spec_draft_accepted",
                                 "spec_accept_rate", "spec_replays",
                                 "spec_k_mean")},
           "admitted_into_freed_slot": reused[0],
           "model_calls": dict(c), "launches": {n: got[n] for n in on_path},
           "logit_rows_checked": rows[0], "peak_mem_gib":
           _peak_gib(torch, device)}
    if adapt:
        rec["spec_k_by_rid"] = {str(r): v
                                for r, v in sched.spec_k_by_rid.items()}
    if profile:
        rec["profiled_round"] = prof
    rec["tokens"] = {rid: v.tolist() for rid, v in results.items()}
    rec["sched"] = sched
    return rec


def _spec_compare(what, base, run, gaps, dtype) -> dict:
    """Hold a speculative run to the target-only one: token-identical save
    top-2 ties within ``SPEC_TIE[dtype]`` where a request's streams first
    part; fills the run's record and returns it."""
    parts = _partings(base["tokens"], run["tokens"], gaps, SPEC_TIE[dtype])
    run["partings"] = parts
    run["parting_count"] = len(parts)
    run["identical_requests"] = len(base["tokens"]) - len(parts)
    check(all(p["tie"] for p in parts),
          f"{what} {run['run']}: tokens part from target-only decoding away "
          f"from a top-2 tie (tolerance {SPEC_TIE[dtype]}): "
          f"{[p for p in parts if not p['tie']][:4]}")
    return run


def _emit_runs(phase, cfg, runs, **extra) -> dict:
    """One JSON line for a phase part: its runs without the schedulers and
    token streams (a sample of request 0 kept); returns the launches
    summed over the runs."""
    total = {}
    out = []
    for r in runs:
        for n, v in r["launches"].items():
            total[n] = total.get(n, 0) + v
        out.append({k: v for k, v in r.items()
                    if k not in ("sched", "tokens")}
                   | {"sample": r["tokens"][0][:8]})
    emit({"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
          "layers": cfg.num_layers, **extra, "runs": out})
    return total


def _add(total: dict, more: dict) -> None:
    for n, v in more.items():
        total[n] = total.get(n, 0) + v


def _spec_kernel_checks(torch):
    """The paged kernel at the verify shapes against its plain version, as
    phase 3 times it: lengths 114-499 and the split edges of a 36-page
    table, qwen2.5-3b's g = 8 at K = 5 and 8 (40 and 64 rows) and
    qwen3-0.6b's g = 2 at K = 5 in bf16 and f32."""
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    lengths = torch.randint(114, 500, (8,), generator=gen,
                            device="cuda").tolist()
    cases = []
    for H, Hkv, K, dtype in SPEC_VERIFY:
        cases.append(_paged_check(torch, timer, gen, 8, H, Hkv, 128, 16, K,
                                  dtype, lengths))
        cases.append(_paged_check(
            torch, timer, gen, 8, H, Hkv, 128, 16, K, dtype,
            _split_edge_lengths(torch, 8, Hkv, 36, 16, K), 36))
    del timer
    release(torch)
    return cases


def _spec_arch(torch, device, smoke):
    """spec_arch: qwen2.5-3b FULL in bf16 target-only, with a self
    drafter and with a qwen3-0.6b FULL drafter (``draft_cfg``); one plain
    decode round and one speculative round profiled."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm

    cfg = get_config("qwen2.5-3b", smoke=smoke)
    dcfg = get_config("qwen3-0.6b", smoke=smoke)
    if smoke:
        dcfg = replace(dcfg, vocab_size=cfg.vocab_size)
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    gaps = {}
    tr = SPEC_ARCH_TRAFFIC
    base = _spec_run(torch, "target_only", cfg, model, tr, device,
                     gaps=gaps, profile=True)
    runs = [base]
    runs.append(_spec_compare("spec_arch", base, _spec_run(
        torch, "self_drafter", cfg, model, tr, device, draft=model,
        k=SPEC_K, profile=True), gaps, cfg.dtype))
    drafter = init_lm(dcfg, seed=1, device=device)
    runs.append(_spec_compare("spec_arch", base, _spec_run(
        torch, "qwen3_drafter", cfg, model, tr, device, draft=drafter,
        draft_cfg=dcfg, k=SPEC_K), gaps, cfg.dtype))
    total = _emit_runs("serve_spec.spec_arch", cfg, runs,
                       draft_arch=dcfg.name, init_s=init_s,
                       weight_gb=sum(p.numel() * p.element_size()
                                     for p in model.parameters()) / 1e9,
                       tie_tolerance=SPEC_TIE[cfg.dtype], **tr)
    del model, drafter, runs, base
    _release(torch, device)
    return total


@exact_f32
def _spec_pop(torch, pop, device, smoke):
    """spec_pop: the LM tournament's latest winner serves in f32 (TF32
    off), its earliest winner drafts (``load_draft``): fused, sequential,
    at temperature 0.8 and with ``spec_adapt``, each against target-only
    decoding; then the serve CLI with ``--draft-ckpt``."""
    import re

    from repro_torch.launch import serve
    from repro_torch.models.lm import init_lm
    from repro_torch.serve import registry as reg

    cfg = _pop_cfg(smoke, dtype="float32")
    model = init_lm(cfg, seed=0, device=device)
    # the template on the card in the population's dtype: each restored
    # leaf goes straight there (the sixteenth slice's cut: 7-8 s a load
    # through a host f32 template)
    like, from_ckpt, _ = _pop_hooks(torch, cfg, smoke, device)
    registry = reg.ModelRegistry(pop, like, from_ckpt=from_ckpt)
    model.load_state_dict(registry.load())
    # round 1's winner: the earliest (its trainer files were pruned, so
    # the directory's earliest population step is round 2's)
    first = min(int(m.group(1)) for f in os.listdir(pop)
                if (m := re.match(r"^winner_step_(\d+)\.ckpt$", f)))
    drafter = init_lm(cfg, seed=1, device=device)
    t0 = time.perf_counter()
    dparams, dinfo = reg.load_draft(pop, like, step=first,
                                    expect_vocab=cfg.vocab_size,
                                    from_ckpt=from_ckpt)
    load_s = time.perf_counter() - t0
    drafter.load_state_dict(dparams)
    del dparams
    tr = SPEC_POP_TRAFFIC
    # the greedy and the T = 0.8 target-only runs record their gaps apart
    # (the rids repeat)
    gaps, gaps_t = {}, {}
    base = _spec_run(torch, "target_only", cfg, model, tr, device, gaps=gaps)
    base_t = _spec_run(torch, "target_only_t0.8", cfg, model, tr, device,
                       temperature=0.8, gaps=gaps_t)
    runs = [base, base_t]
    for what, kw, ref, g in (
            ("fused", {}, base, gaps),
            ("sequential", {"fused": False}, base, gaps),
            ("fused_t0.8", {"temperature": 0.8}, base_t, gaps_t),
            ("adapt", {"adapt": True}, base, gaps)):
        runs.append(_spec_compare("spec_pop", ref, _spec_run(
            torch, what, cfg, model, tr, device, draft=drafter, k=SPEC_K,
            **kw), g, cfg.dtype))
    total = _emit_runs("serve_spec.spec_pop", cfg, runs,
                       served_step=registry.step,
                       draft_step=dinfo.get("step"), draft_load_s=load_s,
                       tie_tolerance=SPEC_TIE[cfg.dtype], **tr)
    del runs, base, base_t, model, drafter
    _release(torch, device)
    size = ["--smoke"] if smoke else []
    cli = _run_cli(torch, serve.main, [
        "--arch", "qwen3-0.6b", "--ckpt-dir", pop, "--draft-ckpt", pop,
        "--spec-tokens", "3", "--spec-adapt", "--requests", "4", "--device",
        device, *size, *_pop_flags(smoke)], "[serve]",
        re.compile(r"([\d.]+) tok/s"))
    return total, cli


def _spec_recurrent(torch, device, smoke):
    """spec_recurrent: xlstm-125m FULL in f32 (TF32 off) with a self and a
    fresh-seed drafter, exact save ties; jamba NOEXP_8L in bf16 with a
    self drafter under the bf16 parting rule, its snapshot timed."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.jamba_15_large import NOEXP_8L
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm

    total = {}

    @exact_f32
    def xlstm(torch):
        cfg = replace(get_config("xlstm-125m", smoke=smoke), dtype="float32")
        model = init_lm(cfg, seed=0, device=device)
        fresh = init_lm(cfg, seed=7, device=device)
        tr, gaps = SPEC_XLSTM_TRAFFIC, {}
        base = _spec_run(torch, "target_only", cfg, model, tr, device,
                         gaps=gaps)
        runs = [base] + [_spec_compare("spec_recurrent.xlstm", base,
                                       _spec_run(torch, what, cfg, model,
                                                 tr, device, draft=d,
                                                 k=SPEC_K), gaps, cfg.dtype)
                         for what, d in (("self_drafter", model),
                                         ("fresh_drafter", fresh))]
        check(runs[2]["spec_replays"] > 0,
              "spec_recurrent.xlstm: a fresh-seed drafter made no replay")
        return _emit_runs("serve_spec.spec_recurrent", cfg, runs,
                          tie_tolerance=SPEC_TIE[cfg.dtype], **tr)

    _add(total, xlstm(torch))
    _release(torch, device)
    cfg = replace(get_config("jamba-1.5-large-398b", smoke=True), moe=None) \
        if smoke else NOEXP_8L
    model = init_lm(cfg, seed=0, device=device)
    tr, gaps = SPEC_HYBRID_TRAFFIC, {}
    base = _spec_run(torch, "target_only", cfg, model, tr, device, gaps=gaps)
    run = _spec_compare("spec_recurrent.jamba", base, _spec_run(
        torch, "self_drafter", cfg, model, tr, device, draft=model, k=SPEC_K,
        profile=True), gaps, cfg.dtype)
    sess = run["sched"].session
    snap_bytes = sum(t.numel() * t.element_size() for t in sess.snapshot())
    if str(device).startswith("cuda"):
        timer = Timer(torch)
        snap_ms = timer.ms(sess.snapshot)
        del timer
    else:
        snap_ms = None
    b_ms, b_by = bound(2 * snap_bytes, 0, "bfloat16")
    _add(total, _emit_runs("serve_spec.spec_recurrent", cfg, [base, run],
                           tie_tolerance=SPEC_TIE[cfg.dtype],
                           snapshot_bytes=snap_bytes, snapshot_ms=snap_ms,
                           snapshot_bound_ms=b_ms, snapshot_bound_by=b_by,
                           **tr))
    del model, base, run, sess
    _release(torch, device)
    return total


def phase_serve_spec(torch, pop, device="cuda", smoke=False):
    """serve_spec: population speculative decoding.  The paged kernel at
    the verify shapes (on the card), spec_arch, spec_pop over the LM
    tournament's population ``pop`` and spec_recurrent.  Returns (the
    launches of every exactly counted run, the kernel cases)."""
    cases = _spec_kernel_checks(torch) if str(device).startswith("cuda") \
        else []
    total = _spec_arch(torch, device, smoke)
    pop_total, cli = _spec_pop(torch, pop, device, smoke)
    _release(torch, device)
    _add(total, pop_total)
    cuda = str(device).startswith("cuda")
    emit({"phase": "serve_spec.cli", **{k: v for k, v in cli.items()
                                        if k != "lines"},
          "lines": cli["lines"][-8:]})
    check(cli["rc"] == 0 and cli["values"]
          and all(map(math.isfinite, cli["values"]))
          and any(ln.startswith("[serve] speculative:")
                  for ln in cli["lines"])
          and any(ln.startswith("[serve] drafter:") for ln in cli["lines"]),
          f"serve_spec: the serve CLI with a drafter: rc={cli['rc']} "
          f"{cli['lines'][-8:]}")
    check(any(cli["launches"].values()) == cuda,
          f"serve_spec: the CLI's launches {cli['launches']}")
    _add(total, _spec_recurrent(torch, device, smoke))
    return total, cases


# ---------------------------------------------------------------------------
# the thirteenth slice: dense slot rows, the batch engine, remat dots
# ---------------------------------------------------------------------------

# the end-to-end figures serve_dense prints beside the paged serve phase's
SERVE_FIGURES = ("tokens_per_s", "ttft_p50_s", "ttft_p99_s", "tpot_mean_s",
                 "wall_s", "decode_steps")
# serve_dense: the serve phase's traffic over dense rows (max_len 576),
# then one long prompt on a one-slot pool (flash in its prefill)
DENSE_TRAFFIC = dict(n_req=16, prompt_lens=[128, 256, 512], max_new=64,
                     slots=8)
DENSE_LONG = dict(n_req=1, prompt_lens=[4096], max_new=32, slots=1)
DENSE_SMOKE_TRAFFIC = dict(n_req=6, prompt_lens=[8, 20], max_new=6,
                           slots=4)
# recompute_dense: uniform prompts (the engine takes one uniform batch)
DENSE_F32 = (("qwen3-0.6b", 8, 128, 64), ("xlstm-125m", 4, 128, 64))
DENSE_F32_SMOKE = (("qwen3-0.6b", 4, 12, 8), ("xlstm-125m", 2, 12, 8))
# train_remat: the train cell's batch, 4 steps a policy from one seed
# (the step time is the median of the last 3: one warm step alone varied
# by 20% between two runs)
REMAT_POLICIES = ("full", "dots", "dots_no_batch")
REMAT_STEPS = 4


def _dense_serve(torch, cfg, model, traffic, device):
    """Serve ``traffic`` over dense slot rows (max_len = the longest
    prompt + max_new): every logit row finite, the paged-attention,
    flash-forward and RMSNorm counters set to 0 just before the run and
    read just after.  Returns (scheduler, requests, results, stats,
    launches, logit rows checked)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.serve import build_requests
    from repro_torch.serve.scheduler import Scheduler

    lens, max_new = traffic["prompt_lens"], traffic["max_new"]
    sched = Scheduler(cfg, model, num_slots=traffic["slots"], block_size=16,
                      max_len=max(lens) + max_new, layout="dense",
                      device=device)
    rows = [0]
    _check_finite(torch, sched.session, rows)
    reqs = build_requests(cfg, traffic["n_req"], lens, max_new, seed=0)
    for r in reqs:
        sched.submit(r)
    counters = {"paged_attention": pa.paged_attention,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "rmsnorm": rn.rmsnorm}
    _sync(torch, device)
    _reset_peak(torch, device)
    for fn in counters.values():
        fn.launches = 0
    results = sched.run()
    launches = {n: fn.launches for n, fn in counters.items()}
    st = sched.stats.as_dict()
    check(st["completed"] == len(reqs) and all(
        len(results[r.rid]) == max_new for r in reqs),
        f"serve_dense: {st['completed']} of {len(reqs)} requests completed "
        "in full")
    return sched, reqs, results, st, launches, rows[0]


def _profile_dense_decode(torch, sched, prompts):
    """After a dense run (every slot free): each slot prefilled with one
    of ``prompts`` (padded to its bucket), then one decode step over all
    of them under torch.profiler."""
    import numpy as np

    pool, session = sched.pool, sched.session
    index = np.zeros((pool.num_slots,), np.int32)
    rids = [f"profiled{i}" for i in range(len(prompts))]
    for rid, prompt in zip(rids, prompts):
        pool.admit(rid, len(prompt) + 1)
        session.prefill(rid, prompt, bucket=sched._bucket(len(prompt)))
        index[pool.slot_of(rid)] = len(prompt)
    tokens = np.zeros((pool.num_slots, 1), np.int32)
    out = _profile(torch, lambda: session.step(tokens, index))
    for rid in rids:
        pool.release(rid)
    return out


def phase_serve_dense(torch, paged=None, device="cuda", smoke=False):
    """serve_dense: the serve phase's trace (qwen3-0.6b FULL bf16, seed 0)
    over dense slot rows: no paged-attention launch, the RMSNorm launches
    of every prefill and decode step exact, its tokens/s, TTFT and TPOT
    printed beside the paged phase's (``paged``); one decode step
    profiled; then one 4,096-token prompt on a one-slot pool, whose
    prefill runs flash attention, one forward launch a layer."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm

    cfg = get_config("qwen3-0.6b", smoke=smoke)
    model = init_lm(cfg, seed=0, device=device)
    norms = _norms_per_forward(cfg)
    traffic = DENSE_SMOKE_TRAFFIC if smoke else DENSE_TRAFFIC
    sched, reqs, results, st, launches, rows = _dense_serve(
        torch, cfg, model, traffic, device)
    calls = st["prefills"] + st["decode_steps"]
    check(launches["paged_attention"] == 0,
          f"serve_dense launched paged attention {launches}")
    _launch_check(torch, device, {"rmsnorm": launches["rmsnorm"]},
                  {"rmsnorm": norms * calls}, "serve_dense")
    check(launches["flash_attention_fwd"] == 0,
          f"serve_dense: flash below 4,096 tokens {launches}")
    peak = _peak_gib(torch, device)
    profiled = _profile_dense_decode(
        torch, sched, [r.prompt for r in reqs[:traffic["slots"]]])
    del sched
    _release(torch, device)
    long_sched, _, long_res, long_st, long_launches, long_rows = \
        _dense_serve(torch, cfg, model, DENSE_LONG, device)
    long_calls = long_st["prefills"] + long_st["decode_steps"]
    check(long_launches["paged_attention"] == 0,
          f"serve_dense long: paged attention {long_launches}")
    _launch_check(torch, device,
                  {k: long_launches[k] for k in ("flash_attention_fwd",
                                                 "rmsnorm")},
                  {"flash_attention_fwd": cfg.num_layers,
                   "rmsnorm": norms * long_calls}, "serve_dense long")
    emit({"phase": "serve_dense", "arch": cfg.name, "dtype": cfg.dtype,
          "layout": "dense", **{k: traffic[k] for k in traffic},
          "max_len": max(traffic["prompt_lens"]) + traffic["max_new"],
          "completed": st["completed"],
          **{k: st[k] for k in SERVE_FIGURES},
          "prefills": st["prefills"],
          "padded_prefill_tokens": st["padded_prefill_tokens"],
          "paged_serve": paged, "logit_rows_checked": rows,
          "launches": launches, "peak_mem_gib": peak,
          "sample": results[0][:8].tolist(),
          "profiled_decode_step": profiled,
          "long": {**DENSE_LONG, "ttft_s": long_st["ttft_p50_s"],
                   "tpot_mean_s": long_st["tpot_mean_s"],
                   "wall_s": long_st["wall_s"],
                   "launches": long_launches,
                   "logit_rows_checked": long_rows,
                   "peak_mem_gib": _peak_gib(torch, device),
                   "sample": long_res[0][:8].tolist()}})
    del long_sched, model
    _release(torch, device)
    return {n: launches[n] + long_launches[n] for n in launches}


def _batch_floor(torch, model, prompts, device) -> float:
    """The largest |difference| between the last-position prefill logits
    of ``prompts`` as one batch (the engine's prefill) and one row at a
    time (the schedulers'): f32 rounding that differs with the batch's
    shape, amplified by the stack's depth."""
    import numpy as np

    from repro_torch.models.lm import lm_prefill_dense

    toks = torch.from_numpy(np.stack(prompts)).long().to(device)
    with torch.no_grad():
        batched = lm_prefill_dense(model, toks)[0][:, -1]
        single = torch.cat([lm_prefill_dense(model, toks[i:i + 1])[0][:, -1]
                            for i in range(len(prompts))])
    return float((batched - single).abs().max())


@exact_f32
def phase_recompute_dense(torch, device="cuda", smoke=False):
    """recompute_dense, in f32 (TF32 off): for qwen3-0.6b and xlstm-125m
    at full width, the dense scheduler, the paged scheduler and
    ``Engine.generate`` over one uniform batch of the same prompts give
    the same greedy tokens, and every token served on dense rows is the
    argmax of ``lm_forward`` over the served sequence, save top-2 ties
    within 1e-4.  The dense and paged streams may part only at such a
    tie; the engine's, which prefills the prompts as one batch where the
    schedulers prefill one row at a time, only at a top-2 gap below
    twice the batch floor :func:`_batch_floor` measures in this run
    (never below 1e-4).  Every parting is counted."""
    import numpy as np

    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Scheduler

    out = {"phase": "recompute_dense", "dtype": "float32",
           "allow_tf32": False}
    for arch, n, P, new in (DENSE_F32_SMOKE if smoke else DENSE_F32):
        cfg = replace(get_config(arch, smoke=smoke), dtype="float32")
        model = init_lm(cfg, seed=1, device=device)
        reqs = build_requests(cfg, n, [P], new, seed=1)
        runs, gaps = {}, {}
        for layout in ("paged", "dense"):
            sched = Scheduler(cfg, model, num_slots=n, block_size=16,
                              max_len=P + new, layout=layout, device=device)
            _record_gaps(sched, gaps.setdefault(layout, {}))
            for r in reqs:
                sched.submit(r)
            runs[layout] = {rid: v.tolist()
                            for rid, v in sched.run().items()}
            if layout == "dense":
                checked, ties, mismatches = _recompute_check(
                    torch, model, sched, reqs, new)
            del sched
        t0 = time.perf_counter()
        gen = Engine(cfg, model, max_len=P + new).generate(
            np.stack([r.prompt for r in reqs]), new)
        engine_s = time.perf_counter() - t0
        runs["engine"] = {r.rid: gen[i, P:].tolist()
                          for i, r in enumerate(reqs)}
        floor = _batch_floor(torch, model, [r.prompt for r in reqs], device)
        engine_tie = max(SPEC_TIE["float32"], 2 * floor)
        partings = {
            "dense_vs_paged": _partings(runs["paged"], runs["dense"],
                                        gaps["paged"], SPEC_TIE["float32"]),
            "engine_vs_dense": _partings(runs["dense"], runs["engine"],
                                         gaps["dense"], engine_tie)}
        out[arch] = {"requests": n, "prompt_len": P, "max_new": new,
                     "positions": checked, "tie_count": len(ties),
                     "mismatches": mismatches, "partings": partings,
                     "batch_floor": floor, "engine_tie": engine_tie,
                     "engine_s": engine_s,
                     "identical": all(not p for p in partings.values())}
        check(not mismatches, f"recompute_dense {arch}: served tokens "
              f"differ from lm_forward at {mismatches[:3]}")
        for what, parts in partings.items():
            check(all(p["tie"] for p in parts), f"recompute_dense {arch}: "
                  f"{what} part off a tie: {parts}")
        del model, gen
        _release(torch, device)
    emit(out)


def phase_train_remat(torch, device="cuda", smoke=False):
    """train_remat: the train cell (qwen3-0.6b FULL bf16, B = 4, S =
    4096, Adam, seed 0) for ``REMAT_STEPS`` steps under each of
    ``REMAT_POLICIES`` from the same weights: the first-step losses
    bit-equal, the launches of every step the train phase's, each
    policy's step ms (median of the steps after the first) and peak
    memory printed.  ``dots`` keeps every block's matmul outputs (and recomputes
    no product), so its peak should sit above ``full``'s."""
    from repro_torch.launch import train as tl

    size = ["--smoke", "--device", "cpu"] if smoke else []
    B, S = (2, 64) if smoke else (TRAIN_B, TRAIN_S)
    runs, launches = {}, {}
    for remat in REMAT_POLICIES:
        tr = tl.build_trainer(tl.build_parser().parse_args([
            "--arch", "qwen3-0.6b", "--steps", str(REMAT_STEPS), "--batch",
            str(B), "--seq", str(S), "--lr", "1e-3", "--optimizer", "adam",
            "--remat", remat, "--seed", "0", *size]))
        batches = [tl.device_batch(tr.cfg, B, S, i, tr.device)
                   for i in range(REMAT_STEPS)]
        counters = _train_counters()
        for fn in counters.values():
            fn.launches = 0
        _sync(torch, device)
        _reset_peak(torch, device)
        losses, step_s, per_step = [], [], []
        for batch in batches:
            before = {n: fn.launches for n, fn in counters.items()}
            t0 = time.perf_counter()
            _, m = tr.step(tr.state, batch)
            _sync(torch, device)
            step_s.append(time.perf_counter() - t0)
            per_step.append({n: fn.launches - before[n]
                             for n, fn in counters.items()})
            losses.append(float(m["loss"]))
        check(all(map(math.isfinite, losses)),
              f"train_remat {remat}: losses {losses}")
        for got in per_step:
            _launch_check(torch, device, got, TRAIN_PER_STEP,
                          f"train_remat {remat}")
        runs[remat] = {"losses": losses, "step_s": step_s,
                       "step_ms": statistics.median(step_s[1:]) * 1e3,
                       "peak_mem_gib": _peak_gib(torch, device),
                       "launches_per_step": per_step[-1]}
        for n, fn in counters.items():
            launches[n] = launches.get(n, 0) + fn.launches
        del tr, batches
        _release(torch, device)
    first = {r: runs[r]["losses"][0] for r in REMAT_POLICIES}
    emit({"phase": "train_remat", "arch": "qwen3-0.6b", "batch": B,
          "seq": S, "steps": REMAT_STEPS, "runs": runs,
          "first_losses_equal": len(set(first.values())) == 1})
    check(len(set(first.values())) == 1,
          f"train_remat: first-step losses differ across policies {first}")
    return launches


# ---------------------------------------------------------------------------
# the fifteenth slice: the request lifecycle, the journal, fault injection
# and the HTTP gateway
# ---------------------------------------------------------------------------

# serve_lifecycle: qwen3-0.6b at full width, LIFECYCLE_LAYERS layers, in
# f32 (TF32 off), 8 requests over 4
# slots, prompts 128/256/512, 32 new tokens, the even rids greedy and the
# odd ones at temperature 0.8 with a seed each
LIFECYCLE_TRAFFIC = dict(n_req=8, prompt_lens=[128, 256, 512], max_new=32,
                         slots=4)
LIFECYCLE_SMOKE_TRAFFIC = dict(n_req=8, prompt_lens=[8, 16, 24],
                               max_new=16, slots=4)
# the lifecycle script's faults (its docstring says where each lands)
LIFECYCLE_FAULTS = "stall@3:secs=0.05,oom@6:hold=3,disconnect@14:rid=4"
# the serve CLI's SIGKILL drill: 4 requests over 4 slots, prompts 128/256,
# 16 new tokens at temperature 0.8
LIFECYCLE_CLI = ["--arch", "qwen3-0.6b", "--dtype", "float32", "--requests",
                 "4", "--slots", "4", "--prompt-lens", "128,256",
                 "--max-new", "16", "--temperature", "0.8"]
LIFECYCLE_CLI_SMOKE = ["--prompt-lens", "8,16", "--max-new", "8"]
# qwen3-0.6b at full width cut to this depth (as ltfb_lm's population):
# every part of the phase and its CLI drill run it (PR 30 cut the phase
# from 28 layers to make room for serve_tp; every path and check kept)
LIFECYCLE_LAYERS = 8


def _mid_decode(max_new: int) -> int:
    """A fault step inside the first wave's decode: its slots fill at
    steps 1-4 (one admission a step) and its first request ends near step
    ``max_new + 1``; 5/8 of the way there (20 at 32 new tokens)."""
    return max(4, max_new * 5 // 8)


def _lifecycle_requests(cfg, traffic):
    """The phase's trace: ``build_requests``' prompts, the odd rids at
    temperature 0.8 with seed 1000 + rid."""
    from repro_torch.launch.serve import build_requests

    reqs = build_requests(cfg, traffic["n_req"], traffic["prompt_lens"],
                          traffic["max_new"], seed=0)
    for r in reqs:
        if r.rid % 2:
            r.temperature, r.seed = 0.8, 1000 + r.rid
    return reqs


def _clone_request(r, **kw):
    """A fresh Request with ``r``'s fields (``kw`` overriding)."""
    from repro_torch.serve.scheduler import Request

    fields = dict(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                  eos_id=r.eos_id, temperature=r.temperature, seed=r.seed)
    fields.update(kw)
    return Request(**fields)


def _pool_free(sched):
    """(free slots, pages an admission may budget, pages in use)."""
    b = sched.pool.blocks
    return [sched.pool.free_slots, b.available_blocks, b.used_blocks]


def _lifecycle_sched(torch, cfg, model, traffic, device, calls, rows,
                     gaps=None, **kw):
    """A paged scheduler over ``model`` whose model calls are counted into
    ``calls`` and logit rows checked finite; with ``gaps`` every sampled
    token's top-2 gap is recorded."""
    from repro_torch.serve.scheduler import Scheduler

    sched = Scheduler(cfg, model, num_slots=traffic["slots"],
                      block_size=16, max_len=max(traffic["prompt_lens"])
                      + traffic["max_new"], device=device, **kw)
    _check_finite(torch, sched.session, rows)
    counted = _count_calls(sched)
    if gaps is not None:
        _record_gaps(sched, gaps)
    calls.append(counted)
    return sched


def _lifecycle_expected(cfg, calls) -> dict:
    """The launches of the counted model calls: one paged launch per
    attention layer and decode step, the RMSNorm launches of every
    prefill chunk and step (attention-only paged stacks prefill in
    chunks)."""
    from repro_torch.models.lm import layer_specs

    attn = sum(s.kind == "a" for s in layer_specs(cfg))
    steps = sum(c["t_step"] for c in calls)
    chunks = sum(c["t_chunk"] + c["t_prefill"] for c in calls)
    return {"paged_attention": attn * steps,
            "rmsnorm": _norms_per_forward(cfg) * (steps + chunks)}


def _tokens(results) -> dict:
    return {rid: [int(t) for t in v] for rid, v in results.items()}


def _crash_drill(torch, cfg, model, traffic, device, work, calls, rows):
    """Part 1: the trace uninterrupted with a journal on, then again with
    ``crash@N``; the journal replayed into a fresh scheduler resumes every
    unfinished request, and the stitched streams must equal the
    uninterrupted ones (partings only at a top-2 gap below 1e-4)."""
    from repro_torch.serve import faults as fl
    from repro_torch.serve import journal as jr

    reqs = _lifecycle_requests(cfg, traffic)
    gaps = {}
    base_path = os.path.join(work, "base.jsonl")
    base = _lifecycle_sched(torch, cfg, model, traffic, device, calls, rows,
                            gaps=gaps,
                            journal=jr.RequestJournal(base_path))
    # the journal's own cost: every record it writes, timed on the host
    cost = {"submit_s": 0.0, "commit_s": 0.0, "commits": 0}
    for name, key in (("record_submit", "submit_s"),
                      ("step_commit", "commit_s")):
        fn = getattr(base.journal, name)

        def timed(*a, _fn=fn, _key=key, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            cost[_key] += time.perf_counter() - t0
            cost["commits"] += _key == "commit_s"
            return out
        setattr(base.journal, name, timed)
    for r in reqs:
        base.submit(_clone_request(r))
    want = _tokens(base.run())
    base.journal.close()
    st = base.stats.as_dict()
    check(st["completed"] == traffic["n_req"] and all(
        len(v) == traffic["max_new"] for v in want.values()),
        f"serve_lifecycle: the uninterrupted run completed {st['completed']}")
    path = os.path.join(work, "crash.jsonl")
    crash_step = _mid_decode(traffic["max_new"])
    crashed = _lifecycle_sched(
        torch, cfg, model, traffic, device, calls, rows,
        journal=jr.RequestJournal(path),
        faults=fl.FaultInjector(f"crash@{crash_step}"))
    for r in reqs:
        crashed.submit(_clone_request(r))
    try:
        crashed.run()
        raised = False
    except fl.InjectedFault:
        raised = True
    check(raised and crashed.stats.fault_injected == 1,
          "serve_lifecycle: crash@N did not stop the run")
    crashed.journal.close()
    entries = jr.replay(path)
    unfinished = jr.unfinished(entries)
    fresh = _lifecycle_sched(torch, cfg, model, traffic, device, calls, rows,
                             journal=jr.RequestJournal(path))
    free0 = _pool_free(fresh)
    prefixes = jr.resume_scheduler(fresh, entries)
    got = _tokens(jr.stitched_results(fresh.run(), prefixes))
    fresh.journal.close()
    parts = _partings(want, got, gaps, SPEC_TIE["float32"])
    check(all(p["tie"] for p in parts),
          f"serve_lifecycle: a resumed stream parts away from a tie: {parts}")
    check(_pool_free(fresh) == free0 and free0[2] == 0,
          f"serve_lifecycle: resumed pool {_pool_free(fresh)} != {free0}")
    mid = sum(1 for p in prefixes.values() if p)
    check(fresh.stats.journal_replayed == len(prefixes) == len(unfinished)
          > 0 and mid > 0, f"serve_lifecycle: resumed {len(prefixes)} of "
          f"{len(unfinished)} unfinished, mid-stream {mid}")
    steps = max(base.stats.steps, 1)
    return reqs, want, gaps, base, {
        "crash_step": crash_step,
        "tokens_at_crash": sum(len(e.tokens) for e in entries.values()),
        "resumed": len(prefixes), "resumed_mid_stream": mid,
        "journal_replayed": fresh.stats.journal_replayed,
        "partings": parts, "parting_count": len(parts),
        "identical_requests": len(want) - len(parts),
        "journal_lines": len(open(base_path, "rb").read().splitlines()),
        "journal_bytes": os.path.getsize(base_path),
        "journal_commit_ms_per_step": 1e3 * cost["commit_s"] / steps,
        "journal_submit_ms": 1e3 * cost["submit_s"] / len(reqs),
        "journal_commits": cost["commits"], "steps": base.stats.steps,
        "step_ms": 1e3 * st["wall_s"] / steps,
        "tokens_per_s": st["tokens_per_s"], "wall_s": st["wall_s"],
        "resumed_wall_s": fresh.stats.as_dict()["wall_s"]}


def _lifecycle_script(torch, cfg, model, traffic, device, reqs, want, gaps,
                      calls, rows):
    """Part 2: the trace's requests through a bounded queue
    (``max_queue=4``) with ``prefill_chunk=64`` (half the shortest
    prompt) and the faults of
    ``LIFECYCLE_FAULTS``: r4 is refused (Overloaded) while r0-r3 fill the
    queue, r3's expired TTFT deadline sheds it, r1 is cancelled after its
    first of four chunks (step 3, which the stall slows), oom holds
    admission shut at steps 6-8, r0 is cancelled in decode (step 10),
    the disconnect cancels r4 (step 14); r5 completes late (a TTFT miss),
    r6 over its TPOT budget.  Every counter must read as written here, the
    pool's free pages must come back, and the completed streams must
    equal part 1's."""
    from repro_torch.serve import faults as fl
    from repro_torch.serve.scheduler import Overloaded

    sched = _lifecycle_sched(torch, cfg, model, traffic, device, calls, rows,
                             prefill_chunk=traffic["prompt_lens"][0] // 2,
                             max_queue=4,
                             faults=fl.FaultInjector(LIFECYCLE_FAULTS))
    free0 = _pool_free(sched)
    r = {q.rid: q for q in reqs}
    for rid in (0, 1, 2):
        sched.submit(_clone_request(r[rid]))
    sched.submit(_clone_request(r[3], ttft_deadline_ms=1e-6))
    try:
        sched.submit(_clone_request(r[4]))
        overloaded = False
    except Overloaded:
        overloaded = True
    shed = sched.shed_expired()
    sched.submit(_clone_request(r[4]))
    for _ in range(3):
        sched.step()
    act = sched.prefilling.get(1)
    in_prefill = act is not None and 0 < act.pf_pos < act.req.prompt_len
    cancel_prefill = sched.cancel(1)
    for _ in range(2):
        sched.step()
    sched.submit(_clone_request(r[5], ttft_deadline_ms=1e-6))
    sched.submit(_clone_request(r[6], tpot_deadline_ms=1e-9))
    sched.submit(_clone_request(r[7]))
    for _ in range(5):
        sched.step()
    in_decode = 0 in sched.active
    cancel_decode = sched.cancel(0)
    got = _tokens(sched.run())
    st = sched.stats
    counters = {k: getattr(st, k) for k in (
        "submitted", "completed", "rejected", "shed_overload",
        "shed_deadline", "cancelled", "ttft_deadline_misses",
        "tpot_deadline_misses", "fault_injected")}
    expected = {"submitted": 8, "completed": 4, "rejected": 0,
                "shed_overload": 1, "shed_deadline": 1, "cancelled": 3,
                "ttft_deadline_misses": 1, "tpot_deadline_misses": 1,
                "fault_injected": 3}
    check(overloaded and shed == [3] and in_prefill and cancel_prefill
          and in_decode and cancel_decode,
          f"serve_lifecycle: script overloaded={overloaded} shed={shed} "
          f"in_prefill={in_prefill} in_decode={in_decode}")
    check(counters == expected,
          f"serve_lifecycle: counters {counters} != {expected}")
    check(sorted(got) == [2, 5, 6, 7],
          f"serve_lifecycle: completed {sorted(got)}")
    parts = _partings({k: want[k] for k in got}, got, gaps,
                      SPEC_TIE["float32"])
    check(all(p["tie"] for p in parts),
          f"serve_lifecycle: a stream parts from part 1's: {parts}")
    free1 = _pool_free(sched)
    check(free1 == free0 and free0[2] == 0,
          f"serve_lifecycle: pool {free1} != {free0}")
    return {"counters": counters, "pool_free_before": free0,
            "pool_free_after": free1, "partings": parts,
            "parting_count": len(parts), "prefill_chunks": st.prefill_chunks,
            "decode_steps": st.decode_steps, "steps": st.steps}


async def _gw_http(port, method, path, body=None, headers=None):
    """One HTTP/1.1 exchange with the gateway: (status, headers, body)."""
    import asyncio

    r, w = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    w.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n{extra}"
             f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload)
    await w.drain()
    data = (await r.read()).decode()
    w.close()
    head, _, rest = data.partition("\r\n\r\n")
    lines = head.split("\r\n")
    hdrs = {k.strip().lower(): v.strip() for k, _, v in
            (ln.partition(":") for ln in lines[1:])}
    return int(lines[0].split()[1]), hdrs, rest


def _gw_tokens(hdrs, rest):
    """A generate response's tokens: the NDJSON chunks of a stream (its
    last record must be ``done``), or the JSON body's ``tokens``."""
    if hdrs.get("transfer-encoding") != "chunked":
        return json.loads(rest)["tokens"]
    recs = []
    while rest:
        size, _, rest = rest.partition("\r\n")
        n = int(size, 16)
        if n == 0:
            break
        recs.append(json.loads(rest[:n]))
        rest = rest[n + 2:]
    check(bool(recs) and recs[-1].get("done"),
          f"serve_lifecycle: a stream ended without done: {recs[-1:]}")
    return [x["token"] for x in recs if "token" in x]


def _gateway_drill(torch, cfg, model, traffic, device, reqs, want, gaps,
                   calls, rows):
    """Part 3: first the trace's 8 requests straight through a scheduler
    (the direct twin: its wall is the gateway's yardstick), then the
    gateway on port 0 over a scheduler with ``max_queue=8``: the same 8
    requests at once (4 streamed, 4 not; r3 with an Idempotency-Key),
    their tokens equal to part 1's; then
    admission held shut while 8 short requests fill the queue, so a
    ninth is a 429; a request past its TTFT deadline, a 429; r3's key
    again, a replay; ``/metrics`` as text and JSON; a drain, after which
    ``/v1/generate`` and ``/readyz`` answer 503."""
    import asyncio
    import threading

    from repro_torch.serve.gateway import Gateway

    twin = _lifecycle_sched(torch, cfg, model, traffic, device, calls, rows,
                            max_queue=8)
    for q in reqs:
        twin.submit(_clone_request(q))
    t0 = time.perf_counter()
    direct = _tokens(twin.run())
    _sync(torch, device)
    direct_wall = time.perf_counter() - t0
    direct_parts = _partings(want, direct, gaps, SPEC_TIE["float32"])
    check(all(p["tie"] for p in direct_parts),
          f"serve_lifecycle: the direct twin parts: {direct_parts}")
    twin_st = twin.stats.as_dict()
    sched = _lifecycle_sched(torch, cfg, model, traffic, device, calls, rows,
                             max_queue=8)
    admit, submit = sched._admission_phase, sched.submit
    hold, queued = threading.Event(), threading.Semaphore(0)
    hold.set()
    sched._admission_phase = lambda: admit() if hold.is_set() else 0

    def counted(req):
        submit(req)
        queued.release()
    sched.submit = counted
    gw = Gateway(sched, host="127.0.0.1", port=0)
    key = {"Idempotency-Key": "k3"}

    def body(q, **kw):
        return {"rid": q.rid, "prompt": q.prompt.tolist(),
                "max_new": q.max_new, "temperature": q.temperature,
                "seed": q.seed, **kw}

    async def go():
        await gw.start()
        loop = asyncio.get_running_loop()
        try:
            ready = await _gw_http(gw.port, "GET", "/readyz")
            t0 = time.perf_counter()
            resps = await asyncio.gather(*[_gw_http(
                gw.port, "POST", "/v1/generate",
                body(q, stream=bool(q.rid % 2 == 0)),
                headers=key if q.rid == 3 else None) for q in reqs])
            wall = time.perf_counter() - t0
            for _ in reqs:
                queued.acquire(timeout=0)
            hold.clear()
            filler = reqs[0].prompt[:traffic["prompt_lens"][0]].tolist()
            fill = [asyncio.ensure_future(_gw_http(
                gw.port, "POST", "/v1/generate",
                {"rid": f"f{i}", "prompt": filler, "max_new": 2,
                 "stream": False})) for i in range(8)]
            for _ in range(8):
                check(await loop.run_in_executor(None, queued.acquire,
                                                 True, 120),
                      "serve_lifecycle: the gateway queued no filler")
            over = await _gw_http(gw.port, "POST", "/v1/generate",
                                  {"rid": "over", "prompt": filler,
                                   "max_new": 2})
            hold.set()
            fills = await asyncio.gather(*fill)
            late = await _gw_http(gw.port, "POST", "/v1/generate",
                                  {"rid": "late", "prompt": filler,
                                   "max_new": 2, "ttft_deadline_ms": 1e-6})
            replay = await _gw_http(gw.port, "POST", "/v1/generate",
                                    body(reqs[3]), headers=key)
            text = await _gw_http(gw.port, "GET", "/metrics")
            js = await _gw_http(gw.port, "GET", "/metrics",
                                headers={"Accept": "application/json"})
            gw.begin_drain()
            refused = await _gw_http(gw.port, "POST", "/v1/generate",
                                     {"prompt": filler, "max_new": 2})
            not_ready = await _gw_http(gw.port, "GET", "/readyz")
        finally:
            await gw.stop()
        return (ready, resps, wall, over, fills, late, replay, text, js,
                refused, not_ready)

    (ready, resps, wall, over, fills, late, replay, text, js, refused,
     not_ready) = asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(go(), 600))
    check(gw.driver_error is None,
          f"serve_lifecycle: the gateway's driver failed: {gw.driver_error}")
    got = {q.rid: _gw_tokens(h, b) for q, (_, h, b) in zip(reqs, resps)}
    parts = _partings(want, got, gaps, SPEC_TIE["float32"])
    check(all(p["tie"] for p in parts),
          f"serve_lifecycle: a gateway stream parts from part 1's: {parts}")
    rb = json.loads(replay[2])
    exposition = text[2]
    metrics = json.loads(js[2])
    statuses = {"readyz": ready[0], "generate": [s for s, _, _ in resps],
                "fillers": [s for s, _, _ in fills], "overload": over[0],
                "deadline": late[0], "replay": replay[0],
                "metrics_text": text[0], "metrics_json": js[0],
                "drain_generate": refused[0], "drain_readyz": not_ready[0]}
    want_status = {"readyz": 200, "generate": [200] * len(reqs),
                   "fillers": [200] * 8, "overload": 429, "deadline": 429,
                   "replay": 200, "metrics_text": 200, "metrics_json": 200,
                   "drain_generate": 503, "drain_readyz": 503}
    check(statuses == want_status,
          f"serve_lifecycle: gateway statuses {statuses}")
    check(all("retry-after" in r[1] for r in (over, late, refused,
                                              not_ready)),
          "serve_lifecycle: a 429/503 lacks Retry-After")
    check(rb.get("idempotent_replay") and rb["tokens"] == got[3],
          f"serve_lifecycle: the replay {rb}")
    lifecycle = {k: metrics[k] for k in ("shed_overload", "shed_deadline",
                                         "completed", "submitted")}
    check(lifecycle == {"shed_overload": 1, "shed_deadline": 1,
                        "completed": len(reqs) + 8,
                        "submitted": len(reqs) + 9}
          and "repro_serve_shed_overload_total 1\n" in exposition
          and "repro_serve_shed_deadline_total 1\n" in exposition,
          f"serve_lifecycle: /metrics {lifecycle}")
    check(gw.drained(), "serve_lifecycle: the gateway did not drain")
    n_tok = sum(len(v) for v in got.values())
    return {"statuses": statuses, "partings": parts,
            "parting_count": len(parts), "metrics": lifecycle,
            "tokens_per_s": n_tok / wall, "wall_s": wall,
            "direct_tokens_per_s": n_tok / direct_wall,
            "direct_wall_s": direct_wall,
            "gateway_over_direct": direct_wall / wall,
            "direct_step_ms": 1e3 * twin_st["wall_s"]
            / max(twin.stats.steps, 1),
            "direct_partings": direct_parts}


def _cli_drill(torch, cfg, model, device, smoke, work, calls, rows):
    """Part 4: ``python -m repro_torch.launch.serve --dtype float32
    --journal J --fault-spec kill@K`` in a subprocess ends with -9; the
    same with ``--resume-journal J --out-json R`` finishes, loading the
    kernels already built (the library is not rebuilt); R's streams must
    equal an in-process run of the same ``build_requests`` trace."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import build_requests

    argv = [*LIFECYCLE_CLI, *(LIFECYCLE_CLI_SMOKE if smoke else
                              ["--num-layers", str(LIFECYCLE_LAYERS)]),
            "--device", str(device).split(":")[0]]
    opt = dict(zip(argv[::2], argv[1::2]))
    argv += ["--smoke"] if smoke else []
    lens = [int(x) for x in opt["--prompt-lens"].split(",")]
    traffic = dict(n_req=int(opt["--requests"]), prompt_lens=lens,
                   max_new=int(opt["--max-new"]), slots=int(opt["--slots"]))
    kill_step = _mid_decode(traffic["max_new"])
    gaps = {}
    ref = _lifecycle_sched(torch, cfg, model, traffic, device, calls, rows,
                           gaps=gaps)
    for r in build_requests(cfg, traffic["n_req"], lens, traffic["max_new"],
                            temperature=float(opt["--temperature"]), seed=0):
        ref.submit(r)
    want = _tokens(ref.run())
    journal = os.path.join(work, "cli.jsonl")
    out = os.path.join(work, "cli.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *argv]
    lib = build.LIBRARY
    lib_mtime = lib.stat().st_mtime_ns if lib.exists() else None
    triton_dir = Path(build.triton_cache_dir())

    def triton_files():
        return sorted(str(p) for p in triton_dir.rglob("*")) \
            if triton_dir.is_dir() else []
    triton0 = triton_files()
    t0 = time.perf_counter()
    killed = subprocess.run(
        cmd + ["--journal", journal, "--fault-spec",
               f"kill@{kill_step}"], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=600)
    t1 = time.perf_counter()
    resumed = subprocess.run(
        cmd + ["--resume-journal", journal, "--out-json", out],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    t2 = time.perf_counter()
    check(killed.returncode == -9,
          f"serve_lifecycle: the killed CLI returned {killed.returncode}: "
          f"{killed.stderr[-2000:]}")
    check(resumed.returncode == 0,
          f"serve_lifecycle: the resumed CLI returned {resumed.returncode}: "
          f"{resumed.stderr[-2000:]}")
    got = {int(k): v for k, v in json.load(open(out))["results"].items()}
    parts = _partings(want, got, gaps, SPEC_TIE["float32"])
    check(all(p["tie"] for p in parts) and len(got) == len(want),
          f"serve_lifecycle: the resumed CLI's streams part: {parts}")
    rebuilt = lib.stat().st_mtime_ns != lib_mtime if lib_mtime else None
    triton_new = len(set(triton_files()) - set(triton0))
    if str(device).startswith("cuda"):
        check(rebuilt is False and triton_new == 0,
              f"serve_lifecycle: the CLI rebuilt kernels (library "
              f"{rebuilt}, {triton_new} new Triton files)")
    lines = [ln for ln in resumed.stdout.splitlines()
             if ln.startswith("[serve] journal:")]
    return {"argv": argv, "kill_step": kill_step,
            "rc_killed": killed.returncode, "rc_resumed": resumed.returncode,
            "killed_s": t1 - t0, "resumed_s": t2 - t1,
            "journal_lines": len(open(journal, "rb").read().splitlines()),
            "replayed_line": lines[-1] if lines else None,
            "partings": parts, "parting_count": len(parts),
            "library_rebuilt": rebuilt, "triton_new_files": triton_new}


@exact_f32
def phase_serve_lifecycle(torch, device="cuda", smoke=False):
    """serve_lifecycle: the request lifecycle, the journal, fault injection
    and the gateway on qwen3-0.6b at full width and ``LIFECYCLE_LAYERS``
    layers in f32 (``smoke``: the SMOKE config, for a CPU rehearsal).
    Returns the launches of its in-process parts, the counters set to 0
    just before the first and read just after the last."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm

    cfg = replace(get_config("qwen3-0.6b", smoke=smoke), dtype="float32")
    if not smoke:
        cfg = replace(cfg, num_layers=LIFECYCLE_LAYERS)
    traffic = LIFECYCLE_SMOKE_TRAFFIC if smoke else LIFECYCLE_TRAFFIC
    t_start = time.perf_counter()
    model = init_lm(cfg, seed=0, device=device)
    _sync(torch, device)
    work = tempfile.mkdtemp(prefix="chip_smoke_lifecycle_")
    counters = _all_counters()
    calls, rows, secs = [], [0], {}
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        reqs, want, gaps, base, crash = _crash_drill(
            torch, cfg, model, traffic, device, work, calls, rows)
        secs["crash_drill"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        script = _lifecycle_script(torch, cfg, model, traffic, device, reqs,
                                   want, gaps, calls, rows)
        secs["lifecycle"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gateway = _gateway_drill(torch, cfg, model, traffic, device, reqs,
                                 want, gaps, calls, rows)
        secs["gateway"] = time.perf_counter() - t0
        _sync(torch, device)
        got = {n: fn.launches for n, fn in counters.items()}
        # the CLI reference run is in-process too, but counted apart: the
        # subprocesses' launches are their own
        cli_calls = []
        t0 = time.perf_counter()
        cli = _cli_drill(torch, cfg, model, device, smoke, work, cli_calls,
                         rows)
        secs["cli_drill"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    expected = _lifecycle_expected(cfg, calls)
    _launch_check(torch, device, {n: got[n] for n in expected}, expected,
                  "serve_lifecycle")
    check(not any(got[n] for n in got if n not in expected)
          or not str(device).startswith("cuda"),
          f"serve_lifecycle: a kernel off the path launched: {got}")
    secs["total"] = time.perf_counter() - t_start
    emit({"phase": "serve_lifecycle", "arch": cfg.name, "dtype": cfg.dtype,
          "allow_tf32": False, **traffic, "temperatures": [0.0, 0.8],
          "crash": crash, "lifecycle": script, "gateway": gateway,
          "cli": cli, "journal_share_of_step":
          crash["journal_commit_ms_per_step"] / gateway["direct_step_ms"],
          "tie_tolerance": SPEC_TIE["float32"],
          "logit_rows_checked": rows[0],
          "model_calls": {k: sum(c[k] for c in calls) for k in calls[0]},
          "launches": {n: got[n] for n in expected}, "seconds": secs})
    del model, base
    _release(torch, device)
    return {n: got[n] for n in expected}


# ---------------------------------------------------------------------------
# the online LTFB arena: challengers draft for the champion
# ---------------------------------------------------------------------------

# serve_arena: ltfb_lm's round-2 population (qwen3-0.6b FULL), 8 requests
# over 4 slots, prompts 128/256, 32 new tokens, 4 draft tokens a round.
# (a) twins (both trainers link trainer 0's file) in f32: the challenger
# accepts nearly every proposal, so it crosses a margin of 0.3 once its
# window holds 8 proposals, and the streams must be target-only decoding's
ARENA_TRAFFIC = dict(n_req=8, prompt_lens=SWAP_PROMPTS, max_new=SWAP_MAX_NEW,
                     slots=4)
ARENA_SMOKE_TRAFFIC = dict(n_req=8, prompt_lens=[8, 16], max_new=8, slots=4)
ARENA_TWIN = dict(policy="shadow", window=64, min_samples=8, margin=0.3,
                  hysteresis=1, check_every=2, seq_len=64, samples_per_file=4)
# the crash drill's fault lands this many steps after the promotion
ARENA_CRASH_AFTER = 3
# (c) the real roster behind the gateway: only the admin override can
# promote; its requests are the trace's first 4 at 8 new tokens
ARENA_GATEWAY = dict(policy="shadow", min_samples=10 ** 6, hysteresis=1)
ARENA_GATEWAY_NEW = 8


def _arena_roster(pop_dir, dst, twin=False) -> str:
    """A population directory of hard links to ``pop_dir``'s newest step
    (its trainer files and manifest; with ``twin`` every trainer links
    trainer 0's file, so the recorded wins tie and trainer 0 serves) and
    a copy of its genealogy, if any: an arena archives and appends there
    and ``pop_dir`` stays as the later phases read it."""
    from repro_torch.serve import registry as reg

    step = reg.population_steps(pop_dir)[-1]
    os.makedirs(dst)
    manifest = f"step_{step}.manifest"
    with open(os.path.join(pop_dir, manifest)) as f:
        n = json.load(f)["num_trainers"]
    for i in range(n):
        os.link(os.path.join(pop_dir,
                             f"step_{step}_trainer_{0 if twin else i}.ckpt"),
                os.path.join(dst, f"step_{step}_trainer_{i}.ckpt"))
    os.link(os.path.join(pop_dir, manifest), os.path.join(dst, manifest))
    genealogy = os.path.join(pop_dir, "genealogy.jsonl")
    if os.path.exists(genealogy):
        shutil.copy(genealogy, dst)
    return dst


def _on_device(tree, device):
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(v, device) for v in tree)
    return tree.to(device)


def _pop_hooks(torch, cfg, smoke, device):
    """(template, from_ckpt, to_ckpt) for serving ``cfg`` from ltfb_lm's
    checkpoints: the template in the population's dtype on ``device``
    (``ckpt.restore`` puts each leaf straight on the card), the weights
    cast to ``cfg``'s dtype there, and back to the checkpoint's layout for
    an arena's archives."""
    from repro_torch import bridge
    from repro_torch.models.lm import init_lm
    from repro_torch.train.steps import params_from_ckpt

    pop_cfg = _pop_cfg(smoke)
    like = _on_device(bridge.params_to_jax_layout(
        init_lm(pop_cfg, seed=0, device=device), pop_cfg), device)
    dtype = getattr(torch, cfg.dtype)
    return (like,
            lambda tree: params_from_ckpt(cfg, tree, device, dtype),
            lambda params: bridge.params_to_jax_layout(params, cfg))


def _timed(obj, name, sink, torch, device):
    """Wrap ``obj.name`` so that each call's seconds (the card synced
    after it) go into ``sink``."""
    fn = getattr(obj, name)

    def run(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        _sync(torch, device)
        sink.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, run)


def _arena_sched(torch, cfg, models, arena, traffic, device, calls, rows,
                 **kw):
    """A speculative scheduler over ``arena`` (``models``: the target and
    the drafter, into which it loads the champion and the active
    challenger), its model calls counted into ``calls`` and every logit
    row checked finite."""
    from repro_torch.serve.scheduler import Scheduler

    sched = Scheduler(cfg, models[0], num_slots=traffic["slots"],
                      block_size=16, max_len=max(traffic["prompt_lens"])
                      + traffic["max_new"], draft_params=models[1],
                      spec_tokens=SPEC_K, swap_mode="drain", arena=arena,
                      device=device, **kw)
    _check_finite(torch, sched.session, rows)
    calls.append((cfg, _count_calls(sched)))
    return sched


def _shard_rows(root):
    """Every write-back shard's shape and its rows, in shard order."""
    from repro_torch.data.tokens import list_token_shards, read_token_shard

    shards = [read_token_shard(p)["tokens"] for p in list_token_shards(root)]
    return [list(s.shape) for s in shards], sorted(
        r for s in shards for r in s.tolist())


def _arena_twins(torch, cfg, hooks, models, pop_dir, work, traffic, device,
                 calls, rows):
    """Part (a): the twin roster with a journal and write-back, against
    target-only decoding; then the crash drill."""
    from repro_torch.launch.serve import build_requests
    from repro_torch.serve import faults as fl
    from repro_torch.serve import journal as jr
    from repro_torch.serve import registry as reg
    from repro_torch.serve.arena import Arena, ArenaConfig, TokenWriteback
    from repro_torch.serve.scheduler import Scheduler

    like, from_ckpt, to_ckpt = hooks
    acfg = ArenaConfig(**ARENA_TWIN)
    reqs = build_requests(cfg, traffic["n_req"], traffic["prompt_lens"],
                          traffic["max_new"], seed=0)
    roster = _arena_roster(pop_dir, f"{work}/twin", twin=True)
    wb, jpath = f"{work}/wb", f"{work}/journal.jsonl"
    t0 = time.perf_counter()
    arena = Arena.from_population(roster, like, acfg, writeback_dir=wb,
                                  vocab=cfg.vocab_size, from_ckpt=from_ckpt,
                                  to_ckpt=to_ckpt)
    _sync(torch, device)
    load_s = time.perf_counter() - t0
    prepare_s, rotate_s = [], []
    _timed(arena, "prepare_promotion", prepare_s, torch, device)
    sched = _arena_sched(torch, cfg, models, arena, traffic, device, calls,
                         rows, journal=jr.RequestJournal(jpath))
    _timed(sched.draft, "set_params", rotate_s, torch, device)
    for r in reqs:
        sched.submit(_clone_request(r))
    t0 = time.perf_counter()
    got = _tokens(sched.run())
    _sync(torch, device)
    wall = time.perf_counter() - t0
    sched.journal.close()
    arena.close()
    st = sched.stats.as_dict()
    snap = arena.snapshot()
    recs = [json.loads(ln) for ln in open(jpath) if ln.strip()]
    promos = [r for r in recs if r["t"] == "promotion"]
    check(st["completed"] == len(reqs) and all(
        len(v) == traffic["max_new"] for v in got.values()),
        f"serve_arena: the twins completed {st['completed']}")
    check(len(promos) == 1 and not promos[0]["forced"]
          and promos[0]["winner"] == "trainer_1"
          and snap["champion"] == "trainer_1" and snap["promotions"] == 1
          and st["arena_promotions"] == 1 and st["hot_swaps"] == 1,
          f"serve_arena: twins promoted {promos} ({snap['champion']})")
    check(sum(r["t"] == "match" for r in recs) == st["arena_matches"]
          == snap["matches"] > 0,
          f"serve_arena: {st['arena_matches']} matches journaled?")
    archives = sorted(os.listdir(f"{roster}/arena"))
    ckpts = [f for f in archives if f.endswith(".ckpt")]
    for f in ckpts:
        reg.verify_checkpoint(f"{roster}/arena/{f}")
    check(len(archives) == 4 and any("_retired_trainer_0." in f
                                     for f in ckpts)
          and any("_champion_trainer_1." in f for f in ckpts),
          f"serve_arena: archives {archives}")
    # target-only decoding of the same prompts on the same weights
    models[0].load_state_dict(arena.params["trainer_0"])
    base = Scheduler(cfg, models[0], num_slots=traffic["slots"],
                     block_size=16, max_len=max(traffic["prompt_lens"])
                     + traffic["max_new"], device=device)
    _check_finite(torch, base.session, rows)
    calls.append((cfg, _count_calls(base)))
    gaps = {}
    _record_gaps(base, gaps)
    for r in reqs:
        base.submit(_clone_request(r))
    want = _tokens(base.run())
    parts = _partings(want, got, gaps, SPEC_TIE["float32"])
    check(all(p["tie"] for p in parts), f"serve_arena: a twin stream parts "
          f"from target-only decoding away from a tie: {parts}")
    width = acfg.seq_len + 1
    shapes, rows_wb = _shard_rows(wb)
    expect_rows = sorted((list(map(int, r.prompt)) + got[r.rid]
                          + [0] * width)[:width] for r in reqs)
    check(shapes == [[acfg.samples_per_file, width]] * 2
          and rows_wb == expect_rows,
          f"serve_arena: write-back shards {shapes}")
    # the crash drill: the same trace crashes a few steps after its
    # promotion; a fresh roster restored from the journal resumes it
    step = promos[0]["step"]
    crash_roster = _arena_roster(pop_dir, f"{work}/twin_crash", twin=True)
    cwb, cpath = f"{work}/wb_crash", f"{work}/crash.jsonl"
    # the crashed run reuses the roster's weights and archives nothing
    # (no registry directory): the first run timed and verified that
    crashed_arena = Arena(dict(arena.params), "trainer_0", acfg,
                          writeback=TokenWriteback(
                              cwb, acfg.seq_len, cfg.vocab_size,
                              acfg.samples_per_file), to_ckpt=to_ckpt)
    crashed = _arena_sched(
        torch, cfg, models, crashed_arena, traffic, device, calls, rows,
        journal=jr.RequestJournal(cpath),
        faults=fl.FaultInjector(f"crash@{step + ARENA_CRASH_AFTER}"))
    for r in reqs:
        crashed.submit(_clone_request(r))
    try:
        crashed.run()
        raised = False
    except fl.InjectedFault:
        raised = True
    crashed.journal.close()
    entries = jr.replay(cpath)
    state = jr.replay_arena(cpath)
    check(raised and state is not None and state["promotions"] == 1
          and jr.unfinished(entries),
          f"serve_arena: crash@{step + ARENA_CRASH_AFTER} (raised={raised})"
          f" left {state and state['promotions']} promotions journaled")
    t0 = time.perf_counter()
    fresh = Arena.from_population(crash_roster, like, acfg,
                                  writeback_dir=cwb, vocab=cfg.vocab_size,
                                  from_ckpt=from_ckpt, to_ckpt=to_ckpt)
    fresh.restore(state)
    _sync(torch, device)
    reload_s = time.perf_counter() - t0
    restored = fresh.snapshot()
    check({**restored, "writeback": None} == {**state, "writeback": None}
          and fresh.champion == "trainer_1" and fresh.generation == 1,
          "serve_arena: the restored arena is not the journaled one")
    resumed = _arena_sched(torch, cfg, models, fresh, traffic, device,
                           calls, rows, journal=jr.RequestJournal(cpath))
    prefixes = jr.resume_scheduler(resumed, entries)
    stitched = _tokens(jr.stitched_results(resumed.run(), prefixes))
    resumed.journal.close()
    fresh.close()
    resumed_parts = _partings(got, stitched, gaps, SPEC_TIE["float32"])
    check(all(p["tie"] for p in resumed_parts),
          f"serve_arena: a resumed stream parts: {resumed_parts}")
    check(_shard_rows(cwb)[1] == rows_wb,
          "serve_arena: the crash drill's write-back differs")
    lineage = _lineage_of(roster)
    return {"load_s": load_s, "prepare_promotion_s": prepare_s,
            "drafter_set_params_s": rotate_s, "wall_s": wall,
            "tokens_per_s": st["tokens_per_s"],
            "promotion_step": step, "matches": snap["matches"],
            "baseline": snap["baseline"],
            "members": {n: {k: m[k] for k in ("offered", "accepted",
                                              "served_tokens")}
                        for n, m in snap["members"].items()},
            "spec_accept_rate": st["spec_accept_rate"],
            "journal_kinds": {k: sum(r["t"] == k for r in recs)
                              for k in ("match", "promotion")},
            "archives": archives, "partings": parts,
            "writeback_shards": shapes, "crash_step": step
            + ARENA_CRASH_AFTER, "resumed": len(prefixes),
            "resumed_mid_stream": sum(1 for p in prefixes.values() if p),
            "resumed_partings": resumed_parts, "reload_s": reload_s,
            "lineage": lineage}


def _lineage_of(roster) -> list:
    """The lineage CLI's ancestry of the roster's latest champion: the
    record kinds, oldest first (the arena's promotion the last)."""
    import contextlib
    import io

    from repro_torch.launch import lineage

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = lineage.main(["--genealogy", f"{roster}/genealogy.jsonl",
                           "--json"])
    rep = json.loads(out.getvalue())
    kinds = [r["t"] for r in rep["ancestry"]]
    check(rc == 0 and rep["champion"] == "trainer_1"
          and kinds[-1] == "promotion",
          f"serve_arena: lineage {rep['champion']} {kinds}")
    return kinds


def _arena_gateway(torch, cfg, hooks, models, roster, traffic, device,
                   calls, rows):
    """Part (c): the real roster behind an in-process gateway on port 0:
    ``/population``, then ``/arena/promote`` of an unknown member, the
    champion and the challenger (400, 400, 200), then 4 requests; the
    override lands in step 1 through the archives, ``/population`` names
    the new champion and ``/metrics`` carries the arena's families."""
    import asyncio

    from repro_torch.launch.serve import build_requests
    from repro_torch.serve import registry as reg
    from repro_torch.serve.arena import Arena, ArenaConfig
    from repro_torch.serve.gateway import Gateway

    like, from_ckpt, to_ckpt = hooks
    t0 = time.perf_counter()
    arena = Arena.from_population(roster, like, ArenaConfig(**ARENA_GATEWAY),
                                  from_ckpt=from_ckpt, to_ckpt=to_ckpt)
    _sync(torch, device)
    load_s = time.perf_counter() - t0
    prepare_s = []
    _timed(arena, "prepare_promotion", prepare_s, torch, device)
    champion = arena.champion
    (challenger,) = arena.challengers
    sched = _arena_sched(torch, cfg, models, arena, traffic, device, calls,
                         rows)
    reqs = build_requests(cfg, 4, traffic["prompt_lens"], ARENA_GATEWAY_NEW,
                          seed=0)
    gw = Gateway(sched, host="127.0.0.1", port=0)

    async def go():
        await gw.start()
        try:
            out = {"population": await _gw_http(gw.port, "GET",
                                                "/population")}
            for who in ("nope", champion, challenger):
                out[who] = await _gw_http(gw.port, "POST", "/arena/promote",
                                          {"member": who})
            out["generate"] = await asyncio.gather(*[_gw_http(
                gw.port, "POST", "/v1/generate",
                {"rid": r.rid, "prompt": r.prompt.tolist(),
                 "max_new": r.max_new, "stream": False}) for r in reqs])
            out["after"] = await _gw_http(gw.port, "GET", "/population")
            out["metrics"] = await _gw_http(gw.port, "GET", "/metrics")
        finally:
            await gw.stop()
        return out

    out = asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(go(), 600))
    check(gw.driver_error is None,
          f"serve_arena: the gateway's driver failed: {gw.driver_error}")
    before, after = (json.loads(out[k][2]) for k in ("population", "after"))
    statuses = {"population": out["population"][0], "unknown": out["nope"][0],
                "champion": out[champion][0], "challenger": out[challenger][0],
                "generate": [s for s, _, _ in out["generate"]],
                "after": out["after"][0], "metrics": out["metrics"][0]}
    check(statuses == {"population": 200, "unknown": 400, "champion": 400,
                       "challenger": 200, "generate": [200] * len(reqs),
                       "after": 200, "metrics": 200},
          f"serve_arena: gateway statuses {statuses}")
    check(json.loads(out[challenger][2]) == {
        "queued": True, "member": challenger, "champion": champion},
        f"serve_arena: /arena/promote answered {out[challenger][2]}")
    check(before["champion"] == champion and before["promotions"] == 0
          and after["champion"] == challenger and after["promotions"] == 1
          and arena.last_promotion["step"] == 1,
          f"serve_arena: the override {arena.last_promotion} ({after})")
    ckpts = sorted(f for f in os.listdir(f"{roster}/arena")
                   if f.endswith(".ckpt"))
    for f in ckpts:
        reg.verify_checkpoint(f"{roster}/arena/{f}")
    check(len(ckpts) == 2, f"serve_arena: gateway archives {ckpts}")
    text = out["metrics"][2]
    check(f'repro_serve_arena_accept_rate{{member="{challenger}"}}' in text
          and f'repro_serve_arena_served_tokens{{member="{champion}"}}'
          in text and "repro_serve_arena_promotions_total 1\n" in text,
          "serve_arena: /metrics lacks the arena's families")
    return {"load_s": load_s, "prepare_promotion_s": prepare_s,
            "statuses": statuses, "champion_before": champion,
            "champion_after": after["champion"], "archives": ckpts,
            "tokens": sum(len(json.loads(b)["tokens"])
                          for _, _, b in out["generate"])}


@exact_f32
def phase_serve_arena(torch, pop_dir, workdir, device="cuda", smoke=False):
    """serve_arena: the online LTFB arena on ltfb_lm's round-2 population
    (qwen3-0.6b FULL; ``smoke``: SMOKE, for a CPU rehearsal).  (a) twins
    in f32 (TF32 off): one rule-driven promotion through verified
    archives, streams identical to target-only decoding, journaled
    matches and the promotion, write-back shards, a crash drill resumed
    from the journal; (c) the real roster in bf16 behind the gateway, its
    admin override; (b) the serve CLI's ``--arena`` on the real roster.
    Returns the launches of (a) and (c), the counters set to 0 just
    before the first and read just after the last."""
    import re

    from repro_torch.launch import serve
    from repro_torch.models.lm import init_lm

    traffic = ARENA_SMOKE_TRAFFIC if smoke else ARENA_TRAFFIC
    t_start = time.perf_counter()
    work = f"{workdir}/serve_arena"
    counters = _all_counters()
    calls, rows, secs = [], [0], {}
    try:
        cfg = _pop_cfg(smoke, dtype="float32")
        hooks = _pop_hooks(torch, cfg, smoke, device)
        models = [init_lm(cfg, seed=s, device=device) for s in (0, 1)]
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        twins = _arena_twins(torch, cfg, hooks, models, pop_dir, work,
                             traffic, device, calls, rows)
        secs["twins"] = time.perf_counter() - t0
        del models
        _release(torch, device)
        real = _arena_roster(pop_dir, f"{work}/real")
        gcfg = _pop_cfg(smoke)
        models = [init_lm(gcfg, seed=s, device=device) for s in (0, 1)]
        t0 = time.perf_counter()
        gateway = _arena_gateway(torch, gcfg, _pop_hooks(
            torch, gcfg, smoke, device), models, real, traffic, device,
            calls, rows)
        secs["gateway"] = time.perf_counter() - t0
        _sync(torch, device)
        got = {n: fn.launches for n, fn in counters.items()}
        del models
        _release(torch, device)
        t0 = time.perf_counter()
        out_json = f"{work}/cli.json"
        cli = _run_cli(torch, serve.main, [
            "--arch", "qwen3-0.6b", "--arena", real, "--arena-policy",
            "epsilon", "--requests", "4", "--device", device, "--out-json",
            out_json, *(["--smoke"] if smoke else []), *_pop_flags(smoke)],
            "[arena]",
            re.compile(r"\brate=([^\s]+)"))
        secs["cli"] = time.perf_counter() - t0
        result = json.load(open(out_json))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    expected = {}
    for c, n in calls:
        _add(expected, _call_launches(c, c, n, True))
    expected = {n: expected[n] for n in ("paged_attention", "rmsnorm")}
    _launch_check(torch, device, {n: got[n] for n in expected}, expected,
                  "serve_arena")
    check(not any(got[n] for n in got if n not in expected)
          or not str(device).startswith("cuda"),
          f"serve_arena: a kernel off the path launched: {got}")
    members = result["arena"]["members"].values()
    stats = result["stats"]
    accounting = {"offered": sum(m["offered"] for m in members),
                  "accepted": sum(m["accepted"] for m in members),
                  "spec_draft_proposed": stats["spec_draft_proposed"],
                  "spec_draft_accepted": stats["spec_draft_accepted"]}
    cuda = str(device).startswith("cuda")
    check(cli["rc"] == 0 and len(cli["values"]) == len(members)
          and all(map(math.isfinite, cli["values"]))
          and any(cli["launches"].values()) == cuda,
          f"serve_arena: the CLI: rc={cli['rc']} rates={cli['values']} "
          f"launches={cli['launches']}")
    check(accounting["offered"] == accounting["spec_draft_proposed"] > 0
          and accounting["accepted"] == accounting["spec_draft_accepted"],
          f"serve_arena: the CLI's arena accounting {accounting}")
    secs["total"] = time.perf_counter() - t_start
    emit({"phase": "serve_arena", "arch": cfg.name, **traffic,
          "spec_tokens": SPEC_K, "twin_config": ARENA_TWIN,
          "twins": twins, "gateway": gateway,
          "cli": {k: v for k, v in cli.items() if k != "lines"}
          | {"lines": cli["lines"][-4:], "accounting": accounting,
             "champion": result["arena"]["champion"],
             "promotions": result["arena"]["promotions"]},
          "logit_rows_checked": rows[0],
          "model_calls": [n for _, n in calls],
          "launches": {n: got[n] for n in expected}, "seconds": secs})
    return {n: got[n] for n in expected}


# ---------------------------------------------------------------------------
# LTFB across process ranks
# ---------------------------------------------------------------------------


def _rank_argv(fn: str, *args) -> list:
    """A rank process running chip_smoke's ``fn(*args)``."""
    return [sys.executable, "-c", _RANK_MAIN, str(ROOT), fn,
            *map(str, args)]


def _start_ranks(mesh, argv, n, logs, name, env=None):
    """``n`` ranks of ``argv`` (torchrun's environment), each rank's
    output to ``logs/<name>.<rank>.log``."""
    def log(r):
        return open(f"{logs}/{name}.{r}.log", "w")

    return mesh.start(argv, n, env, stdout=log, stderr=log)


def _tail(logs, name, n) -> str:
    out = []
    for r in range(n):
        with open(f"{logs}/{name}.{r}.log") as f:
            out.append(f"[{name} rank {r}] " + f.read()[-3000:])
    return "\n".join(out)


def _tree_equal(torch, a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _mesh_replay(torch, orch, pre, pre_copy, log, quant) -> dict:
    """Hold this rank's round against a replay from the pair's
    pre-tournament states: the partner's is swapped again in full
    precision (a check, not the exchange), both candidates' metrics are
    recomputed on this rank's tournament batch and must equal the logged
    ones bit for bit, and so must the decision; an adopted generator is
    the partner's (int8: within half a step of it), a kept one and the
    discriminator untouched, the pre-tournament weights never written."""
    from repro_torch.core import ltfb
    from repro_torch.optim.compression import (dequantize_int8,
                                               quantize_int8)

    r, group, scope = orch._rank, orch._group, orch.cfg.scope
    j = log["partner"][r]
    leaves = ltfb.tree_leaves(pre)
    got = ltfb.swap_buffers(ltfb.pack(leaves), ltfb.global_rank(group, j),
                            group)
    other = ltfb.tree_unflatten(pre, ltfb.unpack(got, leaves))
    theirs, _ = ltfb.split_scope(other, scope)
    if quant:
        theirs = {n: dequantize_int8(*quantize_int8(t)).to(t.dtype)
                  for n, t in theirs.items()}
    _, mine_local = ltfb.split_scope(pre, scope)
    cand = ltfb.merge_scope(theirs, mine_local, scope)
    m_local = float(orch.fns.metric(pre, orch._mesh_batch))
    m_other = float(orch.fns.metric(cand, orch._mesh_batch))
    i, jj, ml, mo = log["metrics"][r]
    check((i, jj) == (r, j), f"ltfb_mesh: rank {r} logged pair {(i, jj)}")
    check((m_local, m_other) == (ml, mo),
          f"ltfb_mesh: rank {r} replayed {(m_local, m_other)} != logged "
          f"{(ml, mo)}")
    adopted = mo < ml
    post = orch.population.trainers[r].params
    check(_tree_equal(torch, post["disc"], pre_copy["disc"]),
          "ltfb_mesh: the discriminator changed in the tournament")
    check(all(_tree_equal(torch, pre[h], pre_copy[h]) for h in pre),
          "ltfb_mesh: the pre-tournament weights were written through")
    dev = 0.0
    if not adopted:
        check(_tree_equal(torch, post["gen"], pre_copy["gen"]),
              "ltfb_mesh: a kept generator changed")
    elif not quant:
        check(_tree_equal(torch, post["gen"], ltfb.split_scope(
            other, scope)[0]), "ltfb_mesh: an adopted generator is not "
              "bit-equal to the partner's")
    else:
        orig = ltfb.split_scope(other, scope)[0]
        for n, t in orig.items():
            # half a step, and the f32 roundings of x / s and q * s: two
            # ulps of the tensor's largest value
            step = float(quantize_int8(t)[1])
            slack = 2 * torch.finfo(torch.float32).eps * float(
                t.abs().max())
            d = float((post["gen"][n] - t).abs().max())
            check(d <= step / 2 + slack, f"ltfb_mesh: adopted {n} {d} "
                  f"from the partner's, half a step {step / 2}")
            dev = max(dev, d / step)
    return {"round": orch.population.round - 1,
            "partner": j, "adopted": adopted, "m_local": ml,
            "m_other": mo, "exchange_ms": log["exchange_seconds"] * 1e3,
            "wire_bytes": log["wire_bytes"],
            "exchange_bytes": log["exchange_bytes"],
            "max_dev_steps": dev}


def mesh_gan_rank(out_dir: str, device: str, *argv) -> int:
    """One rank of ltfb_mesh (a) and (b): join the job, run the
    CycleGAN's mesh tournament with the full and then the int8 exchange,
    replay every round (:func:`_mesh_replay`), write the rank's record."""
    import torch

    from repro_torch.core.tournament import TournamentOrchestrator
    from repro_torch.launch import ltfb as lt
    from repro_torch.launch import mesh

    ranks = mesh.init_ranks("gloo", device, MESH_TIMEOUT_S)
    args = lt.finish_args(lt.build_parser().parse_args(
        [*argv, "--device", device]))
    args.device = str(ranks.device)
    plan = lt.build_plan(args)            # the parent wrote the bundles
    fns = lt.build_fns(args)
    out = {"rank": ranks.rank, "world": ranks.world,
           "backend": ranks.backend, "device": str(ranks.device)}
    for name, quant in (("full", False), ("int8", True)):
        cfg = dataclasses.replace(lt.build_config(args),
                                  quantize_exchange=quant)
        orch = TournamentOrchestrator(fns, plan, cfg)
        rounds, tournament = [], orch.tournament

        def replayed():
            me = orch.population.trainers[ranks.rank]
            pre = me.params
            copy = {h: {n: t.clone() for n, t in d.items()}
                    for h, d in pre.items()}
            log = tournament()
            rounds.append(_mesh_replay(torch, orch, pre, copy, log, quant))
            return log

        orch.tournament = replayed
        t0 = time.perf_counter()
        trace = orch.run(args.rounds, args.steps_per_round)
        run_s = time.perf_counter() - t0
        st = orch.stats()
        orch.close()
        out[name] = {"rounds": rounds, "run_s": run_s,
                     "best_val": trace,
                     "wins": [d["wins"] for d in st["per_trainer"]],
                     "adoptions": [d["adoptions"] for d in st["per_trainer"]],
                     "steps": [d["steps"] for d in st["per_trainer"]]}
    with open(f"{out_dir}/gan.{ranks.rank}.json", "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def mesh_lm_rank(out_dir: str, *argv) -> int:
    """One rank of ltfb_mesh (c): ``repro_torch.launch.ltfb.main`` as
    torchrun starts it; writes the rank's exit code and kernel launches
    (every counter set to 0 just before)."""
    from repro_torch.launch import ltfb as lt

    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    rc = lt.main(list(argv))
    with open(f"{out_dir}/lm.{os.environ['RANK']}.json", "w") as f:
        json.dump({"rc": rc, "launches": {n: fn.launches
                                          for n, fn in counters.items()}}, f)
    return rc


def _nccl_refusal(device) -> str:
    """(e): ``init_ranks("nccl", ...)`` for rank 0 of two on this host's
    one card (on the CPU: nccl at all) raises ``RankLayoutError`` before
    any process group exists."""
    import torch.distributed as dist

    from repro_torch.launch import mesh

    env = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(mesh.find_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mesh.init_ranks("nccl", device, 10)
        msg = None
    except mesh.RankLayoutError as e:
        msg = str(e)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(msg is not None and not dist.is_initialized(),
          f"ltfb_mesh: nccl with two ranks on one card did not raise: {msg}")
    return msg


def _kill_drill(mesh, work, logs, device) -> dict:
    """(d): the ltfb CLI's two ranks as torchrun starts them; once rank 0
    has printed its first round, rank 1 is SIGKILLed, and rank 0 must
    exit nonzero on its own within ``--dist-timeout``."""
    import signal

    argv = [sys.executable, "-m", "repro_torch.launch.ltfb",
            *MESH_KILL_ARGS, "--device", device, "--dist-timeout",
            str(MESH_KILL_TIMEOUT_S), "--data-dir", f"{work}/kill_data"]
    procs = _start_ranks(mesh, argv, 2, logs, "kill")
    try:
        t0 = time.monotonic()
        while time.monotonic() - t0 < MESH_JOB_S:
            with open(f"{logs}/kill.0.log") as f:
                if "[ltfb] round=" in f.read():
                    break
            check(all(p.poll() is None for p in procs),
                  "ltfb_mesh: a kill-drill rank ended early:\n"
                  + _tail(logs, "kill", 2))
            time.sleep(0.05)
        os.kill(procs[1].pid, signal.SIGKILL)
        killed = time.monotonic()
        try:
            rc0 = procs[0].wait(timeout=MESH_KILL_TIMEOUT_S + 30)
        except subprocess.TimeoutExpired:
            rc0 = None
        failed_s = time.monotonic() - killed
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    check(rc0 not in (None, 0) and failed_s <= MESH_KILL_TIMEOUT_S + 5,
          f"ltfb_mesh: rank 0 after its peer's SIGKILL: rc {rc0} after "
          f"{failed_s:.1f} s (timeout {MESH_KILL_TIMEOUT_S} s)\n"
          + _tail(logs, "kill", 2))
    return {"rank0_rc": rc0, "rank1_rc": procs[1].returncode,
            "failed_after_s": round(failed_s, 3),
            "dist_timeout_s": MESH_KILL_TIMEOUT_S}


def _lm_launches(layers: int, steps: int, forwards: int) -> dict:
    """The launches of an LM tournament over qwen3 cut to ``layers``
    layers at S = 4096: ``steps`` train steps (remat full: every block's
    forward twice, 4 norms a block and the final one) and ``forwards``
    metric forwards (ltfb_lm's; in ltfb_mesh (c) one rank's, the
    tournament's two candidates and the round's validation)."""
    per_step = {"flash_attention_fwd": 2 * layers,
                "flash_attention_bwd": layers,
                "rmsnorm": 8 * layers + 1, "rmsnorm_bwd": 4 * layers + 1}
    per_fwd = {"flash_attention_fwd": layers, "flash_attention_bwd": 0,
               "rmsnorm": 4 * layers + 1, "rmsnorm_bwd": 0}
    return {n: steps * per_step[n] + forwards * per_fwd[n]
            for n in per_step}


def phase_ltfb_mesh(torch, workdir, device="cuda", smoke=False):
    """LTFB across process ranks on the one card (phase 35): (a)-(d) run
    side by side in subprocesses, (e) in this process.  Returns the
    kernel launches of (c), summed over its ranks."""
    from repro_torch.launch import ltfb as lt
    from repro_torch.launch import mesh

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=workdir)
    logs = f"{work}/logs"
    os.makedirs(logs)
    refusal = _nccl_refusal(device)
    gan_argv = MESH_ARGS + (["--smoke", "--samples", "256",
                             "--samples-per-file", "32"] if smoke else [])
    gan_argv += ["--data-dir", f"{work}/gan_data"]
    args = lt.finish_args(lt.build_parser().parse_args(
        gan_argv + ["--device", device]))
    k = args.trainers
    lt.build_plan(args)                     # the bundles, before the ranks
    gan = _start_ranks(mesh, _rank_argv("mesh_gan_rank", work, device,
                                        *gan_argv), k, logs, "gan")
    lm_argv = MESH_LM_ARGS + (["--smoke", "--seq", "64"] if smoke else [])
    lm_argv += ["--device", device, "--dist-timeout", str(MESH_TIMEOUT_S),
                "--data-dir", f"{work}/lm_data"]
    lm_k = int(lm_argv[lm_argv.index("--trainers") + 1])
    lm = _start_ranks(mesh, _rank_argv("mesh_lm_rank", work, *lm_argv),
                      lm_k, logs, "lm")
    kill = _kill_drill(mesh, work, logs, device)
    for procs, name in ((gan, "gan"), (lm, "lm")):
        rc = mesh.supervise(procs, MESH_JOB_S)
        check(rc == 0, f"ltfb_mesh: the {name} ranks exited {rc}:\n"
              + _tail(logs, name, len(procs)))
    wall_s = time.perf_counter() - t0
    ranks = []
    for r in range(k):
        with open(f"{work}/gan.{r}.json") as f:
            ranks.append(json.load(f))
    parts = {}
    for name in ("full", "int8"):
        runs = [rk[name] for rk in ranks]
        for key in ("wins", "adoptions", "steps"):
            check(all(run[key] == runs[0][key] for run in runs),
                  f"ltfb_mesh: {name} {key} differ between ranks")
        check(runs[0]["steps"] == [args.rounds * args.steps_per_round] * k,
              f"ltfb_mesh: {name} steps {runs[0]['steps']}")
        check(sum(runs[0]["wins"]) == args.rounds * k,
              f"ltfb_mesh: {name} wins {runs[0]['wins']}")
        check(all(math.isfinite(v) for run in runs for v in run["best_val"]),
              f"ltfb_mesh: {name} best_val not finite")
        rounds = [rd for run in runs for rd in run["rounds"]]
        parts[name] = {
            "adopted": sum(rd["adopted"] for rd in rounds),
            "decisions": len(rounds),
            "wins": runs[0]["wins"], "adoptions": runs[0]["adoptions"],
            "best_val": runs[0]["best_val"],
            "exchange_ms": [round(rd["exchange_ms"], 3) for rd in rounds],
            "wire_bytes_per_rank": rounds[0]["wire_bytes"],
            "exchange_bytes_logged": rounds[0]["exchange_bytes"],
            "max_dev_steps": max(rd["max_dev_steps"] for rd in rounds),
            "run_s": [round(run["run_s"], 3) for run in runs]}
    check(parts["int8"]["wire_bytes_per_rank"] * 3
          < parts["full"]["wire_bytes_per_rank"],
          "ltfb_mesh: the int8 exchange is not ~4x smaller on the wire")
    lm_out = []
    for r in range(lm_k):
        with open(f"{work}/lm.{r}.json") as f:
            lm_out.append(json.load(f))
    with open(f"{logs}/lm.0.log") as f:
        records = [json.loads(ln) for ln in f if ln.startswith("{")]
    events = [rec["event"] for rec in records]
    start = next(rec for rec in records if rec["event"] == "ltfb_start")
    check(start["backend"] == "mesh" and start["trainers"] == lm_k,
          f"ltfb_mesh: the CLI's start record {start}")
    check(events.count("ltfb_round") == 1
          and events.count("ltfb_trainer_stats") == lm_k,
          f"ltfb_mesh: the CLI's records {events}")
    with open(f"{logs}/lm.1.log") as f:
        check(not any(ln.startswith("{") for ln in f),
              "ltfb_mesh: rank 1 of the CLI printed records")
    want = _lm_launches(MESH_LM_LAYERS, 2, 3)
    lm_launches = {n: 0 for n in want}
    for r, out in enumerate(lm_out):
        check(out["rc"] == 0, f"ltfb_mesh: CLI rank {r} rc {out['rc']}")
        got = {n: out["launches"][n] for n in want}
        _launch_check(torch, device, got, want, f"ltfb_mesh CLI rank {r}")
        for n in want:
            lm_launches[n] += got[n]
    others = {n: v for out in lm_out for n, v in out["launches"].items()
              if n not in want and v}
    check(not others, f"ltfb_mesh: unexpected launches {others}")
    rnd = next(rec for rec in records if rec["event"] == "ltfb_round")
    emit({"phase": "ltfb_mesh", "dist_backend": ranks[0]["backend"],
          "ranks": k, "devices": sorted({rk["device"] for rk in ranks}),
          "gan": {"arch": "icf-cyclegan", "smoke": smoke, **parts},
          "lm": {"arch": "qwen3-0.6b", "layers": MESH_LM_LAYERS,
                 "ranks": lm_k, "events": sorted(set(events)),
                 "exchange_bytes": rnd["exchange_bytes"],
                 "tournament_s": rnd["tournament_seconds"],
                 "best_val": rnd["best_val"],
                 "launches_per_rank": [out["launches"] for out in lm_out]},
          "kill": kill, "nccl_refusal": refusal[:120],
          "wall_s": round(wall_s, 1)})
    return lm_launches


# ---------------------------------------------------------------------------
# serve_mesh: data-sharded page pools, the step plan, the distributed CLI
# ---------------------------------------------------------------------------

# (a) phase 5's traffic over in-process meshes of these data shards; (b)
# the sharded dispatch at qwen3's serve shape; (c) the distributed CLI's
# ranks on a 2,1 mesh, sharing the card over gloo
MESH_SERVE_DATA = (2, 4)
MESH_SERVE_TRAFFIC = dict(n_req=16, prompt_lens=[128, 256, 512], max_new=64,
                          slots=8)
MESH_SERVE_SMOKE_TRAFFIC = dict(n_req=6, prompt_lens=[8, 16, 24], max_new=6,
                                slots=4)
MESH_CLI = ["--arch", "qwen3-0.6b", "--requests", "8", "--slots", "8",
            "--prompt-lens", "128,256", "--max-new", "16", "--mesh", "2,1",
            "--dist-backend", "gloo", "--step-timeout", "120"]
MESH_CLI_SMOKE = ["--smoke", "--prompt-lens", "8,16", "--max-new", "8"]
# the drill's SIGKILL of rank 1: every request admitted (one a step), none
# finished (16 new tokens each)
MESH_CLI_KILL_STEP = {False: 12, True: 6}


def _mesh_serve_run(torch, cfg, model, traffic, device, data=None,
                    gaps=None, requests=None):
    """One serve run of ``traffic`` (or ``requests``) through the
    single-device scheduler (``data=None``) or the mesh scheduler at
    ``data`` shards: every logit row finite, the launches exact (per
    decode step one paged launch a shard and attention layer, the norms of
    every model call; counters set to 0 just before the run).  Returns
    (figures, tokens, launches)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import layer_specs
    from repro_torch.serve.mesh import MeshScheduler
    from repro_torch.serve.scheduler import Scheduler

    kw = dict(num_slots=traffic["slots"], block_size=16, device=device,
              max_len=max(traffic["prompt_lens"]) + traffic["max_new"])
    sched = Scheduler(cfg, model, **kw) if data is None else \
        MeshScheduler(cfg, model, mesh_shape=(data, 1), **kw)
    rows = [0]
    _check_finite(torch, sched.session, rows)
    if gaps is not None:
        _record_gaps(sched, gaps)
    reqs = requests or build_requests(cfg, traffic["n_req"],
                                      traffic["prompt_lens"],
                                      traffic["max_new"], seed=0)
    for r in reqs:
        sched.submit(r)
    _sync(torch, device)
    pa.paged_attention.launches = 0
    rn.rmsnorm.launches = 0
    results = sched.run()
    launches = {"paged_attention": pa.paged_attention.launches,
                "rmsnorm": rn.rmsnorm.launches}
    st = sched.stats.as_dict()
    what = f"serve_mesh {cfg.dtype} data={data}"
    check(st["completed"] == len(reqs) and len(results) == len(reqs),
          f"{what}: {st['completed']} of {len(reqs)} requests completed")
    attn = sum(s.kind == "a" for s in layer_specs(cfg))
    shards = data or 1
    _launch_check(torch, device, launches, {
        "paged_attention": shards * attn * st["decode_steps"],
        "rmsnorm": _norms_per_forward(cfg)
        * (st["decode_steps"] + st["prefill_chunks"])}, what)
    figures = {k: st[k] for k in SERVE_FIGURES}
    figures.update(data=data, logit_rows_checked=rows[0],
                   launches=launches,
                   paged_attention_per_decode_step=shards * attn,
                   prefill_chunks=st["prefill_chunks"])
    if data is not None:
        figures["pool"] = sched.pool.as_dict()
    del sched
    return figures, _tokens(results), launches


def _mesh_dispatch_case(torch, timer, gen, data, K, dtype):
    """(b) one case: the sharded dispatch at qwen3's serve shape (B = 8, H
    = 16 over 8 KV heads, D = 128, 16-token pages, rows of 100-600 tokens,
    the last row of every shard idle on its shard's null page) against
    its plain version and one unsharded launch over the global tables."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    B, H, Hkv, D, bs = 8, 16, 8, 128, 16
    rows = B // data
    lengths = torch.randint(100, 601, (B,), generator=gen,
                            device="cuda").tolist()
    for s in range(data):
        lengths[(s + 1) * rows - 1] = 1             # idle
    W = -(-(max(lengths) + K - 1) // bs)
    pps = rows * W                                  # usable pages a shard
    dt = getattr(torch, dtype)
    q = torch.randn((B, K, H, D), generator=gen, device="cuda").to(dt)
    kp = torch.randn((data * (pps + 1), bs, Hkv, D), generator=gen,
                     device="cuda").to(dt)
    vp = torch.randn(kp.shape, generator=gen, device="cuda").to(dt)
    tables = torch.empty((B, W), dtype=torch.int32, device="cuda")
    for s in range(data):
        base = s * (pps + 1)
        perm = torch.randperm(pps, generator=gen, device="cuda")
        tables[s * rows:(s + 1) * rows] = (base + perm).reshape(rows, W)
        for b in range(s * rows, (s + 1) * rows):
            used = -(-(lengths[b] + K - 1) // bs)
            tables[b, used:] = base + pps           # the shard's null page
            if lengths[b] == 1:
                tables[b] = base + pps
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    args = (q, kp, vp, tables, lens)
    got = ops.paged_attention_sharded(data, *args)
    want = ref.paged_attention_ref(*args)
    whole = pa.paged_attention(*args)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    err_whole = (got.float() - whole.float()).abs()
    check(bool((err <= tol + tol * want.float().abs()).all()),
          f"serve_mesh dispatch data={data} K={K} {dtype}: max |err| "
          f"{err.max().item()} over {tol}")
    check(bool((err_whole <= tol + tol * whole.float().abs()).all()),
          f"serve_mesh dispatch data={data} K={K} {dtype}: against one "
          f"unsharded launch max |err| {err_whole.max().item()}")
    return {"data": data, "K": K, "dtype": dtype, "W": W,
            "lengths": lengths, "max_abs_err": err.max().item(),
            "max_abs_err_vs_unsharded": err_whole.max().item(), "tol": tol,
            "sharded_ms": timer.ms(
                lambda: ops.paged_attention_sharded(data, *args)),
            "unsharded_ms": timer.ms(lambda: pa.paged_attention(*args)),
            "plain_ms": timer.ms(lambda: ref.paged_attention_ref(*args))}


def mesh_serve_rank(out_dir: str, name: str, *argv) -> int:
    """One rank of serve_mesh (c): ``repro_torch.launch.distributed.main``
    as torchrun starts it; writes the rank's exit code and kernel launches
    (the counters set to 0 just before)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import distributed

    counters = {"paged_attention": pa.paged_attention, "rmsnorm": rn.rmsnorm}
    for fn in counters.values():
        fn.launches = 0
    rc = distributed.main(list(argv))
    with open(f"{out_dir}/{name}.launches.{os.environ['RANK']}.json",
              "w") as f:
        json.dump({"rc": rc, "launches": {n: fn.launches
                                          for n, fn in counters.items()}}, f)
    return rc


def _stamped(proc, lines) -> None:
    """Read ``proc``'s merged output into ``lines`` as (monotonic time of
    arrival, line)."""
    for line in proc.stdout:
        lines.append((time.monotonic(), line.rstrip("\n")))


def _mesh_cli_start(work, device, smoke):
    """(c)'s jobs, all started together: the CLI's worker as 1 and as 2
    torchrun ranks, and its spawner's kill drill (rank 1 SIGKILLed at a
    step, the job restarted from rank 0's journal)."""
    import threading

    from repro_torch.launch import mesh

    logs = f"{work}/logs"
    os.makedirs(logs)
    base = MESH_CLI + (MESH_CLI_SMOKE if smoke else []) + ["--device", device]
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    jobs = {"logs": logs, "base": base}
    for name, n in (("one", 1), ("two", 2)):
        argv = base + ["--out-json", f"{work}/{name}.json"]
        jobs[name] = _start_ranks(mesh, _rank_argv("mesh_serve_rank", work,
                                                   name, *argv),
                                  n, logs, name, env)
    step = MESH_CLI_KILL_STEP[smoke]
    drill = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.distributed", *base,
         "--procs", "2", "--journal", f"{work}/drill.jsonl",
         "--fault-spec", f"kill@{step}:rank=1", "--restart-on-failure", "1",
         "--out-json", f"{work}/drill.json"],
        env=dict(env, PYTHONPATH=str(ROOT / "src")), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=_stamped, args=(drill, lines),
                              daemon=True)
    reader.start()
    jobs["drill"] = (drill, lines, reader, step)
    return jobs


def _mesh_cli_finish(torch, cfg, work, jobs, ref_tokens, gaps,
                     device) -> tuple:
    """(c)'s checks: the 1- and 2-rank runs' streams bit-identical to each
    other and to the in-process reference, rank 0's Prometheus text with
    both ranks' series, every rank's launches exact; the drill restarted
    once and its stitched streams equal to the reference's, save partings
    at a top-2 gap below the bf16 rule (counted).  Returns the part's
    figures and launches."""
    from repro_torch.launch import mesh
    from repro_torch.models.lm import layer_specs

    logs = jobs["logs"]
    for name, n in (("one", 1), ("two", 2)):
        rc = mesh.supervise(jobs[name], MESH_JOB_S)
        check(rc == 0, f"serve_mesh: the {name}-rank CLI exited {rc}:\n"
              + _tail(logs, name, n))
    drill, lines, reader, step = jobs["drill"]
    try:
        drill_rc = drill.wait(timeout=MESH_JOB_S)
    finally:
        if drill.poll() is None:
            drill.kill()
            drill.wait()
    reader.join(timeout=10)
    text = "\n".join(ln for _, ln in lines)
    check(drill_rc == 0, f"serve_mesh: the drill exited {drill_rc}:\n"
          + text[-4000:])
    outs = {}
    for name, path in (("one", "one.json"), ("two", "two.json"),
                       ("two.p1", "two.json.p1"), ("drill", "drill.json")):
        with open(f"{work}/{path}") as f:
            outs[name] = json.load(f)
    want = {str(k): v for k, v in ref_tokens.items()}
    for name in ("one", "two", "two.p1"):
        check(outs[name]["results"] == want,
              f"serve_mesh: the {name} run's streams differ from the "
              "in-process reference")
    with open(f"{work}/two.json.prom") as f:
        prom = f.read()
    follower = outs["two.p1"]["stats"]
    check(f'repro_serve_mesh_completed_total{{rank="1"}} '
          f'{follower["completed"]}' in prom
          and 'repro_serve_mesh_pool_high_water_blocks{rank="1",shard="1"}'
          in prom, "serve_mesh: rank 0's .prom lacks rank 1's series")
    launches = {"paged_attention": 0, "rmsnorm": 0}
    per_rank = []
    attn = sum(s.kind == "a" for s in layer_specs(cfg))
    for name, n in (("one", 1), ("two", 2)):
        for r in range(n):
            with open(f"{work}/{name}.launches.{r}.json") as f:
                got = json.load(f)
            st = outs[name if r == 0 else f"{name}.p{r}"]["stats"]
            check(got["rc"] == 0, f"serve_mesh: {name} rank {r} rc "
                  f"{got['rc']}")
            # a 2,1 mesh: two paged launches an attention layer a step
            _launch_check(torch, device, got["launches"], {
                "paged_attention": 2 * attn * st["decode_steps"],
                "rmsnorm": _norms_per_forward(cfg)
                * (st["decode_steps"] + st["prefill_chunks"])},
                f"serve_mesh {name} rank {r}")
            per_rank.append(got["launches"])
            for k in launches:
                launches[k] += got["launches"][k]
    killed = next((t for t, ln in lines
                   if f"SIGKILL self at step {step} (rank 1)" in ln), None)
    failed = next((t for t, ln in lines
                   if "peer process likely died" in ln
                   or "[dist] worker failure" in ln), None)
    check(killed is not None and failed is not None
          and "resuming from the generation-0 journal" in text
          and "[dist] rank=0 journal: replayed" in text,
          "serve_mesh: the drill did not kill, fail and resume:\n"
          + text[-4000:])
    partings = _partings(want, outs["drill"]["results"],
                         {(str(r), i): g for (r, i), g in gaps.items()},
                         SPEC_TIE["bfloat16"])
    check(all(p["tie"] for p in partings),
          f"serve_mesh: the resumed streams part from the uninterrupted "
          f"ones away from a tie: {partings}")
    return {"results_identical": True,
            "requests": len(want), "decode_steps": follower["decode_steps"],
            "launches_per_rank": per_rank, "plan_retries":
                outs["two"]["stats"]["plan_retries"],
            "tokens_per_s": {"one": outs["one"]["stats"]["tokens_per_s"],
                             "two": outs["two"]["stats"]["tokens_per_s"]},
            "channel": {name: outs[name]["channel"]
                        for name in ("two", "two.p1")},
            "plan_ms_per_step": 1e3 * outs["two"]["channel"]["broadcast_s"]
            / max(outs["two"]["channel"]["broadcasts"], 1),
            "stats_gather_ms_per_step": 1e3
            * outs["two"]["channel"]["gather_s"]
            / max(outs["two"]["channel"]["gathers"], 1),
            "drill": {"kill_step": step, "rank0_failed_after_s":
                      round(failed - killed, 3), "partings": partings,
                      "parting_count": len(partings)}}, launches


@exact_f32
def _mesh_f32(torch, cfg, model, traffic, device) -> tuple:
    """(a) in f32, TF32 off: the single-device scheduler's streams (top-2
    gaps recorded) against the mesh at each data shard count; a stream
    may part only at a gap below 1e-4 (counted)."""
    from repro_torch.configs.base import replace

    cfg32 = replace(cfg, dtype="float32")
    model.float()
    gaps = {}
    base, base_tokens, launches = _mesh_serve_run(
        torch, cfg32, model, traffic, device, gaps=gaps)
    runs = []
    for data in MESH_SERVE_DATA:
        fig, tokens, got = _mesh_serve_run(torch, cfg32, model, traffic,
                                           device, data=data)
        _add(launches, got)
        partings = _partings(base_tokens, tokens, gaps, SPEC_TIE["float32"])
        check(all(p["tie"] for p in partings),
              f"serve_mesh f32 data={data}: streams part from the "
              f"single-device ones away from a tie: {partings}")
        runs.append({**fig, "partings": partings,
                     "parting_count": len(partings)})
    return {"single_device": base, "mesh": runs}, launches


def phase_serve_mesh(torch, model, serve_figures, device="cuda",
                     smoke=False, start_with=None):
    """Mesh serving (phase 36, after phase 5, on its model and traffic):
    (b) the sharded dispatch on the card, (a) the in-process mesh at
    ``MESH_SERVE_DATA`` in bf16 and then in f32, (c) the distributed CLI's
    ranks, started before (a)'s f32 runs and checked after them.
    ``start_with``: called right after (c)'s ranks start (the next phase
    starts its own ranks there, so that both sets start and serve while
    this process runs the f32 references).  Returns the launches of (a)
    and (c)."""
    cfg = model.cfg
    traffic = MESH_SERVE_SMOKE_TRAFFIC if smoke else MESH_SERVE_TRAFFIC
    launches = {"paged_attention": 0, "rmsnorm": 0}
    cuda = str(device).startswith("cuda")
    if cuda:
        timer = Timer(torch)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        dispatch = [_mesh_dispatch_case(torch, timer, gen, data, K, dtype)
                    for data in MESH_SERVE_DATA for K in (1, 5)
                    for dtype in ("bfloat16", "float32")]
        del timer
        emit({"phase": "serve_mesh", "part": "dispatch", "cases": dispatch})
    runs = []
    for data in MESH_SERVE_DATA:
        fig, _, got = _mesh_serve_run(torch, cfg, model, traffic, device,
                                      data=data)
        _add(launches, got)
        runs.append(fig)
    emit({"phase": "serve_mesh", "part": "inprocess", "arch": cfg.name,
          "dtype": cfg.dtype, **{k: traffic[k] for k in traffic},
          "single_device": serve_figures, "mesh": runs})
    # (c)'s reference: the CLI's trace through this process's mesh
    from repro_torch.launch.distributed import build_parser
    from repro_torch.launch.serve import build_requests, parse_lens

    argv = MESH_CLI + (MESH_CLI_SMOKE if smoke else [])
    args = build_parser().parse_args(argv)
    cli_traffic = dict(n_req=args.requests, slots=args.slots,
                       prompt_lens=parse_lens(args.prompt_lens),
                       max_new=args.max_new)
    gaps = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_mesh_")
    try:
        _, ref_tokens, got = _mesh_serve_run(
            torch, cfg, model, cli_traffic, device, data=2, gaps=gaps,
            requests=build_requests(cfg, args.requests,
                                    cli_traffic["prompt_lens"],
                                    args.max_new, seed=args.seed))
        _add(launches, got)
        jobs = _mesh_cli_start(work, device, smoke)
        if start_with is not None:
            start_with()
        f32, got = _mesh_f32(torch, cfg, model, traffic, device)
        _add(launches, got)
        emit({"phase": "serve_mesh", "part": "f32", **f32})
        cli, got = _mesh_cli_finish(torch, cfg, work, jobs, ref_tokens,
                                    gaps, device)
        _add(launches, got)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "serve_mesh", "part": "distributed", **cli,
          "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# serve_tp: the serving mesh's model axis across process ranks
# ---------------------------------------------------------------------------

# (b) the distributed CLI on a 1,2 mesh: two model ranks of qwen3-0.6b
# FULL sharing the card over gloo, a slice of phase 5's traffic, in bf16
# and in f32; (c) a SIGKILLed model rank
TP_CLI = ["--arch", "qwen3-0.6b", "--requests", "8", "--slots", "8",
          "--prompt-lens", "128,256,512", "--max-new", "16", "--mesh", "1,2",
          "--dist-backend", "gloo", "--step-timeout", "120"]
TP_CLI_SMOKE = ["--smoke", "--prompt-lens", "8,16", "--max-new", "8"]
TP_DRILL = ["--requests", "4", "--max-new", "16", "--step-timeout", "30",
            "--fault-spec", "kill@6:rank=1"]


TP_RUNS = (("bf16", []), ("f32", ["--dtype", "float32"]))


def tp_serve_rank(out_dir: str, ports: str, *argv) -> int:
    """One rank of serve_tp: ``repro_torch.launch.distributed.main`` as
    torchrun starts it, three times in this process, each on a
    rendezvous port of its own (``ports``: the second and third): (b) in
    bf16 and in f32, each run's kernel launches counted (the counters set
    to 0 just before it) and written beside its ``--out-json``; then (c)
    the drill, in which rank 1 SIGKILLs itself and rank 0 fails (the
    worker's hard exit ends this process)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import distributed

    counters = {"paged_attention": pa.paged_attention, "rmsnorm": rn.rmsnorm}
    more = ports.split(",")
    for i, (name, extra) in enumerate(TP_RUNS):
        if i:
            os.environ["MASTER_PORT"] = more[i - 1]
        for fn in counters.values():
            fn.launches = 0
        rc = distributed.main(list(argv) + extra
                              + ["--out-json", f"{out_dir}/{name}.json"])
        with open(f"{out_dir}/{name}.launches.{os.environ['RANK']}.json",
                  "w") as f:
            json.dump({"rc": rc, "launches": {
                n: fn.launches for n, fn in counters.items()}}, f)
    os.environ["MASTER_PORT"] = more[-1]
    print("[serve_tp] drill", flush=True)
    return distributed.main(list(argv) + TP_DRILL)


def serve_tp_start(work, device="cuda", smoke=False) -> dict:
    """serve_tp's two ranks (:func:`tp_serve_rank`: (b) in bf16, then in
    f32, then (c)'s drill, in one pair of processes), started in
    ``work``; their output is read line by line with its arrival
    times."""
    import threading

    from repro_torch.launch import mesh

    base = TP_CLI + (TP_CLI_SMOKE if smoke else []) + ["--device", device]
    ports = set()
    while len(ports) < 2:
        ports.add(mesh.find_free_port())
    procs = mesh.start(
        _rank_argv("tp_serve_rank", work, ",".join(map(str, ports)), *base),
        2, dict(os.environ, PYTHONUNBUFFERED="1"),
        stdout=lambda r: subprocess.PIPE, stderr=lambda r: subprocess.STDOUT)
    lines = {0: [], 1: []}
    readers = []
    for r, proc in enumerate(procs):
        proc.stdout = io.TextIOWrapper(proc.stdout, errors="replace")
        readers.append(threading.Thread(target=_stamped,
                                        args=(proc, lines[r]), daemon=True))
        readers[-1].start()
    return {"work": work, "procs": procs, "lines": lines,
            "readers": readers}


def serve_tp_stop(jobs) -> None:
    """Kill whatever of serve_tp's ranks still runs (a failed check must
    leave no process behind)."""
    for p in jobs.get("procs", ()):
        if p.poll() is None:
            p.kill()
            p.wait()


def _tp_wait(jobs) -> dict:
    """Wait for serve_tp's ranks: the drill ends them, rank 1 by its
    SIGKILL and rank 0 on its own, naming the dead peer, within the step
    timeout.  Returns (c)'s figures."""
    procs, lines = jobs["procs"], jobs["lines"]
    try:
        rcs = [p.wait(timeout=MESH_JOB_S) for p in procs]
    finally:
        serve_tp_stop(jobs)
    for t in jobs["readers"]:
        t.join(timeout=10)
    text = {r: "\n".join(ln for _, ln in lines[r]) for r in lines}
    jobs["text"] = text
    drill_t = next((t for t, ln in lines[1] if "[serve_tp] drill" in ln),
                   None)
    killed = next((t for t, ln in lines[1]
                   if "SIGKILL self at step 6 (rank 1)" in ln), None)
    failed = next((t for t, ln in lines[0]
                   if "peer process likely died" in ln), None)
    limit = float(TP_DRILL[TP_DRILL.index("--step-timeout") + 1])
    check(rcs[1] == -9 and rcs[0] == 1 and None not in (drill_t, killed,
                                                        failed),
          f"serve_tp: the drill did not kill rank 1 and fail rank 0 (rc "
          f"{rcs}):\n" + text[0][-3000:] + "\n" + text[1][-1500:])
    check(failed - killed < limit, f"serve_tp: rank 0 failed "
          f"{failed - killed:.3f} s after its peer's SIGKILL, over the "
          f"{limit} s step timeout")
    return {"kill_step": 6, "rcs": rcs, "step_timeout_s": limit,
            "rank0_failed_after_s": round(failed - killed, 3)}


def _tp_job(torch, cfg, jobs, name, dtype, ref_tokens, gaps,
            device) -> tuple:
    """(b) one run: both ranks' streams equal (the gathered logits) and
    equal the single-device scheduler's save partings at a top-2 gap
    below ``dtype``'s rule (counted); each rank's launches exact (one
    paged launch an attention layer a decode step over its 8 q heads, the
    norms of every model call); the model group's collectives a decode
    step.  Returns the run's figures and launches."""
    from repro_torch.models.lm import layer_specs

    work = jobs["work"]
    outs = []
    for r in range(2):
        path = f"{work}/{name}.json" + (f".p{r}" if r else "")
        check(os.path.exists(path), f"serve_tp: no {name} output of rank "
              f"{r}:\n" + jobs["text"][r][-3000:])
        with open(path) as f:
            outs.append(json.load(f))
    check(outs[0]["results"] == outs[1]["results"],
          f"serve_tp {name}: the two model ranks' streams differ")
    want = {str(k): v for k, v in ref_tokens.items()}
    partings = _partings(want, outs[0]["results"],
                         {(str(r), i): g for (r, i), g in gaps.items()},
                         SPEC_TIE[dtype])
    check(all(p["tie"] for p in partings),
          f"serve_tp {name}: streams part from the single-device ones "
          f"away from a tie: {partings}")
    attn = sum(s.kind == "a" for s in layer_specs(cfg))
    launches = {"paged_attention": 0, "rmsnorm": 0}
    per_rank = []
    for r in range(2):
        with open(f"{work}/{name}.launches.{r}.json") as f:
            got = json.load(f)
        st = outs[r]["stats"]
        check(got["rc"] == 0, f"serve_tp {name} rank {r} rc {got['rc']}")
        _launch_check(torch, device, got["launches"], {
            "paged_attention": attn * st["decode_steps"],
            "rmsnorm": _norms_per_forward(cfg)
            * (st["decode_steps"] + st["prefill_chunks"])},
            f"serve_tp {name} rank {r}")
        per_rank.append(got["launches"])
        for k in launches:
            launches[k] += got["launches"][k]
    st = outs[0]["stats"]
    mg = outs[0]["model_group"]
    steps = max(st["decode_steps"], 1)
    check(mg["decode"]["calls"] == (2 * attn + 2) * st["decode_steps"],
          f"serve_tp {name}: {mg['decode']['calls']} model-group "
          f"collectives in {st['decode_steps']} decode steps, not "
          f"{2 * attn + 2} a step")
    return {"dtype": dtype, "requests": len(want),
            "tokens_per_s": st["tokens_per_s"],
            "tpot_mean_s": st["tpot_mean_s"],
            "ttft_p50_s": st["ttft_p50_s"],
            "decode_steps": st["decode_steps"],
            "paged_attention_per_decode_step_per_rank":
                per_rank[0]["paged_attention"] / steps,
            "launches_per_rank": per_rank,
            "collectives_per_decode_step": mg["decode"]["calls"] / steps,
            "collective_ms_per_decode_step":
                1e3 * mg["decode"]["seconds"] / steps,
            "collective_bytes_per_decode_step": mg["decode"]["bytes"] / steps,
            "model_group_all": mg["all"],
            "plan_ms_per_step": 1e3 * outs[0]["channel"]["broadcast_s"]
            / max(outs[0]["channel"]["broadcasts"], 1),
            "partings": partings, "parting_count": len(partings)}, launches


@exact_f32
def _tp_f32_ref(torch, cfg, traffic, device, reqs) -> tuple:
    """The single-device scheduler over (b)'s trace in f32, TF32 off (its
    top-2 gaps recorded), on the weights the CLI's ``--dtype float32``
    draws: ``init_lm`` from the seed in f32, not bf16 weights cast up."""
    from repro_torch.configs.base import replace
    from repro_torch.models.lm import init_lm

    gaps = {}
    cfg32 = replace(cfg, dtype="float32")
    model = init_lm(cfg32, seed=0, device=device)
    fig, tokens, launches = _mesh_serve_run(
        torch, cfg32, model, traffic, device, gaps=gaps, requests=reqs)
    del model
    return fig, tokens, gaps, launches


def phase_serve_tp(torch, model, serve_figures, device="cuda", smoke=False,
                   jobs=None):
    """The serving mesh's ``model`` axis (phase 37, after serve_mesh, on
    phase 5's model): (a) the paged kernel and RMSNorm at a model rank's
    shapes (qwen3 at model 2: 8 q heads over 4 kv heads), (b) the
    distributed CLI on a 1,2 mesh in bf16 and f32 against the
    single-device scheduler in this process on the same weights and
    trace, (c) a SIGKILLed model rank.  ``jobs``: (b)'s and (c)'s ranks
    when :func:`serve_tp_start` started them already (main starts them
    inside serve_mesh's window of ranks); else they start here.  Returns
    the launches of (b) and the single-device references, and (a)'s
    cases."""
    from repro_torch.configs.base import replace
    from repro_torch.launch.distributed import build_parser
    from repro_torch.launch.serve import build_requests, parse_lens

    t_phase = time.perf_counter()
    cuda = str(device).startswith("cuda")
    cases = {"paged_attention": [], "rmsnorm": []}
    if cuda:
        timer = Timer(torch)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        lengths = torch.randint(170, 570, (8,), generator=gen,
                                device="cuda").tolist()
        cases["paged_attention"].append(_paged_check(
            torch, timer, gen, 8, 8, 4, 128, 16, 1, "bfloat16", lengths))
        cases["rmsnorm"].append(_rms_check(torch, timer, gen, (8, 4, 128),
                                           "bfloat16"))
        del timer
        emit({"phase": "serve_tp", "part": "kernels", "cases": [
            {k: c[k] for k in ("kernel", "dtype", "max_abs_err",
                               "kernel_ms", "plain_ms", "bound_ms",
                               "library_ms") if k in c}
            for rows in cases.values() for c in rows]})
    cfg = replace(model.cfg, dtype="bfloat16")
    args = build_parser().parse_args(TP_CLI + (TP_CLI_SMOKE if smoke
                                               else []))
    traffic = dict(n_req=args.requests, slots=args.slots,
                   prompt_lens=parse_lens(args.prompt_lens),
                   max_new=args.max_new)
    reqs = build_requests(cfg, args.requests, traffic["prompt_lens"],
                          args.max_new, seed=args.seed)
    launches = {"paged_attention": 0, "rmsnorm": 0}
    if jobs is None:
        jobs = serve_tp_start(tempfile.mkdtemp(prefix="chip_smoke_serve_tp_"),
                              device, smoke)
    work = jobs["work"]
    try:
        # the references while the ranks start: f32 on the f32 draw, then
        # bf16 on phase 5's model (f32 after serve_mesh; f32 -> bf16 is
        # exact, the CLI's bf16 draw)
        f32_fig, f32_tokens, f32_gaps, got = _tp_f32_ref(
            torch, cfg, traffic, device, reqs)
        _add(launches, got)
        model.to(torch.bfloat16)
        bf16_gaps = {}
        bf16_fig, bf16_tokens, got = _mesh_serve_run(
            torch, cfg, model, traffic, device, gaps=bf16_gaps,
            requests=reqs)
        _add(launches, got)
        refs_s = time.perf_counter() - t_phase
        drill = _tp_wait(jobs)
        runs = {}
        for name, dtype, tokens, gaps in (
                ("bf16", "bfloat16", bf16_tokens, bf16_gaps),
                ("f32", "float32", f32_tokens, f32_gaps)):
            runs[name], got = _tp_job(torch, cfg, jobs, name, dtype, tokens,
                                      gaps, device)
            _add(launches, got)
    finally:
        serve_tp_stop(jobs)
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "serve_tp", "part": "distributed", "arch": cfg.name,
          "mesh": "1,2", **traffic, "ranks": runs,
          "single_device": {"bf16": bf16_fig, "f32": f32_fig},
          "phase5": serve_figures, "drill": drill, "launches": launches,
          "refs_done_s": refs_s, "wall_s": time.perf_counter() - t_phase})
    return launches, cases


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repo (src/repro_torch "
              "not found next to this script)", file=sys.stderr)
        return 2
    # grow the caching allocator's segments instead of cutting new ones:
    # with fixed segments train_vlm's (B, S, V) f32 logits gradient (4.6
    # GiB) found no free block among ~30 GiB cached in other sizes and ran
    # out of memory with 47 GiB allocated on an H100 80GB
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    smi_line = phase_card(torch)
    phase_build(torch)
    timer = Timer(torch)
    # the plain flash references and scans take 10 ms-0.6 s a call: a
    # median of 5
    plain_timer = Timer(torch, reps=5, warmup=1)
    cases = phase_kernels(torch, timer)
    for more in (phase_train_kernels(torch, timer, plain_timer),
                 phase_recurrent_kernels(torch, timer, plain_timer),
                 phase_arch_kernels(torch, timer, plain_timer),
                 phase_recurrent_bwd_kernels(torch, timer, plain_timer)):
        for name, rows in more.items():
            cases.setdefault(name, []).extend(rows)
    del timer, plain_timer
    release(torch)
    serve_launches, serve_figures, serve_model = phase_serve(torch)
    release(torch)
    # serve_tp's ranks start and serve inside serve_mesh's window of ranks
    tp_jobs = {}
    try:
        mesh_serve_launches = phase_serve_mesh(
            torch, serve_model, serve_figures,
            start_with=lambda: tp_jobs.update(serve_tp_start(
                tempfile.mkdtemp(prefix="chip_smoke_serve_tp_"))))
    except BaseException:
        if tp_jobs:
            serve_tp_stop(tp_jobs)
            shutil.rmtree(tp_jobs["work"], ignore_errors=True)
        raise
    release(torch)
    tp_launches, tp_cases = phase_serve_tp(torch, serve_model, serve_figures,
                                           jobs=tp_jobs)
    for name, rows in tp_cases.items():
        cases[name].extend(rows)
    del serve_model
    release(torch)
    phase_recompute(torch)
    release(torch)
    dense_launches = phase_serve_dense(torch, serve_figures)
    release(torch)
    phase_recompute_dense(torch)
    release(torch)
    lifecycle_launches = phase_serve_lifecycle(torch)
    release(torch)
    train_launches, _ = phase_train(torch)
    release(torch)
    remat_launches = phase_train_remat(torch)
    release(torch)
    phase_train_parity(torch)
    release(torch)
    recurrent_launches = phase_serve_recurrent(torch)
    phase_recompute_recurrent(torch)
    release(torch)
    phase_gan_parity(torch)
    release(torch)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        surrogate_dirs = phase_ltfb(torch, workdir=work)
        release(torch)
        mesh_launches = phase_ltfb_mesh(torch, work)
        release(torch)
        lm_launches, lm = phase_ltfb_lm(torch, work)
        release(torch)
        spec_launches, spec_cases = phase_serve_spec(torch, lm["pop"])
        cases["paged_attention"].extend(spec_cases)
        release(torch)
        swap_launches = phase_serve_swap(torch, lm["pop"], work)
        release(torch)
        arena_launches = phase_serve_arena(torch, lm["pop"], work)
        release(torch)
        phase_surrogate(torch, *surrogate_dirs)
        release(torch)
        phase_clis(torch, work, surrogate_dirs[0], lm)
        release(torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    arch_launches = phase_serve_archs(torch)
    arch_launches.update(phase_serve_moe(torch))
    phase_recompute_archs(torch)
    release(torch)
    arch_launches["train_moe"] = phase_train_moe(torch)
    arch_launches["train_vlm"] = phase_train_vlm(torch)
    release(torch)
    arch_launches.update(phase_train_recurrent(torch))
    release(torch)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        arch_launches["ltfb_recurrent"] = phase_ltfb_recurrent(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # the kernels line reports each kernel at the shape its path gives it
    # most: paged attention and the RMSNorm forward at the serve decode
    # shape (bf16, one query token, head_dim 128 / d = 1024), the training
    # kernels at the train cell's (bf16, B = 4, S = 4096; 16384 x 1024),
    # the scans at the recurrent serve phases' longest prompt (f32, B = 1,
    # S = 500)
    headline = {
        "paged_attention": lambda c: (c["dtype"], c["D"], c["K"])
        == ("bfloat16", 128, 1),
        "rmsnorm": lambda c: (c["dtype"], c["shape"]) == ("bfloat16",
                                                          [8, 1024]),
        "rmsnorm_bwd": lambda c: c["shape"] == [TRAIN_B * TRAIN_S, 1024],
        "flash_attention_fwd": lambda c: (c["dtype"], c["B"], c["S"],
                                          c["Hkv"])
        == ("bfloat16", TRAIN_B, TRAIN_S, 8),
        "flash_attention_bwd": lambda c: (c["dtype"], c["B"], c["S"],
                                          c["Hkv"])
        == ("bfloat16", TRAIN_B, TRAIN_S, 8),
        "mamba_scan": lambda c: (c["B"], c["S"]) == (1, 500),
        "slstm_scan": lambda c: (c["B"], c["S"]) == (1, 500),
        "mamba_scan_bwd": lambda c: (c["B"], c["S"]) == (2, 4096),
        "slstm_scan_bwd": lambda c: (c["B"], c["S"]) == (4, 4096)}
    by_path = {"serve": serve_launches, "serve_dense": dense_launches,
               "serve_lifecycle": lifecycle_launches,
               "train": train_launches, "train_remat": remat_launches,
               **recurrent_launches, "ltfb_lm": lm_launches,
               "serve_swap": swap_launches, "serve_spec": spec_launches,
               "serve_arena": arena_launches,
               "ltfb_mesh": mesh_launches, "serve_mesh": mesh_serve_launches,
               "serve_tp": tp_launches,
               **arch_launches}
    kernels = []
    for name, rows in cases.items():
        main_case = next(c for c in rows if headline[name](c))
        counts = {path: launches[name] for path, launches in by_path.items()
                  if name in launches}
        kernels.append({
            "name": name, "route": ROUTES[name], "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(counts.values()),
            "launches_by_path": counts,
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "checks_passed": len(rows)})
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
