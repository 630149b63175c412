#!/usr/bin/env python3
"""Drive the port's paths on an NVIDIA card; hold every CUDA kernel against
its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure ends the run with a non-zero exit and no last line):

1. Device: the card's name and power limit, as nvidia-smi prints them.
2. Build: every source in src/repro_torch/kernels/csrc, one nvcc each, all
   started together, into build/repro_torch; each library's kernels,
   registers and spill bytes from ptxas' report.
3. Kernels against their plain versions on the card, at the main paths'
   shapes and a few others, with CUDA-event timing (100 launches after a
   warm-up; 10 for the plain gated linear recurrence) of the kernel, the
   plain version and the one PyTorch call that computes the same function
   where there is one (timed as a yardstick only; the port never calls it).
   ns_update is also timed at the solver's per-step calls (U[:1] and U[:8]
   of an NFE-8 request), and its device time and addmv's are read from
   torch.profiler beside the host-inclusive times, and its time a launch
   replayed from one CUDA graph of 100 launches (the serving programs'
   cost). Flash attention prints its achieved TFLOP/s and kernel / bound.
   Paged attention has no such call: a dense SDPA over a pre-gathered copy
   is timed beside it, labelled "dense SDPA, gather excluded"; its device
   time is read from torch.profiler at the decode cell and the long rows,
   beside the host-inclusive time. gla_scan has
   none either, and is held against its step-by-step oracle, taken in f64
   on the same inputs; each case prints which of its two kernels ran
   (tensor-core for bf16 q, k, v with dk, dv multiples of 16 up to 128 and a
   chunk of 16, 32 or 64; CUDA-core otherwise) and fails if the library's
   choice differs from that rule. Its bound takes the peak of the type the
   products run in (bf16 for bf16 inputs), with the f32 CUDA-core count
   beside it. TF32 is off. zamba2-2.7b's main-path cases: flash at B=4
   H=32 KV=32 L=1024 hd=80, causal, bf16 (G 1), and gla_scan at its SSD
   shape (4, 1024, 80, dk 64, dv 64, chunk 64, inclusive, one f32 decay a
   head) with q and k broadcast over the heads as the model makes them
   (stride-0 views into one (B, L, conv_dim) product); its bound counts
   each stored byte once (q and k once, not once a head) and the line also
   prints the bytes with q and k read by every (b, h) block.
3c. Backward kernels against their plain versions on the same card inputs:
   the ns_update backward at the flow cell's k = 1 and k = 8 live rows (and
   bf16, a ragged D, k = 64), its dot products held to TOL times the sum of
   their terms' magnitudes, each case's bits equal on a second call and
   replayed from a CUDA graph; the flash backward in bf16 and f32 at the flow cell's
   shape, non-causal, at a ragged L and at small GQA shapes (bf16 under
   FLASH_BWD_BF16, f32 under 4 TOL), each after the forward kernel's lse is
   held against the plain log-sum-exp. Timed (CUDA events) beside the plain
   version and, for flash, torch autograd of SDPA's backward (a yardstick
   only); flash prints achieved TFLOP/s at the algorithm's 10 hd flops a
   kept pair and at the executed count (20 hd in bf16: S and dP in both
   passes, P and dS in two parts; 14 in f32), kernel / bound, and the device
   time of each pass (dq, dk/dv) from torch.profiler by kernel name; the
   ns_update backward its device time at the flow cell. Both backward
   kernels at the flow cell are also timed a launch replayed from one CUDA
   graph of 100 launches (the training programs' cost). Since PR 30 the
   flash backward also at the shapes of the families it newly trains, on
   the CUDA cores (bf16 widened as staged): zamba2-2.7b's shared attention
   (B=4, 32 / 32 heads of 80, L 1024, causal), whisper-medium's decoder
   (16 / 16 heads of 64, L 1024, causal) and its cross-attention (Lq 1024,
   Lk 1500, full) twice: the dq pass alone (distillation: the memory
   carries no gradient; its bound and flops count S, dP and dQ, 6 hd a
   pair, and SDPA's backward is taken in q only) and whole (training); and
   f32 cases at hd 80 and 64; and, bf16 causal at hd 128, internvl2-26b's
   decoder (B=4, 48 / 8 heads, L 1280: G 6), phi3-medium-14b's (40 / 10,
   L 1024: G 4) and yi-34b's (56 / 8: G 7), the groups phases 33 and 34
   differentiate. And the gla_scan backward (gla_scan_bwd)
   against ``gla_chunked_bwd`` taken in f64 on the same inputs, relative L2
   of each gradient <= GLA_BWD_TOL (f32 1e-5, bf16 2e-2; a gradient kept in
   f32 for bf16 inputs, GLA_BWD_F32_OUT_TOL 1e-3): rwkv6-7b's flow
   shape (exclusive, bf16, per-channel f32 decay of the model's size),
   zamba2-2.7b's (inclusive, q and k one group broadcast over 80 heads, one
   f32 decay a head), and ragged cases (L 1000) with s0 and dS_final in f32
   and bf16; each case prints which kernel ran (``bwd_kernel_for``:
   tensor-core for bf16 q, k, v under the forward's rule, CUDA-core
   otherwise) and fails if that differs from the rule; kernel and device ms, the plain backward's ms (in the inputs' types), no
   library call ("none: no one PyTorch call"), the bound at the peak of the
   inputs' type (bytes: q, k, v, dO, ld read once, dq, dk, dv, dld written
   once; flops ``gla_bwd_flops``) with the f32 CUDA-core count beside it.
3d. The flash forward with its log-sum-exp and the flash backward at the
   backbone trainer's shape (phase 24a: batch TRAIN_BATCH = 8, L TRAIN_SEQ =
   64, 32 / 4 heads of 128, bf16, causal), each against its plain version on
   the same card inputs (FLASH_BF16, the lse under 4 TOL (1 + |lse|),
   FLASH_BWD_BF16), timed beside the plain version and SDPA's forward /
   torch autograd of SDPA's backward, with each one's bound.
4. Flow path: ``repro_torch.launch.serve.main`` with yi-6b at full width
   (32 layers, bf16, random weights from a seeded generator on the card),
   NFE 8, batch 4, sequence 1024, 3 requests. Launch counts must be exact.
4b. Baselines served at full width: for each of ddim, dpm2m and edm_heun
   (BASELINES), ``SolverSpec(name, 8).build`` for yi-6b's fm_ot field, saved
   as a baseline ``ns`` artifact under build/chip_smoke/ and served by
   ``serve.main`` with phase 4's flags plus ``--requests 2
   --solver-artifact`` (``FlowSampler.from_artifact``). Each request must
   launch ns_update 8 and flash attention 256 times, exactly; the zoo must
   report loads=1 distills=0, "no retraining" be printed, the served
   NSParams equal the built ones to the bit and the latents be finite.
   Each request's ms is printed beside the card's name and power limit.
5. The flow path on the card (kernels) against the CPU (plain versions):
   yi-6b width cut to 2 layers, f32, euler NFE 4, relative L2 <= 1e-4.
5b. The new solver paths on the card against the CPU, phase 5's model and
   limit: ddim, dpm2m and edm_heun at NFE 8 under fm_ot and vp (each 8
   ns_update and 16 flash launches), midpoint with sigma0 = 2, and a
   BST-Euler solver at NFE 4 with random knots, once run directly
   (``taxonomy.run_direct``: 8 flash launches, no ns_update) and once
   through its ``to_ns`` parameters sampled by ``ns_sample`` (4 ns_update
   launches), both against the CPU's direct run. Each case prints its error
   (the baselines beside their largest |a| and |b|); all are run before a
   failure ends the phase.
6. Decode path: ``repro_torch.launch.serve.main`` in decode mode, yi-6b at
   full width, 16 requests through the paged gateway with the paged kernel.
   Every request must finish at its length with in-vocabulary tokens, no
   request may fail, every page must return to the pool, and paged
   attention must launch 32 times per ``decode_apply`` call (counted apart
   from the kernel's own counter); the flow kernels launch 0 times.
6b. Long-row decode step: the same yi-6b weights at full width over a paged
   state of 8 rows of 256 pages of 16 (the decode cell's f32 slot state,
   ~4.3 GB), each row on its own shuffled pages past the trash page 0 with
   seeded random K/V, at positions LONG_LENGTHS - 1. One ``decode_apply``
   call with the paged kernel and one with the reference's dense gather are
   timed (CUDA events, 5 calls after 2 warm-up calls), with the kernel's
   device time from torch.profiler; the kernel launches exactly 32 times a
   call. With bf16 weights the dense gather rounds scores and softmax
   weights to bf16 (the reference's rounding order), so the two paths'
   logits are compared, by phase 7's rule (relative L2 <= 1e-4, the same
   greedy tokens), on an f32 copy of the same weights; the bf16 difference
   is printed beside it.
7. The decode path on the card (kernel) against the CPU (plain version):
   the same 2-layer f32 model and the same gateway requests; every step's
   logits within relative L2 1e-4 and the same greedy tokens.
8. Flow path of rwkv6-7b at full width (32 layers, bf16), as phase 4, after
   the yi-6b weights are freed: gla_scan 32 x 8 x 3 = 768 launches,
   ns_update 24, the attention kernels 0.
9. Phase 5 for rwkv6-7b: its width cut to 2 layers, f32; gla_scan launches
   2 x 4 times on the card, the CPU runs the plain chunked form.
10. Decode path of rwkv6-7b at full width: 8 requests through the gateway
    on 4 slots, max_tokens cycling 32/16; every request finishes at its
    length with in-vocabulary tokens and no kernel launches (decode steps
    the recurrence in plain torch, as the reference does).
11. Phase 7 for rwkv6-7b's 2-layer f32 model.
12. Distillation at full width: ``repro_torch.launch.serve.main`` with
    yi-6b at DISTILL_LAYERS = 4 of its 32 layers (``launcher_depth``; 32
    in PRs 27-29, when phases 12-12d took ~530 s of the script's limit;
    phases 12-12d all run at this depth), NFE 8, batch 4, seq 1024,
    ``--bns-iters`` DISTILL_ITERS, 2
    requests and ``--solver-artifact`` BNS_ARTIFACT (deleted first, so the
    solver zoo misses and distils): RK45 pairs (train and val), the initial
    solver's val PSNR, DISTILL_ITERS training iterations (each layer
    recomputed in the backward), the final validation, the artifact saved
    and reloaded (no launches), the requests with the reloaded solver. The
    RK45 solves run as the card's default: one captured step program
    (``core/rk45.py::RK45Program``, the seven evaluations and the error
    norm) shared by the train and val solves, replayed every step; the
    training likewise: one captured step and one captured validation
    (``bns.TrainLoop``), replayed. The RK45 seconds and the step program's
    captures and replays are printed. The zoo must report
    distills=1. Launch counts must be exact. With R the RK45 evaluations of both
    solves, K = DISTILL_ITERS and N = DISTILL_LAYERS: flash forward N (R +
    8 + 8 + 2 * 8) for the no-grad calls plus N * 8 * 2 * K in training
    (every layer's forward and its recompute; the first velocity call of a
    step also differentiates, since t_0 is an entry of the time grid built
    from theta), flash backward N * 8 * K, ns_update forward 8 (1 + 1 + 2 +
    K), ns_update backward 8 K: an iteration is 16 N flash forward, 8 N flash
    backward, 8 and 8 ns_update launches, a request 8 N flash forward and 8
    ns_update. Loss and
    PSNR finite, the distilled val PSNR at least the initial solver's (with K
    under val_every, the final validation is the only one).
12b. The artifact reload: phase 12's flags again, in a fresh ``main``
    call. It must print "no retraining", report zoo loads=1 and distills=0,
    launch exactly what 2 requests launch (flash forward N x 8 x 2, ns_update
    16, no backward kernel, no RK45 evaluation), serve NSParams equal to
    phase 12's to the bit and give both requests' latents equal to phase
    12's to the bit (same seeds, weights and deterministic kernels).
12c. Anytime at full width: yi-6b, ``--budgets 4,8 --request-budgets
    4,8,16``, batch 4, seq ANYTIME_SEQ, ``--bns-iters`` ANYTIME_ITERS, 3
    requests, ``--solver-artifact`` ANYTIME_ARTIFACT (deleted first), at
    DISTILL_LAYERS layers (``launcher_depth``; 16 in PRs 25-26, 32 in PRs
    27-29). With R the RK45 evaluations of both solves, K =
    ANYTIME_ITERS and N = DISTILL_LAYERS: flash forward N (R + 8 + 8 + 20)
    for the no-grad calls (the initial solver's and the final validation's
    shared trajectory, 8 evaluations each; the requests at 4, 8 and 16 -> 8
    NFE) plus N x 8 x 2 K in training, flash backward N x 8 K, ns_update
    9 + 9 + 20 + 9 K (a trajectory runs 8 intermediate rules and the
    budget-4 exit; a request at m NFE m rules), ns_update backward 9 K: an
    iteration is 16 N flash forward, 8 N flash backward, 9 and 9 ns_update
    launches. The nearest-budget WARNING for 16 is printed
    exactly once; loss and PSNR finite. Then, on the served
    ``AnytimeFlowSampler`` and one seeded x0, each equal to the bit:
    ``sample_all_from(x0)[m]`` and ``sample_from(x0, m)`` for m in (4, 8);
    ``carry_start`` -> ``carry_extend(4)`` -> ``carry_extend(8)`` and
    ``sample_all_from``.
12d. BST distilled at full width and N = DISTILL_LAYERS layers: yi-6b's
    field with each layer recomputed (as ``serve._distill_artifact`` builds
    it), one ``bns.generate_pairs``
    call of BST_PAIRS = 8 samples at seq BST_SEQ = 256 (one RK45 solve,
    graphed, its evaluations read from the solve's result; the conditioning
    batch of 4 rows taken twice, so the 4 train and 4 val rows share it;
    flash forward N per evaluation), Euler's val PSNR through
    ``ns_sample`` (8 ns_update, 8 N flash), then ``SolverSpec("euler", 8,
    mode="bst").distill`` for BST_ITERS = 4 full-batch iterations: flash
    forward 16 N and backward 8 N an iteration plus 8 N forward for the
    final validation, and no ns_update launch (``run_direct`` bypasses it).
    Loss and PSNR finite, the BST val PSNR at least Euler's - 0.2 dB (the
    reference's BST claim) and above Euler's, the trained knots off
    ``identity_bst(8, "euler")`` (which samples as Euler does, so a lost
    gradient would pass the claim alone), the ``bst`` artifact saved and reloaded
    bit-equal and its ``ns_params`` refused with TypeError. Prints each
    iteration's ms (``bns.fit``'s stamps: CUDA events between iterations,
    the first holding the captures) and the peak memory.
13. The gradient on the card against the CPU: yi-6b's width cut to 2 layers,
    f32, euler NFE 4, on shared pairs (numpy, seeded), each layer recomputed:
    _loss_fn and d loss / d(time_logits, a, b) at theta0, relative L2 <= 1e-4
    (phase 5's rule), with exactly 16 flash forward, 8 flash backward, 4 + 4
    ns_update launches; then theta after DISTILL_CHECK_STEPS train_solver
    steps (graphed on the card). Adam's first steps are ~lr sign(g) per component, so a component
    whose gradient is near 0 can step either way: components whose CPU
    gradient at theta0 is at least 1e-3 of its largest must agree to 1e-3 of
    the largest step (lr per step), the others to the most a flipped sign can
    move them (2 lr per step).
13b. Phase 13 for the anytime loss: the same 2-layer f32 model and pairs,
    budgets (2, 4), theta the nested initial solver jittered with numpy from
    a seed: ``anytime_loss`` and its gradient in every field of
    ``AnytimeParams``, card against CPU, relative L2 <= 1e-4, with exactly 16
    flash forward, 8 flash backward, 5 + 5 ns_update launches (4
    intermediate rules and the budget-2 exit).
13c. Phase 13 for BST, the gradient that phase 12d trains on: the same
    2-layer f32 model and pairs, BST-Euler at NFE 4, knots the identity
    jittered with numpy from a seed: ``_loss_fn`` through ``bst_sampler``
    (``run_direct`` under autograd into ``materialize_bst``) and its gradient
    in every field of ``BSTParams``, card against CPU, relative L2 <= 1e-4,
    with exactly 16 flash forward, 8 flash backward and no ns_update launch.
14. The flow gateways at full width, serving 12c's anytime artifact
    (budgets 4 and 8; its parameters do not depend on the sequence length)
    through ``serve.main --gateway`` at seq 1024 (GATEWAY_ARGS): every
    request a single-sample submit, token row ``req % 4``, noise from seed
    ``1000 + req``. Launch counts are derived from the gateway's own
    ``dispatches`` counters (``program_launches``): a flush batch at budget
    m runs m forwards and m ns_update launches, a mixed one (``bmix``) the
    shared trajectory's 8 forwards and 9 launches (8 rules and the budget-4
    exit), a trajectory leg s -> t (and a join prefix 0 -> t) t - s forwards
    and t - s launches plus one where it crosses the budget-4 exit; flash
    attention launches 32 a forward, and the summed forwards must equal the
    gateway's. Every request must be served (done = submitted, failed 0);
    each flush batch's rows (recorded around ``Gateway._execute``) equal a
    direct ``sample_from`` / ``sample_all_from`` on the same assembled batch
    to the bit; each row is held against its request sampled alone at batch
    1 and its native shape, and the first per-budget batch's first three rows
    against a direct call at batch 3: equal to the bit, or within relative
    L2 GATEWAY_REL_L2 = 2e-2 (max |diff| and relative L2 printed either way).
    14a: the flush gateway, 12 requests alternating budgets 4 and 8,
    --max-batch 4, --max-wait-ms 60000: exactly three dispatches, b4/k4
    (uids 0, 2, 4, 6), b8/k4 (1, 3, 5, 7) and, at drain, one mixed bmix/k4
    (8-11; 1 x 8 < 4 + 8): forwards 20, flash 640, ns_update 4 + 8 + 9 = 21.
    14b: the same with --continuous --max-slots 4 and 8 requests; the layout
    depends on timing, so the counts are held to the dispatches; at least one
    trajectory must open; joins, join rate and slot occupancy are printed,
    and each row is held (as above) against 14a's row of the same request.
    14c: --tiers 512,1024 at seq 1000, 4 requests at budget 8: one b8/k4
    dispatch at tier (1024, 64), rows cropped to (1000, 64) (yi-6b's flow
    field is causal, so tail positions do not reach earlier ones) and held
    also against a direct call on the same four rows at their native shape
    (4, 1000, 64).
    14d: 14a's 12 requests through --fleet 4 (a ``FleetGateway`` of four
    flush gateways serving one sampler, the balancer stealing queued
    entries to idle hosts): gateway_path's checks with the counts held to
    the dispatches, each row against 14a's for the same request (bits, or
    GATEWAY_REL_L2 where the batch composition differs), the homes HRW gives
    the two affinity keys and the routed counts (6 each on the keys' homes).
    14e: a ``FleetGateway`` of FLEET_HOSTS = 4 ``Gateway``s over 14a's
    sampler, pumped by hand: 12 requests on one hot key (one shard), a
    ``steal_round`` (``WorkStealer(min_queue=2, max_steal=8)``) moving 6 + 3
    + 2, a fifth host joining, 4 budget-8 requests, the deepest other host
    leaving (its shard re-homed: ``rerouted``), the drain; all 16 futures
    resolve, every row equals a direct call on the batch it was served in to
    the bit, launches equal the dispatches'.
15. The serving engines' programs, graphed (``serving.programs``: on the
    card every engine call goes through a CUDA graph captured once per key,
    so phases 4, 4b, 6, 8, 10, 12, 12b, 12c's requests and 14 already ran
    graphed, as did the training of 12, 12c, 12d, 13, 13b and 13c (phase
    16); phases 7 and 11 record each step's logits on the host and run
    eagerly) against the same call under ``programs.disabled()``, at full
    width, in the phases that hold each model's weights: yi-6b
    ``FlowSampler`` at budget 8, batch 4, seq 1024 (after phase 4); yi-6b
    ``prefill_slots`` (C = 64) and ``step_slots`` greedy and sampled on a
    paged state of phase 6's shape (8 slots of 16 pages of 16; after phase
    6), and a step captured at 2 slots of 16 pages, replayed after a step
    at 2 slots of 64 pages grew the paged kernel's merge workspace; rwkv6-7b
    flow (after phase 8) and ``step_slots`` (after phase 10); 12c's anytime
    artifact at seq 1024 (after 14a): budgets 4 and 8, ``sample_all`` and
    the legs 0 -> 4 and 4 -> 8; zamba2-2.7b flow (after phase 17),
    ``prefill_slots`` and ``step_slots`` greedy and sampled (after 17c).
    Each case runs a first pair and GRAPH_REPS timed pairs (graphed, then
    eager; decode on two copies of one state): each pair equal to the bit
    (tokens and every state leaf for decode) with equal launch counts;
    prints ms a call each way (median), the capture ms and the launches a
    call; one graphed greedy step of each decode model runs under
    torch.profiler for the card's busy share. Launch counts of
    every phase read the same graphed as eager: a capture launches nothing
    and a replay adds what its program recorded.
16. The training programs, graphed against eager (``bns.TrainLoop``: on
    the card one Algorithm-2 iteration is one CUDA graph, captured at the
    first and replayed, and the validation another), at full width, in the
    phases that hold the weights and the solved pairs (no new RK45 solve):
    the BNS trainer at seq 1024, euler NFE 8 (after phase 12, on its
    pairs), the anytime trainer at seq 256, budgets 4 and 8 (after 12c),
    the BST-Euler trainer at seq 256, NFE 8 (in 12d). Each runs
    TRAIN_GRAPH_ITERS iterations and one validation through a fresh loop
    graphed, then from the same theta and full batches under
    ``programs.disabled()``: theta, Adam's moments and step, every loss and
    the val PSNR equal to the bit, launch counts equal. Prints ms an
    iteration each way (host clock around an iteration and a sync; median
    after the first, which graphed is the capture's warm-up), the capture
    ms, the validation ms, the launches an iteration and, for the anytime
    trainer, one more iteration each way, the graphed one under
    torch.profiler (the card's busy share). Then RK45's step program
    (``core/rk45.py::RK45Program``), graphed against eager: two solves of
    one shape through one fresh program, then the same two under
    ``programs.disabled()``, on yi-6b at full width and RK45_GATE_LAYERS = 2
    layers (bf16, batch 4, seq 256) and on the claims twin's toy field
    (``benchmarks.psnr_vs_nfe.make_field("fm_ot")``, 256 x 2): x1 equal to
    the bit, nfe, accepted and rejected equal, launches equal, one capture
    in all (the second solve captures nothing); seconds each way.
17. Flow path of zamba2-2.7b at full width (54 Mamba2 layers and 9 sites
    of the one shared attention block, bf16), as phase 4, after the earlier
    weights are freed: flash attention 9 x 8 x 3 = 216 launches (hd 80),
    gla_scan 54 x 8 x 3 = 1296 (inclusive, one decay a head), ns_update 24,
    the others 0; phase 15's case on the served sampler (graphed equal to
    eager to the bit). Prints each request's ms and the peak memory beside
    the card's name and power limit.
17b. Phase 5 for zamba2-2.7b: its width cut to 2 layers and one
    shared-attention site (hybrid_attn_every 2, so hd stays 80), f32, euler
    NFE 4, relative L2 <= 1e-4; flash 4, gla_scan 8 and ns_update 4
    launches on the card.
17c. Decode path of zamba2-2.7b at full width, phase 10's flags (8
    requests on 4 slots, lengths 32/16): every request finishes at its
    length with in-vocabulary tokens and no kernel launches (decode steps
    the recurrence and a dense KV cache a site in plain torch, as the
    reference does); then phase 15's decode cases on its engine
    (prefill_slots of ZAMBA_PREFILL columns, step_slots greedy and
    sampled), graphed equal to eager to the bit.
17d. Phase 7 for zamba2-2.7b's 2-layer f32 model.
18. Flow path of qwen3-moe-30b-a3b at full width and depth (48 layers of
    attention, 32 / 4 heads of 128 with qk-norm, and 128 experts, top 8,
    dispatched by the per-sequence scatter; bf16), as phase 4: flash 48 x 8
    x 3 = 1152 launches, ns_update 24, the others 0; phase 15's case on the
    served sampler. Prints each request's ms, the capture and peak memory.
18b. Phase 5 for it on its width cut to 2 layers (f32, drawn on the card
    and copied to the CPU), eagerly on both sides: every router call's
    expert choices equal first (a flip prints both sides' probabilities and
    the CPU's gap between its 8th and 9th), then the latents within 1e-4
    and their nearest tokens equal.
18c. Its decode through the gateway and the paged kernel: phase 10's flags
    plus --page-size 16 --paged-kernel --slots 256; paged launches exactly
    48 a decode_apply call; tokens/s, engine call ms, phase 15's step case.
18d. Phase 7 for 18c on the 2-layer f32 model (paged kernel, 2 a call).
19. qwen3-moe-235b-a22b at 8 of its 94 layers (MOE_235B_DEPTH; all 94 are
    ~470 GB), full width: one flow request (flash 64, ns_update 8) and a
    short decode through the paged kernel at 64 / 4 heads, G = 16 (8
    launches a call, phase 15's step case); then its smoke config (2
    layers, f32, with the full config's 64 / 4 heads of 128: the smoke
    config's hd 32 is not among the flash kernel's) on the card against the
    CPU, flow and decode.
20. phi3-medium-14b, command-r-35b and yi-34b at full width and depth, one
    flow request each with phase 4's other flags (flash 320, 320 and 480);
    each then against the CPU at 2 layers, f32, drawn on the card.
21. Flow path of whisper-medium at full width and depth (24 encoder and 24
    decoder layers, 16 heads of 64, bf16; the stub frontend's 1500 frames
    of 1024 drawn by ``SyntheticTokens``), as phase 4: every request exactly
    576 flash launches (72 a forward: 24 encoder non-causal over the frames,
    24 causal decoder self-attention, 24 cross-attention at Lq 1024, Lk
    1500) and 8 ns_update, the others 0; phase 15's flow case.
21b. Phase 5 for it at 2 + 2 layers, f32, drawn on the card, with the full
    config's 16 heads of 64 (the smoke config's hd 32 is not among the flash
    kernel's): relative L2 <= 1e-4, flash 24 and ns_update 4 on the card.
21c. Greedy decode over an encoded memory (``DecodeEngine.greedy``, graphed,
    after ``whisper.encode`` writes the state's memory): at full width,
    WHISPER_DECODE_STEPS steps of 4 rows, each step exactly 24 flash
    launches (cross-attention at Lq 1, Lk 1500), step ms and tokens/s; at
    the 2 + 2-layer f32 model, the memory within relative L2 1e-4 of the
    CPU's and the tokens equal to the CPU's.
22. internvl2-26b at full width and depth (48 layers, 48 / 8 heads of 128,
    G 6; ~40 GB of bf16 weights; 256 stub patches of 3200 prepended through
    the projector): INTERNVL_REQUESTS flow requests with phase 4's other
    flags (flash 384 and ns_update 8 each, over 1280 positions), then its
    decode through the gateway and the paged kernel with phase 18c's flags
    (paged attention exactly 48 a decode_apply call) and phase 15's step
    case.
22b. Phase 5 and phase 7 for it at INTERNVL_CHECK_LAYERS = 1 layer, f32,
    drawn on the card (the full config's heads of 128; one layer, as the
    CPU's side of an f32 layer at full width is slow): flow relative L2 <=
    1e-4, decode logits within 1e-4 with the paged kernel (1 a call) and the
    tokens equal.
23. Placement on the 1 x 1 host mesh (``launch.mesh.make_host_mesh``: a
    one-rank NCCL process group, destroyed at the end). 23a: 14a's trace
    through --mesh host (weights and batches DTensors, every kernel run on
    its local shard through ``local_map``): dispatches and launches equal
    14a's, each row equal to 14a's for the same request, or the largest
    difference printed and over MESH_REL_L2 = 1e-3 relative L2 failing.
    23b: a short form of phase 6's trace (MESH_DECODE_ARGS: 8 requests of
    32, 16, 24 and 8 tokens on 8 slots, pages of 16, prefill chunk 64)
    through ``DecodeGateway`` on one yi-6b engine, unsharded and then with
    ``mesh=``: tokens equal, paged attention 32 a ``decode_apply`` call in
    both. 23c: ``make_distributed_bns_step`` at world size 1 on yi-6b's
    field at full width and DIST_LAYERS = 2 layers (f32, each layer
    recomputed in the backward), DIST_ITERS = 3 iterations on 8 x 256
    pairs (noise, an Euler solve at NFE 16): theta and the losses within the
    f32 TOL of the plain step's (the PSNR loss, autograd, Adam at the host
    rate), launches equal to the plain step's.
24a. The backbone trainer: ``repro_torch.launch.train.main`` trains yi-6b at
    full width and TRAIN_LAYERS = 32 layers (its full depth; ~73.2 GB of
    bf16 params and gradients and f32 Adam moments), TRAIN_STEPS = 6 steps
    of batch 8 x 64 (the reference trainer's batch and seq), bf16 weights
    drawn on the card, the step one CUDA graph (captured at step 0,
    replayed): flash forward (with lse) and backward exactly 32 launches a
    step each and no other kernel, one program and 5 replays, finite losses.
    Prints ms a step (step 0 with its capture, then steps 1-5; the last under
    torch.profiler for the card's busy share), tokens/s, the peak memory and
    the losses.
24b. The trainer at full width and TRAIN_CHECK_LAYERS = 2 layers, 3 steps
    graphed and then under ``programs.disabled()``: params, Adam's moments
    and step and the losses equal to the bit, launch counts equal.
24c. ``launch.train.Trainer`` on the card against the CPU: yi-6b's width at
    2 layers, f32 (drawn on the card, copied), TF32 off, 3 steps of 8 x 64
    on the same tokens and noise: each loss within 1e-4 relative, the
    params after the third step within 1e-4 relative L2.
24d. The checkpoint round trip at full width and 2 layers: the trainer
    writes its step-2 checkpoint under build/chip_smoke/train_ckpt, a second
    ``train`` call resumes from it (params only, Adam from zero, so its one
    step runs at rate 0 and keeps the params to the bit), and ``serve.main
    --ckpt`` at the same depth (``launcher_depth``) serves one phase-4
    request whose latents equal a ``FlowSampler`` on the trained params
    with the served solver and the same x0, to the bit.
24e. Phase 4's request in a subprocess under ``--profile tuned`` (one
    re-exec: ``expandable_segments``, tcmalloc where installed) beside
    phase 4's first request under the default profile: request ms, peak
    memory, whether tcmalloc was found and the one re-exec line; no claim
    either way.
26. Distillation of rwkv6-7b at full width (PR 30): ``serve.main`` with
    phase 12's flags at FAMILY_DISTILL_DEPTH = 2 of its 32 layers
    (``launcher_depth``; 4 until phases 32-35 needed the script's time: its
    RK45 took 51.4 s at 4), FAMILY_DISTILL_ITERS = K = 8 iterations, the
    artifact under build/chip_smoke/rwkv6-7b/ (a directory of its own,
    emptied first: the zoo scans it for a solver of the same spec), then its
    2 requests. With R the RK45 evaluations of both solves, C = R + 8 + 8 +
    16 velocity calls under no_grad and G = 8 K differentiated ones (each
    layer recomputed): gla_scan N (C + 2 G), gla_scan_bwd N G (N = 2
    layers; ``family_launches`` writes this out), ns_update 8 (2 + 2 + K),
    ns_update_bwd 8 K, nothing else. The distilled val PSNR above Euler's.
26b. Phase 13's gradient for rwkv6-7b at 1 layer, f32, drawn on the card:
    gla_scan 8, gla_scan_bwd 4, ns_update 4 and 4. The loss and each
    gradient card vs CPU within relative L2 1e-4; a gradient that f32
    itself cannot hold to that (the CPU's f32 result farther than
    GRAD_F32_FLOOR = 2.5e-5 from the CPU's f64 one: rwkv6-7b's time-logit
    gradient reads 2.0e-4) is held to the f64 result instead, the card's
    distance at most GRAD_F32_FACTOR = 4 times the CPU's.
27. Phase 26 for zamba2-2.7b at 6 of its 54 layers (one shared-attention
    site, hybrid_attn_every 6): gla_scan 6 (C + 2 G), gla_scan_bwd 6 G,
    flash (hd 80) C + 2 G, flash backward G; then phase 16's BNS case on its
    weights and pairs (graphed TrainLoop iterations equal to eager to the
    bit, launches equal). 27b: its gradient at 2 layers and one site
    (hybrid_attn_every 2), f32: gla_scan 16, gla_scan_bwd 8, flash 8 and 4.
28. Phase 26 for whisper-medium at 4 decoder and 4 encoder layers (E = D =
    4): flash (E + 2 D) C + (E + 4 D) G (the encoder runs a plain forward in
    every call, its frames and weights carrying no gradient; each decoder
    layer's self- and cross-attention run twice when differentiated), flash
    backward 2 D G (the cross-attention's the dq pass alone). 28b: its
    gradient at 1 + 1 layers, f32: flash 20, backward 8.
29. The backbone trainer (``launch.train.main``) on each of the three at
    full width and the smallest depth each takes (FAMILY_TRAIN_DEPTH:
    rwkv6-7b 1 layer, zamba2-2.7b 6 (one site), whisper-medium 1 + 1),
    FAMILY_TRAIN_STEPS = 3 steps of 8 x 64, graphed and then under
    ``programs.disabled()``: params, Adam's moments and step and the losses
    equal to the bit, launches equal to the formula (weights carry
    gradients, no recomputation: each recurrence and attention forward and
    backward once a step: rwkv6-7b gla_scan 1 and gla_scan_bwd 1 a step,
    zamba2-2.7b 6 and 6 with flash 1 and 1, whisper-medium flash 3 and 3);
    ms a step and peak memory printed (29a, 29b, 29c).
30. ``model.lm_apply`` (full-sequence logits), one call a family on the
    full-width weights a phase already holds: 4 (yi-6b), 8 (rwkv6-7b), 17
    (zamba2-2.7b), 18 (qwen3-moe-30b-a3b), 21 (whisper-medium, its 1500 stub
    frames) and 22 (internvl2-26b, its 256 patches), at the phase's batch and
    seq 1024 with ``last_only``: ms, peak GiB and launches, held to the
    formula (flash once a layer for the dense, moe and vlm families, once a
    shared-attention site for zamba2-2.7b, 3 a layer pair for whisper-medium;
    gla_scan once a layer for rwkv6-7b and zamba2-2.7b). On yi-6b also the
    full call (its last row within 2e-2 of the ``last_only`` one) and
    token-by-token ``decode_apply`` over the first LM_DECODE_STEPS positions
    (within 2e-2 of ``lm_apply``'s logits, the same argmax). Each family's
    2-layer f32 model (phases 5, 9, 17b, 18b, 21b, 22b) card vs CPU at seq
    64: relative L2 <= 1e-4.
31. The examples' twins (``examples/torch``) run in-process on the card at
    their smallest knobs (TWIN_ARGS), each printing its board: quickstart
    (BNS wins), solver_zoo, gateway_demo, serve_decode and train_flow_lm.
32a. One MoE layer of qwen3-moe-30b-a3b at full width (128 experts of 768,
    top 8), batch 4 x 1024, bf16 and f32: the backward twice on the same
    inputs and output gradient, x.grad's bits compared through the port's
    dispatch gather (``moe._Dispatch``: its backward a gather summing each
    token's 8 slot gradients in order) and through autograd of
    ``index_select`` (``index_add_``'s float atomics), each form's forward +
    backward ms; the port's must be bit-equal and within TOL (relative L2)
    of the other form's gradient, the other's bits are printed either way.
32. Phase 26 for qwen3-moe-30b-a3b at FAMILY_DISTILL_DEPTH = 1 of its 48
    layers (the width full; the depth cut for the script's time): flash N
    (C + 2 G), flash backward N G (``family_launches``), then phase 16's
    BNS case on its weights and pairs (graphed TrainLoop iterations equal to
    eager to the bit: the dispatch backward has no atomics). 32b: its
    gradient at 1 layer, f32, card vs CPU under phase 26b's rule, after
    every router call's expert choices (8: each layer routes in the forward
    and again in its recomputation, for each of the 4 steps) are compared,
    as 18b compares them: flash 8, backward 4. 32c: the trainer at 2 layers
    (FAMILY_TRAIN_DEPTH), 3 steps of 8 x 64, graphed against eager to the
    bit: flash 1 and backward 1 a layer a step.
33. The same for internvl2-26b: distilled at 1 of its 48 layers (its
    decoder over 256 stub patches and 1024 tokens: flash at G 6 over 1280
    positions), 33b its gradient at 1 layer f32, 33c the trainer at 1
    layer (its 92,553 x 6144 embedding and head are most of the state).
34. Phase 26b's gradient for phi3-medium-14b (40 / 10 heads, G 4),
    command-r-35b (64 / 8, G 8, the parallel block, tied embeddings) and
    yi-34b (56 / 8, G 7) at 1 layer, f32, full width, card vs CPU: flash 8
    and backward 4 each.
35. Sliding-window attention on the card (the masked plain path: no kernel
    takes a window, the reference's flash kernel neither). 35a:
    ``lm_apply(window=WINDOW_FULL)`` on yi-6b's weights at full width and
    depth, batch 4 x 1024, timed beside the unwindowed call: no kernel
    launch, ms and peak GiB; over the first 256 positions the two within
    the bf16 limit on an f32 copy of the weights (in bf16 the plain path
    rounds scores and softmax weights to bf16, as the reference does, and
    their distance is printed), past them different. 35b, inside phases 5,
    17b, 18b and 22b on their 2-layer f32 models (dense, hybrid, moe, vlm):
    ``lm_apply(window=WINDOW_CPU)`` card vs CPU (relative L2 <= 1e-4), then
    again under an installed context with ``q_chunk`` = Q_CHUNK, every
    attention through ``_chunked_attend`` on both sides. 35c:
    ``serve.main`` decode with ``--window 64 --slots 64`` on yi-6b at full
    width (8 requests of up to 2 + 96 positions on 4 slots: the ring wraps),
    phase 15's cases on its engine (``prefill_slots`` of 16 columns, then
    greedy ``step_slots`` from position 62, across the wrap, graphed against
    eager to the bit), then a 2-layer
    f32 model card vs CPU over an 8-slot ring (the same tokens, logits
    within 1e-4).
36. The production-mesh dry run (``repro_torch.launch.dryrun``) with the
    card's torch, in subprocesses (each starts a fake process group of its
    own, which this process's group would refuse): yi-6b decode_32k on the
    16 x 16 mesh, fake tensors on the card's paths (nothing launches),
    printing one rank's GiB, TFLOP and collective GB; and the memory
    tracker held to the card: phase 30's yi-6b ``lm_apply(last_only)`` at
    batch 4 x 1024 reckoned on a 1 x 1 fake world, its peak within
    DRYRUN_PEAK_TOL of phase 30's measured peak, both beside the card's
    name and power limit.
37. The script's wall time, one JSON line listing the kernels (the
    ns_update and flash entries, forward and backward, with phases 4b, 5b,
    12b, 12c, 12d, 13b, 13c, 14a, 14b, 14c, 16 and 17-17d's launches and
    ms beside the main path's; every entry with phases 18-20's; the flash
    and gla_scan entries also carry zamba2-2.7b's case and phase-17
    launches, the flash and paged entries phases 18-20's shapes; every
    entry with phases 14d, 14e and 23's, and 24a-24d's; the two flash
    entries with phase 3d's case and 24a's launches as "trainer"; every
    entry with phases 26-29's, the gla_scan_bwd entry's main path being
    phase 26 and the flash backward's and gla_scan_bwd's phase 3c cases at
    the new families' shapes as "slice19_cases"), then the last line.
    Every entry also carries phases 32-35's launches, the flash backward's
    phase 3c's cases at G 6, 4 and 7 as "gqa_cases".

Phase 3 also holds flash at B=4 L=1024 hd 128, causal, bf16 at (H, KV) =
(56, 8), (40, 10), (64, 8) and (64, 4) (yi-34b, phi3-medium-14b,
command-r-35b, qwen3-moe-235b-a22b), and the paged kernel at G = 16 (B=8,
KV=4, the decode cell's pages, bf16 and f32 pools); and the shapes of
phases 21-22: flash bf16 at B=4, 16 heads of 64, G 1: non-causal at L 1500
(whisper's encoder), causal at L 1024 (its decoder), non-causal at Lq 1024
/ Lk 1500 (cross-attention) and at Lq 1 / Lk 1500 (cross-attention in
decode); causal at B=4, L 1280, (48, 8) heads of 128 (internvl2-26b, G 6);
and the paged kernel at KV 8, G 6 on the decode cell's pages (bf16 and f32
pools). SDPA is timed beside each as a yardstick.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import msgpack
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
# bf16 flash attention against its plain version. The kernel rounds the
# softmax weights P to bf16 before P·V and the output to bf16; the plain
# version keeps P in f32. Both limits must hold: elementwise
# |err| <= atol + rtol |ref|, and the relative L2 error of each output row
# (over the head dim) <= row_rel_l2, which catches a fault confined to late
# rows, where |o| is small. scripts/flash_fault_check.py shows the sound
# kernel inside both and planted faults outside.
FLASH_BF16 = {"atol": 4e-3, "rtol": 2e-2, "row_rel_l2": 1e-2}
# bf16 paged attention against its plain version: both keep scores, weights
# and sums in f32 and round only the output to bf16, so the two differ by at
# most one bf16 ulp of |o|, which is <= 2**-7 |o| (atol covers outputs near 0).
PAGED_BF16 = {"rel": 2.0 ** -7, "atol": 1e-6}
# bf16 flash backward against its plain version (phase 3c). Both take the same
# bf16 q, k, v, o, dO and the kernel's lse, sum in f32 (the kernel's P and dS
# in two bf16 parts, ~16 bits) and round only dq, dk, dv to bf16, so they
# differ by one bf16 rounding step at most: |err| <= atol + 2^-7 |ref|
# elementwise (card readings: 0.88 of it for an exact-f32 first version, 0.97
# for the tensor-core kernel), and each row's relative L2 error <= row_rel_l2,
# over max(|ref row|, atol sqrt(hd)) (causal row 0 of dq is exactly 0: its one
# key gives dS = P (dP - D) = 0); readings 1.7e-3 and 2.6e-3.
# scripts/flash_bwd_fault_check.py shows the sound kernel inside and planted
# faults outside.
FLASH_BWD_BF16 = {"atol": 1e-3, "rtol": 2 ** -7, "row_rel_l2": 4e-3}
# the gla_scan backward against its plain version taken in f64 on the same
# inputs: relative L2 of each gradient, f32 inputs 1e-5 (the kernel sums in
# f32), bf16 inputs 2e-2 (bf16 outputs round by up to 2^-9 each). A gradient
# kept in f32 for bf16 inputs (dld of an f32 ld, ds0) does not round: 1e-3
# (the tensor-core kernel's readings <= 3.8e-5; with S0's and G's low bf16
# parts dropped, 3.0e-3-1.3e-2: scripts/gla_bwd_fault_check.py)
GLA_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GLA_BWD_F32_OUT_TOL = 1e-3


def gla_bwd_limit(qkv_dtype: torch.dtype, out_dtype: torch.dtype) -> float:
    """The relative L2 limit of one gla_scan_bwd gradient of ``out_dtype``
    for q, k, v of ``qkv_dtype``."""
    if qkv_dtype == torch.bfloat16 and out_dtype == torch.float32:
        return GLA_BWD_F32_OUT_TOL
    return GLA_BWD_TOL[qkv_dtype]
HBM_BYTES_PER_S = 3.35e12                          # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # CUDA-core f32, dense bf16
NFE, BATCH, SEQ, REQUESTS = 8, 4, 1024, 3
DECODE_ARGS = ["--arch", "yi-6b", "--mode", "decode", "--full", "--gateway",
               "--page-size", "16", "--paged-kernel", "--max-slots", "8", "--slots", "256",
               "--requests", "16", "--decode-lengths", "128,32,64,16",
               "--prefill-chunk", "64"]
RWKV_DECODE_ARGS = ["--arch", "rwkv6-7b", "--mode", "decode", "--full", "--gateway",
                    "--max-slots", "4", "--requests", "8", "--decode-lengths", "32,16"]
LONG_LENGTHS = [4096, 3001, 2048, 1, 777, 4095, 1500, 3333]   # positions a row
LAYERS = 32                                        # yi-6b and rwkv6-7b
DISTILL_ITERS, DISTILL_REQUESTS = 8, 2             # phase 12
DISTILL_CHECK_STEPS, DISTILL_CHECK_LR = 3, 1e-3    # phase 13
BNS_ARTIFACT = ROOT / "build" / "chip_smoke" / "bns_nfe8.msgpack"          # phases 12, 12b
ANYTIME_ARTIFACT = ROOT / "build" / "chip_smoke" / "anytime_4_8.msgpack"   # phase 12c
ANYTIME_SEQ, ANYTIME_ITERS, ANYTIME_BUDGETS = 256, 4, (4, 8)              # phase 12c
# phases 12-12d's depth at yi-6b's full width: their RK45 pairs and training
# scale with it, and at 32 layers they took ~530 s of the script's limit
DISTILL_LAYERS = 4
ANYTIME_REQUEST_BUDGETS = (4, 8, 16)
BASELINES = ("ddim", "dpm2m", "edm_heun")                                    # phases 4b, 5b
BASELINE_REQUESTS = 2                                                        # phase 4b
BST_SEQ, BST_PAIRS, BST_ITERS = 256, 8, 4                                    # phase 12d
TRAIN_GRAPH_ITERS = 4                                                        # phase 16
RK45_GATE_LAYERS, RK45_GATE_SEQ = 2, 256        # phase 16's RK45 case on yi-6b's width
BST_ARTIFACT = ROOT / "build" / "chip_smoke" / "bst_euler_nfe8.msgpack"
VOCAB = {"yi-6b": 64000, "rwkv6-7b": 65536, "zamba2-2.7b": 32000, "qwen3-moe-30b-a3b": 151936,
         "qwen3-moe-235b-a22b": 151936, "phi3-medium-14b": 100352, "command-r-35b": 256000,
         "yi-34b": 64000, "whisper-medium": 51865, "internvl2-26b": 92553}
# phases 18-18d: qwen3-moe-30b-a3b, 48 layers of attention and 128 experts (top 8)
MOE_ARCH, MOE_LAYERS = "qwen3-moe-30b-a3b", 48
MOE_DECODE_ARGS = ["--arch", MOE_ARCH, "--mode", "decode", "--full", "--gateway",
                   "--max-slots", "4", "--requests", "8", "--decode-lengths", "32,16",
                   "--page-size", "16", "--paged-kernel", "--slots", "256"]
# phase 19: qwen3-moe-235b-a22b at 8 of its 94 layers (~42 GB of bf16 weights;
# all 94 are ~470 GB), full width: 64 query heads over 4 KV heads, G = 16
MOE_235B, MOE_235B_DEPTH = "qwen3-moe-235b-a22b", 8
MOE_235B_DECODE_ARGS = ["--arch", MOE_235B, "--mode", "decode", "--full", "--gateway",
                        "--max-slots", "4", "--requests", "4", "--decode-lengths", "8,4",
                        "--page-size", "16", "--paged-kernel", "--slots", "256"]
# phase 20: the dense configs at full width and depth, one flow request each
DENSE_LAYERS = {"phi3-medium-14b": 40, "command-r-35b": 40, "yi-34b": 60}
# phases 21-21c: whisper-medium, 24 encoder and 24 decoder layers; a forward runs
# flash 3 x 24 times (encoder, decoder self-attention, cross-attention)
WHISPER, WHISPER_LAYERS = "whisper-medium", 24
WHISPER_FRAMES = 1500                                        # its stub frontend's frames
WHISPER_DECODE_STEPS, WHISPER_DECODE_SLOTS = 32, 64          # phase 21c
# phases 22-22b: internvl2-26b at full width and depth, 48 layers (~40 GB bf16)
INTERNVL, INTERNVL_LAYERS, INTERNVL_REQUESTS = "internvl2-26b", 48, 2
INTERNVL_CHECK_LAYERS = 1                  # 22b's card-vs-CPU model (the CPU side is slow)
INTERNVL_DECODE_ARGS = ["--arch", INTERNVL, "--mode", "decode", "--full", "--gateway",
                        "--max-slots", "4", "--requests", "8", "--decode-lengths", "32,16",
                        "--page-size", "16", "--paged-kernel", "--slots", "256"]
# phases 17-17d: zamba2-2.7b, 54 Mamba2 layers and 9 shared-attention sites
ZAMBA_LAYERS, ZAMBA_SITES = 54, 9
ZAMBA_DECODE_ARGS = ["--arch", "zamba2-2.7b", "--mode", "decode", "--full", "--gateway",
                     "--max-slots", "4", "--requests", "8", "--decode-lengths", "32,16"]
ZAMBA_PREFILL = 16            # phase 15's prefill_slots case on zamba2-2.7b's engine
# phase 14: flow gateways serving 12c's anytime artifact at full width
GATEWAY_ARGS = ["--arch", "yi-6b", "--mode", "flow", "--full", "--gateway",
                "--max-batch", "4", "--max-wait-ms", "60000", "--batch", str(BATCH),
                "--bns-iters", "0"]
GATEWAY_REL_L2 = 2e-2   # a served row against its request alone where bits differ
FLEET_HOSTS = 4         # phases 14d and 14e: the fleet's hosts (14e adds a fifth, then one leaves)
# phase 23a: rows on the 1 x 1 mesh against 14a's for the same requests, where bits differ
MESH_REL_L2 = 1e-3
MESH_DECODE_ARGS = dict(requests=8, lengths=(32, 16, 24, 8), max_slots=8, slots=256,
                        page_size=16, prefill=64)                  # phase 23b
DIST_LAYERS, DIST_SEQ, DIST_PAIRS, DIST_ITERS = 2, 256, 8, 3       # phase 23c
# phases 3d and 24a-e: the backbone trainer (launch/train.py) on yi-6b at the
# reference trainer's shape, batch 8 of 64 positions, full width
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 64, 6       # 24a
TRAIN_LAYERS = 32                                    # 24a: yi-6b's full depth
TRAIN_CHECK_LAYERS, TRAIN_CHECK_STEPS = 2, 3         # 24b, 24c
TRAIN_CKPT_DIR = ROOT / "build" / "chip_smoke" / "train_ckpt"                # 24d
KERNELS = ("ns_update", "flash_attention", "paged_attention", "gla_scan", "ns_update_bwd",
           "flash_attention_bwd", "gla_scan_bwd")
# phases 26-28: Algorithm 2 at full width for the families whose backward
# kernels PR 30 added (gla_scan's; flash at hd 80 and 64), each at a cut
# depth: (layers, encoder layers); 26b-28b their gradient card vs CPU and
# 29a-c the trainer at the smallest depth each takes
FAMILY_DISTILL_DEPTH = {"rwkv6-7b": (2, None), "zamba2-2.7b": (6, None),
                        "whisper-medium": (4, 4), MOE_ARCH: (1, None), INTERNVL: (1, None)}
FAMILY_DISTILL_ITERS = 8
FAMILY_GRAD_DEPTH = {"rwkv6-7b": 1, "zamba2-2.7b": 2, "whisper-medium": 1,   # f32, each stack
                     MOE_ARCH: 1, INTERNVL: 1, "phi3-medium-14b": 1, "command-r-35b": 1,
                     "yi-34b": 1}
FAMILY_TRAIN_DEPTH = {"rwkv6-7b": (1, None), "zamba2-2.7b": (6, None),
                      "whisper-medium": (1, 1), MOE_ARCH: (2, None), INTERNVL: (1, None)}
FAMILY_TRAIN_STEPS = 3
# phases 32-33: the same trio (distillation, gradient, trainer) for the moe
# and vlm families, each at 1 of its 48 layers to distil (at 2 the script
# passed 1100 s on a slower host; the script's time:
# the RK45 pairs scale with the depth) and at the least depth its check
# needs: one layer for the gradient on both sides (the CPU's half at full
# width), 2 for qwen3-moe-30b-a3b's trainer (a layer routes what another
# layer's gradient reaches), 1 for internvl2-26b's (its 92,553 x 6144
# embedding and head, f32 moments included, are most of its state);
# 32a: one MoE layer's backward twice at the flow cell's shape; phase 34: the
# gradient of the dense archs phase 20 serves, flash backward at G 4, 8, 7
PHASES_26_29 = ("rwkv6-7b", "zamba2-2.7b", "whisper-medium")
PHASES_32_33 = (MOE_ARCH, INTERNVL)
PHASE_34_ARCHS = ("phi3-medium-14b", "command-r-35b", "yi-34b")
TRAIN_PHASE = {"rwkv6-7b": "29a", "zamba2-2.7b": "29b", "whisper-medium": "29c",
               MOE_ARCH: "32c", INTERNVL: "33c"}
# 26b-28b: a gradient whose CPU f32 result lies farther than this from the
# CPU's f64 one is held to f64 (the card within GRAD_F32_FACTOR x the CPU's
# distance): rwkv6-7b's time-logit gradient reads 2.0e-4 from f64 on the CPU
# in f32 and 4.0e-4 on the card, 4.0e-4 too with the gla backward kernel
# replaced by its plain version in f64 (scripts/grad_f32_conditioning.py):
# the kernels add nothing to it
GRAD_F32_FLOOR, GRAD_F32_FACTOR = 2.5e-5, 4.0
FAMILY_PHASE = {"rwkv6-7b": "26", "zamba2-2.7b": "27", "whisper-medium": "28",
                MOE_ARCH: "32", INTERNVL: "33"}
# phase 35: sliding-window attention on the card. 35a: lm_apply at yi-6b's
# full width, batch 4 x 1024, window 256 (the first 256 positions see no
# cut); 35b: each windowed family's 2-layer f32 model card vs CPU at window
# 16 over 64 positions (320 with internvl2-26b's patches), and again under an
# installed q_chunk of 32; 35c: decode through the gateway with a 64-slot
# ring (prompt + tokens up to 98 positions, so it wraps), phase 15's cases
# (a prefill of 16 columns; the steps from position 62, so they wrap), and a
# 2-layer f32 model card vs CPU over an 8-slot ring
WINDOW_FULL, WINDOW_CPU, Q_CHUNK = 256, 16, 32
WINDOW_DECODE, WINDOW_PREFILL, WINDOW_CPU_DECODE = 64, 16, 8
WINDOW_DECODE_ARGS = ["--arch", "yi-6b", "--mode", "decode", "--full", "--gateway",
                      "--window", str(WINDOW_DECODE), "--slots", str(WINDOW_DECODE),
                      "--max-slots", "4", "--requests", "8", "--decode-lengths", "96,80",
                      "--prefill-chunk", "64"]
WINDOW_RUNS: dict = {}                                     # phase 35, by part
LM_SEQ, LM_DECODE_STEPS, LM_CPU_SEQ = 1024, 32, 64        # phase 30
DRYRUN_PEAK_TOL, DRYRUN_TIMEOUT_S = 0.10, 300              # phase 36
LM_RUNS: dict = {}                                         # phase 30, by arch
TWIN_ARGS = {"quickstart": ["--pairs", "64", "--iterations", "100"],       # phase 31
             "solver_zoo": [], "gateway_demo": [],
             "serve_decode": ["--batch", "2", "--steps", "4"],
             "train_flow_lm": ["--steps", "2", "--iterations", "4", "--pairs", "4"]}
# the flash backward's passes by kernel name (in bf16 and f32 alike)
BWD_PASSES = ("flash_bwd_dq", "flash_bwd_dkdv")


def time_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graphed_ms(fn, calls: int = 100, reps: int = 5) -> float:
    """Mean ms a call of ``fn`` replayed from one CUDA graph of ``calls``
    calls (CUDA events over ``reps`` replays, after one): the cost with no
    host work a launch. The capture's launch counts are taken back (it
    launches nothing)."""
    from repro_torch.kernels import build

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up on a side stream
    torch.cuda.current_stream().wait_stream(side)
    counts = {c: c.launches for c in build.COUNTERS}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for c, n in counts.items():
        c.launches = n
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def device_ms(fn, kernel: str | None, iters: int = 100) -> float | None:
    """Mean device time per call of ``fn`` from torch.profiler: the kernels
    whose name holds ``kernel`` (every kernel if None), over ``iters`` calls.
    None where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.name))
    return us / iters / 1e3 if us else None


def device_ms_by_kernel(fn, kernels: tuple, iters: int = 20) -> dict:
    """Mean device time per call of ``fn`` from torch.profiler, for each name
    in ``kernels``: the kernels whose name holds it (None where none ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(kernels, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in kernels:
                if k in e.name:
                    us[k] += e.time_range.elapsed_us()
    return {k: v / iters / 1e3 if v else None for k, v in us.items()}


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, atol: float,
                rtol: float) -> float:
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol,
                               msg=lambda m: f"{name}: kernel vs plain: {m}")
    return float((out.float() - ref.float()).abs().max())


def flash_bf16_errors(out: torch.Tensor, ref: torch.Tensor,
                      atol: float = FLASH_BF16["atol"],
                      rtol: float = FLASH_BF16["rtol"]) -> dict:
    """Largest |err|, largest |err| / (atol + rtol |ref|), and largest
    relative L2 error of one row over the last (head) dim."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    row = (torch.linalg.vector_norm(err, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1).clamp_min(1e-30))
    return {"max_abs": float(err.max()),
            "ratio": float((err / (atol + rtol * ref.abs())).max()),
            "row_rel_l2": float(row.max())}


def check_flash_bf16(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    e = flash_bf16_errors(out, ref)
    if not (e["ratio"] <= 1 and e["row_rel_l2"] <= FLASH_BF16["row_rel_l2"]):
        raise SystemExit(f"{name}: kernel vs plain outside the bf16 limit {FLASH_BF16}: {e}")
    return e["max_abs"]


def ns_update_cases(dev):
    from repro_torch.kernels.ns_update.ns_update import ns_update
    from repro_torch.kernels.ns_update.ref import ns_update_ref

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for n, B, D, dtype in [(NFE, BATCH, SEQ * 64, torch.float32),   # main path
                           (20, 3, 1000, torch.float32),            # ragged D
                           (NFE, BATCH, SEQ * 64, torch.bfloat16)]:
        x0 = torch.randn((B, D), generator=g, device=dev).to(dtype)
        u = torch.randn((n, B, D), generator=g, device=dev).to(dtype)
        a = torch.randn((), generator=g, device=dev)
        w = torch.randn((n,), generator=g, device=dev)
        err = check_close(f"ns_update n={n} B={B} D={D} {dtype}",
                          ns_update(x0, u, a, w), ns_update_ref(x0, u, a, w),
                          atol=TOL[dtype] * n, rtol=TOL[dtype])
        rows.append(ns_update_row(f"n={n} B={B} D={D} {str(dtype)[6:]}", err,
                                  x0, u, a, w, timed_on_device=not rows))
    # the main path's calls: step i of an NFE-8 request reads the i+1 rows the
    # solver has filled, U[:i+1], with the weights b[i, :i+1] (views)
    x0 = torch.randn((BATCH, SEQ * 64), generator=g, device=dev)
    U = torch.randn((NFE, BATCH, SEQ * 64), generator=g, device=dev)
    a = torch.randn((NFE,), generator=g, device=dev)
    b = torch.randn((NFE, NFE), generator=g, device=dev)
    for live in (1, NFE):
        u, w = U[:live], b[live - 1, :live]
        err = check_close(f"ns_update step {live} of {NFE}", ns_update(x0, u, a[live - 1], w),
                          ns_update_ref(x0, u, a[live - 1], w), atol=TOL[torch.float32] * live,
                          rtol=TOL[torch.float32])
        rows.append(ns_update_row(f"step {live} of n={NFE}: U[:{live}] B={BATCH} "
                                  f"D={SEQ * 64} float32", err, x0, u, a[live - 1], w,
                                  timed_on_device=True))
    return rows


def ns_update_row(shape, err, x0, u, a, w, timed_on_device: bool) -> dict:
    """Host-inclusive back-to-back times of the kernel, its plain version and
    addmv; with ``timed_on_device`` also the kernel's and addmv's device time
    from the profiler."""
    from repro_torch.kernels.ns_update.ns_update import ns_update
    from repro_torch.kernels.ns_update.ref import ns_update_ref

    n, N = u.shape[0], x0.numel()
    beta, wl, xf, uf = a.item(), w.to(x0.dtype), x0.view(-1), u.view(n, -1).t()
    b_ms, b_by = bound((n + 2) * N * x0.element_size(), 2 * (n + 1) * N, x0.dtype)
    row = dict(shape=shape, max_abs_err=err,
               ms=time_ms(lambda: ns_update(x0, u, a, w)),
               plain_ms=time_ms(lambda: ns_update_ref(x0, u, a, w)),
               library_ms=time_ms(lambda: torch.addmv(xf, uf, wl, beta=beta)),
               bound_ms=b_ms, bound_by=b_by)
    if timed_on_device:
        row["device_ms"] = device_ms(lambda: ns_update(x0, u, a, w), "ns_update_kernel")
        row["graphed_ms"] = graphed_ms(lambda: ns_update(x0, u, a, w))
        row["library_device_ms"] = device_ms(lambda: torch.addmv(xf, uf, wl, beta=beta), None)
    return row


def flash_cases(dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for case in [
            (BATCH, 32, 4, SEQ, 128, torch.bfloat16, True),    # main path
            (BATCH, 32, 4, SEQ, 128, torch.bfloat16, False),
            (BATCH, 32, 4, 1000, 128, torch.bfloat16, True),   # ragged L
            (2, 8, 2, 512, 64, torch.float32, True),
            (2, 8, 2, 512, 80, torch.float32, True),
            (2, 8, 2, 512, 64, torch.bfloat16, True),          # hd 64
            (2, 8, 2, 512, 80, torch.bfloat16, True),          # hd 80: 32-byte swizzle
            (BATCH, 32, 4, 1, 128, torch.bfloat16, True),      # one position
            (BATCH, 32, 32, SEQ, 80, torch.bfloat16, True),    # zamba2-2.7b's main path
            # phases 18-20: yi-34b (G 7), phi3-medium-14b (G 4), command-r-35b (G 8),
            # qwen3-moe-235b-a22b (G 16); qwen3-moe-30b-a3b is the main path's 32 / 4
            (BATCH, 56, 8, SEQ, 128, torch.bfloat16, True),
            (BATCH, 40, 10, SEQ, 128, torch.bfloat16, True),
            (BATCH, 64, 8, SEQ, 128, torch.bfloat16, True),
            (BATCH, 64, 4, SEQ, 128, torch.bfloat16, True),
            # phases 21-22: whisper-medium's encoder (L 1500, non-causal), decoder
            # self-attention, cross-attention (Lq 1024 / Lk 1500) and its decode
            # step's (Lq 1 / Lk 1500), 16 heads of 64; internvl2-26b (G 6, L 1280)
            (BATCH, 16, 16, 1500, 64, torch.bfloat16, False),
            (BATCH, 16, 16, SEQ, 64, torch.bfloat16, True),
            (BATCH, 16, 16, SEQ, 64, torch.bfloat16, False, 1500),
            (BATCH, 16, 16, 1, 64, torch.bfloat16, False, 1500),
            (BATCH, 48, 8, 1280, 128, torch.bfloat16, True)]:
        B, H, KV, L, hd, dtype, causal, *rest = case
        Lk = rest[0] if rest else L           # keys: L, or the memory's length
        # transposed views of the model's (B, L, heads, hd) layout, as on the main path
        q = torch.randn((B, L, H, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
        k = torch.randn((B, Lk, KV, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
        v = torch.randn((B, Lk, KV, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
        length = f"L={L}" if Lk == L else f"Lq={L} Lk={Lk}"
        name = f"flash_attention B={B} H={H} KV={KV} {length} hd={hd} {dtype} causal={causal}"
        out, ref = flash_attention(q, k, v, causal=causal), attention_ref(q, k, v, causal=causal)
        if dtype == torch.bfloat16:
            err = check_flash_bf16(name, out, ref)
        else:
            err = check_close(name, out, ref, atol=TOL[dtype] * 4, rtol=TOL[dtype] * 4)
        pairs = L * (L + 1) // 2 if causal else L * Lk
        size = q.element_size()
        flops = 4 * hd * pairs * B * H
        b_ms, b_by = bound((2 * B * H * L * hd + 2 * B * KV * Lk * hd) * size, flops, dtype)
        ms = time_ms(lambda: flash_attention(q, k, v, causal=causal))
        rows.append(dict(
            shape=f"B={B} H={H} KV={KV} {length} hd={hd} {str(dtype)[6:]} "
                  f"{'causal' if causal else 'full'}", max_abs_err=err,
            ms=ms, tflops=flops / ms / 1e9,
            plain_ms=time_ms(lambda: attention_ref(q, k, v, causal=causal)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by))
    return rows


def ns_update_bwd_cases(dev):
    """Phase 3c: the ns_update backward at the flow cell's shapes (k = 1 and 8
    live rows of B=4 x D=65536), in bf16, at a ragged D, at k = 64 and
    without dx0. dU and dx0 are one f32 product each, as in the plain
    version (limit TOL); da and dw are f32 sums over N products, held to TOL
    times the sum of the products' magnitudes (the scale of a reordered f32
    sum's error). Every case gives the same bits on a second call and
    replayed from a CUDA graph."""
    from repro_torch.kernels.ns_update.ns_update import ns_update_bwd
    from repro_torch.kernels.ns_update.ref import ns_update_bwd_ref

    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for n, B, D, dtype, need_x0 in [(NFE, BATCH, SEQ * 64, torch.float32, False),  # main path
                                    (1, BATCH, SEQ * 64, torch.float32, False),
                                    (NFE, BATCH, SEQ * 64, torch.bfloat16, True),
                                    (20, 3, 1000, torch.float32, True),           # ragged D
                                    (64, 2, 4096, torch.float32, True)]:
        x0, grad = (torch.randn((B, D), generator=g, device=dev).to(dtype) for _ in "xg")
        u = torch.randn((n, B, D), generator=g, device=dev).to(dtype)
        a = torch.randn((), generator=g, device=dev)
        w = torch.randn((n,), generator=g, device=dev)
        shape = f"k={n} B={B} D={D} {str(dtype)[6:]}{' dx0' if need_x0 else ''}"
        got = ns_update_bwd(grad, x0, u, a, w, need_x0=need_x0)
        ref = ns_update_bwd_ref(grad, x0, u, a, w, need_x0=need_x0)
        err = 0.0
        for what, x, r in zip(("dx0", "du"), got[:2], ref[:2]):
            if need_x0 or what != "dx0":
                err = max(err, check_close(f"ns_update_bwd [{shape}] {what}", x, r,
                                           atol=TOL[dtype], rtol=TOL[dtype]))
        gf = grad.float()
        scales = torch.cat([(x0.float() * gf).abs().sum().reshape(1),
                            torch.tensordot(u.float().abs(), gf.abs(), dims=2)])
        dots, dots_ref = torch.cat([got[2].reshape(1), got[3]]), torch.cat(
            [ref[2].reshape(1), ref[3]])
        ratio = float(((dots - dots_ref).abs() / (TOL[torch.float32] * scales)).max())
        if not ratio <= 1:
            raise SystemExit(f"ns_update_bwd [{shape}]: da, dw vs plain at {ratio:.3f} of "
                             f"the limit (TOL x the sum of |terms|)")
        err = max(err, float((dots - dots_ref).abs().max()))
        again = ns_update_bwd(grad, x0, u, a, w, need_x0=need_x0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            graphed = ns_update_bwd(grad, x0, u, a, w, need_x0=need_x0)
        graph.replay()
        torch.cuda.synchronize(dev)
        for what, runs in (("a second call", again), ("a graph replay", graphed)):
            if not all(x is None or torch.equal(x, y) for x, y in zip(got, runs)):
                raise SystemExit(f"ns_update_bwd [{shape}]: {what} differs from the first "
                                 "call's bits")
        N, size = x0.numel(), x0.element_size()
        b_ms, b_by = bound((2 + 2 * n + need_x0) * N * size, (3 * n + 2 + need_x0) * N, dtype)
        rows.append(dict(
            shape=shape, max_abs_err=err, dot_limit_ratio=ratio,
            ms=time_ms(lambda: ns_update_bwd(grad, x0, u, a, w, need_x0=need_x0)),
            plain_ms=time_ms(lambda: ns_update_bwd_ref(grad, x0, u, a, w, need_x0=need_x0)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
        if not len(rows) > 2:
            rows[-1]["device_ms"] = device_ms(
                lambda: ns_update_bwd(grad, x0, u, a, w, need_x0=need_x0), "ns_update_bwd")
            rows[-1]["graphed_ms"] = graphed_ms(
                lambda: ns_update_bwd(grad, x0, u, a, w, need_x0=need_x0))
    return rows


def flash_bwd_errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Largest |err|, largest |err| / (atol + rtol |ref|), and largest row
    relative L2 error over max(|ref row|, atol sqrt(hd)), under the
    backward's bf16 limit."""
    atol, rtol = FLASH_BWD_BF16["atol"], FLASH_BWD_BF16["rtol"]
    ref = ref.float()
    err = (out.float() - ref).abs()
    floor = atol * ref.shape[-1] ** 0.5
    row = (torch.linalg.vector_norm(err, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1).clamp_min(floor))
    return {"max_abs": float(err.max()),
            "ratio": float((err / (atol + rtol * ref.abs())).max()),
            "row_rel_l2": float(row.max())}


def flash_bwd_passes(e: dict) -> bool:
    return e["ratio"] <= 1 and e["row_rel_l2"] <= FLASH_BWD_BF16["row_rel_l2"]


def flash_bwd_cases(dev):
    """Phase 3c: the flash backward against its plain version on the same
    inputs (q, k, v, dO drawn on the card; o and lse from the forward
    kernel, whose lse is first held against the plain log-sum-exp), at the
    flow cell's shape in bf16 and f32, non-causal, at a ragged L and at small
    GQA shapes. Timed beside its plain version and torch autograd of SDPA's
    backward (a yardstick only: the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref

    g = torch.Generator(device=dev).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    # (B, H, KV, Lq, Lk, hd, dtype, causal, dk/dv wanted)
    cases = [(BATCH, 32, 4, SEQ, SEQ, 128, bf16, True, True),     # main path
             (BATCH, 32, 4, SEQ, SEQ, 128, f32, True, True),
             (BATCH, 32, 4, SEQ, SEQ, 128, bf16, False, True),
             (BATCH, 32, 4, 1000, 1000, 128, bf16, True, True),   # ragged L
             (BATCH, 32, 4, 1000, 1000, 128, f32, False, True),
             (2, 8, 2, 77, 77, 128, f32, True, True),
             (1, 4, 4, 33, 33, 128, bf16, False, True)]
    cases += [(BATCH, 32, 32, SEQ, SEQ, 80, bf16, True, True),    # zamba2's shared attention
              (BATCH, 16, 16, SEQ, SEQ, 64, bf16, True, True),    # whisper's decoder
              # whisper's cross-attention under distillation: only q needs a gradient
              (BATCH, 16, 16, SEQ, WHISPER_FRAMES, 64, bf16, False, False),
              (BATCH, 16, 16, SEQ, WHISPER_FRAMES, 64, bf16, False, True),  # under training
              (2, 8, 2, 77, 77, 80, f32, True, True),
              (1, 4, 4, 40, 97, 64, f32, False, True)]
    # the tensor-core path's edges at hd 64 and 80: ragged L (TMA zero fill,
    # masks), GQA 8 / 2 summed in the block, Lq != Lk both ways, the dq pass alone
    # internvl2-26b's decoder over 256 patches and 1024 tokens (G 6), phi3-medium-14b's
    # (G 4) and yi-34b's (G 7) heads: the GQA groups phases 33 and 34 differentiate
    cases += [(BATCH, 48, 8, 256 + SEQ, 256 + SEQ, 128, bf16, True, True),
              (BATCH, 40, 10, SEQ, SEQ, 128, bf16, True, True),
              (BATCH, 56, 8, SEQ, SEQ, 128, bf16, True, True)]
    for hd in (64, 80):
        cases += [(2, 16, 16, 1000, 1000, hd, bf16, True, True),
                  (2, 8, 2, 333, 333, hd, bf16, True, True),
                  (1, 8, 4, 200, 77, hd, bf16, False, True),
                  (1, 4, 2, 40, 97, hd, bf16, False, True),
                  (2, 8, 2, 300, 450, hd, bf16, True, False)]
    for B, H, KV, Lq, Lk, hd, dtype, causal, dkdv in cases:
        q, do = (torch.randn((B, Lq, H, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
                 for _ in "qo")
        k, v = (torch.randn((B, Lk, KV, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
                for _ in "kv")
        lens = f"L={Lq}" if Lq == Lk else f"Lq={Lq} Lk={Lk}"
        shape = (f"B={B} H={H} KV={KV} {lens} hd={hd} {str(dtype)[6:]} "
                 f"{'causal' if causal else 'full'}{'' if dkdv else ', dq only'}")
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        lse_ref = attention_lse_ref(q, k, causal=causal)
        lse_ratio = float(((lse - lse_ref).abs() / (4 * TOL[f32] * (1 + lse_ref.abs()))).max())
        if not lse_ratio <= 1:
            raise SystemExit(f"flash_attention [{shape}]: lse vs plain at {lse_ratio:.3f} of "
                             "the limit (4 TOL (1 + |lse|))")
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, dkdv=dkdv)
        ref = attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        if not dkdv:
            if got[1] is not None or got[2] is not None:
                raise SystemExit(f"flash_attention_bwd [{shape}]: dk, dv returned")
            got, ref = got[:1], ref[:1]
        err, ratio = 0.0, 0.0
        for what, x, r in zip(("dq", "dk", "dv"), got, ref):
            if not bool(torch.isfinite(x.float()).all()):
                raise SystemExit(f"flash_attention_bwd [{shape}] {what}: non-finite")
            if dtype == bf16:
                e = flash_bwd_errors(x, r)
                if not flash_bwd_passes(e):
                    raise SystemExit(f"flash_attention_bwd [{shape}] {what}: kernel vs plain "
                                     f"outside the bf16 limit {FLASH_BWD_BF16}: {e}")
                err, ratio = max(err, e["max_abs"]), max(ratio, e["ratio"])
            else:
                err = max(err, check_close(f"flash_attention_bwd [{shape}] {what}", x, r,
                                           atol=TOL[f32] * 4, rtol=TOL[f32] * 4))
        # kept (query, key) pairs: under `causal`, key j <= query i
        pairs = sum(min(i + 1, Lk) for i in range(Lq)) if causal else Lq * Lk
        size = q.element_size()
        # the algorithm's flops a kept pair: S, dP, dQ (6 hd), and dV, dK (4 hd more)
        flops = (10 if dkdv else 6) * hd * pairs * B * H
        # q, o, dO read and dq written; k, v read (and dk, dv written)
        nbytes = ((4 * B * H * Lq + (4 if dkdv else 2) * B * KV * Lk) * hd * size
                  + B * H * Lq * 4)
        b_ms, b_by = bound(nbytes, flops, dtype)

        def call():
            return flash_attention_bwd(q, k, v, o, lse, do, causal=causal, dkdv=dkdv)

        ms = time_ms(call, iters=20)
        passes = device_ms_by_kernel(call, BWD_PASSES)
        # flops done a kept pair: in bf16 (the tensor cores, at every hd) S and dP
        # in each pass and P, dS as two bf16 parts, 8 hd in dq and 12 in dk/dv;
        # in f32 (the CUDA cores) 6 and 8
        if dtype == bf16:
            executed = (20 if dkdv else 8) * hd * pairs * B * H
        else:
            executed = (14 if dkdv else 6) * hd * pairs * B * H
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        if not dkdv:
            ks, vs = k, v
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=True)
        wrt = (qs, ks, vs) if dkdv else (qs,)

        def sdpa_bwd():
            return torch.autograd.grad(out, wrt, do, retain_graph=True)

        rows.append(dict(
            shape=shape, max_abs_err=err, limit_ratio=ratio, lse_limit_ratio=lse_ratio,
            ms=ms, tflops=flops / ms / 1e9, executed_tflops=executed / ms / 1e9,
            pass_device_ms=passes,
            plain_ms=time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do, causal=causal),
                             iters=5, warmup=1),
            library_ms=time_ms(sdpa_bwd, iters=20),
            # every kernel the autograd call runs
            sdpa_bwd_device_ms=device_ms(sdpa_bwd, None, iters=20),
            bound_ms=b_ms, bound_by=b_by))
        if len(rows) == 1:
            rows[-1]["graphed_ms"] = graphed_ms(
                lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal))
        del out, qs, ks, vs, got, ref
    return rows


def paged_errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Largest |err|, and its largest ratio to the limit of the output type."""
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        limit = TOL[torch.float32] * 4 * (1 + ref.abs())
    else:
        limit = PAGED_BF16["rel"] * ref.float().abs() + PAGED_BF16["atol"]
    return {"max_abs": float(err.max()), "ratio": float((err / limit).max())}


def paged_inputs(g, dev, B, KV, G, hd, ps, nb, q_dtype, page_dtype, lengths):
    """q, a K and V pool whose rows own nb shuffled pages past the trash page
    0, the block table and the lengths, made on the card from ``g``."""
    num_pages = 1 + B * nb
    q = torch.randn((B, KV, G, hd), generator=g, device=dev).to(q_dtype)
    k = torch.randn((num_pages, ps, KV, hd), generator=g, device=dev).to(page_dtype)
    v = torch.randn((num_pages, ps, KV, hd), generator=g, device=dev).to(page_dtype)
    perm = torch.randperm(num_pages - 1, generator=g, device=dev)[:B * nb] + 1
    table = perm.reshape(B, nb).to(torch.int32)
    return q, k, v, table, torch.tensor(lengths, dtype=torch.int32, device=dev)


def poison_tails(k, v, table, lengths) -> None:
    """Garbage (+-1e4, alternating) in each row's own pages past its length."""
    ps, nb = k.shape[1], table.shape[1]
    for b, n in enumerate(lengths):
        pos = torch.arange(n, nb * ps, device=k.device)
        page, off = table[b, pos // ps].long(), pos % ps
        sign = (pos % 2 * 2 - 1).to(k.dtype)[:, None, None]
        k[page, off] = 1e4 * sign
        v[page, off] = -1e4 * sign


def paged_cases(dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.paged_attention import paged_attention
    from repro_torch.kernels.flash_attention.ref import paged_attention_ref

    g = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    decode_lengths = [129, 1, 17, 64, 100, 33, 128, 16]
    rows = []
    for B, KV, G, hd, ps, nb, q_dtype, page_dtype, lengths, poison in [
            (8, 4, 8, 128, 16, 16, bf16, f32, decode_lengths, False),   # the decode cell
            (8, 4, 8, 128, 16, 256, bf16, bf16, LONG_LENGTHS, False),   # long rows
            (8, 4, 8, 128, 16, 256, bf16, f32, LONG_LENGTHS, False),
            (2, 2, 2, 64, 8, 4, f32, f32, [2, 12], False),              # tests/test_kernels.py
            (3, 1, 4, 32, 16, 2, f32, f32, [1, 19, 32], False),
            (1, 4, 1, 64, 8, 3, f32, f32, [9], False),
            (4, 4, 8, 128, 16, 16, bf16, f32, [5, 37, 1, 200], True),  # poisoned tails
            # qwen3-moe-235b-a22b's 16 query heads a KV head, at the decode cell's pages
            (8, 4, 16, 128, 16, 16, bf16, f32, decode_lengths, False),
            (8, 4, 16, 128, 16, 16, bf16, bf16, decode_lengths, False),
            # internvl2-26b's 6 query heads a KV head over 8 KV heads (phase 22)
            (8, 8, 6, 128, 16, 16, bf16, f32, decode_lengths, False),
            (8, 8, 6, 128, 16, 16, bf16, bf16, decode_lengths, False)]:
        q, k, v, table, lens = paged_inputs(g, dev, B, KV, G, hd, ps, nb, q_dtype,
                                            page_dtype, lengths)
        shape = (f"B={B} KV={KV} G={G} hd={hd} ps={ps} nb={nb} q {str(q_dtype)[6:]} "
                 f"pages {str(page_dtype)[6:]} lengths<={max(lengths)}")
        out = paged_attention(q, k, v, table, lens)
        if poison:
            poison_tails(k, v, table, lengths)
            if not torch.equal(paged_attention(q, k, v, table, lens), out):
                raise SystemExit(f"paged_attention [{shape}]: positions past the "
                                 "length leak into the output")
            shape += " poisoned"
        ref = paged_attention_ref(q, k, v, table, lens)
        e = paged_errors(out, ref)
        if not e["ratio"] <= 1:
            raise SystemExit(f"paged_attention [{shape}]: kernel vs plain outside the "
                             f"limit (f32: 4x TOL, bf16: {PAGED_BF16}): {e}")
        kept = [min(n, nb * ps) for n in lengths]
        page_bytes = sum(kept) * KV * hd * 2 * k.element_size()
        io_bytes = 2 * q.numel() * q.element_size() + 4 * (B + sum(-(-n // ps) for n in kept))
        b_ms, b_by = bound(page_bytes + io_bytes, 4 * hd * G * KV * sum(kept), f32)
        # yardstick: one SDPA over a dense copy gathered beforehand
        L = nb * ps
        kd = k[table.long()].reshape(B, L, KV, hd).transpose(1, 2)
        vd = v[table.long()].reshape(B, L, KV, hd).transpose(1, 2)
        qd = q.reshape(B, KV * G, 1, hd).to(page_dtype)
        mask = (torch.arange(L, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        rows.append(dict(
            shape=shape, max_abs_err=e["max_abs"], limit_ratio=e["ratio"],
            ms=time_ms(lambda: paged_attention(q, k, v, table, lens)),
            plain_ms=time_ms(lambda: paged_attention_ref(q, k, v, table, lens)),
            library_ms=None,
            yardstick_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by))
        if len(rows) <= 3 or G in (6, 16):    # the decode cell, the long rows, G 16, G 6
            rows[-1]["device_ms"] = device_ms(
                lambda: paged_attention(q, k, v, table, lens), "paged_attention")
        del kd, vd
    return rows


def gla_flops(L: int, chunk: int, dk: int, dv: int, inclusive: bool) -> float:
    """Operations one (row, head) needs, chunk by chunk: the kept (lower)
    triangle of the score cube (a difference, two products and a sum per
    element) and of the intra-chunk product, the cross-chunk product and the
    state update. Exponentials are not counted."""
    total = 0.0
    for l0 in range(0, L, chunk):
        n = min(chunk, L - l0)
        pairs = n * (n + 1) // 2 if inclusive else n * (n - 1) // 2
        total += 4 * pairs * dk + 2 * pairs * dv + 4 * n * dk * dv
    return total


def gla_kernel_rule(dtype: torch.dtype, L: int, dk: int, dv: int, chunk: int) -> str:
    """The selection rule csrc/gla_scan.cu states (and csrc/gla_scan_bwd.cu
    for the backward), written out apart from them:
    bf16 q, k, v with dk and dv multiples of 16 up to 128 and a chunk (cut to
    L) of 16, 32 or 64 take the tensor-core kernel."""
    mma = (dtype == torch.bfloat16 and dk % 16 == 0 and dv % 16 == 0 and dk <= 128
           and dv <= 128 and min(chunk, L) in (16, 32, 64))
    return "tensor-core" if mma else "CUDA-core"


def gla_cases(dev):
    from repro_torch.kernels.gla_scan.gla_scan import gla_scan, kernel_for
    from repro_torch.kernels.gla_scan.ref import gla_ref
    from repro_torch.models.linear_scan import gla_chunked

    g = torch.Generator(device=dev).manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    # (B, L, H, dk, dv, chunk, inclusive, qkv dtype, ld dtype, decay, scalar decay, s0)
    # decay: "model" draws ld as rwkv6 does (-exp(-6 + small noise)), a number
    # scales -|N(0, 1)| as tests/test_kernels.py does (0.5 moderate, 30 strong);
    # "mamba2" is models/mamba2.py::_ssd's form: ld = softplus(dt - 2) * -exp(A_log)
    # one a head, and q, k one B/C group broadcast over the heads (views with a
    # stride of 0 on h into a (B, L, conv_dim) product, as the model makes them)
    cases = [(BATCH, SEQ, 64, 64, 64, 64, False, bf16, f32, "model", False, False),  # main path
             (BATCH, SEQ, 64, 64, 64, 64, False, bf16, f32, 0.5, False, False),
             (BATCH, SEQ, 64, 64, 64, 64, False, f32, f32, "model", False, False),
             (2, SEQ, 80, 64, 64, 64, True, bf16, f32, 0.5, True, False),   # mamba2-style
             # zamba2-2.7b's main path: the model's own form (decay "mamba2")
             (BATCH, SEQ, 80, 64, 64, 64, True, bf16, f32, "mamba2", True, False),
             (BATCH, 1000, 64, 64, 64, 64, False, bf16, f32, "model", False, False),
             (2, 256, 8, 64, 64, 64, False, f32, f32, 0.5, False, True),    # given s0
             (2, 256, 8, 64, 64, 64, True, bf16, bf16, 0.5, False, True),
             (1, 128, 2, 16, 16, 32, False, f32, f32, 30.0, False, False),  # strong decay
             (1, 128, 2, 16, 16, 32, False, bf16, f32, 30.0, False, False),
             (2, 256, 8, 64, 64, 16, False, bf16, f32, "model", False, False),  # chunk 16
             (2, 256, 8, 32, 96, 64, True, bf16, f32, 0.5, False, True)]     # dk != dv
    for dtype in (f32, bf16):                        # tests/test_kernels.py sweep
        for L, chunk, inclusive, dk, dv in [(128, 32, True, 64, 64), (128, 32, False, 64, 64),
                                            (96, 16, False, 32, 48), (64, 64, True, 16, 128)]:
            cases.append((2, L, 3, dk, dv, chunk, inclusive, dtype, f32, 0.5, False, False))
    for B, L, H, dk, dv, chunk, inclusive, dtype, ld_dtype, decay, scalar, with_s0 in cases:
        broadcast = decay == "mamba2"
        if broadcast:
            xbc = torch.randn((B, L, H * dv + 2 * dk), generator=g, device=dev).to(dtype)
            k = xbc[..., H * dv:H * dv + dk][:, :, None, :].expand(B, L, H, dk)
            q = xbc[..., H * dv + dk:][:, :, None, :].expand(B, L, H, dk)
        else:
            q, k = (torch.randn((B, L, H, dk), generator=g, device=dev).to(dtype)
                    for _ in "qk")
        v = torch.randn((B, L, H, dv), generator=g, device=dev).to(dtype)
        noise = torch.randn((B, L, H, 1 if scalar else dk), generator=g, device=dev)
        if decay == "mamba2":
            a_log = 0.5 * torch.randn((H, 1), generator=g, device=dev)
            ld = (torch.nn.functional.softplus(noise - 2.0) * -torch.exp(a_log)).to(ld_dtype)
        else:
            ld = (-torch.exp(-6.0 + 0.1 * noise) if decay == "model"
                  else -noise.abs() * decay).to(ld_dtype)
        s0 = (torch.randn((B, H, dk, dv), generator=g, device=dev) if with_s0 else None)
        shape = (f"B={B} L={L} H={H} dk={dk} dv={dv} chunk={chunk} "
                 f"{'inclusive' if inclusive else 'exclusive'} qkv {str(dtype)[6:]} "
                 f"ld {str(ld_dtype)[6:]}{' per head' if scalar else ''} decay {decay}"
                 f"{' s0' if with_s0 else ''}"
                 f"{' q, k broadcast over heads (stride 0)' if broadcast else ''}")
        kernel = kernel_for(dtype, L, dk, dv, chunk)
        if kernel != gla_kernel_rule(dtype, L, dk, dv, chunk):
            raise SystemExit(f"gla_scan [{shape}]: the library selects the {kernel} kernel, "
                             f"the stated rule the {gla_kernel_rule(dtype, L, dk, dv, chunk)} one")
        shape += f" [{kernel}]"
        o, s = gla_scan(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk)
        if not (bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(s).all())):
            raise SystemExit(f"gla_scan [{shape}]: non-finite output")
        # the oracle in f64 on the same inputs: over 1024 weakly decayed steps
        # the f32 recurrence drifts from exact by more than the limit itself
        o_ref, s_ref = gla_ref(*(t.double() for t in (q, k, v, ld)),
                               None if s0 is None else s0.double(), inclusive=inclusive)
        # tests/test_kernels.py: atol 20 TOL, rtol TOL; its strong-decay case atol 1e-3
        atol = max(TOL[dtype] * 20, 1e-3 if decay == 30.0 else 0.0)
        err = max(check_close(f"gla_scan [{shape}] o", o, o_ref, atol, TOL[dtype]),
                  check_close(f"gla_scan [{shape}] state", s, s_ref, atol, TOL[dtype]))
        if dtype == f32:
            o32, _ = gla_ref(q, k, v, ld, s0, inclusive=inclusive)
            shape += f" (f32 oracle's own error {float((o32.double() - o_ref).abs().max()):.3e})"
        ld_elems = B * L * H * (1 if scalar else dk)
        # each input read once: a broadcast q or k is stored once, not a head
        qk_elems = 2 * (B * L * dk if broadcast else q.numel())
        rest = v.numel() * v.element_size() + ld_elems * ld.element_size() + \
            o.numel() * o.element_size() + s.numel() * 4 * (2 if with_s0 else 1)
        nbytes = qk_elems * q.element_size() + rest
        # the bound at the peak of the type the products run in (bf16 tensor
        # cores for bf16 q, k, v), and beside it the same count at the f32
        # CUDA-core peak (the table's bound before the tensor-core kernel)
        flops = B * H * gla_flops(L, chunk, dk, dv, inclusive)
        b_ms, b_by = bound(nbytes, flops, dtype)
        b32_ms, b32_by = bound(nbytes, flops, f32)
        extra = {}
        if broadcast:
            # what the kernel moves: every (b, h) block reads its rows of q and k
            per_block = 2 * q.numel() * q.element_size() + rest
            extra = dict(stored_mb=nbytes / 1e6, per_block_read_mb=per_block / 1e6,
                         per_block_read_ms=per_block / HBM_BYTES_PER_S * 1e3)
        rows.append(dict(
            shape=shape, max_abs_err=err, kernel=kernel, bound_f32=(b32_ms, b32_by), **extra,
            ms=time_ms(lambda: gla_scan(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk)),
            plain_ms=time_ms(lambda: gla_chunked(q, k, v, ld, s0, inclusive=inclusive,
                                                 chunk=chunk), iters=10, warmup=2),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return rows


def gla_bwd_flops(L: int, chunk: int, dk: int, dv: int, inclusive: bool) -> float:
    """Operations the backward needs for one (row, head), chunk by chunk
    (ref.gla_chunked_bwd's products): the kept triangle of the score cube P
    and of dq's and dk's intra-chunk sums over it (a difference, two
    products and a sum per element each), dP and dv's intra-chunk sum
    (2 dv a pair each), and five (n, dk, dv) products: dq's and dk's and
    dv's terms in the state and its gradient, the gradient's update and the
    recomputed starting state. Exponentials are not counted."""
    total = 0.0
    for l0 in range(0, L, chunk):
        n = min(chunk, L - l0)
        pairs = n * (n + 1) // 2 if inclusive else n * (n - 1) // 2
        total += 12 * pairs * dk + 4 * pairs * dv + 10 * n * dk * dv
    return total


def gla_bwd_cases(dev):
    """Phase 3c: the gla_scan backward kernel against ``gla_chunked_bwd`` in
    f64 on the same inputs (relative L2 of each gradient <= ``gla_bwd_limit``:
    GLA_BWD_TOL of its input type, GLA_BWD_F32_OUT_TOL for a gradient kept
    in f32 for bf16 inputs), at rwkv6-7b's flow shape (exclusive, per-channel
    decay), zamba2-2.7b's (inclusive, q and k one group broadcast over 80
    heads, one f32 decay a head, as models/mamba2.py::_ssd hands them
    over) and ragged f32 and bf16 cases with s0 and dS_final, each naming
    the kernel that ran (held to the forward's rule); timed beside the plain
    version (in the inputs' types) with its bound. No one PyTorch call
    computes the function."""
    from repro_torch.kernels.gla_scan.gla_scan import bwd_kernel_for, gla_scan_bwd
    from repro_torch.kernels.gla_scan.ref import gla_chunked_bwd

    g = torch.Generator(device=dev).manual_seed(31)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    # (B, L, H, dk, dv, chunk, form, qkv dtype, s0 and dS_final)
    for B, L, H, dk, dv, chunk, form, dtype, state in [
            (BATCH, SEQ, 64, 64, 64, 64, "rwkv6", bf16, False),    # rwkv6-7b's main path
            (BATCH, SEQ, 80, 64, 64, 64, "mamba2", bf16, False),   # zamba2-2.7b's
            (2, 1000, 8, 64, 64, 64, "rwkv6", f32, True),          # ragged, states
            (2, 1000, 8, 64, 64, 64, "rwkv6", bf16, True)]:
        group = form == "mamba2"
        if group:
            xbc = torch.randn((B, L, H * dv + 2 * dk), generator=g, device=dev).to(dtype)
            k = xbc[..., H * dv:H * dv + dk][:, :, None, :]
            q = xbc[..., H * dv + dk:][:, :, None, :]
            noise = torch.randn((B, L, H, 1), generator=g, device=dev)
            a_log = 0.5 * torch.randn((H, 1), generator=g, device=dev)
            ld = torch.nn.functional.softplus(noise - 2.0) * -torch.exp(a_log)
        else:
            q, k = (torch.randn((B, L, H, dk), generator=g, device=dev).to(dtype)
                    for _ in "qk")
            ld = -torch.exp(-6.0 + 0.1 * torch.randn((B, L, H, dk), generator=g, device=dev))
        v, do = (torch.randn((B, L, H, dv), generator=g, device=dev).to(dtype) for _ in "vo")
        s0, dS = ((torch.randn((B, H, dk, dv), generator=g, device=dev) for _ in "sd")
                  if state else (None, None))
        inclusive = group
        shape = (f"B={B} L={L} H={H} dk={dk} dv={dv} chunk={chunk} "
                 f"{'inclusive' if inclusive else 'exclusive'} qkv {str(dtype)[6:]} ld f32"
                 f"{' per head, q, k one group over the heads' if group else ''}"
                 f"{' s0 and dS_final' if state else ''}")
        kernel = bwd_kernel_for(dtype, L, dk, dv, chunk)
        if kernel != gla_kernel_rule(dtype, L, dk, dv, chunk):
            raise SystemExit(f"gla_scan_bwd [{shape}]: the library selects the {kernel} "
                             f"kernel, the stated rule the "
                             f"{gla_kernel_rule(dtype, L, dk, dv, chunk)} one")
        shape += f" [{kernel}]"

        def call():
            return gla_scan_bwd(q, k, v, ld, s0, do, dS, inclusive=inclusive, chunk=chunk)

        got = call()
        f64 = lambda t: None if t is None else t.double()  # noqa: E731
        want = gla_chunked_bwd(*map(f64, (q, k, v, ld, s0, do, dS)), inclusive=inclusive,
                               chunk=chunk)
        rels, limits, err = {}, {}, 0.0
        for what, x, w in zip(("dq", "dk", "dv", "dld", "ds0"), got, want):
            if w is None:
                continue
            if not bool(torch.isfinite(x.float()).all()):
                raise SystemExit(f"gla_scan_bwd [{shape}] {what}: non-finite")
            rels[what] = relative_l2(x.double(), w.cpu())
            limits[what] = gla_bwd_limit(dtype, x.dtype)
            err = max(err, float((x.double() - w).abs().max()))
        del want
        if not all(rels[k] <= limits[k] for k in rels):
            raise SystemExit(f"gla_scan_bwd [{shape}]: relative L2 against the f64 plain "
                             f"backward {rels}, limits {limits}")
        size = q.element_size()
        qk = 2 * q.numel() * size                 # a group's q and k stored once
        states = (3 * B * H * dk * dv * 4) if state else 0
        # inputs q, k, v, do, ld read once; dq, dk, dv, dld written once
        nbytes = 2 * (qk + 2 * v.numel() * size + ld.numel() * 4) - v.numel() * size + states
        flops = B * H * gla_bwd_flops(L, chunk, dk, dv, inclusive)
        b_ms, b_by = bound(nbytes, flops, dtype)
        b32_ms, b32_by = bound(nbytes, flops, f32)
        rows.append(dict(
            shape=shape, max_abs_err=err, relative_l2=rels, bound_f32=(b32_ms, b32_by),
            kernel=kernel,
            ms=time_ms(call, iters=10, warmup=2),
            device_ms=device_ms(call, "gla_scan_bwd", iters=5),
            plain_ms=time_ms(lambda: gla_chunked_bwd(q, k, v, ld, s0, do, dS,
                                                     inclusive=inclusive, chunk=chunk),
                             iters=2, warmup=1),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return rows


def ptxas_summary(name: str, log: Path) -> str:
    """Kernels, registers and spill bytes from the -Xptxas=-v report kept
    beside a library (build.py writes it when it compiles the source)."""
    if not log.exists():
        return f"ptxas {name}: no report (library not built in this run)"
    text = log.read_text()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", text))
    return (f"ptxas {name}: {len(regs)} kernels, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, {spills} bytes of spill stores")


def reset(counters) -> None:
    for c in counters.values():
        c.reset()


def free_device_memory(dev) -> None:
    gc.collect()                       # the previous phase's weights go first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def flow_path(dev, counters, arch: str, want: dict, graphs: dict, requests: int = REQUESTS,
              programs: bool = True, lm: bool = False) -> tuple[dict, dict]:
    """serve.main in flow mode at full width, ``requests`` requests; launch
    counts must be ``want``. Then (``lm``) phase 30's ``lm_apply`` on the
    served weights, into ``LM_RUNS``, and (``programs``) phase 15's case on
    the served sampler, into ``graphs``. Returns the launches and the run's
    request ms, peak memory, wall and capture ms."""
    from repro_torch.launch import serve

    free_device_memory(dev)
    reset(counters)
    t0 = time.perf_counter()
    served = serve.main(["--arch", arch, "--mode", "flow", "--full",
                         "--nfe", str(NFE), "--batch", str(BATCH), "--seq", str(SEQ),
                         "--requests", str(requests), "--bns-iters", "0"])
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    if launches != want:
        raise SystemExit(f"{arch} flow path launch counts {launches}, expected {want}")
    if len(served) != requests:
        raise SystemExit(f"{len(served)} requests answered, expected {requests}")
    for s in served:
        if s.latents.shape != (BATCH, SEQ, 64) or not bool(torch.isfinite(s.latents).all()):
            raise SystemExit(f"bad latents: shape {tuple(s.latents.shape)}")
        if (s.tokens.shape != (BATCH, SEQ) or int(s.tokens.min()) < 0
                or int(s.tokens.max()) >= VOCAB[arch]):
            raise SystemExit(f"bad tokens: shape {tuple(s.tokens.shape)}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"flow path: {arch} full width, NFE {NFE}, batch {BATCH}, seq {SEQ}: "
          f"request ms {[round(s.ms, 3) for s in served]}, launches {launches}, "
          f"peak memory {peak / 2**30:.3f} GiB, main() wall {wall:.3f} s, programs "
          f"{served.sampler.programs.stats()}")
    capture_ms = served.sampler.programs.stats().get("capture_ms")
    if lm:
        LM_RUNS[arch] = lm_apply_full_width(dev, counters, served.sampler)
    if programs:
        graphs.update(flow_programs(dev, counters, served.sampler, arch, SEQ))
    return launches, {"request_ms": [s.ms for s in served], "peak_gib": peak / 2**30,
                      "wall_s": wall, "capture_ms": capture_ms}


def lm_launches(cfg, window: int = 0) -> dict:
    """Phase 30's formula: the kernels one ``lm_apply`` launches (with a
    ``window``, phase 35's: no flash launch, where the family takes one)."""
    out = dict.fromkeys(KERNELS, 0)
    if cfg.family == "ssm":
        out["gla_scan"] = cfg.n_layers
    elif cfg.family == "hybrid":
        out["gla_scan"] = cfg.n_layers
        out["flash_attention"] = 0 if window else cfg.n_layers // cfg.hybrid_attn_every
    elif cfg.family == "encdec":
        out["flash_attention"] = cfg.n_encoder_layers + 2 * cfg.n_layers
    elif not window:
        out["flash_attention"] = cfg.n_layers
    return out


def lm_batch(cfg, B: int, S: int, device) -> dict:
    """``lm_apply``'s batch: numpy-seeded tokens, and the stub frontend's
    frames (encdec) or patches (vlm), 0.05 x standard normal, on ``device``."""
    rng = np.random.default_rng(S)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, S)))}
    if cfg.family in ("encdec", "vlm"):
        width = cfg.d_model if cfg.family == "encdec" else cfg.frontend.embed_dim
        stub = 0.05 * rng.standard_normal((B, cfg.frontend.num_tokens, width))
        batch["frames" if cfg.family == "encdec" else "patches"] = torch.from_numpy(
            stub.astype(np.float32))
    return {k: v.to(device) for k, v in batch.items()}


def lm_apply_full_width(dev, counters, sampler) -> dict:
    """Phase 30 at full width: ``lm_apply(last_only=True)`` on the served
    weights, batch BATCH x LM_SEQ (a warm-up call, then a timed one): launches
    equal to the formula, finite (B, 1, V) logits, ms and peak memory. On
    yi-6b also the full call and the decode check (module docstring)."""
    from repro_torch.models import model as M

    cfg, params = sampler.cfg, sampler.params
    batch = lm_batch(cfg, BATCH, LM_SEQ, dev)
    with torch.no_grad():
        M.lm_apply(params, cfg, batch, last_only=True)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = {name: c.launches for name, c in counters.items()}
        t0 = time.perf_counter()
        last = M.lm_apply(params, cfg, batch, last_only=True)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        ran = launched(counters, before)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    want = lm_launches(cfg)
    if ran != want:
        raise SystemExit(f"{cfg.name} lm_apply launched {ran}, expected {want}")
    if last.shape != (BATCH, 1, cfg.vocab) or not bool(torch.isfinite(last).all()):
        raise SystemExit(f"{cfg.name} lm_apply: logits {tuple(last.shape)}, finite "
                         f"{bool(torch.isfinite(last).all())}")
    out = {"ms": ms, "peak_gib": peak, "launches": {k: v for k, v in ran.items() if v}}
    if cfg.name == "yi-6b":
        out.update(lm_decode_check(dev, cfg, params, batch, last))
    print(f"phase 30 [{cfg.name}]: lm_apply last_only, batch {BATCH} x {LM_SEQ}, full width "
          f"and depth: {ms:.1f} ms, peak {peak:.3f} GiB, launches {out['launches']} (the "
          f"formula)" + "".join(f", {k} {v}" for k, v in out.items()
                                if k not in ("ms", "peak_gib", "launches")))
    return out


def dryrun_paths(card: str) -> dict:
    """Phase 36: the dry run in two subprocesses, run together (module
    docstring). Fails where either fails or the reckoned peak misses phase
    30's measured one by more than DRYRUN_PEAK_TOL."""
    t0 = time.perf_counter()
    outdir = ROOT / "build" / "chip_smoke" / "dryrun"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    host = (f"import json; from repro_torch.launch import dryrun; print('reckoned ' + "
            f"json.dumps(dryrun.reckon_host('yi-6b', dict(kind='prefill', batch={BATCH}, "
            f"seq={LM_SEQ}))))")
    procs = {"pod": subprocess.Popen(
                 [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "yi-6b",
                  "--shape", "decode_32k", "--outdir", str(outdir)],
                 cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
             "host": subprocess.Popen([sys.executable, "-c", host], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)}
    logs = {}
    try:
        for k, proc in procs.items():
            logs[k] = proc.communicate(timeout=DRYRUN_TIMEOUT_S)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k, proc in procs.items():
        if proc.returncode != 0:
            raise SystemExit(f"phase 36 [{k}] exited {proc.returncode}:\n{logs[k][-4000:]}")
    pod = json.loads((outdir / "yi-6b__decode_32k__pod16x16.json").read_text())
    line = [x for x in logs["host"].splitlines() if x.startswith("reckoned ")][-1]
    reckoned = json.loads(line[len("reckoned "):])["memory"]["peak_size_in_bytes"] / 2**30
    measured = LM_RUNS["yi-6b"]["peak_gib"]
    mem = pod["memory"]
    coll = sum(v for k, v in pod["collectives"].items() if not k.endswith("_count"))
    out = {"decode_32k_pod16x16": {
               "argument_gib": mem["argument_size_in_bytes"] / 2**30,
               "temp_gib": mem["temp_size_in_bytes"] / 2**30,
               "peak_gib": mem["peak_size_in_bytes"] / 2**30, "tflop": pod["flops"] / 1e12,
               "collective_gb": coll / 1e9, "trace_s": pod["lower_s"]},
           "lm_apply_peak_gib": {"reckoned": reckoned, "measured_phase_30": measured,
                                 "ratio": reckoned / measured},
           "s": time.perf_counter() - t0}
    d = out["decode_32k_pod16x16"]
    print(f"phase 36 [yi-6b decode_32k, 16 x 16 fake mesh, card's paths]: a rank holds "
          f"{d['argument_gib']:.3f} GiB of arguments, temp {d['temp_gib']:.3f} GiB, peak "
          f"{d['peak_gib']:.3f} GiB; {d['tflop']:.4f} TFLOP; collectives {d['collective_gb']:.4f} "
          f"GB {dict(pod['collectives'])}; trace {d['trace_s']} s")
    print(f"phase 36 [memory tracker] ({card}): yi-6b lm_apply(last_only) {BATCH} x {LM_SEQ} "
          f"reckoned on a 1 x 1 fake world {reckoned:.3f} GiB, measured in phase 30 "
          f"{measured:.3f} GiB, ratio {reckoned / measured:.4f} (within {DRYRUN_PEAK_TOL:.0%})")
    if abs(reckoned / measured - 1) > DRYRUN_PEAK_TOL:
        raise SystemExit(f"phase 36: reckoned peak {reckoned:.3f} GiB is not within "
                         f"{DRYRUN_PEAK_TOL:.0%} of the measured {measured:.3f} GiB")
    return out


def lm_decode_check(dev, cfg, params, batch: dict, last: torch.Tensor) -> dict:
    """yi-6b at full width: the full call's last row against ``last_only``'s
    (bf16, within 2e-2), and ``decode_apply`` token by token over the first
    LM_DECODE_STEPS positions against the full call's logits there, on an
    f32 copy of the weights (``tests/test_archs_smoke.py``'s check: within
    2e-2, the same argmax). In bf16 the two paths round at different places
    through 32 layers: their distance is printed, not held."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import cast_params

    def decoded(weights) -> torch.Tensor:
        state = M.init_decode_state(cfg, BATCH, LM_DECODE_STEPS, weights["embed"].dtype, dev)
        return torch.stack([M.decode_apply(weights, cfg, batch["tokens"][:, i], state)[0]
                            for i in range(LM_DECODE_STEPS)], dim=1).float()

    bf16 = TOL[torch.bfloat16]
    with torch.no_grad():
        full = M.lm_apply(params, cfg, batch)
        err_last = check_close("lm_apply full vs last_only", full[:, -1:], last,
                               atol=bf16, rtol=bf16)
        head = full[:, :LM_DECODE_STEPS].float()
        del full
        gap = (decoded(params) - head).abs()
        out = {"full_vs_last_max_abs": err_last,
               "bf16_decode_vs_lm_max_abs": float(gap.max()),
               "bf16_decode_vs_lm_outside_2e-2": float((gap > bf16 + bf16 * head.abs())
                                                       .float().mean())}
        del gap, head
        weights = cast_params(params, torch.float32)
        ref = M.lm_apply(weights, cfg, batch)[:, :LM_DECODE_STEPS].float()
        dec = decoded(weights)
        del weights
    out["decode_vs_lm_max_abs"] = check_close("decode_apply vs lm_apply (f32 weights)", dec,
                                              ref, atol=bf16, rtol=bf16)
    out["decode_argmax_equal"] = bool(torch.equal(dec.argmax(-1), ref.argmax(-1)))
    if not out["decode_argmax_equal"]:
        raise SystemExit(f"decode_apply vs lm_apply: argmax differs at "
                         f"{int((dec.argmax(-1) != ref.argmax(-1)).sum())} positions")
    return out


def lm_against_cpu(dev, counters, cfg, params, on_card=None, window: int = 0,
                   label: str = "phase 30") -> float:
    """Phase 30 on a phase's cut f32 model: ``lm_apply`` on the card
    (``on_card``, or ``params`` copied there) and on the CPU (``params``),
    batch 2 x LM_CPU_SEQ, the same inputs, at ``window`` (phase 35b): relative
    L2 of the logits <= 1e-4, the card run's launches equal to the formula."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import params_to

    batch = lm_batch(cfg, 2, LM_CPU_SEQ, "cpu")
    card_params = params_to(params, dev) if on_card is None else on_card
    before = {name: c.launches for name, c in counters.items()}
    with torch.no_grad():
        got = M.lm_apply(card_params, cfg, {k: v.to(dev) for k, v in batch.items()},
                         window=window)
        torch.cuda.synchronize(dev)
        ran = launched(counters, before)
        want = M.lm_apply(params, cfg, batch, window=window)
    if ran != lm_launches(cfg, window):
        raise SystemExit(f"{cfg.name} lm_apply card run launched {ran}, expected "
                         f"{lm_launches(cfg, window)}")
    rel = relative_l2(got.cpu(), want)
    what = f"lm_apply(window={window})" if window else "lm_apply"
    print(f"{label} [{cfg.name}]: {what} card vs CPU ({cfg.n_layers} layers, f32, batch 2 x "
          f"{LM_CPU_SEQ}): relative L2 {rel:.3e} (limit 1e-4), card launches "
          f"{ {k: v for k, v in ran.items() if v} }")
    if not rel <= 1e-4:
        raise SystemExit(f"{what} {cfg.name}: card vs CPU relative L2 {rel} over 1e-4")
    if not window:
        LM_RUNS.setdefault("card_vs_cpu", {})[cfg.name] = rel
    return rel


def window_against_cpu(dev, counters, cfg, params, on_card=None) -> dict:
    """Phase 35b on a phase's cut f32 model (dense, moe, hybrid or vlm):
    ``lm_against_cpu`` at WINDOW_CPU, then again under an installed context
    with ``q_chunk`` Q_CHUNK (both sides; a host-only mesh of 1 x 1 axis
    sizes, so ``constrain`` passes plain tensors through), where every
    attention must run the query-chunked path, ``_chunked_attend``, on both
    sides."""
    from repro_torch.distributed import context
    from repro_torch.models import attention

    out = {"window": lm_against_cpu(dev, counters, cfg, params, on_card, WINDOW_CPU,
                                    "phase 35b")}
    inner, chunked = attention._chunked_attend, []

    def counted(q, *rest):
        chunked.append(q.device.type)
        return inner(q, *rest)

    attention._chunked_attend = counted
    context.install({"data": 1, "model": 1}, q_chunk=Q_CHUNK)
    try:
        out["q_chunk"] = lm_against_cpu(dev, counters, cfg, params, on_card, WINDOW_CPU,
                                        f"phase 35b, q_chunk {Q_CHUNK}")
    finally:
        context.clear()
        attention._chunked_attend = inner
    sites = cfg.n_layers // (cfg.hybrid_attn_every if cfg.family == "hybrid" else 1)
    out["chunked_calls"] = {d: chunked.count(d) for d in ("cuda", "cpu")}
    print(f"phase 35b [{cfg.name}]: under q_chunk {Q_CHUNK}, _chunked_attend ran "
          f"{out['chunked_calls']} times (card, CPU; {sites} attention layers a call)")
    if out["chunked_calls"] != {"cuda": sites, "cpu": sites}:
        raise SystemExit(f"phase 35b [{cfg.name}]: the q_chunk context did not route "
                         f"attention through _chunked_attend: {out['chunked_calls']}")
    WINDOW_RUNS.setdefault("35b", {})[cfg.name] = out
    return out


def twins(dev, counters, card: str) -> dict:
    """Phase 31: each twin's ``main`` in-process on the card at TWIN_ARGS,
    its board printed; returns seconds and launches a twin."""
    import importlib.util

    out = {}
    for name, args in TWIN_ARGS.items():
        spec = importlib.util.spec_from_file_location(
            f"twin_{name}", ROOT / "examples" / "torch" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        free_device_memory(dev)
        before = {k: c.launches for k, c in counters.items()}
        t0 = time.perf_counter()
        print(f"phase 31 [{' '.join([name, *args])}] ({card}):")
        result = mod.main(["--device", "cuda", *args])
        torch.cuda.synchronize(dev)
        out[name] = {"s": time.perf_counter() - t0,
                     "launches": {k: v for k, v in launched(counters, before).items() if v}}
        if name == "quickstart":
            out[name]["psnr"] = result
        print(f"phase 31 [{name}]: {out[name]['s']:.1f} s, launches {out[name]['launches']}")
    return out


def small_model(arch: str):
    """The arch's width cut to 2 layers, f32, random weights on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch)
    # a hybrid model keeps one shared-attention site over its two Mamba2 layers
    site = {"hybrid_attn_every": 2} if cfg.family == "hybrid" else {}
    cfg = dataclasses.replace(cfg, n_layers=2, dtype="float32", **site)
    return cfg, M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")


def euler_inputs(cfg, params):
    """The CPU checks' inputs: batch 2 x 128 of synthetic tokens, seeded
    numpy noise, and a FlowSampler's keywords for euler NFE 4 on fm_ot."""
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.solvers.registry import build_ns

    batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                            device="cpu").batch(0)
    x0 = np.random.default_rng(0).standard_normal((2, 128, cfg.latent_dim)).astype(np.float32)
    field = M.velocity_field(params, cfg, get_scheduler("fm_ot"), batch)
    return batch, x0, dict(cfg=cfg, sched=field.scheduler, solver=build_ns("euler", 4, field))


def whole_path_against_cpu(dev, counters, cfg, params, want: dict, card_params=None):
    """Phase 5 and its twins: euler NFE 4 on the card (``card_params``, or
    ``params`` copied there) and on the CPU (``params``), batch 2 x 128, the
    same tokens and noise: relative L2 of the latents <= 1e-4; the card run
    launches exactly ``want``."""
    from repro_torch.models.transformer import params_to
    from repro_torch.serving.engine import FlowSampler

    batch, x0, kw = euler_inputs(cfg, params)
    before = {name: c.launches for name, c in counters.items()}
    on_card = FlowSampler(params=params_to(params, dev) if card_params is None
                          else card_params, **kw).sample_from(batch, x0)
    torch.cuda.synchronize(dev)
    ran = {name: c.launches - before[name] for name, c in counters.items()}
    if ran != want:
        raise SystemExit(f"{cfg.name} card run launched {ran}, expected {want}")
    on_cpu = FlowSampler(params=params, **kw).sample_from(batch, x0)
    rel = float(torch.linalg.vector_norm(on_card.cpu() - on_cpu)
                / torch.linalg.vector_norm(on_cpu))
    print(f"whole path, {cfg.name}, card kernels vs CPU plain ({cfg.n_layers} layers, f32, euler "
          f"NFE 4): relative L2 {rel:.3e} (limit 1e-4)")
    if not rel <= 1e-4:
        raise SystemExit(f"whole path {cfg.name}: relative L2 {rel} over 1e-4")
    return rel


class PerRequest:
    """Each ``FlowSampler.sample`` call's kernel launches, read from the
    counters around it (the launcher samples each request through it)."""

    def __init__(self, counters):
        from repro_torch.serving import engine

        self.cls, self.inner, self.counters, self.runs = engine.FlowSampler, None, counters, []

    def __enter__(self):
        self.inner = self.cls.sample

        def counted(sampler, *args, **kwargs):
            before = {name: c.launches for name, c in self.counters.items()}
            out = self.inner(sampler, *args, **kwargs)
            self.runs.append({name: c.launches - before[name]
                              for name, c in self.counters.items()})
            return out

        self.cls.sample = counted
        return self

    def __exit__(self, *exc):
        self.cls.sample = self.inner


def baselines_served(dev, counters, card: str) -> dict:
    """Phase 4b: each baseline at NFE 8, built for yi-6b's fm_ot field, saved
    as a baseline ``ns`` artifact and served by serve.main with phase 4's
    flags plus --requests 2 and --solver-artifact: exact launches a request,
    a load and no distillation, the served NSParams equal to the built ones
    to the bit, finite latents."""
    from repro_torch.configs import get_config
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.solvers import SolverArtifact, SolverSpec

    # the build reads the field's scheduler only: no weights behind this closure
    field = M.velocity_field({}, get_config("yi-6b", smoke=False), get_scheduler("fm_ot"))
    per_request = {**dict.fromkeys(KERNELS, 0), "ns_update": NFE,
                   "flash_attention": LAYERS * NFE}
    out = {"launches": dict.fromkeys(KERNELS, 0), "request_ms": {}}
    for name in BASELINES:
        spec = SolverSpec(name, NFE)
        built = spec.build(field)
        path = ROOT / "build" / "chip_smoke" / f"{name}_nfe{NFE}.msgpack"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.unlink(missing_ok=True)
        SolverArtifact(spec=spec, params=built, val_psnr=float("nan"),
                       provenance={"arch": "yi-6b", "scheduler": "fm_ot"}).save(str(path))
        free_device_memory(dev)
        reset(counters)
        t0 = time.perf_counter()
        with Tee() as text, PerRequest(counters) as runs:
            served = serve.main(["--arch", "yi-6b", "--mode", "flow", "--full",
                                 "--nfe", str(NFE), "--batch", str(BATCH), "--seq", str(SEQ),
                                 "--requests", str(BASELINE_REQUESTS), "--bns-iters", "0",
                                 "--solver-artifact", str(path)])
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        same = all(torch.equal(a.cpu(), b) for a, b in zip(served.sampler.solver, built))
        z = served.zoo
        finite = [bool(torch.isfinite(x.latents).all()) and x.latents.shape == (BATCH, SEQ, 64)
                  for x in served]
        a_max, b_max = float(built.a.abs().max()), float(built.b.abs().max())
        print(f"baseline {name} NFE {NFE} served (yi-6b full width, batch {BATCH}, seq "
              f"{SEQ}, {card}): request ms {[round(x.ms, 3) for x in served]}, launches a "
              f"request {runs.runs}, zoo {z}, NSParams equal to the built ones: {same}, "
              f"max |a| {a_max:.4g}, max |b| {b_max:.4g}, main() wall {wall:.3f} s")
        if (runs.runs != [per_request] * BASELINE_REQUESTS
                or launches != {k: v * BASELINE_REQUESTS for k, v in per_request.items()}
                or (z.loads, z.distills) != (1, 0) or "no retraining" not in text.text
                or served.artifact.spec != spec or not same or not all(finite)
                or len(served) != BASELINE_REQUESTS):
            raise SystemExit(f"baseline {name} served wrong: launches {runs.runs} (expected "
                             f"{per_request} a request), zoo {z}, solver equal {same}, "
                             f"finite latents {finite}")
        out["request_ms"][name] = [x.ms for x in served]
        for k in KERNELS:
            out["launches"][k] += launches[k]
    return out


def relative_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b|, on b's device."""
    return float(torch.linalg.vector_norm(a.to(b.device) - b) / torch.linalg.vector_norm(b))


def baselines_against_cpu(dev, counters, cfg, params) -> dict:
    """Phase 5b: the new solver paths on the card (kernels) against the CPU
    (plain versions), phase 5's 2-layer f32 model, relative L2 <= 1e-4:
    ddim, dpm2m and edm_heun at NFE 8 under fm_ot and vp, midpoint with
    sigma0 = 2, and a BST-Euler solver at NFE 4 with random knots, run
    directly (no ns_update launch) and through its to_ns parameters sampled
    by ns_sample (the ST ⊂ NS inclusion of Theorem 3.2)."""
    from repro_torch.core import bst_solver, taxonomy
    from repro_torch.core.ns_solver import ns_sample
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.models.transformer import params_to
    from repro_torch.solvers.registry import build_ns

    batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                            device="cpu").batch(0)
    card_params = params_to(params, dev)
    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 128, cfg.latent_dim)).astype(np.float32))

    def fields(sname):
        sched = get_scheduler(sname)
        return (M.velocity_field(params, cfg, sched, batch),
                M.velocity_field(card_params, cfg, sched,
                                 {k: v.to(dev) for k, v in batch.items()}))

    total = dict.fromkeys(KERNELS, 0)

    def on_card(fn, want):
        before = {name: c.launches for name, c in counters.items()}
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize(dev)
        ran = {name: c.launches - before[name] for name, c in counters.items()}
        for name in KERNELS:
            total[name] += ran[name]
        return out, ran == {**dict.fromkeys(KERNELS, 0), **want}, ran

    cases, failed = {}, []
    for sname in ("fm_ot", "vp"):
        cpu_f, card_f = fields(sname)
        runs = [(name, build_ns(name, NFE, cpu_f)) for name in BASELINES]
        if sname == "fm_ot":
            runs.append(("midpoint sigma0=2", build_ns("midpoint", NFE, cpu_f, sigma0=2.0)))
        for name, ns in runs:
            with torch.no_grad():
                ref = ns_sample(ns, cpu_f.fn, x0)
            got, ok, ran = on_card(lambda: ns_sample(ns, card_f.fn, x0.to(dev)),
                                   {"ns_update": NFE, "flash_attention": 2 * NFE})
            key = f"{name} {sname}"
            cases[key] = {"rel_l2": relative_l2(got, ref), "max_abs_a": float(ns.a.abs().max()),
                          "max_abs_b": float(ns.b.abs().max()), "launches_ok": ok}
            if not ok:
                failed.append(f"{key}: launched {ran}")
    cpu_f, card_f = fields("fm_ot")
    rng = np.random.default_rng(17)
    k = bst_solver.knot_positions(4, "euler").shape[0]
    theta = bst_solver.bst_params_from_numpy(*((0.2 * rng.standard_normal(n)).astype(
        np.float32) for n in (k - 1, k, k, k)))
    knots = bst_solver.materialize_bst(theta)
    prog = bst_solver.bst_euler_program
    with torch.no_grad():
        ref = taxonomy.run_direct(prog, cpu_f, x0, knots)
    got, ok, ran = on_card(lambda: taxonomy.run_direct(
        prog, card_f, x0.to(dev), bst_solver.materialize_bst(
            bst_solver.BSTParams(*(p.to(dev) for p in theta)))), {"flash_attention": 2 * 4})
    cases["bst euler run_direct"] = {"rel_l2": relative_l2(got, ref), "launches_ok": ok}
    if not ok:
        failed.append(f"bst run_direct: launched {ran}")
    ns = taxonomy.to_ns(prog, knots)
    got, ok, ran = on_card(lambda: ns_sample(ns, card_f.fn, x0.to(dev)),
                           {"ns_update": 4, "flash_attention": 2 * 4})
    cases["bst euler to_ns, ns_sample"] = {"rel_l2": relative_l2(got, ref), "launches_ok": ok}
    if not ok:
        failed.append(f"bst to_ns: launched {ran}")
    for key, c in cases.items():
        extra = (f", max |a| {c['max_abs_a']:.4g}, max |b| {c['max_abs_b']:.4g}"
                 if "max_abs_a" in c else "")
        print(f"5b {key}, yi-6b 2 layers f32, card vs CPU: relative L2 {c['rel_l2']:.3e} "
              f"(limit 1e-4){extra}")
        if not c["rel_l2"] <= 1e-4:
            failed.append(f"{key}: relative L2 {c['rel_l2']} over 1e-4")
    if failed:
        raise SystemExit("phase 5b: " + "; ".join(failed))
    return {"cases": cases, "launches": total}


class CountCalls:
    """Counts (and optionally records the logits of) ``decode_apply`` calls,
    apart from any kernel's counter, by wrapping the model function the
    engine calls. The count is a ``LaunchCounter`` of its own, so a replayed
    CUDA graph adds the calls its program recorded at capture, as it adds
    kernel launches. Recording logits reads each call's result on the host,
    which a replay cannot do: the engines then run eagerly
    (``programs.disabled()``)."""

    def __init__(self, keep_logits: bool = False):
        from repro_torch.kernels import build
        from repro_torch.models import model as M

        self.module, self.inner = M, M.decode_apply
        self.counter = build.LaunchCounter("decode_apply")
        self.keep, self.logits, self.eager = keep_logits, [], None

    @property
    def calls(self) -> int:
        return self.counter.launches

    def __enter__(self):
        from repro_torch.serving import programs

        def counted(*args, **kwargs):
            logits, state = self.inner(*args, **kwargs)
            self.counter.launches += 1
            if self.keep:
                self.logits.append(logits.float().cpu())
            return logits, state

        if self.keep:
            self.eager = programs.disabled()
            self.eager.__enter__()
        self.module.decode_apply = counted
        return self

    def __exit__(self, *exc):
        self.module.decode_apply = self.inner
        if self.eager is not None:
            self.eager.__exit__(*exc)


def decode_path(dev, counters, args: list, per_call: dict, graphs: dict,
                runs: dict | None = None, **cases):
    """serve.main in decode mode at full width through the gateway: every
    request finishes at its length with in-vocabulary tokens, nothing fails,
    every page returns, and each kernel launches ``per_call[name]`` times a
    ``decode_apply`` call (0 where it is not named). Then phase 15's cases on
    the served engine (``decode_programs``' ``prefill`` and ``sampled``; with
    ``growth``, ``workspace_growth`` too), into ``graphs`` under ``label``
    (default the arch); the run's tokens/s, engine call ms and peak memory
    into ``runs`` where given."""
    from repro_torch.launch import serve

    free_device_memory(dev)
    reset(counters)
    with CountCalls() as calls:
        served = serve.main(args)
    launches = {name: c.launches for name, c in counters.items()}
    arch = args[args.index("--arch") + 1]
    n = int(args[args.index("--requests") + 1])
    slots = args[args.index("--max-slots") + 1]
    lengths = [int(x) for x in args[args.index("--decode-lengths") + 1].split(",")]
    s = served.stats
    if len(served.responses) != n or any(r is None for r in served.responses):
        raise SystemExit(f"{arch} decode path: a request was rejected or shed")
    for i, r in enumerate(served.responses):
        toks, want_len = r.tokens.tolist(), lengths[i % len(lengths)]
        if r.meta["finish_reason"] != "length" or len(toks) != want_len:
            raise SystemExit(f"{arch} decode path: {r.meta}, {len(toks)} tokens, "
                             f"expected {want_len}")
        if min(toks) < 0 or max(toks) >= VOCAB[arch]:
            raise SystemExit(f"{arch} decode path: token outside the vocabulary in {toks}")
    if s["failed"] or s.get("pages_in_use", 0) or s["completed"] != n:
        raise SystemExit(f"{arch} decode path: failed {s['failed']}, pages in use "
                         f"{s.get('pages_in_use')}, completed {s['completed']}")
    want = {name: per_call.get(name, 0) * calls.calls for name in KERNELS}
    if launches != want or calls.calls == 0:
        raise SystemExit(f"{arch} decode path launch counts {launches}, expected {want} "
                         f"({calls.calls} decode_apply calls)")
    d = served.metrics["device_dispatch_ms"]
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"decode path: {arch} full width, {n} requests on {slots} slots: "
          f"{s['tokens_out']} tokens in {served.wall_s:.3f} s ({s['tokens_per_s']:.1f} tokens/s "
          f"by the gateway clock), {s['forwards']} engine calls ({s['prefill_calls']} "
          f"prefill, {s['prefill_tokens']} prompt tokens), {calls.calls} decode_apply calls, "
          f"engine call ms mean {d['sum'] / d['count']:.3f} p50 {d['p50']:.3f} "
          f"max {d['max']:.3f}, launches {launches}, peak memory {peak / 2**30:.3f} GiB, "
          f"programs captured {s['program_captures']}, replays {s['program_replays']}, "
          f"capture {s['program_capture_ms']:.1f} ms")
    engine = served.engine
    slots = int(args[args.index("--max-slots") + 1])
    cache_slots = int(args[args.index("--slots") + 1]) if "--slots" in args else 128
    graphs.update(decode_programs(dev, counters, engine, cases.get("label", arch), slots,
                                  cache_slots, cases.get("prefill", 0),
                                  cases.get("sampled", False), cases.get("start")))
    if cases.get("growth"):
        graphs["yi-6b paged workspace growth"] = workspace_growth(dev, counters, engine)
    if runs is not None:
        runs.update(tokens_per_s=s["tokens_per_s"], tokens=s["tokens_out"],
                             wall_s=served.wall_s, calls=calls.calls, peak_gib=peak / 2**30,
                             call_ms_mean=d["sum"] / d["count"], call_ms_p50=d["p50"])
    return launches


def long_row_decode_step(dev, counters) -> dict:
    """Phase 6b: one yi-6b decode step at full width over 8 rows of up to
    4096 positions, through the paged kernel and through the dense gather."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    free_device_memory(dev)
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=LAYERS)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    B, ps, nb = len(LONG_LENGTHS), 16, 256
    state = M.init_paged_decode_state(cfg, B, 1 + B * nb, ps, nb, torch.float32, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    table = (torch.randperm(B * nb, generator=g, device=dev) + 1).reshape(B, nb)
    state.block_table.copy_(table.to(torch.int32))
    # random K/V a layer at a time, bf16 values in the f32 pool, as the bf16
    # model's own writes to an f32 slot state are
    for pool in (state.k_pages, state.v_pages):
        for layer in pool:
            layer.copy_(torch.randn(layer.shape, generator=g, device=dev).to(torch.bfloat16))
    positions = torch.tensor(LONG_LENGTHS, dtype=torch.int32, device=dev) - 1
    token = torch.arange(B, dtype=torch.int32, device=dev) * 7 + 3

    def step(p, kernel: bool):
        # decode_apply advances the positions in place: every call starts from
        # the same ones (and rewrites the same pool cells)
        state.index.copy_(positions)
        return M.decode_apply(p, cfg, token, state, paged_kernel=kernel)[0]

    zero = dict.fromkeys(KERNELS, 0)
    with torch.no_grad():
        reset(counters)
        logits = {kernel: step(params, kernel).float() for kernel in (True, False)}
        torch.cuda.synchronize(dev)
        launches = {name: c.launches for name, c in counters.items()}
        if launches != {**zero, "paged_attention": LAYERS}:
            raise SystemExit(f"long-row decode step launched {launches} for one kernel "
                             f"call and one dense call, expected {LAYERS} paged")
        kernel_ms = time_ms(lambda: step(params, True), iters=5, warmup=2)
        dense_ms = time_ms(lambda: step(params, False), iters=5, warmup=2)
        kernel_dev = device_ms(lambda: step(params, True), "paged_attention", iters=3)
        all_dev = device_ms(lambda: step(params, True), None, iters=3)
        rel16 = float(torch.linalg.vector_norm(logits[True] - logits[False])
                      / torch.linalg.vector_norm(logits[False]))
        params = _to_f32(params)                         # the f32 copy replaces it
        torch.cuda.empty_cache()
        logits32 = {kernel: step(params, kernel).float() for kernel in (True, False)}
    rel32 = float(torch.linalg.vector_norm(logits32[True] - logits32[False])
                  / torch.linalg.vector_norm(logits32[False]))
    same = bool(torch.equal(logits32[True].argmax(-1), logits32[False].argmax(-1)))
    peak = torch.cuda.max_memory_allocated(dev)
    kd = "not measured" if kernel_dev is None else f"{kernel_dev:.4f} ms"
    ad = "not measured" if all_dev is None else f"{all_dev:.3f} ms"
    print(f"long-row decode step: yi-6b full width, {B} rows of up to "
          f"{max(LONG_LENGTHS)} positions (f32 pages, {2 * state.k_pages.numel() * 4 / 1e9:.2f} GB): "
          f"decode_apply with the paged kernel {kernel_ms:.3f} ms, with the dense gather "
          f"{dense_ms:.3f} ms; paged kernel device time {kd} a call ({LAYERS} launches), "
          f"all kernels' device time {ad} a call; logits kernel vs dense relative L2 "
          f"{rel16:.3e} with bf16 weights (the dense gather rounds scores and weights "
          f"to bf16), {rel32:.3e} with the f32 copy (limit 1e-4), greedy tokens equal "
          f"(f32): {same}; peak memory {peak / 2**30:.3f} GiB")
    if not (rel32 <= 1e-4 and same):
        raise SystemExit(f"long-row decode step: kernel vs dense gather on the f32 weights: "
                         f"relative L2 {rel32}, same tokens {same}")
    del params, state, logits, logits32
    free_device_memory(dev)
    return {"kernel_path_ms": kernel_ms, "dense_gather_ms": dense_ms,
            "kernel_device_ms": kernel_dev, "all_kernels_device_ms": all_dev}


def _to_f32(tree):
    """The parameter tree with every floating tensor in f32."""
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_f32(v) for v in tree)
    return tree.float() if torch.is_floating_point(tree) else tree


def decode_against_cpu(dev, counters, cfg, params, engine_kw: dict, per_call: dict,
                       cache_slots: int = 32, lengths=(6, 3, 5, 2)):
    """The same gateway requests on the card and on the CPU (two-token
    prompts, ``lengths`` new tokens, ``cache_slots`` positions a slot): every
    step's logits within relative L2 1e-4 and the same greedy tokens; on the
    card each kernel launches ``per_call[name]`` times a ``decode_apply``
    call."""
    from repro_torch.models.transformer import params_to
    from repro_torch.serving.decode import DecodeGateway, DecodeRequest
    from repro_torch.serving.engine import DecodeEngine

    def serve_on(p):
        engine = DecodeEngine(params=p, cfg=cfg, **engine_kw)
        gw = DecodeGateway(engine, max_slots=2, cache_slots=cache_slots, prefill_chunk=4)
        futures = [gw.submit(DecodeRequest(prompt=[(3 * r + 1) % cfg.vocab,
                                                   (5 * r + 2) % cfg.vocab],
                                           max_tokens=n))
                   for r, n in enumerate(lengths)]
        with CountCalls(keep_logits=True) as rec:
            while not all(f.done() for f in futures):
                gw.pump()
        return [f.result().tokens.tolist() for f in futures], rec.logits

    before = {name: c.launches for name, c in counters.items()}
    card_tokens, card_logits = serve_on(params_to(params, dev))
    ran = {name: c.launches - before[name] for name, c in counters.items()}
    want = {name: per_call.get(name, 0) * len(card_logits) for name in KERNELS}
    if ran != want:
        raise SystemExit(f"{cfg.name} decode card run launched {ran} for "
                         f"{len(card_logits)} decode_apply calls, expected {want}")
    cpu_tokens, cpu_logits = serve_on(params)
    rels = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
            for a, b in zip(card_logits, cpu_logits)]
    ring = f", window {engine_kw['window']}" if engine_kw.get("window") else ""
    print(f"decode path, {cfg.name}, card vs CPU plain ({cfg.n_layers} layers, f32, "
          f"{len(lengths)} requests"
          f"{ring}): {len(rels)} steps, worst logits relative L2 {max(rels):.3e} (limit "
          f"1e-4), tokens equal: {card_tokens == cpu_tokens}")
    if len(card_logits) != len(cpu_logits) or not max(rels) <= 1e-4:
        raise SystemExit(f"{cfg.name} decode path: per-step logits relative L2 {rels}")
    if card_tokens != cpu_tokens:
        top2 = [torch.topk(lg, 2, dim=-1).values for lg in cpu_logits]
        margin = min(float((t[:, 0] - t[:, 1]).min()) for t in top2)
        raise SystemExit(f"{cfg.name} decode path: tokens differ ({card_tokens} vs "
                         f"{cpu_tokens}); smallest top-2 logit margin on the CPU "
                         f"{margin:.3e}")
    return max(rels)


class Tee:
    """Copies what is printed to stdout into ``text`` while it still goes out."""

    def __enter__(self):
        self.out, self.parts = sys.stdout, []
        sys.stdout = self
        return self

    def write(self, data):
        self.parts.append(data)
        return self.out.write(data)

    def flush(self):
        self.out.flush()

    def __exit__(self, *exc):
        sys.stdout = self.out

    @property
    def text(self) -> str:
        return "".join(self.parts)


def distill_args() -> list:
    """Phase 12's (and 12b's) flags."""
    return ["--arch", "yi-6b", "--mode", "flow", "--full", "--nfe", str(NFE),
            "--batch", str(BATCH), "--seq", str(SEQ), "--bns-iters", str(DISTILL_ITERS),
            "--requests", str(DISTILL_REQUESTS), "--solver-artifact", str(BNS_ARTIFACT)]


def distill_path(dev, counters, trains: dict) -> dict:
    """Phase 12: serve.main distils a BNS solver for yi-6b at full width,
    saves it as an artifact and serves the reloaded copy; launch counts as
    the module docstring states them. Then phase 16's BNS case on its
    weights and pairs, into ``trains``."""
    from repro_torch.launch import serve

    BNS_ARTIFACT.unlink(missing_ok=True)
    free_device_memory(dev)
    reset(counters)
    t0 = time.perf_counter()
    with launcher_depth(DISTILL_LAYERS):
        served = serve.main(distill_args())
    wall = time.perf_counter() - t0
    d = served.distillation
    K, R = DISTILL_ITERS, sum(d.rk45[part][0] for part in ("train", "val"))
    no_grad_calls = R + NFE + NFE + DISTILL_REQUESTS * NFE
    want = {**dict.fromkeys(KERNELS, 0),
            "flash_attention": DISTILL_LAYERS * (no_grad_calls + 2 * NFE * K),
            "flash_attention_bwd": DISTILL_LAYERS * NFE * K,
            "ns_update": NFE * (2 + DISTILL_REQUESTS + K), "ns_update_bwd": NFE * K}
    launches = {name: c.launches for name, c in counters.items()}
    if launches != want:
        raise SystemExit(f"distillation launch counts {launches}, expected {want} "
                         f"(RK45 evaluations {R})")
    z, art = served.zoo, served.artifact
    saved_as_trained = all(torch.equal(a.cpu(), b.cpu())   # the artifact loads on the CPU
                           for a, b in zip(art.params, d.params))
    if ((z.distills, z.loads, art.kind) != (1, 0, "bns") or not BNS_ARTIFACT.exists()
            or not saved_as_trained):
        raise SystemExit(f"distillation: zoo {z}, kind {art.kind}, artifact saved "
                         f"{BNS_ARTIFACT.exists()}, its BNSParams equal to the distilled "
                         f"ones: {saved_as_trained}")
    losses = [h[1] for h in d.history]
    if not (d.history and all(np.isfinite(losses)) and np.isfinite(d.val_psnr)
            and np.isfinite(d.init_val_psnr)):
        raise SystemExit(f"distillation: non-finite loss or PSNR: {d.history}, "
                         f"init {d.init_val_psnr}")
    if not d.val_psnr >= d.init_val_psnr:
        raise SystemExit(f"distillation: val PSNR {d.val_psnr} below the initial "
                         f"solver's {d.init_val_psnr}")
    for s in served:
        if s.latents.shape != (BATCH, SEQ, 64) or not bool(torch.isfinite(s.latents).all()):
            raise SystemExit(f"distilled solver: bad latents {tuple(s.latents.shape)}")
    peak = torch.cuda.max_memory_allocated(dev)
    # train_bns' wall holds K iterations (the first with the step's and the
    # validation's captures) and one validation, which costs what the initial
    # solver's validation did
    iter_ms = (d.train_seconds - d.init_val_seconds) / K * 1e3
    print(f"distillation: yi-6b full width, {DISTILL_LAYERS} of its {LAYERS} layers, NFE "
          f"{NFE}, batch {BATCH}, seq {SEQ}: RK45 "
          f"train nfe/accepted/rejected {d.rk45['train']}, val {d.rk45['val']} "
          f"({d.rk45_seconds:.3f} s, graphed: step program {d.rk45_programs}); val PSNR initial {d.init_val_psnr:.4f} dB -> distilled "
          f"{d.val_psnr:.4f} dB after {K} iterations (losses {[round(x, 5) for x in losses]}); "
          f"train_bns {d.train_seconds:.3f} s, ~{iter_ms:.1f} ms an iteration (one "
          f"validation {d.init_val_seconds * 1e3:.1f} ms taken off; each, by CUDA events, "
          f"the first with the captures, the last with its validation, "
          f"{[round(x * 1e3, 1) for x in d.iteration_seconds]}); artifact "
          f"saved and reloaded (its BNSParams equal to the distilled ones to the bit), zoo "
          f"{z}; request ms with the "
          f"distilled solver {[round(x.ms, 3) for x in served]}; launches {launches}; peak "
          f"memory {peak / 2**30:.3f} GiB; main() wall {wall:.3f} s; training programs "
          f"{d.programs}")
    trains[f"bns, seq {SEQ}, euler NFE {NFE}"] = train_programs(
        dev, counters, f"bns, seq {SEQ}, euler NFE {NFE}",
        train_loop("bns", served_field(dev, served.sampler, SEQ), d.pairs))
    return {"rk45": d.rk45, "rk45_s": d.rk45_seconds, "rk45_programs": d.rk45_programs,
            "init_val_psnr": d.init_val_psnr,
            "val_psnr": d.val_psnr, "iterations": K, "iteration_ms": iter_ms,
            "request_ms": [x.ms for x in served], "peak_gib": peak / 2**30,
            "launches": launches, "wall_s": wall,
            "each_iteration_ms": [x * 1e3 for x in d.iteration_seconds],
            "solver": [t.cpu() for t in served.sampler.solver],
            "latents": [x.latents.cpu() for x in served]}


def artifact_reload(dev, counters, distilled: dict) -> dict:
    """Phase 12b: phase 12's flags in a fresh serve.main call load the saved
    artifact: no retraining, exact launch counts, solver and latents equal
    to phase 12's to the bit."""
    from repro_torch.launch import serve

    free_device_memory(dev)
    reset(counters)
    t0 = time.perf_counter()
    with Tee() as out, launcher_depth(DISTILL_LAYERS):
        served = serve.main(distill_args())
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    want = {**dict.fromkeys(KERNELS, 0),
            "flash_attention": DISTILL_LAYERS * NFE * DISTILL_REQUESTS,
            "ns_update": NFE * DISTILL_REQUESTS}
    if launches != want:
        raise SystemExit(f"artifact reload launch counts {launches}, expected {want}")
    z = served.zoo
    if "no retraining" not in out.text or (z.loads, z.distills) != (1, 0) \
            or served.distillation is not None:
        raise SystemExit(f"artifact reload: zoo {z}, distillation {served.distillation}, "
                         f"'no retraining' printed: {'no retraining' in out.text}")
    solver = [t.cpu() for t in served.sampler.solver]
    same_solver = all(torch.equal(a, b) for a, b in zip(solver, distilled["solver"]))
    same_latents = [torch.equal(s.latents.cpu(), ref)
                    for s, ref in zip(served, distilled["latents"])]
    diff = [float((s.latents.cpu() - ref).abs().max())
            for s, ref in zip(served, distilled["latents"])]
    print(f"artifact reload: zoo {z}; launches {launches}; request ms "
          f"{[round(x.ms, 3) for x in served]}; NSParams equal to phase 12's: {same_solver}; "
          f"latents equal to phase 12's: {same_latents} (max |diff| {diff}); "
          f"main() wall {wall:.3f} s")
    if not (same_solver and all(same_latents) and len(same_latents) == DISTILL_REQUESTS):
        raise SystemExit("artifact reload: the served solver or latents differ from phase 12's")
    return {"launches": launches, "request_ms": [x.ms for x in served], "wall_s": wall}


@contextlib.contextmanager
def launcher_depth(layers: int, encoder_layers: int | None = None):
    """Inside the block the launcher and the trainer build their model with
    ``layers`` layers, and an encoder-decoder's encoder with
    ``encoder_layers`` (when given), the width unchanged."""
    from repro_torch.launch import serve, train

    inner = {serve: serve.get_config, train: train.get_config}
    enc = {} if encoder_layers is None else {"n_encoder_layers": encoder_layers}
    for module, fn in inner.items():
        module.get_config = lambda arch, smoke=False, fn=fn: dataclasses.replace(
            fn(arch, smoke=smoke), n_layers=layers, **enc)
    try:
        yield
    finally:
        for module, fn in inner.items():
            module.get_config = fn


def anytime_path(dev, counters, trains: dict) -> dict:
    """Phase 12c: serve.main distils an anytime solver over budgets (4, 8)
    for yi-6b at full width and DISTILL_LAYERS of its depth, saves and
    reloads it and routes 3 requests;
    launch counts as the module docstring states them; then the served
    sampler's exits against per-budget sampling and carry legs, to the bit;
    then phase 16's anytime case (profiled) on its weights and pairs."""
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.launch import serve
    from repro_torch.serving import nearest_budget

    ANYTIME_ARTIFACT.unlink(missing_ok=True)
    free_device_memory(dev)
    reset(counters)
    t0 = time.perf_counter()
    with Tee() as out, launcher_depth(DISTILL_LAYERS):
        served = serve.main(["--arch", "yi-6b", "--mode", "flow", "--full",
                             "--budgets", ",".join(map(str, ANYTIME_BUDGETS)),
                             "--request-budgets", ",".join(map(str, ANYTIME_REQUEST_BUDGETS)),
                             "--batch", str(BATCH), "--seq", str(ANYTIME_SEQ),
                             "--bns-iters", str(ANYTIME_ITERS),
                             "--requests", str(len(ANYTIME_REQUEST_BUDGETS)),
                             "--solver-artifact", str(ANYTIME_ARTIFACT)])
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    d = served.distillation
    K, R = ANYTIME_ITERS, sum(d.rk45[part][0] for part in ("train", "val"))
    top = ANYTIME_BUDGETS[-1]
    rules = top + len(ANYTIME_BUDGETS) - 1            # intermediate rules + exits
    served_nfe = [nearest_budget(ANYTIME_BUDGETS, m) for m in ANYTIME_REQUEST_BUDGETS]
    want = {**dict.fromkeys(KERNELS, 0),
            "flash_attention": DISTILL_LAYERS * (R + 2 * top + sum(served_nfe)
                                                 + 2 * top * K),
            "flash_attention_bwd": DISTILL_LAYERS * top * K,
            "ns_update": 2 * rules + sum(served_nfe) + rules * K, "ns_update_bwd": rules * K}
    if launches != want:
        raise SystemExit(f"anytime launch counts {launches}, expected {want} "
                         f"(RK45 evaluations {R})")
    warnings = out.text.count("WARNING: requested NFE 16 not served")
    losses = [h[1] for h in d.history]
    if (warnings != 1 or [s.nfe for s in served] != served_nfe
            or (served.zoo.distills, served.artifact.kind, served.artifact.budgets)
            != (1, "anytime", ANYTIME_BUDGETS)
            or not (d.history and all(np.isfinite(losses)) and np.isfinite(d.val_psnr)
                    and np.isfinite(d.init_val_psnr))):
        raise SystemExit(f"anytime: {warnings} nearest-budget warnings, served NFE "
                         f"{[s.nfe for s in served]}, zoo {served.zoo}, kind "
                         f"{served.artifact.kind}, "
                         f"history {d.history}, init PSNR {d.init_val_psnr}")
    for s in served:
        if s.latents.shape != (BATCH, ANYTIME_SEQ, 64) or not bool(
                torch.isfinite(s.latents).all()):
            raise SystemExit(f"anytime: bad latents {tuple(s.latents.shape)}")
    peak = torch.cuda.max_memory_allocated(dev)
    iter_ms = (d.train_seconds - d.init_val_seconds) / K * 1e3
    # the exits on one seeded x0, to the bit
    sampler = served.sampler
    cond = SyntheticTokens(sampler.cfg, DataConfig(batch_size=BATCH, seq_len=ANYTIME_SEQ,
                                                   seed=0), device=dev).batch(0)
    x0 = torch.randn((BATCH, ANYTIME_SEQ, sampler.cfg.latent_dim), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(12))
    every = sampler.sample_all_from(cond, x0)
    carry, exits = sampler.carry_start(cond, x0), {}
    for stop in ANYTIME_BUDGETS:
        carry, e = sampler.carry_extend(cond, carry, stop)
        exits.update(e)
    checks = {}
    for m in ANYTIME_BUDGETS:
        checks[f"sample_all_from[{m}] == sample_from({m})"] = torch.equal(
            every[m], sampler.sample_from(cond, x0, m))
        checks[f"carry legs [{m}] == sample_all_from[{m}]"] = torch.equal(exits[m], every[m])
    print(f"anytime: yi-6b full width, {DISTILL_LAYERS} of its {LAYERS} layers, budgets "
          f"{ANYTIME_BUDGETS}, batch {BATCH}, seq "
          f"{ANYTIME_SEQ}: RK45 train {d.rk45['train']}, val {d.rk45['val']} "
          f"({d.rk45_seconds:.3f} s, graphed: step program {d.rk45_programs}); mean val PSNR initial {d.init_val_psnr:.4f} dB -> "
          f"distilled {d.val_psnr:.4f} dB after {K} iterations (losses "
          f"{[round(x, 5) for x in losses]}); train_anytime {d.train_seconds:.3f} s, "
          f"~{iter_ms:.1f} ms an iteration (one validation {d.init_val_seconds * 1e3:.1f} ms "
          f"taken off; each, by CUDA events, the first with the captures, the last with "
          f"its validation, "
          f"{[round(x * 1e3, 1) for x in d.iteration_seconds]}); requests "
          f"{list(ANYTIME_REQUEST_BUDGETS)} served at {served_nfe} NFE "
          f"in {[round(x.ms, 3) for x in served]} ms; nearest-budget warnings {warnings}; "
          f"zoo {served.zoo}; launches {launches}; peak memory {peak / 2**30:.3f} GiB; "
          f"main() wall {wall:.3f} s; to the bit: {checks}; training programs "
          f"{d.programs}")
    if not all(checks.values()):
        raise SystemExit(f"anytime: exits differ: {checks}")
    label = f"anytime, seq {ANYTIME_SEQ}, budgets {ANYTIME_BUDGETS}"
    trains[label] = train_programs(dev, counters, label, train_loop(
        "anytime", served_field(dev, sampler, ANYTIME_SEQ), d.pairs), profile=True)
    return {"rk45": d.rk45, "rk45_s": d.rk45_seconds, "rk45_programs": d.rk45_programs,
            "init_val_psnr": d.init_val_psnr,
            "val_psnr": d.val_psnr, "iterations": K, "iteration_ms": iter_ms,
            "each_iteration_ms": [x * 1e3 for x in d.iteration_seconds],
            "request_ms": [x.ms for x in served], "request_nfe": served_nfe,
            "peak_gib": peak / 2**30, "launches": launches, "wall_s": wall}


def bst_distill_path(dev, counters, trains: dict) -> dict:
    """Phase 12d: a BST-Euler solver distilled at yi-6b's full width: the
    launcher's field (each layer recomputed in the backward), one
    generate_pairs call of BST_PAIRS samples at seq BST_SEQ (one RK45 solve
    over a conditioning batch of BATCH rows taken twice, so train rows 0..3
    and val rows 4..7 share it), then SolverSpec("euler", 8, mode="bst")
    .distill for BST_ITERS full-batch iterations; launch counts exact per
    stage, the BST claim (val PSNR >= Euler's - 0.2 dB), the artifact saved
    and reloaded bit-equal, and its ns_params refused with TypeError. Then
    phase 16's BST case on the same field and pairs, into ``trains``."""
    from repro_torch.configs import get_config
    from repro_torch.core import bns, bst_solver
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.solvers import SolverArtifact, SolverSpec

    BST_ARTIFACT.unlink(missing_ok=True)
    free_device_memory(dev)
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("yi-6b", smoke=False), n_layers=DISTILL_LAYERS)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    cond = SyntheticTokens(cfg, DataConfig(batch_size=BATCH, seq_len=BST_SEQ, seed=0),
                           device=dev).batch(0)
    sched = get_scheduler("fm_ot")
    field = M.velocity_field(params, cfg, sched, cond, remat=True)
    twice = M.velocity_field(params, cfg, sched,
                             {k: torch.cat([v, v]) for k, v in cond.items()})
    # the solve's evaluations, from its result: a graphed step runs no Python
    solves, inner = [], bns.rk45_solve

    def recorded(*args, **kwargs):
        solves.append(inner(*args, **kwargs))
        return solves[-1]

    stages, zero = {}, dict.fromkeys(KERNELS, 0)

    def stage(name, fn, want_of):
        reset(counters)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: c.launches for k, c in counters.items()}
        want = {**zero, **want_of()}
        stages[name] = {"launches": launches, "ms": ms}
        if launches != want:
            raise SystemExit(f"BST {name}: launched {launches}, expected {want}")
        return out

    bns.rk45_solve = recorded
    try:
        x0, x1 = stage("rk45", lambda: bns.generate_pairs(
            twice, torch.Generator(device=dev).manual_seed(1), BST_PAIRS,
            (BST_SEQ, cfg.latent_dim)),
            lambda: {"flash_attention": DISTILL_LAYERS * sum(r.nfe for r in solves)})
    finally:
        bns.rk45_solve = inner
    evaluations = sum(r.nfe for r in solves)
    train, val = (x0[:BATCH], x1[:BATCH]), (x0[BATCH:], x1[BATCH:])
    euler = stage("euler init", lambda: SolverSpec("euler", NFE).sampler(field).psnr(val),
                  lambda: {"ns_update": NFE, "flash_attention": DISTILL_LAYERS * NFE})
    K = BST_ITERS
    spec = SolverSpec("euler", NFE, mode="bst")
    res = stage("training", lambda: spec.distill(
        field, train, val, bns.BNSTrainConfig(lr=1e-3, lr_schedule="cosine", iterations=K,
                                              val_every=100, batch_size=BATCH)),
        lambda: {"flash_attention": DISTILL_LAYERS * (2 * NFE * K + NFE),
                 "flash_attention_bwd": DISTILL_LAYERS * NFE * K})
    peak = torch.cuda.max_memory_allocated(dev)
    reset(counters)
    res.artifact(provenance={"arch": "yi-6b", "scheduler": "fm_ot"}).save(str(BST_ARTIFACT))
    back = SolverArtifact.load(str(BST_ARTIFACT))
    same = all(torch.equal(a.cpu(), b) for a, b in zip(res.params, back.params))
    try:
        back.ns_params
        refused = False
    except TypeError:
        refused = True
    moved = not all(torch.equal(p.cpu(), q)
                    for p, q in zip(res.params, bst_solver.identity_bst(NFE, "euler")))
    losses = [h[1] for h in res.history]
    iteration_ms = [x * 1e3 for x in res.iteration_seconds]
    print(f"BST distillation: yi-6b full width, {DISTILL_LAYERS} of its {LAYERS} layers, "
          f"euler NFE {NFE}, {BST_PAIRS} pairs at seq "
          f"{BST_SEQ} ({evaluations} RK45 evaluations in {len(solves)} solve, graphed, "
          f"{stages['rk45']['ms'] / 1e3:.3f} s), "
          f"{BATCH} train / {BATCH} val: val PSNR Euler {euler:.4f} dB -> BST "
          f"{res.val_psnr:.4f} dB after {K} iterations, knots moved off the identity: "
          f"{moved} (losses "
          f"{[round(x, 5) for x in losses]}); ms an iteration (bns.fit's, the last with its "
          f"validation) {[round(x, 1) for x in iteration_ms]}; launches by stage "
          f"{ {k: v['launches'] for k, v in stages.items()} }; artifact {back.kind} reloaded "
          f"bit-equal: {same}, ns_params refused: {refused}; peak memory "
          f"{peak / 2**30:.3f} GiB; training programs {res.programs}; phase wall "
          f"{time.perf_counter() - t_phase:.3f} s")
    if not (np.isfinite(res.val_psnr) and all(np.isfinite(losses)) and losses):
        raise SystemExit(f"BST distillation: non-finite loss or PSNR {res.history}")
    if not (res.val_psnr >= euler - 0.2 and res.val_psnr > euler and moved):
        raise SystemExit(f"BST distillation learned nothing: val PSNR {res.val_psnr} against "
                         f"Euler's {euler}, knots moved off the identity: {moved}")
    if not (same and refused and back.kind == "bst"):
        raise SystemExit(f"BST artifact: reloaded equal {same}, kind {back.kind}, "
                         f"ns_params refused {refused}")
    label = f"bst, seq {BST_SEQ}, euler NFE {NFE}"
    trains[label] = train_programs(dev, counters, label, train_loop(
        "bst", field, {"train": train, "val": val}))
    launches = {k: sum(v["launches"][k] for v in stages.values()) for k in KERNELS}
    return {"launches": launches, "training_launches": stages["training"]["launches"],
            "rk45_evaluations": evaluations, "rk45_s": stages["rk45"]["ms"] / 1e3,
            "euler_val_psnr": euler, "val_psnr": res.val_psnr, "iterations": K,
            "each_iteration_ms": iteration_ms, "peak_gib": peak / 2**30}


def bns_gradient_against_cpu(dev, counters, cfg, params, label: str, want: dict,
                             card_params=None, check: bool = True, on_side=None):
    """_loss_fn at euler NFE 4 and its gradient in theta on the card
    (kernels; ``card_params``, or ``params`` copied there) against the CPU
    (plain versions, ``params``), batch 2 x 128 of synthetic tokens (and
    frames), seeded pairs, each layer recomputed: relative L2 of the loss
    and of each gradient <= 1e-4 (with ``check``; else the caller judges);
    the card launches exactly ``want``; ``on_side(where)`` is called before
    each side's run ("cpu", then "card"). Returns (the two sides' fields,
    theta0, the pairs, each side's gradients on the CPU, the relative L2s)."""
    from repro_torch.core import bns, ns_solver
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.models.transformer import params_to
    from repro_torch.solvers.registry import build_ns

    batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                            device="cpu").batch(0)
    rng = np.random.default_rng(13)
    x0, x1 = (torch.from_numpy(rng.standard_normal((2, 128, cfg.latent_dim))
                               .astype(np.float32)) for _ in "01")
    theta0 = ns_solver.from_ns(build_ns("euler", 4, None))
    card_params = params_to(params, dev) if card_params is None else card_params
    fields = {"cpu": M.velocity_field(params, cfg, get_scheduler("fm_ot"), batch, remat=True),
              "card": M.velocity_field(card_params, cfg, get_scheduler("fm_ot"),
                                       {k: v.to(dev) for k, v in batch.items()}, remat=True)}
    got = {}
    for where, field in fields.items():
        d = dev if where == "card" else torch.device("cpu")
        th = ns_solver.BNSParams(*(p.to(d).requires_grad_(True) for p in theta0))
        if on_side is not None:
            on_side(where)
        before = {name: c.launches for name, c in counters.items()}
        loss = bns._loss_fn(bns.ns_sampler(field), th, x0.to(d), x1.to(d))
        grads = torch.autograd.grad(loss, list(th))
        ran = {name: c.launches - before[name] for name, c in counters.items()}
        expected = want if where == "card" else dict.fromkeys(KERNELS, 0)
        if ran != expected:
            raise SystemExit(f"gradient on the {where} [{label}]: launched {ran}, expected "
                             f"{expected}")
        got[where] = (loss.detach().cpu(), [g.cpu() for g in grads])
    rels = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))
            for a, b in zip([got["card"][0], *got["card"][1]], [got["cpu"][0], *got["cpu"][1]])]
    print(f"gradient, {label}, euler NFE 4, remat: card vs CPU relative L2 of "
          f"loss {rels[0]:.3e}, d/d time_logits {rels[1]:.3e}, d/da {rels[2]:.3e}, "
          f"d/db {rels[3]:.3e} (limit 1e-4); card launches {want}")
    if check and not max(rels) <= 1e-4:
        raise SystemExit(f"gradient card vs CPU [{label}]: relative L2 {rels} over 1e-4")
    return fields, theta0, (x0, x1), {k: v[1] for k, v in got.items()}, rels


def gradient_against_cpu(dev, counters, cfg, params) -> None:
    """Phase 13: _loss_fn and its gradient in theta on the card (kernels)
    against the CPU (plain versions), then theta after a few train_solver
    steps; limits as the module docstring states them."""
    from repro_torch.core import bns

    want = {**dict.fromkeys(KERNELS, 0), "flash_attention": 2 * 4 * 2,
            "flash_attention_bwd": 2 * 4, "ns_update": 4, "ns_update_bwd": 4}
    fields, theta0, (x0, x1), grads, _ = bns_gradient_against_cpu(
        dev, counters, cfg, params, "yi-6b 2 layers f32", want)
    cfg_t = bns.BNSTrainConfig(nfe=4, init_solver="euler", lr=DISTILL_CHECK_LR,
                               lr_schedule="cosine", iterations=DISTILL_CHECK_STEPS,
                               val_every=100, batch_size=2)
    thetas = {}
    for where, field in fields.items():
        d = dev if where == "card" else torch.device("cpu")
        res = bns.train_solver(bns.ns_sampler(field), theta0, (x0.to(d), x1.to(d)),
                               (x0.to(d), x1.to(d)), cfg_t)
        thetas[where] = torch.cat([p.cpu().reshape(-1) for p in res.params])
    g0 = torch.cat([g.reshape(-1) for g in grads["cpu"]]).abs()
    signed = g0 >= 1e-3 * g0.max()
    diff = (thetas["card"] - thetas["cpu"]).abs()
    step = DISTILL_CHECK_LR * DISTILL_CHECK_STEPS
    r_signed = float((diff[signed] / (1e-3 * step)).max())
    r_rest = float((diff[~signed] / (2 * step)).max()) if bool((~signed).any()) else 0.0
    print(f"theta after {DISTILL_CHECK_STEPS} train_solver steps (lr {DISTILL_CHECK_LR}), card "
          f"vs CPU: {int(signed.sum())} components with a clear gradient sign at "
          f"{r_signed:.4f} of their limit (1e-3 of lr a step), {int((~signed).sum())} others at "
          f"{r_rest:.4f} of theirs (2 lr a step); largest difference {float(diff.max()):.3e}")
    if not (r_signed <= 1 and r_rest <= 1):
        raise SystemExit(f"theta card vs CPU outside its limits: {r_signed}, {r_rest}")


def anytime_gradient_against_cpu(dev, counters, cfg, params) -> dict:
    """Phase 13b: anytime_loss and its gradient in every field of
    AnytimeParams on the card (kernels) against the CPU (plain versions);
    limits as the module docstring states them."""
    from repro_torch.core import anytime
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.models.transformer import params_to

    budgets = (2, 4)
    batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                            device="cpu").batch(0)
    rng = np.random.default_rng(14)
    x0, x1 = (torch.from_numpy(rng.standard_normal((2, 128, cfg.latent_dim))
                               .astype(np.float32)) for _ in "01")
    theta0 = anytime.AnytimeParams(*(
        p + torch.from_numpy(0.1 * rng.standard_normal(tuple(p.shape)).astype(np.float32))
        for p in anytime.init_anytime(None, budgets)))
    fields = {"cpu": M.velocity_field(params, cfg, get_scheduler("fm_ot"), batch, remat=True),
              "card": M.velocity_field(params_to(params, dev), cfg, get_scheduler("fm_ot"),
                                       {k: v.to(dev) for k, v in batch.items()}, remat=True)}
    rules = budgets[-1] + len(budgets) - 1
    got, launched = {}, {}
    for where, field in fields.items():
        d = dev if where == "card" else torch.device("cpu")
        th = anytime.AnytimeParams(*(p.to(d).requires_grad_(True) for p in theta0))
        before = {name: c.launches for name, c in counters.items()}
        loss = anytime.anytime_loss(th, budgets, field.fn, x0.to(d), x1.to(d))
        grads = torch.autograd.grad(loss, list(th))
        ran = {name: c.launches - before[name] for name, c in counters.items()}
        want = ({**dict.fromkeys(KERNELS, 0), "flash_attention": 2 * 4 * 2,
                 "flash_attention_bwd": 2 * 4, "ns_update": rules, "ns_update_bwd": rules}
                if where == "card" else dict.fromkeys(KERNELS, 0))
        if ran != want:
            raise SystemExit(f"anytime gradient on the {where}: launched {ran}, expected {want}")
        launched[where] = ran
        got[where] = [loss.detach().cpu(), *(g.cpu() for g in grads)]
    rels = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))
            for a, b in zip(got["card"], got["cpu"])]
    names = ["loss"] + [f"d/d {f}" for f in anytime.AnytimeParams._fields]
    print(f"anytime gradient, yi-6b 2 layers f32, budgets {budgets}, remat: card vs CPU "
          f"relative L2 " + ", ".join(f"{n} {r:.3e}" for n, r in zip(names, rels))
          + f" (limit 1e-4); card launches {launched['card']}")
    if not max(rels) <= 1e-4:
        raise SystemExit(f"anytime gradient card vs CPU: relative L2 {rels} over 1e-4")
    return {"launches": launched["card"], "relative_l2": dict(zip(names, rels))}


def bst_gradient_against_cpu(dev, counters, cfg, params) -> dict:
    """Phase 13c: _loss_fn through bst_sampler and its gradient in every
    field of BSTParams on the card (kernels) against the CPU (plain
    versions); limits as the module docstring states them."""
    from repro_torch.core import bns, bst_solver
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.models.transformer import params_to

    batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                            device="cpu").batch(0)
    rng = np.random.default_rng(15)
    x0, x1 = (torch.from_numpy(rng.standard_normal((2, 128, cfg.latent_dim))
                               .astype(np.float32)) for _ in "01")
    theta0 = bst_solver.BSTParams(*(
        p + torch.from_numpy(0.1 * rng.standard_normal(tuple(p.shape)).astype(np.float32))
        for p in bst_solver.identity_bst(4, "euler")))
    fields = {"cpu": M.velocity_field(params, cfg, get_scheduler("fm_ot"), batch, remat=True),
              "card": M.velocity_field(params_to(params, dev), cfg, get_scheduler("fm_ot"),
                                       {k: v.to(dev) for k, v in batch.items()}, remat=True)}
    got, launched = {}, {}
    for where, field in fields.items():
        d = dev if where == "card" else torch.device("cpu")
        th = bst_solver.BSTParams(*(p.to(d).requires_grad_(True) for p in theta0))
        before = {name: c.launches for name, c in counters.items()}
        loss = bns._loss_fn(bns.bst_sampler(field), th, x0.to(d), x1.to(d))
        grads = torch.autograd.grad(loss, list(th))
        ran = {name: c.launches - before[name] for name, c in counters.items()}
        want = ({**dict.fromkeys(KERNELS, 0), "flash_attention": 2 * 4 * 2,
                 "flash_attention_bwd": 2 * 4}
                if where == "card" else dict.fromkeys(KERNELS, 0))
        if ran != want:
            raise SystemExit(f"BST gradient on the {where}: launched {ran}, expected {want}")
        launched[where] = ran
        got[where] = [loss.detach().cpu(), *(g.cpu() for g in grads)]
    rels = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))
            for a, b in zip(got["card"], got["cpu"])]
    names = ["loss"] + [f"d/d {f}" for f in bst_solver.BSTParams._fields]
    print(f"BST gradient, yi-6b 2 layers f32, euler NFE 4, remat: card vs CPU relative L2 "
          + ", ".join(f"{n} {r:.3e}" for n, r in zip(names, rels))
          + f" (limit 1e-4); card launches {launched['card']}")
    if not max(rels) <= 1e-4:
        raise SystemExit(f"BST gradient card vs CPU: relative L2 {rels} over 1e-4")
    return {"launches": launched["card"], "relative_l2": dict(zip(names, rels))}


class FlushBatches:
    """Each flush batch a gateway runs, read around ``Gateway._execute``:
    its entries' uids and served budgets, bucket, mixed flag and the host
    arrays ``assemble_rows`` builds for it (recorded, not re-run)."""

    def __enter__(self):
        from repro_torch.serving import gateway

        self.cls, self.inner, self.batches = gateway.Gateway, gateway.Gateway._execute, []

        def recorded(gw, batch):
            x0, tokens = gateway.assemble_rows(batch.entries, batch.bucket)
            self.batches.append({"uids": [e.uid for e in batch.entries],
                                 "served": [e.served for e in batch.entries],
                                 "budget": batch.budget, "bucket": batch.bucket,
                                 "mixed": batch.mixed, "x0": x0, "tokens": tokens})
            return self.inner(gw, batch)

        self.cls._execute = recorded
        return self

    def __exit__(self, *exc):
        self.cls._execute = self.inner


def program_launches(program: str, budgets: tuple) -> tuple[int, int]:
    """(backbone forwards, ns_update launches) of one gateway dispatch, from
    its ``dispatches`` label: an anytime leg from s to t runs t - s
    intermediate rules plus the exit rule of each budget below the top
    that it crosses (the top budget's output is the last rule's)."""
    top, exits = max(budgets), [m for m in budgets if m < max(budgets)]

    def leg(s, t):
        return t - s, (t - s) + sum(1 for m in exits if s < m <= t)

    kind, _, rest = program.partition("/")
    if kind == "bmix":
        return leg(0, top)
    if kind.startswith("b"):
        m = int(kind[1:])
        return m, m
    if kind == "start":
        return 0, 0
    if kind == "leg":
        s, t = map(int, rest.split("-"))
        return leg(s, t)
    if kind == "join":
        return leg(0, int(rest.split("-")[0]))
    if kind == "resume":
        s, t = map(int, rest.split("-")[:2])
        return leg(s, t)
    raise ValueError(f"unknown dispatch {program!r}")


def row_errors(got: np.ndarray, want: torch.Tensor) -> dict:
    """Bit equality, max |diff| and relative L2 of a served row against the
    same request computed another way."""
    want = want.float().cpu().numpy()
    diff = np.abs(got.astype(np.float64) - want)
    return {"equal": bool(np.array_equal(got, want)), "max_abs": float(diff.max()),
            "rel_l2": float(np.linalg.norm(got.astype(np.float64) - want)
                            / np.linalg.norm(want.astype(np.float64)))}


def gateway_path(dev, counters, card: str, name: str, extra: list, seq: int,
                 cycle: tuple, requests: int, want_programs=None) -> dict:
    """Phase 14a/b/c: serve.main through a flow gateway with 12c's anytime
    artifact; launch counts from the gateway's own dispatches; each flush
    batch's rows against a direct call on the same assembled batch (to the
    bit), each row against its request alone (bits, or GATEWAY_REL_L2)."""
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.launch import serve
    from repro_torch.serving.gateway import request_noise

    budgets = [cycle[i % len(cycle)] for i in range(requests)]
    free_device_memory(dev)
    reset(counters)
    t0 = time.perf_counter()
    with FlushBatches() as flushed:
        served = serve.main(GATEWAY_ARGS + [
            "--solver-artifact", str(ANYTIME_ARTIFACT), "--seq", str(seq),
            "--request-budgets", ",".join(map(str, cycle)), "--requests", str(requests)]
            + extra)
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    stats, snap, sampler = served.stats, served.metrics, served.sampler
    programs = {k[len('dispatches{program="'):-2]: int(v) for k, v in snap.items()
                if k.startswith('dispatches{program="')}
    forwards = ns_updates = 0
    for program, n in programs.items():
        f, u = program_launches(program, sampler.budgets)
        forwards, ns_updates = forwards + n * f, ns_updates + n * u
    want = {**dict.fromkeys(KERNELS, 0), "ns_update": ns_updates,
            "flash_attention": LAYERS * stats["forwards"]}
    failures = []
    if launches != want or forwards != stats["forwards"]:
        failures.append(f"launches {launches}, expected {want} from dispatches {programs} "
                        f"({forwards} forwards; the gateway counts {stats['forwards']})")
    if want_programs is not None and programs != want_programs:
        failures.append(f"dispatches {programs}, expected {want_programs}")
    if (stats["completed"], stats["submitted"], stats["failed"]) != (len(budgets),) * 2 + (0,):
        failures.append(f"done {stats['completed']}/{stats['submitted']}, "
                        f"failed {stats['failed']}")
    if [r.meta["served_budget"] for r in served.responses] != budgets:
        failures.append("served budgets "
                        f"{[r.meta['served_budget'] for r in served.responses]}")
    # the same assembled batch, to the bit (the reference's padded-batch contract)
    same_batch = []
    for b in flushed.batches:
        cond = {"tokens": torch.from_numpy(b["tokens"]).to(dev)}
        x0 = torch.from_numpy(b["x0"]).to(dev)
        outs = (sampler.sample_all_from(cond, x0) if b["mixed"]
                else {b["budget"]: sampler.sample_from(cond, x0, b["budget"])})
        for i, (uid, m) in enumerate(zip(b["uids"], b["served"])):
            resp = served.responses[uid]
            n = resp.latents.shape[0]
            same_batch.append(torch.equal(torch.from_numpy(resp.latents),
                                          outs[m][i, :n].cpu()))
    if not all(same_batch):
        failures.append(f"rows differ from the same assembled batch: {same_batch}")
    # the first per-budget batch's first three rows again at batch 3
    bucket3 = []
    first = next((b for b in flushed.batches if not b["mixed"] and len(b["uids"]) >= 3), None)
    if first is not None:
        out = sampler.sample_from({"tokens": torch.from_numpy(first["tokens"][:3]).to(dev)},
                                  torch.from_numpy(first["x0"][:3]).to(dev), first["budget"])
        bucket3 = [row_errors(served.responses[uid].latents,
                              out[i, :served.responses[uid].latents.shape[0]])
                   for i, uid in enumerate(first["uids"][:3])]
        if any(not (e["equal"] or e["rel_l2"] <= GATEWAY_REL_L2) for e in bucket3):
            failures.append(f"rows at batch 3 over {GATEWAY_REL_L2}: {bucket3}")
    # a tiered batch's rows against the same rows at their native shape
    native = []
    for b in flushed.batches if "--tiers" in extra else ():
        n = served.responses[b["uids"][0]].latents.shape[0]
        k = len(b["uids"])
        out = sampler.sample_from({"tokens": torch.from_numpy(b["tokens"][:k, :n]).to(dev)},
                                  torch.from_numpy(b["x0"][:k, :n]).to(dev), b["budget"])
        native += [row_errors(served.responses[uid].latents, out[i])
                   for i, uid in enumerate(b["uids"])]
    if any(not (e["equal"] or e["rel_l2"] <= GATEWAY_REL_L2) for e in native):
        failures.append(f"rows at the native shape over {GATEWAY_REL_L2}: {native}")
    # each request alone at batch 1 and its native shape
    cfg = sampler.cfg
    tokens = SyntheticTokens(cfg, DataConfig(batch_size=BATCH, seq_len=seq, seed=0),
                             device=dev).batch(0)["tokens"]
    alone = []
    for req, resp in enumerate(served.responses):
        x0 = torch.from_numpy(request_noise(seq, cfg.latent_dim, 1000 + req)).to(dev)
        out = sampler.sample_from({"tokens": tokens[req % BATCH][None]}, x0[None],
                                  resp.meta["served_budget"])[0]
        alone.append(row_errors(resp.latents, out))
    if any(not (e["equal"] or e["rel_l2"] <= GATEWAY_REL_L2) for e in alone):
        failures.append(f"rows against their requests alone over {GATEWAY_REL_L2}: {alone}")
    tiers = {r.meta.get("tier_shape") for r in served.responses}
    if tiers != ({(1024, cfg.latent_dim)} if "--tiers" in extra else {None}):
        failures.append(f"tier shapes {tiers}")
    shapes = {tuple(r.latents.shape) for r in served.responses}
    if shapes != {(seq, cfg.latent_dim)} or not all(
            np.isfinite(r.latents).all() for r in served.responses):
        failures.append(f"row shapes {shapes} or non-finite values")
    hist = {k: snap[k] for k in ("device_dispatch_ms", "host_assembly_ms", "wait_ms")}
    print(f"gateway {name} ({card}): yi-6b full width, seq {seq}, requests at "
          f"{budgets}: dispatches {programs}; forwards {stats['forwards']}, done "
          f"{stats['completed']}/{stats['submitted']}, failed {stats['failed']}, batches "
          f"{stats['batches']}, mixed {stats['mixed_batches']}, traj {stats['trajectories']}, "
          f"legs {stats['legs']}, joins {stats['joins']}, join_rate "
          f"{stats['join_rate']:.3f}, slot_occ {stats['slot_occupancy']:.3f}, occupancy "
          f"{stats['occupancy']:.3f}; launches {launches}; device dispatch ms sum "
          f"{hist['device_dispatch_ms']['sum']:.3f} over {hist['device_dispatch_ms']['count']} "
          f"(p50 {hist['device_dispatch_ms']['p50']:.3f}), host assembly ms sum "
          f"{hist['host_assembly_ms']['sum']:.3f}, wait ms p50/p95/max "
          f"{stats['wait_p50_ms']:.3f}/{stats['wait_p95_ms']:.3f}/{stats['max_wait_ms']:.3f}; "
          f"submit-to-drain {served.wall_s:.3f} s, {stats['completed'] / served.wall_s:.3f} "
          f"requests/s; main() wall {wall:.3f} s; rows equal to the same assembled batch: "
          f"{sum(same_batch)}/{len(same_batch)}; against each request alone: equal "
          f"{sum(e['equal'] for e in alone)}/{len(alone)}, max |diff| "
          f"{max(e['max_abs'] for e in alone):.3e}, relative L2 "
          f"{[round(e['rel_l2'], 7) for e in alone]} (limit {GATEWAY_REL_L2} where bits differ)"
          + (f"; the first batch's rows at batch 3: equal {[e['equal'] for e in bucket3]}, "
             f"max |diff| {max(e['max_abs'] for e in bucket3):.3e}, relative L2 "
             f"{[round(e['rel_l2'], 7) for e in bucket3]}" if bucket3 else "")
          + (f"; the tiered rows against the same rows at their native shape: equal "
             f"{[e['equal'] for e in native]}, max |diff| "
             f"{max(e['max_abs'] for e in native):.3e}, relative L2 "
             f"{[round(e['rel_l2'], 7) for e in native]}" if native else ""))
    if failures:
        raise SystemExit(f"gateway {name}: " + "; ".join(failures))
    return {"launches": launches, "dispatches": programs, "forwards": stats["forwards"],
            "wall_s": served.wall_s, "device_dispatch_ms": hist["device_dispatch_ms"]["sum"],
            "dispatch_count": hist["device_dispatch_ms"]["count"],
            "wait_p50_ms": stats["wait_p50_ms"], "max_wait_ms": stats["max_wait_ms"],
            "joins": stats["joins"], "join_rate": stats["join_rate"],
            "slot_occupancy": stats["slot_occupancy"],
            "alone_equal": sum(e["equal"] for e in alone), "requests": len(alone),
            "alone_max_abs": max(e["max_abs"] for e in alone),
            "alone_max_rel_l2": max(e["rel_l2"] for e in alone),
            "bucket3_equal": [e["equal"] for e in bucket3],
            "rows": {uid: r.latents for uid, r in enumerate(served.responses)},
            "sampler": sampler, "programs": sampler.programs.stats(),
            "native_max_rel_l2": max((e["rel_l2"] for e in native), default=None),
            "routed": stats.get("routed"), "steals": stats.get("steals")}


def across(name: str, got: dict, want: dict, limit: float) -> list:
    """Rows of one run against another run's rows for the same requests:
    bits, or relative L2 within ``limit``."""
    errs = [row_errors(got[uid], torch.from_numpy(want[uid])) for uid in sorted(got)]
    print(f"{name}: equal {[e['equal'] for e in errs]}, max |diff| "
          f"{max(e['max_abs'] for e in errs):.3e}, relative L2 max "
          f"{max(e['rel_l2'] for e in errs):.3e}")
    if any(not (e["equal"] or e["rel_l2"] <= limit) for e in errs):
        raise SystemExit(f"{name}: over {limit}: {errs}")
    return errs


def dispatch_launches(programs: dict, budgets: tuple, forwards: int) -> dict:
    """The launches a gateway's dispatches make: flash LAYERS a forward,
    ``ns_update`` by ``program_launches``."""
    ns = sum(n * program_launches(p, budgets)[1] for p, n in programs.items())
    fw = sum(n * program_launches(p, budgets)[0] for p, n in programs.items())
    if fw != forwards:
        raise SystemExit(f"dispatches {programs} make {fw} forwards; the gateway counts "
                         f"{forwards}")
    return {**dict.fromkeys(KERNELS, 0), "ns_update": ns, "flash_attention": LAYERS * fw}


def fleet_direct(dev, counters, card: str, sampler) -> dict:
    """Phase 14e: a ``FleetGateway`` of FLEET_HOSTS ``Gateway``s over 14a's
    sampler, pumped by hand. A hot key homes 12 requests on one shard, a
    ``steal_round`` spreads them, a host joins, 4 more requests arrive, the
    deepest other host leaves (its shard re-homed), and the fleet drains.
    Every future resolves; every row equals, to the bit, a direct call on the
    batch it was served in (the batch a lone ``Gateway`` would assemble for
    that composition); launches equal the dispatches'."""
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.serving import FleetGateway, Gateway, Request, WorkStealer

    cfg = sampler.cfg
    tokens = SyntheticTokens(cfg, DataConfig(batch_size=BATCH, seq_len=SEQ, seed=0),
                             device=dev).batch(0)["tokens"].cpu()

    def host():
        return Gateway(sampler, max_batch=4, max_wait_ms=60000.0)

    fleet = FleetGateway({f"h{i}": host() for i in range(FLEET_HOSTS)},
                         stealer=WorkStealer(min_queue=2, max_steal=8))
    hot = [Request(tokens=tokens[i % BATCH], budget=4, seed=2000 + i) for i in range(12)]
    late = [Request(tokens=tokens[i % BATCH], budget=8, seed=3000 + i) for i in range(4)]
    hot_home = fleet.home(hot[0])
    reset(counters)
    t0 = time.perf_counter()
    with FlushBatches() as flushed:
        futs = [fleet.submit(r) for r in hot]
        before = dict(fleet.stats()["queue_depths"])
        moved = fleet.steal_round()
        after = dict(fleet.stats()["queue_depths"])
        fleet.add_host(f"h{FLEET_HOSTS}", host())
        late_home = fleet.home(late[0])
        futs += [fleet.submit(r) for r in late]
        depths = fleet.stats()["queue_depths"]
        leaver = max((h for h in depths if h != hot_home), key=lambda h: (depths[h], h))
        rerouted = depths[leaver]
        fleet.remove_host(leaver, timeout=600)
        fleet.drain(timeout=600)
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    stats = fleet.stats()
    programs = {k[len('dispatches{program="'):-2]: int(v)
                for k, v in fleet.metrics_snapshot().items()
                if k.startswith('dispatches{program="')}
    failures = []
    if not all(f.done() and f.exception() is None for f in futs):
        failures.append("a future was dropped or failed")
    if before != {**dict.fromkeys(before, 0), hot_home: 12} or moved != 11:
        failures.append(f"queue depths {before} before the steal, {moved} moved")
    if (stats["steals"], stats["rerouted"], stats["completed"], stats["failed"]) != (
            11, rerouted, 16, 0):
        failures.append(f"steals {stats['steals']}, rerouted {stats['rerouted']} "
                        f"(expected {rerouted}), done {stats['completed']}, failed "
                        f"{stats['failed']}")
    want = dispatch_launches(programs, sampler.budgets, stats["forwards"])
    if launches != want:
        failures.append(f"launches {launches}, expected {want} from {programs}")
    rows = {f.uid: f.result().latents for f in futs}
    same = []
    for b in flushed.batches:
        cond = {"tokens": torch.from_numpy(b["tokens"]).to(dev)}
        x0 = torch.from_numpy(b["x0"]).to(dev)
        outs = (sampler.sample_all_from(cond, x0) if b["mixed"]
                else {b["budget"]: sampler.sample_from(cond, x0, b["budget"])})
        same += [np.array_equal(rows[uid], outs[m][i].cpu().numpy())
                 for i, (uid, m) in enumerate(zip(b["uids"], b["served"]))]
    if len(same) != 16 or not all(same):
        failures.append(f"rows against the same batch composition: {same}")
    print(f"phase 14e ({card}): FleetGateway of {FLEET_HOSTS} Gateways over 14a's sampler, "
          f"hot key homed on {hot_home} (depths {before}), steal_round moved {moved} "
          f"(depths {after}), h{FLEET_HOSTS} joined, budget-8 key homed on {late_home}, "
          f"{leaver} left with {rerouted} queued (rerouted {stats['rerouted']}); routed "
          f"{stats['routed']}, dispatches {programs}, forwards {stats['forwards']}, done "
          f"{stats['completed']}/16, failed {stats['failed']}; launches {launches}; rows "
          f"equal to the same batch composition {sum(same)}/{len(same)}; wall {wall:.3f} s")
    if failures:
        raise SystemExit("phase 14e: " + "; ".join(failures))
    return {"launches": launches, "dispatches": programs, "forwards": stats["forwards"],
            "steals": stats["steals"], "rerouted": stats["rerouted"],
            "routed": stats["routed"], "rows_equal": sum(same), "wall_s": wall}


def fleet_launched(dev, counters, card: str, runs: dict) -> dict:
    """Phase 14d: 14a's 12 requests through ``serve.main(... --fleet 4)``
    (gateway_path's checks), each row against 14a's for the same request
    (bits, or GATEWAY_REL_L2 where the batch composition differs), the
    homes HRW gives the two affinity keys and the routed counts."""
    from repro_torch.serving import FleetRouter

    run = gateway_path(dev, counters, card, "14d fleet", ["--fleet", str(FLEET_HOSTS)],
                       SEQ, (4, 8), 12)
    run.pop("sampler")
    run["errors_to_14a"] = across("gateway 14d rows against 14a's for the same requests",
                                  run["rows"], runs["14a"]["rows"], GATEWAY_REL_L2)
    router = FleetRouter([f"h{i}" for i in range(FLEET_HOSTS)])
    homes = {m: router.route(("flow", m, (SEQ,), None)) for m in (4, 8)}
    print(f"gateway 14d: homes {homes} (budget -> host), routed {run['routed']}, steals "
          f"{run['steals']}; flash and ns_update launches {run['launches']['flash_attention']} "
          f"and {run['launches']['ns_update']}, the dispatches' sum")
    if sum(run["routed"].values()) != 12 or any(
            run["routed"][h] != sum(6 for m in (4, 8) if homes[m] == h) for h in run["routed"]):
        raise SystemExit(f"gateway 14d: routed {run['routed']}, homes {homes}")
    run["homes"] = homes
    return run


def gateways(dev, counters, card: str, graphs: dict) -> dict:
    """Phase 14: 14a flush, 14b continuous, 14c shape tiers, 14d the fleet
    through the launcher, 14e the fleet direct on 14a's sampler; phase 15's
    anytime cases on 14a's sampler (seq 1024), into ``graphs``."""
    runs = {"14a": gateway_path(dev, counters, card, "14a flush", [], SEQ, (4, 8), 12,
                                {"b4/k4": 1, "b8/k4": 1, "bmix/k4": 1})}
    sampler14a = runs["14a"].pop("sampler")
    graphs.update(anytime_programs(dev, counters, sampler14a, SEQ))
    runs["14b"] = gateway_path(dev, counters, card, "14b continuous",
                               ["--continuous", "--max-slots", "4"], SEQ, (4, 8), 8)
    runs["14b"].pop("sampler")
    if runs["14b"]["dispatches"].get("start/k4", 0) < 1:
        raise SystemExit("gateway 14b: no trajectory opened")
    # 14b's requests are 14a's first eight: trajectory rows (joined ones
    # included) against the same requests served in 14a's bucket-4 batches
    flushed, legs = runs["14a"]["rows"], runs["14b"]["rows"]
    across = [row_errors(legs[uid], torch.from_numpy(flushed[uid])) for uid in sorted(legs)]
    print(f"gateway 14b rows against 14a's for the same requests: equal "
          f"{[e['equal'] for e in across]}, max |diff| "
          f"{max(e['max_abs'] for e in across):.3e}")
    if any(not (e["equal"] or e["rel_l2"] <= GATEWAY_REL_L2) for e in across):
        raise SystemExit(f"gateway 14b: rows against 14a's over {GATEWAY_REL_L2}: {across}")
    runs["14b"]["equal_to_14a"] = [e["equal"] for e in across]
    runs["14c"] = gateway_path(dev, counters, card, "14c tiers", ["--tiers", "512,1024"],
                               1000, (8,), 4, {"b8/k4": 1})
    runs["14c"].pop("sampler")
    t0 = time.perf_counter()
    runs["14d"] = fleet_launched(dev, counters, card, runs)
    runs["14e"] = fleet_direct(dev, counters, card, sampler14a)
    runs["14d"]["phase_s"] = time.perf_counter() - t0
    del sampler14a
    return runs


def mesh_gateway(dev, counters, card: str, flushed: dict) -> dict:
    """Phase 23a: 14a's trace through ``serve.main(... --mesh host)``: the
    weights and each batch placed on the 1 x 1 mesh as DTensors, every
    kernel run on its local shard. The dispatches and the launches equal
    14a's; each row equals 14a's for the same request, or the largest
    difference is printed and over MESH_REL_L2 relative L2 fails."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import serve

    free_device_memory(dev)
    reset(counters)
    t0 = time.perf_counter()
    served = serve.main(GATEWAY_ARGS + [
        "--solver-artifact", str(ANYTIME_ARTIFACT), "--seq", str(SEQ),
        "--request-budgets", "4,8", "--requests", "12", "--mesh", "host"])
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    snap, stats, sampler = served.metrics, served.stats, served.sampler
    programs = {k[len('dispatches{program="'):-2]: int(v) for k, v in snap.items()
                if k.startswith('dispatches{program="')}
    wq = sampler.params["layers"]["attn"]["wq"]
    rows = {uid: r.latents for uid, r in enumerate(served.responses)}
    errs = [row_errors(rows[uid], torch.from_numpy(flushed["rows"][uid])) for uid in rows]
    equal = [e["equal"] for e in errs]
    print(f"phase 23a ({card}): --mesh host, weights {type(wq).__name__} on "
          f"{wq.device_mesh if isinstance(wq, DTensor) else None} placed "
          f"{getattr(wq, 'placements', None)}; dispatches {programs} (14a {flushed['dispatches']}); "
          f"launches {launches} (14a {flushed['launches']}); programs captured "
          f"{stats.get('program_captures')}, replays {stats.get('program_replays')}; done "
          f"{stats['completed']}/{stats['submitted']}, failed {stats['failed']}; rows equal to "
          f"14a's {sum(equal)}/{len(equal)}, max |diff| {max(e['max_abs'] for e in errs):.3e}, "
          f"relative L2 max {max(e['rel_l2'] for e in errs):.3e}; submit-to-drain "
          f"{served.wall_s:.3f} s (14a {flushed['wall_s']:.3f} s); main() wall {wall:.3f} s")
    failures = []
    if not isinstance(wq, DTensor):
        failures.append(f"the weights are {type(wq).__name__}, not placed")
    if programs != flushed["dispatches"] or launches != flushed["launches"]:
        failures.append("dispatches or launches differ from 14a's")
    if (stats["completed"], stats["failed"]) != (12, 0):
        failures.append(f"done {stats['completed']}, failed {stats['failed']}")
    if any(not (e["equal"] or e["rel_l2"] <= MESH_REL_L2) for e in errs):
        failures.append(f"rows over {MESH_REL_L2} relative L2: {errs}")
    if failures:
        raise SystemExit("phase 23a: " + "; ".join(failures))
    return {"launches": launches, "dispatches": programs, "rows_equal": sum(equal),
            "max_abs": max(e["max_abs"] for e in errs),
            "max_rel_l2": max(e["rel_l2"] for e in errs), "wall_s": served.wall_s,
            "programs": {"captures": stats.get("program_captures"),
                         "replays": stats.get("program_replays")}}


def mesh_decode(dev, counters, card: str) -> dict:
    """Phase 23b: a short form of phase 6's trace (MESH_DECODE_ARGS) through
    ``DecodeGateway`` on one yi-6b engine at full width with the paged
    kernel, first unsharded, then with ``mesh=`` the host mesh (the engine's
    weights and the paged pool placed as DTensors, the kernel on the local
    shard). Tokens equal; the paged kernel launches LAYERS a
    ``decode_apply`` call in both runs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.serving import DecodeEngine, DecodeGateway, DecodeRequest

    a = MESH_DECODE_ARGS
    free_device_memory(dev)
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=LAYERS)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    engine = DecodeEngine(params=params, cfg=cfg, page_size=a["page_size"], paged_kernel=True)
    out = {}
    for label, mesh in (("unsharded", None), ("mesh", make_host_mesh(dev))):
        reset(counters)
        with CountCalls() as calls:
            gw = DecodeGateway(engine, max_slots=a["max_slots"], cache_slots=a["slots"],
                               prefill_chunk=a["prefill"], mesh=mesh)
            t0 = time.perf_counter()
            futs = [gw.submit(DecodeRequest(
                prompt=[(3 * r + 1) % cfg.vocab, (5 * r + 2) % cfg.vocab],
                max_tokens=a["lengths"][r % len(a["lengths"])])) for r in range(a["requests"])]
            gw.drain()
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        out[label] = {"tokens": [f.result().tokens.tolist() for f in futs],
                      "launches": {k: c.launches for k, c in counters.items()},
                      "calls": calls.calls, "wall_s": wall, "stats": gw.stats()}
    u, m = out["unsharded"], out["mesh"]
    want = {**dict.fromkeys(KERNELS, 0), "paged_attention": LAYERS * m["calls"]}
    state_type = type(gw._state.k_pages).__name__
    print(f"phase 23b ({card}): DecodeGateway yi-6b full width, paged kernel, "
          f"{a['requests']} requests on {a['max_slots']} slots: tokens equal "
          f"{u['tokens'] == m['tokens']}; decode_apply calls {u['calls']} / {m['calls']}; "
          f"launches {u['launches']} / {m['launches']}; pool {state_type}; wall "
          f"{u['wall_s']:.3f} / {m['wall_s']:.3f} s; programs captured "
          f"{u['stats']['program_captures']} / {m['stats']['program_captures']}")
    if (u["tokens"] != m["tokens"] or m["launches"] != want or u["launches"] != {
            **want, "paged_attention": LAYERS * u["calls"]} or state_type != "DTensor"
            or m["stats"]["completed"] != a["requests"]):
        raise SystemExit(f"phase 23b: tokens {u['tokens']} / {m['tokens']}, launches "
                         f"{u['launches']} / {m['launches']} (want {want}), pool {state_type}")
    return {"launches": m["launches"], "calls": m["calls"], "tokens_equal": True,
            "wall_s": {"unsharded": u["wall_s"], "mesh": m["wall_s"]}}


def mesh_distill_step(dev, counters, card: str) -> dict:
    """Phase 23c: ``make_distributed_bns_step`` at world size 1 on the host
    mesh, DIST_ITERS iterations on yi-6b's velocity field at full width and
    DIST_LAYERS layers (f32, unconditional, each layer recomputed in the
    backward as phase 12's field), pairs of DIST_PAIRS x DIST_SEQ
    noise and an Euler solve at NFE 16 of it; theta and the losses against
    the plain single-process step (the PSNR loss, autograd, Adam at the
    host-computed rate) within the f32 TOL."""
    from repro_torch.core import ns_solver
    from repro_torch.core.bns import (
        BNSTrainConfig,
        _loss_fn,
        make_distributed_bns_step,
        ns_sampler,
    )
    from repro_torch.core.schedulers import fm_ot
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adam import adam_update, tree_leaves, tree_map, tree_unflatten
    from repro_torch.optim.schedule import poly_decay
    from repro_torch.solvers.registry import build_ns

    free_device_memory(dev)
    cfg, params = small_model("yi-6b")
    cfg = dataclasses.replace(cfg, n_layers=DIST_LAYERS)
    params = tree_map(lambda p: p.to(dev), params)
    field = M.velocity_field(params, cfg, fm_ot(), None, remat=True)   # phase 12's form
    g = torch.Generator(device=dev).manual_seed(23)
    x0 = torch.randn((DIST_PAIRS, DIST_SEQ, cfg.latent_dim), generator=g, device=dev)
    with torch.no_grad():
        x1 = ns_solver.ns_sample(build_ns("euler", 16, field), field.fn, x0)
    tcfg = BNSTrainConfig(nfe=NFE, init_solver="euler", iterations=10, lr=1e-3)
    reset(counters)
    step, theta, opt = make_distributed_bns_step(field, tcfg, make_host_mesh(dev))
    th, op = theta, opt
    lr_fn = poly_decay(tcfg.lr, tcfg.iterations)
    losses = []
    t0 = time.perf_counter()
    for it in range(DIST_ITERS):
        theta, opt, loss = step(theta, opt, it, x0, x1)
        losses.append(float(loss))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    reset(counters)
    plain = []
    for it in range(DIST_ITERS):
        g_th = tree_map(lambda p: p.detach().requires_grad_(True), th)
        loss = _loss_fn(ns_sampler(field), g_th, x0, x1)
        grads = torch.autograd.grad(loss, tree_leaves(g_th))
        with torch.no_grad():
            th, op = adam_update(tree_unflatten(th, list(grads)), op, th,
                                 torch.tensor(float(lr_fn(it)), dtype=torch.float32,
                                              device=dev))
        plain.append(float(loss.detach()))
    plain_launches = {k: c.launches for k, c in counters.items()}
    tol = TOL[torch.float32]
    errs = [float((a - b).abs().max()) for a, b in zip(tree_leaves(theta), tree_leaves(th))]
    close = all(torch.allclose(a, b, atol=tol, rtol=tol)
                for a, b in zip(tree_leaves(theta), tree_leaves(th)))
    bits = all(torch.equal(a, b) for a, b in zip(tree_leaves(theta), tree_leaves(th)))
    want = {**dict.fromkeys(KERNELS, 0), "ns_update": NFE * DIST_ITERS,   # the forward
            "ns_update_bwd": NFE * DIST_ITERS,          # and its recompute: flash twice
            "flash_attention": 2 * DIST_LAYERS * NFE * DIST_ITERS,
            "flash_attention_bwd": DIST_LAYERS * NFE * DIST_ITERS}
    print(f"phase 23c ({card}): make_distributed_bns_step on the 1 x 1 mesh, yi-6b full width "
          f"at {DIST_LAYERS} layers f32, {DIST_PAIRS} x {DIST_SEQ} pairs, {DIST_ITERS} "
          f"iterations: losses {[round(v, 6) for v in losses]} (plain step "
          f"{[round(v, 6) for v in plain]}); theta max |diff| a leaf {errs}, equal to the bit "
          f"{bits}; launches {launches} (the plain step's {plain_launches}); "
          f"{wall / DIST_ITERS * 1e3:.1f} ms an iteration")
    if not close or losses != plain and not np.allclose(losses, plain, atol=tol, rtol=tol):
        raise SystemExit(f"phase 23c: theta or losses beyond {tol}: {errs}, {losses} / {plain}")
    if not launches == plain_launches == want:
        raise SystemExit(f"phase 23c: launches {launches}, the plain step's {plain_launches}, "
                         f"expected {want}")
    return {"launches": launches, "theta_equal": bits, "theta_max_abs": max(errs),
            "losses": losses, "iteration_ms": wall / DIST_ITERS * 1e3}


def placement_paths(dev, counters, card: str, flushed: dict) -> dict:
    """Phase 23: placement on the host mesh (23a flow gateway, 23b decode
    gateway, 23c the distributed step); the process group it starts is
    destroyed at the end."""
    import torch.distributed as dist

    runs, wall = {}, {}
    try:
        for name, fn in (("23a", lambda: mesh_gateway(dev, counters, card, flushed)),
                         ("23b", lambda: mesh_decode(dev, counters, card)),
                         ("23c", lambda: mesh_distill_step(dev, counters, card))):
            t0 = time.perf_counter()
            runs[name] = fn()
            wall[name] = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    runs["wall_s"] = wall
    return runs


GRAPH_REPS = 3           # phase 15: timed calls each way after the capture


def _same(a, b) -> bool:
    """Bit equality of two results (tensors, or tuples, lists or dicts of them)."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def graph_case(dev, counters, label: str, cache, graphed, eager) -> dict:
    """Phase 15, one program kind: ``graphed()`` goes through the engine's
    program cache (its first call captures the key, unless an earlier phase
    did) and ``eager()`` is the same call, run under ``programs.disabled()``.
    A first pair, then GRAPH_REPS timed pairs: each pair equal to the bit and
    launching the same kernels (counted apart for each side). Prints ms a
    call (host clock around the call and a sync; median) each way and the
    program's capture ms."""
    from repro_torch.serving import programs

    before_programs = len(cache)
    pairs = []
    for rep in range(GRAPH_REPS + 1):
        pair = []
        for side, call in (("graphed", graphed), ("eager", eager)):
            counts = {k: c.launches for k, c in counters.items()}
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with (programs.disabled() if side == "eager" else contextlib.nullcontext()):
                out = call()
            torch.cuda.synchronize(dev)
            pair.append((out, (time.perf_counter() - t0) * 1e3,
                         {k: c.launches - counts[k] for k, c in counters.items()}))
        pairs.append(pair)
    program = cache.last
    equal = [_same(g[0], e[0]) for g, e in pairs]
    same_launches = [g[2] == e[2] for g, e in pairs]
    g_ms = [g[1] for g, _ in pairs[1:]]
    e_ms = [e[1] for _, e in pairs[1:]]
    row = {"graphed_ms": float(np.median(g_ms)), "eager_ms": float(np.median(e_ms)),
           "graphed_each_ms": g_ms, "eager_each_ms": e_ms,
           "capture_ms": None if program is None else program.capture_ms,
           "captured_here": len(cache) > before_programs,
           "launches_a_call": {k: v for k, v in pairs[-1][0][2].items() if v},
           "equal": all(equal), "launches_equal": all(same_launches)}
    print(f"phase 15 [{label}]: graphed {row['graphed_ms']:.3f} ms a call (median of "
          f"{GRAPH_REPS}: {[round(x, 3) for x in g_ms]}), eager {row['eager_ms']:.3f} ms "
          f"({[round(x, 3) for x in e_ms]}), capture "
          + ("-" if program is None else f"{program.capture_ms:.1f} ms")
          + f" ({'this case' if row['captured_here'] else 'an earlier phase'}), "
          f"launches a call {row['launches_a_call']}, equal to the bit {equal}, "
          f"launches equal {same_launches}")
    if program is None or not program.replays or not row["equal"] or not row["launches_equal"]:
        raise SystemExit(f"phase 15 [{label}]: graphed against eager failed: {row}")
    return row


def busy_share(dev, call) -> dict:
    """One call under torch.profiler: its wall ms (host clock, synchronised)
    and the union of the device kernels' intervals; None where the profiler
    saw no device kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    busy = busy / 1e3 if spans else None
    return {"wall_ms": wall, "busy_ms": busy, "kernels": len(spans),
            "busy_share": None if busy is None else busy / wall}


def train_loop(kind: str, field, pairs: dict):
    """Phase 16: a maker of fresh ``bns.TrainLoop``s for ``kind`` ("bns":
    euler NFE 8; "anytime": the nested solver over ANYTIME_BUDGETS; "bst":
    BST-Euler at NFE 8) on ``field`` and ``pairs`` ({"train"|"val": (x0,
    x1)}, full batches), with phase 12's optimiser (lr 1e-3, cosine)."""
    from repro_torch.core import anytime, bns, bst_solver, ns_solver
    from repro_torch.solvers import build_ns

    cfg = bns.BNSTrainConfig(nfe=NFE, lr=1e-3, lr_schedule="cosine",
                             iterations=TRAIN_GRAPH_ITERS + 1, val_every=100,
                             batch_size=BATCH)
    val = pairs["val"]
    if kind == "anytime":
        objective = anytime.anytime_objective(field, ANYTIME_BUDGETS, val, cfg)
        theta0 = anytime.init_anytime(None, ANYTIME_BUDGETS)
    elif kind == "bst":
        objective = bns.solver_objective(bns.bst_sampler(field), val, cfg)
        theta0 = bst_solver.identity_bst(NFE, "euler")
    else:
        objective = bns.solver_objective(bns.ns_sampler(field), val, cfg)
        theta0 = ns_solver.from_ns(build_ns("euler", NFE, None))
    return lambda: bns.TrainLoop(*objective, theta0, pairs["train"], cfg)


def served_field(dev, sampler, seq: int):
    """The launcher's distillation field over a served sampler's weights:
    conditioning rows of ``--seed`` 0, each layer recomputed."""
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M

    cond = SyntheticTokens(sampler.cfg, DataConfig(batch_size=BATCH, seq_len=seq, seed=0),
                           device=dev).batch(0)
    return M.velocity_field(sampler.params, sampler.cfg, sampler.sched, cond, remat=True)


def train_programs(dev, counters, label: str, make_loop, profile: bool = False) -> dict:
    """Phase 16, one trainer: ``make_loop()`` builds a fresh ``bns.TrainLoop``
    (the same theta0, pairs and config each call). TRAIN_GRAPH_ITERS
    iterations and one validation graphed (the card's default), then the
    same eager under ``programs.disabled()``; with ``profile``, one more
    iteration each way before the validation, the graphed one under
    torch.profiler (its busy share). theta,
    Adam's moments and step, each loss and the val PSNR must be equal to the
    bit, and each side's launches equal."""
    from repro_torch.optim.adam import tree_leaves
    from repro_torch.serving import programs

    sides = {}
    for side in ("graphed", "eager"):
        loop = make_loop()
        steps = {k: c.launches for k, c in counters.items()}
        ms, losses, busy = [], [], None
        with (programs.disabled() if side == "eager" else contextlib.nullcontext()):
            for _ in range(TRAIN_GRAPH_ITERS):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                losses.append(loop.step())
                torch.cuda.synchronize(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
            if profile:                  # one more iteration, the graphed one profiled
                if side == "graphed":
                    busy = busy_share(dev, loop.step)
                else:
                    loop.step()
            n = TRAIN_GRAPH_ITERS + bool(profile)
            steps = {k: c.launches - steps[k] for k, c in counters.items()}
            val = {k: c.launches for k, c in counters.items()}
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            vp = loop.validate()
            torch.cuda.synchronize(dev)
            val_ms = (time.perf_counter() - t0) * 1e3
            val = {k: c.launches - val[k] for k, c in counters.items()}
        sides[side] = {"ms": ms, "val_ms": val_ms, "busy": busy, "losses": losses, "vp": vp,
                       "state": [t.clone() for t in tree_leaves((loop.theta, loop.opt))],
                       "launches": {k: v for k, v in steps.items() if v},
                       "val_launches": {k: v for k, v in val.items() if v},
                       "programs": loop.programs.stats()}
        del loop
    g, e = sides["graphed"], sides["eager"]
    checks = {"theta, mu, nu, step": [torch.equal(a, b) for a, b in zip(g["state"], e["state"])],
              "losses": [torch.equal(a, b) for a, b in zip(g["losses"], e["losses"])],
              "val PSNR": [torch.equal(g["vp"], e["vp"])],
              "launches": [g["launches"] == e["launches"]
                           and g["val_launches"] == e["val_launches"]]}
    row = {"graphed_ms": float(np.median(g["ms"][1:])), "eager_ms": float(np.median(e["ms"][1:])),
           "graphed_each_ms": g["ms"], "eager_each_ms": e["ms"],
           "capture_ms": g["programs"]["capture_ms"], "programs": g["programs"],
           "val_ms": {"graphed": g["val_ms"], "eager": e["val_ms"]},
           "launches_an_iteration": {k: v // n for k, v in g["launches"].items()},
           "launches": {k: g["launches"].get(k, 0) + g["val_launches"].get(k, 0)
                        for k in KERNELS},
           "busy": g["busy"],
           "equal": all(all(v) for v in checks.values())}
    b = g["busy"]
    busy = "" if not profile else (
        f"; one more iteration each way, the graphed one under torch.profiler: "
        f"{b['wall_ms']:.1f} ms, card busy " + (
            "not measured (no device time in the trace)" if b["busy_ms"] is None else
            f"{b['busy_ms']:.1f} ms ({100 * b['busy_share']:.1f}%, {b['kernels']} kernels)"))
    print(f"phase 16 [{label}]: graphed {row['graphed_ms']:.1f} ms an iteration (median after "
          f"the first; each {[round(x, 1) for x in g['ms']]}), eager {row['eager_ms']:.1f} ms "
          f"({[round(x, 1) for x in e['ms']]}); captures (step and validation) "
          f"{row['capture_ms']:.1f} ms, programs {g['programs']}; validation graphed "
          f"{g['val_ms']:.1f} ms, eager {e['val_ms']:.1f} ms; launches an iteration "
          f"{row['launches_an_iteration']}{busy}; equal to the bit: {checks}")
    if not row["equal"] or g["programs"]["programs"] != 2 or e["programs"]["programs"]:
        raise SystemExit(f"phase 16 [{label}]: graphed against eager failed: {checks}, "
                         f"programs {g['programs']} / {e['programs']}")
    return row


def flow_programs(dev, counters, sampler, label: str, seq: int) -> dict:
    """Phase 15 on a served ``FlowSampler``: one request batch (BATCH rows
    at ``seq``, phase 4's conditioning rows, noise from a seed) at its budget."""
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens

    cond = SyntheticTokens(sampler.cfg, DataConfig(batch_size=BATCH, seq_len=seq, seed=0),
                           device=dev).batch(0)
    x0 = torch.randn((BATCH, seq, sampler.cfg.latent_dim), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(15))
    call = lambda: sampler.sample_from(cond, x0)       # noqa: E731
    return {f"{label} flow, budget {sampler.solver.n}": graph_case(
        dev, counters, f"{label} FlowSampler budget {sampler.solver.n}, batch {BATCH}, "
        f"seq {seq}", sampler.programs, call, call)}


def anytime_programs(dev, counters, sampler, seq: int) -> dict:
    """Phase 15 on the served ``AnytimeFlowSampler``: each budget, the shared
    trajectory, and the legs between the budgets' exits."""
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.serving import programs

    cond = SyntheticTokens(sampler.cfg, DataConfig(batch_size=BATCH, seq_len=seq, seed=0),
                           device=dev).batch(0)
    x0 = torch.randn((BATCH, seq, sampler.cfg.latent_dim), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(16))

    def leg(carry, stop):
        def call():
            new, exits = sampler.carry_extend(cond, carry, stop)
            return new.U, new.x, exits
        return call

    calls = {f"anytime budget {m}": (lambda m=m: sampler.sample_from(cond, x0, m))
             for m in sampler.budgets}
    calls["anytime sample_all"] = lambda: sampler.sample_all_from(cond, x0)
    carry, start = sampler.carry_start(cond, x0), 0
    for stop in sampler.budgets:
        calls[f"anytime leg {start}->{stop}"] = leg(carry, stop)
        with programs.disabled():
            carry, _ = sampler.carry_extend(cond, carry, stop)
        start = stop
    return {name: graph_case(dev, counters, f"yi-6b {name}, batch {BATCH}, seq {seq}",
                             sampler.programs, call, call)
            for name, call in calls.items()}


def _slot_states(engine, slots: int, cache_slots: int, copies: int = 2) -> list:
    """Fresh slot states of one shape (paged: each row on its own pages)."""
    states = []
    for _ in range(copies):
        state = engine.init_slot_state(slots, cache_slots)
        if engine.paged:
            blocks = cache_slots // engine.page_size
            table = (np.arange(slots * blocks) + 1).reshape(slots, blocks).astype(np.int32)
            state = engine.with_block_table(state, table)
        states.append(state)
    return states


def decode_programs(dev, counters, engine, label: str, slots: int, cache_slots: int,
                    prefill: int, sampled: bool, start: int | None = None) -> dict:
    """Phase 15 on a served ``DecodeEngine``: ``prefill_slots`` of ``prefill``
    columns (positions reset to 0 before each call), then ``step_slots``
    greedy and (``sampled``) with per-row sampling, from position ``start``
    where given (a windowed engine's ring then wraps inside the steps),
    graphed on one slot state and eager on a second of the same shape:
    tokens and every state leaf equal to the bit after each pair. Then one
    graphed greedy step under torch.profiler: its device-busy share."""
    from repro_torch.serving.engine import SlotSampling

    states = _slot_states(engine, slots, cache_slots)
    rng = np.random.default_rng(15)
    prompt = rng.integers(0, engine.cfg.vocab, size=(slots, max(prefill, 1))).astype(np.int32)
    active = np.ones(slots, bool)
    rows = {}
    if prefill:
        def prefill_on(state):
            def call():
                state.index.zero_()
                engine.prefill_slots(prompt, np.full(slots, prefill, np.int32), state, active)
                return tuple(state)
            return call
        rows[f"{label} prefill_slots C={prefill}"] = graph_case(
            dev, counters, f"{label} prefill_slots C={prefill}, {slots} slots",
            engine.programs, prefill_on(states[0]), prefill_on(states[1]))
    if start is not None:
        for state in states:
            state.index.fill_(start)
    feeds, steps = [prompt[:, -1].copy(), prompt[:, -1].copy()], [0, 0]
    sampling = SlotSampling(seeds=np.arange(slots, dtype=np.uint64) + 15,
                            counts=np.zeros(slots, np.int32),
                            temps=np.where(np.arange(slots) % 2, 0.8, 0.0).astype(np.float32),
                            top_ks=np.where(np.arange(slots) % 3, 50, 0).astype(np.int32),
                            top_ps=np.full(slots, 0.9, np.float32))

    def step_on(i, sample: bool):
        def call():
            samp = (sampling._replace(counts=np.full(slots, steps[i], np.int32))
                    if sample else None)
            toks, _ = engine.step_slots(feeds[i], states[i], active, sampling=samp)
            feeds[i], steps[i] = np.asarray(toks), steps[i] + 1
            return (toks,) + tuple(states[i])
        return call

    for sample in (False, True) if sampled else (False,):
        name = f"{label} step_slots {'sampled' if sample else 'greedy'}"
        rows[name] = graph_case(dev, counters, f"{name}, {slots} slots", engine.programs,
                                step_on(0, sample), step_on(1, sample))
    busy = busy_share(dev, step_on(0, False))
    greedy = rows[f"{label} step_slots greedy"]
    if busy["busy_ms"] is None:
        share = "not measured (the profiler saw no device kernel)"
    else:
        busy["busy_share_of_median"] = busy["busy_ms"] / greedy["graphed_ms"]
        share = (f"{busy['busy_ms']:.3f} ms of device time in {busy['kernels']} kernels: "
                 f"{100 * busy['busy_share']:.1f}% of the profiled call, "
                 f"{100 * busy['busy_share_of_median']:.1f}% of the median graphed call "
                 f"({greedy['graphed_ms']:.3f} ms, unprofiled)")
    print(f"phase 15 [{label} one graphed greedy step under torch.profiler]: "
          f"{busy['wall_ms']:.3f} ms, card busy {share}")
    greedy["profiled"] = busy
    return rows


def workspace_growth(dev, counters, engine) -> dict:
    """Phase 15: a paged decode step captured at a small shape (2 slots of 16
    pages), then one at a larger shape (2 slots of 64 pages) that grows the
    paged kernel's merge workspace, then the first program replayed: equal
    to the bit to the same step run eagerly. Starts from a fresh plan state
    for the device (the earlier phases' buffers kept alive beside it), so
    the growth happens here whatever shapes ran before."""
    from repro_torch.kernels.flash_attention import paged_attention as pa
    from repro_torch.serving import programs

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    old = pa._DEVICES.get(index)
    fresh = pa._DEVICES[index] = pa._Device(index)
    if old is not None:
        fresh.retired += [(old.workspace, old.counters)] + old.retired
    small = _slot_states(engine, 2, 16 * engine.page_size)
    large = _slot_states(engine, 2, 64 * engine.page_size, copies=1)[0]
    feed, active = np.array([1, 2], np.int32), np.ones(2, bool)
    engine.step_slots(feed, small[0], active)              # captures the small program
    with programs.disabled():
        engine.step_slots(feed, small[1], active)
    first = fresh.workspace.data_ptr()
    engine.step_slots(feed, large, active)                 # captures at the larger shape
    grew = fresh.workspace.data_ptr() != first
    row = graph_case(dev, counters, "yi-6b step_slots at 2 x 16 pages after the workspace grew",
                     engine.programs,
                     lambda: (engine.step_slots(feed, small[0], active)[0],) + tuple(small[0]),
                     lambda: (engine.step_slots(feed, small[1], active)[0],) + tuple(small[1]))
    print(f"phase 15 [paged workspace]: grew after the first capture: {grew} "
          f"({len(fresh.retired)} buffers kept alive)")
    if not grew:
        raise SystemExit("phase 15: the paged workspace did not grow after the first capture")
    return {"grew": grew, **row}



def zamba2_paths(dev, counters, card: str, graphs: dict) -> dict:
    """Phases 17-17d: zamba2-2.7b served at full width in flow (17) and
    decode (17c), with phase 15's cases on each engine; each path on the card
    against the CPU on the 2-layer f32 model (17b, 17d)."""
    zero = dict.fromkeys(KERNELS, 0)
    flows = NFE * REQUESTS
    out, wall = {}, {}
    t0 = time.perf_counter()
    out["launches"], out["flow"] = flow_path(
        dev, counters, "zamba2-2.7b",
        {**zero, "ns_update": flows, "flash_attention": ZAMBA_SITES * flows,
         "gla_scan": ZAMBA_LAYERS * flows}, graphs, lm=True)
    wall["17+15"] = time.perf_counter() - t0
    print(f"phase 17 ({card}): zamba2-2.7b flow request ms "
          f"{[round(x, 3) for x in out['flow']['request_ms']]}, peak memory "
          f"{out['flow']['peak_gib']:.3f} GiB")
    t0 = time.perf_counter()
    cfg, params = small_model("zamba2-2.7b")
    out["flow_rel_l2"] = whole_path_against_cpu(
        dev, counters, cfg, params,
        {**zero, "ns_update": 4, "flash_attention": 4, "gla_scan": 2 * 4})
    lm_against_cpu(dev, counters, cfg, params)
    window_against_cpu(dev, counters, cfg, params)
    wall["17b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["decode"] = {}
    decode_path(dev, counters, ZAMBA_DECODE_ARGS, {}, graphs, prefill=ZAMBA_PREFILL,
                sampled=True, runs=out["decode"])
    wall["17c+15"] = time.perf_counter() - t0
    print(f"phase 17c ({card}): zamba2-2.7b decode {out['decode']['tokens_per_s']:.1f} "
          f"tokens/s, engine call ms mean {out['decode']['call_ms_mean']:.3f}, peak memory "
          f"{out['decode']['peak_gib']:.3f} GiB")
    t0 = time.perf_counter()
    out["decode_rel_l2"] = decode_against_cpu(dev, counters, cfg, params, {}, {})
    wall["17d"] = time.perf_counter() - t0
    out["wall_s"] = wall
    return out


def card_drawn_model(dev, arch: str, layers: int = 2):
    """The arch's width cut to ``layers`` layers, f32, random weights drawn on
    the card (a full-width draw on the host takes tens of seconds a model):
    (cfg, the params on the card, their copy on the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.transformer import params_to

    free_device_memory(dev)
    cfg = get_config(arch)
    # an encoder-decoder model takes ``layers`` in each stack; a hybrid one
    # keeps one shared-attention site over its ``layers`` Mamba2 layers
    enc = {"n_encoder_layers": layers} if cfg.n_encoder_layers else {}
    if cfg.family == "hybrid":
        enc["hybrid_attn_every"] = layers
    cfg = dataclasses.replace(cfg, n_layers=layers, dtype="float32", **enc)
    on_card = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    return cfg, on_card, params_to(on_card, "cpu")


def launched(counters, before: dict) -> dict:
    return {name: c.launches - before[name] for name, c in counters.items()}


class RouterCalls:
    """Records every MoE router call's expert choices, with the
    probabilities they came from, on the side ``side`` names ("card" or
    "cpu"), by wrapping ``moe._routing`` while the context is open;
    ``flips`` compares the two sides call by call."""

    def __init__(self):
        self.calls, self.side = {"card": [], "cpu": []}, "card"

    def __enter__(self):
        from repro_torch.models import moe

        self.module, self.inner = moe, moe._routing

        def recording(p, x2d, c, mean=None):
            gates, idx, aux = self.inner(p, x2d, c, mean=mean)
            probs = torch.softmax(x2d.float() @ p["router"].float(), dim=-1)
            self.calls[self.side].append((probs.detach().cpu(), idx.cpu()))
            return gates, idx, aux

        moe._routing = recording
        return self

    def __exit__(self, *exc):
        self.module._routing = self.inner

    def flips(self, cfg, per_step: int = 0) -> list:
        """One line a router call whose choices differ (``per_step`` calls an
        NFE step, where the calls run step by step): the first differing
        token's choices on each side, both sides' probabilities of the
        experts involved and the CPU's gap between its k-th and (k+1)-th
        probability."""
        k, out = cfg.moe.top_k, []
        for call, ((pc, ic), (pp, ip)) in enumerate(zip(self.calls["card"],
                                                        self.calls["cpu"])):
            if torch.equal(ic, ip):
                continue
            t = int((ic != ip).any(-1).nonzero()[0, 0])
            ranked = pp[t].sort(descending=True).values
            experts = sorted(set(ic[t].tolist()) ^ set(ip[t].tolist())) or ic[t].tolist()
            where = (f" (NFE step {call // per_step}, call {call % per_step} of the step)"
                     if per_step else "")
            out.append(f"call {call}{where}, token {t}: card {ic[t].tolist()}, CPU "
                       f"{ip[t].tolist()}; "
                       f"experts {experts}: card p {[float(pc[t, e]) for e in experts]}, CPU "
                       f"p {[float(pp[t, e]) for e in experts]}; CPU gap between its {k}th "
                       f"and {k + 1}th {float(ranked[k - 1] - ranked[k]):.3e}")
        return out


def routed_path_against_cpu(dev, counters, cfg, params, on_card, want: dict) -> dict:
    """Phase 18b: phase 5 for an MoE model (``on_card``: ``params``' copy on
    the card), eagerly on both sides. Every
    router call's expert choices are recorded (with the probabilities they
    came from) and compared first, call by call (a call is one layer of one
    NFE step); a flip prints the two sides' probabilities of the experts
    involved and the CPU's gap between its k-th and (k+1)-th probability, and
    fails. Then the latents (relative L2 <= 1e-4) and their nearest tokens
    (equal)."""
    from repro_torch.serving import programs
    from repro_torch.serving.engine import FlowSampler

    batch, x0, kw = euler_inputs(cfg, params)
    with RouterCalls() as router, programs.disabled():
        before = {name: c.launches for name, c in counters.items()}
        card_sampler = FlowSampler(params=on_card, **kw)
        on_card = card_sampler.sample_from(batch, x0)
        torch.cuda.synchronize(dev)
        ran = launched(counters, before)
        router.side = "cpu"
        cpu_sampler = FlowSampler(params=params, **kw)
        on_cpu = cpu_sampler.sample_from(batch, x0)
    if ran != want:
        raise SystemExit(f"{cfg.name} card run launched {ran}, expected {want}")
    calls, flips = len(router.calls["cpu"]), router.flips(cfg, cfg.n_layers)
    print(f"whole path, {cfg.name}, expert choices card vs CPU: {calls} router calls "
          f"({cfg.n_layers} layers x 4 steps) of {x0.shape[0] * x0.shape[1]} tokens x top "
          f"{cfg.moe.top_k}, {len(flips)} differ" + ("; " + " | ".join(flips) if flips else ""))
    if flips or len(router.calls["card"]) != calls or calls != 4 * cfg.n_layers:
        raise SystemExit(f"{cfg.name}: expert choices differ between the card and the CPU "
                         f"({len(router.calls['card'])} and {calls} router calls): {flips}")
    rel = relative_l2(on_card.cpu(), on_cpu)
    same = bool(torch.equal(card_sampler.nearest_tokens(on_card).cpu(),
                            cpu_sampler.nearest_tokens(on_cpu)))
    print(f"whole path, {cfg.name}, card kernels vs CPU plain ({cfg.n_layers} layers, f32, euler "
          f"NFE 4): relative L2 {rel:.3e} (limit 1e-4), nearest tokens equal: {same}")
    if not (rel <= 1e-4 and same):
        raise SystemExit(f"whole path {cfg.name}: relative L2 {rel}, tokens equal {same}")
    return {"relative_l2": rel, "router_calls": calls, "tokens_equal": same, "launches": ran}


def moe_paths(dev, counters, card: str, graphs: dict) -> dict:
    """Phases 18-18d: qwen3-moe-30b-a3b served at full width and depth in
    flow (18) and decode through the paged kernel (18c), with phase 15's
    cases on each engine; each path on the card against the CPU on the
    2-layer f32 model (18b, with the expert choices; 18d)."""
    zero = dict.fromkeys(KERNELS, 0)
    flows = NFE * REQUESTS
    out, wall, phases = {}, {}, {}
    t0 = time.perf_counter()
    phases["18"], out["flow"] = flow_path(
        dev, counters, MOE_ARCH,
        {**zero, "ns_update": flows, "flash_attention": MOE_LAYERS * flows}, graphs, lm=True)
    wall["18+15"] = time.perf_counter() - t0
    print(f"phase 18 ({card}): {MOE_ARCH} flow request ms "
          f"{[round(x, 3) for x in out['flow']['request_ms']]}, capture "
          f"{out['flow']['capture_ms']:.1f} ms, peak memory {out['flow']['peak_gib']:.3f} GiB")
    t0 = time.perf_counter()
    cfg, on_card, params = card_drawn_model(dev, MOE_ARCH)
    out["flow_against_cpu"] = routed_path_against_cpu(
        dev, counters, cfg, params, on_card, {**zero, "ns_update": 4, "flash_attention": 2 * 4})
    lm_against_cpu(dev, counters, cfg, params, on_card)
    window_against_cpu(dev, counters, cfg, params, on_card)
    del on_card
    phases["18b"] = out["flow_against_cpu"]["launches"]
    wall["18b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["decode"] = {}
    phases["18c"] = decode_path(dev, counters, MOE_DECODE_ARGS,
                                {"paged_attention": MOE_LAYERS}, graphs, runs=out["decode"])
    wall["18c+15"] = time.perf_counter() - t0
    print(f"phase 18c ({card}): {MOE_ARCH} decode {out['decode']['tokens_per_s']:.1f} "
          f"tokens/s, engine call ms mean {out['decode']['call_ms_mean']:.3f}, peak memory "
          f"{out['decode']['peak_gib']:.3f} GiB")
    t0 = time.perf_counter()
    before = {name: c.launches for name, c in counters.items()}
    out["decode_rel_l2"] = decode_against_cpu(dev, counters, cfg, params,
                                              dict(page_size=16, paged_kernel=True),
                                              {"paged_attention": 2})
    phases["18d"] = launched(counters, before)
    wall["18d"] = time.perf_counter() - t0
    del params
    out["wall_s"], out["phase_launches"] = wall, phases
    return out


def moe_235b_paths(dev, counters, card: str, graphs: dict) -> dict:
    """Phase 19: qwen3-moe-235b-a22b at MOE_235B_DEPTH of its 94 layers, full
    width: one flow request and a short decode through the paged kernel at
    G = 16 (phase 15's step case on its engine); then card vs CPU, flow and
    decode, on the smoke config (2 layers, f32: a full-width layer is 10 GB in
    f32) with the full config's attention heads, 64 over 4 of 128 (the smoke
    config's hd 32 is not among the flash kernel's head dims), so flash and
    the paged kernel run at G = 16 there too."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    zero = dict.fromkeys(KERNELS, 0)
    out, wall, phases = {}, {}, {}
    t0 = time.perf_counter()
    with launcher_depth(MOE_235B_DEPTH):
        phases["19"], out["flow"] = flow_path(
            dev, counters, MOE_235B,
            {**zero, "ns_update": NFE, "flash_attention": MOE_235B_DEPTH * NFE}, graphs,
            requests=1, programs=False)
        out["decode"] = {}
        phases["19 decode"] = decode_path(dev, counters, MOE_235B_DECODE_ARGS,
                                          {"paged_attention": MOE_235B_DEPTH}, graphs,
                                          runs=out["decode"])
    wall["19+15"] = time.perf_counter() - t0
    print(f"phase 19 ({card}): {MOE_235B} at {MOE_235B_DEPTH} of 94 layers, flow request "
          f"ms {[round(x, 3) for x in out['flow']['request_ms']]} (capture "
          f"{out['flow']['capture_ms']:.1f} ms), peak memory {out['flow']['peak_gib']:.3f} "
          f"GiB; decode {out['decode']['tokens_per_s']:.1f} tokens/s, engine call ms mean "
          f"{out['decode']['call_ms_mean']:.3f}, peak {out['decode']['peak_gib']:.3f} GiB")
    t0 = time.perf_counter()
    free_device_memory(dev)
    full = get_config(MOE_235B)
    cfg = dataclasses.replace(get_config(MOE_235B, smoke=True), n_heads=full.n_heads,
                              n_kv_heads=full.n_kv_heads, head_dim=full.head_dim)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    before = {name: c.launches for name, c in counters.items()}
    out["flow_rel_l2"] = whole_path_against_cpu(
        dev, counters, cfg, params, {**zero, "ns_update": 4, "flash_attention": 2 * 4})
    out["decode_rel_l2"] = decode_against_cpu(dev, counters, cfg, params,
                                              dict(page_size=16, paged_kernel=True),
                                              {"paged_attention": 2})
    phases["19b"] = launched(counters, before)
    wall["19b"] = time.perf_counter() - t0
    out["wall_s"], out["phase_launches"] = wall, phases
    return out


def dense_paths(dev, counters, card: str) -> dict:
    """Phase 20: phi3-medium-14b, command-r-35b and yi-34b at full width and
    depth, one flow request each (flash launches = layers x NFE), each then
    on the card against the CPU at 2 layers (f32, drawn on the card)."""
    zero = dict.fromkeys(KERNELS, 0)
    out, wall, phases = {}, {}, {}
    for arch, layers in DENSE_LAYERS.items():
        t0 = time.perf_counter()
        phases[f"20 {arch}"], flow = flow_path(
            dev, counters, arch, {**zero, "ns_update": NFE, "flash_attention": layers * NFE},
            {}, requests=1, programs=False)
        cfg, on_card, params = card_drawn_model(dev, arch)
        before = {name: c.launches for name, c in counters.items()}
        rel = whole_path_against_cpu(dev, counters, cfg, params,
                                     {**zero, "ns_update": 4, "flash_attention": 2 * 4},
                                     card_params=on_card)
        phases[f"20 {arch} vs CPU"] = launched(counters, before)
        del on_card, params
        out[arch] = {**flow, "flow_rel_l2": rel}
        wall[f"20 {arch}"] = time.perf_counter() - t0
        print(f"phase 20 ({card}): {arch} full width and depth ({layers} layers), flow "
              f"request ms {[round(x, 3) for x in flow['request_ms']]} (capture "
              f"{flow['capture_ms']:.1f} ms), peak memory {flow['peak_gib']:.3f} GiB, card "
              f"vs CPU {rel:.3e}")
    out["wall_s"], out["phase_launches"] = wall, phases
    return out


def rk45_case(dev, counters, label: str, fn, x0s: list, tol: float) -> dict:
    """Phase 16's RK45 gate, one field: the solves of ``x0s`` through one
    fresh ``RK45Program`` (graphed: the first step captures, every later
    step of both solves replays), then the same solves through another under
    ``programs.disabled()``: x1 equal to the bit, the counts equal, the
    launches equal, one capture in all; seconds each way."""
    from repro_torch.core.rk45 import RK45Program, rk45_solve
    from repro_torch.serving import programs

    runs = {}
    for side in ("graphed", "eager"):
        program = RK45Program(fn, dev)
        counts = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with (programs.disabled() if side == "eager" else contextlib.nullcontext()):
            res = [rk45_solve(fn, x0, rtol=tol, atol=tol, program=program) for x0 in x0s]
        torch.cuda.synchronize(dev)
        runs[side] = {"res": res, "s": time.perf_counter() - t0,
                      "launches": {k: c.launches - counts[k] for k, c in counters.items()},
                      "programs": program.stats()}
    g, e = runs["graphed"], runs["eager"]
    equal = [torch.equal(a.x1, b.x1) and (a.nfe, a.accepted, a.rejected)
             == (b.nfe, b.accepted, b.rejected) for a, b in zip(g["res"], e["res"])]
    row = {"graphed_s": g["s"], "eager_s": e["s"],
           "solves": [(r.nfe, r.accepted, r.rejected) for r in g["res"]],
           "programs": g["programs"], "equal": equal,
           "launches_equal": g["launches"] == e["launches"],
           "launches": {k: v for k, v in g["launches"].items() if v}}
    print(f"phase 16 [rk45, {label}]: graphed {g['s']:.3f} s, eager {e['s']:.3f} s for "
          f"{len(x0s)} solves (nfe, accepted, rejected) {row['solves']}; step program "
          f"{g['programs']}; x1 and counts equal to the bit {equal}, launches equal "
          f"{row['launches_equal']} {row['launches']}")
    if not (all(equal) and row["launches_equal"] and g["programs"]["programs"] == 1
            and e["programs"]["programs"] == 0
            and g["programs"]["replays"] == sum(r.nfe // 7 for r in g["res"]) - 1):
        raise SystemExit(f"phase 16 [rk45, {label}]: graphed against eager failed: {row}")
    return row


def rk45_programs_gate(dev, counters) -> dict:
    """Phase 16's RK45 cases: yi-6b at full width and RK45_GATE_LAYERS layers
    (bf16, its conditioning batch of BATCH rows at RK45_GATE_SEQ) and the
    claims twin's toy field, each two solves of one shape (``rk45_case``)."""
    from repro_torch.benchmarks.psnr_vs_nfe import make_field
    from repro_torch.configs import get_config
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M

    free_device_memory(dev)
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=RK45_GATE_LAYERS)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    cond = SyntheticTokens(cfg, DataConfig(batch_size=BATCH, seq_len=RK45_GATE_SEQ, seed=0),
                           device=dev).batch(0)
    field = M.velocity_field(params, cfg, get_scheduler("fm_ot"), cond)
    g = torch.Generator(device=dev).manual_seed(27)
    x0s = [torch.randn((BATCH, RK45_GATE_SEQ, cfg.latent_dim), generator=g, device=dev)
           for _ in range(2)]
    out = {f"yi-6b full width, {RK45_GATE_LAYERS} layers, batch {BATCH}, seq "
           f"{RK45_GATE_SEQ}": rk45_case(dev, counters, f"yi-6b, {RK45_GATE_LAYERS} layers, "
                                         f"seq {RK45_GATE_SEQ}", field.fn, x0s, 1e-5)}
    del params, field
    toy = make_field("fm_ot", dev)
    x0s = [torch.randn((256, 2), generator=g, device=dev) for _ in range(2)]
    out["claims twin toy field, fm_ot, 256 x 2"] = rk45_case(
        dev, counters, "toy mixture field, fm_ot, 256 x 2", toy.fn, x0s, 1e-5)
    return out


def encoded_greedy(engine, frames: torch.Tensor, steps: int, slots: int):
    """Greedy decode over ``frames``' encoded memory: a fresh state, its
    memory written by ``whisper.encode``, ``steps`` tokens from token 0
    (through the engine's step program). Returns (tokens, state)."""
    from repro_torch.models import whisper

    state = engine.init_state(frames.shape[0], slots)
    with torch.no_grad():
        state.memory.copy_(whisper.encode(engine.params, engine.cfg,
                                          frames.to(engine.device)))
    prompt = torch.zeros((frames.shape[0],), dtype=torch.int32, device=engine.device)
    tokens, state = engine.greedy(prompt, state, steps)
    return tokens.cpu(), state


def whisper_greedy(dev, counters, card: str) -> dict:
    """Phase 21c at full width: WHISPER_DECODE_STEPS greedy steps of BATCH
    rows over an encoded memory (the first call captures the step), then
    the same steps again on the same state, its caches and position reset:
    replays only, timed; 24 flash launches a step, tokens in the vocabulary
    and equal in both runs."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DecodeEngine

    free_device_memory(dev)
    cfg = get_config(WHISPER)
    engine = DecodeEngine(params=M.init_params(torch.Generator(device=dev).manual_seed(0),
                                               cfg, dev), cfg=cfg)
    frames = SyntheticTokens(cfg, DataConfig(batch_size=BATCH, seq_len=8, seed=0),
                             device=dev).batch(0)["frames"]
    steps = WHISPER_DECODE_STEPS
    first, state = encoded_greedy(engine, frames, steps, WHISPER_DECODE_SLOTS)
    for leaf in (state.k, state.v, state.index):
        leaf.zero_()
    reset(counters)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tokens, _ = engine.greedy(torch.zeros((BATCH,), dtype=torch.int32, device=dev), state,
                              steps)
    tokens = tokens.cpu()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    want = {**dict.fromkeys(KERNELS, 0), "flash_attention": WHISPER_LAYERS * steps}
    peak = torch.cuda.max_memory_allocated(dev)
    row = {"steps": steps, "rows": BATCH, "step_ms": wall / steps * 1e3,
           "tokens_per_s": BATCH * steps / wall, "launches": launches,
           "programs": engine.programs.stats(), "peak_gib": peak / 2**30}
    print(f"phase 21c ({card}): {WHISPER} greedy over an encoded memory, {BATCH} rows x "
          f"{steps} steps, graphed: {row['step_ms']:.3f} ms a step, "
          f"{row['tokens_per_s']:.1f} tokens/s, launches {launches}, programs "
          f"{row['programs']}, peak memory {row['peak_gib']:.3f} GiB, first row "
          f"{tokens[0, :8].tolist()}")
    if launches != want:
        raise SystemExit(f"{WHISPER} greedy: launches {launches}, expected {want}")
    if not (torch.equal(tokens, first) and int(tokens.min()) >= 0
            and int(tokens.max()) < VOCAB[WHISPER]):
        raise SystemExit(f"{WHISPER} greedy: tokens out of the vocabulary or differ between "
                         f"two runs of the same steps: {first[0]} / {tokens[0]}")
    return row


def greedy_against_cpu(dev, counters, cfg, on_card, params) -> dict:
    """Phase 21c at 2 + 2 layers: the encoded memory card vs CPU (relative
    L2 <= 1e-4), then 8 greedy steps over it on each side, tokens equal;
    the card launches flash 2 (the encoder) + 2 a step (cross-attention)."""
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.serving.engine import DecodeEngine

    steps = 8
    frames = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=8, seed=0),
                             device="cpu").batch(0)["frames"]
    before = {k: c.launches for k, c in counters.items()}
    card_tokens, card_state = encoded_greedy(DecodeEngine(params=on_card, cfg=cfg), frames,
                                             steps, 16)
    ran = launched(counters, before)
    cpu_tokens, cpu_state = encoded_greedy(DecodeEngine(params=params, cfg=cfg), frames,
                                           steps, 16)
    rel = relative_l2(card_state.memory.cpu(), cpu_state.memory)
    want = {**dict.fromkeys(KERNELS, 0), "flash_attention": cfg.n_encoder_layers
            + cfg.n_layers * steps}
    print(f"decode path, {cfg.name} (2 + 2 layers, f32), card vs CPU: encoded memory "
          f"relative L2 {rel:.3e} (limit 1e-4), {steps} greedy steps, tokens equal: "
          f"{torch.equal(card_tokens, cpu_tokens)}, launches {ran}")
    if ran != want or not rel <= 1e-4:
        raise SystemExit(f"{cfg.name} greedy card vs CPU: launches {ran} (expected {want}), "
                         f"memory relative L2 {rel}")
    if not torch.equal(card_tokens, cpu_tokens):
        raise SystemExit(f"{cfg.name} greedy card vs CPU: tokens differ ({card_tokens} vs "
                         f"{cpu_tokens})")
    return {"memory_rel_l2": rel, "tokens_equal": True, "launches": ran}


def whisper_paths(dev, counters, card: str, graphs: dict) -> dict:
    """Phases 21-21c: whisper-medium's flow at full width and depth with
    phase 15's case (21; each request's launches exact), card vs CPU at
    2 + 2 layers (21b) and greedy decode over an encoded memory (21c)."""
    zero = dict.fromkeys(KERNELS, 0)
    per_request = {**zero, "ns_update": NFE, "flash_attention": 3 * WHISPER_LAYERS * NFE}
    out, wall, phases = {}, {}, {}
    t0 = time.perf_counter()
    with PerRequest(counters) as each:
        phases["21"], out["flow"] = flow_path(
            dev, counters, WHISPER, {k: v * REQUESTS for k, v in per_request.items()}, graphs,
            lm=True)
    if each.runs[:REQUESTS] != [per_request] * REQUESTS:
        raise SystemExit(f"{WHISPER} flow: launches a request {each.runs[:REQUESTS]}, "
                         f"expected {per_request}")
    wall["21+15"] = time.perf_counter() - t0
    print(f"phase 21 ({card}): {WHISPER} flow request ms "
          f"{[round(x, 3) for x in out['flow']['request_ms']]}, capture "
          f"{out['flow']['capture_ms']:.1f} ms, peak memory {out['flow']['peak_gib']:.3f} GiB, "
          f"launches a request {per_request}")
    t0 = time.perf_counter()
    cfg, on_card, params = card_drawn_model(dev, WHISPER)
    before = {name: c.launches for name, c in counters.items()}
    out["flow_rel_l2"] = whole_path_against_cpu(
        dev, counters, cfg, params, {**zero, "ns_update": 4, "flash_attention": 3 * 2 * 4},
        card_params=on_card)
    phases["21b"] = launched(counters, before)
    out["decode_against_cpu"] = greedy_against_cpu(dev, counters, cfg, on_card, params)
    lm_against_cpu(dev, counters, cfg, params, on_card)
    del on_card, params
    wall["21b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["decode"] = whisper_greedy(dev, counters, card)
    phases["21c"] = out["decode"]["launches"]
    wall["21c"] = time.perf_counter() - t0
    out["wall_s"], out["phase_launches"] = wall, phases
    return out


def internvl_paths(dev, counters, card: str, graphs: dict) -> dict:
    """Phases 22-22b: internvl2-26b at full width and depth, flow
    (INTERNVL_REQUESTS requests) and decode through the paged kernel at G 6
    with phase 15's step case; then flow and decode card vs CPU at 2 layers."""
    zero = dict.fromkeys(KERNELS, 0)
    out, wall, phases = {}, {}, {}
    t0 = time.perf_counter()
    phases["22"], out["flow"] = flow_path(
        dev, counters, INTERNVL,
        {**zero, "ns_update": NFE * INTERNVL_REQUESTS,
         "flash_attention": INTERNVL_LAYERS * NFE * INTERNVL_REQUESTS},
        graphs, requests=INTERNVL_REQUESTS, programs=False, lm=True)
    wall["22"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["decode"] = {}
    phases["22 decode"] = decode_path(dev, counters, INTERNVL_DECODE_ARGS,
                                      {"paged_attention": INTERNVL_LAYERS}, graphs,
                                      runs=out["decode"])
    wall["22 decode+15"] = time.perf_counter() - t0
    print(f"phase 22 ({card}): {INTERNVL} full width and depth, flow request ms "
          f"{[round(x, 3) for x in out['flow']['request_ms']]} (capture "
          f"{out['flow']['capture_ms']:.1f} ms), peak memory {out['flow']['peak_gib']:.3f} "
          f"GiB; decode {out['decode']['tokens_per_s']:.1f} tokens/s, engine call ms mean "
          f"{out['decode']['call_ms_mean']:.3f}, peak {out['decode']['peak_gib']:.3f} GiB")
    t0 = time.perf_counter()
    cfg, on_card, params = card_drawn_model(dev, INTERNVL, INTERNVL_CHECK_LAYERS)
    before = {name: c.launches for name, c in counters.items()}
    out["flow_rel_l2"] = whole_path_against_cpu(
        dev, counters, cfg, params,
        {**zero, "ns_update": 4, "flash_attention": INTERNVL_CHECK_LAYERS * 4},
        card_params=on_card)
    del on_card
    out["decode_rel_l2"] = decode_against_cpu(dev, counters, cfg, params,
                                              dict(page_size=16, paged_kernel=True),
                                              {"paged_attention": INTERNVL_CHECK_LAYERS})
    phases["22b"] = launched(counters, before)
    lm_against_cpu(dev, counters, cfg, params)
    window_against_cpu(dev, counters, cfg, params)
    del params
    wall["22b"] = time.perf_counter() - t0
    out["wall_s"], out["phase_launches"] = wall, phases
    return out


def trainer_flash_cases(dev) -> dict:
    """Phase 3d: the flash forward with its log-sum-exp and the flash
    backward at the trainer's shape (batch TRAIN_BATCH, L TRAIN_SEQ, 32 / 4
    heads of 128, bf16, causal), each against its plain version on the same
    card inputs (the output under FLASH_BF16, the lse under 4 TOL (1 +
    |lse|), dq, dk, dv under FLASH_BWD_BF16), timed beside the plain version
    and the PyTorch call (SDPA's forward; torch autograd of SDPA's backward),
    with each one's bound. Returns {"flash_attention": row,
    "flash_attention_bwd": row}."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref,
        attention_lse_ref,
        attention_ref,
    )

    g = torch.Generator(device=dev).manual_seed(24)
    B, H, KV, L, hd, dtype = TRAIN_BATCH, 32, 4, TRAIN_SEQ, 128, torch.bfloat16
    q, do = (torch.randn((B, L, H, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
             for _ in "qo")
    k, v = (torch.randn((B, L, KV, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
            for _ in "kv")
    shape = f"B={B} H={H} KV={KV} L={L} hd={hd} bfloat16 causal"
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    fwd_err = check_flash_bf16(f"flash_attention [{shape}] with lse", o,
                               attention_ref(q, k, v, causal=True))
    lse_ref = attention_lse_ref(q, k, causal=True)
    lse_ratio = float(((lse - lse_ref).abs()
                       / (4 * TOL[torch.float32] * (1 + lse_ref.abs()))).max())
    if not lse_ratio <= 1:
        raise SystemExit(f"flash_attention [{shape}]: lse vs plain at {lse_ratio:.3f} of the "
                         "limit (4 TOL (1 + |lse|))")
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    ref = attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    bwd_err, bwd_ratio = 0.0, 0.0
    for what, x, r in zip(("dq", "dk", "dv"), got, ref):
        e = flash_bwd_errors(x, r)
        if not (bool(torch.isfinite(x.float()).all()) and flash_bwd_passes(e)):
            raise SystemExit(f"flash_attention_bwd [{shape}] {what}: kernel vs plain outside "
                             f"the bf16 limit {FLASH_BWD_BF16}: {e}")
        bwd_err, bwd_ratio = max(bwd_err, e["max_abs"]), max(bwd_ratio, e["ratio"])
    pairs, size = L * (L + 1) // 2, q.element_size()
    io = (2 * B * H * L * hd + 2 * B * KV * L * hd) * size
    f_ms, f_by = bound(io + B * H * L * 4, 4 * hd * pairs * B * H, dtype)
    b_ms, b_by = bound(2 * io + B * H * L * 4, 10 * hd * pairs * B * H, dtype)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    rows = {
        "flash_attention": dict(
            shape=shape + " (with lse)", max_abs_err=fwd_err, lse_limit_ratio=lse_ratio,
            ms=time_ms(lambda: flash_attention(q, k, v, causal=True, return_lse=True)),
            plain_ms=time_ms(lambda: (attention_ref(q, k, v, causal=True),
                                      attention_lse_ref(q, k, causal=True))),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)),
            bound_ms=f_ms, bound_by=f_by),
        "flash_attention_bwd": dict(
            shape=shape, max_abs_err=bwd_err, limit_ratio=bwd_ratio,
            ms=time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True)),
            plain_ms=time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do, causal=True)),
            library_ms=time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                           retain_graph=True)),
            bound_ms=b_ms, bound_by=b_by)}
    for name, r in rows.items():
        print(f"phase 3d {name} [{r['shape']}]: err {r['max_abs_err']:.3e}, kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f", lse at {lse_ratio:.4f} of the limit" if name == "flash_attention"
                 else f", bf16 limit ratio {bwd_ratio:.4f} (library: torch autograd of "
                      "SDPA's backward)"))
    return rows


def train_args(steps: int, layers: int, *extra) -> list:
    """``launch.train.main``'s flags for yi-6b at full width on the card."""
    return ["--arch", "yi-6b", "--steps", str(steps), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--layers", str(layers), *extra]


class ProfiledStep:
    """Runs the ``n``-th ``Trainer.step`` call (0-based) inside the block
    under ``busy_share`` (torch.profiler), keeping its result in ``busy``."""

    def __init__(self, dev, n: int):
        from repro_torch.launch import train

        self.cls, self.dev, self.n, self.calls, self.busy = train.Trainer, dev, n, 0, None

    def __enter__(self):
        self.inner = self.cls.step

        def step(trainer, *args):
            self.calls += 1
            if self.calls - 1 != self.n:
                return self.inner(trainer, *args)
            box = []
            self.busy = busy_share(self.dev, lambda: box.append(self.inner(trainer, *args)))
            return box[0]

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.inner


def trainer_path(dev, counters, card: str) -> dict:
    """Phase 24a: ``launch.train.main`` trains yi-6b at full width and
    TRAIN_LAYERS layers, TRAIN_STEPS steps of batch TRAIN_BATCH x TRAIN_SEQ,
    bf16 weights drawn on the card, graphed (one program, captured at step 0
    and replayed): flash forward (with lse) and backward exactly TRAIN_LAYERS
    a step each and nothing else, finite losses; the last step under
    torch.profiler for the card's busy share."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    free_device_memory(dev)
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_LAYERS)
    state_bytes = train.train_state_bytes(cfg)
    print(f"phase 24a: yi-6b at {TRAIN_LAYERS} layers, {state_bytes / 1e9:.3f} GB of bf16 "
          f"params and gradients and f32 Adam moments; allocated before the run "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB, free "
          f"{torch.cuda.mem_get_info(dev)[0] / 2**30:.3f} GiB")
    reset(counters)
    t0 = time.perf_counter()
    with ProfiledStep(dev, TRAIN_STEPS - 1) as profiled:
        run = train.main(train_args(TRAIN_STEPS, TRAIN_LAYERS))
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    want = {**dict.fromkeys(KERNELS, 0), "flash_attention": TRAIN_LAYERS * TRAIN_STEPS,
            "flash_attention_bwd": TRAIN_LAYERS * TRAIN_STEPS}
    if launches != want:
        raise SystemExit(f"trainer launch counts {launches}, expected {want}")
    stats = run.trainer.programs.stats()
    if (stats["programs"], stats["replays"]) != (1, TRAIN_STEPS - 1):
        raise SystemExit(f"trainer programs {stats}, expected one captured and "
                         f"{TRAIN_STEPS - 1} replays")
    if len(run.losses) != TRAIN_STEPS or not all(np.isfinite(run.losses)):
        raise SystemExit(f"trainer losses {run.losses}")
    peak = torch.cuda.max_memory_allocated(dev)
    steady = run.step_ms[1:-1]          # the last step ran under the profiler
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (float(np.median(steady)) / 1e3)
    busy = profiled.busy
    print(f"phase 24a ({card}): yi-6b full width, {TRAIN_LAYERS} layers, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps: step 0 (warm-up and capture) "
          f"{run.step_ms[0]:.1f} ms, steps 1-{TRAIN_STEPS - 1} "
          f"{[round(x, 1) for x in run.step_ms[1:]]} ms (the last under torch.profiler), "
          f"median of 1-{TRAIN_STEPS - 2} {np.median(steady):.1f} ms, {tokens_s:.1f} tokens/s; "
          f"capture {stats['capture_ms']:.1f} ms; busy {busy['busy_share']:.3f} of the "
          f"profiled step ({busy['busy_ms']:.1f} of {busy['wall_ms']:.1f} ms, "
          f"{busy['kernels']} kernels); peak {peak / 2**30:.3f} GiB; launches a step "
          f"flash {launches['flash_attention'] // TRAIN_STEPS}, backward "
          f"{launches['flash_attention_bwd'] // TRAIN_STEPS}; losses "
          f"{[round(x, 5) for x in run.losses]}; main() wall {wall:.1f} s")
    out = {"layers": TRAIN_LAYERS, "state_gb": state_bytes / 1e9, "step_ms": run.step_ms,
           "median_step_ms": float(np.median(steady)), "tokens_per_s": tokens_s,
           "capture_ms": stats["capture_ms"], "busy": busy, "peak_gib": peak / 2**30,
           "losses": run.losses, "launches": launches, "wall_s": wall}
    del run
    return out


def _tree_equal(a, b) -> list:
    from repro_torch.optim.adam import tree_leaves

    return [bool(torch.equal(x, y)) for x, y in zip(tree_leaves(a), tree_leaves(b))]


def trainer_graphed_against_eager(dev, counters) -> dict:
    """Phase 24b: the trainer at full width and TRAIN_CHECK_LAYERS layers,
    TRAIN_CHECK_STEPS steps graphed and then the same run under
    ``programs.disabled()``: params, mu, nu, step and the losses equal to
    the bit, the launch counts equal."""
    from repro_torch.launch import train
    from repro_torch.serving import programs

    free_device_memory(dev)
    runs, counts = {}, {}
    for side in ("graphed", "eager"):
        before = {name: c.launches for name, c in counters.items()}
        with (programs.disabled() if side == "eager" else contextlib.nullcontext()):
            runs[side] = train.main(train_args(TRAIN_CHECK_STEPS, TRAIN_CHECK_LAYERS))
        counts[side] = launched(counters, before)
    g, e = runs["graphed"], runs["eager"]
    equal = {"params": _tree_equal(g.params, e.params), "mu": _tree_equal(g.opt.mu, e.opt.mu),
             "nu": _tree_equal(g.opt.nu, e.opt.nu),
             "step": [int(g.opt.step) == int(e.opt.step) == TRAIN_CHECK_STEPS],
             "losses": [a == b for a, b in zip(g.losses, e.losses)]}
    programs_each = {side: len(r.trainer.programs) for side, r in runs.items()}
    print(f"phase 24b: trainer graphed against eager at {TRAIN_CHECK_LAYERS} layers, "
          f"{TRAIN_CHECK_STEPS} steps: equal to the bit {equal}, launches {counts}, "
          f"programs {programs_each}, step ms graphed {[round(x, 1) for x in g.step_ms]} / "
          f"eager {[round(x, 1) for x in e.step_ms]}")
    if not (all(all(v) for v in equal.values()) and counts["graphed"] == counts["eager"]
            and programs_each == {"graphed": 1, "eager": 0}):
        raise SystemExit("phase 24b: the graphed trainer differs from the eager one")
    out = {"equal": {k: all(v) for k, v in equal.items()}, "launches": counts["graphed"],
           "step_ms": {"graphed": g.step_ms, "eager": e.step_ms}, "losses": g.losses}
    del runs, g, e
    return out


def trainer_against_cpu(dev, counters) -> dict:
    """Phase 24c: ``launch.train.Trainer`` on the card (kernels) against the
    CPU (plain versions): yi-6b's width at TRAIN_CHECK_LAYERS layers, f32
    weights drawn on the card and copied, TF32 off, TRAIN_CHECK_STEPS steps
    of TRAIN_BATCH x TRAIN_SEQ on the same tokens and noise
    (numpy-seeded generator on the host): each loss within 1e-4 relative,
    the params after the last step within 1e-4 relative L2 (over all
    leaves). The card's model is freed before the CPU's steps run."""
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.launch.train import Trainer
    from repro_torch.models.model import CFMNoise, draw_cfm_noise
    from repro_torch.optim.adam import tree_leaves

    cfg, on_card, on_cpu = card_drawn_model(dev, "yi-6b", TRAIN_CHECK_LAYERS)
    sched = get_scheduler("fm_ot")
    data = SyntheticTokens(cfg, DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                           seed=0), device="cpu")
    gen = torch.Generator().manual_seed(0)
    inputs = [(data.batch(step), draw_cfm_noise(gen, TRAIN_BATCH, TRAIN_SEQ,
                                                cfg.latent_dim))
              for step in range(TRAIN_CHECK_STEPS)]
    card = Trainer(cfg, sched, on_card, steps=TRAIN_CHECK_STEPS, lr=3e-4, device=dev)
    before = {name: c.launches for name, c in counters.items()}
    losses = {"card": [float(card.step({k: v.to(dev) for k, v in batch.items()},
                                       CFMNoise(*(x.to(dev) for x in noise))))
                       for batch, noise in inputs]}
    launches = launched(counters, before)
    card_params = [t.cpu() for t in tree_leaves(on_card)]
    del card, on_card
    free_device_memory(dev)
    t0 = time.perf_counter()
    cpu = Trainer(cfg, sched, on_cpu, steps=TRAIN_CHECK_STEPS, lr=3e-4, device="cpu")
    losses["cpu"] = [float(cpu.step(batch, noise)) for batch, noise in inputs]
    cpu_s = time.perf_counter() - t0
    num = den = 0.0
    for a, b in zip(card_params, tree_leaves(on_cpu)):   # in f64, 2^20 elements at a time
        for x, y in zip(a.reshape(-1).split(1 << 20), b.reshape(-1).split(1 << 20)):
            y = y.double()
            num += float(torch.sum((x.double() - y) ** 2))
            den += float(torch.sum(y ** 2))
    params_rel = (num / den) ** 0.5
    del cpu, on_cpu, card_params
    want = {**dict.fromkeys(KERNELS, 0),
            "flash_attention": TRAIN_CHECK_LAYERS * TRAIN_CHECK_STEPS,
            "flash_attention_bwd": TRAIN_CHECK_LAYERS * TRAIN_CHECK_STEPS}
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"])]
    print(f"phase 24c: trainer card vs CPU ({TRAIN_CHECK_LAYERS} layers, f32, "
          f"{TRAIN_CHECK_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}): losses card "
          f"{losses['card']} cpu {losses['cpu']}, relative {[f'{x:.3e}' for x in loss_rel]} "
          f"(limit 1e-4); params after step {TRAIN_CHECK_STEPS} relative L2 {params_rel:.3e} "
          f"(limit 1e-4); card launches {launches}; the CPU's steps {cpu_s:.1f} s")
    if launches != want:
        raise SystemExit(f"phase 24c: card launches {launches}, expected {want}")
    if not (max(loss_rel) <= 1e-4 and params_rel <= 1e-4):
        raise SystemExit("phase 24c: the trainer on the card differs from the CPU's")
    return {"loss_rel": loss_rel, "params_rel_l2": params_rel, "launches": launches,
            "losses": losses, "cpu_s": cpu_s}


def trainer_checkpoint(dev, counters) -> dict:
    """Phase 24d: the trainer at full width and TRAIN_CHECK_LAYERS layers
    checkpoints its last step (2) under TRAIN_CKPT_DIR; a second ``train``
    call resumes from it (params only, Adam from zero: its one step runs at
    rate 0, so the params stay the checkpoint's to the bit); then
    ``serve.main --ckpt`` at the same depth (``launcher_depth``) serves one
    phase-4 request whose latents equal, to the bit, a ``FlowSampler`` on
    the trained params with the served solver and the same x0 (seed 1000)."""
    import shutil

    from repro_torch.checkpoint import checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.launch import serve, train
    from repro_torch.serving.engine import FlowSampler

    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    free_device_memory(dev)
    reset(counters)
    t0 = time.perf_counter()
    ckpt = ["--ckpt-dir", str(TRAIN_CKPT_DIR), "--ckpt-every", "2"]
    first = train.main(train_args(2, TRAIN_CHECK_LAYERS, *ckpt))
    saved_s = time.perf_counter() - t0
    path = checkpointer.step_path(str(TRAIN_CKPT_DIR), 2)
    if checkpointer.latest_step(str(TRAIN_CKPT_DIR)) != 2:
        raise SystemExit(f"phase 24d: no checkpoint at step 2 in {TRAIN_CKPT_DIR}")
    t1 = time.perf_counter()
    resumed = train.main(train_args(3, TRAIN_CHECK_LAYERS, *ckpt))
    resumed_s = time.perf_counter() - t1
    kept = _tree_equal(first.params, resumed.params)
    if not (resumed.start == 2 and len(resumed.losses) == 1 and int(resumed.opt.step) == 1
            and all(kept)):
        raise SystemExit(f"phase 24d: resume start {resumed.start}, losses {resumed.losses}, "
                         f"Adam step {int(resumed.opt.step)}, params kept {kept}")
    del resumed
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_CHECK_LAYERS)
    t2 = time.perf_counter()
    with launcher_depth(TRAIN_CHECK_LAYERS):
        served = serve.main(["--arch", "yi-6b", "--mode", "flow", "--full", "--nfe", str(NFE),
                             "--batch", str(BATCH), "--seq", str(SEQ), "--requests", "1",
                             "--bns-iters", "0", "--ckpt", path])
    served_s = time.perf_counter() - t2
    cond = SyntheticTokens(cfg, DataConfig(batch_size=BATCH, seq_len=SEQ, seed=0),
                           device=dev).batch(0)
    want = FlowSampler(params=first.params, cfg=cfg, sched=get_scheduler("fm_ot"),
                       solver=served.sampler.solver).sample(
        cond, torch.Generator(device=dev).manual_seed(1000))
    equal = bool(torch.equal(served[0].latents, want))
    launches = {name: c.launches for name, c in counters.items()}
    print(f"phase 24d: trainer checkpoint at step 2 ({path}, "
          f"{Path(path).stat().st_size / 1e9:.3f} GB) written in a {saved_s:.1f} s run, "
          f"resumed (start 2, Adam restarted, params kept to the bit) in {resumed_s:.1f} s, "
          f"served through --ckpt in {served_s:.1f} s: request ms "
          f"{round(served[0].ms, 3)}, latents equal to a FlowSampler on the trained params "
          f"{equal}; launches {launches}")
    if not equal:
        raise SystemExit("phase 24d: the served latents differ from the trained params' sampler")
    out = {"checkpoint_gb": Path(path).stat().st_size / 1e9, "saved_run_s": saved_s,
           "resumed_run_s": resumed_s, "served_s": served_s, "request_ms": served[0].ms,
           "latents_equal": equal, "launches": launches}
    del first, served
    return out
def launch_profiles(dev, card: str, default: dict) -> dict:
    """Phase 24e: phase 4's request (yi-6b at full width, NFE 8, batch 4,
    seq 1024) by ``python -m repro_torch.launch.serve --profile tuned`` in a
    subprocess (one re-exec with the allocator settings, tcmalloc preloaded
    where installed): it exits 0, serves the request and prints its re-exec
    line once. Prints its request ms and peak memory (read from the
    launcher's output) beside phase 4's first request under the default
    profile (``default``: flow_path's record, in this process), and whether
    tcmalloc was found; no claim either way."""
    free_device_memory(dev)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_TUNED_REEXEC", None)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-6b", "--mode",
           "flow", "--full", "--nfe", str(NFE), "--batch", str(BATCH), "--seq", str(SEQ),
           "--requests", "1", "--bns-iters", "0", "--profile", "tuned"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    text = proc.stdout
    request = re.search(r"request 0: sampled \(4, 1024\) in ([0-9.]+) ms", text)
    peak = re.search(r"peak device memory ([0-9.]+) GiB", text)
    reexecs = [line for line in text.splitlines() if line.startswith("re-exec under")]
    if proc.returncode != 0 or request is None or peak is None:
        raise SystemExit(f"phase 24e: exit {proc.returncode}\n{text[-3000:]}"
                         f"\n{proc.stderr[-3000:]}")
    if len(reexecs) != 1:
        raise SystemExit(f"phase 24e: re-exec lines {reexecs}")
    out = {"default": {"request_ms": default["request_ms"][0],
                       "peak_gib": default["peak_gib"]},
           "tuned": {"request_ms": float(request.group(1)), "peak_gib": float(peak.group(1)),
                     "wall_s": wall, "reexec": reexecs[0],
                     "tcmalloc": "LD_PRELOAD=" in reexecs[0]}}
    print(f"phase 24e ({card}): phase 4's first request, default profile (phase 4, this "
          f"process) {out['default']['request_ms']:.1f} ms, peak "
          f"{out['default']['peak_gib']:.3f} GiB; tuned (a subprocess) "
          f"{out['tuned']['request_ms']:.1f} ms, peak {out['tuned']['peak_gib']:.3f} GiB, "
          f"{wall:.1f} s, tcmalloc {'found' if out['tuned']['tcmalloc'] else 'not found'}, "
          f"re-exec once: {out['tuned']['reexec']!r}")
    return out


def trainer_paths(dev, counters, card: str, phase4: dict) -> dict:
    """Phases 24a-24e, each model freed before the next (``phase4``: phase
    4's flow_path record, 24e's default profile)."""
    out, wall, phases = {}, {}, {}
    for key, fn in (("24a", lambda: trainer_path(dev, counters, card)),
                    ("24b", lambda: trainer_graphed_against_eager(dev, counters)),
                    ("24c", lambda: trainer_against_cpu(dev, counters)),
                    ("24d", lambda: trainer_checkpoint(dev, counters)),
                    ("24e", lambda: launch_profiles(dev, card, phase4))):
        t0 = time.perf_counter()
        out[key] = fn()
        wall[key] = time.perf_counter() - t0
        if "launches" in out[key]:
            phases[key] = out[key].pop("launches")
    free_device_memory(dev)
    out["wall_s"], out["phase_launches"] = wall, phases
    return out


def family_launches(cfg, no_grad: int, grad: int, *, training: bool = False) -> dict:
    """Kernel launches of ``no_grad`` velocity calls of ``cfg``'s model under
    no_grad and ``grad`` differentiated ones: with ``training`` (the
    backbone trainer: weights require grad, no recomputation) every
    attention and recurrence runs forward once and backward once; otherwise
    (distillation: only x and theta carry gradients, each layer recomputed in
    the backward) a differentiated call runs each layer forward twice and
    backward once, except whisper's encoder, whose frames and weights carry
    no gradient (one plain forward a call), and its cross-attention's
    backward is the dq pass alone (one launch all the same). The dense, moe
    and vlm families run one attention a layer (vlm's decoder over the
    patches and the tokens)."""
    N, twice = cfg.n_layers, 1 if training else 2
    out = dict.fromkeys(KERNELS, 0)
    if cfg.family == "ssm":
        out.update(gla_scan=N * (no_grad + twice * grad), gla_scan_bwd=N * grad)
    elif cfg.family == "hybrid":
        sites = N // cfg.hybrid_attn_every
        out.update(gla_scan=N * (no_grad + twice * grad), gla_scan_bwd=N * grad,
                   flash_attention=sites * (no_grad + twice * grad),
                   flash_attention_bwd=sites * grad)
    elif cfg.family == "encdec":
        E, D = cfg.n_encoder_layers, 2 * cfg.n_layers      # decoder: self and cross
        if training:
            out.update(flash_attention=(E + D) * (no_grad + grad),
                       flash_attention_bwd=(E + D) * grad)
        else:
            out.update(flash_attention=(E + D) * no_grad + (E + 2 * D) * grad,
                       flash_attention_bwd=D * grad)
    elif cfg.family in ("dense", "moe", "vlm"):
        out.update(flash_attention=N * (no_grad + twice * grad), flash_attention_bwd=N * grad)
    else:
        raise ValueError(f"no launch formula for the {cfg.family} family")
    return out


def family_distill_path(dev, counters, card: str, arch: str, trains: dict) -> dict:
    """Phases 26-28, 32 and 33: serve.main distils a BNS solver for ``arch``
    at full width and FAMILY_DISTILL_DEPTH[arch] layers (phase 12's flags with
    FAMILY_DISTILL_ITERS iterations and ``--solver-artifact`` under
    build/chip_smoke/<arch>/, emptied first), serves its requests, and must launch
    what the module docstring's formula says; the distilled val PSNR above
    the initial (Euler) solver's. zamba2-2.7b's and qwen3-moe-30b-a3b's then
    run phase 16's BNS case (graphed against eager) on their weights and
    pairs, into ``trains``."""
    from repro_torch.launch import serve

    layers, enc = FAMILY_DISTILL_DEPTH[arch]
    phase = FAMILY_PHASE[arch]
    # a directory of its own: the launcher's zoo scans the artifact's directory
    # and would serve another arch's solver of the same spec from it
    path = ROOT / "build" / "chip_smoke" / arch / f"bns_nfe{NFE}.msgpack"
    shutil.rmtree(path.parent, ignore_errors=True)
    path.parent.mkdir(parents=True)
    free_device_memory(dev)
    reset(counters)
    t0 = time.perf_counter()
    with launcher_depth(layers, enc):
        served = serve.main(["--arch", arch, "--mode", "flow", "--full", "--nfe", str(NFE),
                             "--batch", str(BATCH), "--seq", str(SEQ), "--bns-iters",
                             str(FAMILY_DISTILL_ITERS), "--requests", str(DISTILL_REQUESTS),
                             "--solver-artifact", str(path)])
    wall = time.perf_counter() - t0
    d, cfg = served.distillation, served.sampler.cfg
    K, R = FAMILY_DISTILL_ITERS, sum(d.rk45[part][0] for part in ("train", "val"))
    no_grad = R + NFE + NFE + DISTILL_REQUESTS * NFE
    want = {**family_launches(cfg, no_grad, NFE * K),
            "ns_update": NFE * (2 + DISTILL_REQUESTS + K), "ns_update_bwd": NFE * K}
    launches = {name: c.launches for name, c in counters.items()}
    if launches != want:
        raise SystemExit(f"phase {phase} ({arch}): distillation launch counts {launches}, "
                         f"expected {want} (RK45 evaluations {R})")
    losses = [h[1] for h in d.history]
    if not (d.history and all(np.isfinite(losses)) and np.isfinite(d.val_psnr)
            and np.isfinite(d.init_val_psnr)):
        raise SystemExit(f"phase {phase} ({arch}): non-finite loss or PSNR: {d.history}, "
                         f"init {d.init_val_psnr}")
    if not d.val_psnr > d.init_val_psnr:
        raise SystemExit(f"phase {phase} ({arch}): distilled val PSNR {d.val_psnr} not above "
                         f"Euler's {d.init_val_psnr}")
    if served.zoo.distills != 1 or len(served) != DISTILL_REQUESTS or not all(
            s.latents.shape == (BATCH, SEQ, 64) and bool(torch.isfinite(s.latents).all())
            for s in served):
        raise SystemExit(f"phase {phase} ({arch}): zoo {served.zoo}, bad requests")
    peak = torch.cuda.max_memory_allocated(dev)
    iter_ms = (d.train_seconds - d.init_val_seconds) / K * 1e3
    depth = f"{layers}" + ("" if enc is None else f" + {enc} encoder")
    print(f"phase {phase} ({card}): {arch} full width, {depth} layers, NFE {NFE}, batch "
          f"{BATCH}, seq {SEQ}: RK45 train nfe/accepted/rejected {d.rk45['train']}, val "
          f"{d.rk45['val']} ({d.rk45_seconds:.3f} s, step program {d.rk45_programs}); val "
          f"PSNR Euler {d.init_val_psnr:.4f} dB -> distilled {d.val_psnr:.4f} dB after {K} "
          f"iterations (losses {[round(x, 5) for x in losses]}); ~{iter_ms:.1f} ms an "
          f"iteration (each {[round(x * 1e3, 1) for x in d.iteration_seconds]}); request ms "
          f"{[round(x.ms, 3) for x in served]}; launches {launches} (the formula's); peak "
          f"memory {peak / 2**30:.3f} GiB; main() wall {wall:.3f} s; training programs "
          f"{d.programs}")
    if arch in ("zamba2-2.7b", MOE_ARCH):
        label = f"bns, {arch} at {layers} layers, seq {SEQ}, euler NFE {NFE}"
        trains[label] = train_programs(dev, counters, label, train_loop(
            "bns", served_field(dev, served.sampler, SEQ), d.pairs))
    out = {"layers": layers, "encoder_layers": enc, "rk45": d.rk45,
           "rk45_s": d.rk45_seconds, "init_val_psnr": d.init_val_psnr,
           "val_psnr": d.val_psnr, "iteration_ms": iter_ms,
           "each_iteration_ms": [x * 1e3 for x in d.iteration_seconds],
           "request_ms": [x.ms for x in served], "peak_gib": peak / 2**30, "wall_s": wall,
           "launches": launches}
    del served, d
    return out


def family_gradient_against_cpu(dev, counters, arch: str, phase: str) -> dict:
    """Phases 26b-28b, 32b, 33b and 34: phase 13's gradient for ``arch`` at
    FAMILY_GRAD_DEPTH layers (each stack of whisper's; zamba2's one
    shared-attention site over its two Mamba2 layers), f32, drawn on the
    card, launches as the formula says for 4 differentiated calls: the loss
    and each gradient card vs CPU within relative L2 1e-4. A gradient that
    f32 cannot hold to that (the CPU's own f32 result farther than
    GRAD_F32_FLOOR from the same computation in f64 on the CPU) is held
    instead to the f64 result: the card's distance from it at most
    GRAD_F32_FACTOR times the CPU's. An MoE model's expert choices are
    compared first, every router call of both sides (phase 18b's rule; each
    layer routes twice a differentiated call, once more in its recomputation):
    a flip prints both sides' probabilities and fails."""
    from repro_torch.optim.adam import tree_map

    cfg, on_card, on_cpu = card_drawn_model(dev, arch, FAMILY_GRAD_DEPTH[arch])
    want = {**family_launches(cfg, 0, 4), "ns_update": 4, "ns_update_bwd": 4}
    label = f"phase {phase}, {arch} {FAMILY_GRAD_DEPTH[arch]} layers f32"
    routed = cfg.family == "moe"
    router = RouterCalls()
    with router if routed else contextlib.nullcontext():
        fields, theta0, pairs, grads, rels = bns_gradient_against_cpu(
            dev, counters, cfg, on_cpu, label, want, card_params=on_card, check=False,
            on_side=lambda where: setattr(router, "side", where))
    out = {"relative_l2": rels, "launches": want}
    if routed:
        calls, flips = len(router.calls["cpu"]), router.flips(cfg)
        print(f"gradient, {label}: expert choices card vs CPU, {calls} router calls "
              f"({cfg.n_layers} layers x 4 steps x 2, the recomputation included) of "
              f"{router.calls['cpu'][0][1].shape[0]} tokens x top {cfg.moe.top_k}, "
              f"{len(flips)} differ" + ("; " + " | ".join(flips) if flips else ""))
        if flips or len(router.calls["card"]) != calls or calls != 8 * cfg.n_layers:
            raise SystemExit(f"{label}: expert choices differ between the card and the "
                             f"CPU ({len(router.calls['card'])} and {calls} router calls): "
                             f"{flips}")
        out["router_calls"] = calls
    if max(rels) > 1e-4:
        from repro_torch.core import bns, ns_solver
        from repro_torch.core.schedulers import get_scheduler
        from repro_torch.data.synthetic import DataConfig, SyntheticTokens
        from repro_torch.models import model as M

        batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                                device="cpu").batch(0)
        field = M.velocity_field(tree_map(lambda t: t.double(), on_cpu),
                                 dataclasses.replace(cfg, dtype="float64"),
                                 get_scheduler("fm_ot"), batch, remat=True)
        th = ns_solver.BNSParams(*(p.double().requires_grad_(True) for p in theta0))
        exact = torch.autograd.grad(
            bns._loss_fn(bns.ns_sampler(field), th, *(x.double() for x in pairs)), list(th))
        cpu_err, card_err = ([relative_l2(g.double(), e) for g, e in zip(grads[side], exact)]
                             for side in ("cpu", "card"))
        ok = [r <= 1e-4 or (c_cpu > GRAD_F32_FLOOR and c_card <= GRAD_F32_FACTOR * c_cpu)
              for r, c_cpu, c_card in zip(rels[1:], cpu_err, card_err)]
        print(f"gradient, {label}: against the CPU's f64 gradient, relative L2 CPU f32 "
              f"{[f'{x:.3e}' for x in cpu_err]}, card {[f'{x:.3e}' for x in card_err]}; "
              f"held (card vs CPU <= 1e-4, or the CPU f32 past {GRAD_F32_FLOOR:.1e} from f64 "
              f"and the card within {GRAD_F32_FACTOR} x of it) {ok}")
        out.update(cpu_f32_vs_f64=cpu_err, card_vs_f64=card_err)
        if not (rels[0] <= 1e-4 and all(ok)):
            raise SystemExit(f"gradient card vs CPU [{label}]: relative L2 {rels}, against "
                             f"f64 CPU {cpu_err} / card {card_err}")
    del on_card, on_cpu, fields
    return out


def family_trainer(dev, counters, card: str, arch: str) -> dict:
    """Phases 29a-c, 32c and 33c: ``launch.train.main`` trains ``arch`` at full width and
    FAMILY_TRAIN_DEPTH[arch] layers, FAMILY_TRAIN_STEPS steps of TRAIN_BATCH
    x TRAIN_SEQ, graphed and then under ``programs.disabled()``: params,
    Adam's moments and step and the losses equal to the bit, launches equal
    and as the formula says; ms a step and peak memory printed."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.serving import programs

    layers, enc = FAMILY_TRAIN_DEPTH[arch]
    runs, counts, peaks = {}, {}, {}
    for side in ("graphed", "eager"):
        free_device_memory(dev)
        before = {name: c.launches for name, c in counters.items()}
        with launcher_depth(layers, enc), (programs.disabled() if side == "eager"
                                           else contextlib.nullcontext()):
            runs[side] = train.main(["--arch", arch, "--steps", str(FAMILY_TRAIN_STEPS),
                                     "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)])
        counts[side] = launched(counters, before)
        peaks[side] = torch.cuda.max_memory_allocated(dev) / 2**30
    g, e = runs["graphed"], runs["eager"]
    equal = {"params": _tree_equal(g.params, e.params), "mu": _tree_equal(g.opt.mu, e.opt.mu),
             "nu": _tree_equal(g.opt.nu, e.opt.nu),
             "step": [int(g.opt.step) == int(e.opt.step) == FAMILY_TRAIN_STEPS],
             "losses": [a == b for a, b in zip(g.losses, e.losses)]}
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              **({} if enc is None else {"n_encoder_layers": enc}))
    want = family_launches(cfg, 0, FAMILY_TRAIN_STEPS, training=True)
    depth = f"{layers}" + ("" if enc is None else f" + {enc} encoder")
    row = {"layers": layers, "encoder_layers": enc, "step_ms": {"graphed": g.step_ms,
                                                                "eager": e.step_ms},
           "median_step_ms": float(np.median(g.step_ms[1:])), "peak_gib": peaks,
           "losses": g.losses, "equal": {k: all(v) for k, v in equal.items()},
           "launches": counts["graphed"]}
    print(f"phase {TRAIN_PHASE[arch]} [{arch}] ({card}): trainer at full width, {depth} layers, "
          f"{FAMILY_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: step ms graphed "
          f"{[round(x, 1) for x in g.step_ms]} (step 0 with the capture) / eager "
          f"{[round(x, 1) for x in e.step_ms]}, peak {peaks['graphed']:.3f} / "
          f"{peaks['eager']:.3f} GiB; equal to the bit {equal}; launches {counts}; losses "
          f"{[round(x, 5) for x in g.losses]}")
    if not (all(all(v) for v in equal.values()) and counts["graphed"] == counts["eager"] == want
            and len(g.trainer.programs) == 1 and all(np.isfinite(g.losses))):
        raise SystemExit(f"phase {TRAIN_PHASE[arch]} [{arch}]: the graphed trainer differs "
                         f"from the eager one or from the launch formula {want}")
    del runs, g, e
    return row


def family_paths(dev, counters, card: str, trains: dict, archs: tuple) -> dict:
    """Phases 26-29 (``archs`` PHASES_26_29) or 32-33 (PHASES_32_33): each
    arch distilled at full width, its gradient card vs CPU, then each
    trained; every model freed before the next."""
    out, wall = {}, {}
    for arch in archs:
        phase = FAMILY_PHASE[arch]
        t0 = time.perf_counter()
        out[phase] = family_distill_path(dev, counters, card, arch, trains)
        wall[phase] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out[phase + "b"] = family_gradient_against_cpu(dev, counters, arch, phase + "b")
        wall[phase + "b"] = time.perf_counter() - t0
    for arch in archs:
        key = TRAIN_PHASE[arch]
        t0 = time.perf_counter()
        out[key] = family_trainer(dev, counters, card, arch)
        wall[key] = time.perf_counter() - t0
    free_device_memory(dev)
    out["wall_s"] = wall
    return out


def moe_dispatch_backward_bits(dev, card: str) -> dict:
    """Phase 32a: one MoE layer of qwen3-moe-30b-a3b at full width (128
    experts of 768, top 8, d_model 2048), batch BATCH x SEQ, in bf16 and
    f32: the backward twice on the same x and output gradient, x.grad's bits
    compared, through the dispatch gather the port runs (``moe._Dispatch``,
    a gather in the backward) and through autograd of ``index_select``
    (``index_add_``'s float atomics in the backward, the form before it);
    the two forms' gradients against each other, and each form's forward and
    backward ms (CUDA events, 10 after a warm-up). The port's form must be
    bit-equal; the other's result is printed, whichever way it goes."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(MOE_ARCH)
    inner = moe._Dispatch.apply

    def index_select(x2d, fill, slot):
        zero = torch.zeros((1, x2d.shape[1]), dtype=x2d.dtype, device=x2d.device)
        return torch.cat([x2d, zero]).index_select(0, fill)

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        free_device_memory(dev)
        g = torch.Generator(device=dev).manual_seed(32)
        p = {k: v.to(dtype) for k, v in moe.init_moe_mlp(g, cfg).items()}
        x, dy = (torch.randn((BATCH, SEQ, cfg.d_model), generator=g, device=dev).to(dtype)
                 for _ in "xy")

        def x_grad():
            xs = x.detach().requires_grad_(True)
            y, _ = moe.moe_mlp_scatter(p, xs, cfg)
            return torch.autograd.grad(y, xs, dy)[0]

        grads, row = {}, {}
        for form, dispatch in (("_Dispatch", inner), ("index_select", index_select)):
            moe._Dispatch.apply = dispatch
            try:
                first, second = x_grad(), x_grad()
                ms = time_ms(x_grad, iters=10, warmup=1)
            finally:
                moe._Dispatch.apply = inner
            grads[form] = first
            row[form] = {"equal": bool(torch.equal(first, second)),
                         "elements_differ": int((first != second).sum()),
                         "max_abs_diff": float((first.float() - second.float()).abs().max()),
                         "fwd_bwd_ms": ms}
        row["forms_relative_l2"] = relative_l2(grads["_Dispatch"].float(),
                                               grads["index_select"].float())
        name = str(dtype)[6:]
        out[name] = row
        print(f"phase 32a ({card}): {MOE_ARCH} one MoE layer, full width, batch {BATCH} x "
              f"{SEQ}, {name}: x.grad twice on the same inputs, bit-equal through "
              f"_Dispatch {row['_Dispatch']['equal']} ({row['_Dispatch']['elements_differ']} "
              f"elements differ), through index_select's autograd (index_add_) "
              f"{row['index_select']['equal']} ({row['index_select']['elements_differ']} of "
              f"{x.numel()} differ, by up to {row['index_select']['max_abs_diff']:.3e}); the "
              f"forms' x.grad relative L2 {row['forms_relative_l2']:.3e}; forward + backward "
              f"{row['_Dispatch']['fwd_bwd_ms']:.3f} / {row['index_select']['fwd_bwd_ms']:.3f}"
              f" ms")
        limit = TOL[dtype]
        if not (row["_Dispatch"]["equal"] and row["forms_relative_l2"] <= limit):
            raise SystemExit(f"phase 32a [{name}]: the dispatch backward is not bit-equal "
                             f"across calls, or differs from index_select's by more than "
                             f"{limit}: {row}")
        del p, x, dy, grads
    free_device_memory(dev)
    return out


def phases_32_34(dev, counters, card: str, trains: dict) -> dict:
    """Phases 32a, 32-33c (``family_paths`` over PHASES_32_33) and 34 (the
    gradient of each of PHASE_34_ARCHS, card vs CPU)."""
    t0 = time.perf_counter()
    bits = moe_dispatch_backward_bits(dev, card)
    bits_s = time.perf_counter() - t0
    out = family_paths(dev, counters, card, trains, PHASES_32_33)
    out["32a"], out["wall_s"]["32a"] = bits, bits_s
    for arch in PHASE_34_ARCHS:
        t0 = time.perf_counter()
        out[f"34 {arch}"] = family_gradient_against_cpu(dev, counters, arch, "34")
        out["wall_s"][f"34 {arch}"] = time.perf_counter() - t0
    free_device_memory(dev)
    return out


def window_full_width(dev, counters, card: str) -> dict:
    """Phase 35a: ``lm_apply(window=WINDOW_FULL)`` on yi-6b's weights at full
    width and depth, drawn on the card, batch BATCH x LM_SEQ (a warm-up call
    each way, then timed ones): no kernel launch (the masked plain path), finite
    logits, ms and peak memory; the unwindowed call (flash) timed beside it.
    Over the first WINDOW_FULL positions, where the window cuts nothing, the
    two agree within the bf16 limit on an f32 copy of the weights (in bf16
    the plain path rounds scores and softmax weights to bf16, the reference's
    order, and flash does not: their distance is printed, as phase 30 prints
    decode's), and past them they differ (the window binds)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.transformer import cast_params

    free_device_memory(dev)
    cfg = get_config("yi-6b")
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    batch = lm_batch(cfg, BATCH, LM_SEQ, dev)
    W, bf16 = WINDOW_FULL, TOL[torch.bfloat16]

    def timed(weights, window):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = {name: c.launches for name, c in counters.items()}
        t0 = time.perf_counter()
        logits = M.lm_apply(weights, cfg, batch, window=window)
        torch.cuda.synchronize(dev)
        return (logits, (time.perf_counter() - t0) * 1e3,
                torch.cuda.max_memory_allocated(dev) / 2**30, launched(counters, before))

    with torch.no_grad():
        for window in (W, 0):                   # a warm-up call each way
            M.lm_apply(params, cfg, batch, window=window)
        windowed, ms, peak, ran = timed(params, W)
        full, full_ms, full_peak, full_ran = timed(params, 0)
        if ran != dict.fromkeys(KERNELS, 0) or full_ran != lm_launches(cfg):
            raise SystemExit(f"phase 35a: launches windowed {ran}, unwindowed {full_ran}")
        if (windowed.shape != (BATCH, LM_SEQ, cfg.vocab)
                or not bool(torch.isfinite(windowed).all())):
            raise SystemExit(f"phase 35a: logits {tuple(windowed.shape)}, finite "
                             f"{bool(torch.isfinite(windowed).all())}")
        head16 = (windowed[:, :W].float() - full[:, :W].float()).abs()
        out = {"ms": ms, "peak_gib": peak, "unwindowed_ms": full_ms,
               "unwindowed_peak_gib": full_peak,
               "bf16_head_max_abs": float(head16.max()),
               "bf16_head_relative_l2": relative_l2(windowed[:, :W].float(),
                                                    full[:, :W].float()),
               "bf16_tail_relative_l2": relative_l2(windowed[:, W:].float(),
                                                    full[:, W:].float())}
        del windowed, full, head16
        weights = cast_params(params, torch.float32)
        del params
        torch.cuda.empty_cache()
        w32 = M.lm_apply(weights, cfg, batch, window=W).float()
        f32 = M.lm_apply(weights, cfg, batch).float()
        del weights
    out["f32_head_max_abs"] = check_close("phase 35a: windowed vs unwindowed over the first "
                                          f"{W} positions (f32 weights)", w32[:, :W],
                                          f32[:, :W], atol=bf16, rtol=bf16)
    out["f32_tail_relative_l2"] = relative_l2(w32[:, W:], f32[:, W:])
    del w32, f32
    print(f"phase 35a ({card}): yi-6b lm_apply(window={W}), full width and depth, batch "
          f"{BATCH} x {LM_SEQ}: {ms:.1f} ms, peak {peak:.3f} GiB, no kernel launch (the "
          f"unwindowed call: {full_ms:.1f} ms, peak {full_peak:.3f} GiB, flash "
          f"{full_ran['flash_attention']}); first {W} positions against the unwindowed "
          f"call: f32 weights max |diff| {out['f32_head_max_abs']:.3e} (limit {bf16} + "
          f"{bf16} |ref|), bf16 weights max |diff| {out['bf16_head_max_abs']:.3e}, relative "
          f"L2 {out['bf16_head_relative_l2']:.3e} (printed); past them relative L2 "
          f"{out['f32_tail_relative_l2']:.3e} f32, {out['bf16_tail_relative_l2']:.3e} bf16 "
          f"(the window binds)")
    if not out["f32_tail_relative_l2"] > 1e-3:
        raise SystemExit(f"phase 35a: the window does not change the logits past position "
                         f"{W}: {out['f32_tail_relative_l2']}")
    free_device_memory(dev)
    return out


def window_paths(dev, counters, card: str, graphs: dict) -> dict:
    """Phases 35a and 35c (35b runs inside phases 5, 17b, 18b and 22b, on
    the 2-layer models they hold): 35c serves WINDOW_DECODE_ARGS (yi-6b at
    full width through the gateway, its dense caches a ring of WINDOW_DECODE
    slots) with phase 15's cases on the served engine (prefill_slots of
    WINDOW_PREFILL columns, then greedy step_slots from position
    WINDOW_DECODE - 2, across the ring's wrap, graphed against eager, to the
    bit), then a 2-layer f32 model card vs CPU over a ring of
    WINDOW_CPU_DECODE slots (requests of 2 + 7 to 2 + 12 positions)."""
    out, wall = {}, {}
    t0 = time.perf_counter()
    out["35a"] = window_full_width(dev, counters, card)
    wall["35a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["35c"] = {}
    decode_path(dev, counters, WINDOW_DECODE_ARGS, {}, graphs, runs=out["35c"],
                prefill=WINDOW_PREFILL, start=WINDOW_DECODE - 2,
                label=f"yi-6b window {WINDOW_DECODE}")
    print(f"phase 35c ({card}): yi-6b decode, window {WINDOW_DECODE} (the ring wraps "
          f"past position {WINDOW_DECODE}): {out['35c']['tokens_per_s']:.1f} tokens/s, "
          f"engine call ms mean {out['35c']['call_ms_mean']:.3f}, peak memory "
          f"{out['35c']['peak_gib']:.3f} GiB")
    cfg, on_card, params = card_drawn_model(dev, "yi-6b")
    del on_card
    out["35c"]["cpu_rel_l2"] = decode_against_cpu(
        dev, counters, cfg, params, dict(window=WINDOW_CPU_DECODE), {},
        cache_slots=WINDOW_CPU_DECODE, lengths=(12, 9, 10, 7))
    del params
    wall["35c"] = time.perf_counter() - t0
    free_device_memory(dev)
    out["wall_s"] = wall
    WINDOW_RUNS.update({k: v for k, v in out.items() if k != "wall_s"})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import paged_attention as pa
    from repro_torch.kernels.gla_scan import gla_scan as gs
    from repro_torch.kernels.ns_update import ns_update as nu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"msgpack {'.'.join(map(str, msgpack.version))}, "
          f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    seconds = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items()) or 'cached'})")
    for name in build.SOURCES:
        print(ptxas_summary(name, build.library_path(name).with_suffix(".so.log")))

    rows = {"ns_update": ns_update_cases(dev), "flash_attention": flash_cases(dev),
            "paged_attention": paged_cases(dev), "gla_scan": gla_cases(dev),
            "ns_update_bwd": ns_update_bwd_cases(dev),
            "flash_attention_bwd": flash_bwd_cases(dev), "gla_scan_bwd": gla_bwd_cases(dev)}
    for name, cases in rows.items():
        for r in cases:
            lib = ("none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms")
            extra = (f", dense SDPA (gather excluded) {r['yardstick_ms']:.4f} ms, "
                     f"limit ratio {r['limit_ratio']:.4f}" if "yardstick_ms" in r else "")
            if "bound_f32" in r and r["bound_f32"][0] != r["bound_ms"]:
                extra += (f", bound at the f32 CUDA-core peak {r['bound_f32'][0]:.4f} ms "
                          f"({r['bound_f32'][1]})")
            if "per_block_read_mb" in r:
                extra += (f", bytes: {r['stored_mb']:.1f} MB stored, each input read "
                          f"once (the bound's count); {r['per_block_read_mb']:.1f} MB with "
                          f"q and k read by every (b, h) block -> "
                          f"{r['per_block_read_ms']:.4f} ms")
            if "tflops" in r:
                extra += (f", {r['tflops']:.1f} TFLOP/s, kernel/bound "
                          f"{r['ms'] / r['bound_ms']:.2f}")
            if "relative_l2" in r:
                extra += ", relative L2 against the f64 plain backward " + ", ".join(
                    f"{k} {v:.2e}" for k, v in r["relative_l2"].items())
            for key, what in (("dot_limit_ratio", "da, dw at"), ("lse_limit_ratio", "lse at")):
                if key in r:
                    extra += f", {what} {r[key]:.4f} of the limit"
            if name == "flash_attention_bwd":
                passes = ", ".join(f"{k[10:]} {'-' if t is None else f'{t:.4f} ms'}"
                                   for k, t in r["pass_device_ms"].items())
                extra += (f", executed {r['executed_tflops']:.1f} TFLOP/s, device time a "
                          f"pass: {passes}")
                extra += (f", bf16 limit ratio {r['limit_ratio']:.4f}" if "bfloat16" in r["shape"]
                          else "") + " (library: torch autograd of SDPA's backward"
                sdpa = r["sdpa_bwd_device_ms"]
                sdpa_text = "not measured" if sdpa is None else f"{sdpa:.4f} ms"
                extra += f"; its device time {sdpa_text})"
            for key, what in (("device_ms", "kernel"), ("library_device_ms", "addmv")):
                if key in r:
                    t = "not measured" if r[key] is None else f"{r[key]:.4f} ms"
                    extra += f", {what} device time {t}"
            if "graphed_ms" in r:
                extra += (f", graphed {r['graphed_ms']:.4f} ms a launch (100 launches "
                          f"replayed from one CUDA graph)")
            if name == "gla_scan_bwd":
                lib = "none: no one PyTorch call"
            print(f"{name} [{r['shape']}]: err {r['max_abs_err']:.3e}, "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}){extra}")

    trainer_rows = trainer_flash_cases(dev)
    counters = {"ns_update": nu.COUNTER, "flash_attention": fa.COUNTER,
                "paged_attention": pa.COUNTER, "gla_scan": gs.COUNTER,
                "ns_update_bwd": nu.BWD_COUNTER, "flash_attention_bwd": fa.BWD_COUNTER,
                "gla_scan_bwd": gs.BWD_COUNTER}
    zero = dict.fromkeys(KERNELS, 0)
    flows = NFE * REQUESTS
    graphs, phase_s = {}, {}
    t0 = time.perf_counter()
    launches, phase4 = flow_path(dev, counters, "yi-6b", {**zero, "ns_update": flows,
                                                          "flash_attention": LAYERS * flows},
                                 graphs, lm=True)
    phase_s["4+15"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    baselines = baselines_served(dev, counters, card)
    phase_s["4b"] = time.perf_counter() - t0
    cfg, params = small_model("yi-6b")
    whole_path_against_cpu(dev, counters, cfg, params,
                           {**zero, "ns_update": 4, "flash_attention": 2 * 4})
    lm_against_cpu(dev, counters, cfg, params)
    window_against_cpu(dev, counters, cfg, params)
    t0 = time.perf_counter()
    baselines_cpu = baselines_against_cpu(dev, counters, cfg, params)
    phase_s["5b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["paged_attention"] = decode_path(
        dev, counters, DECODE_ARGS, {"paged_attention": LAYERS}, graphs,
        prefill=64, sampled=True, growth=True)["paged_attention"]
    phase_s["6+15"] = time.perf_counter() - t0
    long_step = long_row_decode_step(dev, counters)
    decode_against_cpu(dev, counters, cfg, params,
                       dict(page_size=16, paged_kernel=True), {"paged_attention": 2})
    del cfg, params
    t0 = time.perf_counter()
    launches["gla_scan"] = flow_path(
        dev, counters, "rwkv6-7b",
        {**zero, "ns_update": flows, "gla_scan": LAYERS * flows}, graphs,
        lm=True)[0]["gla_scan"]
    phase_s["8+15"] = time.perf_counter() - t0
    cfg, params = small_model("rwkv6-7b")
    whole_path_against_cpu(dev, counters, cfg, params,
                           {**zero, "ns_update": 4, "gla_scan": 2 * 4})
    lm_against_cpu(dev, counters, cfg, params)
    t0 = time.perf_counter()
    decode_path(dev, counters, RWKV_DECODE_ARGS, {}, graphs)
    phase_s["10+15"] = time.perf_counter() - t0
    decode_against_cpu(dev, counters, cfg, params, {}, {})
    del cfg, params
    trains = {}
    t0 = time.perf_counter()
    distill = distill_path(dev, counters, trains)
    for name in ("ns_update_bwd", "flash_attention_bwd"):
        launches[name] = distill["launches"][name]
    phase_s["12"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reload = artifact_reload(dev, counters, distill)
    phase_s["12b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    any_run = anytime_path(dev, counters, trains)
    phase_s["12c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bst_run = bst_distill_path(dev, counters, trains)
    phase_s["12d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rk45_gate = rk45_programs_gate(dev, counters)
    phase_s["16 rk45"] = time.perf_counter() - t0
    cfg, params = small_model("yi-6b")
    t0 = time.perf_counter()
    gradient_against_cpu(dev, counters, cfg, params)
    phase_s["13"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    any_grad = anytime_gradient_against_cpu(dev, counters, cfg, params)
    phase_s["13b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bst_grad = bst_gradient_against_cpu(dev, counters, cfg, params)
    phase_s["13c"] = time.perf_counter() - t0
    del cfg, params
    t0 = time.perf_counter()
    gw_runs = gateways(dev, counters, card, graphs)
    phase_s["14+15"] = time.perf_counter() - t0
    phase_s["14d+14e"] = gw_runs["14d"].pop("phase_s")
    t0 = time.perf_counter()
    placed = placement_paths(dev, counters, card, gw_runs["14a"])
    phase_s["23"] = time.perf_counter() - t0
    zamba = zamba2_paths(dev, counters, card, graphs)
    phase_s.update(zamba["wall_s"])
    moe_run = moe_paths(dev, counters, card, graphs)
    phase_s.update(moe_run["wall_s"])
    big_moe = moe_235b_paths(dev, counters, card, graphs)
    phase_s.update(big_moe["wall_s"])
    dense = dense_paths(dev, counters, card)
    phase_s.update(dense["wall_s"])
    whisper_run = whisper_paths(dev, counters, card, graphs)
    phase_s.update(whisper_run["wall_s"])
    internvl = internvl_paths(dev, counters, card, graphs)
    phase_s.update(internvl["wall_s"])
    trainer = trainer_paths(dev, counters, card, phase4)
    phase_s.update(trainer["wall_s"])
    family = family_paths(dev, counters, card, trains, PHASES_26_29)
    phase_s.update(family["wall_s"])
    launches["gla_scan_bwd"] = family["26"]["launches"]["gla_scan_bwd"]
    later = phases_32_34(dev, counters, card, trains)
    phase_s.update(later["wall_s"])
    windows = window_paths(dev, counters, card, graphs)
    phase_s.update(windows["wall_s"])
    t0 = time.perf_counter()
    twin_runs = twins(dev, counters, card)
    phase_s["31"] = time.perf_counter() - t0
    dry = dryrun_paths(card)
    phase_s["36"] = dry["s"]
    graph_kinds = {k for k in graphs if "workspace" not in k}
    print("phase 15 summary (" + card + "): " + "; ".join(
        f"{k}: graphed {v['graphed_ms']:.3f} / eager {v['eager_ms']:.3f} ms, capture "
        f"{v['capture_ms']:.1f} ms" for k, v in graphs.items() if k in graph_kinds))
    print("phase 16 summary (" + card + "): " + "; ".join(
        f"{k}: graphed {v['graphed_ms']:.1f} / eager {v['eager_ms']:.1f} ms an iteration, "
        f"captures {v['capture_ms']:.1f} ms, equal to the bit {v['equal']}"
        for k, v in trains.items()) + "; " + "; ".join(
        f"rk45 {k}: graphed {v['graphed_s']:.3f} / eager {v['eager_s']:.3f} s, equal to the "
        f"bit {v['equal']}" for k, v in rk45_gate.items()))
    print("RK45 seconds, graphed (" + card + "): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in (("12", distill["rk45_s"]), ("12c", any_run["rk45_s"]),
                                       ("12d", bst_run["rk45_s"]))))
    print(f"phase 24 summary ({card}): yi-6b trainer at {trainer['24a']['layers']} layers, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}: {trainer['24a']['median_step_ms']:.1f} ms a "
          f"step, {trainer['24a']['tokens_per_s']:.1f} tokens/s, peak "
          f"{trainer['24a']['peak_gib']:.3f} GiB, busy {trainer['24a']['busy']['busy_share']:.3f}; "
          f"graphed equal to eager {trainer['24b']['equal']}; card vs CPU losses "
          f"{max(trainer['24c']['loss_rel']):.3e}, params {trainer['24c']['params_rel_l2']:.3e}; "
          f"checkpoint round trip equal {trainer['24d']['latents_equal']}; profiles default "
          f"{trainer['24e']['default']['request_ms']:.1f} / tuned "
          f"{trainer['24e']['tuned']['request_ms']:.1f} ms a request")
    print(f"phases 26-29 summary ({card}): " + "; ".join(
        f"{arch} at {family[p]['layers']} layers: val PSNR Euler {family[p]['init_val_psnr']:.4f}"
        f" -> {family[p]['val_psnr']:.4f} dB, {family[p]['iteration_ms']:.1f} ms an iteration, "
        f"RK45 {family[p]['rk45_s']:.1f} s, gradient card vs CPU "
        f"{max(family[p + 'b']['relative_l2']):.2e}"
        for arch, p in FAMILY_PHASE.items() if arch in PHASES_26_29)
          + "; trainer " + "; ".join(
              f"{arch} {family[k]['median_step_ms']:.1f} ms a step, peak "
              f"{family[k]['peak_gib']['graphed']:.3f} GiB, equal {family[k]['equal']}"
              for arch, k in TRAIN_PHASE.items() if arch in PHASES_26_29))
    print(f"phases 32-34 summary ({card}): dispatch backward bit-equal (_Dispatch / "
          f"index_select) " + ", ".join(
              f"{d} {r['_Dispatch']['equal']} / {r['index_select']['equal']}"
              for d, r in later["32a"].items()) + "; " + "; ".join(
        f"{arch} at {later[p]['layers']} layers: val PSNR Euler "
        f"{later[p]['init_val_psnr']:.4f} -> {later[p]['val_psnr']:.4f} dB, "
        f"{later[p]['iteration_ms']:.1f} ms an iteration, RK45 {later[p]['rk45_s']:.1f} s, "
        f"peak {later[p]['peak_gib']:.3f} GiB, gradient card vs CPU "
        f"{max(later[p + 'b']['relative_l2']):.2e}, trainer "
        f"{later[TRAIN_PHASE[arch]]['median_step_ms']:.1f} ms a step, peak "
        f"{later[TRAIN_PHASE[arch]]['peak_gib']['graphed']:.3f} GiB, equal "
        f"{later[TRAIN_PHASE[arch]]['equal']}"
        for arch, p in FAMILY_PHASE.items() if arch in PHASES_32_33) + "; gradients (34) "
          + ", ".join(f"{arch} {max(later[f'34 {arch}']['relative_l2']):.2e}"
                      for arch in PHASE_34_ARCHS))
    w = windows["35a"]
    print(f"phase 35 summary ({card}): 35a yi-6b lm_apply(window={WINDOW_FULL}) "
          f"{w['ms']:.1f} ms, peak {w['peak_gib']:.3f} GiB (unwindowed {w['unwindowed_ms']:.1f}"
          f" ms, {w['unwindowed_peak_gib']:.3f} GiB); 35b card vs CPU " + ", ".join(
              f"{arch} {r['window']:.2e} / q_chunk {r['q_chunk']:.2e}"
              for arch, r in WINDOW_RUNS.get("35b", {}).items())
          + f"; 35c decode {windows['35c']['tokens_per_s']:.1f} tokens/s, card vs CPU "
          f"{windows['35c']['cpu_rel_l2']:.2e}")
    print("phase wall s: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    new_phases = {
        "12b": {"what": "artifact reload, 2 requests", "request_ms": reload["request_ms"]},
        "12c": {"what": "anytime distillation and serving",
                "iteration_ms": any_run["iteration_ms"],
                "each_iteration_ms": any_run["each_iteration_ms"],
                "request_ms": any_run["request_ms"],
                "request_nfe": any_run["request_nfe"], "layers": DISTILL_LAYERS,
                "rk45": any_run["rk45"], "rk45_s": any_run["rk45_s"],
                "rk45_programs": any_run["rk45_programs"]},
        "13b": {"what": "anytime gradient, 2 layers f32"},
        "13c": {"what": "BST gradient, 2 layers f32",
                "relative_l2": bst_grad["relative_l2"]},
        "4b": {"what": f"baselines {', '.join(BASELINES)} served, {BASELINE_REQUESTS} "
                       "requests each", "request_ms": baselines["request_ms"]},
        "5b": {"what": "baselines, sigma0 and BST card vs CPU, 2 layers f32",
               "rel_l2": {k: v["rel_l2"] for k, v in baselines_cpu["cases"].items()}},
        "12d": {"what": "BST-Euler distillation, seq 256", "rk45_s": bst_run["rk45_s"],
                "rk45_evaluations": bst_run["rk45_evaluations"],
                "each_iteration_ms": bst_run["each_iteration_ms"],
                "training_launches": bst_run["training_launches"]}}
    for k, what in (("14a", "flush gateway, 12 requests at budgets 4/8, seq 1024"),
                    ("14b", "continuous gateway, 8 requests at budgets 4/8, 4 slots"),
                    ("14c", "shape tiers 512/1024, 4 requests of 1000 positions at 8")):
        new_phases[k] = {"what": what, **{f: gw_runs[k][f] for f in (
            "dispatches", "forwards", "wall_s", "device_dispatch_ms", "dispatch_count",
            "wait_p50_ms", "max_wait_ms", "joins", "slot_occupancy", "alone_equal",
            "alone_max_abs", "alone_max_rel_l2", "bucket3_equal", "native_max_rel_l2")}}
    new_phases["14b"]["equal_to_14a"] = gw_runs["14b"]["equal_to_14a"]
    new_phases["17"] = {"what": "zamba2-2.7b flow, full width, NFE 8, batch 4, seq 1024, "
                                f"{REQUESTS} requests", **zamba["flow"]}
    new_phases["17b"] = {"what": "zamba2-2.7b flow card vs CPU, 2 layers f32",
                         "relative_l2": zamba["flow_rel_l2"]}
    new_phases["17c"] = {"what": "zamba2-2.7b decode, full width, 8 requests on 4 slots",
                         **zamba["decode"]}
    new_phases["17d"] = {"what": "zamba2-2.7b decode card vs CPU, 2 layers f32",
                         "worst_logits_relative_l2": zamba["decode_rel_l2"]}
    slice15 = {   # phases 18-20: what each ran and its launches
        "18": {"what": f"{MOE_ARCH} flow, full width and depth, NFE 8, batch 4, seq 1024, "
                       f"{REQUESTS} requests", **moe_run["flow"]},
        "18b": {"what": f"{MOE_ARCH} flow card vs CPU, 2 layers f32, expert choices first",
                **{k: v for k, v in moe_run["flow_against_cpu"].items() if k != "launches"}},
        "18c": {"what": f"{MOE_ARCH} decode, paged kernel, 8 requests on 4 slots",
                **moe_run["decode"]},
        "18d": {"what": f"{MOE_ARCH} decode card vs CPU, 2 layers f32",
                "worst_logits_relative_l2": moe_run["decode_rel_l2"]},
        "19": {"what": f"{MOE_235B} at {MOE_235B_DEPTH} of 94 layers, full width, one flow "
                       "request", **big_moe["flow"]},
        "19 decode": {"what": f"{MOE_235B} at {MOE_235B_DEPTH} layers, decode at G 16, 4 "
                              "requests on 4 slots", **big_moe["decode"]},
        "19b": {"what": f"{MOE_235B} smoke config with 64 / 4 heads of 128, card vs CPU, "
                        "flow and decode",
                "flow_rel_l2": big_moe["flow_rel_l2"],
                "worst_logits_relative_l2": big_moe["decode_rel_l2"]}}
    for arch in DENSE_LAYERS:
        slice15[f"20 {arch}"] = {"what": f"{arch} flow, full width and depth, one request",
                                 **{k: v for k, v in dense[arch].items() if k != "flow_rel_l2"}}
        slice15[f"20 {arch} vs CPU"] = {"what": f"{arch} flow card vs CPU, 2 layers f32",
                                        "relative_l2": dense[arch]["flow_rel_l2"]}
    slice15_launches = {**moe_run["phase_launches"], **big_moe["phase_launches"],
                        **dense["phase_launches"]}
    slice16 = {   # phases 21-22: what each ran and its launches
        "21": {"what": f"{WHISPER} flow, full width and depth, NFE 8, batch 4, seq 1024, "
                       f"{REQUESTS} requests", **whisper_run["flow"]},
        "21b": {"what": f"{WHISPER} flow card vs CPU, 2 + 2 layers f32, 16 heads of 64",
                "relative_l2": whisper_run["flow_rel_l2"],
                "decode_memory_rel_l2": whisper_run["decode_against_cpu"]["memory_rel_l2"]},
        "21c": {"what": f"{WHISPER} greedy decode over an encoded memory, full width",
                **{k: v for k, v in whisper_run["decode"].items() if k != "launches"}},
        "22": {"what": f"{INTERNVL} flow, full width and depth, {INTERNVL_REQUESTS} "
                       "requests", **internvl["flow"]},
        "22 decode": {"what": f"{INTERNVL} decode, paged kernel at G 6, 8 requests on 4 "
                              "slots", **internvl["decode"]},
        "22b": {"what": f"{INTERNVL} card vs CPU, {INTERNVL_CHECK_LAYERS} layer f32, flow "
                        "and decode",
                "flow_rel_l2": internvl["flow_rel_l2"],
                "worst_logits_relative_l2": internvl["decode_rel_l2"]}}
    slice16_launches = {**whisper_run["phase_launches"], **internvl["phase_launches"]}
    slice17 = {   # phases 14d, 14e and 23: the fleet and placement
        "14d": {"what": f"14a's 12 requests through --fleet {FLEET_HOSTS}",
                **{f: gw_runs["14d"][f] for f in ("dispatches", "forwards", "wall_s", "homes",
                                                  "routed", "steals", "alone_equal",
                                                  "alone_max_rel_l2")},
                "equal_to_14a": [e["equal"] for e in gw_runs["14d"]["errors_to_14a"]]},
        "14e": {"what": f"FleetGateway of {FLEET_HOSTS} Gateways over 14a's sampler: hot key, "
                        "steal round, a join and a leave, 16 requests",
                **{f: v for f, v in gw_runs["14e"].items() if f != "launches"}},
        "23a": {"what": "14a's trace through --mesh host (1 x 1 mesh, DTensor weights)",
                **{f: v for f, v in placed["23a"].items() if f != "launches"}},
        "23b": {"what": "DecodeGateway on the host mesh, paged kernel, "
                        f"{MESH_DECODE_ARGS['requests']} requests",
                **{f: v for f, v in placed["23b"].items() if f != "launches"}},
        "23c": {"what": f"make_distributed_bns_step at world size 1, {DIST_LAYERS} layers f32",
                **{f: v for f, v in placed["23c"].items() if f != "launches"}}}
    slice17_launches = {"14d": gw_runs["14d"]["launches"], "14e": gw_runs["14e"]["launches"],
                        **{k: placed[k]["launches"] for k in ("23a", "23b", "23c")}}
    slice18 = {   # phases 24a-24d: the backbone trainer
        "24a": {"what": f"yi-6b trainer, full width, {TRAIN_LAYERS} layers, {TRAIN_STEPS} steps "
                        f"of {TRAIN_BATCH} x {TRAIN_SEQ}",
                **{f: trainer["24a"][f] for f in ("median_step_ms", "tokens_per_s", "peak_gib",
                                                  "step_ms", "capture_ms", "busy")}},
        "24b": {"what": f"trainer graphed against eager, {TRAIN_CHECK_LAYERS} layers, "
                        f"{TRAIN_CHECK_STEPS} steps", "equal": trainer["24b"]["equal"]},
        "24c": {"what": f"trainer card vs CPU, {TRAIN_CHECK_LAYERS} layers f32, "
                        f"{TRAIN_CHECK_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}",
                "loss_rel": trainer["24c"]["loss_rel"],
                "params_rel_l2": trainer["24c"]["params_rel_l2"]},
        "24d": {"what": "trainer checkpoint, resume and serve --ckpt, "
                        f"{TRAIN_CHECK_LAYERS} layers",
                "latents_equal": trainer["24d"]["latents_equal"]}}
    new_phases["16"] = {"what": "training programs graphed against eager",
                        **{k: {f: v[f] for f in ("graphed_ms", "eager_ms", "capture_ms",
                                                 "launches_an_iteration", "busy")}
                           for k, v in trains.items()},
                        "rk45": {k: {f: v[f] for f in ("graphed_s", "eager_s", "solves",
                                                       "programs", "equal")}
                                 for k, v in rk45_gate.items()}}

    meta = {
        "ns_update": ("src/repro_torch/kernels/csrc/ns_update.cu",
                      "src/repro/kernels/ns_update/ns_update.py:36"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:68"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/flash_attention/paged_attention.py:74"),
        "gla_scan": ("src/repro_torch/kernels/csrc/gla_scan.cu",
                     "src/repro/kernels/gla_scan/gla_scan.py:67"),
        "ns_update_bwd": ("src/repro_torch/kernels/csrc/ns_update.cu",
                          "src/repro/kernels/ns_update/ns_update.py:36"),
        "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention/flash_attention.py:68"),
        "gla_scan_bwd": ("src/repro_torch/kernels/csrc/gla_scan_bwd.cu",
                         "src/repro/kernels/gla_scan/gla_scan.py:67"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        main_case = rows[name][0]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "shape": main_case["shape"],
                        **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by",
                                                     "library_ms")}})
        if "yardstick_ms" in main_case:
            kernels[-1]["yardstick"] = {"what": "dense SDPA, gather excluded",
                                        "ms": main_case["yardstick_ms"]}
        if name == "paged_attention":
            kernels[-1]["device_ms"] = main_case["device_ms"]
            kernels[-1]["long_row_decode_step"] = long_step
        if name == "ns_update_bwd":
            kernels[-1]["device_ms"] = main_case["device_ms"]
        if "graphed_ms" in main_case:
            kernels[-1]["graphed_ms"] = main_case["graphed_ms"]
        if name == "flash_attention_bwd":
            kernels[-1]["library_is"] = "torch autograd of SDPA's backward"
            kernels[-1]["library_device_ms"] = main_case["sdpa_bwd_device_ms"]
            kernels[-1]["pass_device_ms"] = main_case["pass_device_ms"]
            # zamba2-2.7b's and whisper-medium's shapes (hd 80 and 64)
            kernels[-1]["hd_64_80_cases"] = [
                {k: r[k] for k in ("shape", "max_abs_err", "ms", "pass_device_ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms", "sdpa_bwd_device_ms")}
                for r in rows[name] if r["shape"].startswith(f"B={BATCH} ")
                and "hd=128" not in r["shape"] and "bfloat16" in r["shape"]]
            kernels[-1]["distillation"] = {k: v for k, v in distill.items()
                                           if k not in ("launches", "solver", "latents")}
        if name in ("flash_attention", "paged_attention"):
            # phases 18-20's new shapes: flash at G 7, 4, 8 and 16; paged at G 16
            kernels[-1]["slice15_cases"] = [
                {k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms") + (
                                       ("device_ms", "yardstick_ms")
                                       if name == "paged_attention" else ())}
                for r in rows[name] if any(f"{tag} " in r["shape"] for tag in (
                    "H=56", "H=40", "H=64", "G=16"))]
        if name in ("flash_attention", "gla_scan"):
            # zamba2-2.7b's main path (phase 17): its shape's case and launches
            case = next(r for r in rows[name] if "H=32 KV=32" in r["shape"]
                        or "per_block_read_mb" in r)
            kernels[-1]["zamba2"] = {
                "launches": zamba["launches"][name],
                **{k: case[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")},
                **{k: case[k] for k in ("stored_mb", "per_block_read_mb",
                                        "per_block_read_ms") if k in case}}
        if name in ("ns_update", "flash_attention", "ns_update_bwd", "flash_attention_bwd"):
            runs = {"12b": reload, "12c": any_run, "13b": any_grad, "13c": bst_grad,
                    "4b": baselines,
                    "5b": baselines_cpu, "12d": bst_run, **gw_runs,
                    "16": {"launches": {k: sum(v["launches"][k] for v in trains.values())
                                        + sum(2 * v["launches"].get(k, 0)
                                              for v in rk45_gate.values())
                                        for k in KERNELS}},
                    "17": zamba, "17b": {"launches": {
                        **dict.fromkeys(KERNELS, 0), "ns_update": 4, "flash_attention": 4,
                        "gla_scan": 8}},
                    "17c": {"launches": dict.fromkeys(KERNELS, 0)},
                    "17d": {"launches": dict.fromkeys(KERNELS, 0)}}
            kernels[-1]["phases"] = {k: {**v, "launches": runs[k]["launches"][name]}
                                     for k, v in new_phases.items()}
        kernels[-1].setdefault("phases", {}).update(
            {k: {**v, "launches": slice15_launches[k][name]} for k, v in slice15.items()})
        kernels[-1]["phases"].update(
            {k: {**v, "launches": slice16_launches[k][name]} for k, v in slice16.items()})
        kernels[-1]["phases"].update(
            {k: {**v, "launches": slice17_launches[k][name]} for k, v in slice17.items()})
        kernels[-1]["phases"].update(
            {k: {**v, "launches": trainer["phase_launches"][k][name]}
             for k, v in slice18.items()})
        if name in trainer_rows:
            # phase 3d's shape, the trainer's (24a: one launch a layer a step)
            kernels[-1]["trainer"] = {
                **{k: trainer_rows[name][k] for k in ("shape", "max_abs_err", "ms",
                                                      "plain_ms", "bound_ms", "bound_by",
                                                      "library_ms")},
                "launches": trainer["phase_launches"]["24a"][name],
                "launches_a_step": trainer["phase_launches"]["24a"][name] // TRAIN_STEPS}
            if name == "flash_attention_bwd":
                kernels[-1]["trainer"]["library_is"] = "torch autograd of SDPA's backward"
        if name in ("flash_attention", "paged_attention"):
            # phases 21-22's new shapes: flash at hd 64 G 1 (Lq != Lk too) and G 6;
            # paged at KV 8, G 6
            kernels[-1]["slice16_cases"] = [
                {k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms") + (
                                       ("device_ms", "yardstick_ms")
                                       if name == "paged_attention" else ())}
                for r in rows[name] if any(f"{tag} " in r["shape"] for tag in (
                    "H=16 KV=16", "H=48 KV=8", "KV=8 G=6"))]
    slice19 = {   # phases 26-29: the families of the gla_scan backward and flash at hd 64/80
        **{p: {"what": f"{arch} BNS distillation, full width, {family[p]['layers']} layers"
                       + ("" if family[p]["encoder_layers"] is None
                          else f" + {family[p]['encoder_layers']} encoder")
                       + f", NFE {NFE}, batch {BATCH}, seq {SEQ}, {FAMILY_DISTILL_ITERS} iterations",
               **{f: family[p][f] for f in ("init_val_psnr", "val_psnr", "iteration_ms",
                                            "rk45", "rk45_s", "request_ms", "peak_gib")},
               "launches": family[p]["launches"]}
           for arch, p in FAMILY_PHASE.items() if arch in PHASES_26_29},
        **{p + "b": {"what": f"{arch} BNS gradient card vs CPU, {FAMILY_GRAD_DEPTH[arch]} "
                             "layers f32",
                     "relative_l2": family[p + "b"]["relative_l2"],
                     "launches": family[p + "b"]["launches"]}
           for arch, p in FAMILY_PHASE.items() if arch in PHASES_26_29},
        **{k: {"what": f"{arch} trainer, full width, {family[k]['layers']} layers, "
                       f"{FAMILY_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}",
               **{f: family[k][f] for f in ("median_step_ms", "peak_gib", "equal")},
               "launches": family[k]["launches"]}
           for arch, k in TRAIN_PHASE.items() if arch in PHASES_26_29}}
    for entry in kernels:
        entry["phases"].update({k: {**v, "launches": v["launches"][entry["name"]]}
                                for k, v in slice19.items()})
        if entry["name"] in ("flash_attention_bwd", "gla_scan_bwd"):
            # phase 3c's cases at the shapes of the families this slice trains
            entry["slice19_cases"] = [
                {k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")}
                for r in rows[entry["name"]][1:] if entry["name"] == "gla_scan_bwd"
                or "hd=80" in r["shape"] or "hd=64" in r["shape"]]
    zero = dict.fromkeys(KERNELS, 0)
    phases_32_35 = {   # the moe and vlm families' distillation and training; the window
        **{p: {"what": f"{arch} BNS distillation, full width, {later[p]['layers']} layers, "
                       f"NFE {NFE}, batch {BATCH}, seq {SEQ}, {FAMILY_DISTILL_ITERS} iterations",
               **{f: later[p][f] for f in ("init_val_psnr", "val_psnr", "iteration_ms",
                                           "rk45", "rk45_s", "request_ms", "peak_gib")},
               "launches": later[p]["launches"]}
           for arch, p in FAMILY_PHASE.items() if arch in PHASES_32_33},
        **{k: {"what": f"{arch} BNS gradient card vs CPU, {FAMILY_GRAD_DEPTH[arch]} layer f32",
               "relative_l2": later[k]["relative_l2"], "launches": later[k]["launches"]}
           for arch, k in [(a, FAMILY_PHASE[a] + "b") for a in PHASES_32_33]
           + [(a, f"34 {a}") for a in PHASE_34_ARCHS]},
        **{k: {"what": f"{arch} trainer, full width, {later[k]['layers']} layers, "
                       f"{FAMILY_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}",
               **{f: later[k][f] for f in ("median_step_ms", "peak_gib", "equal")},
               "launches": later[k]["launches"]}
           for arch, k in TRAIN_PHASE.items() if arch in PHASES_32_33},
        "35a": {"what": f"yi-6b lm_apply(window={WINDOW_FULL}), full width, batch {BATCH} x "
                        f"{LM_SEQ}", "ms": windows["35a"]["ms"],
                "peak_gib": windows["35a"]["peak_gib"], "launches": zero},
        "35c": {"what": f"yi-6b decode, window {WINDOW_DECODE}, 8 requests on 4 slots",
                **{f: windows["35c"][f] for f in ("tokens_per_s", "call_ms_mean",
                                                  "peak_gib")}, "launches": zero}}
    for entry in kernels:
        entry["phases"].update({k: {**v, "launches": v["launches"][entry["name"]]}
                                for k, v in phases_32_35.items()})
        if entry["name"] == "flash_attention_bwd":
            # phase 3c at the GQA shapes phases 33 and 34 add: G 6 at L 1280, G 4, G 7
            entry["gqa_cases"] = [
                {k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "sdpa_bwd_device_ms",
                                   "pass_device_ms")}
                for r in rows[entry["name"]] if any(f"{tag} " in r["shape"] for tag in (
                    "H=48 KV=8", "H=40 KV=10", "H=56 KV=8"))]
    print(f"chip_smoke wall {time.perf_counter() - T_START:.1f} s")
    print("phase 15 json: " + json.dumps(graphs))
    print("phase 16 json: " + json.dumps(trains))
    print("phase 24 json: " + json.dumps({k: v for k, v in trainer.items()
                                          if k != "phase_launches"}))
    print("phases 26-29 json: " + json.dumps(family))
    print("phases 32-34 json: " + json.dumps(later))
    print("phase 35 json: " + json.dumps(WINDOW_RUNS))
    print(f"phase 30 summary ({card}): " + "; ".join(
        f"{arch} {r['ms']:.1f} ms, peak {r['peak_gib']:.3f} GiB, launches {r['launches']}"
        for arch, r in LM_RUNS.items() if arch != "card_vs_cpu")
        + "; card vs CPU relative L2 " + ", ".join(
            f"{arch} {v:.3e}" for arch, v in LM_RUNS.get("card_vs_cpu", {}).items()))
    print("phase 30 json: " + json.dumps(LM_RUNS))
    print(f"phase 31 summary ({card}): " + "; ".join(
        f"{k} {v['s']:.1f} s" for k, v in twin_runs.items()))
    print("phase 31 json: " + json.dumps(twin_runs))
    print("phase 36 json: " + json.dumps(dry))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
